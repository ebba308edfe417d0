"""The harness on the CPU over the tiny serving cells: the program's
float32 prefill and decode against the reference pass the check, and
each fault a serving cell can have, and the reference in bfloat16 in the
program's place (the control), fail it."""
from __future__ import annotations

import pytest

import pbtiny

SERVING = ("q.dec", "p.pre", "q.pre")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pbtiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", SERVING)
@pytest.mark.parametrize("trace", (0, 1))
def test_sound_run_is_correct(root, cell, trace):
    res = pbtiny.run(root, cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    if trace:
        assert res["device"]["window_s"] > 0 and "breakdown" in res
        assert {n for n in names if n.startswith("idle_pct")}
    else:
        assert "setup_s" in names and len(names) >= 2
        assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell,fault", [(c, f) for c in ("q.dec", "p.pre")
                                        for f in ("token", "half_batch", "one_row")])
def test_planted_fault_fails(root, cell, fault):
    res = pbtiny.run(root, cell, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ("q.dec", "p.pre"))
def test_control_fails(root, cell):
    import torch

    from harness import spec
    from harness.cell import CELLS

    c = spec.load_cell(cell, root)
    runner = CELLS[c.mode](c, 5, torch.device("cpu"))
    runner.setup()
    runner.window(0.2)
    runner.release()
    sound, control = runner.check(), runner.check(control="bf16")
    limits = c.limits["limits"]
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(control[k] > limits[k] for k in limits), control



def test_route_gap_reads_how_far_a_choice_taken_lies_below_the_cutoff():
    """A forward pass that takes its own expert choices reads route gap 0
    and the logits of one that chooses for itself; one that takes another
    choice for a token reads that choice's distance below the cutoff."""
    import torch

    from reference import lm as ref_lm
    from reference import weights as W

    m = dict(pbtiny.configs()[1]["model"], n_layers=1)
    ref_lm.exact()

    def block(i):
        return W.draw_block(m, 5, i, torch.float32, "cpu")

    tokens = torch.randint(0, m["vocab_size"], (2, 64), generator=torch.Generator().manual_seed(1))
    own = ref_lm.Routing()
    base = ref_lm.logits_at(m, block, tokens, [63], routing=own)
    same = ref_lm.Routing(follow=own.chosen)
    assert torch.equal(ref_lm.logits_at(m, block, tokens, [63], routing=same), base)
    assert same.gaps == [0.0]
    other = own.chosen[0].clone()
    other[5, 1] = next(e for e in range(m["n_experts"]) if e not in other[5].tolist())
    moved = ref_lm.Routing(follow=[other])
    ref_lm.logits_at(m, block, tokens, [63], routing=moved)
    assert moved.gaps[0] > 0
