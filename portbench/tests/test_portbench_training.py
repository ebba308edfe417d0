"""The harness on the CPU over the tiny training cell (4 top-2 experts,
remat "full"): the program's float32 steps against the reference's pass
the check; a step that leaves the state unchanged, half of the batch
left out, and the reference in bfloat16 in the program's place (the
control) fail it."""
from __future__ import annotations

import pytest

import pbtiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pbtiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", (0, 1))
def test_sound_run_is_correct(root, trace):
    res = pbtiny.run(root, "p.tr", trace)
    assert res["correct"], res["checks"]
    if trace:
        assert "idle_pct.train" in res["metrics"]
    else:
        assert {"train_tokens_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", ("frozen", "half_batch"))
def test_planted_fault_fails(root, fault):
    res = pbtiny.run(root, "p.tr", fault=fault)
    assert not res["correct"], res["checks"]


def test_frozen_step_reads_one():
    """A state left unchanged reads 1 on the gradient and change numbers."""
    from harness.cell import worst_rel

    ref = {"a": 2.0, "b": 3.0, "c": 1e-9}
    assert worst_rel({"a": 0.0, "b": 0.0, "c": 0.0}, ref, lambda k: k != "c") == 1.0


def test_control_fails(root):
    import torch

    from harness import spec
    from harness.cell import CELLS

    c = spec.load_cell("p.tr", root)
    runner = CELLS[c.mode](c, 7, torch.device("cpu"))
    runner.setup()
    runner.release()
    sound, control = runner.check(), runner.check(control="bf16")
    limits = c.limits["limits"]
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(control[k] > limits[k] for k in limits), control
