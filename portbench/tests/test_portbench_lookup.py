"""A configuration is added by new files only: a tiny decoder of
qwen3-1.7b's shape with q/k RMSNorm, which ``reference.lm`` refuses,
brings its own reference module, with its port check and counts, in the
test's tree (``added/``), and its prefill cell runs through ``run.run``
and is correct with no file of the harness changed.  And nothing moved:
the real cells' lookups resolve to ``reference.lm``, whose counts are
``harness.flops``'s and equal the values pinned from the formulas before
the lookup, and the three configuration files give the program configs
they gave."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

import pbtiny
from pbtiny import PORTBENCH, REPO

from harness import spec

ADDED = Path(__file__).resolve().parent / "added"
REFUSED = "untied full attention with rope, no q/k norm"
H100 = "NVIDIA H100 80GB HBM3"


def _qknorm_config(name: str, reference=None) -> dict:
    model = dict(pbtiny.TINY, d_ff=128, vocab_size=512, vocab_multiple=128, n_experts=0,
                 top_k=0, norm="rmsnorm", norm_eps=1e-6, rope_theta=1e6, qkv_bias=False,
                 o_bias=False, qk_norm=True, dtype="float32", param_dtype="float32")
    replace = dict(pbtiny.TINY, d_ff=128, vocab_size=512, norm_eps=1e-6, tie_embeddings=False,
                   dtype="float32", param_dtype="float32")
    c = {"name": name, "model": model, "port": {"arch": "qwen3-1.7b", "replace": replace}}
    if reference:
        c["reference"] = reference
    return c


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree with two configurations added as files and entries:
    ``k`` names its own reference; ``k_lm`` is the same model
    under ``reference.lm``."""
    root = pbtiny.make_root(tmp_path_factory.mktemp("added"))
    pb = root / "portbench"
    shutil.copy(ADDED / "reference" / "qknorm.py", pb / "reference" / "qknorm.py")
    for name, ref in (("k", "qknorm"), ("k_lm", "lm")):
        (pb / "configs" / f"{name}.json").write_text(json.dumps(_qknorm_config(name, ref)))
        (pb / "cells" / f"{name}.pre.json").write_text((pb / "cells" / "q.pre.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"] += [{"name": f"{n}.pre", "config": n, "traffic": "pre", "chips": 1,
                            "why": "test"} for n in ("k", "k_lm")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "q.pre" in m.get("workloads", ()):
            m["workloads"] += ["k.pre", "k_lm.pre"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_added_configuration_finds_its_own_modules(tree):
    cell = spec.load_cell("k.pre", tree)
    assert Path(cell.reference.__file__) == (tree / "portbench/reference/qknorm.py").resolve()
    assert spec.load_cell("k.pre", tree).reference is cell.reference  # loaded once a path
    cfg = spec.port_config(cell.config, cell.reference)
    assert cfg.qk_norm and not cfg.tie_embeddings


@pytest.mark.parametrize("trace", (0, 1))
def test_added_configuration_runs_and_is_correct(tree, trace, monkeypatch):
    import run as pbrun

    seen = []

    class Recorded(pbrun.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(pbrun, "Run", Recorded)
    res = pbtiny.run(tree, "k.pre", trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        (run_,) = seen
        assert run_.flops is spec.load_cell("k.pre", tree).reference
        assert Path(run_.flops.__file__) == (tree / "portbench/reference/qknorm.py").resolve()
        assert run_.program is not None and run_.program.window_s > 0
        assert "idle_pct.prefill" in res["metrics"]
    else:
        assert not seen and "prefill_tokens_per_s" in res["metrics"]


def test_added_reference_is_what_the_check_holds(tree, monkeypatch):
    """Without its q/k norm the added reference no longer matches the
    program: the check compares the layer the configuration adds."""
    cell = spec.load_cell("k.pre", tree)
    monkeypatch.setattr(cell.reference, "head_norm", lambda x, scale, eps: x)
    res = pbtiny.run(tree, "k.pre")
    assert not res["correct"], res["checks"]


def test_lm_refuses_the_added_configuration_as_before(tree):
    cell = spec.load_cell("k_lm.pre", tree)
    assert Path(cell.reference.__file__) == (tree / "portbench/reference/lm.py").resolve()
    with pytest.raises(ValueError, match=REFUSED):
        spec.port_config(cell.config, cell.reference)
    with pytest.raises(ValueError, match=REFUSED):
        pbtiny.run(tree, "k_lm.pre")


# window_flops and window_decode_bytes of 3 requests or steps, and the
# roofline readers' least seconds of one call a layer, at the real cells'
# traffic on the H100's peaks, as the formulas gave them before the lookup
PINNED = {
    "qwen2-7b.decode-4k": {"window_flops": 1387669852520448.0,
                           "window_decode_bytes": 3030493519872},
    "phi3.5-moe-42b-a6.6b.prefill-4k": {"window_flops": 679723545919488.0,
                                        "attn_fwd_least_seconds": 0.017792195158455006},
    "phi3.5-moe-42b-a6.6b.train-4k": {"window_flops": 83952987537408.0,
                                      "attn_bwd_least_seconds": 0.0013900152467542972},
    "qwen2-7b.prefill-32k": {"window_flops": 1928752285974528.0,
                             "attn_fwd_least_seconds": 0.21778815988610717},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_real_cells_resolve_to_lm_and_flops_and_count_as_before(name):
    from harness import flops

    cell = spec.load_cell(name, REPO)
    assert Path(cell.reference.__file__) == PORTBENCH / "reference" / "lm.py"
    f, m, t = cell.reference, cell.model, cell.traffic
    for count in ("window_flops", "window_decode_bytes", "attn_fwd_least_seconds",
                  "attn_bwd_least_seconds"):
        assert getattr(f, count) is getattr(flops, count)
    got = {"window_flops": f.window_flops(m, t, 3)}
    if t["mode"] == "decode":
        got["window_decode_bytes"] = f.window_decode_bytes(m, t, 3)
    calls, peak = m["n_layers"], spec.peaks(H100)
    if name.endswith("prefill-4k") or name.endswith("prefill-32k"):
        got["attn_fwd_least_seconds"] = f.attn_fwd_least_seconds(m, t, calls, peak)
    if t["mode"] == "train":
        got["attn_bwd_least_seconds"] = f.attn_bwd_least_seconds(m, t, calls, peak)
    assert got == PINNED[name]


@pytest.mark.parametrize("config", ["qwen2-7b", "phi3.5-moe-42b-a6.6b.serving",
                                    "phi3.5-moe-42b-a6.6b.training"])
def test_real_configurations_give_the_same_program_config(config):
    from repro_torch.configs import get_config

    data = json.loads((PORTBENCH / "configs" / f"{config}.json").read_text())
    assert "reference" not in data
    lm = spec.module("reference", "lm")
    cfg = spec.port_config(data, lm)
    port = data["port"]
    assert cfg == get_config(port["arch"]).replace(**port["replace"])
    m = data["model"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
            cfg.n_experts, cfg.qkv_bias, cfg.param_dtype) == (
        m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"], m["vocab_size"],
        m["n_experts"], m["qkv_bias"], m["param_dtype"])
    assert lm.unsupported(cfg) is None
