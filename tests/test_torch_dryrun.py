"""The port's dry run (``repro_torch.launch.dryrun``) on ``meta`` tensors:
records with the reference's keys, counted FLOPs against the analytic
model with every difference derived, the roofline's ``mfu``, the
live-bytes tracker, the kernel wrappers' ``meta`` branch, the CLI and the
isolation of the module from ``jax`` and ``repro``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.launch import dryrun
from repro_torch.models.lm import layer_kinds
from repro_torch.roofline import analytic, roofline

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
KINDS = ("prefill", "decode", "train")
# the keys of the reference's run_cell record (src/repro/launch/dryrun.py)
RECORD_KEYS = {"arch", "shape", "multi_pod", "status", "n_chips", "n_params", "n_active_params",
               "tokens_per_step", "memory", "cost", "collectives", "analytic", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes_est"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "model_flops_per_dev",
                 "hlo_flops_per_dev", "useful_ratio", "step_time_s", "mfu", "source"}


def _expected_counted(cfg, kind) -> float:
    """The FLOPs the counter must see, derived from ``analytic.step_flops``
    and what the analytic model counts differently.  It counts only
    products; the analytic model also counts the RG-LRU's 10 elementwise
    operations an element and, outside decode (where the port's conv is an
    ``einsum``), its depthwise conv's 2 * conv_width, neither of which is
    a product; the train step multiplies by 3 (forward and backward, no
    remat).  The port's prefill takes the logits of the last token only
    (the analytic model: of every token), and computes the cache with a
    second pass: each attention layer's K and V projections and each
    recurrent layer's input projection and block-diagonal gates
    (``Block.prefill``).  Norms, rope and softmax are not products; the
    plain attention's masked pairs are products, and the analytic model
    counts the full S x S square too (Sk = S at prefill and train)."""
    D, W, H = cfg.d_model, cfg.resolved_rnn_width, cfg.n_heads
    KV, hd, cw = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.conv_width
    kinds = layer_kinds(cfg)
    n_attn, n_rec = kinds.count("attn"), kinds.count("rec")
    want = analytic.step_flops(cfg, kind, B, S)
    if kind == "decode":
        return want - n_rec * 10 * B * W
    elementwise = n_rec * (10 + 2 * cw) * B * S * W
    if kind == "train":
        return want - 3 * elementwise
    stem = analytic.forward_flops(cfg, B, S)["stem"]
    second_pass = n_attn * 4 * B * S * D * KV * hd + n_rec * (2 * B * S * D * W
                                                             + 4 * B * S * W * (W // H))
    return want - stem + stem / S + second_pass - elementwise


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen3-1.7b"])
def test_reduced_dry_run_record(arch, kind):
    cfg = get_config(arch).reduced()
    rec = dryrun.dry_run(cfg, ShapeConfig(f"reduced {kind}", S, B, kind))
    assert RECORD_KEYS <= set(rec) and rec["status"] == "OK" and rec["n_chips"] == 1
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["tokens_per_step"] == (B if kind == "decode" else B * S)
    flops = rec["cost"]["flops"]
    assert flops == _expected_counted(cfg, kind)
    an = rec["analytic"]
    assert an["flops_global"] == analytic.step_flops(cfg, kind, B, S)
    assert an["counted_vs_analytic"] == flops / an["flops_global"]
    assert an["bytes_per_dev"] == analytic.step_bytes(cfg, kind, B, S, dp=1, tp=1, chips=1)
    roof = rec["roofline"]
    mf = roofline.model_flops(kind, rec["n_active_params"], rec["tokens_per_step"])
    assert roof["model_flops_per_dev"] == mf
    assert roof["compute_s"] == flops / roofline.PEAK_FLOPS
    assert roof["memory_s"] == an["bytes_per_dev"]["total"] / roofline.HBM_BW
    assert roof["collective_s"] == 0.0
    assert roof["mfu"] == pytest.approx(mf / (roof["step_time_s"] * roofline.PEAK_FLOPS),
                                        rel=1e-12)
    assert "flops=counted" in roof["source"] and "bytes=analytic" in roof["source"]
    mem = rec["memory"]
    assert mem["peak_bytes_est"] == (mem["argument_bytes"] + mem["output_bytes"]
                                     + mem["temp_bytes"] - mem["alias_bytes"])
    params = sum(p.numel() * p.element_size()
                 for p in dryrun.specs_mod.abstract_params(cfg, S).parameters())
    assert mem["argument_bytes"] >= params
    if kind == "train":  # float32 masters, their gradients, and two moments
        assert mem["peak_bytes_est"] >= 4 * params
    json.dumps(rec)


def test_no_probe_traces_without_counting():
    cfg = get_config("qwen3-1.7b").reduced()
    rec = dryrun.dry_run(cfg, ShapeConfig("t", S, B, "prefill"), count=False)
    assert rec["cost"] == {} and rec["memory"] == {}
    assert rec["roofline"]["hlo_flops_per_dev"] == analytic.step_flops(cfg, "prefill", B, S)
    assert rec["roofline"]["source"].startswith("flops=analytic")


def test_serving_dry_runs_in_the_activation_type():
    """Serving stores the parameters in ``cfg.dtype`` (as the reference's
    dryrun.py does); training keeps ``param_dtype`` masters."""
    cfg = get_config("qwen3-1.7b").reduced().replace(dtype="bfloat16")
    serve = dryrun.dry_run(cfg, ShapeConfig("t", S, B, "decode"))
    train = dryrun.dry_run(cfg, ShapeConfig("t", S, B, "train"))
    n = serve["n_params"]
    assert serve["memory"]["argument_bytes"] < 4 * n <= train["memory"]["argument_bytes"]


def test_live_bytes_counts_storages_once_and_frees_them():
    live = dryrun.LiveBytes()
    with live:
        a = torch.empty(1000, device="meta")  # 4,000 bytes
        v = a.view(10, 100)  # a view: no new storage
        a.add_(1)  # in place: none either
        b = torch.empty(500, dtype=torch.bfloat16, device="meta")  # 1,000
        assert live.live == 5000
        del a, v
        assert live.live == 1000
        c = torch.empty(2, 2000, device="meta")  # 16,000
    assert (live.live, live.peak) == (17000, 17000)
    del b, c


def test_kernel_wrappers_take_the_plain_version_on_meta():
    """On ``meta`` the wrappers run their plain versions (shapes only) and
    launch nothing; on the CPU, too; a CUDA tensor would launch."""
    before = dict(fa_ops.LAUNCHES), dict(rg_ops.LAUNCHES)
    q = torch.empty(2, 4, 32, 16, device="meta")
    pos = torch.empty(32, dtype=torch.int32, device="meta")
    o = fa_ops.flash_attention(q, q, q, pos, pos, causal=True, window=8)
    o2, lse = fa_ops.flash_attention_lse(q, q, q, pos, pos)
    dq, dk, dv = fa_ops.flash_attention_bwd(q, q, q, pos, pos, o2, lse, o2)
    assert o.device.type == "meta" and tuple(o.shape) == (2, 4, 32, 16)
    assert tuple(lse.shape) == (2, 4, 32) and tuple(dk.shape) == (2, 4, 32, 16)
    x = torch.empty(2, 64, 8, device="meta")
    h = rg_ops.rglru(x, x)
    dla, db = rg_ops.rglru_bwd(x, h, h)
    assert h.device.type == "meta" and tuple(dla.shape) == tuple(db.shape) == (2, 64, 8)
    assert (dict(fa_ops.LAUNCHES), dict(rg_ops.LAUNCHES)) == before
    assert "meta" in fa_ops.PLAIN_DEVICES and "cuda" not in fa_ops.PLAIN_DEVICES
    assert "meta" in rg_ops.PLAIN_DEVICES and "cuda" not in rg_ops.PLAIN_DEVICES


def test_run_cell_writes_its_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", verbose=False)
    saved = json.loads((tmp_path / "qwen3-1.7b__decode_32k__onecard.json").read_text())
    assert saved["status"] == rec["status"] == "OK"
    assert RECORD_KEYS <= set(saved) and saved["roofline"]["dominant"] == "memory"
    assert saved["n_params"] == 1720574976
    again = dryrun.run_cell("qwen3-1.7b", "decode_32k", skip_existing=True, verbose=False)
    assert again == saved
    skip = dryrun.run_cell("qwen3-1.7b", "long_500k", verbose=False)
    assert skip["status"] == "SKIP"


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_meshes_wait_for_the_multi_card_slice(flag, monkeypatch, tmp_path):
    """The mesh flags write one record a mesh (``--both-meshes`` from a
    child process each); a cell the arch does not support is a SKIP
    record and starts no group.  The sharded dry runs themselves are
    tested in test_torch_collectives.py."""
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen3-1.7b", "--shape", "long_500k",
                                      "--out", str(tmp_path), flag])
    if flag == "--both-meshes":
        with pytest.raises(SystemExit) as done:
            dryrun.main()
        assert done.value.code == 0
        tags = ["singlepod", "multipod"]
    else:
        dryrun.main()
        tags = ["multipod"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"qwen3-1.7b__long_500k__{t}.json" for t in tags)
    for t in tags:
        rec = json.loads((tmp_path / f"qwen3-1.7b__long_500k__{t}.json").read_text())
        assert rec["status"] == "SKIP" and rec["multi_pod"] == (t == "multipod")


def test_chip_smoke_roofline_phase(capsys, monkeypatch):
    """``chip_smoke.py``'s roofline phase on its CPU rehearsal's paths: the
    dry-run children's records give one line a timed path, with ``mfu``
    and ``roofline_share`` from the measured seconds; a path measured
    faster than its roofline fails the run."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    procs = chip_smoke.start_dry_runs(reduced=True)
    try:
        recs = chip_smoke.read_dry_runs(procs)
    finally:
        chip_smoke.stop(procs)
    paths = chip_smoke.roofline_paths(reduced=True)
    assert set(recs) == set(paths) | {"mesh"} and len(paths) == 24  # 8 dense, 4 train families
    timed = {name: dict(seconds=0.5, peak_memory_bytes=None) for name in paths}
    monkeypatch.setattr(chip_smoke, "TIMED", timed)
    chip_smoke.roofline_phase(recs, reduced=True)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    *lines, mesh = lines
    assert [ln["path"] for ln in lines] == list(paths)
    # the third child: a training step on a fake group's mesh, counted per
    # device, with the collectives DTensor issued and their roofline term
    assert mesh["path"] == "mesh " + " ".join(chip_smoke.MESH_DRY_RUN) and mesh["cpu_counts"]
    assert mesh["n_chips"] == 4 and mesh["collectives"]["wire_bytes"] > 0
    assert mesh["collective_s"] == mesh["collectives"]["wire_bytes"] / roofline.NVLINK_BW
    for ln in lines:
        assert ln["mfu"] == ln["model_flops"] / (0.5 * roofline.PEAK_FLOPS)
        assert ln["roofline_share"] == ln["step_time_s"] / 0.5
        assert ln["step_time_s"] == max(ln["compute_s"], ln["memory_s"])
    train = recs["lm train"]["roofline"]["step_time_s"]
    timed["lm train"]["seconds"] = train / (chip_smoke.ROOFLINE_SHARE_MAX * 1.01)
    with pytest.raises(SystemExit, match="lm train"):
        chip_smoke.roofline_phase(recs, reduced=True)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_chip_smoke_dense_attention_flops(kind, monkeypatch):
    """What ``chip_smoke.py``'s dense roofline lines take out of a dense
    serving path's count (``attention_pair_flops``' first term) is what
    the dry run counts for attention: the count less the count with
    attention doing no product (the prefill's ``flash_attention``, the
    decode's ``_decode_mha``); the pairs the masks let through are the
    causal ones in a prefill, the slots filled up to the new token in a
    decode step."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch.models import attention

    name = f"dense serve qwen2-7b {kind}"
    cfg, shape, cache_len, max_seq = chip_smoke.roofline_paths(reduced=True)[name]
    full = dryrun.dry_run(cfg, shape, cache_len=cache_len, max_seq=max_seq)["cost"]["flops"]
    if kind == "prefill":
        monkeypatch.setattr(fa_ops, "flash_attention", lambda q, *a, **kw: q)
    else:
        monkeypatch.setattr(attention, "_decode_mha", lambda k, v, q, *a: q)
    bare = dryrun.dry_run(cfg, shape, cache_len=cache_len, max_seq=max_seq)["cost"]["flops"]
    every, visible = chip_smoke.attention_pair_flops(cfg, shape, cache_len)
    assert full - bare == every > 0
    S = shape.seq_len
    pairs = (S * S, S * (S + 1) // 2) if kind == "prefill" else (cache_len, S + 1)
    assert every * pairs[1] == visible * pairs[0]


def test_importing_the_dry_run_loads_no_jax_and_no_repro():
    code = ("import sys, repro_torch.launch.dryrun\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
