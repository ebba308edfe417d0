"""The benchmark's operation and byte counts against hand counts for one
layer of qwen2-7b and of phi3.5-moe, and the trace reduction on a
made-up trace."""
from __future__ import annotations

import json

from pbtiny import PORTBENCH

from harness import flops, trace


def _model(name: str, layers: int = 1) -> dict:
    m = json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())["model"]
    return dict(m, n_layers=layers)


def test_qwen2_layer_by_hand():
    m = _model("qwen2-7b")
    # q 3584 x 3584, k and v 3584 x 512 each, o 3584 x 3584
    assert flops.attn_weights(m) == 12_845_056 + 2 * 1_835_008 + 12_845_056
    assert flops.ffn_weights_active(m) == 3 * 3584 * 18944 == 203_685_888
    # 4 prompt tokens: products 2 x 4 x 233,046,016; 10 visible pairs x 4 x 128
    # x 28 heads; the head once, at the last position
    assert flops.prefill_flops(m, 1, 4) == 2_954_506_240
    # a decode step at position 0: every bf16 weight once, one embedding row,
    # one cache entry read and one written (k and v, 4 KV heads of 128)
    assert flops.decode_step_bytes(m, 1, 0) == 2 * (233_046_016 + 3584 * 152064 + 3584) + 2048


def test_phi_moe_layer_by_hand():
    m = _model("phi3.5-moe-42b-a6.6b.training")
    assert flops.attn_weights(m) == 41_943_040
    # the router and two experts of 3 x 4096 x 6400, not 2.5 capacity slots
    assert flops.ffn_weights_active(m) == 65_536 + 157_286_400
    # a train step of 8 tokens: the products 3 x 2 x 8 x (layer + head);
    # 36 visible pairs x (4 + 10) x 128 x 32 heads
    assert flops.train_step_flops(m, 1, 8) == 48 * (199_294_976 + 4096 * 32128) + 2_064_384
    assert flops.causal_pairs(0, 8) == 36 and flops.causal_pairs(4096, 1) == 4097


def test_trace_reduction():
    def ev(name, act, start, end, tid=1, corr=0):
        return {"name": name, "activity": act, "start": start, "end": end, "tid": tid,
                "corr": corr, "linked": 0}

    raw = [ev("pb:window", "user_annotation", 0, 1000),
           ev("pb:attn", "user_annotation", 100, 300),
           ev("cudaLaunchKernel", "cuda_runtime", 150, 160, corr=7),
           ev("fa_wgmma", "kernel", 400, 500, tid=9, corr=7),
           ev("cudaLaunchKernel", "cuda_runtime", 350, 360, corr=8),
           ev("gemm", "kernel", 450, 700, tid=9, corr=8),
           ev("pb:moe:bwd<", "user_annotation", 800, 801, tid=2),
           ev("cudaLaunchKernel", "cuda_runtime", 850, 860, tid=2, corr=9),
           ev("pb:moe:bwd>", "user_annotation", 900, 901, tid=2),
           ev("mm_kernel", "kernel", 900, 950, tid=9, corr=9),
           ev("aten::mm", "cpu_op", 700, 990)]
    t = trace.reduce(raw)
    assert t.window_s == 1e-6
    assert abs(t.busy_s - 3.5e-7) < 1e-15  # 400-700 and 900-950
    assert abs(t.seconds_under("pb:attn", innermost=True) - 1e-7) < 1e-15
    assert abs(t.seconds_under("pb:moe") - 5e-8) < 1e-15
    assert abs(t.seconds_named(("fa_wgmma",)) - 1e-7) < 1e-15
    gaps = dict(t.idle_gaps)
    assert abs(sum(gaps.values()) - 6.5e-7) < 1e-15
    assert any("aten::mm" in k for k in gaps)
