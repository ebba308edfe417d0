"""A benchmark tree at a tiny size, for the CPU tests: two small
configurations of the program's families (a grouped-KV dense decoder with
qkv biases, and a LayerNorm decoder of 4 top-2 experts with its vocabulary
padded) in float32, the traffic mixes of the real cells cut down, the
real metric readers and reference modules, and
``BENCHMARK.json``'s metrics mapped onto the tiny cells.  Each tiny cell
compares the numbers its real cell compares, against a limit of its own
(``LIMIT``), not the real one."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
REPO = PORTBENCH.parent
for p in (str(REPO / "src"), str(PORTBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

REAL = {"qwen2-7b.decode-4k": "q.dec", "phi3.5-moe-42b-a6.6b.prefill-4k": "p.pre",
        "phi3.5-moe-42b-a6.6b.train-4k": "p.tr", "qwen2-7b.prefill-32k": "q.pre"}
LIMIT = 1e-3  # float32 program against the float32 reference at this size


TINY = {"d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16}
OPTIMIZER = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
             "clip_norm": 1.0, "warmup_steps": 4, "decay_steps": 1000, "min_lr_ratio": 0.1}
TRAFFIC = {"dec": {"mode": "decode", "batch": 2, "prompt_len": 32, "gen_tokens": 6},
           "pre": {"mode": "prefill", "batch": 2, "prompt_len": 64, "gen_tokens": 1},
           "tr": {"mode": "train", "batch": 2, "seq_len": 32, "check_steps": 3,
                  "optimizer": OPTIMIZER}}
CELLS = (("q.dec", "q", "dec"), ("p.pre", "ps", "pre"), ("p.tr", "p", "tr"), ("q.pre", "q", "pre"))


def _config(name, arch, model, port_extra, dtype, param_dtype, remat=None):
    model = dict(TINY, **model, dtype=dtype, param_dtype=param_dtype)
    replace = dict(TINY, **port_extra, dtype=dtype, param_dtype=param_dtype)
    if remat:
        model["remat"] = replace["remat"] = remat
    return {"name": name, "model": model, "port": {"arch": arch, "replace": replace}}


def configs(dtype: str = "float32"):
    dense = {"d_ff": 128, "vocab_size": 512, "vocab_multiple": 128, "n_experts": 0, "top_k": 0,
             "norm": "rmsnorm", "norm_eps": 1e-6, "rope_theta": 1e6, "qkv_bias": True,
             "o_bias": False}
    moe = {"d_ff": 64, "vocab_size": 500, "vocab_multiple": 128, "n_experts": 4, "top_k": 2,
           "capacity_factor": 1.25, "route_group": 1024, "norm": "layernorm", "norm_eps": 1e-5,
           "rope_theta": 1e4, "qkv_bias": True, "o_bias": True}
    moe_port = {"d_ff": 64, "vocab_size": 500, "n_experts": 4, "qkv_bias": True}
    return [_config("q", "qwen2-7b", dense,
                    {"d_ff": 128, "vocab_size": 512, "norm_eps": 1e-6}, dtype, dtype),
            _config("p", "phi3.5-moe-42b-a6.6b", moe, moe_port, dtype, "float32", "full"),
            _config("ps", "phi3.5-moe-42b-a6.6b", moe, moe_port, dtype, dtype)]


def make_root(tmp, dtype: str = "float32") -> Path:
    """Writes the tiny tree under ``tmp``; returns it."""
    tmp = Path(tmp)
    pb = tmp / "portbench"
    for d in ("configs", "traffic", "cells"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    ignore = shutil.ignore_patterns("__pycache__")
    for d in ("metrics", "reference"):
        shutil.copytree(PORTBENCH / d, pb / d, dirs_exist_ok=True, ignore=ignore)
    for c in configs(dtype):
        (pb / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    for k, v in TRAFFIC.items():
        (pb / "traffic" / f"{k}.json").write_text(json.dumps(v))
    real = json.loads((REPO / "BENCHMARK.json").read_text())

    def remap(metrics):
        out = []
        for m in metrics:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [REAL[w] for w in m["workloads"]]
            out.append(m)
        return out

    cells = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"} for n, c, t in CELLS]
    bench = dict(real, workloads=cells, end_to_end=remap(real["end_to_end"]),
                 per_layer=remap(real["per_layer"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    tiny = {v: k for k, v in REAL.items()}
    for n, _, _ in CELLS:
        real_cell = json.loads((PORTBENCH / "cells" / f"{tiny[n]}.json").read_text())
        lim = {"sample_requests": 2, "limits": {k: LIMIT for k in real_cell["limits"]}}
        (pb / "cells" / f"{n}.json").write_text(json.dumps(lim))
    return tmp


def run(root, cell: str, trace: int = 0, fault=None, seconds: float = 0.2,
        seed: int = 3_000_000_019) -> dict:
    """One run of a tiny cell on the CPU (the harness's look for a card
    skipped); returns its result."""
    import run as pbrun

    argv = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    return pbrun.run(argv, root=Path(root), device="cpu", fault=fault)
