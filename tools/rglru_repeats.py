#!/usr/bin/env python3
"""Repeat the RG-LRU scan kernels on fixed inputs and compare their bits.

On the inputs of ``tests/test_torch_lm_bwd_cuda.py::test_rglru_function_gradients``
(B=2 S=300 W=96, seed 3) and at the serving shape (B=4 S=4096 W=4096,
seeded), each repeat runs the forward scan and the gradients through the
``autograd.Function`` on the card; every repeat's outputs must equal the
first's bit for bit, and the first must be within 2e-5 (the test's
tolerance) of autograd through the plain version on the CPU.  At the
test's shape the CPU side is repeated too, and must give the same bits
every time.  Prints one JSON line per shape (repeats, repeats whose bits
moved on the card and on the CPU, the largest error against the CPU) and
the card's name and power limit; exits 1 on any difference.

    python3 tools/rglru_repeats.py --repeats 50
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(B, S, W, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    log_a = -torch.rand(B, S, W, generator=g) * 0.5
    b = torch.randn(B, S, W, generator=g)
    dh = torch.randn(B, S, W, generator=g)
    return log_a, b, dh


def _run(rg_ops, log_a, b, dh):
    la, bb = log_a.clone().requires_grad_(), b.clone().requires_grad_()
    h = rg_ops.rglru(la, bb)
    grads = torch.autograd.grad(h, (la, bb), dh)
    return [h.detach()] + list(grads)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rglru_repeats: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.rglru_scan import ops as rg_ops

    ok = True
    # the CPU repeats only at the test's shape: the serving shape takes seconds a pass
    for what, shape, seed, cpu_repeats in (
            ("test_rglru_function_gradients", (2, 300, 96), 3, args.repeats),
            ("serving shape", (4, 4096, 4096), 0, 1)):
        host = _inputs(*shape, seed)
        want = _run(rg_ops, *host)  # the CPU: the plain versions
        cpu_moved = sum(not all(torch.equal(a, w) for a, w in zip(_run(rg_ops, *host), want))
                        for _ in range(cpu_repeats - 1))
        card = [t.cuda() for t in host]
        first = [t.cpu() for t in _run(rg_ops, *card)]
        moved = 0
        for _ in range(args.repeats - 1):
            again = _run(rg_ops, *card)
            moved += not all(torch.equal(a.cpu(), f) for a, f in zip(again, first))
        errs = [float((f - w).abs().max()) for f, w in zip(first, want)]
        close = all(torch.allclose(f, w, **TOL) for f, w in zip(first, want))
        ok &= close and moved == 0 and cpu_moved == 0
        print(json.dumps(dict(case=what, shape=shape, repeats=args.repeats,
                              repeats_with_other_bits=moved, cpu_repeats=cpu_repeats,
                              cpu_repeats_with_other_bits=cpu_moved,
                              max_abs_err_vs_cpu={"h": errs[0], "dlog_a": errs[1],
                                                  "db": errs[2]},
                              within_tol=close)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi.strip(),
                          ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
