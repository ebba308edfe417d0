#!/usr/bin/env python3
"""Does the CPU side of the RG-LRU gradient test move with the host's state?

``tests/test_torch_lm_bwd_cuda.py::test_rglru_function_gradients`` holds
the card's gradients against autograd through the plain scan on the CPU
(B=2 S=300 W=96, seed 3); twice the CPU side came out off.  This script
runs that CPU side (the forward h, dlog_a and db) again and again under
the conditions that could move its bits, and compares each run with the
first, bit for bit, and with the float64 recurrence:

* ``threads``: ``torch.set_num_threads(n)`` for n = 1, 2, 3, 4, 8, 16
  and the default;
* ``busy``: the same while a second process keeps every core busy with
  matrix products;
* ``after_card_tests`` (with a card): after the card test file's other
  tests in this process (``pytest.main``), then at every n again.

Prints one JSON line per condition (runs, runs with other bits, the
largest distance from float64 of each output), then one with the CPU's
vector capability and the default thread count; exits 1 if any run's
bits moved.

    python3 tools/rglru_cpu_threads.py [--repeats 5]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
THREADS = (1, 2, 3, 4, 8, 16)
BUSY = "import torch\nx = torch.randn(2048, 2048)\nwhile True:\n    x @ x\n"


def _inputs():
    g = torch.Generator(device="cpu").manual_seed(3)
    log_a = -torch.rand(2, 300, 96, generator=g) * 0.5
    b = torch.randn(2, 300, 96, generator=g)
    dh = torch.randn(2, 300, 96, generator=g)
    return log_a, b, dh


def _exact(log_a, b, dh):
    """(h, dlog_a, db) of the recurrence step by step in float64."""
    la, b, dh = (t.double() for t in (log_a, b, dh))
    a = la.exp()
    h, hs = torch.zeros_like(b[:, 0]), []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    h_all = torch.stack(hs, dim=1)
    h_prev = torch.cat([torch.zeros_like(h_all[:, :1]), h_all[:, :-1]], dim=1)
    g, gs = torch.zeros_like(h), []
    for t in reversed(range(b.shape[1])):
        g = dh[:, t] + (a[:, t + 1] * g if t + 1 < b.shape[1] else 0.0)
        gs.append(g)
    g = torch.stack(gs[::-1], dim=1)
    return h_all, g * a * h_prev, g


def _cpu_side(rg_ops, log_a, b, dh):
    la, bb = log_a.clone().requires_grad_(), b.clone().requires_grad_()
    h = rg_ops.rglru(la, bb)
    return [h.detach()] + list(torch.autograd.grad(h, (la, bb), dh))


def _condition(name, rg_ops, ins, first, exact, repeats, threads):
    moved, dist = 0, [0.0, 0.0, 0.0]
    default = torch.get_num_threads()
    try:
        for n in threads:
            torch.set_num_threads(n or default)
            for _ in range(repeats):
                got = _cpu_side(rg_ops, *ins)
                moved += not all(torch.equal(a, f) for a, f in zip(got, first))
                dist = [max(d, float((a.double() - x).abs().max()))
                        for d, a, x in zip(dist, got, exact)]
    finally:
        torch.set_num_threads(default)
    rec = dict(condition=name, threads=[n or default for n in threads], runs=repeats * len(threads),
               runs_with_other_bits=moved,
               max_distance_from_float64={"h": dist[0], "dlog_a": dist[1], "db": dist[2]})
    print(json.dumps(rec), flush=True)
    return moved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.rglru_scan import ops as rg_ops

    ins = _inputs()
    exact = _exact(*ins)
    first = _cpu_side(rg_ops, *ins)
    threads = THREADS + (0,)  # 0: the default count
    moved = _condition("threads", rg_ops, ins, first, exact, args.repeats, threads)
    busy = subprocess.Popen([sys.executable, "-c", BUSY])
    try:
        moved += _condition("busy", rg_ops, ins, first, exact, args.repeats, threads)
    finally:
        busy.kill()
        busy.wait()
    if torch.cuda.is_available():
        import pytest

        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "cuda",
                          str(ROOT / "tests" / "test_torch_lm_bwd_cuda.py"),
                          "-k", "not test_rglru_function_gradients"])
        print(json.dumps(dict(card_tests_exit=int(rc))), flush=True)
        moved += _condition("after_card_tests", rg_ops, ins, first, exact, args.repeats,
                            threads)
    print(json.dumps(dict(cpu_capability=torch.backends.cpu.get_cpu_capability(),
                          default_threads=torch.get_num_threads(), torch=torch.__version__,
                          runs_with_other_bits=moved)), flush=True)
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
