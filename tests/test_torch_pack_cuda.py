"""The pack passes of the port's CUDA kernels (``kernels/dense_bits.cuh``
for temporal_pagerank and temporal_cc, ``temporal_motif.cu``'s own) at
odd T and N, where T N N is not a multiple of 4 and the stack's last
16-byte word is partial.  The stack is a view that ends inside a larger
buffer whose rest is NaN, so an entry read past the stack's end would
show in the results.  Each kernel is held against its plain version:
PageRank within atol=1e-6, rtol=1e-5, components and motif counts bit for
bit.  Needs the card; run there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pack_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.temporal_cc import ops as cc_ops
from repro_torch.kernels.temporal_cc import ref as cc_ref
from repro_torch.kernels.temporal_motif import ops as motif_ops
from repro_torch.kernels.temporal_motif import ref as motif_ref
from repro_torch.kernels.temporal_pagerank import ops as pr_ops
from repro_torch.kernels.temporal_pagerank import ref as pr_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pack passes are CUDA kernels")
    return torch.device("cuda")


@pytest.mark.parametrize("T,N", [(3, 45), (1, 1), (5, 1295)])
def test_pack_odd_stack_on_card(card, T, N):
    rng = np.random.RandomState(T * 7919 + N)
    adj = ((rng.rand(T, N, N) < 0.1) * rng.uniform(-0.5, 2, (T, N, N))).astype(np.float32)
    adj[0] = adj[0] != 0  # a 0/1 timepoint beside weighted ones
    act = (rng.rand(T, N) < 0.8).astype(np.float32)
    buf = torch.full((T * N * N + 7,), float("nan"), device=card)
    stack = buf[:T * N * N].view(T, N, N)
    stack.copy_(torch.from_numpy(adj))
    a_cpu, act_cpu = torch.from_numpy(adj), torch.from_numpy(act)
    act_dev = act_cpu.to(card)

    got = pr_ops.temporal_pagerank(stack, act_dev).cpu()
    np.testing.assert_allclose(got.numpy(), pr_ref.pagerank_ref(a_cpu, act_cpu).numpy(),
                               atol=1e-6, rtol=1e-5)
    assert torch.equal(cc_ops.temporal_cc(stack, act_dev).cpu(), cc_ref.cc_ref(a_cpu, act_cpu))
    assert torch.equal(motif_ops.temporal_motif(stack).cpu(), motif_ref.motif_ref(a_cpu))
    assert torch.isnan(buf[T * N * N:]).all()
