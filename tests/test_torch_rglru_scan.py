"""repro_torch rglru_scan vs the reference: the port's op on CPU tensors
(the plain PyTorch version the CPU path runs, a log-depth scan) against
the reference Pallas kernel in interpret mode and against the model's
associative scan (``repro.models.recurrent.rglru_scan``), on the grid of
the reference's own kernel test, within its tolerance (atol = rtol =
2e-5: float32 products taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import ops as ref_ops
from repro.models.recurrent import rglru_scan as ref_scan
from repro_torch.kernels.rglru_scan import ops, ref

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, S, W, spread=0.5):
    rng = np.random.RandomState(seed)
    log_a = -np.abs(rng.randn(B, S, W)).astype(np.float32) * spread
    b = rng.randn(B, S, W).astype(np.float32)
    return log_a, b


@pytest.mark.parametrize("B,S,W,chunk", [(1, 128, 128, 32), (2, 64, 256, 16),
                                         (1, 96, 130, 32), (2, 33, 64, 16)])
def test_rglru_matches_reference_kernel_and_scan(B, S, W, chunk):
    log_a, b = _inputs(S + W, B, S, W)
    launches = dict(ops.LAUNCHES)
    got = ops.rglru(torch.from_numpy(log_a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, W)
    assert ops.LAUNCHES == launches  # the CPU path launches no kernel
    pallas = ref_ops.rglru(jnp.asarray(log_a), jnp.asarray(b), chunk=chunk, tile_w=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_scan(jnp.asarray(log_a),
                                                                jnp.asarray(b))), **TOL)


def test_rglru_matches_sequential():
    log_a, b = _inputs(3, 1, 40, 32, spread=1.0)
    h = np.zeros((1, 32), np.float32)
    seq = []
    for t in range(40):
        h = np.exp(log_a[:, t]) * h + b[:, t]
        seq.append(h.copy())
    got = ops.rglru(torch.from_numpy(log_a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), **TOL)


def test_rglru_rejects_other_devices():
    with pytest.raises(ValueError):
        ops.rglru(torch.zeros(1, 4, 4, device="meta"), torch.zeros(1, 4, 4, device="meta"))


CHUNK = ops.CHUNK


@pytest.mark.parametrize("B,S,W", [(2, 1, 33), (1, CHUNK - 1, 33), (2, CHUNK, 17),
                                   (1, CHUNK + 1, 65), (1, 3 * CHUNK + 5, 31)])
def test_rglru_chunked_decomposition_matches_reference_kernel(B, S, W):
    """The CUDA kernel's decomposition (chunk aggregates, a serial carry,
    a rescan from the carry) in plain PyTorch, at the kernel's chunk and
    at ragged S and odd W, against the reference Pallas kernel in
    interpret mode and the port's plain version."""
    log_a, b = _inputs(S * 7 + W, B, S, W)
    got = ref.rglru_chunked_ref(torch.from_numpy(log_a), torch.from_numpy(b), CHUNK)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, W)
    pallas = ref_ops.rglru(jnp.asarray(log_a), jnp.asarray(b), chunk=CHUNK, tile_w=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got.numpy(), ref.rglru_ref(torch.from_numpy(log_a), torch.from_numpy(b)).numpy(),
        **TOL)


@pytest.mark.parametrize("chunk", [1, 2, 7, 16])
def test_rglru_chunked_decomposition_any_chunk(chunk):
    """Chunks shorter than the sequence, a ragged last chunk included, and
    a chunk of one step (every step its own carry), against the
    step-by-step recurrence."""
    log_a, b = _inputs(chunk, 2, 45, 9, spread=1.0)
    h = np.zeros((2, 9), np.float32)
    seq = []
    for t in range(45):
        h = np.exp(log_a[:, t]) * h + b[:, t]
        seq.append(h.copy())
    got = ref.rglru_chunked_ref(torch.from_numpy(log_a), torch.from_numpy(b), chunk)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), **TOL)
