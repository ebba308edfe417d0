"""repro_torch rglru_scan vs the reference: the port's op on CPU tensors
(the plain PyTorch version the CPU path runs, a log-depth scan) against
the reference Pallas kernel in interpret mode and against the model's
associative scan (``repro.models.recurrent.rglru_scan``), on the grid of
the reference's own kernel test, within its tolerance (atol = rtol =
2e-5: float32 products taken in another order)."""
import jax
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


def _sequential64(log_a, b):
    """The recurrence step by step in float64: the yardstick that says
    which side of a failed comparison moved."""
    h, out = np.zeros(b[:, 0].shape), np.empty(b.shape)
    for t in range(b.shape[1]):
        h = np.exp(log_a[:, t].astype(np.float64)) * h + b[:, t]
        out[:, t] = h
    return out


def _assert_close(got, want, log_a, b, what):
    """``got`` (the port) within TOL of ``want`` (``what``); a failure
    names the values off, the largest error, its index, both sides and
    the float64 recurrence there, and each side's largest distance from
    the recurrence."""
    err = np.abs(got - want)
    off = err > TOL["atol"] + TOL["rtol"] * np.abs(want)
    if not off.any():
        return
    exact = _sequential64(log_a, b)
    i = tuple(int(j) for j in np.unravel_index(err.argmax(), err.shape))
    pytest.fail(f"port vs {what}: {int(off.sum())} of {err.size} values off; largest "
                f"{err[i]:.3g} at {i}: port {got[i]!r}, {what} {want[i]!r}, float64 "
                f"recurrence {exact[i]!r}; largest distance from the recurrence: port "
                f"{np.abs(got - exact).max():.3g}, {what} {np.abs(want - exact).max():.3g}")


@pytest.mark.parametrize("B,S,W,chunk", [(1, 128, 128, 32), (2, 64, 256, 16),
                                         (1, 96, 130, 32), (2, 33, 64, 16)])
def test_rglru_matches_reference_kernel_and_scan(B, S, W, chunk):
    log_a, b = _inputs(S + W, B, S, W)
    launches = dict(ops.LAUNCHES)
    got = ops.rglru(torch.from_numpy(log_a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, W)
    assert ops.LAUNCHES == launches  # the CPU path launches no kernel
    pallas = ref_ops.rglru(jnp.asarray(log_a), jnp.asarray(b), chunk=chunk, tile_w=64)
    _assert_close(got.numpy(), np.asarray(pallas), log_a, b, "Pallas kernel")
    _assert_close(got.numpy(), np.asarray(ref_scan(jnp.asarray(log_a), jnp.asarray(b))),
                  log_a, b, "associative scan")


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
    """Only CUDA tensors reach the kernels: their launch path rejects any
    other device.  CPU and ``meta`` tensors take the plain version before
    it (``meta`` in the dry run, where it computes nothing)."""
    for dev in ("meta", "cpu"):
        t = torch.zeros(1, 4, 4, device=dev)
        with pytest.raises(ValueError):
            ops._check("rglru", t, t)
    meta = torch.zeros(1, 4, 4, device="meta")
    launches = dict(ops.LAUNCHES)
    assert ops.rglru(meta, meta).device.type == "meta"
    assert ops.LAUNCHES == launches


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


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

BWD_TOL = dict(atol=1e-5, rtol=1e-5)


@jax.jit
def _jax_vjp(log_a, b, dh):
    from repro.kernels.rglru_scan.ref import rglru_ref as jax_rglru

    h, vjp = jax.vjp(jax_rglru, log_a, b)
    return (h, *vjp(dh))


def _ref_vjp(log_a, b, dh):
    """The reference's gradients: jax.vjp of its oracle ``rglru_ref``."""
    return [np.asarray(a) for a in _jax_vjp(*(jnp.asarray(a) for a in (log_a, b, dh)))]


@pytest.mark.parametrize("B,S,W", [(1, 1, 8), (2, 37, 16), (1, 128, 33), (2, 3 * CHUNK + 5, 9)])
def test_rglru_bwd_ref_matches_jax_vjp(B, S, W):
    log_a, b = _inputs(S * 3 + W, B, S, W)
    dh = np.random.RandomState(S).randn(B, S, W).astype(np.float32)
    h, dla, db = _ref_vjp(log_a, b, dh)
    got = ref.rglru_bwd_ref(torch.from_numpy(log_a), torch.from_numpy(h), torch.from_numpy(dh))
    assert all(g.dtype == torch.float32 and tuple(g.shape) == (B, S, W) for g in got)
    np.testing.assert_allclose(got[0].numpy(), dla, **BWD_TOL)
    np.testing.assert_allclose(got[1].numpy(), db, **BWD_TOL)


@pytest.mark.parametrize("S,chunk,W", [
    pytest.param(S, chunk, W, id=f"{S}-{chunk}" + (f"-{W}" if W != 17 else ""))
    for S, chunk, W in [(2 * CHUNK + 7, CHUNK, 17), (CHUNK, CHUNK, 17), (45, 7, 17),
                        (45, 1, 17), (1, CHUNK, 4), (CHUNK - 1, CHUNK, 33),
                        (3 * CHUNK + 5, CHUNK, 132)]])
def test_rglru_bwd_chunked_decomposition_matches_jax_vjp(S, chunk, W):
    """The backward kernel's decomposition (chunk aggregates walking back,
    a carry from the last chunk to the first, a rescan from each carry),
    with a ragged last chunk, against the reference's gradients; at the
    kernel's chunk also S = 1, S < chunk, and widths whose last lane tile
    is partial (W = 4, 33, 132 against the kernel's 64 lanes a block)."""
    log_a, b = _inputs(S + chunk, 2, S, W, spread=1.0)
    dh = np.random.RandomState(chunk).randn(2, S, W).astype(np.float32)
    h, dla, db = _ref_vjp(log_a, b, dh)
    got = ref.rglru_bwd_chunked_ref(torch.from_numpy(log_a), torch.from_numpy(h),
                                    torch.from_numpy(dh), chunk)
    np.testing.assert_allclose(got[0].numpy(), dla, **BWD_TOL)
    np.testing.assert_allclose(got[1].numpy(), db, **BWD_TOL)


def test_rglru_function_plumbing_on_cpu():
    """``RGLRUScan`` (what the wrapper applies on the card) run on CPU
    tensors, where its forward and backward calls take the plain versions:
    the gradients autograd gives through it equal the reference's."""
    log_a, b = _inputs(9, 2, 70, 24)
    dh = np.random.RandomState(1).randn(2, 70, 24).astype(np.float32)
    la, bb = (torch.from_numpy(a).requires_grad_() for a in (log_a, b))
    launches = dict(ops.LAUNCHES)
    got = torch.autograd.grad(ops.RGLRUScan.apply(la, bb), (la, bb), torch.from_numpy(dh))
    assert ops.LAUNCHES == launches
    _, dla, db = _ref_vjp(log_a, b, dh)
    np.testing.assert_allclose(got[0].numpy(), dla, **BWD_TOL)
    np.testing.assert_allclose(got[1].numpy(), db, **BWD_TOL)
