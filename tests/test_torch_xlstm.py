"""repro_torch xLSTM blocks vs the reference (``repro.models.xlstm_blocks``)
on the CPU, in float32, within 1e-5 (sums in another order), with the
reference's parameters carried over: ``group_norm_heads``; the chunkwise
mLSTM (S = 48, chunk 16) against the reference's chunkwise form and
against a loop of the reference's ``mlstm_step``, from a zero state and
from a carried one; ``mlstm_step``; the sLSTM sequence and its final
state; both blocks' full-sequence and decode functions with their caches;
and a sequence that is no multiple of the chunk raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import common as ref_common
from repro.models import xlstm_blocks as ref_xl
from repro.models.common import Init as RefInit
from repro.models.sharding import Sharder, split_tree
from repro_torch.configs import get_config as port_config
from repro_torch.models import common, xlstm_blocks as xl
from repro_torch.models.common import Init

TOL = dict(atol=1e-5, rtol=1e-5)
SHD = Sharder(mesh=None)
ARCH = "xlstm-350m"
B, S, H, d, CHUNK = 2, 48, 4, 16, 16


def _rng(seed):
    return np.random.RandomState(seed)


def _qkvif(seed=0):
    r = _rng(seed)
    q, k, v = (r.randn(B, S, H, d).astype(np.float32) for _ in range(3))
    i_pre = r.randn(B, S, H).astype(np.float32)
    f_pre = (r.randn(B, S, H) + 2.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _state(seed=5):
    r = _rng(seed)
    return (r.randn(B, H, d, d).astype(np.float32) * 0.3,
            r.randn(B, H, d).astype(np.float32) * 0.3,
            r.randn(B, H).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_group_norm_heads():
    r = _rng(3)
    x, scale = r.randn(2, 5, 4, 16).astype(np.float32), r.randn(4, 16).astype(np.float32)
    want = ref_common.group_norm_heads(jnp.asarray(x), jnp.asarray(scale))
    got = common.group_norm_heads(*_t(x, scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bf = common.group_norm_heads(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_matches_reference_and_the_step_loop(carried):
    ins = _qkvif()
    state = _state() if carried else None
    h_ref, st_ref = jax.jit(ref_xl.mlstm_chunkwise, static_argnums=5)(
        *map(jnp.asarray, ins), CHUNK,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    h, st = xl.mlstm_chunkwise(*_t(*ins), CHUNK,
                               state=None if state is None else tuple(_t(*state)))
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, H, d)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)
    for a, w in zip(st, st_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    # the recurrence itself: the reference's step, token by token
    q, k, v, i_pre, f_pre = map(jnp.asarray, ins)
    carry = (tuple(map(jnp.asarray, state)) if carried else
             (jnp.zeros((B, H, d, d)), jnp.zeros((B, H, d)), jnp.zeros((B, H))))
    hs, step = [], jax.jit(ref_xl.mlstm_step)
    for t in range(S):
        ht, carry = step(q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t], carry)
        hs.append(ht)
    np.testing.assert_allclose(h.numpy(), np.stack(hs, 1), atol=1e-4, rtol=1e-4)
    for a, w in zip(st, carry):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_mlstm_step_matches_reference():
    q, k, v, i_pre, f_pre = (a[:, 0] for a in _qkvif(seed=1))
    state = _state()
    h_ref, st_ref = ref_xl.mlstm_step(*map(jnp.asarray, (q, k, v, i_pre, f_pre)),
                                      tuple(map(jnp.asarray, state)))
    h, st = xl.mlstm_step(*_t(q, k, v, i_pre, f_pre), tuple(_t(*state)))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **TOL)
    for a, w in zip(st, st_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_mlstm_sequence_no_multiple_of_the_chunk_raises():
    ins = [a[:, :40] for a in _qkvif()]
    with pytest.raises(ValueError, match="no multiple"):
        xl.mlstm_chunkwise(*_t(*ins), CHUNK)


def _block(kind, seed=0):
    cfg = get_config(ARCH).reduced()
    ini = RefInit(rng=jax.random.PRNGKey(seed), param_dtype=jnp.float32)
    init = ref_xl.init_mlstm_block if kind == "mlstm" else ref_xl.init_slstm_block
    params = jax.tree.map(np.asarray, split_tree(init(ini, cfg))[0])
    pcfg = port_config(ARCH).reduced()
    mod = (xl.MLSTMBlock if kind == "mlstm" else xl.SLSTMBlock)(
        Init(None, torch.float32, torch.device("cpu")), pcfg)
    mod.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    x = _rng(7).randn(B, S, cfg.d_model).astype(np.float32)
    return cfg, params, pcfg, mod, x


def test_slstm_sequence_matches_reference():
    cfg, params, pcfg, mod, x = _block("slstm")
    r = _rng(9)
    state = tuple(r.randn(B, H, cfg.d_model // H).astype(np.float32) * 0.5 for _ in range(4))
    hs_ref, st_ref = jax.jit(lambda p, x_, st: ref_xl.slstm_sequence(p, x_, cfg, st))(
        params, jnp.asarray(x), tuple(map(jnp.asarray, state)))
    hs, st = xl.slstm_sequence(mod, torch.from_numpy(x), tuple(_t(*state)))
    assert tuple(hs.shape) == (B, S, H, cfg.d_model // H)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_ref), **TOL)
    for a, w in zip(st, st_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_cache_and_decode_match_reference(kind):
    """The full-sequence function over two chunks, the cache it returns,
    and one decode step from it, against the reference's forward, its
    prefill cache (``_block_prefill_cache``'s arithmetic) and decode."""
    cfg, params, pcfg, mod, x = _block(kind)
    fwd, dec = ((ref_xl.mlstm_forward, ref_xl.mlstm_decode) if kind == "mlstm"
                else (ref_xl.slstm_forward, ref_xl.slstm_decode))
    pfwd, pdec = ((xl.mlstm_forward, xl.mlstm_decode) if kind == "mlstm"
                  else (xl.slstm_forward, xl.slstm_decode))
    xs = jnp.asarray(x[:, :S - CHUNK])
    want = jax.jit(lambda p, x_: fwd(p, x_, cfg, SHD))(params, xs)
    got, cache = pfwd(mod, torch.from_numpy(x[:, :S - CHUNK]), pcfg, with_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @jax.jit
    def prefill_cache(params, xs):
        if kind == "mlstm":
            up = jnp.einsum("bsd,dcf->bscf", xs, params["up"])
            q, k, v, i_pre, f_pre, _ = ref_xl._mlstm_qkvif(params, up[:, :, 1], cfg)
            _, (C, n, m) = ref_xl.mlstm_chunkwise(q, k, v, i_pre, f_pre, cfg.mlstm_chunk)
            return {"C": C, "n": n, "m": m, "conv": up[:, -(cfg.conv_width - 1):, 1]}
        z = jnp.zeros((B, H, cfg.d_model // H), jnp.float32)
        return dict(zip("cnhm", ref_xl.slstm_sequence(params, xs, cfg, (z, z, z, z))[1]))

    ref_cache = prefill_cache(params, xs)
    assert cache.keys() == ref_cache.keys()
    for key, w in ref_cache.items():
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(w), err_msg=key, **TOL)
    x1 = x[:, S - CHUNK:S - CHUNK + 1]
    want_y, want_c = jax.jit(lambda p, x_, c: dec(p, x_, c, cfg, SHD))(
        params, jnp.asarray(x1), ref_cache)
    got_y, got_c = pdec(mod, torch.from_numpy(x1), cache, pcfg)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    for key, w in want_c.items():
        np.testing.assert_allclose(got_c[key].numpy(), np.asarray(w), err_msg=key, **TOL)
