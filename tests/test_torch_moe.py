"""repro_torch MoE FFN vs the reference (``repro.models.moe``) on the CPU,
in float32, with the reference's parameters carried over: the routing
integers (expert ids, positions in expert, capacities) bit for bit;
``moe_forward``'s output and load-balancing loss on both dispatch paths
within 1e-5, in one group and in several, and with a skewed router that
drops some (token, choice) at capacity, so the drop order is held too;
a token count that is no whole number of groups raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as ref_moe
from repro.models.common import Init as RefInit
from repro.models.sharding import Sharder, split_tree
from repro_torch.configs import get_config as port_config
from repro_torch.models import moe
from repro_torch.models.common import Init

TOL = dict(atol=1e-5, rtol=1e-5)
SHD = Sharder(mesh=None)
ARCH = "phi3.5-moe-42b-a6.6b"


def _setup(arch=ARCH, skew=0.0, seed=0, **kw):
    """The reduced config (optionally changed by ``kw``), the reference's
    MoE parameters and the port's module holding them.  ``skew`` turns
    expert 0's router column toward the all-ones direction, so tokens
    with a positive mean (``_x(..., offset=1)``) crowd into fewer experts."""
    cfg = get_config(arch).reduced().replace(**kw)
    ini = RefInit(rng=jax.random.PRNGKey(seed), param_dtype=jnp.float32)
    params = jax.tree.map(np.array, split_tree(ref_moe.init_moe(ini, cfg))[0])
    if skew:
        params["router"][:, 0] += skew / cfg.d_model
    pcfg = port_config(arch).reduced().replace(**kw)
    p = moe.MoE(Init(None, torch.float32, torch.device("cpu")), pcfg)
    p.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    return cfg, params, pcfg, p


def _x(B, S, D, seed=1, offset=0.0):
    return (np.random.RandomState(seed).randn(B, S, D) + offset).astype(np.float32)


@pytest.mark.parametrize("skew", [0.0, 2.0])
def test_routing_integers_equal_the_reference(skew):
    cfg, params, pcfg, p = _setup(skew=skew)
    x2d = _x(1, 96, cfg.d_model, offset=1.0 if skew else 0.0)[0]
    w_ref, idx_ref, aux_ref = ref_moe._route(params, jnp.asarray(x2d), cfg)
    w, idx, aux = moe._route(p, torch.from_numpy(x2d), pcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_ref), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), **TOL)
    pos_ref = ref_moe._positions_in_expert(idx_ref, cfg.n_experts)
    pos = moe._positions_in_expert(idx, pcfg.n_experts)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_ref))
    # batched over a leading group axis, as moe_forward calls it
    np.testing.assert_array_equal(moe._positions_in_expert(idx.view(2, 48, -1), 4).numpy(),
                                  np.stack([np.asarray(ref_moe._positions_in_expert(
                                      idx_ref[i * 48:(i + 1) * 48], 4)) for i in range(2)]))
    for g in (1, 7, 8, 96, 1000, 1024):
        for cf in (1.0, 1.25, 2.0):
            assert moe._capacity(pcfg.replace(capacity_factor=cf), g) == \
                ref_moe._capacity(cfg.replace(capacity_factor=cf), g)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("arch,B,S", [(ARCH, 2, 48), ("mixtral-8x22b", 2, 48),
                                      (ARCH, 2, 1024)])
def test_moe_forward_matches_reference(arch, B, S, impl):
    """One group of 96 tokens, and two full groups of GROUP tokens."""
    cfg, params, pcfg, p = _setup(arch)
    x = _x(B, S, cfg.d_model)
    want, want_aux = jax.jit(lambda p_, x_: ref_moe.moe_forward(p_, x_, cfg, SHD, impl=impl))(
        params, jnp.asarray(x))
    got, aux = moe.moe_forward(p, torch.from_numpy(x), pcfg, impl=impl)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_skewed_router_drops_in_the_reference_order(impl):
    """A skewed router overflows an expert's capacity: exactly the choices
    of each expert past its C-th in token-major order (a token's first
    choice before its second, earlier tokens first) are dropped, and the
    outputs still match the reference's."""
    cfg, params, pcfg, p = _setup(skew=2.0)
    x = _x(2, 48, cfg.d_model, seed=2, offset=1.0)
    _, idx, _ = moe._route(p, torch.from_numpy(x.reshape(96, -1)), pcfg)
    pos = moe._positions_in_expert(idx, pcfg.n_experts)
    C = moe._capacity(pcfg, 96)
    dropped = sorted(map(tuple, (pos >= C).nonzero().tolist()))
    assert dropped, "the skewed router drops no (token, choice)"
    past_capacity = []
    for e in range(pcfg.n_experts):
        order = [(t, j) for t in range(96) for j in range(pcfg.top_k) if idx[t, j] == e]
        past_capacity += order[C:]
    assert dropped == sorted(past_capacity)
    want, want_aux = ref_moe.moe_forward(params, jnp.asarray(x), cfg, SHD, impl=impl)
    got, aux = moe.moe_forward(p, torch.from_numpy(x), pcfg, impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    # a dropped choice contributes nothing: a token whose every choice is
    # dropped gets a zero output
    all_dropped = (pos >= C).all(dim=1)
    if all_dropped.any():
        assert (got.reshape(96, -1)[all_dropped] == 0).all()


def test_token_count_no_whole_number_of_groups_raises():
    _, _, pcfg, p = _setup()
    with pytest.raises(ValueError, match="no multiple"):
        moe.moe_forward(p, torch.zeros(1, moe.GROUP + 76, pcfg.d_model), pcfg)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_forward(p, torch.zeros(1, 8, pcfg.d_model), pcfg, impl="sort")
