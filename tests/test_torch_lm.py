"""repro_torch LM serving path vs the reference, on
``recurrentgemma-9b.reduced()`` (5 layers: 2 remainder recurrent layers,
one (rec, rec, attn) unit; float32) with the reference's parameters
carried over by ``lm_params_from_arrays``: forward logits, prefill logits
and every cache entry at S = 48 > window 32 (the ring roll), 8 decode
steps teacher-forced on the same tokens (so a near-tie cannot derail the
run), all within atol = rtol = 1e-4 (float32, sums in another order);
``serve`` tokens equal to the reference's ``serve`` loop; the same for
the MoE (reduced mixtral-8x22b, phi3.5-moe) and xLSTM families; the dense
configs' forward through the same code; the guards."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models.sharding import Sharder, split_tree
from repro_torch import carry
from repro_torch.configs import get_config as port_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention, lm, recurrent

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH, S, CACHE = "recurrentgemma-9b", 48, 64
SHD = Sharder(mesh=None)


def _setup(arch, seed=0):
    cfg = get_config(arch).reduced()
    params = jax.tree.map(np.asarray, split_tree(
        ref_lm.init(jax.random.PRNGKey(seed), cfg, max_seq=CACHE))[0])
    pcfg = port_config(arch).reduced()
    model = lm.from_state_dict(pcfg, carry.lm_params_from_arrays(pcfg, params), device="cpu")
    return cfg, params, pcfg, model


@pytest.fixture(scope="module")
def setup():
    cfg, params, pcfg, model = _setup(ARCH)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, S + 8)).astype(np.int32)
    return cfg, params, pcfg, model, tokens


def test_layers_follow_the_reference_order(setup):
    cfg, params, pcfg, model, _ = setup
    assert [b.kind for b in model.layers] == ["rec", "rec", "rec", "rec", "attn"]
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n


def test_forward_logits(setup):
    cfg, params, _, model, tokens = setup
    want = jax.jit(lambda p, b: ref_lm.forward(p, b, cfg, SHD)[0])(
        params, {"tokens": tokens[:, :S]})
    got = model(torch.from_numpy(tokens[:, :S]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_entries(got_tree, want_tree):
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        got = got_tree
        for key in path:
            got = got[key.key]
        yield str(path), got, np.asarray(want)


def _prefill_and_decode(cfg, params, pcfg, model, tokens):
    """Prefill logits and every cache entry, then 8 decode steps
    teacher-forced on ``tokens``, against the reference; returns the
    port's cache tree after the prefill."""
    want_l, want_c = jax.jit(lambda p, b: ref_lm.prefill(p, b, cfg, SHD, cache_len=CACHE))(
        params, {"tokens": tokens[:, :S]})
    got_l, got_c = model.prefill(torch.from_numpy(tokens[:, :S]), cache_len=CACHE)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    got_tree = carry.lm_cache_to_arrays(pcfg, got_c)
    for path, got, want in _cache_entries(got_tree, want_c):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, cfg, SHD))
    for i in range(8):
        pos = np.full((2,), S + i, np.int32)
        tok = tokens[:, S + i:S + i + 1]
        want_l, want_c = step(params, want_c, tok, pos)
        got_l, got_c = model.decode_step(got_c, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), err_msg=f"step {i}", **TOL)
    return got_tree


def test_prefill_caches_and_decode(setup):
    cfg, params, pcfg, model, tokens = setup
    got_tree = _prefill_and_decode(cfg, params, pcfg, model, tokens)
    assert got_tree["units"]["b2"]["attn"]["k"].shape[2] == 32  # window-sized ring


def test_decode_from_empty_caches(setup):
    """Decode from fresh caches (``init_attn_cache`` / ``init_rec_cache``:
    every ring slot a hole, zero state) against the reference's
    ``init_cache``: 3 steps, the caches the same after them."""
    from repro.models.common import Init as RefInit

    cfg, params, pcfg, model, tokens = setup
    ini = RefInit(rng=jax.random.PRNGKey(0), param_dtype=jnp.float32)
    want_c = split_tree(ref_lm.init_cache(ini, cfg, 2, CACHE, 1))[0]
    got_c = [{"attn": attention.init_attn_cache(pcfg, 2, CACHE, "cpu")} if b.kind == "attn"
             else {"rec": recurrent.init_rec_cache(pcfg, 2, "cpu")} for b in model.layers]
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, cfg, SHD))
    for i in range(3):
        pos = np.full((2,), i, np.int32)
        want_l, want_c = step(params, want_c, tokens[:, i:i + 1], pos)
        got_l, got_c = model.decode_step(got_c, torch.from_numpy(tokens[:, i:i + 1]),
                                         torch.from_numpy(pos))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), err_msg=f"step {i}", **TOL)
    got_tree = carry.lm_cache_to_arrays(pcfg, got_c)
    assert (got_tree["units"]["b2"]["attn"]["k_pos"] == -1).sum() == 2 * (32 - 3)
    for path, got, want in _cache_entries(got_tree, want_c):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


def test_serve_tokens_equal_the_reference():
    cfg, params, pcfg, _ = _setup(ARCH)
    kw = dict(batch=2, prompt_len=40, gen_tokens=6, reduced=True, seed=0)
    want, _ = ref_serve.serve(ARCH, **kw)
    got, stats = port_serve.serve(ARCH, **kw, device="cpu",
                                  params=carry.lm_params_from_arrays(pcfg, params))
    assert got.dtype == np.int32 and got.shape == (2, 6) and stats["logits_finite"]
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-7b", "minitron-8b", "granite-3-8b"])
def test_dense_config_forward(arch):
    """The attention-only configs through the same blocks: GQA
    (repeat_interleave), qk-norm (qwen3), qkv biases (qwen2), LayerNorm
    and squared-ReLU FFN (minitron), full causal attention."""
    cfg, params, _, model = _setup(arch)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    want = jax.jit(lambda p, b: ref_lm.forward(p, b, cfg, SHD)[0])(params, {"tokens": tokens})
    np.testing.assert_allclose(model(torch.from_numpy(tokens)).numpy(), np.asarray(want), **TOL)


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.serve(ARCH)


MOE_XLSTM = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "xlstm-350m"]


@pytest.mark.parametrize("arch", MOE_XLSTM)
def test_moe_and_xlstm_forward_prefill_and_decode(arch):
    """The MoE and xLSTM families, reduced: mixtral (an MoE FFN of 4
    experts, top 2, window 32 < S, so the ring roll), phi3.5-moe (full
    causal attention, LayerNorm) and xlstm (3 mLSTM + 1 sLSTM blocks, 3
    chunks of 16, tied embeddings, no positions): forward logits and the
    MoE load-balancing loss, prefill logits, every cache entry (the
    experts' layers' KV, the mLSTM {C, n, m, conv} and sLSTM {c, n, h, m}
    states) and 8 teacher-forced decode steps."""
    cfg, params, pcfg, model = _setup(arch)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, S + 8)).astype(np.int32)
    want, want_aux = jax.jit(lambda p, b: ref_lm.forward(p, b, cfg, SHD))(
        params, {"tokens": tokens[:, :S]})
    got, aux = model.forward_with_aux(torch.from_numpy(tokens[:, :S]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert (float(aux) > 0) == cfg.is_moe
    _prefill_and_decode(cfg, params, pcfg, model, tokens)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "xlstm-350m"])
def test_moe_and_xlstm_serve_tokens_equal_the_reference(arch):
    cfg, params, pcfg, _ = _setup(arch)
    kw = dict(batch=2, prompt_len=48, gen_tokens=6, reduced=True, seed=0)
    want, _ = ref_serve.serve(arch, **kw)
    got, stats = port_serve.serve(arch, **kw, device="cpu",
                                  params=carry.lm_params_from_arrays(pcfg, params))
    assert got.shape == (2, 6) and stats["logits_finite"]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_takes_a_depth_cut_model():
    """``serve(params=model)`` runs a model of the serving config cut in
    depth, and refuses one that differs in anything else."""
    pcfg = port_serve.serving_config("phi3.5-moe-42b-a6.6b")
    cut = lm.init(pcfg.replace(n_layers=2), seed=0, device="cpu")
    got, stats = port_serve.serve("phi3.5-moe-42b-a6.6b", batch=1, prompt_len=8, gen_tokens=3,
                                  device="cpu", params=cut)
    assert got.shape == (1, 3) and stats["logits_finite"]
    other = lm.init(pcfg.replace(n_layers=2, d_ff=64), seed=0, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        port_serve.serve("phi3.5-moe-42b-a6.6b", device="cpu", params=other)
