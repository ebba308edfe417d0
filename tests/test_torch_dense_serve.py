"""repro_torch's dense family with grouped KV heads against the reference.

``ModelConfig.reduced()`` keeps at most 4 query heads and as many KV
heads, so the reduced dense configs attend with KV = H and the branch of
``_expand_kv`` that repeats more than one KV head runs only at full
width.  Here each dense config's reduced form keeps grouped heads on both
sides, ``n_heads=8, n_kv_heads=2`` (4 query heads a KV head), and
``qwen2-7b`` also its own 7:1 ratio as ``n_heads=14, n_kv_heads=2``, with
the reference's weights carried over by ``lm_params_from_arrays``:
forward logits; prefill logits and every cache entry, then 8 decode
steps teacher-forced on the same tokens; ``serve`` tokens equal to the
reference's ``serve`` loop (both given the grouped config); and, for the
7:1 ratio, the loss and every parameter's gradient against ``jax.grad``
of the reference's loss, which runs the backward of
``repeat_interleave``.  float32, atol = rtol = 1e-4 (sums in another
order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.models.sharding import Sharder, split_tree
from repro.train import steps as ref_steps
from repro_torch import carry
from repro_torch.configs import get_config as port_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import lm
from repro_torch.train import make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4  # of max(1, max |g_ref|), as tests/test_torch_train.py
S, CACHE, STEPS = 40, 64, 8
SHD = Sharder(mesh=None)

GROUPED = [("qwen3-1.7b", 8, 2), ("qwen2-7b", 8, 2), ("granite-3-8b", 8, 2),
           ("minitron-8b", 8, 2), ("qwen2-7b", 14, 2)]
CHECKS = ["forward", "prefill_and_decode", "serve", "gradients"]
# the loss and gradients on one config: qwen2-7b's own 7:1 ratio (with its
# qkv biases), the widest repeat
GRAD_CASE = ("qwen2-7b", 14, 2)
CASES = [(*g, c) for g in GROUPED for c in CHECKS if c != "gradients" or g == GRAD_CASE]


def _grouped(get, arch, heads, kv):
    return get(arch).reduced().replace(n_heads=heads, n_kv_heads=kv)


@functools.lru_cache(maxsize=None)
def _setup(arch, heads, kv):
    """(reference config, its parameters as numpy, port config, the
    carried state dict), seed 0."""
    cfg = _grouped(get_config, arch, heads, kv)
    params = jax.tree.map(np.asarray, split_tree(
        ref_lm.init(jax.random.PRNGKey(0), cfg, max_seq=CACHE))[0])
    pcfg = _grouped(port_config, arch, heads, kv)
    return cfg, params, pcfg, carry.lm_params_from_arrays(pcfg, params)


def _tokens(cfg, n, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(2, n)).astype(np.int32)


def _cache_entries(got_tree, want_tree):
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        got = got_tree
        for key in path:
            got = got[key.key]
        yield str(path), got, np.asarray(want)


def _forward(cfg, params, pcfg, state):
    model = lm.from_state_dict(pcfg, state, device="cpu")
    tokens = _tokens(cfg, S)
    want = jax.jit(lambda p, b: ref_lm.forward(p, b, cfg, SHD)[0])(params, {"tokens": tokens})
    got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prefill_and_decode(cfg, params, pcfg, state):
    model = lm.from_state_dict(pcfg, state, device="cpu")
    tokens = _tokens(cfg, S + STEPS)
    want_l, want_c = jax.jit(lambda p, b: ref_lm.prefill(p, b, cfg, SHD, cache_len=CACHE))(
        params, {"tokens": tokens[:, :S]})
    with torch.inference_mode():
        got_l, got_c = model.prefill(torch.from_numpy(tokens[:, :S]), cache_len=CACHE)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    got_tree = carry.lm_cache_to_arrays(pcfg, got_c)
    entries = list(_cache_entries(got_tree, want_c))
    # the caches hold the KV heads, not the query heads
    assert any(got.ndim == 5 and got.shape[3] == pcfg.n_kv_heads for _, got, _ in entries)
    for path, got, want in entries:
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, cfg, SHD))
    for i in range(STEPS):
        pos = np.full((2,), S + i, np.int32)
        tok = tokens[:, S + i:S + i + 1]
        want_l, want_c = step(params, want_c, tok, pos)
        with torch.inference_mode():
            got_l, got_c = model.decode_step(got_c, torch.from_numpy(tok),
                                             torch.from_numpy(pos))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), err_msg=f"step {i}",
                                   **TOL)
    for path, got, want in _cache_entries(carry.lm_cache_to_arrays(pcfg, got_c), want_c):
        np.testing.assert_allclose(got, want, err_msg=f"after decode: {path}", **TOL)


def _serve(cfg, params, pcfg, state, monkeypatch):
    """Both ``serve`` loops given the grouped config (``reduced=False``
    takes it as it is); the reference draws its weights from seed 0 as
    ``_setup`` did."""
    monkeypatch.setattr(ref_serve, "get_config", lambda arch: cfg)
    monkeypatch.setattr(port_serve, "get_config", lambda arch: pcfg)
    kw = dict(batch=2, prompt_len=S, gen_tokens=6, reduced=False, seed=0)
    want, _ = ref_serve.serve(cfg.name, **kw)
    got, stats = port_serve.serve(cfg.name, **kw, device="cpu", params=state)
    assert got.shape == (2, 6) and stats["logits_finite"]
    np.testing.assert_array_equal(got, np.asarray(want))


def _gradients(cfg, params, pcfg, state):
    toks = _tokens(cfg, S + 1, seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (want_total, _), grads = jax.jit(jax.value_and_grad(
        ref_steps.make_loss_fn(cfg, SHD), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = carry.lm_params_from_arrays(pcfg, jax.tree.map(np.asarray, grads))
    model = lm.from_state_dict(pcfg, state, device="cpu").requires_grad_(True)
    total, _ = make_loss_fn(pcfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g is not None and g.shape == w.shape, k
        bound = GRAD_TOL * max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("arch,heads,kv,check", CASES,
                         ids=[f"{a}-{h}over{k}-{c}" for a, h, k, c in CASES])
def test_grouped_kv_heads_match_the_reference(arch, heads, kv, check, monkeypatch):
    cfg, params, pcfg, state = _setup(arch, heads, kv)
    assert pcfg.n_heads == heads and pcfg.n_kv_heads == kv and pcfg.family == "dense"
    if check == "forward":
        _forward(cfg, params, pcfg, state)
    elif check == "prefill_and_decode":
        _prefill_and_decode(cfg, params, pcfg, state)
    elif check == "serve":
        _serve(cfg, params, pcfg, state, monkeypatch)
    else:
        _gradients(cfg, params, pcfg, state)
