"""repro_torch encoder-decoder and image-prefix models vs the reference, on
the CPU: reduced ``whisper-small`` (2 encoder layers over 24 frames,
learned decoder positions, LayerNorm, GELU, biases, tied embeddings) and
reduced ``phi-3-vision-4.2b`` (8 image tokens before the text, rope over
both), each with 2 decoder layers, the reference's weights carried over by
``lm_params_from_arrays`` and seeded non-zero image embeddings and frames:
forward logits, prefill logits and every cache entry (``ck``/``cv``
included), 8 teacher-forced decode steps (positions after the image
prefix, ``pos[pos]`` at decode), a train step's loss (the image
positions' logits dropped) and gradients, all within atol = rtol = 1e-4
(float32, sums in another order); ``serve`` tokens and 3 steps of
``launch.train.run`` equal to the reference's; ``sinusoidal_positions``
bit for bit against the reference's; a
``pos_kind="sinusoidal"`` decoder (no position input) equal to the
reference's.  And the reference's serve fault: with an image prefix
longer than ``gen_tokens + 8`` its KV cache has no room for the decode
tokens, so the first step overwrites image token 0; the port's model
repeats that when given the same ``cache_len``, and the port's ``serve``
keeps every position."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.models.sharding import Sharder, split_tree
from repro.train import steps as ref_steps
from repro_torch import carry
from repro_torch.configs import get_config as port_config
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import common, lm
from repro_torch.train import make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["whisper-small", "phi-3-vision-4.2b"]
S, CACHE, STEPS = 24, 64, 8
SHD = Sharder(mesh=None)
GRAD_TOL = 1e-4


def _configs(arch, **kw):
    return (get_config(arch).reduced().replace(**kw),
            port_config(arch).reduced().replace(**kw))


def _carry(cfg, pcfg, max_seq, seed=0):
    params = jax.tree.map(np.asarray, split_tree(
        ref_lm.init(jax.random.PRNGKey(seed), cfg, max_seq=max_seq))[0])
    return params, carry.lm_params_from_arrays(pcfg, params)


def _inputs(cfg, seed=0, batch=2, n=S + STEPS):
    """Tokens and the stub frontends' inputs, seeded and non-zero."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, size=(batch, n)).astype(np.int32)}
    if cfg.n_img_tokens:
        out["img_embeds"] = (rng.randn(batch, cfg.n_img_tokens, cfg.d_model) * 0.5) \
            .astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = (rng.randn(batch, cfg.enc_seq, cfg.d_model) * 0.5).astype(np.float32)
    return out


def _prefix(inputs, n):
    return dict(inputs, tokens=inputs["tokens"][:, :n])


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        cfg, pcfg = _configs(arch, n_layers=2)
        params, state = _carry(cfg, pcfg, CACHE)
        _SETUPS[arch] = (cfg, params, pcfg, lm.from_state_dict(pcfg, state, device="cpu"),
                         _inputs(cfg))
    return _SETUPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_follow_the_reference(arch):
    cfg, params, pcfg, model, _ = _setup(arch)
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n
    assert len(model.layers) == 2 and all(b.cross == cfg.is_encdec for b in model.layers)
    if cfg.is_encdec:
        assert len(model.enc_layers) == cfg.n_enc_layers == 2
        assert not any(b.causal or b.cross for b in model.enc_layers)
        assert model.pos.shape == (CACHE, cfg.d_model)
        assert model.layers[0].xattn.q_norm is None


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(arch):
    cfg, params, _, model, inputs = _setup(arch)
    x = _prefix(inputs, S)
    want = jax.jit(lambda p, b: ref_lm.forward(p, b, cfg, SHD)[0])(params, x)
    got = model(**_torch(x))
    assert got.shape == (2, cfg.n_img_tokens + S, model.embed.shape[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_entries(got_tree, want_tree):
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        got = got_tree
        for key in path:
            got = got[key.key]
        yield str(path), got, np.asarray(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode(arch):
    """Prefill logits and every cache entry (the self-attention ring and,
    for whisper, the encoder's K/V in ``ck``/``cv``), then 8 decode steps
    teacher-forced on the same tokens at positions n_img + S + i."""
    cfg, params, pcfg, model, inputs = _setup(arch)
    x = _prefix(inputs, S)
    want_l, want_c = jax.jit(lambda p, b: ref_lm.prefill(p, b, cfg, SHD, cache_len=CACHE))(
        params, x)
    got_l, got_c = model.prefill(cache_len=CACHE, **_torch(x))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    got_tree = carry.lm_cache_to_arrays(pcfg, got_c)
    entries = list(_cache_entries(got_tree, want_c))
    names = {p.rsplit("'", 2)[-2] for p, _, _ in entries}
    assert names == ({"k", "v", "k_pos", "ck", "cv"} if cfg.is_encdec else {"k", "v", "k_pos"})
    for path, got, want in entries:
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, cfg, SHD))
    tokens = inputs["tokens"]
    for i in range(STEPS):
        pos = np.full((2,), cfg.n_img_tokens + S + i, np.int32)
        tok = tokens[:, S + i:S + i + 1]
        want_l, want_c = step(params, want_c, tok, pos)
        got_l, got_c = model.decode_step(got_c, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), err_msg=f"step {i}", **TOL)
    for path, got, want in _cache_entries(carry.lm_cache_to_arrays(pcfg, got_c), want_c):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_gradients(arch, remat):
    """The loss over the text positions (the image prefix's logits
    dropped, as the reference's ``make_loss_fn`` drops them) and every
    parameter's gradient, the encoder's and the learned positions'
    included, within 1e-4 * max(1, max|g_ref|)."""
    cfg, params, pcfg, _, inputs = _setup(arch)
    toks = inputs["tokens"][:, :S + 1]
    batch = dict(_prefix(inputs, S), labels=toks[:, 1:])
    loss_fn = ref_steps.make_loss_fn(cfg, SHD)
    (total, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = carry.lm_params_from_arrays(pcfg, jax.tree.map(np.asarray, grads))
    model = lm.from_state_dict(pcfg.replace(remat=remat), carry.lm_params_from_arrays(
        pcfg, params), device="cpu").requires_grad_(True)
    got_total, _ = make_loss_fn(pcfg)(model, _torch(batch))
    got_total.backward()
    np.testing.assert_allclose(float(got_total.detach()), float(total), rtol=1e-5)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        bound = GRAD_TOL * max(1.0, float(w.abs().max()))
        err = float((got[k] - w).abs().max())
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_the_reference(arch):
    """``serve`` at the reduced defaults, where the reference's cache does
    not evict: the same greedy tokens, from the same prompts and frames."""
    kw = dict(batch=2, prompt_len=32, gen_tokens=6, reduced=True, seed=0)
    cfg, pcfg = _configs(arch)
    _, state = _carry(cfg, pcfg, kw["prompt_len"] + kw["gen_tokens"] + 8)
    want, _ = ref_serve.serve(arch, **kw)
    got, stats = port_serve.serve(arch, **kw, device="cpu", params=state)
    assert got.shape == (2, 6) and stats["logits_finite"]
    assert stats["cache_len"] == cfg.n_img_tokens + 32 + 6 + 8
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_run_matches_reference_run(arch):
    """3 steps of ``launch.train.run`` (batch 2, seq 16): the reference's
    stub inputs (zero image embeddings, frames from RandomState(step)),
    its initial weights, its losses within rtol 1e-4."""
    kw = dict(arch=arch, steps=3, batch=2, seq=16, seed=5, log_every=100)
    _, _, want = ref_train.run(**kw)
    cfg, pcfg = _configs(arch)
    _, state = _carry(cfg, pcfg, 4 * 16, seed=5)
    _, _, got = port_train.run(**kw, device="cpu", params=state)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("n_pos,dim", [(1500, 768), (24, 64), (448, 768), (3, 2)])
def test_sinusoidal_positions_bit_for_bit(n_pos, dim):
    got = common.sinusoidal_positions(n_pos, dim)
    want = ref_common.sinusoidal_positions(n_pos, dim)
    assert got.dtype == np.float32 and got.shape == (n_pos, dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-small"])
def test_sinusoidal_decoder_equals_reference(arch):
    """``pos_kind="sinusoidal"``: nothing is added to the decoder's input
    and no rope is applied, in the reference and in the port; forward,
    prefill and 4 decode steps agree (for whisper its encoder keeps its
    own sinusoidal table)."""
    cfg, pcfg = _configs(arch, n_layers=2, pos_kind="sinusoidal")
    params, state = _carry(cfg, pcfg, CACHE)
    assert "pos" not in params and "pos" not in state
    model = lm.from_state_dict(pcfg, state, device="cpu")
    inputs = _inputs(cfg, seed=3)
    x = _prefix(inputs, S)
    want = jax.jit(lambda p, b: ref_lm.forward(p, b, cfg, SHD)[0])(params, x)
    np.testing.assert_allclose(model(**_torch(x)).numpy(), np.asarray(want), **TOL)
    _, want_c = jax.jit(lambda p, b: ref_lm.prefill(p, b, cfg, SHD, cache_len=CACHE))(
        params, x)
    _, got_c = model.prefill(cache_len=CACHE, **_torch(x))
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, cfg, SHD))
    for i in range(4):
        tok, pos = inputs["tokens"][:, S + i:S + i + 1], np.full((2,), S + i, np.int32)
        want_l, want_c = step(params, want_c, tok, pos)
        got_l, got_c = model.decode_step(got_c, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


EVICT = dict(batch=2, prompt_len=32, gen_tokens=16)
N_IMG = 32  # longer than gen_tokens + 8, as the 576 image tokens at full width are


@functools.lru_cache(maxsize=None)
def _evict_setup():
    cfg, pcfg = _configs("phi-3-vision-4.2b", n_img_tokens=N_IMG)
    params, state = _carry(cfg, pcfg, CACHE)
    return cfg, params, pcfg, state


def test_reference_serve_evicts_the_image_prefix():
    """The reference's serve sizes the cache at prompt + gen + 8 = 56 <
    S = 64: prefill allocates S slots, and the first decode step (at
    position S) overwrites ring slot 0, image token 0's.  The port's model
    given that cache_len does the same, with the same logits."""
    cfg, params, pcfg, state = _evict_setup()
    ref_cache_len = EVICT["prompt_len"] + EVICT["gen_tokens"] + 8
    inputs = _inputs(cfg, seed=1, n=EVICT["prompt_len"] + 1)
    x = _prefix(inputs, EVICT["prompt_len"])
    S_all = N_IMG + EVICT["prompt_len"]
    pos = np.full((2,), S_all, np.int32)
    tok = inputs["tokens"][:, -1:]
    _, want_c = ref_lm.prefill(params, x, cfg, SHD, cache_len=ref_cache_len)
    want_l, want_c = ref_lm.decode_step(params, want_c, tok, pos, cfg, SHD)
    want_kpos = np.asarray(want_c["units"]["b0"]["attn"]["k_pos"][0])
    assert want_kpos.shape == (2, S_all)
    assert (want_kpos[:, 0] == S_all).all() and (want_kpos[:, 1:] == np.arange(1, S_all)).all()
    model = lm.from_state_dict(pcfg, state, device="cpu")
    _, got_c = model.prefill(cache_len=ref_cache_len, **_torch(x))
    got_l, got_c = model.decode_step(got_c, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_array_equal(got_c[0]["attn"]["k_pos"].numpy(), want_kpos)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_port_serve_keeps_the_image_prefix(monkeypatch):
    """The port's ``serve`` with the same 32-image config: room for the
    prefix, the prompt and every decode token, so after the last step
    each layer's cache holds positions 0 .. S + gen - 2 and no hole is
    overwritten; its tokens are the reference model's, run greedily with
    that cache length."""
    cfg, params, pcfg, state = _evict_setup()
    monkeypatch.setattr(port_serve, "serving_config",
                        lambda arch, reduced=True: pcfg.replace(param_dtype=pcfg.dtype))
    seen = []
    decode_step = lm.LM.decode_step

    def recording(self, caches, tokens, pos, *shd):
        out = decode_step(self, caches, tokens, pos, *shd)
        seen.append(out[1])
        return out

    monkeypatch.setattr(lm.LM, "decode_step", recording)
    got, stats = port_serve.serve("phi-3-vision-4.2b", **EVICT, device="cpu", params=state)
    S_all, gen = N_IMG + EVICT["prompt_len"], EVICT["gen_tokens"]
    assert stats["cache_len"] == S_all + gen + 8
    kpos = seen[-1][0]["attn"]["k_pos"].numpy()
    want_kpos = np.where(np.arange(S_all + gen + 8) < S_all + gen - 1,
                         np.arange(S_all + gen + 8), -1)
    np.testing.assert_array_equal(kpos, np.broadcast_to(want_kpos, kpos.shape))
    # the reference's model, driven with the port's cache length
    rng = np.random.RandomState(0)
    x = {"tokens": rng.randint(0, cfg.vocab_size, size=(2, EVICT["prompt_len"]))
         .astype(np.int32), "img_embeds": np.zeros((2, N_IMG, cfg.d_model), np.float32)}
    logits, cache = ref_lm.prefill(params, x, cfg, SHD, cache_len=stats["cache_len"])
    want = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    step = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(p, c, t, pos, cfg, SHD))
    for i in range(gen - 1):
        logits, cache = step(params, cache, want[-1][:, None].astype(np.int32),
                             np.full((2,), S_all + i, np.int32))
        want.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    np.testing.assert_array_equal(got, np.stack(want, 1))


@pytest.mark.parametrize("arch,missing", [("whisper-small", "frames"),
                                          ("phi-3-vision-4.2b", "img_embeds")])
def test_a_missing_frontend_input_raises(arch, missing):
    _, _, _, model, inputs = _setup(arch)
    x = {k: v for k, v in _torch(_prefix(inputs, S)).items() if k != missing}
    with pytest.raises(ValueError, match=missing):
        model(**x)
    with pytest.raises(ValueError, match=missing):
        model.prefill(cache_len=CACHE, **x)


def test_learned_positions_need_a_table_length():
    with pytest.raises(ValueError, match="max_seq"):
        lm.init(port_config("whisper-small").reduced(), device="cpu")
    model = lm.init(port_config("whisper-small").reduced(), device="cpu", max_seq=40)
    assert model.pos.shape == (40, 64)


@pytest.mark.parametrize("arch,max_seq,want", [("whisper-small", 448, None),
                                               ("phi-3-vision-4.2b", 0, 3_821_472_768)])
def test_full_configs_build(arch, max_seq, want):
    """The full configs build (on the meta device: shapes, no storage)
    with the reference's parameter count; whisper's learned table at its
    published 448-token decoder context."""
    pcfg = port_config(arch)
    model = lm.LM(pcfg, common.Init(None, torch.bfloat16, torch.device("meta")), max_seq)
    ref = ref_lm.init(jax.random.PRNGKey(0), get_config(arch), max_seq=max_seq, abstract=True)
    n = sum(int(np.prod(leaf.value.shape))
            for leaf in jax.tree.leaves(ref, is_leaf=lambda x: hasattr(x, "axes")))
    assert sum(p.numel() for p in model.parameters()) == n
    assert want is None or n == want
    assert len(model.layers) == pcfg.n_layers
    assert len(model.enc_layers or ()) == pcfg.n_enc_layers
