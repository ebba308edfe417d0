"""repro_torch training vs the reference, on the CPU (autograd through the
kernels' plain versions): ``lm_loss``; the gradient of one loss on
reduced ``recurrentgemma-9b`` (RG-LRU scans, one KV head at stride 0,
window 32 < S), ``qwen3-1.7b`` (qk-norm, full causal attention),
``phi3.5-moe-42b-a6.6b`` (the MoE FFN and its load-balancing loss) and
``xlstm-350m`` (mLSTM and sLSTM blocks), with the reference's weights
carried over, leaf by leaf within 1e-4 * max(1, max|g_ref|), with and
without ``remat="full"``; ``remat="dots"`` against both; three AdamW
updates within 1e-6; the port's ``run`` against the reference's
(``qwen3-1.7b`` 12 steps, ``phi3.5-moe`` and ``xlstm-350m`` 6) within
rtol 1e-4; ``GraphWalkLM`` over the port's TGI against the
reference's tokens; and the guards."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.tgi import TGIConfig as RefConfig
from repro.data.pipeline import GraphWalkLM as RefWalk
from repro.data.pipeline import PipelineConfig as RefPipe
from repro.data.temporal_graph_gen import generate
from repro.launch import train as ref_train
from repro.models import lm as ref_lm
from repro.models.sharding import Sharder, split_tree
from repro.optim import adamw as ref_adamw
from repro.taf import HistoricalGraphStore as RefStore
from repro.train import steps as ref_steps
from repro_torch import carry
from repro_torch.configs import get_config as port_config
from repro_torch.core.tgi import TGIConfig
from repro_torch.data.pipeline import GraphWalkLM, PipelineConfig
from repro_torch.launch import train as port_train
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.taf import HistoricalGraphStore
from repro_torch.train import make_loss_fn, make_train_step

SHD = Sharder(mesh=None)
GRAD_TOL = 1e-4
S = 48


def test_lm_loss_matches_reference():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 7, 384) * 3).astype(np.float32)
    labels = rng.randint(0, 300, size=(2, 7)).astype(np.int32)
    weights = (rng.rand(2, 7) < 0.7).astype(np.float32)
    for w in (None, weights):
        want = ref_lm.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                              None if w is None else jnp.asarray(w))
        got = lm.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if w is None else torch.from_numpy(w))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = lm.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.zeros(2, 7))
    assert float(zero) == 0.0  # no weight: the sum is divided by 1


def _setup(arch, seed=0):
    cfg = get_config(arch).reduced()
    params = jax.tree.map(np.asarray, split_tree(
        ref_lm.init(jax.random.PRNGKey(seed), cfg, max_seq=4 * S))[0])
    pcfg = port_config(arch).reduced()
    return cfg, params, pcfg, carry.lm_params_from_arrays(pcfg, params)


def _batch(cfg, seed):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(2, S + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


_REF_GRADS = {}


def _ref_grads(arch):
    """The reference's loss and gradient tree on one batch (cached: one
    jit per architecture)."""
    if arch not in _REF_GRADS:
        cfg, params, pcfg, state = _setup(arch)
        batch = _batch(cfg, 1)
        loss_fn = ref_steps.make_loss_fn(cfg, SHD)
        (total, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        _REF_GRADS[arch] = (pcfg, state, batch, float(total), float(metrics["aux_loss"]),
                            carry.lm_params_from_arrays(pcfg, jax.tree.map(np.asarray, grads)))
    return _REF_GRADS[arch]


def _grads(pcfg, state, batch):
    """The port's total loss, its metrics and every parameter's gradient."""
    model = lm.from_state_dict(pcfg, state, device="cpu").requires_grad_(True)
    total, metrics = make_loss_fn(pcfg)(model, {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
    total.backward()
    return total, metrics, {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen3-1.7b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-350m"])
def test_gradients_match_reference(arch, remat):
    """The total loss (the MoE load-balancing loss times MOE_AUX_COEF
    included), the aux loss (0 without an MoE layer) and every gradient."""
    pcfg, state, batch, want_loss, want_aux, want = _ref_grads(arch)
    total, metrics, got = _grads(pcfg.replace(remat=remat), state, batch)
    np.testing.assert_allclose(float(total), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"]), want_aux, rtol=1e-5)
    assert (want_aux > 0) == pcfg.is_moe
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g is not None and g.shape == w.shape, k
        bound = GRAD_TOL * max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= bound, (k, err, bound)


def test_adamw_three_updates_match_reference():
    rng = np.random.RandomState(3)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * g).astype(np.float32) for k, s in shapes.items()}
             for g in (0.5, 2.0, 0.01)]
    ocfg_kw = dict(lr=1e-2, warmup_steps=2, decay_steps=5)
    r_params = {k: jnp.asarray(v) for k, v in params.items()}
    r_state = ref_adamw.init(r_params)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p_state = adamw.init(p_params)
    for g in grads:
        r_params, r_state, r_m = ref_adamw.update({k: jnp.asarray(v) for k, v in g.items()},
                                                  r_state, r_params,
                                                  ref_adamw.AdamWConfig(**ocfg_kw))
        p_params, p_state, p_m = adamw.update({k: torch.from_numpy(v.copy())
                                               for k, v in g.items()},
                                              p_state, p_params, adamw.AdamWConfig(**ocfg_kw))
        np.testing.assert_allclose(float(p_m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(p_m["lr"]), float(r_m["lr"]), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(p_params[k].numpy(), np.asarray(r_params[k]), atol=1e-6)
            np.testing.assert_allclose(p_state["m"][k].numpy(), np.asarray(r_state["m"][k]),
                                       atol=1e-6)
            np.testing.assert_allclose(p_state["v"][k].numpy(), np.asarray(r_state["v"][k]),
                                       atol=1e-6)
    assert int(p_state["count"]) == int(r_state["count"]) == 3


@pytest.mark.parametrize("arch,steps", [("qwen3-1.7b", 12), ("phi3.5-moe-42b-a6.6b", 6),
                                        ("xlstm-350m", 6)])
def test_run_matches_reference_run(arch, steps):
    """Reduced qwen3-1.7b (12 steps), phi3.5-moe (the routing, capacity,
    dispatch and aux loss under training) and xlstm-350m (the chunkwise
    mLSTM and the sLSTM loop) (6 steps), batch 4, seq 32, seed 11: the
    port with the reference's initial weights gives the reference's
    losses."""
    kw = dict(arch=arch, steps=steps, batch=4, seq=32, seed=11, log_every=100)
    _, _, want = ref_train.run(**kw)
    cfg = get_config(arch).reduced()
    params = jax.tree.map(np.asarray, split_tree(
        ref_lm.init(jax.random.PRNGKey(11), cfg, max_seq=4 * 32))[0])
    pcfg = port_config(arch).reduced()
    model, opt_state, got = port_train.run(
        **kw, device="cpu", params=carry.lm_params_from_arrays(pcfg, params))
    assert len(got) == steps and int(opt_state["count"]) == steps
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert all(p.requires_grad and p.grad is not None for p in model.parameters())


def test_train_step_needs_gradients_on():
    pcfg = port_config("recurrentgemma-9b").reduced()
    model = lm.init(pcfg, seed=0, device="cpu")  # frozen, as serving leaves it
    step = make_train_step(pcfg)
    toks = torch.zeros(1, 9, dtype=torch.int64)
    with pytest.raises(RuntimeError):
        step(model, adamw.init(dict(model.named_parameters())),
             {"tokens": toks[:, :-1], "labels": toks[:, 1:]})


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "phi3.5-moe-42b-a6.6b"])
def test_remat_dots_matches_full_and_none(arch):
    """remat="dots" (the products with no batch dimension kept, the rest
    recomputed) gives the losses and gradients of "full" and "none"
    within 1e-6: the same arithmetic, only stored or recomputed."""
    pcfg, state, batch, _, _, _ = _ref_grads(arch)
    runs = {remat: _grads(pcfg.replace(remat=remat), state, batch)
            for remat in ("dots", "full", "none")}
    total, metrics, got = runs["dots"]
    for other in ("full", "none"):
        o_total, o_metrics, o_got = runs[other]
        np.testing.assert_allclose(float(total), float(o_total), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(metrics["aux_loss"]), float(o_metrics["aux_loss"]),
                                   rtol=1e-6, atol=1e-6)
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), o_got[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} vs remat={other}")


def test_remat_dots_saves_only_the_unbatched_products():
    """Under "dots" the backward reruns the batched products and the
    elementwise work but no ``mm``: the projections' outputs are kept."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    pcfg, state, batch, _, _, _ = _ref_grads("phi3.5-moe-42b-a6.6b")
    counts = {}
    for remat in ("none", "dots", "full"):
        model = lm.from_state_dict(pcfg.replace(remat=remat), state,
                                   device="cpu").requires_grad_(True)
        total, _ = make_loss_fn(pcfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
        with Count() as c:
            total.backward()
        counts[remat] = c.ops
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"].get(mm, 0) == counts["none"].get(mm, 0) < counts["full"][mm]
    assert counts["none"].get(bmm, 0) < counts["dots"][bmm] == counts["full"][bmm]


def test_run_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.run(steps=1)


def test_run_rejects_another_model():
    other = lm.init(port_config("recurrentgemma-9b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="depth"):
        port_train.run("qwen3-1.7b", steps=1, device="cpu", params=other)


def test_graph_walk_matches_reference():
    """GraphWalkLM (a copy) over the port's TGI gives the reference's
    tokens over its own, from the same events."""
    ev = generate(1500, seed=4)
    port_ev = carry.eventlog_from_arrays(
        {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)})
    cfg = dict(n_shards=2, parts_per_shard=2, events_per_span=400, eventlist_size=64,
               checkpoints_per_span=2)
    ref = RefStore.build(ev, RefConfig(**cfg))
    port = HistoricalGraphStore.build(port_ev, TGIConfig(**cfg), device="cpu")
    want = RefWalk(RefPipe(4, 16, 97, n_shards=2), ref.tgi, seed=2, n_times=3)
    got = GraphWalkLM(PipelineConfig(4, 16, 97, n_shards=2), port.tgi, seed=2, n_times=3)
    for step in (0, 5):
        w, g = want.batch(step), got.batch(step)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
