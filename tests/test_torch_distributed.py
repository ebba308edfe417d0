"""The port across several ranks, on the CPU: four ``gloo`` processes
(``tests/torch_dist_workers.py``, one a rank, joined through a FileStore
in the test's directory, OMP_NUM_THREADS=1) run every multi-rank path of
the port once, and each test here holds one of their results against the
unsharded port and the reference:

* the sharded TAF degree plans on W = 4 workers, over a node count that
  is no multiple of 4, on the reference's distributed test's input,
  against ``repro.taf.exec.sharded_degree_at``,
  ``repro.taf.analytics.degree_series_delta`` and the port's
  ``mesh=None`` run, bit for bit;
* two float32 train steps on a (data=2, model=2) mesh of the reduced
  ``recurrentgemma-9b`` (RG-LRU width and every weight sharded, one KV
  head), of a 3-head attention config (the heads do not divide the
  model axis: head_dim takes it), of the reduced
  ``phi3.5-moe-42b-a6.6b`` (the router's dispatch and combine under the
  reference's activation constraints) and of the reduced ``xlstm-350m``
  (mLSTM and sLSTM blocks, the up projections through
  ``flat_matmul``), with the reference's weights: losses
  and every gradient against the unsharded port step, and the first
  loss against the reference's, within LM_REDUCED_TOL; and a prefill with
  three greedy decode steps of each, every step's logits against the
  unsharded port's;
* ``restore_sharded`` of an unsharded checkpoint onto the 2 x 2 mesh and
  onto a 1-D mesh of 2 ranks, bit for bit;
* ``compress_grads_podwise`` on 2 "pod" ranks: with the same gradient on
  both, bit for bit against the reference's on 2 placeholder XLA devices
  (a subprocess), residuals included; with each pod its own, against a
  numpy model of the mean of the dequantized contributions.

Multi-rank runs are CPU-only: the card machine has one H100, where
``chip_smoke.py`` runs the same code on a 1 x 1 mesh over NCCL."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.tgi import TGI, TGIConfig
from repro.data.temporal_graph_gen import generate
from repro.models import lm as ref_lm
from repro.models.sharding import Sharder as RefSharder
from repro.models.sharding import split_tree
from repro.storage.kvstore import DeltaStore as RefDeltaStore
from repro.taf import analytics, build_sots
from repro.taf import exec as ref_exec
from repro.train import steps as ref_steps
from repro_torch import carry
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ref as ref_decode
from repro_torch.launch import train as port_train
from repro_torch.models import lm
from repro_torch.models.sharding import Sharder
from repro_torch.optim import adamw
from repro_torch.optim.compression import CHUNK
from repro_torch.taf import exec as taf_exec
from repro_torch.train import make_prefill_step, make_serve_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
S, B = 48, 4
LM_REDUCED_TOL = dict(atol=1e-4, rtol=1e-4)  # chip_smoke.py's, f32
TRAIN = {"recurrentgemma": ("recurrentgemma-9b", {}),
         "head_dim_fallback": ("qwen2-7b", {"n_heads": 3, "n_kv_heads": 1}),
         "moe": ("phi3.5-moe-42b-a6.6b", {}),
         "xlstm": ("xlstm-350m", {})}
# weights each case's mesh run must shard (beside "embed")
SHARDED = {"recurrentgemma": "layers.0.ffn.w_up", "head_dim_fallback": "layers.0.ffn.w_up",
           "moe": "layers.0.ffn.w_up", "xlstm": "layers.0.mix.up"}

REF_COMPRESSION = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.optim import compression
    assert len(jax.devices()) == 2
    g = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2,), ("pod",))
    grads = {k: jnp.asarray(v) for k, v in g.items()}
    err = compression.init_error_state(grads)
    out = {}
    for r in range(2):
        grads_hat, err = compression.compress_grads_podwise(grads, err, mesh)
        for k in grads:
            out[f"g{r}_{k}"] = np.asarray(grads_hat[k])
            out[f"e{r}_{k}"] = np.asarray(err[k])
    np.savez(sys.argv[2], **out)
    """)


def _ref_sots():
    """The reference distributed test's SoTS and its timepoint."""
    events = generate(2500, seed=2)
    cfg = TGIConfig(n_shards=2, parts_per_shard=2, events_per_span=900)
    tgi = TGI.build(events, cfg, RefDeltaStore(m=2, r=1, backend="mem"))
    t0g, t1g = events.time_range()
    t0, t1 = int(t0g + 0.3 * (t1g - t0g)), int(t0g + 0.8 * (t1g - t0g))
    return build_sots(tgi, t0, t1), t0, t1


def _train_case(name):
    arch, overrides = TRAIN[name]
    cfg = ref_config(arch).reduced().replace(**overrides)
    params = jax.tree.map(np.asarray, split_tree(
        ref_lm.init(jax.random.PRNGKey(0), cfg, max_seq=4 * S))[0])
    pcfg = get_config(arch).reduced().replace(**overrides)
    rng = np.random.RandomState(1)
    batches = []
    for _ in range(2):
        toks = rng.randint(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()})
    return cfg, params, pcfg, {"arch": arch, "overrides": overrides,
                               "state": carry.lm_params_from_arrays(pcfg, params),
                               "batches": batches}


# a decode cache's placements on the (data, model) mesh: the tensor
# dimension each mesh dimension shards (None: replicated).  Slots (1) and
# the head dim (3) are the layouts decode attention merges or gathers.
DECODE_LAYOUTS = {"slots on data": (1, None), "head dim on model": (None, 3),
                  "batch on data, slots on model": (0, 1),
                  "slots on data, head dim on model": (1, 3),
                  "batch on data, KV heads on model": (0, 2)}


def _decode_cache():
    """k, v (2, 24, 2, 8), q (2, 1, 6, 8), k_pos, pos: a ring whose slots hold
    positions in no order, the second half of sequence 0's empty (a rank's
    whole range of slots masked), every fifth slot of sequence 1 empty."""
    g = torch.Generator().manual_seed(3)
    k, v = (torch.randn(2, 24, 2, 8, generator=g) for _ in range(2))
    q = torch.randn(2, 1, 6, 8, generator=g)
    k_pos = torch.stack([torch.roll(torch.arange(24), 5 * b) for b in range(2)]).to(torch.int32)
    k_pos[0] = torch.where(torch.arange(24) < 12, torch.arange(24), -1)
    k_pos[1, ::5] = -1
    pos = torch.tensor([11, 23], dtype=torch.int32)
    return k, v, q, k_pos, pos


def _ckpt_trees():
    """Two saves of a model's parameters (one of them bf16) and a count."""
    cfg = get_config("recurrentgemma-9b").reduced()
    model = lm.init(cfg, seed=1, device="cpu")
    params = {k: v.clone() for k, v in model.state_dict().items()}
    params["embed"] = params["embed"].to(torch.bfloat16)
    axes = {"params": {k: p.axes for k, p in model.named_parameters()}, "count": ()}
    first = {"params": params, "count": torch.tensor(3, dtype=torch.int32)}
    second = {"params": {k: v * 1.5 for k, v in params.items()},
              "count": torch.tensor(4, dtype=torch.int32)}
    return [first, second], axes


def _gradients():
    rng = np.random.RandomState(5)
    # a ragged last chunk, a leaf smaller than a chunk, a chunk of zeros
    a = rng.randn(2 * CHUNK + 904).astype(np.float32)
    a[CHUNK:2 * CHUNK] = 0
    return {"a": a, "b": (rng.randn(3, 7) * 1e-3).astype(np.float32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's inputs, the four ranks' results and the
    reference's compression on 2 placeholder devices."""
    d = tmp_path_factory.mktemp("dist")
    sots, t0, t1 = _ref_sots()
    if len(sots) % WORLD == 0:  # a node count that needs padding
        sots = sots.subset(np.arange(len(sots) - 1))
    assert len(sots) % WORLD
    grads = _gradients()
    trees, axes = _ckpt_trees()
    cases = {name: _train_case(name) for name in TRAIN}
    inp = {"sots": {f.name: getattr(sots, f.name) for f in dataclasses.fields(sots)},
           "tm": (t0 + t1) // 2, "ts": [t0, (t0 + t1) // 2, t1],
           "train": {name: c[3] for name, c in cases.items()},
           "ckpt_trees": trees, "ckpt_axes": axes,
           "decode": _decode_cache(), "layouts": DECODE_LAYOUTS,
           "g_same": {k: torch.from_numpy(v) for k, v in grads.items()},
           "g_diff": [{k: torch.from_numpy(v * (1 + p) + p) for k, v in grads.items()}
                      for p in range(2)]}
    torch.save(inp, d / "inputs.pt")
    np.savez(d / "grads.npz", **grads)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [d / f"rank{r}.log" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_workers.py"),
                               str(r), str(WORLD), str(d)], env=env, cwd=ROOT,
                              stdout=log.open("w"), stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    ref = subprocess.run([sys.executable, "-c", REF_COMPRESSION, str(d / "grads.npz"),
                          str(d / "ref.npz")], env=dict(env, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.wait(timeout=600) == 0, f"rank {r}:\n{log.read_text()[-4000:]}"
    assert ref.returncode == 0, ref.stderr[-3000:]
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(inp=inp, sots=sots, outs=outs, cases=cases, ref=dict(np.load(d / "ref.npz")))


def test_sharded_degree_plans_match_the_reference(run):
    ref_sots, inp = run["sots"], run["inp"]
    sots = carry.sots_from_arrays(inp["sots"])
    tm, ts = inp["tm"], inp["ts"]
    want_at = np.asarray(ref_exec.sharded_degree_at(ref_sots, tm))
    _, want_series = analytics.degree_series_delta(ref_sots, points=ts)
    alone_at = taf_exec.sharded_degree_at(sots, tm, device="cpu")
    alone_series = taf_exec.sharded_degree_series(sots, ts, device="cpu")
    on = ref_sots.init_present == 1
    np.testing.assert_array_equal(alone_at, want_at)
    np.testing.assert_array_equal(alone_series[on], want_series[on].astype(alone_series.dtype))
    for out in run["outs"]:
        got = out["taf"]
        assert got["W"] == WORLD
        for key, alone in (("at", alone_at), ("series", alone_series)):
            assert got[key].dtype == alone.dtype and got[key].shape == alone.shape
            np.testing.assert_array_equal(got[key], alone)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_steps_match_unsharded_and_reference(run, name):
    cfg, params, pcfg, case = run["cases"][name]
    model = lm.from_state_dict(pcfg, case["state"], device="cpu")
    model.train()
    model.requires_grad_(True)
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(pcfg)
    for i, batch in enumerate(case["batches"]):
        model, opt, metrics = step(model, opt, {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
        want = {k: p.grad for k, p in model.named_parameters()}
        for out in run["outs"]:
            got = out["train"][name]
            np.testing.assert_allclose(got["losses"][i], float(metrics["loss"]),
                                       **LM_REDUCED_TOL)
            assert got["grads"][i].keys() == want.keys()
            for k, w in want.items():
                torch.testing.assert_close(got["grads"][i][k], w, **LM_REDUCED_TOL)
    # the sharded run's first loss against the reference's on the same weights
    loss_fn = ref_steps.make_loss_fn(cfg, RefSharder(mesh=None))
    _, ref_metrics = loss_fn(params, {k: jnp.asarray(v) for k, v in case["batches"][0].items()})
    np.testing.assert_allclose(run["outs"][0]["train"][name]["losses"][0],
                               float(ref_metrics["loss"]), **LM_REDUCED_TOL)
    # every weight matrix is sharded over the mesh; the norms are not
    sharded = set(run["outs"][0]["train"][name]["sharded"])
    assert {"embed", SHARDED[name]} <= sharded
    assert not any(k.endswith("norm1.scale") for k in sharded)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_decode_matches_unsharded(run, name):
    """Prefill and greedy decode on the (data=2, model=2) mesh: the ring
    write and the decode attention on each rank's block give every
    step's logits of the unsharded port within LM_REDUCED_TOL."""
    _, _, pcfg, case = run["cases"][name]
    model = lm.from_state_dict(pcfg, case["state"], device="cpu")
    tokens = torch.from_numpy(case["batches"][0]["tokens"])
    B, S = tokens.shape
    steps = len(run["outs"][0]["serve"][name])
    with torch.no_grad():
        nxt, caches = make_prefill_step(cache_len=S + steps)(model, {"tokens": tokens})
        want = []
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32)
            nxt, out, caches = make_serve_step()(model, caches, nxt[:, None], pos)
            want.append(out)
    for out in run["outs"]:
        for got, w in zip(out["serve"][name], want):
            torch.testing.assert_close(got, w, **LM_REDUCED_TOL)


@pytest.mark.parametrize("layout", list(DECODE_LAYOUTS))
def test_sharded_decode_attention_layouts(run, layout):
    """A decode cache sharded on its slots, its head dim, its batch or its
    KV heads on the (data=2, model=2) mesh: every ``decode_attention`` call
    gets a rank's block as a plain tensor (what the card's kernel takes),
    and the output, with a window and without, is the unsharded plain
    version's within float32 rounding (slot ranges merged by their
    log-sum-exps, one of them wholly masked)."""
    k, v, q, k_pos, pos = run["inp"]["decode"]
    for out in run["outs"]:
        for window in (0, 5):
            got, calls, plain = out["decode_layouts"][(layout, window)]
            want = ref_decode.decode_attention_ref(k, v, q, k_pos, pos, window)
            assert calls > 0 and plain
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_restore_sharded_is_exact_on_other_meshes(run):
    tree = run["inp"]["ckpt_trees"][-1]
    for out in run["outs"]:
        for mesh in ("2x2", "1d"):
            got = out["checkpoint"][mesh]
            assert got["step"] == 1 and torch.equal(got["count"], tree["count"])
            for k, want in tree["params"].items():
                g = got["full"][k]
                assert g.dtype == want.dtype and g.shape == want.shape, k
                assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                                   want.view(torch.int16) if want.dtype == torch.bfloat16
                                   else want), k
    shapes = run["outs"][0]["checkpoint"]
    vocab, width = tree["params"]["embed"].shape  # ("vocab", "embed"): model, data
    assert shapes["2x2"]["local_shapes"]["embed"] == (vocab // 2, width // 2)
    assert shapes["1d"]["local_shapes"]["embed"] == (vocab, width // 2)


def _np_compress(flat, err):
    """The EF-int8 contribution of one pod: (dequantized, new residual)."""
    x = flat.astype(np.float32) + err
    n = len(x)
    xc = np.pad(x, (0, (-n) % CHUNK)).reshape(-1, CHUNK)
    scale = np.maximum(np.abs(xc).max(axis=1, keepdims=True) / np.float32(127.0),
                       np.float32(1e-12))
    q = np.clip(np.round(xc / scale), -127, 127).astype(np.int8)
    deq = (q.astype(np.float32) * scale).reshape(-1)[:n]
    return deq, x - deq


def test_compression_matches_the_reference_bit_for_bit(run):
    ref = run["ref"]
    for out in run["outs"]:
        rounds = out["compression"]["same"]
        for r, (ghat, err) in enumerate(rounds):
            for k in ghat:
                np.testing.assert_array_equal(ghat[k].numpy(), ref[f"g{r}_{k}"])
                np.testing.assert_array_equal(err[k].numpy(), ref[f"e{r}_{k}"])
        # no "pod" axis: the identity
        for k, g in out["compression"]["no_pod"].items():
            assert torch.equal(g, run["inp"]["g_same"][k])


def test_compression_of_different_gradients_is_the_mean_of_contributions(run):
    g_diff = run["inp"]["g_diff"]
    for k in g_diff[0]:
        errs = [np.zeros(g_diff[p][k].numel(), np.float32) for p in range(2)]
        for r in range(2):
            contrib = []
            for p in range(2):
                deq, errs[p] = _np_compress(g_diff[p][k].numpy().reshape(-1), errs[p])
                contrib.append(deq)
            want = ((contrib[0] + contrib[1]) / np.float32(2.0)).reshape(g_diff[0][k].shape)
            for rank, out in enumerate(run["outs"]):
                ghat, err = out["compression"]["diff"][r]
                np.testing.assert_array_equal(ghat[k].numpy(), want)
                pod = rank // 2  # mesh (pod=2, data=2): ranks 0, 1 are pod 0
                np.testing.assert_array_equal(err[k].numpy().reshape(-1), errs[pod])
        # the quantization error of one round stays within one int8 step
        assert np.all(np.abs(errs[0]) <= np.abs(g_diff[0][k].numpy()).max() / 127 * 1.01 + 1e-6)


def test_worker_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        taf_exec.make_worker_mesh()


def test_sharded_paths_without_a_card_raise(monkeypatch):
    """``device=None`` means the card on a mesh too: without one the
    sharded paths raise before touching the mesh, as the unsharded do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref_sots, _, _ = _ref_sots()
    sots = carry.sots_from_arrays({f.name: getattr(ref_sots, f.name)
                                   for f in dataclasses.fields(ref_sots)})
    stand_in = object()  # never reached
    with pytest.raises(RuntimeError, match="CUDA"):
        taf_exec.sharded_degree_at(sots, 0, mesh=stand_in)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.run("recurrentgemma-9b", steps=1, shd=Sharder(stand_in))
