"""The program's own spans and counters (``repro_torch.obs``) on the CPU:
with no profiler recording they enter no profiler record and count
nothing; under one, the MoE counters equal a count made on the host from
the router's choices with ``_positions_in_expert`` and ``_capacity``, on
both dispatch paths, under ``inference_mode``, ``no_grad`` and a training
step with ``remat="full"`` (whose recompute counts every layer twice,
the ratios unchanged); counts from serving and training add up in one
accumulator that stays out of autograd and is no inference tensor."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import lm, moe
from repro_torch.models.common import Init
from repro_torch.optim import adamw
from repro_torch.train import make_serve_step, make_train_step

ARCH = "phi3.5-moe-42b-a6.6b"
GROUP = 32  # tokens a routing group here: several groups a call
CAPACITY = 0.75  # 16 slots an expert for 32 x 2 choices over 4 experts: some drop


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setattr(moe, "GROUP", GROUP)
    obs.reset()
    yield
    obs.reset()


def _model(**kw):
    cfg = get_config(ARCH).reduced().replace(n_layers=2, capacity_factor=CAPACITY, **kw)
    model = lm.LM(cfg, Init(torch.Generator().manual_seed(0), torch.float32,
                            torch.device("cpu")))
    return cfg, model


def _tokens(cfg, B=2, S=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _routes(monkeypatch) -> list:
    """The expert choices (T, k) of every call of the router, from now on."""
    calls, route = [], moe._route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        calls.append(out[1].detach().clone())
        return out

    monkeypatch.setattr(moe, "_route", recorded)
    return calls


def _host_counts(calls, cfg) -> dict:
    """The counters' values counted on the host from the router's choices."""
    E = cfg.n_experts
    out = {"moe.routed": 0, "moe.slots": 0, "moe.dropped": torch.zeros(E, dtype=torch.int64)}
    for idx in calls:
        T, k = idx.shape
        g = min(GROUP, T)
        grouped = idx.view(T // g, g, k)
        C = moe._capacity(cfg, g)
        pos = moe._positions_in_expert(grouped, E)
        out["moe.routed"] += T * k
        out["moe.slots"] += (T // g) * E * C
        out["moe.dropped"] += torch.bincount(grouped[pos >= C], minlength=E)
    out["moe.dropped"] = out["moe.dropped"].tolist()
    return out


def test_without_a_profiler_no_span_is_entered_and_nothing_is_counted(monkeypatch):
    entered = []
    record = torch._C._profiler._RecordFunctionFast

    def counted(name, *args):
        entered.append(name)
        return record(name, *args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    cfg, model = _model()
    toks = _tokens(cfg)[:, :-1]
    with obs.span("anything"):
        obs.count("n", 3)
        obs.count("t", torch.ones(2))
    with torch.inference_mode():
        _, caches = model.prefill(toks, cache_len=40)
        make_serve_step()(model, caches, toks[:, -1:], torch.full((2,), 32, dtype=torch.int32))
        for impl in moe._DISPATCH:
            moe.moe_forward(model.layers[0].ffn, torch.randn(2, 32, cfg.d_model), cfg, impl)
    assert entered == [] and obs.counters() == {}
    assert not obs.recording()
    with _profiled():  # the same calls, recording
        assert obs.recording()
        with torch.inference_mode():
            model.prefill(toks, cache_len=40)
    assert {"hgs:moe.dispatch", "hgs:moe.experts"} <= set(entered)
    assert obs.counters()["moe.routed"] == 2 * 32 * cfg.top_k * cfg.n_layers


@pytest.mark.parametrize("impl", sorted(moe._DISPATCH))
@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "train_remat"])
def test_moe_counters_equal_a_host_count(monkeypatch, impl, mode):
    monkeypatch.setitem(moe._DISPATCH, "einsum", moe._DISPATCH[impl])
    cfg, model = _model(remat="full" if mode == "train_remat" else "none")
    toks = _tokens(cfg)
    calls = _routes(monkeypatch)
    if mode == "train_remat":
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        step = make_train_step(cfg, adamw.AdamWConfig())
        with _profiled():
            step(model, adamw.init(params), {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        train = obs.counters()
        assert len(calls) == 2 * cfg.n_layers  # the forward's and remat's
        assert train == _host_counts(calls, cfg)
        # the forward alone counts half of every counter: the ratios hold
        obs.reset()
        with _profiled(), torch.no_grad():
            model(toks[:, :-1])
        half = obs.counters()
        assert train == {k: [2 * x for x in v] if isinstance(v, list) else 2 * v
                         for k, v in half.items()}
    else:
        ctx = torch.inference_mode() if mode == "inference_mode" else torch.no_grad()
        with _profiled(), ctx:
            model.prefill(toks[:, :-1], cache_len=40)
            moe.moe_forward(model.layers[0].ffn, torch.randn(4, 32, cfg.d_model), cfg)
        assert len(calls) == cfg.n_layers + 1
        assert obs.counters() == _host_counts(calls, cfg)
    assert sum(obs.counters()["moe.dropped"]) > 0, "nothing dropped: the capacity is too large"


def test_serving_and_training_counts_add_up_outside_autograd():
    cfg, model = _model()
    ffn = model.layers[0].ffn
    x = torch.randn(2, 32, cfg.d_model)
    with _profiled():
        with torch.inference_mode():
            moe.moe_forward(ffn, x, cfg)
        served = obs.counters()
        ffn.requires_grad_(True)
        y, aux = moe.moe_forward(ffn, x.requires_grad_(True), cfg)
        (y.sum() + aux).backward()
    acc = obs._DEVICE["moe.dropped"]
    assert not acc.is_inference() and not acc.requires_grad and acc.grad_fn is None
    both = obs.counters()
    assert both["moe.routed"] == 2 * served["moe.routed"]
    assert both["moe.dropped"] == [2 * d for d in served["moe.dropped"]]
