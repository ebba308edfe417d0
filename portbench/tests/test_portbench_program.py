"""The program's own spans (``hgs:*``) and counters in the harness: they
reach the profiler's events as host ranges; ``harness.trace``'s
reduction, and every metric reader it feeds, give the same values with
and without them; ``harness.program`` reduces them by hand on a made-up
trace; and the traced tiny cells report what the program recorded."""
from __future__ import annotations

import json
import sys

import pytest

import pbtiny
from pbtiny import PORTBENCH, REPO

from harness import program, spec, trace
from harness.cell import Window

sys.path.insert(0, str(PORTBENCH / "tools"))


def ev(name, act, start, end, tid=1, corr=0):
    return {"name": name, "activity": act, "start": start, "end": end, "tid": tid, "corr": corr,
            "linked": 0}


def launched(corr, at, name, start, end, act="kernel", tid=1):
    return [ev("cudaLaunchKernel", "cuda_runtime", at, at + 5, tid=tid, corr=corr),
            ev(name, act, start, end, tid=9, corr=corr)]


# the harness's spans and the program's, nested as a decode step, an MoE
# layer and a backward nest them; host operations on the main thread
HARNESS = [ev("pb:window", "user_annotation", 0, 2000),
           ev("pb:decode_step", "user_annotation", 100, 1500),
           ev("pb:attn_decode", "user_annotation", 250, 700),
           ev("pb:attn", "user_annotation", 720, 760),
           ev("pb:moe", "user_annotation", 990, 1110),
           ev("pb:adamw", "user_annotation", 1550, 1650),
           ev("pb:moe:bwd<", "user_annotation", 1800, 1801, tid=2),
           ev("pb:moe:bwd>", "user_annotation", 1900, 1901, tid=2),
           ev("aten::mm", "cpu_op", 1000, 1050), ev("aten::copy_", "cpu_op", 1250, 1700)]
PROGRAM = [ev("hgs:serve_step", "cpu_op", 150, 1200),
           ev("hgs:decode_mha", "cpu_op", 300, 600),
           ev("hgs:moe.dispatch", "cpu_op", 1000, 1100),
           ev("hgs:moe.experts", "cpu_op", 1020, 1060)]
DEVICE = (launched(1, 320, "elementwise", 400, 500)
          + launched(2, 650, "gemv", 700, 900)
          + launched(3, 730, "fa_wgmma", 900, 950)
          + launched(4, 1010, "one_hot_bmm", 1100, 1150)
          + launched(5, 1030, "nvjet_bmm", 1150, 1300)
          + launched(6, 1600, "Memcpy DtoH", 1600, 1700, act="gpu_memcpy")
          + launched(7, 1850, "dq_wgmma", 1850, 1950, tid=2))


def test_program_ranges_move_nothing_the_harness_reads():
    with_program = trace.reduce(HARNESS + PROGRAM + DEVICE)
    without = trace.reduce(HARNESS + DEVICE)
    # every op and its spans, busy and window; the idle gaps by the spans open
    # (a gap's host operation may now name a program span where no operator ran)
    for f in ("ops", "window_s", "busy_s"):
        assert getattr(with_program, f) == getattr(without, f), f
    assert with_program.top_ops(10) == without.top_ops(10)
    assert all(not n.startswith("hgs:") for o in with_program.ops for n in o.spans)

    def by_spans(t):
        out = {}
        for label, s in t.idle_gaps:
            out[label.split(" | ")[0]] = out.get(label.split(" | ")[0], 0.0) + s
        return out

    assert by_spans(with_program) == by_spans(without)
    # torch builds whose events lack activity types (2.11): the program's
    # operator-scope ranges are host operations, never device work
    fake = type("Event", (), {"name": lambda self: "hgs:serve_step",
                              "is_user_annotation": lambda self: False})()
    assert trace._activity(fake, "CPU") == "cpu_op"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {"prefill": "phi3.5-moe-42b-a6.6b.prefill-4k", "decode": "qwen2-7b.decode-4k",
             "train": "phi3.5-moe-42b-a6.6b.train-4k"}
    win = Window(seconds=2e-6, requests=1, tokens_in=8, tokens_out=8, gaps=[0.1, 0.1],
                 launches={"flash_attention": 2, "bwd": 1})
    import run as pbrun

    read = 0
    for m in bench["per_layer"]:
        cell = spec.load_cell(cells[m["name"].split(".")[-1]], REPO)
        values = [spec.reader(m["name"], REPO)(
            pbrun.Run(cell, win, t, spec.peaks("NVIDIA H100 80GB HBM3"), 10 ** 9))
            for t in (with_program, without)]
        assert values[0] == values[1], m["name"]
        read += values[0] is not None
    assert read >= 15  # the readers of the harness's spans and the device found their inputs


def test_program_reduction_by_hand():
    t = program.reduce(HARNESS + PROGRAM + DEVICE)
    ns = 1e-9
    assert t.window_s == pytest.approx(2000 * ns) and t.device_s == pytest.approx(750 * ns)
    assert t.seconds_under("hgs:decode_mha") == pytest.approx(100 * ns)
    assert t.seconds_under("hgs:serve_step") == pytest.approx(550 * ns)
    # the experts' product is nested in the dispatch: innermost leaves it out
    assert t.seconds_under("hgs:moe.dispatch") == pytest.approx(200 * ns)
    assert t.seconds_under("hgs:moe.dispatch", innermost=True) == pytest.approx(50 * ns)
    assert t.seconds_under("hgs:moe.experts", innermost=True) == pytest.approx(150 * ns)
    # idle gaps 0-400, 500-700, 950-1100, 1300-1600, 1700-1850, 1950-2000;
    # the step's span 150-1200 holds 250 + 200 + 150 of them, the attention's
    # 300-600 holds 100 + 100, the dispatch's 1000-1100 100, the experts' 40
    assert t.idle_under("hgs:serve_step") == pytest.approx(600 * ns)
    assert t.idle_under("hgs:decode_mha") == pytest.approx(200 * ns)
    assert t.idle_under("hgs:moe.dispatch") == pytest.approx(100 * ns)
    assert t.idle_under("hgs:moe.experts") == pytest.approx(40 * ns)
    assert sum(t.idle.values()) == pytest.approx(1250 * ns)
    assert program.reduce(HARNESS + DEVICE).device == {(): pytest.approx(750 * ns)}


def test_span_readers_by_hand():
    """The three readers of the program's spans over ``run.program``, on
    the made-up trace: 100 of 750 device ns launched under the decode
    attention's span, 600 of 2,000 window ns idle inside the step's, 50 ns
    innermost in the dispatch's; nothing without a program trace."""
    import run as pbrun

    pt = program.reduce(HARNESS + PROGRAM + DEVICE)
    cell = spec.load_cell("qwen2-7b.decode-4k", REPO)
    win = Window(seconds=2e-6, requests=1, gaps=[0.1])
    want = {"decode_mha_share.decode": 100 * 100 / 750,
            "decode_issue_idle_pct.decode": 100 * 600 / 2000,
            "moe_dispatch_share.prefill": 100 * 50 / 750}
    for name, value in want.items():
        read = spec.reader(name, REPO)
        assert read(pbrun.Run(cell, win, None, {}, 0, pt)) == pytest.approx(value), name
        assert read(pbrun.Run(cell, win, None, {}, 0)) is None, name
        assert read(pbrun.Run(cell, win, None, {}, 0, program.reduce(HARNESS + DEVICE))) is None


def test_program_spans_reach_the_trace_as_host_ranges():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.common import Init
    from repro_torch.train import make_serve_step

    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    model = lm.LM(cfg, Init(torch.Generator().manual_seed(0), torch.float32, torch.device("cpu")))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("pb:window"):
            _, caches = model.prefill(toks, cache_len=24)
            make_serve_step()(model, caches, toks[:, -1:], torch.full((2,), 16, dtype=torch.int32))
    obs.reset()
    raw = trace.raw_events(prof)
    ranges = {}
    for e in raw:
        if e["name"].startswith("hgs:"):
            assert e["activity"] == "cpu_op", e  # no range of theirs on the device's timeline
            ranges.setdefault(e["name"], []).append((e["start"], e["end"]))
    assert set(ranges) == {"hgs:serve_step", "hgs:decode_mha", "hgs:moe.dispatch",
                           "hgs:moe.experts"}
    # one MoE layer in the prefill and one in the step; the experts nested in each dispatch
    assert len(ranges["hgs:moe.dispatch"]) == len(ranges["hgs:moe.experts"]) == 2
    for (a, b), (c, d) in zip(sorted(ranges["hgs:moe.dispatch"]),
                              sorted(ranges["hgs:moe.experts"])):
        assert a <= c <= d <= b
    (s0, s1), = ranges["hgs:serve_step"]
    assert all(s0 <= a <= b <= s1 for a, b in ranges["hgs:decode_mha"])
    assert program.reduce(raw).idle_under("hgs:serve_step") > 0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pbtiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,metrics", [
    ("p.pre", ("moe_slot_use_pct.prefill", "moe_drop_pct.prefill")),
    ("p.tr", ("moe_drop_pct.train",))])
def test_traced_tiny_cells_report_the_program_counters(root, cell, metrics):
    from repro_torch import obs

    obs.reset()
    res = pbtiny.run(root, cell, trace=1)
    obs.reset()
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(metrics) <= set(got), got
    assert all(0 <= got[m] <= 100 for m in metrics)


@pytest.mark.parametrize("cell,spans", [
    ("q.dec", ("hgs:serve_step", "hgs:decode_mha")),
    ("p.pre", ("hgs:moe.dispatch", "hgs:moe.experts"))])
def test_program_spans_tool_on_the_tiny_cells(root, cell, spans, capsys):
    import program_spans

    from repro_torch import obs

    obs.reset()
    assert program_spans.main(["--workload", cell, "--seed", "3000000019", "--seconds", "0.2"],
                              root=root, device="cpu") == 0
    obs.reset()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["result"]["correct"]
    assert set(spans) <= set(out["spans"])
    assert all(v > 0 for v in out["traced"].values())
    if cell == "q.dec":  # no device here: the window is idle, much of it inside the step
        assert 0 < out["program"]["decode_issue_idle_pct.decode"] <= 100
    else:
        c = out["counters"]
        assert c["moe.routed"] > 0 and len(c["moe.dropped"]) == 4
