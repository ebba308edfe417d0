"""The port's graph examples against the reference's, on the CPU, at the
reference's own sizes: ``examples/quickstart.py`` and
``examples/temporal_analytics.py`` run through ``runpy.run_path`` (their
globals are read), ``examples/{quickstart,temporal_analytics}_torch.py``
through ``main(device="cpu")``.  Integers, node ids, snapshots and the
plan's text are equal; floats that both compute on the host in float64
(LCC, PageRank, the label counts) are equal too, and the density a
fused plan computes on the device within 1e-5 (float32 on the device,
``tests/test_torch_compile.py``'s tolerance).  Without a card the
examples' default device raises."""
import importlib.util
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
DEVICE_TOL = dict(atol=1e-5, rtol=0)


def _port(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_graph(got, want):
    for field in ("present", "attrs", "edge_key"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_quickstart_matches_reference(capsys):
    ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    ref_out = capsys.readouterr().out
    got = _port("quickstart_torch").main(device="cpu")
    assert capsys.readouterr().out == ref_out  # every printed line
    assert got["n_events"] == len(ref["events"]) == 20_000
    assert (got["t0"], got["t1"], got["t"]) == (ref["t0"], ref["t1"], ref["t"])
    assert got["n_spans"] == len(ref["store"].tgi.spans)
    assert got["bytes_written"] == ref["kv"].stats.bytes_written
    _same_graph(got["g"], ref["g"])
    assert got["hub"] == ref["hub"]
    assert got["init_degree"] == len(ref["init"]["neighbors"])
    assert got["n_change_events"] == len(ref["ev"])
    _same_graph(got["hood"], ref["hood"])
    assert got["failovers"] == ref["kv"].stats.failovers > 0
    assert (got["nid"], got["lcc"]) == (ref["nid"], ref["lcc"])
    np.testing.assert_array_equal(got["pts"], np.asarray(ref["pts"]))
    np.testing.assert_allclose(got["dens"], np.asarray(ref["dens"], np.float64), **DEVICE_TOL)


def test_temporal_analytics_matches_reference(capsys):
    ref = runpy.run_path(str(ROOT / "examples" / "temporal_analytics.py"), run_name="__main__")
    ref_lines = capsys.readouterr().out.splitlines()
    got = _port("temporal_analytics_torch").main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    timed = [i for i, line in enumerate(ref_lines) if line.startswith("label-count")]
    assert len(lines) == len(ref_lines) and len(timed) == 1
    # every line but the one that prints wall times
    assert [x for i, x in enumerate(lines) if i != timed[0]] == \
        [x for i, x in enumerate(ref_lines) if i != timed[0]]
    assert (got["t0"], got["t1"], got["tm"]) == (ref["t0"], ref["t1"], ref["tm"])
    assert got["n_sots"] == len(ref["sots"])
    assert got["explain"] == ref["com"].explain()
    assert got["label"] == ref["label"]
    np.testing.assert_array_equal(got["a"], ref["a"])
    np.testing.assert_array_equal(got["b"], ref["b"])
    assert got["hub"] == ref["hub"]
    assert got["hub_degree"] == ref["r"].value[1][0, 0]
    assert got["pushdown"] == (ref["r"].cost.n_deltas, ref["r"].cost.n_bytes)
    assert got["full_fetch"] == (ref["full_cost"].n_deltas, ref["full_cost"].n_bytes)
    assert got["pushdown"][0] < got["full_fetch"][0]
    assert got["ranks"] == ref["ranks"]
    assert got["top"] == ref["top"]
    assert (got["iters"], got["iters_cold"]) == (list(ref["iters"]), list(ref["iters_cold"]))
    # the reference's `dens` is the evolution's; its peak and mean lines
    # were compared above as printed
    np.testing.assert_allclose(got["dens"], np.asarray(ref["dens"], np.float64), **DEVICE_TOL)


@pytest.mark.parametrize("name", ["quickstart_torch", "temporal_analytics_torch"])
def test_graph_examples_without_a_card_raise(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _port(name).main()
