"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
each cell names a configuration (``portbench/configs/<config>.json``) and
a traffic mix (``portbench/traffic/<traffic>.json``), and its limits of
the output check are in ``portbench/cells/<cell>.json``.  Each per-layer
metric is read by ``portbench/metrics/<metric>.py``.  Adding a cell, a
mix or a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent

# the program's config fields each normalised model key must equal
PORT_FIELDS = {"d_model": "d_model", "n_layers": "n_layers", "n_heads": "n_heads",
               "n_kv_heads": "n_kv_heads", "head_dim": "resolved_head_dim", "d_ff": "d_ff",
               "vocab_size": "vocab_size", "n_experts": "n_experts", "top_k": "top_k",
               "capacity_factor": "capacity_factor", "norm_eps": "norm_eps",
               "rope_theta": "rope_theta", "qkv_bias": "qkv_bias", "dtype": "dtype",
               "param_dtype": "param_dtype", "remat": "remat"}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file
    traffic: dict  # the traffic mix
    limits: dict  # the output check's limits and sample
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    chips: int

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    pb = root / "portbench"
    return Cell(name=name, config=_load(pb / "configs" / f"{w['config']}.json"),
                traffic=_load(pb / "traffic" / f"{w['traffic']}.json"),
                limits=_load(pb / "cells" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _listed(m, name)],
                per_layer=[m for m in bench["per_layer"] if _listed(m, name)],
                chips=int(w["chips"]))


def port_config(config: dict):
    """The program's ``ModelConfig`` for a configuration file, checked
    field by field against the file's ``model``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    port = config["port"]
    cfg = get_config(port["arch"]).replace(**port.get("replace", {}))
    m = config["model"]
    wrong = {k: (m[k], getattr(cfg, f)) for k, f in PORT_FIELDS.items()
             if k in m and m[k] != getattr(cfg, f)}
    norm = "rmsnorm" if cfg.norm_kind == "rmsnorm" else "layernorm"
    if m["norm"] != norm:
        wrong["norm"] = (m["norm"], norm)
    if m.get("n_experts") and m["route_group"] != moe_mod.GROUP:
        wrong["route_group"] = (m["route_group"], moe_mod.GROUP)
    if cfg.tie_embeddings or cfg.attn_kind != "full" or cfg.pos_kind != "rope" or cfg.qk_norm:
        wrong["kind"] = ("untied full attention with rope, no q/k norm", cfg)
    if wrong:
        raise ValueError(f"{config['name']}: the program's config differs from the file: {wrong}")
    return cfg


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks(kind: str) -> Dict[str, float]:
    """The published peaks of the card named ``kind``, or {} if the table
    has none."""
    return _load(PORTBENCH / "harness" / "peaks.json").get(kind, {})
