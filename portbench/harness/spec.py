"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
each cell names a configuration (``portbench/configs/<config>.json``) and
a traffic mix (``portbench/traffic/<traffic>.json``), and its limits of
the output check are in ``portbench/cells/<cell>.json``.  Each per-layer
metric is read by ``portbench/metrics/<metric>.py``.  Adding a cell, a
mix, a metric or a configuration adds files and entries; no file here
changes.

A configuration file may name its plain reference, ``"reference":
"<name>"`` (default ``lm``): ``portbench/reference/<name>.py``, found by
path under the run's root and loaded once a path.  The module provides

* the model: ``exact()``, ``Routing``, ``logits_at(m, get_block, tokens,
  at, quant=None, routing=None)`` and ``loss(m, params, tokens, labels,
  quant=None, routing=None)`` (as ``reference.lm`` defines them);
* the weights drawn from the seed: ``leaves(m)``, ``n_blocks(m)``,
  ``draw_block(m, seed, index, dtype, device)`` and ``layer_block(i)``
  (as ``reference.weights``);
* the port check: ``unsupported(cfg)``, None where it computes the
  program's ``ModelConfig`` ``cfg``, else what it does compute (the
  refusal), and optionally ``PORT_FIELDS``, further model keys and the
  config fields they must equal (beside this module's ``PORT_FIELDS``);
* the operations and bytes the model's work needs: ``window_flops``,
  ``window_decode_bytes``, ``attn_fwd_least_seconds`` and
  ``attn_bwd_least_seconds`` (as ``harness.flops`` defines them, which
  ``lm`` re-exports).  The metric readers see the module as ``run.flops``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
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
    reference: ModuleType  # the configuration's plain reference and counts
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
    config = _load(pb / "configs" / f"{w['config']}.json")
    return Cell(name=name, config=config,
                reference=module("reference", config.get("reference", "lm"), root),
                traffic=_load(pb / "traffic" / f"{w['traffic']}.json"),
                limits=_load(pb / "cells" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _listed(m, name)],
                per_layer=[m for m in bench["per_layer"] if _listed(m, name)],
                chips=int(w["chips"]))


def port_config(config: dict, reference: ModuleType):
    """The program's ``ModelConfig`` for a configuration file, checked
    field by field against the file's ``model``, and refused where the
    configuration's ``reference`` cannot compute it."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    port = config["port"]
    cfg = get_config(port["arch"]).replace(**port.get("replace", {}))
    m = config["model"]
    fields = {**PORT_FIELDS, **getattr(reference, "PORT_FIELDS", {})}
    wrong = {k: (m[k], getattr(cfg, f)) for k, f in fields.items()
             if k in m and m[k] != getattr(cfg, f)}
    norm = "rmsnorm" if cfg.norm_kind == "rmsnorm" else "layernorm"
    if m["norm"] != norm:
        wrong["norm"] = (m["norm"], norm)
    if m.get("n_experts") and m["route_group"] != moe_mod.GROUP:
        wrong["route_group"] = (m["route_group"], moe_mod.GROUP)
    computes = reference.unsupported(cfg)
    if computes:
        wrong["kind"] = (computes, cfg)
    if wrong:
        raise ValueError(f"{config['name']}: the program's config differs from the file: {wrong}")
    return cfg


def module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/<kind>/<name>.py`` under ``root``, loaded by path once
    (a module's classes then stay the same objects across cells)."""
    path = (root / "portbench" / kind / f"{name}.py").resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    key = f"portbench_{kind}_{name}_{tag}".replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod  # before it runs: dataclasses look their module up
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``."""
    return module("metrics", metric, root).read


def peaks(kind: str) -> Dict[str, float]:
    """The published peaks of the card named ``kind``, or {} if the table
    has none."""
    return _load(PORTBENCH / "harness" / "peaks.json").get(kind, {})
