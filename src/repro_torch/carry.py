"""Carry host state into the port from plain arrays.

The reference package and the port keep the same host state (event
columns, SoN/SoTS operands) as numpy arrays in their own dataclasses.
These constructors rebuild the port's objects from those arrays, so one
seeded input can be fed to both packages without either importing the
other: pass ``{name: getattr(obj, name)}`` over the reference object's
fields.

The LM's parameters and caches travel as nested dicts of numpy arrays in
the reference's tree layout (``{"embed", "final_norm", ["pos"],
"rem": {"b<i>"}, "units": {"b<i>": leaves stacked over units},
["enc_units": {"b0": leaves stacked over encoder layers}, "enc_norm"]}``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.events import COLUMNS, DTYPES, EventLog
from repro_torch.taf.son import SoN, SoTS


def eventlog_from_arrays(cols: Dict[str, np.ndarray]) -> EventLog:
    """EventLog from its columns (already sorted, kept in their order)."""
    return EventLog(**{c: np.asarray(cols[c], DTYPES[c]) for c in COLUMNS})


def _fields(cls, fields: Dict) -> Dict:
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"{cls.__name__} fields missing: {sorted(missing)}")
    return {n: (np.array(fields[n]) if isinstance(fields[n], np.ndarray)
                else fields[n]) for n in names}


def son_from_arrays(fields: Dict) -> SoN:
    """SoN from the fields of a SoN (arrays copied)."""
    return SoN(**_fields(SoN, fields))


def sots_from_arrays(fields: Dict) -> SoTS:
    """SoTS from the fields of a SoTS (arrays copied)."""
    return SoTS(**_fields(SoTS, fields))


def _flat(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_names(cfg, tree: Dict) -> Dict[str, tuple]:
    """Each port state-dict name for the reference's parameter tree (of
    arrays, or of anything else in its layout, e.g. the axes tree of
    ``split_tree``): ``{name: (the reference's leaf path, a tuple of
    keys; the unit index, or None for an unstacked leaf)}``.
    ``rem/b<i>/...`` is layer i, ``units/b<i>/...[u]`` layer ``n_rem + u *
    unit_len + i`` (``norm_x``, ``xattn`` included), ``enc_units/b0/...[u]``
    encoder layer u; ``pos`` and ``enc_norm`` keep their names."""
    names = {}
    stacks = ("rem", "units", "enc_units")
    for name, _ in _flat({k: v for k, v in tree.items() if k not in stacks}):
        names[name] = (tuple(name.split(".")), None)
    for name, _ in _flat(tree.get("enc_units") or {}):
        rest = name.split(".", 1)[1]
        for u in range(cfg.n_enc_layers):
            names[f"enc_layers.{u}.{rest}"] = (("enc_units", *name.split(".")), u)
    for name, _ in _flat(tree.get("rem") or {}):
        b, rest = name.split(".", 1)
        names[f"layers.{int(b[1:])}.{rest}"] = (("rem", *name.split(".")), None)
    for name, _ in _flat(tree.get("units") or {}):
        b, rest = name.split(".", 1)
        for u in range(cfg.n_units):
            layer = cfg.n_rem_layers + u * cfg.unit_len + int(b[1:])
            names[f"layers.{layer}.{rest}"] = (("units", *name.split(".")), u)
    return names


def lm_leaf(tree: Dict, path: tuple):
    """The leaf of ``tree`` at ``path`` (``lm_names``' keys)."""
    for k in path:
        tree = tree[k]
    return tree


def lm_params_from_arrays(cfg, tree: Dict) -> Dict[str, torch.Tensor]:
    """The port's LM state dict from the reference's parameter tree (as
    numpy, e.g. ``split_tree(lm.init(...))[0]``), named by ``lm_names``."""
    state = {}
    for name, (path, unit) in lm_names(cfg, tree).items():
        value = lm_leaf(tree, path)
        state[name] = torch.from_numpy(np.array(value if unit is None else value[unit]))
    return state


def lm_cache_to_arrays(cfg, caches: List[Dict]) -> Dict:
    """The reference's ``{"rem", "units"}`` cache tree (numpy) from the
    port's per-layer caches, unit leaves stacked over units (a
    cross-attention layer's ``ck``/``cv`` with its ``k``/``v``)."""

    def host(c):
        return {k: host(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in c.items()}

    rem = {f"b{i}": host(caches[i]) for i in range(cfg.n_rem_layers)}
    units = None
    if cfg.n_units:
        per_unit = [[host(caches[cfg.n_rem_layers + u * cfg.unit_len + i])
                     for u in range(cfg.n_units)] for i in range(cfg.unit_len)]

        def stack(trees):
            return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                    else np.stack([t[k] for t in trees]) for k in trees[0]}

        units = {f"b{i}": stack(per_unit[i]) for i in range(cfg.unit_len)}
    return {"rem": rem, "units": units}
