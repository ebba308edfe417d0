"""Carry host state into the port from plain arrays.

The reference package and the port keep the same host state (event
columns, SoN/SoTS operands) as numpy arrays in their own dataclasses.
These constructors rebuild the port's objects from those arrays, so one
seeded input can be fed to both packages without either importing the
other: pass ``{name: getattr(obj, name)}`` over the reference object's
fields.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

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
