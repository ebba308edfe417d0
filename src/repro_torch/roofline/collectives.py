"""The collectives of a sharded step, recorded as they are issued: the
port's counterpart of ``repro.roofline.hlo_analysis``, which parses them
out of the compiled SPMD HLO.

``CollectiveRecorder`` is a ``TorchDispatchMode``: it lets DTensor
dispatch first (returning ``NotImplemented`` for a DTensor operation),
so it sees the operations on each rank's local tensors, and records
every collective among them with its operand bytes and group size:
``_c10d_functional`` all-gather, reduce-scatter, all-reduce and
all-to-all (their coalesced and autograd forms too) and DTensor's own
``shard_dim_alltoall``.  The operations DTensor runs on fake tensors to
propagate shapes are skipped.  ``summarize_collectives`` applies the
reference's ring model and cross-pod rule to them and returns the
reference's keys:

    all-reduce        2 (n-1)/n * operand
    all-gather        (n-1)/n   * result        (result = n * operand)
    reduce-scatter    (n-1)/n   * operand       (operand = n * result)
    all-to-all        (n-1)/n   * operand

A group of 2 (the pod axis) or of more than 256 ranks counts as
crossing pods.  What is counted is what DTensor issues, eagerly and op by
op, which differs by design from what GSPMD chooses for the same
program (ROADMAP Queue 3); each op runs once, so there is no trip-count
weighting to do.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import torch
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
# op name -> (kind, index of the group size argument or None, of the group name)
_OPS = {
    "all_reduce": ("all-reduce", None, 2),
    "all_reduce_coalesced": ("all-reduce", None, 2),
    "all_gather_into_tensor": ("all-gather", 1, 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 1, 2),
    "reduce_scatter_tensor": ("reduce-scatter", 2, 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2, 3),
    "all_to_all_single": ("all-to-all", None, 3),
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    operand_bytes: int
    wire_bytes: float
    group_size: int


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def dtensor_op(types) -> bool:
    """Whether a dispatched operation has DTensor operands: a mode that
    counts local work returns ``NotImplemented`` for it, and DTensor's
    local operations come back to the mode."""
    return any(issubclass(t, DTensor) for t in types)


def fake(x) -> bool:
    """Whether ``x`` holds fake tensors: DTensor propagates shapes by
    running an operation on fake tensors of the global shape, no work of
    this rank."""
    from torch._subclasses.fake_tensor import is_fake

    return any(is_fake(t) for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def _group_size(group) -> int:
    return group if isinstance(group, int) else _resolve_process_group(group).size()


def collective_op(func, args) -> CollectiveOp:
    """The record of one collective call ``func(*args)``, or None for any
    other operation."""
    name = func._overloadpacket.__name__
    if func.namespace == "_dtensor" and name == "shard_dim_alltoall":
        kind, n = "all-to-all", _group_size(args[3])
    elif func.namespace in _NAMESPACES and name in _OPS:
        kind, size_at, group_at = _OPS[name]
        n = int(args[size_at]) if size_at is not None else _group_size(args[group_at])
    else:
        return None
    operand = _nbytes(args[0])
    if kind == "all-reduce":
        wire = 2.0 * operand * (n - 1) / max(n, 1)
    elif kind == "all-gather":
        wire = float(operand * (n - 1))  # (n-1)/n of the n-fold result
    else:  # reduce-scatter, all-to-all
        wire = operand * (n - 1) / max(n, 1)
    return CollectiveOp(kind, operand, wire, n)


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective issued while it is active (``ops``)."""

    def __init__(self):
        super().__init__()
        self.ops: List[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        op = collective_op(func, args)
        if op is not None and not fake(args[0]):
            self.ops.append(op)
        return out

    def summary(self) -> Dict:
        return summarize_collectives(self.ops)


def summarize_collectives(ops: List[CollectiveOp]) -> Dict:
    """The reference's collective summary of recorded ops: ``by_kind``
    {count, operand_bytes, wire_bytes}, ``n_ops``, ``operand_bytes``,
    ``wire_bytes`` and ``cross_pod_wire_bytes``."""
    by_kind: Dict[str, Dict] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0, "wire_bytes": 0.0})
    cross = 0.0
    for op in ops:
        d = by_kind[op.kind]
        d["count"] += 1
        d["operand_bytes"] += op.operand_bytes
        d["wire_bytes"] += op.wire_bytes
        if op.group_size in (2, 512) or op.group_size > 256:
            cross += op.wire_bytes
    return {
        "by_kind": dict(by_kind),
        "n_ops": len(ops),
        "operand_bytes": sum(d["operand_bytes"] for d in by_kind.values()),
        "wire_bytes": sum(d["wire_bytes"] for d in by_kind.values()),
        "cross_pod_wire_bytes": cross,
    }
