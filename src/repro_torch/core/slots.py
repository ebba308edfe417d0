"""Per-timespan node -> (partition, slot) assignment.

The paper freezes the node->partition function f_i within a timespan
(§4.5); we additionally freeze a *slot* index inside the partition, which
is what makes dense slot-aligned deltas (and the elementwise Δ-sum
overlay) possible.  Slot maps are rebuilt at timespan boundaries exactly
where the paper re-partitions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def hash32(x: np.ndarray) -> np.ndarray:
    """Deterministic avalanche hash (splitmix-style) for balanced
    node->shard placement (the paper's 'random function of the node-id')."""
    x = x.astype(np.uint32)
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * np.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


@dataclasses.dataclass
class SlotMap:
    """node-id -> (pid, slot) for one timespan.

    node_ids is sorted; (pid, slot) parallel arrays.  psize is uniform
    across partitions (padded) — BlockSpec-friendly.
    """

    node_ids: np.ndarray  # (N,) int32 sorted
    pid: np.ndarray  # (N,) int32
    slot: np.ndarray  # (N,) int32
    n_parts: int
    psize: int

    @classmethod
    def build(cls, node_ids: np.ndarray, n_parts: int,
              assignment: Optional[np.ndarray] = None,
              pad_multiple: int = 128) -> "SlotMap":
        """assignment: optional node->partition (locality partitioner);
        default = hash partitioning."""
        node_ids = np.unique(np.asarray(node_ids, np.int32))
        if assignment is None:
            pid = (hash32(node_ids) % np.uint32(n_parts)).astype(np.int32)
        else:
            pid = np.asarray(assignment, np.int32)
            assert len(pid) == len(node_ids)
        # slot = rank within partition (stable by node id)
        order = np.lexsort((node_ids, pid))
        slot = np.empty(len(node_ids), np.int32)
        ranks = np.arange(len(node_ids), dtype=np.int32)
        # rank within each pid group
        pid_sorted = pid[order]
        group_start = np.zeros(len(node_ids), np.int64)
        if len(node_ids):
            starts = np.r_[0, np.nonzero(np.diff(pid_sorted))[0] + 1]
            sizes = np.diff(np.r_[starts, len(node_ids)])
            within = ranks - np.repeat(starts, sizes)
            slot[order] = within.astype(np.int32)
        counts = np.bincount(pid, minlength=n_parts) if len(node_ids) else np.zeros(n_parts, int)
        psize = int(counts.max()) if len(node_ids) else pad_multiple
        psize = max(((psize + pad_multiple - 1) // pad_multiple) * pad_multiple, pad_multiple)
        return cls(node_ids=node_ids, pid=pid, slot=slot, n_parts=n_parts, psize=psize)

    def lookup(self, nids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (pid, slot, found_mask) for query node ids."""
        nids = np.asarray(nids, np.int32)
        pos = np.searchsorted(self.node_ids, nids)
        pos_c = np.clip(pos, 0, max(len(self.node_ids) - 1, 0))
        found = np.zeros(len(nids), bool)
        if len(self.node_ids):
            found = self.node_ids[pos_c] == nids
        pid = np.where(found, self.pid[pos_c], -1).astype(np.int32)
        slot = np.where(found, self.slot[pos_c], -1).astype(np.int32)
        return pid, slot, found

    def reverse(self) -> np.ndarray:
        """(n_parts, psize) int32 table: slot -> node id (-1 = empty)."""
        table = np.full((self.n_parts, self.psize), -1, np.int32)
        table[self.pid, self.slot] = self.node_ids
        return table

    def n_nodes(self) -> int:
        return len(self.node_ids)
