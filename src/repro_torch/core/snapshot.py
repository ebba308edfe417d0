"""Graph state, bucket replay, and the Δ-fold used by snapshot retrieval.

``GraphState`` is the host-side ground truth used during index
construction (and by the naive oracle the property tests compare
against).  ``events_to_delta`` turns an event bucket into a partitioned
Delta under a SlotMap; ``overlay_fold`` is the Σ Δ_si + Σ Δ_ei of
Algorithm 1 — with ``use_kernel`` its node payload runs the CUDA
`delta_overlay` kernel on the index's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core import delta as delta_mod
from repro_torch.core.delta import SENTINEL, Delta
from repro_torch.core.events import (
    EDGE_ADD,
    EDGE_DEL,
    EATTR_SET,
    NATTR_SET,
    NODE_ADD,
    NODE_DEL,
    EventLog,
)
from repro_torch.core.slots import SlotMap


# ---------------------------------------------------------------------------
# Edge-key packing (one source of truth for GraphState.edge_key)
# ---------------------------------------------------------------------------

_EDGE_KEY_SHIFT = 32
_EDGE_KEY_MASK = np.int64((1 << _EDGE_KEY_SHIFT) - 1)
_MAX_NODE_ID = 1 << 31  # ids must stay below this for a collision-free pack


def pack_edge_key(src, dst) -> np.ndarray:
    """Pack an (src, dst) pair into one sortable int64 key via a 32-bit
    shift.  The old ``src * 2**31 + dst`` arithmetic pack silently
    collides once ids reach 2^31; here ids are range-checked and the
    shift keeps the halves disjoint."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if len(src) and (int(src.min()) < 0 or int(dst.min()) < 0
                     or int(src.max()) >= _MAX_NODE_ID
                     or int(dst.max()) >= _MAX_NODE_ID):
        raise ValueError(
            f"edge endpoints must be in [0, 2^31) for int64 key packing; "
            f"got range [{int(min(src.min(), dst.min()))}, "
            f"{int(max(src.max(), dst.max()))}]")
    return (src << _EDGE_KEY_SHIFT) | dst


def unpack_edge_key(key) -> Tuple[np.ndarray, np.ndarray]:
    key = np.asarray(key, np.int64)
    return ((key >> _EDGE_KEY_SHIFT).astype(np.int32),
            (key & _EDGE_KEY_MASK).astype(np.int32))


# ---------------------------------------------------------------------------
# Host graph state (construction-time ground truth / test oracle)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphState:
    """Dense-by-node-id graph state. K node-attribute slots."""

    present: np.ndarray  # (N,) int8
    attrs: np.ndarray  # (N, K) int32
    edge_key: np.ndarray  # (E,) int64 sorted (pack_edge_key, canonical src<dst)
    edge_val: np.ndarray  # (E,) int32

    @classmethod
    def empty(cls, n_nodes: int, K: int) -> "GraphState":
        return cls(
            present=np.zeros(n_nodes, np.int8),
            attrs=np.full((n_nodes, K), -1, np.int32),
            edge_key=np.empty(0, np.int64),
            edge_val=np.empty(0, np.int32),
        )

    def copy(self) -> "GraphState":
        return GraphState(self.present.copy(), self.attrs.copy(),
                          self.edge_key.copy(), self.edge_val.copy())

    def nbytes(self) -> int:
        """Materialized size — the storage benchmark's working-set
        reference against FetchCost.n_bytes_decompressed."""
        return (self.present.nbytes + self.attrs.nbytes
                + self.edge_key.nbytes + self.edge_val.nbytes)

    def grow(self, n_nodes: int):
        if n_nodes > len(self.present):
            extra = n_nodes - len(self.present)
            self.present = np.r_[self.present, np.zeros(extra, np.int8)]
            self.attrs = np.concatenate(
                [self.attrs, np.full((extra, self.attrs.shape[1]), -1, np.int32)]
            )

    # ---- replay ----
    def apply_bucket(self, ev: EventLog):
        """Apply one chronological event bucket (vectorized last-wins; a
        bucket is the atomic replay unit — checkpoints sit on bucket
        boundaries, so intra-bucket ordering only needs last-wins)."""
        if not len(ev):
            return
        self.grow(ev.n_nodes)
        # node add/del: last op per node
        m = (ev.kind == NODE_ADD) | (ev.kind == NODE_DEL)
        if m.any():
            nids = ev.src[m]
            ops = (ev.kind[m] == NODE_ADD).astype(np.int8)
            # keep last per node (stable order)
            _, last_idx = np.unique(nids[::-1], return_index=True)
            last_idx = len(nids) - 1 - last_idx
            self.present[nids[last_idx]] = ops[last_idx]
            deleted = nids[last_idx][ops[last_idx] == 0]
            self.attrs[deleted] = -1
        # node attrs: last per (node, key)
        m = ev.kind == NATTR_SET
        if m.any():
            nid, key, val = ev.src[m], ev.key[m].astype(np.int64), ev.val[m]
            ck = nid.astype(np.int64) * 64 + key
            _, last_idx = np.unique(ck[::-1], return_index=True)
            last_idx = len(ck) - 1 - last_idx
            self.attrs[nid[last_idx], key[last_idx].astype(np.int32)] = val[last_idx]
        # edges: last op per (src,dst); EATTR_SET counts as presence-keeping
        m = (ev.kind == EDGE_ADD) | (ev.kind == EDGE_DEL) | (ev.kind == EATTR_SET)
        if m.any():
            src, dst = ev.src[m], ev.dst[m]
            kinds = ev.kind[m]
            vals = ev.val[m]
            key = pack_edge_key(src, dst)
            _, last_idx = np.unique(key[::-1], return_index=True)
            last_idx = np.sort(len(key) - 1 - last_idx)
            key, kinds, vals = key[last_idx], kinds[last_idx], vals[last_idx]
            add = kinds != EDGE_DEL
            # merge into sorted edge set
            self._merge_edges(key[add], vals[add], key[~add])

    def _merge_edges(self, add_keys, add_vals, del_keys):
        if len(add_keys):
            pos = np.searchsorted(self.edge_key, add_keys)
            pos_c = np.clip(pos, 0, max(len(self.edge_key) - 1, 0))
            exists = np.zeros(len(add_keys), bool)
            if len(self.edge_key):
                exists = self.edge_key[pos_c] == add_keys
            # update attrs of existing; EATTR_SET with val -1 keeps old
            upd = exists & (add_vals >= 0)
            self.edge_val[pos_c[upd]] = add_vals[upd]
            new_keys = add_keys[~exists]
            new_vals = add_vals[~exists]
            if len(new_keys):
                keys = np.concatenate([self.edge_key, new_keys])
                vals = np.concatenate([self.edge_val, new_vals])
                order = np.argsort(keys, kind="stable")
                self.edge_key, self.edge_val = keys[order], vals[order]
        if len(del_keys):
            keep = ~np.isin(self.edge_key, del_keys)
            self.edge_key = self.edge_key[keep]
            self.edge_val = self.edge_val[keep]

    # ---- views ----
    def node_ids(self) -> np.ndarray:
        return np.nonzero(self.present)[0].astype(np.int32)

    def edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        src, dst = unpack_edge_key(self.edge_key)
        return src, dst, self.edge_val.copy()

    def degree(self) -> np.ndarray:
        deg = np.zeros(len(self.present), np.int64)
        src, dst, _ = self.edges()
        np.add.at(deg, src, 1)
        np.add.at(deg, dst, 1)
        return deg

    def to_delta(self, smap: SlotMap, K: Optional[int] = None) -> Delta:
        """Full-state snapshot Delta (paper Ex. 4: G(t) - G(-inf))."""
        K = K or self.attrs.shape[1]
        d = Delta.empty(smap.n_parts, smap.psize, K, ecap=max(len(self.edge_key), 1))
        nids = self.node_ids()
        pid, slot, found = smap.lookup(nids)
        assert found.all(), "snapshot contains node outside slot map"
        d.valid[pid, slot] = True
        d.present[pid, slot] = 1
        d.attrs[pid, slot] = self.attrs[nids]
        src, dst, val = self.edges()
        # mirror each edge under BOTH endpoints' slots so a partition's
        # micro-delta holds every edge with >=1 endpoint in it (the
        # paper's partitioned-snapshot definition, Ex. 5); duplicates are
        # canonicalized away at materialization
        m_src = np.concatenate([src, dst])
        m_dst = np.concatenate([dst, src])
        m_val = np.concatenate([val, val])
        spid, sslot, sfound = smap.lookup(m_src)
        assert sfound.all()
        gslot = spid.astype(np.int64) * smap.psize + sslot
        order = np.lexsort((m_dst, gslot))
        d.e_src = gslot[order].astype(np.int32)
        d.e_dst = m_dst[order].astype(np.int32)
        d.e_op = np.ones(len(order), np.int8)
        d.e_val = m_val[order].astype(np.int32)
        return d


# ---------------------------------------------------------------------------
# Events -> partitioned Delta (the eventlist overlay of Algorithm 1)
# ---------------------------------------------------------------------------


def events_to_delta(ev: EventLog, smap: SlotMap, K: int,
                    base_attrs: Optional[Dict] = None) -> Delta:
    """Collapse a chronological event bucket into a Delta under `smap`.

    Note NATTR_SET on a node the bucket doesn't otherwise touch yields a
    valid slot whose `present` must reflect the node's existing state —
    the paper's events are post-state diffs; we mark present=1 (an attr
    set implies the node exists).
    """
    d = Delta.empty(smap.n_parts, smap.psize, K, ecap=max(int(((ev.kind == EDGE_ADD) | (ev.kind == EDGE_DEL) | (ev.kind == EATTR_SET)).sum()), 1))
    if not len(ev):
        return d
    # --- nodes ---
    m = (ev.kind == NODE_ADD) | (ev.kind == NODE_DEL) | (ev.kind == NATTR_SET)
    if m.any():
        nids = ev.src[m]
        kinds = ev.kind[m]
        keys = ev.key[m]
        vals = ev.val[m]
        pid, slot, found = smap.lookup(nids)
        assert found.all(), "event touches node outside timespan slot map"
        # chronological apply (vectorized last-wins per (node) for
        # presence, per (node,key) for attrs)
        pres_m = kinds != NATTR_SET
        if pres_m.any():
            n2, p2, s2 = nids[pres_m], pid[pres_m], slot[pres_m]
            ops = (kinds[pres_m] == NODE_ADD).astype(np.int8)
            _, last = np.unique(n2[::-1], return_index=True)
            last = len(n2) - 1 - last
            d.valid[p2[last], s2[last]] = True
            d.present[p2[last], s2[last]] = ops[last]
        at_m = kinds == NATTR_SET
        if at_m.any():
            n2, p2, s2 = nids[at_m], pid[at_m], slot[at_m]
            k2, v2 = keys[at_m].astype(np.int64), vals[at_m]
            ck = n2.astype(np.int64) * 64 + k2
            _, last = np.unique(ck[::-1], return_index=True)
            last = len(ck) - 1 - last
            newly = ~d.valid[p2[last], s2[last]]
            d.valid[p2[last], s2[last]] = True
            # attr-set implies existence unless an explicit later delete
            d.present[p2[last], s2[last]] = np.where(
                newly, 1, d.present[p2[last], s2[last]]
            )
            d.attrs[p2[last], s2[last], k2[last].astype(np.int32)] = v2[last]
    # --- edges ---
    m = (ev.kind == EDGE_ADD) | (ev.kind == EDGE_DEL) | (ev.kind == EATTR_SET)
    if m.any():
        src, dst, kinds, vals = ev.src[m], ev.dst[m], ev.kind[m], ev.val[m]
        key = pack_edge_key(src, dst)
        _, last = np.unique(key[::-1], return_index=True)
        last = np.sort(len(key) - 1 - last)
        src, dst, kinds, vals = src[last], dst[last], kinds[last], vals[last]
        # mirror to both endpoints (see GraphState.to_delta)
        m_src = np.concatenate([src, dst])
        m_dst = np.concatenate([dst, src])
        m_kinds = np.concatenate([kinds, kinds])
        m_vals = np.concatenate([vals, vals])
        pid, slot, found = smap.lookup(m_src)
        assert found.all()
        gslot = pid.astype(np.int64) * smap.psize + slot
        order = np.lexsort((m_dst, gslot))
        n = len(order)
        need = n
        if need > len(d.e_src):
            pad = need - len(d.e_src)
            d.e_src = np.r_[d.e_src, np.full(pad, SENTINEL, np.int32)]
            d.e_dst = np.r_[d.e_dst, np.full(pad, SENTINEL, np.int32)]
            d.e_op = np.r_[d.e_op, np.zeros(pad, np.int8)]
            d.e_val = np.r_[d.e_val, np.full(pad, -1, np.int32)]
        d.e_src[:n] = gslot[order].astype(np.int32)
        d.e_dst[:n] = m_dst[order]
        d.e_op[:n] = (m_kinds[order] != EDGE_DEL).astype(np.int8)
        d.e_val[:n] = m_vals[order]
    return d


def overlay_fold(deltas: List[Delta], ecap: Optional[int] = None,
                 use_kernel: bool = False, device=None) -> Delta:
    """Σ over an ordered delta chain (Algorithm 1's merge).  With
    ``use_kernel`` the node payload is stacked, uploaded to ``device``
    (None: the CUDA card) and folded by the fused ``delta_overlay`` op —
    the CUDA kernel on a card, its plain version on the CPU; edges use
    the sorted last-wins merge on the host."""
    assert deltas
    if use_kernel:
        from repro_torch.kernels.delta_overlay import ops as ov_ops

        on = dev.resolve(device)
        node_part = ov_ops.overlay(*(
            torch.from_numpy(np.stack([getattr(d, f) for d in deltas])).to(on)
            for f in ("valid", "present", "attrs")))
        acc = deltas[0].copy()
        acc.valid, acc.present, acc.attrs = (x.cpu().numpy() for x in node_part)
        for d in deltas[1:]:
            acc.e_src, acc.e_dst, acc.e_op, acc.e_val = delta_mod._edge_sum(acc, d, ecap)
        return acc
    acc = deltas[0]
    for d in deltas[1:]:
        acc = delta_mod.delta_sum(acc, d, ecap)
    return acc


def delta_to_graph(d: Delta, smap: SlotMap) -> GraphState:
    """Materialize a reconstructed snapshot Delta back to GraphState."""
    K = d.attrs.shape[-1]
    rev = smap.reverse()  # (P, psize) -> nid
    n_nodes = int(smap.node_ids.max()) + 1 if len(smap.node_ids) else 0
    g = GraphState.empty(n_nodes, K)
    on = d.valid & (d.present == 1)
    nids = rev[on]
    g.present[nids] = 1
    g.attrs[nids] = d.attrs[on]
    ne = int((d.e_src != SENTINEL).sum())
    if ne:
        keep = d.e_op[:ne] == 1
        gslot = d.e_src[:ne][keep].astype(np.int64)
        pid = (gslot // smap.psize).astype(np.int32)
        slot = (gslot % smap.psize).astype(np.int32)
        src = rev[pid, slot]
        dst = d.e_dst[:ne][keep]
        # canonicalize mirrored copies (edges stored under both endpoints)
        lo = np.minimum(src.astype(np.int64), dst.astype(np.int64))
        hi = np.maximum(src.astype(np.int64), dst.astype(np.int64))
        key = pack_edge_key(lo, hi)
        val = d.e_val[:ne][keep]
        order = np.argsort(key, kind="stable")
        key, val = key[order], val[order]
        uniq = np.ones(len(key), bool)
        if len(key) > 1:
            uniq[1:] = key[1:] != key[:-1]
        g.edge_key = key[uniq]
        g.edge_val = val[uniq]
    return g
