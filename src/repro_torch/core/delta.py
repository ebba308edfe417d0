"""The delta framework (paper §4.1, Definitions 1-5) in tensor form.

A partitioned delta over a timespan's slot assignment has two parts:

* **node payload** — dense slot-aligned tiles.  Because the paper freezes
  the node->partition map within a timespan (§4.5), every node also gets a
  frozen *slot*, so Δ-sum over node state degenerates from a sorted merge
  into an elementwise last-writer-wins overlay (the TPU adaptation —
  DESIGN.md §2; Pallas kernel in repro.kernels.delta_overlay):

      valid  (P, psize)      bool  — this delta touches the slot
      present(P, psize)      int8  — 0/1 node existence (post-state)
      attrs  (P, psize, K)   int32 — attribute values, -1 = unset

* **edge payload** — slot-keyed sorted adjacency runs; Δ-sum is a sorted
  last-wins merge (edges are too skewed for dense rows):

      e_src  (E,) int32 — slot-of-src within partition  (sorted major)
      e_dst  (E,) int32 — global dst node id            (sorted minor)
      e_op   (E,) int8  — 1 = present after this delta, 0 = deleted
      e_val  (E,) int32 — edge attribute value (-1 unset)
      (padded with e_src = INT32_MAX sentinels to fixed capacity)

All Δ-algebra identities of the paper hold and are property-tested:
Δ+∅=Δ, (Δ1+Δ2)+Δ3 = Δ1+(Δ2+Δ3), Δ−Δ=∅, and non-commutativity of +.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

SENTINEL = np.int32(2**31 - 1)

# the stored micro-delta schema (one source of truth for serialization,
# size accounting, and the planner's projection pushdown)
FIELDS = ("valid", "present", "attrs", "e_src", "e_dst", "e_op", "e_val")


@dataclasses.dataclass
class Delta:
    """One partitioned delta (all partitions of one horizontal shard)."""

    valid: np.ndarray  # (P, psize) bool
    present: np.ndarray  # (P, psize) int8
    attrs: np.ndarray  # (P, psize, K) int32
    e_src: np.ndarray  # (E,) int32 (slot ids, SENTINEL-padded, sorted)
    e_dst: np.ndarray  # (E,) int32
    e_op: np.ndarray  # (E,) int8
    e_val: np.ndarray  # (E,) int32

    # ---- constructors ----
    @classmethod
    def empty(cls, P: int, psize: int, K: int, ecap: int = 0) -> "Delta":
        return cls(
            valid=np.zeros((P, psize), bool),
            present=np.zeros((P, psize), np.int8),
            attrs=np.full((P, psize, K), -1, np.int32),
            e_src=np.full(ecap, SENTINEL, np.int32),
            e_dst=np.full(ecap, SENTINEL, np.int32),
            e_op=np.zeros(ecap, np.int8),
            e_val=np.full(ecap, -1, np.int32),
        )

    @property
    def shape(self):
        return self.valid.shape + (self.attrs.shape[-1], len(self.e_src))

    def n_edges(self) -> int:
        return int((self.e_src != SENTINEL).sum())

    def cardinality(self) -> int:
        """Paper Def. 3: unique node/edge descriptions in the delta."""
        return int(self.valid.sum()) + self.n_edges()

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in FIELDS)

    def copy(self) -> "Delta":
        return Delta(**{f: getattr(self, f).copy() for f in
                        ("valid", "present", "attrs", "e_src", "e_dst", "e_op", "e_val")})


# ---------------------------------------------------------------------------
# Node-payload algebra (elementwise, slot-aligned)
# ---------------------------------------------------------------------------


def _node_sum(a: Delta, b: Delta):
    """last-writer-wins overlay: b over a.  Attributes merge per-key: a
    delta that touches a node but leaves a key at -1 inherits a's value
    (matches event semantics: NATTR_SET writes one key)."""
    valid = a.valid | b.valid
    present = np.where(b.valid, b.present, a.present)
    attrs = np.where(b.valid[..., None] & (b.attrs != -1), b.attrs, a.attrs)
    # deletion clears attributes
    attrs = np.where((present == 0)[..., None], -1, attrs)
    return valid, present, attrs


def _edge_key(src, dst):
    # shift-pack (slot, dst) into one sortable int64.  This is a delta-
    # internal keyspace (src is a global SLOT id, not a node id) and is
    # never compared against GraphState.edge_key / snapshot.pack_edge_key
    # (which shifts by 32); both halves stay below 2^31 here (slots are
    # n_parts*psize-bounded, dst ids are bounded by events.py int32)
    return (src.astype(np.int64) << 31) | dst.astype(np.int64)


def _edge_sum(a: Delta, b: Delta, cap: Optional[int] = None):
    """Sorted last-wins merge of edge runs (b wins)."""
    na = int((a.e_src != SENTINEL).sum())
    nb = int((b.e_src != SENTINEL).sum())
    src = np.concatenate([a.e_src[:na], b.e_src[:nb]])
    dst = np.concatenate([a.e_dst[:na], b.e_dst[:nb]])
    op = np.concatenate([a.e_op[:na], b.e_op[:nb]])
    val = np.concatenate([a.e_val[:na], b.e_val[:nb]])
    prio = np.concatenate([np.zeros(na, np.int8), np.ones(nb, np.int8)])
    key = _edge_key(src, dst)
    order = np.lexsort((prio, key))
    key, src, dst, op, val = key[order], src[order], dst[order], op[order], val[order]
    # keep last of each key; inherit attr from the earlier run when the
    # later one leaves it unset and keeps the edge present
    last = np.ones(len(key), bool)
    if len(key) > 1:
        last[:-1] = key[1:] != key[:-1]
    # attribute inheritance within equal-key runs (at most 2 entries)
    if len(key) > 1:
        same_prev = key[1:] == key[:-1]
        inherit = same_prev & (val[1:] == -1) & (op[1:] == 1)
        val[1:][inherit] = val[:-1][inherit]
    src, dst, op, val = src[last], dst[last], op[last], val[last]
    n = len(src)
    cap = cap if cap is not None else max(n, 1)
    cap = max(cap, n)
    out = (
        np.full(cap, SENTINEL, np.int32),
        np.full(cap, SENTINEL, np.int32),
        np.zeros(cap, np.int8),
        np.full(cap, -1, np.int32),
    )
    out[0][:n], out[1][:n], out[2][:n], out[3][:n] = src, dst, op, val
    return out


def delta_sum(a: Delta, b: Delta, ecap: Optional[int] = None) -> Delta:
    """Paper Def. 4: Δs = a + b (b's components win on id collision)."""
    valid, present, attrs = _node_sum(a, b)
    e_src, e_dst, e_op, e_val = _edge_sum(a, b, ecap)
    return Delta(valid, present, attrs, e_src, e_dst, e_op, e_val)


def delta_intersection(a: Delta, b: Delta) -> Delta:
    """Paper Def. 5: components equal in both (used to build parents in
    the derived-snapshot hierarchy)."""
    same = (
        a.valid
        & b.valid
        & (a.present == b.present)
        & (a.attrs == b.attrs).all(-1)
    )
    valid = same
    present = np.where(same, a.present, 0).astype(np.int8)
    attrs = np.where(same[..., None], a.attrs, -1)
    # edges: sorted set intersection on (key, op, val)
    na = int((a.e_src != SENTINEL).sum())
    nb = int((b.e_src != SENTINEL).sum())
    ka = _edge_key(a.e_src[:na], a.e_dst[:na])
    kb = _edge_key(b.e_src[:nb], b.e_dst[:nb])
    common, ia, ib = np.intersect1d(ka, kb, return_indices=True)
    eq = (a.e_op[ia] == b.e_op[ib]) & (a.e_val[ia] == b.e_val[ib])
    ia = ia[eq]
    n = len(ia)
    cap = max(n, 1)
    e_src = np.full(cap, SENTINEL, np.int32)
    e_dst = np.full(cap, SENTINEL, np.int32)
    e_op = np.zeros(cap, np.int8)
    e_val = np.full(cap, -1, np.int32)
    e_src[:n], e_dst[:n] = a.e_src[ia], a.e_dst[ia]
    e_op[:n], e_val[:n] = a.e_op[ia], a.e_val[ia]
    return Delta(valid, present, attrs, e_src, e_dst, e_op, e_val)


def delta_difference(a: Delta, b: Delta) -> Delta:
    """a - b: components of a not present (identically) in b.  Satisfies
    (a ∩ b) + (a - (a ∩ b)) == a — the hierarchy reconstruction identity."""
    same = (
        a.valid
        & b.valid
        & (a.present == b.present)
        & (a.attrs == b.attrs).all(-1)
    )
    keep = a.valid & ~same
    valid = keep
    present = np.where(keep, a.present, 0).astype(np.int8)
    attrs = np.where(keep[..., None], a.attrs, -1)
    na = int((a.e_src != SENTINEL).sum())
    nb = int((b.e_src != SENTINEL).sum())
    ka = _edge_key(a.e_src[:na], a.e_dst[:na])
    kb = _edge_key(b.e_src[:nb], b.e_dst[:nb])
    # positions of a-edges identically present in b
    pos = np.searchsorted(kb, ka)
    pos_c = np.clip(pos, 0, max(nb - 1, 0))
    same_e = np.zeros(na, bool)
    if nb:
        same_e = (
            (kb[pos_c] == ka)
            & (b.e_op[pos_c] == a.e_op[:na])
            & (b.e_val[pos_c] == a.e_val[:na])
        )
    ia = np.nonzero(~same_e)[0]
    n = len(ia)
    cap = max(n, 1)
    e_src = np.full(cap, SENTINEL, np.int32)
    e_dst = np.full(cap, SENTINEL, np.int32)
    e_op = np.zeros(cap, np.int8)
    e_val = np.full(cap, -1, np.int32)
    e_src[:n], e_dst[:n] = a.e_src[ia], a.e_dst[ia]
    e_op[:n], e_val[:n] = a.e_op[ia], a.e_val[ia]
    return Delta(valid, present, attrs, e_src, e_dst, e_op, e_val)


def deltas_equal(a: Delta, b: Delta) -> bool:
    if not (
        (a.valid == b.valid).all()
        and (np.where(a.valid, a.present, 0) == np.where(b.valid, b.present, 0)).all()
        and (np.where(a.valid[..., None], a.attrs, -1)
             == np.where(b.valid[..., None], b.attrs, -1)).all()
    ):
        return False
    na = int((a.e_src != SENTINEL).sum())
    nb = int((b.e_src != SENTINEL).sum())
    if na != nb:
        return False
    return (
        (a.e_src[:na] == b.e_src[:nb]).all()
        and (a.e_dst[:na] == b.e_dst[:nb]).all()
        and (a.e_op[:na] == b.e_op[:nb]).all()
        and (a.e_val[:na] == b.e_val[:nb]).all()
    )
