"""TGI-backed training checkpoint store (port of
``repro.storage.checkpoint``): the paper's technique turned on training
state.

Training-state history is a temporal graph: parameter blocks are nodes,
saves are timepoints.  The store keeps

* **snapshot checkpoints** (the paper's Copy leg): full blocks, every
  ``snapshot_every``-th save;
* **delta checkpoints** (the Log leg): per-block XOR of the raw bits
  against the previous save, zlib-compressed, exact to invert.

Restore at step t is the nearest snapshot plus forward delta replay
(Algorithm 1).  Blocks are keyed ``(tsid=save_idx, sid=block_hash)`` over
the same ``DeltaStore``, with a crc32 checked on read; replication and
failover come from the store.

A tree is nested dicts, lists and tuples whose leaves are tensors (on any
device), numpy arrays or scalars; it is flattened in the order
``jax.tree`` uses (dict keys sorted, ``None`` holds no leaf), so for the
same tree of numpy arrays every chunk blob (``did="P:<leaf>"``) is byte
for byte the reference's; only the manifest's ``treedef`` string differs.
A tensor is copied to the host; a bfloat16 leaf, which numpy has no type
for, is stored as its raw 16-bit words under dtype ``"bfloat16"``.
``restore(example_tree=...)`` puts each leaf back where the example's
leaf lives: a tensor of its type on its device, or a numpy array.
``restore_sharded`` places each leaf on a DeviceMesh as a DTensor, each
rank taking its own chunk of the restored leaf, so nothing is broadcast;
the mesh may differ in size from the writer's (the reference's elastic
restore, which ``launch.elastic`` plans for).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import Placement

from repro_torch.models.sharding import Sharder, place
from repro_torch.storage.kvstore import DeltaKey, DeltaStore

BLOCK = 1 << 20  # 1 MiB per node-block


@dataclasses.dataclass
class CheckpointConfig:
    snapshot_every: int = 4  # full checkpoint cadence (Copy vs Log knob)
    compress_level: int = 1
    n_shards: int = 4  # placement width


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def tree_flatten(tree):
    """(leaves, treedef) in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples in order, ``None`` an empty subtree."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _flatten(node, leaves: List[Any]):
    """``node``'s treedef, its leaves appended to ``leaves``.  At module
    level: a nested function that calls itself is a reference cycle, and
    one that closed over ``leaves`` kept every tensor of the tree alive
    until the garbage collector ran."""
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return ("leaf",)


def tree_unflatten(treedef, leaves):
    return _unflatten(treedef, iter(leaves))


def _unflatten(d, it):
    """The tree of treedef ``d``, its leaves taken from ``it`` in order
    (at module level, as ``_flatten``)."""
    kind = d[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(d[1], d[2])}
    children = [_unflatten(c, it) for c in d[1]]
    return children if kind == "list" else tuple(children)


def _host(leaf) -> np.ndarray:
    """The leaf as a host numpy array of its bits (a bfloat16 tensor as
    int16 words, the caller keeps its dtype name).  A tensor is copied:
    the trainer updates its parameters in place, and the next save's XOR
    needs this save's bits."""
    if torch.is_tensor(leaf):
        t = Sharder.whole(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _leaf_blocks(arr: np.ndarray):
    raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    return [raw[i : i + BLOCK] for i in range(0, len(raw), BLOCK)] or [raw]


def _from_raw(raw: np.ndarray, meta: Dict, like=None):
    """A saved leaf from its bytes: like the example leaf ``like`` (a
    tensor of its type on its device, or numpy) or, without one, numpy
    (a bfloat16 leaf as a CPU tensor)."""
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16).reshape(meta["shape"]).copy()).view(
            torch.bfloat16)
    else:
        arr = raw.view(np.dtype(meta["dtype"])).reshape(meta["shape"])
        if not torch.is_tensor(like):
            return arr
        t = torch.from_numpy(arr.copy())
    if torch.is_tensor(like):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def _placement_leaves(tree) -> list:
    """The placement lists of a shardings tree, in ``tree_flatten``'s
    order (a list or tuple of placements is a leaf)."""
    if isinstance(tree, (list, tuple)) and tree and all(isinstance(p, Placement)
                                                        for p in tree):
        return [list(tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _placement_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [p for c in tree for p in _placement_leaves(c)]
    if tree is None:
        return []
    raise TypeError(f"not a placement list: {tree!r}")


class CheckpointStore:
    def __init__(self, store: DeltaStore, cfg: CheckpointConfig = CheckpointConfig()):
        self.store = store
        self.cfg = cfg
        self.saves: List[Dict] = []  # manifest per save: step, kind, leaf meta
        self._prev_raw: Optional[List[np.ndarray]] = None
        self._pool = cf.ThreadPoolExecutor(max_workers=2)
        self._blocks = cf.ThreadPoolExecutor(max_workers=os.cpu_count() or 1)

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------

    def save(self, step: int, tree) -> Dict:
        """Synchronous save; returns the manifest entry."""
        leaves, treedef = tree_flatten(tree)
        host = [_host(l) for l in leaves]
        dtypes = ["bfloat16" if torch.is_tensor(l) and l.dtype == torch.bfloat16
                  else str(h.dtype) for l, h in zip(leaves, host)]
        raws = [np.ascontiguousarray(h).view(np.uint8).reshape(-1) for h in host]
        sidx = len(self.saves)
        is_snap = (sidx % self.cfg.snapshot_every == 0) or self._prev_raw is None
        kind = "snap" if is_snap else "delta"
        leaf_meta = []
        for li, (h, dt, raw) in enumerate(zip(host, dtypes, raws)):
            payload = raw if is_snap else np.bitwise_xor(raw, self._prev_raw[li])
            blocks = _leaf_blocks(payload)
            keys = [DeltaKey(tsid=sidx, sid=(li * 131 + bi) % self.cfg.n_shards,
                             did=f"P:{li}", pid=bi) for bi in range(len(blocks))]
            # the blocks compress in parallel (zlib drops the GIL) and are
            # written in order, so the store's bytes are a serial save's
            blk_meta = []
            for key, (blob, raw_bytes, crc, n) in zip(
                    keys, self._blocks.map(self._encode_block, keys, blocks)):
                self.store.put_encoded(key, blob, raw_bytes)
                blk_meta.append({"key": list(key), "crc": crc, "n": n})
            leaf_meta.append({"shape": list(h.shape), "dtype": dt, "blocks": blk_meta})
        entry = {"step": int(step), "save_idx": sidx, "kind": kind,
                 "leaves": leaf_meta, "treedef": repr(treedef)}
        self.saves.append(entry)
        self._prev_raw = raws
        self._treedef = treedef
        # manifest blob (replicated like any chunk)
        self.store.put(
            DeltaKey(sidx, 0, "MANIFEST", 0),
            {"json": np.frombuffer(json.dumps(entry).encode(), np.uint8)},
        )
        return entry

    def _encode_block(self, key: DeltaKey, blk: np.ndarray):
        """One block's store record, encoded: (blob, raw bytes, crc, n)."""
        crc = zlib.crc32(blk)
        comp = zlib.compress(blk, self.cfg.compress_level)
        blob, raw_bytes = self.store.encode_payload(key, {
            "z": np.frombuffer(comp, np.uint8),
            "crc": np.asarray([crc], np.uint32),
            "n": np.asarray([len(blk)], np.int64),
        })
        return blob, raw_bytes, int(crc), len(blk)

    def save_async(self, step: int, tree):
        """Async save: copies every leaf to the host synchronously (a
        device leaf's copy waits for the device) and writes in a worker
        thread, so the train loop is not blocked on storage."""
        leaves, treedef = tree_flatten(tree)
        host = [Sharder.whole(l).detach().to("cpu", copy=True) if torch.is_tensor(l)
                else np.asarray(l).copy() for l in leaves]
        return self._pool.submit(self.save, step, tree_unflatten(treedef, host))

    # ------------------------------------------------------------------
    # Restore (Algorithm 1 on parameter history)
    # ------------------------------------------------------------------

    def _fetch_payload(self, entry: Dict, c: int) -> List[np.ndarray]:
        """Each leaf's raw bytes.  A leaf at a time: its blocks fetched
        (``c`` clients) and inflated in parallel, so only one leaf's
        compressed blocks are held at once."""
        out = []
        for lm in entry["leaves"]:
            keys = [DeltaKey(*bm["key"]) for bm in lm["blocks"]]
            got = self.store.multiget(keys, c=c)

            def block(key, bm):
                blk = np.frombuffer(zlib.decompress(got[key]["z"]), np.uint8)
                if zlib.crc32(blk) != bm["crc"] or len(blk) != bm["n"]:
                    raise IOError(f"checkpoint corrupt: block {bm['key']}")
                return blk

            out.append(np.concatenate(list(self._blocks.map(block, keys, lm["blocks"]))))
            del got
        return out

    def restore(self, step: Optional[int] = None, c: int = 4, example_tree=None):
        """Reconstruct the tree at `step` (default: latest): the nearest
        snapshot, then XOR-delta replay forward.  With ``example_tree``
        the leaves come back shaped and placed like its leaves."""
        if not self.saves:
            raise ValueError("nothing saved")
        target = max(
            (e for e in self.saves if step is None or e["step"] <= step),
            key=lambda e: e["step"],
        )
        sidx = target["save_idx"]
        snap_idx = max(i for i in range(sidx + 1)
                       if self.saves[i]["kind"] == "snap")
        raws = self._fetch_payload(self.saves[snap_idx], c)
        for i in range(snap_idx + 1, sidx + 1):
            deltas = self._fetch_payload(self.saves[i], c)
            raws = [np.bitwise_xor(r, d) for r, d in zip(raws, deltas)]
        if example_tree is not None:
            likes, treedef = tree_flatten(example_tree)
        else:
            likes, treedef = [None] * len(raws), self._treedef
        leaves = [_from_raw(raw, lm, like)
                  for raw, lm, like in zip(raws, target["leaves"], likes)]
        return tree_unflatten(treedef, leaves), target["step"]

    def restore_sharded(self, mesh, shardings_tree, step: Optional[int] = None, c: int = 4,
                        example_tree=None):
        """Elastic restore: ``restore``, then each leaf placed on ``mesh``
        by its placements in ``shardings_tree`` (the values tree's layout,
        a list of placements, one a mesh dimension, at each leaf; e.g.
        ``Sharder.tree_shardings``).  Each rank keeps only its own chunk
        (``DTensor.from_local``): nothing is broadcast, and the mesh may
        have another size than the writer's."""
        tree, got_step = self.restore(step, c=c, example_tree=example_tree)
        leaves, treedef = tree_flatten(tree)
        placements = _placement_leaves(shardings_tree)
        if len(placements) != len(leaves):
            raise ValueError(f"{len(placements)} placements for {len(leaves)} leaves")
        return tree_unflatten(treedef, [place(v, mesh, p)
                                        for v, p in zip(leaves, placements)]), got_step

    def storage_cost(self) -> Dict[str, int]:
        return {
            "bytes_written": self.store.stats.bytes_written,
            "n_saves": len(self.saves),
        }
