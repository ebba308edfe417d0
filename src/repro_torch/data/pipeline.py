"""Deterministic, shardable input pipeline.

Every batch is a pure function of (step, shard) — the property the
elastic coordinator relies on: restore at step s and the stream continues
with neither duplicated nor dropped samples, on any shard count.

Sources:
* ``SyntheticLM`` — seeded token streams (throughput/correctness work);
* ``GraphWalkLM`` — random walks over TGI snapshots at a step-dependent
  timepoint, tokenized as node ids: the graph plane feeding the LM plane
  (temporal graphs as a corpus — quickstart example 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    n_shards: int = 1
    prefetch: int = 2


class SyntheticLM:
    def __init__(self, cfg: PipelineConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def shard_batch(self, step: int, shard: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per = cfg.global_batch // cfg.n_shards
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + shard) % (2**31)
        )
        toks = rng.randint(0, cfg.vocab_size, size=(per, cfg.seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        parts = [self.shard_batch(step, s) for s in range(self.cfg.n_shards)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class GraphWalkLM:
    """Random walks on historical snapshots: the walk's timepoint advances
    with the training step, so the model sees the graph's evolution."""

    def __init__(self, cfg: PipelineConfig, tgi, seed: int = 0, n_times: int = 8):
        self.cfg = cfg
        self.tgi = tgi
        self.seed = seed
        t0, t1 = tgi._events.time_range()
        self.times = np.linspace(t0, t1, n_times).astype(np.int64)
        self._cache: Dict[int, tuple] = {}

    def _adj_at(self, t: int):
        if t not in self._cache:
            g = self.tgi.get_snapshot(int(t))
            src, dst, _ = g.edges()
            both_s = np.concatenate([src, dst])
            both_d = np.concatenate([dst, src])
            order = np.argsort(both_s, kind="stable")
            bs, bd = both_s[order], both_d[order]
            nodes = g.node_ids()
            indptr = np.searchsorted(bs, np.arange(len(g.present) + 1))
            self._cache[t] = (nodes, indptr, bd)
        return self._cache[t]

    def shard_batch(self, step: int, shard: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per = cfg.global_batch // cfg.n_shards
        rng = np.random.RandomState(
            (self.seed * 7_368_787 + step * 131 + shard) % (2**31)
        )
        L = cfg.seq_len + 1
        out = np.zeros((per, L), np.int32)
        for b in range(per):
            # fixed per-slot timepoint mixture: every batch sees the same
            # blend of graph epochs (stationary distribution for training)
            t = int(self.times[(b + shard * per) % len(self.times)])
            nodes, indptr, nbrs = self._adj_at(t)
            cur = int(nodes[rng.randint(len(nodes))]) if len(nodes) else 0
            for j in range(L):
                out[b, j] = cur % cfg.vocab_size
                lo, hi = indptr[cur], indptr[cur + 1]
                if hi > lo:
                    cur = int(nbrs[lo + rng.randint(hi - lo)])
                elif len(nodes):
                    cur = int(nodes[rng.randint(len(nodes))])  # restart
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        parts = [self.shard_batch(step, s) for s in range(self.cfg.n_shards)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
