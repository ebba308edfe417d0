"""Elastic coordinator: failure detection, straggler mitigation, re-mesh.

Controller-side logic for a 1000+-node deployment, exercised here against
simulated workers (tests/test_fault_tolerance.py).  The data-plane pieces
it drives — TGI checkpoint restore-with-reshard, deterministic data
pipeline seek — are the real implementations.

Policies:
* failure: no heartbeat for ``heartbeat_timeout`` -> host dead; pick the
  largest (data_axis') <= data_axis with dead hosts removed, restore the
  latest checkpoint onto the shrunk mesh, seek the pipeline to the
  restored step (no sample loss/duplication — the pipeline is seeded by
  (step, shard)).
* stragglers: a host whose rolling median step time exceeds
  ``straggler_factor`` x the cluster median is quarantined at the next
  re-mesh boundary (TPU SPMD steps are synchronous — one slow host IS a
  slow step, so quarantine, don't re-balance).
* elastic growth: joined hosts are folded in at the next boundary the
  same way (restore onto the larger mesh).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Set, Tuple


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    step_times: deque  # rolling window
    quarantined: bool = False


class Coordinator:
    def __init__(self, n_hosts: int, chips_per_host: int = 4,
                 heartbeat_timeout: float = 60.0, straggler_factor: float = 2.0,
                 window: int = 16, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.chips_per_host = chips_per_host
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(self.clock(), deque(maxlen=window)) for i in range(n_hosts)
        }
        self.generation = 0  # bumped on every re-mesh
        self.log: List[Dict] = []

    # ---- data plane callbacks ----
    def heartbeat(self, host: int, step_time: Optional[float] = None):
        w = self.workers[host]
        w.last_heartbeat = self.clock()
        if step_time is not None:
            w.step_times.append(step_time)

    def join(self, host: int):
        self.workers[host] = WorkerState(self.clock(), deque(maxlen=16))
        self.log.append({"event": "join", "host": host, "gen": self.generation})

    # ---- policies ----
    def dead_hosts(self) -> Set[int]:
        now = self.clock()
        return {
            h for h, w in self.workers.items()
            if now - w.last_heartbeat > self.heartbeat_timeout
        }

    def stragglers(self) -> Set[int]:
        med = self._cluster_median()
        if med is None:
            return set()
        out = set()
        for h, w in self.workers.items():
            if len(w.step_times) >= w.step_times.maxlen // 2:
                wm = sorted(w.step_times)[len(w.step_times) // 2]
                if wm > self.straggler_factor * med:
                    out.add(h)
        return out

    def _cluster_median(self) -> Optional[float]:
        all_t = [t for w in self.workers.values() for t in w.step_times]
        if not all_t:
            return None
        return sorted(all_t)[len(all_t) // 2]

    def healthy_hosts(self) -> List[int]:
        dead = self.dead_hosts()
        return sorted(
            h for h, w in self.workers.items()
            if h not in dead and not w.quarantined
        )

    def plan(self, data_axis: int, model_axis: int) -> Optional[Dict]:
        """Returns a re-mesh plan if the healthy set changed, else None.

        The model axis is preserved (weights shard over it); the data axis
        shrinks/grows to the largest power-of-two host count available —
        checkpoint restore re-shards, the pipeline re-seeks.
        """
        dead = self.dead_hosts()
        strag = self.stragglers()
        for h in strag:
            self.workers[h].quarantined = True
        healthy = self.healthy_hosts()
        chips = len(healthy) * self.chips_per_host
        need = data_axis * model_axis
        if not dead and not strag and chips >= need:
            return None
        # largest data' (power of two) fitting the healthy chips
        data2 = data_axis
        while data2 > 1 and data2 * model_axis > chips:
            data2 //= 2
        self.generation += 1
        plan = {
            "gen": self.generation,
            "dead": sorted(dead),
            "quarantined": sorted(strag),
            "hosts": healthy[: (data2 * model_axis) // self.chips_per_host],
            "mesh": (data2, model_axis),
            "action": "restore_from_checkpoint_and_reseek",
        }
        self.log.append(plan)
        return plan


def pipeline_seek(step: int, global_batch: int, n_shards: int):
    """Deterministic pipeline position after restore: each shard's RNG is
    seeded by (step, shard), so resuming at `step` replays no sample and
    skips none (see repro.data.pipeline)."""
    return {"step": step, "shard_seeds": [(step, s) for s in range(n_shards)]}
