"""Local service-plane cluster: N storage cells x r replication.

The launch harness for tests, benches, and docs.  Two modes:

* ``mode="subprocess"`` — each cell is a real OS process (``python -m
  repro_torch.service.cell``), so kills are real crashes (SIGKILL: no
  goodbye, no flush) and restart exercises feed catch-up across
  process boundaries.  This is what the ``service`` bench and the
  chaos tests run.
* ``mode="thread"`` — cells run in-process on daemon threads: same
  wire protocol over loopback sockets, ~instant startup.  This is what
  the docs quickstart runs.

Cells keep their port across restarts (``SO_REUSEADDR``), so a
client's address table stays valid through a kill/restart cycle.  A
restarted cell is handed every other live cell as a catch-up peer; its
``feed_since`` pull filters to the keys whose replica chain includes
it (see ``StorageCell.catch_up``).
"""
from __future__ import annotations

import dataclasses
import os
import select
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.service.cell import StorageCell
from repro_torch.service.client import RemoteDeltaStore

CELL_MODULE = "repro_torch.service.cell"  # what a subprocess cell runs


@dataclasses.dataclass
class ClusterSpec:
    n_cells: int = 3
    r: int = 2
    backend: str = "file"
    root: Optional[str] = None  # required for the file backend
    fmt: Optional[str] = None
    host: str = "127.0.0.1"
    # per-node environment overrides for subprocess cells (e.g. arm a
    # fault point in ONE cell: {1: {"REPRO_FAULTPOINTS": "cell.apply=
    # 5:kill"}}); merged over the inherited environment at spawn AND
    # respawn, so a restarted cell comes back with the same overrides
    cell_env: Optional[Dict[int, Dict[str, str]]] = None
    # cell serving knobs (see StorageCell): request-executor pool size,
    # per-connection in-flight cap, and the feed-records threshold that
    # arms ack-watermark truncation
    workers: int = 4
    inflight_cap: int = 32
    feed_keep: int = 256
    # writer-lease TTL (cells sweep expired lanes at ttl/2; clients
    # renew at ttl/3) and the optional shared wire-auth secret — both
    # flow to every cell AND to client() so the cluster stays coherent
    lease_ttl: float = 2.0
    auth_key: Optional[str] = None

    def cell_root(self, node: int) -> Optional[str]:
        if self.backend == "mem":
            return None
        return str(Path(self.root) / f"cell{node}")


class LocalCluster:
    def __init__(self, spec: ClusterSpec, mode: str = "subprocess"):
        assert mode in ("subprocess", "thread")
        assert spec.backend == "mem" or spec.root is not None
        self.spec = spec
        self.mode = mode
        self.ports: List[int] = [0] * spec.n_cells
        self._procs: List[Optional[subprocess.Popen]] = [None] * spec.n_cells
        self._cells: List[Optional[StorageCell]] = [None] * spec.n_cells

    # ---- lifecycle ----
    def start(self) -> "LocalCluster":
        for i in range(self.spec.n_cells):
            self._spawn(i, peers=[])
        return self

    def stop(self) -> None:
        for i in range(self.spec.n_cells):
            self._down(i, hard=False)

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def addrs(self) -> List[Tuple[str, int]]:
        return [(self.spec.host, p) for p in self.ports]

    def client(self, **kw) -> RemoteDeltaStore:
        kw.setdefault("r", self.spec.r)
        kw.setdefault("fmt", self.spec.fmt)
        kw.setdefault("lease_ttl", self.spec.lease_ttl)
        kw.setdefault("auth_key", self.spec.auth_key)
        return RemoteDeltaStore(self.addrs, **kw)

    def kill(self, node: int) -> None:
        """Crash one cell (subprocess mode: SIGKILL — no flush, no
        goodbye; thread mode: sockets closed)."""
        self._down(node, hard=True)

    def restart(self, node: int) -> None:
        """Bring a killed cell back on its old port, with every other
        live cell as a catch-up peer."""
        peers = [(self.spec.host, p) for i, p in enumerate(self.ports)
                 if i != node and self._alive(i)]
        self._spawn(node, peers=peers, port=self.ports[node])

    def wipe(self, node: int) -> None:
        """Erase a (downed) cell's on-disk state — feed, checkpoint,
        chunks — simulating a disk loss.  On restart the fresh cell
        must bootstrap via full-state transfer from its peers."""
        assert not self._alive(node), "wipe requires the cell to be down"
        root = self.spec.cell_root(node)
        if root is None:
            return
        import shutil
        shutil.rmtree(root, ignore_errors=True)

    def _alive(self, node: int) -> bool:
        if self.mode == "thread":
            return self._cells[node] is not None
        p = self._procs[node]
        return p is not None and p.poll() is None

    # ---- internals ----
    def _down(self, node: int, hard: bool) -> None:
        if self.mode == "thread":
            cell = self._cells[node]
            if cell is not None:
                cell.stop()
                self._cells[node] = None
            return
        proc = self._procs[node]
        if proc is None or proc.poll() is not None:
            self._procs[node] = None
            return
        if hard:
            proc.kill()
        else:
            proc.terminate()
        proc.wait(timeout=10)
        self._procs[node] = None

    def _spawn(self, node: int, peers: List[Tuple[str, int]],
               port: int = 0) -> None:
        spec = self.spec
        if self.mode == "thread":
            cell = StorageCell(node_id=node, n_cells=spec.n_cells, r=spec.r,
                               backend=spec.backend,
                               root=spec.cell_root(node), fmt=spec.fmt,
                               host=spec.host, port=port,
                               workers=spec.workers,
                               inflight_cap=spec.inflight_cap,
                               feed_keep=spec.feed_keep,
                               lease_ttl=spec.lease_ttl,
                               auth_key=spec.auth_key)
            self.ports[node] = cell.start(peers=peers)
            self._cells[node] = cell
            return
        import repro_torch  # a regular package: its src/ is two levels up
        src = str(Path(repro_torch.__file__).parents[1])
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p])
        if spec.cell_env and node in spec.cell_env:
            env.update(spec.cell_env[node])
        cmd = [sys.executable, "-m", CELL_MODULE,
               "--node-id", str(node), "--n-cells", str(spec.n_cells),
               "--replication", str(spec.r), "--backend", spec.backend,
               "--host", spec.host, "--port", str(port),
               "--workers", str(spec.workers),
               "--inflight-cap", str(spec.inflight_cap),
               "--feed-keep", str(spec.feed_keep),
               "--lease-ttl", str(spec.lease_ttl)]
        if spec.auth_key:
            cmd += ["--auth-key", spec.auth_key]
        if spec.backend == "file":
            cmd += ["--root", spec.cell_root(node)]
        if spec.fmt:
            cmd += ["--fmt", spec.fmt]
        if peers:
            cmd += ["--peers", ",".join(f"{h}:{p}" for h, p in peers)]
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        self._procs[node] = proc
        self.ports[node] = self._wait_ready(proc, node)

    @staticmethod
    def _wait_ready(proc: subprocess.Popen, node: int,
                    timeout: float = 30.0) -> int:
        """Parse the cell's ``CELL READY node=<i> port=<p>`` line —
        printed only after boot catch-up completed and the listen
        socket is bound."""
        deadline = time.monotonic() + timeout
        line = ""
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"cell {node} exited rc={proc.returncode} before READY")
            rd, _, _ = select.select([proc.stdout], [], [], 0.25)
            if not rd:
                continue
            line = proc.stdout.readline()
            if line.startswith("CELL READY"):
                return int(line.strip().rsplit("port=", 1)[1])
        raise TimeoutError(f"cell {node} not READY within {timeout}s "
                           f"(last line: {line!r})")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(
        description="Launch a local temporal-graph storage cluster.")
    ap.add_argument("--cells", type=int, default=3)
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--backend", default="file", choices=("mem", "file"))
    ap.add_argument("--root", default=None)
    ap.add_argument("--mode", default="subprocess",
                    choices=("subprocess", "thread"))
    args = ap.parse_args(argv)
    root = args.root or (tempfile.mkdtemp(prefix="tg-cluster-")
                         if args.backend == "file" else None)
    spec = ClusterSpec(n_cells=args.cells, r=args.replication,
                       backend=args.backend, root=root)
    cluster = LocalCluster(spec, mode=args.mode).start()
    print(f"cluster up: {args.cells} cells x r={args.replication} "
          f"({args.backend}) root={root}")
    for i, (host, port) in enumerate(cluster.addrs):
        print(f"  cell {i}: {host}:{port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
