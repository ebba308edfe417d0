"""Standalone multi-writer stress client: one SIGKILL-able writer
process for the ``multiwriter`` chaos bench and stress suite.

Connects a ``RemoteDeltaStore`` to a running cluster, acquires its own
writer lease, and hammers a shared keyspace with seeded-deterministic
PUTs (and occasional DELETEs).  Every *acked* operation is appended to
``--out`` and flushed BEFORE the next one starts, so when the harness
SIGKILLs this process mid-storm the log is exactly the set of writes
the cluster acknowledged — the "zero acked writes lost" oracle.  Lines:

    PUT <tsid> <sid> <pid> <did> <epoch> <seq> <token>
    DEL <tsid> <sid> <pid> <did> <epoch> <seq> -

``token`` seeds the payload (``payload_arrays(token)``), so a verifier
can reconstruct the winning value per key (max ``(epoch, seq)`` across
every writer's log) and compare it byte-for-byte against what the
cluster serves.  Payloads are pure functions of the token — no clocks,
no process state — so the oracle is reproducible across runs.

Exit code 0 after ``--n-writes`` acked operations; 3 if the write
plane degraded (``WriteUnavailable``) past the retry budget.  A torn
last line (SIGKILL between write and flush) is the reader's problem —
``read_acked_log`` drops it.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.service import wire  # noqa: F401  (re-exported for callers)
from repro_torch.service.client import RemoteDeltaStore
from repro_torch.storage.kvstore import (DeltaKey, DeltaStore, StorageNodeDown,
                                   WriteUnavailable, make_vseq)

_DELETE_EVERY = 10  # every 10th op (per writer stream) is a delete


def key_for(slot: int) -> DeltaKey:
    """The shared keyspace: slot -> key, spread over two placements so
    every cell in a small cluster owns traffic."""
    return DeltaKey(tsid=7, sid=slot % 2, did=f"E:{slot}", pid=slot)


def payload_arrays(token: int) -> Dict[str, np.ndarray]:
    """Deterministic payload for one token: seeded arrays, so the blob
    a verifier re-encodes for token T is byte-identical to what the
    writer sent."""
    rng = np.random.default_rng(token)
    n = 16 + token % 17
    return {"src": rng.integers(0, 1 << 20, size=n).astype(np.int64),
            "dst": rng.integers(0, 1 << 20, size=n).astype(np.int64),
            "t": np.arange(token, token + n, dtype=np.int64)}


def encode_token(key: DeltaKey, token: int,
                 fmt: Optional[str] = None) -> Tuple[bytes, int]:
    """(blob, raw_bytes) for one token — the exact bytes a writer fans
    out, reusable by the oracle."""
    enc = DeltaStore(m=1, r=1, backend="mem", fmt=fmt, pool_bytes=0)
    return enc.encode_payload(key, payload_arrays(token))


def read_acked_log(path: Path) -> List[Tuple[str, DeltaKey, int, int]]:
    """Parse one writer's acked log into ``(op, key, vseq, token)``
    rows, dropping a torn (SIGKILLed mid-write) last line."""
    rows: List[Tuple[str, DeltaKey, int, int]] = []
    if not path.exists():
        return rows
    for line in path.read_text().splitlines():
        parts = line.split()
        if len(parts) != 8 or parts[0] not in ("PUT", "DEL"):
            continue  # torn tail or noise: not an acked write
        try:
            op = parts[0]
            key = DeltaKey(int(parts[1]), int(parts[2]), parts[4],
                           int(parts[3]))
            epoch, seq = int(parts[5]), int(parts[6])
            token = 0 if parts[7] == "-" else int(parts[7])
        except ValueError:
            continue
        rows.append((op, key, make_vseq(epoch, seq), token))
    return rows


def run_writer(addrs: List[Tuple[str, int]], r: int, n_writes: int,
               keyspace: int, seed: int, out: Path,
               lease_ttl: float = 1.0, timeout: float = 5.0,
               auth_key: Optional[str] = None,
               fmt: Optional[str] = None) -> int:
    rng = np.random.default_rng(seed)
    store = RemoteDeltaStore(addrs, r=r, fmt=fmt, pool_bytes=0,
                             timeout=timeout, lease_ttl=lease_ttl,
                             auth_key=auth_key,
                             writer_id=f"stress-{seed}")
    degraded_budget = 50
    done = 0
    with open(out, "a") as log:
        while done < n_writes:
            slot = int(rng.integers(0, keyspace))
            token = seed * 1_000_003 + done  # unique per (writer, op)
            key = key_for(slot)
            delete = done % _DELETE_EVERY == (_DELETE_EVERY - 1)
            try:
                if delete:
                    store.delete(key)
                else:
                    blob, raw = encode_token(key, token, fmt)
                    store.put_encoded(key, blob, raw)
            except (WriteUnavailable, StorageNodeDown):
                degraded_budget -= 1
                if degraded_budget <= 0:
                    store.close()
                    return 3
                time.sleep(lease_ttl / 4)
                continue
            st = store.lease_status()
            log.write(f"{'DEL' if delete else 'PUT'} {key.tsid} {key.sid} "
                      f"{key.pid} {key.did} {st['epoch']} {st['seq']} "
                      f"{'-' if delete else token}\n")
            log.flush()  # acked -> durable in the oracle BEFORE next op
            done += 1
    store.quiesce()
    store.close()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="One lease-fenced stress writer (SIGKILL-able).")
    ap.add_argument("--addrs", required=True,
                    help="comma-separated host:port cells")
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--n-writes", type=int, default=200)
    ap.add_argument("--keyspace", type=int, default=32)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True, help="acked-ops log path")
    ap.add_argument("--lease-ttl", type=float, default=1.0)
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--auth-key", default=None)
    ap.add_argument("--fmt", default=None)
    args = ap.parse_args(argv)
    addrs = []
    for part in args.addrs.split(","):
        host, port = part.strip().rsplit(":", 1)
        addrs.append((host, int(port)))
    print(f"WRITER READY seed={args.seed}", flush=True)
    return run_writer(addrs, args.r, args.n_writes, args.keyspace,
                      args.seed, Path(args.out), lease_ttl=args.lease_ttl,
                      timeout=args.timeout, auth_key=args.auth_key,
                      fmt=args.fmt)


if __name__ == "__main__":
    sys.exit(main())
