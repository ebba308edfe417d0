"""StorageCell: one storage node served over the wire protocol.

A cell owns one node's chunk/extent files through a private
single-node ``DeltaStore`` (m=1, r=1, no decoded-block pool — decoding
is the *client's* job; the cell ships encoded columns verbatim via
``get_encoded``/``assemble_block``, so a projected GET costs the cell
only the projected columns' file bytes).

Writes are change-feed records: every ``put``/``delete`` is stamped
with a *vseq* — the writer's fencing **epoch** and its lane-local
**seq** packed into one u64 (``kvstore.make_vseq``) — and fanned out
to the key's replica cells.  Each cell appends applied records to an
append-only ``feed.log`` (and an in-memory tail) — the cell's write
history in arrival order.  One epoch is one writer incarnation's
*lane*: seqs are monotone within a lane, and the u64 vseq order is the
cluster-wide (epoch, seq) total order, so N concurrent writers merge
deterministically — every per-key conflict resolves to the max vseq
whatever the arrival order, and a canonical vacuum pass
(``MAINT_CANON``) orders each chunk's live records by record key,
making the on-disk bytes a pure function of the applied record *set*.
Duplicate deliveries (client retries, catch-up racing a live write)
are dropped by vseq: every applied vseq — including those replayed
from ``feed.log`` at boot — lives in an applied set, so catch-up can
refetch the peer feed and repair interior gaps, not just the tail.  A
per-key max-vseq guard keeps an out-of-order repair from regressing a
key past a newer applied write.

**Writer leases and fencing.**  A writer attaches by acquiring a
time-bounded lease (``MSG_LEASE`` acquire, granted iff the proposed
epoch exceeds every epoch this cell has seen — monotonic fencing;
the *client* requires a cell quorum of grants).  Every accepted write
in lane ``e`` refreshes lane ``e``'s lease — the heartbeat is
piggybacked on the write path, so a busy writer never expires.  When a
lease expires un-renewed (hard-killed writer), the cell's lease
sweeper runs **orphan-seq reconciliation**: it queries every peer for
the lane's high-water mark (aborting if any peer still sees a live
lease, or any cell is unreachable — sealing is only safe when every
replica can be brought to the same record set), anti-entropies its own
gaps via a normal feed pull, then *seals* the lane at the max
replica-acked record and broadcasts the seal (``MSG_RECONCILE``).  A
sealed lane is the fence: a wire write into lane ``e`` above its seal
is rejected with the typed ``LEASE_FENCED`` error — never silently
applied — while writes at or below the seal remain accepted (they are
duplicates or gap fills, deduped as always).  Internal applies
(catch-up, boot replay) bypass the fence and merge the seal upward, so
an acked record that outlived every live replica still converges when
its holder restarts.

**Feed compaction (per-lane ack coverage).**  The feed no longer grows
without bound: each writer piggybacks its lane's *ack watermark* on
PUT/DELETE/PING bodies — the highest lane seq it can prove every
owning cell has applied.  A lane's *coverage* is that watermark or, for
a sealed lane, the seal point — which is exactly what un-strands the
floor after a writer dies with queued redeliveries: reconciliation
seals the lane, coverage jumps to the seal, truncation resumes.  Once
at least ``feed_keep`` in-memory records sit at or below their lane's
coverage (or a forced MAINT pass asks), the cell checkpoints: it
writes ``feed.base`` (per-lane floor/ack/seal maps + per-key
size/vseq accounting, sorted for byte determinism), rewrites
``feed.log`` with only the uncovered records in vseq order, and drops
the truncated vseqs from the applied set — ``seq <= floor[lane]``
itself now certifies "applied".  The base is written *before* the log
is rewritten, so a crash between the two leaves stale records the boot
path skips by floor.  A *fresh* cell (wiped disk) facing a truncated
peer bootstraps by full-state transfer — ``MSG_PLACEMENTS`` +
``MSG_STATE_PULL`` copy a live replica's chunk and extent files
verbatim plus the per-key accounting, then a normal feed pull stamps
the records above the floors.  A fresh *mem* cell cannot be rebuilt
this way and fails with the typed ``FeedTruncated``.

**Opt-in shared-secret auth.**  A cell started with ``auth_key``
answers HELLO with an ``MSG_AUTH`` challenge (random nonce); the
client must reply with ``HMAC-SHA256(key, nonce)`` before any other
frame is served — wrong or missing gets the typed ``AUTH_FAILED`` and
a closed connection.  Cell-to-cell traffic (catch-up, reconciliation)
performs the same handshake.

**Pipelined serving.**  The per-connection read loop no longer
executes requests inline: frames are dispatched to a small cell-wide
worker pool (``workers``) under a per-connection in-flight cap
(``inflight_cap``, enforced by semaphore — a flooding client blocks in
its own read loop, which is TCP backpressure, not memory growth), and
replies are written under a per-connection send lock in completion
order — the ``req_id`` is the demux key, not arrival order.  HELLO and
PING are answered *inline on the read loop*, so a slow GET can never
head-of-line-block a health probe even with every worker busy.
MULTIGET replies stream one ``MSG_CHUNK`` frame per found key followed
by ``MSG_END``, so the client decodes early keys while the cell is
still reading later ones.

Run one cell per process via ``python -m repro.service.cell`` (prints
``CELL READY node=<i> port=<p>`` for the cluster harness) or
in-process via ``LocalCluster(mode="thread")``.
"""
from __future__ import annotations

import argparse
import hashlib
import hmac
import json
import os
import signal
import socket
import struct
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core import faultpoints
from repro_torch.service import wire
from repro_torch.storage.kvstore import (DeltaStore, KeyMissing, make_vseq,
                                   replica_nodes, split_vseq)

_BASE_MAGIC = b"TGB3"  # feed.base format tag (v3: per-lane maps)


class FeedTruncated(wire.WireError):
    """Needed feed history predates a peer's truncation floor and no
    full-state transfer can cover it (mem backend, or no file-backed
    replica reachable)."""


class StorageCell:
    def __init__(self, node_id: int, n_cells: int, r: int,
                 backend: str = "file", root: Optional[str] = None,
                 fmt: Optional[str] = None, host: str = "127.0.0.1",
                 port: int = 0, workers: int = 4, inflight_cap: int = 32,
                 feed_keep: int = 256, lease_ttl: float = 2.0,
                 auth_key: Optional[str] = None):
        assert backend in ("mem", "file")
        self.node_id = node_id
        self.n_cells = n_cells
        self.r = r
        self.host = host
        self.port = port  # 0 -> ephemeral; real port known after start()
        self.workers = max(1, workers)
        self.inflight_cap = max(1, inflight_cap)
        self.feed_keep = max(1, feed_keep)
        self.lease_ttl = max(0.05, lease_ttl)
        self.auth_key = auth_key.encode() if auth_key else None
        self.root = Path(root) if root is not None else None
        if backend == "file":
            assert root is not None
            self.root.mkdir(parents=True, exist_ok=True)
        self.store = DeltaStore(m=1, r=1, backend=backend, root=root,
                                fmt=fmt, pool_bytes=0, seek=True)
        # change feed: in-memory tail above the truncation floors plus an
        # append-only feed.log (file backend).  _flock serializes
        # apply+append so the log can never disagree with the store.
        self._feed: List[wire.FeedRecord] = []
        self._flock = threading.Lock()
        # every vseq this cell has applied ABOVE its lane's floor
        # (rebuilt from feed.log at boot) — together with ``seq <=
        # floor[lane]`` this is the dedupe that lets catch-up refetch
        # the peer feed and repair interior gaps without double-applying
        self._applied: set = set()
        # per-key max applied vseq: an out-of-order gap repair must
        # never regress a key past a newer applied write
        self._key_seq: Dict[Tuple, int] = {}
        self.last_seq = 0  # max vseq seen (any lane)
        # per-lane write-plane state, all keyed by epoch:
        self._floors: Dict[int, int] = {}    # truncated up to (per lane)
        self._lane_ack: Dict[int, int] = {}  # writer-proven replica ack
        self._sealed: Dict[int, int] = {}    # fenced lanes: seal point
        self._lane_seq: Dict[int, int] = {}  # local lane high-water mark
        # epoch -> [writer_id|None, monotonic deadline]; None writer_id
        # is a wildcard installed by a write whose acquire this cell
        # missed (it was down) — adopted by the first renew/acquire
        self.leases: Dict[int, list] = {}
        self.max_epoch = 0  # highest epoch ever seen (monotonic fence)
        self.known_peers: List[Tuple[str, int]] = []
        self.truncations = 0  # completed feed truncation passes
        self.lease_grants = 0
        self.fenced_writes = 0  # wire writes refused with LEASE_FENCED
        self.reconciles = 0  # lanes this cell sealed (swept or told)
        self._load_feed()
        self._lsock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self._pool: Optional[ThreadPoolExecutor] = None
        # background store maintenance (chunk vacuum): one pass at a
        # time, triggered by MSG_MAINT; the cell keeps serving while it
        # runs (vacuum holds the store lock per chunk only)
        self._maint_lock = threading.Lock()
        self._maint_thread: Optional[threading.Thread] = None
        self.last_vacuum: Optional[Dict] = None

    # ---- lane bookkeeping (caller holds _flock unless noted) ----
    def _note_epoch(self, epoch: int) -> None:
        if epoch > self.max_epoch:
            self.max_epoch = epoch

    def _coverage(self, epoch: int) -> int:
        """Highest lane seq proven replica-complete: the writer's acked
        watermark while the lane is live, the seal once it is fenced."""
        cov = self._lane_ack.get(epoch, 0)
        if epoch in self._sealed:
            cov = max(cov, self._sealed[epoch])
        return max(cov, self._floors.get(epoch, 0))

    def _lanes_known(self) -> set:
        return (set(self._floors) | set(self._lane_ack) | set(self._sealed)
                | set(self._lane_seq))

    # ---- feed persistence ----
    def _feed_path(self) -> Optional[Path]:
        return None if self.root is None else self.root / "feed.log"

    def _base_path(self) -> Optional[Path]:
        return None if self.root is None else self.root / "feed.base"

    def _load_base(self) -> None:
        """Load the truncation checkpoint (per-lane floor/ack/seal maps
        + per-key accounting) if one exists.  Everything at or below a
        lane's floor is certified applied; ``feed.log`` replay then
        layers the surviving tail on top."""
        path = self._base_path()
        if path is None or not path.exists():
            return
        buf = path.read_bytes()
        if not buf.startswith(_BASE_MAGIC):
            return  # older or torn checkpoint: rebuild from the log
        try:
            off = len(_BASE_MAGIC)
            floors, off = wire.unpack_lanes(buf, off)
            acks, off = wire.unpack_lanes(buf, off)
            seals, off = wire.unpack_lanes(buf, off)
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            sizes = []
            for _ in range(n):
                key, off = wire.unpack_key(buf, off)
                raw, enc = struct.unpack_from("<QQ", buf, off)
                off += 16
                sizes.append((key, raw, enc))
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            seqs = []
            for _ in range(n):
                key, off = wire.unpack_key(buf, off)
                (seq,) = struct.unpack_from("<Q", buf, off)
                off += 8
                seqs.append((key, seq))
        except (wire.WireError, struct.error, IndexError, UnicodeDecodeError):
            return  # torn checkpoint: fall back to whatever the log holds
        self._floors = floors
        self._lane_ack = acks
        self._sealed = seals
        for e, s in floors.items():
            self._note_epoch(e)
            self._lane_seq[e] = max(self._lane_seq.get(e, 0), s)
            self.last_seq = max(self.last_seq, make_vseq(e, s))
        for e in list(acks) + list(seals):
            self._note_epoch(e)
        for key, raw, enc in sizes:
            self.store.key_sizes[key] = (raw, enc)
        for key, seq in seqs:
            self._key_seq[key] = seq
            self.last_seq = max(self.last_seq, seq)
            e, s = split_vseq(seq)
            self._note_epoch(e)
            self._lane_seq[e] = max(self._lane_seq.get(e, 0), s)

    def _save_base_locked(self) -> None:
        """Checkpoint the current accounting under the current floors.
        Lane maps and keys are emitted in sorted order so the file bytes
        are a pure function of the state (the byte-identity property
        extends to the checkpoint).  Written tmp-then-rename, and always
        BEFORE the log rewrite, so a crash between the two only leaves
        stale log records the boot path drops by floor."""
        path = self._base_path()
        if path is None:
            return
        # a seal supersedes any ack water below it, so persist the ack
        # map normalized against the seals — a cell that missed some
        # piggybacked acks while dead still checkpoints the same bytes
        # as one that saw them all
        acks = dict(self._lane_ack)
        for e, seal in self._sealed.items():
            acks[e] = max(acks.get(e, 0), seal)
        out = [_BASE_MAGIC, wire.pack_lanes(self._floors),
               wire.pack_lanes(acks),
               wire.pack_lanes(self._sealed),
               struct.pack("<I", len(self.store.key_sizes))]
        for key in sorted(self.store.key_sizes,
                          key=lambda k: (k.tsid, k.sid, k.pid, k.did)):
            raw, enc = self.store.key_sizes[key]
            out.append(wire.pack_key(key) + struct.pack("<QQ", raw, enc))
        out.append(struct.pack("<I", len(self._key_seq)))
        for key in sorted(self._key_seq,
                          key=lambda k: (k.tsid, k.sid, k.pid, k.did)):
            out.append(wire.pack_key(key)
                       + struct.pack("<Q", self._key_seq[key]))
        tmp = path.with_suffix(".base.tmp")
        tmp.write_bytes(b"".join(out))
        os.replace(tmp, path)

    def _load_feed(self) -> None:
        """Boot: rebuild ``last_seq``, the applied-vseq set, the per-key
        vseq watermarks, the lane maps, and the store's size accounting
        from ``feed.base`` + ``feed.log``.  The chunk/extent files
        already hold the data (the store's file backend persists), so
        records are NOT re-applied — only the bookkeeping is replayed.

        The feed append in ``apply`` is not atomic and cells are killed
        with SIGKILL, so a torn last record is an expected crash
        artifact: any record that fails to decode is treated as the torn
        tail — the log is truncated back to the last whole record and
        catch-up refetches whatever the lost suffix held."""
        self._load_base()
        path = self._feed_path()
        if path is None or not path.exists():
            return
        data = path.read_bytes()
        off = 0
        good = 0  # byte offset of the last cleanly decoded record's end
        while off < len(data):
            try:
                rec, off = wire.FeedRecord.unpack(data, off)
            except (wire.WireError, struct.error, IndexError,
                    UnicodeDecodeError):
                with open(path, "r+b") as f:  # torn tail: drop it
                    f.truncate(good)
                break
            good = off
            e, s = split_vseq(rec.seq)
            if s <= self._floors.get(e, 0):
                # checkpoint written but crash hit before the log
                # rewrite: the record is already certified by the floor
                continue
            self._feed.append(rec)
            self._applied.add(rec.seq)
            self.last_seq = max(self.last_seq, rec.seq)
            self._note_epoch(e)
            self._lane_seq[e] = max(self._lane_seq.get(e, 0), s)
            if rec.seq > self._key_seq.get(rec.key, 0):
                self._key_seq[rec.key] = rec.seq
                if rec.op == wire.OP_PUT:
                    self.store.key_sizes[rec.key] = (rec.raw_bytes,
                                                     len(rec.blob))
                else:
                    self.store.key_sizes.pop(rec.key, None)

    def _owns(self, key) -> bool:
        return self.node_id in replica_nodes(key.tsid, key.sid,
                                             self.n_cells, self.r)

    # ---- write path ----
    def fence_check(self, vseq: int, writer_id: Optional[str] = None) -> None:
        """The wire-write gate: reject a write into a sealed lane above
        its seal point with the typed ``LeaseFenced`` (writes at or
        below the seal are duplicates or gap fills — ``apply`` dedupes
        them as always).  An accepted non-legacy write refreshes (or,
        for a cell that missed the acquire, installs) its lane's lease:
        the write IS the heartbeat.  Internal applies — catch-up, boot
        replay, reconciliation anti-entropy — never call this."""
        e, s = split_vseq(vseq)
        if e == 0:
            return  # legacy unleased lane: single-writer compatibility
        with self._flock:
            seal = self._sealed.get(e)
            if seal is not None and s > seal:
                self.fenced_writes += 1
                raise wire.LeaseFenced(
                    f"lane {e} sealed at {seal}, write seq {s} refused "
                    f"(stale writer: re-acquire a fresh epoch)")
            self._note_epoch(e)
            lease = self.leases.get(e)
            deadline = time.monotonic() + self.lease_ttl
            if lease is None:
                self.leases[e] = [writer_id, deadline]
            else:
                if lease[0] is None and writer_id is not None:
                    lease[0] = writer_id
                lease[1] = deadline

    def apply(self, rec: wire.FeedRecord) -> Tuple[bool, bool]:
        """Apply one feed record (a wire PUT/DELETE, a catch-up replay,
        or a client gap redelivery); returns ``(applied, existed)``.
        Duplicates — client retries after a lost ack, catch-up
        overlapping a live write — are detected against the applied-vseq
        set plus the per-lane truncation floor (both survive restarts
        via ``feed.base``/``feed.log``) and acked without touching the
        store, so a record can never double-append to the chunk files.
        A record at or below the key's newest applied write (an
        interior-gap repair arriving late, or a feed replay of a record
        whose effect arrived via full-state transfer) is stamped into
        the feed — the vseq is no longer a gap, and peers replicating
        this feed dedupe it the same way — but the store mutation is
        skipped so the key never regresses or double-applies.  A record
        landing above its lane's seal (an acked write that outlived
        every live replica, arriving via catch-up) merges the seal
        upward — internal applies bypass the fence by design."""
        # crash point for the service fault suite: REPRO_FAULTPOINTS=
        # "cell.apply=N:kill" SIGKILLs this cell on its Nth applied
        # record — mid write storm, before the mutation lands
        faultpoints.fire("cell.apply")
        e, s = split_vseq(rec.seq)
        with self._flock:
            if s <= self._floors.get(e, 0) or rec.seq in self._applied:
                return False, False
            if rec.seq > self._key_seq.get(rec.key, 0):
                self._key_seq[rec.key] = rec.seq
                if rec.op == wire.OP_PUT:
                    self.store.put_encoded(rec.key, rec.blob, rec.raw_bytes)
                    existed = True
                else:
                    existed = self.store.delete(rec.key)
            else:
                existed = False  # superseded: recorded, not applied
            self._feed.append(rec)
            self._applied.add(rec.seq)
            self.last_seq = max(self.last_seq, rec.seq)
            self._note_epoch(e)
            self._lane_seq[e] = max(self._lane_seq.get(e, 0), s)
            if e in self._sealed and s > self._sealed[e]:
                self._sealed[e] = s  # merge the fence up, never down
            path = self._feed_path()
            if path is not None:
                with open(path, "ab") as f:
                    f.write(rec.pack())
            return True, existed

    def feed_since(self, floors) -> List[wire.FeedRecord]:
        """Records above the *caller's* per-lane floors (a lane absent
        from the map means "send everything you have in it").  An int
        is accepted as a combined-vseq floor (single-lane callers)."""
        if isinstance(floors, int):
            with self._flock:
                return [r for r in self._feed if r.seq > floors]
        with self._flock:
            out = []
            for r in self._feed:
                e, s = split_vseq(r.seq)
                if s > floors.get(e, 0):
                    out.append(r)
            return out

    def feed_bytes(self) -> int:
        path = self._feed_path()
        if path is not None and path.exists():
            return path.stat().st_size
        with self._flock:
            return sum(49 + len(r.key.did) + len(r.blob) for r in self._feed)

    # ---- per-lane ack coverage / feed truncation ----
    def note_ack(self, water: int) -> None:
        """Record a writer-piggybacked ack watermark (every cell has
        applied everything it owns in the writer's lane at or below
        ``water``) and truncate the feed if enough backlog has fallen
        below coverage."""
        e, s = split_vseq(water)
        with self._flock:
            if s > self._lane_ack.get(e, 0):
                self._lane_ack[e] = s
                self._note_epoch(e)
            self._maybe_truncate_locked(force=False)

    def truncate_feed(self, force: bool = True) -> bool:
        with self._flock:
            return self._maybe_truncate_locked(force=force)

    def _maybe_truncate_locked(self, force: bool) -> bool:
        floors = dict(self._floors)
        below = 0
        for r in self._feed:
            e, s = split_vseq(r.seq)
            cov = self._coverage(e)
            if s <= cov:
                below += 1
                if cov > floors.get(e, 0):
                    floors[e] = cov
        if floors == self._floors:
            return False
        if below < (1 if force else self.feed_keep):
            return False
        self._floors = floors
        keep = []
        for r in self._feed:
            e, s = split_vseq(r.seq)
            if s > floors.get(e, 0):
                keep.append(r)
        keep.sort(key=lambda r: r.seq)  # rewrite in vseq order: the
        # surviving log bytes are a pure function of the record set
        self._save_base_locked()  # checkpoint BEFORE the log shrinks
        path = self._feed_path()
        if path is not None:
            tmp = path.with_suffix(".log.tmp")
            with open(tmp, "wb") as f:
                for r in keep:
                    f.write(r.pack())
            os.replace(tmp, path)
        self._feed = keep
        kept = {r.seq for r in keep}
        self._applied = {s for s in self._applied if s in kept}
        self.truncations += 1
        return True

    # ---- writer leases ----
    def lease_op(self, op: int, epoch: int, writer_id: str,
                 final_seq: int = 0) -> Tuple[bool, int]:
        """ACQUIRE / RENEW / RELEASE one writer lease; returns
        ``(granted, max_epoch)`` — the deny reply carries the highest
        epoch this cell has seen so a losing writer can propose past
        it.  Grants are monotonic: an epoch is granted only if it
        exceeds every epoch seen (or re-grants the same writer's own
        lease — acquire and renew are idempotent)."""
        now = time.monotonic()
        with self._flock:
            if op == wire.LEASE_ACQUIRE:
                lease = self.leases.get(epoch)
                if epoch in self._sealed:
                    granted = False
                elif lease is not None and lease[0] in (None, writer_id):
                    lease[0] = writer_id
                    lease[1] = now + self.lease_ttl
                    granted = True
                elif epoch > self.max_epoch and lease is None:
                    self.leases[epoch] = [writer_id, now + self.lease_ttl]
                    granted = True
                else:
                    granted = False
                if granted:
                    self._note_epoch(epoch)
                    self.lease_grants += 1
            elif op == wire.LEASE_RENEW:
                # install-if-missing: a restarted cell lost its lease
                # table, but the renewing writer IS the lane's holder
                # (an impostor would be fenced by the seal, and a lane
                # can have at most one living writer by acquisition) —
                # refusing here would spuriously degrade a healthy
                # writer once a quorum of cells has restarted
                lease = self.leases.get(epoch)
                granted = (epoch not in self._sealed
                           and (lease is None
                                or lease[0] in (None, writer_id)))
                if granted:
                    self.leases[epoch] = [writer_id, now + self.lease_ttl]
                    self._note_epoch(epoch)
            elif op == wire.LEASE_RELEASE:
                # clean writer exit: fence the lane at its final seq so
                # the sweeper needn't wait out the TTL.  The writer has
                # drained its redelivery queues (quiesce/close), so the
                # lane is replica-complete up to final_seq everywhere.
                seal = max(final_seq, self._lane_seq.get(epoch, 0),
                           self._sealed.get(epoch, 0))
                self._sealed[epoch] = seal
                self.leases.pop(epoch, None)
                self._note_epoch(epoch)
                self.reconciles += 1
                self._save_base_locked()
                self._maybe_truncate_locked(force=False)
                granted = True
            else:
                raise AssertionError(f"unknown lease op {op}")
            return granted, self.max_epoch

    def learn_peers(self, peers: List[Tuple[str, int]]) -> None:
        """Adopt cluster topology from a LEASE/RECONCILE frame — the
        addresses lease-expiry reconciliation anti-entropies from."""
        mine = (self.host, self.port)
        with self._flock:
            for p in peers:
                if tuple(p) != mine and tuple(p) not in self.known_peers:
                    self.known_peers.append(tuple(p))

    # ---- orphan-seq reconciliation ----
    def sweep_leases(self) -> int:
        """Detect expired writer leases and reconcile their lanes.
        Returns the number of lanes sealed this pass."""
        now = time.monotonic()
        with self._flock:
            expired = [e for e, (wid, deadline) in self.leases.items()
                       if deadline < now and e not in self._sealed]
        sealed = 0
        for e in expired:
            # crash point: REPRO_FAULTPOINTS="cell.lease_expire=1:kill"
            # SIGKILLs the sweeping cell between detection and repair
            faultpoints.fire("cell.lease_expire")
            if self.reconcile_lane(e):
                sealed += 1
        return sealed

    def reconcile_lane(self, epoch: int, timeout: float = 5.0) -> bool:
        """Coordinate orphan-seq reconciliation for one dead lane:
        query every peer's lane high-water mark, anti-entropy this
        cell's own gaps, seal the lane at the max replica-acked record,
        and broadcast the seal.  Refuses (returns False) unless EVERY
        other cell answers and none still sees a live lease — sealing
        implies "replica-complete up to the seal", which is only
        provable with the whole cluster reachable; a later sweep (or a
        restarted cell's catch-up) retries."""
        with self._flock:
            peers = list(self.known_peers)
            if epoch in self._sealed:
                return True
        if len({p for p in peers}) < self.n_cells - 1:
            return False
        marks = [self._lane_seq.get(epoch, 0)]
        for host, port in peers:
            try:
                with self._peer_socket(host, port, timeout) as s:
                    wire.send_frame(
                        s, wire.MSG_RECONCILE, 0,
                        struct.pack("<BQ", wire.RECONCILE_QUERY, epoch))
                    reply = wire.recv_frame(s)
                if reply.msg_type != wire.MSG_OK:
                    return False
                lane_seq, seal, has_seal, live = struct.unpack_from(
                    "<QQBB", reply.body, 0)
                if live:
                    return False  # the writer still renews somewhere
                marks.append(lane_seq)
                if has_seal:
                    marks.append(seal)
            except (OSError, wire.WireError, struct.error):
                return False
        seal = max(marks)
        # anti-entropy own gaps below the seal before fencing the lane
        self.catch_up(peers, timeout=timeout)
        # phase 1 (prepare): every peer fills its own gaps while every
        # feed is still intact.  Sealing truncates, and each cell's feed
        # only covers the placements it replicates — peers must pull
        # from EACH OTHER before anyone drops feed records, or the seal
        # would certify records a replica never received.
        prep = (struct.pack("<BQ", wire.RECONCILE_PREPARE, epoch)
                + wire.pack_peers([(self.host, self.port)] + peers))
        for host, port in peers:
            try:
                with self._peer_socket(host, port, timeout) as s:
                    wire.send_frame(s, wire.MSG_RECONCILE, 0, prep)
                    reply = wire.recv_frame(s)
                if reply.msg_type != wire.MSG_OK:
                    return False
                (lane_seq,) = struct.unpack_from("<Q", reply.body, 0)
                seal = max(seal, lane_seq)
            except (OSError, wire.WireError, struct.error):
                return False  # completeness unproven: retry next sweep
        # phase 2 (seal): fence + truncate, locally then broadcast —
        # every peer is now complete, so truncation cannot orphan them
        self.apply_seal(epoch, seal)
        body = (struct.pack("<BQQ", wire.RECONCILE_SEAL, epoch, seal)
                + wire.pack_peers([(self.host, self.port)] + peers))
        for host, port in peers:
            try:
                with self._peer_socket(host, port, timeout) as s:
                    wire.send_frame(s, wire.MSG_RECONCILE, 0, body)
                    wire.recv_frame(s)
            except (OSError, wire.WireError):
                continue  # peer repairs at restart catch-up / next sweep
        return True

    def apply_seal(self, epoch: int, seal: int) -> int:
        """Fence one lane at ``seal`` (merged up by any local record
        above it), drop its lease, persist, and let truncation resume —
        the ack-coverage advance that un-strands a dead writer's floor.
        Returns the effective seal."""
        # crash point: REPRO_FAULTPOINTS="cell.reconcile=1:kill" SIGKILLs
        # the cell mid-reconciliation — after anti-entropy, before the
        # seal persists; a restart (or the next sweep) converges
        faultpoints.fire("cell.reconcile")
        with self._flock:
            eff = max(seal, self._sealed.get(epoch, 0),
                      self._lane_seq.get(epoch, 0))
            self._sealed[epoch] = eff
            self.leases.pop(epoch, None)
            self._note_epoch(epoch)
            self.reconciles += 1
            self._save_base_locked()
            self._maybe_truncate_locked(force=False)
            return eff

    def _sweep_loop(self) -> None:
        while not self._stop.wait(self.lease_ttl / 2):
            try:
                self.sweep_leases()
            except Exception:  # noqa: BLE001 — sweeping must not kill serving
                continue

    # ---- background maintenance ----
    def maintain(self) -> bool:
        """Kick a background vacuum of the store's chunk files (reclaim
        tombstoned/superseded records).  Returns whether a new pass was
        started (False: one is already running).  The cell never refuses
        traffic during the pass — ``DeltaStore.vacuum`` holds the store
        lock per chunk and readers retry across rewrites."""
        with self._maint_lock:
            if self._maint_thread is not None and self._maint_thread.is_alive():
                return False
            t = threading.Thread(target=self._maint_pass,
                                 name=f"cell{self.node_id}-maint",
                                 daemon=True)
            self._maint_thread = t
            t.start()
            return True

    def _maint_pass(self) -> None:
        try:
            self.last_vacuum = self.store.vacuum()
        except Exception:  # noqa: BLE001 — maintenance must not kill serving
            self.last_vacuum = None

    # ---- replica catch-up ----
    def _peer_socket(self, host: str, port: int,
                     timeout: float) -> socket.socket:
        """Dial a peer cell with the HELLO (+ optional auth) handshake —
        cell-to-cell traffic speaks the same protocol as clients."""
        s = socket.create_connection((host, port), timeout=timeout)
        s.settimeout(timeout)
        try:
            wire.send_frame(s, wire.MSG_HELLO, 0)
            reply = wire.recv_frame(s)
            if reply.msg_type == wire.MSG_AUTH:
                if self.auth_key is None:
                    raise wire.AuthFailed(
                        f"peer {host}:{port} requires auth but this cell "
                        f"has no key")
                mac = hmac.new(self.auth_key, reply.body,
                               hashlib.sha256).digest()
                wire.send_frame(s, wire.MSG_AUTH, 0, mac)
                reply = wire.recv_frame(s)
            if reply.msg_type == wire.MSG_ERR:
                code, msg = wire.unpack_err(reply.body)
                if code == wire.ERR_AUTH_FAILED:
                    raise wire.AuthFailed(msg)
                raise wire.RemoteError(code, msg)
            if reply.msg_type != wire.MSG_HELLO:
                raise wire.FrameError(
                    f"expected HELLO reply, got type {reply.msg_type}")
        except BaseException:
            s.close()
            raise
        return s

    def _pull_feed(self, host: str, port: int, floors: Dict[int, int],
                   timeout: float,
                   ) -> Tuple[Dict[int, int], Dict[int, int],
                              List[wire.FeedRecord]]:
        with self._peer_socket(host, port, timeout) as s:
            wire.send_frame(s, wire.MSG_FEED_SINCE, 0,
                            wire.pack_lanes(floors))
            reply = wire.recv_frame(s)
        if reply.msg_type != wire.MSG_OK:
            raise wire.RemoteError(*wire.unpack_err(reply.body))
        peer_floors, off = wire.unpack_lanes(reply.body, 0)
        peer_seals, off = wire.unpack_lanes(reply.body, off)
        return peer_floors, peer_seals, wire.unpack_records(reply.body, off)

    def _is_fresh(self) -> bool:
        return (not self._feed and not self._applied and not self._floors
                and self.last_seq == 0 and not self.store.key_sizes)

    def _bootstrap_state(self, peers: List[Tuple[str, int]],
                         timeout: float) -> int:
        """Full-state transfer for a fresh (wiped) cell facing peers
        whose feeds are truncated: for every placement this cell owns,
        copy a live replica's chunk + extent file bytes verbatim and
        install its per-key accounting, then adopt the highest peer
        floors seen.  Returns the number of placements installed.  Chunk
        files never shrink at truncation (only the feed does), so any
        replica's copy is complete regardless of its floors — and since
        they are pure functions of the record set, the copied bytes are
        exactly what replaying the full history would have produced."""
        if self.store.backend != "file":
            raise FeedTruncated(
                "fresh mem-backed cell cannot bootstrap past a truncated "
                "peer feed: full-state transfer needs the file backend")
        pulled: set = set()
        floors: Dict[int, int] = {}
        seals: Dict[int, int] = {}
        installed = 0
        for host, port in peers:
            try:
                with self._peer_socket(host, port, timeout) as s:
                    wire.send_frame(s, wire.MSG_PLACEMENTS, 0)
                    reply = wire.recv_frame(s)
                    if reply.msg_type != wire.MSG_OK:
                        continue
                    placements = [
                        p for p in wire.unpack_placements(reply.body)
                        if p not in pulled
                        and self.node_id in replica_nodes(p[0], p[1],
                                                          self.n_cells,
                                                          self.r)]
                    for tsid, sid in placements:
                        wire.send_frame(s, wire.MSG_STATE_PULL, 0,
                                        struct.pack("<qq", tsid, sid))
                        reply = wire.recv_frame(s)
                        if reply.msg_type != wire.MSG_OK:
                            continue
                        state = wire.PlacementState.unpack(reply.body)
                        self._install_state((tsid, sid), state)
                        pulled.add((tsid, sid))
                        for e, f in state.floors.items():
                            floors[e] = max(floors.get(e, 0), f)
                        for e, f in state.seals.items():
                            seals[e] = max(seals.get(e, 0), f)
                        installed += 1
            except (OSError, wire.WireError, struct.error):
                continue
        with self._flock:
            if installed:
                for e, f in floors.items():
                    self._floors[e] = max(self._floors.get(e, 0), f)
                    self._lane_ack[e] = max(self._lane_ack.get(e, 0), f)
                    self._lane_seq[e] = max(self._lane_seq.get(e, 0), f)
                    self._note_epoch(e)
                    self.last_seq = max(self.last_seq, make_vseq(e, f))
                for e, f in seals.items():
                    self._sealed[e] = max(self._sealed.get(e, 0), f)
                    self._note_epoch(e)
                self.last_seq = max([self.last_seq]
                                    + list(self._key_seq.values()))
                self._save_base_locked()
        return installed

    def _install_state(self, placement: Tuple[int, int],
                       state: wire.PlacementState) -> None:
        cpath = self.store._chunk_path(0, placement)
        epath = self.store._extent_path(0, placement)
        cpath.parent.mkdir(parents=True, exist_ok=True)
        cpath.write_bytes(state.chunk)
        if state.ext:
            epath.write_bytes(state.ext)
        self.store.drop_chunk_caches(0, placement)
        for key, raw, enc in state.sizes:
            self.store.key_sizes[key] = (raw, enc)
        for key, seq in state.key_seqs:
            if seq > self._key_seq.get(key, 0):
                self._key_seq[key] = seq

    def catch_up(self, peers: List[Tuple[str, int]],
                 timeout: float = 5.0) -> int:
        """Converge with the cluster after a restart: pull every peer's
        feed above this cell's own per-lane truncation floors, keep the
        records whose key's replica chain includes this cell and whose
        vseq is not already certified applied, and apply them in vseq
        order.  Merges peer lane *seals* (a lane fenced while this cell
        was down stays fenced here), then returns the number of records
        applied (feed stamps included).

        Fetching from the floors rather than from ``last_seq`` is what
        repairs *interior* gaps — a PUT this cell missed while live
        (transient timeout) below a vseq it did accept would be
        invisible to a tail-only pull and would otherwise serve silently
        stale reads forever; the applied set makes the refetch cheap to
        dedupe and impossible to double-apply.  The floors are a safe
        lower bound because they only advance past records every replica
        acked (or a full-cluster reconciliation sealed).  A peer whose
        own floors are above ours can no longer serve the records in
        between as feed entries — for a disk-surviving cell that is fine
        (the ack invariant says we already hold everything we own down
        there); a *fresh* cell instead bootstraps by full-state transfer
        first.  Unreachable peers are skipped — with r-way replication
        any single live peer of a key suffices."""
        with self._flock:
            own_floors = dict(self._floors)
        fetched: Dict[int, wire.FeedRecord] = {}
        peer_floor_max: Dict[int, int] = {}
        peer_seals: Dict[int, int] = {}
        reachable: List[Tuple[str, int]] = []
        for host, port in peers:
            try:
                pf, ps, recs = self._pull_feed(host, port, own_floors,
                                               timeout)
            except (OSError, wire.WireError, struct.error):
                continue
            reachable.append((host, port))
            for e, f in pf.items():
                peer_floor_max[e] = max(peer_floor_max.get(e, 0), f)
            for e, f in ps.items():
                peer_seals[e] = max(peer_seals.get(e, 0), f)
            for rec in recs:
                e, s = split_vseq(rec.seq)
                if (s > own_floors.get(e, 0)
                        and rec.seq not in self._applied
                        and self._owns(rec.key)):
                    fetched.setdefault(rec.seq, rec)
        above = any(f > own_floors.get(e, 0)
                    for e, f in peer_floor_max.items())
        if above and self._is_fresh():
            self._bootstrap_state(reachable, timeout)
        n = 0
        for seq in sorted(fetched):
            applied, _ = self.apply(fetched[seq])
            n += applied
        # merge peer seals only AFTER the gap records above are applied:
        # a seal raises this lane's truncation coverage, and a concurrent
        # piggybacked ack must not advance the floor past records still
        # sitting in `fetched` (the floor certifies them applied)
        with self._flock:
            for e, f in peer_seals.items():
                if f > self._sealed.get(e, -1):
                    self._sealed[e] = max(f, self._lane_seq.get(e, 0))
                self.leases.pop(e, None)
                self._note_epoch(e)
        return n

    # ---- server ----
    def start(self, peers: Optional[List[Tuple[str, int]]] = None) -> int:
        """Catch up from ``peers`` (if any), bind, and serve in
        background threads.  Returns the bound port.  A second catch-up
        pass runs after bind so records that landed on peers while this
        cell was binding are not missed."""
        if peers:
            self.catch_up(peers)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix=f"cell{self.node_id}-worker")
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((self.host, self.port))
        self._lsock.listen(64)
        self.port = self._lsock.getsockname()[1]
        for target, name in ((self._accept_loop, "accept"),
                             (self._sweep_loop, "sweep")):
            t = threading.Thread(target=target,
                                 name=f"cell{self.node_id}-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if peers:
            self.learn_peers(peers)
            self.catch_up(peers)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        for c in list(self._conns):
            try:
                c.close()
            except OSError:
                pass
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return  # listen socket closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _hello_body(self) -> bytes:
        return struct.pack("<BQ", self.node_id, self.last_seq)

    def _serve_conn(self, conn: socket.socket) -> None:
        """Per-connection read loop.  Cheap liveness traffic (HELLO,
        PING) is answered inline so it can never queue behind a slow
        request; everything else is dispatched to the worker pool under
        the per-connection in-flight cap.  Replies are written under
        ``send_lock`` in completion order — out-of-order by design, the
        client demuxes by ``req_id``.

        With ``auth_key`` set, the connection starts *unauthenticated*:
        HELLO is answered with an ``MSG_AUTH`` nonce challenge, the
        client's ``MSG_AUTH`` HMAC response is verified with a
        constant-time compare, and every other frame before success is
        refused with the typed ``AUTH_FAILED`` and a hangup."""
        send_lock = threading.Lock()
        slots = threading.BoundedSemaphore(self.inflight_cap)
        reader = wire.FrameReader(conn)  # pipelined requests batch per recv
        authed = self.auth_key is None
        nonce: Optional[bytes] = None
        try:
            while not self._stop.is_set():
                try:
                    frame = reader.next_frame()
                except (wire.ConnectionClosed, OSError):
                    return  # peer hung up, or stop() closed us mid-read
                except wire.WireError:
                    return  # garbage on the stream: drop the connection
                if frame.version != wire.PROTO_VERSION:
                    # answer under OUR version so the peer's codec can
                    # still read the rejection, then hang up
                    with send_lock:
                        wire.send_frame(
                            conn, wire.MSG_ERR, frame.req_id,
                            wire.pack_err(
                                wire.ERR_VERSION,
                                f"cell speaks v{wire.PROTO_VERSION}, "
                                f"client sent v{frame.version}"))
                    return
                if not authed:
                    try:
                        if frame.msg_type == wire.MSG_HELLO:
                            nonce = os.urandom(wire.AUTH_NONCE_LEN)
                            with send_lock:
                                wire.send_frame(conn, wire.MSG_AUTH,
                                                frame.req_id, nonce)
                            continue
                        if frame.msg_type == wire.MSG_AUTH and nonce:
                            mac = hmac.new(self.auth_key, nonce,
                                           hashlib.sha256).digest()
                            if hmac.compare_digest(mac, frame.body):
                                authed = True
                                nonce = None
                                with send_lock:
                                    wire.send_frame(conn, wire.MSG_HELLO,
                                                    frame.req_id,
                                                    self._hello_body())
                                continue
                        with send_lock:
                            wire.send_frame(
                                conn, wire.MSG_ERR, frame.req_id,
                                wire.pack_err(wire.ERR_AUTH_FAILED,
                                              "auth required: bad or "
                                              "missing HMAC response"))
                    except OSError:
                        pass
                    if not authed:
                        return  # failed handshake: hang up
                    continue
                if frame.msg_type in (wire.MSG_HELLO, wire.MSG_PING):
                    if frame.msg_type == wire.MSG_PING and len(frame.body) >= 8:
                        (water,) = struct.unpack_from("<Q", frame.body, 0)
                        self.note_ack(water)
                    reply = (wire.MSG_HELLO if frame.msg_type == wire.MSG_HELLO
                             else wire.MSG_OK)
                    try:
                        with send_lock:
                            wire.send_frame(conn, reply, frame.req_id,
                                            self._hello_body())
                    except OSError:
                        return
                    continue
                slots.acquire()  # in-flight cap: blocks the READ loop only
                if self._pool is None:  # direct use without start(): inline
                    self._run_request(conn, send_lock, slots, frame)
                else:
                    self._pool.submit(self._run_request, conn, send_lock,
                                      slots, frame)
        finally:
            self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _run_request(self, conn: socket.socket, send_lock: threading.Lock,
                     slots: threading.BoundedSemaphore,
                     frame: wire.Frame) -> None:
        try:
            try:
                if frame.msg_type == wire.MSG_MULTIGET:
                    self._stream_multiget(conn, send_lock, frame)
                    return
                mtype, body = self._handle(frame.msg_type, frame.body)
            except KeyMissing as e:
                mtype, body = wire.MSG_ERR, wire.pack_err(
                    wire.ERR_KEY_MISSING, str(e.args[0]))
            except FeedTruncated as e:
                mtype, body = wire.MSG_ERR, wire.pack_err(
                    wire.ERR_FEED_TRUNCATED, str(e))
            except wire.LeaseFenced as e:
                mtype, body = wire.MSG_ERR, wire.pack_err(
                    wire.ERR_LEASE_FENCED, str(e))
            except (wire.WireError, struct.error, IndexError,
                    UnicodeDecodeError, AssertionError) as e:
                mtype, body = wire.MSG_ERR, wire.pack_err(
                    wire.ERR_BAD_REQUEST, f"{type(e).__name__}: {e}")
            except Exception as e:  # noqa: BLE001 — relay, don't die
                mtype, body = wire.MSG_ERR, wire.pack_err(
                    wire.ERR_INTERNAL, f"{type(e).__name__}: {e}")
            try:
                with send_lock:
                    wire.send_frame(conn, mtype, frame.req_id, body)
            except OSError:
                pass
        finally:
            slots.release()

    def _stream_multiget(self, conn: socket.socket,
                         send_lock: threading.Lock,
                         frame: wire.Frame) -> None:
        """MULTIGET reply stream: one CHUNK frame per found key as it is
        read (the client can decode and pool-fill immediately), END with
        the found count as the terminal frame, ERR as the terminal frame
        on a hard miss.  All frames carry the request's req_id, so the
        stream interleaves freely with other in-flight replies."""
        try:
            body = frame.body
            (n,) = struct.unpack_from("<I", body, 0)
            off = 4
            keys = []
            for _ in range(n):
                k, off = wire.unpack_key(body, off)
                keys.append(k)
            fields, off = wire.unpack_fields(body, off)
            (missing_ok,) = struct.unpack_from("<B", body, off)
        except (wire.WireError, struct.error, IndexError,
                UnicodeDecodeError) as e:
            try:
                with send_lock:
                    wire.send_frame(conn, wire.MSG_ERR, frame.req_id,
                                    wire.pack_err(wire.ERR_BAD_REQUEST,
                                                  f"{type(e).__name__}: {e}"))
            except OSError:
                pass
            return
        # CHUNK frames coalesce into one sendall per ~64 KiB — identical
        # frames on the wire, a fraction of the syscalls (and on a busy
        # box, of the scheduler switches).  A terminal ERR/END appends
        # after any buffered chunks so per-request frame order holds.
        found = 0
        pend = bytearray()
        try:
            for k in keys:
                try:
                    blob = self.store.get_encoded(k, fields)
                except KeyMissing as e:
                    if missing_ok:
                        continue
                    pend += wire.encode_frame(
                        wire.MSG_ERR, frame.req_id,
                        wire.pack_err(wire.ERR_KEY_MISSING, str(e.args[0])))
                    with send_lock:
                        conn.sendall(pend)
                    return
                except Exception as e:  # noqa: BLE001 — relay, don't die
                    pend += wire.encode_frame(
                        wire.MSG_ERR, frame.req_id,
                        wire.pack_err(wire.ERR_INTERNAL,
                                      f"{type(e).__name__}: {e}"))
                    with send_lock:
                        conn.sendall(pend)
                    return
                found += 1
                pend += wire.encode_frame(
                    wire.MSG_CHUNK, frame.req_id,
                    wire.pack_key(k) + wire.pack_blob(blob))
                if len(pend) >= (1 << 16):
                    with send_lock:
                        conn.sendall(pend)
                    pend = bytearray()
            pend += wire.encode_frame(wire.MSG_END, frame.req_id,
                                      struct.pack("<I", found))
            with send_lock:
                conn.sendall(pend)
        except OSError:
            pass

    def _feed_status_locked(self) -> Dict:
        lanes = {}
        for e in sorted(self._lanes_known()):
            lanes[str(e)] = {
                "seq": self._lane_seq.get(e, 0),
                "ack": self._lane_ack.get(e, 0),
                "floor": self._floors.get(e, 0),
                "seal": self._sealed.get(e),
                "lease": (e in self.leases
                          and self.leases[e][1] > time.monotonic()),
            }
        known = self._lanes_known()
        return {
            "len": len(self._feed),
            "floor": max((make_vseq(e, f)
                          for e, f in self._floors.items()), default=0),
            "ack_water": max((make_vseq(e, self._coverage(e))
                              for e in known), default=0),
            "truncations": self.truncations,
            "lanes": lanes,
            "max_epoch": self.max_epoch,
            "fenced_writes": self.fenced_writes,
            "reconciles": self.reconciles,
        }

    def _handle(self, msg_type: int, body: bytes) -> Tuple[int, bytes]:
        if msg_type in (wire.MSG_HELLO, wire.MSG_PING):
            # normally answered inline by the read loop; kept here for
            # direct (non-socket) callers
            if msg_type == wire.MSG_PING and len(body) >= 8:
                (water,) = struct.unpack_from("<Q", body, 0)
                self.note_ack(water)
            reply = wire.MSG_HELLO if msg_type == wire.MSG_HELLO else wire.MSG_OK
            return reply, self._hello_body()
        if msg_type == wire.MSG_GET:
            key, off = wire.unpack_key(body, 0)
            fields, _ = wire.unpack_fields(body, off)
            return wire.MSG_OK, self.store.get_encoded(key, fields)
        if msg_type == wire.MSG_PUT:
            key, off = wire.unpack_key(body, 0)
            seq, raw = struct.unpack_from("<QQ", body, off)
            blob, off = wire.unpack_blob(body, off + 16)
            self.fence_check(seq)  # LeaseFenced before anything lands
            applied, _ = self.apply(
                wire.FeedRecord(seq, wire.OP_PUT, key, raw, blob))
            if off + 8 <= len(body):  # trailing ack watermark
                (water,) = struct.unpack_from("<Q", body, off)
                self.note_ack(water)
            return wire.MSG_OK, struct.pack("<BQ", applied, self.last_seq)
        if msg_type == wire.MSG_DELETE:
            key, off = wire.unpack_key(body, 0)
            (seq,) = struct.unpack_from("<Q", body, off)
            self.fence_check(seq)
            _, existed = self.apply(
                wire.FeedRecord(seq, wire.OP_DELETE, key, 0, b""))
            if off + 16 <= len(body):  # trailing ack watermark
                (water,) = struct.unpack_from("<Q", body, off + 8)
                self.note_ack(water)
            return wire.MSG_OK, struct.pack("<BQ", existed, self.last_seq)
        if msg_type == wire.MSG_FEED_SINCE:
            floors, _ = wire.unpack_lanes(body, 0)
            with self._flock:
                head = (wire.pack_lanes(self._floors)
                        + wire.pack_lanes(self._sealed))
            return wire.MSG_OK, (head
                                 + wire.pack_records(self.feed_since(floors)))
        if msg_type == wire.MSG_LEASE:
            (op,) = struct.unpack_from("<B", body, 0)
            (epoch,) = struct.unpack_from("<Q", body, 1)
            writer_id, off = wire.unpack_str(body, 9)
            final_seq = 0
            if op == wire.LEASE_RELEASE and off + 8 <= len(body):
                (final_seq,) = struct.unpack_from("<Q", body, off)
                off += 8
            if off < len(body):  # trailing peer list: learn the topology
                peers, _ = wire.unpack_peers(body, off)
                self.learn_peers(peers)
            granted, max_epoch = self.lease_op(op, epoch, writer_id,
                                               final_seq)
            return wire.MSG_OK, struct.pack("<BQ", granted, max_epoch)
        if msg_type == wire.MSG_RECONCILE:
            (op,) = struct.unpack_from("<B", body, 0)
            if op == wire.RECONCILE_QUERY:
                (epoch,) = struct.unpack_from("<Q", body, 1)
                with self._flock:
                    lane_seq = self._lane_seq.get(epoch, 0)
                    seal = self._sealed.get(epoch)
                    lease = self.leases.get(epoch)
                    live = (lease is not None
                            and lease[1] > time.monotonic())
                return wire.MSG_OK, struct.pack(
                    "<QQBB", lane_seq, seal or 0, seal is not None, live)
            if op == wire.RECONCILE_PREPARE:
                (epoch,) = struct.unpack_from("<Q", body, 1)
                peers: List[Tuple[str, int]] = []
                if len(body) > 9:
                    peers, _ = wire.unpack_peers(body, 9)
                    self.learn_peers(peers)
                mine = (self.host, self.port)
                others = [tuple(p) for p in peers if tuple(p) != mine]
                if others:  # fill own gaps while feeds are intact
                    self.catch_up(others)
                with self._flock:
                    return wire.MSG_OK, struct.pack(
                        "<Q", self._lane_seq.get(epoch, 0))
            if op == wire.RECONCILE_SEAL:
                epoch, seal = struct.unpack_from("<QQ", body, 1)
                peers: List[Tuple[str, int]] = []
                if len(body) > 17:
                    peers, _ = wire.unpack_peers(body, 17)
                    self.learn_peers(peers)
                mine = (self.host, self.port)
                others = [tuple(p) for p in peers if tuple(p) != mine]
                if others:  # anti-entropy own gaps before fencing
                    self.catch_up(others)
                eff = self.apply_seal(epoch, seal)
                return wire.MSG_OK, struct.pack("<Q", eff)
            raise AssertionError(f"unknown reconcile op {op}")
        if msg_type == wire.MSG_STATUS:
            s = self.store.stats
            with self._flock:
                feed = self._feed_status_locked()
                lease_view = {
                    str(e): {"writer": wid,
                             "remaining": round(dl - time.monotonic(), 3)}
                    for e, (wid, dl) in self.leases.items()}
            status = {
                "node": self.node_id, "last_seq": self.last_seq,
                "n_keys": len(self.store.key_sizes),
                "live_bytes": self.store.live_bytes(),
                "backend": self.store.backend,
                "feed_len": feed["len"],
                "feed": dict(feed, bytes=self.feed_bytes()),
                "leases": lease_view,
                "max_epoch": self.max_epoch,
                "stats": {"reads": s.reads, "writes": s.writes,
                          "bytes_read": s.bytes_read,
                          "bytes_written": s.bytes_written,
                          "bytes_io": s.bytes_io},
                "maint": {
                    "running": (self._maint_thread is not None
                                and self._maint_thread.is_alive()),
                    "last_vacuum": self.last_vacuum,
                },
            }
            return wire.MSG_OK, json.dumps(status).encode()
        if msg_type == wire.MSG_KEYS:
            tsid, sid = struct.unpack_from("<qq", body, 0)
            keys = self.store.keys_for_placement(tsid, sid)
            return wire.MSG_OK, (struct.pack("<I", len(keys))
                                 + b"".join(wire.pack_key(k) for k in keys))
        if msg_type == wire.MSG_MAINT:
            # empty body: legacy "kick a vacuum".  Otherwise a flags
            # byte: bit0 vacuum (fire-and-forget, background thread),
            # bit1 truncate the feed NOW if coverage allows, bit2 run a
            # SYNCHRONOUS canonical vacuum (chunk records reordered by
            # key — the multi-writer byte-identity anchor); bits 1-2 are
            # synchronous so benches/tests reach a deterministic final
            # disk state before comparing files
            flags = wire.MAINT_VACUUM
            if len(body) >= 1:
                (flags,) = struct.unpack_from("<B", body, 0)
            started = False
            if flags & wire.MAINT_VACUUM and not flags & wire.MAINT_CANON:
                started = self.maintain()
            if flags & wire.MAINT_TRUNCATE:
                self.truncate_feed(force=True)
            if flags & wire.MAINT_CANON:
                self.last_vacuum = self.store.vacuum(canonical=True)
                started = True
            return wire.MSG_OK, struct.pack("<B", started)
        if msg_type == wire.MSG_PLACEMENTS:
            placements = sorted({(k.tsid, k.sid)
                                 for k in self.store.key_sizes})
            return wire.MSG_OK, wire.pack_placements(placements)
        if msg_type == wire.MSG_STATE_PULL:
            if self.store.backend != "file":
                raise FeedTruncated(
                    "mem-backed cell cannot serve full-state transfer")
            tsid, sid = struct.unpack_from("<qq", body, 0)
            placement = (tsid, sid)
            with self._flock:
                cpath = self.store._chunk_path(0, placement)
                epath = self.store._extent_path(0, placement)
                chunk = cpath.read_bytes() if cpath.exists() else b""
                ext = epath.read_bytes() if epath.exists() else b""
                sizes = [(k, rw, en)
                         for k, (rw, en) in self.store.key_sizes.items()
                         if (k.tsid, k.sid) == placement]
                key_seqs = [(k, s) for k, s in self._key_seq.items()
                            if (k.tsid, k.sid) == placement]
                state = wire.PlacementState(dict(self._floors),
                                            dict(self._sealed), chunk, ext,
                                            sizes, key_seqs)
            return wire.MSG_OK, state.pack()
        raise AssertionError(f"unknown message type {msg_type}")


def _parse_peers(spec: str) -> List[Tuple[str, int]]:
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, port = part.rsplit(":", 1)
        out.append((host, int(port)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Run one temporal-graph storage cell.")
    ap.add_argument("--node-id", type=int, required=True)
    ap.add_argument("--n-cells", type=int, required=True)
    ap.add_argument("--replication", type=int, default=1)
    ap.add_argument("--backend", default="file", choices=("mem", "file"))
    ap.add_argument("--root", default=None,
                    help="cell data dir (chunk/extent files + feed.log)")
    ap.add_argument("--fmt", default=None, help="block format (TGI2 default)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral, printed on READY)")
    ap.add_argument("--peers", default="",
                    help="comma-separated host:port peers for boot catch-up")
    ap.add_argument("--workers", type=int, default=4,
                    help="request worker pool size (read loops stay free)")
    ap.add_argument("--inflight-cap", type=int, default=32,
                    help="max queued+running requests per connection")
    ap.add_argument("--feed-keep", type=int, default=256,
                    help="min fully-acked backlog before feed truncation")
    ap.add_argument("--lease-ttl", type=float, default=2.0,
                    help="writer-lease TTL seconds (sweeper reconciles "
                         "expired lanes)")
    ap.add_argument("--auth-key", default=None,
                    help="shared secret: require the HELLO HMAC handshake")
    args = ap.parse_args(argv)
    cell = StorageCell(node_id=args.node_id, n_cells=args.n_cells,
                       r=args.replication, backend=args.backend,
                       root=args.root, fmt=args.fmt, host=args.host,
                       port=args.port, workers=args.workers,
                       inflight_cap=args.inflight_cap,
                       feed_keep=args.feed_keep, lease_ttl=args.lease_ttl,
                       auth_key=args.auth_key)
    port = cell.start(peers=_parse_peers(args.peers))
    print(f"CELL READY node={cell.node_id} port={port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    cell.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
