"""Delta KV store (the paper's Cassandra role, §4.4).

Keys are ``DeltaKey(tsid, sid, did, pid)``; the **placement key**
``(tsid, sid)`` maps a chunk to a storage node, so any large fetch
(snapshot = all sids of one tsid; node version = one sid across tsids)
spreads over the whole cluster — the paper's equitable-distribution
property.  Within a chunk, micro-deltas are clustered by the full delta
key, i.e. all ``pid`` of one ``did`` stored contiguously (paper layout
point 5): the FileBackend writes one blob per placement key.

Replication factor r places a chunk on r consecutive storage nodes;
``fail_node``/``heal_node`` inject failures — reads fall over to live
replicas, writes raise only if *all* replicas are down.  A thread-pooled
``multiget`` models the paper's parallel fetch factor ``c``.

Read-path fast layers (both on by default):

* **Decoded-block buffer pool** (``BlockPool``): a byte-budgeted LRU of
  *decoded* columns keyed ``(key, column)``.  Repeated hierarchy-path
  and eventlist reads — the inner loop of snapshot retrieval and
  compaction — skip storage I/O AND decompression entirely.  Pool hits
  are accounted separately from physical decodes (``StoreStats.
  pool_hits`` / ``bytes_pool_served`` vs ``bytes_decompressed``;
  ``ReadSizes`` carries the per-key split) so FetchCost stays truthful.
  Writers (``put``/``delete``) invalidate per key.
* **Range-seek file backend** (``seek=True``): every put appends the
  blob's (offset, length) extent to a ``.tgx`` sidecar next to the chunk
  file; reads seek straight to the blob, parse the TGI2 directory from a
  small prefix, and pread only the *requested* columns' byte ranges —
  a ``fields=`` projection saves real disk I/O, not just decode time
  (``StoreStats.bytes_io`` counts the physical file bytes actually
  read; compare with ``seek=False``, which slurps whole chunk files).
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import os
import threading
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import faultpoints
from repro_torch.storage import serialize
from repro_torch.storage.serialize import BlockCorruption  # re-export  # noqa: F401


class DeltaKey(NamedTuple):
    tsid: int
    sid: int
    did: str  # e.g. 'E:<bucket>' eventlist, 'S:<level>:<idx>' derived snapshot
    pid: int  # micro-delta partition id (== sid-local partition index)

    @property
    def placement(self) -> Tuple[int, int]:
        return (self.tsid, self.sid)


def replica_nodes(tsid: int, sid: int, m: int, r: int) -> List[int]:
    """The placement function, shared by every party that must agree on
    it: ``DeltaStore`` (local reads/writes), ``RemoteDeltaStore``
    (routing), and ``StorageCell`` (feed catch-up filters peer records
    to the keys whose replica chain includes this cell).  A placement
    key hashes to a primary node; replicas live on the next ``r - 1``
    consecutive nodes (the paper's equitable-distribution layout)."""
    h = (tsid * 0x9E3779B1 + sid * 0x85EBCA77) % m
    return [(h + j) % m for j in range(r)]


# ---------------------------------------------------------------------------
# versioned sequence numbers: (epoch, seq) packed into one u64
# ---------------------------------------------------------------------------

# A write's version is ``(epoch, seq)``: ``epoch`` is the writer's
# fencing epoch (one per writer-lease incarnation, granted by cell
# quorum, strictly monotonic cluster-wide) and ``seq`` is that lane's
# local counter starting at 1.  Packing epoch into the high bits makes
# the numeric order of the u64 exactly the lexicographic (epoch, seq)
# order — the cluster-wide total order that every per-key conflict
# (concurrent writers, replays, redeliveries arriving in any
# permutation) is resolved by.  Epoch 0 is the legacy unleased lane
# (direct ``StorageCell.apply`` callers, pre-lease feeds).
SEQ_BITS = 44
SEQ_MASK = (1 << SEQ_BITS) - 1
MAX_EPOCH = (1 << (64 - SEQ_BITS)) - 1


def make_vseq(epoch: int, seq: int) -> int:
    assert 0 <= epoch <= MAX_EPOCH and 0 <= seq <= SEQ_MASK
    return (epoch << SEQ_BITS) | seq


def split_vseq(vseq: int) -> Tuple[int, int]:
    return vseq >> SEQ_BITS, vseq & SEQ_MASK


class StorageNodeDown(RuntimeError):
    pass


class WriteUnavailable(StorageNodeDown):
    """The write plane is degraded: this writer holds no live lease and
    cannot reach a cell quorum to acquire one, so writes fail *fast*
    (no network attempt, no hang) while reads keep failing over.  The
    client re-acquires automatically in the background; writes flow
    again, under a fresh fencing epoch, once a quorum returns."""


class NodeUnavailable(RuntimeError):
    """One replica could not be reached (remote cell down, connect or
    request timeout).  Read paths treat it exactly like a down node:
    fail over to the next replica; only when every replica is
    unavailable does the error surface as ``StorageNodeDown``.  Local
    backends never raise it."""


# file-backend deletion marker: a record whose length field holds this
# sentinel carries no blob and tombstones every earlier write of its key
# (reads are last-record-wins, so append-only chunk files stay valid)
_TOMBSTONE = (1 << 64) - 1


class KeyMissing(KeyError):
    pass


@dataclasses.dataclass
class StoreStats:
    reads: int = 0
    writes: int = 0
    n_deletes: int = 0  # keys GC'd (span compaction)
    bytes_read: int = 0  # encoded bytes touched off storage
    bytes_written: int = 0  # encoded bytes on disk (x replication)
    bytes_raw_written: int = 0  # pre-encoding bytes (x replication)
    bytes_decompressed: int = 0  # raw bytes physically decoded by reads
    bytes_deleted: int = 0  # encoded bytes reclaimed by deletes (x repl.)
    failovers: int = 0
    # multiget batch redirects: keys routed straight to a fallback
    # replica because their node was known-unavailable at batch start
    # (hedged as a group, not rediscovered per key)
    hedged_reads: int = 0
    # replica writes that failed (or were skipped on a suspect node) and
    # were later delivered from the client's per-node redelivery queue —
    # the live repair that closes interior feed gaps (remote store only)
    redelivered: int = 0
    # decoded-block pool accounting — pool hits are NEVER counted as
    # physical decodes (bytes_decompressed), so FetchCost stays truthful
    pool_hits: int = 0  # columns served from the pool
    pool_misses: int = 0  # columns physically read + decoded (pool on)
    bytes_pool_served: int = 0  # raw bytes served from the pool
    bytes_io: int = 0  # physical file-backend bytes read (0 for mem)
    # wire-transport round trips (remote store only): a request submitted
    # while its node's connection already had >= 1 reply outstanding rode
    # the pipeline; one submitted to an idle connection paid a serial
    # round trip.  Deadline cancels expired client-side without poisoning
    # the connection; reconnects are transparent re-dials of a mux socket
    rt_pipelined: int = 0
    rt_serial: int = 0
    rt_deadline_cancels: int = 0
    rt_reconnects: int = 0
    # writer-lease lifecycle (remote store only): epochs acquired by
    # quorum grant, quorum-confirmed renewals, writes refused by a cell
    # because their lane was fenced (sealed under a newer epoch), and
    # queued redeliveries dropped because redelivering them is forever
    # futile (their lane sealed below them — restart catch-up repairs)
    lease_acquires: int = 0
    lease_renewals: int = 0
    lease_fenced: int = 0
    fence_drops: int = 0
    # encoded serve cache (file backend): projected blocks assembled once
    # and re-served byte-identical while their extent record is unmoved
    serve_hits: int = 0
    serve_misses: int = 0

    def reset(self):
        self.reads = self.writes = self.n_deletes = 0
        self.bytes_read = self.bytes_written = 0
        self.bytes_raw_written = self.bytes_decompressed = 0
        self.bytes_deleted = 0
        self.failovers = self.hedged_reads = self.redelivered = 0
        self.pool_hits = self.pool_misses = self.bytes_pool_served = 0
        self.bytes_io = 0
        self.rt_pipelined = self.rt_serial = 0
        self.rt_deadline_cancels = self.rt_reconnects = 0
        self.lease_acquires = self.lease_renewals = 0
        self.lease_fenced = self.fence_drops = 0
        self.serve_hits = self.serve_misses = 0


class ReadSizes(NamedTuple):
    """Per-key byte accounting of one ``get`` (the ``sizes=`` out-param):
    what physically crossed storage vs what the decoded-block pool
    served.  ``enc + raw`` describe the physical read; ``pool`` raw
    bytes (over ``pool_cols`` columns) came from the pool and must never
    be reported as decompression."""

    enc: int  # encoded bytes physically read off storage
    raw: int  # raw bytes physically materialized by decode
    pool: int = 0  # raw bytes served from the decoded-block pool
    pool_cols: int = 0  # pooled columns in this read


# default decoded-block pool budget per store (bytes); 0 disables
DEFAULT_POOL_BYTES = 48 << 20


class BlockPool:
    """Byte-budgeted LRU of *decoded* columns keyed ``(DeltaKey, column)``.

    The buffer-pool-over-compressed-deltas design (Khurana & Deshpande):
    snapshot retrieval and compaction re-read the same hierarchy-path
    and eventlist blocks over and over; caching their decoded arrays
    turns those repeats into dictionary lookups — no storage I/O, no
    decompression, no checksum pass.  Entries are copied on insert and
    stored read-only: the cold-read caller keeps its own (possibly
    writeable) array, so no mutation can reach the pool, and a pooled
    column never pins the blob buffer it was decoded from.  Warm reads
    hand the read-only array out without copying (callers already
    tolerate read-only arrays — raw/zlib decodes are ``frombuffer``
    views).  The parsed per-key directory rides along so a fully pooled
    key is served with zero backend touches.
    """

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._lock = threading.Lock()
        self._cols: "collections.OrderedDict" = collections.OrderedDict()
        self._dirs: Dict[DeltaKey, List[serialize.ColumnMeta]] = {}
        self._by_key: Dict[DeltaKey, set] = defaultdict(set)
        # per-key write-version counter, monotonic for the pool's
        # lifetime (never reset, even on delete — a re-put must not
        # collide with a token captured before the delete).  Writers bump
        # it AFTER mutating the backend and BEFORE invalidating; readers
        # capture it BEFORE their physical read and pass it to ``put``/
        # ``dir_put``, which reject the fill on mismatch.  That closes
        # the read/invalidate race: a fill computed from pre-write bytes
        # can never land after the writer's invalidation.
        self._wver: Dict[DeltaKey, int] = {}
        self.bytes_cached = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0
        self.invalidations = 0
        self.stale_rejects = 0

    def get(self, key: DeltaKey, col: str) -> Optional[np.ndarray]:
        with self._lock:
            a = self._cols.get((key, col))
            if a is None:
                self.misses += 1
                return None
            self._cols.move_to_end((key, col))
            self.hits += 1
            return a

    def peek(self, key: DeltaKey, col: str) -> bool:
        """Residency probe without LRU promotion or hit/miss accounting
        (the planner's cost model asks, it doesn't read)."""
        with self._lock:
            return (key, col) in self._cols

    def write_version(self, key: DeltaKey) -> int:
        """Current write version of ``key`` — capture BEFORE a physical
        read, hand back to ``put``/``dir_put`` as ``ver=``."""
        with self._lock:
            return self._wver.get(key, 0)

    def bump_version(self, key: DeltaKey) -> None:
        """Writer-side: record that the backend bytes of ``key`` changed.
        Must happen after the backend mutation and before ``invalidate``."""
        with self._lock:
            self._wver[key] = self._wver.get(key, 0) + 1

    def put(self, key: DeltaKey, col: str, arr: np.ndarray,
            ver: Optional[int] = None) -> None:
        nb = int(arr.nbytes)
        if nb > self.budget:
            return  # larger than the whole pool: not cacheable
        # own copy, marked read-only: (a) a caller mutating its cold-read
        # array can never poison the pooled one, and (b) frombuffer views
        # into a whole blob would otherwise pin the entire encoded blob
        # while bytes_cached only counted the column
        arr = np.array(arr, copy=True)
        arr.flags.writeable = False
        with self._lock:
            if ver is not None and ver != self._wver.get(key, 0):
                self.stale_rejects += 1  # decoded from superseded bytes
                return
            k = (key, col)
            old = self._cols.pop(k, None)
            if old is not None:
                self.bytes_cached -= old.nbytes
            self._cols[k] = arr
            self._by_key[key].add(col)
            self.bytes_cached += nb
            self.inserts += 1
            while self.bytes_cached > self.budget and self._cols:
                (ek, ecol), ea = self._cols.popitem(last=False)
                self.bytes_cached -= ea.nbytes
                cols = self._by_key.get(ek)
                if cols is not None:
                    cols.discard(ecol)
                    if not cols:
                        del self._by_key[ek]
                        self._dirs.pop(ek, None)
                self.evictions += 1

    def dir_get(self, key: DeltaKey) -> Optional[List[serialize.ColumnMeta]]:
        with self._lock:
            return self._dirs.get(key)

    def dir_put(self, key: DeltaKey, entries: List[serialize.ColumnMeta],
                ver: Optional[int] = None) -> None:
        with self._lock:
            if ver is not None and ver != self._wver.get(key, 0):
                self.stale_rejects += 1  # directory of superseded bytes
                return
            self._dirs[key] = entries
            self._by_key.setdefault(key, set())

    def invalidate(self, key: DeltaKey) -> None:
        """Drop every pooled column (and the directory) of one key —
        called by ``put``/``delete`` so ingest and GC can never leave
        stale decoded blocks behind."""
        with self._lock:
            cols = self._by_key.pop(key, None)
            self._dirs.pop(key, None)
            if not cols:
                return
            for c in cols:
                a = self._cols.pop((key, c), None)
                if a is not None:
                    self.bytes_cached -= a.nbytes
            self.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            self._cols.clear()
            self._dirs.clear()
            self._by_key.clear()
            self.bytes_cached = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "budget_bytes": self.budget,
                "bytes_cached": self.bytes_cached,
                "entries": len(self._cols),
                "keys": len(self._by_key),
                "hits": self.hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "stale_rejects": self.stale_rejects,
            }


class DeltaStore:
    """m storage nodes, replication r, mem or file backend.  ``fmt``
    selects the on-disk block format ("TGI2" compressed columnar by
    default, "TGI1" raw); reads MAGIC-dispatch, so a store can read
    blobs of either format regardless of its write format.

    ``pool_bytes`` budgets the decoded-block buffer pool (0 disables);
    ``seek`` selects range-seek reads on the file backend (extent
    sidecars + per-column preads) vs whole-chunk-file slurps."""

    def __init__(self, m: int = 4, r: int = 1, backend: str = "mem",
                 root: Optional[str] = None, fmt: Optional[str] = None,
                 pool_bytes: int = DEFAULT_POOL_BYTES, seek: bool = True,
                 serve_cache_bytes: int = 8 << 20):
        assert 1 <= r <= m
        self.m, self.r = m, r
        self.backend = backend
        self.fmt = fmt or serialize.DEFAULT_FORMAT
        self.seek = seek
        self.pool: Optional[BlockPool] = (
            BlockPool(pool_bytes) if pool_bytes else None)
        self.down: set = set()
        self.stats = StoreStats()
        # per-DeltaKey (raw, encoded) bytes of the last write — the
        # storage-accounting source for TGI.storage_report()
        self.key_sizes: Dict[DeltaKey, Tuple[int, int]] = {}
        self._lock = threading.Lock()
        # epoch-tagged deferred GC: (publish_epoch, [keys]) batches from
        # MVCC maintenance, deletable only once every reader pinned below
        # publish_epoch has drained (TGI drives gc_drain on guard exit)
        self._gc_queue: List[Tuple[int, List[DeltaKey]]] = []
        # file-backend vacuum: generation counter bumped on every chunk
        # rewrite; lock-free readers holding a pre-rewrite extent table
        # retry once when they fail and the generation moved
        self._vacuum_gen = 0
        self._vacuum_lock = threading.Lock()
        # per-read pool-version token (set by ``get`` around its physical
        # read so the dir-fill deep in the read path can version-check)
        self._rd_tls = threading.local()
        # file backend: per-(node, placement) extent tables, lazily
        # loaded from the .tgx sidecars (or one legacy chunk scan)
        self._ext_cache: Dict[Tuple[int, Tuple[int, int]],
                              Dict[bytes, Tuple[int, int]]] = {}
        # file backend: cached read handles per chunk, shared between
        # reader threads via positioned reads (os.pread — no seek state).
        # Invalidation pops the handle WITHOUT closing it: in-flight
        # readers keep their reference alive (refcounting closes the old
        # inode once the last one returns), so an fd number can never be
        # recycled under a concurrent pread.
        self._fh_lock = threading.Lock()
        self._fh_cache: Dict[Tuple[int, Tuple[int, int]], object] = {}
        # encoded serve cache: assembled projected blocks keyed by
        # (node, placement, record, projection), validated against the
        # CURRENT extent record and vacuum generation on every hit —
        # appends move a rewritten key's extent (miss), vacuum bumps the
        # generation (wholesale miss) — so a stale blob is unservable
        self._serve_lock = threading.Lock()
        self._serve_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._serve_bytes = 0
        self.serve_cache_bytes = int(serve_cache_bytes)
        if backend == "mem":
            self._mem: List[Dict] = [dict() for _ in range(m)]
        else:
            assert root is not None
            self.root = Path(root)
            for i in range(m):
                (self.root / f"node{i}").mkdir(parents=True, exist_ok=True)

    # ---- placement ----
    def replicas(self, key: DeltaKey) -> List[int]:
        return replica_nodes(key.tsid, key.sid, self.m, self.r)

    def transport_stats(self) -> Dict:
        """Wire-transport view (in-flight depth, pipelined vs serial
        round trips).  Local backends have no transport: empty dict.
        ``RemoteDeltaStore`` overrides with live per-node mux state."""
        return {}

    # ---- failure injection / node health ----
    def fail_node(self, i: int):
        self.down.add(i)

    def heal_node(self, i: int):
        self.down.discard(i)

    def _node_ok(self, i: int) -> bool:
        """Whether node ``i`` is currently worth sending a request to.
        The local store only knows injected failures; RemoteDeltaStore
        additionally tracks cells whose last request failed (suspects,
        with a re-probe TTL)."""
        return i not in self.down

    def _mark_unavailable(self, i: int) -> None:
        """Health feedback from a failed read — no-op locally (injected
        failures are authoritative); the remote store marks the cell
        suspect so the next batch hedges straight to replicas."""

    def node_status(self) -> Dict:
        """Per-node health and live-data report, shared by local and
        remote stores (chaos tests assert cluster health through one
        shape): for each of the ``m`` nodes, whether it is up and the
        live keys / encoded bytes it hosts (replicas counted on every
        node holding them, from the write-time ``key_sizes``)."""
        with self._lock:
            items = list(self.key_sizes.items())
        return self._node_status_from(items)

    def _node_status_from(self, items) -> Dict:
        """``node_status`` computed from one caller-supplied snapshot of
        ``key_sizes.items()`` (so ``report_snapshot`` can derive every
        section from a single point-in-time copy)."""
        keys_per = [0] * self.m
        bytes_per = [0] * self.m
        for key, (_, enc) in items:
            for n in self.replicas(key):
                keys_per[n] += 1
                bytes_per[n] += enc
        nodes = [
            {"node": i, "up": self._node_ok(i), "live_keys": keys_per[i],
             "live_bytes": bytes_per[i]}
            for i in range(self.m)
        ]
        return {"m": self.m, "r": self.r, "backend": self.backend,
                "n_down": sum(1 for n in nodes if not n["up"]),
                "nodes": nodes}

    # ---- io ----
    def _chunk_path(self, node: int, placement) -> Path:
        tsid, sid = placement
        return self.root / f"node{node}" / f"ts{tsid}_s{sid}.tgi"

    def _extent_path(self, node: int, placement) -> Path:
        tsid, sid = placement
        return self.root / f"node{node}" / f"ts{tsid}_s{sid}.tgx"

    def _ext_record(self, node: int, placement, rec_key: bytes,
                    off: int, length: int) -> None:
        """Append one (key -> blob offset, length) extent to the sidecar
        and mirror it into the in-memory table.  A ``_TOMBSTONE`` length
        marks deletion.  Caller holds ``self._lock``."""
        with open(self._extent_path(node, placement), "ab") as f:
            f.write(len(rec_key).to_bytes(4, "little"))
            f.write(rec_key)
            f.write(off.to_bytes(8, "little"))
            f.write(length.to_bytes(8, "little"))
        cache = self._ext_cache.get((node, placement))
        if cache is not None:
            if length == _TOMBSTONE:
                cache.pop(rec_key, None)
            else:
                cache[rec_key] = (off, length)

    def _extents(self, node: int, placement) -> Dict[bytes, Tuple[int, int]]:
        """Extent table of one chunk: rec_key -> (blob offset, length),
        last record wins.  Loaded once from the ``.tgx`` sidecar — or,
        for a legacy chunk written without one, rebuilt by a single full
        scan — then kept current inline by put/delete."""
        ck = (node, placement)
        with self._lock:
            cache = self._ext_cache.get(ck)
            if cache is not None:
                return cache
            cache = {}
            epath = self._extent_path(node, placement)
            cpath = self._chunk_path(node, placement)
            if epath.exists():
                data = epath.read_bytes()
                self.stats.bytes_io += len(data)
                off = 0
                while off < len(data):
                    klen = int.from_bytes(data[off : off + 4], "little")
                    off += 4
                    k = bytes(data[off : off + klen])
                    off += klen
                    boff = int.from_bytes(data[off : off + 8], "little")
                    blen = int.from_bytes(data[off + 8 : off + 16], "little")
                    off += 16
                    if blen == _TOMBSTONE:
                        cache.pop(k, None)
                    else:
                        cache[k] = (boff, blen)
            elif cpath.exists():
                data = cpath.read_bytes()
                self.stats.bytes_io += len(data)
                off = 0
                while off < len(data):
                    klen = int.from_bytes(data[off : off + 4], "little")
                    off += 4
                    k = bytes(data[off : off + klen])
                    off += klen
                    blen = int.from_bytes(data[off : off + 8], "little")
                    off += 8
                    if blen == _TOMBSTONE:
                        cache.pop(k, None)
                        continue
                    cache[k] = (off, blen)
                    off += blen
            self._ext_cache[ck] = cache
            return cache

    def _chunk_file(self, node: int, placement):
        """Cached read handle of one chunk file (unbuffered, read via
        ``os.pread`` so concurrent readers never race a shared file
        position).  Raises ``FileNotFoundError`` when the chunk does not
        exist — callers translate to ``KeyMissing``."""
        ck = (node, placement)
        with self._fh_lock:
            f = self._fh_cache.get(ck)
        if f is not None:
            return f
        f = open(self._chunk_path(node, placement), "rb", buffering=0)
        with self._fh_lock:
            cur = self._fh_cache.setdefault(ck, f)
        if cur is not f:
            f.close()
        return cur

    @staticmethod
    def _pread_exact(fd: int, n: int, off: int) -> bytes:
        """Positioned read of exactly ``n`` bytes (short reads looped;
        a true EOF returns what exists, like ``file.read``)."""
        out = os.pread(fd, n, off)
        if len(out) == n or not out:
            return out
        parts = [out]
        got = len(out)
        while got < n:
            chunk = os.pread(fd, n - got, off + got)
            if not chunk:
                break
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def drop_chunk_caches(self, node: int, placement) -> None:
        """Invalidate every read-side cache over one chunk after its
        file was replaced wholesale (state transfer installs, external
        rewrites): extent table, read handle, and — via the generation
        bump — every encoded serve-cache entry sourced from it."""
        with self._lock:
            self._ext_cache.pop((node, placement), None)
            self._vacuum_gen += 1
        with self._fh_lock:
            self._fh_cache.pop((node, placement), None)

    def _serve_cache_get(self, node: int, placement, rec_key: bytes,
                         wkey, rec: Tuple[int, int]) -> Optional[bytes]:
        """Serve-cache hit iff the entry was assembled from the record
        the extent table points at RIGHT NOW (same offset/length, same
        vacuum generation) — anything else misses and re-reads."""
        k = (node, placement, rec_key, wkey)
        with self._serve_lock:
            ent = self._serve_cache.get(k)
            if ent is None:
                return None
            gen, erec, blob = ent
            if gen != self._vacuum_gen or erec != rec:
                del self._serve_cache[k]
                self._serve_bytes -= len(blob)
                return None
            self._serve_cache.move_to_end(k)
            return blob

    def _serve_cache_put(self, node: int, placement, rec_key: bytes,
                         wkey, rec: Tuple[int, int], blob: bytes) -> None:
        if len(blob) * 4 > self.serve_cache_bytes:
            return  # one giant block must not wipe the whole cache
        k = (node, placement, rec_key, wkey)
        with self._serve_lock:
            old = self._serve_cache.pop(k, None)
            if old is not None:
                self._serve_bytes -= len(old[2])
            self._serve_cache[k] = (self._vacuum_gen, rec, blob)
            self._serve_bytes += len(blob)
            while self._serve_bytes > self.serve_cache_bytes:
                _, (_, _, evicted) = self._serve_cache.popitem(last=False)
                self._serve_bytes -= len(evicted)

    def encode_payload(self, key: DeltaKey,
                       arrays: Dict[str, np.ndarray]) -> Tuple[bytes, int]:
        """Serialize one micro-delta to its stored block: ``(blob,
        raw_bytes)``.  Eventlists ('E:*') are the replay hot path —
        dozens of blobs per snapshot — so they encode under the
        latency-biased profile; hierarchy deltas and aux replicas (the
        bulk of the bytes, a few blobs per query) maximize compression.
        Split out of ``put`` so the remote client encodes ONCE and fans
        the same bytes out to every replica cell."""
        profile = "speed" if key.did.startswith("E:") else "size"
        blob = serialize.dumps(arrays, fmt=self.fmt, profile=profile)
        raw_bytes = sum(np.asarray(a).nbytes for a in arrays.values())
        return blob, raw_bytes

    def put(self, key: DeltaKey, arrays: Dict[str, np.ndarray]):
        blob, raw_bytes = self.encode_payload(key, arrays)
        self.put_encoded(key, blob, raw_bytes)

    def put_encoded(self, key: DeltaKey, blob: bytes, raw_bytes: int):
        """Store an already-encoded block verbatim.  This is the write
        primitive a StorageCell applies for wire PUTs and change-feed
        replay: because the bytes land untouched, every replica's chunk
        and extent files stay byte-identical to the writer's encoding —
        the property feed-based catch-up converges on."""
        wrote = False
        for node in self.replicas(key):
            if node in self.down:
                continue
            if self.backend == "mem":
                self._mem[node][key] = blob
            else:
                # chunk file per placement key: micro-deltas clustered by
                # delta key (append-style record: key line + length + blob)
                path = self._chunk_path(node, key.placement)
                rec_key = f"{key.did}|{key.pid}".encode()
                # chunk record + extent append under ONE lock hold, so
                # concurrent puts of a key can't leave the sidecar
                # pointing at a superseded blob.  Sidecars are written
                # regardless of this store's read mode so a later
                # seek=True open of the same root sees a complete
                # extent history.
                with self._lock:
                    with open(path, "ab") as f:
                        base = f.tell()
                        f.write(len(rec_key).to_bytes(4, "little"))
                        f.write(rec_key)
                        f.write(len(blob).to_bytes(8, "little"))
                        f.write(blob)
                    self._ext_record(node, key.placement, rec_key,
                                     base + 4 + len(rec_key) + 8, len(blob))
            wrote = True
        if not wrote:
            raise StorageNodeDown(f"all replicas down for {key}")
        if self.pool is not None:  # a rewrite must never serve stale blocks
            # bump-then-invalidate: the bump fences out in-flight readers
            # (their captured version no longer matches, so their decoded
            # pre-write blocks can't re-fill the pool after this
            # invalidation), the invalidation drops what's already cached
            self.pool.bump_version(key)
            self.pool.invalidate(key)
        with self._lock:
            self.stats.writes += 1
            self.stats.bytes_written += len(blob) * self.r
            self.stats.bytes_raw_written += raw_bytes * self.r
            self.key_sizes[key] = (raw_bytes, len(blob))

    def _read_node(self, node: int, key: DeltaKey) -> bytes:
        if self.backend == "mem":
            if key not in self._mem[node]:
                raise KeyMissing(key)
            return self._mem[node][key]
        path = self._chunk_path(node, key.placement)
        if not path.exists():
            raise KeyMissing(key)
        want = f"{key.did}|{key.pid}".encode()
        with open(path, "rb") as f:
            data = f.read()
        with self._lock:  # the whole-file slurp: every byte of the chunk
            self.stats.bytes_io += len(data)
        off = 0
        found = None
        while off < len(data):
            klen = int.from_bytes(data[off : off + 4], "little")
            off += 4
            k = data[off : off + klen]
            off += klen
            blen = int.from_bytes(data[off : off + 8], "little")
            off += 8
            if blen == _TOMBSTONE:  # deletion marker, no blob follows
                if k == want:
                    found = None
                continue
            if k == want:
                found = data[off : off + blen]  # last write wins
            off += blen
        if found is None:
            raise KeyMissing(key)
        return found

    def delete(self, key: DeltaKey) -> bool:
        """GC one micro-delta (span compaction's cleanup path): drops the
        key from every live replica — the mem backend pops, the file
        backend appends a tombstone record — and reverses the write
        accounting (``key_sizes`` forgets the key, so ``size_report`` and
        ``TGI.storage_report`` shrink; ``stats.bytes_deleted`` tracks the
        reclaimed encoded bytes).  Returns whether the key was live."""
        for node in self.replicas(key):
            if node in self.down:
                continue
            if self.backend == "mem":
                self._mem[node].pop(key, None)
            else:
                path = self._chunk_path(node, key.placement)
                if not path.exists():
                    continue
                rec_key = f"{key.did}|{key.pid}".encode()
                with self._lock:
                    with open(path, "ab") as f:
                        f.write(len(rec_key).to_bytes(4, "little"))
                        f.write(rec_key)
                        f.write(_TOMBSTONE.to_bytes(8, "little"))
                    self._ext_record(node, key.placement, rec_key,
                                     0, _TOMBSTONE)
        if self.pool is not None:  # GC'd blocks must never be served
            self.pool.bump_version(key)  # fence in-flight reader re-fills
            self.pool.invalidate(key)
        with self._lock:
            sizes = self.key_sizes.pop(key, None)
            if sizes is None:
                return False
            self.stats.n_deletes += 1
            self.stats.bytes_deleted += sizes[1] * self.r
        return True

    # ---- epoch-deferred GC (MVCC maintenance) ----

    def delete_deferred(self, keys: Iterable[DeltaKey], epoch: int) -> int:
        """Queue superseded keys for GC, tagged with the epoch at which
        they stopped being reachable (the maintenance pass's post-publish
        ``read_epoch``).  They stay readable until ``gc_drain`` proves no
        pinned reader can still reach them."""
        keys = list(keys)
        if not keys:
            return 0
        with self._lock:
            self._gc_queue.append((int(epoch), keys))
        return len(keys)

    def gc_pending(self) -> int:
        """Keys queued for GC but not yet reclaimed (pinned readers, or
        no drain since the last publish)."""
        with self._lock:
            return sum(len(ks) for _, ks in self._gc_queue)

    def gc_drain(self, min_pinned_epoch: Optional[int] = None,
                 ) -> Tuple[int, int]:
        """Reclaim every queued batch whose tag epoch is safe: a batch
        tagged E was superseded by the publish that bumped the epoch *to*
        E, so a reader pinned at E or later only sees the replacement
        layout — the batch is deletable once ``min_pinned_epoch >= E``
        (or nothing is pinned at all).  Batches are epoch-ordered (the
        queue is append-only under a monotonic epoch), so the drain stops
        at the first unsafe batch.  Returns ``(keys_deleted,
        encoded_bytes_deleted)``.  A crash mid-batch (``compact.mid_gc``
        fault point) re-queues the undeleted remainder, so a retried
        drain converges instead of leaking."""
        deleted, freed = 0, 0
        while True:
            with self._lock:
                if not self._gc_queue:
                    break
                epoch, keys = self._gc_queue[0]
                if min_pinned_epoch is not None and min_pinned_epoch < epoch:
                    break  # a pinned reader may still reach this batch
                self._gc_queue.pop(0)
            idx = 0
            try:
                for idx, k in enumerate(keys):
                    faultpoints.fire("compact.mid_gc")
                    with self._lock:
                        sz = self.key_sizes.get(k)
                    if self.delete(k):
                        deleted += 1
                        freed += (sz[1] * self.r) if sz else 0
            except BaseException:
                with self._lock:  # keys[idx] was not deleted: keep it
                    self._gc_queue.insert(0, (epoch, keys[idx:]))
                raise
        return deleted, freed

    def live_bytes(self) -> int:
        """Encoded bytes currently live on the store (x replication) —
        unlike ``stats.bytes_written`` this shrinks after GC."""
        with self._lock:
            return sum(enc for _, enc in self.key_sizes.values()) * self.r

    def _dir_ver(self, key: DeltaKey) -> Optional[int]:
        """The pool write-version ``get`` captured before this thread's
        in-flight physical read of ``key`` (None when the read did not
        come through ``get`` — then the fill is unchecked, matching the
        callers that never race a writer)."""
        cur = getattr(self._rd_tls, "cur", None)
        if cur is not None and cur[0] == key:
            return cur[1]
        return None

    def _pool_dir_fill(self, key: DeltaKey, blob: bytes) -> None:
        if self.pool is not None and self.pool.dir_get(key) is None:
            self.pool.dir_put(key, serialize.walk(blob),
                              ver=self._dir_ver(key))

    def _read_columns(self, node: int, key: DeltaKey,
                      fields: Optional[Tuple[str, ...]],
                      ) -> Tuple[Dict[str, np.ndarray], int, int]:
        """Physically read + decode the requested columns from one
        replica; returns ``(arrays, enc_read, raw_read)`` and caches the
        block directory in the pool."""
        if self.backend == "file" and self.seek:
            return self._read_columns_seek(node, key, fields)
        blob = self._read_node(node, key)
        arrays, enc_read, raw_read = serialize.loads_sized(blob, fields=fields)
        self._pool_dir_fill(key, blob)
        return arrays, enc_read, raw_read

    # prefix read size for range-seek blob reads: one pread that covers
    # the whole TGI2 directory for any realistic column count (~40 bytes
    # per entry), grown geometrically for the rare block that overflows
    _DIR_PREFIX = 4096

    def _read_columns_seek(self, node: int, key: DeltaKey,
                           fields: Optional[Tuple[str, ...]],
                           ) -> Tuple[Dict[str, np.ndarray], int, int]:
        """Range-seek read with one vacuum retry: readers are lock-free
        against ``vacuum()``'s chunk rewrites, so a reader holding a
        pre-rewrite extent table can seek into relocated bytes — every
        such landing fails loudly (crc32 mismatch -> BlockCorruption,
        short read -> truncated directory, dropped extent -> KeyMissing).
        If the vacuum generation moved during the read, retry once
        against the refreshed extents; a failure with an unmoved
        generation is a real error and propagates."""
        gen0 = self._vacuum_gen
        try:
            return self._read_columns_seek_raw(node, key, fields)
        except (KeyMissing, BlockCorruption, ValueError, OSError):
            if self._vacuum_gen == gen0:
                raise
            return self._read_columns_seek_raw(node, key, fields)

    def _read_columns_seek_raw(self, node: int, key: DeltaKey,
                               fields: Optional[Tuple[str, ...]],
                               ) -> Tuple[Dict[str, np.ndarray], int, int]:
        """Range-seek read: extent lookup -> directory prefix pread ->
        one pread per requested column.  Unrequested columns cost zero
        file bytes (``stats.bytes_io`` counts exactly what was read)."""
        ext = self._extents(node, key.placement)
        rec = ext.get(f"{key.did}|{key.pid}".encode())
        if rec is None:
            raise KeyMissing(key)
        off, blen = rec
        io_bytes = 0
        try:
            fd = self._chunk_file(node, key.placement).fileno()
        except FileNotFoundError:
            raise KeyMissing(key) from None
        prefix = self._pread_exact(fd, min(blen, self._DIR_PREFIX), off)
        io_bytes += len(prefix)
        if bytes(prefix[:4]) == serialize.MAGIC:
            # TGI1 interleaves headers with payloads: no seekable
            # directory — fall back to reading this blob in full
            blob = prefix + self._pread_exact(
                fd, blen - len(prefix), off + len(prefix))
            io_bytes += max(blen - len(prefix), 0)
            arrays, enc_read, raw_read = serialize.loads_sized(
                blob, fields=fields)
            self._pool_dir_fill(key, blob)
            with self._lock:
                self.stats.bytes_io += io_bytes
            return arrays, enc_read, raw_read
        entries = serialize.parse_directory(prefix)
        while entries is None and len(prefix) < blen:
            more = self._pread_exact(
                fd, min(blen - len(prefix), len(prefix)),
                off + len(prefix))
            if not more:
                break
            prefix += more
            io_bytes += len(more)
            entries = serialize.parse_directory(prefix)
        if entries is None:
            raise BlockCorruption(f"truncated TGI2 directory for {key}")
        if self.pool is not None and self.pool.dir_get(key) is None:
            self.pool.dir_put(key, entries, ver=self._dir_ver(key))
        want = None if fields is None else set(fields)
        arrays: Dict[str, np.ndarray] = {}
        enc_read, raw_read = 8, 0
        view = memoryview(prefix)
        for e in entries:
            if want is not None and e.name not in want:
                continue
            if e.off + e.length <= len(prefix):
                payload = view[e.off : e.off + e.length]
            else:
                payload = self._pread_exact(fd, e.length, off + e.off)
                io_bytes += e.length
            arrays[e.name] = serialize.decode_entry(e, payload)
            enc_read += e.length
            raw_read += arrays[e.name].nbytes
        with self._lock:
            self.stats.bytes_io += io_bytes
        return arrays, enc_read, raw_read

    def get(self, key: DeltaKey,
            fields: Optional[Iterable[str]] = None,
            sizes: Optional[Dict[DeltaKey, "ReadSizes"]] = None,
            ) -> Dict[str, np.ndarray]:
        """Read one micro-delta.  ``fields`` projects the read to the named
        arrays: unrequested columns are seeked over via the block directory
        (never decompressed or materialized — and on the range-seek file
        backend never even read off disk); only the projected bytes count
        toward ``stats.bytes_read`` (the storage end of the planner's
        projection pushdown).

        Columns resident in the decoded-block pool are served from it:
        no storage I/O, no decode, no checksum pass.  ``sizes``, if
        given, is filled with this key's ``ReadSizes`` — the physical
        (enc, raw) bytes vs the pool-served bytes, the FetchCost
        accounting side-channel (pool hits are never reported as
        physical decodes)."""
        want = None if fields is None else tuple(fields)
        pooled: Dict[str, np.ndarray] = {}
        pool_raw = 0
        need = want
        if self.pool is not None:
            entries = self.pool.dir_get(key)
            if entries is not None:
                wset = None if want is None else set(want)
                targets = [e.name for e in entries
                           if wset is None or e.name in wset]
                missing = []
                for n in targets:
                    a = self.pool.get(key, n)
                    if a is None:
                        missing.append(n)
                    else:
                        pooled[n] = a
                        pool_raw += a.nbytes
                if not missing:  # fully pooled: zero backend touches
                    with self._lock:
                        self.stats.reads += 1
                        self.stats.pool_hits += len(pooled)
                        self.stats.bytes_pool_served += pool_raw
                    if sizes is not None:
                        sizes[key] = ReadSizes(0, 0, pool_raw, len(pooled))
                    return dict(pooled)
                need = tuple(missing)
        last_err: Exception = KeyMissing(key)
        # version token captured BEFORE the physical read: if a writer
        # rewrites/deletes this key while we read, the pool rejects our
        # (now stale) fill instead of resurrecting superseded blocks
        tok = self.pool.write_version(key) if self.pool is not None else None
        self._rd_tls.cur = (key, tok)
        try:
            for j, node in enumerate(self.replicas(key)):
                if not self._node_ok(node):
                    with self._lock:
                        self.stats.failovers += j > 0 or self.r == 1
                    continue
                try:
                    arrays, enc_read, raw_read = self._read_columns(
                        node, key, need)
                except KeyMissing as e:
                    last_err = e
                    continue
                except BlockCorruption as e:
                    # a corrupt replica is as dead as a down one: fail over
                    # to the next copy (the error surfaces only when every
                    # replica is corrupt or missing)
                    last_err = e
                    with self._lock:
                        self.stats.failovers += 1
                    continue
                except NodeUnavailable as e:
                    # an unreachable cell (remote backend): mark it suspect
                    # so the rest of the batch hedges, and fail over
                    last_err = e
                    self._mark_unavailable(node)
                    with self._lock:
                        self.stats.failovers += 1
                    continue
                with self._lock:
                    self.stats.reads += 1
                    self.stats.bytes_read += enc_read
                    self.stats.bytes_decompressed += raw_read
                    if self.pool is not None:
                        self.stats.pool_hits += len(pooled)
                        self.stats.pool_misses += len(arrays)
                        self.stats.bytes_pool_served += pool_raw
                    if j > 0:
                        self.stats.failovers += 1
                if self.pool is not None:
                    for n, a in arrays.items():
                        self.pool.put(key, n, a, ver=tok)
                if sizes is not None:
                    sizes[key] = ReadSizes(enc_read, raw_read, pool_raw,
                                           len(pooled))
                if pooled:
                    arrays = {**pooled, **arrays}
                return arrays
        finally:
            self._rd_tls.cur = None
        if isinstance(last_err, (KeyMissing, BlockCorruption)):
            raise last_err
        raise StorageNodeDown(f"no live replica for {key}")

    def clear_pool(self) -> None:
        """Drop every decoded block (``TGI.invalidate_caches()`` full
        path and cold-read benchmarking)."""
        if self.pool is not None:
            self.pool.clear()

    def pool_stats(self) -> Dict[str, int]:
        return self.pool.stats() if self.pool is not None else {}

    def pool_residency(self, key: DeltaKey) -> float:
        """Fraction of ``key``'s columns currently pooled (0.0 when the
        key has never been read) — the planner's pool-awareness hook for
        discounting warm blocks in fetch-cost estimates."""
        if self.pool is None:
            return 0.0
        entries = self.pool.dir_get(key)
        if not entries:
            return 0.0
        present = sum(1 for e in entries if self.pool.peek(key, e.name))
        return present / len(entries)

    def multiget(self, keys: Iterable[DeltaKey], c: int = 1,
                 fields: Optional[Iterable[str]] = None,
                 missing_ok: bool = False,
                 sizes: Optional[Dict[DeltaKey, "ReadSizes"]] = None,
                 ) -> Dict[DeltaKey, Dict]:
        """Parallel fetch with c clients (paper Fig. 11/12's c parameter).
        Keys are grouped by their primary replica node and each group is
        drained as one batch, so concurrent clients hit distinct nodes —
        the paper's direct QP->storage parallelism (keys sharing a
        primary share the whole replica chain, so a group fails over as
        a unit).  A group whose primary is known-unavailable at batch
        start is *hedged*: every key goes straight to the fallback
        replicas in one batch instead of rediscovering the dead node per
        key (``StoreStats.hedged_reads`` counts them).  With
        ``missing_ok`` absent keys are skipped instead of raising (sparse
        key spaces like per-shard eventlists); node failures still raise."""
        keys = list(keys)
        groups: Dict[int, List[DeltaKey]] = {}
        for k in keys:
            groups.setdefault(self.replicas(k)[0], []).append(k)
        out: Dict[DeltaKey, Dict] = {}
        if c <= 1 or len(groups) == 1:
            for primary, gkeys in groups.items():
                out.update(self._group_fetch(primary, gkeys, fields,
                                             missing_ok, sizes))
            return out
        with cf.ThreadPoolExecutor(max_workers=c) as ex:
            futs = [
                ex.submit(self._group_fetch, primary, gkeys, fields,
                          missing_ok, sizes)
                for primary, gkeys in groups.items()
            ]
            for fut in cf.as_completed(futs):
                out.update(fut.result())
        return out

    def _group_fetch(self, primary: int, gkeys: List[DeltaKey],
                     fields: Optional[Iterable[str]], missing_ok: bool,
                     sizes: Optional[Dict[DeltaKey, "ReadSizes"]],
                     ) -> Dict[DeltaKey, Dict]:
        """Fetch one primary-node group of a multiget.  The base store
        reads key by key (``get`` already fails over); the remote store
        overrides this with one wire MULTIGET frame per replica tier.
        Either way, an unavailable primary is detected once for the
        whole group — the keys are hedged to the replicas as a batch."""
        if not self._node_ok(primary):
            with self._lock:
                self.stats.hedged_reads += len(gkeys)
        out: Dict[DeltaKey, Dict] = {}
        for k in gkeys:
            try:
                out[k] = self.get(k, fields=fields, sizes=sizes)
            except KeyMissing:
                if not missing_ok:
                    raise
        return out

    # ---- encoded (no-decode) reads: the service plane's serving path ----

    def get_encoded(self, key: DeltaKey,
                    fields: Optional[Iterable[str]] = None) -> bytes:
        """Projected block read *without decoding*: returns a TGI2 block
        whose directory lists every column of the stored blob but whose
        payload section carries only the requested columns' encoded
        bytes, copied verbatim.  This is what a StorageCell serves for a
        wire GET — the cell never decompresses, per-column crc32s ride
        along unchanged (the client verifies on decode), and on the
        range-seek file backend only the projected columns' byte ranges
        are read off disk (``stats.bytes_io`` measures exactly that).
        Assembled blocks land in the encoded serve cache, so a cell
        re-serving a hot key skips file io AND re-assembly — the cached
        bytes are only ever served while the key's extent record (and
        the vacuum generation) are exactly what they were at assembly
        time, so a rewrite or compaction can never serve stale bytes."""
        want = None if fields is None else set(fields)
        wkey = None if want is None else frozenset(want)
        seekable = self.backend == "file" and self.seek
        rec_key = f"{key.did}|{key.pid}".encode() if seekable else b""
        last_err: Exception = KeyMissing(key)
        for j, node in enumerate(self.replicas(key)):
            if not self._node_ok(node):
                with self._lock:
                    self.stats.failovers += j > 0 or self.r == 1
                continue
            rec = None
            if seekable:
                rec = self._extents(node, key.placement).get(rec_key)
                if rec is not None:
                    blob = self._serve_cache_get(
                        node, key.placement, rec_key, wkey, rec)
                    if blob is not None:
                        with self._lock:
                            self.stats.reads += 1
                            self.stats.bytes_read += len(blob)
                            self.stats.serve_hits += 1
                            if j > 0:
                                self.stats.failovers += 1
                        return blob
            try:
                entries, payloads, enc_read = self._read_encoded(
                    node, key, want)
            except KeyMissing as e:
                last_err = e
                continue
            except BlockCorruption as e:
                last_err = e
                with self._lock:
                    self.stats.failovers += 1
                continue
            with self._lock:
                self.stats.reads += 1
                self.stats.bytes_read += enc_read
                self.stats.serve_misses += seekable
                if j > 0:
                    self.stats.failovers += 1
            blob = serialize.assemble_block(entries, payloads)
            if rec is not None:
                self._serve_cache_put(
                    node, key.placement, rec_key, wkey, rec, blob)
            return blob
        if isinstance(last_err, (KeyMissing, BlockCorruption)):
            raise last_err
        raise StorageNodeDown(f"no live replica for {key}")

    def _read_encoded(self, node: int, key: DeltaKey,
                      want: Optional[set],
                      ) -> Tuple[List[serialize.ColumnMeta],
                                 Dict[str, bytes], int]:
        """Read one replica's directory plus the wanted columns' encoded
        payload bytes — no decode, no checksum pass (the reader
        verifies).  Returns ``(all entries, {name: payload}, enc_read)``."""
        if self.backend == "file" and self.seek:
            return self._read_encoded_seek(node, key, want)
        blob = memoryview(self._read_node(node, key))
        entries = serialize.walk(blob)
        payloads = {
            e.name: bytes(blob[e.off : e.off + e.length])
            for e in entries if want is None or e.name in want
        }
        enc_read = 8 + sum(len(p) for p in payloads.values())
        return entries, payloads, enc_read

    def _read_encoded_seek(self, node: int, key: DeltaKey,
                           want: Optional[set],
                           ) -> Tuple[List[serialize.ColumnMeta],
                                      Dict[str, bytes], int]:
        """Range-seek twin of ``_read_encoded`` with the same one-shot
        vacuum retry as ``_read_columns_seek``."""
        gen0 = self._vacuum_gen
        try:
            return self._read_encoded_seek_raw(node, key, want)
        except (KeyMissing, BlockCorruption, ValueError, OSError):
            if self._vacuum_gen == gen0:
                raise
            return self._read_encoded_seek_raw(node, key, want)

    def _read_encoded_seek_raw(self, node: int, key: DeltaKey,
                               want: Optional[set],
                               ) -> Tuple[List[serialize.ColumnMeta],
                                          Dict[str, bytes], int]:
        """Range-seek twin of ``_read_encoded``: extent lookup ->
        directory prefix pread -> one pread per wanted column.
        Unrequested columns cost zero file bytes."""
        ext = self._extents(node, key.placement)
        rec = ext.get(f"{key.did}|{key.pid}".encode())
        if rec is None:
            raise KeyMissing(key)
        off, blen = rec
        io_bytes = 0
        try:
            fd = self._chunk_file(node, key.placement).fileno()
        except FileNotFoundError:
            raise KeyMissing(key) from None
        prefix = self._pread_exact(fd, min(blen, self._DIR_PREFIX), off)
        io_bytes += len(prefix)
        if bytes(prefix[:4]) == serialize.MAGIC:
            # TGI1: headers interleave with payloads — full read
            blob = prefix + self._pread_exact(
                fd, blen - len(prefix), off + len(prefix))
            io_bytes += max(blen - len(prefix), 0)
            with self._lock:
                self.stats.bytes_io += io_bytes
            blob_v = memoryview(blob)
            entries = serialize.walk(blob_v)
            payloads = {
                e.name: bytes(blob_v[e.off : e.off + e.length])
                for e in entries if want is None or e.name in want
            }
            return entries, payloads, 8 + sum(
                len(p) for p in payloads.values())
        entries = serialize.parse_directory(prefix)
        while entries is None and len(prefix) < blen:
            more = self._pread_exact(
                fd, min(blen - len(prefix), len(prefix)),
                off + len(prefix))
            if not more:
                break
            prefix += more
            io_bytes += len(more)
            entries = serialize.parse_directory(prefix)
        if entries is None:
            raise BlockCorruption(f"truncated TGI2 directory for {key}")
        view = memoryview(prefix)
        payloads: Dict[str, bytes] = {}
        for e in entries:
            if want is not None and e.name not in want:
                continue
            if e.off + e.length <= len(prefix):
                payloads[e.name] = bytes(view[e.off : e.off + e.length])
            else:
                payloads[e.name] = self._pread_exact(
                    fd, e.length, off + e.off)
                io_bytes += e.length
        with self._lock:
            self.stats.bytes_io += io_bytes
        return entries, payloads, 8 + sum(len(p) for p in payloads.values())

    def size_report(self) -> Dict[str, Dict[str, int]]:
        """Raw vs. encoded bytes per did component, from the per-key
        write accounting (one entry per logical key — multiply by ``r``
        for on-disk bytes).  Components are the did prefixes: ``E``
        eventlists, ``S`` hierarchy deltas, ``X`` aux replicas, and the
        literal did for anything else (checkpoint blocks, manifests)."""
        with self._lock:
            items = list(self.key_sizes.items())
        return self._size_report_from(items)

    @staticmethod
    def _size_report_from(items) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for key, (raw, enc) in items:
            comp = key.did.split(":", 1)[0]
            row = out.setdefault(comp, {"raw": 0, "encoded": 0, "count": 0})
            row["raw"] += raw
            row["encoded"] += enc
            row["count"] += 1
        return out

    def report_snapshot(self) -> Dict:
        """Every storage-accounting section — per-component sizes, per-
        node live data, total live bytes, GC backlog — derived from ONE
        point-in-time copy of the write accounting taken under the store
        lock.  ``TGI.storage_report`` builds on this so a report taken
        mid-compaction is internally consistent: its sections can never
        mix pre- and post-publish states of ``key_sizes``."""
        with self._lock:
            items = list(self.key_sizes.items())
            gc_pending = sum(len(ks) for _, ks in self._gc_queue)
        return {
            "size_report": self._size_report_from(items),
            "node_status": self._node_status_from(items),
            "live_bytes": sum(enc for _, (_, enc) in items) * self.r,
            "gc_pending_keys": gc_pending,
        }

    def keys_for_placement(self, tsid: int, sid: int) -> List[DeltaKey]:
        """Enumerate stored micro-delta keys under one placement chunk."""
        if self.backend == "mem":
            ks = set()
            for node in range(self.m):
                for k in self._mem[node]:
                    if k.placement == (tsid, sid):
                        ks.add(k)
            return sorted(ks)
        ks = set()
        for node in range(self.m):
            path = self._chunk_path(node, (tsid, sid))
            if not path.exists():
                continue
            with open(path, "rb") as f:
                data = f.read()
            off = 0
            while off < len(data):
                klen = int.from_bytes(data[off : off + 4], "little")
                off += 4
                k = data[off : off + klen].decode()
                off += klen
                blen = int.from_bytes(data[off : off + 8], "little")
                off += 8
                did, pid = k.rsplit("|", 1)
                if blen == _TOMBSTONE:  # deleted (last record wins)
                    ks.discard(DeltaKey(tsid, sid, did, int(pid)))
                    continue
                off += blen
                ks.add(DeltaKey(tsid, sid, did, int(pid)))
        return sorted(ks)

    def vacuum(self, canonical: bool = False) -> Dict[str, int]:
        """File-backend chunk compaction: rewrite each chunk with only
        its live (non-tombstoned, non-superseded) records, dropping the
        garbage that append-only puts and tombstone deletes accumulate.
        This is the maintenance a StorageCell runs in the background on a
        MAINT request — it must not refuse traffic, so each chunk is
        rewritten under ONE hold of the store lock (writers queue behind
        it briefly); lock-free readers that raced the rename retry once
        via the vacuum-generation check in the seek readers.  The rewrite
        goes through a temp file + ``os.replace`` so a crash mid-vacuum
        (``cell.vacuum`` fault point) leaves every chunk either fully old
        or fully new — both readable.  Returns rewrite counters.

        ``canonical=True`` additionally orders each rewritten chunk's
        live records by record key instead of preserving their append
        offsets, making the chunk bytes a pure function of the live
        record *set* — the byte-identical-convergence anchor when N
        concurrent writer lanes interleave differently per replica (the
        default arrival-order rewrite is only deterministic under a
        single writer).  Idempotent: a chunk already in canonical form
        is left untouched."""
        out = {"chunks_scanned": 0, "chunks_rewritten": 0,
               "chunks_removed": 0, "bytes_before": 0, "bytes_after": 0}
        if self.backend != "file":
            return out
        with self._vacuum_lock:  # one vacuum at a time
            for node in range(self.m):
                ndir = self.root / f"node{node}"
                for cpath in sorted(ndir.glob("ts*_s*.tgi")):
                    stem = cpath.stem  # ts{tsid}_s{sid}
                    try:
                        tsid_s, sid_s = stem[2:].split("_s")
                        placement = (int(tsid_s), int(sid_s))
                    except ValueError:
                        continue
                    faultpoints.fire("cell.vacuum")
                    self._extents(node, placement)  # ensure table loaded
                    with self._lock:
                        out["chunks_scanned"] += 1
                        cache = self._ext_cache.get((node, placement), {})
                        try:
                            data = cpath.read_bytes()
                        except OSError:
                            continue
                        out["bytes_before"] += len(data)
                        epath = self._extent_path(node, placement)
                        if not cache:  # fully dead: drop chunk + sidecar
                            cpath.unlink(missing_ok=True)
                            epath.unlink(missing_ok=True)
                            self._ext_cache.pop((node, placement), None)
                            with self._fh_lock:
                                self._fh_cache.pop((node, placement), None)
                            self._vacuum_gen += 1
                            out["chunks_removed"] += 1
                            continue
                        parts: List[bytes] = []
                        new_cache: Dict[bytes, Tuple[int, int]] = {}
                        pos = 0
                        order = (sorted(cache.items())  # by record key
                                 if canonical else
                                 sorted(cache.items(), key=lambda kv: kv[1][0]))
                        for rec_key, (boff, blen) in order:
                            blob = data[boff:boff + blen]
                            if len(blob) != blen:
                                continue  # torn extent: drop the record
                            rec = (len(rec_key).to_bytes(4, "little")
                                   + rec_key
                                   + blen.to_bytes(8, "little") + blob)
                            new_cache[rec_key] = (
                                pos + 4 + len(rec_key) + 8, blen)
                            parts.append(rec)
                            pos += len(rec)
                        new_data = b"".join(parts)
                        if new_data == data:
                            out["bytes_after"] += len(new_data)
                            continue  # already exact: leave untouched
                        tmp_c = cpath.parent / (cpath.name + ".tmp")
                        tmp_c.write_bytes(new_data)
                        ext_parts = []
                        for rec_key, (boff, blen) in new_cache.items():
                            ext_parts.append(
                                len(rec_key).to_bytes(4, "little") + rec_key
                                + boff.to_bytes(8, "little")
                                + blen.to_bytes(8, "little"))
                        tmp_e = epath.parent / (epath.name + ".tmp")
                        tmp_e.write_bytes(b"".join(ext_parts))
                        os.replace(tmp_c, cpath)
                        os.replace(tmp_e, epath)
                        self._ext_cache[(node, placement)] = new_cache
                        with self._fh_lock:
                            self._fh_cache.pop((node, placement), None)
                        self._vacuum_gen += 1
                        out["chunks_rewritten"] += 1
                        out["bytes_after"] += len(new_data)
                        self.stats.bytes_io += len(data) + len(new_data)
        return out
