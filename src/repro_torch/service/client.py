"""RemoteDeltaStore: the local ``DeltaStore`` surface over wire cells.

A drop-in store whose ``m`` nodes are ``StorageCell`` servers reached
over sockets — ``TGI``, the PlanExecutor fetch stage, and the
decoded-block pool run on top of it unchanged, because everything
above the physical-I/O layer is *inherited*: placement, replica
failover, the pool preamble, projection, and stats all come from
``DeltaStore``; this class only swaps dict/file reads for wire frames.

**Transport: a per-node connection multiplexer.**  Each node gets one
socket (dialed lazily, HELLO handshake once per connection) shared by
every concurrent request: a background reader thread demuxes reply
frames to waiting futures by ``req_id``, so replies complete out of
order and a slow GET never head-of-line-blocks a PING.  In-flight
requests per node are bounded by a window semaphore (backpressure: a
submitter blocks, within its deadline, until a slot frees).  Deadlines
are wall-clock from *enqueue* — queue wait, connect, send, and reply
all spend the same budget — and an expired request cancels its future
WITHOUT poisoning the connection: the late reply is drained and
dropped by the reader, the slot frees on that terminal frame, and
every other in-flight request proceeds untouched.  A dead connection
fails all its pending futures with ``NodeUnavailable``; the request
wrapper transparently re-dials and re-issues *idempotent* requests
only (GET/MULTIGET/PING/STATUS/KEYS/FEED_SINCE/...) with bounded
backoff — writes fail loudly after one attempt and rely on the
seq-dedup'd redelivery queue, never on silent transport replays.
Idle connections (mux and the serial fallback pool) are reaped after
``idle_ttl``.  Pass ``pipeline=False`` for the pre-multiplexer
behavior: one checked-out connection per request — kept as the bench
baseline and as a fallback.

Read path: ``_read_columns`` issues one GET per key (fields pushed
through the wire, so the cell preads only the projected columns) and
decodes the TGI2 reply client-side — a reply that fails its per-column
crc32 raises ``BlockCorruption``, which the inherited ``get`` treats
as a dead replica and fails over, extending corrupt-replica failover
across the process boundary.  ``multiget`` fans out every replica-tier
group *concurrently* across nodes on the muxes — hedged reads ride the
same futures — and consumes the streamed CHUNK replies as they arrive,
decoding and filling the BlockPool while the cells are still reading
later keys.  A cell that stays unreachable is marked *suspect* for
``suspect_ttl`` seconds so subsequent reads skip it without paying the
timeout again, then re-probed.

Write path: **lease-fenced multi-writer**.  Before its first write the
client acquires a time-bounded *writer lease* from a cell quorum
(``m//2 + 1`` grants): a monotonic **fencing epoch** that names this
writer incarnation's *lane*.  Every ``put``/``delete`` is stamped with
a *vseq* — ``(epoch, seq)`` packed into one u64 — and fanned out to
the key's replica cells while the writer lock is held; within a lane
seqs are monotone, so every cell receives this writer's records in
order, and across lanes the u64 vseq order is the cluster-wide total
order that makes N concurrent writers' feeds merge deterministically
(restart catch-up stays byte-identical).  Accepted writes double as
the lease heartbeat; a background thread renews explicitly every
``lease_ttl/3`` so an idle writer stays live.  A cell that has sealed
the lane (this writer was presumed dead and reconciled away) rejects
the write with the typed ``LeaseFenced`` — never silently applied —
and the client invalidates its lease and re-acquires a fresh epoch for
the next write.  When no quorum is reachable the client **degrades to
read-only**: writes raise the typed ``WriteUnavailable`` *immediately*
(no network attempt, no hang) while reads keep failing over, and the
renewal thread re-acquires automatically once a quorum returns.

A write (put OR delete) succeeds only when at least one replica cell
accepted it — otherwise it raises ``StorageNodeDown`` with the local
accounting untouched.  A replica that missed an acknowledged write
(down, suspect, or a transient failure) gets the record queued on a
per-node *redelivery queue*: the queue is drained, in vseq order,
before that node serves any further read or receives any further write
from this client, so a cell with an interior feed gap this client
created can never serve it a stale version — and a restarting cell
additionally repairs gaps from any writer via the feed ``catch_up``
pull.  A queued record whose lane got sealed in the meantime is
dropped at drain time (``fence_drops``): the reconciliation that
sealed the lane already anti-entropied the records that mattered.

Every write and ``quiesce`` piggybacks the client's *ack watermark* —
the highest own-lane vseq below which no redelivery is queued, i.e.
every cell provably holds everything it owns — which is what lets
cells truncate ``feed.log`` per lane (see ``StorageCell``).  A
hard-killed writer obviously stops acking; its lane's floor is
un-stranded by lease-expiry reconciliation instead.  ``close()``
releases the lease cleanly (sealing the lane at its final seq) when
every own-lane redelivery has drained, so well-behaved exits don't
wait out the TTL.

Attach is read-only and lazy: no probe, no seq resume — a fresh epoch
starts its lane at seq 0, so nothing this writer stamps can collide
with history.  Transport retries across the client (mux redial, serial
fallback, lease acquisition) share one jittered ``Backoff`` helper
with per-call deadline caps.

With ``auth_key`` set, every dialed connection answers the cell's
HELLO challenge with ``HMAC-SHA256(key, nonce)`` before any other
frame; a wrong or missing key surfaces as the typed ``AuthFailed``
(never retried, never wrapped into ``NodeUnavailable``).
"""
from __future__ import annotations

import hashlib
import hmac
import random
import socket
import struct
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.service import wire
from repro_torch.storage import serialize
from repro_torch.storage.kvstore import (DEFAULT_POOL_BYTES, BlockCorruption,
                                   DeltaKey, DeltaStore, KeyMissing,
                                   NodeUnavailable, ReadSizes,
                                   StorageNodeDown, WriteUnavailable,
                                   make_vseq, replica_nodes, split_vseq)

# message types the transport may re-issue transparently after a
# reconnect: read-only (or seq-dedup'd maintenance) requests.  PUT and
# DELETE are deliberately absent — a write gets ONE transport attempt
# and then fails loudly into the redelivery queue, so a retry can never
# materialize a write the caller saw fail.  LEASE and RECONCILE are
# idempotent by construction (grants/seals are keyed by epoch and
# monotone), so a replayed frame converges to the same state.
_IDEMPOTENT = frozenset({
    wire.MSG_HELLO, wire.MSG_PING, wire.MSG_GET, wire.MSG_MULTIGET,
    wire.MSG_STATUS, wire.MSG_KEYS, wire.MSG_FEED_SINCE, wire.MSG_MAINT,
    wire.MSG_PLACEMENTS, wire.MSG_STATE_PULL, wire.MSG_LEASE,
    wire.MSG_RECONCILE,
})


class Backoff:
    """One jittered exponential-backoff policy for every retry loop in
    the client (transport redial, serial fallback, lease acquisition).
    ``sleep`` blocks for the next delay — clipped to the remaining
    deadline budget — and returns False *without sleeping* once the
    budget is exhausted, so every loop is bounded by its caller's
    deadline, never by an iteration count alone.  Full jitter
    (0.5x–1.5x the nominal delay) decorrelates concurrent retriers —
    with N writers hammering a recovering cell, synchronized retry
    waves are exactly the failure mode this avoids."""

    __slots__ = ("delay", "cap", "deadline", "rng")

    def __init__(self, base: float, cap: float = 1.0,
                 deadline: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        self.delay = max(1e-4, base)
        self.cap = cap
        self.deadline = deadline
        self.rng = rng if rng is not None else random.Random()

    def sleep(self, deadline: Optional[float] = None) -> bool:
        if deadline is None:
            deadline = self.deadline
        d = self.delay * (0.5 + self.rng.random())
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            d = min(d, remaining)
        time.sleep(d)
        self.delay = min(self.delay * 2, self.cap)
        return True


class _Deadline(Exception):
    """Internal: a per-request deadline expired (wall-clock from
    enqueue).  Converted to ``NodeUnavailable`` at the API boundary."""


class _MuxFuture:
    """Reply slot of one in-flight request: an ordered event queue the
    reader thread pushes into (``("chunk", body)`` per CHUNK frame, then
    exactly one terminal ``("end", msg_type, body)`` or ``("err",
    exc)``).  The waiter consumes with a deadline; ``cancelled`` makes
    the reader drop late frames instead of queuing them."""

    __slots__ = ("_q", "_cond", "cancelled")

    def __init__(self):
        self._q: deque = deque()
        self._cond = threading.Condition()
        self.cancelled = False

    def push(self, item) -> None:
        with self._cond:
            self._q.append(item)
            self._cond.notify()

    def push_many(self, items) -> None:
        """Batch push from the demux loop: one lock hold + one notify
        for a whole CHUNK train instead of a wakeup per frame."""
        with self._cond:
            self._q.extend(items)
            self._cond.notify()

    def next(self, deadline: float):
        with self._cond:
            while not self._q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _Deadline()
                self._cond.wait(remaining)
            return self._q.popleft()

    def next_batch(self, deadline: float) -> List:
        """Pop *everything* queued in one lock round (blocking like
        ``next`` while empty).  Consumers that can absorb a run of
        events amortise the handoff to one wakeup per CHUNK train."""
        with self._cond:
            while not self._q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise _Deadline()
                self._cond.wait(remaining)
            evs = list(self._q)
            self._q.clear()
            return evs


class _NodeMux:
    """One multiplexed connection to one cell.  ``submit`` acquires a
    window slot (bounded in-flight, backpressure within the caller's
    deadline), registers a future under a fresh ``req_id``, and sends
    the frame; a background reader thread owns the receive side and
    demuxes every incoming frame to its future.  The window slot is
    released exactly when the request's terminal frame arrives (or the
    connection dies) — a cancelled future keeps its slot until the
    server's reply is drained, which is the price of not poisoning the
    stream, bounded by the window.  Connection death fails every
    pending future with ``NodeUnavailable``; re-dial is lazy on the
    next submit."""

    def __init__(self, store: "RemoteDeltaStore", node: int, window: int):
        self.store = store
        self.node = node
        self.window = threading.BoundedSemaphore(window)
        self.lock = threading.Lock()
        self.send_lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self.gen = 0  # bumped per dial; stale reader threads self-expire
        self.waiters: Dict[int, _MuxFuture] = {}
        self.inflight_hwm = 0
        self.last_used = time.monotonic()
        self.closed = False

    def submit(self, msg_type: int, body: bytes,
               deadline: float) -> _MuxFuture:
        """Register + send one request; returns its future.  Raises
        ``_Deadline`` if the window or the dial exhausts the budget and
        ``NodeUnavailable`` if the node can't be dialed.  A send failure
        does NOT raise — it fails the connection, and the returned
        future already carries the error event."""
        remaining = deadline - time.monotonic()
        if remaining <= 0 or not self.window.acquire(timeout=remaining):
            raise _Deadline()
        fut = _MuxFuture()
        registered = False
        try:
            with self.lock:
                if self.closed:
                    raise NodeUnavailable(f"cell {self.node}: client closed")
                if self.sock is None:
                    if self.gen > 0:
                        with self.store._lock:
                            self.store.stats.rt_reconnects += 1
                    sock = self.store._dial(self.node)
                    sock.settimeout(None)  # deadlines live in the futures
                    self.sock = sock
                    self.gen += 1
                    t = threading.Thread(
                        target=self._read_loop, args=(sock, self.gen),
                        name=f"mux{self.node}-reader", daemon=True)
                    t.start()
                req_id = self.store._next_req_id()
                self.waiters[req_id] = fut
                registered = True
                depth = len(self.waiters)
                self.inflight_hwm = max(self.inflight_hwm, depth)
                self.last_used = time.monotonic()
                sock, gen = self.sock, self.gen
        except (wire.ProtocolMismatch, wire.AuthFailed):
            raise  # typed handshake failures: never masked as "down"
        except (OSError, wire.WireError) as e:
            raise NodeUnavailable(
                f"cell {self.node} @ {self.store.addrs[self.node]}: {e}"
            ) from e
        finally:
            if not registered:
                self.window.release()
        with self.store._lock:
            if depth > 1:
                self.store.stats.rt_pipelined += 1
            else:
                self.store.stats.rt_serial += 1
        try:
            with self.send_lock:
                wire.send_frame(sock, msg_type, req_id, body)
        except OSError as e:
            self._fail(gen, e)  # drains fut with the error event
        return fut

    def cancel(self, fut: _MuxFuture) -> None:
        """Deadline expiry: stop waiting without poisoning the stream.
        The future stays registered so the reader can drain (and drop)
        the late reply; its window slot frees on that terminal frame."""
        fut.cancelled = True
        with self.store._lock:
            self.store.stats.rt_deadline_cancels += 1

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        reader = wire.FrameReader(sock)
        while True:
            try:
                frames = reader.read_frames()
            except (OSError, wire.WireError) as e:
                self._fail(gen, e)
                return
            # resolve the whole batch under ONE lock hold, then deliver
            # with one wakeup per future — a 64-chunk train costs one
            # recv, one lock round, one notify
            resolved = []
            with self.lock:
                if gen != self.gen:
                    return  # superseded connection: stand down
                self.last_used = time.monotonic()
                for frame in frames:
                    terminal = frame.msg_type != wire.MSG_CHUNK
                    fut = self.waiters.get(frame.req_id)
                    if fut is not None and terminal:
                        del self.waiters[frame.req_id]
                    resolved.append((fut, terminal, frame))
            deliver: Dict[int, Tuple[_MuxFuture, list]] = {}
            for fut, terminal, frame in resolved:
                if fut is None:
                    continue  # stray frame (already-failed request): drop
                if terminal:
                    self.window.release()
                if fut.cancelled:
                    continue  # deadline passed: drain and drop
                slot = deliver.setdefault(id(fut), (fut, []))
                if terminal:
                    slot[1].append(("end", frame.msg_type, frame.body))
                else:
                    slot[1].append(("chunk", frame.body))
            for fut, items in deliver.values():
                fut.push_many(items)

    def _fail(self, gen: int, exc: Exception) -> None:
        """Connection death: close the socket and fail every pending
        future.  ``gen`` guards double-failure (send-side and read-side
        racing) and stale reader threads."""
        with self.lock:
            if gen != self.gen:
                return
            if self.sock is not None:
                try:
                    self.sock.close()
                except OSError:
                    pass
                self.sock = None
            pending = list(self.waiters.values())
            self.waiters.clear()
        err = NodeUnavailable(
            f"cell {self.node} @ {self.store.addrs[self.node]}: {exc}")
        for fut in pending:
            self.window.release()
            fut.push(("err", err))

    def reap_if_idle(self, cutoff: float) -> bool:
        with self.lock:
            if (self.sock is None or self.waiters
                    or self.last_used >= cutoff):
                return False
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
            self.gen += 1  # blocked reader fails with a stale gen: no drain
            return True

    def close(self) -> None:
        with self.lock:
            self.closed = True
            if self.sock is not None:
                try:
                    self.sock.close()
                except OSError:
                    pass
                self.sock = None
            self.gen += 1
            pending = list(self.waiters.values())
            self.waiters.clear()
        err = NodeUnavailable(f"cell {self.node}: client closed")
        for fut in pending:
            self.window.release()
            fut.push(("err", err))


class RemoteDeltaStore(DeltaStore):
    def __init__(self, addrs: List[Tuple[str, int]], r: int = 1,
                 fmt: Optional[str] = None,
                 pool_bytes: int = DEFAULT_POOL_BYTES,
                 timeout: float = 5.0, retries: int = 2,
                 backoff: float = 0.05, suspect_ttl: float = 2.0,
                 pipeline: bool = True, window: int = 32,
                 idle_ttl: float = 30.0, lease_ttl: float = 2.0,
                 auth_key: Optional[str] = None,
                 writer_id: Optional[str] = None):
        super().__init__(m=len(addrs), r=r, backend="mem", fmt=fmt,
                         pool_bytes=pool_bytes)
        self.backend = "remote"
        self.addrs = list(addrs)
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.suspect_ttl = suspect_ttl
        self.window = max(1, window)
        self.idle_ttl = idle_ttl
        self.lease_ttl = max(0.05, lease_ttl)
        self.auth_key = auth_key.encode() if auth_key else None
        self.writer_id = writer_id or uuid.uuid4().hex[:12]
        self._pipeline = pipeline
        self._suspects: Dict[int, float] = {}
        # serial fallback pool: (socket, last-checkin time) per node
        self._conns: List[List[Tuple[socket.socket, float]]] = [
            [] for _ in addrs]
        self._conn_lock = threading.Lock()
        self._muxes = [_NodeMux(self, j, self.window)
                       for j in range(len(addrs))]
        self._req_id = 0
        self._wlock = threading.Lock()
        # per-node redelivery queues: (vseq, msg_type, body) of replica
        # writes that node missed, drained in vseq order before the node
        # serves any further read/write from this client (gap repair)
        self._pending: List[List[Tuple[int, int, bytes]]] = [[] for _ in addrs]
        # writer-lease state, all guarded by _wlock: the lane this
        # writer stamps (epoch 0 = no lease yet), its lane-local seq,
        # the client-side lease validity horizon, and the degraded flag
        # (True: no lease AND no quorum — writes fail fast until the
        # renewal thread re-acquires)
        self._seq = 0
        self._epoch = 0
        self._lease_deadline = 0.0
        self._degraded = False
        self._max_epoch_seen = 0
        self._closed = threading.Event()
        self._reaper = threading.Thread(target=self._reap_loop,
                                        name="remote-store-reaper",
                                        daemon=True)
        self._reaper.start()
        self._lease_thread = threading.Thread(
            target=self._lease_loop, name="remote-store-lease", daemon=True)
        self._lease_thread.start()

    # ---- connection management ----
    def _dial(self, node: int) -> socket.socket:
        sock = socket.create_connection(self.addrs[node],
                                        timeout=self.timeout)
        sock.settimeout(self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        wire.send_frame(sock, wire.MSG_HELLO, 0)
        reply = wire.recv_frame(sock)
        if reply.msg_type == wire.MSG_AUTH:
            # HELLO challenge: prove the shared secret before anything
            # else is served.  No key configured -> typed AuthFailed
            # (retrying cannot help; never masked as NodeUnavailable).
            if self.auth_key is None:
                sock.close()
                raise wire.AuthFailed(
                    f"cell {node} requires auth (pass auth_key=...)")
            mac = hmac.new(self.auth_key, reply.body,
                           hashlib.sha256).digest()
            wire.send_frame(sock, wire.MSG_AUTH, 0, mac)
            reply = wire.recv_frame(sock)
        if reply.msg_type == wire.MSG_ERR:
            code, msg = wire.unpack_err(reply.body)
            sock.close()
            if code == wire.ERR_VERSION:
                raise wire.ProtocolMismatch(msg)
            if code == wire.ERR_AUTH_FAILED:
                raise wire.AuthFailed(msg)
            raise wire.RemoteError(code, msg)
        if reply.msg_type != wire.MSG_HELLO:
            sock.close()
            raise wire.FrameError(
                f"expected HELLO reply, got type {reply.msg_type}")
        return sock

    def _next_req_id(self) -> int:
        with self._lock:
            self._req_id = (self._req_id + 1) & 0xFFFFFFFF or 1
            return self._req_id

    def _checkout(self, node: int) -> socket.socket:
        cutoff = time.monotonic() - self.idle_ttl
        with self._conn_lock:
            while self._conns[node]:
                sock, ts = self._conns[node].pop()
                if ts >= cutoff:
                    return sock
                try:  # sat idle past the TTL: the cell may have dropped
                    sock.close()  # it; don't hand a dead socket out
                except OSError:
                    pass
        return self._dial(node)

    def _checkin(self, node: int, sock: socket.socket) -> None:
        with self._conn_lock:
            self._conns[node].append((sock, time.monotonic()))

    def _reap_loop(self) -> None:
        interval = max(0.05, min(self.idle_ttl, 5.0) / 2)
        while not self._closed.wait(interval):
            cutoff = time.monotonic() - self.idle_ttl
            for mux in self._muxes:
                mux.reap_if_idle(cutoff)
            with self._conn_lock:
                for node, stack in enumerate(self._conns):
                    live = [(s, ts) for s, ts in stack if ts >= cutoff]
                    for s, ts in stack:
                        if ts < cutoff:
                            try:
                                s.close()
                            except OSError:
                                pass
                    self._conns[node] = live

    def close(self) -> None:
        self._release_lease()
        self._closed.set()
        for mux in self._muxes:
            mux.close()
        with self._conn_lock:
            for stack in self._conns:
                while stack:
                    try:
                        stack.pop()[0].close()
                    except OSError:
                        pass

    # ---- request/reply: deadline from enqueue, idempotent-only retry ----
    def _map_reply(self, msg_type: int, body: bytes) -> bytes:
        if msg_type != wire.MSG_ERR:
            return body
        code, msg = wire.unpack_err(body)
        if code == wire.ERR_VERSION:
            raise wire.ProtocolMismatch(msg)
        if code == wire.ERR_KEY_MISSING:
            raise KeyMissing(msg)
        if code == wire.ERR_LEASE_FENCED:
            raise wire.LeaseFenced(msg)
        if code == wire.ERR_AUTH_FAILED:
            raise wire.AuthFailed(msg)
        raise wire.RemoteError(code, msg)

    def _request(self, node: int, msg_type: int, body: bytes,
                 retries: Optional[int] = None,
                 deadline: Optional[float] = None) -> bytes:
        """One request to one cell.  The deadline is wall-clock from
        THIS call (enqueue): window wait, dial, send, queueing on the
        server, and the reply all draw down the same ``timeout`` budget,
        so a request stuck behind a full window can't silently exceed
        the caller's patience.  Transport failures (dead connection,
        torn or corrupt frame) are retried with bounded backoff for
        idempotent message types only, then surface as
        ``NodeUnavailable`` — the caller fails over.  Server-relayed
        errors (ERR frames) are never retried: the cell is alive, the
        request itself failed."""
        if deadline is None:
            deadline = time.monotonic() + self.timeout
        if not self._pipeline:
            return self._request_serial(node, msg_type, body, retries,
                                        deadline)
        retries = self.retries if retries is None else retries
        attempts = (retries + 1) if msg_type in _IDEMPOTENT else 1
        bo = Backoff(self.backoff, deadline=deadline)
        mux = self._muxes[node]
        last: Exception = NodeUnavailable(f"cell {node}")
        for _ in range(attempts):
            try:
                fut = mux.submit(msg_type, body, deadline)
            except _Deadline:
                break
            except NodeUnavailable as e:
                last = e
                if not bo.sleep():
                    break
                continue
            try:
                ev = fut.next(deadline)
            except _Deadline:
                mux.cancel(fut)
                raise NodeUnavailable(
                    f"cell {node} @ {self.addrs[node]}: deadline "
                    f"({self.timeout}s from enqueue) expired") from None
            if ev[0] == "err":
                last = ev[1]
                if not bo.sleep():
                    break
                continue
            assert ev[0] == "end", f"unexpected stream event {ev[0]}"
            return self._map_reply(ev[1], ev[2])
        raise NodeUnavailable(
            f"cell {node} @ {self.addrs[node]}: {last}") from last

    def _request_serial(self, node: int, msg_type: int, body: bytes,
                        retries: Optional[int], deadline: float) -> bytes:
        """The pre-multiplexer transport: one checked-out connection per
        request, blocking reply read.  Kept as the ``pipeline=False``
        baseline; per-attempt socket timeouts are clipped to the
        remaining enqueue budget."""
        retries = self.retries if retries is None else retries
        bo = Backoff(self.backoff, deadline=deadline)
        last: Exception = NodeUnavailable(f"cell {node}")
        for _ in range(retries + 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            sock = None
            try:
                sock = self._checkout(node)
                sock.settimeout(max(0.05, remaining))
                req_id = self._next_req_id()
                wire.send_frame(sock, msg_type, req_id, body)
                reply = wire.recv_frame(sock)
                if reply.req_id != req_id:
                    raise wire.FrameError("reply req_id mismatch")
                with self._lock:
                    self.stats.rt_serial += 1
                self._checkin(node, sock)
                return self._map_reply(reply.msg_type, reply.body)
            except (wire.ProtocolMismatch, wire.AuthFailed, wire.LeaseFenced,
                    wire.RemoteError, KeyMissing):
                raise  # the cell answered: retrying cannot change it
            except (OSError, wire.WireError) as e:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                last = e
                if not bo.sleep():
                    break
        raise NodeUnavailable(
            f"cell {node} @ {self.addrs[node]}: {last}") from last

    # ---- node health (suspect set with re-probe TTL) ----
    def _health_ok(self, i: int) -> bool:
        """Pure reachability check: not down, not a live suspect.  Safe
        to call while holding ``_wlock`` (no side effects beyond TTL
        expiry of the suspect mark)."""
        if i in self.down:
            return False
        t = self._suspects.get(i)
        if t is None:
            return True
        if time.monotonic() - t > self.suspect_ttl:
            self._suspects.pop(i, None)  # TTL over: re-probe the cell
            return True
        return False

    def _node_ok(self, i: int) -> bool:
        """The routing gate the (inherited) read paths consult.  On top
        of reachability, a node with queued redeliveries is *gap-known*:
        it missed acknowledged writes, so a read routed there could
        return a stale version with a valid crc — no failover would
        trigger.  Drain the queue first; if the node still can't take
        the backlog, treat it as unavailable and let the read fail over
        to a replica that has the writes."""
        if not self._health_ok(i):
            return False
        if self._pending[i]:
            with self._wlock:
                if self._pending[i] and not self._drain_pending(i):
                    return False
        return True

    def _mark_unavailable(self, i: int) -> None:
        self._suspects[i] = time.monotonic()

    def _drain_pending(self, node: int) -> bool:
        """Redeliver ``node``'s queued writes in seq order; True when
        the queue is empty.  Caller holds ``_wlock`` — the drain must
        serialize with live writes so the node keeps seeing seqs in
        order.  A failed redelivery re-marks the node suspect and keeps
        the rest of the queue (including on RemoteError: dropping a
        record would silently re-open the gap; restart catch-up remains
        the backstop for a persistently failing cell)."""
        q = self._pending[node]
        while q:
            _seq, mtype, body = q[0]
            try:
                self._request(node, mtype, body)
            except wire.LeaseFenced:
                # the record's lane was sealed while it sat queued: the
                # reconciliation that sealed it already anti-entropied
                # every record that mattered, so this copy is moot —
                # drop it, or the node stays gap-known forever
                q.pop(0)
                with self._lock:
                    self.stats.fence_drops += 1
                continue
            except NodeUnavailable:
                self._mark_unavailable(node)
                return False
            except wire.RemoteError:
                return False
            q.pop(0)
            with self._lock:
                self.stats.redelivered += 1
        return True

    # ---- writer lease lifecycle ----
    def _lease_body(self, op: int, epoch: int,
                    final_seq: Optional[int] = None,
                    peers: bool = False) -> bytes:
        body = (struct.pack("<BQ", op, epoch)
                + wire.pack_str(self.writer_id))
        if final_seq is not None:
            body += struct.pack("<Q", final_seq)
        if peers:
            body += wire.pack_peers(self.addrs)
        return body

    def _lease_quorum(self) -> int:
        return self.m // 2 + 1

    def _acquire_lease_locked(self, deadline: float) -> None:
        """Acquire a fresh fencing epoch from a cell quorum (caller
        holds ``_wlock``).  Proposes past the highest epoch seen and,
        on a denied round, past the highest epoch the denials revealed
        — two racing writers converge in one extra round.  The ACQUIRE
        body carries the full address list so every cell learns the
        topology reconciliation will later anti-entropy across.  Raises
        ``WriteUnavailable`` once the deadline budget is exhausted
        without a quorum."""
        quorum = self._lease_quorum()
        bo = Backoff(self.backoff, deadline=deadline)
        propose = max(self._max_epoch_seen, self._epoch) + 1
        while True:
            grants = 0
            body = self._lease_body(wire.LEASE_ACQUIRE, propose, peers=True)
            for j in range(self.m):
                try:
                    rep = self._request(j, wire.MSG_LEASE, body, retries=0,
                                        deadline=deadline)
                except (NodeUnavailable, wire.RemoteError):
                    self._mark_unavailable(j)
                    continue
                granted, max_epoch = struct.unpack_from("<BQ", rep, 0)
                self._max_epoch_seen = max(self._max_epoch_seen, max_epoch)
                grants += granted
            if grants >= quorum:
                self._epoch = propose
                self._max_epoch_seen = max(self._max_epoch_seen, propose)
                self._seq = 0  # a fresh lane starts empty: no seq resume
                self._degraded = False
                self._lease_deadline = time.monotonic() + self.lease_ttl
                with self._lock:
                    self.stats.lease_acquires += 1
                return
            propose = max(self._max_epoch_seen, propose) + 1
            if not bo.sleep():
                self._degraded = True
                raise WriteUnavailable(
                    f"writer lease: no quorum ({grants}/{quorum} grants, "
                    f"m={self.m}) — write plane degraded to read-only; "
                    f"re-acquiring in the background")

    def _ensure_lease_locked(self) -> None:
        """Write-path gate (caller holds ``_wlock``): a live lease
        passes immediately; a degraded writer fails FAST with the typed
        ``WriteUnavailable`` (no network — the renewal thread owns
        re-acquisition); anything else (first write, lapsed or fenced
        lease) acquires synchronously within one timeout budget."""
        if self._epoch and not self._degraded \
                and time.monotonic() < self._lease_deadline:
            return
        if self._degraded:
            raise WriteUnavailable(
                "write plane degraded: no writer-lease quorum (reads keep "
                "serving; writes resume once a quorum returns)")
        self._acquire_lease_locked(time.monotonic() + self.timeout)

    def _renew_locked(self, deadline: float) -> bool:
        quorum = self._lease_quorum()
        grants = 0
        body = self._lease_body(wire.LEASE_RENEW, self._epoch)
        for j in range(self.m):
            try:
                rep = self._request(j, wire.MSG_LEASE, body, retries=0,
                                    deadline=deadline)
            except (NodeUnavailable, wire.RemoteError):
                continue
            granted, max_epoch = struct.unpack_from("<BQ", rep, 0)
            self._max_epoch_seen = max(self._max_epoch_seen, max_epoch)
            grants += granted
        if grants >= quorum:
            self._lease_deadline = time.monotonic() + self.lease_ttl
            with self._lock:
                self.stats.lease_renewals += 1
            return True
        return False

    def _invalidate_lease_locked(self) -> None:
        """A cell fenced our epoch: the lane was sealed (this writer was
        presumed dead).  Drop the lease WITHOUT degrading — the next
        write re-acquires a fresh epoch synchronously."""
        self._lease_deadline = 0.0
        self._degraded = False
        with self._lock:
            self.stats.lease_fenced += 1

    def _lease_loop(self) -> None:
        """Background renewal: every ``lease_ttl/3`` renew a held lease
        (writes also extend it, so this mostly matters when idle),
        degrade to read-only when the lease expires without a quorum,
        and — while degraded — keep trying to re-acquire so writes
        resume automatically when the quorum returns."""
        interval = self.lease_ttl / 3
        while not self._closed.wait(interval):
            if not self._wlock.acquire(timeout=interval):
                continue  # a write holds the lock — it IS the heartbeat
            try:
                budget = time.monotonic() + min(self.timeout,
                                                self.lease_ttl)
                if self._degraded:
                    try:
                        self._acquire_lease_locked(budget)
                    except WriteUnavailable:
                        pass
                    continue
                if not self._epoch:
                    continue  # never written: nothing to maintain
                if not self._renew_locked(budget) \
                        and time.monotonic() >= self._lease_deadline:
                    self._degraded = True
            finally:
                self._wlock.release()

    def _release_lease(self) -> None:
        """Best-effort clean exit: seal our lane at its final seq so the
        cells needn't wait out the TTL.  Only safe — and only attempted
        — when every own-lane redelivery has drained (a RELEASE seal
        asserts the lane is replica-complete up to ``final_seq``); a
        writer exiting with queued records leaves the TTL + orphan-seq
        reconciliation to seal the lane instead."""
        try:
            with self._wlock:
                if not self._epoch or self._degraded:
                    return
                for q in self._pending:
                    for vseq, _, _ in q:
                        if split_vseq(vseq)[0] == self._epoch:
                            return
                body = self._lease_body(wire.LEASE_RELEASE, self._epoch,
                                        final_seq=self._seq)
                for j in range(self.m):
                    try:
                        self._request(j, wire.MSG_LEASE, body, retries=0)
                    except (NodeUnavailable, wire.WireError):
                        continue
                self._epoch = 0
                self._lease_deadline = 0.0
        except Exception:  # noqa: BLE001 — close() must never fail on this
            pass

    def lease_status(self) -> Dict:
        """This writer's lane as the client sees it: epoch, lane seq,
        degraded flag, and how much lease validity remains."""
        with self._wlock:
            return {"writer_id": self.writer_id, "epoch": self._epoch,
                    "seq": self._seq, "degraded": self._degraded,
                    "remaining": max(0.0, self._lease_deadline
                                     - time.monotonic())}

    def reconcile_lane(self, epoch: int, force: bool = False) -> int:
        """Operator-driven orphan-seq reconciliation for one lane:
        query every cell's lane high-water mark, have every cell
        anti-entropy its gaps from the peer list (prepare: while every
        feed is still intact), then seal the lane at the max and
        broadcast.  Requires every cell reachable — sealing asserts
        replica-completeness, which a partial view cannot prove — and,
        unless ``force``, refuses while any cell still sees a live
        lease.  ``force`` fences a *live* writer deliberately (the
        stale-writer drill: its next write gets ``LeaseFenced``).
        Returns the seal point."""
        marks: List[int] = []
        for j in range(self.m):
            rep = self._request(
                j, wire.MSG_RECONCILE,
                struct.pack("<BQ", wire.RECONCILE_QUERY, epoch))
            lane_seq, seal, has_seal, live = struct.unpack_from(
                "<QQBB", rep, 0)
            if live and not force:
                raise StorageNodeDown(
                    f"lane {epoch} still holds a live lease on cell {j}; "
                    f"pass force=True to fence it anyway")
            marks.append(lane_seq)
            if has_seal:
                marks.append(seal)
        prep = (struct.pack("<BQ", wire.RECONCILE_PREPARE, epoch)
                + wire.pack_peers(self.addrs))
        for j in range(self.m):
            rep = self._request(j, wire.MSG_RECONCILE, prep)
            marks.append(struct.unpack_from("<Q", rep, 0)[0])
        seal = max(marks)
        body = (struct.pack("<BQQ", wire.RECONCILE_SEAL, epoch, seal)
                + wire.pack_peers(self.addrs))
        for j in range(self.m):
            self._request(j, wire.MSG_RECONCILE, body)
        return seal

    # ---- replica-ack watermark (feed truncation) ----
    def _ack_watermark_locked(self, exclude_current: bool = False) -> int:
        """Highest OWN-LANE seq S such that every record this client
        stamped with lane seq <= S was accepted by EVERY replica cell it
        belongs to: every fan-out either acked on all replicas or queued
        the misses, so S is ``_seq`` clamped below the oldest own-lane
        queued redelivery.  Returned as a vseq — cells split it and
        advance only this lane's ack coverage, so one writer's watermark
        can never certify (or strand) another writer's lane.  Queued
        records from a *previous* epoch of this client are ignored: the
        watermark asserts nothing about sealed lanes.  Caller holds
        ``_wlock``.  ``exclude_current`` backs off by one for the write
        being fanned out right now (its own acks are not in yet)."""
        base = self._seq - (1 if exclude_current else 0)
        for q in self._pending:
            for vseq, _, _ in q:
                e, s = split_vseq(vseq)
                if e == self._epoch:
                    base = min(base, s - 1)
                    break  # queues are vseq-ordered: first hit is min
        return make_vseq(self._epoch, max(0, base))

    def ack_watermark(self) -> int:
        with self._wlock:
            return self._ack_watermark_locked()

    def quiesce(self, truncate: bool = False) -> int:
        """Drain every redelivery queue (best effort), then push the ack
        watermark to every cell with a PING; with ``truncate`` also ask
        each cell to truncate its feed up to the watermark NOW (forced
        MAINT) — benches/tests use this to reach a deterministic feed
        state before comparing files.  Returns the watermark."""
        with self._wlock:
            for j in range(self.m):
                if self._pending[j]:
                    self._drain_pending(j)
            water = self._ack_watermark_locked()
        body = struct.pack("<Q", water)
        for j in range(self.m):
            try:
                self._request(j, wire.MSG_PING, body, retries=0)
            except (NodeUnavailable, wire.WireError):
                continue
            if truncate:
                try:
                    self._request(j, wire.MSG_MAINT,
                                  struct.pack("<B", wire.MAINT_TRUNCATE))
                except (NodeUnavailable, wire.RemoteError):
                    pass
        return water

    # ---- physical I/O overrides (everything above is inherited) ----
    def _read_columns(self, node: int, key: DeltaKey,
                      fields: Optional[Tuple[str, ...]],
                      ) -> Tuple[Dict[str, np.ndarray], int, int]:
        flist = None if fields is None else list(fields)
        body = wire.pack_key(key) + wire.pack_fields(flist)
        blob = self._request(node, wire.MSG_GET, body)
        # the reply IS a TGI2 block: per-column crc32 verified on decode
        # (BlockCorruption -> inherited get() fails over to next replica)
        arrays, enc_read, raw_read = serialize.loads_sized(blob, fields=flist)
        self._pool_dir_fill(key, blob)
        return arrays, enc_read, raw_read

    def _fan_out(self, key: DeltaKey, seq: int, msg_type: int,
                 body: bytes) -> List[bytes]:
        """Send one stamped record to every replica cell of ``key``
        (caller holds ``_wlock``).  A reachable node first drains its
        redelivery backlog so it keeps receiving seqs in order; a node
        that is suspect or fails gets the record queued for redelivery
        instead.  Returns the replies of the cells that acked — if NONE
        did, the write failed: nothing is queued (a record the caller
        saw fail must not materialize later) and ``StorageNodeDown`` is
        raised."""
        acked: List[bytes] = []
        missed: List[int] = []
        fenced: Optional[wire.LeaseFenced] = None
        for node in self.replicas(key):
            if self._health_ok(node) and self._drain_pending(node):
                try:
                    acked.append(self._request(node, msg_type, body))
                    continue
                except wire.LeaseFenced as e:
                    fenced = e  # lane sealed there: do NOT queue a copy
                    continue
                except NodeUnavailable:
                    self._mark_unavailable(node)
            missed.append(node)
        if fenced is not None:
            # our epoch was reconciled away (this writer was presumed
            # dead).  Invalidate the lease so the next write re-acquires
            # a fresh epoch.  With zero acks the write plainly failed —
            # surface the typed fence.  With partial acks the record IS
            # durable (the accepting cell's copy rides the seal upward
            # when reconciliation reaches it), so the write stands.
            self._invalidate_lease_locked()
            if not acked:
                raise fenced
        if not acked:
            raise StorageNodeDown(f"all replica cells down for {key}")
        for node in missed:
            self._pending[node].append((seq, msg_type, body))
        return acked

    def put_encoded(self, key: DeltaKey, blob: bytes, raw_bytes: int):
        with self._wlock:
            self._ensure_lease_locked()
            self._seq += 1
            vseq = make_vseq(self._epoch, self._seq)
            body = (wire.pack_key(key)
                    + struct.pack("<QQ", vseq, raw_bytes)
                    + wire.pack_blob(blob)
                    + struct.pack("<Q",
                                  self._ack_watermark_locked(True)))
            acked = self._fan_out(key, vseq, wire.MSG_PUT, body)
            if len(acked) >= self._lease_quorum():
                # a quorum saw the write: it doubles as the heartbeat
                self._lease_deadline = time.monotonic() + self.lease_ttl
        if self.pool is not None:
            self.pool.invalidate(key)
        with self._lock:
            self.stats.writes += 1
            self.stats.bytes_written += len(blob) * self.r
            self.stats.bytes_raw_written += raw_bytes * self.r
            self.key_sizes[key] = (raw_bytes, len(blob))

    def delete(self, key: DeltaKey) -> bool:
        """Like ``put_encoded``, a delete must be acked by at least one
        replica cell — otherwise no DELETE record exists in any feed
        (the seq would be a permanent gap and the key would stay live on
        the cluster), so it raises ``StorageNodeDown`` with the local
        accounting untouched instead of silently 'succeeding'."""
        with self._wlock:
            self._ensure_lease_locked()
            self._seq += 1
            vseq = make_vseq(self._epoch, self._seq)
            body = (wire.pack_key(key) + struct.pack("<Q", vseq)
                    + struct.pack("<Q",
                                  self._ack_watermark_locked(True)))
            replies = self._fan_out(key, vseq, wire.MSG_DELETE, body)
            existed = any(bool(rep[0]) for rep in replies)
            if len(replies) >= self._lease_quorum():
                self._lease_deadline = time.monotonic() + self.lease_ttl
        if self.pool is not None:
            self.pool.invalidate(key)
        with self._lock:
            sizes = self.key_sizes.pop(key, None)
            if sizes is not None:
                self.stats.n_deletes += 1
                self.stats.bytes_deleted += sizes[1] * self.r
        return existed or sizes is not None

    # ---- multiget: replica-parallel fan-out over streamed chunks ----
    def _mg_body(self, keys: List[DeltaKey],
                 flist: Optional[List[str]]) -> bytes:
        req = [struct.pack("<I", len(keys))]
        req += [wire.pack_key(k) for k in keys]
        req.append(wire.pack_fields(flist))
        req.append(struct.pack("<B", 1))  # found-subset reply; the
        # client decides missing vs try-next-replica
        return b"".join(req)

    def _absorb_hit(self, k: DeltaKey, blob: bytes,
                    flist: Optional[List[str]],
                    sizes: Optional[Dict[DeltaKey, ReadSizes]],
                    tier: int) -> Optional[Dict]:
        """Decode one multiget hit and run the full read-side
        bookkeeping (pool fill, stats, sizes); None on a corrupt blob
        (counted as a failover — the key retries on the next tier)."""
        try:
            arrays, enc_read, raw_read = serialize.loads_sized(
                blob, fields=flist)
        except BlockCorruption:
            with self._lock:
                self.stats.failovers += 1
            return None
        self._pool_dir_fill(k, blob)
        with self._lock:
            self.stats.reads += 1
            self.stats.bytes_read += enc_read
            self.stats.bytes_decompressed += raw_read
            if self.pool is not None:
                self.stats.pool_misses += len(arrays)
            if tier > 0:
                self.stats.failovers += 1
        if self.pool is not None:
            for name, a in arrays.items():
                self.pool.put(k, name, a)
        if sizes is not None:
            sizes[k] = ReadSizes(enc_read, raw_read, 0, 0)
        return arrays

    def _mg_drain(self, node: int, fut: _MuxFuture, deadline: float,
                  on_blob: Callable[[DeltaKey, bytes], None]) -> int:
        """Consume one MULTIGET reply stream from a mux future, invoking
        ``on_blob`` per CHUNK as it arrives (decode overlaps the
        server's reads of later keys).  Returns the server's found
        count; transport failure or deadline -> ``NodeUnavailable``."""
        mux = self._muxes[node]
        while True:
            try:
                evs = fut.next_batch(deadline)
            except _Deadline:
                mux.cancel(fut)
                raise NodeUnavailable(
                    f"cell {node}: multiget deadline expired") from None
            for ev in evs:
                if ev[0] == "chunk":
                    k, off = wire.unpack_key(ev[1], 0)
                    blob, _ = wire.unpack_blob(ev[1], off)
                    on_blob(k, blob)
                    continue
                if ev[0] == "err":
                    raise NodeUnavailable(
                        f"cell {node}: {ev[1]}") from ev[1]
                mtype, body = ev[1], ev[2]
                if mtype == wire.MSG_END:
                    (found,) = struct.unpack_from("<I", body, 0)
                    return found
                self._map_reply(mtype, body)  # raises on ERR
                raise wire.FrameError(
                    f"unexpected terminal frame {mtype}")

    def multiget(self, keys: Iterable[DeltaKey], c: int = 1,
                 fields: Optional[Iterable[str]] = None,
                 missing_ok: bool = False,
                 sizes: Optional[Dict[DeltaKey, ReadSizes]] = None,
                 ) -> Dict[DeltaKey, Dict]:
        """Replica-parallel pipelined multiget: every primary-node group
        is submitted to its node's mux *concurrently* (one streamed
        MULTIGET each — ``c`` is moot, parallelism is free on the
        muxes), then the streams are drained with decode/pool-fill per
        arriving chunk.  Keys a tier leaves unserved advance together to
        the next replica tier — hedged groups (primary known-dead) ride
        the same mechanism starting at tier 0.  With ``pipeline=False``
        falls back to the serial per-group path."""
        if not self._pipeline:
            return super().multiget(keys, c=c, fields=fields,
                                    missing_ok=missing_ok, sizes=sizes)
        keys = list(keys)
        flist = None if fields is None else list(fields)
        out: Dict[DeltaKey, Dict] = {}
        groups: Dict[int, List[DeltaKey]] = {}
        for k in keys:
            if self.pool is not None and self.pool.dir_get(k) is not None:
                try:
                    out[k] = self.get(k, fields=fields, sizes=sizes)
                except KeyMissing:
                    if not missing_ok:
                        raise
            else:
                groups.setdefault(self.replicas(k)[0], []).append(k)
        states = []
        for primary, batch in groups.items():
            if not self._node_ok(primary):
                with self._lock:
                    self.stats.hedged_reads += len(batch)
            states.append({"chain": self.replicas(batch[0]),
                           "pending": batch, "reachable": False})
        for tier in range(self.r):
            live = []
            for st in states:
                pending = st["pending"]
                if not pending:
                    continue
                node = st["chain"][tier]
                if not self._node_ok(node):
                    if tier > 0 or self.r == 1:
                        with self._lock:
                            self.stats.failovers += len(pending)
                    continue
                deadline = time.monotonic() + self.timeout
                try:
                    fut = self._muxes[node].submit(
                        wire.MSG_MULTIGET, self._mg_body(pending, flist),
                        deadline)
                except (_Deadline, NodeUnavailable):
                    self._mark_unavailable(node)
                    with self._lock:
                        self.stats.failovers += len(pending)
                    continue
                live.append((st, node, fut, deadline))
            for st, node, fut, deadline in live:
                pending = st["pending"]
                done: Dict[DeltaKey, Dict] = {}

                def absorb(k, blob, done=done, tier=tier):
                    if k in done:
                        return
                    arrays = self._absorb_hit(k, blob, flist, sizes, tier)
                    if arrays is not None:
                        done[k] = arrays

                ok = False
                for attempt in range(self.retries + 1):
                    try:
                        self._mg_drain(node, fut, deadline, absorb)
                        ok = True
                        break
                    except NodeUnavailable:
                        # transport blip mid-stream: re-issue the
                        # remaining keys on the same tier within the
                        # original enqueue deadline (MULTIGET is
                        # idempotent; already-absorbed keys are skipped)
                        if (attempt == self.retries
                                or time.monotonic() >= deadline):
                            break
                        rest = [k for k in pending if k not in done]
                        if not rest:
                            ok = True
                            break
                        try:
                            fut = self._muxes[node].submit(
                                wire.MSG_MULTIGET,
                                self._mg_body(rest, flist), deadline)
                        except (_Deadline, NodeUnavailable):
                            break
                    except (KeyMissing, wire.RemoteError,
                            wire.WireError):
                        break  # cell alive, batch refused: next tier
                if not ok:
                    self._mark_unavailable(node)
                    with self._lock:
                        self.stats.failovers += len(pending) - len(done)
                else:
                    st["reachable"] = True
                out.update(done)
                st["pending"] = [k for k in pending if k not in done]
            if all(not st["pending"] for st in states):
                break
        for st in states:
            if st["pending"]:
                if not st["reachable"]:
                    raise StorageNodeDown(
                        f"no live replica cell for {st['pending'][0]}")
                if not missing_ok:
                    raise KeyMissing(st["pending"][0])
        return out

    def _mg_round_serial(self, node: int, pending: List[DeltaKey],
                         flist: Optional[List[str]],
                         ) -> Dict[DeltaKey, bytes]:
        """Serial-mode MULTIGET: one checked-out connection, blocking
        CHUNK/END stream read.  Returns key -> blob for the found
        subset; transport failure -> ``NodeUnavailable``."""
        deadline = time.monotonic() + self.timeout
        body = self._mg_body(pending, flist)
        bo = Backoff(self.backoff, deadline=deadline)
        last: Exception = NodeUnavailable(f"cell {node}")
        for _ in range(self.retries + 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            sock = None
            try:
                sock = self._checkout(node)
                sock.settimeout(max(0.05, remaining))
                req_id = self._next_req_id()
                wire.send_frame(sock, wire.MSG_MULTIGET, req_id, body)
                got: Dict[DeltaKey, bytes] = {}
                while True:
                    reply = wire.recv_frame(sock)
                    if reply.req_id != req_id:
                        raise wire.FrameError("reply req_id mismatch")
                    if reply.msg_type == wire.MSG_CHUNK:
                        k, off = wire.unpack_key(reply.body, 0)
                        blob, _ = wire.unpack_blob(reply.body, off)
                        got[k] = blob
                        continue
                    with self._lock:
                        self.stats.rt_serial += 1
                    self._checkin(node, sock)
                    if reply.msg_type == wire.MSG_END:
                        return got
                    self._map_reply(reply.msg_type, reply.body)
                    raise wire.FrameError(
                        f"unexpected terminal frame {reply.msg_type}")
            except (wire.ProtocolMismatch, wire.AuthFailed,
                    wire.RemoteError, KeyMissing):
                raise
            except (OSError, wire.WireError) as e:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                last = e
                if not bo.sleep():
                    break
        raise NodeUnavailable(
            f"cell {node} @ {self.addrs[node]}: {last}") from last

    def _group_fetch(self, primary: int, gkeys: List[DeltaKey],
                     fields: Optional[Iterable[str]], missing_ok: bool,
                     sizes: Optional[Dict[DeltaKey, ReadSizes]],
                     ) -> Dict[DeltaKey, Dict]:
        """Serial-mode group fetch (``pipeline=False``, reached via the
        inherited ``multiget``): one MULTIGET frame per replica tier for
        a whole primary-node group.  Keys with pooled state go through
        the inherited per-key ``get`` (it merges pool hits with a
        partial fetch); cold keys ride the batch.  An unavailable tier
        redirects the *remaining batch* to the next replica in one
        frame — the hedged path."""
        out: Dict[DeltaKey, Dict] = {}
        batch: List[DeltaKey] = []
        for k in gkeys:
            if self.pool is not None and self.pool.dir_get(k) is not None:
                try:
                    out[k] = self.get(k, fields=fields, sizes=sizes)
                except KeyMissing:
                    if not missing_ok:
                        raise
            else:
                batch.append(k)
        if not batch:
            return out
        if not self._node_ok(primary):
            with self._lock:
                self.stats.hedged_reads += len(batch)
        flist = None if fields is None else list(fields)
        pending = batch
        reachable = False
        for j, node in enumerate(self.replicas(batch[0])):
            if not pending:
                break
            if not self._node_ok(node):
                if j > 0 or self.r == 1:
                    with self._lock:
                        self.stats.failovers += len(pending)
                continue
            try:
                got = self._mg_round_serial(node, pending, flist)
            except NodeUnavailable:
                self._mark_unavailable(node)
                with self._lock:
                    self.stats.failovers += len(pending)
                continue
            reachable = True
            still: List[DeltaKey] = []
            for k in pending:
                blob = got.get(k)
                if blob is None:
                    still.append(k)  # not on this tier: try the next
                    continue
                arrays = self._absorb_hit(k, blob, flist, sizes, j)
                if arrays is None:
                    still.append(k)
                    continue
                out[k] = arrays
            pending = still
        if pending:
            if not reachable:
                raise StorageNodeDown(
                    f"no live replica cell for {pending[0]}")
            if not missing_ok:
                raise KeyMissing(pending[0])
        return out

    def keys_for_placement(self, tsid: int, sid: int) -> List[DeltaKey]:
        body = struct.pack("<qq", tsid, sid)
        last: Exception = StorageNodeDown(
            f"no live replica cell for placement ({tsid}, {sid})")
        for node in replica_nodes(tsid, sid, self.m, self.r):
            if not self._node_ok(node):
                continue
            try:
                reply = self._request(node, wire.MSG_KEYS, body)
            except NodeUnavailable as e:
                self._mark_unavailable(node)
                last = e
                continue
            (n,) = struct.unpack_from("<I", reply, 0)
            off = 4
            out = []
            for _ in range(n):
                k, off = wire.unpack_key(reply, off)
                out.append(k)
            return out
        raise StorageNodeDown(str(last))

    def node_status(self) -> Dict:
        """The shared cluster-health shape, with liveness *probed*: each
        cell answers a PING (one attempt) so "up" reflects the cluster
        as it is now, not just the suspect cache."""
        for i in range(self.m):
            try:
                self._request(i, wire.MSG_PING, b"", retries=0)
                self._suspects.pop(i, None)
            except (NodeUnavailable, wire.WireError):
                self._mark_unavailable(i)
        return super().node_status()

    def feed_status(self) -> List[Optional[Dict]]:
        """Per-cell feed state (length/floor/bytes/ack_water/
        truncations), ``None`` for unreachable cells — how benches and
        ``storage_report`` observe ack-watermark feed truncation."""
        out: List[Optional[Dict]] = []
        for i in range(self.m):
            try:
                out.append(self.cell_status(i).get("feed"))
            except (NodeUnavailable, wire.WireError, ValueError):
                out.append(None)
        return out

    def transport_stats(self) -> Dict:
        """Live mux state + transport counters: per-node in-flight
        depth (and its high-water mark), connectedness, and the
        pipelined/serial/cancel/reconnect round-trip counters."""
        nodes = []
        for j, mux in enumerate(self._muxes):
            with mux.lock:
                nodes.append({"node": j,
                              "connected": mux.sock is not None,
                              "in_flight": len(mux.waiters),
                              "inflight_hwm": mux.inflight_hwm})
        with self._lock:
            s = self.stats
            counters = {"rt_pipelined": s.rt_pipelined,
                        "rt_serial": s.rt_serial,
                        "rt_deadline_cancels": s.rt_deadline_cancels,
                        "rt_reconnects": s.rt_reconnects,
                        "hedged_reads": s.hedged_reads,
                        "failovers": s.failovers}
        return {"pipeline": self._pipeline, "window": self.window,
                "in_flight": sum(n["in_flight"] for n in nodes),
                "inflight_hwm": max((n["inflight_hwm"] for n in nodes),
                                    default=0),
                **counters, "nodes": nodes}

    def cell_status(self, node: int) -> Dict:
        """Server-side view of one cell (its own stats/feed/last_seq) —
        the bench asserts server-measured ``bytes_io`` through this."""
        import json
        return json.loads(self._request(node, wire.MSG_STATUS, b""))

    def maintain(self, node: int, canonical: bool = False) -> bool:
        """Ask one cell to run a vacuum pass (MSG_MAINT).  The default
        background pass acks immediately and keeps serving while it
        runs; ``canonical=True`` instead runs a SYNCHRONOUS canonical
        vacuum — chunk records reordered by key, the pass that makes
        replica files byte-identical under multi-writer interleaving.
        Returns whether a pass ran/started (False: one already
        running).  Results surface in ``cell_status(node)["maint"]``."""
        body = (struct.pack("<B", wire.MAINT_CANON) if canonical else b"")
        reply = self._request(node, wire.MSG_MAINT, body)
        (started,) = struct.unpack_from("<B", reply, 0)
        return bool(started)

    def report_snapshot(self) -> Dict:
        """One-copy storage accounting (see the base class), with the
        node section swapped for the *probed* cluster health — remote
        liveness is a cell property, not derivable from the client's
        write-accounting mirror."""
        snap = super().report_snapshot()
        snap["node_status"] = self.node_status()
        snap["transport"] = self.transport_stats()
        snap["feeds"] = self.feed_status()
        return snap
