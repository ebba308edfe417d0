"""Wire protocol for the temporal graph service plane.

Length-prefixed binary framing over a byte stream (TCP).  Every message
is one frame:

    header (16 bytes, little-endian):
        magic     2s   b"TW"
        version   u8   PROTO_VERSION — checked on BOTH ends; a server
                       answers a mismatched frame with ERR code
                       "VERSION" (framed under ITS version) so old
                       clients fail with ProtocolMismatch, not garbage
        type      u8   message type (MSG_*)
        req_id    u32  request correlation id, echoed in the reply
        body_len  u32  payload byte count (<= MAX_FRAME)
        body_crc  u32  crc32 of the payload
    body (body_len bytes)

Bodies are hand-rolled ``struct`` packing — no msgpack, no pickle.
Block payloads are NOT re-encoded for the wire: a GET reply body *is* a
TGI2 block (``serialize.assemble_block`` of the projected columns), so
per-column crc32s ride end to end and a corrupt reply surfaces as
``BlockCorruption`` on decode, which the client treats as a replica
failure (failover), exactly like a corrupt local disk read.

Decoding is total: truncated, oversized, corrupt, or garbage frames
raise *typed* errors (``FrameError`` / ``FrameTooLarge`` /
``FrameCorrupt`` / ``ProtocolMismatch``) — never a hang, never a
silent mis-parse.  ``decode_frame`` is a pure bytes->Frame function so
the codec is fuzzable without sockets.

Protocol v2 (pipelining + feed compaction):

* **Streaming replies.** A MULTIGET no longer answers with one giant
  OK frame: the server sends one ``MSG_CHUNK`` frame per found key
  (body: ``pack_key + pack_blob``) followed by one ``MSG_END`` frame
  (body: ``<I found_count>``), all under the request's ``req_id``.
  The client starts decoding (and filling its BlockPool) from the
  first CHUNK while the server is still reading later keys, and a
  multiplexed connection can interleave CHUNK streams of concurrent
  requests — the demux key is ``req_id``, not arrival order.
* **Ack piggyback.** The writer client appends a trailing ``<Q
  ack_watermark>`` to PUT / DELETE / PING bodies: the highest seq S
  such that, as far as this client can prove, EVERY cell has applied
  every record it owns with seq <= S (min over nodes of observed
  ``last_seq``, clamped below any queued redelivery).  Cells use the
  watermark to truncate ``feed.log`` (see ``cell.py``); the field is
  optional — an empty PING body or a v1-shaped write body means "no
  ack claim".
* **Feed floor + full-state transfer.** FEED_SINCE replies are
  prefixed with the cell's per-lane floor map (the highest truncated
  seq per writer lane; records at or below their lane's floor are no
  longer in the feed).  A peer that needs records below a floor
  bootstraps via ``MSG_PLACEMENTS`` (list the cell's chunk placements)
  + ``MSG_STATE_PULL`` (verbatim chunk + extent file bytes for one
  placement, plus per-key accounting) — chunk files are pure functions
  of the record set, so copying them preserves the
  byte-identical-convergence property.

Protocol v3 (lease-fenced multi-writer):

* **Versioned seqs.** Every write is stamped with a ``vseq`` — the
  writer's fencing ``epoch`` and its lane-local ``seq`` packed into
  one u64 (``kvstore.make_vseq``; numeric order == lexicographic
  ``(epoch, seq)`` order).  N concurrent writers each own one epoch
  lane; cells merge the lanes deterministically because every per-key
  conflict resolves to the max vseq, whatever the arrival order.
* **Writer leases.** ``MSG_LEASE`` carries acquire / renew / release
  for a time-bounded writer lease: an epoch is granted iff it exceeds
  every epoch the cell has seen (monotonic fencing), a write in lane
  ``e`` refreshes lane ``e``'s lease (heartbeat piggybacked on
  writes), and a write into a *sealed* lane above its seal point is
  rejected with the typed ``ERR_LEASE_FENCED`` — never silently
  applied.
* **Orphan-seq reconciliation.** ``MSG_RECONCILE`` queries a lane's
  replica high-water marks and broadcasts the agreed *seal*: cells
  anti-entropy the dead lane from their peers up to the max
  replica-acked record, fence the lane at that point, and advance the
  lane's ack coverage so feed truncation resumes instead of stranding
  the floor behind a hard-killed writer forever.
* **Shared-secret auth (opt-in).** A cell configured with an auth key
  answers HELLO with ``MSG_AUTH`` carrying a random nonce; the client
  must reply ``MSG_AUTH`` with ``HMAC-SHA256(key, nonce)`` before any
  other frame is served.  A wrong or missing response gets the typed
  ``ERR_AUTH_FAILED`` and a closed connection.
"""
from __future__ import annotations

import socket
import struct
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

from repro_torch.storage.kvstore import (DeltaKey,  # noqa: F401 — re-exported
                                   make_vseq, split_vseq)

PROTO_VERSION = 3
FRAME_MAGIC = b"TW"
HEADER = struct.Struct("<2sBBIII")  # magic, version, type, req_id, len, crc
MAX_FRAME = 1 << 28  # 256 MiB: far above any block, far below a bomb

(MSG_HELLO, MSG_OK, MSG_ERR, MSG_PING, MSG_GET, MSG_MULTIGET, MSG_PUT,
 MSG_DELETE, MSG_FEED_SINCE, MSG_STATUS, MSG_KEYS,
 MSG_MAINT, MSG_CHUNK, MSG_END, MSG_PLACEMENTS,
 MSG_STATE_PULL, MSG_LEASE, MSG_RECONCILE, MSG_AUTH) = range(1, 20)

# ERR body codes (pack_str'd): the client maps these back to the local
# store's exception types so failure semantics match the local backend
ERR_KEY_MISSING = "KEY_MISSING"
ERR_BAD_REQUEST = "BAD_REQUEST"
ERR_INTERNAL = "INTERNAL"
ERR_VERSION = "VERSION"
# requested feed history predates the truncation floor and the cell
# cannot serve a full-state transfer (mem backend): caller must either
# bootstrap from a file-backed replica or accept the typed failure
ERR_FEED_TRUNCATED = "FEED_TRUNCATED"
# write stamped into a sealed (fenced) lane above its seal point: the
# writer's lease expired and a reconciliation pass closed the lane, or
# a newer writer fenced it — the write must NOT be applied anywhere
ERR_LEASE_FENCED = "LEASE_FENCED"
# HELLO auth handshake failed: wrong or missing shared-secret HMAC
ERR_AUTH_FAILED = "AUTH_FAILED"

# change-feed record ops
OP_PUT = 0
OP_DELETE = 1

# MAINT body flags (an empty MAINT body means "vacuum only" — the v1
# shape).  TRUNCATE forces a synchronous feed truncation up to the
# cell's ack coverage regardless of backlog size, so benches/tests can
# reach a deterministic final feed state before comparing files.
# CANON runs a *synchronous* canonical vacuum (chunk records reordered
# by record key — the byte-identity anchor under multi-writer
# interleave; see ``DeltaStore.vacuum(canonical=True)``).
MAINT_VACUUM = 1
MAINT_TRUNCATE = 2
MAINT_CANON = 4

# MSG_LEASE ops
LEASE_ACQUIRE = 1
LEASE_RENEW = 2
LEASE_RELEASE = 3

# MSG_RECONCILE ops.  PREPARE runs between QUERY and SEAL: every cell
# anti-entropies its lane gaps from the peer list while every feed is
# still intact — sealing truncates, so nobody may seal until the whole
# cluster holds what it owns.
RECONCILE_QUERY = 1
RECONCILE_SEAL = 2
RECONCILE_PREPARE = 3

# auth handshake sizes: the server's random challenge and the client's
# HMAC-SHA256 response
AUTH_NONCE_LEN = 16
AUTH_MAC_LEN = 32


class WireError(RuntimeError):
    """Base of every wire-protocol error."""


class FrameError(WireError):
    """Malformed frame: bad magic, truncated header/body, or trailing
    garbage where a frame boundary should be."""


class FrameTooLarge(WireError):
    """Declared body length exceeds MAX_FRAME — rejected before any
    body byte is read, so a hostile length can't balloon memory."""


class FrameCorrupt(WireError):
    """Body bytes fail the header's crc32."""


class ProtocolMismatch(WireError):
    """Peer speaks a different PROTO_VERSION."""


class ConnectionClosed(WireError):
    """Clean EOF between frames (peer went away)."""


class LeaseFenced(WireError):
    """A write carried an epoch whose lane is sealed at or below the
    write's seq: the writer's lease expired (or a newer writer fenced
    it) and reconciliation closed the lane.  The write was NOT applied;
    the writer must degrade and re-acquire a fresh epoch."""


class AuthFailed(WireError):
    """The HELLO auth handshake failed: the cell requires a shared
    secret this client lacks, the HMAC response was wrong, or the cell
    refused an unauthenticated request."""


class RemoteError(WireError):
    """Server-side failure relayed through an ERR frame."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class Frame(NamedTuple):
    version: int
    msg_type: int
    req_id: int
    body: bytes


# ---------------------------------------------------------------------------
# frame codec (pure bytes <-> Frame; the socket layer wraps these)
# ---------------------------------------------------------------------------


def encode_frame(msg_type: int, req_id: int, body: bytes = b"",
                 version: int = PROTO_VERSION) -> bytes:
    if len(body) > MAX_FRAME:
        raise FrameTooLarge(f"body of {len(body)} bytes exceeds MAX_FRAME")
    return HEADER.pack(FRAME_MAGIC, version, msg_type, req_id, len(body),
                       zlib.crc32(body) & 0xFFFFFFFF) + body


def decode_frame(data: bytes) -> Tuple[Frame, int]:
    """Decode one complete frame from the head of ``data``; returns
    ``(frame, bytes_consumed)``.  Raises typed errors on anything that
    is not a well-formed frame — a decoder that can't throw can only
    hang or mis-parse."""
    if len(data) < HEADER.size:
        raise FrameError(f"truncated header: {len(data)} < {HEADER.size} bytes")
    magic, version, msg_type, req_id, body_len, body_crc = HEADER.unpack_from(data)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if body_len > MAX_FRAME:
        raise FrameTooLarge(f"declared body of {body_len} bytes exceeds MAX_FRAME")
    end = HEADER.size + body_len
    if len(data) < end:
        raise FrameError(f"truncated body: have {len(data) - HEADER.size} "
                         f"of {body_len} bytes")
    body = bytes(data[HEADER.size:end])
    if zlib.crc32(body) & 0xFFFFFFFF != body_crc:
        raise FrameCorrupt("frame body crc32 mismatch")
    return Frame(version, msg_type, req_id, body), end


def _recv_exact(sock: socket.socket, n: int, mid_frame: bool) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0 and not mid_frame:
                raise ConnectionClosed("peer closed the connection")
            raise FrameError(f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, msg_type: int, req_id: int,
               body: bytes = b"", version: int = PROTO_VERSION) -> None:
    sock.sendall(encode_frame(msg_type, req_id, body, version))


def recv_frame(sock: socket.socket) -> Frame:
    """Read one frame off a socket.  The header is validated before the
    body is read, so an oversized length raises without allocating."""
    head = _recv_exact(sock, HEADER.size, mid_frame=False)
    magic, version, msg_type, req_id, body_len, body_crc = HEADER.unpack(head)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if body_len > MAX_FRAME:
        raise FrameTooLarge(f"declared body of {body_len} bytes exceeds MAX_FRAME")
    body = _recv_exact(sock, body_len, mid_frame=True) if body_len else b""
    if zlib.crc32(body) & 0xFFFFFFFF != body_crc:
        raise FrameCorrupt("frame body crc32 mismatch")
    return Frame(version, msg_type, req_id, body)


class FrameReader:
    """Buffered frame reader for pipelined streams: one ``recv`` syscall
    can carry many frames (a multiget's CHUNK train, a burst of small
    requests), so the per-frame syscall pair of ``recv_frame`` collapses
    to ~one per buffer fill.  Same validation, same typed errors, same
    frames — only the socket read granularity changes.  Not for sharing
    between threads (buffered bytes belong to one reader)."""

    __slots__ = ("sock", "bufsize", "_buf")

    def __init__(self, sock: socket.socket, bufsize: int = 1 << 18):
        self.sock = sock
        self.bufsize = bufsize
        self._buf = bytearray()

    def _parse_one(self) -> Optional[Frame]:
        buf = self._buf
        if len(buf) < HEADER.size:
            return None
        magic, version, msg_type, req_id, body_len, body_crc = \
            HEADER.unpack_from(buf)
        if magic != FRAME_MAGIC:
            raise FrameError(f"bad frame magic {magic!r}")
        if body_len > MAX_FRAME:
            raise FrameTooLarge(
                f"declared body of {body_len} bytes exceeds MAX_FRAME")
        end = HEADER.size + body_len
        if len(buf) < end:
            return None
        body = bytes(buf[HEADER.size:end])
        if zlib.crc32(body) & 0xFFFFFFFF != body_crc:
            raise FrameCorrupt("frame body crc32 mismatch")
        del buf[:end]
        return Frame(version, msg_type, req_id, body)

    def _fill(self) -> None:
        chunk = self.sock.recv(self.bufsize)
        if not chunk:
            if self._buf:
                raise FrameError(
                    f"connection closed mid-frame ({len(self._buf)} "
                    f"buffered bytes)")
            raise ConnectionClosed("peer closed the connection")
        self._buf += chunk

    def next_frame(self) -> Frame:
        """Blocking read of the next frame (drop-in for ``recv_frame``)."""
        while True:
            frame = self._parse_one()
            if frame is not None:
                return frame
            self._fill()

    def read_frames(self) -> List[Frame]:
        """Block until at least one frame is available, then return every
        complete frame currently buffered — the demux loop's batch unit."""
        out: List[Frame] = []
        while True:
            frame = self._parse_one()
            if frame is None:
                if out:
                    return out
                self._fill()
            else:
                out.append(frame)


# ---------------------------------------------------------------------------
# body packing helpers (hand-rolled struct, no external codec)
# ---------------------------------------------------------------------------


def _need(buf: bytes, off: int, n: int, what: str) -> None:
    if off + n > len(buf):
        raise FrameError(f"truncated {what}: need {n} bytes at offset {off}, "
                         f"have {len(buf) - off}")


def pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    _need(buf, off, 2, "string length")
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    _need(buf, off, n, "string body")
    return buf[off:off + n].decode(), off + n


def pack_key(key: DeltaKey) -> bytes:
    return struct.pack("<qqq", key.tsid, key.sid, key.pid) + pack_str(key.did)


def unpack_key(buf: bytes, off: int) -> Tuple[DeltaKey, int]:
    tsid, sid, pid = struct.unpack_from("<qqq", buf, off)
    did, off = unpack_str(buf, off + 24)
    return DeltaKey(tsid, sid, did, pid), off


# u16 0xFFFF marks "no projection" (fields=None: every column); 0 is a
# legal empty projection
_ALL_FIELDS = 0xFFFF


def pack_fields(fields: Optional[List[str]]) -> bytes:
    if fields is None:
        return struct.pack("<H", _ALL_FIELDS)
    assert len(fields) < _ALL_FIELDS
    return struct.pack("<H", len(fields)) + b"".join(pack_str(f) for f in fields)


def unpack_fields(buf: bytes, off: int) -> Tuple[Optional[List[str]], int]:
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    if n == _ALL_FIELDS:
        return None, off
    out = []
    for _ in range(n):
        f, off = unpack_str(buf, off)
        out.append(f)
    return out, off


def pack_blob(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def unpack_blob(buf: bytes, off: int) -> Tuple[bytes, int]:
    _need(buf, off, 4, "blob length")
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    _need(buf, off, n, "blob body")
    return bytes(buf[off:off + n]), off + n


def pack_lanes(lanes: Dict[int, int]) -> bytes:
    """Per-lane ``{epoch: seq}`` map (floor maps, seal maps, ack maps),
    emitted in sorted epoch order so the bytes are a pure function of
    the mapping — lane maps ride ``feed.base`` and the byte-identity
    property extends to them."""
    out = [struct.pack("<I", len(lanes))]
    for epoch in sorted(lanes):
        out.append(struct.pack("<QQ", epoch, lanes[epoch]))
    return b"".join(out)


def unpack_lanes(buf: bytes, off: int) -> Tuple[Dict[int, int], int]:
    _need(buf, off, 4, "lane count")
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    lanes: Dict[int, int] = {}
    for _ in range(n):
        _need(buf, off, 16, "lane entry")
        epoch, seq = struct.unpack_from("<QQ", buf, off)
        off += 16
        lanes[epoch] = seq
    return lanes, off


def pack_peers(peers: List[Tuple[str, int]]) -> bytes:
    """Cluster address list: LEASE acquire and RECONCILE seal frames
    carry it so cells learn the topology they need for lease-expiry
    reconciliation (anti-entropy pulls peer feeds)."""
    out = [struct.pack("<I", len(peers))]
    for host, port in peers:
        out.append(pack_str(host) + struct.pack("<H", port))
    return b"".join(out)


def unpack_peers(buf: bytes, off: int) -> Tuple[List[Tuple[str, int]], int]:
    _need(buf, off, 4, "peer count")
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    peers: List[Tuple[str, int]] = []
    for _ in range(n):
        host, off = unpack_str(buf, off)
        _need(buf, off, 2, "peer port")
        (port,) = struct.unpack_from("<H", buf, off)
        off += 2
        peers.append((host, port))
    return peers, off


class FeedRecord(NamedTuple):
    """One change-feed entry: a client-stamped ``seq`` plus the write it
    carries.  ``seq`` is a *vseq* — the writer's fencing epoch and its
    lane-local counter packed into one u64 (``kvstore.make_vseq``), so
    the u64 order is the cluster-wide (epoch, seq) total order; legacy
    single-writer records live in epoch 0 unchanged.  ``blob`` is the
    encoded block verbatim (``raw_bytes`` rides along for storage
    accounting); DELETE records carry an empty blob.  Applying a record
    set in vseq order — or any order, once per-key conflicts resolve to
    the max vseq and a canonical vacuum pass orders the chunk bytes —
    reproduces a cell's files byte for byte: the catch-up convergence
    property, extended to N concurrent writer lanes."""

    seq: int
    op: int  # OP_PUT | OP_DELETE
    key: DeltaKey
    raw_bytes: int
    blob: bytes

    def pack(self) -> bytes:
        return (struct.pack("<QB", self.seq, self.op) + pack_key(self.key)
                + struct.pack("<Q", self.raw_bytes) + pack_blob(self.blob))

    @staticmethod
    def unpack(buf: bytes, off: int) -> Tuple["FeedRecord", int]:
        seq, op = struct.unpack_from("<QB", buf, off)
        key, off = unpack_key(buf, off + 9)
        (raw,) = struct.unpack_from("<Q", buf, off)
        blob, off = unpack_blob(buf, off + 8)
        return FeedRecord(seq, op, key, raw, blob), off


def pack_records(records: List[FeedRecord]) -> bytes:
    return struct.pack("<I", len(records)) + b"".join(r.pack() for r in records)


def unpack_records(buf: bytes, off: int = 0) -> List[FeedRecord]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    out = []
    for _ in range(n):
        rec, off = FeedRecord.unpack(buf, off)
        out.append(rec)
    return out


def pack_err(code: str, message: str) -> bytes:
    return pack_str(code) + pack_str(message)


def unpack_err(buf: bytes) -> Tuple[str, str]:
    code, off = unpack_str(buf, 0)
    message, _ = unpack_str(buf, off)
    return code, message


# ---------------------------------------------------------------------------
# full-state transfer (bootstrap past a truncated feed)
# ---------------------------------------------------------------------------


class PlacementState(NamedTuple):
    """STATE_PULL reply for one ``(tsid, sid)`` placement: the replica's
    chunk + extent file bytes *verbatim* (chunk files are pure functions
    of the applied record set, so copying them preserves byte-identical
    convergence), plus the per-key accounting a restored cell needs:
    live ``(key, raw, enc)`` sizes and the per-key max-vseq watermark
    (including deleted keys, whose watermark guards replays), plus the
    serving cell's per-lane floor and seal maps at pull time."""

    floors: Dict[int, int]  # serving cell's per-lane feed floors
    seals: Dict[int, int]   # serving cell's sealed (fenced) lanes
    chunk: bytes
    ext: bytes
    sizes: List[Tuple[DeltaKey, int, int]]
    key_seqs: List[Tuple[DeltaKey, int]]

    def pack(self) -> bytes:
        out = [pack_lanes(self.floors), pack_lanes(self.seals),
               pack_blob(self.chunk),
               pack_blob(self.ext), struct.pack("<I", len(self.sizes))]
        for key, raw, enc in self.sizes:
            out.append(pack_key(key) + struct.pack("<QQ", raw, enc))
        out.append(struct.pack("<I", len(self.key_seqs)))
        for key, seq in self.key_seqs:
            out.append(pack_key(key) + struct.pack("<Q", seq))
        return b"".join(out)

    @staticmethod
    def unpack(buf: bytes) -> "PlacementState":
        floors, off = unpack_lanes(buf, 0)
        seals, off = unpack_lanes(buf, off)
        chunk, off = unpack_blob(buf, off)
        ext, off = unpack_blob(buf, off)
        _need(buf, off, 4, "state size count")
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        sizes = []
        for _ in range(n):
            key, off = unpack_key(buf, off)
            _need(buf, off, 16, "state key sizes")
            raw, enc = struct.unpack_from("<QQ", buf, off)
            off += 16
            sizes.append((key, raw, enc))
        _need(buf, off, 4, "state seq count")
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        key_seqs = []
        for _ in range(n):
            key, off = unpack_key(buf, off)
            _need(buf, off, 8, "state key seq")
            (seq,) = struct.unpack_from("<Q", buf, off)
            off += 8
            key_seqs.append((key, seq))
        return PlacementState(floors, seals, chunk, ext, sizes, key_seqs)


def pack_placements(placements: List[Tuple[int, int]]) -> bytes:
    return (struct.pack("<I", len(placements))
            + b"".join(struct.pack("<qq", t, s) for t, s in placements))


def unpack_placements(buf: bytes) -> List[Tuple[int, int]]:
    _need(buf, 0, 4, "placement count")
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = []
    for _ in range(n):
        _need(buf, off, 16, "placement entry")
        t, s = struct.unpack_from("<qq", buf, off)
        off += 16
        out.append((t, s))
    return out
