"""Typed, versioned binary (de)serialization for delta payloads.

Two wire formats live behind one ``dumps``/``loads`` API, dispatched on
the 4-byte MAGIC (see docs/storage_format.md for the byte-level spec):

* **TGI1** — fixed-layout header + raw little-endian arrays.  mmap
  friendly, zero-copy on read, byte-stable.  Still written on request
  (``dumps(..., fmt="TGI1")``) and always readable: old blobs keep
  loading byte-identically (golden-blob tested).

* **TGI2** — compressed columnar blocks.  A per-column directory
  (name, dtype, shape, encoding, encoded length) precedes the payloads,
  so a ``fields=`` projection *seeks over* unread columns without
  decompressing them.  Encodings are chosen per column at write time by
  actual encoded size:

      0 RAW           verbatim little-endian bytes (also every column at
                      or below RAW_KEEP_BYTES — decode-latency floor)
      1 DELTA_VARINT  first value as fixed int64, then LEB128 varints of
                      the deltas — sorted int columns (event times,
                      packed edge keys, slot ids) shrink to ~1 byte/value
                      and decode as one cast + cumsum
      2 BITPACK       booleans at 1 bit/value (np.packbits)
      3 DICT          low-cardinality columns: sorted uniques +
                      bit-packed codes ({1,2,4,8} bits/value, LUT decode)
      4 ZLIB          zlib of the raw bytes — the fallback for
                      everything else (floats, high-entropy columns)
      5 NARROW        frame-of-reference: min + offsets cast to the
                      smallest unsigned width — bounded-range int
                      columns (node ids, attr values) at memcpy-like
                      decode speed
      6 DELTA_NARROW  delta + frame-of-reference: sorted columns whose
                      diffs overflow 7 bits, one branch-free cumsum pass

The chooser weighs candidate sizes by decode-speed class under a per-
block *profile*: "size" for cold blocks (hierarchy, checkpoints),
"speed" for the replay hot path (eventlists), where an encoding must
buy roughly an order of magnitude before displacing raw.  The codecs
are numpy-vectorized (no per-value Python on either hot path);
``loads_sized`` additionally reports (encoded bytes touched, raw bytes
materialized) so the kvstore/FetchCost layers can account compression.

Every TGI2 directory entry carries a crc32 of its encoded payload,
verified on decode (``BlockCorruption`` on mismatch), and the absolute
payload offsets make the directory a *range map*: ``parse_directory``
parses it from a byte prefix and ``decode_entry`` decodes one column
from its own payload bytes — the kvstore's range-seek file backend and
decoded-block buffer pool are built on these two hooks.
"""
from __future__ import annotations

import io
import math
import struct
import zlib
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

MAGIC = b"TGI1"
MAGIC2 = b"TGI2"
DEFAULT_FORMAT = "TGI2"
# high bit of the TGI2 column-count word: directory entries carry a
# trailing u32 crc32 (the pre-checksum layout has the bit clear, and
# its 17-byte entry tail keeps loading — no rewrite needed)
DIR_HAS_CRC = 0x80000000
ZLIB_LEVEL = 6
RAW_KEEP_BYTES = 128  # columns at or below this stay raw (decode-latency floor)
DICT_MAX_ELEMS = 1 << 16  # skip np.unique-based dict probing above this
DELTA_MAX_ELEMS = 1 << 17  # skip the sortedness scan / delta coding above this
ZLIB_PROBE_BYTES = 1 << 16  # above this, probe a 4 KiB prefix before zlib-6

_DT_CODE = {
    np.dtype(np.bool_): 0, np.dtype(np.int8): 1, np.dtype(np.int16): 2,
    np.dtype(np.int32): 3, np.dtype(np.int64): 4, np.dtype(np.float32): 5,
    np.dtype(np.float64): 6, np.dtype(np.uint8): 7, np.dtype(np.uint32): 8,
    np.dtype(np.bfloat16) if hasattr(np, "bfloat16") else np.dtype(np.void): 9,
    # TGI2 additions (new codes only — existing TGI1 bytes are unchanged)
    np.dtype(np.uint16): 10, np.dtype(np.uint64): 11, np.dtype(np.float16): 12,
}
_CODE_DT = {v: k for k, v in _DT_CODE.items()}

# TGI2 column encodings
(ENC_RAW, ENC_DELTA_VARINT, ENC_BITPACK, ENC_DICT, ENC_ZLIB,
 ENC_NARROW, ENC_DELTA_NARROW) = range(7)
ENC_NAME = {0: "raw", 1: "delta_varint", 2: "bitpack", 3: "dict",
            4: "zlib", 5: "narrow", 6: "delta_narrow"}
# decode-speed weights: the chooser minimizes stored_bytes * weight, so
# a slower-decoding encoding must buy proportionally more compression to
# take the column (raw/narrow decode at memcpy speed; dict is one table
# lookup; delta-varint pays a cumsum + varint scan; zlib a full inflate).
# The "size" profile (hierarchy deltas, checkpoints — fetched a few
# blobs per query) leans toward compression; the "speed" profile
# (eventlists — the replay hot path reads dozens of blobs per snapshot)
# keeps a column raw unless an encoding pays for its decode with roughly
# an order of magnitude of compression — which the killers (delta-coded
# event times, extreme dictionaries) still clear.
ENC_WEIGHTS = {
    "size": {ENC_RAW: 1.0, ENC_NARROW: 1.0, ENC_BITPACK: 1.0,
             ENC_DICT: 1.25, ENC_DELTA_VARINT: 1.8, ENC_ZLIB: 4.0,
             ENC_DELTA_NARROW: 1.1},
    "speed": {ENC_RAW: 1.0, ENC_NARROW: 12.0, ENC_BITPACK: 4.0,
              ENC_DICT: 12.0, ENC_DELTA_VARINT: 5.0, ENC_ZLIB: 24.0,
              ENC_DELTA_NARROW: 1.5},
}

# int dtypes safe to round-trip through int64 delta/narrow coding
_VARINTABLE = {np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32),
               np.dtype(np.int64), np.dtype(np.uint8), np.dtype(np.uint16),
               np.dtype(np.uint32)}


class BlockCorruption(RuntimeError):
    """A stored column failed its crc32 check: the payload bytes on
    storage do not match what the writer recorded.  Raised *before* any
    decode, so corruption surfaces as a clear error instead of silently
    mis-decoded arrays."""


class ColumnMeta(NamedTuple):
    """One directory entry: everything needed to locate, verify, and
    decode a single column without touching the rest of the block.
    ``off``/``length`` are byte positions relative to the block start;
    ``crc`` is the crc32 of the *encoded* payload (None for TGI1 blocks,
    which predate checksums)."""

    name: str
    dtype: np.dtype
    shape: Tuple[int, ...]
    enc: int
    off: int
    length: int
    crc: Optional[int]


# ---------------------------------------------------------------------------
# varint codec (vectorized LEB128)
# ---------------------------------------------------------------------------


def _uvarint_encode(vals: np.ndarray) -> bytes:
    """LEB128-encode a uint64 array (one unrolled pass per byte position)."""
    v = np.ascontiguousarray(vals, np.uint64)
    if v.size == 0:
        return b""
    nb = np.ones(v.shape, np.int64)
    x = v >> np.uint64(7)
    while x.any():
        nb += x != 0
        x >>= np.uint64(7)
    offs = np.zeros(v.size + 1, np.int64)
    np.cumsum(nb, out=offs[1:])
    out = np.zeros(int(offs[-1]), np.uint8)
    for i in range(int(nb.max())):
        sel = nb > i
        byte = ((v[sel] >> np.uint64(7 * i)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nb[sel] - 1 > i).astype(np.uint8) << 7
        out[offs[:-1][sel] + i] = byte | cont
    return out.tobytes()


def _uvarint_decode(buf, count: int) -> np.ndarray:
    """Decode ``count`` LEB128 values.  Delta streams are dominated by
    1-byte values, so the decoder treats multi-byte values as the
    exception: the terminator byte of every value lands in one
    vectorized gather (for 1-byte values that IS the value), then the
    few multi-byte values are patched — scalar when they are rare,
    one fancy-indexed pass per byte position when they are not."""
    if count == 0:
        return np.zeros(0, np.uint64)
    b = np.frombuffer(buf, np.uint8)
    if len(b) == count:  # every value fits 7 bits
        return b.astype(np.uint64)
    ends = np.flatnonzero(b < 0x80)  # terminator byte of each value
    assert len(ends) == count, "varint stream/count mismatch"
    vals = b[ends].astype(np.uint64)  # terminators have the high bit clear
    n_cont = len(b) - count
    if n_cont <= 8:
        # rare multi-byte values: find each continuation run's start and
        # rebuild just those values in Python (bounded tiny loop)
        cont = np.flatnonzero(b & 0x80)
        run_starts = cont[np.diff(cont, prepend=-2) > 1]
        raw = bytes(buf) if not isinstance(buf, bytes) else buf
        for s in run_starts:
            v, shift, j = 0, 0, int(s)
            while raw[j] & 0x80:
                v |= (raw[j] & 0x7F) << shift
                shift += 7
                j += 1
            v |= raw[j] << shift
            vals[np.searchsorted(ends, j)] = v
        return vals
    starts = np.empty(count, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    nb = ends - starts + 1
    vals = (b[starts] & 0x7F).astype(np.uint64)
    for i in range(1, int(nb.max())):
        sel = np.flatnonzero(nb > i)
        vals[sel] |= (b[starts[sel] + i] & np.uint8(0x7F)).astype(np.uint64) \
            << np.uint64(7 * i)
    return vals


# ---------------------------------------------------------------------------
# per-column encoders
# ---------------------------------------------------------------------------


def _enc_delta_varint(arr: np.ndarray) -> bytes:
    v = arr.astype(np.int64).ravel()
    # first value fixed-width, out of the varint stream: diff streams are
    # mostly 1-byte values, and keeping the (large) first value out lets
    # the decoder's single-cast fast path fire
    diffs = np.diff(v).astype(np.uint64)  # non-decreasing -> diffs >= 0
    return struct.pack("<q", int(v[0])) + _uvarint_encode(diffs)


def _dec_delta_varint(payload, count: int, dt: np.dtype) -> np.ndarray:
    (first,) = struct.unpack_from("<q", payload, 0)
    b = np.frombuffer(payload, np.uint8, offset=8)
    out = np.empty(count, np.int64)
    out[0] = first
    if len(b) == count - 1:  # all diffs fit 7 bits: cumsum straight off
        np.add(np.cumsum(b, dtype=np.int64), first, out=out[1:])
    else:
        diffs = _uvarint_decode(b, count - 1).astype(np.int64)
        np.cumsum(diffs, out=diffs)
        np.add(diffs, first, out=out[1:])
    return out if dt == np.int64 else out.astype(dt)


# code widths are restricted to {1, 2, 4, 8} bits so a packed byte holds
# a whole number of codes and decodes through one 256-entry table lookup
_CODE_LUT: Dict[int, np.ndarray] = {}


def _code_lut(bits: int) -> np.ndarray:
    lut = _CODE_LUT.get(bits)
    if lut is None:
        byte = np.arange(256, dtype=np.uint8)
        per = 8 // bits
        lut = np.stack(
            [(byte >> (i * bits)) & ((1 << bits) - 1) for i in range(per)], 1
        )
        _CODE_LUT[bits] = lut
    return lut


def _enc_delta_narrow(arr: np.ndarray) -> Optional[bytes]:
    """Delta + frame-of-reference: fixed int64 first value, then the
    (non-negative) diffs min-subtracted and cast to the smallest
    unsigned width.  Slightly larger than delta+varint but decodes in
    one branch-free frombuffer+cumsum pass — the hot-profile choice for
    sorted columns whose diffs overflow 7 bits."""
    v = arr.astype(np.int64).ravel()
    body = _enc_narrow(np.diff(v))
    if body is None:
        return None
    return struct.pack("<q", int(v[0])) + body


def _dec_delta_narrow(payload, count: int, dt: np.dtype) -> np.ndarray:
    (first,) = struct.unpack_from("<q", payload, 0)
    diffs = _dec_narrow(payload[8:], count - 1, np.dtype(np.int64))
    out = np.empty(count, np.int64)
    out[0] = first
    np.cumsum(diffs, out=diffs)
    np.add(diffs, first, out=out[1:])
    return out if dt == np.int64 else out.astype(dt)


def _enc_dict(arr: np.ndarray) -> Optional[bytes]:
    flat = arr.ravel()
    uniq, codes = np.unique(flat, return_inverse=True)
    if len(uniq) > 256:
        return None
    n_bits = max(1, int(len(uniq) - 1).bit_length())
    bits = next(b for b in (1, 2, 4, 8) if b >= n_bits)
    per = 8 // bits
    pad = (-len(codes)) % per
    codes = np.concatenate([codes, np.zeros(pad, codes.dtype)]).astype(np.uint8)
    grouped = codes.reshape(-1, per) << (np.arange(per, dtype=np.uint8) * bits)
    packed = np.bitwise_or.reduce(grouped, 1).astype(np.uint8)
    return (struct.pack("<HB", len(uniq), bits)
            + np.ascontiguousarray(uniq).tobytes() + packed.tobytes())


def _dec_dict(payload, count: int, dt: np.dtype) -> np.ndarray:
    n_uniq, bits = struct.unpack_from("<HB", payload, 0)
    uniq = np.frombuffer(payload, dt, count=n_uniq, offset=3)
    if n_uniq == 1:  # constant column (all-unset attrs, all-alive flags)
        return np.full(count, uniq[0], dt)
    off = 3 + n_uniq * dt.itemsize
    codes = np.frombuffer(payload, np.uint8, count=count if bits == 8 else -1,
                          offset=off)
    if bits != 8:
        codes = _code_lut(bits)[codes].ravel()[:count]
    return uniq[codes]


def _enc_narrow(arr: np.ndarray) -> Optional[bytes]:
    """Frame-of-reference: subtract the min, cast to the smallest
    unsigned width.  Near-varint compression for bounded-range columns
    (node ids, attr values) at a fraction of the decode cost."""
    flat = arr.astype(np.int64).ravel()
    mn = int(flat.min())
    rng = int(flat.max()) - mn
    width = next((w for w, lim in ((1, 1 << 8), (2, 1 << 16), (4, 1 << 32))
                  if rng < lim and w < arr.dtype.itemsize), None)
    if width is None:
        return None
    offs = (flat - mn).astype({1: np.uint8, 2: np.uint16, 4: np.uint32}[width])
    return struct.pack("<Bq", width, mn) + offs.tobytes()


def _dec_narrow(payload, count: int, dt: np.dtype) -> np.ndarray:
    width, mn = struct.unpack_from("<Bq", payload, 0)
    offs = np.frombuffer(payload, {1: np.uint8, 2: np.uint16, 4: np.uint32}[width],
                         count=count, offset=9)
    # offs + mn is an original value, so it fits dt: one fused add+cast
    return np.add(offs, dt.type(mn), dtype=dt)


def _encode_column(arr: np.ndarray, profile: str = "size") -> Tuple[int, bytes]:
    """Pick the encoding for one column (write-time choice).  Candidates
    are actually encoded and compared by size — the blocks are small
    (KBs), so paying encode cost per candidate at write time buys an
    exact choice instead of a heuristic one.  Candidates compete on
    stored_bytes x weight (decode-speed class, per ``profile``), so a
    slow decoder must buy proportionally more compression to take the
    column."""
    weights = ENC_WEIGHTS[profile]
    raw = arr.tobytes()
    if len(raw) <= RAW_KEEP_BYTES:
        # tiny columns: a fancy decode costs more wall time than the
        # handful of bytes it saves — keep them verbatim
        return ENC_RAW, raw
    if arr.dtype == np.bool_:
        return ENC_BITPACK, np.packbits(arr.ravel(), bitorder="little").tobytes()
    cands = [(ENC_RAW, raw)]
    if arr.dtype in _VARINTABLE:
        flat = arr.ravel()
        probes = [(ENC_NARROW, _enc_narrow(arr))]
        if arr.size <= DICT_MAX_ELEMS:  # np.unique is too costly above
            probes.append((ENC_DICT, _enc_dict(arr)))
        for enc, payload in probes:
            if payload is not None:
                cands.append((enc, payload))
        if arr.ndim == 1 and 1 < arr.size <= DELTA_MAX_ELEMS and (
                np.diff(flat.astype(np.int64)) >= 0).all():
            cands.append((ENC_DELTA_VARINT, _enc_delta_varint(arr)))
            cand = _enc_delta_narrow(arr)
            if cand is not None:
                cands.append((ENC_DELTA_NARROW, cand))
    if len(raw) > ZLIB_PROBE_BYTES:
        # big blocks (checkpoint tensors, pre-compressed payloads): only
        # pay a full zlib-6 pass if a cheap prefix probe shows compression
        probe = zlib.compress(raw[:4096], 1)
        try_zlib = len(probe) < int(0.9 * 4096)
    else:
        try_zlib = True
    if try_zlib:
        z = zlib.compress(raw, ZLIB_LEVEL)
        if len(z) < len(raw):
            cands.append((ENC_ZLIB, z))
    return min(cands, key=lambda c: len(c[1]) * weights[c[0]])


def _decode_column(enc: int, payload, shape, dt: np.dtype) -> np.ndarray:
    count = math.prod(shape)
    if enc == ENC_RAW:
        out = np.frombuffer(payload, dtype=dt, count=count)
    elif enc == ENC_BITPACK:
        out = np.unpackbits(
            np.frombuffer(payload, np.uint8), count=count, bitorder="little",
        ).astype(np.bool_)
    elif enc == ENC_DELTA_VARINT:
        out = _dec_delta_varint(payload, count, dt)
    elif enc == ENC_DICT:
        out = _dec_dict(payload, count, dt)
    elif enc == ENC_ZLIB:
        out = np.frombuffer(zlib.decompress(payload), dtype=dt, count=count)
    elif enc == ENC_NARROW:
        out = _dec_narrow(payload, count, dt)
    elif enc == ENC_DELTA_NARROW:
        out = _dec_delta_narrow(payload, count, dt)
    else:
        raise ValueError(f"unknown TGI2 column encoding {enc}")
    return out if len(shape) == 1 else out.reshape(shape)


# ---------------------------------------------------------------------------
# block writers
# ---------------------------------------------------------------------------


def _coerce(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    if np.dtype(arr.dtype) not in _DT_CODE:  # e.g. ml_dtypes.bfloat16
        arr = arr.view(np.uint8 if arr.dtype.itemsize == 1 else np.uint16)
    return arr


def _dumps_v1(arrays: Dict[str, np.ndarray]) -> bytes:
    """The original fixed-layout writer — kept byte-identical (golden)."""
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(struct.pack("<I", len(arrays)))
    for name, arr in sorted(arrays.items()):
        arr = _coerce(arr)
        nb = name.encode()
        buf.write(struct.pack("<H", len(nb)))
        buf.write(nb)
        buf.write(struct.pack("<BB", _DT_CODE[np.dtype(arr.dtype)], arr.ndim))
        buf.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
        buf.write(arr.tobytes())
    return buf.getvalue()


def _dumps_v2(arrays: Dict[str, np.ndarray], profile: str = "size") -> bytes:
    cols = []
    dir_len = 8  # MAGIC + column count
    for name, arr in sorted(arrays.items()):
        arr = _coerce(arr)
        enc, payload = _encode_column(arr, profile)
        nb = name.encode()
        cols.append((nb, arr, enc, payload))
        dir_len += 2 + len(nb) + 2 + 8 * arr.ndim + 21
    buf = io.BytesIO()
    buf.write(MAGIC2)
    buf.write(struct.pack("<I", len(cols) | DIR_HAS_CRC))
    off = dir_len
    for nb, arr, enc, payload in cols:  # directory, absolute payload offsets
        buf.write(struct.pack("<H", len(nb)))
        buf.write(nb)
        buf.write(struct.pack("<BB", _DT_CODE[np.dtype(arr.dtype)], arr.ndim))
        buf.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
        buf.write(struct.pack("<BQQI", enc, len(payload), off,
                              zlib.crc32(payload) & 0xFFFFFFFF))
        off += len(payload)
    for _, _, _, payload in cols:  # payloads, directory order
        buf.write(payload)
    return buf.getvalue()


def assemble_block(entries: List["ColumnMeta"],
                   payloads: Dict[str, bytes]) -> bytes:
    """Re-emit a TGI2 block from *already-encoded* columns — the service
    plane's projected-read path.  A StorageCell copies the requested
    columns' payload bytes verbatim (no decode, no re-encode) into a
    fresh block whose directory still lists EVERY column of the source
    blob, so the client learns the blob's full column set from a
    projected reply (its decoded-block pool needs the complete
    directory).  Entries without a payload keep their stored length but
    point at offset 0: decoding one fails its crc check loudly instead
    of silently returning garbage — readers must project to the supplied
    columns.  Columns sourced from a TGI1 blob (crc None) get a fresh
    crc32, so every reply is checksummed end to end."""
    dir_len = 8
    for e in entries:
        dir_len += 2 + len(e.name.encode()) + 2 + 8 * len(e.shape) + 21
    parts = [MAGIC2, struct.pack("<I", len(entries) | DIR_HAS_CRC)]
    tail = []
    off = dir_len
    for e in entries:
        nb = e.name.encode()
        payload = payloads.get(e.name)
        if payload is None:
            poff, crc = 0, (e.crc if e.crc is not None else 0)
        else:
            poff = off
            off += len(payload)
            crc = (e.crc if e.crc is not None
                   else zlib.crc32(payload) & 0xFFFFFFFF)
            tail.append(payload)
        parts.append(struct.pack(
            f"<H{len(nb)}sBB{len(e.shape)}qBQQI", len(nb), nb,
            _DT_CODE[np.dtype(e.dtype)], len(e.shape), *e.shape,
            e.enc, e.length, poff, crc))
    return b"".join(parts + tail)


def dumps(arrays: Dict[str, np.ndarray], fmt: Optional[str] = None,
          profile: str = "size") -> bytes:
    """Serialize a dict of ndarrays (``fmt`` in {"TGI1", "TGI2"}; default
    ``DEFAULT_FORMAT``).  ``profile`` biases the TGI2 per-column encoding
    choice: "size" (cold blocks) or "speed" (hot replay blocks)."""
    fmt = fmt or DEFAULT_FORMAT
    if fmt == "TGI1":
        return _dumps_v1(arrays)
    if fmt == "TGI2":
        return _dumps_v2(arrays, profile)
    raise ValueError(f"unknown serialization format {fmt!r}")


# ---------------------------------------------------------------------------
# readers (MAGIC-dispatched)
# ---------------------------------------------------------------------------


def _walk_v1(buf) -> List[ColumnMeta]:
    """TGI1 directory: headers interleave with payloads, so this is pure
    shape arithmetic over the whole blob.  Every column reads as ENC_RAW
    with no checksum (the format predates them)."""
    (n,) = struct.unpack_from("<I", buf, 4)
    off = 8
    out = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<H", buf, off)
        off += 2
        name = bytes(buf[off : off + ln]).decode()
        off += ln
        code, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        dt = _CODE_DT[code]
        nbytes = math.prod(shape) * dt.itemsize
        out.append(ColumnMeta(name, dt, tuple(shape), ENC_RAW, off, nbytes, None))
        off += nbytes
    return out


def parse_directory(prefix) -> Optional[List[ColumnMeta]]:
    """Parse a TGI2 directory from a byte *prefix* of the block.

    Returns the column list, or None when the prefix is too short to
    hold the whole directory — the range-seek backend reads a small
    prefix first, and grows it only for the rare block whose directory
    overflows it.  Raises on a non-TGI2 magic (the caller dispatches
    TGI1 blobs to a full read first)."""
    buf = memoryview(prefix)
    if len(buf) < 8:
        return None
    if bytes(buf[:4]) != MAGIC2:
        raise ValueError("not a TGI2 block")
    (raw_n,) = struct.unpack_from("<I", buf, 4)
    has_crc = bool(raw_n & DIR_HAS_CRC)
    n = raw_n & ~DIR_HAS_CRC
    tail = 21 if has_crc else 17  # enc + len + off (+ crc32)
    off = 8
    out = []
    for _ in range(n):
        if off + 4 > len(buf):
            return None
        (ln,) = struct.unpack_from("<H", buf, off)
        if off + 2 + ln + 2 > len(buf):
            return None
        name = bytes(buf[off + 2 : off + 2 + ln]).decode()
        off += 2 + ln
        code, ndim = struct.unpack_from("<BB", buf, off)
        if off + 2 + 8 * ndim + tail > len(buf):
            return None
        shape = struct.unpack_from(f"<{ndim}q", buf, off + 2)
        if has_crc:
            enc, plen, poff, crc = struct.unpack_from(
                "<BQQI", buf, off + 2 + 8 * ndim)
        else:  # pre-checksum directory layout: no crc to verify
            enc, plen, poff = struct.unpack_from("<BQQ", buf, off + 2 + 8 * ndim)
            crc = None
        off += 2 + 8 * ndim + tail
        out.append(ColumnMeta(name, _CODE_DT[code], tuple(shape), enc,
                              poff, plen, crc))
    return out


def walk(data) -> List[ColumnMeta]:
    """Directory of a complete block, MAGIC-dispatched (TGI1 or TGI2).
    The ONE implementation of both directory byte layouts — loads_sized,
    block_info, and the kvstore read paths all go through it."""
    buf = memoryview(data)
    magic = bytes(buf[:4])
    if magic == MAGIC:
        return _walk_v1(buf)
    if magic == MAGIC2:
        out = parse_directory(buf)
        assert out is not None, "bad TGI2 block (truncated directory)"
        return out
    raise AssertionError("bad TGI block (unknown MAGIC)")


def decode_entry(meta: ColumnMeta, payload) -> np.ndarray:
    """Decode one column from its encoded payload bytes, verifying the
    directory's crc32 first (TGI2): corruption raises ``BlockCorruption``
    *before* any decode instead of silently mis-decoding."""
    if meta.crc is not None and zlib.crc32(payload) & 0xFFFFFFFF != meta.crc:
        raise BlockCorruption(
            f"column {meta.name!r}: payload crc32 mismatch "
            f"(stored {meta.crc:#010x}, computed "
            f"{zlib.crc32(payload) & 0xFFFFFFFF:#010x})")
    return _decode_column(meta.enc, payload, meta.shape, meta.dtype)


def loads_sized(data: bytes, fields: Optional[Iterable[str]] = None,
                ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Deserialize a block; returns ``(arrays, encoded_read, raw_read)``.

    ``fields`` projects the read: only the named columns are decoded —
    the rest are *seeked over* via the directory offsets (TGI2) or shape
    arithmetic (TGI1), never decompressed or copied.  ``encoded_read``
    counts header + the projected columns' stored bytes (what actually
    crossed storage); ``raw_read`` counts the materialized bytes (the
    FetchCost bytes-decompressed dimension).  TGI2 payload checksums are
    verified on every decode (``BlockCorruption`` on mismatch)."""
    buf = memoryview(data)
    want = None if fields is None else set(fields)
    out: Dict[str, np.ndarray] = {}
    enc_read = 8  # MAGIC + count (per-column headers are ~free)
    raw_read = 0
    for meta in walk(buf):
        if want is None or meta.name in want:
            out[meta.name] = decode_entry(
                meta, buf[meta.off : meta.off + meta.length])
            enc_read += meta.length
            raw_read += out[meta.name].nbytes
    return out, enc_read, raw_read


def loads(data: bytes, fields: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """Deserialize a block (MAGIC-dispatched TGI1/TGI2).  ``fields``
    projects the read: only the named arrays are materialized."""
    return loads_sized(data, fields)[0]


def block_info(data: bytes) -> Dict[str, Dict]:
    """Per-column metadata of a stored block (no payload decode):
    ``{name: {dtype, shape, encoding, stored_bytes, raw_bytes, crc}}``."""
    info: Dict[str, Dict] = {}
    for meta in walk(data):
        info[meta.name] = {
            "dtype": str(meta.dtype), "shape": tuple(meta.shape),
            "encoding": ENC_NAME[meta.enc], "stored_bytes": meta.length,
            "raw_bytes": math.prod(meta.shape) * meta.dtype.itemsize,
            "crc": meta.crc,
        }
    return info
