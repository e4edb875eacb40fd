"""Data integrity: CRCs, the verification header, Optimistic Error Correction
and the concatenated chunk-level code (paper §IV-C2/C3).

Layout implemented here (per 4 KiB match-mode page):

  chunk 0 (the *verification header* chunk, 64 B):
    slot 0  : CRC-64 over slots 1..7 of chunk 0        (8 B)
    slot 1  : magic number 0x5349_4D43_4849_5021        (8 B, "SIMCHIP!")
    slot 2  : write timestamp (uint64 nanoseconds)      (8 B)
    slots 3..7 : user metadata (B+Tree header etc.)

  out-of-band area (modelled separately, as on a real chip):
    64 x CRC-32 chunk parities  (the concatenated *inner* code)
    1  x page-level parity + correction budget t (the *outer* code; real
        chips use BCH/LDPC — we model a t-error-correcting code whose
        decode succeeds iff the injected bit-error count is <= t)

`page_open` transfers header+chunk0 only; the controller checks the CRC-64.
Clean -> proceed with on-chip matching (the optimistic fast path).
Dirty -> full-page fallback: outer-code decode, then bounded read-retries.
Stale timestamp -> page is queued for refresh (rewrite) even when clean.
"""
from __future__ import annotations

import dataclasses
import functools
from enum import Enum

import numpy as np

from .bits import (CHUNK_BYTES, CHUNKS_PER_PAGE, bytes_to_slot_words,
                   pair_to_u64, slot_words_to_bytes, u64_to_pair)

MAGIC = 0x53494D4348495021  # "SIMCHIP!"
HEADER_CRC_SLOT = 0
HEADER_MAGIC_SLOT = 1
HEADER_TIMESTAMP_SLOT = 2
HEADER_USER_SLOTS = slice(3, 8)

# --------------------------------------------------------------------------
# Table-driven CRC-32 (Castagnoli) and CRC-64 (ECMA-182), vectorized in numpy.
# --------------------------------------------------------------------------

_CRC32_POLY = 0x82F63B78            # Castagnoli, reflected
_CRC64_POLY = 0xC96C5795D7870F42    # ECMA-182, reflected


def _make_crc32_table(poly: int = _CRC32_POLY) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    return table


def _make_crc64_table(poly: int = _CRC64_POLY) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = np.uint64(crc)
    return table


_CRC32_TABLE = _make_crc32_table()
_CRC64_TABLE = _make_crc64_table()


def _as_u8(data: np.ndarray | bytes) -> np.ndarray:
    return np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8).ravel()


def _crc32_bytewise(data: np.ndarray | bytes) -> int:
    """Reference per-byte CRC-32; kept as the property-test oracle and the
    tail of the long-buffer fold (:func:`_crc_fold`)."""
    buf = _as_u8(data)
    crc = np.uint32(0xFFFFFFFF)
    for b in buf:
        crc = _CRC32_TABLE[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def _crc64_bytewise(data: np.ndarray | bytes) -> int:
    """Reference per-byte CRC-64 (see :func:`_crc32_bytewise`)."""
    buf = _as_u8(data)
    crc = np.uint64(0xFFFFFFFFFFFFFFFF)
    for b in buf:
        crc = _CRC64_TABLE[(crc ^ np.uint64(b)) & np.uint64(0xFF)] ^ (
            crc >> np.uint64(8))
    return int(crc ^ np.uint64(0xFFFFFFFFFFFFFFFF))


# Position tables.  A CRC is affine in its input bytes: the CRC of an n-byte
# row is c_n XOR (XOR over positions i of P[i][byte_i]), where P[i] holds a
# byte's contribution with n-1-i bytes after it (the byte table followed by
# that many zero bytes, from a zero register) and c_n is the CRC of n zero
# bytes.  A width-n row reads the last n positions of a table, so one table
# serves every width up to _TABLE_POSITIONS, crc32/crc64's short buffers
# included.  A row pass is then gathers and XORs, with no byte-by-byte chain
# through the register.

_ROW_BYTES = 64  # fold granularity of the vectorized single-buffer CRCs
_TABLE_POSITIONS = 2 * _ROW_BYTES - 1
# Row bytes up to which one gather over the whole (k, n) array beats a loop
# over the n positions (whose gathers are k long).  On an H100 machine's
# host (scripts/crc_crossover.py) the gather won both CRCs up to 1,536 rows
# of 64 B and the loop from 2,048, where the CRC-64 gather's index and value
# arrays (2 MiB) fall out of cache and it slows fivefold.
_GATHER_MAX_BYTES = 96 * 1024
_POSITION_OFFSETS = np.arange(_TABLE_POSITIONS, dtype=np.intp) * 256

# Row passes since import, by branch: "gather" (one gather and an
# XOR-reduce), "columns" (a gather a position), "loop" (rows wider than
# the tables: the register through each byte position in turn).
ROW_PASSES = {"gather": 0, "columns": 0, "loop": 0}


def _crc_rows_loop(rows: np.ndarray, table: np.ndarray) -> np.ndarray:
    """The register through a row's byte positions in turn, all rows at
    once (rows wider than the position tables)."""
    dt = table.dtype.type
    ones, low, eight = dt(~dt(0)), dt(0xFF), dt(8)
    crc = np.full(rows.shape[0], ones, dtype=table.dtype)
    for i in range(rows.shape[1]):
        crc = table[(crc ^ rows[:, i]) & low] ^ (crc >> eight)
    return crc ^ ones


def _position_table(table: np.ndarray) -> np.ndarray:
    """(_TABLE_POSITIONS, 256): entry [j, b] is byte b's contribution with
    _TABLE_POSITIONS - 1 - j zero bytes after it."""
    dt = table.dtype.type
    pos = np.empty((_TABLE_POSITIONS, 256), dtype=table.dtype)
    pos[-1] = table
    for j in range(_TABLE_POSITIONS - 2, -1, -1):
        pos[j] = table[pos[j + 1] & dt(0xFF)] ^ (pos[j + 1] >> dt(8))
    return pos


def _zero_row_crcs(table: np.ndarray) -> np.ndarray:
    """(_TABLE_POSITIONS + 1,): entry n is the CRC of n zero bytes, read off
    one register run through _TABLE_POSITIONS zeros."""
    dt = table.dtype.type
    ones = dt(~dt(0))
    out = np.zeros(_TABLE_POSITIONS + 1, dtype=table.dtype)
    reg = ones
    for n in range(1, _TABLE_POSITIONS + 1):
        reg = table[reg & dt(0xFF)] ^ (reg >> dt(8))
        out[n] = reg ^ ones
    return out


_CRC32_POSITIONS = _position_table(_CRC32_TABLE)
_CRC64_POSITIONS = _position_table(_CRC64_TABLE)
_CRC32_ZERO_ROWS = _zero_row_crcs(_CRC32_TABLE)
_CRC64_ZERO_ROWS = _zero_row_crcs(_CRC64_TABLE)


def _crc_rows(rows: np.ndarray, table: np.ndarray, positions: np.ndarray,
              zero_rows: np.ndarray) -> np.ndarray:
    """Row-wise CRC over a (k, n) uint8 array; the pass is chosen by the
    array's shape alone."""
    rows = np.asarray(rows, dtype=np.uint8)
    k, n = rows.shape
    if n > _TABLE_POSITIONS:
        ROW_PASSES["loop"] += 1
        return _crc_rows_loop(rows, table)
    first = _TABLE_POSITIONS - n
    if rows.size <= _GATHER_MAX_BYTES:
        ROW_PASSES["gather"] += 1
        parts = positions.reshape(-1)[rows + _POSITION_OFFSETS[first:]]
        acc = np.bitwise_xor.reduce(parts, axis=1)
    else:
        ROW_PASSES["columns"] += 1
        acc = np.zeros(k, dtype=table.dtype)
        for i, col in enumerate(np.ascontiguousarray(rows.T)):
            acc ^= positions[first + i].take(col)
    return acc ^ zero_rows[n]


# GF(2) length-shift operators (the zlib crc32_combine construction): the
# final CRC of A||B is  M_len(B) @ crc(A)  ^  crc(B), where M_n is the linear
# operator that advances a (reflected, pre/post-conditioned) CRC register by
# n zero bytes.  Splitting a buffer into equal rows therefore reduces a
# whole-buffer CRC to ONE vectorized row-wise table pass plus a cheap
# per-row fold with a cached matrix — no per-byte Python loop.

def _gf2_times(mat: tuple[int, ...], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(_gf2_times(mat, m) for m in mat)


@functools.lru_cache(maxsize=None)
def _shift_matrix(poly: int, width: int, len_bytes: int) -> tuple[int, ...]:
    """Operator advancing a reflected CRC register by ``len_bytes`` zeros."""
    op = (poly,) + tuple(1 << (i - 1) for i in range(1, width))  # 1-bit shift
    op = _gf2_square(_gf2_square(op))                            # 4-bit shift
    mat = tuple(1 << i for i in range(width))                    # identity
    n = len_bytes
    while n:
        op = _gf2_square(op)        # 8, 16, 32, ... bit shifts
        if n & 1:
            mat = tuple(_gf2_times(op, m) for m in mat)
        n >>= 1
    return mat


def _crc_fold(row_crcs: np.ndarray, tail: np.ndarray, poly: int, width: int,
              bytewise) -> int:
    """Fold per-row CRCs (rows of _ROW_BYTES each) + a short tail into the
    stream CRC via the cached shift operators."""
    shift_row = _shift_matrix(poly, width, _ROW_BYTES)
    crc = int(row_crcs[0])
    for r in row_crcs[1:]:
        crc = _gf2_times(shift_row, crc) ^ int(r)
    if tail.size:
        crc = _gf2_times(_shift_matrix(poly, width, int(tail.size)), crc) \
            ^ bytewise(tail)
    return crc


def crc32(data: np.ndarray | bytes) -> int:
    buf = _as_u8(data)
    if buf.size < 2 * _ROW_BYTES:
        return int(crc32_rows(buf[None, :])[0])
    full = buf.size // _ROW_BYTES
    rows = crc32_rows(buf[:full * _ROW_BYTES].reshape(full, _ROW_BYTES))
    return _crc_fold(rows, buf[full * _ROW_BYTES:], _CRC32_POLY, 32,
                     _crc32_bytewise)


def crc64(data: np.ndarray | bytes) -> int:
    buf = _as_u8(data)
    if buf.size < 2 * _ROW_BYTES:
        return int(crc64_rows(buf[None, :])[0])
    full = buf.size // _ROW_BYTES
    rows = crc64_rows(buf[:full * _ROW_BYTES].reshape(full, _ROW_BYTES))
    return _crc_fold(rows, buf[full * _ROW_BYTES:], _CRC64_POLY, 64,
                     _crc64_bytewise)


def crc32_rows(rows: np.ndarray) -> np.ndarray:
    """Row-wise CRC-32 over a (k, n) uint8 array -> (k,) uint32."""
    return _crc_rows(rows, _CRC32_TABLE, _CRC32_POSITIONS, _CRC32_ZERO_ROWS)


def crc64_rows(rows: np.ndarray) -> np.ndarray:
    """Row-wise CRC-64 over a (k, n) uint8 array -> (k,) uint64.

    One table pass verifies every page's header body in a flush's open
    burst (see :func:`parse_header_chunks`) instead of k per-byte loops.
    """
    return _crc_rows(rows, _CRC64_TABLE, _CRC64_POSITIONS, _CRC64_ZERO_ROWS)


def crc32_chunks(page_bytes: np.ndarray) -> np.ndarray:
    """CRC-32 of each 64 B chunk of a page -> (64,) uint32 (vectorized)."""
    return crc32_rows(np.asarray(page_bytes, dtype=np.uint8).reshape(
        CHUNKS_PER_PAGE, CHUNK_BYTES))


# --------------------------------------------------------------------------
# Verification header
# --------------------------------------------------------------------------

def build_header_chunk(timestamp_ns: int,
                       user_slots: np.ndarray | None = None) -> np.ndarray:
    """Return the 64 B verification-header chunk as uint8."""
    words = np.zeros((8, 2), dtype=np.uint32)
    words[HEADER_MAGIC_SLOT] = u64_to_pair(MAGIC)
    words[HEADER_TIMESTAMP_SLOT] = u64_to_pair(timestamp_ns)
    if user_slots is not None:
        u = np.asarray(user_slots, dtype=np.uint32).reshape(-1, 2)
        words[HEADER_USER_SLOTS][:u.shape[0]] = u
    body = slot_words_to_bytes(words[1:])          # slots 1..7
    crc = crc64(body)
    words[HEADER_CRC_SLOT] = u64_to_pair(crc)
    return slot_words_to_bytes(words)


@dataclasses.dataclass
class Header:
    crc: int
    magic: int
    timestamp_ns: int
    user: np.ndarray  # (5, 2) uint32
    crc_ok: bool
    magic_ok: bool


def _header_from_words(words: np.ndarray, body_crc: int) -> Header:
    crc_stored = pair_to_u64(*words[HEADER_CRC_SLOT])
    magic = pair_to_u64(*words[HEADER_MAGIC_SLOT])
    ts = pair_to_u64(*words[HEADER_TIMESTAMP_SLOT])
    return Header(
        crc=crc_stored, magic=magic, timestamp_ns=ts,
        user=np.array(words[HEADER_USER_SLOTS]),
        crc_ok=(body_crc == crc_stored), magic_ok=(magic == MAGIC))


def parse_header_chunk(chunk_bytes: np.ndarray) -> Header:
    words = bytes_to_slot_words(np.asarray(chunk_bytes, dtype=np.uint8))
    body = slot_words_to_bytes(words[1:])
    return _header_from_words(words, crc64(body))


def parse_header_chunks(chunk_bytes: np.ndarray) -> list[Header]:
    """Parse many 64 B header chunks at once -> list of :class:`Header`.

    The CRC-64 body check for every page runs as ONE :func:`crc64_rows`
    table pass, so a flush-wide open burst doesn't pay a per-page CRC loop.
    """
    chunks = np.asarray(chunk_bytes, dtype=np.uint8).reshape(-1, CHUNK_BYTES)
    body_crcs = crc64_rows(chunks[:, 8:])  # bytes of slots 1..7
    return [_header_from_words(bytes_to_slot_words(chunks[i]),
                               int(body_crcs[i]))
            for i in range(chunks.shape[0])]


# --------------------------------------------------------------------------
# Optimistic Error Correction pipeline
# --------------------------------------------------------------------------

class OpenVerdict(Enum):
    CLEAN = "clean"                  # fast path: match on-chip immediately
    CLEAN_NEEDS_REFRESH = "refresh"  # clean, but older than the safety margin
    FALLBACK_ECC = "fallback"        # CRC mismatch -> full-page outer decode
    UNCORRECTABLE = "uncorrectable"  # outer decode failed after read-retries


@dataclasses.dataclass
class EccConfig:
    t_correctable: int = 40           # outer-code budget (bits / 4 KiB page)
    max_read_retries: int = 5         # sensing-voltage retries (paper [17])
    refresh_margin_ns: int = int(30 * 24 * 3600 * 1e9)  # 30 days
    retry_fix_prob: float = 0.5       # per-retry chance a marginal page reads clean


@dataclasses.dataclass
class OpenResult:
    verdict: OpenVerdict
    header: Header | None
    retries_used: int = 0
    bits_corrected: int = 0


def optimistic_open(header_chunk: np.ndarray | None, *, now_ns: int,
                    injected_error_bits: int, cfg: EccConfig,
                    rng: np.random.Generator | None = None,
                    header: Header | None = None) -> OpenResult:
    """Model the page-open decision tree of §IV-C2.

    ``injected_error_bits`` is the simulator's ground-truth raw bit-error
    count for the page (the header chunk's own errors are already reflected
    in the bytes passed in, so the CRC check is real, not modelled).
    Callers that already parsed the header (e.g. a flush-wide open burst
    through :func:`parse_header_chunks`) pass ``header=`` and may leave
    ``header_chunk`` as None.
    """
    if header is None:
        header = parse_header_chunk(header_chunk)
    if header.crc_ok and header.magic_ok:
        if now_ns - header.timestamp_ns > cfg.refresh_margin_ns:
            return OpenResult(OpenVerdict.CLEAN_NEEDS_REFRESH, header)
        return OpenResult(OpenVerdict.CLEAN, header)

    # Fallback: full page is read out, outer code decodes.
    if injected_error_bits <= cfg.t_correctable:
        return OpenResult(OpenVerdict.FALLBACK_ECC, header,
                          bits_corrected=injected_error_bits)

    # Read-retry loop with adjusted sensing voltage; the magic number gives
    # the controller a known-plaintext anchor for calibrating the retry.
    if rng is None:
        raise ValueError(
            "optimistic_open reached the read-retry path without an RNG: "
            "pass the owning chip's seeded generator.  A shared default "
            "generator would replay the identical retry-outcome sequence "
            "for every marginal page in the fleet, making retry statistics "
            "degenerate.")
    for attempt in range(1, cfg.max_read_retries + 1):
        if rng.random() < cfg.retry_fix_prob:
            return OpenResult(OpenVerdict.FALLBACK_ECC, header,
                              retries_used=attempt,
                              bits_corrected=cfg.t_correctable)
    return OpenResult(OpenVerdict.UNCORRECTABLE, header,
                      retries_used=cfg.max_read_retries)


# --------------------------------------------------------------------------
# Concatenated chunk-level code (inner CRC-32 per chunk)
# --------------------------------------------------------------------------

def build_chunk_parities(page_bytes: np.ndarray) -> np.ndarray:
    """(64,) uint32 inner-code parities stored out-of-band with the page."""
    return crc32_chunks(page_bytes)


def verify_chunks(page_bytes: np.ndarray, parities: np.ndarray,
                  chunk_ids: np.ndarray) -> np.ndarray:
    """Check selected chunks against their stored parities -> (k,) bool."""
    fresh = crc32_chunks(page_bytes)
    chunk_ids = np.asarray(chunk_ids, dtype=np.int64)
    return fresh[chunk_ids] == np.asarray(parities, dtype=np.uint32)[chunk_ids]
