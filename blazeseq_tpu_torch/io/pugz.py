"""Parallel inflate for arbitrary single-stream gzip (driver side).

rapidgzip/pugz design over the native core (native/pinflate.cpp):
speculative deflate-block boundary discovery splits the compressed stream
into chunks that decode CONCURRENTLY with 16-bit marker outputs for
references into the unknown 32 KB pre-chunk window; a sequential chain walk
resolves markers with each predecessor's final window and yields output as
it goes. The walk only ever continues from a position the TRUE decode
reached (chunk 0 starts at the member's real deflate start, and every later
chunk starts at the previous chunk's exact end bit), so speculative results
are used only when the true chain confirms them — false boundaries are
healed by re-decoding that link ("chain repair"). The gzip trailer CRC32 is
verified per member.

Memory is bounded: at most `parallelism + 2` chunk decodes are in flight,
probes are submitted lazily just ahead of the chain, and nothing is
submitted past a decoded BFINAL — so concatenated multi-member files do not
pay O(members x file size) (reference capability parity: C4 RapidgzipReader,
readers.mojo:380-443; "up to 5x speedup", reference CHANGELOG.md:40).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from .. import native

_WSIZE = 32768
_PZ_OUTCAP = 4
_CONFIRM_SYMS = 1 << 18


class GzipIntegrityError(Exception):
    """Trailer CRC32/ISIZE mismatch or malformed stream mid-decode."""


def _gf2_times(mat, vec):
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat):
    return [_gf2_times(mat, mat[n]) for n in range(32)]


import functools


@functools.lru_cache(maxsize=1)
def _zero_byte_pows():
    """Operators for appending 2^k zero BYTES to a CRC, k = 0..63, built
    once: repeated squaring of the single-zero-bit operator (3 squarings =
    1 byte, then one per doubling)."""
    m = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    for _ in range(3):
        m = _gf2_square(m)  # 8 zero bits = 1 byte
    pows = [m]
    for _ in range(63):
        m = _gf2_square(m)
        pows.append(m)
    return pows


@functools.lru_cache(maxsize=64)
def _combine_matrix(len2: int):
    """Composed GF(2) operator taking crc(A) to crc(A + len2 zero bytes).

    Tail lengths are data-dependent (chunk symbol counts), so per-length
    memoization rarely hits; instead the power-of-two zero operators are
    built once (_zero_byte_pows) and each length composes from its set
    bits — popcount(len2) matrix products instead of ~2 squarings per bit
    on every miss."""
    pows = _zero_byte_pows()
    mat = [1 << n for n in range(32)]  # identity
    n = len2
    k = 0
    while n:
        if n & 1:
            mat = [_gf2_times(pows[k], row) for row in mat]
        n >>= 1
        k += 1
    return tuple(mat)


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's crc32_combine: CRC of A+B from crc(A), crc(B), len(B) — lets
    workers CRC their own chunks off the sequential chain. O(1) per call
    after the per-length operator matrix is cached."""
    if len2 <= 0:
        return crc1
    return (_gf2_times(_combine_matrix(len2), crc1) ^ crc2) & 0xFFFFFFFF


def _parse_gzip_header_at(buf: bytes, pos: int) -> Optional[int]:
    """Byte offset (absolute) where the member's deflate stream starts, or
    None if buf[pos:] is not a gzip member. Offset-based: no tail copies."""
    if pos + 18 > len(buf) or buf[pos] != 0x1F or buf[pos + 1] != 0x8B \
            or buf[pos + 2] != 8:
        return None
    flg = buf[pos + 3]
    p = pos + 10
    if flg & 4:  # FEXTRA
        if p + 2 > len(buf):
            return None
        xlen = struct.unpack_from("<H", buf, p)[0]
        p += 2 + xlen
    if flg & 8:  # FNAME
        end = buf.find(b"\x00", p)
        if end < 0:
            return None
        p = end + 1
    if flg & 16:  # FCOMMENT
        end = buf.find(b"\x00", p)
        if end < 0:
            return None
        p = end + 1
    if flg & 2:  # FHCRC
        p += 2
    return p if p < len(buf) else None


def parallel_inflate_stream(comp: bytes, parallelism: int,
                            chunk_bytes: int = 4 * 1024 * 1024
                            ) -> Iterator[bytes]:
    """Yield decompressed parts of a (possibly multi-member) gzip buffer.

    Raises GzipIntegrityError when the stream is malformed or a member's
    trailer CRC32/ISIZE does not match the produced output (detected at the
    member end, like any streaming gzip consumer)."""
    lib = native.pinflate_lib()
    if lib is None:
        raise GzipIntegrityError("no native pinflate library")
    if parallelism < 1:
        parallelism = 1
    comp_arr = np.frombuffer(comp, dtype=np.uint8)
    p_comp = comp_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    nbits = 8 * len(comp)

    def find(bit_off: int) -> int:
        scratch = np.empty(_CONFIRM_SYMS, dtype=np.uint16)
        return int(lib.pz_find_block(
            p_comp, nbits, bit_off, 8 * chunk_bytes, _CONFIRM_SYMS,
            scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            len(scratch)))

    def decode_range(bit_start: int, bit_limit: int):
        """Decode + post-process in the worker: only a chunk's first 32768
        outputs can hold markers, so the tail is narrowed to u8 and its
        CRC32 computed here, off the sequential chain path. Returns
        (head_syms u16, tail u8, tail_crc, end_bit, saw_final)."""
        cap = max((bit_limit - bit_start) // 8 * _PZ_OUTCAP, 1 << 16)
        for _ in range(10):  # grow on OUTCAP
            out = np.empty(int(cap), dtype=np.uint16)
            end_bit = ctypes.c_int64(0)
            saw_final = ctypes.c_int32(0)
            err = ctypes.c_int32(0)
            n = lib.pz_decode_chunk(
                p_comp, nbits, bit_start, bit_limit,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                len(out), ctypes.byref(end_bit), ctypes.byref(saw_final),
                ctypes.byref(err))
            if err.value == 4:  # OUTCAP: retry bigger
                cap *= 2
                continue
            if err.value != 0:
                return None
            # split at the LAST marker: everything after it is plain bytes
            # (markers originate in the first 32KB but propagate via copies)
            last = int(lib.pz_last_marker(
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n))
            h = last + 1
            head = out[:h].copy()
            tail = np.empty(n - h, dtype=np.uint8)
            if n > h:
                lib.pz_narrow(
                    out[h:n].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                    n - h,
                    tail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            tail_crc = zlib.crc32(tail)
            return head, tail, tail_crc, end_bit.value, bool(saw_final.value)
        return None

    pos = 0
    with ThreadPoolExecutor(max_workers=parallelism) as pool:
        while pos < len(comp):
            hdr = _parse_gzip_header_at(comp, pos)
            if hdr is None:
                raise GzipIntegrityError("bad gzip header at %d" % pos)
            for part, end_byte in _member_stream(
                    lib, comp, hdr, nbits, chunk_bytes, parallelism, pool,
                    find, decode_range):
                if part is not None:
                    yield part
            pos = end_byte + 8


def _member_stream(lib, comp, deflate_start, nbits, chunk_bytes, parallelism,
                   pool, find, decode_range):
    """Yield (resolved_part_bytes, None) for one member, then (None,
    end_byte). Bounded lookahead: probes and decodes stay <= W links ahead
    of the sequential chain walk."""
    W = parallelism + 2
    start_bit = 8 * deflate_start

    probe_futs = {}    # target_bit -> future(found_bit or -1)
    decode_futs = {}   # bit_start -> future(decode result)
    next_probe = deflate_start + chunk_bytes  # byte offset of next probe

    bounds = []        # found boundaries (sorted, ahead of the chain)

    def top_up(cur_bit):
        nonlocal next_probe
        # keep ~W probes ahead of the chain position
        while (len(probe_futs) + len(bounds) < W
               and 8 * next_probe < nbits):
            t = 8 * next_probe
            probe_futs[t] = pool.submit(find, t)
            next_probe += chunk_bytes
        # harvest completed probes in order
        for t in sorted(probe_futs):
            f = probe_futs[t]
            if f.done():
                b = f.result()
                del probe_futs[t]
                if b > cur_bit and (not bounds or b > bounds[-1]):
                    bounds.append(b)
            else:
                break
        # speculative decodes for consecutive bound pairs (the last known
        # bound decodes at most ~2 chunks ahead, not to EOF — the chain adds
        # further links as more probes land)
        starts = [b for b in bounds if b > cur_bit]
        for i, s in enumerate(starts[:W]):
            if s not in decode_futs:
                limit = (starts[i + 1] if i + 1 < len(starts)
                         else min(nbits, s + 2 * 8 * chunk_bytes))
                decode_futs[s] = pool.submit(decode_range, s, limit)

    crc = 0
    isize = 0
    prev_win = np.zeros(_WSIZE, dtype=np.uint8)
    cur = start_bit
    guard = 0
    while True:
        guard += 1
        if guard > (nbits // max(8 * chunk_bytes, 1) + 8) * 4:
            raise GzipIntegrityError("chain did not terminate")
        top_up(cur)
        fut = decode_futs.pop(cur, None)
        if fut is not None:
            res = fut.result()
        else:
            # sequential link (start of member, or repair after a false
            # boundary): decode to the next known-or-guessed limit
            nxt = next((b for b in bounds if b > cur),
                       min(cur + 8 * chunk_bytes, nbits))
            res = decode_range(cur, nxt)
        if res is None:
            raise GzipIntegrityError("deflate decode error at bit %d" % cur)
        head_syms, tail, tail_crc, end_bit, saw_final = res
        # drop stale speculative state behind the chain
        for s in [s for s in decode_futs if s < end_bit]:
            decode_futs.pop(s).cancel()
        while bounds and bounds[0] <= end_bit:
            bounds.pop(0)

        # sequential work per chunk is only the <=32KB head patch + CRC
        # combine; the tail was narrowed and CRC'd in the worker
        head = np.empty(len(head_syms), dtype=np.uint8)
        rc = lib.pz_resolve(
            head_syms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            len(head_syms),
            prev_win.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            head.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise GzipIntegrityError("marker outside window at bit %d" % cur)
        n_out = len(head) + len(tail)
        if len(tail) >= _WSIZE:
            prev_win = tail[-_WSIZE:].copy()
        else:
            joined = np.concatenate([prev_win, head, tail])
            prev_win = joined[-_WSIZE:].copy()
        crc = zlib.crc32(head, crc)
        crc = _crc32_combine(crc, tail_crc, len(tail))
        isize = (isize + n_out) & 0xFFFFFFFF
        yield head.tobytes(), None
        if len(tail):
            yield tail.tobytes(), None

        if saw_final:
            # stop speculative work before the next member re-probes
            for f in probe_futs.values():
                f.cancel()
            for f in decode_futs.values():
                f.cancel()
            end_byte = (end_bit + 7) // 8
            if end_byte + 8 > len(comp):
                raise GzipIntegrityError("truncated gzip trailer")
            want_crc, want_isize = struct.unpack_from("<II", comp, end_byte)
            if (crc & 0xFFFFFFFF) != want_crc or isize != want_isize:
                raise GzipIntegrityError("gzip CRC32/ISIZE mismatch")
            yield None, end_byte
            return
        if end_bit <= cur or end_bit >= nbits:
            raise GzipIntegrityError("no progress at bit %d" % cur)
        cur = end_bit


def parallel_inflate(comp: bytes, parallelism: int,
                     chunk_bytes: int = 4 * 1024 * 1024) -> Optional[bytes]:
    """Materializing wrapper: full decompressed bytes, or None when the
    parallel path cannot be used / the stream is bad (caller falls back to
    sequential zlib, which reproduces the proper error for corrupt input)."""
    if native.pinflate_lib() is None or parallelism < 2 or not comp:
        return None
    try:
        return b"".join(parallel_inflate_stream(comp, parallelism,
                                                chunk_bytes))
    except Exception:
        return None
