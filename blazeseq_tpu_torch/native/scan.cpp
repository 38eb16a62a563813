// blazeseq_tpu native host kernels: bulk FASTQ record scanning + fused
// validation, newline discovery, and SoA gather.
//
// TPU-native role: the TPU does the heavy per-byte compute (validation,
// decoding, stats, alignment) on SoA batches; this library is the host-side
// feed path that turns a raw byte window into record offset tables at memory
// bandwidth, so the host never becomes the bottleneck of the HBM ingest
// pipeline. It replaces the reference's in-parser SIMD scan state machine
// (reference behavior spec: blazeseq/utils.mojo:472-551 _scan_record,
// blazeseq/fastq/record.mojo:77-148 Validator, blazeseq/fastq/parser.mojo:311-379).
//
// Two implementations per hot kernel:
//   * AVX-512BW fast path: one pass over the window in 64-byte blocks; a
//     single cmpeq produces the newline bitmask (the reference's
//     pack_bits(v.eq('\n')) idea, utils.mojo:524-531), a tzcnt bit-loop
//     drives the 4-phase record state machine, ASCII validation is a fused
//     whole-window OR-reduce pre-filter, and the quality-range check is
//     fused into the same vector loads as the padded-row gather.
//   * scalar memchr path: exact per-record semantics; used on non-AVX512
//     builds and as the precision fallback when the ASCII pre-filter trips
//     (the pre-filter conservatively covers separator-line bytes, which the
//     reference never ASCII-checks — record.mojo:107-116).
//
// Build: g++ -O3 -march=native -shared -fPIC scan.cpp -o libblazeseq_scan.so
// No external dependencies.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <type_traits>

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

// FastxErrorCode values (mirrors blazeseq_tpu/errors.py)
enum : int32_t {
  BS_OK = 0,
  BS_ID_NO_AT = 1,
  BS_SEP_NO_PLUS = 2,
  BS_SEQ_QUAL_LEN_MISMATCH = 3,
  BS_ASCII_INVALID = 4,
  BS_QUALITY_OUT_OF_RANGE = 5,
};

// High-bit test over [p, p+n). Returns true if all bytes are 7-bit ASCII.
inline bool all_ascii(const uint8_t* p, int64_t n) {
  int64_t i = 0;
  uint64_t acc = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    acc |= w;
  }
  if (acc & 0x8080808080808080ULL) return false;
  for (; i < n; ++i)
    if (p[i] & 0x80) return false;
  return true;
}

inline bool is_posix_space(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r' || c == 0x1c || c == 0x1d || c == 0x1e;
}

// Inclusive-range check: every byte b in [p, p+n) satisfies lower <= b <= upper,
// via the unsigned-wraparound trick (b - lower) <= span.
inline bool all_in_range(const uint8_t* p, int64_t n, uint8_t lower,
                         uint8_t span) {
  int64_t i = 0;
  // Vectorizable loop: accumulate the max of (b - lower) and compare once.
  uint8_t bad = 0;
  for (; i < n; ++i) {
    uint8_t d = (uint8_t)(p[i] - lower);
    bad |= (uint8_t)(d > span);
  }
  return !bad;
}

// ---------------------------------------------------------------------------
// Scalar reference implementations (exact per-record semantics; also the
// dispatch target on non-AVX512 builds and the ASCII-pre-filter fallback).
// ---------------------------------------------------------------------------

int64_t scan_fastq_scalar(const uint8_t* buf, int64_t n, int64_t start,
                          int64_t max_records, int32_t check_ascii,
                          int32_t check_quality, uint8_t q_lower,
                          uint8_t q_span, int64_t* out, int64_t* consumed,
                          int32_t* err_code, int32_t* err_phase) {
  int64_t pos = start;
  int64_t count = 0;
  *err_code = BS_OK;
  *err_phase = 0;
  *consumed = start;

  while (count < max_records && pos < n) {
    const int64_t h = pos;
    int64_t* rec = out + count * 5;
    rec[0] = h;
    rec[1] = rec[2] = rec[3] = rec[4] = -1;

    const void* m1 = std::memchr(buf + pos, '\n', (size_t)(n - pos));
    if (!m1) { *err_phase = 0; return count; }
    const int64_t s = (const uint8_t*)m1 - buf + 1;
    rec[1] = s;
    if (s >= n) { *err_phase = 1; return count; }

    const void* m2 = std::memchr(buf + s, '\n', (size_t)(n - s));
    if (!m2) { *err_phase = 1; return count; }
    const int64_t p = (const uint8_t*)m2 - buf + 1;
    rec[2] = p;
    if (p >= n) { *err_phase = 2; return count; }

    const void* m3 = std::memchr(buf + p, '\n', (size_t)(n - p));
    if (!m3) { *err_phase = 2; return count; }
    const int64_t q = (const uint8_t*)m3 - buf + 1;
    rec[3] = q;
    if (q >= n) { *err_phase = 3; return count; }

    const void* m4 = std::memchr(buf + q, '\n', (size_t)(n - q));
    if (!m4) { *err_phase = 3; return count; }
    const int64_t e = (const uint8_t*)m4 - buf;  // record_end
    rec[4] = e;

    // Structure validation (reference: utils.mojo:449-462).
    if (buf[h] != '@') { *err_code = BS_ID_NO_AT; return count; }
    if (buf[p] != '+') { *err_code = BS_SEP_NO_PLUS; return count; }
    const int64_t seq_len = p - s - 1;
    const int64_t qual_len = e - q;
    if (seq_len != qual_len) {
      *err_code = BS_SEQ_QUAL_LEN_MISMATCH;
      return count;
    }

    // Record is structurally complete: consume it (validation failures below
    // still consume, matching the reference's consume-then-validate order).
    ++count;
    pos = e + 1;
    *consumed = pos;

    if (check_ascii) {
      // id + seq lines: [h+1, p-1) includes the seq-end '\n' (ASCII, harmless)
      // and excludes the separator-line content, which the reference never
      // ASCII-checks (record.mojo:107-116 checks id/seq/qual spans only).
      if (!all_ascii(buf + h + 1, (p - 1) - (h + 1)) ||
          !all_ascii(buf + q, qual_len)) {
        *err_code = BS_ASCII_INVALID;
        return count;
      }
    }
    if (check_quality) {
      if (!all_in_range(buf + q, qual_len, q_lower, q_span)) {
        *err_code = BS_QUALITY_OUT_OF_RANGE;
        return count;
      }
    }
  }
  return count;
}

int64_t scan_gather_padded_scalar(
    const uint8_t* buf, int64_t n, int64_t start, int64_t max_records,
    int64_t width, int32_t check_ascii, int32_t check_quality, uint8_t q_lower,
    uint8_t q_span, int64_t max_rec_size, uint8_t* seq_out, uint8_t* qual_out,
    int32_t* len_out, int64_t* consumed, int32_t* err_code,
    int32_t* err_phase) {
  int64_t pos = start;
  int64_t count = 0;
  *err_code = BS_OK;
  *err_phase = 0;
  *consumed = start;
  while (count < max_records && pos < n) {
    const int64_t h = pos;
    const void* m1 = std::memchr(buf + pos, '\n', (size_t)(n - pos));
    if (!m1) { *err_phase = 0; return count; }
    const int64_t s = (const uint8_t*)m1 - buf + 1;
    if (s >= n) { *err_phase = 1; return count; }
    const void* m2 = std::memchr(buf + s, '\n', (size_t)(n - s));
    if (!m2) { *err_phase = 1; return count; }
    const int64_t p = (const uint8_t*)m2 - buf + 1;
    if (p >= n) { *err_phase = 2; return count; }
    const void* m3 = std::memchr(buf + p, '\n', (size_t)(n - p));
    if (!m3) { *err_phase = 2; return count; }
    const int64_t q = (const uint8_t*)m3 - buf + 1;
    if (q >= n) { *err_phase = 3; return count; }
    const void* m4 = std::memchr(buf + q, '\n', (size_t)(n - q));
    if (!m4) { *err_phase = 3; return count; }
    const int64_t e = (const uint8_t*)m4 - buf;

    if (buf[h] != '@') { *err_code = BS_ID_NO_AT; return count; }
    if (buf[p] != '+') { *err_code = BS_SEP_NO_PLUS; return count; }
    const int64_t seq_len = p - s - 1;
    if (seq_len != e - q) { *err_code = BS_SEQ_QUAL_LEN_MISMATCH; return count; }
    if (e + 1 - h > max_rec_size) { *err_code = -9; return count; }
    if (check_ascii &&
        (!all_ascii(buf + h + 1, (p - 1) - (h + 1)) ||
         !all_ascii(buf + q, seq_len))) {
      *err_code = BS_ASCII_INVALID;
      return count;
    }
    if (check_quality && !all_in_range(buf + q, seq_len, q_lower, q_span)) {
      *err_code = BS_QUALITY_OUT_OF_RANGE;
      return count;
    }

    // copy is clamped to the row width, but len_out records the TRUE read
    // length so downstream counters (bases, read-length stats) stay exact;
    // per-position kernels mask with min(len, width) implicitly
    const int64_t len = seq_len > width ? width : seq_len;
    uint8_t* srow = seq_out + count * width;
    uint8_t* qrow = qual_out + count * width;
    std::memcpy(srow, buf + s, (size_t)len);
    std::memcpy(qrow, buf + q, (size_t)len);
    std::memset(srow + len, 0, (size_t)(width - len));
    std::memset(qrow + len, 0, (size_t)(width - len));
    len_out[count] = (int32_t)seq_len;
    ++count;
    pos = e + 1;
    *consumed = pos;
  }
  return count;
}

int64_t count_fastq_scalar(const uint8_t* buf, int64_t n, int64_t start,
                           int32_t check_ascii, int32_t check_quality,
                           uint8_t q_lower, uint8_t q_span, int64_t* bases_out,
                           int64_t* consumed, int32_t* err_code,
                           int32_t* err_phase) {
  int64_t pos = start;
  int64_t records = 0;
  int64_t bases = 0;
  *err_code = BS_OK;
  *err_phase = 0;
  *consumed = start;
  while (pos < n) {
    const int64_t h = pos;
    const void* m1 = std::memchr(buf + pos, '\n', (size_t)(n - pos));
    if (!m1) { *err_phase = 0; break; }
    const int64_t s = (const uint8_t*)m1 - buf + 1;
    if (s >= n) { *err_phase = 1; break; }
    const void* m2 = std::memchr(buf + s, '\n', (size_t)(n - s));
    if (!m2) { *err_phase = 1; break; }
    const int64_t p = (const uint8_t*)m2 - buf + 1;
    if (p >= n) { *err_phase = 2; break; }
    const void* m3 = std::memchr(buf + p, '\n', (size_t)(n - p));
    if (!m3) { *err_phase = 2; break; }
    const int64_t q = (const uint8_t*)m3 - buf + 1;
    if (q >= n) { *err_phase = 3; break; }
    const void* m4 = std::memchr(buf + q, '\n', (size_t)(n - q));
    if (!m4) { *err_phase = 3; break; }
    const int64_t e = (const uint8_t*)m4 - buf;
    if (buf[h] != '@') { *err_code = BS_ID_NO_AT; break; }
    if (buf[p] != '+') { *err_code = BS_SEP_NO_PLUS; break; }
    const int64_t seq_len = p - s - 1;
    if (seq_len != e - q) { *err_code = BS_SEQ_QUAL_LEN_MISMATCH; break; }
    if (check_ascii &&
        (!all_ascii(buf + h + 1, (p - 1) - (h + 1)) ||
         !all_ascii(buf + q, seq_len))) {
      *err_code = BS_ASCII_INVALID;  // record left unconsumed for rescan
      break;
    }
    if (check_quality && !all_in_range(buf + q, seq_len, q_lower, q_span)) {
      *err_code = BS_QUALITY_OUT_OF_RANGE;
      break;
    }
    ++records;
    bases += seq_len;
    pos = e + 1;
    *consumed = pos;
  }
  *bases_out = bases;
  return records;
}

// ---------------------------------------------------------------------------
// AVX-512BW fast path
// ---------------------------------------------------------------------------
#if defined(__AVX512BW__)

inline bool acc_nonascii(__m512i acc) {
  return _mm512_test_epi8_mask(acc, _mm512_set1_epi8((char)0x80)) != 0;
}

// Quality-range check over [p, p+n): true when every byte is in
// [lower, lower+span] (unsigned-wraparound trick, vectorized).
inline bool range_ok_512(const uint8_t* p, int64_t n, uint8_t lower,
                         uint8_t span) {
  const __m512i vl = _mm512_set1_epi8((char)lower);
  const __m512i vs = _mm512_set1_epi8((char)span);
  int64_t i = 0;
  __mmask64 bad = 0;
  for (; i + 64 <= n; i += 64) {
    __m512i v = _mm512_loadu_si512((const void*)(p + i));
    bad |= _mm512_cmp_epu8_mask(_mm512_sub_epi8(v, vl), vs, _MM_CMPINT_NLE);
  }
  if (i < n) {
    __mmask64 lm = ((uint64_t)1 << (n - i)) - 1;
    __m512i v = _mm512_maskz_loadu_epi8(lm, p + i);
    bad |= _mm512_mask_cmp_epu8_mask(lm, _mm512_sub_epi8(v, vl), vs,
                                     _MM_CMPINT_NLE);
  }
  return bad == 0;
}

// Copy min(len, width) bytes src->dst, zero-pad dst to width, and (when
// check) accumulate quality-range violations over the copied lanes using the
// same vector loads. Returns the violation mask OR (0 = in range).
//
// STREAM selects non-temporal full-width stores: padded rows are written once
// and consumed by the device transfer, never re-read by the host, so
// bypassing the cache avoids the read-for-ownership traffic that would
// otherwise add a full extra read of the output size to the memory bus.
// STREAM requires dst 64-byte aligned and width % 64 == 0 (callers check the
// batch base pointer once; rows then stay aligned).
template <bool STREAM>
inline __mmask64 copy_pad_check(uint8_t* dst, const uint8_t* src, int64_t len,
                                int64_t width, bool check, __m512i vl,
                                __m512i vs) {
  __mmask64 bad = 0;
  const int64_t copy = len < width ? len : width;
  int64_t j = 0;
  for (; j + 64 <= copy; j += 64) {
    __m512i v = _mm512_loadu_si512((const void*)(src + j));
    if (STREAM)
      _mm512_stream_si512((__m512i*)(dst + j), v);
    else
      _mm512_storeu_si512((void*)(dst + j), v);
    if (check)
      bad |= _mm512_cmp_epu8_mask(_mm512_sub_epi8(v, vl), vs, _MM_CMPINT_NLE);
  }
  if (j < width) {
    // boundary chunk: tail of the copy + start of the zero padding
    __mmask64 lm = (copy > j) ? (((uint64_t)1 << (copy - j)) - 1) : 0;
    __m512i v = _mm512_maskz_loadu_epi8(lm, src + j);
    if (check && lm)
      bad |= _mm512_mask_cmp_epu8_mask(lm, _mm512_sub_epi8(v, vl), vs,
                                       _MM_CMPINT_NLE);
    const int64_t chunk = width - j;
    if (chunk >= 64) {
      if (STREAM)
        _mm512_stream_si512((__m512i*)(dst + j), v);
      else
        _mm512_storeu_si512((void*)(dst + j), v);
      j += 64;
    } else {
      _mm512_mask_storeu_epi8(dst + j, (((uint64_t)1 << chunk) - 1), v);
      j = width;
    }
    const __m512i z = _mm512_setzero_si512();
    for (; j + 64 <= width; j += 64) {
      if (STREAM)
        _mm512_stream_si512((__m512i*)(dst + j), z);
      else
        _mm512_storeu_si512((void*)(dst + j), z);
    }
    if (j < width)
      _mm512_mask_storeu_epi8(dst + j, (((uint64_t)1 << (width - j)) - 1), z);
  }
  return bad;
}

// Unpadded inline copy (unaligned 64B chunks + masked tail) with optional
// fused quality-range check over the copied lanes; avoids per-line memcpy
// call overhead on ~100-byte segments. Returns the violation mask OR.
inline __mmask64 copy_check(uint8_t* dst, const uint8_t* src, int64_t len,
                            bool check, __m512i vl, __m512i vs) {
  __mmask64 bad = 0;
  int64_t j = 0;
  for (; j + 64 <= len; j += 64) {
    __m512i v = _mm512_loadu_si512((const void*)(src + j));
    _mm512_storeu_si512((void*)(dst + j), v);
    if (check)
      bad |= _mm512_cmp_epu8_mask(_mm512_sub_epi8(v, vl), vs, _MM_CMPINT_NLE);
  }
  if (j < len) {
    const __mmask64 lm = (((uint64_t)1 << (len - j)) - 1);
    __m512i v = _mm512_maskz_loadu_epi8(lm, src + j);
    _mm512_mask_storeu_epi8(dst + j, lm, v);
    if (check)
      bad |= _mm512_mask_cmp_epu8_mask(lm, _mm512_sub_epi8(v, vl), vs,
                                       _MM_CMPINT_NLE);
  }
  return bad;
}

// Record-handler action codes for the shared scan loop.
enum : int {
  REC_GO = 0,        // record accepted; consume and continue
  REC_STOP_TAKEN = 1,  // record accepted + consumed, then stop (e.g. quality
                       // error in consume-then-validate mode)
  REC_STOP_DROP = 2,   // record rejected: nothing of it consumed; stop
};

// Group size for the tier-1 locked-layout loop below.
constexpr int SPEC_GROUP = 4;

// Tier-1 group step for a fixed kblock count K (free function: a templated
// lambda ICEs gcc here): verifies SPEC_GROUP records (newline layout +
// fused quality range + '@'/'+') and emits each through the handler's
// no-validation fast path. Returns true when the whole group was accepted
// (count/pos/consumed advanced); false = handler state rolled back, caller
// takes the per-record path.
template <int K, class Handler>
inline bool group_step_impl(const uint8_t* buf, Handler& hd, bool want_q,
                            const uint64_t* exp, const uint64_t* vmask,
                            const uint64_t* qlm, int64_t o2, int64_t o4,
                            __m512i& acc, int64_t& pos, int64_t& count,
                            int64_t* consumed) {
  constexpr int SPEC_BLOCKS_ = 8;
  const __m512i nlv = _mm512_set1_epi8('\n');
  const int64_t rs = o4 + 1;
  const __m512i vl = _mm512_set1_epi8((char)hd.q_lower);
  const __m512i vs = _mm512_set1_epi8((char)hd.q_span);
  hd.spec_save();
  const __m512i accs = acc;
  uint64_t ok = 1;
  unsigned st = 1;
  bool emitted_ok = true;
#pragma GCC unroll 4
  for (int g = 0; g < SPEC_GROUP; ++g) {
    const int64_t base = pos + (int64_t)g * rs;
    __m512i v[SPEC_BLOCKS_ + 2];
#pragma GCC unroll 8
    for (int j = 0; j < K; ++j) {
      v[j] = _mm512_loadu_si512((const void*)(buf + base + (int64_t)j * 64));
      acc = _mm512_or_si512(acc, v[j]);
      const uint64_t m = (uint64_t)_mm512_cmpeq_epi8_mask(v[j], nlv);
      ok &= ((m & vmask[j]) == exp[j]) ? 1u : 0u;
      if (want_q) {
        const uint64_t bad = _mm512_cmp_epu8_mask(_mm512_sub_epi8(v[j], vl),
                                                  vs, _MM_CMPINT_NLE);
        ok &= ((bad & qlm[j]) == 0) ? 1u : 0u;
      }
    }
    v[K] = _mm512_setzero_si512();
    v[K + 1] = _mm512_setzero_si512();
    st &= (unsigned)((buf[base] == '@') & (buf[base + o2 + 1] == '+'));
    // Eager emit: rows/offsets written even if a later record in the group
    // fails — the rollback + per-record rerun rewrites them identically up
    // to the failing record, so results stay exact.
    if (!hd.on_spec(count + g, base, v, K)) {
      emitted_ok = false;
      break;
    }
  }
  if (ok && st && emitted_ok) {
    count += SPEC_GROUP;
    pos += (int64_t)SPEC_GROUP * rs;
    *consumed = pos;
    return true;
  }
  hd.spec_restore();
  acc = accs;
  return false;
}

// Record-centric scan driver with speculative structural parsing.
//
// Records in real FASTQ are locally uniform (fixed read length, fixed header
// width), so the newline layout of record k is an excellent predictor for
// record k+1. The driver caches the last record's relative newline offsets;
// for each new record it loads the predicted span (<= SPEC_BLOCKS 64-byte
// vectors), cmpeq's against '\n', and accepts the record if the resulting
// bitmasks EXACTLY equal the expected pattern (which simultaneously proves
// the 4 newlines are where predicted AND that no other newline exists in the
// record, so the parse is exact, not a guess). On mismatch it falls back to
// a tzcnt bit-loop scan for that one record and re-learns the layout
// (the reference's SearchPhase machine, utils.mojo:97-128, is the fallback).
//
// Tier-1 group path: once the layout is locked, records are verified in
// groups of SPEC_GROUP with the quality-range check FUSED into the same
// vector loads (a mask of quality-line byte positions selects which lanes'
// range violations matter), '@'/'+' checked as scalar byte loads, and the
// handler's emit step (offsets/copy/count) running on pre-verified records
// with no per-record branching. Any group mismatch rolls the handler back
// and re-runs the per-record path from the group start, so error semantics
// (stop-before / consume-then-validate) are identical to the slow path.
//
// A whole-window byte OR-reduce (ASCII pre-filter) is fused into the same
// loads. Handler sees every structurally-delimited record.
template <class Handler>
int64_t scan_loop_512(const uint8_t* buf, int64_t n, int64_t start,
                      int64_t max_records, Handler& hd, int64_t* consumed,
                      int32_t* err_code, int32_t* err_phase, bool* acc_bad) {
  constexpr int SPEC_BLOCKS = 8;  // speculate on records up to 512 bytes
  const __m512i nlv = _mm512_set1_epi8('\n');
  __m512i acc = _mm512_setzero_si512();
  int64_t pos = start;
  int64_t count = 0;
  int tail_phase = 0;  // newlines found in a trailing partial record
  *consumed = start;
  *err_code = BS_OK;

  bool lay_valid = false;
  int64_t o1 = 0, o2 = 0, o3 = 0, o4 = 0;  // newline offsets rel record start
  int kblocks = 0;
  uint64_t exp[SPEC_BLOCKS], vmask[SPEC_BLOCKS], qlm[SPEC_BLOCKS];

  // Fixed-trip speculation verifier: K known at compile time lets the
  // compiler software-pipeline the K loads/compares instead of a serial
  // runtime-count loop.
  auto verify = [&](auto kc, int64_t at, __m512i* accl_out) -> bool {
    constexpr int K = decltype(kc)::value;
    __m512i accl = acc;
    uint64_t ok = 1;
#pragma GCC unroll 8
    for (int j = 0; j < K; ++j) {
      const __m512i v =
          _mm512_loadu_si512((const void*)(buf + at + (int64_t)j * 64));
      accl = _mm512_or_si512(accl, v);
      const uint64_t m = (uint64_t)_mm512_cmpeq_epi8_mask(v, nlv);
      ok &= ((m & vmask[j]) == exp[j]) ? 1u : 0u;
    }
    *accl_out = accl;
    return ok != 0;
  };

  const bool want_q = hd.check_quality;
  auto group_step = [&](auto kc) -> bool {
    constexpr int K = decltype(kc)::value;
    return group_step_impl<K>(buf, hd, want_q, exp, vmask, qlm, o2, o4, acc,
                              pos, count, consumed);
  };

  // After a failed group attempt, hold off re-trying tier-1 for a few
  // records: on data whose layout shifts often (e.g. header widths that
  // change every read) the group path would otherwise re-verify and fail
  // every SPEC_GROUP records, paying ~2x. Correctness is unaffected — the
  // per-record path handles everything.
  int group_cooldown = 0;

  while (pos < n && count < max_records) {
    // ---- tier-1: locked-layout group verify + bulk emit ----
    if (lay_valid && group_cooldown == 0 &&
        count + SPEC_GROUP <= max_records &&
        pos + (int64_t)(SPEC_GROUP - 1) * (o4 + 1) + kblocks * 64 <= n &&
        hd.spec_allowed(o4 + 1)) {
      bool took;
      switch (kblocks) {
        case 1: took = group_step(std::integral_constant<int, 1>{}); break;
        case 2: took = group_step(std::integral_constant<int, 2>{}); break;
        case 3: took = group_step(std::integral_constant<int, 3>{}); break;
        case 4: took = group_step(std::integral_constant<int, 4>{}); break;
        case 5: took = group_step(std::integral_constant<int, 5>{}); break;
        case 6: took = group_step(std::integral_constant<int, 6>{}); break;
        case 7: took = group_step(std::integral_constant<int, 7>{}); break;
        default: took = group_step(std::integral_constant<int, 8>{}); break;
      }
      if (took) continue;
      group_cooldown = 4 * SPEC_GROUP;
    }
    if (group_cooldown > 0) --group_cooldown;
    // ---- fast path: verify the predicted layout ----
    if (lay_valid && pos + kblocks * 64 <= n) {
      __m512i accl;
      bool ok;
      switch (kblocks) {
        case 1: ok = verify(std::integral_constant<int, 1>{}, pos, &accl); break;
        case 2: ok = verify(std::integral_constant<int, 2>{}, pos, &accl); break;
        case 3: ok = verify(std::integral_constant<int, 3>{}, pos, &accl); break;
        case 4: ok = verify(std::integral_constant<int, 4>{}, pos, &accl); break;
        case 5: ok = verify(std::integral_constant<int, 5>{}, pos, &accl); break;
        case 6: ok = verify(std::integral_constant<int, 6>{}, pos, &accl); break;
        case 7: ok = verify(std::integral_constant<int, 7>{}, pos, &accl); break;
        default: ok = verify(std::integral_constant<int, 8>{}, pos, &accl); break;
      }
      if (ok) {
        acc = accl;
        const int64_t h = pos, e = pos + o4;
        const int action = hd.on_record(count, h, pos + o1 + 1, pos + o2 + 1,
                                        pos + o3 + 1, e, err_code);
        if (action == REC_GO) {
          ++count;
          pos = e + 1;
          *consumed = pos;
          continue;
        }
        if (action == REC_STOP_TAKEN) {
          ++count;
          *consumed = e + 1;
        }
        *err_phase = 0;
        *acc_bad = acc_nonascii(acc);
        return count;
      }
      // speculation miss: re-learn via the scan path below
    }

    // ---- slow path: scan one record's 4 newlines with the bit loop ----
    int64_t nl[4];
    int got = 0;
    for (int64_t base = pos; base < n && got < 4; base += 64) {
      const int64_t rem = n - base;
      __m512i v;
      uint64_t m;
      if (rem >= 64) {
        v = _mm512_loadu_si512((const void*)(buf + base));
        m = (uint64_t)_mm512_cmpeq_epi8_mask(v, nlv);
      } else {
        const __mmask64 lm = (((uint64_t)1 << rem) - 1);
        v = _mm512_maskz_loadu_epi8(lm, buf + base);
        m = (uint64_t)_mm512_cmpeq_epi8_mask(v, nlv) & lm;
      }
      acc = _mm512_or_si512(acc, v);
      while (m && got < 4) {
        nl[got++] = base + (int64_t)_tzcnt_u64(m);
        m &= m - 1;
      }
    }
    if (got < 4) {  // window ends mid-record
      tail_phase = got;
      break;
    }
    const int64_t h = pos, e = nl[3];
    const int action =
        hd.on_record(count, h, nl[0] + 1, nl[1] + 1, nl[2] + 1, e, err_code);
    if (action == REC_GO) {
      ++count;
      pos = e + 1;
      *consumed = pos;
      // learn the layout for speculation
      o1 = nl[0] - h;
      o2 = nl[1] - h;
      o3 = nl[2] - h;
      o4 = nl[3] - h;
      if (o4 < SPEC_BLOCKS * 64) {
        kblocks = (int)(o4 / 64) + 1;
        for (int j = 0; j < kblocks; ++j) {
          uint64_t ex = 0;
          const int64_t lo = (int64_t)j * 64;
          if (o1 >= lo && o1 < lo + 64) ex |= (uint64_t)1 << (o1 - lo);
          if (o2 >= lo && o2 < lo + 64) ex |= (uint64_t)1 << (o2 - lo);
          if (o3 >= lo && o3 < lo + 64) ex |= (uint64_t)1 << (o3 - lo);
          if (o4 >= lo && o4 < lo + 64) ex |= (uint64_t)1 << (o4 - lo);
          exp[j] = ex;
          // compare only bytes belonging to this record (bits <= o4 - lo)
          const int64_t valid = o4 - lo + 1;
          vmask[j] = valid >= 64 ? ~(uint64_t)0 : (((uint64_t)1 << valid) - 1);
          // quality-line byte positions [o3+1, o4) within this block: lanes
          // whose range violations fail validation in the tier-1 group path
          const int64_t qa = (o3 + 1) > lo ? (o3 + 1) : lo;
          const int64_t qb = o4 < (lo + 64) ? o4 : (lo + 64);
          uint64_t ql = 0;
          if (qb > qa) {
            const int64_t w = qb - qa;
            ql = (w >= 64 ? ~(uint64_t)0 : (((uint64_t)1 << w) - 1))
                 << (qa - lo);
          }
          qlm[j] = ql;
        }
        lay_valid = true;
        hd.spec_layout(o1, o2, o3, o4);
      } else {
        lay_valid = false;
      }
      continue;
    }
    if (action == REC_STOP_TAKEN) {
      ++count;
      *consumed = e + 1;
    }
    *err_phase = 0;
    *acc_bad = acc_nonascii(acc);
    return count;
  }
  *err_phase = (pos < n && count < max_records) ? tail_phase : 0;
  *acc_bad = acc_nonascii(acc);
  return count;
}

struct OffsetsHandler {
  const uint8_t* buf;
  int64_t* out;
  bool check_quality;
  uint8_t q_lower, q_span;
  int64_t so1 = 0, so2 = 0, so3 = 0, so4 = 0;

  inline void spec_layout(int64_t a, int64_t b, int64_t c, int64_t d) {
    so1 = a; so2 = b; so3 = c; so4 = d;
  }
  inline bool spec_allowed(int64_t) const { return true; }
  inline void spec_save() {}
  inline void spec_restore() {}
  inline bool on_spec(int64_t idx, int64_t base, const __m512i*, int) {
    int64_t* rec = out + idx * 5;
    rec[0] = base;
    rec[1] = base + so1 + 1;
    rec[2] = base + so2 + 1;
    rec[3] = base + so3 + 1;
    rec[4] = base + so4;
    return true;
  }

  inline int on_record(int64_t count, int64_t h, int64_t s, int64_t p,
                       int64_t q, int64_t e, int32_t* err_code) {
    int64_t* rec = out + count * 5;
    rec[0] = h;
    rec[1] = s;
    rec[2] = p;
    rec[3] = q;
    rec[4] = e;
    if (buf[h] != '@') { *err_code = BS_ID_NO_AT; return REC_STOP_DROP; }
    if (buf[p] != '+') { *err_code = BS_SEP_NO_PLUS; return REC_STOP_DROP; }
    const int64_t seq_len = p - s - 1;
    if (seq_len != e - q) {
      *err_code = BS_SEQ_QUAL_LEN_MISMATCH;
      return REC_STOP_DROP;
    }
    if (check_quality && !range_ok_512(buf + q, e - q, q_lower, q_span)) {
      // consume-then-validate order (reference fastq/parser.mojo:160-170)
      *err_code = BS_QUALITY_OUT_OF_RANGE;
      return REC_STOP_TAKEN;
    }
    return REC_GO;
  }
};

struct CountHandler {
  const uint8_t* buf;
  int64_t bases = 0;
  bool check_quality;
  uint8_t q_lower, q_span;
  int64_t spec_sl = 0;
  int64_t saved_bases = 0;

  inline void spec_layout(int64_t a, int64_t b, int64_t, int64_t) {
    spec_sl = b - a - 1;
  }
  inline bool spec_allowed(int64_t) const { return true; }
  inline void spec_save() { saved_bases = bases; }
  inline void spec_restore() { bases = saved_bases; }
  inline bool on_spec(int64_t, int64_t, const __m512i*, int) {
    bases += spec_sl;
    return true;
  }

  inline int on_record(int64_t, int64_t h, int64_t s, int64_t p, int64_t q,
                       int64_t e, int32_t* err_code) {
    if (buf[h] != '@') { *err_code = BS_ID_NO_AT; return REC_STOP_DROP; }
    if (buf[p] != '+') { *err_code = BS_SEP_NO_PLUS; return REC_STOP_DROP; }
    const int64_t seq_len = p - s - 1;
    if (seq_len != e - q) {
      *err_code = BS_SEQ_QUAL_LEN_MISMATCH;
      return REC_STOP_DROP;
    }
    if (check_quality && !range_ok_512(buf + q, e - q, q_lower, q_span)) {
      *err_code = BS_QUALITY_OUT_OF_RANGE;  // record left unconsumed
      return REC_STOP_DROP;
    }
    bases += seq_len;
    return REC_GO;
  }
};

template <bool STREAM>
struct PaddedHandler {
  const uint8_t* buf;
  int64_t width;
  int64_t max_rec_size;
  uint8_t* seq_out;
  uint8_t* qual_out;
  int32_t* len_out;
  bool check_quality;
  __m512i vl, vs;
  uint8_t q_lower, q_span;
  // tier-1 layout state
  int64_t s_off = 0, q_off = 0, sl = 0;
  bool vbmi_ok = false;
  int sv0 = 0, sv1 = 0, qv0 = 0, qv1 = 0;
  __m512i sidx0, sidx1, qidx0, qidx1;
  __mmask64 m1 = 0;

  static inline __m512i mkidx(int64_t byte0) {
    uint8_t idx[64];
    for (int i = 0; i < 64; ++i) idx[i] = (uint8_t)((byte0 + i) & 127);
    return _mm512_loadu_si512((const void*)idx);
  }

  inline void spec_layout(int64_t a, int64_t b, int64_t c, int64_t d) {
    s_off = a + 1;
    q_off = c + 1;
    sl = b - a - 1;
    (void)d;
    // VBMI fast emit: rows extracted straight from the verify vectors
    // (v[kb], v[kb+1] are zeroed by the driver, so out-of-record index
    // lanes read zeros). Requires two-block rows; other shapes use the
    // generic copy below.
    vbmi_ok = (width == 128);
    if (vbmi_ok) {
      sv0 = (int)(s_off / 64);
      sidx0 = mkidx(s_off - (int64_t)sv0 * 64);
      sv1 = (int)((s_off + 64) / 64);
      sidx1 = mkidx(s_off + 64 - (int64_t)sv1 * 64);
      qv0 = (int)(q_off / 64);
      qidx0 = mkidx(q_off - (int64_t)qv0 * 64);
      qv1 = (int)((q_off + 64) / 64);
      qidx1 = mkidx(q_off + 64 - (int64_t)qv1 * 64);
      const int64_t c1 = sl > 64 ? (sl - 64 >= 64 ? 64 : sl - 64) : 0;
      m1 = c1 >= 64 ? ~(uint64_t)0 : ((c1 > 0) ? (((uint64_t)1 << c1) - 1) : 0);
      const __mmask64 m0 = sl >= 64 ? ~(uint64_t)0 : (((uint64_t)1 << sl) - 1);
      // block-0 mask folded into the index vectors is not possible; apply
      // maskz on emit when sl < 64
      m0_ = m0;
    }
  }
  __mmask64 m0_ = ~(uint64_t)0;

  inline bool spec_allowed(int64_t rs) const { return rs <= max_rec_size; }
  inline void spec_save() {}
  inline void spec_restore() {}

  inline bool on_spec(int64_t idx, int64_t base, const __m512i* v, int) {
    uint8_t* srow = seq_out + idx * width;
    uint8_t* qrow = qual_out + idx * width;
    if (vbmi_ok) {
      const __m512i s0 =
          _mm512_maskz_permutex2var_epi8(m0_, v[sv0], sidx0, v[sv0 + 1]);
      const __m512i s1 =
          _mm512_maskz_permutex2var_epi8(m1, v[sv1], sidx1, v[sv1 + 1]);
      const __m512i q0 =
          _mm512_maskz_permutex2var_epi8(m0_, v[qv0], qidx0, v[qv0 + 1]);
      const __m512i q1 =
          _mm512_maskz_permutex2var_epi8(m1, v[qv1], qidx1, v[qv1 + 1]);
      if (STREAM) {
        _mm512_stream_si512((__m512i*)srow, s0);
        _mm512_stream_si512((__m512i*)(srow + 64), s1);
        _mm512_stream_si512((__m512i*)qrow, q0);
        _mm512_stream_si512((__m512i*)(qrow + 64), q1);
      } else {
        _mm512_storeu_si512((void*)srow, s0);
        _mm512_storeu_si512((void*)(srow + 64), s1);
        _mm512_storeu_si512((void*)qrow, q0);
        _mm512_storeu_si512((void*)(qrow + 64), q1);
      }
    } else {
      copy_pad_check<STREAM>(srow, buf + base + s_off, sl, width, false, vl,
                             vs);
      copy_pad_check<STREAM>(qrow, buf + base + q_off, sl, width, false, vl,
                             vs);
    }
    len_out[idx] = (int32_t)sl;
    return true;
  }

  inline int on_record(int64_t count, int64_t h, int64_t s, int64_t p,
                       int64_t q, int64_t e, int32_t* err_code) {
    if (buf[h] != '@') { *err_code = BS_ID_NO_AT; return REC_STOP_DROP; }
    if (buf[p] != '+') { *err_code = BS_SEP_NO_PLUS; return REC_STOP_DROP; }
    const int64_t seq_len = p - s - 1;
    if (seq_len != e - q) {
      *err_code = BS_SEQ_QUAL_LEN_MISMATCH;
      return REC_STOP_DROP;
    }
    if (e + 1 - h > max_rec_size) { *err_code = -9; return REC_STOP_DROP; }
    uint8_t* srow = seq_out + count * width;
    uint8_t* qrow = qual_out + count * width;
    copy_pad_check<STREAM>(srow, buf + s, seq_len, width, false, vl, vs);
    __mmask64 bad = copy_pad_check<STREAM>(qrow, buf + q, seq_len, width,
                                           check_quality, vl, vs);
    if (check_quality) {
      if (seq_len > width &&
          !range_ok_512(buf + q + width, seq_len - width, q_lower, q_span))
        bad = 1;
      if (bad) {
        // stop BEFORE the bad record (row bytes written but not counted)
        *err_code = BS_QUALITY_OUT_OF_RANGE;
        return REC_STOP_DROP;
      }
    }
    len_out[count] = (int32_t)seq_len;
    return REC_GO;
  }
};

struct SoaHandler {
  const uint8_t* buf;
  int64_t bytes_cap;   // capacity of seq_out/qual_out
  int64_t id_cap;      // capacity of id_out
  uint8_t* seq_out;
  uint8_t* qual_out;
  int64_t* ends_out;
  uint8_t* id_out;
  int64_t* id_ends_out;
  int64_t total = 0;     // seq/qual bytes written
  int64_t id_total = 0;  // id bytes written
  bool check_quality;
  __m512i vl, vs;
  uint8_t q_lower, q_span;
  int64_t s_off = 0, q_off = 0, sl = 0, hdr_end = 0;
  int64_t saved_total = 0, saved_id_total = 0;

  inline void spec_layout(int64_t a, int64_t b, int64_t c, int64_t) {
    s_off = a + 1;
    q_off = c + 1;
    sl = b - a - 1;
    hdr_end = a;  // newline ending the header line (rel record start)
  }
  inline bool spec_allowed(int64_t) const { return true; }
  inline void spec_save() {
    saved_total = total;
    saved_id_total = id_total;
  }
  inline void spec_restore() {
    total = saved_total;
    id_total = saved_id_total;
  }
  inline bool on_spec(int64_t idx, int64_t base, const __m512i*, int) {
    // id bounds (whitespace-stripped both ends, utils.mojo:223-242) —
    // data-dependent, so computed per record even in the group path
    int64_t a = base + 1, b = base + hdr_end;
    while (a < b && is_posix_space(buf[a])) ++a;
    while (b > a && is_posix_space(buf[b - 1])) --b;
    const int64_t id_len = b - a;
    if (total + sl > bytes_cap || id_total + id_len > id_cap)
      return false;  // output full: group aborts; tier-2 reports -8
    copy_check(seq_out + total, buf + base + s_off, sl, false, vl, vs);
    copy_check(qual_out + total, buf + base + q_off, sl, false, vl, vs);
    total += sl;
    ends_out[idx] = total;
    copy_check(id_out + id_total, buf + a, id_len, false, vl, vs);
    id_total += id_len;
    id_ends_out[idx] = id_total;
    return true;
  }

  inline int on_record(int64_t count, int64_t h, int64_t s, int64_t p,
                       int64_t q, int64_t e, int32_t* err_code) {
    if (buf[h] != '@') { *err_code = BS_ID_NO_AT; return REC_STOP_DROP; }
    if (buf[p] != '+') { *err_code = BS_SEP_NO_PLUS; return REC_STOP_DROP; }
    const int64_t seq_len = p - s - 1;
    if (seq_len != e - q) {
      *err_code = BS_SEQ_QUAL_LEN_MISMATCH;
      return REC_STOP_DROP;
    }
    // id bounds (whitespace-stripped, utils.mojo:223-242)
    int64_t a = h + 1, b = s - 1;
    while (a < b && is_posix_space(buf[a])) ++a;
    while (b > a && is_posix_space(buf[b - 1])) --b;
    const int64_t id_len = b - a;
    if (total + seq_len > bytes_cap || id_total + id_len > id_cap) {
      *err_code = -8;  // output full: caller continues from `consumed`
      return REC_STOP_DROP;
    }
    copy_check(seq_out + total, buf + s, seq_len, false, vl, vs);
    const __mmask64 bad =
        copy_check(qual_out + total, buf + q, seq_len, check_quality, vl, vs);
    if (check_quality && bad) {
      // row bytes written but not counted/consumed (stop-before semantics)
      *err_code = BS_QUALITY_OUT_OF_RANGE;
      return REC_STOP_DROP;
    }
    total += seq_len;
    ends_out[count] = total;
    copy_check(id_out + id_total, buf + a, id_len, false, vl, vs);
    id_total += id_len;
    id_ends_out[count] = id_total;
    return REC_GO;
  }
};

#endif  // __AVX512BW__

}  // namespace

extern "C" {

// Find all '\n' positions in [buf, buf+n); writes up to cap positions into out.
// Returns the number written (callers size cap generously; a second call with
// start offset can resume).
int64_t bs_find_newlines(const uint8_t* buf, int64_t n, int64_t* out,
                         int64_t cap) {
#if defined(__AVX512BW__)
  const __m512i nlv = _mm512_set1_epi8('\n');
  int64_t count = 0;
  for (int64_t base = 0; base < n; base += 64) {
    const int64_t rem = n - base;
    __mmask64 m;
    if (rem >= 64) {
      m = _mm512_cmpeq_epi8_mask(
          _mm512_loadu_si512((const void*)(buf + base)), nlv);
    } else {
      const __mmask64 lm = (((uint64_t)1 << rem) - 1);
      m = _mm512_cmpeq_epi8_mask(_mm512_maskz_loadu_epi8(lm, buf + base),
                                 nlv) &
          lm;
    }
    while (m) {
      if (count >= cap) return count;
      out[count++] = base + (int64_t)_tzcnt_u64(m);
      m &= m - 1;
    }
  }
  return count;
#else
  int64_t count = 0;
  int64_t pos = 0;
  while (count < cap) {
    const void* p = std::memchr(buf + pos, '\n', (size_t)(n - pos));
    if (!p) break;
    pos = (const uint8_t*)p - buf;
    out[count++] = pos;
    ++pos;
    if (pos >= n) break;
  }
  return count;
#endif
}

// Scan a window for complete FASTQ records with fused structure validation and
// optional ASCII / quality-range validation.
//
//   out:        int64[max_records * 5]: header_start, seq_start, sep_start,
//               qual_start, record_end per record (record_end = index of the
//               record's final '\n' = one past the last quality byte).
//   consumed:   offset one past the final newline of the last *returned*
//               record (the next record's header_start).
//   err_code:   BS_OK, a structure code (bad record NOT counted; its partial
//               offsets are written at out[count*5] for snippet building), or
//               a validation code (bad record IS counted & consumed, matching
//               reference consume-then-validate ordering, fastq/parser.mojo:160-170).
//   err_phase:  when the window ends mid-record: number of newlines already
//               found for the partial record (0..3). Python uses this for
//               EOF handling (reference _check_end_qual, utils.mojo:294-329).
//
// Returns the number of complete valid-structure records written to out
// (including, for validation errors, the failing record as the last one).
int64_t bs_scan_fastq(const uint8_t* buf, int64_t n, int64_t start,
                      int64_t max_records, int32_t check_ascii,
                      int32_t check_quality, uint8_t q_lower, uint8_t q_span,
                      int64_t* out, int64_t* consumed, int32_t* err_code,
                      int32_t* err_phase) {
#if defined(__AVX512BW__)
  OffsetsHandler hd{buf, out, check_quality != 0, q_lower, q_span};
  bool acc_bad = false;
  const int64_t count = scan_loop_512(buf, n, start, max_records, hd, consumed,
                                      err_code, err_phase, &acc_bad);
  if (check_ascii && acc_bad) {
    // High bit seen somewhere in the scanned region: rerun the scalar path
    // for exact per-record ASCII semantics (id/seq/qual spans only, ordered
    // before the quality check).
    return scan_fastq_scalar(buf, n, start, max_records, check_ascii,
                             check_quality, q_lower, q_span, out, consumed,
                             err_code, err_phase);
  }
  return count;
#else
  return scan_fastq_scalar(buf, n, start, max_records, check_ascii,
                           check_quality, q_lower, q_span, out, consumed,
                           err_code, err_phase);
#endif
}

// Gather SoA arrays from a window + offset table in one pass:
// copies sequence bytes and quality bytes into contiguous output buffers and
// writes cumulative end offsets (int64). Returns total bases copied.
int64_t bs_gather_soa(const uint8_t* buf, const int64_t* offsets, int64_t nrec,
                      uint8_t* seq_out, uint8_t* qual_out, int64_t* ends_out) {
  int64_t total = 0;
  for (int64_t i = 0; i < nrec; ++i) {
    const int64_t* rec = offsets + i * 5;
    const int64_t s = rec[1];
    const int64_t p = rec[2];
    const int64_t q = rec[3];
    const int64_t len = p - s - 1;
    std::memcpy(seq_out + total, buf + s, (size_t)len);
    std::memcpy(qual_out + total, buf + q, (size_t)len);
    total += len;
    ends_out[i] = total;
  }
  return total;
}

// Gather id bytes (header line content after '@', POSIX-whitespace-stripped on
// both ends, reference: utils.mojo:223-242) into a contiguous buffer with
// cumulative ends. Returns total id bytes.
int64_t bs_gather_ids(const uint8_t* buf, const int64_t* offsets, int64_t nrec,
                      uint8_t* id_out, int64_t* id_ends_out) {
  auto is_space = [](uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
           c == '\r' || c == 0x1c || c == 0x1d || c == 0x1e;
  };
  int64_t total = 0;
  for (int64_t i = 0; i < nrec; ++i) {
    const int64_t* rec = offsets + i * 5;
    int64_t a = rec[0] + 1;      // after '@'
    int64_t b = rec[1] - 1;      // before '\n'
    while (a < b && is_space(buf[a])) ++a;
    while (b > a && is_space(buf[b - 1])) --b;
    const int64_t len = b - a;
    std::memcpy(id_out + total, buf + a, (size_t)len);
    total += len;
    id_ends_out[i] = total;
  }
  return total;
}

// Fused scan + validate + padded gather: one pass over the window that finds
// record boundaries, applies structure/ASCII/quality validation, and writes
// seq/qual straight into the padded [*, width] device layout. This is the
// single-pass host->HBM feed kernel (bytes are touched once on read, once on
// write). Reads longer than width are clamped (reference MAX_QUERY_LEN
// semantics, examples/nw_gpu/kernels.mojo:15-16).
//
// Stops BEFORE any record that fails validation/structure or exceeds
// max_rec_size (err_code set, nothing of that record consumed); the caller
// rescans it through bs_scan_fastq for exact error context. err_code -9 means
// capacity exceeded.
int64_t bs_scan_gather_padded(const uint8_t* buf, int64_t n, int64_t start,
                              int64_t max_records, int64_t width,
                              int32_t check_ascii, int32_t check_quality,
                              uint8_t q_lower, uint8_t q_span,
                              int64_t max_rec_size, uint8_t* seq_out,
                              uint8_t* qual_out, int32_t* len_out,
                              int64_t* consumed, int32_t* err_code,
                              int32_t* err_phase) {
#if defined(__AVX512BW__)
  const bool can_stream =
      ((reinterpret_cast<uintptr_t>(seq_out) & 63) == 0) &&
      ((reinterpret_cast<uintptr_t>(qual_out) & 63) == 0) && (width % 64 == 0);
  bool acc_bad = false;
  int64_t count;
  if (can_stream) {
    PaddedHandler<true> hd{buf,
                           width,
                           max_rec_size,
                           seq_out,
                           qual_out,
                           len_out,
                           check_quality != 0,
                           _mm512_set1_epi8((char)q_lower),
                           _mm512_set1_epi8((char)q_span),
                           q_lower,
                           q_span};
    count = scan_loop_512(buf, n, start, max_records, hd, consumed, err_code,
                          err_phase, &acc_bad);
    _mm_sfence();  // make the non-temporal row stores globally visible
  } else {
    PaddedHandler<false> hd{buf,
                            width,
                            max_rec_size,
                            seq_out,
                            qual_out,
                            len_out,
                            check_quality != 0,
                            _mm512_set1_epi8((char)q_lower),
                            _mm512_set1_epi8((char)q_span),
                            q_lower,
                            q_span};
    count = scan_loop_512(buf, n, start, max_records, hd, consumed, err_code,
                          err_phase, &acc_bad);
  }
  if (check_ascii && acc_bad) {
    return scan_gather_padded_scalar(buf, n, start, max_records, width,
                                     check_ascii, check_quality, q_lower,
                                     q_span, max_rec_size, seq_out, qual_out,
                                     len_out, consumed, err_code, err_phase);
  }
  return count;
#else
  return scan_gather_padded_scalar(buf, n, start, max_records, width,
                                   check_ascii, check_quality, q_lower, q_span,
                                   max_rec_size, seq_out, qual_out, len_out,
                                   consumed, err_code, err_phase);
#endif
}

// Fused scan + validate + flat-SoA gather (batch mode): one pass producing
// concatenated seq/qual bytes + cumulative ends and whitespace-stripped ids
// + ends — the whole FastqBatch payload with bytes touched once. Stops
// BEFORE any record that fails validation/structure (err_code set, nothing
// of it consumed; caller rescans via bs_scan_fastq for exact context) or
// that would overflow an output buffer (err_code -8: caller continues from
// `consumed` with fresh buffers).
int64_t bs_scan_gather_soa(const uint8_t* buf, int64_t n, int64_t start,
                           int64_t max_records, int64_t bytes_cap,
                           int64_t id_cap, int32_t check_ascii,
                           int32_t check_quality, uint8_t q_lower,
                           uint8_t q_span, uint8_t* seq_out, uint8_t* qual_out,
                           int64_t* ends_out, uint8_t* id_out,
                           int64_t* id_ends_out, int64_t* total_out,
                           int64_t* id_total_out, int64_t* consumed,
                           int32_t* err_code, int32_t* err_phase) {
#if defined(__AVX512BW__)
  SoaHandler hd{buf,    bytes_cap, id_cap,      seq_out,
                qual_out, ends_out, id_out,     id_ends_out,
                0,        0,        check_quality != 0,
                _mm512_set1_epi8((char)q_lower),
                _mm512_set1_epi8((char)q_span),
                q_lower,  q_span};
  bool acc_bad = false;
  const int64_t count = scan_loop_512(buf, n, start, max_records, hd, consumed,
                                      err_code, err_phase, &acc_bad);
  *total_out = hd.total;
  *id_total_out = hd.id_total;
  if (check_ascii && acc_bad) {
    // precise per-record ASCII semantics via the offsets+gather slow path:
    // signal the caller to discard this output and fall back (rare:
    // non-ASCII bytes present somewhere in the scanned region)
    *err_code = -9;
    return count;
  }
  return count;
#else
  (void)bytes_cap; (void)id_cap; (void)check_quality;
  (void)q_lower; (void)q_span; (void)seq_out; (void)qual_out;
  (void)ends_out; (void)id_out; (void)id_ends_out;
  *total_out = 0;
  *id_total_out = 0;
  *consumed = start;
  *err_code = -9;  // no fused path: caller uses the offsets+gather path
  *err_phase = 0;
  return 0;
#endif
}

// Gather directly into the padded [nrec, width] device layout (rows
// zero-padded, reads clamped to width). Writes per-record lengths (true).
// This is the host->HBM feed fast path: one memcpy per line, no intermediate
// flat SoA. The quality copy stops at the record's end (rec[4]) and the rest
// of its row is zero: a last record without its final newline may have a
// quality line shorter than its sequence, and the bytes past it are not the
// record's.
void bs_gather_padded(const uint8_t* buf, const int64_t* offsets, int64_t nrec,
                      int64_t width, uint8_t* seq_out, uint8_t* qual_out,
                      int32_t* len_out) {
  for (int64_t i = 0; i < nrec; ++i) {
    const int64_t* rec = offsets + i * 5;
    const int64_t s = rec[1];
    const int64_t p = rec[2];
    const int64_t q = rec[3];
    const int64_t true_len = p - s - 1;
    int64_t len = true_len > width ? width : true_len;
    int64_t qlen = rec[4] - q;
    if (qlen > len) qlen = len;
    if (qlen < 0) qlen = 0;
    uint8_t* srow = seq_out + i * width;
    uint8_t* qrow = qual_out + i * width;
    std::memcpy(srow, buf + s, (size_t)len);
    std::memcpy(qrow, buf + q, (size_t)qlen);
    std::memset(srow + len, 0, (size_t)(width - len));
    std::memset(qrow + qlen, 0, (size_t)(width - qlen));
    len_out[i] = (int32_t)true_len;
  }
}

// Rows of a flat SoA batch into the padded [rows, width] layout
// (FastqBatch.to_padded): record i spans [ends[i-1], ends[i]) of seq and
// qual; its row gets the first min(len, width) bytes and zeros after them,
// rows n..rows-1 are zero. len_out holds the true lengths (not clamped),
// and 0 on the padding rows. Every byte of the outputs is written.
void bs_pad_rows(const uint8_t* seq, const uint8_t* qual, const int64_t* ends,
                 int64_t n, int64_t width, int64_t rows, uint8_t* seq_out,
                 uint8_t* qual_out, int32_t* len_out) {
  int64_t start = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = ends[i] - start;
    const int64_t keep = len < width ? len : width;
    uint8_t* srow = seq_out + i * width;
    uint8_t* qrow = qual_out + i * width;
    std::memcpy(srow, seq + start, (size_t)keep);
    std::memcpy(qrow, qual + start, (size_t)keep);
    std::memset(srow + keep, 0, (size_t)(width - keep));
    std::memset(qrow + keep, 0, (size_t)(width - keep));
    len_out[i] = (int32_t)len;
    start = ends[i];
  }
  if (rows > n) {
    std::memset(seq_out + n * width, 0, (size_t)((rows - n) * width));
    std::memset(qual_out + n * width, 0, (size_t)((rows - n) * width));
    std::memset(len_out + n, 0, (size_t)(rows - n) * sizeof(int32_t));
  }
}

// Count reads and bases in a window without materializing anything
// (views-mode equivalent: reference benchmark runners print `records base_pairs`,
// benchmark/fastq-parser/run_blazeseq.mojo:21-60).
int64_t bs_count_fastq(const uint8_t* buf, int64_t n, int64_t start,
                       int32_t check_ascii, int32_t check_quality,
                       uint8_t q_lower, uint8_t q_span,
                       int64_t* bases_out, int64_t* consumed,
                       int32_t* err_code, int32_t* err_phase) {
#if defined(__AVX512BW__)
  CountHandler hd{buf, 0, check_quality != 0, q_lower, q_span};
  bool acc_bad = false;
  const int64_t count =
      scan_loop_512(buf, n, start, (int64_t)1 << 62, hd, consumed, err_code,
                    err_phase, &acc_bad);
  if (check_ascii && acc_bad) {
    return count_fastq_scalar(buf, n, start, check_ascii, check_quality,
                              q_lower, q_span, bases_out, consumed, err_code,
                              err_phase);
  }
  *bases_out = hd.bases;
  return count;
#else
  return count_fastq_scalar(buf, n, start, check_ascii, check_quality, q_lower,
                            q_span, bases_out, consumed, err_code, err_phase);
#endif
}

// Deterministic synthetic FASTQ generator (exact model of the reference
// generator, blazeseq/utils.mojo:707-917: per-read Knuth MMIX LCG masked to
// 63 bits, GC-biased 8-slot LUT, linear quality decay + LCG jitter).
// Writes records for reads [first_read, first_read + num_reads) into out;
// returns bytes written. num_digits fixes the zero-padded header width.
int64_t bs_generate_fastq(int64_t first_read, int64_t num_reads,
                          int64_t total_reads_for_digits, int64_t min_length,
                          int64_t max_length, int64_t min_phred,
                          int64_t max_phred, int32_t offset_i, int32_t lower_i,
                          int32_t upper_i, const uint8_t* base_lut,
                          uint8_t* out) {
  const uint64_t MASK63 = 0x7FFFFFFFFFFFFFFFULL;
  const uint64_t A = 6364136223846793005ULL;
  const uint64_t C = 1442695040888963407ULL;
  int64_t num_digits = 1;
  if (total_reads_for_digits > 1) {
    num_digits = 0;
    for (int64_t v = total_reads_for_digits - 1; v > 0; v /= 10) ++num_digits;
  }
  const int64_t q_start = max_phred;
  const int64_t q_range = max_phred - min_phred;
  const int64_t noise_amp = (q_range / 6) + 1;
  const int64_t noise_mod = 2 * noise_amp + 1;

  uint8_t* p = out;
  for (int64_t i = first_read; i < first_read + num_reads; ++i) {
    int64_t read_len = (max_length == min_length)
                           ? min_length
                           : min_length + ((i * 31 + 7) %
                                           (max_length - min_length + 1));
    // header: @read_<zero-padded i>\n
    *p++ = '@'; *p++ = 'r'; *p++ = 'e'; *p++ = 'a'; *p++ = 'd'; *p++ = '_';
    for (int64_t k = num_digits - 1; k >= 0; --k) {
      int64_t div = 1;
      for (int64_t t = 0; t < k; ++t) div *= 10;
      *p++ = (uint8_t)('0' + (i / div) % 10);
    }
    *p++ = '\n';
    // sequence
    uint64_t s = ((uint64_t)i * A + C) & MASK63;
    for (int64_t b = 0; b < read_len; ++b) {
      s = (s * A + C) & MASK63;
      p[b] = base_lut[(s >> 33) & 7];
    }
    p += read_len;
    *p++ = '\n'; *p++ = '+'; *p++ = '\n';
    // quality: linear decay + jitter
    uint64_t q = ((uint64_t)i * 2654435761ULL + 1013904223ULL) & MASK63;
    const int64_t lm1 = read_len - 1;
    for (int64_t b = 0; b < read_len; ++b) {
      int64_t mean =
          (lm1 == 0) ? q_start
                     : q_start - (q_range * b + lm1 / 2) / lm1;
      q = (q * 1664525ULL + 1013904223ULL) & MASK63;
      int64_t noise = (int64_t)((q >> 17) % (uint64_t)noise_mod);
      int64_t phred = mean + noise - noise_amp;
      if (phred < min_phred) phred = min_phred;
      if (phred > max_phred) phred = max_phred;
      int64_t a = offset_i + phred;
      if (a < lower_i) a = lower_i;
      if (a > upper_i) a = upper_i;
      p[b] = (uint8_t)a;
    }
    p += read_len;
    *p++ = '\n';
  }
  return p - out;
}

namespace {
// Stateful newline finder: consecutive next() calls with non-decreasing
// `from` walk the window with 64-byte cmpeq masks instead of one memchr call
// per line (per-call setup dominates for ~60-byte FASTA lines). Falls back
// to memchr on non-AVX512 builds.
struct NlCursor {
  const uint8_t* buf;
  int64_t n;
#if defined(__AVX512BW__)
  int64_t base = -64;   // block start of the cached mask
  uint64_t m = 0;       // newline mask of the cached block

  // First '\n' at or after `from`; -1 when none before window end.
  inline int64_t next(int64_t from) {
    if (from >= n) return -1;
    const __m512i nlv = _mm512_set1_epi8('\n');
    if (from >= base && from < base + 64) {
      uint64_t mm = m & (~(uint64_t)0 << (from - base));
      if (mm) return base + (int64_t)_tzcnt_u64(mm);
      base += 64;
    } else {
      base = from & ~(int64_t)63;
    }
    for (; base < n; base += 64) {
      const int64_t rem = n - base;
      if (rem >= 64) {
        m = (uint64_t)_mm512_cmpeq_epi8_mask(
            _mm512_loadu_si512((const void*)(buf + base)), nlv);
      } else {
        const __mmask64 lm = (((uint64_t)1 << rem) - 1);
        m = (uint64_t)_mm512_cmpeq_epi8_mask(
                _mm512_maskz_loadu_epi8(lm, buf + base), nlv) &
            lm;
      }
      uint64_t mm = m;
      if (base < from) mm &= (~(uint64_t)0 << (from - base));
      if (mm) return base + (int64_t)_tzcnt_u64(mm);
    }
    base = n;
    m = 0;
    return -1;
  }
#else
  inline int64_t next(int64_t from) {
    if (from >= n) return -1;
    const void* p = std::memchr(buf + from, '\n', (size_t)(n - from));
    return p ? (const uint8_t*)p - buf : -1;
  }
#endif
};
}  // namespace

// Count FASTA records and sequence bases in window[start, n) without
// materializing anything — the FASTA analog of bs_count_fastq (reference
// counting runner: benchmark/fasta-parser/run_blazeseq_fasta.mojo).
//
// One vector pass computes, per 64-byte block, the newline mask, the
// '>'-at-line-start mask, and the POSIX-non-whitespace popcount; headers
// (rare: one per record) get small scalar fixups subtracting their own
// non-whitespace bytes. This equals the parser's strip-and-concatenate
// length accounting whenever whitespace only appears at line edges. Any
// layout the fast accounting cannot prove equal — leading whitespace at a
// line start (includes blank/space-only lines), whitespace INSIDE a
// sequence line, content before the first header, or a header with an
// empty sequence — sets *fallback=1 and the caller re-runs the exact
// bs_scan_fasta path, so results are always byte-exact.
//
//   at_eof:   1 = the final (possibly unterminated) line is complete.
//   consumed: one past the last complete line counted.
// Returns the record count; *bases_out = sequence bytes.
int64_t bs_count_fasta(const uint8_t* buf, int64_t n, int64_t start,
                       int32_t at_eof, int64_t* bases_out, int64_t* consumed,
                       int64_t* lines_out, int32_t* fallback) {
  *bases_out = 0;
  *consumed = start;
  *lines_out = 0;
  *fallback = 0;
  if (start >= n) return 0;
#if !defined(__AVX512BW__)
  *fallback = 1;
  return 0;
#else
  // vectorized sub-span counters (header fixups + window tails, which can
  // be most of the window when one record's sequence spans many windows)
  auto count_nonws_span = [&](int64_t a, int64_t b) -> int64_t {
    const __m512i w9_ = _mm512_set1_epi8(9);
    const __m512i w5_ = _mm512_set1_epi8(13 - 9);
    const __m512i wfs_ = _mm512_set1_epi8(0x1c);
    const __m512i w2_ = _mm512_set1_epi8(0x1e - 0x1c);
    const __m512i spv_ = _mm512_set1_epi8(' ');
    int64_t total = 0;
    for (int64_t p = a; p < b; p += 64) {
      const int64_t rem = b - p;
      __mmask64 lm = rem >= 64 ? ~(uint64_t)0 : (((uint64_t)1 << rem) - 1);
      const __m512i v = _mm512_maskz_loadu_epi8(lm, buf + p);
      const uint64_t ws =
          (_mm512_cmp_epu8_mask(_mm512_sub_epi8(v, w9_), w5_, _MM_CMPINT_LE) |
           _mm512_cmp_epu8_mask(_mm512_sub_epi8(v, wfs_), w2_, _MM_CMPINT_LE) |
           _mm512_cmpeq_epi8_mask(v, spv_)) & lm;
      total += (int64_t)_mm_popcnt_u64(~ws & lm);
    }
    return total;
  };
  auto count_nl_span = [&](int64_t a, int64_t b) -> int64_t {
    const __m512i nlv_ = _mm512_set1_epi8('\n');
    int64_t total = 0;
    for (int64_t p = a; p < b; p += 64) {
      const int64_t rem = b - p;
      __mmask64 lm = rem >= 64 ? ~(uint64_t)0 : (((uint64_t)1 << rem) - 1);
      const __m512i v = _mm512_maskz_loadu_epi8(lm, buf + p);
      total += (int64_t)_mm_popcnt_u64(_mm512_cmpeq_epi8_mask(v, nlv_) & lm);
    }
    return total;
  };
  // effective end: one past the last newline (all of [start, n) if at_eof)
  int64_t end = n;
  if (!at_eof) {
    int64_t i = n - 1;
    while (i >= start && buf[i] != '\n') --i;
    if (i < start) return 0;  // no complete line yet
    end = i + 1;
  }

  const __m512i nlv = _mm512_set1_epi8('\n');
  const __m512i gtv = _mm512_set1_epi8('>');
  // POSIX whitespace: \t(9)..\r(13), 0x1c..0x1e, ' '(32)
  const __m512i w9 = _mm512_set1_epi8(9);
  const __m512i w5 = _mm512_set1_epi8(13 - 9);
  const __m512i wfs = _mm512_set1_epi8(0x1c);
  const __m512i w2 = _mm512_set1_epi8(0x1e - 0x1c);
  const __m512i spv = _mm512_set1_epi8(' ');

  int64_t records = 0;
  int64_t nonws_total = 0;
  int64_t nl_total = 0;
  uint64_t bad = 0;
  uint64_t prev_last_nl = 1;     // virtual newline before the window start
  uint64_t prev_last_ws = 0;     // was the window's previous byte whitespace
  // header positions, one per record: a complete record needs >= 4 bytes
  // (">\n" + one base + newline), so span/4+2 bounds the count
  const int64_t HCAP = (end - start) / 4 + 2;
  int64_t* headers = (int64_t*)std::malloc((size_t)HCAP * sizeof(int64_t));
  if (!headers) { *fallback = 1; return 0; }
  struct Guard {
    void* p;
    ~Guard() { std::free(p); }
  } guard{headers};
  int64_t n_headers = 0;
  int64_t first_nonws = -1;

  // Fast tier: a 256-byte group whose every byte is printable (>= 33) or
  // '\n' — true for all pure sequence/bare-header content — needs only the
  // newline mask: no whitespace classes exist (ws/controls are all < 33),
  // so nonws = ~nl, the `bad` rules can't trigger, and '>'-headers are
  // found by scalar checks at the (rare) line-start bits. Any group with a
  // byte < 33 besides '\n' (header descriptions with spaces, indented or
  // blank-with-space lines, controls) drops to the exact per-block tier
  // below for one block. This tripled the count rate on this host (the
  // 5-compare byte classification dominated the loop).
  const __m512i lo33 = _mm512_set1_epi8(33);
  int64_t base = start;
  while (base < end) {
    const int64_t rem = end - base;
    if (rem >= 256) {
      uint64_t nls[4], lows[4];
#pragma GCC unroll 4
      for (int j = 0; j < 4; ++j) {
        const __m512i vj =
            _mm512_loadu_si512((const void*)(buf + base + j * 64));
        nls[j] = _mm512_cmpeq_epi8_mask(vj, nlv);
        lows[j] = _mm512_cmp_epu8_mask(vj, lo33, _MM_CMPINT_LT);
      }
      if (((lows[0] ^ nls[0]) | (lows[1] ^ nls[1]) | (lows[2] ^ nls[2]) |
           (lows[3] ^ nls[3])) == 0) {
        // a whitespace byte ending the previous block followed by content
        // here is interior whitespace (same rule as the exact tier)
        bad |= prev_last_ws & ~nls[0] & 1;
        int64_t nlp = 0;
#pragma GCC unroll 4
        for (int j = 0; j < 4; ++j) {
          const uint64_t nl_j = nls[j];
          uint64_t ls = (nl_j << 1) | (prev_last_nl & 1);
          prev_last_nl = nl_j >> 63;
          while (ls) {
            const int64_t p = base + j * 64 + (int64_t)_tzcnt_u64(ls);
            if (buf[p] == '>') {
              if (n_headers >= HCAP) { *fallback = 1; return 0; }
              headers[n_headers++] = p;
            }
            ls &= ls - 1;
          }
          if (first_nonws < 0 && ~nl_j)
            first_nonws = base + j * 64 + (int64_t)_tzcnt_u64(~nl_j);
          nlp += (int64_t)_mm_popcnt_u64(nl_j);
        }
        nl_total += nlp;
        nonws_total += 256 - nlp;
        prev_last_ws = 0;
        base += 256;
        continue;
      }
    }
    __m512i v;
    __mmask64 lane_m = ~(uint64_t)0;
    if (rem >= 64) {
      v = _mm512_loadu_si512((const void*)(buf + base));
    } else {
      lane_m = (((uint64_t)1 << rem) - 1);
      v = _mm512_maskz_loadu_epi8(lane_m, buf + base);
    }
    const uint64_t nl = _mm512_cmpeq_epi8_mask(v, nlv) & lane_m;
    const uint64_t gt = _mm512_cmpeq_epi8_mask(v, gtv) & lane_m;
    const uint64_t ws_r = _mm512_cmp_epu8_mask(_mm512_sub_epi8(v, w9), w5,
                                               _MM_CMPINT_LE);
    const uint64_t ws_f = _mm512_cmp_epu8_mask(_mm512_sub_epi8(v, wfs), w2,
                                               _MM_CMPINT_LE);
    const uint64_t ws_sp = _mm512_cmpeq_epi8_mask(v, spv);
    const uint64_t ws = (ws_r | ws_f | ws_sp) & lane_m;
    const uint64_t nonws = ~ws & lane_m;
    // line starts: bit after each newline (with carry from previous block)
    const uint64_t line_start = (nl << 1) | (prev_last_nl & 1);
    const uint64_t ws_nonl = ws & ~nl;
    // leading whitespace at a line start (covers blank/space-only lines)
    bad |= ws_nonl & line_start;
    // whitespace followed by non-whitespace within a line (interior ws);
    // the carry handles runs crossing block boundaries
    bad |= ((ws_nonl << 1) | prev_last_ws) & nonws;
    const uint64_t hdr = gt & line_start;
    uint64_t h = hdr;
    while (h) {
      if (n_headers >= HCAP) { *fallback = 1; return 0; }
      headers[n_headers++] = base + (int64_t)_tzcnt_u64(h);
      h &= h - 1;
    }
    nonws_total += (int64_t)_mm_popcnt_u64(nonws);
    nl_total += (int64_t)_mm_popcnt_u64(nl);
    if (first_nonws < 0 && nonws)
      first_nonws = base + (int64_t)_tzcnt_u64(nonws);
    prev_last_nl = nl >> 63;
    prev_last_ws = (ws_nonl >> 63) & 1;
    if (rem < 64) break;
    base += 64;
  }
  if (bad) { *fallback = 1; return 0; }
  if (n_headers == 0) {
    if (first_nonws >= 0) { *fallback = 1; return 0; }  // content, no header
    *consumed = end;
    *lines_out = nl_total;
    return 0;  // blank lines only
  }
  if (first_nonws < headers[0]) { *fallback = 1; return 0; }

  // scalar fixups at each header line (subtract its non-ws bytes) and
  // empty-sequence detection between consecutive records
  int64_t hdr_nonws = 0;
  for (int k = 0; k < n_headers; ++k) {
    const int64_t h = headers[k];
    const void* m = std::memchr(buf + h, '\n', (size_t)(end - h));
    const int64_t eol = m ? ((const uint8_t*)m - buf) : end;
    if (!m && !at_eof) break;  // incomplete trailing header: not consumed
    hdr_nonws += count_nonws_span(h, eol);
    // sequence must have a non-ws byte before the next header / end
    const int64_t nxt = (k + 1 < n_headers) ? headers[k + 1] : end;
    int64_t i = eol;
    while (i < nxt && is_posix_space(buf[i])) ++i;
    if (i >= nxt) {
      // empty sequence (error 101), or a header whose sequence has not
      // arrived yet: both are rare edges — let the exact path decide
      *fallback = 1;
      return 0;
    }
    ++records;
  }
  // a trailing record whose sequence may continue past the window: without
  // at_eof, everything from the LAST header onward stays unconsumed so the
  // next window rescans it with more data
  if (!at_eof) {
    // the last record's sequence may continue past the window: leave
    // everything from the LAST header onward unconsumed for the next scan
    const int64_t last_h = headers[n_headers - 1];
    const int64_t tail_nonws = count_nonws_span(last_h, end);
    const void* m = std::memchr(buf + last_h, '\n', (size_t)(end - last_h));
    const int64_t eol = m ? ((const uint8_t*)m - buf) : end;
    const int64_t last_hdr_nonws = count_nonws_span(last_h, eol);
    *bases_out = nonws_total - (hdr_nonws - last_hdr_nonws) - tail_nonws;
    *consumed = last_h;
    *lines_out = nl_total - count_nl_span(last_h, end);
    return records - 1;
  }
  *bases_out = nonws_total - hdr_nonws;
  *consumed = end;
  *lines_out = nl_total;
  return records;
#endif
}

// Scan a window for complete FASTA records (behavior spec:
// blazeseq/fasta/parser.mojo:120-195 — every line whitespace-stripped at both
// ends, multi-line sequences concatenated, blank lines skipped, a stripped
// line starting with '>' begins the next record).
//
//   at_eof:     1 when the window is the end of the stream; the trailing
//               record (no following '>' header) is then flushed.
//   id_out/id_ends, seq_out/seq_ends: concatenated bytes + cumulative ends
//               (caller sizes both at window length).
//   consumed:   byte offset of the next unconsumed line (start of the next
//               record's header line, or n when everything was consumed).
//   lines_consumed: '\n' count within [start, consumed).
//   err_code:   0 OK; 100 header-missing ('>' expected); 101 empty sequence;
//               4 ASCII_INVALID (when check_ascii). The failing record is not
//               counted. err_line = 0-based line index (within this scan)
//               of the offending line.
// Returns number of complete records.
int64_t bs_scan_fasta(const uint8_t* buf, int64_t n, int64_t start,
                      int32_t at_eof, int64_t max_records, int32_t check_ascii,
                      uint8_t* id_out, int64_t* id_ends, uint8_t* seq_out,
                      int64_t* seq_ends, int64_t* consumed,
                      int64_t* lines_consumed, int32_t* err_code,
                      int64_t* err_line) {
  int64_t pos = start;
  int64_t count = 0;
  int64_t id_base = 0, seq_base = 0;
  int64_t line_idx = 0;            // lines seen within this scan
  int64_t committed_lines = 0;     // lines within [start, consumed)
  *consumed = start;
  *lines_consumed = 0;
  *err_code = 0;
  *err_line = 0;

  bool have_header = false;
  int64_t id_tent_len = 0;   // tentative id bytes at id_out + id_base
  int64_t seq_tent_len = 0;  // tentative seq bytes at seq_out + seq_base
  int64_t header_line = 0;
  bool tent_ascii_bad = false;
  int64_t tent_bad_line = 0;

  auto commit = [&]() -> bool {  // returns false on error
    if (seq_tent_len == 0) {
      *err_code = 101;
      *err_line = header_line + 1;  // sequence expected on the next line
      return false;
    }
    if (check_ascii && tent_ascii_bad) {
      *err_code = 4;
      *err_line = tent_bad_line;
      return false;
    }
    id_base += id_tent_len;
    seq_base += seq_tent_len;
    id_ends[count] = id_base;
    seq_ends[count] = seq_base;
    ++count;
    return true;
  };

  NlCursor nlc{buf, n};
  while (pos < n && count < max_records) {
    const int64_t found = nlc.next(pos);
    int64_t eol;
    bool had_newline = true;
    if (found >= 0) {
      eol = found;
    } else if (at_eof) {
      eol = n;
      had_newline = false;
    } else {
      break;  // incomplete line; caller refills
    }
    // strip both ends (POSIX whitespace)
    int64_t a = pos, b = eol;
    while (a < b && is_posix_space(buf[a])) ++a;
    while (b > a && is_posix_space(buf[b - 1])) --b;

    if (!have_header) {
      if (a == b) {  // blank line before header
        pos = eol + 1;
        ++line_idx;
        if (had_newline) { *consumed = pos; ++committed_lines; }
        continue;
      }
      if (buf[a] != '>') {
        *err_code = 100;
        *err_line = line_idx;
        *lines_consumed = committed_lines;
        return count;
      }
      int64_t ia = a + 1, ib = b;
      while (ia < ib && is_posix_space(buf[ia])) ++ia;
      id_tent_len = ib - ia;
      std::memcpy(id_out + id_base, buf + ia, (size_t)id_tent_len);
      if (check_ascii && !all_ascii(buf + ia, id_tent_len)) {
        tent_ascii_bad = true;
        tent_bad_line = line_idx;
      } else {
        tent_ascii_bad = false;
      }
      seq_tent_len = 0;
      have_header = true;
      header_line = line_idx;
    } else if (a < b && buf[a] == '>') {
      // next record's header: commit the current record first
      if (!commit()) { *lines_consumed = committed_lines; return count; }
      *consumed = pos;  // next record starts at this header line
      committed_lines = line_idx;
      *lines_consumed = committed_lines;
      // reprocess this header line for the new record
      int64_t ia = a + 1, ib = b;
      while (ia < ib && is_posix_space(buf[ia])) ++ia;
      id_tent_len = ib - ia;
      std::memcpy(id_out + id_base, buf + ia, (size_t)id_tent_len);
      tent_ascii_bad =
          check_ascii && !all_ascii(buf + ia, id_tent_len);
      if (tent_ascii_bad) tent_bad_line = line_idx;
      seq_tent_len = 0;
      header_line = line_idx;
    } else {
      // sequence line (possibly blank -> appends nothing)
      std::memcpy(seq_out + seq_base + seq_tent_len, buf + a, (size_t)(b - a));
      if (check_ascii && !tent_ascii_bad && !all_ascii(buf + a, b - a)) {
        tent_ascii_bad = true;
        tent_bad_line = line_idx;
      }
      seq_tent_len += b - a;
    }
    pos = eol + 1;
    ++line_idx;
    if (found < 0) break;  // consumed the unterminated final line
  }

  if (at_eof && have_header && count < max_records && pos >= n) {
    if (commit()) {
      *consumed = n;
      committed_lines = line_idx;
    }
  }
  *lines_consumed = committed_lines;
  return count;
}


// Bulk FASTQ serialization: '@id\nseq\n+\nqual\n' per record, one
// memcpy pass (the write-side complement of the bulk scan). Per-record
// seq/qual spans are (offs[i], lens[i]) into the shared seq/qual arrays
// (callers compute offsets for SoA or padded-row layouts); records with
// lens[i] <= 0 are skipped. Returns bytes written, or -1 when out_cap is
// too small (caller sizes exactly, so -1 means a caller bug).
int64_t bs_serialize_fastq(const uint8_t* ids, const int64_t* id_starts,
                           const int64_t* id_lens, const uint8_t* seq,
                           const uint8_t* qual, const int64_t* offs,
                           const int64_t* lens, int64_t n, uint8_t* out,
                           int64_t out_cap) {
  uint8_t* p = out;
  uint8_t* const end = out + out_cap;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t ln = lens[i];
    if (ln <= 0) continue;
    const int64_t il = id_lens[i];
    if (p + 1 + il + 1 + ln + 3 + ln + 1 > end) return -1;
    *p++ = '@';
    std::memcpy(p, ids + id_starts[i], (size_t)il);
    p += il;
    *p++ = '\n';
    std::memcpy(p, seq + offs[i], (size_t)ln);
    p += ln;
    *p++ = '\n';
    *p++ = '+';
    *p++ = '\n';
    std::memcpy(p, qual + offs[i], (size_t)ln);
    p += ln;
    *p++ = '\n';
  }
  return p - out;
}

// Normalize a semi-uniform FASTQ region — fixed seq/qual length L, bare
// '+' separator, variable id-line widths (id text <= idw bytes) — into a
// UNIFORM layout: each record rewritten as
//   '@' id <spaces to idw> '\n' seq[L] '\n' '+' '\n' qual[L] '\n'
// with fixed stride rs = idw + 2*L + 6. The trailing-space id padding is
// QC-invisible (no stat reads id bytes) and ASCII-clean; the device
// template proof re-verifies the produced layout byte-for-byte, so a
// false accept here (e.g. a short seq line whose byte at offset L happens
// to be '\n') only costs a chunk fallback, never exactness.
//
// Stops at the first record that does not match (id too wide, seq/qual
// length != L, '+' line not bare, partial tail) or when dst is full.
// Returns the record count written to dst; *consumed = src bytes consumed
// (a record boundary).
int64_t bs_normalize_semi_uniform(const uint8_t* src, int64_t n,
                                  int64_t start, uint8_t* dst,
                                  int64_t dst_cap, int64_t idw, int64_t L,
                                  int64_t* consumed) {
  const int64_t rs = idw + 2 * L + 6;
  int64_t p = start;
  uint8_t* out = dst;
  uint8_t* const dend = dst + dst_cap;
  int64_t count = 0;
  while (p < n && out + rs <= dend) {
    if (src[p] != '@') break;
    const int64_t id_span = (n - p - 1) < (idw + 1) ? (n - p - 1) : (idw + 1);
    if (id_span <= 0) break;
    const void* nl = std::memchr(src + p + 1, '\n', (size_t)id_span);
    if (!nl) break;
    const int64_t idl = (const uint8_t*)nl - (src + p);  // '@' + id text
    const int64_t s = p + idl + 1;
    if (s + L >= n || src[s + L] != '\n') break;
    const int64_t sep = s + L + 1;
    if (sep + 1 >= n || src[sep] != '+' || src[sep + 1] != '\n') break;
    const int64_t q = sep + 2;
    if (q + L >= n || src[q + L] != '\n') break;
    std::memcpy(out, src + p, (size_t)idl);
    std::memset(out + idl, ' ', (size_t)(idw + 1 - idl));
    out[idw + 1] = '\n';
    std::memcpy(out + idw + 2, src + s, (size_t)L);
    out[idw + 2 + L] = '\n';
    out[idw + 3 + L] = '+';
    out[idw + 4 + L] = '\n';
    std::memcpy(out + idw + 5 + L, src + q, (size_t)L);
    out[idw + 5 + 2 * L] = '\n';
    out += rs;
    p = q + L + 1;
    ++count;
  }
  *consumed = p;
  return count;
}

}  // extern "C"
