// Padded-batch validate + Phred decode for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/validate.py::validate_decode_pallas
// (body _validate_kernel), with the col_offset argument of its XLA twin
// validate_decode_xla.
//
// Inputs: seq, qual u8[n, L] (row-major, contiguous), lengths i32[n] (any
// value: below 0 or past L). Outputs, allocated by the caller: codes i32[n],
// phred u8[n, L].
//   code 5: check_quality and an in-length quality byte outside [q_lo, q_hi]
//   code 4: check_ascii and an in-length (seq | qual) byte with bit 7 set;
//           4 overrides 5
//   phred[r, c] = (u8)(qual - offset) when c + col_offset < lengths[r]
//                 (wraps for qual < offset, as the reference's int32 -> u8
//                 cast does), 0 elsewhere.
//
// Bound: device-memory bytes. It reads 2 bytes and writes 1 per element
// and does a handful of integer operations on each, so at the path's
// [4096, 256] batch the 3 MiB take under a microsecond at full rate and the
// launch is most of the time; at [32768, 1024] it streams 100 MB.
//
// Design. Vector path (the host picks it when L % 16 == 0 and seq, qual
// and phred are 16-byte aligned): a thread takes 16 consecutive columns of
// a row, one uint4 of seq and one of qual, so each memory instruction of a
// warp moves 512 bytes. It works on four 32-bit words with byte-SIMD
// intrinsics under an in-length byte mask: __vcmpltu4 / __vcmpgtu4 for the
// range test, (s | q) & 0x80808080 for the high bit, __vsub4 for the
// wrapped decode; phred goes out as one uint4. seq is not read when
// check_ascii is off, and a piece wholly past a row's length reads
// nothing. A row gets a group of G lanes (G = min(32, next_pow2(L / 16)),
// chosen by the host), so a warp holds 32 / G rows and a row wider than
// 16 * G columns loops. The row verdict is a __ballot_sync cut to the
// group's bits, written by the group's first lane: no atomics, no second
// launch. Each thread walks its (row, piece) items kUnroll at a time, with
// every load issued before any is used, in a grid-stride loop: 64 bytes per
// thread in flight.
//
// Byte path (L % 16 != 0, L == 0, or a pointer off 16-byte alignment, such
// as seq[1:] with odd L): one warp per row, lanes on consecutive columns,
// one byte each, and the verdict is two warp votes. Both paths are
// branches of the one kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* seq;
  const uint8_t* qual;
  const int32_t* lengths;
  int32_t* codes;
  uint8_t* phred;
  long long n;
  int L;
  int col_offset;
  int q_lo;
  int q_hi;
  int offset;
  int check_ascii;
  int check_quality;
  int group;  // lanes per row on the vector path; 0 takes the byte path
};

__device__ __forceinline__ int32_t verdict(const Args& a, bool bad_a,
                                           bool bad_q) {
  return (a.check_ascii && bad_a) ? 4 : ((a.check_quality && bad_q) ? 5 : 0);
}

// mask of the first clamp(k, 0, 4) bytes of a little-endian word
__device__ __forceinline__ uint32_t first_bytes(long long k) {
  return k >= 4 ? kFull : (k <= 0 ? 0u : (1u << (8 * (int)k)) - 1u);
}

__device__ void byte_path(const Args& a) {
  const int lane = threadIdx.x & 31;
  const long long wstride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < a.n; r += wstride) {
    const long long base = r * a.L;
    const long long len = a.lengths[r];
    bool bad_q = false;
    bool bad_a = false;
    for (int c = lane; c < a.L; c += 32) {
      const int q = a.qual[base + c];
      const bool in_len = (long long)c + a.col_offset < len;
      if (in_len) {
        const int s = a.seq[base + c];
        bad_q |= (q < a.q_lo) | (q > a.q_hi);
        bad_a |= ((s | q) & 0x80) != 0;
      }
      a.phred[base + c] = in_len ? (uint8_t)(q - a.offset) : (uint8_t)0;
    }
    bad_q = __any_sync(kFull, bad_q);
    bad_a = __any_sync(kFull, bad_a);
    if (lane == 0) a.codes[r] = verdict(a, bad_a, bad_q);
  }
}

__device__ void vector_path(const Args& a) {
  const int G = a.group;
  const int gshift = __ffs(G) - 1;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);       // lane within its row's group
  const int rpw = 32 >> gshift;       // rows per warp
  const int nch = a.L >> 4;           // 16-byte pieces per row
  const int cpl = (nch + G - 1) >> gshift;  // pieces per lane per row
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * kWarps * rpw;  // rows
  const long long first = warp * rpw;
  if (first >= a.n) return;  // warp-uniform
  // the warp's row-group steps, and its (row, piece) items
  const long long items = (a.n - first + step - 1) / step * cpl;
  const unsigned gmask =
      G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
  // the range test as unsigned byte compares: a bound outside [0, 255]
  // either never fires or fires on every in-length byte
  const bool all_bad = a.q_lo > 255 || a.q_hi < 0;
  const uint32_t lo4 = 0x01010101u * (uint32_t)min(max(a.q_lo, 0), 255);
  const uint32_t hi4 = 0x01010101u * (uint32_t)min(max(a.q_hi, 0), 255);
  const uint32_t off4 = 0x01010101u * ((uint32_t)a.offset & 0xffu);
  uint32_t acc_a = 0, acc_q = 0;
  long long k = 0;  // row-group step of the next item
  int i = 0;        // piece step within the row of the next item
  for (long long m = 0; m < items; m += kUnroll) {
    long long row[kUnroll], inlen[kUnroll];
    int c[kUnroll];
    bool live[kUnroll], last[kUnroll];
    uint4 sv[kUnroll], qv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      live[u] = m + u < items;  // warp-uniform
      last[u] = i == cpl - 1;
      row[u] = first + k * step + (lane >> gshift);
      c[u] = j + i * G;
      const bool valid = live[u] && row[u] < a.n && c[u] < nch;
      inlen[u] = 0;
      sv[u] = qv[u] = make_uint4(0, 0, 0, 0);
      if (valid) {
        const long long len = a.lengths[row[u]];
        inlen[u] = len - a.col_offset - 16LL * c[u];
        const long long at = row[u] * a.L + 16LL * c[u];
        if (inlen[u] > 0) {
          qv[u] = *reinterpret_cast<const uint4*>(a.qual + at);
          if (a.check_ascii)
            sv[u] = *reinterpret_cast<const uint4*>(a.seq + at);
        }
      } else {
        c[u] = nch;  // nothing to store
      }
      if (++i == cpl) {
        i = 0;
        ++k;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c[u] < nch) {
        const uint32_t q[4] = {qv[u].x, qv[u].y, qv[u].z, qv[u].w};
        const uint32_t s[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
        uint32_t p[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t in = first_bytes(inlen[u] - 4 * w);
          p[w] = __vsub4(q[w], off4) & in;
          acc_a |= (s[w] | q[w]) & in;
          if (a.check_quality) {
            const uint32_t out = all_bad ? kFull
                                         : (__vcmpltu4(q[w], lo4) |
                                            __vcmpgtu4(q[w], hi4));
            acc_q |= out & in;
          }
        }
        *reinterpret_cast<uint4*>(a.phred + row[u] * a.L + 16LL * c[u]) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
      if (live[u] && last[u]) {
        const unsigned ba =
            __ballot_sync(kFull, (acc_a & 0x80808080u) != 0) & gmask;
        const unsigned bq = __ballot_sync(kFull, acc_q != 0) & gmask;
        if (j == 0 && row[u] < a.n) a.codes[row[u]] = verdict(a, ba, bq);
        acc_a = acc_q = 0;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    validate_decode_kernel(const Args a) {
  if (a.group) {
    vector_path(a);
  } else {
    byte_path(a);
  }
}

}  // namespace

// group: lanes per row (a power of two up to 32) for the vector path, which
// needs L % 16 == 0 and 16-byte aligned seq, qual and phred; 0 for the byte
// path. Returns cudaErrorInvalidValue for a group the shapes do not allow.
extern "C" int bs_validate_decode(const uint8_t* seq, const uint8_t* qual,
                                  const int32_t* lengths, int32_t* codes,
                                  uint8_t* phred, long long n, int L,
                                  int col_offset, int q_lo, int q_hi,
                                  int offset, int check_ascii,
                                  int check_quality, int group,
                                  int max_blocks, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool pow2 = group > 0 && group <= 32 && (group & (group - 1)) == 0;
  const bool aligned = ((uintptr_t)seq | (uintptr_t)qual |
                        (uintptr_t)phred) % 16 == 0;
  if (group != 0 && !(pow2 && L > 0 && L % 16 == 0 && aligned))
    return (int)cudaErrorInvalidValue;
  const Args a{seq,    qual,        lengths,       codes, phred,
               n,      L,           col_offset,    q_lo,  q_hi,
               offset, check_ascii, check_quality, group};
  const long long rows_per_block = group ? kWarps * (32 / group) : kWarps;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > max_blocks) blocks = max_blocks;
  validate_decode_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
