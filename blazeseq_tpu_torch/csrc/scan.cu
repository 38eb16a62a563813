// Structural-byte bitmaps for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/scan.py::structural_bitmaps
// (body _bitmap_kernel).
//
// Input: chunk u8[rows * 128] (contiguous; any address). Outputs, allocated
// by the caller: nl, at, plus u32[rows, 4] and counts i32[rows]. Bit b of
// word w of row r is set when byte r*128 + 32*w + b is '\n' (nl), '@' (at)
// or '+' (plus); counts[r] is the number of '\n' bytes in row r.
//
// Bound: device-memory bytes (it reads 128 bytes and writes 52 per row; a
// 256 MiB chunk moves 377.5 MB).
//
// Design: a thread per 32-byte span, which is one output word of each
// bitmap. It makes two 16-byte loads and tests the eight 32-bit pieces
// with an exact SWAR zero-byte test on piece ^ class, computed once per
// piece for the 7 low bits (the classic has-zero trick would flag the byte
// after a hit). Each piece's four hit bits (bit 7 of each byte) are
// gathered by a multiply-high into the 4 bits they own in the word, two
// pieces to a byte, and __byte_perm packs the four bytes: no vote. Lanes
// 4k..4k+3 hold one row's four words, so a warp stores 128 contiguous
// bytes of each bitmap; the row count is the __popc of the newline word
// summed over those four lanes with two __shfl_xor_sync, stored by the
// first of them. Each thread takes kSpans spans a step, all loads issued
// before any is used (128 bytes per thread in flight), in a grid-stride
// loop over a grid sized by the host to fill the card. A chunk whose
// address is not 16-byte aligned (a view such as chunk[5:]) takes the
// unaligned branch of the same kernel: each span is cut out of the three
// aligned 16-byte blocks that hold it with funnel shifts, one span a step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpans = 4;  // spans per thread and step on the aligned branch
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNl = 0x0a0a0a0au;
constexpr uint32_t kAt = 0x40404040u;
constexpr uint32_t kPlus = 0x2b2b2b2bu;

struct Out {
  uint32_t* nl;
  uint32_t* at;
  uint32_t* plus;
  int32_t* counts;
};

// bit 7 of each byte of x that equals the class byte (class < 0x80, x7 =
// x & 0x7f7f7f7f): the low 7 bits of byte ^ class plus 0x7f carry into bit
// 7 unless they are all 0, and never out of the byte
__device__ __forceinline__ uint32_t hits(uint32_t x, uint32_t x7,
                                         uint32_t cls) {
  return ~(((x7 ^ cls) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// the word of one class over eight pieces: bit 4p + k from bit 8k + 7 of
// h(piece p). __umulhi by 2^25 + 2^18 + 2^11 + 2^4 moves bit 8k + 7 to bit
// k of the high half (2^29 + ... + 2^8: to bit 4 + k); the other partial
// products land below bit 32 or at bit 8 and up, with no two on one bit,
// so nothing carries into the low byte
__device__ __forceinline__ uint32_t pack(const uint32_t (&x)[8],
                                         const uint32_t (&x7)[8],
                                         uint32_t cls) {
  uint32_t b[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    b[q] = __umulhi(hits(x[2 * q], x7[2 * q], cls), 0x02040810u) +
           __umulhi(hits(x[2 * q + 1], x7[2 * q + 1], cls), 0x20408100u);
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// the words of span s (its 32 bytes as eight pieces) and its row's count;
// every lane of the warp calls it (the shuffles), `live` marks real spans
__device__ __forceinline__ void emit(const uint32_t (&x)[8], long long s,
                                     bool live, const Out& o) {
  uint32_t x7[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) x7[p] = x[p] & 0x7f7f7f7fu;
  const uint32_t nl = pack(x, x7, kNl);
  const uint32_t at = pack(x, x7, kAt);
  const uint32_t plus = pack(x, x7, kPlus);
  int cnt = __popc(nl);
  cnt += __shfl_xor_sync(kFull, cnt, 1);
  cnt += __shfl_xor_sync(kFull, cnt, 2);
  if (live) {
    o.nl[s] = nl;
    o.at[s] = at;
    o.plus[s] = plus;
    if ((s & 3) == 0) o.counts[s >> 2] = cnt;
  }
}

__device__ __forceinline__ void aligned_branch(const uint4* __restrict__ c,
                                               long long spans, const Out& o) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads * kSpans;
  // warp-uniform loop: spans are whole rows of 4, warps start at multiples
  // of 32, so the four lanes of a row are live together
  for (long long w0 = (long long)blockIdx.x * kThreads * kSpans +
                      (threadIdx.x & ~31) * kSpans;
       w0 < spans; w0 += stride) {
    uint4 v[kSpans][2];
#pragma unroll
    for (int u = 0; u < kSpans; ++u) {
      const long long s = w0 + 32 * u + lane;
      if (s < spans) {
        v[u][0] = c[2 * s];
        v[u][1] = c[2 * s + 1];
      } else {
        v[u][0] = v[u][1] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kSpans; ++u) {
      const long long s = w0 + 32 * u + lane;
      const uint32_t x[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                             v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
      emit(x, s, s < spans, o);
    }
  }
}

// chunk = base + off with base 16-byte aligned and 0 < off < 16: span s is
// bytes off + 32s .. off + 32s + 31 of base, inside the aligned blocks
// 2s, 2s + 1 and 2s + 2 (each holds a byte of the chunk, so each lies
// within its allocation)
__device__ __forceinline__ void unaligned_branch(const uint4* __restrict__ base,
                                                 int off, long long spans,
                                                 const Out& o) {
  const int lane = threadIdx.x & 31;
  const int wq = off >> 2;            // whole words to skip
  const unsigned sh = 8 * (off & 3);  // then bits to shift
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long w0 = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
       w0 < spans; w0 += stride) {
    const long long s = w0 + lane;
    uint32_t v[12] = {};
    if (s < spans) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const uint4 t = base[2 * s + b];
        v[4 * b] = t.x;
        v[4 * b + 1] = t.y;
        v[4 * b + 2] = t.z;
        v[4 * b + 3] = t.w;
      }
    }
    uint32_t u[9];
#pragma unroll
    for (int i = 0; i < 9; ++i)
      u[i] = wq == 0 ? v[i] : wq == 1 ? v[i + 1] : wq == 2 ? v[i + 2] : v[i + 3];
    uint32_t x[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) x[p] = __funnelshift_r(u[p], u[p + 1], sh);
    emit(x, s, s < spans, o);
  }
}

__global__ void __launch_bounds__(kThreads)
    structural_bitmaps_kernel(const uint8_t* __restrict__ chunk,
                              long long spans, Out o) {
  const int off = (int)((uintptr_t)chunk & 15);
  if (off == 0) {
    aligned_branch(reinterpret_cast<const uint4*>(chunk), spans, o);
  } else {
    unaligned_branch(reinterpret_cast<const uint4*>(chunk - off), off, spans,
                     o);
  }
}

}  // namespace

// the grid: enough blocks for one step over every span, at most max_blocks
extern "C" int bs_structural_bitmaps(const uint8_t* chunk, void* nl, void* at,
                                     void* plus, int32_t* counts,
                                     long long rows, int max_blocks,
                                     void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const long long spans = rows * 4;
  const long long per_block =
      ((uintptr_t)chunk & 15) == 0 ? (long long)kThreads * kSpans : kThreads;
  long long blocks = (spans + per_block - 1) / per_block;
  if (blocks > max_blocks) blocks = max_blocks;
  const Out o{(uint32_t*)nl, (uint32_t*)at, (uint32_t*)plus, counts};
  structural_bitmaps_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(chunk, spans, o);
  return (int)cudaGetLastError();
}
