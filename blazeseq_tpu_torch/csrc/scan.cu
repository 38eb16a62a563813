// Structural-byte bitmaps for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/scan.py::structural_bitmaps
// (body _bitmap_kernel).
//
// Input: chunk u8[rows * 128] (contiguous). Outputs, allocated by the
// caller: nl, at, plus u32[rows, 4] and counts i32[rows]. Bit b of word w of
// row r is set when byte r*128 + 32*w + b is '\n' (nl), '@' (at) or '+'
// (plus); counts[r] is the number of '\n' bytes in row r.
//
// Bound: device-memory bytes (reads 128 bytes and writes 52 per row, a
// compare and a vote per byte). Design: one warp per 128-byte row, in a
// grid-stride loop over rows with 64-bit indices (a 256 MiB chunk has 2^21
// rows). For word w, lane l loads byte 32*w + l, so each load is one
// coalesced 32-byte segment, and __ballot_sync returns exactly the packed
// word the reference builds from 2^(l % 32) weights: bit l comes from lane
// l. __popc of the newline words is the row count. Lane 0 stores the three
// rows of four words as 16-byte vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void structural_bitmaps_kernel(const uint8_t* __restrict__ chunk,
                                          uint4* __restrict__ nl,
                                          uint4* __restrict__ at,
                                          uint4* __restrict__ plus,
                                          int32_t* __restrict__ counts,
                                          long long rows) {
  const int lane = threadIdx.x & 31;
  const long long wstride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock +
                     (threadIdx.x >> 5);
       r < rows; r += wstride) {
    const uint8_t* row = chunk + r * 128;
    unsigned w_nl[4], w_at[4], w_plus[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint8_t c = row[32 * w + lane];
      w_nl[w] = __ballot_sync(kFull, c == '\n');
      w_at[w] = __ballot_sync(kFull, c == '@');
      w_plus[w] = __ballot_sync(kFull, c == '+');
    }
    if (lane == 0) {
      nl[r] = make_uint4(w_nl[0], w_nl[1], w_nl[2], w_nl[3]);
      at[r] = make_uint4(w_at[0], w_at[1], w_at[2], w_at[3]);
      plus[r] = make_uint4(w_plus[0], w_plus[1], w_plus[2], w_plus[3]);
      counts[r] = __popc(w_nl[0]) + __popc(w_nl[1]) + __popc(w_nl[2]) +
                  __popc(w_nl[3]);
    }
  }
}

}  // namespace

extern "C" int bs_structural_bitmaps(const uint8_t* chunk, void* nl, void* at,
                                     void* plus, int32_t* counts,
                                     long long rows, int max_blocks,
                                     void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > max_blocks) blocks = max_blocks;
  structural_bitmaps_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
      chunk, (uint4*)nl, (uint4*)at, (uint4*)plus, counts, rows);
  return (int)cudaGetLastError();
}
