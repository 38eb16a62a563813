// Per-tile Phred sums and base counts of a padded batch for Hopper (sm_90a).
//
// Replaces the device half of blazeseq_tpu/ops/tiles.py::per_tile_qual_sums
// (l.59-95, with _tile_contract, l.50-56), XLA code with no Pallas kernel:
// two one-hot [n, T] x [n, L] contractions. Its plain torch version
// (ops/tiles.py::per_tile_qual_sums_torch) takes ~17 launches a call. Here
// one launch after one zero fill.
//
// Inputs: qual u8[n, L] (row-major, contiguous), lengths i32[n], and the
// host's order of the k rows of known tiles, int32 [2, k]: row indices,
// grouped by tile (ops/tiles.py::_tile_order), then each one's tile row in
// [0, T). Output: out int64 [2, T, L], zeroed by the caller:
// out[0, t, j] += min(phred, max_phred - 1) and out[1, t, j] += 1 for
// every listed row of tile t and column j < lengths, phred = byte >= offset
// ? byte - offset : 0. Integer sums: exact in any order.
//
// Bound: device-memory bytes (each listed row read once up to its length,
// the [2, T, L] sums written once); a few integer operations a byte.
//
// Design. A block takes 256 columns (grid y) of 4 x 16 x `chunks`
// consecutive rows of the order (grid x): 64 threads across, 4 bytes each,
// and 4 row lanes, each loading 16 rows at once (their indices and tiles,
// then their lengths and bytes). A thread sums its 4 columns in registers
// while the tile stays the same and adds them to out with one 64-bit atomic
// a column and leaf when it changes and at the end. The rows come grouped
// by tile, so a thread flushes about once: the atomics, not the bytes, set
// this kernel's time when rows come in file order with their tiles mixed
// (0.040 ms at 4,096 x 256 on an H100 with a tile drawn at random a read,
// a flush almost every row). `chunks` grows with the rows, up to 8, so
// that large batches take fewer flushes. Rows are read 4 bytes at a time
// where qual is 4-byte aligned and L % 4 == 0, else a byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;     // columns a thread
constexpr int kAcross = 64;  // threads across a block's columns
constexpr int kLanes = 4;    // row lanes a block
constexpr int kChunk = 16;   // rows a lane loads at once
constexpr int kMaxChunks = 8;

struct Args {
  const uint8_t* qual;
  const int32_t* lengths;
  const int32_t* rows;   // [k] row indices, grouped by tile
  const int32_t* tiles;  // [k] their tile rows
  unsigned long long* out;  // [2, T, L]
  int k;
  int L;
  int T;
  int offset;
  int max_phred;
  int chunks;  // of kChunk rows a lane
};

// Add tile t's sums and counts to out (nothing for no tile, -1).
__device__ __forceinline__ void flush(const Args& a, int t, int c0,
                                      const int (&s)[kCols],
                                      const int (&k)[kCols]) {
  if (t < 0) return;
  unsigned long long* sums = a.out + (long long)t * a.L + c0;
  const long long plane = (long long)a.T * a.L;
#pragma unroll
  for (int b = 0; b < kCols; ++b) {
    if (c0 + b >= a.L) break;
    if (s[b]) atomicAdd(sums + b, (unsigned long long)s[b]);
    if (k[b]) atomicAdd(sums + plane + b, (unsigned long long)k[b]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kAcross * kLanes)
    tiles_kernel(const Args a) {
  const int c0 = (blockIdx.y * kAcross + threadIdx.x) * kCols;
  if (c0 >= a.L) return;
  const int span = kChunk * a.chunks;
  const long long p0 = ((long long)blockIdx.x * kLanes + threadIdx.y) * span;
  int s[kCols] = {0}, k[kCols] = {0};
  int cur = -1;
  for (long long p = p0; p < p0 + span && p < a.k; p += kChunk) {
    // a chunk's rows at once: their indices and tiles, then their lengths
    // and bytes (on the 16-byte path whatever the length)
    int row[kChunk], t[kChunk], m[kChunk];
    uint32_t w[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool live = p + i < a.k;
      row[i] = live ? __ldg(a.rows + p + i) : 0;
      t[i] = live ? __ldg(a.tiles + p + i) : -1;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      m[i] = t[i] >= 0 ? min(__ldg(a.lengths + row[i]), a.L) - c0 : 0;
      const uint8_t* q = a.qual + (long long)row[i] * a.L + c0;
      w[i] = 0;
      if (VEC) {
        if (t[i] >= 0) w[i] = __ldg(reinterpret_cast<const uint32_t*>(q));
      } else {
#pragma unroll
        for (int b = 0; b < kCols; ++b)
          if (b < m[i]) w[i] |= (uint32_t)__ldg(q + b) << (8 * b);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (t[i] != cur) {
        flush(a, cur, c0, s, k);
#pragma unroll
        for (int b = 0; b < kCols; ++b) s[b] = k[b] = 0;
        cur = t[i];
      }
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        if (b < m[i]) {
          const int v = (int)((w[i] >> (8 * b)) & 0xffu);
          const int ph = v >= a.offset ? v - a.offset : 0;
          s[b] += min(ph, a.max_phred - 1);
          k[b] += 1;
        }
      }
    }
  }
  flush(a, cur, c0, s, k);
}

}  // namespace

// order: int32 [2, k] (row indices grouped by tile, their tile rows in
// [0, T)); out: int64 [2, T, L], zeroed. k < 2^31 (k == 0 launches
// nothing), 1 <= L < 2^24.
extern "C" int bs_tile_sums(const uint8_t* qual, const int32_t* lengths,
                            const int32_t* order, long long* out, long long k,
                            int L, int T, int offset, int max_phred,
                            int sm_count, void* stream) {
  if (k < 0 || k >= (1LL << 31) || L < 1 || L >= (1 << 24) || T < 1 ||
      max_phred < 1 || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  if (k == 0) return (int)cudaSuccess;
  const int across = (L + kAcross * kCols - 1) / (kAcross * kCols);
  const long long rows = (long long)kLanes * kChunk;
  // about four blocks an SM with one chunk a lane, more chunks (fewer
  // flushes) once the rows would fill more
  const long long blocks1 = (k + rows - 1) / rows * across;
  int chunks = (int)(blocks1 / (4LL * sm_count));
  chunks = chunks < 1 ? 1 : chunks > kMaxChunks ? kMaxChunks : chunks;
  const Args a{qual, lengths, order, order + k,
               reinterpret_cast<unsigned long long*>(out), (int)k, L, T,
               offset, max_phred, chunks};
  const dim3 block(kAcross, kLanes);
  const dim3 grid((unsigned)((k + rows * chunks - 1) / (rows * chunks)),
                  (unsigned)across);
  cudaStream_t s = (cudaStream_t)stream;
  if (L % 4 == 0 && ((uintptr_t)qual & 3) == 0)
    tiles_kernel<true><<<grid, block, 0, s>>>(a);
  else
    tiles_kernel<false><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
