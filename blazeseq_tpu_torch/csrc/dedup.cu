// Read-duplication hashes of a padded batch for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/dedup.py::read_hashes, which is XLA code with
// no Pallas kernel: one launch, where the plain torch version
// (ops/dedup.py::read_hashes_torch) emulates uint32 in int64 and builds two
// int64 [n, L] products.
//
// Inputs: seq u8[n, L] (row-major, contiguous), lengths i32[n]. Output
// int64[n, 2]: for a row r < n_valid = min(n, n_records), with m =
// clip(lengths[r], 0, L),
//   h = sum_{j < m} seq[r, j] * base^j + (uint32)lengths[r] * salt
// mod 2^32, for (base, salt) = (1000003, 2654435761) and (0x01000193,
// 0x9E3779B1); a padding row gets 0xFFFFFFFF in both. Each value is a
// uint32 held in int64. uint32 arithmetic on the card wraps mod 2^32, so
// these are the reference's bits directly; the sum is exact in any order.
//
// Bound: device-memory bytes (each row read once up to its length, 16
// bytes written a row); two multiply-adds a byte.
//
// Design. A warp takes one row at a time; lane l sums the columns l, l +
// 32, ... against its own powers, base^l at the start (by squaring, once a
// thread) and times base^32 a step, so no table is read; two wrapping
// warp sums (__shfl_xor_sync) combine the lanes and lane 0 adds the
// length term and writes the row's 16 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kBaseA = 1000003u;
constexpr uint32_t kBaseB = 0x01000193u;
constexpr uint32_t kSaltA = 2654435761u;
constexpr uint32_t kSaltB = 0x9E3779B1u;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t pow_u32(uint32_t b, unsigned e) {
  uint32_t r = 1;
  for (; e; e >>= 1, b *= b)
    if (e & 1) r *= b;
  return r;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    read_hashes_kernel(const uint8_t* __restrict__ seq,
                       const int32_t* __restrict__ lengths,
                       long long* __restrict__ out, long long n,
                       long long n_valid, int L) {
  const int lane = threadIdx.x & 31;
  const uint32_t pa0 = pow_u32(kBaseA, lane), pb0 = pow_u32(kBaseB, lane);
  const uint32_t sa = pow_u32(kBaseA, 32), sb = pow_u32(kBaseB, 32);
  const long long wstride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < n; r += wstride) {  // warp-uniform
    if (r >= n_valid) {
      if (lane < 2) out[2 * r + lane] = kSentinel;
      continue;
    }
    const int len = lengths[r];
    const int m = min(max(len, 0), L);
    const uint8_t* row = seq + r * (long long)L;
    uint32_t ha = 0, hb = 0, pa = pa0, pb = pb0;
    for (int j = lane; j < m; j += 32) {
      const uint32_t x = row[j];
      ha += x * pa;
      hb += x * pb;
      pa *= sa;
      pb *= sb;
    }
    ha = warp_sum(ha);
    hb = warp_sum(hb);
    if (lane == 0) {
      out[2 * r] = ha + (uint32_t)len * kSaltA;
      out[2 * r + 1] = hb + (uint32_t)len * kSaltB;
    }
  }
}

}  // namespace

// out: int64[n, 2] (any contents; every element is written).
extern "C" int bs_read_hashes(const uint8_t* seq, const int32_t* lengths,
                              long long* out, long long n, long long n_valid,
                              int L, int sm_count, void* stream) {
  if (n < 0 || L < 0 || n_valid < 0 || n_valid > n)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 8LL * sm_count) blocks = 8LL * sm_count;
  read_hashes_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(seq, lengths, out, n, n_valid,
                                               L);
  return (int)cudaGetLastError();
}
