// k-mer spectrum of a padded batch for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/kmer.py::kmer_counts (l.30-63), XLA code with
// no Pallas kernel (rolling codes, then a sort and a searchsorted); its
// plain torch version (ops/kmer.py::kmer_counts_torch) takes ~52 launches
// and [n, L] int32 intermediates a call. Here one launch after one zero
// fill of the output.
//
// Inputs: seq u8[n, L] (row-major, contiguous), lengths i32[n], the row
// count n_valid (a host value, or an int32 / int64 scalar on the card).
// Output: out int32 [4^k], zeroed by the caller, 1 <= k <= 8. A window
// [j, j + k) of row r counts in bin Sum_t code(seq[r, j + t]) 4^(k-1-t)
// when r < n_valid, j + k <= min(lengths[r], L), and each of its bytes is
// one of ACGTacgt (code: A 0, C 1, G 2, T 3).
//
// Bound: device-memory bytes (each row read once up to its length, the bins
// written once); ~10 integer operations a window.
//
// Design. A thread takes 16 window starts of a row, reading its 16 bytes and
// the next k - 1 (the halo, in the next piece) in 16-byte loads, with a
// rolling code and a run of valid bases: a window counts when the run
// reaches k, with one atomic add. A warp's lanes take consecutive pieces.
// For k <= 7 the
// bins (at most 64 KiB) live in shared memory a block, zeroed at the start
// and added to out with one atomic a nonzero bin at the end, the blocks
// persistent (a grid-stride loop over the pieces) so that each flushes
// once. For k = 8 (256 KiB of bins) the windows add to out directly. Byte
// path (L % 16 != 0, or seq off 16-byte alignment): bytes one at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMaxK = 7;
constexpr int kMaxDevices = 64;

struct Args {
  const uint8_t* seq;
  const int32_t* lengths;
  const void* n_valid_ptr;  // null: n_valid below
  int n_valid_bytes;        // 4 or 8
  long long n_valid;
  int* out;
  long long n;
  int L;
  int k;
  int segs;  // 16-column pieces a row
};

// 2-bit code of an upper-cased base, 4 for any other byte
__device__ __forceinline__ int base_code(int b) {
  const int u = b & 0xDF;
  return u == 'A' ? 0 : u == 'C' ? 1 : u == 'G' ? 2 : u == 'T' ? 3 : 4;
}

template <bool VEC>
__device__ __forceinline__ void load_piece(const uint8_t* row, int c, int lim,
                                           uint32_t (&w)[4]) {
  if (VEC) {
    const uint4 v = c < lim ? __ldg(reinterpret_cast<const uint4*>(row + c))
                            : make_uint4(0, 0, 0, 0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (c + i < lim)
        w[i >> 2] |= (uint32_t)__ldg(row + c + i) << (8 * (i & 3));
  }
}

template <bool SHARED, bool VEC>
__global__ void __launch_bounds__(kThreads) kmer_kernel(const Args a) {
  extern __shared__ int bins[];
  const int n_bins = 1 << (2 * a.k);
  if (SHARED) {
    for (int i = threadIdx.x; i < n_bins; i += kThreads) bins[i] = 0;
    __syncthreads();
  }
  int* hist = SHARED ? bins : a.out;
  long long n_valid = a.n_valid;
  if (a.n_valid_ptr)
    n_valid = a.n_valid_bytes == 8
                  ? *static_cast<const long long*>(a.n_valid_ptr)
                  : *static_cast<const int*>(a.n_valid_ptr);
  const long long rows = min(n_valid, a.n);
  const long long items = rows > 0 ? rows * a.segs : 0;
  const unsigned mask = n_bins - 1;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
       item < items; item += stride) {
    const long long r = item / a.segs;
    const int base = 16 * (int)(item - r * a.segs);
    const uint8_t* row = a.seq + r * a.L;
    // bytes this thread reads
    const int lim = min(base + 15 + a.k, min(max(__ldg(a.lengths + r), 0),
                                             a.L));
    uint32_t lo[4], hi[4] = {0, 0, 0, 0};
    load_piece<VEC>(row, base, lim, lo);
    if (lim > base + 16) load_piece<VEC>(row, base + 16, lim, hi);
    unsigned code = 0;
    int run = 0;
    // positions base .. base + 14 + k; a window ends at each with run >= k
    // (unrolled to k = 8's 23, so that the pieces stay in registers)
#pragma unroll
    for (int i = 0; i < 23; ++i) {
      if (i >= 15 + a.k) break;
      const uint32_t x = (i & 16) ? hi[(i >> 2) & 3] : lo[(i >> 2) & 3];
      const int c = base_code((int)((x >> (8 * (i & 3))) & 0xffu));
      const bool in = base + i < lim && c < 4;
      code = ((code << 2) | (unsigned)(c & 3)) & mask;
      run = in ? run + 1 : 0;
      if (run >= a.k) atomicAdd(hist + code, 1);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_bins; i += kThreads)
      if (bins[i]) atomicAdd(a.out + i, bins[i]);
  }
}

// Blocks of the instantiation an SM holds with `smem` bytes of bins (those
// of k), with its opt-in to more than 48 KB made once a device.
template <bool SHARED, bool VEC>
cudaError_t blocks_per_sm(int k, int smem, int* per_sm) {
  static std::atomic<int> known[kMaxDevices][kSharedMaxK + 1];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int slot = SHARED ? k : 0;
  if (dev < kMaxDevices && (*per_sm = known[dev][slot].load()) > 0)
    return cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kmer_kernel<SHARED, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kmer_kernel<SHARED, VEC>, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) *per_sm = 1;
  if (dev < kMaxDevices) known[dev][slot].store(*per_sm);
  return cudaSuccess;
}

template <bool SHARED, bool VEC>
cudaError_t launch(const Args& a, int sm_count, cudaStream_t s) {
  const int smem = SHARED ? (int)sizeof(int) << (2 * a.k) : 0;
  int per_sm = 0;
  const cudaError_t e = blocks_per_sm<SHARED, VEC>(a.k, smem, &per_sm);
  if (e != cudaSuccess) return e;
  // persistent: at most the blocks the card holds at once (a known row
  // count caps them further; a count on the card is read by the kernel)
  const long long rows =
      a.n_valid_ptr || a.n_valid > a.n ? a.n : a.n_valid;
  const long long items = rows > 0 ? rows * a.segs : 1;
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long wave = (long long)per_sm * sm_count;
  if (blocks > wave) blocks = wave;
  kmer_kernel<SHARED, VEC><<<(unsigned)blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_v(const Args& a, int sm_count, cudaStream_t s) {
  return a.k <= kSharedMaxK ? launch<true, VEC>(a, sm_count, s)
                            : launch<false, VEC>(a, sm_count, s);
}

}  // namespace

// out: int32 [4^k], zeroed; 1 <= k <= 8. The row count is *n_valid_ptr
// (n_valid_bytes 4 or 8) when n_valid_ptr is not null, else n_valid.
// n < 2^40 rows; n == 0 launches nothing.
extern "C" int bs_kmer_counts(const uint8_t* seq, const int32_t* lengths,
                              const void* n_valid_ptr, int n_valid_bytes,
                              long long n_valid, int* out, long long n, int L,
                              int k, int sm_count, void* stream) {
  if (n < 0 || n >= (1LL << 40) || L < 0 || k < 1 || k > 8 ||
      sm_count < 1 ||
      (n_valid_ptr && n_valid_bytes != 4 && n_valid_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || L == 0) return (int)cudaSuccess;
  const Args a{seq, lengths, n_valid_ptr, n_valid_bytes, n_valid, out, n, L,
               k, (L + 15) / 16};
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = L % 16 == 0 && ((uintptr_t)seq & 15) == 0;
  return (int)(vec ? launch_v<true>(a, sm_count, s)
                   : launch_v<false>(a, sm_count, s));
}
