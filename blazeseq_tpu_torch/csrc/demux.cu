// Barcode assignment of a padded batch for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/demux.py::_assign (l.38-54), XLA code with no
// Pallas kernel; its plain torch version (ops/demux.py::demux_assign_torch)
// builds an [n, K, bl] compare in ~19 launches. Here one launch.
//
// Inputs: seq u8[n, L] (row-major, contiguous; bl <= L), lengths i32[n],
// and the barcode set as int32 words [2, K, W] made once a set and device by
// the host (ops/demux.py::_barcode_words): W = ceil(bl / 4) words a barcode,
// its upper-cased bytes, then a mask word with 0xFF in each byte that is a
// barcode base other than 'N' (0 for 'N', the wildcard, and past bl).
// Outputs: assign i32[n], best i32[n]. For read r, with up = its first bl
// bytes & 0xDF, mm(k) = #{i < bl : up[i] != code_k[i] and code_k[i] != 'N'},
// or bl + 1 for every k when lengths[r] < bl; best = min_k mm(k); assign =
// the first k reaching best when it is the only one and best <= max_mm,
// else -1.
//
// Bound: device-memory bytes (each read's first bl bytes, 8 bytes written a
// read); K x W byte-SIMD compares a read, ~4 integer operations a word.
//
// Design. A thread takes a read. The barcode words go to shared memory once
// a block; every thread reads the same word at once (a broadcast). A read's
// W words are loaded once (4-byte loads where rows are 4-byte aligned and
// the word lies inside bl, bytes otherwise) and upper-cased; a barcode's
// mismatches are Sum over words of popc(__vcmpne4(read, code) & mask) / 8.
// The scan over k keeps the first minimum and how many reach it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;  // barcodes of up to 32 bases
// the words of a set in the shared memory a block has without an opt-in
constexpr int kMaxSetWords = 48 * 1024 / 8;

struct Args {
  const uint8_t* seq;
  const int32_t* lengths;
  const uint32_t* words;  // [2, K, W]
  int32_t* assign;
  int32_t* best;
  int n;
  int L;
  int K;
  int bl;
  int W;  // words a barcode, ceil(bl / 4)
  int max_mm;
};

// WMAX: a bound on the words a barcode (the read's words in registers)
template <int WMAX>
__global__ void __launch_bounds__(kThreads) demux_kernel(const Args a) {
  extern __shared__ uint32_t sh[];  // codes [K][W], then masks [K][W]
  const int W = a.W;
  for (int i = threadIdx.x; i < 2 * a.K * W; i += kThreads)
    sh[i] = __ldg(a.words + i);
  __syncthreads();
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  const uint8_t* row = a.seq + r * (long long)a.L;
  const bool words4 = ((uintptr_t)row & 3) == 0;
  uint32_t up[WMAX];
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    uint32_t x = 0;
    if (i < W && words4 && 4 * i + 4 <= a.bl) {
      x = __ldg(reinterpret_cast<const uint32_t*>(row) + i);
    } else if (i < W) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < a.bl)
          x |= (uint32_t)__ldg(row + 4 * i + b) << (8 * b);
    }
    up[i] = x & 0xDFDFDFDFu;
  }
  const bool short_read = __ldg(a.lengths + r) < a.bl;
  const uint32_t* codes = sh;
  const uint32_t* masks = sh + a.K * W;
  int best = 1 << 30, best_k = 0, ties = 0;
  for (int k = 0; k < a.K; ++k) {
    int bits = 0;
#pragma unroll
    for (int i = 0; i < WMAX; ++i)
      if (i < W)
        bits += __popc(__vcmpne4(up[i], codes[k * W + i]) & masks[k * W + i]);
    const int mm = short_read ? a.bl + 1 : bits >> 3;
    if (mm < best) {
      best = mm;
      best_k = k;
      ties = 1;
    } else if (mm == best) {
      ++ties;
    }
  }
  a.assign[r] = best <= a.max_mm && ties == 1 ? best_k : -1;
  a.best[r] = best;
}

template <int WMAX>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t smem = (size_t)2 * a.K * a.W * sizeof(uint32_t);
  const unsigned blocks = (unsigned)((a.n + kThreads - 1) / kThreads);
  demux_kernel<WMAX><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// words: int32 [2, K, ceil(bl / 4)] as above. n < 2^31 (n == 0 launches
// nothing), 1 <= bl <= min(L, 32), 1 <= K and K * ceil(bl / 4) <= 6,144
// (the set in 48 KB of shared memory: 768 barcodes of 32 bases).
extern "C" int bs_demux_assign(const uint8_t* seq, const int32_t* lengths,
                               const uint32_t* words, int32_t* assign,
                               int32_t* best, long long n, int L, int K,
                               int bl, int max_mm, void* stream) {
  if (n < 0 || n >= (1LL << 31) || K < 1 || bl < 1 || bl > L ||
      bl > 4 * kMaxWords || (long long)K * ((bl + 3) / 4) > kMaxSetWords)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int W = (bl + 3) / 4;
  const Args a{seq, lengths, words, assign, best, (int)n, L, K, bl, W, max_mm};
  cudaStream_t s = (cudaStream_t)stream;
  if (W <= 2) return (int)launch<2>(a, s);
  if (W <= 4) return (int)launch<4>(a, s);
  return (int)launch<kMaxWords>(a, s);
}
