// Batched global Needleman-Wunsch scores for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/nw.py::nw_scores_pallas (body
// _nw_kernel): for each row b, the global alignment score of
// seq[b, :lengths[b]] against the whole of ref, +1 match / -1 mismatch /
// -1 gap per base, dp[0][j] = -j, dp[i][0] = -i, score = dp[len][Lr].
//
// Inputs: seq u8[B, Lq] (row-major, contiguous), lengths i32[B], ref u8[Lr]
// (Lr >= 1). Output: scores i32[B]. Scratch: i32[Lq + 1, B], untouched when
// Lr <= kTile. Lengths outside [0, Lq] give what the reference
// wavefront gives them: NEG for len > Lq; for len < 0, 0 when len + Lr >= 1
// and NEG otherwise.
//
// Why any exact DP is right: a cell depends only on cells with a smaller
// or equal i and j, so the padded columns past a read's length never reach
// its score, and the TPU kernel's diagonal-by-diagonal order need not be
// kept.
//
// Bound: integer operations on a serial dependency chain (about 5 per DP
// cell, one of them on the chain through the row). Design: one thread per
// read, so reads of different lengths cost only their own cells and no
// block synchronises. The reference is cut into tiles of kTile columns; a
// thread holds the previous row of the current tile (h[]) and the tile's
// reference bytes (r[]) in registers, both fully unrolled, and walks its
// read's rows. Between tiles the only state is the boundary column
// dp[i][j0 + kTile - 1], kept in the scratch column laid out [i][b] so that
// a warp's loads and stores at one row are coalesced: 8 bytes of traffic
// per kTile cells. Each cell is two Hopper DPX add-max instructions
// (__viaddmax_s32), max(diag + s, up - 1, left - 1). The row loop prefetches
// the next row's boundary value and query byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 128;
constexpr int kNeg = -500000000;  // NEG = -(10**9) // 2 of the reference

__device__ __forceinline__ int add_max(int a, int b, int c) {
  // max(a + b, c)
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32(a, b, c);
#else
  return max(a + b, c);
#endif
}

__global__ void __launch_bounds__(kThreads)
nw_scores_kernel(const uint8_t* __restrict__ seq,
                 const int32_t* __restrict__ lengths,
                 const uint8_t* __restrict__ ref, int32_t* __restrict__ scores,
                 int32_t* __restrict__ col, long long B, int Lq, int Lr) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int len = lengths[b];
  if (len < 0 || len > Lq) {
    scores[b] = (len < 0 && len + Lr >= 1) ? 0 : kNeg;
    return;
  }
  if (len == 0) {
    scores[b] = -Lr;
    return;
  }
  const uint8_t* q = seq + b * (long long)Lq;
  int score = kNeg;
  for (int j0 = 1; j0 <= Lr; j0 += kTile) {
    const bool first = j0 == 1;
    const bool last = j0 + kTile > Lr;
    // the tile's last real column, as an offset into it
    const int kend = (last ? Lr - j0 + 1 : kTile) - 1;
    int r[kTile];
    int h[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      r[k] = (j0 + k <= Lr) ? (int)__ldg(ref + j0 + k - 1) : -1;
      h[k] = -(j0 + k);  // row 0
    }
    int diag_in = -(j0 - 1);  // dp[0][j0 - 1]
    int left_next = first ? -1 : col[B + b];  // dp[1][j0 - 1]
    int qc_next = __ldg(q);
    for (int i = 1; i <= len; ++i) {
      const int left_in = left_next;
      const int qc = qc_next;
      if (i < len) {
        left_next = first ? -(i + 1) : col[(long long)(i + 1) * B + b];
        qc_next = __ldg(q + i);
      }
      int diag = diag_in;
      int left = left_in;
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const int up = h[k];
        const int a = add_max(up, -1, diag + (qc == r[k] ? 1 : -1));
        const int v = add_max(left, -1, a);
        diag = up;
        h[k] = v;
        left = v;
      }
      if (!last) col[(long long)i * B + b] = left;  // dp[i][j0 + kTile - 1]
      diag_in = left_in;  // dp[i][j0 - 1], the next row's diagonal
    }
    if (last) {
      // h[] now holds row len: the score is dp[len][Lr]
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        if (k == kend) score = h[k];
      }
    }
  }
  scores[b] = score;
}

}  // namespace

extern "C" int bs_nw_scores(const uint8_t* seq, const int32_t* lengths,
                            const uint8_t* ref, int32_t* scores, int32_t* col,
                            long long B, int Lq, int Lr, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const long long blocks = (B + kThreads - 1) / kThreads;
  nw_scores_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      seq, lengths, ref, scores, col, B, Lq, Lr);
  return (int)cudaGetLastError();
}
