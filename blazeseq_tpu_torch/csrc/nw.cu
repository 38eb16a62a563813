// Batched global Needleman-Wunsch scores for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/nw.py::nw_scores_pallas (body
// _nw_kernel): for each row b, the global alignment score of
// seq[b, :lengths[b]] against the whole of ref, +1 match / -1 mismatch /
// -1 gap per base, dp[0][j] = -j, dp[i][0] = -i, score = dp[len][Lr].
//
// Inputs: seq u8[B, Lq] (row-major, contiguous), lengths i32[B], ref u8[Lr]
// (Lr >= 1). Output: scores i32[B]. Lengths outside [0, Lq] give what the
// reference wavefront gives them: NEG for len > Lq; for len < 0, 0 when
// len + Lr >= 1 and NEG otherwise. len = 0 scores -Lr.
//
// Why any exact DP is right: a cell depends only on cells with a smaller
// or equal i and j, so the padded columns past a read's length never reach
// its score, and the TPU kernel's diagonal-by-diagonal order need not be
// kept.
//
// The recurrence is run on D[i][j] = dp[i][j] + i + j, which turns it into
// D = max(D[i-1][j-1] + (match ? 3 : 1), D[i-1][j], D[i][j-1]) with every
// boundary cell 0: four integer operations per cell (a compare, a select,
// one Hopper DPX add-max __viaddmax_s32 for the diagonal and the cell
// above, one max with the cell to the left), and only the last max lies on
// the chain through a row. The score is D[len][Lr] - len - Lr.
//
// Bound: integer operations, on a serial chain through each row. Design: a
// group of G lanes per read (G = 2, 4, 16 or 32, picked from Lr by the
// host). The reference is cut into tiles of G * W columns; lane l holds W
// columns of the tile as a strip in registers (the previous row h[] and
// the reference bytes r[]), fully unrolled. Rows pass from lane to lane as
// an anti-diagonal wavefront: at step t lane l works on row t - l + 1, and
// the left boundary of its strip, D[i][first column - 1], is what lane
// l - 1 produced at step t - 1, passed by one __shfl_up_sync. A read's
// serial chain falls from len * Lr cells to about (len + G) * W. Lane 0 of
// the first tile has the zero boundary; on a later tile (references longer
// than 32 * 32 columns) it reads the previous tile's last column, which
// lane G - 1 kept in shared memory (in place: lane G - 1 writes row i
// G - 1 steps after lane 0 read it). The block's reads are staged into
// shared memory first, with 16-byte loads over one contiguous span where
// the rows allow it. With G < 32 a warp holds 32 / G reads and steps to
// the longest of them; with G = 32 a read pays only for its own length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block unless a row is too wide
constexpr int kMaxW = 32;      // widest strip: tiles of 32 * 32 columns
constexpr int kNeg = -500000000;  // NEG = -(10**9) // 2 of the reference
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int add_max(int a, int b, int c) {
  // max(a + b, c)
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32(a, b, c);
#else
  return max(a + b, c);
#endif
}

// The lanes per read G and the strip width W for a reference of Lr bytes:
// few lanes with wide strips (long strips keep a lane's cells off the
// shuffle and the row bookkeeping), but enough lanes to spread a QC batch
// of 150 bp reads across the card. W is rounded up to an even count above
// 4 to bound the template instances; beyond 32 x 32 columns the reference
// is walked in tiles.
void nw_shape(int Lr, int* G, int* W) {
  const int g = Lr <= 40 ? 2 : Lr <= 80 ? 4 : Lr <= 160 ? 16 : 32;
  int w = (Lr + g - 1) / g;
  if (w > 4) w += w & 1;
  *G = g;
  *W = w > kMaxW ? kMaxW : w;
}

// shared memory of a block of R reads: the query rows [R * Lq] rounded up
// to 16 bytes, then, when Lr spans more than one tile, a boundary column
// [R][Lq + 1]
long long smem_bytes(long long R, int G, int W, long long Lq, int Lr) {
  long long bytes = (R * Lq + 15) / 16 * 16;
  if (Lr > G * W) bytes += R * (Lq + 1) * (long long)sizeof(int32_t);
  return bytes;
}

template <int G, int W>
__global__ void __launch_bounds__(kThreads)
nw_wave_kernel(const uint8_t* __restrict__ seq,
               const int32_t* __restrict__ lengths,
               const uint8_t* __restrict__ ref, int32_t* __restrict__ scores,
               long long B, int Lq, int Lr) {
  constexpr int kTile = G * W;  // reference columns per tile
  const int R = blockDim.x / G;  // reads per block
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_q = smem;
  int32_t* s_col = reinterpret_cast<int32_t*>(
      smem + ((long long)R * Lq + 15) / 16 * 16);

  // stage the block's rows: one contiguous span of rows * Lq bytes
  const long long b0 = (long long)blockIdx.x * R;
  const long long rows = B - b0 < R ? B - b0 : R;
  const uint8_t* src = seq + b0 * Lq;
  const long long span = rows * Lq;
  if ((Lq & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(s_q);
    for (long long k = threadIdx.x; k < span / 16; k += blockDim.x)
      d16[k] = __ldg(s16 + k);
  } else {
    for (long long k = threadIdx.x; k < span; k += blockDim.x)
      s_q[k] = __ldg(src + k);
  }
  __syncthreads();

  const int g = threadIdx.x / G;  // read within the block
  const int l = threadIdx.x % G;  // lane within the read's group
  const long long b = b0 + g;
  int len = 0;  // rows this group computes; 0 for an edge case
  int fixed = 0;
  bool has_fixed = false;
  if (b < B) {
    const int L = lengths[b];
    if (L < 0 || L > Lq) {
      fixed = (L < 0 && L + Lr >= 1) ? 0 : kNeg;
      has_fixed = true;
    } else if (L == 0) {
      fixed = -Lr;
      has_fixed = true;
    } else {
      len = L;
    }
  }
  if (has_fixed && l == 0) scores[b] = fixed;
  // every lane of the warp steps together: the shuffles name them all
  const int warp_len = __reduce_max_sync(kFull, len);
  if (warp_len == 0) return;
  const int steps = warp_len + G - 1;
  const uint8_t* q = s_q + (long long)g * Lq;
  int32_t* col = s_col + (long long)g * (Lq + 1);

  for (int j0 = 1; j0 <= Lr; j0 += kTile) {
    const bool first = j0 == 1;
    const bool last = j0 + kTile > Lr;
    const int jl = j0 + l * W;  // this lane's first column
    int r[W];
    int h[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      // a column past Lr holds -1, which no byte matches
      r[k] = (jl + k <= Lr) ? (int)__ldg(ref + jl + k - 1) : -1;
      h[k] = 0;  // row 0
    }
    int diag_in = 0;  // D[0][jl - 1]
    int out = 0;      // D[i][jl + W - 1] of the last row done
    for (int t = 0; t < steps; ++t) {
      const int recv = __shfl_up_sync(kFull, out, 1, G);
      const int i = t - l + 1;
      if (i >= 1 && i <= len) {
        const int left_in = l != 0 ? recv : (first ? 0 : col[i]);
        const int qc = q[i - 1];
        int diag = diag_in;
        int left = left_in;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int up = h[k];
          const int v = max(add_max(diag, qc == r[k] ? 3 : 1, up), left);
          diag = up;
          h[k] = v;
          left = v;
        }
        out = left;
        diag_in = left_in;  // D[i][jl - 1], the next row's diagonal
        if (!last && l == G - 1) col[i] = left;
      }
    }
    __syncwarp();
    if (last && len > 0) {
      // h[] holds row len: the lane owning column Lr writes the score
      const int kk = Lr - jl;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k == kk) scores[b] = h[k] - len - Lr;
      }
    }
  }
}

// Reads per block: kThreads / G, fewer when their rows would not fit in
// the card's shared memory, but always whole warps (a multiple of 32 / G).
long long reads_per_block(int G, int W, long long Lq, int Lr,
                          long long max_smem) {
  const long long r_min = G >= 32 ? 1 : 32 / G;
  long long R = kThreads / G;
  while (R > r_min && smem_bytes(R, G, W, Lq, Lr) > max_smem) R -= r_min;
  return R;
}

template <int G, int W>
int launch(const uint8_t* seq, const int32_t* lengths, const uint8_t* ref,
           int32_t* scores, long long B, int Lq, int Lr,
           cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const long long R = reads_per_block(G, W, Lq, Lr, max_smem);
  const size_t smem = (size_t)smem_bytes(R, G, W, Lq, Lr);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nw_wave_kernel<G, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (B + R - 1) / R;
  nw_wave_kernel<G, W><<<(unsigned)blocks, (unsigned)(R * G), smem, stream>>>(
      seq, lengths, ref, scores, B, Lq, Lr);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the smallest block for this shape needs (capped at
// INT32_MAX); the wrapper refuses shapes above the card's per-block limit.
extern "C" int bs_nw_smem_bytes(int Lq, int Lr) {
  int G, W;
  nw_shape(Lr, &G, &W);
  const long long r_min = G >= 32 ? 1 : 32 / G;
  const long long bytes = smem_bytes(r_min, G, W, Lq, Lr);
  return bytes > 0x7fffffff ? 0x7fffffff : (int)bytes;
}

extern "C" int bs_nw_scores(const uint8_t* seq, const int32_t* lengths,
                            const uint8_t* ref, int32_t* scores, long long B,
                            int Lq, int Lr, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  int G, W;
  nw_shape(Lr, &G, &W);
  cudaStream_t s = (cudaStream_t)stream;
#define BS_NW_CASE(g, w)                                                \
  if (G == g && W == w)                                                 \
    return launch<g, w>(seq, lengths, ref, scores, B, Lq, Lr, s);
  BS_NW_CASE(2, 1) BS_NW_CASE(2, 2) BS_NW_CASE(2, 3) BS_NW_CASE(2, 4)
  BS_NW_CASE(2, 6) BS_NW_CASE(2, 8) BS_NW_CASE(2, 10) BS_NW_CASE(2, 12)
  BS_NW_CASE(2, 14) BS_NW_CASE(2, 16) BS_NW_CASE(2, 18) BS_NW_CASE(2, 20)
  BS_NW_CASE(4, 12) BS_NW_CASE(4, 14) BS_NW_CASE(4, 16) BS_NW_CASE(4, 18)
  BS_NW_CASE(4, 20)
  BS_NW_CASE(16, 6) BS_NW_CASE(16, 8) BS_NW_CASE(16, 10)
  BS_NW_CASE(32, 6) BS_NW_CASE(32, 8) BS_NW_CASE(32, 10) BS_NW_CASE(32, 12)
  BS_NW_CASE(32, 14) BS_NW_CASE(32, 16) BS_NW_CASE(32, 18) BS_NW_CASE(32, 20)
  BS_NW_CASE(32, 22) BS_NW_CASE(32, 24) BS_NW_CASE(32, 26) BS_NW_CASE(32, 28)
  BS_NW_CASE(32, 30) BS_NW_CASE(32, 32)
#undef BS_NW_CASE
  return (int)cudaErrorInvalidValue;
}
