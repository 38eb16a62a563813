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
// [R][Lq + 1] of `carry` values a row (the variant kernel carries up to 3)
long long smem_bytes(long long R, int G, int W, long long Lq, int Lr,
                     int carry = 1) {
  long long bytes = (R * Lq + 15) / 16 * 16;
  if (Lr > G * W) bytes += R * (Lq + 1) * carry * (long long)sizeof(int32_t);
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
                          long long max_smem, int carry = 1) {
  const long long r_min = G >= 32 ? 1 : 32 / G;
  long long R = kThreads / G;
  while (R > r_min && smem_bytes(R, G, W, Lq, Lr, carry) > max_smem)
    R -= r_min;
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

// ---------------------------------------------------------------- variants
//
// The local, semi-global and affine-gap scores, which the reference writes
// as XLA code with no Pallas kernel (blazeseq_tpu/ops/nw.py:240-566:
// sw_scores_xla, nw_affine_scores_xla, sw_affine_scores_xla,
// nw_semiglobal_scores_xla, nw_semiglobal_affine_scores_xla). For each row
// b, the score of seq[b, :lengths[b]] against the whole ref, with runtime
// scores (match, mismatch, gap; gap_open, gap_extend: a length-k gap costs
// gap_open + (k-1) * gap_extend). The semantics are those of the port's
// plain versions (blazeseq_tpu_torch/ops/nw.py, *_torch), edge values
// included:
//
//   local (0)           dp = max(0, diag + s, up + gap, left + gap), edges
//                       0; the max over the read's cells, 0 when empty
//   semi-global (1)     the same without the floor, row 0 free (0), column
//                       0 i * gap; the max over j = 0..Lr of dp[len][j]
//   affine (2)          Gotoh: M = C[i-1][j-1] + s, X = max(M, X)[up] +
//                       (open, extend), Y = max(M, Y)[left] + (open,
//                       extend), C = max(M, X, Y); row 0 Y = the gap's cost,
//                       column 0 X = the gap's cost, the rest NEG;
//                       C[len][Lr]
//   local affine (3)    H = max(diag + s, E, max(F, 0)), E from the left, F
//                       from above, edges H = 0 and E = F = NEG; the max H
//   semi-global affine (4)  the affine recurrence with row 0 M = 0; the max
//                       over j = 0..Lr of C[len][j]
//
// Every cell is computed in the plain versions' arithmetic (int32, the
// same sums and maxima), so the scores are equal bit for bit; the plain
// versions' cells past a row's length or past Lr never reach a score. A
// length outside [0, Lq] gives what the plain versions give it: the local
// modes take min(len, Lq) rows (none below 0); the others score 0 or NEG
// by the same rules as their wavefronts (bs_nw_scores' header).
//
// Bound: integer operations (5-9 a cell, counted in chip_smoke.py), on a
// serial chain through each row. Design: nw_wave_kernel's. G lanes a read
// hold strips of W columns in registers (dp, or M / X / C, or H / F, and
// the reference bytes) and pass each row's last column to the next lane
// with __shfl_up_sync as an anti-diagonal wavefront: one value for the
// linear modes, H and E for the local affine mode, M, Y and C for the
// Gotoh modes. Between tiles of G * W columns the last lane keeps those
// values in shared memory. No D-transform: the scores are arbitrary, so
// the kernel works on dp itself. G is a runtime value and strips are at
// most 16 columns (more states a column than the global kernel), so a
// mode has ten instances. The local modes' running max is kept per column
// and folded once a tile, with the columns past Lr left out. On an NVIDIA
// H100 80GB HBM3 at 700 W the bound is 73-87% of the kernel's time on the
// card alone at 65,536 x 64 vs 40 bp, 61-74% at 4,096 x 256 vs 150 bp
// (PERF.md).

namespace {

enum VariantMode : int {
  kLocal = 0,
  kSemiGlobal = 1,
  kAffine = 2,
  kLocalAffine = 3,
  kSemiAffine = 4,
};

struct Scores {
  int match, mismatch, gap, go, ge;
};

constexpr int kVarMaxW = 16;

__device__ __forceinline__ int add_max_relu(int a, int b, int c) {
  // max(a + b, c, 0)
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32_relu(a, b, c);
#else
  return max(max(a + b, c), 0);
#endif
}

__device__ __forceinline__ int max3(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax3_s32(a, b, c);
#else
  return max(max(a, b), c);
#endif
}

__device__ __forceinline__ int max_relu(int a, int b) {
  // max(a, b, 0)
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vimax_s32_relu(a, b);
#else
  return max(max(a, b), 0);
#endif
}

__host__ __device__ constexpr int carry_of(int mode) {
  return mode == kAffine || mode == kSemiAffine ? 3
         : mode == kLocalAffine                  ? 2
                                                 : 1;
}

// G and W for a reference of Lr bytes: nw_shape's lanes, doubled while a
// strip would pass kVarMaxW columns; W even above 4.
void variant_shape(int Lr, int* G, int* W) {
  int g = Lr <= 40 ? 2 : Lr <= 80 ? 4 : Lr <= 160 ? 16 : 32;
  int w = (Lr + g - 1) / g;
  while (w > kVarMaxW && g < 32) {
    g *= 2;
    w = (Lr + g - 1) / g;
  }
  if (w > 4) w += w & 1;
  *G = g;
  *W = w > kVarMaxW ? kVarMaxW : w;
}

// Copy `rows` rows of Lq bytes from seq row b0 on into s_q: 16-byte loads
// where the span allows them.
__device__ __forceinline__ void stage_reads(const uint8_t* __restrict__ seq,
                                            uint8_t* s_q, long long b0,
                                            long long rows, int Lq) {
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
}

template <int MODE, int W>
__global__ void __launch_bounds__(kThreads)
nw_variant_kernel(const uint8_t* __restrict__ seq,
                  const int32_t* __restrict__ lengths,
                  const uint8_t* __restrict__ ref,
                  int32_t* __restrict__ scores, long long B, int Lq, int Lr,
                  int G, Scores sc) {
  constexpr bool kGotoh = MODE == kAffine || MODE == kSemiAffine;
  constexpr bool kLoc = MODE == kLocal || MODE == kLocalAffine;
  constexpr bool kSemi = MODE == kSemiGlobal || MODE == kSemiAffine;
  constexpr int kCarry = carry_of(MODE);
  const int tile = G * W;  // reference columns per tile
  const int R = blockDim.x / G;  // reads per block
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_q = smem;
  int32_t* s_col = reinterpret_cast<int32_t*>(
      smem + ((long long)R * Lq + 15) / 16 * 16);
  const long long b0 = (long long)blockIdx.x * R;
  stage_reads(seq, s_q, b0, B - b0 < R ? B - b0 : R, Lq);
  __syncthreads();

  const int g = threadIdx.x / G;  // read within the block
  const int l = threadIdx.x % G;  // lane within the read's group
  const long long b = b0 + g;
  int rows = 0;  // rows this group computes
  int fixed = 0;
  bool has_fixed = false;  // a score that needs no DP
  if (b < B) {
    const int L = lengths[b];
    if (kLoc) {
      rows = L < 0 ? 0 : L > Lq ? Lq : L;  // no rows: the score is 0
    } else if (L >= 1 && L <= Lq) {
      rows = L;
    } else {
      has_fixed = true;
      if (L == 0)
        fixed = kSemi ? 0 : max(kNeg, sc.go + (Lr - 1) * sc.ge);
      else if (L < 0)
        fixed = (long long)L + Lr >= 1 ? 0 : kNeg;
      else
        fixed = kSemi && (long long)L <= (long long)Lq + Lr ? 0 : kNeg;
    }
  }
  // the score of a local or semi-global read: a max over this lane's cells,
  // then over its group; the semi-global modes start from column 0
  int best = kLoc ? 0 : kNeg;
  if (kSemi && l == 0 && rows > 0)
    best = kGotoh ? max(kNeg, sc.go + (rows - 1) * sc.ge) : rows * sc.gap;
  const int warp_rows = __reduce_max_sync(kFull, rows);
  if (warp_rows > 0) {
    const int steps = warp_rows + G - 1;
    const uint8_t* q = s_q + (long long)g * Lq;
    int32_t* col = s_col + (long long)g * (Lq + 1) * kCarry;
    for (int j0 = 1; j0 <= Lr; j0 += tile) {
      const bool first = j0 == 1;
      const bool last = j0 + tile > Lr;
      const int jl = j0 + l * W;  // this lane's first column
      int r[W];
      int h[W];   // the previous row: dp, H, or M
      int x[W];   // F (local affine) or X (Gotoh)
      int c[W];   // C = max(M, X, Y) (Gotoh)
      int mx[W];  // the local modes' running max
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int j = jl + k;
        // a column past Lr holds -1, which no byte matches
        r[k] = j <= Lr ? (int)__ldg(ref + j - 1) : -1;
        // row 0
        h[k] = MODE == kAffine ? kNeg : 0;
        x[k] = kNeg;
        c[k] = MODE == kAffine ? max(kNeg, sc.go + (j - 1) * sc.ge) : 0;
        mx[k] = 0;
      }
      // C[0][jl - 1] (dp, H: 0), the first row's diagonal
      int diag_in = MODE == kAffine && jl > 1
                        ? max(kNeg, sc.go + (jl - 2) * sc.ge)
                        : 0;
      int o0 = 0, o1 = 0, o2 = 0;  // the last row's last column, carried
      for (int t = 0; t < steps; ++t) {
        const int v0 = __shfl_up_sync(kFull, o0, 1, G);
        const int v1 = kCarry > 1 ? __shfl_up_sync(kFull, o1, 1, G) : 0;
        const int v2 = kCarry > 2 ? __shfl_up_sync(kFull, o2, 1, G) : 0;
        const int i = t - l + 1;
        if (i >= 1 && i <= rows) {
          // the row's left boundary, column jl - 1
          int a0, a1 = 0, a2 = 0;
          if (l != 0) {
            a0 = v0;
            a1 = v1;
            a2 = v2;
          } else if (first) {  // column 0
            if (MODE == kLocal) {
              a0 = 0;
            } else if (MODE == kSemiGlobal) {
              a0 = i * sc.gap;
            } else if (MODE == kLocalAffine) {
              a0 = 0;
              a1 = kNeg;
            } else {
              a0 = kNeg;
              a1 = kNeg;
              a2 = max(kNeg, sc.go + (i - 1) * sc.ge);
            }
          } else {
            const int32_t* cell = col + (long long)i * kCarry;
            a0 = cell[0];
            if (kCarry > 1) a1 = cell[1];
            if (kCarry > 2) a2 = cell[2];
          }
          const int qc = q[i - 1];
          int dg = diag_in;
          if (MODE == kLocal || MODE == kSemiGlobal) {
            int left = a0;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const int s = qc == r[k] ? sc.match : sc.mismatch;
              const int up = h[k];
              const int u = add_max(dg, s, up + sc.gap);
              const int v = MODE == kLocal ? add_max_relu(left, sc.gap, u)
                                           : add_max(left, sc.gap, u);
              if (MODE == kLocal) mx[k] = max(mx[k], v);
              dg = up;
              h[k] = v;
              left = v;
            }
            o0 = left;
            diag_in = a0;
          } else if (MODE == kLocalAffine) {
            int lh = a0, le = a1;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const int s = qc == r[k] ? sc.match : sc.mismatch;
              const int e = add_max(lh, sc.go, le + sc.ge);
              const int f = add_max(h[k], sc.go, x[k] + sc.ge);
              const int v = max_relu(add_max(dg, s, e), f);
              mx[k] = max(mx[k], v);
              dg = h[k];
              h[k] = v;
              x[k] = f;
              lh = v;
              le = e;
            }
            o0 = lh;
            o1 = le;
            diag_in = a0;
          } else {
            int lm = a0, ly = a1, cc = a2;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const int s = qc == r[k] ? sc.match : sc.mismatch;
              const int m = dg + s;
              const int xx = add_max(h[k], sc.go, x[k] + sc.ge);
              const int y = add_max(lm, sc.go, ly + sc.ge);
              cc = max3(m, xx, y);
              dg = c[k];
              h[k] = m;
              x[k] = xx;
              c[k] = cc;
              lm = m;
              ly = y;
            }
            o0 = lm;
            o1 = ly;
            o2 = cc;
            diag_in = a2;
          }
          if (!last && l == G - 1) {
            int32_t* cell = col + (long long)i * kCarry;
            cell[0] = o0;
            if (kCarry > 1) cell[1] = o1;
            if (kCarry > 2) cell[2] = o2;
          }
        }
      }
      __syncwarp();
      // fold this tile's columns up to Lr: the local max of every row, or
      // the semi-global modes' row `rows`; the global affine score
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (jl + k > Lr) continue;
        if (kLoc) best = max(best, mx[k]);
        if (kSemi && rows > 0) best = max(best, kGotoh ? c[k] : h[k]);
        if (MODE == kAffine && rows > 0 && jl + k == Lr) scores[b] = c[k];
      }
    }
  }
  if (MODE != kAffine) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < G) best = max(best, __shfl_xor_sync(kFull, best, o, G));
    if (l == 0 && b < B) scores[b] = has_fixed ? fixed : best;
  } else if (l == 0 && has_fixed) {
    scores[b] = fixed;
  }
}

template <int MODE, int W>
int launch_variant(const uint8_t* seq, const int32_t* lengths,
                   const uint8_t* ref, int32_t* scores, long long B, int Lq,
                   int Lr, int G, Scores sc, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr int carry = carry_of(MODE);
  const long long R = reads_per_block(G, W, Lq, Lr, max_smem, carry);
  const size_t smem = (size_t)smem_bytes(R, G, W, Lq, Lr, carry);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nw_variant_kernel<MODE, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (B + R - 1) / R;
  nw_variant_kernel<MODE, W>
      <<<(unsigned)blocks, (unsigned)(R * G), smem, stream>>>(
          seq, lengths, ref, scores, B, Lq, Lr, G, sc);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(int W, const uint8_t* seq, const int32_t* lengths,
                const uint8_t* ref, int32_t* scores, long long B, int Lq,
                int Lr, int G, Scores sc, cudaStream_t s) {
#define BS_NW_VARIANT_CASE(w)                                             \
  if (W == w)                                                             \
    return launch_variant<MODE, w>(seq, lengths, ref, scores, B, Lq, Lr, G, \
                                   sc, s);
  BS_NW_VARIANT_CASE(1) BS_NW_VARIANT_CASE(2) BS_NW_VARIANT_CASE(3)
  BS_NW_VARIANT_CASE(4) BS_NW_VARIANT_CASE(6) BS_NW_VARIANT_CASE(8)
  BS_NW_VARIANT_CASE(10) BS_NW_VARIANT_CASE(12) BS_NW_VARIANT_CASE(14)
  BS_NW_VARIANT_CASE(16)
#undef BS_NW_VARIANT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory the smallest block of the variant kernel needs for
// this shape and mode (capped at INT32_MAX; -1 for an unknown mode).
extern "C" int bs_nw_variant_smem_bytes(int Lq, int Lr, int mode) {
  if (mode < kLocal || mode > kSemiAffine) return -1;
  int G, W;
  variant_shape(Lr, &G, &W);
  const long long r_min = G >= 32 ? 1 : 32 / G;
  const long long bytes = smem_bytes(r_min, G, W, Lq, Lr, carry_of(mode));
  return bytes > 0x7fffffff ? 0x7fffffff : (int)bytes;
}

extern "C" int bs_nw_variant_scores(const uint8_t* seq,
                                    const int32_t* lengths,
                                    const uint8_t* ref, int32_t* scores,
                                    long long B, int Lq, int Lr, int mode,
                                    int match, int mismatch, int gap,
                                    int gap_open, int gap_extend,
                                    void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  int G, W;
  variant_shape(Lr, &G, &W);
  const Scores sc{match, mismatch, gap, gap_open, gap_extend};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kLocal:
      return launch_mode<kLocal>(W, seq, lengths, ref, scores, B, Lq, Lr, G,
                                 sc, s);
    case kSemiGlobal:
      return launch_mode<kSemiGlobal>(W, seq, lengths, ref, scores, B, Lq,
                                      Lr, G, sc, s);
    case kAffine:
      return launch_mode<kAffine>(W, seq, lengths, ref, scores, B, Lq, Lr,
                                  G, sc, s);
    case kLocalAffine:
      return launch_mode<kLocalAffine>(W, seq, lengths, ref, scores, B, Lq,
                                       Lr, G, sc, s);
    case kSemiAffine:
      return launch_mode<kSemiAffine>(W, seq, lengths, ref, scores, B, Lq,
                                      Lr, G, sc, s);
  }
  return (int)cudaErrorInvalidValue;
}
