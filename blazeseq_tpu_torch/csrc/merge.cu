// Paired-end overlap merging for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/merge.py::merge_pairs (with _revcomp_rows and
// _score_overlaps), which is XLA code with no Pallas kernel: a lax.scan over
// the overlap lengths. Its plain torch version (ops/merge.py::
// merge_pairs_torch) loops over them in Python, about a dozen launches an
// overlap length, ~3,000 a 4,096-pair batch at L = 256. Here one launch
// computes every output of a batch.
//
// Inputs: seq1, qual1, seq2, qual2 u8[n, L] (row-major, contiguous; R2 as
// sequenced), len1, len2 i32[n]. Outputs: ints i32[4, n] (overlap,
// merged_len, score, mismatches) and seq, qual u8[n, 2L]; every byte is
// written, zero past merged_len and on unmerged rows.
//
// What it computes, as the reference does:
// * rc(R2)[j] = COMP[seq2[min(len2 - 1 - j, L - 1)]] for j < len2, else 0
//   (COMP: ACGTacgtN -> TGCATGCAN, every other byte -> N); its qualities
//   reversed the same way. R1 right-aligned: r1r[j] = seq1[min(j - L +
//   len1, L - 1)] where j - L + len1 >= 0, else 0. So a read longer than L
//   (to_padded clamps rows but reports true lengths) reads column L - 1
//   past the row's end.
// * For o in [max(min_overlap, 1), min(L, len1, len2)]: m(o) = #{i < o :
//   r1r[L - o + i] == rc(R2)[i]} (raw bytes), s(o) = m - penalty * (o - m)
//   in wrapping int32. The best s wins, from -(1 << 30) and strictly, over
//   ascending o: among equal scores the smallest overlap, with its
//   mismatches.
// * Accepted when o > 0, s > 0 and float(mism) <= float(frac) * float(o),
//   all fp32 (frac comes from the host as fp32).
// * Consensus at k < 2L, with pre = len1 - o: k < len1 takes R1's column
//   min(k, L - 1), or rc(R2)'s column clip(k - pre, 0, L - 1) where k >= pre
//   and its quality is strictly higher; k >= len1 takes rc(R2)'s.
//
// Bound: Sum over the feasible overlaps of o byte comparisons a pair
// (~11,300 for 150 bp mates of 200 bp fragments), and the four [n, L]
// inputs read and the two [n, 2L] outputs written once: a few microseconds
// at [4096, 256], the launch floor's scale.
//
// Design. A warp takes a pair. It stages R1 right-aligned, rc(R2) and
// rc(R2)'s qualities in its slice of shared memory (about 3L bytes), R1's
// suffix ending at a 4-byte boundary so that every overlap starts at a
// known byte offset in a word. Lane l scores the overlaps o = o_lo + l,
// o_lo + l + 32, ...: four bytes a step, R1's bytes taken from two aligned
// words by a funnel shift, compared with __vcmpeq4 and counted by
// __popc; the last partial word is masked. A shuffle reduction keeps the
// best (score, then the smallest o); the warp then writes the consensus
// rows, a byte a lane and step, R1's bytes read from device memory and
// rc(R2)'s from shared memory. Rows wider than kMaxStagedL take the same
// code with every byte computed from device memory (no staging).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // a block; a warp a pair
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 30);
// staged rows: kWarps slices of stage_bytes(L) within the default 48 KiB
constexpr int kMaxStagedL = 4080;

struct Args {
  const uint8_t* seq1;
  const uint8_t* qual1;
  const int32_t* len1;
  const uint8_t* seq2;
  const uint8_t* qual2;
  const int32_t* len2;
  int32_t* ints;  // [4, n]: overlap, merged_len, score, mismatches
  uint8_t* seq;   // [n, 2L]
  uint8_t* qual;  // [n, 2L]
  int n;
  int L;
  int Lp;  // L rounded up to 16
  int min_overlap;
  int penalty;
  float frac;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// bytes of one warp's slice: R1 right-aligned (Lp + a pad word), rc(R2)
// (Lp + a pad word), rc(R2)'s qualities (Lp)
__host__ __device__ inline int stage_bytes(int Lp) { return 3 * Lp + 32; }

__device__ __forceinline__ uint8_t comp(uint8_t b) {
  switch (b | 0x20) {
    case 'a': return 'T';
    case 'c': return 'G';
    case 'g': return 'C';
    case 't': return 'A';
    default: return 'N';
  }
}

// R1 right-aligned at column j in [0, L)
__device__ __forceinline__ uint8_t r1_right(const uint8_t* s1, int L, int len1,
                                            int j) {
  const long long src = (long long)j - L + len1;
  return src >= 0 ? s1[src < L ? src : L - 1] : 0;
}

// column j in [0, L) of rc(R2) (or of R2's reversed qualities, comp false)
template <bool COMP>
__device__ __forceinline__ uint8_t rc_at(const uint8_t* s2, int L, int len2,
                                         int j) {
  if (j >= len2) return 0;
  const long long src = (long long)len2 - 1 - j;
  const uint8_t b = s2[src < L ? src : L - 1];
  return COMP ? comp(b) : b;
}

// matches of overlap o from the staged words: R1's bytes [Lp - o, Lp)
// against rc(R2)'s [0, o)
__device__ __forceinline__ int matches_staged(const uint32_t* rw,
                                              const uint32_t* cw, int Lp,
                                              int o) {
  const int base = Lp - o;
  const uint32_t* r = rw + (base >> 2);
  const unsigned sh = 8u * (base & 3);
  const int full = o >> 2, rem = o & 3;
  int bits = 0;
  uint32_t lo = r[0];
  for (int w = 0; w < full; ++w) {
    const uint32_t hi = r[w + 1];
    bits += __popc(__vcmpeq4(__funnelshift_r(lo, hi, sh), cw[w]));
    lo = hi;
  }
  if (rem) {
    const uint32_t hi = r[full + 1];
    bits += __popc(__vcmpeq4(__funnelshift_r(lo, hi, sh), cw[full]) &
                   ((1u << (8 * rem)) - 1u));
  }
  return bits >> 3;
}

// matches of overlap o, every byte from device memory
__device__ __forceinline__ int matches_direct(const uint8_t* s1,
                                              const uint8_t* s2, int L,
                                              int len1, int len2, int o) {
  int m = 0;
  for (int i = 0; i < o; ++i)
    m += r1_right(s1, L, len1, L - o + i) == rc_at<true>(s2, L, len2, i);
  return m;
}

template <bool STAGED>
__global__ void __launch_bounds__(kThreads) merge_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= a.n) return;  // warp-uniform
  const int L = a.L, Lp = a.Lp;
  const long long row = (long long)pair * L;
  const uint8_t* s1 = a.seq1 + row;
  const uint8_t* q1 = a.qual1 + row;
  const uint8_t* s2 = a.seq2 + row;
  const uint8_t* q2 = a.qual2 + row;
  const int len1 = a.len1[pair], len2 = a.len2[pair];

  // the warp's slice: R1 right-aligned ending at Lp, rc(R2), its qualities
  uint8_t* rs = smem + warp * stage_bytes(Lp);
  uint8_t* cs = rs + Lp + 16;
  uint8_t* qs = cs + Lp + 16;
  if (STAGED) {
    for (int j = lane; j < Lp + 16; j += 32) {
      const int c = j - (Lp - L);  // R1's column
      rs[j] = c >= 0 && c < L ? r1_right(s1, L, len1, c) : 0;
      cs[j] = j < L ? rc_at<true>(s2, L, len2, j) : 0;
      if (j < Lp) qs[j] = j < L ? rc_at<false>(q2, L, len2, j) : 0;
    }
    __syncwarp();
  }

  // each lane's best over its overlaps, ascending, strictly
  int best_s = kNeg, best_o = 0, best_x = 0;
  const int o_hi = min(L, min(len1, len2));
  const int o_lo = max(a.min_overlap, 1);
  for (int o = o_lo + lane; o <= o_hi; o += 32) {
    const int m = STAGED
        ? matches_staged(reinterpret_cast<const uint32_t*>(rs),
                         reinterpret_cast<const uint32_t*>(cs), Lp, o)
        : matches_direct(s1, s2, L, len1, len2, o);
    const int x = o - m;
    const int s = (int)((unsigned)m - (unsigned)a.penalty * (unsigned)x);
    if (s > best_s) {
      best_s = s;
      best_o = o;
      best_x = x;
    }
  }
  // the warp's best: the highest score, then the smallest overlap
  for (int off = 16; off; off >>= 1) {
    const int s = __shfl_xor_sync(kFull, best_s, off);
    const int o = __shfl_xor_sync(kFull, best_o, off);
    const int x = __shfl_xor_sync(kFull, best_x, off);
    if (s > best_s || (s == best_s && o < best_o)) {
      best_s = s;
      best_o = o;
      best_x = x;
    }
  }
  const bool ok = best_o > 0 && best_s > 0 &&
                  (float)best_x <= __fmul_rn(a.frac, (float)best_o);
  const int o = ok ? best_o : 0;
  const int merged =
      ok ? (int)((unsigned)len1 + (unsigned)len2 - (unsigned)o) : 0;
  if (lane == 0) {
    a.ints[pair] = o;
    a.ints[a.n + pair] = merged;
    a.ints[2LL * a.n + pair] = ok ? best_s : 0;
    a.ints[3LL * a.n + pair] = ok ? best_x : 0;
  }

  // the consensus rows, a byte a lane and step
  const int M = 2 * L;
  uint8_t* out_s = a.seq + (long long)pair * M;
  uint8_t* out_q = a.qual + (long long)pair * M;
  const long long pre = (long long)len1 - o;
  for (int k = lane; k < M; k += 32) {
    uint8_t sb = 0, qb = 0;
    if (ok && k < merged) {
      const int i1 = min(k, L - 1);
      const long long d = k - pre;
      const int i2 = d < 0 ? 0 : d > L - 1 ? L - 1 : (int)d;
      const uint8_t b2 = STAGED ? cs[i2] : rc_at<true>(s2, L, len2, i2);
      const uint8_t v2 = STAGED ? qs[i2] : rc_at<false>(q2, L, len2, i2);
      if (k < len1) {
        const uint8_t b1 = s1[i1], v1 = q1[i1];
        const bool use2 = k >= pre && v2 > v1;
        sb = use2 ? b2 : b1;
        qb = use2 ? v2 : v1;
      } else {
        sb = b2;
        qb = v2;
      }
    }
    out_s[k] = sb;
    out_q[k] = qb;
  }
}

}  // namespace

// One launch a batch of n pairs (n < 2^31; n == 0 launches nothing).
extern "C" int bs_merge_pairs(const uint8_t* seq1, const uint8_t* qual1,
                              const int32_t* len1, const uint8_t* seq2,
                              const uint8_t* qual2, const int32_t* len2,
                              int32_t* ints, uint8_t* seq, uint8_t* qual,
                              long long n, int L, int min_overlap, int penalty,
                              float frac, void* stream) {
  if (n < 0 || n >= (1LL << 31) || L < 0 || L >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Args a{seq1, qual1, len1, seq2, qual2, len2, ints, seq, qual,
               (int)n, L, round16(L), min_overlap, penalty, frac};
  const long long blocks = (n + kWarps - 1) / kWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= kMaxStagedL) {
    merge_kernel<true><<<(unsigned)blocks, kThreads,
                         kWarps * stage_bytes(a.Lp), s>>>(a);
  } else {
    merge_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
