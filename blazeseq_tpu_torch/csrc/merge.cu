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
// Bound: the bytes each output depends on read once (a row's first
// min(len, L) columns, in 32-byte sectors) and the two [n, 2L] outputs
// written once, 0.0021 ms at [4096, 256] for 150 bp mates on the H100's
// 3.35 TB/s. The scoring, Sum over the feasible overlaps of o positions a
// pair (~11,300 for 150 bp mates of 200 bp fragments), costs 8 integer
// operations a 32 positions in the bit-sliced form below, about a third of
// the bytes' time.
//
// Design. A warp takes a pair; a block holds kWarps of them (fewer where
// their slices of shared memory would not fit), each with its slice.
// * Staging: the four rows in one round of 16-byte loads (a byte a lane
//   where a row is not 16-byte aligned).
// * Codes: inside a feasible overlap every rc(R2) byte is one of A C G T N,
//   so raw-byte equality is equality of 3-bit codes: (b >> 1) & 7 of the
//   letters (A C T G N -> 0 1 2 3 7), 4 for any other R1 byte (lowercase
//   too), which no rc(R2) letter has. A lane takes 8 columns of both rows
//   through the reference's index formulas (R1 right-aligned to a
//   32-column boundary E = 32 ceil(L/32); rc(R2) as 8 bytes at an offset,
//   byte-reversed; each index clamped when a read is longer than L),
//   codes four bytes a word (a byte-permute table lookup confirms each
//   letter), writes rc(R2)'s letters and qualities for the consensus, and
//   takes each bit-plane's 8 bits with one multiply into its byte of the
//   plane word: no ballots, shuffles or tables.
// * Scoring: m(o) = 32 x words - Sum over words of popc((a0 ^ b0) |
//   (a1 ^ b1) | (a2 ^ b2)), R1's planes taken from E - o with
//   __funnelshift_r: 32 positions in 8 operations. R1's planes end in a
//   pad word of code 4, which no rc(R2) code equals, so a last word's
//   positions past o always differ and need no mask. Lanes take
//   the overlaps o_lo + u and o_hi - u for u = lane, lane + 32, ..., so
//   every lane's word count is within one overlap of every other's; each
//   keeps its best by (score, then the smaller o), and a shuffle
//   reduction the warp's.
// * Consensus: lane l builds the 16-byte pieces l, l + 32, ... of both
//   output rows from R1's staged words and rc(R2)'s (a funnel shift), the
//   quality choice four bytes at a time (__vcmpgtu4 under byte masks of
//   pre, len1 and merged_len), and stores each with one uint4 store. Rows
//   whose width is not a multiple of 16 or whose tensors are not 16-byte
//   aligned, and pairs with a read longer than L, take a byte a lane.
// Rows so wide that one warp's slice (about 7 bytes a column) passes the
// device's opt-in shared memory a block (227 KB on the H100: about 33,000
// columns) take merge_direct_kernel: every byte from device memory, the
// same balanced order, a byte compare a position, the same byte consensus.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 16;  // a block's warps, a pair each
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 30);
constexpr int kMaxDevices = 64;
// rc(R2)'s staged rows keep kPad bytes before column 0 and 32 after Lp, so
// that a consensus piece's five words never leave them
constexpr int kPad = 16;
constexpr int kDefaultSmem = 48 * 1024;
// a lane's 8 columns of a row in a code-building step
constexpr int kChunk = 8;
// ACTG...N as a byte table indexed by code, and its lowercase ACTG
constexpr uint32_t kLetLo = 0x47544341u, kLetHi = 0x4e000000u;
constexpr uint32_t kLowLo = 0x67746361u;

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
  int W;   // 32-column words a row: ceil(L / 32)
  int min_overlap;  // max(min_overlap, 1), at most L + 1
  int penalty;
  float frac;
  int vec;  // L % 16 == 0 and every row 16-byte aligned
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// one warp's slice: kPad bytes, then s1, q1, s2, q2 (Lp each); rc(R2)'s
// letters and its qualities (kPad + Lp + 32 each); R1's planes (W + 1 uint4,
// the last a pad of code 4) and rc(R2)'s (W uint4), a word's three planes
// in .x .y .z
__host__ __device__ inline long long slice_bytes(long long Lp, long long W) {
  return kPad + 4 * Lp + 2 * (kPad + Lp + 32) + (2 * W + 1) * 16;
}

__device__ __forceinline__ uint8_t comp(uint8_t b) {
  switch (b | 0x20) {
    case 'a': return 'T';
    case 'c': return 'G';
    case 'g': return 'C';
    case 't': return 'A';
    default: return 'N';
  }
}

// 3-bit codes, four bytes a word: A C T G N -> 0 1 2 3 7 ((b >> 1) & 7 of
// each letter); any other R1 byte 4, which no rc(R2) letter has; an R2 byte
// the code of COMP[b]. Equal codes <=> equal raw bytes (R1's against
// rc(R2)'s).

// byte-table selector of four codes (one nibble a byte)
__device__ __forceinline__ uint32_t selector(uint32_t c) {
  return __byte_perm(c | (c >> 4), 0, 0x4420);
}

// 0xff in each byte where t == x
__device__ __forceinline__ uint32_t same_bytes(uint32_t t, uint32_t x) {
  const uint32_t z = t ^ x;
  const uint32_t hi = ~(((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z) & 0x80808080u;
  return (hi >> 7) * 0xffu;
}

__device__ __forceinline__ uint32_t r1_codes(uint32_t x) {
  const uint32_t c = (x >> 1) & 0x07070707u;
  const uint32_t in = same_bytes(__byte_perm(kLetLo, kLetHi, selector(c)), x);
  return (c & in) | (~in & 0x04040404u);
}

__device__ __forceinline__ uint32_t rc_codes(uint32_t x) {
  const uint32_t u = x | 0x20202020u;  // COMP ignores case
  const uint32_t c = (u >> 1) & 0x07070707u;
  const uint32_t in = same_bytes(__byte_perm(kLowLo, 0u, selector(c)), u);
  return ((c ^ 0x02020202u) & in) | (~in & 0x07070707u);  // A<->T, C<->G
}

// the letters of four codes
__device__ __forceinline__ uint32_t letters(uint32_t c) {
  return __byte_perm(kLetLo, kLetHi, selector(c));
}

// bit p of 8 codes (y = codes of columns 0-3 | codes of 4-7 << 4) as a byte,
// column t at bit t
__device__ __forceinline__ uint32_t plane_byte(uint32_t y, int p) {
  return (((y >> p) & 0x11111111u) * 0x01020408u) >> 24;
}

// 8 bytes from p + at (any alignment; p 4-byte aligned) as two words
__device__ __forceinline__ uint2 load8(const uint8_t* p, int at) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p) + (at >> 2);
  const unsigned sh = 8u * (at & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// 8 bytes p[clamp(at + step * t, 0, L - 1)], t = 0..7, as two words
__device__ __forceinline__ uint2 gather8(const uint8_t* p, int at, int step,
                                         int L) {
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int t = 0; t < 8; ++t)
    v[t >> 2] |= (uint32_t)p[min(max(at + step * t, 0), L - 1)]
                 << (8 * (t & 3));
  return make_uint2(v[0], v[1]);
}

__device__ __forceinline__ uint32_t reverse_bytes(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// bytes t < x of a word set (0xff), the others 0
__device__ __forceinline__ uint32_t lt_mask(int x) {
  return __funnelshift_lc(kFull, 0u, 8u * (unsigned)min(max(x, 0), 4));
}

// R1 right-aligned at column j in [0, L), from device memory
__device__ __forceinline__ uint8_t r1_right(const uint8_t* s1, int L, int len1,
                                            int j) {
  const long long src = (long long)j - L + len1;
  return src >= 0 ? s1[src < L ? src : L - 1] : 0;
}

// column j in [0, L) of rc(R2) (or of R2's reversed qualities, COMP false),
// from device memory
template <bool COMP>
__device__ __forceinline__ uint8_t rc_at(const uint8_t* s2, int L, int len2,
                                         int j) {
  if (j >= len2) return 0;
  const long long src = (long long)len2 - 1 - j;
  const uint8_t b = s2[src < L ? src : L - 1];
  return COMP ? comp(b) : b;
}

// matches of overlap o from the planes: R1's columns [E - o, E) against
// rc(R2)'s [0, o), 32 a word, counted as the words' positions less those
// that differ. A last word's positions past o read R1's pad word, code 4,
// which no rc(R2) code equals: they differ, and no mask is needed.
__device__ __forceinline__ int matches_planes(const uint4* rp, const uint4* cp,
                                              int E, int o) {
  const int base = E - o;
  const uint4* r = rp + (base >> 5);
  const unsigned sh = base & 31;
  const int last = (o - 1) >> 5;
  int differ = 0;
  uint4 lo = r[0];
  for (int w = 0; w <= last; ++w) {
    const uint4 hi = r[w + 1];
    const uint4 c = cp[w];
    differ += __popc((__funnelshift_r(lo.x, hi.x, sh) ^ c.x) |
                     (__funnelshift_r(lo.y, hi.y, sh) ^ c.y) |
                     (__funnelshift_r(lo.z, hi.z, sh) ^ c.z));
    lo = hi;
  }
  return 32 * (last + 1) - differ;
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

struct Best {
  int s, o, x;
};

// The consensus a byte a lane and step, for rows that 16-byte pieces do not
// serve. r1(i) and r2(i) give R1's and rc(R2)'s (base, quality) at column i
// in [0, L).
template <typename Row1, typename Row2>
__device__ __forceinline__ void consensus_bytes(uint8_t* out_s, uint8_t* out_q,
                                                int L, int lane, int len1,
                                                int o, int merged, Row1 r1,
                                                Row2 r2) {
  const long long pre = (long long)len1 - o;
  for (int k = lane; k < 2 * L; k += 32) {
    uint8_t sb = 0, qb = 0;
    if (k < merged) {
      const long long d = k - pre;
      const uchar2 b2 = r2(d < 0 ? 0 : d > L - 1 ? L - 1 : (int)d);
      if (k < len1) {
        const uchar2 b1 = r1(min(k, L - 1));
        const bool use2 = k >= pre && b2.y > b1.y;
        sb = use2 ? b2.x : b1.x;
        qb = use2 ? b2.y : b1.y;
      } else {
        sb = b2.x;
        qb = b2.y;
      }
    }
    out_s[k] = sb;
    out_q[k] = qb;
  }
}

// The warp's best overlap. Lane l scores o_lo + u and o_hi - u for u = l,
// l + 32, ... (each overlap once), keeping the highest score and then the
// smallest o, as does the shuffle reduction.
template <typename Matches>
__device__ __forceinline__ Best best_overlap(int o_lo, int o_hi, int lane,
                                             int penalty, Matches matches) {
  Best b{kNeg, 0, 0};
  const int K = o_hi - o_lo + 1;
  auto take = [&](int o) {
    const int m = matches(o);
    const int x = o - m;
    const int s = (int)((unsigned)m - (unsigned)penalty * (unsigned)x);
    if (s > b.s || (s == b.s && o < b.o)) b = Best{s, o, x};
  };
  for (int u = lane; 2 * u < K; u += 32) {
    take(o_lo + u);
    if (2 * u < K - 1) take(o_hi - u);
  }
  for (int off = 16; off; off >>= 1) {
    const int s = __shfl_xor_sync(kFull, b.s, off);
    const int o = __shfl_xor_sync(kFull, b.o, off);
    const int x = __shfl_xor_sync(kFull, b.x, off);
    if (s > b.s || (s == b.s && o < b.o)) b = Best{s, o, x};
  }
  return b;
}

// acceptance and the four ints of a pair; returns the accepted overlap (0
// when unmerged) and sets merged (0 when unmerged, wrapping int32)
__device__ __forceinline__ int accept(const Args& a, long long pair, int lane,
                                      const Best& b, int len1, int len2,
                                      int& merged) {
  const bool ok = b.o > 0 && b.s > 0 &&
                  (float)b.x <= __fmul_rn(a.frac, (float)b.o);
  const int o = ok ? b.o : 0;
  merged = ok ? (int)((unsigned)len1 + (unsigned)len2 - (unsigned)o) : 0;
  if (lane == 0) {
    a.ints[pair] = o;
    a.ints[a.n + pair] = merged;
    a.ints[2LL * a.n + pair] = ok ? b.s : 0;
    a.ints[3LL * a.n + pair] = ok ? b.x : 0;
  }
  return o;
}

// two blocks an SM: at most 64 registers a thread (left free, the compiler
// takes 100, one block an SM and two waves of a 4,096-pair batch)
__global__ void __launch_bounds__(32 * kWarps, 2) merge_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= a.n) return;
  const int L = a.L, Lp = a.Lp, W = a.W, E = 32 * W, M = 2 * L;
  uint8_t* s1s = smem + warp * slice_bytes(Lp, W) + kPad;
  uint8_t* q1s = s1s + Lp;
  uint8_t* s2s = q1s + Lp;
  uint8_t* q2s = s2s + Lp;
  uint8_t* cs = q2s + Lp + kPad;  // rc(R2)'s column 0
  uint8_t* qs = cs + Lp + 32 + kPad;
  uint4* rp = reinterpret_cast<uint4*>(qs + Lp + 32);
  uint4* cp = rp + W + 1;

  const long long row = pair * L;
  const int len1 = a.len1[pair], len2 = a.len2[pair];

  // the four rows, one 16-byte load round
  if (a.vec) {
    const uint4* src[4] = {
        reinterpret_cast<const uint4*>(a.seq1 + row),
        reinterpret_cast<const uint4*>(a.qual1 + row),
        reinterpret_cast<const uint4*>(a.seq2 + row),
        reinterpret_cast<const uint4*>(a.qual2 + row)};
    for (int i = lane; i < (Lp >> 4); i += 32) {
      uint4 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = __ldg(src[r] + i);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        reinterpret_cast<uint4*>(s1s + r * Lp)[i] = v[r];
    }
  } else {
    for (int j = lane; j < L; j += 32) {
      s1s[j] = a.seq1[row + j];
      q1s[j] = a.qual1[row + j];
      s2s[j] = a.seq2[row + j];
      q2s[j] = a.qual2[row + j];
    }
  }
  __syncwarp();

  // the bit-planes, and rc(R2)'s letters and qualities: a lane takes 8
  // columns (chunk q: columns 8q.., byte q & 3 of plane word q >> 2) of
  // both rows through the reference's index formulas, R1 right-aligned to
  // E. Reads shorter than L take 8 bytes at an offset (reversed for
  // rc(R2)); longer ones clamp each index. Columns that no overlap
  // compares (R1's before its read, rc(R2)'s past len2) read the pad or
  // other bytes of the slice, and are never used.
  const int off1 = min(max(len1, -E), E + L) - E;
  const int l2 = min(max(len2, 0), E + L);
  const bool wide = len1 > L || len2 > L;
  for (int q = lane; q < 4 * W; q += 32) {
    const int c0 = kChunk * q;
    uint2 x1, x2, v2;
    if (!wide) {
      x1 = load8(s1s, max(c0 + off1, -kChunk));
      const int at2 = max(l2 - kChunk - c0, -kChunk);
      const uint2 r2 = load8(s2s, at2), rq = load8(q2s, at2);
      x2 = make_uint2(reverse_bytes(r2.y), reverse_bytes(r2.x));
      v2 = make_uint2(reverse_bytes(rq.y), reverse_bytes(rq.x));
    } else {
      x1 = gather8(s1s, c0 + off1, 1, L);
      x2 = gather8(s2s, l2 - 1 - c0, -1, L);
      v2 = gather8(q2s, l2 - 1 - c0, -1, L);
    }
    const uint32_t r0 = r1_codes(x1.x), r1 = r1_codes(x1.y);
    const uint32_t k0 = rc_codes(x2.x), k1 = rc_codes(x2.y);
    const uint32_t yr = r0 | r1 << 4, yk = k0 | k1 << 4;
    uint8_t* rb = reinterpret_cast<uint8_t*>(rp + (q >> 2)) + (q & 3);
    uint8_t* cb = reinterpret_cast<uint8_t*>(cp + (q >> 2)) + (q & 3);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      rb[4 * p] = (uint8_t)plane_byte(yr, p);
      cb[4 * p] = (uint8_t)plane_byte(yk, p);
    }
    // rc(R2)'s letters and qualities (past len2 never read)
    reinterpret_cast<uint2*>(cs)[q] = make_uint2(letters(k0), letters(k1));
    reinterpret_cast<uint2*>(qs)[q] = v2;
  }
  if (lane == 0) rp[W] = make_uint4(0, 0, kFull, 0);  // code 4
  __syncwarp();

  const int o_hi = max(min(L, min(len1, len2)), 0);
  const Best b =
      best_overlap(a.min_overlap, o_hi, lane, a.penalty, [&](int o) {
        return matches_planes(rp, cp, E, o);
      });
  int merged;
  const int o = accept(a, pair, lane, b, len1, len2, merged);

  uint8_t* out_s = a.seq + pair * M;
  uint8_t* out_q = a.qual + pair * M;
  if (a.vec && (o == 0 || (len1 <= L && len2 <= L))) {
    // 16-byte pieces; here every length is in [1, L] or the row is zero
    const int pre = len1 - o;
    for (int p = lane; p < (M >> 4); p += 32) {
      const int k0 = p << 4;
      uint32_t so[4] = {0, 0, 0, 0}, qo[4] = {0, 0, 0, 0};
      if (k0 < merged) {
        uint4 r = make_uint4(0, 0, 0, 0), v = r;
        if (k0 < L) {
          r = reinterpret_cast<const uint4*>(s1s)[p];
          v = reinterpret_cast<const uint4*>(q1s)[p];
        }
        const uint32_t w1[4] = {r.x, r.y, r.z, r.w};
        const uint32_t v1[4] = {v.x, v.y, v.z, v.w};
        // rc(R2)'s bytes from k0 - pre: five words and a shift (a piece
        // wholly before pre reads the pad, which it never takes)
        const int at = max(k0 - pre, -kPad) + kPad;
        const uint32_t* cw =
            reinterpret_cast<const uint32_t*>(cs - kPad) + (at >> 2);
        const uint32_t* qw =
            reinterpret_cast<const uint32_t*>(qs - kPad) + (at >> 2);
        const unsigned sh = 8u * (at & 3);
        uint32_t cv[5], qv[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          cv[i] = cw[i];
          qv[i] = qw[i];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int kb = k0 + 4 * g;
          const uint32_t b2 = __funnelshift_r(cv[g], cv[g + 1], sh);
          const uint32_t v2 = __funnelshift_r(qv[g], qv[g + 1], sh);
          // rc(R2)'s byte where k >= len1, or k >= pre with a higher
          // quality
          const uint32_t two = ~lt_mask(len1 - kb) |
                               (__vcmpgtu4(v2, v1[g]) & ~lt_mask(pre - kb));
          const uint32_t valid = lt_mask(merged - kb);
          so[g] = ((w1[g] & ~two) | (b2 & two)) & valid;
          qo[g] = ((v1[g] & ~two) | (v2 & two)) & valid;
        }
      }
      reinterpret_cast<uint4*>(out_s)[p] =
          make_uint4(so[0], so[1], so[2], so[3]);
      reinterpret_cast<uint4*>(out_q)[p] =
          make_uint4(qo[0], qo[1], qo[2], qo[3]);
    }
  } else {
    consensus_bytes(
        out_s, out_q, L, lane, len1, o, merged,
        [&](int i) { return make_uchar2(s1s[i], q1s[i]); },
        [&](int i) { return make_uchar2(cs[i], qs[i]); });
  }
}

// rows too wide for one warp's slice: every byte from device memory, a block
// a pair
__global__ void __launch_bounds__(32) merge_direct_kernel(const Args a) {
  const int lane = threadIdx.x;
  const long long pair = blockIdx.x;
  const int L = a.L, M = 2 * L;
  const long long row = pair * L;
  const uint8_t* s1 = a.seq1 + row;
  const uint8_t* q1 = a.qual1 + row;
  const uint8_t* s2 = a.seq2 + row;
  const uint8_t* q2 = a.qual2 + row;
  const int len1 = a.len1[pair], len2 = a.len2[pair];
  const int o_hi = max(min(L, min(len1, len2)), 0);
  const Best b =
      best_overlap(a.min_overlap, o_hi, lane, a.penalty, [&](int o) {
        return matches_direct(s1, s2, L, len1, len2, o);
      });
  int merged;
  const int o = accept(a, pair, lane, b, len1, len2, merged);
  consensus_bytes(
      a.seq + pair * M, a.qual + pair * M, L, lane, len1, o, merged,
      [&](int i) { return make_uchar2(s1[i], q1[i]); },
      [&](int i) {
        return make_uchar2(rc_at<true>(s2, L, len2, i),
                           rc_at<false>(q2, L, len2, i));
      });
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The current device's opt-in shared memory a block, with merge_kernel
// allowed all of it: queried and set once a device.
cudaError_t staged_limit(int* limit) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*limit = known[dev].load()) > 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
  if (e == cudaSuccess && dev < kMaxDevices) known[dev].store(*limit);
  return e;
}

}  // namespace

// One launch a batch of n pairs (n < 2^31; n == 0 launches nothing): kWarps
// pairs a block, half as many while their slices pass the shared memory
// that a block may hold; rows too wide for one slice take
// merge_direct_kernel.
extern "C" int bs_merge_pairs(const uint8_t* seq1, const uint8_t* qual1,
                              const int32_t* len1, const uint8_t* seq2,
                              const uint8_t* qual2, const int32_t* len2,
                              int32_t* ints, uint8_t* seq, uint8_t* qual,
                              long long n, int L, int min_overlap, int penalty,
                              float frac, void* stream) {
  if (n < 0 || n >= (1LL << 31) || L < 0 || L >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const bool vec = L % 16 == 0 && aligned16(seq1) && aligned16(qual1) &&
                   aligned16(seq2) && aligned16(qual2) && aligned16(seq) &&
                   aligned16(qual);
  const Args a{seq1, qual1, len1, seq2, qual2, len2, ints, seq, qual,
               (int)n, L, round16(L), (L + 31) >> 5, min_overlap, penalty,
               frac, vec};
  cudaStream_t s = (cudaStream_t)stream;
  const long long slice = slice_bytes(a.Lp, a.W);
  int warps = kWarps;
  if (warps * slice > kDefaultSmem) {
    int limit = 0;
    const cudaError_t e = staged_limit(&limit);
    if (e != cudaSuccess) return (int)e;
    if (slice > limit) {
      merge_direct_kernel<<<(unsigned)n, 32, 0, s>>>(a);
      return (int)cudaGetLastError();
    }
    while (warps * slice > limit) warps >>= 1;
  }
  merge_kernel<<<(unsigned)((n + warps - 1) / warps), 32 * warps,
                 (size_t)(warps * slice), s>>>(a);
  return (int)cudaGetLastError();
}
