// Quality trimming of a padded batch for Hopper (sm_90a): the `trim`
// command's three modes in one source, the mode a template argument.
//
// Replaces blazeseq_tpu/ops/trim.py's clip_ends (l.43-62),
// sliding_window_trim (l.76-95) and bwa_trim (l.106-126), XLA code with no
// Pallas kernel; their plain torch versions (ops/trim.py::*_torch) take ~25
// launches a call. Here one launch computes a batch's new lengths.
//
// Inputs: qual u8[n, L] (row-major, contiguous), lengths i32[n]. With lens =
// min(lengths, L) (possibly <= 0) and lim = max(lens, 0), Phred
// q = byte >= offset ? byte - offset : 0 in wrapping int32 over the columns
// j < lim:
// * clip_ends (a = leading, b = trailing): start = min(first j with q >= a,
//   lens) (lens when none), end = last j with q >= b, plus one (0 when none);
//   out0 = start, out1 = max(end - start, 0) in wrapping int32.
// * sliding_window_trim (a = mean_q * window, an int32): out0 = min(first j
//   with j + window <= lens and sum(q[j, j + window)) < a, lens).
// * bwa_trim (a = threshold): s(k) = Sum over [k, lim) of a - q in wrapping
//   int32; out0 = the largest k < lim reaching the maximum of s when that
//   maximum is > 0, else lens.
//
// Bound: device-memory bytes (each row read once up to its length, 4 or 8
// bytes written a row); a few integer operations a byte. At the CLI's
// 4,096 x 256 the launch and one memory round trip set the time; at 32,768
// x 1,024 the instructions issued a row do.
//
// Design: four bytes a step, no branch a byte, few instructions a byte. A
// row gets a group of G lanes (G the power of two >= ceil(L / 16), at most
// 32), each lane PL = 1 or 2 16-byte pieces a round (L = 256: 16 lanes of
// one piece, two rows a warp; L = 1,024: 32 lanes of two, one round; wider
// rows take rounds of 1,024 columns). The first round's pieces load beside
// the length, not after it. Offsets and thresholds are folded on the host
// into constants, so that every int32 offset and threshold is exact:
// * clip_ends: q >= t is a byte compare (__vcmpgeu4) against t + offset
//   clamped to [0, 256] (256: no byte); where byte - offset wraps (offsets
//   within 255 of INT32_MIN) a second compare takes the bytes past the wrap
//   (a kernel of its own). The compare is SWAR on bit 7 of each byte (one
//   compare for both ends where leading == trailing, the CLI's default),
//   and a multiply gathers each word's bits (movemask), so a lane holds its
//   kept bytes as one bit mask, cut at lim once; __ffs / __clz of it and a
//   group min and max (redux.sync) finish.
// * bwa_trim and sliding_window_trim have a fast kernel for rows of one
//   round and constants whose sums cannot wrap; the host picks it. The
//   offset folds into the threshold (q = byte - offset), so it works on raw
//   bytes, a __dp4a per position. A group vote (SWAR byte tests, offsets up
//   to 128) sends a row with a byte below the offset to one lane that walks
//   it a byte at a time.
//   - bwa_trim: s(k) = (later lanes' sums, a group scan) + (a1 - k) a' -
//     (the lane's bytes from k on), a' = a + offset. Each position's key
//     32 s(k) + (k's place in the lane) is one mixed-sign dp4a (byte
//     weights -32) on a per-word constant, so a DPX three-way max
//     (__vimax3_s32) gives the lane's maximum and, among ties, its largest
//     k at once, before the scan, which adds 32 times the later lanes' sum;
//     two group maxima finish the row. Positions at or past lim get s <= 0
//     (a' > 0), so they never win; where no d = a - q can be > 0 the answer
//     is lens without a load.
//   - sliding_window_trim: with P the row's prefix sums, the window at j
//     sums P[j + w] - P[j]. A lane loads, with its own pieces, the bytes w
//     further on (its "end" bytes, in L1: other lanes' pieces), realigned
//     by w % 16; a group scan of (end - own) sums gives each lane the sum of
//     its first window from P[w] (a group reduction). Every start of the
//     lane is then tested at once against a + w * offset, each sum two
//     chained dp4a (end bytes weighted 1, own bytes -1), the failing starts
//     a bit mask, the first a group min of __ffs.
// * The general kernel (offsets over 128 or wrapping sums, wide rows): the
//   same design on Phred words (q = __vsubus4(word, offset) for 0 <=
//   offset <= 255; a negative offset folds into the threshold or adds
//   window * -offset to each window sum, in wrapping int32 as the plain
//   version's sums); bwa_trim walks rounds right to left, each position
//   from the right with a strictly greater sum keeping the largest k, and a
//   window's rounds left to right.
// Byte path (L % 16 != 0, or qual off 16-byte alignment): the same pieces
// gathered a byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 1 << 30;
constexpr uint32_t kOnes = 0x01010101u;

enum Mode { kClipEnds = 0, kSlidingWindow = 1, kBwa = 2 };

// bytes >= x for x in [0, 255] (x4 = x in each byte, on = ~0); none for x =
// 256 (on = 0)
struct Ge {
  uint32_t x4;
  uint32_t on;
};

// clip_ends' test q >= t on a byte b: b < split ? b >= lo : b >= hi (split
// = 256, no wrap, for every offset but those within 255 of INT32_MIN)
struct Keep {
  Ge lo;
  Ge hi;
};

struct Args {
  const uint8_t* qual;
  const int32_t* lengths;
  int32_t* out0;
  int32_t* out1;  // clip_ends' new lengths
  int n;
  int L;
  uint32_t off4;  // general path: the offset clamped to [0, 255], each byte
  Keep lead;      // clip_ends
  Keep trail;
  Ge split;
  bool same;      // clip_ends: leading == trailing
  int a;          // general path: bwa threshold (+ a negative offset);
                  // mean_q * window
  uint32_t bias;  // general window: window * -offset for a negative
                  // offset, else 0
  int window;
  int gshift;     // log2 of the lanes a row
  int span;       // columns a round: lanes x PL x 16
  int rounds;     // ceil(L / span)
  // fast path (rounds == 1): taken where fast, and no byte below lim of the
  // row is below the offset (below4 = offset in each byte, 1..128; 0: no
  // byte can be); fast_a = a + offset (bwa) or a + window * offset
  // (window, clamped to int32); bwa_lens: no sum can be > 0
  bool fast;
  bool bwa_lens;
  uint32_t below4;
  int fast_a;
};

__device__ __forceinline__ uint32_t ge(uint32_t w, Ge g) {
  return __vcmpgeu4(w, g.x4) & g.on;
}

// bytes of the word at column c that lie below lim, as a byte mask
__device__ __forceinline__ uint32_t len_mask(int c, int lim) {
  const int k = lim - c;
  return k >= 4 ? 0xffffffffu : k <= 0 ? 0u : 0xffffffffu >> (32 - 8 * k);
}

// dp4a masks: the bytes below i, and the bytes at or above i
__device__ __forceinline__ uint32_t below(int i) {
  return i == 0 ? 0u : i == 1 ? 0x1u : i == 2 ? 0x101u : 0x10101u;
}
__device__ __forceinline__ uint32_t from(int i) {
  return i == 0 ? kOnes : i == 1 ? 0x01010100u : i == 2 ? 0x01010000u
                                                          : 0x01000000u;
}

__device__ __forceinline__ uint32_t sum4(uint32_t x, uint32_t m) {
  return __dp4a(x, m, 0u);
}

// c + Sum of byte_i(x) (unsigned) times byte_i(m) (signed)
__device__ __forceinline__ uint32_t dp4a_us(uint32_t x, uint32_t m,
                                            uint32_t c) {
  uint32_t d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(m), "r"(c));
  return d;
}

// bit 7 of each byte of m, as 4 bits (no product overlaps or carries)
__device__ __forceinline__ uint32_t movemask(uint32_t m) {
  return ((m & 0x80808080u) * 0x00204081u) >> 28;
}

// bit 7 of each byte of the result: that byte of w >= that of x4 (SWAR:
// the low 7 bits compared by a subtraction that cannot borrow across
// bytes, then the top bits)
__device__ __forceinline__ uint32_t ge7(uint32_t w, uint32_t x4) {
  const uint32_t low = (w | 0x80808080u) - (x4 & 0x7f7f7f7fu);
  return (w & ~x4) | (~(w ^ x4) & low);
}

// the bytes of W words with q >= t (Keep), a bit each, word t in bits
// 4t..4t+3; wrapped offsets (VAR) take the two compares around the split
template <int W, bool VAR>
__device__ __forceinline__ uint32_t kept_bits(const uint32_t (&w)[W],
                                              const Keep& k, const Ge& split) {
  uint32_t bits = 0;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    uint32_t m;
    if (VAR) {
      const uint32_t past = ge(w[t], split);
      m = (ge(w[t], k.lo) & ~past) | (ge(w[t], k.hi) & past);
    } else {
      m = ge7(w[t], k.lo.x4);
    }
    bits |= movemask(m) << (4 * t);
  }
  return VAR ? bits : bits & k.lo.on;
}

// a byte of x below n, for n4 = n in each byte, 1 <= n <= 128 (SWAR)
__device__ __forceinline__ bool has_below(uint32_t x, uint32_t n4) {
  return ((x - n4) & ~x & 0x80808080u) != 0;
}

// NP 16-byte pieces of `row` from column c (a multiple of 16) as words;
// pieces (VEC) or bytes at or past `bound` (<= L) are left 0.
template <int NP, bool VEC>
__device__ __forceinline__ void load_words(const uint8_t* row, int c,
                                           int bound, uint32_t (&w)[4 * NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int cp = c + 16 * p;
    if (VEC) {
      const uint4 v = cp < bound
                          ? __ldg(reinterpret_cast<const uint4*>(row + cp))
                          : make_uint4(0, 0, 0, 0);
      w[4 * p] = v.x;
      w[4 * p + 1] = v.y;
      w[4 * p + 2] = v.z;
      w[4 * p + 3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[4 * p + k] = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (cp + i < bound)
          w[4 * p + (i >> 2)] |= (uint32_t)__ldg(row + cp + i)
                                 << (8 * (i & 3));
    }
  }
}

// x[t + k] for a compile-time t and a run-time k in [0, 3]
template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&x)[N], int t,
                                         int k) {
  return (k & 2) ? ((k & 1) ? x[t + 3] : x[t + 2])
                 : ((k & 1) ? x[t + 1] : x[t]);
}

// The lane's 4 PL words starting w bytes after column c0 (w's pieces from
// c0 + w - w % 16), zero at or past bound.
template <int PL, bool VEC>
__device__ __forceinline__ void end_words(const uint8_t* row, int c0, int w,
                                          int bound, uint32_t (&out)[4 * PL]) {
  const int s = w & 15, k0 = s >> 2, sh = 8 * (s & 3);
  uint32_t e[4 * PL + 4];
  load_words<PL + 1, VEC>(row, c0 + w - s, bound, e);
#pragma unroll
  for (int t = 0; t < 4 * PL; ++t)
    out[t] = __funnelshift_r(pick(e, t, k0), pick(e, t + 1, k0), sh);
}

// Where a lane's row group sits in its warp.
struct Lane {
  int G, sub;
  unsigned gmask;
};

// inclusive prefix (UP) or suffix sum of v over the group
template <bool UP>
__device__ __forceinline__ unsigned group_scan(const Lane& g, unsigned v) {
  for (int o = 1; o < g.G; o <<= 1) {
    const unsigned y = UP ? __shfl_up_sync(g.gmask, v, o, g.G)
                          : __shfl_down_sync(g.gmask, v, o, g.G);
    if (UP ? g.sub >= o : g.sub + o < g.G) v += y;
  }
  return v;
}

// bwa_trim's fast path on the lane's raw words (one round, PL pieces).
template <int PL>
__device__ __forceinline__ int bwa_fast(const Args& a, const Lane& g,
                                        uint32_t (&b)[4 * PL], int c0,
                                        int lim, int lens) {
  constexpr int W = 4 * PL;
  const unsigned th = (unsigned)a.fast_a;
  unsigned bs[W], tot_b = 0;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    b[t] &= len_mask(c0 + 4 * t, lim);
    bs[t] = sum4(b[t], kOnes);
    tot_b += bs[t];
  }
  const int cnt = min(max(lim - c0, 0), 16 * PL);
  const unsigned tot = (unsigned)cnt * th - tot_b;
  // key = 32 s(k) + (k - c0) at every position, each a dp4a with byte
  // weights -32 on a word's constant, first without the later lanes' sum
  // (32 times it is added to the lane's maximum after the scan)
  int best = INT32_MIN;
  unsigned bsuf = 0;
#pragma unroll
  for (int t = W - 1; t >= 0; --t) {
    const unsigned r = 32u * ((unsigned)(cnt - 4 * t) * th - bsuf) + 4u * t;
    int key[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      key[i] = (int)dp4a_us(b[t], from(i) * 0xe0u,
                            r + (unsigned)i - 32u * (unsigned)i * th);
    best = __vimax3_s32(best, key[0], key[1]);
    best = __vimax3_s32(best, key[2], key[3]);
    bsuf += bs[t];
  }
  best = (int)((unsigned)best + 32u * (group_scan<false>(g, tot) - tot));
  const int bv = best >> 5, bk = c0 + (best & 31);
  const int gb = __reduce_max_sync(g.gmask, bv);
  const int gk = __reduce_max_sync(g.gmask, bv == gb ? bk : -1);
  return lim > 0 && gb > 0 ? gk : lens;
}

// sliding_window_trim's fast path on the lane's raw words (one round).
template <int PL>
__device__ __forceinline__ int window_fast(const Args& a, const Lane& g,
                                           const uint32_t (&o)[4 * PL],
                                           const uint32_t (&e)[4 * PL],
                                           int c0, int jmax) {
  constexpr int W = 4 * PL;
  const int w = a.window;
  unsigned pre = 0, diff = 0, dw[W];  // dw: a word's (end - own) sum
#pragma unroll
  for (int t = 0; t < W; ++t) {
    pre += sum4(o[t] & len_mask(c0 + 4 * t, w), kOnes);
    dw[t] = dp4a_us(o[t], 0xffffffffu, sum4(e[t], kOnes));
    diff += dw[t];
  }
  // the first window's bytes, then the earlier lanes' (end - own) sums
  unsigned cum = __reduce_add_sync(g.gmask, pre) +
                 group_scan<true>(g, diff) - diff;
  uint32_t bad = 0;
#pragma unroll
  for (int t = 0; t < W; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned win =
          i ? dp4a_us(o[t], below(i) * 0xffu, __dp4a(e[t], below(i), cum))
            : cum;
      if ((int)win < a.fast_a) bad |= 1u << (4 * t + i);
    }
    cum += dw[t];
  }
  const int valid = min(max(jmax - c0 + 1, 0), 16 * PL);
  bad &= valid >= 32 ? 0xffffffffu : (1u << valid) - 1;
  return __reduce_min_sync(g.gmask, bad ? c0 + __ffs(bad) - 1 : kBig);
}

// Phred of a byte for an offset in [1, 128] (the fast kernel's offsets
// with bytes that can lie below them)
__device__ __forceinline__ unsigned phred1(const uint8_t* p, int off) {
  const int b = __ldg(p);
  return b >= off ? b - off : 0;
}

// bwa_trim a byte at a time, by one lane: the fast kernel's rows with a
// byte below the offset.
__device__ __noinline__ int bwa_serial(const uint8_t* row, int lim, int lens,
                                      int th, int off) {
  unsigned s = 0;
  int best = INT32_MIN, best_k = -1;
  for (int k = lim - 1; k >= 0; --k) {
    s += (unsigned)th - phred1(row + k, off);
    if ((int)s > best) {
      best = (int)s;
      best_k = k;
    }
  }
  return lim > 0 && best > 0 ? best_k : lens;
}

// sliding_window_trim a byte at a time, by one lane (lim >= w).
__device__ __noinline__ int window_serial(const uint8_t* row, int lim, int w,
                                         int thr, int off) {
  unsigned sum = 0;
  for (int x = 0; x < w; ++x) sum += phred1(row + x, off);
  for (int j = 0; j + w <= lim; ++j) {
    if ((int)sum < thr) return j;
    if (j + w < lim) sum += phred1(row + j + w, off) - phred1(row + j, off);
  }
  return kBig;
}

// bwa_trim's general path: Phred words, rounds right to left.
template <int PL, bool VEC>
__device__ __forceinline__ int bwa_general(const Args& a, const Lane& g,
                                           const uint8_t* row, int lane_c,
                                           int first_bound, int lim,
                                           int lens) {
  constexpr int W = 4 * PL;
  const unsigned th = (unsigned)a.a;
  int best = INT32_MIN, best_k = -1;
  unsigned later = 0;  // the sum of a - q over the later rounds
  for (int R = a.rounds - 1; R >= 0; --R) {
    const int c0 = R * a.span + lane_c;
    uint32_t q[W], qs[W];
    load_words<PL, VEC>(row, c0, R ? lim : first_bound, q);
    unsigned tot_q = 0;
#pragma unroll
    for (int t = 0; t < W; ++t) {
      q[t] = __vsubus4(q[t] & len_mask(c0 + 4 * t, lim), a.off4);
      qs[t] = sum4(q[t], kOnes);
      tot_q += qs[t];
    }
    const int cnt = min(max(lim - c0, 0), 16 * PL);
    const int a1 = c0 + cnt;
    const unsigned tot = (unsigned)cnt * th - tot_q;
    const unsigned after = later + group_scan<false>(g, tot) - tot;
    // s(k) at every position of the lane from the right: a strictly
    // greater sum keeps the largest k at the maximum
    int bv = INT32_MIN, bk = -1;
    unsigned qsuf = 0;
#pragma unroll
    for (int t = W - 1; t >= 0; --t) {
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        const int j = c0 + 4 * t + i;
        const int s = (int)(after + (unsigned)(a1 - j) * th -
                            (qsuf + sum4(q[t], from(i))));
        if (j < a1 && s > bv) {
          bv = s;
          bk = j;
        }
      }
      qsuf += qs[t];
    }
    const int gb = __reduce_max_sync(g.gmask, bv);
    const int gk = __reduce_max_sync(g.gmask, bv == gb ? bk : -1);
    // later rounds hold the larger k: only a strictly greater sum wins
    if (gb > best) {
      best = gb;
      best_k = gk;
    }
    if (R) later += __reduce_add_sync(g.gmask, tot);
  }
  return lim > 0 && best > 0 ? best_k : lens;
}

// sliding_window_trim's general path: Phred words, rounds left to right.
template <int PL, bool VEC>
__device__ __forceinline__ int window_general(const Args& a, const Lane& g,
                                              const uint8_t* row, int lane_c,
                                              int first_bound, int lim,
                                              int jmax) {
  constexpr int W = 4 * PL;
  const int w = a.window;
  int cut = kBig;
  unsigned d = 0;  // the window sum at the round's first start
  for (int R = 0; R < a.rounds && cut == kBig; ++R) {
    const int c0 = R * a.span + lane_c;
    const int bound = R ? lim : first_bound;
    uint32_t q[W], ew[W];
    load_words<PL, VEC>(row, c0, bound, q);
    end_words<PL, VEC>(row, c0, w, bound, ew);
    uint32_t qs[W], es[W];
    unsigned diff = 0;
#pragma unroll
    for (int t = 0; t < W; ++t) {
      q[t] = __vsubus4(q[t] & len_mask(c0 + 4 * t, lim), a.off4);
      qs[t] = sum4(q[t], kOnes);
      // the bytes w further on; past lim they meet only windows that do
      // not fit the read
      ew[t] = __vsubus4(ew[t], a.off4);
      es[t] = sum4(ew[t], kOnes);
      diff += es[t] - qs[t];
    }
    if (R == 0) {
      // P[w]: the first w bytes of the read
      unsigned pre = 0;
#pragma unroll
      for (int t = 0; t < W; ++t)
        pre += sum4(q[t] & len_mask(c0 + 4 * t, w), kOnes);
      for (int c = a.span + lane_c; c < w; c += a.span) {
        uint32_t x[W];
        load_words<PL, VEC>(row, c, w, x);
#pragma unroll
        for (int t = 0; t < W; ++t)
          pre += sum4(__vsubus4(x[t] & len_mask(c + 4 * t, w), a.off4),
                      kOnes);
      }
      d = __reduce_add_sync(g.gmask, pre);
    }
    // the earlier lanes' (end - own) sums
    unsigned cum = d + group_scan<true>(g, diff) - diff;
    int lane_cut = kBig;
#pragma unroll
    for (int t = 0; t < W; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = c0 + 4 * t + i;
        const unsigned win =
            cum + sum4(ew[t], below(i)) - sum4(q[t], below(i)) + a.bias;
        if (j <= jmax && (int)win < a.a) lane_cut = min(lane_cut, j);
      }
      cum += es[t] - qs[t];
    }
    cut = __reduce_min_sync(g.gmask, lane_cut);
    if (R + 1 < a.rounds) d += __reduce_add_sync(g.gmask, diff);
  }
  return cut;
}

// VAR: clip_ends' wrapped offsets; the general path of the other modes
template <int MODE, int PL, bool VEC, bool VAR>
__global__ void __launch_bounds__(kThreads, 4) trim_kernel(const Args a) {
  constexpr int W = 4 * PL;  // words a lane a round
  const int lane = threadIdx.x & 31;
  Lane g;
  g.G = 1 << a.gshift;
  g.sub = lane & (g.G - 1);
  g.gmask = g.G == 32 ? 0xffffffffu : ((1u << g.G) - 1) << (lane & ~(g.G - 1));
  // one group of rows a warp
  const long long r = ((long long)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5)) * (32 >> a.gshift) +
                      (lane >> a.gshift);
  const bool live = r < a.n;
  const int len = live ? __ldg(a.lengths + r) : 0;
  const int lens = min(len, a.L);
  const int lim = max(lens, 0);
  const uint8_t* row = a.qual + (live ? r : 0) * (long long)a.L;
  const int lane_c = g.sub * 16 * PL;
  // the first round's loads do not wait for the length
  const int first_bound = live ? a.L : 0;

  if (MODE == kClipEnds) {
    int first = kBig, end = 0;
    for (int R = 0; R < a.rounds; ++R) {
      const int c0 = R * a.span + lane_c;
      uint32_t w[W];
      load_words<PL, VEC>(row, c0, R ? lim : first_bound, w);
      // the kept bytes of the lane, a bit each (one compare for both ends
      // where the thresholds are one)
      const uint32_t ba = kept_bits<W, VAR>(w, a.lead, a.split);
      uint32_t bb = a.same ? ba : kept_bits<W, VAR>(w, a.trail, a.split);
      const int valid = min(max(lim - c0, 0), 16 * PL);
      const uint32_t vm = valid >= 32 ? 0xffffffffu : (1u << valid) - 1;
      const uint32_t ka = ba & vm;
      bb &= vm;
      if (ka) first = min(first, c0 + __ffs(ka) - 1);
      if (bb) end = c0 + 32 - __clz(bb);
    }
    first = __reduce_min_sync(g.gmask, first);
    end = __reduce_max_sync(g.gmask, end);
    if (live && g.sub == 0) {
      const int start = min(first, lens);
      const int kept = (int)((unsigned)end - (unsigned)start);
      a.out0[r] = start;
      a.out1[r] = max(kept, 0);
    }
    return;
  }
  int out = lens;
  if (MODE == kBwa && a.bwa_lens) {
    // no sum can be > 0
  } else if (MODE == kSlidingWindow && lim < a.window) {
    // no window fits the read
  } else if (VAR) {
    out = MODE == kBwa
              ? bwa_general<PL, VEC>(a, g, row, lane_c, first_bound, lim,
                                     lens)
              : min(window_general<PL, VEC>(a, g, row, lane_c, first_bound,
                                            lim, lim - a.window),
                    lens);
  } else {
    // the own words and, for windows, the end words in one round trip
    uint32_t own[W], ends[W];
    load_words<PL, VEC>(row, lane_c, first_bound, own);
    if constexpr (MODE == kSlidingWindow)
      end_words<PL, VEC>(row, lane_c, a.window, first_bound, ends);
    bool low = false;
    if (a.below4) {
#pragma unroll
      for (int t = 0; t < W; ++t)
        low |= has_below(own[t] | ~len_mask(lane_c + 4 * t, lim), a.below4);
    }
    if (__any_sync(g.gmask, low)) {
      // a byte below the offset: the row a byte at a time
      const int off = a.below4 & 0xff;
      if (g.sub == 0)
        out = MODE == kBwa
                  ? bwa_serial(row, lim, lens, a.a, off)
                  : min(window_serial(row, lim, a.window, a.a, off), lens);
    } else if (MODE == kBwa) {
      out = bwa_fast<PL>(a, g, own, lane_c, lim, lens);
    } else {
      out = min(window_fast<PL>(a, g, own, ends, lane_c, lim - a.window),
                lens);
    }
  }
  if (live && g.sub == 0) a.out0[r] = out;
}

template <int MODE, int PL, bool VAR>
cudaError_t launch(const Args& a, bool vec, cudaStream_t s) {
  const long long rows_per_block = (long long)(kThreads / 32)
                                   << (5 - a.gshift);
  const unsigned blocks = (unsigned)((a.n + rows_per_block - 1) /
                                     rows_per_block);
  if (vec)
    trim_kernel<MODE, PL, true, VAR><<<blocks, kThreads, 0, s>>>(a);
  else
    trim_kernel<MODE, PL, false, VAR><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const Args& a, bool var, int pl, bool vec,
                        cudaStream_t s) {
  if (var)
    return pl == 1 ? launch<MODE, 1, true>(a, vec, s)
                   : launch<MODE, 2, true>(a, vec, s);
  return pl == 1 ? launch<MODE, 1, false>(a, vec, s)
                 : launch<MODE, 2, false>(a, vec, s);
}

Ge make_ge(long long x) {
  x = x < 0 ? 0 : x > 256 ? 256 : x;
  return Ge{(uint32_t)(x > 255 ? 255 : x) * kOnes, x <= 255 ? ~0u : 0u};
}

// q >= t as byte compares (Keep), q = byte - offset wrapped to int32, or
// saturated at 0 for offset >= 0
Keep make_keep(int t, int offset) {
  const long long lo = (offset >= 0 && t <= 0) ? 0 : (long long)t + offset;
  return Keep{make_ge(lo), make_ge(lo + (1LL << 32))};
}

long long clamp32(long long v) {
  return v < INT32_MIN ? INT32_MIN : v > INT32_MAX ? INT32_MAX : v;
}

}  // namespace

// mode 0: clip_ends (a = leading, b = trailing; out0 = start, out1 = new
// length); 1: sliding_window_trim (a = mean_q * window; out0); 2: bwa_trim
// (a = threshold; out0). n < 2^31; n == 0 launches nothing.
extern "C" int bs_trim(const uint8_t* qual, const int32_t* lengths,
                       int32_t* out0, int32_t* out1, long long n, int L,
                       int mode, int offset, int a, int b, int window,
                       void* stream) {
  if (n < 0 || n >= (1LL << 31) || L < 1 || mode < 0 || mode > 2 ||
      (mode == kSlidingWindow && (window < 1 || window > L)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int pieces = (L + 15) / 16;
  int gshift = 0;
  while ((1 << gshift) < pieces && gshift < 5) ++gshift;
  const int pl = pieces > 32 ? 2 : 1;
  Args args{};
  args.qual = qual;
  args.lengths = lengths;
  args.out0 = out0;
  args.out1 = out1;
  args.n = (int)n;
  args.L = L;
  args.off4 = (uint32_t)(offset < 0 ? 0 : offset > 255 ? 255 : offset) * kOnes;
  args.lead = make_keep(a, offset);
  args.trail = make_keep(b, offset);
  args.same = a == b;
  // bytes at or past 2^31 + offset wrap (offsets within 255 of INT32_MIN)
  args.split = make_ge(offset < 0 ? (1LL << 31) + offset : 256);
  args.a = mode == kBwa && offset < 0
               ? (int)((unsigned)a + (unsigned)offset)
               : a;
  args.bias = mode == kSlidingWindow && offset < 0
                  ? (unsigned)window * (0u - (unsigned)offset)
                  : 0u;
  args.window = window;
  args.gshift = gshift;
  args.span = (16 * pl) << gshift;
  args.rounds = (L + args.span - 1) / args.span;
  // the fast path: one round, bytes tested against offsets up to 128, and
  // sums far from wrapping (|q| <= 255 + |offset| = qmax)
  const long long qmax = 255 + (offset < 0 ? -(long long)offset : 0);
  const long long ea = (long long)a + offset;  // bwa: a - q = ea - byte
  args.below4 = offset > 0 && offset <= 128 ? (uint32_t)offset * kOnes : 0;
  const bool off_ok = offset <= 128 && args.rounds == 1;
  if (mode == kBwa) {
    // d = a - q is at most dmax and at most dmag in size (d = ea - byte
    // for offset <= 0); where no d is > 0 and no sum wraps, every s(k) <= 0
    const long long dmax = offset <= 0 ? ea : a;
    const long long dmag = (dmax < 0 ? -dmax : dmax) + 255;
    args.bwa_lens = dmax <= 0 && L * dmag < (1LL << 31);
    // s(k) of raw bytes, 32 s(k) + 31 inside int32
    args.fast = off_ok && ea > 0 && L * (ea + 255) < (1LL << 25);
    args.fast_a = (int)(args.fast ? ea : 0);
  } else if (mode == kSlidingWindow) {
    args.fast = off_ok && qmax * window < (1LL << 31);
    args.fast_a = (int)clamp32((long long)a + (long long)window * offset);
  }
  const bool vec = L % 16 == 0 && ((uintptr_t)qual & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  // the general kernel where the fast path cannot serve every row
  const bool general = !args.fast;
  switch (mode) {
    case kClipEnds:
      return (int)launch_mode<kClipEnds>(args, args.split.on != 0, pl, vec,
                                         s);
    case kSlidingWindow:
      return (int)launch_mode<kSlidingWindow>(args, general, pl, vec, s);
    default:
      return (int)launch_mode<kBwa>(args, general, pl, vec, s);
  }
}
