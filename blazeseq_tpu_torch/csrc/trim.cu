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
// q = byte >= offset ? byte - offset : 0 over the columns j < lim:
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
// bytes written a row); a few integer operations a byte.
//
// Design. A row gets a group of G lanes, G the power of two >= ceil(L / 16)
// at most 32, and each lane a contiguous segment of the row, a multiple of
// 16 columns, read in 16-byte pieces (L = 256: 16 lanes of one piece, two
// rows a warp; L = 1,024: 32 lanes of two). clip_ends reduces a min and a
// max over the group. bwa_trim sums its segment, takes the sum of the later
// segments by a suffix scan of shuffles, then walks its segment backwards
// (strictly greater keeps the largest k) and reduces (max s, then the larger
// k). sliding_window_trim walks its window starts with a running sum, a
// piece at a time: the bytes w further on (in the next lanes' segments, in
// L1) come from two pieces realigned by w % 16 once a piece, so each step
// reads both of its bytes at fixed places; it reduces a min. Byte path (L % 16 != 0, or qual off
// 16-byte alignment): the same pieces gathered a byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;

enum Mode { kClipEnds = 0, kSlidingWindow = 1, kBwa = 2 };

struct Args {
  const uint8_t* qual;
  const int32_t* lengths;
  int32_t* out0;
  int32_t* out1;  // clip_ends' new lengths
  int n;
  int L;
  int offset;
  int a;  // leading / mean_q * window / threshold
  int b;  // trailing
  int window;
  int gshift;  // log2 of the lanes a row
  int seg;     // columns a lane, a multiple of 16
};

// The 16-byte piece of `row` at column c (c a multiple of 16), bytes at or
// past lim left 0.
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

// byte i (0..15) of a piece, i known at run time
__device__ __forceinline__ int byte_of(const uint32_t (&w)[4], int i) {
  const uint32_t x = (i & 8) ? ((i & 4) ? w[3] : w[2])
                             : ((i & 4) ? w[1] : w[0]);
  return (int)((x >> (8 * (i & 3))) & 0xffu);
}

__device__ __forceinline__ int phred(int byte, int off) {
  return byte >= off ? byte - off : 0;
}

// word k (0..7, known at run time) of two pieces in a row
__device__ __forceinline__ uint32_t word_of(const uint32_t (&p0)[4],
                                            const uint32_t (&p1)[4], int k) {
  const uint32_t a = (k & 2) ? ((k & 1) ? p0[3] : p0[2])
                             : ((k & 1) ? p0[1] : p0[0]);
  const uint32_t b = (k & 2) ? ((k & 1) ? p1[3] : p1[2])
                             : ((k & 1) ? p1[1] : p1[0]);
  return (k & 4) ? b : a;
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) trim_kernel(const Args a) {
  const int G = 1 << a.gshift;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  // one group of rows a warp: every lane reaches the shuffles
  const long long r = ((long long)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5)) * (32 >> a.gshift) +
                      (lane >> a.gshift);
  const bool live = r < a.n;
  const int len = live ? __ldg(a.lengths + r) : 0;
  const int lens = min(len, a.L);
  const int lim = max(lens, 0);
  const uint8_t* row = a.qual + (live ? r : 0) * (long long)a.L;
  const int off = a.offset;
  const int a0 = sub * a.seg;
  const int a1 = min(a0 + a.seg, lim);  // the lane's columns: [a0, a1)

  if (MODE == kClipEnds) {
    int first = kBig, end = 0;
    for (int c = a0; c < a1; c += 16) {
      uint32_t w[4];
      load_piece<VEC>(row, c, a1, w);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = c + i;
        const int q = phred(byte_of(w, i), off);
        if (j < a1) {
          if (q >= a.a) first = min(first, j);
          if (q >= a.b) end = j + 1;
        }
      }
    }
    for (int o = G >> 1; o; o >>= 1) {
      first = min(first, __shfl_xor_sync(kFull, first, o));
      end = max(end, __shfl_xor_sync(kFull, end, o));
    }
    if (live && sub == 0) {
      const int start = min(first, lens);
      const int kept = (int)((unsigned)end - (unsigned)start);
      a.out0[r] = start;
      a.out1[r] = max(kept, 0);
    }
  } else if (MODE == kBwa) {
    // the segment's sum of a - q, then the sum of the later segments
    unsigned tot = 0;
    for (int c = a0; c < a1; c += 16) {
      uint32_t w[4];
      load_piece<VEC>(row, c, a1, w);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c + i < a1)
          tot += (unsigned)a.a - (unsigned)phred(byte_of(w, i), off);
    }
    unsigned inc = tot;
    for (int o = 1; o < G; o <<= 1) {
      const unsigned y = __shfl_down_sync(kFull, inc, o, G);
      if (sub + o < G) inc += y;
    }
    unsigned s = inc - tot;
    // backwards over the segment: strictly greater keeps the largest k
    int best = INT32_MIN, best_k = -1;
    for (int c = a0 + ((a1 - a0 - 1) & ~15); c >= a0 && a1 > a0; c -= 16) {
      uint32_t w[4];
      load_piece<VEC>(row, c, a1, w);
#pragma unroll
      for (int i = 15; i >= 0; --i) {
        if (c + i < a1) {
          s += (unsigned)a.a - (unsigned)phred(byte_of(w, i), off);
          if ((int)s > best) {
            best = (int)s;
            best_k = c + i;
          }
        }
      }
    }
    for (int o = G >> 1; o; o >>= 1) {
      const int ob = __shfl_xor_sync(kFull, best, o);
      const int ok = __shfl_xor_sync(kFull, best_k, o);
      if (ob > best || (ob == best && ok > best_k)) {
        best = ob;
        best_k = ok;
      }
    }
    if (live && sub == 0) a.out0[r] = lim > 0 && best > 0 ? best_k : lens;
  } else {
    // window starts j in [a0, jend): windows fully inside the read
    const int w = a.window;
    const int jend = min(a0 + a.seg, lim - w + 1);
    int cut = kBig;
    if (a0 < jend) {
      unsigned sum = 0;
      for (int c = a0; c < a0 + w; c += 16) {
        uint32_t p[4];
        const int e = min(c + 16, a0 + w);
        load_piece<VEC>(row, c, e, p);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (c + i < e) sum += (unsigned)phred(byte_of(p, i), off);
      }
      // a piece of window starts at a time: its own bytes leave the window,
      // the 16 bytes w further on enter it, taken from the two pieces that
      // hold them and realigned by s = w % 16 bytes (the same for every
      // piece), so that each step reads its bytes at fixed places
      const int s = w & 15;
      for (int c = a0; c < jend && cut == kBig; c += 16) {
        uint32_t t[4], p0[4], p1[4], in[4];
        load_piece<VEC>(row, c, lim, t);
        load_piece<VEC>(row, c + w - s, lim, p0);
        load_piece<VEC>(row, c + w - s + 16, lim, p1);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          in[k] = __funnelshift_r(word_of(p0, p1, (s >> 2) + k),
                                  word_of(p0, p1, (s >> 2) + k + 1),
                                  8 * (s & 3));
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (c + i >= jend) break;
          if ((int)sum < a.a) {
            cut = c + i;
            break;
          }
          sum += (unsigned)phred(byte_of(in, i), off) -
                 (unsigned)phred(byte_of(t, i), off);
        }
      }
    }
    for (int o = G >> 1; o; o >>= 1)
      cut = min(cut, __shfl_xor_sync(kFull, cut, o));
    if (live && sub == 0) a.out0[r] = min(cut, lens);
  }
}

template <int MODE>
cudaError_t launch(const Args& a, bool vec, cudaStream_t s) {
  const long long rows_per_block = (long long)(kThreads / 32)
                                   << (5 - a.gshift);
  const unsigned blocks = (unsigned)((a.n + rows_per_block - 1) /
                                     rows_per_block);
  if (vec)
    trim_kernel<MODE, true><<<blocks, kThreads, 0, s>>>(a);
  else
    trim_kernel<MODE, false><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
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
  const int seg = 16 * ((pieces + (1 << gshift) - 1) >> gshift);
  const Args args{qual, lengths, out0, out1, (int)n, L, offset, a, b, window,
                  gshift, seg};
  const bool vec = L % 16 == 0 && ((uintptr_t)qual & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kClipEnds:
      return (int)launch<kClipEnds>(args, vec, s);
    case kSlidingWindow:
      return (int)launch<kSlidingWindow>(args, vec, s);
    default:
      return (int)launch<kBwa>(args, vec, s);
  }
}
