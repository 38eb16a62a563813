// Read-duplication hashes of a padded batch for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/dedup.py::read_hashes, which is XLA code with
// no Pallas kernel: one launch, where the plain torch version
// (ops/dedup.py::read_hashes_torch) emulates uint32 in int64 and builds two
// int64 [n, L] products.
//
// Inputs: seq u8[n, L] (row-major, contiguous), lengths i32[n]. Output:
// rows [0, rows) of the batch into out[0:rows], int64 [rows, 2], where
// `out` may point into a larger buffer. For a row r < n_valid = min(n,
// n_records), with m = clip(lengths[r], 0, L),
//   h = sum_{j < m} seq[r, j] * base^j + (uint32)lengths[r] * salt
// mod 2^32, for (base, salt) = (1000003, 2654435761) and (0x01000193,
// 0x9E3779B1); a padding row gets 0xFFFFFFFF in both. Each value is a
// uint32 held in int64. uint32 arithmetic on the card wraps mod 2^32, so
// these are the reference's bits directly; the sum is exact in any order.
//
// Bound: device-memory bytes (each row read once up to its length, 16
// bytes written a row); two multiply-adds a byte.
//
// Design. A row is cut into 16-byte pieces, and a group of g lanes takes
// one row: g is the power of two >= ceil(L / 16), at most 8 (L = 256: 8
// lanes with two pieces each, four rows a warp; L = 1024: 8 lanes, two
// rounds of four pieces). Lane s of a group takes the pieces s, s + g, ...
// (P of them a round); it issues the uint4 loads of all of them, those that
// start before the row's length, before it uses any, so a row costs one
// round trip to device memory, and the next row's loads are in flight
// while it sums this one. A piece's sum is sum_b x_b * base^b over its 16
// bytes, base^0..base^15 being compile-time constants (16 multiply-adds a
// base, all immediates), bytes at j >= m zeroed first in the piece that
// straddles m; the lane scales it by the piece's power base^(16k), computed
// once a thread from constant squares, so no table is read. Two wrapping __shfl_xor_sync sums over the
// group combine the lanes, and the group's first lane adds the length term
// and writes the row's 16 bytes. The time at [32768, 1024] follows the
// instructions a warp issues a row, not the bytes: more rows a warp and
// fewer shuffle levels (g at most 8, not 32) took it from 13.4 to 10.8 us
// on an H100, at [4096, 256] 2.9 against 3.0 us (PERF.md).
// Byte path (L % 16 != 0, or seq off 16-byte alignment): the same pieces,
// each gathered a byte at a time up to the length; a kernel of its own.

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
constexpr int kMaxGroup = 8;  // lanes a row at most

struct Args {
  const uint8_t* seq;
  const int32_t* lengths;
  long long* out;
  int rows;     // rows written: [0, rows)
  int n_valid;  // rows below it are hashed, the rest get the sentinel
  int L;
  int gshift;  // log2 of the lanes a row, g
  int spec;    // each warp has one row block: load it whole, at once with
               // its lengths
};

__host__ __device__ constexpr uint32_t const_pow(uint32_t b, int e) {
  uint32_t r = 1;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}

// B^(16 e) for e < 256: a product of the constants B^(16 * 2^i) that the
// bits of e select (immediates; no loop, no table read)
template <uint32_t B, int I = 0>
__device__ __forceinline__ uint32_t pow16(unsigned e, uint32_t r = 1) {
  if constexpr (I == 8) {
    return r;
  } else {
    constexpr uint32_t c = const_pow(B, 16 << I);
    return pow16<B, I + 1>(e, (e >> I) & 1u ? r * c : r);
  }
}

// sum_{i < 16} byte i of w * B^i (mod 2^32), the powers as immediates
template <uint32_t B, int I = 0>
__device__ __forceinline__ uint32_t piece_sum(const uint32_t (&w)[4],
                                              uint32_t s = 0) {
  if constexpr (I == 16) {
    return s;
  } else {
    constexpr uint32_t c = const_pow(B, I);
    const uint32_t x = __byte_perm(w[I >> 2], 0u, 0x4440u | (I & 3));
    return piece_sum<B, I + 1>(w, s + x * c);
  }
}

// bytes [0, k) of a 4-byte word, k clipped to [0, 4]: ~0 shifted right by
// 32 - 8k, the shift clamped at 32
__device__ __forceinline__ uint32_t first_bytes(int k) {
  return __funnelshift_rc(kFull, 0u, 32 - 8 * min(k, 4));
}

// The piece of `row` at column c, bytes at or past lim left 0 (none when
// c >= lim): one uint4 on the 16-byte path, else a byte at a time.
template <bool VEC>
__device__ __forceinline__ void load_piece(const uint8_t* row, int c, int lim,
                                           uint32_t (&w)[4]) {
  const int k = lim - c;
  if (VEC) {
    const uint4 v = k > 0 ? __ldg(reinterpret_cast<const uint4*>(row + c))
                          : make_uint4(0, 0, 0, 0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < k) w[b >> 2] |= (uint32_t)row[c + b] << (8 * (b & 3));
  }
}

// Add a piece whose first kv bytes lie within the row's length, at powers
// (pa, pb): nothing when kv <= 0; the bytes past kv zeroed when kv < 16.
__device__ __forceinline__ void add_piece(uint32_t (&w)[4], int kv,
                                          uint32_t pa, uint32_t pb,
                                          uint32_t& ha, uint32_t& hb) {
  if (kv <= 0) return;
  if (kv < 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] &= first_bytes(kv - 4 * i);
  }
  ha += piece_sum<kBaseA>(w) * pa;
  hb += piece_sum<kBaseB>(w) * pb;
}

// P: pieces a lane loads for a row (1, 2 or 4; a row wider than 16 * g * P
// bytes takes further rounds, loaded as they go). VEC: the 16-byte path.
template <int P, bool VEC>
__global__ void __launch_bounds__(kThreads) read_hashes_kernel(const Args a) {
  const int g = 1 << a.gshift;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);
  const int col = 16 * sub;  // the lane's first piece
  const int span = 16 * g;   // columns between its pieces
  // the powers of the lane's pieces sub + g * p, once a thread (kept in
  // registers: the compiler would otherwise recompute them a row), and the
  // step to its pieces of a further round
  const uint32_t ga = pow16<kBaseA>(g), gb = pow16<kBaseB>(g);
  uint32_t pa[P], pb[P], sa = ga, sb = gb;
  pa[0] = pow16<kBaseA>(sub);
  pb[0] = pow16<kBaseB>(sub);
#pragma unroll
  for (int p = 1; p < P; ++p) {
    pa[p] = pa[p - 1] * ga;
    pb[p] = pb[p - 1] * gb;
    sa *= ga;
    sb *= gb;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) asm volatile("" : "+r"(pa[p]), "+r"(pb[p]));
  // the warp's row blocks: one, then a grid's worth of rows further on
  // (warp-uniform, so that every lane reaches the shuffles); the lane's row
  // in each is `lane / g` into it
  const int rpw = 32 >> a.gshift;
  const int stride = gridDim.x * kWarps * rpw;
  const int b0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * rpw;
  int r = b0 + (lane >> a.gshift);
  const long long row_step = (long long)stride * a.L;
  const uint8_t* row = a.seq + (long long)r * a.L;
  auto length_of = [&](int q) {
    return q < a.n_valid ? __ldg(a.lengths + q) : 0;
  };
  auto limit = [&](int q, int len) {
    return q < a.n_valid ? min(max(len, 0), a.L) : 0;
  };
  // Two rows a lane in flight: the next row's loads are issued before this
  // one is summed, its length one row earlier still. With spec the row is
  // loaded whole (padding included) while its length is on the way.
  uint32_t cur[P][4], nxt[P][4];
  int len, len_next = 0;
  if (a.spec) {
    const int lim = r < a.n_valid ? a.L : 0;
#pragma unroll
    for (int p = 0; p < P; ++p)
      load_piece<VEC>(row, col + span * p, lim, cur[p]);
    len = length_of(r);
  } else {
    len = length_of(r);
    const int lim = limit(r, len);
#pragma unroll
    for (int p = 0; p < P; ++p)
      load_piece<VEC>(row, col + span * p, lim, cur[p]);
    len_next = length_of(r + stride);
  }
  for (int blk = b0; blk < a.rows; blk += stride) {
    const bool more = blk + stride < a.rows;  // warp-uniform
    int len_after = 0;
    if (more) {
      const int lim = limit(r + stride, len_next);
#pragma unroll
      for (int p = 0; p < P; ++p)
        load_piece<VEC>(row + row_step, col + span * p, lim, nxt[p]);
      len_after = length_of(r + 2 * stride);
    }
    const int m = limit(r, len);
    uint32_t ha = 0, hb = 0;
#pragma unroll
    for (int p = 0; p < P; ++p)
      add_piece(cur[p], m - col - span * p, pa[p], pb[p], ha, hb);
    if (span * P < m) {  // a wider row: further rounds, loaded as they go
      uint32_t qa[P], qb[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        qa[p] = pa[p];
        qb[p] = pb[p];
      }
      for (int c0 = span * P; c0 < m; c0 += span * P) {
        uint32_t x[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_piece<VEC>(row, c0 + col + span * p, m, x[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          qa[p] *= sa;
          qb[p] *= sb;
          add_piece(x[p], m - c0 - col - span * p, qa[p], qb[p], ha, hb);
        }
      }
    }
    for (int o = g >> 1; o; o >>= 1) {
      ha += __shfl_xor_sync(kFull, ha, o);
      hb += __shfl_xor_sync(kFull, hb, o);
    }
    if (r < a.rows && sub == 0) {
      const bool valid = r < a.n_valid;
      const long long h0 = valid ? ha + (uint32_t)len * kSaltA : kSentinel;
      const long long h1 = valid ? hb + (uint32_t)len * kSaltB : kSentinel;
      long long* o = a.out + 2LL * r;
      if (((uintptr_t)o & 15) == 0) {
        *reinterpret_cast<longlong2*>(o) = make_longlong2(h0, h1);
      } else {
        o[0] = h0;
        o[1] = h1;
      }
    }
    if (more) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[p][i] = nxt[p][i];
      len = len_next;
      len_next = len_after;
    }
    r += stride;
    row += row_step;
  }
}

template <int P, bool VEC>
cudaError_t launch(Args a, int sm_count, cudaStream_t stream) {
  // resident blocks a card holds, asked once a build (every kernel's
  // occupancy is fixed by its registers)
  static int per_sm = 0;
  if (per_sm == 0) {
    int got = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &got, read_hashes_kernel<P, VEC>, kThreads, 0);
    if (e != cudaSuccess) return e;
    per_sm = got > 0 ? got : 1;
  }
  // One wave: a block for every 8 * 32 / g rows, at most as many blocks as
  // the card holds at once; a warp then walks its row blocks with the
  // grid's stride, the next one's loads in flight while it sums the current
  // one. At [32768, 1024] (g = 8, P = 4) that is every resident block and
  // ~4 row blocks of 4 rows a warp, every row in the one wave. Where each
  // warp has one row block (at [4096, 256]: g = 8, 128 blocks) the rows are
  // loaded whole, padding included, while their lengths are (spec): one
  // round trip.
  const long long rows_per_block = (long long)kWarps * (32 >> a.gshift);
  long long blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  const long long wave = (long long)per_sm * sm_count;
  if (blocks > wave) blocks = wave;
  a.spec = blocks * rows_per_block >= a.rows ? 1 : 0;
  read_hashes_kernel<P, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_p(int per_lane, const Args& a, int sm_count,
                     cudaStream_t s) {
  return per_lane <= 1   ? launch<1, VEC>(a, sm_count, s)
         : per_lane <= 2 ? launch<2, VEC>(a, sm_count, s)
                         : launch<4, VEC>(a, sm_count, s);
}

}  // namespace

// Rows [0, rows) of the batch into out[0:rows] (int64, two a row; `out`
// may point into a larger buffer, other rows are left alone). Row indices
// are int: a batch of 2^30 rows or more is refused.
extern "C" int bs_read_hashes(const uint8_t* seq, const int32_t* lengths,
                              long long* out, long long n, long long n_valid,
                              long long rows, int L, int sm_count,
                              void* stream) {
  if (n < 0 || n >= (1LL << 30) || L < 0 || n_valid < 0 || n_valid > n ||
      rows < 0 || rows > n || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int pieces = L > 0 ? (L + 15) / 16 : 1;
  int gshift = 0;
  while ((1 << gshift) < pieces && (1 << gshift) < kMaxGroup) ++gshift;
  const int per_lane = (pieces + (1 << gshift) - 1) >> gshift;
  const Args a{seq, lengths, out, (int)rows,
               (int)(n_valid < rows ? n_valid : rows), L, gshift, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = L % 16 == 0 && ((uintptr_t)seq & 15) == 0;
  return (int)(vec ? launch_p<true>(per_lane, a, sm_count, s)
                   : launch_p<false>(per_lane, a, sm_count, s));
}
