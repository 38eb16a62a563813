// Barcode assignment of a padded batch for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/demux.py::_assign (l.38-54), XLA code with no
// Pallas kernel; its plain torch version (ops/demux.py::demux_assign_torch)
// builds an [n, K, bl] compare in ~19 launches. Here one launch, for any
// barcode length and any set.
//
// Inputs: seq u8[n, L] (row-major, contiguous; bl <= L), lengths i32[n],
// and the barcode set made once a set and device by the host
// (ops/demux.py::_barcode_words) in one of two layouts:
//   planes, for sets of more than 8 barcodes or barcodes of more than 16
//   bases, where every barcode byte is one of ACGTN and bl <= 256: int32
//   [K, W, 4], W = ceil(bl / 32), for positions 32w .. 32w + 31 of a
//   barcode the three bit-planes of its 3-bit codes (b >> 1) & 7 (A 0, C 1,
//   T 2, G 3, N 7), then a mask of the positions that hold a base other
//   than 'N' (0 for 'N', the wildcard, and past bl);
//   bytes, any other set: int32 [2, K, ceil(bl / 4)], the upper-cased
//   bytes four a word, then masks with 0xFF in each byte other than 'N'.
// Outputs: assign i32[n], best i32[n]. For read r, with up = its first bl
// bytes & 0xDF, mm(k) = #{i < bl : up[i] != code_k[i] and code_k[i] != 'N'},
// or bl + 1 for every k when lengths[r] < bl; best = min_k mm(k); assign =
// the first k reaching best when it is the only one and best <= max_mm,
// else -1.
//
// Bound: device-memory bytes (each read's first bl bytes, 8 bytes written a
// read); K x ceil(bl / 32) words a read, ~8 integer operations a word.
//
// Design (planes). A read's first bl bytes become the same planes, four
// bytes at a time (upper-cased, the code (u >> 1) & 7, a __byte_perm
// lookup of the code's letter and a SWAR equality for the bytes outside
// ACGTN, which set a fourth "other" plane; one multiply gathers 8 bits of a
// plane), kept in registers. A barcode's mismatches over 32 positions are
// one popc of ((r0 ^ b0) | (r1 ^ b1) | (r2 ^ b2) | other) & mask: A, C, G,
// T and N have distinct codes, and an other byte mismatches every base. The
// set streams through shared memory in tiles of at most 48 KB (every
// thread of a group reading the same 16-byte word at once); the first
// minimum and whether another barcode reaches it are carried across tiles
// as the two least keys (count << 20 | barcode: three min/max a barcode,
// no branch). A read takes a group of G lanes (1 to 8, more for large sets
// and few reads), lane j the barcodes j, j + G, ...; the group's shuffles
// combine them.
//
// Design (bytes). A thread a read, __vcmpne4 and popc four bytes at a
// time: exact for any byte and any length. A set of at most 8 barcodes of
// at most 16 bases (the CLI's 4 x 8) is loaded into registers with the
// read's words, at once and with no barrier: a small set has no plane
// build to pay for; any other set reads every word from device memory
// (L1).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 48 * 1024;
constexpr int kMaxPlaneWords = 8;  // the planes layout: bl <= 256
constexpr int kMaxLanes = 8;
// the bytes layout's sets held in registers: at most this many barcodes
// (of up to 16 bases)
constexpr int kDirect = 8;
// a barcode's index in the low bits of a key, its count above them
constexpr int kIndexBits = 20;
// the letter of each 3-bit code: 0-3 'A' 'C' 'T' 'G', 4-6 none, 7 'N'
constexpr uint32_t kLetLo = 0x47544341u;
constexpr uint32_t kLetHi = 0x4EFFFFFFu;

struct Args {
  const uint8_t* seq;
  const int32_t* lengths;
  const uint32_t* words;
  int32_t* assign;
  int32_t* best;
  long long n;
  int L;
  int K;
  int bl;
  int W;      // words a barcode: 32 positions (planes) or 4 bytes (bytes)
  int max_mm;
  int gbits;  // log2 of the lanes a read
  int tile;   // barcodes a tile of shared memory
};

// 0xff in each byte where t == x
__device__ __forceinline__ uint32_t same_bytes(uint32_t t, uint32_t x) {
  const uint32_t z = t ^ x;
  const uint32_t hi = ~(((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z) & 0x80808080u;
  return (hi >> 7) * 0xffu;
}

// 4-bit codes of four bytes: bits 0-2 the code of the upper-cased byte,
// bit 3 set for a byte outside ACGTN
__device__ __forceinline__ uint32_t codes4(uint32_t x) {
  const uint32_t u = x & 0xDFDFDFDFu;
  const uint32_t c = (u >> 1) & 0x07070707u;
  const uint32_t sel = __byte_perm(c | (c >> 4), 0, 0x4420);
  const uint32_t in = same_bytes(__byte_perm(kLetLo, kLetHi, sel), u);
  return c | (~in & 0x08080808u);
}

// key1 <= key2, the two least keys seen
__device__ __forceinline__ void keep_two(uint32_t& key1, uint32_t& key2,
                                         uint32_t key) {
  key2 = min(key2, max(key1, key));
  key1 = min(key1, key);
}

// bit p of 8 codes (y = codes of positions 0-3 | codes of 4-7 << 4) as a
// byte, position t at bit t
__device__ __forceinline__ uint32_t plane_byte(uint32_t y, int p) {
  return (((y >> p) & 0x11111111u) * 0x01020408u) >> 24;
}

// bytes 4i .. 4i + 3 of a row, those past bl zero
__device__ __forceinline__ uint32_t read_word(const uint8_t* row, int i,
                                              int bl, bool aligned) {
  if (aligned && 4 * i + 4 <= bl)
    return __ldg(reinterpret_cast<const uint32_t*>(row) + i);
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * i + b < bl) x |= (uint32_t)__ldg(row + 4 * i + b) << (8 * b);
  return x;
}

// WMAX: a bound on the plane words a barcode (the read's in registers)
template <int WMAX>
__global__ void __launch_bounds__(kThreads) demux_planes_kernel(const Args a) {
  extern __shared__ uint4 sh[];  // a tile of barcodes, [tile][W]
  const int tid = threadIdx.x;
  const int G = 1 << a.gbits;
  const int sub = tid & (G - 1);
  const long long r =
      ((long long)blockIdx.x * kThreads + tid) >> a.gbits;
  const bool live = r < a.n;
  const uint4* set = reinterpret_cast<const uint4*>(a.words);
  uint32_t p0[WMAX], p1[WMAX], p2[WMAX], po[WMAX];
  bool short_read = true;
  if (live) {
    const uint8_t* row = a.seq + r * a.L;
    const bool aligned = ((uintptr_t)row & 3) == 0;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      p0[w] = p1[w] = p2[w] = po[w] = 0;
      if (w >= a.W) continue;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t y =
            codes4(read_word(row, 8 * w + 2 * m, a.bl, aligned)) |
            codes4(read_word(row, 8 * w + 2 * m + 1, a.bl, aligned)) << 4;
        p0[w] |= plane_byte(y, 0) << (8 * m);
        p1[w] |= plane_byte(y, 1) << (8 * m);
        p2[w] |= plane_byte(y, 2) << (8 * m);
        po[w] |= plane_byte(y, 3) << (8 * m);
      }
    }
    short_read = __ldg(a.lengths + r) < a.bl;
  }
  // the two least keys mm << kIndexBits | k: the first least count and
  // its barcode, and whether another barcode reaches it
  uint32_t key1 = UINT_MAX, key2 = UINT_MAX;
  for (int t0 = 0; t0 < a.K; t0 += a.tile) {
    const int tk = min(a.tile, a.K - t0);
    __syncthreads();  // the last tile read
    for (int i = tid; i < tk * a.W; i += kThreads)
      sh[i] = __ldg(set + (size_t)t0 * a.W + i);
    __syncthreads();
    if (!live || short_read) continue;
#pragma unroll 4
    for (int j = sub; j < tk; j += G) {
      const uint4* b = sh + j * a.W;
      uint32_t mm = 0;
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w >= a.W) break;
        const uint4 v = b[w];
        mm += __popc(((p0[w] ^ v.x) | (p1[w] ^ v.y) | (p2[w] ^ v.z) | po[w]) &
                     v.w);
      }
      keep_two(key1, key2, mm << kIndexBits | (uint32_t)(t0 + j));
    }
  }
  // the group's lanes
  for (int o = 1; o < G; o <<= 1) {
    const uint32_t o1 = __shfl_xor_sync(0xffffffffu, key1, o);
    const uint32_t o2 = __shfl_xor_sync(0xffffffffu, key2, o);
    keep_two(key1, key2, o1);
    key2 = min(key2, o2);
  }
  if (!live || sub) return;
  int best = (int)(key1 >> kIndexBits);
  int assign = best <= a.max_mm && (key2 >> kIndexBits) > (uint32_t)best
                   ? (int)(key1 & ((1u << kIndexBits) - 1))
                   : -1;
  if (short_read) {
    best = a.bl + 1;
    assign = a.K == 1 && best <= a.max_mm ? 0 : -1;
  }
  a.assign[r] = assign;
  a.best[r] = best;
}

// WMAX > 0: a set of at most kDirect barcodes of at most WMAX words, in
// registers with the read's words, loaded at once; 0: any set, every word
// from device memory (L1)
template <int WMAX>
__global__ void __launch_bounds__(kThreads) demux_bytes_kernel(const Args a) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  const uint8_t* row = a.seq + r * a.L;
  const bool aligned = ((uintptr_t)row & 3) == 0;
  const uint32_t* codes = a.words;
  const uint32_t* masks = a.words + (size_t)a.K * a.W;
  constexpr int D = WMAX > 0 ? kDirect : 1, WD = WMAX > 0 ? WMAX : 1;
  uint32_t dc[D][WD], dm[D][WD], up[WD];
  if (WMAX > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k)
#pragma unroll
      for (int i = 0; i < WD; ++i) {
        const bool in = k < a.K && i < a.W;
        dc[k][i] = in ? __ldg(codes + k * a.W + i) : 0u;
        dm[k][i] = in ? __ldg(masks + k * a.W + i) : 0u;
      }
#pragma unroll
    for (int i = 0; i < WD; ++i)
      up[i] = i < a.W ? read_word(row, i, a.bl, aligned) & 0xDFDFDFDFu : 0u;
  }
  int best = a.bl + 1, best_k = 0, ties = a.K;
  if (__ldg(a.lengths + r) >= a.bl) {
    best = INT_MAX;
    const auto keep = [&](int mm, int k) {
      if (mm < best) {
        best = mm;
        best_k = k;
        ties = 1;
      } else if (mm == best) {
        ++ties;
      }
    };
    if (WMAX > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k >= a.K) break;
        int bits = 0;
#pragma unroll
        for (int i = 0; i < WD; ++i)
          bits += __popc(__vcmpne4(up[i], dc[k][i]) & dm[k][i]);
        keep(bits >> 3, k);
      }
    } else {
      for (int k = 0; k < a.K; ++k) {
        int bits = 0;
        for (int i = 0; i < a.W; ++i)
          bits += __popc(
              __vcmpne4(read_word(row, i, a.bl, aligned) & 0xDFDFDFDFu,
                        __ldg(codes + (size_t)k * a.W + i)) &
              __ldg(masks + (size_t)k * a.W + i));
        keep(bits >> 3, k);
      }
    }
  }
  a.assign[r] = best <= a.max_mm && ties == 1 ? best_k : -1;
  a.best[r] = best;
}

template <int WMAX>
cudaError_t launch_planes(const Args& a, cudaStream_t s) {
  const size_t smem = (size_t)a.tile * a.W * sizeof(uint4);
  const long long threads = a.n << a.gbits;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  demux_planes_kernel<WMAX><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// words: int32 in the layout `planes` names (1: [K, ceil(bl / 32), 4],
// planes, only for bl <= 256 and every byte one of ACGTN; 0: [2, K,
// ceil(bl / 4)], bytes), as above. n < 2^31 (n == 0 launches nothing),
// 0 <= bl <= L, K >= 1 (planes: K <= 2^20).
extern "C" int bs_demux_assign(const uint8_t* seq, const int32_t* lengths,
                               const uint32_t* words, int32_t* assign,
                               int32_t* best, long long n, int L, int K,
                               int bl, int max_mm, int planes, void* stream) {
  if (n < 0 || n >= (1LL << 31) || K < 1 || bl < 0 || bl > L ||
      (planes && (bl > 32 * kMaxPlaneWords || K > (1 << kIndexBits))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  Args a{seq, lengths, words, assign, best, n, L, K, bl, 0, max_mm, 0, 0};
  if (!planes) {
    a.W = (bl + 3) / 4;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (K <= kDirect && a.W <= 2)
      demux_bytes_kernel<2><<<blocks, kThreads, 0, s>>>(a);
    else if (K <= kDirect && a.W <= 4)
      demux_bytes_kernel<4><<<blocks, kThreads, 0, s>>>(a);
    else
      demux_bytes_kernel<0><<<blocks, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  a.W = (bl + 31) / 32;
  a.tile = kTileBytes / (int)sizeof(uint4) / (a.W > 0 ? a.W : 1);
  if (a.tile > K) a.tile = K;
  // more lanes a read for a large set, while the reads leave the card
  // room (each lane at least 16 barcodes)
  while ((1 << a.gbits) < kMaxLanes && K >= (16 << a.gbits) &&
         (n << a.gbits) < (1LL << 18))
    ++a.gbits;
  if (a.W <= 1) return (int)launch_planes<1>(a, s);
  if (a.W <= 2) return (int)launch_planes<2>(a, s);
  if (a.W <= 4) return (int)launch_planes<4>(a, s);
  return (int)launch_planes<kMaxPlaneWords>(a, s);
}
