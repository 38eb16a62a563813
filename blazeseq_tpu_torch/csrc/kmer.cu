// k-mer spectrum of a padded batch for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/kmer.py::kmer_counts (l.30-63), XLA code with no
// Pallas kernel (rolling codes, then a sort and a searchsorted); its plain
// torch version (ops/kmer.py::kmer_counts_torch) takes ~52 launches and [n, L]
// int32 intermediates a call. Here one launch and no fill.
//
// Inputs: seq u8[n, L] (row-major, contiguous), lengths i32[n], the row count
// n_valid (a host value, or an int32 / int64 scalar on the card). Output: out
// int32 [4^k], every bin written, 1 <= k <= 8. A window [j, j + k) of row r
// counts in bin Sum_t code(seq[r, j + t]) 4^(k-1-t) when r < n_valid, j + k <=
// min(lengths[r], L), and each of its bytes is one of ACGTacgt (code: A 0, C
// 1, G 2, T 3).
//
// Bound: device-memory bytes (each row read once up to its length, the bins
// written once); a few integer operations a byte.
//
// Design. A lane takes a 16-byte piece of a row (one 16-byte load, the next
// piece's load in flight while this one is counted), a warp 32 consecutive
// pieces. Decoding is four bytes at a time: upper-case by & 0xDF, the code ((u
// >> 1) ^ (u >> 2)) & 3 (A 0, C 1, G 2, T 3), the byte valid where it equals
// the letter of its code (a __byte_perm lookup, a SWAR equality, a multiply
// gathering the four high bits); the lane's 16 codes packed into one word
// (first base highest) and its validity into 16 bits, cut at the row's length.
// The k - 1 halo codes and bits come from the next lane by a shuffle: a warp
// counts 31 pieces, its lane 31 loading the next piece for lane 30's halo. A
// window is valid where the bits hold a run of k (k - 1 shift-ANDs); its code
// is one funnel shift of the lane's codes, and every window is one shared-
// memory reduction with no branch (an invalid one adds to a spare word of its
// lane). A lane whose 16 windows are one base (a homopolymer, such as a poly-G
// tail) adds 16 to its bin once.
//
// Bins. k <= 7: in shared memory a block, a copy a warp where 64 KiB holds it
// (k <= 5; k = 6 four copies, k = 7 one), and for k <= 2 a copy a lane, so
// that four or sixteen bins take no bank conflict. k = 8: the 65,536 bins (256
// KiB) are spread over a thread-block cluster of 2 blocks of 1,024 threads
// (128 KiB each), and no window touches device memory. A window's atomic into
// another block's shared memory costs several local ones on the H100, so the
// blocks exchange the decoded pieces instead: in each round a block stages its
// lanes' packed pieces (codes and valid windows, 8 bytes) in shared memory,
// arrives at the cluster barrier, counts its own pieces' windows of its bins,
// waits, and reads the other blocks' staged pieces through distributed shared
// memory (mapa, ld.shared::cluster) to count their windows of its bins; stages
// alternate between two buffers.
//
// No fill. With one bin owner (a block, or a k = 8 cluster) it stores its
// bins into out. Otherwise every block takes a start ticket as it begins
// (one 64-bit atomic on a kept word: the launch's generation, then the
// blocks started); the first block to start zeroes out and publishes the
// generation, and every owner adds its nonzero bins into out with one
// atomic a bin once it reads it. A block waits only on one that has
// started, as a decoupled look-back orders its tiles by a ticket taken at
// the start, so no launch depends on its blocks being resident at once;
// the last block to start moves the word to the next generation. The grid
// gives a lane a piece (a cluster's lane half a piece), with at most as
// many owners as the card holds at once. Byte path (L % 16 != 0, or seq off
// 16-byte alignment): the piece's bytes one at a time.
//
// Measurement switches, which the library is built without (kernel_bench.py
// --only kmer_k8 builds this file alone with them): BS_KMER_OWNERS fixes
// the bin owners a launch; BS_KMER_SKIP drops work, leaving the counts
// wrong: 1 the other blocks' pieces (k = 8), 2 the rounds' cluster
// barriers (k = 8), 4 the flush into out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#ifndef BS_KMER_SKIP
#define BS_KMER_SKIP 0
#endif
#ifndef BS_KMER_OWNERS
#define BS_KMER_OWNERS 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;          // a block, k <= 7
constexpr int kClusterThreads = 1024;  // a block of a cluster, k = 8
constexpr int kCluster = 2;            // k = 8's blocks a cluster
constexpr int kBinBytes = 64 * 1024;   // sub-histograms' shared memory
constexpr int kMaxDevices = 64;
// 'A' 'C' 'G' 'T': the letter of each 2-bit code
constexpr uint32_t kLetters = 0x54474341u;

struct Args {
  const uint8_t* seq;
  const int32_t* lengths;
  const void* n_valid_ptr;  // null: n_valid below
  int n_valid_bytes;        // 4 or 8
  long long n_valid;
  int* out;                 // int32 [4^k]
  // [0]: the generation << 32 | the blocks started; [1]: the last
  // generation whose out is zero, + 1
  unsigned long long* state;
  long long n;
  int L;
  int segs;                 // 16-column pieces a row
  int vec;                  // 16-byte loads
};

// Sub-histograms of a block (k <= 7): WC warp groups, as many as
// kBinBytes holds (16 for k <= 5, 4 for k = 6, 1 for k = 7), each of LC
// lane copies for k <= 2 (32: four or sixteen bins take no bank
// conflict), else 1.
__host__ __device__ constexpr int max_copies(int k) {
  return (kBinBytes >> (2 * k + 2)) >= 1 ? (kBinBytes >> (2 * k + 2)) : 1;
}
__host__ __device__ constexpr int warp_copies(int k) {
  return max_copies(k) < kThreads / 32 ? max_copies(k) : kThreads / 32;
}
__host__ __device__ constexpr int lane_copies(int k) {
  return k > 2 ? 1 : 32;
}

// dynamic shared memory: the bins (and a cluster block's stages), then a
// spare word a lane
template <int K, int CS>
constexpr size_t smem_bytes() {
  return CS > 1 ? ((size_t)(1 << (2 * K)) / CS + 32) * sizeof(int) +
                      2 * kClusterThreads * sizeof(uint2)
                : ((size_t)warp_copies(K) * lane_copies(K) * (1 << (2 * K)) +
                   32) *
                      sizeof(int);
}

// Four bytes: their codes as one byte (the first highest) and their
// validity as four bits (the first lowest).
__device__ __forceinline__ void decode4(uint32_t w, uint32_t& codes,
                                        uint32_t& valid) {
  const uint32_t u = w & 0xDFDFDFDFu;
  const uint32_t c = ((u >> 1) ^ (u >> 2)) & 0x03030303u;
  const uint32_t sel = __byte_perm(c | (c >> 4), 0, 0x4420);
  const uint32_t z = __byte_perm(kLetters, 0, sel) ^ u;
  const uint32_t eq = ~(((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z) & 0x80808080u;
  valid = (eq * 0x00204081u) >> 28;
  codes = (c * 0x40100401u) >> 24;
}

// 16 bytes: codes (position 0 at bits 30-31) and validity (position p at
// bit p)
__device__ __forceinline__ void decode16(const uint32_t (&w)[4],
                                         uint32_t& codes, uint32_t& valid) {
  codes = valid = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t c, v;
    decode4(w[i], c, v);
    codes |= c << (24 - 8 * i);
    valid |= v << (4 * i);
  }
}

// the bytes [c, c + 16) of a row below `lim` (any alignment)
__device__ __forceinline__ void load_bytes(const uint8_t* row, int c, int lim,
                                           uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c + i < lim)
      w[i >> 2] |= (uint32_t)__ldg(row + c + i) << (8 * (i & 3));
}

// shared memory [addr] += v (a shared::cta address), with no branch
__device__ __forceinline__ void add_at(uint32_t addr, uint32_t v) {
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

// A lane's piece: 16 bytes from column c0 of a row, and its length
struct Piece {
  uint32_t w[4];
  int len;
  int c0;
};

// The lane's piece, packed: .x its 16 codes
// (position 0 highest), .y the next 8 positions' codes in the top half
// (the halo, from the next lane) and its valid windows in the low 16 bits
// (none in lane 31, whose piece is the halo of lane 30 and is counted by
// the next warp's lane 0). Every lane of the warp calls it (shuffles).
template <int K>
__device__ __forceinline__ uint2 pack(const Args& a, const Piece& p,
                                      int lane) {
  uint32_t codes, valid;
  decode16(p.w, codes, valid);
  const int left = min(max(p.len, 0), a.L) - p.c0;  // the row's, from c0
  valid &= left >= 16 ? 0xffffu : left > 0 ? (1u << left) - 1 : 0u;
  const uint32_t hc = __shfl_down_sync(0xffffffffu, codes, 1) >> 16;
  const uint32_t hv = __shfl_down_sync(0xffffffffu, valid, 1) & 0xffu;
  // positions 0-23 (the halo's cut at the row's length), windows 0-15
  const uint32_t V = (valid | hv << 16) &
                     (left >= 24 ? 0xffffffu : left > 0 ? (1u << left) - 1
                                                        : 0u);
  uint32_t wv = lane == 31 ? 0u : V;
#pragma unroll
  for (int t = 1; t < K; ++t) wv &= V >> t;
  return make_uint2(codes, hc << 16 | (wv & 0xffffu));
}

// The windows of a packed piece whose bins lie in [first, first + NB),
// each added at mine + (bin - first) << SHIFT (shared::cta addresses);
// the others, and invalid windows, at spare. A piece of one base
// throughout (a homopolymer) adds its 16 windows at once.
template <int K, uint32_t NB, int SHIFT>
__device__ __forceinline__ void add_windows(uint2 e, uint32_t first,
                                            uint32_t mine, uint32_t spare) {
  constexpr uint32_t kBins = 1u << (2 * K);
  // positions 0-15 in hi, 16-23 in lo's top half: window i's code is
  // bits 2 (32 - i - K) of hi:lo
  const uint32_t hi = e.x, lo = e.y & 0xffff0000u, wv = e.y & 0xffffu;
  const uint32_t rep = (hi >> 30) * 0x55555555u;
  constexpr uint32_t kHalo = (0xffff0000u << (18 - 2 * K));
  const bool run = wv == 0xffffu && hi == rep && (lo & kHalo) == (rep & kHalo);
  const uint32_t add = run ? 1u : wv;
  const uint32_t v = run ? 16u : 1u;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int sh = 2 * (32 - i - K);
    const uint32_t code =
        (sh >= 32 ? hi >> (sh - 32) : __funnelshift_r(lo, hi, sh)) &
        (kBins - 1);
    const uint32_t rel = code - first;
    const bool ok = ((add >> i) & 1) && (NB == kBins || rel < NB);
    add_at(ok ? mine + (rel << SHIFT) : spare, v);
  }
}

// The row count, from the card or from the host
__device__ __forceinline__ long long row_count(const Args& a) {
  long long n_valid = a.n_valid;
  if (a.n_valid_ptr)
    n_valid = a.n_valid_bytes == 8
                  ? *static_cast<const long long*>(a.n_valid_ptr)
                  : *static_cast<const int*>(a.n_valid_ptr);
  return min(n_valid, a.n);
}

// Thread 0 of every block, as it begins (owners > 1): its start ticket;
// whether it is the first to start into `zeroer`, the generation into
// `gen`
__device__ __forceinline__ void start(const Args& a, int owners,
                                      bool& zeroer, unsigned& gen) {
  const unsigned blocks = gridDim.x;
  if (owners == 1 || threadIdx.x != 0) return;
  const unsigned long long t = atomicAdd(a.state, 1ull);
  if ((unsigned)t == blocks - 1)  // every block has its ticket
    atomicAdd(a.state, (1ull << 32) - blocks);
  zeroer = (unsigned)t == 0;
  gen = (unsigned)(t >> 32);
}

// The first block to start: out zeroed, then its generation published
__device__ __forceinline__ void zero_out(const Args& a, bool zeroer,
                                         unsigned gen, int bins,
                                         int threads) {
  if (!zeroer) return;
  for (int i = threadIdx.x; i < bins; i += threads) a.out[i] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(a.state + 1),
                 "r"(gen + 1)
                 : "memory");
}

// Thread 0 waits for out of its generation to be zero, then the block's
// threads go on
__device__ __forceinline__ void await_zero(const Args& a, int owners,
                                           unsigned gen) {
  if (owners == 1) return;
  if (threadIdx.x == 0) {
    uint32_t f;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(f)
                   : "l"(a.state + 1)
                   : "memory");
    } while (f != gen + 1);
  }
  __syncthreads();
}

// An owner's count of bin i: stored with one owner, else added into out
// (nonzero only)
__device__ __forceinline__ void put_bin(const Args& a, int owners, int i,
                                        int v) {
  if (owners == 1)
    a.out[i] = v;
  else if (v && !(BS_KMER_SKIP & 4))
    atomicAdd(a.out + i, v);
}

// A lane's pieces: from `item` on, `stride` apart; row and piece advance
// by (dr, ds)
struct Walk {
  const uint8_t* row;
  const int32_t* len;
  int s, ds;
  long long dr;

  __device__ __forceinline__ Walk(const Args& a, long long item,
                                  long long stride) {
    const long long r = item / a.segs;
    s = (int)(item - r * a.segs);
    dr = stride / a.segs;
    ds = (int)(stride - dr * a.segs);
    row = a.seq + r * a.L;
    len = a.lengths + r;
  }
  __device__ __forceinline__ void next(const Args& a) {
    s += ds;
    row += dr * a.L;
    len += dr;
    if (s >= a.segs) {
      s -= a.segs;
      row += a.L;
      ++len;
    }
  }
};

// Loads a lane's piece (none where `live` is false)
__device__ __forceinline__ void fetch(const Args& a, bool live,
                                      const Walk& at, Piece& p) {
  p.w[0] = p.w[1] = p.w[2] = p.w[3] = 0;
  p.len = 0;
  p.c0 = 16 * at.s;
  if (!live) return;
  p.len = __ldg(at.len);
  if (a.vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(at.row + p.c0));
    p.w[0] = v.x;
    p.w[1] = v.y;
    p.w[2] = v.z;
    p.w[3] = v.w;
  } else {
    load_bytes(at.row, p.c0, a.L, p.w);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2) kmer_kernel(const Args a) {
  constexpr uint32_t kBins = 1u << (2 * K);
  constexpr int WC = warp_copies(K), LC = lane_copies(K);
  constexpr int kLcBits = LC == 32 ? 5 : LC == 16 ? 4 : LC == 8 ? 3
                          : LC == 4 ? 2 : LC == 2 ? 1 : 0;
  // WC x kBins x LC sub-histogram words (bin b of copy (g, l) at
  // (g kBins + b) LC + l), then 32 spare words
  extern __shared__ int bins[];
  __shared__ bool zeroer;
  __shared__ unsigned gen;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  start(a, gridDim.x, zeroer, gen);
  for (int i = tid; i < WC * (int)kBins * LC; i += kThreads) bins[i] = 0;
  __syncthreads();
  zero_out(a, gridDim.x > 1 && zeroer, gen, kBins, kThreads);
  const uint32_t mine = (uint32_t)__cvta_generic_to_shared(
      bins + (warp % WC) * (int)kBins * LC + (lane & (LC - 1)));
  const uint32_t spare =
      (uint32_t)__cvta_generic_to_shared(bins + WC * (int)kBins * LC + lane);

  const long long rows = row_count(a);
  const long long items = rows > 0 ? rows * a.segs : 0;
  // a warp counts 31 consecutive pieces (lane 31 loads the next one for
  // lane 30's halo), then strides over the grid's
  const long long stride = (long long)gridDim.x * (kThreads / 32) * 31;
  const long long first =
      ((long long)blockIdx.x * (kThreads / 32) + warp) * 31;
  Walk at(a, first + lane, stride);
  Piece cur;
  fetch(a, first + lane < items, at, cur);
  for (long long base = first; base < items; base += stride) {
    at.next(a);
    Piece nxt;
    fetch(a, base + stride + lane < items, at, nxt);
    add_windows<K, kBins, 2 + kLcBits>(pack<K>(a, cur, lane), 0, mine, spare);
    cur = nxt;
  }

  __syncthreads();
  await_zero(a, gridDim.x, gen);
  for (int i = tid; i < (int)kBins; i += kThreads) {
    int v = 0;
#pragma unroll
    for (int g = 0; g < WC; ++g)
#pragma unroll
      for (int l = 0; l < LC; ++l) v += bins[(g * (int)kBins + i) * LC + l];
    put_bin(a, gridDim.x, i, v);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// k = 8 over a cluster of CS blocks, block q holding bins [q NB, q NB +
// NB). Round t: block q of cluster c takes the pieces (t C + c) CS T +
// q T + tid (C clusters of CS blocks of T threads).
template <int K, int CS>
__global__ void __launch_bounds__(kClusterThreads, 1)
    kmer_cluster_kernel(const Args a) {
  constexpr uint32_t kBins = 1u << (2 * K);
  constexpr uint32_t NB = kBins / CS;
  constexpr int T = kClusterThreads;
  // NB bins, 32 spare words, then two stages of T packed pieces
  extern __shared__ int bins[];
  __shared__ bool zeroer;
  __shared__ unsigned gen;
  uint2* stage = reinterpret_cast<uint2*>(bins + NB + 32);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t q = cluster.block_rank();
  const int owners = gridDim.x / CS;
  start(a, owners, zeroer, gen);
  for (int i = tid; i < (int)NB; i += T) bins[i] = 0;
  cluster.sync();  // every block's bins zeroed
  zero_out(a, owners > 1 && zeroer, gen, kBins, T);
  const uint32_t mine = (uint32_t)__cvta_generic_to_shared(bins);
  const uint32_t spare = (uint32_t)__cvta_generic_to_shared(bins + NB + lane);
  const uint32_t stage0 = (uint32_t)__cvta_generic_to_shared(stage + tid);

  const long long rows = row_count(a);
  const long long items = rows > 0 ? rows * a.segs : 0;
  // a warp counts 31 pieces a round (as kmer_kernel's)
  const long long cstride = (long long)CS * (T / 32) * 31;  // a cluster's
  const long long stride = (long long)gridDim.x * (T / 32) * 31;
  const long long cfirst = (long long)(blockIdx.x / CS) * cstride;
  const long long first = cfirst + (q * (T / 32) + warp) * 31;
  Walk at(a, first + lane, stride);
  Piece cur;
  fetch(a, first + lane < items, at, cur);
  int buf = 0;
  // the cluster's blocks run the same rounds
  for (long long base = cfirst; base < items; base += stride, buf ^= 1) {
    at.next(a);
    Piece nxt;
    fetch(a, base - cfirst + first + stride + lane < items, at, nxt);
    const uint2 e = pack<K>(a, cur, lane);
    stage[buf * T + tid] = e;
    if (!(BS_KMER_SKIP & 2)) cluster_arrive();
    add_windows<K, NB, 2>(e, q * NB, mine, spare);
    if (!(BS_KMER_SKIP & 2)) cluster_wait();  // every block's stage written
#pragma unroll
    for (int d = 1; d < CS && !(BS_KMER_SKIP & 1); ++d) {
      const uint32_t r = (q + d) % CS;
      uint2 o;
      asm volatile(
          "{\n\t.reg .b32 ra;\n\tmapa.shared::cluster.u32 ra, %2, %3;\n\t"
          "ld.shared::cluster.v2.u32 {%0, %1}, [ra];\n\t}"
          : "=r"(o.x), "=r"(o.y)
          : "r"(stage0 + buf * T * (uint32_t)sizeof(uint2)), "r"(r)
          : "memory");
      add_windows<K, NB, 2>(o, q * NB, mine, spare);
    }
    cur = nxt;
  }
  cluster.sync();  // every stage read and every window added
  await_zero(a, owners, gen);
  for (int i = tid; i < (int)NB; i += T)
    put_bin(a, owners, q * NB + i, bins[i]);
}

// The opt-in to more than 48 KB of shared memory, once a device and
// kernel, and the bin owners (blocks, or clusters) the card holds at once
template <int K, int CS>
cudaError_t capacity(int sm_count, int* owners) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*owners = known[dev].load()) > 0)
    return cudaSuccess;
  const size_t smem = smem_bytes<K, CS>();
  const void* fn = CS > 1 ? (const void*)kmer_cluster_kernel<K, CS>
                          : (const void*)kmer_kernel<K>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (CS == 1) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
    *owners = per_sm * sm_count;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(CS);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(owners, fn, &cfg);
  }
  if (e != cudaSuccess) return e;
  if (*owners < 1) *owners = 1;
  if (dev < kMaxDevices) known[dev].store(*owners);
  return cudaSuccess;
}

template <int K, int CS>
cudaError_t launch(const Args& a, long long rows, int sm_count,
                   cudaStream_t s) {
  int cap = 0;
  cudaError_t e = capacity<K, CS>(sm_count, &cap);
  if (e != cudaSuccess) return e;
  // a lane a piece at least (a cluster's lane half a piece: twice the
  // clusters halve each one's flush, 7% off k = 8 at 4,096 x 256 on the
  // H100), and no more bin owners than the card holds at once (each adds
  // its bins once)
  const int threads = CS > 1 ? kClusterThreads / 2 : kThreads;
  long long owners = (rows * a.segs + (long long)threads * CS - 1) /
                     ((long long)threads * CS);
  if (owners > cap) owners = cap;
  if (owners < 1) owners = 1;
  if (BS_KMER_OWNERS > 0) owners = BS_KMER_OWNERS;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(owners * CS));
  cfg.blockDim = dim3(CS > 1 ? kClusterThreads : kThreads);
  cfg.dynamicSmemBytes = smem_bytes<K, CS>();
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  if constexpr (CS > 1)
    e = cudaLaunchKernelEx(&cfg, kmer_cluster_kernel<K, CS>, a);
  else
    e = cudaLaunchKernelEx(&cfg, kmer_kernel<K>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// out: int32 [4^k], every bin written. state: two uint64 on the card, zero
// before the first launch, which each launch leaves ready for the next (a
// stream's launches share it; another stream takes its own). The row
// count is *n_valid_ptr (n_valid_bytes 4 or 8) when n_valid_ptr is not
// null, else n_valid. 1 <= k <= 8, n < 2^40 rows, n >= 1 and L >= 1.
extern "C" int bs_kmer_counts(const uint8_t* seq, const int32_t* lengths,
                              const void* n_valid_ptr, int n_valid_bytes,
                              long long n_valid, int* out,
                              unsigned long long* state, long long n, int L,
                              int k, int sm_count, void* stream) {
  if (n < 1 || n >= (1LL << 40) || L < 1 || k < 1 || k > 8 ||
      sm_count < 1 ||
      (n_valid_ptr && n_valid_bytes != 4 && n_valid_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const Args a{seq, lengths, n_valid_ptr, n_valid_bytes, n_valid, out,
               state, n, L, (L + 15) / 16,
               L % 16 == 0 && ((uintptr_t)seq & 15) == 0};
  // a known row count caps the grid; a count on the card is read there
  const long long rows =
      n_valid_ptr || n_valid > n ? n : n_valid < 0 ? 0 : n_valid;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return (int)launch<1, 1>(a, rows, sm_count, s);
    case 2: return (int)launch<2, 1>(a, rows, sm_count, s);
    case 3: return (int)launch<3, 1>(a, rows, sm_count, s);
    case 4: return (int)launch<4, 1>(a, rows, sm_count, s);
    case 5: return (int)launch<5, 1>(a, rows, sm_count, s);
    case 6: return (int)launch<6, 1>(a, rows, sm_count, s);
    case 7: return (int)launch<7, 1>(a, rows, sm_count, s);
    default: return (int)launch<8, kCluster>(a, rows, sm_count, s);
  }
}
