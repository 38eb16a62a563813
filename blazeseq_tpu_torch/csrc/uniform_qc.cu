// One-pass uniform-layout FASTQ parse + validate + QC for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/fused_qc.py::fused_uniform_qc
// (body _kernel_body) and serves the contract of the XLA step
// blazeseq_tpu/ops/uniform_qc.py::uniform_qc (the torch epilogue in
// blazeseq_tpu_torch/ops/uniform_qc.py folds the eq-mode histogram).
//
// Input: a chunk u8[nrec, rs] of fixed-layout records (16-byte aligned);
// rows at or beyond nrec_valid are the zero padding of a partial chunk and
// are skipped. Per valid row, over the full row:
//   template proof: '\n' exactly at columns o1, o2, o3, rs-1; '@' at column
//   0; '+' at column o2+1; with check_ascii every byte <= 127; with
//   check_quality every quality byte (columns [o3+1, rs-1)) in [q_lo, q_hi].
//   A row failing any check adds 1 to bad[0].
// Over the stats window of cnt = min(seq_len, width) columns:
//   csb[k*cnt + p]  A/C/G/T counts at position p (case-folded by & 0xDF)
//   csq[p]          sum of clip(q - offset, 0, 63)
//   qh[64]          histogram of clip(q - offset, 0, 63)
//   gch[101]        reads by (200*gc + cnt) / (2*cnt)
//   mqh[64]         reads by min((2*qsum + cnt) / (2*cnt), 63)
// Outputs are zeroed by the caller and every count is an integer sum, so the
// result is the same whatever order the blocks run in.
//
// Bound: device-memory bytes (each chunk byte is read once; KB of counters
// are written). Design:
// * A persistent grid (as many blocks as fit on the card at once) walks the
//   chunk in tiles of R rows, each one contiguous span of R * rs bytes with
//   R chosen so that every span starts 16-byte aligned. One thread stages
//   tiles into a ring of kStages shared-memory buffers with bulk
//   asynchronous copies (cp.async.bulk, the 1-D TMA), each completing on
//   its own mbarrier, so the next tiles are in flight while the block works
//   on one. The rows past the last whole tile are loaded by one block with
//   plain loads.
// * The newline proof is taken per tile, not per row: all threads count
//   the tile's newlines and OR its bytes in 16-byte words. When every row
//   has its four fixed newlines, '@' and '+' in place and in-range quality
//   bytes, and the tile holds exactly 4 * R newlines (and no high bit under
//   check_ascii), no row can hold another newline and the tile is clean.
//   The fixed and quality bytes' verdicts are ORed per lane over the tile's
//   rows and voted once per tile. Any other tile (never a clean file's) is
//   judged again row by row, every byte.
// * One warp per row. Lane l owns the window positions p = l + 32k (k < P)
//   for the whole run. Two 256-entry tables in shared memory turn a byte
//   into its counts: a base into one add of a packed word of four 8-bit
//   A/C/G/T counters, a quality byte into its clipped Phred value and its
//   range verdict. The packed counters are flushed into 32-bit sums every
//   255 rows (and at the end); Phred sums stay in 32-bit registers. No
//   per-byte shared atomics on shared counters.
// * The Phred histogram is privatised per lane: 16-bit counters, two bins a
//   word, laid out [bin / 2][lane] so that each lane owns one bank (no
//   conflicts whatever the values, binned corpora included), flushed with
//   the packed counters. Updates are fire-and-forget shared atomics, so no
//   chain of dependent loads and stores runs through a row.
// * The per-read GC count and Phred sum come from one warp reduction of a
//   packed word; their bins divide by 2 * cnt with a multiply-high by a
//   reciprocal made on the host (exact for these numerators).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kMaxPhred = 64;
constexpr int kGcBins = 101;
constexpr int kTileTarget = 12 * 1024;  // bytes per staged tile, about
constexpr int kFlushRows = 255;  // rows an 8-bit packed counter can take
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bit 7 of each byte of the result: that byte of w is '\n'
__device__ __forceinline__ uint32_t newline_bytes(uint32_t w) {
  const uint32_t z = w ^ 0x0A0A0A0Au;
  return ~(((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z | 0x7F7F7F7Fu);
}

struct Layout {
  int rs, o1, o2, o3, cnt, q_lo, q_hi, offset, check_ascii, check_quality;
  unsigned recip;  // ceil(2^32 / (2 * cnt))
};

// rows per tile: the least multiple of 16 / gcd(rs, 16) (so that every
// tile's span starts 16-byte aligned), grown towards kTileTarget bytes
int tile_rows(int rs) {
  int g = 16;
  while (rs % g) g >>= 1;
  const int align = 16 / g;
  const long long per = (long long)align * rs;
  const long long k = per >= kTileTarget ? 1 : kTileTarget / per;
  return (int)(align * k);
}

// shared memory of one block, in bytes: mbarriers and tile counters, the
// tile ring, the per-lane histograms, the two tables and the block's panel
// sums
long long smem_bytes(int rs, int cnt) {
  const long long tile = (long long)tile_rows(rs) * rs;
  return 128 + kStages * tile + (long long)kWarps * 32 * 32 * 4 + 256 * 4 +
         256 + (5LL * cnt + 2 * kMaxPhred + kGcBins + 1) * 4;
}

// The packed counters and the lanes' histograms into the block's sums.
template <int P>
__device__ __forceinline__ void flush(const Layout& L, int lane,
                                      uint32_t acgt[P],
                                      uint32_t* __restrict__ hist,
                                      int32_t* s_pos, int32_t* s_qh) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = lane + 32 * k;
    if (p < L.cnt && acgt[k]) {
      atomicAdd(s_pos + p, (int)(acgt[k] & 0xff));
      atomicAdd(s_pos + L.cnt + p, (int)((acgt[k] >> 8) & 0xff));
      atomicAdd(s_pos + 2 * L.cnt + p, (int)((acgt[k] >> 16) & 0xff));
      atomicAdd(s_pos + 3 * L.cnt + p, (int)(acgt[k] >> 24));
    }
    acgt[k] = 0;
  }
  for (int b = 0; b < kMaxPhred / 2; ++b) {
    const uint32_t v = hist[b * 32];
    const unsigned lo = __reduce_add_sync(kFull, v & 0xffffu);
    const unsigned hi = __reduce_add_sync(kFull, v >> 16);
    hist[b * 32] = 0;
    if (lane == 0) {
      if (lo) atomicAdd(s_qh + 2 * b, (int)lo);
      if (hi) atomicAdd(s_qh + 2 * b + 1, (int)hi);
    }
  }
}

// The byte each lane checks in every row: lanes 0-5 one of the four fixed
// newlines, the '@' and the '+'; the other lanes repeat lane 4's check.
__device__ __forceinline__ void fixed_byte(const Layout& L, int lane,
                                           int* col, int* want) {
  *col = lane == 0 ? L.o1 : lane == 1 ? L.o2 : lane == 2 ? L.o3
       : lane == 3 ? L.rs - 1 : lane == 5 ? L.o2 + 1 : 0;
  *want = lane < 4 ? '\n' : lane == 5 ? '+' : '@';
}

// The lane's fixed byte and its quality bytes from column `from` of the
// quality line on (the stats pass checks those before `from`); bit 7 of the
// result is set where one fails.
__device__ __forceinline__ unsigned row_bytes_flag(
    const uint8_t* __restrict__ row, const Layout& L, int lane, int fcol,
    int fwant, const uint8_t* __restrict__ s_ph, int from) {
  unsigned flag = row[fcol] != fwant ? 0x80u : 0u;
  if (L.check_quality) {
    const uint8_t* qual = row + L.o3 + 1;
    for (int p = from + lane; p < L.rs - 2 - L.o3; p += 32)
      flag |= s_ph[qual[p]];
  }
  return flag;
}

// The window panels of one staged row and its per-row bins; returns this
// lane's verdict on its window quality bytes, its quality bytes past the
// window and its fixed byte (bit 7 set: one fails). The newline count and
// the high bits are the tile's business.
template <int P>
__device__ __forceinline__ unsigned row_panels(
    const uint8_t* __restrict__ row, const Layout& L, int lane, int fcol,
    int fwant, uint32_t acgt[P], int cq[P], uint32_t* __restrict__ hist,
    const uint32_t* __restrict__ s_inc, const uint8_t* __restrict__ s_ph,
    int32_t* s_gch, int32_t* s_mqh) {
  const uint8_t* seq = row + L.o1 + 1;
  const uint8_t* qual = row + L.o3 + 1;
  uint32_t row_inc = 0;  // this lane's A/C/G/T counts in this row
  unsigned qs = 0;
  unsigned flag = row_bytes_flag(row, L, lane, fcol, fwant, s_ph, L.cnt);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = lane + 32 * k;
    if (p < L.cnt) {
      const uint32_t inc = s_inc[seq[p] & 0xDF];
      acgt[k] += inc;
      row_inc += inc;
      const unsigned t = s_ph[qual[p]];
      const int ph = t & 63;
      flag |= t;
      cq[k] += ph;
      qs += ph;
      atomicAdd(hist + (ph >> 1) * 32, 1u << ((ph & 1) << 4));
    }
  }
  // the row's C + G count and Phred sum in one reduction: at most 512
  // and 512 * 63 over the warp, so each fits its 16 bits
  const unsigned both = __reduce_add_sync(
      kFull, ((((row_inc >> 8) & 0xff) + ((row_inc >> 16) & 0xff)) << 16) |
                 qs);
  if (lane < 2) {
    // lane 0 bins the GC share, lane 1 the mean quality
    const unsigned num = lane == 0 ? 200 * (both >> 16) + L.cnt
                                   : 2 * (both & 0xffff) + L.cnt;
    const unsigned bin = __umulhi(num, L.recip);
    atomicAdd(lane == 0 ? s_gch + bin
                        : s_mqh + min(bin, (unsigned)(kMaxPhred - 1)),
              1);
  }
  return flag;
}

// The exact newline count and high bits of one row over its aligned 32-bit
// words (the judgement of a tile that is not clean); true if the row fails.
__device__ __forceinline__ bool row_newlines_bad(const uint8_t* tile,
                                                 int row_off, const Layout& L,
                                                 int lane) {
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(tile);
  const int end = row_off + L.rs;
  int nl = 0;
  uint32_t high = 0;
  for (int wi = (row_off >> 2) + lane; wi < (end + 3) >> 2; wi += 32) {
    const uint32_t w = w32[wi];
    const int lo = row_off - 4 * wi;  // bytes of the row start at this one
    const int hi = end - 4 * wi;      // and end before this one
    uint32_t m = kFull;
    if (lo > 0) m &= kFull << (8 * lo);
    if (hi < 4) m &= kFull >> (8 * (4 - hi));
    nl += __popc(newline_bytes(w) & m);
    high |= w & m;
  }
  nl = __reduce_add_sync(kFull, nl);
  const bool hb = __any_sync(kFull, (high & 0x80808080u) != 0);
  return nl != 4 || (L.check_ascii && hb);
}

template <int P>
__global__ void __launch_bounds__(kThreads, 4)
uniform_qc_kernel(const uint8_t* __restrict__ chunk, long long nrec_valid,
                  Layout L, int R, int32_t* __restrict__ bad_out,
                  int32_t* __restrict__ csq_out, int32_t* __restrict__ csb_out,
                  int32_t* __restrict__ qh_out, int32_t* __restrict__ gch_out,
                  int32_t* __restrict__ mqh_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile_bytes = R * L.rs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // per tile (i % kStages): newline count, and flags (1: a row failed its
  // fixed or quality bytes, 2: a high bit)
  int32_t* s_tnl = reinterpret_cast<int32_t*>(smem + 64);
  int32_t* s_tflag = s_tnl + kStages;
  uint8_t* ring = smem + 128;
  uint32_t* s_hist = reinterpret_cast<uint32_t*>(ring + kStages * tile_bytes);
  uint32_t* s_inc = s_hist + kWarps * 32 * 32;
  uint8_t* s_ph = reinterpret_cast<uint8_t*>(s_inc + 256);
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_ph + 256);
  int32_t* s_qh = s_pos + 5 * L.cnt;  // [5][cnt]: A C G T, then Phred
  int32_t* s_gch = s_qh + kMaxPhred;
  int32_t* s_mqh = s_gch + kGcBins;
  int32_t* s_bad = s_mqh + kMaxPhred;
  const int n_small = 5 * L.cnt + 2 * kMaxPhred + kGcBins + 1;
  for (int i = threadIdx.x; i < kWarps * 32 * 32; i += kThreads)
    s_hist[i] = 0;
  for (int i = threadIdx.x; i < n_small; i += kThreads) s_pos[i] = 0;
  {
    const int b = threadIdx.x;  // kThreads == 256: one entry each
    s_inc[b] = b == 'A' ? 1u : b == 'C' ? 1u << 8 : b == 'G' ? 1u << 16
             : b == 'T' ? 1u << 24 : 0u;
    const int ph = min(max(b - L.offset, 0), kMaxPhred - 1);
    const bool out = L.check_quality && (b < L.q_lo || b > L.q_hi);
    s_ph[b] = (uint8_t)(ph | (out ? 0x80 : 0));
  }
  if (threadIdx.x < kStages) {
    s_tnl[threadIdx.x] = 0;
    s_tflag[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* hist = s_hist + warp * 32 * 32 + lane;
  uint32_t acgt[P];
  int cq[P];
#pragma unroll
  for (int k = 0; k < P; ++k) acgt[k] = cq[k] = 0;
  int since_flush = 0;  // rows this warp counted since the last flush
  int fcol, fwant;
  fixed_byte(L, lane, &fcol, &fwant);

  // this block's whole tiles: blockIdx.x, + gridDim.x, ...
  const long long n_tiles = nrec_valid / R;
  const long long mine =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    for (long long i = 0; i < mine && i < kStages; ++i)
      tma_load(ring + i * tile_bytes,
               chunk + (blockIdx.x + i * gridDim.x) * (long long)tile_bytes,
               (unsigned)tile_bytes, bars + i);
  }
  int bad = 0;  // bad rows this warp found (lane 0's count)
  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % kStages);
    mbar_wait(bars + s, (unsigned)((i / kStages) & 1));
    const uint8_t* tile = ring + s * tile_bytes;
    // the tile's newlines and high bits, in 16-byte words
    {
      const uint4* t16 = reinterpret_cast<const uint4*>(tile);
      uint32_t nl = 0, high = 0;
      for (int c = threadIdx.x; c < tile_bytes / 16; c += kThreads) {
        const uint4 v = t16[c];
        nl += ((newline_bytes(v.x) >> 7) + (newline_bytes(v.y) >> 7)) +
              ((newline_bytes(v.z) >> 7) + (newline_bytes(v.w) >> 7));
        high |= v.x | v.y | v.z | v.w;
      }
      // nl holds four byte-wise counts of at most 4 each per 16-byte word
      const int n = (int)__reduce_add_sync(
          kFull, (nl & 0xff) + ((nl >> 8) & 0xff) + ((nl >> 16) & 0xff) +
                     (nl >> 24));
      const bool hb = __any_sync(kFull, (high & 0x80808080u) != 0);
      if (lane == 0) {
        atomicAdd(s_tnl + s, n);
        if (hb) atomicOr(s_tflag + s, 2);
      }
    }
    unsigned flag = 0;  // this lane's byte verdicts over the tile's rows
    for (int r = warp; r < R; r += kWarps) {
      flag |= row_panels<P>(tile + r * L.rs, L, lane, fcol, fwant, acgt, cq,
                            hist, s_inc, s_ph, s_gch, s_mqh);
      if (++since_flush == kFlushRows) {
        flush<P>(L, lane, acgt, hist, s_pos, s_qh);
        since_flush = 0;
      }
    }
    if (__any_sync(kFull, flag & 0x80) && lane == 0) atomicOr(s_tflag + s, 1);
    if (threadIdx.x == 0) {
      // the next tile's counters: their last readers passed the barrier
      // before this tile
      const int nx = (int)((i + 1) % kStages);
      s_tnl[nx] = 0;
      s_tflag[nx] = 0;
    }
    __syncthreads();  // every warp is done with stage s and its counters
    const int fl = s_tflag[s];
    if (s_tnl[s] != 4 * R || (fl & 1) || (L.check_ascii && (fl & 2))) {
      // not clean: judge each row on its own, every byte again
      for (int r = warp; r < R; r += kWarps) {
        const uint8_t* row = tile + r * L.rs;
        const bool b = row_newlines_bad(tile, r * L.rs, L, lane);
        const bool f = __any_sync(
            kFull, row_bytes_flag(row, L, lane, fcol, fwant, s_ph, 0) & 0x80);
        if (lane == 0 && (b || f)) ++bad;
      }
      __syncthreads();  // stage s is free again
    }
    if (threadIdx.x == 0 && i + kStages < mine)
      tma_load(ring + s * tile_bytes,
               chunk + (blockIdx.x + (i + kStages) * gridDim.x) *
                           (long long)tile_bytes,
               (unsigned)tile_bytes, bars + s);
  }
  // the rows past the last whole tile: the last block, with plain loads,
  // judged row by row
  const int tail = (int)(nrec_valid - n_tiles * R);
  if (tail > 0 && blockIdx.x == gridDim.x - 1) {
    const uint8_t* src = chunk + n_tiles * (long long)tile_bytes;
    const int bytes = tail * L.rs;
    for (int k = threadIdx.x; k < bytes; k += kThreads) ring[k] = src[k];
    __syncthreads();
    for (int r = warp; r < tail; r += kWarps) {
      const bool f = __any_sync(
          kFull, row_panels<P>(ring + r * L.rs, L, lane, fcol, fwant, acgt,
                               cq, hist, s_inc, s_ph, s_gch, s_mqh) &
                     0x80);
      const bool b = row_newlines_bad(ring, r * L.rs, L, lane);
      if (lane == 0 && (f || b)) ++bad;
      if (++since_flush == kFlushRows) {
        flush<P>(L, lane, acgt, hist, s_pos, s_qh);
        since_flush = 0;
      }
    }
  }

  // the block's sums: registers and per-lane histograms into shared
  // memory, then one global add per nonzero counter
  flush<P>(L, lane, acgt, hist, s_pos, s_qh);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = lane + 32 * k;
    if (p < L.cnt && cq[k]) atomicAdd(s_pos + 4 * L.cnt + p, cq[k]);
  }
  if (lane == 0 && bad) atomicAdd(s_bad, bad);
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * L.cnt; i += kThreads)
    if (s_pos[i]) atomicAdd(csb_out + i, s_pos[i]);
  for (int i = threadIdx.x; i < L.cnt; i += kThreads)
    if (s_pos[4 * L.cnt + i]) atomicAdd(csq_out + i, s_pos[4 * L.cnt + i]);
  for (int i = threadIdx.x; i < kMaxPhred; i += kThreads)
    if (s_qh[i]) atomicAdd(qh_out + i, s_qh[i]);
  for (int i = threadIdx.x; i < kGcBins; i += kThreads)
    if (s_gch[i]) atomicAdd(gch_out + i, s_gch[i]);
  for (int i = threadIdx.x; i < kMaxPhred; i += kThreads)
    if (s_mqh[i]) atomicAdd(mqh_out + i, s_mqh[i]);
  if (threadIdx.x == 0 && *s_bad) atomicAdd(bad_out, *s_bad);
}

template <int P>
int launch(const uint8_t* chunk, long long nrec_valid, const Layout& L,
           int32_t* bad, int32_t* csq, int32_t* csb, int32_t* qh,
           int32_t* gch, int32_t* mqh, int sm_count, cudaStream_t stream) {
  const int R = tile_rows(L.rs);
  const int smem = (int)smem_bytes(L.rs, L.cnt);
  cudaError_t e = cudaFuncSetAttribute(
      uniform_qc_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, uniform_qc_kernel<P>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long n_tiles = nrec_valid / R;
  long long blocks = (long long)per_sm * sm_count;
  if (blocks > n_tiles) blocks = n_tiles > 0 ? n_tiles : 1;
  uniform_qc_kernel<P><<<(unsigned)blocks, kThreads, smem, stream>>>(
      chunk, nrec_valid, L, R, bad, csq, csb, qh, gch, mqh);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows per staged tile for records of rs bytes (the tests aim their edge
// cases at tile boundaries with it).
extern "C" int bs_uniform_qc_tile_rows(int rs) {
  return rs < 1 ? -1 : tile_rows(rs);
}

// Shared memory one block needs for the layout, or -1 when the kernel does
// not take it (a stats window of more than 512 columns).
extern "C" int bs_uniform_qc_smem_bytes(int rs, int cnt) {
  if (cnt < 1 || cnt > 512 || rs < 1) return -1;
  const long long b = smem_bytes(rs, cnt);
  return b > 0x7fffffff ? 0x7fffffff : (int)b;
}

extern "C" int bs_uniform_qc(const uint8_t* chunk, long long nrec_valid,
                             int rs, int o1, int o2, int o3, int cnt,
                             int q_lo, int q_hi, int offset, int check_ascii,
                             int check_quality, int32_t* bad, int32_t* csq,
                             int32_t* csb, int32_t* qh, int32_t* gch,
                             int32_t* mqh, int sm_count, void* stream) {
  if (nrec_valid <= 0) return (int)cudaSuccess;
  const unsigned long long d = 2ull * (unsigned)cnt;
  const Layout L{rs, o1, o2, o3, cnt, q_lo, q_hi, offset, check_ascii,
                 check_quality, (unsigned)(((1ull << 32) + d - 1) / d)};
  cudaStream_t s = (cudaStream_t)stream;
  const int p = (cnt + 31) / 32;
#define BS_UQC_CASE(n)                                                    \
  if (p <= n)                                                             \
    return launch<n>(chunk, nrec_valid, L, bad, csq, csb, qh, gch, mqh,   \
                     sm_count, s);
  BS_UQC_CASE(1) BS_UQC_CASE(2) BS_UQC_CASE(4) BS_UQC_CASE(5)
  BS_UQC_CASE(8) BS_UQC_CASE(16)
#undef BS_UQC_CASE
  return (int)cudaErrorInvalidValue;
}
