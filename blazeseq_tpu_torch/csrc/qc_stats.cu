// Padded-batch QC statistics for Hopper (sm_90a), added into a running
// total.
//
// Replaces blazeseq_tpu/ops/stats.py::qc_stats, which is XLA code with no
// Pallas kernel: every QCStats leaf of one padded batch in one launch,
// where the plain torch version (ops/stats.py::qc_stats_torch) takes ~120
// dispatcher calls and builds int32/int64 [n, L] intermediates.
//
// Inputs: seq, qual u8[n, L] (row-major, contiguous), lengths i32[n] (the
// true lengths, which may exceed L; not below 0), codes i32[n] or null.
// Rows r < n_valid = min(n, n_records) are records; the rest are padding
// and are not read. Position c of record r is in the mask when
// c + col_offset < lengths[r]. On masked positions:
//   phred = clip(qual - offset, 0, 63)   (clamps; kernel A's decode wraps)
//   class = A, C, G, T by seq & 0xDF, else "other" (N, 0x00, high bits)
// Output: one int32 buffer holding the leaves in QCStats' field order
// (Layout below), into which the batch is ADDED (the caller zero-fills a
// new buffer, or passes the running total of earlier batches; int32 wraps
// as the merge adds it replaces did):
//   reads += n_records * scale, bases += sum of the true lengths of the
//   records, error_reads += records with codes != 0 (each times scale =
//   count_scalars); base_counts, per_pos_base_counts [5, L],
//   per_pos_qual_sum [L], per_pos_count [L], qual_hist [64], gc_count;
//   with row_stats and count_scalars the per-read panels over the
//   in-window count cnt = clip(len - col_offset, 0, L): length_hist
//   (min(len, 511)), and for cnt > 0 gc_hist floor((200 gc + cnt) /
//   (2 cnt)) and mean_qual_hist min(floor((2 qsum + cnt) / (2 cnt)), 63);
//   with qual_hist_2d the per-position Phred histogram [64, L].
// Every leaf is a sum of integer counts, added with integer atomics: any
// order gives the same bits as the plain version.
//
// Bound: device-memory bytes. The kernel reads seq and qual where a row's
// length reaches (2 bytes a masked position) and writes a few KB, with a
// few dozen integer operations a byte; at the host route's [4096, 256]
// batch the 1.3 MB take well under a microsecond at full rate, so the
// launch, one round trip to memory and the flush of the partial sums are
// its time. At [32768, 1024] with the [64, L] leaf the flush is up to 64 x
// L words a block.
//
// Design. A block owns a contiguous range of at most 255 rows, whose
// lengths (and codes) it stages with one load a thread. A row is cut into
// 16-byte pieces and gets a group of G = min(32, next_pow2(pieces)) lanes
// (the host picks G), so a warp holds 32 / G rows and a strip of S = 16 G
// columns; wider rows are walked strip by strip, and within a strip a lane
// always holds the same 16 columns. A lane loads one uint4 of seq and one
// of qual a row (byte loads when L % 16 != 0 or a pointer is off 16-byte
// alignment), kUnroll rows' loads issued before any is used, and counts
// with byte-SIMD words under an in-length byte mask: __vcmpeq4 for
// A/C/G/T, the count from the mask, clip(q - offset, 0, 63) as
// __vminu4(__vsubus4(...)). The per-column counts stay in registers as
// 8-bit lanes and the Phred sums as 16-bit lanes (a block's 255 rows keep
// both in range); the row's GC and Phred sums are __popc and __dp4a, one
// packed segmented warp sum a row. At the strip's end each warp stores its
// packed sums with plain stores and the block's threads add the 8 warps'
// words and unpack them once into the strip's column rows: the warps'
// column sums once met through shared atomics, 112 a lane, which took a
// third of the kernel's time. The Phred histogram is one shared atomic a
// position into 64 bins; with the [64, L] leaf that atomic goes instead
// into the strip's [64, S] counts, held as 8-bit lanes (4 columns a word,
// so the strip fits 32 KB at S = 512 and two blocks share an SM), and the
// histogram is the flush's row sums of them. Strip columns in shared
// memory are XOR-swizzled so that the lanes' adds of one byte position and
// the flush's reads of neighbouring columns each hit 32 banks.
//
// The flush. Blocks run in clusters of up to 8 (a launch attribute). When
// a cluster's blocks have their partials in shared memory, cluster rank k
// reads the k-th share of every block's partial words through distributed
// shared memory, sums them, and adds each nonzero sum to the output with
// one global atomic, neighbouring threads on neighbouring columns: a word
// takes one atomic a cluster where it took one a block. Strips before the
// last are flushed on their own; the last strip, the histograms and the
// scalars together (with the [64, L] leaf the scalars and histograms after
// the last strip, which sums the Phred histogram). The grid is as many
// clusters as the card holds at once, each block at least kMinRows rows
// (fewer blocks when the rows run out). The kernel's first form flushed
// every block's partials itself (128 blocks at [4096, 256]), zeroed and
// scanned a 32 KB per-position Phred histogram in every strip whether or
// not the [64, L] leaf was asked for, and loaded 4 bytes a lane.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPhred = 64;
constexpr int kLenBins = 512;
constexpr int kGcBins = 101;
constexpr int kMaxRows = 255;   // rows a block takes at most (8-bit sums)
constexpr int kMinRows = 32;    // rows a block takes at least, by default
constexpr int kUnroll = 4;      // rows a lane loads before it uses them
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;
// the reduced words of a block: the scalars and histograms ("tail": reads,
// bases, base_counts[5], then qual_hist .. mean_qual_hist as in Layout),
// padded to 16 bytes, then the strip's rows of S columns (A C G T other
// qsum count, and with the [64, L] leaf its 64 Phred rows)
constexpr int kTail = 7 + kPhred + 2 + kLenBins + kGcBins + kPhred;  // 750
constexpr int kTailPad = 752;
constexpr int kQualHist = 7;     // tail words
constexpr int kGcCount = kQualHist + kPhred;
constexpr int kErrors = kGcCount + 1;
constexpr int kLenHist = kErrors + 1;
constexpr int kGcHist = kLenHist + kLenBins;
constexpr int kMqHist = kGcHist + kGcBins;
constexpr int kColRows = 7;      // strip rows before the Phred rows

// offsets of the leaves in the output buffer, in QCStats' field order
struct Layout {
  long long reads, bases, base_counts, pp_base, pp_qsum, pp_count, qual_hist,
      gc_count, error_reads, len_hist, gc_hist, mq_hist, pp_hist, total;
};

Layout layout(long long L, int qual_hist_2d) {
  Layout o;
  o.reads = 0;
  o.bases = 1;
  o.base_counts = 2;
  o.pp_base = o.base_counts + 5;
  o.pp_qsum = o.pp_base + 5 * L;
  o.pp_count = o.pp_qsum + L;
  o.qual_hist = o.pp_count + L;
  o.gc_count = o.qual_hist + kPhred;
  o.error_reads = o.gc_count + 1;
  o.len_hist = o.error_reads + 1;
  o.gc_hist = o.len_hist + kLenBins;
  o.mq_hist = o.gc_hist + kGcBins;
  o.pp_hist = o.mq_hist + kPhred;
  o.total = o.pp_hist + (qual_hist_2d ? kPhred * L : 0);
  return o;
}

struct Args {
  const uint8_t* seq;
  const uint8_t* qual;
  const int32_t* lengths;
  const int32_t* codes;  // null: error_reads gets nothing
  int32_t* out;
  Layout o;
  long long n_valid;
  int rows_per_block;
  int L;
  int col_offset;
  int offset;
  int reads;
  int count_scalars;
  int do_rows;
  int qual_hist_2d;
  int vec;    // 16-byte loads: L % 16 == 0, seq and qual 16-byte aligned
  int gbits;  // log2 of G, the lanes a row takes
  int strip_words;  // kColRows rows of S, and with the [64, L] leaf its
                    // 64 rows of S / 4 words of 8-bit counts
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// mask of the first clamp(k, 0, 4) bytes of a little-endian word
__device__ __forceinline__ uint32_t first_bytes(int k) {
  return k >= 4 ? kFull : (k <= 0 ? 0u : (1u << (8 * k)) - 1u);
}

// shared-memory slot of column c of a strip row (see the note above)
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 5) & 15); }

// shared-memory slot of word v (columns 4v .. 4v + 3) of a row of the
// [64, S] Phred counts, held as 8-bit lanes: the lanes' adds of one word
// position, and the flush's reads of neighbouring words, hit 32 banks
__device__ __forceinline__ int swz8(int v) {
  return (v & ~3) | ((v + (v >> 5)) & 3);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

// Sum the logical words [lo, hi) of the cluster's blocks and add each
// nonzero sum to the output: rank k of the cluster takes the k-th share.
// Logical word w < kTail is tail word w; then come the strip's kColRows
// rows of S columns, then the [64, L] leaf's 64 rows of S / 4 words of
// four 8-bit counts each, of the strip starting at column s0. The sums of
// the leaf's rows go into s_qh (its Phred histogram).
__device__ void cluster_flush(const Args& a, int* smem, int* s_qh, int lo,
                              int hi, int s0, int S, int sbits) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials are complete
  const int nb = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = hi - lo;
  const int b = lo + (int)((long long)n * rank / nb);
  const int e = lo + (int)((long long)n * (rank + 1) / nb);
  const unsigned* src[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    src[r] = reinterpret_cast<const unsigned*>(
        cluster.map_shared_rank(smem, r < nb ? r : 0));
  const int cols_end = kTail + kColRows * S;
  int ph_row = -1;  // the [64, L] row whose sums `ph_sum` holds
  unsigned ph_sum = 0;
  for (int w = b + (int)threadIdx.x; w < e; w += kThreads) {
    if (w < cols_end) {
      int phys;
      long long dst;
      if (w < kTail) {
        phys = w;
        dst = w < kQualHist ? w : a.o.qual_hist + (w - kQualHist);
      } else {
        const int t = w - kTail;
        const int k = t >> sbits;
        const int c = t & (S - 1);
        const long long col = (long long)s0 + c;
        if (col >= a.L) continue;
        phys = kTailPad + k * S + swz(c);
        dst = a.o.pp_base + k * (long long)a.L + col;
      }
      unsigned sum = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < nb) sum += src[r][phys];
      if (sum) atomicAdd(a.out + dst, (int)sum);
      continue;
    }
    // four columns' 8-bit counts, summed as 16-bit lanes (8 x 255 fits)
    const int t = w - cols_end;
    const int ph = t >> (sbits - 2);
    const int v = t & (S / 4 - 1);
    const int phys = kTailPad + kColRows * S + ph * (S / 4) + swz8(v);
    unsigned even = 0, odd = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < nb) {
        const unsigned x = src[r][phys];
        even += x & 0x00FF00FFu;
        odd += (x >> 8) & 0x00FF00FFu;
      }
    }
    if (ph != ph_row) {
      if (ph_sum) atomicAdd(&s_qh[ph_row], (int)ph_sum);
      ph_row = ph;
      ph_sum = 0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned cnt = ((q & 1) ? odd : even) >> (16 * (q >> 1)) & 0xFFFFu;
      const long long col = (long long)s0 + 4 * v + q;
      if (cnt && col < a.L) {
        atomicAdd(a.out + a.o.pp_hist + ph * (long long)a.L + col, (int)cnt);
        ph_sum += cnt;
      }
    }
  }
  if (ph_sum) atomicAdd(&s_qh[ph_row], (int)ph_sum);
  cluster.sync();  // no block reuses or leaves its words while read
}

__global__ void __launch_bounds__(kThreads) qc_stats_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int G = 1 << a.gbits;
  const int S = 16 * G;
  const int sbits = a.gbits + 4;
  const int R = 32 >> a.gbits;  // rows a warp holds at once
  const int region = kTailPad + a.strip_words;
  int* const tail = smem;
  int* const strip = smem + kTailPad;
  // the warps' packed column sums: [warp][28 words][G pieces]
  uint32_t* const s_pack = reinterpret_cast<uint32_t*>(smem + region);
  int* const s_len = smem + region + kWarps * 28 * G;  // the block's lengths
  int* const s_gc = s_len + kMaxRows;  // and their row partials
  int* const s_qs = s_gc + kMaxRows;
  int* const s_qh = s_qs + kMaxRows;  // [64] from the [64, L] leaf's sums
  const long long r0 = (long long)blockIdx.x * a.rows_per_block;
  const int rows = (int)max(min(a.n_valid - r0, (long long)a.rows_per_block),
                            0LL);
  for (int i = threadIdx.x; i < region / 4; i += kThreads)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  // rows <= kMaxRows < kThreads: a thread stages at most one row, whose
  // code it keeps for the row panels
  int code = 0;
  if (threadIdx.x < rows) {
    s_len[threadIdx.x] = a.lengths[r0 + threadIdx.x];
    s_gc[threadIdx.x] = s_qs[threadIdx.x] = 0;
    if (a.codes) code = a.codes[r0 + threadIdx.x];
  }
  if (threadIdx.x < kPhred) s_qh[threadIdx.x] = 0;
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) tail[0] = a.reads;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = lane & (G - 1);  // this lane's piece of the strip
  const int sub = lane >> a.gbits;  // its row among the warp's R
  const int L = a.L;
  const int nstrips = max(1, (L + S - 1) / S);
  // q - offset saturating at 0 (at 255 for an offset below 0) per byte
  const bool neg = a.offset < 0;
  const uint32_t off4 =
      0x01010101u * (uint32_t)min(neg ? -max(a.offset, -255) : a.offset, 255);
  // this thread's share of base_counts (A C G T other)
  int tot[5] = {0, 0, 0, 0, 0};

  for (int s = 0; s < nstrips; ++s) {
    const int c0 = s * S + 16 * p;  // this lane's first column
    // per column of the lane's 16: counts as 8-bit lanes, Phred sums of
    // the even and odd bytes as 16-bit lanes, one word per 4 columns (a
    // block's rows, at most 255, keep every lane in range)
    uint32_t acc[7][4];  // A C G T count, phred even, phred odd
#pragma unroll
    for (int r = 0; r < 7; ++r)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[r][w] = 0;
    // the warp's rows: R at once (one a sub-group), kUnroll groups of
    // them with every load issued before any is used (warp-uniform)
    for (int i0 = warp * R; i0 < rows; i0 += kUnroll * kWarps * R) {
      uint4 sv[kUnroll], qv[kUnroll];
      int k[kUnroll];  // in-mask columns among the lane's 16
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kWarps * R + sub;
        sv[u] = qv[u] = make_uint4(0, 0, 0, 0);
        k[u] = 0;
        if (i < rows) {
          const long long lim =
              min((long long)s_len[i] - a.col_offset, (long long)L);
          k[u] = (int)max(min(lim - c0, 16LL), 0LL);
        }
        if (k[u] > 0) {
          const long long at = (r0 + i) * L + c0;
          if (a.vec) {
            sv[u] = __ldg(reinterpret_cast<const uint4*>(a.seq + at));
            qv[u] = __ldg(reinterpret_cast<const uint4*>(a.qual + at));
          } else {
            uint32_t sw[4] = {0, 0, 0, 0}, qw[4] = {0, 0, 0, 0};
#pragma unroll
            for (int b = 0; b < 16; ++b) {
              if (b < k[u]) {
                sw[b >> 2] |= (uint32_t)a.seq[at + b] << (8 * (b & 3));
                qw[b >> 2] |= (uint32_t)a.qual[at + b] << (8 * (b & 3));
              }
            }
            sv[u] = make_uint4(sw[0], sw[1], sw[2], sw[3]);
            qv[u] = make_uint4(qw[0], qw[1], qw[2], qw[3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u * kWarps * R >= rows) break;  // warp-uniform
        const int i = i0 + u * kWarps * R + sub;
        int part = 0;  // gc | phred sum << 16 of the row's piece
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int kw = k[u] - 4 * w;
          if (kw <= 0) break;
          const uint32_t m = first_bytes(kw);
          const uint32_t sb = word_of(sv[u], w) & 0xDFDFDFDFu;
          const uint32_t eqA = __vcmpeq4(sb, 0x41414141u) & m;
          const uint32_t eqC = __vcmpeq4(sb, 0x43434343u) & m;
          const uint32_t eqG = __vcmpeq4(sb, 0x47474747u) & m;
          const uint32_t eqT = __vcmpeq4(sb, 0x54545454u) & m;
          const uint32_t qb = word_of(qv[u], w);
          const uint32_t ph =
              __vminu4(neg ? __vaddus4(qb, off4) : __vsubus4(qb, off4),
                       0x3F3F3F3Fu) & m;
          acc[0][w] += eqA & 0x01010101u;
          acc[1][w] += eqC & 0x01010101u;
          acc[2][w] += eqG & 0x01010101u;
          acc[3][w] += eqT & 0x01010101u;
          acc[4][w] += m & 0x01010101u;
          acc[5][w] += ph & 0x00FF00FFu;
          acc[6][w] += (ph >> 8) & 0x00FF00FFu;
          part += __popc((eqC | eqG) & 0x01010101u) +
                  (__dp4a((int)ph, 0x01010101, 0) << 16);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (b < kw) {
              const int q = (int)((ph >> (8 * b)) & 0xFFu);
              if (a.qual_hist_2d)
                atomicAdd(&strip[kColRows * S + q * (S / 4) +
                                 swz8(4 * p + w)],
                          1 << (8 * b));
              else
                atomicAdd(&tail[kQualHist + q], 1);
            }
          }
        }
        if (a.do_rows) {
#pragma unroll
          for (int o = 1; o < 32; o <<= 1)
            if (o < G) part += __shfl_xor_sync(kFull, part, o);
          if (p == 0 && i < rows) {  // row i is this lane's in every strip
            s_gc[i] += part & 0xFFFF;
            s_qs[i] += part >> 16;
          }
        }
      }
    }
    // the warp's row groups into one (lanes with the same piece), stored
    // with plain stores; then the block's threads sum the 8 warps' packed
    // words and write the strip's column rows
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      if (o < G) break;
#pragma unroll
      for (int r = 0; r < 7; ++r)
#pragma unroll
        for (int w = 0; w < 4; ++w)
          acc[r][w] += __shfl_xor_sync(kFull, acc[r][w], o);
    }
    if (sub == 0) {
#pragma unroll
      for (int r = 0; r < 7; ++r)
#pragma unroll
        for (int w = 0; w < 4; ++w)
          s_pack[(warp * 28 + 4 * r + w) * G + p] = acc[r][w];
    }
    __syncthreads();
    if (threadIdx.x < 4 * G) {  // one (piece, word) a thread
      const int pp = threadIdx.x % G;
      const int w = threadIdx.x / G;
      uint32_t sum[7] = {0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int v = 0; v < kWarps; ++v)
#pragma unroll
        for (int r = 0; r < 7; ++r)
          sum[r] += s_pack[(v * 28 + 4 * r + w) * G + pp];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int sh = 8 * b;
        const int na = (int)((sum[0] >> sh) & 0xFFu);
        const int nc = (int)((sum[1] >> sh) & 0xFFu);
        const int ng = (int)((sum[2] >> sh) & 0xFFu);
        const int nt = (int)((sum[3] >> sh) & 0xFFu);
        const int cnt = (int)((sum[4] >> sh) & 0xFFu);
        const int nq = (int)(((b & 1) ? sum[6] : sum[5]) >> (16 * (b >> 1))
                             & 0xFFFFu);
        const int other = cnt - na - nc - ng - nt;
        const int col = swz(16 * pp + 4 * w + b);
        strip[0 * S + col] = na;
        strip[1 * S + col] = nc;
        strip[2 * S + col] = ng;
        strip[3 * S + col] = nt;
        strip[4 * S + col] = other;
        strip[5 * S + col] = nq;
        strip[6 * S + col] = cnt;
        tot[0] += na;
        tot[1] += nc;
        tot[2] += ng;
        tot[3] += nt;
        tot[4] += other;
      }
    }
    const bool last = s + 1 == nstrips;
    if (!last || a.qual_hist_2d) {
      // the strip alone: with the [64, L] leaf the tail waits for the
      // Phred histogram its flush sums
      cluster_flush(a, smem, s_qh, kTail, kTail + a.strip_words, s * S, S,
                    sbits);
      if (a.qual_hist_2d && !last) {
        for (int i = threadIdx.x; i < kPhred * S / 16; i += kThreads)
          reinterpret_cast<int4*>(strip + kColRows * S)[i] =
              make_int4(0, 0, 0, 0);
        __syncthreads();
      }
    } else {
      __syncthreads();  // the row partials are complete
    }
  }

  // the per-record scalars and panels of the block's rows
  int bases = 0, errs = 0;
  const int i = threadIdx.x;
  if (a.count_scalars && i < rows) {
    const int len = s_len[i];
    bases = len;
    errs = code != 0;
    if (a.do_rows) {
      atomicAdd(&tail[kLenHist + min(max(len, 0), kLenBins - 1)], 1);
      const long long cnt =
          min(max((long long)len - a.col_offset, 0LL), (long long)L);
      if (cnt > 0) {
        const int c = (int)cnt;
        atomicAdd(&tail[kGcHist + (200 * s_gc[i] + c) / (2 * c)], 1);
        atomicAdd(&tail[kMqHist + min((2 * s_qs[i] + c) / (2 * c),
                                      kPhred - 1)],
                  1);
      }
    }
  }
  if (a.qual_hist_2d && threadIdx.x < kPhred && s_qh[threadIdx.x])
    atomicAdd(&tail[kQualHist + threadIdx.x], s_qh[threadIdx.x]);
  int v[7] = {tot[0], tot[1], tot[2], tot[3], tot[4], bases, errs};
#pragma unroll
  for (int j = 0; j < 7; ++j) v[j] = warp_sum(v[j]);  // int32 wraps
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 5; ++j)
      if (v[j]) atomicAdd(&tail[2 + j], v[j]);
    if (v[1] + v[2]) atomicAdd(&tail[kGcCount], v[1] + v[2]);
    if (v[5]) atomicAdd(&tail[1], v[5]);
    if (v[6]) atomicAdd(&tail[kErrors], v[6]);
  }
  if (a.qual_hist_2d)
    cluster_flush(a, smem, s_qh, 0, kTail, 0, S, sbits);
  else
    cluster_flush(a, smem, s_qh, 0, kTail + a.strip_words,
                  (nstrips - 1) * S, S, sbits);
}

// dynamic shared memory of a block: the reduced words, then the staged
// lengths and row partials
int strip_words(int G, int qual_hist_2d) {
  return kColRows * 16 * G + (qual_hist_2d ? kPhred * 4 * G : 0);
}

int smem_bytes(int G, int qual_hist_2d) {
  return 4 * (kTailPad + strip_words(G, qual_hist_2d) + kWarps * 28 * G +
              3 * kMaxRows + kPhred);
}

}  // namespace

// out: int32[Layout::total] (ops/stats.py lays the leaves out alike); the
// batch is added into it. reads: what the reads leaf gets. group: the
// lanes a row takes (a power of two, 1 to 32). rows_per_block and cluster:
// 0 for the kernel's own choice (a sweep may set them; cluster a power of
// two up to 8).
extern "C" int bs_qc_stats(const uint8_t* seq, const uint8_t* qual,
                           const int32_t* lengths, const int32_t* codes,
                           int32_t* out, long long n, long long n_valid,
                           int L, int col_offset, int offset, int reads,
                           int count_scalars, int row_stats, int qual_hist_2d,
                           int group, int rows_per_block, int cluster,
                           void* stream) {
  if (n < 0 || L < 0 || n_valid < 0 || n_valid > n || group < 1 ||
      group > 32 || (group & (group - 1)) || rows_per_block < 0 ||
      rows_per_block > kMaxRows || cluster < 0 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(group, qual_hist_2d);
  static int smem_set = 0;  // the opt-in above 48 KB, made once
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qc_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  int cl = cluster ? cluster : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  long long rpb = rows_per_block;
  if (!rpb) {
    // as many clusters as the card holds at once, each block at least
    // kMinRows rows; the answer depends only on (smem, cluster)
    static int cached_smem[kMaxCluster + 1], cached_clusters[kMaxCluster + 1];
    if (cached_smem[cl] != smem) {
      cfg.gridDim = dim3(cl);
      int held = 0;
      const cudaError_t e =
          cudaOccupancyMaxActiveClusters(&held, qc_stats_kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      cached_clusters[cl] = held > 0 ? held : 1;
      cached_smem[cl] = smem;
    }
    const long long most = (long long)cached_clusters[cl] * cl;
    rpb = (n_valid + most - 1) / most;
    if (rpb < kMinRows) rpb = kMinRows;
    if (rpb > kMaxRows) rpb = kMaxRows;
  }
  long long blocks = (n_valid + rpb - 1) / rpb;
  if (blocks < 1) blocks = 1;  // block 0 adds `reads`
  while (cl > 1 && cl > blocks) cl >>= 1;
  blocks = (blocks + cl - 1) / cl * cl;
  attr[0].val.clusterDim.x = (unsigned)cl;
  cfg.gridDim = dim3((unsigned)blocks);
  Args a;
  a.seq = seq;
  a.qual = qual;
  a.lengths = lengths;
  a.codes = codes;
  a.out = out;
  a.o = layout(L, qual_hist_2d);
  a.n_valid = n_valid;
  a.rows_per_block = (int)rpb;
  a.L = L;
  a.col_offset = col_offset;
  a.offset = offset;
  a.reads = reads;
  a.count_scalars = count_scalars;
  a.do_rows = row_stats && count_scalars;
  a.qual_hist_2d = qual_hist_2d;
  a.vec = L % 16 == 0 &&
          ((uintptr_t)seq | (uintptr_t)qual) % 16 == 0;
  a.gbits = __builtin_ctz((unsigned)group);
  a.strip_words = strip_words(group, qual_hist_2d);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, qc_stats_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
