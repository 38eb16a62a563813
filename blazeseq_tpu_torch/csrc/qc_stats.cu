// Padded-batch QC statistics for Hopper (sm_90a).
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
// Output: one zero-filled int32 buffer holding the leaves in QCStats'
// field order (Layout below); the caller makes each leaf a view of it.
//   reads = n_records * scale (written here), bases = sum of the true
//   lengths of the records, error_reads = records with codes != 0 (each
//   times scale = count_scalars); base_counts, per_pos_base_counts [5, L],
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
// latency of a row's loads, the launch and the flush of the per-block
// partial leaves are its time.
//
// Design. A block owns a contiguous range of at most 512 rows, whose
// lengths it stages in shared memory with one coalesced load. A warp
// takes one row at a time (rows warp, warp + 8, ... of the range, four at
// once with every load issued before any is used, so that a warp waits
// on memory once for four rows) and covers a strip of 128 columns, a lane
// 4 consecutive columns (one 32-bit load of seq and one of qual when
// L % 4 == 0 and both are 4-byte aligned, else byte loads). The strips of
// a row are walked in turn, strip-outer, so within a strip a lane always
// holds the same 4 columns and keeps their A/C/G/T/count/Phred sums in
// registers over all the block's rows; when the strip ends, the 8 warps'
// sums meet in shared memory and the block adds each nonzero column of
// the 7 x L per-position leaves with one global atomic, neighbouring
// threads on neighbouring columns. The per-position Phred histogram of
// the strip is privatized in shared memory (64 x 128 ints, laid out so
// that the 32 lanes of a warp hit 32 banks whatever their values),
// flushed by warps over its 64 rows, lanes on neighbouring columns, and
// its row sums give qual_hist; so any L takes the 32 KB strip, and L = 1024 with
// the [64, L] leaf needs no more shared memory than L = 128. A row's GC
// count and Phred sum within the strip are one packed warp sum (gc | qsum
// << 8, both bounded by the strip's 128 columns), added by the warp that
// owns the row in every strip into its shared partials; after the last
// strip the block's threads bin its rows into shared histograms (length,
// GC%, mean Phred), flushed with one global atomic a nonzero bin.
//
// Every block adds its partial leaves into the same output words, so the
// flush grows with the blocks while the rows a warp waits on shrink. A
// first form, in which each warp added its own column sums with global
// atomics (8 x 7 a column a block, lanes 16 bytes apart), spent most of
// its time on the H100 in that flush; summed in shared memory first, the
// flush is one atomic a column and leaf a block, and a block takes at
// least 32 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 128;  // columns a warp covers: 32 lanes x 4
constexpr int kPhred = 64;
constexpr int kLenBins = 512;
constexpr int kGcBins = 101;
constexpr int kMinRows = 32;    // rows a block takes at least
constexpr int kMaxRows = 512;   // rows a block takes at most
constexpr int kRowUnroll = 4;   // rows a warp loads before it uses them
constexpr unsigned kFull = 0xffffffffu;

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
  const int32_t* codes;  // null: error_reads stays 0
  int32_t* out;
  Layout o;
  long long n_valid;
  long long rows_per_block;
  int L;
  int col_offset;
  int offset;
  int reads;
  int count_scalars;
  int do_rows;
  int qual_hist_2d;
  int vec;  // 32-bit loads: L % 4 == 0, seq and qual 4-byte aligned
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void add_nonzero(int32_t* p, int v) {
  if (v) atomicAdd(p, v);
}

__global__ void __launch_bounds__(kThreads) qc_stats_kernel(const Args a) {
  __shared__ int s_pph[kPhred * kStrip];  // [phred][b][lane]: column 4 lane + b
  __shared__ int s_pos[6][kStrip];        // the strip's A C G T count qsum
  __shared__ int s_len[kMaxRows];         // the block's lengths
  __shared__ int s_gc[kMaxRows];          // and their row partials
  __shared__ int s_qs[kMaxRows];
  __shared__ int s_qh[kPhred];
  __shared__ int s_lenh[kLenBins];
  __shared__ int s_gch[kGcBins];
  __shared__ int s_mqh[kPhred];
  __shared__ int s_tot[kWarps][7];
  const long long r0 = (long long)blockIdx.x * a.rows_per_block;
  const int rows = (int)max(min(a.n_valid - r0, a.rows_per_block), 0LL);
  for (int i = threadIdx.x; i < kPhred * kStrip; i += kThreads) s_pph[i] = 0;
  for (int i = threadIdx.x; i < 6 * kStrip; i += kThreads) (&s_pos[0][0])[i] = 0;
  for (int i = threadIdx.x; i < kLenBins; i += kThreads) s_lenh[i] = 0;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    s_len[i] = a.lengths[r0 + i];
    s_gc[i] = s_qs[i] = 0;
  }
  if (threadIdx.x < kPhred) s_qh[threadIdx.x] = s_mqh[threadIdx.x] = 0;
  if (threadIdx.x < kGcBins) s_gch[threadIdx.x] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int L = a.L;
  const int nstrips = (L + kStrip - 1) / kStrip;
  // this thread's share of base_counts (A C G T other)
  int tot[5] = {0, 0, 0, 0, 0};

  for (int s = 0; s < nstrips; ++s) {
    const int c0 = s * kStrip + 4 * lane;  // this lane's first column
    int nA[4] = {0, 0, 0, 0}, nC[4] = {0, 0, 0, 0}, nG[4] = {0, 0, 0, 0};
    int nT[4] = {0, 0, 0, 0}, nc[4] = {0, 0, 0, 0}, nq[4] = {0, 0, 0, 0};
    // rows warp, warp + 8, ... of the block, kRowUnroll at a time with
    // every load issued before any is used (warp-uniform)
    for (int i0 = warp; i0 < rows; i0 += kRowUnroll * kWarps) {
      uint32_t sw[kRowUnroll], qw[kRowUnroll];
      int k[kRowUnroll];  // masked columns among the lane's 4
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int i = i0 + u * kWarps;
        sw[u] = qw[u] = 0;
        k[u] = 0;
        if (i < rows) {
          const long long lim =
              min((long long)s_len[i] - a.col_offset, (long long)L);
          k[u] = (int)max(min(lim - c0, 4LL), 0LL);
        }
        if (k[u] > 0) {
          const long long at = (r0 + i) * L + c0;
          if (a.vec) {
            sw[u] = *reinterpret_cast<const uint32_t*>(a.seq + at);
            qw[u] = *reinterpret_cast<const uint32_t*>(a.qual + at);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (b < k[u]) {
                sw[u] |= (uint32_t)a.seq[at + b] << (8 * b);
                qw[u] |= (uint32_t)a.qual[at + b] << (8 * b);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int i = i0 + u * kWarps;
        if (i >= rows) break;  // warp-uniform
        int part = 0;          // gc | phred sum << 8
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (b < k[u]) {
            const uint32_t c = (sw[u] >> (8 * b)) & 0xDFu;
            const int q = (int)((qw[u] >> (8 * b)) & 0xFFu);
            const int ph = min(max(q - a.offset, 0), kPhred - 1);
            nA[b] += c == 'A';
            nC[b] += c == 'C';
            nG[b] += c == 'G';
            nT[b] += c == 'T';
            nc[b] += 1;
            nq[b] += ph;
            atomicAdd(&s_pph[ph * kStrip + b * 32 + lane], 1);
            part += (int)(c == 'C' || c == 'G') + (ph << 8);
          }
        }
        if (a.do_rows) {
          part = warp_sum(part);
          if (lane == 0) {  // row i is this warp's in every strip
            s_gc[i] += part & 0xFF;
            s_qs[i] += part >> 8;
          }
        }
      }
    }
    // the warps' column sums into the block's (8 warps, one set of
    // columns), then one global atomic a nonzero value, neighbouring
    // threads on neighbouring columns
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * lane + b;
      if (nc[b]) {
        atomicAdd(&s_pos[0][c], nA[b]);
        atomicAdd(&s_pos[1][c], nC[b]);
        atomicAdd(&s_pos[2][c], nG[b]);
        atomicAdd(&s_pos[3][c], nT[b]);
        atomicAdd(&s_pos[4][c], nc[b]);
        atomicAdd(&s_pos[5][c], nq[b]);
      }
      tot[0] += nA[b];
      tot[1] += nC[b];
      tot[2] += nG[b];
      tot[3] += nT[b];
      tot[4] += nc[b] - nA[b] - nC[b] - nG[b] - nT[b];
    }
    __syncthreads();  // the strip's sums and Phred histogram are complete
    if (threadIdx.x < kStrip) {
      const int c = threadIdx.x;
      const long long col = (long long)s * kStrip + c;
      const int cnt = s_pos[4][c];
      if (cnt) {  // so col < L
        int32_t* pb = a.out + a.o.pp_base + col;
        int known = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          add_nonzero(pb + k * (long long)L, s_pos[k][c]);
          known += s_pos[k][c];
        }
        add_nonzero(pb + 4LL * L, cnt - known);  // other
        add_nonzero(a.out + a.o.pp_qsum + col, s_pos[5][c]);
        atomicAdd(a.out + a.o.pp_count + col, cnt);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) s_pos[k][c] = 0;
    }
    for (int ph = warp; ph < kPhred; ph += kWarps) {
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // column cc = lane + 32 j of the strip, held at [cc % 4][cc / 4]
        const int cc = lane + 32 * j;
        int* p = &s_pph[ph * kStrip + (cc & 3) * 32 + (cc >> 2)];
        const int v = *p;
        if (v) {
          sum += v;
          *p = 0;
          if (a.qual_hist_2d)
            atomicAdd(a.out + a.o.pp_hist + (long long)ph * L +
                          (long long)s * kStrip + cc,
                      v);
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) s_qh[ph] += sum;  // one warp owns each phred row
    }
    __syncthreads();  // zeroed before the next strip
  }

  // the per-record scalars and panels of the block's rows
  int bases = 0, errs = 0;
  if (a.count_scalars) {
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const int len = s_len[i];
      bases = (int)((unsigned)bases + (unsigned)len);  // wraps as int32
      if (a.codes) errs += a.codes[r0 + i] != 0;
      if (a.do_rows) {
        atomicAdd(&s_lenh[min(max(len, 0), kLenBins - 1)], 1);
        const long long cnt =
            min(max((long long)len - a.col_offset, 0LL), (long long)L);
        if (cnt > 0) {
          const int c = (int)cnt;
          atomicAdd(&s_gch[(200 * s_gc[i] + c) / (2 * c)], 1);
          atomicAdd(&s_mqh[min((2 * s_qs[i] + c) / (2 * c), kPhred - 1)], 1);
        }
      }
    }
  }

  // block totals, then one global atomic a nonzero value
  int v[7] = {tot[0], tot[1], tot[2], tot[3], tot[4], bases, errs};
#pragma unroll
  for (int i = 0; i < 7; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) s_tot[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) {
      t += threadIdx.x < 7 ? s_tot[w][threadIdx.x]
                           : s_tot[w][1] + s_tot[w][2];  // C + G
    }
    const long long dst = threadIdx.x < 5    ? a.o.base_counts + threadIdx.x
                          : threadIdx.x == 5 ? a.o.bases
                          : threadIdx.x == 6 ? a.o.error_reads
                                             : a.o.gc_count;
    add_nonzero(a.out + dst, t);
  }
  for (int i = threadIdx.x; i < kPhred; i += kThreads) {
    add_nonzero(a.out + a.o.qual_hist + i, s_qh[i]);
    add_nonzero(a.out + a.o.mq_hist + i, s_mqh[i]);
  }
  for (int i = threadIdx.x; i < kLenBins; i += kThreads)
    add_nonzero(a.out + a.o.len_hist + i, s_lenh[i]);
  for (int i = threadIdx.x; i < kGcBins; i += kThreads)
    add_nonzero(a.out + a.o.gc_hist + i, s_gch[i]);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.out[a.o.reads] = a.reads;
}

}  // namespace

// out: int32[Layout::total] (ops/stats.py lays the leaves out alike),
// zero-filled by the caller. reads: the value of the reads leaf.
extern "C" int bs_qc_stats(const uint8_t* seq, const uint8_t* qual,
                           const int32_t* lengths, const int32_t* codes,
                           int32_t* out, long long n, long long n_valid,
                           int L, int col_offset, int offset, int reads,
                           int count_scalars, int row_stats, int qual_hist_2d,
                           int sm_count, void* stream) {
  if (n < 0 || L < 0 || n_valid < 0 || n_valid > n)
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)seq | (uintptr_t)qual) % 4 == 0;
  // at least kMinRows rows a block (the flush costs the same whatever the
  // rows), at most kMaxRows (the staged lengths and row partials)
  long long blocks = (n_valid + kMinRows - 1) / kMinRows;
  if (blocks > 2LL * sm_count) blocks = 2LL * sm_count;
  const long long fewest = (n_valid + kMaxRows - 1) / kMaxRows;
  if (blocks < fewest) blocks = fewest;
  if (blocks < 1) blocks = 1;  // block 0 writes `reads`
  Args a;
  a.seq = seq;
  a.qual = qual;
  a.lengths = lengths;
  a.codes = codes;
  a.out = out;
  a.o = layout(L, qual_hist_2d);
  a.n_valid = n_valid;
  a.rows_per_block = (n_valid + blocks - 1) / blocks;
  a.L = L;
  a.col_offset = col_offset;
  a.offset = offset;
  a.reads = reads;
  a.count_scalars = count_scalars;
  a.do_rows = row_stats && count_scalars;
  a.qual_hist_2d = qual_hist_2d;
  a.vec = L % 4 == 0 && aligned;
  qc_stats_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
