// General (ragged-layout) FASTQ parse + validate + QC for Hopper (sm_90a).
//
// Serves the contract of blazeseq_tpu/ops/ragged_qc.py::ragged_qc, which is
// XLA code (MXU cross-correlations over a [tiles, K] view, rank-compacted
// slots) and reaches no Pallas kernel; the torch epilogue in
// blazeseq_tpu_torch/ops/ragged_qc.py folds the eq-mode histograms.
//
// Input: a chunk u8[n] starting at a record boundary (any address); bytes at
// or past n_valid are padding. Its newlines below n_valid come from the
// structural-bitmap kernel (csrc/scan.cu) over the chunk's 128-byte rows and
// an int32 cumsum of its per-row counts (both launched by the wrapper).
//
// bs_ragged_lines: one thread per bitmap row writes the row's newline
// positions below n_valid, in order, at its row's offset in the cumsum
// (__ffs over the row's four words); the thread of the row that holds byte
// n_valid - 1 writes the count of newlines below n_valid. Bytes past the
// last whole 128-byte row of the tensor (a length off a multiple of 128) are
// read by one more thread, byte by byte. Positions has room for n_valid
// entries, so every chunk fits.
//
// bs_ragged_qc: record r ends at newlines 4r..4r+3 and starts one byte past
// newline 4r-1 (0 for r = 0); records run to the count of newlines / 4. One
// warp per record, a grid-stride loop over records (the count is read on the
// card: no host sync). Per record the warp checks:
//   '@' starting the id line, '+' starting the separator line, seq length ==
//   qual length, no high bit in any of the record's bytes (check_ascii), each
//   quality byte in [q_lo, q_hi] over the whole line (check_quality);
// a failing record adds 1 to bad. Over the first `width` columns of its seq
// and qual lines (lanes stride over the columns, one byte load each, a warp
// reading 32 neighbouring bytes), it adds:
//   csb[k*width + p]  A/C/G/T at column p (case-folded by & 0xDF)
//   csq[p]            clip(q - offset, 0, 63) at column p
//   qh[64]            histogram of clip(q - offset, 0, 63)
// and per record (lane 0):
//   effh[min(ls, width)], lh[min(ls, 511)], bases += ls,
//   gch[(200*gc + eff) / (2*eff)] when ls > 0 (eff = min(ls, width)),
//   mqh[min((2*qsum + effq) / (2*effq), 63)] when lq > 0 (effq = min(lq,
//   width)),
// with gc and qsum from one warp reduction each. Block 0 writes tail_start
// (one past newline 4*nrec - 1, or 0) and reads. Raw outputs (int32, zeroed
// by the caller, in this order): bad, tail_start, reads, bases,
// effh[width + 1], csb[4 * width], csq[width], qh[64], lh[512], gch[101],
// mqh[64]. Every count is an integer sum, so the result is the same
// whatever order the blocks run in.
//
// Bound: device-memory bytes (the chunk is read once, and its newline
// positions written and read once). Design: block-private counters in
// shared memory, flushed with one integer atomicAdd per nonzero counter: the
// per-position rows take shared atomics (the lanes of a warp hold distinct
// columns, so no two collide), the Phred histogram is privatised per lane
// ([warp][bin][lane], a lane's own bank, no atomics) so that binned
// qualities cost no conflicts. A width whose per-position rows do not fit in
// shared memory adds them straight into global memory; no width is refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLane = 128;
constexpr int kMaxPhred = 64;
constexpr int kLenBins = 512;
constexpr int kGcBins = 101;
constexpr unsigned kFull = 0xffffffffu;
// the smallest complete record, "@\n\n+\n\n"
constexpr int kMinRecord = 6;
// shared memory a block may use on sm_90
constexpr long long kMaxSmem = 232448;

struct Params {
  int width, q_lo, q_hi, offset, check_ascii, check_quality;
};

// offsets of the raw outputs (see the header), in int32 entries
struct Raw {
  int32_t *bad, *tail, *reads, *bases, *effh, *csb, *csq, *qh, *lh, *gch,
      *mqh;
};

__device__ inline Raw raw_layout(int32_t* out, int width) {
  Raw r;
  r.bad = out;
  r.tail = out + 1;
  r.reads = out + 2;
  r.bases = out + 3;
  r.effh = out + 4;
  r.csb = r.effh + width + 1;
  r.csq = r.csb + 4 * width;
  r.qh = r.csq + width;
  r.lh = r.qh + kMaxPhred;
  r.gch = r.lh + kLenBins;
  r.mqh = r.gch + kGcBins;
  return r;
}

// shared memory of one block: the per-lane Phred histograms, the two byte
// tables, the block's histograms (lh, gch, mqh, qh) and bad and bases
// counts, and, when they fit, the per-position rows (effh, csb, csq:
// 6 * width + 1 entries)
constexpr long long kHistBytes = (long long)kWarps * kMaxPhred * 32 * 4;
constexpr int kSmall = kLenBins + kGcBins + 2 * kMaxPhred + 2;
constexpr long long kSmallBytes = 512 + (kSmall + 2) * 4;

long long pos_bytes(int width) { return (6LL * width + 1) * 4; }

bool pos_in_smem(int width) {
  return kHistBytes + kSmallBytes + pos_bytes(width) <= kMaxSmem;
}

long long smem_bytes(int width) {
  return kHistBytes + kSmallBytes + (pos_in_smem(width) ? pos_bytes(width) : 0);
}

__global__ void __launch_bounds__(kThreads)
    ragged_lines_kernel(const uint8_t* __restrict__ chunk,
                        const uint32_t* __restrict__ nl_words,
                        const int32_t* __restrict__ excl, long long rows,
                        long long n_valid, int32_t* __restrict__ positions,
                        int32_t* __restrict__ n_lines) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row < rows) {
    const long long first = row * kLane;
    if (first >= n_valid) return;
    int k = excl[row];
    const uint4 w = reinterpret_cast<const uint4*>(nl_words)[row];
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bits = words[j];
      while (bits) {
        const long long q = first + 32 * j + (__ffs(bits) - 1);
        bits &= bits - 1;
        if (q < n_valid) positions[k++] = (int32_t)q;
      }
    }
    if (n_valid <= first + kLane) *n_lines = k;
  } else if (row == rows && n_valid > rows * kLane) {
    // the bytes past the last whole row of the tensor
    int k = 0;
    if (rows > 0) {
      const uint4 w = reinterpret_cast<const uint4*>(nl_words)[rows - 1];
      k = excl[rows - 1] + __popc(w.x) + __popc(w.y) + __popc(w.z) +
          __popc(w.w);
    }
    for (long long q = rows * kLane; q < n_valid; ++q)
      if (chunk[q] == '\n') positions[k++] = (int32_t)q;
    *n_lines = k;
  }
}

__global__ void __launch_bounds__(kThreads)
    ragged_qc_kernel(const uint8_t* __restrict__ chunk,
                     const int32_t* __restrict__ positions,
                     const int32_t* __restrict__ n_lines, Params P,
                     int32_t* __restrict__ out, int smem_pos) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_hist = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_ph = smem + kHistBytes;  // clip(b - offset, 0, 63) | 0x80 out
  uint8_t* s_cls = s_ph + 256;        // A C G T -> 0..3, else 4
  int32_t* s_small = reinterpret_cast<int32_t*>(s_cls + 256);
  int32_t* s_lh = s_small;
  int32_t* s_gch = s_lh + kLenBins;
  int32_t* s_mqh = s_gch + kGcBins;
  int32_t* s_qh = s_mqh + kMaxPhred;
  int32_t* s_bad = s_qh + kMaxPhred;
  int32_t* s_bases = s_bad + 1;
  const int W = P.width;
  const Raw g = raw_layout(out, W);
  int32_t* effh = g.effh;
  int32_t* csb = g.csb;
  int32_t* csq = g.csq;
  if (smem_pos) {
    effh = s_small + kSmall + 2;
    csb = effh + W + 1;
    csq = csb + 4 * W;
    for (int i = threadIdx.x; i < 6 * W + 1; i += kThreads) effh[i] = 0;
  }
  for (int i = threadIdx.x; i < kWarps * kMaxPhred * 32; i += kThreads)
    s_hist[i] = 0;
  for (int i = threadIdx.x; i < kSmall; i += kThreads) s_small[i] = 0;
  {
    const int b = threadIdx.x;  // kThreads == 256: one entry each
    const int ph = min(max(b - P.offset, 0), kMaxPhred - 1);
    const bool outside = P.check_quality && (b < P.q_lo || b > P.q_hi);
    s_ph[b] = (uint8_t)(ph | (outside ? 0x80 : 0));
    const int u = b & 0xDF;
    s_cls[b] = u == 'A' ? 0 : u == 'C' ? 1 : u == 'G' ? 2 : u == 'T' ? 3 : 4;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* hist = s_hist + warp * kMaxPhred * 32 + lane;
  const long long n_rec = (long long)(*n_lines) >> 2;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *g.tail = n_rec > 0 ? positions[4 * n_rec - 1] + 1 : 0;
    *g.reads = (int32_t)n_rec;
  }
  int bad = 0;           // failing records this warp found (lane 0's)
  long long bases = 0;   // lane 0's
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n_rec;
       r += (long long)gridDim.x * kWarps) {
    const int s = r == 0 ? 0 : positions[4 * r - 1] + 1;
    const int e0 = positions[4 * r];
    const int e1 = positions[4 * r + 1];
    const int e2 = positions[4 * r + 2];
    const int e3 = positions[4 * r + 3];
    const int ls = e1 - e0 - 1;
    const int lq = e3 - e2 - 1;
    const int sw = min(ls, W);
    const int qw = min(lq, W);
    unsigned flag = 0;  // bit 7: a failing byte
    if (lane == 0 &&
        (chunk[s] != '@' || chunk[e1 + 1] != '+' || ls != lq))
      flag = 0x80;
    if (P.check_ascii) {
      for (int i = s + lane; i < e0; i += 32) flag |= chunk[i];
      for (int i = e1 + 1 + lane; i < e2; i += 32) flag |= chunk[i];
    }
    const uint8_t* seq = chunk + e0 + 1;
    const int send = P.check_ascii ? ls : sw;
    int cg = 0;
    for (int c = lane; c < send; c += 32) {
      const uint8_t b = seq[c];
      if (P.check_ascii) flag |= b;
      if (c < sw) {
        const int k = s_cls[b];
        if (k < 4) atomicAdd(csb + k * W + c, 1);
        cg += (k == 1) | (k == 2);
      }
    }
    const uint8_t* qual = chunk + e2 + 1;
    const int qend = (P.check_ascii || P.check_quality) ? lq : qw;
    int qs = 0;
    for (int c = lane; c < qend; c += 32) {
      const uint8_t b = qual[c];
      const unsigned t = s_ph[b];
      flag |= (P.check_ascii ? b : 0) | t;
      if (c < qw) {
        const int ph = t & 63;
        atomicAdd(csq + c, ph);
        hist[ph * 32] += 1;
        qs += ph;
      }
    }
    cg = (int)__reduce_add_sync(kFull, (unsigned)cg);
    qs = (int)__reduce_add_sync(kFull, (unsigned)qs);
    const bool failed = __any_sync(kFull, flag & 0x80);
    if (lane == 0) {
      bad += failed;
      bases += ls;
      atomicAdd(s_lh + min(ls, kLenBins - 1), 1);
      atomicAdd(effh + sw, 1);
      if (ls > 0)
        atomicAdd(s_gch + (int)((200LL * cg + sw) / (2LL * sw)), 1);
      if (lq > 0)
        atomicAdd(s_mqh + (int)min((2LL * qs + qw) / (2LL * qw),
                                   (long long)(kMaxPhred - 1)),
                  1);
    }
  }
  // the warp's lanes' histograms (each lane reads back its own entries)
  for (int b = 0; b < kMaxPhred; ++b) {
    const unsigned v = __reduce_add_sync(kFull, hist[b * 32]);
    if (lane == 0 && v) atomicAdd(s_qh + b, (int)v);
  }
  if (lane == 0) {
    if (bad) atomicAdd(s_bad, bad);
    if (bases) atomicAdd(s_bases, (int)bases);
  }
  __syncthreads();
  // the block's sums into the outputs, one atomic per nonzero counter
  for (int i = threadIdx.x; i < kMaxPhred; i += kThreads)
    if (s_qh[i]) atomicAdd(g.qh + i, s_qh[i]);
  for (int i = threadIdx.x; i < kLenBins; i += kThreads)
    if (s_lh[i]) atomicAdd(g.lh + i, s_lh[i]);
  for (int i = threadIdx.x; i < kGcBins; i += kThreads)
    if (s_gch[i]) atomicAdd(g.gch + i, s_gch[i]);
  for (int i = threadIdx.x; i < kMaxPhred; i += kThreads)
    if (s_mqh[i]) atomicAdd(g.mqh + i, s_mqh[i]);
  if (smem_pos) {
    for (int i = threadIdx.x; i < 6 * W + 1; i += kThreads)
      if (effh[i]) atomicAdd(g.effh + i, effh[i]);
  }
  if (threadIdx.x == 0) {
    if (*s_bad) atomicAdd(g.bad, *s_bad);
    if (*s_bases) atomicAdd(g.bases, *s_bases);
  }
}

}  // namespace

// The newline positions below n_valid (see the header). nl_words and excl
// are null when rows is 0. Writes the count to *n_lines.
extern "C" int bs_ragged_lines(const uint8_t* chunk, const void* nl_words,
                               const int32_t* excl, long long rows,
                               long long n_valid, int32_t* positions,
                               int32_t* n_lines, void* stream) {
  if (n_valid <= 0) return (int)cudaSuccess;  // the count stays 0
  const long long threads = rows + 1;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  ragged_lines_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      chunk, (const uint32_t*)nl_words, excl, rows, n_valid, positions,
      n_lines);
  return (int)cudaGetLastError();
}

// One warp per record over the records that bs_ragged_lines found; `out` is
// the zeroed raw outputs (see the header). n_valid only sizes the grid.
extern "C" int bs_ragged_qc(const uint8_t* chunk, const int32_t* positions,
                            const int32_t* n_lines, long long n_valid,
                            int width, int q_lo, int q_hi, int offset,
                            int check_ascii, int check_quality, int32_t* out,
                            int sm_count, void* stream) {
  if (width < 1) return (int)cudaErrorInvalidValue;
  const Params P{width, q_lo, q_hi, offset, check_ascii, check_quality};
  const int smem = (int)smem_bytes(width);
  cudaError_t e = cudaFuncSetAttribute(
      ragged_qc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ragged_qc_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  // no more blocks than the records the chunk could hold
  const long long max_rec = n_valid / kMinRecord + 1;
  long long blocks = (long long)per_sm * sm_count;
  const long long need = (max_rec + kWarps - 1) / kWarps;
  if (blocks > need) blocks = need;
  ragged_qc_kernel<<<(unsigned)blocks, kThreads, smem,
                     (cudaStream_t)stream>>>(chunk, positions, n_lines, P,
                                             out, pos_in_smem(width) ? 1 : 0);
  return (int)cudaGetLastError();
}
