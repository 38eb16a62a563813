// General (ragged-layout) FASTQ parse + validate + QC for Hopper (sm_90a).
//
// Serves the contract of blazeseq_tpu/ops/ragged_qc.py::ragged_qc, which is
// XLA code (MXU cross-correlations over a [tiles, K] view, rank-compacted
// slots) and reaches no Pallas kernel; the torch epilogue in
// blazeseq_tpu_torch/ops/ragged_qc.py folds the eq-mode histograms.
//
// Input: a chunk u8[n] starting at a record boundary (any address); bytes at
// or past n_valid are padding. Record r ends at newlines 4r..4r+3 (counted
// below n_valid) and starts one byte past newline 4r-1 (0 for r = 0);
// records run to the count of newlines / 4. Per record:
//   '@' starting the id line, '+' starting the separator line, seq length ==
//   qual length, no high bit in any of the record's bytes (check_ascii), each
//   quality byte in [q_lo, q_hi] over the whole line (check_quality);
// a failing record adds 1 to bad. Over the first `width` columns of its seq
// and qual lines:
//   csb[k*width + p]  A/C/G/T at column p (case-folded by & 0xDF)
//   csq[p]            clip(q - offset, 0, 63) at column p
//   qh[64]            histogram of clip(q - offset, 0, 63)
// and per record:
//   effh[min(ls, width)], lh[min(ls, 511)], bases += ls,
//   gch[(200*gc + eff) / (2*eff)] when ls > 0 (eff = min(ls, width)),
//   mqh[min((2*qsum + effq) / (2*effq), 63)] when lq > 0 (effq = min(lq,
//   width)).
// tail_start is one past newline 4*nrec - 1 (0 without a record), reads is
// nrec. Raw outputs (int32, zeroed by the caller, in this order): bad,
// tail_start, reads, bases, effh[width + 1], csb[4 * width], csq[width],
// qh[64], lh[512], gch[101], mqh[64]. Every count is an integer sum, so the
// result is the same whatever order the blocks run in.
//
// Bound: device-memory bytes (the chunk must be read once; the outputs are
// KB). The design before this one reached 5.7% of that bound: the scan
// kernel's three bitmaps (109 MB written per 256 MiB), an int32 newline
// position per chunk byte (1 GiB of scratch), then one warp per record
// walking a chain of dependent loads of those positions and byte-per-lane
// loads of its lines from device memory, with 64 KB of per-lane histograms
// allowing three blocks an SM. It was bound by latency and by instructions
// per byte, not by bytes. This design, one kernel after one zero fill:
// * Coordinates. Byte i of the chunk sits at virtual position v = lead + i,
//   lead = the chunk's address mod 16, so that every tile of kTile virtual
//   bytes starts 16-byte aligned. Whole 16-byte words that hold a chunk
//   byte are read; bytes below lead or at or past lead + n_valid are masked
//   out (they are padding to every test).
// * A warp per tile, tiles taken in order from a counter. The warp stages
//   its tile and a halo of kHalo bytes (the window) in its own shared
//   memory with 16-byte cp.async copies (the window is too small for a bulk
//   copy to pay; no block barrier anywhere in the loop), finds the
//   window's newlines (16-byte words, a SWAR zero-byte test, a warp prefix
//   over the lanes' counts) and compacts them in order into a list of at
//   most kList 16-bit offsets. Scanning stops once four newlines past the
//   tile's end are listed: they close the tile's last record.
// * Phase by look-back. Records end at newlines 4r..4r+3, so a tile needs
//   the count of the newlines before it mod 4. The warp publishes its
//   tile's count (mod 4) in the tile's status word, then walks back over
//   the status words of the tiles before it, 32 at a time, adding counts
//   until it meets a tile that has published its inclusive phase, and
//   publishes its own. Tiles are taken in order, so the tiles it waits on
//   are already held by running warps that publish before they wait: no
//   deadlock, and one pass over the chunk (no count pass, no positions in
//   device memory: one int32 per tile of scratch).
// * A tile owns the records that start in it (the record starting at its
//   first byte is its own when the byte before ends a record). Its warp
//   parses them one after another from shared memory. A tile denser than
//   the list (records of a few bytes) takes several rounds, each listing
//   from the start of the first record the last round could not finish; a
//   record of four newlines always fits a round, so rounds progress. A
//   record that runs past the window (long reads, records longer than the
//   halo) is finished from device memory: its missing newlines found with
//   16-byte loads and ballots, its lines read with the same code; one
//   whose newlines run out before n_valid is the partial tail.
// * Checks. The window scan also ORs its bytes: without a high bit there,
//   no record of the round searches its bytes for one (else 16-byte words
//   with byte masks). Quality bytes are range-checked in the column loop,
//   and past the window on their own. '@', '+' and ls == lq by lane 0.
// * Column counts. Lane l owns columns l + 32k for every record. For
//   windows of up to 512 columns they live in registers: A/C/G/T in four
//   8-bit counters a column and Phred sums in 16-bit counters, flushed
//   into the block's per-position rows every 255 records; wider windows
//   add into the rows with atomics (in global memory when the rows do not
//   fit in shared memory; no width is refused). The Phred histogram is
//   privatised per lane in 8-bit counters, four bins a word, laid out
//   [bin / 4][lane] (a lane's own bank), flushed every 255 column steps.
//   The four per-record bins go out from four lanes with one atomic.
// * reads and tail_start are the count of complete records and one past
//   the last one's fourth newline (a per-warp count and maximum). Int32
//   block sums stay exact because chunks are at most 2^28 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// bytes per tile (ops/ragged_qc.py's TILE_BYTES must match: the entry
// points refuse another), and halo bytes a warp stages past its tile
constexpr int kTile = 2048;
constexpr int kHalo = 1024;
constexpr int kWin = kTile + kHalo;
// newline offsets one round lists (a round per 256 newlines of a window)
constexpr int kList = 256;
constexpr int kMaxPhred = 64;
constexpr int kLenBins = 512;
constexpr int kGcBins = 101;
constexpr int kFlushSteps = 255;  // steps an 8-bit counter can take
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may use on sm_90
constexpr long long kMaxSmem = 232448;

struct Params {
  int width, offset, check_ascii, check_quality;
  // a quality byte b is in range when (unsigned)(b - q_lo) < q_cnt
  int q_lo;
  unsigned q_cnt;
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

// shared memory of one block, in this order: each warp's window, newline
// list and per-lane Phred counters, the two byte tables, the block's
// histograms (lh, gch, mqh, qh) and bad and bases counts, and, when they
// fit, the per-position rows (effh, csb, csq: 6 * width + 1 entries)
constexpr long long kWarpBytes = kWin + kList * 2 + (kMaxPhred / 4) * 32 * 4;
constexpr int kSmall = kLenBins + kGcBins + 2 * kMaxPhred + 4;
constexpr long long kFixedBytes =
    kWarps * kWarpBytes + 256 + 256 * 4 + kSmall * 4;

long long pos_bytes(int width) { return (6LL * width + 1) * 4; }

bool pos_in_smem(int width) {
  return kFixedBytes + pos_bytes(width) <= kMaxSmem;
}

long long smem_bytes(int width) {
  return kFixedBytes + (pos_in_smem(width) ? pos_bytes(width) : 0);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// an asynchronous 16-byte copy from global to shared memory (both ends
// 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// bit 7 of each byte of the result: that byte of w is '\n'
__device__ __forceinline__ uint32_t newline_bytes(uint32_t w) {
  const uint32_t z = w ^ 0x0A0A0A0Au;
  return ~(((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z | 0x7F7F7F7Fu);
}

// bit j of the result: byte j of the 16-byte word v is '\n' (a multiply
// gathers bits 7, 15, 23 and 31 of a word into its top nibble: their
// partial products never meet)
__device__ __forceinline__ unsigned newline_mask16(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m |= ((newline_bytes(w[i]) * 0x00204081u) >> 28) << (4 * i);
  return m;
}

// the 16 bits of a word at virtual position p whose bytes lie in [lo, hi)
__device__ __forceinline__ unsigned byte_range16(long long p, long long lo,
                                                 long long hi) {
  unsigned m = 0xffffu;
  if (lo > p) m = lo - p >= 16 ? 0u : m & (0xffffu << (lo - p));
  if (hi < p + 16) m = hi <= p ? 0u : m & (0xffffu >> (p + 16 - hi));
  return m;
}

// the 16 bits of a word at window offset p whose bytes lie in [lo, hi)
__device__ __forceinline__ unsigned range16(int p, int lo, int hi) {
  const int a = min(max(lo - p, 0), 16);
  const int b = min(max(p + 16 - hi, 0), 16);
  return (0xffffu << a) & (0xffffu >> b);
}

// 0xff in byte j of the result where bit j of the nibble n is set
__device__ __forceinline__ uint32_t byte_mask(unsigned n) {
  return ((n & 0xfu) * 0x00204081u & 0x01010101u) * 0xffu;
}

// the block's counters in shared memory (or, for the per-position rows of
// a wide window, in global memory) and this lane's Phred counters
struct Block {
  const uint8_t* cls;   // A C G T (either case) -> 0..3, else 4
  const uint32_t* inc;  // A C G T (either case) -> 1 in byte 0..3, else 0
  uint32_t* hist;       // this lane's [bin / 4] 8-bit counters, stride 32
  int32_t *lh, *gch, *mqh, *qh, *effh, *csb, *csq;
};

// A warp's running state. With NS > 0 slots (windows of at most 32 * NS
// columns), lane l keeps the counts of its columns l + 32k in registers,
// flushed every 255 records: A/C/G/T in four 8-bit counters a column, the
// Phred sums in 16-bit counters, two columns a register. With NS == 0 the
// columns go into the per-position rows with atomics.
template <int NS>
struct WarpAcc {
  int steps;       // column steps since the Phred counters' flush
  int recs;        // records since the packed counters' flush
  int bad, bases;  // lane 0's failing records and bases
  uint32_t acgt[NS > 0 ? NS : 1];
  uint32_t cq[NS > 1 ? NS / 2 : 1];
};

// the lane's 8-bit Phred counters into the block's bins
__device__ __forceinline__ void flush_hist(const Block& B, int lane) {
  for (int w = 0; w < kMaxPhred / 4; ++w) {
    const uint32_t v = B.hist[w * 32];
    B.hist[w * 32] = 0;
    // bins 4w, 4w+2 and 4w+1, 4w+3: at most 255 * 32 each, 16 bits
    const unsigned ev = __reduce_add_sync(kFull, v & 0x00ff00ffu);
    const unsigned od = __reduce_add_sync(kFull, (v >> 8) & 0x00ff00ffu);
    if (lane == 0) {
      if (ev & 0xffffu) atomicAdd(B.qh + 4 * w, (int)(ev & 0xffffu));
      if (od & 0xffffu) atomicAdd(B.qh + 4 * w + 1, (int)(od & 0xffffu));
      if (ev >> 16) atomicAdd(B.qh + 4 * w + 2, (int)(ev >> 16));
      if (od >> 16) atomicAdd(B.qh + 4 * w + 3, (int)(od >> 16));
    }
  }
}

// the lane's packed column counters into the per-position rows (the
// Phred sums' 16 bits take 255 records of at most 63 each)
template <int NS>
__device__ __forceinline__ void flush_cols(const Block& B, int W, int lane,
                                           WarpAcc<NS>& A) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int c = lane + 32 * k;
    const uint32_t v = A.acgt[k];
    if (c < W && v) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = (v >> (8 * j)) & 0xff;
        if (n) atomicAdd(B.csb + j * W + c, n);
      }
    }
    A.acgt[k] = 0;
    const int q = (A.cq[k / 2] >> (16 * (k & 1))) & 0xffff;
    if (c < W && q) atomicAdd(B.csq + c, q);
    if (k & 1 || k == NS - 1) A.cq[k / 2] = 0;
  }
}

// A high bit in src[lo, hi) (src 16-byte aligned), by one warp in
// 16-byte words, 512 bytes a step. True on the lanes that saw one.
__device__ __forceinline__ bool high_bit_in(const uint8_t* src, int lo,
                                            int hi, int lane) {
  uint32_t acc = 0;
  for (int p0 = lo & ~15; p0 < hi; p0 += 512) {
    const int p = p0 + 16 * lane;
    if (p < hi) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + p);
      const unsigned m = range16(p, lo, hi);
      acc |= (v.x & byte_mask(m)) | (v.y & byte_mask(m >> 4)) |
             (v.z & byte_mask(m >> 8)) | (v.w & byte_mask(m >> 12));
    }
  }
  return (acc & 0x80808080u) != 0;
}

// A quality byte of src[lo, hi) outside [q_lo, q_hi], by one warp a byte
// a lane. True on the lanes that saw one.
__device__ __forceinline__ bool quality_out_in(const uint8_t* src, int lo,
                                               int hi, const Params& P,
                                               int lane) {
  bool out = false;
  for (int c = lo + lane; c < hi; c += 32)
    out |= (unsigned)((int)src[c] - P.q_lo) >= P.q_cnt;
  return out;
}

// One record, by one warp: src holds it at offsets s (its first byte) and
// e0..e3 (its four newlines). Checks the record and adds its counts. The
// record's bytes are searched for a high bit only with `high` (a
// warp-uniform flag: check_ascii, and a high bit seen near the record);
// its quality bytes are checked in the column loop and, past the window,
// on their own.
template <int NS>
__device__ __forceinline__ void parse_record(const uint8_t* src, int s,
                                             int e0, int e1, int e2, int e3,
                                             bool high, const Params& P,
                                             const Block& B, WarpAcc<NS>& A,
                                             int lane) {
  const int W = P.width;
  const int ls = e1 - e0 - 1;
  const int lq = e3 - e2 - 1;
  const int sw = min(ls, W);
  const int qw = min(lq, W);
  bool bad = high && high_bit_in(src, s, e3 + 1, lane);
  if (P.check_quality && lq > qw)
    bad |= quality_out_in(src, e2 + 1 + qw, e3, P, lane);
  if (lane == 0)
    bad |= src[s] != '@' || src[e1 + 1] != '+' || ls != lq;
  // the window's columns of both lines in one loop (a valid record has
  // sw == qw), so that their loads overlap
  const uint8_t* seq = src + e0 + 1;
  const uint8_t* qual = src + e2 + 1;
  const int cw = max(sw, qw);
  int cg = 0, qs = 0;
  if (NS > 0) {
    // no atomics per byte: registers, and the lane's own Phred counters
    if (A.steps + NS > kFlushSteps) {
      flush_hist(B, lane);
      A.steps = 0;
    }
    uint32_t row = 0;  // this record's A/C/G/T counts in the lane's columns
#pragma unroll
    for (int k = 0; k < (NS > 0 ? NS : 1); ++k) {
      if (32 * k >= cw) break;
      const int c = lane + 32 * k;
      if (c < sw) {
        const uint32_t inc = B.inc[seq[c]];
        A.acgt[k] += inc;
        row += inc;
      }
      if (c < qw) {
        const int b = qual[c];
        if (P.check_quality) bad |= (unsigned)(b - P.q_lo) >= P.q_cnt;
        const int ph = min(max(b - P.offset, 0), kMaxPhred - 1);
        A.cq[k / 2] += (uint32_t)ph << (16 * (k & 1));
        qs += ph;
        B.hist[(ph >> 2) * 32] += 1u << ((ph & 3) << 3);
      }
      ++A.steps;
    }
    cg = (int)(((row >> 8) & 0xffu) + ((row >> 16) & 0xffu));
    if (++A.recs == 255) {
      flush_cols<NS>(B, W, lane, A);
      A.recs = 0;
    }
  } else {
    for (int c0 = 0; c0 < cw; c0 += 32) {
      const int c = c0 + lane;
      if (c < sw) {
        const int k = B.cls[seq[c]];
        if (k < 4) atomicAdd(B.csb + k * W + c, 1);
        cg += (k == 1) | (k == 2);
      }
      if (c < qw) {
        const int b = qual[c];
        if (P.check_quality) bad |= (unsigned)(b - P.q_lo) >= P.q_cnt;
        const int ph = min(max(b - P.offset, 0), kMaxPhred - 1);
        atomicAdd(B.csq + c, ph);
        B.hist[(ph >> 2) * 32] += 1u << ((ph & 3) << 3);
        qs += ph;
      }
      if (++A.steps == kFlushSteps) {
        flush_hist(B, lane);
        A.steps = 0;
      }
    }
  }
  const bool failed = __any_sync(kFull, bad);
  if (W <= 1024) {
    // the C + G count and the Phred sum in one reduction: at most 1024
    // and 1024 * 63, 16 bits each
    const unsigned both = __reduce_add_sync(
        kFull, ((unsigned)cg << 16) | (unsigned)qs);
    cg = (int)(both >> 16);
    qs = (int)(both & 0xffffu);
  } else {
    cg = (int)__reduce_add_sync(kFull, (unsigned)cg);
    qs = (int)__reduce_add_sync(kFull, (unsigned)qs);
  }
  // the record's four bins from four lanes, with one atomic: lane 0 the
  // length, lane 1 the in-window length, lanes 2 and 3 the GC share and
  // the mean quality (one division for both)
  int32_t* bin = nullptr;
  if (lane == 0) {
    A.bad += failed;
    A.bases += ls;
    bin = B.lh + min(ls, kLenBins - 1);
  } else if (lane == 1) {
    bin = B.effh + sw;
  } else if (lane < 4) {
    const bool gc = lane == 2;
    const int eff = gc ? sw : qw;
    if (eff > 0) {
      const unsigned long long num =
          gc ? 200ull * cg + sw : 2ull * qs + qw;
      const unsigned den = 2u * (unsigned)eff;
      const unsigned q = num >> 32 ? (unsigned)(num / den)
                                   : (unsigned)num / den;
      bin = gc ? B.gch + q : B.mqh + min(q, (unsigned)(kMaxPhred - 1));
    }
  }
  if (bin) atomicAdd(bin, 1);
}

// The first `need` newlines at or past virtual position `from` (16-byte
// aligned) and below vend, into out[0..need), by one warp: 512 bytes a
// step, a 16-byte word a lane, the owner of each newline found by a ballot
// over the lanes' running counts. Returns how many it found (fewer than
// `need` when vend comes first).
__device__ int next_newlines(const uint8_t* abase, long long from,
                             long long vend, int need, int* out, int lane) {
  int got = 0;
  for (long long p0 = from; got < need && p0 < vend; p0 += 512) {
    const long long p = p0 + 16 * lane;
    unsigned m = 0;
    if (p < vend)
      m = newline_mask16(*reinterpret_cast<const uint4*>(abase + p)) &
          byte_range16(p, p, vend);
    const int cnt = __popc(m);
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += v;
    }
    const int total = __shfl_sync(kFull, inc, 31);
    for (int q = 0; q < total && got < need; ++q, ++got) {
      const int owner = __ffs(__ballot_sync(kFull, inc > q)) - 1;
      int pos = 0;
      if (lane == owner) {
        unsigned mm = m;
        for (int k = q - (inc - cnt); k > 0; --k) mm &= mm - 1;
        pos = (int)(p + __ffs(mm) - 1);
      }
      out[got] = __shfl_sync(kFull, pos, owner);
    }
  }
  return got;
}

// Tile status words of the single pass's look-back: 0 until the tile's
// warp has counted it, then the flag and a phase (a newline count mod 4):
// kAgg with the tile's own count, later kIncl with the count of every
// newline below the tile's end.
constexpr int kAgg = 4;
constexpr int kIncl = 8;

__device__ __forceinline__ int load_status(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// The phase of tile t's first newline: the count, mod 4, of the newlines
// of tiles 0..t-1, by one warp looking back 32 tiles a step over their
// status words, until a tile with kIncl (spinning on tiles not counted
// yet: their warps count them before they look back themselves).
__device__ int look_back(const int* status, long long t, int lane) {
  int phase = 0;
  for (long long j = t - 1; j >= 0; j -= 32) {
    const long long i = j - lane;
    int v;
    unsigned incl, need;
    while (true) {
      v = i >= 0 ? load_status(status + i) : kIncl;
      incl = __ballot_sync(kFull, v & kIncl);
      // the lanes up to the nearest inclusive status must all be ready
      need = incl ? (incl & -incl) * 2 - 1 : kFull;
      if ((__ballot_sync(kFull, v != 0) & need) == need) break;
      __nanosleep(64);
    }
    phase += (int)__reduce_add_sync(
        kFull, ((need >> lane) & 1) ? (unsigned)(v & 3) : 0u);
    if (incl) break;
  }
  return phase & 3;
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 4)
    ragged_qc_kernel(const uint8_t* __restrict__ abase, long long lead,
                     long long n_valid, int* __restrict__ status,
                     long long n_tiles, Params P, int32_t* __restrict__ out,
                     int smem_pos) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int W = P.width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* win = smem + warp * kWarpBytes;  // this warp's window
  uint16_t* list = reinterpret_cast<uint16_t*>(win + kWin);
  uint32_t* hist = reinterpret_cast<uint32_t*>(list + kList);
  uint8_t* s_cls = smem + kWarps * kWarpBytes;
  uint32_t* s_inc = reinterpret_cast<uint32_t*>(s_cls + 256);
  int32_t* s_small = reinterpret_cast<int32_t*>(s_inc + 256);
  // lh, gch, mqh, qh, then bad, bases, reads and the tail
  int32_t* s_bad = s_small + kSmall - 4;
  int32_t* s_bases = s_bad + 1;
  int32_t* s_reads = s_bad + 2;
  int32_t* s_tail = s_bad + 3;
  const Raw g = raw_layout(out, W);
  Block B;
  B.cls = s_cls;
  B.inc = s_inc;
  B.hist = hist + lane;
  B.lh = s_small;
  B.gch = B.lh + kLenBins;
  B.mqh = B.gch + kGcBins;
  B.qh = B.mqh + kMaxPhred;
  B.effh = g.effh;
  B.csb = g.csb;
  B.csq = g.csq;
  if (smem_pos) {
    B.effh = s_small + kSmall;
    B.csb = B.effh + W + 1;
    B.csq = B.csb + 4 * W;
    for (int i = threadIdx.x; i < 6 * W + 1; i += kThreads) B.effh[i] = 0;
  }
  for (int i = lane; i < (kMaxPhred / 4) * 32; i += 32) hist[i] = 0;
  for (int i = threadIdx.x; i < kSmall; i += kThreads) s_small[i] = 0;
  {
    const int b = threadIdx.x;  // kThreads == 256: one entry each
    const int u = b & 0xDF;
    const int k = u == 'A' ? 0 : u == 'C' ? 1 : u == 'G' ? 2 : u == 'T' ? 3
                : 4;
    s_cls[b] = (uint8_t)k;
    s_inc[b] = k < 4 ? 1u << (8 * k) : 0u;
  }
  __syncthreads();

  const long long vend = lead + n_valid;  // virtual end of the valid bytes
  const long long vend16 = (vend + 15) & ~15LL;
  int* claim = status + n_tiles;  // the next tile to take
  WarpAcc<NS> A{};
  int reads = 0, tail = 0;  // lane 0's complete records and their end
  while (true) {
    // tiles are taken in order: each tile the look-back below waits on is
    // held by a running warp, which publishes its count before it waits
    long long t = 0;
    if (lane == 0) t = atomicAdd(claim, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= n_tiles) break;
    const long long tv = t * kTile;  // the window's virtual start
    const int bytes = (int)min((long long)kWin, vend16 - tv);
    for (int o = 16 * lane; o < bytes; o += 512)
      cp_async16(win + o, abase + tv + o);
    asm volatile("cp.async.commit_group;" ::: "memory");
    // the window's bytes below vend; the tile's below vend
    const int wlen = (int)min((long long)kWin, vend - tv);
    const int tlen = min(kTile, wlen);
    const bool nl_before = t > 0 && abase[tv - 1] == '\n';
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
    // rounds: the first from the tile's first chunk byte; j0 is the list
    // index of the newline before the round's first record (-1: the record
    // starts at a), known once the tile's phase is
    int a = t == 0 ? (int)lead : 0;
    int j0 = -1;
    bool first = true;
    while (true) {
      // the newlines of window bytes [a, wlen), in order, into the list
      // (and a high bit among the bytes read, from `a` on)
      int base = 0;
      bool trunc = false;
      uint32_t hb = 0;
      int past = 0;  // newlines listed at or past the tile's last byte
      int in_tile = 0;  // newlines of [a, tlen) read
      int w0 = a & ~15;
      for (; w0 < wlen; w0 += 512) {
        const int p = w0 + 16 * lane;
        unsigned m = 0;
        if (p < wlen) {
          const uint4 v = *reinterpret_cast<const uint4*>(win + p);
          const unsigned r = range16(p, a, wlen);
          m = newline_mask16(v) & r;
          hb |= r == 0xffffu
                    ? v.x | v.y | v.z | v.w
                    : (v.x & byte_mask(r)) | (v.y & byte_mask(r >> 4)) |
                          (v.z & byte_mask(r >> 8)) |
                          (v.w & byte_mask(r >> 12));
        }
        const int cnt = __popc(m);
        const int cnt_past = __popc(m & range16(p, kTile - 1, wlen));
        if (first && w0 < tlen)
          in_tile += (int)__reduce_add_sync(
              kFull, (unsigned)__popc(m & range16(p, 0, tlen)));
        int inc = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, inc, d);
          if (lane >= d) inc += v;
        }
        for (int k = base + inc - cnt; m && k < kList; ++k, m &= m - 1)
          list[k] = (uint16_t)(p + __ffs(m) - 1);
        base += __shfl_sync(kFull, inc, 31);
        if (base >= kList) {
          trunc = base > kList || w0 + 512 < wlen;
          break;
        }
        // four of them hold the end of the tile's last record: the halo
        // past them is not needed
        if (w0 + 512 >= kTile) {
          past += (int)__reduce_add_sync(kFull, (unsigned)cnt_past);
          if (past >= 4) break;
        }
      }
      if (first) {
        // the rest of the tile's newlines, when the list ran out first
        for (w0 += 512; w0 < tlen; w0 += 512) {
          const int p = w0 + 16 * lane;
          unsigned m = 0;
          if (p < tlen)
            m = newline_mask16(*reinterpret_cast<const uint4*>(win + p)) &
                range16(p, a, tlen);
          in_tile += (int)__reduce_add_sync(kFull, (unsigned)__popc(m));
        }
        // publish the tile's count, then its phase from the tiles before,
        // then the phase past it
        if (lane == 0 && t > 0) atomicExch(status + t, kAgg | (in_tile & 3));
        const int phase = t == 0 ? 0 : look_back(status, t, lane);
        if (lane == 0) atomicExch(status + t, kIncl | ((phase + in_tile) & 3));
        // the first listed newline has that phase: a record starts at
        // the tile's first byte when the byte before ends a record
        j0 = t == 0 || (nl_before && phase == 0) ? -1 : (3 - phase) & 3;
        first = false;
      }
      // no high bit among them: no record of the list needs the search
      const bool high =
          P.check_ascii && __any_sync(kFull, (hb & 0x80808080u) != 0);
      const int n_list = min(base, kList);
      // the round's records, while they start in the list (or at a) and
      // in the tile; `next` is the next round's first record
      int next = -1;
      for (int js = j0;; js += 4) {
        const int s = js < 0 ? a : js < n_list ? list[js] + 1 : kTile;
        if (s >= kTile) break;  // not this round's, or not this tile's
        if (js + 4 < n_list) {
          const int e3 = list[js + 4];
          parse_record<NS>(win, s, list[js + 1], list[js + 2], list[js + 3],
                           e3, high, P, B, A, lane);
          ++reads;
          tail = (int)(tv + e3 + 1 - lead);
        } else if (trunc) {
          next = s;  // the list ran out: the next round starts here
          break;
        } else {
          // the record runs past the window: the tile's last, from device
          // memory (its missing newlines lie at or past the window's end),
          // unless the chunk ends first
          int e[4];
          int have = 0;
          for (; have < 4 && js + 1 + have < n_list; ++have)
            e[have] = (int)(tv + list[js + 1 + have]);
          if (wlen == kWin &&
              next_newlines(abase, tv + kWin, vend, 4 - have, e + have,
                            lane) == 4 - have) {
            parse_record<NS>(abase, (int)(tv + s), e[0], e[1], e[2], e[3],
                             P.check_ascii, P, B, A, lane);
            ++reads;
            tail = (int)(e[3] + 1 - lead);
          }
          break;
        }
      }
      __syncwarp();  // the list and the window are free again
      if (next < 0) break;
      a = next;
      j0 = -1;
    }
  }
  // the block's sums: the lanes' counters into shared memory, then one
  // global add per nonzero counter
  flush_hist(B, lane);
  flush_cols<NS>(B, W, lane, A);
  if (lane == 0) {
    if (A.bad) atomicAdd(s_bad, A.bad);
    if (A.bases) atomicAdd(s_bases, A.bases);
    if (reads) atomicAdd(s_reads, reads);
    if (tail) atomicMax(s_tail, tail);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxPhred; i += kThreads)
    if (B.qh[i]) atomicAdd(g.qh + i, B.qh[i]);
  for (int i = threadIdx.x; i < kLenBins; i += kThreads)
    if (B.lh[i]) atomicAdd(g.lh + i, B.lh[i]);
  for (int i = threadIdx.x; i < kGcBins; i += kThreads)
    if (B.gch[i]) atomicAdd(g.gch + i, B.gch[i]);
  for (int i = threadIdx.x; i < kMaxPhred; i += kThreads)
    if (B.mqh[i]) atomicAdd(g.mqh + i, B.mqh[i]);
  if (smem_pos) {
    for (int i = threadIdx.x; i < 6 * W + 1; i += kThreads)
      if (B.effh[i]) atomicAdd(g.effh + i, B.effh[i]);
  }
  if (threadIdx.x == 0) {
    if (*s_bad) atomicAdd(g.bad, *s_bad);
    if (*s_bases) atomicAdd(g.bases, *s_bases);
    if (*s_reads) atomicAdd(g.reads, *s_reads);
    if (*s_tail) atomicMax(g.tail, *s_tail);
  }
}

// the chunk's 16-byte aligned base, its lead and its tiles
struct Tiles {
  const uint8_t* abase;
  long long lead, n_tiles;
};

Tiles tiles_of(const uint8_t* chunk, long long n_valid) {
  const long long lead = (long long)((uintptr_t)chunk & 15u);
  return Tiles{chunk - lead, lead,
               n_valid > 0 ? (lead + n_valid + kTile - 1) / kTile : 0};
}

// A launch of ragged_qc_kernel<NS>, after its blocks per SM into *per_sm
// (out == nullptr: only those).
template <int NS>
int launch(const Tiles& T, long long n_valid, int* status, const Params& P,
           int32_t* out, int sm_count, cudaStream_t stream, int* per_sm) {
  const int smem = (int)smem_bytes(P.width);
  cudaError_t e = cudaFuncSetAttribute(
      ragged_qc_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, ragged_qc_kernel<NS>, kThreads, smem);
  if (e != cudaSuccess || out == nullptr) return (int)e;
  long long blocks = (long long)(*per_sm > 0 ? *per_sm : 1) * sm_count;
  const long long need = (T.n_tiles + kWarps - 1) / kWarps;
  if (blocks > need) blocks = need > 0 ? need : 1;
  ragged_qc_kernel<NS><<<(unsigned)blocks, kThreads, smem, stream>>>(
      T.abase, T.lead, n_valid, status, T.n_tiles, P, out,
      pos_in_smem(P.width) ? 1 : 0);
  return (int)cudaGetLastError();
}

// The instantiation for the width: register slots for windows of up to
// 512 columns, atomics into the per-position rows above.
int dispatch(const Tiles& T, long long n_valid, int* status, const Params& P,
             int32_t* out, int sm_count, cudaStream_t stream, int* per_sm) {
  const int ns = (P.width + 31) / 32;
#define BS_RQC_CASE(n)                                             \
  if (ns <= n)                                                     \
    return launch<n>(T, n_valid, status, P, out, sm_count, stream, \
                     per_sm);
  BS_RQC_CASE(1) BS_RQC_CASE(2) BS_RQC_CASE(4) BS_RQC_CASE(8)
  BS_RQC_CASE(16)
#undef BS_RQC_CASE
  return launch<0>(T, n_valid, status, P, out, sm_count, stream, per_sm);
}

Params params(int width, int q_lo, int q_hi, int offset, int check_ascii,
              int check_quality) {
  const int lo = q_lo < 0 ? 0 : q_lo > 256 ? 256 : q_lo;
  const int hi = q_hi < -1 ? -1 : q_hi > 255 ? 255 : q_hi;
  return Params{width, offset, check_ascii, check_quality, lo,
                (unsigned)(hi >= lo ? hi - lo + 1 : 0)};
}

}  // namespace

// The records of the chunk in one pass (see the header). `status` holds
// n_tiles + 1 zeroed int32 (the tiles' look-back words and the claim
// counter), `out` the zeroed raw outputs; refuses a tile size other than
// this source's.
extern "C" int bs_ragged_qc(const uint8_t* chunk, int* status,
                            long long n_valid, int tile, int width, int q_lo,
                            int q_hi, int offset, int check_ascii,
                            int check_quality, int32_t* out, int sm_count,
                            void* stream) {
  if (width < 1 || tile != kTile || out == nullptr || status == nullptr)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  return dispatch(tiles_of(chunk, n_valid), n_valid, status,
                  params(width, q_lo, q_hi, offset, check_ascii,
                         check_quality),
                  out, sm_count, (cudaStream_t)stream, &per_sm);
}

// Blocks of bs_ragged_qc that fit one SM at `width` (the occupancy its
// launch gets), or minus a CUDA error code.
extern "C" int bs_ragged_qc_blocks_per_sm(int width) {
  if (width < 1) return -(int)cudaErrorInvalidValue;
  int per_sm = 0;
  const int e = dispatch(Tiles{nullptr, 0, 0}, 0, nullptr,
                         params(width, 0, 0, 0, 0, 0), nullptr, 0, nullptr,
                         &per_sm);
  return e ? -e : per_sm;
}
