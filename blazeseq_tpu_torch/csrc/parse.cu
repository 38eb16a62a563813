// The device-parse API for Hopper (sm_90a): raw-stream QC, newline
// compaction, record offsets and codes, the padded gather, and the record
// count of a chunk whose length is not a multiple of 128.
//
// Replaces XLA code of the reference (none of it is a Pallas kernel):
//   raw_qc_kernel        blazeseq_tpu/ops/raw_stats.py:64-127 raw_stream_qc
//   compact_kernel       blazeseq_tpu/ops/scan.py:98-135 _compact_positions,
//                        newline_positions_device
//   records_kernel       blazeseq_tpu/ops/scan.py:138-176
//                        record_offsets_device (after compact_kernel)
//   gather_kernel        blazeseq_tpu/ops/scan.py:179-196 gather_padded_device
//   count_records_kernel blazeseq_tpu/ops/scan.py:216-228
//                        count_records_device's sum of the scan kernel's row
//                        counts, with the n % 128 bytes past its rows (the
//                        reference pads the chunk with a copy instead)
// One source for the two reference modules: the QC pass and the compaction
// both start from the same count of newlines per tile, and share its
// kernel and the byte tests.
//
// Bound: device-memory bytes everywhere. raw_stream_qc must read the chunk
// once (268.4 MB per 256 MiB chunk: 0.080 ms at 3.35 TB/s); the compaction
// reads it and writes 4 bytes a newline; the record pass reads and writes
// 20 bytes a record and 4 of codes; the gather writes its two
// [max_records, max_len] outputs (1.87 GB at 3,121,343 x 300: 0.56 ms) and
// reads each in-row byte once.
//
// Design. The torch versions make ~25 passes with O(N) int32 and int64
// intermediates (a running newline count, an index per byte, an int64 bin
// per byte, an int32 index per output byte). Here every kernel reads the
// chunk as aligned 16-byte words and nothing of O(N) is kept:
// * Coordinates. Byte i of the chunk sits at virtual position v = lead + i,
//   lead = the chunk's address mod 16, so that the chunk is read as whole
//   16-byte words (bytes outside [lead, lead + n) are masked out; a word
//   that holds a chunk byte lies within the allocation). A block of 256
//   threads takes a tile of kTile = 16 KiB virtual bytes, 64 a thread (four
//   16-byte loads, all issued before any is used).
// * Newline ranks. newline_tiles_kernel counts each tile's newlines (an
//   exact SWAR byte test, popcount) and the last block to finish turns the
//   counts into exclusive prefixes in place, the total after them: scratch
//   of one int32 a tile (64 KiB per 256 MiB). The second kernel of each
//   call re-reads its tile, takes a block prefix of the threads' counts, and
//   so knows every newline's global rank. Two reads of the chunk instead of
//   a look-back: the total must be known before the first byte is judged
//   (raw_stream_qc counts only bytes before the last complete record's end).
// * raw_qc_kernel walks its thread's 64 bytes in order with the running
//   rank: phase = rank & 3, complete = rank < 4 * (total / 4), one byte a
//   step (taking four bytes inside one line at once, with SWAR base
//   counts, was slower: the warps' lanes split between the two paths).
//   Counters in
//   registers, reduced per warp, per block in shared memory, then one global
//   atomic per counter per block; the Phred histogram per warp in shared
//   memory; the flags by __syncthreads_or; the last block to finish sets
//   seq_qual_mismatch. tail_start is written by the one thread that sees the
//   newline of rank 4 * (total / 4).
// * compact_kernel writes each newline at its rank (dropping ranks at or
//   past max_count): as positions, padded with n past the count; or, for the
//   record offsets, straight into the [max_records, 5] rows (newline 4k + j
//   is field j + 1 of row k, and newline 4k + 3 also starts row k + 1), so
//   no position list is kept. records_kernel then takes a thread a row:
//   codes from its fields and two byte reads, -1 rows past the count.
// * gather_kernel treats each output as flat bytes in 16-byte words. A
//   block takes a run of rows whose bytes start 16-byte aligned (a multiple
//   of 16 / gcd(max_len, 16) rows), stages their starts and lengths in
//   shared memory, and gives a thread a 16-byte word of each output: the
//   bytes of each row the word overlaps (one, or two across a row's end)
//   are taken under a byte mask for the row's length, each from two aligned
//   16-byte loads and a funnel shift; only a source clamped into
//   [0, n - 1] (a row reading past the chunk's end) goes byte by byte with
//   the reference's int32 index arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 64;                // bytes a thread takes
constexpr int kTile = 16384;            // bytes a block takes
static_assert(kTile == kThreads * kSeg, "a tile is 64 bytes a thread");
constexpr int kMaxBins = 256;           // Phred bins the QC pass can keep
constexpr int kGatherRows = 1024;       // rows a gather block can stage
constexpr int kGatherBytes = 8192;      // output bytes a gather block aims at
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNl = 0x0a0a0a0au;

// a chunk read as 16-byte words: byte i at virtual position lead + i
struct Span {
  const uint4* words;
  long long lead;
  long long n;
};

Span make_span(const uint8_t* chunk, long long n) {
  const long long lead = (long long)((uintptr_t)chunk & 15);
  return Span{reinterpret_cast<const uint4*>(chunk - lead), lead, n};
}

long long tiles_of(const Span& s) {
  return s.n > 0 ? (s.lead + s.n + kTile - 1) / kTile : 0;
}

// bit 7 of each byte of x that equals the class byte (class < 0x80): the
// low 7 bits of byte ^ class plus 0x7f carry into bit 7 unless they are
// all 0, and never out of the byte
__device__ __forceinline__ uint32_t hits(uint32_t x, uint32_t cls) {
  return ~((((x & 0x7f7f7f7fu) ^ cls) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// bit b set when byte b of x is '\n': bits 7, 15, 23, 31 of the hits move
// to bits 21-24 of the product by 2^21 + 2^14 + 2^7 + 1 (no two partial
// products share a bit, so nothing carries)
__device__ __forceinline__ uint32_t nl_bits(uint32_t x) {
  return (((hits(x, kNl) >> 7) * 0x204081u) >> 21) & 0xFu;
}

// the thread's 64 bytes at virtual v0 (a multiple of 64) as 16 pieces;
// words that hold no chunk byte are not read and stay 0
__device__ __forceinline__ void load_seg(const Span& s, long long v0,
                                         uint32_t (&x)[16]) {
  uint4 w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long a = v0 + 16 * j;
    w[j] = a < s.lead + s.n ? s.words[a >> 4] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[4 * j] = w[j].x;
    x[4 * j + 1] = w[j].y;
    x[4 * j + 2] = w[j].z;
    x[4 * j + 3] = w[j].w;
  }
}

// bit k set when virtual position v0 + k lies in [lo, hi)
__device__ __forceinline__ uint64_t range_mask(long long v0, long long lo,
                                               long long hi) {
  long long a = lo - v0, b = hi - v0;
  a = a < 0 ? 0 : (a > kSeg ? kSeg : a);
  b = b < 0 ? 0 : (b > kSeg ? kSeg : b);
  if (b <= a) return 0;
  const uint64_t below_b = b == kSeg ? ~0ull : (1ull << b) - 1;
  const uint64_t below_a = (1ull << a) - 1;  // a < 64 here
  return below_b & ~below_a;
}

__device__ __forceinline__ uint64_t nl_mask(const uint32_t (&x)[16]) {
  uint64_t m = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) m |= (uint64_t)nl_bits(x[p]) << (4 * p);
  return m;
}

// exclusive prefix of v over the block's threads, and the block's total in
// `total`; every thread calls it. sh: kWarps + 1 ints of shared memory
__device__ __forceinline__ int block_scan(int v, int* sh, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? sh[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += t;
    }
    if (lane < kWarps) sh[lane] = wi - w;
    if (lane == kWarps - 1) sh[kWarps] = wi;
  }
  __syncthreads();
  const int r = sh[warp] + inc - v;
  total = sh[kWarps];
  __syncthreads();
  return r;
}

// newlines at virtual positions [lo, lead + n) of each tile into base[t];
// the last block to finish rewrites base[0..tiles) as exclusive prefixes and
// base[tiles] as the total. done: a counter zeroed by the caller
__global__ void __launch_bounds__(kThreads)
    newline_tiles_kernel(Span s, long long lo, int tiles, int* base,
                         unsigned* done) {
  __shared__ int sh[kWarps + 1];
  __shared__ bool last;
  const int t = blockIdx.x;
  const long long v0 = (long long)t * kTile + threadIdx.x * kSeg;
  uint32_t x[16];
  load_seg(s, v0, x);
  const int c = __popcll(nl_mask(x) & range_mask(v0, lo, s.lead + s.n));
  int total;
  block_scan(c, sh, total);
  if (threadIdx.x == 0) {
    base[t] = total;
    __threadfence();
    last = atomicAdd(done, 1u) == (unsigned)tiles - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each thread a run of consecutive tiles: their sum, a block prefix,
  // then the run rewritten in place
  const int per = (tiles + kThreads - 1) / kThreads;
  const int b0 = min((int)threadIdx.x * per, tiles);
  const int b1 = min(b0 + per, tiles);
  int sum = 0;
  for (int i = b0; i < b1; ++i) sum += __ldcg(base + i);
  int all;
  int run = block_scan(sum, sh, all);
  for (int i = b0; i < b1; ++i) {
    const int ci = __ldcg(base + i);
    base[i] = run;
    run += ci;
  }
  if (threadIdx.x == 0) base[tiles] = all;
}

// ------------------------------------------------------------ raw QC

// int32 outputs: reads, bases, tail_start, base_counts[5] (A C G T other),
// qual_hist[max_phred]; flags (bool bytes): bad_structure,
// seq_qual_mismatch, bad_ascii, bad_quality
enum { kReads = 0, kBases = 1, kTail = 2, kCounts = 3, kHist = 8 };
enum { kBadStructure = 0, kMismatch = 1, kBadAscii = 2, kBadQuality = 3 };

struct QcParams {
  int q_lo, q_hi, offset;  // each in 0..255
  int bins;                // histogram bins kept: min(max_phred, 256)
  int cap;                 // largest bin: min(max_phred - 1, 255)
};

struct QcOut {
  int* ints;
  uint8_t* flags;
  int* quals;      // scratch: quality bytes in complete records
  unsigned* done;  // scratch: blocks finished
};

__global__ void __launch_bounds__(kThreads)
    raw_qc_kernel(Span s, const int* base, int tiles, QcParams p, QcOut o) {
  __shared__ int hist[kWarps][kMaxBins];
  __shared__ int sums[7];  // bases, A, C, G, T, other, quals
  __shared__ int sh[kWarps + 1];
  for (int i = threadIdx.x; i < kWarps * kMaxBins; i += kThreads)
    (&hist[0][0])[i] = 0;
  if (threadIdx.x < 7) sums[threadIdx.x] = 0;

  const int t = blockIdx.x;
  const long long v0 = (long long)t * kTile + threadIdx.x * kSeg;
  uint32_t x[16];
  load_seg(s, v0, x);
  const uint64_t valid = range_mask(v0, s.lead, s.lead + s.n);
  int block_total;
  const int excl = block_scan(__popcll(nl_mask(x) & valid), sh,
                              block_total);
  const int total = __ldg(base + tiles);
  const int r4 = total & ~3;  // newlines of the complete records
  int rank = __ldg(base + t) + excl;
  const long long i0 = v0 - s.lead;  // chunk index of the segment's byte 0
  // byte 0 of the chunk starts a line; else the byte before the segment
  // says whether its first byte does
  bool prev = true;
  if (i0 > 0 && i0 <= s.n)
    prev = reinterpret_cast<const uint8_t*>(s.words)[v0 - 1] == '\n';

  int bases = 0, na = 0, nc = 0, ng = 0, nt = 0, quals = 0;
  bool bad_s = false, bad_q = false;
  uint32_t asc = 0;
  int* wh = hist[threadIdx.x >> 5];
  if (valid) {
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      const uint32_t b = (x[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      if (!((valid >> k) & 1)) continue;
      const bool nl = b == '\n';
      asc |= b;
      if (rank < r4) {
        const int ph = rank & 3;
        if (prev && ((ph == 0 && b != '@') || (ph == 2 && b != '+')))
          bad_s = true;
        if (!nl && ph == 1) {
          const uint32_t u = b & 0xDFu;
          ++bases;
          na += u == 'A';
          nc += u == 'C';
          ng += u == 'G';
          nt += u == 'T';
        } else if (!nl && ph == 3) {
          ++quals;
          const int q = (int)b < p.offset ? 0 : (int)b - p.offset;
          atomicAdd(&wh[q < p.cap ? q : p.cap], 1);
          bad_q |= ((int)b < p.q_lo) | ((int)b > p.q_hi);
        }
      }
      prev = nl;
      if (nl && ++rank == r4) o.ints[kTail] = (int)(i0 + k + 1);
    }
  }
  const int other = bases - na - nc - ng - nt;
  const int vals[7] = {bases, na, nc, ng, nt, other, quals};
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int w = __reduce_add_sync(kFull, vals[j]);
    if ((threadIdx.x & 31) == 0 && w) atomicAdd(&sums[j], w);
  }
  const bool any_s = __syncthreads_or(bad_s);
  const bool any_q = __syncthreads_or(bad_q);
  const bool any_a = __syncthreads_or(asc & 0x80u);
  for (int b = threadIdx.x; b < p.bins; b += kThreads) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w][b];
    if (c) atomicAdd(&o.ints[kHist + b], c);
  }
  if (threadIdx.x == 0) {
    if (sums[0]) atomicAdd(&o.ints[kBases], sums[0]);
    for (int j = 0; j < 5; ++j)
      if (sums[1 + j]) atomicAdd(&o.ints[kCounts + j], sums[1 + j]);
    if (sums[6]) atomicAdd(o.quals, sums[6]);
    if (any_s) o.flags[kBadStructure] = 1;
    if (any_q) o.flags[kBadQuality] = 1;
    if (any_a) o.flags[kBadAscii] = 1;
    if (t == 0) o.ints[kReads] = total >> 2;
    __threadfence();
    if (atomicAdd(o.done, 1u) == gridDim.x - 1) {
      __threadfence();
      o.flags[kMismatch] = __ldcg(o.ints + kBases) != __ldcg(o.quals);
    }
  }
}

// ------------------------------------------------------------ compaction

// each newline at virtual positions [lo, lead + n) written at its rank r
// (ranks at or past max_count dropped): pos[r] = its index, or, with
// pos == nullptr, into the [max_records, 5] offset rows. With pos, slots
// from the count to max_count take n and *count = the count (uncapped).
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Span s, long long lo, const int* base, int tiles,
                   long long max_count, int* pos, int* count, int* offsets,
                   long long max_records) {
  __shared__ int sh[kWarps + 1];
  const long long hi = s.lead + s.n;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long v0 = (long long)t * kTile + threadIdx.x * kSeg;
    uint32_t x[16];
    load_seg(s, v0, x);
    uint64_t m = nl_mask(x) & range_mask(v0, lo, hi);
    int block_total;
    long long r = (long long)__ldg(base + t) +
                  block_scan(__popcll(m), sh, block_total);
    const long long i0 = v0 - s.lead;
    for (; m && r < max_count; m &= m - 1, ++r) {
      const int i = (int)(i0 + __ffsll((long long)m) - 1);
      if (pos) {
        pos[r] = i;
      } else {
        const long long k = r >> 2;
        const int f = (int)(r & 3);
        if (f < 3) {
          offsets[5 * k + f + 1] = i + 1;
        } else {
          offsets[5 * k + 4] = i;
          if (k + 1 < max_records) offsets[5 * (k + 1)] = i + 1;
        }
      }
    }
  }
  if (pos) {
    const long long total = __ldg(base + tiles);
    if (blockIdx.x == 0 && threadIdx.x == 0) *count = (int)total;
    for (long long j = total + (long long)blockIdx.x * kThreads + threadIdx.x;
         j < max_count; j += (long long)gridDim.x * kThreads)
      pos[j] = (int)s.n;
  }
}

// ------------------------------------------------------------ records

// a thread a row: rows past the count are -1 with code 0; a complete row
// (fields 1-4 and, past row 0, field 0 written by compact_kernel) gets its
// header (start on row 0) and code: 1 no '@' at the header, else 2 no '+'
// at the separator, else 3 seq and qual lengths differ
__global__ void __launch_bounds__(kThreads)
    records_kernel(const uint8_t* chunk, long long n, int start,
                   const int* base, int tiles, long long max_records,
                   int* offsets, int* codes, int* n_rec) {
  const int nrec = __ldg(base + tiles) >> 2;
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_rec = nrec;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
       k < max_records; k += (long long)gridDim.x * kThreads) {
    int* row = offsets + 5 * k;
    if (k >= nrec) {
#pragma unroll
      for (int f = 0; f < 5; ++f) row[f] = -1;
      codes[k] = 0;
      continue;
    }
    int h;
    if (k == 0) {
      h = start;
      row[0] = start;
    } else {
      h = row[0];
    }
    const int s1 = row[1], s2 = row[2], s3 = row[3], e = row[4];
    const long long last = n - 1;
    const long long p = s2 < 0 ? 0 : (s2 > last ? last : s2);
    const long long hh = h < 0 ? 0 : (h > last ? last : h);
    int code = s2 - s1 - 1 != e - s3 ? 3 : 0;
    if (chunk[p] != '+') code = 2;
    if (chunk[hh] != '@') code = 1;
    codes[k] = code;
  }
}

// ------------------------------------------------------------ gather

// bytes [a, b) of a 16-byte word (0 <= a, b <= 16) as a mask
__device__ __forceinline__ uint4 byte_mask(int a, int b) {
  uint32_t m[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int lo = min(max(a - 4 * p, 0), 4), hi = min(max(b - 4 * p, 0), 4);
    m[p] = hi <= lo ? 0u
                    : (uint32_t)(((1ull << (8 * hi)) - 1) &
                                 ~((1ull << (8 * lo)) - 1));
  }
  return make_uint4(m[0], m[1], m[2], m[3]);
}

// the bytes of `mask` of a word whose byte j is column col0 + j of a row
// that starts at chunk index `start`: when the 16 source bytes lie in the
// chunk, two aligned 16-byte loads and a funnel shift; else byte by byte
// with the reference's int32 index clamped into [0, n - 1]
__device__ __forceinline__ uint4 row_window(const Span& s,
                                            const uint8_t* chunk, int start,
                                            int col0, uint4 mask) {
  const long long q = (long long)start + col0;
  if (q >= 0 && q + 16 <= s.n) {
    const long long v = s.lead + q;
    const uint4* w = s.words + (v >> 4);
    const int sh = (int)(v & 15);
    const uint4 a = w[0];
    const uint4 b = sh ? w[1] : make_uint4(0, 0, 0, 0);
    const uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int wq = sh >> 2;
    const unsigned bits = 8 * (sh & 3);
    uint32_t t[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      t[i] = wq == 0 ? u[i] : wq == 1 ? u[i + 1] : wq == 2 ? u[i + 2]
                                                          : u[i + 3];
    return make_uint4(__funnelshift_r(t[0], t[1], bits) & mask.x,
                      __funnelshift_r(t[1], t[2], bits) & mask.y,
                      __funnelshift_r(t[2], t[3], bits) & mask.z,
                      __funnelshift_r(t[3], t[4], bits) & mask.w);
  }
  const uint32_t m[4] = {mask.x, mask.y, mask.z, mask.w};
  uint32_t pk[4] = {0, 0, 0, 0};
  for (int j = 0; j < 16; ++j) {
    if (!((m[j >> 2] >> (8 * (j & 3))) & 0xFFu) || s.n <= 0) continue;
    const long long i = (int)((unsigned)start + (unsigned)(col0 + j));
    pk[j >> 2] |= (uint32_t)chunk[i < 0 ? 0 : (i >= s.n ? s.n - 1 : i)]
                  << (8 * (j & 3));
  }
  return make_uint4(pk[0], pk[1], pk[2], pk[3]);
}

__device__ __forceinline__ void or_into(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

// a block takes rows [row0, row0 + rows_per_block): its output bytes start
// 16-byte aligned (rows_per_block * max_len is a multiple of 16). A thread
// takes a 16-byte word of each output at a time: for each row the word
// overlaps (one, or two across a row's end), the row's in-length bytes
// under a byte mask
__global__ void __launch_bounds__(kThreads)
    gather_kernel(Span s, const uint8_t* chunk, const int* offsets,
                  long long max_records, int max_len, int rows_per_block,
                  uint8_t* seq, uint8_t* qual, int* lengths) {
  __shared__ int s_seq[kGatherRows], s_qual[kGatherRows], s_len[kGatherRows];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, max_records - row0);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int* o = offsets + 5 * (row0 + r);
    const bool valid = o[0] >= 0;
    const int a = valid ? o[1] : 0;
    // the reference's int32 arithmetic, wrapping as it does
    const int len = valid ? (int)((unsigned)o[2] - (unsigned)a - 1u) : 0;
    s_seq[r] = a;
    s_qual[r] = valid ? o[3] : 0;
    s_len[r] = len;
    lengths[row0 + r] = len;
  }
  __syncthreads();
  const int L = max_len;
  const unsigned bytes = (unsigned)rows * (unsigned)L;
  uint8_t* sb = seq + row0 * max_len;
  uint8_t* qb = qual + row0 * max_len;
  for (unsigned w = threadIdx.x; 16 * w < bytes; w += kThreads) {
    const unsigned o = 16 * w;
    const int nb = bytes - o < 16 ? (int)(bytes - o) : 16;
    int r = (int)(o / (unsigned)L);
    int c = (int)(o - (unsigned)r * (unsigned)L);
    uint4 vs = make_uint4(0, 0, 0, 0), vq = vs;
    // word bytes [j, j + take) are columns [c, c + take) of row r
    for (int j = 0; j < nb; j += L - c, c = 0, ++r) {
      const int take = min(nb - j, L - c);
      const int in_len = (int)min((long long)take, (long long)s_len[r] - c);
      if (in_len <= 0) continue;
      const uint4 m = byte_mask(j, j + in_len);
      or_into(vs, row_window(s, chunk, s_seq[r], c - j, m));
      or_into(vq, row_window(s, chunk, s_qual[r], c - j, m));
    }
    if (nb == 16) {
      reinterpret_cast<uint4*>(sb)[w] = vs;
      reinterpret_cast<uint4*>(qb)[w] = vq;
    } else {
      const uint32_t ps[4] = {vs.x, vs.y, vs.z, vs.w};
      const uint32_t pq[4] = {vq.x, vq.y, vq.z, vq.w};
      for (int j = 0; j < nb; ++j) {
        sb[o + j] = (uint8_t)(ps[j >> 2] >> (8 * (j & 3)));
        qb[o + j] = (uint8_t)(pq[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

// ------------------------------------------------------------ record count

// (sum of the row counts + newlines among the tail bytes) / 4 into *out;
// work: a sum and a counter of finished blocks, zeroed by the caller
__global__ void __launch_bounds__(kThreads)
    count_records_kernel(const int* counts, long long rows,
                         const uint8_t* tail, int tail_len, int* work,
                         int* out) {
  __shared__ int sh[kWarps];
  int c = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < rows;
       i += (long long)gridDim.x * kThreads)
    c += __ldg(counts + i);
  if (blockIdx.x == 0 && (int)threadIdx.x < tail_len)
    c += tail[threadIdx.x] == '\n';
  c = __reduce_add_sync(kFull, c);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += sh[w];
    if (sum) atomicAdd(work, sum);
    __threadfence();
    if (atomicAdd(reinterpret_cast<unsigned*>(work + 1), 1u) ==
        gridDim.x - 1) {
      __threadfence();
      *out = __ldcg(work) / 4;
    }
  }
}

int grid_for(long long items, long long per_block, int max_blocks) {
  long long g = (items + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > max_blocks) g = max_blocks;
  return (int)g;
}

// the tile counts and their prefixes (scratch: tiles + 1 ints, then the
// finished-block counter, zeroed here); newlines below chunk index `start`
// are not counted
cudaError_t newline_tiles(const Span& s, long long start, int tiles,
                          int* scratch, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      tiles > 0 ? scratch + tiles + 1 : scratch,
      0, (tiles > 0 ? 1 : 2) * sizeof(int), st);
  if (err != cudaSuccess || tiles == 0) return err;
  newline_tiles_kernel<<<tiles, kThreads, 0, st>>>(
      s, s.lead + start, tiles, scratch,
      reinterpret_cast<unsigned*>(scratch + tiles + 1));
  return cudaGetLastError();
}

}  // namespace

// raw_stream_qc: ints[8 + max_phred] and flags[4] as in raw_qc_kernel;
// scratch[tiles + 4]. q_lo, q_hi, offset are taken mod 256. `tiles`, which
// sized the scratch, must be ceil((chunk mod 16 + n) / kTile) (0 when n is
// 0), as in every entry point below
extern "C" int bs_raw_stream_qc(const uint8_t* chunk, long long n, int q_lo,
                                int q_hi, int offset, int max_phred,
                                int* ints, uint8_t* flags, int* scratch,
                                long long tiles, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Span s = make_span(chunk, n);
  if (max_phred < 1 || tiles != tiles_of(s) || tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(ints, 0, (8 + max_phred) * sizeof(int), st);
  cudaMemsetAsync(flags, 0, 4, st);
  cudaMemsetAsync(scratch + tiles + 2, 0, 2 * sizeof(int), st);
  if (tiles == 0) return (int)cudaGetLastError();
  cudaError_t err = newline_tiles(s, 0, (int)tiles, scratch, st);
  if (err != cudaSuccess) return (int)err;
  const QcParams p{q_lo & 255, q_hi & 255, offset & 255,
                   max_phred < kMaxBins ? max_phred : kMaxBins,
                   max_phred - 1 < 255 ? max_phred - 1 : 255};
  const QcOut o{ints, flags, scratch + tiles + 2,
                reinterpret_cast<unsigned*>(scratch + tiles + 3)};
  raw_qc_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(s, scratch, (int)tiles,
                                                      p, o);
  return (int)cudaGetLastError();
}

// newline positions from index `start` on: pos[max_count] padded with n,
// then pos[max_count] = the uncapped count; scratch[tiles + 2]
extern "C" int bs_newline_positions(const uint8_t* chunk, long long n,
                                    long long start, long long max_count,
                                    int* pos, int* scratch, long long tiles,
                                    int max_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Span s = make_span(chunk, n);
  if (tiles != tiles_of(s) || tiles > 0x7fffffff || start < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = newline_tiles(s, start, (int)tiles, scratch, st);
  if (err != cudaSuccess) return (int)err;
  const long long items = tiles > max_count / 1024 ? tiles : max_count / 1024;
  compact_kernel<<<grid_for(items, 1, max_blocks), kThreads, 0, st>>>(
      s, s.lead + start, scratch, (int)tiles, max_count, pos, pos + max_count,
      nullptr, 0);
  return (int)cudaGetLastError();
}

// record_offsets: offsets[max_records, 5], codes[max_records + 1] (the last
// entry takes the uncapped record count); scratch[tiles + 2]
extern "C" int bs_record_offsets(const uint8_t* chunk, long long n, int start,
                                 long long max_records, int* offsets,
                                 int* codes, int* scratch, long long tiles,
                                 int max_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Span s = make_span(chunk, n);
  if (tiles != tiles_of(s) || tiles > 0x7fffffff || start < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = newline_tiles(s, start, (int)tiles, scratch, st);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0 && max_records > 0) {
    compact_kernel<<<grid_for(tiles, 1, max_blocks), kThreads, 0, st>>>(
        s, s.lead + start, scratch, (int)tiles, 4 * max_records, nullptr,
        nullptr, offsets, max_records);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  records_kernel<<<grid_for(max_records, kThreads, max_blocks), kThreads, 0,
                   st>>>(chunk, n, start, scratch, (int)tiles, max_records,
                         offsets, codes, codes + max_records);
  return (int)cudaGetLastError();
}

// gather_padded: seq, qual u8[max_records, max_len] (16-byte aligned),
// lengths i32[max_records] from offsets i32[max_records, 5]
extern "C" int bs_gather_padded(const uint8_t* chunk, long long n,
                                const int* offsets, long long max_records,
                                int max_len, uint8_t* seq, uint8_t* qual,
                                int* lengths, void* stream) {
  if (max_records <= 0) return (int)cudaSuccess;
  if (max_len < 0 || max_len >= (1 << 24) ||
      (((uintptr_t)seq | (uintptr_t)qual) & 15))
    return (int)cudaErrorInvalidValue;
  // rows a block: a multiple of g = 16 / gcd(max_len, 16), so that each
  // block's bytes start 16-byte aligned, near kGatherBytes bytes
  int g = 16;
  while (g > 1 && max_len % (16 / g * 2) == 0) g /= 2;
  long long rpb = kGatherRows;
  if (max_len > 0) {
    const long long m = kGatherBytes / ((long long)max_len * g);
    rpb = g * (m > 1 ? m : 1);
    if (rpb > kGatherRows) rpb = kGatherRows;
  }
  const long long blocks = (max_records + rpb - 1) / rpb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      make_span(chunk, n), chunk, offsets, max_records, max_len, (int)rpb,
      seq, qual, lengths);
  return (int)cudaGetLastError();
}

// count_records_device: (sum of counts[rows] + newlines in tail[tail_len])
// / 4 into *out; work: 2 ints, zeroed here
extern "C" int bs_count_records(const int* counts, long long rows,
                                const uint8_t* tail, int tail_len, int* work,
                                int* out, int max_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tail_len < 0 || tail_len > kThreads) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(work, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  count_records_kernel<<<grid_for(rows, 8 * kThreads, max_blocks), kThreads,
                         0, st>>>(counts, rows, tail, tail_len, work, out);
  return (int)cudaGetLastError();
}
