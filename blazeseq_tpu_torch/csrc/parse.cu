// The device-parse API for Hopper (sm_90a): raw-stream QC, newline
// compaction, record offsets and codes, the padded gather, and the record
// count of a chunk whose length is not a multiple of 128.
//
// Replaces XLA code of the reference (none of it is a Pallas kernel):
//   raw_qc_kernel,       blazeseq_tpu/ops/raw_stats.py:64-127 raw_stream_qc
//   raw_tail_kernel
//   compact_kernel,      blazeseq_tpu/ops/scan.py:98-135 _compact_positions,
//   pad_kernel           newline_positions_device
//   records_kernel       blazeseq_tpu/ops/scan.py:138-176
//                        record_offsets_device (after compact_kernel)
//   gather_kernel        blazeseq_tpu/ops/scan.py:179-196 gather_padded_device
//   count_records_kernel blazeseq_tpu/ops/scan.py:216-228
//                        count_records_device's sum of the scan kernel's row
//                        counts, with the n % 128 bytes past them (the
//                        reference pads the chunk with a copy instead)
// One source for the two reference modules: the QC pass and the compaction
// rank the chunk's 16 KiB tiles alike and share the byte tests.
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
// * Tile ranks in the same read (the QC pass and the compaction). Blocks
//   take tiles in order from a counter; a tile publishes its newline count
//   in a 64-bit status word, one warp sums the words of the tiles below it
//   back to the nearest inclusive one (a decoupled look-back), and the tile
//   publishes its inclusive count; a block scan of the threads' counts
//   gives each thread the rank of its first byte. Scratch: 8 bytes a tile
//   and a few counters (131 KB per 256 MiB).
// * raw_qc_kernel (a persistent grid) judges a thread's 64 bytes with
//   64-bit masks that every lane computes alike, with no branch on a
//   byte's phase: the newline mask m; the phase bits P0 (the exclusive
//   prefix-XOR of m, XOR bit 0 of the rank) and P1 (the exclusive
//   prefix-XOR of m & P0, XOR bit 1); sequence bytes P0 & ~P1 & ~m, quality
//   bytes P0 & P1 & ~m, line starts (m << 1) | (the byte before is '\n').
//   Line starts of phase 0 or 2 are checked from the thread's copy of its
//   bytes in shared memory. Each sequence or quality byte then takes one
//   predicated step: prmt packs the byte and its quality bit into an index
//   of a 512-word table in shared memory, which names the 8-bit counter to
//   add one to (A C G T, a never-read byte for other bases, the Phred bin,
//   or the count of quality bytes out of range, which a slow path bins);
//   each lane owns its counters in its own bank, so an increment is a
//   plain load, add and store. A C G T are read back each tile; the Phred
//   counters are summed into the output every kFlushTiles tiles, before
//   one can pass 255. raw_stream_qc counts only the bytes before the last
//   complete record's end, and that end is known only once every tile is
//   ranked: the pass counts every byte, keeps the structure and quality
//   flags as the least index that breaks them, and raw_tail_kernel finds
//   the tile of the (4 * (total / 4))-th newline by binary search over the
//   inclusive counts, takes back what the bytes past it added, writes
//   tail_start, and sets the flags that depend on it.
// * compact_kernel (a block a tile) stages the tile's newline indices in
//   shared memory at their ranks in the tile and stores them in order:
//   positions (pad_kernel then fills slots from the count to max_count
//   with n and writes the count), or, for the record offsets, the fields
//   of the [max_records, 5] rows that the tile's ranks own (newline 4k + j
//   is field j + 1 of row k, and newline 4k + 3 also field 0 of row k + 1:
//   a run of ranks owns a run of the flat rows), so no position list is
//   kept. records_kernel then takes a thread a row: codes from its fields
//   and two byte reads, -1 rows past the count.
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
// to bits 28-31 of the product by 2^21 + 2^14 + 2^7 + 1 (no two partial
// products share a bit, so nothing carries)
__device__ __forceinline__ uint32_t nl_bits(uint32_t x) {
  return (hits(x, kNl) * 0x204081u) >> 28;
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

// ------------------------------------------------------------ tile ranks

// The QC pass and the compaction give each tile its rank (the newlines
// below it) in the same pass that reads it, by a decoupled look-back:
// blocks take tiles in order from a counter, so a tile waits only on tiles
// that running blocks hold. A tile's status word is 0 until the tile is
// counted, then a flag in the high half and a count in the low: kAgg with
// the tile's own count, later kIncl with every newline below the tile's
// end (below 2^31: offsets are int32).
constexpr unsigned long long kAgg = 1ull << 32;
constexpr unsigned long long kIncl = 2ull << 32;

// the look-back's scratch, zeroed: a status word a tile, the tile counter,
// and the count of every newline, which the last tile writes
struct Ranks {
  unsigned long long* status;
  unsigned* claim;
  int* total;
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// The newlines of tiles 0..t-1, by one warp looking back 32 tiles a step
// over their status words until a tile with kIncl (spinning on tiles not
// counted yet: their blocks took them earlier and publish kAgg before they
// look back themselves).
__device__ unsigned look_back(const unsigned long long* status, int t,
                              int lane) {
  unsigned sum = 0;
  for (int j = t - 1; j >= 0; j -= 32) {
    const int i = j - lane;
    unsigned long long v;
    unsigned incl, need;
    while (true) {
      v = i >= 0 ? load_status(status + i) : kIncl;
      incl = __ballot_sync(kFull, (v >> 32) == (kIncl >> 32));
      // the lanes up to the nearest inclusive status must all be ready
      need = incl ? (incl & (0u - incl)) * 2u - 1u : kFull;
      if ((__ballot_sync(kFull, (v >> 32) != 0) & need) == need) break;
      __nanosleep(32);
    }
    sum += __reduce_add_sync(kFull, (need >> lane) & 1 ? (unsigned)v : 0u);
    if (incl) break;
  }
  return sum;
}

// the block's next tile; every thread calls it (s_tile: shared)
__device__ __forceinline__ int claim_tile(const Ranks& r, int* s_tile) {
  if (threadIdx.x == 0) *s_tile = (int)atomicAdd(r.claim, 1u);
  __syncthreads();
  return *s_tile;
}

// the newlines below tile t, which holds `count`: warp 0 publishes the
// count, looks back, then publishes the inclusive count (the last tile also
// the total); every thread calls it (s_below: shared)
__device__ unsigned rank_tile(const Ranks& r, int t, int tiles, int count,
                              unsigned* s_below) {
  if (threadIdx.x < 32) {
    unsigned below = 0;
    if (t > 0) {
      if (threadIdx.x == 0) atomicExch(r.status + t, kAgg | (unsigned)count);
      below = look_back(r.status, t, threadIdx.x);
    }
    if (threadIdx.x == 0) {
      atomicExch(r.status + t, kIncl | (below + (unsigned)count));
      if (t == tiles - 1) *r.total = (int)(below + count);
      *s_below = below;
    }
  }
  __syncthreads();
  return *s_below;
}

// the newlines up to the end of tile t, once the pass has ranked every tile
__device__ __forceinline__ int newlines_through(const Ranks& r, int t) {
  return (int)(unsigned)__ldcg(r.status + t);
}

// ------------------------------------------------------------ raw QC

// int32 outputs: reads, bases, tail_start, base_counts[5] (A C G T other),
// qual_hist[max_phred]; flags (bool bytes): bad_structure,
// seq_qual_mismatch, bad_ascii, bad_quality
enum { kReads = 0, kBases = 1, kTail = 2, kCounts = 3, kHist = 8 };
enum { kBadStructure = 0, kMismatch = 1, kBadAscii = 2, kBadQuality = 3 };

// a lane adds at most kSeg to its 8-bit Phred counters a tile: flush them
// every kFlushTiles tiles (3 * 64 < 256)
constexpr int kFlushTiles = 3;
// the QC pass's dynamic shared memory: the byte table, the threads'
// segments, then each warp's counters (qc_region bytes a warp)
constexpr int kLutBytes = 512 * 4;
constexpr int kSegBytes = kThreads * kSeg;
// A lane's 8-bit counters, as byte offsets from its own byte 4 * lane of
// its warp's region (so that each lane keeps to its own bank): Phred bin b
// at ((b >> 2) << 7) | (b & 3), below cls = 1 << wshift; then A C G T of
// the sequence bytes (cls + 0..3), a byte that every other sequence byte
// adds to and that is never read (cls + kDummy), and the count of quality
// bytes outside [q_lo, q_hi] (cls + kBad), which a slow path bins instead
constexpr int kDummy = 128, kBad = 129;

struct QcParams {
  int q_lo, q_hi, offset;  // each in 0..255
  int bins;                // histogram bins kept: min(max_phred, 256)
  int cap;                 // largest bin: min(max_phred - 1, 255)
  int wshift;              // a lane's Phred counters span 1 << wshift bytes
};

__host__ __device__ __forceinline__ int qc_region(int wshift) {
  return (1 << wshift) + 256;
}

struct QcOut {
  int* ints;
  uint8_t* flags;
};

// the QC pass's scratch beyond the tile ranks
struct QcScratch {
  Ranks r;
  int* quals;      // quality bytes counted, zeroed
  int* bad_s;      // least index of a bad line start (0x7f7f7f7f: none)
  int* bad_q;      // least index of a quality byte out of range (the same)
  unsigned* done;  // raw_tail_kernel's blocks finished, zeroed
};

// bit k set when bit k of y or of a bit below it is set an odd number of
// times: the inclusive prefix-XOR of a 64-bit word
__device__ __forceinline__ uint64_t prefix_xor(uint64_t y) {
  y ^= y << 1;
  y ^= y << 2;
  y ^= y << 4;
  y ^= y << 8;
  y ^= y << 16;
  y ^= y << 32;
  return y;
}

// a thread's 64 bytes into its slots of seg (4 * kThreads 16-byte words in
// shared memory, conflict-free), for the few bytes that are read by index
__device__ __forceinline__ void stash(uint4* seg, const uint32_t (&x)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    seg[j * kThreads + threadIdx.x] =
        make_uint4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}

// byte k of the thread's stashed 64 bytes
__device__ __forceinline__ int stashed(const uint4* seg, int k) {
  return reinterpret_cast<const uint8_t*>(seg + (k >> 4) * kThreads +
                                          threadIdx.x)[k & 15];
}

// the line phase of each byte of a segment whose newline mask is m and
// whose first byte has rank R (newlines before it), as two bit masks: P0 =
// rank & 1 (the exclusive prefix-XOR of m), P1 = (rank >> 1) & 1 (bit 1 of
// the count flips at the newlines whose count before them is odd)
__device__ __forceinline__ void phase_bits(uint64_t m, int R, uint64_t& p0,
                                           uint64_t& p1) {
  p0 = prefix_xor(m) ^ m ^ (R & 1 ? ~0ull : 0ull);
  const uint64_t odd = m & p0;
  p1 = prefix_xor(odd) ^ odd ^ (R & 2 ? ~0ull : 0ull);
}

// the position of the d-th set bit of m (1 <= d <= popcount(m)): halve the
// window while its low half holds fewer than d set bits
__device__ __forceinline__ int select64(uint64_t m, int d) {
  int p = 0;
#pragma unroll
  for (int w = 32; w; w >>= 1) {
    const int c = __popcll(m & ((1ull << w) - 1));
    if (c < d) {
      d -= c;
      m >>= w;
      p += w;
    }
  }
  return p;
}

// 0x01 in byte b of the result for bit b of the 4-bit nib
__device__ __forceinline__ uint32_t byte_ones(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// byte i of a, then byte i of b, then two copies of b's byte i's top bit
// (prmt's sign mode): with b's bytes 0 or 1, the table index a_i | b_i << 8
template <int i>
__device__ __forceinline__ uint32_t byte_and_flag(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = i | (4 + i) << 4 | (12 + i) << 8 | (12 + i) << 12;
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "n"(sel));
  return d;
}

__device__ __forceinline__ int phred_bin(int b, const QcParams& p) {
  const int q = b < p.offset ? 0 : b - p.offset;
  return q < p.cap ? q : p.cap;
}

__device__ __forceinline__ int bin_offset(int bin) {
  return ((bin >> 2) << 7) | (bin & 3);
}

// the block's Phred counters summed into out[0..bins) and zeroed; every
// thread calls it. A warp takes word w of each lane's counters across the
// warps, four 8-bit counters in two 16-bit halves (at most kFlushTiles *
// kSeg * kThreads = 49,152 a counter, below 2^16)
__device__ void flush_hist(uint8_t* hist, int wshift, int bins, int* out) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < 1 << (wshift - 7); w += kWarps) {
    uint32_t even = 0, odd = 0;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) {
      uint32_t* p = reinterpret_cast<uint32_t*>(hist + g * qc_region(wshift)) +
                    32 * w + lane;
      const uint32_t v = *p;
      *p = 0;
      even += v & 0x00FF00FFu;
      odd += (v >> 8) & 0x00FF00FFu;
    }
    even = __reduce_add_sync(kFull, even);
    odd = __reduce_add_sync(kFull, odd);
    const int bin = 4 * w + lane;  // lanes 0-3: the word's four counters
    if (lane < 4 && bin < bins) {
      const uint32_t half = lane & 1 ? odd : even;
      const int c = (int)((lane & 2 ? half >> 16 : half) & 0xFFFFu);
      if (c) atomicAdd(out + bin, c);
    }
  }
  __syncthreads();
}

// One read of the chunk by a persistent grid whose blocks take tiles in
// order and rank them by look-back. A thread's 64 bytes are judged with
// 64-bit masks that every lane computes alike: the newline mask m and the
// phase bits P0, P1 (the newlines before each byte, plus the segment's rank
// R, mod 4) as prefix-XORs. Then one step a byte, the same for every lane
// and predicated on the byte being a sequence or quality byte: a 512-word
// table in shared memory, indexed by the byte and its quality bit, gives
// the counter it adds one to (A C G T or the never-read byte for a
// sequence byte, the Phred bin or the out-of-range count for a quality
// byte), and the lane adds one to that 8-bit counter of its own. The total
// is not known yet, so every byte counts as complete; raw_tail_kernel
// takes the partial record back, and the structure and quality flags are
// kept as the least index that breaks them.
__global__ void __launch_bounds__(kThreads)
    raw_qc_kernel(Span s, int tiles, QcParams p, QcOut o, QcScratch q) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  uint4* seg = reinterpret_cast<uint4*>(smem + kLutBytes);
  uint8_t* hist = smem + kLutBytes + kSegBytes;
  __shared__ int sums[7];  // bases, A, C, G, T, other, quals
  __shared__ int sh[kWarps + 1];
  __shared__ int s_tile;
  __shared__ unsigned s_below;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cls = 1 << p.wshift;
  for (int b = threadIdx.x; b < 256; b += kThreads) {
    const int u = b & 0xDF;
    lut[b] = u == 'A' ? cls : u == 'C' ? cls + 1 : u == 'G' ? cls + 2
           : u == 'T' ? cls + 3 : cls + kDummy;
    lut[256 + b] = b < p.q_lo || b > p.q_hi ? cls + kBad
                                             : bin_offset(phred_bin(b, p));
  }
  for (int i = threadIdx.x; i < kWarps * qc_region(p.wshift) / 16;
       i += kThreads)
    reinterpret_cast<uint4*>(hist)[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x < 7) sums[threadIdx.x] = 0;
  uint8_t* mine = hist + warp * qc_region(p.wshift) + 4 * lane;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(s.words);

  int bases = 0, na = 0, nc = 0, ng = 0, nt = 0, quals = 0;
  int bad_s = 0x7f7f7f7f, bad_q = 0x7f7f7f7f;
  uint32_t asc = 0;
  int since = 0;  // tiles since the counters' last flush
  __syncthreads();
  while (true) {
    const int t = claim_tile(q.r, &s_tile);
    if (t >= tiles) break;
    const long long v0 = (long long)t * kTile + threadIdx.x * kSeg;
    uint32_t x[16];
    load_seg(s, v0, x);
    const uint64_t valid = range_mask(v0, s.lead, s.lead + s.n);
    const uint64_t m = nl_mask(x) & valid;
    int count;
    const int excl = block_scan(__popcll(m), sh, count);
    const int R = (int)rank_tile(q.r, t, tiles, count, &s_below) + excl;
    const long long i0 = v0 - s.lead;  // chunk index of the segment's byte 0
    uint64_t p0, p1;
    phase_bits(m, R, p0, p1);
    // sequence and quality bytes, every one counted (raw_tail_kernel takes
    // back those of the partial record)
    const uint64_t body = valid & ~m & p0;
    const uint64_t qual = body & p1;
    // a line starts at chunk byte 0 and after each newline
    uint64_t first = 0;
    if (i0 <= 0)
      first = 1ull << (-i0);
    else if (i0 <= s.n)
      first = bytes[v0 - 1] == '\n';
    const uint64_t starts = ((m << 1) | first) & valid & ~p0;
    const uint64_t plus = starts & p1;  // phase 2: '+'; phase 0: '@'
    if (starts) {
      // the few line starts from the thread's own copy of its bytes
      stash(seg, x);
      for (uint64_t q = starts; q; q &= q - 1) {
        const int k = __ffsll((long long)q) - 1;
        const int b = stashed(seg, k);
        if (b != ((plus >> k) & 1 ? '+' : '@'))
          bad_s = min(bad_s, (int)(i0 + k));
      }
    }
    if (valid == ~0ull) {
#pragma unroll
      for (int j = 0; j < 16; ++j) asc |= x[j];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        asc |= x[j] & byte_ones((uint32_t)(valid >> (4 * j)) & 0xFu) * 0xFFu;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t qf = byte_ones((uint32_t)(qual >> (4 * j)) & 0xFu);
      const uint32_t w = x[j];
      if ((body >> (4 * j)) & 1) ++mine[lut[byte_and_flag<0>(w, qf)]];
      if ((body >> (4 * j + 1)) & 1) ++mine[lut[byte_and_flag<1>(w, qf)]];
      if ((body >> (4 * j + 2)) & 1) ++mine[lut[byte_and_flag<2>(w, qf)]];
      if ((body >> (4 * j + 3)) & 1) ++mine[lut[byte_and_flag<3>(w, qf)]];
    }
    const int nq = __popcll(qual);
    bases += __popcll(body) - nq;
    quals += nq;
    uint32_t* acgt = reinterpret_cast<uint32_t*>(mine + cls);
    const uint32_t a = *acgt;
    *acgt = 0;
    na += a & 0xFF;
    nc += (a >> 8) & 0xFF;
    ng += (a >> 16) & 0xFF;
    nt += a >> 24;
    if (mine[cls + kBad]) {
      // quality bytes outside [q_lo, q_hi]: into their bins one by one
      mine[cls + kBad] = 0;
      stash(seg, x);
      for (uint64_t q = qual; q; q &= q - 1) {
        const int k = __ffsll((long long)q) - 1;
        const int b = stashed(seg, k);
        if (b < p.q_lo || b > p.q_hi) {
          ++mine[bin_offset(phred_bin(b, p))];
          bad_q = min(bad_q, (int)(i0 + k));
        }
      }
    }
    if (++since == kFlushTiles) {
      flush_hist(hist, p.wshift, p.bins, o.ints + kHist);
      since = 0;
    }
  }
  if (since) flush_hist(hist, p.wshift, p.bins, o.ints + kHist);
  const int other = bases - na - nc - ng - nt;
  const int vals[7] = {bases, na, nc, ng, nt, other, quals};
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int w = __reduce_add_sync(kFull, vals[j]);
    if (lane == 0 && w) atomicAdd(&sums[j], w);
  }
  const int ws = __reduce_min_sync(kFull, bad_s);
  const int wq = __reduce_min_sync(kFull, bad_q);
  if (lane == 0 && ws != 0x7f7f7f7f) atomicMin(q.bad_s, ws);
  if (lane == 0 && wq != 0x7f7f7f7f) atomicMin(q.bad_q, wq);
  const bool any_a = __syncthreads_or(asc & 0x80808080u);
  if (threadIdx.x == 0) {
    if (sums[0]) atomicAdd(&o.ints[kBases], sums[0]);
    for (int j = 0; j < 5; ++j)
      if (sums[1 + j]) atomicAdd(&o.ints[kCounts + j], sums[1 + j]);
    if (sums[6]) atomicAdd(q.quals, sums[6]);
    if (any_a) o.flags[kBadAscii] = 1;
  }
}

// Takes back what raw_qc_kernel counted of the bytes past the last complete
// record ([tail_start, n): fewer than 4 newlines, any number of bytes),
// then sets what depends on tail_start. Each block finds the tile that
// holds newline r4 by a binary search over the inclusive counts, then the
// blocks walk the tiles from there.
__global__ void __launch_bounds__(kThreads)
    raw_tail_kernel(Span s, int tiles, QcParams p, QcOut o, QcScratch q) {
  __shared__ uint4 seg[4 * kThreads];
  __shared__ int hist[kMaxBins];
  __shared__ int sums[7];  // bases, A, C, G, T, other, quals
  __shared__ int sh[kWarps + 1];
  for (int i = threadIdx.x; i < p.bins; i += kThreads) hist[i] = 0;
  if (threadIdx.x < 7) sums[threadIdx.x] = 0;
  const int total = __ldcg(q.r.total);
  const int r4 = total & ~3;
  int lo = 0;
  if (r4 > 0) {
    int hi = tiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (newlines_through(q.r, mid) >= r4)
        hi = mid;
      else
        lo = mid + 1;
    }
  }
  __syncthreads();
  int bases = 0, na = 0, nc = 0, ng = 0, nt = 0, quals = 0;
  for (int t = lo + blockIdx.x; t < tiles; t += gridDim.x) {
    const long long v0 = (long long)t * kTile + threadIdx.x * kSeg;
    uint32_t x[16];
    load_seg(s, v0, x);
    const uint64_t valid = range_mask(v0, s.lead, s.lead + s.n);
    const uint64_t m = nl_mask(x) & valid;
    int count;
    const int R = (t > 0 ? newlines_through(q.r, t - 1) : 0) +
                  block_scan(__popcll(m), sh, count);
    const long long i0 = v0 - s.lead;
    // the tail: bytes whose rank is r4 or more, past the r4-th newline
    uint64_t tail = valid;
    if (R < r4) {
      const int d = r4 - R;
      if (d > __popcll(m)) {
        tail = 0;
      } else {
        const int k = select64(m, d);
        tail = valid & ~(~0ull >> (63 - k));
        o.ints[kTail] = (int)(i0 + k + 1);
      }
    }
    uint64_t p0, p1;
    phase_bits(m, R, p0, p1);
    const uint64_t body = tail & ~m & p0;
    const uint64_t qual = body & p1;
    if (!body) continue;
    stash(seg, x);
    for (uint64_t r = body; r; r &= r - 1) {
      const int k = __ffsll((long long)r) - 1;
      const int b = stashed(seg, k);
      if ((qual >> k) & 1) {
        atomicAdd(&hist[phred_bin(b, p)], 1);
      } else {
        const int u = b & 0xDF;
        na += u == 'A';
        nc += u == 'C';
        ng += u == 'G';
        nt += u == 'T';
      }
    }
    const int nq = __popcll(qual);
    bases += __popcll(body) - nq;
    quals += nq;
  }
  const int other = bases - na - nc - ng - nt;
  const int vals[7] = {bases, na, nc, ng, nt, other, quals};
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int w = __reduce_add_sync(kFull, vals[j]);
    if ((threadIdx.x & 31) == 0 && w) atomicAdd(&sums[j], w);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.bins; i += kThreads)
    if (hist[i]) atomicSub(&o.ints[kHist + i], hist[i]);
  if (threadIdx.x == 0) {
    if (sums[0]) atomicSub(&o.ints[kBases], sums[0]);
    for (int j = 0; j < 5; ++j)
      if (sums[1 + j]) atomicSub(&o.ints[kCounts + j], sums[1 + j]);
    if (sums[6]) atomicSub(q.quals, sums[6]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(q.done, 1u) == gridDim.x - 1) {
    __threadfence();
    const int tail = __ldcg(o.ints + kTail);
    o.ints[kReads] = total >> 2;
    o.flags[kBadStructure] = __ldcg(q.bad_s) < tail;
    o.flags[kBadQuality] = __ldcg(q.bad_q) < tail;
    o.flags[kMismatch] = __ldcg(o.ints + kBases) != __ldcg(q.quals);
  }
}

// ------------------------------------------------------------ compaction

// newline ranks a compaction block stages at once (16 KiB)
constexpr int kStage = 4096;

// ranks [r0, r0 + k) (staged: stage[r - r0] = the index of newline r) into
// the [max_records, 5] offset rows: newline 4j + f is field f + 1 of row j
// (its index + 1; field 4, f = 3, its index) and newline 4j + 3 also field
// 0 of row j + 1. The ranks own the elements [first, last] of the flat rows
// and no other, so a block writes them in order.
__device__ void store_rows(const int* stage, long long r0, int k,
                           long long max_records, int* offsets) {
  const long long r1 = min(r0 + k, 4 * max_records);
  if (r0 >= r1) return;
  const long long rl = r1 - 1;
  const unsigned e0 = (unsigned)(5 * (r0 >> 2) + (r0 & 3) + 1);
  const unsigned e1 = (unsigned)min(
      5 * (rl >> 2) + (rl & 3) + 2 + ((rl & 3) == 3), 5 * max_records);
  const unsigned q0 = (unsigned)r0;
  for (unsigned e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const unsigned row = e / 5u, f = e - 5u * row;
    const unsigned r = f == 0 ? 4u * row - 1u : 4u * row + f - 1u;
    offsets[e] = stage[r - q0] + (f == 4 ? 0 : 1);
  }
}

// Newlines at virtual positions [lo, lead + n) in order of rank, in one
// read: a block claims the next tile, counts its newlines (a block scan
// gives each thread its rank in the tile), publishes the count, takes the
// count below the tile by look-back, publishes the inclusive count, then
// stages the tile's positions in shared memory at their ranks and stores
// them in order: pos[r] = the index for ranks below max_count, or, with
// pos == nullptr, the offset rows (store_rows).
__global__ void __launch_bounds__(kThreads)
    compact_kernel(Span s, long long lo, int tiles, Ranks r,
                   long long max_count, int* pos, int* offsets,
                   long long max_records) {
  __shared__ int stage[kStage];
  __shared__ int sh[kWarps + 1];
  __shared__ int s_tile;
  __shared__ unsigned s_below;
  const int t = claim_tile(r, &s_tile);
  const long long v0 = (long long)t * kTile + threadIdx.x * kSeg;
  uint32_t x[16];
  load_seg(s, v0, x);
  const uint64_t m = nl_mask(x) & range_mask(v0, lo, s.lead + s.n);
  const int cnt = __popcll(m);
  int count;
  const int excl = block_scan(cnt, sh, count);
  // the rank of the tile's first newline
  const long long first = rank_tile(r, t, tiles, count, &s_below);
  const long long i0 = v0 - s.lead;
  // rounds of kStage ranks (one, unless the tile holds more newlines)
  for (int a = 0; a < count; a += kStage) {
    if (excl < a + kStage && excl + cnt > a) {
      int rank = excl;
      for (uint64_t mm = m; mm; mm &= mm - 1, ++rank)
        if (rank >= a && rank < a + kStage)
          stage[rank - a] = (int)(i0 + __ffsll((long long)mm) - 1);
    }
    __syncthreads();
    const int k = min(kStage, count - a);
    const long long r0 = first + a;
    if (pos) {
      for (int q = threadIdx.x; q < k && r0 + q < max_count; q += kThreads)
        pos[r0 + q] = stage[q];
    } else {
      store_rows(stage, r0, k, max_records, offsets);
    }
    __syncthreads();
  }
}

// pos[count, max_count) = n and pos[max_count] = count, the count read
// from where the compaction left it
__global__ void __launch_bounds__(kThreads)
    pad_kernel(const int* total, long long max_count, int n, int* pos) {
  const long long count = __ldg(total);
  if (blockIdx.x == 0 && threadIdx.x == 0) pos[max_count] = (int)count;
  for (long long j = count + (long long)blockIdx.x * kThreads + threadIdx.x;
       j < max_count; j += (long long)gridDim.x * kThreads)
    pos[j] = n;
}

// ------------------------------------------------------------ records

// a thread a row: rows past the count are -1 with code 0; a complete row
// (fields 1-4 and, past row 0, field 0 written by compact_kernel) gets its
// header (start on row 0) and code: 1 no '@' at the header, else 2 no '+'
// at the separator, else 3 seq and qual lengths differ
__global__ void __launch_bounds__(kThreads)
    records_kernel(const uint8_t* chunk, long long n, int start,
                   const int* total, long long max_records, int* offsets,
                   int* codes, int* n_rec) {
  const int nrec = __ldg(total) >> 2;
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

// the tile ranks' scratch and `extra` ints after it, zeroed
Ranks ranks_scratch(int* scratch, long long tiles, int extra, cudaStream_t st,
                    cudaError_t& err) {
  err = cudaMemsetAsync(scratch, 0, (2 * tiles + 2 + extra) * sizeof(int), st);
  int* tail = scratch + 2 * tiles;
  return Ranks{reinterpret_cast<unsigned long long*>(scratch),
               reinterpret_cast<unsigned*>(tail), tail + 1};
}

}  // namespace

// raw_stream_qc: ints[8 + max_phred] and flags[4] as in raw_qc_kernel;
// scratch[2 * tiles + 8]. q_lo, q_hi, offset are taken mod 256. `tiles`,
// which sized the scratch, must be ceil((chunk mod 16 + n) / kTile) (0
// when n is 0), as in every entry point below
extern "C" int bs_raw_stream_qc(const uint8_t* chunk, long long n, int q_lo,
                                int q_hi, int offset, int max_phred,
                                int* ints, uint8_t* flags, int* scratch,
                                long long tiles, int sm_count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Span s = make_span(chunk, n);
  if (max_phred < 1 || tiles != tiles_of(s) || tiles > 0x7fffffff ||
      sm_count < 1)
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(ints, 0, (8 + max_phred) * sizeof(int), st);
  cudaMemsetAsync(flags, 0, 4, st);
  if (tiles == 0) return (int)cudaGetLastError();
  cudaError_t err;
  const Ranks r = ranks_scratch(scratch, tiles, 4, st, err);
  if (err != cudaSuccess) return (int)err;
  int* more = scratch + 2 * tiles + 2;
  err = cudaMemsetAsync(more + 1, 0x7f, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const QcScratch q{r, more, more + 1, more + 2,
                    reinterpret_cast<unsigned*>(more + 3)};
  // a lane's counters: 4 bins a word, a power of two of words
  const int bins = max_phred < kMaxBins ? max_phred : kMaxBins;
  int wshift = 7;
  while ((4 << (wshift - 7)) < bins) ++wshift;
  const QcParams p{q_lo & 255, q_hi & 255, offset & 255, bins,
                   max_phred - 1 < 255 ? max_phred - 1 : 255, wshift};
  const QcOut o{ints, flags};
  const int smem = kLutBytes + kSegBytes + kWarps * qc_region(wshift);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(raw_qc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raw_qc_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = per_sm < 1 ? 1 : (long long)per_sm * sm_count;
  raw_qc_kernel<<<(unsigned)(grid < tiles ? grid : tiles), kThreads, smem,
                  st>>>(s, (int)tiles, p, o, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  raw_tail_kernel<<<(unsigned)(2 * sm_count < tiles ? 2 * sm_count : tiles),
                    kThreads, 0, st>>>(s, (int)tiles, p, o, q);
  return (int)cudaGetLastError();
}

// newline positions from index `start` on: pos[max_count] padded with n,
// then pos[max_count] = the uncapped count; scratch[2 * tiles + 2]
extern "C" int bs_newline_positions(const uint8_t* chunk, long long n,
                                    long long start, long long max_count,
                                    int* pos, int* scratch, long long tiles,
                                    int max_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Span s = make_span(chunk, n);
  if (tiles != tiles_of(s) || tiles > 0x7fffffff || start < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const Ranks r = ranks_scratch(scratch, tiles, 0, st, err);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    compact_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
        s, s.lead + start, (int)tiles, r, max_count, pos, nullptr, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pad_kernel<<<grid_for(max_count, 4 * kThreads, max_blocks), kThreads, 0,
               st>>>(r.total, max_count, (int)n, pos);
  return (int)cudaGetLastError();
}

// record_offsets: offsets[max_records, 5], codes[max_records + 1] (the last
// entry takes the uncapped record count); scratch[2 * tiles + 2]
extern "C" int bs_record_offsets(const uint8_t* chunk, long long n, int start,
                                 long long max_records, int* offsets,
                                 int* codes, int* scratch, long long tiles,
                                 int max_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Span s = make_span(chunk, n);
  if (tiles != tiles_of(s) || tiles > 0x7fffffff || start < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const Ranks r = ranks_scratch(scratch, tiles, 0, st, err);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    compact_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
        s, s.lead + start, (int)tiles, r, 4 * max_records, nullptr, offsets,
        max_records);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  records_kernel<<<grid_for(max_records, kThreads, max_blocks), kThreads, 0,
                   st>>>(chunk, n, start, r.total, max_records, offsets,
                         codes, codes + max_records);
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
