// Per-tile Phred sums and base counts of a padded batch for Hopper (sm_90a).
//
// Replaces the device half of blazeseq_tpu/ops/tiles.py::per_tile_qual_sums
// (l.59-95, with _tile_contract, l.50-56), XLA code with no Pallas kernel:
// two one-hot [n, T] x [n, L] contractions. Its plain torch version
// (ops/tiles.py::per_tile_qual_sums_torch) takes ~17 launches a call. Here
// one launch, no fill.
//
// Inputs: qual u8[n, L] (row-major, contiguous), lengths i32[n], and dst
// i32[n] in file order: each row's tile row in [0, T), or any other value
// (T for an unknown tile or a row past n_records) for none. Output: out f32
// [2, T, L], every cell written: out[0, t, j] = Sum of min(phred, cap) and
// out[1, t, j] = the count, over the rows of tile t with j < lengths, phred
// = byte >= offset ? byte - offset : 0; integer sums made float32 once
// (exact below 2^24, as the reference's float32 sums).
//
// Bound: device-memory bytes (each row of a known tile read once up to its
// length, dst and lengths read once, the [2, T, L] sums written once); a
// few integer operations a byte. At the CLI's 4,096 x 256 the launch, two
// load round trips and the combine's fence and ticket set the time.
//
// Design: sums in registers and shared memory, rows in file order, no host
// sort, no fill. A block takes a slab of rows, a span of 128 columns and a
// range of TB tiles: a warp a row lane (a contiguous part of the slab, 16
// to 256 rows), a thread 4 columns, 8 rows' dst, length and word loaded at
// once. The Phred of two columns at a time is one Hopper DPX add-max and
// one add-min on 16-bit halves (__viaddmax_s16x2, __viaddmin_s16x2). A
// thread keeps the sums and counts of the range's first kSlots tiles in
// registers (even and odd columns in 16-bit halves; the tile is the
// warp's, all its lanes read one row), so rows with their tiles mixed cost
// no memory traffic; rows of the range's other tiles add into the thread's
// own cells of its lane's [TB, 128] accumulators in shared memory, without
// atomics. The slots join them at the end, packed sum << 13 | count (a
// slab holds at most 2,048 rows). The lanes' copies are added, then the
// slabs combined in the same launch: each block adds its cells to a zeroed
// uint64 sum in scratch (sum << 32 | count, one 64-bit reduction a cell)
// and takes a ticket (one counter a tile range and span); the last block of
// a range and span converts the sums to float32 into the output and zeroes
// them and its ticket for the next launch. With one slab a block writes its
// output itself. TB is every tile where the lanes' copies fit the block's
// shared memory (up to the device's opt-in limit, queried and set once a
// device), else 12 tiles (48 KB) a range, blocks passing over the rows of
// other ranges with only their dst read. Rows are read 4 bytes at a time
// where qual is 4-byte aligned and L % 4 == 0, else a byte at a time.

#include <atomic>
#include <initializer_list>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAcross = 32;                 // threads across a span
constexpr int kLanes = kThreads / kAcross;  // row lanes (warps) a block
constexpr int kSpan = 4 * kAcross;          // columns a block
constexpr int kChunk = 8;                   // rows a thread loads at once
constexpr int kSlots = 4;                   // tiles a thread sums in registers
constexpr int kCountBits = 13;
constexpr int kCountMask = (1 << kCountBits) - 1;
constexpr int kMinLaneRows = 16;
constexpr int kMaxLaneRows = 256;  // 16-bit halves: 255 x 256 < 2^16
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

struct Args {
  const uint8_t* qual;
  const int32_t* lengths;
  const int32_t* dst;
  float* out;                   // [2, T, L]
  unsigned long long* sums;     // [T, L] scratch, zero between launches
  unsigned* tickets;            // [groups], zero between launches
  int n;
  int L;
  int T;
  int TB;         // tiles a range
  int spans;      // ceil(L / kSpan)
  int slabs;
  int lane_rows;  // rows a lane: a slab is kLanes x lane_rows rows
  // phred = min(max(byte - sub, 0) + add, cap) on 16-bit halves
  uint32_t neg_sub2, add2, cap2;
};

struct Plan {
  int TB, ranges, spans, slabs, lane_rows;
  size_t smem;
};

// dynamic shared memory of a block of TB tiles
size_t smem_bytes(int TB) {
  return (size_t)kLanes * TB * kSpan * sizeof(uint32_t);
}

// packed cells += the even (bytes 0, 2) and odd (1, 3) columns' sums and
// counts in 16-bit halves
__device__ __forceinline__ void add_cells(uint4* cell, uint32_t se,
                                          uint32_t so, uint32_t ce,
                                          uint32_t co) {
  uint4 v = *cell;
  v.x += ((se & 0xffffu) << kCountBits) + (ce & 0xffffu);
  v.y += ((so & 0xffffu) << kCountBits) + (co & 0xffffu);
  v.z += ((se >> 16) << kCountBits) + (ce >> 16);
  v.w += ((so >> 16) << kCountBits) + (co >> 16);
  *cell = v;
}

template <bool ONE_RANGE, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) tiles_kernel(const Args a) {
  extern __shared__ uint4 smem4[];
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem4);
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int x = tid % kAcross, y = tid / kAcross;
  const int slab_i = blockIdx.x % a.slabs;
  const int group = blockIdx.x / a.slabs;  // range * spans + span
  const int span_i = group % a.spans, range_i = group / a.spans;
  const int t0 = range_i * a.TB;
  const int tb = min(a.TB, a.T - t0);
  const int cells = tb * kSpan;
  const int c0 = span_i * kSpan + 4 * x;

  for (int i = tid; i < kLanes * cells / 4; i += kThreads)
    smem4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (c0 < a.L) {
    const long long p_lo = ((long long)slab_i * kLanes + y) * a.lane_rows;
    const long long p_hi = min(p_lo + a.lane_rows, (long long)a.n);
    uint4* mine = reinterpret_cast<uint4*>(acc + (size_t)y * cells + 4 * x);
    uint32_t se[kSlots], so[kSlots], ce[kSlots], co[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) se[k] = so[k] = ce[k] = co[k] = 0;
    const uint8_t* base = a.qual + (size_t)p_lo * a.L + c0;
    for (long long p = p_lo; p < p_hi;
         p += kChunk, base += (size_t)kChunk * a.L) {
      int t[kChunk], m[kChunk];
      uint32_t w[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const bool live = p + i < p_hi;
        t[i] = live ? __ldg(a.dst + p + i) - t0 : -1;
        const bool load =
            live && (ONE_RANGE || (unsigned)t[i] < (unsigned)tb);
        m[i] = load ? min(__ldg(a.lengths + p + i), a.L) - c0 : 0;
        const uint8_t* q = base + (size_t)i * a.L;
        w[i] = 0;
        if (VEC) {
          if (load) w[i] = __ldg(reinterpret_cast<const uint32_t*>(q));
        } else if (load) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + b < a.L) w[i] |= (uint32_t)__ldg(q + b) << (8 * b);
        }
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int tt = t[i];
        if ((unsigned)tt >= (unsigned)tb) continue;
        const int k = m[i];
        const uint32_t lm = k >= 4 ? 0xffffffffu
                            : k <= 0 ? 0u : 0xffffffffu >> (32 - 8 * k);
        const uint32_t me = lm & 0x00ff00ffu, mo = (lm >> 8) & 0x00ff00ffu;
        const uint32_t pe =
            __viaddmin_s16x2(__viaddmax_s16x2(w[i] & 0x00ff00ffu, a.neg_sub2,
                                              0u),
                             a.add2, a.cap2) & me;
        const uint32_t po =
            __viaddmin_s16x2(__viaddmax_s16x2((w[i] >> 8) & 0x00ff00ffu,
                                              a.neg_sub2, 0u),
                             a.add2, a.cap2) & mo;
        const uint32_t le = me & 0x00010001u, lo = mo & 0x00010001u;
        if (tt < kSlots) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            if (tt == s) {
              se[s] += pe;
              so[s] += po;
              ce[s] += le;
              co[s] += lo;
            }
        } else {
          add_cells(mine + (size_t)tt * (kSpan / 4), pe, po, le, lo);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (s < tb) add_cells(mine + (size_t)s * (kSpan / 4), se[s], so[s],
                            ce[s], co[s]);
  }
  __syncthreads();

  // the lanes' copies added, cell by cell
  const int col0 = span_i * kSpan;
  float* out_sums = a.out + (size_t)t0 * a.L;
  float* out_counts = out_sums + (size_t)a.T * a.L;
  unsigned long long* sums = a.sums + (size_t)t0 * a.L;
  for (int i = tid; i < cells; i += kThreads) {
    const int col = col0 + i % kSpan;
    if (col >= a.L) continue;
    uint32_t v = 0;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v += acc[(size_t)l * cells + i];
    const size_t at = (size_t)(i / kSpan) * a.L + col;
    if (a.slabs == 1) {
      out_sums[at] = (float)(v >> kCountBits);
      out_counts[at] = (float)(v & kCountMask);
    } else if (v) {
      atomicAdd(sums + at, ((unsigned long long)(v >> kCountBits) << 32) |
                               (v & kCountMask));
    }
  }
  if (a.slabs == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(a.tickets + group, 1u) == (unsigned)a.slabs - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < cells; i += kThreads) {
    const int col = col0 + i % kSpan;
    if (col >= a.L) continue;
    const size_t at = (size_t)(i / kSpan) * a.L + col;
    const unsigned long long v = __ldcg(sums + at);
    sums[at] = 0;
    out_sums[at] = __ull2float_rn(v >> 32);
    out_counts[at] = __ull2float_rn(v & 0xffffffffu);
  }
  if (tid == 0) a.tickets[group] = 0;
}

// The dynamic shared memory a block may have: the current device's opt-in
// limit less the kernels' static shared memory, which each is allowed;
// queried and set once a device.
cudaError_t smem_limit(int* limit) {
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*limit = known[dev].load()) > 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, tiles_kernel<true, true>);
  if (e == cudaSuccess) *limit -= (int)fa.sharedSizeBytes;
  for (auto k : {tiles_kernel<true, true>, tiles_kernel<true, false>,
                 tiles_kernel<false, true>, tiles_kernel<false, false>})
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *limit);
  if (e == cudaSuccess && dev < kMaxDevices) known[dev].store(*limit);
  return e;
}

// The blocks of a launch: every tile in one range where the lanes' copies
// fit the opt-in limit, else ranges of 48 KB; about four blocks an SM, each
// lane kMinLaneRows to kMaxLaneRows rows.
cudaError_t make_plan(long long n, int L, int T, int sm_count, Plan* p) {
  int limit = 0;
  const cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return e;
  p->TB = smem_bytes(T) <= (size_t)limit
              ? T
              : (int)(kDefaultSmem / smem_bytes(1));
  p->ranges = (T + p->TB - 1) / p->TB;
  p->smem = smem_bytes(p->TB < T ? p->TB : T);
  p->spans = (L + kSpan - 1) / kSpan;
  const long long groups = (long long)p->ranges * p->spans;
  long long rows = (n * groups + 4LL * sm_count * kLanes - 1) /
                   (4LL * sm_count * kLanes);
  rows = rows < kMinLaneRows ? kMinLaneRows
         : rows > kMaxLaneRows ? kMaxLaneRows : rows;
  p->lane_rows = (int)rows;
  p->slabs = (int)((n + rows * kLanes - 1) / (rows * kLanes));
  return cudaSuccess;
}

}  // namespace

// dst: int32 [n] (tile rows, T or more for none); out: float32 [2, T, L],
// every cell written; sums: uint64 [T, L] and tickets: uint32 [T x
// ceil(L / 128)], both zeroed once by the caller and left zero.
// n < 2^31 (n == 0 launches nothing), L >= 1, 1 <= max_phred <= 256.
extern "C" int bs_tile_sums(const uint8_t* qual, const int32_t* lengths,
                            const int32_t* dst, float* out,
                            unsigned long long* sums, unsigned* tickets,
                            long long n, int L, int T, int offset,
                            int max_phred, int sm_count, void* stream) {
  if (n < 0 || n >= (1LL << 31) || L < 1 || T < 1 || max_phred < 1 ||
      max_phred > 256 || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Plan p;
  const cudaError_t e = make_plan(n, L, T, sm_count, &p);
  if (e != cudaSuccess) return (int)e;
  // phred = min(byte - offset, cap) for offset < 0 (no byte below it)
  const int cap = max_phred - 1;
  const long long neg = offset < 0 ? -(long long)offset : 0;
  const uint32_t add = (uint32_t)(neg < cap ? neg : cap);
  const uint32_t sub = offset < 0 ? 0 : offset > 255 ? 255 : offset;
  Args a{qual, lengths, dst, out, sums, tickets, (int)n, L, T, p.TB,
         p.spans, p.slabs, p.lane_rows, ((0x10000u - sub) & 0xffffu) *
         0x00010001u, add * 0x00010001u, (uint32_t)cap * 0x00010001u};
  const unsigned blocks = (unsigned)((long long)p.ranges * p.spans * p.slabs);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = L % 4 == 0 && ((uintptr_t)qual & 3) == 0;
  if (p.ranges == 1) {
    if (vec)
      tiles_kernel<true, true><<<blocks, kThreads, p.smem, s>>>(a);
    else
      tiles_kernel<true, false><<<blocks, kThreads, p.smem, s>>>(a);
  } else {
    if (vec)
      tiles_kernel<false, true><<<blocks, kThreads, p.smem, s>>>(a);
    else
      tiles_kernel<false, false><<<blocks, kThreads, p.smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
