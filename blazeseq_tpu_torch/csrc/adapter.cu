// Adapter first-occurrence panels of a padded batch for Hopper (sm_90a):
// every adapter of the batch in one launch, added into a running total.
//
// Replaces blazeseq_tpu/ops/adapter.py::adapter_content, which is XLA code
// with no Pallas kernel and runs once per adapter, where the plain torch
// version (ops/adapter.py::adapter_content_torch) makes `la` shifted
// [n, L] copies and ~100 dispatcher calls an adapter.
//
// Inputs: seq u8[n, L] (row-major, contiguous), lengths i32[n], and the
// adapters, case-folded (& 0xDF) and packed on the card by the host:
// bytes u8[...], offsets i32[n_ad + 1] (adapter a is bytes[off[a], off[a +
// 1])) and meta i32[n_ad][2] (its length, and its first four bytes as a
// little-endian word). Rows r < n_valid = min(n, n_records) are reads; the
// rest are padding and are not read. Row r has a hit of adapter a (length
// la) at column j when j + la <= min(lengths[r], L) and (seq[r, j + k] &
// 0xDF) == a[k] for every k; its first hit is the smallest such j. Output,
// int32 [n_ad, L + 2], one row an adapter in AdapterStats' field order,
// into which the batch is ADDED: first_occurrence [L] (+1 at each read's
// first hit), reads_with_adapter (reads with any hit), reads_scanned
// (+ n_records). An adapter longer than the row finds nothing, an empty
// one a hit at column 0 of every read (when L > 0).
//
// Bound: device-memory bytes, each read once up to the end of the last
// adapter's first hit (to its length without one), and a compare per
// start column and adapter up to the first hit; at the host route's
// [4096, 256] batch that is under a microsecond, so the launch and the
// round trips to memory are its time.
//
// Design. A warp owns a row, a block kWarps rows. The warp stages its row
// in its own part of shared memory, in 16-byte pieces (byte loads when L %
// 16 != 0 or seq is off 16-byte alignment) folded with & 0xDFDFDFDF as
// they land; the first window's pieces are loaded with the row's length,
// every load issued before any is used, so a warp waits on memory once (a
// row is read to the window's end whatever its length; the bytes past it
// are never matched). A row wider than the window W = 512 is
// taken in windows, each with a halo of the longest adapter less one (at
// most kHalo; a compare past the halo reads the row from memory). The warp
// scans its row for every adapter at once (lane k holds adapter k's last
// start column, and a ballot gives the adapters still to find): lane l
// tests start column j0 + l,
// with one 4-byte word of the staged row (a funnel shift of two aligned
// words) against each adapter's first four bytes, and the full compare
// from shared memory only where that matches; a __reduce_or_sync of the
// lanes' hit masks, then one __ballot_sync an adapter hit, gives each
// adapter's first occurrence, after which the row stops testing it, and
// the row stops when every adapter is found or past its last start
// column. Hits are counted per block in shared memory and added with one
// global atomic per nonzero word. The kernel's first form took one launch
// an adapter, read the row from memory once an adapter, and loaded each
// compared byte from memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 512;   // start columns a window takes at most
constexpr int kHalo = 124;     // bytes past the window a row stages at most
constexpr int kMaxItems = 2;   // 16-byte pieces a lane loads a window
constexpr int kMaxAdapters = 32;  // adapters a launch takes (a hit mask)
constexpr int kAdBytes = 2048;  // adapter bytes staged in shared memory
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* seq;
  const int32_t* lengths;
  const uint8_t* ad;      // folded bytes
  const int32_t* ad_off;  // [n_ad + 1]
  const int32_t* meta;    // [n_ad][2]: length, first four bytes
  int32_t* out;           // [n_ad, L + 2]
  long long n_valid;
  int L;
  int n_ad;
  int W;       // the window
  int halo;    // staged bytes past the window, a multiple of 4
  int stride;  // staged bytes a row, a multiple of 16
  int reads_scanned;
  int vec;     // 16-byte loads: L % 16 == 0, seq 16-byte aligned
  int ad_staged;  // adapter bytes staged in shared memory (0: none)
};

__device__ __forceinline__ uint32_t first_bytes(int k) {
  return k >= 4 ? kFull : (k <= 0 ? 0u : (1u << (8 * k)) - 1u);
}

// Stage columns [w0, w0 + upto) of the warp's row into `stage`, every
// load issued before any is used.
__device__ __forceinline__ void stage_row(const Args& a, uint8_t* stage,
                                          long long r, int w0, int upto,
                                          int lane) {
  uint4 v[kMaxItems];
  int at[kMaxItems];  // stage offset of the piece, -1 for none
#pragma unroll
  for (int m = 0; m < kMaxItems; ++m) {
    const int c = 16 * (lane + 32 * m);
    at[m] = -1;
    if (c >= upto) continue;
    const long long g = r * a.L + w0 + c;
    if (a.vec) {
      v[m] = __ldg(reinterpret_cast<const uint4*>(a.seq + g));
    } else {
      uint32_t wd[4] = {0, 0, 0, 0};
      const int k = min(16, upto - c);
      for (int b = 0; b < k; ++b)
        wd[b >> 2] |= (uint32_t)a.seq[g + b] << (8 * (b & 3));
      v[m] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    at[m] = c;
  }
#pragma unroll
  for (int m = 0; m < kMaxItems; ++m) {
    if (at[m] < 0) continue;
    v[m].x &= 0xDFDFDFDFu;
    v[m].y &= 0xDFDFDFDFu;
    v[m].z &= 0xDFDFDFDFu;
    v[m].w &= 0xDFDFDFDFu;
    *reinterpret_cast<uint4*>(stage + at[m]) = v[m];
  }
}

__global__ void __launch_bounds__(kThreads) adapter_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_ad = a.n_ad;
  const int L = a.L;
  uint8_t* const stage = smem + warp * a.stride;
  int* const s_first = reinterpret_cast<int*>(smem + kWarps * a.stride);
  int* const s_hits = s_first + n_ad * a.W;  // [n_ad]
  int* const s_la = s_hits + kMaxAdapters;   // adapter lengths
  uint32_t* const s_pre = reinterpret_cast<uint32_t*>(s_la + kMaxAdapters);
  int* const s_off = reinterpret_cast<int*>(s_pre + kMaxAdapters);
  uint8_t* const s_ad = reinterpret_cast<uint8_t*>(s_off + kMaxAdapters);
  // the adapters' bytes: from shared memory when they were staged
  const uint8_t* const adp = a.ad_staged ? s_ad : a.ad;
  const long long r = (long long)blockIdx.x * kWarps + warp;  // the row
  const bool has_row = r < a.n_valid;
  // the row's length, loaded with the first window's pieces
  int fit = has_row ? a.lengths[r] : 0;
  if (has_row && L > 0) stage_row(a, stage, r, 0, min(L, a.W + a.halo), lane);
  for (int i = threadIdx.x; i < n_ad * a.W; i += kThreads) s_first[i] = 0;
  if (threadIdx.x < n_ad) {
    s_la[threadIdx.x] = a.meta[2 * threadIdx.x];
    s_pre[threadIdx.x] = (uint32_t)a.meta[2 * threadIdx.x + 1];
    s_off[threadIdx.x] = a.ad_off[threadIdx.x] - a.ad_off[0];
    s_hits[threadIdx.x] = 0;
  }
  for (int i = threadIdx.x; i < a.ad_staged; i += kThreads)
    s_ad[i] = a.ad[i];
  fit = min(fit, L);
  __syncthreads();
  // lane k < n_ad holds adapter k's last start column in the row
  const int last = lane < n_ad ? fit - s_la[lane] : -1;
  uint32_t found = 0;

  for (int w0 = 0; w0 < L; w0 += a.W) {
    const int span = min(L - w0, a.W + a.halo);
    if (w0 > 0 && has_row) {  // later windows: the row up to its length
      __syncwarp();
      stage_row(a, stage, r, w0, min(fit - w0, span), lane);
      __syncwarp();
    }
    const int jend = min(w0 + a.W, L);  // the window's start columns
    const uint32_t* row32 = reinterpret_cast<const uint32_t*>(stage);
    const int staged = min(fit - w0, span);  // staged bytes of the row
    const uint8_t* grow = a.seq + r * L + w0;
    for (int j0 = w0; has_row && j0 < jend; j0 += 32) {  // warp-uniform
      // adapters still to find that fit from j0
      const uint32_t act = __ballot_sync(kFull, j0 <= last) & ~found;
      if (!act) break;
      const int j = j0 + lane;
      const int jj = j - w0;  // column in the stage
      uint32_t hits = 0;
      if (j < jend) {
        const uint32_t lo = row32[jj >> 2], hi = row32[(jj >> 2) + 1];
        const uint32_t word = __funnelshift_r(lo, hi, 8 * (jj & 3));
        for (uint32_t m = act; m; m &= m - 1) {
          const int k = __ffs(m) - 1;
          const int la = s_la[k];
          if (j + la > fit || (word & first_bytes(la)) != s_pre[k]) continue;
          const uint8_t* ad = adp + s_off[k];
          bool hit = true;
          for (int b = 4; hit && b < la; ++b) {
            const uint8_t x =
                jj + b < staged ? stage[jj + b] : (grow[jj + b] & 0xDF);
            hit = x == ad[b];
          }
          if (hit) hits |= 1u << k;
        }
      }
      for (uint32_t any = __reduce_or_sync(kFull, hits); any; any &= any - 1) {
        const int k = __ffs(any) - 1;
        const unsigned ballot = __ballot_sync(kFull, (hits >> k) & 1u);
        if (lane == 0) {
          atomicAdd(&s_first[k * a.W + (j0 - w0) + __ffs(ballot) - 1], 1);
          atomicAdd(&s_hits[k], 1);
        }
        found |= 1u << k;
      }
    }
    __syncthreads();
    // the window's first occurrences, one atomic a nonzero word
    const int width = min(a.W, L - w0);
    for (int t = threadIdx.x; t < n_ad * width; t += kThreads) {
      const int k = t / width;
      const int c = t - k * width;
      const int v = s_first[k * a.W + c];
      if (v) {
        atomicAdd(a.out + k * (long long)(L + 2) + w0 + c, v);
        s_first[k * a.W + c] = 0;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < n_ad) {
    int32_t* o = a.out + threadIdx.x * (long long)(L + 2) + L;
    if (s_hits[threadIdx.x]) atomicAdd(o, s_hits[threadIdx.x]);
    if (blockIdx.x == 0 && a.reads_scanned) atomicAdd(o + 1, a.reads_scanned);
  }
}

}  // namespace

// out: int32[n_ad, L + 2]; the batch is added into it. ad: the folded
// bytes of these adapters on the card (ad_bytes of them), ad_off:
// int32[n_ad + 1] offsets (ad_off[0] at ad), meta: int32[n_ad][2] (length,
// first four bytes); la_max: the longest adapter's length.
extern "C" int bs_adapter_contents(const uint8_t* seq, const int32_t* lengths,
                                   const uint8_t* ad, const int32_t* ad_off,
                                   const int32_t* meta, int32_t* out,
                                   long long n_valid, int L, int n_ad,
                                   int ad_bytes, int la_max,
                                   int reads_scanned, void* stream) {
  if (n_valid < 0 || L < 0 || n_ad < 1 || n_ad > kMaxAdapters ||
      ad_bytes < 0 || la_max < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.seq = seq;
  a.lengths = lengths;
  a.ad = ad;
  a.ad_off = ad_off;
  a.meta = meta;
  a.out = out;
  a.n_valid = n_valid;
  a.L = L;
  a.n_ad = n_ad;
  a.W = L < kWindow ? (L + 15) / 16 * 16 : kWindow;
  if (a.W < 16) a.W = 16;
  // an adapter longer than the row never fits: no halo for it
  const int longest = la_max < L ? la_max : L;
  a.halo = ((longest > 1 ? longest - 1 : 0) + 3) / 4 * 4;
  if (a.halo > kHalo) a.halo = kHalo;
  // 4 bytes of slack for the word read past the last staged byte; a
  // window's pieces fit kMaxItems a lane (W + kHalo <= 32 * 16 * 2)
  a.stride = ((a.W + a.halo + 15) / 16 * 16 + 4 + 15) / 16 * 16;
  a.reads_scanned = reads_scanned;
  a.vec = L % 16 == 0 && (uintptr_t)seq % 16 == 0;
  a.ad_staged = ad_bytes <= kAdBytes ? ad_bytes : 0;
  const int smem = kWarps * a.stride + 4 * (n_ad * a.W + 4 * kMaxAdapters) +
                   (a.ad_staged + 3) / 4 * 4;
  static int smem_set = 0;  // the opt-in above 48 KB, made once
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        adapter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  long long blocks = (n_valid + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;  // block 0 adds reads_scanned
  adapter_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
