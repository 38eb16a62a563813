// Adapter first-occurrence panel of a padded batch for Hopper (sm_90a).
//
// Replaces blazeseq_tpu/ops/adapter.py::adapter_content, which is XLA code
// with no Pallas kernel: one launch per adapter, where the plain torch
// version (ops/adapter.py::adapter_content_torch) makes `la` shifted
// [n, L] copies and ~100 dispatcher calls.
//
// Inputs: seq u8[n, L] (row-major, contiguous), lengths i32[n], the adapter
// a[0..la) already case-folded (& 0xDF) on the card. Rows r < n_valid =
// min(n, n_records) are reads; the rest are padding and are not read. Row r
// has a hit at column j when j + la <= min(lengths[r], L) and
// (seq[r, j + k] & 0xDF) == a[k] for every k; its first hit is the
// smallest such j. Output, zero-filled by the caller, in AdapterStats'
// field order: first_occurrence i32[L] (+1 at each read's first hit),
// reads_with_adapter (reads with any hit), reads_scanned (= n_records,
// written here). An adapter longer than the row finds nothing: the start
// range is empty.
//
// Bound: device-memory bytes, the rows read once up to their length;
// the compares per start column stop at the first mismatch, which for an
// adapter against random bases is the first or second byte.
//
// Design. A warp takes one read at a time. Its lanes test 32 consecutive
// start columns at once (lane l column j0 + l, neighbouring lanes on
// neighbouring bytes, so each step of the compare loop is one coalesced
// 32-byte load of the row, from L1 after the first), and a __ballot_sync
// gives the window's hits: the lowest set bit is the first occurrence and
// the read is done. A window with no hit moves on by 32 columns. The
// adapter is read through the read-only path; every lane reads the same
// byte, a broadcast. A read adds at most one count, so first_occurrence
// takes at most one global atomic a read, and the hits one atomic a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* seq;
  const int32_t* lengths;
  const uint8_t* adapter;  // folded
  int32_t* out;            // [L + 2]
  long long n_valid;
  int L;
  int la;
  int reads_scanned;
};

__global__ void __launch_bounds__(kThreads) adapter_kernel(const Args a) {
  __shared__ int s_hits;
  if (threadIdx.x == 0) s_hits = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long wstride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < a.n_valid; r += wstride) {  // warp-uniform
    const long long fit = min((long long)a.lengths[r], (long long)a.L);
    // the last start column whose match ends inside the read
    const long long last = min(fit - a.la, (long long)a.L - 1);
    const uint8_t* row = a.seq + r * a.L;
    for (long long j0 = 0; j0 <= last; j0 += 32) {
      const long long j = j0 + lane;
      bool hit = j <= last;
      for (int k = 0; hit && k < a.la; ++k)
        hit = (row[j + k] & 0xDF) == __ldg(a.adapter + k);
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (ballot) {
        if (lane == 0) {
          atomicAdd(a.out + j0 + __ffs(ballot) - 1, 1);
          atomicAdd(&s_hits, 1);
        }
        break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_hits) atomicAdd(a.out + a.L, s_hits);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.out[a.L + 1] = a.reads_scanned;
}

}  // namespace

// out: int32[L + 2], zero-filled by the caller; adapter: u8[la] on the
// card, folded with & 0xDF (any pointer when la == 0).
extern "C" int bs_adapter_content(const uint8_t* seq, const int32_t* lengths,
                                  const uint8_t* adapter, int32_t* out,
                                  long long n_valid, int L, int la,
                                  int reads_scanned, int sm_count,
                                  void* stream) {
  if (n_valid < 0 || L < 0 || la < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n_valid + kWarps - 1) / kWarps;
  if (blocks > 8LL * sm_count) blocks = 8LL * sm_count;
  if (blocks < 1) blocks = 1;  // block 0 writes reads_scanned
  const Args a{seq, lengths, adapter, out, n_valid, L, la, reads_scanned};
  adapter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
