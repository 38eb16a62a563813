// One-pass uniform-layout FASTQ parse + validate + QC for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/fused_qc.py::fused_uniform_qc
// (body _kernel_body) and serves the contract of the XLA step
// blazeseq_tpu/ops/uniform_qc.py::uniform_qc (the torch epilogue in
// blazeseq_tpu_torch/ops/uniform_qc.py folds the eq-mode histogram).
//
// Input: a chunk u8[nrec, rs] of fixed-layout records; rows at or beyond
// nrec_valid are the zero padding of a partial chunk and are skipped.
// Per valid row, over the full row:
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
// Outputs are zeroed by the caller; every count is an integer atomic, so the
// result is the same whatever order the blocks run in.
//
// Bound: device-memory bytes. The kernel reads each chunk byte once and
// writes only KB of counters. Design: one warp per record row with lanes on
// consecutive bytes (coalesced loads); the row verdict is a warp vote and the
// per-read GC and Phred sums are warp shuffles, so per-row work never
// touches global memory. All panels accumulate in per-block shared memory
// and reach the global outputs once per block. Shared atomics on the
// histogram bins contend when a corpus has few distinct Phred values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPhred = 64;
constexpr int kGcBins = 101;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void flush(int32_t* dst, const int32_t* src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t v = src[i];
    if (v != 0) atomicAdd(dst + i, v);
  }
}

__global__ void uniform_qc_kernel(
    const uint8_t* __restrict__ chunk, long long nrec_valid, int rs, int o1,
    int o2, int o3, int cnt, int q_lo, int q_hi, int offset, int check_ascii,
    int check_quality, int32_t* __restrict__ bad_out,
    int32_t* __restrict__ csq_out, int32_t* __restrict__ csb_out,
    int32_t* __restrict__ qh_out, int32_t* __restrict__ gch_out,
    int32_t* __restrict__ mqh_out) {
  extern __shared__ int32_t smem[];
  int32_t* s_csb = smem;               // [4 * cnt]
  int32_t* s_csq = s_csb + 4 * cnt;    // [cnt]
  int32_t* s_qh = s_csq + cnt;         // [64]
  int32_t* s_gch = s_qh + kMaxPhred;   // [101]
  int32_t* s_mqh = s_gch + kGcBins;    // [64]
  int32_t* s_bad = s_mqh + kMaxPhred;  // [1]
  const int n_shared = 5 * cnt + 2 * kMaxPhred + kGcBins + 1;
  for (int i = threadIdx.x; i < n_shared; i += blockDim.x) smem[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int seq0 = o1 + 1;
  const int qual0 = o3 + 1;
  const int plus_col = o2 + 1;
  const long long wstride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock +
                     (threadIdx.x >> 5);
       r < nrec_valid; r += wstride) {
    const uint8_t* row = chunk + r * rs;
    bool bad = false;
    int gc = 0;
    int qsum = 0;
    for (int c = lane; c < rs; c += 32) {
      const int x = row[c];
      const bool nl_expected =
          (c == o1) | (c == o2) | (c == o3) | (c == rs - 1);
      bad |= (x == '\n') != nl_expected;
      if (check_ascii) bad |= x > 127;
      if (check_quality && c >= qual0 && c < rs - 1)
        bad |= (x < q_lo) | (x > q_hi);
      if (c == 0) bad |= x != '@';
      if (c == plus_col) bad |= x != '+';
      const int ps = c - seq0;
      if (ps >= 0 && ps < cnt) {
        const int u = x & 0xDF;
        const int k = u == 'A' ? 0 : u == 'C' ? 1 : u == 'G' ? 2
                    : u == 'T' ? 3 : -1;
        if (k >= 0) atomicAdd(s_csb + k * cnt + ps, 1);
        gc += (k == 1) | (k == 2);
      }
      const int pq = c - qual0;
      if (pq >= 0 && pq < cnt) {
        const int ph = min(max(x - offset, 0), kMaxPhred - 1);
        if (ph) atomicAdd(s_csq + pq, ph);
        atomicAdd(s_qh + ph, 1);
        qsum += ph;
      }
    }
    bad = __any_sync(kFull, bad);
    for (int m = 16; m > 0; m >>= 1) {
      gc += __shfl_xor_sync(kFull, gc, m);
      qsum += __shfl_xor_sync(kFull, qsum, m);
    }
    if (lane == 0) {
      if (bad) atomicAdd(s_bad, 1);
      atomicAdd(s_gch + (200 * gc + cnt) / (2 * cnt), 1);
      atomicAdd(s_mqh + min((2 * qsum + cnt) / (2 * cnt), kMaxPhred - 1), 1);
    }
  }
  __syncthreads();
  flush(csb_out, s_csb, 4 * cnt);
  flush(csq_out, s_csq, cnt);
  flush(qh_out, s_qh, kMaxPhred);
  flush(gch_out, s_gch, kGcBins);
  flush(mqh_out, s_mqh, kMaxPhred);
  flush(bad_out, s_bad, 1);
}

}  // namespace

extern "C" int bs_uniform_qc_smem_bytes(int cnt) {
  return (5 * cnt + 2 * kMaxPhred + kGcBins + 1) * (int)sizeof(int32_t);
}

extern "C" int bs_uniform_qc(const uint8_t* chunk, long long nrec_valid,
                             int rs, int o1, int o2, int o3, int cnt,
                             int q_lo, int q_hi, int offset, int check_ascii,
                             int check_quality, int32_t* bad, int32_t* csq,
                             int32_t* csb, int32_t* qh, int32_t* gch,
                             int32_t* mqh, int max_blocks, void* stream) {
  if (nrec_valid <= 0) return (int)cudaSuccess;
  const int smem = bs_uniform_qc_smem_bytes(cnt);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        uniform_qc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (nrec_valid + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > max_blocks) blocks = max_blocks;
  uniform_qc_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, smem,
                      (cudaStream_t)stream>>>(
      chunk, nrec_valid, rs, o1, o2, o3, cnt, q_lo, q_hi, offset,
      check_ascii, check_quality, bad, csq, csb, qh, gch, mqh);
  return (int)cudaGetLastError();
}
