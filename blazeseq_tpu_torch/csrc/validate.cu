// Padded-batch validate + Phred decode for Hopper (sm_90a).
//
// Replaces the TPU kernel blazeseq_tpu/ops/validate.py::validate_decode_pallas
// (body _validate_kernel), with the col_offset argument of its XLA twin
// validate_decode_xla.
//
// Inputs: seq, qual u8[n, L] (row-major, contiguous), lengths i32[n] (may
// exceed L). Outputs, allocated by the caller: codes i32[n], phred u8[n, L].
//   code 5: check_quality and an in-length quality byte outside [q_lo, q_hi]
//   code 4: check_ascii and an in-length (seq | qual) byte with bit 7 set;
//           4 overrides 5
//   phred[r, c] = (u8)(qual - offset) when c + col_offset < lengths[r]
//                 (wraps for qual < offset, as the reference's int32 -> u8
//                 cast does), 0 elsewhere.
//
// Bound: device-memory bytes (reads 2 bytes and writes 1 per element, a
// handful of integer ops each). Design: one warp per record row, lanes on
// consecutive columns so every load and store is coalesced; the per-row
// verdicts are two warp votes (__any_sync), so nothing but the code and the
// phred row is written and no atomics are needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void validate_decode_kernel(
    const uint8_t* __restrict__ seq, const uint8_t* __restrict__ qual,
    const int32_t* __restrict__ lengths, int32_t* __restrict__ codes,
    uint8_t* __restrict__ phred, long long n, int L, int col_offset,
    int q_lo, int q_hi, int offset, int check_ascii, int check_quality) {
  const int lane = threadIdx.x & 31;
  const long long wstride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock +
                     (threadIdx.x >> 5);
       r < n; r += wstride) {
    const long long base = r * L;
    const long long len = lengths[r];
    bool bad_q = false;
    bool bad_a = false;
    for (int c = lane; c < L; c += 32) {
      const int q = qual[base + c];
      const bool in_len = (long long)c + col_offset < len;
      if (in_len) {
        const int s = seq[base + c];
        bad_q |= (q < q_lo) | (q > q_hi);
        bad_a |= ((s | q) & 0x80) != 0;
      }
      phred[base + c] = in_len ? (uint8_t)(q - offset) : (uint8_t)0;
    }
    bad_q = __any_sync(kFull, bad_q);
    bad_a = __any_sync(kFull, bad_a);
    if (lane == 0) {
      codes[r] = (check_ascii && bad_a) ? 4 : ((check_quality && bad_q) ? 5 : 0);
    }
  }
}

}  // namespace

extern "C" int bs_validate_decode(const uint8_t* seq, const uint8_t* qual,
                                  const int32_t* lengths, int32_t* codes,
                                  uint8_t* phred, long long n, int L,
                                  int col_offset, int q_lo, int q_hi,
                                  int offset, int check_ascii,
                                  int check_quality, int max_blocks,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > max_blocks) blocks = max_blocks;
  validate_decode_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                           (cudaStream_t)stream>>>(
      seq, qual, lengths, codes, phred, n, L, col_offset, q_lo, q_hi, offset,
      check_ascii, check_quality);
  return (int)cudaGetLastError();
}
