// K1: packed Bernoulli planes straight from Philox.
//
// Replaces iib_project_ldpc_codes_tpu/ops/bitops.py:63-78 (bernoulli_packed,
// reached through ops/channels.py::bec_packed_channel).  The JAX version
// draws a uint32[n, 32W] array, compares it in float32 and packs it: an
// intermediate 32 times the output.  Here one thread writes whole words.
//
// Draw scheme (the port's ops/bitops.py documents it and runs the same
// arithmetic in its plain version, so both give the same bits):
//   word i = v*W + w, bit b  <-  lane b % 4 of
//   Philox4x32-10(counter = (g lo, g hi, offset lo, offset hi), key),
//   g = 8*i + b / 4;  bit set iff draw < thr, thr = floor(p * 2^32) in
//   [0, 2^32] (so p <= 0 never sets a bit and p >= 1 always does).
//
// Bound on the H100: integer multiplies.  Each word costs 8 Philox calls,
// 80 rounds of two 32-bit mul.hi/mul.lo pairs, against 4 bytes of output,
// so the kernel runs at the ALU rate, far under memory bandwidth.  The
// design keeps every draw in registers and stores one coalesced int32 per
// thread; nothing else touches device memory.
#include "common.cuh"

namespace {

__global__ void bernoulli_packed_kernel(int32_t* __restrict__ out,
                                        long long total_words, uint32_t k0,
                                        uint32_t k1, uint32_t offset_lo,
                                        uint32_t offset_hi,
                                        unsigned long long thr) {
  const uint2 key = make_uint2(k0, k1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total_words; i += stride) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned long long g = 8ULL * static_cast<unsigned long long>(i) + j;
      const uint4 r = ldpc::philox4x32_10(
          make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                     offset_lo, offset_hi),
          key);
      word |= static_cast<uint32_t>(r.x < thr) << (4 * j);
      word |= static_cast<uint32_t>(r.y < thr) << (4 * j + 1);
      word |= static_cast<uint32_t>(r.z < thr) << (4 * j + 2);
      word |= static_cast<uint32_t>(r.w < thr) << (4 * j + 3);
    }
    out[i] = static_cast<int32_t>(word);
  }
}

}  // namespace

extern "C" int ldpc_bernoulli_packed(void* out, long long total_words,
                                     unsigned int k0, unsigned int k1,
                                     unsigned int offset_lo,
                                     unsigned int offset_hi,
                                     unsigned long long thr, void* stream) {
  if (total_words > 0) {
    bernoulli_packed_kernel<<<ldpc::grid_for(total_words), ldpc::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(out), total_words, k0, k1, offset_lo,
        offset_hi, thr);
  }
  return static_cast<int>(cudaGetLastError());
}

