// K2: per-check "exactly one participant unknown" plane.
//
// Replaces iib_project_ldpc_codes_tpu/ops/erasure_bp.py:186-228
// (_check_summaries(code, None, known)), the check half of the all-zero
// packed round.  For check c and word w:
//   exactly_one[c, w] = bits where exactly one of the dc words
//                       known[chk_to_var[c, j], w] is 0.
// JAX writes it as OR_j(~k_j & prefixAND_j & suffixAND_j); two running
// masks (a zero seen once, a zero seen twice) give the same bits in one
// pass with no arrays, for any dc.
//
// Bound on the H100: memory.  A thread does ~3 logic ops per 4-byte load,
// and one round reads dc rows of `known` per check (dc * m * W * 4 bytes,
// 92 MB at n = 1e4, W = 768) and writes m * W * 4 bytes.  One thread per
// (check, word), word fastest: the 32 lanes of a warp read 128 contiguous
// bytes of one gathered row, so every socket load is coalesced, and the
// check's dc indices are the same address for the whole warp (one
// broadcast load).  The per-socket row loads and the int32[m, W] output
// layout are kept so that K3 gathers whole rows too.
#include "common.cuh"

namespace {

__global__ void check_exactly_one_kernel(const int32_t* __restrict__ known,
                                         const int32_t* __restrict__ chk_to_var,
                                         int32_t* __restrict__ out, int m,
                                         int dc, int words, int wpc) {
  const long long total = static_cast<long long>(m) * words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int c = static_cast<int>(t / words);
    const int w = static_cast<int>(t - static_cast<long long>(c) * words);
    const int32_t* row =
        chk_to_var + (static_cast<long long>(w / wpc) * m + c) * dc;
    uint32_t once = 0, twice = 0;
    for (int j = 0; j < dc; ++j) {
      const uint32_t unknown = ~static_cast<uint32_t>(
          __ldg(known + static_cast<long long>(__ldg(row + j)) * words + w));
      twice |= once & unknown;
      once |= unknown;
    }
    out[t] = static_cast<int32_t>(once & ~twice);
  }
}

}  // namespace

extern "C" int ldpc_check_exactly_one(const void* known,
                                      const void* chk_to_var, void* out,
                                      int m, int dc, int words, int wpc,
                                      void* stream) {
  const long long total = static_cast<long long>(m) * words;
  if (total > 0) {
    check_exactly_one_kernel<<<ldpc::grid_for(total), ldpc::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(known),
        static_cast<const int32_t*>(chk_to_var), static_cast<int32_t*>(out),
        m, dc, words, wpc);
  }
  return static_cast<int>(cudaGetLastError());
}
