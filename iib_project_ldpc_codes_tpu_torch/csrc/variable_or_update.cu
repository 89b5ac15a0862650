// K3: variable update of the all-zero packed round, with its error count.
//
// Replaces iib_project_ldpc_codes_tpu/ops/erasure_bp.py:231-236 and
// :279-288 (_gather_or_by_variable + _packed_iteration_allzero) and the
// per-round total_popcount(~known) of _run_to_fixed_point (:66-110,
// ops/bitops.py:45-47):
//   known[v, w] |= OR_{j < dv} exactly_one[var_to_chk[v, j], w]
//   *errors += sum over all (v, w) of popcount(~known[v, w])
//
// `known` is updated in place.  That is safe because K2 (which reads
// `known`) has finished before K3 starts on the same stream; fusing K2 and
// K3 would need a grid-wide sync.
//
// Bound on the H100: memory, 3 gathered rows + 1 read + 1 write of 4 bytes
// per word (77 MB per round at n = 1e4, W = 768).  One thread per
// (variable, word), word fastest, so each gathered row is a coalesced
// 128-byte warp load.  A word whose 32 trials already know the variable
// skips its gathers (known only grows), which cuts the traffic as the
// decode converges.  The count is reduced in registers across the warp
// and added with one atomicAdd per warp; integer atomics are exact in any
// order, so the total does not depend on scheduling.
//
// A batch of C codes: `var_to_chk` is int32[C, n, dv] and word w reads the
// slice of code w / wpc (wpc = W / C), as K2 does; C = 1 is the
// single-code call.  The error count stays one total over all codes.
#include "common.cuh"

namespace {

__global__ void variable_or_update_kernel(int32_t* __restrict__ known,
                                          const int32_t* __restrict__ exactly_one,
                                          const int32_t* __restrict__ var_to_chk,
                                          int32_t* __restrict__ errors_slot,
                                          int n, int dv, int words,
                                          int wpc) {
  const long long total = static_cast<long long>(n) * words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int unknown = 0;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    uint32_t k = static_cast<uint32_t>(known[t]);
    if (k != 0xFFFFFFFFu) {
      const int v = static_cast<int>(t / words);
      const int w = static_cast<int>(t - static_cast<long long>(v) * words);
      const int32_t* row =
          var_to_chk + (static_cast<long long>(w / wpc) * n + v) * dv;
      uint32_t acc = 0;
      for (int j = 0; j < dv; ++j) {
        acc |= static_cast<uint32_t>(__ldg(
            exactly_one + static_cast<long long>(__ldg(row + j)) * words + w));
      }
      k |= acc;
      known[t] = static_cast<int32_t>(k);
    }
    unknown += __popc(~k);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    unknown += __shfl_down_sync(0xFFFFFFFFu, unknown, offset);
  }
  if ((threadIdx.x & 31) == 0 && unknown != 0) {
    atomicAdd(errors_slot, unknown);
  }
}

}  // namespace

extern "C" int ldpc_variable_or_update(void* known, const void* exactly_one,
                                       const void* var_to_chk,
                                       void* errors_slot, int n, int dv,
                                       int words, int wpc, void* stream) {
  const long long total = static_cast<long long>(n) * words;
  if (total > 0) {
    variable_or_update_kernel<<<ldpc::grid_for(total), ldpc::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(known), static_cast<const int32_t*>(exactly_one),
        static_cast<const int32_t*>(var_to_chk),
        static_cast<int32_t*>(errors_slot), n, dv, words, wpc);
  }
  return static_cast<int>(cudaGetLastError());
}
