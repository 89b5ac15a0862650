// Value-plane variable pass of the packed BEC round, with its error count.
//
// Replaces the variable half of iib_project_ldpc_codes_tpu/ops/erasure_bp.py
// _packed_iteration (:239-248) and the per-round total_popcount(~known) of
// _run_to_fixed_point (:66-110):
//   any   = OR_{j < dv} exactly_one[var_to_chk[v, j], w]
//   taken = OR_{j < dv} adopt[var_to_chk[v, j], w]
//   val[v, w]   |= taken & ~known[v, w]      (with the old known)
//   known[v, w] |= any
//   *errors += sum over all (v, w) of popcount(~known[v, w])
// `known` and `val` are updated in place: the check pass that read them has
// finished (same stream), and each thread writes only its own (v, w).  K3
// (variable_or_update.cu) stays the all-zero path.
//
// Bound on the H100: memory, 2 dv gathered rows + 2 reads + 2 writes of 4
// bytes per word (the 2 writes only where the word was not yet fully known).
// One thread per (variable, word), word fastest: coalesced 128-byte warp
// loads.  A word whose 32 trials already know the variable skips its
// gathers and its stores (known only grows, and val changes only where it
// was unknown), which cuts the traffic as the decode converges.  The count
// is reduced across the warp and added with one atomicAdd per warp (integer
// atomics: exact in any order).  A batch of C codes reads code w / wpc's
// table slice for word w, as K3.
#include "common.cuh"

namespace {

__global__ void variable_or_adopt_kernel(int32_t* __restrict__ known,
                                         int32_t* __restrict__ val,
                                         const int32_t* __restrict__ exactly_one,
                                         const int32_t* __restrict__ adopt,
                                         const int32_t* __restrict__ var_to_chk,
                                         int32_t* __restrict__ errors_slot,
                                         int n, int dv, int words, int wpc) {
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
      uint32_t any = 0, taken = 0;
      for (int j = 0; j < dv; ++j) {
        const long long at =
            static_cast<long long>(__ldg(row + j)) * words + w;
        any |= static_cast<uint32_t>(__ldg(exactly_one + at));
        taken |= static_cast<uint32_t>(__ldg(adopt + at));
      }
      val[t] = static_cast<int32_t>(static_cast<uint32_t>(val[t]) |
                                    (taken & ~k));
      k |= any;
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

extern "C" int ldpc_variable_or_adopt(void* known, void* val,
                                      const void* exactly_one,
                                      const void* adopt,
                                      const void* var_to_chk,
                                      void* errors_slot, int n, int dv,
                                      int words, int wpc, void* stream) {
  const long long total = static_cast<long long>(n) * words;
  if (total > 0) {
    variable_or_adopt_kernel<<<ldpc::grid_for(total), ldpc::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(known), static_cast<int32_t*>(val),
        static_cast<const int32_t*>(exactly_one),
        static_cast<const int32_t*>(adopt),
        static_cast<const int32_t*>(var_to_chk),
        static_cast<int32_t*>(errors_slot), n, dv, words, wpc);
  }
  return static_cast<int>(cudaGetLastError());
}
