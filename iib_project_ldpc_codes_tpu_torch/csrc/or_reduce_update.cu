// X2: the OR all-reduce's reduction fused with the round's update and
// erasure count.
//
// Replaces iib_project_ldpc_codes_tpu/parallel/edge_sharded.py:38-41 (the
// OR over the all-gathered candidates of _or_all_reduce) and :158-160
// (known |= cand, then total_popcount(~known)).  With gathered
// int32[D, n, W] the D ranks' candidate planes (after the all-gather; at
// D = 1 the one rank's own plane, no copy):
//   known[v, w] |= OR_{d < D} gathered[d, v, w]
//   *errors += sum over all (v, w) of popcount(~known[v, w])
// The collective cannot do the OR itself: NCCL and gloo reduce by sum,
// which carries across bits.
//
// Bound on the H100: memory, D + 1 reads and one write of n * W words (at
// n = 1e6, W = 48 and D = 1: 576 MB).  The planes are walked as flat
// arrays, one word a thread, so every access is coalesced.  A word whose
// 32 trials already know the variable reads no candidate (known only
// grows), which cuts the traffic as the decode converges, as K3 does.
// The count is reduced in registers across the warp and added with one
// int32 atomicAdd per warp: exact in any order (the caller keeps the total
// below 2^31 bits).
#include "common.cuh"

namespace {

__global__ void or_reduce_update_kernel(int32_t* __restrict__ known,
                                        const int32_t* __restrict__ gathered,
                                        int32_t* __restrict__ errors_slot,
                                        int ranks, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int unknown = 0;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    uint32_t k = static_cast<uint32_t>(known[t]);
    if (k != 0xFFFFFFFFu) {
      uint32_t acc = 0;
      for (int d = 0; d < ranks; ++d) {
        acc |= static_cast<uint32_t>(__ldg(gathered + d * total + t));
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

extern "C" int ldpc_or_reduce_update(void* known, const void* gathered,
                                     void* errors_slot, int ranks,
                                     long long total, void* stream) {
  if (total > 0) {
    or_reduce_update_kernel<<<ldpc::grid_for(total), ldpc::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(known), static_cast<const int32_t*>(gathered),
        static_cast<int32_t*>(errors_slot), ranks, total);
  }
  return static_cast<int>(cudaGetLastError());
}
