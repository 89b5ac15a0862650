// Device functions shared by the code samplers (sample_regular_codes.cu,
// sample_irregular_codes.cu): the Fisher-Yates shuffle and the repair swap
// on the documented Philox stream (the port's models/ensemble.py
// docstring).  Both samplers run one block of kSamplerThreads per code.
#pragma once

#include "common.cuh"

namespace ldpc {
namespace sampler {

constexpr int kSamplerThreads = 256;
constexpr int kTile = 1024;
constexpr uint32_t kRepairStream = 0x80000000u;
constexpr int kRaw = 0, kReject = 1;  // kRepair = 2

static __device__ __forceinline__ int uniform_below(uint32_t lo, uint32_t hi,
                                                    uint32_t bound) {
  const unsigned long long r =
      (static_cast<unsigned long long>(hi) << 32) | lo;
  return static_cast<int>(__umul64hi(r, static_cast<unsigned long long>(bound)));
}

// Fisher-Yates permutation of [0, E) for shuffle stream `attempt`: the
// block draws the partners of the next kTile positions in parallel (they do
// not depend on the permutation), then one thread swaps.
static __device__ void shuffle(int32_t* perm, int32_t* partner, int E,
                               uint32_t code, uint32_t chunk, uint32_t attempt,
                               uint2 key) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) perm[e] = e;
  __syncthreads();
  int hi = E;
  while (hi > 1) {
    const int lo = max(1, hi - kTile);
    // partners of positions lo .. hi-1, two positions per Philox block
    for (int q = (lo >> 1) + threadIdx.x; q <= ((hi - 1) >> 1);
         q += blockDim.x) {
      const uint4 r = ldpc::philox4x32_10(
          make_uint4(static_cast<uint32_t>(q), code, chunk, attempt), key);
      const int i0 = 2 * q, i1 = 2 * q + 1;
      if (i0 >= lo && i0 < hi) partner[i0 - lo] = uniform_below(r.x, r.y, i0 + 1);
      if (i1 >= lo && i1 < hi) partner[i1 - lo] = uniform_below(r.z, r.w, i1 + 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = hi - 1; i >= lo; --i) {
        const int j = partner[i - lo];
        const int32_t held = perm[i];
        perm[i] = perm[j];
        perm[j] = held;
      }
    }
    __syncthreads();
    hi = lo;
  }
}

// Repair pass `pass`: swap socket s with uniform(draw pass of the repair
// stream, E), on one thread, then a barrier.
static __device__ void repair_swap(int32_t* perm, int s, int E, int pass,
                                   uint32_t code, uint32_t chunk, uint2 key) {
  if (threadIdx.x == 0) {
    const uint4 r = ldpc::philox4x32_10(
        make_uint4(static_cast<uint32_t>(pass) >> 1, code, chunk,
                   kRepairStream),
        key);
    const int j = (pass & 1) ? uniform_below(r.z, r.w, E)
                             : uniform_below(r.x, r.y, E);
    const int32_t held = perm[s];
    perm[s] = perm[j];
    perm[j] = held;
  }
  __syncthreads();
}

}  // namespace sampler
}  // namespace ldpc
