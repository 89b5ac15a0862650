// Shared by the Gallager variable passes (gallager_variable.cu,
// qc_gallager_variable.cu and kernel G, gallager_decode.cu): the bit-sliced
// disagreement count.
#pragma once

#include "common.cuh"

namespace ldpc {

constexpr int kMaxDegree = 32;     // the wrappers raise above it
constexpr int kCountPlanes = 6;    // counts up to 63 >= kMaxDegree

// Bits whose bit-sliced count (planes, LSB first) is >= k; kPlanes planes
// count up to 2^kPlanes - 1 (kernel G takes 3 for degrees up to 4).
template <int kPlanes>
__device__ __forceinline__ uint32_t count_at_least(
    const uint32_t (&planes)[kPlanes], int k) {
  if (k <= 0) return 0xFFFFFFFFu;
  if (k >= (1 << kPlanes)) return 0u;
  uint32_t ge = 0u, eq = 0xFFFFFFFFu;
#pragma unroll
  for (int i = kPlanes - 1; i >= 0; --i) {
    const uint32_t p = planes[i];
    if ((k >> i) & 1) {
      eq &= p;
    } else {
      ge |= eq & p;
      eq &= ~p;
    }
  }
  return ge | eq;
}

}  // namespace ldpc
