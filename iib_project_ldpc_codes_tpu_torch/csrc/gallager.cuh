// Shared by the Gallager passes (gallager_check.cu, gallager_variable.cu,
// qc_gallager_variable.cu and kernel G, gallager_decode.cu): the bit-sliced
// disagreement count, and the round kernels' row vectors.
#pragma once

#include "common.cuh"

namespace ldpc {

constexpr int kMaxDegree = 32;     // the wrappers raise above it
constexpr int kCountPlanes = 6;    // counts up to 63 >= kMaxDegree

// Planes of a bit-sliced count up to d: the bit width of d (2 for 3, 3
// for 4, 6 for kMaxDegree).
__host__ __device__ constexpr int planes_for(int d) {
  return d < 2 ? 1 : 1 + planes_for(d / 2);
}

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

// V adjacent 32-bit words of a row (V = 4, 2, 1: one 16-, 8- or 4-byte
// access; the wrappers pick V so that every access is aligned).
template <int V>
struct Words {
  uint32_t w[V];
};

// Of a plane the kernel only reads (the read-only data path).
template <int V>
__device__ __forceinline__ Words<V> load_ro(const int32_t* p) {
  Words<V> r;
  if constexpr (V == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    r.w[0] = x.x, r.w[1] = x.y, r.w[2] = x.z, r.w[3] = x.w;
  } else if constexpr (V == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    r.w[0] = x.x, r.w[1] = x.y;
  } else {
    r.w[0] = __ldg(p);
  }
  return r;
}

// Of a plane the kernel also writes (plain, coherent loads).
template <int V>
__device__ __forceinline__ Words<V> load_rw(const int32_t* p) {
  Words<V> r;
  if constexpr (V == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    r.w[0] = x.x, r.w[1] = x.y, r.w[2] = x.z, r.w[3] = x.w;
  } else if constexpr (V == 2) {
    const int2 x = *reinterpret_cast<const int2*>(p);
    r.w[0] = x.x, r.w[1] = x.y;
  } else {
    r.w[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(int32_t* p, const Words<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(r.w[0], r.w[1]);
  } else {
    *p = static_cast<int32_t>(r.w[0]);
  }
}

}  // namespace ldpc
