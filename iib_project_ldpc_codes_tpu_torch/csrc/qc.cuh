// Shared by the quasi-cyclic (circulant-index) kernels: qc_check_exactly_one.cu,
// qc_variable_or.cu, qc_gallager_check.cu, and qc_gallager_variable.cu
// (vector_ok and kMaxPlanes only: Q4 has a layout of its own).
//
// Every pass here works on [Z, W] planes of packed words, one plane per base
// node: blockIdx.y is the base check or the variable block, so its base
// table entries are uniform across the block (broadcast loads), and the
// x dimension runs a grid-stride loop over the plane's Z * (W / N) items of
// N adjacent words.  Inside a plane every index fits 32 bits (the wrappers
// hold n * W * 32 below 2^31), so an item costs one 32-bit division; only
// the final word offsets are 64-bit.  N = 4 (16-byte loads and stores, a
// warp moving 512 contiguous bytes) when W is a multiple of 4 and every
// plane pointer is 16-byte aligned, else N = 1.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace ldpc {
namespace qc {

template <int N>
struct alignas(4 * N) Words {
  uint32_t v[N];
};

template <int N>
__device__ __forceinline__ Words<N> load(const int32_t* p) {
  return *reinterpret_cast<const Words<N>*>(p);
}

template <int N>
__device__ __forceinline__ void store(int32_t* p, const Words<N>& w) {
  *reinterpret_cast<Words<N>*>(p) = w;
}

// Row (z + shift) mod Z, for 0 <= z, shift < Z: one conditional subtract.
__device__ __forceinline__ int row_plus(int z, int shift, int lift) {
  const int zz = z + shift;
  return zz >= lift ? zz - lift : zz;
}

// Row (z - shift) mod Z, for 0 <= z, shift < Z: one conditional add, never
// a negative `%`.
__device__ __forceinline__ int row_minus(int z, int shift, int lift) {
  const int zz = z - shift;
  return zz < 0 ? zz + lift : zz;
}

// Word offset of row `row` of plane `plane`, word w, in an int32[planes * Z,
// W] array.
__device__ __forceinline__ long long at(int plane, int row, int lift,
                                        int words, int w) {
  return (static_cast<long long>(plane) * lift + row) * words + w;
}

// Blocks along x for `planes` planes of `items` items each: enough in all to
// fill the 132 SMs several times over, never more than the items need.
inline dim3 grid_for_planes(long long items, int planes) {
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = (132LL * 32 + planes - 1) / planes;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned int>(blocks),
              static_cast<unsigned int>(planes), 1);
}

constexpr int kMaxPlanes = 65535;   // gridDim.y

// True when N = 4 may be used: W a multiple of 4 and every (non-null)
// pointer 16-byte aligned.
inline bool vector_ok(int words, std::initializer_list<const void*> ptrs) {
  if (words % 4) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

}  // namespace qc
}  // namespace ldpc
