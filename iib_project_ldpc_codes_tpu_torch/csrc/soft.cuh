// Shared by the soft-decision passes (soft_posterior.cu, soft_check.cu).
//
// Message planes are [rows, B] in the working type T (float, bfloat16 or
// int8), trial b in column b; for a batch of C codes column b belongs to
// code b / (B / C).  A thread takes 4 bytes of a row, kCols = 4 / sizeof(T)
// adjacent columns, so a warp moves 128 contiguous bytes of a row whatever
// the type.  The wrappers require B and B / C to be multiples of 4.
//
// Arithmetic follows the JAX package's soft_bp.py: float32 for float32 and
// bfloat16 messages (bfloat16 is widened exactly and rounded to nearest even
// when stored), int16 for int8 messages (held here in an int: every value
// stays within [-(1 + 32) * 127, (1 + 32) * 127]).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace ldpc {
namespace soft {

enum Dtype { kFloat32 = 0, kBfloat16 = 1, kInt8 = 2 };

template <typename E, int N>
struct alignas(sizeof(E) * N) Vec {
  E v[N];
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Acc = float;
  __device__ static float acc(float x) { return x; }
  __device__ static float store(float a) { return a; }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  __device__ static float acc(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float a) { return __float2bfloat16_rn(a); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <>
struct Elem<int8_t> {
  using Acc = int;
  __device__ static int acc(int8_t x) { return x; }
  // the int8 posterior plane saturates at +-127 (JAX soft_bp.py:196-197)
  __device__ static int8_t store(int a) {
    return static_cast<int8_t>(max(-127, min(127, a)));
  }
  __device__ static int add(int a, int b) { return a + b; }
  __device__ static int sub(int a, int b) { return a - b; }
};

template <typename E, int N>
__device__ __forceinline__ Vec<E, N> load(const E* p) {
  return *reinterpret_cast<const Vec<E, N>*>(p);
}

template <typename E, int N>
__device__ __forceinline__ void store(E* p, const Vec<E, N>& v) {
  *reinterpret_cast<Vec<E, N>*>(p) = v;
}

}  // namespace soft
}  // namespace ldpc
