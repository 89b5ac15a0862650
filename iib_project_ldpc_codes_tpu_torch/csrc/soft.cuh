// Shared by the soft-decision passes (soft_posterior.cu, soft_check.cu) and
// their quasi-cyclic counterparts (qc_soft_posterior.cu, qc_soft_check.cu).
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

// N adjacent elements of type E moved as accesses of at most 16 bytes: the
// struct is aligned to min(sizeof(E) * N, 16), so a run of up to 16 bytes
// is one access and a 32- or 64-byte run two or four 16-byte accesses.
template <typename E, int N>
struct alignas(sizeof(E) * N < 16 ? sizeof(E) * N : 16) Lanes {
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

constexpr float kLlrClip = 30.0f;
constexpr float kTanhClip = 0.999999f;
constexpr int kInt8Max = 127;

enum Method { kMinSum = 0, kSumProduct = 1 };

__device__ __forceinline__ float clipf(float x, float c) {
  return fminf(fmaxf(x, -c), c);
}

// The check update of one check and trial, shared by soft_check.cu and
// qc_soft_check.cu: the dc extrinsic inputs r[0 .. dc-1] (accumulation
// type, float inputs already clipped to +-kLlrClip) -> the dc new messages
// out[0 .. dc-1] (soft_check.cu's header states the rules).  kMaxDc bounds
// dc at compile time, so both arrays stay in registers.
template <typename T, int kMethod, int kMaxDc>
__device__ __forceinline__ void check_update(
    const typename Elem<T>::Acc (&r)[kMaxDc], int dc, float alpha, float beta,
    typename Elem<T>::Acc (&out)[kMaxDc]) {
  using Acc = typename Elem<T>::Acc;
  constexpr bool kQuantised = sizeof(T) == 1;
  if constexpr (kMethod == kMinSum) {
    // the two smallest magnitudes and the sign parity
    Acc big;
    if constexpr (kQuantised) big = 4 * kInt8Max; else big = INFINITY;
    Acc m1 = big, m2 = big;
    int i1 = -1;
    unsigned signs = 0u, all = 0u;
#pragma unroll
    for (int j = 0; j < kMaxDc; ++j) {
      if (j < dc) {
        Acc a;
        if constexpr (kQuantised) a = r[j] < 0 ? -r[j] : r[j]; else a = fabsf(r[j]);
        const unsigned s = r[j] < 0;
        signs |= s << j;
        all ^= s;
        if (a < m1) {
          m2 = m1;
          m1 = a;
          i1 = j;
        } else if (a < m2) {
          m2 = a;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxDc; ++j) {
      if (j < dc) {
        Acc mag = j == i1 ? m2 : m1;
        if constexpr (kQuantised) {
          mag = min(mag, Acc(kInt8Max));
        } else {
          if (beta != 0.0f) mag = fmaxf(__fsub_rn(mag, beta), 0.0f);
          if (alpha != 1.0f) mag = __fmul_rn(alpha, mag);
        }
        out[j] = ((all ^ (signs >> j)) & 1u) ? -mag : mag;
      }
    }
  } else {
    float tv[kMaxDc], suf[kMaxDc];
#pragma unroll
    for (int j = 0; j < kMaxDc; ++j)
      if (j < dc) tv[j] = clipf(tanhf(__fmul_rn(float(r[j]), 0.5f)), kTanhClip);
    float acc = 1.0f;
#pragma unroll
    for (int j = kMaxDc - 1; j >= 0; --j) {
      if (j < dc) {
        suf[j] = acc;
        acc = __fmul_rn(acc, tv[j]);
      }
    }
    float pre = 1.0f;
#pragma unroll
    for (int j = 0; j < kMaxDc; ++j) {
      if (j < dc) {
        out[j] = __fmul_rn(2.0f, atanhf(clipf(__fmul_rn(pre, suf[j]), kTanhClip)));
        pre = __fmul_rn(pre, tv[j]);
      }
    }
  }
}

template <typename E, int N>
__device__ __forceinline__ Lanes<E, N> load_lanes(const E* p) {
  return *reinterpret_cast<const Lanes<E, N>*>(p);
}

template <typename E, int N>
__device__ __forceinline__ void store_lanes(E* p, const Lanes<E, N>& v) {
  *reinterpret_cast<Lanes<E, N>*>(p) = v;
}

}  // namespace soft
}  // namespace ldpc
