// Shared by the soft-decision passes (soft_posterior.cu, soft_check.cu) and
// their quasi-cyclic counterparts (qc_soft_posterior.cu, qc_soft_check.cu).
//
// Message planes are [rows, B] in the working type T (float, bfloat16 or
// int8), trial b in column b; for a batch of C codes column b belongs to
// code b / (B / C).  A thread takes a run of adjacent columns of a row (4
// to 16 bytes, each kernel says which), so a warp moves a contiguous
// segment of the row.  The wrappers require B and B / C to be multiples
// of 4.
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

enum Method { kMinSum = 0, kSumProduct = 1 };

__device__ __forceinline__ float clipf(float x, float c) {
  return fminf(fmaxf(x, -c), c);
}

// The check update of one check and trial of float32 or bfloat16 messages,
// shared by soft_check.cu and qc_soft_check.cu: the dc extrinsic inputs
// r[0 .. dc-1] (float32, already clipped to +-kLlrClip) -> the dc new
// messages out[0 .. dc-1] (soft_check.cu's header states the rules).
// kMaxDc bounds dc at compile time, so both arrays stay in registers; a
// caller that passes dc = kMaxDc as a constant gets no guard at all.
template <int kMethod, int kMaxDc>
__device__ __forceinline__ void check_update(const float (&r)[kMaxDc], int dc,
                                             float alpha, float beta,
                                             float (&out)[kMaxDc]) {
  if constexpr (kMethod == kMinSum) {
    // the two smallest magnitudes and the sign parity
    float m1 = INFINITY, m2 = INFINITY;
    int i1 = -1;
    unsigned signs = 0u, all = 0u;
#pragma unroll
    for (int j = 0; j < kMaxDc; ++j) {
      if (j < dc) {
        const float a = fabsf(r[j]);
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
        float mag = j == i1 ? m2 : m1;
        if (beta != 0.0f) mag = fmaxf(__fsub_rn(mag, beta), 0.0f);
        if (alpha != 1.0f) mag = __fmul_rn(alpha, mag);
        out[j] = ((all ^ (signs >> j)) & 1u) ? -mag : mag;
      }
    }
  } else {
    float tv[kMaxDc], suf[kMaxDc];
#pragma unroll
    for (int j = 0; j < kMaxDc; ++j)
      if (j < dc) tv[j] = clipf(tanhf(__fmul_rn(r[j], 0.5f)), kTanhClip);
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

// ---------------------------------------------------------------------------
// int8 min-sum on packed lanes: four trials a 32-bit word (soft_check.cu,
// qc_soft_check.cu)
// ---------------------------------------------------------------------------
//
// JAX's update (ops/soft_bp.py _check_update_minsum, mag_cap = 127),
//   out_j = sign_j * min(min_{k != j} |r_k|, 127),  r_k = p_k - m_k,
// sign_j the XOR of the other sockets' signs, is exact on r'_k = sat8(r_k):
// |r'_k| = min(|r_k|, 127) by saturating absolute value and sign(r'_k) =
// sign(r_k), zero included.  With m1 <= m2 the two smallest |r'| and 127,
// out_j's magnitude is m2 where |r'_j| = m1 and m1 elsewhere (ties give m1 =
// m2), so no index is kept, and a degree-1 check gives +127 as JAX's big =
// 4 * 127 does.  Per socket and word: r' = __vsubss4(p, m), a = __vabsss4,
// m2 = min(m2, max(m1, a)), m1 = min(m1, a) in unsigned bytes, the signs
// XORed in bit 7 of every byte.  The syndrome is the popcount of the sign
// bits of the XORed p words.

constexpr uint32_t kSignBits = 0x80808080u;   // bit 7 of every byte
constexpr uint32_t kCap = 0x7F7F7F7Fu;        // 127 in every byte

// 0xFF in every byte whose bit 7 is set, else 0 (prmt's sign replication)
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
  uint32_t d;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(d) : "r"(x));
  return d;
}

// -x in every byte, for bytes in [0, 127]: 0x80 - x never borrows, and
// (0x80 - x) ^ 0x80 is 256 - x, or 0 for x = 0
__device__ __forceinline__ uint32_t negate_bytes(uint32_t x) {
  return (kSignBits - x) ^ kSignBits;
}

// The min/sign state of one word of four trials over a check's sockets.
struct MinSum8 {
  uint32_t m1 = kCap, m2 = kCap, signs = 0u;

  // folds in the socket with posterior word p and message word m; returns
  // its r' word
  __device__ __forceinline__ uint32_t add(uint32_t p, uint32_t m) {
    const uint32_t x = __vsubss4(p, m);
    const uint32_t a = __vabsss4(x);
    signs ^= x;
    m2 = __vminu4(m2, __vmaxu4(m1, a));
    m1 = __vminu4(m1, a);
    return x;
  }

  // the new message word of the socket whose r' word is x
  __device__ __forceinline__ uint32_t out(uint32_t x) const {
    const uint32_t at_min = __vcmpeq4(__vabsss4(x), m1);
    const uint32_t mag = m1 ^ (at_min & (m1 ^ m2));
    const uint32_t neg = sign_bytes(signs ^ x);
    return mag ^ (neg & (mag ^ negate_bytes(mag)));
  }
};

// ---------------------------------------------------------------------------
// int8 posterior sums on packed lanes: four trials a 32-bit word
// (soft_posterior.cu; qc_soft_posterior.cu may take it too)
// ---------------------------------------------------------------------------
//
// JAX's posterior (ops/soft_bp.py _posterior in int16, then clip to +-127
// and the int8 cast) on one word of four trials: each byte is sign-extended
// into a 16-bit half (prmt with sign-replicating selectors: trials 0, 1
// into `lo`, trials 2, 3 into `hi`), the halves are summed with __vadd2
// (two 16-bit adds, no carry between them), saturated at +-127 by
// __vmins2 / __vmaxs2 and packed back by prmt.  Why it is exact: every
// addend lies in [-128, 127] and a posterior has at most 1 + 32 of them, so
// |sum| <= 33 * 128 = 4,224 < 2^15: no half ever wraps, and each half holds
// JAX's int16 sum exactly (integer addition, so in any order).  Saturation
// keeps the sign, so the decision sum < 0 is bit 15 of the half.  A
// saturating byte add per step (__vaddss4) is NOT exact: 127 + 127 - 127
// gives 0 there, 127 in int16.
struct Sum8 {
  uint32_t lo, hi;

  Sum8() = default;
  __device__ __forceinline__ explicit Sum8(uint32_t x)
      : lo(widen_lo(x)), hi(widen_hi(x)) {}

  __device__ __forceinline__ void add(uint32_t x) {
    lo = __vadd2(lo, widen_lo(x));
    hi = __vadd2(hi, widen_hi(x));
  }

  // the four sums clipped to +-127, as int8 bytes in trial order
  __device__ __forceinline__ uint32_t clipped() const {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, 0x6420;"
        : "=r"(d) : "r"(clip(lo)), "r"(clip(hi)));
    return d;
  }

  // bit i set where trial i's sum is negative
  __device__ __forceinline__ uint32_t negative() const {
    return ((lo >> 15) & 1u) | ((lo >> 30) & 2u) | ((hi >> 13) & 4u) |
           ((hi >> 28) & 8u);
  }

  // trial i's sum
  __device__ __forceinline__ int value(int i) const {
    const uint32_t h = i < 2 ? lo : hi;
    return i & 1 ? static_cast<int>(h) >> 16
                 : static_cast<int>(static_cast<int16_t>(h & 0xFFFFu));
  }

  __device__ __forceinline__ static uint32_t widen_lo(uint32_t x) {
    uint32_t d;
    asm("prmt.b32 %0, %1, 0, 0x9180;" : "=r"(d) : "r"(x));
    return d;
  }

  __device__ __forceinline__ static uint32_t widen_hi(uint32_t x) {
    uint32_t d;
    asm("prmt.b32 %0, %1, 0, 0xB3A2;" : "=r"(d) : "r"(x));
    return d;
  }

  // each signed half into [-127, 127] (0xFF81 is -127)
  __device__ __forceinline__ static uint32_t clip(uint32_t h) {
    return __vmaxs2(__vmins2(h, 0x007F007Fu), 0xFF81FF81u);
  }
};

// bit i of a nibble -> byte i (0 or 1): four bool lanes from four flags
__device__ __forceinline__ uint32_t spread_nibble(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

template <typename E, int N>
__device__ __forceinline__ Lanes<E, N> load_lanes(const E* p) {
  return *reinterpret_cast<const Lanes<E, N>*>(p);
}

template <typename E, int N>
__device__ __forceinline__ void store_lanes(E* p, const Lanes<E, N>& v) {
  *reinterpret_cast<Lanes<E, N>*>(p) = v;
}

template <int kBytes>
struct Raw;
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

// The same moves of 4, 8 or 16 bytes, cache-streaming (ld.global.cs /
// st.global.cs: evict first), for a stream read once and written once that
// should not push a plane gathered many times out of L2.
template <typename E, int N>
__device__ __forceinline__ Lanes<E, N> load_lanes_streaming(const E* p) {
  using R = typename Raw<sizeof(E) * N>::type;
  Lanes<E, N> v;
  *reinterpret_cast<R*>(&v) = __ldcs(reinterpret_cast<const R*>(p));
  return v;
}

template <typename E, int N>
__device__ __forceinline__ void store_lanes_streaming(E* p,
                                                      const Lanes<E, N>& v) {
  using R = typename Raw<sizeof(E) * N>::type;
  __stcs(reinterpret_cast<R*>(p), *reinterpret_cast<const R*>(&v));
}

}  // namespace soft
}  // namespace ldpc
