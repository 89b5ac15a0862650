// Kernel A: AWGN channel LLRs straight from Philox.
//
// Replaces iib_project_ldpc_codes_tpu/ops/channels.py:86-93 (AWGN.transmit
// and AWGN.llr, as parallel/montecarlo.py:252-254 calls them inside
// _soft_chunk): normals times sigma plus the BPSK symbol 1 - 2b, then
// 2y/sigma^2.  Without a transmitted plane (tx == nullptr) b = 0 for every
// element, the all-zero codeword, in an instantiation whose symbol is the
// constant +1; with one, b is bit i % 32 of word i / 32 of the packed
// int32[n, B / 32] codeword plane (B a multiple of 32, so a row's words
// follow each other and the four elements of a thread share one word).
//
// Draw scheme (ops/channels.py documents it; its plain version runs the same
// arithmetic):
//   element i of the row-major float32[n, B] output  <-  lane i % 4 of
//   Philox4x32-10(counter = (g lo, g hi, offset lo, offset hi), key),
//   g = i / 4, key = philox_key(seed) with 0xB7E15162 XORed into word 0 (the
//   wrapper passes it so: a stream apart from K1's, whose key is untweaked,
//   and the code sampler's, which tweaks word 1).  Box-Muller in float64 on
//   each pair of words: u1 = (x + 0.5) 2^-32, u2 = y 2^-32, r =
//   sqrt(-2 ln u1), theta = 2 pi u2, lanes (0, 1) <- r (cos, sin) theta of
//   words (0, 1), lanes (2, 3) of words (2, 3); z is rounded to float32.  Then, in float32 and in JAX's
//   order, noise = z * sigma, y = (1 - 2b) + noise, llr = (2 y) / (sigma sigma),
//   each step rounded on its own (the __f*_rn intrinsics keep nvcc from
//   fusing the multiply and the add).
//
// Bound on the H100: the float32 output, 4 bytes per element written once
// (805 MB, 0.24 ms at 3.35 TB/s for n = 8192, B = 24,576), against one
// Philox block and two float64 log/sqrt/sincos per four elements on the
// FP64 units (half the FP32 rate).  One thread per Philox block keeps every
// draw in registers and writes its four results as one 16-byte store.
#include "common.cuh"

namespace {

constexpr double kTwoPi = 6.283185307179586;
constexpr double kTwoToMinus32 = 2.3283064365386963e-10;

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& z0,
                                           float& z1) {
  const double u1 = (static_cast<double>(a) + 0.5) * kTwoToMinus32;
  const double u2 = static_cast<double>(b) * kTwoToMinus32;
  const double r = sqrt(-2.0 * log(u1));
  const double theta = kTwoPi * u2;
  double s, c;
  sincos(theta, &s, &c);
  z0 = static_cast<float>(r * c);
  z1 = static_cast<float>(r * s);
}

__device__ __forceinline__ float llr_of(float z, float sigma, float sigma_sq,
                                       uint32_t bit) {
  const float y = __fadd_rn(bit ? -1.0f : 1.0f, __fmul_rn(z, sigma));
  return __fdiv_rn(__fmul_rn(2.0f, y), sigma_sq);
}

template <bool kTx>
__global__ void awgn_llr_kernel(float* __restrict__ out, long long total,
                                uint32_t k0, uint32_t k1, uint32_t offset_lo,
                                uint32_t offset_hi, float sigma,
                                const int32_t* __restrict__ tx) {
  const uint2 key = make_uint2(k0, k1);
  const float sigma_sq = __fmul_rn(sigma, sigma);
  const long long blocks = (total + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < blocks; g += stride) {
    const uint4 r = ldpc::philox4x32_10(
        make_uint4(static_cast<uint32_t>(g),
                   static_cast<uint32_t>(static_cast<unsigned long long>(g) >> 32),
                   offset_lo, offset_hi),
        key);
    float4 v;
    box_muller(r.x, r.y, v.x, v.y);
    box_muller(r.z, r.w, v.z, v.w);
    const long long i = 4 * g;
    uint32_t bits = 0u;
    if (kTx) bits = static_cast<uint32_t>(__ldg(tx + (i >> 5))) >> (i & 31);
    v.x = llr_of(v.x, sigma, sigma_sq, bits & 1u);
    v.y = llr_of(v.y, sigma, sigma_sq, (bits >> 1) & 1u);
    v.z = llr_of(v.z, sigma, sigma_sq, (bits >> 2) & 1u);
    v.w = llr_of(v.w, sigma, sigma_sq, (bits >> 3) & 1u);
    if (i + 3 < total) {
      *reinterpret_cast<float4*>(out + i) = v;   // torch allocations: 256 B aligned
    } else {
      const float lanes[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; i + k < total; ++k) out[i + k] = lanes[k];
    }
  }
}

}  // namespace

extern "C" int ldpc_awgn_llr(void* out, long long total, unsigned int k0,
                             unsigned int k1, unsigned int offset_lo,
                             unsigned int offset_hi, float sigma,
                             const void* tx, void* stream) {
  if (tx != nullptr && total % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned int blocks = ldpc::grid_for((total + 3) / 4);
    if (tx == nullptr) {
      awgn_llr_kernel<false><<<blocks, ldpc::kThreads, 0, s>>>(
          static_cast<float*>(out), total, k0, k1, offset_lo, offset_hi,
          sigma, nullptr);
    } else {
      awgn_llr_kernel<true><<<blocks, ldpc::kThreads, 0, s>>>(
          static_cast<float*>(out), total, k0, k1, offset_lo, offset_hi,
          sigma, static_cast<const int32_t*>(tx));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
