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
// The transform is written for its inputs, with no call and no branch
// (the math library's log, sqrt and sincos handle any double: special
// values, subnormals, Payne-Hanek reduction):
//   * -2 ln u1 from the word a: v = 2a + 1 is an odd 33-bit integer, exact
//     as a double (a conversion and an FMA), so its exponent field gives
//     u1's exponent and its mantissa field m in [1, 2), both exactly.  m's
//     top 5 bits pick a table entry (1/c, with 20 significant bits so that
//     t = m/c - 1 is exact, and -2 ln c split in a part on a 2^-40 grid and
//     a rest), and a degree-8 polynomial gives -2 log1p(t), |t| <= 2^-6.
//     The grid makes k 2 ln 2 + (-2 ln c) exact, so the sum carries one
//     rounding whatever cancels.  Entries 13-31 fold c above sqrt 2 to
//     c / 2 (and entry 31 is c = 2), so near u1 = 1 the result is
//     -2 log1p(t) itself, relative to its own size.
//   * r = sqrt(x) by the reciprocal square root unit (MUFU.RSQ64H), one
//     Goldschmidt step and one Newton correction.
//   * the angle theta = 2 pi u2, rounded once as the plain version rounds
//     it, minus the nearest multiple q pi/2 (q from the top bits of b: the
//     octant) with a two-part pi/2, so |x| <= pi/4; sin and cos by a
//     degree-13 odd and a degree-14 even polynomial, swapped and signed by q
//     on the float32 results.
//   * the float32 division by sigma^2 as a product by rcp = RN(1 /
//     sigma^2) and two remainder corrections (Markstein): the first leaves
//     the quotient within one ulp, so the second rounds it correctly
//     (Markstein's theorem: rcp within half an ulp of 1/s, q within one ulp
//     of a/s, r = a - s q exact by the FMA, then RN(q + r rcp) = RN(a/s)),
//     for every a as long as no step under- or overflows: sigma^2 in
//     [2^-60, 2^60] (|2y| in [2^-23, 2^35] or +0 here).  Outside that range
//     the kernel keeps __fdiv_rn.
// ldpc_awgn_llr_check holds the transform and the division against the math
// library and __fdiv_rn over every 32-bit word (chip_smoke.py phase 18).
//
// Bound on the H100: the float32 output, 4 bytes per element written once
// (805 MB, 0.24 ms at 3.35 TB/s for n = 8192, B = 24,576); the Philox
// products (20 a block of four elements) are far below it.  What sets this
// kernel's time is instruction issue, about 65 instructions an element (22
// of them FP64, 15 Philox), so the design cuts instructions: no call or
// branch in the transform, the polynomial coefficients loaded once into
// (uniform) registers (as literals the compiler rebuilds them on every
// trip), the tables in shared memory as 32-bit words one a bank (no
// conflicts for any index), and four Philox blocks a trip, independent
// chains for the scheduler.  Each block writes its four results as one
// 16-byte store.
#include "common.cuh"

namespace {

// the log table, entry i for m in [1 + i/32, 1 + (i+1)/32): the high words
// of 1/c (the low words are 0) and of the rest of -2 ln c (rounded to 21
// bits), and -2 ln c on a 2^-40 grid (entries 13-31: -2 ln(c/2))
constexpr int kFold = 13;
__constant__ uint32_t kInvC[32] = {
    0x3fef81f8u, 0x3fee9132u, 0x3fedae60u, 0x3fecd856u, 0x3fec0e08u, 0x3feb4e82u,
    0x3fea98f0u, 0x3fe9ec8eu, 0x3fe948b0u, 0x3fe8acbau, 0x3fe81818u, 0x3fe78a4cu,
    0x3fe702e0u, 0x3fe68168u, 0x3fe60582u, 0x3fe58ed2u, 0x3fe51d08u, 0x3fe4afd6u,
    0x3fe446f8u, 0x3fe3e22cu, 0x3fe38138u, 0x3fe323e4u, 0x3fe2c9fcu, 0x3fe27350u,
    0x3fe21fb8u, 0x3fe1cf06u, 0x3fe18118u, 0x3fe135c8u, 0x3fe0ecf6u, 0x3fe0a682u,
    0x3fe0624eu, 0x3fe00000u};
__constant__ uint32_t kLogLo[32] = {
    0xbcff8f3eu, 0x3d3b73bau, 0x3d5317b7u, 0x3d4f549bu, 0x3d5d669au, 0x3d0fb306u,
    0x3d5df6e4u, 0xbd406db2u, 0xbd47cbd5u, 0x3d39d507u, 0x3d49e977u, 0xbd53638eu,
    0x3d474bd9u, 0xbd1e0b2au, 0xbd33b7cdu, 0xbd3df27bu, 0x3d56e9bbu, 0xbd5e3f1au,
    0x3d43a424u, 0x3d20e873u, 0x3d13f228u, 0x3d542b9du, 0x3d5ed0dfu, 0xbd56fe5cu,
    0x3d5e72cbu, 0x3d55c9efu, 0xbd5fcf86u, 0x3d47248cu, 0x3d598ee2u, 0x3d24b32au,
    0x3d5773d2u, 0x00000000u};
__constant__ unsigned long long kLogHi[32] = {
    0xbf9fc0b0b0fc0000ull, 0xbfb7745376330000ull, 0xbfc341db961c0000ull,
    0xbfca9271fa4b0000ull, 0xbfd0d779fcd0c000ull, 0xbfd44d2a0ccb8000ull,
    0xbfd7ab8602110000ull, 0xbfdaf3cc2e80c000ull, 0xbfde270c6e2b0000ull,
    0xbfe0a3227273a000ull, 0xbfe229423bcf8000ull, 0xbfe3a64db5694000ull,
    0xbfe51aae872e0000ull, 0x3fe5d5bd9f596000ull, 0x3fe4718f9271c000ull,
    0x3fe314f151d36000ull, 0x3fe1bf99a35a6000ull, 0x3fe07136704d6000ull,
    0x3fde530c7fe70000ull, 0x3fdbd082783bc000ull, 0x3fd95a5a5cf70000ull,
    0x3fd6f0174b754000ull, 0x3fd4914243338000ull, 0x3fd23d6c2a49c000ull,
    0x3fcfe89839db8000ull, 0x3fcb6abecdad0000ull, 0x3fc700d20aeb0000ull,
    0x3fc2aa03a4470000ull, 0x3fbccb854ddd0000ull, 0x3fb466cc542d0000ull,
    0x3fa8493028c80000ull, 0x0000000000000000ull};

// 2 ln 2 on the 2^-40 grid and its rest; pi/2 in 50 bits (so q pi/2 is
// exact for q <= 4) and its rest
constexpr double kTwoLn2Hi = 0x1.62e42fefa4000p+0;
constexpr double kTwoLn2Lo = -0x1.8432a1b0e2634p-42;
constexpr double kHalfPiHi = 0x1.921fb54442d18p+0;
constexpr double kHalfPiLo = 0x1.1a62633145c07p-54;
// 2 pi 2^-32 and 2 pi 2^20: fma(2^52 + b, the first, -the second) rounds
// 2 pi b 2^-32 once, the plain version's theta
constexpr double kTwoPiUlp = 0x1.921fb54442d18p-30;
constexpr double kTwoPiBias = 0x1.921fb54442d18p+22;
constexpr double kTwo52 = 0x1p52;

// -2 log1p(t) = -2 t + t^2 q(t), |t| <= 2^-6; sin x = x + x^3 s(x^2) and
// cos x = 1 - x^2/2 + x^4 c(x^2), |x| <= pi/4 (interpolants at Chebyshev
// nodes, max error 2^-57 relative, 2^-56 and 2^-60 absolute)
struct Coef {
  double q[7], s[6], c[6];
};
__device__ Coef kCoef = {
    {0x1.0000000000000p+0, -0x1.55555555561cap-1, 0x1.0000000000b36p-1,
     -0x1.999998d258344p-2, 0x1.555554a20099dp-2, -0x1.24ab2f908fd82p-2,
     0x1.0016690195ac2p-2},
    {-0x1.5555555555555p-3, 0x1.1111111110bb1p-7, -0x1.a01a019e8357dp-13,
     0x1.71de37961e4c6p-19, -0x1.ae600a926c89ap-26, 0x1.5e0af186af739p-33},
    {0x1.5555555555555p-5, -0x1.6c16c16c16966p-10, 0x1.a01a019f4e867p-16,
     -0x1.27e4fa17a41b4p-22, 0x1.1eeb68b109173p-29, -0x1.907d7aebd5e3dp-37}};

// The coefficients in registers for the whole grid-stride loop, loaded once
// by plain loads (not const, so that the compiler cannot fold them back
// into literals).
__device__ __forceinline__ Coef load_coef() {
  Coef c;
  const double* src = reinterpret_cast<const double*>(&kCoef);
  double* dst = reinterpret_cast<double*>(&c);
#pragma unroll
  for (int j = 0; j < 19; ++j) dst[j] = __ldg(src + j);
  return c;
}

// the log table in shared memory, one 32-bit word a bank (no conflicts for
// any index)
struct Tables {
  uint32_t inv_c[32], log_lo[32], log_hi_lo[32], log_hi_hi[32];
};

__device__ __forceinline__ void load_tables(Tables& t) {
  const int i = threadIdx.x;
  if (i < 32) {
    t.inv_c[i] = kInvC[i];
    t.log_lo[i] = kLogLo[i];
    t.log_hi_lo[i] = static_cast<uint32_t>(kLogHi[i]);
    t.log_hi_hi[i] = static_cast<uint32_t>(kLogHi[i] >> 32);
  }
  __syncthreads();
}

// the double of a small non-negative integer, by one add
__device__ __forceinline__ double small_int(uint32_t k) {
  return __hiloint2double(0x43300000, static_cast<int>(k)) - kTwo52;
}

// r = sqrt(-2 ln u1), u1 = (a + 0.5) 2^-32 = v 2^-33, v = 2a + 1
__device__ __forceinline__ double radius(uint32_t a, const Tables& tb,
                                         const Coef& cf) {
  const double v = fma(2.0, static_cast<double>(a), 1.0);   // exact
  const uint32_t hi = static_cast<uint32_t>(__double2hiint(v));
  const uint32_t i = (hi >> 15) & 31u;                 // m's top 5 bits
  const double m = __hiloint2double(
      static_cast<int>((hi & 0x000FFFFFu) | 0x3FF00000u), __double2loint(v));
  // k = 33 - e - fold, e = the exponent of v (u1 = m 2^(e - 33))
  const double k = small_int(1056u - (hi >> 20) - (i >= kFold ? 1u : 0u));
  const double t = fma(m, __hiloint2double(static_cast<int>(tb.inv_c[i]), 0),
                       -1.0);                          // exact
  double q = cf.q[6];
#pragma unroll
  for (int j = 5; j >= 0; --j) q = fma(q, t, cf.q[j]);
  const double p = fma(t * t, q, fma(t, -2.0, __hiloint2double(
                                                 static_cast<int>(tb.log_lo[i]),
                                                 0)));
  const double hi_sum = fma(k, kTwoLn2Hi, __hiloint2double(
      static_cast<int>(tb.log_hi_hi[i]), static_cast<int>(tb.log_hi_lo[i])));
  const double x = hi_sum + fma(k, kTwoLn2Lo, p);  // -2 ln u1 > 2^-33
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double h = x * y, g = 0.5 * y;
  const double e = fma(-h, g, 0.5);
  h = fma(h, e, h);
  g = fma(g, e, g);
  return fma(fma(-h, h, x), g, h);
}

// theta = RN(2 pi b 2^-32) = q pi/2 + x, q the nearest quadrant (from the
// top bits of b), |x| <= pi/4: (cos x, sin x) and q
__device__ __forceinline__ void reduced_cos_sin(uint32_t b, const Coef& cf,
                                                double& cx, double& sx,
                                                uint32_t& q) {
  const double theta = fma(__hiloint2double(0x43300000, static_cast<int>(b)),
                           kTwoPiUlp, -kTwoPiBias);
  q = ((b >> 29) + 1) >> 1;
  const double qd = small_int(q);
  const double x = fma(-qd, kHalfPiLo, fma(-qd, kHalfPiHi, theta));
  const double z = x * x;
  double ps = cf.s[5], pc = cf.c[5];
#pragma unroll
  for (int j = 4; j >= 0; --j) {
    ps = fma(ps, z, cf.s[j]);
    pc = fma(pc, z, cf.c[j]);
  }
  sx = fma(x * z, ps, x);
  cx = fma(z, fma(z, pc, -0.5), 1.0);
}

// z0, z1 = RN32(r cos theta), RN32(r sin theta): cos theta = +-cos x for q
// even, +-sin x for q odd (and sin theta the other), negative for q = 1, 2
// (cos) and q = 2, 3 (sin); the swap and the signs are exact on the float32
// results
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b,
                                           const Tables& tb, const Coef& cf,
                                           float& z0, float& z1) {
  const double r = radius(a, tb, cf);
  double cx, sx;
  uint32_t q;
  reduced_cos_sin(b, cf, cx, sx, q);
  const float zc = __double2float_rn(r * cx), zs = __double2float_rn(r * sx);
  const bool odd = q & 1u;
  z0 = __uint_as_float(__float_as_uint(odd ? zs : zc) ^ (((q + 1) & 2u) << 30));
  z1 = __uint_as_float(__float_as_uint(odd ? zc : zs) ^ ((q & 2u) << 30));
}

// RN(2y / s) for s = sigma^2 in [2^-60, 2^60], from rcp2 = 2 RN(1 / s) and
// s_half = s / 2 (exact): Markstein's sequence on a = 2y with its remainders
// halved, which changes no rounding
__device__ __forceinline__ float div_by_products(float y, float s_half,
                                                 float rcp2) {
  const float q0 = __fmul_rn(y, rcp2);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, s_half, y), rcp2, q0);
  return __fmaf_rn(__fmaf_rn(-q1, s_half, y), rcp2, q1);
}

template <bool kProducts>
__device__ __forceinline__ float llr_of(float z, float sigma, float sigma_sq,
                                        float rcp2, uint32_t bit) {
  const float y = __fadd_rn(bit ? -1.0f : 1.0f, __fmul_rn(z, sigma));
  return kProducts ? div_by_products(y, 0.5f * sigma_sq, rcp2)
                   : __fdiv_rn(__fmul_rn(2.0f, y), sigma_sq);
}

// One Philox block: its four elements' LLRs, stored as one 16-byte write
// (torch allocations are 256-byte aligned) or, for the plane's last block,
// one element at a time.
template <bool kTx, bool kProducts>
__device__ __forceinline__ void draw_block(
    long long g, float* __restrict__ out, long long total,
    uint32_t offset_lo, uint32_t offset_hi, uint2 key,
    const Tables& tb, const Coef& cf, float sigma, float sigma_sq,
    float rcp2, const int32_t* __restrict__ tx) {
  const uint4 r = ldpc::philox4x32_10(
      make_uint4(static_cast<uint32_t>(g),
                 static_cast<uint32_t>(static_cast<unsigned long long>(g) >>
                                       32),
                 offset_lo, offset_hi),
      key);
  float4 v;
  box_muller(r.x, r.y, tb, cf, v.x, v.y);
  box_muller(r.z, r.w, tb, cf, v.z, v.w);
  const long long i = 4 * g;
  uint32_t bits = 0u;
  if (kTx) bits = static_cast<uint32_t>(__ldg(tx + (i >> 5))) >> (i & 31);
  v.x = llr_of<kProducts>(v.x, sigma, sigma_sq, rcp2, bits & 1u);
  v.y = llr_of<kProducts>(v.y, sigma, sigma_sq, rcp2, (bits >> 1) & 1u);
  v.z = llr_of<kProducts>(v.z, sigma, sigma_sq, rcp2, (bits >> 2) & 1u);
  v.w = llr_of<kProducts>(v.w, sigma, sigma_sq, rcp2, (bits >> 3) & 1u);
  if (i + 3 < total) {
    *reinterpret_cast<float4*>(out + i) = v;
  } else {                              // at most three elements left
    out[i] = v.x;
    if (i + 1 < total) out[i + 1] = v.y;
    if (i + 2 < total) out[i + 2] = v.z;
  }
}

// Philox blocks a thread draws on each trip of its grid-stride loop: four
// chains of independent float64 work in flight
constexpr int kPerTrip = 4;

template <bool kTx, bool kProducts>
__global__ void __launch_bounds__(ldpc::kThreads)
awgn_llr_kernel(float* __restrict__ out, long long total, uint32_t k0,
                uint32_t k1, uint32_t offset_lo, uint32_t offset_hi,
                float sigma, const int32_t* __restrict__ tx) {
  __shared__ Tables tb;
  load_tables(tb);
  const Coef cf = load_coef();
  const uint2 key = make_uint2(k0, k1);
  const float sigma_sq = __fmul_rn(sigma, sigma);
  const float rcp2 = kProducts ? 2.0f * __frcp_rn(sigma_sq) : 0.0f;
  const long long blocks = (total + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  for (; g + (kPerTrip - 1) * stride < blocks; g += kPerTrip * stride) {
#pragma unroll
    for (int u = 0; u < kPerTrip; ++u)
      draw_block<kTx, kProducts>(g + u * stride, out, total, offset_lo,
                                 offset_hi, key, tb, cf, sigma, sigma_sq,
                                 rcp2, tx);
  }
  for (; g < blocks; g += stride)
    draw_block<kTx, kProducts>(g, out, total, offset_lo, offset_hi, key, tb,
                               cf, sigma, sigma_sq, rcp2, tx);
}

// Counts over the words w in [first, first + words) (every word < 2^32):
// [0] r(w) further than 2^-50 relative from sqrt(-2 log u1) of the math
// library, [1] words whose float32 rounding of r differs, [2] cos or sin
// of b = w further than 2^-50 from sincos(theta), theta rounded as above,
// [3] float32 numerators a (bits w) whose quotient by sigma_sq differs from
// __fdiv_rn, among the [4] compared (+0 and |a| in [2^-23, 2^35]); [5] and
// [6] the largest relative error of r and absolute error
// of cos / sin, as the bits of a double.  mode bit 0: the transform, bit 1:
// the division.
__global__ void __launch_bounds__(ldpc::kThreads)
awgn_llr_check_kernel(unsigned long long* __restrict__ counts,
                      long long first, long long words, float sigma_sq,
                      int mode) {
  __shared__ Tables tb;
  load_tables(tb);
  const Coef cf = load_coef();
  const float rcp2 = 2.0f * __frcp_rn(sigma_sq);
  unsigned int n_r = 0, n_f32 = 0, n_cs = 0, n_div = 0, n_cmp = 0;
  double max_r = 0.0, max_cs = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < words; j += stride) {
    const uint32_t w = static_cast<uint32_t>(first + j);
    if (mode & 1) {
      const double r = radius(w, tb, cf);
      const double ref = sqrt(-2.0 * log((static_cast<double>(w) + 0.5) *
                                         2.3283064365386963e-10));
      const double rel = fabs(r - ref) / ref;
      n_r += rel > 0x1p-50;
      n_f32 += __double2float_rn(r) != __double2float_rn(ref);
      max_r = fmax(max_r, rel);
      double cx, sx, rc, rs;
      uint32_t q;
      reduced_cos_sin(w, cf, cx, sx, q);
      sincos(6.283185307179586 * (static_cast<double>(w) *
                                  2.3283064365386963e-10), &rs, &rc);
      const double c = (q & 1u) ? sx : cx, s = (q & 1u) ? cx : sx;
      const double err = fmax(fabs(((q + 1) & 2u ? -c : c) - rc),
                              fabs((q & 2u ? -s : s) - rs));
      n_cs += err > 0x1p-50;
      max_cs = fmax(max_cs, err);
    }
    if (mode & 2) {
      // every 2y the kernel divides is +0 (a sum with +-1 is never -0) or
      // in [2^-23, 2^35] in magnitude: those numerators are compared
      const float a = __uint_as_float(w);
      if (w == 0u || (fabsf(a) >= 0x1p-23f && fabsf(a) <= 0x1p35f)) {
        ++n_cmp;
        n_div += __float_as_uint(div_by_products(0.5f * a, 0.5f * sigma_sq,
                                                 rcp2)) !=
                 __float_as_uint(__fdiv_rn(a, sigma_sq));
      }
    }
  }
  const unsigned int all = 0xffffffffu;
  n_r = __reduce_add_sync(all, n_r);
  n_f32 = __reduce_add_sync(all, n_f32);
  n_cs = __reduce_add_sync(all, n_cs);
  n_div = __reduce_add_sync(all, n_div);
  n_cmp = __reduce_add_sync(all, n_cmp);
  for (int d = 16; d > 0; d >>= 1) {
    max_r = fmax(max_r, __shfl_xor_sync(all, max_r, d));
    max_cs = fmax(max_cs, __shfl_xor_sync(all, max_cs, d));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(counts + 0, n_r);
    atomicAdd(counts + 1, n_f32);
    atomicAdd(counts + 2, n_cs);
    atomicAdd(counts + 3, n_div);
    atomicAdd(counts + 4, n_cmp);
    // non-negative doubles order as their bits
    atomicMax(counts + 5, static_cast<unsigned long long>(
                              __double_as_longlong(max_r)));
    atomicMax(counts + 6, static_cast<unsigned long long>(
                              __double_as_longlong(max_cs)));
  }
}

template <bool kTx, bool kProducts>
void launch(float* out, long long total, unsigned int k0, unsigned int k1,
            unsigned int offset_lo, unsigned int offset_hi, float sigma,
            const int32_t* tx, cudaStream_t s) {
  awgn_llr_kernel<kTx, kProducts>
      <<<ldpc::grid_for((total + 3) / 4), ldpc::kThreads, 0, s>>>(
          out, total, k0, k1, offset_lo, offset_hi, sigma, tx);
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
    auto* o = static_cast<float*>(out);
    const auto* t = static_cast<const int32_t*>(tx);
    const float sigma_sq = sigma * sigma;
    const bool products = sigma_sq >= 0x1p-60f && sigma_sq <= 0x1p60f;
    if (tx == nullptr) {
      if (products)
        launch<false, true>(o, total, k0, k1, offset_lo, offset_hi, sigma, t, s);
      else
        launch<false, false>(o, total, k0, k1, offset_lo, offset_hi, sigma, t, s);
    } else {
      if (products)
        launch<true, true>(o, total, k0, k1, offset_lo, offset_hi, sigma, t, s);
      else
        launch<true, false>(o, total, k0, k1, offset_lo, offset_hi, sigma, t, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// counts: uint64[7], zeroed by the caller (the check kernel's comment)
extern "C" int ldpc_awgn_llr_check(void* counts, long long first,
                                   long long words, float sigma_sq, int mode,
                                   void* stream) {
  if (first < 0 || words < 0 || first + words > (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (words > 0)
    awgn_llr_check_kernel<<<ldpc::grid_for(words), ldpc::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned long long*>(counts), first, words, sigma_sq,
        mode);
  return static_cast<int>(cudaGetLastError());
}
