// Q1: check pass of the packed BEC round on a quasi-cyclic code.
//
// Replaces the check half of iib_project_ldpc_codes_tpu/ops/qc_bp.py
// _qc_iteration_allzero (:64-87) and, with value planes, of _qc_iteration
// (:90-117).  JAX makes one rolled copy of a whole [Z, W] plane per base
// socket (jnp.roll by -s) and forms every socket's exactly-one plane by
// prefix and suffix ANDs; here the shift folds into the load address and no
// rolled copy exists.  For lifted check (c, z) and word w, over the REAL
// sockets j of base check c (base_chk[c, j] < nb):
//   v_j               = base_chk[c, j] * Z + (z + shifts[c, j]) mod Z
//   exactly_one[c*Z+z, w] = bits where exactly one known[v_j, w] is 0
//   adopt[c*Z+z, w]       = exactly_one & XOR_j (val[v_j, w] & known[v_j, w])
// The second plane (kVal, random-codeword transmit) is the value the unique
// unknown participant must take, as check_exactly_one_xor.cu writes it; the
// all-zero instantiation (val == nullptr) neither reads val nor writes adopt.
// The exactly-one summary is K2's two running masks (a zero seen once, a
// zero seen twice).
//
// No per-lifted-edge table is read: the neighbour index is computed from
// the two base tables (mb * dcb ints, broadcast loads).  (z + s) mod Z is one
// conditional subtract, as 0 <= s < Z.  Offsets are 64-bit.
//
// Bound on the H100: memory.  Per (check, word): one 4-byte load of `known`
// per real socket and one 4-byte store (twice that with value planes); each
// byte of `known` is read dvb times a round.  blockIdx.y is the base check,
// a thread takes N adjacent words of a row (qc.cuh), words fastest: a warp
// reads contiguous bytes of a row, consecutive z are consecutive rows, and
// the wrap at z + s = Z splits a block's stream once.
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

template <bool kVal, int N>
__global__ void qc_check_exactly_one_kernel(
    const int32_t* __restrict__ known, const int32_t* __restrict__ val,
    const int32_t* __restrict__ base_chk, const int32_t* __restrict__ shifts,
    int32_t* __restrict__ exactly_one, int32_t* __restrict__ adopt, int dcb,
    int nb, int lift, int words) {
  const int c = blockIdx.y;
  const int groups = words / N;
  const int items = lift * groups;
  const int32_t* blocks = base_chk + c * dcb;
  const int32_t* sh = shifts + c * dcb;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int z = i / groups;
    const int w = (i - z * groups) * N;
    Words<N> once = {}, twice = {}, xor_known = {};
    for (int j = 0; j < dcb; ++j) {
      const int b = __ldg(blocks + j);
      if (b >= nb) continue;               // padded socket of an irregular base
      const long long src = ldpc::qc::at(
          b, ldpc::qc::row_plus(z, __ldg(sh + j), lift), lift, words, w);
      const Words<N> k = ldpc::qc::load<N>(known + src);
      Words<N> v = {};
      if (kVal) v = ldpc::qc::load<N>(val + src);
#pragma unroll
      for (int l = 0; l < N; ++l) {
        const uint32_t unknown = ~k.v[l];
        twice.v[l] |= once.v[l] & unknown;
        once.v[l] |= unknown;
        if (kVal) xor_known.v[l] ^= v.v[l] & k.v[l];
      }
    }
    const long long dst = ldpc::qc::at(c, z, lift, words, w);
    Words<N> eo, ad;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      eo.v[l] = once.v[l] & ~twice.v[l];
      ad.v[l] = eo.v[l] & xor_known.v[l];
    }
    ldpc::qc::store<N>(exactly_one + dst, eo);
    if (kVal) ldpc::qc::store<N>(adopt + dst, ad);
  }
}

template <bool kVal, int N>
void launch_check(const void* known, const void* val, const void* base_chk,
                  const void* shifts, void* exactly_one, void* adopt, int mb,
                  int dcb, int nb, int lift, int words, cudaStream_t stream) {
  const long long items = static_cast<long long>(lift) * (words / N);
  qc_check_exactly_one_kernel<kVal, N>
      <<<ldpc::qc::grid_for_planes(items, mb), ldpc::kThreads, 0, stream>>>(
          static_cast<const int32_t*>(known), static_cast<const int32_t*>(val),
          static_cast<const int32_t*>(base_chk),
          static_cast<const int32_t*>(shifts),
          static_cast<int32_t*>(exactly_one), static_cast<int32_t*>(adopt),
          dcb, nb, lift, words);
}

}  // namespace

extern "C" int ldpc_qc_check_exactly_one(const void* known, const void* val,
                                         const void* base_chk,
                                         const void* shifts,
                                         void* exactly_one, void* adopt,
                                         int mb, int dcb, int nb, int lift,
                                         int words, void* stream) {
  const long long total = static_cast<long long>(mb) * lift * words;
  if ((val == nullptr) != (adopt == nullptr) || mb > ldpc::qc::kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec =
        ldpc::qc::vector_ok(words, {known, val, exactly_one, adopt});
    auto fn = val == nullptr
                  ? (vec ? launch_check<false, 4> : launch_check<false, 1>)
                  : (vec ? launch_check<true, 4> : launch_check<true, 1>);
    fn(known, val, base_chk, shifts, exactly_one, adopt, mb, dcb, nb, lift,
       words, s);
  }
  return static_cast<int>(cudaGetLastError());
}
