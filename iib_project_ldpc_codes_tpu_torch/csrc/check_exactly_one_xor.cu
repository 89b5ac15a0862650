// Value-plane check pass of the packed BEC round (random-codeword transmit).
//
// Replaces iib_project_ldpc_codes_tpu/ops/erasure_bp.py:186-228
// (_check_summaries(code, val, known)), the check half of _packed_iteration
// (:239-248).  For check c and word w over its dc participants
// v_j = chk_to_var[c, j]:
//   exactly_one[c, w] = bits where exactly one known[v_j, w] is 0
//   adopt[c, w]       = exactly_one & XOR_j (val[v_j, w] & known[v_j, w])
// The second plane is the value the unique unknown participant must take,
// already masked by exactly_one, so the variable pass ORs it as it is
// (JAX: _gather_or_by_variable(code, exactly_one & xor_known)).  The
// exactly-one summary is K2's two running masks (a zero seen once, a zero
// seen twice); K2 itself (check_exactly_one.cu) stays the all-zero path.
//
// Bound on the H100: memory.  Per (check, word): dc gathered rows of
// `known` and of `val` (2 dc loads of 4 bytes) and two 4-byte stores; at
// n = 1e4, W = 768 that is 184 MB read and 31 MB written a round.  One
// thread per (check, word), word fastest, so each gathered row is a
// coalesced 128-byte warp load and the table entries are broadcasts, as K2.
// A batch of C codes reads code w / wpc's table slice for word w.
#include "common.cuh"

namespace {

__global__ void check_exactly_one_xor_kernel(
    const int32_t* __restrict__ known, const int32_t* __restrict__ val,
    const int32_t* __restrict__ chk_to_var, int32_t* __restrict__ exactly_one,
    int32_t* __restrict__ adopt, int m, int dc, int words, int wpc) {
  const long long total = static_cast<long long>(m) * words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int c = static_cast<int>(t / words);
    const int w = static_cast<int>(t - static_cast<long long>(c) * words);
    const int32_t* row =
        chk_to_var + (static_cast<long long>(w / wpc) * m + c) * dc;
    uint32_t once = 0, twice = 0, xor_known = 0;
    for (int j = 0; j < dc; ++j) {
      const long long at = static_cast<long long>(__ldg(row + j)) * words + w;
      const uint32_t k = static_cast<uint32_t>(__ldg(known + at));
      const uint32_t unknown = ~k;
      twice |= once & unknown;
      once |= unknown;
      xor_known ^= static_cast<uint32_t>(__ldg(val + at)) & k;
    }
    const uint32_t eo = once & ~twice;
    exactly_one[t] = static_cast<int32_t>(eo);
    adopt[t] = static_cast<int32_t>(eo & xor_known);
  }
}

}  // namespace

extern "C" int ldpc_check_exactly_one_xor(const void* known, const void* val,
                                          const void* chk_to_var,
                                          void* exactly_one, void* adopt,
                                          int m, int dc, int words, int wpc,
                                          void* stream) {
  const long long total = static_cast<long long>(m) * words;
  if (total > 0) {
    check_exactly_one_xor_kernel<<<ldpc::grid_for(total), ldpc::kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(known), static_cast<const int32_t*>(val),
        static_cast<const int32_t*>(chk_to_var),
        static_cast<int32_t*>(exactly_one), static_cast<int32_t*>(adopt), m,
        dc, words, wpc);
  }
  return static_cast<int>(cudaGetLastError());
}
