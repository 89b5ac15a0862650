// Q2: variable pass of the packed BEC round on a quasi-cyclic code, with
// its error count.
//
// Replaces the variable half of iib_project_ldpc_codes_tpu/ops/qc_bp.py
// _qc_iteration_allzero (:64-87: roll each socket's exactly-one plane back
// by +s and OR it into block b) and of _qc_iteration (:90-117), and the
// per-round total_popcount(~known) of the fixed-point loop (:121-146).  For
// lifted variable (b, z) and word w, over block b's base sockets i (check
// c_i, shift s_i; the variable-side adjacency, padded per block with -1):
//   r_i         = c_i * Z + (z - s_i) mod Z
//   any         = OR_i exactly_one[r_i, w]
//   taken       = OR_i adopt[r_i, w]                     (kVal only)
//   val[v, w]   |= taken & ~known[v, w]                  (kVal only)
//   known[v, w] |= any
//   *errors += sum over all (v, w) of popcount(~known[v, w])
// Q1's plane is the check-level summary (exactly one participant unknown);
// ORing it into a participant that is already known changes nothing, so the
// result equals JAX's per-socket planes bit for bit.
//
// `known` (and `val`) are updated in place: Q1, which read them, has
// finished on the same stream, and each thread writes only its own (v, w).
// The two passes keep the exactly-one plane between them; one fused in-place
// kernel would race across blocks.  (z - s) mod Z is z - s plus one
// conditional add of Z (0 <= s < Z), never a negative `%`.  Offsets are
// 64-bit.
//
// Bound on the H100: memory, dvb loads of `exactly_one` (2 dvb with value
// planes) + 1 read + 1 write of 4 bytes per word.  blockIdx.y is the variable
// block, a thread takes N adjacent words of a row (qc.cuh), words fastest:
// coalesced warp loads on contiguous rows.  An item whose trials all know
// the variable already skips its loads and stores (known only grows), as K3
// does.  The count is reduced across the warp and added with one atomicAdd
// per warp (integer atomics: exact in any order).
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

template <bool kVal, int N>
__global__ void qc_variable_or_kernel(
    int32_t* __restrict__ known, int32_t* __restrict__ val,
    const int32_t* __restrict__ exactly_one, const int32_t* __restrict__ adopt,
    const int32_t* __restrict__ var_chk, const int32_t* __restrict__ var_shift,
    int32_t* __restrict__ errors_slot, int dvb, int lift, int words) {
  const int b = blockIdx.y;
  const int groups = words / N;
  const int items = lift * groups;
  const int32_t* chks = var_chk + b * dvb;
  const int32_t* sh = var_shift + b * dvb;
  int unknown = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int z = i / groups;
    const int w = (i - z * groups) * N;
    const long long own = ldpc::qc::at(b, z, lift, words, w);
    Words<N> k = ldpc::qc::load<N>(known + own);
    uint32_t all_known = 0xFFFFFFFFu;
#pragma unroll
    for (int l = 0; l < N; ++l) all_known &= k.v[l];
    if (all_known != 0xFFFFFFFFu) {
      Words<N> any = {}, taken = {};
      for (int p = 0; p < dvb; ++p) {
        const int c = __ldg(chks + p);
        if (c < 0) break;                  // this block's sockets are done
        const long long src = ldpc::qc::at(
            c, ldpc::qc::row_minus(z, __ldg(sh + p), lift), lift, words, w);
        const Words<N> e = ldpc::qc::load<N>(exactly_one + src);
        Words<N> a = {};
        if (kVal) a = ldpc::qc::load<N>(adopt + src);
#pragma unroll
        for (int l = 0; l < N; ++l) {
          any.v[l] |= e.v[l];
          taken.v[l] |= a.v[l];
        }
      }
      if (kVal) {
        Words<N> v = ldpc::qc::load<N>(val + own);
#pragma unroll
        for (int l = 0; l < N; ++l) v.v[l] |= taken.v[l] & ~k.v[l];
        ldpc::qc::store<N>(val + own, v);
      }
#pragma unroll
      for (int l = 0; l < N; ++l) k.v[l] |= any.v[l];
      ldpc::qc::store<N>(known + own, k);
    }
#pragma unroll
    for (int l = 0; l < N; ++l) unknown += __popc(~k.v[l]);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    unknown += __shfl_down_sync(0xFFFFFFFFu, unknown, offset);
  }
  if ((threadIdx.x & 31) == 0 && unknown != 0) {
    atomicAdd(errors_slot, unknown);
  }
}

template <bool kVal, int N>
void launch_variable(void* known, void* val, const void* exactly_one,
                     const void* adopt, const void* var_chk,
                     const void* var_shift, void* errors_slot, int nb,
                     int dvb, int lift, int words, cudaStream_t stream) {
  const long long items = static_cast<long long>(lift) * (words / N);
  qc_variable_or_kernel<kVal, N>
      <<<ldpc::qc::grid_for_planes(items, nb), ldpc::kThreads, 0, stream>>>(
          static_cast<int32_t*>(known), static_cast<int32_t*>(val),
          static_cast<const int32_t*>(exactly_one),
          static_cast<const int32_t*>(adopt),
          static_cast<const int32_t*>(var_chk),
          static_cast<const int32_t*>(var_shift),
          static_cast<int32_t*>(errors_slot), dvb, lift, words);
}

}  // namespace

extern "C" int ldpc_qc_variable_or(void* known, void* val,
                                   const void* exactly_one, const void* adopt,
                                   const void* var_chk, const void* var_shift,
                                   void* errors_slot, int nb, int dvb,
                                   int lift, int words, void* stream) {
  const long long total = static_cast<long long>(nb) * lift * words;
  if ((val == nullptr) != (adopt == nullptr) || nb > ldpc::qc::kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const bool vec =
        ldpc::qc::vector_ok(words, {known, val, exactly_one, adopt});
    auto fn = val == nullptr ? (vec ? launch_variable<false, 4>
                                    : launch_variable<false, 1>)
                             : (vec ? launch_variable<true, 4>
                                    : launch_variable<true, 1>);
    fn(known, val, exactly_one, adopt, var_chk, var_shift, errors_slot, nb,
       dvb, lift, words, s);
  }
  return static_cast<int>(cudaGetLastError());
}
