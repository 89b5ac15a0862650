// Kernel C: the soft decoder's check pass (syndrome and new messages).
//
// Replaces the check side of iib_project_ldpc_codes_tpu/ops/soft_bp.py
// _soft_iteration (:200-223) with _check_update_minsum (:97-132) and
// _check_update_sumproduct (:135-148).  For check c, trial b and socket j
// (message row c*dc + j, variable var_j = chk_to_var[c, j]):
//   syndrome: XOR_j [pm[var_j, b] < 0] on the working-type plane pm; the
//             count of unsatisfied (check, trial) pairs of each code is
//             added into unsat[code] (one atomic per code and warp);
//   extrinsic: row_j = pm[var_j, b] - msg[c*dc + j, b] in the accumulation
//             type, clipped to +-30 for float messages;
//   min-sum:  |out_j| = min_{l != j} |row_l|, sign = XOR_{l != j} sign_l,
//             then max(|out| - beta, 0) and alpha |out| (float), or
//             min(|out|, 127) with the empty minimum 4 * 127 (int8);
//   sum-product: t_l = clip(tanh(row_l / 2), +-0.999999), out_j =
//             2 atanh(clip(pre_j suf_j, +-0.999999)) with JAX's prefix and
//             suffix products (same factors, same order, so the same
//             roundings; tanhf and atanhf are CUDA's).
// Padded check sockets of an irregular code (var_j == pad_var) write 0 (JAX
// chk_sock_mask, :220-222); their row still takes part in the others'
// minimum and product, as in JAX.  A thread reads its own dc messages before
// it writes them, and no other thread touches them, so the update is in
// place.  Codes whose active flag is 0 are skipped whole.
//
// The min-sum minimum over the others is taken from the two smallest
// magnitudes (the first index of the smallest gets the second): min is
// exact, so this equals JAX's prefix/suffix minima bit for bit, and the
// signs are the total XOR minus the own bit.  Sum-product keeps JAX's
// prefix/suffix products, since a product's rounding depends on its order.
//
// Bound on the H100: memory.  Per (check, trial): dc pm gathers, dc message
// loads and dc message stores in the working type (5.64 GB a round in
// float32 at n = 8192, (3,6), B = 24,576; 2.82 GB bfloat16; 1.41 GB int8);
// the sum-product's tanhf/atanhf add 2 dc transcendental calls.  Threads
// are laid out as in the posterior pass (4 bytes of columns, columns
// fastest), so every gather of a warp reads a contiguous 128-byte segment
// of one pm row (one code per 32 columns in ensemble mode, the table entry
// broadcast).  Templates over (type, method, max degree) keep the per-socket
// arrays in registers.
#include "soft.cuh"

namespace {

using ldpc::soft::Elem;
using ldpc::soft::Lanes;
using ldpc::soft::load_lanes;
using ldpc::soft::store_lanes;

using ldpc::soft::clipf;
using ldpc::soft::kLlrClip;
using ldpc::soft::kMinSum;
using ldpc::soft::kSumProduct;

constexpr int kChecksPerThread = 16;

template <typename T, int kMethod, int kMaxDc>
__global__ void soft_check_kernel(const T* __restrict__ pm, T* __restrict__ msg,
                                  const int32_t* __restrict__ chk_to_var,
                                  const int32_t* __restrict__ active,
                                  int32_t* __restrict__ unsat, int rows,
                                  int table_rows, int dc, int pad_var, int cols,
                                  int cpc, float alpha, float beta) {
  constexpr int K = 4 / sizeof(T);
  constexpr bool kQuantised = sizeof(T) == 1;
  using E = Elem<T>;
  using Acc = typename E::Acc;
  const int nvec = cols / K;
  const long long groups = (rows + kChecksPerThread - 1) / kChecksPerThread;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int code = -1, bad = 0;
  if (t < groups * nvec) {
    const int group = static_cast<int>(t / nvec);
    const int col0 = static_cast<int>(t - static_cast<long long>(group) * nvec) * K;
    code = col0 / cpc;
    if (__ldg(active + code)) {
      const int c_end = min(rows, (group + 1) * kChecksPerThread);
      for (int c = group * kChecksPerThread; c < c_end; ++c) {
        const int32_t* vars =
            chk_to_var + (static_cast<long long>(code) * table_rows + c) * dc;
        T* own = msg + static_cast<long long>(c) * dc * cols + col0;
        Lanes<T, K> pv[kMaxDc], mv[kMaxDc];
        unsigned padded = 0u;
#pragma unroll
        for (int j = 0; j < kMaxDc; ++j) {
          if (j < dc) {
            const int var = __ldg(vars + j);
            padded |= static_cast<unsigned>(var == pad_var) << j;
            pv[j] = load_lanes<T, K>(pm + static_cast<long long>(var) * cols + col0);
            mv[j] = load_lanes<T, K>(own + static_cast<long long>(j) * cols);
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          Acc r[kMaxDc];
          unsigned parity = 0u;
#pragma unroll
          for (int j = 0; j < kMaxDc; ++j) {
            if (j < dc) {
              const Acc p = E::acc(pv[j].v[k]);
              parity ^= p < 0;
              r[j] = E::sub(p, E::acc(mv[j].v[k]));
              if constexpr (!kQuantised) r[j] = clipf(r[j], kLlrClip);
            }
          }
          bad += parity;
          Acc out[kMaxDc];
          ldpc::soft::check_update<T, kMethod, kMaxDc>(r, dc, alpha, beta, out);
#pragma unroll
          for (int j = 0; j < kMaxDc; ++j)
            if (j < dc) mv[j].v[k] = E::store((padded >> j) & 1u ? Acc(0) : out[j]);
        }
#pragma unroll
        for (int j = 0; j < kMaxDc; ++j)
          if (j < dc) store_lanes<T, K>(own + static_cast<long long>(j) * cols, mv[j]);
      }
    }
  }
  // every lane of every warp gets here (one item per thread, no early exit)
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, code);
  bad = __reduce_add_sync(peers, bad);
  if (code >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1 && bad)
    atomicAdd(unsat + code, bad);
}

template <typename T, int kMethod, int kMaxDc>
void launch_check(const void* pm, void* msg, const void* chk_to_var,
                  const void* active, void* unsat, int rows, int table_rows,
                  int dc, int pad_var, int cols, int cpc, float alpha,
                  float beta, cudaStream_t stream) {
  constexpr int K = 4 / sizeof(T);
  const long long items =
      static_cast<long long>((rows + kChecksPerThread - 1) / kChecksPerThread) *
      (cols / K);
  if (items <= 0) return;
  const long long blocks = (items + ldpc::kThreads - 1) / ldpc::kThreads;
  soft_check_kernel<T, kMethod, kMaxDc><<<static_cast<unsigned int>(blocks),
                                          ldpc::kThreads, 0, stream>>>(
      static_cast<const T*>(pm), static_cast<T*>(msg),
      static_cast<const int32_t*>(chk_to_var),
      static_cast<const int32_t*>(active), static_cast<int32_t*>(unsat), rows,
      table_rows, dc, pad_var, cols, cpc, alpha, beta);
}

template <typename T, int kMethod>
int dispatch_degree(const void* pm, void* msg, const void* chk_to_var,
                    const void* active, void* unsat, int rows, int table_rows,
                    int dc, int pad_var, int cols, int cpc, float alpha,
                    float beta, cudaStream_t s) {
  if (dc <= 8) {
    launch_check<T, kMethod, 8>(pm, msg, chk_to_var, active, unsat, rows,
                                table_rows, dc, pad_var, cols, cpc, alpha,
                                beta, s);
  } else if (dc <= 16) {
    launch_check<T, kMethod, 16>(pm, msg, chk_to_var, active, unsat, rows,
                                 table_rows, dc, pad_var, cols, cpc, alpha,
                                 beta, s);
  } else if (dc <= 32) {
    launch_check<T, kMethod, 32>(pm, msg, chk_to_var, active, unsat, rows,
                                 table_rows, dc, pad_var, cols, cpc, alpha,
                                 beta, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// method: 0 min-sum, 1 sum-product; dtype: 0 float32, 1 bfloat16, 2 int8
// (min-sum only, alpha = 1, beta = 0).  pad_var < 0: no padded sockets.
extern "C" int ldpc_soft_check(const void* pm, void* msg,
                               const void* chk_to_var, const void* active,
                               void* unsat, int rows, int table_rows, int dc,
                               int pad_var, int cols, int cpc, int dtype,
                               int method, float alpha, float beta,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cols % 4 || cpc % 4 || dc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ldpc::soft::kFloat32 && method == kMinSum)
    return dispatch_degree<float, kMinSum>(pm, msg, chk_to_var, active, unsat,
                                           rows, table_rows, dc, pad_var, cols,
                                           cpc, alpha, beta, s);
  if (dtype == ldpc::soft::kFloat32 && method == kSumProduct)
    return dispatch_degree<float, kSumProduct>(pm, msg, chk_to_var, active,
                                               unsat, rows, table_rows, dc,
                                               pad_var, cols, cpc, alpha, beta,
                                               s);
  if (dtype == ldpc::soft::kBfloat16 && method == kMinSum)
    return dispatch_degree<__nv_bfloat16, kMinSum>(
        pm, msg, chk_to_var, active, unsat, rows, table_rows, dc, pad_var, cols,
        cpc, alpha, beta, s);
  if (dtype == ldpc::soft::kBfloat16 && method == kSumProduct)
    return dispatch_degree<__nv_bfloat16, kSumProduct>(
        pm, msg, chk_to_var, active, unsat, rows, table_rows, dc, pad_var, cols,
        cpc, alpha, beta, s);
  if (dtype == ldpc::soft::kInt8 && method == kMinSum && alpha == 1.0f &&
      beta == 0.0f)
    return dispatch_degree<int8_t, kMinSum>(pm, msg, chk_to_var, active, unsat,
                                            rows, table_rows, dc, pad_var,
                                            cols, cpc, alpha, beta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
