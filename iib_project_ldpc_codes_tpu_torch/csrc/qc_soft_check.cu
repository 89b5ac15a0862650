// S2: the check pass of soft BP on a quasi-cyclic code (syndrome and new
// messages).
//
// Replaces the check side of iib_project_ldpc_codes_tpu/ops/qc_soft_bp.py
// _qc_soft_iteration (:83-104).  Messages are check-resident, [E_b * Z, B]
// in the working type T as in JAX: plane off[c] + jj holds socket jj of base
// check c, row z of it lifted check (c, z), so an irregular base has no
// padded rows.  For base check c (blockIdx.y), lifted row z and trial b,
// over the dc_c real sockets jj of c (variable block chk_block[c, jj], shift
// chk_shift[c, jj], compacted to the left; dc_c = off[c+1] - off[c]):
//   p_jj = pm[chk_block[c, jj]*Z + (z + s_jj) mod Z, b]     (qc::row_plus)
//   syndrome: XOR_jj [p_jj < 0]; the unsatisfied (check, trial) pairs are
//             added into unsat[0] (one atomic per warp);
//   r_jj  = p_jj - msg[(off[c] + jj)*Z + z, b] in the accumulation type,
//           clipped to +-30 for float messages;
//   msg[(off[c] + jj)*Z + z, b] = the check update of the r's, in place:
//           min-sum (alpha, beta), int8 min-sum saturated at 127, or
//           sum-product, the function soft_check.cu uses
//           (soft.cuh::check_update; its header states the rules).
// JAX rolls every pm plane by -s into the check frame; here (z + s) mod Z is
// one conditional subtract in the load address and no rolled copy exists.
// A thread reads its own dc_c messages before it writes them and no other
// thread touches them, so the update is in place.  Nothing runs when
// active[0] is 0.
//
// Bound on the H100: memory.  Per (check, trial): dc_c pm gathers, dc_c
// message loads and dc_c message stores in the working type; the nb = 12
// (3,6) base at Z = 834, B = 24,576 moves 2.21 GB a round in int8.  Design
// as qc_soft_posterior.cu: a grid row per base check (its tables uniform
// loads), 32-bit in-plane indices, V adjacent trials a thread for checks of
// degree up to 8: 16-byte accesses in float32 and bfloat16 (V = 4, 8),
// 8-byte in int8 (V = 8; 16 lanes of 8 sockets spilled registers on the
// H100).  The per-socket values stay in registers, so the kernel is
// instantiated by the largest base check degree (6, 8; above 8, up to 32,
// one trial a thread, two in int8), as Q4 is.
#include "qc.cuh"
#include "soft.cuh"

namespace {

using ldpc::soft::clipf;
using ldpc::soft::Elem;
using ldpc::soft::kLlrClip;
using ldpc::soft::kMinSum;
using ldpc::soft::kSumProduct;
using ldpc::soft::Lanes;
using ldpc::soft::load_lanes;
using ldpc::soft::store_lanes;

constexpr int kMaxDegree = 32;

template <typename T, int kMethod, int V, int kMaxDc>
__global__ void qc_soft_check_kernel(
    const T* __restrict__ pm, T* __restrict__ msg,
    const int32_t* __restrict__ chk_block,
    const int32_t* __restrict__ chk_shift,
    const int32_t* __restrict__ row_offs, const int32_t* __restrict__ active,
    int32_t* __restrict__ unsat, int dcb, int lift, int cols, float alpha,
    float beta) {
  constexpr bool kQuantised = sizeof(T) == 1;
  using E = Elem<T>;
  using Acc = typename E::Acc;
  if (!__ldg(active)) return;               // one code: uniform over the grid
  const int c = blockIdx.y;
  const int off = __ldg(row_offs + c);
  const int dc = __ldg(row_offs + c + 1) - off;
  const int groups = cols / V;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int bad = 0;
  if (i < lift * groups) {
    const int z = i / groups;
    const int col0 = (i - z * groups) * V;
    const long long plane = static_cast<long long>(lift) * cols;
    const int own = z * cols + col0;
    const int32_t* blocks = chk_block + c * dcb;
    const int32_t* shifts = chk_shift + c * dcb;
    Lanes<T, V> pv[kMaxDc], mv[kMaxDc];
#pragma unroll
    for (int jj = 0; jj < kMaxDc; ++jj) {
      if (jj < dc) {
        const int zz = ldpc::qc::row_plus(z, __ldg(shifts + jj), lift);
        pv[jj] = load_lanes<T, V>(pm + __ldg(blocks + jj) * plane + zz * cols +
                                  col0);
        mv[jj] = load_lanes<T, V>(msg + (off + jj) * plane + own);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      Acc r[kMaxDc];
      unsigned parity = 0u;
#pragma unroll
      for (int jj = 0; jj < kMaxDc; ++jj) {
        if (jj < dc) {
          const Acc p = E::acc(pv[jj].v[k]);
          parity ^= p < 0;
          r[jj] = E::sub(p, E::acc(mv[jj].v[k]));
          if constexpr (!kQuantised) r[jj] = clipf(r[jj], kLlrClip);
        }
      }
      bad += parity;
      Acc out[kMaxDc];
      ldpc::soft::check_update<T, kMethod, kMaxDc>(r, dc, alpha, beta, out);
#pragma unroll
      for (int jj = 0; jj < kMaxDc; ++jj)
        if (jj < dc) mv[jj].v[k] = E::store(out[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kMaxDc; ++jj)
      if (jj < dc) store_lanes<T, V>(msg + (off + jj) * plane + own, mv[jj]);
  }
  // every lane of every warp gets here (one item per thread)
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    bad += __shfl_down_sync(0xFFFFFFFFu, bad, offset);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(unsat, bad);
}

template <typename T, int kMethod, int V, int kMaxDc>
void launch_check(const void* pm, void* msg, const void* chk_block,
                  const void* chk_shift, const void* row_offs,
                  const void* active, void* unsat, int mb, int dcb, int lift,
                  int cols, float alpha, float beta, cudaStream_t stream) {
  const long long items = static_cast<long long>(lift) * (cols / V);
  const dim3 grid(static_cast<unsigned int>(
                      (items + ldpc::kThreads - 1) / ldpc::kThreads),
                  static_cast<unsigned int>(mb));
  qc_soft_check_kernel<T, kMethod, V, kMaxDc>
      <<<grid, ldpc::kThreads, 0, stream>>>(
          static_cast<const T*>(pm), static_cast<T*>(msg),
          static_cast<const int32_t*>(chk_block),
          static_cast<const int32_t*>(chk_shift),
          static_cast<const int32_t*>(row_offs),
          static_cast<const int32_t*>(active), static_cast<int32_t*>(unsat),
          dcb, lift, cols, alpha, beta);
}

template <typename T, int kMethod>
int dispatch(const void* pm, void* msg, const void* chk_block,
             const void* chk_shift, const void* row_offs, const void* active,
             void* unsat, int mb, int dcb, int max_dc, int lift, int cols,
             float alpha, float beta, cudaStream_t s) {
  // int8 takes 8 lanes, not 16: 16 int8 lanes of 8 sockets spill
  constexpr int kWide = sizeof(T) == 1 ? 8 : 16 / sizeof(T);
  constexpr int kNarrow = sizeof(T) == 1 ? 2 : 1;
  if (!ldpc::qc::vector_ok(4, {pm, msg}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool wide = cols % kWide == 0 && max_dc <= 8;
  auto fn = !wide ? launch_check<T, kMethod, kNarrow, kMaxDegree>
                  : (max_dc <= 6 ? launch_check<T, kMethod, kWide, 6>
                                 : launch_check<T, kMethod, kWide, 8>);
  fn(pm, msg, chk_block, chk_shift, row_offs, active, unsat, mb, dcb, lift,
     cols, alpha, beta, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// method: 0 min-sum, 1 sum-product; dtype: 0 float32, 1 bfloat16, 2 int8
// (min-sum only, alpha = 1, beta = 0).  max_dc: the largest real base check
// degree.
extern "C" int ldpc_qc_soft_check(const void* pm, void* msg,
                                  const void* chk_block, const void* chk_shift,
                                  const void* row_offs, const void* active,
                                  void* unsat, int mb, int dcb, int max_dc,
                                  int lift, int cols, int dtype, int method,
                                  float alpha, float beta, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cols % 4 || max_dc < 1 || max_dc > kMaxDegree || max_dc > dcb ||
      mb > ldpc::qc::kMaxPlanes ||
      static_cast<long long>(lift) * cols >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(lift) * cols == 0 || mb == 0) return 0;
  if (dtype == ldpc::soft::kFloat32 && method == kMinSum)
    return dispatch<float, kMinSum>(pm, msg, chk_block, chk_shift, row_offs,
                                    active, unsat, mb, dcb, max_dc, lift, cols,
                                    alpha, beta, s);
  if (dtype == ldpc::soft::kFloat32 && method == kSumProduct)
    return dispatch<float, kSumProduct>(pm, msg, chk_block, chk_shift,
                                        row_offs, active, unsat, mb, dcb,
                                        max_dc, lift, cols, alpha, beta, s);
  if (dtype == ldpc::soft::kBfloat16 && method == kMinSum)
    return dispatch<__nv_bfloat16, kMinSum>(pm, msg, chk_block, chk_shift,
                                            row_offs, active, unsat, mb, dcb,
                                            max_dc, lift, cols, alpha, beta,
                                            s);
  if (dtype == ldpc::soft::kBfloat16 && method == kSumProduct)
    return dispatch<__nv_bfloat16, kSumProduct>(
        pm, msg, chk_block, chk_shift, row_offs, active, unsat, mb, dcb,
        max_dc, lift, cols, alpha, beta, s);
  if (dtype == ldpc::soft::kInt8 && method == kMinSum && alpha == 1.0f &&
      beta == 0.0f)
    return dispatch<int8_t, kMinSum>(pm, msg, chk_block, chk_shift, row_offs,
                                     active, unsat, mb, dcb, max_dc, lift,
                                     cols, alpha, beta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
