// S1: the variable pass of soft BP on a quasi-cyclic code (posterior, error
// counts).
//
// Replaces iib_project_ldpc_codes_tpu/ops/qc_soft_bp.py _qc_posterior
// (:61-69), the variable side of _qc_soft_iteration (:77-81) and the error
// counts of _qc_soft_core (:151-167).  Messages are check-resident, [E_b * Z,
// B] in the working type T: one [Z, B] plane per REAL base socket, check-
// major (qc_soft_check.cu).  For lifted variable (j, z) and trial b, over
// block j's sockets p (message plane var_row[j, p], shift var_shift[j, p];
// padded per block with -1):
//   post = llr0[j*Z + z, b] + msg[var_row[j, p]*Z + (z - s_p) mod Z, b] + ...
// in JAX's order (the channel first, then the sockets in flat-row order,
// each addition rounded on its own), in float32 for float32 and bfloat16
// messages and in integers (JAX: int16) for int8.  JAX rolls every message
// plane by +s into the variable frame; here (z - s) mod Z is one conditional
// add in the load address (qc::row_minus) and no rolled copy exists.  It
// writes the working-type plane pm = post, bf16(post) (nearest even) or
// int8(clip(post, -127, 127)), which the check pass gathers, and counts
// post < 0: into counts[b] per trial (per_trial != 0; one atomic per trial
// and thread) or into counts[0] for the whole batch (one atomic per warp).
// Integer atomics are exact in any order.  Nothing runs when active[0] is 0.
// The final launch (post != nullptr) also writes the float32 posterior,
// divided by `scale` for int8 (qc_soft_bp.py:169-170), and the decisions
// post < 0 as a bool plane.
//
// Bound on the H100: memory.  Per (variable, trial): the channel LLR (4
// bytes, 1 for int8), dvb messages and one pm store in the working type; the
// nb = 12 (3,6) base at Z = 834, B = 24,576 moves 1.23 GB a round in int8.
// Design (the lesson of qc.cuh: index arithmetic, not bytes, was the cost of
// the first circulant-index kernels): blockIdx.y is the variable block, so
// its socket tables are uniform loads; every index inside a plane is 32-bit
// (the wrapper holds n * B below 2^31); a thread takes V = 16 / sizeof(T)
// adjacent trials (16-byte accesses of messages and pm, a warp moving 512
// contiguous bytes of a row) for kRows consecutive rows, one 32-bit division
// per thread.  When B is not a multiple of 16 / sizeof(T), V = 4 /
// sizeof(T).  Every plane pointer must be 16-byte aligned (PyTorch's
// allocations are).
#include "qc.cuh"
#include "soft.cuh"

namespace {

using ldpc::soft::Elem;
using ldpc::soft::Lanes;
using ldpc::soft::load_lanes;
using ldpc::soft::store_lanes;

constexpr int kRows = 8;   // lifted rows a thread walks, in the same columns

template <typename T, typename L, int V, bool kPerTrial>
__global__ void qc_soft_posterior_kernel(
    const L* __restrict__ llr0, const T* __restrict__ msg,
    const int32_t* __restrict__ var_row, const int32_t* __restrict__ var_shift,
    const int32_t* __restrict__ active, T* __restrict__ pm,
    int32_t* __restrict__ counts, float* __restrict__ post,
    bool* __restrict__ hard, int dvb, int lift, int cols, float scale) {
  using E = Elem<T>;
  using Acc = typename E::Acc;
  if (!__ldg(active)) return;               // one code: uniform over the grid
  const int j = blockIdx.y;
  const int groups = cols / V;
  const int items = ((lift + kRows - 1) / kRows) * groups;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int total = 0;
  if (i < items) {
    const int zg = i / groups;
    const int col0 = (i - zg * groups) * V;
    const int32_t* rows = var_row + j * dvb;
    const int32_t* shifts = var_shift + j * dvb;
    const long long plane = static_cast<long long>(lift) * cols;
    const long long own = j * plane;
    int cnt[V] = {};
    const int z_end = min(lift, (zg + 1) * kRows);
    for (int z = zg * kRows; z < z_end; ++z) {
      const int at = z * cols + col0;
      const Lanes<L, V> l = load_lanes<L, V>(llr0 + own + at);
      Acc acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = static_cast<Acc>(l.v[k]);
      for (int p = 0; p < dvb; ++p) {
        const int row = __ldg(rows + p);
        if (row < 0) continue;               // padded socket of the block
        const int zz = ldpc::qc::row_minus(z, __ldg(shifts + p), lift);
        const Lanes<T, V> m =
            load_lanes<T, V>(msg + row * plane + zz * cols + col0);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = E::add(acc[k], E::acc(m.v[k]));
      }
      Lanes<T, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        out.v[k] = E::store(acc[k]);
        if (kPerTrial) {
          cnt[k] += acc[k] < 0;
        } else {
          total += acc[k] < 0;
        }
      }
      store_lanes<T, V>(pm + own + at, out);
      if (post != nullptr) {
        Lanes<float, V> value;
        Lanes<bool, V> decision;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = static_cast<float>(acc[k]);
          value.v[k] = sizeof(T) == 1 ? __fdiv_rn(f, scale) : f;
          decision.v[k] = acc[k] < 0;
        }
        store_lanes<float, V>(post + own + at, value);
        store_lanes<bool, V>(hard + own + at, decision);
      }
    }
    if (kPerTrial) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (cnt[k]) atomicAdd(counts + col0 + k, cnt[k]);
    }
  }
  if (!kPerTrial) {
    // every lane of every warp gets here (one item per thread)
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      total += __shfl_down_sync(0xFFFFFFFFu, total, offset);
    if ((threadIdx.x & 31) == 0 && total) atomicAdd(counts, total);
  }
}

template <typename T, typename L, int V>
void launch_posterior(const void* llr0, const void* msg, const void* var_row,
                      const void* var_shift, const void* active, void* pm,
                      void* counts, void* post, void* hard, int nb, int dvb,
                      int lift, int cols, int per_trial, float scale,
                      cudaStream_t stream) {
  const long long items =
      static_cast<long long>((lift + kRows - 1) / kRows) * (cols / V);
  const dim3 grid(static_cast<unsigned int>(
                      (items + ldpc::kThreads - 1) / ldpc::kThreads),
                  static_cast<unsigned int>(nb));
  auto kernel = per_trial ? qc_soft_posterior_kernel<T, L, V, true>
                          : qc_soft_posterior_kernel<T, L, V, false>;
  kernel<<<grid, ldpc::kThreads, 0, stream>>>(
      static_cast<const L*>(llr0), static_cast<const T*>(msg),
      static_cast<const int32_t*>(var_row),
      static_cast<const int32_t*>(var_shift),
      static_cast<const int32_t*>(active), static_cast<T*>(pm),
      static_cast<int32_t*>(counts), static_cast<float*>(post),
      static_cast<bool*>(hard), dvb, lift, cols, scale);
}

template <typename T, typename L>
int dispatch(const void* llr0, const void* msg, const void* var_row,
             const void* var_shift, const void* active, void* pm, void* counts,
             void* post, void* hard, int nb, int dvb, int lift, int cols,
             int per_trial, float scale, cudaStream_t s) {
  constexpr int kWide = 16 / sizeof(T), kNarrow = 4 / sizeof(T);
  if (!ldpc::qc::vector_ok(4, {llr0, msg, pm, post, hard}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto fn = cols % kWide == 0 ? launch_posterior<T, L, kWide>
                              : launch_posterior<T, L, kNarrow>;
  fn(llr0, msg, var_row, var_shift, active, pm, counts, post, hard, nb, dvb,
     lift, cols, per_trial, scale, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32 (llr0 float32), 1 bfloat16 (llr0 float32), 2 int8 (llr0
// int8).  counts: int32[cols] with per_trial != 0, else int32[1].  post and
// hard: both or neither.
extern "C" int ldpc_qc_soft_posterior(const void* llr0, const void* msg,
                                      const void* var_row,
                                      const void* var_shift,
                                      const void* active, void* pm,
                                      void* counts, void* post, void* hard,
                                      int nb, int dvb, int lift, int cols,
                                      int per_trial, int dtype, float scale,
                                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cols % 4 || (post == nullptr) != (hard == nullptr) ||
      nb > ldpc::qc::kMaxPlanes ||
      static_cast<long long>(nb) * lift * cols >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(lift) * cols == 0 || nb == 0) return 0;
  switch (dtype) {
    case ldpc::soft::kFloat32:
      return dispatch<float, float>(llr0, msg, var_row, var_shift, active, pm,
                                    counts, post, hard, nb, dvb, lift, cols,
                                    per_trial, scale, s);
    case ldpc::soft::kBfloat16:
      return dispatch<__nv_bfloat16, float>(llr0, msg, var_row, var_shift,
                                            active, pm, counts, post, hard, nb,
                                            dvb, lift, cols, per_trial, scale,
                                            s);
    case ldpc::soft::kInt8:
      return dispatch<int8_t, int8_t>(llr0, msg, var_row, var_shift, active,
                                      pm, counts, post, hard, nb, dvb, lift,
                                      cols, per_trial, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
