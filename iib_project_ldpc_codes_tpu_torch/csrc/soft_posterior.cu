// Kernel B: the soft decoder's variable pass (posterior, error counts).
//
// Replaces iib_project_ldpc_codes_tpu/ops/soft_bp.py:166-171 (_posterior),
// the cast of soft_bp.py:196-199 and the error counts of soft_bp.py:281-299
// (and, in its final form, :308-317).  For variable v and trial b:
//   post = llr0[v, b] + msg[s_0, b] + ... + msg[s_{dv-1}, b]
// in JAX's order (channel first, then the sockets p = 0 .. dv-1 of
// var_to_sock / var_to_edge, each addition rounded on its own), in float32
// for float32 and bfloat16 messages and in integers (JAX: int16) for int8.
// It writes the working-type plane pm = post (float32), bf16(post), or
// int8(clip(post, -127, 127)), which the check pass gathers, and adds the
// per-trial count of post < 0 into counts[b] with integer atomics (exact in
// any order, so the counts are deterministic).  Padded sockets of an
// irregular code (s >= pad_pos) are skipped: their stored message is 0, and
// adding 0 changes no value.  A batch of codes skips the trials of a code
// whose active flag is 0, so a stopped code's pm plane stays as it was.
//
// The final launch (post != nullptr) also writes the float32 posterior of
// the first n_out rows, de-quantised by 1 / scale for int8
// (soft_bp.py:315-317), and the decision post < 0 as a bool plane.
//
// Random-codeword transmit (soft_bp.py:275-285): given the packed codeword
// plane tx int32[n_rows, cols / 32] (trial b in bit b % 32 of word b / 32),
// the counts and the bool plane hold the errors (post < 0) ^ tx; pm and the
// posterior are unchanged.  Without it (tx == nullptr) an instantiation
// with the constant tx = 0 runs, the all-zero codeword's arithmetic.
//
// Bound on the H100: memory.  Per (variable, trial): the channel LLR
// (4 bytes, 1 for int8), dv messages and one pm store in the working type;
// at n = 8192, (3,6), B = 24,576 that is 4.03 GB a round in float32, 2.42 GB
// in bfloat16, 1.01 GB in int8.  One thread takes a run of kVarsPerThread
// variables at 4 bytes of columns, columns fastest, so each load and store
// of a warp is a contiguous 128-byte row segment; in ensemble mode a warp's
// columns belong to one or a few codes, so its table entries are broadcast.
#include "soft.cuh"

namespace {

using ldpc::soft::Elem;
using ldpc::soft::Lanes;
using ldpc::soft::load_lanes;
using ldpc::soft::store_lanes;

constexpr int kVarsPerThread = 32;

template <typename T, typename L, bool kTx>
__global__ void soft_posterior_kernel(
    const L* __restrict__ llr0, const T* __restrict__ msg,
    const int32_t* __restrict__ var_to_sock, const int32_t* __restrict__ active,
    T* __restrict__ pm, int32_t* __restrict__ counts, float* __restrict__ post,
    bool* __restrict__ hard, const int32_t* __restrict__ tx, int n_rows,
    int n_out, int table_rows, int dv, int pad_pos, int cols, int cpc,
    float scale) {
  constexpr int K = 4 / sizeof(T);
  using E = Elem<T>;
  using Acc = typename E::Acc;
  const int nvec = cols / K;
  const long long groups = (n_rows + kVarsPerThread - 1) / kVarsPerThread;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= groups * nvec) return;
  const int group = static_cast<int>(t / nvec);
  const int col0 = static_cast<int>(t - static_cast<long long>(group) * nvec) * K;
  const int code = col0 / cpc;
  if (!__ldg(active + code)) return;
  int cnt[K] = {};
  const int v_end = min(n_rows, (group + 1) * kVarsPerThread);
  for (int v = group * kVarsPerThread; v < v_end; ++v) {
    const int32_t* socks =
        var_to_sock + (static_cast<long long>(code) * table_rows + v) * dv;
    const long long row = static_cast<long long>(v) * cols + col0;
    const Lanes<L, K> l = load_lanes<L, K>(llr0 + row);
    Acc acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = static_cast<Acc>(l.v[k]);
    for (int p = 0; p < dv; ++p) {
      const int s = __ldg(socks + p);
      if (s >= pad_pos) continue;
      const Lanes<T, K> m =
          load_lanes<T, K>(msg + static_cast<long long>(s) * cols + col0);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = E::add(acc[k], E::acc(m.v[k]));
    }
    uint32_t tb = 0u;
    if (kTx) {
      tb = static_cast<uint32_t>(__ldg(
               tx + static_cast<long long>(v) * (cols / 32) + col0 / 32)) >>
           (col0 & 31);
    }
    Lanes<T, K> out;
    bool err[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      out.v[k] = E::store(acc[k]);
      err[k] = (acc[k] < 0) != (kTx && ((tb >> k) & 1u));
      cnt[k] += err[k];
    }
    store_lanes<T, K>(pm + row, out);
    if (post != nullptr && v < n_out) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float f = static_cast<float>(acc[k]);
        post[row + k] = sizeof(T) == 1 ? __fdiv_rn(f, scale) : f;
        hard[row + k] = err[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (cnt[k]) atomicAdd(counts + col0 + k, cnt[k]);
}

template <typename T, typename L, bool kTx>
void launch_posterior(const void* llr0, const void* msg, const void* var_to_sock,
                      const void* active, void* pm, void* counts, void* post,
                      void* hard, const void* tx, int n_rows, int n_out,
                      int table_rows, int dv, int pad_pos, int cols, int cpc,
                      float scale, cudaStream_t stream) {
  constexpr int K = 4 / sizeof(T);
  const long long items =
      static_cast<long long>((n_rows + kVarsPerThread - 1) / kVarsPerThread) *
      (cols / K);
  if (items <= 0) return;
  const long long blocks = (items + ldpc::kThreads - 1) / ldpc::kThreads;
  soft_posterior_kernel<T, L, kTx><<<static_cast<unsigned int>(blocks),
                                     ldpc::kThreads, 0, stream>>>(
      static_cast<const L*>(llr0), static_cast<const T*>(msg),
      static_cast<const int32_t*>(var_to_sock),
      static_cast<const int32_t*>(active), static_cast<T*>(pm),
      static_cast<int32_t*>(counts), static_cast<float*>(post),
      static_cast<bool*>(hard), static_cast<const int32_t*>(tx), n_rows,
      n_out, table_rows, dv, pad_pos, cols, cpc, scale);
}

template <typename T, typename L>
void dispatch_tx(const void* llr0, const void* msg, const void* var_to_sock,
                 const void* active, void* pm, void* counts, void* post,
                 void* hard, const void* tx, int n_rows, int n_out,
                 int table_rows, int dv, int pad_pos, int cols, int cpc,
                 float scale, cudaStream_t stream) {
  if (tx == nullptr) {
    launch_posterior<T, L, false>(llr0, msg, var_to_sock, active, pm, counts,
                                  post, hard, tx, n_rows, n_out, table_rows,
                                  dv, pad_pos, cols, cpc, scale, stream);
  } else {
    launch_posterior<T, L, true>(llr0, msg, var_to_sock, active, pm, counts,
                                 post, hard, tx, n_rows, n_out, table_rows,
                                 dv, pad_pos, cols, cpc, scale, stream);
  }
}

}  // namespace

extern "C" int ldpc_soft_posterior(const void* llr0, const void* msg,
                                   const void* var_to_sock, const void* active,
                                   void* pm, void* counts, void* post,
                                   void* hard, const void* tx, int n_rows,
                                   int n_out, int table_rows, int dv,
                                   int pad_pos, int cols, int cpc, int dtype,
                                   float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cols % 4 || cpc % 4 || (post == nullptr) != (hard == nullptr) ||
      (tx != nullptr && cols % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case ldpc::soft::kFloat32:
      dispatch_tx<float, float>(llr0, msg, var_to_sock, active, pm, counts,
                                post, hard, tx, n_rows, n_out, table_rows, dv,
                                pad_pos, cols, cpc, scale, s);
      break;
    case ldpc::soft::kBfloat16:
      dispatch_tx<__nv_bfloat16, float>(llr0, msg, var_to_sock, active, pm,
                                        counts, post, hard, tx, n_rows, n_out,
                                        table_rows, dv, pad_pos, cols, cpc,
                                        scale, s);
      break;
    case ldpc::soft::kInt8:
      dispatch_tx<int8_t, int8_t>(llr0, msg, var_to_sock, active, pm, counts,
                                  post, hard, tx, n_rows, n_out, table_rows,
                                  dv, pad_pos, cols, cpc, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
