// S2: the check pass of soft BP on a quasi-cyclic code (syndrome and new
// messages).
//
// Replaces the check side of iib_project_ldpc_codes_tpu/ops/qc_soft_bp.py
// _qc_soft_iteration (:72-104), with _check_update_minsum (int8: mag_cap =
// 127) or _check_update_sumproduct of ops/soft_bp.py (:97-158).  Messages
// are check-resident, [E_b * Z, B] in the working type T as in JAX: plane
// off[c] + jj holds socket jj of base check c, row z of it lifted check
// (c, z), so an irregular base has no padded rows.  For base check c
// (blockIdx.y), lifted row z and trial b, over the dc_c real sockets jj of c
// (variable block chk_block[c, jj], shift chk_shift[c, jj], compacted to the
// left; dc_c = off[c+1] - off[c]):
//   p_jj = pm[chk_block[c, jj]*Z + (z + s_jj) mod Z, b]     (qc::row_plus)
//   syndrome: XOR_jj [p_jj < 0]; the unsatisfied (check, trial) pairs are
//             added into unsat[0];
//   r_jj  = p_jj - msg[(off[c] + jj)*Z + z, b] in the accumulation type,
//           clipped to +-30 for float messages;
//   msg[(off[c] + jj)*Z + z, b] = the check update of the r's, in place.
// JAX rolls every pm plane by -s into the check frame; here (z + s) mod Z is
// one conditional subtract in the load address and no rolled copy exists.
// A thread reads its own dc_c messages before it writes them and no other
// thread touches them, so the update is in place.  Nothing runs when
// active[0] is 0.
//
// Bound on the H100: memory.  Counted with each input read once and each
// output written once, a pass moves n*B bytes of pm and 2*E*B of messages in
// the working type: 10.75 GB in int8 on the nb = 12 (3,6) base at Z =
// 83,334, B = 1,536, 3.21 ms at 3.35 TB/s.  This design reads pm once per
// check socket, dvb times in all, so it really moves 3*E*B bytes: 13.8 GB,
// 4.1 ms (2.21 GB, 0.66 ms at Z = 834, B = 24,576).  A grid row per base
// check keeps its tables uniform loads; in-plane indices are 32-bit.
//
// int8 (min-sum saturated at 127, the engine's path) runs on packed lanes,
// four trials a 32-bit word, never one byte at a time, with the update of
// soft.cuh's MinSum8 (shared with soft_check.cu), exact against JAX's.  A
// thread takes 4 words (16 bytes, 16 trials) of a row where B % 16 == 0 and
// every degree is at most 8, else one word, for degrees up to 32; the dc r'
// words stay in registers, so nothing is reread and nothing spills
// (-Xptxas -v).  The block sums its unsatisfied pairs (warp shuffles, then
// shared memory) into one atomicAdd.
//
// float32 and bfloat16 (min-sum with alpha and beta, sum-product): V
// adjacent trials a thread, 16-byte accesses, for checks of degree up to 8
// (above, one trial a thread), the update of soft.cuh::check_update that
// soft_check.cu uses, one atomic a warp for the syndrome.
#include "qc.cuh"
#include "soft.cuh"

namespace {

using ldpc::qc::Words;
using ldpc::soft::clipf;
using ldpc::soft::Elem;
using ldpc::soft::kLlrClip;
using ldpc::soft::kMinSum;
using ldpc::soft::kSignBits;
using ldpc::soft::kSumProduct;
using ldpc::soft::Lanes;
using ldpc::soft::load_lanes;
using ldpc::soft::MinSum8;
using ldpc::soft::store_lanes;

constexpr int kMaxDegree = 32;

// ---------------------------------------------------------------------------
// float32 and bfloat16
// ---------------------------------------------------------------------------

template <typename T, int kMethod, int V, int kMaxDc>
__global__ void qc_soft_check_kernel(
    const T* __restrict__ pm, T* __restrict__ msg,
    const int32_t* __restrict__ chk_block,
    const int32_t* __restrict__ chk_shift,
    const int32_t* __restrict__ row_offs, const int32_t* __restrict__ active,
    int32_t* __restrict__ unsat, int dcb, int lift, int cols, float alpha,
    float beta) {
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
          r[jj] = clipf(E::sub(p, E::acc(mv[jj].v[k])), kLlrClip);
        }
      }
      bad += parity;
      Acc out[kMaxDc];
      ldpc::soft::check_update<kMethod, kMaxDc>(r, dc, alpha, beta, out);
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
  constexpr int kWide = 16 / sizeof(T);
  if (!ldpc::qc::vector_ok(4, {pm, msg}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool wide = cols % kWide == 0 && max_dc <= 8;
  auto fn = !wide ? launch_check<T, kMethod, 1, kMaxDegree>
                  : (max_dc <= 6 ? launch_check<T, kMethod, kWide, 6>
                                 : launch_check<T, kMethod, kWide, 8>);
  fn(pm, msg, chk_block, chk_shift, row_offs, active, unsat, mb, dcb, lift,
     cols, alpha, beta, s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// int8: four trials a 32-bit word
// ---------------------------------------------------------------------------

// The unsatisfied pairs of the block into unsat[0]: warp shuffles, one
// shared-memory slot a warp, one atomic.  Every thread of the block calls it.
__device__ __forceinline__ void add_block_count(int v, int32_t* unsat) {
  __shared__ int per_warp[ldpc::kThreads / 32];
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xFFFFFFFFu, v, offset);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) per_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < ldpc::kThreads / 32 ? per_warp[lane] : 0;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, offset);
    if (lane == 0 && v) atomicAdd(unsat, v);
  }
}

// U words (4 * U trials) of one lifted row a thread; kMaxDc bounds the base
// check degree, so the dc * U extrinsic words are registers.
template <int U, int kMaxDc>
__global__ void __launch_bounds__(ldpc::kThreads) qc_soft_check_kernel_int8(
    const int32_t* __restrict__ pm, int32_t* __restrict__ msg,
    const int32_t* __restrict__ chk_block,
    const int32_t* __restrict__ chk_shift,
    const int32_t* __restrict__ row_offs, const int32_t* __restrict__ active,
    int32_t* __restrict__ unsat, int dcb, int lift, int words) {
  if (!__ldg(active)) return;               // one code: uniform over the grid
  const int c = blockIdx.y;
  const int off = __ldg(row_offs + c);
  const int dc = __ldg(row_offs + c + 1) - off;
  const int groups = words / U;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int bad = 0;
  if (i < lift * groups) {
    const int z = i / groups;
    const int w0 = (i - z * groups) * U;
    const long long plane = static_cast<long long>(lift) * words;
    const int own = z * words + w0;
    const int32_t* blocks = chk_block + c * dcb;
    const int32_t* shifts = chk_shift + c * dcb;
    uint32_t r[kMaxDc][U];
    MinSum8 acc[U];
    uint32_t parity[U] = {};
#pragma unroll
    for (int jj = 0; jj < kMaxDc; ++jj) {
      if (jj < dc) {
        const int zz = ldpc::qc::row_plus(z, __ldg(shifts + jj), lift);
        const Words<U> p = ldpc::qc::load<U>(pm + __ldg(blocks + jj) * plane +
                                             zz * words + w0);
        const Words<U> m = ldpc::qc::load<U>(msg + (off + jj) * plane + own);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          r[jj][u] = acc[u].add(p.v[u], m.v[u]);
          parity[u] ^= p.v[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) bad += __popc(parity[u] & kSignBits);
#pragma unroll
    for (int jj = 0; jj < kMaxDc; ++jj) {
      if (jj < dc) {
        Words<U> o;
#pragma unroll
        for (int u = 0; u < U; ++u) o.v[u] = acc[u].out(r[jj][u]);
        ldpc::qc::store<U>(msg + (off + jj) * plane + own, o);
      }
    }
  }
  add_block_count(bad, unsat);
}

template <int U, int kMaxDc>
void launch_int8(const void* pm, void* msg, const void* chk_block,
                 const void* chk_shift, const void* row_offs,
                 const void* active, void* unsat, int mb, int dcb, int lift,
                 int words, cudaStream_t stream) {
  const long long items = static_cast<long long>(lift) * (words / U);
  const dim3 grid(static_cast<unsigned int>(
                      (items + ldpc::kThreads - 1) / ldpc::kThreads),
                  static_cast<unsigned int>(mb));
  qc_soft_check_kernel_int8<U, kMaxDc><<<grid, ldpc::kThreads, 0, stream>>>(
      static_cast<const int32_t*>(pm), static_cast<int32_t*>(msg),
      static_cast<const int32_t*>(chk_block),
      static_cast<const int32_t*>(chk_shift),
      static_cast<const int32_t*>(row_offs),
      static_cast<const int32_t*>(active), static_cast<int32_t*>(unsat), dcb,
      lift, words);
}

int dispatch_int8(const void* pm, void* msg, const void* chk_block,
                  const void* chk_shift, const void* row_offs,
                  const void* active, void* unsat, int mb, int dcb,
                  int max_dc, int lift, int cols, cudaStream_t s) {
  if (!ldpc::qc::vector_ok(4, {pm, msg}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int words = cols / 4;
  const bool wide = words % 4 == 0 && max_dc <= 8;
  auto fn = !wide ? launch_int8<1, kMaxDegree>
                  : (max_dc <= 6 ? launch_int8<4, 6> : launch_int8<4, 8>);
  fn(pm, msg, chk_block, chk_shift, row_offs, active, unsat, mb, dcb, lift,
     words, s);
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
    return dispatch_int8(pm, msg, chk_block, chk_shift, row_offs, active,
                         unsat, mb, dcb, max_dc, lift, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
