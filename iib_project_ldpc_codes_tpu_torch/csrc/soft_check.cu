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
// The float min-sum minimum over the others is taken from the two smallest
// magnitudes (the first index of the smallest gets the second): min is
// exact, so this equals JAX's prefix/suffix minima bit for bit, and the
// signs are the total XOR minus the own bit.  Sum-product keeps JAX's
// prefix/suffix products, since a product's rounding depends on its order.
// int8 runs on packed lanes, four trials a 32-bit word (soft.cuh MinSum8,
// shared with qc_soft_check.cu; soft.cuh states why it is exact).
//
// Bound on the H100: memory.  Per (check, trial): dc pm gathers, dc message
// loads and dc message stores in the working type (5.64 GB a round in
// float32 at n = 8192, (3,6), B = 24,576; 2.82 GB bfloat16; 1.41 GB int8);
// the sum-product's tanhf/atanhf add 2 dc transcendental calls.  The design:
//   * a thread takes one check and V adjacent trials, 16 bytes of a row
//     (V = 4 float32, 8 bfloat16, 16 int8), or 8 or 4 bytes where 16 would
//     cross a code's columns or the planes' alignment, or where dc > 8;
//   * templates over the exact degree 2..8, so the per-socket arrays hold
//     dc entries with no guard (above 8, kMaxDc = 16 or 32 with guards);
//   * column tiles: blockIdx.y is a tile of `tile` columns (whole codes
//     where C > 1), blockIdx.x the tile's (check, vector) items, checks
//     slowest, so every block of a tile runs before the next tile's.  The
//     wrapper sizes the tile so that its slice of pm, n_rows * tile
//     elements, fits a fifth of the L2 cache (ops/soft_bp.py
//     soft_check_geometry; 10 MB on the H100, measured faster than 20 MB
//     or one tile of all columns): the dv gathers of a pm row then hit L2
//     and HBM carries pm about once, as the counted bound assumes.  The
//     message stream moves cache-streaming (evict first), so it does not
//     push the tile out.  Where no tile of a warp's width fits (n ~ 10^6),
//     one tile holds every column.
//   * one check a thread keeps 2 dc loads of 4-16 bytes in flight for each
//     thread, far above what Little's law asks of an SM (~20 KB an SM).
#include "soft.cuh"

namespace {

using ldpc::soft::clipf;
using ldpc::soft::Elem;
using ldpc::soft::kLlrClip;
using ldpc::soft::kMinSum;
using ldpc::soft::kSignBits;
using ldpc::soft::kSumProduct;
using ldpc::soft::Lanes;
using ldpc::soft::load_lanes;
using ldpc::soft::load_lanes_streaming;
using ldpc::soft::MinSum8;
using ldpc::soft::store_lanes_streaming;

constexpr int kMaxDegree = 32;

// The arguments every instantiation takes.
struct Args {
  const void* pm;
  void* msg;
  const int32_t* chk_to_var;
  const int32_t* active;
  int32_t* unsat;
  int rows, table_rows, dc, pad_var, cols, cpc, tile;
  float alpha, beta;
};

// This thread's check c and first column col0 in tile blockIdx.y (V
// columns a thread, the tile's vectors fastest); false past the tile's
// items.  The launcher holds rows * (tile / V) below 2^31.
template <int V>
__device__ __forceinline__ bool locate(const Args& a, int& c, int& col0) {
  const int tile0 = blockIdx.y * a.tile;
  const int nvec = min(a.tile, a.cols - tile0) / V;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.rows * nvec) return false;
  c = i / nvec;
  col0 = tile0 + (i - c * nvec) * V;
  return true;
}

// unsat[code] += the warp's unsatisfied pairs of that code: one atomic per
// code present in the warp.  Every lane of the warp calls it (code -1: no
// item).
__device__ __forceinline__ void add_code_count(int code, int bad,
                                               int32_t* unsat) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, code);
  bad = __reduce_add_sync(peers, bad);
  if (code >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1 &&
      bad)
    atomicAdd(unsat + code, bad);
}

// float32 and bfloat16: V adjacent trials of one check a thread.  kExact:
// dc == kDc; else dc <= kDc, guarded.
template <typename T, int kMethod, int V, int kDc, bool kExact>
__global__ void __launch_bounds__(ldpc::kThreads)
    soft_check_kernel(const Args a) {
  using E = Elem<T>;
  const int dc = kExact ? kDc : a.dc;
  int c, col0, code = -1, bad = 0;
  if (locate<V>(a, c, col0)) {
    code = col0 / a.cpc;
    if (__ldg(a.active + code)) {
      const int32_t* vars =
          a.chk_to_var + (static_cast<long long>(code) * a.table_rows + c) * dc;
      const T* pm = static_cast<const T*>(a.pm);
      T* own = static_cast<T*>(a.msg) + static_cast<long long>(c) * dc * a.cols +
               col0;
      Lanes<T, V> pv[kDc], mv[kDc];
      unsigned padded = 0u;
#pragma unroll
      for (int j = 0; j < kDc; ++j)
        if (j < dc)
          mv[j] = load_lanes_streaming<T, V>(own + static_cast<long long>(j) * a.cols);
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        if (j < dc) {
          const int var = __ldg(vars + j);
          padded |= static_cast<unsigned>(var == a.pad_var) << j;
          pv[j] = load_lanes<T, V>(pm + static_cast<long long>(var) * a.cols + col0);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float r[kDc];
        unsigned parity = 0u;
#pragma unroll
        for (int j = 0; j < kDc; ++j) {
          if (j < dc) {
            const float p = E::acc(pv[j].v[k]);
            parity ^= p < 0;
            r[j] = clipf(E::sub(p, E::acc(mv[j].v[k])), kLlrClip);
          }
        }
        bad += parity;
        float out[kDc];
        ldpc::soft::check_update<kMethod, kDc>(r, dc, a.alpha, a.beta, out);
#pragma unroll
        for (int j = 0; j < kDc; ++j)
          if (j < dc) mv[j].v[k] = E::store((padded >> j) & 1u ? 0.0f : out[j]);
      }
#pragma unroll
      for (int j = 0; j < kDc; ++j)
        if (j < dc)
          store_lanes_streaming<T, V>(own + static_cast<long long>(j) * a.cols, mv[j]);
    }
  }
  add_code_count(code, bad, a.unsat);   // every lane of every warp gets here
}

// int8 (min-sum, alpha 1, beta 0): U words of four trials of one check a
// thread, on packed lanes.  Up to degree 6, registers for three blocks an
// SM (at most 80 a thread; without the bound, 96 at U = 4).
template <int U, int kDc, bool kExact>
__global__ void __launch_bounds__(ldpc::kThreads, kDc <= 6 ? 3 : 1)
    soft_check_kernel_int8(const Args a) {
  using Word = Lanes<uint32_t, U>;
  const int dc = kExact ? kDc : a.dc;
  int c, col0, code = -1, bad = 0;
  if (locate<4 * U>(a, c, col0)) {
    code = col0 / a.cpc;
    if (__ldg(a.active + code)) {
      const int32_t* vars =
          a.chk_to_var + (static_cast<long long>(code) * a.table_rows + c) * dc;
      const int8_t* pm = static_cast<const int8_t*>(a.pm);
      int8_t* own = static_cast<int8_t*>(a.msg) +
                    static_cast<long long>(c) * dc * a.cols + col0;
      Word pv[kDc], mv[kDc];
      unsigned padded = 0u;
#pragma unroll
      for (int j = 0; j < kDc; ++j)
        if (j < dc)
          mv[j] = load_lanes_streaming<uint32_t, U>(reinterpret_cast<const uint32_t*>(
              own + static_cast<long long>(j) * a.cols));
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        if (j < dc) {
          const int var = __ldg(vars + j);
          padded |= static_cast<unsigned>(var == a.pad_var) << j;
          pv[j] = load_lanes<uint32_t, U>(reinterpret_cast<const uint32_t*>(
              pm + static_cast<long long>(var) * a.cols + col0));
        }
      }
      MinSum8 acc[U];
      uint32_t parity[U] = {};
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        if (j < dc) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            mv[j].v[u] = acc[u].add(pv[j].v[u], mv[j].v[u]);   // now r'
            parity[u] ^= pv[j].v[u];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) bad += __popc(parity[u] & kSignBits);
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        if (j < dc) {
          Word o;
#pragma unroll
          for (int u = 0; u < U; ++u)
            o.v[u] = (padded >> j) & 1u ? 0u : acc[u].out(mv[j].v[u]);
          store_lanes_streaming<uint32_t, U>(
              reinterpret_cast<uint32_t*>(own + static_cast<long long>(j) * a.cols), o);
        }
      }
    }
  }
  add_code_count(code, bad, a.unsat);   // every lane of every warp gets here
}

template <typename T, int kMethod, int V, int kDc, bool kExact>
void launch(const Args& a, cudaStream_t stream) {
  const long long items = static_cast<long long>(a.rows) * (a.tile / V);
  const dim3 grid(static_cast<unsigned int>(
                      (items + ldpc::kThreads - 1) / ldpc::kThreads),
                  static_cast<unsigned int>((a.cols + a.tile - 1) / a.tile));
  if constexpr (sizeof(T) == 1)
    soft_check_kernel_int8<V / 4, kDc, kExact>
        <<<grid, ldpc::kThreads, 0, stream>>>(a);
  else
    soft_check_kernel<T, kMethod, V, kDc, kExact>
        <<<grid, ldpc::kThreads, 0, stream>>>(a);
}

// The exact-degree instantiations, 2 <= dc <= 8.
template <typename T, int kMethod, int V>
int by_degree(const Args& a, cudaStream_t s) {
  switch (a.dc) {
    case 2: launch<T, kMethod, V, 2, true>(a, s); break;
    case 3: launch<T, kMethod, V, 3, true>(a, s); break;
    case 4: launch<T, kMethod, V, 4, true>(a, s); break;
    case 5: launch<T, kMethod, V, 5, true>(a, s); break;
    case 6: launch<T, kMethod, V, 6, true>(a, s); break;
    case 7: launch<T, kMethod, V, 7, true>(a, s); break;
    case 8: launch<T, kMethod, V, 8, true>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// vec: the trials a thread, 16, 8 or 4 bytes of them; 4 bytes above degree
// 8 (and at degree 1), where kMaxDc = 16 or 32 bounds the arrays.
template <typename T, int kMethod>
int dispatch(const Args& a, int vec, cudaStream_t s) {
  constexpr int k16 = 16 / sizeof(T), k8 = 8 / sizeof(T), k4 = 4 / sizeof(T);
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const int bytes = vec * static_cast<int>(sizeof(T));
  if (a.cpc % vec || a.tile % vec || (addr(a.pm) | addr(a.msg)) % bytes)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int rc;
  if (a.dc < 2 || a.dc > 8) {
    if (vec != k4 || a.dc > kMaxDegree) return static_cast<int>(cudaErrorInvalidValue);
    if (a.dc <= 16)
      launch<T, kMethod, k4, 16, false>(a, s);
    else
      launch<T, kMethod, k4, kMaxDegree, false>(a, s);
    rc = 0;
  } else if (vec == k16) {
    rc = by_degree<T, kMethod, k16>(a, s);
  } else if (vec == k8) {
    rc = by_degree<T, kMethod, k8>(a, s);
  } else if (vec == k4) {
    rc = by_degree<T, kMethod, k4>(a, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace

// method: 0 min-sum, 1 sum-product; dtype: 0 float32, 1 bfloat16, 2 int8
// (min-sum only, alpha = 1, beta = 0).  pad_var < 0: no padded sockets.
// vec: trials a thread (4, 8 or 16 bytes of them, dividing cpc and tile,
// the planes aligned to them); tile: columns a tile (the launch order).
extern "C" int ldpc_soft_check(const void* pm, void* msg,
                               const void* chk_to_var, const void* active,
                               void* unsat, int rows, int table_rows, int dc,
                               int pad_var, int cols, int cpc, int vec,
                               int tile, int dtype, int method, float alpha,
                               float beta, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || cols == 0) return 0;
  if (cols % 4 || cpc % 4 || dc < 1 || vec < 1 || tile < vec ||
      static_cast<long long>(rows) * (tile / vec) >= (1LL << 31) ||
      (cols + tile - 1) / tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{pm, msg, static_cast<const int32_t*>(chk_to_var),
               static_cast<const int32_t*>(active), static_cast<int32_t*>(unsat),
               rows, table_rows, dc, pad_var, cols, cpc, tile, alpha, beta};
  if (dtype == ldpc::soft::kFloat32 && method == kMinSum)
    return dispatch<float, kMinSum>(a, vec, s);
  if (dtype == ldpc::soft::kFloat32 && method == kSumProduct)
    return dispatch<float, kSumProduct>(a, vec, s);
  if (dtype == ldpc::soft::kBfloat16 && method == kMinSum)
    return dispatch<__nv_bfloat16, kMinSum>(a, vec, s);
  if (dtype == ldpc::soft::kBfloat16 && method == kSumProduct)
    return dispatch<__nv_bfloat16, kSumProduct>(a, vec, s);
  if (dtype == ldpc::soft::kInt8 && method == kMinSum && alpha == 1.0f &&
      beta == 0.0f)
    return dispatch<int8_t, kMinSum>(a, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
