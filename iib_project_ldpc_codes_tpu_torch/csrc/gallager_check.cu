// Gallager-A/B check pass: the parity of each check's incoming messages.
//
// Replaces the check half of iib_project_ldpc_codes_tpu/ops/gallager.py
// _gallager_iteration (:127-136) and of gallager_decode_packed_irregular
// (:356-365).  JAX forms each socket's extrinsic message by a prefix and a
// suffix XOR over the dc socket planes; here
//   parity[c, w] = XOR_{j < dc} msg[c*dc + j, w]
// and the variable pass takes socket j's extrinsic message as
// parity[c] ^ msg[c*dc + j]: the same bits, one word a check instead of dc.
//
// Messages are int32[rows*dc, W], one row per flat check-socket position
// (c*dc + j, the position var_to_edge / var_to_sock name), so a check's dc
// rows are adjacent and no table is read: the pass is the same for one code
// and for a batch of codes.  Padded sockets of an irregular code hold 0, so
// no mask is needed.
//
// Bound on the H100: memory, dc loads and one store per (check, word)
// (107 MB a round at n = 1e4, (3,6), W = 768: 0.032 ms).  The design:
//   * one thread a (check, vector of V words), V = 4, 2 or 1 (16, 8 or 4
//     bytes; ops/gallager.py gallager_round_vector picks the widest that
//     W and the planes' alignment allow), vectors fastest, so a warp moves
//     a contiguous 128-512-byte piece of each of the check's rows;
//   * a template over the exact degree 6 (the (3,6) codes and the
//     irregular pairs' dc_max): the dc loads unroll and are all in flight
//     before the first XOR; any other degree runs the same loop by run time.
#include "gallager.cuh"

namespace {

using ldpc::load_ro;
using ldpc::Words;

template <int V, int kDc>  // kDc 0: any degree, read at run time
__global__ void __launch_bounds__(ldpc::kThreads)
gallager_check_kernel(const int32_t* __restrict__ msg,
                      int32_t* __restrict__ parity, int rows, int dc,
                      int words) {
  const int vecs = words / V;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(rows) * vecs) return;
  const long long c = t / vecs;
  const int w = static_cast<int>(t - c * vecs) * V;
  const int degree = kDc > 0 ? kDc : dc;
  const int32_t* row = msg + c * degree * words + w;
  Words<V> acc = {};
  if constexpr (kDc > 0) {
    Words<V> x[kDc];
#pragma unroll
    for (int j = 0; j < kDc; ++j)
      x[j] = load_ro<V>(row + static_cast<long long>(j) * words);
#pragma unroll
    for (int j = 0; j < kDc; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc.w[i] ^= x[j].w[i];
  } else {
#pragma unroll 4
    for (int j = 0; j < degree; ++j) {
      const Words<V> x = load_ro<V>(row + static_cast<long long>(j) * words);
#pragma unroll
      for (int i = 0; i < V; ++i) acc.w[i] ^= x.w[i];
    }
  }
  ldpc::store<V>(parity + c * words + w, acc);
}

template <int V>
void launch_check(const int32_t* msg, int32_t* parity, int rows, int dc,
                  int words, cudaStream_t s) {
  const long long items = static_cast<long long>(rows) * (words / V);
  const auto blocks = static_cast<unsigned int>(
      (items + ldpc::kThreads - 1) / ldpc::kThreads);
  auto kernel = dc == 6 ? gallager_check_kernel<V, 6>
                        : gallager_check_kernel<V, 0>;
  kernel<<<blocks, ldpc::kThreads, 0, s>>>(msg, parity, rows, dc, words);
}

}  // namespace

// vec: the words a thread moves, 4, 2 or 1, dividing words; msg and parity
// aligned to 4 * vec bytes.
extern "C" int ldpc_gallager_check(const void* msg, void* parity, int rows,
                                   int dc, int words, int vec, void* stream) {
  if ((vec != 4 && vec != 2 && vec != 1) || words % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(rows) * words > 0) {
    const auto m = static_cast<const int32_t*>(msg);
    const auto p = static_cast<int32_t*>(parity);
    const auto s = static_cast<cudaStream_t>(stream);
    if (vec == 4) {
      launch_check<4>(m, p, rows, dc, words, s);
    } else if (vec == 2) {
      launch_check<2>(m, p, rows, dc, words, s);
    } else {
      launch_check<1>(m, p, rows, dc, words, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
