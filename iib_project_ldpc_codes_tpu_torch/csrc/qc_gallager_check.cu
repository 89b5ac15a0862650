// Q3: Gallager-A/B check pass on a quasi-cyclic code.
//
// Replaces the check half of iib_project_ldpc_codes_tpu/ops/qc_gallager.py
// _qc_gallager_core's step (:53-66).  Messages live where JAX keeps them,
// in the check frame: int32[E_b * Z, W], one [Z, W] plane per REAL base
// socket, check-major (plane row_offs[c] + jj is socket jj of base check c),
// row z of a plane belonging to lifted check (c, z).  JAX forms each
// socket's extrinsic message by a prefix and a suffix XOR over the check's
// planes; here
//   parity[c*Z + z, w] = XOR_{row_offs[c] <= r < row_offs[c+1]} msg[r*Z + z, w]
// and the variable pass takes a socket's extrinsic message as
// parity ^ msg: the same bits, one word a check instead of one a socket.
//
// In this layout a check's planes are whole contiguous [Z, W] slabs, no
// index table is read beyond the mb + 1 plane offsets, an irregular base
// has no padded rows, and the pass is a pure stream: the generic layout
// (dc adjacent rows per lifted check, gallager_check.cu) would make the
// variable pass of a circulant stride by dc rows.  Offsets are 64-bit: at
// Z = 83,334, W = 48, 36 planes hold 1.44e8 words (576 MB).
//
// Bound on the H100: memory, one 4-byte load per (socket, z, word) and one
// store per (check, z, word).  blockIdx.y is the base check, a thread takes N
// adjacent words (qc.cuh): every load is a coalesced warp load of a
// contiguous slab.
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

template <int N>
__global__ void qc_gallager_check_kernel(const int32_t* __restrict__ msg,
                                         const int32_t* __restrict__ row_offs,
                                         int32_t* __restrict__ parity,
                                         int lift, int words) {
  const int c = blockIdx.y;
  const int items = lift * words / N;        // a [Z, W] plane, N words each
  const long long plane = static_cast<long long>(lift) * words;
  const int first = __ldg(row_offs + c), last = __ldg(row_offs + c + 1);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const long long within = static_cast<long long>(i) * N;
    Words<N> acc = {};
    for (int r = first; r < last; ++r) {
      const Words<N> m = ldpc::qc::load<N>(msg + r * plane + within);
#pragma unroll
      for (int l = 0; l < N; ++l) acc.v[l] ^= m.v[l];
    }
    ldpc::qc::store<N>(parity + c * plane + within, acc);
  }
}

template <int N>
void launch_check(const void* msg, const void* row_offs, void* parity, int mb,
                  int lift, int words, cudaStream_t stream) {
  const long long items = static_cast<long long>(lift) * words / N;
  qc_gallager_check_kernel<N>
      <<<ldpc::qc::grid_for_planes(items, mb), ldpc::kThreads, 0, stream>>>(
          static_cast<const int32_t*>(msg),
          static_cast<const int32_t*>(row_offs),
          static_cast<int32_t*>(parity), lift, words);
}

}  // namespace

extern "C" int ldpc_qc_gallager_check(const void* msg, const void* row_offs,
                                      void* parity, int mb, int lift,
                                      int words, void* stream) {
  const long long total = static_cast<long long>(mb) * lift * words;
  if (mb > ldpc::qc::kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (ldpc::qc::vector_ok(words, {msg, parity})) {
      launch_check<4>(msg, row_offs, parity, mb, lift, words, s);
    } else {
      launch_check<1>(msg, row_offs, parity, mb, lift, words, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
