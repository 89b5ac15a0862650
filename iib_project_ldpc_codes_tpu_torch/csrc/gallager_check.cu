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
// Bound on the H100: memory, dc loads and one store of 4 bytes per
// (check, word) (110 MB a round at n = 1e4, (3,6), W = 768).  One thread
// per (check, word), word fastest, so every load is a coalesced 128-byte
// warp load.
#include "common.cuh"

namespace {

__global__ void gallager_check_kernel(const int32_t* __restrict__ msg,
                                      int32_t* __restrict__ parity, int rows,
                                      int dc, int words) {
  const long long total = static_cast<long long>(rows) * words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long c = t / words;
    const long long w = t - c * words;
    const int32_t* row = msg + c * dc * words + w;
    int32_t acc = 0;
    for (int j = 0; j < dc; ++j) acc ^= __ldg(row + static_cast<long long>(j) * words);
    parity[t] = acc;
  }
}

}  // namespace

extern "C" int ldpc_gallager_check(const void* msg, void* parity, int rows,
                                   int dc, int words, void* stream) {
  const long long total = static_cast<long long>(rows) * words;
  if (total > 0) {
    gallager_check_kernel<<<ldpc::grid_for(total), ldpc::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(msg), static_cast<int32_t*>(parity), rows,
        dc, words);
  }
  return static_cast<int>(cudaGetLastError());
}
