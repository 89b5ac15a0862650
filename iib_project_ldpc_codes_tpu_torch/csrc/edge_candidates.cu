// X1: the variable half of one edge-sharded round, the candidate plane of
// one rank's check shard.
//
// Replaces iib_project_ldpc_codes_tpu/parallel/edge_sharded.py:71-79 (the
// masked gather of _local_round).  For variable v and word w:
//   cand[v, w] = OR_{p < dv} (0 <= var_to_chk[v, p] - off < m_local
//                             ? exactly_one[var_to_chk[v, p] - off, w] : 0)
// where exactly_one int32[m_local, W] is the exactly-one-unknown summary of
// this rank's checks off .. off + m_local - 1 (K2 on the row slice of the
// check table).  JAX clips the shifted index into range and masks the row
// afterwards; here a check outside the shard is never read, so no load
// leaves the m_local rows.
//
// Bound on the H100: memory.  One round reads the n * dv table entries once
// and writes n * W words (at n = 1e6, W = 48: 12 MB read, 192 MB written);
// the summary rows it gathers (m_local * W words, 96 MB at one rank) are
// read about dv * m_local / m times each over the grid, mostly from L2.
// One thread per (variable, word), word fastest: a warp reads whole
// gathered rows in coalesced 128-byte pieces and the variable's dv
// indices are one broadcast load for every lane that shares the variable.
// All gathers and no scatter, as in JAX, so no atomics and no zeroing.
#include "common.cuh"

namespace {

__global__ void edge_candidates_kernel(int32_t* __restrict__ cand,
                                       const int32_t* __restrict__ var_to_chk,
                                       const int32_t* __restrict__ exactly_one,
                                       int n, int dv, int m_local, int words,
                                       int chk_offset) {
  const long long total = static_cast<long long>(n) * words;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const int v = static_cast<int>(t / words);
    const int w = static_cast<int>(t - static_cast<long long>(v) * words);
    const int32_t* row = var_to_chk + static_cast<long long>(v) * dv;
    uint32_t acc = 0;
    for (int p = 0; p < dv; ++p) {
      const int c = __ldg(row + p) - chk_offset;
      if (static_cast<unsigned>(c) < static_cast<unsigned>(m_local)) {
        acc |= static_cast<uint32_t>(
            __ldg(exactly_one + static_cast<long long>(c) * words + w));
      }
    }
    cand[t] = static_cast<int32_t>(acc);
  }
}

}  // namespace

extern "C" int ldpc_edge_candidates(void* cand, const void* var_to_chk,
                                    const void* exactly_one, int n, int dv,
                                    int m_local, int words, int chk_offset,
                                    void* stream) {
  const long long total = static_cast<long long>(n) * words;
  if (total > 0) {
    edge_candidates_kernel<<<ldpc::grid_for(total), ldpc::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(cand), static_cast<const int32_t*>(var_to_chk),
        static_cast<const int32_t*>(exactly_one), n, dv, m_local, words,
        chk_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
