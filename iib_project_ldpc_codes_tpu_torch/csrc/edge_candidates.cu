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
// afterwards; here a check outside the shard is never read (one unsigned
// compare), so no load leaves the m_local rows.
//
// Bound on the H100: memory.  One round reads the n * dv table entries and
// the shard's summary and writes n * W words (at n = 10^6, W = 48, one
// rank: 12 MB + 96 MB read, 192 MB written); each summary row is gathered
// by its dc variables, far apart in a random table, so the gathers move dv
// * n * W * 4 bytes (576 MB), mostly from DRAM.  The design (K2's,
// check_exactly_one.cu):
//   * one item of N words a thread (16 bytes where W and the planes'
//     alignment allow), the variable's dv table entries loaded once for
//     all its words, 32-bit offsets, no division in the socket loop;
//   * at the main paths' degree, dv = 3, the sockets unrolled so that the
//     three gathers are in flight together (other degrees: a loop);
//   * common.cuh's row grid on the row-major planes (column tiles of the
//     summary, the tile slowest in the grid, tied with them on the H100:
//     PERF.md row 15);
//   * the candidate plane written once and read once by X2, streamed
//     (st.global.cs).
// All gathers and no scatter, as in JAX, so no atomics and no zeroing.
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

struct Args {
  int32_t* cand;
  const int32_t* var_to_chk;
  const int32_t* exactly_one;
  int dv, m_local, words, chk_offset;
  ldpc::RowGrid grid;   // the n variable rows
};

// The variable degree of the (3,6) code, the main paths': the sockets
// unrolled, every gather issued before the first OR.
constexpr int kExactDv = 3;

// kDv: the table's width when it is kExactDv, else 0 (a loop over a.dv).
template <int N, int kDv>
__global__ void __launch_bounds__(ldpc::kThreads)
edge_candidates_kernel(const Args a) {
  const ldpc::RowItem it = ldpc::row_item<N>(a.grid);
  if (!it.live) return;
  const int32_t* row = a.var_to_chk + it.row * (kDv > 0 ? kDv : a.dv);
  const int32_t* summary = a.exactly_one + it.w;
  Words<N> acc = {};
  auto gather = [&](int p) {
    const int c = __ldg(row + p) - a.chk_offset;
    if (static_cast<unsigned>(c) < static_cast<unsigned>(a.m_local)) {
      const Words<N> s = ldpc::qc::load<N>(summary + c * a.words);
#pragma unroll
      for (int l = 0; l < N; ++l) acc.v[l] |= s.v[l];
    }
  };
  if constexpr (kDv > 0) {
#pragma unroll
    for (int p = 0; p < kDv; ++p) gather(p);
  } else {
    for (int p = 0; p < a.dv; ++p) gather(p);
  }
  ldpc::qc::store_stream<N>(a.cand + it.row * a.words + it.w, acc);
}

template <int N, int kDv>
void launch(const Args& a, unsigned int blocks, cudaStream_t stream) {
  edge_candidates_kernel<N, kDv>
      <<<blocks, ldpc::kThreads, 0, stream>>>(a);
}

}  // namespace

// vec: the words a thread moves, 4 (W a multiple of 4, both planes
// 16-byte aligned) or 1.
extern "C" int ldpc_edge_candidates(void* cand, const void* var_to_chk,
                                    const void* exactly_one, int n, int dv,
                                    int m_local, int words, int chk_offset,
                                    int vec, void* stream) {
  if (static_cast<long long>(n) * words == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec_ok =
      (vec == 4 && ldpc::qc::vector_ok(words, {cand, exactly_one})) ||
      vec == 1;
  if (!vec_ok || !ldpc::row_grid_fits(n, words, vec) ||
      !ldpc::row_grid_fits(m_local, words, vec) ||
      static_cast<long long>(n) * dv >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned int blocks = 0;
  const Args a{static_cast<int32_t*>(cand),
               static_cast<const int32_t*>(var_to_chk),
               static_cast<const int32_t*>(exactly_one), dv, m_local, words,
               chk_offset, ldpc::row_grid(n, words, vec, &blocks)};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool exact = dv == kExactDv;
  (vec == 4 ? (exact ? launch<4, kExactDv> : launch<4, 0>)
            : (exact ? launch<1, kExactDv> : launch<1, 0>))(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
