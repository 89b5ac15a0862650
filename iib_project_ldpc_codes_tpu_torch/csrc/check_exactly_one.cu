// K2: per-check "exactly one participant unknown" plane.
//
// Replaces iib_project_ldpc_codes_tpu/ops/erasure_bp.py:186-228
// (_check_summaries(code, None, known)), the check half of the all-zero
// packed round, and on one rank's check rows the check half of
// iib_project_ldpc_codes_tpu/parallel/edge_sharded.py _local_round
// (:44-79).  For check c and word w:
//   exactly_one[c, w] = bits where exactly one of the dc words
//                       known[chk_to_var[c, j], w] is 0.
// JAX writes it as OR_j(~k_j & prefixAND_j & suffixAND_j); two running
// masks (a zero seen once, a zero seen twice) give the same bits in one
// pass with no arrays, for any dc.
//
// Bound on the H100: memory.  Per (check, word): dc gathered loads of
// `known` and one store, ~3 logic ops a word.  Each row of `known` is read
// dv times a round by checks far apart in a random table, so the gathers
// move dc * m * W * 4 bytes (576 MB at n = 10^6, W = 48: 0.17 ms alone at
// 3.35 TB/s) from DRAM, not the plane's 192 MB once.  The design:
//   * one item of N words a thread (16 bytes where a code's words and the
//     planes' alignment allow), the check's dc table entries loaded once
//     for all its words, 32-bit offsets, no division in the socket loop
//     (the earlier 4-byte form divided a 64-bit index by W per word:
//     PERF.md row 2 has both forms' times);
//   * at the main paths' degree, dc = 6, all of a check's table entries and
//     then all of its rows loaded before the first fold, six gathers in
//     flight a thread (other degrees: a socket loop);
//   * common.cuh's row grid on the row-major planes.  Column tiles of
//     `known`, the tile slowest in the grid so that its reads come from L2,
//     tied with row-major on the H100 and lost the two conversions a
//     decode (PERF.md row 15);
//   * the summary written once, streamed (st.global.cs).
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

struct Args {
  const int32_t* known;
  const int32_t* chk_to_var;
  int32_t* out;
  int m, dc, words, wpc;
  ldpc::RowGrid grid;   // the m check rows
};

// The degree of the (3,6) code's checks, the main paths' (an irregular
// code's phantom-padded table of width 6 too): every socket's load issued
// before the first fold.
constexpr int kExactDc = 6;

template <int N>
__device__ __forceinline__ void fold(const Words<N>& k, Words<N>& once,
                                     Words<N>& twice) {
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const uint32_t unknown = ~k.v[l];
    twice.v[l] |= once.v[l] & unknown;
    once.v[l] |= unknown;
  }
}

// kDc: the table's width when it is kExactDc, else 0 (a loop over a.dc).
template <int N, int kDc>
__global__ void __launch_bounds__(ldpc::kThreads)
check_exactly_one_kernel(const Args a) {
  const ldpc::RowItem it = ldpc::row_item<N>(a.grid);
  if (!it.live) return;
  const int dc = kDc > 0 ? kDc : a.dc;
  const int32_t* row = a.chk_to_var + ((it.w / a.wpc) * a.m + it.row) * dc;
  const int32_t* known = a.known + it.w;
  Words<N> once = {}, twice = {};
  if constexpr (kDc > 0) {
    int v[kDc];
#pragma unroll
    for (int j = 0; j < kDc; ++j) v[j] = __ldg(row + j);
    Words<N> k[kDc];
#pragma unroll
    for (int j = 0; j < kDc; ++j) {
      k[j] = ldpc::qc::load<N>(known + v[j] * a.words);
    }
#pragma unroll
    for (int j = 0; j < kDc; ++j) fold<N>(k[j], once, twice);
  } else {
    for (int j = 0; j < a.dc; ++j) {
      fold<N>(ldpc::qc::load<N>(known + __ldg(row + j) * a.words), once,
              twice);
    }
  }
  Words<N> eo;
#pragma unroll
  for (int l = 0; l < N; ++l) eo.v[l] = once.v[l] & ~twice.v[l];
  ldpc::qc::store_stream<N>(a.out + it.row * a.words + it.w, eo);
}

template <int N, int kDc>
void launch(const Args& a, unsigned int blocks, cudaStream_t stream) {
  check_exactly_one_kernel<N, kDc>
      <<<blocks, ldpc::kThreads, 0, stream>>>(a);
}

}  // namespace

// n: rows of `known`; m: check rows of the table and the summary; wpc: the
// words of a code (W for one code); vec: the words a thread moves, 4 (wpc a
// multiple of 4, both planes 16-byte aligned) or 1.
extern "C" int ldpc_check_exactly_one(const void* known,
                                      const void* chk_to_var, void* out,
                                      int n, int m, int dc, int words,
                                      int wpc, int vec, void* stream) {
  if (static_cast<long long>(m) * words == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec_ok =
      (vec == 4 && wpc % 4 == 0 && ldpc::qc::vector_ok(words, {known, out}))
      || vec == 1;
  if (wpc <= 0 || words % wpc || !vec_ok ||
      static_cast<long long>(words / wpc) * m * dc >= (1LL << 31) ||
      !ldpc::row_grid_fits(n, words, vec) ||
      !ldpc::row_grid_fits(m, words, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned int blocks = 0;
  const Args a{static_cast<const int32_t*>(known),
               static_cast<const int32_t*>(chk_to_var),
               static_cast<int32_t*>(out), m, dc, words, wpc,
               ldpc::row_grid(m, words, vec, &blocks)};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool exact = dc == kExactDc;
  (vec == 4 ? (exact ? launch<4, kExactDc> : launch<4, 0>)
            : (exact ? launch<1, kExactDc> : launch<1, 0>))(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
