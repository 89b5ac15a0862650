// K2: per-check "exactly one participant unknown" plane, and its value form
// (check_exactly_one_xor) for random-codeword transmit.
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
// The value form (check_exactly_one_xor_kernel, entry point
// ldpc_check_exactly_one_xor) replaces _check_summaries(code, val, known)
// (:186-228), the check half of _packed_iteration (:239-248):
//   adopt[c, w] = exactly_one & XOR_j (val[v_j, w] & known[v_j, w]),
// the value the unique unknown participant must take, already masked by
// exactly_one, so the variable pass ORs it as it is (JAX:
// _gather_or_by_variable(code, exactly_one & xor_known)).
//
// Bound on the H100: memory.  Per (check, word): dc gathered loads of
// `known` and one store, ~3 logic ops a word.  Each row of `known` is read
// dv times a round by checks far apart in a random table, so the gathers
// move dc * m * W * 4 bytes (576 MB at n = 10^6, W = 48: 0.17 ms alone at
// 3.35 TB/s) from DRAM, not the plane's 192 MB once.  The value form adds
// dc gathers of `val` and a second store.  The design:
//   * one item of N words a thread (16 bytes where a code's words and the
//     planes' alignment allow), the check's dc table entries loaded once
//     for all its words, 32-bit offsets, no division in the socket loop
//     (the earlier 4-byte form divided a 64-bit index by W per word:
//     PERF.md rows 2 and 5 have both forms' times);
//   * at the main paths' degree, dc = 6, all of a check's table entries and
//     then all of its rows loaded before the first fold, six gathers in
//     flight a thread (other degrees: a socket loop);
//   * the value form gathers `val` only where the item's exactly-one
//     summary is non-zero (adopt is zero wherever exactly_one is, so this
//     is exact): a converged word, or a trial stuck on a stopping set, has
//     no check with exactly one unknown and skips half of the gathers; at
//     dc = 6 the six `val` loads are issued together after that test;
//   * common.cuh's row grid on the row-major planes.  Column tiles of
//     `known`, the tile slowest in the grid so that its reads come from L2,
//     tied with row-major on the H100 and lost the two conversions a
//     decode (PERF.md row 15).  The value form gathers two planes, which
//     at one code of n = 10^4, W = 768 (61 MB) overflow the 50 MB L2: it
//     takes the row grid in column tiles of `tile` words of the row-major
//     planes (tiled_row_item; the wrapper sizes them to a third of the L2,
//     ops/erasure_bp.py value_round_tile), 28% faster there (PERF.md row 5);
//   * the planes written once, streamed (st.global.cs).
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

struct Args {
  const int32_t* known;
  const int32_t* val;       // the value form only
  const int32_t* chk_to_var;
  int32_t* out;
  int32_t* adopt;           // the value form only
  int m, dc, words, wpc;
  int tile;                 // the value form's column tile (W: none)
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

template <int N>
__device__ __forceinline__ Words<N> exactly_one_of(const Words<N>& once,
                                                   const Words<N>& twice) {
  Words<N> eo;
#pragma unroll
  for (int l = 0; l < N; ++l) eo.v[l] = once.v[l] & ~twice.v[l];
  return eo;
}

// Whether a check teaches any of the item's trials (its exactly-one words
// are not all zero): only then does the value form gather `val`.
template <int N>
__device__ __forceinline__ bool teaches(const Words<N>& eo) {
  uint32_t any = 0;
#pragma unroll
  for (int l = 0; l < N; ++l) any |= eo.v[l];
  return any != 0;
}

template <int N>
__device__ __forceinline__ void fold_value(const Words<N>& k,
                                           const Words<N>& v, Words<N>& x) {
#pragma unroll
  for (int l = 0; l < N; ++l) x.v[l] ^= v.v[l] & k.v[l];
}

// One check row's item.  kDc: the table's width when it is kExactDc, else 0
// (a loop over a.dc).  kValues: the value form, which also writes adopt.
template <int N, int kDc, bool kValues>
__device__ __forceinline__ void check_item(const Args& a) {
  const ldpc::RowItem it = kValues ? ldpc::tiled_row_item<N>(a.grid, a.tile)
                                   : ldpc::row_item<N>(a.grid);
  if (!it.live) return;
  const int dc = kDc > 0 ? kDc : a.dc;
  const int32_t* row = a.chk_to_var + ((it.w / a.wpc) * a.m + it.row) * dc;
  const int32_t* known = a.known + it.w;
  Words<N> once = {}, twice = {}, eo, x = {};
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
    eo = exactly_one_of<N>(once, twice);
    if constexpr (kValues) {
      if (teaches<N>(eo)) {
        Words<N> s[kDc];
#pragma unroll
        for (int j = 0; j < kDc; ++j) {
          s[j] = ldpc::qc::load<N>(a.val + it.w + v[j] * a.words);
        }
#pragma unroll
        for (int j = 0; j < kDc; ++j) fold_value<N>(k[j], s[j], x);
      }
    }
  } else {
    for (int j = 0; j < a.dc; ++j) {
      fold<N>(ldpc::qc::load<N>(known + __ldg(row + j) * a.words), once,
              twice);
    }
    eo = exactly_one_of<N>(once, twice);
    if constexpr (kValues) {
      if (teaches<N>(eo)) {
        for (int j = 0; j < a.dc; ++j) {
          const int at = __ldg(row + j) * a.words;
          fold_value<N>(ldpc::qc::load<N>(known + at),
                        ldpc::qc::load<N>(a.val + it.w + at), x);
        }
      }
    }
  }
  const int at = it.row * a.words + it.w;
  ldpc::qc::store_stream<N>(a.out + at, eo);
  if constexpr (kValues) {
#pragma unroll
    for (int l = 0; l < N; ++l) x.v[l] &= eo.v[l];
    ldpc::qc::store_stream<N>(a.adopt + at, x);
  }
}

template <int N, int kDc>
__global__ void __launch_bounds__(ldpc::kThreads)
check_exactly_one_kernel(const Args a) {
  check_item<N, kDc, false>(a);
}

template <int N, int kDc>
__global__ void __launch_bounds__(ldpc::kThreads)
check_exactly_one_xor_kernel(const Args a) {
  check_item<N, kDc, true>(a);
}

template <int N, int kDc, bool kValues>
void launch(const Args& a, unsigned int blocks, cudaStream_t stream) {
  if constexpr (kValues) {
    check_exactly_one_xor_kernel<N, kDc>
        <<<blocks, ldpc::kThreads, 0, stream>>>(a);
  } else {
    check_exactly_one_kernel<N, kDc>
        <<<blocks, ldpc::kThreads, 0, stream>>>(a);
  }
}

// Both entry points: hold the shape, pick N and the degree, launch.
template <bool kValues>
int run(const void* known, const void* val, const void* chk_to_var,
        void* out, void* adopt, int n, int m, int dc, int words, int wpc,
        int vec, int tile, bool vec_ok, void* stream) {
  if (static_cast<long long>(m) * words == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (wpc <= 0 || words % wpc || !vec_ok || tile <= 0 || tile % vec ||
      words % tile ||
      static_cast<long long>(words / wpc) * m * dc >= (1LL << 31) ||
      !ldpc::row_grid_fits(n, words, vec) ||
      !ldpc::row_grid_fits(m, words, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned int blocks = 0;
  const Args a{static_cast<const int32_t*>(known),
               static_cast<const int32_t*>(val),
               static_cast<const int32_t*>(chk_to_var),
               static_cast<int32_t*>(out), static_cast<int32_t*>(adopt), m,
               dc, words, wpc, tile, ldpc::row_grid(m, words, vec, &blocks)};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool exact = dc == kExactDc;
  (vec == 4 ? (exact ? launch<4, kExactDc, kValues> : launch<4, 0, kValues>)
            : (exact ? launch<1, kExactDc, kValues>
                     : launch<1, 0, kValues>))(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n: rows of `known`; m: check rows of the table and the summary; wpc: the
// words of a code (W for one code); vec: the words a thread moves, 4 (wpc a
// multiple of 4, both planes 16-byte aligned) or 1.
extern "C" int ldpc_check_exactly_one(const void* known,
                                      const void* chk_to_var, void* out,
                                      int n, int m, int dc, int words,
                                      int wpc, int vec, void* stream) {
  const bool vec_ok =
      (vec == 4 && wpc % 4 == 0 && ldpc::qc::vector_ok(words, {known, out}))
      || vec == 1;
  return run<false>(known, nullptr, chk_to_var, out, nullptr, n, m, dc,
                    words, wpc, vec, words, vec_ok, stream);
}

// The value form: `val` beside `known` (both [n, W]), `adopt` beside
// `exactly_one` (both [m, W]); the same arguments and conditions, N = 4
// only where all four planes are 16-byte aligned; tile: the words of a
// column tile of the grid, a multiple of vec dividing W (W: none).
extern "C" int ldpc_check_exactly_one_xor(const void* known, const void* val,
                                          const void* chk_to_var,
                                          void* exactly_one, void* adopt,
                                          int n, int m, int dc, int words,
                                          int wpc, int vec, int tile,
                                          void* stream) {
  const bool vec_ok =
      (vec == 4 && wpc % 4 == 0 &&
       ldpc::qc::vector_ok(words, {known, val, exactly_one, adopt})) ||
      vec == 1;
  return run<true>(known, val, chk_to_var, exactly_one, adopt, n, m, dc,
                   words, wpc, vec, tile, vec_ok, stream);
}
