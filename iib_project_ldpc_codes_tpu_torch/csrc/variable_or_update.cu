// K3: variable update of the all-zero packed round, with its error count,
// and its value form (variable_or_adopt) for random-codeword transmit.
//
// Replaces iib_project_ldpc_codes_tpu/ops/erasure_bp.py:231-236 and
// :279-288 (_gather_or_by_variable + _packed_iteration_allzero) and the
// per-round total_popcount(~known) of _run_to_fixed_point (:66-110,
// ops/bitops.py:45-47):
//   known[v, w] |= OR_{j < dv} exactly_one[var_to_chk[v, j], w]
//   *errors += sum over all (v, w) of popcount(~known[v, w])
// The value form (variable_or_adopt_kernel, entry point
// ldpc_variable_or_adopt) replaces the variable half of _packed_iteration
// (:239-248): first, with the old known,
//   val[v, w] |= OR_{j < dv} adopt[var_to_chk[v, j], w] & ~known[v, w]
// (adopt is the check pass's exactly_one & xor_known, check_exactly_one.cu).
//
// `known` (and `val`) are updated in place.  That is safe because K2
// (which reads them) has finished before K3 starts on the same stream, and
// each thread reads and writes only its own words; fusing K2 and K3 would
// need a grid-wide sync.
//
// A batch of C codes: `var_to_chk` is int32[C, n, dv] and word w reads the
// slice of code w / wpc (wpc = W / C), as K2 does; C = 1 is the
// single-code call.  The error count stays one total over all codes.
//
// Bound on the H100: memory.  One round reads the n * dv table entries,
// the exactly-one plane and `known`, and writes `known` (at n = 10^6, W =
// 48: 12 + 96 + 192 + 192 MB, 0.147 ms at 3.35 TB/s); each summary row is
// gathered by its dc variables, far apart in a random table, so the
// gathers move dv * n * W * 4 bytes (576 MB), mostly from DRAM, until the
// decode has made most words known.  The value form adds the adopt plane
// and `val` read and written.  The design (K2's and X1's,
// check_exactly_one.cu, edge_candidates.cu):
//   * common.cuh's row grid over the row-major planes, one item of N words
//     a thread (16 bytes where a code's words and the planes' alignment
//     allow: ops/erasure_bp.py check_exactly_one_vector), the variable's
//     dv table entries loaded once for its N words, 32-bit offsets, no
//     division in the socket loop;
//   * at the main paths' degree, dv = 3, the sockets unrolled so that the
//     three gathers are in flight together (other degrees, the irregular
//     phantom views: a loop);
//   * an item whose N words already know every trial skips its gathers and
//     its store (known only grows), which cuts the traffic as the decode
//     converges; the skip is taken per item, not per word;
//   * the value form gathers `adopt` only where the OR of the item's
//     exactly-one gathers has a bit on a trial the variable does not know
//     (taken is a subset of that OR, and only its unknown bits reach val,
//     so this is exact), and then loads and stores `val`; where it has
//     none, known does not change either, and the item stores nothing;
//   * the value form takes the row grid in column tiles of `tile` words
//     (common.cuh tiled_row_item), as the check pass does: at one code of
//     n = 10^4, W = 768 its planes overflow the L2 (check_exactly_one.cu);
//   * the count reduced across the warp with __reduce_add_sync, the warps'
//     sums across the block through shared memory, and added with one
//     atomicAdd a block: integer atomics are exact in any order, so the
//     total does not depend on scheduling.  One atomic a warp, all on one
//     address (375,000 a launch at n = 10^6, W = 48), was slower than the
//     earlier one-word design at every shape (PERF.md row 3).
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

struct Args {
  int32_t* known;
  int32_t* val;               // the value form only
  const int32_t* exactly_one;
  const int32_t* adopt;       // the value form only
  const int32_t* var_to_chk;
  int32_t* errors_slot;
  int n, dv, words, wpc;
  int tile;                   // the value form's column tile (W: none)
  ldpc::RowGrid grid;   // the n variable rows
};

// The variable degree of the (3,6) code, the main paths': the sockets
// unrolled, every gather issued before the first OR.
constexpr int kExactDv = 3;

// OR of the item's dv gathered rows of `plane` (the exactly-one or the adopt
// plane): c the table entries when kDv > 0, else row the table's row.
template <int N, int kDv>
__device__ __forceinline__ Words<N> gather_or(const int32_t* plane,
                                              const int* c,
                                              const int32_t* row,
                                              const Args& a) {
  Words<N> acc = {};
  if constexpr (kDv > 0) {
    Words<N> s[kDv];
#pragma unroll
    for (int p = 0; p < kDv; ++p) {
      s[p] = ldpc::qc::load<N>(plane + c[p] * a.words);
    }
#pragma unroll
    for (int p = 0; p < kDv; ++p) {
#pragma unroll
      for (int l = 0; l < N; ++l) acc.v[l] |= s[p].v[l];
    }
  } else {
    for (int p = 0; p < a.dv; ++p) {
      const Words<N> s = ldpc::qc::load<N>(plane + __ldg(row + p) * a.words);
#pragma unroll
      for (int l = 0; l < N; ++l) acc.v[l] |= s.v[l];
    }
  }
  return acc;
}

// One variable row's item and the block's count.  kDv: the table's width
// when it is kExactDv, else 0 (a loop over a.dv).  kValues: the value form.
template <int N, int kDv, bool kValues>
__device__ __forceinline__ void variable_item(const Args& a) {
  const ldpc::RowItem it = kValues ? ldpc::tiled_row_item<N>(a.grid, a.tile)
                                   : ldpc::row_item<N>(a.grid);
  int unknown = 0;
  if (it.live) {
    const int at = it.row * a.words + it.w;
    int32_t* kp = a.known + at;
    Words<N> k = ldpc::qc::load<N>(kp);
    uint32_t all = 0xFFFFFFFFu;
#pragma unroll
    for (int l = 0; l < N; ++l) all &= k.v[l];
    if (all != 0xFFFFFFFFu) {
      const int dv = kDv > 0 ? kDv : a.dv;
      const int32_t* row =
          a.var_to_chk + ((it.w / a.wpc) * a.n + it.row) * dv;
      int c[kDv > 0 ? kDv : 1];
      if constexpr (kDv > 0) {
#pragma unroll
        for (int p = 0; p < kDv; ++p) c[p] = __ldg(row + p);
      }
      const Words<N> acc =
          gather_or<N, kDv>(a.exactly_one + it.w, c, row, a);
      if constexpr (kValues) {
        uint32_t learn = 0;
#pragma unroll
        for (int l = 0; l < N; ++l) learn |= acc.v[l] & ~k.v[l];
        if (learn != 0) {
          const Words<N> taken =
              gather_or<N, kDv>(a.adopt + it.w, c, row, a);
          int32_t* vp = a.val + at;
          Words<N> v = ldpc::qc::load<N>(vp);
#pragma unroll
          for (int l = 0; l < N; ++l) {
            v.v[l] |= taken.v[l] & ~k.v[l];
            k.v[l] |= acc.v[l];
          }
          ldpc::qc::store<N>(vp, v);
          ldpc::qc::store<N>(kp, k);
        }
      } else {
#pragma unroll
        for (int l = 0; l < N; ++l) k.v[l] |= acc.v[l];
        ldpc::qc::store<N>(kp, k);
      }
    }
#pragma unroll
    for (int l = 0; l < N; ++l) unknown += __popc(~k.v[l]);
  }
  // the count: a warp's sum, then the block's, then one atomic
  unknown = __reduce_add_sync(0xFFFFFFFFu, unknown);
  __shared__ int warp_sums[ldpc::kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = unknown;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < ldpc::kThreads / 32 ? warp_sums[threadIdx.x] : 0;
    v = __reduce_add_sync(0xFFFFFFFFu, v);
    if (threadIdx.x == 0 && v != 0) atomicAdd(a.errors_slot, v);
  }
}

template <int N, int kDv>
__global__ void __launch_bounds__(ldpc::kThreads)
variable_or_update_kernel(const Args a) {
  variable_item<N, kDv, false>(a);
}

template <int N, int kDv>
__global__ void __launch_bounds__(ldpc::kThreads)
variable_or_adopt_kernel(const Args a) {
  variable_item<N, kDv, true>(a);
}

template <int N, int kDv, bool kValues>
void launch(const Args& a, unsigned int blocks, cudaStream_t stream) {
  if constexpr (kValues) {
    variable_or_adopt_kernel<N, kDv>
        <<<blocks, ldpc::kThreads, 0, stream>>>(a);
  } else {
    variable_or_update_kernel<N, kDv>
        <<<blocks, ldpc::kThreads, 0, stream>>>(a);
  }
}

// Both entry points: hold the shape, pick N and the degree, launch.
template <bool kValues>
int run(void* known, void* val, const void* exactly_one, const void* adopt,
        const void* var_to_chk, void* errors_slot, int n, int m, int dv,
        int words, int wpc, int vec, int tile, bool vec_ok, void* stream) {
  if (static_cast<long long>(n) * words == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (wpc <= 0 || words % wpc || !vec_ok || tile <= 0 || tile % vec ||
      words % tile ||
      static_cast<long long>(words / wpc) * n * dv >= (1LL << 31) ||
      !ldpc::row_grid_fits(n, words, vec) ||
      !ldpc::row_grid_fits(m, words, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned int blocks = 0;
  const Args a{static_cast<int32_t*>(known), static_cast<int32_t*>(val),
               static_cast<const int32_t*>(exactly_one),
               static_cast<const int32_t*>(adopt),
               static_cast<const int32_t*>(var_to_chk),
               static_cast<int32_t*>(errors_slot), n, dv, words, wpc, tile,
               ldpc::row_grid(n, words, vec, &blocks)};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool exact = dv == kExactDv;
  (vec == 4 ? (exact ? launch<4, kExactDv, kValues> : launch<4, 0, kValues>)
            : (exact ? launch<1, kExactDv, kValues>
                     : launch<1, 0, kValues>))(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n: rows of `known` and of the table; m: rows of `exactly_one`; wpc: the
// words of a code (W for one code); vec: the words a thread moves, 4 (wpc a
// multiple of 4, both planes 16-byte aligned) or 1.
extern "C" int ldpc_variable_or_update(void* known, const void* exactly_one,
                                       const void* var_to_chk,
                                       void* errors_slot, int n, int m,
                                       int dv, int words, int wpc, int vec,
                                       void* stream) {
  const bool vec_ok =
      (vec == 4 && wpc % 4 == 0 &&
       ldpc::qc::vector_ok(words, {known, exactly_one})) || vec == 1;
  return run<false>(known, nullptr, exactly_one, nullptr, var_to_chk,
                    errors_slot, n, m, dv, words, wpc, vec, words, vec_ok,
                    stream);
}

// The value form: `val` beside `known` (both [n, W]), `adopt` beside
// `exactly_one` (both [m, W]); the same arguments and conditions, N = 4
// only where all four planes are 16-byte aligned; tile: the words of a
// column tile of the grid, a multiple of vec dividing W (W: none).
extern "C" int ldpc_variable_or_adopt(void* known, void* val,
                                      const void* exactly_one,
                                      const void* adopt,
                                      const void* var_to_chk,
                                      void* errors_slot, int n, int m,
                                      int dv, int words, int wpc, int vec,
                                      int tile, void* stream) {
  const bool vec_ok =
      (vec == 4 && wpc % 4 == 0 &&
       ldpc::qc::vector_ok(words, {known, val, exactly_one, adopt})) ||
      vec == 1;
  return run<true>(known, val, exactly_one, adopt, var_to_chk, errors_slot,
                   n, m, dv, words, wpc, vec, tile, vec_ok, stream);
}
