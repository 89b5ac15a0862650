// K3: variable update of the all-zero packed round, with its error count.
//
// Replaces iib_project_ldpc_codes_tpu/ops/erasure_bp.py:231-236 and
// :279-288 (_gather_or_by_variable + _packed_iteration_allzero) and the
// per-round total_popcount(~known) of _run_to_fixed_point (:66-110,
// ops/bitops.py:45-47):
//   known[v, w] |= OR_{j < dv} exactly_one[var_to_chk[v, j], w]
//   *errors += sum over all (v, w) of popcount(~known[v, w])
//
// `known` is updated in place.  That is safe because K2 (which reads
// `known`) has finished before K3 starts on the same stream, and each
// thread reads and writes only its own words; fusing K2 and K3 would need
// a grid-wide sync.
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
// decode has made most words known.  The design (K2's and X1's,
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
  const int32_t* exactly_one;
  const int32_t* var_to_chk;
  int32_t* errors_slot;
  int n, dv, words, wpc;
  ldpc::RowGrid grid;   // the n variable rows
};

// The variable degree of the (3,6) code, the main paths': the sockets
// unrolled, every gather issued before the first OR.
constexpr int kExactDv = 3;

// kDv: the table's width when it is kExactDv, else 0 (a loop over a.dv).
template <int N, int kDv>
__global__ void __launch_bounds__(ldpc::kThreads)
variable_or_update_kernel(const Args a) {
  const ldpc::RowItem it = ldpc::row_item<N>(a.grid);
  int unknown = 0;
  if (it.live) {
    int32_t* kp = a.known + it.row * a.words + it.w;
    Words<N> k = ldpc::qc::load<N>(kp);
    uint32_t all = 0xFFFFFFFFu;
#pragma unroll
    for (int l = 0; l < N; ++l) all &= k.v[l];
    if (all != 0xFFFFFFFFu) {
      const int dv = kDv > 0 ? kDv : a.dv;
      const int32_t* row =
          a.var_to_chk + ((it.w / a.wpc) * a.n + it.row) * dv;
      const int32_t* summary = a.exactly_one + it.w;
      Words<N> acc = {};
      if constexpr (kDv > 0) {
        int c[kDv];
#pragma unroll
        for (int p = 0; p < kDv; ++p) c[p] = __ldg(row + p);
        Words<N> s[kDv];
#pragma unroll
        for (int p = 0; p < kDv; ++p) {
          s[p] = ldpc::qc::load<N>(summary + c[p] * a.words);
        }
#pragma unroll
        for (int p = 0; p < kDv; ++p) {
#pragma unroll
          for (int l = 0; l < N; ++l) acc.v[l] |= s[p].v[l];
        }
      } else {
        for (int p = 0; p < a.dv; ++p) {
          const Words<N> s =
              ldpc::qc::load<N>(summary + __ldg(row + p) * a.words);
#pragma unroll
          for (int l = 0; l < N; ++l) acc.v[l] |= s.v[l];
        }
      }
#pragma unroll
      for (int l = 0; l < N; ++l) k.v[l] |= acc.v[l];
      ldpc::qc::store<N>(kp, k);
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
void launch(const Args& a, unsigned int blocks, cudaStream_t stream) {
  variable_or_update_kernel<N, kDv>
      <<<blocks, ldpc::kThreads, 0, stream>>>(a);
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
  if (static_cast<long long>(n) * words == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec_ok =
      (vec == 4 && wpc % 4 == 0 &&
       ldpc::qc::vector_ok(words, {known, exactly_one})) || vec == 1;
  if (wpc <= 0 || words % wpc || !vec_ok ||
      static_cast<long long>(words / wpc) * n * dv >= (1LL << 31) ||
      !ldpc::row_grid_fits(n, words, vec) ||
      !ldpc::row_grid_fits(m, words, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned int blocks = 0;
  const Args a{static_cast<int32_t*>(known),
               static_cast<const int32_t*>(exactly_one),
               static_cast<const int32_t*>(var_to_chk),
               static_cast<int32_t*>(errors_slot), n, dv, words, wpc,
               ldpc::row_grid(n, words, vec, &blocks)};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool exact = dv == kExactDv;
  (vec == 4 ? (exact ? launch<4, kExactDv> : launch<4, 0>)
            : (exact ? launch<1, kExactDv> : launch<1, 0>))(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
