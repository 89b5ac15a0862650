// Q2: variable pass of the packed BEC round on a quasi-cyclic code, with
// its error count.
//
// Replaces the variable half of iib_project_ldpc_codes_tpu/ops/qc_bp.py
// _qc_iteration_allzero (:64-87: roll each socket's exactly-one plane back
// by +s and OR it into block b) and of _qc_iteration (:90-117), and the
// per-round total_popcount(~known) of the fixed-point loop (:121-146).  For
// lifted variable (b, z) and word w, over block b's base sockets i (check
// c_i, shift s_i; the variable-side adjacency, padded per block with -1):
//   r_i         = c_i * Z + (z - s_i) mod Z
//   any         = OR_i exactly_one[r_i, w]
//   taken       = OR_i adopt[r_i, w]                     (kVal only)
//   val[v, w]   |= taken & ~known[v, w]                  (kVal only)
//   known[v, w] |= any
//   *errors += sum over all (v, w) of popcount(~known[v, w])
// Q1's plane is the check-level summary (exactly one participant unknown);
// ORing it into a participant that is already known changes nothing, so the
// result equals JAX's per-socket planes bit for bit.
//
// `known` (and `val`) are updated in place: Q1, which read them, has
// finished on the same stream, and each thread reads, then writes, only its
// own (v, w).  The two passes keep the exactly-one plane between them; one
// fused in-place kernel would race across blocks.
//
// Bound on the H100: memory, dvb loads of `exactly_one` (2 dvb with value
// planes) + 1 read + 1 write of 4 bytes per word.  At n = 1,000,008, W = 48
// the 96 MB exactly-one plane does not fit the 50 MB L2, so a row-major
// pass reads it from DRAM dvb times.  The design:
//   * tile-major planes and the column-tile grid (qc.cuh): the blocks
//     resident at one time work on one tile of every row, so the dvb reads
//     of a piece of the exactly-one (and adopt) plane come while its tile
//     is in L2; the thread's own `known` and `val` words are read once and
//     written once (ld/st.global.cs: on the H100 11% faster at n =
//     1,000,008 than the default policy, PERF.md);
//   * the circulant index as a rotation of the [Z, tile] slab by s * tile
//     words (qc.cuh rotate_down);
//   * a thread takes one item of N words (16 bytes where the tile and the
//     planes' alignment allow) and loops over the block's sockets (32
//     registers: the loads of 8 sockets held before their arithmetic took
//     48, 78 with value planes, and were 11-15% slower);
//   * an item whose trials all know the variable already skips its loads
//     and stores (known only grows), as K3 does;
//   * the count reduced across the warp (__reduce_add_sync), then across
//     the block in shared memory, then one atomicAdd a block (integer
//     atomics: exact in any order).
// Instantiations: N = 4 and 1, with and without value planes.
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

constexpr int kWarps = ldpc::kThreads / 32;

struct Args {
  int32_t* known;
  int32_t* val;
  const int32_t* exactly_one;
  const int32_t* adopt;
  const int32_t* var_chk;
  const int32_t* var_shift;
  int32_t* errors_slot;
  int dvb, mb;
  ldpc::qc::TileGrid grid;
};

// The item's new known (and val) words: the OR of its sockets' exactly-one
// (and adopt) words.
template <bool kVal, int N>
__device__ __forceinline__ void update(const Args& a,
                                       const ldpc::qc::TileItem& it,
                                       long long own, Words<N>& k) {
  const int size = a.grid.lift * a.grid.tile;
  const int rows = a.mb * a.grid.lift;
  const int32_t* chks = a.var_chk + it.plane * a.dvb;
  const int32_t* shifts = a.var_shift + it.plane * a.dvb;
  Words<N> any = {}, taken = {};
  for (int p = 0; p < a.dvb; ++p) {
    const int c = __ldg(chks + p);
    if (c < 0) break;            // the block's sockets end at -1
    const long long src =
        ldpc::qc::slab(it.tile, c, rows, a.grid) +
        ldpc::qc::rotate_down(it.o, __ldg(shifts + p) * a.grid.tile, size);
    const Words<N> e = ldpc::qc::load<N>(a.exactly_one + src);
    Words<N> ad = {};
    if (kVal) ad = ldpc::qc::load<N>(a.adopt + src);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      any.v[l] |= e.v[l];
      if (kVal) taken.v[l] |= ad.v[l];
    }
  }
  if (kVal) {
    Words<N> v = ldpc::qc::load_stream<N>(a.val + own);
#pragma unroll
    for (int l = 0; l < N; ++l) v.v[l] |= taken.v[l] & ~k.v[l];
    ldpc::qc::store_stream<N>(a.val + own, v);
  }
#pragma unroll
  for (int l = 0; l < N; ++l) k.v[l] |= any.v[l];
  ldpc::qc::store_stream<N>(a.known + own, k);
}

template <bool kVal, int N>
__global__ void __launch_bounds__(ldpc::kThreads)
qc_variable_or_kernel(const Args a) {
  __shared__ int sums[kWarps];
  const ldpc::qc::TileItem it = ldpc::qc::tile_item<N>(a.grid);
  int unknown = 0;
  if (it.live) {
    const long long own =
        ldpc::qc::slab(it.tile, it.plane, a.grid.planes * a.grid.lift,
                       a.grid) + it.o;
    Words<N> k = ldpc::qc::load_stream<N>(a.known + own);
    uint32_t all_known = 0xFFFFFFFFu;
#pragma unroll
    for (int l = 0; l < N; ++l) all_known &= k.v[l];
    if (all_known != 0xFFFFFFFFu) update<kVal, N>(a, it, own, k);
#pragma unroll
    for (int l = 0; l < N; ++l) unknown += __popc(~k.v[l]);
  }
  // every thread of the block gets here (no early exit)
  unknown = __reduce_add_sync(0xFFFFFFFFu, unknown);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = unknown;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sums[w];
    if (total != 0) atomicAdd(a.errors_slot, total);
  }
}

template <bool kVal, int N>
void launch_variable(const Args& a, long long blocks, cudaStream_t stream) {
  qc_variable_or_kernel<kVal, N>
      <<<static_cast<unsigned int>(blocks), ldpc::kThreads, 0, stream>>>(a);
}

}  // namespace

// vec, tile: as ldpc_qc_check_exactly_one's.
extern "C" int ldpc_qc_variable_or(void* known, void* val,
                                   const void* exactly_one, const void* adopt,
                                   const void* var_chk, const void* var_shift,
                                   void* errors_slot, int nb, int mb, int dvb,
                                   int lift, int words, int vec, int tile,
                                   void* stream) {
  const bool vec_ok =
      (vec == 4 && ldpc::qc::vector_ok(tile,
                                       {known, val, exactly_one, adopt}))
      || vec == 1;
  if ((val == nullptr) != (adopt == nullptr) || nb > ldpc::qc::kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(nb) * lift * words == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (!vec_ok || !ldpc::qc::tiles_fit(lift, words, tile, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = 0;
  const Args a{static_cast<int32_t*>(known), static_cast<int32_t*>(val),
               static_cast<const int32_t*>(exactly_one),
               static_cast<const int32_t*>(adopt),
               static_cast<const int32_t*>(var_chk),
               static_cast<const int32_t*>(var_shift),
               static_cast<int32_t*>(errors_slot), dvb, mb,
               ldpc::qc::tile_grid(nb, lift, words, tile, vec, &blocks)};
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto fn = val == nullptr ? (vec == 4 ? launch_variable<false, 4>
                                       : launch_variable<false, 1>)
                           : (vec == 4 ? launch_variable<true, 4>
                                       : launch_variable<true, 1>);
  fn(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
