// Q1: check pass of the packed BEC round on a quasi-cyclic code.
//
// Replaces the check half of iib_project_ldpc_codes_tpu/ops/qc_bp.py
// _qc_iteration_allzero (:64-87) and, with value planes, of _qc_iteration
// (:90-117).  JAX makes one rolled copy of a whole [Z, W] plane per base
// socket (jnp.roll by -s) and forms every socket's exactly-one plane by
// prefix and suffix ANDs; here the shift folds into the load address and no
// rolled copy exists.  For lifted check (c, z) and word w, over the REAL
// sockets j of base check c (chk_block[c, j] < nb, compacted to the left):
//   v_j               = chk_block[c, j] * Z + (z + chk_shift[c, j]) mod Z
//   exactly_one[c*Z+z, w] = bits where exactly one known[v_j, w] is 0
//   adopt[c*Z+z, w]       = exactly_one & XOR_j (val[v_j, w] & known[v_j, w])
// The second plane (kVal, random-codeword transmit) is the value the unique
// unknown participant must take, as check_exactly_one_xor writes it; the
// all-zero instantiation (val == nullptr) neither reads val nor writes adopt.
// The exactly-one summary is K2's two running masks (a zero seen once, a
// zero seen twice).
//
// Bound on the H100: memory.  Per (check, word): one 4-byte load of `known`
// per real socket and one 4-byte store (twice that with value planes); each
// byte of `known` is read dvb times a round.  At n = 1,000,008, W = 48 the
// 192 MB `known` does not fit the 50 MB L2, so a row-major pass reads it
// from DRAM dvb times.  The design:
//   * tile-major planes and the column-tile grid (qc.cuh): the blocks
//     resident at one time work on one tile of every row, so the dvb reads
//     of a piece of `known` come while its tile is in L2; the exactly-one
//     and adopt planes are written once (st.global.cs);
//   * the circulant index as a rotation of the [Z, tile] slab by s * tile
//     words (qc.cuh rotate_up), no row, no division;
//   * a thread takes one item of N words (16 bytes where the tile and the
//     planes' alignment allow) and loops over the check's sockets: 32
//     registers, so 2,048 threads an SM keep their loads in flight (on the
//     H100, the loads of 8 sockets held before their arithmetic took 48
//     registers and were 5% slower; an L2 evict-last policy on `known`
//     changed nothing: PERF.md).
// Instantiations: N = 4 and 1, with and without value planes.
#include "qc.cuh"

namespace {

using ldpc::qc::Words;

struct Args {
  const int32_t* known;
  const int32_t* val;
  const int32_t* chk_block;
  const int32_t* chk_shift;
  int32_t* exactly_one;
  int32_t* adopt;
  int dcb, nb;
  ldpc::qc::TileGrid grid;
};

// The running summary of one socket's words: `once` / `twice` gather the
// unknown bits, `xor_known` the known values.
template <bool kVal, int N>
__device__ __forceinline__ void fold(const Words<N>& k, const Words<N>& v,
                                     Words<N>& once, Words<N>& twice,
                                     Words<N>& xor_known) {
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const uint32_t unknown = ~k.v[l];
    twice.v[l] |= once.v[l] & unknown;
    once.v[l] |= unknown;
    if (kVal) xor_known.v[l] ^= v.v[l] & k.v[l];
  }
}

template <bool kVal, int N>
__global__ void __launch_bounds__(ldpc::kThreads)
qc_check_exactly_one_kernel(const Args a) {
  const ldpc::qc::TileItem it = ldpc::qc::tile_item<N>(a.grid);
  if (!it.live) return;
  const int size = a.grid.lift * a.grid.tile;
  const int rows = a.nb * a.grid.lift;
  const int32_t* blocks = a.chk_block + it.plane * a.dcb;
  const int32_t* shifts = a.chk_shift + it.plane * a.dcb;
  Words<N> once = {}, twice = {}, xor_known = {};
  for (int j = 0; j < a.dcb; ++j) {
    const int b = __ldg(blocks + j);
    if (b >= a.nb) break;        // padded sockets (b == nb) end the row
    const long long src =
        ldpc::qc::slab(it.tile, b, rows, a.grid) +
        ldpc::qc::rotate_up(it.o, __ldg(shifts + j) * a.grid.tile, size);
    Words<N> v = {};
    if (kVal) v = ldpc::qc::load<N>(a.val + src);
    fold<kVal, N>(ldpc::qc::load<N>(a.known + src), v, once, twice,
                  xor_known);
  }
  const long long dst =
      ldpc::qc::slab(it.tile, it.plane, a.grid.planes * a.grid.lift,
                     a.grid) + it.o;
  Words<N> eo, ad;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    eo.v[l] = once.v[l] & ~twice.v[l];
    ad.v[l] = eo.v[l] & xor_known.v[l];
  }
  ldpc::qc::store_stream<N>(a.exactly_one + dst, eo);
  if (kVal) ldpc::qc::store_stream<N>(a.adopt + dst, ad);
}

template <bool kVal, int N>
void launch_check(const Args& a, long long blocks, cudaStream_t stream) {
  qc_check_exactly_one_kernel<kVal, N>
      <<<static_cast<unsigned int>(blocks), ldpc::kThreads, 0, stream>>>(a);
}

}  // namespace

// vec: the words a thread moves, 4 (the tile a multiple of 4, every plane
// 16-byte aligned) or 1; tile: the words of a column tile of the planes'
// tile-major layout (W: row-major planes; ops/qc_bp.py qc_bec_layout picks
// it for the decodes).
extern "C" int ldpc_qc_check_exactly_one(const void* known, const void* val,
                                         const void* chk_block,
                                         const void* chk_shift,
                                         void* exactly_one, void* adopt,
                                         int mb, int dcb, int nb, int lift,
                                         int words, int vec, int tile,
                                         void* stream) {
  const bool vec_ok =
      (vec == 4 && ldpc::qc::vector_ok(tile,
                                       {known, val, exactly_one, adopt}))
      || vec == 1;
  if ((val == nullptr) != (adopt == nullptr) || mb > ldpc::qc::kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(mb) * lift * words == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (!vec_ok || !ldpc::qc::tiles_fit(lift, words, tile, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = 0;
  const Args a{static_cast<const int32_t*>(known),
               static_cast<const int32_t*>(val),
               static_cast<const int32_t*>(chk_block),
               static_cast<const int32_t*>(chk_shift),
               static_cast<int32_t*>(exactly_one),
               static_cast<int32_t*>(adopt), dcb, nb,
               ldpc::qc::tile_grid(mb, lift, words, tile, vec, &blocks)};
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto fn = val == nullptr
                ? (vec == 4 ? launch_check<false, 4> : launch_check<false, 1>)
                : (vec == 4 ? launch_check<true, 4> : launch_check<true, 1>);
  fn(a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
