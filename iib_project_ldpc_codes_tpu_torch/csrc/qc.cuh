// Shared by the quasi-cyclic (circulant-index) kernels:
// qc_check_exactly_one.cu, qc_variable_or.cu, qc_gallager_check.cu,
// qc_gallager_variable.cu (vector_ok and kMaxPlanes only: Q4 has a layout
// of its own) and the QC soft passes (row_plus, row_minus, Words); the
// generic BEC round's gathers, check_exactly_one.cu, variable_or_update.cu
// and edge_candidates.cu, take Words, load, store, store_stream and
// vector_ok only.
//
// Every pass here works on [Z, W] planes of packed words, one plane per base
// node.  Q3 runs grid_for_planes: blockIdx.y is the base check, so its base
// table entries are uniform across the block (broadcast loads), and the x
// dimension runs a grid-stride loop over the plane's Z * (W / N) items of N
// adjacent words.  The BEC round (Q1, Q2) runs on tile-major planes, the
// column-tile grid below.  Inside a plane every index fits 32 bits (the
// wrappers hold n * W * 32 below 2^31); only plane starts are 64-bit.  N =
// 4 (16-byte loads and stores) when W is a multiple of 4 and every plane
// pointer is 16-byte aligned, else N = 1.
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace ldpc {
namespace qc {

template <int N>
struct alignas(4 * N) Words {
  uint32_t v[N];
};

template <int N>
__device__ __forceinline__ Words<N> load(const int32_t* p) {
  return *reinterpret_cast<const Words<N>*>(p);
}

template <int N>
__device__ __forceinline__ void store(int32_t* p, const Words<N>& w) {
  *reinterpret_cast<Words<N>*>(p) = w;
}

// Row (z + shift) mod Z, for 0 <= z, shift < Z: one conditional subtract.
__device__ __forceinline__ int row_plus(int z, int shift, int lift) {
  const int zz = z + shift;
  return zz >= lift ? zz - lift : zz;
}

// Row (z - shift) mod Z, for 0 <= z, shift < Z: one conditional add, never
// a negative `%`.
__device__ __forceinline__ int row_minus(int z, int shift, int lift) {
  const int zz = z - shift;
  return zz < 0 ? zz + lift : zz;
}

// Blocks along x for `planes` planes of `items` items each: enough in all to
// fill the 132 SMs several times over, never more than the items need.
inline dim3 grid_for_planes(long long items, int planes) {
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = (132LL * 32 + planes - 1) / planes;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned int>(blocks),
              static_cast<unsigned int>(planes), 1);
}

constexpr int kMaxPlanes = 65535;   // gridDim.y

// True when N = 4 may be used: W a multiple of 4 and every (non-null)
// pointer 16-byte aligned.
inline bool vector_ok(int words, std::initializer_list<const void*> ptrs) {
  if (words % 4) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// The streaming path, for the planes the BEC round reads or writes once
// ---------------------------------------------------------------------------

// Of a plane read once and not again in the pass: the streaming path
// (ld.global.cs, evict first from L1 and L2).
template <int N>
__device__ __forceinline__ Words<N> load_stream(const int32_t* p) {
  Words<N> r;
  if constexpr (N == 4) {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
    r.v[0] = x.x, r.v[1] = x.y, r.v[2] = x.z, r.v[3] = x.w;
  } else {
    r.v[0] = __ldcs(p);
  }
  return r;
}

// Of a plane written once: st.global.cs.
template <int N>
__device__ __forceinline__ void store_stream(int32_t* p, const Words<N>& r) {
  if constexpr (N == 4) {
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(r.v[0], r.v[1], r.v[2], r.v[3]));
  } else {
    __stcs(p, static_cast<int32_t>(r.v[0]));
  }
}

// ---------------------------------------------------------------------------
// The column tiles of the BEC round (Q1, Q2)
// ---------------------------------------------------------------------------
//
// Every word column of the planes is an independent decode of 32 trials, so
// a pass may take the columns in any order.  A column tile is `tile`
// adjacent words of every row (tile divides W).  The planes of Q1 and Q2
// are stored tile-major: tile t of an array of R rows is the R * tile words
// from t * R * tile, its row r at r * tile (ops/qc_bp.py to_tiles); so a
// tile of one base node's plane is a [Z, tile] slab, contiguous, and
// row-major planes are the case of one tile of W words.
//
// The grid is 1-D with the tile as its slowest coordinate; blocks launch in
// index order, so the blocks resident at one time work on one or two tiles
// across every plane and row: a tile of the planes a pass reads again (Q1
// `known`, Q2 the exactly-one plane) stays in L2 until its last read, and a
// warp reads 32 consecutive items, contiguous bytes.  Inside a tile, the
// plane, then the block; a block is kThreads items of N words of one
// plane (its base table entries uniform), z major.
struct TileGrid {
  int planes;   // planes of the pass's output
  int lift;     // Z
  int tile;     // words of a tile
  int groups;   // tile / N: items a row of a tile
  int blocks;   // blocks per (tile, plane)
};

// The grid of `planes` planes of [Z, W] words in tiles of `tile` words at N
// = `vec`; `blocks_total` its 1-D size.
inline TileGrid tile_grid(int planes, int lift, int words, int tile, int vec,
                          long long* blocks_total) {
  TileGrid g{planes, lift, tile, tile / vec, 0};
  const long long items = static_cast<long long>(lift) * g.groups;
  g.blocks = static_cast<int>((items + kThreads - 1) / kThreads);
  *blocks_total = static_cast<long long>(words / tile) * planes * g.blocks;
  return g;
}

struct TileItem {
  int tile;    // t
  int plane;   // the pass's plane (base check or variable block)
  int o;       // z * tile + w: the item's word offset in its [Z, tile] slab
  bool live;   // z < Z
};

// This thread's item of N words.
template <int N>
__device__ __forceinline__ TileItem tile_item(const TileGrid& g) {
  const int q = blockIdx.x / g.blocks;
  const int block = blockIdx.x - q * g.blocks;
  const int t = q / g.planes;
  const int i = block * kThreads + threadIdx.x;
  const int z = i / g.groups;
  return TileItem{t, q - t * g.planes, z * g.tile + (i - z * g.groups) * N,
                  z < g.lift};
}

// Word offset of slab `plane` of tile `t` in a tile-major array of `rows`
// rows.
__device__ __forceinline__ long long slab(int t, int plane, int rows,
                                          const TileGrid& g) {
  return (static_cast<long long>(t) * rows + static_cast<long long>(plane) *
          g.lift) * g.tile;
}

// Offset, in a socket's [Z, tile] slab, of the word at `o` for a circulant
// index that rotates the flat slab by `rot` = s * tile words (0 <= o, rot <
// size): row (z + s) mod Z by +rot (Q1), row (z - s) mod Z by -rot (Q2);
// one conditional subtract or add, no row, no division.  N words never
// cross the wrap (N divides the tile).
__device__ __forceinline__ int rotate_up(int o, int rot, int size) {
  const int r = o + rot;
  return r >= size ? r - size : r;
}

__device__ __forceinline__ int rotate_down(int o, int rot, int size) {
  const int r = o - rot;
  return r < 0 ? r + size : r;
}

// True when a launch fits: N and the tile divide W, N divides the tile, and
// a plane of Z * W words is below 2^30 (an offset plus a rotation stays
// below 2^31).
inline bool tiles_fit(int lift, int words, int tile, int vec) {
  return tile > 0 && words % tile == 0 && tile % vec == 0
         && static_cast<long long>(lift) * words < (1LL << 30);
}

}  // namespace qc
}  // namespace ldpc
