// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every packed plane is int32[rows, W] in row-major order: word w of row r
// holds trials 32*w .. 32*w+31, trial b in bit b % 32 (the JAX package's
// layout, ops/bitops.py:3-5).  Kernels read and write the words as uint32
// bit patterns; the int32 type is only what PyTorch stores.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ldpc {

constexpr int kThreads = 256;

// Blocks for a grid-stride loop over `total` items: enough to fill the
// 132 SMs several times over, never more than the items need.
inline unsigned int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

// A 1-D grid over a row-major [rows, W] plane in items of N adjacent words
// of one row, one item a thread, in the plane's order: a warp's 32 items
// are contiguous bytes, and a row's N words share its table entries.  Every
// index fits 32 bits: a launch holds rows * W below 2^30 (row_grid_fits).
struct RowGrid {
  int rows;
  int groups;   // W / N: items a row
};

inline bool row_grid_fits(int rows, int words, int vec) {
  return rows >= 0 && vec > 0 && words % vec == 0 &&
         static_cast<long long>(rows) * words < (1LL << 30);
}

// The grid of `rows` rows of `words` words at N = `vec`; `blocks` its size.
inline RowGrid row_grid(int rows, int words, int vec, unsigned int* blocks) {
  const RowGrid g{rows, words / vec};
  *blocks = static_cast<unsigned int>(
      (static_cast<long long>(rows) * g.groups + kThreads - 1) / kThreads);
  return g;
}

struct RowItem {
  int row;
  int w;       // the item's first word in its row
  bool live;   // row < rows
};

// This thread's item of N words.
template <int N>
__device__ __forceinline__ RowItem row_item(const RowGrid& g) {
  const int i = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  const int row = i / g.groups;
  return RowItem{row, (i - row * g.groups) * N, row < g.rows};
}

// The row grid taken in column tiles of `tile` words (a multiple of N that
// divides W; W itself: row_item's order): tile slowest, then row, then the
// item in the row's slice of the tile.  The blocks resident at one time work
// on one or two tiles, so the rows they gather stay in L2 while a plane that
// is gathered whole would not.
template <int N>
__device__ __forceinline__ RowItem tiled_row_item(const RowGrid& g,
                                                  int tile) {
  const int i = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  const int groups = tile / N;             // items a row of a tile
  const int per_tile = g.rows * groups;
  const int t = i / per_tile;
  const int rem = i - t * per_tile;
  const int row = rem / groups;
  return RowItem{row, t * tile + (rem - row * groups) * N,
                 t < g.groups * N / tile};
}

// Philox4x32-10 (Salmon et al., SC'11; the Random123 reference rounds):
// counter (c0, c1, c2, c3), key (k0, k1).  Known answer: counter 0, key 0
// gives (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8).
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

}  // namespace ldpc
