// K4: per-trial bit counts down the rows of a packed plane.
//
// Replaces iib_project_ldpc_codes_tpu/ops/bitops.py:50-60 (per_trial_counts)
// and the final counters of ops/erasure_bp.py:173-183
// (PackedBPResult.failed / bit_errors):
//   counts[32*w + b] = number of rows r with bit b of words[r, w] set.
// `failed` is counts > 0; the chunk statistics follow from the counts.
//
// Bound on the H100: bytes, n*W*4 read once.  The counts need a few logic
// operations a word, and this kernel spends about that: a bit-sliced
// (carry-save) counter.  A thread owns one column and walks a run of R
// rows, 16 at a time: it issues the 16 loads first (64 bytes in flight a
// thread), then adds the 16 words into its bit planes of weight 1, 2, 4
// and 8 by a Harley-Seal tree of 15 full adders (two LOP3 each: sum a ^ b
// ^ c, carry maj(a, b, c)), whose weight-16 carry ripples into planes of
// weight 16 to 128.  After its run (R <= 128) it reads the 32 counts out of
// its eight planes into byte lanes (count of bit j + 8k in byte k of word
// j: shift, mask, shift-add a plane a word), once.  A block is 32 columns
// (lane = column, so each warp load is 128 contiguous bytes) x 8 walkers
// (one a warp) on consecutive runs; the walkers' byte lanes meet in shared
// memory, widened to 16-bit lanes, and each block adds its sums into the
// output with int32 atomics, exact in any order.  The host picks R, the
// largest of 128, 64, 32, 16 that still gives at least kMinBlocks blocks.
// The output must be zeroed by the caller.
#include "common.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kWalkers = 8;
constexpr int kGroup = 16;
constexpr int kMaxRun = 128;    // planes up to weight 128: byte lanes hold it
constexpr int kMinBlocks = 132;

// full adder on 32 bit positions: l = a ^ b ^ c, h = maj(a, b, c)
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                   uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// Adds 16 words of weight 1 into the planes p[0..8) of weight 1..128.
__device__ __forceinline__ void add16(const uint32_t (&d)[kGroup],
                                      uint32_t (&p)[8]) {
  uint32_t twos_a, twos_b, fours_a, fours_b, eights_a, eights_b, sixteens;
  csa(twos_a, p[0], p[0], d[0], d[1]);
  csa(twos_b, p[0], p[0], d[2], d[3]);
  csa(fours_a, p[1], p[1], twos_a, twos_b);
  csa(twos_a, p[0], p[0], d[4], d[5]);
  csa(twos_b, p[0], p[0], d[6], d[7]);
  csa(fours_b, p[1], p[1], twos_a, twos_b);
  csa(eights_a, p[2], p[2], fours_a, fours_b);
  csa(twos_a, p[0], p[0], d[8], d[9]);
  csa(twos_b, p[0], p[0], d[10], d[11]);
  csa(fours_a, p[1], p[1], twos_a, twos_b);
  csa(twos_a, p[0], p[0], d[12], d[13]);
  csa(twos_b, p[0], p[0], d[14], d[15]);
  csa(fours_b, p[1], p[1], twos_a, twos_b);
  csa(eights_b, p[2], p[2], fours_a, fours_b);
  csa(sixteens, p[3], p[3], eights_a, eights_b);
  // a run of at most 128 rows adds at most 8 sixteens: no carry out of p[7]
#pragma unroll
  for (int k = 4; k < 8; ++k) {
    const uint32_t carry = p[k] & sixteens;
    p[k] ^= sixteens;
    sixteens = carry;
  }
}

__global__ void __launch_bounds__(kCols * kWalkers)
per_trial_counts_kernel(const int32_t* __restrict__ words,
                        int32_t* __restrict__ counts, int n, int w_total,
                        int run, int runs) {
  __shared__ uint32_t partial[kWalkers][kCols][9];   // 9: no bank conflicts
  const int lane = threadIdx.x;
  const int walker = threadIdx.y;
  const int w = blockIdx.x * kCols + lane;
  const int tid = walker * kCols + lane;
  const int col = tid >> 3, j = tid & 7;
  // the y grid strides over the blocks of runs (at most 65,535 at a time)
  for (int yb = blockIdx.y; yb * kWalkers < runs; yb += gridDim.y) {
    uint32_t p[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    const long long r0 = (static_cast<long long>(yb) * kWalkers + walker) *
                         run;
    const long long r1 = r0 + run < n ? r0 + run : n;
    if (w < w_total && r0 < r1) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(words) +
                            r0 * w_total + w;
      long long r = r0;
      for (; r + kGroup <= r1; r += kGroup) {
        uint32_t d[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          d[k] = __ldg(src + static_cast<long long>(k) * w_total);
        src += static_cast<long long>(kGroup) * w_total;
        add16(d, p);
      }
      if (r < r1) {                     // the run's last rows, zero-padded
        uint32_t d[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          d[k] = r + k < r1
                     ? __ldg(src + static_cast<long long>(k) * w_total)
                     : 0u;
        add16(d, p);
      }
    }
    // byte k of the j-th word: the count of bit j + 8k
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      uint32_t acc = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += ((p[k] >> b) & 0x01010101u) << k;
      partial[walker][lane][b] = acc;
    }
    __syncthreads();
    // thread (col, j) sums the walkers' byte lanes in 16-bit lanes (at most
    // 8 x 128 a lane) and adds the four counts it holds
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int y = 0; y < kWalkers; ++y) {
      const uint32_t x = partial[y][col][j];
      lo += x & 0x00FF00FFu;
      hi += (x >> 8) & 0x00FF00FFu;
    }
    __syncthreads();
    const int wc = blockIdx.x * kCols + col;
    if (wc < w_total) {
      int32_t* c = counts + static_cast<long long>(wc) * 32;
      if (lo & 0xFFFFu) atomicAdd(c + j, static_cast<int>(lo & 0xFFFFu));
      if (hi & 0xFFFFu) atomicAdd(c + j + 8, static_cast<int>(hi & 0xFFFFu));
      if (lo >> 16) atomicAdd(c + j + 16, static_cast<int>(lo >> 16));
      if (hi >> 16) atomicAdd(c + j + 24, static_cast<int>(hi >> 16));
    }
  }
}

}  // namespace

extern "C" int ldpc_per_trial_counts(const void* words, void* counts, int n,
                                     int w_total, void* stream) {
  if (n > 0 && w_total > 0) {
    const int xblocks = (w_total + kCols - 1) / kCols;
    auto yblocks = [n](int run) {
      return (n + kWalkers * run - 1) / (kWalkers * run);
    };
    int run = kMaxRun;
    while (run > kGroup &&
           static_cast<long long>(xblocks) * yblocks(run) < kMinBlocks)
      run /= 2;
    const int y = yblocks(run);
    per_trial_counts_kernel<<<dim3(xblocks, y < 65535 ? y : 65535),
                              dim3(kCols, kWalkers), 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), static_cast<int32_t*>(counts), n,
        w_total, run, (n + run - 1) / run);
  }
  return static_cast<int>(cudaGetLastError());
}
