// K4: per-trial bit counts down the rows of a packed plane.
//
// Replaces iib_project_ldpc_codes_tpu/ops/bitops.py:50-60 (per_trial_counts)
// and the final counters of ops/erasure_bp.py:173-183
// (PackedBPResult.failed / bit_errors):
//   counts[32*w + b] = number of rows r with bit b of words[r, w] set.
// `failed` is counts > 0; the chunk statistics follow from the counts.
//
// Bound on the H100: bytes, n*W*4 read once.  The counts need about 5
// logic operations a word (a bit-sliced carry-save counter), well under
// that; this kernel spends 32 shift-and-add counter updates on every word
// (109 integer instructions in its SASS), so its instruction issue, not
// the bytes, sets its time.  A block is 32 columns x 8 row-walkers: lane
// = column, so each warp load is 128 contiguous bytes; each thread keeps
// its column's 32 counters in registers while it strides down the rows.
// The 8 walkers are summed in shared memory (padded to 33 to avoid bank
// conflicts), and the row range is split over gridDim.y blocks whose
// partial sums meet in int32 atomics, exact in any order.  The output
// must be zeroed by the caller.
#include "common.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kWalkers = 8;

__global__ void per_trial_counts_kernel(const int32_t* __restrict__ words,
                                        int32_t* __restrict__ counts, int n,
                                        int w_total) {
  __shared__ int partial[kWalkers][kCols][33];
  const int lane = threadIdx.x;
  const int walker = threadIdx.y;
  const int w = blockIdx.x * kCols + lane;
  int cnt[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) cnt[b] = 0;
  if (w < w_total) {
    for (long long r = static_cast<long long>(blockIdx.y) * kWalkers + walker;
         r < n; r += static_cast<long long>(gridDim.y) * kWalkers) {
      const uint32_t x = static_cast<uint32_t>(__ldg(words + r * w_total + w));
#pragma unroll
      for (int b = 0; b < 32; ++b) cnt[b] += (x >> b) & 1u;
    }
  }
#pragma unroll
  for (int b = 0; b < 32; ++b) partial[walker][lane][b] = cnt[b];
  __syncthreads();
  const int tid = walker * kCols + lane;
  for (int o = tid; o < kCols * 32; o += kCols * kWalkers) {
    const int col = o >> 5, bit = o & 31;
    int sum = 0;
#pragma unroll
    for (int y = 0; y < kWalkers; ++y) sum += partial[y][col][bit];
    const int wc = blockIdx.x * kCols + col;
    if (wc < w_total && sum != 0) atomicAdd(counts + wc * 32 + bit, sum);
  }
}

}  // namespace

extern "C" int ldpc_per_trial_counts(const void* words, void* counts, int n,
                                     int w_total, void* stream) {
  if (n > 0 && w_total > 0) {
    const int xblocks = (w_total + kCols - 1) / kCols;
    // about four blocks per SM in all, each walking at least 8 rows
    int yblocks = (4 * 132 + xblocks - 1) / xblocks;
    const int max_y = (n + kWalkers - 1) / kWalkers;
    if (yblocks > max_y) yblocks = max_y;
    if (yblocks < 1) yblocks = 1;
    per_trial_counts_kernel<<<dim3(xblocks, yblocks), dim3(kCols, kWalkers),
                              0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), static_cast<int32_t*>(counts), n,
        w_total);
  }
  return static_cast<int>(cudaGetLastError());
}
