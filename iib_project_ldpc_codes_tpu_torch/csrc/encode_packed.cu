// Kernel E: systematic encoding of bit-packed information planes.
//
// Replaces iib_project_ldpc_codes_tpu/models/encode.py:110-146
// (encode_packed, a lax.scan over information rows with a [rank, W] carry,
// then two scatters).  For parity row r and word w of a code's words:
//   parity      = XOR over information rows j with mask bit (r, j) set
//                 of info[j, w]
//   out[pivots[r], w] = parity,   out[free[j], w] = info[j, w]
// with entries equal to the sentinel n (padding of a batch) dropped.  The
// mask is the parity map bit-packed, int32[(C,) rank, kw] (bit j % 32 of
// word j / 32); a batch of C codes reads code w / wpc's mask, free and
// pivot rows for word w, as K2/K3 read their tables.
//
// Design: the method of Four Russians in shared memory.  A block owns one
// output tile: up to 32 words of one code (lane = word) by R = 32 * warps
// parity rows (32 rows a warp, one accumulator register a row).  It walks
// the information rows in chunks of 32 (one mask word a parity row):
//   1. the chunk's 32 x 32-word slice of info is staged into shared memory
//      by cp.async one chunk ahead (double-buffered), and every 8 chunks
//      the tile rows' next 8 mask words likewise, 8 words of a row side by
//      side (coalesced), stored transposed as [8][R];
//   2. from the slice the block builds four 256-entry tables, one per
//      group of 8 rows: entry e of table t holds, for each word, the XOR of
//      the rows 8t + b with bit b of e set.  A warp builds a run of 32
//      entries in Gray-code order, one XOR and one store an entry (128 KB).
//      Tables 2p and 2p + 1 are interleaved, entry by entry, so that entry
//      e starts at byte e * 256 of its pair;
//   3. each warp then walks its 32 rows: four rows' mask words come in one
//      broadcast 16-byte shared load, and for each byte of a row's word one
//      byte permute (__byte_perm of the word and 4 * lane) forms the lane's
//      offset in the selected entry, and one 4-byte shared load fetches it
//      (32 consecutive words, no bank conflicts): two instructions a
//      lookup besides the XOR.
// So info leaves L2 once per row tile (not once per set mask bit, which
// bound the first design at ~31 GB of L2 re-reads, 6.6 ms on the H100 at
// n = 1e4), and
// the work is one shared-memory lookup per (parity row, group of 8, word).
// Extra blocks of the same grid copy the information rows to their free
// columns.  The host picks R (1024, 512, 256 or 128 rows) so that the
// tiles fill the card: a block holds 202 KB of shared memory, one a SM.
//
// Bound on the H100 at n = 1e4 (rank = k = 5000, W = 768): shared memory.
// The lookups are 5000 * 625 * 768 = 2.4e9 4-byte shared-memory reads,
// ~0.3 ms at 128 B/clk/SM, and the table builds add one store per four
// lookups at R = 1024.  By operations, the Four-Russians count (lookups
// plus the 625 * 256 * 768 table entries of one pass) is ~0.075 ms at
// 33.5 Tops/s INT32; the bytes (15 MB of info, 3 MB of mask, 31 MB out)
// ~0.015 ms.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;                 // information rows a chunk
constexpr int kGroups = kChunk / 8;        // tables a chunk
constexpr int kLanes = 32;                 // words a tile
constexpr int kTableWords = 256 * kLanes;  // one table
// Tables 2p and 2p + 1 are interleaved: entry e of table t at word
// (t / 2) * kPairBytes / 4 + e * kEntryWords + (t % 2) * 32 + lane, so the
// entry of byte value e starts at byte e * 256 of its pair.
constexpr int kEntryWords = 2 * kLanes;
constexpr int kPairBytes = 2 * kTableWords * 4;
constexpr int kMaxWarps = 32;
constexpr int kMaxRows = kMaxWarps * 32;   // parity rows a tile
constexpr int kMaskWords = 8;              // mask words staged at once
// a row of the transposed mask stage, padded so that the 8 words of one
// parity row land in 8 different banks
constexpr int kMaskStride = kMaxRows + 4;
constexpr int kMaskStage = kMaskWords * kMaskStride;
constexpr int kSharedBytes =
    (kGroups * kTableWords + 2 * kChunk * kLanes + 2 * kMaskStage) * 4;

// Trailing zeros of a positive constant (the Gray-code step's bit).
__host__ __device__ constexpr int trailing_zeros(int x) {
  return (x & 1) ? 0 : 1 + trailing_zeros(x >> 1);
}

__device__ __forceinline__ uint32_t entry_at(const char* base,
                                             uint32_t offset) {
  return *reinterpret_cast<const uint32_t*>(base + offset);
}

__device__ __forceinline__ void stage_word(uint32_t* dst, const int32_t* src,
                                           bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0));
}

// Stage information rows chunk * 32 .. +31 of the tile's words into `dst`
// [32 rows][32 lanes]; rows past k and lanes past the tile read as zero.
__device__ __forceinline__ void stage_chunk(uint32_t* dst,
                                            const int32_t* info, int chunk,
                                            int k, int words, int w0,
                                            int width) {
  for (int idx = threadIdx.x; idx < kChunk * kLanes; idx += blockDim.x) {
    const int j = chunk * kChunk + idx / kLanes;
    const int lane = idx % kLanes;
    const bool valid = j < k && lane < width;
    stage_word(dst + idx,
               valid ? info + static_cast<long long>(j) * words + w0 + lane
                     : info,
               valid);
  }
}

// Stage mask words 8s .. 8s+7 of the tile's `rows` parity rows into `dst`
// [8][kMaskStride] (word q of row r at q * kMaskStride + r); words past kw
// read as zero, and rows past the tile are not staged.
__device__ __forceinline__ void stage_masks(uint32_t* dst,
                                            const int32_t* mask_rows, int s,
                                            int kw, int rows) {
  for (int idx = threadIdx.x; idx < rows * kMaskWords; idx += blockDim.x) {
    const int r = idx / kMaskWords, q = idx % kMaskWords;
    const bool valid = s * kMaskWords + q < kw;
    stage_word(dst + q * kMaskStride + r,
               valid ? mask_rows + static_cast<long long>(r) * kw +
                           s * kMaskWords + q
                     : mask_rows,
               valid);
  }
}

__global__ void __launch_bounds__(kMaxRows, 1)
    encode_packed_kernel(const int32_t* __restrict__ info,
                         const int32_t* __restrict__ mask,
                         const int32_t* __restrict__ free_cols,
                         const int32_t* __restrict__ pivots,
                         int32_t* __restrict__ out, int n, int rank, int k,
                         int kw, int words, int wpc, int tiles_per_code,
                         int row_tiles) {
  extern __shared__ uint32_t smem[];
  uint32_t* tables = smem;  // [2 pairs][256 entries][2 tables][32 lanes]
  uint32_t* stage = smem + kGroups * kTableWords;   // [2][32][32]
  uint32_t* mask_stage = stage + 2 * kChunk * kLanes;  // [2][8][R + 4]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rows_per_block = blockDim.x;            // 32 rows a warp
  const long long code = blockIdx.x / tiles_per_code;
  const int w0 = static_cast<int>(code * wpc) +
                 (blockIdx.x % tiles_per_code) * kLanes;
  const int width = min(kLanes, static_cast<int>((code + 1) * wpc) - w0);
  const bool active = lane < width;
  const long long w = w0 + lane;

  if (static_cast<int>(blockIdx.y) >= row_tiles) {  // free-column copy
    const int j0 = (blockIdx.y - row_tiles) * rows_per_block + warp * 32;
    if (!active) return;
    for (int i = 0; i < 32 && j0 + i < k; ++i) {
      const int j = j0 + i;
      const int target = __ldg(free_cols + code * k + j);
      if (target < n) {
        out[static_cast<long long>(target) * words + w] =
            __ldg(info + static_cast<long long>(j) * words + w);
      }
    }
    return;
  }

  const int tile_row0 = blockIdx.y * rows_per_block;
  const int tile_rows = min(rows_per_block, rank - tile_row0);
  const int32_t* mask_rows = mask + (code * rank + tile_row0) * kw;
  uint32_t acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0u;

  if (kw > 0) {
    stage_chunk(stage, info, 0, k, words, w0, width);
    stage_masks(mask_stage, mask_rows, 0, kw, tile_rows);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int c = 0; c < kw; ++c) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // chunk c staged; chunk c - 1's lookups are done
    if (c + 1 < kw) {
      stage_chunk(stage + ((c + 1) & 1) * kChunk * kLanes, info, c + 1, k,
                  words, w0, width);
      if ((c + 1) % kMaskWords == 0) {
        const int s = (c + 1) / kMaskWords;
        stage_masks(mask_stage + (s & 1) * kMaskStage, mask_rows, s, kw,
                    tile_rows);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const uint32_t* rows = stage + (c & 1) * kChunk * kLanes;
    for (int run = warp; run < kGroups * 8; run += blockDim.x / 32) {
      const int t = run / 8, high = run % 8;
      uint32_t r[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) r[b] = rows[(t * 8 + b) * kLanes + lane];
      uint32_t v = ((high & 1) ? r[5] : 0u) ^ ((high & 2) ? r[6] : 0u) ^
                   ((high & 4) ? r[7] : 0u);
      uint32_t* entry = tables + (t / 2) * (kPairBytes / 4) +
                        high * 32 * kEntryWords + (t % 2) * kLanes + lane;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        entry[(i ^ (i >> 1)) * kEntryWords] = v;  // Gray: one bit a step
        if (i < 31) v ^= r[trailing_zeros(i + 1)];
      }
    }
    __syncthreads();  // the four tables are built
    // rows past rank read stale mask words: their pivots are sentinels
    const uint4* masks = reinterpret_cast<const uint4*>(
        mask_stage + ((c / kMaskWords) & 1) * kMaskStage +
        (c % kMaskWords) * kMaskStride + warp * 32);
    const char* tb = reinterpret_cast<const char*>(tables);
    const uint32_t lane4 = lane * 4u;
#pragma unroll
    for (int i4 = 0; i4 < 8; ++i4) {
      const uint4 m4 = masks[i4];
      const uint32_t ms[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // one byte permute forms (byte t of m) * 256 + 4 * lane, the
        // offset of the lane's word in entry byte_t of table t's pair
        const uint32_t m = ms[q];
        acc[i4 * 4 + q] ^= entry_at(tb, __byte_perm(m, lane4, 0x5504)) ^
                           entry_at(tb + 128, __byte_perm(m, lane4, 0x5514)) ^
                           entry_at(tb + kPairBytes,
                                    __byte_perm(m, lane4, 0x5524)) ^
                           entry_at(tb + kPairBytes + 128,
                                    __byte_perm(m, lane4, 0x5534));
      }
    }
  }

  const int row0 = tile_row0 + warp * 32;
  const bool lane_row = row0 + lane < rank;
  const int my_pivot = lane_row ? __ldg(pivots + code * rank + row0 + lane)
                                : n;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int target = __shfl_sync(0xffffffffu, my_pivot, i);
    if (active && target < n) {                      // padded rows drop
      out[static_cast<long long>(target) * words + w] =
          static_cast<int32_t>(acc[i]);
    }
  }
}

// Rows a block: the largest of 1024 / 512 / 256 / 128 whose grid takes no
// more waves of the card's SMs (one block an SM) times the block's
// per-chunk work (4 lookups a row, 1024 table entries).
int pick_warps(long long word_tiles, int rank) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int best = kMaxWarps;
  long long best_cost = -1;
  for (int warps = kMaxWarps; warps >= 4; warps /= 2) {
    const long long rows = warps * 32LL;
    const long long tiles = word_tiles * ((rank + rows - 1) / rows);
    const long long cost = (tiles + sms - 1) / sms * (4 * rows + 1024);
    if (best_cost < 0 || cost < best_cost) {
      best = warps;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

extern "C" int ldpc_encode_packed(const void* info, const void* mask,
                                  const void* free_cols, const void* pivots,
                                  void* out, int n, int rank, int k, int kw,
                                  int words, int wpc, void* stream) {
  if (words <= 0 || wpc <= 0 || rank + k <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles_per_code = (wpc + kLanes - 1) / kLanes;
  const long long word_tiles =
      static_cast<long long>(words / wpc) * tiles_per_code;
  const int warps = pick_warps(word_tiles, rank);
  const int rows = warps * 32;
  const int row_tiles = (rank + rows - 1) / rows;
  const int copy_tiles = (k + rows - 1) / rows;
  cudaError_t err = cudaFuncSetAttribute(
      encode_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(word_tiles),
                  static_cast<unsigned>(row_tiles + copy_tiles));
  encode_packed_kernel<<<grid, rows, kSharedBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(info), static_cast<const int32_t*>(mask),
      static_cast<const int32_t*>(free_cols),
      static_cast<const int32_t*>(pivots), static_cast<int32_t*>(out), n,
      rank, k, kw, words, wpc, tiles_per_code, row_tiles);
  return static_cast<int>(cudaGetLastError());
}
