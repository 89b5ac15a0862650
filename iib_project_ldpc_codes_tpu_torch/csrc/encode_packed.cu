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
// Bound on the H100: operations.  Dense, the parity costs rank * k_eff * W
// AND+XOR pairs (3.84e10 at n = 1e4, rank = k_eff = 5000, W = 768: 1.15 ms
// at 33.5 Tops/s); the bytes (15 MB of info, 3 MB of mask, 31 MB out)
// take ~0.015 ms.  This first design walks the set bits of each mask word
// (__ffs), so a thread does one XOR and one 4-byte load per set bit (40%
// of the map at n = 1e4) and none for the zeros.  A block is 32 words x 8
// rows: the 32 lanes of a warp take 32 consecutive words of one row r, so
// the mask word is one broadcast load (one code per warp when the code
// has >= 32 words) and each info load is a coalesced 128-byte row segment
// that the block's 8 rows share through L1.  Rows rank .. rank+k-1 of the
// grid copy the information rows to their free columns.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void encode_packed_kernel(const int32_t* __restrict__ info,
                                     const int32_t* __restrict__ mask,
                                     const int32_t* __restrict__ free_cols,
                                     const int32_t* __restrict__ pivots,
                                     int32_t* __restrict__ out, int n,
                                     int rank, int k, int kw, int words,
                                     int wpc) {
  const int w = blockIdx.x * 32 + threadIdx.x;
  const int row = blockIdx.y * kRowsPerBlock + threadIdx.y;
  if (w >= words) return;
  const long long code = w / wpc;
  if (row < rank) {
    const int target = __ldg(pivots + code * rank + row);
    if (target >= n) return;                       // a padded parity row
    const int32_t* bits_of = mask + (code * rank + row) * kw;
    uint32_t parity = 0u;
    for (int q = 0; q < kw; ++q) {
      uint32_t bits = static_cast<uint32_t>(__ldg(bits_of + q));
      while (bits != 0u) {
        const int j = q * 32 + __ffs(static_cast<int>(bits)) - 1;
        parity ^= static_cast<uint32_t>(
            __ldg(info + static_cast<long long>(j) * words + w));
        bits &= bits - 1u;
      }
    }
    out[static_cast<long long>(target) * words + w] =
        static_cast<int32_t>(parity);
  } else if (row < rank + k) {
    const int j = row - rank;
    const int target = __ldg(free_cols + code * k + j);
    if (target < n) {
      out[static_cast<long long>(target) * words + w] =
          __ldg(info + static_cast<long long>(j) * words + w);
    }
  }
}

}  // namespace

extern "C" int ldpc_encode_packed(const void* info, const void* mask,
                                  const void* free_cols, const void* pivots,
                                  void* out, int n, int rank, int k, int kw,
                                  int words, int wpc, void* stream) {
  const int rows = rank + k;
  if (words > 0 && rows > 0) {
    const dim3 block(32, kRowsPerBlock);
    const dim3 grid((words + 31) / 32,
                    (rows + kRowsPerBlock - 1) / kRowsPerBlock);
    encode_packed_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(info), static_cast<const int32_t*>(mask),
        static_cast<const int32_t*>(free_cols),
        static_cast<const int32_t*>(pivots), static_cast<int32_t*>(out), n,
        rank, k, kw, words, wpc);
  }
  return static_cast<int>(cudaGetLastError());
}
