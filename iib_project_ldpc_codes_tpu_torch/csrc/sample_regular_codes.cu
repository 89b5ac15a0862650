// K5: a batch of (dv,dc)-regular codes per Monte Carlo chunk.
//
// Replaces iib_project_ldpc_codes_tpu/models/ensemble.py:61-156
// (match_until_simple + _regular_matching, vmapped by sample_codes at
// :175-187) and the stable argsort of models/code.py:71-91.  One block
// samples one code and writes all three tables:
//   chk_to_var[c, e]      = perm[e] / dv                  (int32[C, m, dc])
//   var_to_edge[c, v, :]  = inv[v*dv .. v*dv+dv-1], sorted (int32[C, n, dv])
//   var_to_chk[c, v, k]   = var_to_edge[c, v, k] / dc
// where perm is the socket permutation after the method's loop and inv its
// inverse.  Since perm is a permutation, variable v's edges are exactly
// inv[v*dv + k]; sorting those dv values gives the stable argsort without
// a global sort.
//
// Draws (the port's models/ensemble.py documents them and its plain
// version runs the same arithmetic): Philox4x32-10 with the sampler key,
// counter (d >> 1, code, chunk, stream); draw d is lanes (x, y) for even d
// and (z, w) for odd d as lo | hi << 32; a uniform integer below `bound`
// is __umul64hi(draw, bound).  Fisher-Yates from the identity swaps
// positions i and uniform(draw i of stream `attempt`, i + 1) for
// i = E-1 .. 1; repair pass p swaps the first duplicate with
// uniform(draw p of stream 2^31, E).
//
// Bound on the H100: latency of the sequential shuffle.  Fisher-Yates is
// E dependent swaps, so one thread performs them; the other threads draw
// the partners of the next kTile positions in parallel (the partners do
// not depend on the permutation), so the serial thread does only two
// loads and two stores per step.  The permutation sits in shared memory
// when 4 * E bytes fit beside the tile (E <= 56,000: n <= 18,666 at
// dv = 3) and in a global scratch buffer otherwise (same code, slower).
// The duplicate scan runs on all threads, one check row each, with a
// shared atomicMin for the first offender; the repair swap is one thread.
// Every loop condition is block-uniform (read from shared memory after a
// barrier), so the barriers inside the loops are safe.  One block per code;
// at n = 1e4 a block holds 124 KB of shared memory, so one block per SM.
#include "sampler.cuh"

namespace {

using namespace ldpc::sampler;

// Flat check-socket index of the first socket whose variable repeats an
// earlier socket of its check row, or E when the permutation is simple.
__device__ int first_duplicate(const int32_t* perm, int E, int dv, int dc,
                               int* first) {
  if (threadIdx.x == 0) *first = E;
  __syncthreads();
  const int m = E / dc;
  // rows ascend per thread, so a thread's first hit is its smallest
  for (int row = threadIdx.x; row < m; row += blockDim.x) {
    const int32_t* s = perm + static_cast<long long>(row) * dc;
    int hit = E;
    for (int k = 1; k < dc && hit == E; ++k) {
      const int v = s[k] / dv;
      for (int l = 0; l < k; ++l) {
        if (s[l] / dv == v) {
          hit = row * dc + k;
          break;
        }
      }
    }
    if (hit < E) {
      atomicMin(first, hit);
      break;
    }
  }
  __syncthreads();
  const int result = *first;
  __syncthreads();  // every thread has read it before the next reset
  return result;
}

__global__ void sample_regular_codes_kernel(
    int32_t* __restrict__ chk_to_var, int32_t* __restrict__ var_to_edge,
    int32_t* __restrict__ var_to_chk, int32_t* scratch, int n, int dv, int dc,
    int method, int max_tries, uint32_t k0, uint32_t k1, uint32_t chunk) {
  extern __shared__ int32_t smem[];
  __shared__ int first;
  const int E = n * dv;
  const uint32_t code = blockIdx.x;
  const uint2 key = make_uint2(k0, k1);
  int32_t* partner = smem;
  int32_t* perm = scratch != nullptr
                      ? scratch + static_cast<long long>(code) * E
                      : smem + kTile;

  shuffle(perm, partner, E, code, chunk, 0u, key);
  if (method != kRaw) {
    int s = first_duplicate(perm, E, dv, dc, &first);
    for (int pass = 0; s < E && pass < max_tries; ++pass) {
      if (method == kReject) {
        shuffle(perm, partner, E, code, chunk, static_cast<uint32_t>(pass + 1),
                key);
      } else {
        repair_swap(perm, s, E, pass, code, chunk, key);
      }
      s = first_duplicate(perm, E, dv, dc, &first);
    }
  }

  const long long base = static_cast<long long>(code) * E;
  int32_t* chk = chk_to_var + base;
  int32_t* edges = var_to_edge + base;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int32_t p = perm[e];
    chk[e] = p / dv;
    edges[p] = e;  // the inverse permutation, unsorted within a variable
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    int32_t* a = edges + static_cast<long long>(v) * dv;
    for (int k = 1; k < dv; ++k) {  // insertion sort of dv entries
      const int32_t x = a[k];
      int l = k - 1;
      while (l >= 0 && a[l] > x) {
        a[l + 1] = a[l];
        --l;
      }
      a[l + 1] = x;
    }
    int32_t* out = var_to_chk + base + static_cast<long long>(v) * dv;
    for (int k = 0; k < dv; ++k) out[k] = a[k] / dc;
  }
}

}  // namespace

extern "C" int ldpc_sample_regular_codes(void* chk_to_var, void* var_to_edge,
                                         void* var_to_chk, void* scratch,
                                         int num_codes, int n, int dv, int dc,
                                         int method, int max_tries,
                                         unsigned int k0, unsigned int k1,
                                         unsigned int chunk, int use_shared,
                                         void* stream) {
  const long long sockets = static_cast<long long>(n) * dv;
  const size_t smem =
      static_cast<size_t>(kTile + (use_shared ? sockets : 0)) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sample_regular_codes_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_codes > 0) {
    sample_regular_codes_kernel<<<num_codes, kSamplerThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(chk_to_var), static_cast<int32_t*>(var_to_edge),
        static_cast<int32_t*>(var_to_chk),
        use_shared ? nullptr : static_cast<int32_t*>(scratch), n, dv, dc,
        method, max_tries, k0, k1, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
