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
// Design (sampler.cuh has the details).  1,024 threads a block.  The
// shuffle runs as rounds of deterministic reservations over all threads
// (34 rounds at n = 1e4, E = 30,000), on one word a socket in shared
// memory: the permutation in the low half, the reservation in the high
// half; the partners sit beside them as 16-bit values up to 37,000
// sockets (180 KB at n = 1e4: one block an SM), in a global scratch
// buffer up to 56,000, and everything moves to a global scratch buffer
// above that.  `repair` flags the check rows with a duplicate once, in
// parallel, then warp 0 swaps the first offender and rescans only the two
// rows the swap touched.  The tables come from shared memory: the inverse
// permutation goes into the words' high halves, each variable's dv entries
// are sorted there, and the three tables are written once each, coalesced.
// Those writes are the byte bound (0.0825 ms at 768 codes of n = 1e4 on the
// H100 at 3.35 TB/s); the rounds' shared-memory atomics set the time.
// Every loop condition that guards a barrier is block-uniform.
#include "sampler.cuh"

namespace {

using namespace ldpc::sampler;

template <int kLayout>
__global__ void __launch_bounds__(kSamplerThreads, 1)
    sample_regular_codes_kernel(int32_t* __restrict__ chk_to_var,
                                int32_t* __restrict__ var_to_edge,
                                int32_t* __restrict__ var_to_chk,
                                unsigned char* scratch, int32_t* rounds_out,
                                int n, int dv, int dc, int method,
                                int max_tries, uint32_t k0, uint32_t k1,
                                uint32_t chunk) {
  using L = Layout<kLayout>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = n * dv;
  const uint32_t code = blockIdx.x;
  const Buffers<kLayout> b = carve<kLayout>(smem, scratch, E, code);
  const RegularRows rows{dv, dc, E / dc};
  sample_permutation(b, rows, E, method, max_tries, code, chunk,
                     make_uint2(k0, k1), rounds_out);

  // inverse permutation into the high halves (they are all 0 here)
  typename L::Half* half = reinterpret_cast<typename L::Half*>(b.words);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    half[2LL * low(b.words[e], L::kShift) + 1] =
        static_cast<typename L::Half>(e);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    typename L::Half* a = half + 2LL * v * dv + 1;
    for (int k = 1; k < dv; ++k) {  // insertion sort of dv entries
      const typename L::Half x = a[2 * k];
      int l = k - 1;
      while (l >= 0 && a[2 * l] > x) {
        a[2 * l + 2] = a[2 * l];
        --l;
      }
      a[2 * l + 2] = x;
    }
  }
  __syncthreads();
  const long long base = static_cast<long long>(code) * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const typename L::Word w = b.words[e];
    const int edge = static_cast<int>(w >> L::kShift);
    chk_to_var[base + e] = low(w, L::kShift) / dv;
    var_to_edge[base + e] = edge;
    var_to_chk[base + e] = edge / dc;
  }
}

template <int kLayout>
int launch_layout(int32_t* chk_to_var, int32_t* var_to_edge,
                  int32_t* var_to_chk, unsigned char* scratch,
                  int32_t* rounds, int num_codes, int n, int dv, int dc,
                  int method, int max_tries, uint32_t k0, uint32_t k1,
                  uint32_t chunk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(
      shared_bytes(kLayout, static_cast<long long>(n) * dv));
  cudaError_t err = cudaFuncSetAttribute(
      sample_regular_codes_kernel<kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_codes > 0) {
    sample_regular_codes_kernel<kLayout>
        <<<num_codes, kSamplerThreads, smem, stream>>>(
            chk_to_var, var_to_edge, var_to_chk, scratch, rounds, n, dv, dc,
            method, max_tries, k0, k1, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout: kGlobal (0), kWordsShared (1) or kAllShared (2); scratch holds
// scratch_bytes(layout, n * dv) bytes a code (the call is refused when
// scratch_per_code is smaller); rounds: int32[num_codes] or null.
extern "C" int ldpc_sample_regular_codes(
    void* chk_to_var, void* var_to_edge, void* var_to_chk, void* scratch,
    void* rounds, int num_codes, int n, int dv, int dc, int method,
    int max_tries, unsigned int k0, unsigned int k1, unsigned int chunk,
    int layout, long long scratch_per_code, void* stream) {
  const long long sockets = static_cast<long long>(n) * dv;
  if (layout < kGlobal || layout > kAllShared ||
      (layout != kGlobal && sockets > 65536) ||
      scratch_per_code < scratch_bytes(layout, sockets) ||
      (scratch_bytes(layout, sockets) > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* a = static_cast<int32_t*>(chk_to_var);
  auto* b = static_cast<int32_t*>(var_to_edge);
  auto* c = static_cast<int32_t*>(var_to_chk);
  auto* s = static_cast<unsigned char*>(scratch);
  auto* r = static_cast<int32_t*>(rounds);
  auto st = static_cast<cudaStream_t>(stream);
  if (layout == kAllShared) {
    return launch_layout<kAllShared>(a, b, c, s, r, num_codes, n, dv, dc,
                                     method, max_tries, k0, k1, chunk, st);
  }
  if (layout == kWordsShared) {
    return launch_layout<kWordsShared>(a, b, c, s, r, num_codes, n, dv, dc,
                                       method, max_tries, k0, k1, chunk, st);
  }
  return launch_layout<kGlobal>(a, b, c, s, r, num_codes, n, dv, dc, method,
                                max_tries, k0, k1, chunk, st);
}
