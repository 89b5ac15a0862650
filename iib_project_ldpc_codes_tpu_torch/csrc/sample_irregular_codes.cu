// A batch of irregular (lambda, rho) codes per Monte Carlo chunk.
//
// Replaces iib_project_ldpc_codes_tpu/models/irregular.py:266-314
// (_sample_irregular, vmapped by IrregularEnsembleSpec.sample_batch).  The
// regular sampler (sample_regular_codes.cu) with the spec's socket maps in
// place of its fixed ones: check socket s holds variable
// socket_var[perm[s]] (regular: perm[s] / dv), check c owns the sockets
// chk_offs[c] .. chk_offs[c+1]-1 (regular: c*dc ..), and variable v owns
// the variable sockets var_offs[v] .. var_offs[v+1]-1.  The shuffle, the
// repair and reject streams and the Philox layout are the regular
// sampler's (sampler.cuh), so the degenerate spec of a regular ensemble
// gives the same check tables.  One block samples one code and writes the
// three phantom-padded tables:
//   chk_to_var[c, j]  = socket_var[perm[chk_offs[c] + j]], padding n
//   var_to_chk[v, p]  = c, var_to_sock[v, p] = c*dc_max + j for the check
//                       socket (c, j) matched to variable socket
//                       var_offs[v] + p; padding m and m*dc_max
// The variable side is filled by a scatter from the check side (each
// variable socket is matched to exactly one check socket), so no inverse
// permutation is stored; like the JAX sampler, it is not sorted.
//
// The duplicate scan reads each check's real sockets only, so phantom
// entries never count, and reports the smallest socket index whose variable
// repeats an earlier socket of its row: the JAX sampler's first padded
// position, since its pad map is monotone.  Bound on the H100 as the
// regular sampler: latency of the sequential shuffle; the permutation sits
// in shared memory up to SHARED_PERM_MAX_SOCKETS sockets, in a global
// scratch buffer above.
#include "sampler.cuh"

namespace {

using namespace ldpc::sampler;

__device__ int first_duplicate(const int32_t* perm,
                               const int32_t* __restrict__ socket_var,
                               const int32_t* __restrict__ chk_offs, int m,
                               int E, int* first) {
  if (threadIdx.x == 0) *first = E;
  __syncthreads();
  // rows ascend per thread, so a thread's first hit is its smallest
  for (int row = threadIdx.x; row < m; row += blockDim.x) {
    const int s0 = __ldg(chk_offs + row), s1 = __ldg(chk_offs + row + 1);
    int hit = E;
    for (int k = s0 + 1; k < s1 && hit == E; ++k) {
      const int v = __ldg(socket_var + perm[k]);
      for (int l = s0; l < k; ++l) {
        if (__ldg(socket_var + perm[l]) == v) {
          hit = k;
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

__global__ void sample_irregular_codes_kernel(
    int32_t* __restrict__ chk_to_var, int32_t* __restrict__ var_to_chk,
    int32_t* __restrict__ var_to_sock, int32_t* scratch,
    const int32_t* __restrict__ socket_var,
    const int32_t* __restrict__ chk_offs,
    const int32_t* __restrict__ var_offs, int n, int m, int dv_max,
    int dc_max, int method, int max_tries, uint32_t k0, uint32_t k1,
    uint32_t chunk) {
  extern __shared__ int32_t smem[];
  __shared__ int first;
  const int E = __ldg(chk_offs + m);
  const uint32_t code = blockIdx.x;
  const uint2 key = make_uint2(k0, k1);
  int32_t* partner = smem;
  int32_t* perm = scratch != nullptr
                      ? scratch + static_cast<long long>(code) * E
                      : smem + kTile;

  shuffle(perm, partner, E, code, chunk, 0u, key);
  if (method != kRaw) {
    int s = first_duplicate(perm, socket_var, chk_offs, m, E, &first);
    for (int pass = 0; s < E && pass < max_tries; ++pass) {
      if (method == kReject) {
        shuffle(perm, partner, E, code, chunk, static_cast<uint32_t>(pass + 1),
                key);
      } else {
        repair_swap(perm, s, E, pass, code, chunk, key);
      }
      s = first_duplicate(perm, socket_var, chk_offs, m, E, &first);
    }
  }

  const int chk_cells = (m + 1) * dc_max, var_cells = (n + 1) * dv_max;
  int32_t* chk = chk_to_var + static_cast<long long>(code) * chk_cells;
  int32_t* vchk = var_to_chk + static_cast<long long>(code) * var_cells;
  int32_t* vsock = var_to_sock + static_cast<long long>(code) * var_cells;
  for (int pos = threadIdx.x; pos < chk_cells; pos += blockDim.x) {
    const int c = pos / dc_max;
    int v = n;
    if (c < m) {
      const int s = __ldg(chk_offs + c) + (pos - c * dc_max);
      if (s < __ldg(chk_offs + c + 1)) {
        const int t = perm[s];
        v = __ldg(socket_var + t);
        const int cell = v * dv_max + (t - __ldg(var_offs + v));
        vchk[cell] = c;
        vsock[cell] = pos;
      }
    }
    chk[pos] = v;
  }
  // padding of the variable side: cells the scatter above never writes
  for (int cell = threadIdx.x; cell < var_cells; cell += blockDim.x) {
    const int v = cell / dv_max;
    if (v == n ||
        cell - v * dv_max >= __ldg(var_offs + v + 1) - __ldg(var_offs + v)) {
      vchk[cell] = m;
      vsock[cell] = m * dc_max;
    }
  }
}

}  // namespace

extern "C" int ldpc_sample_irregular_codes(
    void* chk_to_var, void* var_to_chk, void* var_to_sock, void* scratch,
    const void* socket_var, const void* chk_offs, const void* var_offs,
    int num_codes, int n, int m, int dv_max, int dc_max, int method,
    int max_tries, unsigned int k0, unsigned int k1, unsigned int chunk,
    int use_shared, int sockets, void* stream) {
  const size_t smem = static_cast<size_t>(kTile + (use_shared ? sockets : 0)) *
                      sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sample_irregular_codes_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_codes > 0) {
    sample_irregular_codes_kernel<<<num_codes, kSamplerThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(chk_to_var), static_cast<int32_t*>(var_to_chk),
        static_cast<int32_t*>(var_to_sock),
        use_shared ? nullptr : static_cast<int32_t*>(scratch),
        static_cast<const int32_t*>(socket_var),
        static_cast<const int32_t*>(chk_offs),
        static_cast<const int32_t*>(var_offs), n, m, dv_max, dc_max, method,
        max_tries, k0, k1, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
