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
// Like the JAX sampler, the variable side is not sorted.
//
// The duplicate flags read each check's real sockets only, so phantom
// entries never count, and the first offender is the smallest socket index
// whose variable repeats an earlier socket of its row: the JAX sampler's
// first padded position, since its pad map is monotone.
//
// Design: the regular sampler's (sample_regular_codes.cu, sampler.cuh):
// 1,024 threads a block, the shuffle as rounds of deterministic
// reservations on one shared-memory word a socket (permutation low,
// reservation high), partners beside them up to 37,000 sockets, in a
// global scratch buffer up to 56,000 and everything global above; the
// repair loop in warp 0 rescans only the two rows a swap touched
// (chk_of_socket gives a socket's row).  The tables: the inverse
// permutation goes into the words' high halves, so both sides are written
// in their own order, coalesced, through the spec's static maps (pad_map:
// check cell -> socket; var_pad_map: variable cell -> socket; sock_to_pad:
// socket -> check cell), which stay in L2.  Each random 4-byte gather
// costs a 32-byte L2 sector, so the loops take one gather a cell:
// socket_var moves into the partners' freed shared memory as 16-bit values
// (all-shared layout), and a check is its check cell / dc_max.  (Three
// gathers a cell, the maps all in L2: 1.218 ms at 768 codes of n = 1e4,
// raw, on an NVIDIA H100 80GB HBM3 at 700.00 W, against K5's 0.676.)
#include "sampler.cuh"

namespace {

using namespace ldpc::sampler;

template <int kLayout>
__global__ void __launch_bounds__(kSamplerThreads, 1)
    sample_irregular_codes_kernel(
        int32_t* __restrict__ chk_to_var, int32_t* __restrict__ var_to_chk,
        int32_t* __restrict__ var_to_sock, unsigned char* scratch,
        int32_t* rounds_out, const int32_t* __restrict__ socket_var,
        const int32_t* __restrict__ chk_offs,
        const int32_t* __restrict__ chk_of_socket,
        const int32_t* __restrict__ pad_map,
        const int32_t* __restrict__ var_pad_map,
        const int32_t* __restrict__ sock_to_pad, int n, int m, int dv_max,
        int dc_max, int method, int max_tries, uint32_t k0, uint32_t k1,
        uint32_t chunk) {
  using L = Layout<kLayout>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = __ldg(chk_offs + m);
  const uint32_t code = blockIdx.x;
  const Buffers<kLayout> b = carve<kLayout>(smem, scratch, E, code);
  const IrregularRows rows{socket_var, chk_offs, chk_of_socket, m};
  sample_permutation(b, rows, E, method, max_tries, code, chunk,
                     make_uint2(k0, k1), rounds_out);

  // inverse permutation into the words' high halves (all 0 here); in the
  // all-shared layout, socket_var as 16-bit values where the partners were
  typename L::Half* half = reinterpret_cast<typename L::Half*>(b.words);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    half[2LL * low(b.words[e], L::kShift) + 1] =
        static_cast<typename L::Half>(e);
    if constexpr (kLayout == kAllShared) b.partner[e] = __ldg(socket_var + e);
  }
  __syncthreads();
  const int chk_cells = (m + 1) * dc_max, var_cells = (n + 1) * dv_max;
  int32_t* chk = chk_to_var + static_cast<long long>(code) * chk_cells;
  int32_t* vchk = var_to_chk + static_cast<long long>(code) * var_cells;
  int32_t* vsock = var_to_sock + static_cast<long long>(code) * var_cells;
#pragma unroll 4
  for (int pos = threadIdx.x; pos < chk_cells; pos += blockDim.x) {
    const int s = __ldg(pad_map + pos);
    int v = n;
    if (s < E) {
      const int t = low(b.words[s], L::kShift);
      if constexpr (kLayout == kAllShared) {
        v = b.partner[t];
      } else {
        v = __ldg(socket_var + t);
      }
    }
    chk[pos] = v;
  }
  // variable side in cell order: variable socket t is matched to check
  // socket inv[t], at check cell sock_to_pad[inv[t]] of check
  // sock_to_pad[inv[t]] / dc_max
#pragma unroll 4
  for (int cell = threadIdx.x; cell < var_cells; cell += blockDim.x) {
    const int t = __ldg(var_pad_map + cell);
    if (t < E) {
      const int pos = __ldg(sock_to_pad + static_cast<int>(
                                              b.words[t] >> L::kShift));
      vchk[cell] = pos / dc_max;
      vsock[cell] = pos;
    } else {
      vchk[cell] = m;
      vsock[cell] = m * dc_max;
    }
  }
}

template <int kLayout>
int launch_layout(void** tables, unsigned char* scratch, int32_t* rounds,
                  const int32_t** maps, int num_codes, int n, int m,
                  int dv_max, int dc_max, int method, int max_tries,
                  uint32_t k0, uint32_t k1, uint32_t chunk, int sockets,
                  cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(shared_bytes(kLayout, sockets));
  cudaError_t err = cudaFuncSetAttribute(
      sample_irregular_codes_kernel<kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_codes > 0) {
    sample_irregular_codes_kernel<kLayout>
        <<<num_codes, kSamplerThreads, smem, stream>>>(
            static_cast<int32_t*>(tables[0]),
            static_cast<int32_t*>(tables[1]),
            static_cast<int32_t*>(tables[2]), scratch, rounds, maps[0],
            maps[1], maps[2], maps[3], maps[4], maps[5], n, m, dv_max, dc_max,
            method, max_tries, k0, k1, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// maps: the spec's socket_var, chk_offs, chk_of_socket, pad_map,
// var_pad_map and sock_to_pad (models/irregular.py IrregularEnsembleSpec);
// sockets: its E; layout, scratch and rounds as ldpc_sample_regular_codes
// takes them.
extern "C" int ldpc_sample_irregular_codes(
    void* chk_to_var, void* var_to_chk, void* var_to_sock, void* scratch,
    void* rounds, const void* socket_var, const void* chk_offs,
    const void* chk_of_socket, const void* pad_map, const void* var_pad_map,
    const void* sock_to_pad, int num_codes, int n, int m, int dv_max,
    int dc_max, int method, int max_tries, unsigned int k0, unsigned int k1,
    unsigned int chunk, int layout, int sockets, long long scratch_per_code,
    void* stream) {
  if (layout < kGlobal || layout > kAllShared ||
      (layout != kGlobal && sockets > 65536) ||
      scratch_per_code < scratch_bytes(layout, sockets) ||
      (scratch_bytes(layout, sockets) > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* tables[3] = {chk_to_var, var_to_chk, var_to_sock};
  const int32_t* maps[6] = {
      static_cast<const int32_t*>(socket_var),
      static_cast<const int32_t*>(chk_offs),
      static_cast<const int32_t*>(chk_of_socket),
      static_cast<const int32_t*>(pad_map),
      static_cast<const int32_t*>(var_pad_map),
      static_cast<const int32_t*>(sock_to_pad)};
  auto* s = static_cast<unsigned char*>(scratch);
  auto* r = static_cast<int32_t*>(rounds);
  auto st = static_cast<cudaStream_t>(stream);
  if (layout == kAllShared) {
    return launch_layout<kAllShared>(tables, s, r, maps, num_codes, n, m,
                                     dv_max, dc_max, method, max_tries, k0,
                                     k1, chunk, sockets, st);
  }
  if (layout == kWordsShared) {
    return launch_layout<kWordsShared>(tables, s, r, maps, num_codes, n, m,
                                       dv_max, dc_max, method, max_tries, k0,
                                       k1, chunk, sockets, st);
  }
  return launch_layout<kGlobal>(tables, s, r, maps, num_codes, n, m, dv_max,
                                dc_max, method, max_tries, k0, k1, chunk,
                                sockets, st);
}
