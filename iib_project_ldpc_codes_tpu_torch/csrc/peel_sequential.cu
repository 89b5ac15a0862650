// P1: the sequential peeling decoder with its R-process, one warp a trial.
//
// Replaces iib_project_ldpc_codes_tpu/ops/peeling.py peel_decode (:68-113),
// peel_decode_irregular (:116-160) and peel_decode_batch (:163-170).  For
// trial r (code r of a batch, or the one code) with erasures erased[r, :]:
// strip the known variables, then, while some check has exactly one
// unresolved variable and fewer than max_steps peels were made, at step t
//   count = the number of degree-1 checks, written to evolution[r, t];
//   k     = floor(r64 * count / 2^64), r64 = lanes (0, 1) of Philox4x32-10
//           at counter (t, r, 0, 0) under the key (key0, key1);
//   c     = the k-th degree-1 check in increasing check index;
//   v     = the first unresolved entry of c's row (JAX's argmax);
//   resolve v and decrement the residual degree of each of its checks.
// Then evolution[r, t'] = -1 for t' >= steps, except evolution[r, steps]
// = 0 when nothing is left unresolved (the reference's final append), and
// steps_out = steps + [success], num_erasures = the initial erasure count.
// The choice is canonical, so the plain version (ops/peeling.py) gives the
// same trajectory on any device; JAX draws it by Gumbel-argmax and the
// native C by xorshift, which agree with it in distribution only.
// Table entries >= n (check rows) and >= m (variable rows) are the padding
// of an irregular code (native/peeling.c's convention) and are skipped; a
// variable entry counts once per edge, as JAX's degree sums do.
//
// Bound on the H100: neither bytes nor operations.  The tables are read
// once (O(E) per trial, as native/peeling.c) and the evolution written once,
// far below any time a chain of num_erasures dependent steps can take: each
// step needs the previous step's degrees, and its two table reads (the
// chosen row, then the resolved variable's checks) are dependent loads.
// The parallelism is across trials.  Design: one warp a trial (a block of
// 32 threads), its state in shared memory -- the residual check degrees
// (uint8, m bytes), a bitmap of the degree-1 checks and a bitmap of the
// unresolved variables, 12 KB at n = 16,384 for a (3,6) code.  The count is
// kept up to date, so a step scans the degree-1 bitmap once: each lane
// counts its run of words, a warp scan finds the lane holding the k-th set
// bit (the rank-select) and that lane finds the bit.  The row's entries are
// read by dc lanes at once and the first unresolved one chosen by ballot;
// lane 0 then resolves the variable and updates the degrees, bitmap and
// count one edge at a time (dv of them), so repeated checks are exact.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool bit_of(const uint32_t* map, int i) {
  return (map[i >> 5] >> (i & 31)) & 1u;
}

__global__ void peel_sequential_kernel(
    const int32_t* __restrict__ chk, const int32_t* __restrict__ var,
    const bool* __restrict__ erased, bool* __restrict__ unresolved,
    int32_t* __restrict__ evolution, int32_t* __restrict__ steps_out,
    int32_t* __restrict__ erasures_out, int n, int m, int dc, int dv,
    int batched, int max_steps, uint32_t key0, uint32_t key1) {
  extern __shared__ uint32_t smem[];
  const int wm = (m + 31) / 32, wn = (n + 31) / 32;
  uint32_t* ones = smem;                                    // [wm]
  uint32_t* unres = smem + wm;                              // [wn]
  uint8_t* deg = reinterpret_cast<uint8_t*>(smem + wm + wn);  // [m]
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* rows = chk + (batched ? static_cast<long long>(r) * m * dc : 0);
  const int32_t* cols = var + (batched ? static_cast<long long>(r) * n * dv : 0);
  const bool* er = erased + static_cast<long long>(r) * n;
  int32_t* evo = evolution + static_cast<long long>(r) * (max_steps + 1);

  // the unresolved variables: the erasures
  int num_erasures = 0;
  for (int base = 0; base < n; base += 32) {
    const int v = base + lane;
    const uint32_t word = __ballot_sync(kFull, v < n && er[v]);
    if (lane == 0) unres[base >> 5] = word;
    num_erasures += __popc(word);
  }
  __syncwarp();
  // residual degrees, then the degree-1 bitmap and its count
  for (int c = lane; c < m; c += 32) {
    int d = 0;
    for (int j = 0; j < dc; ++j) {
      const int v = __ldg(rows + static_cast<long long>(c) * dc + j);
      d += v < n && bit_of(unres, v);
    }
    deg[c] = static_cast<uint8_t>(d);
  }
  __syncwarp();
  int count = 0;
  for (int base = 0; base < m; base += 32) {
    const int c = base + lane;
    const uint32_t word = __ballot_sync(kFull, c < m && deg[c] == 1);
    if (lane == 0) ones[base >> 5] = word;
    count += __popc(word);
  }
  __syncwarp();

  const int per = (wm + 31) / 32;     // bitmap words a lane scans
  int t = 0;
  while (count > 0 && t < max_steps) {
    const uint4 draw = ldpc::philox4x32_10(
        make_uint4(static_cast<uint32_t>(t), static_cast<uint32_t>(r), 0u, 0u),
        make_uint2(key0, key1));
    const unsigned long long hi =
        static_cast<unsigned long long>(draw.y) * count +
        ((static_cast<unsigned long long>(draw.x) * count) >> 32);
    const int k = static_cast<int>(hi >> 32);
    // rank-select of the k-th set bit of `ones`
    int own = 0;
    for (int i = 0; i < per; ++i) {
      const int w = lane * per + i;
      if (w < wm) own += __popc(ones[w]);
    }
    int incl = own;
#pragma unroll
    for (int offset = 1; offset < 32; offset <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, offset);
      if (lane >= offset) incl += up;
    }
    const int excl = incl - own;
    const unsigned holder = __ballot_sync(kFull, k >= excl && k < incl);
    const int src = __ffs(holder) - 1;
    int chosen = 0;
    if (lane == src) {
      int rest = k - excl;
      for (int i = 0; i < per; ++i) {
        const int w = lane * per + i;
        uint32_t word = ones[w];
        const int pc = __popc(word);
        if (rest < pc) {
          for (int s = 0; s < rest; ++s) word &= word - 1;   // drop lower bits
          chosen = w * 32 + __ffs(word) - 1;
          break;
        }
        rest -= pc;
      }
    }
    chosen = __shfl_sync(kFull, chosen, src);
    // the first unresolved entry of the chosen row
    int v = n;
    if (lane < dc) v = __ldg(rows + static_cast<long long>(chosen) * dc + lane);
    const unsigned live = __ballot_sync(kFull, lane < dc && v < n && bit_of(unres, v));
    v = __shfl_sync(kFull, v, __ffs(live) - 1);
    if (lane == 0) {
      evo[t] = count;
      unres[v >> 5] &= ~(1u << (v & 31));
      for (int j = 0; j < dv; ++j) {
        const int c = __ldg(cols + static_cast<long long>(v) * dv + j);
        if (c >= m) continue;                 // padded socket
        const int d = deg[c];
        deg[c] = static_cast<uint8_t>(d - 1);
        if (d == 2) {
          ones[c >> 5] |= 1u << (c & 31);
          ++count;
        } else if (d == 1) {
          ones[c >> 5] &= ~(1u << (c & 31));
          --count;
        }
      }
    }
    count = __shfl_sync(kFull, count, 0);
    __syncwarp();
    ++t;
  }

  int left = 0;
  for (int w = lane; w < wn; w += 32) left += __popc(unres[w]);
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    left += __shfl_xor_sync(kFull, left, offset);
  const bool success = left == 0;
  for (int s = t + lane; s <= max_steps; s += 32) evo[s] = s == t && success ? 0 : -1;
  for (int v = lane; v < n; v += 32)
    unresolved[static_cast<long long>(r) * n + v] = bit_of(unres, v);
  if (lane == 0) {
    steps_out[r] = t + success;
    erasures_out[r] = num_erasures;
  }
}

}  // namespace

// chk int32[(T,) m, dc], var int32[(T,) n, dv] (batched != 0: one code a
// trial), erased bool[T, n]; outputs unresolved bool[T, n], evolution
// int32[T, max_steps + 1], steps and num_erasures int32[T].
extern "C" int ldpc_peel_sequential(const void* chk, const void* var,
                                    const void* erased, void* unresolved,
                                    void* evolution, void* steps,
                                    void* erasures, int trials, int n, int m,
                                    int dc, int dv, int batched, int max_steps,
                                    unsigned key0, unsigned key1,
                                    void* stream) {
  if (trials < 0 || n < 1 || m < 1 || dc < 1 || dc > 32 || dv < 1 ||
      max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (trials == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>((m + 31) / 32 + (n + 31) / 32) +
                      static_cast<size_t>(m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        peel_sequential_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  peel_sequential_kernel<<<trials, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chk), static_cast<const int32_t*>(var),
      static_cast<const bool*>(erased), static_cast<bool*>(unresolved),
      static_cast<int32_t*>(evolution), static_cast<int32_t*>(steps),
      static_cast<int32_t*>(erasures), n, m, dc, dv, batched, max_steps, key0,
      key1);
  return static_cast<int>(cudaGetLastError());
}
