// Kernel G: the whole Gallager-A/B decode of one code per block.
//
// Replaces iib_project_ldpc_codes_tpu/ops/gallager.py _gallager_loop
// (:238-299) as the JAX engine runs it under vmap, one while_loop per code
// (parallel/montecarlo.py:268-285 _fresh_codes_chunk), with record="total":
// the rounds of _gallager_iteration (:117-175) on a regular code and of
// gallager_decode_packed_irregular (:302-398) on a phantom-padded one.
//
// Codes never exchange data and a code's stop depends only on its own
// counts, so one block runs every round of its code with no grid-wide sync
// and no host read.  Its messages int32[rows * dc][wpc] (one row per flat
// check-socket position) and parities int32[rows][wpc] live in dynamic
// shared memory: 140,000 bytes for a (3,6) code of n = 10^4 at one word
// (32 trials) per code, 160,020 for phase 14's irregular code.  A round is
//   1. check pass: parity[c] = XOR_j msg[c*dc + j], from shared memory;
//   2. variable pass: the arithmetic of gallager_variable.cu unchanged
//      (the bit-sliced count and count_at_least of gallager.cuh, the clamp
//      t = min(b, max(d-1, 1)) for irregular codes, the majority d/2 + 1),
//      messages and parity read from and written to shared memory;
//   3. a block reduction of (decision errors, changed message words), the
//      errors counted against tx in the kTx instantiation;
// each followed by __syncthreads().  The stop rule is the host loop's per
// code (ops/gallager.py::_round_loop): start only if the channel has errors;
// after round it, go on only while errors > 0 and (a message changed or
// change_ahead[it]), and never past max_iters.  thresholds[it] carries the
// constant threshold, a Gallager-B schedule or the irregular b.
//
// Outputs: the decision of the last round run (the channel for 0 rounds),
// round_errors[code][r] (r = 0 the channel's errors, then the count after
// each round run, the tail after the stop holding the final count, as the
// JAX loop's) and rounds[code].
//
// Memory: the channel, tx and decision planes are code-major [C][n][wpc]
// (the wrapper transposes), so a warp's loads and stores coalesce.  The
// socket tables (chk_to_var [C][rows][dc], var_to_sock [C][table_rows][dv])
// do not also fit in shared memory; var_to_sock is read each round from
// device memory, consecutive variables contiguous, and the resident
// blocks' tables (~120 KB a code) stay in L2.  The decision is stored each
// round a code runs (the block learns that a round was its last only from
// the round's counts); its 40 KB a code stays in L2 and reaches device
// memory about once.  Its least time on the H100 is set by shared memory,
// ~125,000 accesses a round at n = 10^4, (3,6), against ~154 MB of device
// memory for the whole decode of 768 codes (tables, channel and decision
// once).
//
// A thread owns variables tid, tid + T, ... and all wpc words of each, so
// a variable's socket positions are read once a round; s / dc is a
// multiply-high by a reciprocal fixed at launch (exact below 2^16 sockets,
// which the shared-memory budget guarantees).  The round runs at ~11x that
// least time, held by instruction throughput and latency: 1,024 threads a
// block beat 512, a prefetch of the next variable's sockets did not help,
// and three count planes in place of six (degrees up to 4) cut 18%.
#include "gallager.cuh"

namespace {

using ldpc::count_at_least;
using ldpc::kCountPlanes;

// threads a block: 1024 (32 warps to hide shared-memory latency, 64
// registers a thread) for degrees up to 4, 256 above (the 32-entry arrays)
template <int kMaxD>
constexpr int threads_for() {
  return kMaxD <= 4 ? 1024 : 256;
}

// floor(s / d) for 0 <= s < 2^16, 1 <= d < 2^16: s * ceil(2^32 / d) >> 32.
struct DivBy {
  unsigned long long magic;
  __device__ explicit DivBy(int d)
      : magic(0xFFFFFFFFull / static_cast<unsigned long long>(d) + 1ull) {}
  __device__ int operator()(int s) const {
    return static_cast<int>((static_cast<unsigned long long>(s) * magic) >> 32);
  }
};

// Adds (a, b) of every thread into dst[0], dst[1]: a warp sum, then one
// atomic pair a warp.  Every thread of the block must call it.
__device__ __forceinline__ void block_add(int* dst, int a, int b) {
  a = __reduce_add_sync(0xFFFFFFFFu, a);
  b = __reduce_add_sync(0xFFFFFFFFu, b);
  if ((threadIdx.x & 31) == 0 && (a | b) != 0) {
    atomicAdd(dst, a);
    atomicAdd(dst + 1, b);
  }
}

template <int kMaxD, bool kTx>
__global__ void __launch_bounds__(kMaxD <= 4 ? 1024 : 256, 1)
gallager_decode_kernel(
    const int32_t* __restrict__ channel, const int32_t* __restrict__ tx,
    const int32_t* __restrict__ chk_to_var,
    const int32_t* __restrict__ var_to_sock,
    const int32_t* __restrict__ thresholds,
    const int32_t* __restrict__ change_ahead, int32_t* __restrict__ decided,
    int32_t* __restrict__ round_errors, int32_t* __restrict__ rounds, int n,
    int rows, int dc, int table_rows, int dv, int pad_pos, int wpc,
    int max_iters, int clamp) {
  // count planes: degrees up to 4 count to 4 in 3 planes (18% faster than
  // 6 at the (3,6) headline shape on the H100), wider ones in 6
  constexpr int kPlanes = kMaxD <= 4 ? 3 : kCountPlanes;
  extern __shared__ uint32_t smem[];
  const int sockets = rows * dc;
  uint32_t* msg = smem;                                        // [sockets][wpc]
  uint32_t* parity = smem + static_cast<long long>(sockets) * wpc;  // [rows][wpc]
  int* counts = reinterpret_cast<int*>(parity + static_cast<long long>(rows) * wpc);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long code = blockIdx.x;
  const long long plane = code * n * wpc;
  const int32_t* ch = channel + plane;
  const int32_t* txc = kTx ? tx + plane : nullptr;
  int32_t* dec_out = decided + plane;
  const int32_t* c2v = chk_to_var + code * sockets;
  const int32_t* v2s = var_to_sock + code * table_rows * dv;
  int32_t* errors_out = round_errors + code * (max_iters + 1);
  const DivBy by_dc(dc);

  // set-up: the first messages (the socket's variable's channel word, 0 on
  // the phantom's padded sockets) and the channel's errors
  if (tid < 4) counts[tid] = 0;
  for (int s = tid; s < sockets; s += nthreads) {
    const int v = __ldg(c2v + s);
    for (int w = 0; w < wpc; ++w) {
      msg[s * wpc + w] =
          v < n ? static_cast<uint32_t>(__ldg(ch + static_cast<long long>(v) * wpc + w))
                : 0u;
    }
  }
  int errors = 0;
  for (int i = tid; i < n * wpc; i += nthreads) {
    const uint32_t c = static_cast<uint32_t>(__ldg(ch + i));
    errors += __popc(kTx ? c ^ static_cast<uint32_t>(__ldg(txc + i)) : c);
  }
  __syncthreads();                      // counters zeroed, messages set
  block_add(counts + 2, errors, 0);
  __syncthreads();
  int current = counts[2];
  if (tid == 0) errors_out[0] = current;

  int it = 0;
  bool go = current > 0 && max_iters > 0;
  while (go) {
    // 1. check pass
    for (int c = tid; c < rows; c += nthreads) {
      const uint32_t* row = msg + static_cast<long long>(c) * dc * wpc;
      for (int w = 0; w < wpc; ++w) {
        uint32_t acc = 0u;
        for (int j = 0; j < dc; ++j) acc ^= row[j * wpc + w];
        parity[c * wpc + w] = acc;
      }
    }
    __syncthreads();
    // 2. variable pass
    const int threshold = __ldg(thresholds + it);
    int errs = 0, changed = 0;
    for (int v = tid; v < n; v += nthreads) {
      const int32_t* socks = v2s + static_cast<long long>(v) * dv;
      int pos[kMaxD], chk[kMaxD];
      int degree = 0;
#pragma unroll
      for (int p = 0; p < kMaxD; ++p) {
        pos[p] = p < dv ? __ldg(socks + p) : pad_pos;
        if (pos[p] < pad_pos) ++degree;
        chk[p] = by_dc(pos[p] < pad_pos ? pos[p] : 0);
      }
      const int t_flip = clamp ? min(threshold, max(degree - 1, 1)) : threshold;
      for (int w = 0; w < wpc; ++w) {
        const uint32_t c = static_cast<uint32_t>(
            __ldg(ch + static_cast<long long>(v) * wpc + w));
        uint32_t dis[kMaxD], old[kMaxD];
        uint32_t planes[kPlanes] = {};
#pragma unroll
        for (int p = 0; p < kMaxD; ++p) {
          dis[p] = old[p] = 0u;
          if (pos[p] < pad_pos) {
            old[p] = msg[pos[p] * wpc + w];
            dis[p] = parity[chk[p] * wpc + w] ^ old[p] ^ c;
            uint32_t carry = dis[p];
#pragma unroll
            for (int i = 0; i < kPlanes; ++i) {
              const uint32_t next = planes[i] & carry;
              planes[i] ^= carry;
              carry = next;
            }
          }
        }
        const uint32_t ge_t = count_at_least(planes, t_flip);
        const uint32_t ge_t1 =
            t_flip < (1 << kPlanes) ? count_at_least(planes, t_flip + 1) : 0u;
#pragma unroll
        for (int p = 0; p < kMaxD; ++p) {
          if (pos[p] < pad_pos) {
            const uint32_t out = c ^ ((dis[p] & ge_t1) | (~dis[p] & ge_t));
            changed += old[p] != out;
            msg[pos[p] * wpc + w] = out;
          }
        }
        const uint32_t dec = c ^ count_at_least(planes, degree / 2 + 1);
        dec_out[static_cast<long long>(v) * wpc + w] = static_cast<int32_t>(dec);
        errs += __popc(kTx ? dec ^ static_cast<uint32_t>(__ldg(
                                       txc + static_cast<long long>(v) * wpc + w))
                           : dec);
      }
    }
    // 3. the round's counts; the next round's counters are zeroed only
    // after every thread has read this pair's twin (two rounds back)
    int* pair = counts + 2 * (it & 1);
    block_add(pair, errs, changed);
    __syncthreads();
    current = pair[0];
    const int moved = pair[1];
    if (tid == 0) {
      errors_out[it + 1] = current;
      int* next = counts + 2 * ((it + 1) & 1);
      next[0] = 0;
      next[1] = 0;
    }
    ++it;
    go = it < max_iters && current > 0 &&
         (moved > 0 || __ldg(change_ahead + it - 1) != 0);
  }
  if (it == 0) {                        // no round ran: decide the channel
    for (int i = tid; i < n * wpc; i += nthreads) dec_out[i] = __ldg(ch + i);
  }
  for (int r = it + 1 + tid; r <= max_iters; r += nthreads) errors_out[r] = current;
  if (tid == 0) rounds[code] = it;
}

template <int kMaxD, bool kTx>
int launch_decode(int num_codes, size_t smem_bytes, cudaStream_t stream,
                  const int32_t* channel, const int32_t* tx,
                  const int32_t* chk_to_var, const int32_t* var_to_sock,
                  const int32_t* thresholds, const int32_t* change_ahead,
                  int32_t* decided, int32_t* round_errors, int32_t* rounds,
                  int n, int rows, int dc, int table_rows, int dv, int pad_pos,
                  int wpc, int max_iters, int clamp) {
  auto kernel = gallager_decode_kernel<kMaxD, kTx>;
  const cudaError_t opt = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (opt != cudaSuccess) return static_cast<int>(opt);
  kernel<<<num_codes, threads_for<kMaxD>(), smem_bytes, stream>>>(
      channel, tx, chk_to_var, var_to_sock, thresholds, change_ahead, decided,
      round_errors, rounds, n, rows, dc, table_rows, dv, pad_pos, wpc,
      max_iters, clamp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_bytes = (rows * dc + rows) * wpc * 4 + 16 (the two counter pairs);
// the wrapper computes it and checks it against the opt-in limit, and a
// refused opt-in or launch returns its CUDA error.
extern "C" int ldpc_gallager_decode(
    const void* channel, const void* tx, const void* chk_to_var,
    const void* var_to_sock, const void* thresholds, const void* change_ahead,
    void* decided, void* round_errors, void* rounds, int num_codes, int n,
    int rows, int dc, int table_rows, int dv, int pad_pos, int wpc,
    int max_iters, int clamp, void* stream) {
  if (dv > ldpc::kMaxDegree || dv < 1 || dc < 1 || wpc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_codes <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem_bytes =
      (static_cast<size_t>(rows) * dc + rows) * wpc * sizeof(uint32_t) +
      4 * sizeof(int);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ch = static_cast<const int32_t*>(channel);
  const auto* t = static_cast<const int32_t*>(tx);
  const auto* c2v = static_cast<const int32_t*>(chk_to_var);
  const auto* v2s = static_cast<const int32_t*>(var_to_sock);
  const auto* th = static_cast<const int32_t*>(thresholds);
  const auto* ca = static_cast<const int32_t*>(change_ahead);
  auto* dec = static_cast<int32_t*>(decided);
  auto* re = static_cast<int32_t*>(round_errors);
  auto* ro = static_cast<int32_t*>(rounds);
#define LDPC_DECODE(D, TX)                                                     \
  launch_decode<D, TX>(num_codes, smem_bytes, s, ch, t, c2v, v2s, th, ca, dec, \
                       re, ro, n, rows, dc, table_rows, dv, pad_pos, wpc,      \
                       max_iters, clamp)
  if (dv <= 4) return tx == nullptr ? LDPC_DECODE(4, false) : LDPC_DECODE(4, true);
  return tx == nullptr ? LDPC_DECODE(ldpc::kMaxDegree, false)
                       : LDPC_DECODE(ldpc::kMaxDegree, true);
#undef LDPC_DECODE
}
