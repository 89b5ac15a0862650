// Gallager-A/B variable pass: new messages, the decision, the stop counts.
//
// Replaces the variable half of iib_project_ldpc_codes_tpu/ops/gallager.py
// _gallager_iteration (:138-175), of gallager_decode_packed_irregular
// (:367-398), and the per-round counts of _gallager_loop (:262-271).  For
// variable v with channel word ch and real sockets p (flat check-socket
// positions s_p = var_to_sock[v, p] below pad_pos):
//   d_p       = parity[s_p / dc] ^ msg[s_p] ^ ch   (extrinsic bit disagrees)
//   msg[s_p]  = ch ^ [#{l != p : d_l} >= t]        (per bit lane)
//   decided   = ch ^ [#{l : d_l} >= degree / 2 + 1]
// with t the threshold as given (regular codes) or, for irregular codes
// (clamp), t = min(threshold, max(degree - 1, 1)): the thread knows its
// variable's degree, so the JAX per-degree select over every candidate
// degree (:331-353) becomes one scalar.  The count of the other sockets is
// the total minus the own bit: #others >= t <=> (d_p and total >= t+1) or
// (not d_p and total >= t), so the total is counted once, bit-sliced in
// registers (kCountPlanes planes, LSB first), and compared twice.
//
// Each new message goes straight to its own socket row.  A socket belongs
// to exactly one (v, p), and the check pass that read the old messages has
// finished (same stream), so the update in place is safe; JAX's inverse
// routing tables (soe, inv_p) are not needed.  Padded sockets (irregular
// codes) are skipped: their rows stay 0, the phantom variable is never
// visited.
//
// Stop counts: counts[code] += (popcount of the decision's errors, number
// of message words that changed).  The errors are the decision itself (the
// all-zero codeword, tx == nullptr) or, for random-codeword transmit
// (gallager.py:252-256), the decision XOR the packed codeword plane
// tx int32[n, W], in an instantiation of their own; `decided` holds the
// decision either way.  A code whose `active` flag is 0 has
// stopped: its threads write nothing, so its messages and decision stay as
// they were when it stopped (the JAX while_loop's per-code semantics under
// vmap).
//
// Layout: one thread per (group of kVarsPerThread variables, word), word
// fastest, so the channel, decision and (for >= 32 words per code) message
// loads of a warp are coalesced 128-byte rows.  Bound on the H100: memory,
// ~2 dv + 2 words of 4 bytes per (variable, word).  The counts of a warp
// are summed per code (__match_any_sync + __reduce_add_sync) before one
// atomicAdd per code and warp; integer atomics are exact in any order.
// A batch of C codes reads code w / wpc's table slice for word w, as K2/K3.
#include "gallager.cuh"

namespace {

using ldpc::count_at_least;
using ldpc::kCountPlanes;
using ldpc::kMaxDegree;

constexpr int kVarsPerThread = 16;

template <bool kTx>
__global__ void gallager_variable_kernel(
    int32_t* msg, const int32_t* __restrict__ parity,
    const int32_t* __restrict__ channel, const int32_t* __restrict__ var_to_sock,
    const int32_t* __restrict__ active, int32_t* __restrict__ decided,
    int32_t* __restrict__ counts, const int32_t* __restrict__ tx, int n,
    int table_rows, int dv, int dc, int pad_pos, int words, int wpc,
    int threshold, int clamp) {
  const long long groups = (n + kVarsPerThread - 1) / kVarsPerThread;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int code = -1, errors = 0, changed = 0;
  if (t < groups * words) {
    const int group = static_cast<int>(t / words);
    const int w = static_cast<int>(t - static_cast<long long>(group) * words);
    code = w / wpc;
    if (__ldg(active + code)) {
      const int v_end = min(n, (group + 1) * kVarsPerThread);
      for (int v = group * kVarsPerThread; v < v_end; ++v) {
        const int32_t* socks =
            var_to_sock + (static_cast<long long>(code) * table_rows + v) * dv;
        const uint32_t ch = static_cast<uint32_t>(
            __ldg(channel + static_cast<long long>(v) * words + w));
        uint32_t dis[kMaxDegree];
        uint32_t planes[kCountPlanes] = {};
        int degree = 0;
#pragma unroll
        for (int p = 0; p < kMaxDegree; ++p) {
          dis[p] = 0u;
          if (p < dv) {
            const int s = __ldg(socks + p);
            if (s < pad_pos) {
              dis[p] = static_cast<uint32_t>(
                           __ldg(parity + static_cast<long long>(s / dc) * words + w) ^
                           msg[static_cast<long long>(s) * words + w]) ^ ch;
              ++degree;
              uint32_t carry = dis[p];
#pragma unroll
              for (int i = 0; i < kCountPlanes; ++i) {
                const uint32_t next = planes[i] & carry;
                planes[i] ^= carry;
                carry = next;
              }
            }
          }
        }
        const int t_flip = clamp ? min(threshold, max(degree - 1, 1)) : threshold;
        const uint32_t ge_t = count_at_least(planes, t_flip);
        const uint32_t ge_t1 =
            t_flip < (1 << kCountPlanes) ? count_at_least(planes, t_flip + 1) : 0u;
#pragma unroll
        for (int p = 0; p < kMaxDegree; ++p) {
          if (p < dv) {
            const int s = __ldg(socks + p);
            if (s < pad_pos) {
              const uint32_t out = ch ^ ((dis[p] & ge_t1) | (~dis[p] & ge_t));
              int32_t* slot = msg + static_cast<long long>(s) * words + w;
              changed += static_cast<uint32_t>(*slot) != out;
              *slot = static_cast<int32_t>(out);
            }
          }
        }
        const uint32_t dec = ch ^ count_at_least(planes, degree / 2 + 1);
        decided[static_cast<long long>(v) * words + w] = static_cast<int32_t>(dec);
        if (kTx) {
          errors += __popc(dec ^ static_cast<uint32_t>(__ldg(
                                     tx + static_cast<long long>(v) * words + w)));
        } else {
          errors += __popc(dec);
        }
      }
    }
  }
  // every lane of every warp gets here (one item per thread, no early exit)
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, code);
  errors = __reduce_add_sync(peers, errors);
  changed = __reduce_add_sync(peers, changed);
  if (code >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1 &&
      (errors | changed) != 0) {
    atomicAdd(counts + 2 * code, errors);
    atomicAdd(counts + 2 * code + 1, changed);
  }
}

}  // namespace

extern "C" int ldpc_gallager_variable(
    void* msg, const void* parity, const void* channel,
    const void* var_to_sock, const void* active, void* decided, void* counts,
    const void* tx, int n, int table_rows, int dv, int dc, int pad_pos,
    int words, int wpc, int threshold, int clamp, void* stream) {
  const long long items =
      static_cast<long long>((n + kVarsPerThread - 1) / kVarsPerThread) * words;
  if (dv > kMaxDegree) return static_cast<int>(cudaErrorInvalidValue);
  if (items > 0) {
    const auto blocks = static_cast<unsigned int>(
        (items + ldpc::kThreads - 1) / ldpc::kThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    auto kernel = tx == nullptr ? gallager_variable_kernel<false>
                                : gallager_variable_kernel<true>;
    kernel<<<blocks, ldpc::kThreads, 0, s>>>(
        static_cast<int32_t*>(msg), static_cast<const int32_t*>(parity),
        static_cast<const int32_t*>(channel),
        static_cast<const int32_t*>(var_to_sock),
        static_cast<const int32_t*>(active), static_cast<int32_t*>(decided),
        static_cast<int32_t*>(counts), static_cast<const int32_t*>(tx), n,
        table_rows, dv, dc, pad_pos, words, wpc, threshold, clamp);
  }
  return static_cast<int>(cudaGetLastError());
}
