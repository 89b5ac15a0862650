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
// registers (planes_for(degree) planes, LSB first), and compared twice.
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
// vmap).  A batch of C codes reads code w / wpc's table slice for word w,
// as K2/K3.
//
// Bound on the H100: memory.  Per (variable, word): dv message words read
// and written, dv parity words, the channel word and the decision (and tx):
// 261 MB a round at n = 1e4, (3,6), one code at W = 768 (0.078 ms).  The
// design:
//   * a thread takes a vector of V adjacent words of every row, V = 4, 2 or
//     1 (16, 8 or 4 bytes; ops/gallager.py gallager_round_vector picks the
//     widest that a code's words and the planes' alignment allow; one
//     vector never holds two codes' words), and kVars = 4 / V consecutive
//     variables (the fastest of 1, 2 and 4 variables a thread at W = 768,
//     and of 1, 2, 4 and 8 at one word, as timed on the H100: PERF.md);
//   * templates over the exact degrees 3 and 4 (the (3,6) codes, the
//     irregular pairs' dv_max), with the count planes sized to the degree
//     (2 and 3, against 6 for kMaxDegree): the socket loop unrolls, and
//     the thread issues the table rows of its kVars variables first, then
//     every parity, message and channel vector of all of them, then
//     computes and stores.  No store can feed a load of the group: each
//     message row belongs to exactly one (variable, socket), and only
//     that thread reads it, before it writes it; so every pointer is
//     __restrict__.  Every other degree, up to kMaxDegree, runs one
//     generic path by run time: one word and one variable a thread, its
//     sockets streamed twice (streamed_pass);
//   * a block is a tile of 32 vectors (its lanes) by kWarps * kVars
//     variables (a run per warp), tiles slowest in the grid, so the rows a
//     tile gathers from (a 512-byte piece of each at V = 4; at one word a
//     code, 32 codes' 128-byte piece) stay in L2 while the tile's blocks
//     run: a 32-byte sector of a batch at one word a code holds 8 codes'
//     words, which the other codes' threads of the tile read soon after;
//   * counts: the lanes of a code in a warp summed (__match_any_sync), the
//     warps' sums added per code in shared memory, then one atomicAdd per
//     code present in the block; integer atomics are exact in any order.
#include "gallager.cuh"

namespace {

using ldpc::count_at_least;
using ldpc::kMaxDegree;
using ldpc::load_ro;
using ldpc::load_rw;
using ldpc::planes_for;
using ldpc::Words;

constexpr int kWarps = ldpc::kThreads / 32;
constexpr int kWordsInFlight = 4;  // words of a socket's rows a thread loads
constexpr int kTileVecs = 32;   // vectors of a row a block takes: its lanes

struct Args {
  int32_t* msg;
  const int32_t* parity;
  const int32_t* channel;
  const int32_t* var_to_sock;
  const int32_t* active;
  int32_t* decided;
  int32_t* counts;
  const int32_t* tx;
  int n, table_rows, dv, dc, pad_pos, words, wpc, threshold, clamp, bands;
};

// Variables a thread: kWordsInFlight / V at the exact degrees (4 at one
// word, 1 at 16 bytes), so a thread has 2 dv + 1 rows' 16 bytes in flight
// at every width; the generic path (D = 0) takes one.
template <int V, int D>
__host__ __device__ constexpr int vars_a_thread() {
  return D > 0 ? kWordsInFlight / V : 1;
}

// The pass for kVars variables from v0 at words w.. of `code`, its D
// sockets held in registers.
template <int V, int D, bool kTx>
__device__ __forceinline__ void held_pass(const Args& a, int code, int v0,
                                          int w, int& errors, int& changed) {
  constexpr int kPlanes = planes_for(D);
  constexpr int kVars = vars_a_thread<V, D>();
  int32_t* __restrict__ msg = a.msg;
  const int32_t* __restrict__ parity = a.parity;
  const int32_t* __restrict__ channel = a.channel;
  int32_t* __restrict__ decided = a.decided;
  const int32_t* __restrict__ tx = a.tx;
  const int words = a.words, dc = a.dc, pad_pos = a.pad_pos;
  // 1. the table rows of the kVars variables
  int s[kVars][D];
#pragma unroll
  for (int k = 0; k < kVars; ++k) {
    const int v = v0 + k;
    const int32_t* row =
        a.var_to_sock + (static_cast<long long>(code) * a.table_rows + v) * D;
#pragma unroll
    for (int p = 0; p < D; ++p)
      s[k][p] = v < a.n ? __ldg(row + p) : pad_pos;
  }
  // 2. every vector they read: channel (and tx), parity (into dis, which
  // then becomes the disagreement) and message
  Words<V> ch[kVars], tw[kVars], dis[kVars][D], old[kVars][D];
#pragma unroll
  for (int k = 0; k < kVars; ++k) {
    const long long at = static_cast<long long>(v0 + k) * words + w;
    if (v0 + k < a.n) {
      ch[k] = load_ro<V>(channel + at);
      if constexpr (kTx) tw[k] = load_ro<V>(tx + at);
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
      if (s[k][p] < pad_pos) {
        const long long check = s[k][p] / dc;
        dis[k][p] = load_ro<V>(parity + check * words + w);
        old[k][p] = load_rw<V>(msg + static_cast<long long>(s[k][p]) *
                                         words + w);
      }
    }
  }
  // 3. the count, the new messages and the decision
#pragma unroll
  for (int k = 0; k < kVars; ++k) {
    if (v0 + k >= a.n) continue;
    uint32_t planes[V][kPlanes] = {};
    int degree = 0;
#pragma unroll
    for (int p = 0; p < D; ++p) {
      if (s[k][p] < pad_pos) {
        ++degree;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          uint32_t carry = dis[k][p].w[i] ^ old[k][p].w[i] ^ ch[k].w[i];
          dis[k][p].w[i] = carry;
#pragma unroll
          for (int q = 0; q < kPlanes; ++q) {
            const uint32_t next = planes[i][q] & carry;
            planes[i][q] ^= carry;
            carry = next;
          }
        }
      }
    }
    const int t_flip =
        a.clamp ? min(a.threshold, max(degree - 1, 1)) : a.threshold;
    uint32_t ge_t[V], ge_t1[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ge_t[i] = count_at_least(planes[i], t_flip);
      ge_t1[i] = t_flip < (1 << kPlanes)
                     ? count_at_least(planes[i], t_flip + 1) : 0u;
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
      if (s[k][p] < pad_pos) {
        Words<V> out;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const uint32_t d = dis[k][p].w[i];
          out.w[i] = ch[k].w[i] ^ ((d & ge_t1[i]) | (~d & ge_t[i]));
          changed += out.w[i] != old[k][p].w[i];
        }
        ldpc::store<V>(msg + static_cast<long long>(s[k][p]) * words + w,
                       out);
      }
    }
    Words<V> dec;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dec.w[i] = ch[k].w[i] ^ count_at_least(planes[i], degree / 2 + 1);
      errors += __popc(kTx ? dec.w[i] ^ tw[k].w[i] : dec.w[i]);
    }
    ldpc::store<V>(decided + static_cast<long long>(v0 + k) * words + w,
                   dec);
  }
}

// The pass for variable v at word w of `code` at any other degree (up to
// kMaxDegree): the sockets streamed twice, first for the count, then for
// the new messages with each parity and message word read again (from L1
// or L2), so a thread holds no array of sockets and the card stays full
// (32 sockets held took 156 registers, one block an SM).
template <bool kTx>
__device__ __forceinline__ void streamed_pass(const Args& a, int code,
                                              int v, int w, int& errors,
                                              int& changed) {
  constexpr int kPlanes = ldpc::kCountPlanes;
  int32_t* __restrict__ msg = a.msg;
  const int32_t* __restrict__ parity = a.parity;
  const int words = a.words, dc = a.dc, pad_pos = a.pad_pos, dv = a.dv;
  if (v >= a.n) return;
  const int32_t* row =
      a.var_to_sock + (static_cast<long long>(code) * a.table_rows + v) * dv;
  const long long at = static_cast<long long>(v) * words + w;
  const uint32_t ch = static_cast<uint32_t>(__ldg(a.channel + at));
  uint32_t planes[kPlanes] = {};
  int degree = 0;
  for (int p = 0; p < dv; ++p) {
    const int s = __ldg(row + p);
    if (s < pad_pos) {
      ++degree;
      uint32_t carry = static_cast<uint32_t>(
          __ldg(parity + static_cast<long long>(s / dc) * words + w) ^
          msg[static_cast<long long>(s) * words + w]) ^ ch;
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
        const uint32_t next = planes[q] & carry;
        planes[q] ^= carry;
        carry = next;
      }
    }
  }
  const int t_flip =
      a.clamp ? min(a.threshold, max(degree - 1, 1)) : a.threshold;
  const uint32_t ge_t = count_at_least(planes, t_flip);
  const uint32_t ge_t1 =
      t_flip < (1 << kPlanes) ? count_at_least(planes, t_flip + 1) : 0u;
  for (int p = 0; p < dv; ++p) {
    const int s = __ldg(row + p);
    if (s < pad_pos) {
      int32_t* slot = msg + static_cast<long long>(s) * words + w;
      const uint32_t was = static_cast<uint32_t>(*slot);
      const uint32_t d = static_cast<uint32_t>(
          __ldg(parity + static_cast<long long>(s / dc) * words + w)) ^
          was ^ ch;
      const uint32_t out = ch ^ ((d & ge_t1) | (~d & ge_t));
      changed += out != was;
      *slot = static_cast<int32_t>(out);
    }
  }
  const uint32_t dec = ch ^ count_at_least(planes, degree / 2 + 1);
  errors += __popc(kTx ? dec ^ static_cast<uint32_t>(__ldg(a.tx + at)) : dec);
  a.decided[at] = static_cast<int32_t>(dec);
}

// D: the exact degree (3 or 4), or 0 for the generic path at one word.
template <int V, int D, bool kTx>
__global__ void __launch_bounds__(ldpc::kThreads)
gallager_variable_kernel(const Args a) {
  constexpr int kVars = vars_a_thread<V, D>();
  __shared__ int sums[2][kTileVecs];    // by code - base
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x / a.bands;
  const int band = blockIdx.x - tile * a.bands;
  const int vec = tile * kTileVecs + lane;
  const int v0 = (band * kWarps + warp) * kVars;
  const int base = tile * kTileVecs * V / a.wpc;  // the block's first code
  if (threadIdx.x < 2 * kTileVecs)
    sums[threadIdx.x / kTileVecs][threadIdx.x % kTileVecs] = 0;
  __syncthreads();

  const int w = vec * V;
  const int code = w < a.words ? w / a.wpc : -1;
  int errors = 0, changed = 0;
  if (code >= 0 && __ldg(a.active + code)) {
    if constexpr (D > 0) {
      held_pass<V, D, kTx>(a, code, v0, w, errors, changed);
    } else {
      static_assert(V == 1, "the generic path moves one word");
      streamed_pass<kTx>(a, code, v0, w, errors, changed);
    }
  }
  // every thread of the block gets here (no early exit)
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, code);
  errors = __reduce_add_sync(peers, errors);
  changed = __reduce_add_sync(peers, changed);
  if (code >= 0 && lane == __ffs(peers) - 1 && (errors | changed) != 0) {
    atomicAdd(&sums[0][code - base], errors);
    atomicAdd(&sums[1][code - base], changed);
  }
  __syncthreads();
  if (threadIdx.x < kTileVecs) {
    const int e = sums[0][threadIdx.x], c = sums[1][threadIdx.x];
    if ((e | c) != 0) {
      atomicAdd(a.counts + 2 * (base + threadIdx.x), e);
      atomicAdd(a.counts + 2 * (base + threadIdx.x) + 1, c);
    }
  }
}

template <int V, int D, bool kTx>
void launch_variable(Args a, cudaStream_t s) {
  constexpr int block_vars = kWarps * vars_a_thread<V, D>();
  const int tiles = (a.words / V + kTileVecs - 1) / kTileVecs;
  a.bands = (a.n + block_vars - 1) / block_vars;
  const auto blocks = static_cast<unsigned int>(tiles) * a.bands;
  gallager_variable_kernel<V, D, kTx><<<blocks, ldpc::kThreads, 0, s>>>(a);
}

template <int V, bool kTx>
int by_degree(const Args& a, cudaStream_t s) {
  if (a.dv == 3) {
    launch_variable<V, 3, kTx>(a, s);
  } else if (a.dv == 4) {
    launch_variable<V, 4, kTx>(a, s);
  } else if constexpr (V == 1) {
    launch_variable<1, 0, kTx>(a, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // generic: one word
  }
  return 0;
}

template <bool kTx>
int by_vector(const Args& a, int vec, cudaStream_t s) {
  if (vec == 4) return by_degree<4, kTx>(a, s);
  if (vec == 2) return by_degree<2, kTx>(a, s);
  return by_degree<1, kTx>(a, s);
}

}  // namespace

// vec: the words a thread moves, 4, 2 or 1, dividing wpc (1 for a dv other
// than 3 and 4); every plane aligned to 4 * vec bytes.
extern "C" int ldpc_gallager_variable(
    void* msg, const void* parity, const void* channel,
    const void* var_to_sock, const void* active, void* decided, void* counts,
    const void* tx, int n, int table_rows, int dv, int dc, int pad_pos,
    int words, int wpc, int threshold, int clamp, int vec, void* stream) {
  if (dv > kMaxDegree || (vec != 4 && vec != 2 && vec != 1) || wpc % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || words <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<int32_t*>(msg),
               static_cast<const int32_t*>(parity),
               static_cast<const int32_t*>(channel),
               static_cast<const int32_t*>(var_to_sock),
               static_cast<const int32_t*>(active),
               static_cast<int32_t*>(decided),
               static_cast<int32_t*>(counts),
               static_cast<const int32_t*>(tx),
               n, table_rows, dv, dc, pad_pos, words, wpc, threshold, clamp,
               0};
  const auto s = static_cast<cudaStream_t>(stream);
  const int rc = tx == nullptr ? by_vector<false>(a, vec, s)
                               : by_vector<true>(a, vec, s);
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
