// Q4: Gallager-A/B variable pass on a quasi-cyclic code: new messages, the
// decision, the stop counts; and the first messages of a decode.
//
// Replaces the variable half of iib_project_ldpc_codes_tpu/ops/
// qc_gallager.py _qc_gallager_core's step (:68-92), its initial messages
// (:94-96) and the per-round counts of the shared loop.  Messages are
// check-resident, int32[E_b * Z, W] (qc_gallager_check.cu).  Lifted variable
// (b, z) with channel word ch meets, for block b's base sockets i (message
// plane row_i, base check c_i, shift s_i; padded per block with -1), check
// row zc_i = (z - s_i) mod Z:
//   d_i               = parity[c_i*Z + zc_i] ^ msg[row_i*Z + zc_i] ^ ch
//   msg[row_i*Z+zc_i] = ch ^ [#{l != i : d_l} >= t]        (per bit lane)
//   decided[b*Z + z]  = ch ^ [#{l : d_l} >= degree / 2 + 1]
// with t the threshold as given (regular bases) or, for irregular bases
// (clamp), t = min(threshold, max(degree - 1, 1)), by the code's TYPE as JAX
// decides it (:40-51); a degree-1 block has no other socket and so never
// flips at t >= 1, and always does at t <= 0.  The count of the others is
// the total minus the own bit, as in gallager_variable.cu: the total is
// counted once, bit-sliced in registers, and compared twice.
//
// The circulant index: a [Z, W] plane is Z * W contiguous words, and row
// (z - s) mod Z, word w, lies at (z * W + w - s * W) mod (Z * W).  So the
// check frame of a socket is the variable frame rotated by s * W words: a
// thread at word offset o of its block's plane finds the socket's words at
// o - s * W, plus Z * W when that is negative, with no row, no division and
// no rolled copy.  A vector of N words never crosses the wrap (N divides W).
//
// Each new message goes straight to its own socket word: a socket word
// belongs to exactly one (b, z, i), so only the thread of (b, z) reads it,
// before it writes it, and the check pass that read the old messages has
// finished (same stream).  So every pointer is __restrict__, and a thread's
// loads all precede its stores.  Stop counts: counts[0] += popcount of the
// decision's errors (the decision itself, or with tx != nullptr the
// decision XOR the transmitted codeword plane tx int32[n, W]), counts[1] +=
// message words that changed.
//
// The initial messages (init != 0) are the channel word at every socket in
// the check frame, msg[row_i*Z + zc_i] = ch, by the same rotation; parity,
// decided, counts and tx are not touched.
//
// Bound on the H100: memory, per (variable, word) dvb message words read
// and written, dvb parity words, the channel and decision words (and tx),
// 4 bytes each: 0.078 ms at n = 10,008, W = 768 (261 MB).  At n =
// 1,000,008, W = 48 the 96 MB parity plane does not fit the 50 MB L2, and
// it is read once per socket (dvb times), so 2.11 GB move, 0.63 ms.
// The design:
//   * blockIdx.y is the variable block b, so its sockets (table row, plane
//     offsets, s * W) are uniform: staged once in shared memory, and its
//     degree picks the pass by a branch that never diverges;
//   * exact-degree passes for 3 and 4 (the (3,6) bases, the irregular
//     pair's blocks): count planes sized to the degree (2 and 3, against 6
//     for kMaxDegree), every socket unrolled without predicates, the old
//     messages held from their one load for the changed count; every other
//     degree (1 to kMaxDegree) runs one generic pass that streams the
//     sockets twice, as gallager_variable.cu's does;
//   * a thread takes kRows = kWordsInFlight / N vectors of N words (N = 16
//     bytes where W and the planes' alignment allow), kThreads vectors
//     apart, so each of its loads is one coalesced warp access, and issues
//     every channel, tx, parity and message load of all of them before its
//     first store (on the H100, two rows a thread at 16 bytes, 128 or 512
//     threads a block, and 64 or 80 registers were no faster: PERF.md);
//   * a block covers kRows * kThreads vectors of its plane, blocks along x
//     in plane order: no grid-stride loop, no division per item.  Offsets
//     inside a plane are 32-bit (the wrappers hold n * W * 32 below 2^31),
//     plane starts 64-bit (a plane set may exceed 2^31 words);
//   * cache policy: the messages, channel, tx and decision pass through L2
//     once (ld/st.global.cs, evict first); the parity planes, which each
//     of a base check's blocks reads again, load with an L2 evict-last
//     policy, so at n = 10,008 the 15 MB parity set stays in L2 while
//     246 MB stream past (on the H100 9% faster there than the default
//     policy, and equal at n = 10^6, where 96 MB of parity cannot stay;
//     PERF.md); the generic pass keeps the default policy, its second
//     reads meant to hit;
//   * counts summed per warp (__reduce_add_sync), then per block in shared
//     memory, then one atomicAdd pair per block; integer atomics are exact
//     in any order.
// Instantiations: N = 4 and 1, with and without tx, each holding the three
// passes; and the first messages at N = 4 and 1.  Six kernels.
#include "gallager.cuh"
#include "qc.cuh"

namespace {

using ldpc::count_at_least;
using ldpc::kMaxDegree;
using ldpc::kThreads;
using ldpc::load_ro;
using ldpc::load_rw;
using ldpc::planes_for;
using ldpc::Words;

constexpr int kWarps = kThreads / 32;

// Of a plane read once and not again this round (messages, channel, tx):
// the streaming path (ld.global.cs, evict first from L1 and L2).
template <int N>
__device__ __forceinline__ Words<N> load_stream(const int32_t* p) {
  Words<N> r;
  if constexpr (N == 4) {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
    r.w[0] = x.x, r.w[1] = x.y, r.w[2] = x.z, r.w[3] = x.w;
  } else {
    r.w[0] = __ldcs(p);
  }
  return r;
}

// Of a plane written once (messages, decision): st.global.cs.
template <int N>
__device__ __forceinline__ void store_stream(int32_t* p, const Words<N>& r) {
  if constexpr (N == 4) {
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(r.w[0], r.w[1], r.w[2], r.w[3]));
  } else {
    __stcs(p, static_cast<int32_t>(r.w[0]));
  }
}

// Of the parity planes, which every block of a base check reads again: the
// read-only path with an L2 evict-last policy.
template <int N>
__device__ __forceinline__ Words<N> load_kept(const int32_t* p) {
  Words<N> r;
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
      : "=l"(policy));
  if constexpr (N == 4) {
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
        : "l"(p), "l"(policy));
  } else {
    asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
        : "=r"(r.w[0]) : "l"(p), "l"(policy));
  }
  return r;
}

// words of each socket's rows a thread keeps in flight: kRows = 4 / N
// vectors a thread (one at 16 bytes, four at one word)
constexpr int kWordsInFlight = 4;

template <int N>
__host__ __device__ constexpr int rows_a_thread() {
  return kWordsInFlight / N;
}

struct Args {
  int32_t* msg;
  const int32_t* parity;
  const int32_t* channel;
  const int32_t* var_chk;
  const int32_t* var_row;
  const int32_t* var_shift;
  int32_t* decided;
  int32_t* counts;
  const int32_t* tx;
  int dvb, plane, words, threshold, clamp;   // plane = Z * W words
};

// The block's real sockets, compacted to the left of its table row: plane
// starts of the messages and of the parity, and the rotation s * W.
struct Sockets {
  long long msg[kMaxDegree];
  long long par[kMaxDegree];
  int rot[kMaxDegree];
};

// Stage block b's sockets; returns its degree (a barrier: the staged
// entries are visible to every thread after it).
__device__ __forceinline__ int stage(const Args& a, Sockets& sk) {
  const int p = threadIdx.x;
  bool real = false;
  if (p < a.dvb) {
    const int at = blockIdx.y * a.dvb + p;
    const int row = __ldg(a.var_row + at);
    real = row >= 0;
    if (real) {
      sk.msg[p] = static_cast<long long>(row) * a.plane;
      sk.par[p] = static_cast<long long>(__ldg(a.var_chk + at)) * a.plane;
      sk.rot[p] = __ldg(a.var_shift + at) * a.words;
    }
  }
  return __syncthreads_count(real);
}

// Word offset, in the check frame, of the word at `o` in the variable
// frame, for a socket of rotation `rot` (0 <= o, rot < plane).
__device__ __forceinline__ int check_frame(int o, int rot, int plane) {
  const int oc = o - rot;
  return oc < 0 ? oc + plane : oc;
}

// The exact-degree pass: kRows vectors of the block from vector i0, the D
// sockets' words held in registers between the loads and the stores.
template <int N, int D, bool kTx>
__device__ __forceinline__ void held_pass(const Args& a, const Sockets& sk,
                                          int i0, int& errors,
                                          int& changed) {
  constexpr int kRows = rows_a_thread<N>();
  constexpr int kPlanes = planes_for(D);
  const int plane = a.plane, items = plane / N;
  const long long own = static_cast<long long>(blockIdx.y) * plane;
  int32_t* __restrict__ msg = a.msg;
  const int32_t* __restrict__ parity = a.parity;
  const int32_t* __restrict__ channel = a.channel + own;
  int32_t* __restrict__ decided = a.decided + own;
  const int32_t* __restrict__ tx = kTx ? a.tx + own : nullptr;
  long long mb[D], pb[D];
  int rot[D];
#pragma unroll
  for (int p = 0; p < D; ++p) {
    mb[p] = sk.msg[p];
    pb[p] = sk.par[p];
    rot[p] = sk.rot[p];
  }
  // 1. every vector the kRows rows read: channel (and tx), parity (into
  // dis, which then becomes the disagreement) and the old messages
  Words<N> ch[kRows], tw[kRows], dis[kRows][D], old[kRows][D];
  int at[kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    if (i < items) {
      const int o = i * N;
      ch[r] = load_stream<N>(channel + o);
      if constexpr (kTx) tw[r] = load_stream<N>(tx + o);
#pragma unroll
      for (int p = 0; p < D; ++p) {
        at[r][p] = check_frame(o, rot[p], plane);
        dis[r][p] = load_kept<N>(parity + pb[p] + at[r][p]);
        old[r][p] = load_stream<N>(msg + mb[p] + at[r][p]);
      }
    }
  }
  // 2. the count, the new messages and the decision
  const int t_flip =
      a.clamp ? min(a.threshold, max(D - 1, 1)) : a.threshold;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    if (i >= items) continue;
    uint32_t planes[N][kPlanes] = {};
#pragma unroll
    for (int p = 0; p < D; ++p) {
#pragma unroll
      for (int l = 0; l < N; ++l) {
        uint32_t carry = dis[r][p].w[l] ^ old[r][p].w[l] ^ ch[r].w[l];
        dis[r][p].w[l] = carry;
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) {
          const uint32_t next = planes[l][q] & carry;
          planes[l][q] ^= carry;
          carry = next;
        }
      }
    }
    uint32_t ge_t[N], ge_t1[N];
    Words<N> dec;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      ge_t[l] = count_at_least(planes[l], t_flip);
      ge_t1[l] = t_flip < (1 << kPlanes)
                     ? count_at_least(planes[l], t_flip + 1) : 0u;
      dec.w[l] = ch[r].w[l] ^ count_at_least(planes[l], D / 2 + 1);
      if constexpr (kTx) {
        errors += __popc(dec.w[l] ^ tw[r].w[l]);
      } else {
        errors += __popc(dec.w[l]);
      }
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
      Words<N> out;
#pragma unroll
      for (int l = 0; l < N; ++l) {
        const uint32_t d = dis[r][p].w[l];
        out.w[l] = ch[r].w[l] ^ ((d & ge_t1[l]) | (~d & ge_t[l]));
        changed += out.w[l] != old[r][p].w[l];
      }
      store_stream<N>(msg + mb[p] + at[r][p], out);
    }
    store_stream<N>(decided + i * N, dec);
  }
}

// Any other degree (0 to kMaxDegree): each row's sockets streamed twice,
// first for the count, then for the new messages with each parity and
// message vector read again (from L1 or L2), so a thread holds no array of
// sockets whatever the degree.
template <int N, bool kTx>
__device__ __forceinline__ void streamed_pass(const Args& a,
                                              const Sockets& sk, int degree,
                                              int i0, int& errors,
                                              int& changed) {
  constexpr int kRows = rows_a_thread<N>();
  constexpr int kPlanes = ldpc::kCountPlanes;
  const int plane = a.plane, items = plane / N;
  const long long own = static_cast<long long>(blockIdx.y) * plane;
  int32_t* __restrict__ msg = a.msg;
  const int32_t* __restrict__ parity = a.parity;
  const int32_t* __restrict__ channel = a.channel + own;
  int32_t* __restrict__ decided = a.decided + own;
  const int t_flip =
      a.clamp ? min(a.threshold, max(degree - 1, 1)) : a.threshold;
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    if (i >= items) break;
    const int o = i * N;
    const Words<N> ch = load_ro<N>(channel + o);
    Words<N> sent;
    if constexpr (kTx) sent = load_ro<N>(a.tx + own + o);
    uint32_t planes[N][kPlanes] = {};
    for (int p = 0; p < degree; ++p) {
      const int oc = check_frame(o, sk.rot[p], plane);
      const Words<N> par = load_ro<N>(parity + sk.par[p] + oc);
      const Words<N> was = load_rw<N>(msg + sk.msg[p] + oc);
#pragma unroll
      for (int l = 0; l < N; ++l) {
        uint32_t carry = par.w[l] ^ was.w[l] ^ ch.w[l];
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) {
          const uint32_t next = planes[l][q] & carry;
          planes[l][q] ^= carry;
          carry = next;
        }
      }
    }
    uint32_t ge_t[N], ge_t1[N];
    Words<N> dec;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      ge_t[l] = count_at_least(planes[l], t_flip);
      ge_t1[l] = t_flip < (1 << kPlanes)
                     ? count_at_least(planes[l], t_flip + 1) : 0u;
      dec.w[l] = ch.w[l] ^ count_at_least(planes[l], degree / 2 + 1);
      if constexpr (kTx) {
        errors += __popc(dec.w[l] ^ sent.w[l]);
      } else {
        errors += __popc(dec.w[l]);
      }
    }
    for (int p = 0; p < degree; ++p) {
      const int oc = check_frame(o, sk.rot[p], plane);
      int32_t* slot = msg + sk.msg[p] + oc;
      const Words<N> par = load_ro<N>(parity + sk.par[p] + oc);
      const Words<N> was = load_rw<N>(slot);
      Words<N> out;
#pragma unroll
      for (int l = 0; l < N; ++l) {
        const uint32_t d = par.w[l] ^ was.w[l] ^ ch.w[l];
        out.w[l] = ch.w[l] ^ ((d & ge_t1[l]) | (~d & ge_t[l]));
        changed += out.w[l] != was.w[l];
      }
      ldpc::store<N>(slot, out);
    }
    ldpc::store<N>(decided + o, dec);
  }
}

template <int N, bool kTx>
__global__ void __launch_bounds__(kThreads)
qc_gallager_variable_kernel(const Args a) {
  __shared__ Sockets sk;
  __shared__ int sums[2][kWarps];
  const int degree = stage(a, sk);
  const int i0 = blockIdx.x * (rows_a_thread<N>() * kThreads) + threadIdx.x;
  int errors = 0, changed = 0;
  // the block's degree is uniform: the branch never diverges
  if (degree == 3) {
    held_pass<N, 3, kTx>(a, sk, i0, errors, changed);
  } else if (degree == 4) {
    held_pass<N, 4, kTx>(a, sk, i0, errors, changed);
  } else {
    streamed_pass<N, kTx>(a, sk, degree, i0, errors, changed);
  }
  // every thread of the block gets here (no early exit)
  errors = __reduce_add_sync(0xFFFFFFFFu, errors);
  changed = __reduce_add_sync(0xFFFFFFFFu, changed);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sums[0][warp] = errors;
    sums[1][warp] = changed;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int e = 0, c = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      e += sums[0][k];
      c += sums[1][k];
    }
    if ((e | c) != 0) {
      atomicAdd(a.counts, e);
      atomicAdd(a.counts + 1, c);
    }
  }
}

// The first messages: each of kRows vectors' channel words loaded, then
// stored at every socket of the block.
template <int N>
__global__ void __launch_bounds__(kThreads)
qc_gallager_init_kernel(const Args a) {
  constexpr int kRows = rows_a_thread<N>();
  __shared__ Sockets sk;
  const int degree = stage(a, sk);
  const int plane = a.plane, items = plane / N;
  const int i0 = blockIdx.x * (kRows * kThreads) + threadIdx.x;
  const int32_t* __restrict__ channel =
      a.channel + static_cast<long long>(blockIdx.y) * plane;
  int32_t* __restrict__ msg = a.msg;
  Words<N> ch[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    if (i < items) ch[r] = load_stream<N>(channel + i * N);
  }
  for (int p = 0; p < degree; ++p) {
    const long long mb = sk.msg[p];
    const int rot = sk.rot[p];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r * kThreads;
      if (i < items)
        store_stream<N>(msg + mb + check_frame(i * N, rot, plane), ch[r]);
    }
  }
}

template <int N>
int launch(const Args& a, int nb, bool init, cudaStream_t s) {
  constexpr int per_block = rows_a_thread<N>() * kThreads;
  const int items = a.plane / N;
  const dim3 grid((items + per_block - 1) / per_block, nb);
  if (init) {
    qc_gallager_init_kernel<N><<<grid, kThreads, 0, s>>>(a);
  } else if (a.tx == nullptr) {
    qc_gallager_variable_kernel<N, false><<<grid, kThreads, 0, s>>>(a);
  } else {
    qc_gallager_variable_kernel<N, true><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: the words a thread moves per row, 4 (W a multiple of 4, every plane
// 16-byte aligned) or 1; rows: the rows a thread takes, 4 / vec (the
// wrapper's rule, ops/qc_gallager.py qc_variable_layout).
extern "C" int ldpc_qc_gallager_variable(
    void* msg, const void* parity, const void* channel, const void* var_chk,
    const void* var_row, const void* var_shift, void* decided, void* counts,
    const void* tx, int nb, int dvb, int lift, int words, int threshold,
    int clamp, int init, int vec, int rows, void* stream) {
  const long long plane = static_cast<long long>(lift) * words;
  const bool vec_ok =
      (vec == 4 && ldpc::qc::vector_ok(words,
                                       {msg, parity, channel, decided, tx}))
      || vec == 1;
  if (dvb > kMaxDegree || dvb < 1 || nb > ldpc::qc::kMaxPlanes || !vec_ok
      || rows != kWordsInFlight / vec || plane >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb <= 0 || plane == 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<int32_t*>(msg),
               static_cast<const int32_t*>(parity),
               static_cast<const int32_t*>(channel),
               static_cast<const int32_t*>(var_chk),
               static_cast<const int32_t*>(var_row),
               static_cast<const int32_t*>(var_shift),
               static_cast<int32_t*>(decided),
               static_cast<int32_t*>(counts),
               static_cast<const int32_t*>(tx),
               dvb, static_cast<int>(plane), words, threshold, clamp};
  const auto s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch<4>(a, nb, init != 0, s)
                  : launch<1>(a, nb, init != 0, s);
}
