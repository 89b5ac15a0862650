// Kernel B: the soft decoder's variable pass (posterior, error counts).
//
// Replaces iib_project_ldpc_codes_tpu/ops/soft_bp.py:166-171 (_posterior),
// the cast of soft_bp.py:196-199 and the error counts of soft_bp.py:281-299
// (and, in its final form, :308-317).  For variable v and trial b:
//   post = llr0[v, b] + msg[s_0, b] + ... + msg[s_{dv-1}, b]
// in JAX's order (channel first, then the sockets p = 0 .. dv-1 of
// var_to_sock / var_to_edge, each addition rounded on its own), in float32
// for float32 and bfloat16 messages and in integers (JAX: int16) for int8.
// It writes the working-type plane pm = post (float32), bf16(post), or
// int8(clip(post, -127, 127)), which the check pass gathers, and counts
// post < 0: per trial into counts[b] (per_trial != 0) or per code into
// counts[code] (the decode loop's totals need no more), with integer
// atomics, exact in any order.  Padded sockets of an irregular code (s >=
// pad_pos) are skipped: their stored message is 0, and adding 0 changes no
// value.  The columns of a code whose active flag is 0 are left alone.
//
// The final launch (post != nullptr) also writes the float32 posterior of
// the first n_out rows, de-quantised by 1 / scale for int8
// (soft_bp.py:315-317), and the decision post < 0 as a bool plane.
//
// Random-codeword transmit (soft_bp.py:275-285): given the packed codeword
// plane tx int32[n_rows, cols / 32] (trial b in bit b % 32 of word b / 32),
// the counts and the bool plane hold the errors (post < 0) ^ tx; pm and the
// posterior are unchanged.
//
// Bound on the H100: memory.  Per (variable, trial): the channel LLR
// (4 bytes, 1 for int8), dv messages and one pm store in the working type;
// at n = 8192, (3,6), B = 24,576 that is 4.03 GB a round in float32, 2.42 GB
// in bfloat16, 1.01 GB in int8.  The design:
//   * a thread takes V adjacent trials, 16 bytes of a row in the working
//     type (V = 4 float32, 8 bfloat16, 16 int8), or 8 or 4 bytes where 16
//     would cross a code's columns or a plane's alignment, or where dv is
//     outside 2..8 (ops/soft_bp.py soft_posterior_vector picks V), and walks
//     a run of consecutive variables in those columns (its length below);
//   * templates over the exact degree 2..8: the socket loop unrolls, so the
//     dv table loads, then the dv message loads, are all issued before the
//     first add, and a padded socket is a predicate (other degrees up to 32:
//     guarded runs of 8 sockets);
//   * int8 on packed lanes, four trials a 32-bit word (soft.cuh Sum8:
//     int16 pairs, __vadd2, saturation, sign bits);
//   * the lanes of a warp take one tile of columns (32 vectors: whole codes
//     where a code has at most 32 vectors, else a part of one code), so a
//     warp moves a contiguous 128-512-byte row segment, and the 8 warps of
//     a block 8 runs of variables of that tile; a block whose codes are
//     all stopped exits after one barrier;
//   * the grid's order: a band of variables of every tile at a time, so
//     the card streams whole rows; but tiles slowest where a code's piece
//     of a row is under kSmallPiece bytes (int8 codes of 32 trials).  A
//     socket gather reads a code's own piece of a random message row, and
//     a 32-byte piece leaves the rest of its DRAM access to other codes;
//     with the blocks of one tile (n / 16 at runs of 2) filling the card
//     about once, that tile's message slice (24,576 rows x 512 bytes =
//     12.6 MB at the headline shape) stays in L2 until its codes read the
//     rest.  Runs: kTileRows = 2 variables in the tile order, kBandRows = 4
//     in the band order (fewer blocks, so the blocks of stopped codes cost
//     less), kTrialRows = 8 with per-trial counts (one atomic per trial and
//     block).  On the H100 (examples/time_soft_posterior.py) int8 at 768
//     codes takes 0.48 ms so and 0.75 ms in the band order; float32,
//     bfloat16 and one code take 2-3% longer in the tile order;
//   * counts: per-thread counters (bytes packed in words per trial), summed
//     over the block in shared memory, then one atomic per code present in
//     the block (__match_any_sync) or one per trial and block.
#include "soft.cuh"

namespace {

using ldpc::soft::Elem;
using ldpc::soft::Lanes;
using ldpc::soft::load_lanes;
using ldpc::soft::spread_nibble;
using ldpc::soft::store_lanes;
using ldpc::soft::Sum8;

constexpr int kTileRows = 2;    // variables a thread walks: tile order,
constexpr int kBandRows = 4;    // band order,
constexpr int kTrialRows = 8;   // per-trial counts
constexpr int kSmallPiece = 64;  // bytes of a code's row: tiles slowest below
constexpr int kWarps = ldpc::kThreads / 32;   // runs of a block, one a warp
constexpr int kMaxDegree = 32;
constexpr int kChunk = 8;                     // sockets a run, generic path
// each packed byte counter sums at most kTrialRows * kWarps flags
static_assert(kTrialRows * kWarps < 256, "packed per-trial counters overflow");

// The arguments every instantiation takes.
struct Args {
  const void* llr0;
  const void* msg;
  const int32_t* table;
  const int32_t* active;
  void* pm;
  int32_t* counts;
  float* post;
  bool* hard;
  const int32_t* tx;
  int n_rows, n_out, table_rows, dv, pad_pos, cols, cpc, codes, tiles, runs;
  int per_trial;
  int rows;             // variables a thread walks
  bool tiles_slowest;   // grid order: tile-major, else run-major
  float scale;
};

// Where this thread works: its code and first column (code -1: no
// columns), the first variable of its run and whether it runs at all.
struct Place {
  int code = -1, col0 = 0, v0 = 0;
  bool on = false;
};

// The block's tile t and run r (tile-major: blockIdx.x = t * runs + r, or
// run-major: r * tiles + t).  Tile t: k = 32 / vpc whole codes (vpc = cpc
// / V vectors a code, at most 32), lane l in code t*k + l / vpc; or, above
// 32 vectors a code, 32 vectors of code t / tpc.  Run r: the block's kWarps
// runs of `rows` variables, one a warp.
template <int V>
__device__ __forceinline__ Place locate(const Args& a) {
  Place p;
  const int t = a.tiles_slowest ? blockIdx.x / a.runs : blockIdx.x % a.tiles;
  const int r =
      a.tiles_slowest ? blockIdx.x - t * a.runs : blockIdx.x / a.tiles;
  const int lane = threadIdx.x & 31;
  const int vpc = a.cpc / V;
  int vec;
  if (vpc <= 32) {
    const int k = 32 / vpc;
    p.code = lane < k * vpc ? t * k + lane / vpc : a.codes;
    vec = lane % vpc;
  } else {
    const int tpc = (vpc + 31) / 32;
    p.code = t / tpc;
    vec = (t - p.code * tpc) * 32 + lane;
    if (vec >= vpc) p.code = a.codes;
  }
  if (p.code >= a.codes) {
    p.code = -1;
    return p;
  }
  p.col0 = p.code * a.cpc + vec * V;
  p.v0 = (r * kWarps + (threadIdx.x >> 5)) * a.rows;
  p.on = p.v0 < a.n_rows && __ldg(a.active + p.code);
  return p;
}

// The V trials' transmitted bits of variable v (0 without tx).
template <int V>
__device__ __forceinline__ uint32_t tx_bits(const Args& a, int v, int col0) {
  if (a.tx == nullptr) return 0u;
  const uint32_t w = static_cast<uint32_t>(
      __ldg(a.tx + static_cast<long long>(v) * (a.cols / 32) + col0 / 32));
  return (w >> (col0 & 31)) & ((V == 32 ? 0u : 1u << V) - 1u);
}

// Sockets p0 .. p0 + kN - 1 of variable v (those below dv): their kN table
// loads, then the messages of the live ones (row < pad_pos), M holding the
// trials of columns col0.. of a plane of E, all issued before the first is
// handed, in socket order, to add.
template <typename E, typename M, int kN, bool kGuard, typename Add>
__device__ __forceinline__ void gather(const Args& a, const int32_t* tab,
                                       int v, int p0, int col0, Add add) {
  int s[kN];
  unsigned live = 0u;
#pragma unroll
  for (int p = 0; p < kN; ++p) {
    if (!kGuard || p0 + p < a.dv) {
      s[p] = __ldg(tab + v * a.dv + p0 + p);
      live |= static_cast<unsigned>(s[p] < a.pad_pos) << p;
    }
  }
  M m[kN];
#pragma unroll
  for (int p = 0; p < kN; ++p)
    if ((live >> p) & 1u)
      m[p] = *reinterpret_cast<const M*>(
          static_cast<const E*>(a.msg) +
          static_cast<long long>(s[p]) * a.cols + col0);
#pragma unroll
  for (int p = 0; p < kN; ++p)
    if ((live >> p) & 1u) add(m[p]);
}

// The dv messages of variable v into add, in socket order: unrolled at the
// exact degree kDv, or in guarded runs of kDv sockets (the generic path).
template <typename E, typename M, int kDv, bool kExact, typename Add>
__device__ __forceinline__ void gather_all(const Args& a, const int32_t* tab,
                                           int v, int col0, Add add) {
  if constexpr (kExact) {
    gather<E, M, kDv, false>(a, tab, v, 0, col0, add);
  } else {
    for (int p0 = 0; p0 < a.dv; p0 += kDv)
      gather<E, M, kDv, true>(a, tab, v, p0, col0, add);
  }
}

// Per-thread counts: per trial, V byte counters packed four a word; or
// one total.
template <int V>
struct Counts {
  static constexpr int kWords = (V + 3) / 4;
  uint32_t trial[kWords] = {};
  int total = 0;

  __device__ __forceinline__ void add(const Args& a, uint32_t err) {
    if (a.per_trial) {
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        trial[u] += spread_nibble((err >> (4 * u)) & 15u);
    } else {
      total += __popc(err);
    }
  }
};

// The block's sums into counts: every thread of the block calls it.
template <int V>
__device__ __forceinline__ void flush(const Args& a, const Place& p,
                                      const Counts<V>& cnt) {
  constexpr int kWords = Counts<V>::kWords;
  __shared__ uint32_t red[kWarps][kWords][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kWords; ++u)
    red[warp][u][lane] =
        a.per_trial ? cnt.trial[u] : (u ? 0u : static_cast<uint32_t>(cnt.total));
  __syncthreads();
  if (warp != 0) return;
  if (a.per_trial) {
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      uint32_t sum = 0u;   // bytes: at most kTrialRows * kWarps each
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][u][lane];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (sum >> (8 * i)) & 0xFF;
        if (4 * u + i < V && c) atomicAdd(a.counts + p.col0 + 4 * u + i, c);
      }
    }
  } else {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += static_cast<int>(red[w][0][lane]);
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, p.code);
    sum = __reduce_add_sync(peers, sum);
    if (p.code >= 0 && lane == __ffs(peers) - 1 && sum)
      atomicAdd(a.counts + p.code, sum);
  }
}

// V bool lanes from the low V bits of `bits`.
template <int V>
__device__ __forceinline__ void store_flags(bool* at, uint32_t bits) {
  if constexpr (V >= 4) {
    Lanes<uint32_t, V / 4> w;
#pragma unroll
    for (int u = 0; u < V / 4; ++u) w.v[u] = spread_nibble((bits >> (4 * u)) & 15u);
    store_lanes<uint32_t, V / 4>(reinterpret_cast<uint32_t*>(at), w);
  } else {
    Lanes<bool, V> w;
#pragma unroll
    for (int k = 0; k < V; ++k) w.v[k] = (bits >> k) & 1u;
    store_lanes<bool, V>(at, w);
  }
}

// float32 and bfloat16: V trials of a run of variables a thread, float32
// sums.  kExact: dv == kDv; else dv <= kDv, guarded.
template <typename T, int V, int kDv, bool kExact>
__global__ void __launch_bounds__(ldpc::kThreads)
    soft_posterior_kernel(const Args a) {
  using E = Elem<T>;
  using Msg = Lanes<T, V>;
  const Place pl = locate<V>(a);
  if (!__syncthreads_or(pl.on)) return;   // every code of the block stopped
  Counts<V> cnt;
  if (pl.on) {
    const int32_t* tab =
        a.table + static_cast<long long>(pl.code) * a.table_rows * a.dv;
    const int v_end = min(a.n_rows, pl.v0 + a.rows);
    for (int v = pl.v0; v < v_end; ++v) {
      const long long row = static_cast<long long>(v) * a.cols + pl.col0;
      const Lanes<float, V> l =
          load_lanes<float, V>(static_cast<const float*>(a.llr0) + row);
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = l.v[k];
      gather_all<T, Msg, kDv, kExact>(
          a, tab, v, pl.col0, [&](const Msg& m) {
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = E::add(acc[k], E::acc(m.v[k]));
          });
      Lanes<T, V> out;
      uint32_t neg = 0u;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        out.v[k] = E::store(acc[k]);
        neg |= static_cast<uint32_t>(acc[k] < 0.0f) << k;
      }
      store_lanes<T, V>(static_cast<T*>(a.pm) + row, out);
      const uint32_t err = neg ^ tx_bits<V>(a, v, pl.col0);
      cnt.add(a, err);
      if (a.post != nullptr && v < a.n_out) {
        Lanes<float, V> value;
#pragma unroll
        for (int k = 0; k < V; ++k) value.v[k] = acc[k];
        store_lanes<float, V>(a.post + row, value);
        store_flags<V>(a.hard + row, err);
      }
    }
  }
  flush<V>(a, pl, cnt);
}

// int8: U words of four trials of a run of variables a thread, on packed
// lanes (soft.cuh Sum8).
template <int U, int kDv, bool kExact>
__global__ void __launch_bounds__(ldpc::kThreads)
    soft_posterior_kernel_int8(const Args a) {
  constexpr int V = 4 * U;
  using Word = Lanes<uint32_t, U>;
  const Place pl = locate<V>(a);
  if (!__syncthreads_or(pl.on)) return;   // every code of the block stopped
  Counts<V> cnt;
  if (pl.on) {
    const int32_t* tab =
        a.table + static_cast<long long>(pl.code) * a.table_rows * a.dv;
    const int v_end = min(a.n_rows, pl.v0 + a.rows);
    const int8_t* llr0 = static_cast<const int8_t*>(a.llr0);
    for (int v = pl.v0; v < v_end; ++v) {
      const long long row = static_cast<long long>(v) * a.cols + pl.col0;
      const Word l =
          load_lanes<uint32_t, U>(reinterpret_cast<const uint32_t*>(llr0 + row));
      Sum8 acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = Sum8(l.v[u]);
      gather_all<int8_t, Word, kDv, kExact>(
          a, tab, v, pl.col0, [&](const Word& m) {
#pragma unroll
            for (int u = 0; u < U; ++u) acc[u].add(m.v[u]);
          });
      Word out;
      uint32_t neg = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        out.v[u] = acc[u].clipped();
        neg |= acc[u].negative() << (4 * u);
      }
      store_lanes<uint32_t, U>(
          reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.pm) + row), out);
      const uint32_t err = neg ^ tx_bits<V>(a, v, pl.col0);
      cnt.add(a, err);
      if (a.post != nullptr && v < a.n_out) {
        Lanes<float, V> value;
#pragma unroll
        for (int k = 0; k < V; ++k)
          value.v[k] = __fdiv_rn(static_cast<float>(acc[k / 4].value(k % 4)),
                                 a.scale);
        store_lanes<float, V>(a.post + row, value);
        store_flags<V>(a.hard + row, err);
      }
    }
  }
  flush<V>(a, pl, cnt);
}

template <typename T, int V, int kDv, bool kExact>
void launch(const Args& a, cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>(static_cast<long long>(a.runs) * a.tiles);
  if constexpr (sizeof(T) == 1)
    soft_posterior_kernel_int8<V / 4, kDv, kExact>
        <<<blocks, ldpc::kThreads, 0, stream>>>(a);
  else
    soft_posterior_kernel<T, V, kDv, kExact>
        <<<blocks, ldpc::kThreads, 0, stream>>>(a);
}

// The exact-degree instantiations, 2 <= dv <= 8.
template <typename T, int V>
int by_degree(const Args& a, cudaStream_t s) {
  switch (a.dv) {
    case 2: launch<T, V, 2, true>(a, s); break;
    case 3: launch<T, V, 3, true>(a, s); break;
    case 4: launch<T, V, 4, true>(a, s); break;
    case 5: launch<T, V, 5, true>(a, s); break;
    case 6: launch<T, V, 6, true>(a, s); break;
    case 7: launch<T, V, 7, true>(a, s); break;
    case 8: launch<T, V, 8, true>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// p aligned to the bytes of V elements of `elem` bytes, at most 16.
bool aligned(const void* p, int v, int elem) {
  const int bytes = v * elem < 16 ? v * elem : 16;
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// vec: the trials a thread, 16, 8 or 4 bytes of them; 4 bytes outside the
// exact degrees, in runs of kChunk sockets.
template <typename T>
int dispatch(const Args& a, int vec, cudaStream_t s) {
  constexpr int k16 = 16 / sizeof(T), k8 = 8 / sizeof(T), k4 = 4 / sizeof(T);
  constexpr int kLlr = sizeof(T) == 1 ? 1 : 4;
  if (a.cpc % vec || !aligned(a.msg, vec, sizeof(T)) ||
      !aligned(a.pm, vec, sizeof(T)) || !aligned(a.llr0, vec, kLlr) ||
      !aligned(a.post, vec, 4) || !aligned(a.hard, vec, 1))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int rc;
  if (a.dv < 2 || a.dv > 8) {
    if (vec != k4 || a.dv > kMaxDegree) return static_cast<int>(cudaErrorInvalidValue);
    launch<T, k4, kChunk, false>(a, s);
    rc = 0;
  } else if (vec == k16) {
    rc = by_degree<T, k16>(a, s);
  } else if (vec == k8) {
    rc = by_degree<T, k8>(a, s);
  } else if (vec == k4) {
    rc = by_degree<T, k4>(a, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32 (llr0 float32), 1 bfloat16 (llr0 float32), 2 int8 (llr0
// int8).  table: var_to_sock int32[codes, table_rows, dv].  counts: int32[cols]
// with per_trial != 0, else int32[codes].  post and hard: both or neither.
// vec: trials a thread (4, 8 or 16 bytes of them, dividing cpc, every plane
// aligned to its own bytes of them).
extern "C" int ldpc_soft_posterior(
    const void* llr0, const void* msg, const void* table, const void* active,
    void* pm, void* counts, void* post, void* hard, const void* tx,
    int n_rows, int n_out, int table_rows, int dv, int pad_pos, int cols,
    int cpc, int vec, int per_trial, int dtype, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_rows == 0 || cols == 0) return 0;
  if (cols % 4 || cpc < 4 || cpc % 4 || cols % cpc || dv < 1 || vec < 1 ||
      (post == nullptr) != (hard == nullptr) || n_out > n_rows ||
      (tx != nullptr && cols % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int codes = cols / cpc, vpc = cpc / vec;
  const long long tiles = vpc <= 32
                              ? (codes + 32 / vpc - 1) / (32 / vpc)
                              : static_cast<long long>(codes) * ((vpc + 31) / 32);
  const int elem = dtype == ldpc::soft::kFloat32    ? 4
                   : dtype == ldpc::soft::kBfloat16 ? 2
                                                    : 1;
  const bool tiles_slowest = codes > 1 && cpc * elem < kSmallPiece;
  const int rows =
      per_trial ? kTrialRows : tiles_slowest ? kTileRows : kBandRows;
  const long long runs = ((n_rows + rows - 1) / rows + kWarps - 1) / kWarps;
  if (runs * tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{llr0, msg, static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(active), pm,
               static_cast<int32_t*>(counts), static_cast<float*>(post),
               static_cast<bool*>(hard), static_cast<const int32_t*>(tx),
               n_rows, n_out, table_rows, dv,
               pad_pos, cols, cpc, codes, static_cast<int>(tiles),
               static_cast<int>(runs), per_trial, rows, tiles_slowest, scale};
  switch (dtype) {
    case ldpc::soft::kFloat32:
      return dispatch<float>(a, vec, s);
    case ldpc::soft::kBfloat16:
      return dispatch<__nv_bfloat16>(a, vec, s);
    case ldpc::soft::kInt8:
      return dispatch<int8_t>(a, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
