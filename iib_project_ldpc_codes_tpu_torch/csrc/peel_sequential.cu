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
//   v     = the one unresolved variable of c (JAX's argmax: the first
//           unresolved entry of c's row, the only one at degree 1);
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
// Bound on the H100: a chain of num_erasures dependent steps a trial (each
// step needs the previous step's degrees); the bytes (tables read once,
// evolution written once) take far less.  The parallelism is across
// trials, one warp each, so a step's latency sets the time.  Two forms,
// picked by shape alone (ops/peeling.py::peel_form):
//
// "xor" (n <= 65,535, m <= 65,535, dc <= 15, dv <= 8, its state within one
// block's shared memory): no device-memory load on a step's chain. Per check,
// in shared memory: the residual degree (4 bits) and dv 16-bit accumulators,
// each the XOR over the check's unresolved sockets of: (0) the variable, (k >=
// 1) the variable's check k places further round its row (real entries in row
// order, cyclic; + 1, so 0 means none).  At degree 1 they hold the one
// variable and its other checks in order, so neither the chosen check's row
// nor the variable's row is read: the variable table is read once, at the
// start, by a block of 128 threads (each loads the flags and rows of 4
// variables before it adds any), after which the first warp peels and the
// others leave.  A check listed twice in a row is two sockets and cancels as
// two.  The degree-1 bitmap is split into 32 runs of `per` words (a power of
// two, at least 4), one a lane; each lane keeps its run's inclusive prefix
// count in a register.  The select: a ballot over the prefix counts names the
// holder lane; meanwhile every lane finds in its own run (in registers where
// per = 8, the n = 16,384 case) the word and rank the k-th bit would have; the
// holder's two are shuffled and the bit is found a lane a bit (popc of the
// word below each lane, a ballot).  The update runs on the variable's d lanes,
// each with the list of the variable's other checks by d - 1 shuffles: a check
// listed twice is taken by its first lane with its multiplicity, which reads
// the degree field (no other lane changes it this step) and subtracts every
// socket at once; the bit flips where the degree enters or leaves 1, and each
// lane's (owner lane, change) moves the count and the prefix counts by d
// shuffles.  Every update is a predicated shared-memory reduction, so a step
// takes no branch, and the accumulators are read again only after the next
// select.  The Philox draws are made 32 steps at a time, one a lane, and a
// step's draw is two shuffles taken one step ahead.  54 KB a trial at a (3,6)
// code of n = 16,384: four trials an SM, 528 on the card at once; 70.7 KB at
// dv 4 (three an SM).  NVIDIA H100 80GB HBM3, 700 W, 400 (3,6) codes of n =
// 16,384 at eps = 0.42 (examples/time_peel.py): 2.8-2.9 ms, about 0.4 us a
// step of the longest trial's 7,080, against 13.5 ms for "row".
//
// "row" (every other shape, e.g. n = 300,000): the residual degrees
// (uint8), a bitmap of the degree-1 checks and one of the unresolved
// variables in shared memory (12 KB at n = 16,384), the count kept up to
// date; a step rescans the bitmap (each lane counts its run of words, a
// warp scan finds the lane holding the k-th set bit), reads the chosen
// row from device memory (dc lanes, the first unresolved entry by ballot),
// then lane 0 reads the variable's dv checks and updates the degrees,
// bitmap and count one edge at a time.  Both reads sit on the chain.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool bit_of(const uint32_t* map, int i) {
  return (map[i >> 5] >> (i & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// "xor"
// ---------------------------------------------------------------------------

// The layout of the "xor" form's shared memory in 32-bit words (mirrored by
// ops/peeling.py::peel_xor_layout): the degree-1 bitmap, 32 runs of `per`
// words; the degrees, eight 4-bit fields a word; dv accumulator planes of
// `stride` words, two 16-bit accumulators a word (the odd stride spreads
// the planes of one check over the banks); the erasure count.
struct XorLayout {
  int shift;    // per = 1 << shift bitmap words a lane
  int mx;       // m rounded up to 8
  int stride;   // words of an accumulator plane
  long long words;
};

__host__ __device__ inline XorLayout xor_layout(int m, int dv) {
  XorLayout l;
  const int runs = ((m + 31) / 32 + 31) / 32;   // bitmap words a lane needs
  l.shift = 2;
  while ((1 << l.shift) < runs) ++l.shift;
  l.mx = (m + 7) & ~7;
  l.stride = l.mx / 2 + 1;
  l.words = 32LL * (1 << l.shift) + l.mx / 8 +
            static_cast<long long>(dv) * l.stride + 1;
  return l;
}

// Shared-memory reductions (no value returned) under a predicate, so a
// lane's update needs no branch.
__device__ __forceinline__ void red_add_if(bool p, uint32_t* a, uint32_t v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q red.shared.add.u32 [%0], %1;\n\t}"
      ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(a))), "r"(v),
      "r"(static_cast<uint32_t>(p))
      : "memory");
}

__device__ __forceinline__ void red_xor_if(bool p, uint32_t* a, uint32_t v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
      "@q red.shared.xor.b32 [%0], %1;\n\t}"
      ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(a))), "r"(v),
      "r"(static_cast<uint32_t>(p))
      : "memory");
}

// The degree word and accumulators of one erased variable's sockets: its
// row's real entries (< m) in row order, cyclic; socket a adds the
// variable to plane 0 and its check k places further (+ 1) to plane k.
// Atomics: the lanes' variables may share checks.
template <int DV>
__device__ __forceinline__ void add_variable(const int (&row)[DV], int v,
                                             int m, int stride,
                                             uint32_t* degw, uint32_t* acc) {
  int d = 0;
#pragma unroll
  for (int a = 0; a < DV; ++a) d += row[a] < m;
  int ra = 0;
#pragma unroll
  for (int a = 0; a < DV; ++a) {
    const int ca = row[a];
    if (ca >= m) continue;                    // padded socket
    const int sh = (ca & 1) * 16;
    atomicAdd(&degw[ca >> 3], 1u << ((ca & 7) * 4));
    atomicXor(&acc[ca >> 1], static_cast<uint32_t>(v) << sh);
    int rb = 0;
#pragma unroll
    for (int b = 0; b < DV; ++b) {
      const int cb = row[b];
      if (cb >= m) continue;
      if (b != a) {
        const int k = rb - ra + (rb < ra ? d : 0);
        atomicXor(&acc[k * stride + (ca >> 1)],
                  static_cast<uint32_t>(cb + 1) << sh);
      }
      ++rb;
    }
    ++ra;
  }
}

// A block of kXorInit threads builds the state; then its first warp peels
// and the others leave.
constexpr int kXorInit = 128;

// DV = the variable table's width (3 or 4), or 0: any width up to 8.
// PER = 8 bitmap words a lane (m from 4,097 to 8,192), held in registers
// for the select, or 0: any.
template <int DV, int PER>
__global__ void __launch_bounds__(kXorInit) peel_xor_kernel(
    const int32_t* __restrict__ var, const bool* __restrict__ erased,
    bool* __restrict__ unresolved, int32_t* __restrict__ evolution,
    int32_t* __restrict__ steps_out, int32_t* __restrict__ erasures_out,
    int n, int m, int dv, int batched, int max_steps, uint32_t key0,
    uint32_t key1) {
  extern __shared__ uint4 smem4[];
  constexpr int kRows = 4;          // variables a thread loads at once
  const int dvr = DV > 0 ? DV : dv;
  const XorLayout lay = xor_layout(m, dvr);
  const int per = 1 << lay.shift;
  uint32_t* ones = reinterpret_cast<uint32_t*>(smem4);      // [32 * per]
  uint32_t* degw = ones + 32 * per;                         // [mx / 8]
  uint32_t* acc = degw + lay.mx / 8;                        // [dv][stride]
  const uint16_t* acc16 = reinterpret_cast<const uint16_t*>(acc);
  uint32_t* tally = acc + dvr * lay.stride;                 // [1]
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int32_t* cols =
      var + (batched ? static_cast<long long>(r) * n * dvr : 0);
  const bool* er = erased + static_cast<long long>(r) * n;
  bool* un = unresolved + static_cast<long long>(r) * n;
  int32_t* evo = evolution + static_cast<long long>(r) * (max_steps + 1);

  for (int i = tid; i < lay.words; i += kXorInit) ones[i] = 0u;
  __syncthreads();
  // the erasures: the unresolved output starts as a copy, each erased
  // variable's sockets go into its checks' degrees and accumulators; the
  // flags and rows of kRows variables a thread are loaded before any is
  // used
  int num_erasures = 0;
  constexpr int W = DV > 0 ? DV : 8;          // entries past dv read as m
  for (int base = tid; base < n; base += kXorInit * kRows) {
    bool e[kRows];
    int row[kRows][W];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int v = base + kXorInit * u;
      e[u] = v < n && er[v];
#pragma unroll
      for (int a = 0; a < W; ++a)
        row[u][a] = v < n && a < dvr
                        ? __ldg(cols + static_cast<long long>(v) * dvr + a)
                        : m;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int v = base + kXorInit * u;
      if (v < n) un[v] = e[u];
      if (!e[u]) continue;
      ++num_erasures;
      add_variable<W>(row[u], v, m, lay.stride, degw, acc);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    num_erasures += __shfl_xor_sync(kFull, num_erasures, offset);
  if (lane == 0) atomicAdd(tally, static_cast<uint32_t>(num_erasures));
  __syncthreads();
  if (tid >= 32) return;
  num_erasures = static_cast<int>(*tally);
  // the degree-1 bitmap, a run of `per` words a lane, and the prefix counts
  int own = 0;
  for (int i = 0; i < per; ++i) {
    const int w = lane * per + i;
    uint32_t word = 0;
    for (int q = 0; q < 4; ++q) {
      const int dw = w * 4 + q;             // checks 8 dw .. 8 dw + 7
      if (dw >= lay.mx / 8) break;
      const uint32_t x = degw[dw];
#pragma unroll
      for (int b = 0; b < 8; ++b)
        word |= static_cast<uint32_t>(((x >> (4 * b)) & 15u) == 1u)
                << (q * 8 + b);
    }
    ones[w] = word;
    own += __popc(word);
  }
  int incl = own;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, offset);
    if (lane >= offset) incl += up;
  }
  int count = __shfl_sync(kFull, incl, 31);
  __syncwarp();

  // the draws: lane j holds the Philox words of step 32 q + j, refreshed
  // every 32 steps; a step's draw is two shuffles, taken one step ahead
  const uint2 key = make_uint2(key0, key1);
  uint4 batch = ldpc::philox4x32_10(
      make_uint4(static_cast<uint32_t>(lane), static_cast<uint32_t>(r), 0u,
                 0u), key);
  uint32_t dx = batch.x, dy = batch.y;
  uint32_t nx = __shfl_sync(kFull, dx, 0), ny = __shfl_sync(kFull, dy, 0);
  int t = 0;
  while (count > 0 && t < max_steps) {
    const unsigned long long hi =
        static_cast<unsigned long long>(ny) * count +
        ((static_cast<unsigned long long>(nx) * count) >> 32);
    const int k = static_cast<int>(hi >> 32);
    // the select: the lane whose run holds the k-th set bit (a ballot over
    // the prefix counts); meanwhile every lane finds, in its own run, the
    // word and rank that bit would have; the holder's two are shuffled and
    // the bit is found a lane a bit
    const int src = __ffs(__ballot_sync(kFull, k < incl)) - 1;
    int rank = k - (incl - own);
    uint32_t word = 0;
    int wi = 0;
    if constexpr (PER == 8) {
      const uint4* run = reinterpret_cast<const uint4*>(ones) + 2 * lane;
      const uint4 g0 = run[0], g1 = run[1];
      const uint32_t w[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      int below = 0, at = 0;
      word = w[0];
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        at += __popc(w[i]);
        if (rank >= at) {
          word = w[i + 1];
          wi = i + 1;
          below = at;
        }
      }
      rank -= below;
    } else {
      int at = 0;
      bool found = false;
      for (int i = 0; i < per; ++i) {
        const uint32_t x = ones[lane * per + i];
        const int pc = __popc(x);
        if (!found && rank < at + pc) {
          found = true;
          word = x;
          wi = i;
        }
        if (!found) at += pc;
      }
      rank -= at;
    }
    word = __shfl_sync(kFull, word, src);
    const int held = __shfl_sync(kFull, wi * 32 + rank, src);
    const bool past = __popc(word & (0xFFFFFFFFu >> (31 - lane))) >
                      (held & 31);
    const int chosen = ((src * per + (held >> 5)) << 5) +
                       __ffs(__ballot_sync(kFull, past)) - 1;
    // the next step's draw, off the chain
    if (((t + 1) & 31) == 0) {
      batch = ldpc::philox4x32_10(
          make_uint4(static_cast<uint32_t>(t + 1 + lane),
                     static_cast<uint32_t>(r), 0u, 0u), key);
      dx = batch.x;
      dy = batch.y;
    }
    nx = __shfl_sync(kFull, dx, (t + 1) & 31);
    ny = __shfl_sync(kFull, dy, (t + 1) & 31);
    // the variable and its other checks, from the chosen check's
    // accumulators: lane i < d holds check s_i (s_0 = the chosen one) and
    // takes the checks after it in row order, cs[kk - 1] = s_(i + kk mod d)
    const int x = lane < dvr ? acc16[2 * lane * lay.stride + chosen] : 0;
    const int d = 1 + __popc(__ballot_sync(kFull, lane > 0 && x != 0));
    const int v = __shfl_sync(kFull, x, 0);
    const bool mine = lane < d;
    const int c = lane == 0 ? chosen : mine ? x - 1 : 0;
    const int sh = (c & 1) * 16;
    constexpr int kOthers = DV > 1 ? DV - 1 : 7;
    int cs[kOthers];
    // a check listed twice is counted on its first lane (mult), which
    // alone updates its degree
    int mult = 1;
    bool leader = mine;
#pragma unroll
    for (int kk = 1; kk <= kOthers; ++kk) {
      if (DV == 0 && kk >= dvr) break;
      int j = lane + kk;
      if (j >= d) j -= d;
      cs[kk - 1] = __shfl_sync(kFull, c, j);
      const bool twice = kk < d && cs[kk - 1] == c;
      mult += twice;
      leader &= !(twice && j < lane);
    }
    // the degree before the step (no other lane changes this check's
    // field), then one atomic for every socket of it; its bit flips where
    // the degree enters or leaves 1.  No branch: predicated atomics.
    const int at = (c & 7) * 4;
    const int pre = (degw[c >> 3] >> at) & 15;
    red_add_if(leader, &degw[c >> 3],
               0u - (static_cast<uint32_t>(mult) << at));
    const int delta = leader ? (pre - mult == 1) - (pre == 1) : 0;
    red_xor_if(delta != 0, &ones[c >> 5], 1u << (c & 31));
    const int packed = ((c >> (5 + lay.shift)) << 2) + delta + 1;
    // each socket's accumulators, read again only after the next select
    const bool socket = mine && lane > 0;
    red_xor_if(socket, &acc[c >> 1], static_cast<uint32_t>(v) << sh);
#pragma unroll
    for (int kk = 1; kk <= kOthers; ++kk) {
      if (DV == 0 && kk >= dvr) break;
      red_xor_if(socket && kk < d, &acc[kk * lay.stride + (c >> 1)],
                 static_cast<uint32_t>(cs[kk - 1] + 1) << sh);
    }
    // the bits that changed move the count and the prefix counts
    const int before = count;
#pragma unroll
    for (int i = 0; i < (DV > 0 ? DV : 8); ++i) {
      if (DV == 0 && i >= dvr) break;
      const int p = __shfl_sync(kFull, packed, i);
      const int dd = i < d ? (p & 3) - 1 : 0;
      count += dd;
      incl += lane >= (p >> 2) ? dd : 0;
      own += lane == (p >> 2) ? dd : 0;
    }
    evo[t] = before;                          // every lane: one store
    un[v] = false;
    __syncwarp();
    ++t;
  }

  const bool success = t == num_erasures;   // one variable resolved a step
  for (int s = t + lane; s <= max_steps; s += 32)
    evo[s] = s == t && success ? 0 : -1;
  if (lane == 0) {
    steps_out[r] = t + success;
    erasures_out[r] = num_erasures;
  }
}

// ---------------------------------------------------------------------------
// "row"
// ---------------------------------------------------------------------------

__global__ void peel_row_kernel(
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
// int32[T, max_steps + 1], steps and num_erasures int32[T].  form 0 is
// "row", 1 is "xor" (which reads only `var`); a shape the form does not
// take is refused with cudaErrorInvalidValue.
extern "C" int ldpc_peel_sequential(const void* chk, const void* var,
                                    const void* erased, void* unresolved,
                                    void* evolution, void* steps,
                                    void* erasures, int trials, int n, int m,
                                    int dc, int dv, int batched, int max_steps,
                                    unsigned key0, unsigned key1, int form,
                                    void* stream) {
  if (trials < 0 || n < 1 || m < 1 || dc < 1 || dc > 32 || dv < 1 ||
      dv > 32 || max_steps < 0 || form < 0 || form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1) {
    if (n > 65535 || m > 65535 || dc > 15 || dv > 8)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = 4 * static_cast<size_t>(xor_layout(m, dv).words);
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    if (trials == 0) return 0;
    const bool per8 = xor_layout(m, dv).shift == 3;
    void (*kernel)(const int32_t*, const bool*, bool*, int32_t*, int32_t*,
                   int32_t*, int, int, int, int, int, uint32_t, uint32_t) =
        dv == 3   ? (per8 ? peel_xor_kernel<3, 8> : peel_xor_kernel<3, 0>)
        : dv == 4 ? (per8 ? peel_xor_kernel<4, 8> : peel_xor_kernel<4, 0>)
                  : (per8 ? peel_xor_kernel<0, 8> : peel_xor_kernel<0, 0>);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<trials, kXorInit, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(var), static_cast<const bool*>(erased),
        static_cast<bool*>(unresolved), static_cast<int32_t*>(evolution),
        static_cast<int32_t*>(steps), static_cast<int32_t*>(erasures), n, m,
        dv, batched, max_steps, key0, key1);
    return static_cast<int>(cudaGetLastError());
  }
  if (trials == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>((m + 31) / 32 + (n + 31) / 32) +
                      static_cast<size_t>(m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        peel_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  peel_row_kernel<<<trials, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(chk), static_cast<const int32_t*>(var),
      static_cast<const bool*>(erased), static_cast<bool*>(unresolved),
      static_cast<int32_t*>(evolution), static_cast<int32_t*>(steps),
      static_cast<int32_t*>(erasures), n, m, dc, dv, batched, max_steps, key0,
      key1);
  return static_cast<int>(cudaGetLastError());
}
