// Device functions shared by the code samplers (sample_regular_codes.cu,
// sample_irregular_codes.cu): the Fisher-Yates shuffle, run as rounds of
// deterministic reservations, the duplicate flags of the check rows and
// the repair loop, on the documented Philox stream (the port's
// models/ensemble.py docstring).  Both samplers run one block of
// kSamplerThreads per code.
//
// The shuffle.  Fisher-Yates from the identity swaps positions i and H[i]
// (H[i] = uniform(draw i, i + 1) <= i) for i = E-1 .. 1.  The partners do
// not depend on the permutation, so the block draws them all first.  The
// swaps then run in rounds over every thread of the block (Shun, Gu,
// Blelloch, Fineman, Gibbons, "Sequential random permutation, list
// contraction and tree contraction are highly parallel", SODA 2015):
//   reserve: every pending step i max-writes its priority i into the
//            reservation of position i and of position H[i];
//   commit:  a step that holds both reservations swaps the two positions,
//            clears both reservations and is done; the others stay
//            pending.
// A step waits exactly for the earlier (higher) pending steps that share a
// position with it, so the steps of one round touch disjoint positions and
// every position sees its swaps in the sequential order: the permutation is
// bit for bit the sequential one.  The highest pending step always commits,
// so every round makes progress; the number of rounds is the dependence
// depth (33-34 at E = 30,000, 22-25 at 3,000).  Clearing inside the commit
// pass is safe: a step reading a cleared reservation reads 0, never its own
// priority, and the reservations that a losing step holds stay valid until
// it commits, since the set of pending steps only shrinks.
//
// Memory.  Position x is one word: the permutation's value in the low half,
// the reservation in the high half.  A reservation is an atomicMax of
// (i << half) | perm[x] on the whole word: perm[x] does not change while
// steps reserve, so the low halves are equal and the high halves decide.
// A commit writes each word once, swapped value and cleared reservation
// together.  Layouts (the wrappers pick one from E, models/ensemble.py
// sampler_layout):
//   kAllShared   (E <= SHARED_PARTNERS_MAX_SOCKETS): 32-bit words (16-bit
//                halves) and 16-bit partners in shared memory, 6 bytes a
//                socket, beside 8 KB of pending masks;
//   kWordsShared (E <= SHARED_PERM_MAX_SOCKETS): the words in shared
//                memory, the partners in a global scratch buffer (L2);
//   kGlobal      (above): 64-bit words, 32-bit partners and the masks in
//                a global scratch buffer; any E below 2^31.
// Thread t owns steps i = 1 + t + k * blockDim.x; a 64-bit mask per thread
// and segment of 64 k's marks its pending steps, so a pass visits only
// pending steps (about 3.5 E visits over all rounds at E = 30,000).  After
// the shuffle the masks' memory holds the check rows' duplicate flags.
//
// Every loop condition that guards a barrier is block-uniform
// (__syncthreads_or), and the repair loop runs in warp 0 alone.
#pragma once

#include "common.cuh"

namespace ldpc {
namespace sampler {

constexpr int kSamplerThreads = 1024;
constexpr uint32_t kRepairStream = 0x80000000u;
constexpr int kRaw = 0, kReject = 1;  // kRepair = 2
constexpr int kGlobal = 0, kWordsShared = 1, kAllShared = 2;

template <int kLayout>
struct Layout {  // kAllShared, kWordsShared
  using Word = uint32_t;
  using Half = uint16_t;
  using Partner = uint16_t;
  static constexpr int kShift = 16;
};
template <>
struct Layout<kGlobal> {
  using Word = unsigned long long;
  using Half = uint32_t;
  using Partner = uint32_t;
  static constexpr int kShift = 32;
};

__host__ __device__ inline long long round8(long long bytes) {
  return (bytes + 7) / 8 * 8;
}

// Segments of 64 steps a thread: ceil(E / (64 * threads)).  Their masks
// also hold the m <= E duplicate flags of the check rows.
__host__ __device__ inline long long mask_segments(long long E) {
  return (E + 64LL * kSamplerThreads - 1) / (64LL * kSamplerThreads);
}

// Dynamic shared memory of a block: masks first (8-byte aligned), then the
// words, then the partners.
__host__ __device__ inline long long shared_bytes(int layout, long long E) {
  const long long masks = 8LL * kSamplerThreads;
  if (layout == kAllShared) return masks + 4 * E + round8(2 * E);
  if (layout == kWordsShared) return masks + 4 * E;
  return 0;
}

// Global scratch of one code: the partners (kWordsShared), or the words,
// the masks and the partners (kGlobal).
__host__ __device__ inline long long scratch_bytes(int layout, long long E) {
  if (layout == kWordsShared) return round8(2 * E);
  if (layout == kGlobal)
    return 8 * E + 8LL * kSamplerThreads * mask_segments(E) + round8(4 * E);
  return 0;
}

template <int kLayout>
struct Buffers {
  typename Layout<kLayout>::Word* words;
  typename Layout<kLayout>::Partner* partner;  // indexed by step, [0] unused
  unsigned long long* masks;                   // [segment][thread]
};

// The block's buffers: dynamic shared memory and/or this code's slice of
// the global scratch, laid out as shared_bytes / scratch_bytes say.
template <int kLayout>
__device__ Buffers<kLayout> carve(unsigned char* smem, unsigned char* scratch,
                                  long long E, uint32_t code) {
  using L = Layout<kLayout>;
  Buffers<kLayout> b;
  unsigned char* mine =
      scratch + static_cast<long long>(code) * scratch_bytes(kLayout, E);
  if (kLayout == kGlobal) {
    b.words = reinterpret_cast<typename L::Word*>(mine);
    b.masks = reinterpret_cast<unsigned long long*>(mine + 8 * E);
    b.partner = reinterpret_cast<typename L::Partner*>(
        mine + 8 * E + 8LL * kSamplerThreads * mask_segments(E));
  } else {
    b.masks = reinterpret_cast<unsigned long long*>(smem);
    b.words = reinterpret_cast<typename L::Word*>(smem + 8 * kSamplerThreads);
    b.partner = reinterpret_cast<typename L::Partner*>(
        kLayout == kAllShared ? smem + 8 * kSamplerThreads + 4 * E : mine);
  }
  return b;
}

template <typename Word>
__device__ __forceinline__ int low(Word w, int shift) {
  return static_cast<int>(w & ((Word(1) << shift) - 1));
}

static __device__ __forceinline__ int uniform_below(uint32_t lo, uint32_t hi,
                                                    uint32_t bound) {
  const unsigned long long r =
      (static_cast<unsigned long long>(hi) << 32) | lo;
  return static_cast<int>(__umul64hi(r, static_cast<unsigned long long>(bound)));
}

// Fisher-Yates permutation of [0, E) for shuffle stream `attempt`, as
// rounds of reservations (top of this file).  Leaves perm[x] in the low
// half of words[x] and every high half 0; returns the number of rounds.
// Called by every thread of the block.
template <int kLayout>
__device__ int shuffle(const Buffers<kLayout>& b, int E, uint32_t code,
                       uint32_t chunk, uint32_t attempt, uint2 key) {
  using Word = typename Layout<kLayout>::Word;
  using Partner = typename Layout<kLayout>::Partner;
  constexpr int kShift = Layout<kLayout>::kShift;
  const Word kLow = (Word(1) << kShift) - 1;
  const int T = kSamplerThreads, t = threadIdx.x;
  const int segments = static_cast<int>(mask_segments(E));
  for (int e = t; e < E; e += T) b.words[e] = static_cast<Word>(e);
  // partners of steps 2q and 2q + 1 from one Philox block
  for (int q = t; q <= (E - 1) >> 1; q += T) {
    const uint4 r = ldpc::philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), code, chunk, attempt), key);
    const int i0 = 2 * q, i1 = 2 * q + 1;
    if (i0 >= 1) {
      b.partner[i0] = static_cast<Partner>(uniform_below(r.x, r.y, i0 + 1));
    }
    if (i1 < E) {
      b.partner[i1] = static_cast<Partner>(uniform_below(r.z, r.w, i1 + 1));
    }
  }
  bool pending = false;
  for (int g = 0; g < segments; ++g) {
    const long long first = 1 + t + 64LL * g * T;
    unsigned long long bits = 0;
    if (first < E) {
      const long long count = (E - 1 - first) / T + 1;
      bits = count >= 64 ? ~0ull : (1ull << count) - 1;
    }
    b.masks[g * T + t] = bits;
    pending |= bits != 0;
  }
  int rounds = 0;
  while (__syncthreads_or(pending)) {
    ++rounds;
    for (int g = 0; g < segments; ++g) {  // reserve
      for (unsigned long long bits = b.masks[g * T + t]; bits;
           bits &= bits - 1) {
        const int k = 64 * g + __ffsll(static_cast<long long>(bits)) - 1;
        const int i = 1 + t + k * T;
        const int h = b.partner[i];
        const Word tag = static_cast<Word>(i) << kShift;
        atomicMax(b.words + i, tag | (b.words[i] & kLow));
        if (h != i) atomicMax(b.words + h, tag | (b.words[h] & kLow));
      }
    }
    __syncthreads();
    pending = false;
    for (int g = 0; g < segments; ++g) {  // commit and clear
      unsigned long long left = b.masks[g * T + t];
      for (unsigned long long bits = left; bits; bits &= bits - 1) {
        const int k = 64 * g + __ffsll(static_cast<long long>(bits)) - 1;
        const int i = 1 + t + k * T;
        const int h = b.partner[i];
        const Word at_i = b.words[i], at_h = b.words[h];
        if ((at_i >> kShift) == static_cast<Word>(i) &&
            (at_h >> kShift) == static_cast<Word>(i)) {
          b.words[i] = at_h & kLow;
          b.words[h] = at_i & kLow;
          left &= ~(1ull << (k - 64 * g));
        }
      }
      b.masks[g * T + t] = left;
      pending |= left != 0;
    }
  }
  return rounds;
}

// Check rows of a regular code: row r owns sockets r*dc .. r*dc + dc-1,
// and permuted socket p belongs to variable p / dv.
struct RegularRows {
  int dv, dc, m;
  __device__ int begin(int r) const { return r * dc; }
  __device__ int end(int r) const { return r * dc + dc; }
  __device__ int var(int p) const { return p / dv; }
  __device__ int row(int s) const { return s / dc; }
};

// Check rows of an irregular spec (models/irregular.py socket maps).
struct IrregularRows {
  const int32_t* __restrict__ socket_var;
  const int32_t* __restrict__ chk_offs;
  const int32_t* __restrict__ chk_of_socket;
  int m;
  __device__ int begin(int r) const { return __ldg(chk_offs + r); }
  __device__ int end(int r) const { return __ldg(chk_offs + r + 1); }
  __device__ int var(int p) const { return __ldg(socket_var + p); }
  __device__ int row(int s) const { return __ldg(chk_of_socket + s); }
};

// First socket of row r whose variable repeats an earlier socket of the
// row, or -1.
template <int kLayout, typename Rows>
__device__ int row_first_duplicate(const Buffers<kLayout>& b,
                                   const Rows& rows, int r) {
  constexpr int kShift = Layout<kLayout>::kShift;
  const int s0 = rows.begin(r), s1 = rows.end(r);
  for (int k = s0 + 1; k < s1; ++k) {
    const int v = rows.var(low(b.words[k], kShift));
    for (int l = s0; l < k; ++l) {
      if (rows.var(low(b.words[l], kShift)) == v) return k;
    }
  }
  return -1;
}

constexpr int kCachedRow = 8;

// Whether row r holds a duplicate: a row of up to kCachedRow sockets reads
// its variables once, into registers, then compares them there.
template <int kLayout, typename Rows>
__device__ bool row_has_duplicate(const Buffers<kLayout>& b,
                                  const Rows& rows, int r) {
  const int s0 = rows.begin(r), d = rows.end(r) - s0;
  if (d > kCachedRow) return row_first_duplicate(b, rows, r) >= 0;
  int v[kCachedRow];
#pragma unroll
  for (int k = 0; k < kCachedRow; ++k) {  // distinct negatives past the row
    v[k] = k < d ? rows.var(low(b.words[s0 + k], Layout<kLayout>::kShift))
                 : -1 - k;
  }
  bool dup = false;
#pragma unroll
  for (int k = 1; k < kCachedRow; ++k) {
#pragma unroll
    for (int l = 0; l < k; ++l) dup |= v[k] == v[l];
  }
  return dup;
}

// Flags every check row that holds a duplicate (bit r of the masks'
// memory, one ballot a warp of rows); true, block-uniformly, when any does.
template <int kLayout, typename Rows>
__device__ bool flag_rows(const Buffers<kLayout>& b, const Rows& rows) {
  uint32_t* flags = reinterpret_cast<uint32_t*>(b.masks);
  bool any = false;
  for (int base = 0; base < rows.m; base += blockDim.x) {
    const int r = base + threadIdx.x;
    const bool dup = r < rows.m && row_has_duplicate(b, rows, r);
    const unsigned bits = __ballot_sync(0xffffffffu, dup);
    if ((threadIdx.x & 31) == 0 && r < rows.m) flags[r >> 5] = bits;
    any |= dup;
  }
  return __syncthreads_or(any);
}

// In warp 0: row_first_duplicate with a lane a socket (rows of up to 32
// sockets; longer rows take the serial scan), the same value in every lane.
template <int kLayout, typename Rows>
__device__ int warp_row_first_duplicate(const Buffers<kLayout>& b,
                                        const Rows& rows, int r, int lane) {
  const int s0 = rows.begin(r), d = rows.end(r) - s0;
  if (d > 32) return row_first_duplicate(b, rows, r);
  // lanes past the row hold distinct negative values: never a repeat
  const int v = lane < d ? rows.var(low(b.words[s0 + lane],
                                        Layout<kLayout>::kShift))
                         : -1 - lane;
  bool dup = false;
  for (int k = 0; k + 1 < d; ++k) {
    const int vk = __shfl_sync(0xffffffffu, v, k);
    dup |= k < lane && vk == v;
  }
  const unsigned hit = __ballot_sync(0xffffffffu, dup);
  return hit ? s0 + __ffs(hit) - 1 : -1;
}

// `repair` after flag_rows: pass p swaps the first duplicate s (the first
// flagged row's first offender: rows own ascending runs of sockets) with
// uniform(draw p of the repair stream, E), then rescans the two rows the
// swap touched, until no row is flagged or `max_tries` passes ran.  Warp 0
// runs it, a lane a socket of a row, and draws 32 passes' partners at once
// (they do not depend on the permutation); the block waits at the barrier
// after.
template <int kLayout, typename Rows>
__device__ void repair(const Buffers<kLayout>& b, const Rows& rows, int E,
                       int max_tries, uint32_t code, uint32_t chunk,
                       uint2 key) {
  using Word = typename Layout<kLayout>::Word;
  uint32_t* flags = reinterpret_cast<uint32_t*>(b.masks);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int words = (rows.m + 31) >> 5;
    int partner = 0;  // of pass (pass & ~31) + lane
    for (int pass = 0; pass < max_tries; ++pass) {
      int r = -1;
      for (int base = 0; base < words; base += 32) {
        const uint32_t f = base + lane < words ? flags[base + lane] : 0u;
        const unsigned hit = __ballot_sync(0xffffffffu, f != 0u);
        if (hit) {
          const int l = __ffs(hit) - 1;
          const uint32_t fl = __shfl_sync(0xffffffffu, f, l);
          r = ((base + l) << 5) + __ffs(fl) - 1;
          break;
        }
      }
      if (r < 0) break;  // warp-uniform
      if ((pass & 31) == 0) {
        const uint32_t p = static_cast<uint32_t>(pass + lane);
        const uint4 d = ldpc::philox4x32_10(
            make_uint4(p >> 1, code, chunk, kRepairStream), key);
        partner = (p & 1) ? uniform_below(d.z, d.w, E)
                          : uniform_below(d.x, d.y, E);
      }
      const int j = __shfl_sync(0xffffffffu, partner, pass & 31);
      const int s = warp_row_first_duplicate(b, rows, r, lane);
      __syncwarp();
      if (lane == 0) {
        const Word held = b.words[s];
        b.words[s] = b.words[j];
        b.words[j] = held;
      }
      __syncwarp();
      const int rs = rows.row(s), rj = rows.row(j);
      const bool dup_s = warp_row_first_duplicate(b, rows, rs, lane) >= 0;
      const bool dup_j =
          rj == rs ? dup_s : warp_row_first_duplicate(b, rows, rj, lane) >= 0;
      if (lane == 0) {
        flags[rs >> 5] = dup_s ? flags[rs >> 5] | (1u << (rs & 31))
                               : flags[rs >> 5] & ~(1u << (rs & 31));
        flags[rj >> 5] = dup_j ? flags[rj >> 5] | (1u << (rj & 31))
                               : flags[rj >> 5] & ~(1u << (rj & 31));
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// The permutation after the method's loop (shuffle 0; reject: reshuffle on
// stream pass + 1 while a row holds a duplicate; repair: the repair loop),
// with the first shuffle's rounds written to rounds_out[code] when given.
template <int kLayout, typename Rows>
__device__ void sample_permutation(const Buffers<kLayout>& b, const Rows& rows,
                                   int E, int method, int max_tries,
                                   uint32_t code, uint32_t chunk, uint2 key,
                                   int32_t* rounds_out) {
  const int rounds = shuffle(b, E, code, chunk, 0u, key);
  if (rounds_out != nullptr && threadIdx.x == 0) rounds_out[code] = rounds;
  if (method == kRaw) return;
  bool any = flag_rows(b, rows);
  if (method == kReject) {
    for (int pass = 0; any && pass < max_tries; ++pass) {
      shuffle(b, E, code, chunk, static_cast<uint32_t>(pass + 1), key);
      any = flag_rows(b, rows);
    }
  } else if (any) {
    repair(b, rows, E, max_tries, code, chunk, key);
  }
}

}  // namespace sampler
}  // namespace ldpc
