// Kernel D: the whole erasure-BP decode, all-zero (and in its value form,
// below, random-transmit), one block per block of words of one code.
//
// Replaces iib_project_ldpc_codes_tpu/ops/erasure_bp.py
// bp_decode_packed_allzero (:292-306), as the JAX engine runs it under vmap,
// one while_loop per code (parallel/montecarlo.py:268-285
// _fresh_codes_chunk), and as it runs on one fixed code: the rounds of
// _packed_iteration_allzero (:279-288, the check summary of :186-228 and
// the variable OR of :231-236) with the stop rule of _run_to_fixed_point
// (:66-110).  On the port's host loop this was K2 and K3 per round and one
// host read of the summed count per round.
//
// Every word column of a plane is an independent decode of 32 trials, so a
// block of `wpb` words of one code (wpb divides the code's `wpc`) never
// exchanges data with another, and its stop depends only on its own count:
// one block runs every round of its words with no grid-wide sync and no
// host read.  Block b holds words b * wpb onward, of code b * wpb / wpc.  A
// batch of codes (the ensemble chunks) runs one block a code (wpb = wpc);
// one code runs one block a word (wpb = 1, a table of one code, so every
// block reads the same table, from L2).  On the BEC a block's unchanged
// count is an absorbing fixed point, so a block frozen at its own stop
// holds the plane and the count that the host loop would go on computing
// for it: the per-round sums of the blocks' counts are the host loop's, and
// the wrapper applies the host loop's stop rule to them once.
//
// Dynamic shared memory holds the block's known plane uint32[rows][wpb],
// its exactly-one plane uint32[checks][wpb], four counters, its code's
// chk_to_var table socket-major ([dc][checks], so a warp's index loads are
// consecutive and free of bank conflicts) and a byte per check and word
// (the sockets a summary teaches): 185,016 bytes for a (3,6) code of n =
// 10^4 at one word (32 trials) a block.  A round is
//   1. the check pass: K2's two running masks (a zero seen once, a zero
//      seen twice) over the dc known words of each check, out of shared
//      memory, into the exactly-one plane;
//   2. __syncthreads();
//   3. the variable half as a scatter: for each check with a nonzero
//      exactly-one word e and each of its sockets whose variable is
//      unknown in a trial of e (noted by the check pass),
//      atomicOr(&known[v], e).  OR is idempotent and a trial whose bit is
//      set in e already knows every other participant, so the result is
//      exact in any order; the atomic's old value counts each newly known
//      bit exactly once, and the erasures left are the last count less
//      those bits.  It reads no var_to_chk: the wrapper's chk_to_var and
//      var_to_chk must describe the same graph, as every code of the
//      package does;
//   4. a block reduction of the count, then __syncthreads().
// On the H100 this scatter was faster than a gather over var_to_chk (K3
// per variable) and than 16-bit tables (PERF.md, row 7).
//
// The value form (erasure_decode_values_kernel, decode_block's kValues;
// entry point ldpc_erasure_decode_values) is the random-transmit decode,
// bp_decode_packed (:239-276): the rounds of _packed_iteration (:262-272)
// with the values of _check_summaries (:222-228).  On the port's host
// loop this was check_exactly_one_xor and variable_or_adopt per round.  Shared memory also holds the block's value
// plane val[rows][wpb], set to tx & known (then (2 * rows + checks) * wpb *
// 4 + 16 + checks * dc * 4 + checks * wpb bytes: 225,016 for a (3,6) code
// of n = 10^4 at one word a block).  The check pass, where a check's
// exactly-one word e is nonzero, XORs its sockets' known values, x =
// XOR_j val[v_j] & known[v_j], and ORs e & ~known[v_j] & x into
// val[v_j] of each socket it teaches.  That is JAX's val | (adopt &
// ~known) with the round's old known plane: known does not change during
// the check pass, and an OR touches only bits where its variable is
// unknown, so every other check's masked read val & known is stable, and
// two checks that teach one (variable, trial) in a round both OR their
// value in, as JAX's OR over the variable's checks does (on a codeword
// they agree; the tests also feed planes that are not codewords).  A
// round that leaves a block's count unchanged taught no socket, so its
// val plane is frozen too, and the per-block stop stays exact.
//
// The stop rule per block is _run_to_fixed_point's: start only if the
// channel erased a bit, go on while it < max_iters, the count changed and
// the count > 0.  Outputs: the final known plane, round_errors[block][r]
// (r = 0 the channel's erasures, then the count after each round run, the
// tail after the stop holding the final count) and rounds[block].
//
// Memory: the erased and known planes (and tx and val) are block-major
// [blocks][rows][wpb] (the wrapper transposes), so the loads and the
// stores of a decode coalesce.  A decode's least time on the H100 is set
// by shared memory (each socket's known word read and each check's summary
// written every round, each variable's word written; the value form adds
// its val plane's set-up and dc val words read for each check word that
// teaches) against ~154 MB of device memory for 768 codes of n = 10^4
// (the tables and both planes once).
#include "common.cuh"

namespace {

constexpr int kDecodeThreads = 1024;
// check degrees up to this run the unrolled socket loop (and the one-byte
// socket masks); wider checks the loop over a runtime degree
constexpr int kUnrolledDc = 8;

// Adds v of every thread into *dst: a warp sum, then one atomic a warp.
// Every thread of the block must call it.
__device__ __forceinline__ void block_add(int* dst, int v) {
  v = __reduce_add_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(dst, v);
}

// The decode of one block, both forms; tx and val_out are read and
// written by the value form only.
template <int kMaxDc, bool kValues>
__device__ __forceinline__ void decode_block(
    const int32_t* __restrict__ erased, const int32_t* __restrict__ tx,
    const int32_t* __restrict__ chk_to_var, int32_t* __restrict__ known_out,
    int32_t* __restrict__ val_out, int32_t* __restrict__ round_errors,
    int32_t* __restrict__ rounds, int rows, int checks, int dc, int wpc,
    int wpb, int max_iters) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int words = rows * wpb;
  uint32_t* known = smem;                                // [rows][wpb]
  uint32_t* val = known + words;            // [rows][wpb], the value form
  uint32_t* ex = known + (kValues ? 2 : 1) * words;      // [checks][wpb]
  int* counts = reinterpret_cast<int*>(ex + checks * wpb);  // [4]
  int32_t* c2v = counts + 4;                             // [dc][checks]
  uint8_t* teach_of = reinterpret_cast<uint8_t*>(c2v + checks * dc);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long block = blockIdx.x;
  const long long code = block * wpb / wpc;
  const int32_t* er = erased + block * words;
  const int32_t* c2v_g = chk_to_var + code * checks * dc;
  int32_t* errors_out = round_errors + block * (max_iters + 1);

  // set-up: the known plane, the table socket-major, the channel's count
  if (tid < 4) counts[tid] = 0;
  int erasures = 0;
  for (int i = tid; i < words; i += nthreads) {
    const uint32_t e = static_cast<uint32_t>(__ldg(er + i));
    known[i] = ~e;
    if constexpr (kValues)
      val[i] = static_cast<uint32_t>(__ldg(tx + block * words + i)) & ~e;
    erasures += __popc(e);
  }
  for (int i = tid; i < checks * dc; i += nthreads) {
    const int c = i / dc;
    c2v[(i - c * dc) * checks + c] = __ldg(c2v_g + i);
  }
  __syncthreads();                      // counters zeroed, table in place
  block_add(counts, erasures);
  __syncthreads();
  int current = counts[0];
  if (tid == 0) errors_out[0] = current;

  int it = 0;
  bool go = current > 0 && max_iters > 0;
  while (go) {
    // 1. check pass.  With dc <= kMaxDc the socket loop is unrolled, so a
    // check's dc index loads, then its dc known loads, are in flight
    // together, and the sockets whose variable the summary e teaches
    // (unknown in a trial of e) are noted in teach_of[c][w]; e is stored
    // only where it is nonzero
    for (int c = tid; c < checks; c += nthreads) {
      if (kMaxDc > 0) {
        int var[kMaxDc > 0 ? kMaxDc : 1];
#pragma unroll
        for (int j = 0; j < kMaxDc; ++j)
          var[j] = j < dc ? c2v[j * checks + c] : 0;
        for (int w = 0; w < wpb; ++w) {
          uint32_t unknown[kMaxDc > 0 ? kMaxDc : 1];
#pragma unroll
          for (int j = 0; j < kMaxDc; ++j)
            unknown[j] = j < dc ? ~known[var[j] * wpb + w] : 0u;
          uint32_t once = 0u, twice = 0u;
#pragma unroll
          for (int j = 0; j < kMaxDc; ++j) {
            twice |= once & unknown[j];
            once |= unknown[j];
          }
          const uint32_t e = once & ~twice;
          uint32_t teach = 0u;
#pragma unroll
          for (int j = 0; j < kMaxDc; ++j)
            teach |= static_cast<uint32_t>((unknown[j] & e) != 0u) << j;
          teach_of[c * wpb + w] = static_cast<uint8_t>(teach);
          if (e == 0u) continue;
          ex[c * wpb + w] = e;
          if constexpr (kValues) {
            // the value each taught trial's unknown participant takes
            uint32_t x = 0u;
#pragma unroll
            for (int j = 0; j < kMaxDc; ++j)
              if (j < dc) x ^= val[var[j] * wpb + w] & ~unknown[j];
            x &= e;
#pragma unroll
            for (int j = 0; j < kMaxDc; ++j) {
              const uint32_t bits = x & unknown[j];
              if (bits != 0u) atomicOr(val + var[j] * wpb + w, bits);
            }
          }
        }
      } else {
        for (int w = 0; w < wpb; ++w) {
          uint32_t once = 0u, twice = 0u;
          for (int j = 0; j < dc; ++j) {
            const uint32_t unknown = ~known[c2v[j * checks + c] * wpb + w];
            twice |= once & unknown;
            once |= unknown;
          }
          const uint32_t e = once & ~twice;
          ex[c * wpb + w] = e;
          if constexpr (kValues) {
            if (e == 0u) continue;
            uint32_t x = 0u;
            for (int j = 0; j < dc; ++j) {
              const int at = c2v[j * checks + c] * wpb + w;
              x ^= val[at] & known[at];
            }
            x &= e;
            for (int j = 0; j < dc && x != 0u; ++j) {
              const int at = c2v[j * checks + c] * wpb + w;
              const uint32_t bits = x & ~known[at];
              if (bits != 0u) atomicOr(val + at, bits);
            }
          }
        }
      }
    }
    __syncthreads();
    // 3. variable half: the scatter counts the bits it makes known
    int tally = 0;
    for (int c = tid; c < checks; c += nthreads) {
      for (int w = 0; w < wpb; ++w) {
        if (kMaxDc > 0) {
          uint32_t teach = teach_of[c * wpb + w];
          if (teach == 0u) continue;
          const uint32_t e = ex[c * wpb + w];
          do {
            const int j = __ffs(teach) - 1;
            teach &= teach - 1u;
            tally += __popc(
                e & ~atomicOr(known + c2v[j * checks + c] * wpb + w, e));
          } while (teach != 0u);
        } else {
          const uint32_t e = ex[c * wpb + w];
          if (e == 0u) continue;
          for (int j = 0; j < dc; ++j) {
            uint32_t* k = known + c2v[j * checks + c] * wpb + w;
            // a racing atomic can only have set more bits: skipping an
            // OR that adds nothing keeps the count exact
            if ((*reinterpret_cast<volatile uint32_t*>(k) & e) != e)
              tally += __popc(e & ~atomicOr(k, e));
          }
        }
      }
    }
    // 4. the round's count; the next round's counter is zeroed only after
    // every thread has read this one's twin (two rounds back)
    int* sum = counts + 1 + (it & 1);
    block_add(sum, tally);
    __syncthreads();
    const int next = current - *sum;
    if (tid == 0) {
      errors_out[it + 1] = next;
      counts[1 + ((it + 1) & 1)] = 0;
    }
    ++it;
    go = it < max_iters && next > 0 && next != current;
    current = next;
  }
  for (int r = it + 1 + tid; r <= max_iters; r += nthreads) errors_out[r] = current;
  if (tid == 0) rounds[block] = it;
  int32_t* out = known_out + block * words;
  for (int i = tid; i < words; i += nthreads) out[i] = static_cast<int32_t>(known[i]);
  if constexpr (kValues) {
    int32_t* vout = val_out + block * words;
    for (int i = tid; i < words; i += nthreads)
      vout[i] = static_cast<int32_t>(val[i]);
  }
}

template <int kMaxDc>
__global__ void __launch_bounds__(kDecodeThreads, 1)
erasure_decode_kernel(const int32_t* __restrict__ erased,
                      const int32_t* __restrict__ chk_to_var,
                      int32_t* __restrict__ known_out,
                      int32_t* __restrict__ round_errors,
                      int32_t* __restrict__ rounds, int rows, int checks,
                      int dc, int wpc, int wpb, int max_iters) {
  decode_block<kMaxDc, false>(erased, nullptr, chk_to_var, known_out,
                              nullptr, round_errors, rounds, rows, checks, dc,
                              wpc, wpb, max_iters);
}

template <int kMaxDc>
__global__ void __launch_bounds__(kDecodeThreads, 1)
erasure_decode_values_kernel(const int32_t* __restrict__ erased,
                             const int32_t* __restrict__ tx,
                             const int32_t* __restrict__ chk_to_var,
                             int32_t* __restrict__ known_out,
                             int32_t* __restrict__ val_out,
                             int32_t* __restrict__ round_errors,
                             int32_t* __restrict__ rounds, int rows,
                             int checks, int dc, int wpc, int wpb,
                             int max_iters) {
  decode_block<kMaxDc, true>(erased, tx, chk_to_var, known_out, val_out,
                             round_errors, rounds, rows, checks, dc, wpc, wpb,
                             max_iters);
}

template <int kMaxDc>
int launch_decode(int num_blocks, size_t smem_bytes, cudaStream_t stream,
                  const int32_t* erased, const int32_t* tx,
                  const int32_t* chk_to_var, int32_t* known, int32_t* val,
                  int32_t* round_errors, int32_t* rounds, int rows,
                  int checks, int dc, int wpc, int wpb, int max_iters) {
  cudaError_t opt;
  if (tx == nullptr) {
    opt = cudaFuncSetAttribute(erasure_decode_kernel<kMaxDc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
    if (opt != cudaSuccess) return static_cast<int>(opt);
    erasure_decode_kernel<kMaxDc><<<num_blocks, kDecodeThreads, smem_bytes,
                                    stream>>>(erased, chk_to_var, known,
                                              round_errors, rounds, rows,
                                              checks, dc, wpc, wpb,
                                              max_iters);
  } else {
    opt = cudaFuncSetAttribute(erasure_decode_values_kernel<kMaxDc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
    if (opt != cudaSuccess) return static_cast<int>(opt);
    erasure_decode_values_kernel<kMaxDc><<<num_blocks, kDecodeThreads,
                                           smem_bytes, stream>>>(
        erased, tx, chk_to_var, known, val, round_errors, rounds, rows,
        checks, dc, wpc, wpb, max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// Both entry points: the all-zero form when tx and val are null.
int decode(const void* erased, const void* tx, const void* chk_to_var,
           void* known, void* val, void* round_errors, void* rounds,
           int num_blocks, int rows, int checks, int dc, int wpc, int wpb,
           int max_iters, void* stream) {
  if (dc < 1 || wpb < 1 || wpc < wpb || wpc % wpb || rows < 1 ||
      checks < 1 || max_iters < 0 || (tx == nullptr) != (val == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_blocks <= 0) return static_cast<int>(cudaGetLastError());
  const bool values = tx != nullptr;
  const size_t smem_bytes =
      ((values ? 2 : 1) * static_cast<size_t>(rows) + checks) * wpb *
          sizeof(uint32_t) +
      4 * sizeof(int) + static_cast<size_t>(checks) * dc * sizeof(int32_t) +
      static_cast<size_t>(checks) * wpb;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* er = static_cast<const int32_t*>(erased);
  const auto* t = static_cast<const int32_t*>(tx);
  const auto* c2v = static_cast<const int32_t*>(chk_to_var);
  auto* kn = static_cast<int32_t*>(known);
  auto* v = static_cast<int32_t*>(val);
  auto* re = static_cast<int32_t*>(round_errors);
  auto* ro = static_cast<int32_t*>(rounds);
  if (dc <= kUnrolledDc)
    return launch_decode<kUnrolledDc>(num_blocks, smem_bytes, s, er, t, c2v,
                                      kn, v, re, ro, rows, checks, dc, wpc,
                                      wpb, max_iters);
  return launch_decode<0>(num_blocks, smem_bytes, s, er, t, c2v, kn, v, re,
                          ro, rows, checks, dc, wpc, wpb, max_iters);
}

}  // namespace

// num_blocks blocks of wpb words each (wpb divides wpc, a code's words;
// block b decodes words b * wpb onward of code b * wpb / wpc); smem_bytes =
// (rows + checks) * wpb * 4 + 16 + checks * dc * 4 + checks * wpb (the
// socket masks); the wrapper computes it and checks it against the opt-in
// limit, and a refused opt-in or launch returns its CUDA error.
extern "C" int ldpc_erasure_decode(const void* erased, const void* chk_to_var,
                                   void* known, void* round_errors,
                                   void* rounds, int num_blocks, int rows,
                                   int checks, int dc, int wpc, int wpb,
                                   int max_iters, void* stream) {
  return decode(erased, nullptr, chk_to_var, known, nullptr, round_errors,
                rounds, num_blocks, rows, checks, dc, wpc, wpb, max_iters,
                stream);
}

// The value form: tx and the final val plane beside erased and known, in
// the same block-major layout; smem_bytes gains rows * wpb * 4 (the val
// plane).
extern "C" int ldpc_erasure_decode_values(
    const void* erased, const void* tx, const void* chk_to_var, void* known,
    void* val, void* round_errors, void* rounds, int num_blocks, int rows,
    int checks, int dc, int wpc, int wpb, int max_iters, void* stream) {
  if (tx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return decode(erased, tx, chk_to_var, known, val, round_errors, rounds,
                num_blocks, rows, checks, dc, wpc, wpb, max_iters, stream);
}
