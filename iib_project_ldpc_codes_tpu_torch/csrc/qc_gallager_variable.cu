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
// flips at t >= 1.  JAX rolls each check-frame plane by +s into the variable
// frame and each new plane back by -s; here both directions are one index
// computation, z - s plus one conditional add of Z (0 <= s < Z), and no
// rolled copy exists.  The count of the others is the total minus the own
// bit, as in gallager_variable.cu: the total is counted once, bit-sliced in
// registers, and compared twice.
//
// Each new message goes straight to its own socket word: a socket word
// belongs to exactly one (b, z, i), and the check pass that read the old
// messages has finished (same stream), so the update in place is safe.
// Stop counts: counts[0] += popcount of the decision's errors (the decision
// itself, or with tx != nullptr the decision XOR the transmitted codeword
// plane tx int32[n, W]), counts[1] += message words that changed.
//
// The initial messages (init != 0) are the channel word at every socket in
// the check frame, msg[row_i*Z + zc_i] = ch, by the same index computation;
// parity, decided, counts and tx are not touched.
//
// Bound on the H100: memory, 2 dvb loads + dvb stores of messages and parity
// plus the channel, decision and optional tx words, 4 bytes each per
// (variable, word).  blockIdx.y is the variable block, a thread takes N
// adjacent words of a row (qc.cuh), words fastest, grid-stride: every access
// is a coalesced warp access on contiguous rows (the wrap at z = s splits a
// block's stream once).  The disagreement words of all sockets stay in
// registers between the count and the new messages, kDeg * N of them, so the
// kernel is instantiated by degree: N = 4 for base degrees up to 4 and up to
// 8, N = 1 up to kMaxDegree.  Offsets are 64-bit (576 MB of messages at
// Z = 83,334, W = 48).  The counts are reduced across the warp before one
// atomicAdd per warp; integer atomics are exact in any order.
#include "gallager.cuh"
#include "qc.cuh"

namespace {

using ldpc::count_at_least;
using ldpc::kCountPlanes;
using ldpc::kMaxDegree;
using ldpc::qc::Words;

template <int N>
__global__ void qc_gallager_init_kernel(
    int32_t* __restrict__ msg, const int32_t* __restrict__ channel,
    const int32_t* __restrict__ var_row, const int32_t* __restrict__ var_shift,
    int dvb, int lift, int words) {
  const int b = blockIdx.y;
  const int groups = words / N;
  const int items = lift * groups;
  const int32_t* rows = var_row + b * dvb;
  const int32_t* sh = var_shift + b * dvb;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int z = i / groups;
    const int w = (i - z * groups) * N;
    const Words<N> ch =
        ldpc::qc::load<N>(channel + ldpc::qc::at(b, z, lift, words, w));
    for (int p = 0; p < dvb; ++p) {
      const int row = __ldg(rows + p);
      if (row < 0) break;
      ldpc::qc::store<N>(
          msg + ldpc::qc::at(row, ldpc::qc::row_minus(z, __ldg(sh + p), lift),
                             lift, words, w),
          ch);
    }
  }
}

template <bool kTx, int N, int kDeg>
__global__ void qc_gallager_variable_kernel(
    int32_t* msg, const int32_t* __restrict__ parity,
    const int32_t* __restrict__ channel, const int32_t* __restrict__ var_chk,
    const int32_t* __restrict__ var_row, const int32_t* __restrict__ var_shift,
    int32_t* __restrict__ decided, int32_t* __restrict__ counts,
    const int32_t* __restrict__ tx, int dvb, int lift, int words,
    int threshold, int clamp) {
  const int b = blockIdx.y;
  const int groups = words / N;
  const int items = lift * groups;
  const int32_t* chks = var_chk + b * dvb;
  const int32_t* rows = var_row + b * dvb;
  const int32_t* sh = var_shift + b * dvb;
  // the block's degree and flip threshold are the same for every item
  int degree = 0;
  for (int p = 0; p < dvb; ++p) degree += __ldg(rows + p) >= 0;
  const int t_flip = clamp ? min(threshold, max(degree - 1, 1)) : threshold;
  int errors = 0, changed = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int z = i / groups;
    const int w = (i - z * groups) * N;
    const long long own = ldpc::qc::at(b, z, lift, words, w);
    const Words<N> ch = ldpc::qc::load<N>(channel + own);
    Words<N> dis[kDeg];
    uint32_t planes[N][kCountPlanes] = {};
#pragma unroll
    for (int p = 0; p < kDeg; ++p) {
      dis[p] = Words<N>{};
      if (p < degree) {
        const int zc = ldpc::qc::row_minus(z, __ldg(sh + p), lift);
        const Words<N> par = ldpc::qc::load<N>(
            parity + ldpc::qc::at(__ldg(chks + p), zc, lift, words, w));
        const Words<N> old = ldpc::qc::load<N>(
            msg + ldpc::qc::at(__ldg(rows + p), zc, lift, words, w));
#pragma unroll
        for (int l = 0; l < N; ++l) {
          dis[p].v[l] = par.v[l] ^ old.v[l] ^ ch.v[l];
          uint32_t carry = dis[p].v[l];
#pragma unroll
          for (int q = 0; q < kCountPlanes; ++q) {
            const uint32_t next = planes[l][q] & carry;
            planes[l][q] ^= carry;
            carry = next;
          }
        }
      }
    }
    Words<N> ge_t, ge_t1, dec;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      ge_t.v[l] = count_at_least(planes[l], t_flip);
      ge_t1.v[l] = t_flip < (1 << kCountPlanes)
                       ? count_at_least(planes[l], t_flip + 1) : 0u;
      dec.v[l] = ch.v[l] ^ count_at_least(planes[l], degree / 2 + 1);
    }
#pragma unroll
    for (int p = 0; p < kDeg; ++p) {
      if (p < degree) {
        const int zc = ldpc::qc::row_minus(z, __ldg(sh + p), lift);
        int32_t* slot = msg + ldpc::qc::at(__ldg(rows + p), zc, lift, words, w);
        const Words<N> old = ldpc::qc::load<N>(slot);
        Words<N> out;
#pragma unroll
        for (int l = 0; l < N; ++l) {
          out.v[l] = ch.v[l] ^ ((dis[p].v[l] & ge_t1.v[l]) |
                                (~dis[p].v[l] & ge_t.v[l]));
          changed += old.v[l] != out.v[l];
        }
        ldpc::qc::store<N>(slot, out);
      }
    }
    ldpc::qc::store<N>(decided + own, dec);
    if (kTx) {
      const Words<N> sent = ldpc::qc::load<N>(tx + own);
#pragma unroll
      for (int l = 0; l < N; ++l) errors += __popc(dec.v[l] ^ sent.v[l]);
    } else {
#pragma unroll
      for (int l = 0; l < N; ++l) errors += __popc(dec.v[l]);
    }
  }
  // every lane of every warp gets here (grid-stride loop, no early exit)
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    errors += __shfl_down_sync(0xFFFFFFFFu, errors, offset);
    changed += __shfl_down_sync(0xFFFFFFFFu, changed, offset);
  }
  if ((threadIdx.x & 31) == 0 && (errors | changed) != 0) {
    atomicAdd(counts, errors);
    atomicAdd(counts + 1, changed);
  }
}

template <int N, int kDeg>
void launch_variable(void* msg, const void* parity, const void* channel,
                     const void* var_chk, const void* var_row,
                     const void* var_shift, void* decided, void* counts,
                     const void* tx, int nb, int dvb, int lift, int words,
                     int threshold, int clamp, cudaStream_t stream) {
  const long long items = static_cast<long long>(lift) * (words / N);
  auto kernel = tx == nullptr ? qc_gallager_variable_kernel<false, N, kDeg>
                              : qc_gallager_variable_kernel<true, N, kDeg>;
  kernel<<<ldpc::qc::grid_for_planes(items, nb), ldpc::kThreads, 0, stream>>>(
      static_cast<int32_t*>(msg), static_cast<const int32_t*>(parity),
      static_cast<const int32_t*>(channel),
      static_cast<const int32_t*>(var_chk),
      static_cast<const int32_t*>(var_row),
      static_cast<const int32_t*>(var_shift), static_cast<int32_t*>(decided),
      static_cast<int32_t*>(counts), static_cast<const int32_t*>(tx), dvb,
      lift, words, threshold, clamp);
}

template <int N>
void launch_init(void* msg, const void* channel, const void* var_row,
                 const void* var_shift, int nb, int dvb, int lift, int words,
                 cudaStream_t stream) {
  const long long items = static_cast<long long>(lift) * (words / N);
  qc_gallager_init_kernel<N>
      <<<ldpc::qc::grid_for_planes(items, nb), ldpc::kThreads, 0, stream>>>(
          static_cast<int32_t*>(msg), static_cast<const int32_t*>(channel),
          static_cast<const int32_t*>(var_row),
          static_cast<const int32_t*>(var_shift), dvb, lift, words);
}

}  // namespace

extern "C" int ldpc_qc_gallager_variable(
    void* msg, const void* parity, const void* channel, const void* var_chk,
    const void* var_row, const void* var_shift, void* decided, void* counts,
    const void* tx, int nb, int dvb, int lift, int words, int threshold,
    int clamp, int init, void* stream) {
  const long long total = static_cast<long long>(nb) * lift * words;
  if (dvb > kMaxDegree || nb > ldpc::qc::kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (init) {
      if (ldpc::qc::vector_ok(words, {msg, channel})) {
        launch_init<4>(msg, channel, var_row, var_shift, nb, dvb, lift, words,
                       s);
      } else {
        launch_init<1>(msg, channel, var_row, var_shift, nb, dvb, lift, words,
                       s);
      }
    } else {
      const bool vec = dvb <= 8 && ldpc::qc::vector_ok(
          words, {msg, parity, channel, decided, tx});
      auto fn = !vec ? launch_variable<1, kMaxDegree>
                     : (dvb <= 4 ? launch_variable<4, 4>
                                 : launch_variable<4, 8>);
      fn(msg, parity, channel, var_chk, var_row, var_shift, decided, counts,
         tx, nb, dvb, lift, words, threshold, clamp, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
