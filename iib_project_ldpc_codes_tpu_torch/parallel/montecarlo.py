"""Batched Monte Carlo BER/FER engine: BEC erasure BP, BSC Gallager-A/B,
and soft BP (sum-product, min-sum, int8 min-sum) on AWGN and BSC LLRs.

The JAX package's engine (``iib_project_ldpc_codes_tpu/parallel/
montecarlo.py``) for its device decoders, with all-zero or random-codeword
transmit (``cfg.transmit``): each chunk
decodes ``cfg.batch`` trials on one device (bit-packed for the BEC and
Gallager decoders, one column per trial for soft BP), and the host loop
applies the reference's stopping rules at chunk granularity (>=
max_block_errors block errors / num_tests / wall clock,
parallel_simulator.py:198).  Every decoder runs on (dv,dc)-regular or
irregular (lam, rho) codes, and on quasi-cyclic (QC) codes of either
kind (``models/qc.py``; below).  Two code modes:

  * ``fixed`` (reference mode 3): one code for the whole run.
  * ``ensemble`` (reference mode 0, the default): every chunk samples
    ``codes_per_chunk`` fresh codes (``models/ensemble.py::sample_codes``
    or ``models/irregular.py::sample_irregular_codes``, kernels on the
    GPU) and decodes them in one batched call, each code on its own
    ``32 * words_per_code`` trials, as the JAX engine's
    ``_fresh_codes_chunk`` (montecarlo.py:268-299).

Random-codeword transmit (``transmit="random"``): the chunk draws fair
information bits, encodes them with kernel E (``models/encode.py``) into
one codeword per trial, sends those, and counts errors against them.  The
systematic encoder is derived on the run's device: once for a fixed code,
and per chunk for the chunk's fresh codes in ensemble mode (one batched
GF(2) elimination over the chunk's codes, which are the zero run's codes
of the same (seed, chunk)).  A BEC trial's errors are its unresolved
erasures plus any resolved bit that differs from the codeword (JAX
``_bp_chunk``, montecarlo.py:109-117; zero by construction, counted all
the same); the Gallager and soft decoders count decision ^ codeword.

Quasi-cyclic codes (a :class:`..models.qc.QCLDPCCode` or
:class:`..models.qc.IrregularQCLDPCCode` as the fixed code): the JAX
engine's gate (montecarlo.py:482-492).  With all-zero transmit and no
expurgation, BEC bp, BSC Gallager and int8 min-sum on AWGN or BSC LLRs
decode by circulant index (``ops/qc_bp.py``, ``ops/qc_gallager.py``,
``ops/qc_soft_bp.py``: no table per lifted edge); every other mode --
random transmit, expurgation, float soft decoding (whose addition order
differs by index, as in JAX) -- runs the generic decoders on
``code.expand()``.  The circulant-index chunk draws the generic chunk's
planes and LLRs from the same (seed, chunk) (kernel A for AWGN, K1 flips
through ``BSC.llr_of_flips`` for the BSC) and its decoders equal the
generic ones on ``expand()`` bit for bit, so a run's counters do not
depend on the way taken; only its speed does.

Several devices (a ``torch.distributed`` group, one rank per device;
:mod:`.mesh`): batch sharding splits each chunk's trials over the ranks
and sums the counters (every family above), and edge sharding
(``cfg.edge_sharded``, fixed-code BEC) splits the code's checks over them
with the batch replicated (:mod:`.edge_sharded`).  Either way a run's
counters do not depend on how it was split beyond the seeding below.

The peeling decoder (``decoder="peeling"``) runs through its own host
driver, :func:`_run_peeling`, as in JAX: on the BEC peeling stops at BP's
fixed point (the maximal stopping set), so its statistics are those of the
packed BP decode run with an n-round budget.

Seeding: chunk ``c`` draws its erasures or flips with Philox key
``philox_key(seed)`` and offset ``c`` (``ops/bitops.py`` gives the full
scheme), its AWGN noise from the same offset on a key of its own
(``ops/channels.py``), its information bits (random transmit) from the
same offset on a third key (``ops/bitops.py::info_planes``), and in
ensemble mode its codes from the sampler's own Philox stream of (seed, c).
Under batch sharding over D ranks, rank r draws all of these at offset
``c * D + r`` in place of ``c`` (and samples ``codes_per_chunk / D``
codes); D = 1 is the single-device stream.  So any run is reproducible
from (seed, batch, codes_per_chunk, D) alone, on
the CPU and the GPU alike (AWGN LLRs to one float32 ulp: the float64
transcendentals of the two devices may round apart), and a resumed run is
bit-identical to an uninterrupted one.  A random-transmit chunk draws the
zero-transmit chunk's noise: on the BEC and with Gallager decoding, whose
updates are exactly symmetric in a codeword shift, the two runs' counters
are then equal.  This replaces the JAX engine's ``fold_in(key(seed), c)``
(whose random runs split off an information key, so their noise differs
from the zero runs'); the two engines draw different planes, noise and
codes and agree in distribution.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from datetime import datetime
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.code import LDPCCode
from ..models.encode import code_encoder_planes, encode_packed
from ..models.ensemble import sample_codes
from ..models.irregular import (IrregularEnsembleSpec, IrregularLDPCCode,
                                sample_irregular_codes)
from ..models.qc import IrregularQCLDPCCode, QCLDPCCode
from ..ops.bitops import bernoulli_packed, info_planes, pack_bits, \
    per_trial_counts
from ..ops.channels import BSC, awgn_llr
from ..ops.erasure_bp import (bp_decode_packed, bp_decode_packed_allzero,
                              bp_decode_packed_allzero_irregular,
                              bp_decode_packed_irregular)
from ..ops.gallager import (gallager_decode_packed,
                            gallager_decode_packed_irregular)
from ..ops.qc_bp import qc_bp_decode_packed_allzero
from ..ops.qc_gallager import qc_gallager_decode_packed
from ..ops.qc_soft_bp import qc_soft_bp_decode
from ..ops.soft_bp import soft_bp_decode, soft_bp_decode_irregular
from ..utils.config import SimulationConfig
from ..utils.results import SimulationResult
from .edge_sharded import (edge_sharded_bp_decode,
                           edge_sharded_bp_decode_irregular)
from .mesh import broadcast_, world


_QC_CODES = (QCLDPCCode, IrregularQCLDPCCode)


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """Counters of one chunk of trials, as device tensors.

    Counts are exact integers; ``bit_errors_sq`` -- the sum of squared
    per-trial final error counts, for the block-level BER variance -- is
    float64, exact below 2^53, where the JAX engine sums it in float32
    (montecarlo.py:129): the two agree to float32's ~1e-7 relative.
    ``code_bit_errors_sq``, ensemble mode only, is the sum over the
    chunk's codes of (per-code counted bit errors)^2: the cluster second
    moment of the clustered BER interval (JAX ``_reduce_code_stats``,
    montecarlo.py:288-299), float64 as well.
    """

    error_totals: torch.Tensor   # int32[iterations+1], counted trials
    block_errors: torch.Tensor   # int64 scalar
    bit_errors: torch.Tensor     # int64 scalar (final erasures, counted)
    excluded: torch.Tensor       # int64 scalar (expurgation-gated trials)
    bit_errors_sq: torch.Tensor  # float64 scalar
    code_bit_errors_sq: Optional[torch.Tensor] = None  # float64 scalar


def _allzero_decode(code, erased: torch.Tensor, iterations: int):
    """The all-zero packed erasure decode of a code's family."""
    if isinstance(code, _QC_CODES):
        return qc_bp_decode_packed_allzero(code, erased, iterations)
    if isinstance(code, IrregularLDPCCode):
        return bp_decode_packed_allzero_irregular(code, erased, iterations)
    return bp_decode_packed_allzero(code, erased, iterations)


def _final_count_stats(error_totals: torch.Tensor, final: torch.Tensor,
                       expurgation: Optional[int],
                       traj: Optional[torch.Tensor] = None,
                       num_codes: Optional[int] = None) -> ChunkStats:
    """ChunkStats from the per-trial final error counts ``final`` [B].

    With ``expurgation = s``, trials with <= s final errors are dropped
    from *all* statistics while still counted as trials
    (parallel_simulator_expurgated.py:238-243); given the per-trial
    trajectories ``traj`` [iterations+1, B], the per-iteration series is
    summed over the included trials only (JAX ``_final_count_stats``).
    ``num_codes`` (a batch of codes, trials split evenly, code-major)
    also records ``code_bit_errors_sq``.
    """
    final = final.to(torch.int64)
    include = torch.ones_like(final, dtype=torch.bool)
    if expurgation is not None:
        include = final > expurgation
        if traj is not None:
            error_totals = (traj * include).sum(1, dtype=torch.int64) \
                .to(torch.int32)
    gated = final * include
    code_sq = None
    if num_codes is not None:
        per_code = gated.reshape(num_codes, -1).sum(1)
        code_sq = (per_code.to(torch.float64) ** 2).sum()
    return ChunkStats(
        error_totals=error_totals,
        block_errors=(include & (final > 0)).sum(),
        bit_errors=gated.sum(),
        excluded=(~include).sum(),
        bit_errors_sq=(gated.to(torch.float64) ** 2).sum(),
        code_bit_errors_sq=code_sq)


def _codes_in(code) -> Optional[int]:
    """C for a batch of codes (ensemble mode), None for one code (a QC
    code is always one)."""
    return code.num_codes if getattr(code, "batched", False) else None


def _bp_chunk(code, erased: torch.Tensor, *, iterations: int,
              expurgation: Optional[int],
              tx: Optional[torch.Tensor] = None) -> ChunkStats:
    """Chunk statistics of the decode of ``erased`` int32[n, W] on one
    code (regular, irregular, or quasi-cyclic with all-zero transmit), or
    on a batch of C codes (word w on code ``w // (W // C)``, which also
    records ``code_bit_errors_sq``).

    ``tx`` (int32[n, W] codewords) decodes the value planes and counts a
    trial's errors as K4 of ``~known | ((val ^ tx) & known)``; without it
    the all-zero decode runs.  Expurgation (all-zero only) by the JAX
    engine's two-pass form: decode, read the final per-trial counts, then
    re-decode with the excluded trials' erasures masked out, so they add
    zero to every per-iteration total.
    """
    if tx is not None:
        if expurgation is not None:
            raise ValueError("random-transmit BEC chunks do not implement "
                             "expurgation")
        decode = bp_decode_packed_irregular \
            if isinstance(code, IrregularLDPCCode) else bp_decode_packed
        res = decode(code, erased, tx, iterations)
        final = per_trial_counts(~res.known | ((res.val ^ tx) & res.known))
        return _final_count_stats(res.error_totals, final, None,
                                  num_codes=_codes_in(code))
    res = _allzero_decode(code, erased, iterations)
    final = res.bit_errors
    error_totals = res.error_totals
    if expurgation is not None:
        include_words = pack_bits((final > expurgation)[None, :])[0]
        error_totals = _allzero_decode(
            code, erased & include_words[None, :], iterations).error_totals
    return _final_count_stats(error_totals, final, expurgation,
                              num_codes=_codes_in(code))


def _gallager_chunk(code, received: torch.Tensor, *, iterations: int,
                    threshold: Optional[int],
                    expurgation: Optional[int],
                    tx: Optional[torch.Tensor] = None) -> ChunkStats:
    """BSC hard-decision chunk (JAX ``_gallager_chunk``): Gallager-A/B on
    the received planes ``received`` int32[n, W] (the flips, or tx ^
    flips for codewords ``tx``) of one code (regular, irregular or
    quasi-cyclic) or a batch; expurgated chunks record per-trial
    trajectories."""
    if isinstance(code, _QC_CODES):
        decode = qc_gallager_decode_packed
    elif isinstance(code, IrregularLDPCCode):
        decode = gallager_decode_packed_irregular
    else:
        decode = gallager_decode_packed
    res = decode(code, received, iterations, threshold=threshold,
                 record="total" if expurgation is None else "per_trial",
                 tx_bits=tx)
    return _final_count_stats(res.error_totals, res.bit_errors, expurgation,
                              traj=res.traj, num_codes=_codes_in(code))


def _soft_chunk(code, llr: torch.Tensor, *, iterations: int, method: str,
                alpha: float, beta: float, msg_dtype: str,
                expurgation: Optional[int],
                tx: Optional[torch.Tensor] = None) -> ChunkStats:
    """AWGN/BSC soft-decision chunk (JAX ``_soft_chunk`` after its
    channel): soft BP on the LLRs ``llr`` float32[n, B] of one code
    (regular, irregular, or quasi-cyclic with all-zero transmit) or a
    batch (trial b on code ``b // (B // C)``), errors counted against the
    codewords ``tx`` (packed) when given; expurgated chunks record
    per-trial trajectories."""
    kw = dict(method=method, alpha=alpha, beta=beta, msg_dtype=msg_dtype,
              record="total" if expurgation is None else "per_trial")
    if isinstance(code, _QC_CODES):
        res = qc_soft_bp_decode(code, llr, iterations, **kw)
    else:
        decode = soft_bp_decode_irregular \
            if isinstance(code, IrregularLDPCCode) else soft_bp_decode
        res = decode(code, llr, iterations, tx_bits=tx, **kw)
    return _final_count_stats(res.error_totals, res.bit_errors, expurgation,
                              traj=res.traj, num_codes=_codes_in(code))


def _ensemble_layout(cfg: SimulationConfig, n_dev: int = 1
                     ) -> tuple[int, int]:
    """(codes per rank-chunk, words per code) of ensemble mode over
    ``n_dev`` ranks: the JAX engine's rule (montecarlo.py:322-331), in one
    place so the chunk and the cluster-size accounting (trials_per_code =
    32 * words per code) never disagree."""
    words = cfg.batch // 32 // n_dev
    num_codes = max(cfg.codes_per_chunk // n_dev, 1)
    while words % num_codes:
        num_codes -= 1
    return num_codes, words // num_codes


def make_chunk_fn(cfg: SimulationConfig, code, device="cuda", rank: int = 0,
                  size: int = 1) -> Callable[[int], ChunkStats]:
    """``fn(chunk_idx) -> ChunkStats`` decoding rank ``rank``'s share,
    ``cfg.batch / size`` trials, of chunk ``chunk_idx`` (batch sharding
    over ``size`` ranks; the sum of the ranks' stats is the chunk's).
    Rank r draws at Philox offset ``chunk_idx * size + r``: an offset
    names a whole stream (``ops/bitops.py``), so no two ranks or chunks
    share a draw, and ``size == 1`` is the single-device stream.

    The port runs, with all-zero or random-codeword transmit, BEC erasure
    BP, BSC Gallager-A/B and soft BP on BSC or AWGN LLRs (sum-product,
    min-sum; float32, bfloat16 or int8 messages) on (dv,dc)-regular or
    irregular (lam, rho) codes, on a fixed code (the reference's mode 3)
    or on fresh codes per chunk (mode 0); ML raises, naming the ROADMAP
    item that ports it, and peeling raises as in JAX: it runs through
    :func:`_run_peeling`.  ``cfg.edge_sharded`` is not read here, as in
    JAX: :func:`run_simulation` takes :func:`make_edge_sharded_chunk_fn`
    for it, whose counters equal this chunk's.  ``code`` is the fixed
    code: an ``LDPCCode``, an ``IrregularLDPCCode`` for an irregular
    configuration, or a quasi-cyclic code of ``n == cfg.n`` whatever the
    configuration's degrees say (the JAX gate: its kind is the code's
    type), decoded by circulant index where the module docstring says and
    on ``expand()`` elsewhere.  Ensemble mode ignores ``code``, as the JAX
    engine does.  Random transmit derives the fixed code's encoder here,
    once.
    """
    pair = (cfg.channel, cfg.decoder)
    if pair in (("BEC", "ml"), ("BEC", "both")):
        raise NotImplementedError(
            f"{pair} decodes with the host ML decoder, not ported yet "
            "(ROADMAP queue 1 item 14)")
    if pair == ("BEC", "peeling"):
        raise NotImplementedError(
            f"{pair} runs through its own host driver (run_simulation's "
            "_run_peeling)")
    if cfg.batch % (32 * size):
        raise ValueError("batch must divide by 32 * n_devices")
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a group of {size}")
    words = cfg.batch // 32 // size

    random = cfg.transmit == "random"
    if random and cfg.expurgation is not None:
        raise ValueError("transmit='random' not supported with expurgation")

    def soft(codes, llr: torch.Tensor, tx) -> ChunkStats:
        return _soft_chunk(codes, llr, iterations=cfg.iterations,
                           method=cfg.decoder, alpha=cfg.minsum_alpha,
                           beta=cfg.minsum_beta,
                           msg_dtype=cfg.soft_msg_dtype,
                           expurgation=cfg.expurgation, tx=tx)

    def decode(codes, offset: int) -> ChunkStats:
        tx = None
        if random:      # one codeword per trial, from the chunk's encoder
            enc = enc_planes if cfg.code_mode == "fixed" else \
                code_encoder_planes(codes)
            tx = encode_packed(enc, info_planes(enc.k, words, seed=cfg.seed,
                                                offset=offset,
                                                device=device))
        if cfg.channel == "AWGN":
            llr = awgn_llr(cfg.channel_param, (cfg.n, 32 * words),
                           seed=cfg.seed, offset=offset, device=device,
                           tx=tx)
            return soft(codes, llr, tx)
        # the same K1 planes are erasures on the BEC, flips on the BSC
        planes = bernoulli_packed(cfg.channel_param, (cfg.n, words),
                                  seed=cfg.seed, offset=offset,
                                  device=device)
        if cfg.channel == "BEC":
            return _bp_chunk(codes, planes, iterations=cfg.iterations,
                             expurgation=cfg.expurgation, tx=tx)
        received = planes if tx is None else planes ^ tx
        if cfg.decoder in ("sumproduct", "minsum"):
            return soft(codes, BSC(cfg.channel_param).llr_of_flips(received),
                        tx)
        return _gallager_chunk(codes, received, iterations=cfg.iterations,
                               threshold=cfg.gallager_threshold,
                               expurgation=cfg.expurgation, tx=tx)

    def offset(chunk_idx: int) -> int:
        return chunk_idx * size + rank

    if cfg.code_mode == "ensemble":
        num_codes, _ = _ensemble_layout(cfg, size)
        if cfg.irregular:
            spec = IrregularEnsembleSpec.from_lam_rho(cfg.n, cfg.lam, cfg.rho,
                                                      device=device)

            def sample(chunk_idx: int):
                return sample_irregular_codes(cfg.seed, chunk_idx, num_codes,
                                              spec, cfg.sampler,
                                              device=device)
        else:
            def sample(chunk_idx: int):
                return sample_codes(cfg.seed, chunk_idx, num_codes, cfg.n,
                                    cfg.dv, cfg.dc, cfg.sampler,
                                    device=device)

        return lambda chunk_idx: decode(sample(offset(chunk_idx)),
                                        offset(chunk_idx))
    if code is None:
        raise ValueError("fixed code_mode requires a code")
    if isinstance(code, _QC_CODES):
        if code.n != cfg.n:
            raise ValueError(f"QC code n={code.n} != cfg.n={cfg.n}")
        code = code.to(device)
        soft_int8 = cfg.decoder == "minsum" and cfg.soft_msg_dtype == "int8"
        by_index = (pair in (("BEC", "bp"), ("BSC", "gallager"))
                    or soft_int8) and cfg.expurgation is None and not random
        if not by_index:
            code = code.expand()
    elif cfg.irregular:
        if not isinstance(code, IrregularLDPCCode) or code.n != cfg.n:
            raise ValueError(f"an irregular config needs an "
                             f"IrregularLDPCCode of n={cfg.n}, got a "
                             f"{type(code).__name__}")
    elif not isinstance(code, LDPCCode):
        raise TypeError(f"a regular config needs an LDPCCode or a QC code, "
                        f"got a {type(code).__name__}")
    elif (code.n, code.dv, code.dc) != (cfg.n, cfg.dv, cfg.dc):
        raise ValueError(f"code (n, dv, dc) = {(code.n, code.dv, code.dc)} "
                         f"!= config {(cfg.n, cfg.dv, cfg.dc)}")
    code = code.to(device)
    enc_planes = code_encoder_planes(code) if random else None
    return lambda chunk_idx: decode(code, offset(chunk_idx))


def _reduce_stats(stats: ChunkStats, group) -> ChunkStats:
    """The ranks' stats summed over ``group`` (JAX's ``psum`` of the
    counters, montecarlo.py:427-444): one int64 and one float64 sum.
    The float64 moments are sums of integers below 2^53, so exact in any
    order: the reduced stats equal the per-rank stats added on one host."""
    counts = torch.cat([stats.error_totals.to(torch.int64), torch.stack(
        [stats.block_errors, stats.bit_errors, stats.excluded]).to(
        torch.int64)])
    code_sq = stats.code_bit_errors_sq
    moments = torch.stack([stats.bit_errors_sq,
                           torch.zeros_like(stats.bit_errors_sq)
                           if code_sq is None else code_sq])
    dist.all_reduce(counts, group=group)
    dist.all_reduce(moments, group=group)
    return ChunkStats(error_totals=counts[:-3], block_errors=counts[-3],
                      bit_errors=counts[-2], excluded=counts[-1],
                      bit_errors_sq=moments[0],
                      code_bit_errors_sq=None if code_sq is None
                      else moments[1])


def make_edge_sharded_chunk_fn(cfg: SimulationConfig, code, device="cuda",
                               group=None) -> Callable[[int], ChunkStats]:
    """``fn(chunk_idx) -> ChunkStats`` of a huge-n fixed-code BEC run with
    the graph's checks split over ``group``'s ranks
    (:mod:`.edge_sharded`; default the whole job, or this process alone)
    and the trial batch replicated (JAX montecarlo.py:638-686).

    Every rank draws chunk ``chunk_idx``'s whole batch at offset
    ``chunk_idx``, as the unsharded engine does, and the edge-sharded
    decode reaches the same fixed point, so the counters equal
    :func:`make_chunk_fn`'s bit for bit on every rank: a rank count
    changes the wall clock only.  A QC code decodes on ``expand()``."""
    if code is None:
        raise ValueError("edge_sharded requires a fixed code")
    if isinstance(code, _QC_CODES):
        code = code.expand()     # the counters are the same either way
    if code.n != cfg.n:
        raise ValueError(f"code n={code.n} != cfg.n={cfg.n}")
    code = code.to(device)
    decode = edge_sharded_bp_decode_irregular \
        if isinstance(code, IrregularLDPCCode) else edge_sharded_bp_decode
    words = cfg.batch // 32

    def fn(chunk_idx: int) -> ChunkStats:
        erased = bernoulli_packed(cfg.channel_param, (cfg.n, words),
                                  seed=cfg.seed, offset=chunk_idx,
                                  device=device)
        res = decode(code, erased, cfg.iterations, group)
        return _final_count_stats(res.error_totals, res.bit_errors, None)

    return fn


def _require_single_process(driver: str) -> None:
    """The host drivers run no collective: under a job of several
    processes each would repeat the whole num_tests and could stop at
    another point (JAX montecarlo.py:688-706)."""
    if world()[2] > 1:
        raise RuntimeError(
            f"the {driver} driver is single-process only: it has no "
            "reduced counters and no wall-clock broadcast; run it outside "
            "the torch.distributed job")


def _run_peeling(cfg: SimulationConfig, code, device) -> SimulationResult:
    """Monte Carlo with the peeling decoder (JAX ``_run_peeling``,
    montecarlo.py:848-916).

    On the BEC the peeling decoder and erasure BP stop at the identical
    fixed point, the maximal stopping set of the erasure pattern, so the
    statistics of peeling are those of the packed BP decode run to its
    fixed point: an n-round budget guarantees it, since every productive
    round resolves at least one variable.  The one-peel-at-a-time
    trajectory decoder is ``ops/peeling.py`` (the R-process experiments of
    ``utils/experiments.py``).  Chunk c draws K1 erasures from (cfg.seed,
    c), as :func:`make_chunk_fn` does, on the fixed code or, in ensemble
    mode, on one fresh code of (seed, c) (K5 or the irregular sampler, a
    batch of one), as JAX samples one code per chunk; so a fixed-code run
    counts exactly what the ``decoder="bp"`` run with ``iterations = n``
    counts at the same seed.  The stopping rules are the engine's."""
    if cfg.code_mode == "fixed":
        if code is None:
            raise ValueError("fixed code_mode requires a code")
        if code.n != cfg.n:
            raise ValueError(f"code n={code.n} != cfg.n={cfg.n}")
        code = code.to(device)
    elif cfg.irregular:
        spec = IrregularEnsembleSpec.from_lam_rho(cfg.n, cfg.lam, cfg.rho,
                                                  device=device)
    start = time.time()
    trials = chunk_idx = 0
    block_errors = bit_errors = 0
    bit_errors_sq = 0.0
    stopped_by = "num_tests"
    while trials < cfg.num_tests:
        if cfg.code_mode == "fixed":
            chunk_code = code
        elif cfg.irregular:
            chunk_code = sample_irregular_codes(
                cfg.seed, chunk_idx, 1, spec, cfg.sampler,
                device=device).select(0)
        else:
            chunk_code = sample_codes(cfg.seed, chunk_idx, 1, cfg.n, cfg.dv,
                                      cfg.dc, cfg.sampler,
                                      device=device).select(0)
        erased = bernoulli_packed(cfg.channel_param, (cfg.n, cfg.batch // 32),
                                  seed=cfg.seed, offset=chunk_idx,
                                  device=device)
        res = _allzero_decode(chunk_code, erased, cfg.n)
        stats = _final_count_stats(res.error_totals, res.bit_errors, None)
        block_errors += int(stats.block_errors)
        bit_errors += int(stats.bit_errors)
        bit_errors_sq += float(stats.bit_errors_sq)
        trials += cfg.batch
        chunk_idx += 1
        if block_errors >= cfg.max_block_errors:
            stopped_by = "block_errors"
            break
        if time.time() - start > cfg.max_seconds:
            stopped_by = "wall_clock"
            break
    return SimulationResult(
        config=cfg, num_trials=trials, error_rate_per_iteration=[],
        block_error_rate=block_errors / trials,
        bit_error_rate=bit_errors / (cfg.n * trials),
        block_errors=block_errors, bit_errors=bit_errors,
        bit_errors_sq=bit_errors_sq, elapsed_seconds=time.time() - start,
        timestamp=datetime.now().strftime("%d-%m-%Y-%H-%M-%S"),
        stopped_by=stopped_by)


def run_simulation(cfg: SimulationConfig, code=None, device="cuda",
                   group=None) -> SimulationResult:
    """Run the Monte Carlo to the reference's stopping rules and reduce.

    Each loop pass decodes one chunk of ``cfg.batch`` trials on
    ``device``, accumulates the counters on the host in int64, and checks
    the three stopping rules.  With ``cfg.checkpoint_path`` set, the
    counters are snapshotted every ``cfg.checkpoint_every_chunks`` chunks
    and at the end, and a run with the same (seed, batch) resumes from the
    snapshot.  Ensemble runs also accumulate the per-code cluster moment
    ``code_bit_errors_sq``, kept only when the whole run used one cluster
    size (``trials_per_code``), as in the JAX engine.  The peeling decoder
    runs through :func:`_run_peeling` (no checkpoints, as in JAX).

    Several devices (JAX's mesh, montecarlo.py:918-1085): ``group`` is a
    ``torch.distributed`` group with one rank per device (the whole job:
    ``distributed.global_group()``); without one, ``cfg.edge_sharded``
    takes the whole job when one is initialised and a batch-sharded run
    has one device.  ``cfg.edge_sharded`` splits the fixed code's
    checks over the ranks (:func:`make_edge_sharded_chunk_fn`, the batch
    replicated); otherwise each rank decodes ``batch / size`` trials
    (:func:`make_chunk_fn`) and the counters are summed over the group.
    Every rank then holds the same totals and stops on the same chunk:
    the wall clock is rank 0's, broadcast each chunk, a resume starts from
    rank 0's checkpoint, broadcast, and only rank 0 writes checkpoints.
    """
    if (cfg.channel, cfg.decoder) == ("BEC", "peeling"):
        _require_single_process("peeling")
        return _run_peeling(cfg, code, device)
    if group is not None or cfg.edge_sharded:
        group, rank, size = world(group)
    else:
        rank, size = 0, 1
    multi = size > 1
    if cfg.edge_sharded:        # the stats are replicated: nothing to sum
        chunk_fn = make_edge_sharded_chunk_fn(cfg, code, device, group)
    else:
        local_fn = make_chunk_fn(cfg, code, device, rank, size)
        chunk_fn = local_fn if not multi else (
            lambda chunk_idx: _reduce_stats(local_fn(chunk_idx), group))

    start = time.time()
    trials = 0
    chunk_idx = 0
    error_totals = np.zeros(cfg.iterations + 1, np.int64)
    block_errors = bit_errors = excluded = 0
    bit_errors_sq = code_bit_errors_sq = 0.0
    cluster_ok = True
    ensemble = cfg.code_mode == "ensemble"
    trials_per_code = 32 * _ensemble_layout(cfg, size)[1] if ensemble \
        else None
    stopped_by = "num_tests"

    def wall_clock_exceeded() -> bool:
        hit = time.time() - start > cfg.max_seconds
        if multi:      # rank 0's clock decides for every rank
            flag = torch.tensor([int(hit)], dtype=torch.int64, device=device)
            hit = bool(broadcast_(flag, group)[0])
        return hit

    if cfg.checkpoint_path and rank == 0 and \
            os.path.exists(cfg.checkpoint_path):
        with open(cfg.checkpoint_path) as f:
            ck = json.load(f)
        if ck["seed"] == cfg.seed and ck["batch"] == cfg.batch:
            trials = ck["trials"]
            chunk_idx = ck["chunk_idx"]
            error_totals = np.asarray(ck["error_totals"], np.int64)
            block_errors = ck["block_errors"]
            bit_errors = ck["bit_errors"]
            excluded = ck["excluded"]
            bit_errors_sq = ck.get("bit_errors_sq", 0.0)
            code_bit_errors_sq = ck.get("code_bit_errors_sq", 0.0)
            # the cluster moment means something only if the whole run
            # accumulated it at one cluster size
            if ensemble and ("code_bit_errors_sq" not in ck or
                             ck.get("trials_per_code") != trials_per_code):
                cluster_ok = False
    if cfg.checkpoint_path and multi:
        # rank 0's file is the one that counts (it may be on a disk of its
        # own); a rank starting at another chunk would strand the others
        # in the chunk's collective
        state = broadcast_(torch.tensor(
            [trials, chunk_idx, block_errors, bit_errors, excluded,
             int(cluster_ok), *error_totals.tolist()], dtype=torch.int64,
            device=device), group).tolist()
        moments = broadcast_(torch.tensor(
            [bit_errors_sq, code_bit_errors_sq], dtype=torch.float64,
            device=device), group).tolist()
        trials, chunk_idx, block_errors, bit_errors, excluded = state[:5]
        cluster_ok = bool(state[5])
        error_totals = np.asarray(state[6:], np.int64)
        bit_errors_sq, code_bit_errors_sq = moments

    def write_checkpoint():
        if rank != 0:
            return
        tmp = cfg.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(seed=cfg.seed, batch=cfg.batch, trials=trials,
                           chunk_idx=chunk_idx,
                           error_totals=error_totals.tolist(),
                           block_errors=block_errors,
                           bit_errors=bit_errors, excluded=excluded,
                           bit_errors_sq=bit_errors_sq,
                           code_bit_errors_sq=code_bit_errors_sq,
                           # null once the moment mixes cluster sizes, so
                           # a later resume drops it too
                           trials_per_code=(trials_per_code if cluster_ok
                                            else None)), f)
        os.replace(tmp, cfg.checkpoint_path)

    while trials < cfg.num_tests:
        stats = chunk_fn(chunk_idx)
        error_totals += stats.error_totals.cpu().numpy().astype(np.int64)
        block_errors += int(stats.block_errors)
        bit_errors += int(stats.bit_errors)
        excluded += int(stats.excluded)
        bit_errors_sq += float(stats.bit_errors_sq)
        if stats.code_bit_errors_sq is not None:
            code_bit_errors_sq += float(stats.code_bit_errors_sq)
        trials += cfg.batch
        chunk_idx += 1
        if cfg.checkpoint_path and \
                chunk_idx % cfg.checkpoint_every_chunks == 0:
            write_checkpoint()
        if block_errors >= cfg.max_block_errors:
            stopped_by = "block_errors"
            break
        if wall_clock_exceeded():
            stopped_by = "wall_clock"
            break
    if cfg.checkpoint_path:
        write_checkpoint()

    elapsed = time.time() - start
    denom = cfg.n * trials
    return SimulationResult(
        config=cfg,
        num_trials=trials,
        error_rate_per_iteration=(error_totals / denom).tolist(),
        block_error_rate=block_errors / trials,
        bit_error_rate=bit_errors / denom,
        block_errors=block_errors,
        bit_errors=bit_errors,
        error_counts_per_iteration=error_totals.tolist(),
        excluded_trials=excluded,
        bit_errors_sq=bit_errors_sq,
        code_bit_errors_sq=(code_bit_errors_sq if ensemble and cluster_ok
                            else None),
        trials_per_code=trials_per_code if cluster_ok else None,
        elapsed_seconds=elapsed,
        timestamp=datetime.now().strftime("%d-%m-%Y-%H-%M-%S"),
        stopped_by=stopped_by,
    )
