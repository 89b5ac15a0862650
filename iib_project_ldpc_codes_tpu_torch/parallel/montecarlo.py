"""Batched Monte Carlo BER/FER engine, fixed-code BEC erasure BP.

The JAX package's engine (``iib_project_ldpc_codes_tpu/parallel/
montecarlo.py``) for its main path: each chunk decodes ``cfg.batch``
trials bit-packed on one device, and the host loop applies the reference's
stopping rules at chunk granularity (>= max_block_errors block errors /
num_tests / wall clock, parallel_simulator.py:198).

Seeding: chunk ``c`` draws its erasures with Philox key ``philox_key(seed)``
and offset ``c`` (``ops/bitops.py`` gives the full scheme), so any run is
reproducible from (seed, batch) alone, on the CPU and the GPU alike, and a
resumed run is bit-identical to an uninterrupted one.  This replaces the
JAX engine's ``fold_in(key(seed), c)``; the two engines draw different
erasures and agree in distribution.
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

from ..models.code import LDPCCode
from ..ops.bitops import pack_bits
from ..ops.channels import bec_packed_channel
from ..ops.erasure_bp import bp_decode_packed_allzero
from ..utils.config import SimulationConfig
from ..utils.results import SimulationResult


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """Counters of one chunk of trials, as device tensors.

    Counts are exact integers; ``bit_errors_sq`` -- the sum of squared
    per-trial final error counts, for the block-level BER variance -- is
    float64, exact below 2^53, where the JAX engine sums it in float32
    (montecarlo.py:129): the two agree to float32's ~1e-7 relative.
    """

    error_totals: torch.Tensor   # int32[iterations+1], counted trials
    block_errors: torch.Tensor   # int64 scalar
    bit_errors: torch.Tensor     # int64 scalar (final erasures, counted)
    excluded: torch.Tensor       # int64 scalar (expurgation-gated trials)
    bit_errors_sq: torch.Tensor  # float64 scalar


def _bp_chunk(code: LDPCCode, erased: torch.Tensor, *, iterations: int,
              expurgation: Optional[int]) -> ChunkStats:
    """Chunk statistics of the all-zero decode of ``erased`` int32[n, W].

    With ``expurgation = s``, trials with <= s final erasures are dropped
    from *all* statistics while still counted as trials
    (parallel_simulator_expurgated.py:238-243), by the JAX engine's
    two-pass form: decode, read the final per-trial counts, then re-decode
    with the excluded trials' erasures masked out, so they add zero to
    every per-iteration total.
    """
    res = bp_decode_packed_allzero(code, erased, iterations)
    final = res.bit_errors.to(torch.int64)                   # [B]
    if expurgation is None:
        return ChunkStats(
            error_totals=res.error_totals,
            block_errors=(final > 0).sum(),
            bit_errors=final.sum(),
            excluded=torch.zeros((), dtype=torch.int64, device=final.device),
            bit_errors_sq=(final.to(torch.float64) ** 2).sum())
    include = final > expurgation
    include_words = pack_bits(include[None, :])[0]           # int32[W]
    res2 = bp_decode_packed_allzero(code, erased & include_words[None, :],
                                    iterations)
    gated = final * include
    return ChunkStats(
        error_totals=res2.error_totals,
        block_errors=(include & (final > 0)).sum(),
        bit_errors=gated.sum(),
        excluded=(~include).sum(),
        bit_errors_sq=(gated.to(torch.float64) ** 2).sum())


def make_chunk_fn(cfg: SimulationConfig, code: Optional[LDPCCode],
                  device="cuda") -> Callable[[int], ChunkStats]:
    """``fn(chunk_idx) -> ChunkStats`` decoding ``cfg.batch`` trials.

    The port runs fixed-code BEC erasure BP with all-zero transmit (the
    reference's mode 3); every other combination raises, naming the
    ROADMAP item that ports it.
    """
    pair = (cfg.channel, cfg.decoder)
    if pair in (("BEC", "ml"), ("BEC", "both")):
        raise NotImplementedError(
            f"{pair} decodes with the host ML decoder, not ported yet "
            "(ROADMAP queue 1 item 14)")
    if pair == ("BEC", "peeling"):
        raise NotImplementedError(
            "the peeling decoder is not ported yet (ROADMAP queue 1 item 14)")
    if pair == ("BSC", "gallager"):
        raise NotImplementedError(
            "Gallager decoding is not ported yet (ROADMAP queue 1 item 9)")
    if pair != ("BEC", "bp"):
        raise NotImplementedError(
            f"soft BP {pair} is not ported yet (ROADMAP queue 1 item 10)")
    if cfg.irregular:
        raise NotImplementedError(
            "irregular codes are not ported yet (ROADMAP queue 1 item 8)")
    if cfg.code_mode != "fixed":
        raise NotImplementedError(
            "ensemble code mode is not ported yet (ROADMAP queue 1 item 7)")
    if cfg.transmit != "zero":
        raise NotImplementedError(
            "random-codeword transmit is not ported yet (ROADMAP queue 1 "
            "item 11)")
    if cfg.edge_sharded:
        raise NotImplementedError(
            "edge sharding is not ported yet (ROADMAP queue 1 item 13)")
    if code is None:
        raise ValueError("fixed code_mode requires a code")
    if not isinstance(code, LDPCCode):
        raise NotImplementedError(
            f"{type(code).__name__} codes are not ported yet (ROADMAP "
            "queue 1 item 12)")
    if (code.n, code.dv, code.dc) != (cfg.n, cfg.dv, cfg.dc):
        raise ValueError(f"code (n, dv, dc) = {(code.n, code.dv, code.dc)} "
                         f"!= config {(cfg.n, cfg.dv, cfg.dc)}")
    code = code.to(device)
    words = cfg.batch // 32

    def chunk(chunk_idx: int) -> ChunkStats:
        erased = bec_packed_channel(cfg.channel_param, (cfg.n, words),
                                    seed=cfg.seed, offset=chunk_idx,
                                    device=device)
        return _bp_chunk(code, erased, iterations=cfg.iterations,
                         expurgation=cfg.expurgation)

    return chunk


def run_simulation(cfg: SimulationConfig, code: Optional[LDPCCode] = None,
                   device="cuda") -> SimulationResult:
    """Run the Monte Carlo to the reference's stopping rules and reduce.

    Each loop pass decodes one chunk of ``cfg.batch`` trials on
    ``device``, accumulates the counters on the host in int64, and checks
    the three stopping rules.  With ``cfg.checkpoint_path`` set, the
    counters are snapshotted every ``cfg.checkpoint_every_chunks`` chunks
    and at the end, and a run with the same (seed, batch) resumes from the
    snapshot.
    """
    chunk_fn = make_chunk_fn(cfg, code, device)

    start = time.time()
    trials = 0
    chunk_idx = 0
    error_totals = np.zeros(cfg.iterations + 1, np.int64)
    block_errors = bit_errors = excluded = 0
    bit_errors_sq = 0.0
    stopped_by = "num_tests"

    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
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

    def write_checkpoint():
        tmp = cfg.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(seed=cfg.seed, batch=cfg.batch, trials=trials,
                           chunk_idx=chunk_idx,
                           error_totals=error_totals.tolist(),
                           block_errors=block_errors,
                           bit_errors=bit_errors, excluded=excluded,
                           bit_errors_sq=bit_errors_sq), f)
        os.replace(tmp, cfg.checkpoint_path)

    while trials < cfg.num_tests:
        stats = chunk_fn(chunk_idx)
        error_totals += stats.error_totals.cpu().numpy().astype(np.int64)
        block_errors += int(stats.block_errors)
        bit_errors += int(stats.bit_errors)
        excluded += int(stats.excluded)
        bit_errors_sq += float(stats.bit_errors_sq)
        trials += cfg.batch
        chunk_idx += 1
        if cfg.checkpoint_path and \
                chunk_idx % cfg.checkpoint_every_chunks == 0:
            write_checkpoint()
        if block_errors >= cfg.max_block_errors:
            stopped_by = "block_errors"
            break
        if time.time() - start > cfg.max_seconds:
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
        code_bit_errors_sq=None,
        trials_per_code=None,
        elapsed_seconds=elapsed,
        timestamp=datetime.now().strftime("%d-%m-%Y-%H-%M-%S"),
        stopped_by=stopped_by,
    )
