"""Experiment drivers: finite-length scaling of the peeling decoder, BP
decoding paths, waterfall curves.

The JAX package's drivers (``iib_project_ldpc_codes_tpu/utils/
experiments.py``; the reference's peeling experiment,
peeling_decoder.py:89-232, and its waterfall calculation,
finite_length_scaling_calculation.py:31-45) as library functions
returning structured results, with the same fields and bookkeeping.  The
port batches what JAX loops: :func:`peeling_scaling_experiment` samples
all its fresh codes in one sampler call (K5, or the irregular sampler),
draws all erasures in one K1 call and peels every repeat in one launch of
P1 (``ops/peeling.py``).  ``residual_degree_experiment`` waits for the
native histogram peel (ROADMAP queue 1 item 14b).

Randomness, all Philox from ``seed``: repeat r peels code r of sampler
chunk 0 (``models/ensemble.py``'s stream), its erasures are row r of a K1
plane of shape [repeats, ceil(n / 32)] at offset 0, bits along the
variables, and its choices are trial r of ``ops/peeling.py``'s stream; so
a repeat does not depend on how many repeats share the run.  JAX draws
from ``jax.random``: the two agree in distribution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..models.ensemble import sample_codes
from ..models.irregular import IrregularEnsembleSpec, sample_irregular_codes
from ..ops.bitops import bernoulli_packed, unpack_bits
from ..ops.channels import ERASURE
from ..ops.erasure_bp import bp_decode_packed_traj
from ..ops.peeling import peel_decode_batch
from . import theory


@dataclasses.dataclass
class PeelingScalingResult:
    """Output of the peeling R-process experiment at one (n, eps)."""

    n: int
    dv: int
    dc: int
    erasure_prob: float
    repeats: int
    # trajectories[i] = degree-1 check counts, reversed (steps-remaining
    # axis), NaN-padded to num_erasures+1 (peeling_decoder.py:143-149)
    trajectories: List[np.ndarray]
    sizes_at_failure: np.ndarray     # int[repeats]
    drift: np.ndarray                # analytic E[R] on the same axis
    critical_point: int              # step index of the critical point
    critical_distribution: np.ndarray  # R values at the critical point
    num_failures_at_critical: int
    expected_at_critical: float      # first-order drift prediction
    variance_at_critical: float      # scaling-law variance

    @property
    def failure_rate(self) -> float:
        return float((self.sizes_at_failure > 0).mean())


def peeling_scaling_experiment(n: int, dv: int, dc: int, erasure_prob: float,
                               repeats: int = 100, seed: int = 0, code=None,
                               backend: str = "device", lam=None, rho=None,
                               device="cuda", sampler: str = "repair"
                               ) -> PeelingScalingResult:
    """Monte Carlo R-process trajectories against the analytic drift.

    Mirrors peeling_decoder.py:136-168: a fresh code per repeat (or the
    fixed ``code``), all-zero transmit through the BEC, sequential random
    peeling, and the critical-point bookkeeping of :105-123, as JAX's
    function.  ``backend="device"`` (the default) peels on ``device``: P1
    on a CUDA device, its plain version on the CPU; ``"native"`` (JAX's
    host C) is not ported.  ``lam``/``rho`` switch to the irregular
    (lambda, rho) ensemble (``dv``/``dc`` ignored): the drift from
    :func:`..theory.irregular_peeling_drift`, the critical point from the
    interior minimum of the irregular drift, ``expected_at_critical`` the
    drift there and ``variance_at_critical`` NaN, as in JAX.
    """
    if backend == "native":
        raise NotImplementedError(
            "the native host peel (native/peeling.c) is not ported yet "
            "(ROADMAP queue 1 item 14b); use backend='device'")
    if backend != "device":
        raise ValueError(f"unknown backend {backend!r}")
    irregular = lam is not None
    if irregular:
        spec = IrregularEnsembleSpec.from_lam_rho(n, lam, rho, device=device)
        thr = theory.irregular_threshold(lam, rho, 1e-7)
        x_crit = theory.irregular_critical_x(lam, rho)
        # unresolved count at the critical time = n eps* L(x*) -- the
        # irregular generalisation of peeling_decoder.py:111's
        # int(n eps* y*^dv)
        critical_point = int(n * thr * theory._node_poly_val(lam, x_crit))
        steps = np.arange(int(n * erasure_prob))
        drift = theory.irregular_peeling_drift(
            erasure_prob, lam, rho, n, steps)[::-1]
        expected_at_critical = (float(drift[critical_point])
                                if critical_point < len(drift)
                                else float("nan"))
        variance = float("nan")
        dv, dc = spec.dv_max, spec.dc_max
    else:
        thr = theory.calc_threshold(dv, dc)
        y_crit = theory.threshold_y(thr, dv, dc)
        # critical step index (peeling_decoder.py:111: int(n eps* y*^dv))
        critical_point = int(n * thr * y_crit ** dv)
        # analytic drift on the steps-remaining axis
        # (peeling_decoder.py:106-107)
        steps = np.arange(int(n * erasure_prob))
        drift = theory.peeling_drift(erasure_prob, dv, dc, n, steps)[::-1]
        # first-order expected R at the critical point
        # (peeling_decoder.py:117-118)
        first_derivative = (
            -n * dv * (dc - 1) * thr * y_crit ** (2 * dv - 2)
            * (1 - erasure_prob * y_crit ** (dv - 1)) ** (dc - 2))
        expected_at_critical = first_derivative * (erasure_prob - thr)
        variance = theory.critical_point_variance(n, erasure_prob, dv, dc)

    if code is not None:
        codes = code.to(device)
    elif irregular:
        codes = sample_irregular_codes(seed, 0, repeats, spec, sampler,
                                       device=device)
    else:
        codes = sample_codes(seed, 0, repeats, n, dv, dc, sampler,
                             device=device)
    erased = unpack_bits(bernoulli_packed(
        erasure_prob, (repeats, (n + 31) // 32), seed=seed,
        device=device))[:, :n]
    res = peel_decode_batch(codes, torch.where(erased, ERASURE, 0),
                            seed=seed)
    evolutions = res.one_degree_evolution.cpu().numpy()
    erasure_counts = res.num_erasures.cpu().numpy()

    trajectories = []
    sizes_at_failure = []
    critical_distribution = []
    num_failures_at_critical = 0
    for evo, num_erasures in zip(evolutions, erasure_counts.tolist()):
        evo = evo[evo >= 0].astype(float)
        sizes_at_failure.append(num_erasures + 1 - len(evo))
        padded = np.concatenate(
            [evo, np.full(num_erasures + 1 - len(evo), np.nan)])
        traj = padded[::-1]
        trajectories.append(traj)
        # critical-point statistics (peeling_decoder.py:162-168)
        if critical_point < len(traj):
            r = traj[critical_point] - (
                drift[critical_point] if critical_point < len(drift) else 0.0)
            if math.isnan(r) or r < 0:
                num_failures_at_critical += 1
            else:
                critical_distribution.append(traj[critical_point])
        else:
            num_failures_at_critical += 1

    return PeelingScalingResult(
        n=n, dv=dv, dc=dc, erasure_prob=erasure_prob, repeats=repeats,
        trajectories=trajectories,
        sizes_at_failure=np.array(sizes_at_failure),
        drift=drift, critical_point=critical_point,
        critical_distribution=np.array(critical_distribution),
        num_failures_at_critical=num_failures_at_critical,
        expected_at_critical=float(expected_at_critical),
        variance_at_critical=float(variance))


@dataclasses.dataclass
class BPDecodingPaths:
    """Per-trial BP erasure-count trajectories at one (n, eps).

    The BP analogue of the reference's per-epsilon decoding-path export
    (test_peeling_decoder_path.py:56-62): simulated per-iteration decoding
    paths, here per *trial* (reference ``errors`` array semantics,
    parallel_simulator.py:147-166) with outcome-conditional means and the
    bit-erasure DE curve on the same axis.
    """

    n: int
    dv: int
    dc: int
    erasure_prob: float
    iterations: int
    num_trials: int
    trajectories: np.ndarray       # int32[trials, iterations+1]
    failed: np.ndarray             # bool[trials]
    mean_path: np.ndarray          # f64[iterations+1], fraction of n
    mean_path_failed: np.ndarray   # conditional on decode failure (or NaN)
    mean_path_success: np.ndarray  # conditional on success (or NaN)
    de_path: np.ndarray            # modified DE bit-erasure curve

    @property
    def failure_rate(self) -> float:
        return float(self.failed.mean())


def bp_decoding_paths(n: int, dv: int, dc: int, erasure_prob: float,
                      iterations: int, trials: int = 1024, seed: int = 0,
                      code=None, erased: Optional[torch.Tensor] = None,
                      device="cuda") -> BPDecodingPaths:
    """Per-trial BP decoding paths via the packed trajectory decode
    (``ops/erasure_bp.py::bp_decode_packed_traj``: K4 a round), all-zero
    transmit.  The code is ``code`` or code 0 of sampler chunk 0 of
    ``seed``; the erasures are ``erased`` int32[n, trials // 32] or a K1
    plane of ``seed`` (the engine's chunk 0)."""
    if trials % 32:
        raise ValueError("trials must be a multiple of 32")
    c = code.to(device) if code is not None else \
        sample_codes(seed, 0, 1, n, dv, dc, device=device).select(0)
    if erased is None:
        erased = bernoulli_packed(erasure_prob, (n, trials // 32), seed=seed,
                                  device=device)
    res, traj = bp_decode_packed_traj(c, erased.to(device),
                                      torch.zeros_like(erased, device=device),
                                      iterations)
    traj = traj.cpu().numpy().T                     # [trials, iters+1]
    failed = res.failed.cpu().numpy()

    def cond_mean(mask):
        if not mask.any():
            return np.full(iterations + 1, np.nan)
        return traj[mask].mean(axis=0) / n

    de = np.asarray(theory.modified_density_evolution(
        erasure_prob, iterations, dv, dc))
    de = np.concatenate([de, np.full(iterations + 1 - len(de), 0.0)])
    return BPDecodingPaths(
        n=n, dv=dv, dc=dc, erasure_prob=erasure_prob, iterations=iterations,
        num_trials=trials, trajectories=traj, failed=failed,
        mean_path=traj.mean(axis=0) / n,
        mean_path_failed=cond_mean(failed),
        mean_path_success=cond_mean(~failed),
        de_path=de)


def export_bp_decoding_paths(paths: BPDecodingPaths, directory: str) -> str:
    """Write one structured JSON per epsilon (decoding-path export; JAX's
    file name and fields, NaN written as null)."""
    import json
    import os

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory,
        f"bp_decoding_paths_eps={paths.erasure_prob}_n={paths.n}"
        f"_dv={paths.dv}_dc={paths.dc}.json")

    def clean(x):
        # NaN (e.g. mean_path_failed with zero failures) -> null: keep
        # the file strict RFC-8259 JSON
        if isinstance(x, list):
            return [clean(e) for e in x]
        if isinstance(x, float) and not math.isfinite(x):
            return None
        return x

    doc = dataclasses.asdict(paths)
    for k, v in doc.items():
        if isinstance(v, np.ndarray):
            doc[k] = clean(v.tolist())
    with open(path, "w") as f:
        json.dump(doc, f, allow_nan=False)
    return path


def export_peeling_paths(result: PeelingScalingResult, directory: str,
                         legacy_csv: bool = True) -> str:
    """Export a peeling R-process experiment's decoding paths: the
    reference-format analytic CSV ``peeling_decoder_paths_<eps>.csv`` with
    header ['x', 'fraction of edges'] (test_peeling_decoder_path.py:56-62:
    x = steps/(n eps), fraction = drift/(n dv)) and a structured JSON with
    the simulated trajectories beside the analytic curve (JAX's names and
    fields)."""
    import csv
    import json
    import os

    os.makedirs(directory, exist_ok=True)
    eps, n, dv = result.erasure_prob, result.n, result.dv
    steps = len(result.drift)
    xs = np.arange(steps) / max(steps - 1, 1)
    frac = result.drift / (n * dv)

    if legacy_csv:
        cpath = os.path.join(directory, f"peeling_decoder_paths_{eps}.csv")
        with open(cpath, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["x", "fraction of edges"])
            for x, v in zip(xs, frac):
                w.writerow([x, v])

    jpath = os.path.join(
        directory, f"peeling_decoder_paths_eps={eps}_n={n}.json")
    with open(jpath, "w") as f:
        json.dump({
            "n": n, "dv": dv, "dc": result.dc, "erasure_prob": eps,
            "repeats": result.repeats,
            "x": xs.tolist(),
            "analytic_fraction_of_edges": frac.tolist(),
            "drift": result.drift.tolist(),
            "critical_point": result.critical_point,
            "trajectories": [
                np.where(np.isnan(t), -1, t).astype(int).tolist()
                for t in result.trajectories],
            "sizes_at_failure": result.sizes_at_failure.tolist(),
        }, f)
    return jpath


@dataclasses.dataclass
class WaterfallResult:
    ns: List[int]
    erasure_probs: np.ndarray
    curves: List[np.ndarray]          # P_block per n (scaling law)
    threshold: float
    alpha: float


def waterfall_curves(ns, erasure_probs=None, dv: int = 3, dc: int = 6,
                     finite_size_shift: bool = False) -> WaterfallResult:
    """Scaling-law waterfall curves for a list of block lengths
    (finite_length_scaling_calculation.py:31-45)."""
    if erasure_probs is None:
        erasure_probs = np.linspace(0.32, 0.5, 100)
    erasure_probs = np.asarray(erasure_probs)
    thr = theory.calc_threshold(dv, dc)
    alpha = theory.calculate_alpha(thr, dv, dc)
    curves = [theory.waterfall_block_error(
        n, erasure_probs, dv, dc, finite_size_shift) for n in ns]
    return WaterfallResult(ns=list(ns), erasure_probs=erasure_probs,
                           curves=curves, threshold=thr, alpha=alpha)
