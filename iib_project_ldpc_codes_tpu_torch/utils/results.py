"""Structured results IO.

The JAX package's JSON result format (``iib_project_ldpc_codes_tpu/utils/
results.py``): the same ``SimulationResult`` fields, JSON document and
``key=value`` filename codec, so a file written by the port loads with the
JAX package's ``load_result`` and merges with its ``combine_results``.
The legacy reference CSV writer comes with a later slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime
from typing import List, Optional

from .config import SimulationConfig


@dataclasses.dataclass
class SimulationResult:
    config: SimulationConfig
    num_trials: int
    # Average bit erasure rate after each BP iteration (length iterations+1,
    # index 0 = channel erasure rate), averaged over *all* trials.
    error_rate_per_iteration: List[float]
    block_error_rate: float
    bit_error_rate: float
    optimal_block_error_rate: Optional[float] = None
    optimal_bit_error_rate: Optional[float] = None
    # Raw counts, so shards can be re-reduced without rounding.
    block_errors: int = 0
    bit_errors: int = 0
    optimal_block_errors: Optional[int] = None
    optimal_bit_errors: Optional[int] = None
    error_counts_per_iteration: Optional[List[int]] = None
    excluded_trials: int = 0  # expurgation-gated trials
    # Sum of squared per-trial final error counts (block-level second
    # moment) for the empirical-variance BER interval.
    bit_errors_sq: Optional[float] = None
    # Ensemble mode only: per-code cluster second moment and cluster size.
    code_bit_errors_sq: Optional[float] = None
    trials_per_code: Optional[int] = None
    elapsed_seconds: float = 0.0
    timestamp: str = ""
    stopped_by: str = ""  # "num_tests" | "block_errors" | "wall_clock"

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["config"] = dataclasses.asdict(self.config)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SimulationResult":
        d = json.loads(s)
        d["config"] = SimulationConfig(**d["config"])
        return cls(**d)


def encode_filename(result: SimulationResult, extension: str = ".json") -> str:
    """The reference's ``key=value`` filename (parallel_simulator.py:250-260)."""
    cfg = result.config
    irregular = cfg.lam is not None
    parts = ["irregular_code" if irregular else "regular_code"]
    if cfg.expurgation is not None:
        parts[0] += f"_expurgated={cfg.expurgation}"
    if cfg.code_mode == "fixed":
        parts.append(f"code_number={cfg.code_number}")
    parts.append(f"{cfg.channel}={cfg.channel_param}")
    parts.append(f"n={cfg.n}")
    parts.append(f"k={cfg.k}")
    if irregular:
        parts.append(f"dvmax={len(cfg.lam)}")
        parts.append(f"dcmax={len(cfg.rho)}")
    else:
        parts.append(f"dv={cfg.dv}")
        parts.append(f"dc={cfg.dc}")
    if result.config.decoder in ("bp", "both"):
        parts.append(f"it={cfg.iterations}")
    parts.append(f"num={result.num_trials}")
    parts.append(f"seed={cfg.seed}")
    stamp = result.timestamp or datetime.now().strftime("%d-%m-%Y-%H-%M-%S")
    parts.append(f"time={stamp}")
    return "_".join(parts) + extension


def decode_filename(filename: str) -> dict:
    """Parse ``key=value`` filename segments (tools/combine_data.py:15-27)."""
    base = os.path.basename(filename)
    for ext in (".json", ".csv"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    params = {}
    for seg in base.split("_"):
        if "=" in seg:
            k, v = seg.split("=", 1)
            params[k] = v
    return params


def save_result(result: SimulationResult, directory: Optional[str] = None
                ) -> str:
    if result.config.write_legacy_csv:
        raise NotImplementedError(
            "the legacy CSV writer is not ported yet (ROADMAP queue 1 "
            "item 14); write JSON and convert with the JAX package")
    directory = directory or result.config.output_dir
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, encode_filename(result))
    with open(path, "w") as f:
        f.write(result.to_json())
    return path


def load_result(path: str) -> SimulationResult:
    with open(path) as f:
        return SimulationResult.from_json(f.read())
