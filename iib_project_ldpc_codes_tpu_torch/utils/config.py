"""Typed experiment configuration.

The JAX package's ``SimulationConfig`` (``iib_project_ldpc_codes_tpu/
utils/config.py``) with the same fields, defaults, validation and JSON, so
a configuration or result moves between the two packages unchanged.  It is
carried here, not imported: importing anything from the JAX package
imports ``jax``.

The reference's positional argv (parallel_simulator.py:403-445:
``erasure_prob num_tests iterations n dv dc mode [seed|filenumber]
[expurgation]``) maps its six modes onto (decoder x code_mode):

  mode 0 -> decoder="bp",   code_mode="ensemble"
  mode 1 -> decoder="ml",   code_mode="ensemble"
  mode 2 -> decoder="both", code_mode="ensemble"
  mode 3 -> decoder="bp",   code_mode="fixed"
  mode 4 -> decoder="ml",   code_mode="fixed"
  mode 5 -> decoder="both", code_mode="fixed"

The port runs modes 0 and 3 so far, and through a JSON config BSC
Gallager-A/B, soft BP on the AWGN channel and the BSC, and irregular (lam,
rho) codes with each of these decoders; the Monte Carlo engine names the
ROADMAP item of every other combination.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional


@dataclasses.dataclass
class SimulationConfig:
    # Channel
    channel: str = "BEC"          # "BEC" | "BSC" | "AWGN"
    channel_param: float = 0.4    # erasure prob / crossover prob / sigma

    # Code
    n: int = 1024
    dv: int = 3
    dc: int = 6
    code_mode: str = "ensemble"   # "ensemble" (fresh code/trial) | "fixed"
    code_number: int = 1          # fixed-code id (concentration runs)
    sampler: str = "repair"       # "repair" | "reject"
    # Irregular (lambda, rho) ensemble: edge-perspective degree
    # distributions (utils.theory coefficient convention: lam[i] is the
    # edge fraction on degree-(i+1) variables).  When set, dv/dc are
    # ignored and codes come from models.irregular.  Supported decoder
    # pairs: BEC bp/peeling/ml/both and the BSC/AWGN soft decoders
    # (sumproduct/minsum) -- see __post_init__.
    lam: Optional[List[float]] = None
    rho: Optional[List[float]] = None

    # Decoder
    decoder: str = "bp"           # "bp" | "ml" | "both" | "peeling"
    iterations: int = 50          # BP budget (reference envelope 50-200)
    gallager_threshold: Optional[int] = None  # None -> Gallager-A (dv-1)
    minsum_alpha: float = 1.0     # normalised min-sum scale
    minsum_beta: float = 0.0      # offset min-sum correction
    soft_msg_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"
                                     # message planes (int8: quantised
                                     # min-sum, see ops/soft_bp.py)

    # Transmit convention.  "zero": every trial sends the all-zero
    # codeword (the reference's only workload, simulator.py:253).
    # "random": encode fresh random information bits per trial through
    # the systematic encoder (models/encode.py -- the reference's
    # vestigial encode, simulator.py:61-64, made load-bearing), transmit
    # them, and count errors against the true codeword.  Measures the
    # all-zero/channel-symmetry equivalence instead of assuming it.
    # Supported for BEC+bp, BSC Gallager, and the soft decoders, in
    # fixed-code AND ensemble mode (ensemble: per-chunk host-side
    # encoder derivation, single-device only).  Validation-scale
    # feature: the encoder map is a dense O(n^2) host array
    # (models.encode.encoder_planes guards at ~n = 3e4).
    transmit: str = "zero"

    # Stopping rules (parallel_simulator.py:198)
    num_tests: int = 100_000
    max_block_errors: int = 200
    max_seconds: float = 43_000.0

    # Monte Carlo execution
    seed: int = 0
    # Trials per chunk (multiple of 32).  The ml/both host loop caps
    # its chunks at 512 trials regardless (ML is O(n^3) host work; it
    # warns when the cap engages) -- larger values only affect the
    # device decoders.
    batch: int = 1024
    # Shard the Tanner graph (check set) across the mesh instead of the
    # trial batch -- Monte Carlo statistics at huge block lengths
    # (n ~ 10^6, parallel/edge_sharded.py).  Fixed-code BEC+bp only; the
    # batch is replicated and each chunk's counters are bit-identical to
    # the unsharded engine's.
    edge_sharded: bool = False
    codes_per_chunk: int = 32     # fresh codes per chunk in ensemble mode
    # Exclude trials with <= s final errors from the statistics while
    # still counting them as trials (parallel_simulator_expurgated.py
    # :238).  Supported by every batched decoder family and EXACT for
    # all of them, including the per-iteration series: BEC bp via a
    # two-pass masked re-decode, Gallager and the soft decoders via
    # per-trial trajectory recording (record="per_trial") with the
    # excluded trials' whole series dropped -- the reference's
    # expurgated accumulation verbatim.  The traj recording costs ~32x
    # the (cheap) counting work of a plain chunk; only expurgated runs
    # pay it.
    expurgation: Optional[int] = None

    # IO
    output_dir: str = "results"
    write_legacy_csv: bool = False
    # Periodic counter snapshots for resumable long sweeps (SURVEY.md
    # section 5: the reference never checkpoints Monte Carlo state; its
    # "resume" is running more shards).  None disables.
    checkpoint_path: Optional[str] = None
    checkpoint_every_chunks: int = 10

    @property
    def irregular(self) -> bool:
        return self.lam is not None

    @property
    def k(self) -> int:
        if self.irregular:
            from ..models.irregular import degree_sequences_from_lam_rho

            _, chk_degrees = degree_sequences_from_lam_rho(
                self.n, self.lam, self.rho)
            return self.n - int(chk_degrees.size)
        return self.n * (self.dc - self.dv) // self.dc

    def __post_init__(self):
        if self.batch % 32:
            raise ValueError("batch must be a multiple of 32 (bit packing)")
        if self.channel not in ("BEC", "BSC", "AWGN"):
            raise ValueError(f"unknown channel {self.channel!r}")
        valid_decoders = ("bp", "ml", "both", "peeling",   # BEC family
                          "gallager",                      # BSC hard-decision
                          "sumproduct", "minsum")          # soft LLR family
        if self.decoder not in valid_decoders:
            raise ValueError(f"unknown decoder {self.decoder!r}")
        by_channel = {"BEC": ("bp", "ml", "both", "peeling"),
                      "BSC": ("gallager", "sumproduct", "minsum"),
                      "AWGN": ("sumproduct", "minsum")}
        if self.decoder not in by_channel[self.channel]:
            raise ValueError(
                f"decoder {self.decoder!r} not available on {self.channel}")
        if self.soft_msg_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"unknown soft_msg_dtype {self.soft_msg_dtype!r}")
        if self.soft_msg_dtype == "int8" and self.decoder == "sumproduct":
            raise ValueError("int8 messages require the minsum decoder")
        if self.soft_msg_dtype == "int8" and (self.minsum_alpha != 1.0
                                              or self.minsum_beta != 0.0):
            # fail at config time, not inside the jitted kernel
            # (ops/soft_bp.py rejects the same combination at trace time)
            raise ValueError("int8 min-sum: saturation replaces alpha/beta "
                             "corrections")
        if self.code_mode not in ("ensemble", "fixed"):
            raise ValueError(f"unknown code_mode {self.code_mode!r}")
        if self.transmit not in ("zero", "random"):
            raise ValueError(f"unknown transmit {self.transmit!r}")
        if self.transmit == "random":
            ok = {("BEC", "bp"), ("BSC", "gallager"),
                  ("BSC", "sumproduct"), ("BSC", "minsum"),
                  ("AWGN", "sumproduct"), ("AWGN", "minsum")}
            if (self.channel, self.decoder) not in ok:
                raise ValueError(
                    "transmit='random' supports BEC+bp, Gallager, and "
                    f"the soft decoders; got {(self.channel, self.decoder)}")
            if self.edge_sharded:
                raise ValueError("transmit='random' not supported with "
                                 "edge_sharded")
            if self.expurgation is not None:
                raise ValueError("transmit='random' not supported with "
                                 "expurgation")
        if self.edge_sharded:
            if (self.channel, self.decoder) != ("BEC", "bp"):
                raise ValueError("edge_sharded requires BEC + bp")
            if self.code_mode != "fixed":
                raise ValueError("edge_sharded requires a fixed code "
                                 "(the graph shard is per-code)")
            if self.expurgation is not None:
                raise ValueError("edge_sharded does not support "
                                 "expurgation")
        if (self.lam is None) != (self.rho is None):
            raise ValueError("lam and rho must be given together")
        if self.lam is not None:
            irregular_ok = {("BEC", "bp"), ("BEC", "peeling"),
                            ("BEC", "ml"), ("BEC", "both"),
                            ("BSC", "gallager"),
                            ("BSC", "sumproduct"), ("BSC", "minsum"),
                            ("AWGN", "sumproduct"), ("AWGN", "minsum")}
            if (self.channel, self.decoder) not in irregular_ok:
                raise ValueError(
                    "irregular (lam, rho) ensembles support the BEC "
                    "decoders (bp/peeling/ml/both), Gallager-A/B, and "
                    "the soft decoders (sumproduct/minsum); got "
                    f"{(self.channel, self.decoder)}")
        elif (self.n * self.dv) % self.dc:
            raise ValueError("n*dv must be divisible by dc")
        if self.code_mode == "ensemble":
            # clamp so every chunk divides evenly into >= 32-trial groups
            self.codes_per_chunk = max(min(self.codes_per_chunk,
                                           self.batch // 32), 1)
            while self.batch % (32 * self.codes_per_chunk):
                self.codes_per_chunk -= 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SimulationConfig":
        return cls(**json.loads(s))

    @classmethod
    def from_reference_argv(cls, argv) -> "SimulationConfig":
        """Parse the reference's positional CLI (parallel_simulator.py:405-443)."""
        eps, num_tests, iterations, n, dv, dc, mode = (
            float(argv[0]), int(argv[1]), int(argv[2]), int(argv[3]),
            int(argv[4]), int(argv[5]), int(argv[6]))
        decoder = {0: "bp", 1: "ml", 2: "both",
                   3: "bp", 4: "ml", 5: "both"}[mode]
        code_mode = "ensemble" if mode < 3 else "fixed"
        cfg = cls(channel="BEC", channel_param=eps, n=n, dv=dv, dc=dc,
                  decoder=decoder, iterations=iterations,
                  num_tests=num_tests, code_mode=code_mode)
        if len(argv) > 7:
            if code_mode == "ensemble":
                cfg.seed = int(argv[7])
            else:
                cfg.code_number = int(argv[7])
        if len(argv) > 8:
            cfg.expurgation = int(argv[8])
        return cfg
