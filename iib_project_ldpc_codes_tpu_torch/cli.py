"""Command-line entry point of the PyTorch/CUDA port.

Two invocation styles, as in the JAX package:

  1. Reference-compatible positional argv (parallel_simulator.py:403-445):

       python -m iib_project_ldpc_codes_tpu_torch.cli \\
           <erasure_prob> <num_tests> <iterations> <n> <dv> <dc> <mode> \\
           [seed|filenumber] [expurgation]

     The port runs mode 0 (a fresh code per group of trials, erasure BP;
     the 8th argument is the seed) and mode 3 (a fixed code, erasure BP;
     the 8th argument is the code number).  Modes 1, 2, 4 and 5 (ML)
     raise, naming their ROADMAP item.

  2. A JSON config (``SimulationConfig`` fields, the JAX package's JSON):
       python -m iib_project_ldpc_codes_tpu_torch.cli --config cfg.json

     Beyond the positional modes this runs BSC Gallager-A/B (``"channel":
     "BSC", "decoder": "gallager"``, ``gallager_threshold`` null for A),
     soft BP on the AWGN channel or the BSC (``"decoder": "sumproduct"``
     or ``"minsum"``, ``"channel_param"`` sigma or p, ``"minsum_alpha"``,
     ``"minsum_beta"``, ``"soft_msg_dtype"`` float32, bfloat16 or int8)
     and irregular ensembles (``"lam"``, ``"rho"``: edge-perspective
     degree fractions) with any of these decoders, in either code mode
     (``"code_mode": "ensemble"`` or ``"fixed"``), and the peeling decoder
     on the BEC (``"decoder": "peeling"``).

Optional flags (either style):
  --device=cuda|cpu      where to decode (default cuda; without a GPU the
                         run fails unless --device=cpu is given)
  --output-dir=DIR       where results are written
"""

from __future__ import annotations

import sys

import torch

from .models.ensemble import code_for_config
from .parallel.montecarlo import run_simulation
from .utils.config import SimulationConfig
from .utils.results import save_result

FLAGS = ("config", "output-dir", "device")


def resolve_device(flag) -> torch.device:
    """``cuda`` (the default) or ``cpu``; never switches on its own."""
    name = "cuda" if flag is None else flag
    if name not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device=cpu to run "
                           "the plain PyTorch path on the CPU")
    return torch.device(name)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {}
    positional = []
    args = iter(argv)
    for a in args:
        if not a.startswith("--"):
            positional.append(a)
            continue
        k, eq, v = a[2:].partition("=")
        if k not in FLAGS:
            raise ValueError(f"unknown flag --{k} (known: "
                             f"{', '.join('--' + f for f in FLAGS)})")
        if not eq:                      # "--flag value"
            v = next(args, None)
            if v is None:
                raise ValueError(f"--{k} needs a value")
        flags[k] = v

    if "config" in flags:
        with open(flags["config"]) as f:
            cfg = SimulationConfig.from_json(f.read())
    else:
        if len(positional) < 7:
            print(__doc__)
            return 2
        cfg = SimulationConfig.from_reference_argv(positional)
    if "output-dir" in flags:
        cfg.output_dir = flags["output-dir"]
    device = resolve_device(flags.get("device"))

    code = code_for_config(cfg) if cfg.code_mode == "fixed" else None
    result = run_simulation(cfg, code=code, device=device)
    path = save_result(result)
    print(f"wrote {path}")
    print(f"trials={result.num_trials} block_error_rate="
          f"{result.block_error_rate:.6g} bit_error_rate="
          f"{result.bit_error_rate:.6g} stopped_by={result.stopped_by}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
