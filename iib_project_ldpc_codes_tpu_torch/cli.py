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
  --devices=N            the number of devices: must equal the world size
                         of the job this process runs in, 1 outside a job
                         or WORLD_SIZE under torchrun (one process per
                         device; the batch, or with --edge-sharded the
                         code's checks, is split over them)
  --edge-sharded         split the fixed code's checks over the devices
                         instead of the trial batch (huge-n fixed-code BEC
                         runs, n ~ 10^6; parallel/edge_sharded.py)
  --output-dir=DIR       where results are written

Several GPUs of one machine (one process each):
  torchrun --nproc-per-node=N -m iib_project_ldpc_codes_tpu_torch.cli \
      <argv> --devices=N
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch

from .models.ensemble import code_for_config
from .parallel import distributed
from .parallel.mesh import world
from .parallel.montecarlo import run_simulation
from .utils.config import SimulationConfig
from .utils.results import SimulationResult

FLAGS = ("config", "output-dir", "device", "devices")
SWITCHES = ("edge-sharded",)


def resolve_device(flag) -> torch.device:
    """``cuda`` (the default) or ``cpu``; never switches on its own."""
    name = "cuda" if flag is None else flag
    if name not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device=cpu to run "
                           "the plain PyTorch path on the CPU")
    return torch.device(name)


def parse_argv(argv, flags=FLAGS, switches=SWITCHES):
    """``(flags, positional)`` of ``argv``; a flag outside ``flags`` and
    ``switches`` raises, so a typo never drops an option silently."""
    parsed = {}
    positional = []
    args = iter(argv)
    for a in args:
        if not a.startswith("--"):
            positional.append(a)
            continue
        k, eq, v = a[2:].partition("=")
        if k in switches and not eq:
            parsed[k] = True
            continue
        if k not in flags:
            known = ", ".join("--" + f for f in tuple(flags) + tuple(switches))
            raise ValueError(f"unknown flag --{k} (known: {known})")
        if not eq:                      # "--flag value"
            v = next(args, None)
            if v is None:
                raise ValueError(f"--{k} needs a value")
        parsed[k] = v
    return parsed, positional


class Job(NamedTuple):
    """What :func:`run_job` ran: the reduced result, the path rank 0
    wrote (None elsewhere), this process's rank, the job's size and
    whether a ``torch.distributed`` job was joined."""
    result: SimulationResult
    path: Optional[str]
    rank: int
    size: int
    joined: bool


def run_job(flags, positional, coordinator_address=None,
            num_processes=None, process_id=None) -> Optional[Job]:
    """Run the experiment that ``flags``/``positional`` name, alone or as
    one process of a job, and write the result on rank 0.

    The job is the one the arguments name, else the one ``torchrun``'s
    variables name, else none (one device).  Returns None when the argv
    names no experiment."""
    if "config" in flags:
        with open(flags["config"]) as f:
            cfg = SimulationConfig.from_json(f.read())
    else:
        if len(positional) < 7:
            return None
        cfg = SimulationConfig.from_reference_argv(positional)
    if "output-dir" in flags:
        cfg.output_dir = flags["output-dir"]
    if "checkpoint-path" in flags:
        # per process: rank 0's file is the one that counts
        # (run_simulation broadcasts its state)
        cfg.checkpoint_path = flags["checkpoint-path"]
    if flags.get("edge-sharded"):
        cfg.edge_sharded = True
        cfg.__post_init__()          # re-validate the flag combination
    device = resolve_device(flags.get("device"))

    joined = distributed.initialize(coordinator_address, num_processes,
                                    process_id, device=device)
    try:
        group, rank, size = world()
        if "devices" in flags and int(flags["devices"]) != size:
            raise ValueError(
                f"--devices={flags['devices']} but this process runs in a "
                f"job of {size} device(s); start one process per device, "
                f"e.g. torchrun --nproc-per-node={flags['devices']}")
        if joined:
            device = distributed.local_device(device, rank)
        # a pure function of (code_number, n, dv, dc): every process
        # derives the same code with no broadcast
        code = code_for_config(cfg) if cfg.code_mode == "fixed" else None
        result = run_simulation(cfg, code=code, device=device, group=group)
        path = distributed.save_result_primary(result)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    return Job(result, path, rank, size, joined)


def main(argv=None) -> int:
    flags, positional = parse_argv(
        list(sys.argv[1:] if argv is None else argv))
    job = run_job(flags, positional)
    if job is None:
        print(__doc__)
        return 2
    if job.path is not None:
        result = job.result
        print(f"wrote {job.path}")
        print(f"trials={result.num_trials} block_error_rate="
              f"{result.block_error_rate:.6g} bit_error_rate="
              f"{result.bit_error_rate:.6g} stopped_by={result.stopped_by}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
