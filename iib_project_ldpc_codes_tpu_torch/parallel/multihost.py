"""Multi-process Monte Carlo entry point: one ``torch.distributed`` job.

The reference scales over hosts as independent HPC array jobs whose CSV
shards are merged offline (tools/combine_data.py:32-95).  Here, as in the
JAX package's ``parallel/multihost.py``, every process runs this module
with the same experiment argv; the processes join one job, one per device,
the counters are summed over the whole job each chunk (or, with
``--edge-sharded``, the code's checks are split and the batch
replicated), every process holds the same totals -- so the stopping rules
fire in lockstep -- and only rank 0 writes the result.

Usage (the same command in every process, only --process-id varying):

    python -m iib_project_ldpc_codes_tpu_torch.parallel.multihost \\
        --coordinator=HOST:PORT --num-processes=N --process-id=I \\
        <erasure_prob> <num_tests> <iterations> <n> <dv> <dc> <mode> \\
        [seed|filenumber] [expurgation] \\
        [--device=cuda|cpu] [--devices=N] [--edge-sharded] \\
        [--output-dir=DIR] [--checkpoint-path=PATH] [--config=cfg.json]

or under ``torchrun``, which sets the job's variables, with none of the
three job flags.  ``--device=cuda`` (the default) drives
``cuda:LOCAL_RANK`` (``torchrun`` sets it; else ``cuda:<process id>``)
over NCCL; ``--device=cpu`` decodes on the CPU over gloo.

The experiment's flags and the run itself are the CLI's
(``cli.run_job``): an unknown flag raises, ``--devices=N`` must equal the
job's size, and the peeling decoder, a host driver with no collective,
refuses a job of several processes.  Every process prints one JSON line
with the reduced counters, so a launcher can read any process's output
(they all agree).
"""

from __future__ import annotations

import json
import sys

from ..cli import FLAGS, SWITCHES, parse_argv, run_job

JOB_FLAGS = ("coordinator", "num-processes", "process-id")


def main(argv=None) -> int:
    flags, positional = parse_argv(
        list(sys.argv[1:] if argv is None else argv),
        FLAGS + JOB_FLAGS + ("checkpoint-path",), SWITCHES)
    job = run_job(
        flags, positional, flags.get("coordinator"),
        int(flags["num-processes"]) if "num-processes" in flags else None,
        int(flags["process-id"]) if "process-id" in flags else None)
    if job is None:
        print(__doc__)
        return 2
    result = job.result
    print(json.dumps({
        "process_index": job.rank,
        "process_count": job.size,
        "distributed": job.joined,
        "mesh_devices": job.size,
        "is_primary": job.rank == 0,
        "num_trials": result.num_trials,
        "block_errors": result.block_errors,
        "bit_errors": result.bit_errors,
        "error_counts_per_iteration": result.error_counts_per_iteration,
        "stopped_by": result.stopped_by,
        "wrote": job.path,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
