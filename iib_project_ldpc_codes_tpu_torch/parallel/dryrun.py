"""Multi-device dry run: one chunk of every family over an N-rank group.

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``:

    python -m iib_project_ldpc_codes_tpu_torch.parallel.dryrun N \\
        [--device=cpu|cuda|cuda:K] [--backend=gloo|nccl]

spawns N processes on this machine that join one ``torch.distributed``
group (on a free local port), runs one batch-sharded chunk -- channel,
decode, counters summed over the group -- of each family the engine runs
(fixed, ensemble and irregular ensemble BEC, int8 min-sum on AWGN LLRs,
Gallager-A on the BSC, a QC code by circulant index, random-codeword
transmit) and one edge-sharded decode, at tiny shapes, and rank 0 prints
one ``ok`` line.  It runs on the card unless asked for the CPU: with no
``--device``, rank r drives ``cuda:r`` over NCCL when the machine has N
cards, else every rank shares ``cuda:0`` over gloo (NCCL refuses two
ranks on one card), and without CUDA it raises.  ``cuda`` and ``cuda:K``
ask for either layout; ``--device=cpu`` runs on the CPU over gloo.
"""

from __future__ import annotations

import socket
import sys

import torch


def free_port() -> int:
    """A TCP port that was free on localhost a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, size: int, port: int, device: str,
               backend) -> None:
    import torch.distributed as dist

    from ..models.ensemble import sample_code
    from ..models.qc import sample_qc_code
    from ..ops.bitops import bernoulli_packed
    from ..utils.config import SimulationConfig
    from . import distributed
    from .edge_sharded import edge_sharded_bp_decode
    from .montecarlo import run_simulation

    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", size, rank, device=device,
                           backend=backend, timeout_s=300)
    try:
        dev = distributed.local_device(device, rank)
        group = distributed.global_group()

        def gen(seed):
            return torch.Generator().manual_seed(seed)

        def one_chunk(cfg, code=None):
            cfg.num_tests, cfg.max_block_errors = cfg.batch, 10**9
            return run_simulation(cfg, code=code, device=dev, group=group)

        base = dict(channel="BEC", channel_param=0.42, n=48, dv=3, dc=6,
                    decoder="bp", iterations=10, batch=32 * size)
        code = sample_code(gen(0), 48, 3, 6)
        fixed = one_chunk(SimulationConfig(code_mode="fixed", **base), code)
        one_chunk(SimulationConfig(code_mode="ensemble",
                                   codes_per_chunk=size, **base))
        irr = {k: v for k, v in base.items() if k not in ("dv", "dc")}
        one_chunk(SimulationConfig(code_mode="ensemble", codes_per_chunk=size,
                                   lam=[0, 1 / 3, 0, 2 / 3],
                                   rho=[0, 0, 0, 0, 0, 1.0], **irr))
        one_chunk(SimulationConfig(
            code_mode="fixed", **dict(base, channel="AWGN", channel_param=0.8,
                                      decoder="minsum",
                                      soft_msg_dtype="int8")), code)
        one_chunk(SimulationConfig(
            code_mode="fixed", **dict(base, channel="BSC", channel_param=0.03,
                                      decoder="gallager")), code)
        qc = sample_qc_code(gen(8), nb=12, dv=3, dc=6, Z=8)
        one_chunk(SimulationConfig(code_mode="fixed", **dict(base, n=qc.n)),
                  qc)
        one_chunk(SimulationConfig(code_mode="fixed", transmit="random",
                                   **base), code)
        # length-axis sharding: the huge-n decoder with the checks split
        n_big = 48 * size
        big = sample_code(gen(3), n_big, 3, 6, device=dev)
        erased = bernoulli_packed(0.42, (n_big, 1), seed=4, device=dev)
        edge_sharded_bp_decode(big, erased, 20, group)
        if rank == 0:
            print(f"dryrun({size}) ok: batch-sharded BEC fixed/ensemble/"
                  "irregular + int8-minsum soft (AWGN) + Gallager-A (BSC) + "
                  "QC circulant-index + random-transmit chunks + "
                  "edge-sharded decode ran; "
                  f"block_errors={fixed.block_errors}", flush=True)
        dist.barrier(group)
    finally:
        dist.destroy_process_group()


def run(size: int, device=None, backend=None) -> None:
    """Spawn ``size`` ranks and run the dry run; raises if a rank fails.

    ``device`` None is the card: ``cuda`` (one card a rank, NCCL) when
    there are ``size`` cards, else ``cuda:0`` shared over gloo."""
    import torch.multiprocessing as mp

    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device=cpu "
                               "to run the dry run on the CPU")
    if device is None:
        device = "cuda" if torch.cuda.device_count() >= size else "cuda:0"
    if torch.device(device).type == "cuda" and backend is None and \
            torch.device(device).index is not None:
        backend = "gloo"            # several ranks on one card
    mp.spawn(_rank_main, args=(size, free_port(), device, backend),
             nprocs=size, join=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = dict(a[2:].partition("=")[::2] for a in argv
                 if a.startswith("--"))
    unknown = set(flags) - {"device", "backend"}
    if unknown:
        raise ValueError(f"unknown flag(s) {sorted(unknown)} (known: "
                         "--device, --backend)")
    positional = [a for a in argv if not a.startswith("--")]
    if len(positional) != 1:
        print(__doc__)
        return 2
    run(int(positional[0]), flags.get("device"), flags.get("backend"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
