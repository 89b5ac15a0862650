"""Multi-process orchestration: one ``torch.distributed`` job.

The JAX package's ``parallel/distributed.py`` joins a ``jax.distributed``
job, so that its mesh spans every process's devices, the Monte Carlo
counters are summed by a collective, and only process 0 writes the result
(the collective replacement of the reference's offline CSV merge,
tools/combine_data.py).  Here the job is a ``torch.distributed`` process
group with one process per device: NCCL for CUDA, gloo for the CPU.

A single-process run needs none of this: :func:`initialize` returns False
when no job is configured, as JAX's does without
``JAX_COORDINATOR_ADDRESS``, and every entry point then runs alone.
Importing this module joins nothing.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import world


def local_device(device="cuda", process_id: Optional[int] = None
                 ) -> torch.device:
    """The device this process drives.

    A device with an index (``cuda:0``) is taken as given: several ranks
    may then share one card, over gloo.  Plain ``cuda`` means
    ``cuda:LOCAL_RANK`` (the variable ``torchrun`` sets), else
    ``cuda:<process_id>``, one process per card of a host; a CUDA device
    with neither is an error, never a silent choice.  ``cpu`` is the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if os.environ.get("LOCAL_RANK"):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if process_id is None:
        raise ValueError("no CUDA device index for this process: set "
                         "LOCAL_RANK or give a process id")
    return torch.device("cuda", process_id)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> bool:
    """Join (or skip) a ``torch.distributed`` job; True if one is active.

    The arguments default to the variables ``torchrun`` sets:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  Without a
    coordinator address nothing is joined and False is returned.  The
    backend is NCCL for a CUDA ``device`` and gloo for the CPU, unless
    ``backend`` names one (gloo for several ranks on one card: NCCL
    refuses them).  A CUDA process is bound to :func:`local_device`
    before it joins.
    """
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = env.get("WORLD_SIZE")
    if process_id is None:
        process_id = env.get("RANK")
    if num_processes is None or process_id is None:
        raise ValueError("a distributed job needs its number of processes "
                         "and this process's id (arguments, or WORLD_SIZE "
                         "and RANK)")
    process_id = int(process_id)
    dev = local_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=process_id, **kwargs)
    return True


def is_primary() -> bool:
    """Is this the process that writes results (rank 0, or no job)?"""
    return world()[1] == 0


def global_group():
    """The group of every process of the job; None outside a job."""
    return world()[0]


def save_result_primary(result, directory: Optional[str] = None
                        ) -> Optional[str]:
    """Write the (already reduced) result on rank 0 only; the path, or
    None on the other ranks."""
    from ..utils.results import save_result

    if not is_primary():
        return None
    return save_result(result, directory)
