"""The one-axis device mesh of the port: a ``torch.distributed`` group.

The JAX package's ``parallel/mesh.py`` builds a ``jax.sharding.Mesh`` with
one axis over the devices of one or many processes, and places arrays on
it with ``NamedSharding`` / ``PartitionSpec``.  PyTorch runs one process
per device, so the mesh is the process group itself: rank r of D drives
one device and holds its own shard of whatever is sharded, chosen by
explicit slicing (:func:`shard_rows`), and the replicated state is simply
computed alike on every rank.  Nothing of ``NamedSharding`` carries over.

The port's collectives are a sum (``dist.all_reduce``), a stacking
gather and a broadcast from the group's rank 0 (below).  NCCL takes CUDA
tensors only and refuses two ranks on one card; gloo takes CPU tensors
and, for these three collectives, CUDA tensors too, which it copies
through host memory itself (checked on an H100 with torch 2.11, CUDA
12.8): so several ranks can share one card over gloo while the kernels
run on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def world(group=None) -> tuple[Optional[object], int, int]:
    """``(group, rank, size)`` of ``group`` (default: the whole job).

    Outside a ``torch.distributed`` job there is no group: ``(None, 0,
    1)``, the one-device mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        return None, 0, 1
    group = dist.group.WORLD if group is None else group
    return group, dist.get_rank(group), dist.get_world_size(group)


def shard_rows(rows: int, size: int) -> int:
    """Rows a rank holds when ``rows`` split evenly over ``size`` ranks
    (the JAX engine's rule, edge_sharded.py:91-93, 133-135)."""
    if rows % size:
        raise ValueError(f"mesh size {size} must divide the (padded) check "
                         f"row count {rows}")
    return rows // size


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """``[D, *t.shape]``: row d is rank d's ``t``.  The list form of
    ``all_gather`` writes into views of one contiguous tensor; it takes
    the same arguments on every backend and torch version the port
    runs."""
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group),) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t, group=group)
    return out


def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``t`` with the group's rank 0 copy, in place."""
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t
