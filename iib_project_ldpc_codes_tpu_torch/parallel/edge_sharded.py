"""Edge-sharded erasure BP for huge block lengths (n ~ 10^6).

The JAX package's ``parallel/edge_sharded.py``: the Tanner graph's checks
(and so its edges) are split evenly over the ranks of a process group
(:mod:`.mesh`), while the bit-packed variable state ``known`` int32[n, W]
is replicated.  A random-ensemble graph has no locality, so every rank
needs most of the variable state; the collective is a full OR all-reduce
of each rank's newly resolvable candidates, not a halo exchange.  One
round on each rank:

  1. the exactly-one-unknown summary of its checks ``off .. off+m_local``:
     K2 (``csrc/check_exactly_one.cu``) on the contiguous row slice of the
     check table, the same function as ``_check_summaries`` on a slice;
  2. the candidate plane: per variable, the OR of the summaries of those of
     its checks that lie in the shard (X1, ``csrc/edge_candidates.cu``);
  3. the candidates of all ranks, all-gathered into [D, n, W]
     (``torch.distributed``; none at D = 1);
  4. ``known |= OR_d gathered[d]`` and the erasures left (X2,
     ``csrc/or_reduce_update.cu``).

The count is taken on the replicated ``known``, so every rank reads the
same count and stops on the same round with no further collective.  The
stopping rule, the error array and its tail are
``ops/erasure_bp.py::_run_to_fixed_point``'s, so the result equals
:func:`..ops.erasure_bp.bp_decode_packed_allzero` bit for bit, whatever
the number of ranks: a rank count changes the wall clock only.  On a CUDA
tensor every pass is a kernel; on a CPU tensor the plain versions run.
"""

from __future__ import annotations

import torch

from ..kernels import alignment, check_int32, launch, use_kernel
from ..models.code import LDPCCode
from ..ops.bitops import per_trial_counts, popcount
from ..ops.erasure_bp import (PackedBPResult, _check_packed_batch_bits,
                              _pad_phantom_row, _run_to_fixed_point,
                              _strip_phantom, check_exactly_one,
                              check_exactly_one_vector)
from .mesh import all_gather_stack, shard_rows, world


# ---------------------------------------------------------------------------
# X1: the masked variable gather
# ---------------------------------------------------------------------------

def _edge_candidates_plain(var_to_chk: torch.Tensor,
                           exactly_one: torch.Tensor,
                           chk_offset: int) -> torch.Tensor:
    """Plain version of X1: JAX's masked gather (edge_sharded.py:71-79),
    index clipped into the shard and the row masked afterwards."""
    m_local = exactly_one.shape[0]
    cand = torch.zeros((var_to_chk.shape[0], exactly_one.shape[1]),
                       dtype=torch.int32, device=exactly_one.device)
    for p in range(var_to_chk.shape[1]):
        idx = var_to_chk[:, p] - chk_offset
        local = (idx >= 0) & (idx < m_local)
        plane = exactly_one.index_select(0, idx.clamp(0, m_local - 1))
        cand |= torch.where(local[:, None], plane, 0)
    return cand


def edge_candidates(var_to_chk: torch.Tensor, exactly_one: torch.Tensor,
                    chk_offset: int) -> torch.Tensor:
    """int32[n, W]: per variable and trial, the OR over its checks
    ``c = var_to_chk[v, p]`` with ``chk_offset <= c < chk_offset +
    m_local`` of ``exactly_one[c - chk_offset]`` (``exactly_one``
    int32[m_local, W], the shard's summary); checks outside the shard
    give 0.  The wrapper keeps its last launch's words a thread (K2's
    rule, :func:`..ops.erasure_bp.check_exactly_one_vector`) in
    ``.vec``."""
    check_int32("var_to_chk", var_to_chk, 2)
    check_int32("exactly_one", exactly_one, 2)
    if not use_kernel(var_to_chk, exactly_one):
        return _edge_candidates_plain(var_to_chk, exactly_one, chk_offset)
    (n, dv), (m_local, words) = var_to_chk.shape, exactly_one.shape
    cand = torch.empty((n, words), dtype=torch.int32,
                       device=exactly_one.device)
    vec = check_exactly_one_vector(words, alignment(exactly_one, cand))
    launch("ldpc_edge_candidates", cand.device, cand.data_ptr(),
           var_to_chk.data_ptr(), exactly_one.data_ptr(), n, dv, m_local,
           words, chk_offset, vec)
    edge_candidates.launches += 1
    edge_candidates.vec = vec
    return cand


edge_candidates.launches = 0
edge_candidates.vec = None


# ---------------------------------------------------------------------------
# X2: the OR reduction, the update and the count
# ---------------------------------------------------------------------------

def _or_reduce_update_plain(gathered: torch.Tensor, known: torch.Tensor,
                            errors: torch.Tensor, slot: int) -> None:
    """Plain version of X2 (edge_sharded.py:38-41, 158-160)."""
    acc = gathered[0].clone()
    for d in range(1, gathered.shape[0]):
        acc |= gathered[d]
    known |= acc
    errors[slot] = popcount(~known).sum(dtype=torch.int64).to(torch.int32)


def or_reduce_update(gathered: torch.Tensor, known: torch.Tensor,
                     errors: torch.Tensor, slot: int) -> None:
    """``known |= OR_d gathered[d]`` in place (``gathered`` int32[D, n,
    W], the ranks' candidate planes), and ``errors[slot]`` = erasures left
    in ``known`` (``errors[slot]`` must be 0 on entry)."""
    check_int32("gathered", gathered, 3)
    check_int32("known", known, 2)
    check_int32("errors", errors, 1)
    if gathered.shape[1:] != known.shape:
        raise ValueError(f"gathered {tuple(gathered.shape)} does not stack "
                         f"planes of known {tuple(known.shape)}")
    if not 0 <= slot < errors.shape[0]:
        raise ValueError(f"slot {slot} outside errors[{errors.shape[0]}]")
    if not use_kernel(gathered, known, errors):
        _or_reduce_update_plain(gathered, known, errors, slot)
        return
    launch("ldpc_or_reduce_update", known.device, known.data_ptr(),
           gathered.data_ptr(), errors[slot:].data_ptr(), gathered.shape[0],
           known.numel())
    or_reduce_update.launches += 1


or_reduce_update.launches = 0


# ---------------------------------------------------------------------------
# The round and the decode
# ---------------------------------------------------------------------------

def _local_round(chk_local: torch.Tensor, var_to_chk: torch.Tensor,
                 chk_offset: int, known: torch.Tensor) -> torch.Tensor:
    """Candidate plane int32[n, W] of one rank's check shard ``chk_local``
    (the rows ``chk_offset ..`` of the check table) on the replicated
    ``known`` (JAX ``_local_round``; the degrees are the tables' widths):
    K2 on the shard, then X1."""
    return edge_candidates(var_to_chk, check_exactly_one(chk_local, known),
                           chk_offset)


def _or_all_reduce_update(cand: torch.Tensor, known: torch.Tensor,
                          errors: torch.Tensor, slot: int, group) -> None:
    """JAX's ``_or_all_reduce`` and the round's update: all-gather the
    ranks' candidates (a collective; one rank gathers nothing), then X2.
    The collective sums cannot OR packed planes: a sum carries."""
    gathered = cand[None] if group is None else all_gather_stack(cand, group)
    or_reduce_update(gathered, known, errors, slot)


def edge_sharded_bp_decode(code: LDPCCode, erased: torch.Tensor,
                           max_iters: int, group=None) -> PackedBPResult:
    """All-zero-codeword erasure BP with the checks split over ``group``'s
    ranks (default: the whole job, or this process alone outside one).

    Every rank passes the same ``erased`` int32[n, W] and gets the same
    result, equal bit for bit to
    :func:`..ops.erasure_bp.bp_decode_packed_allzero`."""
    _, _, size = world(group)
    if code.m % size:
        raise ValueError(f"mesh size {size} must divide the check count "
                         f"m={code.m}")
    return _edge_sharded_core(code.chk_to_var, code.var_to_chk, erased,
                              max_iters, group)


def edge_sharded_bp_decode_irregular(code, erased: torch.Tensor,
                                     max_iters: int, group=None
                                     ) -> PackedBPResult:
    """:func:`edge_sharded_bp_decode` for an
    :class:`..models.irregular.IrregularLDPCCode`.

    The state gains the phantom variable's row (never erased) and the
    phantom-padded check table (phantom row m included) gains all-phantom
    rows until the rank count divides it: their summary is zero on
    whichever rank owns them.  Equal bit for bit to
    :func:`..ops.erasure_bp.bp_decode_packed_allzero_irregular`."""
    _, _, size = world(group)
    chk = code.chk_to_var
    extra = (-(code.m + 1)) % size
    if extra:
        chk = torch.cat([chk, chk.new_full((extra, code.dc_max), code.n)])
    return _strip_phantom(_edge_sharded_core(
        chk, code.var_to_chk, _pad_phantom_row(erased), max_iters, group))


def _edge_sharded_core(chk_rows: torch.Tensor, var_to_chk: torch.Tensor,
                       erased: torch.Tensor, max_iters: int,
                       group) -> PackedBPResult:
    """The degree-agnostic sharded fixed-point loop over explicit tables
    (one code: int32[m_rows, dc] and int32[n, dv])."""
    group, rank, size = world(group)
    check_int32("chk_rows", chk_rows, 2)
    check_int32("var_to_chk", var_to_chk, 2)
    check_int32("erased", erased, 2)
    m_local = shard_rows(chk_rows.shape[0], size)
    n, words = erased.shape
    if var_to_chk.shape[0] != n:
        raise ValueError(f"erased has {n} rows, the code "
                         f"{var_to_chk.shape[0]}")
    _check_packed_batch_bits(n, words)
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    chk_offset = rank * m_local
    chk_local = chk_rows[chk_offset:chk_offset + m_local]
    known = ~erased
    total0 = int(per_trial_counts(erased).sum(dtype=torch.int64))
    errors = torch.zeros(max_iters + 1, dtype=torch.int32,
                         device=erased.device)

    def step(it: int) -> int:
        cand = _local_round(chk_local, var_to_chk, chk_offset, known)
        _or_all_reduce_update(cand, known, errors, it + 1,
                              group if size > 1 else None)
        return int(errors[it + 1])

    totals, it = _run_to_fixed_point(step, total0, max_iters)
    return PackedBPResult(
        known=known,
        error_totals=torch.tensor(totals, dtype=torch.int32,
                                  device=erased.device),
        iterations=it)
