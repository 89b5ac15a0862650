"""Gallager-A/B (BSC hard-decision) for quasi-cyclic codes by circulant
index.

The JAX package's decoder (``iib_project_ldpc_codes_tpu/ops/
qc_gallager.py``) turns the generic decoder's per-socket gathers into
rolls of packed [Z, W] planes; here the shift folds into the kernels' load
and store addresses.  Messages are check-resident as in JAX, int32[E_b *
Z, W]: one [Z, W] plane per REAL base socket, check-major, row z of a
plane belonging to lifted check (c, z), so an irregular base has no padded
rows.  One flooding round is two hand-written kernels:

  * Q3 :func:`qc_gallager_check` (``csrc/qc_gallager_check.cu``): the XOR
    of each base check's planes; a socket's extrinsic message is
    ``parity ^ msg`` (JAX: prefix/suffix XOR);
  * Q4 :func:`qc_gallager_variable` (``csrc/qc_gallager_variable.cu``):
    per socket of variable (b, z), flip the channel bit iff at least t of
    the other incoming messages disagree with it, decide by majority
    (degree // 2 + 1), write the new messages in place at check row
    (z - s) mod Z, and count the decision errors and the changed message
    words.  With ``init=True`` the same source writes the first messages,
    the channel word at every socket, by the same index computation.  Its
    launch (:func:`qc_variable_layout`): 16 or 4 bytes of a row a thread,
    4 / 1 rows a thread, and per variable block an exact-degree pass
    (:data:`QC_EXACT_DEGREES`) or the generic one; the wrapper keeps the
    last launch's in ``.vec`` and ``.paths``.

The flip rule goes by the code's TYPE, as in JAX: the raw threshold for a
:class:`..models.qc.QCLDPCCode`, the per-degree clamp t_d = min(t, max(d-1,
1)) for an :class:`..models.qc.IrregularQCLDPCCode` even when its base is
degree-uniform.  A degree-1 block never flips at any t >= 1.  The loop is
the generic decoder's (``ops/gallager.py::_gallager_loop``: stop rules,
``record``, ``tx_bits`` accounting), so a decode equals the generic one on
``code.expand()`` bit for bit, the stop round included: the message set is
the same, laid out differently.  No per-round ``schedule``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from ..kernels import alignment, check_int32, launch, use_kernel
from ..models.qc import IrregularQCLDPCCode
from .bitops import _per_trial_counts_plain, per_trial_counts, popcount
from .gallager import (MAX_DEGREE, GallagerResult, _bitsliced_count_ge,
                       _gallager_loop)
from .qc_bp import QCAdjacency, _adjacency, _check_planes


# ---------------------------------------------------------------------------
# Q3: the check pass
# ---------------------------------------------------------------------------

def _qc_gallager_check_plain(adj: QCAdjacency, msg: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of Q3."""
    planes = msg.reshape(adj.num_rows, adj.Z, -1)
    parity, row = [], 0
    for sockets in adj.chk_side:
        acc = planes[row].clone()
        for r in range(row + 1, row + len(sockets)):
            acc ^= planes[r]
        parity.append(acc)
        row += len(sockets)
    return torch.cat(parity)


def qc_gallager_check(adj: QCAdjacency, msg: torch.Tensor) -> torch.Tensor:
    """int32[m, W]: row c*Z + z holds the XOR of the message words of
    lifted check (c, z) over base check c's real sockets (``msg``
    int32[E_b * Z, W], check-resident)."""
    words = _check_planes(adj, adj.num_rows * adj.Z, msg=msg)
    if not use_kernel(adj.base_chk, msg):
        return _qc_gallager_check_plain(adj, msg)
    parity = torch.empty((adj.m, words), dtype=torch.int32,
                         device=msg.device)
    launch("ldpc_qc_gallager_check", msg.device, msg.data_ptr(),
           adj.row_offs.data_ptr(), parity.data_ptr(), adj.mb, adj.Z, words)
    qc_gallager_check.launches += 1
    return parity


qc_gallager_check.launches = 0


# ---------------------------------------------------------------------------
# Q4: the variable pass, and the first messages
# ---------------------------------------------------------------------------

#: the variable-block degrees Q4 has exact passes for; a block of any other
#: degree (up to MAX_DEGREE) runs its generic pass, in the same launch
QC_EXACT_DEGREES = (3, 4)
#: words of each socket's rows a thread of Q4 keeps in flight
#: (``kWordsInFlight`` of ``csrc/qc_gallager_variable.cu``)
QC_WORDS_IN_FLIGHT = 4


def qc_variable_layout(degrees: Iterable[int], words: int, align: int
                       ) -> Tuple[int, int, Tuple[str, ...]]:
    """Q4's launch, ``(vec, rows, paths)``: ``vec`` the words of a row a
    thread moves, 4 (16 bytes) when ``words`` is a multiple of 4 and
    ``align`` (the largest power of two up to 16 dividing every plane's
    address) is 16, else 1; ``rows`` the rows a thread takes,
    ``QC_WORDS_IN_FLIGHT // vec``; ``paths`` the passes that variable
    blocks of these ``degrees`` take, sorted: ``"dv3"``, ``"dv4"`` (the
    exact degrees) and ``"generic"``."""
    vec = 4 if words % 4 == 0 and align % 16 == 0 else 1
    paths = {f"dv{d}" if d in QC_EXACT_DEGREES else "generic"
             for d in degrees}
    return vec, QC_WORDS_IN_FLIGHT // vec, tuple(sorted(paths))


def _qc_gallager_variable_plain(adj: QCAdjacency, msg, parity, channel,
                                decided, counts, *, threshold: int = 0,
                                clamp: bool = False, tx=None,
                                init: bool = False) -> None:
    """Plain version of Q4, in JAX's form (qc_gallager.py:68-96): check
    planes rolled by +s into the variable frame, bit-sliced disagreement
    counts with a static threshold per block, new planes rolled back by
    -s."""
    Z = adj.Z
    planes = msg.view(adj.num_rows, Z, -1)
    changed = torch.zeros((), dtype=torch.int64, device=msg.device)
    for b, sockets in enumerate(adj.var_side):
        block = slice(b * Z, (b + 1) * Z)
        ch = channel[block]
        if init:
            for row, _c, s in sockets:
                planes[row] = torch.roll(ch, -s, 0)
            continue
        d = len(sockets)
        disagree = [torch.roll(parity[c * Z:(c + 1) * Z] ^ planes[row], s, 0)
                    ^ ch for row, c, s in sockets]
        t = min(threshold, max(d - 1, 1)) if clamp else threshold
        for p, (row, _c, s) in enumerate(sockets):
            others = [disagree[l] for l in range(d) if l != p]
            # a degree-1 block has no other socket: zero disagreements
            flip = _bitsliced_count_ge(others, t) if others else \
                torch.full_like(ch, -1 if t <= 0 else 0)
            new = torch.roll(ch ^ flip, -s, 0)
            changed += (new != planes[row]).sum()
            planes[row] = new
        decided[block] = ch ^ _bitsliced_count_ge(disagree, d // 2 + 1) \
            if disagree else ch
    if init:
        return
    errors = popcount(decided if tx is None else decided ^ tx) \
        .sum(dtype=torch.int64)
    counts[0] += torch.stack([errors, changed]).to(torch.int32)


def qc_gallager_variable(adj: QCAdjacency, msg: torch.Tensor,
                         parity: Optional[torch.Tensor],
                         channel: torch.Tensor,
                         decided: Optional[torch.Tensor],
                         counts: Optional[torch.Tensor], *,
                         threshold: int = 0, clamp: bool = False,
                         tx: Optional[torch.Tensor] = None,
                         init: bool = False) -> None:
    """One variable pass, in place: new messages into ``msg`` int32[E_b *
    Z, W], the decision into ``decided`` int32[n, W], and ``counts[0] +=``
    (decision errors, changed message words), ``counts`` int32[1, 2].
    ``parity`` is :func:`qc_gallager_check` of ``msg``; ``channel`` the
    received planes int32[n, W]; ``clamp`` selects the irregular
    per-degree threshold.  The errors are the decision's set bits, or its
    bits that differ from the transmitted codeword ``tx`` int32[n, W].

    ``init=True`` writes the first messages instead, the channel word at
    every socket of ``msg``; ``parity``, ``decided``, ``counts`` and
    ``tx`` are then not read (pass None).
    """
    words = _check_planes(adj, adj.n, channel=channel)
    tensors = [msg, channel]
    _check_planes(adj, adj.num_rows * adj.Z, msg=msg)
    if not init:
        _check_planes(adj, adj.m, parity=parity)
        _check_planes(adj, adj.n, decided=decided,
                      **({} if tx is None else dict(tx=tx)))
        check_int32("counts", counts, 2)
        if counts.shape != (1, 2):
            raise ValueError("counts must be int32[1, 2]")
        tensors += [parity, decided, counts] + ([] if tx is None else [tx])
    if any(t.shape[1] != words for t in tensors if t is not counts):
        raise ValueError("msg, parity, channel, decided and tx differ in "
                         "words")
    if not use_kernel(adj.base_chk, *tensors):
        _qc_gallager_variable_plain(adj, msg, parity, channel, decided,
                                    counts, threshold=threshold, clamp=clamp,
                                    tx=tx, init=init)
        return
    dvb = adj.var_chk.shape[1]
    if dvb > MAX_DEGREE:
        raise ValueError(f"base variable degree {dvb} above the kernel's "
                         f"{MAX_DEGREE}")

    def ptr(t):
        return None if init or t is None else t.data_ptr()

    planes = [t for t in tensors if t is not counts]
    vec, rows, paths = qc_variable_layout(
        (len(s) for s in adj.var_side), words, alignment(*planes))
    launch("ldpc_qc_gallager_variable", msg.device, msg.data_ptr(),
           ptr(parity), channel.data_ptr(), adj.var_chk.data_ptr(),
           adj.var_row.data_ptr(), adj.var_shift.data_ptr(), ptr(decided),
           ptr(counts), ptr(tx), adj.nb, dvb, adj.Z, words, threshold,
           int(clamp), int(init), vec, rows)
    qc_gallager_variable.launches += 1
    qc_gallager_variable.vec = vec
    qc_gallager_variable.paths = ("init",) if init else paths


qc_gallager_variable.launches = 0
qc_gallager_variable.vec = qc_gallager_variable.paths = None


# ---------------------------------------------------------------------------
# The decode: the generic loop on these passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _QCGraph:
    """The quasi-cyclic counterpart of ``ops/gallager.py::_Graph``: what
    ``_gallager_loop`` asks of a code, answered by circulant index."""

    adj: QCAdjacency
    clamp: bool               # an irregular base: per-degree threshold
    num_codes: int = 1

    @property
    def n(self) -> int:
        return self.adj.n

    def check_words(self, _words: int) -> None:
        """One code: any number of words."""

    def initial_messages(self, passes, received: torch.Tensor
                         ) -> torch.Tensor:
        msg = torch.empty((self.adj.num_rows * self.adj.Z,
                           received.shape[1]), dtype=torch.int32,
                          device=received.device)
        passes[1](self.adj, msg, None, received, None, None, init=True)
        return msg

    def run_round(self, passes, msg, received, _active, decided, counts,
                  threshold: int, tx) -> None:
        check, variable, _ = passes
        parity = check(self.adj, msg)
        variable(self.adj, msg, parity, received, decided, counts,
                 threshold=threshold, clamp=self.clamp, tx=tx)


_KERNEL_PASSES = (qc_gallager_check, qc_gallager_variable, per_trial_counts)
_PLAIN_PASSES = (_qc_gallager_check_plain, _qc_gallager_variable_plain,
                 _per_trial_counts_plain)


def _decode(code, received, max_iters, threshold, record, tx_bits, passes
            ) -> GallagerResult:
    check_int32("received", received, 2)
    adj = _adjacency(code, received.device)
    clamp = isinstance(code, IrregularQCLDPCCode)
    # the generic decoders' clipping: any t <= 0 always flips, any t above
    # the largest degree never does
    top = adj.var_chk.shape[1] if clamp else code.dv
    t = (top if clamp else top - 1) if threshold is None else \
        min(max(int(threshold), 0), top)
    return _gallager_loop(_QCGraph(adj=adj, clamp=clamp), received,
                          max_iters, lambda _it: t, lambda _it: False,
                          record, passes, tx_bits)


def qc_gallager_decode_packed(code, received: torch.Tensor, max_iters: int,
                              threshold: Optional[int] = None,
                              record: str = "total",
                              tx_bits: Optional[torch.Tensor] = None
                              ) -> GallagerResult:
    """:func:`..gallager.gallager_decode_packed` for a QC code, by
    circulant index; ``received`` is int32[n, W] packed hard-bit planes in
    the expanded layout (v = b*Z + z).  Bit-identical results: a regular
    base (:class:`..models.qc.QCLDPCCode`) follows
    ``gallager_decode_packed``'s raw-threshold rule on ``code.expand()``,
    an irregular base (:class:`..models.qc.IrregularQCLDPCCode`)
    ``gallager_decode_packed_irregular``'s per-degree clamp.  On CUDA
    tensors the rounds run Q3 and Q4 (K4 for per-trial counts); on CPU
    tensors their plain versions."""
    return _decode(code, received, max_iters, threshold, record, tx_bits,
                   _KERNEL_PASSES)


def qc_gallager_decode_packed_plain(code, received: torch.Tensor,
                                    max_iters: int,
                                    threshold: Optional[int] = None,
                                    record: str = "total",
                                    tx_bits: Optional[torch.Tensor] = None
                                    ) -> GallagerResult:
    """:func:`qc_gallager_decode_packed` through the plain version of
    every pass, on any device: the reference the kernels are held to."""
    return _decode(code, received, max_iters, threshold, record, tx_bits,
                   _PLAIN_PASSES)
