"""Packed BEC BP for quasi-cyclic codes (``models/qc.py``) by circulant
index, no table per lifted edge.

The JAX package's decoder (``iib_project_ldpc_codes_tpu/ops/qc_bp.py``)
replaces the generic decoder's per-edge gathers by ``jnp.roll`` of whole
[Z, W] planes, one rolled copy per base socket and round.  On the GPU the
shift folds into the load address instead: the neighbour of lifted check
(c, z) at base socket j is ``base_chk[c, j] * Z + (z + shifts[c, j]) mod
Z``, computed in the kernel from the two base tables, and no rolled copy
exists.  One round is two hand-written kernels with the exactly-one plane
between them:

  * Q1 :func:`qc_check_exactly_one` (``csrc/qc_check_exactly_one.cu``):
    per lifted check, whether exactly one participant is unknown; with
    value planes also that bit AND the XOR of the known values;
  * Q2 :func:`qc_variable_or` (``csrc/qc_variable_or.cu``): ``known |=``
    the OR over the block's sockets, the erasure count, and with value
    planes ``val |= adopt & ~known``.

Both take their planes in a tile-major layout (:func:`to_tiles`): a
column tile is ``tile`` adjacent words of every row, stored as one
contiguous [rows, tile] block, and the tile is the slowest coordinate of
the kernels' grid, so the plane a pass reads once per socket (Q1
``known``, Q2 the exactly-one plane) is read from L2 after its first
read.  Row-major planes are the layout of one tile of W words.  A decode
whose planes do not fit the card's L2 converts them once at each end
(:func:`qc_bec_layout` picks the tile); each wrapper keeps its last
launch's words a thread and tile in ``.vec`` and ``.tile``.

Beside each, its plain version in JAX's form (``torch.roll``, prefix and
suffix ANDs), which runs on CPU tensors.  State and semantics are those of
the generic decoder on ``code.expand()`` (planes int32[n, W] in the
expanded layout v = b*Z + z; same fixed-point loop, the same
``error_totals`` tails), bit for bit; the loops are the generic decoder's
own (``ops/erasure_bp.py``), given these passes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import alignment, check_int32, l2_bytes, launch, use_kernel
from ..models.qc import base_edges
from .bitops import _per_trial_counts_plain, per_trial_counts, popcount
from .erasure_bp import PackedBPResult, _decode_allzero, _decode_values


@dataclasses.dataclass(frozen=True)
class QCAdjacency:
    """The routing of one QC code, as the passes read it: the two base
    tables and the variable-side adjacency on the planes' device (int32,
    a few hundred entries), and the same on the host for the plain
    versions.  Flat message rows (``row_offs``, ``var_row``) count the
    REAL base sockets check-major, the order of JAX's ``_adjacency`` and
    ``_var_adjacency``."""

    base_chk: torch.Tensor    # int32[mb, dcb], padding nb
    shifts: torch.Tensor      # int32[mb, dcb]
    row_offs: torch.Tensor    # int32[mb+1]: first flat row of each check
    chk_block: torch.Tensor   # int32[mb, dcb]: real sockets compacted to
    #                           the left (socket jj is flat row offs[c]+jj),
    #                           padding nb
    chk_shift: torch.Tensor   # int32[mb, dcb]: their shifts, padding 0
    var_chk: torch.Tensor     # int32[nb, dvb]: base check, padding -1
    var_row: torch.Tensor     # int32[nb, dvb]: flat message row, padding -1
    var_shift: torch.Tensor   # int32[nb, dvb]: shift, padding 0
    Z: int
    nb: int
    # host copies: per base check ((block, shift), ...), per variable
    # block ((flat row, base check, shift), ...)
    chk_side: Tuple[Tuple[Tuple[int, int], ...], ...]
    var_side: Tuple[Tuple[Tuple[int, int, int], ...], ...]

    @property
    def mb(self) -> int:
        return self.base_chk.shape[0]

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def num_rows(self) -> int:
        """E_b, the number of real base sockets."""
        return sum(len(s) for s in self.chk_side)


def _adjacency(code, device) -> QCAdjacency:
    """:class:`QCAdjacency` of a :class:`..models.qc.QCLDPCCode` or
    :class:`..models.qc.IrregularQCLDPCCode` on ``device``.  Padded
    sockets (sentinel block ``nb``) are filtered out, so every lifted
    check runs at its real degree; a base check without a real socket
    raises, as in JAX."""
    base = code.base_chk.cpu().numpy()
    sh = code.shifts.cpu().numpy()
    nb, Z = code.nb, code.Z
    real = base < nb
    if base.size and (base.min() < 0 or base.max() > nb):
        raise ValueError(f"base_chk entries must lie in [0, nb={nb}]")
    if real.any() and (sh[real].min() < 0 or sh[real].max() >= Z):
        raise ValueError(f"shifts must lie in [0, Z={Z})")
    empty = np.nonzero(~real.any(axis=1))[0]
    if empty.size:
        raise ValueError(f"base check {empty[0]} has no real sockets")
    edges = base_edges(base, sh, nb)
    chk_side = [[] for _ in range(base.shape[0])]
    var_side = [[] for _ in range(nb)]
    for row, (c, b, s) in enumerate(zip(edges.check.tolist(),
                                        edges.block.tolist(),
                                        edges.shift.tolist())):
        chk_side[c].append((b, s))
        var_side[b].append((row, c, s))
    dvb = max(1, max(len(v) for v in var_side))
    var = np.zeros((3, nb, dvb), np.int32)
    var[:2] = -1
    var[0, edges.block, edges.var_slot] = edges.check
    var[1, edges.block, edges.var_slot] = np.arange(edges.block.size)
    var[2, edges.block, edges.var_slot] = edges.shift
    offs = np.concatenate([[0], np.cumsum(real.sum(axis=1))]).astype(np.int32)
    chk = np.zeros((2,) + base.shape, np.int32)
    chk[0] = nb
    chk[0, edges.check, edges.slot] = edges.block
    chk[1, edges.check, edges.slot] = edges.shift

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return QCAdjacency(
        base_chk=on_device(base), shifts=on_device(np.where(real, sh, 0)),
        row_offs=on_device(offs), chk_block=on_device(chk[0]),
        chk_shift=on_device(chk[1]), var_chk=on_device(var[0]),
        var_row=on_device(var[1]), var_shift=on_device(var[2]), Z=Z, nb=nb,
        chk_side=tuple(tuple(s) for s in chk_side),
        var_side=tuple(tuple(s) for s in var_side))


def _check_planes(adj: QCAdjacency, rows: int, **planes) -> int:
    """Raise unless every plane is a contiguous int32[rows, W] of one W;
    returns W."""
    words = None
    for name, t in planes.items():
        check_int32(name, t, 2)
        if t.shape[0] != rows or (words is not None and t.shape[1] != words):
            raise ValueError(f"{name} {tuple(t.shape)} is not [{rows}, W] "
                             f"(nb={adj.nb}, mb={adj.mb}, Z={adj.Z})")
        words = t.shape[1]
    return words


# ---------------------------------------------------------------------------
# The layout and the launch rule of Q1 and Q2
# ---------------------------------------------------------------------------

#: words of a column tile where the decodes tile their planes: 16 bytes a
#: row
QC_TILE_WORDS = 4
#: the cache a CPU decode sizes its layout for: the H100's L2, so the CPU
#: takes the layout the card would
QC_CPU_CACHE_BYTES = 50 * 2 ** 20


def qc_bec_layout(rows: int, words: int, align: int, cache_bytes: int
                  ) -> Tuple[int, int]:
    """The decodes' layout and Q1's and Q2's launch, ``(vec, tile)``:
    ``tile`` the words of a column tile, :data:`QC_TILE_WORDS` when the
    ``known`` plane (``rows`` x ``words`` words) is larger than
    ``cache_bytes`` (the card's L2) and the tile divides ``words`` with
    more than one tile, else ``words`` (row-major planes, one tile: a plane
    set that fits L2 gains nothing from tiles); ``vec`` the words a thread
    moves, 4 (16 bytes) when the tile is a multiple of 4 and ``align``
    (the largest power of two up to 16 dividing every plane's address) is
    16, else 1."""
    tiled = rows * words * 4 > cache_bytes and \
        words % QC_TILE_WORDS == 0 and words > QC_TILE_WORDS
    tile = QC_TILE_WORDS if tiled else words
    return _vector(tile, align), tile


def _vector(tile: int, align: int) -> int:
    """Words a thread of Q1 / Q2 moves: 4 when the tile is a multiple of 4
    and the planes are 16-byte aligned, else 1."""
    return 4 if tile % 4 == 0 and align % 16 == 0 else 1


def to_tiles(planes: torch.Tensor, tile: Optional[int]) -> torch.Tensor:
    """``planes`` int32[R, W] in the tile-major layout of ``tile``-word
    column tiles: the same shape, its memory [W // tile, R, tile] (tile t
    of row r at ``(t * R + r) * tile``).  ``tile`` None or W: ``planes``
    itself."""
    rows, words = planes.shape
    if tile is None or tile == words:
        return planes
    return planes.view(rows, words // tile, tile).transpose(0, 1) \
        .contiguous().view(rows, words)


def from_tiles(planes: torch.Tensor, tile: Optional[int]) -> torch.Tensor:
    """The row-major planes of :func:`to_tiles`'s layout."""
    rows, words = planes.shape
    if tile is None or tile == words:
        return planes
    return planes.view(words // tile, rows, tile).transpose(0, 1) \
        .contiguous().view(rows, words)


def _launch_layout(words: int, tile: Optional[int], planes
                   ) -> Tuple[int, int]:
    """``(vec, tile)`` of a launch on ``planes`` laid out in tiles of
    ``tile`` words (None: row-major)."""
    tile = words if tile is None else tile
    if tile <= 0 or words % tile:
        raise ValueError(f"a tile of {tile} words does not divide W = "
                         f"{words}")
    return _vector(tile, alignment(*planes)), tile


# ---------------------------------------------------------------------------
# Q1: the check pass
# ---------------------------------------------------------------------------

def _qc_check_exactly_one_plain(adj: QCAdjacency, known: torch.Tensor,
                                val: Optional[torch.Tensor] = None):
    """Plain version of Q1, in JAX's form (qc_bp.py:64-117): per base
    check, planes rolled by -s into the check frame, prefix and suffix
    ANDs for each socket's exactly-one plane."""
    Z = adj.Z
    eo_rows, adopt_rows = [], []
    for sockets in adj.chk_side:
        kns = [torch.roll(known[b * Z:(b + 1) * Z], -s, 0)
               for b, s in sockets]
        full = torch.full_like(kns[0], -1)
        pre = [full]
        for kn in kns[:-1]:
            pre.append(pre[-1] & kn)
        suf = [full]
        for kn in kns[:0:-1]:
            suf.append(suf[-1] & kn)
        suf.reverse()
        exactly_one = torch.zeros_like(kns[0])
        for j in range(len(sockets)):
            exactly_one |= ~kns[j] & pre[j] & suf[j]
        eo_rows.append(exactly_one)
        if val is not None:
            xor_known = torch.zeros_like(kns[0])
            for (b, s), kn in zip(sockets, kns):
                xor_known ^= torch.roll(val[b * Z:(b + 1) * Z], -s, 0) & kn
            adopt_rows.append(exactly_one & xor_known)
    if val is None:
        return torch.cat(eo_rows)
    return torch.cat(eo_rows), torch.cat(adopt_rows)


def qc_check_exactly_one(adj: QCAdjacency, known: torch.Tensor,
                         val: Optional[torch.Tensor] = None, *,
                         tile: Optional[int] = None):
    """int32[m, W]: per lifted check (c, z) at row c*Z + z and trial,
    whether exactly one of its real participants is still unknown
    (``known`` int32[n, W]).  With the value planes ``val`` int32[n, W]
    it returns ``(exactly_one, adopt)``, the second plane that bit AND the
    XOR of the known participants' values (the contract of
    :func:`..erasure_bp.check_exactly_one_xor`).  Every plane, in and out,
    is in the layout ``tile`` (:func:`to_tiles`; None: row-major)."""
    planes = dict(known=known) if val is None else dict(known=known, val=val)
    words = _check_planes(adj, adj.n, **planes)
    if not use_kernel(adj.base_chk, *planes.values()):
        out = _qc_check_exactly_one_plain(
            adj, from_tiles(known, tile),
            None if val is None else from_tiles(val, tile))
        return to_tiles(out, tile) if val is None else \
            tuple(to_tiles(t, tile) for t in out)
    exactly_one = torch.empty((adj.m, words), dtype=torch.int32,
                              device=known.device)
    adopt = None if val is None else torch.empty_like(exactly_one)
    out = [exactly_one] + ([] if adopt is None else [adopt])
    vec, tile = _launch_layout(words, tile, [*planes.values(), *out])
    launch("ldpc_qc_check_exactly_one", known.device, known.data_ptr(),
           None if val is None else val.data_ptr(),
           adj.chk_block.data_ptr(), adj.chk_shift.data_ptr(),
           exactly_one.data_ptr(),
           None if val is None else adopt.data_ptr(), adj.mb,
           adj.chk_block.shape[1], adj.nb, adj.Z, words, vec, tile)
    qc_check_exactly_one.launches += 1
    qc_check_exactly_one.vec, qc_check_exactly_one.tile = vec, tile
    return exactly_one if val is None else (exactly_one, adopt)


qc_check_exactly_one.launches = 0
qc_check_exactly_one.vec = qc_check_exactly_one.tile = None


# ---------------------------------------------------------------------------
# Q2: the variable pass
# ---------------------------------------------------------------------------

def _qc_variable_or_plain(adj: QCAdjacency, exactly_one: torch.Tensor,
                          known: torch.Tensor, errors: torch.Tensor,
                          slot: int, adopt: Optional[torch.Tensor] = None,
                          val: Optional[torch.Tensor] = None) -> None:
    """Plain version of Q2 (qc_bp.py:82-87, 109-117): each check plane
    rolled back by +s into its variable block's frame and ORed in."""
    Z = adj.Z
    for b, sockets in enumerate(adj.var_side):
        block = slice(b * Z, (b + 1) * Z)
        any_ready = torch.zeros_like(known[block])
        taken = torch.zeros_like(any_ready)
        for _row, c, s in sockets:
            any_ready |= torch.roll(exactly_one[c * Z:(c + 1) * Z], s, 0)
            if val is not None:
                taken |= torch.roll(adopt[c * Z:(c + 1) * Z], s, 0)
        if val is not None:
            val[block] |= taken & ~known[block]
        known[block] |= any_ready
    errors[slot] = popcount(~known).sum(dtype=torch.int64).to(torch.int32)


def qc_variable_or(adj: QCAdjacency, exactly_one: torch.Tensor,
                   known: torch.Tensor, errors: torch.Tensor, slot: int,
                   adopt: Optional[torch.Tensor] = None,
                   val: Optional[torch.Tensor] = None, *,
                   tile: Optional[int] = None) -> None:
    """In place, for lifted variable (b, z) over block b's sockets (check
    c, shift s): ``known |= OR exactly_one[c*Z + (z - s) mod Z]``, and
    ``errors[slot]`` = erasures left (``errors[slot]`` must be 0 on
    entry).  With ``adopt`` and ``val`` (both or neither) first ``val |=
    OR adopt[...] & ~known``, the contract of :func:`..erasure_bp
    .variable_or_adopt`.  Every plane is in the layout ``tile``
    (:func:`to_tiles`; None: row-major)."""
    if (adopt is None) != (val is None):
        raise ValueError("adopt and val go together")
    _check_planes(adj, adj.n, known=known, **({} if val is None
                                              else dict(val=val)))
    words = _check_planes(adj, adj.m, exactly_one=exactly_one,
                          **({} if adopt is None else dict(adopt=adopt)))
    if words != known.shape[1]:
        raise ValueError("exactly_one and known differ in words")
    check_int32("errors", errors, 1)
    if not 0 <= slot < errors.shape[0]:
        raise ValueError(f"slot {slot} outside errors[{errors.shape[0]}]")
    planes = [t for t in (exactly_one, known, adopt, val) if t is not None]
    if not use_kernel(adj.base_chk, errors, *planes):
        if tile is None or tile == words:
            _qc_variable_or_plain(adj, exactly_one, known, errors, slot,
                                  adopt, val)
            return
        rows = [None if t is None else from_tiles(t, tile)
                for t in (exactly_one, known, adopt, val)]
        _qc_variable_or_plain(adj, rows[0], rows[1], errors, slot, rows[2],
                              rows[3])
        for t, r in ((known, rows[1]), (val, rows[3])):
            if t is not None:
                t.copy_(to_tiles(r, tile))
        return
    vec, tile = _launch_layout(words, tile, planes)
    launch("ldpc_qc_variable_or", known.device, known.data_ptr(),
           None if val is None else val.data_ptr(), exactly_one.data_ptr(),
           None if adopt is None else adopt.data_ptr(),
           adj.var_chk.data_ptr(), adj.var_shift.data_ptr(),
           errors[slot:].data_ptr(), adj.nb, adj.mb, adj.var_chk.shape[1],
           adj.Z, words, vec, tile)
    qc_variable_or.launches += 1
    qc_variable_or.vec, qc_variable_or.tile = vec, tile


qc_variable_or.launches = 0
qc_variable_or.vec = qc_variable_or.tile = None


# ---------------------------------------------------------------------------
# Whole decodes: the generic loops on these passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _QCView:
    """What the generic packed loops read of a code (duck-typed
    :class:`..models.code.LDPCCode`): both "tables" are the adjacency,
    which is what Q1 and Q2 take in their place."""

    chk_to_var: QCAdjacency
    var_to_chk: QCAdjacency
    n: int


def _view(code, planes: torch.Tensor) -> _QCView:
    adj = _adjacency(code, planes.device)
    return _QCView(chk_to_var=adj, var_to_chk=adj, n=code.n)


def _decode_tile(erased: torch.Tensor) -> int:
    """The tile of a decode's planes (:func:`qc_bec_layout`, for the L2 of
    the planes' card; the decode's own planes are freshly allocated, so
    16-byte aligned)."""
    cache = l2_bytes(erased.device.index if erased.device.index is not None
                     else torch.cuda.current_device()) \
        if erased.is_cuda else QC_CPU_CACHE_BYTES
    return qc_bec_layout(erased.shape[0], erased.shape[1], 16, cache)[1]


def _value_passes(tile: Optional[int]):
    """(check, variable, counts) of the value-plane loop in layout
    ``tile``."""
    def variable(adj, exactly_one, adopt, known, val, errors, slot):
        qc_variable_or(adj, exactly_one, known, errors, slot, adopt=adopt,
                       val=val, tile=tile)

    return (functools.partial(qc_check_exactly_one, tile=tile), variable,
            per_trial_counts)


def _variable_values_plain(adj, exactly_one, adopt, known, val, errors,
                           slot):
    _qc_variable_or_plain(adj, exactly_one, known, errors, slot, adopt, val)


_VALUE_PLAIN = (_qc_check_exactly_one_plain, _variable_values_plain,
                _per_trial_counts_plain)


def qc_bp_decode_packed_allzero(code, erased: torch.Tensor,
                                max_iters: int) -> PackedBPResult:
    """All-zero-transmit packed decode of 32*W trials on a QC code.

    ``erased`` is int32[n, W] in the expanded layout (v = b*Z + z); the
    result equals ``bp_decode_packed_allzero(code.expand(), erased,
    max_iters)`` bit for bit.  The rounds run on the planes in the layout
    of :func:`qc_bec_layout`, converted at each end (the initial count
    sums over trials, so it reads the tiles as they are).  On CUDA tensors
    every round is Q1 and Q2 (K4 for the initial count); on CPU tensors
    their plain versions.
    """
    tile = _decode_tile(erased)
    res = _decode_allzero(_view(code, erased), to_tiles(erased, tile),
                          max_iters,
                          functools.partial(qc_check_exactly_one, tile=tile),
                          functools.partial(qc_variable_or, tile=tile),
                          per_trial_counts)
    return dataclasses.replace(res, known=from_tiles(res.known, tile))


def qc_bp_decode_packed_allzero_plain(code, erased: torch.Tensor,
                                      max_iters: int) -> PackedBPResult:
    """:func:`qc_bp_decode_packed_allzero` through the plain version of
    every pass, on any device, on row-major planes: the reference the
    kernels are held to."""
    return _decode_allzero(_view(code, erased), erased, max_iters,
                           _qc_check_exactly_one_plain,
                           _qc_variable_or_plain, _per_trial_counts_plain)


def qc_bp_decode_packed(code, erased: torch.Tensor, tx_bits: torch.Tensor,
                        max_iters: int) -> PackedBPResult:
    """Nonzero-transmit variant (cf. :func:`..erasure_bp
    .bp_decode_packed`): ``tx_bits`` int32[n, W] holds a codeword per
    trial, the result's ``val`` the decoded bits where ``known``; its
    rounds in the layout of :func:`qc_bec_layout`, as the all-zero
    decode's."""
    tile = _decode_tile(erased)
    res = _decode_values(_view(code, erased), to_tiles(erased, tile),
                         to_tiles(tx_bits, tile), max_iters,
                         _value_passes(tile), False)[0]
    return dataclasses.replace(res, known=from_tiles(res.known, tile),
                               val=from_tiles(res.val, tile))


def qc_bp_decode_packed_plain(code, erased: torch.Tensor,
                              tx_bits: torch.Tensor, max_iters: int
                              ) -> PackedBPResult:
    """:func:`qc_bp_decode_packed` through the plain passes."""
    return _decode_values(_view(code, erased), erased, tx_bits, max_iters,
                          _VALUE_PLAIN, False)[0]
