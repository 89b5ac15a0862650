"""Systematic encoding for LDPC codes (random-codeword transmit).

The JAX package's encoder (``iib_project_ldpc_codes_tpu/models/
encode.py``): a systematic generator derived from H by GF(2) Gauss-Jordan
elimination, rank-deficient H included.  Pivot columns of H carry the
parity bits, free columns the ``k_eff = n - rank(H)`` information bits.

  * :func:`gf2_row_reduce` -- the elimination, the port's own copy of the
    JAX package's ``ops/ml.py::gf2_row_reduce`` (vendored, not imported).
    The pivot of column c is the first row at or below the current one
    with bit c set, columns in order, as there; the reduced echelon form
    is unique, so pivot columns, free columns and the parity map equal
    JAX's.  It runs as whole-matrix torch operations per column over a
    batch of matrices, with no host read inside the loop, on the device of
    its input: one fixed code, or a chunk's batch of fresh codes at once.
  * :func:`make_encoder` -- the :class:`Encoder` of one code (fields equal
    to JAX ``make_encoder``'s); :func:`code_encoder_planes` -- the device
    constants of one code or a batch straight from its tables, which the
    Monte Carlo engine uses; :func:`encoder_planes` and
    :func:`encoder_planes_padded` -- the same from :class:`Encoder` s.
  * :func:`encode_packed` -- kernel E (``csrc/encode_packed.cu``): 32*W
    codewords from packed information planes, for one code or a batch
    (word w on code ``w // (W // C)``).

The parity map crosses to the device bit-packed, int32[(C,) rank_max,
ceil(k_max / 32)] (bit j % 32 of word j // 32 selects information bit j),
in place of JAX's bool[(C,) rank_max, k_max]: 3.1 MB in place of 25 MB at
n = 10^4.  Padded entries of a batch hold JAX's sentinel ``n`` and the
scatters drop them; padded mask bits are zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import check_int32, launch, use_kernel
from ..ops.bitops import WORD, pack_bits, unpack_bits
from .code import LDPCCode
from .irregular import IrregularLDPCCode

_WORD64 = 64
#: JAX's guard on the dense parity map (encode.py:97-101): rank * k_eff
#: entries, ~n = 3e4
_MAX_MAP_ENTRIES = 2 ** 28


# ---------------------------------------------------------------------------
# GF(2) elimination (the port's copy of ops/ml.py:28-79)
# ---------------------------------------------------------------------------

def _pack_rows(mat: torch.Tensor) -> torch.Tensor:
    """bool[..., c] -> int64[..., ceil(c/64)], bit j of word w = column
    64w+j (JAX ``_pack_rows``, held as int64 bit patterns)."""
    c = mat.shape[-1]
    nw = (c + _WORD64 - 1) // _WORD64
    padded = torch.zeros(mat.shape[:-1] + (nw * _WORD64,), dtype=torch.bool,
                         device=mat.device)
    padded[..., :c] = mat
    bits = padded.reshape(mat.shape[:-1] + (nw, _WORD64)).to(torch.int64)
    out = torch.zeros(mat.shape[:-1] + (nw,), dtype=torch.int64,
                      device=mat.device)
    for b in range(_WORD64):
        out |= bits[..., b] << b
    return out


def _unpack_rows(words: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`_pack_rows`: int64[..., nw] -> bool[..., c]."""
    bits = torch.stack([((words >> b) & 1).to(torch.bool)
                        for b in range(_WORD64)], -1)
    return bits.reshape(words.shape[:-1] + (-1,))[..., :c]


def gf2_row_reduce(aug: torch.Tensor, num_cols: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gauss-Jordan over GF(2) of ``aug`` int64[(C,) m, words] (modified
    in place).

    Only the first ``num_cols`` columns are eligible pivots.  Returns
    ``(reduced, pivots, rank)`` in JAX's layout: ``reduced`` int64[(C,) m,
    words], row r the reduced row of pivot column ``pivots[r]`` for r <
    rank, zero rows after; ``pivots`` int64[(C,) m] (-1 after rank);
    ``rank`` int64[(C,)].  Per column, every matrix of the batch takes the
    first row not yet used as a pivot that has the bit set, and clears the
    column in every other row.  Rows stay where they are while eliminating
    and are gathered into pivot order at the end: JAX swaps each pivot row
    up instead, but the reduced row echelon form is unique, so the two give
    the same rows and pivot columns.  A pivot row is zero left of its
    column, so only the words from the column's word onward are XORed.
    Every 256 columns one host read stops the loop once every matrix has
    used all its rows.
    """
    single = aug.dim() == 2
    if single:
        aug = aug[None]
    num, m, words = aug.shape
    dev = aug.device
    rows = torch.arange(m, device=dev)
    codes = torch.arange(num, device=dev)
    r = torch.zeros(num, dtype=torch.int64, device=dev)
    free = torch.ones((num, m), dtype=torch.bool, device=dev)
    pivot_row = torch.full((num, m + 1), m, dtype=torch.int64, device=dev)
    pivots = torch.full((num, m + 1), -1, dtype=torch.int64, device=dev)
    for c in range(num_cols if m else 0):
        if c % 256 == 0 and c and bool((r >= m).all()):
            break
        w, b = divmod(c, _WORD64)
        bit = ((aug[:, :, w] >> b) & 1).to(torch.bool)          # [C, m]
        p = torch.where(bit & free, rows[None, :], m).amin(1)
        has = p < m
        p = p.clamp(max=m - 1)
        pivot = aug[codes, p]                                   # [C, words]
        bit[codes, p] = False
        bit &= has[:, None]
        aug[:, :, w:] ^= torch.where(bit[:, :, None], pivot[:, None, w:], 0)
        free[codes, p] &= ~has
        pivot_row[codes, r] = torch.where(has, p, m)
        pivots[codes, r] = torch.where(has, c, -1)
        r = r + has.to(torch.int64)
    padded = torch.cat([aug, aug.new_zeros((num, 1, words))], 1)
    reduced = padded[codes[:, None], pivot_row[:, :m]]
    pivots = pivots[:, :m]
    if single:
        return reduced[0], pivots[0], r[0]
    return reduced, pivots, r


# ---------------------------------------------------------------------------
# The encoder of one code, and the device planes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Encoder:
    """Systematic encoder for one code (JAX ``Encoder``)."""

    n: int
    pivot_cols: np.ndarray        # int[rank]: parity positions
    free_cols: np.ndarray         # int[k_eff]: information positions
    # parity_map[r] = packed row over free columns: parity bit r is the
    # XOR of the info bits selected by this row
    parity_map: np.ndarray        # uint64[rank, ceil(k_eff / 64)]

    @property
    def k_eff(self) -> int:
        return len(self.free_cols)

    @property
    def rank(self) -> int:
        return len(self.pivot_cols)

    def mask(self) -> np.ndarray:
        """bool[rank, k_eff]: the unpacked parity map."""
        j = np.arange(self.k_eff)
        return (self.parity_map[:, j // _WORD64]
                >> (j % _WORD64).astype(np.uint64)) & np.uint64(1) != 0

    def encode(self, info_bits: np.ndarray) -> np.ndarray:
        """info_bits [..., k_eff] -> codewords [..., n] over GF(2)."""
        info_bits = np.asarray(info_bits, np.uint8) & 1
        if info_bits.shape[-1] != self.k_eff:
            raise ValueError(f"need {self.k_eff} information bits, got "
                             f"{info_bits.shape[-1]}")
        flat = info_bits.reshape(-1, self.k_eff)
        out = np.zeros((flat.shape[0], self.n), np.uint8)
        out[:, self.free_cols] = flat
        out[:, self.pivot_cols] = (flat.astype(np.int64)
                                   @ self.mask().T.astype(np.int64)) & 1
        return out.reshape(info_bits.shape[:-1] + (self.n,))


def _dense_of(code) -> torch.Tensor:
    """bool[(C,) m, n] parity-check matrices of a code or a batch, on the
    code's device (a double edge sets its entry once, as JAX's
    ``dense_parity_check``)."""
    chk = code.chk_to_var.long()
    single = chk.dim() == 2
    if single:
        chk = chk[None]
    num, rows, _ = chk.shape
    h = torch.zeros((num, rows, code.n + 1), dtype=torch.bool,
                    device=chk.device)
    h.scatter_(2, chk, True)
    if isinstance(code, IrregularLDPCCode):     # drop the phantom row, column
        h = h[:, :code.m]
    h = h[:, :, :code.n]
    return h[0] if single else h


def _check_map_size(rank: int, k_eff: int) -> None:
    if rank * k_eff > _MAX_MAP_ENTRIES:
        raise ValueError(
            f"encoder_planes would materialise a {rank}x{k_eff} dense "
            "GF(2) map (> 256 MB): transmit='random' is a validation-"
            "scale feature (n up to ~3e4); use the all-zero transmit at "
            "larger block lengths")


def _reduce(h: torch.Tensor):
    """Eliminate bool[C, m, n]; returns (reduced bits bool[C, m, n], pivot
    columns int64[C, m] (-1 padded), ranks int64[C])."""
    n = h.shape[-1]
    aug, pivots, rank = gf2_row_reduce(_pack_rows(h), n)
    return _unpack_rows(aug, n), pivots, rank


@dataclasses.dataclass(frozen=True)
class EncoderPlanes:
    """Device constants of :func:`encode_packed` for one code or a batch
    (leading ``[C]``), padded to common widths with sentinel ``n``."""

    mask: torch.Tensor     # int32[(C,) rank_max, ceil(k_max/32)] parity map
    free: torch.Tensor     # int32[(C,) k_max] information positions
    pivots: torch.Tensor   # int32[(C,) rank_max] parity positions
    n: int

    @property
    def batched(self) -> bool:
        return self.mask.dim() == 3

    @property
    def num_codes(self) -> int:
        return self.mask.shape[0] if self.batched else 1

    @property
    def rank(self) -> int:
        """rank_max: parity rows of the (padded) map."""
        return self.pivots.shape[-1]

    @property
    def k(self) -> int:
        """k_max: information rows :func:`encode_packed` reads."""
        return self.free.shape[-1]


def _planes_from_reduced(bits: torch.Tensor, pivots: torch.Tensor,
                         rank: torch.Tensor, single: bool) -> EncoderPlanes:
    """EncoderPlanes from :func:`_reduce`'s output (one host read for the
    widths): the one builder of the plane layout.  Free columns in
    ascending order, as JAX's ``np.setdiff1d``."""
    num, _, n = bits.shape
    dev = bits.device
    ranks = [int(x) for x in rank.tolist()]
    for rk in ranks:
        _check_map_size(rk, n - rk)
    rank_max, k_max = max(ranks), n - min(ranks)
    is_pivot = torch.zeros((num, n + 1), dtype=torch.bool, device=dev)
    is_pivot.scatter_(1, torch.where(pivots >= 0, pivots, n), True)
    cols = torch.arange(n, device=dev)
    # free columns first, in order; then the pivot columns (dropped)
    order = torch.argsort(torch.where(is_pivot[:, :n], n + cols, cols),
                          dim=1)[:, :k_max]
    k_of = torch.tensor([n - rk for rk in ranks], device=dev)
    free = torch.where(torch.arange(k_max, device=dev)[None, :]
                       < k_of[:, None], order, n)
    piv = torch.where(pivots[:, :rank_max] >= 0, pivots[:, :rank_max], n)
    padded = torch.cat([bits[:, :rank_max],
                        bits.new_zeros((num, rank_max, 1))], 2)
    mask = torch.gather(padded, 2,
                        free[:, None, :].expand(num, rank_max, k_max))
    kw = (k_max + WORD - 1) // WORD
    mask = torch.cat([mask, mask.new_zeros((num, rank_max,
                                            kw * WORD - k_max))], 2)
    planes = EncoderPlanes(mask=pack_bits(mask).contiguous(),
                           free=free.to(torch.int32).contiguous(),
                           pivots=piv.to(torch.int32).contiguous(), n=n)
    if single:
        planes = EncoderPlanes(mask=planes.mask[0], free=planes.free[0],
                               pivots=planes.pivots[0], n=n)
    return planes


def code_encoder_planes(code) -> EncoderPlanes:
    """The device planes of a code or a batch of codes (regular or
    irregular), derived on the code's device by one batched elimination
    (the Monte Carlo engine's path: no table leaves the device)."""
    h = _dense_of(code)
    single = h.dim() == 2
    bits, pivots, rank = _reduce(h[None] if single else h)
    return _planes_from_reduced(bits, pivots, rank, single)


def make_encoder(code: Optional[LDPCCode] = None,
                 h: Optional[np.ndarray] = None) -> Encoder:
    """Derive the systematic encoder from H (JAX ``make_encoder``).  Pass
    ``h`` (bool[m, n]) directly for any container.  The elimination runs
    on the code's device, or on the CPU for ``h``."""
    if h is None:
        if code is None:
            raise ValueError("need a code or a dense H")
        if code.batched:
            raise ValueError("make_encoder takes one code; use select()")
        dense = _dense_of(code)
    else:
        dense = torch.as_tensor(np.asarray(h, bool))
    n = dense.shape[1]
    bits, pivots, rank = _reduce(dense[None])
    rk = int(rank[0])
    piv = pivots[0, :rk]
    is_pivot = torch.zeros(n, dtype=torch.bool, device=dense.device)
    is_pivot[piv] = True
    free = torch.nonzero(~is_pivot).reshape(-1)
    mask = bits[0, :rk][:, free]
    parity_map = _pack_rows(mask).cpu().numpy().view(np.uint64)
    return Encoder(n=n, pivot_cols=piv.cpu().numpy().astype(int),
                   free_cols=free.cpu().numpy().astype(int),
                   parity_map=parity_map)


def _planes_of_encoders(encoders: Sequence[Encoder], n: int, device,
                        single: bool) -> EncoderPlanes:
    """:func:`_planes_from_reduced` of encoders: their reduced rows
    rebuilt (row r: bit ``pivot_cols[r]`` and the map over the free
    columns), so the plane layout lives in that one function."""
    rank_max = max(e.rank for e in encoders)
    bits = np.zeros((len(encoders), rank_max, n), bool)
    pivots = np.full((len(encoders), rank_max), -1, np.int64)
    for i, enc in enumerate(encoders):
        rows = np.arange(enc.rank)
        bits[i, rows, enc.pivot_cols] = True
        bits[i][np.ix_(rows, enc.free_cols)] = enc.mask()
        pivots[i, :enc.rank] = enc.pivot_cols
    return _planes_from_reduced(
        torch.from_numpy(bits).to(device), torch.from_numpy(pivots).to(device),
        torch.tensor([e.rank for e in encoders], device=device), single)


def encoder_planes_padded(encoders: Sequence[Encoder], n: int,
                          device="cpu") -> EncoderPlanes:
    """Stacked planes of a batch of encoders (JAX
    ``encoder_planes_padded``), padded to rank_max / k_max with the
    sentinel ``n`` and zero mask bits."""
    return _planes_of_encoders(encoders, n, device, single=False)


def encoder_planes(enc: Encoder, device="cpu") -> EncoderPlanes:
    """Planes of one encoder (JAX ``encoder_planes``, mask bit-packed)."""
    return _planes_of_encoders([enc], enc.n, device, single=True)


# ---------------------------------------------------------------------------
# Kernel E: encode_packed
# ---------------------------------------------------------------------------

def _words_per_code(planes: EncoderPlanes, words: int) -> int:
    num = planes.num_codes
    if words % num:
        raise ValueError(f"{words} words do not split evenly over {num} "
                         "codes")
    return words // num


def _scatter_rows(out: torch.Tensor, rows: torch.Tensor, src: torch.Tensor,
                  num: int) -> None:
    """``out[rows[g, i]]`` in code g's words = ``src[i]`` in code g's
    words, in place; ``out`` [n+1, W] holds a spare row n for the
    sentinel."""
    wpc = out.shape[1] // num
    view = out.view(out.shape[0] * num, wpc)
    codes = torch.arange(num, device=out.device)[:, None]
    index = (rows.long() * num + codes).reshape(-1)
    code_major = src.reshape(src.shape[0], num, wpc).transpose(0, 1)
    view.index_copy_(0, index, code_major.reshape(-1, wpc))


def _encode_packed_plain(planes: EncoderPlanes, info: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of kernel E: JAX's scan over information rows
    (encode.py:136-146), the parity XOR-accumulated row by row."""
    num = planes.num_codes
    words = info.shape[1]
    mask = planes.mask if planes.batched else planes.mask[None]
    bits = unpack_bits(mask)[..., :planes.k]               # [C, R, K]
    acc = torch.zeros((planes.rank, words), dtype=torch.int32,
                      device=info.device)
    for j in range(planes.k):
        sel = bits[:, :, j].t().repeat_interleave(words // num, dim=1)
        acc ^= torch.where(sel, info[j][None, :], 0)
    out = torch.zeros((planes.n + 1, words), dtype=torch.int32,
                      device=info.device)
    free = planes.free if planes.batched else planes.free[None]
    pivots = planes.pivots if planes.batched else planes.pivots[None]
    _scatter_rows(out, free, info, num)
    _scatter_rows(out, pivots, acc, num)
    return out[:planes.n]


def encode_packed(planes: EncoderPlanes, info: torch.Tensor) -> torch.Tensor:
    """int32[n, W] codeword planes of 32*W trials from information planes
    ``info`` int32[k_max, W] (trial b in bit b % 32 of word b // 32; e.g.
    :func:`..ops.bitops.info_planes`).  One code, or a batch of C codes
    with word w on code ``w // (W // C)``.  On CUDA tensors kernel E
    writes the planes; on CPU tensors its plain version."""
    check_int32("info", info, 2)
    for name, t, rank in (("mask", planes.mask, 2), ("free", planes.free, 1),
                          ("pivots", planes.pivots, 1)):
        check_int32(name, t, rank + int(planes.batched))
    if info.shape[0] != planes.k:
        raise ValueError(f"info has {info.shape[0]} rows, the planes take "
                         f"{planes.k}")
    wpc = _words_per_code(planes, info.shape[1])
    if not use_kernel(info, planes.mask, planes.free, planes.pivots):
        return _encode_packed_plain(planes, info)
    words = info.shape[1]
    out = torch.zeros((planes.n, words), dtype=torch.int32,
                      device=info.device)
    launch("ldpc_encode_packed", info.device, info.data_ptr(),
           planes.mask.data_ptr(), planes.free.data_ptr(),
           planes.pivots.data_ptr(), out.data_ptr(), planes.n, planes.rank,
           planes.k, planes.mask.shape[-1], words, wpc)
    encode_packed.launches += 1
    return out


encode_packed.launches = 0
