"""Quasi-cyclic (protograph-lifted) LDPC codes.

The JAX package's module (``iib_project_ldpc_codes_tpu/models/qc.py``):
the parity-check matrix is a BASE graph of ``nb`` variable blocks and
``mb`` base checks whose edges are Z x Z circulant permutations, the
structure of the standards' codes (5G NR, 802.11, DVB-S2).  The lifted
code has n = nb * Z variables, lifted variable (j, z) at index j*Z + z and
lifted check (c, z) at index c*Z + z; check (c, z) meets variable
(base_chk[c, jj], (z + shifts[c, jj]) mod Z) at each base socket jj -- the
standard circulant convention.  No table per lifted edge exists: the two
small base tables are the whole code, at any block length.

Two containers, as in JAX: :class:`QCLDPCCode`, a (dv,dc)-regular base
in the edge-list form of :class:`..code.LDPCCode` at base scale, and
:class:`IrregularQCLDPCCode`, an irregular base whose check rows are
padded with the sentinel block ``nb`` (shift 0 at padding).

``expand()`` materialises the lifted code as the port's generic
:class:`..code.LDPCCode` / :class:`..irregular.IrregularLDPCCode`, entry
for entry the tables of JAX's ``expand()``, on the device the base tables
lie on, so every generic kernel and engine path runs on QC codes
unchanged and serves as the oracle of the circulant-index decoders
(``ops/qc_bp.py``, ``ops/qc_gallager.py``).

The samplers draw the base graph with the port's host samplers at base
scale and the shifts uniformly in [0, Z) from the same
``torch.Generator``; as for every sampler of the port, the draw differs
from ``jax.random``'s for the same numbers.  To run both packages on one
code, carry JAX's two tables over with :func:`qc_code_from_numpy` /
:func:`irregular_qc_code_from_numpy` or the npz store.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .code import LDPCCode, code_from_checks
from .ensemble import sample_check_table
from .irregular import (IrregularEnsembleSpec, IrregularLDPCCode,
                        sample_irregular_code)


class BaseEdges(NamedTuple):
    """The real sockets of a base graph in check-major order (the flat
    row order of the check-resident message state), as int64 numpy
    arrays of one entry per base edge."""

    check: np.ndarray     # base check c
    slot: np.ndarray      # position among the REAL sockets of its check
    block: np.ndarray     # variable block b
    shift: np.ndarray     # circulant shift s
    var_slot: np.ndarray  # position among block b's sockets, in this order


def base_edges(base_chk, shifts, nb: int) -> BaseEdges:
    """:class:`BaseEdges` of a base table (entries >= ``nb`` are padding
    and are skipped, so regular and irregular bases route alike)."""
    base = np.asarray(base_chk, np.int64)
    real = base < nb
    check, col = np.nonzero(real)                  # row-major: check-major
    block = base[check, col]
    slot = (np.cumsum(real, axis=1) - 1)[check, col]
    # running count of each block's sockets in check-major order
    order = np.argsort(block, kind="stable")
    counts = np.bincount(block, minlength=nb)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    var_slot = np.empty(block.size, np.int64)
    var_slot[order] = np.arange(block.size) - np.repeat(starts, counts)
    return BaseEdges(check=check, slot=slot, block=block,
                     shift=np.asarray(shifts, np.int64)[check, col],
                     var_slot=var_slot)


def _check_tables(base_chk: torch.Tensor, shifts: torch.Tensor, Z: int,
                  rows: int) -> None:
    for name, t in (("base_chk", base_chk), ("shifts", shifts)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != 2:
            raise TypeError(f"{name} must be an int32 tensor of rank 2")
    if base_chk.shape != shifts.shape or base_chk.shape[0] != rows:
        raise ValueError(f"base_chk {tuple(base_chk.shape)} and shifts "
                         f"{tuple(shifts.shape)} must both be [{rows}, dcb]")
    if Z < 1:
        raise ValueError(f"lift size Z={Z} must be >= 1")


@dataclasses.dataclass(frozen=True)
class QCLDPCCode:
    """A Z-lifted (dv,dc)-regular protograph code.

    ``base_chk[mb, dc]`` -- base-variable index per base-check socket (a
    base-scale ``chk_to_var`` table); ``shifts[mb, dc]`` -- the circulant
    shift of each base edge, in [0, Z).
    """

    base_chk: torch.Tensor   # int32[mb, dc]
    shifts: torch.Tensor     # int32[mb, dc]
    Z: int
    nb: int
    dv: int
    dc: int

    def __post_init__(self):
        _check_tables(self.base_chk, self.shifts, self.Z, self.mb)

    @property
    def mb(self) -> int:
        return (self.nb * self.dv) // self.dc

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def k(self) -> int:
        return self.n * (self.dc - self.dv) // self.dc

    def to(self, device) -> "QCLDPCCode":
        """The same code with its two tables on ``device``."""
        return dataclasses.replace(self, base_chk=self.base_chk.to(device),
                                   shifts=self.shifts.to(device))

    def expand(self) -> LDPCCode:
        """Materialise the lifted code as a generic edge-list code, on the
        base tables' device: the socket of lifted check (c, z) for base
        socket (c, jj) is variable
        ``base_chk[c, jj] * Z + (z + shifts[c, jj]) % Z``."""
        z = torch.arange(self.Z, dtype=torch.int64,
                         device=self.base_chk.device)
        var = (self.base_chk.long()[:, None, :] * self.Z
               + (z[None, :, None] + self.shifts.long()[:, None, :])
               % self.Z)                                   # [mb, Z, dc]
        return code_from_checks(var.reshape(self.m, -1), n=self.n,
                                dv=self.dv, dc=self.dc)


@dataclasses.dataclass(frozen=True)
class IrregularQCLDPCCode:
    """A Z-lifted IRREGULAR protograph code (5G-NR-style base graphs).

    ``base_chk[mb, dcb_max]`` -- base-variable index per base-check
    socket, padded with the sentinel ``nb`` (absent socket); ``shifts`` --
    circulant shift per base edge (0 at padding).  The circulant-index
    decoders skip the padded sockets, so every lifted check and variable
    runs at its real degree.
    """

    base_chk: torch.Tensor   # int32[mb, dcb_max], sentinel nb
    shifts: torch.Tensor     # int32[mb, dcb_max]
    Z: int
    nb: int
    mb: int

    def __post_init__(self):
        _check_tables(self.base_chk, self.shifts, self.Z, self.mb)

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def k(self) -> int:
        return self.n - self.m

    def to(self, device) -> "IrregularQCLDPCCode":
        """The same code with its two tables on ``device``."""
        return dataclasses.replace(self, base_chk=self.base_chk.to(device),
                                   shifts=self.shifts.to(device))

    def expand(self) -> IrregularLDPCCode:
        """Materialise as a phantom-padded :class:`..irregular
        .IrregularLDPCCode`, built from the lift directly (no dense H, so
        it works at any n), on the base tables' device.  Check (c, z)
        holds its real sockets compacted to the left; variable (b, z)
        meets check ``(c, (z - s) mod Z)`` for block b's sockets in
        check-major order, at flat socket ``row * dcb_max + slot``."""
        device = self.base_chk.device
        dcb_max = self.base_chk.shape[1]
        Z, n, m = self.Z, self.n, self.m
        edges = base_edges(self.base_chk.cpu().numpy(),
                           self.shifts.cpu().numpy(), self.nb)
        c, slot, b, s, i = (torch.from_numpy(a).to(device)[:, None]
                            for a in edges)                    # [E_b, 1]
        z = torch.arange(Z, dtype=torch.int64, device=device)[None, :]
        dv_max = int(edges.var_slot.max()) + 1 if edges.block.size else 1

        def table(rows: int, width: int, pad: int) -> torch.Tensor:
            return torch.full((rows, width), pad, dtype=torch.int32,
                              device=device)

        chk_to_var = table(m + 1, dcb_max, n)
        chk_to_var[c * Z + z, slot] = (b * Z + (z + s) % Z).to(torch.int32)
        var_to_chk = table(n + 1, dv_max, m)
        var_to_sock = table(n + 1, dv_max, m * dcb_max)
        rows = c * Z + (z - s) % Z
        var_to_chk[b * Z + z, i] = rows.to(torch.int32)
        var_to_sock[b * Z + z, i] = (rows * dcb_max + slot).to(torch.int32)
        return IrregularLDPCCode(
            chk_to_var=chk_to_var, var_to_chk=var_to_chk,
            var_to_sock=var_to_sock, n=n, m=m, dv_max=dv_max,
            dc_max=dcb_max, num_edges=int(edges.block.size) * Z)


# ---------------------------------------------------------------------------
# Samplers and protograph design
# ---------------------------------------------------------------------------

def _draw_shifts(generator: torch.Generator, base_chk: torch.Tensor,
                 nb: int, Z: int) -> torch.Tensor:
    """Shifts uniform in [0, Z) on the real sockets, 0 at padding."""
    shifts = torch.randint(0, Z, tuple(base_chk.shape), generator=generator,
                           dtype=torch.int32)
    return torch.where(base_chk < nb, shifts, 0)


def sample_qc_code(generator: torch.Generator, nb: int, dv: int, dc: int,
                   Z: int, method: str = "repair",
                   device="cpu") -> QCLDPCCode:
    """Sample a QC code: base graph from the (dv,dc) configuration model
    at base scale (simple unless ``method == "raw"``, which also makes the
    lifted code simple for any shifts), then shifts uniform in [0, Z),
    both from ``generator``."""
    if (nb * dv) % dc:
        raise ValueError("nb*dv must be divisible by dc")
    base = sample_check_table(generator, nb, dv, dc, method)
    return QCLDPCCode(base_chk=base, shifts=_draw_shifts(generator, base,
                                                         nb, Z),
                      Z=Z, nb=nb, dv=dv, dc=dc).to(device)


def _sample_base_irregular(generator: torch.Generator,
                           spec: IrregularEnsembleSpec,
                           method: str) -> torch.Tensor:
    """An irregular base table int32[mb, dcb_max]: the host sampler's
    check table without its phantom row (sentinel entries == nb mark the
    absent sockets)."""
    return sample_irregular_code(generator, spec, method) \
        .chk_to_var[:-1].contiguous()


def sample_qc_code_irregular(generator: torch.Generator, nb: int, lam, rho,
                             Z: int, method: str = "repair",
                             device="cpu") -> IrregularQCLDPCCode:
    """Sample an irregular protograph: base graph from the (lam, rho)
    configuration model at base scale ``nb``, shifts uniform in [0, Z) on
    the real sockets."""
    spec = IrregularEnsembleSpec.from_lam_rho(nb, lam, rho)
    base = _sample_base_irregular(generator, spec, method)
    return IrregularQCLDPCCode(
        base_chk=base, shifts=_draw_shifts(generator, base, nb, Z), Z=Z,
        nb=nb, mb=spec.m).to(device)


def design_protograph(generator: torch.Generator, nb: int, lam, rho, Z: int,
                      tries: int = 32, method: str = "repair",
                      device="cpu") -> Tuple[IrregularQCLDPCCode, float]:
    """Pick the best of ``tries`` sampled irregular bases by their
    protograph BEC threshold (``utils.theory.protograph_threshold``, the
    exact Z -> infinity lift threshold), then attach shifts.  Small random
    protographs scatter below the (lam, rho) ensemble threshold; this
    rejection design recovers most of the gap at protograph scale.
    Returns ``(IrregularQCLDPCCode, threshold)``."""
    from ..utils.theory import protograph_threshold

    if tries < 1:
        raise ValueError(f"tries={tries} must be >= 1")
    spec = IrregularEnsembleSpec.from_lam_rho(nb, lam, rho)
    best, best_t = None, -1.0
    for _ in range(tries):
        base = _sample_base_irregular(generator, spec, method)
        t = protograph_threshold(base.numpy(), nb, precision=1e-4)
        if t > best_t:
            best, best_t = base, t
    code = IrregularQCLDPCCode(
        base_chk=best, shifts=_draw_shifts(generator, best, nb, Z), Z=Z,
        nb=nb, mb=spec.m).to(device)
    return code, best_t


# ---------------------------------------------------------------------------
# Carrying codes over
# ---------------------------------------------------------------------------

def _tables_from_numpy(base_chk, shifts, device):
    return [torch.from_numpy(np.array(t, dtype=np.int32, order="C"))
            .to(device) for t in (base_chk, shifts)]


def qc_code_from_numpy(base_chk, shifts, Z: int, nb: int, dv: int, dc: int,
                       device="cpu") -> QCLDPCCode:
    """Carry a regular QC code (``np.asarray`` of a JAX ``QCLDPCCode``'s
    two tables, or any numpy source) into the port."""
    base, sh = _tables_from_numpy(base_chk, shifts, device)
    return QCLDPCCode(base_chk=base, shifts=sh, Z=int(Z), nb=int(nb),
                      dv=int(dv), dc=int(dc))


def irregular_qc_code_from_numpy(base_chk, shifts, Z: int, nb: int, mb: int,
                                 device="cpu") -> IrregularQCLDPCCode:
    """Carry an irregular QC code (a JAX ``IrregularQCLDPCCode``'s two
    tables) into the port."""
    base, sh = _tables_from_numpy(base_chk, shifts, device)
    return IrregularQCLDPCCode(base_chk=base, shifts=sh, Z=int(Z),
                               nb=int(nb), mb=int(mb))
