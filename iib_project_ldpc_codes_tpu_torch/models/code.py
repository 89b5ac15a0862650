"""Edge-list LDPC code container.

The JAX package's structure (``iib_project_ldpc_codes_tpu/models/code.py``):

  * ``chk_to_var[m, dc]``  -- variable index at each check socket.  Edge
    ``e`` (row-major position in this table) belongs to check ``e // dc``.
  * ``var_to_edge[n, dv]`` -- for each variable, the edge ids of its
    sockets in ascending order (a stable argsort of ``chk_to_var``).
  * ``var_to_chk[n, dv]``  -- the check of each variable socket,
    ``var_to_edge // dc``; kept as a field because every decode round
    reads it.

Both decode directions are then gathers through static int32 tables.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """A (dv,dc)-regular LDPC code in edge-list form (int32 tables)."""

    chk_to_var: torch.Tensor   # int32[m, dc]
    var_to_edge: torch.Tensor  # int32[n, dv]
    n: int
    dv: int
    dc: int
    var_to_chk: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "var_to_chk",
                           (self.var_to_edge // self.dc).contiguous())

    @property
    def m(self) -> int:
        """Number of check nodes (= rows of H)."""
        return (self.n * self.dv) // self.dc

    @property
    def k(self) -> int:
        """Design dimension k = n(dc-dv)/dc."""
        return self.n * (self.dc - self.dv) // self.dc

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def num_edges(self) -> int:
        return self.n * self.dv

    def to(self, device) -> "LDPCCode":
        """The same code with its tables on ``device``."""
        return LDPCCode(chk_to_var=self.chk_to_var.to(device),
                        var_to_edge=self.var_to_edge.to(device),
                        n=self.n, dv=self.dv, dc=self.dc)


def code_from_checks(chk_to_var, n: int, dv: int, dc: int,
                     device=None) -> LDPCCode:
    """Build an :class:`LDPCCode` from a check->variable socket table.

    ``var_to_edge`` comes from a *stable* argsort of the flattened table,
    so each variable's sockets are grouped and ascend by edge id -- the
    JAX package's ordering exactly.
    """
    if (n * dv) % dc:
        raise ValueError("n*dv must be divisible by dc")
    table = torch.as_tensor(chk_to_var, device=device)
    table = table.to(torch.int32).reshape((n * dv) // dc, dc).contiguous()
    if table.numel() and (int(table.min()) < 0 or int(table.max()) >= n):
        raise ValueError("variable index out of range [0, n)")
    flat = table.reshape(-1)
    if flat.numel() and not bool(torch.equal(
            torch.bincount(flat.to(torch.int64), minlength=n),
            torch.full((n,), dv, dtype=torch.int64, device=flat.device))):
        raise ValueError("variable degrees are not all dv")
    order = torch.argsort(flat, stable=True).to(torch.int32)
    return LDPCCode(chk_to_var=table, var_to_edge=order.reshape(n, dv),
                    n=n, dv=dv, dc=dc)


def code_from_numpy(chk_to_var: np.ndarray, n: int, dv: int, dc: int,
                    device="cpu") -> LDPCCode:
    """Carry a code table from the JAX package (``np.asarray(code
    .chk_to_var)``) or any numpy source into the port."""
    return code_from_checks(torch.from_numpy(
        np.array(chk_to_var, dtype=np.int32, order="C")), n, dv, dc,
        device=device)


def dense_parity_check(code: LDPCCode) -> np.ndarray:
    """Dense boolean H of shape [m, n] (small-n export / oracle use only)."""
    chk_to_var = code.chk_to_var.cpu().numpy()
    h = np.zeros((code.m, code.n), dtype=bool)
    rows = np.repeat(np.arange(code.m), code.dc)
    h[rows, chk_to_var.reshape(-1)] = True
    return h


def validate_code(code: LDPCCode) -> Tuple[bool, str]:
    """Host-side structural validation (the JAX package's checks)."""
    chk_to_var = code.chk_to_var.cpu().numpy()
    m, dc = chk_to_var.shape
    if m != code.m or dc != code.dc:
        return False, "shape mismatch"
    if chk_to_var.min() < 0 or chk_to_var.max() >= code.n:
        return False, "variable index out of range"
    counts = np.bincount(chk_to_var.reshape(-1), minlength=code.n)
    if not (counts == code.dv).all():
        return False, "variable degrees are not all dv"
    for row in chk_to_var:
        if len(set(row.tolist())) != dc:
            return False, "check touches the same variable twice"
    var_to_edge = code.var_to_edge.cpu().numpy()
    if not (chk_to_var.reshape(-1)[var_to_edge]
            == np.arange(code.n)[:, None]).all():
        return False, "var_to_edge inconsistent with chk_to_var"
    return True, "ok"
