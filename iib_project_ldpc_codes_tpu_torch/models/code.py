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

A batch of C codes (ensemble mode: a fresh code per group of trials) is the
same class with a leading ``[C]`` axis on all three tables, as the JAX
package's batched ``LDPCCode`` pytree (``models/ensemble.py:175-187``);
``num_codes`` is then C and :meth:`LDPCCode.select` takes one code out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """A (dv,dc)-regular LDPC code in edge-list form (int32 tables), or a
    batch of C such codes with a leading ``[C]`` axis on every table."""

    chk_to_var: torch.Tensor   # int32[m, dc] or int32[C, m, dc]
    var_to_edge: torch.Tensor  # int32[n, dv] or int32[C, n, dv]
    n: int
    dv: int
    dc: int
    # var_to_edge // dc; computed when not given (a sampler that writes it
    # itself passes it in)
    var_to_chk: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           repr=False)

    def __post_init__(self):
        if self.var_to_chk is None:
            object.__setattr__(self, "var_to_chk",
                               (self.var_to_edge // self.dc).contiguous())

    @property
    def batched(self) -> bool:
        """True for a batch of codes (tables with a leading [C] axis)."""
        return self.chk_to_var.dim() == 3

    @property
    def num_codes(self) -> int:
        """C for a batch, 1 for a single code."""
        return self.chk_to_var.shape[0] if self.batched else 1

    def select(self, i: int) -> "LDPCCode":
        """Code ``i`` of a batch, as a single code."""
        if not self.batched:
            raise ValueError("select() needs a batch of codes")
        return LDPCCode(chk_to_var=self.chk_to_var[i],
                        var_to_edge=self.var_to_edge[i], n=self.n,
                        dv=self.dv, dc=self.dc, var_to_chk=self.var_to_chk[i])

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
                        n=self.n, dv=self.dv, dc=self.dc,
                        var_to_chk=self.var_to_chk.to(device))


def _from_tables(table: torch.Tensor, n: int, dv: int, dc: int
                 ) -> LDPCCode:
    """:class:`LDPCCode` from int32[C, m, dc] tables; ``var_to_edge`` by a
    *stable* argsort of each flattened table, so each variable's sockets
    are grouped and ascend by edge id -- the JAX package's ordering."""
    num = table.shape[0]
    if table.numel() and (int(table.min()) < 0 or int(table.max()) >= n):
        raise ValueError("variable index out of range [0, n)")
    flat = table.reshape(num, -1)
    degrees = torch.zeros((num, n), dtype=torch.int64, device=flat.device)
    degrees.scatter_add_(1, flat.to(torch.int64), torch.ones_like(
        flat, dtype=torch.int64))
    if flat.numel() and not bool((degrees == dv).all()):
        raise ValueError("variable degrees are not all dv")
    order = torch.argsort(flat, dim=1, stable=True).to(torch.int32)
    return LDPCCode(chk_to_var=table, var_to_edge=order.reshape(num, n, dv),
                    n=n, dv=dv, dc=dc)


def code_from_checks(chk_to_var, n: int, dv: int, dc: int,
                     device=None) -> LDPCCode:
    """Build an :class:`LDPCCode` from a check->variable socket table
    (any shape holding m*dc entries)."""
    if (n * dv) % dc:
        raise ValueError("n*dv must be divisible by dc")
    table = torch.as_tensor(chk_to_var, device=device)
    table = table.to(torch.int32).reshape(1, (n * dv) // dc, dc)
    return _from_tables(table.contiguous(), n, dv, dc).select(0)


def codes_from_checks(chk_to_var, n: int, dv: int, dc: int,
                      device=None) -> LDPCCode:
    """Build a batch of codes from int32[C, m, dc] socket tables."""
    if (n * dv) % dc:
        raise ValueError("n*dv must be divisible by dc")
    table = torch.as_tensor(chk_to_var, device=device).to(torch.int32)
    if table.dim() != 3 or table.shape[1:] != ((n * dv) // dc, dc):
        raise ValueError(f"tables of shape {tuple(table.shape)} are not "
                         f"[C, {(n * dv) // dc}, {dc}]")
    return _from_tables(table.contiguous(), n, dv, dc)


def code_from_numpy(chk_to_var: np.ndarray, n: int, dv: int, dc: int,
                    device="cpu") -> LDPCCode:
    """Carry a code table from the JAX package (``np.asarray(code
    .chk_to_var)``) or any numpy source into the port."""
    return code_from_checks(torch.from_numpy(
        np.array(chk_to_var, dtype=np.int32, order="C")), n, dv, dc,
        device=device)


def codes_from_numpy(chk_to_var: np.ndarray, n: int, dv: int, dc: int,
                     device="cpu") -> LDPCCode:
    """Carry a batch of code tables, int32[C, m, dc] (e.g. ``np.asarray``
    of the JAX package's ``sample_codes(...).chk_to_var``), into the
    port."""
    return codes_from_checks(torch.from_numpy(
        np.array(chk_to_var, dtype=np.int32, order="C")), n, dv, dc,
        device=device)


def dense_parity_check(code: LDPCCode) -> np.ndarray:
    """Dense boolean H of shape [m, n] (small-n export / oracle use only)."""
    if code.batched:
        raise ValueError("dense_parity_check takes one code; use select()")
    chk_to_var = code.chk_to_var.cpu().numpy()
    h = np.zeros((code.m, code.n), dtype=bool)
    rows = np.repeat(np.arange(code.m), code.dc)
    h[rows, chk_to_var.reshape(-1)] = True
    return h


def validate_code(code: LDPCCode) -> Tuple[bool, str]:
    """Structural validation (the JAX package's checks) of one code, or
    of every code of a batch, in torch on the code's device.  The
    simplicity check comes last, so a multi-edge (``raw``) code that
    reports only it has passed every other check."""
    chk = code.chk_to_var if code.batched else code.chk_to_var[None]
    edges = code.var_to_edge if code.batched else code.var_to_edge[None]
    num, m, dc = chk.shape
    if m != code.m or dc != code.dc:
        return False, "shape mismatch"
    flat = chk.reshape(num, -1).to(torch.int64)
    if int(flat.min()) < 0 or int(flat.max()) >= code.n:
        return False, "variable index out of range"
    degrees = torch.zeros((num, code.n), dtype=torch.int64,
                          device=flat.device)
    degrees.scatter_add_(1, flat, torch.ones_like(flat))
    if not bool((degrees == code.dv).all()):
        return False, "variable degrees are not all dv"
    owner = flat.gather(1, edges.reshape(num, -1).to(torch.int64))
    if not bool((owner.reshape(num, code.n, code.dv) == torch.arange(
            code.n, device=flat.device)[:, None]).all()):
        return False, "var_to_edge inconsistent with chk_to_var"
    rows = chk.sort(dim=2).values
    if bool((rows[..., 1:] == rows[..., :-1]).any()):
        return False, "check touches the same variable twice"
    return True, "ok"
