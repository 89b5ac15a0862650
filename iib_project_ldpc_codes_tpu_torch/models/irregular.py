"""Irregular (lambda, rho) LDPC ensembles: container, spec and samplers.

The JAX package's module (``iib_project_ldpc_codes_tpu/models/
irregular.py``), with its phantom-node padding and no masks in the hot loop:

  * check rows are padded to ``dc_max`` with a phantom variable ``n``,
    whose packed planes stay known (BEC) or zero (BSC);
  * variable rows are padded to ``dv_max`` with a phantom check ``m``
    whose row holds only the phantom variable, so its summaries are zero;
  * ``var_to_sock`` gives each variable socket's flat position in the
    padded ``[m+1, dc_max]`` check-socket grid, padding -> ``m * dc_max``
    (the phantom row's first position).

So the regular packed decoders run unchanged on the padded tables.  As for
regular codes, a batch of C codes is the same class with a leading ``[C]``
axis on its three tables.

Samplers (the configuration model over the E = sum of degrees sockets):

  * :func:`sample_irregular_code` / :func:`..ensemble.code_for_config` --
    one code on the host from a ``torch.Generator`` (fixed-code mode).
  * :func:`sample_irregular_codes` -- a batch of C codes per Monte Carlo
    chunk.  On a CUDA device one launch of ``csrc/
    sample_irregular_codes.cu`` samples them all; on the CPU the plain
    version computes the same tables bit for bit.

The batch sampler draws exactly as the regular one does (``models/
ensemble.py``'s docstring: the sampler key, Philox counter (d >> 1, code,
chunk, stream), Fisher-Yates from the identity, the repair and reject
streams).  Only the socket -> variable map differs: check socket s holds
variable ``socket_var[perm[s]]`` (the regular map is ``perm[s] // dv``),
check c owns sockets ``chk_offs[c] .. chk_offs[c+1]-1``, and the first
duplicate is the smallest socket index whose variable repeats an earlier
socket of its check row.  On the degenerate spec of a regular ensemble the
check tables equal ``sample_codes``' for the same (seed, chunk, code).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels import launch, use_kernel
from . import ensemble


@dataclasses.dataclass(frozen=True)
class IrregularLDPCCode:
    """An irregular LDPC code in phantom-padded edge-list form, or a batch
    of C such codes with a leading ``[C]`` axis on every table."""

    chk_to_var: torch.Tensor   # int32[(C,) m+1, dc_max], padding n
    var_to_chk: torch.Tensor   # int32[(C,) n+1, dv_max], padding m
    var_to_sock: torch.Tensor  # int32[(C,) n+1, dv_max], padding m*dc_max
    n: int
    m: int
    dv_max: int
    dc_max: int
    num_edges: int

    @property
    def batched(self) -> bool:
        """True for a batch of codes (tables with a leading [C] axis)."""
        return self.chk_to_var.dim() == 3

    @property
    def num_codes(self) -> int:
        """C for a batch, 1 for a single code."""
        return self.chk_to_var.shape[0] if self.batched else 1

    def _with(self, pick) -> "IrregularLDPCCode":
        return dataclasses.replace(
            self, chk_to_var=pick(self.chk_to_var),
            var_to_chk=pick(self.var_to_chk),
            var_to_sock=pick(self.var_to_sock))

    def select(self, i: int) -> "IrregularLDPCCode":
        """Code ``i`` of a batch, as a single code."""
        if not self.batched:
            raise ValueError("select() needs a batch of codes")
        return self._with(lambda t: t[i])

    def to(self, device) -> "IrregularLDPCCode":
        """The same code with its tables on ``device``."""
        return self._with(lambda t: t.to(device))

    @property
    def k(self) -> int:
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def chk_mask(self) -> torch.Tensor:
        """bool[(C,) m+1, dc_max]: real (non-phantom) check sockets."""
        return self.chk_to_var < self.n

    @property
    def var_mask(self) -> torch.Tensor:
        """bool[(C,) n+1, dv_max]: real (non-phantom) variable sockets."""
        return self.var_to_chk < self.m

    @property
    def chk_degrees(self) -> torch.Tensor:
        """int32[(C,) m]: real check degrees."""
        return self.chk_mask[..., :-1, :].sum(-1, dtype=torch.int32)

    @property
    def var_degrees(self) -> torch.Tensor:
        """int32[(C,) n]: real variable degrees."""
        return self.var_mask[..., :-1, :].sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Degree sequences from (lambda, rho) -- numpy, as the JAX package
# ---------------------------------------------------------------------------

def _largest_remainder(fracs: np.ndarray, total: int) -> np.ndarray:
    """Integer counts summing to ``total`` proportional to ``fracs``."""
    raw = fracs * total
    counts = np.floor(raw).astype(np.int64)
    short = total - int(counts.sum())
    if short > 0:
        order = np.argsort(-(raw - counts))
        counts[order[:short]] += 1
    return counts


def degree_sequences_from_lam_rho(n: int, lam: Sequence[float],
                                  rho: Sequence[float]
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Finite-n node-degree sequences realising edge-perspective
    (lambda, rho): ``lam[i]`` is the edge fraction on degree-(i+1)
    variables.  Variable counts by largest remainder summing to n; the
    edge total E fixes the check side, whose rounding residue is absorbed
    by +-1 bumps of the largest-remainder checks (JAX
    ``models/irregular.py:108-165``, the same arithmetic)."""
    lam = np.asarray(lam, float)
    rho = np.asarray(rho, float)
    if lam[0] != 0 or rho[0] != 0:
        raise ValueError("lam/rho must have zero degree-1 mass (c0 == 0)")
    degs_v = np.arange(1, lam.size + 1)
    node_frac_v = np.where(lam > 0, lam / degs_v, 0.0)
    node_frac_v /= node_frac_v.sum()
    counts_v = _largest_remainder(node_frac_v, n)
    var_degrees = np.repeat(degs_v, counts_v)
    E = int(var_degrees.sum())

    degs_c = np.arange(1, rho.size + 1)
    node_frac_c = np.where(rho > 0, rho / degs_c, 0.0)
    inv_avg_c = node_frac_c.sum()          # = int(rho) = 1/avg check degree
    node_frac_c /= inv_avg_c
    m = max(int(round(E * inv_avg_c)), 1)
    counts_c = _largest_remainder(node_frac_c, m)
    chk_degrees = np.repeat(degs_c, counts_c).astype(np.int64)
    diff = E - int(chk_degrees.sum())
    step = 1 if diff > 0 else -1
    i = 0
    order = np.argsort(chk_degrees) if step > 0 else np.argsort(-chk_degrees)
    diff_at_sweep_start = diff
    while diff != 0:
        # a sweep of all m checks without progress: the residue cannot be
        # absorbed (every check at degree 1 while diff < 0)
        if i and i % m == 0:
            if diff == diff_at_sweep_start:
                raise ValueError(
                    f"cannot absorb edge residue {diff} into {m} checks "
                    "(degree floor 1); (lam, rho) is unrealisable at "
                    f"this n")
            diff_at_sweep_start = diff
        c = order[i % m]
        nd = chk_degrees[c] + step
        if 1 <= nd:
            chk_degrees[c] = nd
            diff -= step
        i += 1
    return var_degrees.astype(np.int64), chk_degrees


# ---------------------------------------------------------------------------
# Ensemble spec: the static socket maps
# ---------------------------------------------------------------------------

class IrregularEnsembleSpec:
    """The socket maps of one irregular ensemble, int32 tensors on
    ``device`` (everything that depends on the degree sequences only):

      * ``socket_var[E]``, ``chk_of_socket[E]`` -- owner of each socket;
      * ``var_offs[n+1]``, ``chk_offs[m+1]`` -- first socket of each node;
      * ``pad_map[m+1, dc_max]`` -- check grid -> socket index, pad E;
      * ``sock_to_pad[E]`` -- socket -> flat check-grid position;
      * ``var_pad_map[n+1, dv_max]`` -- variable grid -> socket, pad E.
    """

    def __init__(self, var_degrees, chk_degrees, device="cpu"):
        var_degrees = np.asarray(var_degrees, np.int64)
        chk_degrees = np.asarray(chk_degrees, np.int64)
        if var_degrees.min() < 1 or chk_degrees.min() < 1:
            raise ValueError("all node degrees must be >= 1")
        if var_degrees.sum() != chk_degrees.sum():
            raise ValueError("variable and check socket counts differ")
        self.var_degrees = var_degrees
        self.chk_degrees = chk_degrees
        self.n = n = int(var_degrees.size)
        self.m = m = int(chk_degrees.size)
        self.E = E = int(var_degrees.sum())
        if E >= 2 ** 31:
            raise ValueError(f"{E} sockets must stay below 2^31")
        self.dv_max = int(var_degrees.max())
        self.dc_max = int(chk_degrees.max())
        self.device = torch.device(device)

        voffs = np.concatenate([[0], np.cumsum(var_degrees)])
        offs = np.concatenate([[0], np.cumsum(chk_degrees)])

        def padded(offsets, degrees, width):
            # [rows+1, width] grid of socket indices, E where padded
            slot = np.arange(width)
            grid = np.where(slot < degrees[:, None],
                            offsets[:-1, None] + slot, E)
            return np.vstack([grid, np.full((1, width), E)])

        pad_map = padded(offs, chk_degrees, self.dc_max)
        flat = pad_map.reshape(-1)
        sock_to_pad = np.zeros(E, np.int64)
        sock_to_pad[flat[flat < E]] = np.nonzero(flat < E)[0]
        maps = dict(socket_var=np.repeat(np.arange(n), var_degrees),
                    chk_of_socket=np.repeat(np.arange(m), chk_degrees),
                    var_offs=voffs, chk_offs=offs, pad_map=pad_map,
                    sock_to_pad=sock_to_pad,
                    var_pad_map=padded(voffs, var_degrees, self.dv_max))
        for name, value in maps.items():
            setattr(self, name, torch.as_tensor(value, dtype=torch.int32,
                                                device=self.device))

    @classmethod
    def from_lam_rho(cls, n: int, lam, rho, device="cpu"
                     ) -> "IrregularEnsembleSpec":
        return cls(*degree_sequences_from_lam_rho(n, lam, rho),
                   device=device)

    @classmethod
    def regular(cls, n: int, dv: int, dc: int, device="cpu"
                ) -> "IrregularEnsembleSpec":
        """Degenerate spec of the (dv,dc)-regular ensemble."""
        if (n * dv) % dc:
            raise ValueError("n*dv must be divisible by dc")
        return cls(np.full(n, dv), np.full((n * dv) // dc, dc), device)

    def to(self, device) -> "IrregularEnsembleSpec":
        """The same spec with its maps on ``device``."""
        if torch.device(device) == self.device:
            return self
        return IrregularEnsembleSpec(self.var_degrees, self.chk_degrees,
                                     device)


# ---------------------------------------------------------------------------
# Plain sampler pieces (shared by the host sampler and the batch sampler)
# ---------------------------------------------------------------------------

def _socket_vars(perm: torch.Tensor, spec: IrregularEnsembleSpec
                 ) -> torch.Tensor:
    """int64[R, m+1, dc_max]: the variable at each padded check socket of
    each row of int64[R, E] socket permutations; padding holds n."""
    var = spec.socket_var.long()[perm]
    var = torch.cat([var, torch.full_like(var[:, :1], spec.n)], dim=1)
    return var[:, spec.pad_map.long()]


def _first_duplicates(perm: torch.Tensor, spec: IrregularEnsembleSpec
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of int64[R, E]: (has a duplicate, smallest socket index
    whose variable repeats an earlier real socket of its check row; E
    when none).  Phantom entries never count (JAX ``_row_duplicates``)."""
    chk = _socket_vars(perm, spec)
    dc_max = chk.shape[-1]
    earlier = torch.tril(torch.ones((dc_max, dc_max), dtype=torch.bool,
                                    device=perm.device), -1)
    dup = ((chk[..., :, None] == chk[..., None, :]) & earlier).any(-1) \
        & (chk < spec.n)
    socket = spec.pad_map.long().expand_as(dup)
    first = torch.where(dup, socket, spec.E).flatten(1).amin(1)
    return first < spec.E, first


def _tables_from_perm(perm: torch.Tensor, spec: IrregularEnsembleSpec
                      ) -> IrregularLDPCCode:
    """Batch of codes from int64[C, E] socket permutations (JAX
    ``_sample_irregular:301-313``: the variable side is not sorted)."""
    num, E = perm.shape
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(E, device=perm.device)
                 .expand(num, E))
    inv = torch.cat([inv, torch.full_like(inv[:, :1], E)], dim=1)
    var_socks = inv[:, spec.var_pad_map.long()]           # [C, n+1, dv_max]

    def ext(table, pad):
        return torch.cat([table.long(), torch.tensor(
            [pad], device=perm.device)])

    chk_of = ext(spec.chk_of_socket, spec.m)[var_socks]
    sock = ext(spec.sock_to_pad, spec.m * spec.dc_max)[var_socks]
    return IrregularLDPCCode(
        chk_to_var=_socket_vars(perm, spec).to(torch.int32).contiguous(),
        var_to_chk=chk_of.to(torch.int32).contiguous(),
        var_to_sock=sock.to(torch.int32).contiguous(),
        n=spec.n, m=spec.m, dv_max=spec.dv_max, dc_max=spec.dc_max,
        num_edges=spec.E)


# ---------------------------------------------------------------------------
# Host sampler (fixed codes)
# ---------------------------------------------------------------------------

def sample_irregular_code(generator: torch.Generator,
                          spec: IrregularEnsembleSpec,
                          method: str = "repair",
                          device="cpu") -> IrregularLDPCCode:
    """Sample one code of the ensemble on the host; simple unless
    ``method == "raw"`` (the regular host sampler's loop)."""
    if method not in ensemble.METHODS:
        raise ValueError(f"unknown sampling method {method!r}")
    spec = spec.to("cpu")

    def first_dup(perm):
        dup, first = _first_duplicates(perm[None], spec)
        return int(first[0]) if bool(dup[0]) else -1

    perm = ensemble.match_on_host(generator, spec.E, first_dup, method)
    return _tables_from_perm(perm[None], spec).select(0).to(device)


def irregular_code_seed(code_number: int, n: int, lam, rho) -> int:
    """Generator seed of the fixed irregular code (code_number, n, lam,
    rho): the first 8 bytes of SHA-256 over their ``repr``, below 2^63."""
    text = repr(("irregular", code_number, n, tuple(map(float, lam)),
                 tuple(map(float, rho)))).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8],
                          "little") & ((1 << 63) - 1)


# ---------------------------------------------------------------------------
# Batch sampler (ensemble mode): kernel and plain version
# ---------------------------------------------------------------------------

def _check_sampler_args(chunk: int, num: int, method: str) -> None:
    if method not in ensemble.METHODS:
        raise ValueError(f"unknown sampling method {method!r}")
    if num < 1:
        raise ValueError(f"num={num} must be >= 1")
    if not 0 <= chunk <= ensemble.MASK32 or num > ensemble.MASK32 + 1:
        raise ValueError(f"chunk {chunk} or num {num} outside 32 bits")


def _sample_irregular_codes_plain(seed: int, chunk: int, num: int,
                                  spec: IrregularEnsembleSpec,
                                  method: str = "repair",
                                  device="cpu") -> IrregularLDPCCode:
    """Plain version of the irregular sampler kernel: the regular plain
    sampler's draws with this spec's duplicate rule."""
    _check_sampler_args(chunk, num, method)
    spec = spec.to(device)
    key = ensemble.sampler_key(seed)
    codes = torch.arange(num, dtype=torch.int64, device=spec.device)

    def dups(perm):
        return _first_duplicates(perm, spec)

    if method == "reject":
        perm = ensemble._reject_with(key, codes, chunk, spec.E, dups)
    else:
        perm = ensemble._shuffle_plain(key, codes, chunk,
                                       torch.zeros_like(codes), spec.E)
        if method == "repair":
            ensemble._repair_with(perm, key, codes, chunk, dups)
    return _tables_from_perm(perm, spec)


def sample_irregular_codes(seed: int, chunk: int, num: int,
                           spec: IrregularEnsembleSpec,
                           method: str = "repair", device="cpu",
                           rounds: torch.Tensor | None = None
                           ) -> IrregularLDPCCode:
    """Sample ``num`` codes of the ensemble for Monte Carlo chunk
    ``chunk``: a batch :class:`IrregularLDPCCode`.

    Deterministic in (seed, chunk, code index).  On a CUDA device one
    launch of ``csrc/sample_irregular_codes.cu`` samples all codes; on
    the CPU the plain version computes the same tables.  ``rounds`` as
    :func:`..ensemble.sample_codes` takes it.
    """
    device = torch.device(device)
    ensemble.check_rounds(rounds, num, device)
    if not use_kernel(device):
        code = _sample_irregular_codes_plain(seed, chunk, num, spec, method,
                                             device)
        if rounds is not None:
            rounds.copy_(ensemble.first_shuffle_rounds(seed, chunk, num,
                                                       spec.E))
        return code
    _check_sampler_args(chunk, num, method)
    spec = spec.to(device)
    n, m, E = spec.n, spec.m, spec.E
    chk = torch.empty((num, m + 1, spec.dc_max), dtype=torch.int32,
                      device=device)
    var_to_chk = torch.empty((num, n + 1, spec.dv_max), dtype=torch.int32,
                             device=device)
    var_to_sock = torch.empty_like(var_to_chk)
    layout, per_code, scratch = ensemble.sampler_scratch(num, E, device)
    k0, k1 = ensemble.sampler_key(seed)
    launch("ldpc_sample_irregular_codes", device, chk.data_ptr(),
           var_to_chk.data_ptr(), var_to_sock.data_ptr(),
           0 if scratch is None else scratch.data_ptr(),
           0 if rounds is None else rounds.data_ptr(),
           spec.socket_var.data_ptr(), spec.chk_offs.data_ptr(),
           spec.chk_of_socket.data_ptr(), spec.pad_map.data_ptr(),
           spec.var_pad_map.data_ptr(), spec.sock_to_pad.data_ptr(), num, n,
           m, spec.dv_max, spec.dc_max, ensemble.METHODS.index(method),
           ensemble.MAX_REJECT_TRIES if method == "reject"
           else ensemble.MAX_REPAIR_PASSES,
           k0, k1, chunk, layout, E, per_code)
    sample_irregular_codes.launches += 1
    return IrregularLDPCCode(chk_to_var=chk, var_to_chk=var_to_chk,
                             var_to_sock=var_to_sock, n=n, m=m,
                             dv_max=spec.dv_max, dc_max=spec.dc_max,
                             num_edges=E)


sample_irregular_codes.launches = 0


# ---------------------------------------------------------------------------
# Carrying codes over, dense interop and validation
# ---------------------------------------------------------------------------

def irregular_codes_from_numpy(chk_to_var, var_to_chk, var_to_sock, n: int,
                               m: int, device="cpu") -> IrregularLDPCCode:
    """Carry a batch of irregular codes (``np.asarray`` of a vmapped JAX
    ``IrregularLDPCCode``'s three tables, [C, ...] each) into the port."""
    tables = [torch.from_numpy(np.array(t, dtype=np.int32, order="C"))
              .to(device) for t in (chk_to_var, var_to_chk, var_to_sock)]
    chk, var, sock = tables
    if chk.dim() != 3 or chk.shape[1] != m + 1 or \
            var.shape[:2] != (chk.shape[0], n + 1) or \
            sock.shape != var.shape:
        raise ValueError(f"tables of shapes {[tuple(t.shape) for t in tables]}"
                         f" are not [C, {m + 1}, dc_max], [C, {n + 1}, "
                         "dv_max] x2")
    return IrregularLDPCCode(chk_to_var=chk, var_to_chk=var,
                             var_to_sock=sock, n=n, m=m,
                             dv_max=var.shape[2], dc_max=chk.shape[2],
                             num_edges=int((chk[0] < n).sum()))


def irregular_code_from_numpy(chk_to_var, var_to_chk, var_to_sock, n: int,
                              m: int, device="cpu") -> IrregularLDPCCode:
    """Carry one irregular code (``np.asarray`` of a JAX
    ``IrregularLDPCCode``'s three tables) into the port."""
    return irregular_codes_from_numpy(
        np.asarray(chk_to_var)[None], np.asarray(var_to_chk)[None],
        np.asarray(var_to_sock)[None], n, m, device).select(0)


def dense_parity_check_irregular(code: IrregularLDPCCode) -> np.ndarray:
    """Dense boolean H of shape [m, n] (small-n oracle use only)."""
    if code.batched:
        raise ValueError("dense_parity_check_irregular takes one code")
    chk = code.chk_to_var[:-1].cpu().numpy()
    h = np.zeros((code.m, code.n + 1), bool)
    h[np.repeat(np.arange(code.m), code.dc_max), chk.reshape(-1)] = True
    return h[:, :-1]


def irregular_code_from_dense(h: np.ndarray, device="cpu"
                              ) -> IrregularLDPCCode:
    """The phantom-padded container of a dense H (tools interop); the
    same tables as the JAX package's ``irregular_code_from_dense``."""
    h = np.asarray(h, bool)
    m, n = h.shape
    chk_degrees = h.sum(axis=1)
    var_degrees = h.sum(axis=0)
    dc_max, dv_max = int(chk_degrees.max()), int(var_degrees.max())
    rows, cols = np.nonzero(h)                    # row-major: c, then v
    slot = np.arange(rows.size) - np.repeat(
        np.concatenate([[0], np.cumsum(chk_degrees)[:-1]]), chk_degrees)
    chk_to_var = np.full((m + 1, dc_max), n, np.int32)
    chk_to_var[rows, slot] = cols
    # variable sockets in order of their check (a stable sort by variable)
    order = np.argsort(cols, kind="stable")
    vslot = np.arange(rows.size) - np.repeat(
        np.concatenate([[0], np.cumsum(var_degrees)[:-1]]), var_degrees)
    var_to_chk = np.full((n + 1, dv_max), m, np.int32)
    var_to_sock = np.full((n + 1, dv_max), m * dc_max, np.int32)
    var_to_chk[cols[order], vslot] = rows[order]
    var_to_sock[cols[order], vslot] = rows[order] * dc_max + slot[order]
    return irregular_code_from_numpy(chk_to_var, var_to_chk, var_to_sock,
                                     n, m, device)


def validate_irregular_code(code: IrregularLDPCCode,
                            spec: IrregularEnsembleSpec = None
                            ) -> Tuple[bool, str]:
    """Structural validation (the JAX package's checks) of one code."""
    if code.batched:
        raise ValueError("validate_irregular_code takes one code")
    chk = code.chk_to_var.cpu().numpy()
    var = code.var_to_chk.cpu().numpy()
    sock = code.var_to_sock.cpu().numpy()
    n, m = code.n, code.m
    if chk.shape != (m + 1, code.dc_max) or var.shape != (n + 1, code.dv_max):
        return False, "shape mismatch"
    if not (chk[-1] == n).all():
        return False, "phantom check row must be all-phantom"
    if not (var[-1] == m).all():
        return False, "phantom variable row must point at the phantom check"
    real = chk[:-1][chk[:-1] < n]
    if real.size != code.num_edges:
        return False, "edge count mismatch"
    rows = np.sort(np.where(chk[:-1] < n, chk[:-1], -1 - np.arange(
        code.dc_max)), axis=1)
    repeated = np.nonzero((rows[:, 1:] == rows[:, :-1]).any(1))[0]
    if repeated.size:
        return False, f"check {repeated[0]} touches a variable twice"
    if spec is not None:
        if not (np.sort(spec.chk_degrees)
                == np.sort((chk[:-1] < n).sum(1))).all():
            return False, "check degree multiset mismatch"
        if not (np.sort(spec.var_degrees)
                == np.sort(np.bincount(real, minlength=n))).all():
            return False, "variable degree multiset mismatch"
    flat = chk.reshape(-1)
    mask = var[:-1] < m
    vs = np.broadcast_to(np.arange(n)[:, None], mask.shape)
    if not (flat[sock[:-1][mask]] == vs[mask]).all():
        return False, "var_to_sock inconsistent"
    if not (sock[:-1][mask] // code.dc_max == var[:-1][mask]).all():
        return False, "var_to_chk inconsistent"
    if not (sock[:-1][~mask] // code.dc_max == m).all():
        return False, "padded var_to_sock not on the phantom row"
    if not (np.bincount(real, minlength=n) == mask.sum(1)).all():
        return False, "variable degrees inconsistent between tables"
    return True, "ok"
