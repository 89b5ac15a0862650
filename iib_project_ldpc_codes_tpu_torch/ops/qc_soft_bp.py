"""Soft-decision BP (min-sum, sum-product, int8 min-sum) for quasi-cyclic
codes by circulant index.

The JAX package's decoder (``iib_project_ldpc_codes_tpu/ops/
qc_soft_bp.py``) replaces the generic soft decoder's per-edge gathers by
``jnp.roll`` of whole [Z, B] planes; here, as in the BEC and Gallager QC
decoders (``ops/qc_bp.py``, ``ops/qc_gallager.py``), the shift folds into
the kernels' load addresses and no rolled copy exists.  Messages are
check-resident as in JAX, [E_b * Z, B] in the working type: one [Z, B]
plane per REAL base socket in check-major flat-row order (the order of
JAX's ``_adjacency`` and ``_var_adjacency``, carried by
:class:`..qc_bp.QCAdjacency`), so an irregular base has no padded rows.  One
flooding round is two hand-written kernels:

  * S1 :func:`qc_soft_posterior` (``csrc/qc_soft_posterior.cu``): per
    lifted variable (b, z), posterior = channel LLR + the messages of block
    b's sockets at check row (z - s) mod Z, in JAX's order, stored in the
    working type as the plane the check pass gathers, and the count of
    negative posteriors (per trial, or one for the batch);
  * S2 :func:`qc_soft_check` (``csrc/qc_soft_check.cu``): per lifted check
    (c, z), the posteriors of its sockets at rows (z + s) mod Z, the
    syndrome from their signs, the extrinsic subtraction and the check
    update of the generic kernel C, written in place.

Beside each, its plain version in JAX's form (``torch.roll``), which runs
on CPU tensors.  The loop is the generic decoder's own
(``ops/soft_bp.py::_soft_loop``) given these passes, so the contracts are
the same: int8 needs min-sum with alpha 1 and beta 0 (saturation replaces
the corrections); the LLRs are quantised as round(llr * scale) clipped to
+-127; float messages are clipped at 30; ``error_totals[t]`` counts the
posterior entering round t and its tail the final posterior's; the result
is a :class:`..soft_bp.SoftBPResult` in the expanded layout v = b*Z + z,
whose ``satisfied`` is the syndrome of the final decisions.  Integer
messages make the decode equal to ``soft_bp_decode(code.expand(), ...)``
bit for bit; float messages agree to roundoff (the posterior's addition
order differs), as in JAX.  All-zero codeword only, as JAX's.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import check_int32, launch, use_kernel
from ..models.qc import IrregularQCLDPCCode, QCLDPCCode
from .qc_bp import QCAdjacency, _adjacency
from .soft_bp import (_DTYPES, _INT8_MAX, _LLR_CLIP, _METHODS, MAX_DEGREE,
                      SoftBPResult, _acc_dtype, _check_update_minsum,
                      _check_update_sumproduct, _soft_loop)


def _check_args(adj: QCAdjacency, pm: torch.Tensor, msg: torch.Tensor,
                active: torch.Tensor) -> int:
    """Raise unless ``pm`` [n, B] and ``msg`` [E_b * Z, B] are contiguous
    planes of one working type with B a multiple of 4 and ``active`` is
    int32[1]; returns B."""
    if pm.dtype not in _DTYPES or msg.dtype != pm.dtype:
        raise TypeError(f"pm and msg must share a type of {list(_DTYPES)}, "
                        f"got {pm.dtype} and {msg.dtype}")
    cols = pm.shape[1] if pm.dim() == 2 else -1
    for name, t, rows in (("pm", pm, adj.n),
                          ("msg", msg, adj.num_rows * adj.Z)):
        if t.dim() != 2 or not t.is_contiguous() or \
                tuple(t.shape) != (rows, cols):
            raise ValueError(f"{name} must be a contiguous [{rows}, B] "
                             f"plane, got {tuple(t.shape)}")
    if cols % 4:
        raise ValueError(f"{cols} trials are not a multiple of 4")
    check_int32("active", active, 1)
    if active.shape != (1,):
        raise ValueError("active must be int32[1]: a QC decode is one code")
    return cols


# ---------------------------------------------------------------------------
# S1: the variable pass
# ---------------------------------------------------------------------------

def _qc_soft_posterior_plain(llr0, msg, adj: QCAdjacency, active, pm, counts,
                             *, pad_pos: int = 0, post=None, hard=None,
                             int8_scale: float = 4.0, tx=None) -> None:
    """Plain version of S1, in JAX's form (qc_soft_bp.py:61-69): each
    message plane rolled by +s into its block's frame and added in the
    accumulation type."""
    if not bool(active[0]):
        return
    Z = adj.Z
    acc = _acc_dtype(pm.dtype)
    planes = msg.view(adj.num_rows, Z, -1)
    for b, sockets in enumerate(adj.var_side):
        block = slice(b * Z, (b + 1) * Z)
        total = llr0[block].to(acc)
        for row, _c, s in sockets:
            total = total + torch.roll(planes[row], s, 0).to(acc)
        if pm.dtype == torch.int8:
            pm[block] = torch.clamp(total, -_INT8_MAX, _INT8_MAX) \
                .to(torch.int8)
        else:
            pm[block] = total.to(pm.dtype)
        err = total < 0
        counts += err.sum(dtype=torch.int32) if counts.shape == (1,) else \
            err.sum(0, dtype=torch.int32)
        if post is not None:
            value = total.to(torch.float32)
            if pm.dtype == torch.int8:
                value = value / int8_scale
            post[block] = value
            hard[block] = err


def qc_soft_posterior(llr0: torch.Tensor, msg: torch.Tensor,
                      adj: QCAdjacency, active: torch.Tensor,
                      pm: torch.Tensor, counts: torch.Tensor, *,
                      pad_pos: int = 0, post=None, hard=None,
                      int8_scale: float = 4.0, tx=None) -> None:
    """One variable pass, in place, unless ``active[0]`` is 0: ``pm``
    [n, B] (working type) = the posterior, llr0 + the messages of ``msg``
    [E_b * Z, B] routed by ``adj``, and ``counts +=`` [posterior < 0],
    per trial (``counts`` int32[B]) or for the batch (int32[1]).  ``llr0``
    is float32 for float32/bfloat16 messages, int8 for int8.  With
    ``post`` float32[n, B] and ``hard`` bool[n, B] given, it also writes
    the posterior (divided by ``int8_scale`` for int8) and the decisions.
    The signature is kernel B's (``pad_pos`` is not read); ``tx`` must be
    None (all-zero codeword)."""
    if tx is not None:
        raise ValueError("the QC soft decoder takes the all-zero codeword "
                         "only")
    cols = _check_args(adj, pm, msg, active)
    want = torch.int8 if pm.dtype == torch.int8 else torch.float32
    if llr0.dtype != want or llr0.shape != pm.shape or \
            not llr0.is_contiguous():
        raise ValueError(f"llr0 must be a contiguous {want} plane of pm's "
                         "shape")
    check_int32("counts", counts, 1)
    if counts.shape not in ((cols,), (1,)):
        raise ValueError("counts must be int32[B] or int32[1]")
    if (post is None) != (hard is None):
        raise ValueError("post and hard go together")
    if post is not None and (post.dtype != torch.float32
                             or hard.dtype != torch.bool
                             or post.shape != pm.shape
                             or hard.shape != pm.shape
                             or not post.is_contiguous()
                             or not hard.is_contiguous()):
        raise ValueError("post and hard must be contiguous float32 and bool "
                         "[n, B]")
    tensors = [llr0, msg, active, pm, counts, adj.var_row] + \
        ([] if post is None else [post, hard])
    if not use_kernel(*tensors):
        _qc_soft_posterior_plain(llr0, msg, adj, active, pm, counts,
                                 post=post, hard=hard, int8_scale=int8_scale)
        return
    dvb = adj.var_row.shape[1]
    if dvb > MAX_DEGREE:
        raise ValueError(f"base variable degree {dvb} above the kernel's "
                         f"{MAX_DEGREE}")
    launch("ldpc_qc_soft_posterior", pm.device, llr0.data_ptr(),
           msg.data_ptr(), adj.var_row.data_ptr(), adj.var_shift.data_ptr(),
           active.data_ptr(), pm.data_ptr(), counts.data_ptr(),
           0 if post is None else post.data_ptr(),
           0 if hard is None else hard.data_ptr(), adj.nb, dvb, adj.Z, cols,
           int(counts.shape[0] == cols), _DTYPES[pm.dtype],
           float(int8_scale))
    qc_soft_posterior.launches += 1


qc_soft_posterior.launches = 0


# ---------------------------------------------------------------------------
# S2: the check pass
# ---------------------------------------------------------------------------

def _qc_soft_check_plain(pm, msg, adj: QCAdjacency, active, unsat, *,
                         method: str, alpha: float = 1.0, beta: float = 0.0,
                         pad_var: int = -1) -> None:
    """Plain version of S2, in JAX's form (qc_soft_bp.py:83-104): each
    posterior plane rolled by -s into the check frame, the generic check
    updates of ``ops/soft_bp.py``."""
    if not bool(active[0]):
        return
    Z = adj.Z
    acc = _acc_dtype(pm.dtype)
    planes = msg.view(adj.num_rows, Z, -1)
    row = 0
    for sockets in adj.chk_side:
        rows_c = [torch.roll(pm[b * Z:(b + 1) * Z], -s, 0) for b, s in sockets]
        parity = rows_c[0] < 0
        for r in rows_c[1:]:
            parity = parity ^ (r < 0)
        unsat += parity.sum(dtype=torch.int32)
        ext = [rows_c[jj].to(acc) - planes[row + jj].to(acc)
               for jj in range(len(sockets))]
        if pm.dtype == torch.int8:
            upd = _check_update_minsum(ext, alpha, beta, mag_cap=_INT8_MAX)
        else:
            ext = [torch.clamp(r, -_LLR_CLIP, _LLR_CLIP) for r in ext]
            upd = _check_update_minsum(ext, alpha, beta) \
                if method == "minsum" else _check_update_sumproduct(ext)
        for jj, r in enumerate(upd):
            planes[row + jj] = r.to(pm.dtype)
        row += len(sockets)


def qc_soft_check(pm: torch.Tensor, msg: torch.Tensor, adj: QCAdjacency,
                  active: torch.Tensor, unsat: torch.Tensor, *, method: str,
                  alpha: float = 1.0, beta: float = 0.0,
                  pad_var: int = -1) -> None:
    """One check pass, in place, unless ``active[0]`` is 0: ``unsat[0] +=``
    the unsatisfied (check, trial) pairs read off the signs of ``pm``
    [n, B], and every message of ``msg`` [E_b * Z, B] replaced by its check
    update (``method`` "minsum" with ``alpha``/``beta`` or "sumproduct";
    int8 messages: min-sum, saturated at 127).  The signature is kernel
    C's (``pad_var`` is not read: the state has no padded rows)."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    if pm.dtype == torch.int8 and (method != "minsum" or alpha != 1.0
                                   or beta != 0.0):
        raise ValueError("int8 messages take min-sum with alpha 1, beta 0")
    cols = _check_args(adj, pm, msg, active)
    check_int32("unsat", unsat, 1)
    if unsat.shape != (1,):
        raise ValueError("unsat must be int32[1]")
    if not use_kernel(pm, msg, active, unsat, adj.chk_block):
        _qc_soft_check_plain(pm, msg, adj, active, unsat, method=method,
                             alpha=alpha, beta=beta)
        return
    max_dc = max(len(s) for s in adj.chk_side)
    if max_dc > MAX_DEGREE:
        raise ValueError(f"base check degree {max_dc} above the kernel's "
                         f"{MAX_DEGREE}")
    launch("ldpc_qc_soft_check", pm.device, pm.data_ptr(), msg.data_ptr(),
           adj.chk_block.data_ptr(), adj.chk_shift.data_ptr(),
           adj.row_offs.data_ptr(), active.data_ptr(), unsat.data_ptr(),
           adj.mb, adj.chk_block.shape[1], max_dc, adj.Z, cols,
           _DTYPES[pm.dtype], _METHODS[method], float(alpha), float(beta))
    qc_soft_check.launches += 1


qc_soft_check.launches = 0


# ---------------------------------------------------------------------------
# The decode: the generic loop on these passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _QCSoftGraph:
    """What ``_soft_loop`` asks of a code, answered by circulant index:
    both "tables" are the adjacency, which S1 and S2 take in their place."""

    adj: QCAdjacency
    num_codes = 1
    irregular = False
    pad_pos = 0

    @property
    def n(self) -> int:
        return self.adj.n

    @property
    def msg_rows(self) -> int:
        return self.adj.num_rows * self.adj.Z

    @property
    def chk_to_var(self) -> QCAdjacency:
        return self.adj

    @property
    def var_to_sock(self) -> QCAdjacency:
        return self.adj

    def syndrome_ok(self, hard: torch.Tensor) -> torch.Tensor:
        """bool[B]: the decisions satisfy every lifted check, from the
        rolled decision planes (JAX qc_soft_bp.py:174-180)."""
        Z = self.adj.Z
        ok = torch.ones(hard.shape[1], dtype=torch.bool, device=hard.device)
        for sockets in self.adj.chk_side:
            parity = torch.zeros_like(hard[:Z])
            for b, s in sockets:
                parity = parity ^ torch.roll(hard[b * Z:(b + 1) * Z], -s, 0)
            ok &= ~parity.any(0)
        return ok


_KERNEL_PASSES = (qc_soft_posterior, qc_soft_check)
_PLAIN_PASSES = (_qc_soft_posterior_plain, _qc_soft_check_plain)


def _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
            int8_scale, record, passes) -> SoftBPResult:
    if not isinstance(code, (QCLDPCCode, IrregularQCLDPCCode)):
        raise TypeError(f"a QC code is needed, got {type(code).__name__}")
    graph = _QCSoftGraph(adj=_adjacency(code, llr.device))
    return _soft_loop(graph, llr, max_iters, method, alpha, beta, msg_dtype,
                      int8_scale, record, passes, None)


def qc_soft_bp_decode(code, llr: torch.Tensor, max_iters: int,
                      method: str = "sumproduct", alpha: float = 1.0,
                      beta: float = 0.0, msg_dtype=torch.float32,
                      int8_scale: float = 4.0,
                      record: str = "total") -> SoftBPResult:
    """:func:`..soft_bp.soft_bp_decode` for a
    :class:`..models.qc.QCLDPCCode` or :class:`..models.qc
    .IrregularQCLDPCCode`, by circulant index.

    ``llr`` is float32[n, B] (B a multiple of 4) in the expanded layout
    (v = b*Z + z), positive favouring bit 0; all-zero codeword.  Integer
    (int8) decodes equal the generic decoder's on ``code.expand()`` bit for
    bit, float decodes to roundoff.  ``record="per_trial"`` also fills
    ``traj``.  On CUDA tensors every round runs S1 and S2; on CPU tensors
    their plain versions.
    """
    return _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
                   int8_scale, record, _KERNEL_PASSES)


def qc_soft_bp_decode_plain(code, llr: torch.Tensor, max_iters: int,
                            method: str = "sumproduct", alpha: float = 1.0,
                            beta: float = 0.0, msg_dtype=torch.float32,
                            int8_scale: float = 4.0,
                            record: str = "total") -> SoftBPResult:
    """:func:`qc_soft_bp_decode` through the plain version of both passes,
    on any device: the reference the kernels are held to."""
    return _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
                   int8_scale, record, _PLAIN_PASSES)
