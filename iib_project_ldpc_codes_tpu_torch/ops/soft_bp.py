"""Soft-decision BP on AWGN and BSC LLRs: sum-product, min-sum, int8 min-sum.

The JAX package's decoder (``iib_project_ldpc_codes_tpu/ops/soft_bp.py``)
on the all-zero codeword, trials in the trailing (column) dimension.  One
flooding round is two hand-written kernels:

  * the variable pass :func:`soft_posterior` (kernel B,
    ``csrc/soft_posterior.cu``): posterior = channel LLR + the dv incoming
    messages in JAX's order, stored in the working type as the plane the
    check pass gathers, and the count of negative posteriors per trial
    (where the trajectories are returned) or per code (the totals);
  * the check pass :func:`soft_check` (kernel C, ``csrc/soft_check.cu``):
    the syndrome from the sign bits of the gathered plane (a count of
    unsatisfied checks per code), the extrinsic subtraction, and min-sum
    (alpha, beta), sum-product or int8 min-sum, written in place.

Messages sit at their flat check-socket row ``c * dc + j`` (the position
``var_to_edge`` names for a regular code, ``var_to_sock`` for an irregular
one), as in the Gallager port, so no routing table is needed; JAX keeps
them socket-major (``[dc * m, B]``, row ``j * m + c``).  Irregular codes
decode on their phantom-padded tables: the phantom variable's LLR is pinned
at ``_PHANTOM_LLR`` (127 after int8 quantisation), padded check sockets
write 0 every round, and padded variable sockets read the phantom check's
always-zero row.  The public outputs keep JAX's ``[n, B]`` layout.

Working types (``msg_dtype``): float32; bfloat16 (float32 arithmetic, the
stored planes rounded to nearest even); int8 (min-sum only, alpha = 1,
beta = 0: LLRs quantised by ``int8_scale`` LSBs per unit, +-127, int16
arithmetic, the posterior returned de-quantised).

The host loop (:func:`_soft_loop`) keeps the JAX ``while_loop`` semantics
(soft_bp.py:288-314), per code of a batch as the JAX engine's vmapped
decode: a round records the error count of the posterior entering it,
updates the messages of every code active at its start, and only then
stops the codes whose syndrome was satisfied, so ``iterations`` is one more
than the round that converged; ``error_totals[t]`` for t >= a code's
iterations is the count of the final posterior, rebuilt from the messages.
A fixed code stops when all its trials satisfy every check.  The host reads
one flag a round.

Random-codeword transmit: ``tx_bits`` is the transmitted codeword plane,
bit-packed int32[n, B // 32] (trial b in bit b % 32 of word b // 32, B a
multiple of 32) as the BEC and Gallager decoders take it, in place of
JAX's bool[n, B].  Kernel B then counts (posterior < 0) ^ tx, so the
error totals and the returned ``hard`` planes hold errors against the
codeword, while ``posterior`` and ``satisfied`` stay in decision space
(JAX soft_bp.py:235-309); an irregular code's phantom row transmits 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import alignment, l2_bytes, launch, use_kernel
from ..models.irregular import IrregularLDPCCode
from .bitops import unpack_bits
from .gallager import _Graph, _gather, _graph, _per_word

_LLR_CLIP = 30.0
_TANH_CLIP = 0.999999
_INT8_MAX = 127
#: pinned channel LLR of an irregular code's phantom variable (JAX
#: soft_bp.py:378): well above the clip, so it reads as a known 0
_PHANTOM_LLR = 1.0e4
#: largest degrees the kernels take (registers per thread)
MAX_DEGREE = 32
#: kernel C's widths a thread, in bytes, widest first, and the share of the
#: card's L2 cache that one column tile of the gathered plane may fill (the
#: message stream passes through the rest)
_CHECK_VECTOR_BYTES = (16, 8, 4)
_CHECK_L2_SHARE = 0.2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_METHODS = {"minsum": 0, "sumproduct": 1}


@dataclasses.dataclass(frozen=True)
class SoftBPResult:
    """Result of a soft decode of B trials (all-zero codeword)."""

    hard: torch.Tensor          # bool[n, B] decision errors (all-zero
    #                             codeword: the decisions, True = bit 1)
    posterior: torch.Tensor     # float32[n, B] posterior LLRs
    error_totals: torch.Tensor  # int32[max_iters+1] decision errors
    iterations: int             # rounds run (a batch: the most of any code)
    code_iterations: torch.Tensor  # int32[C] rounds run by each code
    # int32[max_iters+1, B] per-trial error trajectories (record="per_trial"
    # only; error_totals is then their sum over trials)
    traj: Optional[torch.Tensor] = None
    graph: Optional[_Graph] = dataclasses.field(default=None, repr=False)
    # int32[n, B // 32] the transmitted codewords (None: all-zero)
    tx: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    @property
    def bit_errors(self) -> torch.Tensor:
        """int32[B] decision errors per trial."""
        return self.hard.sum(0, dtype=torch.int32)

    @property
    def failed(self) -> torch.Tensor:
        """bool[B]: any decision error."""
        return self.hard.any(0)

    @property
    def satisfied(self) -> torch.Tensor:
        """bool[B]: the final decisions satisfy every check (JAX
        ``_syndrome_ok``), computed in plain torch when asked."""
        hard = self.hard if self.tx is None else \
            self.hard ^ unpack_bits(self.tx)
        return self.graph.syndrome_ok(hard)


# ---------------------------------------------------------------------------
# The check updates, line for line from JAX (soft_bp.py:97-148)
# ---------------------------------------------------------------------------

def _check_update_minsum(planes, alpha: float, beta: float, mag_cap=None):
    """dc planes -> dc extrinsic planes (float or integer math) by
    prefix/suffix minima and sign XORs; ``mag_cap`` saturates the output
    magnitude (int8 path)."""
    dc = len(planes)
    mags = [p.abs() for p in planes]
    sgns = [p < 0 for p in planes]
    if mag_cap is None:
        big = torch.full_like(planes[0], float("inf"))
    else:
        big = torch.full_like(planes[0], 4 * mag_cap)
    pre_m, suf_m = [big], [big]
    pre_s = [torch.zeros_like(sgns[0])]
    suf_s = [torch.zeros_like(sgns[0])]
    for j in range(dc - 1):
        pre_m.append(torch.minimum(pre_m[-1], mags[j]))
        pre_s.append(pre_s[-1] ^ sgns[j])
    for j in range(dc - 1, 0, -1):
        suf_m.append(torch.minimum(suf_m[-1], mags[j]))
        suf_s.append(suf_s[-1] ^ sgns[j])
    suf_m.reverse()
    suf_s.reverse()
    out = []
    for j in range(dc):
        mag = torch.minimum(pre_m[j], suf_m[j])
        if beta:
            mag = torch.clamp(mag - beta, min=0.0)
        if alpha != 1.0:
            mag = alpha * mag
        if mag_cap is not None:
            mag = torch.clamp(mag, max=mag_cap)
        out.append(torch.where(pre_s[j] ^ suf_s[j], -mag, mag))
    return out


def _check_update_sumproduct(planes):
    """dc planes -> dc extrinsic planes: 2 atanh of the prefix/suffix
    products of tanh(x/2), clipped for stability."""
    dc = len(planes)
    ts = [torch.clamp(torch.tanh(torch.clamp(p, -_LLR_CLIP, _LLR_CLIP) / 2.0),
                      -_TANH_CLIP, _TANH_CLIP) for p in planes]
    one = torch.ones_like(ts[0])
    pre, suf = [one], [one]
    for j in range(dc - 1):
        pre.append(pre[-1] * ts[j])
    for j in range(dc - 1, 0, -1):
        suf.append(suf[-1] * ts[j])
    suf.reverse()
    return [2.0 * torch.atanh(torch.clamp(pre[j] * suf[j], -_TANH_CLIP,
                                          _TANH_CLIP))
            for j in range(dc)]


# ---------------------------------------------------------------------------
# Kernel B: the variable pass
# ---------------------------------------------------------------------------

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int16 if dtype == torch.int8 else torch.float32


def _columns_on(active: torch.Tensor, cols: int) -> torch.Tensor:
    """bool[1, cols]: the columns of the codes whose ``active`` is set."""
    return active.bool().repeat_interleave(cols // active.shape[0])[None, :]


def _soft_posterior_plain(llr0, msg, var_to_sock, active, pm, counts, *,
                          pad_pos: int, post=None, hard=None,
                          int8_scale: float = 4.0, tx=None) -> None:
    """Plain version of kernel B, in JAX's form (soft_bp.py:166-171):
    the dv gathers summed in the accumulation type, padded sockets
    reading the phantom check's zero row; ``counts`` per trial or per
    code, as the wrapper takes them."""
    n_rows, cols = llr0.shape
    acc = _acc_dtype(pm.dtype)
    table = var_to_sock[..., :n_rows, :].long()
    total = llr0.to(acc)
    for p in range(table.shape[-1]):
        total = total + _gather(msg, table[..., p]).to(acc)
    on = _columns_on(active, cols)
    if pm.dtype == torch.int8:
        new = torch.clamp(total, -_INT8_MAX, _INT8_MAX).to(torch.int8)
    else:
        new = total.to(pm.dtype)
    pm.copy_(torch.where(on, new, pm))
    err = total < 0
    if tx is not None:
        err = err ^ unpack_bits(tx)
    per_trial = (err & on).sum(0, dtype=torch.int32)
    if counts.shape[0] == cols:
        counts += per_trial
    else:
        counts += per_trial.reshape(counts.shape[0], -1).sum(
            1, dtype=torch.int32)
    if post is not None:
        value = total[:post.shape[0]].to(torch.float32)
        if pm.dtype == torch.int8:
            value = value / int8_scale
        post.copy_(torch.where(on, value, post))
        hard.copy_(torch.where(on, err[:post.shape[0]], hard))


def soft_posterior(llr0: torch.Tensor, msg: torch.Tensor,
                   var_to_sock: torch.Tensor, active: torch.Tensor,
                   pm: torch.Tensor, counts: torch.Tensor, *, pad_pos: int,
                   post: Optional[torch.Tensor] = None,
                   hard: Optional[torch.Tensor] = None,
                   int8_scale: float = 4.0,
                   tx: Optional[torch.Tensor] = None) -> None:
    """One variable pass, in place.  For the columns of the codes whose
    ``active`` int32[C] is nonzero: ``pm`` [n_rows, B] (working type) =
    the posterior llr0 + the dv messages of ``msg`` [rows * dc, B] at the
    socket rows ``var_to_sock`` int32[(C,) >= n_rows, dv] (rows >=
    ``pad_pos`` skipped), and ``counts += [posterior < 0]``, per trial
    (``counts`` int32[B]) or per code (int32[C]).  ``llr0`` is float32 for
    float32/bfloat16 messages, int8 for int8.  With ``post`` float32[n, B]
    and ``hard`` bool[n, B] given, it also writes the posterior of the
    first n rows (divided by ``int8_scale`` for int8) and the decisions, in
    the same columns.  Given the packed codewords ``tx`` int32[n_rows, B //
    32], the counts and ``hard`` are of the errors (posterior < 0) ^ tx.
    On the card the kernel's trials a thread come from
    :func:`soft_posterior_vector`."""
    dtype = pm.dtype
    if dtype not in _DTYPES or msg.dtype != dtype:
        raise TypeError(f"pm and msg must share a type of {list(_DTYPES)}, "
                        f"got {pm.dtype} and {msg.dtype}")
    want = torch.int8 if dtype == torch.int8 else torch.float32
    if llr0.dtype != want:
        raise TypeError(f"llr0 must be {want} for {dtype} messages")
    if (post is None) != (hard is None):
        raise ValueError("post and hard go together")
    _check_planes(msg, pm, active, var_to_sock)
    if llr0.shape != pm.shape or not llr0.is_contiguous():
        raise ValueError("llr0 must be a contiguous plane of pm's shape")
    cols = llr0.shape[1]
    if counts.dtype != torch.int32 or counts.dim() != 1 or \
            counts.shape[0] not in (cols, active.shape[0]) or \
            not counts.is_contiguous():
        raise ValueError(f"counts must be int32[B = {cols}] or int32[C = "
                         f"{active.shape[0]}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if tx is not None and (tx.dtype != torch.int32 or not tx.is_contiguous()
                           or llr0.shape[1] % 32 or tuple(tx.shape)
                           != (llr0.shape[0], llr0.shape[1] // 32)):
        raise ValueError("tx must be a contiguous int32[n_rows, B // 32]")
    if post is not None and (post.dtype != torch.float32
                             or hard.dtype != torch.bool
                             or post.shape != hard.shape
                             or post.shape[1] != llr0.shape[1]
                             or post.shape[0] > llr0.shape[0]
                             or not post.is_contiguous()
                             or not hard.is_contiguous()):
        raise ValueError("post and hard must be contiguous float32 and bool "
                         "[n, B]")
    if not use_kernel(llr0, msg, var_to_sock, active, pm, counts,
                      *(t for t in (post, hard, tx) if t is not None)):
        _soft_posterior_plain(llr0, msg, var_to_sock, active, pm, counts,
                              pad_pos=pad_pos, post=post, hard=hard,
                              int8_scale=int8_scale, tx=tx)
        return
    n_rows = llr0.shape[0]
    dv = var_to_sock.shape[-1]
    if dv > MAX_DEGREE:
        raise ValueError(f"variable degree {dv} above the kernel's "
                         f"{MAX_DEGREE}")
    if n_rows == 0 or cols == 0:                      # no (variable, trial)
        return
    cpc = cols // active.shape[0]
    planes = [t for t in (llr0, msg, pm, post, hard) if t is not None]
    vec = soft_posterior_vector(pm.element_size(), cpc, dv,
                                [(alignment(t), t.element_size())
                                 for t in planes])
    launch("ldpc_soft_posterior", pm.device, llr0.data_ptr(), msg.data_ptr(),
           var_to_sock.data_ptr(), active.data_ptr(), pm.data_ptr(),
           counts.data_ptr(), 0 if post is None else post.data_ptr(),
           0 if hard is None else hard.data_ptr(),
           None if tx is None else tx.data_ptr(), n_rows,
           0 if post is None else post.shape[0], var_to_sock.shape[-2], dv,
           pad_pos, cols, cpc, vec, int(counts.shape[0] == cols),
           _DTYPES[dtype], float(int8_scale))
    soft_posterior.launches += 1


soft_posterior.launches = 0


def _check_planes(msg, pm, active, table) -> None:
    """Shapes and layout shared by the two passes' wrappers."""
    for name, t in (("msg", msg), ("pm", pm)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [rows, B] plane")
    if active.dtype != torch.int32 or active.dim() != 1 or \
            table.dtype != torch.int32 or not table.is_contiguous():
        raise TypeError("active must be int32[C] and the table contiguous "
                        "int32")
    cols = pm.shape[1]
    num = active.shape[0]
    if msg.shape[1] != cols:
        raise ValueError("pm and msg differ in trials")
    if table.dim() not in (2, 3) or \
            (table.shape[0] if table.dim() == 3 else 1) != num:
        raise ValueError(f"a table of {tuple(table.shape)} for {num} codes")
    if num == 0 or cols % num or (cols // num) % 4:
        raise ValueError(f"{cols} trials do not split into {num} codes of a "
                         "multiple of 4")


# ---------------------------------------------------------------------------
# Kernel C: the check pass
# ---------------------------------------------------------------------------

def _soft_check_plain(pm, msg, chk_to_var, active, unsat, *, method: str,
                      alpha: float, beta: float, pad_var: int) -> None:
    """Plain version of kernel C, in JAX's form (soft_bp.py:200-223)."""
    rows, dc = chk_to_var.shape[-2:]
    cols = pm.shape[1]
    num = active.shape[0]
    acc = _acc_dtype(pm.dtype)
    table = chk_to_var.long()
    post_rows = [_gather(pm, table[..., j]) for j in range(dc)]
    parity = post_rows[0] < 0
    for j in range(1, dc):
        parity = parity ^ (post_rows[j] < 0)
    on = _columns_on(active, cols)
    unsat += (parity & on).sum(0, dtype=torch.int32).reshape(num, -1) \
        .sum(1, dtype=torch.int32)
    planes = msg.view(rows, dc, cols)
    ext = [post_rows[j].to(acc) - planes[:, j].to(acc) for j in range(dc)]
    if pm.dtype == torch.int8:
        new = _check_update_minsum(ext, alpha, beta, mag_cap=_INT8_MAX)
    else:
        ext = [torch.clamp(r, -_LLR_CLIP, _LLR_CLIP) for r in ext]
        new = _check_update_minsum(ext, alpha, beta) \
            if method == "minsum" else _check_update_sumproduct(ext)
    new = [torch.where(_per_word(table[..., j] != pad_var, cols), r, 0)
           for j, r in enumerate(new)]
    out = torch.stack([r.to(pm.dtype) for r in new], 1)
    planes.copy_(torch.where(on[:, None], out, planes))


def soft_check_geometry(elem_size: int, cols: int, cpc: int, dc: int,
                        n_rows: int, l2_bytes: int,
                        align: int = 16) -> tuple[int, int]:
    """Kernel C's launch geometry: ``(vec, tile)``.

    ``vec`` is the trials a thread: the widest of 16, 8 and 4 bytes of
    ``elem_size``-byte elements that divides a code's ``cpc`` columns (one
    vector never holds two codes' trials) and the planes' alignment
    ``align``; 4 bytes where ``dc`` is outside the exact-degree templates
    (2..8).  ``tile`` is the columns of one tile, the launch order's unit:
    the most whole codes (``cpc < cols``), or runs of 32 vectors (a warp's
    run of one row, one code), whose slice of the gathered plane,
    ``n_rows * tile * elem_size`` bytes, fits ``_CHECK_L2_SHARE`` of
    ``l2_bytes``; all ``cols`` when even one such unit is over that budget
    (no tile could stay in L2) or the tile would reach past ``cols``."""
    for nbytes in _CHECK_VECTOR_BYTES:
        vec = nbytes // elem_size
        if (nbytes == 4 or 2 <= dc <= 8) and cpc % vec == 0 and \
                align % nbytes == 0:
            break
    else:
        raise ValueError(f"planes aligned to {align} bytes: kernel C moves "
                         "at least 4")
    unit = cpc if cpc < cols else 32 * vec
    if n_rows * unit == 0:             # an empty plane: one tile of all
        return vec, cols
    fit = int(l2_bytes * _CHECK_L2_SHARE) // (n_rows * unit * elem_size)
    return vec, (min(cols, fit * unit) if fit else cols)


def soft_posterior_vector(elem_size: int, cpc: int, dv: int,
                          planes=()) -> int:
    """Kernel B's trials a thread: the widest of 16, 8 and 4 bytes of
    ``elem_size``-byte trials (the working type) that divides a code's
    ``cpc`` columns (one vector never holds two codes' trials) and to which
    every plane is aligned: ``planes`` lists (alignment, element size) of
    each plane the launch touches, and a plane of e-byte elements moves V
    of them as accesses of min(16, V * e) bytes.  4 bytes where ``dv`` is
    outside the exact-degree templates (2..8)."""
    for nbytes in _CHECK_VECTOR_BYTES:
        vec = nbytes // elem_size
        if (nbytes == 4 or 2 <= dv <= 8) and cpc % vec == 0 and \
                all(align % min(16, vec * elem) == 0
                    for align, elem in planes):
            return vec
    raise ValueError(f"planes aligned to {sorted(set(planes))} (alignment, "
                     f"element bytes) or {cpc} trials a code: kernel B "
                     "moves at least 4 bytes of a code's trials")


def soft_check(pm: torch.Tensor, msg: torch.Tensor, chk_to_var: torch.Tensor,
               active: torch.Tensor, unsat: torch.Tensor, *, method: str,
               alpha: float = 1.0, beta: float = 0.0,
               pad_var: int = -1) -> None:
    """One check pass, in place, for the columns of the active codes:
    ``unsat[g] +=`` the unsatisfied (check, trial) pairs of code g, read
    off the signs of ``pm`` [n_rows, B] at ``chk_to_var`` int32[(C,) rows,
    dc]; every message of ``msg`` [rows * dc, B] replaced by its check
    update (``method`` "minsum" with ``alpha``/``beta`` or "sumproduct";
    int8 messages: min-sum, saturated at 127).  Sockets holding variable
    ``pad_var`` (an irregular code's phantom) get 0.  On the card the
    kernel's trials a thread and column tiles come from
    :func:`soft_check_geometry`."""
    dtype = pm.dtype
    if dtype not in _DTYPES or msg.dtype != dtype:
        raise TypeError(f"pm and msg must share a type of {list(_DTYPES)}")
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    if dtype == torch.int8 and (method != "minsum" or alpha != 1.0
                                or beta != 0.0):
        raise ValueError("int8 messages take min-sum with alpha 1, beta 0")
    _check_planes(msg, pm, active, chk_to_var)
    rows, dc = chk_to_var.shape[-2:]
    if msg.shape[0] != rows * dc:
        raise ValueError(f"msg has {msg.shape[0]} rows, the table {rows} x "
                         f"{dc}")
    if unsat.dtype != torch.int32 or unsat.shape != active.shape:
        raise ValueError("unsat must be int32[C]")
    if rows == 0 or pm.shape[1] == 0:                 # no (check, trial)
        return
    if not use_kernel(pm, msg, chk_to_var, active, unsat):
        _soft_check_plain(pm, msg, chk_to_var, active, unsat, method=method,
                          alpha=alpha, beta=beta, pad_var=pad_var)
        return
    if dc > MAX_DEGREE:
        raise ValueError(f"check degree {dc} above the kernel's "
                         f"{MAX_DEGREE}")
    cols = pm.shape[1]
    cpc = cols // active.shape[0]
    vec, tile = soft_check_geometry(
        pm.element_size(), cols, cpc, dc, pm.shape[0],
        l2_bytes(torch.cuda.current_device()), alignment(pm, msg))
    launch("ldpc_soft_check", pm.device, pm.data_ptr(), msg.data_ptr(),
           chk_to_var.data_ptr(), active.data_ptr(), unsat.data_ptr(), rows,
           rows, dc, pad_var, cols, cpc, vec, tile, _DTYPES[dtype],
           _METHODS[method], float(alpha), float(beta))
    soft_check.launches += 1


soft_check.launches = 0


# ---------------------------------------------------------------------------
# The decode loop
# ---------------------------------------------------------------------------

def _quantise(llr: torch.Tensor, int8_scale: float) -> torch.Tensor:
    """int8 channel LLRs: round half to even, saturate at +-127."""
    return torch.clamp(torch.round(llr * int8_scale), -_INT8_MAX,
                       _INT8_MAX).to(torch.int8)


def _soft_loop(graph: _Graph, llr: torch.Tensor, max_iters: int, method: str,
               alpha: float, beta: float, msg_dtype: torch.dtype,
               int8_scale: float, record: str, passes,
               tx: Optional[torch.Tensor]) -> SoftBPResult:
    """Host loop shared by the decoders (module docstring).  ``graph`` is
    a :class:`_Graph`, or the quasi-cyclic decoder's counterpart
    (``ops/qc_soft_bp.py``) with the same fields and methods; ``passes``
    are its (posterior, check) functions, kernels or plain."""
    posterior, check = passes
    if record not in ("total", "per_trial"):
        raise ValueError(f"unknown record mode {record!r}")
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    if not isinstance(msg_dtype, torch.dtype):         # "bfloat16", ...
        msg_dtype = getattr(torch, str(msg_dtype))
    if msg_dtype not in _DTYPES:
        raise ValueError(f"msg_dtype must be one of {list(_DTYPES)}")
    quantised = msg_dtype == torch.int8
    if quantised and method != "minsum":
        raise ValueError("int8 messages require method='minsum'")
    if quantised and (alpha != 1.0 or beta != 0.0):
        raise ValueError("int8 min-sum: saturation replaces alpha/beta "
                         "corrections")
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    if llr.dim() != 2 or llr.shape[0] != graph.n:
        raise ValueError(f"llr must be [n={graph.n}, B], got "
                         f"{tuple(llr.shape)}")
    llr = llr.to(torch.float32).contiguous()
    cols = llr.shape[1]
    num = graph.num_codes
    device = llr.device
    tx_rows = tx
    if tx is not None:
        if tx.dtype != torch.int32 or cols % 32 or \
                tuple(tx.shape) != (graph.n, cols // 32):
            raise ValueError(f"tx_bits must be the packed int32[{graph.n}, "
                             f"{cols // 32}] plane, got {tx.dtype} "
                             f"{tuple(tx.shape)}")
        tx = tx_rows = tx.contiguous()
    if graph.irregular:
        llr = torch.cat([llr, llr.new_full((1, cols), _PHANTOM_LLR)])
        if tx is not None:                 # the phantom row transmits 0
            tx_rows = torch.cat([tx, tx.new_zeros((1, tx.shape[1]))])
    if llr.numel() >= 2 ** 31:
        raise ValueError(f"{tuple(llr.shape)} LLRs exceed the kernels' "
                         "int32 counters (2^31); split the batch")
    llr0 = _quantise(llr, int8_scale) if quantised else llr
    msg = torch.zeros((graph.msg_rows, cols), dtype=msg_dtype, device=device)
    pm = torch.empty(llr0.shape, dtype=msg_dtype, device=device)
    # the posterior pass counts errors per trial where the trajectories
    # are returned, else per code: the totals and the tail need no more
    width = cols if record == "per_trial" else num
    counts = torch.zeros((max_iters + 1, width), dtype=torch.int32,
                         device=device)
    active = torch.ones(num, dtype=torch.int32, device=device)
    code_iters = torch.zeros(num, dtype=torch.int32, device=device)
    unsat = torch.zeros(num, dtype=torch.int32, device=device)
    pad_var = graph.n if graph.irregular else -1
    it = 0
    while it < max_iters:
        posterior(llr0, msg, graph.var_to_sock, active, pm, counts[it],
                  pad_pos=graph.pad_pos, tx=tx_rows)
        unsat.zero_()
        check(pm, msg, graph.chk_to_var, active, unsat, method=method,
              alpha=alpha, beta=beta, pad_var=pad_var)
        code_iters += active
        active *= (unsat > 0).to(torch.int32)
        it += 1
        if not bool(active.any()):
            break
    final = torch.zeros(width, dtype=torch.int32, device=device)
    post = torch.empty((graph.n, cols), dtype=torch.float32, device=device)
    hard = torch.empty((graph.n, cols), dtype=torch.bool, device=device)
    posterior(llr0, msg, graph.var_to_sock, torch.ones_like(active), pm,
              final, pad_pos=graph.pad_pos, post=post, hard=hard,
              int8_scale=int8_scale, tx=tx_rows)
    # a code's rounds at and after its own count hold the final posterior's
    tail = torch.arange(max_iters + 1, device=device)[:, None] >= \
        code_iters.repeat_interleave(width // num)[None, :]
    traj = torch.where(tail, final[None, :], counts)
    result = dict(hard=hard, posterior=post,
                  error_totals=traj.sum(1, dtype=torch.int64)
                  .to(torch.int32),
                  iterations=int(code_iters.max()),
                  code_iterations=code_iters, graph=graph, tx=tx)
    if record == "per_trial":
        result["traj"] = traj
    return SoftBPResult(**result)


_KERNEL_PASSES = (soft_posterior, soft_check)
_PLAIN_PASSES = (_soft_posterior_plain, _soft_check_plain)


def _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
            int8_scale, tx_bits, record, passes, irregular: bool):
    if isinstance(code, IrregularLDPCCode) != irregular:
        raise TypeError(f"{type(code).__name__} given to the "
                        f"{'irregular' if irregular else 'regular'} decoder")
    return _soft_loop(_graph(code), llr, max_iters, method, alpha, beta,
                      msg_dtype, int8_scale, record, passes, tx_bits)


def soft_bp_decode(code, llr: torch.Tensor, max_iters: int,
                   method: str = "sumproduct", alpha: float = 1.0,
                   beta: float = 0.0, msg_dtype=torch.float32,
                   int8_scale: float = 4.0, tx_bits=None,
                   record: str = "total") -> SoftBPResult:
    """Decode B trials of channel LLRs ``llr`` float32[n, B] (positive
    favours bit 0) on a (dv,dc)-regular code, or on a batch of C codes
    (trial b on code ``b // (B // C)``; B // C a multiple of 4).

    ``method`` "sumproduct" or "minsum" (normalised by ``alpha``, offset by
    ``beta``); ``msg_dtype`` float32, bfloat16 or int8 (min-sum only, with
    ``int8_scale`` LSBs per LLR unit).  ``error_totals`` counts decision
    errors against the all-zero codeword, or against ``tx_bits`` (packed
    int32[n, B // 32] codewords, module docstring), entering each round
    (index 0: the channel decisions, quantised for int8) and after the last;
    ``record="per_trial"`` also fills ``traj``.  On CUDA tensors every
    round runs kernels B and C; on CPU tensors their plain versions.
    """
    return _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
                   int8_scale, tx_bits, record, _KERNEL_PASSES, False)


def soft_bp_decode_plain(code, llr: torch.Tensor, max_iters: int,
                         method: str = "sumproduct", alpha: float = 1.0,
                         beta: float = 0.0, msg_dtype=torch.float32,
                         int8_scale: float = 4.0, tx_bits=None,
                         record: str = "total") -> SoftBPResult:
    """:func:`soft_bp_decode` through the plain version of both passes,
    on any device: the reference the kernels are held to."""
    return _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
                   int8_scale, tx_bits, record, _PLAIN_PASSES, False)


def soft_bp_decode_irregular(code, llr: torch.Tensor, max_iters: int,
                             method: str = "sumproduct", alpha: float = 1.0,
                             beta: float = 0.0, msg_dtype=torch.float32,
                             int8_scale: float = 4.0, tx_bits=None,
                             record: str = "total") -> SoftBPResult:
    """:func:`soft_bp_decode` for an :class:`..models.irregular
    .IrregularLDPCCode` (one or a batch); the same semantics and [n, B]
    outputs."""
    return _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
                   int8_scale, tx_bits, record, _KERNEL_PASSES, True)


def soft_bp_decode_irregular_plain(code, llr: torch.Tensor, max_iters: int,
                                   method: str = "sumproduct",
                                   alpha: float = 1.0, beta: float = 0.0,
                                   msg_dtype=torch.float32,
                                   int8_scale: float = 4.0, tx_bits=None,
                                   record: str = "total") -> SoftBPResult:
    """:func:`soft_bp_decode_irregular` through the plain passes."""
    return _decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
                   int8_scale, tx_bits, record, _PLAIN_PASSES, True)
