"""Gallager-A/B hard-decision decoding for the BSC (bit-packed).

The JAX package's decoder (``iib_project_ldpc_codes_tpu/ops/gallager.py``)
on the all-zero codeword: ``received`` is int32[n, W], bit set = the
channel flipped that trial's bit.  One flooding round is two hand-written
kernels:

  * the check pass :func:`gallager_check` (``csrc/gallager_check.cu``):
    ``parity[c]`` = XOR of check c's incoming messages; the extrinsic
    message on a socket is ``parity ^ msg`` (JAX: prefix/suffix XOR);
  * the variable pass :func:`gallager_variable`
    (``csrc/gallager_variable.cu``): per socket, flip the channel bit iff
    at least t of the other incoming messages disagree with it (Gallager-A
    is t = dv-1), decide by majority over all of them, write the new
    messages in place, and count the decision errors and the changed
    message words per code.

Both move 16, 8 or 4 bytes of a row a thread, the widest that a code's
words and the planes' alignment allow (:func:`gallager_round_vector`);
the variable kernel has templates over the :data:`EXACT_DEGREES` and a
generic path at 4 bytes for any other degree up to :data:`MAX_DEGREE`.
Each wrapper keeps the width of its last launch in ``.vec``.

Messages live in int32[rows * dc, W], one row per flat check-socket
position (``var_to_edge`` of a regular code, ``var_to_sock`` of an
irregular one); padded sockets of an irregular code hold 0.  Irregular
codes clamp the threshold per degree, t_d = min(b, max(d-1, 1)) (b = None:
max(d-1, 1)), and decide with d // 2 + 1; regular codes use the raw
threshold (``threshold > dv-1`` never flips, ``<= 0`` always does).

The loop is a host loop with the JAX ``while_loop`` semantics
(``_round_loop``): stop after ``max_iters`` rounds, or when the decision
has no error, or when no message changed -- per code of a batch, as the
JAX engine's vmapped decode stops each code on its own round (a stopped
code's messages and decision stay frozen while the others run on).
``error_totals[0]`` is the raw channel error count, its tail after a code
stops holds that code's final count, and the totals are summed over codes.
The host reads one flag a round.

Kernel G, :func:`gallager_decode` (``csrc/gallager_decode.cu``), runs the
same loop whole on the card, one block per code with the code's messages
and parities in shared memory, and the host reads once a decode.  One
rule, :func:`takes_decode_kernel`, picks it by shape: the generic graph
(not the quasi-cyclic one), ``record="total"``, ``dv <= MAX_DEGREE`` and
a code's messages and parities within one block's shared memory -- the
ensemble chunks at one word (32 trials) per code.  Every other shape (a
fixed code at hundreds of words, the expurgated chunks' per-trial
records, QC codes) runs the round kernels above; both routes are
hand-written kernels, and neither gives way to the other.

Random-codeword transmit (``tx_bits`` int32[n, W], the packed transmitted
codewords; ``received`` is then tx ^ flips): errors are counted against
tx, in the variable kernel's own instantiation, the loop stops on them,
and the returned ``decided`` holds the error planes decision ^ tx (JAX
gallager.py:238-286).  The update is XOR-affine in a codeword shift, so
with the zero run's flips the counts equal the zero run's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from ..kernels import alignment, check_int32, launch, use_kernel
from ..models.irregular import IrregularLDPCCode
from .bitops import _per_trial_counts_plain, per_trial_counts, popcount
from .erasure_bp import (SMEM_OPTIN_BYTES, _check_packed_batch_bits,
                         _code_major_to_plane, _pad_phantom_row,
                         _plane_to_code_major, _words_per_code)

#: largest variable degree the variable kernel takes (registers per thread)
MAX_DEGREE = 32
#: the variable degrees the variable kernel has templates for, at any
#: width; every other degree runs its generic path at one word a thread
EXACT_DEGREES = (3, 4)


def gallager_round_vector(wpc: int, align: int,
                          dv: Optional[int] = None) -> int:
    """The round kernels' words a thread: the widest of 4, 2 and 1 (16, 8
    or 4 bytes of a row) that divides a code's ``wpc`` words, so that one
    vector never holds two codes' words, and whose bytes divide ``align``,
    the largest power of two up to 16 dividing every plane's address.  1
    for a variable degree ``dv`` outside :data:`EXACT_DEGREES`.  The check
    pass has no codes: it passes ``wpc`` = its words and no ``dv``."""
    for vec in (4, 2, 1):
        if wpc % vec == 0 and align % (4 * vec) == 0 and (
                vec == 1 or dv is None or dv in EXACT_DEGREES):
            return vec
    raise ValueError(f"planes aligned to {align} bytes: the round kernels "
                     "move whole 4-byte words")


def _bitsliced_count_ge(bits: List[torch.Tensor], threshold: int
                        ) -> torch.Tensor:
    """A plane whose bit is set iff >= ``threshold`` of the input planes
    have it set: ripple-carry sum planes, then an MSB-first compare (JAX
    ``_bitsliced_count_ge``)."""
    k = len(bits)
    if threshold <= 0:
        return torch.full_like(bits[0], -1)
    if threshold > k:
        return torch.zeros_like(bits[0])
    planes: List[torch.Tensor] = []
    for b in bits:
        carry = b
        for i in range(len(planes)):
            planes[i], carry = planes[i] ^ carry, planes[i] & carry
        planes.append(carry)
    ge = torch.zeros_like(bits[0])                 # sum > prefix
    eq = torch.full_like(bits[0], -1)              # equal so far
    for i in range(len(planes) - 1, -1, -1):
        p = planes[i]
        if (threshold >> i) & 1 == 0:
            ge = ge | (eq & p)
            eq = eq & ~p
        else:
            eq = eq & p
    return ge | eq


def _flip_at_threshold(others: List[torch.Tensor], threshold
                       ) -> torch.Tensor:
    """:func:`_bitsliced_count_ge` with an int threshold, or with a
    threshold per variable (an int tensor broadcasting against the
    planes): compute the count planes for every candidate and select, as
    JAX does for a traced threshold."""
    if isinstance(threshold, int):
        return _bitsliced_count_ge(others, threshold)
    out = torch.where(threshold <= 0, -1, torch.zeros_like(others[0]))
    for b in range(1, len(others) + 1):
        out = torch.where(threshold == b, _bitsliced_count_ge(others, b), out)
    return out


@dataclasses.dataclass(frozen=True)
class GallagerResult:
    """Result of a packed Gallager decode of B = 32*W trials."""

    decided: torch.Tensor       # int32[n, W]; set bit = decision error
    #                             (the decision ^ tx_bits with a codeword)
    error_totals: torch.Tensor  # int32[max_iters+1] decision errors
    iterations: int             # rounds run (a batch: the most of any code)
    # int32[max_iters+1, B] per-trial error trajectories, with
    # record="per_trial" only (the expurgated chunks)
    traj: Optional[torch.Tensor] = None

    @property
    def bit_errors(self) -> torch.Tensor:
        """int32[B]: decision errors per trial (K4 on ``decided``)."""
        return per_trial_counts(self.decided)

    @property
    def failed(self) -> torch.Tensor:
        """bool[B]: trials with at least one decision error."""
        return self.bit_errors > 0


# ---------------------------------------------------------------------------
# Batched row gathers (word w on code w // (W // C), as K2/K3)
# ---------------------------------------------------------------------------

def _index(rows: torch.Tensor, num: int) -> torch.Tensor:
    """Flat row index of ``rows`` int64[C, k] in the code-major view
    [R * C, W // C] of an [R, W] plane (row r, code g -> r*C + g)."""
    codes = torch.arange(num, device=rows.device)[:, None]
    return (rows * num + codes).reshape(-1)


def _gather(plane: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[k, W]: row ``rows[g, i]`` of ``plane`` [R, W] in code g's words,
    for ``rows`` int64[C, k]; or plainly ``plane[rows]`` for int64[k]."""
    if rows.dim() == 1:
        return plane.index_select(0, rows)
    num = rows.shape[0]
    view = plane.reshape(plane.shape[0] * num, -1)
    return _code_major_to_plane(view.index_select(0, _index(rows, num)), num)


def _scatter(plane: torch.Tensor, rows: torch.Tensor, src: torch.Tensor
             ) -> None:
    """Inverse of :func:`_gather`: ``plane[rows[g, i]]`` in code g's words
    = ``src[i]`` in code g's words, in place."""
    if rows.dim() == 1:
        plane.index_copy_(0, rows, src)
        return
    num = rows.shape[0]
    wpc = src.shape[1] // num
    code_major = src.reshape(src.shape[0], num, wpc).transpose(0, 1)
    plane.view(plane.shape[0] * num, wpc).index_copy_(
        0, _index(rows, num), code_major.reshape(-1, wpc))


def _per_word(x: torch.Tensor, words: int) -> torch.Tensor:
    """Per-variable values ``x`` [n] or [C, n] as a plane [n, 1] or
    [n, W] (code g's value in its W // C words)."""
    if x.dim() == 1:
        return x[:, None]
    return x.t().repeat_interleave(words // x.shape[0], dim=1)


def _initial_messages(chk_to_var: torch.Tensor, channel: torch.Tensor
                      ) -> torch.Tensor:
    """int32[rows * dc, W]: every socket's first message is its variable's
    channel word (``channel`` with the phantom row for irregular codes,
    which puts 0 on padded sockets)."""
    return _gather(channel, chk_to_var.long().flatten(-2)).contiguous()


# ---------------------------------------------------------------------------
# Check pass
# ---------------------------------------------------------------------------

def _gallager_check_plain(msg: torch.Tensor, dc: int) -> torch.Tensor:
    """Plain version of the check kernel."""
    planes = msg.reshape(-1, dc, msg.shape[1])
    parity = planes[:, 0].clone()
    for j in range(1, dc):
        parity ^= planes[:, j]
    return parity


def gallager_check(msg: torch.Tensor, dc: int) -> torch.Tensor:
    """int32[rows, W]: the XOR of each check's ``dc`` message rows of
    ``msg`` int32[rows * dc, W]."""
    check_int32("msg", msg, 2)
    if dc < 1 or msg.shape[0] % dc:
        raise ValueError(f"{msg.shape[0]} message rows do not split into "
                         f"checks of {dc}")
    if not use_kernel(msg):
        return _gallager_check_plain(msg, dc)
    rows, words = msg.shape[0] // dc, msg.shape[1]
    parity = torch.empty((rows, words), dtype=torch.int32, device=msg.device)
    vec = gallager_round_vector(words, alignment(msg, parity))
    launch("ldpc_gallager_check", msg.device, msg.data_ptr(),
           parity.data_ptr(), rows, dc, words, vec)
    gallager_check.launches += 1
    gallager_check.vec = vec
    return parity


gallager_check.launches = 0
gallager_check.vec = None


# ---------------------------------------------------------------------------
# Variable pass
# ---------------------------------------------------------------------------

def _gallager_variable_plain(msg, parity, channel, var_to_sock, active,
                             decided, counts, *, dc: int, pad_pos: int,
                             threshold: int, clamp: bool, tx=None) -> None:
    """Plain version of the variable kernel, in JAX's bit-sliced form:
    masked disagreement planes, per-variable thresholds selected over the
    candidate counts, majority by the same count."""
    n, words = channel.shape
    num = active.shape[0]
    table = var_to_sock[..., :n, :].long()             # [(C,) n, dv]
    real = table < pad_pos
    dv = table.shape[-1]
    degree = real.sum(-1)
    on = active.bool().repeat_interleave(words // num)[None, :]
    socks = [table[..., p] for p in range(dv)]
    old = [_gather(msg, s) for s in socks]
    masks = [torch.where(_per_word(real[..., p], words), -1, 0)
             .to(torch.int32) for p in range(dv)]
    dis = [(_gather(parity, s // dc) ^ o ^ channel) & mask
           for s, o, mask in zip(socks, old, masks)]
    if clamp:
        t = _per_word(torch.clamp(degree - 1, min=1).clamp(max=threshold),
                      words)
        majority = _per_word(degree // 2 + 1, words)
    else:
        t, majority = threshold, dv // 2 + 1
    changed = torch.zeros(words, dtype=torch.int64, device=msg.device)
    for p in range(dv):
        flip = _flip_at_threshold([dis[l] for l in range(dv) if l != p], t)
        new = torch.where(on, (channel ^ flip) & masks[p], old[p])
        changed += (new != old[p]).sum(0)
        _scatter(msg, socks[p], new)
    dec = torch.where(on, channel ^ _flip_at_threshold(dis, majority),
                      decided)
    errors = popcount(dec if tx is None else dec ^ tx) \
        .sum(0, dtype=torch.int64)
    decided.copy_(dec)
    per_code = torch.stack([errors, changed], 1).reshape(num, -1, 2).sum(1)
    counts += torch.where(active.bool()[:, None], per_code, 0) \
        .to(torch.int32)


def gallager_variable(msg: torch.Tensor, parity: torch.Tensor,
                      channel: torch.Tensor, var_to_sock: torch.Tensor,
                      active: torch.Tensor, decided: torch.Tensor,
                      counts: torch.Tensor, *, dc: int, pad_pos: int,
                      threshold: int, clamp: bool,
                      tx: Optional[torch.Tensor] = None) -> None:
    """One variable pass, in place: new messages into ``msg`` int32[rows
    * dc, W] (socket positions below ``pad_pos`` only), the decision into
    ``decided`` int32[n, W], and ``counts[g] +=`` (decision errors,
    changed message words) of code g, for the codes whose ``active[g]`` is
    nonzero.  ``parity`` is :func:`gallager_check` of ``msg``;
    ``var_to_sock`` is int32[(C,) >= n, dv]; ``active`` int32[C],
    ``counts`` int32[C, 2]; ``clamp`` selects the irregular per-degree
    threshold.  The errors are the decision's set bits, or its bits that
    differ from the transmitted codeword ``tx`` int32[n, W]."""
    for name, t in (("msg", msg), ("parity", parity), ("channel", channel),
                    ("decided", decided), ("counts", counts)):
        check_int32(name, t, 2)
    if tx is not None and (check_int32("tx", tx, 2).shape != channel.shape):
        raise ValueError("tx and channel differ in shape")
    check_int32("active", active, 1)
    n, words = channel.shape
    wpc = _words_per_code("var_to_sock", var_to_sock, words)
    num = words // wpc
    if msg.shape[1] != words or parity.shape[1] != words or \
            decided.shape != channel.shape:
        raise ValueError("msg, parity, channel and decided differ in words")
    if parity.shape[0] * dc != msg.shape[0] or var_to_sock.shape[-2] < n:
        raise ValueError("msg, parity and var_to_sock do not fit together")
    if active.shape[0] != num or counts.shape != (num, 2):
        raise ValueError(f"active and counts must hold {num} codes")
    if not use_kernel(msg, parity, channel, var_to_sock, active, decided,
                      counts, *(() if tx is None else (tx,))):
        _gallager_variable_plain(msg, parity, channel, var_to_sock, active,
                                 decided, counts, dc=dc, pad_pos=pad_pos,
                                 threshold=threshold, clamp=clamp, tx=tx)
        return
    dv = var_to_sock.shape[-1]
    if dv > MAX_DEGREE:
        raise ValueError(f"variable degree {dv} above the kernel's "
                         f"{MAX_DEGREE}")
    vec = gallager_round_vector(wpc, alignment(
        msg, parity, channel, decided, *(() if tx is None else (tx,))), dv)
    launch("ldpc_gallager_variable", msg.device, msg.data_ptr(),
           parity.data_ptr(), channel.data_ptr(), var_to_sock.data_ptr(),
           active.data_ptr(), decided.data_ptr(), counts.data_ptr(),
           None if tx is None else tx.data_ptr(), n, var_to_sock.shape[-2],
           dv, dc, pad_pos, words, wpc, threshold, int(clamp), vec)
    gallager_variable.launches += 1
    gallager_variable.vec = vec


gallager_variable.launches = 0
gallager_variable.vec = None


# ---------------------------------------------------------------------------
# The decode loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Graph:
    """What the two passes read of a code (one, or a batch)."""

    chk_to_var: torch.Tensor    # [(C,) rows, dc]; irregular: rows = m+1
    var_to_sock: torch.Tensor   # [(C,) n or n+1, dv] flat socket positions
    n: int
    dc: int
    pad_pos: int                # socket positions >= this are padding
    irregular: bool             # phantom row, per-degree threshold clamp

    @property
    def num_codes(self) -> int:
        return self.chk_to_var.shape[0] if self.chk_to_var.dim() == 3 else 1

    @property
    def msg_rows(self) -> int:
        """Rows of the soft decoder's message planes: one per check
        socket."""
        return self.chk_to_var.shape[-2] * self.dc

    def syndrome_ok(self, hard: torch.Tensor) -> torch.Tensor:
        """bool[B]: the decisions ``hard`` bool[n, B] satisfy every check
        (JAX ``_syndrome_ok``)."""
        if self.irregular:             # the phantom variable decides 0
            hard = torch.cat([hard, hard.new_zeros((1, hard.shape[1]))])
        table = self.chk_to_var.long()
        parity = _gather(hard, table[..., 0])
        for j in range(1, self.dc):
            parity = parity ^ _gather(hard, table[..., j])
        return ~parity.any(0)

    def check_words(self, words: int) -> None:
        """Raise unless ``words`` split evenly over the codes."""
        _words_per_code("chk_to_var", self.chk_to_var, words)

    def initial_messages(self, _passes, received: torch.Tensor
                         ) -> torch.Tensor:
        return _initial_messages(self.chk_to_var, _pad_phantom_row(received)
                                 if self.irregular else received)

    def run_round(self, passes, msg, received, active, decided, counts,
                  threshold: int, tx) -> None:
        """One flooding round in place: the check pass, then the variable
        pass at ``threshold``."""
        check, variable, _ = passes
        parity = check(msg, self.dc)
        variable(msg, parity, received, self.var_to_sock, active, decided,
                 counts, dc=self.dc, pad_pos=self.pad_pos,
                 threshold=threshold, clamp=self.irregular, tx=tx)


def _graph(code) -> _Graph:
    """The passes' view of a regular or an irregular code (one or a
    batch)."""
    if isinstance(code, IrregularLDPCCode):
        return _Graph(chk_to_var=code.chk_to_var,
                      var_to_sock=code.var_to_sock, n=code.n, dc=code.dc_max,
                      pad_pos=code.m * code.dc_max, irregular=True)
    return _Graph(chk_to_var=code.chk_to_var, var_to_sock=code.var_to_edge,
                  n=code.n, dc=code.dc, pad_pos=code.m * code.dc,
                  irregular=False)


def _round_loop(graph, received: torch.Tensor, max_iters: int,
                threshold_of: Callable[[int], int],
                change_ahead: Callable[[int], bool], per_trial: bool,
                passes, tx: Optional[torch.Tensor]):
    """The host loop over the two passes, per code of a batch (module
    docstring).  Returns the decision (not yet XORed with ``tx``), the
    per-code counts int32[C, max_iters+1] (row 0 the channel's errors, the
    tail after a code's stop its final count), the rounds each code ran
    int32[C], and with ``per_trial`` the per-trial counts of each round."""
    counts_of = passes[2]
    num = graph.num_codes
    device = received.device
    msg = graph.initial_messages(passes, received)
    decided = received.clone()
    channel_err = received if tx is None else received ^ tx
    if per_trial:
        traj = [counts_of(channel_err)]
        current = traj[0].reshape(num, -1).sum(1, dtype=torch.int64)
    else:
        traj = None
        current = popcount(channel_err).sum(0, dtype=torch.int64) \
            .reshape(num, -1).sum(1)
    round_errors = torch.zeros((num, max_iters + 1), dtype=torch.int64,
                               device=device)
    round_errors[:, 0] = current
    rounds = torch.zeros(num, dtype=torch.int32, device=device)
    active = (current > 0).to(torch.int32)
    counts = torch.zeros((num, 2), dtype=torch.int32, device=device)
    it = 0
    while it < max_iters and bool(active.any()):
        counts.zero_()
        graph.run_round(passes, msg, received, active, decided, counts,
                        threshold_of(it), tx)
        ran = active.bool()
        rounds += active
        current = torch.where(ran, counts[:, 0].long(), current)
        round_errors[:, it + 1] = current
        if per_trial:
            traj.append(counts_of(decided if tx is None else decided ^ tx))
        moving = (counts[:, 1] > 0) | change_ahead(it)
        active = (ran & (counts[:, 0] > 0) & moving).to(torch.int32)
        it += 1
    round_errors[:, it + 1:] = current[:, None]
    return decided, round_errors.to(torch.int32), rounds, traj


def _decode_smem_bytes(rows: int, dc: int, wpc: int) -> int:
    """Kernel G's shared memory for one code: its message rows (``rows *
    dc``) and parities (``rows``) of ``wpc`` words, and two counter
    pairs."""
    return (rows * dc + rows) * 4 * wpc + 16


def takes_decode_kernel(graph, record: str, words: int) -> bool:
    """The rule that picks kernel G (:func:`gallager_decode`) for a decode
    of ``words`` words on ``graph``, by shape alone: the generic
    :class:`_Graph` (the quasi-cyclic decoder keeps its own round
    kernels), ``record="total"`` (the expurgated chunks' per-trial counts
    stay with the round kernels), ``dv <= MAX_DEGREE`` and one code's
    messages and parities within one block's shared memory."""
    return (type(graph) is _Graph and record == "total"
            and graph.var_to_sock.shape[-1] <= MAX_DEGREE
            and _decode_smem_bytes(graph.chk_to_var.shape[-2], graph.dc,
                                   words // graph.num_codes)
            <= SMEM_OPTIN_BYTES)


def _gallager_loop(graph, received: torch.Tensor, max_iters: int,
                   threshold_of: Callable[[int], int],
                   change_ahead: Callable[[int], bool], record: str,
                   passes, tx: Optional[torch.Tensor]) -> GallagerResult:
    """The decoders' shared entry: the JAX ``_gallager_loop`` semantics,
    per code of a batch (module docstring).  ``graph`` is a
    :class:`_Graph`, or the quasi-cyclic decoder's counterpart with the
    same ``n``, ``num_codes``, ``check_words``, ``initial_messages`` and
    ``run_round`` (``ops/qc_gallager.py``); ``passes`` are its (check,
    variable, per-trial counts) functions, kernels or plain.  With the
    kernels, the shapes :func:`takes_decode_kernel` accepts run kernel G;
    the rest, and the plain passes, run :func:`_round_loop`."""
    if record not in ("total", "per_trial"):
        raise ValueError(f"unknown record mode {record!r}")
    check_int32("received", received, 2)
    n, words = received.shape
    if n != graph.n:
        raise ValueError(f"received has {n} rows, code n={graph.n}")
    if tx is not None and check_int32("tx_bits", tx, 2).shape != \
            received.shape:
        raise ValueError(f"tx_bits {tuple(tx.shape)} differs from received "
                         f"{tuple(received.shape)}")
    _check_packed_batch_bits(n, words)
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    graph.check_words(words)
    if passes is _KERNEL_PASSES and takes_decode_kernel(graph, record,
                                                        words):
        per_round = [torch.tensor([f(it) for it in range(max_iters)],
                                  dtype=torch.int32, device=received.device)
                     for f in (threshold_of, change_ahead)]
        decided, round_errors, rounds = gallager_decode(
            received, graph.chk_to_var, graph.var_to_sock, *per_round,
            dc=graph.dc, pad_pos=graph.pad_pos, clamp=graph.irregular, tx=tx)
        traj = None
    else:
        decided, round_errors, rounds, traj = _round_loop(
            graph, received, max_iters, threshold_of, change_ahead,
            record == "per_trial", passes, tx)
    decided = decided if tx is None else decided ^ tx
    iterations = int(rounds.max())          # kernel G's one host read
    if record == "total":
        return GallagerResult(decided=decided,
                              error_totals=round_errors.sum(
                                  0, dtype=torch.int32),
                              iterations=iterations)
    traj = torch.stack(traj + [traj[-1]] * (max_iters - iterations))
    return GallagerResult(decided=decided,
                          error_totals=traj.sum(1, dtype=torch.int64)
                          .to(torch.int32),
                          iterations=iterations, traj=traj)


# ---------------------------------------------------------------------------
# Kernel G: the whole decode, one block per code
# ---------------------------------------------------------------------------

def _gallager_decode_plain(received, chk_to_var, var_to_sock, thresholds,
                           change_ahead, *, dc: int, pad_pos: int,
                           clamp: bool, tx=None):
    """Plain version of kernel G, on any device: :func:`_round_loop` over
    the plain passes, with the per-round thresholds and ``change_ahead``
    flags of the arrays."""
    graph = _Graph(chk_to_var=chk_to_var, var_to_sock=var_to_sock,
                   n=received.shape[0], dc=dc, pad_pos=pad_pos,
                   irregular=clamp)
    ts, ahead = thresholds.tolist(), change_ahead.tolist()
    decided, round_errors, rounds, _ = _round_loop(
        graph, received, len(ts), ts.__getitem__,
        lambda it: bool(ahead[it]), False, _PLAIN_PASSES, tx)
    return decided, round_errors, rounds


def gallager_decode(received: torch.Tensor, chk_to_var: torch.Tensor,
                    var_to_sock: torch.Tensor, thresholds: torch.Tensor,
                    change_ahead: torch.Tensor, *, dc: int, pad_pos: int,
                    clamp: bool, tx: Optional[torch.Tensor] = None):
    """Kernel G: the whole Gallager decode of each code of a batch, one
    block per code.  ``received`` int32[n, W] (code g's words ``g * wpc``
    onward), the code tables ``chk_to_var`` int32[(C,) rows, dc] (an
    irregular code's phantom variable is n, its padded sockets read 0) and
    ``var_to_sock`` int32[(C,) >= n, dv] (socket positions >= ``pad_pos``
    are padding); round ``it`` flips at ``thresholds[it]`` (clamped per
    degree with ``clamp``) and goes on after a round without a changed
    message while ``change_ahead[it]`` (both int32[max_iters]).  Errors
    are the decision's set bits, or its bits that differ from ``tx``.

    Returns ``(decided, round_errors, rounds)``: the decision int32[n, W]
    of each code's last round (its channel when it ran none), the errors
    int32[C, max_iters+1] after each round (row 0 the channel's; after a
    code's stop its final count) and the rounds int32[C] each code ran.
    Raises when a code's messages do not fit one block's shared memory."""
    for name, t in (("received", received), ("thresholds", thresholds),
                    ("change_ahead", change_ahead)):
        check_int32(name, t, 1 if name != "received" else 2)
    if tx is not None and check_int32("tx", tx, 2).shape != received.shape:
        raise ValueError("tx and received differ in shape")
    n, words = received.shape
    wpc = _words_per_code("chk_to_var", chk_to_var, words)
    _words_per_code("var_to_sock", var_to_sock, words)
    num = words // wpc
    max_iters = thresholds.shape[0]
    rows, dv = chk_to_var.shape[-2], var_to_sock.shape[-1]
    if change_ahead.shape[0] != max_iters:
        raise ValueError("thresholds and change_ahead differ in length")
    if chk_to_var.shape[-1] != dc or var_to_sock.shape[-2] < n:
        raise ValueError("chk_to_var, var_to_sock and received do not fit "
                         "together")
    if not use_kernel(received, chk_to_var, var_to_sock, thresholds,
                      change_ahead, *(() if tx is None else (tx,))):
        return _gallager_decode_plain(received, chk_to_var, var_to_sock,
                                      thresholds, change_ahead, dc=dc,
                                      pad_pos=pad_pos, clamp=clamp, tx=tx)
    if dv > MAX_DEGREE:
        raise ValueError(f"variable degree {dv} above the kernel's "
                         f"{MAX_DEGREE}")
    need = _decode_smem_bytes(rows, dc, wpc)
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(f"a code needs {need} bytes of shared memory, above "
                         f"one block's {SMEM_OPTIN_BYTES}")
    channel = _plane_to_code_major(received, num)
    tx_cm = None if tx is None else _plane_to_code_major(tx, num)
    decided = torch.empty_like(channel)
    round_errors = torch.empty((num, max_iters + 1), dtype=torch.int32,
                               device=received.device)
    rounds = torch.empty(num, dtype=torch.int32, device=received.device)
    launch("ldpc_gallager_decode", received.device, channel.data_ptr(),
           None if tx_cm is None else tx_cm.data_ptr(), chk_to_var.data_ptr(),
           var_to_sock.data_ptr(), thresholds.data_ptr(),
           change_ahead.data_ptr(), decided.data_ptr(),
           round_errors.data_ptr(), rounds.data_ptr(), num, n, rows, dc,
           var_to_sock.shape[-2], dv, pad_pos, wpc, max_iters, int(clamp))
    gallager_decode.launches += 1
    return _code_major_to_plane(decided, num), round_errors, rounds


gallager_decode.launches = 0


_KERNEL_PASSES = (gallager_check, gallager_variable, per_trial_counts)
_PLAIN_PASSES = (_gallager_check_plain, _gallager_variable_plain,
                 _per_trial_counts_plain)


def _regular(code, received, max_iters, threshold, schedule, record,
             tx_bits, passes) -> GallagerResult:
    dv = code.dv
    if schedule is None:
        # any t <= 0 always flips, any t >= dv never does: clip into int32
        t = min(max(dv - 1 if threshold is None else int(threshold), 0), dv)

        def threshold_of(_it):
            return t

        def change_ahead(_it):
            return False
    else:
        sched = [int(s) for s in torch.as_tensor(schedule).reshape(-1)
                 .tolist()]
        if len(sched) < max_iters:
            raise ValueError(
                f"schedule has {len(sched)} entries but max_iters="
                f"{max_iters}; pass at least max_iters thresholds")
        sched = [min(max(s, 1), dv - 1) for s in sched[:max_iters]]
        # a fixed point under the current threshold is not one of the run
        # while a later entry differs
        ahead = [False] * max_iters
        for i in range(max_iters - 2, -1, -1):
            ahead[i] = ahead[i + 1] or sched[i + 1] != sched[i]

        def threshold_of(it):
            return sched[it]

        def change_ahead(it):
            return ahead[it]
    return _gallager_loop(_graph(code), received, max_iters, threshold_of,
                          change_ahead, record, passes, tx_bits)


def _irregular(code, received, max_iters, threshold, record, tx_bits,
               passes) -> GallagerResult:
    # t_d = min(b, max(d-1, 1)) <= dv_max - 1, so b = dv_max is Gallager-A
    b = code.dv_max if threshold is None else \
        min(max(int(threshold), 0), code.dv_max)
    return _gallager_loop(_graph(code), received, max_iters, lambda _it: b,
                          lambda _it: False, record, passes, tx_bits)


def gallager_decode_packed(code, received: torch.Tensor, max_iters: int,
                           threshold: Optional[int] = None, schedule=None,
                           record: str = "total",
                           tx_bits=None) -> GallagerResult:
    """Decode 32*W BSC trials on a regular code, or on a batch of C codes
    (word w on code ``w // (W // C)``); ``received`` is int32[n, W], set
    bit = the channel flipped the (all-zero) codeword's bit, or, with
    ``tx_bits`` (int32[n, W] packed codewords), the received bits
    themselves, errors then counted against ``tx_bits``.

    ``threshold=None`` is Gallager-A (t = dv-1); smaller t gives
    Gallager-B.  ``schedule`` (>= max_iters ints, clipped into [1, dv-1])
    overrides it with a threshold per round (``utils.theory
    .gallager_b_schedule`` in the JAX package).  ``record="per_trial"``
    also fills ``traj``.  On CUDA tensors the rounds run the two kernels
    (K4 for per-trial counts); on CPU tensors their plain versions.
    """
    return _regular(code, received, max_iters, threshold, schedule, record,
                    tx_bits, _KERNEL_PASSES)


def gallager_decode_packed_plain(code, received: torch.Tensor,
                                 max_iters: int,
                                 threshold: Optional[int] = None,
                                 schedule=None, record: str = "total",
                                 tx_bits=None) -> GallagerResult:
    """:func:`gallager_decode_packed` through the plain version of every
    pass, on any device: the reference the kernels are held to."""
    return _regular(code, received, max_iters, threshold, schedule, record,
                    tx_bits, _PLAIN_PASSES)


def gallager_decode_packed_irregular(code, received: torch.Tensor,
                                     max_iters: int,
                                     threshold: Optional[int] = None,
                                     record: str = "total",
                                     tx_bits=None) -> GallagerResult:
    """Gallager-A/B on an :class:`..models.irregular.IrregularLDPCCode`
    (one or a batch): the contract of :func:`gallager_decode_packed` with
    the per-degree threshold t_d = min(b, max(d-1, 1)) (``threshold=None``:
    max(d-1, 1)) and majority d // 2 + 1."""
    return _irregular(code, received, max_iters, threshold, record, tx_bits,
                      _KERNEL_PASSES)


def gallager_decode_packed_irregular_plain(code, received: torch.Tensor,
                                           max_iters: int,
                                           threshold: Optional[int] = None,
                                           record: str = "total",
                                           tx_bits=None) -> GallagerResult:
    """:func:`gallager_decode_packed_irregular` through the plain passes."""
    return _irregular(code, received, max_iters, threshold, record, tx_bits,
                      _PLAIN_PASSES)
