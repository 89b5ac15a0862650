"""BEC erasure message-passing (BP) decoder.

The JAX package's decoder (``iib_project_ldpc_codes_tpu/ops/
erasure_bp.py``), all-zero-codeword path first:

  * :func:`bp_decode` -- one codeword in the {0,1,2} alphabet, the
    readable oracle, plain torch.
  * :func:`bp_decode_packed_allzero` -- the production path: 32 trials
    per int32 word, batch in the trailing dimension.  One round is the
    check pass :func:`check_exactly_one` (K2, ``csrc/check_exactly_one.cu``)
    and the variable pass :func:`variable_or_update` (K3,
    ``csrc/variable_or_update.cu``), which also counts the erasures left;
    the final per-trial counts are K4 (``ops/bitops.py``).

The fixed-point loop is a host loop that reads one 4-byte count per round
and reproduces the JAX ``while_loop`` (erasure_bp.py:66-110) exactly:
stop when the count is unchanged, zero, or the budget is spent;
``iterations`` counts the last, unchanged round; the error array's tail
holds the final count.

A batch of C codes (ensemble mode) decodes in the same call: the code's
tables carry a leading ``[C]`` axis and word w of the ``[n, W]`` planes
belongs to code ``w // (W // C)``.  One loop over the summed count stays
exact: each code's count never increases, so the sum is unchanged only
when every code's count is unchanged, and on the BEC an unchanged count is
an absorbing fixed point.  ``error_totals`` is then the sum of the JAX
package's per-code (vmapped) arrays, tails included.

The same argument holds for any split of the words into blocks of one
code's words: each word column is an independent decode of 32 trials.
Kernel D, :func:`erasure_decode` (``csrc/erasure_decode.cu``), runs the
decode of each block whole, every round of a block in one CUDA block with
its known plane and its code's check table in shared memory, and returns
the per-block counts; their sum is ``error_totals`` and the host loop's
rule applied to the sum gives ``iterations`` (the "one more" round
included), read once a decode.  :func:`erasure_decode_block_words` picks
it by shape alone: a batch of codes one block a code (the ensemble chunks
at one word a code), one code one block a word (the fixed-code decode,
(3,6) up to n = 12,562), where a block fits the shared memory; the rest,
and quasi-cyclic codes, run K2/K3 (or Q1/Q2).

Irregular codes (:class:`..models.irregular.IrregularLDPCCode`, one or a
batch) decode through the same K2/K3 on a phantom view of their padded
tables (:func:`bp_decode_packed_allzero_irregular`): the planes gain the
phantom variable's row n, never erased, so it never blocks a check, the
phantom check's summary is zero, and K3 counts no erasure for it.

Random-codeword transmit (:func:`bp_decode_packed` and its ``_traj`` and
``_irregular`` forms, JAX erasure_bp.py:239-276, 310-334, 383-409) also
carries the value planes ``val`` (the transmitted bits where known).  The
shapes :func:`erasure_decode_block_words` splits into blocks with
``values=True`` run the value form of kernel D,
:func:`erasure_decode_values` (the val plane beside known in each block's
shared memory: the fixed-code decode, (3,6) up to n = 10,330 a block a
word), the whole decode in one launch and one host read.  The rest, and
the ``_traj`` forms, which count each trial after every round, run a host
loop over the value forms of K2 and K3: the check pass
:func:`check_exactly_one_xor` (``csrc/check_exactly_one.cu``:
exactly_one and exactly_one & xor_known) and the variable pass
:func:`variable_or_adopt` (``csrc/variable_or_update.cu``: known |= OR
exactly_one, val |= OR adopt & ~known, the erasure count).  The ``_traj``
forms add K4's per-trial counts of ~known after every round,
int32[max_iters+1, B], the tail filled with the final counts.  ``known``
evolves as in the all-zero decode, whatever ``val`` holds, so the two
decodes' erasure counts agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch

from ..kernels import alignment, check_int32, l2_bytes, launch, use_kernel
from ..models.code import LDPCCode
from .bitops import _per_trial_counts_plain, per_trial_counts, popcount
from .channels import ERASURE


def _check_packed_batch_bits(n: int, words: int) -> None:
    """The packed decoder's counters are exact int32, so a batch whose
    total bit count reaches 2^31 is out of contract (a worst-case erasure
    count would wrap).  Split such workloads into chunks; the Monte Carlo
    engine accumulates chunk counters in int64 on the host."""
    total = n * words * 32
    if total >= 2 ** 31:
        raise ValueError(
            f"packed batch of {total} total bits (n={n}, words={words}) "
            "exceeds the exact-int32 counter range (2^31); split the "
            "batch into chunks")


def _run_to_fixed_point(step: Callable[[int], int], total0: int,
                        max_iters: int) -> Tuple[List[int], int]:
    """Host loop shared by the decoders of this module.

    ``step(it)`` runs round ``it + 1`` and returns the summed error count
    after it.  Rounds run until the count is unchanged for one round (on
    the BEC the known set only grows, so that IS the fixed point), hits
    zero, or ``max_iters`` is reached.  Returns ``(errors, iterations)``:
    ``errors[t]`` is the count after round t for t <= iterations and the
    final count after it, ``len(errors) == max_iters + 1``.
    """
    errors = [total0]
    it, total, changed = 0, total0, True
    while it < max_iters and changed and total > 0:
        new_total = step(it)
        errors.append(new_total)
        it += 1
        changed = new_total != total
        total = new_total
    errors += [total] * (max_iters - it)
    return errors, it


# ---------------------------------------------------------------------------
# Single-codeword oracle ({0,1,2} alphabet)
# ---------------------------------------------------------------------------

def _bp_iteration(code: LDPCCode, val: torch.Tensor, known: torch.Tensor):
    """One parallel BP round on one codeword: returns (val, known)."""
    row_val = val[code.chk_to_var.long()]               # [m, dc]
    row_kn = known[code.chk_to_var.long()].to(torch.int32)
    cnt = row_kn.sum(dim=1, keepdim=True)
    masked = row_val & row_kn
    xor_all = masked.sum(dim=1, keepdim=True) & 1        # XOR of 0/1 values
    others_known = (cnt - row_kn) == (code.dc - 1)       # [m, dc]
    mcv_val = xor_all ^ masked                           # extrinsic XOR
    edges = code.var_to_edge.long()
    e_valid = others_known.reshape(-1)[edges]            # [n, dv]
    e_val = mcv_val.reshape(-1)[edges]
    any_valid = e_valid.any(dim=1)
    adopt = (e_valid & (e_val == 1)).any(dim=1).to(val.dtype)
    new_known = known | any_valid
    new_val = torch.where(known, val, adopt * any_valid.to(val.dtype))
    return new_val, new_known


def bp_decode(code: LDPCCode, channel_output: torch.Tensor, max_iters: int
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Decode one codeword in the {0,1,2} wire format.

    Returns ``(decoded, errors, iterations)``: ``decoded`` in {0,1,2}
    (2 = still erased), ``errors`` int32[max_iters + 1] with the initial
    erasure count first, ``iterations`` the rounds computed.
    """
    channel_output = channel_output.to(torch.int32)
    known = channel_output != ERASURE
    val = torch.where(known, channel_output, 0)

    def step(_it: int) -> int:
        nonlocal val, known
        val, known = _bp_iteration(code, val, known)
        return int((~known).sum())

    errors, it = _run_to_fixed_point(step, int((~known).sum()), max_iters)
    decoded = torch.where(known, val, ERASURE)
    return decoded, torch.tensor(errors, dtype=torch.int32), it


# ---------------------------------------------------------------------------
# Packed all-zero path: K2 (check pass) and K3 (variable pass)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedBPResult:
    """Result of a packed batch decode of B = 32*W trials."""

    known: torch.Tensor         # int32[n, W] resolved mask
    error_totals: torch.Tensor  # int32[max_iters+1] erased bits, whole batch
    # rounds computed before the fixed point; for a batch of codes the
    # largest per-code count, or one more when the last code to move
    # reached zero erasures (the summed count then needs one unchanged
    # round to stop)
    iterations: int
    # int32[n, W] decoded bit planes (valid where known); None for the
    # all-zero decode, whose values are the all-zero plane
    val: Optional[torch.Tensor] = None

    @property
    def bit_errors(self) -> torch.Tensor:
        """int32[B]: unresolved erasures per trial (K4 on ~known)."""
        return per_trial_counts(~self.known)

    @property
    def failed(self) -> torch.Tensor:
        """bool[B]: trials with at least one unresolved erasure."""
        return self.bit_errors > 0


def _words_per_code(name: str, table, words: int) -> int:
    """Check a code table, int32[rows, k] for one code or [C, rows, k]
    for a batch, and return the words per code of a ``words``-word
    plane."""
    rank = 3 if isinstance(table, torch.Tensor) and table.dim() == 3 else 2
    check_int32(name, table, rank)
    num = table.shape[0] if rank == 3 else 1
    if num == 0 or words % num:
        raise ValueError(f"{words} words do not split evenly over {num} "
                         "codes")
    return words // num


def _gather_rows(plane: torch.Tensor, table: torch.Tensor, j: int
                 ) -> torch.Tensor:
    """Rows ``table[g, :, j]`` of code g's words of ``plane`` [rows, W],
    for every code g at once: int32[C * table rows, W // C] (code-major).
    One code is the plain ``index_select`` of the whole rows."""
    if table.dim() == 2:
        return plane.index_select(0, table[:, j])
    num = table.shape[0]
    rows = plane.reshape(plane.shape[0] * num, -1)     # row r, code g -> r*C+g
    codes = torch.arange(num, dtype=torch.int32, device=table.device)
    return rows.index_select(0, (table[:, :, j] * num
                                 + codes[:, None]).reshape(-1))


def _code_major_to_plane(x: torch.Tensor, num: int) -> torch.Tensor:
    """Inverse of :func:`_gather_rows`' layout: [C * rows, wpc] ->
    [rows, C * wpc]."""
    if num == 1:
        return x
    return x.reshape(num, -1, x.shape[1]).transpose(0, 1).contiguous() \
        .reshape(x.shape[0] // num, -1)


def _plane_to_code_major(x: torch.Tensor, num: int) -> torch.Tensor:
    """[n, C * wpc] -> [C * n, wpc]: each code's words contiguous (the
    inverse of :func:`_code_major_to_plane`)."""
    if num == 1:
        return x
    n, words = x.shape
    return x.reshape(n, num, words // num).transpose(0, 1).contiguous() \
        .reshape(num * n, -1)


def _check_exactly_one_plain(chk_to_var: torch.Tensor,
                             known: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the JAX package's per-socket prefix/suffix
    form (erasure_bp.py:203-220), per code of a batch."""
    dc = chk_to_var.shape[-1]
    kns = [_gather_rows(known, chk_to_var, j) for j in range(dc)]
    full = torch.full_like(kns[0], -1)
    pre = [full]
    for j in range(dc - 1):
        pre.append(pre[-1] & kns[j])
    suf = [full]
    for j in range(dc - 1, 0, -1):
        suf.append(suf[-1] & kns[j])
    suf.reverse()
    exactly_one = torch.zeros_like(kns[0])
    for j in range(dc):
        exactly_one |= ~kns[j] & pre[j] & suf[j]
    num = chk_to_var.shape[0] if chk_to_var.dim() == 3 else 1
    return _code_major_to_plane(exactly_one, num)


def check_exactly_one_vector(wpc: int, align: int) -> int:
    """Words a thread of K2 and K3 (and of X1, ``wpc`` = W) moves: 4 (16
    bytes) when a code's ``wpc`` words are a multiple of 4 (a thread's
    words belong to one code) and ``align`` (the largest power of two up
    to 16 dividing every plane's address) is 16, else 1."""
    return 4 if wpc % 4 == 0 and align % 16 == 0 else 1


def check_exactly_one(chk_to_var: torch.Tensor,
                      known: torch.Tensor) -> torch.Tensor:
    """int32[m, W]: per check and trial, whether exactly one of the dc
    participants is still unknown (``known`` int32[n, W]).  ``chk_to_var``
    is one code's int32[m, dc] table or a batch's int32[C, m, dc], word w
    then belonging to code ``w // (W // C)``.  The table's entries must
    lie in [0, n), as :func:`..models.code.code_from_checks` ensures.  The
    wrapper keeps its last launch's words a thread in ``.vec``."""
    check_int32("known", known, 2)
    words = known.shape[1]
    wpc = _words_per_code("chk_to_var", chk_to_var, words)
    if not use_kernel(chk_to_var, known):
        return _check_exactly_one_plain(chk_to_var, known)
    m, dc = chk_to_var.shape[-2:]
    out = torch.empty((m, words), dtype=torch.int32, device=known.device)
    vec = check_exactly_one_vector(wpc, alignment(known, out))
    launch("ldpc_check_exactly_one", known.device, known.data_ptr(),
           chk_to_var.data_ptr(), out.data_ptr(), known.shape[0], m, dc,
           words, wpc, vec)
    check_exactly_one.launches += 1
    check_exactly_one.vec = vec
    return out


check_exactly_one.launches = 0
check_exactly_one.vec = None


def _or_by_variable(var_to_chk: torch.Tensor,
                    exactly_one: torch.Tensor) -> torch.Tensor:
    """int32[n, W]: ``OR_j exactly_one[var_to_chk[:, j]]`` per code of a
    batch (erasure_bp.py:231-236)."""
    acc = _gather_rows(exactly_one, var_to_chk, 0)
    for j in range(1, var_to_chk.shape[-1]):
        acc |= _gather_rows(exactly_one, var_to_chk, j)
    num = var_to_chk.shape[0] if var_to_chk.dim() == 3 else 1
    return _code_major_to_plane(acc, num)


def _variable_or_update_plain(var_to_chk: torch.Tensor,
                              exactly_one: torch.Tensor, known: torch.Tensor,
                              errors: torch.Tensor, slot: int) -> None:
    """Plain version of K3 (erasure_bp.py:231-236, 279-288), per code of
    a batch."""
    known |= _or_by_variable(var_to_chk, exactly_one)
    errors[slot] = popcount(~known).sum(dtype=torch.int64).to(torch.int32)


def variable_or_update(var_to_chk: torch.Tensor, exactly_one: torch.Tensor,
                       known: torch.Tensor, errors: torch.Tensor,
                       slot: int) -> None:
    """``known |= OR_j exactly_one[var_to_chk[:, j]]`` in place, and
    ``errors[slot]`` = erasures left in ``known`` (``errors[slot]`` must
    be 0 on entry).  ``var_to_chk`` is int32[n, dv] or a batch's
    int32[C, n, dv], as in :func:`check_exactly_one`.  The wrapper keeps
    its last launch's words a thread (:func:`check_exactly_one_vector`)
    in ``.vec``."""
    check_int32("known", known, 2)
    check_int32("exactly_one", exactly_one, 2)
    check_int32("errors", errors, 1)
    wpc = _words_per_code("var_to_chk", var_to_chk, known.shape[1])
    if exactly_one.shape[1] != known.shape[1]:
        raise ValueError("exactly_one and known differ in words")
    if var_to_chk.shape[-2] != known.shape[0]:
        raise ValueError("var_to_chk and known differ in rows")
    if not 0 <= slot < errors.shape[0]:
        raise ValueError(f"slot {slot} outside errors[{errors.shape[0]}]")
    if not use_kernel(var_to_chk, exactly_one, known, errors):
        _variable_or_update_plain(var_to_chk, exactly_one, known, errors,
                                  slot)
        return
    n, dv = var_to_chk.shape[-2:]
    vec = check_exactly_one_vector(wpc, alignment(known, exactly_one))
    launch("ldpc_variable_or_update", known.device, known.data_ptr(),
           exactly_one.data_ptr(), var_to_chk.data_ptr(),
           errors[slot:].data_ptr(), n, exactly_one.shape[0], dv,
           known.shape[1], wpc, vec)
    variable_or_update.launches += 1
    variable_or_update.vec = vec


variable_or_update.launches = 0
variable_or_update.vec = None


# ---------------------------------------------------------------------------
# Kernel D: the whole all-zero decode, one block per block of a code's words
# ---------------------------------------------------------------------------

#: dynamic shared memory one block may opt into on the kernels' only
#: target, sm_90 (Hopper: 227 KB of the SM's 256 KB)
SMEM_OPTIN_BYTES = 232_448


def _erasure_decode_smem_bytes(rows: int, checks: int, dc: int,
                               wpb: int, values: bool = False) -> int:
    """Kernel D's shared memory for a block of ``wpb`` words: its known
    plane (and with ``values`` its val plane) and its exactly-one plane,
    four counters, its code's chk_to_var table (int32) and the scatter's
    socket masks (a byte per check and word)."""
    return ((2 if values else 1) * rows + checks) * wpb * 4 + 16 \
        + checks * dc * 4 + checks * wpb


def erasure_decode_block_words(code, words: int,
                               values: bool = False) -> int:
    """The rule that picks kernel D for the packed decode of ``words``
    words on ``code`` (:func:`erasure_decode`, or with ``values`` the
    random-transmit decode's :func:`erasure_decode_values`), by shape
    alone: the words of a block, or 0 where the host loop over the round
    kernels runs (K2/K3, or check_exactly_one_xor / variable_or_adopt).  D
    takes the generic tables (an :class:`LDPCCode` or an irregular code's
    phantom view; quasi-cyclic codes keep their circulant-index rounds): a
    batch of codes (a leading [C] axis, the words split evenly) one block a
    code, one code one block a word; a block's shared memory must fit one
    block's."""
    if not isinstance(code, (LDPCCode, _PhantomView)) or words < 1:
        return 0
    if code.chk_to_var.dim() == 3:
        num = code.chk_to_var.shape[0]
        if words % num:
            return 0
        wpb = words // num
    else:
        wpb = 1
    checks, dc = code.chk_to_var.shape[-2:]
    fits = _erasure_decode_smem_bytes(code.n, checks, dc, wpb, values) \
        <= SMEM_OPTIN_BYTES
    return wpb if fits else 0


def takes_erasure_decode_kernel(code, words: int,
                                values: bool = False) -> bool:
    """True when :func:`erasure_decode_block_words` sends the decode to
    kernel D."""
    return erasure_decode_block_words(code, words, values) > 0


def _erasure_decode_values_plain(erased: torch.Tensor,
                                 tx: Optional[torch.Tensor],
                                 chk_to_var: torch.Tensor,
                                 var_to_chk: torch.Tensor, max_iters: int,
                                 wpb: Optional[int] = None):
    """Plain version of kernel D's value form
    (:func:`erasure_decode_values`) and, with ``tx`` None, of its all-zero
    form, on any device: the batched plain passes (the value passes with
    ``tx``) with a count and a stop per block of ``wpb`` words (default: a
    code's words; a stopped block's words are frozen), no loop over
    blocks.  Returns ``(known, val or None, round_errors, rounds)``."""
    if wpb is None:
        wpb = erased.shape[1] // chk_to_var.shape[0]
    blocks = erased.shape[1] // wpb
    if chk_to_var.shape[0] == 1:           # one code: the passes' 2-D form
        chk_to_var, var_to_chk = chk_to_var[0], var_to_chk[0]

    def per_block(known):
        return popcount(~known).sum(0, dtype=torch.int64) \
            .reshape(blocks, wpb).sum(1)

    known = ~erased
    val = None if tx is None else tx & known
    current = per_block(known)
    round_errors = torch.empty((blocks, max_iters + 1), dtype=torch.int64,
                               device=erased.device)
    round_errors[:, 0] = current
    rounds = torch.zeros(blocks, dtype=torch.int32, device=erased.device)
    active = current > 0
    it = 0
    while it < max_iters and bool(active.any()):
        moving = active.repeat_interleave(wpb)[None, :]
        if val is None:
            exactly_one = _check_exactly_one_plain(chk_to_var, known)
        else:
            exactly_one, adopt = _check_exactly_one_xor_plain(chk_to_var,
                                                              known, val)
            val = torch.where(moving, val | (
                _or_by_variable(var_to_chk, adopt) & ~known), val)
        known = torch.where(moving, known | _or_by_variable(
            var_to_chk, exactly_one), known)
        new = per_block(known)
        rounds += active.to(torch.int32)
        round_errors[:, it + 1] = new
        active &= (new != current) & (new > 0)
        current = new
        it += 1
    round_errors[:, it + 1:] = current[:, None]
    return known, val, round_errors.to(torch.int32), rounds


def _erasure_decode_plain(erased: torch.Tensor, chk_to_var: torch.Tensor,
                          var_to_chk: torch.Tensor, max_iters: int,
                          wpb: Optional[int] = None):
    """Plain version of kernel D (:func:`erasure_decode`)."""
    known, _, round_errors, rounds = _erasure_decode_values_plain(
        erased, None, chk_to_var, var_to_chk, max_iters, wpb)
    return known, round_errors, rounds


def _check_decode_args(erased: torch.Tensor, chk_to_var: torch.Tensor,
                       var_to_chk: torch.Tensor, max_iters: int,
                       wpb: Optional[int]) -> int:
    """Check kernel D's arguments (either form); returns ``wpb``."""
    check_int32("erased", erased, 2)
    check_int32("chk_to_var", chk_to_var, 3)
    check_int32("var_to_chk", var_to_chk, 3)
    rows, words = erased.shape
    wpc = _words_per_code("chk_to_var", chk_to_var, words)
    if var_to_chk.shape[:2] != (chk_to_var.shape[0], rows):
        raise ValueError("chk_to_var, var_to_chk and erased do not fit "
                         "together")
    wpb = wpc if wpb is None else wpb
    if wpb < 1 or wpc % wpb:
        raise ValueError(f"blocks of {wpb} words do not split a code's "
                         f"{wpc} words")
    _check_packed_batch_bits(rows, words)
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    return wpb


def _check_decode_smem(erased: torch.Tensor, chk_to_var: torch.Tensor,
                       wpb: int, values: bool) -> None:
    need = _erasure_decode_smem_bytes(erased.shape[0], *chk_to_var.shape[1:],
                                      wpb, values)
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(f"a block needs {need} bytes of shared memory, "
                         f"above one block's {SMEM_OPTIN_BYTES}")


def erasure_decode(erased: torch.Tensor, chk_to_var: torch.Tensor,
                   var_to_chk: torch.Tensor, max_iters: int,
                   wpb: Optional[int] = None):
    """Kernel D: the whole all-zero decode of each block of ``wpb`` words
    (default: a code's words), one CUDA block each.  ``erased`` int32[n,
    W] (code g's words ``g * wpc`` onward), the tables ``chk_to_var``
    int32[C, m, dc] and ``var_to_chk`` int32[C, n, dv] of one graph (an
    irregular code's phantom view; C = 1 for one code); ``wpb`` divides
    ``wpc`` = W / C, and block b decodes words ``b * wpb`` onward.

    Returns ``(known, round_errors, rounds)``: the final known plane
    int32[n, W], the erasures int32[W / wpb, max_iters+1] after each round
    (row 0 the channel's; after a block's stop its final count) and the
    rounds int32[W / wpb] each block ran, by the stop rule of
    :func:`_run_to_fixed_point` per block.  The kernel scatters each
    check's summary into its sockets and reads no ``var_to_chk`` (the
    plain version does): both tables must describe the same graph.  Raises
    when a block does not fit one block's shared memory."""
    wpb = _check_decode_args(erased, chk_to_var, var_to_chk, max_iters, wpb)
    if not use_kernel(erased, chk_to_var, var_to_chk):
        return _erasure_decode_plain(erased, chk_to_var, var_to_chk,
                                     max_iters, wpb)
    _check_decode_smem(erased, chk_to_var, wpb, False)
    rows, words = erased.shape
    blocks = words // wpb
    planes = _plane_to_code_major(erased, blocks)
    known = torch.empty_like(planes)
    round_errors = torch.empty((blocks, max_iters + 1), dtype=torch.int32,
                               device=erased.device)
    rounds = torch.empty(blocks, dtype=torch.int32, device=erased.device)
    launch("ldpc_erasure_decode", erased.device, planes.data_ptr(),
           chk_to_var.data_ptr(), known.data_ptr(), round_errors.data_ptr(),
           rounds.data_ptr(), blocks, rows, *chk_to_var.shape[1:],
           words // chk_to_var.shape[0], wpb, max_iters)
    erasure_decode.launches += 1
    return _code_major_to_plane(known, blocks), round_errors, rounds


erasure_decode.launches = 0


def erasure_decode_values(erased: torch.Tensor, tx: torch.Tensor,
                          chk_to_var: torch.Tensor, var_to_chk: torch.Tensor,
                          max_iters: int, wpb: Optional[int] = None):
    """Kernel D's value form: the whole random-transmit decode
    (:func:`bp_decode_packed`'s rounds) of each block of ``wpb`` words,
    one CUDA block each.  ``tx`` int32[n, W] holds the transmitted planes
    (any bits: the decode adopts what the checks' known values imply,
    codeword or not); the rest as :func:`erasure_decode`.

    Returns ``(known, val, round_errors, rounds)``: the final known and
    value planes int32[n, W] (val is ``tx & known`` grown by the adopted
    bits, 0 where unknown) and the per-block counts and rounds of
    :func:`erasure_decode`.  Raises when a block does not fit one block's
    shared memory."""
    wpb = _check_decode_args(erased, chk_to_var, var_to_chk, max_iters, wpb)
    check_int32("tx", tx, 2)
    if tx.shape != erased.shape:
        raise ValueError(f"tx {tuple(tx.shape)} and erased "
                         f"{tuple(erased.shape)} differ in shape")
    if not use_kernel(erased, tx, chk_to_var, var_to_chk):
        return _erasure_decode_values_plain(erased, tx, chk_to_var,
                                            var_to_chk, max_iters, wpb)
    _check_decode_smem(erased, chk_to_var, wpb, True)
    rows, words = erased.shape
    blocks = words // wpb
    planes = _plane_to_code_major(erased, blocks)
    tx_planes = _plane_to_code_major(tx, blocks)
    known, val = torch.empty_like(planes), torch.empty_like(planes)
    round_errors = torch.empty((blocks, max_iters + 1), dtype=torch.int32,
                               device=erased.device)
    rounds = torch.empty(blocks, dtype=torch.int32, device=erased.device)
    launch("ldpc_erasure_decode_values", erased.device, planes.data_ptr(),
           tx_planes.data_ptr(), chk_to_var.data_ptr(), known.data_ptr(),
           val.data_ptr(), round_errors.data_ptr(), rounds.data_ptr(),
           blocks, rows, *chk_to_var.shape[1:],
           words // chk_to_var.shape[0], wpb, max_iters)
    erasure_decode_values.launches += 1
    return (_code_major_to_plane(known, blocks),
            _code_major_to_plane(val, blocks), round_errors, rounds)


erasure_decode_values.launches = 0


def _block_totals(round_errors: torch.Tensor, max_iters: int
                  ) -> Tuple[torch.Tensor, int]:
    """``(error_totals, iterations)`` of a decode split into blocks: the
    sum of the blocks' counts, and the host loop's rule applied to the
    sum (module docstring), read once."""
    sums = round_errors.sum(0, dtype=torch.int64).tolist()
    totals, it = _run_to_fixed_point(lambda t: sums[t + 1], sums[0],
                                     max_iters)
    return torch.tensor(totals, dtype=torch.int32,
                        device=round_errors.device), it


def _batch_tables(code) -> Tuple[torch.Tensor, torch.Tensor]:
    """The code's tables with the leading [C] axis kernel D takes (one
    code: a batch of one)."""
    chk, var = code.chk_to_var, code.var_to_chk
    if chk.dim() == 2:
        chk, var = chk[None], var[None]
    return chk, var


def _decode_allzero(code: LDPCCode, erased: torch.Tensor, max_iters: int,
                    check, variable, counts,
                    whole: Optional[Callable] = None) -> PackedBPResult:
    """The packed all-zero decode, parametrised by its three passes and
    the whole decode ``whole`` (:func:`erasure_decode`), which runs the
    shapes :func:`erasure_decode_block_words` gives a block split: the
    error totals are then the sum of its per-block counts and
    ``iterations`` follows from them by the host loop's rule (module
    docstring), read once.  The rest, and every decode without ``whole``,
    run the host loop over the passes."""
    check_int32("erased", erased, 2)
    if erased.shape[0] != code.n:
        raise ValueError(f"erased has {erased.shape[0]} rows, code n={code.n}")
    _check_packed_batch_bits(code.n, erased.shape[1])
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    wpb = erasure_decode_block_words(code, erased.shape[1]) \
        if whole is not None else 0
    if wpb:
        known, round_errors, _ = whole(erased, *_batch_tables(code),
                                       max_iters, wpb)
        totals, it = _block_totals(round_errors, max_iters)
        return PackedBPResult(known=known, error_totals=totals,
                              iterations=it)
    known = ~erased
    total0 = int(counts(erased).sum(dtype=torch.int64))
    errors = torch.zeros(max_iters + 1, dtype=torch.int32,
                         device=erased.device)

    def step(it: int) -> int:
        exactly_one = check(code.chk_to_var, known)
        variable(code.var_to_chk, exactly_one, known, errors, it + 1)
        return int(errors[it + 1])

    totals, it = _run_to_fixed_point(step, total0, max_iters)
    return PackedBPResult(
        known=known,
        error_totals=torch.tensor(totals, dtype=torch.int32,
                                  device=erased.device),
        iterations=it)


def bp_decode_packed_allzero(code: LDPCCode, erased: torch.Tensor,
                             max_iters: int) -> PackedBPResult:
    """Decode 32*W all-zero-codeword trials at once on one code, or on a
    batch of C codes (word w on code ``w // (W // C)``).

    ``erased`` is int32[n, W] (1 = erased), e.g. from
    :func:`..channels.bec_packed_channel`.  On CUDA tensors the shapes
    :func:`erasure_decode_block_words` splits into blocks (a batch whose
    codes each fit one block, one code whose word fits one) run kernel D,
    the whole decode in one launch; the rest run the host loop over
    hand-written passes (K4 for the initial count, K2 and K3 per round).
    On CPU tensors their plain versions run, by the same rule.
    """
    return _decode_allzero(code, erased, max_iters, check_exactly_one,
                           variable_or_update, per_trial_counts,
                           erasure_decode)


def bp_decode_packed_allzero_plain(code: LDPCCode, erased: torch.Tensor,
                                   max_iters: int) -> PackedBPResult:
    """:func:`bp_decode_packed_allzero` through the plain PyTorch version
    of every pass, on any device: the reference the kernels are held to."""
    return _decode_allzero(code, erased, max_iters, _check_exactly_one_plain,
                           _variable_or_update_plain,
                           _per_trial_counts_plain)


# ---------------------------------------------------------------------------
# Packed value-plane path (random-codeword transmit): K2's and K3's value
# forms
# ---------------------------------------------------------------------------

#: the least words of a column tile of the value round's grid: a row's
#: slice of a tile fills a 128-byte line
VALUE_TILE_MIN_WORDS = 32


@functools.lru_cache(maxsize=None)
def value_round_tile(rows: int, words: int, cache_bytes: int) -> int:
    """Words of a column tile of the value round's grid (the value forms of
    K2 and K3 take the row grid tile after tile): W itself where the two
    planes the check pass gathers (``rows`` x ``words`` words each, known
    and val) fit a third of ``cache_bytes`` (the card's L2), else the
    largest divisor of W that is a multiple of 8 words (so of either N), at
    least :data:`VALUE_TILE_MIN_WORDS`, whose slices of both planes fit a
    third of it; W where there is none.  The variable pass takes the same
    tile."""
    budget = cache_bytes // 3
    if 2 * rows * words * 4 <= budget:
        return words
    fits = [t for t in range(VALUE_TILE_MIN_WORDS, words, 8)
            if words % t == 0 and 2 * rows * t * 4 <= budget]
    return max(fits, default=words)


def _value_round_launch(wpc: int, *planes) -> Tuple[int, int]:
    """The value round's (vec, tile) on the CUDA ``planes`` (known
    first)."""
    known = planes[0]
    return (check_exactly_one_vector(wpc, alignment(*planes)),
            value_round_tile(*known.shape, l2_bytes(known.device.index)))


def _check_exactly_one_xor_plain(chk_to_var: torch.Tensor,
                                 known: torch.Tensor, val: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`check_exactly_one_xor`: JAX's per-socket
    form (erasure_bp.py:203-228), per code of a batch."""
    exactly_one = _check_exactly_one_plain(chk_to_var, known)
    xor_known = torch.zeros_like(exactly_one)
    num = chk_to_var.shape[0] if chk_to_var.dim() == 3 else 1
    for j in range(chk_to_var.shape[-1]):
        xor_known ^= _code_major_to_plane(
            _gather_rows(val & known, chk_to_var, j), num)
    return exactly_one, exactly_one & xor_known


def check_exactly_one_xor(chk_to_var: torch.Tensor, known: torch.Tensor,
                          val: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exactly_one, adopt), each int32[m, W]: per check and trial,
    whether exactly one participant is unknown, and that bit AND the XOR
    of the known participants' values (the value the unknown one must
    take).  Tables and batches as :func:`check_exactly_one`; the kernel
    is K2's value form (``csrc/check_exactly_one.cu``), whose words a
    thread (:func:`check_exactly_one_vector` over all four planes) and
    column tile (:func:`value_round_tile`) the wrapper keeps in ``.vec``
    and ``.tile``."""
    check_int32("known", known, 2)
    check_int32("val", val, 2)
    if val.shape != known.shape:
        raise ValueError("val and known differ in shape")
    wpc = _words_per_code("chk_to_var", chk_to_var, known.shape[1])
    if not use_kernel(chk_to_var, known, val):
        return _check_exactly_one_xor_plain(chk_to_var, known, val)
    m, dc = chk_to_var.shape[-2:]
    words = known.shape[1]
    exactly_one = torch.empty((m, words), dtype=torch.int32,
                              device=known.device)
    adopt = torch.empty_like(exactly_one)
    vec, tile = _value_round_launch(wpc, known, val, exactly_one, adopt)
    launch("ldpc_check_exactly_one_xor", known.device, known.data_ptr(),
           val.data_ptr(), chk_to_var.data_ptr(), exactly_one.data_ptr(),
           adopt.data_ptr(), known.shape[0], m, dc, words, wpc, vec, tile)
    check_exactly_one_xor.launches += 1
    check_exactly_one_xor.vec, check_exactly_one_xor.tile = vec, tile
    return exactly_one, adopt


check_exactly_one_xor.launches = 0
check_exactly_one_xor.vec = check_exactly_one_xor.tile = None


def _variable_or_adopt_plain(var_to_chk: torch.Tensor,
                             exactly_one: torch.Tensor, adopt: torch.Tensor,
                             known: torch.Tensor, val: torch.Tensor,
                             errors: torch.Tensor, slot: int) -> None:
    """Plain version of :func:`variable_or_adopt` (JAX erasure_bp.py:231-248),
    per code of a batch."""
    num = var_to_chk.shape[0] if var_to_chk.dim() == 3 else 1
    taken = _gather_rows(adopt, var_to_chk, 0)
    for j in range(1, var_to_chk.shape[-1]):
        taken |= _gather_rows(adopt, var_to_chk, j)
    val |= _code_major_to_plane(taken, num) & ~known
    _variable_or_update_plain(var_to_chk, exactly_one, known, errors, slot)


def variable_or_adopt(var_to_chk: torch.Tensor, exactly_one: torch.Tensor,
                      adopt: torch.Tensor, known: torch.Tensor,
                      val: torch.Tensor, errors: torch.Tensor,
                      slot: int) -> None:
    """In place: ``val |= OR_j adopt[var_to_chk[:, j]] & ~known``, then
    ``known |= OR_j exactly_one[var_to_chk[:, j]]``, and ``errors[slot]``
    = erasures left (``errors[slot]`` must be 0 on entry).  Tables and
    batches as :func:`variable_or_update`; the kernel is K3's value form
    (``csrc/variable_or_update.cu``), whose words a thread and column tile
    (as :func:`check_exactly_one_xor`'s) the wrapper keeps in ``.vec`` and
    ``.tile``."""
    for name, t in (("known", known), ("val", val),
                    ("exactly_one", exactly_one), ("adopt", adopt)):
        check_int32(name, t, 2)
    check_int32("errors", errors, 1)
    wpc = _words_per_code("var_to_chk", var_to_chk, known.shape[1])
    if val.shape != known.shape or adopt.shape != exactly_one.shape or \
            exactly_one.shape[1] != known.shape[1]:
        raise ValueError("known, val, exactly_one and adopt do not fit "
                         "together")
    if var_to_chk.shape[-2] != known.shape[0]:
        raise ValueError("var_to_chk and known differ in rows")
    if not 0 <= slot < errors.shape[0]:
        raise ValueError(f"slot {slot} outside errors[{errors.shape[0]}]")
    if not use_kernel(var_to_chk, exactly_one, adopt, known, val, errors):
        _variable_or_adopt_plain(var_to_chk, exactly_one, adopt, known, val,
                                 errors, slot)
        return
    n, dv = var_to_chk.shape[-2:]
    vec, tile = _value_round_launch(wpc, known, val, exactly_one, adopt)
    launch("ldpc_variable_or_adopt", known.device, known.data_ptr(),
           val.data_ptr(), exactly_one.data_ptr(), adopt.data_ptr(),
           var_to_chk.data_ptr(), errors[slot:].data_ptr(), n,
           exactly_one.shape[0], dv, known.shape[1], wpc, vec, tile)
    variable_or_adopt.launches += 1
    variable_or_adopt.vec, variable_or_adopt.tile = vec, tile


variable_or_adopt.launches = 0
variable_or_adopt.vec = variable_or_adopt.tile = None


def _decode_values(code, erased: torch.Tensor, tx_bits: torch.Tensor,
                   max_iters: int, passes, traj: bool,
                   whole: Optional[Callable] = None):
    """The packed value-plane decode, parametrised by its passes (check,
    variable, counts) and the whole decode ``whole``
    (:func:`erasure_decode_values`), which runs the shapes
    :func:`erasure_decode_block_words` gives a block split with
    ``values=True`` when no trajectory is asked for (as
    :func:`_decode_allzero`); the rest run the host loop over the passes.
    Returns ``(PackedBPResult, traj or None)``."""
    check, variable, counts = passes
    check_int32("erased", erased, 2)
    check_int32("tx_bits", tx_bits, 2)
    if erased.shape[0] != code.n or tx_bits.shape != erased.shape:
        raise ValueError(f"erased {tuple(erased.shape)} and tx_bits "
                         f"{tuple(tx_bits.shape)} must be [n={code.n}, W]")
    _check_packed_batch_bits(code.n, erased.shape[1])
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    wpb = erasure_decode_block_words(code, erased.shape[1], values=True) \
        if whole is not None and not traj else 0
    if wpb:
        known, val, round_errors, _ = whole(erased, tx_bits,
                                            *_batch_tables(code), max_iters,
                                            wpb)
        totals, it = _block_totals(round_errors, max_iters)
        return PackedBPResult(known=known, val=val, error_totals=totals,
                              iterations=it), None
    known = ~erased
    val = tx_bits & known
    counts0 = counts(erased)
    rows = [counts0] if traj else None
    total0 = int(counts0.sum(dtype=torch.int64))
    errors = torch.zeros(max_iters + 1, dtype=torch.int32,
                         device=erased.device)

    def step(it: int) -> int:
        exactly_one, adopt = check(code.chk_to_var, known, val)
        variable(code.var_to_chk, exactly_one, adopt, known, val, errors,
                 it + 1)
        if traj:
            rows.append(counts(~known))
        return int(errors[it + 1])

    totals, it = _run_to_fixed_point(step, total0, max_iters)
    res = PackedBPResult(
        known=known, val=val,
        error_totals=torch.tensor(totals, dtype=torch.int32,
                                  device=erased.device),
        iterations=it)
    if not traj:
        return res, None
    return res, torch.stack(rows + [rows[-1]] * (max_iters - it))


_VALUE_KERNELS = (check_exactly_one_xor, variable_or_adopt, per_trial_counts)
_VALUE_PLAIN = (_check_exactly_one_xor_plain, _variable_or_adopt_plain,
                _per_trial_counts_plain)


def bp_decode_packed(code: LDPCCode, erased: torch.Tensor,
                     tx_bits: torch.Tensor, max_iters: int
                     ) -> PackedBPResult:
    """Decode 32*W trials of the transmitted planes ``tx_bits`` int32[n,
    W] (a codeword per trial) under the erasures ``erased`` int32[n, W],
    on one code or a batch (word w on code ``w // (W // C)``).  The
    result's ``val`` holds the decoded bits where ``known``.  On CUDA
    tensors the shapes :func:`erasure_decode_block_words` splits into
    blocks (``values=True``) run kernel D's value form, the whole decode in
    one launch; the rest a host loop whose rounds are
    :func:`check_exactly_one_xor` and :func:`variable_or_adopt`.  On CPU
    tensors their plain versions run, by the same rule."""
    return _decode_values(code, erased, tx_bits, max_iters, _VALUE_KERNELS,
                          False, erasure_decode_values)[0]


def bp_decode_packed_plain(code: LDPCCode, erased: torch.Tensor,
                           tx_bits: torch.Tensor, max_iters: int
                           ) -> PackedBPResult:
    """:func:`bp_decode_packed` through the plain version of every pass,
    on any device: the reference the kernels are held to."""
    return _decode_values(code, erased, tx_bits, max_iters, _VALUE_PLAIN,
                          False)[0]


def bp_decode_packed_traj(code: LDPCCode, erased: torch.Tensor,
                          tx_bits: torch.Tensor, max_iters: int
                          ) -> Tuple[PackedBPResult, torch.Tensor]:
    """:func:`bp_decode_packed` that also returns ``traj``
    int32[max_iters+1, B], the erasures of each trial after each round
    (K4 a round), the tail filled with the final counts; ``error_totals``
    is its sum over trials."""
    return _decode_values(code, erased, tx_bits, max_iters, _VALUE_KERNELS,
                          True)


def bp_decode_packed_traj_plain(code: LDPCCode, erased: torch.Tensor,
                                tx_bits: torch.Tensor, max_iters: int
                                ) -> Tuple[PackedBPResult, torch.Tensor]:
    """:func:`bp_decode_packed_traj` through the plain passes."""
    return _decode_values(code, erased, tx_bits, max_iters, _VALUE_PLAIN,
                          True)


# ---------------------------------------------------------------------------
# Irregular codes: K2/K3 unchanged on the phantom-padded tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _PhantomView:
    """What the packed decode reads of a code (duck-typed
    :class:`LDPCCode`): ``n`` counts the phantom row; K2 and K3 take the
    check and variable counts from the table shapes."""

    chk_to_var: torch.Tensor   # int32[(C,) m+1, dc_max]
    var_to_chk: torch.Tensor   # int32[(C,) n+1, dv_max]
    n: int


def _phantom_view(code) -> _PhantomView:
    return _PhantomView(chk_to_var=code.chk_to_var,
                        var_to_chk=code.var_to_chk, n=code.n + 1)


def _pad_phantom_row(plane: torch.Tensor) -> torch.Tensor:
    """Append the phantom variable's plane (all zero: not erased)."""
    return torch.cat([plane, plane.new_zeros((1,) + plane.shape[1:])])


def _strip_phantom(res: PackedBPResult) -> PackedBPResult:
    return dataclasses.replace(
        res, known=res.known[:-1],
        val=None if res.val is None else res.val[:-1])


def bp_decode_packed_allzero_irregular(code, erased: torch.Tensor,
                                       max_iters: int) -> PackedBPResult:
    """:func:`bp_decode_packed_allzero` for an irregular code or a batch
    of them; ``erased`` and the result's planes are [n, W]."""
    return _strip_phantom(bp_decode_packed_allzero(
        _phantom_view(code), _pad_phantom_row(erased), max_iters))


def _irregular_values(code, erased, tx_bits, max_iters, passes, traj,
                      whole=None):
    """A value-plane decode on the phantom view: the phantom row is known,
    its transmitted bit 0."""
    res, rows = _decode_values(_phantom_view(code), _pad_phantom_row(erased),
                               _pad_phantom_row(tx_bits), max_iters, passes,
                               traj, whole)
    return _strip_phantom(res), rows


def bp_decode_packed_irregular(code, erased: torch.Tensor,
                               tx_bits: torch.Tensor, max_iters: int
                               ) -> PackedBPResult:
    """:func:`bp_decode_packed` for an irregular code or a batch of them;
    [n, W] planes in and out."""
    return _irregular_values(code, erased, tx_bits, max_iters,
                             _VALUE_KERNELS, False,
                             erasure_decode_values)[0]


def bp_decode_packed_irregular_plain(code, erased: torch.Tensor,
                                     tx_bits: torch.Tensor, max_iters: int
                                     ) -> PackedBPResult:
    """:func:`bp_decode_packed_irregular` through the plain passes."""
    return _irregular_values(code, erased, tx_bits, max_iters, _VALUE_PLAIN,
                             False)[0]


def bp_decode_packed_traj_irregular(code, erased: torch.Tensor,
                                    tx_bits: torch.Tensor, max_iters: int
                                    ) -> Tuple[PackedBPResult, torch.Tensor]:
    """:func:`bp_decode_packed_traj` for irregular codes."""
    return _irregular_values(code, erased, tx_bits, max_iters,
                             _VALUE_KERNELS, True)


def bp_decode_packed_traj_irregular_plain(
        code, erased: torch.Tensor, tx_bits: torch.Tensor, max_iters: int
) -> Tuple[PackedBPResult, torch.Tensor]:
    """:func:`bp_decode_packed_traj_irregular` through the plain passes."""
    return _irregular_values(code, erased, tx_bits, max_iters, _VALUE_PLAIN,
                             True)


def bp_decode_irregular(code, channel_output: torch.Tensor, max_iters: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Single-codeword {0,1,2} oracle for one irregular code, the
    semantics of :func:`bp_decode`.  Unlike the packed path it masks the
    variable sockets: the all-known phantom check would otherwise send
    (vacuously valid) zero messages."""
    channel_output = channel_output.to(torch.int32)
    pad = channel_output.new_zeros(1)
    known = torch.cat([channel_output != ERASURE, pad == 0])
    val = torch.where(known, torch.cat([channel_output, pad]), 0)
    chk, sock = code.chk_to_var.long(), code.var_to_sock.long()

    def step(_it: int) -> int:
        nonlocal val, known
        row_val = val[chk]                                  # [m+1, dc_max]
        row_kn = known[chk].to(torch.int32)
        cnt = row_kn.sum(dim=1, keepdim=True)
        masked = row_val & row_kn
        xor_all = masked.sum(dim=1, keepdim=True) & 1      # XOR of 0/1
        others_known = (cnt - row_kn) == (code.dc_max - 1)
        mcv_val = xor_all ^ masked
        e_valid = others_known.reshape(-1)[sock] & code.var_mask
        e_val = mcv_val.reshape(-1)[sock]
        any_valid = e_valid.any(dim=1)
        adopt = (e_valid & (e_val == 1)).any(dim=1).to(val.dtype)
        val = torch.where(known, val, adopt * any_valid.to(val.dtype))
        known = known | any_valid
        return int((~known).sum())

    errors, it = _run_to_fixed_point(step, int((~known).sum()), max_iters)
    decoded = torch.where(known, val, ERASURE)[:-1]
    return decoded, torch.tensor(errors, dtype=torch.int32), it
