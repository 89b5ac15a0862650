"""BEC peeling decoder with its R-process (degree-1 evolution).

The JAX package's decoder (``iib_project_ldpc_codes_tpu/ops/peeling.py``;
reference semantics peeling_decoder.py:47-82): strip the non-erased
variables from the residual graph, then repeatedly pick a uniformly random
degree-1 check, resolve its one unresolved variable and peel its column,
recording the number of degree-1 checks before each peel
(``one_degree_evolution``, the R-process of finite-length scaling theory).
The decoder fails when the degree-1 checks run out with erasures left.

The sequential peel is a chain of dependent steps (the statistic of
interest IS the one-at-a-time trajectory), so its parallelism is across
trials and a step's latency bounds its time (the bytes, tables read once
and the evolution written once, take far less): :func:`peel_sequential`
(P1, ``csrc/peel_sequential.cu``) runs one warp a trial, for a batch of T
trials on one code or on T codes (the experiment's fresh code per repeat)
in one launch, in one of two forms that :func:`peel_form` picks by shape
alone.  "xor" keeps, per check in shared memory, the residual degree and
the XOR over its unresolved sockets of the variable and of the variable's
other checks (cyclic row offsets), so at degree 1 they name the variable
and its checks and no device-memory load sits on a step's chain; "row"
(n above 16-bit indices, e.g. 300,000) reads the chosen row and the
variable's row from device memory each step.  The plain version does
the same steps vectorised over the trials.  :func:`peel_decode`,
:func:`peel_decode_irregular` and :func:`peel_decode_batch` are JAX's entry
points on it, each with a ``_plain`` twin.

The random choice is canonical: at step t of trial r, with ``count``
degree-1 checks, k = floor(r64 * count / 2^64), r64 = lanes 0 (low) and 1
(high) of Philox4x32-10 at counter (t, r, 0, 0) under ``peel_key(seed)``
(``philox_key(seed)`` with ``PEEL_KEY_TAG`` XORed into word 0), and the
chosen check is the k-th degree-1 check in increasing check index; its
variable is the first unresolved entry of its row (JAX's argmax).  So the
kernel and the plain version give the same trajectory, on the GPU and the
CPU alike, and a trajectory depends only on (seed, trial), not on the
batch.  JAX picks by Gumbel-argmax and its native C by xorshift: the three
agree in distribution only, and on everything that does not depend on the
order of choices -- the final unresolved set (the maximal stopping set),
the number of peels and the initial degree-1 count.

Irregular codes run on their phantom-padded tables with the phantom rows
dropped: check-row entries n and variable-row entries m are padding and
are skipped (native/peeling.c:52-60).

:func:`peel_decode_parallel` (JAX :174-205) resolves, each round, every
erased variable with an adjacent degree-1 check: exactly the BEC BP round,
so it runs on K2/K3 over a packed plane (one trial a bit) and counts rounds
with JAX's rule, the last round that changed nothing included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels import check_int32, launch, use_kernel
from ..models.code import LDPCCode
from ..models.irregular import IrregularLDPCCode
from .bitops import MASK32, pack_bits, philox4x32_10, philox_key
from .channels import ERASURE
from .erasure_bp import (_check_exactly_one_plain, _variable_or_update_plain,
                         check_exactly_one, variable_or_update)

PEEL_KEY_TAG = 0xA54FF53A      # XORed into key word 0 of the peel's choices
#: largest degrees the kernel takes (one lane per row entry)
MAX_DEGREE = 32
#: the shared memory one block may hold (H100: 227 KB)
MAX_SHARED_BYTES = 232_448
#: the "xor" form's limits: a variable, and a check + 1, in a 16-bit
#: accumulator; residual degrees in 4 bits; a variable's checks in registers
XOR_MAX_N, XOR_MAX_M, XOR_MAX_DC, XOR_MAX_DV = 65_535, 65_535, 15, 8
#: P1's forms, as the C entry point numbers them
PEEL_FORMS = ("row", "xor")
_DRAW_BLOCK = 256              # steps of Philox draws made at once (plain)


@dataclasses.dataclass(frozen=True)
class PeelResult:
    """Result of a peeling decode: one codeword, or a batch of T with a
    leading [T] axis on every field."""

    unresolved: torch.Tensor            # bool[(T,) n] erasures never resolved
    one_degree_evolution: torch.Tensor  # int32[(T,) max_steps+1], -1 padded
    steps: torch.Tensor                 # int32[(T,)] peels (+1 if final 0)
    num_erasures: torch.Tensor          # int32[(T,)] initial erasure count

    @property
    def success(self) -> torch.Tensor:
        return ~self.unresolved.any(-1)

    @property
    def remaining(self) -> torch.Tensor:
        return self.unresolved.sum(-1, dtype=torch.int32)

    @property
    def size_at_failure(self) -> torch.Tensor:
        """The reference's ``sizes_at_failure`` bookkeeping: initial
        erasures + 1 - trajectory length (peeling_decoder.py:143):
        remaining + 1 for failures, 0 for successes."""
        return self.num_erasures + 1 - self.steps


def peel_key(seed: int) -> tuple[int, int]:
    """Philox key of the peel's choices for ``seed`` (module docstring)."""
    k0, k1 = philox_key(seed)
    return k0 ^ PEEL_KEY_TAG, k1


def _tables(code) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(check rows int32[(C,) m, dc], variable rows int32[(C,) n, dv], n,
    m) of a regular or irregular code or batch, phantom rows dropped."""
    if isinstance(code, IrregularLDPCCode):
        return (code.chk_to_var[..., :code.m, :].contiguous(),
                code.var_to_chk[..., :code.n, :].contiguous(), code.n, code.m)
    if isinstance(code, LDPCCode):
        return code.chk_to_var, code.var_to_chk, code.n, code.m
    raise TypeError(f"no peeling decoder for a {type(code).__name__}")


# ---------------------------------------------------------------------------
# P1: the sequential peel of a batch
# ---------------------------------------------------------------------------

def _draws(key, t0: int, t1: int, trials: int, device) -> tuple:
    """(low, high) Philox words int64[t1 - t0, T] of steps t0 .. t1-1."""
    t = torch.arange(t0, t1, dtype=torch.int64, device=device)[:, None]
    r = torch.arange(trials, dtype=torch.int64, device=device)[None, :]
    c0, c1, _, _ = philox4x32_10((t.expand(-1, trials), r.expand(t1 - t0, -1),
                                  0, 0), key)
    return c0, c1


def _peel_sequential_plain(chk, var, erased, n: int, m: int, seed: int,
                           max_steps: int):
    """Plain version of P1: the same steps vectorised over the trials,
    the k-th degree-1 check by cumsum and searchsorted.  Returns
    (unresolved, evolution, steps, num_erasures)."""
    trials = erased.shape[0]
    device = erased.device
    batched = chk.dim() == 3
    tr = torch.arange(trials, device=device)
    chk_l = chk.long().clamp(max=n)          # padding -> the phantom column n
    var_l = var.long().clamp(max=m)          # padding -> the phantom check m
    un = torch.cat([erased, erased.new_zeros((trials, 1))], 1)   # [T, n+1]
    flat = chk_l.reshape(trials, -1) if batched else chk_l.reshape(1, -1) \
        .expand(trials, -1)
    deg = un.gather(1, flat).reshape(trials, m, -1).sum(-1, dtype=torch.int32)
    deg = torch.cat([deg, deg.new_zeros((trials, 1))], 1)       # [T, m+1]
    num_erasures = erased.sum(1, dtype=torch.int32)
    evolution = torch.full((trials, max_steps + 1), -1, dtype=torch.int32,
                           device=device)
    done = num_erasures == 0
    key = peel_key(seed)
    for t in range(max_steps):
        if t % _DRAW_BLOCK == 0:
            low, high = _draws(key, t, min(max_steps, t + _DRAW_BLOCK),
                               trials, device)
        ones = deg[:, :m] == 1
        count = ones.sum(1)
        active = (count > 0) & ~done
        if not bool(active.any()):
            break
        i = t % _DRAW_BLOCK
        k = (high[i] * count + ((low[i] * count) >> 32)) >> 32
        chosen = torch.searchsorted(ones.cumsum(1), (k + 1)[:, None]) \
            .squeeze(1).clamp(max=m - 1)
        row = chk_l[tr, chosen] if batched else chk_l[chosen]      # [T, dc]
        first = un.gather(1, row).to(torch.int8).argmax(1)
        v = row.gather(1, first[:, None]).squeeze(1)
        at, v = tr[active], v[active]
        un[at, v] = False
        hit = var_l[at, v] if batched else var_l[v]                # [A, dv]
        deg.index_put_((at[:, None].expand_as(hit), hit),
                       torch.tensor(-1, dtype=torch.int32, device=device),
                       accumulate=True)
        evolution[:, t] = torch.where(active, count, -1).to(torch.int32)
        done |= ~active
    unresolved = un[:, :n].contiguous()
    steps = (evolution >= 0).sum(1, dtype=torch.int32)
    success = ~unresolved.any(1)
    evolution[tr[success], steps[success].long()] = 0
    return unresolved, evolution, steps + success.to(torch.int32), \
        num_erasures


def peel_xor_layout(m: int, dv: int) -> dict:
    """The "xor" form's shared memory in 32-bit words, as
    ``csrc/peel_sequential.cu::xor_layout`` lays it out: the degree-1
    bitmap in 32 runs of ``per`` words (a power of two, at least 4: a
    lane's run, read 16 bytes at a time), the 4-bit degrees (``mx`` = m
    rounded up to 8), ``dv`` accumulator planes of ``stride`` words (two
    16-bit accumulators a word) and the erasure count."""
    runs = ((m + 31) // 32 + 31) // 32      # bitmap words a lane needs
    shift = 2
    while (1 << shift) < runs:
        shift += 1
    mx = (m + 7) & ~7
    stride = mx // 2 + 1
    words = 32 * (1 << shift) + mx // 8 + dv * stride + 1
    return dict(per=1 << shift, shift=shift, mx=mx, stride=stride,
                words=words, bytes=4 * words)


def peel_form(n: int, m: int, dc: int, dv: int) -> str:
    """The P1 form for a code of n variables, m checks and tables of
    widths dc and dv, by shape alone: "xor" where its 16-bit accumulators,
    4-bit degrees, registers and shared memory fit (n and m up to 65,535,
    dc up to 15, dv up to 8, :func:`peel_xor_layout` within one block),
    else "row"."""
    if n <= XOR_MAX_N and m <= XOR_MAX_M and dc <= XOR_MAX_DC and \
            dv <= XOR_MAX_DV and \
            peel_xor_layout(m, dv)["bytes"] <= MAX_SHARED_BYTES:
        return "xor"
    return "row"


def peel_sequential(chk: torch.Tensor, var: torch.Tensor,
                    erased: torch.Tensor, n: int, m: int, seed: int,
                    max_steps: int, form: Optional[str] = None):
    """The sequential peel of T trials: ``chk`` int32[(T,) m, dc] and
    ``var`` int32[(T,) n, dv] (one code, or one a trial; entries >= n and
    >= m are padding), ``erased`` bool[T, n].  Returns ``(unresolved
    bool[T, n], evolution int32[T, max_steps+1], steps int32[T],
    num_erasures int32[T])`` in JAX's format (module docstring).  On CUDA
    tensors one launch of P1 in ``form`` (default :func:`peel_form`'s; a
    form the shape does not fit raises), kept as ``peel_sequential.form``;
    "xor" reads only ``var``, so both tables must describe one graph, as
    the samplers' do.  On CPU tensors the plain version."""
    check_int32("chk", chk, chk.dim())
    check_int32("var", var, var.dim())
    if erased.dtype != torch.bool or erased.dim() != 2 or \
            erased.shape[1] != n or not erased.is_contiguous():
        raise ValueError(f"erased must be a contiguous bool[T, n={n}]")
    trials = erased.shape[0]
    batched = chk.dim() == 3
    if chk.dim() not in (2, 3) or var.dim() != chk.dim() or \
            chk.shape[-2] != m or var.shape[-2] != n or \
            (batched and (chk.shape[0] != trials or var.shape[0] != trials)):
        raise ValueError(f"tables {tuple(chk.shape)} / {tuple(var.shape)} "
                         f"do not fit {trials} trials of n={n}, m={m}")
    if max_steps < 0:
        raise ValueError("max_steps must be >= 0")
    if form is not None and form not in PEEL_FORMS:
        raise ValueError(f"form must be one of {PEEL_FORMS}, got {form!r}")
    if not use_kernel(chk, var, erased):
        return _peel_sequential_plain(chk, var, erased, n, m, seed,
                                      max_steps)
    dc, dv = chk.shape[-1], var.shape[-1]
    if dc > MAX_DEGREE or dv > MAX_DEGREE:
        raise ValueError(f"degrees ({dv}, {dc}) above the kernel's "
                         f"{MAX_DEGREE}")
    fits = peel_form(n, m, dc, dv)
    form = form or fits
    if form == "xor" and fits != "xor":
        raise ValueError(f"the xor form does not take n={n}, m={m}, "
                         f"dc={dc}, dv={dv}")
    smem = 4 * ((m + 31) // 32 + (n + 31) // 32) + m
    if form == "row" and smem > MAX_SHARED_BYTES:
        raise ValueError(f"n={n}, m={m} needs {smem} bytes of shared memory, "
                         f"above {MAX_SHARED_BYTES}")
    device = erased.device
    unresolved = torch.empty((trials, n), dtype=torch.bool, device=device)
    evolution = torch.empty((trials, max_steps + 1), dtype=torch.int32,
                            device=device)
    steps = torch.empty(trials, dtype=torch.int32, device=device)
    num_erasures = torch.empty_like(steps)
    key0, key1 = peel_key(seed)
    launch("ldpc_peel_sequential", device, chk.data_ptr(), var.data_ptr(),
           erased.data_ptr(), unresolved.data_ptr(), evolution.data_ptr(),
           steps.data_ptr(), num_erasures.data_ptr(), trials, n, m, dc, dv,
           int(batched), max_steps, key0 & MASK32, key1 & MASK32,
           PEEL_FORMS.index(form))
    peel_sequential.launches += 1
    peel_sequential.form = form
    return unresolved, evolution, steps, num_erasures


peel_sequential.launches = 0
peel_sequential.form = None


# ---------------------------------------------------------------------------
# JAX's entry points
# ---------------------------------------------------------------------------

def _batch(code, channel_outputs, seed, max_steps, run) -> PeelResult:
    chk, var, n, m = _tables(code)
    if channel_outputs.dim() != 2 or channel_outputs.shape[1] != n:
        raise ValueError(f"channel outputs must be [T, n={n}], got "
                         f"{tuple(channel_outputs.shape)}")
    erased = (channel_outputs == ERASURE).contiguous()
    steps = n if max_steps is None else int(max_steps)
    return PeelResult(*run(chk, var, erased, n, m, seed, steps))


def _single(code, channel_output, seed, max_steps, run, irregular: bool
            ) -> PeelResult:
    if isinstance(code, IrregularLDPCCode) != irregular or \
            getattr(code, "batched", False):
        raise TypeError(f"{type(code).__name__} (batched: "
                        f"{getattr(code, 'batched', None)}) given to the "
                        f"{'irregular' if irregular else 'regular'} "
                        "single-codeword decoder")
    res = _batch(code, channel_output[None, :], seed, max_steps, run)
    return PeelResult(*(getattr(res, f.name)[0]
                        for f in dataclasses.fields(res)))


def peel_decode(code: LDPCCode, channel_output: torch.Tensor, seed: int = 0,
                max_steps: Optional[int] = None) -> PeelResult:
    """Sequential random peeling of one codeword in the {0,1,2} format,
    trial 0 of ``seed``'s stream.  ``one_degree_evolution[t]`` is the
    degree-1 check count before peel t; a complete decode records one
    extra 0 (the reference's final append, peeling_decoder.py:79-80);
    entries past ``steps`` are -1.  ``max_steps`` defaults to n."""
    return _single(code, channel_output, seed, max_steps, peel_sequential,
                   False)


def peel_decode_plain(code: LDPCCode, channel_output: torch.Tensor,
                      seed: int = 0, max_steps: Optional[int] = None
                      ) -> PeelResult:
    """:func:`peel_decode` through P1's plain version."""
    return _single(code, channel_output, seed, max_steps,
                   _peel_sequential_plain, False)


def peel_decode_irregular(code: IrregularLDPCCode,
                          channel_output: torch.Tensor, seed: int = 0,
                          max_steps: Optional[int] = None) -> PeelResult:
    """:func:`peel_decode` for an :class:`..models.irregular
    .IrregularLDPCCode`: the same R-process semantics, padding skipped."""
    return _single(code, channel_output, seed, max_steps, peel_sequential,
                   True)


def peel_decode_irregular_plain(code: IrregularLDPCCode,
                                channel_output: torch.Tensor, seed: int = 0,
                                max_steps: Optional[int] = None
                                ) -> PeelResult:
    """:func:`peel_decode_irregular` through P1's plain version."""
    return _single(code, channel_output, seed, max_steps,
                   _peel_sequential_plain, True)


def peel_decode_batch(code, channel_outputs: torch.Tensor, seed: int = 0,
                      max_steps: Optional[int] = None) -> PeelResult:
    """Peel T codewords ``channel_outputs`` [T, n] ({0,1,2} format) in one
    launch: on one code, or on a batch of T codes (trial t on code t),
    regular or irregular; trial t draws its choices as trial t of
    ``seed``'s stream."""
    return _batch(code, channel_outputs, seed, max_steps, peel_sequential)


def peel_decode_batch_plain(code, channel_outputs: torch.Tensor,
                            seed: int = 0, max_steps: Optional[int] = None
                            ) -> PeelResult:
    """:func:`peel_decode_batch` through P1's plain version."""
    return _batch(code, channel_outputs, seed, max_steps,
                  _peel_sequential_plain)


# ---------------------------------------------------------------------------
# The parallel (super-step) peel: K2/K3
# ---------------------------------------------------------------------------

def _parallel(code: LDPCCode, channel_output: torch.Tensor, max_rounds: int,
              check, variable) -> Tuple[torch.Tensor, int]:
    if not isinstance(code, LDPCCode) or code.batched:
        raise TypeError("the parallel peel takes one regular LDPCCode, as "
                        "JAX's")
    if channel_output.shape != (code.n,):
        raise ValueError(f"channel_output must be [n={code.n}]")
    erased = channel_output == ERASURE
    plane = torch.zeros((code.n, 32), dtype=torch.bool, device=erased.device)
    plane[:, 0] = erased                 # trial 0 in bit 0 of one word
    known = ~pack_bits(plane)
    remaining = int(erased.sum())
    max_rounds = max_rounds or code.n
    errors = torch.zeros(1, dtype=torch.int32, device=erased.device)
    rounds, changed = 0, remaining > 0
    while changed and rounds < max_rounds:
        exactly_one = check(code.chk_to_var, known)
        errors.zero_()
        variable(code.var_to_chk, exactly_one, known, errors, 0)
        left = int(errors[0])
        rounds += 1
        changed = left != remaining
        remaining = left
    return (known[:, 0] & 1) == 0, rounds


def peel_decode_parallel(code: LDPCCode, channel_output: torch.Tensor,
                         max_rounds: int = 0) -> Tuple[torch.Tensor, int]:
    """Super-step peeling of one codeword: each round resolves every
    erased variable with an adjacent degree-1 check.  Returns
    ``(unresolved bool[n], rounds)``: the final set is the same maximal
    stopping set as the sequential peel's, ``rounds`` counts the last
    round, which changed nothing (JAX's rule; 0 without erasures;
    ``max_rounds`` 0 means n).  On a CUDA tensor each round is K2 and
    K3; on a CPU tensor their plain versions."""
    return _parallel(code, channel_output, max_rounds, check_exactly_one,
                     variable_or_update)


def peel_decode_parallel_plain(code: LDPCCode, channel_output: torch.Tensor,
                               max_rounds: int = 0
                               ) -> Tuple[torch.Tensor, int]:
    """:func:`peel_decode_parallel` through K2's and K3's plain
    versions."""
    return _parallel(code, channel_output, max_rounds,
                     _check_exactly_one_plain, _variable_or_update_plain)
