"""Seeded (dv,dc)-regular configuration-model samplers.

The JAX package's sampler (``iib_project_ldpc_codes_tpu/models/
ensemble.py:61-222``): shuffle the E = n*dv sockets, floor-divide by dv to
get the variable at each check socket, and condition on simplicity by one
of three methods -- ``reject`` (redraw the whole permutation, at most
MAX_REJECT_TRIES times), ``repair`` (swap the first duplicated socket with
a uniformly random partner and rescan, at most MAX_REPAIR_PASSES passes)
or ``raw`` (no conditioning: multi-edges allowed).  Two samplers:

  * :func:`sample_code` / :func:`code_for_config` -- one code on the host
    from a ``torch.Generator`` (fixed-code mode; once per run).
  * :func:`sample_codes` -- a batch of C codes per Monte Carlo chunk
    (ensemble mode).  On a CUDA device one launch of K5
    (``csrc/sample_regular_codes.cu``) samples them all; on the CPU the
    plain version computes the same tables bit for bit.

Both give other codes than ``jax.random`` for the same numbers: the
packages agree on the ensemble, not on the draw.  To run both on one code,
carry the JAX code's table over with :func:`..code.code_from_numpy` /
:func:`..code.codes_from_numpy` or the npz store.

Random numbers of :func:`sample_codes`: Philox4x32-10 as in K1
(``ops/bitops.py``), on a stream of its own:

  * key = ``philox_key(seed)`` with ``SAMPLER_KEY_TAG`` XORed into word 1,
    so it never meets the channel's stream of the same seed;
  * draw d of stream s for code c of chunk t is the 64-bit number
    ``lo | hi << 32`` from the Philox block at counter
    (d >> 1, c, t, s): lanes (0, 1) for even d, lanes (2, 3) for odd d;
  * stream s < 2^31 is shuffle attempt s (0 first; ``reject`` redraws
    1, 2, ...); stream ``REPAIR_STREAM`` = 2^31 gives repair pass p its
    draw d = p;
  * a uniform integer below ``bound`` is ``mulhi64(r, bound)`` = the high
    64 bits of r * bound (no rejection loop; bias below bound / 2^64).

A shuffle is Fisher-Yates from the identity: for i = E-1 down to 1, swap
positions i and ``mulhi64(draw i, i+1)``.  A repair pass swaps the first
duplicate s (the smallest flat check-socket index whose variable repeats
an earlier socket of its row) with ``mulhi64(draw p, E)``.
``var_to_edge`` is then read off the inverse permutation: variable v's
edges are ``inv[v*dv .. v*dv+dv-1]`` in ascending order, the stable argsort
of ``code_from_checks`` without a sort.
"""

from __future__ import annotations

import hashlib

import torch

from ..kernels import launch, use_kernel
from ..ops.bitops import MASK32, philox4x32_10, philox_key
from .code import LDPCCode, code_from_checks

MAX_REJECT_TRIES = 10_000  # reference cap, random_code_generator.c:26-28
MAX_REPAIR_PASSES = 1_000
METHODS = ("raw", "reject", "repair")   # K5's method codes 0, 1, 2
SAMPLER_KEY_TAG = 0x243F6A88            # XORed into key word 1
REPAIR_STREAM = 1 << 31
#: K5 keeps the permutation in shared memory up to this many sockets
#: (4 bytes each, beside a 4 KB tile of shuffle partners, within the
#: 227 KB a block may hold) and in a global scratch buffer above it
SHARED_PERM_MAX_SOCKETS = 56_000
#: element budget of one block of the plain version's reject search
#: (codes x attempts x sockets permutation entries)
_PLAIN_REJECT_BUDGET = 1 << 24


def _perm_to_checks(perm: torch.Tensor, dv: int, dc: int) -> torch.Tensor:
    """Socket permutation -> check->variable table (configuration model)."""
    return (perm // dv).reshape(-1, dc).to(torch.int32)


def _first_duplicate(perm: torch.Tensor, dv: int, dc: int) -> int:
    """Flat check-socket index of the first socket that repeats an earlier
    socket's variable in its check row, or -1 when the draw is simple."""
    dup, first = _first_duplicates(perm[None, :], dv, dc)
    return int(first[0]) if bool(dup[0]) else -1


def match_on_host(generator: torch.Generator, num_sockets: int,
                  first_duplicate, method: str) -> torch.Tensor:
    """A socket permutation int64[E] on the host, conditioned on
    simplicity by ``method`` (``first_duplicate(perm)``: the offending
    socket index or -1)."""
    perm = torch.randperm(num_sockets, generator=generator)
    if method == "reject":
        tries = 0
        while first_duplicate(perm) >= 0 and tries < MAX_REJECT_TRIES:
            perm = torch.randperm(num_sockets, generator=generator)
            tries += 1
    elif method == "repair":
        for _ in range(MAX_REPAIR_PASSES):
            s = first_duplicate(perm)
            if s < 0:
                break
            j = int(torch.randint(0, num_sockets, (), generator=generator))
            perm[s], perm[j] = perm[j].clone(), perm[s].clone()
    return perm


def sample_check_table(generator: torch.Generator, n: int, dv: int, dc: int,
                       method: str = "repair") -> torch.Tensor:
    """Sample a (dv,dc)-regular check->variable table, int32[m, dc] on
    the CPU; simple unless ``method == "raw"``."""
    if (n * dv) % dc != 0:
        raise ValueError("n*dv must be divisible by dc")
    if method not in METHODS:
        raise ValueError(f"unknown sampling method {method!r}")
    perm = match_on_host(generator, n * dv,
                         lambda p: _first_duplicate(p, dv, dc), method)
    return _perm_to_checks(perm, dv, dc)


def sample_code(generator: torch.Generator, n: int, dv: int, dc: int,
                method: str = "repair", device="cpu") -> LDPCCode:
    """Sample one code from the (dv,dc)-regular ensemble."""
    chk = sample_check_table(generator, n, dv, dc, method)
    return code_from_checks(chk, n=n, dv=dv, dc=dc, device=device)


def code_seed(code_number: int, n: int, dv: int, dc: int) -> int:
    """Generator seed of the fixed code (code_number, n, dv, dc): the first
    8 bytes of SHA-256 over their decimal text, below 2^63."""
    text = f"regular:{code_number}:{n}:{dv}:{dc}".encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8],
                          "little") & ((1 << 63) - 1)


def code_for_config(cfg, device="cpu"):
    """Deterministic fixed code keyed by (code_number, n, dv, dc), or by
    (code_number, n, lam, rho) for an irregular configuration (an
    :class:`.irregular.IrregularLDPCCode`).

    Regenerating from the seed is exact, so nothing needs storing.  The
    code differs from the JAX package's ``code_for_config`` for the same
    numbers (another generator).
    """
    if cfg.lam is not None:
        from . import irregular

        g = torch.Generator().manual_seed(irregular.irregular_code_seed(
            cfg.code_number, cfg.n, cfg.lam, cfg.rho))
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(cfg.n, cfg.lam,
                                                            cfg.rho)
        return irregular.sample_irregular_code(g, spec, cfg.sampler, device)
    g = torch.Generator().manual_seed(
        code_seed(cfg.code_number, cfg.n, cfg.dv, cfg.dc))
    return sample_code(g, cfg.n, cfg.dv, cfg.dc, cfg.sampler, device=device)


# ---------------------------------------------------------------------------
# K5: a batch of codes per chunk (ensemble mode)
# ---------------------------------------------------------------------------

def sampler_key(seed: int) -> tuple[int, int]:
    """Philox key of the code sampler for ``seed`` (module docstring)."""
    k0, k1 = philox_key(seed)
    return k0, k1 ^ SAMPLER_KEY_TAG


def _mulhi64(hi: torch.Tensor, lo: torch.Tensor, bound) -> torch.Tensor:
    """High 64 bits of (hi * 2^32 + lo) * bound for hi, lo in [0, 2^32)
    and bound in [1, 2^31], in int64 pieces: each product is below 2^63
    and so is their sum."""
    return (hi * bound + ((lo * bound) >> 32)) >> 32


def _draws(key, index, code, chunk: int, stream) -> tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(hi, lo) of draw ``index`` of ``stream`` for ``code`` (broadcast
    int64 tensors), as the module docstring lays the counters out."""
    x, y, z, w = philox4x32_10((index >> 1, code, chunk, stream), key)
    odd = (index & 1) == 1
    return torch.where(odd, w, y), torch.where(odd, z, x)


def _shuffle_plain(key, codes: torch.Tensor, chunk: int,
                   attempts: torch.Tensor, num_sockets: int) -> torch.Tensor:
    """Fisher-Yates permutations int64[R, E], one per (code, attempt)
    row; the partners of all steps are drawn at once, the swaps run in
    order."""
    device = codes.device
    rows = codes.shape[0]
    perm = torch.arange(num_sockets, dtype=torch.int64,
                        device=device).repeat(rows, 1)
    if num_sockets < 2:
        return perm
    pos = torch.arange(1, num_sockets, dtype=torch.int64, device=device)
    hi, lo = _draws(key, pos[None, :], codes[:, None], chunk,
                    attempts[:, None])
    partner = _mulhi64(hi, lo, pos + 1)                 # [R, E-1]
    row = torch.arange(rows, device=device)
    for i in range(num_sockets - 1, 0, -1):
        j = partner[:, i - 1]
        held = perm[:, i].clone()
        perm[:, i] = perm[row, j]
        perm[row, j] = held
    return perm


def _first_duplicates(perm: torch.Tensor, dv: int, dc: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of int64[R, E]: (has a duplicate, flat check-socket index
    of the first socket that repeats an earlier socket's variable in its
    check row; E when none)."""
    rows, num_sockets = perm.shape
    chk = (perm // dv).reshape(rows, -1, dc)
    earlier = torch.tril(torch.ones((dc, dc), dtype=torch.bool,
                                    device=perm.device), -1)
    dup = ((chk[..., :, None] == chk[..., None, :]) & earlier).any(-1)
    idx = torch.arange(num_sockets, device=perm.device)
    first = torch.where(dup.reshape(rows, -1), idx, num_sockets).amin(1)
    return first < num_sockets, first


def _repair_with(perm: torch.Tensor, key, codes: torch.Tensor, chunk: int,
                 first_duplicates,
                 max_passes: int = MAX_REPAIR_PASSES) -> torch.Tensor:
    """``repair`` on int64[C, E] in place: every code with a duplicate
    swaps its first offender (``first_duplicates(perm) -> (has one,
    socket index)``) with ``mulhi64(draw p, E)`` in pass p, until it is
    simple or ``max_passes`` passes ran."""
    num_sockets = perm.shape[1]
    active, first = first_duplicates(perm)
    rows = torch.nonzero(active).reshape(-1)
    for p in range(max_passes):
        if rows.numel() == 0:
            break
        hi, lo = _draws(key, torch.tensor(p, device=perm.device),
                        codes[rows], chunk, REPAIR_STREAM)
        j = _mulhi64(hi, lo, num_sockets)
        s = first[rows]
        at_s = perm[rows, s].clone()
        perm[rows, s] = perm[rows, j]
        perm[rows, j] = at_s
        dup, first_sub = first_duplicates(perm[rows])
        first[rows] = first_sub
        rows = rows[dup]
    return perm


def _repair_plain(perm: torch.Tensor, key, codes: torch.Tensor, chunk: int,
                  dv: int, dc: int,
                  max_passes: int = MAX_REPAIR_PASSES) -> torch.Tensor:
    """:func:`_repair_with` for (dv,dc)-regular rows."""
    return _repair_with(perm, key, codes, chunk,
                        lambda p: _first_duplicates(p, dv, dc), max_passes)


def _reject_with(key, codes: torch.Tensor, chunk: int, num_sockets: int,
                 first_duplicates) -> torch.Tensor:
    """``reject`` for int64[C] codes: attempt a* = the first simple
    attempt (``first_duplicates`` finds none), or MAX_REJECT_TRIES when
    none is, as the sequential loop (draw 0, redraw while a duplicate
    remains and fewer than MAX_REJECT_TRIES redraws ran) picks it.
    Attempts are drawn in blocks that double (128, 256, ...) within an
    element budget, all pending codes at once."""
    out = torch.empty((codes.shape[0], num_sockets), dtype=torch.int64,
                      device=codes.device)
    pending = torch.arange(codes.shape[0], device=codes.device)
    start, block = 0, 64
    while pending.numel():
        block = min(2 * block, MAX_REJECT_TRIES + 1 - start,
                    max(1, _PLAIN_REJECT_BUDGET // (pending.numel()
                                                    * num_sockets)))
        attempts = torch.arange(start, start + block, device=codes.device)
        perms = _shuffle_plain(key, codes[pending].repeat_interleave(block),
                               chunk, attempts.repeat(pending.numel()),
                               num_sockets)
        dup, _ = first_duplicates(perms)
        take = ~dup.reshape(-1, block)
        if start + block == MAX_REJECT_TRIES + 1:
            take[:, -1] = True          # the cap keeps the last draw
        found = take.any(1)
        col = torch.where(take, torch.arange(block, device=codes.device),
                          block).amin(1)
        perms = perms.reshape(-1, block, num_sockets)
        out[pending[found]] = perms[found, col[found]]
        pending = pending[~found]
        start += block
    return out


def _tables_from_perm(perm: torch.Tensor, n: int, dv: int, dc: int
                      ) -> LDPCCode:
    """Batch of codes from int64[C, E] socket permutations."""
    num, num_sockets = perm.shape
    chk = (perm // dv).to(torch.int32).reshape(num, -1, dc)
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(num_sockets, device=perm.device)
                 .expand(num, num_sockets))
    var_to_edge = inv.reshape(num, n, dv).sort(dim=2).values
    return LDPCCode(chk_to_var=chk.contiguous(),
                    var_to_edge=var_to_edge.to(torch.int32).contiguous(),
                    n=n, dv=dv, dc=dc,
                    var_to_chk=(var_to_edge // dc).to(torch.int32)
                    .contiguous())


def _check_sampler_args(chunk: int, num: int, n: int, dv: int, dc: int,
                        method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown sampling method {method!r}")
    if (n * dv) % dc:
        raise ValueError("n*dv must be divisible by dc")
    if min(num, n, dv, dc) < 1:
        raise ValueError(f"num={num}, n={n}, dv={dv}, dc={dc} must be >= 1")
    if n * dv >= 2 ** 31:
        raise ValueError(f"n*dv = {n * dv} sockets must stay below 2^31")
    if not 0 <= chunk <= MASK32 or num > MASK32 + 1:
        raise ValueError(f"chunk {chunk} or num {num} outside 32 bits")


def _sample_codes_plain(seed: int, chunk: int, num: int, n: int, dv: int,
                        dc: int, method: str = "repair",
                        device="cpu") -> LDPCCode:
    """Plain version of K5: the same draws in int64 torch, vectorised
    over the codes, with a Python loop over the steps."""
    _check_sampler_args(chunk, num, n, dv, dc, method)
    key = sampler_key(seed)
    codes = torch.arange(num, dtype=torch.int64, device=device)
    num_sockets = n * dv
    if method == "reject":
        perm = _reject_with(key, codes, chunk, num_sockets,
                            lambda p: _first_duplicates(p, dv, dc))
    else:
        perm = _shuffle_plain(key, codes, chunk, torch.zeros_like(codes),
                              num_sockets)
        if method == "repair":
            _repair_plain(perm, key, codes, chunk, dv, dc)
    return _tables_from_perm(perm, n, dv, dc)


def sample_codes(seed: int, chunk: int, num: int, n: int, dv: int, dc: int,
                 method: str = "repair", device="cpu") -> LDPCCode:
    """Sample ``num`` codes of the (dv,dc)-regular ensemble for Monte
    Carlo chunk ``chunk``: a batch :class:`LDPCCode` (tables [num, ...]).

    Deterministic in (seed, chunk, code index); the module docstring
    gives the draws.  On a CUDA device K5 samples all codes in one launch;
    on the CPU the plain version computes the same tables.
    """
    device = torch.device(device)
    if not use_kernel(device):
        return _sample_codes_plain(seed, chunk, num, n, dv, dc, method,
                                   device)
    _check_sampler_args(chunk, num, n, dv, dc, method)
    m, num_sockets = n * dv // dc, n * dv
    chk = torch.empty((num, m, dc), dtype=torch.int32, device=device)
    var_to_edge = torch.empty((num, n, dv), dtype=torch.int32, device=device)
    var_to_chk = torch.empty((num, n, dv), dtype=torch.int32, device=device)
    shared = num_sockets <= SHARED_PERM_MAX_SOCKETS
    scratch = None if shared else torch.empty(
        (num, num_sockets), dtype=torch.int32, device=device)
    k0, k1 = sampler_key(seed)
    launch("ldpc_sample_regular_codes", device, chk.data_ptr(),
           var_to_edge.data_ptr(), var_to_chk.data_ptr(),
           0 if shared else scratch.data_ptr(), num, n, dv, dc,
           METHODS.index(method),
           MAX_REJECT_TRIES if method == "reject" else MAX_REPAIR_PASSES,
           k0, k1, chunk, int(shared))
    sample_codes.launches += 1
    return LDPCCode(chk_to_var=chk, var_to_edge=var_to_edge, n=n, dv=dv,
                    dc=dc, var_to_chk=var_to_chk)


sample_codes.launches = 0
