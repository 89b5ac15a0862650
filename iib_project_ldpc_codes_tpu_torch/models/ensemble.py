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

The kernels run the shuffle's swaps in parallel, as rounds of
deterministic reservations that give the same permutation
(:func:`shuffle_rounds` is their CPU model, with the rounds per code), and
the repair loop as :func:`repair_two_rows` does; :func:`sampler_layout`
says where a launch keeps its permutation.
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
#: threads of a sampler block (``csrc/sampler.cuh`` kSamplerThreads)
SAMPLER_THREADS = 1024
#: the samplers keep the permutation in shared memory up to this many
#: sockets (a 4-byte word each: the value and the shuffle's reservation,
#: beside 8 KB of pending masks, within the 227 KB a block may hold) and in
#: a global scratch buffer above it
SHARED_PERM_MAX_SOCKETS = 56_000
#: ... and the shuffle's partners beside it (2 bytes each) up to this many
SHARED_PARTNERS_MAX_SOCKETS = 37_000
#: the kernels' layouts (``csrc/sampler.cuh``): everything in a global
#: scratch buffer, the words in shared memory, words and partners there
LAYOUT_GLOBAL, LAYOUT_WORDS_SHARED, LAYOUT_ALL_SHARED = 0, 1, 2
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


def shuffle_rounds(key, codes: torch.Tensor, chunk: int,
                   attempts: torch.Tensor, num_sockets: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The samplers' shuffle as the kernels run it (``csrc/sampler.cuh``):
    rounds of deterministic reservations, vectorised over the rows.

    Returns (int64[R, E] permutations, int64[R] rounds per row).  Each
    round, every pending step i (partner H[i] <= i, drawn as in
    :func:`_shuffle_plain`) max-writes its priority i into the
    reservations of positions i and H[i]; a step holding both swaps the
    two positions, clears both reservations and is done.  The reservations
    of steps still pending carry over to the next round.  The result is
    :func:`_shuffle_plain`'s permutation; the rounds are the dependence
    depth of the steps.
    """
    device = codes.device
    rows = codes.shape[0]
    perm = torch.arange(num_sockets, dtype=torch.int64,
                        device=device).repeat(rows, 1)
    rounds = torch.zeros(rows, dtype=torch.int64, device=device)
    if num_sockets < 2:
        return perm, rounds
    step = torch.arange(1, num_sockets, dtype=torch.int64, device=device)
    hi, lo = _draws(key, step[None, :], codes[:, None], chunk,
                    attempts[:, None])
    partner = _mulhi64(hi, lo, step + 1)                # [R, E-1]
    own = step.expand(rows, -1)
    reserved = torch.zeros_like(perm)                   # 0: none
    pending = torch.ones_like(partner, dtype=torch.bool)
    while True:
        active = pending.any(1)
        if not bool(active.any()):
            return perm, rounds
        rounds += active
        priority = torch.where(pending, own, 0)
        reserved.scatter_reduce_(1, own, priority, "amax")
        reserved.scatter_reduce_(1, partner, priority, "amax")
        win = pending & (reserved[:, 1:] == own) \
            & (reserved.gather(1, partner) == own)
        r, c = torch.nonzero(win, as_tuple=True)
        i, h = c + 1, partner[r, c]
        at_i, at_h = perm[r, i], perm[r, h]
        perm[r, i], perm[r, h] = at_h, at_i
        reserved[r, i] = 0
        reserved[r, h] = 0
        pending &= ~win


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


def repair_two_rows(perm: torch.Tensor, key, code: int, chunk: int,
                    row_offs: torch.Tensor, var_of: torch.Tensor,
                    max_passes: int = MAX_REPAIR_PASSES
                    ) -> tuple[torch.Tensor, list[int]]:
    """``repair`` on one int64[E] permutation as the kernels run it
    (``csrc/sampler.cuh`` ``flag_rows`` and ``repair``): flag every check
    row that holds a duplicate once; then each pass takes the first flagged
    row's first offender s, swaps it with ``mulhi64(draw p, E)`` and
    rescans only the rows of the two swapped sockets.

    ``row_offs``: int64[m+1] first socket of each check row; ``var_of``:
    int64[E], the variable of each permuted socket (regular: p // dv).
    Returns (the repaired permutation, the offender s of every pass).
    """
    perm = perm.clone()
    num_sockets = perm.shape[0]
    offs = row_offs.tolist()
    row_of = torch.repeat_interleave(
        torch.arange(len(offs) - 1), torch.diff(row_offs.cpu())).tolist()

    def offender(r):
        seen = set()
        for s in range(offs[r], offs[r + 1]):
            v = int(var_of[perm[s]])
            if v in seen:
                return s
            seen.add(v)
        return -1

    flagged = {r for r in range(len(offs) - 1) if offender(r) >= 0}
    offenders = []
    codes = torch.tensor([code], dtype=torch.int64, device=perm.device)
    for p in range(max_passes):
        if not flagged:
            break
        s = offender(min(flagged))
        offenders.append(s)
        hi, lo = _draws(key, torch.tensor(p, device=perm.device), codes,
                        chunk, REPAIR_STREAM)
        j = int(_mulhi64(hi, lo, num_sockets)[0])
        perm[s], perm[j] = perm[j].clone(), perm[s].clone()
        for r in {row_of[s], row_of[j]}:
            if offender(r) >= 0:
                flagged.add(r)
            else:
                flagged.discard(r)
    return perm, offenders


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


def sampler_layout(num_sockets: int) -> tuple[int, int]:
    """(layout, global scratch bytes a code) of the samplers' kernels for
    E sockets: ``csrc/sampler.cuh`` ``shared_bytes`` / ``scratch_bytes``."""
    if num_sockets > SHARED_PERM_MAX_SOCKETS:
        segments = -(-num_sockets // (64 * SAMPLER_THREADS))
        return LAYOUT_GLOBAL, (8 * num_sockets
                               + 8 * SAMPLER_THREADS * segments
                               + -(-4 * num_sockets // 8) * 8)
    if num_sockets > SHARED_PARTNERS_MAX_SOCKETS:
        return LAYOUT_WORDS_SHARED, -(-2 * num_sockets // 8) * 8
    return LAYOUT_ALL_SHARED, 0


def sampler_scratch(num: int, num_sockets: int, device
                    ) -> tuple[int, int, torch.Tensor | None]:
    """(layout, bytes a code, the global scratch buffer or None) of a
    sampler launch of ``num`` codes."""
    layout, per_code = sampler_layout(num_sockets)
    scratch = torch.empty((num, per_code // 8), dtype=torch.int64,
                          device=device) if per_code else None
    return layout, per_code, scratch


def check_rounds(rounds, num: int, device) -> None:
    """Raise unless ``rounds`` is None or int32[num] on ``device``."""
    if rounds is not None and (
            rounds.dtype != torch.int32 or rounds.shape != (num,)
            or rounds.device.type != torch.device(device).type
            or not rounds.is_contiguous()):
        raise ValueError(f"rounds must be a contiguous int32[{num}] on "
                         f"{device}")


def first_shuffle_rounds(seed: int, chunk: int, num: int,
                         num_sockets: int, device="cpu") -> torch.Tensor:
    """int64[num]: the rounds each code's first shuffle takes (what the
    kernels write to ``rounds``), from :func:`shuffle_rounds`."""
    codes = torch.arange(num, dtype=torch.int64, device=device)
    return shuffle_rounds(sampler_key(seed), codes, chunk,
                          torch.zeros_like(codes), num_sockets)[1]


def sample_codes(seed: int, chunk: int, num: int, n: int, dv: int, dc: int,
                 method: str = "repair", device="cpu",
                 rounds: torch.Tensor | None = None) -> LDPCCode:
    """Sample ``num`` codes of the (dv,dc)-regular ensemble for Monte
    Carlo chunk ``chunk``: a batch :class:`LDPCCode` (tables [num, ...]).

    Deterministic in (seed, chunk, code index); the module docstring
    gives the draws.  On a CUDA device K5 samples all codes in one launch;
    on the CPU the plain version computes the same tables.  ``rounds``
    (int32[num] on the device, optional) receives the rounds of each
    code's first shuffle (on the CPU from :func:`first_shuffle_rounds`).
    """
    device = torch.device(device)
    check_rounds(rounds, num, device)
    if not use_kernel(device):
        code = _sample_codes_plain(seed, chunk, num, n, dv, dc, method,
                                   device)
        if rounds is not None:
            rounds.copy_(first_shuffle_rounds(seed, chunk, num, n * dv))
        return code
    _check_sampler_args(chunk, num, n, dv, dc, method)
    m, num_sockets = n * dv // dc, n * dv
    chk = torch.empty((num, m, dc), dtype=torch.int32, device=device)
    var_to_edge = torch.empty((num, n, dv), dtype=torch.int32, device=device)
    var_to_chk = torch.empty((num, n, dv), dtype=torch.int32, device=device)
    layout, per_code, scratch = sampler_scratch(num, num_sockets, device)
    k0, k1 = sampler_key(seed)
    launch("ldpc_sample_regular_codes", device, chk.data_ptr(),
           var_to_edge.data_ptr(), var_to_chk.data_ptr(),
           0 if scratch is None else scratch.data_ptr(),
           0 if rounds is None else rounds.data_ptr(), num, n, dv, dc,
           METHODS.index(method),
           MAX_REJECT_TRIES if method == "reject" else MAX_REPAIR_PASSES,
           k0, k1, chunk, layout, per_code)
    sample_codes.launches += 1
    return LDPCCode(chk_to_var=chk, var_to_edge=var_to_edge, n=n, dv=dv,
                    dc=dc, var_to_chk=var_to_chk)


sample_codes.launches = 0
