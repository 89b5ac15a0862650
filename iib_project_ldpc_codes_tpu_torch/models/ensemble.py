"""Seeded (dv,dc)-regular configuration-model sampler, on the host.

The JAX package's sampler (``iib_project_ldpc_codes_tpu/models/
ensemble.py:61-222``) with a ``torch.Generator`` in place of
``jax.random`` keys: shuffle the n*dv sockets, floor-divide by dv to get
the variable at each check socket, and condition on simplicity by one of
three methods -- ``reject`` (redraw the whole permutation), ``repair``
(swap the first duplicated socket with a uniformly random partner) or
``raw`` (no conditioning: multi-edges allowed).

The generator gives a *different* code than ``jax.random`` for the same
numbers: the two packages agree on the ensemble, not on the draw.  To run
both on one code, carry the JAX code's table over with
:func:`..code.code_from_numpy` or the npz store.

This runs once per run in fixed-code mode, so it is plain torch on the
CPU; a device sampler for per-chunk fresh codes comes with ensemble mode.
"""

from __future__ import annotations

import hashlib

import torch

from .code import LDPCCode, code_from_checks

MAX_REJECT_TRIES = 10_000  # reference cap, random_code_generator.c:26-28
MAX_REPAIR_PASSES = 1_000


def _perm_to_checks(perm: torch.Tensor, dv: int, dc: int) -> torch.Tensor:
    """Socket permutation -> check->variable table (configuration model)."""
    return (perm // dv).reshape(-1, dc).to(torch.int32)


def _first_duplicate(perm: torch.Tensor, dv: int, dc: int) -> int:
    """Flat check-socket index of the first socket that repeats an earlier
    socket's variable in its check row, or -1 when the draw is simple."""
    chk = _perm_to_checks(perm, dv, dc)
    eq = chk[:, :, None] == chk[:, None, :]                # [m, dc, dc]
    earlier = torch.tril(torch.ones((dc, dc), dtype=torch.bool), -1)
    dup = (eq & earlier).any(dim=2).reshape(-1)            # [E]
    hits = torch.nonzero(dup)
    return int(hits[0, 0]) if hits.numel() else -1


def sample_check_table(generator: torch.Generator, n: int, dv: int, dc: int,
                       method: str = "repair") -> torch.Tensor:
    """Sample a (dv,dc)-regular check->variable table, int32[m, dc] on
    the CPU; simple unless ``method == "raw"``."""
    if (n * dv) % dc != 0:
        raise ValueError("n*dv must be divisible by dc")
    if method not in ("reject", "repair", "raw"):
        raise ValueError(f"unknown sampling method {method!r}")
    E = n * dv
    perm = torch.randperm(E, generator=generator)
    if method == "reject":
        tries = 0
        while _first_duplicate(perm, dv, dc) >= 0 and \
                tries < MAX_REJECT_TRIES:
            perm = torch.randperm(E, generator=generator)
            tries += 1
    elif method == "repair":
        passes = 0
        while passes < MAX_REPAIR_PASSES:
            s = _first_duplicate(perm, dv, dc)
            if s < 0:
                break
            j = int(torch.randint(0, E, (), generator=generator))
            perm[s], perm[j] = perm[j].clone(), perm[s].clone()
            passes += 1
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


def code_for_config(cfg, device="cpu") -> LDPCCode:
    """Deterministic fixed code keyed by (code_number, n, dv, dc).

    Regenerating from the seed is exact, so nothing needs storing.  The
    code differs from the JAX package's ``code_for_config`` for the same
    numbers (another generator); irregular configurations come later.
    """
    if cfg.lam is not None:
        raise NotImplementedError(
            "irregular (lam, rho) codes are not ported yet "
            "(ROADMAP queue 1 item 8)")
    g = torch.Generator().manual_seed(
        code_seed(cfg.code_number, cfg.n, cfg.dv, cfg.dc))
    return sample_code(g, cfg.n, cfg.dv, cfg.dc, cfg.sampler, device=device)
