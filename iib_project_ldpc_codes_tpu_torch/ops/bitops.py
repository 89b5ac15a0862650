"""Bit-packing utilities for the 32-trials-per-word decoder path.

The layout is the JAX package's (``iib_project_ldpc_codes_tpu/ops/
bitops.py``): ``int32[n, W]`` holds ``B = 32*W`` trials for each of ``n``
rows, trial ``b`` in bit ``b % 32`` of word ``b // 32``.  Words are held as
int32 because ``torch.uint32`` lacks ``~``, ``>>`` and ``index_select`` on
the CPU; a JAX uint32 plane enters as ``np.asarray(x).view(np.int32)``.
``>>`` on int32 is arithmetic, so every shift here is followed by a mask.

Two functions have hand-written CUDA kernels beside their plain versions:
:func:`bernoulli_packed` (K1, ``csrc/bernoulli_packed.cu``) and
:func:`per_trial_counts` (K4, ``csrc/per_trial_counts.cu``).

Random bits: Philox4x32-10, one documented scheme for the kernel and the
plain version alike, so a CPU run and a GPU run give the same planes:

  * key    = (seed mod 2^32, (seed >> 32) mod 2^32)
  * offset = a 64-bit stream number (the Monte Carlo engine passes the
    chunk index), counter words 2 and 3
  * bit b of word i = v*W + w is lane b % 4 of the Philox block at counter
    (g mod 2^32, g >> 32, offset mod 2^32, offset >> 32), g = 8*i + b // 4
  * the bit is set iff draw < thr, thr = floor(p * 2^32) computed in
    float64 on the host and clipped to [0, 2^32].

The information bits of random-codeword transmit (:func:`info_planes`) are
K1 planes at p = 0.5 on a key of their own: ``philox_key(seed)`` with
``INFO_KEY_TAG`` XORed into word 0 (apart from K1's noise planes, whose key
is untweaked, from the AWGN noise, tag ``0xB7E15162`` in word 0, and from
the code sampler, which tweaks word 1), offset = the chunk index.  So a
random-transmit chunk draws the same erasures, flips and AWGN noise as the
zero-transmit chunk of the same (seed, offset), and its codewords from a
stream that shares no counter with them.

JAX compares ``float32(draw) < float32(p * 2^32)`` (ops/bitops.py:75-77);
the integer compare here is exact, and the two differ in probability by at
most 2^-24 relative.  ``jax.random`` and Philox give different planes from
the same seed, so the tests compare the two packages on planes handed to
both, and compare channels by their statistics.
"""

from __future__ import annotations

import math

import torch

from ..kernels import check_int32, launch, use_kernel

WORD = 32
MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
DRAWS_PER_WORD = WORD // 4     # Philox blocks per packed word
INFO_KEY_TAG = 0x6A09E667      # XORed into key word 0 for information bits


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., B] -> int32[..., B//32]; bit b of word w is trial 32*w+b."""
    b = bits.shape[-1]
    if b % WORD:
        raise ValueError(f"trailing dim {b} must be a multiple of {WORD}")
    words = bits.reshape(bits.shape[:-1] + (b // WORD, WORD)).to(torch.int32)
    # distinct powers of two: the int32 sum is the OR, bit 31 included
    return torch.sum(words << _shifts(bits.device), dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> bool[..., 32*W] (inverse of :func:`pack_bits`)."""
    expanded = (words[..., None] >> _shifts(words.device)) & 1
    return expanded.reshape(words.shape[:-1] + (-1,)).to(torch.bool)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count, int32 -> int32 (SWAR on the 32-bit
    pattern, widened to int64 so that no step overflows)."""
    x = words.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F).to(torch.int32)


def total_popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits across the whole array (int64 scalar tensor)."""
    return popcount(words).sum(dtype=torch.int64)


# ---------------------------------------------------------------------------
# K4: per-trial counts
# ---------------------------------------------------------------------------

def _per_trial_counts_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: walks the rows in slices of at most ~4M bits,
    so the [n, W, 32] bit array of the JAX version is never built whole."""
    n, w = words.shape
    counts = torch.zeros((w, WORD), dtype=torch.int32, device=words.device)
    shifts = _shifts(words.device)
    step = max(1, (1 << 22) // max(1, w * WORD))
    for r0 in range(0, n, step):
        bits = (words[r0:r0 + step, :, None] >> shifts) & 1
        counts += bits.sum(dim=0, dtype=torch.int32)
    return counts.reshape(-1)


def per_trial_counts(words: torch.Tensor) -> torch.Tensor:
    """int32[n, W] -> int32[32*W]: per trial, the number of the n rows
    whose bit is set (JAX ``per_trial_counts(words, axis=0)``)."""
    check_int32("words", words, 2)
    if not use_kernel(words):
        return _per_trial_counts_plain(words)
    n, w = words.shape
    counts = torch.zeros(w * WORD, dtype=torch.int32, device=words.device)
    launch("ldpc_per_trial_counts", words.device, words.data_ptr(),
           counts.data_ptr(), n, w)
    per_trial_counts.launches += 1
    return counts


per_trial_counts.launches = 0


# ---------------------------------------------------------------------------
# K1: Philox packed Bernoulli planes
# ---------------------------------------------------------------------------

def philox_key(seed: int) -> tuple[int, int]:
    """Philox key (k0, k1) of a seed (any int, taken mod 2^64)."""
    seed &= (1 << 64) - 1
    return seed & MASK32, seed >> 32


def bernoulli_threshold(prob: float) -> int:
    """thr = floor(p * 2^32) in float64, clipped to [0, 2^32]: a draw is
    a hit iff draw < thr, so p <= 0 never hits and p >= 1 always does."""
    p = float(prob)
    if math.isnan(p):
        raise ValueError("probability is NaN")
    if p <= 0.0:
        return 0
    if p >= 1.0:
        return 1 << 32
    return int(math.floor(p * 4294967296.0))


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of a * m for a in [0, 2^32) as int64; m is
    split into 16-bit halves so that no product overflows int64."""
    p1 = a * (m >> 16)          # < 2^48
    p0 = a * (m & 0xFFFF)       # < 2^48
    lo = (((p1 & 0xFFFF) << 16) + p0) & MASK32
    hi = (p1 + (p0 >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr, key: tuple[int, int]):
    """Plain Philox4x32-10 on int64 tensors holding uint32 values.

    ``ctr`` is four broadcastable tensors (or ints) in [0, 2^32); returns
    the four output words as int64 tensors in [0, 2^32).
    """
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def _bernoulli_packed_plain(thr: int, shape, key: tuple[int, int],
                            offset: int, device) -> torch.Tensor:
    """Plain version of K1: the same Philox counters in int64 arithmetic,
    so it gives K1's bits exactly."""
    total = math.prod(shape)
    word_idx = torch.arange(total, dtype=torch.int64, device=device)
    words = torch.zeros(total, dtype=torch.int64, device=device)
    off = (offset & MASK32, (offset >> 32) & MASK32)
    for j in range(DRAWS_PER_WORD):
        g = word_idx * DRAWS_PER_WORD + j
        lanes = philox4x32_10((g & MASK32, g >> 32, off[0], off[1]), key)
        for lane, draw in enumerate(lanes):
            words |= (draw < thr).to(torch.int64) << (4 * j + lane)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words)
    return words.to(torch.int32).reshape(shape)


def bernoulli_packed(prob: float, shape, *, seed: int, offset: int = 0,
                     device="cpu", key_tag: int = 0) -> torch.Tensor:
    """int32[*shape] with 32 independent Bernoulli(prob) bits per word.

    Deterministic in (seed, offset): the module docstring gives the
    scheme; ``key_tag`` is XORed into word 0 of the key (a stream of its
    own).  On a CUDA device K1 writes the planes; on the CPU the plain
    version computes the same bits.
    """
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"negative shape {shape}")
    if not 0 <= offset < (1 << 64):
        raise ValueError(f"offset {offset} outside [0, 2^64)")
    thr = bernoulli_threshold(prob)
    k0, k1 = philox_key(seed)
    key = (k0 ^ (key_tag & MASK32), k1)
    device = torch.device(device)
    if not use_kernel(device):
        return _bernoulli_packed_plain(thr, shape, key, offset, device)
    out = torch.empty(shape, dtype=torch.int32, device=device)
    launch("ldpc_bernoulli_packed", device, out.data_ptr(), out.numel(),
           key[0], key[1], offset & MASK32, offset >> 32, thr)
    bernoulli_packed.launches += 1
    return out


bernoulli_packed.launches = 0


def info_planes(k: int, words: int, *, seed: int, offset: int = 0,
                device="cpu") -> torch.Tensor:
    """int32[k, words] fair information bits of random-codeword transmit:
    K1 at p = 0.5 on the information key (module docstring)."""
    return bernoulli_packed(0.5, (k, words), seed=seed, offset=offset,
                            device=device, key_tag=INFO_KEY_TAG)

