"""Channels: the BEC, the BSC and the AWGN channel.

The canonical alphabet is the JAX package's: bits in {0,1}, erasure = 2
(``ERASURE``).  Packed planes (32 trials per int32 word) of the BEC and the
BSC come from K1 (``ops/bitops.py::bernoulli_packed``): erasures on the
BEC, flips against the all-zero codeword on the BSC; the soft decoders read
the BSC as LLR planes of those flips (:meth:`BSC.llr_of_flips`), or, for a
transmitted codeword plane tx, of the received bits tx ^ flips.  The AWGN
channel's LLR planes come from kernel A (:func:`awgn_llr`,
``csrc/awgn_llr.cu``), of the all-zero codeword or of a packed codeword
plane.  Random-codeword transmit keeps the zero-transmit noise: the same
(seed, offset) gives the same flips and the same normals z either way.

AWGN draws: element i of the row-major float32[n, B] plane is lane i % 4 of
the Philox4x32-10 block at counter (g mod 2^32, g >> 32, offset mod 2^32,
offset >> 32), g = i // 4, under key ``philox_key(seed)`` with
``AWGN_KEY_TAG`` XORed into word 0 -- a stream of its own, apart from K1's
(untweaked key) and the code sampler's (word 1 tweaked), so noise never
shares counters with a flip or a code draw.  Box-Muller in float64 on the
word pairs (0, 1) and (2, 3): u1 = (x + 0.5) 2^-32, u2 = y 2^-32, r =
sqrt(-2 ln u1), lanes (r cos 2 pi u2, r sin 2 pi u2), rounded to float32.
Then JAX's float32 arithmetic (ops/channels.py:86-93), one rounding a step:
noise = z sigma, y = (1 - 2b) + noise, llr = (2 y) / (sigma sigma), b the
transmitted bit (0 without a codeword plane).  The kernel computes the
float64 transform without the math library (a table log from the word's
bits, polynomial sin / cos, ``csrc/awgn_llr.cu``) to within 2^-50 of it,
and the plain version calls ``log`` / ``cos`` / ``sin``, so a CPU and a
GPU plane agree to one float32 ulp, equal in all but a tiny share of
entries.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import check_int32, launch, use_kernel
from .bitops import MASK32, bernoulli_packed, philox4x32_10, philox_key, \
    unpack_bits

ERASURE = 2  # sentinel in the {0,1,2} erasure alphabet
AWGN_KEY_TAG = 0xB7E15162   # XORed into Philox key word 0 for AWGN noise


@dataclasses.dataclass(frozen=True)
class BEC:
    """Binary erasure channel with erasure probability ``erasure_prob``."""

    erasure_prob: float

    def transmit(self, bits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        """bits {0,1} -> {0,1,2}; each bit erased i.i.d. (int32)."""
        u = torch.rand(bits.shape, generator=generator,
                       device=generator.device)
        out = torch.where(u.to(bits.device) < self.erasure_prob,
                          ERASURE, bits.to(torch.int32))
        return out.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BSC:
    """Binary symmetric channel with crossover probability
    ``crossover_prob``."""

    crossover_prob: float

    def flip_mask(self, shape, generator: torch.Generator) -> torch.Tensor:
        """bool mask of flipped positions."""
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u < self.crossover_prob

    def transmit(self, bits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        """bits {0,1} -> received bits {0,1}, each flipped i.i.d. (int32)."""
        flips = self.flip_mask(bits.shape, generator).to(bits.device)
        return bits.to(torch.int32) ^ flips.to(torch.int32)

    def llr(self, received: torch.Tensor) -> torch.Tensor:
        """Channel LLRs log P(y|0)/P(y|1) of received hard bits
        (float32)."""
        p = self.crossover_prob
        mag = math.log((1 - p) / p)
        return torch.where(received == 0, mag, -mag).to(torch.float32)

    def llr_of_flips(self, flips: torch.Tensor) -> torch.Tensor:
        """float32[n, 32W] channel LLRs of packed received bits int32[n, W]
        (trial b in bit b % 32 of word b // 32): K1's flip planes for the
        all-zero codeword, tx ^ flips for a codeword plane tx; -mag where
        the bit is 1, +mag elsewhere.  The
        magnitude log((1-p)/p) is taken in float64 and rounded once to
        float32 (JAX: float32 ``log``, which may differ by an ulp)."""
        mag = math.log((1 - self.crossover_prob) / self.crossover_prob)
        return torch.where(unpack_bits(flips), -mag, mag).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class AWGN:
    """Binary-input AWGN channel, BPSK mapping 0 -> +1, 1 -> -1.

    ``sigma`` is the per-dimension noise standard deviation, taken as
    float32 in the arithmetic (JAX traces it as a float32 scalar); Eb/N0 in
    dB for a rate-R code satisfies sigma^2 = 1 / (2 R 10^(EbN0_dB/10)).
    """

    sigma: float

    def _sigma(self, device) -> torch.Tensor:
        return torch.tensor(self.sigma, dtype=torch.float32, device=device)

    def transmit(self, bits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        """Soft channel outputs y = (1 - 2b) + sigma z (float32)."""
        z = torch.randn(bits.shape, generator=generator,
                        device=generator.device).to(bits.device)
        noise = z * self._sigma(bits.device)
        return (1.0 - 2.0 * bits.to(torch.float32)) + noise

    def llr(self, received: torch.Tensor) -> torch.Tensor:
        """Channel LLRs 2y/sigma^2 (positive favours bit 0)."""
        sigma = self._sigma(received.device)
        return 2.0 * received / (sigma * sigma)

    @staticmethod
    def sigma_from_ebn0_db(ebn0_db: float, rate: float) -> float:
        """sigma of Eb/N0 ``ebn0_db`` at code rate ``rate`` (float64; JAX
        evaluates the same formula in float32)."""
        return (2.0 * rate * 10.0 ** (ebn0_db / 10.0)) ** -0.5


def bec_packed_channel(erasure_prob: float, shape, *, seed: int,
                       offset: int = 0, device="cpu") -> torch.Tensor:
    """Packed erasure mask: int32[*shape], each of the 32 bits of a word an
    independent Bernoulli(erasure_prob) draw (1 = erased); the native input
    of the packed decoder.  Deterministic in (seed, offset)."""
    return bernoulli_packed(erasure_prob, shape, seed=seed, offset=offset,
                            device=device)


# ---------------------------------------------------------------------------
# Kernel A: AWGN LLR planes straight from Philox
# ---------------------------------------------------------------------------

def awgn_key(seed: int) -> tuple[int, int]:
    """Philox key of the AWGN noise for ``seed`` (module docstring)."""
    k0, k1 = philox_key(seed)
    return k0 ^ AWGN_KEY_TAG, k1


def _box_muller(a: torch.Tensor, b: torch.Tensor):
    """float64 Box-Muller pair of two int64 tensors of uint32 words."""
    u1 = (a.to(torch.float64) + 0.5) * 2.0 ** -32
    u2 = b.to(torch.float64) * 2.0 ** -32
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = 2.0 * math.pi * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _awgn_normals(total: int, key: tuple[int, int], offset: int,
                  device) -> torch.Tensor:
    """The float32 normals z of elements 0 .. total-1 (the kernel's draw,
    before sigma)."""
    g = torch.arange((total + 3) // 4, dtype=torch.int64, device=device)
    lanes = philox4x32_10((g & MASK32, g >> 32, offset & MASK32,
                           (offset >> 32) & MASK32), key)
    z0, z1 = _box_muller(lanes[0], lanes[1])
    z2, z3 = _box_muller(lanes[2], lanes[3])
    return torch.stack([z0, z1, z2, z3], 1).reshape(-1)[:total] \
        .to(torch.float32)


def _awgn_llr_plain(sigma: float, shape, key: tuple[int, int], offset: int,
                    device, tx=None) -> torch.Tensor:
    """Plain version of kernel A: the same Philox words and float64
    transform, then JAX's float32 steps."""
    z = _awgn_normals(math.prod(shape), key, offset, device).reshape(shape)
    ch = AWGN(sigma)
    noise = z * ch._sigma(device)
    if tx is None:
        return ch.llr(1.0 + noise)
    return ch.llr(torch.where(unpack_bits(tx), -1.0, 1.0) + noise)


def awgn_llr(sigma: float, shape, *, seed: int, offset: int = 0,
             device="cpu", tx=None) -> torch.Tensor:
    """float32[*shape] AWGN channel LLRs, noise standard deviation
    ``sigma``: deterministic in (seed, offset) by the scheme of the module
    docstring.  ``tx`` (int32[n, B // 32] packed, for shape (n, B), B a
    multiple of 32) is the transmitted codeword; None sends the all-zero
    codeword.  On a CUDA device kernel A writes the plane; on the CPU its
    plain version computes it."""
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"negative shape {shape}")
    if not 0 <= offset < (1 << 64):
        raise ValueError(f"offset {offset} outside [0, 2^64)")
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    if tx is not None:
        check_int32("tx", tx, 2)
        if len(shape) != 2 or shape[1] % 32 or \
                tuple(tx.shape) != (shape[0], shape[1] // 32):
            raise ValueError(f"tx {tuple(tx.shape)} is not the packed plane "
                             f"of an {shape} LLR plane")
    key = awgn_key(seed)
    device = torch.device(device)
    if tx is not None:
        if tx.device.type != device.type or device.index not in (
                None, tx.device.index):
            raise ValueError(f"tx on {tx.device}, LLRs asked on {device}")
        device = tx.device
    if not use_kernel(device):
        return _awgn_llr_plain(sigma, shape, key, offset, device, tx)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    launch("ldpc_awgn_llr", device, out.data_ptr(), out.numel(), key[0],
           key[1], offset & MASK32, offset >> 32, float(sigma),
           None if tx is None else tx.data_ptr())
    awgn_llr.launches += 1
    return out


awgn_llr.launches = 0
