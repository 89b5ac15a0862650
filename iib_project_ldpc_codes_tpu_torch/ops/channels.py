"""Channels: the BEC and the BSC, in oracle form and packed form.

The canonical alphabet is the JAX package's: bits in {0,1}, erasure = 2
(``ERASURE``).  Packed planes (32 trials per int32 word) of either channel
come from K1 (``ops/bitops.py::bernoulli_packed``): erasures on the BEC,
flips against the all-zero codeword on the BSC.  AWGN comes with the soft
decoders.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .bitops import bernoulli_packed

ERASURE = 2  # sentinel in the {0,1,2} erasure alphabet


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


def bec_packed_channel(erasure_prob: float, shape, *, seed: int,
                       offset: int = 0, device="cpu") -> torch.Tensor:
    """Packed erasure mask: int32[*shape], each of the 32 bits of a word an
    independent Bernoulli(erasure_prob) draw (1 = erased); the native input
    of the packed decoder.  Deterministic in (seed, offset)."""
    return bernoulli_packed(erasure_prob, shape, seed=seed, offset=offset,
                            device=device)
