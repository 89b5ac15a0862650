"""Binary erasure channel: the {0,1,2} oracle form and the packed form.

The canonical alphabet is the JAX package's: bits in {0,1}, erasure = 2
(``ERASURE``).  BSC and AWGN come with the decoders that use them.
"""

from __future__ import annotations

import dataclasses

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


def bec_packed_channel(erasure_prob: float, shape, *, seed: int,
                       offset: int = 0, device="cpu") -> torch.Tensor:
    """Packed erasure mask: int32[*shape], each of the 32 bits of a word an
    independent Bernoulli(erasure_prob) draw (1 = erased); the native input
    of the packed decoder.  Deterministic in (seed, offset)."""
    return bernoulli_packed(erasure_prob, shape, seed=seed, offset=offset,
                            device=device)
