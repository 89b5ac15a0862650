"""PyTorch/CUDA port of the LDPC Monte Carlo framework.

A second package beside ``iib_project_ldpc_codes_tpu`` (the JAX reference),
with the same module names.  It imports ``torch`` and numpy and never
``jax``.  Plain functions on tensors take an explicit ``device``; random
numbers come from explicit ``torch.Generator``s (code sampling) or explicit
Philox seeds (channels), never from global RNG state.

The hot loops are hand-written CUDA kernels for Hopper (``csrc/``, built
with ``nvcc`` at first use, see ``kernels/build.py``); each has a plain
PyTorch version beside it, which runs on CPU tensors.
"""

__version__ = "0.1.0"

from .models.code import LDPCCode, code_from_checks, code_from_numpy, \
    dense_parity_check
from .models.ensemble import sample_code
from .ops.channels import AWGN, BEC, BSC, ERASURE

__all__ = [
    "LDPCCode",
    "code_from_checks",
    "code_from_numpy",
    "dense_parity_check",
    "sample_code",
    "AWGN",
    "BEC",
    "BSC",
    "ERASURE",
]
