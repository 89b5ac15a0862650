"""Code storage in the JAX package's native npz format.

One ``.npz`` holds the socket table and the degrees (``chk_to_var``, ``n``,
``dv``, ``dc``), exactly as ``iib_project_ldpc_codes_tpu/models/store.py``
writes it, so a code saved by either package loads in the other.  numpy
only; the reference ``.npy`` export comes with a later slice.
"""

from __future__ import annotations

import numpy as np

from .code import LDPCCode, code_from_numpy


def save_code(code: LDPCCode, path: str) -> None:
    """Native compact format: one .npz with the socket table."""
    np.savez_compressed(path, chk_to_var=code.chk_to_var.cpu().numpy(),
                        n=code.n, dv=code.dv, dc=code.dc)


def load_code(path: str, device="cpu") -> LDPCCode:
    with np.load(path) as z:
        return code_from_numpy(z["chk_to_var"], n=int(z["n"]),
                               dv=int(z["dv"]), dc=int(z["dc"]),
                               device=device)
