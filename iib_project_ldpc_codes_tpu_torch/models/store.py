"""Code storage in the JAX package's native npz format.

One ``.npz`` holds the socket table and the degrees (``chk_to_var``, ``n``,
``dv``, ``dc``), exactly as ``iib_project_ldpc_codes_tpu/models/store.py``
writes it, so a code saved by either package loads in the other.  A
quasi-cyclic code is stored as its base table, shifts and lift size
(``base_chk``, ``shifts``, ``Z``, ``nb``, ``irregular``, ``mb``, ``dv``,
``dc``: a few KB at any n), in JAX's fields too.  numpy only; the
reference ``.npy`` export comes with a later slice.
"""

from __future__ import annotations

import numpy as np

from .code import LDPCCode, code_from_numpy
from .qc import (IrregularQCLDPCCode, irregular_qc_code_from_numpy,
                 qc_code_from_numpy)


def save_code(code: LDPCCode, path: str) -> None:
    """Native compact format: one .npz with the socket table."""
    np.savez_compressed(path, chk_to_var=code.chk_to_var.cpu().numpy(),
                        n=code.n, dv=code.dv, dc=code.dc)


def load_code(path: str, device="cpu") -> LDPCCode:
    with np.load(path) as z:
        return code_from_numpy(z["chk_to_var"], n=int(z["n"]),
                               dv=int(z["dv"]), dc=int(z["dc"]),
                               device=device)


def save_qc_code(code, path: str) -> None:
    """Persist a quasi-cyclic code (:class:`.qc.QCLDPCCode` or
    :class:`.qc.IrregularQCLDPCCode`) as base table + shifts + lift size,
    the compact form standards publish."""
    np.savez_compressed(
        path, base_chk=code.base_chk.cpu().numpy(),
        shifts=code.shifts.cpu().numpy(), Z=code.Z, nb=code.nb,
        irregular=isinstance(code, IrregularQCLDPCCode),
        mb=getattr(code, "mb", 0), dv=getattr(code, "dv", 0),
        dc=getattr(code, "dc", 0))


def load_qc_code(path: str, device="cpu"):
    """The QC code of an npz written by :func:`save_qc_code` or by the JAX
    package's, of the class the file names."""
    with np.load(path) as z:
        if bool(z["irregular"]):
            return irregular_qc_code_from_numpy(
                z["base_chk"], z["shifts"], Z=int(z["Z"]), nb=int(z["nb"]),
                mb=int(z["mb"]), device=device)
        return qc_code_from_numpy(
            z["base_chk"], z["shifts"], Z=int(z["Z"]), nb=int(z["nb"]),
            dv=int(z["dv"]), dc=int(z["dc"]), device=device)
