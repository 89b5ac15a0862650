"""Build and bind the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one
process per source and all at once, and links the objects into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``_build/<hash>/`` beside the package, keyed by a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one
is reused.  The build runs at the first kernel launch, never at import:
importing the package needs neither ``nvcc`` nor a GPU.

Every C entry point returns ``cudaGetLastError()``; :func:`launch` raises
when it is not 0, so a refused launch is never silent.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIBRARY_NAME = "libldpc_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_LL = ctypes.c_longlong
#: a float argument must be declared, or ctypes passes a double
_F = ctypes.c_float
#: argtypes of each C entry point (pointers and the stream as void*)
SIGNATURES = {
    "ldpc_bernoulli_packed": (_P, _LL, _U, _U, _U, _U, ctypes.c_ulonglong,
                              _P),
    "ldpc_check_exactly_one": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ldpc_variable_or_update": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P),
    "ldpc_per_trial_counts": (_P, _P, _I, _I, _P),
    "ldpc_sample_regular_codes": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _U, _U, _U, _I, _LL, _P),
    "ldpc_sample_irregular_codes": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _I, _I, _I, _I, _I, _U, _U,
                                    _U, _I, _I, _LL, _P),
    "ldpc_gallager_check": (_P, _P, _I, _I, _I, _I, _P),
    "ldpc_gallager_variable": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P),
    "ldpc_gallager_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _P),
    "ldpc_erasure_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _P),
    "ldpc_erasure_decode_values": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _P),
    "ldpc_awgn_llr": (_P, _LL, _U, _U, _U, _U, _F, _P, _P),
    "ldpc_awgn_llr_check": (_P, _LL, _LL, _F, _I, _P),
    "ldpc_soft_posterior": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "ldpc_soft_check": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _F, _F, _P),
    "ldpc_encode_packed": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ldpc_check_exactly_one_xor": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _P),
    "ldpc_variable_or_adopt": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    "ldpc_qc_check_exactly_one": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _P),
    "ldpc_qc_variable_or": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P),
    "ldpc_qc_gallager_check": (_P, _P, _P, _I, _I, _I, _P),
    "ldpc_qc_gallager_variable": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _P),
    "ldpc_qc_soft_posterior": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _F, _P),
    "ldpc_qc_soft_check": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _F, _F, _P),
    "ldpc_peel_sequential": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _U, _U, _I, _P),
    "ldpc_edge_candidates": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ldpc_or_reduce_update": (_P, _P, _P, _I, _LL, _P),
}


def source_files() -> list[Path]:
    return sorted(p for p in SOURCE_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIBRARY_NAME


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile ``csrc/*.cu`` unless the hashed library exists.

    Returns ``(library path, seconds spent compiling)`` (0.0 when the
    library was already built).  Every source compiles in its own ``nvcc``
    process, all started together, then one ``nvcc`` links the objects.
    The library is written under a temporary name and renamed into place,
    so a concurrent or interrupted build never leaves a partial file where
    a loader would find it.
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=path.parent) as work:
        jobs, objects = [], []
        for src in (p for p in source_files() if p.suffix == ".cu"):
            objects.append(os.path.join(work, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objects[-1], str(src)]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
            elif verbose:
                print(out, flush=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(work, LIBRARY_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path, time.perf_counter() - start


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on PyTorch's current stream; raise if
    the tensors' ``device`` is not the current CUDA device (the kernel
    would run on the wrong card) or the launch reported a CUDA error.
    Checked rather than switched: a device guard costs host time on every
    launch of the decode loop."""
    if device.index is not None and device.index != \
            torch.cuda.current_device():
        raise ValueError(f"tensors on {device}, but the current CUDA device "
                         f"is cuda:{torch.cuda.current_device()}; use "
                         "torch.cuda.device() around the call")
    rc = getattr(load_library(), name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
