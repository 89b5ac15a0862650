"""Time the code samplers on the card as the engine launches them: K5
(``csrc/sample_regular_codes.cu``) and the irregular sampler
(``csrc/sample_irregular_codes.cu``), the ensemble chunks that sample their
codes with them, and edited designs of K5 that show where its time goes.

    python examples/time_samplers.py [--root DIR] [--designs] [--reps 10]
        [--out chiprun_out/time_samplers.json]

``--root DIR`` imports the package (and ``chip_smoke.py``'s helpers) from
DIR, an unpacked checkout of another commit, instead of this tree: the
samplers' public calls are the same there.  To compare two trees, run the
script once per tree in one chip call, in turns (other, this, this, other),
and compare the JSON files; each holds a digest of every sampled table, so
equal digests show that both trees drew the same codes.

Timed (CUDA events around single launches after a warm-up, mean of
``reps``): K5 with ``repair`` and ``raw`` at 768 codes of n = 10^4 (the
ensemble BEC and Gallager chunks), ``repair`` at 768 codes of n = 8192 (the
soft chunks), 32 codes of n = 2048 (the random-transmit ensemble chunk),
400 and 4,000 codes of n = 16,384 (the R-process experiment), ``reject``
at 32 codes of n = 1024; the irregular sampler with ``repair`` and ``raw``
at 768 codes of the BEC pair (lambda = x/3 + 2x^3/3, rho = x^5) and of the
Gallager pair (lambda = x^2/2 + x^3/2) at n = 10^4.  Beside them, one
launch of ``torch.rand(768, 30000).argsort(dim=1)``: a parallel random
permutation of the same size on the card, another function and another
stream.  The ensemble chunks (BEC, Gallager-A, irregular BEC and irregular
Gallager-A at n = 10^4, 768 codes of 32 trials): host clock over 3 chunks
after a warm-up, and the device time by kernel of one chunk.

``--designs`` (this tree only): the tree's K5 source with edits, each
compiled alone and launched in the shipped library's place, ``raw`` at 768
codes of n = 10^4: ``no_rounds`` (the shuffle's rounds removed: the
partners, the identity and the tables), ``no_partners`` (the partners' draw
removed too: the tables alone).  Their tables are wrong by design and are
not checked.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

N, CODES, DV, DC = 10_000, 768, 3, 6
LAM_BEC, LAM_GAL, RHO6 = [0, 1 / 3, 0, 2 / 3], [0, 0, 0.5, 0.5], \
    [0, 0, 0, 0, 0, 1.0]
ROUNDS_LOOP = "  int rounds = 0;\n  while (__syncthreads_or(pending)) {"
PARTNER_LOOP = "  for (int q = t; q <= (E - 1) >> 1; q += T) {"
DESIGNS = {
    "no_rounds": [(ROUNDS_LOOP, "  int rounds = 0;\n  pending = false;\n"
                                "  while (__syncthreads_or(pending)) {")],
    "no_partners": [(ROUNDS_LOOP, "  int rounds = 0;\n  pending = false;\n"
                                  "  while (__syncthreads_or(pending)) {"),
                    (PARTNER_LOOP, "  for (int q = E; q < 0; q += T) {")],
}


def digest(code) -> str:
    h = hashlib.sha256()
    for name in ("chk_to_var", "var_to_edge", "var_to_chk", "var_to_sock"):
        t = getattr(code, name, None)
        if t is not None:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(run, reps: int) -> float:
    run()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def build_designs(source_dir: Path, work: Path, signature) -> dict:
    """Each design's ldpc_sample_regular_codes, compiled in parallel."""
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild

    jobs = {}
    for name, edits in DESIGNS.items():
        src = work / name
        shutil.copytree(source_dir, src)
        text = (src / "sampler.cuh").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"design {name}: {old!r} not in source")
            text = text.replace(old, new)
        (src / "sampler.cuh").write_text(text)
        cmd = [kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o",
               str(src / "lib.so"), str(src / "sample_regular_codes.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"design {name}: nvcc failed\n{out[-3000:]}")
        fn = ctypes.CDLL(str(work / name / "lib.so")).ldpc_sample_regular_codes
        fn.argtypes, fn.restype = signature, ctypes.c_int
        entries[name] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--designs", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/time_samplers.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild
    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    out = {"root": str(root), "card": chip_smoke.smi_line(), "ms": {},
           "digest": {}}
    specs = {name: irregular.IrregularEnsembleSpec.from_lam_rho(
        N, lam, RHO6, device=dev) for name, lam in (("bec", LAM_BEC),
                                                     ("gallager", LAM_GAL))}
    cases = {
        "k5_repair_n10000_c768": lambda: ensemble.sample_codes(
            1, 0, CODES, N, DV, DC, "repair", device=dev),
        "k5_raw_n10000_c768": lambda: ensemble.sample_codes(
            1, 0, CODES, N, DV, DC, "raw", device=dev),
        "k5_repair_n8192_c768": lambda: ensemble.sample_codes(
            1, 0, CODES, 8192, DV, DC, "repair", device=dev),
        "k5_repair_n2048_c32": lambda: ensemble.sample_codes(
            1, 0, 32, 2048, DV, DC, "repair", device=dev),
        "k5_repair_n16384_c400": lambda: ensemble.sample_codes(
            7, 0, 400, 16_384, DV, DC, "repair", device=dev),
        "k5_repair_n16384_c4000": lambda: ensemble.sample_codes(
            7, 0, 4000, 16_384, DV, DC, "repair", device=dev),
        "k5_reject_n1024_c32": lambda: ensemble.sample_codes(
            1, 0, 32, 1024, DV, DC, "reject", device=dev),
        "irregular_bec_repair_c768": lambda: irregular.sample_irregular_codes(
            1, 0, CODES, specs["bec"], "repair", device=dev),
        "irregular_bec_raw_c768": lambda: irregular.sample_irregular_codes(
            1, 0, CODES, specs["bec"], "raw", device=dev),
        "irregular_gallager_repair_c768":
            lambda: irregular.sample_irregular_codes(
                3, 0, CODES, specs["gallager"], "repair", device=dev),
    }
    for name, run in cases.items():
        out["digest"][name] = digest(run())
        out["ms"][name] = timed(run, args.reps)
        print(f"{name}: {out['ms'][name]:.4f} ms", flush=True)
    out["ms"]["argsort_yardstick_768x30000"] = timed(
        lambda: torch.rand(CODES, 3 * N, device=dev).argsort(dim=1),
        args.reps)

    if args.designs:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=args.out.parent) as work:
            entries = build_designs(
                kbuild.SOURCE_DIR, Path(work),
                kbuild.SIGNATURES["ldpc_sample_regular_codes"])
            shipped = ensemble.launch
            for name, fn in entries.items():
                def launch(_name, _device, *a, fn=fn):
                    rc = fn(*a, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"design {name}: CUDA error {rc}")
                ensemble.launch = launch
                try:
                    out["ms"][f"design_{name}_raw_n10000_c768"] = timed(
                        cases["k5_raw_n10000_c768"], args.reps)
                finally:
                    ensemble.launch = shipped
            out["ms"]["design_shipped_raw_n10000_c768"] = timed(
                cases["k5_raw_n10000_c768"], args.reps)

    def config(**fields):
        return SimulationConfig(**{
            "n": N, "iterations": 50, "batch": 32 * CODES,
            "codes_per_chunk": CODES, "seed": 1, "dv": DV, "dc": DC,
            "code_mode": "ensemble", **fields})

    chunks = {
        "bec": config(channel_param=0.42),
        "gallager": config(channel="BSC", decoder="gallager",
                           channel_param=0.03),
        "bec_irregular": config(channel_param=0.42, lam=LAM_BEC, rho=RHO6),
        "gallager_irregular": config(channel="BSC", decoder="gallager",
                                     channel_param=0.04, lam=LAM_GAL,
                                     rho=RHO6)}
    kernels = {"sample_regular_codes": {"wrapper": ensemble.sample_codes},
               "sample_irregular_codes": {
                   "wrapper": irregular.sample_irregular_codes}}
    out["chunk_ms"], out["chunk_profile"] = {}, {}
    for name, cfg in chunks.items():
        fn = mc.make_chunk_fn(cfg, None, device=dev)
        int(fn(9).block_errors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in range(3):
            int(fn(idx).block_errors)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        out["chunk_ms"][name] = ms
        out["chunk_profile"][name] = json.loads(
            chip_smoke.device_time_breakdown(lambda: int(fn(4).block_errors),
                                             ms, kernels))
        print(f"chunk {name}: {ms:.3f} ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": out["card"], "ms": out["ms"],
                      "chunk_ms": out["chunk_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
