"""Time kernel A (``csrc/awgn_llr.cu``, the AWGN LLR planes) and K4
(``csrc/per_trial_counts.cu``, the per-trial counts) on the card, with the
paths they serve: the ensemble int8 AWGN chunk (A once a chunk) and the
``_traj`` BEC decode (K4 once a round).

    python examples/time_channel_counts.py [--root DIR] [--reps 10]
        [--designs] [--out results/time_channel_counts.json]

``--root DIR`` imports the package from DIR, an unpacked checkout of
another commit, instead of this tree (the timing helpers stay this tree's
``chip_smoke.py``'s).  Every call below is a public entry point of the
package or a helper of ``parallel/montecarlo.py`` that both trees have.  To
compare two trees, run the script once per tree in one chip call, in turns
(other, this, this, other), and compare the JSON files: each holds a digest
of every output, so equal digests show that both trees computed the same
thing.

Timed, at ``chip_smoke.py``'s shapes: A's zero and tx forms at n = 8192,
24,576 trials (phase 18's plane, sigma 0.80, seed 7, offset 3; tx an
information plane) by torch.profiler (``device_ms``, the kernel alone) and
by CUDA events around one call (``ms``); K4 on phase 4's erasure plane (n =
10^4, W = 768, eps = 0.42) and on an n = 10^6, W = 48 plane; each with its
registers (cuobjdump ``-res-usage``) and the SASS counts of its main loop
(``chip_smoke.sass_loop_counts``: FP64 and quarter-rate instructions a
trip of A's loop, integer instructions and loads of K4's innermost loop),
and the card's SM clock and power sampled by ``nvidia-smi`` while a queue
of A's launches runs.  The
``_traj`` decode ((3,6), n = 10^4, W = 768, eps = 0.42, codewords, 50
rounds) by events around whole decodes, with its device time by kernel and
idle share; the ensemble int8 min-sum AWGN chunk (n = 8192, 768 codes of
32 trials, sigma of Eb/N0 = 1.5 dB) by the host clock over 3 chunks after
a warm-up, with its device time by kernel and idle share.

``--designs``: the root tree's A source with edits (written for the source
before the redesign, ``--root`` an unpacked parent), each compiled alone
with nvcc into a library of its own, loaded with ctypes and launched with
the wrapper's arguments: ``no_sincos`` (sin and cos replaced by constants),
``no_logsqrt`` (r = sqrt(-2 ln u1) replaced by a constant), ``no_fdiv``
(the float32 division by sigma^2 replaced by a product), ``no_fp64`` (both
float64 parts), ``philox_store`` (all three: the Philox block, the float32
steps and the store), and ``shipped`` (no edit).  An edit whose text the
source lacks is reported and skipped.  Their planes are wrong by design and
are not checked; each gets its device time, registers, SASS counts and SM
clock.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

N_SOFT, COLS_SOFT, CODES_SOFT, SIGMA = 8192, 24_576, 768, 0.80
N_BIG, W_BIG = 1_000_000, 48
SINCOS = "  sincos(theta, &s, &c);"
LOGSQRT = "  const double r = sqrt(-2.0 * log(u1));"
FDIV = "  return __fdiv_rn(__fmul_rn(2.0f, y), sigma_sq);"
DESIGNS = {
    "shipped": [],
    "no_sincos": [(SINCOS, "  s = 0.6;\n  c = 0.8;")],
    "no_logsqrt": [(LOGSQRT, "  const double r = 1.25;")],
    "no_fdiv": [(FDIV, "  return __fmul_rn(__fmul_rn(2.0f, y), sigma_sq);")],
    "no_fp64": [(SINCOS, "  s = 0.6;\n  c = 0.8;"),
                (LOGSQRT, "  const double r = 1.25;")],
    "philox_store": [(SINCOS, "  s = 0.6;\n  c = 0.8;"),
                     (LOGSQRT, "  const double r = 1.25;"),
                     (FDIV, "  return __fmul_rn(__fmul_rn(2.0f, y), "
                            "sigma_sq);")],
}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def clocks_during(run, count: int) -> str:
    """nvidia-smi's SM clock, power draw and limit, read while ``count``
    calls of ``run()`` queued on the card run."""
    for _ in range(count):
        run()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return line


def build_designs(source: Path, work: Path, nvcc: str, flags) -> dict:
    """Each design's library, compiled in parallel: {name: path}."""
    jobs = {}
    for name, edits in DESIGNS.items():
        text = (source / "awgn_llr.cu").read_text()
        missing = [old for old, _ in edits if old not in text]
        if missing:
            print(f"design {name}: skipped, the source lacks {missing}",
                  flush=True)
            continue
        for old, new in edits:
            text = text.replace(old, new)
        src = work / name
        shutil.copytree(source, src)
        (src / "awgn_llr.cu").write_text(text)
        cmd = [nvcc, *flags, "-shared", "-o", str(src / "lib.so"),
               str(src / "awgn_llr.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"design {name}: nvcc failed\n{out[-3000:]}")
        libs[name] = work / name / "lib.so"
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--designs", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=Path("results/time_channel_counts.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # this tree's helpers (timing, profiling, SASS counts, the card's line),
    # then the package of the tree under test
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild
    from iib_project_ldpc_codes_tpu_torch.models import encode, ensemble
    from iib_project_ldpc_codes_tpu_torch.ops import (bitops, channels,
                                                      erasure_bp, soft_bp)
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    usage = cs._res_usage()
    out = {"root": str(root), "card": cs.smi_line(), "awgn_llr": {},
           "per_trial_counts": {}, "digest": {}, "resources": {},
           "sass": {}, "decode_ms": {}, "profile": {}, "chunk_ms": {}}

    def resources(kernel: str, library=None):
        names = (cs._res_usage(library) if library else usage)
        return {name: cs._resource_fields(text)
                for name, text in names.items() if kernel in name}

    def sass(kernel: str, library=None, innermost=False):
        counts = cs.sass_loop_counts(kernel, library, innermost)
        counts.pop("span")
        return counts

    def a_kernel(library=None):
        """A's main instantiation: no codeword plane and, in trees that
        have the choice, the division by products."""
        names = cs._res_usage(library) if library else usage
        return "awgn_llr_kernelILb0ELb1E" if any(
            "awgn_llr_kernelILb0ELb1E" in k for k in names) \
            else "awgn_llr_kernelILb0E"

    # -- kernel A: zero and tx forms ------------------------------------------
    shape = (N_SOFT, COLS_SOFT)
    tx = bitops.info_planes(N_SOFT, COLS_SOFT // 32, seed=2, device=dev)
    forms = {"zero": lambda: channels.awgn_llr(SIGMA, shape, seed=7,
                                               offset=3, device=dev),
             "tx": lambda: channels.awgn_llr(SIGMA, shape, seed=7, offset=3,
                                             device=dev, tx=tx)}
    for form, run in forms.items():
        out["digest"][f"awgn_{form}"] = digest(run())
        row = {"device_ms": cs.device_ms(run, "awgn_llr_kernel",
                                         reps=args.reps),
               "ms": cs.time_ms(run, reps=args.reps),
               "clocks": clocks_during(run, 400),
               **cs.bound(COLS_SOFT * N_SOFT * 4)}
        out["awgn_llr"][form] = row
        print(f"A {form}: {json.dumps(row)}", flush=True)
    out["resources"]["awgn_llr"] = resources("awgn_llr_kernel")
    out["sass"]["awgn_llr"] = sass(a_kernel())
    print(f"A: {json.dumps(out['resources']['awgn_llr'])} "
          f"{json.dumps(out['sass']['awgn_llr'])}", flush=True)

    if args.designs:
        key = channels.awgn_key(7)
        plane = torch.empty(shape, dtype=torch.float32, device=dev)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=args.out.parent) as work:
            libs = build_designs(kbuild.SOURCE_DIR, Path(work),
                                 kbuild.find_nvcc(), kbuild.NVCC_FLAGS)
            import ctypes
            for name, lib in libs.items():
                fn = ctypes.CDLL(str(lib)).ldpc_awgn_llr
                fn.argtypes = list(kbuild.SIGNATURES["ldpc_awgn_llr"])
                fn.restype = ctypes.c_int

                def run(fn=fn):
                    rc = fn(plane.data_ptr(), plane.numel(), key[0], key[1],
                            3, 0, SIGMA, None,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"design {name}: CUDA error {rc}")

                row = {"device_ms": cs.device_ms(run, "awgn_llr_kernel",
                                                 reps=args.reps),
                       "clocks": clocks_during(run, 400),
                       "resources": resources("awgn_llr_kernel", lib),
                       "sass": sass(a_kernel(lib), lib)}
                if name == "shipped":
                    row["digest"] = digest(plane)
                out.setdefault("designs", {})[name] = row
                print(f"design {name}: {json.dumps(row)}", flush=True)
        del plane

    # -- K4 at phase 4's plane and at n = 10^6, W = 48 ------------------------
    planes = {
        "n1e4_w768": bitops.bernoulli_packed(cs.EPS_FULL,
                                             (cs.N_FULL, cs.WORDS_FULL),
                                             seed=7, offset=3, device=dev),
        "n1e6_w48": bitops.bernoulli_packed(cs.EPS_FULL, (N_BIG, W_BIG),
                                            seed=38, device=dev)}
    for label, plane in planes.items():
        def run(plane=plane):
            return bitops.per_trial_counts(plane)

        counts = run()
        check = torch.equal(counts, bitops._per_trial_counts_plain(plane))
        out["digest"][f"k4_{label}"] = digest(counts)
        row = {"device_ms": cs.device_ms(run, "per_trial_counts_kernel",
                                         reps=args.reps),
               "ms": cs.time_ms(run, reps=args.reps), "equal_plain": check,
               **cs.bound(cs.nbytes(plane, counts))}
        out["per_trial_counts"][label] = row
        print(f"K4 {label}: {json.dumps(row)}", flush=True)
    out["resources"]["per_trial_counts"] = resources(
        "per_trial_counts_kernel")
    out["sass"]["per_trial_counts"] = sass("per_trial_counts_kernel",
                                           innermost=True)
    print(f"K4: {json.dumps(out['resources']['per_trial_counts'])} "
          f"{json.dumps(out['sass']['per_trial_counts'])}", flush=True)
    del planes

    # -- the _traj decode at S2 -----------------------------------------------
    cfg = SimulationConfig(channel_param=cs.EPS_FULL, n=cs.N_FULL, dv=cs.DV,
                           dc=cs.DC, code_mode="fixed", code_number=1,
                           iterations=cs.ITERS, batch=32 * cs.WORDS_FULL,
                           seed=1, max_block_errors=10**9)
    code = ensemble.code_for_config(cfg).to(dev)
    erased = bitops.bernoulli_packed(cs.EPS_FULL, (cs.N_FULL, cs.WORDS_FULL),
                                     seed=7, offset=3, device=dev)
    enc = encode.code_encoder_planes(code)
    cw = encode.encode_packed(enc, bitops.info_planes(
        enc.k, cs.WORDS_FULL, seed=1, offset=0, device=dev))
    wrappers = {k: {"wrapper": getattr(m, k)} for m, k in (
        (bitops, "per_trial_counts"), (erasure_bp, "check_exactly_one_xor"),
        (erasure_bp, "variable_or_adopt"), (channels, "awgn_llr"),
        (soft_bp, "soft_posterior"), (soft_bp, "soft_check"),
        (ensemble, "sample_codes"))}
    # the sampler's kernel is named after its source
    wrappers["sample_regular_codes"] = wrappers.pop("sample_codes")

    def traj():
        return erasure_bp.bp_decode_packed_traj(code, erased, cw, cs.ITERS)[0]

    res = traj()
    out["digest"]["traj"] = digest(res.known, res.val, res.error_totals)
    ms = cs.time_ms(traj, reps=args.reps)
    out["decode_ms"]["traj"] = ms
    out["profile"]["traj"] = json.loads(cs.device_time_breakdown(
        lambda: traj().iterations, ms, wrappers))
    print(f"traj: {ms:.3f} ms, {json.dumps(out['profile']['traj'])}",
          flush=True)
    del code, erased, enc, cw, res

    # -- the ensemble int8 AWGN chunk -----------------------------------------
    chunk_cfg = SimulationConfig(
        n=N_SOFT, iterations=cs.ITERS, batch=COLS_SOFT,
        codes_per_chunk=CODES_SOFT, seed=1, dv=cs.DV, dc=cs.DC,
        code_mode="ensemble", channel="AWGN", decoder="minsum",
        soft_msg_dtype="int8",
        channel_param=channels.AWGN.sigma_from_ebn0_db(1.5, 0.5))
    fn = mc.make_chunk_fn(chunk_cfg, None, device=dev)
    int(fn(9).block_errors)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = [int(fn(idx).block_errors) for idx in range(3)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    out["chunk_ms"]["awgn_int8_ensemble"] = ms
    out["digest"]["awgn_int8_ensemble"] = digest(torch.tensor(blocks))
    out["profile"]["awgn_int8_ensemble"] = json.loads(
        cs.device_time_breakdown(lambda: int(fn(4).block_errors), ms,
                                 wrappers))
    print(f"int8 AWGN chunk: {ms:.3f} ms, "
          f"{json.dumps(out['profile']['awgn_int8_ensemble'])}", flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "awgn_llr",
                                          "per_trial_counts", "decode_ms",
                                          "chunk_ms", "digest")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
