"""Time P1, the sequential peel (``csrc/peel_sequential.cu``), on the card,
and the R-process experiment that runs it.

    python examples/time_peel.py [--root DIR] [--reps 5]
        [--out results/time_peel.jsonl]

Without ``--root`` the script times this tree once.  With ``--root DIR``
(an unpacked checkout of another commit, e.g. the parent) it runs itself
four times, each in a fresh process: DIR, this tree, this tree, DIR, and
prints one JSON line a run; each run imports its tree's package (the
timing helpers stay this tree's ``chip_smoke.py``'s) and builds its own
kernels.  Every call is a public entry point that both trees have, so the
digests of the outputs show that both computed the same thing.

Shapes (``chip_smoke.py`` phase 33's): 400 and 4,000 fresh (3,6) codes of
n = 16,384, one trial each, erasures at eps = 0.42 (``bernoulli_packed``
seed 7), ``peel_decode_batch(..., seed=7)``; the irregular family lambda =
x/3 + 2x^3/3, rho = x^5 at 400 codes.  For each: P1's device time
(torch.profiler, the kernel alone, mean of ``reps``), CUDA events around
the whole call, the longest trial's peels and the ms a step (device time
over them), the form the wrapper launched (``peel_sequential.form``; None
in a tree that has one form), and the bytes bound (tables, erasures and
outputs moved once at 3.35 TB/s).  Where the wrapper takes ``form``, every
form is timed on the same inputs.  Then each P1 function's registers,
stack and local memory (cuobjdump of the tree's library), and the
R-process experiment (``peeling_scaling_experiment(16384, 3, 6, 0.42,
repeats, seed=1)``) at 400 and 4,000 repeats: wall time (host clock, mean
of 2 after a warm-up) and P1's device time in one traced run, so its
share of the wall time.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
N, EPS, SEED = 16_384, 0.42, 7
LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
CASES = (("regular", 400), ("regular", 4000), ("irregular", 400))
REPEATS = (400, 4000)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def peel_device_ms(run, reps: int) -> float:
    """P1's device time (every kernel whose name holds "peel") over
    ``reps`` calls of ``run()``, mean per call, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "peel" in e.name]
    return sum(times) / reps / 1e3 if times else float("nan")


def resources(library: Path) -> dict:
    from iib_project_ldpc_codes_tpu_torch.kernels.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {name: {k.lower(): int(v) for k, v in
                   (kv.split(":") for kv in usage.split())}
            for name, usage in re.findall(
                r"Function (\S*peel\S*):\s*(REG:\d+ STACK:\d+ SHARED:\d+ "
                r"LOCAL:\d+)", text)}


def one_tree(tree: Path, reps: int) -> dict:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(tree))
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild
    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, peeling
    from iib_project_ldpc_codes_tpu_torch.utils import experiments

    dev = torch.device("cuda")
    kbuild.build()
    forms = getattr(peeling, "PEEL_FORMS", None) \
        if "form" in inspect.signature(peeling.peel_sequential).parameters \
        else None
    out = {"root": str(tree), "card": cs.smi_line(), "p1": {},
           "resources": resources(kbuild.library_path()), "experiment": {}}
    for fam, trials in CASES:
        if fam == "regular":
            codes = ensemble.sample_codes(SEED, 0, trials, N, 3, 6,
                                          device=dev)
        else:
            spec = irregular.IrregularEnsembleSpec.from_lam_rho(
                N, LAM, RHO, device=dev)
            codes = irregular.sample_irregular_codes(SEED, 0, trials, spec,
                                                     device=dev)
        erased = bitops.unpack_bits(bitops.bernoulli_packed(
            EPS, (trials, (N + 31) // 32), seed=SEED, device=dev))[:, :N] \
            .contiguous()
        rx = torch.where(erased, 2, 0)

        def run():
            return peeling.peel_decode_batch(codes, rx, seed=SEED)

        res = run()
        torch.cuda.synchronize()
        peels = int((res.one_degree_evolution > 0).sum(1).max())
        chk, var, n, m = peeling._tables(codes)
        row = {"form": getattr(peeling.peel_sequential, "form", None),
               "digest": digest(res.unresolved, res.one_degree_evolution,
                                res.steps, res.num_erasures),
               "longest_peels": peels,
               "failures": int((~res.success).sum()),
               "device_ms": peel_device_ms(run, reps),
               "ms": cs.time_ms(run, reps=reps),
               **cs.bound(cs.nbytes(chk, var, erased, res.unresolved,
                                    res.one_degree_evolution, res.steps,
                                    res.num_erasures))}
        row["ms_a_step"] = row["device_ms"] / peels
        for form in forms or ():
            def run_form(form=form):
                return peeling.peel_sequential(chk, var, erased, n, m, SEED,
                                               n, form=form)
            got = run_form()
            torch.cuda.synchronize()
            dms = peel_device_ms(run_form, reps)
            row[f"form_{form}"] = {
                "device_ms": dms, "ms_a_step": dms / peels,
                "digest": digest(*got),
                "equal": all(torch.equal(a, b) for a, b in zip(got, (
                    res.unresolved, res.one_degree_evolution, res.steps,
                    res.num_erasures)))}
        out["p1"][f"{fam}_{trials}"] = row
        print(f"{tree.name} P1 {fam} {trials}: {json.dumps(row)}",
              flush=True)
        del codes, erased, rx, res, chk, var
        torch.cuda.empty_cache()

    def experiment(repeats):
        return experiments.peeling_scaling_experiment(
            N, 3, 6, EPS, repeats=repeats, seed=1, device=dev)

    experiment(REPEATS[0])                     # warm-up
    for repeats in REPEATS:
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = experiment(repeats)
            walls.append(time.perf_counter() - t0)
        wall_ms = sum(walls) / len(walls) * 1e3
        p1_ms = peel_device_ms(lambda: experiment(repeats), 1)
        out["experiment"][repeats] = {
            "wall_ms": wall_ms, "walls_ms": [w * 1e3 for w in walls],
            "p1_device_ms": p1_ms, "p1_share": p1_ms / wall_ms,
            "failure_rate": res.failure_rate,
            "digest": digest(torch.tensor(res.sizes_at_failure))}
        print(f"{tree.name} experiment {repeats}: "
              f"{json.dumps(out['experiment'][repeats])}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=None,
                    help="another tree: run it, this, this, it")
    ap.add_argument("--tree", type=Path, default=HERE,
                    help="the tree one run imports (default: this one)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=Path("results/time_peel.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.root is None:
        rows = [one_tree(args.tree.resolve(), args.reps)]
    else:
        rows = []
        for tree in (args.root, HERE, HERE, args.root):
            proc = subprocess.run(
                [sys.executable, __file__, "--tree", str(tree.resolve()),
                 "--reps", str(args.reps), "--out", "-"],
                capture_output=True, text=True, timeout=1500)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode != 0:
                print(proc.stdout[-4000:])
                return proc.returncode
            rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print("\n".join(proc.stdout.strip().splitlines()[:-1]),
                  flush=True)
    if str(args.out) == "-":
        print(json.dumps(rows[0]))
        return 0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    for row in rows:
        print(json.dumps({"root": row["root"], "card": row["card"],
                          "p1": {k: {f: v[f] for f in ("form", "device_ms",
                                                       "ms_a_step", "digest")}
                                 for k, v in row["p1"].items()},
                          "experiment": row["experiment"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
