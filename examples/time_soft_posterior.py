"""Time kernel B (the soft variable pass, ``csrc/soft_posterior.cu``) on the
card at the soft paths' headline shape, beside other designs of it and an
earlier tree's kernel B.

    python examples/time_soft_posterior.py [--parent DIR] [--designs a,b]
        [--reps 10] [--out .smoke_tmp/time_soft_posterior.json]

n = 8192, (3,6), 24,576 trials, as 768 codes of 32 trials (the ensemble
chunks) and as one code (the fixed paths), in float32, bfloat16 and int8,
through the wrapper ``ops/soft_bp.py::soft_posterior``:
  * ``shipped``: the tree's kernel (built by ``kernels/build.py``) with
    counts per code (what the decode loop asks for totals), per trial,
    and with nine codes in ten, or two in three at random, stopped;
  * each design of ``DESIGNS``: the tree's source with the listed edits,
    compiled alone into a library that the wrapper calls in the shipped
    one's place, counts per code and per trial, and with codes stopped as
    above;
  * with ``--parent DIR`` (an unpacked checkout of a commit whose
    ``ldpc_soft_posterior`` takes the 19 arguments of the kernel before its
    Hopper redesign: per-trial counts, 4 bytes a thread): that source
    alone, as is and with its count atomics removed.
Every variant's pm plane and counts are checked against the plain version
before they are timed.  Times are CUDA events around ``reps`` back-to-back
launches, in two passes (the variants in order, then reversed); the card's
name and power limit are printed beside them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild  # noqa
from iib_project_ldpc_codes_tpu_torch.models import ensemble  # noqa: E402
from iib_project_ldpc_codes_tpu_torch.ops import soft_bp  # noqa: E402
from iib_project_ldpc_codes_tpu_torch.utils.config import (  # noqa: E402
    SimulationConfig)

N, COLS, CODES, DV, DC = 8192, 24_576, 768, 3, 6
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the earlier kernel's entry point: 9 pointers, n_rows, n_out, table_rows,
#: dv, pad_pos, cols, cpc, dtype, scale, stream
PARENT_ARGTYPES = (_P,) * 9 + (_I,) * 8 + (_F, _P)
NO_ATOMICS = ("atomicAdd(counts + col0 + k, cnt[k])", "(void)0")
_ORDER = "const bool tiles_slowest = codes > 1 && cpc * elem < kSmallPiece;"
_ROWS = ("const int rows =\n      per_trial ? kTrialRows : tiles_slowest ? "
         "kTileRows : kBandRows;")
_STREAM = [
    ("store_lanes<T, V>(static_cast<T*>(a.pm) + row, out)",
     "ldpc::soft::store_lanes_streaming<T, V>(static_cast<T*>(a.pm) + row, "
     "out)"),
    ("load_lanes<uint32_t, U>(reinterpret_cast<const uint32_t*>(llr0 + row))",
     "ldpc::soft::load_lanes_streaming<uint32_t, U>("
     "reinterpret_cast<const uint32_t*>(llr0 + row))"),
    ("store_lanes<uint32_t, U>(\n          reinterpret_cast<uint32_t*>("
     "static_cast<int8_t*>(a.pm) + row), out)",
     "ldpc::soft::store_lanes_streaming<uint32_t, U>(\n          "
     "reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.pm) + row), out)")]


def _order(flag):
    return (_ORDER, f"const bool tiles_slowest = {flag};")


def _rows(trial, tile, band):
    """Runs of `trial` variables with per-trial counts, else `tile` in the
    tile order and `band` in the other."""
    return (_ROWS, f"const int rows = per_trial ? {trial} : "
                   f"tiles_slowest ? {tile} : {band};")


#: other designs of kernel B, as edits of the tree's source: one grid order
#: for every shape (tiles slowest, or a band of variables of every tile at a
#: time); other runs of variables a thread (per trial, in the tile order,
#: in the band order); the first design built (the band order, runs of 8);
#: pm (with the int8 channel LLRs) moved cache-streaming (evict first); the
#: table read socket-major, [n, dv, C] (the script passes such a copy to
#: this design), so that a warp's codes share the sectors of a socket
DESIGNS = {
    "socket_major": [
        ("a.table + static_cast<long long>(pl.code) * a.table_rows * a.dv;",
         "a.table + pl.code;"),
        ("s[p] = __ldg(tab + v * a.dv + p0 + p);",
         "s[p] = __ldg(tab + (static_cast<long long>(v) * a.dv + p0 + p) * "
         "a.codes);")],
    "tiles_slowest_always": [_order("true")],
    "tiles_fastest_always": [_order("false")],
    "band_rows2": [_rows("kTrialRows", "kTileRows", 2)],
    "band_rows8": [_rows("kTrialRows", "kTileRows", 8)],
    "tile_rows4": [_rows("kTrialRows", 4, "kBandRows")],
    "trial_rows2": [_rows(2, "kTileRows", "kBandRows")],
    "trial_rows16": [_rows(16, "kTileRows", "kBandRows")],
    "first_design": [_order("false"), _rows(8, 8, 8)],
    "streaming": _STREAM,
}


def _compile(src_dir: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o", str(out),
         str(src_dir / "soft_posterior.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_designs(names, work: Path) -> dict:
    """Each design's library, compiled in parallel: name -> the
    ldpc_soft_posterior entry point bound with the tree's signature."""
    jobs = {}
    for name in names:
        src = work / name
        shutil.copytree(kbuild.SOURCE_DIR, src)
        kernel = src / "soft_posterior.cu"
        text = kernel.read_text()
        for old, new in DESIGNS[name]:
            if old not in text:
                raise RuntimeError(f"design {name}: {old!r} not in the source")
            text = text.replace(old, new)
        kernel.write_text(text)
        jobs[name] = (src / "lib.so", _compile(src, src / "lib.so"))
    entries = {}
    for name, (lib, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            print(f"design {name}: nvcc failed, left out\n{out[-2000:]}",
                  flush=True)
            continue
        fn = ctypes.CDLL(str(lib)).ldpc_soft_posterior
        fn.argtypes = kbuild.SIGNATURES["ldpc_soft_posterior"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def parent_entries(parent: Path, work: Path) -> dict:
    """The earlier tree's ldpc_soft_posterior, compiled from its own csrc/
    (its soft.cuh and common.cuh), as is and without its count atomics."""
    jobs = {}
    for name, atomics in (("parent", True), ("parent_no_atomics", False)):
        src = work / name
        shutil.copytree(parent / "iib_project_ldpc_codes_tpu_torch" / "csrc",
                        src)
        kernel = src / "soft_posterior.cu"
        text = kernel.read_text()
        if not atomics:
            if NO_ATOMICS[0] not in text:
                raise RuntimeError(f"{kernel}: no count atomic to remove")
            kernel.write_text(text.replace(*NO_ATOMICS))
        jobs[name] = (src / "lib.so", _compile(src, src / "lib.so"))
    entries = {}
    for name, (lib, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        fn = ctypes.CDLL(str(lib)).ldpc_soft_posterior
        fn.argtypes, fn.restype = PARENT_ARGTYPES, ctypes.c_int
        entries[name] = fn
    return entries


def inputs(dtype, num, seed=0):
    """Planes of one round at the headline shape: channel LLRs, a message
    plane of a live decode's magnitudes, the codes' graph."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    llr = torch.randn((N, COLS), generator=gen, device="cuda") * 2.5 + 3.1
    msg = torch.randn((N * DV, COLS), generator=gen, device="cuda") * 6
    if dtype == torch.int8:
        llr0, msg = soft_bp._quantise(llr, 4.0), soft_bp._quantise(msg, 4.0)
    else:
        llr0, msg = llr, msg.to(dtype)
    if num == 1:
        code = ensemble.code_for_config(SimulationConfig(
            n=N, dv=DV, dc=DC, code_mode="fixed")).to("cuda")
    else:
        code = ensemble.sample_codes(1, 0, num, N, DV, DC, "repair",
                                     device="cuda")
    return llr0, msg, soft_bp._graph(code)


def timed(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    run()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check_rc(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"ldpc_soft_posterior: CUDA error {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--designs", default=",".join(DESIGNS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=".smoke_tmp/time_soft_posterior.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = chip_smoke.smi_line()
    kbuild.build()
    shipped = kbuild.load_library()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=os.path.dirname(args.out) or "."))
    designs = build_designs([d for d in args.designs.split(",") if d], work)
    parents = parent_entries(args.parent, work) if args.parent else {}

    def through(fn):
        """Run the wrapper with ``fn`` (None: the shipped library) as its
        ldpc_soft_posterior."""
        kbuild.load_library = (lambda: shipped) if fn is None else \
            (lambda: types.SimpleNamespace(ldpc_soft_posterior=fn))

    results = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8)):
        for num in (CODES, 1):
            llr0, msg, graph = inputs(dtype, num)
            table = graph.var_to_sock
            # socket-major [n, dv, C] under the code-major shape
            major = table.permute(1, 2, 0).contiguous().view(table.shape) \
                if num > 1 else table
            cpc = COLS // num
            ones = torch.ones(num, dtype=torch.int32, device="cuda")
            stopped = (torch.arange(num, device="cuda") % 10 == 0) \
                .to(torch.int32) if num > 1 else ones
            third = (torch.randperm(num, generator=torch.Generator()
                                    .manual_seed(3)) < num // 3) \
                .to(torch.int32).to("cuda")
            pm_ref = torch.empty_like(llr0, dtype=dtype)
            cnt_ref = torch.zeros(COLS, dtype=torch.int32, device="cuda")
            soft_bp._soft_posterior_plain(llr0, msg, table, ones, pm_ref,
                                          cnt_ref, pad_pos=graph.pad_pos)
            per_code = cnt_ref.reshape(num, -1).sum(1, dtype=torch.int32)
            variants = {}

            def tree(fn, tab, active, width):
                pm = torch.empty_like(pm_ref)
                counts = torch.zeros(width, dtype=torch.int32, device="cuda")

                def run():
                    through(fn)
                    soft_bp.soft_posterior(llr0, msg, tab, active, pm,
                                           counts, pad_pos=graph.pad_pos)
                return run, pm, counts

            variants["shipped"] = tree(None, table, ones, num)
            variants["shipped_per_trial"] = tree(None, table, ones, COLS)
            if num > 1:
                variants["shipped_tenth_active"] = tree(None, table, stopped,
                                                        num)
                variants["shipped_third_active"] = tree(None, table, third,
                                                        num)
            for dname, fn in designs.items():
                tab = major if dname == "socket_major" else table
                variants[dname] = tree(fn, tab, ones, num)
                variants[dname + "_per_trial"] = tree(fn, tab, ones, COLS)
                if num > 1:
                    variants[dname + "_tenth_active"] = tree(fn, tab, stopped,
                                                             num)
                    variants[dname + "_third_active"] = tree(fn, tab, third,
                                                             num)
            for pname, fn in parents.items():
                pm = torch.empty_like(pm_ref)
                counts = torch.zeros(COLS, dtype=torch.int32, device="cuda")
                for label, active in (("", ones), ("_tenth_active", stopped),
                                      ("_third_active", third)):
                    if label and num == 1:
                        continue
                    run = (lambda fn=fn, pm=pm, counts=counts, active=active:
                           _check_rc(fn(
                               llr0.data_ptr(), msg.data_ptr(),
                               table.data_ptr(), active.data_ptr(),
                               pm.data_ptr(), counts.data_ptr(), None, None,
                               None, N, 0, table.shape[-2], DV,
                               graph.pad_pos, COLS, cpc,
                               soft_bp._DTYPES[dtype], 4.0,
                               torch.cuda.current_stream().cuda_stream)))
                    variants[pname + label] = (run, pm, counts)
            # each variant once against the plain version (all codes on)
            for vname, (run, pm, counts) in variants.items():
                if vname.endswith("_active"):
                    continue
                counts.zero_()
                run()
                torch.cuda.synchronize()
                want = per_code if counts.shape[0] == num else cnt_ref
                if not (torch.equal(pm, pm_ref) and (
                        vname == "parent_no_atomics"
                        or torch.equal(counts, want))):
                    raise AssertionError(f"{name} {num} {vname} differs "
                                         "from the plain version")
            times = {v: [] for v in variants}
            order = list(variants)
            for sweep in (order, order[::-1]):
                for vname in sweep:
                    times[vname].append(timed(variants[vname][0], args.reps))
            through(None)
            moved = chip_smoke.nbytes(llr0, msg, table, ones, pm_ref,
                                      per_code)
            key = f"{name}_{'768' if num > 1 else 'one'}"
            results[key] = dict(
                bound_ms=chip_smoke.bound(moved)["bound_ms"],
                **{v: dict(ms=sum(t) / len(t), runs=t)
                   for v, t in times.items()})
            print(key, json.dumps({v: round(r["ms"], 4) if isinstance(r, dict)
                                   else r for v, r in results[key].items()}),
                  flush=True)
            del variants, llr0, msg, graph, table, major, pm_ref
            torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, shape=dict(n=N, cols=COLS, codes=CODES,
                                            dv=DV), results=results),
                  f, indent=1)
    shutil.rmtree(work, ignore_errors=True)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
