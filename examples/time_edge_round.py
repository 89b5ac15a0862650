"""Time the gather passes of the edge-sharded erasure-BP round on the card:
K2 ``check_exactly_one`` (``csrc/check_exactly_one.cu``) on a rank's check
rows and X1 ``edge_candidates`` (``csrc/edge_candidates.cu``), K2 on the
fixed path, and the whole n = 10^6 edge decode and chunk.

    python examples/time_edge_round.py [--root DIR] [--reps 10]
        [--out results/time_edge_round.json]

``--root DIR`` imports the package from DIR, an unpacked checkout of
another commit, instead of this tree (the timing helpers stay this tree's
``chip_smoke.py``'s).  The passes' public calls are the same in both.  To compare two trees,
run the script once per tree in one chip call, in turns (other, this,
this, other), and compare the JSON files: each holds a digest of every
pass's outputs, so equal digests show that both trees computed the same
thing.  Each wrapper's launched words a thread (``.vec``, None where a
tree's wrapper keeps none) are kept under ``vec``.

Shapes (``chip_smoke.py``'s phases 38-40): the fixed (3,6) code of n =
10^6 (m = 500,000) at W = 48 (1,536 trials), eps = 0.42, the checks split
over D = 1, 2 and 4 ranks; K2 runs on rank 0's rows, X1 on its summary.
Each runs on two states of the decode: two rounds in (``r2``, phase 38's)
and after ``LATER`` rounds.  The fixed path's K2: one code at n = 10^4, W
= 768, and 768 codes of one word each (the batched layout), two rounds
in.  Timed after a warm-up, mean of ``reps``, by CUDA events around single
launches (``ms``: what a caller waits, the wrapper's host work included)
and by torch.profiler (``device_ms``: the kernel alone).  The decodes: the
edge-sharded and the unsharded K2/K3 decode of 50 rounds at n = 10^6, by
CUDA events around whole decodes (host loop included) and the device time
by kernel of one decode; the chunk: phase 40's edge-sharded chunk
(channel, decode, counts, one host read) by the host clock over 2 chunks
after a warm-up, and its device time by kernel.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

#: the later state: rounds run before it (at eps = 0.42 the n = 10^6 decode
#: stops after about 34 rounds; most erasures are left until round 20)
LATER = 16


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path,
                    default=Path("results/time_edge_round.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # this tree's helpers (timing, profiling, the card's line, the shapes),
    # then the package of the tree under test
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild
    from iib_project_ldpc_codes_tpu_torch.models import ensemble
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    out = {"root": str(root), "card": cs.smi_line(), "ms": {},
           "device_ms": {}, "digest": {}, "vec": {}}

    def measure(key, run, kernel):
        out["ms"][key] = cs.time_ms(run, reps=args.reps)
        out["device_ms"][key] = cs.device_ms(run, kernel, reps=args.reps)
        print(f"{key}: {out['ms'][key]:.4f} ms, device "
              f"{out['device_ms'][key]:.4f} ms", flush=True)


    def edge_cfg(**kw):
        return SimulationConfig(**{
            "channel_param": cs.EPS_FULL, "n": cs.N_EDGE, "dv": cs.DV,
            "dc": cs.DC, "iterations": cs.ITERS, "batch": 32 * cs.W_EDGE,
            "num_tests": 2 * 32 * cs.W_EDGE, "seed": 1, "code_mode": "fixed",
            "code_number": 1, "max_block_errors": 10**9, **kw})

    code = ensemble.code_for_config(edge_cfg()).to(dev)
    erased = bitops.bernoulli_packed(cs.EPS_FULL, (cs.N_EDGE, cs.W_EDGE),
                                     seed=38, device=dev)
    for when in (2, LATER):
        known = erasure_bp.bp_decode_packed_allzero(code, erased,
                                                    when).known
        for size in cs.EDGE_SIZES:
            key = f"r{when}_D{size}"
            chk_local = code.chk_to_var[:code.m // size]
            ex = erasure_bp.check_exactly_one(chk_local, known)
            out["vec"][f"k2_{key}"] = getattr(erasure_bp.check_exactly_one,
                                             "vec", None)
            cand = es.edge_candidates(code.var_to_chk, ex, 0)
            out["vec"][f"x1_{key}"] = getattr(es.edge_candidates, "vec", None)
            out["digest"][f"k2_{key}"] = digest(ex)
            out["digest"][f"x1_{key}"] = digest(cand)
            del cand
            measure(f"k2_{key}", lambda c=chk_local, k=known:
                    erasure_bp.check_exactly_one(c, k),
                    "check_exactly_one_kernel")
            measure(f"x1_{key}", lambda e=ex:
                    es.edge_candidates(code.var_to_chk, e, 0),
                    "edge_candidates_kernel")
            del ex
        del known

    # K2 on the fixed path: one code at n = 10^4, W = 768, and 768 codes of
    # one word (the batched tables), two rounds in
    fixed = {"one_code": (ensemble.sample_code(
        torch.Generator().manual_seed(3), cs.N_FULL, cs.DV, cs.DC,
        device=dev), cs.WORDS_FULL),
        "codes768": (ensemble.sample_codes(1, 0, cs.CODES_FULL, cs.N_FULL,
                                           cs.DV, cs.DC, "repair",
                                           device=dev), cs.CODES_FULL)}
    for label, (c, words) in fixed.items():
        e = bitops.bernoulli_packed(cs.EPS_FULL, (cs.N_FULL, words), seed=5,
                                    device=dev)
        known = erasure_bp.bp_decode_packed_allzero(c, e, 2).known
        ex = erasure_bp.check_exactly_one(c.chk_to_var, known)
        out["vec"][f"k2_{label}"] = getattr(erasure_bp.check_exactly_one,
                                           "vec", None)
        out["digest"][f"k2_{label}"] = digest(ex)
        measure(f"k2_{label}", lambda c=c, k=known:
                erasure_bp.check_exactly_one(c.chk_to_var, k),
                "check_exactly_one_kernel")
        del known, ex

    kernels = {k: {"wrapper": w} for k, w in (
        ("check_exactly_one", erasure_bp.check_exactly_one),
        ("edge_candidates", es.edge_candidates),
        ("or_reduce_update", es.or_reduce_update),
        ("variable_or_update", erasure_bp.variable_or_update),
        ("per_trial_counts", bitops.per_trial_counts))}
    # the whole decodes at n = 10^6 (phase 40's), their rounds and their
    # device time by kernel
    decodes = {"edge": lambda: es.edge_sharded_bp_decode(code, erased,
                                                         cs.ITERS),
               "unsharded": lambda: erasure_bp.bp_decode_packed_allzero(
                   code, erased, cs.ITERS)}
    out["decode_ms"], out["decode_profile"] = {}, {}
    for way, decode in decodes.items():
        res = decode()
        out["digest"][f"decode_{way}"] = digest(res.known, res.error_totals)
        out["decode_rounds"] = int(res.iterations)
        del res
        out["decode_ms"][way] = cs.time_ms(decode, reps=3)
        out["decode_profile"][way] = json.loads(cs.device_time_breakdown(
            lambda d=decode: int(d().iterations), out["decode_ms"][way],
            kernels))
        print(f"decode {way}: {out['decode_ms'][way]:.3f} ms, "
              f"{out['decode_rounds']} rounds", flush=True)
    out["edge_over_unsharded"] = out["decode_ms"]["unsharded"] / \
        out["decode_ms"]["edge"]
    # phase 40's chunk
    chunk = mc.make_edge_sharded_chunk_fn(edge_cfg(edge_sharded=True), code,
                                          device=dev)
    stats = chunk(9)
    out["digest"]["chunk"] = digest(torch.tensor(
        [int(stats.block_errors), int(stats.bit_errors)]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in range(2):
        int(chunk(idx).block_errors)
    torch.cuda.synchronize()
    out["chunk_ms"] = (time.perf_counter() - t0) / 2 * 1e3
    out["chunk_profile"] = json.loads(cs.device_time_breakdown(
        lambda: int(chunk(5).block_errors), out["chunk_ms"], kernels))
    print(f"edge chunk: {out['chunk_ms']:.3f} ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "device_ms", "decode_ms",
                                          "chunk_ms", "digest")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
