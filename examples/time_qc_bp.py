"""Time the QC BEC round kernels on the card as the decodes launch them: Q1
``qc_check_exactly_one`` (``csrc/qc_check_exactly_one.cu``) and Q2
``qc_variable_or`` (``csrc/qc_variable_or.cu``), each all-zero and with
value planes, and the whole QC BEC decode and chunk at n = 1,000,008.

    python examples/time_qc_bp.py [--root DIR] [--reps 10]
        [--out results/time_qc_bp.json]

``--root DIR`` imports the package from DIR, an unpacked checkout of
another commit, instead of this tree (the timing helpers stay this tree's
``chip_smoke.py``'s): the passes' public calls are the same there, and
where the tree lays the decodes' planes out in column tiles
(``ops/qc_bp.py`` ``_decode_tile``), the passes run on planes in that
layout, as the decodes launch them (converted outside the timing).  To
compare two trees, run the script once per tree in one chip call, in turns
(other, this, this, other), and compare the JSON files; each holds a digest
of every pass's outputs, so equal digests show that both trees computed the
same thing.

Shapes (``chip_smoke.py``'s phase 28): the nb = 12 (3,6) base at n =
10,008 (Z = 834, W = 768) and n = 1,000,008 (Z = 83,334, W = 48), and the
irregular BEC base (nb = 24, Z = 417, W = 768, lambda = x/3 + 2x^3/3, rho
= x^5: blocks of degree 2 and 4).  Each pass runs on two states of a decode
at eps = 0.42: the first round's planes (``r0``) and the planes after
``LATER`` rounds (``r26``), where many of Q2's 16-byte items are all known
and skip their loads (the share is reported).  Q2 updates in place, so its
planes are reset outside the timing.  Timed after a warm-up, mean of
``reps``, by CUDA events around single launches (``ms``: what a caller
waits, the wrapper's host work included) and by torch.profiler
(``device_ms``: the kernel alone).  The decode: 50 rounds, CUDA events
around whole decodes (host loop included) and the device time by kernel of
one decode; the chunk: phase 32's n = 1,000,008 QC BEC chunk (channel,
decode, counts, one host read) by the host clock over 2 chunks after a
warm-up, and its device time by kernel.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

#: the later state: rounds run before it (density evolution at eps = 0.42
#: collapses between rounds 20 and 30)
LATER = 26


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
                    default=Path("results/time_qc_bp.json"))
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
    from iib_project_ldpc_codes_tpu_torch.models import qc
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, qc_bp
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    out = {"root": str(root), "card": cs.smi_line(), "ms": {},
           "device_ms": {}, "digest": {}, "layout": {}, "all_known": {}}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    shapes = {
        "n1e4": (qc.sample_qc_code(gen(1), cs.QC_NB, cs.DV, cs.DC, cs.QC_Z,
                                   device=dev), cs.WORDS_FULL),
        "n1e6": (qc.sample_qc_code(gen(3), cs.QC_NB, cs.DV, cs.DC,
                                   cs.QC_Z6, device=dev), cs.QC_W6),
        "irregular": (qc.sample_qc_code_irregular(
            gen(4), cs.QC_NB_IRR, cs.LAM_BEC, cs.RHO6, cs.QC_Z_IRR,
            device=dev), cs.WORDS_FULL)}

    def measure(key, run, kernel, prepare=None):
        out["ms"][key] = cs.time_ms(run, prepare, reps=args.reps)
        out["device_ms"][key] = cs.device_ms(run, kernel, prepare,
                                             reps=args.reps)
        print(f"{key}: {out['ms'][key]:.4f} ms, device "
              f"{out['device_ms'][key]:.4f} ms", flush=True)

    def layout(fn):
        return {k: getattr(fn, k, None) for k in ("vec", "tile")}

    # the decodes' layout of the planes (None: row-major, the passes
    # without a tile argument)
    rule = getattr(qc_bp, "_decode_tile", None)

    def to(t, tile):
        return t if tile is None else qc_bp.to_tiles(t, tile)

    def back(*planes, tile):
        return [t if tile is None else qc_bp.from_tiles(t, tile)
                for t in planes]

    for label, (c, words) in shapes.items():
        adj = qc_bp._adjacency(c, dev)
        erased = bitops.bernoulli_packed(cs.EPS_FULL, (c.n, words), seed=7,
                                         offset=3, device=dev)
        tile = None if rule is None else rule(erased)
        kw = {} if tile is None else {"tile": tile}
        tx = bitops.info_planes(c.n, words, seed=2, device=dev)
        later = qc_bp.qc_bp_decode_packed(c, erased, tx, LATER)
        states = {"r0": (~erased, tx & ~erased),
                  "r26": (later.known, later.val)}
        for when, (known0, val0) in states.items():
            key = f"{label}_{when}"
            # the share of Q2's 16-byte items whose trials all know the
            # variable (they skip their loads)
            items = known0.view(c.n, -1, 4) if words % 4 == 0 else \
                known0.view(c.n, -1, 1)
            out["all_known"][key] = float((items == -1).all(-1).float()
                                          .mean())
            known0, val0 = to(known0, tile), to(val0, tile)
            ex = qc_bp.qc_check_exactly_one(adj, known0, **kw)
            out["layout"][f"q1_{key}"] = layout(qc_bp.qc_check_exactly_one)
            ex_v, adopt = qc_bp.qc_check_exactly_one(adj, known0, val0, **kw)
            out["digest"][f"q1_{key}"] = digest(*back(ex, tile=tile))
            out["digest"][f"q1_values_{key}"] = digest(
                *back(ex_v, adopt, tile=tile))
            state = {}

            def fresh(state=state, known0=known0, val0=val0):
                state["known"] = known0.clone()
                state["val"] = val0.clone()
                state["errors"] = torch.zeros(2, dtype=torch.int32,
                                              device=dev)

            def q2(values, adj=adj, ex=ex, ex_v=ex_v, adopt=adopt,
                   state=state, kw=kw):
                if values:
                    qc_bp.qc_variable_or(adj, ex_v, state["known"],
                                         state["errors"], 1, adopt=adopt,
                                         val=state["val"], **kw)
                else:
                    qc_bp.qc_variable_or(adj, ex, state["known"],
                                         state["errors"], 1, **kw)

            for values in (False, True):
                name = f"q2{'_values' if values else ''}_{key}"
                fresh()
                q2(values)
                out["digest"][name] = digest(
                    *back(state["known"], *([state["val"]] if values else []),
                          tile=tile), state["errors"])
                out["layout"][name] = layout(qc_bp.qc_variable_or)
            measure(f"q1_{key}", lambda adj=adj, k=known0, kw=kw:
                    qc_bp.qc_check_exactly_one(adj, k, **kw),
                    "qc_check_exactly_one")
            measure(f"q1_values_{key}", lambda adj=adj, k=known0, v=val0,
                    kw=kw: qc_bp.qc_check_exactly_one(adj, k, v, **kw),
                    "qc_check_exactly_one")
            for values in (False, True):
                measure(f"q2{'_values' if values else ''}_{key}",
                        lambda q2=q2, v=values: q2(v), "qc_variable_or",
                        prepare=fresh)
            del state, ex, ex_v, adopt
        del later, states

    kernels = {"qc_check_exactly_one":
               {"wrapper": qc_bp.qc_check_exactly_one},
               "qc_variable_or": {"wrapper": qc_bp.qc_variable_or}}
    # the whole decode at n = 1,000,008 (chip_smoke.py phase 32's
    # bec_index), its rounds and its device time by kernel
    c, words = shapes["n1e6"]
    erased = bitops.bernoulli_packed(cs.EPS_FULL, (c.n, words), seed=11,
                                     device=dev)

    def decode():
        return qc_bp.qc_bp_decode_packed_allzero(c, erased, cs.ITERS)

    res = decode()
    out["digest"]["decode_n1e6"] = digest(res.known, res.error_totals)
    out["decode_rounds"] = int(res.iterations)
    out["decode_ms"] = cs.time_ms(decode, reps=3)
    out["decode_profile"] = json.loads(cs.device_time_breakdown(
        lambda: int(decode().iterations), out["decode_ms"], kernels))
    print(f"decode n1e6: {out['decode_ms']:.3f} ms, "
          f"{out['decode_rounds']} rounds", flush=True)
    # phase 32's chunk
    cfg6 = SimulationConfig(n=c.n, channel_param=cs.EPS_FULL,
                            iterations=cs.ITERS, batch=32 * words, seed=1,
                            code_mode="fixed")
    chunk6 = mc.make_chunk_fn(cfg6, c, device=dev)
    stats = chunk6(9)
    out["digest"]["chunk_n1e6"] = digest(torch.tensor(
        [int(stats.block_errors), int(stats.bit_errors)]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in range(2):
        int(chunk6(idx).block_errors)
    torch.cuda.synchronize()
    out["chunk_ms"] = (time.perf_counter() - t0) / 2 * 1e3
    out["chunk_profile"] = json.loads(cs.device_time_breakdown(
        lambda: int(chunk6(5).block_errors), out["chunk_ms"], kernels))
    print(f"chunk n1e6: {out['chunk_ms']:.3f} ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "ms", "device_ms",
                                          "decode_ms", "chunk_ms",
                                          "digest")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
