"""Time the Gallager round kernels on the card as the host loop launches
them: ``gallager_check`` (``csrc/gallager_check.cu``) and
``gallager_variable`` (``csrc/gallager_variable.cu``), and the fixed-code
Gallager-A chunk that runs them.

    python examples/time_gallager_rounds.py [--root DIR] [--reps 10]
        [--out chiprun_out/time_gallager_rounds.json]

``--root DIR`` imports the package from DIR, an unpacked checkout of
another commit, instead of this tree (the timing helpers stay this tree's
``chip_smoke.py``'s): the two passes' public calls are the same there. To
compare two trees, run the script once per tree in one chip call, in turns
(other, this, this, other), and compare the JSON files; each holds a digest
of every pass's outputs, so equal digests show that both trees computed the
same thing.

Timed after a warm-up, mean of ``reps``, by CUDA events around single
launches (``ms``: what a caller waits, the wrapper's host work included)
and by torch.profiler (``device_ms``: the kernel alone); the variable
pass's messages, decision and counts reset outside the timing: both passes
on the first round's messages of one (3,6) code of n = 10^4 at W = 768
words (the fixed path) and of 768 codes at one word a code (the expurgated
ensemble chunks), regular and irregular (lambda = x^2/2 + x^3/2, rho =
x^5), and of one (5,10) and one (9,18) code (the generic degree path), the
variable pass with and without a codeword plane at one code. The fixed
Gallager-A chunk ((3,6), n = 10^4, W = 768, 50 iterations, p = 0.03): host
clock over 3 chunks after a warm-up, and the device time by kernel of one
chunk.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

N, WORDS, CODES, ITERS = 10_000, 768, 768, 50
P_GAL, P_GAL_IRR = 0.03, 0.04
LAM_GAL, RHO6 = [0, 0, 0.5, 0.5], [0, 0, 0, 0, 0, 1.0]


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
                    default=Path("chiprun_out/time_gallager_rounds.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # this tree's helpers (timing, profiling, the card's line), then the
    # package of the tree under test
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild
    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp, \
        gallager
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    out = {"root": str(root), "card": chip_smoke.smi_line(), "ms": {},
           "digest": {}}
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(N, LAM_GAL, RHO6,
                                                        device=dev)
    regular = ensemble.sample_codes(1, 0, CODES, N, 3, 6, "repair",
                                    device=dev)
    irreg = irregular.sample_irregular_codes(3, 0, CODES, spec, device=dev)
    flips = bitops.bernoulli_packed(P_GAL, (N, WORDS), seed=7, offset=3,
                                    device=dev)
    flips_irr = bitops.bernoulli_packed(P_GAL_IRR, (N, WORDS), seed=7,
                                        offset=3, device=dev)
    tx = bitops.bernoulli_packed(0.5, (N, WORDS), seed=8, device=dev)
    shapes = {"regular_one": (regular.select(0), flips),
              "regular_768": (regular, flips),
              "irregular_one": (irreg.select(0), flips_irr),
              "irregular_768": (irreg, flips_irr),
              **{f"dv{dv}_one": (ensemble.sample_codes(
                  5, 0, 1, N, dv, 2 * dv, "repair", device=dev).select(0),
                  flips) for dv in (5, 9)}}
    out["device_ms"] = {}

    def measure(key, run, kernel, prepare=None):
        out["ms"][key] = chip_smoke.time_ms(run, prepare, reps=args.reps)
        out["device_ms"][key] = chip_smoke.device_ms(run, kernel, prepare,
                                                     reps=args.reps)
        print(f"{key}: {out['ms'][key]:.4f} ms, device "
              f"{out['device_ms'][key]:.4f} ms", flush=True)

    for label, (code, rx) in shapes.items():
        graph = gallager._graph(code)
        t = graph.var_to_sock.shape[-1] - (0 if graph.irregular else 1)
        channel = erasure_bp._pad_phantom_row(rx) if graph.irregular else rx
        msg0 = gallager._initial_messages(graph.chk_to_var, channel)
        parity = gallager.gallager_check(msg0, graph.dc)
        num = graph.num_codes
        state = {"msg": msg0.clone(), "decided": rx.clone(),
                 "counts": torch.zeros((num, 2), dtype=torch.int32,
                                       device=dev)}
        active = torch.ones(num, dtype=torch.int32, device=dev)
        sent = rx ^ tx                   # the same flips on codewords tx

        def fresh(state=state, msg0=msg0, rx=rx):
            state["msg"].copy_(msg0)
            state["decided"].copy_(rx)
            state["counts"].zero_()

        def variable(with_tx=False, graph=graph, parity=parity, rx=rx,
                     sent=sent, active=active, t=t, state=state):
            gallager.gallager_variable(
                state["msg"], parity, sent if with_tx else rx,
                graph.var_to_sock, active, state["decided"], state["counts"],
                dc=graph.dc, pad_pos=graph.pad_pos, threshold=t,
                clamp=graph.irregular, tx=tx if with_tx else None)
        out["digest"][f"check_{label}"] = digest(parity)
        measure(f"check_{label}", lambda msg0=msg0, graph=graph:
                gallager.gallager_check(msg0, graph.dc), "gallager_check")
        for with_tx in ((False, True) if label.endswith("_one")
                        else (False,)):
            name = f"variable_{label}" + ("_tx" if with_tx else "")
            fresh()
            variable(with_tx)
            out["digest"][name] = digest(state["msg"], state["decided"],
                                         state["counts"])
            measure(name, lambda v=variable, x=with_tx: v(x),
                    "gallager_variable", prepare=fresh)

    cfg = SimulationConfig(n=N, iterations=ITERS, batch=32 * WORDS,
                           num_tests=32 * WORDS, seed=1, dv=3, dc=6,
                           code_mode="fixed", channel="BSC",
                           decoder="gallager", channel_param=P_GAL)
    fn = mc.make_chunk_fn(cfg, ensemble.code_for_config(cfg), device=dev)
    int(fn(9).block_errors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in range(3):
        int(fn(idx).block_errors)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    kernels = {k: {"wrapper": getattr(gallager, k)}
               for k in ("gallager_check", "gallager_variable")}
    kernels["bernoulli_packed"] = {"wrapper": bitops.bernoulli_packed}
    kernels["per_trial_counts"] = {"wrapper": bitops.per_trial_counts}
    out["chunk_ms"] = {"gallager_36_fixed": ms}
    out["chunk_profile"] = {"gallager_36_fixed": json.loads(
        chip_smoke.device_time_breakdown(lambda: int(fn(4).block_errors), ms,
                                         kernels))}
    print(f"chunk gallager_36_fixed: {ms:.3f} ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": out["card"], "ms": out["ms"],
                      "device_ms": out["device_ms"],
                      "chunk_ms": out["chunk_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
