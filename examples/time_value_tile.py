"""Time the host-loop random-transmit decodes with the value round's grid
in column tiles (``ops/erasure_bp.py::value_round_tile``) against the grid
untiled (a tile of W words), in turns within one process.

    python examples/time_value_tile.py [--turns 6] [--reps 10]
        [--out results/time_value_tile.json]

Decodes ((3,6), W = 768, eps = 0.42, codewords, 50 rounds): ``traj``, the
``_traj`` decode at n = 10^4 (``bp_decode_packed_traj``: the value round
and K4 a round), and ``large``, the decode of a code above kernel D's
value-form limit at n = 12,000 (``bp_decode_packed``: the value round a
round).  Each turn times every decode by CUDA events around whole decodes,
mean of ``reps`` after a warm-up, first untiled then tiled or the other
way round (the order alternates by turn), and records the device busy
time of one decode of each (``chip_smoke.device_time_breakdown``).  Both
layouts must give equal digests.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path,
                    default=Path("results/time_value_tile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild
    from iib_project_ldpc_codes_tpu_torch.models import encode, ensemble
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    rule = erasure_bp.value_round_tile
    layouts = {"tiled": rule,
               "untiled": lambda rows, words, cache_bytes: words}
    wrappers = {k: {"wrapper": getattr(erasure_bp, k)} for k in (
        "check_exactly_one_xor", "variable_or_adopt")}
    cfg = SimulationConfig(channel_param=cs.EPS_FULL, n=cs.N_FULL, dv=cs.DV,
                           dc=cs.DC, code_mode="fixed", code_number=1,
                           iterations=cs.ITERS, batch=32 * cs.WORDS_FULL,
                           seed=1, max_block_errors=10**9)
    decodes = {}
    for key, n in (("traj", cs.N_FULL), ("large", 12_000)):
        code = ensemble.code_for_config(dataclasses.replace(cfg, n=n)).to(dev)
        enc = encode.code_encoder_planes(code)
        tx = encode.encode_packed(enc, bitops.info_planes(
            enc.k, cs.WORDS_FULL, seed=1, offset=0, device=dev))
        erased = bitops.bernoulli_packed(cs.EPS_FULL, (n, cs.WORDS_FULL),
                                         seed=7, offset=3, device=dev)
        if key == "traj":
            decodes[key] = (lambda c=code, e=erased, t=tx:
                            erasure_bp.bp_decode_packed_traj(
                                c, e, t, cs.ITERS)[0])
        else:
            decodes[key] = (lambda c=code, e=erased, t=tx:
                            erasure_bp.bp_decode_packed(c, e, t, cs.ITERS))
    out = {"card": cs.smi_line(), "ms": {}, "busy_ms": {}, "tile": {},
           "digest": {}}
    for turn in range(args.turns):
        order = ("untiled", "tiled") if turn % 2 == 0 else ("tiled",
                                                            "untiled")
        for layout in order:
            erasure_bp.value_round_tile = layouts[layout]
            for key, run in decodes.items():
                res = run()
                k = f"{key}_{layout}"
                out["digest"].setdefault(k, digest(
                    res.known, res.val, res.error_totals))
                out["tile"][k] = erasure_bp.check_exactly_one_xor.tile
                out["ms"].setdefault(k, []).append(
                    cs.time_ms(run, reps=args.reps))
                busy = json.loads(cs.device_time_breakdown(
                    lambda: run().iterations, float("nan"), wrappers)
                ).get("device_busy_ms")
                out["busy_ms"].setdefault(k, []).append(busy)
        print(f"turn {turn}: " + json.dumps(
            {k: round(v[-1], 3) for k, v in out["ms"].items()}), flush=True)
    erasure_bp.value_round_tile = rule
    for key in decodes:
        if out["digest"][f"{key}_tiled"] != out["digest"][f"{key}_untiled"]:
            print(f"{key}: the layouts' digests differ", file=sys.stderr)
            return 1
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
