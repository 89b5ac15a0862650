"""Time the fixed-code all-zero BEC decode on the card: the headline decode,
the fixed irregular decode, the peeling and mode-3 chunks at n = 10^4, K3
``variable_or_update`` (``csrc/variable_or_update.cu``) at its shapes, and
the n = 10^6 decode that keeps the K2/K3 round loop.

    python examples/time_fixed_bec.py [--root DIR] [--reps 10]
        [--out results/time_fixed_bec.json]

``--root DIR`` imports the package from DIR, an unpacked checkout of
another commit, instead of this tree (the timing helpers stay this tree's
``chip_smoke.py``'s).  Every call below is a public entry point of the
package or a helper of ``parallel/montecarlo.py`` that both trees have.  To
compare two trees, run the script once per tree in one chip call, in turns
(other, this, this, other), and compare the JSON files: each holds a digest
of every output, so equal digests show that both trees computed the same
thing.  The route each decode took is kept under ``launches`` (the
wrappers' launch counts over one decode) and K3's launched words a thread
under ``vec`` (None where a tree's wrapper keeps none).

Shapes (``chip_smoke.py``'s): the headline decode, (3,6) at n = 10^4, W =
768, eps = 0.42, 50 rounds (phases 4 and 7); the fixed irregular decode of
lambda = x/3 + 2x^3/3, rho = x^5 at the same n, W and eps (phase 17); the
peeling chunk (``_run_peeling``'s: K1, the decode with an n-round budget,
the counts, one host read) and the mode-3 BEC chunk (``make_chunk_fn``) at
n = 10^4, W = 768; the n = 10^6 (3,6) decode at W = 48 (phases 38-40).
Decodes are timed by CUDA events around whole decodes (host loop
included), mean of 3 after a warm-up, with the device time by kernel and
the idle share of one decode; chunks by the host clock over 3 chunks after
a warm-up.  K3 is timed after a warm-up, mean of ``reps``, by
torch.profiler (``device_ms``: the kernel alone) and by CUDA events around
single launches (``ms``: the wrapper's host work included), at one code of
n = 10^4 (W = 768, round 1), at 768 codes of one word each (N = 1) and at
n = 10^6, W = 48, two and ``LATER`` rounds into the decode; ``bound_ms``
counts its table, the exactly-one plane and ``known`` read once and
``known`` written once at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

#: the later state of the n = 10^6 decode: rounds run before it (at eps =
#: 0.42 the decode stops after about 34 rounds)
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
                    default=Path("results/time_fixed_bec.json"))
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
    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    out = {"root": str(root), "card": cs.smi_line(), "decode_ms": {},
           "info_bits_per_s": {}, "profile": {}, "launches": {},
           "chunk_ms": {}, "k3": {}, "digest": {}, "vec": {}}
    wrappers = {k: {"wrapper": getattr(m, k)} for m, k in (
        (bitops, "bernoulli_packed"), (erasure_bp, "check_exactly_one"),
        (erasure_bp, "variable_or_update"), (erasure_bp, "erasure_decode"),
        (bitops, "per_trial_counts"))}

    def launches_of(run):
        before = {k: v["wrapper"].launches for k, v in wrappers.items()}
        run()
        torch.cuda.synchronize()
        return {k: v["wrapper"].launches - before[k]
                for k, v in wrappers.items()
                if v["wrapper"].launches > before[k]}

    def decode(key, run, k_bits):
        res = run()
        out["digest"][key] = digest(res.known, res.error_totals,
                                    torch.tensor([res.iterations]))
        out["launches"][key] = launches_of(run)
        ms = cs.time_ms(run, reps=3)
        out["decode_ms"][key] = ms
        out["info_bits_per_s"][key] = k_bits / (ms / 1e3)
        out["profile"][key] = json.loads(cs.device_time_breakdown(
            lambda: run().iterations, ms, wrappers))
        print(f"{key}: {ms:.3f} ms, {k_bits / (ms / 1e3):.4e} info bits/s, "
              f"{res.iterations} rounds, launches {out['launches'][key]}, "
              f"idle {out['profile'][key].get('device_idle_share')}",
              flush=True)
        return res

    def chunk(key, run):
        run(9)                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = [run(idx) for idx in range(3)]
        torch.cuda.synchronize()
        out["chunk_ms"][key] = (time.perf_counter() - t0) / 3 * 1e3
        out["digest"][key] = digest(torch.tensor(blocks))
        print(f"{key}: {out['chunk_ms'][key]:.3f} ms a chunk", flush=True)

    def k3(key, c, known):
        """K3 on the round after ``known`` of code (or codes) ``c``."""
        ex = erasure_bp.check_exactly_one(c.chk_to_var, known)
        state = {}

        def fresh():
            state["known"] = known.clone()
            state["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

        def run():
            erasure_bp.variable_or_update(c.var_to_chk, ex, state["known"],
                                          state["errors"], 1)

        fresh()
        run()
        out["digest"][f"k3_{key}"] = digest(state["known"], state["errors"])
        out["vec"][f"k3_{key}"] = getattr(erasure_bp.variable_or_update,
                                         "vec", None)
        row = {"device_ms": cs.device_ms(run, "variable_or_update_kernel",
                                         prepare=fresh, reps=args.reps),
               "ms": cs.time_ms(run, prepare=fresh, reps=args.reps),
               **cs.bound(cs.nbytes(c.var_to_chk, ex)
                          + 2 * cs.nbytes(known) + 4)}
        out["k3"][key] = row
        print(f"K3 {key}: device {row['device_ms']:.4f} ms, events "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, vec "
              f"{out['vec'][f'k3_{key}']}", flush=True)

    # -- n = 10^4: the headline, irregular, the chunks ----------------------
    cfg = SimulationConfig(channel_param=cs.EPS_FULL, n=cs.N_FULL, dv=cs.DV,
                           dc=cs.DC, code_mode="fixed", code_number=1,
                           iterations=cs.ITERS, batch=32 * cs.WORDS_FULL,
                           seed=1, max_block_errors=10**9)
    code = ensemble.code_for_config(cfg).to(dev)
    erased = bitops.bernoulli_packed(cs.EPS_FULL, (cs.N_FULL, cs.WORDS_FULL),
                                     seed=7, offset=3, device=dev)
    k_bits = cs.N_FULL * (cs.DC - cs.DV) // cs.DC * 32 * cs.WORDS_FULL
    decode("headline", lambda: erasure_bp.bp_decode_packed_allzero(
        code, erased, cs.ITERS), k_bits)
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(
        cs.N_FULL, cs.LAM_BEC, cs.RHO6, device=dev)
    irr = irregular.sample_irregular_codes(1, 0, 1, spec, "repair",
                                           device=dev).select(0)
    decode("irregular", lambda: erasure_bp.bp_decode_packed_allzero_irregular(
        irr, erased, cs.ITERS), (cs.N_FULL - spec.m) * 32 * cs.WORDS_FULL)

    def peel_chunk(idx):
        e = bitops.bernoulli_packed(cs.EPS_FULL, (cs.N_FULL, cs.WORDS_FULL),
                                    seed=3, offset=idx, device=dev)
        res = mc._allzero_decode(code, e, cs.N_FULL)
        stats = mc._final_count_stats(res.error_totals, res.bit_errors, None)
        return int(stats.block_errors)

    out["launches"]["peeling_chunk"] = launches_of(lambda: peel_chunk(0))
    chunk("peeling_chunk", peel_chunk)
    fixed_chunk = mc.make_chunk_fn(cfg, code, device=dev)
    out["launches"]["fixed_chunk"] = launches_of(lambda: fixed_chunk(0))
    chunk("fixed_chunk", lambda idx: int(fixed_chunk(idx).block_errors))

    # -- K3 at n = 10^4: one code (N = 4), 768 codes of one word (N = 1) ----
    codes768 = ensemble.sample_codes(2, 0, cs.CODES_FULL, cs.N_FULL, cs.DV,
                                     cs.DC, "repair", device=dev)
    k3("one_code", code, ~erased)
    k3("codes768", codes768, ~erased)
    del codes768

    # -- n = 10^6, W = 48: K3 in the round loop, the whole decode -----------
    big_cfg = SimulationConfig(channel_param=cs.EPS_FULL, n=cs.N_EDGE,
                               dv=cs.DV, dc=cs.DC, code_mode="fixed",
                               code_number=1, iterations=cs.ITERS,
                               batch=32 * cs.W_EDGE, seed=1,
                               max_block_errors=10**9)
    big = ensemble.code_for_config(big_cfg).to(dev)
    big_erased = bitops.bernoulli_packed(cs.EPS_FULL, (cs.N_EDGE, cs.W_EDGE),
                                         seed=38, device=dev)
    for when in (2, LATER):
        known = erasure_bp.bp_decode_packed_allzero(big, big_erased,
                                                    when).known
        k3(f"n1e6_r{when}", big, known)
        del known
    decode("n1e6", lambda: erasure_bp.bp_decode_packed_allzero(
        big, big_erased, cs.ITERS), (cs.N_EDGE - big.m) * 32 * cs.W_EDGE)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "decode_ms", "chunk_ms",
                                          "launches", "vec", "digest")}))
    print(json.dumps({"k3": out["k3"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
