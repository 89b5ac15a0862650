"""Time the fixed-code BEC decodes on the card: the headline all-zero
decode, the fixed irregular decode, the peeling and mode-3 chunks at n =
10^4, the random-transmit (value-plane) decode by the package's route
beside the host loop over ``check_exactly_one_xor`` / ``variable_or_adopt``
and the mode-3 random-transmit chunk, the ``_traj`` decode, the ensemble
random chunk's decode, K2 ``check_exactly_one`` and K3
``variable_or_update`` (``csrc/check_exactly_one.cu``,
``csrc/variable_or_update.cu``) at their shapes, the value round's two
kernels at three shapes, and the n = 10^6 decode that keeps the K2/K3
round loop.

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
n = 10^4, W = 768; the value decode and the random-transmit mode-3 chunk
on codewords of the same code (phase 27); the n = 10^6 (3,6) decode at W =
48 (phases 38-40).
Decodes are timed by CUDA events around whole decodes (host loop
included), mean of ``reps`` after a warm-up, with the device time by
kernel and the idle share of one decode; chunks by the host clock over 3
chunks after a warm-up.  K3 is timed after a warm-up, mean of ``reps``, by
torch.profiler (``device_ms``: the kernel alone) and by CUDA events around
single launches (``ms``: the wrapper's host work included), at one code of
n = 10^4 (W = 768, round 1), at 768 codes of one word each (N = 1) and at
n = 10^6, W = 48, two and ``LATER`` rounds into the decode; ``bound_ms``
counts its table, the exactly-one plane and ``known`` read once and
``known`` written once at 3.35 TB/s; K2 the same way at one code and at
n = 10^6 two rounds in.  The value round (``value_round``):
``check_exactly_one_xor`` and ``variable_or_adopt`` by torch.profiler
and by events, with their launched words a thread (``vec``), a digest of
their outputs and ``bound_ms`` (their tables and planes read once, their
planes written once), and their grid's column tile (``tile``), at S1, the ensemble random BEC chunk's rounds
((3,6), n = 2048, 32 codes of 24 words, W = 768, eps = 0.40, codewords,
the first round), S2, one code at n = 10^4, W = 768, eps = 0.42,
codewords, the first round, and S3, n = 10^6, W = 48, random value
planes, two rounds in; ``value_round_resources`` holds the registers of
their instantiations (cuobjdump).  The ``_traj`` decode (``traj``) runs
at S2, the ensemble random decode (``ensemble_value``: the host loop over
the value round, whose blocks do not fit kernel D's value form) at S1.
Where the tree has kernel D's value
form (``erasure_decode_values``), ``value_form`` holds its device time
(torch.profiler) on the headline planes, its rounds per block, its bound
in shared-memory accesses (``chip_smoke.value_decode_smem_accesses``) and
the registers and spills of both of D's kernels (cuobjdump), and
``transpose_share`` the plane transposes' share of each decode's device
time.  ``value_large`` is the random-transmit decode of a fixed (3,6) code
at n = ``N_LARGE``, W = 768, eps = 0.42, codewords: above D's value-form
limit, so the host loop over the value round.  ``--value-tile whole``
runs the value round untiled (its column tile W) instead of by the
package's rule, so that the two can be compared in turns.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

#: the later state of the n = 10^6 decode: rounds run before it (at eps =
#: 0.42 the decode stops after about 34 rounds)
LATER = 16
#: a fixed (3,6) code above kernel D's value-form limit (one word a block
#: up to n = 10,330): its random-transmit decode keeps the value round
N_LARGE = 12_000


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
    ap.add_argument("--value-tile", choices=("rule", "whole"),
                    default="rule",
                    help="the value round's column tile: the package's rule "
                         "(value_round_tile), or W, the grid untiled")
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
    from iib_project_ldpc_codes_tpu_torch.models import (encode, ensemble,
                                                         irregular)
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import \
        SimulationConfig

    dev = torch.device("cuda")
    kbuild.build()
    if args.value_tile == "whole":
        erasure_bp.value_round_tile = lambda rows, words, cache_bytes: words
    out = {"root": str(root), "card": cs.smi_line(),
           "value_tile": args.value_tile, "decode_ms": {},
           "info_bits_per_s": {}, "profile": {}, "launches": {},
           "chunk_ms": {}, "k2": {}, "k3": {}, "value_round": {},
           "digest": {}, "vec": {}, "transpose_share": {}}
    wrappers = {k: {"wrapper": getattr(m, k)} for m, k in (
        (bitops, "bernoulli_packed"), (erasure_bp, "check_exactly_one"),
        (erasure_bp, "variable_or_update"), (erasure_bp, "erasure_decode"),
        (bitops, "per_trial_counts"), (erasure_bp, "check_exactly_one_xor"),
        (erasure_bp, "variable_or_adopt"), (encode, "encode_packed"),
        (erasure_bp, "erasure_decode_values")) if hasattr(m, k)}

    def launches_of(run):
        before = {k: v["wrapper"].launches for k, v in wrappers.items()}
        run()
        torch.cuda.synchronize()
        return {k: v["wrapper"].launches - before[k]
                for k, v in wrappers.items()
                if v["wrapper"].launches > before[k]}

    def decode(key, run, k_bits):
        res = run()
        planes = (res.known,) if res.val is None else (res.known, res.val)
        out["digest"][key] = digest(*planes, res.error_totals,
                                    torch.tensor([res.iterations]))
        out["launches"][key] = launches_of(run)
        ms = cs.time_ms(run, reps=args.reps)
        out["decode_ms"][key] = ms
        out["info_bits_per_s"][key] = k_bits / (ms / 1e3)
        out["profile"][key] = json.loads(cs.device_time_breakdown(
            lambda: run().iterations, ms, wrappers))
        by_kernel = out["profile"][key].get("device_us_by_kernel", {})
        busy = sum(v["us"] for v in by_kernel.values())
        # the planes' transposes to and from kernel D's block-major layout
        # are PyTorch's copy kernels (a direct copy or, for a transposed
        # view, the nocast elementwise copy)
        out["transpose_share"][key] = sum(
            v["us"] for k, v in by_kernel.items()
            if "copy" in k or "gpu_kernel_impl_nocast" in k) / busy \
            if busy else None
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

    def k2(key, c, known):
        """K2 on ``known`` of code (or codes) ``c``."""
        def run():
            return erasure_bp.check_exactly_one(c.chk_to_var, known)

        ex = run()
        out["digest"][f"k2_{key}"] = digest(ex)
        out["vec"][f"k2_{key}"] = getattr(erasure_bp.check_exactly_one,
                                         "vec", None)
        row = {"device_ms": cs.device_ms(run, "check_exactly_one_kernel",
                                         reps=args.reps),
               "ms": cs.time_ms(run, reps=args.reps),
               **cs.bound(cs.nbytes(c.chk_to_var, known, ex))}
        out["k2"][key] = row
        print(f"K2 {key}: device {row['device_ms']:.4f} ms, events "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, vec "
              f"{out['vec'][f'k2_{key}']}", flush=True)

    def value_round(key, c, known, val):
        """The value round's two kernels on the planes (known, val) of code
        (or codes) ``c``: the check pass, then the variable pass on its
        outputs."""
        def check():
            return erasure_bp.check_exactly_one_xor(c.chk_to_var, known, val)

        ex, ad = check()
        state = {}

        def fresh():
            state["known"], state["val"] = known.clone(), val.clone()
            state["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

        def variable():
            erasure_bp.variable_or_adopt(c.var_to_chk, ex, ad,
                                         state["known"], state["val"],
                                         state["errors"], 1)

        fresh()
        variable()
        out["digest"][f"value_round_{key}"] = digest(
            ex, ad, state["known"], state["val"], state["errors"])
        row = {}
        for name, run, prepare, kernel, nbytes in (
                ("check", check, None, "check_exactly_one_xor_kernel",
                 cs.nbytes(c.chk_to_var, known, val, ex, ad)),
                ("variable", variable, fresh, "variable_or_adopt_kernel",
                 cs.nbytes(c.var_to_chk, ex, ad, known, known, val, val)
                 + 4)):
            wrapper = getattr(erasure_bp, kernel[:-len("_kernel")])
            row[name] = {
                "device_ms": cs.device_ms(run, kernel, prepare=prepare,
                                          reps=args.reps),
                "ms": cs.time_ms(run, prepare=prepare, reps=args.reps),
                "vec": getattr(wrapper, "vec", None),
                "tile": getattr(wrapper, "tile", None), **cs.bound(nbytes)}
        out["value_round"][key] = row
        print(f"value round {key}: {json.dumps(row)}", flush=True)

    def value_round_resources():
        """Registers, stack and local memory of the BEC round kernels'
        instantiations, the value forms' and K2's / K3's (cuobjdump)."""
        import re

        found = {}
        for name, text in re.findall(r"Function (\S+):\s*(REG:\d+ STACK:\d+ "
                                     r"SHARED:\d+ LOCAL:\d+)",
                                     cs._cuobjdump("-res-usage")):
            m = re.search(r"\d+(check_exactly_one(?:_xor)?|variable_or_"
                          r"(?:update|adopt))_kernel(I\w*?EE)?", name)
            if m:
                targs = re.findall(r"L[ib](\d+)E", m.group(2) or "")
                found[f"{m.group(1)}<{','.join(targs)}>"] = \
                    cs._resource_fields(text)
        return found

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

    # -- n = 10^4, random transmit: the value decode, its chunk -------------
    enc = encode.code_encoder_planes(code)
    tx = encode.encode_packed(enc, bitops.info_planes(
        enc.k, cs.WORDS_FULL, seed=1, offset=0, device=dev))
    decode("value", lambda: erasure_bp.bp_decode_packed(
        code, erased, tx, cs.ITERS), k_bits)
    decode("value_rounds", lambda: erasure_bp._decode_values(
        code, erased, tx, cs.ITERS, erasure_bp._VALUE_KERNELS, False)[0],
        k_bits)
    random_chunk = mc.make_chunk_fn(dataclasses.replace(cfg,
                                                        transmit="random"),
                                    code, device=dev)
    out["launches"]["random_chunk"] = launches_of(lambda: random_chunk(0))
    out["profile"]["random_chunk"] = json.loads(cs.device_time_breakdown(
        lambda: int(random_chunk(5).block_errors), float("nan"), wrappers))
    chunk("random_chunk", lambda idx: int(random_chunk(idx).block_errors))
    out["profile"]["random_chunk"]["decode_ms"] = out["chunk_ms"][
        "random_chunk"]
    busy = out["profile"]["random_chunk"].get("device_busy_ms")
    if busy is not None and "missing_from_trace" not in \
            out["profile"]["random_chunk"]:
        out["profile"]["random_chunk"]["device_idle_share"] = max(
            0.0, 1 - busy / out["chunk_ms"]["random_chunk"])
    if hasattr(erasure_bp, "erasure_decode_values"):
        chk, var = code.chk_to_var[None], code.var_to_chk[None]

        def value_form():
            return erasure_bp.erasure_decode_values(erased, tx, chk, var,
                                                    cs.ITERS, 1)

        rounds = value_form()[3]
        accesses = cs.value_decode_smem_accesses(code, erased, tx, rounds)
        out["value_form"] = {
            "device_ms": cs.device_ms(value_form,
                                      "erasure_decode_values_kernel",
                                      reps=3),
            "rounds_max": int(rounds.max()), "rounds_sum": int(rounds.sum()),
            "rounds_mean": float(rounds.float().mean()),
            "smem_accesses": accesses,
            "bound": cs.bound(cs.nbytes(chk, erased, tx, erased, tx)
                              + 4 * rounds.numel() * (cs.ITERS + 2),
                              accesses, cs.SMEM_ACCESS_S),
            "resources": cs.erasure_decode_resources()}
        print(f"value form: {json.dumps(out['value_form'])}", flush=True)

    # -- the value round at S2, its _traj decode ------------------------------
    known0 = ~erased
    value_round("s2_one_code", code, known0, tx & known0)
    decode("traj", lambda: erasure_bp.bp_decode_packed_traj(
        code, erased, tx, cs.ITERS)[0], k_bits)

    # -- a fixed code above the value form's one-word limit: the host loop --
    large = ensemble.code_for_config(dataclasses.replace(
        cfg, n=N_LARGE)).to(dev)
    large_enc = encode.code_encoder_planes(large)
    large_tx = encode.encode_packed(large_enc, bitops.info_planes(
        large_enc.k, cs.WORDS_FULL, seed=1, offset=0, device=dev))
    large_erased = bitops.bernoulli_packed(
        cs.EPS_FULL, (N_LARGE, cs.WORDS_FULL), seed=7, offset=3, device=dev)
    decode("value_large", lambda: erasure_bp.bp_decode_packed(
        large, large_erased, large_tx, cs.ITERS),
        N_LARGE * (cs.DC - cs.DV) // cs.DC * 32 * cs.WORDS_FULL)
    del large, large_enc, large_tx, large_erased

    # -- S1: the ensemble random BEC chunk's shape ---------------------------
    ens = ensemble.sample_codes(1, 0, cs.CODES_RT_ENS, cs.N_RT_ENS, cs.DV,
                                cs.DC, "repair", device=dev)
    ens_enc = encode.code_encoder_planes(ens)
    ens_tx = encode.encode_packed(ens_enc, bitops.info_planes(
        ens_enc.k, cs.WORDS_FULL, seed=1, offset=0, device=dev))
    ens_erased = bitops.bernoulli_packed(
        cs.EPS_RT_ENS, (cs.N_RT_ENS, cs.WORDS_FULL), seed=7, offset=3,
        device=dev)
    ens_known = ~ens_erased
    value_round("s1_ensemble", ens, ens_known, ens_tx & ens_known)
    decode("ensemble_value", lambda: erasure_bp.bp_decode_packed(
        ens, ens_erased, ens_tx, cs.ITERS),
        cs.N_RT_ENS * (cs.DC - cs.DV) // cs.DC * 32 * cs.WORDS_FULL)
    del ens, ens_enc, ens_tx, ens_erased, ens_known

    # -- K2 and K3 at n = 10^4: one code (N = 4), K3 also at 768 codes of one
    # word (N = 1) -----------------------------------------------------------
    k2("one_code", code, known0)
    codes768 = ensemble.sample_codes(2, 0, cs.CODES_FULL, cs.N_FULL, cs.DV,
                                     cs.DC, "repair", device=dev)
    k3("one_code", code, known0)
    k3("codes768", codes768, known0)
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
        if when == 2:
            k2("n1e6_r2", big, known)
            # S3: the value round on random value planes two rounds in
            val = bitops.bernoulli_packed(0.5, (cs.N_EDGE, cs.W_EDGE),
                                          seed=39, device=dev) & known
            value_round("s3_n1e6", big, known, val)
            del val
        del known
    decode("n1e6", lambda: erasure_bp.bp_decode_packed_allzero(
        big, big_erased, cs.ITERS), (cs.N_EDGE - big.m) * 32 * cs.W_EDGE)
    out["value_round_resources"] = value_round_resources()
    print(f"value round resources: {json.dumps(out['value_round_resources'])}",
          flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "decode_ms", "chunk_ms",
                                          "launches", "vec", "digest",
                                          "transpose_share")}))
    print(json.dumps({"k2": out["k2"], "k3": out["k3"],
                      "value_round": out["value_round"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
