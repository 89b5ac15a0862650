#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the hand-written kernels from
``iib_project_ldpc_codes_tpu_torch/csrc``, holds each against its plain
PyTorch version on the card, checks GPU Monte Carlo runs against the same
runs on the CPU, drives the port's two main paths through the CLI entry
point -- fixed-code (reference mode 3) and ensemble (mode 0, a fresh code
per 32 trials) (3,6) BEC erasure BP at n = 10^4, 24,576 trials per chunk,
50 iterations -- and times the kernels, the sampler, the decode and the
chunks against the plain path.

K2 and K3 are reported at the ensemble main path's batched shape (one code
per word); their single-code times from phase 4 stand beside as
``fixed_ms``.  ``launches`` counts the ensemble main path, ``launches_fixed``
the fixed-code one.

Any failed check raises, and the script exits non-zero without printing a
result.  On success the last three lines are the card's name and power
limit, the per-kernel JSON line, and ``{"ok": true, "device": ...}``.
Without CUDA, or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

N_FULL, WORDS_FULL, EPS_FULL, ITERS = 10_000, 768, 0.42, 50
DV, DC = 3, 6
CODES_FULL = 768          # ensemble main path: one code per 32 trials
FIXED_PATH = ("bernoulli_packed", "check_exactly_one", "variable_or_update",
              "per_trial_counts")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(run, prepare=None, reps: int = 5) -> float:
    """Mean device time of ``run()`` in ms, by CUDA events around each
    call alone (``prepare()`` runs outside the events), after one warm-up
    call."""
    import torch

    if prepare is not None:
        prepare()
    run()
    total = 0.0
    for _ in range(reps):
        if prepare is not None:
            prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def device_time_breakdown(run, decode_ms: float) -> str:
    """Device time by kernel (and copy) over one ``run()`` under
    torch.profiler, and the device's idle share of ``decode_ms`` (the
    unprofiled time of one ``run()``).  A warm-up step runs first under
    the profiler's schedule and is dropped: a kernel launched right as
    tracing starts is sometimes missing from the trace.
    Returns one JSON line; the numbers are "not measured" when the
    profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    by_kernel = {}
    for e in traced[0] if traced else []:
        if e.device_type != DeviceType.CUDA or \
                e.name.startswith("ProfilerStep"):
            continue          # host-side ops, runtime calls, step spans
        entry = by_kernel.setdefault(e.name[:80], {"calls": 0, "us": 0.0})
        entry["calls"] += 1
        entry["us"] += e.time_range.elapsed_us()
    busy_ms = sum(v["us"] for v in by_kernel.values()) / 1e3
    if busy_ms == 0:
        return json.dumps({"device_time": "not measured"})
    return json.dumps({"device_us_by_kernel": by_kernel,
                       "device_busy_ms": busy_ms,
                       "decode_ms": decode_ms,
                       "device_idle_share": max(0.0, 1 - busy_ms / decode_ms)})


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        import iib_project_ldpc_codes_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port package is missing beside chip_smoke.py: {e}",
              file=sys.stderr)
        return 1

    from iib_project_ldpc_codes_tpu_torch import cli
    from iib_project_ldpc_codes_tpu_torch.kernels.build import build
    from iib_project_ldpc_codes_tpu_torch.models import ensemble
    from iib_project_ldpc_codes_tpu_torch.models.code import validate_code
    from iib_project_ldpc_codes_tpu_torch.models.ensemble import (
        code_for_config)
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
    from iib_project_ldpc_codes_tpu_torch.parallel.montecarlo import (
        make_chunk_fn, run_simulation)
    from iib_project_ldpc_codes_tpu_torch.utils.config import (
        SimulationConfig)
    from iib_project_ldpc_codes_tpu_torch.utils.results import load_result

    dev = torch.device("cuda")
    kernels = {
        "bernoulli_packed": dict(
            wrapper=bitops.bernoulli_packed,
            source="iib_project_ldpc_codes_tpu_torch/csrc/bernoulli_packed.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/bitops.py:63"),
        "check_exactly_one": dict(
            wrapper=erasure_bp.check_exactly_one,
            source="iib_project_ldpc_codes_tpu_torch/csrc/check_exactly_one.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/erasure_bp.py:186"),
        "variable_or_update": dict(
            wrapper=erasure_bp.variable_or_update,
            source="iib_project_ldpc_codes_tpu_torch/csrc/variable_or_update.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/erasure_bp.py:231"),
        "per_trial_counts": dict(
            wrapper=bitops.per_trial_counts,
            source="iib_project_ldpc_codes_tpu_torch/csrc/per_trial_counts.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/bitops.py:50"),
        "sample_regular_codes": dict(
            wrapper=ensemble.sample_codes,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "sample_regular_codes.cu",
            replaces="iib_project_ldpc_codes_tpu/models/ensemble.py:61"),
    }
    measured = {name: {} for name in kernels}

    # -- 1 ------------------------------------------------------------------
    phase("1 device")
    smi = smi_line()
    device_name = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {device_name} count {torch.cuda.device_count()}",
          flush=True)

    # -- 2 ------------------------------------------------------------------
    phase("2 build")
    path, seconds = build(verbose=True)
    print(f"built {path} in {seconds:.1f} s", flush=True)

    # -- 3 K1 ---------------------------------------------------------------
    phase("3 K1 bernoulli_packed")
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    # K1 runs the same Philox as the plain version, so K1 == plain below
    # carries these known answers over to the kernel
    for ctr, key, want in kat:
        plain = [int(x) for x in bitops.philox4x32_10(ctr, key)]
        check(plain == list(want), f"plain Philox known answer: {plain}")
    shape = (N_FULL, WORDS_FULL)
    seed, offset = 7, 3
    thr = bitops.bernoulli_threshold(EPS_FULL)
    key = bitops.philox_key(seed)
    erased = bitops.bernoulli_packed(EPS_FULL, shape, seed=seed,
                                     offset=offset, device=dev)
    plain = bitops._bernoulli_packed_plain(thr, shape, key, offset, dev)
    torch.cuda.synchronize()
    err = max_abs_err(erased, plain)
    check(err == 0, f"K1 differs from its plain version (max |d| {err})")
    bits = int(bitops.total_popcount(erased))
    total_bits = N_FULL * WORDS_FULL * 32
    frac = bits / total_bits
    sigma = math.sqrt(EPS_FULL * (1 - EPS_FULL) / total_bits)
    check(abs(frac - EPS_FULL) < 5 * sigma,
          f"erased fraction {frac} not within 5 sigma of {EPS_FULL}")
    measured["bernoulli_packed"].update(
        max_abs_err=err,
        ms=time_ms(lambda: bitops.bernoulli_packed(
            EPS_FULL, shape, seed=seed, offset=offset, device=dev)),
        plain_ms=time_ms(lambda: bitops._bernoulli_packed_plain(
            thr, shape, key, offset, dev), reps=2))
    print(f"K1 equal to plain at {shape}; erased fraction {frac:.6f} "
          f"(sigma {sigma:.2e})", flush=True)

    # -- 4 K2/K3/K4 ---------------------------------------------------------
    phase("4 K2/K3/K4 decode at the headline shape")
    cfg_full = SimulationConfig(channel_param=EPS_FULL, n=N_FULL, dv=DV,
                                dc=DC, code_mode="fixed", code_number=1,
                                iterations=ITERS)
    code = code_for_config(cfg_full).to(dev)
    known0 = ~erased
    # single passes, compared and timed at round 1
    ex_k = erasure_bp.check_exactly_one(code.chk_to_var, known0)
    ex_p = erasure_bp._check_exactly_one_plain(code.chk_to_var, known0)
    err = max_abs_err(ex_k, ex_p)
    check(err == 0, f"K2 differs from its plain version (max |d| {err})")
    measured["check_exactly_one"].update(
        max_abs_err=err,
        ms=time_ms(lambda: erasure_bp.check_exactly_one(code.chk_to_var,
                                                        known0)),
        plain_ms=time_ms(lambda: erasure_bp._check_exactly_one_plain(
            code.chk_to_var, known0)))
    state = {}

    def fresh():
        state["known"] = known0.clone()
        state["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

    fresh()
    erasure_bp.variable_or_update(code.var_to_chk, ex_k, state["known"],
                                  state["errors"], 1)
    kn_k, er_k = state["known"], state["errors"]
    fresh()
    erasure_bp._variable_or_update_plain(code.var_to_chk, ex_k,
                                         state["known"], state["errors"], 1)
    err = max(max_abs_err(kn_k, state["known"]),
              max_abs_err(er_k, state["errors"]))
    check(err == 0, f"K3 differs from its plain version (max |d| {err})")
    measured["variable_or_update"].update(
        max_abs_err=err,
        ms=time_ms(lambda: erasure_bp.variable_or_update(
            code.var_to_chk, ex_k, state["known"], state["errors"], 1),
            prepare=fresh),
        plain_ms=time_ms(lambda: erasure_bp._variable_or_update_plain(
            code.var_to_chk, ex_k, state["known"], state["errors"], 1),
            prepare=fresh))
    c_k = bitops.per_trial_counts(erased)
    c_p = bitops._per_trial_counts_plain(erased)
    err = max_abs_err(c_k, c_p)
    check(err == 0, f"K4 differs from its plain version (max |d| {err})")
    measured["per_trial_counts"].update(
        max_abs_err=err,
        ms=time_ms(lambda: bitops.per_trial_counts(erased)),
        plain_ms=time_ms(lambda: bitops._per_trial_counts_plain(erased)))
    # whole decodes
    res_k = erasure_bp.bp_decode_packed_allzero(code, erased, ITERS)
    res_p = erasure_bp.bp_decode_packed_allzero_plain(code, erased, ITERS)
    torch.cuda.synchronize()
    check(torch.equal(res_k.known, res_p.known), "decode: known differs")
    check(torch.equal(res_k.error_totals, res_p.error_totals),
          "decode: error_totals differ")
    check(res_k.iterations == res_p.iterations, "decode: iterations differ")
    check(torch.equal(res_k.bit_errors,
                      bitops._per_trial_counts_plain(~res_p.known)),
          "decode: per-trial counts differ")
    print(f"decode equal: iterations {res_k.iterations}, errors[0] "
          f"{int(res_k.error_totals[0])} -> {int(res_k.error_totals[-1])}, "
          f"FER {float(res_k.failed.float().mean()):.4f}", flush=True)

    # -- 5 GPU against CPU --------------------------------------------------
    phase("5 run_simulation on cuda against cpu")
    for expurgation in (None, 2):
        cfg_small = SimulationConfig(
            channel_param=EPS_FULL, n=1024, dv=DV, dc=DC, code_mode="fixed",
            iterations=ITERS, batch=2048, num_tests=3 * 2048, seed=7,
            max_block_errors=10**9, expurgation=expurgation)
        small_code = code_for_config(cfg_small)
        r_gpu = run_simulation(cfg_small, small_code, device="cuda")
        r_cpu = run_simulation(cfg_small, small_code, device="cpu")
        for field in ("num_trials", "block_errors", "bit_errors",
                      "excluded_trials", "bit_errors_sq",
                      "error_counts_per_iteration", "stopped_by"):
            check(getattr(r_gpu, field) == getattr(r_cpu, field),
                  f"cuda and cpu differ in {field} (expurgation "
                  f"{expurgation}): {getattr(r_gpu, field)} vs "
                  f"{getattr(r_cpu, field)}")
        print(f"expurgation={expurgation}: identical, block_errors "
              f"{r_gpu.block_errors}, excluded {r_gpu.excluded_trials}",
              flush=True)

    # -- 6 main path through the CLI ----------------------------------------
    phase("6 main path: cli.main, mode 3, n=1e4, batch 24576, 4 chunks")
    # scratch files stay inside the checkout, in a git-ignored directory
    scratch_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".smoke_tmp")
    os.makedirs(scratch_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        def run_cli(name: str, **fields) -> object:
            cfg = SimulationConfig(**{"code_mode": "fixed", "dv": DV,
                                      "dc": DC, "max_block_errors": 10**9,
                                      **fields})
            cfg_path = os.path.join(tmp, f"{name}.json")
            with open(cfg_path, "w") as f:
                f.write(cfg.to_json())
            out_dir = os.path.join(tmp, name)
            rc = cli.main(["--config", cfg_path, f"--output-dir={out_dir}",
                           "--device=cuda"])
            check(rc == 0, f"cli.main returned {rc}")
            files = [f for f in os.listdir(out_dir) if f.endswith(".json")]
            check(len(files) == 1, f"expected one result file, got {files}")
            return load_result(os.path.join(out_dir, files[0]))

        for spec in kernels.values():
            spec["wrapper"].launches = 0
        t0 = time.perf_counter()
        main_res = run_cli("main", channel_param=EPS_FULL, n=N_FULL,
                           iterations=ITERS, batch=32 * WORDS_FULL,
                           num_tests=4 * 32 * WORDS_FULL, seed=1)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        for name in FIXED_PATH:
            launches = kernels[name]["wrapper"].launches
            measured[name]["launches_fixed"] = launches
            check(launches > 0,
                  f"kernel {name} was not launched on the main path")
        rates = main_res.error_rate_per_iteration
        check(main_res.num_trials == 4 * 32 * WORDS_FULL,
              f"main path ran {main_res.num_trials} trials")
        check(len(rates) == ITERS + 1 and all(map(math.isfinite, rates)),
              "error_rate_per_iteration malformed")
        check(all(a >= b for a, b in zip(rates, rates[1:])),
              "erasure rate increased between iterations")
        check(abs(rates[0] - EPS_FULL) < 1e-3,
              f"channel erasure rate {rates[0]}")
        check(0.0 <= main_res.bit_error_rate <= rates[0]
              and 0.0 < main_res.block_error_rate < 1.0,
              "main path rates out of range")
        print(f"main path: {main_res.num_trials} trials in {main_s:.4f} s, "
              f"FER {main_res.block_error_rate:.5f} BER "
              f"{main_res.bit_error_rate:.3e}; launches "
              f"{ {k: measured[k]['launches_fixed'] for k in FIXED_PATH} }",
              flush=True)

        anchor = run_cli("anchor", channel_param=0.40, n=1024,
                         iterations=ITERS, batch=8192, num_tests=32768,
                         seed=11)
        check(0.05 <= anchor.block_error_rate <= 0.14,
              f"FER at n=1024, eps=0.40: {anchor.block_error_rate}")
        low = run_cli("low", channel_param=0.20, n=1024, iterations=ITERS,
                      batch=8192, num_tests=32768, seed=12)
        check(low.block_error_rate <= 0.002,
              f"FER at n=1024, eps=0.20: {low.block_error_rate}")
        print(f"anchors: FER(0.40) {anchor.block_error_rate:.5f}, "
              f"FER(0.20) {low.block_error_rate:.6f}", flush=True)

    # -- 7 timing -----------------------------------------------------------
    phase("7 decode-only info bits/s at the headline shape")
    k_bits = N_FULL * (DC - DV) // DC * 32 * WORDS_FULL
    rate = {}
    for name, fn in (
            ("plain", erasure_bp.bp_decode_packed_allzero_plain),
            ("kernel", erasure_bp.bp_decode_packed_allzero),
            ("kernel", erasure_bp.bp_decode_packed_allzero),
            ("plain", erasure_bp.bp_decode_packed_allzero_plain)):
        ms = time_ms(lambda: fn(code, erased, ITERS), reps=3)
        rate.setdefault(name, []).append(k_bits / (ms / 1e3))
        print(f"{name}: {ms:.3f} ms per decode, "
              f"{k_bits / (ms / 1e3):.4e} info bits/s", flush=True)
    print(json.dumps({"decode_info_bits_per_s": {
        k: sum(v) / len(v) for k, v in rate.items()},
        "iterations": res_k.iterations, "n": N_FULL, "words": WORDS_FULL,
        "eps": EPS_FULL, "card": smi}))
    print(device_time_breakdown(
        lambda: erasure_bp.bp_decode_packed_allzero(code, erased, ITERS),
        k_bits / (sum(rate["kernel"]) / len(rate["kernel"])) * 1e3),
        flush=True)

    # -- 8 K5 -----------------------------------------------------------------
    phase("8 K5 sample_regular_codes against its plain version")
    tables = ("chk_to_var", "var_to_edge", "var_to_chk")
    k5_err = 0
    for method, n_s, num_s in (("repair", N_FULL, CODES_FULL),
                               ("raw", N_FULL, CODES_FULL),
                               ("reject", 1024, 32)):
        got = ensemble.sample_codes(1, 0, num_s, n_s, DV, DC, method,
                                    device=dev)
        want = ensemble._sample_codes_plain(1, 0, num_s, n_s, DV, DC,
                                            method, dev)
        torch.cuda.synchronize()
        err = max(max_abs_err(getattr(got, f), getattr(want, f))
                  for f in tables)
        check(err == 0, f"K5 ({method}, n={n_s}, C={num_s}) differs from "
                        f"its plain version (max |d| {err})")
        ok, verdict = validate_code(got)
        check(ok or (method == "raw" and verdict ==
                     "check touches the same variable twice"),
              f"K5 ({method}) codes: {verdict}")
        k5_err = max(k5_err, err)
        if method == "raw":
            chk = got.chk_to_var
            doubles = torch.zeros(num_s, dtype=torch.float64, device=dev)
            for a in range(DC):
                for b in range(a + 1, DC):
                    doubles += (chk[:, :, a] == chk[:, :, b]).sum(1)
            mean = float(doubles.mean())
            se = float(doubles.std()) / math.sqrt(num_s)
            expect = (DV - 1) * (DC - 1) / 2
            check(abs(mean - expect) < 4 * se,
                  f"raw double edges {mean} per code, expected {expect}")
            print(f"raw: {mean:.4f} double edges per code (expected "
                  f"{expect}, se {se:.4f})", flush=True)
        print(f"K5 {method} equal to plain at n={n_s}, C={num_s}; "
              f"structure ok", flush=True)
    reject_ms = time_ms(lambda: ensemble.sample_codes(
        1, 0, 32, 1024, DV, DC, "reject", device=dev), reps=2)
    measured["sample_regular_codes"].update(
        max_abs_err=k5_err,
        ms=time_ms(lambda: ensemble.sample_codes(
            1, 0, CODES_FULL, N_FULL, DV, DC, "repair", device=dev)),
        plain_ms=time_ms(lambda: ensemble._sample_codes_plain(
            1, 0, CODES_FULL, N_FULL, DV, DC, "repair", dev), reps=1),
        raw_ms=time_ms(lambda: ensemble.sample_codes(
            1, 0, CODES_FULL, N_FULL, DV, DC, "raw", device=dev)),
        reject_ms_n1024_c32=reject_ms)
    print(f"K5 per chunk (n={N_FULL}, C={CODES_FULL}, repair): "
          f"{measured['sample_regular_codes']['ms']:.3f} ms, plain "
          f"{measured['sample_regular_codes']['plain_ms']:.1f} ms; raw "
          f"{measured['sample_regular_codes']['raw_ms']:.3f} ms; reject at "
          f"n=1024, C=32: {reject_ms:.3f} ms", flush=True)

    # -- 9 batched K2/K3 ----------------------------------------------------
    phase("9 batched K2/K3 against their plain versions, 1 and 24 words "
          "per code")
    batch_codes = {}
    for name in ("check_exactly_one", "variable_or_update"):
        entry = measured[name]
        entry["fixed_ms"], entry["fixed_plain_ms"] = (entry.pop("ms"),
                                                      entry.pop("plain_ms"))
    for wpc in (1, 24):
        codes = ensemble.sample_codes(2, 0, WORDS_FULL // wpc, N_FULL, DV,
                                      DC, "repair", device=dev)
        batch_codes[wpc] = codes
        ex_k = erasure_bp.check_exactly_one(codes.chk_to_var, known0)
        ex_p = erasure_bp._check_exactly_one_plain(codes.chk_to_var, known0)
        err2 = max_abs_err(ex_k, ex_p)
        check(err2 == 0, f"batched K2 (wpc {wpc}) differs from its plain "
                         f"version (max |d| {err2})")
        fresh()
        erasure_bp.variable_or_update(codes.var_to_chk, ex_k,
                                      state["known"], state["errors"], 1)
        kn_k, er_k = state["known"], state["errors"]
        fresh()
        erasure_bp._variable_or_update_plain(
            codes.var_to_chk, ex_k, state["known"], state["errors"], 1)
        err3 = max(max_abs_err(kn_k, state["known"]),
                   max_abs_err(er_k, state["errors"]))
        check(err3 == 0, f"batched K3 (wpc {wpc}) differs from its plain "
                         f"version (max |d| {err3})")
        suffix = "" if wpc == 1 else f"_wpc{wpc}"
        k2, k3 = measured["check_exactly_one"], measured["variable_or_update"]
        k2["max_abs_err"] = max(k2["max_abs_err"], err2)
        k3["max_abs_err"] = max(k3["max_abs_err"], err3)
        k2["ms" + suffix] = time_ms(lambda: erasure_bp.check_exactly_one(
            codes.chk_to_var, known0))
        k2["plain_ms" + suffix] = time_ms(
            lambda: erasure_bp._check_exactly_one_plain(codes.chk_to_var,
                                                        known0), reps=2)
        k3["ms" + suffix] = time_ms(lambda: erasure_bp.variable_or_update(
            codes.var_to_chk, ex_k, state["known"], state["errors"], 1),
            prepare=fresh)
        k3["plain_ms" + suffix] = time_ms(
            lambda: erasure_bp._variable_or_update_plain(
                codes.var_to_chk, ex_k, state["known"], state["errors"], 1),
            prepare=fresh, reps=2)
        print(f"wpc {wpc} ({WORDS_FULL // wpc} codes): K2 "
              f"{k2['ms' + suffix]:.4f} ms (plain "
              f"{k2['plain_ms' + suffix]:.3f}), K3 {k3['ms' + suffix]:.4f} "
              f"ms (plain {k3['plain_ms' + suffix]:.3f})", flush=True)
    # a batch of one code is the single-code call
    ex_1 = erasure_bp.check_exactly_one(code.chk_to_var[None], known0)
    check(torch.equal(ex_1, erasure_bp.check_exactly_one(code.chk_to_var,
                                                         known0)),
          "K2 on a batch of one code differs from the single-code call")
    fresh()
    erasure_bp.variable_or_update(code.var_to_chk[None], ex_1,
                                  state["known"], state["errors"], 1)
    kn_1, er_1 = state["known"], state["errors"]
    fresh()
    erasure_bp.variable_or_update(code.var_to_chk, ex_1, state["known"],
                                  state["errors"], 1)
    check(torch.equal(kn_1, state["known"])
          and torch.equal(er_1, state["errors"]),
          "K3 on a batch of one code differs from the single-code call")
    print("C=1 batches equal the single-code calls", flush=True)

    # -- 10 ensemble GPU against CPU ----------------------------------------
    phase("10 ensemble run_simulation on cuda against cpu")
    for sampler, expurgation in (("repair", None), ("repair", 2),
                                 ("raw", None), ("raw", 2)):
        cfg_small = SimulationConfig(
            channel_param=EPS_FULL, n=1024, dv=DV, dc=DC,
            code_mode="ensemble", codes_per_chunk=64, sampler=sampler,
            iterations=ITERS, batch=2048, num_tests=3 * 2048, seed=7,
            max_block_errors=10**9, expurgation=expurgation)
        r_gpu = run_simulation(cfg_small, device="cuda")
        r_cpu = run_simulation(cfg_small, device="cpu")
        for field in ("num_trials", "block_errors", "bit_errors",
                      "excluded_trials", "bit_errors_sq",
                      "code_bit_errors_sq", "trials_per_code",
                      "error_counts_per_iteration", "stopped_by"):
            check(getattr(r_gpu, field) == getattr(r_cpu, field),
                  f"ensemble cuda and cpu differ in {field} ({sampler}, "
                  f"expurgation {expurgation}): {getattr(r_gpu, field)} vs "
                  f"{getattr(r_cpu, field)}")
        print(f"{sampler}, expurgation={expurgation}: identical, "
              f"block_errors {r_gpu.block_errors}, excluded "
              f"{r_gpu.excluded_trials}, code_bit_errors_sq "
              f"{r_gpu.code_bit_errors_sq}", flush=True)

    # -- 11 ensemble main path through the CLI ------------------------------
    phase("11 ensemble main path: cli.main, mode 0, n=1e4, batch 24576, "
          f"{CODES_FULL} codes per chunk, 4 chunks")
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        for spec in kernels.values():
            spec["wrapper"].launches = 0
        t0 = time.perf_counter()
        ens_res = run_cli("ensemble", code_mode="ensemble",
                          channel_param=EPS_FULL, n=N_FULL, iterations=ITERS,
                          batch=32 * WORDS_FULL, codes_per_chunk=CODES_FULL,
                          num_tests=4 * 32 * WORDS_FULL, seed=1)
        torch.cuda.synchronize()
        ens_s = time.perf_counter() - t0
        for name, spec in kernels.items():
            measured[name]["launches"] = spec["wrapper"].launches
            check(spec["wrapper"].launches > 0,
                  f"kernel {name} was not launched on the ensemble path")
        rates = ens_res.error_rate_per_iteration
        check(ens_res.num_trials == 4 * 32 * WORDS_FULL,
              f"ensemble path ran {ens_res.num_trials} trials")
        check(ens_res.config.code_mode == "ensemble"
              and ens_res.trials_per_code == 32,
              f"trials per code {ens_res.trials_per_code}")
        check(ens_res.code_bit_errors_sq is not None
              and math.isfinite(ens_res.code_bit_errors_sq)
              and ens_res.code_bit_errors_sq >= ens_res.bit_errors_sq,
              f"cluster moment {ens_res.code_bit_errors_sq}")
        check(len(rates) == ITERS + 1 and all(map(math.isfinite, rates)),
              "error_rate_per_iteration malformed")
        check(all(a >= b for a, b in zip(rates, rates[1:])),
              "erasure rate increased between iterations")
        check(abs(rates[0] - EPS_FULL) < 1e-3,
              f"channel erasure rate {rates[0]}")
        check(0.0 <= ens_res.bit_error_rate <= rates[0]
              and 0.0 < ens_res.block_error_rate < 1.0,
              "ensemble path rates out of range")
        print(f"ensemble path: {ens_res.num_trials} trials on "
              f"{4 * CODES_FULL} codes in {ens_s:.4f} s, FER "
              f"{ens_res.block_error_rate:.5f} BER "
              f"{ens_res.bit_error_rate:.3e}; launches "
              f"{ {k: v['launches'] for k, v in measured.items()} }",
              flush=True)
        anchor = run_cli("ens_anchor", code_mode="ensemble",
                         channel_param=0.40, n=1024, iterations=ITERS,
                         batch=8192, codes_per_chunk=256, num_tests=32768,
                         seed=11)
        check(0.05 <= anchor.block_error_rate <= 0.14,
              f"ensemble FER at n=1024, eps=0.40: "
              f"{anchor.block_error_rate}")
        low = run_cli("ens_low", code_mode="ensemble", channel_param=0.20,
                      n=1024, iterations=ITERS, batch=8192,
                      codes_per_chunk=256, num_tests=32768, seed=12)
        check(low.block_error_rate <= 0.002,
              f"ensemble FER at n=1024, eps=0.20: {low.block_error_rate}")
        print(f"ensemble anchors: FER(0.40) {anchor.block_error_rate:.5f}, "
              f"FER(0.20) {low.block_error_rate:.6f}", flush=True)

    # -- 12 ensemble timing -------------------------------------------------
    phase("12 ensemble timing at the headline shape")
    decode_ms = {}
    for wpc, codes in batch_codes.items():
        for name, fn in (
                ("plain", erasure_bp.bp_decode_packed_allzero_plain),
                ("kernel", erasure_bp.bp_decode_packed_allzero),
                ("kernel", erasure_bp.bp_decode_packed_allzero),
                ("plain", erasure_bp.bp_decode_packed_allzero_plain)):
            ms = time_ms(lambda: fn(codes, erased, ITERS),
                         reps=1 if name == "plain" else 3)
            decode_ms.setdefault(f"{name}_codes{codes.num_codes}",
                                 []).append(ms)
            print(f"{codes.num_codes} codes (wpc {wpc}), {name}: {ms:.3f} ms "
                  "per decode", flush=True)
    cfg_ens = SimulationConfig(
        code_mode="ensemble", channel_param=EPS_FULL, n=N_FULL, dv=DV,
        dc=DC, iterations=ITERS, batch=32 * WORDS_FULL,
        codes_per_chunk=CODES_FULL, seed=1)
    cfg_fix = SimulationConfig(
        code_mode="fixed", channel_param=EPS_FULL, n=N_FULL, dv=DV, dc=DC,
        iterations=ITERS, batch=32 * WORDS_FULL, seed=1)
    chunk_fns = {"fixed": make_chunk_fn(cfg_fix, code, device=dev),
                 "ensemble": make_chunk_fn(cfg_ens, None, device=dev)}
    chunk_s = {}
    for mode in ("fixed", "ensemble", "ensemble", "fixed"):
        chunk_fns[mode](9)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in range(3):
            stats = chunk_fns[mode](idx)
            int(stats.block_errors)              # the host reads each chunk
        torch.cuda.synchronize()
        chunk_s.setdefault(mode, []).append((time.perf_counter() - t0) / 3)
    trials_per_s = {k: 32 * WORDS_FULL / (sum(v) / len(v))
                    for k, v in chunk_s.items()}
    print(json.dumps({
        "ensemble_timing": {
            "sampler_ms_per_chunk": measured["sample_regular_codes"]["ms"],
            "sampler_plain_ms_per_chunk":
                measured["sample_regular_codes"]["plain_ms"],
            "decode_ms": {k: sum(v) / len(v) for k, v in decode_ms.items()},
            "chunk_s": chunk_s, "chunk_trials_per_s": trials_per_s},
        "n": N_FULL, "words": WORDS_FULL, "codes_per_chunk": CODES_FULL,
        "eps": EPS_FULL, "card": smi}), flush=True)
    ens_chunk_ms = sum(chunk_s["ensemble"]) / len(chunk_s["ensemble"]) * 1e3
    print(device_time_breakdown(lambda: int(
        chunk_fns["ensemble"](5).block_errors), ens_chunk_ms), flush=True)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"],
         "launches": measured[name]["launches"],
         "max_abs_err": measured[name]["max_abs_err"],
         "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"],
         **{k: v for k, v in measured[name].items()
            if k not in ("launches", "max_abs_err", "ms", "plain_ms")},
         **({"batched": True} if name in ("check_exactly_one",
                                          "variable_or_update") else {})}
        for name, spec in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
