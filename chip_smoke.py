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
chunks against the plain path (phases 1-12).  Phases 13-17 do the same for
the paths of irregular codes and of Gallager decoding, each in both code
modes at the same shape: the irregular (lam, rho) = (x/3 + 2x^3/3, x^5)
ensemble on the BEC at eps = 0.42, Gallager-A on (3,6) codes on the BSC
at p = 0.03, and Gallager-A on (lam, rho) = (x^2/2 + x^3/2, x^5) at
p = 0.04, with the irregular sampler and the Gallager check and variable
kernels held to their plain versions.

K2 and K3 are reported at the ensemble main path's batched shape (one code
per word); their single-code times from phase 4 stand beside as
``fixed_ms``.  ``launches`` counts the ensemble main path, ``launches_fixed``
the fixed-code one; for the kernels of the new paths, ``launches`` counts
the ensemble path each serves first (the irregular BEC path for the
irregular sampler, the (3,6) Gallager path for the Gallager kernels) and
``launches_by_path`` every path of phase 16.

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
ENSEMBLE_PATH = FIXED_PATH + ("sample_regular_codes",)
# the repository's irregular pairs (tests/test_irregular.py): the rate-1/2
# BEC pair (eps* = 0.45265) and the dv >= 3 Gallager pair (p* = 0.0576)
LAM_BEC, LAM_GAL, RHO6 = [0, 1 / 3, 0, 2 / 3], [0, 0, 0.5, 0.5], \
    [0, 0, 0, 0, 0, 1.0]
P_GAL, P_GAL_IRR = 0.03, 0.04   # below p*(3,6) = 0.0394 and 0.0576
EPS_STAR_IRR, P_STAR_GAL, P_STAR_GAL_IRR = 0.45265, 0.0394, 0.0576


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


def cli_run(tmp: str, name: str, **fields) -> object:
    """One run through ``cli.main --config`` on the GPU (fixed (3,6) code
    unless ``fields`` say otherwise); returns the result it wrote."""
    from iib_project_ldpc_codes_tpu_torch import cli
    from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu_torch.utils.results import load_result

    cfg = SimulationConfig(**{"code_mode": "fixed", "dv": DV, "dc": DC,
                              "max_block_errors": 10**9, **fields})
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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def new_paths(dev, smi, measured, kernels, scratch_root, erased, code,
              batch768, ens_ber_36) -> None:
    """Phases 13-17: the irregular and Gallager paths (module docstring).
    ``erased`` are the headline eps = 0.42 planes, ``code`` the fixed
    (3,6) code and ``batch768`` 768 (3,6) codes, all on ``dev``;
    ``ens_ber_36`` the (3,6) ensemble path's BER at eps = 0.42."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.ops import (bitops, erasure_bp,
                                                      gallager)
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

    # -- 13 -------------------------------------------------------------------
    phase("13 irregular sampler against its plain version; irregular "
          "K2/K3 decode")
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(N_FULL, LAM_BEC, RHO6,
                                                        device=dev)
    spec_small = irregular.IrregularEnsembleSpec.from_lam_rho(
        1024, LAM_BEC, RHO6, device=dev)
    print(f"spec n={spec.n} m={spec.m} E={spec.E} dv_max={spec.dv_max} "
          f"dc_max={spec.dc_max}", flush=True)
    tables = ("chk_to_var", "var_to_chk", "var_to_sock")
    sampled, err_s = {}, 0
    for method, sp, num in (("repair", spec, CODES_FULL),
                            ("raw", spec, CODES_FULL),
                            ("reject", spec_small, 32)):
        got = irregular.sample_irregular_codes(1, 0, num, sp, method,
                                               device=dev)
        want = irregular._sample_irregular_codes_plain(1, 0, num, sp, method,
                                                       dev)
        torch.cuda.synchronize()
        err = max(max_abs_err(getattr(got, f), getattr(want, f))
                  for f in tables)
        check(err == 0, f"irregular sampler ({method}, n={sp.n}, C={num}) "
                        f"differs from its plain version (max |d| {err})")
        for i in (0, num - 1):
            ok, verdict = irregular.validate_irregular_code(got.select(i), sp)
            check(ok or (method == "raw" and "twice" in verdict),
                  f"irregular sampler ({method}) code {i}: {verdict}")
        err_s = max(err_s, err)
        sampled[method] = got
        print(f"irregular sampler {method} equal to plain at n={sp.n}, "
              f"C={num}; structure ok", flush=True)
    reg_spec = irregular.IrregularEnsembleSpec.regular(N_FULL, DV, DC,
                                                       device=dev)
    a = irregular.sample_irregular_codes(1, 0, 64, reg_spec, "repair",
                                         device=dev)
    b = ensemble.sample_codes(1, 0, 64, N_FULL, DV, DC, "repair", device=dev)
    check(torch.equal(a.chk_to_var[:, :-1], b.chk_to_var)
          and torch.equal(a.var_to_sock[:, :-1].sort(-1).values,
                          b.var_to_edge),
          "irregular sampler on the regular spec differs from K5")
    print("irregular sampler on the (3,6) spec equals K5's tables", flush=True)
    measured["sample_irregular_codes"].update(
        max_abs_err=err_s,
        ms=time_ms(lambda: irregular.sample_irregular_codes(
            1, 0, CODES_FULL, spec, "repair", device=dev)),
        plain_ms=time_ms(lambda: irregular._sample_irregular_codes_plain(
            1, 0, CODES_FULL, spec, "repair", dev), reps=1),
        raw_ms=time_ms(lambda: irregular.sample_irregular_codes(
            1, 0, CODES_FULL, spec, "raw", device=dev)),
        reject_ms_n1024_c32=time_ms(lambda: irregular.sample_irregular_codes(
            1, 0, 32, spec_small, "reject", device=dev), reps=2))
    print(f"irregular sampler per chunk (n={N_FULL}, C={CODES_FULL}, "
          f"repair): {measured['sample_irregular_codes']['ms']:.3f} ms, plain "
          f"{measured['sample_irregular_codes']['plain_ms']:.1f} ms",
          flush=True)
    irr_batch = sampled["repair"]
    irr_one = irr_batch.select(0)

    def irregular_plain(c, planes, iters):
        return erasure_bp._strip_phantom(
            erasure_bp.bp_decode_packed_allzero_plain(
                erasure_bp._phantom_view(c),
                erasure_bp._pad_phantom_row(planes), iters))

    for label, c in (("one code", irr_one), (f"{CODES_FULL} codes",
                                              irr_batch)):
        res_k = erasure_bp.bp_decode_packed_allzero_irregular(c, erased,
                                                              ITERS)
        res_p = irregular_plain(c, erased, ITERS)
        torch.cuda.synchronize()
        check(torch.equal(res_k.known, res_p.known)
              and torch.equal(res_k.error_totals, res_p.error_totals)
              and res_k.iterations == res_p.iterations,
              f"irregular decode ({label}) differs from the plain path")
        print(f"irregular decode ({label}) equal to plain: iterations "
              f"{res_k.iterations}, erasures {int(res_k.error_totals[0])} -> "
              f"{int(res_k.error_totals[-1])}", flush=True)

    # -- 14 -------------------------------------------------------------------
    phase("14 Gallager check and variable kernels against their plain "
          "versions at the headline shape")
    flips = bitops.bernoulli_packed(P_GAL, (N_FULL, WORDS_FULL), seed=7,
                                    offset=3, device=dev)
    flips_irr = bitops.bernoulli_packed(P_GAL_IRR, (N_FULL, WORDS_FULL),
                                        seed=7, offset=3, device=dev)
    gal_spec = irregular.IrregularEnsembleSpec.from_lam_rho(
        N_FULL, LAM_GAL, RHO6, device=dev)
    gal_irr = irregular.sample_irregular_codes(3, 0, CODES_FULL, gal_spec,
                                               device=dev)
    cases = {"regular_one": (code, flips), "regular_768": (batch768, flips),
             "irregular_one": (gal_irr.select(0), flips_irr),
             "irregular_768": (gal_irr, flips_irr)}
    err_c = err_v = 0
    pass_ms = {}
    for label, (c, rx) in cases.items():
        graph = gallager._graph(c)
        t = graph.var_to_sock.shape[-1] - (0 if graph.irregular else 1)
        channel = erasure_bp._pad_phantom_row(rx) if graph.irregular else rx
        msg0 = gallager._initial_messages(graph.chk_to_var, channel)
        num = graph.num_codes
        parity = gallager.gallager_check(msg0, graph.dc)
        parity_p = gallager._gallager_check_plain(msg0, graph.dc)
        err = max_abs_err(parity, parity_p)
        check(err == 0, f"Gallager check kernel ({label}) differs from its "
                        f"plain version (max |d| {err})")
        err_c = max(err_c, err)
        state = {}

        def fresh():
            state["msg"] = msg0.clone()
            state["decided"] = rx.clone()
            state["counts"] = torch.zeros((num, 2), dtype=torch.int32,
                                          device=dev)

        active = torch.ones(num, dtype=torch.int32, device=dev)

        def run(fn):
            fn(state["msg"], parity, rx, graph.var_to_sock, active,
               state["decided"], state["counts"], dc=graph.dc,
               pad_pos=graph.pad_pos, threshold=t, clamp=graph.irregular)

        fresh()
        run(gallager.gallager_variable)
        got = (state["msg"], state["decided"], state["counts"])
        fresh()
        run(gallager._gallager_variable_plain)
        torch.cuda.synchronize()
        err = max(max_abs_err(x, y) for x, y in
                  zip(got, (state["msg"], state["decided"], state["counts"])))
        check(err == 0, f"Gallager variable kernel ({label}) differs from "
                        f"its plain version (max |d| {err})")
        err_v = max(err_v, err)
        pass_ms[label] = dict(
            check_ms=time_ms(lambda: gallager.gallager_check(msg0,
                                                             graph.dc)),
            check_plain_ms=time_ms(lambda: gallager._gallager_check_plain(
                msg0, graph.dc), reps=2),
            variable_ms=time_ms(lambda: run(gallager.gallager_variable),
                                prepare=fresh),
            variable_plain_ms=time_ms(
                lambda: run(gallager._gallager_variable_plain),
                prepare=fresh, reps=1))
        print(f"{label}: passes equal to plain; check "
              f"{pass_ms[label]['check_ms']:.4f} ms (plain "
              f"{pass_ms[label]['check_plain_ms']:.3f}), variable "
              f"{pass_ms[label]['variable_ms']:.4f} ms (plain "
              f"{pass_ms[label]['variable_plain_ms']:.3f})", flush=True)
    measured["gallager_check"].update(
        max_abs_err=err_c, ms=pass_ms["regular_768"]["check_ms"],
        plain_ms=pass_ms["regular_768"]["check_plain_ms"],
        irregular_768_ms=pass_ms["irregular_768"]["check_ms"],
        irregular_768_plain_ms=pass_ms["irregular_768"]["check_plain_ms"])
    measured["gallager_variable"].update(
        max_abs_err=err_v, ms=pass_ms["regular_768"]["variable_ms"],
        plain_ms=pass_ms["regular_768"]["variable_plain_ms"],
        fixed_ms=pass_ms["regular_one"]["variable_ms"],
        fixed_plain_ms=pass_ms["regular_one"]["variable_plain_ms"],
        irregular_768_ms=pass_ms["irregular_768"]["variable_ms"],
        irregular_768_plain_ms=pass_ms["irregular_768"]["variable_plain_ms"])
    decodes = {}
    for label, (c, rx) in cases.items():
        if gallager._graph(c).irregular:
            kern, plain = (gallager.gallager_decode_packed_irregular,
                           gallager.gallager_decode_packed_irregular_plain)
        else:
            kern, plain = (gallager.gallager_decode_packed,
                           gallager.gallager_decode_packed_plain)
        record = "per_trial" if label == "regular_768" else "total"
        res_k = kern(c, rx, ITERS, record=record)
        res_p = plain(c, rx, ITERS, record=record)
        torch.cuda.synchronize()
        check(torch.equal(res_k.decided, res_p.decided)
              and torch.equal(res_k.error_totals, res_p.error_totals)
              and res_k.iterations == res_p.iterations
              and (record == "total" or torch.equal(res_k.traj, res_p.traj)),
              f"Gallager decode ({label}) differs from the plain path")
        decodes[label] = (c, rx, kern, plain)
        print(f"Gallager decode {label} ({record}) equal to plain: "
              f"iterations {res_k.iterations}, errors "
              f"{int(res_k.error_totals[0])} -> "
              f"{int(res_k.error_totals[-1])}", flush=True)

    # -- 15 -------------------------------------------------------------------
    phase("15 run_simulation of the new paths on cuda against cpu")
    for fields in (
            dict(lam=LAM_BEC, rho=RHO6, code_mode="ensemble"),
            dict(lam=LAM_BEC, rho=RHO6, code_mode="fixed", expurgation=2),
            dict(channel="BSC", decoder="gallager", channel_param=P_GAL,
                 code_mode="ensemble", expurgation=2),
            dict(channel="BSC", decoder="gallager", channel_param=P_GAL,
                 code_mode="fixed", gallager_threshold=1),
            dict(channel="BSC", decoder="gallager", channel_param=P_GAL_IRR,
                 lam=LAM_GAL, rho=RHO6, code_mode="ensemble"),
            dict(channel="BSC", decoder="gallager", channel_param=P_GAL_IRR,
                 lam=LAM_GAL, rho=RHO6, code_mode="fixed", expurgation=1)):
        cfg = SimulationConfig(**{
            "channel_param": EPS_FULL, "n": 1024, "iterations": ITERS,
            "batch": 2048, "num_tests": 3 * 2048, "seed": 7,
            "codes_per_chunk": 64, "max_block_errors": 10**9, **fields})
        fixed = ensemble.code_for_config(cfg) \
            if cfg.code_mode == "fixed" else None
        r_gpu = mc.run_simulation(cfg, fixed, device="cuda")
        r_cpu = mc.run_simulation(cfg, fixed, device="cpu")
        for field in ("num_trials", "block_errors", "bit_errors",
                      "excluded_trials", "bit_errors_sq",
                      "code_bit_errors_sq", "trials_per_code",
                      "error_counts_per_iteration", "stopped_by"):
            check(getattr(r_gpu, field) == getattr(r_cpu, field),
                  f"cuda and cpu differ in {field} ({fields}): "
                  f"{getattr(r_gpu, field)} vs {getattr(r_cpu, field)}")
        print(f"{cfg.channel} {cfg.decoder} "
              f"{'irregular' if cfg.irregular else '(3,6)'} {cfg.code_mode} "
              f"expurgation={cfg.expurgation}: identical, block_errors "
              f"{r_gpu.block_errors}, bit_errors {r_gpu.bit_errors}",
              flush=True)

    # -- 16 -------------------------------------------------------------------
    phase("16 the new paths through cli.main at n=1e4, batch 24576, "
          f"{CODES_FULL} codes per chunk, 4 chunks each")
    paths = {
        "bec_irregular": (dict(channel_param=EPS_FULL, lam=LAM_BEC,
                               rho=RHO6),
                          ("bernoulli_packed", "check_exactly_one",
                           "variable_or_update", "per_trial_counts")),
        "gallager_36": (dict(channel="BSC", decoder="gallager",
                             channel_param=P_GAL),
                        ("bernoulli_packed", "per_trial_counts",
                         "gallager_check", "gallager_variable")),
        "gallager_irregular": (dict(channel="BSC", decoder="gallager",
                                    channel_param=P_GAL_IRR, lam=LAM_GAL,
                                    rho=RHO6),
                               ("bernoulli_packed", "per_trial_counts",
                                "gallager_check", "gallager_variable"))}
    sampler_of = {"bec_irregular": "sample_irregular_codes",
                  "gallager_36": "sample_regular_codes",
                  "gallager_irregular": "sample_irregular_codes"}
    by_path = {name: {} for name in kernels}
    results = {}
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        for path, (fields, uses) in paths.items():
            for mode in ("ensemble", "fixed"):
                name = f"{path}_{mode}"
                needed = uses + ((sampler_of[path],) if mode == "ensemble"
                                 else ())
                for k in kernels.values():
                    k["wrapper"].launches = 0
                t0 = time.perf_counter()
                res = cli_run(tmp, name, code_mode=mode, n=N_FULL,
                              iterations=ITERS, batch=32 * WORDS_FULL,
                              codes_per_chunk=CODES_FULL,
                              num_tests=4 * 32 * WORDS_FULL, seed=1,
                              **fields)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {k: v["wrapper"].launches
                            for k, v in kernels.items()}
                for k in needed:
                    check(launches[k] > 0,
                          f"kernel {k} was not launched on the {name} path")
                    by_path[k][name] = launches[k]
                rates = res.error_rate_per_iteration
                check(res.num_trials == 4 * 32 * WORDS_FULL,
                      f"{name} ran {res.num_trials} trials")
                check(len(rates) == ITERS + 1
                      and all(map(math.isfinite, rates)),
                      f"{name}: error_rate_per_iteration malformed")
                check(abs(rates[0] - fields["channel_param"]) < 1e-3,
                      f"{name}: channel error rate {rates[0]}")
                check(0.0 <= res.bit_error_rate <= rates[0]
                      and 0.0 <= res.block_error_rate <= 1.0,
                      f"{name}: rates out of range")
                check((res.trials_per_code == 32) == (mode == "ensemble")
                      and (res.code_bit_errors_sq is not None)
                      == (mode == "ensemble"),
                      f"{name}: cluster moment {res.code_bit_errors_sq}")
                results[name] = res
                print(f"{name}: {res.num_trials} trials in {seconds:.4f} s, "
                      f"FER {res.block_error_rate:.5f} BER "
                      f"{res.bit_error_rate:.4e}; launches "
                      f"{ {k: launches[k] for k in needed} }", flush=True)
        # the anchors: below threshold the new decoders clean up
        irr_ber = results["bec_irregular_ensemble"].bit_error_rate
        check(irr_ber < 0.5 * ens_ber_36,
              f"irregular BEC BER {irr_ber} not below half the (3,6) "
              f"ensemble's {ens_ber_36} at eps = {EPS_FULL}")
        for name, p in (("gallager_36", P_GAL),
                        ("gallager_irregular", P_GAL_IRR)):
            for mode in ("ensemble", "fixed"):
                ber = results[f"{name}_{mode}"].bit_error_rate
                check(ber < 0.1 * p, f"{name}_{mode}: BER {ber} at p = {p}")
        # and the waterfalls sit where density evolution puts them (n=1024)
        brackets = {}
        for name, fields, lo, hi, lo_max, hi_min in (
                ("bec_irregular", dict(lam=LAM_BEC, rho=RHO6),
                 EPS_STAR_IRR - 0.12, EPS_STAR_IRR + 0.12, 2e-3, 0.15),
                ("gallager_36", dict(channel="BSC", decoder="gallager"),
                 P_STAR_GAL - 0.02, P_STAR_GAL + 0.03, 5e-3, None),
                ("gallager_irregular", dict(channel="BSC",
                                            decoder="gallager", lam=LAM_GAL,
                                            rho=RHO6),
                 P_STAR_GAL_IRR - 0.03, P_STAR_GAL_IRR + 0.03, 5e-3, None)):
            bers = [cli_run(tmp, f"anchor_{name}_{k}", code_mode="ensemble",
                            channel_param=p, n=1024, iterations=60,
                            batch=8192, codes_per_chunk=256, num_tests=16384,
                            seed=11 + k, **fields).bit_error_rate
                    for k, p in enumerate((lo, hi))]
            check(bers[0] < lo_max and bers[1] > (
                hi_min if hi_min is not None else 10 * max(bers[0], 1e-6)),
                  f"{name}: BER {bers} at {lo:.4f} / {hi:.4f} does not "
                  "bracket the threshold")
            brackets[name] = {"at": [lo, hi], "ber": bers}
        print(json.dumps({"threshold_brackets_n1024": brackets}), flush=True)
    for k in ("sample_irregular_codes",):
        measured[k]["launches"] = by_path[k]["bec_irregular_ensemble"]
    for k in ("gallager_check", "gallager_variable"):
        measured[k]["launches"] = by_path[k]["gallager_36_ensemble"]
    for k in kernels:
        measured[k]["launches_by_path"] = by_path[k]

    # -- 17 -------------------------------------------------------------------
    phase("17 timing of the new paths at the headline shape")
    k_bits_gal = N_FULL * (DC - DV) // DC * 32 * WORDS_FULL
    k_bits_irr = (N_FULL - spec.m) * 32 * WORDS_FULL
    decode_ms = {}
    bec_cases = {"bec_irregular_one": irr_one,
                 "bec_irregular_768": irr_batch}
    for label, c in bec_cases.items():
        for name, fn in (
                ("plain", lambda: irregular_plain(c, erased, ITERS)),
                ("kernel", lambda: erasure_bp
                 .bp_decode_packed_allzero_irregular(c, erased, ITERS)),
                ("kernel", lambda: erasure_bp
                 .bp_decode_packed_allzero_irregular(c, erased, ITERS)),
                ("plain", lambda: irregular_plain(c, erased, ITERS))):
            decode_ms.setdefault(f"{label}_{name}", []).append(
                time_ms(fn, reps=1 if name == "plain" else 3))
    for label, (c, rx, kern, plain) in decodes.items():
        for name, fn in (("plain", plain), ("kernel", kern),
                         ("kernel", kern), ("plain", plain)):
            decode_ms.setdefault(f"gallager_{label}_{name}", []).append(
                time_ms(lambda: fn(c, rx, ITERS),
                        reps=1 if name == "plain" else 3))
    decode_ms = {k: sum(v) / len(v) for k, v in decode_ms.items()}
    for k, v in decode_ms.items():
        print(f"decode {k}: {v:.3f} ms", flush=True)
    info_bits_per_s = {
        k: (k_bits_irr if k.startswith("bec") else k_bits_gal) / (v / 1e3)
        for k, v in decode_ms.items()}

    def config(**fields):
        return SimulationConfig(**{
            "n": N_FULL, "iterations": ITERS, "batch": 32 * WORDS_FULL,
            "codes_per_chunk": CODES_FULL, "seed": 1, "dv": DV, "dc": DC,
            **fields})

    cfgs = {
        "bec_irregular_ensemble": config(code_mode="ensemble",
                                         channel_param=EPS_FULL, lam=LAM_BEC,
                                         rho=RHO6),
        "bec_irregular_fixed": config(code_mode="fixed",
                                      channel_param=EPS_FULL, lam=LAM_BEC,
                                      rho=RHO6),
        "gallager_36_ensemble": config(code_mode="ensemble", channel="BSC",
                                       decoder="gallager",
                                       channel_param=P_GAL),
        "gallager_36_fixed": config(code_mode="fixed", channel="BSC",
                                    decoder="gallager", channel_param=P_GAL),
        "gallager_irregular_ensemble": config(
            code_mode="ensemble", channel="BSC", decoder="gallager",
            channel_param=P_GAL_IRR, lam=LAM_GAL, rho=RHO6)}
    chunk_fns = {k: mc.make_chunk_fn(c, ensemble.code_for_config(c)
                                     if c.code_mode == "fixed" else None,
                                     device=dev) for k, c in cfgs.items()}

    def plain_chunk(cfg, idx, sample):
        # the plain version of every pass of the ensemble chunk
        codes = sample(idx)
        planes = bitops._bernoulli_packed_plain(
            bitops.bernoulli_threshold(cfg.channel_param),
            (cfg.n, WORDS_FULL), bitops.philox_key(cfg.seed), idx, dev)
        if cfg.channel == "BSC":
            res = gallager.gallager_decode_packed_plain(codes, planes, ITERS)
            final = bitops._per_trial_counts_plain(res.decided)
        else:
            res = irregular_plain(codes, planes, ITERS)
            final = bitops._per_trial_counts_plain(~res.known)
        return mc._final_count_stats(res.error_totals, final, None,
                                     num_codes=CODES_FULL)

    chunk_fns["gallager_36_ensemble_plain"] = lambda idx: plain_chunk(
        cfgs["gallager_36_ensemble"], idx,
        lambda i: ensemble._sample_codes_plain(1, i, CODES_FULL, N_FULL, DV,
                                               DC, "repair", dev))
    chunk_fns["bec_irregular_ensemble_plain"] = lambda idx: plain_chunk(
        cfgs["bec_irregular_ensemble"], idx,
        lambda i: irregular._sample_irregular_codes_plain(
            1, i, CODES_FULL, spec, "repair", dev))
    chunk_s = {}
    order = ["gallager_36_fixed", "gallager_36_ensemble",
             "gallager_36_ensemble_plain", "bec_irregular_fixed",
             "bec_irregular_ensemble", "bec_irregular_ensemble_plain",
             "gallager_irregular_ensemble"]
    for name in order + order[::-1]:
        plain = name.endswith("_plain")
        chunk_fns[name](9)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in range(1 if plain else 3):
            int(chunk_fns[name](idx).block_errors)
        torch.cuda.synchronize()
        chunk_s.setdefault(name, []).append(
            (time.perf_counter() - t0) / (1 if plain else 3))
    trials_per_s = {k: 32 * WORDS_FULL / (sum(v) / len(v))
                    for k, v in chunk_s.items()}
    print(json.dumps({
        "new_paths_timing": {
            "decode_ms": decode_ms, "decode_info_bits_per_s": info_bits_per_s,
            "passes_ms": pass_ms, "chunk_s": chunk_s,
            "chunk_trials_per_s": trials_per_s},
        "n": N_FULL, "words": WORDS_FULL, "codes_per_chunk": CODES_FULL,
        "eps": EPS_FULL, "p": [P_GAL, P_GAL_IRR], "card": smi}), flush=True)
    gal_chunk_ms = sum(chunk_s["gallager_36_ensemble"]) / \
        len(chunk_s["gallager_36_ensemble"]) * 1e3
    print(device_time_breakdown(lambda: int(
        chunk_fns["gallager_36_ensemble"](5).block_errors), gal_chunk_ms),
        flush=True)


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
    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.models.code import validate_code
    from iib_project_ldpc_codes_tpu_torch.models.ensemble import (
        code_for_config)
    from iib_project_ldpc_codes_tpu_torch.ops import (bitops, erasure_bp,
                                                      gallager)
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
        "sample_irregular_codes": dict(
            wrapper=irregular.sample_irregular_codes,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "sample_irregular_codes.cu",
            replaces="iib_project_ldpc_codes_tpu/models/irregular.py:266"),
        "gallager_check": dict(
            wrapper=gallager.gallager_check,
            source="iib_project_ldpc_codes_tpu_torch/csrc/gallager_check.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/gallager.py:117"),
        "gallager_variable": dict(
            wrapper=gallager.gallager_variable,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "gallager_variable.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/gallager.py:238"),
    }
    measured = {name: {} for name in kernels}
    t_start = time.perf_counter()

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
            return cli_run(tmp, name, **fields)

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
        for name in ENSEMBLE_PATH:
            measured[name]["launches"] = kernels[name]["wrapper"].launches
            check(measured[name]["launches"] > 0,
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
              f"{ {k: measured[k]['launches'] for k in ENSEMBLE_PATH} }",
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
    t_slice2 = time.perf_counter() - t_start
    print(f"phases 1-12 (the earlier paths) wall time: {t_slice2:.1f} s",
          flush=True)

    new_paths(dev, smi, measured, kernels, scratch_root, erased, code,
              batch_codes[1], ens_res.bit_error_rate)
    print(f"wall time: phases 1-12 {t_slice2:.1f} s, phases 13-17 "
          f"{time.perf_counter() - t_start - t_slice2:.1f} s, total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

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
                                          "variable_or_update",
                                          "gallager_variable") else {})}
        for name, spec in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
