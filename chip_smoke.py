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
kernels held to their plain versions (every instantiation: one code at W =
768 and 768 codes at one word, regular and irregular, with and without a
codeword plane, and the generic degree on (5,10) and (9,18) codes; timed
by events and on the device, beside the bound at each shape; the variable
kernel's launches on one expurgated ensemble chunk). Kernel G, the whole
Gallager decode of one code per block, is held to its plain version on all
three outputs (decision, per-code errors per round, rounds) at 768 codes,
regular and irregular, with and without a plane the errors count against,
and on small adversarial batches; its decode at 768 codes is timed beside
the round kernels' and the plain one, and its launches are counted on the
ensemble paths (where the round kernels must not run), the n = 1024
brackets and the random ensemble Gallager path (phase 26), the round
kernels' on the fixed and expurgated paths.

Phases 18-22 do the same for soft-decision BP (BASELINE.json config 3,
``bench.py``'s soft tripwire): kernel A (AWGN LLRs), kernel B (posterior)
and kernel C (check update) against their plain versions in all five
(method, message type) instantiations, whole decodes against the plain
path at n = 8192, 24,576 trials (768 codes of 32 in ensemble mode), 50
iterations, GPU runs against CPU runs, the new paths through the CLI with
their BER anchors and threshold brackets, and their timing: kernel C in
each of its five instantiations at 768 codes and at one code (ms, bound,
plain ms, launch geometry and the rate on the bytes its bound counts),
and the device time of the AWGN sum-product and int8 ensemble chunks.
Phase 33 also reads the registers, stack frame and spills of every
instantiation of kernel C from the built library.

Phases 23-27 do the same for random-codeword transmit (``transmit=
"random"``): kernel E (the systematic encoder), the two value-plane
round kernels (K2's and K3's value forms: at S1, the ensemble random
chunk's rounds, S2, one code at n = 10^4, and S3, n = 10^6, W = 48, random
planes two rounds in, 16 bytes a thread, and at one word a thread on
misaligned planes) and kernel D's value form (the whole decode, a block a
word of one code or a block a code, with codewords and with random planes that
are not, regular and irregular; two cases also against the CPU) against
their plain versions, kernels A, B and the Gallager variable kernel with a
codeword plane, every encoded word checked against H, whole value-plane
decodes against the plain path with their route (D's value form for one
code at n = 10^4, the round kernels for the ensemble's 24 words a code),
GPU runs against CPU
runs, the random paths through the CLI (the fixed (3,6) BEC and Gallager-A
and irregular BEC paths at n = 10^4, AWGN sum-product and BSC bf16 min-sum
at n = 8192, and the ensemble BEC and AWGN min-sum paths at the JAX
package's validation scale, n = 2048, 32 codes of 768 trials a chunk, with
an encoder derived per code and chunk), each held to its zero-transmit run
at the same seed, and their timing: kernel E beside its bound (the least
over a walk of the set map bits, the method of Four Russians and the
tensor-core product) and a library matmul, the value decode by D's value
form beside the host loop over the round kernels it replaced (in turns),
D's value form beside its shared-memory bound and its registers, the
value-round kernels' device times at S1-S3 beside their bounds and their
registers, chunks against the zero-transmit chunks, and the encoder
derivation at n = 10^4 and per ensemble chunk.  For kernel E and D's
value form ``launches`` counts the fixed random BEC path (the CLI's two
chunks), for the two value-round kernels the ensemble random BEC path.

Phases 28-32 do the same for quasi-cyclic (QC) codes, whose entry point is
``run_simulation(cfg, code=qc)``: the four circulant-index kernels (the BEC
check and variable passes, the Gallager check and variable passes; no
table per lifted edge is read) against their plain versions in every
instantiation, on the nb = 12 (3,6) base lifted to n = 10,008 (W = 768)
and to ``bench.py``'s huge-n shape n = 1,000,008 (W = 48) and on the
irregular pairs above on an nb = 24 base, each Q4 launch's words a
thread and degree passes checked, Q3's and Q4's device times
(torch.profiler) beside their event times; ``expand()`` validated; whole
decodes against the plain path and against the generic kernels on
``expand()``; GPU runs against CPU runs and circulant-index runs against
``expand()`` runs, counter for counter; the QC paths through the engine
with launch counts equal to the rounds run and a threshold bracket at
n = 100,008; and circulant index timed against gather (the generic kernels
on ``expand()``) at n = 10^4, 10^5 and 10^6, with the n = 10^6
Gallager-A decode's device time by kernel.  For these four kernels
``launches`` counts the (3,6) QC BEC path (the BEC pair) and the (3,6) QC
Gallager-A path (the Gallager pair).

Phases 33-37 do the same for the QC soft decoder by circulant index, whose
entry point is again ``run_simulation(cfg, code=qc)``, and for the
sequential peeling decoder: the QC soft posterior and check kernels (S1,
S2) against their plain versions in all five (method, type)
instantiations on the nb = 12 (3,6) base at n = 10,008 (24,576 trials) and
n = 1,000,008 (1,536) and on the irregular nb = 24 base, and the peel
kernel (P1) in each of its forms against its plain version on 400 fresh
(3,6) codes of n = 16,384 and 100 irregular ones (the form the shape rule
launched, device ms and ms a step per form); whole int8 decodes against
the plain path and kernels B and C on ``expand()``, S2's int8
instantiation also on planes drawn from {-128, -127, -1, 0, 1, 127}
(saturation and ties), with its registers, stack frame, spills and SASS
instruction count read from the built library and its rate on the bytes it
really moves (pm once per check socket, messages in and out); GPU runs
against CPU runs, every peel's
final set against the batched BP fixed point and the parallel peel against
its plain version; the int8 min-sum path (AWGN sigma = 0.841 and BSC
p = 0.04) with S1 and S2 launches equal to the rounds run and counters
equal to the ``expand()`` run, a threshold bracket at n = 100,008, and the
``{"decoder": "peeling"}`` configuration through the CLI in both modes
(fixed: equal to the bp run with n rounds); the R-process experiment at
n = 16,384, eps = 0.42 (docs/VALIDATION.md) at 400 and 4,000 repeats and
its irregular form; and circulant index timed against gather for int8
min-sum and f32 sum-product at n = 10^4, 10^5 and 10^6, with the n = 10^6
int8 chunk profiled.  For S1 and S2 ``launches`` counts the (3,6) int8
AWGN path of 4 chunks; for P1 the experiment at 400 repeats.

Phases 38-41 do the same for edge-sharded erasure BP (BASELINE.json
config 5) and batch sharding over a process group: the edge round's two
kernels, X1 (the candidate plane of a check shard) and X2 (the OR over
the ranks' candidates fused with the update and the count), against their
plain versions on a fixed (3,6) code of n = 10^6 at W = 48 for every shard
of D = 1, 2 and 4 ranks, each round also against the K2/K3 round; the
whole edge-sharded decode against the K2/K3 decode (launches K2 = X1 = X2
= rounds) and GPU against CPU at n = 10^5; the edge-sharded path through
``cli.main --edge-sharded`` and ``run_simulation`` equal to the unsharded
run in every counter, with a bracket at eps = 0.42 / 0.44 around eps*(3,6)
= 0.4294 and the decode's info bits/s beside the K2/K3 decode's; and two
ranks on the one card over gloo (spawned): the edge decode at n = 10^5
equal to world size 1, a batch-sharded fixed-BEC run equal to the per-rank
chunks summed, and the dry run.  For X1 and X2 ``launches`` counts the
edge-sharded CLI path of 2 chunks.

Every kernel row of the JSON line carries ``bound_ms``, the least time the
card could take for the same work at the shape of its ``ms``: the larger
of its bytes (each input read once, each output written once, counted from
this run's tensors) over 3.35 TB/s and its operations over the peak rate
of their type (``bound_by`` names the larger), and ``library_ms``, the
time of one PyTorch call computing the same function where one exists.

Kernel D, the whole all-zero erasure-BP decode of a block of one code's
words per CUDA block, runs the ensemble BEC chunks (a block a code) and
the fixed-code decodes whose word fits a block (a block a word) in place
of K2/K3 (ops/erasure_bp.py::erasure_decode_block_words): phase 4 holds
the headline decode by D to the K2/K3 decode and the plain one, phase 9
holds D to its plain version bit for bit (known, per-block errors per
round, rounds) at 768 codes, regular and irregular, at eps = 0 and 1, at 0
and 1 rounds and on a batch whose last code to move reaches zero beside a
stuck one; phases 6, 11 and 16 assert that the BEC paths at n = 10^4
launch D (once a decode) and never K2/K3; phase 7 times the headline
decode by D beside the K2/K3 decode and the plain one; phase 12 times D
beside the K2/K3 decode it replaced and profiles the ensemble chunk.  Its
value form (``erasure_decode_values``) runs the random-transmit decodes
whose blocks fit (phases 23-27).

K2 and K3 are held and timed at the fixed-code shape of phase 4 (one
code, 768 words; K3's device time again at n = 10^6, W = 48, in phase 39),
their times at the batched shape of 768 codes (one word a code) stand
beside as ``ms_codes768``, and their ``launches`` count the fixed-code
run at n = 10^6 of phase 40 (whose word does not fit D's block).
``launches`` counts the main path each kernel serves (the ensemble path
for K1, K4, K5 and D); for
the kernels of the later paths, ``launches`` counts the ensemble path each
serves first (the irregular BEC path for the irregular sampler, the (3,6)
Gallager path for kernel G, the AWGN sum-product path for kernels A, B
and C; the fixed (3,6) Gallager path for the Gallager check and variable
kernels, which the ensemble paths no longer run) and ``launches_by_path``
every path of phases 16 and 21.  Kernels G's and D's bounds are their
shared-memory accesses for the rounds their codes ran, over 132 SMs x 32
a clock at 1.98 GHz, or their device-memory bytes.  Kernel A's bound is
its plane written once, beside the Philox products it needs
(``philox_ms``), with its own loop's FP64 instructions (from the built
SASS, ``sass_loop_counts``) at 64 lanes an SM beside it
(``kernel_ops_ms``); phase 18 also holds its transform and its division
against the math library and ``__fdiv_rn`` over every 32-bit word
(``awgn_word_checks``).  K4's bound is its bytes beside the integer
operations the counts need (``vertical_count_ops``, a bit-sliced counter)
at the SM's 128 issue slots a clock, with its own innermost loop's integer
instructions a word beside it (``kernel_ops_ms``); phase 4 holds it to its
plain version on every plane shape the paths give it.

Every phase prints its wall time when the next one starts.  Any failed
check raises, and the script exits non-zero without printing a
result.  On success the last three lines are the card's name and power
limit, the per-kernel JSON line, and ``{"ok": true, "device": ...}``.
Without CUDA, or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import functools
import hashlib
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
# the fixed-code and the ensemble chunks at n = 10^4 decode with kernel D
# (a block a word, a block a code), never K2/K3
FIXED_PATH = ("bernoulli_packed", "erasure_decode", "per_trial_counts")
ENSEMBLE_PATH = ("bernoulli_packed", "erasure_decode", "per_trial_counts",
                 "sample_regular_codes")
ROUND_PAIR = ("check_exactly_one", "variable_or_update")
# the repository's irregular pairs (tests/test_irregular.py): the rate-1/2
# BEC pair (eps* = 0.45265) and the dv >= 3 Gallager pair (p* = 0.0576)
LAM_BEC, LAM_GAL, RHO6 = [0, 1 / 3, 0, 2 / 3], [0, 0, 0.5, 0.5], \
    [0, 0, 0, 0, 0, 1.0]
P_GAL, P_GAL_IRR = 0.03, 0.04   # below p*(3,6) = 0.0394 and 0.0576
EPS_STAR_IRR, P_STAR_GAL, P_STAR_GAL_IRR = 0.45265, 0.0394, 0.0576
# soft BP (BASELINE.json config 3, bench.py:118-131): (3,6) at n = 8192,
# 24,576 trials (768 codes of 32 in ensemble mode), 50 iterations
N_SOFT, COLS_SOFT, CODES_SOFT = 8192, 24_576, 768
SIGMA_SP = 0.80                 # below sigma*_GA(3,6) = 0.8747
SIGMA_STAR_SP, SIGMA_STAR_INT8 = 0.8747, 0.822
# BSC min-sum (alpha 1) decodes (3,6) at p = 0.04 and fails at 0.05 (BER
# 0.15, the JAX package's decoder alike at n = 2048)
P_SOFT_BSC = 0.04
# random-codeword transmit (phases 23-27): the fixed paths at the widths
# above, the ensemble paths at the JAX package's validation scale (one
# encoder per fresh code and chunk): (3,6), n = 2048, 32 codes of 768 trials
N_RT_ENS, CODES_RT_ENS, EPS_RT_ENS, SIGMA_RT_ENS = 2048, 32, 0.40, 0.85
# quasi-cyclic codes (phases 28-32): the nb = 12 (3,6) base lifted to
# n = 10,008, 100,008 and 1,000,008 (bench.py's huge-n shape, W = 48), and
# the irregular pairs above on an nb = 24 base lifted to n = 10,008
QC_NB, QC_Z, QC_Z5, QC_Z6, QC_W5, QC_W6 = 12, 834, 8334, 83_334, 480, 48
QC_NB_IRR, QC_Z_IRR = 24, 417
# the QC soft decoder (phases 33-37): int8 min-sum at sigma = 0.841 (Eb/N0 =
# 1.5 dB, PERF.md section 2) on the bases above, 24,576 / 15,360 / 1,536
# trials; the peeling R-process at docs/VALIDATION.md's point
SIGMA_QC = 0.841
PEEL_N, PEEL_EPS, PEEL_REPEATS, PEEL_REPEATS_BIG = 16_384, 0.42, 400, 4000
PEEL_CODES_IRR = 100            # the irregular family's P1 check (phase 33)
# the largest (3,6) n whose 3n sockets the samplers keep in shared memory
# (models/ensemble.py SHARED_PERM_MAX_SOCKETS); n + 2 takes the global path
EDGE_SHARED_N = 18_666
# edge sharding (phases 38-41, BASELINE.json config 5): a fixed (3,6) code
# of n = 10^6 (m = 500,000, divided by 1, 2 and 4) at W = 48 (1,536
# trials); GPU against CPU and the 2-rank group at n = 10^5
N_EDGE, W_EDGE, N_EDGE_CPU, EDGE_SIZES = 1_000_000, 48, 100_000, (1, 2, 4)
EDGE_RUN_FIELDS = ("num_trials", "block_errors", "bit_errors",
                   "bit_errors_sq", "error_counts_per_iteration")
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s,
# FP32 outside the tensor cores, and FP64 and INT32 at half that rate (64
# such lanes an SM against 128 FP32 lanes)
HBM_BYTES_S, FP32_OPS_S, FP64_OPS_S, INT32_OPS_S = 3.35e12, 67e12, 33.5e12, \
    33.5e12
BF16_TENSOR_OPS_S = 989e12      # dense bf16 on the tensor cores
# shared-memory accesses of 4 bytes a second: 32 banks (128 bytes) a clock
# on each of the 132 SMs at the 1.98 GHz boost clock (NVIDIA's Hopper
# architecture documents and data sheet)
SMEM_ACCESS_S = 132 * 32 * 1.98e9
INT8_TENSOR_OPS_S = 1979e12     # dense int8 on the tensor cores
PHILOX_OPS = 100                # 10 rounds of 4 multiplies, 4 XORs, 2 adds
PHILOX_PRODUCTS = 20            # 10 rounds of two 32 x 32 -> 64-bit products


_PHASE = {"name": None, "start": 0.0}


def phase(name) -> None:
    """Start phase ``name`` (None: end the last one), printing the wall
    time of the phase before it."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"== phase {_PHASE['name'].split()[0]} wall time "
              f"{now - _PHASE['start']:.1f} s", flush=True)
    _PHASE.update(name=name, start=now)
    if name is not None:
        print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(run, prepare=None, reps: int = 5, warmup: bool = True) -> float:
    """Mean device time of ``run()`` in ms, by CUDA events around each
    call alone (``prepare()`` runs outside the events), after one warm-up
    call (``warmup=False``: none, for the plain paths, which build
    nothing)."""
    import torch

    if prepare is not None and warmup:
        prepare()
    if warmup:
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


def device_ms(run, kernel: str, prepare=None, reps: int = 5) -> float:
    """Mean device time in ms of the kernels whose name holds ``kernel``
    over ``reps`` calls of ``run()`` under torch.profiler, after a warm-up
    step of as many, in up to five traces (a trace can lose its device
    events; NaN when all five did): the kernel alone, without the
    wrapper's host work that :func:`time_ms` includes (40-70 us, as long
    as a short kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    times = []
    for _ in range(5):      # a trace can lose its device events: retry
        traced = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.append(p.events())
                     ) as prof:
            for _ in range(2):
                for _ in range(reps):
                    if prepare is not None:
                        prepare()
                    run()
                torch.cuda.synchronize()
                prof.step()
        times = [e.time_range.elapsed_us() for e in traced[0]
                 if e.device_type == DeviceType.CUDA and kernel in e.name] \
            if traced else []
        if times:
            break
    return sum(times) / len(times) / 1e3 if times else float("nan")


@functools.lru_cache(maxsize=None)
def rounds_model(seed: int, chunk: int, num: int, sockets: int):
    """The CPU model's rounds of each code's first shuffle
    (models/ensemble.py first_shuffle_rounds), int64[num] on the CPU."""
    from iib_project_ldpc_codes_tpu_torch.models import ensemble

    return ensemble.first_shuffle_rounds(seed, chunk, num, sockets)


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes, to compare runs and trees."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound(nbytes: int, ops: float = 0.0, ops_per_s: float = FP32_OPS_S
          ) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel moving ``nbytes`` (each
    input read once, each output written once) and doing ``ops``
    operations of a type the card runs at ``ops_per_s``."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_time_breakdown(run, decode_ms: float, kernels: dict) -> str:
    """Device time by kernel (and copy) over one ``run()`` under
    torch.profiler, and the device's idle share of ``decode_ms`` (the
    unprofiled time of one ``run()``).  A warm-up step runs first under
    the profiler's schedule and is dropped.  The trace is held to the
    launch counts of ``kernels``' wrappers over the profiled step: when a
    kernel launched more often than the trace holds it (a trace can drop a
    kernel), the busy sum lacks its time, so the idle share is "not
    measured" and the line names the kernel.  Returns one JSON line; the
    numbers are "not measured" when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        run()                                   # the warm-up step
        torch.cuda.synchronize()
        prof.step()
        before = {k: v["wrapper"].launches for k, v in kernels.items()}
        run()                                   # the profiled step
        torch.cuda.synchronize()
        launched = {k: v["wrapper"].launches - before[k]
                    for k, v in kernels.items()}
        prof.step()
    by_kernel, in_trace = {}, dict.fromkeys(kernels, 0)
    for e in traced[0] if traced else []:
        if e.device_type != DeviceType.CUDA or \
                e.name.startswith("ProfilerStep"):
            continue          # host-side ops, runtime calls, step spans
        entry = by_kernel.setdefault(e.name[:80], {"calls": 0, "us": 0.0})
        entry["calls"] += 1
        entry["us"] += e.time_range.elapsed_us()
        for k in kernels:
            if f"{k}_kernel" in e.name:
                in_trace[k] += 1
    busy_ms = sum(v["us"] for v in by_kernel.values()) / 1e3
    if busy_ms == 0:
        return json.dumps({"device_time": "not measured"})
    missing = {k: {"launched": launched[k], "in_trace": in_trace[k]}
               for k in kernels if in_trace[k] < launched[k]}
    out = {"device_us_by_kernel": by_kernel, "device_busy_ms": busy_ms,
           "decode_ms": decode_ms,
           "launches": {k: c for k, c in launched.items() if c}}
    if missing:
        out.update(device_idle_share="not measured",
                   missing_from_trace=missing)
    else:
        out["device_idle_share"] = max(0.0, 1 - busy_ms / decode_ms)
    return json.dumps(out)


def wilson(k: float, n: int, z: float = 2.576) -> tuple[float, float]:
    """The 99% Wilson interval of k successes in n trials."""
    p = k / n
    d = 1 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return c - h, c + h


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


def round_kernel_decode(c, rx, iters: int):
    """The Gallager-A decode of ``c`` through the round kernels
    (``gallager_check``, ``gallager_variable``) and the host loop, with
    ``record="total"``: what the engine ran before kernel G."""
    from iib_project_ldpc_codes_tpu_torch.ops import gallager

    graph = gallager._graph(c)
    t = graph.var_to_sock.shape[-1] if graph.irregular else DV - 1
    return gallager._round_loop(graph, rx, iters, lambda _it: t,
                                lambda _it: False, False,
                                gallager._KERNEL_PASSES, None)


def decode_smem_accesses(graph, rounds, wpc: int) -> int:
    """Kernel G's shared-memory accesses (4 bytes each) for the rounds
    ``rounds`` int[C] its codes ran: the first messages, then a round's
    check pass (every socket read, every parity written) and variable pass
    (message and parity read, message written, per real socket)."""
    import torch

    table = graph.var_to_sock[..., :graph.n, :]
    real = (table < graph.pad_pos).reshape(graph.num_codes, -1).sum(1)
    sockets = graph.chk_to_var.shape[-2] * graph.dc
    rows = graph.chk_to_var.shape[-2]
    per_round = (sockets + rows + 3 * real.to(torch.int64)) * wpc
    return int(graph.num_codes * sockets * wpc
               + (rounds.to(torch.int64) * per_round).sum())


def round_kernel_bec_decode(c, erased, iters: int):
    """The all-zero BEC decode of ``c`` through K2/K3 and the host loop
    (one host read a round): what the ensemble chunks ran before kernel
    D."""
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp

    return erasure_bp._decode_allzero(c, erased, iters,
                                      erasure_bp.check_exactly_one,
                                      erasure_bp.variable_or_update,
                                      bitops.per_trial_counts)


def erasure_decode_smem_accesses(chk_to_var, rows: int, rounds,
                                 wpc: int) -> int:
    """The least shared-memory accesses (4 bytes each) of kernel D for the
    rounds ``rounds`` int[C] its codes ran: the set-up (the known plane and
    the socket table written), a round's check pass (each socket's known
    word read, each check's summary written), and each variable's word
    written once a decode (a round's variable half updates only the words
    it makes known, and the scatter counts them from its atomics with no
    pass over the variables)."""
    import torch

    checks, dc = chk_to_var.shape[-2:]
    per_round = (checks * dc + checks) * wpc
    return int(chk_to_var.shape[0] * (2 * rows * wpc + checks * dc)
               + rounds.to(torch.int64).sum() * per_round)


def value_decode_smem_accesses(c, erased, tx, rounds) -> int:
    """The least shared-memory accesses (4 bytes each) of kernel D's value
    form on one code ``c``, a block a word, for the rounds ``rounds``
    int[W] its blocks ran: the all-zero form's
    (:func:`erasure_decode_smem_accesses`), the val plane written at
    set-up, and in each round the dc val words read for each check word
    whose exactly-one word is nonzero.  Those words are counted on the
    plain passes' host loop, which computes what the blocks compute: a
    block frozen at its fixed point has no such word."""
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp

    taught = [0]

    def counting_check(chk, known, val):
        ex, adopt = erasure_bp._check_exactly_one_xor_plain(chk, known, val)
        taught[0] += int((ex != 0).sum())
        return ex, adopt

    erasure_bp._decode_values(
        c, erased, tx, int(rounds.max()),
        (counting_check, erasure_bp._variable_or_adopt_plain,
         bitops._per_trial_counts_plain), False)
    rows, words = erased.shape
    return erasure_decode_smem_accesses(
        c.chk_to_var.expand(words, -1, -1), rows, rounds, 1) \
        + rows * words + c.chk_to_var.shape[-1] * taught[0]


def k4_exact_on_path_planes(dev, erased) -> bool:
    """K4 against its plain version on the planes the paths give it: the
    headline erasures and an all-ones plane (n = 10^4, W = 768: the fixed
    and ensemble BEC and Gallager chunks), the random BEC's ``~known |
    ((val ^ tx) & known)`` on random planes, the ensemble random chunk's
    n = 2048, the edge path's n = 10^6, W = 48, one word, and odd widths
    with rows on both sides of the 16-row step and of a block's runs."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.ops import bitops

    def planes():
        yield "headline", erased
        yield "ones", torch.full_like(erased, -1)
        known, val, tx = (bitops.bernoulli_packed(p, erased.shape, seed=s,
                                                  device=dev)
                          for p, s in ((0.6, 41), (0.5, 42), (0.5, 43)))
        yield "random_bec", ~known | ((val ^ tx) & known)
        yield "n2048", bitops.bernoulli_packed(0.4, (N_RT_ENS, WORDS_FULL),
                                               seed=44, device=dev)
        yield "edge", bitops.bernoulli_packed(EPS_FULL, (N_EDGE, W_EDGE),
                                              seed=45, device=dev)
        for n, w in ((N_FULL, 1), (1025, 3), (1023, 5), (129, 48), (17, 5),
                     (1, 1)):
            yield f"n{n}_w{w}", bitops.bernoulli_packed(
                0.5, (n, w), seed=n + w, device=dev)

    equal = {name: torch.equal(bitops.per_trial_counts(x),
                               bitops._per_trial_counts_plain(x))
             for name, x in planes()}
    print(f"K4 == plain on the paths' planes: {equal}", flush=True)
    return all(equal.values())


def erasure_decode_phase(dev, batch_codes, erased, kernels) -> dict:
    """Phase 9's kernel D part: the whole decode against its plain version
    on all three outputs (known, per-code round_errors, rounds) at 768 codes of n = 10^4 (regular and irregular) at
    eps = 0.42, 0 and 1, at budgets of 50, 0 and 1 rounds, and on a batch
    whose last code to move reaches zero while another is stuck; the
    assembled decode against the K2/K3 decode and the plain one; the rule
    on the wpc-24 batch.  Returns kernel D's row of the JSON line (its
    times come in phase 12)."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.models import irregular
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp

    codes = batch_codes[1]
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(N_FULL, LAM_BEC, RHO6,
                                                        device=dev)
    irr = erasure_bp._phantom_view(irregular.sample_irregular_codes(
        1, 0, CODES_FULL, spec, "repair", device=dev))
    converging = bitops.bernoulli_packed(0.3, tuple(erased.shape), seed=9,
                                         device=dev)
    converging[:, 0] = -1                     # code 0: every bit erased
    cases = {
        "regular_768": (codes, erased, ITERS),
        "irregular_768": (irr, erasure_bp._pad_phantom_row(erased), ITERS),
        "eps_0": (codes, torch.zeros_like(erased), ITERS),
        "eps_1": (codes, torch.full_like(erased, -1), ITERS),
        "iters_0": (codes, erased, 0),
        "iters_1": (codes, erased, 1),
        "stuck_and_zero": (codes, converging, ITERS)}
    err_d, rounds_of = 0, {}
    for label, (c, planes, iters) in cases.items():
        want = erasure_bp._erasure_decode_plain(planes, c.chk_to_var,
                                                c.var_to_chk, iters)
        got = erasure_bp.erasure_decode(planes, c.chk_to_var, c.var_to_chk,
                                        iters)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        check(err == 0, f"kernel D ({label}) differs from its plain version "
                        f"(max |d| {err})")
        err_d = max(err_d, err)
        rounds = want[2]
        rounds_of[label] = rounds
        print(f"kernel D {label}: equal to plain on known, "
              f"round_errors and rounds; rounds max {int(rounds.max())}, "
              f"mean {float(rounds.float().mean()):.2f}, erasures "
              f"{int(want[1][:, 0].sum())} -> {int(want[1][:, -1].sum())}",
              flush=True)
    r = rounds_of
    check(int(r["eps_0"].max()) == 0 and bool((r["eps_1"] == 1).all())
          and int(r["iters_0"].max()) == 0 and bool((r["iters_1"] == 1).all()),
          "kernel D: rounds at eps 0 / 1 or at budgets 0 / 1")
    stuck = r["stuck_and_zero"]
    check(int(stuck[0]) == 1 and 1 < int(stuck[1:].max()) < ITERS,
          f"kernel D: the stuck code ran {int(stuck[0])} rounds, the others "
          f"up to {int(stuck[1:].max())}")
    # the assembled decode: D's sums against the host loop's (the K2/K3
    # decode and the plain one), "one more" round included
    for label in ("regular_768", "stuck_and_zero"):
        c, planes, iters = cases[label]
        before = kernels["erasure_decode"]["wrapper"].launches
        got = erasure_bp.bp_decode_packed_allzero(c, planes, iters)
        check(kernels["erasure_decode"]["wrapper"].launches == before + 1,
              f"the decode of {label} did not take kernel D")
        for name, want in (("K2/K3", round_kernel_bec_decode(c, planes,
                                                             iters)),
                           ("plain", erasure_bp.bp_decode_packed_allzero_plain(
                               c, planes, iters))):
            check(torch.equal(got.known, want.known)
                  and torch.equal(got.error_totals, want.error_totals)
                  and got.iterations == want.iterations,
                  f"decode of {label} by kernel D differs from the {name} "
                  "decode")
        print(f"decode {label} by kernel D == K2/K3 == plain: iterations "
              f"{got.iterations} (codes' rounds max "
              f"{int(rounds_of[label].max())})", flush=True)
    # the last code to move reached zero beside a stuck one: the summed
    # count needs one more, unchanged round to stop
    check(got.iterations == int(stuck.max()) + 1,
          f"the stuck batch's decode ran {got.iterations} rounds")
    # the wpc-24 batch keeps K2/K3 by the rule
    wide = batch_codes[24]
    check(not erasure_bp.takes_erasure_decode_kernel(wide, WORDS_FULL),
          "the rule takes kernel D for 24 words a code")
    counts = {k: kernels[k]["wrapper"].launches
              for k in ("erasure_decode",) + ROUND_PAIR}
    erasure_bp.bp_decode_packed_allzero(wide, erased, ITERS)
    torch.cuda.synchronize()
    used = {k: kernels[k]["wrapper"].launches - v for k, v in counts.items()}
    check(used["erasure_decode"] == 0 and used["check_exactly_one"] > 0,
          f"the wpc-24 decode launched {used}")
    print(f"wpc 24 ({wide.num_codes} codes) routes to K2/K3: {used}",
          flush=True)
    return {"max_abs_err": err_d, "library_ms": None,
            "rounds_768": {"max": int(r["regular_768"].max()),
                           "sum": int(r["regular_768"].sum()),
                           "mean": float(r["regular_768"].float().mean())}}


def erasure_decode_timing(codes, erased) -> dict:
    """Phase 12's kernel D part at 768 codes of n = 10^4: the wrapper
    beside its plain version, and its bound for the rounds this run's codes
    ran (the bytes: the socket table, the erased and known planes, the
    counts)."""
    from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp

    def run():
        return erasure_bp.erasure_decode(erased, codes.chk_to_var,
                                         codes.var_to_chk, ITERS)

    ms = time_ms(run)
    known, round_errors, rounds = run()
    wpc = erased.shape[1] // codes.num_codes
    accesses = erasure_decode_smem_accesses(codes.chk_to_var, codes.n,
                                            rounds, wpc)
    row = dict(
        ms=ms,
        plain_ms=time_ms(lambda: erasure_bp._erasure_decode_plain(
            erased, codes.chk_to_var, codes.var_to_chk, ITERS), reps=1,
            warmup=False),
        ms_per_round=ms / int(rounds.max()), smem_accesses=accesses,
        **bound(nbytes(codes.chk_to_var, erased, known, round_errors,
                       rounds), accesses, SMEM_ACCESS_S))
    print(f"kernel D at {codes.num_codes} codes, n = {codes.n}: "
          f"{row['ms']:.4f} ms, {row['ms_per_round']:.4f} a round of the "
          f"longest code; bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"plain {row['plain_ms']:.1f} ms", flush=True)
    return row


def gallager_decode_phase(dev, cases) -> dict:
    """Phase 14's kernel G part: the whole decode against its plain
    version on all three outputs at 768 codes of n = 10^4 (regular and
    irregular, without and with a plane of errors counted against: random
    bits), then on small adversarial batches (thresholds from "always
    flips" to "never flips", random change_ahead flags, budgets of 0, 1
    and 50 rounds, 1 and 3 words a code, degrees up to 6); its times and
    bound.  Returns kernel G's row of the JSON line."""
    import numpy as np
    import torch

    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, gallager

    def both(args, kw):
        got = gallager.gallager_decode(*args, **kw)
        want = gallager._gallager_decode_plain(*args, **kw)
        torch.cuda.synchronize()
        return got, max(max_abs_err(a, b) for a, b in zip(got, want))

    row, err_g, timed = {}, 0, {}
    for label in ("regular_768", "irregular_768"):
        c, rx = cases[label]
        graph = gallager._graph(c)
        t = graph.var_to_sock.shape[-1] if graph.irregular else DV - 1
        per_round = (torch.full((ITERS,), t, dtype=torch.int32, device=dev),
                     torch.zeros(ITERS, dtype=torch.int32, device=dev))
        noise = bitops.bernoulli_packed(0.5, tuple(rx.shape), seed=8,
                                        device=dev)
        for tx in (None, noise):
            args = (rx if tx is None else rx ^ tx, graph.chk_to_var,
                    graph.var_to_sock, *per_round)
            kw = dict(dc=graph.dc, pad_pos=graph.pad_pos,
                      clamp=graph.irregular, tx=tx)
            got, err = both(args, kw)
            check(err == 0, f"kernel G ({label}, tx={tx is not None}) "
                            f"differs from its plain version (max |d| {err})")
            err_g = max(err_g, err)
            rounds = got[2]
            print(f"kernel G {label} tx={tx is not None}: equal to plain on "
                  f"decided, round_errors and rounds; rounds max "
                  f"{int(rounds.max())}, mean {float(rounds.float().mean()):.2f}"
                  f", errors {int(got[1][:, 0].sum())} -> "
                  f"{int(got[1][:, -1].sum())}", flush=True)
            timed[label, tx is not None] = (args, kw, graph, rounds)
    # small adversarial batches
    lam_wide, rho_wide = [0, 0.3, 0.3, 0, 0, 0.4], [0, 0, 0, 0, 0, 0.5, 0.5]
    rng = np.random.default_rng(5)
    small = 0
    for family in ("regular", "dv5", "irregular", "wide"):
        for wpc, num in ((1, 40), (3, 7)):
            if family in ("regular", "dv5"):
                dv, dc = (DV, DC) if family == "regular" else (5, 10)
                codes = ensemble.sample_codes(5, 0, num, 600, dv, dc,
                                              "repair", device=dev)
            else:
                spec = irregular.IrregularEnsembleSpec.from_lam_rho(
                    600, *((LAM_GAL, RHO6) if family == "irregular"
                           else (lam_wide, rho_wide)), device=dev)
                codes = irregular.sample_irregular_codes(5, 0, num, spec,
                                                         device=dev)
            graph = gallager._graph(codes)
            dv = graph.var_to_sock.shape[-1]
            flips = torch.cat([bitops.bernoulli_packed(
                float(p), (600, wpc), seed=5, offset=g, device=dev)
                for g, p in enumerate(np.linspace(0.0, 0.12, num))], dim=1)
            noise = bitops.bernoulli_packed(0.5, tuple(flips.shape), seed=6,
                                            device=dev)
            for iters in (0, 1, ITERS):
                per_round = [torch.from_numpy(x.astype(np.int32)).to(dev)
                             for x in (rng.integers(-1, dv + 2, size=iters),
                                       rng.random(iters) < 0.3)]
                for tx in (None, noise):
                    got, err = both(
                        (flips if tx is None else flips ^ tx,
                         graph.chk_to_var, graph.var_to_sock, *per_round),
                        dict(dc=graph.dc, pad_pos=graph.pad_pos,
                             clamp=graph.irregular, tx=tx))
                    check(err == 0, f"kernel G ({family}, wpc {wpc}, "
                                    f"{iters} rounds, tx={tx is not None})"
                                    f" differs from its plain version")
                    check(int(got[2][0]) == 0, "kernel G ran rounds on a "
                                               "code without errors")
                    small += 1
    print(f"kernel G equal to plain on {small} small adversarial batches "
          "(n = 600; (3,6), (5,10), dv 3/4 and dv 2/3/6 irregular; 1 and 3 "
          "words a code; budgets 0, 1, 50; random thresholds and "
          "change_ahead; with and without tx)", flush=True)
    # times at 768 codes, and the bound of this run's rounds
    for (label, with_tx), (args, kw, graph, rounds) in timed.items():
        key = label + ("_tx" if with_tx else "")
        row[f"{key}_ms"] = time_ms(lambda: gallager.gallager_decode(*args,
                                                                    **kw))
        if not with_tx:
            row[f"{key}_plain_ms"] = time_ms(
                lambda: gallager._gallager_decode_plain(*args, **kw),
                reps=1, warmup=False)
            wpc = args[0].shape[1] // graph.num_codes
            outputs = gallager.gallager_decode(*args, **kw)
            row[f"{key}_rounds"] = {
                "max": int(rounds.max()), "sum": int(rounds.sum()),
                "mean": float(rounds.float().mean())}
            row[f"{key}_ms_per_round"] = row[f"{key}_ms"] / int(rounds.max())
            row[f"{key}_bound"] = bound(
                nbytes(*args, *outputs),
                decode_smem_accesses(graph, rounds, wpc), SMEM_ACCESS_S)
    row.update(max_abs_err=err_g, ms=row["regular_768_ms"],
               plain_ms=row["regular_768_plain_ms"], library_ms=None,
               **row["regular_768_bound"])
    print(f"kernel G at 768 codes, n = {N_FULL}: regular "
          f"{row['regular_768_ms']:.4f} ms ({row['regular_768_ms_per_round']:.4f}"
          f" a round of the longest code; bound {row['bound_ms']:.4f} ms, "
          f"{row['bound_by']}; plain {row['plain_ms']:.1f} ms), irregular "
          f"{row['irregular_768_ms']:.4f} ms, with tx "
          f"{row['regular_768_tx_ms']:.4f} / {row['irregular_768_tx_ms']:.4f}"
          " ms", flush=True)
    return row


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
          "decode (kernel D on one code and on 768)")
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
    # the layouts' edges on the regular spec, and n = 16,384
    for n_s, num_s, methods in (
            (EDGE_SHARED_N, 2, ("raw", "repair", "reject")),
            (EDGE_SHARED_N + 2, 2, ("raw", "repair", "reject")),
            (PEEL_N, 400, ("raw", "repair"))):
        sp = irregular.IrregularEnsembleSpec.regular(n_s, DV, DC, device=dev)
        for method in methods:
            got = irregular.sample_irregular_codes(3, 1, num_s, sp, method,
                                                   device=dev)
            want = irregular._sample_irregular_codes_plain(3, 1, num_s, sp,
                                                           method, dev)
            torch.cuda.synchronize()
            err = max(max_abs_err(getattr(got, f), getattr(want, f))
                      for f in tables)
            check(err == 0, f"irregular sampler ({method}, n={n_s}, "
                            f"C={num_s}) differs from its plain version "
                            f"(max |d| {err})")
            err_s = max(err_s, err)
            print(f"irregular sampler {method} equal to plain at n={n_s}, "
                  f"C={num_s} (layout {ensemble.sampler_layout(sp.E)[0]})",
                  flush=True)
    rounds = torch.zeros(CODES_FULL, dtype=torch.int32, device=dev)
    irregular.sample_irregular_codes(1, 0, CODES_FULL, spec, "repair",
                                     device=dev, rounds=rounds)
    want = rounds_model(1, 0, CODES_FULL, spec.E)
    check(torch.equal(rounds.cpu().long(), want),
          "the irregular sampler's rounds differ from the CPU model's")
    measured["sample_irregular_codes"].update(
        rounds_mean=float(want.double().mean()), rounds_max=int(want.max()))
    print(f"irregular sampler rounds per code (E={spec.E}, C={CODES_FULL}): "
          f"mean {float(want.double().mean()):.3f}, largest "
          f"{int(want.max())} (equal to the CPU model's)", flush=True)
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
            1, 0, 32, spec_small, "reject", device=dev), reps=2),
        **bound(nbytes(*(getattr(sampled["repair"], f) for f in tables)),
                CODES_FULL * spec.E / 2 * PHILOX_OPS, INT32_OPS_S))
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
    # the generic degree path (no template, one word a thread): one (5,10)
    # and one (9,18) code
    generic = {f"dv{dv}_one": ensemble.sample_codes(
        5, 0, 1, N_FULL, dv, 2 * dv, "repair", device=dev).select(0)
        for dv in (5, 9)}
    tx14 = bitops.bernoulli_packed(0.5, (N_FULL, WORDS_FULL), seed=8,
                                   device=dev)
    cases = {"regular_one": (code, flips), "regular_768": (batch768, flips),
             "irregular_one": (gal_irr.select(0), flips_irr),
             "irregular_768": (gal_irr, flips_irr)}
    err_c = err_v = 0
    pass_ms, bounds, widths = {}, {}, {}
    for label, (c, rx) in {**cases, **{k: (c, flips) for k, c in
                                        generic.items()}}.items():
        graph = gallager._graph(c)
        t = graph.var_to_sock.shape[-1] - (0 if graph.irregular else 1)
        channel = erasure_bp._pad_phantom_row(rx) if graph.irregular else rx
        msg0 = gallager._initial_messages(graph.chk_to_var, channel)
        num = graph.num_codes
        parity = gallager.gallager_check(msg0, graph.dc)
        widths[label] = {"check": gallager.gallager_check.vec}
        parity_p = gallager._gallager_check_plain(msg0, graph.dc)
        err = max_abs_err(parity, parity_p)
        check(err == 0, f"Gallager check kernel ({label}) differs from its "
                        f"plain version (max |d| {err})")
        err_c = max(err_c, err)
        active = torch.ones(num, dtype=torch.int32, device=dev)
        pass_ms[label] = dict(
            check_ms=time_ms(lambda: gallager.gallager_check(msg0,
                                                             graph.dc)),
            check_device_ms=device_ms(lambda: gallager.gallager_check(
                msg0, graph.dc), "gallager_check_kernel"),
            check_plain_ms=time_ms(lambda: gallager._gallager_check_plain(
                msg0, graph.dc), reps=2))
        bounds[label] = {"check": bound(nbytes(msg0, parity))["bound_ms"]}
        for tx in (None, tx14):
            key = "tx" if tx is not None else "no_tx"
            sent = rx if tx is None else rx ^ tx
            state = {}

            def fresh():
                state["msg"] = msg0.clone()
                state["decided"] = sent.clone()
                state["counts"] = torch.zeros((num, 2), dtype=torch.int32,
                                              device=dev)

            def run(fn):
                fn(state["msg"], parity, sent, graph.var_to_sock, active,
                   state["decided"], state["counts"], dc=graph.dc,
                   pad_pos=graph.pad_pos, threshold=t, clamp=graph.irregular,
                   tx=tx)

            fresh()
            run(gallager.gallager_variable)
            # the words a thread of the launch the wrapper made
            widths[label][f"variable_{key}"] = gallager.gallager_variable.vec
            got = (state["msg"], state["decided"], state["counts"])
            fresh()
            run(gallager._gallager_variable_plain)
            torch.cuda.synchronize()
            err = max(max_abs_err(x, y) for x, y in zip(
                got, (state["msg"], state["decided"], state["counts"])))
            check(err == 0, f"Gallager variable kernel ({label}, {key}) "
                            f"differs from its plain version (max |d| {err})")
            err_v = max(err_v, err)
            pass_ms[label][f"variable_{key}_ms"] = time_ms(
                lambda: run(gallager.gallager_variable), prepare=fresh)
            pass_ms[label][f"variable_{key}_device_ms"] = device_ms(
                lambda: run(gallager.gallager_variable),
                "gallager_variable_kernel", prepare=fresh)
            if tx is None:
                pass_ms[label]["variable_plain_ms"] = time_ms(
                    lambda: run(gallager._gallager_variable_plain),
                    prepare=fresh, reps=1)
            # messages read and written, parity, channel, the table,
            # flags, decision and counts (and tx), each once
            bounds[label][f"variable_{key}"] = bound(nbytes(
                msg0, msg0, parity, rx, graph.var_to_sock, active, rx,
                state["counts"], *(() if tx is None else (tx,))))["bound_ms"]
        print(f"{label}: passes equal to plain (tx off and on); words a "
              f"thread {widths[label]}; ms (device ms) check "
              f"{pass_ms[label]['check_ms']:.4f} "
              f"({pass_ms[label]['check_device_ms']:.4f}), plain "
              f"{pass_ms[label]['check_plain_ms']:.3f}; variable "
              f"{pass_ms[label]['variable_no_tx_ms']:.4f} "
              f"({pass_ms[label]['variable_no_tx_device_ms']:.4f}), tx "
              f"{pass_ms[label]['variable_tx_ms']:.4f} "
              f"({pass_ms[label]['variable_tx_device_ms']:.4f}), plain "
              f"{pass_ms[label]['variable_plain_ms']:.3f}; bounds "
              f"{bounds[label]}", flush=True)
    check(widths["regular_one"] == {"check": 4, "variable_no_tx": 4,
                                    "variable_tx": 4}
          and widths["irregular_one"]["variable_no_tx"] == 4
          and widths["regular_768"]["variable_no_tx"] == 1
          and widths["dv5_one"]["variable_no_tx"] == 1
          and widths["dv9_one"]["variable_no_tx"] == 1,
          f"round kernels' words a thread {widths}")
    # the main path is the fixed code's (one code at W = 768); the expurgated
    # ensemble chunks launch the variable kernel at 768 codes of one word
    one, many = pass_ms["regular_one"], pass_ms["regular_768"]
    measured["gallager_check"].update(
        max_abs_err=err_c, ms=one["check_ms"], plain_ms=one["check_plain_ms"],
        bound_ms=bounds["regular_one"]["check"], bound_by="bytes",
        device_ms=one["check_device_ms"],
        batched_768_device_ms=many["check_device_ms"],
        irregular_one_ms=pass_ms["irregular_one"]["check_ms"],
        batched_768_ms=many["check_ms"],
        batched_768_plain_ms=many["check_plain_ms"],
        batched_768_bound_ms=bounds["regular_768"]["check"],
        irregular_768_ms=pass_ms["irregular_768"]["check_ms"],
        generic_dc10_ms=pass_ms["dv5_one"]["check_ms"],
        generic_dc10_device_ms=pass_ms["dv5_one"]["check_device_ms"])
    measured["gallager_variable"].update(
        max_abs_err=err_v, ms=one["variable_no_tx_ms"],
        plain_ms=one["variable_plain_ms"],
        bound_ms=bounds["regular_one"]["variable_no_tx"], bound_by="bytes",
        device_ms=one["variable_no_tx_device_ms"],
        tx_ms=one["variable_tx_ms"],
        tx_device_ms=one["variable_tx_device_ms"],
        tx_bound_ms=bounds["regular_one"]["variable_tx"],
        irregular_one_ms=pass_ms["irregular_one"]["variable_no_tx_ms"],
        irregular_one_tx_ms=pass_ms["irregular_one"]["variable_tx_ms"],
        irregular_one_device_ms=pass_ms["irregular_one"][
            "variable_no_tx_device_ms"],
        batched_768_ms=many["variable_no_tx_ms"],
        batched_768_device_ms=many["variable_no_tx_device_ms"],
        batched_768_plain_ms=many["variable_plain_ms"],
        batched_768_bound_ms=bounds["regular_768"]["variable_no_tx"],
        batched_768_tx_ms=many["variable_tx_ms"],
        irregular_768_ms=pass_ms["irregular_768"]["variable_no_tx_ms"],
        irregular_768_plain_ms=pass_ms["irregular_768"]["variable_plain_ms"],
        irregular_768_device_ms=pass_ms["irregular_768"][
            "variable_no_tx_device_ms"],
        generic_dv5_ms=pass_ms["dv5_one"]["variable_no_tx_ms"],
        generic_dv5_device_ms=pass_ms["dv5_one"]["variable_no_tx_device_ms"],
        generic_dv9_device_ms=pass_ms["dv9_one"]["variable_no_tx_device_ms"],
        words_a_thread=widths)
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
    measured["gallager_decode"].update(gallager_decode_phase(dev, cases))
    # the expurgated ensemble Gallager-A chunk (768 codes of one word,
    # record="per_trial") keeps the round kernels: their launches a chunk
    cfg_x = SimulationConfig(
        n=N_FULL, iterations=ITERS, batch=32 * WORDS_FULL,
        codes_per_chunk=CODES_FULL, seed=1, dv=DV, dc=DC,
        code_mode="ensemble", channel="BSC", decoder="gallager",
        channel_param=P_GAL, expurgation=2)
    chunk_x = mc.make_chunk_fn(cfg_x, None, device=dev)
    gal = ("gallager_check", "gallager_variable", "gallager_decode")
    before = {k: kernels[k]["wrapper"].launches for k in gal}
    int(chunk_x(0).block_errors)
    torch.cuda.synchronize()
    used = {k: kernels[k]["wrapper"].launches - before[k] for k in gal}
    check(used["gallager_variable"] == used["gallager_check"] > 0
          and used["gallager_decode"] == 0,
          f"the expurgated Gallager-A chunk launched {used}")
    measured["gallager_variable"]["launches_expurgated_chunk"] = \
        used["gallager_variable"]
    print(f"expurgated ensemble Gallager-A chunk (n={N_FULL}, "
          f"{CODES_FULL} codes): launches {used}", flush=True)

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
        gal = ("gallager_decode", "gallager_variable")
        for k in gal:
            kernels[k]["wrapper"].launches = 0
        r_gpu = mc.run_simulation(cfg, fixed, device="cuda")
        used = {k: kernels[k]["wrapper"].launches for k in gal}
        r_cpu = mc.run_simulation(cfg, fixed, device="cpu")
        for field in ("num_trials", "block_errors", "bit_errors",
                      "excluded_trials", "bit_errors_sq",
                      "code_bit_errors_sq", "trials_per_code",
                      "error_counts_per_iteration", "stopped_by"):
            check(getattr(r_gpu, field) == getattr(r_cpu, field),
                  f"cuda and cpu differ in {field} ({fields}): "
                  f"{getattr(r_gpu, field)} vs {getattr(r_cpu, field)}")
        if cfg.decoder == "gallager":
            # kernel G: the ensemble chunks of one word a code without
            # expurgation; the round kernels: expurgated and fixed chunks
            whole = cfg.code_mode == "ensemble" and cfg.expurgation is None
            check((used["gallager_decode"] > 0) == whole
                  and (used["gallager_variable"] > 0) != whole,
                  f"Gallager route on {fields}: {used}")
        print(f"{cfg.channel} {cfg.decoder} "
              f"{'irregular' if cfg.irregular else '(3,6)'} {cfg.code_mode} "
              f"expurgation={cfg.expurgation}: identical, block_errors "
              f"{r_gpu.block_errors}, bit_errors {r_gpu.bit_errors}"
              + (f"; launches {used}" if cfg.decoder == "gallager" else ""),
              flush=True)

    # -- 16 -------------------------------------------------------------------
    phase("16 the new paths through cli.main at n=1e4, batch 24576, "
          f"{CODES_FULL} codes per chunk, 2 chunks each")
    paths = {
        "bec_irregular": (dict(channel_param=EPS_FULL, lam=LAM_BEC,
                               rho=RHO6),
                          ("bernoulli_packed", "per_trial_counts")),
        "gallager_36": (dict(channel="BSC", decoder="gallager",
                             channel_param=P_GAL),
                        ("bernoulli_packed", "per_trial_counts")),
        "gallager_irregular": (dict(channel="BSC", decoder="gallager",
                                    channel_param=P_GAL_IRR, lam=LAM_GAL,
                                    rho=RHO6),
                               ("bernoulli_packed", "per_trial_counts"))}
    sampler_of = {"bec_irregular": "sample_irregular_codes",
                  "gallager_36": "sample_regular_codes",
                  "gallager_irregular": "sample_irregular_codes"}
    # the decodes by shape (ops/gallager.py::takes_decode_kernel, ops/
    # erasure_bp.py::erasure_decode_block_words): kernels G and D on the
    # ensemble chunks (one word a code), kernel D on the fixed BEC code (a
    # block a word) and the Gallager round kernels on the fixed code at 768
    # words; the other route is not launched
    rounds_pair = ("gallager_check", "gallager_variable")
    route = {("gallager", "ensemble"): (("gallager_decode",), rounds_pair),
             ("gallager", "fixed"): (rounds_pair, ("gallager_decode",)),
             ("bec", "ensemble"): (("erasure_decode",), ROUND_PAIR),
             ("bec", "fixed"): (("erasure_decode",), ROUND_PAIR)}
    by_path = {name: {} for name in kernels}
    results = {}
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        for path, (fields, uses) in paths.items():
            for mode in ("ensemble", "fixed"):
                name = f"{path}_{mode}"
                needed = uses + ((sampler_of[path],) if mode == "ensemble"
                                 else ())
                needed += route[path.split("_")[0], mode][0]
                idle = route[path.split("_")[0], mode][1]
                for k in kernels.values():
                    k["wrapper"].launches = 0
                t0 = time.perf_counter()
                res = cli_run(tmp, name, code_mode=mode, n=N_FULL,
                              iterations=ITERS, batch=32 * WORDS_FULL,
                              codes_per_chunk=CODES_FULL,
                              num_tests=2 * 32 * WORDS_FULL, seed=1,
                              **fields)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {k: v["wrapper"].launches
                            for k, v in kernels.items()}
                for k in needed:
                    check(launches[k] > 0,
                          f"kernel {k} was not launched on the {name} path")
                    by_path[k][name] = launches[k]
                for k in idle:
                    check(launches[k] == 0, f"kernel {k} was launched "
                                            f"{launches[k]} times on {name}")
                    by_path[k][name] = 0
                rates = res.error_rate_per_iteration
                check(res.num_trials == 2 * 32 * WORDS_FULL,
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
        for k in kernels.values():
            k["wrapper"].launches = 0
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
        # the brackets' 256 codes of n = 1024 at one word a code
        gal = {k: kernels[k]["wrapper"].launches
               for k in ("gallager_decode",) + rounds_pair}
        check(gal["gallager_decode"] > 0 and gal["gallager_variable"] == 0
              and gal["gallager_check"] == 0,
              f"the n=1024 Gallager brackets launched {gal}")
        brackets["gallager_launches"] = gal
        print(json.dumps({"threshold_brackets_n1024": brackets}), flush=True)
    measured["sample_irregular_codes"]["launches"] = \
        by_path["sample_irregular_codes"]["bec_irregular_ensemble"]
    measured["gallager_decode"]["launches"] = \
        by_path["gallager_decode"]["gallager_36_ensemble"]
    for k in rounds_pair:                # the fixed code's path since kernel G
        measured[k]["launches"] = by_path[k]["gallager_36_fixed"]
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
        # "kernel": kernel D (a block a code at 768 codes, a block a word on
        # one code); "rounds": the K2/K3 decode that D replaced
        turns = (("plain", lambda: irregular_plain(c, erased, ITERS)),
                 ("kernel", lambda: erasure_bp
                  .bp_decode_packed_allzero_irregular(c, erased, ITERS)),
                 ("rounds", lambda: round_kernel_bec_decode(
                     erasure_bp._phantom_view(c),
                     erasure_bp._pad_phantom_row(erased), ITERS)),
                 ("rounds", lambda: round_kernel_bec_decode(
                     erasure_bp._phantom_view(c),
                     erasure_bp._pad_phantom_row(erased), ITERS)),
                 ("kernel", lambda: erasure_bp
                  .bp_decode_packed_allzero_irregular(c, erased, ITERS)),
                 ("plain", lambda: irregular_plain(c, erased, ITERS)))
        for name, fn in turns:
            decode_ms.setdefault(f"{label}_{name}", []).append(
                time_ms(fn, reps=1 if name == "plain" else 3))
    # record="total" decodes: at 768 codes three ways -- the engine's route
    # (kernel G), the round kernels with the host loop, and plain
    for label, (c, rx, kern, plain) in decodes.items():
        turns = (("plain", plain), ("kernel", kern), ("kernel", kern),
                 ("plain", plain))
        if label.endswith("_768"):
            turns = turns[:2] + (("rounds", round_kernel_decode),) * 2 + \
                turns[2:]
        for name, fn in turns:
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
    for name in ("gallager_36_ensemble", "gallager_irregular_ensemble"):
        chunk_ms = sum(chunk_s[name]) / len(chunk_s[name]) * 1e3
        print(f"{name} chunk ({chunk_ms:.3f} ms) by device time: "
              + device_time_breakdown(lambda: int(
                  chunk_fns[name](5).block_errors), chunk_ms, kernels),
              flush=True)


def misaligned(t, align: int):
    """A contiguous copy of ``t`` whose data pointer lies ``align`` bytes
    past a 16-byte boundary, as a view into a larger buffer."""
    import torch

    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    skip = align // t.element_size()
    while buf[skip:].data_ptr() % 16 != align % 16:
        skip += 1
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def posterior_cases(dev, llr, batch) -> dict:
    """Kernel B against its plain version where phase 18's main cases do
    not reach, per working type, at both count widths: 768 codes of 4 and
    of 8 trials with msg and pm 8 and 4 bytes past a 16-byte boundary (the
    narrower widths); 64 codes of n = 2048 with dv = 12 (the generic
    degree path); the 768 codes at 24,576 trials with a third of the codes
    stopped (their pm columns untouched, their counts 0).  Returns each
    case's trials a thread by type."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.kernels import alignment
    from iib_project_ldpc_codes_tpu_torch.models import ensemble
    from iib_project_ldpc_codes_tpu_torch.ops import soft_bp

    dv12 = soft_bp._graph(ensemble.sample_codes(2, 0, 64, 2048, 12, 24,
                                                "repair", device=dev))
    graph = soft_bp._graph(batch)
    stopped = (torch.arange(CODES_SOFT, device=dev) % 3 != 0) \
        .to(torch.int32)
    cases = {"cpc4_align8": (graph, 4 * CODES_SOFT, 8, None),
             "cpc8_align4": (graph, 8 * CODES_SOFT, 4, None),
             "dv12_64_codes": (dv12, 32 * 64, 16, None),
             "stopped_third": (graph, COLS_SOFT, 16, stopped)}
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for label, (g, cols, align, active) in cases.items():
        num = g.num_codes
        if active is None:
            active = torch.ones(num, dtype=torch.int32, device=dev)
        on = active.bool().repeat_interleave(cols // num)
        out[label] = {}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                            ("int8", torch.int8)):
            llr_c = llr[:g.n, :cols].contiguous()
            msg = torch.randn((g.msg_rows, cols), generator=gen,
                              device=dev) * 6
            if dtype == torch.int8:
                llr0, msg = (soft_bp._quantise(x, 4.0) for x in (llr_c, msg))
            else:
                llr0, msg = llr_c, msg.to(dtype)
            pm0 = torch.full(llr0.shape, 3, dtype=dtype, device=dev)
            msg = misaligned(msg, align)
            for width in (cols, num):
                p_k, p_p = misaligned(pm0, align), pm0.clone()
                c_k, c_p = (torch.zeros(width, dtype=torch.int32, device=dev)
                            for _ in range(2))
                soft_bp.soft_posterior(llr0, msg, g.var_to_sock, active, p_k,
                                       c_k, pad_pos=g.pad_pos)
                soft_bp._soft_posterior_plain(llr0, msg, g.var_to_sock,
                                              active, p_p, c_p,
                                              pad_pos=g.pad_pos)
                torch.cuda.synchronize()
                check(torch.equal(p_k, p_p) and torch.equal(c_k, c_p)
                      and bool((p_k[:, ~on] == 3).all())
                      and int(c_p.sum()) > 0,
                      f"kernel B ({label}, {name}, counts of width {width}) "
                      "differs from its plain version")
            vec = soft_bp.soft_posterior_vector(
                p_k.element_size(), cols // num, g.var_to_sock.shape[-1],
                [(alignment(t), t.element_size())
                 for t in (llr0, msg, p_k)])
            out[label][name] = vec
        print(f"kernel B {label}: equal to plain at both count widths; "
              f"trials a thread {out[label]}", flush=True)
    want = {"cpc4_align8": {"f32": 2, "bf16": 4, "int8": 4},
            "cpc8_align4": {"f32": 1, "bf16": 2, "int8": 4},
            "dv12_64_codes": {"f32": 1, "bf16": 2, "int8": 4}}
    check(all(out[k] == v for k, v in want.items()),
          f"kernel B's widths {out}, expected {want}")
    return out


def awgn_blocks_a_trip() -> int:
    """The Philox blocks kernel A draws on each trip of its main loop
    (``kPerTrip`` in its source): its SASS counts are per trip."""
    import re

    from iib_project_ldpc_codes_tpu_torch.kernels.build import SOURCE_DIR

    return int(re.search(r"constexpr int kPerTrip = (\d+);",
                         (SOURCE_DIR / "awgn_llr.cu").read_text()).group(1))


def awgn_word_checks(dev, sigmas) -> dict:
    """Kernel A's transform and division against the math library and
    ``__fdiv_rn`` over every 32-bit word (``ldpc_awgn_llr_check``, in 16
    slices of 2^28 words): r(a) within 2^-50 relative of sqrt(-2 log u1),
    cos and sin of b within 2^-50 of sincos(theta), theta = RN(2 pi u2) as
    the plain version rounds it, and the float32 quotient 2y / sigma^2 equal
    to ``__fdiv_rn``'s for every numerator the kernel can meet, at each of
    ``sigmas`` (the transform at the first).  Fails on any word outside
    them; returns the counts, the words whose float32 rounding of r
    differs, and the largest errors."""
    import numpy as np
    import torch

    from iib_project_ldpc_codes_tpu_torch.kernels import launch

    out = {}
    for k, sigma in enumerate(sigmas):
        sigma_sq = float(np.float32(sigma) * np.float32(sigma))
        counts = torch.zeros(7, dtype=torch.int64, device=dev)
        start = time.perf_counter()
        for piece in range(16):
            launch("ldpc_awgn_llr_check", dev, counts.data_ptr(),
                   piece << 28, 1 << 28, sigma_sq, 3 if k == 0 else 2)
        c = counts.cpu().tolist()
        as_double = np.array(c[5:], np.int64).view(np.float64)
        row = {"division_differ": c[3], "division_compared": c[4],
               "seconds": time.perf_counter() - start}
        if k == 0:
            row.update(r_out=c[0], r_float32_differ=c[1], cos_sin_out=c[2],
                       r_max_rel_err=float(as_double[0]),
                       cos_sin_max_abs_err=float(as_double[1]))
            check(c[0] == 0 and c[2] == 0,
                  f"kernel A's transform: {c[0]} words of r and {c[2]} of "
                  "cos / sin outside 2^-50 of the math library")
        check(c[3] == 0, f"kernel A's division at sigma {sigma}: {c[3]} of "
                         f"{c[4]} numerators differ from __fdiv_rn")
        out[f"sigma_{sigma:.6g}"] = row
    print(f"kernel A over all 2^32 words: {json.dumps(out)}", flush=True)
    return out


def soft_paths(dev, smi, measured, kernels, scratch_root) -> None:
    """Phases 18-22: soft-decision BP (module docstring).  Tolerances:
    kernel A to one float32 ulp in under 1e-5 of the entries (float64
    log/sincos on the card and on the host may round a normal apart);
    min-sum and int8 min-sum bit-exact; sum-product messages of one pass
    to 0.1 (float32) / 0.5 (bfloat16), the slope of 2 atanh at the clip
    0.999999 times a float32 ulp, and whole sum-product decodes' error
    totals to 1e-5 of the n * B decisions a round."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
    from iib_project_ldpc_codes_tpu_torch.ops import channels, soft_bp
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

    kinds = {"sumproduct_f32": ("sumproduct", torch.float32),
             "sumproduct_bf16": ("sumproduct", torch.bfloat16),
             "minsum_f32": ("minsum", torch.float32),
             "minsum_bf16": ("minsum", torch.bfloat16),
             "minsum_int8": ("minsum", torch.int8)}
    sp_atol = {torch.float32: 0.1, torch.bfloat16: 0.5}
    sigma_int8 = channels.AWGN.sigma_from_ebn0_db(1.5, 0.5)   # bench.py:122
    shape = (N_SOFT, COLS_SOFT)

    # -- 18 -------------------------------------------------------------------
    phase("18 kernels A, B and C against their plain versions at n=8192, "
          "24576 trials")
    llr = channels.awgn_llr(SIGMA_SP, shape, seed=7, offset=3, device=dev)
    key = channels.awgn_key(7)
    llr_p = channels._awgn_llr_plain(SIGMA_SP, shape, key, 3, dev)
    torch.cuda.synchronize()
    ulps = (llr.view(torch.int32).long() - llr_p.view(torch.int32).long()) \
        .abs()
    ulp_max, ulp_share = int(ulps.max()), float((ulps > 0).double().mean())
    check(ulp_max <= 1 and ulp_share < 1e-5,
          f"kernel A differs from its plain version: {ulp_max} ulps at most, "
          f"in a share {ulp_share} of the entries")
    count = llr.numel()
    # the instantiation the paths launch: no codeword plane, sigma^2 in
    # [2^-60, 2^60] (the division by products)
    sass_a = sass_loop_counts("awgn_llr_kernelILb0ELb1E")
    sass_a.pop("span")
    per_trip = awgn_blocks_a_trip()
    check(sass_a["calls"] == 0 and sass_a["fp64_guarded"] == 0,
          f"kernel A's loop holds {sass_a['calls']} calls and "
          f"{sass_a['fp64_guarded']} predicated FP64 instructions")
    words_a = awgn_word_checks(dev, (SIGMA_SP, sigma_int8))
    mean, var = float(llr.double().mean()), float(llr.double().var())
    check(abs(mean - 2 / SIGMA_SP ** 2) < 5 * (4 / SIGMA_SP ** 2 / count)
          ** 0.5 and abs(var / (4 / SIGMA_SP ** 2) - 1) < 5 * (2 / count)
          ** 0.5, f"AWGN LLR mean {mean} or variance {var} off")
    raw = float((llr < 0).double().mean())
    q_raw = 0.5 * math.erfc(1 / SIGMA_SP / math.sqrt(2))
    check(abs(raw - q_raw) < 5 * (q_raw / count) ** 0.5,
          f"raw channel BER {raw} against Q(1/sigma) {q_raw}")
    measured["awgn_llr"].update(
        max_abs_err=float((llr - llr_p).abs().max()), ulp_max=ulp_max,
        ulp_share=ulp_share,
        ms=time_ms(lambda: channels.awgn_llr(SIGMA_SP, shape, seed=7,
                                             offset=3, device=dev)),
        plain_ms=time_ms(lambda: channels._awgn_llr_plain(
            SIGMA_SP, shape, key, 3, dev), reps=1, warmup=False),
        library_ms=None,
        torch_randn_ms=time_ms(lambda: torch.randn(shape, device=dev)),
        device_ms=device_ms(lambda: channels.awgn_llr(
            SIGMA_SP, shape, seed=7, offset=3, device=dev),
            "awgn_llr_kernel"),
        # the bound counts what the function needs: the plane written once,
        # and beside it the Philox4x32-10 products (10 rounds of two 32 x 32
        # -> 64-bit products a block of four elements); the kernel's own
        # FP64 instructions a loop trip (``per_trip`` Philox blocks) at the
        # FP64 rate stand beside the bound (``kernel_ops_ms``), as K4's do
        sass=sass_a, words=words_a, blocks_a_trip=per_trip,
        philox_ms=count / 4 * PHILOX_PRODUCTS / INT32_OPS_S * 1e3,
        kernel_ops_ms=count / (4 * per_trip) * sass_a["fp64"] / FP64_INSTR_S
        * 1e3,
        **bound(nbytes(llr), count / 4 * PHILOX_PRODUCTS, INT32_OPS_S))
    del llr_p, ulps
    row = measured["awgn_llr"]
    print(f"kernel A: {ulp_max} ulp at most, share {ulp_share:.3e} of "
          f"{count} entries; mean {mean:.5f} (2/sigma^2 "
          f"{2 / SIGMA_SP ** 2:.5f}), raw BER {raw:.5f} (Q {q_raw:.5f}); "
          f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; the Philox "
          f"products {row['philox_ms']:.4f} ms); its {sass_a['fp64']} FP64 "
          f"instructions a loop trip of {4 * per_trip} elements take "
          f"{row['kernel_ops_ms']:.4f} ms at the FP64 rate ({sass_a['total']} "
          f"instructions in all, {sass_a['quarter']} conversions and special "
          f"functions, {sass_a['skipped']} behind forward branches, "
          f"{sass_a['calls']} calls, {sass_a['fp64_guarded']} predicated FP64)",
          flush=True)

    fixed = ensemble.code_for_config(SimulationConfig(
        n=N_SOFT, dv=DV, dc=DC, code_mode="fixed")).to(dev)
    batch = ensemble.sample_codes(1, 0, CODES_SOFT, N_SOFT, DV, DC, "repair",
                                  device=dev)
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(N_SOFT, LAM_BEC, RHO6,
                                                        device=dev)
    irr_batch = irregular.sample_irregular_codes(1, 0, CODES_SOFT, spec,
                                                 device=dev)
    cases = {"regular_one": fixed, "regular_768": batch,
             "irregular_one": irr_batch.select(0),
             "irregular_768": irr_batch}
    err_b, err_c, err_c_exact = 0, 0.0, 0.0
    pass_ms = {}
    l2_bytes = soft_bp.l2_bytes(torch.cuda.current_device())
    for label, c in cases.items():
        graph = soft_bp._graph(c)
        num = graph.num_codes
        llr_c = torch.cat([llr, llr.new_full((1, COLS_SOFT),
                                             soft_bp._PHANTOM_LLR)]) \
            if graph.irregular else llr
        rows = graph.chk_to_var.shape[-2]
        pad_var = graph.n if graph.irregular else -1
        active = torch.ones(num, dtype=torch.int32, device=dev)
        for kind, (method, dtype) in kinds.items():
            llr0 = soft_bp._quantise(llr_c, 4.0) if dtype == torch.int8 \
                else llr_c
            msg = torch.zeros((rows * graph.dc, COLS_SOFT), dtype=dtype,
                              device=dev)
            pm = torch.empty(llr0.shape, dtype=dtype, device=dev)
            counts = torch.zeros(COLS_SOFT, dtype=torch.int32, device=dev)
            unsat = torch.zeros(num, dtype=torch.int32, device=dev)
            kw = dict(method=method, alpha=1.0, beta=0.0, pad_var=pad_var)
            # round 1 on the plain passes: a live state for round 2
            soft_bp._soft_posterior_plain(llr0, msg, graph.var_to_sock,
                                          active, pm, counts,
                                          pad_pos=graph.pad_pos)
            soft_bp._soft_check_plain(pm, msg, graph.chk_to_var, active,
                                      unsat, **kw)
            p_k, p_p = torch.empty_like(pm), torch.empty_like(pm)
            c_k, c_p = torch.zeros_like(counts), torch.zeros_like(counts)
            # B's counts as the engine asks for totals: one per code
            w_k, w_p = (torch.zeros(num, dtype=torch.int32, device=dev)
                        for _ in range(2))
            for cnt_k, cnt_p in ((c_k, c_p), (w_k, w_p)):
                soft_bp.soft_posterior(llr0, msg, graph.var_to_sock, active,
                                       p_k, cnt_k, pad_pos=graph.pad_pos)
                soft_bp._soft_posterior_plain(llr0, msg, graph.var_to_sock,
                                              active, p_p, cnt_p,
                                              pad_pos=graph.pad_pos)
            torch.cuda.synchronize()
            e_b = max(float((p_k.float() - p_p.float()).abs().max()),
                      max_abs_err(c_k, c_p), max_abs_err(w_k, w_p))
            check(e_b == 0 and torch.equal(
                w_p, c_p.reshape(num, -1).sum(1, dtype=torch.int32)),
                  f"kernel B ({label}, {kind}) differs from its plain "
                  f"version (max |d| {e_b}) or its per-code counts from the "
                  "per-trial ones")
            m_k, m_p = msg.clone(), msg.clone()
            u_k, u_p = torch.zeros_like(unsat), torch.zeros_like(unsat)
            soft_bp.soft_check(p_p, m_k, graph.chk_to_var, active, u_k, **kw)
            soft_bp._soft_check_plain(p_p, m_p, graph.chk_to_var, active,
                                      u_p, **kw)
            torch.cuda.synchronize()
            e_c = float((m_k.float() - m_p.float()).abs().max())
            check(torch.equal(u_k, u_p) and int(u_p.sum()) > 0,
                  f"kernel C ({label}, {kind}) syndrome counts differ")
            check(e_c <= (sp_atol[dtype] if method == "sumproduct" else 0),
                  f"kernel C ({label}, {kind}) differs from its plain "
                  f"version (max |d| {e_c})")
            err_b, err_c = max(err_b, e_b), max(err_c, e_c)
            if method == "minsum":
                err_c_exact = max(err_c_exact, e_c)
            print(f"{label} {kind}: B equal to plain, C max |d| {e_c:.3g}, "
                  f"unsatisfied (check, trial) pairs {int(u_p.sum())}",
                  flush=True)
            if graph.irregular:
                continue
            ops_c = rows * COLS_SOFT * graph.dc * (7 if method == "sumproduct"
                                                   else 6)
            times = dict(
                # the engine's launch (per-code counts), and per trial
                posterior_ms=time_ms(lambda: soft_bp.soft_posterior(
                    llr0, msg, graph.var_to_sock, active, p_k, w_k,
                    pad_pos=graph.pad_pos)),
                posterior_trial_ms=time_ms(lambda: soft_bp.soft_posterior(
                    llr0, msg, graph.var_to_sock, active, p_k, c_k,
                    pad_pos=graph.pad_pos)),
                posterior_plain_ms=time_ms(
                    lambda: soft_bp._soft_posterior_plain(
                        llr0, msg, graph.var_to_sock, active, p_p, c_p,
                        pad_pos=graph.pad_pos), reps=1),
                check_ms=time_ms(lambda: soft_bp.soft_check(
                    p_p, m_k, graph.chk_to_var, active, u_k, **kw)),
                check_plain_ms=time_ms(lambda: soft_bp._soft_check_plain(
                    p_p, m_p, graph.chk_to_var, active, u_p, **kw), reps=1),
                posterior_bound=bound(nbytes(llr0, msg, graph.var_to_sock,
                                             active, p_k, w_k)),
                check_bound=bound(nbytes(p_p, m_k, graph.chk_to_var, active,
                                         m_k, u_k), ops_c,
                                  INT32_OPS_S if dtype == torch.int8
                                  else FP32_OPS_S))
            # kernel C's launch geometry, and its rate on the bytes its
            # bound counts (pm read once): the DRAM bytes are not measured
            vec, tile = soft_bp.soft_check_geometry(
                pm.element_size(), COLS_SOFT, COLS_SOFT // num, graph.dc,
                pm.shape[0], l2_bytes)
            counted = nbytes(p_p, m_k, graph.chk_to_var, active, m_k, u_k)
            times.update(check_vec=vec, check_tile=tile,
                         check_counted_gb=counted / 1e9,
                         check_counted_gb_per_s=counted / 1e6 /
                         times["check_ms"])
            # kernel B's trials a thread, and its rate on the bytes its
            # bound counts
            counted = nbytes(llr0, msg, graph.var_to_sock, active, p_k, w_k)
            dv = graph.var_to_sock.shape[-1]
            times.update(posterior_vec=soft_bp.soft_posterior_vector(
                pm.element_size(), COLS_SOFT // num, dv,
                [(16, t.element_size()) for t in (llr0, msg, p_k)]),
                posterior_counted_gb=counted / 1e9,
                posterior_counted_gb_per_s=counted / 1e6 /
                times["posterior_ms"])
            if label == "regular_one" and kind == "sumproduct_f32":
                # one PyTorch call summing each message into its variable
                owner = graph.chk_to_var.reshape(-1).long()
                acc = llr0.clone()
                times["posterior_library_ms"] = time_ms(
                    lambda: acc.index_add_(0, owner, msg))
                del acc
            pass_ms[f"{label}_{kind}"] = times
            print(f"  B {times['posterior_ms']:.4f} ms (per trial "
                  f"{times['posterior_trial_ms']:.4f}; bound "
                  f"{times['posterior_bound']['bound_ms']:.4f}, "
                  f"{times['posterior_counted_gb_per_s']:.0f} GB/s, V = "
                  f"{times['posterior_vec']}, plain "
                  f"{times['posterior_plain_ms']:.3f}); C "
                  f"{times['check_ms']:.4f} ms (bound "
                  f"{times['check_bound']['bound_ms']:.4f}, plain "
                  f"{times['check_plain_ms']:.3f})", flush=True)
            del msg, pm, p_k, p_p, m_k, m_p
    main_b = pass_ms["regular_768_sumproduct_f32"]
    one_b = pass_ms["regular_one_sumproduct_f32"]
    measured["soft_posterior"].update(
        max_abs_err=err_b, ms=main_b["posterior_ms"],
        plain_ms=main_b["posterior_plain_ms"], **main_b["posterior_bound"],
        library_ms=None, trial_ms=main_b["posterior_trial_ms"],
        vec=main_b["posterior_vec"],
        counted_gb_per_s=main_b["posterior_counted_gb_per_s"],
        fixed_ms=one_b["posterior_ms"],
        fixed_trial_ms=one_b["posterior_trial_ms"],
        fixed_plain_ms=one_b["posterior_plain_ms"],
        fixed_bound_ms=one_b["posterior_bound"]["bound_ms"],
        fixed_library_ms=one_b["posterior_library_ms"])
    # kernels B's and C's every instantiation at 768 codes and (fixed_) at
    # one code; phase 21 adds the launches of the paths that run each
    by_kind, b_by_kind = {}, {}
    for kind in kinds:
        entry = by_kind[kind] = {}
        for pre, label in (("", "regular_768"), ("fixed_", "regular_one")):
            t = pass_ms[f"{label}_{kind}"]
            b_by_kind.setdefault(kind, {}).update({
                f"{pre}ms": t["posterior_ms"],
                f"{pre}trial_ms": t["posterior_trial_ms"],
                f"{pre}bound_ms": t["posterior_bound"]["bound_ms"],
                f"{pre}plain_ms": t["posterior_plain_ms"],
                f"{pre}counted_gb": t["posterior_counted_gb"],
                f"{pre}counted_gb_per_s": t["posterior_counted_gb_per_s"],
                f"{pre}vec": t["posterior_vec"]})
            entry.update({
                f"{pre}ms": t["check_ms"],
                f"{pre}bound_ms": t["check_bound"]["bound_ms"],
                f"{pre}plain_ms": t["check_plain_ms"],
                f"{pre}counted_gb": t["check_counted_gb"],
                f"{pre}counted_gb_per_s": t["check_counted_gb_per_s"],
                f"{pre}vec": t["check_vec"], f"{pre}tile": t["check_tile"]})
    measured["soft_check"].update(
        max_abs_err=err_c, max_abs_err_minsum=err_c_exact,
        ms=main_b["check_ms"], plain_ms=main_b["check_plain_ms"],
        **main_b["check_bound"], library_ms=None,
        fixed_ms=one_b["check_ms"], fixed_plain_ms=one_b["check_plain_ms"],
        fixed_bound_ms=one_b["check_bound"]["bound_ms"],
        by_kind=by_kind)
    measured["soft_posterior"]["by_kind"] = b_by_kind
    print("kernel C by instantiation (ms, bound, plain, GB/s on the bytes "
          f"the bound counts; card {smi}): "
          f"{json.dumps(measured['soft_check']['by_kind'])}", flush=True)
    print("kernel B by instantiation (ms with per-code counts, trial_ms "
          "with per-trial counts, bound, plain, GB/s on the bytes the "
          f"bound counts, V trials a thread; card {smi}): "
          f"{json.dumps(b_by_kind)}", flush=True)
    measured["soft_posterior"]["cases"] = posterior_cases(dev, llr, batch)

    # -- 19 -------------------------------------------------------------------
    phase("19 whole soft decodes against the plain path at n=8192, 24576 "
          "trials, 50 iterations")
    bits_round = N_SOFT * COLS_SOFT
    for label, kind in ([("regular_one", k) for k in kinds]
                        + [("regular_768", "sumproduct_f32"),
                           ("regular_768", "minsum_int8"),
                           ("irregular_768", "sumproduct_f32")]):
        c = cases[label]
        method, dtype = kinds[kind]
        if soft_bp._graph(c).irregular:
            kern, plain = (soft_bp.soft_bp_decode_irregular,
                           soft_bp.soft_bp_decode_irregular_plain)
        else:
            kern, plain = soft_bp.soft_bp_decode, soft_bp.soft_bp_decode_plain
        record = "per_trial" if label == "regular_768" else "total"
        res_k = kern(c, llr, ITERS, method=method, msg_dtype=dtype,
                     record=record)
        res_p = plain(c, llr, ITERS, method=method, msg_dtype=dtype,
                      record=record)
        torch.cuda.synchronize()
        diff = int((res_k.error_totals.long() - res_p.error_totals.long())
                   .abs().max())
        if method == "minsum":
            check(diff == 0 and torch.equal(res_k.posterior, res_p.posterior)
                  and torch.equal(res_k.code_iterations,
                                  res_p.code_iterations)
                  and (record == "total" or torch.equal(res_k.traj,
                                                        res_p.traj)),
                  f"soft decode ({label}, {kind}) differs from the plain "
                  "path")
        else:
            check(diff <= 1e-5 * bits_round,
                  f"sum-product decode ({label}, {kind}): error totals "
                  f"differ by {diff}")
        print(f"decode {label} {kind} ({record}): iterations "
              f"{res_k.iterations} (plain {res_p.iterations}), errors "
              f"{int(res_k.error_totals[0])} -> "
              f"{int(res_k.error_totals[-1])}, max |d error_totals| {diff}",
              flush=True)
        del res_k, res_p

    # -- 20 -------------------------------------------------------------------
    phase("20 run_simulation of the soft paths on cuda against cpu")
    for exact, fields in (
            (True, dict(channel="BSC", decoder="minsum", channel_param=0.05,
                        code_mode="fixed", expurgation=2)),
            (True, dict(channel="BSC", decoder="minsum", channel_param=0.05,
                        soft_msg_dtype="int8", code_mode="ensemble")),
            (False, dict(channel="AWGN", decoder="sumproduct",
                         channel_param=SIGMA_SP, code_mode="fixed")),
            (False, dict(channel="AWGN", decoder="sumproduct",
                         channel_param=SIGMA_SP, code_mode="ensemble",
                         expurgation=1)),
            (False, dict(channel="AWGN", decoder="minsum",
                         soft_msg_dtype="int8", channel_param=sigma_int8,
                         code_mode="ensemble")),
            (False, dict(channel="AWGN", decoder="minsum",
                         soft_msg_dtype="bfloat16", minsum_alpha=0.8,
                         channel_param=0.85, code_mode="fixed")),
            (False, dict(channel="AWGN", decoder="sumproduct",
                         channel_param=SIGMA_SP, lam=LAM_BEC, rho=RHO6,
                         code_mode="ensemble"))):
        # one chunk a configuration: the CPU references set the phase's time
        cfg = SimulationConfig(**{
            "n": 1024, "iterations": ITERS, "batch": 2048,
            "num_tests": 2048, "seed": 7, "codes_per_chunk": 64,
            "max_block_errors": 10**9, **fields})
        code = ensemble.code_for_config(cfg) \
            if cfg.code_mode == "fixed" else None
        r_gpu = mc.run_simulation(cfg, code, device="cuda")
        r_cpu = mc.run_simulation(cfg, code, device="cpu")
        fields_eq = ("num_trials", "block_errors", "bit_errors",
                     "excluded_trials", "bit_errors_sq", "code_bit_errors_sq",
                     "trials_per_code", "error_counts_per_iteration")
        same = all(getattr(r_gpu, f) == getattr(r_cpu, f) for f in fields_eq)
        if exact:
            check(same, f"cuda and cpu differ ({fields})")
            held = "counters equal"
        elif same:
            held = "counters equal"
        else:
            trials = r_gpu.num_trials
            overlap = True
            for a, b in ((r_gpu.block_errors, r_cpu.block_errors),
                         (r_gpu.bit_errors / cfg.n, r_cpu.bit_errors / cfg.n)):
                lo_a, hi_a = wilson(a, trials)
                lo_b, hi_b = wilson(b, trials)
                overlap &= lo_a <= hi_b and lo_b <= hi_a
            check(overlap, f"cuda and cpu disagree beyond their 99% "
                           f"intervals ({fields})")
            held = "counters differ, 99% intervals overlap"
        print(f"{cfg.channel} {cfg.decoder} {cfg.soft_msg_dtype} "
              f"{'irregular' if cfg.irregular else '(3,6)'} {cfg.code_mode} "
              f"expurgation={cfg.expurgation}: {held}; block_errors "
              f"{r_gpu.block_errors} / {r_cpu.block_errors}, bit_errors "
              f"{r_gpu.bit_errors} / {r_cpu.bit_errors}", flush=True)

    # -- 21 -------------------------------------------------------------------
    phase("21 the soft paths through cli.main at n=8192, batch 24576, "
          f"{CODES_SOFT} codes per chunk, 2 chunks each")
    soft_uses = ("soft_posterior", "soft_check")
    paths = {
        "awgn_sp_f32": (dict(channel="AWGN", decoder="sumproduct",
                             channel_param=SIGMA_SP), ("ensemble", "fixed")),
        "awgn_int8": (dict(channel="AWGN", decoder="minsum",
                           soft_msg_dtype="int8", channel_param=sigma_int8),
                      ("ensemble", "fixed")),
        "awgn_sp_irregular": (dict(channel="AWGN", decoder="sumproduct",
                                   channel_param=SIGMA_SP, lam=LAM_BEC,
                                   rho=RHO6), ("ensemble",)),
        "bsc_minsum_bf16": (dict(channel="BSC", decoder="minsum",
                                 soft_msg_dtype="bfloat16",
                                 channel_param=P_SOFT_BSC), ("fixed",))}
    by_path = {name: {} for name in kernels}
    results = {}
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        for path, (fields, modes) in paths.items():
            for mode in modes:
                name = f"{path}_{mode}"
                needed = soft_uses + (
                    ("awgn_llr",) if fields["channel"] == "AWGN"
                    else ("bernoulli_packed",))
                if mode == "ensemble":
                    needed += ("sample_irregular_codes" if "lam" in fields
                               else "sample_regular_codes",)
                for k in kernels.values():
                    k["wrapper"].launches = 0
                t0 = time.perf_counter()
                res = cli_run(tmp, name, code_mode=mode, n=N_SOFT,
                              iterations=ITERS, batch=COLS_SOFT,
                              codes_per_chunk=CODES_SOFT,
                              num_tests=2 * COLS_SOFT, seed=1, **fields)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {k: v["wrapper"].launches
                            for k, v in kernels.items()}
                for k in needed:
                    check(launches[k] > 0,
                          f"kernel {k} was not launched on the {name} path")
                    by_path[k][name] = launches[k]
                rates = res.error_rate_per_iteration
                check(res.num_trials == 2 * COLS_SOFT
                      and len(rates) == ITERS + 1
                      and all(map(math.isfinite, rates)),
                      f"{name}: {res.num_trials} trials, rates malformed")
                if fields["channel"] == "AWGN":
                    q = 0.5 * math.erfc(1 / fields["channel_param"]
                                        / math.sqrt(2))
                    # int8 counts the quantised LLRs: those within 1/8 of
                    # 0 round to 0 and do not count
                    check(abs(rates[0] - q) < 1e-3 if "soft_msg_dtype"
                          not in fields else q - 0.02 < rates[0] <= q,
                          f"{name}: channel error rate {rates[0]} (Q {q})")
                else:
                    check(abs(rates[0] - fields["channel_param"]) < 1e-3,
                          f"{name}: channel error rate {rates[0]}")
                check(0.0 <= res.bit_error_rate <= rates[0]
                      and (res.trials_per_code == 32) == (mode == "ensemble"),
                      f"{name}: rates or cluster size out of range")
                results[name] = res
                print(f"{name}: {res.num_trials} trials in {seconds:.4f} s, "
                      f"FER {res.block_error_rate:.5f} BER "
                      f"{res.bit_error_rate:.4e} (raw {rates[0]:.5f}); "
                      f"launches { {k: launches[k] for k in needed} }",
                      flush=True)
        for mode in ("ensemble", "fixed"):
            ber = results[f"awgn_sp_f32_{mode}"].bit_error_rate
            check(ber < 1e-3, f"AWGN sum-product {mode}: BER {ber} at "
                              f"sigma {SIGMA_SP}")
        ber = results["bsc_minsum_bf16_fixed"].bit_error_rate
        check(ber < 0.1 * P_SOFT_BSC,
              f"BSC bf16 min-sum: BER {ber} at p = {P_SOFT_BSC}")
        ber = results["awgn_sp_irregular_ensemble"].bit_error_rate
        check(ber < 0.1 * q_raw, f"irregular AWGN sum-product: BER {ber}")
        # the waterfalls where density evolution puts them
        brackets = {}
        for name, n, fields, lo, hi, lo_max in (
                ("sumproduct", 1024, dict(decoder="sumproduct"),
                 SIGMA_STAR_SP - 0.08, SIGMA_STAR_SP + 0.10, 2e-3),
                ("int8_minsum", 2048, dict(decoder="minsum",
                                           soft_msg_dtype="int8"),
                 SIGMA_STAR_INT8 - 0.05, SIGMA_STAR_INT8 + 0.05, 2e-3)):
            bers = [cli_run(tmp, f"anchor_{name}_{k}", code_mode="ensemble",
                            channel="AWGN", channel_param=sigma, n=n,
                            iterations=60, batch=8192, codes_per_chunk=256,
                            num_tests=16384, seed=19 + k,
                            **fields).bit_error_rate
                    for k, sigma in enumerate((lo, hi))]
            check(bers[0] < lo_max and bers[1] > (
                0.01 if name == "sumproduct" else 10 * max(bers[0], 1e-5)),
                  f"{name}: BER {bers} at sigma {lo:.4f} / {hi:.4f} does "
                  "not bracket the threshold")
            brackets[name] = {"sigma": [lo, hi], "ber": bers, "n": n}
        norm = {alpha: cli_run(tmp, f"anchor_alpha_{alpha}",
                               code_mode="ensemble", channel="AWGN",
                               decoder="minsum", minsum_alpha=alpha,
                               channel_param=0.85, n=2048, iterations=60,
                               batch=8192, codes_per_chunk=256,
                               num_tests=8192, seed=43).bit_error_rate
                for alpha in (1.0, 0.8)}
        # normalisation moves min-sum's threshold from 0.823 past 0.85 (to
        # 0.874); at n = 2048, 8192 trials the BER ratio measures ~0.2, so
        # the JAX test's factor 0.2 sits on it and this check takes 0.35
        check(norm[1.0] > 5e-3 and norm[0.8] < 0.35 * norm[1.0],
              f"min-sum at sigma 0.85: BER {norm} (alpha 1 / 0.8)")
        brackets["minsum_alpha_at_0.85"] = norm
        print(json.dumps({"soft_threshold_brackets": brackets}), flush=True)
    for k in ("awgn_llr", "soft_posterior", "soft_check"):
        measured[k]["launches"] = by_path[k]["awgn_sp_f32_ensemble"]
    # each instantiation's launches on the paths that run it: at 768 codes
    # (launches) and on one code (fixed_launches)
    for kind, path in (("sumproduct_f32", "awgn_sp_f32"),
                       ("minsum_int8", "awgn_int8"),
                       ("minsum_bf16", "bsc_minsum_bf16")):
        for k in ("soft_posterior", "soft_check"):
            entry = measured[k]["by_kind"][kind]
            for pre, mode in (("", "ensemble"), ("fixed_", "fixed")):
                entry[f"{pre}launches"] = by_path[k].get(f"{path}_{mode}")
    for k in kernels:
        measured[k].setdefault("launches_by_path", {}).update(by_path[k])

    # -- 22 -------------------------------------------------------------------
    phase("22 soft timing at the headline shape")
    k_bits = N_SOFT * (DC - DV) // DC * COLS_SOFT
    llr_t = channels.awgn_llr(sigma_int8, shape, seed=9, device=dev)
    decode_ms, rounds = {}, {}
    for kind in ("sumproduct_f32", "minsum_bf16", "minsum_int8"):
        method, dtype = kinds[kind]
        for label in ("regular_one", "regular_768"):
            c = cases[label]

            def kern():
                return soft_bp.soft_bp_decode(c, llr_t, ITERS, method=method,
                                              msg_dtype=dtype)

            def plain():
                return soft_bp.soft_bp_decode_plain(
                    c, llr_t, ITERS, method=method, msg_dtype=dtype)

            order = (("plain", plain), ("kernel", kern), ("kernel", kern),
                     ("plain", plain)) if label == "regular_one" else \
                (("kernel", kern), ("kernel", kern))
            for name, fn in order:
                decode_ms.setdefault(f"{kind}_{label}_{name}", []).append(
                    time_ms(fn, reps=1, warmup=False) if name == "plain"
                    else time_ms(fn, reps=3))
            rounds[f"{kind}_{label}"] = kern().iterations
    trip = channels.awgn_llr(sigma_int8, (N_SOFT, 2048), seed=9, device=dev)
    for name, fn in (("plain", soft_bp.soft_bp_decode_plain),
                     ("kernel", soft_bp.soft_bp_decode),
                     ("kernel", soft_bp.soft_bp_decode),
                     ("plain", soft_bp.soft_bp_decode_plain)):
        decode_ms.setdefault(f"tripwire_int8_B2048_{name}", []).append(
            time_ms(lambda: fn(fixed, trip, ITERS, method="minsum",
                               msg_dtype=torch.int8),
                    reps=1 if name == "plain" else 3,
                    warmup=name == "kernel"))
    rounds["tripwire_int8_B2048"] = soft_bp.soft_bp_decode(
        fixed, trip, ITERS, method="minsum", msg_dtype=torch.int8).iterations
    decode_ms = {k: sum(v) / len(v) for k, v in decode_ms.items()}
    info_bits_per_s = {
        k: (N_SOFT // 2 * 2048 if k.startswith("tripwire") else k_bits)
        / (v / 1e3) for k, v in decode_ms.items()}
    # the decode's bound: its rounds at the per-round bounds of B and C
    decode_bound = {}
    for kind in ("sumproduct_f32", "minsum_bf16", "minsum_int8"):
        for label in ("regular_one", "regular_768"):
            t = pass_ms[f"{label}_{kind}"]
            ms = rounds[f"{kind}_{label}"] * (
                t["posterior_bound"]["bound_ms"]
                + t["check_bound"]["bound_ms"])
            decode_bound[f"{kind}_{label}"] = {
                "bound_ms": ms, "info_bits_per_s": k_bits / (ms / 1e3)}
    for k, v in decode_ms.items():
        print(f"decode {k}: {v:.3f} ms, {info_bits_per_s[k]:.4e} info bits/s",
              flush=True)

    def config(**fields):
        return SimulationConfig(**{
            "n": N_SOFT, "iterations": ITERS, "batch": COLS_SOFT,
            "codes_per_chunk": CODES_SOFT, "seed": 1, "dv": DV, "dc": DC,
            **fields})

    cfgs = {f"{path}_{mode}": config(code_mode=mode, **fields)
            for path, (fields, modes) in paths.items() for mode in modes}
    chunk_fns = {k: mc.make_chunk_fn(c, ensemble.code_for_config(c)
                                     if c.code_mode == "fixed" else None,
                                     device=dev) for k, c in cfgs.items()}
    chunk_s = {}
    for name in list(cfgs) + list(cfgs)[::-1]:
        chunk_fns[name](9)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in range(2):
            int(chunk_fns[name](idx).block_errors)
        torch.cuda.synchronize()
        chunk_s.setdefault(name, []).append((time.perf_counter() - t0) / 2)
    trials_per_s = {k: COLS_SOFT / (sum(v) / len(v))
                    for k, v in chunk_s.items()}
    print(json.dumps({
        "soft_timing": {
            "decode_ms": decode_ms, "decode_rounds": rounds,
            "decode_info_bits_per_s": info_bits_per_s,
            "decode_bound": decode_bound, "passes_ms": pass_ms,
            "chunk_s": chunk_s, "chunk_trials_per_s": trials_per_s},
        "n": N_SOFT, "trials": COLS_SOFT, "codes_per_chunk": CODES_SOFT,
        "sigma_decode": sigma_int8, "card": smi}), flush=True)
    sp_chunk_ms = sum(chunk_s["awgn_sp_f32_ensemble"]) / \
        len(chunk_s["awgn_sp_f32_ensemble"]) * 1e3
    print(device_time_breakdown(lambda: int(
        chunk_fns["awgn_sp_f32_ensemble"](5).block_errors), sp_chunk_ms,
        kernels), flush=True)
    int8_chunk_ms = sum(chunk_s["awgn_int8_ensemble"]) / \
        len(chunk_s["awgn_int8_ensemble"]) * 1e3
    print("int8 ensemble chunk: " + device_time_breakdown(lambda: int(
        chunk_fns["awgn_int8_ensemble"](5).block_errors), int8_chunk_ms,
        kernels), flush=True)


def random_paths(dev, smi, measured, kernels, scratch_root, code) -> None:
    """Phases 23-27: random-codeword transmit (module docstring).  ``code``
    is the fixed (3,6) code of n = 10^4 on ``dev``.  Kernel E, the two
    value-round kernels and the Gallager variable kernel are held to their
    plain versions exactly, kernel A with a codeword plane to one float32
    ulp (as phase 18) and kernel B exactly."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.kernels import l2_bytes
    from iib_project_ldpc_codes_tpu_torch.models import (encode, ensemble,
                                                         irregular)
    from iib_project_ldpc_codes_tpu_torch.ops import (bitops, channels,
                                                      erasure_bp, gallager,
                                                      soft_bp)
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

    def codewords_ok(c, x) -> bool:
        """Every word of ``x`` satisfies every check of its code."""
        syndrome = torch.zeros((c.chk_to_var.shape[-2], x.shape[1]),
                               dtype=torch.int32, device=x.device)
        for j in range(c.chk_to_var.shape[-1]):
            syndrome ^= erasure_bp._code_major_to_plane(
                erasure_bp._gather_rows(x, c.chk_to_var, j), c.num_codes)
        return not bool(syndrome.any())

    def seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- 23 -------------------------------------------------------------------
    phase("23 kernel E, the value-round kernels and kernel D's value form "
          "against their plain versions; kernels A, B and the Gallager "
          "variable kernel with a codeword plane")
    planes, derive_s = seconds(lambda: encode.code_encoder_planes(code))
    enc, make_encoder_s = seconds(lambda: encode.make_encoder(code))
    check(torch.equal(encode.encoder_planes(enc, dev).mask, planes.mask),
          "make_encoder's planes differ from code_encoder_planes'")
    print(f"encoder of the n={N_FULL} code: rank {planes.rank}, k_eff "
          f"{planes.k}; code_encoder_planes {derive_s:.3f} s, make_encoder "
          f"{make_encoder_s:.3f} s (elimination on {dev})", flush=True)
    ens_codes = ensemble.sample_codes(1, 0, CODES_RT_ENS, N_RT_ENS, DV, DC,
                                      "repair", device=dev)
    ens_planes, ens_derive_s = seconds(
        lambda: encode.code_encoder_planes(ens_codes))
    print(f"encoders of {CODES_RT_ENS} codes of n={N_RT_ENS}: rank_max "
          f"{ens_planes.rank}, k_max {ens_planes.k}; {ens_derive_s:.3f} s",
          flush=True)
    cases = {"one_code": (code, planes), "ensemble": (ens_codes, ens_planes)}
    txs, err_e, value_ms, value_planes, value_tiles = {}, 0, {}, {}, {}
    value_err = {"check": 0, "variable": 0}

    def value_round_against_plain(label, c, known0, val0, align=16, vec=4):
        """Both value-round kernels (K2's and K3's value forms) on (known0,
        val0) placed ``align`` bytes past a 16-byte boundary, against their
        plain versions, and the words a thread they launched (``vec``);
        returns the plain check pass's planes."""
        eo, ad = erasure_bp.check_exactly_one_xor(
            c.chk_to_var, misaligned(known0, align), misaligned(val0, align))
        launched = [(erasure_bp.check_exactly_one_xor.vec,
                     erasure_bp.check_exactly_one_xor.tile)]
        want = erasure_bp._check_exactly_one_xor_plain(c.chk_to_var, known0,
                                                       val0)
        err = max(max_abs_err(eo, want[0]), max_abs_err(ad, want[1]))
        check(err == 0, f"check_exactly_one_xor ({label}) differs from its "
                        f"plain version (max |d| {err})")
        value_err["check"] = max(value_err["check"], err)
        outs = []
        for fn in (erasure_bp.variable_or_adopt,
                   erasure_bp._variable_or_adopt_plain):
            outs.append([misaligned(t, align) for t in (known0, val0)] + [
                torch.zeros(2, dtype=torch.int32, device=dev)])
            fn(c.var_to_chk, *(misaligned(t, align) for t in want),
               *outs[-1], 1)
            if fn is erasure_bp.variable_or_adopt:
                launched.append((erasure_bp.variable_or_adopt.vec,
                                 erasure_bp.variable_or_adopt.tile))
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(*outs))
        check(err == 0, f"variable_or_adopt ({label}) differs from its plain "
                        f"version (max |d| {err})")
        value_err["variable"] = max(value_err["variable"], err)
        tile = erasure_bp.value_round_tile(*known0.shape, l2_bytes(0))
        check(launched == [(vec, tile)] * 2, f"the value round ({label}) "
              f"launched (words a thread, tile) {launched}, expected "
              f"{(vec, tile)}")
        value_tiles[label] = tile
        print(f"value round {label}: both kernels equal to plain, {vec} "
              f"words a thread, column tiles of {tile} words", flush=True)
        return want
    for label, (c, pl) in cases.items():
        info = bitops.info_planes(pl.k, WORDS_FULL, seed=1, offset=0,
                                  device=dev)
        tx = encode.encode_packed(pl, info)
        err = max_abs_err(tx, encode._encode_packed_plain(pl, info))
        check(err == 0, f"kernel E ({label}) differs from its plain version "
                        f"(max |d| {err})")
        check(codewords_ok(c, tx), f"kernel E ({label}): a word is not a "
                                   "codeword")
        check(int(bitops.total_popcount(tx)) > 0, f"{label}: all-zero tx")
        err_e = max(err_e, err)
        txs[label] = (c, pl, info, tx)
        erased = bitops.bernoulli_packed(EPS_FULL, (c.n, WORDS_FULL), seed=7,
                                         offset=3, device=dev)
        known0 = ~erased
        val0 = tx & known0
        eo, ad = value_round_against_plain(label, c, known0, val0)
        value_planes[label] = (c, known0, val0, eo, ad)
        state = {}

        def fresh():
            state["known"], state["val"] = known0.clone(), val0.clone()
            state["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

        def run(fn):
            fn(c.var_to_chk, eo, ad, state["known"], state["val"],
               state["errors"], 1)

        value_ms[label] = dict(
            check_ms=time_ms(lambda: erasure_bp.check_exactly_one_xor(
                c.chk_to_var, known0, val0)),
            check_plain_ms=time_ms(
                lambda: erasure_bp._check_exactly_one_xor_plain(
                    c.chk_to_var, known0, val0), reps=2),
            variable_ms=time_ms(lambda: run(erasure_bp.variable_or_adopt),
                                prepare=fresh),
            variable_plain_ms=time_ms(
                lambda: run(erasure_bp._variable_or_adopt_plain),
                prepare=fresh, reps=2),
            check_bound=bound(nbytes(c.chk_to_var, known0, val0, eo, ad)),
            variable_bound=bound(nbytes(c.var_to_chk, eo, ad, known0, known0,
                                        val0, val0, state["errors"])))
        print(f"{label}: E equal to plain, every word a codeword; value "
              f"round: check "
              f"{value_ms[label]['check_ms']:.4f} ms (plain "
              f"{value_ms[label]['check_plain_ms']:.3f}), variable "
              f"{value_ms[label]['variable_ms']:.4f} ms (plain "
              f"{value_ms[label]['variable_plain_ms']:.3f})", flush=True)
    # the value round at N = 1 (the one-code planes 4 bytes past a 16-byte
    # boundary) and at n = 10^6, W = 48, random value planes two rounds in
    c, known0, val0 = value_planes["one_code"][:3]
    value_round_against_plain("one_code_N1", c, known0, val0, align=4,
                              vec=1)
    big = ensemble.code_for_config(SimulationConfig(
        n=N_EDGE, dv=DV, dc=DC, code_mode="fixed")).to(dev)
    big_erased = bitops.bernoulli_packed(EPS_FULL, (N_EDGE, W_EDGE), seed=38,
                                         device=dev)
    known0 = erasure_bp.bp_decode_packed_allzero(big, big_erased, 2).known
    val0 = bitops.bernoulli_packed(0.5, (N_EDGE, W_EDGE), seed=39,
                                   device=dev) & known0
    value_planes["n1e6"] = (big, known0, val0,
                            *value_round_against_plain("n1e6", big, known0,
                                                       val0))
    del big_erased
    # kernel A with a codeword plane (any plane will do for the comparison)
    shape = (N_SOFT, COLS_SOFT)
    tx_soft = bitops.info_planes(N_SOFT, COLS_SOFT // 32, seed=2,
                                 device=dev)
    llr = channels.awgn_llr(SIGMA_SP, shape, seed=7, offset=3, device=dev,
                            tx=tx_soft)
    llr_p = channels._awgn_llr_plain(SIGMA_SP, shape, channels.awgn_key(7),
                                     3, dev, tx_soft)
    torch.cuda.synchronize()
    ulps = (llr.view(torch.int32).long() - llr_p.view(torch.int32).long()) \
        .abs()
    ulp_max, ulp_share = int(ulps.max()), float((ulps > 0).double().mean())
    check(ulp_max <= 1 and ulp_share < 1e-5,
          f"kernel A with a codeword plane differs from its plain version: "
          f"{ulp_max} ulps at most, in a share {ulp_share}")
    raw = float(((llr < 0) ^ bitops.unpack_bits(tx_soft)).double().mean())
    q_raw = 0.5 * math.erfc(1 / SIGMA_SP / math.sqrt(2))
    check(abs(raw - q_raw) < 5 * (q_raw / llr.numel()) ** 0.5,
          f"kernel A with tx: raw BER against tx {raw}, Q(1/sigma) {q_raw}")
    measured["awgn_llr"].update(
        ulp_max_tx=ulp_max, ulp_share_tx=ulp_share,
        ms_tx=time_ms(lambda: channels.awgn_llr(
            SIGMA_SP, shape, seed=7, offset=3, device=dev, tx=tx_soft)))
    del llr_p, ulps
    print(f"kernel A with tx: {ulp_max} ulp at most, share {ulp_share:.3e}; "
          f"raw BER against tx {raw:.5f} (Q {q_raw:.5f}); "
          f"{measured['awgn_llr']['ms_tx']:.4f} ms", flush=True)
    # kernel B with a codeword plane: one pass and the final pass
    soft_code = ensemble.code_for_config(SimulationConfig(
        n=N_SOFT, dv=DV, dc=DC, code_mode="fixed")).to(dev)
    graph = soft_bp._graph(soft_code)
    active = torch.ones(1, dtype=torch.int32, device=dev)
    err_b = 0
    for dtype in (torch.float32, torch.int8):
        llr0 = soft_bp._quantise(llr, 4.0) if dtype == torch.int8 else llr
        msg = torch.zeros((graph.chk_to_var.shape[0] * graph.dc, COLS_SOFT),
                          dtype=dtype, device=dev)
        pm = torch.empty(llr0.shape, dtype=dtype, device=dev)
        counts = torch.zeros(COLS_SOFT, dtype=torch.int32, device=dev)
        unsat = torch.zeros(1, dtype=torch.int32, device=dev)
        soft_bp._soft_posterior_plain(llr0, msg, graph.var_to_sock, active,
                                      pm, counts, pad_pos=graph.pad_pos)
        soft_bp._soft_check_plain(pm, msg, graph.chk_to_var, active, unsat,
                                  method="minsum", alpha=1.0, beta=0.0,
                                  pad_var=-1)
        outs = []
        for fn in (soft_bp.soft_posterior, soft_bp._soft_posterior_plain):
            p_ = torch.empty_like(pm)
            c_ = torch.zeros_like(counts)
            post = torch.empty(shape, dtype=torch.float32, device=dev)
            hard = torch.empty(shape, dtype=torch.bool, device=dev)
            fn(llr0, msg, graph.var_to_sock, active, p_, c_,
               pad_pos=graph.pad_pos, post=post, hard=hard, tx=tx_soft)
            outs.append((p_, c_, post, hard))
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            err_b = max(err_b, float((a.float() - b.float()).abs().max()))
        check(err_b == 0, f"kernel B with tx ({dtype}) differs from its "
                          f"plain version (max |d| {err_b})")
        check(torch.equal(outs[0][3], (outs[0][2] < 0)
                          ^ bitops.unpack_bits(tx_soft)),
              "kernel B: hard is not decisions ^ tx")
        if dtype == torch.float32:
            p_, c_ = torch.empty_like(pm), torch.zeros_like(counts)
            measured["soft_posterior"]["fixed_ms_tx"] = time_ms(
                lambda: soft_bp.soft_posterior(
                    llr0, msg, graph.var_to_sock, active, p_, c_,
                    pad_pos=graph.pad_pos, tx=tx_soft))
        del msg, pm, outs
    measured["soft_posterior"]["max_abs_err_tx"] = err_b
    print(f"kernel B with tx (float32, int8; one pass and the final pass) "
          f"equal to plain; {measured['soft_posterior']['fixed_ms_tx']:.4f} "
          "ms (f32, one code)", flush=True)
    del llr
    # the Gallager variable kernel with a codeword plane
    flips = bitops.bernoulli_packed(P_GAL, (N_FULL, WORDS_FULL), seed=7,
                                    offset=3, device=dev)
    tx_g = txs["one_code"][3]
    rx = flips ^ tx_g
    ggraph = gallager._graph(code)
    msg0 = gallager._initial_messages(ggraph.chk_to_var, rx)
    parity = gallager.gallager_check(msg0, ggraph.dc)
    active = torch.ones(1, dtype=torch.int32, device=dev)
    gstate = {}

    def gfresh():
        gstate["msg"], gstate["decided"] = msg0.clone(), rx.clone()
        gstate["counts"] = torch.zeros((1, 2), dtype=torch.int32, device=dev)

    def grun(fn):
        fn(gstate["msg"], parity, rx, ggraph.var_to_sock, active,
           gstate["decided"], gstate["counts"], dc=ggraph.dc,
           pad_pos=ggraph.pad_pos, threshold=DV - 1, clamp=False, tx=tx_g)

    gfresh()
    grun(gallager.gallager_variable)
    got = (gstate["msg"], gstate["decided"], gstate["counts"])
    gfresh()
    grun(gallager._gallager_variable_plain)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(
        got, (gstate["msg"], gstate["decided"], gstate["counts"])))
    check(err == 0, f"Gallager variable kernel with tx differs from its "
                    f"plain version (max |d| {err})")
    measured["gallager_variable"].update(
        max_abs_err_tx=err,
        fixed_ms_tx=time_ms(lambda: grun(gallager.gallager_variable),
                            prepare=gfresh))
    print(f"Gallager variable kernel with tx equal to plain; "
          f"{measured['gallager_variable']['fixed_ms_tx']:.4f} ms (one code)",
          flush=True)
    # kernel D's value form against its plain version, on all four outputs:
    # the headline code a block a word with codewords and with random
    # planes (not codewords: checks teach clashing values, both ORed in),
    # the fixed irregular code's phantom view, the ensemble codes a block a
    # word and, one word each, a block a code; two cases on the CPU too
    c1, tx1 = txs["one_code"][0], txs["one_code"][3]
    ec, etx = txs["ensemble"][0], txs["ensemble"][3]
    erased1 = bitops.bernoulli_packed(EPS_FULL, (N_FULL, WORDS_FULL), seed=7,
                                      offset=3, device=dev)
    tx_rand = bitops.bernoulli_packed(0.5, (N_FULL, WORDS_FULL), seed=11,
                                      device=dev)
    e_ens = bitops.bernoulli_packed(EPS_RT_ENS, (N_RT_ENS, WORDS_FULL),
                                    seed=7, offset=3, device=dev)
    irr = erasure_bp._phantom_view(irregular.sample_irregular_codes(
        1, 0, 1, irregular.IrregularEnsembleSpec.from_lam_rho(
            N_FULL, LAM_BEC, RHO6, device=dev), "repair",
        device=dev).select(0))
    one = (c1.chk_to_var[None], c1.var_to_chk[None])
    value_cases = {
        "one_code_codewords": (erased1, tx1, *one, 1),
        "one_code_random": (erased1, tx_rand, *one, 1),
        "irregular_random": (erasure_bp._pad_phantom_row(erased1),
                             erasure_bp._pad_phantom_row(tx_rand),
                             irr.chk_to_var[None], irr.var_to_chk[None], 1),
        "ensemble_block_a_word": (e_ens, etx, ec.chk_to_var, ec.var_to_chk,
                                  1),
        "ensemble_block_a_code": (e_ens[:, ::24].contiguous(),
                                  etx[:, ::24].contiguous(), ec.chk_to_var,
                                  ec.var_to_chk, None)}
    on_cpu = ("one_code_random", "ensemble_block_a_code")
    err_dv = 0
    for label, (er, t, chk, var, wpb) in value_cases.items():
        got = erasure_bp.erasure_decode_values(er, t, chk, var, ITERS, wpb)
        wants = [erasure_bp._erasure_decode_values_plain(er, t, chk, var,
                                                         ITERS, wpb)]
        if label in on_cpu:
            wants.append(erasure_bp.erasure_decode_values(
                er.cpu(), t.cpu(), chk.cpu(), var.cpu(), ITERS, wpb))
        torch.cuda.synchronize()
        for want in wants:
            err = max(max_abs_err(a, b.to(dev)) for a, b in zip(got, want))
            check(err == 0, f"kernel D's value form ({label}) differs from "
                            f"its plain version (max |d| {err})")
            err_dv = max(err_dv, err)
        rounds = got[3]
        print(f"kernel D value form {label}: equal to plain"
              f"{' and the CPU' if label in on_cpu else ''} on known, val, "
              f"round_errors and rounds; blocks {rounds.numel()}, rounds max "
              f"{int(rounds.max())}, mean {float(rounds.float().mean()):.2f}; "
              f"digest {digest(*got)}", flush=True)
    measured["erasure_decode_values"]["max_abs_err"] = err_dv

    # -- 24 -------------------------------------------------------------------
    phase("24 whole value-plane decodes against the plain path")
    value_route = ("erasure_decode_values", "check_exactly_one_xor",
                   "variable_or_adopt")
    for label, (c, pl, info, tx) in txs.items():
        erased = bitops.bernoulli_packed(EPS_FULL, (c.n, WORDS_FULL), seed=7,
                                         offset=3, device=dev)
        res_k, traj_k = erasure_bp.bp_decode_packed_traj(c, erased, tx, ITERS)
        res_p, traj_p = erasure_bp.bp_decode_packed_traj_plain(c, erased, tx,
                                                               ITERS)
        before = {k: kernels[k]["wrapper"].launches for k in value_route}
        one = erasure_bp.bp_decode_packed(c, erased, tx, ITERS)
        torch.cuda.synchronize()
        route = {k: kernels[k]["wrapper"].launches - v
                 for k, v in before.items()}
        # one code: kernel D's value form a block a word; the ensemble's 24
        # words a code do not fit one block: the round kernels' host loop
        want_route = {"erasure_decode_values": 1, "check_exactly_one_xor": 0,
                      "variable_or_adopt": 0} if label == "one_code" else {
            "erasure_decode_values": 0,
            "check_exactly_one_xor": one.iterations,
            "variable_or_adopt": one.iterations}
        check(route == want_route, f"bp_decode_packed ({label}) launched "
                                   f"{route}, expected {want_route}")
        check(torch.equal(one.val, res_p.val)
              and torch.equal(one.known, res_p.known)
              and torch.equal(one.error_totals, res_p.error_totals)
              and one.iterations == res_p.iterations,
              f"bp_decode_packed ({label}) differs from the plain path")
        zero = erasure_bp.bp_decode_packed_allzero(c, erased, ITERS)
        torch.cuda.synchronize()
        check(torch.equal(res_k.val, res_p.val)
              and torch.equal(res_k.known, res_p.known)
              and torch.equal(traj_k, traj_p)
              and torch.equal(res_k.error_totals, res_p.error_totals)
              and res_k.iterations == res_p.iterations,
              f"value decode ({label}) differs from the plain path")
        check(torch.equal(one.val, res_k.val)
              and torch.equal(one.error_totals, res_k.error_totals),
              f"bp_decode_packed ({label}) differs from the _traj decode")
        check(torch.equal(zero.known, res_k.known)
              and torch.equal(zero.error_totals, res_k.error_totals),
              f"value decode ({label}): known differs from the all-zero "
              "decode's")
        check(not bool(((res_k.val ^ tx) & res_k.known).any()),
              f"value decode ({label}): a resolved bit differs from tx")
        print(f"value decode {label} (traj) equal to plain: iterations "
              f"{res_k.iterations}, erasures {int(res_k.error_totals[0])} -> "
              f"{int(res_k.error_totals[-1])}; known and totals equal the "
              "all-zero decode's; every resolved bit is the codeword's; "
              f"bp_decode_packed by {route}, digest "
              f"{digest(one.known, one.val, one.error_totals)}", flush=True)

    # -- 25 -------------------------------------------------------------------
    phase("25 random-transmit run_simulation on cuda against cpu")
    for exact, fields in (
            (True, dict(channel="BEC", decoder="bp", channel_param=EPS_FULL,
                        code_mode="fixed")),
            (True, dict(channel="BEC", decoder="bp", channel_param=EPS_FULL,
                        lam=LAM_BEC, rho=RHO6, code_mode="ensemble")),
            (True, dict(channel="BSC", decoder="gallager",
                        channel_param=P_GAL_IRR, code_mode="ensemble")),
            (True, dict(channel="BSC", decoder="minsum", soft_msg_dtype="int8",
                        channel_param=0.05, code_mode="fixed")),
            (False, dict(channel="AWGN", decoder="sumproduct",
                         channel_param=SIGMA_SP, code_mode="ensemble"))):
        cfg = SimulationConfig(**{
            "n": 1024, "iterations": ITERS, "batch": 2048,
            "num_tests": 2 * 2048, "seed": 7, "codes_per_chunk": 16,
            "max_block_errors": 10**9, "transmit": "random", **fields})
        fixed = ensemble.code_for_config(cfg) \
            if cfg.code_mode == "fixed" else None
        r_gpu = mc.run_simulation(cfg, fixed, device="cuda")
        r_cpu = mc.run_simulation(cfg, fixed, device="cpu")
        fields_eq = ("num_trials", "block_errors", "bit_errors",
                     "bit_errors_sq", "code_bit_errors_sq",
                     "error_counts_per_iteration")
        same = all(getattr(r_gpu, f) == getattr(r_cpu, f) for f in fields_eq)
        if exact or same:
            check(same, f"random transmit: cuda and cpu differ ({fields})")
            held = "counters equal"
        else:
            overlap = True
            for a, b in ((r_gpu.block_errors, r_cpu.block_errors),
                         (r_gpu.bit_errors / cfg.n, r_cpu.bit_errors / cfg.n)):
                lo_a, hi_a = wilson(a, r_gpu.num_trials)
                lo_b, hi_b = wilson(b, r_gpu.num_trials)
                overlap &= lo_a <= hi_b and lo_b <= hi_a
            check(overlap, f"random transmit: cuda and cpu disagree beyond "
                           f"their 99% intervals ({fields})")
            held = "counters differ, 99% intervals overlap"
        print(f"random {cfg.channel} {cfg.decoder} {cfg.soft_msg_dtype} "
              f"{'irregular' if cfg.irregular else '(3,6)'} {cfg.code_mode}: "
              f"{held}; block_errors {r_gpu.block_errors} / "
              f"{r_cpu.block_errors}, bit_errors {r_gpu.bit_errors} / "
              f"{r_cpu.bit_errors}", flush=True)

    # -- 26 -------------------------------------------------------------------
    phase("26 the random-transmit paths through cli.main, each beside its "
          "zero-transmit run")
    rt_uses = ("bernoulli_packed", "encode_packed")
    # the fixed BEC decodes run kernel D's value form, a block a word; the
    # ensemble's (24 words a code at n = 2048) the value-round kernels
    bec_uses = rt_uses + ("erasure_decode_values", "per_trial_counts")
    value_rounds = ("check_exactly_one_xor", "variable_or_adopt")
    soft_uses = rt_uses + ("soft_posterior", "soft_check")
    paths = {
        "bec_36_fixed": (dict(channel_param=EPS_FULL, n=N_FULL), bec_uses),
        "gallager_36_fixed": (dict(channel="BSC", decoder="gallager",
                                   channel_param=P_GAL, n=N_FULL),
                              rt_uses + ("gallager_check",
                                         "gallager_variable",
                                         "per_trial_counts")),
        "bec_irregular_fixed": (dict(channel_param=EPS_FULL, n=N_FULL,
                                     lam=LAM_BEC, rho=RHO6), bec_uses),
        "awgn_sp_f32_fixed": (dict(channel="AWGN", decoder="sumproduct",
                                   channel_param=SIGMA_SP, n=N_SOFT),
                              soft_uses + ("awgn_llr",)),
        "bsc_minsum_bf16_fixed": (dict(channel="BSC", decoder="minsum",
                                       soft_msg_dtype="bfloat16",
                                       channel_param=P_SOFT_BSC, n=N_SOFT),
                                  soft_uses),
        "bec_36_ensemble": (dict(code_mode="ensemble", n=N_RT_ENS,
                                 channel_param=EPS_RT_ENS,
                                 codes_per_chunk=CODES_RT_ENS),
                            rt_uses + value_rounds + (
                                "per_trial_counts", "sample_regular_codes")),
        "awgn_minsum_ensemble": (dict(code_mode="ensemble", n=N_RT_ENS,
                                      channel="AWGN", decoder="minsum",
                                      channel_param=SIGMA_RT_ENS,
                                      codes_per_chunk=CODES_RT_ENS),
                                 soft_uses + ("awgn_llr",
                                              "sample_regular_codes")),
        # kernel G with codewords: 4 words (128 trials) a code, whose
        # messages fit one block (114,704 bytes at n = 2048)
        "gallager_36_ensemble": (dict(code_mode="ensemble", n=N_RT_ENS,
                                      channel="BSC", decoder="gallager",
                                      channel_param=P_GAL,
                                      codes_per_chunk=CODES_RT_ENS,
                                      batch=CODES_RT_ENS * 32 * 4),
                                 rt_uses + ("gallager_decode",
                                            "per_trial_counts",
                                            "sample_regular_codes"))}
    by_path = {name: {} for name in kernels}
    anchors = {}
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        for name, (fields, needed) in paths.items():
            common = {"iterations": ITERS, "batch": 32 * WORDS_FULL,
                      "seed": 1, **fields}
            common["num_tests"] = 2 * common["batch"]
            for k in kernels.values():
                k["wrapper"].launches = 0
            t0 = time.perf_counter()
            res = cli_run(tmp, name, transmit="random", **common)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {k: v["wrapper"].launches for k, v in kernels.items()}
            for k in needed:
                check(launches[k] > 0,
                      f"kernel {k} was not launched on the random {name} "
                      "path")
                by_path[k][f"random_{name}"] = launches[k]
            if "gallager_decode" in needed:
                check(launches["gallager_variable"] == 0,
                      f"the round kernels ran on the random {name} path")
            if "erasure_decode_values" in needed:
                check(launches["erasure_decode_values"] == 2
                      and not any(launches[k] for k in value_rounds),
                      f"the random {name} path launched "
                      f"{ {k: launches[k] for k in needed + value_rounds} }, "
                      "expected kernel D's value form once a chunk and no "
                      "value-round kernel")
            zero = cli_run(tmp, f"{name}_zero", transmit="zero", **common)
            rates = res.error_rate_per_iteration
            check(res.num_trials == common["num_tests"]
                  and len(rates) == ITERS + 1
                  and all(map(math.isfinite, rates))
                  and res.config.transmit == "random",
                  f"random {name}: {res.num_trials} trials, rates malformed")
            check(0.0 <= res.bit_error_rate <= 1.0
                  and 0.0 <= res.block_error_rate <= 1.0,
                  f"random {name}: rates out of range")
            counters = ("block_errors", "bit_errors", "bit_errors_sq",
                        "code_bit_errors_sq", "error_counts_per_iteration")
            if fields.get("channel", "BEC") == "AWGN":
                overlap = True
                for a, b in ((res.block_errors, zero.block_errors),
                             (res.bit_errors / fields["n"],
                              zero.bit_errors / fields["n"])):
                    lo_a, hi_a = wilson(a, res.num_trials)
                    lo_b, hi_b = wilson(b, res.num_trials)
                    overlap &= lo_a <= hi_b and lo_b <= hi_a
                check(overlap, f"random {name}: BER/FER outside the zero "
                               "run's 99% interval")
                anchor = "within the zero run's 99% intervals"
            elif fields.get("decoder") == "minsum":
                # posterior-0 ties decide 0: wrong only where tx is 1
                check(res.block_errors == zero.block_errors
                      and res.bit_errors >= zero.bit_errors,
                      f"random {name}: block errors {res.block_errors} / "
                      f"{zero.block_errors}, bit errors {res.bit_errors} / "
                      f"{zero.bit_errors}")
                anchor = ("block errors equal the zero run's, bit errors "
                          f"{res.bit_errors} >= {zero.bit_errors}")
            else:
                for f in counters:
                    check(getattr(res, f) == getattr(zero, f),
                          f"random {name}: {f} differs from the zero run's")
                anchor = "counters equal the zero run's"
            anchors[name] = {"random": [res.block_errors, res.bit_errors],
                             "zero": [zero.block_errors, zero.bit_errors],
                             "held": anchor, "run_s": run_s}
            print(f"random {name}: {res.num_trials} trials in {run_s:.4f} s "
                  f"(encoder derivation included), FER "
                  f"{res.block_error_rate:.5f} BER {res.bit_error_rate:.4e}; "
                  f"{anchor}; launches "
                  f"{ {k: launches[k] for k in needed} }", flush=True)
    print(json.dumps({"random_anchors": anchors}), flush=True)
    for k in ("encode_packed", "erasure_decode_values"):
        measured[k]["launches"] = by_path[k]["random_bec_36_fixed"]
    for k in value_rounds:
        measured[k]["launches"] = by_path[k]["random_bec_36_ensemble"]
    for k in kernels:
        measured[k].setdefault("launches_by_path", {}).update(by_path[k])

    # -- 27 -------------------------------------------------------------------
    phase("27 random-transmit timing")
    c, pl, info, tx = txs["one_code"]
    e_ms = time_ms(lambda: encode.encode_packed(pl, info))
    e_plain_ms = time_ms(lambda: encode._encode_packed_plain(pl, info),
                         reps=1)
    ec, epl, einfo, etx = txs["ensemble"]
    e_ens_ms = time_ms(lambda: encode.encode_packed(epl, einfo))
    # the library yardstick: one matmul of the unpacked 0/1 map and bits,
    # mod 2 (integer sums below 2^24 are exact in a float32 accumulator)
    mask01 = bitops.unpack_bits(pl.mask)[:, :pl.k].to(torch.bfloat16)
    info01 = bitops.unpack_bits(info).to(torch.bfloat16)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        def library():
            return torch.mm(mask01, info01, out_dtype=torch.float32)
        library_call = "torch.mm(bf16, bf16, out_dtype=float32)"
        sums = library()
    except (TypeError, RuntimeError):
        # this torch's mm has no bf16 -> float32 output: float32 inputs,
        # full float32 products (exact on 0/1 entries)
        mask32, info32 = mask01.float(), info01.float()
        torch.backends.cuda.matmul.allow_tf32 = False

        def library():
            return torch.mm(mask32, info32)
        library_call = "torch.mm(float32, float32), TF32 off"
        sums = library()
    parity_rows = bitops.unpack_bits(tx.index_select(0, pl.pivots.long()))
    check(torch.equal((sums.to(torch.int64) % 2).bool(), parity_rows),
          f"the library yardstick ({library_call}) differs from kernel E")
    library_ms = time_ms(library)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del mask01, info01, sums
    # the least work for the function on this map, the least over designs:
    # one word XOR per set map bit and word (a walk of the set bits); the
    # method of Four Russians, whose table of the 2^g XOR combinations of g
    # information rows turns a row's g bits into one lookup (rank *
    # ceil(k/g) lookups and ceil(k/g) * 2^g table entries a word, at its
    # best g); the product of the unpacked bits on the tensor cores, bf16
    # or int8 (2 operations a multiply-add)
    e_bytes = nbytes(info, pl.mask, pl.free, pl.pivots, tx)
    e_designs = {
        "set-bit XOR, INT32": bound(
            e_bytes, int(bitops.total_popcount(pl.mask)) * WORDS_FULL,
            INT32_OPS_S),
        "Four Russians, INT32": bound(e_bytes, min(
            (pl.rank + 2 ** g) * -(-pl.k // g) * WORDS_FULL
            for g in range(1, 17)), INT32_OPS_S),
        "bf16 tensor cores": bound(
            e_bytes, 2.0 * pl.rank * pl.k * 32 * WORDS_FULL,
            BF16_TENSOR_OPS_S),
        "int8 tensor cores": bound(
            e_bytes, 2.0 * pl.rank * pl.k * 32 * WORDS_FULL,
            INT8_TENSOR_OPS_S)}
    e_design = min(e_designs, key=lambda d: e_designs[d]["bound_ms"])
    measured["encode_packed"].update(
        max_abs_err=err_e, ms=e_ms, plain_ms=e_plain_ms,
        library_ms=library_ms, library_call=library_call,
        ensemble_ms=e_ens_ms, bound_design=e_design, **e_designs[e_design])
    print("kernel E's bound by design, ms: " + json.dumps(
        {d: b["bound_ms"] for d, b in e_designs.items()}) +
          f"; the least: {e_design}", flush=True)
    print(f"kernel E at rank {pl.rank}, k_eff {pl.k}, W {WORDS_FULL}: "
          f"{e_ms:.4f} ms (bound {measured['encode_packed']['bound_ms']:.4f} "
          f"ms, {measured['encode_packed']['bound_by']}, {e_design}; plain "
          f"{e_plain_ms:.2f} ms; {library_call} mod 2: {library_ms:.4f} ms); "
          f"{CODES_RT_ENS} codes of n={N_RT_ENS}: {e_ens_ms:.4f} ms",
          flush=True)
    # whole decodes of one code (table rows 5, 6 and 7): the value-plane
    # decode by its route (kernel D's value form, a block a word) beside
    # the host loop over the value-round kernels it replaced, in turns; its
    # _traj form (K4 a round) and the all-zero decode
    erased = bitops.bernoulli_packed(EPS_FULL, (N_FULL, WORDS_FULL), seed=7,
                                     offset=3, device=dev)

    def value_rounds_decode():
        return erasure_bp._decode_values(c, erased, tx, ITERS,
                                         erasure_bp._VALUE_KERNELS, False)[0]

    decode_ms = {}
    for name, fn in (
            ("allzero", lambda: erasure_bp.bp_decode_packed_allzero(
                c, erased, ITERS)),
            ("value", lambda: erasure_bp.bp_decode_packed(c, erased, tx,
                                                          ITERS)),
            ("value_rounds", value_rounds_decode),
            ("value_rounds", value_rounds_decode),
            ("value", lambda: erasure_bp.bp_decode_packed(c, erased, tx,
                                                          ITERS)),
            ("traj", lambda: erasure_bp.bp_decode_packed_traj(
                c, erased, tx, ITERS)),
            ("traj_plain", lambda: erasure_bp.bp_decode_packed_traj_plain(
                c, erased, tx, ITERS))):
        decode_ms.setdefault(name, []).append(time_ms(
            fn, reps=1 if name.endswith("plain") else 3))
    print(f"decodes of one code, 50 rounds, ms: {json.dumps(decode_ms)}",
          flush=True)
    # kernel D's value form alone at the headline (row 7): its time beside
    # the plain version and its bound for the rounds this run's blocks ran
    # (bytes: the table, the erased and tx planes, known and val, the
    # counts; shared memory: value_decode_smem_accesses)
    one = (c.chk_to_var[None], c.var_to_chk[None])

    def value_form():
        return erasure_bp.erasure_decode_values(erased, tx, *one, ITERS, 1)

    vk, vv, vre, vro = value_form()
    accesses = value_decode_smem_accesses(c, erased, tx, vro)
    resources = erasure_decode_resources()
    measured["erasure_decode_values"].update(
        ms=time_ms(value_form),
        device_ms=device_ms(value_form, "erasure_decode_values_kernel",
                            reps=3),
        plain_ms=time_ms(lambda: erasure_bp._erasure_decode_values_plain(
            erased, tx, *one, ITERS, 1), reps=1, warmup=False),
        library_ms=None, rounds_max=int(vro.max()),
        rounds_mean=float(vro.float().mean()), smem_accesses=accesses,
        resources={k: v for k, v in resources.items()
                   if k.startswith("values")},
        **bound(nbytes(c.chk_to_var, erased, tx, vk, vv, vre, vro), accesses,
                SMEM_ACCESS_S))
    measured["erasure_decode"]["resources"] = {
        k: v for k, v in resources.items() if k.startswith("allzero")}
    row = measured["erasure_decode_values"]
    print(f"kernel D's value form at n = {N_FULL}, W = {WORDS_FULL}, a block "
          f"a word: {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms "
          f"(rounds max {row['rounds_max']}, mean {row['rounds_mean']:.2f}); "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {accesses} "
          f"shared-memory accesses); plain {row['plain_ms']:.1f} ms; "
          f"resources {json.dumps(resources)}", flush=True)
    decode_ms = {k: sum(v) / len(v) for k, v in decode_ms.items()}
    # the value round's kernels (row 5) by device time at S1 (the ensemble
    # random chunk's rounds), S2 (one code at n = 10^4) and S3 (n = 10^6,
    # two rounds in) beside their bounds, and their registers
    value_device = {}
    for label, shape in (("ensemble", "s1"), ("one_code", "s2"),
                         ("n1e6", "s3")):
        vc, known0, val0, eo, ad = value_planes[label]
        state = {}

        def fresh():
            state["known"], state["val"] = known0.clone(), val0.clone()
            state["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

        def variable():
            erasure_bp.variable_or_adopt(vc.var_to_chk, eo, ad,
                                         state["known"], state["val"],
                                         state["errors"], 1)

        value_device[shape] = {
            "tile": value_tiles[label],
            "check": dict(device_ms=device_ms(
                lambda: erasure_bp.check_exactly_one_xor(
                    vc.chk_to_var, known0, val0),
                "check_exactly_one_xor_kernel"),
                **bound(nbytes(vc.chk_to_var, known0, val0, eo, ad))),
            "variable": dict(device_ms=device_ms(
                variable, "variable_or_adopt_kernel", prepare=fresh),
                **bound(nbytes(vc.var_to_chk, eo, ad, known0, known0, val0,
                               val0) + 4))}
    del value_planes
    lost = [f"{shape} {key}" for shape, v in value_device.items()
            for key in ("check", "variable")
            if not math.isfinite(v[key]["device_ms"])]
    check(not lost, f"the value round's device time was not measured at "
                    f"{lost}: the profiler recorded none of its launches")
    value_resources = round_kernel_resources(
        _res_usage(), (("check_exactly_one_xor", "dc"),
                       ("variable_or_adopt", "dv")))
    print(f"the value round by device time at S1 (ensemble, n = {N_RT_ENS}, "
          f"{CODES_RT_ENS} codes of {WORDS_FULL // CODES_RT_ENS} words), S2 "
          f"(n = {N_FULL}, W = {WORDS_FULL}), S3 (n = {N_EDGE}, W = "
          f"{W_EDGE}, two rounds in): {json.dumps(value_device)}; registers "
          f"{json.dumps(value_resources)}; card {smi}", flush=True)
    for name, key in (("check_exactly_one_xor", "check"),
                      ("variable_or_adopt", "variable")):
        t = value_ms["one_code"]
        measured[name].update(
            max_abs_err=value_err[key],
            ms=t[f"{key}_ms"], plain_ms=t[f"{key}_plain_ms"],
            library_ms=None, **t[f"{key}_bound"],
            ensemble_ms=value_ms["ensemble"][f"{key}_ms"],
            ensemble_plain_ms=value_ms["ensemble"][f"{key}_plain_ms"],
            device_ms={k: v[key]["device_ms"]
                       for k, v in value_device.items()},
            tiles={k: v["tile"] for k, v in value_device.items()},
            bound_ms_by_shape={k: v[key]["bound_ms"]
                               for k, v in value_device.items()},
            resources=value_resources[name])

    def config(**fields):
        return SimulationConfig(**{
            "iterations": ITERS, "batch": 32 * WORDS_FULL, "seed": 1,
            "dv": DV, "dc": DC, "code_mode": "fixed", **fields})

    cfgs = {}
    for transmit in ("zero", "random"):
        cfgs[f"bec_36_fixed_{transmit}"] = config(
            n=N_FULL, channel_param=EPS_FULL, transmit=transmit)
        cfgs[f"awgn_sp_f32_fixed_{transmit}"] = config(
            n=N_SOFT, channel="AWGN", decoder="sumproduct",
            channel_param=SIGMA_SP, transmit=transmit)
        cfgs[f"bec_36_ensemble_{transmit}"] = config(
            n=N_RT_ENS, channel_param=EPS_RT_ENS, code_mode="ensemble",
            codes_per_chunk=CODES_RT_ENS, transmit=transmit)
        cfgs[f"gallager_36_ensemble_{transmit}"] = config(
            n=N_RT_ENS, channel="BSC", decoder="gallager",
            channel_param=P_GAL, code_mode="ensemble",
            codes_per_chunk=CODES_RT_ENS, batch=CODES_RT_ENS * 32 * 4,
            transmit=transmit)
    chunk_fns, setup_s = {}, {}
    for k, cfg in cfgs.items():
        fixed = ensemble.code_for_config(cfg) \
            if cfg.code_mode == "fixed" else None
        chunk_fns[k], setup_s[k] = seconds(
            lambda: mc.make_chunk_fn(cfg, fixed, device=dev))
    chunk_s = {}
    for pair in ("bec_36_fixed", "awgn_sp_f32_fixed", "bec_36_ensemble",
                 "gallager_36_ensemble"):
        for name in (f"{pair}_zero", f"{pair}_random", f"{pair}_random",
                     f"{pair}_zero"):
            chunk_fns[name](9)                   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for idx in range(2):
                int(chunk_fns[name](idx).block_errors)
            torch.cuda.synchronize()
            chunk_s.setdefault(name, []).append((time.perf_counter() - t0) / 2)
    trials_per_s = {k: cfgs[k].batch / (sum(v) / len(v))
                    for k, v in chunk_s.items()}
    # an ensemble chunk's encoders: the batched elimination of its codes
    ens_encoder_s = []
    for idx in range(2):
        codes = ensemble.sample_codes(1, idx, CODES_RT_ENS, N_RT_ENS, DV, DC,
                                      "repair", device=dev)
        ens_encoder_s.append(seconds(
            lambda: encode.code_encoder_planes(codes))[1])
    ens_chunk = sum(chunk_s["bec_36_ensemble_random"]) / 2
    print(json.dumps({
        "random_timing": {
            "chunk_s": chunk_s, "chunk_trials_per_s": trials_per_s,
            "make_chunk_fn_s": setup_s,
            "encoder_s_n1e4": {"code_encoder_planes": derive_s,
                               "make_encoder": make_encoder_s},
            "encoder_s_per_ensemble_chunk": ens_encoder_s,
            "ensemble_chunk_s_without_encoders":
                ens_chunk - sum(ens_encoder_s) / len(ens_encoder_s),
            "value_round_ms": value_ms, "decode_ms": decode_ms},
        "n": N_FULL, "n_soft": N_SOFT, "n_ensemble": N_RT_ENS,
        "words": WORDS_FULL, "codes_per_ensemble_chunk": CODES_RT_ENS,
        "card": smi}), flush=True)
    print(f"encoders of an ensemble chunk ({CODES_RT_ENS} codes, "
          f"n={N_RT_ENS}): {ens_encoder_s[0]:.3f} / {ens_encoder_s[1]:.3f} s "
          f"of a {ens_chunk:.3f} s chunk", flush=True)
    rt_chunk_ms = sum(chunk_s["bec_36_fixed_random"]) / 2 * 1e3
    print(device_time_breakdown(lambda: int(
        chunk_fns["bec_36_fixed_random"](5).block_errors), rt_chunk_ms,
        kernels), flush=True)


def qc_paths(dev, smi, measured, kernels, fer_fixed_36) -> None:
    """Phases 28-32: quasi-cyclic codes (module docstring).  The four
    circulant-index kernels are held to their plain versions exactly (bitwise
    arithmetic), whole decodes to the plain path and to the generic kernels
    on ``expand()``.  ``fer_fixed_36`` is phase 6's FER of the fixed (3,6)
    code of n = 10^4 at eps = 0.42."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.models import qc
    from iib_project_ldpc_codes_tpu_torch.models.code import validate_code
    from iib_project_ldpc_codes_tpu_torch.models.irregular import (
        validate_irregular_code)
    from iib_project_ldpc_codes_tpu_torch.ops import (bitops, erasure_bp,
                                                      gallager, qc_bp,
                                                      qc_gallager)
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

    names = ("qc_check_exactly_one", "qc_variable_or", "qc_gallager_check",
             "qc_gallager_variable")

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    reg = {"n1e4": qc.sample_qc_code(gen(1), QC_NB, DV, DC, QC_Z, device=dev),
           "n1e5": qc.sample_qc_code(gen(2), QC_NB, DV, DC, QC_Z5,
                                     device=dev),
           "n1e6": qc.sample_qc_code(gen(3), QC_NB, DV, DC, QC_Z6,
                                     device=dev)}
    words_of = {"n1e4": WORDS_FULL, "n1e5": QC_W5, "n1e6": QC_W6}
    irr_bec = qc.sample_qc_code_irregular(gen(4), QC_NB_IRR, LAM_BEC, RHO6,
                                          QC_Z_IRR, device=dev)
    irr_gal = qc.sample_qc_code_irregular(gen(5), QC_NB_IRR, LAM_GAL, RHO6,
                                          QC_Z_IRR, device=dev)

    def same(got, want, what):
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        check(err == 0, f"{what} differs from its plain version "
                        f"(max |d| {err})")
        return err

    # -- 28 -------------------------------------------------------------------
    phase("28 the circulant-index kernels Q1-Q4 against their plain "
          "versions; expand() tables")
    expanded = {}
    for label, c in reg.items():
        expanded[label] = c.expand()
        ok, verdict = validate_code(expanded[label])
        check(ok and expanded[label].n == c.n, f"expand() {label}: {verdict}")
    for label, c in (("irregular BEC", irr_bec), ("irregular BSC", irr_gal)):
        expanded[label] = c.expand()
        ok, verdict = validate_irregular_code(expanded[label])
        check(ok and expanded[label].n == c.n, f"expand() {label}: {verdict}")
    print(f"expand() valid: n = {[c.n for c in reg.values()]}, irregular nb="
          f"{QC_NB_IRR} n={irr_bec.n} (dv_max "
          f"{expanded['irregular BEC'].dv_max}, "
          f"{expanded['irregular BSC'].dv_max})", flush=True)
    err = dict.fromkeys(names, 0)
    single = {}
    cases = [("n1e4", reg["n1e4"], WORDS_FULL, EPS_FULL, P_GAL, True),
             ("n1e6", reg["n1e6"], QC_W6, EPS_FULL, P_GAL, True),
             ("irregular BEC", irr_bec, WORDS_FULL, EPS_FULL, P_GAL, False),
             ("irregular BSC", irr_gal, WORDS_FULL, EPS_FULL, P_GAL_IRR,
              False)]
    # Q1's and Q2's launches by case on the decodes' planes: (words a
    # thread, words of a column tile) from ops/qc_bp.py qc_bec_layout: 16
    # bytes a thread; tiles of 16 bytes a row where `known` is larger than
    # the L2 (n = 1,000,008: 192 MB), else row-major (30.7 MB)
    q12_launched, q12_want = {}, {
        "n1e4": (4, WORDS_FULL), "n1e6": (4, qc_bp.QC_TILE_WORDS),
        "irregular BEC": (4, WORDS_FULL), "irregular BSC": (4, WORDS_FULL)}
    # Q4's launches by case: (words a thread, its degree passes) from
    # ops/qc_gallager.py qc_variable_layout (the BEC pair's blocks have
    # degree 2 and 4, the Gallager pair's 3 and 4)
    q4_launched, q4_want = {}, {
        "n1e4": (4, ("dv3",)), "n1e6": (4, ("dv3",)),
        "irregular BEC": (4, ("dv4", "generic")),
        "irregular BSC": (4, ("dv3", "dv4"))}
    for label, c, words, eps, p, timed in cases:
        adj = qc_bp._adjacency(c, dev)
        clamp = isinstance(c, qc.IrregularQCLDPCCode)
        erased = bitops.bernoulli_packed(eps, (c.n, words), seed=7, offset=3,
                                         device=dev)
        tx = bitops.info_planes(c.n, words, seed=2, device=dev)
        known0 = ~erased
        val0 = tx & known0
        # Q1 / Q2 on the planes in the decodes' column tiles (as the decodes
        # launch them, held after from_tiles) and row-major
        tile = qc_bp._decode_tile(erased)
        known_t = qc_bp.to_tiles(known0, tile)
        val_t = qc_bp.to_tiles(val0, tile)
        ex_r = qc_bp.qc_check_exactly_one(adj, known0)
        ex_v, adopt_r = qc_bp.qc_check_exactly_one(adj, known0, val0)
        ex = qc_bp.qc_check_exactly_one(adj, known_t, tile=tile)
        q12_launched[label] = {(qc_bp.qc_check_exactly_one.vec,
                                qc_bp.qc_check_exactly_one.tile)}
        ex_tv, adopt = qc_bp.qc_check_exactly_one(adj, known_t, val_t,
                                                  tile=tile)
        ex_p, adopt_p = qc_bp._qc_check_exactly_one_plain(adj, known0, val0)
        err[names[0]] = max(err[names[0]], same(
            (ex_r, ex_v, adopt_r) + tuple(qc_bp.from_tiles(t, tile)
                                          for t in (ex, ex_tv, adopt)),
            (ex_p, ex_p, adopt_p) * 2, f"Q1 ({label})"))
        del ex_r, ex_v, adopt_r, ex_tv
        state = {}

        def fresh(layout=tile):
            state["known"] = qc_bp.to_tiles(known0.clone(), layout)
            state["val"] = qc_bp.to_tiles(val0.clone(), layout)
            state["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

        # Q1's planes in each layout, made outside the timing
        q1_out = {layout: (qc_bp.to_tiles(ex_p, layout),
                           qc_bp.to_tiles(adopt_p, layout))
                  for layout in (tile, words, None)}

        def q2(fn, values, layout=tile):
            ex_l, adopt_l = q1_out[layout]
            fn(adj, ex_l, state["known"], state["errors"], 1,
               **(dict(adopt=adopt_l, val=state["val"]) if values else {}),
               **({} if layout is None else dict(tile=layout)))

        for values in (False, True):
            got = []
            for layout in (tile, words):
                fresh(layout)
                q2(qc_bp.qc_variable_or, values, layout)
                if layout == tile:
                    q12_launched[label].add((qc_bp.qc_variable_or.vec,
                                             qc_bp.qc_variable_or.tile))
                got.append((qc_bp.from_tiles(state["known"], layout),
                            qc_bp.from_tiles(state["val"], layout),
                            state["errors"]))
            fresh(None)
            q2(qc_bp._qc_variable_or_plain, values, None)
            want = (state["known"], state["val"], state["errors"])
            err[names[1]] = max(err[names[1]], same(
                got[0] + got[1], want * 2,
                f"Q2 ({label}, values={values})"))
        # Gallager: the first messages, then the second round (the first
        # round's messages are the channel words; the second moves)
        flips = bitops.bernoulli_packed(p, (c.n, words), seed=7, offset=3,
                                        device=dev)
        dvb = adj.var_chk.shape[1]
        gstate = {}
        out = {}
        for with_tx in (False, True):
            rx = flips ^ tx if with_tx else flips
            for key, check_fn, var_fn in (
                    ("kernel", qc_gallager.qc_gallager_check,
                     qc_gallager.qc_gallager_variable),
                    ("plain", qc_gallager._qc_gallager_check_plain,
                     qc_gallager._qc_gallager_variable_plain)):
                msg = torch.full((adj.num_rows * adj.Z, words), -7,
                                 dtype=torch.int32, device=dev)
                var_fn(adj, msg, None, rx, None, None, init=True)
                first = msg.clone()
                decided = rx.clone()
                counts = torch.zeros((1, 2), dtype=torch.int32, device=dev)
                for t in (dvb if clamp else dvb - 1, 1):   # Gallager-A, then B
                    parity = check_fn(adj, msg)
                    before = msg.clone() if t == 1 else None
                    var_fn(adj, msg, parity, rx, decided, counts, threshold=t,
                           clamp=clamp, tx=tx if with_tx else None)
                    if key == "kernel":
                        q4_launched.setdefault(label, set()).add((
                            var_fn.vec, var_fn.paths))
                out[key] = (first, parity, msg, decided, counts)
                if key == "kernel" and not with_tx:
                    gstate.update(rx=rx, before=before, parity=parity)
            err[names[2]] = max(err[names[2]], same(
                out["kernel"][1:2], out["plain"][1:2],
                f"Q3 ({label}, tx={with_tx})"))
            err[names[3]] = max(err[names[3]], same(
                out["kernel"][:1] + out["kernel"][2:],
                out["plain"][:1] + out["plain"][2:],
                f"Q4 ({label}, tx={with_tx})"))
            check(int(out["kernel"][4][0, 1]) > 0,
                  f"Q4 ({label}): no message word changed in two rounds")
        check(q4_launched[label] == {q4_want[label]},
              f"Q4 ({label}) launched {q4_launched[label]}, expected "
              f"{q4_want[label]} (words a thread, degree passes)")
        check(q12_launched[label] == {q12_want[label]},
              f"Q1/Q2 ({label}) launched {q12_launched[label]}, expected "
              f"{q12_want[label]} (words a thread, words of a column tile)")
        print(f"Q1-Q4 equal to plain on {label}: n={c.n}, Z={c.Z}, W={words}, "
              f"E_b={adj.num_rows}, dvb {dvb}; Q1/Q2 launched "
              f"{q12_launched[label]} (words a thread, tile words), Q4 "
              f"{q4_launched[label]} (words a thread, degree passes)",
              flush=True)
        if not timed:
            continue
        # single launches at this shape, each beside its plain version and
        # its bound (every input read once, every output written once)
        def gfresh():
            gstate["msg"] = gstate["before"].clone()
            gstate["decided"] = gstate["rx"].clone()
            gstate["counts"] = torch.zeros((1, 2), dtype=torch.int32,
                                           device=dev)

        def q4(fn, tx_plane=None):
            fn(adj, gstate["msg"], gstate["parity"], gstate["rx"],
               gstate["decided"], gstate["counts"], threshold=1, clamp=clamp,
               tx=tx_plane)

        def q4_init(fn):
            fn(adj, gstate["msg"], None, gstate["rx"], None, None, init=True)

        reps_plain = 2
        tables = (adj.base_chk, adj.shifts)
        var_tables = (adj.var_chk, adj.var_shift)
        gfresh()
        single[label] = {
            names[0]: dict(
                ms=time_ms(lambda: qc_bp.qc_check_exactly_one(
                    adj, known_t, tile=tile)),
                # the kernel alone (events add the wrapper's host work)
                device_ms=device_ms(lambda: qc_bp.qc_check_exactly_one(
                    adj, known_t, tile=tile), "qc_check_exactly_one"),
                plain_ms=time_ms(lambda: qc_bp._qc_check_exactly_one_plain(
                    adj, known0), reps=reps_plain),
                values_ms=time_ms(lambda: qc_bp.qc_check_exactly_one(
                    adj, known_t, val_t, tile=tile)),
                values_device_ms=device_ms(lambda: qc_bp.qc_check_exactly_one(
                    adj, known_t, val_t, tile=tile), "qc_check_exactly_one"),
                **bound(nbytes(known0, ex, *tables))),
            names[1]: dict(
                ms=time_ms(lambda: q2(qc_bp.qc_variable_or, False),
                           prepare=fresh),
                device_ms=device_ms(lambda: q2(qc_bp.qc_variable_or, False),
                                    "qc_variable_or", prepare=fresh),
                plain_ms=time_ms(lambda: q2(qc_bp._qc_variable_or_plain,
                                            False, None),
                                 prepare=lambda: fresh(None),
                                 reps=reps_plain),
                values_ms=time_ms(lambda: q2(qc_bp.qc_variable_or, True),
                                  prepare=fresh),
                values_device_ms=device_ms(
                    lambda: q2(qc_bp.qc_variable_or, True), "qc_variable_or",
                    prepare=fresh),
                **bound(nbytes(ex, known0, known0, state["errors"],
                               *var_tables))),
            names[2]: dict(
                ms=time_ms(lambda: qc_gallager.qc_gallager_check(
                    adj, gstate["before"])),
                device_ms=device_ms(lambda: qc_gallager.qc_gallager_check(
                    adj, gstate["before"]), "qc_gallager_check"),
                plain_ms=time_ms(
                    lambda: qc_gallager._qc_gallager_check_plain(
                        adj, gstate["before"]), reps=reps_plain),
                **bound(nbytes(gstate["before"], gstate["parity"],
                               adj.row_offs))),
            names[3]: dict(
                ms=time_ms(lambda: q4(qc_gallager.qc_gallager_variable),
                           prepare=gfresh),
                # the kernel alone (events add the wrapper's host work)
                device_ms=device_ms(
                    lambda: q4(qc_gallager.qc_gallager_variable),
                    "qc_gallager_variable", prepare=gfresh),
                tx_device_ms=device_ms(
                    lambda: q4(qc_gallager.qc_gallager_variable, tx),
                    "qc_gallager_variable", prepare=gfresh),
                init_device_ms=device_ms(
                    lambda: q4_init(qc_gallager.qc_gallager_variable),
                    "qc_gallager_init"),
                plain_ms=time_ms(
                    lambda: q4(qc_gallager._qc_gallager_variable_plain),
                    prepare=gfresh, reps=reps_plain),
                tx_ms=time_ms(lambda: q4(qc_gallager.qc_gallager_variable,
                                         tx), prepare=gfresh),
                init_ms=time_ms(
                    lambda: q4_init(qc_gallager.qc_gallager_variable)),
                # the first messages: the channel and the tables read, the
                # messages written
                init_bound_ms=bound(nbytes(
                    gstate["rx"], gstate["before"], adj.var_chk, adj.var_row,
                    adj.var_shift))["bound_ms"],
                **bound(nbytes(gstate["before"], gstate["before"],
                               gstate["parity"], gstate["rx"],
                               gstate["decided"], gstate["counts"],
                               adj.var_chk, adj.var_row, adj.var_shift)))}
        print(f"single launches at {label} (ms): "
              f"{json.dumps(single[label])}", flush=True)
        del gstate, out, state, q1_out
    for name in names:
        at4, at6 = single["n1e4"][name], single["n1e6"][name]
        measured[name].update(
            max_abs_err=err[name], library_ms=None, **at4,
            **{f"{k}_n1e6": v for k, v in at6.items()})
    print(json.dumps({"qc_single_launch_ms": single, "shapes": {
        "n1e4": [QC_NB, QC_Z, WORDS_FULL], "n1e6": [QC_NB, QC_Z6, QC_W6]},
        "card": smi}), flush=True)

    # -- 29 -------------------------------------------------------------------
    phase("29 whole QC decodes: circulant-index kernels == plain == the "
          "generic kernels on expand()")

    def same_bec(a, b, what):
        check(torch.equal(a.known, b.known)
              and (a.val is None or torch.equal(a.val, b.val))
              and torch.equal(a.error_totals, b.error_totals)
              and a.iterations == b.iterations, f"BEC decode: {what}")

    def same_gal(a, b, what):
        check(torch.equal(a.decided, b.decided)
              and torch.equal(a.error_totals, b.error_totals)
              and a.iterations == b.iterations, f"Gallager decode: {what}")

    for label, c, words, eps, p, plain in (
            ("n1e4", reg["n1e4"], WORDS_FULL, EPS_FULL, P_GAL, True),
            ("irregular BEC", irr_bec, WORDS_FULL, EPS_FULL, P_GAL, True),
            ("irregular BSC", irr_gal, WORDS_FULL, EPS_FULL, P_GAL_IRR,
             True),
            ("n1e6", reg["n1e6"], QC_W6, EPS_FULL, P_GAL, False)):
        e = expanded[label]
        irregular = isinstance(c, qc.IrregularQCLDPCCode)
        erased = bitops.bernoulli_packed(eps, (c.n, words), seed=11,
                                         device=dev)
        flips = bitops.bernoulli_packed(p, (c.n, words), seed=12, device=dev)
        tx = bitops.info_planes(c.n, words, seed=13, device=dev)
        roll = qc_bp.qc_bp_decode_packed_allzero(c, erased, ITERS)
        same_bec(roll, (erasure_bp.bp_decode_packed_allzero_irregular
                        if irregular else
                        erasure_bp.bp_decode_packed_allzero)(e, erased,
                                                             ITERS),
                 f"{label}: all-zero differs from the generic kernels")
        roll_v = qc_bp.qc_bp_decode_packed(c, erased, tx, ITERS)
        same_bec(roll_v, (erasure_bp.bp_decode_packed_irregular if irregular
                          else erasure_bp.bp_decode_packed)(e, erased, tx,
                                                            ITERS),
                 f"{label}: value planes differ from the generic kernels")
        check(torch.equal(roll_v.known, roll.known),
              f"{label}: value decode's known differs from the all-zero's")
        generic_gal = gallager.gallager_decode_packed_irregular \
            if irregular else gallager.gallager_decode_packed
        rolls_g = {}
        for t, with_tx in ((None, False), (1, False), (None, True)):
            kw = dict(threshold=t, tx_bits=tx if with_tx else None)
            rx = flips ^ tx if with_tx else flips
            rolls_g[t, with_tx] = qc_gallager.qc_gallager_decode_packed(
                c, rx, ITERS, **kw)
            same_gal(rolls_g[t, with_tx], generic_gal(e, rx, ITERS, **kw),
                     f"{label}: threshold {t}, tx {with_tx} differs from the "
                     "generic kernels")
            if plain:
                same_gal(rolls_g[t, with_tx],
                         qc_gallager.qc_gallager_decode_packed_plain(
                             c, rx, ITERS, **kw),
                         f"{label}: threshold {t}, tx {with_tx} differs from "
                         "the plain path")
        if plain:
            same_bec(roll, qc_bp.qc_bp_decode_packed_allzero_plain(
                c, erased, ITERS), f"{label}: all-zero differs from plain")
            same_bec(roll_v, qc_bp.qc_bp_decode_packed_plain(
                c, erased, tx, ITERS), f"{label}: values differ from plain")
        ga = rolls_g[None, False]
        print(f"{label}: BEC {roll.iterations} rounds, erasures "
              f"{int(roll.error_totals[0])} -> {int(roll.error_totals[-1])}; "
              f"Gallager-A {ga.iterations} rounds, errors "
              f"{int(ga.error_totals[0])} -> {int(ga.error_totals[-1])}, "
              f"B(t=1) {rolls_g[1, False].iterations} rounds; equal to the "
              f"generic kernels on expand()"
              f"{' and to the plain path' if plain else ''}", flush=True)
        del roll, roll_v, rolls_g

    # -- 30 -------------------------------------------------------------------
    phase("30 QC run_simulation: cuda against cpu, circulant index against "
          "expand(), the other modes through expand()")
    fields_eq = ("num_trials", "block_errors", "bit_errors",
                 "excluded_trials", "bit_errors_sq",
                 "error_counts_per_iteration", "stopped_by")
    small = {"regular": qc.sample_qc_code(gen(6), QC_NB, DV, DC, 64),
             "irregular": qc.sample_qc_code_irregular(gen(7), QC_NB_IRR,
                                                      LAM_BEC, RHO6, 32)}

    def small_cfg(kind, **fields):
        return SimulationConfig(**{
            "n": small[kind].n, "iterations": ITERS, "batch": 2048,
            "num_tests": 2 * 2048, "seed": 7, "code_mode": "fixed",
            "max_block_errors": 10**9, **fields})

    def launches_now():
        return {k: v["wrapper"].launches for k, v in kernels.items()}

    for kind, fields in (
            ("regular", dict(channel_param=EPS_FULL)),
            ("regular", dict(channel="BSC", decoder="gallager",
                             channel_param=P_GAL)),
            ("irregular", dict(channel_param=EPS_FULL, lam=LAM_BEC,
                               rho=RHO6))):
        cfg = small_cfg(kind, **fields)
        before = launches_now()
        r_gpu = mc.run_simulation(cfg, small[kind], device="cuda")
        used = {k: v - before[k] for k, v in launches_now().items()}
        r_cpu = mc.run_simulation(cfg, small[kind], device="cpu")
        r_exp = mc.run_simulation(cfg, small[kind].expand(), device="cuda")
        for f in fields_eq:
            check(getattr(r_gpu, f) == getattr(r_cpu, f),
                  f"QC {kind} {cfg.decoder}: cuda and cpu differ in {f}")
            check(getattr(r_gpu, f) == getattr(r_exp, f),
                  f"QC {kind} {cfg.decoder}: the circulant-index run and the "
                  f"expand() run differ in {f}")
        pair = names[:2] if cfg.channel == "BEC" else names[2:]
        check(all(used[k] > 0 for k in pair)
              and used["check_exactly_one"] == 0
              and used["gallager_variable"] == 0,
              f"QC {kind} {cfg.decoder}: launches {used}")
        print(f"QC {kind} {cfg.channel} {cfg.decoder}: cuda == cpu == "
              f"expand() run; block_errors {r_gpu.block_errors}, bit_errors "
              f"{r_gpu.bit_errors}", flush=True)
    # the expanded code's word fits kernel D's block (with random transmit
    # its value form's): a block a word
    for what, fields, generic in (
            ("random transmit", dict(channel_param=EPS_FULL,
                                     transmit="random"),
             "erasure_decode_values"),
            ("expurgated", dict(channel_param=0.45, expurgation=2),
             "erasure_decode"),
            # float soft stays on expand() (int8 min-sum goes by index:
            # phases 34-35)
            ("float32 min-sum", dict(channel="BSC", decoder="minsum",
                                     channel_param=0.05), "soft_check")):
        cfg = small_cfg("regular", **fields)
        before = launches_now()
        res = mc.run_simulation(cfg, small["regular"], device="cuda")
        used = {k: v - before[k] for k, v in launches_now().items()}
        check(res.num_trials == 2 * 2048 and used[generic] > 0
              and all(used[k] == 0 for k in names + ("qc_soft_posterior",
                                                     "qc_soft_check")),
              f"QC {what}: did not run on expand() (launches {used})")
        print(f"QC {what}: ran on expand() ({generic} x{used[generic]}), "
              f"block_errors {res.block_errors}, excluded "
              f"{res.excluded_trials}", flush=True)

    # -- 31 -------------------------------------------------------------------
    phase(f"31 the QC path at full width: run_simulation(cfg, code=qc), "
          f"n={reg['n1e4'].n}, batch {32 * WORDS_FULL}, {ITERS} iterations")
    by_path = {}

    def drive(name, code, chunks, words, **fields):
        """One run through the engine's entry point for QC codes, the
        launch counts set to 0 just before it and read just after."""
        cfg = SimulationConfig(**{
            "n": code.n, "iterations": ITERS, "batch": 32 * words,
            "num_tests": chunks * 32 * words, "seed": 1,
            "code_mode": "fixed", "max_block_errors": 10**9, **fields})
        for k in kernels.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        res = mc.run_simulation(cfg, code=code, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        by_path[name] = launches_now()
        rates = res.error_rate_per_iteration
        check(res.num_trials == chunks * 32 * words
              and len(rates) == ITERS + 1 and all(map(math.isfinite, rates))
              and abs(rates[0] - cfg.channel_param) < 1e-3
              and 0.0 <= res.bit_error_rate <= 1.0
              and 0.0 <= res.block_error_rate <= 1.0,
              f"QC path {name}: result malformed")
        check(cfg.channel != "BEC"
              or (all(a >= b for a, b in zip(rates, rates[1:]))
                  and res.bit_error_rate <= rates[0]),
              f"QC path {name}: erasure rate increased between iterations")
        # the rounds run, from the generic decoders on expand() on the same
        # chunks' planes (launched after the counts were read)
        e = code.expand()
        irregular = isinstance(code, qc.IrregularQCLDPCCode)
        rounds = 0
        for chunk in range(chunks):
            planes = bitops.bernoulli_packed(cfg.channel_param,
                                             (code.n, words), seed=cfg.seed,
                                             offset=chunk, device=dev)
            if cfg.channel == "BEC":
                rounds += (erasure_bp.bp_decode_packed_allzero_irregular
                           if irregular else
                           erasure_bp.bp_decode_packed_allzero)(
                    e, planes, ITERS).iterations
            else:
                rounds += (gallager.gallager_decode_packed_irregular
                           if irregular else
                           gallager.gallager_decode_packed)(
                    e, planes, ITERS).iterations
        got = by_path[name]
        if cfg.channel == "BEC":
            want = {names[0]: rounds, names[1]: rounds, names[2]: 0,
                    names[3]: 0}
        else:       # Q4 also writes each chunk's first messages
            want = {names[0]: 0, names[1]: 0, names[2]: rounds,
                    names[3]: rounds + chunks}
        check(all(got[k] == v for k, v in want.items())
              and got["bernoulli_packed"] == chunks
              and got["per_trial_counts"] > 0
              and got["check_exactly_one"] == 0
              and got["gallager_check"] == 0,
              f"QC path {name}: launches {got}, expected {want} for {rounds} "
              f"rounds in {chunks} chunks")
        lo, hi = wilson(res.block_errors, res.num_trials)
        print(f"QC path {name}: {res.num_trials} trials in {run_s:.4f} s, "
              f"{rounds} rounds, FER {res.block_error_rate:.5f} (99% "
              f"[{lo:.5f}, {hi:.5f}]) BER {res.bit_error_rate:.4e}; launches "
              f"{ {k: got[k] for k in names if got[k]} }", flush=True)
        return res

    bec = drive("qc_bec_36", reg["n1e4"], 4, WORDS_FULL,
                channel_param=EPS_FULL)
    for k in names[:2]:
        measured[k]["launches"] = by_path["qc_bec_36"][k]
    check(0.0 < bec.block_error_rate < 1.0,
          f"QC BEC FER {bec.block_error_rate} at eps = {EPS_FULL}")
    print(f"FER at eps = {EPS_FULL}: QC nb={QC_NB} Z={QC_Z} "
          f"{bec.block_error_rate:.5f}, 99% "
          f"{wilson(bec.block_errors, bec.num_trials)}; the fixed (3,6) "
          f"code of n = {N_FULL} (phase 6): {fer_fixed_36:.5f}", flush=True)
    gal = drive("qc_gallager_36", reg["n1e4"], 4, WORDS_FULL, channel="BSC",
                decoder="gallager", channel_param=P_GAL)
    for k in names[2:]:
        measured[k]["launches"] = by_path["qc_gallager_36"][k]
    check(gal.bit_error_rate < 0.1 * P_GAL,
          f"QC Gallager-A BER {gal.bit_error_rate} at p = {P_GAL}")
    irr_b = drive("qc_bec_irregular", irr_bec, 2, WORDS_FULL,
                  channel_param=EPS_FULL, lam=LAM_BEC, rho=RHO6)
    irr_g = drive("qc_gallager_irregular", irr_gal, 2, WORDS_FULL,
                  channel="BSC", decoder="gallager", channel_param=P_GAL_IRR,
                  lam=LAM_GAL, rho=RHO6)
    check(irr_b.bit_error_rate < EPS_FULL / 10
          and irr_g.bit_error_rate < 0.1 * P_GAL_IRR,
          f"irregular QC BER {irr_b.bit_error_rate} / {irr_g.bit_error_rate}")
    huge = drive("qc_bec_n1e6", reg["n1e6"], 2, QC_W6,
                 channel_param=EPS_FULL)
    bracket = {}
    for eps in (0.38, 0.46):
        bracket[eps] = drive(f"qc_bec_n1e5_eps{eps}", reg["n1e5"], 1, QC_W5,
                             channel_param=eps)
    check(bracket[0.38].bit_error_rate < 1e-5
          and bracket[0.46].bit_error_rate > 0.15
          and bracket[0.46].block_error_rate == 1.0,
          f"QC Z={QC_Z5}: BER {bracket[0.38].bit_error_rate} / "
          f"{bracket[0.46].bit_error_rate} at eps 0.38 / 0.46 does not "
          "bracket the threshold")
    print(json.dumps({"qc_paths": {
        "fer_eps042_n1e4": bec.block_error_rate,
        "fer_eps042_fixed_36_n1e4": fer_fixed_36,
        "gallager_a_ber_p003": gal.bit_error_rate,
        "irregular_ber": [irr_b.bit_error_rate, irr_g.bit_error_rate],
        "n1e6_eps042": [huge.block_error_rate, huge.bit_error_rate],
        "n1e5_ber_eps038_eps046": [bracket[0.38].bit_error_rate,
                                   bracket[0.46].bit_error_rate]},
        "launches": {p: {k: v[k] for k in names if v[k]}
                     for p, v in by_path.items()}, "card": smi}), flush=True)
    for k in names:
        measured[k]["launches_by_path"] = {p: v[k] for p, v in by_path.items()
                                           if v[k]}

    # -- 32 -------------------------------------------------------------------
    phase("32 QC timing: circulant index against gather (the generic "
          "kernels on expand()), whole decodes")
    timing = {}
    for label, c in reg.items():
        words = words_of[label]
        e = expanded[label]
        erased = bitops.bernoulli_packed(EPS_FULL, (c.n, words), seed=11,
                                         device=dev)
        flips = bitops.bernoulli_packed(P_GAL, (c.n, words), seed=12,
                                        device=dev)
        runs = {
            "bec_gather": lambda: erasure_bp.bp_decode_packed_allzero(
                e, erased, ITERS),
            "bec_index": lambda: qc_bp.qc_bp_decode_packed_allzero(
                c, erased, ITERS),
            "gallager_gather": lambda: gallager.gallager_decode_packed(
                e, flips, ITERS),
            "gallager_index": lambda: qc_gallager.qc_gallager_decode_packed(
                c, flips, ITERS)}
        ms = {}
        for dec in ("bec", "gallager"):
            for way in ("gather", "index", "index", "gather"):
                ms.setdefault(f"{dec}_{way}", []).append(
                    time_ms(runs[f"{dec}_{way}"], reps=3))
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        rounds = {"bec": runs["bec_index"]().iterations,
                  "gallager": runs["gallager_index"]().iterations}
        k_bits = c.k * 32 * words
        timing[label] = {
            "n": c.n, "Z": c.Z, "words": words, "decode_ms": ms,
            "rounds": rounds,
            "index_over_gather_speedup": {
                dec: mean[f"{dec}_gather"] / mean[f"{dec}_index"]
                for dec in ("bec", "gallager")},
            "info_bits_per_s": {k: k_bits / (v / 1e3)
                                for k, v in mean.items()}}
        print(f"{label} (n={c.n}, W={words}): BEC gather "
              f"{mean['bec_gather']:.3f} ms, index {mean['bec_index']:.3f} ms "
              f"({rounds['bec']} rounds); Gallager-A gather "
              f"{mean['gallager_gather']:.3f} ms, index "
              f"{mean['gallager_index']:.3f} ms ({rounds['gallager']} rounds)",
              flush=True)
    print(json.dumps({"qc_index_against_gather": timing, "eps": EPS_FULL,
                      "p": P_GAL, "iterations": ITERS, "card": smi}),
          flush=True)
    cfg6 = SimulationConfig(n=reg["n1e6"].n, channel_param=EPS_FULL,
                            iterations=ITERS, batch=32 * QC_W6, seed=1,
                            code_mode="fixed")
    chunk6 = mc.make_chunk_fn(cfg6, reg["n1e6"], device=dev)
    chunk6(9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in range(2):
        int(chunk6(idx).block_errors)
    torch.cuda.synchronize()
    chunk6_ms = (time.perf_counter() - t0) / 2 * 1e3
    print(f"QC BEC chunk at n={reg['n1e6'].n}, W={QC_W6}: {chunk6_ms:.3f} ms, "
          f"{32 * QC_W6 / chunk6_ms * 1e3:.4e} trials/s; card {smi}",
          flush=True)
    print(device_time_breakdown(lambda: int(chunk6(5).block_errors),
                                chunk6_ms, kernels), flush=True)
    # the QC BEC decode at n = 1,000,008 (bec_index above): its device time
    # by kernel, held to Q1's and Q2's launch counts
    c6 = reg["n1e6"]
    erased6 = bitops.bernoulli_packed(EPS_FULL, (c6.n, QC_W6), seed=11,
                                      device=dev)
    bec6_ms = timing["n1e6"]["decode_ms"]["bec_index"]
    print(f"QC BEC decode at n={c6.n}, W={QC_W6}: "
          f"{sum(bec6_ms) / len(bec6_ms):.3f} ms "
          f"({timing['n1e6']['rounds']['bec']} rounds); card {smi}",
          flush=True)
    print(device_time_breakdown(
        lambda: qc_bp.qc_bp_decode_packed_allzero(c6, erased6,
                                                  ITERS).iterations,
        sum(bec6_ms) / len(bec6_ms),
        {k: kernels[k] for k in names[:2]}), flush=True)
    del erased6
    # the QC Gallager-A decode at n = 1,000,008 (gallager_index above): its
    # device time by kernel; Q4's first messages are a kernel of another
    # name, so the trace is held to Q3's launch count
    flips6 = bitops.bernoulli_packed(P_GAL, (c6.n, QC_W6), seed=12,
                                     device=dev)
    gal6_ms = timing["n1e6"]["decode_ms"]["gallager_index"]
    print(f"QC Gallager-A decode at n={c6.n}, W={QC_W6}: "
          f"{sum(gal6_ms) / len(gal6_ms):.3f} ms "
          f"({timing['n1e6']['rounds']['gallager']} rounds); card {smi}",
          flush=True)
    print(device_time_breakdown(
        lambda: qc_gallager.qc_gallager_decode_packed(c6, flips6,
                                                      ITERS).iterations,
        sum(gal6_ms) / len(gal6_ms),
        {k: kernels[k] for k in ("qc_gallager_check",)}), flush=True)


def _cuobjdump(*flags, library=None) -> str:
    """The toolkit's cuobjdump on ``library`` (default: the built
    library)."""
    from iib_project_ldpc_codes_tpu_torch.kernels.build import (find_nvcc,
                                                                library_path)

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([tool, *flags, str(library or library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


# FP64 instructions a second: 64 FP64 lanes an SM at the boost clock (the
# data sheet's 33.5 TFLOP/s counts a fused multiply-add as two operations).
# Integer instructions issue on more than one pipe (IMAD on the FMA pipe),
# so they are held to INT32_OPS_S, the SM's 128 issue slots a clock.
FP64_INSTR_S = 132 * 64 * 1.98e9
_INT_ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "IMAD",
            "IMUL", "ISETP", "LEA", "IABS", "IMNMX", "VIMNMX", "VIADD", "POPC",
            "FLO", "BMSK", "SGXT", "BREV", "PRMT", "SEL", "I2I", "BFE", "BFI"}
_FP64 = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}
_QUARTER = {"MUFU", "F2F", "I2F", "F2I"}


def sass_loop_counts(kernel: str, library=None, innermost: bool = False
                     ) -> dict:
    """SASS instruction counts over one trip of the largest loop (the
    instructions between a backward branch and its target, each once) of
    the first function of ``library`` (default: the built library) whose
    name holds ``kernel``: ``fp64`` the FP64-pipe arithmetic (DADD, DMUL,
    DFMA, DSETP, DMNMX; ``fp64_guarded`` of them carry a predicate),
    ``quarter`` the conversions and special functions (MUFU, F2F, I2F,
    F2I: 16 a clock an SM),
    ``int_alu`` the integer and logic instructions (IADD3, LOP3, SHF,
    IMAD, ISETP, LEA, ...; no moves, memory, control or uniform-datapath
    instructions), ``loads`` the global loads, and ``total``.  Code called
    out of line (the math library's slow paths, after the kernel's EXIT)
    lies outside the loop and is not counted.  What could make a trip
    differ from the span: ``skipped`` the instructions of the span that a
    forward branch inside it jumps over (code a trip may not run, such as
    a rarely taken path placed inline), ``exits`` the branches out of the
    span that are not the latch, ``calls`` the calls in it, and ``span``
    the span's SASS, one instruction a line.  ``innermost``: the largest of
    the loops that hold no other loop."""
    import re

    kw = {"library": library} if library else {}
    name = next(k for k in _res_usage(**kw) if kernel in k)
    text = _cuobjdump("-sass", "-fun", name, **kw)
    found = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);", text)
    ins = [(int(a, 16), op, rest) for a, _, op, rest in found]
    guard = {int(a, 16): g.strip() for a, g, _, _ in found}
    targets = {a: int(t.group(1), 16) for a, op, rest in ins
               if op.startswith("BRA")
               and (t := re.search(r"0x([0-9a-f]+)", rest))}
    loops = [(t, a) for a, t in targets.items() if t <= a]
    if innermost:
        loops = [(t, a) for t, a in loops
                 if not any(t <= t2 and a2 <= a and (t2, a2) != (t, a)
                            for t2, a2 in loops)]
    check(bool(loops), f"{kernel}: no loop in its SASS")
    head, latch = max(loops, key=lambda x: x[1] - x[0])
    span = [(a, op, rest) for a, op, rest in ins if head <= a <= latch]
    kinds = [op.split(".")[0] for _, op, _ in span]
    skipped = {a for b, t in targets.items() if head <= b < t <= latch
               for a, _, _ in span if b < a < t}
    return {"function": name, "total": len(span),
            "fp64": sum(k in _FP64 for k in kinds),
            "fp64_guarded": sum(k.split(".")[0] in _FP64 and bool(guard[a])
                                for a, k, _ in span),
            "quarter": sum(k in _QUARTER for k in kinds),
            "int_alu": sum(k in _INT_ALU for k in kinds),
            "loads": sum(k == "LDG" for k in kinds),
            "skipped": len(skipped),
            "exits": sum(head <= b < latch and not head <= t <= latch
                         for b, t in targets.items()),
            "calls": sum(k.startswith("CALL") for k in kinds),
            "span": [" ".join(f"{a:04x} {guard[a]} {op}{rest}".split())
                     for a, op, rest in span]}


def vertical_count_ops(rows: int, words: int) -> int:
    """The integer operations the per-trial counts of an int32[rows, words]
    plane need: a bit-sliced (carry-save) vertical counter takes each word
    in with about one full adder, 5 logic operations (2 XOR, 2 AND, 1 OR),
    and reads the 32 counts of a column out of its bit planes (one a bit of
    ``rows``) at 3 operations (shift, mask, add) a count a plane."""
    return 5 * rows * words + 3 * 32 * rows.bit_length() * words


def _resource_fields(text: str) -> dict:
    """cuobjdump's REG/STACK/SHARED/LOCAL of one function, with the
    theoretical occupancy its registers allow at 256 threads a block."""
    f = {k.lower(): int(v) for k, v in (kv.split(":") for kv in text.split())}
    warp_regs = -(-f["reg"] * 32 // 256) * 256
    f["occupancy_from_registers"] = min(65536 // (warp_regs * 8), 8) * 8 / 64
    return f


def erasure_decode_resources() -> dict:
    """Registers, stack frame and local memory (spills) of kernel D's four
    kernels: the all-zero ``erasure_decode_kernel<kMaxDc>`` and the value
    form ``erasure_decode_values_kernel<kMaxDc>`` (21 and 28 letters
    mangled), kMaxDc 8 the unrolled socket loop, 0 the runtime degree."""
    import re

    out = {}
    for name, text in re.findall(r"Function (\S+):\s*(REG:\d+ STACK:\d+ "
                                 r"SHARED:\d+ LOCAL:\d+)",
                                 _cuobjdump("-res-usage")):
        m = re.search(r"(21erasure_decode_kernel|28erasure_decode_values"
                      r"_kernel)ILi(\d+)E", name)
        if m:
            form = "values" if "values" in m.group(1) else "allzero"
            dc = int(m.group(2))
            out[f"{form}_" + (f"dc{dc}" if dc else "loop")] = \
                _resource_fields(text)
    check(len(out) == 4, f"kernel D: {sorted(out)} in the library, expected "
                         "four kernels")
    return out


# the BEC round's gather kernels and their exact degrees: K2, K3, their
# value forms (check_exactly_one_xor, variable_or_adopt) and X1
ROUND_KERNELS = (("check_exactly_one", "dc"), ("variable_or_update", "dv"),
                 ("check_exactly_one_xor", "dc"),
                 ("variable_or_adopt", "dv"), ("edge_candidates", "dv"))


def _res_usage(library=None) -> dict:
    """cuobjdump -res-usage of ``library`` (default: the built library):
    {mangled name: text}."""
    import re

    return dict(re.findall(r"Function (\S+):\s*(REG:\d+ STACK:\d+ "
                           r"SHARED:\d+ LOCAL:\d+)",
                           _cuobjdump("-res-usage", library=library)))


def round_kernel_resources(usage: dict, kernels) -> dict:
    """Registers of the round kernels ``kernels`` ((name, degree letter)
    pairs of ROUND_KERNELS): each ``<name>_kernel<N, kDeg>`` (degree 0 the
    socket loop), four instantiations each; fails on local memory in
    any."""
    import re

    out = {}
    for kernel, deg in kernels:
        out[kernel] = {}
        for name, text in usage.items():
            m = re.search(rf"{len(kernel) + 7}{kernel}_kernelI(\w*?)EEv",
                          name)
            if not m:
                continue
            vec, exact = map(int, re.findall(r"L[ib](\d+)E", m.group(1)))
            key = f"N{vec}_" + (f"{deg}{exact}" if exact else "loop")
            f = _resource_fields(text)
            out[kernel][key] = f
            check(f["local"] == 0, f"{kernel} {key}: local memory {text}")
        check(len(out[kernel]) == 4, f"{kernel}: {len(out[kernel])} "
              "instantiations in the library, expected 4")
    return out


def kernel_resources(smi: str) -> dict:
    """Registers, stack frame and local memory (spills), read with the
    toolkit's cuobjdump from the built library, of every instantiation of
    kernels C (``soft_check``) and B (``soft_posterior``), of the Gallager
    round kernels (``gallager_check``, ``gallager_variable``), of Q1 and Q2
    (``qc_check_exactly_one``, ``qc_variable_or``), of K2, K3, their value
    forms and X1 (ROUND_KERNELS), of
    Q4
    (``qc_gallager_variable``, its first messages too) and of S2's
    int8 instantiations
    (``qc_soft_check_int8``, with their SASS instruction counts); with the
    theoretical occupancy the registers allow at 256 threads a block (a
    warp's registers allocated in units of 256, at most 64 warps an SM).
    Fails on a stack frame or local memory in S2 int8 and on local memory
    in C, in the round kernels' exact-degree instantiations and in Q1, Q2,
    K2, K3, their value forms, X1 and Q4; C's
    stack frames (spill slots) are printed: its int8 instantiations up to
    degree 6 are held to 80 registers for three blocks an SM, measured faster
    with a few bytes spilled than at 96."""
    import re

    usage = _res_usage()
    s2 = {k: v for k, v in usage.items() if "qc_soft_check_kernel_int8" in k}
    check(len(s2) == 3, f"S2 int8: {len(s2)} instantiations in the library, "
          "expected 3")
    sass = {}
    # disassembling only these three keeps the call to seconds
    dumped = _cuobjdump("-sass", "-fun", ",".join(s2))
    for body in dumped.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if name in s2:
            sass[name] = [op for op in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                body) if not op.startswith("NOP")]
    out = {"qc_soft_check_int8": {}, "soft_check": {}}
    for name, text in s2.items():
        words, max_dc = map(int, re.search(
            r"kernel_int8ILi(\d+)ELi(\d+)E", name).groups())
        f = _resource_fields(text)
        ops = len(sass[name])
        f.update(sass_instructions=ops,
                 per_socket_and_word=ops / (max_dc * words))
        out["qc_soft_check_int8"][f"U{words}_dc{max_dc}"] = f
        check(f["stack"] == 0 and f["local"] == 0,
              f"S2 int8 {name}: stack frame or local memory {text}")
    # kernel C: soft_check_kernel<T, method, V, kDc, exact> and
    # soft_check_kernel_int8<U, kDc, exact> (17 and 22 letters mangled)
    for name, text in usage.items():
        m = re.search(r"(17soft_check_kernel|22soft_check_kernel_int8)I"
                      r"(\w*?)EEv", name)
        if not m:
            continue
        args = list(map(int, re.findall(r"L[ib](\d+)E", m.group(2))))
        if m.group(1).endswith("int8"):
            words, max_dc, exact = args
            key = f"int8_minsum_V{4 * words}"
        else:
            method, vec, max_dc, exact = args
            key = ("bf16" if "bfloat16" in m.group(2) else "f32") + \
                ("_sumproduct" if method else "_minsum") + f"_V{vec}"
        key += f"_dc{max_dc}" if exact else f"_dcmax{max_dc}"
        f = _resource_fields(text)
        out["soft_check"][key] = f
        check(f["local"] == 0, f"kernel C {key}: local memory {text}")
    check(len(out["soft_check"]) == 115, f"kernel C: "
          f"{len(out['soft_check'])} instantiations in the library, "
          "expected 115")
    # kernel B: soft_posterior_kernel<T, V, kDv, exact> and
    # soft_posterior_kernel_int8<U, kDv, exact> (21 and 26 letters mangled)
    out["soft_posterior"] = {}
    for name, text in usage.items():
        m = re.search(r"(21soft_posterior_kernel|26soft_posterior_kernel_int8)"
                      r"I(\w*?)EEv", name)
        if not m:
            continue
        args = list(map(int, re.findall(r"L[ib](\d+)E", m.group(2))))
        if m.group(1).endswith("int8"):
            words, max_dv, exact = args
            key = f"int8_V{4 * words}"
        else:
            vec, max_dv, exact = args
            key = ("bf16" if "bfloat16" in m.group(2) else "f32") + \
                f"_V{vec}"
        key += f"_dv{max_dv}" if exact else "_generic"
        out["soft_posterior"][key] = _resource_fields(text)
    check(len(out["soft_posterior"]) == 66, f"kernel B: "
          f"{len(out['soft_posterior'])} instantiations in the library, "
          "expected 66")
    # the Gallager round kernels: gallager_check_kernel<V, kDc> (kDc 0 the
    # generic degree) and gallager_variable_kernel<V, D, kTx> (D 0 the
    # generic degree at one word; 21 and 24 letters mangled)
    out["gallager_check"], out["gallager_variable"] = {}, {}
    for name, text in usage.items():
        m = re.search(r"(21gallager_check_kernel|24gallager_variable_kernel)"
                      r"I(\w*?)EEv", name)
        if not m:
            continue
        args = list(map(int, re.findall(r"L[ib](\d+)E", m.group(2))))
        f = _resource_fields(text)
        if m.group(1).endswith("check_kernel"):
            vec, deg = args
            key = f"V{vec}_" + (f"dc{deg}" if deg else "generic")
            exact = deg > 0
        else:
            vec, deg, tx = args
            key = f"V{vec}_" + (f"dv{deg}" if deg else "generic") + \
                ("_tx" if tx else "")
            exact = deg > 0
        out[m.group(1)[2:-7]][key] = f
        check(f["local"] == 0 or not exact,
              f"Gallager round kernel {key}: local memory {text}")
    check(len(out["gallager_check"]) == 6
          and len(out["gallager_variable"]) == 14,
          f"Gallager round kernels: {len(out['gallager_check'])} / "
          f"{len(out['gallager_variable'])} instantiations in the library, "
          "expected 6 / 14")
    # Q4: qc_gallager_variable_kernel<N, kTx>, its exact-degree and generic
    # passes inlined, and qc_gallager_init_kernel<N> (27 and 23 letters
    # mangled); no local memory in any
    out["qc_gallager_variable"] = {}
    for name, text in usage.items():
        m = re.search(r"(27qc_gallager_variable_kernel|"
                      r"23qc_gallager_init_kernel)I(\w*?)EEv", name)
        if not m:
            continue
        args = list(map(int, re.findall(r"L[ib](\d+)E", m.group(2))))
        key = f"init_N{args[0]}" if m.group(1).endswith("init_kernel") \
            else f"N{args[0]}" + ("_tx" if args[1] else "")
        f = _resource_fields(text)
        out["qc_gallager_variable"][key] = f
        check(f["local"] == 0, f"Q4 {key}: local memory {text}")
    check(len(out["qc_gallager_variable"]) == 6,
          f"Q4: {len(out['qc_gallager_variable'])} instantiations in the "
          "library, expected 6")
    # Q1 and Q2: qc_check_exactly_one_kernel<kVal, N> and
    # qc_variable_or_kernel<kVal, N> (27 and 21 letters mangled); no local
    # memory in any
    for kernel in ("qc_check_exactly_one", "qc_variable_or"):
        out[kernel] = {}
        for name, text in usage.items():
            m = re.search(rf"{len(kernel) + 7}{kernel}_kernelI(\w*?)EEv",
                          name)
            if not m:
                continue
            values, vec = map(int, re.findall(r"L[ib](\d+)E", m.group(1)))
            key = f"N{vec}" + ("_values" if values else "")
            f = _resource_fields(text)
            out[kernel][key] = f
            check(f["local"] == 0, f"{kernel} {key}: local memory {text}")
        check(len(out[kernel]) == 4, f"{kernel}: {len(out[kernel])} "
              "instantiations in the library, expected 4")
    out.update(round_kernel_resources(usage, ROUND_KERNELS))
    print(f"kernel resources (S2 int8: U words a thread, up to dc sockets, "
          f"per_socket_and_word the kernel's SASS over dc * U; kernels C "
          f"and B: type, (C) method, V trials a thread, the exact degree or "
          f"the generic path (C: its bound); card {smi}): "
          f"{json.dumps(out)}",
          flush=True)
    return out


def qc_soft_peel_paths(dev, smi, measured, kernels, scratch_root) -> dict:
    """Phases 33-37: the QC soft decoder by circulant index (S1, S2) and the
    sequential peeling decoder (P1) with its R-process experiment (module
    docstring).  S1 and S2 are held to their plain versions exactly, bar
    sum-product's CUDA tanhf/atanhf (to phase 18's tolerance), P1 exactly
    (its choices are canonical).  Returns the numbers PERF.md reads."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.models import (ensemble, irregular,
                                                         qc)
    from iib_project_ldpc_codes_tpu_torch.ops import (bitops, channels,
                                                      erasure_bp, peeling,
                                                      qc_bp, qc_soft_bp,
                                                      soft_bp)
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils import experiments
    from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

    names = ("qc_soft_posterior", "qc_soft_check", "peel_sequential")
    soft5 = (("minsum", torch.float32), ("minsum", torch.bfloat16),
             ("minsum", torch.int8), ("sumproduct", torch.float32),
             ("sumproduct", torch.bfloat16))
    sp_atol = {torch.float32: 0.1, torch.bfloat16: 0.5}
    out = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def launches_now():
        return {k: v["wrapper"].launches for k, v in kernels.items()}

    reg = {"n1e4": (qc.sample_qc_code(gen(1), QC_NB, DV, DC, QC_Z,
                                      device=dev), COLS_SOFT),
           "n1e5": (qc.sample_qc_code(gen(2), QC_NB, DV, DC, QC_Z5,
                                      device=dev), 32 * QC_W5),
           "n1e6": (qc.sample_qc_code(gen(3), QC_NB, DV, DC, QC_Z6,
                                      device=dev), 32 * QC_W6)}
    irr = qc.sample_qc_code_irregular(gen(4), QC_NB_IRR, LAM_BEC, RHO6,
                                      QC_Z_IRR, device=dev)

    # -- 33 -------------------------------------------------------------------
    phase("33 S1 and S2 against their plain versions in all five "
          "instantiations (n=10,008 / 1,000,008 / irregular nb=24); P1 "
          f"(every form) against its plain version at n={PEEL_N} on "
          f"{PEEL_REPEATS} fresh codes, the irregular family on "
          f"{PEEL_CODES_IRR}")
    err = {names[0]: 0.0, names[1]: 0.0}
    single = {}
    g = torch.Generator(device=dev).manual_seed(5)
    for label, code, cols in (("n1e4",) + reg["n1e4"], ("n1e6",) + reg["n1e6"],
                              ("irregular", irr, COLS_SOFT)):
        adj = qc_bp._adjacency(code, dev)
        rows = adj.num_rows * adj.Z
        one = torch.ones(1, dtype=torch.int32, device=dev)
        for method, dtype in soft5:
            # float types at n ~ 1e6 on half the trials: three 9-18 GB
            # message planes would not leave the plain version room
            c = cols // 2 if label == "n1e6" and dtype != torch.int8 \
                else cols
            if dtype == torch.int8:
                def draw(shape, _mean, _sd):
                    return torch.randint(-127, 128, shape, generator=g,
                                         device=dev, dtype=torch.int8)
                llr0 = draw((code.n, c), 0, 0)
            else:
                def draw(shape, mean, sd):
                    return (torch.randn(shape, generator=g, device=dev) * sd
                            + mean).to(dtype)
                llr0 = draw((code.n, c), 2, 4).float()
            msg0, pm0 = draw((rows, c), 0, 6), draw((code.n, c), 0, 8)
            if method == "minsum":   # S1 does not read the method
                for mode in ("total", "per_trial", "final"):
                    got = []
                    for fn in (qc_soft_bp.qc_soft_posterior,
                               qc_soft_bp._qc_soft_posterior_plain):
                        pm = pm0.clone()
                        counts = torch.zeros(1 if mode == "total" else c,
                                             dtype=torch.int32, device=dev)
                        extra = {} if mode != "final" else dict(
                            post=torch.empty((code.n, c), device=dev),
                            hard=torch.empty((code.n, c), dtype=torch.bool,
                                             device=dev))
                        fn(llr0, msg0, adj, one, pm, counts, int8_scale=4.0,
                           **extra)
                        got.append([pm, counts, *extra.values()])
                    torch.cuda.synchronize()
                    for a, b in zip(*got):
                        check(torch.equal(a, b), f"S1 ({label}, {dtype}, "
                              f"{mode}) differs from its plain version")
                    del got
            kw = dict(method=method)
            if method == "minsum" and dtype != torch.int8:
                kw.update(alpha=0.8, beta=0.25)

            def s2_against_plain(pm_in, msg_in, what):
                got = []
                for fn in (qc_soft_bp.qc_soft_check,
                           qc_soft_bp._qc_soft_check_plain):
                    msg = msg_in.clone()
                    unsat = torch.zeros(1, dtype=torch.int32, device=dev)
                    fn(pm_in, msg, adj, one, unsat, **kw)
                    got.append((msg, unsat))
                torch.cuda.synchronize()
                (mk, uk), (mp, up) = got
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(mk.split(1 << 16),
                                           mp.split(1 << 16)))
                check(torch.equal(uk, up) and int(up) > 0,
                      f"S2 ({label}, {method}, {dtype}{what}): syndromes "
                      f"{int(uk)} / {int(up)}")
                check(diff == 0.0 if method == "minsum"
                      else diff <= sp_atol[dtype],
                      f"S2 ({label}, {method}, {dtype}{what}) differs from "
                      f"its plain version by {diff}")
                err[names[1]] = max(err[names[1]], diff)

            s2_against_plain(pm0, msg0, "")
            if dtype == torch.int8:
                # r = p - m hits +-255, +-128, +-127 and 0; ties everywhere
                edge = torch.tensor([-128, -127, -1, 0, 1, 127],
                                    dtype=torch.int8, device=dev)
                s2_against_plain(*(edge[torch.randint(
                    0, len(edge), shape, generator=g, device=dev)]
                    for shape in ((code.n, c), (rows, c))), ", edge values")
            timed = label in ("n1e4", "n1e6") and (method, dtype) in (
                ("minsum", torch.int8), ("sumproduct", torch.float32))
            if timed:
                key = f"{label}_{'int8' if dtype == torch.int8 else 'f32sp'}"
                pm = pm0.clone()
                msg = msg0.clone()
                counts = torch.zeros(1, dtype=torch.int32, device=dev)
                unsat = torch.zeros(1, dtype=torch.int32, device=dev)
                tables = (adj.var_row, adj.var_shift)

                def s1(fn):
                    fn(llr0, msg0, adj, one, pm, counts)

                def s2(fn):
                    fn(pm0, msg, adj, one, unsat, **kw)

                single[key] = {
                    names[0]: dict(
                        ms=time_ms(lambda: s1(qc_soft_bp.qc_soft_posterior)),
                        plain_ms=time_ms(lambda: s1(
                            qc_soft_bp._qc_soft_posterior_plain), reps=1,
                            warmup=False),
                        **bound(nbytes(llr0, msg0, pm, counts, *tables))),
                    names[1]: dict(
                        ms=time_ms(lambda: s2(qc_soft_bp.qc_soft_check)),
                        plain_ms=time_ms(lambda: s2(
                            qc_soft_bp._qc_soft_check_plain), reps=1,
                            warmup=False),
                        **bound(nbytes(pm0, msg0, msg0, adj.chk_block,
                                       adj.chk_shift, adj.row_offs)))}
                s2 = single[key][names[1]]
                moved = 3 * rows * c * pm0.element_size()
                s2.update(moved_gb=moved / 1e9,
                          moved_gb_per_s=moved / (s2["ms"] / 1e3) / 1e9)
                print(f"S2 {key}: {s2['ms']:.4f} ms, "
                      f"{s2['moved_gb_per_s']:.1f} GB/s on the "
                      f"{s2['moved_gb']:.3f} GB it moves (pm once per check "
                      "socket, messages in and out; 3350 GB/s peak); bound "
                      f"as counted {s2['bound_ms']:.4f} ms; card {smi}",
                      flush=True)
                print(f"single launches {key} (n={code.n}, B={c}): "
                      f"{json.dumps(single[key])}", flush=True)
                del pm, msg
            del msg0, pm0, llr0
            torch.cuda.empty_cache()
        print(f"S1, S2 equal to plain on {label}: n={code.n}, Z={code.Z}, "
              f"B={cols}, E_b={adj.num_rows}", flush=True)
    resources = kernel_resources(smi)
    measured[names[1]]["int8_resources"] = resources["qc_soft_check_int8"]
    # the main paths' degree (dc = 6) in the kernels line; every
    # instantiation is on the resources line above
    measured["soft_check"]["resources_dc6"] = {
        k: v for k, v in resources["soft_check"].items() if k.endswith("_dc6")}
    for name in ("gallager_check", "gallager_variable", "check_exactly_one",
                 "variable_or_update", "edge_candidates"):
        measured[name]["resources"] = resources[name]
    for name in names[:2]:
        measured[name].update(
            max_abs_err=err[name], library_ms=None,
            **single["n1e4_int8"][name],
            **{f"{k}_{key}": v for key in ("n1e4_f32sp", "n1e6_int8",
                                           "n1e6_f32sp")
               for k, v in single[key][name].items() if k != "bound_by"})

    spec = irregular.IrregularEnsembleSpec.from_lam_rho(PEEL_N, LAM_BEC, RHO6,
                                                        device=dev)
    peel_cases = {}
    p1 = {}
    for fam in ("regular", "irregular"):
        trials = PEEL_REPEATS if fam == "regular" else PEEL_CODES_IRR
        codes = ensemble.sample_codes(7, 0, trials, PEEL_N, DV, DC,
                                      device=dev) if fam == "regular" else \
            irregular.sample_irregular_codes(7, 0, trials, spec, device=dev)
        erased = bitops.unpack_bits(bitops.bernoulli_packed(
            PEEL_EPS, (trials, (PEEL_N + 31) // 32), seed=7,
            device=dev))[:, :PEEL_N].contiguous()
        rx = torch.where(erased, 2, 0)
        got = peeling.peel_decode_batch(codes, rx, seed=7)
        ruled = peeling.peel_sequential.form
        chk, var, n, m = peeling._tables(codes)
        check(ruled == peeling.peel_form(n, m, chk.shape[-1], var.shape[-1])
              and ruled == "xor", f"P1 ({fam}): the rule launched {ruled}")
        # the plain version once, timed: plain_ms (regular)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = peeling.peel_decode_batch_plain(codes, rx, seed=7)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        peels = int((got.one_degree_evolution > 0).sum(1).max())
        forms = {}
        for form in peeling.PEEL_FORMS:
            launched = peeling.peel_sequential(chk, var, erased, n, m, 7, n,
                                               form=form)
            torch.cuda.synchronize()
            for f, a, b in zip(("unresolved", "one_degree_evolution",
                                "steps", "num_erasures"), launched, (
                    want.unresolved, want.one_degree_evolution, want.steps,
                    want.num_erasures)):
                check(torch.equal(a, b), f"P1 {form} ({fam}): {f} differs "
                      "from its plain version")
            dms = device_ms(lambda form=form: peeling.peel_sequential(
                chk, var, erased, n, m, 7, n, form=form), "peel", reps=3)
            forms[form] = dict(device_ms=dms, ms_a_step=dms / peels)
        peel_cases[fam] = (codes, erased, rx, got)
        print(f"P1 equal to plain ({fam}), every form: {trials} codes of n="
              f"{PEEL_N}, {int(got.steps.sum())} peels (longest {peels}), "
              f"{int((~got.success).sum())} failures; the rule launched "
              f"{ruled}; device ms (ms a step) {json.dumps(forms)}; plain "
              f"{plain_ms:.0f} ms", flush=True)
        if fam == "regular":
            p1 = dict(
                ms=time_ms(lambda: peeling.peel_decode_batch(codes, rx,
                                                             seed=7), reps=3),
                plain_ms=plain_ms, form=ruled, longest_peels=peels,
                forms=forms,
                **bound(nbytes(chk, var, erased, got.unresolved,
                               got.one_degree_evolution, got.steps,
                               got.num_erasures)))
            p1["ms_a_step"] = p1["ms"] / peels
            p1["bound_note"] = (
                "bytes: tables read once, evolution written once; a chain "
                f"of {peels} dependent steps per trial bounds it far above")
        else:
            p1["irregular"] = dict(codes=trials, form=ruled, forms=forms)
    measured[names[2]].update(max_abs_err=0, library_ms=None, **p1)
    print(f"P1 at {PEEL_REPEATS} codes: {json.dumps(p1)}", flush=True)

    # -- 34 -------------------------------------------------------------------
    phase("34 whole decodes: QC int8 by index == plain == kernels B/C on "
          "expand(); GPU == CPU runs; every peel's final set == the batched "
          "BP fixed point; the parallel peel == plain")

    def same_soft(a, b, what):
        check(a.iterations == b.iterations
              and torch.equal(a.error_totals, b.error_totals)
              and torch.equal(a.hard, b.hard)
              and torch.equal(a.posterior, b.posterior)
              and torch.equal(a.satisfied, b.satisfied), what)

    for label, code, llr in (
            ("n1e4 AWGN", reg["n1e4"][0], channels.awgn_llr(
                SIGMA_QC, (reg["n1e4"][0].n, COLS_SOFT), seed=3,
                device=dev)),
            ("n1e4 BSC", reg["n1e4"][0], channels.BSC(P_SOFT_BSC).llr_of_flips(
                bitops.bernoulli_packed(P_SOFT_BSC, (reg["n1e4"][0].n,
                                                     COLS_SOFT // 32),
                                        seed=4, device=dev))),
            ("irregular AWGN", irr, channels.awgn_llr(
                0.75, (irr.n, COLS_SOFT), seed=5, device=dev))):
        kw = dict(method="minsum", msg_dtype="int8")
        a = qc_soft_bp.qc_soft_bp_decode(code, llr, ITERS, **kw)
        generic = soft_bp.soft_bp_decode_irregular \
            if isinstance(code, qc.IrregularQCLDPCCode) else \
            soft_bp.soft_bp_decode
        same_soft(a, generic(code.expand(), llr, ITERS, **kw),
                  f"QC int8 ({label}) differs from kernels B/C on expand()")
        same_soft(a, qc_soft_bp.qc_soft_bp_decode_plain(code, llr, ITERS,
                                                        **kw),
                  f"QC int8 ({label}) differs from the plain path")
        print(f"QC int8 {label}: {a.iterations} rounds, errors "
              f"{int(a.error_totals[0])} -> {int(a.error_totals[-1])}, FER "
              f"{float(a.failed.float().mean()):.4f}; == plain == B/C on "
              "expand()", flush=True)
        del a, llr
    fields_eq = ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
                 "error_counts_per_iteration", "stopped_by")
    for fields in (dict(channel="AWGN", channel_param=SIGMA_QC),
                   dict(channel="BSC", channel_param=P_SOFT_BSC)):
        cfg = SimulationConfig(n=reg["n1e4"][0].n, decoder="minsum",
                               soft_msg_dtype="int8", iterations=ITERS,
                               batch=1024, num_tests=2048, seed=9,
                               code_mode="fixed", max_block_errors=10**9,
                               **fields)
        r_gpu = mc.run_simulation(cfg, reg["n1e4"][0], device="cuda")
        r_cpu = mc.run_simulation(cfg, reg["n1e4"][0], device="cpu")
        for f in fields_eq:
            check(getattr(r_gpu, f) == getattr(r_cpu, f),
                  f"QC int8 {cfg.channel}: cuda and cpu differ in {f}")
        print(f"QC int8 {cfg.channel} run: cuda == cpu, block_errors "
              f"{r_gpu.block_errors} of {r_gpu.num_trials}", flush=True)
    for fam, (codes, erased, rx, got) in peel_cases.items():
        plane = erased.t().to(torch.int32).contiguous()   # trial t: word t
        decode = erasure_bp.bp_decode_packed_allzero if fam == "regular" \
            else erasure_bp.bp_decode_packed_allzero_irregular
        bp = decode(codes, plane, PEEL_N)
        check(torch.equal((bp.known & 1).t() == 0, got.unresolved),
              f"peel ({fam}): a final set differs from BP's fixed point")
        print(f"peel ({fam}): all {len(got.steps)} final sets == the batched "
              f"BP fixed point ({bp.iterations} rounds)", flush=True)
    codes, erased, rx, got = peel_cases["regular"]
    par, rounds = peeling.peel_decode_parallel(codes.select(0), rx[0])
    par_p, rounds_p = peeling.peel_decode_parallel_plain(codes.select(0),
                                                         rx[0])
    check(torch.equal(par, par_p) and rounds == rounds_p
          and torch.equal(par, got.unresolved[0]),
          "the parallel peel differs from its plain version or the peel")
    print(f"parallel peel: {rounds} rounds, == plain == the sequential "
          "peel's final set", flush=True)
    del peel_cases

    # -- 35 -------------------------------------------------------------------
    phase(f"35 the paths: QC int8 min-sum through run_simulation(cfg, "
          f"code=qc) at n={reg['n1e4'][0].n}, B={COLS_SOFT}; a threshold "
          "bracket at n=100,008; the peeling config through cli.main")
    by_path = {}

    def drive(name, code, chunks, cols, **fields):
        """One QC soft run through the engine, the launch counts set to 0
        just before it and read just after; its rounds from the generic
        decoder on the same chunks' LLRs, launched after the read."""
        cfg = SimulationConfig(**{
            "n": code.n, "decoder": "minsum", "soft_msg_dtype": "int8",
            "iterations": ITERS, "batch": cols, "num_tests": chunks * cols,
            "seed": 1, "code_mode": "fixed", "max_block_errors": 10**9,
            **fields})
        for k in kernels.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        res = mc.run_simulation(cfg, code=code, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        by_path[name] = launches_now()
        rates = res.error_rate_per_iteration
        check(res.num_trials == chunks * cols and len(rates) == ITERS + 1
              and all(map(math.isfinite, rates)) and 0.0 < rates[0] < 0.5
              and 0.0 <= res.bit_error_rate <= 0.5,
              f"QC soft path {name}: result malformed")
        e = code.expand()
        generic = soft_bp.soft_bp_decode_irregular \
            if isinstance(code, qc.IrregularQCLDPCCode) else \
            soft_bp.soft_bp_decode
        rounds = 0
        for chunk in range(chunks):
            if cfg.channel == "AWGN":
                llr = channels.awgn_llr(cfg.channel_param, (code.n, cols),
                                        seed=1, offset=chunk, device=dev)
            else:
                llr = channels.BSC(cfg.channel_param).llr_of_flips(
                    bitops.bernoulli_packed(cfg.channel_param,
                                            (code.n, cols // 32), seed=1,
                                            offset=chunk, device=dev))
            rounds += generic(e, llr, ITERS, method="minsum",
                              msg_dtype="int8").iterations
            del llr
        got = by_path[name]
        channel_kernel = "awgn_llr" if cfg.channel == "AWGN" \
            else "bernoulli_packed"
        check(got[names[0]] == rounds + chunks and got[names[1]] == rounds
              and got[channel_kernel] == chunks
              and got["soft_posterior"] == 0 and got["soft_check"] == 0,
              f"QC soft path {name}: launches {got}, expected S1 "
              f"{rounds + chunks}, S2 {rounds} for {rounds} rounds in "
              f"{chunks} chunks")
        lo, hi = wilson(res.block_errors, res.num_trials)
        print(f"QC soft path {name}: {res.num_trials} trials in {run_s:.4f} "
              f"s, {rounds} rounds, FER {res.block_error_rate:.5f} (99% "
              f"[{lo:.5f}, {hi:.5f}]) BER {res.bit_error_rate:.4e}; S1 "
              f"{got[names[0]]}, S2 {got[names[1]]}", flush=True)
        return cfg, res

    cfg, main_res = drive("qc_int8_awgn_n1e4", reg["n1e4"][0], 4, COLS_SOFT,
                          channel="AWGN", channel_param=SIGMA_QC)
    for k in names[:2]:
        measured[k]["launches"] = by_path["qc_int8_awgn_n1e4"][k]
    exp_res = mc.run_simulation(cfg, code=reg["n1e4"][0].expand(),
                                device="cuda")
    for f in fields_eq:
        check(getattr(main_res, f) == getattr(exp_res, f),
              f"QC int8 path: the index run and the expand() run differ in "
              f"{f}")
    print("QC int8 path: counters == the expand() run's", flush=True)
    bsc = drive("qc_int8_bsc_n1e4", reg["n1e4"][0], 2, COLS_SOFT,
                channel="BSC", channel_param=P_SOFT_BSC)[1]
    irr_res = drive("qc_int8_awgn_irregular", irr, 1, COLS_SOFT,
                    channel="AWGN", channel_param=0.75, lam=LAM_BEC,
                    rho=RHO6)[1]
    huge = drive("qc_int8_awgn_n1e6", reg["n1e6"][0], 1, reg["n1e6"][1],
                 channel="AWGN", channel_param=SIGMA_QC)[1]
    bracket = {s: drive(f"qc_int8_awgn_n1e5_sigma{s}", reg["n1e5"][0], 1,
                        reg["n1e5"][1], channel="AWGN", channel_param=s)[1]
               for s in (0.75, 0.90)}
    check(bracket[0.75].block_error_rate <= 0.01
          and bracket[0.90].block_error_rate >= 0.99,
          f"QC int8 n=100,008: FER {bracket[0.75].block_error_rate} / "
          f"{bracket[0.90].block_error_rate} at sigma 0.75 / 0.90 does not "
          f"bracket sigma* = {SIGMA_STAR_INT8}")
    out["qc_soft_paths"] = {
        "fer_ber_awgn_n1e4": [main_res.block_error_rate,
                              main_res.bit_error_rate],
        "fer_ber_bsc_n1e4": [bsc.block_error_rate, bsc.bit_error_rate],
        "fer_ber_irregular_sigma075": [irr_res.block_error_rate,
                                       irr_res.bit_error_rate],
        "fer_ber_n1e6": [huge.block_error_rate, huge.bit_error_rate],
        "fer_n1e5_sigma075_090": [bracket[0.75].block_error_rate,
                                  bracket[0.90].block_error_rate]}
    print(json.dumps({**out, "launches": {
        p: {k: v[k] for k in names[:2] if v[k]} for p, v in by_path.items()},
        "card": smi}), flush=True)
    measured[names[0]]["launches_by_path"] = {
        p: v[names[0]] for p, v in by_path.items()}
    measured[names[1]]["launches_by_path"] = {
        p: v[names[1]] for p, v in by_path.items()}

    tmp = tempfile.mkdtemp(prefix="peel_", dir=scratch_root)
    peel_runs = {}
    for mode in ("fixed", "ensemble"):
        for k in kernels.values():
            k["wrapper"].launches = 0
        peel_runs[mode] = cli_run(tmp, f"peeling_{mode}", n=N_FULL,
                                  decoder="peeling", channel_param=EPS_FULL,
                                  batch=32 * WORDS_FULL,
                                  num_tests=2 * 32 * WORDS_FULL,
                                  code_mode=mode, seed=3)
        used = launches_now()
        check(peel_runs[mode].num_trials == 2 * 32 * WORDS_FULL
              and peel_runs[mode].error_rate_per_iteration == []
              and used["erasure_decode"] == 2
              and used["check_exactly_one"] == 0 and used[names[2]] == 0
              and used["bernoulli_packed"] == 2
              and used["sample_regular_codes"] == (2 if mode == "ensemble"
                                                   else 0),
              f"peeling {mode}: launches {used}")
        print(f"peeling {mode} through cli.main: FER "
              f"{peel_runs[mode].block_error_rate:.5f} BER "
              f"{peel_runs[mode].bit_error_rate:.4e}", flush=True)
    bp_run = cli_run(tmp, "bp_n_rounds", n=N_FULL, channel_param=EPS_FULL,
                     batch=32 * WORDS_FULL, num_tests=2 * 32 * WORDS_FULL,
                     iterations=N_FULL, seed=3)
    for f in ("block_errors", "bit_errors", "bit_errors_sq", "num_trials"):
        check(getattr(peel_runs["fixed"], f) == getattr(bp_run, f),
              f"peeling fixed: {f} differs from the bp run with n rounds")
    print("peeling fixed: counters == the bp run with iterations = n",
          flush=True)
    out["peeling_paths"] = {m: [r.block_error_rate, r.bit_error_rate]
                            for m, r in peel_runs.items()}

    # -- 36 -------------------------------------------------------------------
    phase(f"36 the R-process experiment at n={PEEL_N}, eps={PEEL_EPS}")
    anchor = wilson(10, 400)
    exp = {}
    for repeats in (PEEL_REPEATS, PEEL_REPEATS_BIG):
        for k in kernels.values():
            k["wrapper"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = experiments.peeling_scaling_experiment(
            PEEL_N, DV, DC, PEEL_EPS, repeats=repeats, seed=1, device=dev)
        wall = time.perf_counter() - t0
        used = launches_now()
        lo, hi = wilson(res.failure_rate * repeats, repeats)
        cond = float(res.critical_distribution.mean())
        check(used[names[2]] == 1 and lo <= anchor[1] and anchor[0] <= hi,
              f"experiment ({repeats}): failure rate {res.failure_rate} (99% "
              f"[{lo}, {hi}]) against {anchor}; P1 launches "
              f"{used[names[2]]}")
        check(abs(cond - 154.0) <= 15.4,
              f"experiment ({repeats}): conditioned critical mean {cond}")
        exp[repeats] = dict(wall_s=wall, failure_rate=res.failure_rate,
                            failure_99=[lo, hi],
                            critical_point=res.critical_point,
                            conditioned_critical_mean=cond,
                            expected_at_critical=res.expected_at_critical,
                            sd_at_critical=math.sqrt(
                                res.variance_at_critical))
        if repeats == PEEL_REPEATS:
            measured[names[2]]["launches"] = used[names[2]]
        print(f"experiment, {repeats} repeats: {json.dumps(exp[repeats])}",
              flush=True)
    res = experiments.peeling_scaling_experiment(
        PEEL_N, 0, 0, PEEL_EPS, repeats=PEEL_REPEATS, seed=2, lam=LAM_BEC,
        rho=RHO6, device=dev)
    u0 = int(0.9 * PEEL_N * PEEL_EPS)
    vals = [t[u0] for t in res.trajectories
            if len(t) > u0 and not math.isnan(t[u0])]
    mean = sum(vals) / len(vals)
    se = math.sqrt(sum((v - mean) ** 2 for v in vals) / (len(vals) - 1)
                   / len(vals))
    check(abs(mean - res.drift[u0]) < 4 * se + 0.02 * res.drift[u0],
          f"irregular experiment: mean R {mean} at step {u0} against the "
          f"drift {res.drift[u0]} (se {se})")
    exp["irregular"] = dict(failure_rate=res.failure_rate, mean_at_90=mean,
                            drift_at_90=float(res.drift[u0]), se=se)
    print(f"irregular experiment: {json.dumps(exp['irregular'])}",
          flush=True)
    out["experiment"] = exp

    # -- 37 -------------------------------------------------------------------
    phase("37 timing: circulant index against gather (kernels B/C on "
          "expand()) for int8 min-sum and f32 sum-product; the n ~ 1e6 "
          "int8 chunk")
    timing = {}
    for label, (code, cols) in reg.items():
        e = code.expand()
        llr = channels.awgn_llr(SIGMA_QC, (code.n, cols), seed=11,
                                device=dev)
        row = {"n": code.n, "B": cols}
        for dec, kw in (("int8_minsum", dict(method="minsum",
                                             msg_dtype="int8")),
                        ("f32_sumproduct", dict(method="sumproduct"))):
            runs = {"gather": lambda: soft_bp.soft_bp_decode(e, llr, ITERS,
                                                             **kw),
                    "index": lambda: qc_soft_bp.qc_soft_bp_decode(
                        code, llr, ITERS, **kw)}
            ms = {}
            for way in ("gather", "index", "index", "gather"):
                ms.setdefault(way, []).append(time_ms(
                    runs[way], reps=1, warmup=way not in ms))
            rounds = runs["index"]().iterations
            mean = {k: sum(v) / len(v) for k, v in ms.items()}
            row[dec] = dict(decode_ms=ms, rounds=rounds,
                            index_over_gather=mean["gather"] / mean["index"],
                            info_bits_per_s_index=code.k * cols
                            / (mean["index"] / 1e3))
            print(f"{label} {dec}: gather {ms['gather']} ms, index "
                  f"{ms['index']} ms, {rounds} rounds", flush=True)
        timing[label] = row
        del llr, e
        torch.cuda.empty_cache()
    out["index_against_gather"] = timing
    print(json.dumps({"qc_soft_index_against_gather": timing,
                      "sigma": SIGMA_QC, "iterations": ITERS, "card": smi}),
          flush=True)
    code6, cols6 = reg["n1e6"]
    cfg6 = SimulationConfig(n=code6.n, channel="AWGN", decoder="minsum",
                            soft_msg_dtype="int8", channel_param=SIGMA_QC,
                            iterations=ITERS, batch=cols6, seed=1,
                            code_mode="fixed")
    chunk6 = mc.make_chunk_fn(cfg6, code6, device=dev)
    int(chunk6(9).block_errors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in range(2):
        int(chunk6(idx).block_errors)
    torch.cuda.synchronize()
    chunk6_ms = (time.perf_counter() - t0) / 2 * 1e3
    out["chunk_n1e6_int8_ms"] = chunk6_ms
    print(f"QC int8 soft chunk at n={code6.n}, B={cols6}: {chunk6_ms:.3f} "
          f"ms, {cols6 / chunk6_ms * 1e3:.4e} trials/s; card {smi}",
          flush=True)
    print(device_time_breakdown(lambda: int(chunk6(5).block_errors),
                                chunk6_ms, kernels), flush=True)
    return out


def _edge_rank_worker(rank: int, port: int, outdir: str, chk_to_var,
                      n_edge: int, n_batch: int) -> None:
    """Phase 41: one of two ranks on card 0 over gloo.  Decodes the n =
    10^5 edge-sharded BEC batch and runs the batch-sharded fixed-BEC
    engine, and saves what it got for the parent to compare."""
    import torch

    from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
    from iib_project_ldpc_codes_tpu_torch.models.ensemble import (
        code_for_config)
    from iib_project_ldpc_codes_tpu_torch.ops import bitops
    from iib_project_ldpc_codes_tpu_torch.parallel import distributed
    from iib_project_ldpc_codes_tpu_torch.parallel.edge_sharded import (
        edge_sharded_bp_decode)
    from iib_project_ldpc_codes_tpu_torch.parallel.montecarlo import (
        run_simulation)

    dev = torch.device("cuda", 0)
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, device=dev,
                           backend="gloo", timeout_s=300)
    try:
        group = distributed.global_group()
        code = code_from_numpy(chk_to_var, n_edge, DV, DC, device=dev)
        erased = bitops.bernoulli_packed(EPS_FULL, (n_edge, W_EDGE), seed=41,
                                         device=dev)
        res = edge_sharded_bp_decode(code, erased, ITERS, group)
        cfg = _edge_batch_cfg(n_batch)
        run = run_simulation(cfg, code_for_config(cfg), device=dev,
                             group=group)
        torch.save({"known": res.known.cpu(),
                    "error_totals": res.error_totals.cpu(),
                    "iterations": res.iterations,
                    "run": [getattr(run, f) for f in EDGE_RUN_FIELDS]},
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _edge_batch_cfg(n: int):
    from iib_project_ldpc_codes_tpu_torch.utils.config import (
        SimulationConfig)

    return SimulationConfig(channel_param=EPS_FULL, n=n, dv=DV, dc=DC,
                            iterations=ITERS, batch=32 * WORDS_FULL,
                            num_tests=2 * 32 * WORDS_FULL, seed=1,
                            code_mode="fixed", max_block_errors=10**9)


def edge_paths(dev, smi, measured, kernels, scratch_root) -> None:
    """Phases 38-41: edge-sharded erasure BP at n = 10^6 (BASELINE.json
    config 5) and batch sharding over a process group (module docstring).
    K2 on every shard, X1 and X2 are held to their plain versions exactly
    (bitwise arithmetic), their launched width checked; whole decodes to
    the K2/K3 decode bit for bit."""
    import torch
    import torch.multiprocessing as mp

    from iib_project_ldpc_codes_tpu_torch import cli
    from iib_project_ldpc_codes_tpu_torch.models.ensemble import (
        code_for_config)
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
    from iib_project_ldpc_codes_tpu_torch.parallel import dryrun
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es
    from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
    from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu_torch.utils.results import load_result

    x1, x2 = measured["edge_candidates"], measured["or_reduce_update"]

    def launches_now():
        return {k: v["wrapper"].launches for k, v in kernels.items()}

    def edge_cfg(**kw):
        return SimulationConfig(**{
            "channel_param": EPS_FULL, "n": N_EDGE, "dv": DV, "dc": DC,
            "iterations": ITERS, "batch": 32 * W_EDGE,
            "num_tests": 2 * 32 * W_EDGE, "seed": 1, "code_mode": "fixed",
            "code_number": 1, "max_block_errors": 10**9, **kw})

    # -- 38 -------------------------------------------------------------------
    phase(f"38 K2 on each shard, X1 and X2 against their plain versions at "
          f"n={N_EDGE}, W={W_EDGE}, every shard of D in {EDGE_SIZES}")
    t0 = time.perf_counter()
    code_host = code_for_config(edge_cfg())
    sample_s = time.perf_counter() - t0
    code = code_host.to(dev)
    print(f"the n={N_EDGE} (3,6) code (code_for_config, repair, host): "
          f"{sample_s:.2f} s", flush=True)
    erased = bitops.bernoulli_packed(EPS_FULL, (N_EDGE, W_EDGE), seed=38,
                                     device=dev)
    # the decode's planes at this shape take 16 bytes a thread (a fall to 4
    # bytes fails below)
    vec = erasure_bp.check_exactly_one_vector(W_EDGE, 16)
    check(vec == 4, f"check_exactly_one_vector at W={W_EDGE}: {vec}, "
          "expected 4")
    # a state two rounds in, as the decode meets it
    known = erasure_bp.bp_decode_packed_allzero(code, erased, 2).known
    ex_full = erasure_bp.check_exactly_one(code.chk_to_var, known)
    k3_known = known.clone()
    k3_errors = torch.zeros(2, dtype=torch.int32, device=dev)
    erasure_bp.variable_or_update(code.var_to_chk, ex_full, k3_known,
                                  k3_errors, 1)
    k2, err0 = measured["check_exactly_one"], 0
    err1 = err2 = 0
    ms1, ms2, bound1, bound2 = {}, {}, {}, {}
    dev1, ms0, dev0, bound0 = {}, {}, {}, {}
    open_words = int((known != -1).sum())     # words X2 reads candidates of
    for size in EDGE_SIZES:
        m_local = code.m // size
        cands = []
        for r in range(size):
            off = r * m_local
            chk_local = code.chk_to_var[off:off + m_local]
            ex = erasure_bp.check_exactly_one(chk_local, known)
            check(erasure_bp.check_exactly_one.vec == vec,
                  "K2 on the shard launched "
                  f"{erasure_bp.check_exactly_one.vec} words a thread")
            err0 = max(err0, max_abs_err(ex, erasure_bp
                                         ._check_exactly_one_plain(
                                             chk_local, known)))
            check(err0 == 0, f"K2 (D={size}, shard {r}) differs from its "
                             f"plain version (max |d| {err0})")
            check(torch.equal(ex, ex_full[off:off + m_local]),
                  f"K2 on rows {off}.. differs from the whole summary")
            got = es.edge_candidates(code.var_to_chk, ex, off)
            check(es.edge_candidates.vec == vec,
                  f"X1 launched {es.edge_candidates.vec} words a thread")
            want = es._edge_candidates_plain(code.var_to_chk, ex, off)
            err1 = max(err1, max_abs_err(got, want))
            check(err1 == 0, f"X1 (D={size}, shard {r}) differs from its "
                             f"plain version (max |d| {err1})")
            cands.append(got)
            if r == 0:
                def run_k2(c=chk_local):
                    return erasure_bp.check_exactly_one(c, known)

                def run_x1(e=ex, o=off):
                    return es.edge_candidates(code.var_to_chk, e, o)

                ms0[size] = time_ms(run_k2)
                dev0[size] = device_ms(run_k2, "check_exactly_one_kernel")
                # the shard's table, the rows of known its checks touch,
                # the summary written
                touched = int(torch.unique(chk_local).numel())
                bound0[size] = bound(nbytes(chk_local, ex)
                                     + touched * W_EDGE * 4)
                ms1[size] = time_ms(run_x1)
                dev1[size] = device_ms(run_x1, "edge_candidates_kernel")
                bound1[size] = bound(nbytes(code.var_to_chk, ex, got))
                if size == 1:
                    x1["plain_ms"] = time_ms(
                        lambda: es._edge_candidates_plain(
                            code.var_to_chk, ex, off), reps=2)
        gathered = torch.stack(cands)
        del cands
        state, errors = known.clone(), torch.zeros(2, dtype=torch.int32,
                                                   device=dev)
        es.or_reduce_update(gathered, state, errors, 1)
        p_state, p_errors = known.clone(), torch.zeros_like(errors)
        es._or_reduce_update_plain(gathered, p_state, p_errors, 1)
        err2 = max(err2, max_abs_err(state, p_state),
                   max_abs_err(errors, p_errors))
        check(err2 == 0, f"X2 (D={size}) differs from its plain version "
                         f"(max |d| {err2})")
        check(torch.equal(state, k3_known) and torch.equal(errors, k3_errors),
              f"the D={size} round (K2 on shards, X1, X2) differs from the "
              "K2/K3 round")
        fresh = {}

        def prepare():
            fresh["known"] = known.clone()
            fresh["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

        ms2[size] = time_ms(lambda: es.or_reduce_update(
            gathered, fresh["known"], fresh["errors"], 1), prepare=prepare)
        # the candidates of the words not yet all known, known read and
        # written, the count
        bound2[size] = bound(size * open_words * 4 + 2 * nbytes(known) + 4)
        if size == 1:
            x2["plain_ms"] = time_ms(lambda: es._or_reduce_update_plain(
                gathered, fresh["known"], fresh["errors"], 1),
                prepare=prepare, reps=2)
        del gathered
        print(f"D={size}: K2 on shard 0 {ms0[size]:.4f} ms, device "
              f"{dev0[size]:.4f} (bound {bound0[size]['bound_ms']:.4f}); X1 "
              f"{ms1[size]:.4f} ms, device {dev1[size]:.4f} (bound "
              f"{bound1[size]['bound_ms']:.4f}); X2 {ms2[size]:.4f} ms "
              f"(bound {bound2[size]['bound_ms']:.4f}); {vec} words a thread; "
              "equal to plain and to the K2/K3 round", flush=True)
    k2.update(edge_max_abs_err=err0, edge_ms_by_ranks=ms0,
              edge_device_ms_by_ranks=dev0,
              edge_bound_ms_by_ranks={k: v["bound_ms"]
                                      for k, v in bound0.items()},
              edge_vec=vec)
    x1.update(max_abs_err=err1, ms=ms1[1], **bound1[1], library_ms=None,
              device_ms=dev1[1], ms_by_ranks=ms1, device_ms_by_ranks=dev1,
              bound_ms_by_ranks={k: v["bound_ms"] for k, v in bound1.items()},
              vec=vec)
    x2.update(max_abs_err=err2, ms=ms2[1], **bound2[1], library_ms=None,
              ms_by_ranks=ms2,
              bound_ms_by_ranks={k: v["bound_ms"] for k, v in bound2.items()})
    print(f"X1 plain {x1['plain_ms']:.3f} ms, X2 plain {x2['plain_ms']:.3f} "
          f"ms at D=1; card {smi}", flush=True)

    # -- 39 -------------------------------------------------------------------
    phase(f"39 K3 and the K2/K3 decode at n={N_EDGE} against their plain "
          f"versions; the whole edge-sharded decode against the K2/K3 "
          f"decode; cuda against cpu at n={N_EDGE_CPU}")
    # K3 on the state two rounds in, 16 bytes a thread and, on a plane 4
    # bytes past a 16-byte boundary, 4 bytes; its device time beside its
    # bound
    # (its table, the summary and known read once, known written once)
    k3 = measured["variable_or_update"]
    check(erasure_bp.variable_or_update.vec == vec,
          f"K3 at n={N_EDGE} launched {erasure_bp.variable_or_update.vec} "
          "words a thread")
    p_known, p_errors = known.clone(), torch.zeros(2, dtype=torch.int32,
                                                   device=dev)
    erasure_bp._variable_or_update_plain(code.var_to_chk, ex_full, p_known,
                                         p_errors, 1)
    shifted = torch.empty(known.numel() + 1, dtype=torch.int32,
                          device=dev)[1:].view(known.shape).copy_(known)
    s_errors = torch.zeros(2, dtype=torch.int32, device=dev)
    erasure_bp.variable_or_update(code.var_to_chk, ex_full, shifted,
                                  s_errors, 1)
    check(erasure_bp.variable_or_update.vec == 1,
          "K3 on a misaligned plane launched "
          f"{erasure_bp.variable_or_update.vec} words a thread")
    err3 = max(max_abs_err(k3_known, p_known), max_abs_err(k3_errors,
                                                            p_errors),
               max_abs_err(shifted, p_known), max_abs_err(s_errors,
                                                           p_errors))
    check(err3 == 0, f"K3 at n={N_EDGE} differs from its plain version "
                     f"(max |d| {err3})")
    del shifted, p_known
    fresh3 = {}

    def prepare3():
        fresh3["known"] = known.clone()
        fresh3["errors"] = torch.zeros(2, dtype=torch.int32, device=dev)

    def run_k3():
        erasure_bp.variable_or_update(code.var_to_chk, ex_full,
                                      fresh3["known"], fresh3["errors"], 1)

    k3.update(max_abs_err=max(k3["max_abs_err"], err3),
              device_ms_n1e6=device_ms(run_k3, "variable_or_update_kernel",
                                       prepare=prepare3),
              ms_n1e6=time_ms(run_k3, prepare=prepare3),
              bound_ms_n1e6=bound(nbytes(code.var_to_chk, ex_full)
                                  + 2 * nbytes(known) + 4)["bound_ms"],
              vec_n1e6=vec)
    print(f"K3 at n={N_EDGE}, W={W_EDGE}, two rounds in: equal to plain at "
          f"{vec} and 1 words a thread; device {k3['device_ms_n1e6']:.4f} "
          f"ms, events {k3['ms_n1e6']:.4f} ms, bound "
          f"{k3['bound_ms_n1e6']:.4f} ms", flush=True)
    del known, ex_full, k3_known, fresh3
    for k in kernels.values():
        k["wrapper"].launches = 0
    got = es.edge_sharded_bp_decode(code, erased, ITERS)
    torch.cuda.synchronize()
    counts = launches_now()
    want = erasure_bp.bp_decode_packed_allzero(code, erased, ITERS)
    plain = erasure_bp.bp_decode_packed_allzero_plain(code, erased, ITERS)
    check(torch.equal(want.known, plain.known)
          and torch.equal(want.error_totals, plain.error_totals)
          and want.iterations == plain.iterations,
          "the K2/K3 decode differs from the plain decode")
    del plain
    check(torch.equal(got.known, want.known)
          and torch.equal(got.error_totals, want.error_totals)
          and got.iterations == want.iterations,
          "the edge-sharded decode differs from the K2/K3 decode")
    rounds = got.iterations
    check(counts["check_exactly_one"] == counts["edge_candidates"]
          == counts["or_reduce_update"] == rounds
          and counts["variable_or_update"] == 0
          and counts["per_trial_counts"] == 1,
          f"edge decode launches {counts} for {rounds} rounds")
    check(erasure_bp.check_exactly_one.vec == es.edge_candidates.vec == vec,
          f"the edge decode launched K2 {erasure_bp.check_exactly_one.vec}, "
          f"X1 {es.edge_candidates.vec} words a thread, expected {vec}")
    print(f"n={N_EDGE}, W={W_EDGE}: equal to the K2/K3 decode, {rounds} "
          f"rounds, final erasures {int(got.error_totals[-1])}; launches K2 "
          f"{counts['check_exactly_one']}, X1 {counts['edge_candidates']}, "
          f"X2 {counts['or_reduce_update']}", flush=True)
    small_cfg = edge_cfg(n=N_EDGE_CPU)
    small = code_for_config(small_cfg)
    small_erased = bitops.bernoulli_packed(EPS_FULL, (N_EDGE_CPU, W_EDGE),
                                           seed=41, device="cpu")
    on_gpu = es.edge_sharded_bp_decode(small.to(dev), small_erased.to(dev),
                                       ITERS)
    on_cpu = es.edge_sharded_bp_decode(small, small_erased, ITERS)
    check(torch.equal(on_gpu.known.cpu(), on_cpu.known)
          and torch.equal(on_gpu.error_totals.cpu(), on_cpu.error_totals)
          and on_gpu.iterations == on_cpu.iterations,
          f"the n={N_EDGE_CPU} edge decode differs between cuda and cpu")
    print(f"n={N_EDGE_CPU}: cuda == cpu ({on_cpu.iterations} rounds)",
          flush=True)

    # -- 40 -------------------------------------------------------------------
    phase(f"40 the edge-sharded path: cli.main --edge-sharded and "
          f"run_simulation at n={N_EDGE}, batch {32 * W_EDGE}, 2 chunks")
    fields = ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
              "excluded_trials", "error_counts_per_iteration", "stopped_by")
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        cfg_path = os.path.join(tmp, "edge.json")
        with open(cfg_path, "w") as f:
            f.write(edge_cfg().to_json())
        out_dir = os.path.join(tmp, "edge")
        for k in kernels.values():
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--config", cfg_path, "--edge-sharded", "--devices=1",
                       f"--output-dir={out_dir}", "--device=cuda"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        path_counts = launches_now()
        check(rc == 0, f"cli.main --edge-sharded returned {rc}")
        (name,) = os.listdir(out_dir)
        via_cli = load_result(os.path.join(out_dir, name))
    check(via_cli.config.edge_sharded, "the CLI result is not edge-sharded")
    path_rounds = sum(erasure_bp.bp_decode_packed_allzero(
        code, bitops.bernoulli_packed(EPS_FULL, (N_EDGE, W_EDGE), seed=1,
                                      offset=c, device=dev), ITERS).iterations
                      for c in range(2))
    for name in ("edge_candidates", "or_reduce_update"):
        measured[name]["launches"] = path_counts[name]
    measured["check_exactly_one"]["launches_edge_path"] = \
        path_counts["check_exactly_one"]
    check(path_counts["check_exactly_one"] == path_counts["edge_candidates"]
          == path_counts["or_reduce_update"] == path_rounds > 0
          and path_counts["variable_or_update"] == 0
          and path_counts["bernoulli_packed"] == 2,
          f"edge path launches {path_counts} for {path_rounds} rounds")
    edge_run = mc.run_simulation(edge_cfg(edge_sharded=True), code,
                                 device="cuda")
    # the unsharded fixed-code run at n = 10^6: a word does not fit kernel
    # D's block, so K2 and K3 run every round (their launches on a path)
    for k in kernels.values():
        k["wrapper"].launches = 0
    plain_run = mc.run_simulation(edge_cfg(), code, device="cuda")
    torch.cuda.synchronize()
    fixed_counts = launches_now()
    check(fixed_counts["check_exactly_one"]
          == fixed_counts["variable_or_update"] == path_rounds > 0
          and fixed_counts["erasure_decode"] == 0,
          f"the n={N_EDGE} fixed run launched {fixed_counts} for "
          f"{path_rounds} rounds")
    for name in ROUND_PAIR:
        measured[name]["launches"] = fixed_counts[name]
    for field in fields:
        check(getattr(via_cli, field) == getattr(edge_run, field)
              == getattr(plain_run, field),
              f"edge path {field}: cli {getattr(via_cli, field)}, "
              f"run_simulation {getattr(edge_run, field)}, unsharded "
              f"{getattr(plain_run, field)}")
    print(f"cli.main --edge-sharded: {via_cli.num_trials} trials in "
          f"{cli_s:.2f} s (code sampling included), FER "
          f"{via_cli.block_error_rate:.5f} BER {via_cli.bit_error_rate:.3e}; "
          f"equal to run_simulation edge-sharded and unsharded; launches K2 "
          f"{path_counts['check_exactly_one']}, X1 "
          f"{path_counts['edge_candidates']}, X2 "
          f"{path_counts['or_reduce_update']} = {path_rounds} rounds",
          flush=True)
    bracket = {eps: mc.run_simulation(edge_cfg(
        edge_sharded=True, channel_param=eps, num_tests=32 * W_EDGE), code,
        device="cuda") for eps in (0.42, 0.44)}
    check(bracket[0.42].block_error_rate <= 0.01
          and bracket[0.44].block_error_rate >= 0.99,
          f"FER {bracket[0.42].block_error_rate} / "
          f"{bracket[0.44].block_error_rate} at eps 0.42 / 0.44 does not "
          "bracket eps*(3,6) = 0.4294")
    decode_ms = {}
    runs = {"unsharded": lambda: erasure_bp.bp_decode_packed_allzero(
                code, erased, ITERS),
            "edge": lambda: es.edge_sharded_bp_decode(code, erased, ITERS)}
    for way in ("unsharded", "edge", "edge", "unsharded"):
        decode_ms.setdefault(way, []).append(time_ms(runs[way], reps=3))
    k_bits = (N_EDGE - code.m) * 32 * W_EDGE
    rates = {k: k_bits / (sum(v) / len(v) / 1e3) for k, v in decode_ms.items()}
    # the edge decode's device time by kernel (K2, X1, X2, K4)
    print(device_time_breakdown(lambda: runs["edge"]().iterations,
                                sum(decode_ms["edge"]) / 2, kernels),
          flush=True)
    chunk = mc.make_edge_sharded_chunk_fn(edge_cfg(edge_sharded=True), code,
                                          device=dev)
    int(chunk(9).block_errors)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in range(2):
        int(chunk(idx).block_errors)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) / 2 * 1e3
    print(device_time_breakdown(lambda: int(chunk(5).block_errors), chunk_ms,
                                kernels), flush=True)
    print(json.dumps({"edge_path": {
        "n": N_EDGE, "words": W_EDGE, "iterations": ITERS, "rounds": rounds,
        "fer_eps042": bracket[0.42].block_error_rate,
        "fer_eps044": bracket[0.44].block_error_rate,
        "path_fer_eps042": via_cli.block_error_rate,
        "code_sampling_s": sample_s, "decode_ms": decode_ms,
        "info_bits_per_s": rates, "chunk_ms": chunk_ms,
        "chunk_trials_per_s": 32 * W_EDGE / chunk_ms * 1e3,
        "edge_over_unsharded": rates["edge"] / rates["unsharded"]},
        "card": smi}), flush=True)

    # -- 41 -------------------------------------------------------------------
    phase("41 two ranks on the one card over gloo: the edge decode at "
          f"n={N_EDGE_CPU}, a batch-sharded run, the dry run")
    alone = es.edge_sharded_bp_decode(
        small.to(dev), bitops.bernoulli_packed(
            EPS_FULL, (N_EDGE_CPU, W_EDGE), seed=41, device=dev), ITERS)
    with tempfile.TemporaryDirectory(dir=scratch_root) as tmp:
        t0 = time.perf_counter()
        mp.spawn(_edge_rank_worker,
                 args=(dryrun.free_port(), tmp, small.chk_to_var.numpy(),
                       N_EDGE_CPU, N_FULL), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]
    for r, o in enumerate(outs):
        check(torch.equal(o["known"], alone.known.cpu())
              and torch.equal(o["error_totals"], alone.error_totals.cpu())
              and o["iterations"] == alone.iterations,
              f"rank {r}'s 2-rank edge decode differs from world size 1")
    cfg = _edge_batch_cfg(N_FULL)
    fixed = code_for_config(cfg).to(dev)
    sums = None
    for c in range(2):
        for r in range(2):
            s = mc.make_chunk_fn(cfg, fixed, device=dev, rank=r, size=2)(c)
            row = [int(s.block_errors), int(s.bit_errors),
                   float(s.bit_errors_sq), *s.error_totals.tolist()]
            sums = row if sums is None else [a + b for a, b in zip(sums, row)]
    for r, o in enumerate(outs):
        got = o["run"]
        check(got[0] == cfg.num_tests and [got[1], got[2], got[3],
                                           *got[4]] == sums,
              f"rank {r}'s batch-sharded run {got[:4]} differs from the "
              f"per-rank sum {sums[:3]}")
    proc = subprocess.run(
        [sys.executable, "-m", "iib_project_ldpc_codes_tpu_torch.parallel."
         "dryrun", "2"], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0 and "dryrun(2) ok" in proc.stdout,
          f"the dry run failed ({proc.returncode}): {proc.stderr[-2000:]}")
    print(f"2 ranks on cuda:0 (gloo): the edge decode equals world size 1, "
          f"the batch-sharded run equals the per-rank sum (spawn and both "
          f"{spawn_s:.1f} s); {proc.stdout.strip().splitlines()[-1]}",
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
    from iib_project_ldpc_codes_tpu_torch.models import (encode, ensemble,
                                                         irregular)
    from iib_project_ldpc_codes_tpu_torch.models.code import validate_code
    from iib_project_ldpc_codes_tpu_torch.models.ensemble import (
        code_for_config)
    from iib_project_ldpc_codes_tpu_torch.ops import (bitops, channels,
                                                      erasure_bp, gallager,
                                                      peeling, qc_bp,
                                                      qc_gallager, qc_soft_bp,
                                                      soft_bp)
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded
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
        "erasure_decode": dict(
            wrapper=erasure_bp.erasure_decode,
            source="iib_project_ldpc_codes_tpu_torch/csrc/erasure_decode.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/erasure_bp.py:292"),
        "erasure_decode_values": dict(
            wrapper=erasure_bp.erasure_decode_values,
            source="iib_project_ldpc_codes_tpu_torch/csrc/erasure_decode.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/erasure_bp.py:239"),
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
        "gallager_decode": dict(
            wrapper=gallager.gallager_decode,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "gallager_decode.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/gallager.py:238"),
        "awgn_llr": dict(
            wrapper=channels.awgn_llr,
            source="iib_project_ldpc_codes_tpu_torch/csrc/awgn_llr.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/channels.py:86"),
        "soft_posterior": dict(
            wrapper=soft_bp.soft_posterior,
            source="iib_project_ldpc_codes_tpu_torch/csrc/soft_posterior.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/soft_bp.py:166"),
        "soft_check": dict(
            wrapper=soft_bp.soft_check,
            source="iib_project_ldpc_codes_tpu_torch/csrc/soft_check.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/soft_bp.py:174"),
        "encode_packed": dict(
            wrapper=encode.encode_packed,
            source="iib_project_ldpc_codes_tpu_torch/csrc/encode_packed.cu",
            replaces="iib_project_ldpc_codes_tpu/models/encode.py:110"),
        "check_exactly_one_xor": dict(
            wrapper=erasure_bp.check_exactly_one_xor,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "check_exactly_one.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/erasure_bp.py:239"),
        "variable_or_adopt": dict(
            wrapper=erasure_bp.variable_or_adopt,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "variable_or_update.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/erasure_bp.py:239"),
        "qc_check_exactly_one": dict(
            wrapper=qc_bp.qc_check_exactly_one,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "qc_check_exactly_one.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/qc_bp.py:64"),
        "qc_variable_or": dict(
            wrapper=qc_bp.qc_variable_or,
            source="iib_project_ldpc_codes_tpu_torch/csrc/qc_variable_or.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/qc_bp.py:90"),
        "qc_gallager_check": dict(
            wrapper=qc_gallager.qc_gallager_check,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "qc_gallager_check.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/qc_gallager.py:33"),
        "qc_gallager_variable": dict(
            wrapper=qc_gallager.qc_gallager_variable,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "qc_gallager_variable.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/qc_gallager.py:33"),
        "qc_soft_posterior": dict(
            wrapper=qc_soft_bp.qc_soft_posterior,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "qc_soft_posterior.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/qc_soft_bp.py:61"),
        "qc_soft_check": dict(
            wrapper=qc_soft_bp.qc_soft_check,
            source="iib_project_ldpc_codes_tpu_torch/csrc/qc_soft_check.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/qc_soft_bp.py:72"),
        "peel_sequential": dict(
            wrapper=peeling.peel_sequential,
            source="iib_project_ldpc_codes_tpu_torch/csrc/peel_sequential.cu",
            replaces="iib_project_ldpc_codes_tpu/ops/peeling.py:68"),
        "edge_candidates": dict(
            wrapper=edge_sharded.edge_candidates,
            source="iib_project_ldpc_codes_tpu_torch/csrc/edge_candidates.cu",
            replaces="iib_project_ldpc_codes_tpu/parallel/edge_sharded.py:44"),
        "or_reduce_update": dict(
            wrapper=edge_sharded.or_reduce_update,
            source="iib_project_ldpc_codes_tpu_torch/csrc/"
                   "or_reduce_update.cu",
            replaces="iib_project_ldpc_codes_tpu/parallel/edge_sharded.py:38"),
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
            thr, shape, key, offset, dev), reps=2),
        **bound(nbytes(erased), erased.numel() * 8 * PHILOX_OPS,
                INT32_OPS_S))
    print(f"K1 equal to plain at {shape}; erased fraction {frac:.6f} "
          f"(sigma {sigma:.2e})", flush=True)

    # -- 4 K2/K3/K4 ---------------------------------------------------------
    phase("4 K2/K3/K4 single passes, the K2/K3 decode and kernel D's at the "
          "headline shape")
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
    check(erasure_bp.check_exactly_one.vec == 4,
          "K2 at the fixed path launched "
          f"{erasure_bp.check_exactly_one.vec} words a thread, expected 4")
    # device_ms: the kernel alone (torch.profiler), without the wrapper's
    # host work that the events around one launch (ms) include
    measured["check_exactly_one"].update(
        max_abs_err=err,
        ms=time_ms(lambda: erasure_bp.check_exactly_one(code.chk_to_var,
                                                        known0)),
        device_ms=device_ms(lambda: erasure_bp.check_exactly_one(
            code.chk_to_var, known0), "check_exactly_one_kernel"),
        plain_ms=time_ms(lambda: erasure_bp._check_exactly_one_plain(
            code.chk_to_var, known0)),
        **bound(nbytes(code.chk_to_var, known0, ex_k)))
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
    check(erasure_bp.variable_or_update.vec == 4,
          "K3 at the fixed path launched "
          f"{erasure_bp.variable_or_update.vec} words a thread, expected 4")
    measured["variable_or_update"].update(
        max_abs_err=err,
        ms=time_ms(lambda: erasure_bp.variable_or_update(
            code.var_to_chk, ex_k, state["known"], state["errors"], 1),
            prepare=fresh),
        device_ms=device_ms(lambda: erasure_bp.variable_or_update(
            code.var_to_chk, ex_k, state["known"], state["errors"], 1),
            "variable_or_update_kernel", prepare=fresh),
        plain_ms=time_ms(lambda: erasure_bp._variable_or_update_plain(
            code.var_to_chk, ex_k, state["known"], state["errors"], 1),
            prepare=fresh),
        **bound(nbytes(code.var_to_chk, ex_k, known0, known0,
                       state["errors"])))
    c_k = bitops.per_trial_counts(erased)
    c_p = bitops._per_trial_counts_plain(erased)
    err = max_abs_err(c_k, c_p)
    check(err == 0, f"K4 differs from its plain version (max |d| {err})")
    check(k4_exact_on_path_planes(dev, erased),
          "K4 differs from its plain version on a path's plane")
    # the bound counts the operations the function needs (a bit-sliced
    # counter, vertical_count_ops); beside it, the integer instructions
    # this kernel spends a word: a trip of its innermost row loop over the
    # words it loads, in its SASS
    sass_k4 = sass_loop_counts("per_trial_counts_kernel", innermost=True)
    sass_k4.pop("span")
    k4_ops = vertical_count_ops(*erased.shape)
    measured["per_trial_counts"].update(
        max_abs_err=err,
        ms=time_ms(lambda: bitops.per_trial_counts(erased)),
        device_ms=device_ms(lambda: bitops.per_trial_counts(erased),
                            "per_trial_counts_kernel"),
        plain_ms=time_ms(lambda: bitops._per_trial_counts_plain(erased)),
        sass=sass_k4, ops=k4_ops,
        kernel_ops_ms=erased.numel() * sass_k4["int_alu"] / sass_k4["loads"]
        / INT32_OPS_S * 1e3,
        **bound(nbytes(erased, c_k), k4_ops, INT32_OPS_S))
    row = measured["per_trial_counts"]
    print(f"K4: {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {k4_ops} integer "
          f"operations needed); this kernel's {sass_k4['int_alu']} integer "
          f"instructions a loop trip of {sass_k4['loads']} words take "
          f"{row['kernel_ops_ms']:.4f} ms at the issue rate", flush=True)
    # whole decodes: kernel D (one block a word, the route of one code
    # whose word fits a block), the K2/K3 host loop and the plain one
    check(erasure_bp.erasure_decode_block_words(code, WORDS_FULL) == 1,
          "the headline decode does not take kernel D a block a word")
    launched = {k: kernels[k]["wrapper"].launches
                for k in ("erasure_decode",) + ROUND_PAIR}
    res_k = erasure_bp.bp_decode_packed_allzero(code, erased, ITERS)
    torch.cuda.synchronize()
    launched = {k: kernels[k]["wrapper"].launches - v
                for k, v in launched.items()}
    check(launched == {"erasure_decode": 1, "check_exactly_one": 0,
                       "variable_or_update": 0},
          f"the headline decode launched {launched}")
    res_r = round_kernel_bec_decode(code, erased, ITERS)
    res_p = erasure_bp.bp_decode_packed_allzero_plain(code, erased, ITERS)
    torch.cuda.synchronize()
    for name, res in (("kernel D", res_k), ("K2/K3", res_r)):
        check(torch.equal(res.known, res_p.known)
              and torch.equal(res.error_totals, res_p.error_totals)
              and res.iterations == res_p.iterations,
              f"decode by {name} differs from the plain decode")
    check(torch.equal(res_k.bit_errors,
                      bitops._per_trial_counts_plain(~res_p.known)),
          "decode: per-trial counts differ")
    print(f"decode by kernel D == K2/K3 == plain: iterations "
          f"{res_k.iterations}, errors[0] {int(res_k.error_totals[0])} -> "
          f"{int(res_k.error_totals[-1])}, FER "
          f"{float(res_k.failed.float().mean()):.4f}", flush=True)

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
        # kernel D once a decode (one a chunk), the round loop never
        decodes = measured["erasure_decode"]["launches_fixed"]
        check(decodes == 4, f"kernel D launched {decodes} times for 4 "
                            "chunks on the main path")
        for name in ROUND_PAIR:
            launched = kernels[name]["wrapper"].launches
            check(launched == 0, f"kernel {name} was launched {launched} "
                                 "times on the main path")
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
    # "kernel" is the route: kernel D a block a word; "rounds" the K2/K3
    # host loop it replaced; "plain" the plain passes' host loop
    for name, fn in (
            ("plain", erasure_bp.bp_decode_packed_allzero_plain),
            ("kernel", erasure_bp.bp_decode_packed_allzero),
            ("rounds", round_kernel_bec_decode),
            ("rounds", round_kernel_bec_decode),
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
        k_bits / (sum(rate["kernel"]) / len(rate["kernel"])) * 1e3, kernels),
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
        if method == "repair" and num_s == CODES_FULL:
            # the tables written, against E/2 Philox blocks a code
            k5_bound = bound(nbytes(got.chk_to_var, got.var_to_edge,
                                    got.var_to_chk),
                             num_s * n_s * DV / 2 * PHILOX_OPS, INT32_OPS_S)
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
    check(ensemble.sampler_layout(EDGE_SHARED_N * DV)[0]
          != ensemble.LAYOUT_GLOBAL and
          ensemble.sampler_layout((EDGE_SHARED_N + 2) * DV)[0]
          == ensemble.LAYOUT_GLOBAL, f"n={EDGE_SHARED_N} is not the edge "
                                     "of the samplers' shared layouts")
    # the layouts' edges (the largest E that keeps the words in shared
    # memory, the smallest that moves them to the global scratch buffer)
    # and the R-process experiment's n = 16,384 (words shared, partners in
    # the global scratch buffer); "reject" on one code each, as its plain
    # version redraws a code about e^5 times
    for n_s, num_s, methods in (
            (EDGE_SHARED_N, 4, ("raw", "repair")), (EDGE_SHARED_N, 1,
                                                    ("reject",)),
            (EDGE_SHARED_N + 2, 4, ("raw", "repair")),
            (EDGE_SHARED_N + 2, 1, ("reject",)),
            (PEEL_N, 400, ("raw", "repair")), (PEEL_N, 1, ("reject",))):
        for method in methods:
            got = ensemble.sample_codes(3, 1, num_s, n_s, DV, DC, method,
                                        device=dev)
            want = ensemble._sample_codes_plain(3, 1, num_s, n_s, DV, DC,
                                                method, dev)
            torch.cuda.synchronize()
            err = max(max_abs_err(getattr(got, f), getattr(want, f))
                      for f in tables)
            check(err == 0, f"K5 ({method}, n={n_s}, C={num_s}, layout "
                            f"{ensemble.sampler_layout(n_s * DV)[0]}) "
                            f"differs from its plain version (max |d| {err})")
            k5_err = max(k5_err, err)
            print(f"K5 {method} equal to plain at n={n_s}, C={num_s} "
                  f"(layout {ensemble.sampler_layout(n_s * DV)[0]})",
                  flush=True)
    # the shuffle's rounds per code, against the CPU model of the rounds
    k5_rounds = {}
    for n_s, num_s in ((N_FULL, CODES_FULL), (EDGE_SHARED_N, 4),
                       (EDGE_SHARED_N + 2, 4), (PEEL_N, 400)):
        rounds = torch.zeros(num_s, dtype=torch.int32, device=dev)
        ensemble.sample_codes(1, 0, num_s, n_s, DV, DC, "repair", device=dev,
                              rounds=rounds)
        want = rounds_model(1, 0, num_s, n_s * DV)
        check(torch.equal(rounds.cpu().long(), want),
              f"K5's rounds at n={n_s} differ from the CPU model's")
        k5_rounds[n_s] = want
        print(f"K5 rounds per code at n={n_s}, C={num_s}: mean "
              f"{float(want.double().mean()):.3f}, largest {int(want.max())} "
              f"(equal to the CPU model's)", flush=True)
    check(int(k5_rounds[N_FULL].max()) < 100,
          f"K5 took {int(k5_rounds[N_FULL].max())} rounds at n={N_FULL}")
    reject_ms = time_ms(lambda: ensemble.sample_codes(
        1, 0, 32, 1024, DV, DC, "reject", device=dev), reps=2)
    argsort_ms = time_ms(lambda: torch.rand(
        CODES_FULL, N_FULL * DV, device=dev).argsort(dim=1))
    measured["sample_regular_codes"].update(
        rounds_mean_n1e4=float(k5_rounds[N_FULL].double().mean()),
        rounds_max_n1e4=int(k5_rounds[N_FULL].max()),
        rounds_mean_n16384=float(k5_rounds[PEEL_N].double().mean()),
        rounds_max_n16384=int(k5_rounds[PEEL_N].max()),
        yardstick_argsort_rand_768x30000_ms=argsort_ms,
        max_abs_err=k5_err,
        ms=time_ms(lambda: ensemble.sample_codes(
            1, 0, CODES_FULL, N_FULL, DV, DC, "repair", device=dev)),
        plain_ms=time_ms(lambda: ensemble._sample_codes_plain(
            1, 0, CODES_FULL, N_FULL, DV, DC, "repair", dev), reps=1),
        raw_ms=time_ms(lambda: ensemble.sample_codes(
            1, 0, CODES_FULL, N_FULL, DV, DC, "raw", device=dev)),
        reject_ms_n1024_c32=reject_ms, **k5_bound)
    print(f"K5 per chunk (n={N_FULL}, C={CODES_FULL}, repair): "
          f"{measured['sample_regular_codes']['ms']:.3f} ms, plain "
          f"{measured['sample_regular_codes']['plain_ms']:.1f} ms; raw "
          f"{measured['sample_regular_codes']['raw_ms']:.3f} ms; reject at "
          f"n=1024, C=32: {reject_ms:.3f} ms", flush=True)
    print(f"yardstick, another function on another stream: torch.rand("
          f"{CODES_FULL}, {N_FULL * DV}).argsort(dim=1) {argsort_ms:.3f} ms "
          f"beside K5's {measured['sample_regular_codes']['raw_ms']:.3f} ms "
          f"(raw)", flush=True)

    # -- 9 batched K2/K3 ----------------------------------------------------
    phase("9 batched K2/K3 and kernel D against their plain versions, 1 and "
          "24 words per code")
    batch_codes = {}
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
        suffix = "_codes768" if wpc == 1 else f"_wpc{wpc}"
        k2, k3 = measured["check_exactly_one"], measured["variable_or_update"]
        k2["max_abs_err"] = max(k2["max_abs_err"], err2)
        k3["max_abs_err"] = max(k3["max_abs_err"], err3)
        if wpc == 1:          # the ensemble chunk's shape before kernel D
            k2["bound_ms_codes768"] = bound(nbytes(
                codes.chk_to_var, known0, ex_k))["bound_ms"]
            k3["bound_ms_codes768"] = bound(nbytes(
                codes.var_to_chk, ex_k, known0, known0,
                state["errors"]))["bound_ms"]
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
    measured["erasure_decode"].update(
        erasure_decode_phase(dev, batch_codes, erased, kernels))

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
        for name in ROUND_PAIR:
            launched = kernels[name]["wrapper"].launches
            check(launched == 0, f"kernel {name} was launched {launched} "
                                 "times on the ensemble path")
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
        # "kernel" is the engine's route: kernel D at one word a code,
        # K2/K3 at 24; "rounds" the K2/K3 decode that D replaced
        turns = (("plain", erasure_bp.bp_decode_packed_allzero_plain),
                 ("kernel", erasure_bp.bp_decode_packed_allzero),
                 ("kernel", erasure_bp.bp_decode_packed_allzero),
                 ("plain", erasure_bp.bp_decode_packed_allzero_plain))
        if wpc == 1:
            turns = turns[:2] + (("rounds", round_kernel_bec_decode),) * 2 \
                + turns[2:]
        for name, fn in turns:
            ms = time_ms(lambda: fn(codes, erased, ITERS),
                         reps=1 if name == "plain" else 3)
            decode_ms.setdefault(f"{name}_codes{codes.num_codes}",
                                 []).append(ms)
            print(f"{codes.num_codes} codes (wpc {wpc}), {name}: {ms:.3f} ms "
                  "per decode", flush=True)
    measured["erasure_decode"].update(erasure_decode_timing(
        batch_codes[1], erased))
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
        chunk_fns["ensemble"](5).block_errors), ens_chunk_ms, kernels),
        flush=True)
    t_slice2 = time.perf_counter() - t_start
    print(f"phases 1-12 (the earlier paths) wall time: {t_slice2:.1f} s",
          flush=True)

    new_paths(dev, smi, measured, kernels, scratch_root, erased, code,
              batch_codes[1], ens_res.bit_error_rate)
    t_slice3 = time.perf_counter() - t_start
    soft_paths(dev, smi, measured, kernels, scratch_root)
    t_slice4 = time.perf_counter() - t_start
    random_paths(dev, smi, measured, kernels, scratch_root, code)
    t_slice5 = time.perf_counter() - t_start
    qc_paths(dev, smi, measured, kernels, main_res.block_error_rate)
    t_slice6 = time.perf_counter() - t_start
    qc_soft_peel_paths(dev, smi, measured, kernels, scratch_root)
    t_slice7 = time.perf_counter() - t_start
    edge_paths(dev, smi, measured, kernels, scratch_root)
    phase(None)
    print(f"wall time: phases 1-12 {t_slice2:.1f} s, phases 13-17 "
          f"{t_slice3 - t_slice2:.1f} s, phases 18-22 "
          f"{t_slice4 - t_slice3:.1f} s, phases 23-27 "
          f"{t_slice5 - t_slice4:.1f} s, phases 28-32 "
          f"{t_slice6 - t_slice5:.1f} s, phases 33-37 "
          f"{t_slice7 - t_slice6:.1f} s, phases 38-41 "
          f"{time.perf_counter() - t_start - t_slice7:.1f} s, total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"],
         **{k: measured[name].get(k) for k in keys},
         **{k: v for k, v in measured[name].items() if k not in keys},
         **({"batched": True} if name in ("erasure_decode",
                                          "erasure_decode_values",
                                          "gallager_variable",
                                          "gallager_decode",
                                          "soft_posterior", "soft_check")
            else {})}
        for name, spec in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
