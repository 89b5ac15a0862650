"""The port's Gallager-A/B decoders and BSC chunks against the JAX package.

Codes are carried over from JAX (``code_from_numpy``,
``irregular_code_from_numpy``) and JAX-drawn flip planes are handed over
as numpy, so both packages decode the same input: the decided planes,
``error_totals``, ``iterations``, ``traj`` and every integer counter must
be equal; the two squared moments agree to rel 1e-6 (float64 here,
float32 in JAX).  Whole runs on the port's own draws are held to the
density-evolution thresholds.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code, sample_codes as jax_sample_codes)
from iib_project_ldpc_codes_tpu.ops import gallager as jg
from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed as \
    jax_bernoulli_packed
from iib_project_ldpc_codes_tpu.ops.channels import BSC as JaxBSC
from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
from iib_project_ldpc_codes_tpu.utils.results import load_result as \
    jax_load_result
from iib_project_ldpc_codes_tpu.utils.theory import (
    gallager_b_schedule, gallager_b_threshold, irregular_gallager_b_threshold)
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.models import encode, qc
from iib_project_ldpc_codes_tpu_torch.models.code import (
    code_from_checks, code_from_numpy, codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    irregular_code_from_numpy, irregular_codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.ops import bitops, gallager
from iib_project_ldpc_codes_tpu_torch.ops.channels import BSC
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

RHO = [0, 0, 0, 0, 0, 1.0]
MIXED = ([0, 0, 0.5, 0.5], [0, 0, 0, 0, 0.5, 0.5])   # dv 3/4, dc 5/6


def _planes(x):
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


def _carry_irregular(jcode):
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    if tables[0].ndim == 3:
        return irregular_codes_from_numpy(*tables, jcode.n, jcode.m)
    return irregular_code_from_numpy(*tables, jcode.n, jcode.m)


def _regular_pair(n, dv, dc, seed):
    jcode = jax_sample_code(jax.random.key(seed), n, dv, dc)
    return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, dv, dc)


def _assert_same_decode(got, want, record="total"):
    assert np.array_equal(got.decided.numpy(),
                          np.asarray(want.decided).view(np.int32))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    assert np.array_equal(got.bit_errors.numpy(), np.asarray(want.bit_errors))
    assert np.array_equal(got.failed.numpy(), np.asarray(want.failed))
    if record == "per_trial":
        assert np.array_equal(got.traj.numpy(), np.asarray(want.traj))
    else:
        assert got.traj is None


def _dense_with_degree_one(n=100, m=50, seed=0):
    """A dense H with variable degrees 1-4 and mixed check degrees."""
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), bool)
    for v in range(n):
        h[rng.choice(m, size=rng.integers(1, 5), replace=False), v] = True
    assert h.any(1).all() and (h.sum(0) == 1).any()
    return h


# ---------------------------------------------------------------------------
# The bit-sliced count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 5, 7])
def test_bitsliced_count_ge_equals_jax(k):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, size=(k, 6, 5), dtype=np.uint64) \
        .astype(np.uint32)
    ours = [torch.from_numpy(w.view(np.int32).copy()) for w in words]
    theirs = [jnp.asarray(w) for w in words]
    for t in range(-1, k + 2):
        got = gallager._bitsliced_count_ge(ours, t)
        want = np.asarray(jg._bitsliced_count_ge(theirs, t)).view(np.int32)
        assert np.array_equal(got.numpy(), want), t
    # a threshold per row selects that row's count
    per_row = torch.tensor([-1, 0, 1, k, k + 1, 2])[:, None]
    got = gallager._flip_at_threshold(ours, per_row)
    for r, t in enumerate(per_row[:, 0].tolist()):
        assert torch.equal(got[r], gallager._bitsliced_count_ge(ours, t)[r])


# ---------------------------------------------------------------------------
# Regular and irregular decodes, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p, threshold, record", [
    (0.02, None, "total"), (0.05, None, "per_trial"), (0.05, 1, "total"),
    (0.04, 1, "per_trial"), (0.05, 0, "total"), (0.05, 7, "per_trial")])
def test_regular_gallager_equals_jax(p, threshold, record):
    jcode, code = _regular_pair(204, 3, 6, 1)
    rx = jax_bernoulli_packed(jax.random.key(int(p * 1000)), p, (204, 3))
    want = jg.gallager_decode_packed(jcode, rx, 25, threshold=threshold,
                                     record=record)
    for decode in (gallager.gallager_decode_packed,
                   gallager.gallager_decode_packed_plain):
        _assert_same_decode(decode(code, _planes(rx), 25,
                                   threshold=threshold, record=record),
                            want, record)


@pytest.mark.parametrize("schedule", ["constant", "optimal", "late"])
def test_regular_gallager_schedules_equal_jax(schedule):
    p, iters = 0.045, 60
    jcode, code = _regular_pair(512, 4, 8, 3)
    sched = {"constant": [3] * iters,
             "optimal": gallager_b_schedule(p, iters, 4, 8),
             "late": [3] * 30 + [2] * 15 + [0] * 15}[schedule]
    rx = jax_bernoulli_packed(jax.random.key(4), p, (512, 2))
    want = jg.gallager_decode_packed(
        jcode, rx, iters, schedule=jnp.asarray(sched, jnp.int32),
        record="per_trial")
    got = gallager.gallager_decode_packed(code, _planes(rx), iters,
                                          schedule=sched, record="per_trial")
    _assert_same_decode(got, want, "per_trial")
    if schedule == "constant":
        fixed = gallager.gallager_decode_packed(code, _planes(rx), iters,
                                                threshold=3)
        assert torch.equal(fixed.decided, got.decided)
        assert torch.equal(fixed.error_totals, got.error_totals)
    with pytest.raises(ValueError, match="max_iters"):
        gallager.gallager_decode_packed(code, _planes(rx), iters,
                                        schedule=sched[:iters - 1])


@pytest.mark.parametrize("threshold", [None, 1, 2, 0])
@pytest.mark.parametrize("record", ["total", "per_trial"])
def test_irregular_gallager_equals_jax_with_degree_one(threshold, record):
    h = _dense_with_degree_one()
    jcode = jir.irregular_code_from_dense(h)
    code = _carry_irregular(jcode)
    rx = jax_bernoulli_packed(jax.random.key(5), 0.05, (100, 3))
    want = jg.gallager_decode_packed_irregular(jcode, rx, 20,
                                               threshold=threshold,
                                               record=record)
    for decode in (gallager.gallager_decode_packed_irregular,
                   gallager.gallager_decode_packed_irregular_plain):
        _assert_same_decode(decode(code, _planes(rx), 20,
                                   threshold=threshold, record=record),
                            want, record)


@pytest.mark.parametrize("threshold", [None, 1, 2])
def test_irregular_gallager_on_sampled_mixed_code_equals_jax(threshold):
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(110, *MIXED).sample(
        jax.random.key(6))
    rx = jax_bernoulli_packed(jax.random.key(7), 0.06, (110, 2))
    want = jg.gallager_decode_packed_irregular(jcode, rx, 30,
                                               threshold=threshold)
    got = gallager.gallager_decode_packed_irregular(
        _carry_irregular(jcode), _planes(rx), 30, threshold=threshold)
    _assert_same_decode(got, want)


@pytest.mark.parametrize("threshold", [None, 1])
def test_degenerate_irregular_decoder_equals_regular(threshold):
    jcode = jir.IrregularEnsembleSpec.regular(96, 3, 6).sample(
        jax.random.key(3))
    icode = _carry_irregular(jcode)
    reg = code_from_checks(icode.chk_to_var[:-1], 96, 3, 6)
    for p in (0.02, 0.05):
        rx = _planes(jax_bernoulli_packed(jax.random.key(int(p * 1000)), p,
                                          (96, 4)))
        ri = gallager.gallager_decode_packed_irregular(icode, rx, 25,
                                                       threshold=threshold)
        rr = gallager.gallager_decode_packed(reg, rx, 25, threshold=threshold)
        assert torch.equal(ri.decided, rr.decided)
        assert torch.equal(ri.error_totals, rr.error_totals)
        assert ri.iterations == rr.iterations


def test_every_round_and_the_stop_round_equal_jax():
    # the stop rule is not absorbing: each budget from 0 to one past the
    # stop must give JAX's planes and counts, and the zero-error exit must
    # land on exactly its round
    jcode, code = _regular_pair(504, 3, 6, 2)
    rx = jax_bernoulli_packed(jax.random.key(9), 0.01, (504, 1))
    full = jg.gallager_decode_packed(jcode, rx, 40)
    stop = int(full.iterations)
    assert 0 < stop < 40
    for budget in range(stop + 2):
        want = jg.gallager_decode_packed(jcode, rx, budget)
        _assert_same_decode(gallager.gallager_decode_packed(
            code, _planes(rx), budget), want)
    got = gallager.gallager_decode_packed(code, _planes(rx), 40)
    totals = got.error_totals.tolist()
    if totals[stop] == 0:                       # the zero-error exit
        assert totals[stop - 1] > 0 and set(totals[stop:]) == {0}
    else:                                       # the unchanged-messages exit
        assert set(totals[stop:]) == {totals[stop]}


@pytest.mark.parametrize("wpc", [1, 2])
def test_batched_decode_freezes_each_code_at_its_own_stop(wpc):
    num, n, iters = 5, 120, 30
    jcodes = jax_sample_codes(jax.random.key(4), num, n, 3, 6)
    codes = codes_from_numpy(np.asarray(jcodes.chk_to_var), n, 3, 6)
    # per-code noise levels so that the codes stop on different rounds
    planes = [jax_bernoulli_packed(jax.random.key(g), p, (n, wpc))
              for g, p in enumerate((0.0, 0.002, 0.005, 0.01, 0.08))]
    got = gallager.gallager_decode_packed(
        codes, _planes(np.concatenate(planes, axis=1)), iters,
        record="per_trial")
    totals, its = np.zeros(iters + 1, np.int64), []
    for g in range(num):
        want = jg.gallager_decode_packed(jax.tree.map(lambda x: x[g], jcodes),
                                         planes[g], iters, record="per_trial")
        words = slice(g * wpc, (g + 1) * wpc)
        assert np.array_equal(got.decided[:, words].numpy(),
                              np.asarray(want.decided).view(np.int32))
        assert np.array_equal(got.traj[:, 32 * g * wpc:32 * (g + 1) * wpc]
                              .numpy(), np.asarray(want.traj))
        totals += np.asarray(want.error_totals)
        its.append(int(want.iterations))
    assert len(set(its)) > 2
    assert got.error_totals.tolist() == totals.tolist()
    assert got.iterations == max(its)


def test_decoder_contract_errors():
    _, code = _regular_pair(96, 3, 6, 0)
    rx = torch.zeros((96, 1), dtype=torch.int32)
    # a codeword plane (here all zero) counts errors against it
    with_tx = gallager.gallager_decode_packed(code, rx, 5, tx_bits=rx)
    assert with_tx.error_totals.tolist() == [0] * 6
    with pytest.raises(ValueError, match="tx_bits"):
        gallager.gallager_decode_packed(code, rx, 5,
                                        tx_bits=rx[:90].contiguous())
    with pytest.raises(ValueError, match="record"):
        gallager.gallager_decode_packed(code, rx, 5, record="bogus")
    with pytest.raises(ValueError, match="rows"):
        gallager.gallager_decode_packed(code, rx[:90].contiguous(), 5)
    res = gallager.gallager_decode_packed(code, rx, 5)
    assert res.iterations == 0 and res.error_totals.tolist() == [0] * 6


# ---------------------------------------------------------------------------
# Kernel G (the whole decode, one block per code): its plain version and
# the host assembly against JAX's vmapped decode, and the rule that picks it
# ---------------------------------------------------------------------------

# one crossover probability per code (one word, 32 trials, each): a code
# without channel errors (0 rounds), codes that stop on different rounds
# (some at a message fixed point with errors left), codes that never stop
G_PS = (0.0, 0.005, 0.01, 0.015, 0.02, 0.02, 0.05, 0.08)
G_ITERS = 30
# Gallager-B on (4,8): Gallager-A (t = 3) for 12 rounds, then t = 2
G_SCHEDULE = [3] * 12 + [2] * (G_ITERS - 12)


def _g_batch(family):
    """(JAX codes, port codes, flips int32[n, C]): one code per word."""
    num = len(G_PS)
    if family == "regular":
        n = 128
        jcodes = jax_sample_codes(jax.random.key(3), num, n, 4, 8)
        codes = codes_from_numpy(np.asarray(jcodes.chk_to_var), n, 4, 8)
    else:
        n = 110
        jcodes = jir.IrregularEnsembleSpec.from_lam_rho(n, *MIXED) \
            .sample_batch(jax.random.key(3), num)
        codes = _carry_irregular(jcodes)
    flips = np.concatenate([np.asarray(jax_bernoulli_packed(
        jax.random.key(10 + g), p, (n, 1))) for g, p in enumerate(G_PS)],
        axis=1)
    return jcodes, codes, _planes(flips)


def _spy_decode(monkeypatch):
    """Record every call of kernel G's wrapper (here: its plain version)
    and its raw outputs."""
    calls = []
    real = gallager.gallager_decode

    def spy(*args, **kwargs):
        calls.append(real(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(gallager, "gallager_decode", spy)
    return calls


def _per_code(plane: torch.Tensor):
    """[n, C] (one word a code) as JAX's vmapped [C, n, 1] uint32."""
    return jnp.asarray(plane.t().contiguous().numpy().view(np.uint32)
                       [:, :, None])


@pytest.mark.parametrize("family, kw", [
    ("regular", dict(threshold=None)), ("regular", dict(threshold=1)),
    ("regular", dict(schedule=G_SCHEDULE)),
    ("irregular", dict(threshold=None)), ("irregular", dict(threshold=1))])
@pytest.mark.parametrize("with_tx", [False, True])
@pytest.mark.parametrize("max_iters", [0, 1, G_ITERS])
def test_decode_kernel_plain_equals_jax_vmap(monkeypatch, family, kw,
                                             with_tx, max_iters):
    jcodes, codes, flips = _g_batch(family)
    tx = None
    if with_tx:
        enc = encode.code_encoder_planes(codes)
        tx = encode.encode_packed(enc, bitops.info_planes(
            enc.k, len(G_PS), seed=4))
    received = flips if tx is None else flips ^ tx
    jfn = jg.gallager_decode_packed if family == "regular" else \
        jg.gallager_decode_packed_irregular
    jkw = dict(kw)
    if "schedule" in kw:
        # JAX cannot trace a schedule of 0 rounds (it indexes the empty
        # array); no round runs, so its decode without one is the same
        jkw["schedule"] = jnp.asarray(kw["schedule"], jnp.int32) \
            if max_iters else None
    if tx is None:
        want = jax.vmap(lambda c, r: jfn(c, r, max_iters, **jkw))(
            jcodes, _per_code(received))
    else:
        want = jax.vmap(lambda c, r, t: jfn(c, r, max_iters, tx_bits=t,
                                            **jkw))(
            jcodes, _per_code(received), _per_code(tx))
    decode = gallager.gallager_decode_packed if family == "regular" else \
        gallager.gallager_decode_packed_irregular
    calls = _spy_decode(monkeypatch)
    got = decode(codes, received, max_iters, tx_bits=tx, **kw)
    assert len(calls) == 1                  # the whole decode, once
    decided, round_errors, rounds = calls[0]
    # the raw outputs, code by code: JAX's per-code totals and rounds
    assert np.array_equal(round_errors.numpy(), np.asarray(want.error_totals))
    assert np.array_equal(rounds.numpy(), np.asarray(want.iterations))
    err = decided if tx is None else decided ^ tx
    assert np.array_equal(err.t().numpy(),
                          np.asarray(want.decided)[:, :, 0].view(np.int32))
    # the host assembly
    assert np.array_equal(got.decided.t().numpy(),
                          np.asarray(want.decided)[:, :, 0].view(np.int32))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals).sum(0))
    assert got.iterations == int(np.asarray(want.iterations).max())
    assert got.traj is None
    stops = np.asarray(want.iterations)
    assert stops[0] == 0                    # no channel errors: no round
    if max_iters == G_ITERS and kw.get("threshold") is None:
        # Gallager-A and the schedule stop the codes on different rounds
        # (t = 1 on these degrees runs every code to the budget)
        assert len(set(stops.tolist())) > 3 and stops.max() == G_ITERS


def test_decode_kernel_schedule_runs_past_a_fixed_point():
    # under the constant t = 3, some code stops at a message fixed point
    # with errors left before the schedule switches; the schedule's
    # change_ahead keeps it running into the t = 2 rounds
    _, codes, flips = _g_batch("regular")
    graph = gallager._graph(codes)
    ahead = [any(G_SCHEDULE[j] != G_SCHEDULE[i] for j in range(i + 1,
                                                               G_ITERS))
             for i in range(G_ITERS)]
    runs = {}
    for name, sched, flags in (("constant", [3] * G_ITERS, [0] * G_ITERS),
                               ("schedule", G_SCHEDULE, ahead)):
        runs[name] = gallager._gallager_decode_plain(
            flips, graph.chk_to_var, graph.var_to_sock,
            torch.tensor(sched, dtype=torch.int32),
            torch.tensor(flags, dtype=torch.int32), dc=8,
            pad_pos=graph.pad_pos, clamp=False)
    _, errs, rounds = runs["constant"]
    stuck = [g for g in range(len(G_PS)) if 0 < rounds[g] < 12
             and errs[g, -1] > 0]
    assert stuck
    assert all(runs["schedule"][2][g] > 12 for g in stuck)
    # and the public decoder builds the same flags
    got = gallager.gallager_decode_packed(codes, flips, G_ITERS,
                                          schedule=G_SCHEDULE)
    assert torch.equal(got.error_totals,
                       runs["schedule"][1].sum(0, dtype=torch.int32))


def _shape_graph(num, n, dv, dc, irregular=False):
    """A graph of ``num`` codes with the tables' shapes only (expanded
    views, no memory): what the rule reads."""
    rows = n * dv // dc + (1 if irregular else 0)
    zero = torch.zeros((1, 1, 1), dtype=torch.int32)
    return gallager._Graph(
        chk_to_var=zero.expand(num, rows, dc),
        var_to_sock=zero.expand(num, n + (1 if irregular else 0), dv), n=n,
        dc=dc, pad_pos=(rows - (1 if irregular else 0)) * dc,
        irregular=irregular)


@pytest.mark.parametrize("num, n, dv, dc, irregular, words, record, takes", [
    # the ensemble chunks at one word per code: n = 10^4, 768 codes
    (768, 10_000, 3, 6, False, 768, "total", True),
    (768, 10_000, 4, 6, True, 768, "total", True),     # dv_max 4, dc_max 6
    (256, 1024, 3, 6, False, 256, "total", True),      # n = 1024 brackets
    (16, 1024, 3, 6, False, 64, "total", True),        # 4 words a code
    # the expurgated chunks keep the round kernels
    (768, 10_000, 3, 6, False, 768, "per_trial", False),
    # a fixed code at W = 768 does not fit one block
    (1, 10_000, 3, 6, False, 768, "total", False),
    # the edge of one block's shared memory: (3,6) at n = 16,602 / 16,604
    (4, 16_602, 3, 6, False, 4, "total", True),
    (4, 16_604, 3, 6, False, 4, "total", False),
    # degrees above the kernel's
    (8, 66, 33, 66, False, 8, "total", False)])
def test_decode_kernel_rule(num, n, dv, dc, irregular, words, record, takes):
    graph = _shape_graph(num, n, dv, dc, irregular)
    assert gallager.takes_decode_kernel(graph, record, words) is takes
    need = (graph.chk_to_var.shape[1] * (dc + 1)) * 4 * (words // num) + 16
    assert (need <= gallager.SMEM_OPTIN_BYTES) is (takes or record !=
                                                   "total" or dv > 32)


def test_decode_kernel_rule_on_the_paths(monkeypatch):
    # which decodes reach kernel G's wrapper: the ensemble chunk at one
    # word a code, not the expurgated chunk, a wide fixed code or QC codes
    _, codes, flips = _g_batch("regular")
    calls = _spy_decode(monkeypatch)
    mc._gallager_chunk(codes, flips, iterations=20, threshold=None,
                       expurgation=None)
    assert len(calls) == 1
    mc._gallager_chunk(codes, flips, iterations=20, threshold=None,
                       expurgation=0)
    wide = flips.repeat(1, 20)                  # one code, 160 words
    rule = gallager.takes_decode_kernel(gallager._graph(codes.select(0)),
                                        "total", wide.shape[1])
    gallager.gallager_decode_packed(codes.select(0), wide, 20)
    assert not rule and len(calls) == 1
    qc_code = qc.sample_qc_code(torch.Generator().manual_seed(0), nb=12,
                                dv=3, dc=6, Z=10)
    qflips = bitops.bernoulli_packed(0.03, (qc_code.n, 1), seed=1)
    mc._gallager_chunk(qc_code, qflips, iterations=20, threshold=None,
                       expurgation=None)
    assert len(calls) == 1
    # the plain decoders run the round loop, the reference of both routes
    plain = gallager.gallager_decode_packed_plain(codes, flips, 20)
    assert len(calls) == 1
    assert torch.equal(plain.error_totals, gallager.gallager_decode_packed(
        codes, flips, 20).error_totals) and len(calls) == 2


def test_decode_kernel_contract_errors():
    _, codes, flips = _g_batch("regular")
    graph = gallager._graph(codes)
    t = torch.full((5,), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ in length"):
        gallager.gallager_decode(flips, graph.chk_to_var, graph.var_to_sock,
                                 t, t[:4].contiguous(), dc=8,
                                 pad_pos=graph.pad_pos, clamp=False)
    with pytest.raises(ValueError, match="split evenly"):
        gallager.gallager_decode(flips[:, :6].contiguous(), graph.chk_to_var,
                                 graph.var_to_sock, t, t, dc=8,
                                 pad_pos=graph.pad_pos, clamp=False)
    with pytest.raises(ValueError, match="differ in shape"):
        gallager.gallager_decode(flips, graph.chk_to_var, graph.var_to_sock,
                                 t, t, dc=8, pad_pos=graph.pad_pos,
                                 clamp=False, tx=flips[:5].contiguous())


# ---------------------------------------------------------------------------
# Chunk statistics
# ---------------------------------------------------------------------------

def _assert_stats_equal(got, want, batched):
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    for field in ("block_errors", "bit_errors", "excluded"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field
    assert float(got.bit_errors_sq) == pytest.approx(
        float(want.bit_errors_sq), rel=1e-6)
    if batched:
        assert float(got.code_bit_errors_sq) == pytest.approx(
            float(want.code_bit_errors_sq), rel=1e-6)
    else:
        assert got.code_bit_errors_sq is None


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_fixed_chunk_equals_jax(family, expurgation):
    n, words, iters, p = 120, 3, 30, 0.05
    if family == "regular":
        jcode, code = _regular_pair(n, 3, 6, 1)
        threshold = None
    else:
        jcode = jir.IrregularEnsembleSpec.from_lam_rho(n, *MIXED).sample(
            jax.random.key(1))
        code, threshold = _carry_irregular(jcode), 2
    key = jax.random.key(5)
    want = jmc._gallager_chunk(jcode, key, n=n, words=words,
                               iterations=iters, crossover_prob=p,
                               threshold=threshold, expurgation=expurgation)
    got = mc._gallager_chunk(code, _planes(jax_bernoulli_packed(
        key, p, (n, words))), iterations=iters, threshold=threshold,
        expurgation=expurgation)
    _assert_stats_equal(got, want, batched=False)
    if expurgation is not None:
        assert 0 < int(got.excluded) < 32 * words


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("wpc", [1, 3])
@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_ensemble_chunk_equals_jax_vmap(family, wpc, expurgation):
    n, num, iters, p = 120, 4, 30, 0.05
    if family == "regular":
        jcodes = jax_sample_codes(jax.random.key(2), num, n, 3, 6)
        codes = codes_from_numpy(np.asarray(jcodes.chk_to_var), n, 3, 6)
    else:
        jcodes = jir.IrregularEnsembleSpec.from_lam_rho(n, *MIXED) \
            .sample_batch(jax.random.key(2), num)
        codes = _carry_irregular(jcodes)
    keys = jax.random.split(jax.random.key(7), num)
    planes = np.concatenate([np.asarray(jax_bernoulli_packed(
        k, p, (n, wpc))) for k in keys], axis=1)
    want = jmc._reduce_code_stats(jax.vmap(
        lambda c, k: jmc._gallager_chunk(
            c, k, n=n, words=wpc, iterations=iters, crossover_prob=p,
            threshold=None, expurgation=expurgation))(jcodes, keys))
    got = mc._gallager_chunk(codes, _planes(planes), iterations=iters,
                             threshold=None, expurgation=expurgation)
    _assert_stats_equal(got, want, batched=True)


def test_bsc_channel_equals_jax():
    ch = BSC(0.1)
    received = torch.tensor([0, 1, 1, 0])
    assert np.allclose(ch.llr(received).numpy(),
                       np.asarray(JaxBSC(0.1).llr(jnp.asarray(received))),
                       rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    flips = ch.flip_mask((200_000,), g)
    assert abs(float(flips.float().mean()) - 0.1) < 5 * (0.09 / 2e5) ** 0.5
    bits = torch.randint(0, 2, (1000,), generator=g)
    out = BSC(1.0).transmit(bits, g)
    assert out.dtype == torch.int32 and torch.equal(out, 1 - bits)


# ---------------------------------------------------------------------------
# Whole runs (port only) and the CLI
# ---------------------------------------------------------------------------

def _run(p, **kw):
    fields = dict(channel="BSC", channel_param=p, n=1024, decoder="gallager",
                  num_tests=1024, batch=512, max_block_errors=10**9,
                  code_mode="ensemble")
    fields.update(kw)
    return mc.run_simulation(SimulationConfig(**fields), device="cpu")


def test_gallager_b_run_brackets_its_threshold():
    # tests/test_gallager_soft.py::test_gallager_b_mc_brackets_de_threshold
    thr = gallager_b_threshold(4, 8, 3)
    common = dict(dv=4, dc=8, gallager_threshold=3, iterations=60, seed=17)
    lo, hi = _run(thr - 0.02, **common), _run(thr + 0.03, **common)
    assert lo.bit_error_rate < 5e-3
    assert hi.bit_error_rate > 10 * max(lo.bit_error_rate, 1e-6)
    assert lo.trials_per_code == 32 and lo.code_bit_errors_sq is not None


def test_irregular_gallager_a_run_brackets_its_threshold():
    # tests/test_irregular.py::test_gallager_irregular_mc_brackets_its_de_threshold
    thr = irregular_gallager_b_threshold([0, 0, 0.5, 0.5], RHO)
    common = dict(lam=[0, 0, 0.5, 0.5], rho=RHO, iterations=40, seed=47)
    lo, hi = _run(thr - 0.03, **common), _run(thr + 0.03, **common)
    assert lo.bit_error_rate < 5e-3
    assert hi.bit_error_rate > 5 * max(lo.bit_error_rate, 1e-6)


def test_cli_gallager_configs_on_cpu(tmp_path):
    for name, fields in (
            ("fixed", dict(code_mode="fixed")),
            ("irregular", dict(lam=[0, 0, 0.5, 0.5], rho=RHO,
                               code_mode="ensemble", codes_per_chunk=8,
                               expurgation=1))):
        cfg = SimulationConfig(channel="BSC", decoder="gallager",
                               channel_param=0.04, n=120, iterations=20,
                               num_tests=512, batch=256,
                               max_block_errors=10**9, seed=3, **fields)
        path = tmp_path / f"{name}.json"
        path.write_text(cfg.to_json())
        out = tmp_path / name
        assert cli.main(["--config", str(path), f"--output-dir={out}",
                         "--device=cpu"]) == 0
        res = jax_load_result(glob.glob(os.path.join(str(out), "*.json"))[0])
        assert res.config.channel == "BSC" and res.num_trials == 512
        rates = res.error_rate_per_iteration
        assert len(rates) == 21
        if cfg.expurgation is None:
            assert abs(rates[0] - 0.04) < 0.01
        else:   # the series counts the included trials only
            assert 0 < res.excluded_trials < 512 and rates[0] < 0.04
