"""The port's ensemble mode (reference mode 0) against the JAX package.

Codes sampled by JAX are carried over with ``codes_from_numpy`` and planes
drawn by JAX are concatenated along words, so the port's batched chunk and
the JAX engine's vmapped ``_bp_chunk`` decode the same input and must
agree: integer counters exactly, the two squared moments to rel 1e-6
(float64 here, float32 in JAX).  The port's sampler draws from its own
Philox stream, so it is held to an independent sequential implementation
of that stream, to the structure of the ensemble, and whole runs to the
exact stopping-set BER and to a JAX run by confidence intervals.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models.ensemble import sample_codes as \
    jax_sample_codes
from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed as \
    jax_bernoulli_packed
from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig as \
    JaxConfig
from iib_project_ldpc_codes_tpu.utils.results import load_result as \
    jax_load_result
from iib_project_ldpc_codes_tpu.utils.stats import ber_ci, wilson
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.models import ensemble
from iib_project_ldpc_codes_tpu_torch.models.code import (
    code_from_checks, codes_from_numpy, validate_code)
from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig
from iib_project_ldpc_codes_tpu_torch.utils.results import save_result


def _jax_codes(num, n, method, seed=31):
    jcodes = jax_sample_codes(jax.random.key(seed), num, n, 3, 6, method)
    return jcodes, codes_from_numpy(np.asarray(jcodes.chk_to_var), n, 3, 6)


def _cfg(**kw):
    base = dict(channel_param=0.4, n=120, code_mode="ensemble",
                iterations=30, batch=256, num_tests=768, codes_per_chunk=4,
                max_block_errors=10**9, seed=3)
    base.update(kw)
    return SimulationConfig(**base)


# ---------------------------------------------------------------------------
# Batched codes and the batched decode
# ---------------------------------------------------------------------------

def test_codes_from_numpy_matches_jax_batch():
    jcodes, codes = _jax_codes(5, 96, "raw")
    assert codes.batched and codes.num_codes == 5
    for name in ("chk_to_var", "var_to_edge", "var_to_chk"):
        assert np.array_equal(getattr(codes, name).numpy(),
                              np.asarray(getattr(jcodes, name))), name
    one = codes.select(2)
    assert not one.batched and one.num_codes == 1
    assert torch.equal(one.var_to_edge, code_from_checks(
        one.chk_to_var, 96, 3, 6).var_to_edge)
    moved = codes.to("cpu")
    assert moved.batched and torch.equal(moved.var_to_chk, codes.var_to_chk)
    assert validate_code(codes) == (False,
                                    "check touches the same variable twice")
    assert validate_code(_jax_codes(3, 96, "repair")[1]) == (True, "ok")
    with pytest.raises(ValueError, match="C, 48, 6"):
        codes_from_numpy(np.zeros((48, 6), np.int32), 96, 3, 6)


@pytest.mark.parametrize("method", ["repair", "raw"])
@pytest.mark.parametrize("wpc", [1, 4])
@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_batched_chunk_matches_jax_vmap(method, wpc, expurgation):
    n, num, iters, eps = 120, 4, 30, 0.4
    jcodes, codes = _jax_codes(num, n, method)
    if method == "raw":      # multi-edges are part of what is compared
        assert not all(validate_code(codes.select(i))[0]
                       for i in range(num))
    keys = jax.random.split(jax.random.key(7), num)
    # each JAX code draws its planes from its key; hand them to the port
    planes = np.concatenate([np.asarray(jax_bernoulli_packed(
        k, eps, (n, wpc))) for k in keys], axis=1)
    want = jmc._reduce_code_stats(jax.vmap(
        lambda c, k: jmc._bp_chunk(c, k, n=n, words=wpc, iterations=iters,
                                   erasure_prob=eps,
                                   expurgation=expurgation))(jcodes, keys))
    got = mc._bp_chunk(codes, torch.from_numpy(planes.view(np.int32).copy()),
                       iterations=iters, expurgation=expurgation)
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert int(got.block_errors) == int(want.block_errors)
    assert int(got.bit_errors) == int(want.bit_errors)
    assert int(got.excluded) == int(want.excluded)
    assert float(got.bit_errors_sq) == pytest.approx(
        float(want.bit_errors_sq), rel=1e-6)
    assert float(got.code_bit_errors_sq) == pytest.approx(
        float(want.code_bit_errors_sq), rel=1e-6)
    if expurgation is not None:
        assert 0 < int(got.excluded) < 32 * wpc * num


@pytest.mark.parametrize("wpc", [1, 3])
def test_batched_passes_equal_per_code_passes(wpc):
    n, num = 96, 4
    _, codes = _jax_codes(num, n, "raw", seed=5)
    known = ~bitops.bernoulli_packed(0.4, (n, num * wpc), seed=2)
    ex = erasure_bp.check_exactly_one(codes.chk_to_var, known)
    errors = torch.zeros(2, dtype=torch.int32)
    new_known = known.clone()
    erasure_bp.variable_or_update(codes.var_to_chk, ex, new_known, errors, 1)
    total = 0
    for g in range(num):
        code = codes.select(g)
        words = slice(g * wpc, (g + 1) * wpc)
        kn = known[:, words].contiguous()
        ex_g = erasure_bp.check_exactly_one(code.chk_to_var, kn)
        assert torch.equal(ex[:, words], ex_g)
        err_g = torch.zeros(2, dtype=torch.int32)
        erasure_bp.variable_or_update(code.var_to_chk, ex_g, kn, err_g, 1)
        assert torch.equal(new_known[:, words], kn)
        total += int(err_g[1])
    assert int(errors[1]) == total
    # a batch of one code is the single-code call
    one = codes_from_numpy(codes.chk_to_var[:1].numpy(), n, 3, 6)
    assert torch.equal(
        erasure_bp.check_exactly_one(one.chk_to_var, known),
        erasure_bp.check_exactly_one(one.select(0).chk_to_var, known))
    with pytest.raises(ValueError, match="split evenly"):
        erasure_bp.check_exactly_one(codes.chk_to_var, known[:, :1]
                                     .contiguous().repeat(1, num + 1))


@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_batched_decode_sums_per_code_decodes(eps):
    n, num, wpc, iters = 96, 5, 2, 40
    _, codes = _jax_codes(num, n, "repair", seed=9)
    erased = bitops.bernoulli_packed(eps, (n, num * wpc), seed=4)
    res = erasure_bp.bp_decode_packed_allzero(codes, erased, iters)
    totals = torch.zeros(iters + 1, dtype=torch.int32)
    iterations = []
    for g in range(num):
        words = slice(g * wpc, (g + 1) * wpc)
        one = erasure_bp.bp_decode_packed_allzero(
            codes.select(g), erased[:, words].contiguous(), iters)
        assert torch.equal(res.known[:, words], one.known)
        totals += one.error_totals
        iterations.append(one.iterations)
    assert torch.equal(res.error_totals, totals)
    assert max(iterations) <= res.iterations <= max(iterations) + 1
    plain = erasure_bp.bp_decode_packed_allzero_plain(codes, erased, iters)
    assert torch.equal(plain.known, res.known)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _philox(ctr, key):
    """Philox4x32-10 on Python ints (independent of the port's code)."""
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & _M32, p1 & _M32,
             ((p0 >> 32) ^ c[3] ^ k1) & _M32, p0 & _M32]
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c


def _sequential_sampler(seed, chunk, num, n, dv, dc, method):
    """The documented draws, one code and one step at a time."""
    key = ((seed & _M32), (seed >> 32) ^ 0x243F6A88)
    sockets = n * dv

    def uniform(d, code, stream, bound):
        x, y, z, w = _philox((d >> 1, code, chunk, stream), key)
        r = (w << 32 | z) if d & 1 else (y << 32 | x)
        return (r * bound) >> 64

    def shuffle(code, attempt):
        perm = list(range(sockets))
        for i in range(sockets - 1, 0, -1):
            j = uniform(i, code, attempt, i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        return perm

    def first_dup(perm):
        for r in range(sockets // dc):
            row = [perm[r * dc + k] // dv for k in range(dc)]
            for k in range(1, dc):
                if row[k] in row[:k]:
                    return r * dc + k
        return -1

    tables = []
    for code in range(num):
        perm = shuffle(code, 0)
        tries = 0
        while method != "raw" and first_dup(perm) >= 0 and tries < 1000:
            if method == "reject":
                perm = shuffle(code, tries + 1)
            else:
                s = first_dup(perm)
                j = uniform(tries, code, 1 << 31, sockets)
                perm[s], perm[j] = perm[j], perm[s]
            tries += 1
        tables.append(np.array(perm) // dv)
    return np.stack(tables).reshape(num, -1, dc)


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_matches_sequential_draws(method):
    codes = ensemble.sample_codes(2**40 + 9, 7, 3, 60, 3, 6, method)
    want = _sequential_sampler(2**40 + 9, 7, 3, 60, 3, 6, method)
    assert np.array_equal(codes.chk_to_var.numpy(), want)


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_structure(method):
    n, num = 96, 6
    codes = ensemble.sample_codes(11, 2, num, n, 3, 6, method)
    assert codes.chk_to_var.shape == (num, 48, 6)
    assert codes.var_to_edge.dtype == torch.int32
    for i in range(num):
        code = codes.select(i)
        counts = np.bincount(code.chk_to_var.numpy().reshape(-1),
                             minlength=n)
        assert (counts == 3).all()          # multiplicity counted
        if method != "raw":
            assert validate_code(code) == (True, "ok")
        assert torch.equal(code.var_to_edge, code_from_checks(
            code.chk_to_var, n, 3, 6).var_to_edge)
        assert torch.equal(code.var_to_chk, code.var_to_edge // 6)


def test_sampler_is_deterministic_per_code():
    a = ensemble.sample_codes(5, 3, 4, 120, 3, 6)
    b = ensemble.sample_codes(5, 3, 6, 120, 3, 6)
    # code i of a chunk does not depend on how many codes were drawn
    assert torch.equal(a.chk_to_var, b.chk_to_var[:4])
    for other in (ensemble.sample_codes(5, 4, 4, 120, 3, 6),
                  ensemble.sample_codes(6, 3, 4, 120, 3, 6)):
        for i in range(4):
            assert not torch.equal(a.chk_to_var[i], other.chk_to_var[i])
    assert ensemble.sampler_key(5) != bitops.philox_key(5)


def test_repair_swaps_the_first_offender():
    n, dv, dc = 12, 3, 6
    # the identity puts variable 0's three sockets in check 0: sockets 1
    # and 2 of row 0 repeat socket 0, so flat index 1 is the first offender
    perm = torch.arange(n * dv, dtype=torch.int64)[None, :].clone()
    dup, first = ensemble._first_duplicates(perm, dv, dc)
    assert bool(dup[0]) and int(first[0]) == 1
    key = ensemble.sampler_key(0)
    codes = torch.zeros(1, dtype=torch.int64)
    once = ensemble._repair_plain(perm.clone(), key, codes, 0, dv, dc,
                                  max_passes=1)
    hi, lo = ensemble._draws(key, torch.tensor(0), codes, 0,
                             ensemble.REPAIR_STREAM)
    j = int(ensemble._mulhi64(hi, lo, n * dv))
    want = perm.clone()
    want[0, 1], want[0, j] = perm[0, j], perm[0, 1]
    assert torch.equal(once, want)
    fixed = ensemble._repair_plain(perm.clone(), key, codes, 0, dv, dc)
    assert not bool(ensemble._first_duplicates(fixed, dv, dc)[0][0])


def test_raw_double_edges_follow_the_configuration_model():
    n, dv, dc, num = 600, 3, 6, 240
    chk = ensemble.sample_codes(1, 0, num, n, dv, dc, "raw").chk_to_var
    pairs = (chk[:, :, :, None] == chk[:, :, None, :]).triu(1)
    doubles = pairs.sum(dim=(1, 2, 3)).double()
    expect = (dv - 1) * (dc - 1) / 2
    se = float(doubles.std()) / num ** 0.5
    assert abs(float(doubles.mean()) - expect) < 4 * se


def test_sampler_rejects_bad_arguments():
    with pytest.raises(ValueError, match="method"):
        ensemble.sample_codes(0, 0, 2, 12, 3, 6, "bogus")
    with pytest.raises(ValueError, match="divisible"):
        ensemble.sample_codes(0, 0, 2, 7, 3, 6)
    with pytest.raises(ValueError, match="32 bits"):
        ensemble.sample_codes(0, 2**32, 2, 12, 3, 6)
    with pytest.raises(ValueError, match="device"):
        ensemble.sample_codes(0, 0, 2, 12, 3, 6, device="meta")


# ---------------------------------------------------------------------------
# Whole runs, checkpoints and the CLI
# ---------------------------------------------------------------------------

def test_raw_run_brackets_the_exact_stopping_set_ber(tmp_path):
    # tests/test_stopping_sets.py::test_exact_vs_monte_carlo_raw_ensemble
    # on the port: the exact ensemble-average BER at n=100, eps=0.3
    exact = 0.00927103257501793
    cfg = SimulationConfig(channel="BEC", channel_param=0.3, n=100, dv=3,
                           dc=6, decoder="bp", iterations=60,
                           num_tests=64000, batch=3200, codes_per_chunk=100,
                           sampler="raw", max_block_errors=10**9, seed=21,
                           code_mode="ensemble")
    res = mc.run_simulation(cfg, device="cpu")
    assert res.trials_per_code == 32 and res.code_bit_errors_sq > 0
    lo, hi = ber_ci(jax_load_result(save_result(res, str(tmp_path))))
    assert lo <= exact <= hi, (res.bit_error_rate, lo, hi, exact)
    assert (hi - lo) / exact < 0.25


def test_ensemble_run_agrees_with_jax():
    fields = dict(channel="BEC", channel_param=0.40, n=1024, dv=3, dc=6,
                  decoder="bp", iterations=50, num_tests=4096, batch=1024,
                  codes_per_chunk=32, max_block_errors=10**9,
                  code_mode="ensemble", seed=5)
    ours = mc.run_simulation(SimulationConfig(**fields), device="cpu")
    theirs = jmc.run_simulation(JaxConfig(**fields))
    assert ours.num_trials == theirs.num_trials == 4096
    assert ours.trials_per_code == theirs.trials_per_code == 32
    # BER over trials, each contributing its erased fraction (see
    # test_torch_montecarlo.py::test_run_simulation_agrees_with_jax)
    for errors_a, errors_b in ((ours.block_errors, theirs.block_errors),
                               (ours.bit_errors / 1024,
                                theirs.bit_errors / 1024)):
        lo_a, hi_a = wilson(errors_a, 4096, alpha=0.01)
        lo_b, hi_b = wilson(errors_b, 4096, alpha=0.01)
        assert lo_a <= hi_b and lo_b <= hi_a, (errors_a, errors_b)
    assert 0.05 <= ours.block_error_rate <= 0.14


def test_ensemble_run_is_deterministic_and_seeded():
    a = mc.run_simulation(_cfg(), device="cpu")
    b = mc.run_simulation(_cfg(), device="cpu")
    assert (a.error_counts_per_iteration, a.block_errors, a.bit_errors,
            a.bit_errors_sq, a.code_bit_errors_sq) == (
        b.error_counts_per_iteration, b.block_errors, b.bit_errors,
        b.bit_errors_sq, b.code_bit_errors_sq)
    assert a.trials_per_code == 64 and a.config.code_mode == "ensemble"
    c = mc.run_simulation(_cfg(seed=4), device="cpu")
    assert c.error_counts_per_iteration != a.error_counts_per_iteration


def test_ensemble_checkpoint_resume_is_bit_identical(tmp_path):
    full = mc.run_simulation(_cfg(num_tests=1024), device="cpu")
    ck = str(tmp_path / "ck.json")
    half = mc.run_simulation(_cfg(num_tests=512, checkpoint_path=ck,
                                  checkpoint_every_chunks=1), device="cpu")
    assert half.num_trials == 512
    with open(ck) as f:
        state = json.load(f)
    assert state["chunk_idx"] == 2 and state["trials_per_code"] == 64
    resumed = mc.run_simulation(_cfg(num_tests=1024, checkpoint_path=ck),
                                device="cpu")
    for field in ("num_trials", "error_counts_per_iteration", "block_errors",
                  "bit_errors", "bit_errors_sq", "code_bit_errors_sq",
                  "trials_per_code"):
        assert getattr(resumed, field) == getattr(full, field), field
    # the same seed and batch at another cluster size: the counters resume,
    # the cluster moment is dropped
    other = mc.run_simulation(_cfg(num_tests=1280, codes_per_chunk=8,
                                   checkpoint_path=ck), device="cpu")
    assert other.num_trials == 1280
    assert other.code_bit_errors_sq is None and other.trials_per_code is None
    # ... and stays dropped when that run's checkpoint is resumed in turn
    again = mc.run_simulation(_cfg(num_tests=1536, codes_per_chunk=8,
                                   checkpoint_path=ck), device="cpu")
    assert again.num_trials == 1536 and again.code_bit_errors_sq is None


def test_cli_mode0_on_cpu(tmp_path, capsys):
    rc = cli.main(["0.40", "512", "20", "96", "3", "6", "0", "7",
                   f"--output-dir={tmp_path}", "--device=cpu"])
    assert rc == 0
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert len(files) == 1
    res = jax_load_result(files[0])
    assert res.config.code_mode == "ensemble" and res.config.seed == 7
    assert res.num_trials == 1024 and res.trials_per_code == 32
    assert res.code_bit_errors_sq is not None
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 14"):
        cli.main(["0.40", "512", "20", "96", "3", "6", "1", "7",
                  f"--output-dir={tmp_path}", "--device=cpu"])
