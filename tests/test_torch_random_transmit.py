"""Random-codeword transmit in the port against the JAX package on the CPU.

Codes are sampled by JAX and carried over; codewords come from the port's
encoder (held equal to JAX's in ``test_torch_encode.py``) and noise from
the port's Philox planes, and both are handed to both packages as numpy.
Tolerances:

  * the value-plane BEC decodes, Gallager-A/B, min-sum (float32) and int8
    min-sum: bit-exact (``val``, ``known``, decisions, ``error_totals``,
    ``iterations``, ``traj``), integer or sign-symmetric arithmetic in
    JAX's order;
  * sum-product: the posteriors to ``SP_ATOL`` and the error totals to
    ``SP_COUNT_TOL`` (XLA's and PyTorch's ``tanh``/``atanh`` round apart,
    ``test_torch_soft_bp.py``);
  * chunk statistics: every integer counter equal, the squared moments to
    rel 1e-6 (float64 here, float32 in JAX).

Whole runs: the port draws a random-transmit chunk's noise from the zero
run's stream, so on the BEC and with Gallager decoding the two runs'
counters are equal at equal seed.  Soft min-sum on the BSC is symmetric in
its messages and posteriors but decides a posterior of exactly 0 as bit 0,
which is right under all-zero transmit and wrong where the codeword holds a
1: the random run counts those ties as errors (the JAX package's decision
rule, ``post < 0``, alike).  AWGN sum-product runs agree within their 99%
intervals.
"""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code, sample_codes as jax_sample_codes)
from iib_project_ldpc_codes_tpu.ops import erasure_bp as jbp
from iib_project_ldpc_codes_tpu.ops import gallager as jg
from iib_project_ldpc_codes_tpu.ops import soft_bp as jsb
from iib_project_ldpc_codes_tpu.ops.bitops import per_trial_counts as \
    jax_per_trial_counts
from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
from iib_project_ldpc_codes_tpu.utils.results import load_result as \
    jax_load_result
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.models import encode
from iib_project_ldpc_codes_tpu_torch.models.code import (code_from_numpy,
                                                          codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.models.ensemble import code_for_config
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    irregular_code_from_numpy)
from iib_project_ldpc_codes_tpu_torch.ops import (bitops, channels,
                                                  erasure_bp, gallager,
                                                  soft_bp)
from iib_project_ldpc_codes_tpu_torch.ops.bitops import unpack_bits
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

N, WORDS, ITERS = 240, 8, 30
LAM, RHO = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]
LAM_GAL = [0, 0, 0.5, 0.5]
SP_ATOL, SP_COUNT_TOL = 0.1, 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pair(family, seed, n=N):
    """(JAX code, port code) of one regular or irregular code."""
    if family == "regular":
        jcode = jax_sample_code(jax.random.key(seed), n, 3, 6)
        return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, 3, 6)
    lam = LAM if family == "irregular" else LAM_GAL
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(n + 12, lam, RHO).sample(
        jax.random.key(seed))
    return jcode, irregular_code_from_numpy(
        *(np.asarray(getattr(jcode, f))
          for f in ("chk_to_var", "var_to_chk", "var_to_sock")),
        jcode.n, jcode.m)


def _tx(code, words, seed):
    planes = encode.code_encoder_planes(code)
    return encode.encode_packed(planes, bitops.info_planes(
        planes.k, words, seed=seed))


def _j(t: torch.Tensor):
    """A port plane as a JAX uint32 (or bool/float) array."""
    if t.dtype == torch.int32:
        return jnp.asarray(t.numpy().view(np.uint32))
    return jnp.asarray(t.numpy())


def _u(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


# ---------------------------------------------------------------------------
# The value-plane BEC decode (table rows 5 and 6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("traj", [False, True])
@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_value_decode_matches_jax(family, traj, eps):
    jcode, code = _pair(family, 1)
    tx = _tx(code, WORDS, 2)
    assert int(bitops.total_popcount(tx)) > 0
    erased = bitops.bernoulli_packed(eps, (code.n, WORDS), seed=3)
    irregular = family == "irregular"
    if traj:
        jfn = jbp.bp_decode_packed_traj_irregular if irregular else \
            jbp.bp_decode_packed_traj
        fn, plain = (erasure_bp.bp_decode_packed_traj_irregular,
                     erasure_bp.bp_decode_packed_traj_irregular_plain) \
            if irregular else (erasure_bp.bp_decode_packed_traj,
                               erasure_bp.bp_decode_packed_traj_plain)
        want, want_traj = jfn(jcode, _j(erased), _j(tx), ITERS)
        got, got_traj = fn(code, erased, tx, ITERS)
        again, again_traj = plain(code, erased, tx, ITERS)
        assert np.array_equal(got_traj.numpy(), np.asarray(want_traj))
        assert torch.equal(again_traj, got_traj)
    else:
        jfn = jbp.bp_decode_packed_irregular if irregular else \
            jbp.bp_decode_packed
        fn, plain = (erasure_bp.bp_decode_packed_irregular,
                     erasure_bp.bp_decode_packed_irregular_plain) \
            if irregular else (erasure_bp.bp_decode_packed,
                               erasure_bp.bp_decode_packed_plain)
        want = jfn(jcode, _j(erased), _j(tx), ITERS)
        got = fn(code, erased, tx, ITERS)
        again = plain(code, erased, tx, ITERS)
    assert np.array_equal(got.val.numpy(), _u(want.val))
    assert np.array_equal(got.known.numpy(), _u(want.known))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    for field in ("val", "known", "error_totals"):
        assert torch.equal(getattr(again, field), getattr(got, field))
    # every resolved bit is the codeword's, and known is the all-zero one's
    assert not ((got.val ^ tx) & got.known).any()
    allzero = (erasure_bp.bp_decode_packed_allzero_irregular if irregular
               else erasure_bp.bp_decode_packed_allzero)(code, erased, ITERS)
    assert torch.equal(allzero.known, got.known)
    assert torch.equal(allzero.error_totals, got.error_totals)


def test_value_decode_batch_matches_jax_vmap():
    num, words = 4, 8
    wpc = words // num
    jcodes = jax_sample_codes(jax.random.key(4), num, N, 3, 6)
    codes = codes_from_numpy(np.asarray(jcodes.chk_to_var), N, 3, 6)
    tx = _tx(codes, words, 5)
    erased = bitops.bernoulli_packed(0.42, (N, words), seed=6)

    def split(t):
        return _j(t).reshape(N, num, wpc).transpose(1, 0, 2)

    want, want_traj = jax.vmap(
        lambda c, e, t: jbp.bp_decode_packed_traj(c, e, t, ITERS))(
        jcodes, split(erased), split(tx))
    got, got_traj = erasure_bp.bp_decode_packed_traj(codes, erased, tx,
                                                     ITERS)
    for field in ("val", "known"):
        joined = np.asarray(getattr(want, field)).transpose(1, 0, 2) \
            .reshape(N, words)
        assert np.array_equal(getattr(got, field).numpy(), _u(joined))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals).sum(0))
    assert np.array_equal(got_traj.numpy(), np.asarray(want_traj)
                          .transpose(1, 0, 2).reshape(ITERS + 1, -1))
    plain, plain_traj = erasure_bp.bp_decode_packed_traj_plain(
        codes, erased, tx, ITERS)
    assert torch.equal(plain.val, got.val) and torch.equal(plain_traj,
                                                           got_traj)


def test_value_kernels_contract():
    _, code = _pair("regular", 0)
    known = torch.zeros((N, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        erasure_bp.check_exactly_one_xor(code.chk_to_var, known, known[:5])
    eo, adopt = erasure_bp.check_exactly_one_xor(code.chk_to_var, known,
                                                 known)
    errors = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot"):
        erasure_bp.variable_or_adopt(code.var_to_chk, eo, adopt, known,
                                     known.clone(), errors, 2)
    with pytest.raises(ValueError, match="tx_bits"):
        erasure_bp.bp_decode_packed(code, known, known[:, :1].contiguous(),
                                    5)


# ---------------------------------------------------------------------------
# Gallager and soft decodes with tx_bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["regular", "irregular_gallager"])
def test_gallager_tx_matches_jax(family):
    jcode, code = _pair(family, 7)
    tx = _tx(code, WORDS, 8)
    flips = bitops.bernoulli_packed(0.04, (code.n, WORDS), seed=9)
    received = tx ^ flips
    jfn, fn, plain = (jg.gallager_decode_packed,
                      gallager.gallager_decode_packed,
                      gallager.gallager_decode_packed_plain) \
        if family == "regular" else \
        (jg.gallager_decode_packed_irregular,
         gallager.gallager_decode_packed_irregular,
         gallager.gallager_decode_packed_irregular_plain)
    want = jfn(jcode, _j(received), ITERS, record="per_trial",
               tx_bits=_j(tx))
    got = fn(code, received, ITERS, record="per_trial", tx_bits=tx)
    assert np.array_equal(got.decided.numpy(), _u(want.decided))
    assert np.array_equal(got.traj.numpy(), np.asarray(want.traj))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    again = plain(code, received, ITERS, record="per_trial", tx_bits=tx)
    assert torch.equal(again.decided, got.decided)
    assert torch.equal(again.traj, got.traj)
    # the codeword shift is exact: the zero run's errors, bit for bit
    zero = fn(code, flips, ITERS, record="per_trial")
    assert torch.equal(zero.decided, got.decided)
    assert torch.equal(zero.traj, got.traj)


@pytest.mark.parametrize("family, method, dtype", [
    ("regular", "minsum", "float32"), ("regular", "sumproduct", "float32"),
    ("irregular", "minsum", "int8")])
def test_soft_tx_matches_jax(family, method, dtype):
    jcode, code = _pair(family, 11)
    cols = 32 * WORDS
    tx = _tx(code, WORDS, 12)
    llr = channels.awgn_llr(0.85, (code.n, cols), seed=13, tx=tx)
    tx_bool = unpack_bits(tx)
    jfn, fn = (jsb.soft_bp_decode, soft_bp.soft_bp_decode) \
        if family == "regular" else (jsb.soft_bp_decode_irregular,
                                     soft_bp.soft_bp_decode_irregular)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "int8": (torch.int8, jnp.int8)}[dtype]
    want = jfn(jcode, _j(llr), 20, method=method, msg_dtype=jdt,
               tx_bits=_j(tx_bool), record="per_trial")
    got = fn(code, llr, 20, method=method, msg_dtype=tdt, tx_bits=tx,
             record="per_trial")
    if method == "minsum":
        assert np.array_equal(got.hard.numpy(), np.asarray(want.hard))
        assert np.array_equal(got.posterior.numpy(),
                              np.asarray(want.posterior))
        assert np.array_equal(got.traj.numpy(), np.asarray(want.traj))
        assert got.iterations == int(want.iterations)
    else:
        assert np.allclose(got.posterior.numpy(), np.asarray(want.posterior),
                           rtol=0, atol=SP_ATOL)
        assert np.abs(got.error_totals.numpy().astype(np.int64)
                      - np.asarray(want.error_totals)).max() <= SP_COUNT_TOL
    assert np.array_equal(got.satisfied.numpy(), np.asarray(want.satisfied))
    # the error planes are decisions ^ tx; the posterior is decision space
    assert torch.equal(got.hard, (got.posterior < 0) ^ tx_bool)
    assert int(got.hard.sum()) < int(tx_bool.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_soft_minsum_bsc_is_symmetric_but_for_ties(dtype):
    """min-sum on the BSC under a codeword shift: the posterior changes
    sign where tx = 1, exactly, so the error planes are the zero run's
    plus the posterior-0 ties where tx = 1 (decided 0)."""
    _, code = _pair("regular", 14)
    tx = _tx(code, WORDS, 15)
    flips = bitops.bernoulli_packed(0.09, (N, WORDS), seed=16)
    bsc = channels.BSC(0.09)
    rounds = 6              # too few to converge: every trial runs them all
    zero = soft_bp.soft_bp_decode(code, bsc.llr_of_flips(flips), rounds,
                                  method="minsum", msg_dtype=dtype)
    shifted = soft_bp.soft_bp_decode(code, bsc.llr_of_flips(flips ^ tx),
                                     rounds, method="minsum", msg_dtype=dtype,
                                     tx_bits=tx)
    assert zero.iterations == shifted.iterations == rounds
    sign = torch.where(unpack_bits(tx), -1.0, 1.0)
    assert torch.equal(shifted.posterior, sign * zero.posterior)
    ties = zero.posterior == 0
    assert int(ties.sum()) > 0
    assert torch.equal(shifted.hard, zero.hard | (ties & unpack_bits(tx)))


# ---------------------------------------------------------------------------
# Chunk statistics against the JAX package's chunk arithmetic
# ---------------------------------------------------------------------------

def _assert_stats(got, error_totals, block, bit, sq):
    assert np.array_equal(got.error_totals.numpy(), np.asarray(error_totals))
    assert int(got.block_errors) == int(block)
    assert int(got.bit_errors) == int(bit)
    assert int(got.excluded) == 0
    assert float(got.bit_errors_sq) == pytest.approx(float(sq), rel=1e-6)


@pytest.mark.parametrize("family", ["regular", "irregular"])
def test_bp_chunk_matches_jax_arithmetic(family):
    jcode, code = _pair(family, 17)
    tx = _tx(code, WORDS, 18)
    erased = bitops.bernoulli_packed(0.45, (code.n, WORDS), seed=19)
    jfn = jbp.bp_decode_packed_irregular if family == "irregular" else \
        jbp.bp_decode_packed
    res = jfn(jcode, _j(erased), _j(tx), ITERS)
    jtx = _j(tx)
    per_trial = jax_per_trial_counts(
        ~res.known | ((res.val ^ jtx) & res.known), axis=0)
    got = mc._bp_chunk(code, erased, iterations=ITERS, expurgation=None,
                       tx=tx)
    _assert_stats(got, res.error_totals, jnp.sum(per_trial > 0),
                  jnp.sum(per_trial),
                  jnp.sum(jnp.square(per_trial.astype(jnp.float32))))
    with pytest.raises(ValueError, match="expurgation"):
        mc._bp_chunk(code, erased, iterations=ITERS, expurgation=1, tx=tx)


def test_gallager_and_soft_chunks_match_jax_arithmetic():
    jcode, code = _pair("regular", 20)
    tx = _tx(code, WORDS, 21)
    flips = bitops.bernoulli_packed(0.05, (N, WORDS), seed=22)
    res = jg.gallager_decode_packed(jcode, _j(tx ^ flips), ITERS,
                                    record="per_trial", tx_bits=_j(tx))
    want = jmc._final_count_stats(res.error_totals, res.bit_errors, None)
    got = mc._gallager_chunk(code, tx ^ flips, iterations=ITERS,
                             threshold=None, expurgation=None, tx=tx)
    _assert_stats(got, want.error_totals, want.block_errors,
                  want.bit_errors, want.bit_errors_sq)
    llr = channels.BSC(0.05).llr_of_flips(tx ^ flips)
    res = jsb.soft_bp_decode(jcode, _j(llr), 20, method="minsum",
                             msg_dtype=jnp.float32,
                             tx_bits=_j(unpack_bits(tx)))
    want = jmc._final_count_stats(res.error_totals, res.bit_errors, None)
    got = mc._soft_chunk(code, llr, iterations=20, method="minsum",
                         alpha=1.0, beta=0.0, msg_dtype="float32",
                         expurgation=None, tx=tx)
    _assert_stats(got, want.error_totals, want.block_errors,
                  want.bit_errors, want.bit_errors_sq)


# ---------------------------------------------------------------------------
# Whole runs: random transmit against zero transmit, the CLI
# ---------------------------------------------------------------------------

COUNTERS = ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
            "code_bit_errors_sq", "trials_per_code",
            "error_counts_per_iteration", "stopped_by")


def _both(mode, **fields):
    kw = dict(n=240, iterations=ITERS, batch=512, num_tests=1024, seed=23,
              code_mode=mode, codes_per_chunk=4, max_block_errors=10**9,
              **fields)
    zero = SimulationConfig(transmit="zero", **kw)
    code = code_for_config(zero) if mode == "fixed" else None
    return (mc.run_simulation(zero, code, device="cpu"),
            mc.run_simulation(SimulationConfig(transmit="random", **kw), code,
                              device="cpu"))


@pytest.mark.parametrize("mode", ["fixed", "ensemble"])
@pytest.mark.parametrize("fields", [
    dict(channel="BEC", decoder="bp", channel_param=0.42),
    dict(channel="BEC", decoder="bp", channel_param=0.45, lam=LAM, rho=RHO),
    dict(channel="BSC", decoder="gallager", channel_param=0.04),
    dict(channel="BSC", decoder="gallager", channel_param=0.05, lam=LAM_GAL,
         rho=RHO, gallager_threshold=2)])
def test_random_run_equals_zero_run(mode, fields):
    zero, random = _both(mode, **fields)
    assert random.config.transmit == "random"
    assert random.bit_errors > 0
    for field in COUNTERS:
        assert getattr(random, field) == getattr(zero, field), field


@pytest.mark.parametrize("mode, dtype", [("fixed", "float32"),
                                         ("ensemble", "int8")])
def test_random_bsc_minsum_run_counts_ties(mode, dtype):
    zero, random = _both(mode, channel="BSC", decoder="minsum",
                         channel_param=0.05, soft_msg_dtype=dtype)
    assert random.block_errors == zero.block_errors > 0
    assert random.bit_errors > zero.bit_errors
    assert random.error_counts_per_iteration[0] == \
        zero.error_counts_per_iteration[0]


def _wilson(k, n, z=2.576):
    p = k / n
    d = 1 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return c - h, c + h


@pytest.mark.parametrize("mode", ["fixed", "ensemble"])
def test_random_awgn_sumproduct_run_within_interval(mode):
    zero, random = _both(mode, channel="AWGN", decoder="sumproduct",
                         channel_param=0.85)
    trials = zero.num_trials
    for a, b in ((zero.block_errors, random.block_errors),
                 (zero.bit_errors / 240, random.bit_errors / 240)):
        lo_a, hi_a = _wilson(a, trials)
        lo_b, hi_b = _wilson(b, trials)
        assert lo_a <= hi_b and lo_b <= hi_a, (a, b)
    assert random.block_errors > 0


def test_cli_random_transmit_config(tmp_path, capsys):
    cfg = SimulationConfig(channel_param=0.42, n=240, iterations=ITERS,
                           num_tests=512, batch=256, max_block_errors=10**9,
                           seed=3, code_mode="fixed", transmit="random")
    path = tmp_path / "random.json"
    path.write_text(cfg.to_json())
    assert '"transmit": "random"' in path.read_text()
    out = tmp_path / "out"
    assert cli.main(["--config", str(path), f"--output-dir={out}",
                     "--device=cpu"]) == 0
    res = jax_load_result(glob.glob(os.path.join(str(out), "*.json"))[0])
    assert res.config.transmit == "random" and res.num_trials == 512
    zero = mc.run_simulation(SimulationConfig(
        **{**cfg.__dict__, "transmit": "zero"}), code_for_config(cfg),
        device="cpu")
    assert res.bit_errors == zero.bit_errors
    assert res.error_counts_per_iteration == zero.error_counts_per_iteration
    assert "wrote" in capsys.readouterr().out


def test_random_transmit_guards_stay_value_errors():
    with pytest.raises(ValueError, match="expurgation"):
        SimulationConfig(transmit="random", expurgation=1)
    with pytest.raises(ValueError, match="edge_sharded"):
        SimulationConfig(transmit="random", code_mode="fixed",
                         edge_sharded=True)
