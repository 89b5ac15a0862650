"""The port's AWGN/BSC soft channels, soft chunks, engine and CLI.

Channel statistics and JAX's LLR arithmetic; chunk statistics against the
JAX package's ``_soft_chunk`` (after its channel) on the same codes and
numpy-drawn LLRs, vmapped over a batch of codes: every integer counter
equal, the squared moments to rel 1e-6 (float64 here, float32 in JAX);
every soft configuration through ``make_chunk_fn``; whole runs held to
the GA threshold as the JAX package's own test is; the CLI on the CPU.
The decoders themselves are held to JAX in ``test_torch_soft_bp.py``.
"""

import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.ops import soft_bp as jsb
from iib_project_ldpc_codes_tpu.ops.channels import AWGN as JaxAWGN, \
    BSC as JaxBSC
from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
from iib_project_ldpc_codes_tpu.utils.results import load_result as \
    jax_load_result
from iib_project_ldpc_codes_tpu.utils.theory import awgn_threshold_sigma_ga
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.models.ensemble import code_for_config
from iib_project_ldpc_codes_tpu_torch.ops import bitops, channels
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig
from test_torch_soft_bp import (MIXED, _batch, _few_threads,  # noqa: F401
                                _llr, _pair)


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------

def test_awgn_channel_statistics_and_oracle():
    sigma = 0.8
    llr = channels.awgn_llr(sigma, (256, 1024), seed=5, offset=3)
    assert llr.dtype == torch.float32 and llr.shape == (256, 1024)
    assert torch.equal(llr, channels.awgn_llr(sigma, (256, 1024), seed=5,
                                              offset=3))
    assert not torch.equal(llr, channels.awgn_llr(sigma, (256, 1024), seed=5,
                                                  offset=4))
    # llr = 2y / sigma^2, y ~ N(1, sigma^2): mean 2/sigma^2, var 4/sigma^2
    count = llr.numel()
    mean, var = float(llr.double().mean()), float(llr.double().var())
    assert abs(mean - 2 / sigma ** 2) < 5 * (4 / sigma ** 2 / count) ** 0.5
    assert abs(var / (4 / sigma ** 2) - 1) < 5 * (2 / count) ** 0.5
    # the raw channel BER is Q(1/sigma)
    ber = float((llr < 0).double().mean())
    q = 0.5 * math.erfc(1 / sigma / math.sqrt(2))
    assert abs(ber - q) < 5 * (q * (1 - q) / count) ** 0.5
    # a ragged size takes the first elements of the same stream
    flat = channels.awgn_llr(sigma, (7,), seed=5, offset=3)
    assert torch.equal(flat, llr.reshape(-1)[:7])
    # the oracle form is JAX's arithmetic
    y = torch.from_numpy(np.random.default_rng(0).normal(1, sigma, 1000)
                         .astype(np.float32))
    ch = channels.AWGN(sigma)
    assert np.array_equal(ch.llr(y).numpy(),
                          np.asarray(JaxAWGN(jnp.float32(sigma))
                                     .llr(jnp.asarray(y.numpy()))))
    assert ch.sigma_from_ebn0_db(1.5, 0.5) == pytest.approx(
        float(JaxAWGN.sigma_from_ebn0_db(1.5, 0.5)), rel=1e-6)
    sent = ch.transmit(torch.ones(50_000, dtype=torch.int32),
                       torch.Generator().manual_seed(1))
    assert abs(float(sent.mean()) + 1) < 5 * sigma / 50_000 ** 0.5


def test_awgn_stream_apart_from_k1():
    # the AWGN key differs from K1's in word 0 and from the sampler's
    k1 = bitops.philox_key(9)
    assert channels.awgn_key(9) == (k1[0] ^ channels.AWGN_KEY_TAG, k1[1])
    z = channels._awgn_normals(8, channels.awgn_key(9), 2, "cpu")
    words = bitops.philox4x32_10((0, 0, 2, 0), channels.awgn_key(9))
    u1 = (int(words[0]) + 0.5) * 2.0 ** -32
    u2 = int(words[1]) * 2.0 ** -32
    r = math.sqrt(-2 * math.log(u1))
    assert float(z[0]) == pytest.approx(r * math.cos(2 * math.pi * u2),
                                        rel=1e-6)
    assert float(z[1]) == pytest.approx(r * math.sin(2 * math.pi * u2),
                                        rel=1e-6)


def test_bsc_llr_of_flips_equals_jax():
    p = 0.07
    flips = bitops.bernoulli_packed(p, (40, 3), seed=1)
    got = channels.BSC(p).llr_of_flips(flips)
    bits = bitops.unpack_bits(flips)
    want = np.asarray(JaxBSC(jnp.float32(p)).llr(jnp.asarray(
        bits.numpy().astype(np.int32))))
    # float64 log rounded once here, float32 log in JAX: one ulp at most
    assert np.allclose(got.numpy(), want, rtol=2 ** -23, atol=0)
    assert torch.equal(got < 0, bits)


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


def _jax_chunk(family, jcode, llr, iters, expurgation):
    """JAX ``_soft_chunk`` after its channel, on the given LLRs."""
    jdec = jsb.soft_bp_decode if family == "regular" else \
        jsb.soft_bp_decode_irregular
    res = jdec(jcode, llr, iters, method="minsum",
               record="total" if expurgation is None else "per_trial")
    return jmc._final_count_stats(res.error_totals, res.bit_errors,
                                  expurgation, traj=res.traj)


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_fixed_chunk_equals_jax(family, expurgation):
    n, iters = 120, 20
    jcode, code, _, _ = _pair(family, n, 1)
    llr = _llr(n, 96, 0.85, seed=8)
    want = _jax_chunk(family, jcode, jnp.asarray(llr), iters, expurgation)
    got = mc._soft_chunk(code, torch.from_numpy(llr), iterations=iters,
                         method="minsum", alpha=1.0, beta=0.0,
                         msg_dtype="float32", expurgation=expurgation)
    _assert_stats_equal(got, want, batched=False)
    if expurgation is not None:
        assert 0 < int(got.excluded) < 96


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_ensemble_chunk_equals_jax_vmap(family, expurgation):
    n, num, cpc, iters = 120, 4, 32, 20
    jcodes, codes = _batch(family, n, num, seed=2)
    llrs = np.stack([_llr(n, cpc, s, seed=20 + g)
                     for g, s in enumerate((0.6, 0.75, 0.85, 0.9))])
    want = jmc._reduce_code_stats(jax.vmap(
        lambda c, l: _jax_chunk(family, c, l, iters, expurgation))(
            jcodes, jnp.asarray(llrs)))
    got = mc._soft_chunk(codes, torch.from_numpy(np.concatenate(list(llrs),
                                                                axis=1)),
                         iterations=iters, method="minsum", alpha=1.0,
                         beta=0.0, msg_dtype="float32",
                         expurgation=expurgation)
    _assert_stats_equal(got, want, batched=True)


# ---------------------------------------------------------------------------
# The engine, whole runs and the CLI
# ---------------------------------------------------------------------------

SOFT_KINDS = [("sumproduct", "float32"), ("sumproduct", "bfloat16"),
              ("minsum", "float32"), ("minsum", "bfloat16"),
              ("minsum", "int8")]


@pytest.mark.parametrize("channel", ["AWGN", "BSC"])
@pytest.mark.parametrize("decoder, dtype", SOFT_KINDS)
@pytest.mark.parametrize("family", ["regular", "irregular"])
def test_make_chunk_fn_runs_every_soft_configuration(channel, decoder, dtype,
                                                     family):
    irr = dict(lam=MIXED[0], rho=MIXED[1]) if family == "irregular" else {}
    for mode in ("fixed", "ensemble"):
        cfg = SimulationConfig(
            channel=channel, decoder=decoder, soft_msg_dtype=dtype,
            channel_param=0.7 if channel == "AWGN" else 0.03, n=120,
            code_mode=mode, iterations=5, batch=128, codes_per_chunk=4,
            seed=3, **irr)
        code = code_for_config(cfg) if mode == "fixed" else None
        stats = mc.make_chunk_fn(cfg, code, device="cpu")(0)
        assert stats.error_totals.shape == (6,)
        assert 0 <= int(stats.bit_errors) <= int(stats.error_totals[0]) * 4
        assert 0 <= int(stats.block_errors) <= 128
        assert (stats.code_bit_errors_sq is None) == (mode == "fixed")


def test_soft_chunks_are_deterministic_and_channel_counts_right():
    cfg = SimulationConfig(channel="AWGN", decoder="minsum", channel_param=0.8,
                           n=240, code_mode="ensemble", iterations=10,
                           batch=256, codes_per_chunk=8, seed=5)
    fn = mc.make_chunk_fn(cfg, None, device="cpu")
    a, b, c = fn(0), fn(0), fn(1)
    assert torch.equal(a.error_totals, b.error_totals)
    assert not torch.equal(a.error_totals, c.error_totals)
    # the round-0 count is the channel's: Q(1/sigma) of the bits
    q = 0.5 * math.erfc(1 / 0.8 / math.sqrt(2))
    count = 240 * 256
    assert abs(int(a.error_totals[0]) / count - q) < 5 * (q / count) ** 0.5
    bsc = SimulationConfig(channel="BSC", decoder="minsum", channel_param=0.05,
                           n=240, code_mode="fixed", iterations=10, batch=256,
                           seed=5)
    flips = bitops.bernoulli_packed(0.05, (240, 8), seed=5, offset=0)
    stats = mc.make_chunk_fn(bsc, code_for_config(bsc), device="cpu")(0)
    assert int(stats.error_totals[0]) == int(bitops.total_popcount(flips))


def test_awgn_ensemble_run_brackets_the_ga_threshold():
    # tests/test_gallager_soft.py::test_awgn_mc_brackets_ga_threshold
    thr = awgn_threshold_sigma_ga(3, 6)
    assert thr == pytest.approx(0.8747, abs=1e-3)

    def run(sigma, trials):
        return mc.run_simulation(SimulationConfig(
            channel="AWGN", channel_param=sigma, n=1024, dv=3, dc=6,
            decoder="sumproduct", iterations=60, num_tests=trials, batch=256,
            max_block_errors=10**9, seed=19, code_mode="ensemble"),
            device="cpu")

    # below it a few failed frames carry the BER (~1e-3 with 2-4% FER), so
    # the lower point takes 2048 trials to keep its spread under the bound
    lo, hi = run(thr - 0.08, 2048), run(thr + 0.10, 512)
    assert lo.bit_error_rate < 2e-3
    assert hi.bit_error_rate > 0.01
    assert lo.trials_per_code == 32 and lo.code_bit_errors_sq is not None


def test_cli_soft_configs_on_cpu(tmp_path):
    for name, fields in (
            ("awgn_fixed", dict(channel="AWGN", decoder="sumproduct",
                                channel_param=0.7, code_mode="fixed")),
            ("bsc_int8_irregular", dict(
                channel="BSC", decoder="minsum", soft_msg_dtype="int8",
                channel_param=0.03, lam=MIXED[0], rho=MIXED[1],
                code_mode="ensemble", codes_per_chunk=8, expurgation=1))):
        cfg = SimulationConfig(n=120, iterations=20, num_tests=512, batch=256,
                               max_block_errors=10**9, seed=3, **fields)
        path = tmp_path / f"{name}.json"
        path.write_text(cfg.to_json())
        out = tmp_path / name
        assert cli.main(["--config", str(path), f"--output-dir={out}",
                         "--device=cpu"]) == 0
        res = jax_load_result(glob.glob(os.path.join(str(out), "*.json"))[0])
        assert res.config.channel == cfg.channel and res.num_trials == 512
        rates = res.error_rate_per_iteration
        assert len(rates) == 21 and rates[-1] <= rates[0]
        if cfg.expurgation is not None:
            assert 0 < res.excluded_trials < 512
