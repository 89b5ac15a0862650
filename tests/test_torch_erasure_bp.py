"""The port's erasure-BP decoders against the JAX package on the CPU.

Codes are sampled by JAX and carried over as numpy tables; packed erasure
planes are drawn by JAX and carried over as ``.view(np.int32)``, so both
packages decode the same input and must agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models.ensemble import sample_code as \
    jax_sample_code
from iib_project_ldpc_codes_tpu.ops import erasure_bp as jbp
from iib_project_ldpc_codes_tpu.ops.channels import BEC as JaxBEC, \
    bec_packed_channel as jax_bec_packed_channel
from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp
from iib_project_ldpc_codes_tpu_torch.ops.channels import BEC, ERASURE

N = 256
WORDS = 8


def _codes(n=N, seed=0):
    jcode = jax_sample_code(jax.random.key(100 + seed), n, 3, 6)
    return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, 3, 6)


def _planes(eps, seed, n=N, words=WORDS):
    jplanes = jax_bec_packed_channel(jax.random.key(seed), eps, (n, words))
    return jplanes, torch.from_numpy(np.asarray(jplanes).view(np.int32).copy())


@pytest.mark.parametrize("eps", [0.2, 0.42, 0.6])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_iters", [1, 3, 50])
def test_packed_allzero_matches_jax(eps, seed, max_iters):
    jcode, code = _codes(seed=seed)
    jplanes, planes = _planes(eps, seed)
    want = jbp.bp_decode_packed_allzero(jcode, jplanes, max_iters)
    got = erasure_bp.bp_decode_packed_allzero(code, planes, max_iters)
    assert np.array_equal(got.known.numpy(),
                          np.asarray(want.known).view(np.int32))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    assert np.array_equal(got.failed.numpy(), np.asarray(want.failed))
    assert np.array_equal(got.bit_errors.numpy(),
                          np.asarray(want.bit_errors))
    plain = erasure_bp.bp_decode_packed_allzero_plain(code, planes, max_iters)
    assert torch.equal(plain.known, got.known)
    assert torch.equal(plain.error_totals, got.error_totals)


def test_packed_allzero_nothing_erased_and_zero_budget():
    jcode, code = _codes()
    zeros = torch.zeros((N, WORDS), dtype=torch.int32)
    res = erasure_bp.bp_decode_packed_allzero(code, zeros, 5)
    assert res.iterations == 0 and res.error_totals.tolist() == [0] * 6
    _, planes = _planes(0.4, 3)
    res0 = erasure_bp.bp_decode_packed_allzero(code, planes, 0)
    want = jbp.bp_decode_packed_allzero(
        jcode, jnp.asarray(planes.numpy().view(np.uint32)), 0)
    assert res0.iterations == 0 == int(want.iterations)
    assert res0.error_totals.tolist() == np.asarray(
        want.error_totals).tolist()


@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_check_exactly_one_matches_jax(eps):
    jcode, code = _codes(seed=2)
    jplanes, planes = _planes(eps, 4)
    want, _ = jbp._check_summaries(jcode, None, ~jplanes)
    got = erasure_bp.check_exactly_one(code.chk_to_var, ~planes)
    assert np.array_equal(got.numpy(), np.asarray(want).view(np.int32))


def test_variable_or_update_matches_jax_round():
    jcode, code = _codes(seed=3)
    jplanes, planes = _planes(0.45, 5)
    want = jbp._packed_iteration_allzero(jcode, ~jplanes)
    known = ~planes
    errors = torch.zeros(3, dtype=torch.int32)
    ex = erasure_bp.check_exactly_one(code.chk_to_var, known)
    erasure_bp.variable_or_update(code.var_to_chk, ex, known, errors, 1)
    assert np.array_equal(known.numpy(), np.asarray(want).view(np.int32))
    assert int(errors[1]) == int(jnp.sum(jax.lax.population_count(~want)))
    assert int(errors[0]) == 0 == int(errors[2])


def test_packed_batch_int32_guard():
    with pytest.raises(ValueError, match="2\\^31"):
        erasure_bp._check_packed_batch_bits(10**5, 672)
    erasure_bp._check_packed_batch_bits(10**4, 768)   # the headline fits
    _, code = _codes()
    # the guard fires before any plane is touched (a meta tensor holds none)
    fake = torch.zeros((N, 2**31 // (32 * N)), dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        erasure_bp.bp_decode_packed_allzero(code, fake, 5)


def test_decoder_rejects_bad_planes():
    _, code = _codes()
    with pytest.raises(ValueError, match="rows"):
        erasure_bp.bp_decode_packed_allzero(
            code, torch.zeros((N + 1, 2), dtype=torch.int32), 5)
    with pytest.raises(TypeError, match="int32"):
        erasure_bp.bp_decode_packed_allzero(
            code, torch.zeros((N, 2), dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="contiguous"):
        erasure_bp.check_exactly_one(
            code.chk_to_var, torch.zeros((2, N), dtype=torch.int32).t())
    with pytest.raises(ValueError, match="words"):
        erasure_bp.variable_or_update(
            code.var_to_chk, torch.zeros((code.m, 3), dtype=torch.int32),
            torch.zeros((N, 2), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="slot"):
        erasure_bp.variable_or_update(
            code.var_to_chk, torch.zeros((code.m, 2), dtype=torch.int32),
            torch.zeros((N, 2), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="device"):
        erasure_bp.check_exactly_one(
            code.chk_to_var, torch.zeros((N, 2), dtype=torch.int32,
                                         device="meta"))


@pytest.mark.parametrize("eps", [0.2, 0.45])
@pytest.mark.parametrize("seed", [0, 1])
def test_bp_decode_matches_jax(eps, seed):
    jcode, code = _codes(n=96, seed=seed)
    rng = np.random.default_rng(seed)
    bits = np.zeros(96, np.int32)
    received = np.where(rng.random(96) < eps, ERASURE, bits).astype(np.int32)
    want = jbp.bp_decode(jcode, jnp.asarray(received), 30)
    got = erasure_bp.bp_decode(code, torch.from_numpy(received), 30)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])


def test_bp_decode_nonzero_codeword_matches_jax():
    # a nonzero codeword from the JAX package's systematic encoder
    from iib_project_ldpc_codes_tpu.models.encode import make_encoder
    from iib_project_ldpc_codes_tpu.models.code import dense_parity_check

    jcode, code = _codes(n=96, seed=4)
    enc = make_encoder(h=dense_parity_check(jcode))
    rng = np.random.default_rng(9)
    info = rng.integers(0, 2, enc.k_eff).astype(np.uint8)
    word = enc.encode(info).astype(np.int32)
    assert word.any()
    received = np.where(rng.random(96) < 0.3, ERASURE, word).astype(np.int32)
    want = jbp.bp_decode(jcode, jnp.asarray(received), 30)
    got = erasure_bp.bp_decode(code, torch.from_numpy(received), 30)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_bec_transmit_oracle_rate():
    g = torch.Generator().manual_seed(0)
    out = BEC(0.3).transmit(torch.zeros(20000, dtype=torch.int32), g)
    assert set(out.unique().tolist()) <= {0, ERASURE}
    assert abs(float((out == ERASURE).double().mean()) - 0.3) < 0.02
    jout = JaxBEC(0.3).transmit(jax.random.key(0), jnp.zeros(20000,
                                                             jnp.int32))
    assert abs(float(jnp.mean(jout == 2)) - 0.3) < 0.02
