"""The port's soft-decision BP decoders against the JAX package.

Codes are carried over from JAX (``code_from_numpy``,
``irregular_code_from_numpy``) and channel LLRs are drawn with numpy and
handed to both packages, so both decode the same input.  Tolerances:

  * min-sum in float32 and bfloat16, and int8 min-sum: bit-exact (hard
    decisions, posterior, ``error_totals``, ``iterations``, ``traj``): the
    additions, minima and casts run in JAX's order;
  * sum-product: XLA's CPU ``tanh``/``atanh`` and PyTorch's round apart in
    the last float32 bits, and 2 atanh(x) has slope 2 / (1 - x^2) ~ 1e6 at
    the clip x = 0.999999, where one float32 ulp of a product moves a
    message by up to 0.06 (a bfloat16 message there rounds in steps of
    0.0625).  So the posteriors agree to ``SP_ATOL`` (per message type;
    about 0.06 and 0.375 measured), the decisions, error totals and
    iterations are equal on the cases below, and ``SP_COUNT_TOL`` bounds
    the error totals' difference near the threshold.

Channels, chunks, the engine and the CLI are in ``test_torch_soft_chunks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code, sample_codes as jax_sample_codes)
from iib_project_ldpc_codes_tpu.ops import soft_bp as jsb
from iib_project_ldpc_codes_tpu_torch.models.code import (code_from_numpy,
                                                          codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    irregular_code_from_numpy, irregular_codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.ops import soft_bp

SP_ATOL = {"float32": 0.1, "bfloat16": 0.5}
SP_COUNT_TOL = 8
# variable degrees 2-4, check degrees 5-6: padding on both sides
MIXED = ([0, 0.3, 0.3, 0.4], [0, 0, 0, 0, 0.5, 0.5])
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the plain passes run many small torch ops; one thread pool per xdist
    # worker over all the machine's cores oversubscribes it many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _llr(n, cols, sigma, seed):
    z = np.random.default_rng(seed).standard_normal((n, cols))
    return (2.0 * (1.0 + sigma * z) / sigma ** 2).astype(np.float32)


def _carry_irregular(jcode):
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    if tables[0].ndim == 3:
        return irregular_codes_from_numpy(*tables, jcode.n, jcode.m)
    return irregular_code_from_numpy(*tables, jcode.n, jcode.m)


def _pair(family, n, seed):
    """(JAX code, port code, JAX decoder, port decoder) of one code."""
    if family == "regular":
        jcode = jax_sample_code(jax.random.key(seed), n, 3, 6)
        return (jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, 3, 6),
                jsb.soft_bp_decode, soft_bp.soft_bp_decode)
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(n, *MIXED).sample(
        jax.random.key(seed))
    return (jcode, _carry_irregular(jcode), jsb.soft_bp_decode_irregular,
            soft_bp.soft_bp_decode_irregular)


def _batch(family, n, num, seed):
    if family == "regular":
        jcodes = jax_sample_codes(jax.random.key(seed), num, n, 3, 6)
        return jcodes, codes_from_numpy(np.asarray(jcodes.chk_to_var), n, 3,
                                        6)
    jcodes = jir.IrregularEnsembleSpec.from_lam_rho(n, *MIXED) \
        .sample_batch(jax.random.key(seed), num)
    return jcodes, _carry_irregular(jcodes)


def _decode_both(family, n, llr, iters, seed=1, **kw):
    jcode, code, jdec, dec = _pair(family, n, seed)
    jkw = dict(kw)
    if "msg_dtype" in kw:
        kw["msg_dtype"], jkw["msg_dtype"] = DTYPES[kw["msg_dtype"]]
    want = jdec(jcode, jnp.asarray(llr), iters, **jkw)
    got = dec(code, torch.from_numpy(llr), iters, **kw)
    return got, want


def _assert_same_decode(got, want, record):
    assert np.array_equal(got.hard.numpy(), np.asarray(want.hard))
    assert np.array_equal(got.posterior.numpy(), np.asarray(want.posterior))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    assert np.array_equal(got.satisfied.numpy(), np.asarray(want.satisfied))
    assert np.array_equal(got.bit_errors.numpy(), np.asarray(want.bit_errors))
    assert np.array_equal(got.failed.numpy(), np.asarray(want.failed))
    if record == "per_trial":
        assert np.array_equal(got.traj.numpy(), np.asarray(want.traj))
    else:
        assert got.traj is None


# ---------------------------------------------------------------------------
# The check updates alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method, alpha, beta, dtype", [
    ("minsum", 1.0, 0.0, "float32"), ("minsum", 0.8, 0.5, "float32"),
    ("minsum", 1.0, 0.0, "int16"), ("sumproduct", 1.0, 0.0, "float32")])
def test_check_updates_equal_jax(method, alpha, beta, dtype):
    rng = np.random.default_rng(3)
    if dtype == "int16":
        planes = [rng.integers(-254, 255, (40, 32)).astype(np.int16)
                  for _ in range(6)]
    else:
        planes = [np.clip(rng.normal(0, 8, (40, 32)), -30, 30)
                  .astype(np.float32) for _ in range(6)]
        planes[2][0, :4] = 0.0                   # ties and zeros
        planes[3][0, :4] = 0.0
    jp = [jnp.asarray(p) for p in planes]
    tp = [torch.from_numpy(p) for p in planes]
    if method == "sumproduct":
        want = jsb._check_update_sumproduct(jp)
        got = soft_bp._check_update_sumproduct(tp)
        for g, w in zip(got, want):
            assert np.allclose(g.numpy(), np.asarray(w),
                               atol=SP_ATOL["float32"], rtol=0)
        return
    cap = 127 if dtype == "int16" else None
    want = jsb._check_update_minsum(jp, alpha, beta, mag_cap=cap)
    got = soft_bp._check_update_minsum(tp, alpha, beta, mag_cap=cap)
    for g, w in zip(got, want):
        assert g.dtype == tp[0].dtype
        assert np.array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Whole decodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("record", ["total", "per_trial"])
def test_int8_minsum_equals_jax(family, record):
    n = 240
    llr = _llr(n, 64, 0.75, seed=1)
    got, want = _decode_both(family, n, llr, 20, method="minsum",
                             msg_dtype="int8", record=record)
    _assert_same_decode(got, want, record)


@pytest.mark.parametrize("family", ["regular", "irregular"])
def test_int8_budgets_and_early_stop_equal_jax(family):
    # the stop rule is not absorbing: every budget up to one past the stop,
    # and max_iters = 0 (the quantised channel count everywhere), must
    # give JAX's planes and counts
    n = 240
    llr = _llr(n, 32, 0.55, seed=2)
    full, _ = _decode_both(family, n, llr, 30, method="minsum",
                           msg_dtype="int8")
    stop = full.iterations
    assert 0 < stop < 30
    for budget in sorted({0, 1, stop - 1, stop, stop + 1}):
        got, want = _decode_both(family, n, llr, budget, method="minsum",
                                 msg_dtype="int8", record="per_trial")
        _assert_same_decode(got, want, "per_trial")
    # the quantised count: small negative LLRs round to 0 and do not count
    assert int(got.error_totals[0]) <= int((llr < 0).sum())


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha, beta", [(1.0, 0.0), (0.8, 0.0), (1.0, 0.5)])
def test_float_minsum_equals_jax(family, dtype, alpha, beta):
    n = 240
    llr = _llr(n, 64, 0.75, seed=4)
    got, want = _decode_both(family, n, llr, 20, method="minsum",
                             alpha=alpha, beta=beta, msg_dtype=dtype,
                             record="per_trial")
    _assert_same_decode(got, want, "per_trial")


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sumproduct_close_to_jax(family, dtype):
    n = 240
    # far below the threshold every trial converges: equal decisions,
    # counts and iterations, posteriors to SP_ATOL
    low = _llr(n, 64, 0.55, seed=5)
    got, want = _decode_both(family, n, low, 20, method="sumproduct",
                             msg_dtype=dtype)
    assert got.iterations == int(want.iterations) < 20
    assert np.array_equal(got.hard.numpy(), np.asarray(want.hard))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert np.allclose(got.posterior.numpy(), np.asarray(want.posterior),
                       atol=SP_ATOL[dtype], rtol=0)
    # near it the rounding differences grow round by round; the error
    # series stay within SP_COUNT_TOL decisions
    near = _llr(n, 64, 0.80, seed=6)
    got, want = _decode_both(family, n, near, 15, method="sumproduct",
                             msg_dtype=dtype)
    diff = np.abs(got.error_totals.numpy().astype(np.int64)
                  - np.asarray(want.error_totals))
    assert diff.max() <= SP_COUNT_TOL
    assert got.error_totals[0] == int(want.error_totals[0])


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_batched_decode_stops_each_code_on_its_own_round(family, dtype):
    n, num, cpc, iters = 240, 4, 32, 25
    jcodes, codes = _batch(family, n, num, seed=3)
    # per-code noise levels so that the codes stop on different rounds
    llrs = [_llr(n, cpc, s, seed=10 + g)
            for g, s in enumerate((0.45, 0.55, 0.62, 0.85))]
    tdt, jdt = DTYPES[dtype]
    jdec = jsb.soft_bp_decode if family == "regular" else \
        jsb.soft_bp_decode_irregular
    dec = soft_bp.soft_bp_decode if family == "regular" else \
        soft_bp.soft_bp_decode_irregular
    got = dec(codes, torch.from_numpy(np.concatenate(llrs, axis=1)), iters,
              method="minsum", msg_dtype=tdt, record="per_trial")
    totals, its = np.zeros(iters + 1, np.int64), []
    for g in range(num):
        want = jdec(jax.tree.map(lambda x: x[g], jcodes),
                    jnp.asarray(llrs[g]), iters, method="minsum",
                    msg_dtype=jdt, record="per_trial")
        cols = slice(g * cpc, (g + 1) * cpc)
        assert np.array_equal(got.hard[:, cols].numpy(),
                              np.asarray(want.hard))
        assert np.array_equal(got.posterior[:, cols].numpy(),
                              np.asarray(want.posterior))
        assert np.array_equal(got.traj[:, cols].numpy(),
                              np.asarray(want.traj))
        assert np.array_equal(got.satisfied[cols].numpy(),
                              np.asarray(want.satisfied))
        totals += np.asarray(want.error_totals)
        its.append(int(want.iterations))
    assert len(set(its)) > 2
    assert got.code_iterations.tolist() == its
    assert got.iterations == max(its)
    assert got.error_totals.tolist() == totals.tolist()


def test_plain_decoders_equal_the_wrapped_ones_on_cpu():
    for family in ("regular", "irregular"):
        _, code, _, dec = _pair(family, 120, 2)
        plain = soft_bp.soft_bp_decode_plain if family == "regular" else \
            soft_bp.soft_bp_decode_irregular_plain
        llr = torch.from_numpy(_llr(120, 32, 0.8, seed=7))
        a = dec(code, llr, 10, method="minsum", msg_dtype=torch.bfloat16)
        b = plain(code, llr, 10, method="minsum", msg_dtype=torch.bfloat16)
        assert torch.equal(a.posterior, b.posterior)
        assert torch.equal(a.error_totals, b.error_totals)


def test_soft_decoder_contract_errors():
    _, code, _, dec = _pair("regular", 96, 0)
    llr = torch.ones((96, 32))
    # tx_bits is the packed codeword plane, not JAX's bool[n, B]
    with pytest.raises(ValueError, match="tx_bits"):
        dec(code, llr, 5, tx_bits=llr > 0)
    zeros = torch.zeros((96, 1), dtype=torch.int32)
    assert torch.equal(dec(code, llr, 5, tx_bits=zeros).error_totals,
                       dec(code, llr, 5).error_totals)
    with pytest.raises(ValueError, match="record"):
        dec(code, llr, 5, record="bogus")
    with pytest.raises(ValueError, match="minsum"):
        dec(code, llr, 5, method="sumproduct", msg_dtype=torch.int8)
    with pytest.raises(ValueError, match="alpha"):
        dec(code, llr, 5, method="minsum", alpha=0.8, msg_dtype=torch.int8)
    with pytest.raises(ValueError, match="llr"):
        dec(code, llr[:90], 5)
    with pytest.raises(TypeError, match="irregular"):
        soft_bp.soft_bp_decode_irregular(code, llr, 5)
    res = dec(code, llr, 5)
    assert res.iterations == 1 and res.error_totals.tolist() == [0] * 6
    assert bool(res.satisfied.all())
