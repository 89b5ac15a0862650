"""The port's peeling decoder, its R-process experiment, the carried theory
and the peeling Monte Carlo driver against the JAX package.

Codes are sampled by JAX and carried over, and the channel outputs are
drawn with ``jax.random`` and handed to both packages as numpy.  The two
packages choose the degree-1 check of each step from different random
streams (JAX by Gumbel-argmax, the port canonically from Philox), so the
trajectories differ; what does not depend on the order of choices must be
equal exactly: the final unresolved set (the maximal stopping set, also
BP's fixed point), the number of peels (``steps``), ``num_erasures``,
``size_at_failure``, the count of valid evolution entries, ``evolution[0]``
(the initial degree-1 count) and the final 0 of a success.  The parallel
peel, whose rounds are deterministic, equals JAX's bit for bit; the
carried theory equals JAX's to rel 1e-12 (the same float64 arithmetic);
statistics agree within JAX's own bands.  On the CPU P1's wrapper runs its
plain version; the kernel is held to it on the GPU.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code)
from iib_project_ldpc_codes_tpu.ops import BEC
from iib_project_ldpc_codes_tpu.ops import peeling as jpeel
from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed as \
    jax_bernoulli_packed
from iib_project_ldpc_codes_tpu.utils import experiments as jexp
from iib_project_ldpc_codes_tpu.utils import theory as jtheory
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.kernels import build
from iib_project_ldpc_codes_tpu_torch.models.code import (code_from_numpy,
                                                          codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.models.ensemble import code_for_config
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    irregular_code_from_numpy, irregular_codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp, peeling
from iib_project_ldpc_codes_tpu_torch.ops.bitops import philox4x32_10
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils import experiments, theory
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig
from iib_project_ldpc_codes_tpu_torch.utils.results import load_result

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
KINDS = ("regular", "irregular")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _carry_irregular(jcode):
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    carry = irregular_codes_from_numpy if tables[0].ndim == 3 else \
        irregular_code_from_numpy
    return carry(*tables, jcode.n, jcode.m)


@pytest.fixture(scope="module")
def pairs():
    """kind -> (JAX code, the same code in the port): (3,6) at n = 240 and
    the irregular (x/3 + 2x^3/3, x^5) code at n = 96 (tests/test_peeling.py's
    irregular fixture)."""
    jreg = jax_sample_code(jax.random.key(1), 240, 3, 6)
    jirr = jir.IrregularEnsembleSpec.from_lam_rho(96, LAM, RHO).sample(
        jax.random.key(5))
    return {"regular": (jreg, code_from_numpy(np.asarray(jreg.chk_to_var),
                                              240, 3, 6)),
            "irregular": (jirr, _carry_irregular(jirr))}


def _rx(n, eps, seed, trials=None):
    shape = (n,) if trials is None else (trials, n)
    return np.array(BEC(eps).transmit(jax.random.key(seed),
                                      jnp.zeros(shape, jnp.int32)))


def _assert_choice_free_fields_equal(got, want):
    """Everything that does not depend on the order of choices."""
    assert np.array_equal(got.unresolved.numpy(), np.asarray(want.unresolved))
    for f in ("steps", "num_erasures", "size_at_failure", "success"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    g, w = got.one_degree_evolution.numpy(), \
        np.asarray(want.one_degree_evolution)
    assert g.shape == w.shape
    assert np.array_equal((g >= 0).sum(-1), (w >= 0).sum(-1))
    assert np.array_equal(g[..., 0], w[..., 0])
    # a success ends in the reference's final 0, then -1 padding
    steps = got.steps.numpy()
    for evo, s, ok in zip(g.reshape(-1, g.shape[-1]), steps.reshape(-1),
                          got.success.numpy().reshape(-1)):
        assert (evo[s:] == -1).all()
        assert (evo[s - 1] == 0) == bool(ok) if s else True
        assert (evo[:s - 1] > 0).all() if s else True


# ---------------------------------------------------------------------------
# The sequential peel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eps", [0.3, 0.42])
def test_peel_equals_jax_where_the_choices_do_not_matter(pairs, kind, eps):
    jcode, code = pairs[kind]
    jfn = jpeel.peel_decode if kind == "regular" else \
        jpeel.peel_decode_irregular
    fn = peeling.peel_decode if kind == "regular" else \
        peeling.peel_decode_irregular
    bp = erasure_bp.bp_decode if kind == "regular" else \
        erasure_bp.bp_decode_irregular
    outcomes = set()
    for s in range(4):
        rx = _rx(code.n, eps, 10 + s)
        want = jfn(jcode, jnp.asarray(rx), jax.random.key(3 + s))
        got = fn(code, torch.from_numpy(rx), seed=s)
        _assert_choice_free_fields_equal(got, want)
        # the final set is BP's fixed point (n rounds reach it)
        decoded, _, _ = bp(code, torch.from_numpy(rx), code.n)
        assert torch.equal(got.unresolved, decoded == 2)
        outcomes.add(bool(got.success))
    if eps == 0.3:
        assert outcomes == {True}


@pytest.mark.parametrize("kind", KINDS)
def test_batch_on_one_code_and_on_a_batch_of_codes(pairs, kind):
    jcode, code = pairs[kind]
    rx = _rx(code.n, 0.42, 21, trials=6)
    jfn = jpeel.peel_decode if kind == "regular" else \
        jpeel.peel_decode_irregular
    got = peeling.peel_decode_batch(code, torch.from_numpy(rx), seed=4)
    for t in range(6):
        want = jfn(jcode, jnp.asarray(rx[t]), jax.random.key(t))
        _assert_choice_free_fields_equal(
            peeling.PeelResult(got.unresolved[t],
                               got.one_degree_evolution[t], got.steps[t],
                               got.num_erasures[t]), want)
    # a batch of codes: trial t on code t
    if kind == "regular":
        jcodes = [jax_sample_code(jax.random.key(40 + t), 120, 3, 6)
                  for t in range(4)]
        tables = np.stack([np.asarray(c.chk_to_var) for c in jcodes])
        codes = codes_from_numpy(tables, 120, 3, 6)
        single = [code_from_numpy(t, 120, 3, 6) for t in tables]
    else:
        spec = jir.IrregularEnsembleSpec.from_lam_rho(96, LAM, RHO)
        jcodes = [spec.sample(jax.random.key(40 + t)) for t in range(4)]
        codes = irregular_codes_from_numpy(
            *[np.stack([np.asarray(getattr(c, f)) for c in jcodes])
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")],
            96, jcodes[0].m)
        single = [_carry_irregular(c) for c in jcodes]
    rx = _rx(codes.n, 0.42, 22, trials=4)
    batch = peeling.peel_decode_batch(codes, torch.from_numpy(rx), seed=9)
    for t in range(4):
        want = jfn(jcodes[t], jnp.asarray(rx[t]), jax.random.key(t))
        _assert_choice_free_fields_equal(
            peeling.PeelResult(batch.unresolved[t],
                               batch.one_degree_evolution[t],
                               batch.steps[t], batch.num_erasures[t]), want)
        # trial t of the batch is trial t of a one-code batch's stream
        alone = peeling.peel_decode_batch(single[t], torch.from_numpy(
            np.repeat(rx[t:t + 1], t + 1, 0)), seed=9)
        assert torch.equal(alone.one_degree_evolution[t],
                           batch.one_degree_evolution[t])


def test_trajectory_depends_only_on_seed_and_trial(pairs):
    _, code = pairs["regular"]
    rx = torch.from_numpy(_rx(code.n, 0.42, 30, trials=8))
    a = peeling.peel_decode_batch(code, rx, seed=12)
    b = peeling.peel_decode_batch(code, rx, seed=12)
    c = peeling.peel_decode_batch(code, rx[:3], seed=12)
    d = peeling.peel_decode_batch(code, rx, seed=13)
    assert torch.equal(a.one_degree_evolution, b.one_degree_evolution)
    assert torch.equal(a.one_degree_evolution[:3], c.one_degree_evolution)
    assert not torch.equal(a.one_degree_evolution, d.one_degree_evolution)
    assert torch.equal(a.unresolved, d.unresolved)       # choice-free
    one = peeling.peel_decode(code, rx[0], seed=12)
    assert torch.equal(one.one_degree_evolution, a.one_degree_evolution[0])
    plain = peeling.peel_decode_batch_plain(code, rx, seed=12)
    assert torch.equal(plain.one_degree_evolution, a.one_degree_evolution)


def test_rank_select_picks_the_kth_degree_one_check():
    """With many degree-1 checks the first peel resolves the first
    unresolved variable of the k-th degree-1 check in check order, k =
    floor(r64 * count / 2^64) from Philox at (t=0, trial)."""
    jcode = jax_sample_code(jax.random.key(2), 240, 3, 6)
    code = code_from_numpy(np.asarray(jcode.chk_to_var), 240, 3, 6)
    rx = _rx(240, 0.08, 7, trials=16)
    res = peeling.peel_decode_batch(code, torch.from_numpy(rx), seed=77,
                                    max_steps=1)
    chk = np.asarray(jcode.chk_to_var)
    key = peeling.peel_key(77)
    for t in range(16):
        erased = rx[t] == 2
        deg = erased[chk].sum(1)
        ones = np.nonzero(deg == 1)[0]
        assert len(ones) > 10
        c0, c1, _, _ = philox4x32_10((0, t, 0, 0), key)
        r64 = (int(c1) << 32) | int(c0)
        k = (r64 * len(ones)) >> 64
        row = chk[ones[k]]
        v = row[np.argmax(erased[row])]
        assert int(res.one_degree_evolution[t, 0]) == len(ones)
        want = erased.copy()
        want[v] = False
        assert np.array_equal(res.unresolved[t].numpy(), want)


def test_no_erasures_and_max_steps(pairs):
    jcode, code = pairs["regular"]
    zero = torch.zeros(code.n, dtype=torch.int32)
    res = peeling.peel_decode(code, zero, seed=1)
    want = jpeel.peel_decode(jcode, jnp.zeros(code.n, jnp.int32),
                             jax.random.key(0))
    _assert_choice_free_fields_equal(res, want)
    assert int(res.steps) == 1 and int(res.one_degree_evolution[0]) == 0
    rx = _rx(code.n, 0.3, 12)
    cut = peeling.peel_decode(code, torch.from_numpy(rx), seed=1,
                              max_steps=5)
    jcut = jpeel.peel_decode(jcode, jnp.asarray(rx), jax.random.key(0),
                             max_steps=5)
    # after a cut which variables are left depends on the choices; how
    # many does not
    for f in ("steps", "num_erasures", "remaining", "size_at_failure"):
        assert int(getattr(cut, f)) == int(getattr(jcut, f)), f
    assert cut.one_degree_evolution.shape == (6,) and int(cut.steps) == 5
    assert int(cut.one_degree_evolution[0]) == int(
        jcut.one_degree_evolution[0]) and int(cut.one_degree_evolution[5]) \
        == -1


def test_peel_inputs_are_checked(pairs):
    _, code = pairs["regular"]
    _, irr = pairs["irregular"]
    with pytest.raises(TypeError, match="single-codeword"):
        peeling.peel_decode(irr, torch.zeros(irr.n, dtype=torch.int32))
    with pytest.raises(TypeError, match="single-codeword"):
        peeling.peel_decode_irregular(code, torch.zeros(code.n,
                                                        dtype=torch.int32))
    with pytest.raises(ValueError, match="channel outputs"):
        peeling.peel_decode_batch(code, torch.zeros((2, code.n + 1)))
    chk, var = code.chk_to_var, code.var_to_chk
    with pytest.raises(ValueError, match="erased"):
        peeling.peel_sequential(chk, var, torch.zeros((2, code.n)), code.n,
                                code.m, 0, 5)
    with pytest.raises(ValueError, match="do not fit"):
        peeling.peel_sequential(chk[None].expand(3, -1, -1).contiguous(),
                                var[None].expand(3, -1, -1).contiguous(),
                                torch.zeros((2, code.n), dtype=torch.bool),
                                code.n, code.m, 0, 5)


def test_kernel_is_declared_and_sourced():
    assert "peel_sequential.cu" in {p.name for p in build.source_files()}
    assert "ldpc_peel_sequential" in build.SIGNATURES
    source = (build.SOURCE_DIR / "peel_sequential.cu").read_text()
    assert 'extern "C" int ldpc_peel_sequential(' in source
    assert peeling.peel_sequential.launches == 0


# ---------------------------------------------------------------------------
# The parallel peel (K2/K3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 0.3, 0.42, 0.5])
def test_parallel_peel_equals_jax(pairs, eps):
    jcode, code = pairs["regular"]
    for s in range(3):
        rx = _rx(code.n, eps, 50 + s)
        ju, jr = jpeel.peel_decode_parallel(jcode, jnp.asarray(rx))
        got, rounds = peeling.peel_decode_parallel(code, torch.from_numpy(rx))
        assert np.array_equal(got.numpy(), np.asarray(ju))
        assert rounds == int(jr)
        plain, prounds = peeling.peel_decode_parallel_plain(
            code, torch.from_numpy(rx))
        assert torch.equal(plain, got) and prounds == rounds
    for cap in (1, 2):
        ju, jr = jpeel.peel_decode_parallel(jcode, jnp.asarray(rx),
                                            max_rounds=cap)
        got, rounds = peeling.peel_decode_parallel(
            code, torch.from_numpy(rx), max_rounds=cap)
        assert np.array_equal(got.numpy(), np.asarray(ju))
        assert rounds == int(jr)


# ---------------------------------------------------------------------------
# Experiments
# ---------------------------------------------------------------------------

def test_scaling_experiment_matches_jax():
    got = experiments.peeling_scaling_experiment(120, 3, 6, 0.35,
                                                 repeats=40, seed=3,
                                                 device="cpu")
    want = jexp.peeling_scaling_experiment(120, 3, 6, 0.35, repeats=40,
                                           seed=3, backend="jax")
    assert got.critical_point == want.critical_point
    assert np.allclose(got.drift, want.drift, rtol=1e-12, atol=0)
    assert math.isclose(got.expected_at_critical, want.expected_at_critical,
                        rel_tol=1e-12)
    assert math.isclose(got.variance_at_critical, want.variance_at_critical,
                        rel_tol=1e-12)
    assert abs(got.failure_rate - want.failure_rate) < 0.35
    assert len(got.trajectories) == 40 and got.repeats == 40
    for traj, size in zip(got.trajectories, got.sizes_at_failure):
        # reversed, NaN-padded: the final entry is the initial count
        assert (size > 0) == bool(np.isnan(traj[0]))
        assert not np.isnan(traj[-1])
    assert got.num_failures_at_critical + len(got.critical_distribution) \
        == 40
    again = experiments.peeling_scaling_experiment(120, 3, 6, 0.35,
                                                   repeats=40, seed=3,
                                                   device="cpu")
    assert all(np.array_equal(a, b, equal_nan=True)
               for a, b in zip(got.trajectories, again.trajectories))


def test_scaling_experiment_on_a_fixed_code(pairs):
    _, code = pairs["regular"]
    res = experiments.peeling_scaling_experiment(240, 3, 6, 0.3, repeats=8,
                                                 seed=1, code=code,
                                                 device="cpu")
    assert res.failure_rate == 0.0 and len(res.trajectories) == 8


def test_irregular_drift_tracks_trajectories():
    """tests/test_peeling.py's check: the mean R-process tracks the
    irregular analytic drift at an early checkpoint."""
    n, eps = 2048, 0.40
    res = experiments.peeling_scaling_experiment(n, 0, 0, eps, repeats=32,
                                                 seed=11, lam=LAM, rho=RHO,
                                                 device="cpu")
    want = jexp.peeling_scaling_experiment(n, 0, 0, eps, repeats=1, seed=11,
                                           lam=LAM, rho=RHO, backend="jax")
    assert res.critical_point == want.critical_point
    assert np.allclose(res.drift, want.drift, rtol=1e-12, atol=0)
    assert (res.dv, res.dc) == (want.dv, want.dc)
    u0 = int(0.9 * n * eps)
    vals = [t[u0] for t in res.trajectories
            if len(t) > u0 and not np.isnan(t[u0])]
    assert len(vals) >= 24
    mean, se = np.mean(vals), np.std(vals, ddof=1) / np.sqrt(len(vals))
    assert abs(mean - res.drift[u0]) < 4 * se + 0.02 * res.drift[u0]


def test_native_backend_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 14b"):
        experiments.peeling_scaling_experiment(120, 3, 6, 0.35, repeats=2,
                                               backend="native",
                                               device="cpu")
    with pytest.raises(ValueError, match="backend"):
        experiments.peeling_scaling_experiment(120, 3, 6, 0.35, repeats=2,
                                               backend="jax", device="cpu")


def test_bp_decoding_paths_equal_jax(pairs):
    jcode, code = pairs["regular"]
    want = jexp.bp_decoding_paths(240, 3, 6, 0.42, 30, trials=128, seed=0,
                                  code=jcode)
    # JAX draws its plane from split(key(seed))[1]; hand the same over
    k_noise = jax.random.split(jax.random.key(0))[1]
    erased = jax_bernoulli_packed(k_noise, 0.42, (240, 4))
    got = experiments.bp_decoding_paths(
        240, 3, 6, 0.42, 30, trials=128, code=code,
        erased=torch.from_numpy(np.asarray(erased).view(np.int32).copy()),
        device="cpu")
    for f in ("trajectories", "failed", "mean_path", "mean_path_failed",
              "mean_path_success", "de_path"):
        assert np.array_equal(getattr(got, f), getattr(want, f),
                              equal_nan=f != "failed"), f
    assert got.failure_rate == want.failure_rate
    assert 0 < got.failure_rate < 1


def test_exports_have_jax_names_and_fields(tmp_path, pairs):
    _, code = pairs["regular"]
    paths = experiments.bp_decoding_paths(240, 3, 6, 0.42, 20, trials=64,
                                          code=code, device="cpu")
    want_paths = jexp.bp_decoding_paths(240, 3, 6, 0.42, 20, trials=64,
                                        code=pairs["regular"][0])
    a = experiments.export_bp_decoding_paths(paths, str(tmp_path / "port"))
    b = jexp.export_bp_decoding_paths(want_paths, str(tmp_path / "jax"))
    assert os.path.basename(a) == os.path.basename(b)
    with open(a) as f, open(b) as g:
        assert json.load(f).keys() == json.load(g).keys()
    res = experiments.peeling_scaling_experiment(120, 3, 6, 0.35, repeats=4,
                                                 device="cpu")
    jres = jexp.peeling_scaling_experiment(120, 3, 6, 0.35, repeats=4,
                                           backend="jax")
    a = experiments.export_peeling_paths(res, str(tmp_path / "port"))
    b = jexp.export_peeling_paths(jres, str(tmp_path / "jax"))
    assert os.path.basename(a) == os.path.basename(b)
    with open(a) as f, open(b) as g:
        da, db = json.load(f), json.load(g)
    assert da.keys() == db.keys()
    assert da["drift"] == db["drift"] and da["x"] == db["x"]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    csv = "peeling_decoder_paths_0.35.csv"
    assert (tmp_path / "port" / csv).read_text() == \
        (tmp_path / "jax" / csv).read_text()


def test_waterfall_curves_equal_jax():
    eps = np.linspace(0.35, 0.45, 11)
    for shift in (False, True):
        got = experiments.waterfall_curves([512, 4096], eps,
                                           finite_size_shift=shift)
        want = jexp.waterfall_curves([512, 4096], eps,
                                     finite_size_shift=shift)
        assert got.threshold == want.threshold and got.alpha == want.alpha
        for a, b in zip(got.curves, want.curves):
            assert np.allclose(a, b, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# The carried theory
# ---------------------------------------------------------------------------

THEORY_CASES = [
    ("density_evolution", (0.42, 30, 3, 6)),
    ("density_evolution", (0.40, 50, 4, 8, 1e-6)),
    ("modified_density_evolution", (0.42, 30, 3, 6)),
    ("below_threshold", (0.42, 3, 6)),
    ("below_threshold", (0.44, 3, 6)),
    ("calc_threshold", (3, 6)),
    ("calc_threshold", (4, 8)),
    ("threshold_y", (0.4294, 3, 6)),
    ("threshold_x", (0.4294, 3, 6)),
    ("calculate_alpha", (0.4294, 3, 6)),
    ("_norm_cdf", (np.linspace(-3, 3, 13),)),
    ("waterfall_block_error", (1000, np.linspace(0.35, 0.45, 7))),
    ("waterfall_block_error", (1000, np.linspace(0.35, 0.45, 7), 3, 6,
                               True)),
    ("critical_point_variance", (1000, 0.42, 3, 6)),
    ("peeling_drift_normalized", (0.42, 3, 6, np.linspace(0, 1, 11))),
    ("peeling_drift", (0.42, 3, 6, 1000, np.arange(0, 400, 7))),
    ("irregular_peeling_drift_normalized", (0.42, LAM, RHO,
                                            np.linspace(0, 1, 11))),
    ("_node_poly_val", (LAM, np.linspace(0, 1, 11))),
    ("_invert_node_poly", (LAM, np.linspace(0.1, 0.9, 9))),
    ("irregular_peeling_drift", (0.42, LAM, RHO, 1000, np.arange(0, 400, 7))),
    ("irregular_critical_x", (LAM, RHO)),
    ("irregular_critical_x", (LAM, RHO, 0.44)),
    ("_poly_check", (LAM, "lam")),
    ("_poly_val", (np.asarray(RHO), 0.3)),
    ("irregular_density_evolution", (0.42, LAM, RHO, 40)),
    ("irregular_below_threshold", (0.44, LAM, RHO)),
    ("irregular_threshold", (LAM, RHO)),
    ("irregular_threshold", ([0, 0, 1.0], [0, 0, 0, 0, 0, 1.0], 1e-7)),
    ("node_perspective", (LAM,)),
]


@pytest.mark.parametrize("name, args", THEORY_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(THEORY_CASES)])
def test_theory_equals_jax(name, args):
    got = getattr(theory, name)(*args)
    want = getattr(jtheory, name)(*args)
    if isinstance(want, (bool, np.bool_)):
        assert got == want
    else:
        assert np.allclose(np.asarray(got, float), np.asarray(want, float),
                           rtol=1e-12, atol=0)
        assert np.shape(got) == np.shape(want)
    assert theory.BETA_3_6 == jtheory.BETA_3_6
    assert theory.BETA_3_6_WATERFALL == jtheory.BETA_3_6_WATERFALL


def test_theory_anchors():
    assert abs(theory.calc_threshold(3, 6) - 0.4294375) < 1e-4
    assert abs(theory.calculate_alpha(theory.calc_threshold(3, 6), 3, 6)
               - 0.5595) < 1e-3
    with pytest.raises(ValueError, match="sum to 1"):
        theory._poly_check([0, 0.5], "lam")


# ---------------------------------------------------------------------------
# The Monte Carlo driver and the CLI
# ---------------------------------------------------------------------------

def _peel_cfg(**fields):
    base = dict(channel="BEC", decoder="peeling", channel_param=0.42, n=240,
                batch=256, num_tests=512, max_block_errors=10**9, seed=3,
                code_mode="fixed")
    return SimulationConfig(**{**base, **fields})


@pytest.mark.parametrize("kind", KINDS)
def test_run_peeling_equals_bp_with_n_rounds(pairs, kind):
    _, code = pairs[kind]
    fields = dict(n=code.n) if kind == "regular" else \
        dict(n=code.n, lam=LAM, rho=RHO)
    cfg = _peel_cfg(**fields)
    got = mc.run_simulation(cfg, code, device="cpu")
    bp = mc.run_simulation(_peel_cfg(decoder="bp", iterations=code.n,
                                     **fields), code, device="cpu")
    for f in ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
              "stopped_by"):
        assert getattr(got, f) == getattr(bp, f), f
    assert got.error_rate_per_iteration == []
    assert 0 < got.block_errors < got.num_trials


def _wilson(k, n, z=2.576):
    p = k / n
    d = 1 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return c - h, c + h


def test_run_peeling_agrees_with_jax_statistically(pairs):
    from iib_project_ldpc_codes_tpu.parallel.montecarlo import (
        run_simulation as jax_run_simulation)
    from iib_project_ldpc_codes_tpu.utils.config import (
        SimulationConfig as JaxConfig)

    jcode, code = pairs["regular"]
    fields = dict(channel="BEC", decoder="peeling", channel_param=0.42,
                  n=240, batch=512, num_tests=2048, max_block_errors=10**9,
                  seed=3, code_mode="fixed")
    got = mc.run_simulation(SimulationConfig(**fields), code, device="cpu")
    want = jax_run_simulation(JaxConfig(**fields), jcode)
    lo, hi = _wilson(got.block_errors, got.num_trials)
    jlo, jhi = _wilson(want.block_errors, want.num_trials)
    assert lo <= jhi and jlo <= hi, ((lo, hi), (jlo, jhi))
    assert got.num_trials == want.num_trials == 2048


@pytest.mark.parametrize("irregular", [False, True])
def test_run_peeling_ensemble_mode(irregular):
    fields = dict(lam=LAM, rho=RHO) if irregular else {}
    cfg = _peel_cfg(code_mode="ensemble", **fields)
    a = mc.run_simulation(cfg, None, device="cpu")
    b = mc.run_simulation(cfg, None, device="cpu")
    assert (a.block_errors, a.bit_errors) == (b.block_errors, b.bit_errors)
    assert a.num_trials == 512 and 0 < a.block_errors < 512
    assert a.code_bit_errors_sq is None


def test_run_peeling_stops_on_block_errors():
    cfg = _peel_cfg(code_mode="ensemble", num_tests=10 * 256,
                    max_block_errors=1)
    res = mc.run_simulation(cfg, None, device="cpu")
    assert res.stopped_by == "block_errors" and res.num_trials == 256


def test_make_chunk_fn_refers_peeling_to_its_driver(pairs):
    with pytest.raises(NotImplementedError, match="own host driver"):
        mc.make_chunk_fn(_peel_cfg(), pairs["regular"][1], device="cpu")


@pytest.mark.parametrize("mode", ["fixed", "ensemble"])
def test_cli_runs_a_peeling_config(tmp_path, mode):
    cfg = _peel_cfg(code_mode=mode, n=600)
    path = tmp_path / "peel.json"
    path.write_text(cfg.to_json())
    out = tmp_path / "out"
    assert cli.main(["--config", str(path), f"--output-dir={out}",
                     "--device=cpu"]) == 0
    files = [f for f in os.listdir(out) if f.endswith(".json")]
    res = load_result(str(out / files[0]))
    assert res.config.decoder == "peeling" and res.num_trials == 512
    if mode == "fixed":
        want = mc.run_simulation(cfg, code_for_config(cfg), device="cpu")
        assert (res.block_errors, res.bit_errors) == \
            (want.block_errors, want.bit_errors)
