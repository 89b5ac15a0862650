"""The port's irregular (lambda, rho) codes against the JAX package.

Degree sequences and socket maps are numpy in both packages and must be
equal.  Codes sampled by JAX are carried over with
``irregular_code_from_numpy`` / ``irregular_codes_from_numpy`` and planes
drawn by JAX are handed over as numpy, so the port's packed decode, its
oracle and its chunk statistics run on the same input as JAX's and must
agree: planes, counters, ``error_totals`` and ``iterations`` exactly, the
two squared moments to rel 1e-6 (float64 here, float32 in JAX).  The
port's batch sampler draws from its own Philox stream, so it is held to an
independent sequential version of that stream, to the regular sampler on
the degenerate spec, and to the structure of the ensemble; whole runs are
held to the BEC threshold of the ensemble.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.ops import erasure_bp as jbp
from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed as \
    jax_bernoulli_packed
from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig as \
    JaxConfig
from iib_project_ldpc_codes_tpu.utils.results import load_result as \
    jax_load_result
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    IrregularEnsembleSpec, irregular_code_from_numpy,
    irregular_codes_from_numpy, validate_irregular_code)
from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

# the repository's rate-1/2 pair (tests/test_irregular.py): half the
# variables degree 2, half degree 4, checks degree 6; eps* = 0.45265
LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
EPS_STAR = 0.45265
MIXED = ([0, 0, 0.5, 0.5], [0, 0, 0, 0, 0.5, 0.5])   # dv 3/4, dc 5/6


def _carry(jcode):
    """A JAX IrregularLDPCCode (one, or a vmapped batch) in the port."""
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    if tables[0].ndim == 3:
        return irregular_codes_from_numpy(*tables, jcode.n, jcode.m)
    return irregular_code_from_numpy(*tables, jcode.n, jcode.m)


def _planes(x):
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


# ---------------------------------------------------------------------------
# Degree sequences, spec maps, the container
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, lam, rho", [
    (120, LAM, RHO), (97, [0, 0.4, 0.6], [0, 0, 0, 0, 0.5, 0.5]),
    (110, *MIXED), (1000, [0, 0.3, 0.3, 0, 0, 0.4], [0, 0, 0, 0, 0, 0.6, 0.4])])
def test_degree_sequences_and_spec_maps_equal_jax(n, lam, rho):
    var_d, chk_d = irregular.degree_sequences_from_lam_rho(n, lam, rho)
    want_v, want_c = jir.degree_sequences_from_lam_rho(n, lam, rho)
    assert np.array_equal(var_d, want_v) and np.array_equal(chk_d, want_c)
    assert var_d.sum() == chk_d.sum() and var_d.size == n
    spec = IrregularEnsembleSpec(var_d, chk_d)
    jspec = jir.IrregularEnsembleSpec(want_v, want_c)
    for name in ("socket_var", "chk_of_socket", "pad_map", "sock_to_pad",
                 "var_pad_map"):
        got = getattr(spec, name)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(getattr(jspec,
                                                              "_" + name)))
    assert np.array_equal(spec.chk_offs.numpy()[1:], np.cumsum(chk_d))
    assert np.array_equal(spec.var_offs.numpy()[1:], np.cumsum(var_d))
    assert (spec.n, spec.m, spec.E, spec.dv_max, spec.dc_max) == (
        jspec.n, jspec.m, jspec.E, jspec.dv_max, jspec.dc_max)


def test_degree_sequence_errors_equal_jax():
    with pytest.raises(ValueError, match="cannot absorb"):
        irregular.degree_sequences_from_lam_rho(8, [0, 1.0], [0, 4.0])
    with pytest.raises(ValueError, match="degree-1"):
        irregular.degree_sequences_from_lam_rho(8, [0.5, 0.5], RHO)
    with pytest.raises(ValueError, match="socket counts"):
        IrregularEnsembleSpec([2, 2], [3])


def test_config_k_equals_jax():
    for n in (120, 97, 1000):
        fields = dict(n=n, lam=[0, 0.4, 0.6], rho=[0, 0, 0, 0, 0.5, 0.5])
        assert SimulationConfig(**fields).k == JaxConfig(**fields).k


def test_carried_codes_and_container_equal_jax():
    jspec = jir.IrregularEnsembleSpec.from_lam_rho(110, *MIXED)
    jcodes = jspec.sample_batch(jax.random.key(4), 3)
    codes = _carry(jcodes)
    assert codes.batched and codes.num_codes == 3
    for i in range(3):
        one, jone = codes.select(i), jax.tree.map(lambda x: x[i], jcodes)
        assert not one.batched and one.num_codes == 1
        for name in ("chk_to_var", "var_to_chk", "var_to_sock", "chk_mask",
                     "var_mask", "chk_degrees", "var_degrees"):
            assert np.array_equal(getattr(one, name).numpy(),
                                  np.asarray(getattr(jone, name))), name
        assert (one.n, one.m, one.dv_max, one.dc_max, one.num_edges, one.k) \
            == (jone.n, jone.m, jone.dv_max, jone.dc_max, jone.num_edges,
                jone.k)
        assert validate_irregular_code(one, IrregularEnsembleSpec(
            jspec.var_degrees, jspec.chk_degrees)) == (True, "ok")
    assert torch.equal(codes.to("cpu").var_to_sock, codes.var_to_sock)
    with pytest.raises(ValueError, match="dv_max"):
        irregular_codes_from_numpy(np.zeros((1, 5, 3)), np.zeros((1, 4, 2)),
                                   np.zeros((1, 4, 2)), n=4, m=3)


def test_dense_interop_and_validation_equal_jax():
    jspec = jir.IrregularEnsembleSpec.from_lam_rho(60, LAM, RHO)
    jcode = jspec.sample(jax.random.key(9))
    code = _carry(jcode)
    h = irregular.dense_parity_check_irregular(code)
    assert np.array_equal(h, jir.dense_parity_check_irregular(jcode))
    back, jback = irregular.irregular_code_from_dense(h), \
        jir.irregular_code_from_dense(h)
    for name in ("chk_to_var", "var_to_chk", "var_to_sock"):
        assert np.array_equal(getattr(back, name).numpy(),
                              np.asarray(getattr(jback, name))), name
    assert back.num_edges == jback.num_edges
    # damaged copies get the JAX package's verdicts
    chk = code.chk_to_var.clone()
    row = chk[0]
    chk[0, 1] = row[0]
    broken = [code, irregular.IrregularLDPCCode(
        chk_to_var=chk, var_to_chk=code.var_to_chk,
        var_to_sock=code.var_to_sock, n=code.n, m=code.m,
        dv_max=code.dv_max, dc_max=code.dc_max, num_edges=code.num_edges)]
    sock = code.var_to_sock.clone()
    sock[0, 0] = sock[1, 0]
    broken.append(irregular.IrregularLDPCCode(
        chk_to_var=code.chk_to_var, var_to_chk=code.var_to_chk,
        var_to_sock=sock, n=code.n, m=code.m, dv_max=code.dv_max,
        dc_max=code.dc_max, num_edges=code.num_edges))
    for b in broken:
        jb = jir.IrregularLDPCCode(
            chk_to_var=b.chk_to_var.numpy(), var_to_chk=b.var_to_chk.numpy(),
            var_to_sock=b.var_to_sock.numpy(), n=b.n, m=b.m,
            dv_max=b.dv_max, dc_max=b.dc_max, num_edges=b.num_edges)
        assert validate_irregular_code(b) == jir.validate_irregular_code(jb)
    assert validate_irregular_code(broken[1])[0] is False


# ---------------------------------------------------------------------------
# Decoding: packed (K2/K3 on the phantom view) and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps, max_iters", [(0.3, 40), (0.45, 50),
                                            (0.55, 3), (0.45, 0)])
def test_packed_irregular_decode_equals_jax(eps, max_iters):
    jspec = jir.IrregularEnsembleSpec.from_lam_rho(96, LAM, RHO)
    jcode = jspec.sample(jax.random.key(2))
    erased = jax_bernoulli_packed(jax.random.key(int(eps * 100)), eps,
                                  (96, 3))
    want = jbp.bp_decode_packed_allzero_irregular(jcode, erased, max_iters)
    got = erasure_bp.bp_decode_packed_allzero_irregular(
        _carry(jcode), _planes(erased), max_iters)
    assert np.array_equal(got.known.numpy(),
                          np.asarray(want.known).view(np.int32))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    assert np.array_equal(got.bit_errors.numpy(), np.asarray(want.bit_errors))
    plain = erasure_bp._strip_phantom(erasure_bp.bp_decode_packed_allzero_plain(
        erasure_bp._phantom_view(_carry(jcode)),
        erasure_bp._pad_phantom_row(_planes(erased)), max_iters))
    assert torch.equal(plain.known, got.known)


@pytest.mark.parametrize("wpc", [1, 3])
def test_packed_irregular_batch_equals_jax_per_code(wpc):
    num, n, iters, eps = 4, 110, 40, 0.4
    jcodes = jir.IrregularEnsembleSpec.from_lam_rho(n, *MIXED).sample_batch(
        jax.random.key(8), num)
    planes = [jax_bernoulli_packed(k, eps, (n, wpc))
              for k in jax.random.split(jax.random.key(3), num)]
    got = erasure_bp.bp_decode_packed_allzero_irregular(
        _carry(jcodes), _planes(np.concatenate(planes, axis=1)), iters)
    totals, its = np.zeros(iters + 1, np.int64), []
    for g in range(num):
        want = jbp.bp_decode_packed_allzero_irregular(
            jax.tree.map(lambda x: x[g], jcodes), planes[g], iters)
        assert np.array_equal(got.known[:, g * wpc:(g + 1) * wpc].numpy(),
                              np.asarray(want.known).view(np.int32))
        totals += np.asarray(want.error_totals)
        its.append(int(want.iterations))
    assert got.error_totals.tolist() == totals.tolist()
    assert max(its) <= got.iterations <= max(its) + 1


@pytest.mark.parametrize("eps", [0.2, 0.45, 0.6])
def test_bp_decode_irregular_equals_jax_oracle(eps):
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(110, *MIXED).sample(
        jax.random.key(11))
    code = _carry(jcode)
    rng = np.random.default_rng(int(eps * 100))
    for _ in range(3):
        rx = np.where(rng.random(110) < eps, 2, rng.integers(0, 2, 110))
        dec, errs, it = erasure_bp.bp_decode_irregular(
            code, torch.from_numpy(rx), 40)
        wdec, werrs, wit = jbp.bp_decode_irregular(jcode, rx, 40)
        assert np.array_equal(dec.numpy(), np.asarray(wdec))
        assert np.array_equal(errs.numpy(), np.asarray(werrs))
        assert it == int(wit)


def _assert_stats_equal(got, want):
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    for field in ("block_errors", "bit_errors", "excluded"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field
    assert float(got.bit_errors_sq) == pytest.approx(
        float(want.bit_errors_sq), rel=1e-6)


@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_fixed_chunk_equals_jax(expurgation):
    n, words, iters, eps = 120, 4, 40, 0.42
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO).sample(
        jax.random.key(1))
    key = jax.random.key(5)
    want = jmc._bp_chunk(jcode, key, n=n, words=words, iterations=iters,
                         erasure_prob=eps, expurgation=expurgation)
    got = mc._bp_chunk(_carry(jcode),
                       _planes(jax_bernoulli_packed(key, eps, (n, words))),
                       iterations=iters, expurgation=expurgation)
    _assert_stats_equal(got, want)
    assert got.code_bit_errors_sq is None
    if expurgation is not None:
        assert 0 < int(got.excluded) < 32 * words


@pytest.mark.parametrize("wpc", [1, 3])
@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_ensemble_chunk_equals_jax_vmap(wpc, expurgation):
    n, num, iters, eps = 120, 4, 40, 0.42
    jcodes = jir.IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO) \
        .sample_batch(jax.random.key(2), num)
    keys = jax.random.split(jax.random.key(7), num)
    planes = np.concatenate([np.asarray(jax_bernoulli_packed(
        k, eps, (n, wpc))) for k in keys], axis=1)
    want = jmc._reduce_code_stats(jax.vmap(
        lambda c, k: jmc._bp_chunk(c, k, n=n, words=wpc, iterations=iters,
                                   erasure_prob=eps,
                                   expurgation=expurgation))(jcodes, keys))
    got = mc._bp_chunk(_carry(jcodes), _planes(planes), iterations=iters,
                       expurgation=expurgation)
    _assert_stats_equal(got, want)
    assert float(got.code_bit_errors_sq) == pytest.approx(
        float(want.code_bit_errors_sq), rel=1e-6)


# ---------------------------------------------------------------------------
# The samplers
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


def _sequential_irregular(seed, chunk, num, var_deg, chk_deg, method):
    """The documented draws on the irregular socket maps, one code and one
    step at a time; returns the three padded tables."""
    key = ((seed & _M32), (seed >> 32) ^ 0x243F6A88)
    n, m = len(var_deg), len(chk_deg)
    socket_var = np.repeat(np.arange(n), var_deg)
    voffs = np.concatenate([[0], np.cumsum(var_deg)])
    coffs = np.concatenate([[0], np.cumsum(chk_deg)])
    sockets, dv_max, dc_max = len(socket_var), max(var_deg), max(chk_deg)

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
        for c in range(m):
            row = [socket_var[perm[s]] for s in range(coffs[c], coffs[c + 1])]
            for k in range(1, len(row)):
                if row[k] in row[:k]:
                    return coffs[c] + k
        return -1

    out = []
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
        chk = np.full((m + 1, dc_max), n)
        var = np.full((n + 1, dv_max), m)
        sock = np.full((n + 1, dv_max), m * dc_max)
        for c in range(m):
            for j, s in enumerate(range(coffs[c], coffs[c + 1])):
                t = perm[s]
                v = socket_var[t]
                chk[c, j] = v
                var[v, t - voffs[v]] = c
                sock[v, t - voffs[v]] = c * dc_max + j
        out.append((chk, var, sock))
    return [np.stack(t) for t in zip(*out)]


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_matches_sequential_draws(method):
    spec = IrregularEnsembleSpec.from_lam_rho(40, *MIXED)
    codes = irregular.sample_irregular_codes(2**40 + 9, 7, 3, spec, method)
    want = _sequential_irregular(2**40 + 9, 7, 3, spec.var_degrees,
                                 spec.chk_degrees, method)
    for name, table in zip(("chk_to_var", "var_to_chk", "var_to_sock"),
                           want):
        assert np.array_equal(getattr(codes, name).numpy(), table), name


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_on_a_regular_spec_equals_the_regular_sampler(method):
    spec = IrregularEnsembleSpec.regular(60, 3, 6)
    got = irregular.sample_irregular_codes(5, 2, 3, spec, method)
    want = ensemble.sample_codes(5, 2, 3, 60, 3, 6, method)
    assert torch.equal(got.chk_to_var[:, :-1], want.chk_to_var)
    assert bool((got.chk_to_var[:, -1] == 60).all())
    assert torch.equal(got.var_to_chk[:, :-1].sort(-1).values,
                       want.var_to_chk)
    assert torch.equal(got.var_to_sock[:, :-1].sort(-1).values,
                       want.var_to_edge)


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_structure(method):
    spec = IrregularEnsembleSpec.from_lam_rho(240, LAM, RHO)
    codes = irregular.sample_irregular_codes(3, 1, 4, spec, method)
    assert codes.chk_to_var.shape == (4, spec.m + 1, spec.dc_max)
    assert codes.var_to_sock.dtype == torch.int32
    for i in range(4):
        code = codes.select(i)
        h = irregular.dense_parity_check_irregular(code)
        counts = np.bincount(code.chk_to_var[:-1].reshape(-1).numpy(),
                             minlength=spec.n + 1)[:-1]
        assert (np.sort(counts) == np.sort(spec.var_degrees)).all()
        assert (np.sort((code.chk_to_var[:-1] < spec.n).sum(1).numpy())
                == np.sort(spec.chk_degrees)).all()
        if method != "raw":
            assert validate_irregular_code(code, spec) == (True, "ok")
            assert h.sum() == spec.E
    if method == "raw":    # multi-edges at this size
        assert not all(validate_irregular_code(codes.select(i))[0]
                       for i in range(4))


def test_sampler_is_seeded_and_distinct():
    spec = IrregularEnsembleSpec.from_lam_rho(120, LAM, RHO)
    a = irregular.sample_irregular_codes(5, 3, 4, spec)
    b = irregular.sample_irregular_codes(5, 3, 6, spec)
    assert torch.equal(a.chk_to_var, b.chk_to_var[:4])
    for other in (irregular.sample_irregular_codes(5, 4, 4, spec),
                  irregular.sample_irregular_codes(6, 3, 4, spec)):
        for i in range(4):
            assert not torch.equal(a.chk_to_var[i], other.chk_to_var[i])
    with pytest.raises(ValueError, match="method"):
        irregular.sample_irregular_codes(0, 0, 2, spec, "bogus")
    with pytest.raises(ValueError, match="32 bits"):
        irregular.sample_irregular_codes(0, 2**32, 2, spec)
    with pytest.raises(ValueError, match="device"):
        irregular.sample_irregular_codes(0, 0, 2, spec, device="meta")


def test_fixed_code_for_config_is_deterministic_and_valid():
    cfg = SimulationConfig(n=256, lam=LAM, rho=RHO, code_mode="fixed",
                           code_number=2)
    a, b = ensemble.code_for_config(cfg), ensemble.code_for_config(cfg)
    assert isinstance(a, irregular.IrregularLDPCCode) and not a.batched
    assert torch.equal(a.chk_to_var, b.chk_to_var)
    spec = IrregularEnsembleSpec.from_lam_rho(256, LAM, RHO)
    assert validate_irregular_code(a, spec) == (True, "ok")
    assert cfg.k == a.k
    cfg.code_number = 3
    assert not torch.equal(ensemble.code_for_config(cfg).chk_to_var,
                           a.chk_to_var)
    raw = irregular.sample_irregular_code(torch.Generator().manual_seed(0),
                                          spec, "raw")
    assert raw.num_edges == spec.E


# ---------------------------------------------------------------------------
# Whole runs (port only), the engine's guards and the CLI
# ---------------------------------------------------------------------------

def _run(eps, n, **kw):
    fields = dict(channel="BEC", channel_param=eps, n=n, lam=LAM, rho=RHO,
                  decoder="bp", iterations=60, num_tests=1024, batch=512,
                  max_block_errors=10**9, seed=21, code_mode="ensemble")
    fields.update(kw)
    return mc.run_simulation(SimulationConfig(**fields), device="cpu")


def test_irregular_ensemble_brackets_its_threshold():
    # tests/test_irregular.py::test_irregular_mc_brackets_de_threshold
    lo, hi = _run(EPS_STAR - 0.12, 512), _run(EPS_STAR + 0.12, 512)
    assert lo.bit_error_rate < 2e-3
    assert hi.bit_error_rate > 0.15
    assert lo.code_bit_errors_sq is not None and lo.trials_per_code == 32


def test_irregular_beats_regular_at_042():
    common = dict(iterations=80, num_tests=2048, seed=13)
    irr = _run(0.42, 1024, **common)
    reg = _run(0.42, 1024, lam=None, rho=None, dv=3, dc=6, **common)
    assert irr.bit_error_rate < 0.5 * reg.bit_error_rate
    assert irr.block_error_rate < reg.block_error_rate


def test_fixed_irregular_run_and_engine_guards():
    cfg = SimulationConfig(channel_param=0.3, n=256, lam=LAM, rho=RHO,
                           iterations=40, num_tests=512, batch=256,
                           max_block_errors=10**9, seed=5, code_mode="fixed",
                           expurgation=1)
    code = ensemble.code_for_config(cfg)
    res = mc.run_simulation(cfg, code, device="cpu")
    again = mc.run_simulation(cfg, code, device="cpu")
    assert res.num_trials == 512 and res.code_bit_errors_sq is None
    assert res.error_counts_per_iteration == again.error_counts_per_iteration
    with pytest.raises(ValueError, match="IrregularLDPCCode"):
        mc.make_chunk_fn(cfg, ensemble.code_for_config(SimulationConfig(
            n=256, code_mode="fixed")), device="cpu")
    # the peeling decoder runs through run_simulation's own driver (JAX's
    # words at make_chunk_fn), on irregular ensembles too
    peel = SimulationConfig(n=256, lam=LAM, rho=RHO, decoder="peeling",
                            batch=256, num_tests=256)
    with pytest.raises(NotImplementedError, match="own host driver"):
        mc.make_chunk_fn(peel, None, device="cpu")
    assert mc.run_simulation(peel, None, device="cpu").num_trials == 256
    # random-codeword transmit (queue 1 item 11) runs on irregular
    # ensembles; with expurgation it stays a configuration error
    for kw in (dict(channel="AWGN", decoder="minsum"), dict()):
        stats = mc.make_chunk_fn(SimulationConfig(
            n=256, lam=LAM, rho=RHO, transmit="random", batch=256,
            codes_per_chunk=4, iterations=20, **kw), None, device="cpu")(0)
        assert int(stats.error_totals[0]) > 0
        assert stats.code_bit_errors_sq is not None
    with pytest.raises(ValueError, match="expurgation"):
        SimulationConfig(n=256, lam=LAM, rho=RHO, transmit="random",
                         expurgation=1)


def test_cli_irregular_config_on_cpu(tmp_path, capsys):
    for mode in ("ensemble", "fixed"):
        cfg = SimulationConfig(channel_param=0.4, n=120, lam=LAM, rho=RHO,
                               iterations=30, num_tests=256, batch=256,
                               max_block_errors=10**9, seed=3,
                               code_mode=mode, codes_per_chunk=8)
        path = tmp_path / f"{mode}.json"
        path.write_text(cfg.to_json())
        out = tmp_path / mode
        assert cli.main(["--config", str(path), f"--output-dir={out}",
                         "--device=cpu"]) == 0
        files = glob.glob(os.path.join(str(out), "*.json"))
        res = jax_load_result(files[0])
        assert res.config.lam == LAM and res.num_trials == 256
        assert (res.trials_per_code == 32) == (mode == "ensemble")
    assert "wrote" in capsys.readouterr().out


def test_regular_packed_decode_unchanged_by_phantom_helpers():
    # the phantom row is invisible to the regular path's planes
    plane = bitops.bernoulli_packed(0.4, (5, 2), seed=1)
    padded = erasure_bp._pad_phantom_row(plane)
    assert padded.shape == (6, 2) and int(padded[-1].abs().sum()) == 0
    assert torch.equal(padded[:-1], plane)
