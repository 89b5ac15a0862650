"""The port's quasi-cyclic (QC) codes and circulant-index decoders against
the JAX package.

QC codes are sampled by the JAX sampler and carried over
(``qc_code_from_numpy``, ``irregular_qc_code_from_numpy``, or the npz
store), and JAX-drawn packed planes are handed over as numpy, so both
packages see the same input.  ``expand()`` tables, the BEC decodes
(all-zero and value planes) and the Gallager decodes must be equal bit for
bit (tolerance 0: integer and bitwise arithmetic); the protograph theory
copies agree to rel 1e-12 (the same float64 arithmetic).  The port's
circulant-index decoders are also held to its generic decoders on
``expand()``, and the engine's circulant-index runs to its ``expand()``
runs, counter for counter.  On the CPU every wrapper runs its kernel's
plain version.
"""

import jax
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import qc as jqc_mod
from iib_project_ldpc_codes_tpu.models import store as jstore
from iib_project_ldpc_codes_tpu.ops import qc_bp as jqc_bp
from iib_project_ldpc_codes_tpu.ops import qc_gallager as jqc_gallager
from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed as \
    jax_bernoulli_packed
from iib_project_ldpc_codes_tpu.utils import theory as jtheory
from iib_project_ldpc_codes_tpu_torch.kernels import build
from iib_project_ldpc_codes_tpu_torch.models import qc, store
from iib_project_ldpc_codes_tpu_torch.models.code import validate_code
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    validate_irregular_code)
from iib_project_ldpc_codes_tpu_torch.ops import (bitops, erasure_bp,
                                                  gallager, qc_bp,
                                                  qc_gallager)
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils import theory
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
KINDS = ("regular", "irregular")


def _planes(x):
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


def _carry(jcode):
    base, shifts = np.asarray(jcode.base_chk), np.asarray(jcode.shifts)
    if isinstance(jcode, jqc_mod.IrregularQCLDPCCode):
        return qc.irregular_qc_code_from_numpy(base, shifts, jcode.Z,
                                               jcode.nb, jcode.mb)
    return qc.qc_code_from_numpy(base, shifts, jcode.Z, jcode.nb, jcode.dv,
                                 jcode.dc)


@pytest.fixture(scope="module")
def pairs():
    """kind -> (JAX QC code, the same code in the port): nb = 12 (3,6) at
    an odd Z = 17, and the irregular nb = 24 base at Z = 16."""
    jreg = jqc_mod.sample_qc_code(jax.random.key(3), nb=12, dv=3, dc=6, Z=17)
    jirr = jqc_mod.sample_qc_code_irregular(jax.random.key(50), nb=24,
                                            lam=LAM, rho=RHO, Z=16)
    return {"regular": (jreg, _carry(jreg)),
            "irregular": (jirr, _carry(jirr))}


def _generic(kind, regular_fn, irregular_fn):
    return regular_fn if kind == "regular" else irregular_fn


# ---------------------------------------------------------------------------
# Containers: expand(), samplers, store, theory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_expand_equals_jax(pairs, kind):
    jcode, code = pairs[kind]
    want, got = jcode.expand(), code.expand()
    tables = ("chk_to_var", "var_to_edge") if kind == "regular" else \
        ("chk_to_var", "var_to_chk", "var_to_sock")
    for f in tables:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert (got.n, got.m, got.k) == (code.n, code.m, code.k) == \
        (jcode.n, jcode.m, jcode.k)
    if kind == "regular":
        assert validate_code(got) == (True, "ok")
    else:
        assert (got.dv_max, got.dc_max, got.num_edges) == \
            (want.dv_max, want.dc_max, want.num_edges)
        assert validate_irregular_code(got) == (True, "ok")


def test_sampler_reproducible_shifts_in_range_and_z1_is_base():
    def draw(seed, Z=37):
        return qc.sample_qc_code(torch.Generator().manual_seed(seed), nb=12,
                                 dv=3, dc=6, Z=Z)

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a.base_chk, b.base_chk)
    assert torch.equal(a.shifts, b.shifts)
    assert not torch.equal(a.shifts, c.shifts)
    assert int(a.shifts.min()) >= 0 and int(a.shifts.max()) < 37
    assert (a.n, a.m, a.k, a.mb) == (12 * 37, 6 * 37, 6 * 37, 6)
    assert validate_code(a.expand()) == (True, "ok")
    one = draw(6, Z=1)
    assert not bool(one.shifts.any())
    assert torch.equal(one.expand().chk_to_var, one.base_chk)


def test_irregular_sampler_pads_with_zero_shifts():
    def draw(seed):
        return qc.sample_qc_code_irregular(
            torch.Generator().manual_seed(seed), nb=24, lam=LAM, rho=RHO,
            Z=16)

    a, b = draw(1), draw(1)
    assert torch.equal(a.base_chk, b.base_chk)
    assert torch.equal(a.shifts, b.shifts)
    pad = a.base_chk >= a.nb
    assert not bool(a.shifts[pad].any())
    assert int(a.shifts.min()) >= 0 and int(a.shifts.max()) < 16
    expanded = a.expand()
    assert validate_irregular_code(expanded) == (True, "ok")
    base_deg = np.bincount(a.base_chk[~pad].numpy(), minlength=a.nb)
    assert np.array_equal(expanded.var_degrees.numpy(),
                          np.repeat(base_deg, a.Z))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_round_trip_with_jax(tmp_path, pairs, kind, writer):
    jcode, code = pairs[kind]
    path = str(tmp_path / f"{kind}.npz")
    if writer == "jax":
        jstore.save_qc_code(jcode, path)
        got = store.load_qc_code(path)
        assert type(got) is type(code)
        assert (got.Z, got.nb, got.mb, got.n) == \
            (code.Z, code.nb, code.mb, code.n)
        assert torch.equal(got.base_chk, code.base_chk)
        assert torch.equal(got.shifts, code.shifts)
    else:
        store.save_qc_code(code, path)
        got = jstore.load_qc_code(path)
        assert type(got) is type(jcode)
        assert (got.Z, got.nb, got.mb, got.n) == \
            (jcode.Z, jcode.nb, jcode.mb, jcode.n)
        assert np.array_equal(np.asarray(got.base_chk), code.base_chk.numpy())
        assert np.array_equal(np.asarray(got.shifts), code.shifts.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eps", [0.40, 0.46])
def test_protograph_de_equals_jax(pairs, kind, eps):
    jcode, code = pairs[kind]
    got = theory.protograph_de(code.base_chk, code.nb, eps,
                               max_iterations=400)
    want = jtheory.protograph_de(np.asarray(jcode.base_chk), jcode.nb, eps,
                                 max_iterations=400)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_protograph_threshold_equals_jax_and_anchor(pairs, kind):
    jcode, code = pairs[kind]
    got = theory.protograph_threshold(code.base_chk, code.nb,
                                      precision=1e-4)
    want = jtheory.protograph_threshold(np.asarray(jcode.base_chk),
                                        jcode.nb, precision=1e-4)
    assert got == pytest.approx(want, rel=1e-12)
    if kind == "regular":          # a regular base reproduces eps*(3,6)
        assert abs(got - 0.4294) < 3e-4
    else:                          # below the (lam, rho) ensemble's 0.4526
        assert 0.43 < got < 0.4527


def test_design_protograph_no_worse_than_first_try():
    first = qc.sample_qc_code_irregular(torch.Generator().manual_seed(1),
                                        nb=12, lam=LAM, rho=RHO, Z=8)
    t_first = theory.protograph_threshold(first.base_chk, 12, precision=1e-4)
    designed, t = qc.design_protograph(torch.Generator().manual_seed(1),
                                       nb=12, lam=LAM, rho=RHO, Z=8, tries=3)
    # the same generator draws the same first base, so the best of 3 can
    # be no worse
    assert t >= t_first and 0.3 < t < 0.4527
    assert isinstance(designed, qc.IrregularQCLDPCCode)
    assert (designed.nb, designed.Z, designed.n) == (12, 8, 96)
    assert not bool(designed.shifts[designed.base_chk >= 12].any())
    erased = _planes(jax_bernoulli_packed(jax.random.key(2), 0.3,
                                          (designed.n, 2)))
    res = qc_bp.qc_bp_decode_packed_allzero(designed, erased, 30)
    assert int(res.error_totals[-1]) < int(res.error_totals[0])


# ---------------------------------------------------------------------------
# BEC decodes, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eps", [0.3, 0.42, 0.5])
def test_allzero_decode_equals_jax_and_generic(pairs, kind, eps):
    jcode, code = pairs[kind]
    erased = jax_bernoulli_packed(jax.random.key(int(eps * 100)), eps,
                                  (code.n, 3))
    want = jqc_bp.qc_bp_decode_packed_allzero(jcode, erased, 30)
    got = qc_bp.qc_bp_decode_packed_allzero(code, _planes(erased), 30)
    assert np.array_equal(got.known.numpy(),
                          np.asarray(want.known).view(np.int32))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    assert np.array_equal(got.failed.numpy(), np.asarray(want.failed))
    assert got.val is None
    generic = _generic(kind, erasure_bp.bp_decode_packed_allzero,
                       erasure_bp.bp_decode_packed_allzero_irregular)(
        code.expand(), _planes(erased), 30)
    plain = qc_bp.qc_bp_decode_packed_allzero_plain(code, _planes(erased),
                                                    30)
    for other in (generic, plain):
        assert torch.equal(other.known, got.known)
        assert torch.equal(other.error_totals, got.error_totals)
        assert other.iterations == got.iterations


@pytest.mark.parametrize("kind", KINDS)
def test_value_decode_equals_jax_and_generic(pairs, kind):
    jcode, code = pairs[kind]
    erased = jax_bernoulli_packed(jax.random.key(9), 0.4, (code.n, 2))
    # any value planes exercise the round (a codeword is not needed for
    # bit identity): the adopt planes then carry nonzero bits
    tx = jax_bernoulli_packed(jax.random.key(10), 0.5, (code.n, 2))
    want = jqc_bp.qc_bp_decode_packed(jcode, erased, tx, 30)
    got = qc_bp.qc_bp_decode_packed(code, _planes(erased), _planes(tx), 30)
    for f in ("known", "val"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f)).view(np.int32)), f
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    generic = _generic(kind, erasure_bp.bp_decode_packed,
                       erasure_bp.bp_decode_packed_irregular)(
        code.expand(), _planes(erased), _planes(tx), 30)
    plain = qc_bp.qc_bp_decode_packed_plain(code, _planes(erased),
                                            _planes(tx), 30)
    for other in (generic, plain):
        assert torch.equal(other.known, got.known)
        assert torch.equal(other.val, got.val)
        assert torch.equal(other.error_totals, got.error_totals)
        assert other.iterations == got.iterations


# ---------------------------------------------------------------------------
# Gallager decodes, bit for bit
# ---------------------------------------------------------------------------

def _assert_same_gallager(got, want_decided, want_totals, want_iterations):
    assert np.array_equal(got.decided.numpy(), want_decided)
    assert np.array_equal(got.error_totals.numpy(), want_totals)
    assert got.iterations == want_iterations


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("threshold, record, with_tx", [
    (None, "per_trial", False), (None, "total", True),
    (1, "total", False), (1, "per_trial", True)])
def test_gallager_equals_jax_and_generic(pairs, kind, threshold, record,
                                         with_tx):
    jcode, code = pairs[kind]
    flips = jax_bernoulli_packed(jax.random.key(40), 0.05, (code.n, 4))
    tx = jax_bernoulli_packed(jax.random.key(41), 0.5, (code.n, 4)) \
        if with_tx else None
    rx = flips if tx is None else flips ^ tx
    want = jqc_gallager.qc_gallager_decode_packed(
        jcode, rx, 15, threshold=threshold, record=record, tx_bits=tx)
    kwargs = dict(threshold=threshold, record=record,
                  tx_bits=None if tx is None else _planes(tx))
    got = qc_gallager.qc_gallager_decode_packed(code, _planes(rx), 15,
                                                **kwargs)
    _assert_same_gallager(got, np.asarray(want.decided).view(np.int32),
                          np.asarray(want.error_totals),
                          int(want.iterations))
    if record == "per_trial":
        assert np.array_equal(got.traj.numpy(), np.asarray(want.traj))
    else:
        assert got.traj is None
    generic = _generic(kind, gallager.gallager_decode_packed,
                       gallager.gallager_decode_packed_irregular)(
        code.expand(), _planes(rx), 15, **kwargs)
    plain = qc_gallager.qc_gallager_decode_packed_plain(code, _planes(rx),
                                                        15, **kwargs)
    for other in (generic, plain):
        _assert_same_gallager(other, got.decided.numpy(),
                              got.error_totals.numpy(), got.iterations)
        assert np.array_equal(other.bit_errors.numpy(),
                              got.bit_errors.numpy())


# the JAX suite's hand-built bases: (a) a degree-1 block (block 3, a
# parity-extension column), (b) a degree-UNIFORM irregular base with an
# explicit threshold above d - 1: the clamp must engage by code type
_HAND_BASES = {
    "degree_one": ([[0, 1, 2], [0, 1, 3]], [[0, 1, 2], [3, 0, 1]], 4, None),
    "uniform_clamped": ([[0, 1, 2, 3], [0, 2, 4, 5], [1, 3, 4, 5]],
                        [[0, 1, 2, 3], [1, 2, 3, 0], [2, 3, 0, 1]], 6, 3)}


@pytest.mark.parametrize("name", sorted(_HAND_BASES))
def test_gallager_hand_built_irregular_bases(name):
    base, shifts, nb, threshold = _HAND_BASES[name]
    jcode = jqc_mod.IrregularQCLDPCCode(
        base_chk=jax.numpy.asarray(base, jax.numpy.int32),
        shifts=jax.numpy.asarray(shifts, jax.numpy.int32), Z=8, nb=nb,
        mb=len(base))
    code = _carry(jcode)
    rx = jax_bernoulli_packed(jax.random.key(60), 0.1, (code.n, 2))
    want = jqc_gallager.qc_gallager_decode_packed(jcode, rx, 10,
                                                  threshold=threshold)
    got = qc_gallager.qc_gallager_decode_packed(code, _planes(rx), 10,
                                                threshold=threshold)
    _assert_same_gallager(got, np.asarray(want.decided).view(np.int32),
                          np.asarray(want.error_totals),
                          int(want.iterations))
    generic = gallager.gallager_decode_packed_irregular(
        code.expand(), _planes(rx), 10, threshold=threshold)
    _assert_same_gallager(generic, got.decided.numpy(),
                          got.error_totals.numpy(), got.iterations)


@pytest.mark.parametrize("threshold", [0, -2, 2, 40])
def test_gallager_threshold_clipping_equals_generic(pairs, threshold):
    """Out-of-range thresholds clip as the generic decoders clip them,
    on the degree-1 base too (the port's rule: t <= 0 always flips)."""
    base, shifts, nb, _ = _HAND_BASES["degree_one"]
    hand = qc.irregular_qc_code_from_numpy(base, shifts, 8, nb, len(base))
    for kind, code in (("regular", pairs["regular"][1]),
                       ("irregular", hand)):
        rx = bitops.bernoulli_packed(0.1, (code.n, 2), seed=3, device="cpu")
        got = qc_gallager.qc_gallager_decode_packed(code, rx, 8,
                                                    threshold=threshold)
        generic = _generic(kind, gallager.gallager_decode_packed,
                           gallager.gallager_decode_packed_irregular)(
            code.expand(), rx, 8, threshold=threshold)
        _assert_same_gallager(generic, got.decided.numpy(),
                              got.error_totals.numpy(), got.iterations)


# ---------------------------------------------------------------------------
# Single passes: wrappers on CPU tensors, argument checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_adjacency_follows_jax_order(pairs, kind):
    jcode, code = pairs[kind]
    adj = qc_bp._adjacency(code, "cpu")
    chk_side, nb = jqc_bp._adjacency(jcode)
    assert adj.chk_side == chk_side and adj.nb == nb
    from iib_project_ldpc_codes_tpu.ops.qc_soft_bp import _var_adjacency
    assert tuple(tuple((row, s) for row, _c, s in block)
                 for block in adj.var_side) == _var_adjacency(jcode)
    assert adj.num_rows == sum(len(s) for s in chk_side)
    assert adj.row_offs.tolist()[-1] == adj.num_rows
    for b, block in enumerate(adj.var_side):
        for i, (row, c, s) in enumerate(block):
            assert (int(adj.var_row[b, i]), int(adj.var_chk[b, i]),
                    int(adj.var_shift[b, i])) == (row, c, s)
        assert bool((adj.var_row[b, len(block):] == -1).all())


def test_pass_wrappers_check_their_arguments(pairs):
    code = pairs["regular"][1]
    adj = qc_bp._adjacency(code, "cpu")
    known = torch.zeros((code.n, 2), dtype=torch.int32)
    ex = qc_bp.qc_check_exactly_one(adj, known)
    assert ex.shape == (code.m, 2)
    errors = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        qc_bp.qc_check_exactly_one(adj, known[:-1])
    with pytest.raises(TypeError):
        qc_bp.qc_check_exactly_one(adj, known.long())
    with pytest.raises(ValueError):
        qc_bp.qc_variable_or(adj, ex, known, errors, 2)
    with pytest.raises(ValueError):
        qc_bp.qc_variable_or(adj, ex, known, errors, 1, adopt=ex)
    with pytest.raises(ValueError):
        qc_bp.qc_variable_or(adj, ex[:, :1].contiguous(), known, errors, 1)
    msg = torch.zeros((adj.num_rows * adj.Z, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        qc_gallager.qc_gallager_check(adj, msg[:-1])
    with pytest.raises(ValueError):
        qc_gallager.qc_gallager_variable(
            adj, msg, ex, known, known.clone(),
            torch.zeros((2, 2), dtype=torch.int32), threshold=2)
    # launch counts move only where a kernel is launched: never on the CPU
    assert qc_bp.qc_check_exactly_one.launches == 0
    assert qc_bp.qc_variable_or.launches == 0
    assert qc_gallager.qc_gallager_check.launches == 0
    assert qc_gallager.qc_gallager_variable.launches == 0


def test_new_kernels_are_declared_and_sourced():
    names = {p.name for p in build.source_files()}
    for stem in ("qc_check_exactly_one", "qc_variable_or",
                 "qc_gallager_check", "qc_gallager_variable"):
        assert f"{stem}.cu" in names
        assert f"ldpc_{stem}" in build.SIGNATURES
        source = (build.SOURCE_DIR / f"{stem}.cu").read_text()
        assert f'extern "C" int ldpc_{stem}(' in source


# ---------------------------------------------------------------------------
# What raises
# ---------------------------------------------------------------------------

def test_sampler_rejects_indivisible_base():
    with pytest.raises(ValueError, match="divisible"):
        qc.sample_qc_code(torch.Generator().manual_seed(0), nb=13, dv=3,
                          dc=6, Z=8)
    with pytest.raises(ValueError, match="divisible"):
        jqc_mod.sample_qc_code(jax.random.key(0), nb=13, dv=3, dc=6, Z=8)


def test_socketless_base_check_raises():
    code = qc.irregular_qc_code_from_numpy([[0, 1], [2, 2]], [[0, 1], [0, 0]],
                                           Z=4, nb=2, mb=2)
    erased = torch.zeros((code.n, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="no real sockets"):
        qc_bp.qc_bp_decode_packed_allzero(code, erased, 5)
    with pytest.raises(ValueError, match="no real sockets"):
        qc_gallager.qc_gallager_decode_packed(code, erased, 5)


def test_shift_out_of_range_raises():
    code = qc.qc_code_from_numpy([[0, 1]], [[0, 4]], Z=4, nb=2, dv=1, dc=2)
    with pytest.raises(ValueError, match="shifts"):
        qc_bp.qc_bp_decode_packed_allzero(
            code, torch.zeros((code.n, 1), dtype=torch.int32), 5)


@pytest.mark.parametrize("words, ok", [(48, True), (96, False)])
def test_int32_guard_at_the_huge_n_shape(words, ok):
    """n = 1,000,008 at W = 48 stays below 2^31 counted bits; W = 96 must
    raise.  Tensors on the meta device carry the shape and no memory."""
    code = qc.sample_qc_code(torch.Generator().manual_seed(0), nb=12, dv=3,
                             dc=6, Z=83_334)
    assert code.n == 1_000_008
    erased = torch.empty((code.n, words), dtype=torch.int32, device="meta")
    if ok:
        erasure_bp._check_packed_batch_bits(code.n, words)
    else:
        with pytest.raises(ValueError, match="2\\^31"):
            qc_bp.qc_bp_decode_packed_allzero(code, erased, 5)
        with pytest.raises(ValueError, match="2\\^31"):
            qc_gallager.qc_gallager_decode_packed(code, erased, 5)


# ---------------------------------------------------------------------------
# The engine's gate
# ---------------------------------------------------------------------------

_COUNTERS = ("num_trials", "block_errors", "bit_errors", "excluded_trials",
             "bit_errors_sq", "error_counts_per_iteration", "stopped_by")


def _config(code, kind, **fields):
    base = dict(n=code.n, iterations=15, num_tests=256, batch=128,
                max_block_errors=10**9, seed=31, code_mode="fixed")
    if kind == "irregular":
        base.update(lam=LAM, rho=RHO)
    return SimulationConfig(**{**base, **fields})


def _spy(monkeypatch, name):
    calls = []
    real = getattr(mc, name)

    def wrapper(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, name, wrapper)
    return calls


@pytest.mark.parametrize("kind, fields", [
    ("regular", dict(channel="BEC", channel_param=0.42, iterations=30)),
    ("irregular", dict(channel="BEC", channel_param=0.45, iterations=30)),
    ("regular", dict(channel="BSC", decoder="gallager", channel_param=0.05)),
    ("irregular", dict(channel="BSC", decoder="gallager",
                       channel_param=0.04)),
    ("irregular", dict(channel="BSC", decoder="gallager", channel_param=0.04,
                       gallager_threshold=3))])
def test_engine_by_index_run_equals_expand_run(monkeypatch, pairs, kind,
                                               fields):
    code = pairs[kind][1]
    cfg = _config(code, kind, **fields)
    bec = _spy(monkeypatch, "qc_bp_decode_packed_allzero")
    gal = _spy(monkeypatch, "qc_gallager_decode_packed")
    fast = mc.run_simulation(cfg, code=code, device="cpu")
    # one circulant-index decode per chunk, of the configuration's decoder
    assert (len(bec), len(gal)) == ((2, 0) if cfg.channel == "BEC"
                                    else (0, 2))
    generic = mc.run_simulation(cfg, code=code.expand(), device="cpu")
    assert (len(bec), len(gal)) == ((2, 0) if cfg.channel == "BEC"
                                    else (0, 2))
    for f in _COUNTERS:
        assert getattr(fast, f) == getattr(generic, f), f
    assert fast.error_counts_per_iteration[0] > 0


def test_engine_decides_by_code_type_not_by_config(pairs):
    """JAX's gate does not look at lam/rho: a regular configuration takes
    an irregular QC code (and the reverse) as long as n agrees."""
    for kind, other in (("regular", "irregular"), ("irregular", "regular")):
        code = pairs[kind][1]
        cfg = _config(code, other, channel="BEC", channel_param=0.4)
        res = mc.run_simulation(cfg, code=code, device="cpu")
        want = mc.run_simulation(_config(code, kind, channel="BEC",
                                         channel_param=0.4), code=code,
                                 device="cpu")
        assert res.error_counts_per_iteration == \
            want.error_counts_per_iteration
        assert res.block_errors == want.block_errors


@pytest.mark.parametrize("kind, fields", [
    ("regular", dict(channel="BEC", channel_param=0.4, transmit="random")),
    ("irregular", dict(channel="BEC", channel_param=0.4,
                       transmit="random")),
    ("regular", dict(channel="BEC", channel_param=0.45, expurgation=2)),
    ("regular", dict(channel="BSC", decoder="gallager", channel_param=0.05,
                     expurgation=1)),
    ("regular", dict(channel="BSC", decoder="gallager", channel_param=0.05,
                     transmit="random")),
    ("regular", dict(channel="AWGN", decoder="minsum", channel_param=0.8,
                     soft_msg_dtype="int8")),
    ("irregular", dict(channel="BSC", decoder="minsum", channel_param=0.06,
                       soft_msg_dtype="int8")),
    ("regular", dict(channel="AWGN", decoder="sumproduct",
                     channel_param=0.8))])
def test_engine_other_modes_expand_transparently(monkeypatch, pairs, kind,
                                                 fields):
    code = pairs[kind][1]
    cfg = _config(code, kind, **fields)
    bec = _spy(monkeypatch, "qc_bp_decode_packed_allzero")
    gal = _spy(monkeypatch, "qc_gallager_decode_packed")
    res = mc.run_simulation(cfg, code=code, device="cpu")
    assert not bec and not gal
    generic = mc.run_simulation(cfg, code=code.expand(), device="cpu")
    for f in _COUNTERS:
        assert getattr(res, f) == getattr(generic, f), f
    assert res.num_trials == 256


def test_engine_rejects_a_code_of_another_length(pairs):
    code = pairs["regular"][1]
    cfg = _config(code, "regular", n=code.n + 12, channel_param=0.4)
    with pytest.raises(ValueError, match="QC code n="):
        mc.make_chunk_fn(cfg, code, device="cpu")
    with pytest.raises(TypeError):
        mc.make_chunk_fn(_config(code, "regular", channel_param=0.4),
                         object(), device="cpu")
