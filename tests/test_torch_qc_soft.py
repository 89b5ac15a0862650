"""The port's soft-decision BP for quasi-cyclic codes by circulant index
(``ops/qc_soft_bp.py``) against the JAX package's roll decoder and the
port's generic decoder on ``expand()``.

QC codes are sampled by the JAX sampler and carried over, and channel LLRs
are drawn with numpy and handed to both packages.  Tolerances:

  * int8 min-sum: bit for bit (hard decisions, posterior, ``error_totals``,
    ``iterations``, ``satisfied``): integer arithmetic is exact in any
    order;
  * float32: JAX's own tolerance between its roll and gather decoders
    (tests/test_qc.py:221-224): posteriors to rtol 1e-4 and atol 1e-3, at
    least 99.9% equal decisions -- except sum-product against JAX, whose
    XLA ``tanh``/``atanh`` round apart from PyTorch's (the port's
    test_torch_soft_bp.py: posteriors to 0.1);
  * bfloat16: test_torch_soft_bp.py's tolerance, posteriors to atol 0.5
    (a bfloat16 message near the tanh clip rounds in steps of 0.0625), and
    the same share of equal decisions.

On the CPU every wrapper runs its kernel's plain version; the kernels are
held to the plain versions on the GPU (test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import qc as jqc_mod
from iib_project_ldpc_codes_tpu.ops import qc_soft_bp as jqs
from iib_project_ldpc_codes_tpu_torch.kernels import build
from iib_project_ldpc_codes_tpu_torch.models import qc
from iib_project_ldpc_codes_tpu_torch.ops import qc_bp, qc_soft_bp, soft_bp
from iib_project_ldpc_codes_tpu_torch.ops.channels import BSC
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
KINDS = ("regular", "irregular")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}
ATOL = {"float32": 1e-3, "bfloat16": 0.5}
SP_ATOL_JAX = {"float32": 0.1, "bfloat16": 0.5}
COUNTERS = ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
            "error_counts_per_iteration", "stopped_by")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _carry(jcode):
    base, shifts = np.asarray(jcode.base_chk), np.asarray(jcode.shifts)
    if isinstance(jcode, jqc_mod.IrregularQCLDPCCode):
        return qc.irregular_qc_code_from_numpy(base, shifts, jcode.Z,
                                               jcode.nb, jcode.mb)
    return qc.qc_code_from_numpy(base, shifts, jcode.Z, jcode.nb, jcode.dv,
                                 jcode.dc)


@pytest.fixture(scope="module")
def pairs():
    """kind -> (JAX QC code, the same code in the port): the `qc` fixture
    of tests/test_qc.py (nb = 12 (3,6), Z = 17) and the irregular nb = 24
    base at Z = 16."""
    jreg = jqc_mod.sample_qc_code(jax.random.key(3), nb=12, dv=3, dc=6, Z=17)
    jirr = jqc_mod.sample_qc_code_irregular(jax.random.key(50), nb=24,
                                            lam=LAM, rho=RHO, Z=16)
    return {"regular": (jreg, _carry(jreg)),
            "irregular": (jirr, _carry(jirr))}


def _awgn_llr(n, cols, sigma, seed):
    z = np.random.default_rng(seed).standard_normal((n, cols))
    return (2.0 * (1.0 + sigma * z) / sigma ** 2).astype(np.float32)


def _bsc_llr(n, cols, p, seed):
    flips = np.random.default_rng(seed).random((n, cols)) < p
    mag = np.float32(np.log((1 - p) / p))
    return np.where(flips, -mag, mag).astype(np.float32)


def _generic(code, llr, iters, **kw):
    decode = soft_bp.soft_bp_decode_irregular \
        if isinstance(code, qc.IrregularQCLDPCCode) else soft_bp.soft_bp_decode
    return decode(code.expand(), llr, iters, **kw)


def _assert_equal(got, want_np):
    """``got`` (a port result) equals ``want_np`` (a dict of numpy arrays)
    in every field."""
    assert got.iterations == int(want_np["iterations"])
    for f in ("hard", "posterior", "error_totals", "satisfied"):
        assert np.array_equal(getattr(got, f).numpy(), want_np[f]), f


def _numpy(res):
    return {f: np.asarray(getattr(res, f)) for f in
            ("hard", "posterior", "error_totals", "satisfied", "iterations")}


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("channel", ["AWGN", "BSC"])
def test_int8_equals_jax_and_expand_bit_for_bit(pairs, kind, channel):
    jcode, code = pairs[kind]
    llr = _awgn_llr(code.n, 64, 0.8, seed=1) if channel == "AWGN" else \
        _bsc_llr(code.n, 64, 0.04, seed=2)
    got = qc_soft_bp.qc_soft_bp_decode(code, torch.from_numpy(llr), 25,
                                       method="minsum", msg_dtype="int8")
    want = jqs.qc_soft_bp_decode(jcode, jnp.asarray(llr), 25,
                                 method="minsum", msg_dtype=jnp.int8)
    _assert_equal(got, _numpy(want))
    _assert_equal(got, _numpy(_generic(code, torch.from_numpy(llr), 25,
                                       method="minsum", msg_dtype="int8")))
    assert 0 < int(got.error_totals[0]) and got.failed.any() \
        and not got.failed.all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", ["minsum", "sumproduct"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_close_to_jax_and_expand(pairs, kind, method, dtype):
    jcode, code = pairs[kind]
    llr = _awgn_llr(code.n, 32, 0.85, seed=31)
    got = qc_soft_bp.qc_soft_bp_decode(code, torch.from_numpy(llr), 20,
                                       method=method, msg_dtype=dtype)
    post = got.posterior.numpy()
    hard = got.hard.numpy()
    gen = _generic(code, torch.from_numpy(llr), 20, method=method,
                   msg_dtype=dtype)
    np.testing.assert_allclose(post, gen.posterior.numpy(), rtol=1e-4,
                               atol=ATOL[dtype])
    assert np.mean(hard == gen.hard.numpy()) > 0.999
    want = jqs.qc_soft_bp_decode(jcode, jnp.asarray(llr), 20, method=method,
                                 msg_dtype=DTYPES[dtype][1])
    atol = ATOL[dtype] if method == "minsum" else SP_ATOL_JAX[dtype]
    np.testing.assert_allclose(post, np.asarray(want.posterior), rtol=1e-4,
                               atol=atol)
    assert np.mean(hard == np.asarray(want.hard)) > 0.999


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_per_trial_record_equals_total_and_expand(pairs, kind, dtype):
    _, code = pairs[kind]
    llr = torch.from_numpy(_awgn_llr(code.n, 64, 0.95, seed=4))
    kw = dict(method="minsum", msg_dtype=dtype)
    per = qc_soft_bp.qc_soft_bp_decode(code, llr, 15, record="per_trial",
                                       **kw)
    tot = qc_soft_bp.qc_soft_bp_decode(code, llr, 15, **kw)
    gen = _generic(code, llr, 15, record="per_trial", **kw)
    assert torch.equal(per.traj, gen.traj)
    assert torch.equal(per.traj.sum(1, dtype=torch.int32), tot.error_totals)
    assert torch.equal(per.error_totals, tot.error_totals)
    assert tot.traj is None and per.traj.shape == (16, 64)


def test_plain_twin_equals_the_wrappers_on_the_cpu(pairs):
    _, code = pairs["irregular"]
    llr = torch.from_numpy(_awgn_llr(code.n, 32, 0.9, seed=8))
    for dtype in DTYPES:
        a = qc_soft_bp.qc_soft_bp_decode(code, llr, 10, method="minsum",
                                         msg_dtype=dtype)
        b = qc_soft_bp.qc_soft_bp_decode_plain(code, llr, 10,
                                               method="minsum",
                                               msg_dtype=dtype)
        _assert_equal(a, _numpy(b))


@pytest.mark.parametrize("iters", [0, 1])
def test_tail_and_zero_rounds_follow_jax(pairs, iters):
    jcode, code = pairs["regular"]
    llr = _awgn_llr(code.n, 32, 0.9, seed=9)
    got = qc_soft_bp.qc_soft_bp_decode(code, torch.from_numpy(llr), iters,
                                       method="minsum", msg_dtype="int8")
    want = jqs.qc_soft_bp_decode(jcode, jnp.asarray(llr), iters,
                                 method="minsum", msg_dtype=jnp.int8)
    _assert_equal(got, _numpy(want))


# ---------------------------------------------------------------------------
# Contracts and the pass wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(method="minsum", alpha=0.8), "alpha/beta"),
    (dict(method="minsum", beta=0.5), "alpha/beta"),
    (dict(method="sumproduct"), "minsum")])
def test_int8_contract_raises(pairs, kw, match):
    _, code = pairs["regular"]
    llr = torch.zeros((code.n, 32))
    with pytest.raises(ValueError, match=match):
        qc_soft_bp.qc_soft_bp_decode(code, llr, 5, msg_dtype="int8", **kw)


def test_pass_wrappers_check_their_arguments(pairs):
    _, code = pairs["regular"]
    adj = qc_bp._adjacency(code, "cpu")
    n, cols = code.n, 32
    llr0 = torch.zeros((n, cols), dtype=torch.int8)
    pm = torch.zeros((n, cols), dtype=torch.int8)
    msg = torch.zeros((adj.num_rows * adj.Z, cols), dtype=torch.int8)
    one = torch.ones(1, dtype=torch.int32)
    counts = torch.zeros(cols, dtype=torch.int32)
    with pytest.raises(ValueError, match="all-zero"):
        qc_soft_bp.qc_soft_posterior(llr0, msg, adj, one, pm, counts,
                                     tx=torch.zeros((n, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="msg must be"):
        qc_soft_bp.qc_soft_posterior(llr0, msg[:-1], adj, one, pm, counts)
    with pytest.raises(TypeError, match="share a type"):
        qc_soft_bp.qc_soft_posterior(llr0, msg.float(), adj, one, pm, counts)
    with pytest.raises(ValueError, match="llr0"):
        qc_soft_bp.qc_soft_posterior(llr0.float(), msg, adj, one, pm, counts)
    with pytest.raises(ValueError, match="counts"):
        qc_soft_bp.qc_soft_posterior(llr0, msg, adj, one, pm, counts[:5])
    with pytest.raises(ValueError, match="one code"):
        qc_soft_bp.qc_soft_posterior(llr0, msg, adj, torch.ones(
            2, dtype=torch.int32), pm, counts)
    with pytest.raises(ValueError, match="multiple of 4"):
        qc_soft_bp.qc_soft_check(pm[:, :6].contiguous(),
                                 msg[:, :6].contiguous(), adj,
                                 one, one.clone(), method="minsum")
    with pytest.raises(ValueError, match="alpha 1"):
        qc_soft_bp.qc_soft_check(pm, msg, adj, one, one.clone(),
                                 method="minsum", alpha=0.5)
    with pytest.raises(ValueError, match="unsat"):
        qc_soft_bp.qc_soft_check(pm, msg, adj, one, counts, method="minsum")
    with pytest.raises(TypeError, match="QC code"):
        qc_soft_bp.qc_soft_bp_decode(code.expand(), torch.zeros((n, cols)),
                                     3)
    # a stopped code's planes stay as they were
    before = msg.clone()
    qc_soft_bp.qc_soft_check(pm, msg, adj, torch.zeros(1, dtype=torch.int32),
                             one.clone(), method="minsum")
    assert torch.equal(msg, before)


def test_kernels_are_declared_and_sourced():
    names = {p.name for p in build.source_files()}
    for stem in ("qc_soft_posterior", "qc_soft_check"):
        assert f"{stem}.cu" in names
        assert f"ldpc_{stem}" in build.SIGNATURES
        source = (build.SOURCE_DIR / f"{stem}.cu").read_text()
        assert f'extern "C" int ldpc_{stem}(' in source
    assert qc_soft_bp.qc_soft_posterior.launches == 0
    assert qc_soft_bp.qc_soft_check.launches == 0


# ---------------------------------------------------------------------------
# The engine's gate
# ---------------------------------------------------------------------------

def _config(code, kind, **fields):
    base = dict(n=code.n, iterations=20, num_tests=256, batch=128,
                max_block_errors=10**9, seed=17, code_mode="fixed",
                decoder="minsum")
    if kind == "irregular":
        base.update(lam=LAM, rho=RHO)
    return SimulationConfig(**{**base, **fields})


def _spy(monkeypatch):
    calls = []
    real = mc.qc_soft_bp_decode

    def wrapper(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, "qc_soft_bp_decode", wrapper)
    return calls


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("channel, param", [("AWGN", 0.8), ("BSC", 0.04)])
def test_engine_int8_by_index_equals_expand_run(monkeypatch, pairs, kind,
                                                channel, param):
    _, code = pairs[kind]
    cfg = _config(code, kind, channel=channel, channel_param=param,
                  soft_msg_dtype="int8")
    calls = _spy(monkeypatch)
    fast = mc.run_simulation(cfg, code=code, device="cpu")
    assert len(calls) == 2                  # one decode by index a chunk
    generic = mc.run_simulation(cfg, code=code.expand(), device="cpu")
    assert len(calls) == 2
    for f in COUNTERS:
        assert getattr(fast, f) == getattr(generic, f), f
    assert 0 < fast.block_errors < fast.num_trials


def test_engine_chunk_draws_the_generic_llrs(pairs):
    """The BSC chunk by index decodes the LLRs the generic chunk draws:
    K1 flips through BSC.llr_of_flips."""
    _, code = pairs["regular"]
    cfg = _config(code, "regular", channel="BSC", channel_param=0.06,
                  soft_msg_dtype="int8")
    stats = mc.make_chunk_fn(cfg, code, device="cpu")(1)
    from iib_project_ldpc_codes_tpu_torch.ops.bitops import bernoulli_packed
    flips = bernoulli_packed(0.06, (code.n, 4), seed=17, offset=1)
    res = qc_soft_bp.qc_soft_bp_decode(code, BSC(0.06).llr_of_flips(flips),
                                       20, method="minsum", msg_dtype="int8")
    assert torch.equal(stats.error_totals, res.error_totals)
    assert int(stats.bit_errors) == int(res.bit_errors.sum())


@pytest.mark.parametrize("fields", [
    dict(channel="AWGN", channel_param=0.85, soft_msg_dtype="float32"),
    dict(channel="AWGN", channel_param=0.85, soft_msg_dtype="bfloat16"),
    dict(channel="AWGN", decoder="sumproduct", channel_param=0.85),
    dict(channel="BSC", channel_param=0.06, soft_msg_dtype="int8",
         expurgation=1)])
def test_engine_float_soft_and_expurgation_go_to_expand(monkeypatch, pairs,
                                                        fields):
    _, code = pairs["regular"]
    cfg = _config(code, "regular", **fields)
    calls = _spy(monkeypatch)
    res = mc.run_simulation(cfg, code=code, device="cpu")
    assert not calls
    generic = mc.run_simulation(cfg, code=code.expand(), device="cpu")
    for f in COUNTERS:
        assert getattr(res, f) == getattr(generic, f), f


# ---------------------------------------------------------------------------
# S2's int8 lane arithmetic (csrc/qc_soft_check.cu), modelled in numpy
# ---------------------------------------------------------------------------

_SIGN_BITS = np.uint32(0x80808080)
_CAP = np.uint32(0x7F7F7F7F)


def _lanes(words):
    """uint32 words -> int16 view of their four signed bytes, [..., 4]."""
    return words[..., None].view(np.int8).reshape(*words.shape, 4) \
        .astype(np.int16)


def _words(lanes):
    """int16 bytes [..., 4] (each in [-128, 255]) -> uint32 words."""
    return np.ascontiguousarray((lanes & 0xFF).astype(np.uint8)) \
        .view(np.uint32)[..., 0]


def _vsubss4(a, b):       # __vsubss4: signed bytes, saturated
    return _words(np.clip(_lanes(a) - _lanes(b), -128, 127))


def _vabsss4(a):          # __vabsss4: |signed byte|, saturated
    return _words(np.minimum(np.abs(_lanes(a)), 127))


def _unsigned(a):
    return _lanes(a) & 0xFF


def _vminu4(a, b):
    return _words(np.minimum(_unsigned(a), _unsigned(b)))


def _vmaxu4(a, b):
    return _words(np.maximum(_unsigned(a), _unsigned(b)))


def _vcmpeq4(a, b):
    return _words(np.where(_unsigned(a) == _unsigned(b), 0xFF, 0))


def _sign_bytes(a):       # prmt.b32 a, 0, 0xBA98
    return _words(np.where(_lanes(a) < 0, 0xFF, 0))


def _negate_bytes(a):     # 32-bit arithmetic, as the kernel does it
    return (_SIGN_BITS - a) ^ _SIGN_BITS


def _packed_check(p, m):
    """The kernel's int8 path on dc planes of words (uint32 [dc, N]): the
    new message words and the unsatisfied count, step by step as in
    qc_soft_check_int8_kernel."""
    m1 = np.full(p.shape[1], _CAP)
    m2 = m1.copy()
    signs = np.zeros_like(m1)
    parity = np.zeros_like(m1)
    r = []
    for pj, mj in zip(p, m):
        x = _vsubss4(pj, mj)
        a = _vabsss4(x)
        r.append(x)
        parity ^= pj
        signs ^= x
        m2 = _vminu4(m2, _vmaxu4(m1, a))
        m1 = _vminu4(m1, a)
    out = []
    for x in r:
        at_min = _vcmpeq4(_vabsss4(x), m1)
        mag = m1 ^ (at_min & (m1 ^ m2))
        neg = _sign_bytes(signs ^ x)
        out.append(mag ^ (neg & (mag ^ _negate_bytes(mag))))
    bad = sum(bin(int(w)).count("1") for w in parity & _SIGN_BITS)
    return np.stack(out), bad


def _hold_to_jax(p8, m8):
    """p8, m8: int8 [dc, B] (B a multiple of 4): the packed model equals
    JAX's _check_update_minsum(mag_cap=127) on int16 planes, and its
    syndrome count equals the XOR of the signs of p."""
    from iib_project_ldpc_codes_tpu.ops.soft_bp import _check_update_minsum
    got, bad = _packed_check(p8.view(np.uint32), m8.view(np.uint32))
    r = [jnp.asarray(pj.astype(np.int16) - mj.astype(np.int16))
         for pj, mj in zip(p8, m8)]
    want = np.stack([np.asarray(o) for o in _check_update_minsum(
        r, 1.0, 0.0, mag_cap=127)])
    assert want.dtype == np.int16 and np.abs(want).max() <= 127
    np.testing.assert_array_equal(got.view(np.int8), want.astype(np.int8))
    assert bad == int(np.bitwise_xor.reduce(p8 < 0, axis=0).sum())


_EDGE_VALUES = np.array([-127, -64, -1, 0, 1, 64, 127], np.int8)


@pytest.mark.parametrize("dc", [1, 2, 3])
def test_int8_lane_model_equals_jax_exhaustively(dc):
    """Every (p, m) of every socket over {-127, -64, -1, 0, 1, 64, 127}:
    r hits +-254, +-128, +-127 and 0, ties at the minimum and all-zero
    extrinsics."""
    v = len(_EDGE_VALUES)
    idx = np.indices((v,) * (2 * dc)).reshape(2 * dc, -1)
    pad = -idx.shape[1] % 4
    idx = np.pad(idx, ((0, 0), (0, pad)))
    planes = _EDGE_VALUES[idx]
    _hold_to_jax(planes[:dc], planes[dc:])


@pytest.mark.parametrize("dc", range(1, 11))
def test_int8_lane_model_equals_jax_on_draws(dc):
    """Seeded draws over the whole int8 range (-128 included), half of them
    from the edge values, so ties and saturation are common."""
    rng = np.random.default_rng(dc)
    shape = (dc, 4096)
    full = rng.integers(-128, 128, size=(2,) + shape).astype(np.int8)
    edge = rng.choice(_EDGE_VALUES, size=(2,) + shape)
    planes = np.where(rng.random((2,) + shape) < 0.5, full, edge)
    _hold_to_jax(planes[0], planes[1])
