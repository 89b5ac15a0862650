"""The port's edge-sharded erasure BP against the JAX package, in one process.

The local round of every shard of D ranks (D in 1, 2, 4, 8) must equal
JAX's ``_local_round`` bit for bit, on a regular code and on a phantom-
padded irregular one; the whole decode at world size 1 must equal the
port's unsharded decode and JAX's edge-sharded decode over D = 1, 4 and 8
virtual devices (``known``, ``error_totals``, ``iterations``); the
edge-sharded Monte Carlo must equal the unsharded engine counter for
counter.  Real process groups (D = 2, 4 over gloo) are in
``tests/test_torch_distributed.py``.  Inputs are drawn with numpy and
handed to both packages.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models.ensemble import sample_code as \
    jax_sample_code
from iib_project_ldpc_codes_tpu.models.irregular import \
    IrregularEnsembleSpec as JaxSpec
from iib_project_ldpc_codes_tpu.parallel import edge_sharded as jes
from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.ensemble import sample_code
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.qc import sample_qc_code
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp
from iib_project_ldpc_codes_tpu_torch.ops.bitops import pack_bits
from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es
from iib_project_ldpc_codes_tpu_torch.parallel import mesh
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]


def _codes(kind, n, seed):
    """(JAX code, the same code in the port)."""
    if kind == "regular":
        jcode = jax_sample_code(jax.random.key(seed), n, 3, 6)
        return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, 3, 6)
    jcode = JaxSpec.from_lam_rho(n, LAM, RHO).sample(jax.random.key(seed))
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    return jcode, irregular_code_from_numpy(*tables, jcode.n, jcode.m)


def _erased(n, words, eps, seed):
    """int32[n, W] erasure planes from numpy, and their uint32 for JAX."""
    bits = np.random.default_rng(seed).random((n, 32 * words)) < eps
    planes = pack_bits(torch.from_numpy(bits))
    return planes, jnp.asarray(planes.numpy().view(np.uint32))


def _shard_tables(kind, jcode, code, size):
    """The decode's (check rows, variable table) as JAX pads them, in both
    packages (edge_sharded.py:110-123)."""
    if kind == "regular":
        return (np.asarray(jcode.chk_to_var), np.asarray(jcode.var_to_chk),
                code.chk_to_var, code.var_to_chk)
    extra = (-(code.m + 1)) % size
    chk = np.concatenate([np.asarray(jcode.chk_to_var),
                          np.full((extra, code.dc_max), code.n, np.int32)])
    return (chk, np.asarray(jcode.var_to_chk), torch.from_numpy(chk),
            code.var_to_chk)


@pytest.mark.parametrize("kind, n", [("regular", 384), ("irregular", 360)])
@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_local_round_every_shard_equals_jax(kind, n, size):
    jcode, code = _codes(kind, n, seed=size)
    rows = n + (kind == "irregular")             # the phantom row
    erased, _ = _erased(rows, 3, 0.45, seed=10 + size)
    if kind == "irregular":
        erased[-1] = 0                            # the phantom is known
    # a state a few rounds in: known grows, some checks resolve
    state = erasure_bp.bp_decode_packed_allzero(
        erasure_bp._phantom_view(code) if kind == "irregular" else code,
        erased, 2).known
    j_chk, j_var, chk, var = _shard_tables(kind, jcode, code, size)
    m_local = mesh.shard_rows(chk.shape[0], size)
    j_known = jnp.asarray(state.numpy().view(np.uint32))
    dc, dv = chk.shape[1], var.shape[1]
    nonzero = 0
    for r in range(size):
        off = r * m_local
        got = es._local_round(chk[off:off + m_local], var, off, state)
        want = jes._local_round(jnp.asarray(j_chk[off:off + m_local]),
                                jnp.asarray(j_var), off, j_known, dc, dv)
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
        nonzero += int((got != 0).sum())
    assert nonzero > 0          # the shards resolve something


def test_or_reduce_update_plain_is_or_and_count():
    rng = np.random.default_rng(3)
    gathered = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 40, 5),
                                             dtype=np.int64).astype(np.int32))
    known = torch.from_numpy(rng.integers(-2**31, 2**31, (40, 5),
                                          dtype=np.int64).astype(np.int32))
    want = known.numpy().view(np.uint32) | np.bitwise_or.reduce(
        gathered.numpy().view(np.uint32), axis=0)
    errors = torch.zeros(4, dtype=torch.int32)
    es.or_reduce_update(gathered, known, errors, 2)
    assert np.array_equal(known.numpy().view(np.uint32), want)
    assert int(errors[2]) == int(np.unpackbits((~want).view(np.uint8)).sum())
    assert errors[[0, 1, 3]].tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="does not stack"):
        es.or_reduce_update(gathered[:, :39].contiguous(), known, errors, 1)


def test_edge_candidates_masks_checks_outside_the_shard():
    var = torch.tensor([[0, 3, 5], [6, 7, 2]], dtype=torch.int32)
    ex = torch.tensor([[1], [2], [4]], dtype=torch.int32)   # checks 2..4
    got = es.edge_candidates(var, ex, 2)
    assert got[:, 0].tolist() == [2, 1]      # v0: check 3; v1: check 2


@pytest.mark.parametrize("kind, n", [("regular", 384), ("irregular", 360)])
@pytest.mark.parametrize("eps", [0.35, 0.45])
def test_decode_equals_unsharded_and_jax_meshes(kind, n, eps):
    jcode, code = _codes(kind, n, seed=int(eps * 100))
    erased, j_erased = _erased(n, 2, eps, seed=int(eps * 1000))
    if kind == "regular":
        got = es.edge_sharded_bp_decode(code, erased, 60)
        ref = erasure_bp.bp_decode_packed_allzero(code, erased, 60)
        jax_decode = jes.edge_sharded_bp_decode
    else:
        got = es.edge_sharded_bp_decode_irregular(code, erased, 60)
        ref = erasure_bp.bp_decode_packed_allzero_irregular(code, erased, 60)
        jax_decode = jes.edge_sharded_bp_decode_irregular
    assert torch.equal(got.known, ref.known)
    assert torch.equal(got.error_totals, ref.error_totals)
    assert got.iterations == ref.iterations > 1
    for size in (1, 4, 8):
        want = jax_decode(jcode, j_erased, 60,
                          make_mesh(jax.devices()[:size]))
        assert np.array_equal(got.known.numpy().view(np.uint32),
                              np.asarray(want.known))
        assert np.array_equal(got.error_totals.numpy(),
                              np.asarray(want.error_totals))
        assert got.iterations == int(want.iterations)


def test_divisibility_errors_match_jax():
    jcode, code = _codes("regular", 100, seed=3)       # m = 50
    with pytest.raises(ValueError) as want:
        jes._edge_sharded_core(jcode.chk_to_var, jcode.var_to_chk,
                               jnp.zeros((100, 1), jnp.uint32), 3, 6, 10,
                               make_mesh(jax.devices()[:8]))
    with pytest.raises(ValueError) as got:
        mesh.shard_rows(code.m, 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="batch must divide by 32"):
        mc.make_chunk_fn(SimulationConfig(n=100, batch=96,
                                          code_mode="fixed"), code,
                         device="cpu", rank=1, size=2)


def _bec_cfg(**kw):
    base = dict(channel="BEC", channel_param=0.42, n=512, dv=3, dc=6,
                decoder="bp", iterations=60, num_tests=256, batch=64,
                max_block_errors=10**9, seed=31, code_mode="fixed")
    base.update(kw)
    return SimulationConfig(**base)


def _counters(r):
    return (r.num_trials, r.block_errors, r.bit_errors, r.bit_errors_sq,
            r.excluded_trials, r.error_counts_per_iteration, r.stopped_by)


@pytest.mark.parametrize("kind", ["regular", "irregular", "qc"])
def test_edge_sharded_run_equals_unsharded(kind):
    if kind == "qc":
        code = sample_qc_code(torch.Generator().manual_seed(5), nb=12, dv=3,
                              dc=6, Z=40)
        kw = dict(n=code.n)
    elif kind == "irregular":
        code, kw = _codes("irregular", 512, 6)[1], dict(lam=LAM, rho=RHO,
                                                         dv=None, dc=None)
    else:
        code, kw = _codes("regular", 512, 8)[1], {}
    plain = mc.run_simulation(_bec_cfg(**kw), code, device="cpu")
    sharded = mc.run_simulation(_bec_cfg(edge_sharded=True, **kw), code,
                                device="cpu")
    assert _counters(sharded) == _counters(plain)
    assert 0 < plain.block_errors < plain.num_trials
    # the chunk itself: equal to make_chunk_fn's, which ignores the flag
    cfg = _bec_cfg(edge_sharded=True, **kw)
    a = mc.make_edge_sharded_chunk_fn(cfg, code, device="cpu")(3)
    b = mc.make_chunk_fn(cfg, code, device="cpu")(3)
    for f in ("error_totals", "block_errors", "bit_errors", "excluded",
              "bit_errors_sq"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_edge_sharded_stopping_and_checkpoint(tmp_path):
    code = _codes("regular", 1024, 9)[1]
    kw = dict(channel_param=0.45, n=1024, iterations=50, num_tests=512,
              seed=5, edge_sharded=True)
    res = mc.run_simulation(_bec_cfg(max_block_errors=5, **kw), code,
                            device="cpu")
    assert res.stopped_by == "block_errors" and res.block_errors >= 5
    full = mc.run_simulation(_bec_cfg(**kw), code, device="cpu")
    ck = str(tmp_path / "es.ck")
    mc.run_simulation(_bec_cfg(checkpoint_path=ck, checkpoint_every_chunks=1,
                               **dict(kw, num_tests=256)), code,
                      device="cpu")
    resumed = mc.run_simulation(_bec_cfg(checkpoint_path=ck,
                                         checkpoint_every_chunks=1, **kw),
                                code, device="cpu")
    assert _counters(resumed)[:6] == _counters(full)[:6]
    assert json.load(open(ck))["chunk_idx"] == 512 // 64


def test_edge_sharded_chunk_checks_its_code():
    code = _codes("regular", 512, 8)[1]
    with pytest.raises(ValueError, match="requires a fixed code"):
        mc.make_edge_sharded_chunk_fn(_bec_cfg(edge_sharded=True), None,
                                      device="cpu")
    with pytest.raises(ValueError, match="n=512 != cfg.n=256"):
        mc.make_edge_sharded_chunk_fn(_bec_cfg(n=256, edge_sharded=True),
                                      code, device="cpu")
    with pytest.raises(ValueError, match="requires BEC"):
        _bec_cfg(edge_sharded=True, channel="BSC", decoder="gallager")


def test_cli_edge_sharded_equals_plain(tmp_path, capsys):
    argv = ["0.42", "256", "40", "512", "3", "6", "3", "2", "--device=cpu"]
    assert cli.main(argv + [f"--output-dir={tmp_path / 'a'}"]) == 0
    assert cli.main(argv + ["--edge-sharded", "--devices=1",
                            f"--output-dir={tmp_path / 'b'}"]) == 0
    out = capsys.readouterr().out
    assert out.count("wrote ") == 2
    (a,), (b,) = (glob.glob(str(tmp_path / d / "*.json")) for d in "ab")
    ra, rb = json.load(open(a)), json.load(open(b))
    assert rb["config"]["edge_sharded"] and not ra["config"]["edge_sharded"]
    for f in ("num_trials", "block_errors", "bit_errors",
              "error_counts_per_iteration", "bit_errors_sq"):
        assert ra[f] == rb[f], f


def test_cli_devices_must_match_the_job():
    argv = ["0.42", "64", "10", "96", "3", "6", "3", "2", "--device=cpu"]
    with pytest.raises(ValueError, match="--devices=2 but this process runs "
                                         "in a job of 1 device"):
        cli.main(argv + ["--devices=2"])
    with pytest.raises(ValueError, match="requires a fixed code"):
        cli.main(["0.42", "64", "10", "96", "3", "6", "0", "2",
                  "--device=cpu", "--edge-sharded"])


def test_port_edge_decode_on_a_fresh_code_decodes_below_threshold():
    n = 4096
    code = sample_code(torch.Generator().manual_seed(4), n, 3, 6)
    erased, _ = _erased(n, 1, 0.40, seed=5)
    res = es.edge_sharded_bp_decode(code, erased, 100)
    assert float(res.failed.float().mean()) < 0.3
    assert int(res.error_totals[-1]) <= int(res.error_totals[0])
