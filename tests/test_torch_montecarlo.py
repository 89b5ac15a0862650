"""The port's Monte Carlo engine and CLI against the JAX package.

Chunk statistics on the same code and planes must equal the JAX engine's
(``bit_errors_sq`` to rel 1e-6: float64 here, float32 in JAX).  Whole runs
draw from different generators, so their FER and BER are held to
overlapping 99% Wilson intervals on the same code.
"""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models.ensemble import sample_code as \
    jax_sample_code
from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed as \
    jax_bernoulli_packed
from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
from iib_project_ldpc_codes_tpu.utils.combine import combine_results
from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig as \
    JaxConfig
from iib_project_ldpc_codes_tpu.utils.results import load_result as \
    jax_load_result
from iib_project_ldpc_codes_tpu.utils.stats import wilson
from iib_project_ldpc_codes_tpu_torch import cli
from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig
from iib_project_ldpc_codes_tpu_torch.utils.results import load_result, \
    save_result


def _codes(n, seed=0):
    jcode = jax_sample_code(jax.random.key(200 + seed), n, 3, 6)
    return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, 3, 6)


def _cfg(**kw):
    base = dict(channel_param=0.4, n=256, code_mode="fixed", iterations=30,
                batch=256, num_tests=512, max_block_errors=10**9, seed=3)
    base.update(kw)
    return SimulationConfig(**base)


@pytest.mark.parametrize("eps", [0.35, 0.45])
@pytest.mark.parametrize("expurgation", [None, 0, 3])
def test_chunk_stats_match_jax(eps, expurgation):
    n, words, iters = 256, 8, 40
    jcode, code = _codes(n)
    key = jax.random.key(17)
    # the JAX chunk draws these planes from its key; hand them to the port
    planes = jax_bernoulli_packed(key, eps, (n, words))
    want = jmc._bp_chunk(jcode, key, n=n, words=words, iterations=iters,
                         erasure_prob=eps, expurgation=expurgation)
    got = mc._bp_chunk(
        code, torch.from_numpy(np.asarray(planes).view(np.int32).copy()),
        iterations=iters, expurgation=expurgation)
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert int(got.block_errors) == int(want.block_errors)
    assert int(got.bit_errors) == int(want.bit_errors)
    assert int(got.excluded) == int(want.excluded)
    assert float(got.bit_errors_sq) == pytest.approx(
        float(want.bit_errors_sq), rel=1e-6)
    if expurgation is not None:
        assert int(got.excluded) > 0


def test_run_simulation_agrees_with_jax():
    n = 1024
    jcode, code = _codes(n, seed=1)
    fields = dict(channel="BEC", channel_param=0.40, n=n, dv=3, dc=6,
                  decoder="bp", iterations=50, num_tests=4096, batch=1024,
                  max_block_errors=10**9, code_mode="fixed", seed=5)
    ours = mc.run_simulation(SimulationConfig(**fields), code, device="cpu")
    theirs = jmc.run_simulation(JaxConfig(**fields), code=jcode)
    assert ours.num_trials == theirs.num_trials == 4096
    # BER: bit errors cluster within trials, so the interval is taken over
    # trials, each contributing its erased fraction in [0, 1] (variance at
    # most p(1-p), so the Wilson interval at 4096 trials is conservative)
    for errors_a, errors_b, trials in (
            (ours.block_errors, theirs.block_errors, 4096),
            (ours.bit_errors / n, theirs.bit_errors / n, 4096)):
        lo_a, hi_a = wilson(errors_a, trials, alpha=0.01)
        lo_b, hi_b = wilson(errors_b, trials, alpha=0.01)
        assert lo_a <= hi_b and lo_b <= hi_a, (errors_a, errors_b)
    # the verify anchor: FER ~0.09 at (3,6), n=1024, eps=0.40
    assert 0.05 <= ours.block_error_rate <= 0.14
    assert abs(ours.error_rate_per_iteration[0] - 0.40) < 0.005


def test_run_simulation_is_deterministic():
    _, code = _codes(256, seed=2)
    a = mc.run_simulation(_cfg(), code, device="cpu")
    b = mc.run_simulation(_cfg(), code, device="cpu")
    assert a.error_counts_per_iteration == b.error_counts_per_iteration
    assert (a.block_errors, a.bit_errors, a.bit_errors_sq) == (
        b.block_errors, b.bit_errors, b.bit_errors_sq)
    c = mc.run_simulation(_cfg(seed=4), code, device="cpu")
    assert c.error_counts_per_iteration != a.error_counts_per_iteration


def test_checkpoint_resume_is_bit_identical(tmp_path):
    _, code = _codes(256, seed=3)
    full = mc.run_simulation(_cfg(num_tests=1024), code, device="cpu")
    ck = str(tmp_path / "ck.json")
    half = mc.run_simulation(_cfg(num_tests=512, checkpoint_path=ck,
                                  checkpoint_every_chunks=1), code,
                             device="cpu")
    assert half.num_trials == 512
    with open(ck) as f:
        assert json.load(f)["chunk_idx"] == 2
    resumed = mc.run_simulation(_cfg(num_tests=1024, checkpoint_path=ck),
                                code, device="cpu")
    assert resumed.num_trials == 1024
    assert resumed.error_counts_per_iteration == \
        full.error_counts_per_iteration
    assert (resumed.block_errors, resumed.bit_errors) == (
        full.block_errors, full.bit_errors)
    assert resumed.bit_errors_sq == full.bit_errors_sq
    # a checkpoint of another seed is ignored
    other = mc.run_simulation(_cfg(num_tests=256, seed=99,
                                   checkpoint_path=ck), code, device="cpu")
    assert other.num_trials == 256


@pytest.mark.parametrize("stop, kw", [
    ("num_tests", dict()),
    ("block_errors", dict(channel_param=0.45, max_block_errors=1)),
    ("wall_clock", dict(max_seconds=-1.0)),
])
def test_stopping_rules(stop, kw):
    _, code = _codes(256, seed=4)
    res = mc.run_simulation(_cfg(**kw), code, device="cpu")
    assert res.stopped_by == stop
    assert res.num_trials == (512 if stop == "num_tests" else 256)


def test_expurgated_run_counts_excluded_trials():
    _, code = _codes(256, seed=5)
    res = mc.run_simulation(_cfg(expurgation=2), code, device="cpu")
    plain = mc.run_simulation(_cfg(), code, device="cpu")
    assert res.excluded_trials > 0
    assert res.block_errors <= plain.block_errors
    assert res.error_counts_per_iteration[0] < \
        plain.error_counts_per_iteration[0]


def test_result_loads_and_combines_in_jax(tmp_path):
    _, code = _codes(256, seed=6)
    a = mc.run_simulation(_cfg(), code, device="cpu")
    b = mc.run_simulation(_cfg(seed=8), code, device="cpu")
    paths = [save_result(r, str(tmp_path / name))
             for r, name in ((a, "a"), (b, "b"))]
    loaded = [jax_load_result(p) for p in paths]
    assert loaded[0].error_counts_per_iteration == \
        a.error_counts_per_iteration
    merged = combine_results(loaded)
    assert merged.num_trials == 1024
    assert merged.block_errors == a.block_errors + b.block_errors
    assert merged.bit_errors_sq == pytest.approx(a.bit_errors_sq
                                                 + b.bit_errors_sq)
    assert load_result(paths[0]) == a


@pytest.mark.parametrize("kw, item", [
    (dict(code_mode="ensemble", lam=[0, 0.5, 0.5], rho=[0, 0, 0, 0, 0, 1.0],
          channel="BSC", decoder="minsum", transmit="random"), "item 11"),
    (dict(decoder="ml"), "item 14"),
    (dict(decoder="peeling"), "item 14"),
    (dict(channel="BSC", decoder="gallager", transmit="random"), "item 11"),
    (dict(channel="AWGN", decoder="minsum", transmit="random"), "item 11"),
    (dict(transmit="random"), "item 11"),
    (dict(edge_sharded=True), "item 13"),
])
def test_unported_modes_name_their_roadmap_item(kw, item):
    _, code = _codes(256, seed=7)
    if item == "item 11":
        # random-codeword transmit (ROADMAP queue 1 item 11) is ported: the
        # chunk runs, its channel errors counted against the codewords
        stats = mc.make_chunk_fn(_cfg(**kw), code, device="cpu")(0)
        assert stats.error_totals.shape == (31,)
        assert int(stats.error_totals[0]) > 0
        assert 0 <= int(stats.block_errors) <= 256
        return
    if kw.get("decoder") == "peeling":
        # the peeling decoder (the device part of item 14) is ported: as in
        # JAX, make_chunk_fn refers it to run_simulation's own driver,
        # which runs it
        with pytest.raises(NotImplementedError, match="own host driver"):
            mc.make_chunk_fn(_cfg(**kw), code, device="cpu")
        res = mc.run_simulation(_cfg(**kw), code, device="cpu")
        assert res.num_trials == 512 and res.error_rate_per_iteration == []
        assert 0 <= res.block_errors <= 512
        return
    if item == "item 13":
        # edge sharding (item 13) is ported: as in JAX, make_chunk_fn does
        # not read the flag, and run_simulation's edge-sharded chunk counts
        # exactly what it counts
        ours = mc.make_chunk_fn(_cfg(**kw), code, device="cpu")(1)
        edge = mc.make_edge_sharded_chunk_fn(_cfg(**kw), code,
                                             device="cpu")(1)
        for f in ("error_totals", "block_errors", "bit_errors",
                  "bit_errors_sq"):
            assert torch.equal(getattr(ours, f), getattr(edge, f)), f
        assert int(ours.error_totals[0]) > 0
        return
    with pytest.raises(NotImplementedError, match=item):
        mc.make_chunk_fn(_cfg(**kw), code, device="cpu")


def test_make_chunk_fn_checks_its_code():
    _, code = _codes(256, seed=7)
    with pytest.raises(ValueError, match="requires a code"):
        mc.make_chunk_fn(_cfg(), None, device="cpu")
    with pytest.raises(ValueError, match="config"):
        mc.make_chunk_fn(_cfg(n=512), code, device="cpu")


def test_cli_mode3_on_cpu(tmp_path, capsys):
    rc = cli.main(["0.40", "512", "20", "96", "3", "6", "3", "2",
                   f"--output-dir={tmp_path}", "--device=cpu"])
    assert rc == 0
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert len(files) == 1 and "code_number=2" in files[0]
    res = jax_load_result(files[0])
    assert res.num_trials == 1024 and res.config.code_mode == "fixed"
    assert "wrote" in capsys.readouterr().out


def test_cli_config_file(tmp_path):
    cfg = _cfg(n=96, num_tests=256, output_dir=str(tmp_path / "out"))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    assert cli.main(["--config", str(path), "--device", "cpu"]) == 0
    (res_path,) = glob.glob(str(tmp_path / "out" / "*.json"))
    res = load_result(res_path)
    assert dataclasses.asdict(res.config) == dataclasses.asdict(cfg)


def test_cli_defaults_to_cuda_and_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["0.40", "64", "20", "96", "3", "6", "3",
            f"--output-dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cli.main(argv + ["--device=tpu"])
    with pytest.raises(ValueError, match="unknown flag"):
        cli.main(argv + ["--platform=cpu"])
    with pytest.raises(ValueError, match="needs a value"):
        cli.main(argv + ["--device"])
    assert cli.main(["0.4"]) == 2
