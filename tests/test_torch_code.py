"""The port's code container, npz store, sampler, config and results IO
against the JAX package, plus the port's independence from ``jax``."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models.code import (
    dense_parity_check as jax_dense_parity_check)
from iib_project_ldpc_codes_tpu.models.ensemble import sample_code as \
    jax_sample_code
from iib_project_ldpc_codes_tpu.models.store import (
    load_code as jax_load_code, save_code as jax_save_code)
from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig as \
    JaxConfig
from iib_project_ldpc_codes_tpu_torch.models import ensemble, store
from iib_project_ldpc_codes_tpu_torch.models.code import (
    LDPCCode, code_from_checks, code_from_numpy, dense_parity_check,
    validate_code)
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_and_port_code(n, seed, method="repair", dv=3, dc=6):
    jcode = jax_sample_code(jax.random.key(seed), n, dv, dc, method)
    return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, dv, dc)


@pytest.mark.parametrize("n, seed, method", [
    (96, 0, "repair"), (1024, 1, "repair"), (200, 2, "raw"),
    (60, 3, "reject")])
def test_tables_match_jax(n, seed, method):
    jcode, code = _jax_and_port_code(n, seed, method)
    assert code.chk_to_var.dtype == torch.int32
    assert np.array_equal(code.chk_to_var.numpy(),
                          np.asarray(jcode.chk_to_var))
    assert np.array_equal(code.var_to_edge.numpy(),
                          np.asarray(jcode.var_to_edge))
    assert np.array_equal(code.var_to_chk.numpy(),
                          np.asarray(jcode.var_to_chk))
    assert (code.m, code.k, code.rate, code.num_edges) == (
        jcode.m, jcode.k, jcode.rate, jcode.num_edges)
    assert np.array_equal(dense_parity_check(code),
                          jax_dense_parity_check(jcode))


def test_code_from_checks_is_stable_with_multi_edges():
    # variable 0 twice in check 0: a stable argsort keeps edge order
    chk = np.array([[0, 0, 1, 2], [1, 2, 3, 3]], np.int32)
    code = code_from_numpy(chk, n=4, dv=2, dc=4)
    assert code.var_to_edge.tolist() == [[0, 1], [2, 4], [3, 5], [6, 7]]
    assert code.var_to_chk.tolist() == [[0, 0], [0, 1], [0, 1], [1, 1]]


@pytest.mark.parametrize("chk, n, dv, dc, match", [
    ([[0, 1, 2, 5]], 4, 1, 4, "out of range"),
    ([[0, 1], [0, 1]], 3, 1, 2, "divisible"),
    ([[0, 0], [1, 2]], 4, 1, 2, "degrees"),
])
def test_code_from_checks_rejects_bad_tables(chk, n, dv, dc, match):
    with pytest.raises(ValueError, match=match):
        code_from_checks(torch.tensor(chk), n, dv, dc)


def test_validate_code():
    _, code = _jax_and_port_code(96, 4)
    assert validate_code(code) == (True, "ok")
    chk = np.array([[0, 0, 1, 2], [1, 2, 3, 3]], np.int32)
    multi = code_from_numpy(chk, n=4, dv=2, dc=4)
    assert validate_code(multi) == (False,
                                    "check touches the same variable twice")
    broken = LDPCCode(chk_to_var=code.chk_to_var,
                      var_to_edge=code.var_to_edge.flip(0).contiguous(),
                      n=code.n, dv=code.dv, dc=code.dc)
    assert validate_code(broken) == (False,
                                     "var_to_edge inconsistent with chk_to_var")


def test_code_to_device_keeps_tables():
    _, code = _jax_and_port_code(48, 5)
    moved = code.to("cpu")
    assert moved.chk_to_var.device.type == "cpu"
    assert torch.equal(moved.var_to_chk, code.var_to_chk)


def test_npz_port_to_jax(tmp_path):
    _, code = _jax_and_port_code(120, 6)
    path = str(tmp_path / "code.npz")
    store.save_code(code, path)
    back = jax_load_code(path)
    assert np.array_equal(np.asarray(back.var_to_edge),
                          code.var_to_edge.numpy())
    assert (back.n, back.dv, back.dc) == (code.n, code.dv, code.dc)


def test_npz_jax_to_port(tmp_path):
    jcode, _ = _jax_and_port_code(120, 7)
    path = str(tmp_path / "code.npz")
    jax_save_code(jcode, path)
    back = store.load_code(path)
    assert np.array_equal(back.chk_to_var.numpy(),
                          np.asarray(jcode.chk_to_var))
    assert np.array_equal(back.var_to_edge.numpy(),
                          np.asarray(jcode.var_to_edge))


@pytest.mark.parametrize("method", ["reject", "repair", "raw"])
def test_sampler_methods(method):
    g = torch.Generator().manual_seed(3)
    code = ensemble.sample_code(g, 300, 3, 6, method)
    counts = np.bincount(code.chk_to_var.numpy().reshape(-1), minlength=300)
    assert (counts == 3).all()
    if method != "raw":
        assert validate_code(code) == (True, "ok")
    again = ensemble.sample_code(torch.Generator().manual_seed(3), 300, 3, 6,
                                 method)
    assert torch.equal(again.chk_to_var, code.chk_to_var)


def test_sampler_rejects_bad_arguments():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="divisible"):
        ensemble.sample_check_table(g, 7, 3, 6)
    with pytest.raises(ValueError, match="method"):
        ensemble.sample_check_table(g, 8, 3, 6, "bogus")


def test_code_for_config_is_deterministic():
    cfg = SimulationConfig(n=512, code_mode="fixed", code_number=3)
    a, b = ensemble.code_for_config(cfg), ensemble.code_for_config(cfg)
    assert torch.equal(a.chk_to_var, b.chk_to_var)
    assert validate_code(a) == (True, "ok")
    other = ensemble.code_for_config(dataclasses.replace(cfg, code_number=4))
    assert not torch.equal(a.chk_to_var, other.chk_to_var)
    # an irregular configuration gets its own deterministic code
    irregular = SimulationConfig(n=512, code_mode="fixed", lam=[0, 0.5, 0.5],
                                 rho=[0, 0, 0, 0, 0, 1.0])
    a = ensemble.code_for_config(irregular)
    assert torch.equal(a.chk_to_var,
                       ensemble.code_for_config(irregular).chk_to_var)
    assert (a.n, a.dv_max, a.dc_max) == (512, 3, 6)
    with pytest.raises(ValueError, match="degree-1"):
        ensemble.code_for_config(dataclasses.replace(irregular,
                                                     lam=[0.5, 0.5]))


@pytest.mark.parametrize("argv", [
    ["0.42", "1000", "50", "512", "3", "6", "3", "7"],
    ["0.3", "64", "20", "96", "3", "6", "0", "11", "2"],
    ["0.45", "100", "200", "1000", "2", "4", "5"],
])
def test_from_reference_argv_matches_jax(argv):
    ours = dataclasses.asdict(SimulationConfig.from_reference_argv(argv))
    theirs = dataclasses.asdict(JaxConfig.from_reference_argv(argv))
    assert ours == theirs


def test_config_defaults_and_json_match_jax():
    assert dataclasses.asdict(SimulationConfig()) == dataclasses.asdict(
        JaxConfig())
    cfg = SimulationConfig(channel_param=0.3, n=96, code_mode="fixed",
                           expurgation=2, batch=64)
    assert JaxConfig.from_json(cfg.to_json()) == JaxConfig(
        **json.loads(cfg.to_json()))
    assert SimulationConfig.from_json(cfg.to_json()) == cfg
    assert cfg.k == JaxConfig(**dataclasses.asdict(cfg)).k


@pytest.mark.parametrize("bad", [
    dict(batch=33), dict(channel="XYZ"), dict(decoder="bogus"),
    dict(channel="BSC", decoder="bp"), dict(n=7),
    dict(code_mode="other"), dict(transmit="other"),
    dict(soft_msg_dtype="int8", channel="AWGN", decoder="sumproduct"),
])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JaxConfig(**bad)
    with pytest.raises(ValueError):
        SimulationConfig(**bad)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import iib_project_ldpc_codes_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                 'iib_project_ldpc_codes_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_import_builds_nothing():
    from iib_project_ldpc_codes_tpu_torch.kernels import build

    assert build.source_files(), "no CUDA sources found"
    names = {p.name for p in build.source_files()}
    assert {"bernoulli_packed.cu", "check_exactly_one.cu",
            "variable_or_update.cu", "per_trial_counts.cu",
            "sample_regular_codes.cu"} <= names
    assert len(build.source_hash()) == 16
