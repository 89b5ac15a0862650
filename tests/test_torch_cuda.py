"""The port's CUDA kernels against their plain versions, on the GPU.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither ``jax`` nor the JAX package, so it also runs where JAX is
not installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The shapes are ragged on purpose (word counts that are not multiples of
32, row counts below one block of walkers, sizes that do not fill a
block, words per code of 1, 3 and 24), so that every kernel's edge masking
is exercised; the headline shapes are covered by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu_torch.models import ensemble
from iib_project_ldpc_codes_tpu_torch.models.code import validate_code
from iib_project_ldpc_codes_tpu_torch.models.ensemble import sample_code
from iib_project_ldpc_codes_tpu_torch.ops import bitops, erasure_bp
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _code(n, seed=0, device="cpu"):
    return sample_code(torch.Generator().manual_seed(seed), n, 3, 6,
                       device=device)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (97, 33), (1000, 70)])
@pytest.mark.parametrize("prob", [0.0, 0.37, 1.0])
def test_bernoulli_packed_kernel_equals_plain_and_cpu(cuda, shape, prob):
    got = bitops.bernoulli_packed(prob, shape, seed=2**40 + 3,
                                  offset=2**32 + 7, device=cuda)
    cpu = bitops.bernoulli_packed(prob, shape, seed=2**40 + 3,
                                  offset=2**32 + 7, device="cpu")
    assert got.dtype == torch.int32 and got.shape == shape
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("prob, nibble", [
    (0.5, 0b0001), (0.7, 0b1001), (0.8, 0b1101), (0.9, 0b1111)])
def test_bernoulli_kernel_known_answer(cuda, prob, nibble):
    # bits 0-3 of word 0 at seed 0, offset 0 are the four lanes of Philox
    # at counter 0, key 0 (6627e8d5 e169c58d bc57ac4c 9b00dbd8), each set
    # iff below floor(p * 2^32)
    word = bitops.bernoulli_packed(prob, (1, 1), seed=0, device=cuda)
    assert int(word[0, 0]) & 0xF == nibble


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (9, 33), (4000, 65)])
def test_per_trial_counts_kernel_equals_plain(cuda, shape):
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=shape,
                                          dtype=np.int64).astype(np.int32))
    got = bitops.per_trial_counts(words.to(cuda))
    assert torch.equal(got.cpu(), bitops._per_trial_counts_plain(words))
    ones = torch.full(shape, -1, dtype=torch.int32, device=cuda)
    assert bool((bitops.per_trial_counts(ones) == shape[0]).all())


@pytest.mark.parametrize("n, words", [(12, 1), (96, 7), (600, 33)])
@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_check_and_variable_kernels_equal_plain(cuda, n, words, eps):
    code = _code(n, seed=n)
    erased = bitops.bernoulli_packed(eps, (n, words), seed=1)
    known = ~erased
    ex_cpu = erasure_bp.check_exactly_one(code.chk_to_var, known)
    code_gpu = code.to(cuda)
    ex_gpu = erasure_bp.check_exactly_one(code_gpu.chk_to_var, known.to(cuda))
    assert torch.equal(ex_gpu.cpu(), ex_cpu)
    errors_cpu = torch.zeros(2, dtype=torch.int32)
    erasure_bp.variable_or_update(code.var_to_chk, ex_cpu, known,
                                  errors_cpu, 1)
    known_gpu = (~erased).to(cuda)
    errors_gpu = torch.zeros(2, dtype=torch.int32, device=cuda)
    erasure_bp.variable_or_update(code_gpu.var_to_chk, ex_gpu, known_gpu,
                                  errors_gpu, 1)
    assert torch.equal(known_gpu.cpu(), known)
    assert torch.equal(errors_gpu.cpu(), errors_cpu)


@pytest.mark.parametrize("max_iters", [0, 1, 3, 50])
def test_decode_on_gpu_equals_cpu(cuda, max_iters):
    code = _code(504, seed=1)
    erased = bitops.bernoulli_packed(0.42, (504, 9), seed=3)
    cpu = erasure_bp.bp_decode_packed_allzero(code, erased, max_iters)
    gpu = erasure_bp.bp_decode_packed_allzero(code.to(cuda),
                                              erased.to(cuda), max_iters)
    assert torch.equal(gpu.known.cpu(), cpu.known)
    assert torch.equal(gpu.error_totals.cpu(), cpu.error_totals)
    assert gpu.iterations == cpu.iterations
    assert torch.equal(gpu.bit_errors.cpu(), cpu.bit_errors)


def test_wrappers_reject_mixed_devices(cuda):
    code = _code(12)
    with pytest.raises(ValueError, match="different devices"):
        erasure_bp.check_exactly_one(code.chk_to_var,
                                     torch.zeros((12, 1), dtype=torch.int32,
                                                 device=cuda))


@pytest.mark.parametrize("expurgation", [None, 1])
def test_run_simulation_gpu_equals_cpu(cuda, expurgation):
    cfg = SimulationConfig(channel_param=0.42, n=504, code_mode="fixed",
                           iterations=40, batch=320, num_tests=960, seed=4,
                           max_block_errors=10**9, expurgation=expurgation)
    code = _code(504, seed=2)
    gpu = mc.run_simulation(cfg, code, device="cuda")
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "excluded_trials", "bit_errors_sq",
                  "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


def _assert_same_codes(got, want):
    for name in ("chk_to_var", "var_to_edge", "var_to_chk"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name


@pytest.mark.parametrize("method, n, num", [
    ("raw", 12, 3), ("raw", 1002, 40), ("repair", 96, 5),
    ("repair", 2000, 64), ("reject", 60, 4), ("reject", 300, 8)])
def test_sampler_kernel_equals_plain(cuda, method, n, num):
    got = ensemble.sample_codes(9, 5, num, n, 3, 6, method, device=cuda)
    assert got.chk_to_var.is_cuda and got.batched
    _assert_same_codes(got, ensemble.sample_codes(9, 5, num, n, 3, 6,
                                                  method))
    if method != "raw":
        assert validate_code(got) == (True, "ok")


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_kernel_global_memory_path(cuda, method, monkeypatch):
    # a permutation too large for shared memory lives in a global scratch
    # buffer; force that path at a small size
    monkeypatch.setattr(ensemble, "SHARED_PERM_MAX_SOCKETS", 0)
    got = ensemble.sample_codes(3, 1, 6, 200, 3, 6, method, device=cuda)
    _assert_same_codes(got, ensemble.sample_codes(3, 1, 6, 200, 3, 6,
                                                  method))


@pytest.mark.parametrize("wpc", [1, 3, 24])
@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_batched_check_and_variable_kernels_equal_plain(cuda, wpc, eps):
    n, num = 600, 7
    codes = ensemble.sample_codes(1, 0, num, n, 3, 6, "raw")
    erased = bitops.bernoulli_packed(eps, (n, num * wpc), seed=wpc)
    known = ~erased
    ex_cpu = erasure_bp.check_exactly_one(codes.chk_to_var, known)
    gpu = codes.to(cuda)
    ex_gpu = erasure_bp.check_exactly_one(gpu.chk_to_var, known.to(cuda))
    assert torch.equal(ex_gpu.cpu(), ex_cpu)
    errors_cpu = torch.zeros(2, dtype=torch.int32)
    erasure_bp.variable_or_update(codes.var_to_chk, ex_cpu, known,
                                  errors_cpu, 1)
    known_gpu = (~erased).to(cuda)
    errors_gpu = torch.zeros(2, dtype=torch.int32, device=cuda)
    erasure_bp.variable_or_update(gpu.var_to_chk, ex_gpu, known_gpu,
                                  errors_gpu, 1)
    assert torch.equal(known_gpu.cpu(), known)
    assert torch.equal(errors_gpu.cpu(), errors_cpu)
    # a batch of one code equals the single-code call
    one = gpu.select(0)
    plane = known_gpu[:, :wpc].contiguous()
    assert torch.equal(
        erasure_bp.check_exactly_one(one.chk_to_var[None], plane),
        erasure_bp.check_exactly_one(one.chk_to_var, plane))


@pytest.mark.parametrize("sampler, expurgation", [
    ("repair", None), ("raw", 1), ("reject", None)])
def test_ensemble_run_gpu_equals_cpu(cuda, sampler, expurgation):
    cfg = SimulationConfig(channel_param=0.42, n=504, code_mode="ensemble",
                           iterations=40, batch=640, num_tests=1920, seed=4,
                           codes_per_chunk=10, sampler=sampler,
                           max_block_errors=10**9, expurgation=expurgation)
    gpu = mc.run_simulation(cfg, device="cuda")
    cpu = mc.run_simulation(cfg, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "excluded_trials", "bit_errors_sq", "code_bit_errors_sq",
                  "trials_per_code", "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field
