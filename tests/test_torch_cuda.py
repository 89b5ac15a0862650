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

from iib_project_ldpc_codes_tpu_torch.models import (encode, ensemble,
                                                     irregular, qc)
from iib_project_ldpc_codes_tpu_torch.models.code import validate_code
from iib_project_ldpc_codes_tpu_torch.models.ensemble import sample_code
from iib_project_ldpc_codes_tpu_torch.ops import (bitops, channels,
                                                  erasure_bp, gallager,
                                                  peeling, qc_bp,
                                                  qc_gallager, qc_soft_bp,
                                                  soft_bp)
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


# (3,6) sizes on each side of the samplers' layout thresholds: the largest
# n whose E = 3n takes a layout and the smallest that takes the next one
_LAYOUT_EDGES = [
    (ensemble.SHARED_PARTNERS_MAX_SOCKETS // 6 * 2, ensemble.LAYOUT_ALL_SHARED),
    (ensemble.SHARED_PARTNERS_MAX_SOCKETS // 6 * 2 + 2,
     ensemble.LAYOUT_WORDS_SHARED),
    (ensemble.SHARED_PERM_MAX_SOCKETS // 6 * 2, ensemble.LAYOUT_WORDS_SHARED),
    (ensemble.SHARED_PERM_MAX_SOCKETS // 6 * 2 + 2, ensemble.LAYOUT_GLOBAL)]


@pytest.mark.parametrize("n, layout", _LAYOUT_EDGES)
@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_kernel_at_layout_edges(cuda, method, n, layout):
    assert ensemble.sampler_layout(3 * n)[0] == layout
    num = 2 if method == "reject" else 3
    rounds = torch.zeros(num, dtype=torch.int32, device=cuda)
    got = ensemble.sample_codes(6, 1, num, n, 3, 6, method, device=cuda,
                                rounds=rounds)
    _assert_same_codes(got, ensemble._sample_codes_plain(6, 1, num, n, 3, 6,
                                                         method))
    assert torch.equal(rounds.cpu().long(),
                       ensemble.first_shuffle_rounds(6, 1, num, 3 * n))


@pytest.mark.parametrize("n, layout", _LAYOUT_EDGES)
@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_irregular_sampler_kernel_at_layout_edges(cuda, method, n, layout):
    spec = irregular.IrregularEnsembleSpec.regular(n, 3, 6)
    assert ensemble.sampler_layout(spec.E)[0] == layout
    num = 2 if method == "reject" else 3
    rounds = torch.zeros(num, dtype=torch.int32, device=cuda)
    got = irregular.sample_irregular_codes(6, 1, num, spec, method,
                                           device=cuda, rounds=rounds)
    _assert_same_irregular(got, irregular._sample_irregular_codes_plain(
        6, 1, num, spec, method))
    assert torch.equal(rounds.cpu().long(),
                       ensemble.first_shuffle_rounds(6, 1, num, spec.E))


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_sampler_kernel_words_shared_path(cuda, method, monkeypatch):
    # the partners in a global scratch buffer, the words in shared memory:
    # force that layout at a small size, for both samplers
    monkeypatch.setattr(ensemble, "SHARED_PARTNERS_MAX_SOCKETS", 0)
    assert ensemble.sampler_layout(600)[0] == ensemble.LAYOUT_WORDS_SHARED
    _assert_same_codes(
        ensemble.sample_codes(3, 1, 6, 200, 3, 6, method, device=cuda),
        ensemble.sample_codes(3, 1, 6, 200, 3, 6, method))
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(200, *MIXED)
    _assert_same_irregular(
        irregular.sample_irregular_codes(3, 1, 6, spec, method, device=cuda),
        irregular.sample_irregular_codes(3, 1, 6, spec, method))


@pytest.mark.parametrize("n", [1, 2, 10, 2048, 10_000])
@pytest.mark.parametrize("shared", [True, False])
def test_sampler_kernel_rounds_equal_cpu(cuda, n, shared, monkeypatch):
    # the kernels' rounds per code equal the CPU model's for the same draws
    if not shared:
        monkeypatch.setattr(ensemble, "SHARED_PERM_MAX_SOCKETS", 0)
    dv, dc = (3, 6) if n % 2 == 0 else (2, 1)
    num = 40
    rounds = torch.full((num,), -1, dtype=torch.int32, device=cuda)
    ensemble.sample_codes(11, 4, num, n, dv, dc, "raw", device=cuda,
                          rounds=rounds)
    want = ensemble.first_shuffle_rounds(11, 4, num, n * dv)
    assert torch.equal(rounds.cpu().long(), want)
    spec = irregular.IrregularEnsembleSpec.regular(n, dv, dc)
    rounds.fill_(-1)
    irregular.sample_irregular_codes(11, 4, num, spec, "repair",
                                     device=cuda, rounds=rounds)
    assert torch.equal(rounds.cpu().long(), want)


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


# ---------------------------------------------------------------------------
# Kernel D: the whole all-zero erasure-BP decode, one block per code
# ---------------------------------------------------------------------------

def _erasure_batch(family, num, n=600):
    """A batch of ``num`` codes (the decode's view of them) on the CPU."""
    if family == "irregular":
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(
            n, [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0])
        return erasure_bp._phantom_view(irregular.sample_irregular_codes(
            4, 0, num, spec, "repair"))
    dv, dc = (3, 6) if family == "regular" else (5, 10)    # dc > 8: the
    return ensemble.sample_codes(4, 0, num, n, dv, dc, "raw")  # runtime loop


@pytest.mark.parametrize("family", ["regular", "irregular", "dc10"])
@pytest.mark.parametrize("wpc, num", [(1, 40), (3, 7), (2, 1)])
@pytest.mark.parametrize("max_iters", [0, 1, 50])
def test_erasure_decode_kernel_equals_plain(cuda, family, wpc, num,
                                            max_iters):
    codes = _erasure_batch(family, num)
    rows = codes.var_to_chk.shape[1]
    # one erasure probability per code: 0, 1 and between
    erased = torch.cat([bitops.bernoulli_packed(
        float(p), (rows, wpc), seed=3, offset=g)
        for g, p in enumerate(np.resize([0.0, 1.0, 0.3, 0.42, 0.5], num))],
        dim=1)
    if family == "irregular":
        erased[-1] = 0                          # the phantom is never erased
    out = []
    for device in (cuda, "cpu"):
        before = erasure_bp.erasure_decode.launches
        got = erasure_bp.erasure_decode(
            erased.to(device), codes.chk_to_var.to(device),
            codes.var_to_chk.to(device), max_iters)
        assert erasure_bp.erasure_decode.launches - before == \
            (1 if device == cuda else 0)
        out.append([t.cpu() for t in got])
    for got, want in zip(*out):
        assert torch.equal(got, want)
    rounds = out[1][2]
    assert rounds[0] == 0 and int(rounds.max()) <= max_iters
    if num > 1 and max_iters:
        assert rounds[1] == 1                   # every bit erased: stalls


def test_erasure_decode_kernel_refuses_a_code_beyond_shared_memory(cuda):
    codes = ensemble.sample_codes(0, 0, 2, 600, 3, 6, "repair").to(cuda)
    wide = torch.zeros((600, 2 * 100), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        erasure_bp.erasure_decode(wide, codes.chk_to_var, codes.var_to_chk,
                                  5)


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("expurgation", [None, 1])
def test_ensemble_bec_runs_take_kernel_d(cuda, family, expurgation):
    # the ensemble BEC chunks decode by kernel D alone (twice a chunk when
    # expurgated), and the run equals the CPU's in every counter
    lam = dict(lam=[0, 1 / 3, 0, 2 / 3], rho=[0, 0, 0, 0, 0, 1.0]) \
        if family == "irregular" else {}
    cfg = SimulationConfig(channel_param=0.42, n=504, code_mode="ensemble",
                           iterations=40, batch=640, num_tests=1920, seed=4,
                           codes_per_chunk=10, max_block_errors=10**9,
                           expurgation=expurgation, **lam)
    wrappers = (erasure_bp.erasure_decode, erasure_bp.check_exactly_one,
                erasure_bp.variable_or_update)
    before = [w.launches for w in wrappers]
    gpu = mc.run_simulation(cfg, device="cuda")
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert launched == [3 * (1 if expurgation is None else 2), 0, 0]
    cpu = mc.run_simulation(cfg, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "excluded_trials", "bit_errors_sq", "code_bit_errors_sq",
                  "trials_per_code", "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


def _one_word_limit():
    """The largest (3,6) n whose one word fits kernel D's block."""
    return max(n for n in range(2, 40_000, 2)
               if erasure_bp._erasure_decode_smem_bytes(n, n // 2, 6, 1)
               <= erasure_bp.SMEM_OPTIN_BYTES)


def _fixed_case(case, cuda):
    """(the decode's code, erased planes) on the card for a one-code case:
    the headline shape, the one-word limit and one word above it, an
    irregular code, and a plane 8 bytes past a 16-byte boundary."""
    if case == "irregular":
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(
            10_000, [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0])
        c = irregular.sample_irregular_codes(5, 0, 1, spec,
                                             "repair").select(0).to(cuda)
        return c, bitops.bernoulli_packed(0.42, (10_000, 96), seed=6,
                                          device=cuda)
    n, words = {"headline": (10_000, 768), "limit": (_one_word_limit(), 40),
                "above": (_one_word_limit() + 2, 8),
                "misaligned": (600, 33)}[case]
    c = _code(n, seed=n).to(cuda)
    erased = bitops.bernoulli_packed(0.42, (n, words), seed=7, device=cuda)
    if case == "misaligned":
        base = torch.zeros(n * words + 2, dtype=torch.int32, device=cuda)
        erased = base[2:].view(n, words).copy_(erased)
    return c, erased


@pytest.mark.parametrize("case", ["headline", "limit", "irregular",
                                  "misaligned", "above"])
@pytest.mark.parametrize("max_iters", [0, 1, 50])
def test_fixed_decode_takes_kernel_d_by_rule(cuda, case, max_iters):
    # one code: kernel D one block a word where the word fits a block,
    # else the K2/K3 host loop; either way equal to the plain path and to
    # the K2/K3 kernels' host loop
    c, erased = _fixed_case(case, cuda)
    irr = case == "irregular"
    view = erasure_bp._phantom_view(c) if irr else c
    planes = erasure_bp._pad_phantom_row(erased) if irr else erased
    takes = case != "above"
    assert erasure_bp.takes_erasure_decode_kernel(view, planes.shape[1]) \
        is takes
    wrappers = (erasure_bp.erasure_decode, erasure_bp.check_exactly_one,
                erasure_bp.variable_or_update)
    before = [w.launches for w in wrappers]
    got = erasure_bp.bp_decode_packed_allzero(view, planes, max_iters)
    torch.cuda.synchronize()
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    if takes:
        assert launched == [1, 0, 0]
    else:
        assert launched[0] == 0 and launched[1] == launched[2] == \
            got.iterations
    rounds = erasure_bp._decode_allzero(
        view, planes, max_iters, erasure_bp.check_exactly_one,
        erasure_bp.variable_or_update, bitops.per_trial_counts)
    plain = erasure_bp.bp_decode_packed_allzero_plain(view, planes,
                                                      max_iters)
    for want in (rounds, plain):
        assert torch.equal(got.known, want.known)
        assert torch.equal(got.error_totals, want.error_totals)
        assert got.iterations == want.iterations


def test_fixed_run_takes_kernel_d(cuda):
    # the mode-3 BEC run launches kernel D once a chunk and K2/K3 never,
    # and equals the CPU's run in every counter
    cfg = SimulationConfig(channel_param=0.42, n=504, code_mode="fixed",
                           iterations=40, batch=640, num_tests=1920, seed=4,
                           max_block_errors=10**9)
    code = _code(504, seed=2)
    wrappers = (erasure_bp.erasure_decode, erasure_bp.check_exactly_one,
                erasure_bp.variable_or_update)
    before = [w.launches for w in wrappers]
    gpu = mc.run_simulation(cfg, code, device="cuda")
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3, 0, 0]
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "bit_errors_sq", "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


@pytest.mark.parametrize("family, dv", [("regular", 3), ("dv5", 5),
                                        ("irregular", 4)])
@pytest.mark.parametrize("words, align, vec", [(768, 16, 4), (48, 16, 4),
                                               (48, 8, 1), (33, 16, 1),
                                               (1, 16, 1)])
def test_variable_or_update_kernel_widths(cuda, family, dv, words, align,
                                          vec):
    # K3 at N = 4 (16 bytes) and N = 1, at the exact degree 3 and in the
    # socket loop (dv 5, the irregular phantom view's dv_max 4), on a state
    # two rounds into a decode, against its plain version
    n = 1200
    if family == "irregular":
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(
            n, [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0])
        c = erasure_bp._phantom_view(irregular.sample_irregular_codes(
            3, 0, 1, spec, "repair").select(0))
    elif family == "dv5":
        c = ensemble.sample_codes(3, 0, 1, n, 5, 10, "repair").select(0)
    else:
        c = _code(n, seed=5)
    assert c.var_to_chk.shape[-1] == dv
    rows = c.var_to_chk.shape[-2]
    erased = bitops.bernoulli_packed(0.42, (rows, words), seed=words)
    known = erasure_bp.bp_decode_packed_allzero_plain(c, erased, 2).known
    ex = erasure_bp.check_exactly_one(c.chk_to_var, known)
    want_known, want_errors = known.clone(), torch.zeros(3, dtype=torch.int32)
    erasure_bp.variable_or_update(c.var_to_chk, ex, want_known, want_errors,
                                  1)
    off = (16 - align) // 4
    base = torch.zeros(rows * words + off, dtype=torch.int32, device=cuda)
    got_known = base[off:].view(rows, words).copy_(known)
    got_errors = torch.zeros(3, dtype=torch.int32, device=cuda)
    erasure_bp.variable_or_update(c.var_to_chk.to(cuda), ex.to(cuda),
                                  got_known, got_errors, 1)
    assert erasure_bp.variable_or_update.vec == vec
    assert torch.equal(got_known.cpu(), want_known)
    assert torch.equal(got_errors.cpu(), want_errors)


# ---------------------------------------------------------------------------
# Irregular codes and Gallager-A/B
# ---------------------------------------------------------------------------

LAM, RHO = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]
MIXED = ([0, 0, 0.5, 0.5], [0, 0, 0, 0, 0.5, 0.5])


def _assert_same_irregular(got, want):
    for name in ("chk_to_var", "var_to_chk", "var_to_sock"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name


@pytest.mark.parametrize("method, n, num, dist", [
    ("raw", 40, 3, MIXED), ("raw", 1000, 33, (LAM, RHO)),
    ("repair", 110, 5, MIXED), ("repair", 2000, 40, (LAM, RHO)),
    ("reject", 60, 4, (LAM, RHO)), ("reject", 110, 6, MIXED)])
def test_irregular_sampler_kernel_equals_plain(cuda, method, n, num, dist):
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, *dist)
    got = irregular.sample_irregular_codes(9, 5, num, spec, method,
                                           device=cuda)
    assert got.chk_to_var.is_cuda and got.batched
    _assert_same_irregular(got, irregular.sample_irregular_codes(
        9, 5, num, spec, method))
    if method != "raw":
        for i in range(num):
            assert irregular.validate_irregular_code(got.select(i), spec) \
                == (True, "ok")


@pytest.mark.parametrize("method", ["raw", "repair", "reject"])
def test_irregular_sampler_kernel_regular_spec_and_global_path(
        cuda, method, monkeypatch):
    spec = irregular.IrregularEnsembleSpec.regular(120, 3, 6, device=cuda)
    got = irregular.sample_irregular_codes(4, 2, 5, spec, method, device=cuda)
    want = ensemble.sample_codes(4, 2, 5, 120, 3, 6, method, device=cuda)
    assert torch.equal(got.chk_to_var[:, :-1], want.chk_to_var)
    assert torch.equal(got.var_to_sock[:, :-1].sort(-1).values,
                       want.var_to_edge)
    monkeypatch.setattr(ensemble, "SHARED_PERM_MAX_SOCKETS", 0)
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(200, *MIXED)
    _assert_same_irregular(
        irregular.sample_irregular_codes(3, 1, 6, spec, method, device=cuda),
        irregular.sample_irregular_codes(3, 1, 6, spec, method))


@pytest.mark.parametrize("wpc", [1, 24])
@pytest.mark.parametrize("batched", [False, True])
def test_irregular_decode_on_gpu_equals_cpu(cuda, wpc, batched):
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(600, LAM, RHO)
    codes = irregular.sample_irregular_codes(1, 0, 7, spec, "repair")
    code = codes if batched else codes.select(0)
    words = wpc * code.num_codes
    erased = bitops.bernoulli_packed(0.45, (600, words), seed=wpc)
    cpu = erasure_bp.bp_decode_packed_allzero_irregular(code, erased, 50)
    gpu = erasure_bp.bp_decode_packed_allzero_irregular(
        code.to(cuda), erased.to(cuda), 50)
    assert torch.equal(gpu.known.cpu(), cpu.known)
    assert torch.equal(gpu.error_totals.cpu(), cpu.error_totals)
    assert gpu.iterations == cpu.iterations


# (rows, dc, words): 16-, 8- and 4-byte vectors (W = 768, 66, 33), the
# exact degree 6 and the generic loop (1, 5, 8)
@pytest.mark.parametrize("rows, dc, words", [
    (1, 1, 1), (13, 6, 33), (301, 5, 96), (40, 6, 768), (40, 6, 66),
    (17, 8, 64), (50, 6, 24)])
@pytest.mark.parametrize("align", [16, 8, 4])
def test_gallager_check_kernel_equals_plain(cuda, rows, dc, words, align):
    rng = np.random.default_rng(rows)
    msg = torch.from_numpy(rng.integers(-2**31, 2**31, size=(rows * dc, words),
                                        dtype=np.int64).astype(np.int32))
    got = gallager.gallager_check(_misaligned(msg.to(cuda), align), dc)
    assert torch.equal(got.cpu(), gallager.gallager_check(msg, dc))


def _variable_case(family, wpc, num, seed=0):
    """Tables, random messages (padding rows 0), channel and the pass's
    other arguments for one variable-pass comparison: (3,6), (4,8), (5,10)
    and (9,18) codes (the exact degrees 3 and 4, the generic path at one
    word a thread) and the dv 3/4 irregular pair."""
    rng = np.random.default_rng(seed)
    n = 600
    if family != "irregular":
        dv = {"regular": 3, "dv4": 4, "dv5": 5, "dv9": 9}[family]
        codes = ensemble.sample_codes(seed, 0, num, n, dv, 2 * dv, "repair")
        table, dc, rows = codes.var_to_edge, 2 * dv, codes.m
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, *MIXED)
        codes = irregular.sample_irregular_codes(seed, 0, num, spec)
        table, dc, rows = codes.var_to_sock, codes.dc_max, codes.m + 1
    if num == 1:
        table = table[0]
    words = wpc * num
    msg = torch.from_numpy(rng.integers(-2**31, 2**31, size=(rows * dc, words),
                                        dtype=np.int64).astype(np.int32))
    if family == "irregular":
        pad = ~(codes.chk_to_var.flatten(1) < n)                 # [C, rows*dc]
        msg.view(rows * dc, num, wpc)[pad.t()] = 0
    channel = bitops.bernoulli_packed(0.2, (n, words), seed=seed)
    active = torch.from_numpy((rng.random(num) < 0.7).astype(np.int32))
    active[0] = 1
    decided = bitops.bernoulli_packed(0.5, (n, words), seed=seed + 1)
    tx = bitops.bernoulli_packed(0.5, (n, words), seed=seed + 2)
    pad_pos = (codes.m) * dc
    return dict(msg=msg, channel=channel, table=table, active=active,
                decided=decided, tx=tx, dc=dc, pad_pos=pad_pos,
                clamp=family == "irregular")


def _variable_pass_both(cuda, case, threshold, with_tx, align=16):
    """The variable pass on the card (its planes ``align`` bytes past a
    16-byte boundary) and on the CPU: (msg, decided, counts) of each."""
    dv = case["table"].shape[-1]
    num = case["active"].shape[0]
    t = (dv if case["clamp"] else dv - 1) if threshold is None else threshold
    out = []
    for device in (cuda, "cpu"):
        def put(x):
            return _misaligned(x.to(device), align) if device == cuda \
                else x.clone()
        msg, decided = put(case["msg"]), put(case["decided"])
        counts = torch.zeros((num, 2), dtype=torch.int32, device=device)
        parity = gallager.gallager_check(msg, case["dc"])
        gallager.gallager_variable(
            msg, put(parity), put(case["channel"]), case["table"].to(device),
            case["active"].to(device), decided, counts, dc=case["dc"],
            pad_pos=case["pad_pos"], threshold=t, clamp=case["clamp"],
            tx=put(case["tx"]) if with_tx else None)
        out.append((msg.cpu(), decided.cpu(), counts.cpu()))
    return out


# (wpc, num): 4-byte vectors on one code (33) and on 40 codes of one word,
# 8-byte ones (6, 2), 16-byte ones (24; 768 words on one code, the fixed
# path's width)
@pytest.mark.parametrize("family", ["regular", "dv4", "dv5", "dv9",
                                    "irregular"])
@pytest.mark.parametrize("wpc, num", [(33, 1), (1, 40), (24, 5), (768, 1),
                                      (6, 7), (2, 20)])
@pytest.mark.parametrize("threshold", [None, 1])
@pytest.mark.parametrize("with_tx", [False, True])
def test_gallager_variable_kernel_equals_plain(cuda, family, wpc, num,
                                               threshold, with_tx):
    case = _variable_case(family, wpc, num)
    gpu, cpu = _variable_pass_both(cuda, case, threshold, with_tx)
    for got, want in zip(gpu, cpu):
        assert torch.equal(got, want)
    assert int(cpu[2][:, 1].sum()) > 0
    stopped = case["active"] == 0               # frozen: nothing written
    if stopped.any():
        assert int(cpu[2][stopped].abs().sum()) == 0


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("wpc, num", [(24, 5), (768, 1)])
@pytest.mark.parametrize("align", [8, 4])
def test_gallager_variable_kernel_on_misaligned_planes(cuda, family, wpc,
                                                       num, align):
    # planes 8 or 4 bytes past a 16-byte boundary: the rule narrows the
    # vectors to 8 or 4 bytes
    case = _variable_case(family, wpc, num, seed=3)
    gpu, cpu = _variable_pass_both(cuda, case, None, False, align)
    for got, want in zip(gpu, cpu):
        assert torch.equal(got, want)


@pytest.mark.parametrize("record", ["total", "per_trial"])
@pytest.mark.parametrize("wpc, num", [(9, 1), (1, 24), (24, 3)])
def test_gallager_decodes_on_gpu_equal_cpu(cuda, record, wpc, num):
    n = 600
    regular = ensemble.sample_codes(2, 0, num, n, 3, 6, "repair")
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, *MIXED)
    irreg = irregular.sample_irregular_codes(2, 0, num, spec)
    rx = bitops.bernoulli_packed(0.04, (n, wpc * num), seed=num)
    for code, decode, kw in (
            (regular, gallager.gallager_decode_packed, dict(threshold=None)),
            (regular, gallager.gallager_decode_packed, dict(threshold=1)),
            (regular, gallager.gallager_decode_packed,
             dict(schedule=[1] * 5 + [2] * 45)),
            (irreg, gallager.gallager_decode_packed_irregular,
             dict(threshold=None)),
            (irreg, gallager.gallager_decode_packed_irregular,
             dict(threshold=1))):
        one = code if num > 1 else code.select(0)
        cpu = decode(one, rx, 50, record=record, **kw)
        gpu = decode(one.to(cuda), rx.to(cuda), 50, record=record, **kw)
        assert torch.equal(gpu.decided.cpu(), cpu.decided)
        assert torch.equal(gpu.error_totals.cpu(), cpu.error_totals)
        assert gpu.iterations == cpu.iterations
        if record == "per_trial":
            assert torch.equal(gpu.traj.cpu(), cpu.traj)


# kernel G's families: (3,6), (5,10) (the 32-socket instantiation), the
# dv 3/4 pair and a dv 2/3/6 irregular pair (the clamp at 32 sockets)
WIDE = ([0, 0.3, 0.3, 0, 0, 0.4], [0, 0, 0, 0, 0, 0.5, 0.5])


def _decode_case(family, wpc, num, seed=0, n=600):
    """Tables and planes of one kernel G comparison: per-code crossover
    probabilities from 0 (no round) to 0.12 (no stop)."""
    rng = np.random.default_rng(seed)
    if family in ("regular", "dv5"):
        dv, dc = (3, 6) if family == "regular" else (5, 10)
        codes = ensemble.sample_codes(seed, 0, num, n, dv, dc, "repair")
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(
            n, *(MIXED if family == "irregular" else WIDE))
        codes = irregular.sample_irregular_codes(seed, 0, num, spec)
    graph = gallager._graph(codes if num > 1 else codes.select(0))
    ps = np.linspace(0.0, 0.12, num) if num > 1 else [0.04]
    flips = torch.cat([bitops.bernoulli_packed(
        float(p), (n, wpc), seed=seed, offset=g) for g, p in enumerate(ps)],
        dim=1)
    tx = bitops.bernoulli_packed(0.5, (n, wpc * num), seed=seed + 1)
    return graph, flips, tx, rng


@pytest.mark.parametrize("family", ["regular", "dv5", "irregular", "wide"])
@pytest.mark.parametrize("wpc, num", [(1, 40), (3, 7), (9, 1)])
@pytest.mark.parametrize("max_iters", [0, 1, 50])
@pytest.mark.parametrize("with_tx", [False, True])
def test_decode_kernel_equals_plain(cuda, family, wpc, num, max_iters,
                                    with_tx):
    graph, flips, tx, rng = _decode_case(family, wpc, num)
    dv = graph.var_to_sock.shape[-1]
    # thresholds from "always flips" (<= 0) to "never flips" (> dv) and
    # change_ahead flags at random: every branch of the stop rule
    thresholds = torch.from_numpy(rng.integers(
        -1, dv + 2, size=max_iters).astype(np.int32))
    ahead = torch.from_numpy((rng.random(max_iters) < 0.3).astype(np.int32))
    received = flips ^ tx if with_tx else flips
    out = []
    for device in (cuda, "cpu"):
        before = gallager.gallager_decode.launches
        got = gallager.gallager_decode(
            received.to(device), graph.chk_to_var.to(device),
            graph.var_to_sock.to(device), thresholds.to(device),
            ahead.to(device), dc=graph.dc, pad_pos=graph.pad_pos,
            clamp=graph.irregular, tx=tx.to(device) if with_tx else None)
        assert gallager.gallager_decode.launches - before == \
            (1 if device == cuda else 0)
        out.append([t.cpu() for t in got])
    for got, want in zip(*out):
        assert torch.equal(got, want)
    rounds = out[1][2]
    assert int(rounds.max()) <= max_iters
    if max_iters == 0 or num == 1:
        return
    assert rounds[0] == 0                       # no channel errors


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("record", ["total", "per_trial"])
def test_decode_kernel_launches_by_rule(cuda, family, record):
    # the ensemble shape at one word a code takes kernel G alone; the
    # per-trial record keeps the round kernels
    _, flips, _, _ = _decode_case(family, 1, 24)
    code = ensemble.sample_codes(0, 0, 24, 600, 3, 6, "repair") \
        if family == "regular" else irregular.sample_irregular_codes(
            0, 0, 24, irregular.IrregularEnsembleSpec.from_lam_rho(600,
                                                                   *MIXED))
    decode = gallager.gallager_decode_packed if family == "regular" else \
        gallager.gallager_decode_packed_irregular
    wrappers = (gallager.gallager_decode, gallager.gallager_check,
                gallager.gallager_variable)
    before = [w.launches for w in wrappers]
    gpu = decode(code.to(cuda), flips.to(cuda), 50, record=record)
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    if record == "total":
        assert launched == [1, 0, 0]
    else:
        assert launched[0] == 0 and launched[1] == launched[2] > 0
    cpu = decode(code, flips, 50, record=record)
    assert torch.equal(gpu.decided.cpu(), cpu.decided)
    assert torch.equal(gpu.error_totals.cpu(), cpu.error_totals)
    assert gpu.iterations == cpu.iterations


def test_decode_kernel_refuses_a_code_beyond_shared_memory(cuda):
    graph, flips, _, _ = _decode_case("regular", 1, 1)
    wide = flips.repeat(1, 64).to(cuda)         # 2100 rows x 64 words
    t = torch.full((5,), 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        gallager.gallager_decode(wide, graph.chk_to_var.to(cuda),
                                 graph.var_to_sock.to(cuda), t, t,
                                 dc=graph.dc, pad_pos=graph.pad_pos,
                                 clamp=False)


@pytest.mark.parametrize("fields", [
    dict(lam=LAM, rho=RHO, code_mode="ensemble", expurgation=None),
    dict(lam=LAM, rho=RHO, code_mode="fixed", expurgation=2),
    dict(channel="BSC", decoder="gallager", channel_param=0.04,
         code_mode="ensemble", expurgation=2),
    dict(channel="BSC", decoder="gallager", channel_param=0.04,
         code_mode="fixed", gallager_threshold=1, expurgation=None),
    dict(channel="BSC", decoder="gallager", channel_param=0.05,
         lam=MIXED[0], rho=RHO, code_mode="ensemble", expurgation=None),
    dict(channel="BSC", decoder="gallager", channel_param=0.05,
         lam=MIXED[0], rho=RHO, code_mode="fixed", expurgation=1)])
def test_new_paths_run_simulation_gpu_equals_cpu(cuda, fields):
    base = dict(channel_param=0.42, n=504, iterations=40, batch=640,
                num_tests=1920, seed=4, codes_per_chunk=10,
                max_block_errors=10**9)
    cfg = SimulationConfig(**{**base, **fields})
    code = ensemble.code_for_config(cfg) if cfg.code_mode == "fixed" \
        else None
    gpu = mc.run_simulation(cfg, code, device="cuda")
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "excluded_trials", "bit_errors_sq", "code_bit_errors_sq",
                  "trials_per_code", "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


# ---------------------------------------------------------------------------
# Soft BP: kernels A, B and C
# ---------------------------------------------------------------------------

SOFT = [("minsum", torch.float32), ("minsum", torch.bfloat16),
        ("minsum", torch.int8), ("sumproduct", torch.float32),
        ("sumproduct", torch.bfloat16)]
# sum-product: CUDA's tanhf/atanhf against the plain version's; one ulp of
# a tanh product at the clip 0.999999 moves a message by up to 0.06
SP_ATOL = {torch.float32: 0.1, torch.bfloat16: 0.5}


def _ulps(a, b):
    """float32 ulp distance of two same-signed planes, elementwise."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return (ia - ib).abs()


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (97, 33), (600, 640)])
def test_awgn_llr_kernel_equals_plain(cuda, shape):
    got = channels.awgn_llr(0.8, shape, seed=2**40 + 3, offset=2**32 + 7,
                            device=cuda).cpu()
    want = channels.awgn_llr(0.8, shape, seed=2**40 + 3, offset=2**32 + 7)
    assert got.shape == shape and got.dtype == torch.float32
    # the same Philox words (any other word moves an LLR by far more than
    # an ulp); float64 log/sincos may round a z apart by one float32 ulp
    ulps = _ulps(got, want)
    assert int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) <= max(1, got.numel() // 10**5)


def _soft_case(family, num, dtype, seed=0):
    """Tables and random planes for one pass comparison: n = 300, 32
    trials a code (the padded rows of an irregular code's messages 0)."""
    rng = np.random.default_rng(seed)
    n, cpc = 300, 32
    if family == "regular":
        codes = ensemble.sample_codes(seed, 0, num, n, 3, 6, "repair")
        var_table, dc, rows = codes.var_to_edge, 6, codes.m
        pad_var, n_rows = -1, n
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, *MIXED)
        codes = irregular.sample_irregular_codes(seed, 0, num, spec)
        var_table, dc, rows = codes.var_to_sock, codes.dc_max, codes.m + 1
        pad_var, n_rows = n, n + 1
    chk = codes.chk_to_var
    if num == 1:
        var_table, chk = var_table[0], chk[0]
    cols = cpc * num
    if dtype == torch.int8:
        msg = torch.from_numpy(rng.integers(-127, 128, (rows * dc, cols))
                               .astype(np.int8))
        llr0 = torch.from_numpy(rng.integers(-127, 128, (n_rows, cols))
                                .astype(np.int8))
        pm = torch.from_numpy(rng.integers(-127, 128, (n_rows, cols))
                              .astype(np.int8))
    else:
        msg = torch.from_numpy(rng.normal(0, 6, (rows * dc, cols))
                               .astype(np.float32)).to(dtype)
        llr0 = torch.from_numpy(rng.normal(2, 4, (n_rows, cols))
                                .astype(np.float32))
        pm = torch.from_numpy(rng.normal(0, 8, (n_rows, cols))
                              .astype(np.float32)).to(dtype)
    if family == "irregular":
        pad = ~(codes.chk_to_var.flatten(1) < n)                 # [C, rows*dc]
        msg.view(rows * dc, num, cpc)[pad.t()] = 0
        llr0[n] = 127 if dtype == torch.int8 else 1e4
    active = torch.from_numpy((rng.random(num) < 0.7).astype(np.int32))
    active[0] = 1
    return dict(msg=msg, llr0=llr0, pm=pm, var_table=var_table, chk=chk,
                active=active, pad_pos=codes.m * dc, pad_var=pad_var, n=n)


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("num", [1, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("final", [False, True])
def test_soft_posterior_kernel_equals_plain(cuda, family, num, dtype, final):
    case = _soft_case(family, num, dtype)
    out = []
    for device in (cuda, "cpu"):
        pm = case["pm"].clone().to(device)
        cols = pm.shape[1]
        counts = torch.zeros(cols, dtype=torch.int32, device=device)
        extra = {}
        if final:
            extra = dict(post=torch.zeros((case["n"], cols), device=device),
                         hard=torch.zeros((case["n"], cols), dtype=torch.bool,
                                          device=device), int8_scale=4.0)
        soft_bp.soft_posterior(case["llr0"].to(device),
                               case["msg"].to(device),
                               case["var_table"].to(device),
                               case["active"].to(device), pm, counts,
                               pad_pos=case["pad_pos"], **extra)
        out.append([pm.cpu(), counts.cpu()] + [t.cpu() for t in extra.values()
                                              if isinstance(t, torch.Tensor)])
    for got, want in zip(*out):
        assert torch.equal(got, want)
    assert int(out[1][1].sum()) > 0


def _misaligned(t, align):
    """A contiguous copy of ``t`` whose data pointer is ``align`` bytes
    past a 16-byte boundary (16: aligned), as a view into a larger
    buffer."""
    if align == 16:
        return t.clone()
    skip = align // t.element_size()
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    while buf[skip:].data_ptr() % 16 != align % 16:
        skip += 1
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _posterior_kernel_case(dtype, dv, num, cols, seed=0, planes="draws"):
    """Random inputs of kernel B alone: a table int32[C, n_rows, dv] over
    the socket rows of a message plane whose last 7 rows are an irregular
    code's padding (a tenth of the sockets there, their messages 0), LLR,
    message and pm planes, packed codewords, and an active flag a code (a
    third of the codes stopped, code 0 active).  ``planes`` for int8:
    "draws" (the whole int8 range), "edges" (values from INT8_EDGE_VALUES,
    sums that saturate both ways), "saturated" (llr0 and every message
    +127 or -127 by column)."""
    rng = np.random.default_rng(seed)
    n_rows, rows = 61, 61 * dv + 7
    pad_pos = rows - 7
    table = rng.integers(0, pad_pos, size=(num, n_rows, dv))
    pad = rng.random(table.shape) < 0.1
    table[pad] = rng.integers(pad_pos, rows, size=int(pad.sum()))
    if dtype != torch.int8:
        llr0 = torch.from_numpy(rng.normal(1, 5, (n_rows, cols))
                                .astype(np.float32))
        msg = torch.from_numpy(rng.normal(0, 6, (rows, cols))
                               .astype(np.float32)).to(dtype)
    else:
        if planes == "draws":
            llr0, msg = (rng.integers(-128, 128, shape)
                         for shape in ((n_rows, cols), (rows, cols)))
        elif planes == "edges":
            llr0, msg = (INT8_EDGE_VALUES[rng.integers(0, 6, shape)]
                         for shape in ((n_rows, cols), (rows, cols)))
        else:
            sign = np.where(rng.random(cols) < 0.5, 1, -1)
            llr0, msg = (np.broadcast_to(127 * sign, shape)
                         for shape in ((n_rows, cols), (rows, cols)))
        llr0, msg = (torch.from_numpy(np.ascontiguousarray(x)
                                      .astype(np.int8)) for x in (llr0, msg))
    msg[pad_pos:] = 0
    pm = torch.from_numpy(rng.integers(-100, 100, (n_rows, cols))).to(dtype)
    tx = torch.from_numpy(rng.integers(-2**31, 2**31, (n_rows, cols // 32))
                          .astype(np.int32)) if cols % 32 == 0 else None
    active = torch.from_numpy((rng.random(num) < 0.67).astype(np.int32))
    active[0] = 1
    return dict(llr0=llr0, msg=msg, pm=pm, tx=tx, active=active,
                table=torch.from_numpy(table.astype(np.int32)),
                pad_pos=pad_pos, n_out=n_rows - 1)


def _posterior_kernel_against_plain(cuda, case, align=16):
    """Kernel B against its plain version on one case, three launches: a
    round with per-trial counts, a round with per-code counts, and the
    final launch (post and hard of the first n_out rows, the codewords
    where B is a multiple of 32) with per-code counts.  Stopped codes'
    columns must stay as they were.  Returns the plain launches' counts."""
    num = case["active"].shape[0]
    cols = case["pm"].shape[1]
    launches = [dict(width=cols), dict(width=num),
                dict(width=num, final=True, tx=case["tx"])]
    out = []
    for device in (cuda, "cpu"):
        got = []
        for spec in launches:
            pm = case["pm"].to(device)
            msg = case["msg"].to(device)
            if device != "cpu":
                pm, msg = _misaligned(pm, align), _misaligned(msg, align)
            counts = torch.zeros(spec["width"], dtype=torch.int32,
                                 device=device)
            extra = {}
            if spec.get("final"):
                extra = dict(post=torch.full((case["n_out"], cols), 7.0,
                                             device=device),
                             hard=torch.zeros((case["n_out"], cols),
                                              dtype=torch.bool, device=device),
                             int8_scale=4.0)
                if spec["tx"] is not None:
                    extra["tx"] = spec["tx"].to(device)
            soft_bp.soft_posterior(case["llr0"].to(device), msg,
                                   case["table"].to(device),
                                   case["active"].to(device), pm, counts,
                                   pad_pos=case["pad_pos"], **extra)
            got.append([pm.cpu(), counts.cpu()] + [
                extra[k].cpu() for k in ("post", "hard") if k in extra])
        out.append(got)
    for got, want in zip(*out):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    cpc = cols // num
    for g in np.flatnonzero(case["active"].numpy() == 0):
        stopped = slice(cpc * g, cpc * (g + 1))
        assert torch.equal(out[0][0][0][:, stopped], case["pm"][:, stopped])
        assert torch.equal(out[0][2][2][:, stopped],
                           torch.full((case["n_out"], cpc), 7.0))
    return [w[1] for w in out[1]]


#: (codes, trials a code): one code over 33 warps' runs of 32 bytes (a
#: ragged last tile), one code of 64; eight codes of 32, 8 and 4 trials
#: (several codes a warp); six of 12 (three float32 vectors a code, idle
#: lanes); three of 1,024 (two tiles a code in int8)
POSTERIOR_SHAPES = [(1, 1056), (1, 64), (8, 32), (8, 8), (8, 4), (6, 12),
                    (3, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dv", [2, 3, 4, 5, 6, 7, 8, 12, 32])
@pytest.mark.parametrize("num, cpc, align", [
    (num, cpc, 16) for num, cpc in POSTERIOR_SHAPES] + [
    (8, 32, 8), (8, 32, 4), (1, 1056, 8), (1, 1056, 4)])
def test_soft_posterior_kernel_every_degree_and_width(cuda, dtype, dv, num,
                                                      cpc, align):
    """Every instantiation of kernel B (the exact degrees 2..8 at 16, 8 and
    4 bytes a thread, the generic kMaxDv = 16 / 32 above) against its plain
    version: padded sockets, stopped codes, both count widths, the final
    launch with codewords; 8- and 4-byte-aligned planes force the narrower
    widths."""
    case = _posterior_kernel_case(dtype, dv, num, num * cpc,
                                  seed=100 * dv + cpc + align)
    elem = case["pm"].element_size()
    vec = soft_bp.soft_posterior_vector(elem, cpc, dv, [(align, elem)])
    want = 4 if not 2 <= dv <= 8 else \
        max(b for b in (16, 8, 4) if cpc % (b // elem) == 0 and align % b == 0)
    assert vec * elem == want
    counts = _posterior_kernel_against_plain(cuda, case, align)
    assert int(counts[0].sum()) > 0


@pytest.mark.parametrize("dv", [2, 3, 6, 8, 12, 32])
@pytest.mark.parametrize("num, cpc", [(1, 1056), (8, 4), (3, 1024)])
@pytest.mark.parametrize("planes", ["edges", "saturated"])
def test_soft_posterior_kernel_int8_adversarial(cuda, dv, num, cpc, planes):
    """Kernel B's packed int8 lanes where the int16 sum saturates both
    ways: every addend +-127 (sums up to 33 * 127), and edge values -128,
    -127, -1, 0, 1, 127 in every combination."""
    case = _posterior_kernel_case(torch.int8, dv, num, num * cpc,
                                  seed=dv + cpc, planes=planes)
    _posterior_kernel_against_plain(cuda, case)


@pytest.mark.parametrize("rows, cols", [(0, 64), (5, 0)])
def test_soft_posterior_kernel_of_empty_planes_is_a_no_op(cuda, rows, cols):
    table = torch.zeros((2, rows, 3), dtype=torch.int32, device=cuda)
    llr0 = torch.ones((rows, cols), device=cuda)
    pm = torch.full((rows, cols), 3.0, device=cuda)
    counts = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = soft_bp.soft_posterior.launches
    soft_bp.soft_posterior(llr0, torch.zeros((7, cols), device=cuda), table,
                           torch.ones_like(counts), pm, counts, pad_pos=7)
    assert soft_bp.soft_posterior.launches == before
    assert not counts.any() and bool((pm == 3).all())


@pytest.mark.parametrize("fields", [
    dict(channel="BSC", decoder="minsum", soft_msg_dtype="int8",
         channel_param=0.05),
    dict(channel="BSC", decoder="sumproduct", channel_param=0.05)])
def test_soft_ensemble_runs_gpu_equal_cpu(cuda, fields):
    """Ensemble int8 min-sum and sum-product runs (kernel B with per-code
    counts every round) equal on the card and on the CPU in every
    counter; the BSC's LLRs are exact on both."""
    cfg = SimulationConfig(n=504, iterations=30, batch=640, num_tests=1280,
                           seed=4, codes_per_chunk=20, max_block_errors=10**9,
                           code_mode="ensemble", **fields)
    gpu = mc.run_simulation(cfg, None, device="cuda")
    cpu = mc.run_simulation(cfg, None, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "excluded_trials", "bit_errors_sq", "code_bit_errors_sq",
                  "trials_per_code", "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("num", [1, 6])
@pytest.mark.parametrize("method, dtype", SOFT)
def test_soft_check_kernel_equals_plain(cuda, family, num, method, dtype):
    case = _soft_case(family, num, dtype, seed=1)
    kw = dict(method=method, pad_var=case["pad_var"])
    if method == "minsum" and dtype != torch.int8:
        kw.update(alpha=0.8, beta=0.25)
    out = []
    for device in (cuda, "cpu"):
        msg = case["msg"].clone().to(device)
        unsat = torch.zeros(num, dtype=torch.int32, device=device)
        soft_bp.soft_check(case["pm"].to(device), msg,
                           case["chk"].to(device), case["active"].to(device),
                           unsat, **kw)
        out.append((msg.cpu(), unsat.cpu()))
    (msg_k, unsat_k), (msg_p, unsat_p) = out
    assert torch.equal(unsat_k, unsat_p) and int(unsat_p.sum()) > 0
    if method == "sumproduct":
        assert torch.allclose(msg_k.float(), msg_p.float(),
                              atol=SP_ATOL[dtype], rtol=0)
    else:
        assert torch.equal(msg_k, msg_p)
    # a stopped code's messages are untouched
    for g in range(num):
        if not case["active"][g]:
            cols = slice(32 * g, 32 * (g + 1))
            assert torch.equal(msg_k[:, cols], case["msg"][:, cols])


INT8_EDGE_VALUES = np.array([-128, -127, -1, 0, 1, 127], np.int8)


def _check_kernel_case(dtype, dc, cpc, num, n_rows=61, rows=40, seed=0,
                       planes="draws"):
    """Random inputs of kernel C alone: a table int32[C, rows, dc] over
    n_rows variables (a tenth of the sockets on the phantom row n_rows -
    1), pm [n_rows, B] and msg [rows * dc, B] planes, and an active flag a
    code (a third of the codes stopped, code 0 active).  ``planes`` for
    int8: "draws" (the whole range), "edges" (values from INT8_EDGE_VALUES:
    r = p - m hits +-255, +-254, +-128, +-127 and 0, ties everywhere),
    "zeros" or "saturated" (|r| = 254 on every socket)."""
    rng = np.random.default_rng(seed)
    cols = cpc * num
    pad_var = n_rows - 1
    table = rng.integers(0, n_rows - 1, size=(num, rows, dc))
    table[rng.random(table.shape) < 0.1] = pad_var
    shapes = ((n_rows, cols), (rows * dc, cols))
    if dtype != torch.int8:
        pm, msg = (torch.from_numpy(rng.normal(0, sd, shape).astype(
            np.float32)).to(dtype) for sd, shape in zip((8, 6), shapes))
    else:
        if planes == "draws":
            pm, msg = (rng.integers(-127, 128, shape) for shape in shapes)
        elif planes == "edges":
            pm, msg = (INT8_EDGE_VALUES[rng.integers(0, 6, shape)]
                       for shape in shapes)
        elif planes == "zeros":
            pm, msg = (np.zeros(shape) for shape in shapes)
        else:
            sign = np.where(rng.random(cols) < 0.5, 1, -1)
            pm, msg = (np.broadcast_to(v * sign, shape)
                       for v, shape in zip((127, -127), shapes))
        pm, msg = (torch.from_numpy(np.ascontiguousarray(x).astype(np.int8))
                   for x in (pm, msg))
    active = torch.from_numpy((rng.random(num) < 0.67).astype(np.int32))
    active[0] = 1
    return dict(pm=pm, msg=msg, table=torch.from_numpy(table.astype(np.int32)),
                active=active, pad_var=pad_var)


def _check_kernel_against_plain(cuda, case, method, **kw):
    """Kernel C against its plain version on one case; returns the plain
    messages and counts.  Stopped codes' messages must stay as they were."""
    out = []
    for device in (cuda, "cpu"):
        msg = case["msg"].clone().to(device)
        unsat = torch.zeros(case["active"].shape[0], dtype=torch.int32,
                            device=device)
        soft_bp.soft_check(case["pm"].to(device), msg,
                           case["table"].to(device),
                           case["active"].to(device), unsat, method=method,
                           pad_var=case["pad_var"], **kw)
        out.append((msg.cpu(), unsat.cpu()))
    (msg_k, unsat_k), (msg_p, unsat_p) = out
    assert torch.equal(unsat_k, unsat_p)
    if method == "sumproduct":
        assert torch.allclose(msg_k.float(), msg_p.float(),
                              atol=SP_ATOL[case["pm"].dtype], rtol=0)
    else:
        assert torch.equal(msg_k, msg_p)
    cpc = case["pm"].shape[1] // case["active"].shape[0]
    for g in np.flatnonzero(case["active"].numpy() == 0):
        cols = slice(cpc * g, cpc * (g + 1))
        assert torch.equal(msg_k[:, cols], case["msg"][:, cols])
    return msg_p, unsat_p


@pytest.mark.parametrize("method, dtype", SOFT)
@pytest.mark.parametrize("dc", [2, 3, 6, 7, 8, 12, 32])
@pytest.mark.parametrize("cpc", [4, 8, 12, 16, 32])
@pytest.mark.parametrize("num", [1, 6])
def test_soft_check_kernel_every_degree_and_width(cuda, method, dtype, dc,
                                                  cpc, num):
    """Every instantiation of kernel C (the exact degrees 2..8 at 16, 8 and
    4 bytes a thread, the generic kMaxDc = 16 / 32 above) against its
    plain version, on B / C = 4, 8, 12, 16 and 32 trials a code, one code
    and six (two of them stopped), padded sockets in every code."""
    case = _check_kernel_case(dtype, dc, cpc, num, seed=dc * 100 + cpc)
    kw = dict(alpha=0.8, beta=0.25) if method == "minsum" and \
        dtype != torch.int8 else {}
    vec, _ = soft_bp.soft_check_geometry(case["pm"].element_size(),
                                         cpc * num, cpc, dc, 61, 50 << 20)
    assert cpc % vec == 0
    _, unsat = _check_kernel_against_plain(cuda, case, method, **kw)
    assert int(unsat.sum()) > 0


@pytest.mark.parametrize("method, dtype", SOFT)
@pytest.mark.parametrize("num", [1, 6])
def test_soft_check_kernel_on_ragged_column_tiles(cuda, method, dtype, num):
    """n_rows so large that the card's L2 share holds few columns of pm:
    the launch runs several column tiles, the last one short (B not a
    multiple of the tile): one code over 3 1/8 tiles of a warp's run of 512
    bytes, or six codes of 128 bytes of trials over tiles of five whole
    codes."""
    elem = torch.empty(0, dtype=dtype).element_size()
    l2 = soft_bp.l2_bytes(torch.cuda.current_device())
    budget = l2 * soft_bp._CHECK_L2_SHARE
    n_rows = int(budget / (512 * 1.5) if num == 1 else budget / (128 * 5.5))
    dc = 6
    cpc = (32 * 16 * 3 + 64) // elem if num == 1 else 128 // elem
    vec, tile = soft_bp.soft_check_geometry(elem, cpc * num, cpc, dc, n_rows,
                                            l2)
    assert tile < cpc * num and (cpc * num) % tile
    case = _check_kernel_case(dtype, dc, cpc, num, n_rows=n_rows, rows=500,
                              seed=num)
    _check_kernel_against_plain(cuda, case, method)


@pytest.mark.parametrize("dc", [2, 6, 8, 12])
@pytest.mark.parametrize("cpc", [4, 8, 16])
@pytest.mark.parametrize("planes", ["edges", "zeros", "saturated"])
def test_soft_check_kernel_equals_plain_int8_adversarial(cuda, dc, cpc,
                                                         planes):
    """Kernel C's packed int8 lanes bit for bit against the plain version
    where saturation and ties decide, at 4, 8 and 16 bytes a thread and on
    the generic degree-12 path, padded sockets and stopped codes
    included."""
    case = _check_kernel_case(torch.int8, dc, cpc, 6, seed=dc + cpc,
                              planes=planes)
    msg, unsat = _check_kernel_against_plain(cuda, case, "minsum")
    on = case["active"].bool().repeat_interleave(cpc)
    if planes == "zeros":
        assert not msg.any() and int(unsat.sum()) == 0
    if planes == "saturated":
        real = (case["table"] != case["pad_var"]).permute(1, 2, 0) \
            .reshape(-1, 6).repeat_interleave(cpc, 1)
        assert bool((msg[real & on].abs() == 127).all())


@pytest.mark.parametrize("rows, cols", [(0, 64), (5, 0)])
def test_soft_check_kernel_of_empty_planes_is_a_no_op(cuda, rows, cols):
    table = torch.zeros((2, rows, 6), dtype=torch.int32, device=cuda)
    pm = torch.ones((7, cols), device=cuda)
    msg = torch.full((rows * 6, cols), 3.0, device=cuda)
    unsat = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = soft_bp.soft_check.launches
    soft_bp.soft_check(pm, msg, table, torch.ones_like(unsat), unsat,
                       method="minsum")
    assert soft_bp.soft_check.launches == before
    assert not unsat.any() and bool((msg == 3).all())


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("num", [1, 5])
@pytest.mark.parametrize("method, dtype", SOFT)
def test_soft_decodes_on_gpu_equal_plain_and_cpu(cuda, family, num, method,
                                                 dtype):
    n = 504
    if family == "regular":
        codes = ensemble.sample_codes(3, 0, num, n, 3, 6, "repair")
        dec, plain = soft_bp.soft_bp_decode, soft_bp.soft_bp_decode_plain
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, *MIXED)
        codes = irregular.sample_irregular_codes(3, 0, num, spec)
        dec, plain = (soft_bp.soft_bp_decode_irregular,
                      soft_bp.soft_bp_decode_irregular_plain)
    one = codes if num > 1 else codes.select(0)
    llr = channels.awgn_llr(0.8, (n, 64 * num), seed=num)
    kw = dict(method=method, msg_dtype=dtype, record="per_trial")
    gpu = dec(one.to(cuda), llr.to(cuda), 30, **kw)
    ref = plain(one.to(cuda), llr.to(cuda), 30, **kw)
    cpu = dec(one, llr, 30, **kw)
    for other in (ref, cpu):
        if method == "sumproduct":
            assert torch.allclose(gpu.posterior.cpu(), other.posterior.cpu(),
                                  atol=SP_ATOL[dtype], rtol=0) or \
                int((gpu.hard.cpu() != other.hard.cpu()).sum()) <= 8
            continue
        assert torch.equal(gpu.posterior.cpu(), other.posterior.cpu())
        assert torch.equal(gpu.traj.cpu(), other.traj.cpu())
        assert torch.equal(gpu.code_iterations.cpu(),
                           other.code_iterations.cpu())


@pytest.mark.parametrize("fields", [
    dict(channel="BSC", decoder="minsum", channel_param=0.05,
         code_mode="ensemble", expurgation=2),
    dict(channel="BSC", decoder="minsum", soft_msg_dtype="int8",
         channel_param=0.05, lam=MIXED[0], rho=RHO, code_mode="fixed"),
    dict(channel="BSC", decoder="minsum", soft_msg_dtype="bfloat16",
         minsum_alpha=0.8, channel_param=0.06, code_mode="fixed")])
def test_soft_bsc_runs_gpu_equal_cpu(cuda, fields):
    cfg = SimulationConfig(n=504, iterations=30, batch=640, num_tests=1280,
                           seed=4, codes_per_chunk=10, max_block_errors=10**9,
                           **fields)
    code = ensemble.code_for_config(cfg) if cfg.code_mode == "fixed" \
        else None
    gpu = mc.run_simulation(cfg, code, device="cuda")
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "excluded_trials", "bit_errors_sq", "code_bit_errors_sq",
                  "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


# ---------------------------------------------------------------------------
# Random-codeword transmit: kernel E, the value-plane round, A/B/Gallager
# with a codeword plane
# ---------------------------------------------------------------------------

def _encoded(code, words, seed, device="cpu"):
    """(planes, info, codewords) of a code or a batch, on ``device``."""
    planes = encode.code_encoder_planes(code.to(device))
    info = bitops.info_planes(planes.k, words, seed=seed, device=device)
    return planes, info, encode.encode_packed(planes, info)


# kernel E's tiles are 32 words of one code by 128-1024 parity rows, and
# it walks information rows in chunks of 32: words per code of 1, 3, 24,
# 33 and 70 (tiles narrower than a warp, several codes a row of tiles, a
# ragged last tile), k_eff of 48, 252 and 300 (not all multiples of 8 or
# 32), and rank 5000 at n = 10^4 (several row tiles)
@pytest.mark.parametrize("n, words, num", [(96, 3, 1), (600, 70, 1),
                                           (504, 24, 24), (504, 72, 3),
                                           (600, 33, 1), (504, 99, 3),
                                           (10_000, 40, 1)])
def test_encode_kernel_equals_plain_and_cpu(cuda, n, words, num):
    codes = ensemble.sample_codes(5, 0, num, n, 3, 6, "repair")
    code = codes if num > 1 else codes.select(0)
    planes, info, got = _encoded(code, words, 6, cuda)
    assert torch.equal(got, encode._encode_packed_plain(planes, info))
    cpu_planes, cpu_info, cpu = _encoded(code, words, 6)
    assert torch.equal(planes.mask.cpu(), cpu_planes.mask)
    assert torch.equal(cpu_info, info.cpu())
    assert torch.equal(got.cpu(), cpu)
    syndrome = torch.zeros((code.m, words), dtype=torch.int32)
    for j in range(code.dc):
        syndrome ^= erasure_bp._code_major_to_plane(
            erasure_bp._gather_rows(cpu, code.chk_to_var, j), num)
    assert not syndrome.any()


@pytest.mark.parametrize("wpc", [1, 3, 24, 33])
def test_encode_kernel_mixed_rank_batch(cuda, wpc):
    # a regular (3,6) code and two irregular codes of one n: their ranks
    # differ, so the padded planes hold sentinel pivots past each code's
    # rank and zero mask bits past its k_eff
    n = 300
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, *MIXED)
    codes = [_code(n, seed=21)] + [
        irregular.sample_irregular_codes(22, 0, 2, spec).select(i)
        for i in range(2)]
    encoders = [encode.make_encoder(c) for c in codes]
    assert len({e.rank for e in encoders}) > 1
    planes = encode.encoder_planes_padded(encoders, n, device=cuda)
    info = bitops.info_planes(planes.k, wpc * len(codes), seed=23,
                              device=cuda)
    before = encode.encode_packed.launches
    got = encode.encode_packed(planes, info)
    assert encode.encode_packed.launches == before + 1
    assert torch.equal(got, encode._encode_packed_plain(planes, info))
    cpu_planes = encode.encoder_planes_padded(encoders, n)
    assert torch.equal(got.cpu(), encode._encode_packed_plain(
        cpu_planes, info.cpu()))
    bits = bitops.unpack_bits(got.cpu()).to(torch.int64)      # [n, 32W]
    for i, c in enumerate(codes):
        h = encode._dense_of(c).to(torch.int64)
        cols = bits[:, 32 * wpc * i:32 * wpc * (i + 1)]
        assert not bool(((h @ cols) % 2).any())


@pytest.mark.parametrize("wpc, num", [(33, 1), (1, 24), (3, 8)])
@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_value_round_kernels_equal_plain(cuda, wpc, num, eps):
    n = 600
    codes = ensemble.sample_codes(7, 0, num, n, 3, 6, "repair")
    code = (codes if num > 1 else codes.select(0)).to(cuda)
    _, _, tx = _encoded(code, wpc * num, 8, cuda)
    known = ~bitops.bernoulli_packed(eps, (n, wpc * num), seed=9,
                                     device=cuda)
    val = tx & known
    got = erasure_bp.check_exactly_one_xor(code.chk_to_var, known, val)
    want = erasure_bp._check_exactly_one_xor_plain(code.chk_to_var, known,
                                                   val)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    state = [(known.clone(), val.clone(),
              torch.zeros(2, dtype=torch.int32, device=cuda))
             for _ in range(2)]
    erasure_bp.variable_or_adopt(code.var_to_chk, *got, *state[0], 1)
    erasure_bp._variable_or_adopt_plain(code.var_to_chk, *want, *state[1],
                                        1)
    for a, b in zip(*state):
        assert torch.equal(a, b)


def _value_round_against_plain(c, known, val, align=16):
    """The value round's two kernels on (known, val) of code (or codes)
    ``c``, the planes ``align`` bytes past a 16-byte boundary, against
    their plain versions on the same planes; returns the launched words a
    thread and column tile, the same for both."""
    known_dev, val_dev = (_misaligned(t, align) for t in (known, val))
    got = erasure_bp.check_exactly_one_xor(c.chk_to_var, known_dev, val_dev)
    launched = (erasure_bp.check_exactly_one_xor.vec,
                erasure_bp.check_exactly_one_xor.tile)
    want = erasure_bp._check_exactly_one_xor_plain(c.chk_to_var, known, val)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    states = [[_misaligned(t, align) for t in (known, val)]
              + [torch.zeros(3, dtype=torch.int32, device=known.device)]
              for _ in range(2)]
    erasure_bp.variable_or_adopt(
        c.var_to_chk, *(_misaligned(t, align) for t in want), *states[0], 1)
    assert (erasure_bp.variable_or_adopt.vec,
            erasure_bp.variable_or_adopt.tile) == launched
    erasure_bp._variable_or_adopt_plain(c.var_to_chk, *want, *states[1], 1)
    for a, b in zip(*states):
        assert torch.equal(a, b)
    return launched


def _value_round_family(family, n, device):
    """(the tables the round reads, the code whose codewords it carries):
    an irregular code's phantom view and the code, else the code twice."""
    if family == "irregular":
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO)
        code = irregular.sample_irregular_codes(3, 0, 1, spec, "repair") \
            .select(0).to(device)
        return erasure_bp._phantom_view(code), code
    if family == "dc10":
        code = ensemble.sample_codes(3, 0, 1, n, 5, 10, "repair") \
            .select(0).to(device)
    else:
        code = _code(n, seed=5, device=device)
    return code, code


@pytest.mark.parametrize("family, dv, dc", [("regular", 3, 6),
                                            ("dc10", 5, 10),
                                            ("irregular", 4, 6)])
@pytest.mark.parametrize("words, align, vec", [(768, 16, 4), (48, 16, 4),
                                               (48, 8, 1), (96, 8, 1),
                                               (33, 16, 1), (1, 16, 1)])
@pytest.mark.parametrize("tx", ["codeword", "random"])
@pytest.mark.parametrize("cache", ["card", "small"])
def test_value_round_kernels_widths(cuda, monkeypatch, family, dv, dc, words,
                                    align, vec, tx, cache):
    # K2's and K3's value forms at N = 4 (16 bytes) and N = 1 (a misaligned
    # plane, an odd W, one word), at the exact degrees (dc 6, dv 3) and in
    # the socket loops (dc 10 and dv 5, the irregular phantom view's dv_max
    # 4), two rounds into a value decode, against their plain versions; on
    # the card's L2 these planes take no column tiles, and with the tile
    # rule given a 1 MB cache, W = 768 and 96 take tiles of 32 words
    n = 1200
    l2 = erasure_bp.l2_bytes(cuda.index or 0) if cache == "card" \
        else 10 ** 6
    monkeypatch.setattr(erasure_bp, "l2_bytes", lambda index: l2)
    c, code = _value_round_family(family, n, cuda)
    assert tuple(c.var_to_chk.shape[-1:] + c.chk_to_var.shape[-1:]) == \
        (dv, dc)
    erased = bitops.bernoulli_packed(0.42, (n, words), seed=words,
                                     device=cuda)
    tx_bits = _encoded(code, words, 2, cuda)[2] if tx == "codeword" else \
        bitops.bernoulli_packed(0.5, (n, words), seed=1, device=cuda)
    if family == "irregular":                # the phantom row: known, 0
        erased, tx_bits = (erasure_bp._pad_phantom_row(t)
                           for t in (erased, tx_bits))
    res = erasure_bp._decode_values(c, erased, tx_bits, 2,
                                    erasure_bp._VALUE_PLAIN, False)[0]
    tile = erasure_bp.value_round_tile(res.known.shape[0], words, l2)
    assert tile == (32 if cache == "small" and words in (768, 96) else words)
    assert _value_round_against_plain(c, res.known, res.val, align) == \
        (vec, tile)


@pytest.mark.parametrize("shape", ["s1_ensemble", "s2_one_code",
                                   "s3_n1e6"])
def test_value_round_kernels_at_the_main_shapes(cuda, shape):
    # S1: the ensemble random BEC chunk's rounds, (3,6), n = 2048, 32 codes
    # of 24 words, eps 0.40, codewords; S2: one code, n = 10^4, W = 768,
    # eps 0.42, codewords; S3: n = 10^6, W = 48, random value planes two
    # rounds in.  Both kernels launch 16 bytes a thread (S2 in column tiles
    # of its planes, which overflow the L2), bit for bit equal to their
    # plain versions round after round
    if shape == "s1_ensemble":
        c = ensemble.sample_codes(1, 0, 32, 2048, 3, 6, "repair",
                                  device=cuda)
        words, eps, rounds = 768, 0.40, 3
        tx_bits = _encoded(c, words, 1, cuda)[2]
    elif shape == "s2_one_code":
        c = ensemble.code_for_config(SimulationConfig(
            n=10_000, dv=3, dc=6, code_mode="fixed")).to(cuda)
        words, eps, rounds = 768, 0.42, 3
        tx_bits = _encoded(c, words, 1, cuda)[2]
    else:
        c = ensemble.code_for_config(SimulationConfig(
            n=1_000_000, dv=3, dc=6, code_mode="fixed")).to(cuda)
        words, eps, rounds = 48, 0.42, 1
        tx_bits = bitops.bernoulli_packed(0.5, (c.n, words), seed=39,
                                          device=cuda)
    erased = bitops.bernoulli_packed(eps, (c.n, words), seed=7, offset=3,
                                     device=cuda)
    known, val = ~erased, tx_bits & ~erased
    if shape == "s3_n1e6":
        res = erasure_bp._decode_values(c, erased, tx_bits, 2,
                                        erasure_bp._VALUE_PLAIN, False)[0]
        known, val = res.known, res.val
    tile = erasure_bp.value_round_tile(c.n, words, erasure_bp.l2_bytes(
        cuda.index or 0))
    assert (tile < words) == (shape == "s2_one_code")
    for _ in range(rounds):
        assert _value_round_against_plain(c, known, val) == (4, tile)
        ex, adopt = erasure_bp._check_exactly_one_xor_plain(c.chk_to_var,
                                                            known, val)
        erasure_bp._variable_or_adopt_plain(
            c.var_to_chk, ex, adopt, known, val,
            torch.zeros(2, dtype=torch.int32, device=cuda), 1)


def test_value_round_entry_points_refuse_shapes(cuda):
    # the shapes ldpc_check_exactly_one_xor and ldpc_variable_or_adopt do
    # not take return cudaErrorInvalidValue, which the launch raises
    c = _code(120, seed=3, device=cuda)
    words = 8
    known = torch.zeros((120, words), dtype=torch.int32, device=cuda)
    val, plane = known.clone(), torch.zeros((60, words), dtype=torch.int32,
                                            device=cuda)
    adopt, errors = plane.clone(), torch.zeros(2, dtype=torch.int32,
                                               device=cuda)
    off = _misaligned(known, 8)

    def check(k=known, n=120, m=60, dc=6, w=words, wpc=words, vec=4,
              tile=words):
        erasure_bp.launch("ldpc_check_exactly_one_xor", cuda, k.data_ptr(),
                          val.data_ptr(), c.chk_to_var.data_ptr(),
                          plane.data_ptr(), adopt.data_ptr(), n, m, dc, w,
                          wpc, vec, tile)

    def variable(k=known, n=120, m=60, dv=3, w=words, wpc=words, vec=4,
                 tile=words):
        erasure_bp.launch("ldpc_variable_or_adopt", cuda, k.data_ptr(),
                          val.data_ptr(), plane.data_ptr(), adopt.data_ptr(),
                          c.var_to_chk.data_ptr(), errors.data_ptr(), n, m,
                          dv, w, wpc, vec, tile)

    for fn in (check, variable):
        fn()                                  # taken: 16 bytes a thread
        fn(vec=1)
        fn(tile=4)                            # two column tiles
        fn(vec=1, tile=2)
        torch.cuda.synchronize()
        for bad in (dict(vec=2), dict(wpc=3, vec=1),   # W % wpc != 0
                    dict(tile=0), dict(tile=6, vec=1),  # W % tile != 0
                    dict(tile=2),                       # tile % vec != 0
                    dict(wpc=6, w=6, vec=4),           # wpc % 4 != 0
                    dict(k=off),                       # misaligned, N = 4
                    dict(w=7, wpc=7, vec=4),           # 4 does not divide W
                    dict(n=2 ** 27, w=8, vec=1),       # a plane >= 2^30
                    dict(wpc=0, vec=1)):
            with pytest.raises(RuntimeError, match="CUDA error"):
                fn(**bad)
    with pytest.raises(RuntimeError, match="CUDA error"):
        check(m=2 ** 26, dc=64, vec=1)        # (W / wpc) * m * dc >= 2^31
    with pytest.raises(RuntimeError, match="CUDA error"):
        variable(n=2 ** 25, dv=64, vec=1)     # (W / wpc) * n * dv >= 2^31


@pytest.mark.parametrize("case", ["s1_ensemble", "one_code_n1",
                                  "irregular"])
def test_traj_decode_on_gpu_equals_plain_and_cpu(cuda, case):
    # bp_decode_packed_traj on the card (the host loop over the value
    # round, K4 a round) against its plain version on the card and the CPU
    if case == "s1_ensemble":
        code = ensemble.sample_codes(1, 0, 32, 2048, 3, 6, "repair")
        words, eps = 768, 0.40
        fn, plain = erasure_bp.bp_decode_packed_traj, \
            erasure_bp.bp_decode_packed_traj_plain
    elif case == "one_code_n1":
        code, words, eps = _code(600, seed=9), 9, 0.42
        fn, plain = erasure_bp.bp_decode_packed_traj, \
            erasure_bp.bp_decode_packed_traj_plain
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(600, LAM, RHO)
        code = irregular.sample_irregular_codes(9, 0, 1, spec).select(0)
        words, eps = 32, 0.42
        fn, plain = erasure_bp.bp_decode_packed_traj_irregular, \
            erasure_bp.bp_decode_packed_traj_irregular_plain
    _, _, tx_bits = _encoded(code, words, 11)
    erased = bitops.bernoulli_packed(eps, (code.n, words), seed=12)
    gpu = fn(code.to(cuda), erased.to(cuda), tx_bits.to(cuda), 50)
    for want in (plain(code.to(cuda), erased.to(cuda), tx_bits.to(cuda), 50),
                 fn(code, erased, tx_bits, 50)):
        assert torch.equal(gpu[1].cpu(), want[1].cpu())
        for field in ("known", "val", "error_totals"):
            assert torch.equal(getattr(gpu[0], field).cpu(),
                               getattr(want[0], field).cpu())
        assert gpu[0].iterations == want[0].iterations


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("wpc, num", [(9, 1), (1, 24)])
def test_value_decodes_on_gpu_equal_cpu(cuda, family, wpc, num):
    n = 600
    if family == "regular":
        codes = ensemble.sample_codes(10, 0, num, n, 3, 6, "repair")
        fn = erasure_bp.bp_decode_packed_traj
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO)
        codes = irregular.sample_irregular_codes(10, 0, num, spec)
        fn = erasure_bp.bp_decode_packed_traj_irregular
    code = codes if num > 1 else codes.select(0)
    _, _, tx = _encoded(code, wpc * num, 11)
    erased = bitops.bernoulli_packed(0.42, (n, wpc * num), seed=12)
    cpu, cpu_traj = fn(code, erased, tx, 50)
    gpu, gpu_traj = fn(code.to(cuda), erased.to(cuda), tx.to(cuda), 50)
    assert torch.equal(gpu.val.cpu(), cpu.val)
    assert torch.equal(gpu.known.cpu(), cpu.known)
    assert torch.equal(gpu.error_totals.cpu(), cpu.error_totals)
    assert torch.equal(gpu_traj.cpu(), cpu_traj)
    assert gpu.iterations == cpu.iterations


# kernel D's value form: the whole random-transmit decode, a block a word of
# one code (the fixed decodes) or a block a code (small batches)
@pytest.mark.parametrize("family", ["regular", "irregular", "dc10"])
@pytest.mark.parametrize("wpc, num", [(1, 40), (3, 7), (2, 1)])
@pytest.mark.parametrize("max_iters", [0, 1, 50])
def test_erasure_decode_values_kernel_equals_plain(cuda, family, wpc, num,
                                                   max_iters):
    codes = _erasure_batch(family, num)
    rows = codes.var_to_chk.shape[1]
    erased = torch.cat([bitops.bernoulli_packed(
        float(p), (rows, wpc), seed=3, offset=g)
        for g, p in enumerate(np.resize([0.0, 1.0, 0.3, 0.42, 0.5], num))],
        dim=1)
    # random planes, not codewords: checks teach clashing values
    tx = bitops.bernoulli_packed(0.5, (rows, wpc * num), seed=4)
    if family == "irregular":
        erased[-1], tx[-1] = 0, 0               # the phantom: known, 0
    out = []
    for device in (cuda, "cpu"):
        before = erasure_bp.erasure_decode_values.launches
        got = erasure_bp.erasure_decode_values(
            erased.to(device), tx.to(device), codes.chk_to_var.to(device),
            codes.var_to_chk.to(device), max_iters)
        assert erasure_bp.erasure_decode_values.launches - before == \
            (1 if device == cuda else 0)
        out.append([t.cpu() for t in got])
    for got, want in zip(*out):
        assert torch.equal(got, want)
    rounds = out[1][3]
    assert rounds[0] == 0 and int(rounds.max()) <= max_iters


def test_erasure_decode_values_refuses_a_block_beyond_shared_memory(cuda):
    # (3,6) at n = 10,332, one word: the all-zero form's block fits, the
    # value form's does not
    c = _code(10_332, seed=1).to(cuda)
    erased = torch.zeros((10_332, 1), dtype=torch.int32, device=cuda)
    chk, var = c.chk_to_var[None], c.var_to_chk[None]
    erasure_bp.erasure_decode(erased, chk, var, 5)
    with pytest.raises(ValueError, match="shared memory"):
        erasure_bp.erasure_decode_values(erased, erased, chk, var, 5)


def _value_limit():
    """The largest (3,6) n whose one word fits the value form's block."""
    return max(n for n in range(2, 40_000, 2)
               if erasure_bp._erasure_decode_smem_bytes(n, n // 2, 6, 1, True)
               <= erasure_bp.SMEM_OPTIN_BYTES)


def _value_case(case, cuda):
    """(the decode's code, erased, tx) on the card for a one-code case of
    the value decode: the headline shape with codewords and with random
    planes, the value form's one-word limit and one word above it, an
    irregular code, and planes 8 bytes past a 16-byte boundary."""
    if case == "irregular":
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(10_000, LAM, RHO)
        c = irregular.sample_irregular_codes(5, 0, 1, spec,
                                             "repair").select(0).to(cuda)
        n, words = 10_000, 96
    else:
        n, words = {"headline_codeword": (10_000, 768),
                    "headline_random": (10_000, 768),
                    "limit": (_value_limit(), 40),
                    "above": (_value_limit() + 2, 8),
                    "misaligned": (600, 33)}[case]
        c = _code(n, seed=n).to(cuda)
    erased = bitops.bernoulli_packed(0.42, (n, words), seed=7, device=cuda)
    if case in ("headline_codeword", "misaligned"):
        tx = _encoded(c, words, 8, cuda)[2]
    else:
        tx = bitops.bernoulli_packed(0.5, (n, words), seed=8, device=cuda)
    if case == "misaligned":
        planes = []
        for t in (erased, tx):
            base = torch.zeros(n * words + 2, dtype=torch.int32,
                               device=cuda)
            planes.append(base[2:].view(n, words).copy_(t))
        erased, tx = planes
    return c, erased, tx


@pytest.mark.parametrize("case", ["headline_codeword", "headline_random",
                                  "limit", "irregular", "misaligned",
                                  "above"])
def test_value_decode_takes_kernel_d_by_rule(cuda, case):
    # one code: the value form one block a word where the word fits a
    # block, else the host loop over check_exactly_one_xor and
    # variable_or_adopt; either way equal to the plain host loop and to the
    # round kernels' host loop
    c, erased, tx = _value_case(case, cuda)
    irr = case == "irregular"
    decode, plain = (erasure_bp.bp_decode_packed_irregular,
                     erasure_bp.bp_decode_packed_irregular_plain) if irr \
        else (erasure_bp.bp_decode_packed, erasure_bp.bp_decode_packed_plain)
    view = erasure_bp._phantom_view(c) if irr else c
    takes = case != "above"
    assert erasure_bp.takes_erasure_decode_kernel(
        view, erased.shape[1], values=True) is takes
    wrappers = (erasure_bp.erasure_decode_values,
                erasure_bp.check_exactly_one_xor,
                erasure_bp.variable_or_adopt)
    before = [w.launches for w in wrappers]
    got = decode(c, erased, tx, 50)
    torch.cuda.synchronize()
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    if takes:
        assert launched == [1, 0, 0]
    else:
        assert launched[0] == 0 and launched[1] == launched[2] == \
            got.iterations
    rounds = erasure_bp._irregular_values(
        c, erased, tx, 50, erasure_bp._VALUE_KERNELS, False)[0] if irr \
        else erasure_bp._decode_values(c, erased, tx, 50,
                                       erasure_bp._VALUE_KERNELS, False)[0]
    for want in (rounds, plain(c, erased, tx, 50)):
        for field in ("known", "val", "error_totals"):
            assert torch.equal(getattr(got, field), getattr(want, field))
        assert got.iterations == want.iterations
    if case == "headline_random":               # on the CPU as well
        cpu = erasure_bp.bp_decode_packed(c.to("cpu"), erased.cpu(),
                                          tx.cpu(), 50)
        assert torch.equal(got.val.cpu(), cpu.val)
        assert torch.equal(got.error_totals.cpu(), cpu.error_totals)


def test_fixed_random_run_takes_kernel_d(cuda):
    # the mode-3 random-transmit BEC run launches the value form once a
    # chunk and the row-5 round kernels never, and equals the CPU's run
    cfg = SimulationConfig(channel_param=0.42, n=504, code_mode="fixed",
                           iterations=40, batch=640, num_tests=1920, seed=4,
                           max_block_errors=10**9, transmit="random")
    code = _code(504, seed=2)
    wrappers = (erasure_bp.erasure_decode_values,
                erasure_bp.check_exactly_one_xor,
                erasure_bp.variable_or_adopt)
    before = [w.launches for w in wrappers]
    gpu = mc.run_simulation(cfg, code, device="cuda")
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3, 0, 0]
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "bit_errors_sq", "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


@pytest.mark.parametrize("shape", [(97, 64), (600, 640)])
def test_awgn_llr_kernel_with_codewords_equals_plain(cuda, shape):
    tx = bitops.bernoulli_packed(0.5, (shape[0], shape[1] // 32), seed=13)
    got = channels.awgn_llr(0.8, shape, seed=14, offset=2, device=cuda,
                            tx=tx.to(cuda)).cpu()
    want = channels.awgn_llr(0.8, shape, seed=14, offset=2, tx=tx)
    ulps = _ulps(got.abs(), want.abs())
    assert int(ulps.max()) <= 1 and torch.equal(got < 0, want < 0)
    zero = channels.awgn_llr(0.8, shape, seed=14, offset=2, device=cuda)
    assert torch.equal(channels.awgn_llr(
        0.8, shape, seed=14, offset=2, device=cuda,
        tx=torch.zeros_like(tx, device=cuda)), zero)


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("method, dtype", SOFT)
def test_soft_decodes_with_codewords_on_gpu_equal_cpu(cuda, family, method,
                                                      dtype):
    n, cols = 300, 256
    if family == "regular":
        code, fn = _code(n, seed=15), soft_bp.soft_bp_decode
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, *MIXED)
        code = irregular.sample_irregular_codes(15, 0, 1, spec).select(0)
        fn = soft_bp.soft_bp_decode_irregular
    _, _, tx = _encoded(code, cols // 32, 16)
    llr = channels.awgn_llr(0.85, (n, cols), seed=17, tx=tx)
    cpu = fn(code, llr, 30, method=method, msg_dtype=dtype, tx_bits=tx,
             record="per_trial")
    gpu = fn(code.to(cuda), llr.to(cuda), 30, method=method,
             msg_dtype=dtype, tx_bits=tx.to(cuda), record="per_trial")
    if method == "minsum":
        assert torch.equal(gpu.hard.cpu(), cpu.hard)
        assert torch.equal(gpu.traj.cpu(), cpu.traj)
    else:
        assert torch.allclose(gpu.posterior.cpu(), cpu.posterior, rtol=0,
                              atol=SP_ATOL[dtype])
    assert torch.equal(gpu.hard.cpu(),
                       (gpu.posterior.cpu() < 0) ^ bitops.unpack_bits(tx))


@pytest.mark.parametrize("record", ["total", "per_trial"])
@pytest.mark.parametrize("wpc, num", [(9, 1), (1, 24)])
def test_gallager_with_codewords_on_gpu_equal_cpu(cuda, record, wpc, num):
    n = 600
    codes = ensemble.sample_codes(18, 0, num, n, 3, 6, "repair")
    code = codes if num > 1 else codes.select(0)
    _, _, tx = _encoded(code, wpc * num, 19)
    flips = bitops.bernoulli_packed(0.04, (n, wpc * num), seed=20)
    cpu = gallager.gallager_decode_packed(code, tx ^ flips, 50,
                                          record=record, tx_bits=tx)
    gpu = gallager.gallager_decode_packed(
        code.to(cuda), (tx ^ flips).to(cuda), 50, record=record,
        tx_bits=tx.to(cuda))
    zero = gallager.gallager_decode_packed(code.to(cuda), flips.to(cuda), 50,
                                           record=record)
    for got in (gpu, zero):
        assert torch.equal(got.decided.cpu(), cpu.decided)
        assert torch.equal(got.error_totals.cpu(), cpu.error_totals)


@pytest.mark.parametrize("fields", [
    dict(channel="BEC", decoder="bp", channel_param=0.42,
         code_mode="ensemble"),
    dict(channel="BEC", decoder="bp", channel_param=0.42, lam=LAM, rho=RHO,
         code_mode="fixed"),
    dict(channel="BSC", decoder="gallager", channel_param=0.04,
         code_mode="fixed"),
    dict(channel="BSC", decoder="minsum", soft_msg_dtype="int8",
         channel_param=0.05, code_mode="ensemble"),
    dict(channel="AWGN", decoder="minsum", channel_param=0.85,
         code_mode="fixed")])
def test_random_transmit_runs_gpu_equal_cpu(cuda, fields):
    cfg = SimulationConfig(n=504, iterations=30, batch=640, num_tests=1280,
                           seed=4, codes_per_chunk=10, max_block_errors=10**9,
                           transmit="random", **fields)
    code = ensemble.code_for_config(cfg) if cfg.code_mode == "fixed" \
        else None
    gpu = mc.run_simulation(cfg, code, device="cuda")
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for field in ("num_trials", "block_errors", "bit_errors",
                  "bit_errors_sq", "code_bit_errors_sq",
                  "error_counts_per_iteration"):
        assert getattr(gpu, field) == getattr(cpu, field), field


# ---------------------------------------------------------------------------
# Quasi-cyclic codes: the circulant-index kernels (Q1-Q4)
# ---------------------------------------------------------------------------

# tests/test_torch_qc.py's hand-built irregular bases (blocks of degree 1
# and 2): (base, shifts, nb)
QC_HAND = {
    "degree_one": ([[0, 1, 2], [0, 1, 3]], [[0, 1, 2], [3, 0, 1]], 4),
    "uniform_clamped": ([[0, 1, 2, 3], [0, 2, 4, 5], [1, 3, 4, 5]],
                        [[0, 1, 2, 3], [1, 2, 3, 0], [2, 3, 0, 1]], 6)}


def _qc_code(family, Z):
    """The nb = 12 (3,6) base, the irregular nb = 24 base (variable degrees
    2 and 4), ("dc10") an nb = 20 base of check degree 10, ("irregular_gal")
    the nb = 24 Gallager base (degrees 3 and 4), ("dv5") an nb = 12 (5,10)
    base, or a hand-built base (shifts mod Z), lifted by Z."""
    g = torch.Generator().manual_seed(Z)
    if family == "regular":
        return qc.sample_qc_code(g, nb=12, dv=3, dc=6, Z=Z)
    if family == "dc10":
        return qc.sample_qc_code_irregular(g, nb=20, lam=[0, 0, 1.0],
                                           rho=[0] * 9 + [1.0], Z=Z)
    if family == "irregular_gal":
        return qc.sample_qc_code_irregular(g, nb=24, lam=[0, 0, 0.5, 0.5],
                                           rho=RHO, Z=Z)
    if family == "dv5":
        return qc.sample_qc_code(g, nb=12, dv=5, dc=10, Z=Z)
    if family in QC_HAND:
        base, shifts, nb = QC_HAND[family]
        return qc.irregular_qc_code_from_numpy(
            np.asarray(base), np.asarray(shifts) % Z, Z, nb, len(base))
    return qc.sample_qc_code_irregular(g, nb=24, lam=LAM, rho=RHO, Z=Z)


QC_SHAPES = [(1, 1), (17, 1), (16, 3), (333, 33), (1000, 70)]   # (Z, W)


# Q1 / Q2 shapes beside QC_SHAPES: several column tiles, a last tile
# narrower than the others (W = 36, 70), many rows (Z = 4096)
QC_BEC_SHAPES = QC_SHAPES + [(17, 4), (333, 36), (4096, 48), (1000, 70),
                             (64, 768)]


@pytest.mark.parametrize("family", ["regular", "irregular", "degree_one",
                                    "uniform_clamped", "dc10"])
@pytest.mark.parametrize("Z, words", QC_BEC_SHAPES)
@pytest.mark.parametrize("values", [False, True])
@pytest.mark.parametrize("align", [16, 8])
@pytest.mark.parametrize("tiled", [True, False])
def test_qc_bec_round_kernels_equal_plain(cuda, family, Z, words, values,
                                          align, tiled):
    # three rounds from erasures at eps = 0.42 on 60% of the variables (the
    # rest known in every trial, so whole items take Q2's skip), on the
    # card in column tiles (qc_bec_layout of a plane set over the cache) or
    # row-major,
    # on the CPU row-major; planes 8 bytes past a 16-byte boundary take
    # the one-word path
    code = _qc_code(family, Z)
    erased = bitops.bernoulli_packed(0.42, (code.n, words), seed=Z)
    rows = torch.from_numpy(np.random.default_rng(Z).random(code.n) < 0.4)
    erased[rows] = 0
    known0 = ~erased
    val0 = bitops.bernoulli_packed(0.5, (code.n, words), seed=Z + 1) & known0
    vec, tile = qc_bp.qc_bec_layout(code.n, words, align, 0)
    if not tiled:
        tile, vec = words, 4 if words % 4 == 0 and align == 16 else 1
    out = []
    for device in (cuda, "cpu"):
        adj = qc_bp._adjacency(code, device)
        known, val = known0.clone().to(device), val0.clone().to(device)
        layout = tile if device == cuda else None
        if device == cuda:
            known = _misaligned(qc_bp.to_tiles(known, tile), align)
            val = _misaligned(qc_bp.to_tiles(val, tile), align)
        got = []
        for _ in range(3):
            errors = torch.zeros(2, dtype=torch.int32, device=device)
            if values:
                ex, adopt = qc_bp.qc_check_exactly_one(adj, known, val,
                                                       tile=layout)
                qc_bp.qc_variable_or(adj, ex, known, errors, 1, adopt=adopt,
                                     val=val, tile=layout)
                planes = [ex, adopt, known, val]
            else:
                ex = qc_bp.qc_check_exactly_one(adj, known, tile=layout)
                qc_bp.qc_variable_or(adj, ex, known, errors, 1, tile=layout)
                planes = [ex, known]
            # copies: the CPU run's planes change in place next round
            got += [qc_bp.from_tiles(t, layout).to("cpu", copy=True)
                    for t in planes] + [errors.to("cpu", copy=True)]
            assert int(errors[0]) == 0      # only errors[slot] is written
        out.append(got)
        if device == cuda:
            launched = {(f.vec, f.tile) for f in (qc_bp.qc_check_exactly_one,
                                                  qc_bp.qc_variable_or)}
    for got, want in zip(*out):
        assert torch.equal(got, want)
    assert launched == {(vec, tile)}


# Q4's degree passes by family: degree 3 and 4 exact, every other degree
# (1, 2, 5) the generic pass
QC_GALLAGER_PATHS = {"regular": ("dv3",), "irregular": ("dv4", "generic"),
                     "irregular_gal": ("dv3", "dv4"), "dv5": ("generic",),
                     "degree_one": ("generic",),
                     "uniform_clamped": ("generic",)}


@pytest.mark.parametrize("family", sorted(QC_GALLAGER_PATHS))
@pytest.mark.parametrize("Z, words", QC_SHAPES + [(17, 4), (333, 36)])
@pytest.mark.parametrize("threshold, with_tx", [(None, False), (1, True),
                                                (0, False)])
def test_qc_gallager_round_kernels_equal_plain(cuda, family, Z, words,
                                               threshold, with_tx):
    # every Q4 instantiation: 16 bytes a thread (W a multiple of 4) and one
    # word (N = 1, four rows a thread; Z * W not a multiple of 4 at odd
    # shapes), with and without tx, each of its degree passes
    code = _qc_code(family, Z)
    clamp = isinstance(code, qc.IrregularQCLDPCCode)
    flips = bitops.bernoulli_packed(0.05, (code.n, words), seed=Z)
    tx = bitops.bernoulli_packed(0.5, (code.n, words), seed=Z + 1) \
        if with_tx else None
    rx = flips if tx is None else flips ^ tx
    out = []
    for device in (cuda, "cpu"):
        adj = qc_bp._adjacency(code, device)
        dvb = adj.var_chk.shape[1]
        t = (dvb if clamp else dvb - 1) if threshold is None else threshold
        channel = rx.to(device)
        msg = torch.full((adj.num_rows * Z, words), -7, dtype=torch.int32,
                         device=device)
        qc_gallager.qc_gallager_variable(adj, msg, None, channel, None, None,
                                         init=True)
        first = msg.clone()
        decided = channel.clone()
        counts = torch.zeros((1, 2), dtype=torch.int32, device=device)
        for _ in range(2):                     # the second round moves
            parity = qc_gallager.qc_gallager_check(adj, msg)
            qc_gallager.qc_gallager_variable(
                adj, msg, parity, channel, decided, counts, threshold=t,
                clamp=clamp, tx=None if tx is None else tx.to(device))
        out.append((first.cpu(), parity.cpu(), msg.cpu(), decided.cpu(),
                    counts.cpu()))
        if device == cuda:
            launched = (qc_gallager.qc_gallager_variable.vec,
                        qc_gallager.qc_gallager_variable.paths)
    for got, want in zip(*out):
        assert torch.equal(got, want)
    assert launched == (4 if words % 4 == 0 else 1, QC_GALLAGER_PATHS[family])


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("Z, words", [(17, 1), (333, 9)])
def test_qc_decodes_on_gpu_equal_cpu_and_expand(cuda, family, Z, words):
    code = _qc_code(family, Z)
    erased = bitops.bernoulli_packed(0.4, (code.n, words), seed=1)
    flips = bitops.bernoulli_packed(0.03, (code.n, words), seed=2)
    tx = bitops.bernoulli_packed(0.5, (code.n, words), seed=3)
    on_gpu = code.to(cuda)
    expanded = on_gpu.expand()
    irr = family == "irregular"
    cpu = qc_bp.qc_bp_decode_packed_allzero(code, erased, 50)
    gpu = qc_bp.qc_bp_decode_packed_allzero(on_gpu, erased.to(cuda), 50)
    gen = (erasure_bp.bp_decode_packed_allzero_irregular if irr else
           erasure_bp.bp_decode_packed_allzero)(expanded, erased.to(cuda), 50)
    for other in (cpu, gen):
        assert torch.equal(gpu.known.cpu(), other.known.cpu())
        assert torch.equal(gpu.error_totals.cpu(), other.error_totals.cpu())
        assert gpu.iterations == other.iterations
    cpu = qc_bp.qc_bp_decode_packed(code, erased, tx, 50)
    gpu = qc_bp.qc_bp_decode_packed(on_gpu, erased.to(cuda), tx.to(cuda), 50)
    assert torch.equal(gpu.known.cpu(), cpu.known)
    assert torch.equal(gpu.val.cpu(), cpu.val)
    assert torch.equal(gpu.error_totals.cpu(), cpu.error_totals)
    for kw in (dict(threshold=None), dict(threshold=1, record="per_trial"),
               dict(threshold=None, tx_bits=tx)):
        rx = flips if "tx_bits" not in kw else flips ^ tx
        cpu = qc_gallager.qc_gallager_decode_packed(code, rx, 50, **kw)
        kw_gpu = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v
                  for k, v in kw.items()}
        gpu = qc_gallager.qc_gallager_decode_packed(on_gpu, rx.to(cuda), 50,
                                                    **kw_gpu)
        gen = (gallager.gallager_decode_packed_irregular if irr else
               gallager.gallager_decode_packed)(expanded, rx.to(cuda), 50,
                                                **kw_gpu)
        for other in (cpu, gen):
            assert torch.equal(gpu.decided.cpu(), other.decided.cpu())
            assert torch.equal(gpu.error_totals.cpu(),
                               other.error_totals.cpu())
            assert gpu.iterations == other.iterations
        if kw.get("record") == "per_trial":
            assert torch.equal(gpu.traj.cpu(), cpu.traj)


@pytest.mark.parametrize("fields", [
    dict(channel="BEC", channel_param=0.42),
    dict(channel="BSC", decoder="gallager", channel_param=0.03),
    dict(channel="BEC", channel_param=0.42, lam=LAM, rho=RHO),
    dict(channel="BEC", channel_param=0.42, transmit="random"),
    dict(channel="BSC", decoder="minsum", soft_msg_dtype="int8",
         channel_param=0.05)])
def test_qc_runs_gpu_equal_cpu(cuda, fields):
    code = _qc_code("irregular" if "lam" in fields else "regular", 64)
    cfg = SimulationConfig(**{
        "n": code.n, "iterations": 30, "batch": 1024, "num_tests": 2048,
        "seed": 5, "code_mode": "fixed", "max_block_errors": 10**9,
        **fields})
    gpu = mc.run_simulation(cfg, code, device="cuda")
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for f in ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
              "error_counts_per_iteration"):
        assert getattr(gpu, f) == getattr(cpu, f), f


@pytest.mark.parametrize("fields", [
    dict(channel="AWGN", decoder="minsum", soft_msg_dtype="int8",
         channel_param=0.8),
    dict(channel="BEC", decoder="peeling", channel_param=0.42),
    dict(channel="BEC", decoder="peeling", channel_param=0.42,
         code_mode="ensemble")])
def test_qc_soft_and_peeling_runs_gpu_equal_cpu(cuda, fields):
    code = _qc_code("regular", 64)
    if fields["decoder"] == "peeling":
        code = code.expand()
    cfg = SimulationConfig(**{
        "n": code.n, "iterations": 30, "batch": 1024, "num_tests": 2048,
        "seed": 5, "code_mode": "fixed", "max_block_errors": 10**9,
        **fields})
    gpu = mc.run_simulation(cfg, code, device="cuda")
    cpu = mc.run_simulation(cfg, code, device="cpu")
    for f in ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
              "error_counts_per_iteration"):
        assert getattr(gpu, f) == getattr(cpu, f), f


# ---------------------------------------------------------------------------
# Quasi-cyclic soft BP: S1 and S2
# ---------------------------------------------------------------------------

QC_SOFT_SHAPES = [(17, 4), (16, 36), (333, 64)]      # (Z, trials)


def _qc_soft_case(family, Z, cols, dtype, seed=0):
    """A QC code and random planes for one pass comparison."""
    rng = np.random.default_rng(seed)
    code = _qc_code(family, Z)
    adj = qc_bp._adjacency(code, "cpu")
    rows = adj.num_rows * Z
    if dtype == torch.int8:
        def draw(shape, _mean, _sd):
            return torch.from_numpy(rng.integers(-127, 128, shape)
                                    .astype(np.int8))
        llr0 = draw((code.n, cols), 0, 0)
    else:
        def draw(shape, mean, sd):
            return torch.from_numpy(rng.normal(mean, sd, shape)
                                    .astype(np.float32)).to(dtype)
        llr0 = draw((code.n, cols), 2, 4).float()
    return code, dict(msg=draw((rows, cols), 0, 6), llr0=llr0,
                      pm=draw((code.n, cols), 0, 8))


@pytest.mark.parametrize("family", ["regular", "irregular", "dc10"])
@pytest.mark.parametrize("Z, cols", QC_SOFT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mode", ["per_trial", "total", "final"])
def test_qc_soft_posterior_kernel_equals_plain(cuda, family, Z, cols, dtype,
                                               mode):
    code, case = _qc_soft_case(family, Z, cols, dtype)
    out = []
    for device in (cuda, "cpu"):
        adj = qc_bp._adjacency(code, device)
        pm = case["pm"].clone().to(device)
        counts = torch.zeros(1 if mode == "total" else cols,
                             dtype=torch.int32, device=device)
        extra = {}
        if mode == "final":
            extra = dict(post=torch.zeros((code.n, cols), device=device),
                         hard=torch.zeros((code.n, cols), dtype=torch.bool,
                                          device=device))
        qc_soft_bp.qc_soft_posterior(
            case["llr0"].to(device), case["msg"].to(device), adj,
            torch.ones(1, dtype=torch.int32, device=device), pm, counts,
            int8_scale=4.0, **extra)
        out.append([pm.cpu(), counts.cpu()] + [t.cpu()
                                               for t in extra.values()])
    for got, want in zip(*out):
        assert torch.equal(got, want)
    assert int(out[1][1].sum()) > 0


@pytest.mark.parametrize("family", ["regular", "irregular", "dc10"])
@pytest.mark.parametrize("Z, cols", QC_SOFT_SHAPES)
@pytest.mark.parametrize("method, dtype", SOFT)
def test_qc_soft_check_kernel_equals_plain(cuda, family, Z, cols, method,
                                           dtype):
    code, case = _qc_soft_case(family, Z, cols, dtype, seed=1)
    kw = dict(method=method)
    if method == "minsum" and dtype != torch.int8:
        kw.update(alpha=0.8, beta=0.25)
    out = []
    for device in (cuda, "cpu"):
        adj = qc_bp._adjacency(code, device)
        msg = case["msg"].clone().to(device)
        unsat = torch.zeros(1, dtype=torch.int32, device=device)
        qc_soft_bp.qc_soft_check(case["pm"].to(device), msg, adj,
                                 torch.ones(1, dtype=torch.int32,
                                            device=device), unsat, **kw)
        out.append((msg.cpu(), unsat.cpu()))
    (msg_k, unsat_k), (msg_p, unsat_p) = out
    assert torch.equal(unsat_k, unsat_p) and int(unsat_p) > 0
    if method == "sumproduct":
        assert torch.allclose(msg_k.float(), msg_p.float(),
                              atol=SP_ATOL[dtype], rtol=0)
    else:
        assert torch.equal(msg_k, msg_p)
    # a stopped decode leaves the messages as they were
    msg = case["msg"].clone().to(cuda)
    qc_soft_bp.qc_soft_check(case["pm"].to(cuda), msg,
                             qc_bp._adjacency(code, cuda),
                             torch.zeros(1, dtype=torch.int32, device=cuda),
                             torch.zeros(1, dtype=torch.int32, device=cuda),
                             **kw)
    assert torch.equal(msg.cpu(), case["msg"])


INT8_EDGES = np.array([-128, -127, -1, 0, 1, 127], np.int8)


@pytest.mark.parametrize("family", ["regular", "irregular", "dc10"])
@pytest.mark.parametrize("cols", [4, 16, 36, 1536])
@pytest.mark.parametrize("case", ["edges", "zeros", "saturated"])
def test_qc_soft_check_kernel_equals_plain_int8_adversarial(cuda, family,
                                                            cols, case):
    """S2's packed int8 lanes bit for bit against the plain version where
    saturation and ties decide: planes drawn from {-128, -127, -1, 0, 1,
    127} (r = p - m hits +-255, +-254, +-128, +-127 and 0, ties at the
    minimum are everywhere), all-zero extrinsics (every output 0), and
    |r| = 254 on every socket (every magnitude saturates at 127).  Both
    lane widths run: 16 bytes a thread (cols % 16 == 0, degree <= 8) and
    4 bytes (cols = 4, 36, and the degree-10 family)."""
    rng = np.random.default_rng(cols)
    code = _qc_code(family, 17)
    adj = qc_bp._adjacency(code, "cpu")
    rows = adj.num_rows * adj.Z
    if case == "edges":
        pm, msg0 = (INT8_EDGES[rng.integers(0, len(INT8_EDGES), shape)]
                    for shape in ((code.n, cols), (rows, cols)))
    elif case == "zeros":
        pm, msg0 = np.zeros((code.n, cols), np.int8), \
            np.zeros((rows, cols), np.int8)
    else:
        sign = np.where(rng.random(cols) < 0.5, 1, -1).astype(np.int8)
        pm = np.broadcast_to(127 * sign, (code.n, cols))
        msg0 = np.broadcast_to(-127 * sign, (rows, cols))
    pm, msg0 = torch.from_numpy(np.ascontiguousarray(pm)), \
        torch.from_numpy(np.ascontiguousarray(msg0))
    out = []
    for device in (cuda, "cpu"):
        msg = msg0.clone().to(device)
        unsat = torch.zeros(1, dtype=torch.int32, device=device)
        qc_soft_bp.qc_soft_check(pm.to(device), msg,
                                 qc_bp._adjacency(code, device),
                                 torch.ones(1, dtype=torch.int32,
                                            device=device), unsat,
                                 method="minsum")
        out.append((msg.cpu(), unsat.cpu()))
    (msg_k, unsat_k), (msg_p, unsat_p) = out
    assert torch.equal(unsat_k, unsat_p)
    assert torch.equal(msg_k, msg_p)
    if case == "zeros":
        assert not msg_p.any() and int(unsat_p) == 0
    if case == "saturated":
        assert bool((msg_p.abs() == 127).all())


@pytest.mark.parametrize("family", ["regular", "irregular", "dc10"])
@pytest.mark.parametrize("method, dtype", SOFT)
def test_qc_soft_decodes_on_gpu_equal_cpu_and_expand(cuda, family, method,
                                                     dtype):
    code = _qc_code(family, 40)
    sigma = 0.8 if family == "regular" else 0.7
    llr = channels.awgn_llr(sigma, (code.n, 96), seed=3)
    kw = dict(method=method, msg_dtype=dtype)
    cpu = qc_soft_bp.qc_soft_bp_decode(code, llr, 30, **kw)
    before = (qc_soft_bp.qc_soft_posterior.launches,
              qc_soft_bp.qc_soft_check.launches)
    gpu = qc_soft_bp.qc_soft_bp_decode(code.to(cuda), llr.to(cuda), 30, **kw)
    assert (qc_soft_bp.qc_soft_posterior.launches - before[0],
            qc_soft_bp.qc_soft_check.launches - before[1]) == \
        (gpu.iterations + 1, gpu.iterations)
    decode = soft_bp.soft_bp_decode if family == "regular" else \
        soft_bp.soft_bp_decode_irregular
    gen = decode(code.to(cuda).expand(), llr.to(cuda), 30, **kw)
    for other in (cpu, gen):
        if method == "minsum":
            assert gpu.iterations == other.iterations
            assert torch.equal(gpu.error_totals.cpu(),
                               other.error_totals.cpu())
            assert torch.equal(gpu.hard.cpu(), other.hard.cpu())
            assert torch.equal(gpu.posterior.cpu(), other.posterior.cpu())
        else:
            assert torch.allclose(gpu.posterior.cpu(), other.posterior.cpu(),
                                  atol=SP_ATOL[dtype], rtol=1e-4)
            assert float((gpu.hard.cpu() == other.hard.cpu()).float()
                         .mean()) > 0.999
    assert torch.equal(gpu.satisfied.cpu(), cpu.satisfied) \
        or method == "sumproduct"


# ---------------------------------------------------------------------------
# The peel: P1, and the parallel peel on K2/K3
# ---------------------------------------------------------------------------

def _peel_case(family, n, trials, batched, seed):
    if family == "regular":
        codes = ensemble.sample_codes(seed, 0, trials if batched else 1, n,
                                      3, 6)
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO)
        codes = irregular.sample_irregular_codes(seed, 0,
                                                 trials if batched else 1,
                                                 spec)
    return codes if batched else codes.select(0)


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("n, trials, batched", [(96, 1, False),
                                                (600, 37, False),
                                                (600, 33, True),
                                                (2048, 8, True)])
@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_peel_kernel_equals_plain(cuda, family, n, trials, batched, eps):
    codes = _peel_case(family, n, trials, batched, seed=n)
    rng = np.random.default_rng(n)
    rx = torch.from_numpy(np.where(rng.random((trials, n)) < eps, 2, 0))
    rx[0] = 0                                  # a trial with no erasure
    before = peeling.peel_sequential.launches
    got = peeling.peel_decode_batch(codes.to(cuda), rx.to(cuda), seed=5)
    assert peeling.peel_sequential.launches == before + 1
    want = peeling.peel_decode_batch(codes, rx, seed=5)
    for f in ("unresolved", "one_degree_evolution", "steps", "num_erasures"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    cut = peeling.peel_decode_batch(codes.to(cuda), rx.to(cuda), seed=5,
                                    max_steps=7)
    want = peeling.peel_decode_batch(codes, rx, seed=5, max_steps=7)
    for f in ("unresolved", "one_degree_evolution", "steps", "num_erasures"):
        assert torch.equal(getattr(cut, f).cpu(), getattr(want, f)), f


def test_peel_kernel_above_48kb_of_shared_memory(cuda):
    """n = 300,000 needs ~206 KB of shared memory a block (the opt-in
    above 48 KB); the plain version runs on the card too."""
    code = ensemble.sample_codes(3, 0, 1, 300_000, 3, 6).select(0).to(cuda)
    rx = torch.where(bitops.unpack_bits(bitops.bernoulli_packed(
        0.01, (2, 300_000 // 32), seed=1, device=cuda)), 2, 0)
    got = peeling.peel_decode_batch(code, rx, seed=2)
    assert peeling.peel_sequential.form == "row"
    want = peeling.peel_decode_batch_plain(code, rx, seed=2)
    for f in ("unresolved", "one_degree_evolution", "steps", "num_erasures"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(got.success.all())
    chk, var, n, m = peeling._tables(code)
    with pytest.raises(ValueError, match="xor form does not take"):
        peeling.peel_sequential(chk, var, (rx == 2).contiguous(), n, m, 2,
                                n, form="xor")


PEEL_FIELDS = ("unresolved", "one_degree_evolution", "steps", "num_erasures")
LAM6 = [0, 0.5, 0, 0, 0, 0.5]                # dv_max 6: the generic width


def _peel_forms_against_plain(codes, erased, seed, max_steps):
    """Both P1 forms against the plain version on the card's tensors;
    returns the form the rule launched."""
    chk, var, n, m = peeling._tables(codes)
    want = peeling._peel_sequential_plain(chk, var, erased, n, m, seed,
                                          max_steps)
    peeling.peel_sequential(chk, var, erased, n, m, seed, max_steps)
    ruled = peeling.peel_sequential.form
    assert ruled == peeling.peel_form(n, m, chk.shape[-1], var.shape[-1])
    for form in peeling.PEEL_FORMS:
        before = peeling.peel_sequential.launches
        got = peeling.peel_sequential(chk, var, erased, n, m, seed,
                                      max_steps, form=form)
        torch.cuda.synchronize()
        assert peeling.peel_sequential.launches == before + 1
        assert peeling.peel_sequential.form == form
        for f, a, b in zip(PEEL_FIELDS, got, want):
            assert torch.equal(a, b), (form, f)
    return ruled


@pytest.mark.parametrize("family, n, trials, batched", [
    ("regular", 96, 5, False), ("regular", 600, 33, True),
    ("irregular", 600, 37, False), ("irregular", 2048, 8, True),
    ("irregular6", 600, 9, True),            # dv_max 6: the generic width
    ("regular24", 12_000, 6, True),          # dv 2, 8 bitmap words a lane
    ("regular", 9_000, 4, True),             # m = 4,500: 8 words a lane
])
@pytest.mark.parametrize("max_steps", [None, 0, 7])
def test_peel_forms_equal_plain(cuda, family, n, trials, batched,
                                max_steps):
    if family == "regular":
        codes = ensemble.sample_codes(n, 0, trials if batched else 1, n, 3,
                                      6, device=cuda)
    elif family == "regular24":
        codes = ensemble.sample_codes(n, 0, trials, n, 2, 4, device=cuda)
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(
            n, LAM if family == "irregular" else LAM6, RHO, device=cuda)
        codes = irregular.sample_irregular_codes(
            n, 0, trials if batched else 1, spec, device=cuda)
    codes = codes if batched else codes.select(0)
    rng = np.random.default_rng(n)
    erased = torch.from_numpy(rng.random((trials, n)) < 0.45).to(cuda)
    erased[0] = False                         # a trial with no erasure
    ruled = _peel_forms_against_plain(codes, erased, 5,
                                      n if max_steps is None else max_steps)
    assert ruled == "xor"


@pytest.mark.parametrize("seed", range(4))
def test_peel_forms_on_multi_edge_codes(cuda, seed):
    """Unrepaired socket permutations: some variables meet a check twice
    (two sockets of one check on the update's lanes)."""
    n, dv, dc = 600, 3, 6
    m = n * dv // dc
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n * dv)
    var = torch.from_numpy((perm // dc).reshape(n, dv)).to(torch.int32)
    chk = np.zeros(m * dc, np.int64)
    chk[perm] = np.repeat(np.arange(n), dv)
    chk = torch.from_numpy(chk.reshape(m, dc)).to(torch.int32)
    assert any(len(set(r.tolist())) < dv for r in var)
    erased = torch.from_numpy(rng.random((40, n)) < 0.45)
    want = peeling._peel_sequential_plain(chk, var, erased, n, m, seed, n)
    for form in peeling.PEEL_FORMS:
        got = peeling.peel_sequential(chk.to(cuda), var.to(cuda),
                                      erased.to(cuda), n, m, seed, n,
                                      form=form)
        for f, a, b in zip(PEEL_FIELDS, got, want):
            assert torch.equal(a.cpu(), b), (form, f)


@pytest.mark.parametrize("family, trials", [("regular", 400),
                                            ("irregular", 100)])
def test_peel_forms_at_the_experiment_shape(cuda, family, trials):
    """chip_smoke.py phase 33's shape: fresh codes of n = 16,384 at eps =
    0.42, one trial each; the rule launches "xor"."""
    n = 16_384
    if family == "regular":
        codes = ensemble.sample_codes(7, 0, trials, n, 3, 6, device=cuda)
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO,
                                                            device=cuda)
        codes = irregular.sample_irregular_codes(7, 0, trials, spec,
                                                 device=cuda)
    erased = bitops.unpack_bits(bitops.bernoulli_packed(
        0.42, (trials, n // 32), seed=7, device=cuda)).contiguous()
    assert _peel_forms_against_plain(codes, erased, 7, n) == "xor"


@pytest.mark.parametrize("eps", [0.3, 0.42, 0.5])
def test_parallel_peel_on_gpu_equals_plain(cuda, eps):
    code = _code(600, seed=4)
    rng = np.random.default_rng(9)
    rx = torch.from_numpy(np.where(rng.random(600) < eps, 2, 0))
    before = erasure_bp.check_exactly_one.launches
    got, rounds = peeling.peel_decode_parallel(code.to(cuda), rx.to(cuda))
    assert erasure_bp.check_exactly_one.launches == before + rounds
    want, want_rounds = peeling.peel_decode_parallel_plain(code, rx)
    assert torch.equal(got.cpu(), want) and rounds == want_rounds


# ---------------------------------------------------------------------------
# Edge sharding: X1 (edge_candidates), X2 (or_reduce_update)
# ---------------------------------------------------------------------------

def _edge_state(code, words, seed, state):
    """A known plane int32[n, W] on the CPU: random words ("random"), or a
    decode's after 4 rounds at eps = 0.4 ("later": most words of a
    variable all known or all but a few bits)."""
    n = code.var_to_chk.shape[0]
    if state == "random":
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(-2**31, 2**31, (n, words),
                                             dtype=np.int64).astype(np.int32))
    erased = bitops.bernoulli_packed(0.4, (n, words), seed=seed,
                                     device="cpu")
    return erasure_bp.bp_decode_packed_allzero(code, erased, 4).known


@pytest.mark.parametrize("n, words", [(12, 1), (600, 7), (3000, 33),
                                      (1000, 4), (3334, 36), (20000, 48),
                                      (1000, 70), (3334, 32), (600, 768)])
@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("layout", ["aligned", "misaligned"])
@pytest.mark.parametrize("state", ["random", "later"])
def test_edge_round_kernels_equal_plain(cuda, n, words, size, layout,
                                        state):
    """K2 on every shard's check rows and X1 on its summary against their
    plain versions and the wrappers' CPU run, on planes as the decode
    allocates them and 8 bytes past a 16-byte boundary (the 4-byte path);
    then X2 on the shards' candidates.  The launched width is asserted."""
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es

    code = _code(n, seed=size)
    known = _edge_state(code, words, size, state)
    vec = erasure_bp.check_exactly_one_vector(
        words, 16 if layout == "aligned" else 8)

    def on_card(t):
        t = t.to(cuda)
        return _misaligned(t, 8) if layout == "misaligned" else t

    known_dev, v2c = on_card(known), code.var_to_chk.to(cuda)
    m_local = -(-code.m // size)
    cands = []
    for r in range(size):
        off = r * m_local
        chk_local = code.chk_to_var[off:off + m_local]
        want_ex = erasure_bp._check_exactly_one_plain(chk_local, known)
        ex = erasure_bp.check_exactly_one(chk_local.to(cuda), known_dev)
        assert erasure_bp.check_exactly_one.vec == vec
        assert torch.equal(ex.cpu(), want_ex)
        got = es.edge_candidates(v2c, on_card(want_ex), off)
        assert es.edge_candidates.vec == vec
        want = es._edge_candidates_plain(code.var_to_chk, want_ex, off)
        assert torch.equal(got.cpu(), want)
        on_cpu = es.edge_candidates(
            code.var_to_chk, erasure_bp.check_exactly_one(chk_local, known),
            off)
        assert torch.equal(got.cpu(), on_cpu)
        cands.append(want)
    gathered = torch.stack(cands)
    state = known.to(cuda)
    errors = torch.zeros(3, dtype=torch.int32, device=cuda)
    es.or_reduce_update(gathered.to(cuda), state, errors, 1)
    want_known, want_errors = known.clone(), torch.zeros(3, dtype=torch.int32)
    es._or_reduce_update_plain(gathered, want_known, want_errors, 1)
    assert torch.equal(state.cpu(), want_known)
    assert torch.equal(errors.cpu(), want_errors)


@pytest.mark.parametrize("dv, dc", [(2, 4), (4, 8), (5, 10)])
@pytest.mark.parametrize("size", [1, 2])
def test_edge_round_kernels_other_degrees(cuda, dv, dc, size):
    """K2 and X1 at degrees other than the (3,6) code's (the socket loops,
    not the unrolled instantiations) against their plain versions."""
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es

    n, words = 2000, 32
    code = sample_code(torch.Generator().manual_seed(dc), n, dv, dc)
    known = _edge_state(code, words, dv, "later")
    m_local = code.m // size
    for r in range(size):
        off = r * m_local
        chk_local = code.chk_to_var[off:off + m_local]
        want_ex = erasure_bp._check_exactly_one_plain(chk_local, known)
        ex = erasure_bp.check_exactly_one(chk_local.to(cuda), known.to(cuda))
        assert torch.equal(ex.cpu(), want_ex)
        got = es.edge_candidates(code.var_to_chk.to(cuda), ex, off)
        want = es._edge_candidates_plain(code.var_to_chk, want_ex, off)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("wpc, num", [(1, 64), (3, 16), (24, 8)])
@pytest.mark.parametrize("align", [16, 8])
def test_check_exactly_one_batched_equals_plain(cuda, wpc, num, align):
    """K2 on a batch of codes (word w of code w // wpc) against its plain
    version: 16 bytes a thread only where a code's words are a multiple of
    4 and the planes 16-byte aligned."""
    codes = ensemble.sample_codes(4, 0, num, 600, 3, 6)
    words = wpc * num
    known = _edge_state(codes.select(0), words, wpc, "random")
    want = erasure_bp._check_exactly_one_plain(codes.chk_to_var, known)
    got = erasure_bp.check_exactly_one(codes.chk_to_var.to(cuda),
                                       _misaligned(known.to(cuda), align))
    assert torch.equal(got.cpu(), want)
    assert erasure_bp.check_exactly_one.vec == \
        (4 if wpc % 4 == 0 and align == 16 else 1)


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("eps", [0.35, 0.45])
@pytest.mark.parametrize("words", [5, 32])
def test_edge_sharded_decode_on_gpu_equals_packed_and_cpu(cuda, family, eps,
                                                          words):
    """The edge decode on the card (4 bytes a thread at W = 5, 16 at W =
    32) against the unsharded K2/K3 decode and the CPU's edge decode."""
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es

    n = 1200
    if family == "regular":
        code = _code(n, seed=7)
        edge, packed = es.edge_sharded_bp_decode, \
            erasure_bp.bp_decode_packed_allzero
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(
            n, [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0])
        code = irregular.sample_irregular_code(
            torch.Generator().manual_seed(7), spec)
        edge, packed = es.edge_sharded_bp_decode_irregular, \
            erasure_bp.bp_decode_packed_allzero_irregular
    erased = bitops.bernoulli_packed(eps, (n, words), seed=3, device="cpu")
    before = (es.edge_candidates.launches, es.or_reduce_update.launches,
              erasure_bp.check_exactly_one.launches)
    got = edge(code.to(cuda), erased.to(cuda), 60)
    rounds = got.iterations
    assert (es.edge_candidates.launches, es.or_reduce_update.launches,
            erasure_bp.check_exactly_one.launches) == tuple(
        b + rounds for b in before)
    assert es.edge_candidates.vec == erasure_bp.check_exactly_one.vec == \
        (4 if words % 4 == 0 else 1)
    for want in (packed(code.to(cuda), erased.to(cuda), 60),
                 edge(code, erased, 60)):
        assert torch.equal(got.known.cpu(), want.known.cpu())
        assert torch.equal(got.error_totals.cpu(), want.error_totals.cpu())
        assert got.iterations == want.iterations


def _nccl_rank(rank, size, port, outdir):
    """One rank of an NCCL group, one card each: the edge-sharded decode
    and a batch-sharded fixed-BEC run, saved for the parent."""
    from iib_project_ldpc_codes_tpu_torch.parallel import distributed
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es

    distributed.initialize(f"127.0.0.1:{port}", size, rank,
                           device=f"cuda:{rank}", timeout_s=300)
    try:
        dev = torch.device("cuda", rank)
        erased = bitops.bernoulli_packed(0.42, (2400, 3), seed=9, device=dev)
        res = es.edge_sharded_bp_decode(_code(2400, seed=5, device=dev),
                                        erased, 60)
        run = mc.run_simulation(_nccl_cfg(size), _code(600, seed=6),
                                device=dev, group=distributed.global_group())
        torch.save({"known": res.known.cpu(),
                    "error_totals": res.error_totals.cpu(),
                    "iterations": res.iterations,
                    "run": (run.num_trials, run.block_errors, run.bit_errors,
                            run.error_counts_per_iteration)},
                   f"{outdir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _nccl_cfg(size):
    return SimulationConfig(channel_param=0.42, n=600, iterations=30,
                            batch=64 * size, num_tests=128 * size, seed=2,
                            code_mode="fixed", max_block_errors=10**9)


def test_nccl_group_of_every_card_equals_one_process(cuda, tmp_path):
    import torch.multiprocessing as mp

    from iib_project_ldpc_codes_tpu_torch.parallel import dryrun
    from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es

    size = torch.cuda.device_count()
    if size < 2:
        pytest.skip("needs two or more GPUs (NCCL refuses two ranks on "
                    "one card)")
    mp.spawn(_nccl_rank, args=(size, dryrun.free_port(), str(tmp_path)),
             nprocs=size, join=True)
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(size)]
    erased = bitops.bernoulli_packed(0.42, (2400, 3), seed=9, device=cuda)
    alone = es.edge_sharded_bp_decode(_code(2400, seed=5, device=cuda),
                                      erased, 60)
    cfg, code = _nccl_cfg(size), _code(600, seed=6)
    fns = [mc.make_chunk_fn(cfg, code, device=cuda, rank=r, size=size)
           for r in range(size)]
    stats = [fn(c) for c in range(2) for fn in fns]
    want = (cfg.num_tests, sum(int(s.block_errors) for s in stats),
            sum(int(s.bit_errors) for s in stats),
            sum(s.error_totals.cpu().to(torch.int64) for s in stats).tolist())
    for o in outs:
        assert torch.equal(o["known"], alone.known.cpu())
        assert torch.equal(o["error_totals"], alone.error_totals.cpu())
        assert o["iterations"] == alone.iterations
        assert o["run"] == want


# -- kernel A's own transform and division, K4's bit-sliced counter ---------

@pytest.mark.parametrize("sigma", [0.8, 0.841, 3.7, 2.0 ** -29.9, 1e-12,
                                   2.0 ** 31])
@pytest.mark.parametrize("with_tx", [False, True])
def test_awgn_llr_kernel_every_division_path_equals_plain(cuda, sigma,
                                                          with_tx):
    """sigma^2 in [2^-60, 2^60] divides by products, outside it by
    __fdiv_rn (1e-12 and 2^31): both against the plain version on the
    card, the same float64 steps but the math library's log / sincos."""
    shape = (257, 320)
    tx = bitops.info_planes(shape[0], shape[1] // 32, seed=4,
                            device=cuda) if with_tx else None
    got = channels.awgn_llr(sigma, shape, seed=21, offset=5, device=cuda,
                            tx=tx)
    want = channels._awgn_llr_plain(sigma, shape, channels.awgn_key(21), 5,
                                    cuda, tx)
    ulps = _ulps(got.abs(), want.abs())
    assert torch.equal(got < 0, want < 0) and int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) <= max(1, got.numel() // 10**5)


@pytest.mark.parametrize("first, mode", [
    (0, 1), ((1 << 32) - (1 << 22), 1), ((1 << 31) - (1 << 21), 1),
    (0x3F800000 - (1 << 21), 2), (0xBF800000 - (1 << 21), 2),
    (0x4F000000 - (1 << 21), 2)])
def test_awgn_llr_check_finds_no_word_outside(cuda, first, mode):
    """The check entry on slices of 2^22 words: the transform at both ends
    and the middle of the words, the division by products on numerators
    around +-1 and 2^31 (every one of them compared)."""
    from iib_project_ldpc_codes_tpu_torch.kernels import launch

    counts = torch.zeros(7, dtype=torch.int64, device=cuda)
    sigma_sq = float(np.float32(0.8) * np.float32(0.8))
    launch("ldpc_awgn_llr_check", cuda, counts.data_ptr(), first, 1 << 22,
           sigma_sq, mode)
    c = counts.cpu().tolist()
    if mode == 1:
        assert c[0] == 0 and c[2] == 0
        assert c[1] <= 2        # words whose float32 rounding of r differs
    else:
        assert c[3] == 0 and c[4] == 1 << 22


@pytest.mark.parametrize("n", [1, 15, 16, 17, 127, 128, 129, 1023, 1024,
                               1025, 16_385, 70_000])
@pytest.mark.parametrize("w", [1, 3, 4, 5, 48, 768])
def test_per_trial_counts_kernel_across_runs_and_widths(cuda, n, w):
    for prob in (0.42, 1.0):
        words = bitops.bernoulli_packed(prob, (n, w), seed=n * 7 + w,
                                        device=cuda)
        assert torch.equal(bitops.per_trial_counts(words),
                           bitops._per_trial_counts_plain(words))


def test_per_trial_counts_kernel_on_a_view_and_many_runs(cuda):
    """A plane view that starts one word in (4-byte aligned only), and
    more runs than the grid's 65,535 rows of blocks."""
    base = bitops.bernoulli_packed(0.3, (3001, 9), seed=3, device=cuda)
    view = base.reshape(-1)[1:1 + 3000 * 9].view(3000, 9)
    assert torch.equal(bitops.per_trial_counts(view),
                       bitops._per_trial_counts_plain(view))
    tall = bitops.bernoulli_packed(0.5, (70_000_000, 1), seed=8,
                                   device=cuda)
    assert torch.equal(bitops.per_trial_counts(tall),
                       bitops._per_trial_counts_plain(tall))
