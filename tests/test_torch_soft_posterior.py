"""Kernel B (the soft variable pass, ``csrc/soft_posterior.cu``) on the CPU:
its int8 lane path, its width rule, and the per-code counts the decode loop
now asks of it.

The int8 instantiation sums the posterior on packed lanes, four trials a
32-bit word (``soft.cuh::Sum8``): each byte sign-extended into a 16-bit
half by ``prmt``, the halves summed with ``__vadd2``, saturated at +-127 by
``__vmins2`` / ``__vmaxs2``, packed back by ``prmt``, the decisions read
off bit 15 of each half.  A numpy model of those instructions, with the
kernel's own ``prmt`` selectors, is held here bit for bit to JAX's
``_posterior`` in int16 plus its clip and to the port's plain version, the
oracle the kernel is held to on the card (tests/test_torch_cuda.py).

``soft_posterior_vector`` (trials a thread) is a pure function, checked on
a table of shapes.  ``_soft_loop`` passes kernel B counts of one per code
where it records totals and one per trial where it returns trajectories;
both give JAX's decode bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code, sample_codes as jax_sample_codes)
from iib_project_ldpc_codes_tpu.ops import soft_bp as jsb
from iib_project_ldpc_codes_tpu_torch.models.code import (code_from_numpy,
                                                          codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.ops import soft_bp


# ---------------------------------------------------------------------------
# A numpy model of the packed int8 lanes
# ---------------------------------------------------------------------------

def _prmt(a, b, selector):
    """PTX prmt.b32 (default mode) on uint32 arrays: bytes 0-3 of ``a`` and
    4-7 of ``b``; selector nibble i picks result byte i, its bit 3
    replicating that byte's sign bit."""
    src = [(a >> (8 * k)) & 0xFF for k in range(4)] + \
        [(b >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        nib = (selector >> (4 * i)) & 0xF
        byte = src[nib & 7]
        if nib & 8:
            byte = np.where(byte & 0x80, np.uint32(0xFF), np.uint32(0))
        out |= byte << np.uint32(8 * i)
    return out


def _halves(x):
    """The two signed 16-bit halves of uint32 words, as int64."""
    lo = (x & 0xFFFF).astype(np.int64)
    hi = (x >> 16).astype(np.int64)
    return np.where(lo >= 2 ** 15, lo - 2 ** 16, lo), \
        np.where(hi >= 2 ** 15, hi - 2 ** 16, hi)


def _join(lo, hi):
    return ((lo & 0xFFFF) | ((hi & 0xFFFF) << 16)).astype(np.uint32)


def _vadd2(a, b):
    """__vadd2: two 16-bit adds, each modulo 2^16."""
    (alo, ahi), (blo, bhi) = _halves(a), _halves(b)
    return _join(alo + blo, ahi + bhi)


def _vmins2(a, b):
    (alo, ahi), (blo, bhi) = _halves(a), _halves(b)
    return _join(np.minimum(alo, blo), np.minimum(ahi, bhi))


def _vmaxs2(a, b):
    (alo, ahi), (blo, bhi) = _halves(a), _halves(b)
    return _join(np.maximum(alo, blo), np.maximum(ahi, bhi))


class _Sum8:
    """soft.cuh Sum8 on arrays of words, instruction for instruction."""

    def __init__(self, x):
        self.lo, self.hi = self._widen(x)

    @staticmethod
    def _widen(x):
        zero = np.zeros_like(x)
        return _prmt(x, zero, 0x9180), _prmt(x, zero, 0xB3A2)

    def add(self, x, where=True):
        lo, hi = self._widen(x)
        self.lo = np.where(where, _vadd2(self.lo, lo), self.lo)
        self.hi = np.where(where, _vadd2(self.hi, hi), self.hi)

    def clipped(self):
        clip = lambda h: _vmaxs2(_vmins2(h, np.uint32(0x007F007F)),  # noqa
                                 np.uint32(0xFF81FF81))
        return _prmt(clip(self.lo), clip(self.hi), 0x6420)

    def negative(self):
        lo, hi = self.lo, self.hi
        return ((lo >> 15) & 1) | ((lo >> 30) & 2) | ((hi >> 13) & 4) | \
            ((hi >> 28) & 8)

    def values(self):
        """int64[..., 4]: the four trials' sums of each word."""
        (a, b), (c, d) = _halves(self.lo), _halves(self.hi)
        return np.stack([a, b, c, d], -1)


def _lane_model(llr0, msg, table, active, pad_pos):
    """soft_posterior_kernel_int8 in numpy: llr0 int8[n_rows, B], msg
    int8[rows, B], table int[C, n_rows, dv], active int[C] -> (pm int8
    plane, sums int64[n_rows, B], decisions bool[n_rows, B]); the columns
    of a stopped code keep pm's zeros and sums of 0."""
    num, n_rows, dv = table.shape
    cols = llr0.shape[1]
    cpc = cols // num
    pm = np.zeros((n_rows, cols), np.int8)
    sums = np.zeros((n_rows, cols), np.int64)
    neg = np.zeros((n_rows, cols), bool)
    words_l = np.ascontiguousarray(llr0).view(np.uint32)
    words_m = np.ascontiguousarray(msg).view(np.uint32)
    for g in np.flatnonzero(active):
        w = slice(g * cpc // 4, (g + 1) * cpc // 4)
        acc = _Sum8(words_l[:, w])
        for p in range(dv):
            rows = table[g, :, p]
            live = (rows < pad_pos)[:, None]
            acc.add(words_m[np.where(rows < pad_pos, rows, 0), w], live)
        cols_g = slice(g * cpc, (g + 1) * cpc)
        pm[:, cols_g] = acc.clipped().view(np.int8).reshape(n_rows, cpc)
        sums[:, cols_g] = acc.values().reshape(n_rows, cpc)
        bits = acc.negative()
        neg[:, cols_g] = ((bits[..., None] >> np.arange(4)) & 1) \
            .reshape(n_rows, cpc).astype(bool)
    return pm, sums, neg


class _Dv:
    """What JAX's _posterior reads of a code: its degree."""

    def __init__(self, dv):
        self.dv = dv


def _hold(llr0, msg, table, active, pad_pos):
    """The lane model == JAX's int16 posterior and clip == the port's
    plain version (pm, per-trial and per-code counts, final posterior and
    decisions)."""
    num, n_rows, dv = table.shape
    cpc = llr0.shape[1] // num
    pm, sums, neg = _lane_model(llr0, msg, table, active, pad_pos)
    for g in np.flatnonzero(active):
        cols = slice(g * cpc, (g + 1) * cpc)
        post = np.asarray(jsb._posterior(
            _Dv(dv), jnp.asarray(llr0[:, cols]), jnp.asarray(msg[:, cols]),
            [jnp.asarray(table[g, :, p]) for p in range(dv)], jnp.int16))
        assert post.dtype == np.int16
        np.testing.assert_array_equal(sums[:, cols], post)
        np.testing.assert_array_equal(
            pm[:, cols], np.clip(post, -127, 127).astype(np.int8))
        np.testing.assert_array_equal(neg[:, cols], post < 0)
    on = np.repeat(active.astype(bool), cpc)
    want_counts = (neg & on).sum(0)
    for width in (llr0.shape[1], num):
        plain_pm = torch.zeros(llr0.shape, dtype=torch.int8)
        counts = torch.zeros(width, dtype=torch.int32)
        post = torch.zeros(llr0.shape)
        hard = torch.zeros(llr0.shape, dtype=torch.bool)
        soft_bp._soft_posterior_plain(
            torch.from_numpy(llr0), torch.from_numpy(msg),
            torch.from_numpy(table.astype(np.int32)),
            torch.from_numpy(active.astype(np.int32)), plain_pm, counts,
            pad_pos=pad_pos, post=post, hard=hard, int8_scale=4.0)
        np.testing.assert_array_equal(plain_pm.numpy(), pm)
        np.testing.assert_array_equal(post.numpy()[:, on],
                                      (sums / np.float32(4.0))[:, on])
        np.testing.assert_array_equal(hard.numpy(), neg & on)
        want = want_counts if width != num else \
            want_counts.reshape(num, cpc).sum(1)
        np.testing.assert_array_equal(counts.numpy(), want)
    return sums


#: the extremes of the int8 planes the decoder stores
_EXTREMES = np.array([127, -127, 0, -1], np.int8)


@pytest.mark.parametrize("dv", range(2, 9))
def test_int8_lanes_equal_jax_exhaustively(dv):
    """Every combination of the extremes over the channel LLR and the dv
    messages (4^(dv+1) trials): sums up to +-(dv+1) * 127, saturating
    both ways.  Variable 0 reads sockets 0 .. dv-1; variable 1 the same
    permuted with its last on a padded row; code 1 of two is stopped."""
    rng = np.random.default_rng(dv)
    idx = np.indices((4,) * (dv + 1)).reshape(dv + 1, -1)
    combos = _EXTREMES[idx]                                # [dv+1, T]
    cpc = -(-combos.shape[1] // 16) * 16
    combos = np.pad(combos, ((0, 0), (0, cpc - combos.shape[1])))
    llr0 = np.tile(combos[:1], (2, 2))                     # [2, 2 cpc]
    msg = np.concatenate([np.tile(combos[1:], (1, 2)),
                          np.zeros((1, 2 * cpc), np.int8)])
    pad_pos = dv
    first = np.arange(dv)
    second = rng.permutation(dv)
    second[-1] = pad_pos
    table = np.tile(np.stack([first, second]), (2, 1, 1))
    sums = _hold(llr0, msg, table, np.array([1, 0]), pad_pos)
    assert np.abs(sums).max() == (dv + 1) * 127


@pytest.mark.parametrize("dv", [2, 3, 4, 6, 8, 12, 32])
@pytest.mark.parametrize("cpc", [16, 32])
def test_int8_lanes_equal_jax_on_draws(dv, cpc):
    """Seeded draws over a batch of five codes: random tables with a tenth
    of the sockets on padded rows (their messages 0), planes over the whole
    int8 range (-128 included), two codes stopped."""
    rng = np.random.default_rng(10 * dv + cpc)
    num, n_rows = 5, 40
    rows = n_rows * dv + 5
    pad_pos = rows - 5
    llr0 = rng.integers(-128, 128, (n_rows, num * cpc)).astype(np.int8)
    msg = rng.integers(-128, 128, (rows, num * cpc)).astype(np.int8)
    msg[pad_pos:] = 0
    table = rng.integers(0, pad_pos, (num, n_rows, dv))
    pad = rng.random(table.shape) < 0.1
    table[pad] = rng.integers(pad_pos, rows, int(pad.sum()))
    _hold(llr0, msg, table, np.array([1, 0, 1, 1, 0]), pad_pos)


def test_sum8_value_and_negative_of_one_word():
    """Bytes -128, -1, 0, 127 in trial order: the halves, the sign bits
    and the packed clip."""
    word = np.array([-128, -1, 0, 127], np.int8).view(np.uint32)
    acc = _Sum8(word)
    assert acc.values().tolist() == [[-128, -1, 0, 127]]
    assert int(acc.negative()[0]) == 0b0011
    acc.add(word)
    assert acc.values().tolist() == [[-256, -2, 0, 254]]
    assert acc.clipped().view(np.int8).tolist() == [-127, -2, 0, 127]


# ---------------------------------------------------------------------------
# The width rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("elem, cpc, align, want", [
    # float32: 16 bytes wherever aligned (every code has 4k trials)
    (4, 4, 16, 4), (4, 32, 16, 4), (4, 32, 8, 2), (4, 8, 4, 1),
    # bfloat16: 8 trials need 8 | cpc
    (2, 4, 16, 4), (2, 8, 16, 8), (2, 32, 16, 8), (2, 32, 8, 4),
    (2, 8, 4, 2),
    # int8: 16 | cpc for 16 bytes, 8 | cpc for 8
    (1, 4, 16, 4), (1, 8, 16, 8), (1, 32, 16, 16), (1, 32, 8, 8),
    (1, 32, 4, 4), (1, 12, 16, 4), (1, 1056, 16, 16)])
def test_width_rule(elem, cpc, align, want):
    assert soft_bp.soft_posterior_vector(elem, cpc, 3,
                                         [(align, elem)]) == want


@pytest.mark.parametrize("dv, want", [(1, 4), (2, 16), (8, 16), (9, 4),
                                      (32, 4)])
def test_width_rule_outside_the_exact_degrees(dv, want):
    assert soft_bp.soft_posterior_vector(1, 32, dv, [(16, 1)]) == want


def test_width_rule_holds_each_plane_to_its_own_bytes():
    """bfloat16 messages beside a float32 LLR plane: 8 trials move 32
    bytes of LLRs (16-byte accesses), so an LLR plane aligned to 8 bytes
    allows 2 trials a thread; the int8 final launch's float32 posterior
    moves 16 bytes for every 4 trials, so it must be 16-byte aligned."""
    assert soft_bp.soft_posterior_vector(2, 32, 3, [(16, 2), (16, 4)]) == 8
    assert soft_bp.soft_posterior_vector(2, 32, 3, [(16, 2), (8, 4)]) == 2
    assert soft_bp.soft_posterior_vector(1, 32, 3, [(16, 1), (16, 4)]) == 16
    assert soft_bp.soft_posterior_vector(1, 32, 3, [(16, 1), (4, 1)]) == 4
    with pytest.raises(ValueError, match="at least 4 bytes"):
        soft_bp.soft_posterior_vector(1, 32, 3, [(16, 1), (8, 4)])


@pytest.mark.parametrize("elem, want", [(4, 4), (2, 8), (1, 16)])
def test_width_rule_of_empty_planes(elem, want):
    """No columns (cpc 0) and no planes: nothing constrains the width (the
    wrapper launches nothing for such planes)."""
    assert soft_bp.soft_posterior_vector(elem, 0, 3, []) == want
    assert soft_bp.soft_posterior_vector(elem, 0, 3, ()) == want


@pytest.mark.parametrize("elem, cpc, planes", [
    (1, 32, [(2, 1)]), (2, 32, [(2, 2)]), (1, 2, [(16, 1)]),
    (2, 1, [(16, 2)])])
def test_width_rule_refuses_what_no_width_takes(elem, cpc, planes):
    with pytest.raises(ValueError, match="at least 4 bytes"):
        soft_bp.soft_posterior_vector(elem, cpc, 3, planes)


# ---------------------------------------------------------------------------
# The wrapper's contract
# ---------------------------------------------------------------------------

def _pass_inputs(num=4, cpc=8, dtype=torch.float32):
    rng = np.random.default_rng(0)
    n_rows, dv, rows = 12, 3, 40
    table = torch.from_numpy(rng.integers(0, rows, (num, n_rows, dv))
                             .astype(np.int32))
    llr0 = torch.from_numpy(rng.normal(0, 3, (n_rows, num * cpc))
                            .astype(np.float32))
    msg = torch.from_numpy(rng.normal(0, 3, (rows, num * cpc))
                           .astype(np.float32)).to(dtype)
    if dtype == torch.int8:
        llr0 = soft_bp._quantise(llr0, 4.0)
    pm = torch.zeros(llr0.shape, dtype=dtype)
    active = torch.tensor([1, 0, 1, 1][:num], dtype=torch.int32)
    return llr0, msg, table, active, pm


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_counts_of_width_b_or_c(dtype):
    """Counts per trial (int32[B]) and per code (int32[C]) of one pass are
    the same errors: the per-code counts are the per-trial ones summed
    over each code's columns; a stopped code counts nothing."""
    llr0, msg, table, active, pm = _pass_inputs(dtype=dtype)
    per_trial = torch.zeros(32, dtype=torch.int32)
    per_code = torch.full((4,), 5, dtype=torch.int32)
    soft_bp.soft_posterior(llr0, msg, table, active, pm, per_trial,
                           pad_pos=40)
    soft_bp.soft_posterior(llr0, msg, table, active, pm.clone(), per_code,
                           pad_pos=40)
    assert per_code.tolist() == \
        (per_trial.reshape(4, 8).sum(1) + 5).tolist()
    assert int(per_trial[8:16].sum()) == 0 and int(per_trial.sum()) > 0


@pytest.mark.parametrize("counts", [
    torch.zeros(1, dtype=torch.int32), torch.zeros(33, dtype=torch.int32),
    torch.zeros(8, dtype=torch.int32), torch.zeros(4, dtype=torch.int64),
    torch.zeros((4, 1), dtype=torch.int32),
    torch.zeros(64, dtype=torch.int32)[::2]])
def test_counts_of_any_other_width_are_refused(counts):
    llr0, msg, table, active, pm = _pass_inputs()
    with pytest.raises(ValueError, match="counts must be"):
        soft_bp.soft_posterior(llr0, msg, table, active, pm, counts,
                               pad_pos=40)


def test_one_code_takes_counts_of_width_1():
    llr0, msg, table, _, pm = _pass_inputs(num=1, cpc=32)
    one = torch.zeros(1, dtype=torch.int32)
    per_trial = torch.zeros(32, dtype=torch.int32)
    active = torch.ones(1, dtype=torch.int32)
    soft_bp.soft_posterior(llr0, msg, table[0], active, pm, one, pad_pos=40)
    soft_bp.soft_posterior(llr0, msg, table[0], active, pm, per_trial,
                           pad_pos=40)
    assert int(one) == int(per_trial.sum()) > 0


def test_post_and_hard_must_be_contiguous():
    llr0, msg, table, active, pm = _pass_inputs()
    post = torch.zeros((32, 12)).t()
    with pytest.raises(ValueError, match="contiguous"):
        soft_bp.soft_posterior(llr0, msg, table, active, pm,
                               torch.zeros(4, dtype=torch.int32), pad_pos=40,
                               post=post,
                               hard=torch.zeros((12, 32), dtype=torch.bool))


# ---------------------------------------------------------------------------
# The decode loop: per-code counts against per-trial counts and JAX
# ---------------------------------------------------------------------------

def _llr(n, cols, sigma, seed):
    z = np.random.default_rng(seed).standard_normal((n, cols))
    return (2.0 * (1.0 + sigma * z) / sigma ** 2).astype(np.float32)


def _spy(widths):
    """Kernel B's plain version, noting the count width of every call."""
    def posterior(llr0, msg, table, active, pm, counts, **kw):
        widths.append(counts.shape[0])
        soft_bp._soft_posterior_plain(llr0, msg, table, active, pm, counts,
                                      **kw)
    return posterior


@pytest.mark.parametrize("num", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_loop_counts_per_code_equal_per_trial_and_jax(num, dtype):
    """Min-sum (float32) and int8 min-sum on one code and on a batch of
    four, whose codes stop on different rounds: the loop passes counts of
    width C for totals and B for trajectories, and both give JAX's
    error_totals, iterations and per-code iterations (and traj) bit for
    bit."""
    n, cpc, iters = 240, 32, 25
    tdt = {"float32": torch.float32, "int8": torch.int8}[dtype]
    jdt = {"float32": jnp.float32, "int8": jnp.int8}[dtype]
    sigmas = (0.45, 0.55, 0.62, 0.85)[:num] if num > 1 else (0.7,)
    llrs = [_llr(n, cpc, s, seed=20 + g) for g, s in enumerate(sigmas)]
    llr = torch.from_numpy(np.concatenate(llrs, axis=1))
    if num > 1:
        jcodes = jax_sample_codes(jax.random.key(3), num, n, 3, 6)
        code = codes_from_numpy(np.asarray(jcodes.chk_to_var), n, 3, 6)
        jcode_of = lambda g: jax.tree.map(lambda x: x[g], jcodes)  # noqa
    else:
        jcode = jax_sample_code(jax.random.key(3), n, 3, 6)
        code = code_from_numpy(np.asarray(jcode.chk_to_var), n, 3, 6)
        jcode_of = lambda g: jcode  # noqa: E731
    graph = soft_bp._graph(code)
    results = {}
    for record in ("total", "per_trial"):
        widths = []
        results[record] = soft_bp._soft_loop(
            graph, llr, iters, "minsum", 1.0, 0.0, tdt, 4.0, record,
            (_spy(widths), soft_bp._soft_check_plain), None)
        assert set(widths) == {num if record == "total" else num * cpc}
    total, trial = results["total"], results["per_trial"]
    assert torch.equal(total.error_totals, trial.error_totals)
    assert torch.equal(total.code_iterations, trial.code_iterations)
    assert total.iterations == trial.iterations
    assert total.traj is None
    assert torch.equal(trial.traj.sum(1, dtype=torch.int32),
                       trial.error_totals)
    totals, its = np.zeros(iters + 1, np.int64), []
    for g in range(num):
        want = jsb.soft_bp_decode(jcode_of(g), jnp.asarray(llrs[g]), iters,
                                  method="minsum", msg_dtype=jdt,
                                  record="per_trial")
        cols = slice(g * cpc, (g + 1) * cpc)
        np.testing.assert_array_equal(trial.traj[:, cols].numpy(),
                                      np.asarray(want.traj))
        totals += np.asarray(want.error_totals)
        its.append(int(want.iterations))
    if num > 1:
        assert len(set(its)) > 1
    assert total.code_iterations.tolist() == its
    assert total.iterations == max(its)
    assert total.error_totals.tolist() == totals.tolist()
