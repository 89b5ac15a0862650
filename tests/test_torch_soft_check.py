"""Kernel C (the soft check pass, ``csrc/soft_check.cu``) on the CPU: its
int8 lane path and its launch geometry.

The int8 instantiation runs JAX's ``_check_update_minsum(mag_cap=127)`` on
packed lanes, four trials a 32-bit word.  A numpy model of that path, word
by word as the kernel runs it (S2's lane steps, tests/test_torch_qc_soft.py,
plus kernel C's own: a table per code, per-code ``active`` columns and
syndrome counts, padded sockets written 0), is held here bit for bit to
JAX's update on int16 planes and to the port's plain version, the oracle
the kernel is held to on the card (tests/test_torch_cuda.py).

The geometry (``soft_check_geometry``: trials a thread and the column
tile) is a pure function, checked at the main paths' shapes and on ragged
ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.ops.soft_bp import _check_update_minsum
from iib_project_ldpc_codes_tpu_torch import kernels
from iib_project_ldpc_codes_tpu_torch.ops import soft_bp
from test_torch_qc_soft import _EDGE_VALUES, _packed_check

#: torch.cuda.get_device_properties(0).L2_cache_size on an H100 (50 MiB)
L2_H100 = 52_428_800


# ---------------------------------------------------------------------------
# The int8 lane path
# ---------------------------------------------------------------------------

def _lane_model(pm, msg, table, active, pad_var):
    """soft_check_kernel_int8 in numpy: pm int8[n_rows, B], msg int8[rows *
    dc, B], table int[C, rows, dc], active int[C] -> (new msg, unsat[C]).
    Every word of a code's columns runs S2's lane steps; a padded socket's
    word is written 0 after its r' took part in the minima; a stopped
    code's words are left as they were."""
    num, rows, dc = table.shape
    words = pm.view(np.uint32)
    msg_w = msg.view(np.uint32).reshape(rows, dc, -1)
    out = msg_w.copy()
    wpc = words.shape[1] // num
    unsat = np.zeros(num, np.int64)
    for g in range(num):
        if not active[g]:
            continue
        cols = slice(g * wpc, (g + 1) * wpc)
        p = np.stack([words[table[g, :, j], cols] for j in range(dc)])
        m = np.stack([msg_w[:, j, cols] for j in range(dc)])
        new, unsat[g] = _packed_check(p.reshape(dc, -1), m.reshape(dc, -1))
        new = new.reshape(dc, rows, wpc)
        new[(table[g] == pad_var).T] = 0
        out[:, :, cols] = new.transpose(1, 0, 2)
    return out.reshape(rows * dc, -1).view(np.int8), unsat


def _jax_check(pm, msg, table, active, pad_var):
    """JAX's check side (ops/soft_bp.py _soft_iteration, :200-223) per
    code on int16 planes, JAX's chk_sock_mask on padded sockets; a stopped
    code's messages unchanged (the vmapped decode's per-code stop)."""
    num, rows, dc = table.shape
    cpc = pm.shape[1] // num
    out = msg.reshape(rows, dc, -1).copy()
    unsat = np.zeros(num, np.int64)
    for g in range(num):
        if not active[g]:
            continue
        cols = slice(g * cpc, (g + 1) * cpc)
        post = [pm[table[g, :, j], cols] for j in range(dc)]
        unsat[g] = int(np.bitwise_xor.reduce(np.stack(post) < 0, 0).sum())
        r = [jnp.asarray(p.astype(np.int16) - out[:, j, cols].astype(np.int16))
             for j, p in enumerate(post)]
        new = [np.asarray(o) for o in _check_update_minsum(r, 1.0, 0.0,
                                                           mag_cap=127)]
        for j, o in enumerate(new):
            assert o.dtype == np.int16 and np.abs(o).max() <= 127
            out[:, j, cols] = np.where((table[g, :, j] != pad_var)[:, None],
                                       o, 0)
    return out.reshape(rows * dc, -1), unsat


def _hold(pm, msg, table, active, pad_var):
    """The lane model == JAX == the port's plain version, messages and
    per-code syndrome counts."""
    got, bad = _lane_model(pm, msg, table, active, pad_var)
    want, want_bad = _jax_check(pm, msg, table, active, pad_var)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bad, want_bad)
    plain = torch.from_numpy(msg.copy())
    unsat = torch.zeros(table.shape[0], dtype=torch.int32)
    soft_bp._soft_check_plain(
        torch.from_numpy(pm), plain, torch.from_numpy(table.astype(np.int32)),
        torch.from_numpy(active.astype(np.int32)), unsat, method="minsum",
        alpha=1.0, beta=0.0, pad_var=pad_var)
    np.testing.assert_array_equal(plain.numpy(), got)
    np.testing.assert_array_equal(unsat.numpy(), bad)
    return got


#: (p, m) pairs whose r = p - m reaches +254, -255, -127, 0, +-1 and +-128
#: (saturating to 127 / -128 on the lanes), so ties, zeros and saturated
#: magnitudes meet in every combination
_PAIRS = np.array([(127, -127), (-128, 127), (-127, 0), (0, 0), (1, 0),
                   (0, 1), (64, -64), (-1, 127)], np.int8)


def _codes_case(planes, dc, rng):
    """One check of degree dc whose trials are the columns of ``planes``
    int8[2, dc, T] (p and m per socket), split over four codes: code 0
    plain, code 1 with its last socket on the phantom row (pad_var = dc,
    holding the same values), code 2 stopped, code 3 with its sockets
    permuted."""
    num = 4
    trials = planes.shape[2]
    cols = -(-trials // (16 * num)) * 16 * num
    planes = np.pad(planes, ((0, 0), (0, 0), (0, cols - trials)))
    pm = np.concatenate([planes[0], planes[0][-1:]])             # [dc + 1, B]
    msg = planes[1].copy()                                       # rows = 1
    table = np.tile(np.arange(dc), (num, 1, 1))
    table[1, 0, -1] = dc
    table[3, 0] = rng.permutation(dc)
    active = np.array([1, 1, 0, 1])
    return pm, msg, table, active


@pytest.mark.parametrize("dc", range(2, 9))
def test_int8_lane_path_equals_jax_exhaustively(dc):
    """Every combination of the (p, m) pairs over the dc sockets (all 8
    pairs up to degree 5, the first 5 above): r meets saturation, ties at
    the minimum and all-zero extrinsics; with a padded socket, a stopped
    code and permuted sockets."""
    pairs = _PAIRS if dc <= 5 else _PAIRS[[0, 1, 3, 4, 5]]
    idx = np.indices((len(pairs),) * dc).reshape(dc, -1)
    planes = np.moveaxis(pairs[idx], 2, 0)                       # [2, dc, T]
    pm, msg, table, active = _codes_case(planes, dc,
                                         np.random.default_rng(dc))
    got = _hold(pm, msg, table, active, pad_var=dc)
    assert np.array_equal(got[:, 2 * pm.shape[1] // 4:3 * pm.shape[1] // 4],
                          msg[:, 2 * pm.shape[1] // 4:3 * pm.shape[1] // 4])
    assert not got[-1, pm.shape[1] // 4:2 * pm.shape[1] // 4].any()


@pytest.mark.parametrize("dc", range(2, 9))
@pytest.mark.parametrize("cpc", [16, 32])
def test_int8_lane_path_equals_jax_on_draws(dc, cpc):
    """Seeded draws over a batch of six codes of 40 checks: random tables
    (some sockets on the phantom row n_rows - 1), planes over the whole
    int8 range (-128 included) and half from the edge values, two codes
    stopped."""
    rng = np.random.default_rng(100 * dc + cpc)
    num, rows, n_rows = 6, 40, 61
    pad_var = n_rows - 1
    cols = num * cpc
    full = rng.integers(-128, 128, size=(n_rows + rows * dc, cols))
    edge = rng.choice(_EDGE_VALUES, size=full.shape)
    planes = np.where(rng.random(full.shape) < 0.5, full, edge) \
        .astype(np.int8)
    pm, msg = planes[:n_rows].copy(), planes[n_rows:].copy()
    table = rng.integers(0, n_rows - 1, size=(num, rows, dc))
    table[rng.random(table.shape) < 0.1] = pad_var
    active = np.array([1, 0, 1, 1, 0, 1])
    got = _hold(pm, msg, table, active, pad_var)
    for g in np.flatnonzero(active == 0):
        cols_g = slice(g * cpc, (g + 1) * cpc)
        assert np.array_equal(got[:, cols_g], msg[:, cols_g])


# ---------------------------------------------------------------------------
# The launch geometry
# ---------------------------------------------------------------------------

GEOMETRY_SHAPES = [
    (8192, 24_576, 768), (8192, 24_576, 1), (10_008, 24_576, 1),
    (1_000_008, 1536, 1),
    # ragged codes: B / C = 4, 8, 12, 20
    (8192, 4 * 768, 768), (8192, 8 * 768, 768), (8193, 12 * 768, 768),
    (8192, 20 * 768, 768), (300, 4 * 6, 6), (300, 12 * 6, 6),
    (1_000_008, 20 * 64, 64), (40_000, 24_576 + 96, 1)]


@pytest.mark.parametrize("n_rows, cols, num", GEOMETRY_SHAPES)
@pytest.mark.parametrize("elem", [4, 2, 1])
@pytest.mark.parametrize("dc", [1, 2, 3, 6, 8, 9, 32])
def test_geometry_vectors_and_tiles(n_rows, cols, num, elem, dc):
    cpc = cols // num
    vec, tile = soft_bp.soft_check_geometry(elem, cols, cpc, dc, n_rows,
                                            L2_H100)
    nbytes = vec * elem
    assert nbytes in (16, 8, 4)
    # a vector never spans two codes: the width divides a code's columns
    assert cpc % vec == 0
    starts = np.arange(0, cols, vec)
    assert np.array_equal(starts // cpc, (starts + vec - 1) // cpc)
    # the widest that does, and 4 bytes outside the exact degrees 2..8
    if not 2 <= dc <= 8:
        assert nbytes == 4
    else:
        assert all(cpc % (b // elem) for b in (16, 8) if b > nbytes)
    # the tile: whole vectors, whole codes where C > 1, within the budget
    # unless even its unit is over it (then one tile of every column)
    assert 0 < tile <= cols and tile % vec == 0
    if num > 1:
        assert tile % cpc == 0
    unit = cpc if num > 1 else 32 * vec
    budget = int(L2_H100 * soft_bp._CHECK_L2_SHARE)
    if n_rows * tile * elem > budget:
        assert tile == cols and n_rows * unit * elem > budget
    # and the largest such tile
    assert tile == cols or n_rows * (tile + unit) * elem > budget


@pytest.mark.parametrize("elem, num, want", [
    (4, 768, (4, 320)), (2, 768, (8, 640)), (1, 768, (16, 1280)),
    (4, 1, (4, 256)), (2, 1, (8, 512)), (1, 1, (16, 1024))])
def test_geometry_at_the_headline_shape(elem, num, want):
    """n = 8192, (3,6), 24,576 trials: 16 bytes a thread; tiles of 10 / 20
    / 40 codes of 32 (f32 / bf16 / int8) or of two runs of a warp's 512
    bytes at one code, each a pm slice of at most 20% of the H100's L2."""
    assert soft_bp.soft_check_geometry(elem, 24_576, 24_576 // num, 6, 8192,
                                       L2_H100) == want


def test_geometry_at_n_1e6_is_one_tile():
    """n ~ 10^6 (the QC decodes on expand()): no tile of a warp's run fits
    the budget, so the launch keeps every column in one tile."""
    for elem, cols in ((4, 768), (1, 1536)):
        vec, tile = soft_bp.soft_check_geometry(elem, cols, cols, 6,
                                                1_000_008, L2_H100)
        assert (vec * elem, tile) == (16, cols)


@pytest.mark.parametrize("align, want", [(16, 4), (8, 2), (4, 1)])
def test_geometry_follows_the_planes_alignment(align, want):
    assert soft_bp.soft_check_geometry(4, 1024, 32, 6, 100, L2_H100,
                                       align)[0] == want


def test_geometry_refuses_planes_below_4_byte_alignment():
    with pytest.raises(ValueError, match="aligned"):
        soft_bp.soft_check_geometry(1, 1024, 32, 6, 100, L2_H100, 2)


@pytest.mark.parametrize("elem, cols, cpc, n_rows, want", [
    (4, 1024, 1024, 0, (4, 1024)), (1, 1024, 32, 0, (16, 1024)),
    (4, 0, 0, 8192, (4, 0)), (1, 0, 0, 0, (16, 0))])
def test_geometry_of_empty_planes(elem, cols, cpc, n_rows, want):
    """No rows or no columns: a slice of 0 bytes, one tile of every column
    (the wrapper launches nothing for such planes)."""
    assert soft_bp.soft_check_geometry(elem, cols, cpc, 6, n_rows,
                                       L2_H100) == want


@pytest.mark.parametrize("rows, cols", [(0, 64), (5, 0), (0, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_soft_check_of_empty_planes_is_a_no_op(rows, cols, dtype):
    num, dc, n_rows = 2, 6, 7
    table = torch.zeros((num, rows, dc), dtype=torch.int32)
    pm = torch.ones((n_rows, cols), dtype=dtype)
    msg = torch.full((rows * dc, cols), 3, dtype=dtype)
    active = torch.ones(num, dtype=torch.int32)
    unsat = torch.zeros(num, dtype=torch.int32)
    before = soft_bp.soft_check.launches
    soft_bp.soft_check(pm, msg, table, active, unsat, method="minsum")
    assert soft_bp.soft_check.launches == before
    assert torch.equal(unsat, torch.zeros(num, dtype=torch.int32))
    assert torch.equal(msg, torch.full((rows * dc, cols), 3, dtype=dtype))


def test_alignment_of_views():
    plane = torch.zeros(64, dtype=torch.int8)
    assert kernels.alignment(plane) == 16
    assert kernels.alignment(plane[4:], plane) == 4
    assert kernels.alignment(plane[8:]) == 8
