"""Q1 and Q2, the QC BEC round, on the CPU: their layout and launch rule,
their column-tile grid and a numpy model of their per-item arithmetic.

``qc_bec_layout`` (the words of a column tile of the decodes' tile-major
planes and the words a thread of ``csrc/qc_check_exactly_one.cu`` and
``csrc/qc_variable_or.cu`` moves) on a table of shapes, the conditions
the kernels hold a launch to against the sources; ``to_tiles`` /
``from_tiles``; the tiled grid's cover of a plane (tile edges, a W that
no tile width divides: one tile), the tile as the slowest coordinate,
warps on contiguous words, and the rotation by s * tile that stands for
the circulant index across the z + s = Z wrap; and a numpy model of the
two kernels on tile-major planes -- the socket loops, Q2's all-known
skip, its erasure count -- held bit for bit against
the plain versions ``_qc_check_exactly_one_plain`` /
``_qc_variable_or_plain``, the wrappers' CPU path with the same layout,
and JAX's one round ``_qc_iteration_allzero`` / ``_qc_iteration``, round
after round.  Bases: the regular (3,6) nb = 12 base, the irregular nb =
24 BEC base (blocks of degree 2 and 4), two hand-built bases with blocks
of degree 1, and an nb = 20 base of check degree 10.  The decodes in
the tiled layout against the plain decodes and JAX's.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import qc as jqc_mod
from iib_project_ldpc_codes_tpu.ops import qc_bp as jqc_bp
from iib_project_ldpc_codes_tpu_torch.kernels.build import SOURCE_DIR
from iib_project_ldpc_codes_tpu_torch.models import qc
from iib_project_ldpc_codes_tpu_torch.ops import qc_bp

KTHREADS = 256                    # csrc/common.cuh kThreads
LAM_BEC, RHO6 = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]
# tests/test_torch_qc.py's hand-built irregular bases: (base, shifts, nb)
HAND = {"degree_one": ([[0, 1, 2], [0, 1, 3]], [[0, 1, 2], [3, 0, 1]], 4),
        "uniform_clamped": ([[0, 1, 2, 3], [0, 2, 4, 5], [1, 3, 4, 5]],
                            [[0, 1, 2, 3], [1, 2, 3, 0], [2, 3, 0, 1]], 6)}
BASES = ("regular", "irregular", "degree_one", "uniform_clamped", "dc10")
FULL = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# The launch rule
# ---------------------------------------------------------------------------

H100_L2 = 50 * 2 ** 20


@pytest.mark.parametrize("rows, words, align, cache, want", [
    (10_008, 768, 16, H100_L2, (4, 768)),     # n ~ 10^4: fits L2, row-major
    (1_000_008, 48, 16, H100_L2, (4, 4)),     # n ~ 10^6: 12 tiles
    (1_000_008, 48, 8, H100_L2, (1, 4)),      # a plane 8 bytes off
    (100_008, 480, 16, H100_L2, (4, 4)),      # n ~ 10^5
    (10_008, 768, 16, 0, (4, 4)),             # any plane set over the cache
    (10_008, 768, 8, 0, (1, 4)),
    (10_008, 768, 4, H100_L2, (1, 768)),
    (300, 36, 16, 0, (4, 4)),
    (300, 36, 4, 0, (1, 4)),
    (300, 70, 16, 0, (1, 70)),                # no tile divides W: row-major
    (300, 70, 4, 0, (1, 70)),
    (300, 1, 16, 0, (1, 1)),
    (300, 1, 4, 0, (1, 1)),
    (300, 4, 16, 0, (4, 4)),                  # one tile of W words
    (300, 3, 16, 0, (1, 3)),
])
def test_bec_layout_rule(rows, words, align, cache, want):
    vec, tile = qc_bp.qc_bec_layout(rows, words, align, cache)
    assert (vec, tile) == want
    # what the kernels hold a launch to (csrc/qc.cuh tiles_fit)
    assert words % tile == 0 and tile % vec == 0


def test_layout_constants_match_the_kernel_source():
    """The block size is the kernels'; both entry points hold a launch to a
    tile dividing W, N dividing the tile, and N = 4 only on 16-byte aligned
    planes with the tile a multiple of 4."""
    header = (SOURCE_DIR / "qc.cuh").read_text()
    assert "words % tile == 0 && tile % vec == 0" in header
    common = (SOURCE_DIR / "common.cuh").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);",
                         common).group(1)) == KTHREADS
    for name in ("qc_check_exactly_one.cu", "qc_variable_or.cu"):
        src = (SOURCE_DIR / name).read_text()
        assert "ldpc::qc::tiles_fit(lift, words, tile, vec)" in src
        assert re.search(r"vec == 4 && ldpc::qc::vector_ok\(tile,", src)


@pytest.mark.parametrize("rows, words, tile", [(5, 12, 4), (7, 48, 4),
                                               (3, 8, 8), (9, 70, 70),
                                               (1, 6, 2)])
def test_tiles_layout(rows, words, tile):
    planes = torch.arange(rows * words, dtype=torch.int32).view(rows, words)
    tiled = qc_bp.to_tiles(planes, tile)
    assert tiled.shape == planes.shape and tiled.is_contiguous()
    flat = tiled.view(-1).numpy()
    r, w = np.meshgrid(np.arange(rows), np.arange(words), indexing="ij")
    # row r, word w at (t * R + r) * tile + w % tile, t = w // tile
    at = ((w // tile) * rows + r) * tile + w % tile
    assert np.array_equal(flat[at], planes.numpy())
    assert torch.equal(qc_bp.from_tiles(tiled, tile), planes)
    assert qc_bp.to_tiles(planes, None) is planes


# ---------------------------------------------------------------------------
# The column-tile grid and the rotation
# ---------------------------------------------------------------------------

def _tile_grid(planes, Z, words, vec, tile):
    """csrc/qc.cuh tile_grid and tile_item for every thread of the 1-D grid,
    in launch order: (tile, plane, o, live), each int64[blocks, kThreads]
    (o = z * tile + w, the item's offset in its plane's [Z, tile] slab)."""
    groups = tile // vec
    blocks = -(-(Z * groups) // KTHREADS)
    bx = np.arange(words // tile * planes * blocks)[:, None]
    q = bx // blocks
    block = bx - q * blocks
    t = q // planes
    i = block * KTHREADS + np.arange(KTHREADS)[None, :]
    z = i // groups
    shape = i.shape
    return (np.broadcast_to(t, shape), np.broadcast_to(q - t * planes, shape),
            z * tile + (i - z * groups) * vec, z < Z)


def _slab(t, plane, rows, Z, tile):
    """csrc/qc.cuh slab: the start of a plane's slab of tile t in a
    tile-major array of ``rows`` rows."""
    return (t * rows + plane * Z) * tile


@pytest.mark.parametrize("Z, words", [(1, 1), (17, 1), (16, 3), (333, 33),
                                      (1000, 70), (17, 4), (834, 768),
                                      (333, 36), (257, 4), (83, 48)])
@pytest.mark.parametrize("align", [16, 8])
def test_grid_covers_each_word_once(Z, words, align):
    planes = 3
    vec, tile = qc_bp.qc_bec_layout(planes * Z, words, align, 0)
    t, plane, o, live = _tile_grid(planes, Z, words, vec, tile)
    # each live item's words, as (row, word) of the row-major planes
    z, wi = o // tile, o % tile
    row = (plane * Z + z)[live][:, None]
    word = (t * tile + wi)[live][:, None] + np.arange(vec)
    seen = np.zeros((planes * Z, words), np.int64)
    np.add.at(seen, (np.broadcast_to(row, word.shape), word), 1)
    assert np.all(seen == 1)
    # the tile is the slowest coordinate: never smaller at a later block
    assert np.all(np.diff(t[:, 0]) >= 0)
    # a block is one plane of one tile
    assert np.all(plane == plane[:, :1]) and np.all(t == t[:, :1])
    # a warp's live items are consecutive words of the tile-major array
    at = _slab(t, plane, planes * Z, Z, tile) + o
    for warp in range(0, KTHREADS, 32):
        a, m = at[:, warp:warp + 32], live[:, warp:warp + 32]
        for row_at, row_live in zip(a, m):
            got = row_at[row_live]
            assert np.array_equal(got, got[0] + vec * np.arange(got.size)) \
                if got.size else True


def _rotate(o, rot, size, up):
    """csrc/qc.cuh rotate_up / rotate_down."""
    r = o + rot if up else o - rot
    return np.where(r >= size, r - size, np.where(r < 0, r + size, r))


@pytest.mark.parametrize("Z, tile", [(1, 4), (8, 1), (17, 4), (16, 3),
                                     (5, 70)])
def test_rotation_is_the_circulant_index(Z, tile):
    # rows (z + s) mod Z and (z - s) mod Z, word w of a [Z, tile] slab, for
    # every (z, w) and every shift s: the wraps at z + s = Z and z = s
    z, w = np.meshgrid(np.arange(Z), np.arange(tile), indexing="ij")
    o = z * tile + w
    for s in range(Z):
        assert np.array_equal(_rotate(o, s * tile, Z * tile, True),
                              ((z + s) % Z) * tile + w)
        assert np.array_equal(_rotate(o, s * tile, Z * tile, False),
                              ((z - s) % Z) * tile + w)


# ---------------------------------------------------------------------------
# The numpy model of the kernels' arithmetic
# ---------------------------------------------------------------------------

def _items(adj, planes, words, vec, tile):
    """The live items of the grid: (tile, plane, o), int64 each."""
    t, plane, o, live = _tile_grid(planes, adj.Z, words, vec, tile)
    return t[live], plane[live], o[live]


def _q1_model(adj, known, val, vec, tile):
    """qc_check_exactly_one.cu's arithmetic on numpy uint32 planes in the
    tile-major layout of ``tile`` words: per item of ``vec`` words, the
    real sockets (compacted to the left, padding nb) in turn, each at the
    rotated offset of its block's slab; the once / twice masks and the XOR
    of the known values.  Returns
    exactly_one (and adopt with ``val``) in the same layout, and checks
    that every output word is written by one item."""
    Z, words = adj.Z, known.shape[1]
    size = Z * tile
    lanes = np.arange(vec)
    t, c, o = _items(adj, adj.mb, words, vec, tile)
    blocks = adj.chk_block.numpy()[c]            # [items, dcb]
    shifts = adj.chk_shift.numpy()[c]
    kf, vf = known.ravel(), None if val is None else val.ravel()
    once = np.zeros((c.size, vec), np.uint32)
    twice, xor_known = np.zeros_like(once), np.zeros_like(once)

    def fold(j, real):
        b = np.where(real, blocks[:, j], 0)
        src = _slab(t, b, adj.n, Z, tile) + _rotate(o, shifts[:, j] * tile,
                                                    size, True)
        at = np.where(real[:, None], src[:, None] + lanes, 0)
        k = np.where(real[:, None], kf[at], FULL)
        unknown = ~k
        twice[:] |= once & unknown
        once[:] |= unknown
        if vf is not None:
            xor_known[:] ^= np.where(real[:, None], vf[at] & k, 0)

    real = blocks < adj.nb
    # real sockets are a prefix of each row: the loop breaks at the first
    # padded one
    assert np.all(real[:, 1:] <= real[:, :-1])
    for j in range(blocks.shape[1]):
        fold(j, real[:, j])
    dst = (_slab(t, c, adj.m, Z, tile) + o)[:, None] + lanes
    assert np.unique(dst).size == dst.size == adj.m * words
    eo = np.zeros(adj.m * words, np.uint32)
    eo[dst] = once & ~twice
    eo = eo.reshape(adj.m, words)
    if val is None:
        return eo
    ad = np.zeros(adj.m * words, np.uint32)
    ad[dst] = (once & ~twice) & xor_known
    return eo, ad.reshape(adj.m, words)


def _q2_model(adj, exactly_one, known, vec, tile, adopt=None, val=None):
    """qc_variable_or.cu's arithmetic, in place on numpy uint32 planes in
    the tile-major layout of ``tile`` words: per item, an item whose
    ``vec`` words are all known skips; else the OR of its sockets'
    exactly-one (and adopt) words at the rotated offsets of their checks'
    slabs, ``val |= taken & ~known``, ``known |= any``.  Returns
    (erasures left, items skipped)."""
    Z, words = adj.Z, known.shape[1]
    size = Z * tile
    lanes = np.arange(vec)
    t, b, o = _items(adj, adj.nb, words, vec, tile)
    own = (_slab(t, b, adj.n, Z, tile) + o)[:, None] + lanes
    assert np.unique(own).size == own.size == adj.n * words
    kf = known.reshape(-1)
    k = kf[own]
    skip = (k == FULL).all(axis=1)
    chks = adj.var_chk.numpy()[b]
    shifts = adj.var_shift.numpy()[b]
    ef = exactly_one.ravel()
    af = None if adopt is None else adopt.ravel()
    any_ready = np.zeros_like(k)
    taken = np.zeros_like(k)
    for p in range(chks.shape[1]):
        real = (chks[:, p] >= 0) & ~skip
        src = _slab(t, np.where(real, chks[:, p], 0), adj.m, Z, tile) + \
            _rotate(o, shifts[:, p] * tile, size, False)
        at = np.where(real[:, None], src[:, None] + lanes, 0)
        any_ready |= np.where(real[:, None], ef[at], 0)
        if af is not None:
            taken |= np.where(real[:, None], af[at], 0)
    if val is not None:
        vf = val.reshape(-1)
        vf[own] |= taken & ~k
    k |= any_ready
    kf[own] = k
    errors = int(np.unpackbits(np.ascontiguousarray(~k).view(np.uint8))
                 .sum())
    return errors, int(skip.sum())


def _code_pair(base, Z):
    """(JAX code, the port's code) of a named base."""
    if base == "regular":
        j = jqc_mod.sample_qc_code(jax.random.key(3), nb=12, dv=3, dc=6, Z=Z)
        return j, qc.qc_code_from_numpy(np.asarray(j.base_chk),
                                        np.asarray(j.shifts), j.Z, j.nb,
                                        j.dv, j.dc)
    if base == "irregular":
        j = jqc_mod.sample_qc_code_irregular(jax.random.key(50), nb=24,
                                             lam=LAM_BEC, rho=RHO6, Z=Z)
    elif base == "dc10":
        j = jqc_mod.sample_qc_code_irregular(jax.random.key(51), nb=20,
                                             lam=[0, 0, 1.0],
                                             rho=[0] * 9 + [1.0], Z=Z)
    else:
        table, shifts, nb = HAND[base]
        j = jqc_mod.IrregularQCLDPCCode(
            base_chk=jnp.asarray(table, jnp.int32),
            shifts=jnp.asarray(np.asarray(shifts) % Z, jnp.int32), Z=Z,
            nb=nb, mb=len(table))
    return j, qc.irregular_qc_code_from_numpy(
        np.asarray(j.base_chk), np.asarray(j.shifts), j.Z, j.nb, j.mb)


def _planes(rng, shape, p=0.5):
    bits = rng.random(shape + (32,)) < p
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


def _u(t):
    return t.numpy().view(np.uint32)


def _popcount(x):
    return int(np.unpackbits(np.ascontiguousarray(x).view(np.uint8)).sum())


def _tiles(x, tile):
    return _u(qc_bp.to_tiles(_t(x), tile)).copy()


def _rows(x, tile):
    return _u(qc_bp.from_tiles(_t(x), tile)).copy()


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("words, align", [(8, 16), (36, 16), (3, 16),
                                          (8, 8), (70, 16), (1, 16)])
@pytest.mark.parametrize("values", [False, True])
def test_model_equals_plain_round_after_round(base, words, align, values):
    # the state of a decode at eps = 0.3 on 60% of the variables (the rest
    # known in every trial, so whole items skip from the first round),
    # round after round: the model on tile-major planes, the plain
    # versions on row-major ones, the wrappers' CPU path on the model's
    _, code = _code_pair(base, 17)
    adj = qc_bp._adjacency(code, "cpu")
    vec, tile = qc_bp.qc_bec_layout(code.n, words, align, 0)
    rng = np.random.default_rng(words * 7 + align)
    erased = _planes(rng, (code.n, words), 0.3)
    erased[rng.random(code.n) < 0.4] = 0
    known = _tiles(~erased, tile)
    val = _tiles(_planes(rng, (code.n, words)) & ~erased, tile) if values \
        else None
    skipped = 0
    for _ in range(12):
        kw = dict(val=None if val is None else _t(val), tile=tile)
        got = _q1_model(adj, known, val, vec, tile)
        want = qc_bp._qc_check_exactly_one_plain(
            adj, _t(_rows(known, tile)),
            None if val is None else _t(_rows(val, tile)))
        wrapped = qc_bp.qc_check_exactly_one(adj, _t(known), **kw)
        eo, ad = got if values else (got, None)
        for g, w, x in zip(got if values else [got],
                           want if values else [want],
                           wrapped if values else [wrapped]):
            assert np.array_equal(_rows(g, tile), _u(w))
            assert np.array_equal(g, _u(x))
        k_plain = _t(_rows(known, tile))
        v_plain = None if val is None else _t(_rows(val, tile))
        errors_plain = torch.zeros(2, dtype=torch.int32)
        qc_bp._qc_variable_or_plain(
            adj, _t(_rows(eo, tile)), k_plain, errors_plain, 1,
            None if ad is None else _t(_rows(ad, tile)), v_plain)
        k_wrap, v_wrap = _t(known), kw["val"]
        errors_wrap = torch.zeros(2, dtype=torch.int32)
        qc_bp.qc_variable_or(adj, _t(eo), k_wrap, errors_wrap, 1,
                             None if ad is None else _t(ad), v_wrap,
                             tile=tile)
        errors, skips = _q2_model(adj, eo, known, vec, tile, ad, val)
        skipped += skips
        assert np.array_equal(_rows(known, tile), _u(k_plain))
        assert np.array_equal(known, _u(k_wrap))
        if values:
            assert np.array_equal(_rows(val, tile), _u(v_plain))
            assert np.array_equal(val, _u(v_wrap))
        assert errors == int(errors_plain[1]) == int(errors_wrap[1])
        assert int(errors_plain[0]) == int(errors_wrap[0]) == 0
    assert skipped > 0


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("values", [False, True])
def test_model_round_equals_jax(base, values):
    """Rounds of the model on tile-major planes equal JAX's
    ``_qc_iteration_allzero`` / ``_qc_iteration`` on the same planes, and
    Q2's count equals the fixed-point loop's ``total_popcount(~known)``."""
    jcode, code = _code_pair(base, 16)
    adj = qc_bp._adjacency(code, "cpu")
    chk_side, nb = jqc_bp._adjacency(jcode)
    words = 12
    vec, tile = qc_bp.qc_bec_layout(code.n, words, 16, 0)
    assert tile < words                 # several tiles
    rng = np.random.default_rng(5)
    erased = _planes(rng, (code.n, words), 0.35)
    known = _tiles(~erased, tile)
    val = _tiles(_planes(rng, (code.n, words)) & ~erased, tile) if values \
        else None
    shape = (nb, code.Z, words)
    for _ in range(4):
        jk = jnp.asarray(_rows(known, tile).reshape(shape))
        if values:
            jv, jk = jqc_bp._qc_iteration(
                chk_side, nb, jnp.asarray(_rows(val, tile).reshape(shape)),
                jk)
            eo, ad = _q1_model(adj, known, val, vec, tile)
        else:
            jk = jqc_bp._qc_iteration_allzero(chk_side, nb, jk)
            eo, ad = _q1_model(adj, known, None, vec, tile), None
        errors, _ = _q2_model(adj, eo, known, vec, tile, ad, val)
        want = np.asarray(jk).reshape(known.shape)
        assert np.array_equal(_rows(known, tile), want)
        if values:
            assert np.array_equal(_rows(val, tile),
                                  np.asarray(jv).reshape(val.shape))
        assert errors == _popcount(~want)


@pytest.mark.parametrize("base", BASES)
def test_tiled_decodes_equal_plain_and_jax(base, monkeypatch):
    """The decodes with their planes in column tiles (the CPU's cache set
    to 0, so any plane set is tiled) equal the plain decodes on row-major
    planes, and the all-zero one JAX's decode."""
    monkeypatch.setattr(qc_bp, "QC_CPU_CACHE_BYTES", 0)
    jcode, code = _code_pair(base, 16)
    words = 12
    assert qc_bp._decode_tile(torch.zeros((code.n, words),
                                          dtype=torch.int32)) == 4
    rng = np.random.default_rng(9)
    erased = _t(_planes(rng, (code.n, words), 0.35))
    tx = _t(_planes(rng, (code.n, words)))
    for got, want in (
            (qc_bp.qc_bp_decode_packed_allzero(code, erased, 30),
             qc_bp.qc_bp_decode_packed_allzero_plain(code, erased, 30)),
            (qc_bp.qc_bp_decode_packed(code, erased, tx, 30),
             qc_bp.qc_bp_decode_packed_plain(code, erased, tx, 30))):
        assert torch.equal(got.known, want.known)
        assert (got.val is None) == (want.val is None)
        assert got.val is None or torch.equal(got.val, want.val)
        assert torch.equal(got.error_totals, want.error_totals)
        assert got.iterations == want.iterations
    one = qc_bp.qc_bp_decode_packed_allzero(code, erased, 30)
    ref = jqc_bp.qc_bp_decode_packed_allzero(
        jcode, jnp.asarray(erased.numpy().view(np.uint32)), 30)
    assert np.array_equal(_u(one.known), np.asarray(ref.known))
    assert np.array_equal(one.error_totals.numpy(),
                          np.asarray(ref.error_totals))
    assert one.iterations == int(ref.iterations)
