"""The value round's two kernels, K2's and K3's value forms, on the CPU.

``check_exactly_one_xor`` and ``variable_or_adopt`` (the ``kValues``
kernels of ``csrc/check_exactly_one.cu`` and ``csrc/variable_or_update.cu``)
run every round of the random-transmit decodes that kernel D's value form
does not take: the ensemble random chunks at n = 2048 (24 words a code),
fixed codes above its one-word limit, irregular codes, and the ``_traj``
forms.  Here:

  * a numpy model of both kernels' items -- ``common.cuh``'s row grid over
    the planes in items of N = 4 or N = 1 words, taken in column tiles of
    the planes (``tiled_row_item``) or whole, a row's table entries
    loaded once an item, 32-bit offsets; the check pass gathering ``val``
    only where the item's exactly-one summary is non-zero; the variable
    pass skipping an item whose words know every trial, gathering
    ``adopt`` (and loading and storing ``val`` and ``known``) only where
    the OR of its exactly-one gathers has a bit on a trial it does not
    know; the count summed a block -- held bit for bit, round after round
    to the fixed point, against the plain passes, the wrappers' CPU path
    and JAX's ``_check_summaries(code, val, known)`` / ``_packed_iteration``
    on an npz (3,6) code, a batch of 4 codes of 24 words, an irregular
    code's phantom view (both degrees in the socket loops) and a dc-10
    code, with codewords and random planes, at eps 0, 0.42 and 1;
  * the tile rule ``value_round_tile`` on a table of shapes, the tiled
    grid's cover of a plane, the wrappers' width and tile rules and
    ``.vec`` / ``.tile`` (the launch recorded on CPU tensors), the entry
    points against the sources and signatures;
  * whole ``bp_decode_packed_traj`` decodes and the forced host loop over
    the value round against JAX's ``bp_decode_packed_traj`` /
    ``bp_decode_packed``.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models import store as jstore
from iib_project_ldpc_codes_tpu.models.ensemble import sample_code as \
    jax_sample_code
from iib_project_ldpc_codes_tpu.ops import erasure_bp as jeb
from iib_project_ldpc_codes_tpu_torch.kernels.build import (SIGNATURES,
                                                            SOURCE_DIR)
from iib_project_ldpc_codes_tpu_torch.models import encode, store
from iib_project_ldpc_codes_tpu_torch.models.code import codes_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_code_from_numpy
from iib_project_ldpc_codes_tpu_torch.ops import bitops
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp as eb

KTHREADS = 256                    # csrc/common.cuh kThreads
FULL = np.uint32(0xFFFFFFFF)
LAM, RHO7 = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 0.5, 0.5]
ROUNDS = 60


# ---------------------------------------------------------------------------
# Codes: (JAX codes, one per block of words; the port's tables; the code
# whose codewords the planes carry)
# ---------------------------------------------------------------------------

def _npz_36(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("code") / "code.npz")
    jstore.save_code(jax_sample_code(jax.random.key(41), 240, 3, 6), path)
    jcode, code = jstore.load_code(path), store.load_code(path)
    return [jcode], code, code, 8


def _batch4(_):
    jcodes = [jax_sample_code(jax.random.key(50 + i), 120, 3, 6)
              for i in range(4)]
    code = codes_from_numpy(np.stack([np.asarray(j.chk_to_var)
                                      for j in jcodes]), 120, 3, 6)
    return jcodes, code, code, 4 * 24


def _irregular(_):
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(300, LAM, RHO7).sample(
        jax.random.key(42))
    code = irregular_code_from_numpy(
        *(np.asarray(getattr(jcode, f))
          for f in ("chk_to_var", "var_to_chk", "var_to_sock")),
        jcode.n, jcode.m)
    return [jeb._phantom_view(jcode)], eb._phantom_view(code), code, 8


def _dc10(_):
    jcode = jax_sample_code(jax.random.key(43), 200, 5, 10)
    code = code_from_numpy(np.asarray(jcode.chk_to_var), 200, 5, 10)
    return [jcode], code, code, 8


KINDS = {"npz_36": _npz_36, "batch4_wpc24": _batch4,
         "irregular_phantom": _irregular, "dc10": _dc10}


@pytest.fixture(scope="module", params=sorted(KINDS))
def case(request, tmp_path_factory):
    return request.param, KINDS[request.param](tmp_path_factory)


def _planes(shape, p, seed):
    bits = np.random.default_rng(seed).random(shape + (32,)) < p
    return torch.from_numpy(
        (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        .astype(np.uint32).view(np.int32))


def _start(view, base, words, eps, tx_kind, seed):
    """(known, val) of the first round, uint32 [rows, W]: codewords of
    ``base`` (the port's encoder) or random planes; a phantom view's last
    row (``base.n`` below the view's rows) known with value 0."""
    rows = view.var_to_chk.shape[-2]
    n = base.n
    if tx_kind == "codeword":
        planes = encode.code_encoder_planes(base)
        tx = encode.encode_packed(planes, bitops.info_planes(
            planes.k, words, seed=seed))
    else:
        tx = _planes((n, words), 0.5, seed)
    erased = _planes((n, words), eps, seed + 1)
    if n != rows:
        tx, erased = eb._pad_phantom_row(tx), eb._pad_phantom_row(erased)
    known = (~erased).numpy().view(np.uint32)
    return known, (tx.numpy().view(np.uint32) & known)


def _u(t):
    return t.numpy().view(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


# ---------------------------------------------------------------------------
# The numpy model of both kernels' items
# ---------------------------------------------------------------------------

def _grid(rows, words, vec, tile):
    """common.cuh row_grid in column tiles of ``tile`` words
    (tiled_row_item; ``tile`` = W: row_item's order): (row, w, thread
    index) of every live thread of the 1-D grid, in launch order."""
    blocks = -(-(rows * (words // vec)) // KTHREADS)
    i = np.arange(blocks * KTHREADS)
    groups = tile // vec
    t = i // (rows * groups)
    rem = i - t * rows * groups
    row = rem // groups
    w = t * tile + (rem - row * groups) * vec
    live = t < words // tile
    return row[live], w[live], i[live]


def _items(table, rows_of_plane, words, vec, tile):
    """Each item's (row, w, thread, its row's table entries as 32-bit word
    offsets, the [items, N] word positions of the item in its plane): word
    w of a batch reads code w // wpc's table."""
    num = table.shape[0] if table.ndim == 3 else 1
    rows, deg = table.shape[-2:]
    wpc = words // num
    r, w, thread = _grid(rows, words, vec, tile)
    entry = (w // wpc) * rows + r
    assert entry.max() * deg < 2 ** 31
    offs = table.reshape(-1, deg)[entry].astype(np.int64) * words
    assert offs.max() < 2 ** 31 and rows_of_plane * words < 2 ** 30
    at = (r * words + w)[:, None] + np.arange(vec)
    assert np.unique(at).size == at.size == rows * words   # the cover
    return r, w, thread, offs, at


def _gather(plane, w, off, vec):
    return plane.ravel()[(w + off)[:, None] + np.arange(vec)]


def _check_model(chk, known, val, vec, tile):
    """check_exactly_one.cu's value form: per item, the dc rows of known
    folded into two running masks, then -- only where the item's
    exactly-one words are not all zero -- the dc rows of val gathered and
    XORed under known.  Returns (exactly_one, adopt, items that gathered
    val, items that did not)."""
    m = chk.shape[-2]
    _, w, _, offs, at = _items(chk, known.shape[0], known.shape[1], vec,
                               tile)
    once = np.zeros(at.shape, np.uint32)
    twice = np.zeros_like(once)
    ks = [_gather(known, w, offs[:, j], vec) for j in range(offs.shape[1])]
    for k in ks:
        twice |= once & ~k
        once |= ~k
    eo = once & ~twice
    teach = (eo != 0).any(1)
    x = np.zeros_like(eo)
    x_all = np.zeros_like(eo)
    for j, k in enumerate(ks):
        v = _gather(val, w, offs[:, j], vec)
        x_all ^= v & k
        x[teach] ^= v[teach] & k[teach]
    # the gathers skipped change nothing: adopt is zero where eo is
    assert np.array_equal(x & eo, x_all & eo)
    ex = np.zeros(m * known.shape[1], np.uint32)
    adopt = np.zeros_like(ex)
    ex[at], adopt[at] = eo, x & eo
    return (ex.reshape(m, -1), adopt.reshape(m, -1), int(teach.sum()),
            int((~teach).sum()))


def _variable_model(var, ex, adopt, known, val, vec, tile):
    """variable_or_update.cu's value form: an item whose words know every
    trial skips everything; else the dv rows of exactly_one ORed; only
    where that OR has a bit on a trial the item does not know, the dv rows
    of adopt ORed, val |= taken & ~known (the old known), known |= OR, and
    both stored; each thread's popcount of ~known summed a block (one
    atomic a block with a non-zero sum).  Returns (known, val, count,
    items skipped, items that gathered adopt)."""
    n, words = known.shape
    _, w, thread, offs, at = _items(var, ex.shape[0], words, vec, tile)
    k_out, v_out = known.ravel().copy(), val.ravel().copy()
    k = k_out[at]
    open_ = (k != FULL).any(1)
    acc = np.zeros_like(k)
    taken_all = np.zeros_like(k)
    for p in range(offs.shape[1]):
        acc |= _gather(ex, w, offs[:, p], vec)
        taken_all |= _gather(adopt, w, offs[:, p], vec)
    learn = open_ & ((acc & ~k) != 0).any(1)
    taken = np.where(learn[:, None], taken_all, 0)
    # the skipped items and gathers change nothing
    assert not (taken_all & ~k)[~learn].any()
    assert np.array_equal(np.where(learn[:, None], k | acc, k), k | acc)
    v_new = np.where(learn[:, None], v_out[at] | (taken & ~k), v_out[at])
    k_new = np.where(learn[:, None], k | acc, k)
    k_out[at], v_out[at] = k_new, v_new
    pop = np.unpackbits((~k_new).view(np.uint8), axis=1).sum(1)
    block_sums = np.bincount(thread // KTHREADS, weights=pop).astype(np.int64)
    return (k_out.reshape(n, words), v_out.reshape(n, words),
            int(block_sums[block_sums != 0].sum()), int((~open_).sum()),
            int(learn.sum()))


@jax.jit
def _jax_one_round(jcode, val, known):
    eo, xor_known = jeb._check_summaries(jcode, val, known)
    new_val, new_known = jeb._packed_iteration(jcode, val, known)
    return eo, eo & xor_known, new_val, new_known


def _jax_round(jcodes, known, val):
    """JAX's _check_summaries and _packed_iteration, each code of a batch
    on its own words: (exactly_one, adopt, val, known) as uint32."""
    wpc = known.shape[1] // len(jcodes)
    outs = []
    for i, jcode in enumerate(jcodes):
        sl = slice(i * wpc, (i + 1) * wpc)
        outs.append([np.asarray(a) for a in _jax_one_round(
            jcode, jnp.asarray(val[:, sl]), jnp.asarray(known[:, sl]))])
    return [np.concatenate(parts, axis=1) for parts in zip(*outs)]


@pytest.mark.parametrize("tx_kind", ["codeword", "random"])
@pytest.mark.parametrize("eps", [0.0, 0.42, 1.0])
@pytest.mark.parametrize("align", [16, 8])
def test_model_equals_plain_and_jax_round_after_round(case, tx_kind, eps,
                                                      align):
    """Rounds to the fixed point: both kernels' model equals the plain
    passes, the wrappers' CPU path and JAX's one round, with N = 4 (where a
    code's words and the planes' alignment allow) on the whole rows and N
    = 1 in two column tiles; the skips are taken where they should be."""
    kind, (jcodes, view, base, words) = case
    num = view.chk_to_var.shape[0] if view.chk_to_var.dim() == 3 else 1
    vec = eb.check_exactly_one_vector(words // num, align)
    assert vec == (4 if align == 16 else 1)
    tile = words if align == 16 else words // 2
    known, val = _start(view, base, words, eps, tx_kind,
                        seed=int(100 * eps) + align)
    chk, var = view.chk_to_var.numpy(), view.var_to_chk.numpy()
    tally = dict(teach=0, quiet=0, skipped=0, learned=0)
    count, rounds = None, 0
    while rounds < ROUNDS:
        ex, adopt, teach, quiet = _check_model(chk, known, val, vec, tile)
        for fn in (eb._check_exactly_one_xor_plain, eb.check_exactly_one_xor):
            got = fn(view.chk_to_var, _t(known), _t(val))
            assert np.array_equal(_u(got[0]), ex)
            assert np.array_equal(_u(got[1]), adopt)
        new_known, new_val, new_count, skipped, learned = _variable_model(
            var, ex, adopt, known, val, vec, tile)
        for fn in (eb._variable_or_adopt_plain, eb.variable_or_adopt):
            k, v = _t(known), _t(val)
            errors = torch.zeros(2, dtype=torch.int32)
            fn(view.var_to_chk, _t(ex), _t(adopt), k, v, errors, 1)
            assert np.array_equal(_u(k), new_known)
            assert np.array_equal(_u(v), new_val)
            assert int(errors[1]) == new_count
        j_ex, j_adopt, j_val, j_known = _jax_round(jcodes, known, val)
        assert np.array_equal(j_ex, ex) and np.array_equal(j_adopt, adopt)
        assert np.array_equal(j_val, new_val)
        assert np.array_equal(j_known, new_known)
        for key, add in zip(tally, (teach, quiet, skipped, learned)):
            tally[key] += add
        rounds += 1
        done = new_count == count or new_count == 0
        known, val, count = new_known, new_val, new_count
        if done:
            break
    assert rounds < ROUNDS                       # the fixed point reached
    if eps == 0.0:                               # all known: all skipped
        assert tally["teach"] == tally["learned"] == 0
        assert tally["skipped"] > 0
    elif eps == 0.42:                  # the gathers taken and skipped
        assert min(tally["teach"], tally["quiet"], tally["learned"]) > 0


# ---------------------------------------------------------------------------
# The tile rule and the tiled grid, the wrappers' launch, the entry points
# ---------------------------------------------------------------------------

H100_L2 = 50 * 2 ** 20


@pytest.mark.parametrize("rows, words, cache, want", [
    (10_000, 768, H100_L2, 192),        # S2: 61 MB of planes, a third: 17
    (2_048, 768, H100_L2, 768),         # S1: 12.6 MB fit, no tiles
    (1_000_000, 48, H100_L2, 48),       # S3: no tile of 32 words fits
    (20_000, 768, H100_L2, 96),
    (100_000, 768, H100_L2, 768),
    (10_000, 33, H100_L2, 33),          # no divisor of 33 qualifies
    (10_000, 40, 10 ** 6, 40),          # 40's divisors below 32 words
    (300, 96, 300_000, 32),
    (300, 96, 600_000, 48),
    (300, 8, 1, 8),                     # W below the least tile
])
def test_value_round_tile_rule(rows, words, cache, want):
    """A column tile only where the two gathered planes overflow a third of
    the L2: the largest divisor of W that is a multiple of 8 words (of
    either N), at least 32 words, whose slices fit it; else W."""
    tile = eb.value_round_tile(rows, words, cache)
    assert tile == want
    assert words % tile == 0 and (tile == words or tile % 8 == 0)
    if tile < words:
        assert tile % 8 == 0 and tile >= eb.VALUE_TILE_MIN_WORDS
        assert 2 * rows * tile * 4 <= cache // 3 < 2 * rows * words * 4


@pytest.mark.parametrize("rows, words, vec, tile", [
    (300, 8, 4, 8), (300, 8, 4, 4), (300, 8, 1, 2), (37, 768, 4, 192),
    (37, 768, 1, 96), (1000, 96, 4, 32), (12, 1, 1, 1), (5, 40, 4, 8)])
def test_tiled_grid_covers_each_item_once(rows, words, vec, tile):
    """The tiled grid (tile slowest, then row) covers every word of a
    [rows, W] plane once, an item's N words in one row and one tile, and
    the blocks of one tile before those of the next."""
    row, w, thread = _grid(rows, words, vec, tile)
    at = (row * words + w)[:, None] + np.arange(vec)
    assert np.unique(at).size == at.size == rows * words
    assert np.all(w // tile == (w + vec - 1) // tile)
    assert np.all(np.diff(w // tile) >= 0)              # tiles in order
    assert np.array_equal(thread, np.arange(thread.size))
    if tile == words:                                   # the row grid
        assert np.array_equal(row, thread // (words // vec))


def _offset_view(t, align):
    """A contiguous copy of ``t`` ``align`` bytes past a 16-byte boundary
    (16: aligned)."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype)
    skip = 0
    while buf[skip:].data_ptr() % 16 != align % 16:
        skip += 1
    out = buf[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("wpc, num, align, misaligned, want", [
    (768, 1, 16, "", 4),           # S2: one code at the fixed width
    (24, 32, 16, "", 4),           # S1: the ensemble random chunk
    (48, 1, 16, "", 4),            # S3: n = 10^6, W = 48
    (48, 1, 8, "known", 1),        # one plane 8 bytes off
    (48, 1, 8, "val", 1),
    (48, 1, 4, "adopt", 1),        # the variable pass's adopt plane
    (33, 1, 16, "", 1),            # W % 4 != 0
    (3, 8, 16, "", 1),             # a code's words not a multiple of 4
    (1, 16, 16, "", 1),
])
def test_wrappers_launch_by_the_width_rule(monkeypatch, wpc, num, align,
                                           misaligned, want):
    """On a CUDA tensor each wrapper launches N = 4 exactly where
    ``check_exactly_one_vector`` over all four planes' alignment allows it,
    passes n, m and the tile of ``value_round_tile`` (no tile at these
    sizes), and keeps the launched N and tile in ``.vec`` and ``.tile``
    (the launch is recorded here instead of run)."""
    launched = []
    monkeypatch.setattr(eb, "use_kernel", lambda *a: True)
    monkeypatch.setattr(eb, "launch", lambda name, dev, *args:
                        launched.append((name, args)))
    monkeypatch.setattr(eb, "l2_bytes", lambda index: H100_L2)
    n, m, words = 24, 12, wpc * num
    chk = torch.zeros((num, m, 6) if num > 1 else (m, 6), dtype=torch.int32)
    var = torch.zeros((num, n, 3) if num > 1 else (n, 3), dtype=torch.int32)
    planes = {k: torch.zeros((rows, words), dtype=torch.int32)
              for k, rows in (("known", n), ("val", n), ("exactly_one", m),
                              ("adopt", m))}
    if misaligned:
        planes[misaligned] = _offset_view(planes[misaligned], align)
    eb.check_exactly_one_xor(chk, planes["known"], planes["val"])
    # the check pass's own outputs are fresh, aligned planes
    want_check = eb.check_exactly_one_vector(wpc, 16) \
        if misaligned == "adopt" else want
    name, args = launched[-1]
    assert name == "ldpc_check_exactly_one_xor"
    assert args[5:] == (n, m, 6, words, wpc, want_check, words)
    assert eb.check_exactly_one_xor.vec == want_check
    assert eb.check_exactly_one_xor.tile == words
    errors = torch.zeros(2, dtype=torch.int32)
    eb.variable_or_adopt(var, planes["exactly_one"], planes["adopt"],
                         planes["known"], planes["val"], errors, 1)
    name, args = launched[-1]
    assert name == "ldpc_variable_or_adopt"
    assert args[6:] == (n, m, 3, words, wpc, want, words)
    assert eb.variable_or_adopt.vec == want
    assert eb.variable_or_adopt.tile == words


def _entry_params(src, name):
    body = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    return [p.split()[-1].lstrip("*") for p in body.split(",")]


def test_entry_points_match_the_sources():
    """The value forms live beside K2 and K3 (their own sources are gone),
    take n, m and vec as K2's and K3's entry points do, hold N = 4 to all
    four planes' alignment, and share K2's and K3's conditions and exact
    degrees."""
    k2 = (SOURCE_DIR / "check_exactly_one.cu").read_text()
    k3 = (SOURCE_DIR / "variable_or_update.cu").read_text()
    for gone in ("check_exactly_one_xor.cu", "variable_or_adopt.cu"):
        assert not (SOURCE_DIR / gone).exists()
    assert _entry_params(k2, "ldpc_check_exactly_one_xor") == [
        "known", "val", "chk_to_var", "exactly_one", "adopt", "n", "m", "dc",
        "words", "wpc", "vec", "tile", "stream"]
    assert _entry_params(k3, "ldpc_variable_or_adopt") == [
        "known", "val", "exactly_one", "adopt", "var_to_chk", "errors_slot",
        "n", "m", "dv", "words", "wpc", "vec", "tile", "stream"]
    assert len(SIGNATURES["ldpc_check_exactly_one_xor"]) == 13
    assert len(SIGNATURES["ldpc_variable_or_adopt"]) == 14
    for src in (k2, k3):
        assert "ldpc::qc::vector_ok(words, {known, val, exactly_one, " \
            "adopt})" in src
        assert src.count("return run<true>(") == 1
        assert src.count("return run<false>(") == 1
    assert "check_item<N, kDc, true>(a);" in k2
    assert "variable_item<N, kDv, true>(a);" in k3
    # the value forms take the tiled grid, the all-zero forms the row grid
    # (K2 and K3 pass W as the tile); a tile is a multiple of N dividing W
    for src in (k2, k3):
        assert "kValues ? ldpc::tiled_row_item<N>(a.grid, a.tile)\n" \
            "                                   : ldpc::row_item<N>(a.grid);" \
            in src
        assert "tile <= 0 || tile % vec ||\n      words % tile ||" in src
    # the gathers taken only where a check can teach
    assert k2.count("if (teaches<N>(eo)) {") == 2       # exact and loop
    assert "learn |= acc.v[l] & ~k.v[l];" in k3
    assert "if (learn != 0) {" in k3
    assert "static_cast<long long>(words / wpc) * m * dc >= (1LL << 31)" \
        in k2
    assert "static_cast<long long>(words / wpc) * n * dv >= (1LL << 31)" \
        in k3


# ---------------------------------------------------------------------------
# Whole decodes: the _traj forms and the forced host loop against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 0.42, 1.0])
@pytest.mark.parametrize("tx_kind", ["codeword", "random"])
def test_traj_and_host_loop_decodes_equal_jax(case, eps, tx_kind):
    """``bp_decode_packed_traj`` (the host loop over the value round, K4 a
    round) and the forced host loop of ``bp_decode_packed`` equal JAX's
    ``bp_decode_packed_traj`` / ``bp_decode_packed`` of each code."""
    kind, (jcodes, view, base, words) = case
    if kind == "irregular_phantom":
        code = base
        traj_fn, jtraj = eb.bp_decode_packed_traj_irregular, \
            jeb.bp_decode_packed_traj
    else:
        code = view
        traj_fn, jtraj = eb.bp_decode_packed_traj, jeb.bp_decode_packed_traj
    n = code.n
    known, val = _start(view, base, words, eps, tx_kind,
                        seed=int(10 * eps) + 3)
    erased, tx = _t(~known[:n]), _t(val[:n])     # tx where known, else 0
    got, got_traj = traj_fn(code, erased, tx, 50)
    rows = eb._decode_values(view, _t(~known), _t(val), 50,
                             eb._VALUE_KERNELS, False)[0]
    wpc = words // len(jcodes)
    want_traj, want_totals, want_its = [], [], []
    for i, jcode in enumerate(jcodes):
        sl = slice(i * wpc, (i + 1) * wpc)
        je, jt = jnp.asarray(~known[:, sl]), jnp.asarray(val[:, sl])
        res, traj = jtraj(jcode, je, jt, 50)
        plain = jeb.bp_decode_packed(jcode, je, jt, 50)
        for r in (res, plain):
            assert np.array_equal(np.asarray(r.known)[:n], _u(got.known)[:, sl])
            assert np.array_equal(np.asarray(r.val)[:n], _u(got.val)[:, sl])
        assert np.array_equal(np.asarray(plain.known), _u(rows.known)[:, sl])
        assert np.array_equal(np.asarray(plain.val), _u(rows.val)[:, sl])
        want_traj.append(np.asarray(traj))
        want_totals.append(np.asarray(res.error_totals))
        want_its.append(int(res.iterations))
    # a batch runs one loop over the summed count, each code frozen at its
    # fixed point: the per-code trajectories side by side, their totals
    # summed, the longest code's rounds
    assert np.array_equal(got_traj.numpy(), np.concatenate(want_traj, 1))
    assert np.array_equal(got.error_totals.numpy(), sum(want_totals))
    assert got.iterations == max(want_its) == rows.iterations
    assert np.array_equal(rows.error_totals.numpy(), sum(want_totals))
