"""K2 on a rank's check rows and X1, the gather passes of the edge-sharded
round, on the CPU: their launch rule, their grid and a numpy model of their
per-item arithmetic.

K2's vector rule ``check_exactly_one_vector`` (the words a thread of
``csrc/check_exactly_one.cu`` and, with a code's words the plane's W,
``csrc/edge_candidates.cu`` moves) on a table of widths, alignments and
words per code, and the conditions the kernels hold a launch to against
the sources; the row grid's cover of a plane (the rows of a shard of D =
1/2/4, widths that 4 does not divide); a numpy model of both kernels --
K2's two running masks over the check's sockets, a batch's code per word;
X1's unsigned shard compare and OR -- held bit for bit against the plain
versions ``_check_exactly_one_plain`` / ``_edge_candidates_plain``, the
wrappers' CPU path and JAX's ``_local_round`` on every shard of D =
1/2/4, round after round, on a regular (3,6) code and a phantom-padded
irregular one.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``); the decodes are held against JAX in
``tests/test_torch_edge_sharded.py``.
"""

import re

import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu_torch.kernels.build import (SIGNATURES,
                                                            SOURCE_DIR)
from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_code_from_numpy
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp
from iib_project_ldpc_codes_tpu_torch.ops.bitops import pack_bits
from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es
from iib_project_ldpc_codes_tpu_torch.parallel import mesh

KTHREADS = 256                    # csrc/common.cuh kThreads
LAM, RHO = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]


# ---------------------------------------------------------------------------
# The launch rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wpc, align, want", [
    (48, 16, 4),                # X1 and K2 on the edge decode's planes
    (48, 8, 1),                 # a plane 8 bytes off
    (48, 4, 1),
    (768, 16, 4),               # one code at the fixed path's width
    (768, 8, 1),
    (70, 16, 1),                # W % 4 != 0
    (36, 16, 4),
    (32, 4, 1),
    (4, 16, 4),
    (7, 16, 1),
    (1, 16, 1),                 # 768 codes of one word
    (1, 4, 1),
    (3, 16, 1),
    (24, 16, 4),
    (24, 8, 1),
    (72, 4, 1),
])
def test_check_exactly_one_vector_rule(wpc, align, want):
    """4 words a thread only where a code's words are a multiple of 4 (a
    thread's words belong to one code) and every plane is 16-byte
    aligned; X1 passes its plane's W as the code's words."""
    assert erasure_bp.check_exactly_one_vector(wpc, align) == want


def _entry_params(src, name):
    """The parameter list of extern "C" entry point ``name`` in ``src``."""
    body = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    return [p.split()[-1].lstrip("*") for p in body.split(",")]


def test_launch_conditions_match_the_kernel_source():
    """The block size is the kernels'; each entry point takes the
    arguments the wrapper passes (ctypes signature), runs the row grid of
    its plane, and holds a launch to N dividing W, planes below 2^30 words
    and N = 4 only on 16-byte aligned planes with (for K2) a code's words a
    multiple of 4."""
    common = (SOURCE_DIR / "common.cuh").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);",
                         common).group(1)) == KTHREADS
    assert "words % vec == 0 &&\n         static_cast<long long>(rows) * " \
        "words < (1LL << 30)" in common
    k2 = (SOURCE_DIR / "check_exactly_one.cu").read_text()
    x1 = (SOURCE_DIR / "edge_candidates.cu").read_text()
    assert _entry_params(k2, "ldpc_check_exactly_one") == [
        "known", "chk_to_var", "out", "n", "m", "dc", "words", "wpc", "vec",
        "stream"]
    assert _entry_params(x1, "ldpc_edge_candidates") == [
        "cand", "var_to_chk", "exactly_one", "n", "dv", "m_local", "words",
        "chk_offset", "vec", "stream"]
    assert len(SIGNATURES["ldpc_check_exactly_one"]) == 10
    assert len(SIGNATURES["ldpc_edge_candidates"]) == 10
    assert "vec == 4 && wpc % 4 == 0 && ldpc::qc::vector_ok(words, {known, " \
        "out})" in k2
    assert "ldpc::row_grid(m, words, vec, &blocks)" in k2
    assert "vec == 4 && ldpc::qc::vector_ok(words, {cand, exactly_one})" \
        in x1
    assert "ldpc::row_grid(n, words, vec, &blocks)" in x1
    for src, rows in ((k2, ("n", "m")), (x1, ("n", "m_local"))):
        for r in rows:
            assert f"ldpc::row_grid_fits({r}, words, vec)" in src
    # X1 never reads a row outside the shard
    assert "static_cast<unsigned>(c) < static_cast<unsigned>(a.m_local)" in x1
    # the main paths' degrees take the unrolled instantiations, any other
    # degree the socket loop
    assert re.search(r"constexpr int kExactDc = (\d+);", k2).group(1) == "6"
    assert re.search(r"constexpr int kExactDv = (\d+);", x1).group(1) == "3"
    assert "const bool exact = dc == kExactDc;" in k2
    assert "const bool exact = dv == kExactDv;" in x1


# ---------------------------------------------------------------------------
# The row grid
# ---------------------------------------------------------------------------

def _grid(rows, words, vec):
    """csrc/common.cuh row_grid and row_item for every live thread of the
    1-D grid, in launch order: (row, w) int64 each, w the item's first
    word in its row, and the block index of each."""
    groups = words // vec
    blocks = -(-(rows * groups) // KTHREADS)
    bx = np.arange(blocks)[:, None]
    i = bx * KTHREADS + np.arange(KTHREADS)[None, :]
    row = i // groups
    w = (i - row * groups) * vec
    live = row < rows
    return row[live], w[live], np.broadcast_to(bx, i.shape)[live]


@pytest.mark.parametrize("n, words", [(12, 1), (600, 7), (1000, 4),
                                      (3334, 36), (2000, 48), (1000, 70),
                                      (600, 32), (300, 768)])
@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("align", [16, 8])
def test_grid_covers_each_item_once(n, words, size, align):
    """K2's grid over a shard's m / D check rows and X1's over the n
    variable rows write every (row, word) of their plane exactly once, and
    a block's threads take consecutive items of the row-major plane."""
    vec = erasure_bp.check_exactly_one_vector(words, align)
    for rows in (n // 2 // size, n):
        z, w, bx = _grid(rows, words, vec)
        word = w[:, None] + np.arange(vec)
        seen = np.zeros((rows, words), np.int64)
        np.add.at(seen, (np.broadcast_to(z[:, None], word.shape), word), 1)
        assert np.all(seen == 1)
        at = z * words + w
        assert np.all(np.diff(at) == vec) and at.max() < 2 ** 30
        assert np.all(np.diff(bx) >= 0)


# ---------------------------------------------------------------------------
# The numpy model of the kernels' arithmetic
# ---------------------------------------------------------------------------

def _k2_model(chk, known, vec):
    """check_exactly_one.cu's arithmetic on a numpy uint32 ``known`` plane
    int32[n, W]: per item of ``vec`` words, the check's dc rows (of its
    code, word w of code w // wpc for a batch's table [C, m, dc]) folded
    into the once / twice masks at 32-bit offsets.  Returns the summary
    and checks that every output word is written by one item."""
    n, words = known.shape
    num = chk.shape[0] if chk.ndim == 3 else 1
    m, dc = chk.shape[-2:]
    wpc = words // num
    flat_chk = chk.reshape(-1, dc)
    lanes = np.arange(vec)
    c, w, _ = _grid(m, words, vec)
    rows = flat_chk[(w // wpc) * m + c]                # [items, dc]
    kf = known.ravel()
    base = w
    once = np.zeros((c.size, vec), np.uint32)
    twice = np.zeros_like(once)
    for j in range(dc):
        off = rows[:, j].astype(np.int64) * words
        assert off.max() < 2 ** 31
        unknown = ~kf[(base + off)[:, None] + lanes]
        twice |= once & unknown
        once |= unknown
    dst = (c * words + w)[:, None] + lanes
    assert np.unique(dst).size == dst.size == m * words
    out = np.zeros(m * words, np.uint32)
    out[dst] = once & ~twice
    return out.reshape(m, words)


def _x1_model(var, summary, chk_offset, vec):
    """edge_candidates.cu's arithmetic on numpy uint32 planes: per item,
    the OR of the summary words of the variable's checks c with 0 <= c -
    chk_offset < m_local (one unsigned compare: no other row is read)."""
    n, dv = var.shape
    m_local, words = summary.shape
    lanes = np.arange(vec)
    v, w, _ = _grid(n, words, vec)
    sf = summary.ravel()
    base = w
    acc = np.zeros((v.size, vec), np.uint32)
    for p in range(dv):
        c = (var[v, p].astype(np.int64) - chk_offset).astype(np.int32)
        inside = c.astype(np.uint32) < np.uint32(m_local)
        at = np.where(inside, base + c.astype(np.int64) * words, -1)
        assert np.all((at[inside] >= 0) & (at[inside] < sf.size))
        acc |= np.where(inside[:, None], sf[np.where(inside, at, 0)[:, None]
                                            + lanes], 0)
    dst = (v * words + w)[:, None] + lanes
    assert np.unique(dst).size == dst.size == n * words
    out = np.zeros(n * words, np.uint32)
    out[dst] = acc
    return out.reshape(n, words)


def _codes(kind, n, seed):
    """(JAX code, the same code in the port)."""
    import jax

    from iib_project_ldpc_codes_tpu.models.ensemble import sample_code
    from iib_project_ldpc_codes_tpu.models.irregular import \
        IrregularEnsembleSpec

    if kind == "regular":
        jcode = sample_code(jax.random.key(seed), n, 3, 6)
        return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), n, 3, 6)
    jcode = IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO).sample(
        jax.random.key(seed))
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    return jcode, irregular_code_from_numpy(*tables, jcode.n, jcode.m)


def _tables(kind, code, size):
    """The edge decode's (check rows, variable table), phantom-padded as
    ``edge_sharded_bp_decode_irregular`` pads them for ``size`` ranks."""
    if kind == "regular":
        return code.chk_to_var, code.var_to_chk
    extra = (-(code.m + 1)) % size
    chk = torch.cat([code.chk_to_var,
                     code.chk_to_var.new_full((extra, code.dc_max), code.n)])
    return chk, code.var_to_chk


def _planes(rng, rows, words, eps):
    bits = rng.random((rows, 32 * words)) < eps
    return pack_bits(torch.from_numpy(bits))


def _u(t):
    return t.numpy().view(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


@pytest.mark.parametrize("kind, n", [("regular", 384), ("irregular", 360)])
@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("words, align", [(32, 16), (48, 8), (7, 16),
                                          (36, 16), (4, 16)])
def test_model_equals_plain_and_jax_round_after_round(kind, n, size, words,
                                                      align):
    """Rounds of the edge decode: K2's model on every shard's check rows
    and X1's on its summary equal the plain versions, the wrappers' CPU
    path and JAX's ``_local_round``; the shards' candidates ORed into
    ``known`` (X2) are the next round's state."""
    import jax.numpy as jnp

    from iib_project_ldpc_codes_tpu.parallel import edge_sharded as jes

    _, code = _codes(kind, n, seed=size)
    chk, var = _tables(kind, code, size)
    rows = n + (kind == "irregular")             # the phantom row
    vec = erasure_bp.check_exactly_one_vector(words, align)
    erased = _planes(np.random.default_rng(words + size), rows, words, 0.4)
    if kind == "irregular":
        erased[-1] = 0                            # the phantom is known
    known = _u(~erased).copy()
    m_local = mesh.shard_rows(chk.shape[0], size)
    dc, dv = chk.shape[1], var.shape[1]
    resolved = 0
    for _ in range(4):
        cands = np.zeros_like(known)
        for r in range(size):
            off = r * m_local
            local = chk[off:off + m_local]
            ex = _k2_model(local.numpy(), known, vec)
            assert np.array_equal(ex, _u(erasure_bp._check_exactly_one_plain(
                local, _t(known))))
            assert np.array_equal(ex, _u(erasure_bp.check_exactly_one(
                local, _t(known))))
            cand = _x1_model(var.numpy(), ex, off, vec)
            assert np.array_equal(cand, _u(es._edge_candidates_plain(
                var, _t(ex), off)))
            assert np.array_equal(cand, _u(es.edge_candidates(
                var, _t(ex), off)))
            want = jes._local_round(jnp.asarray(local.numpy()),
                                    jnp.asarray(var.numpy()), off,
                                    jnp.asarray(known), dc, dv)
            assert np.array_equal(cand, np.asarray(want))
            cands |= cand
        resolved += int((cands & ~known != 0).sum())
        known |= cands
    assert resolved > 0


@pytest.mark.parametrize("wpc, num", [(1, 16), (3, 8), (24, 4), (8, 1)])
@pytest.mark.parametrize("align", [16, 8])
def test_k2_model_batched_equals_plain(wpc, num, align):
    """K2's model on a batch's tables (word w of code w // wpc) equals the
    plain version code by code."""
    from iib_project_ldpc_codes_tpu_torch.models.ensemble import \
        sample_codes

    codes = sample_codes(7, 0, num, 120, 3, 6)
    words = wpc * num
    vec = erasure_bp.check_exactly_one_vector(wpc, align)
    known = _u(~_planes(np.random.default_rng(wpc), 120, words, 0.3))
    got = _k2_model(codes.chk_to_var.numpy(), known, vec)
    want = erasure_bp._check_exactly_one_plain(codes.chk_to_var, _t(known))
    assert np.array_equal(got, _u(want))
