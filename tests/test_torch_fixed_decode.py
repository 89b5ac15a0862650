"""The fixed-code all-zero BEC decode on kernel D and K3, the round loop's
variable pass, on the CPU.

Kernel D (``csrc/erasure_decode.cu``) decodes one code one block a word:
its rule ``erasure_decode_block_words`` on a table of one-code shapes (the
(3,6) one-word limit and a word either side, irregular phantom views, QC
codes refused), the block split's cover of the words, and the one-code
decode through D's plain route held bit for bit -- ``known``,
``error_totals``, ``iterations`` and each word's own counts and rounds --
against the JAX package's ``bp_decode_packed_allzero`` (the code loaded
from one npz by both packages, the erased planes made by JAX) and against
the K2/K3 plain host loop, at eps 0, 0.42 and 1 and budgets 0, 1, 50 and
n, with a word that stops early beside a stuck one, and irregular against
``bp_decode_packed_allzero_irregular``.

K3 (``csrc/variable_or_update.cu``): a numpy model of its item path --
``common.cuh``'s row grid, an item's gathers and store skipped only when
all its N words know every trial, 32-bit offsets, the count summed a
block -- against ``_variable_or_update_plain``, the wrapper's CPU path and JAX's
one-round ``_packed_iteration_allzero``, at dv 3 and at a looped degree,
at N = 4 and N = 1, and batched with words per code that 4 does not
divide.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import store as jstore
from iib_project_ldpc_codes_tpu.models.ensemble import sample_code as \
    jax_sample_code
from iib_project_ldpc_codes_tpu.models.irregular import \
    IrregularEnsembleSpec as JaxSpec
from iib_project_ldpc_codes_tpu.ops import erasure_bp as jeb
from iib_project_ldpc_codes_tpu.ops.channels import \
    bec_packed_channel as jax_bec_packed_channel
from iib_project_ldpc_codes_tpu_torch.kernels.build import (SIGNATURES,
                                                            SOURCE_DIR)
from iib_project_ldpc_codes_tpu_torch.models import qc, store
from iib_project_ldpc_codes_tpu_torch.models.code import (LDPCCode,
                                                          code_from_numpy)
from iib_project_ldpc_codes_tpu_torch.models.ensemble import sample_codes
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_code_from_numpy
from iib_project_ldpc_codes_tpu_torch.ops import bitops
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp as eb

N, WORDS = 240, 8
KTHREADS = 256                    # csrc/common.cuh kThreads
LAM, RHO = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]


# ---------------------------------------------------------------------------
# The rule and the block split
# ---------------------------------------------------------------------------

def _shape_code(n, dv, dc, num=0, irregular=False):
    """A code (a batch when ``num``) with the tables' shapes only
    (expanded views, no memory): what the rule reads; an irregular code
    has the (3,6) rate's n / 2 checks and its phantom row and check."""
    rows = n + irregular
    m = (n // 2 if irregular else n * dv // dc) + irregular
    lead = (num,) if num else ()
    zero = torch.zeros((), dtype=torch.int32)
    chk = zero.expand(*lead, m, dc)
    var = zero.expand(*lead, rows, dv)
    if irregular:
        return eb._PhantomView(chk_to_var=chk, var_to_chk=var, n=rows)
    return LDPCCode(chk_to_var=chk, var_to_edge=var, n=n, dv=dv, dc=dc,
                    var_to_chk=var)


def test_one_word_limit():
    # (3,6) at one word: 18.5 bytes a variable and 16 of counters, within
    # the 232,448 bytes a block may opt into up to n = 12,562 (n even)
    edge = max(n for n in range(2, 40_000, 2)
               if eb._erasure_decode_smem_bytes(n, n // 2, 6, 1)
               <= eb.SMEM_OPTIN_BYTES)
    assert edge == 12_562
    assert eb._erasure_decode_smem_bytes(edge, edge // 2, 6, 1) <= \
        eb.SMEM_OPTIN_BYTES < eb._erasure_decode_smem_bytes(
            edge + 2, (edge + 2) // 2, 6, 1)
    # the headline shape at one word a block
    assert eb._erasure_decode_smem_bytes(10_000, 5000, 6, 1) == 185_016


@pytest.mark.parametrize("n, words, wpb", [
    (10_000, 768, 1),              # the headline: 768 blocks of one word
    (12_562, 768, 1),              # the one-word limit
    (12_560, 1, 1),                # the next n below it
    (12_564, 768, 0),              # the next n above it: K2/K3
    (1_000_000, 48, 0),            # the n = 10^6 decode
    (1024, 1, 1),
    (600, 33, 1)])
def test_rule_on_one_code(n, words, wpb):
    code = _shape_code(n, 3, 6)
    assert eb.erasure_decode_block_words(code, words) == wpb
    assert eb.takes_erasure_decode_kernel(code, words) is (wpb > 0)


@pytest.mark.parametrize("n, words, wpb", [
    (10_000, 768, 1),              # the fixed irregular decode
    (12_000, 96, 1),
    (12_564, 8, 0)])               # the phantom row and check tip it over
def test_rule_on_an_irregular_phantom_view(n, words, wpb):
    view = _shape_code(n, 4, 6, irregular=True)
    assert view.chk_to_var.dim() == 2
    assert eb.erasure_decode_block_words(view, words) == wpb


@pytest.mark.parametrize("num, n, words, wpb", [
    (768, 10_000, 768, 1),         # the ensemble chunk: one block a code
    (16, 1024, 64, 4),             # 4 words a code in one block
    (32, 10_000, 768, 0),          # 24 words a code do not fit
    (3, 1024, 4, 0)])              # words that do not split over codes
def test_rule_on_a_batch_keeps_a_block_a_code(num, n, words, wpb):
    assert eb.erasure_decode_block_words(_shape_code(n, 3, 6, num),
                                         words) == wpb


def test_rule_refuses_a_qc_code_and_no_words():
    code = qc.sample_qc_code(torch.Generator().manual_seed(0), nb=12, dv=3,
                             dc=6, Z=10)
    assert eb.erasure_decode_block_words(code, 8) == 0
    assert eb.erasure_decode_block_words(code.expand(), 8) == 1
    assert eb.erasure_decode_block_words(_shape_code(600, 3, 6), 0) == 0


@pytest.mark.parametrize("words, num, wpb", [(768, 1, 1), (33, 1, 1),
                                             (64, 16, 4), (64, 16, 2),
                                             (24, 3, 8), (12, 4, 1)])
def test_block_split_covers_each_word_once(words, num, wpb):
    """erasure_decode.cu: block b holds words b * wpb onward of code b *
    wpb / wpc, read from the block-major planes the wrapper makes; every
    word of every row lands in one block, at its own code."""
    wpc = words // num
    blocks = words // wpb
    rows = 5
    plane = torch.arange(rows * words, dtype=torch.int32).reshape(rows, words)
    major = eb._plane_to_code_major(plane, blocks)       # [blocks * rows, wpb]
    seen = np.zeros((rows, words), np.int64)
    for b in range(blocks):
        code = b * wpb // wpc
        sl = major[b * rows:(b + 1) * rows].numpy()
        w = sl % words
        assert np.all(w // wpc == code)                  # one code a block
        assert np.array_equal(w, np.broadcast_to(
            b * wpb + np.arange(wpb), (rows, wpb)))
        np.add.at(seen, (sl // words, w), 1)
    assert np.all(seen == 1)
    assert torch.equal(eb._code_major_to_plane(major, blocks), plane)


def test_entry_points_match_the_sources():
    def params(src, name):
        body = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
        return [p.split()[-1].lstrip("*") for p in body.split(",")]

    d = (SOURCE_DIR / "erasure_decode.cu").read_text()
    k3 = (SOURCE_DIR / "variable_or_update.cu").read_text()
    assert params(d, "ldpc_erasure_decode") == [
        "erased", "chk_to_var", "known", "round_errors", "rounds",
        "num_blocks", "rows", "checks", "dc", "wpc", "wpb", "max_iters",
        "stream"]
    assert params(k3, "ldpc_variable_or_update") == [
        "known", "exactly_one", "var_to_chk", "errors_slot", "n", "m", "dv",
        "words", "wpc", "vec", "stream"]
    assert len(SIGNATURES["ldpc_erasure_decode"]) == 13
    assert len(SIGNATURES["ldpc_variable_or_update"]) == 11
    # D: a block's words belong to one code; its table is that code's
    assert "wpb < 1 || wpc < wpb || wpc % wpb" in d
    assert "const long long code = block * wpb / wpc;" in d
    # K3: K2's width rule and grid, the exact degree 3, the warp's count
    assert "vec == 4 && wpc % 4 == 0 &&\n       ldpc::qc::vector_ok(words, " \
        "{known, exactly_one})" in k3
    assert "ldpc::row_grid(n, words, vec, &blocks)" in k3
    for r in ("n", "m"):
        assert f"ldpc::row_grid_fits({r}, words, vec)" in k3
    assert re.search(r"constexpr int kExactDv = (\d+);", k3).group(1) == "3"
    assert "const bool exact = dv == kExactDv;" in k3
    assert "__reduce_add_sync(0xFFFFFFFFu, unknown)" in k3
    assert "if (threadIdx.x == 0 && v != 0) atomicAdd(a.errors_slot, v);" \
        in k3


# ---------------------------------------------------------------------------
# The one-code decode through D's plain route, against JAX and the host loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def npz_code(tmp_path_factory):
    """One (3,6) code of n = N drawn by JAX, saved once as npz and loaded
    by both packages."""
    path = str(tmp_path_factory.mktemp("code") / "code.npz")
    jstore.save_code(jax_sample_code(jax.random.key(21), N, 3, 6), path)
    return jstore.load_code(path), store.load_code(path)


def _jax_planes(eps, seed, n=N, words=WORDS):
    jplanes = jax_bec_packed_channel(jax.random.key(seed), eps, (n, words))
    return jplanes, torch.from_numpy(np.asarray(jplanes).view(np.int32)
                                     .copy())


def _route(monkeypatch):
    """The calls that reach kernel D's wrapper: (W, words a block)."""
    calls = []
    real = eb.erasure_decode

    def spy(erased, chk, var, max_iters, wpb=None):
        calls.append((erased.shape[1], wpb))
        return real(erased, chk, var, max_iters, wpb)

    monkeypatch.setattr(eb, "erasure_decode", spy)
    return calls


def _same(got, want):
    assert torch.equal(got.known, want.known)
    assert torch.equal(got.error_totals, want.error_totals)
    assert got.iterations == want.iterations


@pytest.mark.parametrize("eps", [0.0, 0.42, 1.0])
@pytest.mark.parametrize("max_iters", [0, 1, 50, N])
def test_one_code_equals_jax_and_the_host_loop(npz_code, monkeypatch, eps,
                                               max_iters):
    jcode, code = npz_code
    jplanes, planes = _jax_planes(eps, seed=int(eps * 100) + max_iters)
    calls = _route(monkeypatch)
    got = eb.bp_decode_packed_allzero(code, planes, max_iters)
    assert calls == [(WORDS, 1)]                      # D, one block a word
    want = jeb.bp_decode_packed_allzero(jcode, jplanes, max_iters)
    assert np.array_equal(got.known.numpy(),
                          np.asarray(want.known).view(np.int32))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    _same(got, eb.bp_decode_packed_allzero_plain(code, planes, max_iters))
    if eps == 1.0 and max_iters:
        assert got.iterations == 1                     # stalls at once
    if eps == 0.0:
        assert got.iterations == 0


def test_each_word_is_jax_decode_of_that_word(npz_code):
    # one block a word: a block's counts and rounds are JAX's decode of its
    # word alone; a word that stops early beside a stuck one, and the "one
    # more" round of the summed count when the last to move reaches zero
    jcode, code = npz_code
    rng = np.random.default_rng(4)
    bits = rng.random((N, WORDS, 32)) < np.array(
        [1.0, 0.3, 0.0, 0.42, 0.25, 0.45, 0.2, 0.3])[None, :, None]
    erased = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32)
    planes = torch.from_numpy(erased.view(np.int32).copy())
    known, round_errors, rounds = eb.erasure_decode(
        planes, code.chk_to_var[None], code.var_to_chk[None], 50, 1)
    per_word = jax.vmap(lambda e: jeb.bp_decode_packed_allzero(
        jcode, e[:, None], 50), in_axes=1)(jnp.asarray(erased))
    assert np.array_equal(round_errors.numpy(),
                          np.asarray(per_word.error_totals))
    assert np.array_equal(rounds.numpy(), np.asarray(per_word.iterations))
    assert np.array_equal(known.numpy(), np.asarray(per_word.known)[:, :, 0]
                          .T.view(np.int32))
    r = rounds.tolist()
    assert r[0] == 1 and r[2] == 0 and len(set(r)) > 3
    stuck = round_errors[:, -1] > 0
    assert bool(stuck[0]) and not bool(stuck.all())
    got = eb.bp_decode_packed_allzero(code, planes, 50)
    want = jeb.bp_decode_packed_allzero(jcode, jnp.asarray(erased), 50)
    assert got.iterations == int(want.iterations)
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    _same(got, eb.bp_decode_packed_allzero_plain(code, planes, 50))
    last_to_move = int(rounds[~stuck].max())
    assert got.iterations in (int(rounds.max()), last_to_move + 1)


@pytest.mark.parametrize("wpb", [1, 2, 4])
def test_a_batch_in_smaller_blocks_equals_a_block_a_code(wpb):
    # the split is exact at any block size of one code's words: the blocks'
    # counts summed by code are the per-code counts
    codes = sample_codes(5, 0, 4, 120, 3, 6)
    erased = bitops.bernoulli_packed(0.42, (120, 16), seed=3)
    whole = eb.erasure_decode(erased, codes.chk_to_var, codes.var_to_chk,
                              30)
    split = eb.erasure_decode(erased, codes.chk_to_var, codes.var_to_chk,
                              30, wpb)
    assert torch.equal(split[0], whole[0])
    assert torch.equal(split[1].reshape(4, 4 // wpb, -1).sum(1,
                                                             dtype=torch.int32),
                       whole[1])
    assert split[1].shape == (16 // wpb, 31)
    with pytest.raises(ValueError, match="split a code"):
        eb.erasure_decode(erased, codes.chk_to_var, codes.var_to_chk, 30, 3)


@pytest.mark.parametrize("eps", [0.42, 1.0])
@pytest.mark.parametrize("max_iters", [1, 50])
def test_irregular_one_code_equals_jax(monkeypatch, eps, max_iters):
    n = 300
    jcode = JaxSpec.from_lam_rho(n, LAM, RHO).sample(jax.random.key(8))
    code = irregular_code_from_numpy(
        *(np.asarray(getattr(jcode, f))
          for f in ("chk_to_var", "var_to_chk", "var_to_sock")),
        jcode.n, jcode.m)
    jplanes, planes = _jax_planes(eps, seed=9, n=n)
    calls = _route(monkeypatch)
    got = eb.bp_decode_packed_allzero_irregular(code, planes, max_iters)
    assert calls == [(WORDS, 1)]
    want = jeb.bp_decode_packed_allzero_irregular(jcode, jplanes, max_iters)
    assert np.array_equal(got.known.numpy(),
                          np.asarray(want.known).view(np.int32))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)
    _same(got, eb._strip_phantom(eb.bp_decode_packed_allzero_plain(
        eb._phantom_view(code), eb._pad_phantom_row(planes), max_iters)))


# ---------------------------------------------------------------------------
# K3's item path as a numpy model
# ---------------------------------------------------------------------------

def _grid(rows, words, vec):
    """common.cuh row_grid / row_item: (row, w, thread index) of every
    live thread of the 1-D grid, in launch order."""
    groups = words // vec
    blocks = -(-(rows * groups) // KTHREADS)
    i = np.arange(blocks * KTHREADS)
    row = i // groups
    w = (i - row * groups) * vec
    live = row < rows
    return row[live], w[live], i[live]


def _k3_model(var, ex, known, vec):
    """variable_or_update.cu on numpy uint32 planes: per item of ``vec``
    words, the variable's dv table entries (of its code: word w of code w
    // wpc for a batch's [C, n, dv] table) loaded once, the summary rows
    gathered at 32-bit offsets and ORed in, the gathers and the store
    skipped when all ``vec`` words are full; each thread's popcount of
    ~known summed a block of kThreads threads (one atomic a block with a
    nonzero sum).  Returns (known after, the count, the items skipped)."""
    n, words = known.shape
    num = var.shape[0] if var.ndim == 3 else 1
    dv = var.shape[-1]
    wpc = words // num
    flat_var = var.reshape(-1, dv)
    lanes = np.arange(vec)
    v, w, thread = _grid(n, words, vec)
    at = (v * words + w)[:, None] + lanes
    assert at.max() < 2 ** 30
    out = known.ravel().copy()
    k = out[at]
    open_ = (k != np.uint32(0xFFFFFFFF)).any(1)
    rows = flat_var[(w // wpc) * n + v]                 # [items, dv]
    assert (w // wpc * n + v).max() * dv < 2 ** 31
    ef = ex.ravel()
    acc = np.zeros_like(k)
    for p in range(dv):
        off = rows[:, p].astype(np.int64) * words
        assert off.max() < 2 ** 31
        acc |= ef[(w + off)[:, None] + lanes]
    # a skipped item's words already know every trial: the OR adds nothing
    assert np.array_equal(k[~open_] | acc[~open_], k[~open_])
    new = np.where(open_[:, None], k | acc, k)
    out[at[open_]] = new[open_]
    assert np.unique(at).size == at.size == n * words
    pop = np.unpackbits((~new).view(np.uint8), axis=1).sum(1)
    block_sums = np.bincount(thread // KTHREADS, weights=pop) \
        .astype(np.int64)
    return (out.reshape(n, words), int(block_sums[block_sums != 0].sum()),
            int((~open_).sum()))


def _state(var_rows, words, eps, seed):
    bits = np.random.default_rng(seed).random((var_rows, 32 * words)) < eps
    return bitops.pack_bits(torch.from_numpy(bits))


def _u(t):
    return t.numpy().view(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


@pytest.mark.parametrize("kind", ["regular", "irregular"])
@pytest.mark.parametrize("words, align", [(8, 16), (8, 8), (7, 16),
                                          (36, 16), (1, 16)])
def test_k3_model_equals_plain_and_jax_round_after_round(kind, words,
                                                         align):
    """Rounds of a decode: K2's plain pass, then K3's model, equal the
    plain K3, the wrapper's CPU path and JAX's one-round
    ``_packed_iteration_allzero``; dv 3 runs the exact instantiation, the
    irregular phantom view (dv_max 4) the socket loop."""
    n = 300
    if kind == "regular":
        jview = jax_sample_code(jax.random.key(words), n, 3, 6)
        view = code_from_numpy(np.asarray(jview.chk_to_var), n, 3, 6)
    else:
        jcode = JaxSpec.from_lam_rho(n, LAM, RHO).sample(
            jax.random.key(words))
        code = irregular_code_from_numpy(
            *(np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")),
            jcode.n, jcode.m)
        view, jview = eb._phantom_view(code), jeb._phantom_view(jcode)
    dv = view.var_to_chk.shape[-1]
    assert dv == (3 if kind == "regular" else 4)
    rows = view.var_to_chk.shape[0]
    vec = eb.check_exactly_one_vector(words, align)
    erased = _state(rows, words, 0.3, seed=words)
    if kind == "irregular":
        erased[-1] = 0                           # the phantom is known
    known = _u(~erased).copy()
    skipped = 0
    for _ in range(8):
        ex = eb._check_exactly_one_plain(view.chk_to_var, _t(known))
        got, count, skips = _k3_model(view.var_to_chk.numpy(), _u(ex),
                                      known, vec)
        skipped += skips
        for fn in (eb._variable_or_update_plain, eb.variable_or_update):
            k, errors = _t(known), torch.zeros(2, dtype=torch.int32)
            fn(view.var_to_chk, ex, k, errors, 1)
            assert np.array_equal(got, _u(k)) and int(errors[1]) == count
        want = jeb._packed_iteration_allzero(jview, jnp.asarray(known))
        assert np.array_equal(got, np.asarray(want))
        known = got
    assert skipped > 0                            # items that know it all


@pytest.mark.parametrize("wpc, num, align", [(3, 8, 16), (6, 4, 16),
                                             (1, 16, 16), (8, 4, 16),
                                             (8, 4, 8), (4, 2, 16)])
def test_k3_model_batched_equals_plain(wpc, num, align):
    """K3's model on a batch's tables (word w of code w // wpc) equals the
    plain version code by code; N = 4 only where 4 divides a code's
    words."""
    codes = sample_codes(7, 0, num, 120, 3, 6)
    words = wpc * num
    vec = eb.check_exactly_one_vector(wpc, align)
    assert vec == (4 if wpc % 4 == 0 and align == 16 else 1)
    known = ~_state(120, words, 0.4, seed=wpc)
    ex = eb._check_exactly_one_plain(codes.chk_to_var, known)
    got, count, _ = _k3_model(codes.var_to_chk.numpy(), _u(ex), _u(known),
                              vec)
    k, errors = known.clone(), torch.zeros(2, dtype=torch.int32)
    eb._variable_or_update_plain(codes.var_to_chk, ex, k, errors, 1)
    assert np.array_equal(got, _u(k)) and int(errors[1]) == count
