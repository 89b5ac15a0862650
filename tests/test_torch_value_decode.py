"""The random-transmit BEC decode on kernel D's value form, on the CPU.

Kernel D's value form (``csrc/erasure_decode.cu``, ``kValues``;
``ops/erasure_bp.py::erasure_decode_values``) runs the whole decode of
JAX's ``bp_decode_packed`` one block per block of a code's words, with
the val plane beside known in shared memory.  Here:

  * its rule, ``erasure_decode_block_words(..., values=True)``, on a table
    of shapes: the (3,6) one-word limit n = 10,330 (the all-zero form's
    12,562 unchanged), phantom views, batches, QC codes refused;
  * its plain version (the kernel's oracle on the card) held bit for bit
    -- ``known``, ``val``, each block's counts and rounds -- against JAX's
    ``bp_decode_packed`` of each word alone, and of each code of a batch
    under ``vmap``, at eps 0, 0.42 and 1, budgets 0, 1 and 50 and words
    that stop before the budget beside a stuck one, with ``tx`` planes
    that are codewords and random planes that are not (two checks then
    teach one bit different values in one round, and both are ORed in);
  * whole decodes through ``bp_decode_packed`` and
    ``bp_decode_packed_irregular`` by the rule against JAX and the host
    loop over the plain passes, and the ``_traj`` forms, which keep the
    host loop;
  * a numpy model of the kernel's round -- the check pass ORing each
    taught value into val at once, in any order of the checks, then the
    scatter of known -- against the plain passes and JAX's
    ``_packed_iteration``;
  * the wrapper's contract and the entry point against the source.

The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code, sample_codes as jax_sample_codes)
from iib_project_ldpc_codes_tpu.ops import erasure_bp as jeb
from iib_project_ldpc_codes_tpu_torch.kernels.build import (SIGNATURES,
                                                            SOURCE_DIR)
from iib_project_ldpc_codes_tpu_torch.models import encode, qc
from iib_project_ldpc_codes_tpu_torch.models.code import (LDPCCode,
                                                          code_from_numpy,
                                                          codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_code_from_numpy
from iib_project_ldpc_codes_tpu_torch.ops import bitops
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp as eb

N, WORDS = 240, 8
LAM, RHO = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

def _shape_code(n, dv, dc, num=0, irregular=False):
    """A code (a batch when ``num``) with the tables' shapes only; an
    irregular code has n / 2 checks and its phantom row and check."""
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


def _edge(values):
    return max(n for n in range(2, 40_000, 2)
               if eb._erasure_decode_smem_bytes(n, n // 2, 6, 1, values)
               <= eb.SMEM_OPTIN_BYTES)


def test_one_word_limit_of_the_value_form():
    # (3,6) at one word: 22.5 bytes a variable and 16 of counters; the val
    # plane moves the limit from n = 12,562 to 10,330
    assert _edge(False) == 12_562
    assert _edge(True) == 10_330
    assert eb._erasure_decode_smem_bytes(10_330, 5165, 6, 1, True) == \
        232_441 <= eb.SMEM_OPTIN_BYTES
    assert eb._erasure_decode_smem_bytes(10_332, 5166, 6, 1, True) == \
        232_486 > eb.SMEM_OPTIN_BYTES
    # the headline shape: 225,016 bytes, the all-zero form's plus n words
    assert eb._erasure_decode_smem_bytes(10_000, 5000, 6, 1, True) == \
        225_016 == eb._erasure_decode_smem_bytes(10_000, 5000, 6, 1) \
        + 10_000 * 4


@pytest.mark.parametrize("n, words, wpb, wpb_allzero", [
    (10_000, 768, 1, 1),           # the headline: 768 blocks of one word
    (10_330, 768, 1, 1),           # the value form's one-word limit
    (10_332, 768, 0, 1),           # the next n: the row-5 host loop
    (12_562, 8, 0, 1),             # the all-zero limit
    (1_000_000, 48, 0, 0),
    (600, 33, 1, 1)])
def test_value_rule_on_one_code(n, words, wpb, wpb_allzero):
    code = _shape_code(n, 3, 6)
    assert eb.erasure_decode_block_words(code, words, values=True) == wpb
    assert eb.takes_erasure_decode_kernel(code, words, values=True) is \
        (wpb > 0)
    assert eb.erasure_decode_block_words(code, words) == wpb_allzero


@pytest.mark.parametrize("n, words, wpb", [
    (10_000, 768, 1),              # the fixed irregular random decode
    (10_328, 8, 1),
    (10_330, 8, 0)])               # the phantom row and check tip it over
def test_value_rule_on_an_irregular_phantom_view(n, words, wpb):
    view = _shape_code(n, 4, 6, irregular=True)
    assert eb.erasure_decode_block_words(view, words, values=True) == wpb


@pytest.mark.parametrize("num, n, words, wpb", [
    (768, 10_000, 768, 1),         # one word a code: one block a code
    (32, 2048, 768, 0),            # the random ensemble chunk: 24 words
    (32, 2048, 96, 3),
    (16, 1024, 64, 4),
    (3, 1024, 4, 0)])              # words that do not split over codes
def test_value_rule_on_a_batch_keeps_a_block_a_code(num, n, words, wpb):
    assert eb.erasure_decode_block_words(_shape_code(n, 3, 6, num), words,
                                         values=True) == wpb


def test_value_rule_refuses_a_qc_code_and_no_words():
    code = qc.sample_qc_code(torch.Generator().manual_seed(0), nb=12, dv=3,
                             dc=6, Z=10)
    assert eb.erasure_decode_block_words(code, 8, values=True) == 0
    assert eb.erasure_decode_block_words(code.expand(), 8, values=True) == 1
    assert eb.erasure_decode_block_words(_shape_code(600, 3, 6), 0,
                                         values=True) == 0


# ---------------------------------------------------------------------------
# Codes, planes and JAX's decodes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX code, port code) of one (3,6) code of n = N drawn by JAX."""
    jcode = jax_sample_code(jax.random.key(31), N, 3, 6)
    return jcode, code_from_numpy(np.asarray(jcode.chk_to_var), N, 3, 6)


@pytest.fixture(scope="module")
def irregular_pair():
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(300, LAM, RHO).sample(
        jax.random.key(32))
    return jcode, irregular_code_from_numpy(
        *(np.asarray(getattr(jcode, f))
          for f in ("chk_to_var", "var_to_chk", "var_to_sock")),
        jcode.n, jcode.m)


def _planes(shape, probs, seed):
    """int32 planes whose word w erases each bit with ``probs[w]`` (numpy's
    generator)."""
    bits = np.random.default_rng(seed).random(shape + (32,)) < \
        np.resize(np.asarray(probs, float), shape[1])[None, :, None]
    return torch.from_numpy(
        (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        .astype(np.uint32).view(np.int32))


def _tx(code, words, kind, seed):
    """Codewords from the port's encoder, or random planes that are not."""
    if kind == "random":
        return _planes((code.n, words), [0.5], seed)
    planes = encode.code_encoder_planes(code)
    return encode.encode_packed(planes, bitops.info_planes(
        planes.k, words, seed=seed))


def _j(t):
    return jnp.asarray(t.numpy().view(np.uint32))


def _u(x):
    return np.asarray(x).view(np.int32)


def _per_word_jax(jcode, erased, tx, max_iters, decode=jeb.bp_decode_packed):
    """JAX's decode of each word alone: fields with the word first."""
    return jax.vmap(lambda e, t: decode(jcode, e[:, None], t[:, None],
                                        max_iters),
                    in_axes=(1, 1))(_j(erased), _j(tx))


def _is_codeword(code, tx):
    syndrome = torch.zeros((code.chk_to_var.shape[-2], tx.shape[1]),
                           dtype=torch.int32)
    for j in range(code.chk_to_var.shape[-1]):
        syndrome ^= tx.index_select(0, code.chk_to_var[:, j])
    return not bool(syndrome.any())


def _taught_two_values(code, erased, tx):
    """Whether the first round has a (variable, trial) that two checks
    teach different values (the case the kernel must OR, not pick)."""
    known = ~erased
    ex, adopt = eb._check_exactly_one_xor_plain(code.chk_to_var, known,
                                                tx & known)
    var = code.var_to_chk
    e = [ex.index_select(0, var[:, j]) for j in range(var.shape[1])]
    a = [adopt.index_select(0, var[:, j]) for j in range(var.shape[1])]
    clash = torch.zeros_like(known)
    for i in range(len(e)):
        for k in range(i + 1, len(e)):
            clash |= e[i] & e[k] & (a[i] ^ a[k])
    return bool((clash & ~known).any())


# ---------------------------------------------------------------------------
# The plain value form, a block a word, against JAX's decode of each word
# ---------------------------------------------------------------------------

def _against_per_word(jcode, code, erased, tx, max_iters):
    known, val, round_errors, rounds = eb.erasure_decode_values(
        erased, tx, code.chk_to_var[None], code.var_to_chk[None], max_iters,
        1)
    want = _per_word_jax(jcode, erased, tx, max_iters)
    assert np.array_equal(known.numpy(), _u(want.known)[:, :, 0].T)
    assert np.array_equal(val.numpy(), _u(want.val)[:, :, 0].T)
    assert np.array_equal(round_errors.numpy(),
                          np.asarray(want.error_totals))
    assert np.array_equal(rounds.numpy(), np.asarray(want.iterations))
    return rounds, round_errors


@pytest.mark.parametrize("kind", ["codeword", "random"])
@pytest.mark.parametrize("eps", [0.0, 0.42, 1.0])
@pytest.mark.parametrize("max_iters", [0, 1, 50])
def test_value_form_equals_jax_word_by_word(pair, kind, eps, max_iters):
    jcode, code = pair
    tx = _tx(code, WORDS, kind, seed=3)
    assert _is_codeword(code, tx) is (kind == "codeword")
    erased = _planes((N, WORDS), [eps], seed=int(eps * 100) + max_iters)
    rounds, _ = _against_per_word(jcode, code, erased, tx, max_iters)
    if eps == 0.0 or max_iters == 0:
        assert int(rounds.max()) == 0
    elif eps == 1.0:
        assert bool((rounds == 1).all())              # stalls at once


@pytest.mark.parametrize("kind", ["codeword", "random"])
def test_value_form_words_stop_apart(pair, kind):
    # a word every bit of which is erased (stuck), one with none erased,
    # and words that reach zero or stall before the budget
    jcode, code = pair
    tx = _tx(code, WORDS, kind, seed=4)
    erased = _planes((N, WORDS), [1.0, 0.3, 0.0, 0.42, 0.25, 0.45, 0.2, 0.3],
                     seed=5)
    rounds, round_errors = _against_per_word(jcode, code, erased, tx, 50)
    r = rounds.tolist()
    assert r[0] == 1 and r[2] == 0 and len(set(r)) > 3 and max(r) < 50
    stuck = round_errors[:, -1] > 0
    assert bool(stuck[0]) and not bool(stuck.all())
    if kind == "random":
        assert _taught_two_values(code, erased, tx)


@pytest.mark.parametrize("wpb", [None, 1])
def test_value_form_on_a_batch_equals_jax_vmap(wpb):
    num, wpc = 4, 2
    jcodes = jax_sample_codes(jax.random.key(33), num, N, 3, 6)
    codes = codes_from_numpy(np.asarray(jcodes.chk_to_var), N, 3, 6)
    tx = _tx(codes, num * wpc, "random", seed=6)
    erased = _planes((N, num * wpc), [0.42, 0.3, 1.0, 0.45], seed=7)
    known, val, round_errors, rounds = eb.erasure_decode_values(
        erased, tx, codes.chk_to_var, codes.var_to_chk, 40, wpb)

    def split(t):
        return _j(t).reshape(N, num, wpc).transpose(1, 0, 2)

    want = jax.vmap(lambda c, e, t: jeb.bp_decode_packed(c, e, t, 40))(
        jcodes, split(erased), split(tx))
    for got, field in ((known, "known"), (val, "val")):
        joined = np.asarray(getattr(want, field)).transpose(1, 0, 2) \
            .reshape(N, -1)
        assert np.array_equal(got.numpy(), _u(joined))
    per_code = round_errors.reshape(num, -1, 41).sum(1)
    assert np.array_equal(per_code.numpy(), np.asarray(want.error_totals))
    if wpb is None:
        assert np.array_equal(rounds.numpy(), np.asarray(want.iterations))
    else:
        assert torch.equal(rounds.reshape(num, wpc).max(1).values,
                           torch.from_numpy(np.array(want.iterations)))


@pytest.mark.parametrize("kind", ["codeword", "random"])
def test_value_form_on_a_phantom_view_equals_jax(irregular_pair, kind):
    jcode, code = irregular_pair
    tx = _tx(code, WORDS, kind, seed=8)
    erased = _planes((code.n, WORDS), [0.42, 0.0, 1.0, 0.3], seed=9)
    view = eb._phantom_view(code)
    known, val, round_errors, rounds = eb.erasure_decode_values(
        eb._pad_phantom_row(erased), eb._pad_phantom_row(tx),
        view.chk_to_var[None], view.var_to_chk[None], 50, 1)
    want = _per_word_jax(jcode, erased, tx, 50,
                         jeb.bp_decode_packed_irregular)
    assert np.array_equal(known[:-1].numpy(), _u(want.known)[:, :, 0].T)
    assert np.array_equal(val[:-1].numpy(), _u(want.val)[:, :, 0].T)
    assert bool((known[-1] == -1).all()) and not bool(val[-1].any())
    assert np.array_equal(round_errors.numpy(),
                          np.asarray(want.error_totals))
    assert np.array_equal(rounds.numpy(), np.asarray(want.iterations))


# ---------------------------------------------------------------------------
# Whole decodes by the rule against JAX and the host loop
# ---------------------------------------------------------------------------

def _route(monkeypatch):
    """The calls that reach the value form's wrapper: (W, words a block)."""
    calls = []
    real = eb.erasure_decode_values

    def spy(erased, tx, chk, var, max_iters, wpb=None):
        calls.append((erased.shape[1], wpb))
        return real(erased, tx, chk, var, max_iters, wpb)

    monkeypatch.setattr(eb, "erasure_decode_values", spy)
    return calls


def _same(got, want):
    for field in ("known", "val", "error_totals"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert got.iterations == want.iterations


def _same_as_jax(got, want):
    assert np.array_equal(got.known.numpy(), _u(want.known))
    assert np.array_equal(got.val.numpy(), _u(want.val))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals))
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("kind", ["codeword", "random"])
@pytest.mark.parametrize("eps, max_iters", [(0.42, 50), (0.42, 1),
                                            (0.42, 0), (0.0, 50),
                                            (1.0, 50), (0.3, 50)])
def test_one_code_equals_jax_and_the_host_loop(pair, irregular_pair,
                                               monkeypatch, family, kind,
                                               eps, max_iters):
    irr = family == "irregular"
    jcode, code = irregular_pair if irr else pair
    decode, plain, jdecode = (
        (eb.bp_decode_packed_irregular, eb.bp_decode_packed_irregular_plain,
         jeb.bp_decode_packed_irregular) if irr else
        (eb.bp_decode_packed, eb.bp_decode_packed_plain,
         jeb.bp_decode_packed))
    tx = _tx(code, WORDS, kind, seed=10)
    erased = _planes((code.n, WORDS), [eps], seed=11)
    calls = _route(monkeypatch)
    got = decode(code, erased, tx, max_iters)
    assert calls == [(WORDS, 1)]                 # kernel D, a block a word
    _same_as_jax(got, jdecode(jcode, _j(erased), _j(tx), max_iters))
    _same(got, plain(code, erased, tx, max_iters))
    assert calls == [(WORDS, 1)]                 # the plain decode: no D
    if kind == "codeword":
        assert not bool(((got.val ^ tx) & got.known).any())


def test_a_batch_decode_equals_jax_and_the_host_loop(monkeypatch):
    num, wpc = 4, 2
    jcodes = jax_sample_codes(jax.random.key(34), num, N, 3, 6)
    codes = codes_from_numpy(np.asarray(jcodes.chk_to_var), N, 3, 6)
    tx = _tx(codes, num * wpc, "random", seed=12)
    erased = _planes((N, num * wpc), [0.42, 0.3, 1.0, 0.0], seed=13)
    calls = _route(monkeypatch)
    got = eb.bp_decode_packed(codes, erased, tx, 50)
    assert calls == [(num * wpc, wpc)]           # one block a code
    _same(got, eb.bp_decode_packed_plain(codes, erased, tx, 50))
    want = jax.vmap(lambda c, e, t: jeb.bp_decode_packed(c, e, t, 50))(
        jcodes, *(_j(t).reshape(N, num, wpc).transpose(1, 0, 2)
                  for t in (erased, tx)))
    assert np.array_equal(got.error_totals.numpy(),
                          np.asarray(want.error_totals).sum(0))


@pytest.mark.parametrize("family", ["regular", "irregular"])
def test_traj_forms_keep_the_host_loop(pair, irregular_pair, monkeypatch,
                                       family):
    jcode, code = irregular_pair if family == "irregular" else pair
    traj = eb.bp_decode_packed_traj_irregular if family == "irregular" \
        else eb.bp_decode_packed_traj
    tx = _tx(code, WORDS, "random", seed=14)
    erased = _planes((code.n, WORDS), [0.42], seed=15)
    calls = _route(monkeypatch)
    res, rows = traj(code, erased, tx, 30)
    assert calls == []
    assert rows.shape == (31, 32 * WORDS)
    whole = (eb.bp_decode_packed_irregular if family == "irregular"
             else eb.bp_decode_packed)(code, erased, tx, 30)
    assert calls == [(WORDS, 1)]
    _same(whole, res)


# ---------------------------------------------------------------------------
# The kernel's round as a numpy model
# ---------------------------------------------------------------------------

def _model_round(chk, known, val, order):
    """erasure_decode.cu's value round on numpy uint32 planes of one code
    [rows, W]: the check pass over the checks in ``order`` (any order a
    block's threads may take), each check's exactly-one word e from its
    sockets' known words, x = XOR of val & known over its sockets, and e &
    ~known & x ORed into the val word of each socket at once (the atomic);
    then the scatter of e into known.  Returns (known, val, count)."""
    val = val.copy()
    ex = np.zeros((chk.shape[0], known.shape[1]), np.uint32)
    for c in order:
        rows = chk[c]
        unknown = ~known[rows]                              # [dc, W]
        once = np.zeros(known.shape[1], np.uint32)
        twice = np.zeros_like(once)
        for u in unknown:
            twice |= once & u
            once |= u
        e = once & ~twice
        ex[c] = e
        x = np.bitwise_xor.reduce(val[rows] & ~unknown, axis=0) & e
        for v, u in zip(rows, unknown):
            val[v] |= x & u
    grown = known.copy()
    for c in range(chk.shape[0]):
        for v in chk[c]:
            grown[v] |= ex[c] & ~known[v]
    count = int(np.unpackbits((~grown).view(np.uint8)).sum())
    return grown, val, count


@pytest.mark.parametrize("family", ["regular", "irregular"])
def test_model_round_equals_plain_and_jax_in_any_order(pair, irregular_pair,
                                                       family):
    irr = family == "irregular"
    jcode, code = irregular_pair if irr else pair
    view, jview = (eb._phantom_view(code), jeb._phantom_view(jcode)) \
        if irr else (code, jcode)
    words = 3
    erased = _planes((view.n, words), [0.42, 0.3, 0.45], seed=16)
    tx = _planes((view.n, words), [0.5], seed=17)
    if irr:
        erased[-1], tx[-1] = 0, 0
    chk = view.chk_to_var.numpy()
    known = (~erased).numpy().view(np.uint32)
    val = (tx & ~erased).numpy().view(np.uint32)
    rng = np.random.default_rng(18)
    for _ in range(6):
        got = [_model_round(chk, known, val, rng.permutation(len(chk)))
               for _ in range(2)]
        assert all(np.array_equal(a, b) for a, b in zip(got[0][:2],
                                                        got[1][:2]))
        k, v = torch.from_numpy(known.view(np.int32).copy()), \
            torch.from_numpy(val.view(np.int32).copy())
        errors = torch.zeros(2, dtype=torch.int32)
        ex, adopt = eb._check_exactly_one_xor_plain(view.chk_to_var, k, v)
        eb._variable_or_adopt_plain(view.var_to_chk, ex, adopt, k, v,
                                    errors, 1)
        assert np.array_equal(got[0][0], k.numpy().view(np.uint32))
        assert np.array_equal(got[0][1], v.numpy().view(np.uint32))
        assert got[0][2] == int(errors[1])
        jval, jknown = jeb._packed_iteration(jview, jnp.asarray(val),
                                             jnp.asarray(known))
        assert np.array_equal(got[0][0], np.asarray(jknown))
        assert np.array_equal(got[0][1], np.asarray(jval))
        known, val = got[0][0], got[0][1]


# ---------------------------------------------------------------------------
# The wrapper's contract and the entry point
# ---------------------------------------------------------------------------

def test_value_form_contract(pair):
    _, code = pair
    chk, var = code.chk_to_var[None], code.var_to_chk[None]
    erased = torch.zeros((N, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="differ in shape"):
        eb.erasure_decode_values(erased, erased[:, :2].contiguous(), chk,
                                 var, 5)
    with pytest.raises(TypeError, match="int32"):
        eb.erasure_decode_values(erased, erased.to(torch.int64), chk, var,
                                 5)
    with pytest.raises(ValueError, match="split a code"):
        eb.erasure_decode_values(erased, erased, chk, var, 5, 3)
    with pytest.raises(ValueError, match="max_iters"):
        eb.erasure_decode_values(erased, erased, chk, var, -1)
    with pytest.raises(ValueError, match="fit together"):
        eb.erasure_decode_values(erased[:-1].contiguous(),
                                 erased[:-1].contiguous(), chk, var, 5)
    with pytest.raises(ValueError, match="rank 3"):
        eb.erasure_decode_values(erased, erased, code.chk_to_var,
                                 code.var_to_chk, 5)


def test_entry_point_matches_the_source():
    src = (SOURCE_DIR / "erasure_decode.cu").read_text()
    body = re.search(r'extern "C" int ldpc_erasure_decode_values\(([^)]*)\)',
                     src).group(1)
    assert [p.split()[-1].lstrip("*") for p in body.split(",")] == [
        "erased", "tx", "chk_to_var", "known", "val", "round_errors",
        "rounds", "num_blocks", "rows", "checks", "dc", "wpc", "wpb",
        "max_iters", "stream"]
    assert len(SIGNATURES["ldpc_erasure_decode_values"]) == 15
    # the shared memory the wrapper checks is the kernel's
    assert "((values ? 2 : 1) * static_cast<size_t>(rows) + checks) * wpb" \
        in src
    assert "uint32_t* ex = known + (kValues ? 2 : 1) * words;" in src
    # the value OR in the check pass, masked by the socket's unknown bits
    assert "const uint32_t bits = x & unknown[j];" in src
    assert "if (bits != 0u) atomicOr(val + var[j] * wpb + w, bits);" in src
