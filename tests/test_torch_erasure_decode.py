"""Kernel D's plain version (the whole all-zero erasure-BP decode, one
code at a time) against the JAX package's vmapped decode, and the rule and
host assembly around it.

The codes are drawn in JAX and carried over as numpy tables, the erased
planes are drawn with numpy, so both packages decode the same input.
Each code of a batch gets its own erasure probability (0, 1, below and
above the (3,6) threshold), so the codes stop on different rounds, some
with erasures left.  ``round_errors``, ``rounds`` and the final known
planes must equal JAX's per-code ``error_totals``, ``iterations`` and
``known`` bit for bit; the summed totals and ``iterations`` the batched
host loop's (module docstring of ``ops/erasure_bp.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import \
    sample_codes as jax_sample_codes
from iib_project_ldpc_codes_tpu.ops import erasure_bp as jeb
from iib_project_ldpc_codes_tpu_torch.models import ensemble, qc
from iib_project_ldpc_codes_tpu_torch.models.code import (LDPCCode,
                                                          codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_codes_from_numpy
from iib_project_ldpc_codes_tpu_torch.ops import bitops
from iib_project_ldpc_codes_tpu_torch.ops import erasure_bp as eb
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc

# one erasure probability per code, cycled over the batch
EPS = (0.0, 1.0, 0.2, 0.35, 0.4, 0.42, 0.45, 0.5)
ITERS = 30
BEC_LAM, BEC_RHO = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]


def _erased(n, num, wpc, seed=0):
    """uint32[n, num * wpc]: code g's words erased at EPS[g % 8]."""
    rng = np.random.default_rng(seed)
    p = np.repeat([EPS[g % len(EPS)] for g in range(num)], wpc)
    bits = rng.random((n, num * wpc, 32)) < p[None, :, None]
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32)


def _batch(family, num, n, seed=3):
    """(JAX codes, port codes, the port's decode view)."""
    key = jax.random.key(seed)
    if family == "regular":
        jcodes = jax_sample_codes(key, num, n, 3, 6)
        codes = codes_from_numpy(np.asarray(jcodes.chk_to_var), n, 3, 6)
        return jcodes, codes, codes
    jcodes = jir.IrregularEnsembleSpec.from_lam_rho(n, BEC_LAM, BEC_RHO) \
        .sample_batch(key, num)
    codes = irregular_codes_from_numpy(
        *(np.asarray(getattr(jcodes, f))
          for f in ("chk_to_var", "var_to_chk", "var_to_sock")),
        jcodes.n, jcodes.m)
    return jcodes, codes, eb._phantom_view(codes)


def _jax_per_code(family, jcodes, erased, num, max_iters):
    """JAX's vmapped decode of each code on its own words."""
    per_code = jnp.asarray(erased.reshape(erased.shape[0], num, -1)
                           .transpose(1, 0, 2))
    fn = jeb.bp_decode_packed_allzero if family == "regular" else \
        jeb.bp_decode_packed_allzero_irregular
    return jax.vmap(lambda c, e: fn(c, e, max_iters))(jcodes, per_code)


def _as_port(erased):
    return torch.from_numpy(erased.view(np.int32).copy())


@pytest.mark.parametrize("family, num, n", [("regular", 16, 240),
                                            ("regular", 8, 1024),
                                            ("irregular", 16, 600)])
@pytest.mark.parametrize("wpc", [1, 2])
@pytest.mark.parametrize("max_iters", [0, 1, ITERS])
def test_plain_equals_jax_vmap(family, num, n, wpc, max_iters):
    jcodes, _, view = _batch(family, num, n)
    erased = _erased(n, num, wpc)
    want = _jax_per_code(family, jcodes, erased, num, max_iters)
    planes = _as_port(erased)
    if family == "irregular":
        planes = eb._pad_phantom_row(planes)
    known, round_errors, rounds = eb.erasure_decode(
        planes, view.chk_to_var, view.var_to_chk, max_iters)
    assert np.array_equal(round_errors.numpy(), np.asarray(want.error_totals))
    assert np.array_equal(rounds.numpy(), np.asarray(want.iterations))
    if family == "irregular":
        assert bool((known[-1] == -1).all())       # the phantom row
        known = known[:-1]
    want_known = np.asarray(want.known).transpose(1, 0, 2) \
        .reshape(n, -1).view(np.int32)
    assert np.array_equal(known.numpy(), want_known)
    stops = np.asarray(want.iterations)
    assert stops[0] == 0                     # no erasure: no round
    if max_iters == ITERS:
        # eps = 1 stalls after one round; the others on rounds of their own
        assert stops[1] == 1 and len(set(stops.tolist())) > 3


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("wpc", [1, 2])
def test_sums_equal_the_batched_host_loop(family, wpc):
    _, codes, _ = _batch(family, 16, 600 if family == "irregular" else 504)
    erased = _as_port(_erased(codes.n, 16, wpc, seed=wpc))
    fns = (eb.bp_decode_packed_allzero, eb.bp_decode_packed_allzero_plain) \
        if family == "regular" else \
        (eb.bp_decode_packed_allzero_irregular,
         lambda c, e, it: eb._strip_phantom(eb.bp_decode_packed_allzero_plain(
             eb._phantom_view(c), eb._pad_phantom_row(e), it)))
    for max_iters in (0, 1, 2, ITERS):
        got, want = (fn(codes, erased, max_iters) for fn in fns)
        assert torch.equal(got.known, want.known)
        assert torch.equal(got.error_totals, want.error_totals)
        assert got.iterations == want.iterations


def test_one_more_round_when_the_last_code_to_move_reaches_zero():
    # code 0 stalls with every bit erased, code 1 decodes to zero on its
    # last round: the summed count changes on that round, so the host loop
    # needs one more, unchanged round to stop (PackedBPResult.iterations)
    codes = ensemble.sample_codes(0, 0, 2, 1024, 3, 6, "repair")
    rng = np.random.default_rng(1)
    bits = np.zeros((1024, 2, 32), bool)
    bits[:, 0] = True
    bits[:, 1] = rng.random((1024, 32)) < 0.3
    erased = _as_port((bits.astype(np.uint64)
                       << np.arange(32, dtype=np.uint64)).sum(-1)
                      .astype(np.uint32))
    _, round_errors, rounds = eb.erasure_decode(
        erased, codes.chk_to_var, codes.var_to_chk, ITERS)
    assert rounds.tolist()[0] == 1 and 1 < rounds.tolist()[1] < ITERS
    assert round_errors[1, -1] == 0 and round_errors[0, -1] > 0
    got = eb.bp_decode_packed_allzero(codes, erased, ITERS)
    want = eb.bp_decode_packed_allzero_plain(codes, erased, ITERS)
    assert got.iterations == want.iterations == int(rounds.max()) + 1
    assert torch.equal(got.error_totals, want.error_totals)
    assert torch.equal(got.error_totals, round_errors.sum(0, dtype=torch.int32))


def _shape_code(num, n, dv, dc, irregular=False):
    """A code (a batch when ``num``) with the tables' shapes only
    (expanded views, no memory): what the rule reads.  An irregular code
    of dv_max = ``dv`` has the (3,6) rate's n / 2 checks, as the
    repository's (x/3 + 2x^3/3, x^5) pair."""
    rows = n + irregular
    m = (n // 2 if irregular else n * dv // dc) + irregular
    zero = torch.zeros((1, 1, 1), dtype=torch.int32)
    lead = (num,) if num else ()
    chk = zero.expand(max(num, 1), m, dc).reshape(*lead, m, dc) \
        if num else zero[0].expand(m, dc)
    var = zero.expand(max(num, 1), rows, dv).reshape(*lead, rows, dv) \
        if num else zero[0].expand(rows, dv)
    if irregular:
        return eb._PhantomView(chk_to_var=chk, var_to_chk=var, n=rows)
    return LDPCCode(chk_to_var=chk, var_to_edge=var, n=n, dv=dv, dc=dc,
                    var_to_chk=var)


@pytest.mark.parametrize("num, n, dv, dc, irregular, words, takes", [
    # the ensemble chunks at one word per code: n = 10^4, 768 codes
    (768, 10_000, 3, 6, False, 768, True),
    (768, 10_000, 4, 6, True, 768, True),      # the phantom view
    (256, 1024, 3, 6, False, 256, True),       # the n = 1024 anchors
    (16, 1024, 3, 6, False, 64, True),         # 4 words a code
    (1, 1024, 3, 6, False, 4, True),           # a batch of one code
    # phase 9's wpc-24 batch keeps K2/K3
    (32, 10_000, 3, 6, False, 768, False),
    # one code (no [C] axis): one block a word, the fixed path at 768 words
    (0, 10_000, 3, 6, False, 768, True),
    (0, 1024, 3, 6, False, 1, True),
    # too large for one block at one word a code
    (8, 16_384, 3, 6, False, 8, False),
    # words that do not split over the codes: K2 raises
    (3, 1024, 3, 6, False, 4, False)])
def test_rule(num, n, dv, dc, irregular, words, takes):
    code = _shape_code(num, n, dv, dc, irregular)
    assert eb.takes_erasure_decode_kernel(code, words) is takes
    if not num or words % num == 0:
        wpb = words // num if num else 1
        need = eb._erasure_decode_smem_bytes(
            code.n, code.chk_to_var.shape[-2], dc, wpb)
        assert (need <= eb.SMEM_OPTIN_BYTES) is takes
        assert eb.erasure_decode_block_words(code, words) == \
            (wpb if takes else 0)


def test_rule_at_the_edge_of_shared_memory():
    # the largest (3,6) code of one word that fits, and the next size up
    edge = max(n for n in range(6, 40_000, 6)
               if eb._erasure_decode_smem_bytes(n, n // 2, 6, 1)
               <= eb.SMEM_OPTIN_BYTES)
    assert 10_000 <= edge
    assert eb.takes_erasure_decode_kernel(_shape_code(4, edge, 3, 6), 4)
    assert not eb.takes_erasure_decode_kernel(_shape_code(4, edge + 6, 3, 6),
                                              4)
    # the headline shape: (3,6), n = 10^4, one word
    assert eb._erasure_decode_smem_bytes(10_000, 5000, 6, 1) == 185_016


def test_rule_on_the_paths(monkeypatch):
    # which decodes reach kernel D's wrapper: the ensemble chunk (twice
    # when expurgated) and a fixed code (one block a word), not a QC code
    # or the plain decode
    calls = []
    real = eb.erasure_decode

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(eb, "erasure_decode", spy)
    codes = ensemble.sample_codes(0, 0, 8, 504, 3, 6, "repair")
    erased = bitops.bernoulli_packed(0.42, (504, 8), seed=1)
    mc._bp_chunk(codes, erased, iterations=20, expurgation=None)
    assert len(calls) == 1
    mc._bp_chunk(codes, erased, iterations=20, expurgation=1)
    assert len(calls) == 3
    mc._bp_chunk(codes.select(0), erased, iterations=20, expurgation=None)
    assert len(calls) == 4
    qc_code = qc.sample_qc_code(torch.Generator().manual_seed(0), nb=12,
                                dv=3, dc=6, Z=10)
    mc._bp_chunk(qc_code, bitops.bernoulli_packed(0.4, (qc_code.n, 1),
                                                  seed=2),
                 iterations=20, expurgation=None)
    eb.bp_decode_packed_allzero_plain(codes, erased, 20)
    assert len(calls) == 4
    # a batch of codes too large for one block runs K2/K3
    wide = erased.repeat(1, 300)                 # 300 words a code
    assert not eb.takes_erasure_decode_kernel(codes, wide.shape[1])
    eb.bp_decode_packed_allzero(codes, wide, 5)
    assert len(calls) == 4


def test_contract_errors():
    codes = ensemble.sample_codes(0, 0, 4, 120, 3, 6, "repair")
    erased = bitops.bernoulli_packed(0.4, (120, 8), seed=1)
    args = (codes.chk_to_var, codes.var_to_chk)
    with pytest.raises(ValueError, match="rank 3"):
        eb.erasure_decode(erased, codes.chk_to_var[0], codes.var_to_chk, 5)
    with pytest.raises(ValueError, match="split evenly"):
        eb.erasure_decode(erased[:, :6].contiguous(), *args, 5)
    with pytest.raises(ValueError, match="do not fit together"):
        eb.erasure_decode(erased[:100].contiguous(), *args, 5)
    with pytest.raises(ValueError, match="do not fit together"):
        eb.erasure_decode(erased, codes.chk_to_var, codes.var_to_chk[:2], 5)
    with pytest.raises(ValueError, match="max_iters"):
        eb.erasure_decode(erased, *args, -1)
    with pytest.raises(TypeError, match="int32"):
        eb.erasure_decode(erased.to(torch.int64), *args, 5)
