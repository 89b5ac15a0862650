"""The Gallager round kernels' host rule and lane arithmetic on the CPU.

``gallager_round_vector`` (the words a thread of ``csrc/gallager_check.cu``
and ``csrc/gallager_variable.cu`` moves) on a table of shapes, and a numpy
model of the variable kernel's lane arithmetic -- a variable's loads of a
vector of words before its stores, count planes sized to the degree, the
two compares against t and t + 1, the errors against a codeword plane --
held against the plain version ``_gallager_variable_plain`` and JAX's
``_gallager_iteration`` (regular) or one-round irregular decode on the
same seeded input.  The kernels themselves, with their launch schedule,
run on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import \
    sample_code as jax_sample_code
from iib_project_ldpc_codes_tpu.ops import gallager as jg
from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_code_from_numpy
from iib_project_ldpc_codes_tpu_torch.ops import gallager
from iib_project_ldpc_codes_tpu_torch.ops.erasure_bp import _pad_phantom_row

MIXED = ([0, 0, 0.5, 0.5], [0, 0, 0, 0, 0.5, 0.5])   # dv 3/4, dc 5/6


@pytest.mark.parametrize("wpc, align, dv, want", [
    (768, 16, 3, 4),     # one (3,6) code at W = 768: 16-byte vectors
    (1, 16, 3, 1),       # 768 codes at one word: a vector is one code's word
    (33, 16, 3, 1),      # W odd
    (768, 4, 3, 1),      # a plane one word past a 16-byte boundary
    (768, 8, 3, 2),      # two words past it
    (768, 16, 4, 4),     # the dv 3/4 irregular pair (its table is 4 wide)
    (6, 16, 4, 2),       # 6 words a code
    (24, 16, 5, 1),      # no template: the generic path, one word a thread
    (24, 16, 9, 1),
    (768, 16, None, 4),  # the check pass
    (66, 16, None, 2),
])
def test_round_vector_rule(wpc, align, dv, want):
    assert gallager.gallager_round_vector(wpc, align, dv) == want


def test_round_vector_rule_refuses_sub_word_alignment():
    with pytest.raises(ValueError):
        gallager.gallager_round_vector(768, 2, 3)


def _count_at_least(planes, k):
    """csrc/gallager.cuh count_at_least on uint32 lanes (planes LSB
    first)."""
    full = np.uint32(0xFFFFFFFF)
    if k <= 0:
        return np.full_like(planes[0], full)
    if k >= 1 << len(planes):
        return np.zeros_like(planes[0])
    ge, eq = np.zeros_like(planes[0]), np.full_like(planes[0], full)
    for i in range(len(planes) - 1, -1, -1):
        if (k >> i) & 1:
            eq &= planes[i]
        else:
            ge |= eq & planes[i]
            eq &= ~planes[i]
    return ge | eq


def _variable_kernel_model(msg, parity, channel, table, active, decided,
                           counts, *, dc, pad_pos, threshold, clamp, vec,
                           tx=None):
    """gallager_variable.cu's lane arithmetic on numpy uint32 planes, in
    place: for each vector of ``vec`` words of an active code and each
    variable, every parity and message word it reads, then the count
    (planes sized to the degree: its bit width at the exact degrees,
    MAX_DEGREE's on the generic path), the new messages and the
    decision.  Also checks what the update in place rests on: a message
    row belongs to one (variable, socket) of a code's table."""
    n, words = channel.shape
    num = active.shape[0]
    wpc = words // num
    table = table.reshape(num, table.shape[-2], table.shape[-1])
    dv = table.shape[-1]
    planes_n = (dv if dv in gallager.EXACT_DEGREES
                else gallager.MAX_DEGREE).bit_length()
    for code in range(num):
        real = table[code, :n][table[code, :n] < pad_pos]
        assert np.unique(real).size == real.size, "a row of two sockets"
    for w in range(0, words, vec):
        code = w // wpc
        if not active[code]:
            continue
        cols = slice(w, w + vec)
        errors = changed = 0
        for v in range(n):
            socks = [int(s) for s in table[code, v] if s < pad_pos]
            ch = channel[v, cols]
            old = [msg[s, cols].copy() for s in socks]
            dis = [parity[s // dc, cols] ^ o ^ ch for s, o in zip(socks, old)]
            planes = [np.zeros(vec, np.uint32) for _ in range(planes_n)]
            for carry in dis:
                for q in range(planes_n):
                    planes[q], carry = planes[q] ^ carry, planes[q] & carry
            degree = len(socks)
            t = min(threshold, max(degree - 1, 1)) if clamp else threshold
            ge_t = _count_at_least(planes, t)
            ge_t1 = _count_at_least(planes, t + 1)
            for s, d, o in zip(socks, dis, old):
                out = ch ^ ((d & ge_t1) | (~d & ge_t))
                changed += int((out != o).sum())
                msg[s, cols] = out
            dec = ch ^ _count_at_least(planes, degree // 2 + 1)
            err = dec if tx is None else dec ^ tx[v, cols]
            errors += int(sum(bin(int(x)).count("1") for x in err))
            decided[v, cols] = dec
        counts[code] += (errors, changed)


def _regular_case(n, wpc, num, seed):
    """num JAX-drawn (3,6) codes (one table when num is 1), random messages
    and planes, as numpy."""
    rng = np.random.default_rng(seed)
    jcodes = [jax_sample_code(jax.random.key(seed + g), n, 3, 6)
              for g in range(num)]
    codes = [code_from_numpy(np.asarray(j.chk_to_var), n, 3, 6)
             for j in jcodes]
    table = np.stack([c.var_to_edge.numpy() for c in codes])
    words = wpc * num
    m = n // 2
    msg = rng.integers(0, 2**32, size=(m * 6, words), dtype=np.uint64) \
        .astype(np.uint32)
    return jcodes, codes, table, msg, rng


def _planes(rng, shape, p=0.5):
    bits = rng.random(shape + (32,)) < p
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32)


def _plain_pass(msg, parity, channel, table, active, decided, *, dc,
                pad_pos, threshold, clamp, tx=None):
    """_gallager_variable_plain on copies; returns (msg, decided, counts)
    as numpy uint32 / int64."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)
                                .copy())
    msg_t, dec_t = t(msg), t(decided)
    counts = torch.zeros((active.shape[0], 2), dtype=torch.int32)
    table_t = torch.from_numpy(table.astype(np.int32))
    if table_t.shape[0] == 1:
        table_t = table_t[0]
    gallager._gallager_variable_plain(
        msg_t, t(parity), t(channel), table_t,
        torch.from_numpy(active.astype(np.int32)), dec_t, counts, dc=dc,
        pad_pos=pad_pos, threshold=threshold, clamp=clamp,
        tx=None if tx is None else t(tx))
    return (msg_t.numpy().view(np.uint32), dec_t.numpy().view(np.uint32),
            counts.numpy().astype(np.int64))


@pytest.mark.parametrize("wpc, num, vec", [(8, 1, 4), (6, 1, 2), (1, 40, 1),
                                           (4, 9, 4), (3, 5, 1)])
@pytest.mark.parametrize("threshold, with_tx", [(2, False), (1, True)])
def test_variable_model_equals_plain_and_jax_iteration(wpc, num, vec,
                                                       threshold, with_tx):
    n = 60
    jcodes, codes, table, msg, rng = _regular_case(n, wpc, num, seed=wpc)
    words = wpc * num
    channel = _planes(rng, (n, words), 0.2)
    tx = _planes(rng, (n, words)) if with_tx else None
    active = (rng.random(num) < 0.7).astype(np.int64)
    active[0] = 1
    decided = _planes(rng, (n, words))
    parity = np.bitwise_xor.reduce(msg.reshape(-1, 6, words), axis=1)
    pad_pos = n // 2 * 6
    want = _plain_pass(msg, parity, channel, table, active, decided, dc=6,
                       pad_pos=pad_pos, threshold=threshold, clamp=False,
                       tx=tx)
    got_msg, got_dec = msg.copy(), decided.copy()
    got_counts = np.zeros((num, 2), np.int64)
    _variable_kernel_model(got_msg, parity, channel, table, active, got_dec,
                           got_counts, dc=6, pad_pos=pad_pos,
                           threshold=threshold, clamp=False, vec=vec, tx=tx)
    assert np.array_equal(got_msg, want[0])
    assert np.array_equal(got_dec, want[1])
    assert np.array_equal(got_counts, want[2])
    assert got_counts[:, 1].sum() > 0
    # JAX's round on (up to three) active codes' words: socket-major
    for g in np.flatnonzero(active)[:3]:
        cols = slice(g * wpc, (g + 1) * wpc)
        mvc = msg[:, cols].reshape(n // 2, 6, wpc).transpose(1, 0, 2)
        new_mvc, dec = jg._gallager_iteration(
            jcodes[g], jnp.asarray(channel[:, cols]), jnp.asarray(mvc),
            threshold)
        assert np.array_equal(
            np.asarray(new_mvc).transpose(1, 0, 2).reshape(-1, wpc),
            got_msg[:, cols])
        assert np.array_equal(np.asarray(dec), got_dec[:, cols])


@pytest.mark.parametrize("threshold", [None, 1])
@pytest.mark.parametrize("wpc, vec", [(8, 4), (1, 1)])
def test_variable_model_equals_plain_and_jax_on_irregular(threshold, wpc,
                                                          vec):
    # the dv 3/4 pair: the degree-4 template with padded sockets skipped,
    # the threshold clamped per degree; one round from the first messages
    n = 80
    jcode = jir.IrregularEnsembleSpec.from_lam_rho(n, *MIXED).sample(
        jax.random.key(5))
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    code = irregular_code_from_numpy(*tables, n, jcode.m)
    rng = np.random.default_rng(wpc)
    received = _planes(rng, (n, wpc), 0.08)
    rx = torch.from_numpy(received.view(np.int32).copy())
    msg = gallager._initial_messages(code.chk_to_var, _pad_phantom_row(rx)) \
        .numpy().view(np.uint32)
    dc = code.dc_max
    parity = np.bitwise_xor.reduce(msg.reshape(-1, dc, wpc), axis=1)
    table = code.var_to_sock.numpy()[None]
    b = code.dv_max if threshold is None else threshold
    active = np.ones(1, np.int64)
    kw = dict(dc=dc, pad_pos=code.m * dc, threshold=b, clamp=True)
    want = _plain_pass(msg, parity, received, table, active, received, **kw)
    got_msg, got_dec = msg.copy(), received.copy()
    got_counts = np.zeros((1, 2), np.int64)
    _variable_kernel_model(got_msg, parity, received, table, active, got_dec,
                           got_counts, vec=vec, **kw)
    assert np.array_equal(got_msg, want[0])
    assert np.array_equal(got_dec, want[1])
    assert np.array_equal(got_counts, want[2])
    one = jg.gallager_decode_packed_irregular(jcode, jnp.asarray(received),
                                              1, threshold=threshold)
    assert int(one.iterations) == 1
    assert np.array_equal(np.asarray(one.decided), got_dec)


@pytest.mark.parametrize("dv, words, vec", [(5, 3, 1), (5, 8, 1),
                                             (9, 3, 1)])
def test_variable_model_generic_degree_equals_plain(dv, words, vec):
    # (5,10) and (9,18) codes: no template, one word a thread, the count
    # in MAX_DEGREE's planes
    rng = np.random.default_rng(9)
    n = 40
    code = code_from_numpy(np.asarray(jax_sample_code(
        jax.random.key(9), n, dv, 2 * dv).chk_to_var), n, dv, 2 * dv)
    table = code.var_to_edge.numpy()[None]
    msg = rng.integers(0, 2**32, size=(n * dv, words), dtype=np.uint64) \
        .astype(np.uint32)
    parity = np.bitwise_xor.reduce(msg.reshape(-1, 2 * dv, words), axis=1)
    channel, decided = _planes(rng, (n, words), 0.2), _planes(rng, (n, words))
    active = np.ones(1, np.int64)
    kw = dict(dc=2 * dv, pad_pos=n * dv, threshold=dv // 2 + 1, clamp=False)
    want = _plain_pass(msg, parity, channel, table, active, decided, **kw)
    got_msg, got_dec = msg.copy(), decided.copy()
    got_counts = np.zeros((1, 2), np.int64)
    _variable_kernel_model(got_msg, parity, channel, table, active, got_dec,
                           got_counts, vec=vec, **kw)
    assert np.array_equal(got_msg, want[0])
    assert np.array_equal(got_dec, want[1])
    assert np.array_equal(got_counts, want[2])
