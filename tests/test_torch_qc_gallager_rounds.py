"""Q4, the QC Gallager variable pass, on the CPU: its launch rule and a
numpy model of its per-item arithmetic.

``qc_variable_layout`` (the words a thread of ``csrc/qc_gallager_variable.cu``
moves, its rows a thread and the degree passes of a launch) on a table of
shapes; the grid's cover of a plane and the rotation that stands for the
circulant index, across the z = s wrap; and a numpy model of the kernel --
exact-degree passes (count planes sized to the degree, the old messages
held from their one load and the changed words counted on them) and the
generic pass (MAX_DEGREE's planes, the sockets streamed twice), the t and
t + 1 compares, tx errors -- held against the plain version
``_qc_gallager_variable_plain`` and JAX's ``_qc_gallager_core`` for one
round.  Bases: the regular (3,6) nb = 12 base, the irregular nb = 24 base
(blocks of degree 3 and 4), and two hand-built bases with blocks of
degree 1 and 2.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import qc as jqc_mod
from iib_project_ldpc_codes_tpu.ops import qc_gallager as jqc_gallager
from iib_project_ldpc_codes_tpu_torch.kernels.build import SOURCE_DIR
from iib_project_ldpc_codes_tpu_torch.models import qc
from iib_project_ldpc_codes_tpu_torch.ops import qc_bp, qc_gallager
from iib_project_ldpc_codes_tpu_torch.ops.gallager import MAX_DEGREE

KTHREADS = 256                    # csrc/common.cuh kThreads
LAM_GAL, RHO6 = [0, 0, 0.5, 0.5], [0, 0, 0, 0, 0, 1.0]
# tests/test_torch_qc.py's hand-built irregular bases: (base, shifts, nb)
HAND = {"degree_one": ([[0, 1, 2], [0, 1, 3]], [[0, 1, 2], [3, 0, 1]], 4),
        "uniform_clamped": ([[0, 1, 2, 3], [0, 2, 4, 5], [1, 3, 4, 5]],
                            [[0, 1, 2, 3], [1, 2, 3, 0], [2, 3, 0, 1]], 6)}
BASES = ("regular", "irregular", "degree_one", "uniform_clamped")


# ---------------------------------------------------------------------------
# The launch rule, the grid, the rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degrees, words, align, want", [
    ([3] * 12, 768, 16, (4, 1, ("dv3",))),        # n ~ 10^4, W = 768
    ([3] * 12, 48, 16, (4, 1, ("dv3",))),         # n ~ 10^6, W = 48
    ([3, 4] * 12, 768, 16, (4, 1, ("dv3", "dv4"))),   # the irregular pair
    ([3] * 12, 70, 16, (1, 4, ("dv3",))),         # W not a multiple of 4
    ([3] * 12, 1, 16, (1, 4, ("dv3",))),
    ([3] * 12, 768, 8, (1, 4, ("dv3",))),         # a plane 8 bytes off
    ([3] * 12, 768, 4, (1, 4, ("dv3",))),
    ([2, 2, 1, 1], 2, 16, (1, 4, ("generic",))),  # degree 1 and 2 blocks
    ([2] * 6, 8, 16, (4, 1, ("generic",))),
    ([4, 2, 4], 8, 16, (4, 1, ("dv4", "generic"))),   # the BEC pair's
    ([5] * 12, 16, 16, (4, 1, ("generic",))),
    ([6, 3], 4, 16, (4, 1, ("dv3", "generic"))),
    ([MAX_DEGREE, 0], 3, 16, (1, 4, ("generic",))),
])
def test_variable_layout_rule(degrees, words, align, want):
    assert qc_gallager.qc_variable_layout(degrees, words, align) == want


def test_layout_constants_match_the_kernel_source():
    """The host rule's rows and exact degrees are the kernel's."""
    src = (SOURCE_DIR / "qc_gallager_variable.cu").read_text()
    wif = int(re.search(r"constexpr int kWordsInFlight = (\d+);",
                        src).group(1))
    assert wif == qc_gallager.QC_WORDS_IN_FLIGHT
    exact = tuple(int(d) for d in re.findall(
        r"degree == (\d+)\) \{\s*held_pass<N, \1, kTx>", src))
    assert exact == qc_gallager.QC_EXACT_DEGREES
    assert re.search(r"rows != kWordsInFlight / vec", src)


def _thread_vectors(items, rows):
    """The vectors of a plane each thread of Q4's grid takes, int64[threads,
    rows] (-1 past the plane's end): block x, thread t, row r -> x * rows *
    kThreads + r * kThreads + t, the blocks ceil(items / (rows *
    kThreads))."""
    per_block = rows * KTHREADS
    blocks = -(-items // per_block)
    x, r, t = np.meshgrid(np.arange(blocks), np.arange(rows),
                          np.arange(KTHREADS), indexing="ij")
    i = (x * per_block + r * KTHREADS + t).transpose(0, 2, 1) \
        .reshape(-1, rows)
    return np.where(i < items, i, -1)


@pytest.mark.parametrize("Z, words", [(1, 1), (17, 1), (16, 3), (333, 33),
                                      (1000, 70), (17, 4), (834, 768),
                                      (333, 36), (257, 4)])
def test_grid_covers_each_vector_once(Z, words):
    # Z * W / vec need not be a multiple of the rows a thread or of a block
    for vec in (4, 1) if words % 4 == 0 else (1,):
        items = Z * words // vec
        rows = qc_gallager.QC_WORDS_IN_FLIGHT // vec
        i = _thread_vectors(items, rows)
        assert np.array_equal(np.sort(i[i >= 0]), np.arange(items))
        # a thread's rows are kThreads vectors apart: one warp access each
        assert np.all(np.diff(i, axis=1)[i[:, 1:] >= 0] == KTHREADS) \
            if rows > 1 else True


def _check_frame(o, rot, plane):
    """csrc check_frame: the word at offset o of the variable frame, in the
    check frame of a socket of rotation s * W."""
    oc = o - rot
    return np.where(oc < 0, oc + plane, oc)


@pytest.mark.parametrize("Z, words", [(1, 4), (8, 1), (17, 4), (16, 3)])
def test_rotation_is_the_circulant_index(Z, words):
    # row (z - s) mod Z, word w, for every (z, w) and every shift s: the
    # wrap at z = s included
    z, w = np.meshgrid(np.arange(Z), np.arange(words), indexing="ij")
    o = z * words + w
    for s in range(Z):
        want = ((z - s) % Z) * words + w
        assert np.array_equal(_check_frame(o, s * words, Z * words), want)


# ---------------------------------------------------------------------------
# The numpy model of the kernel's arithmetic
# ---------------------------------------------------------------------------

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


def _popcount(x):
    return int(np.unpackbits(np.ascontiguousarray(x).view(np.uint8)).sum())


def _q4_model(adj, msg, parity, channel, decided, counts, *, threshold,
              clamp, vec, tx=None, init=False):
    """qc_gallager_variable.cu's arithmetic on numpy uint32 planes, in
    place.  Each variable block's plane is Z * W flat words; a vector of
    ``vec`` words at offset o meets socket (row, c, s) at o - s * W (mod Z *
    W) of message plane ``row`` and parity plane ``c``.  The vectors are
    the grid's (each thread's rows, kThreads apart).  An exact-degree block
    loads every parity and message vector once, holds the old messages for
    the changed count, and counts in planes sized to its degree; any other
    degree counts in MAX_DEGREE's planes and reads each socket's parity and
    message again for the new messages.  Also checks what the update in
    place rests on: a block's message words are read and written by one
    vector of one socket each."""
    Z, words = adj.Z, channel.shape[1]
    plane = Z * words
    rows = qc_gallager.QC_WORDS_IN_FLIGHT // vec
    items = plane // vec
    i = _thread_vectors(items, rows).ravel()
    o = i[i >= 0] * vec
    lanes = np.arange(vec)
    msg_f, ch_f = msg.reshape(-1, plane), channel.reshape(-1, plane)
    if not init:
        par_f, dec_f = parity.reshape(-1, plane), decided.reshape(-1, plane)
    errors = changed = 0
    for b, sockets in enumerate(adj.var_side):
        d = len(sockets)
        own = o[:, None] + lanes
        ch = ch_f[b][own]
        at = [_check_frame(o, s * words, plane)[:, None] + lanes
              for _row, _c, s in sockets]
        flat = np.concatenate([a.ravel() + row * plane
                               for a, (row, _c, _s) in zip(at, sockets)]) \
            if sockets else np.zeros(0, np.int64)
        assert np.unique(flat).size == flat.size == d * plane
        if init:
            for a, (row, _c, _s) in zip(at, sockets):
                msg_f[row][a] = ch
            continue
        exact = d in qc_gallager.QC_EXACT_DEGREES
        kplanes = max(1, d.bit_length()) if exact else \
            MAX_DEGREE.bit_length()
        old = [msg_f[row][a].copy() for a, (row, _c, _s) in zip(at, sockets)]
        dis = [par_f[c][a] ^ was ^ ch
               for a, was, (_row, c, _s) in zip(at, old, sockets)]
        planes = [np.zeros_like(ch) for _ in range(kplanes)]
        for carry in dis:
            for q in range(kplanes):
                planes[q], carry = planes[q] ^ carry, planes[q] & carry
        t = min(threshold, max(d - 1, 1)) if clamp else threshold
        ge_t = _count_at_least(planes, t)
        ge_t1 = _count_at_least(planes, t + 1) if t < 1 << kplanes else \
            np.zeros_like(ch)
        for p, (a, (row, c, _s)) in enumerate(zip(at, sockets)):
            if exact:
                dp, was = dis[p], old[p]
            else:           # streamed: read again
                was = msg_f[row][a].copy()
                dp = par_f[c][a] ^ was ^ ch
            out = ch ^ ((dp & ge_t1) | (~dp & ge_t))
            changed += int((out != was).sum())
            msg_f[row][a] = out
        dec = ch ^ _count_at_least(planes, d // 2 + 1)
        errors += _popcount(dec if tx is None else
                            dec ^ tx.reshape(-1, plane)[b][own])
        dec_f[b][own] = dec
    if not init:
        counts[0] += (errors, changed)


def _code_pair(base):
    """(JAX code, the port's code) of a named base."""
    if base == "regular":
        j = jqc_mod.sample_qc_code(jax.random.key(3), nb=12, dv=3, dc=6,
                                   Z=17)
        return j, qc.qc_code_from_numpy(np.asarray(j.base_chk),
                                        np.asarray(j.shifts), j.Z, j.nb,
                                        j.dv, j.dc)
    if base == "irregular":
        j = jqc_mod.sample_qc_code_irregular(jax.random.key(50), nb=24,
                                             lam=LAM_GAL, rho=RHO6, Z=16)
    else:
        table, shifts, nb = HAND[base]
        j = jqc_mod.IrregularQCLDPCCode(
            base_chk=jnp.asarray(table, jnp.int32),
            shifts=jnp.asarray(shifts, jnp.int32), Z=8, nb=nb,
            mb=len(table))
    return j, qc.irregular_qc_code_from_numpy(
        np.asarray(j.base_chk), np.asarray(j.shifts), j.Z, j.nb, j.mb)


def _planes(rng, shape, p=0.5):
    bits = rng.random(shape + (32,)) < p
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


def _plain(adj, msg, parity, channel, decided, **kw):
    """_qc_gallager_variable_plain on copies: (msg, decided, counts) as
    numpy."""
    m, dec = _t(msg), _t(decided)
    counts = torch.zeros((1, 2), dtype=torch.int32)
    qc_gallager._qc_gallager_variable_plain(
        adj, m, None if parity is None else _t(parity), _t(channel), dec,
        counts, **{k: _t(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()})
    return (m.numpy().view(np.uint32), dec.numpy().view(np.uint32),
            counts.numpy().astype(np.int64))


def _parity(adj, msg):
    return qc_gallager._qc_gallager_check_plain(adj, _t(msg)).numpy() \
        .view(np.uint32)


def _threshold(adj, clamp, threshold):
    """The pass's t for a decode's ``threshold`` (None: Gallager-A, as
    JAX's t_of: d - 1, or max(d - 1, 1) by the clamp)."""
    dvb = adj.var_chk.shape[1]
    return (dvb if clamp else dvb - 1) if threshold is None else threshold


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("threshold", [None, 0, 1, 40])
@pytest.mark.parametrize("words, vec, with_tx", [(8, 4, False),
                                                 (8, 4, True),
                                                 (3, 1, True)])
def test_model_equals_plain(base, threshold, words, vec, with_tx):
    # the first messages, then two rounds (the second moves more words)
    _, code = _code_pair(base)
    adj = qc_bp._adjacency(code, "cpu")
    clamp = isinstance(code, qc.IrregularQCLDPCCode)
    t = _threshold(adj, clamp, threshold)
    rng = np.random.default_rng(words + (threshold or 0))
    flips = _planes(rng, (code.n, words), 0.1)
    tx = _planes(rng, (code.n, words)) if with_tx else None
    channel = flips if tx is None else flips ^ tx
    msg = _planes(rng, (adj.num_rows * adj.Z, words))
    want = _plain(adj, msg, None, channel, channel, init=True)[0]
    _q4_model(adj, msg, None, channel, None, None, threshold=t,
              clamp=clamp, vec=vec, init=True)
    assert np.array_equal(msg, want)
    decided = _planes(rng, (code.n, words))
    moved = 0
    for _ in range(2):
        parity = _parity(adj, msg)
        want = _plain(adj, msg, parity, channel, decided, threshold=t,
                      clamp=clamp, tx=tx)
        counts = np.zeros((1, 2), np.int64)
        _q4_model(adj, msg, parity, channel, decided, counts, threshold=t,
                  clamp=clamp, vec=vec, tx=tx)
        assert np.array_equal(msg, want[0])
        assert np.array_equal(decided, want[1])
        assert np.array_equal(counts, want[2])
        moved += int(counts[0, 1])
    assert moved > 0 or threshold == 40 or base == "uniform_clamped"


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("threshold", [None, 0, 1, 40])
def test_model_round_equals_jax(base, threshold):
    """One round from the first messages: the model's decision and error
    count equal JAX's ``_qc_gallager_core`` at max_iters = 1.  (A
    degree-1 block at t <= 0 flips in the port and not in JAX -- the
    port's rule is its generic decoders', tests/test_torch_qc.py -- but a
    round's decision reads only the messages that came in.)"""
    jcode, code = _code_pair(base)
    adj = qc_bp._adjacency(code, "cpu")
    clamp = isinstance(code, qc.IrregularQCLDPCCode)
    words = 4
    received = _planes(np.random.default_rng(7), (code.n, words), 0.1)
    msg = np.zeros((adj.num_rows * adj.Z, words), np.uint32)
    _q4_model(adj, msg, None, received, None, None, threshold=0,
              clamp=clamp, vec=4, init=True)
    decided = received.copy()
    counts = np.zeros((1, 2), np.int64)
    _q4_model(adj, msg, _parity(adj, msg), received, decided, counts,
              threshold=_threshold(adj, clamp, threshold), clamp=clamp,
              vec=4)
    one = jqc_gallager.qc_gallager_decode_packed(
        jcode, jnp.asarray(received), 1, threshold=threshold)
    assert int(one.iterations) == 1
    assert np.array_equal(np.asarray(one.decided), decided)
    assert int(np.asarray(one.error_totals)[1]) == counts[0, 0]
