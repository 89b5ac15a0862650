"""P1's "xor" form (``csrc/peel_sequential.cu``) as a numpy model, on the CPU.

The kernel cannot run here, so its bookkeeping is modelled step for step:
per check the residual degree and the accumulators (the XOR over its
unresolved sockets of the variable and of the variable's checks at each
cyclic offset round its row, + 1), the degree-1 bitmap in 32 runs of
``per`` words with each lane's inclusive prefix count, the select (the
holder lane by a ballot over the prefix counts, the word and rank in its
run, the bit a lane a bit), and the update on the variable's d lanes (a
check listed twice taken by its first lane with its multiplicity, the
degree before the step read and every socket subtracted at once, the bit
flipped where the degree enters or leaves 1, the accumulators XORed a
socket at a time, the (owner, change) pairs moving the counts).  After
every step the model's state is held to a recount from scratch, and its
trajectory to :func:`_peel_sequential_plain` cut at that step; its final
sets and step counts are held to JAX's ``peel_decode`` /
``peel_decode_irregular``.  The shape rule :func:`peeling.peel_form` is
tested on a table of shapes at its edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code)
from iib_project_ldpc_codes_tpu.ops import BEC
from iib_project_ldpc_codes_tpu.ops import peeling as jpeel
from iib_project_ldpc_codes_tpu_torch.kernels import build
from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular
from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    irregular_code_from_numpy)
from iib_project_ldpc_codes_tpu_torch.ops import peeling

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
# mixed check degrees: the check rows carry padding too
LAM_MIX = [0, 0.5, 0.5]
RHO_MIX = [0, 0, 0, 0, 0.5, 0.5]
FIELDS = ("unresolved", "one_degree_evolution", "steps", "num_erasures")


class XorModel:
    """One trial of the "xor" form: ``var`` int[n, dv] (entries >= m are
    padding), ``erased`` bool[n]."""

    def __init__(self, var, erased, m):
        self.var, self.m = np.asarray(var), m
        self.n, self.dv = self.var.shape
        lay = peeling.peel_xor_layout(m, self.dv)
        self.per, self.shift = lay["per"], lay["shift"]
        self.unres = np.asarray(erased, bool).copy()
        self.num_erasures = int(self.unres.sum())
        self.deg, self.acc = self._recount()
        self.ones = np.zeros(32 * self.per, np.int64)
        for c in np.nonzero(self.deg == 1)[0]:
            self.ones[c >> 5] |= 1 << (c & 31)
        self.own = np.array([sum(bin(int(w)).count("1") for w in
                                 self.ones[lane * self.per:
                                           (lane + 1) * self.per])
                             for lane in range(32)])
        self.incl = np.cumsum(self.own)
        self.count = int(self.incl[31])

    def _recount(self):
        """Degrees and accumulators of the current unresolved set, from
        scratch (the kernel's start)."""
        deg = np.zeros(self.m, np.int64)
        acc = np.zeros((self.dv, self.m), np.int64)
        for v in np.nonzero(self.unres)[0]:
            real = [int(c) for c in self.var[v] if c < self.m]
            d = len(real)
            for ra, ca in enumerate(real):
                deg[ca] += 1
                acc[0, ca] ^= v
                for rb, cb in enumerate(real):
                    if rb != ra:
                        acc[(rb - ra) % d, ca] ^= cb + 1
        return deg, acc

    def check_state(self):
        deg, acc = self._recount()
        assert np.array_equal(deg, self.deg)
        # accumulators of checks still in play (the chosen check's are
        # left as they are: its degree is 0 for good)
        live = deg > 0
        assert np.array_equal(acc[:, live], self.acc[:, live])
        assert (self.acc < 1 << 16).all()
        bits = np.zeros(32 * self.per, np.int64)
        for c in np.nonzero(deg == 1)[0]:
            bits[c >> 5] |= 1 << (c & 31)
        assert np.array_equal(bits, self.ones)
        own = [sum(bin(int(w)).count("1") for w in
                   bits[lane * self.per:(lane + 1) * self.per])
               for lane in range(32)]
        assert np.array_equal(own, self.own)
        assert np.array_equal(np.cumsum(own), self.incl)
        assert self.count == int((deg == 1).sum())

    def select(self, k: int) -> int:
        """The k-th set bit: the holder lane (the first whose prefix count
        passes k), the word of its run that holds its rank (the last whose
        bits before it do not pass the rank), the bit of that word whose
        popc below passes the rest (a lane a bit)."""
        src = int(np.argmax(k < self.incl))       # __ffs of the ballot
        assert k < self.incl[src]
        rank = k - int(self.incl[src] - self.own[src])
        run = [int(w) for w in
               self.ones[src * self.per:(src + 1) * self.per]]
        at = np.concatenate([[0], np.cumsum([bin(w).count("1")
                                             for w in run])[:-1]])
        wi = int((rank >= at[1:]).sum())
        rank -= int(at[wi])
        word = run[wi]
        assert 0 <= rank < bin(word).count("1")
        below = [bin(word & (0xFFFFFFFF >> (31 - b))).count("1")
                 for b in range(32)]
        return (src * self.per + wi) * 32 + \
            int(np.argmax(np.array(below) > rank))

    def step(self, low: int, high: int):
        """One peel with the draw's words (low, high); returns (count
        before, chosen check, variable)."""
        before = self.count
        k = (high * before + ((low * before) >> 32)) >> 32
        chosen = self.select(k)
        x = [int(self.acc[i, chosen]) for i in range(self.dv)]
        d = 1 + sum(1 for i in range(1, self.dv) if x[i] != 0)
        v = x[0]
        assert self.unres[v] and self.deg[chosen] == 1
        s = [chosen] + [x[i] - 1 for i in range(1, d)]
        changes = []
        for i in range(d):                       # lane i
            if i > 0:
                self.acc[0, s[i]] ^= v
                for kk in range(1, d):
                    self.acc[kk, s[i]] ^= s[(i + kk) % d] + 1
            # a check listed twice: its first lane takes every socket
            mult = s.count(s[i])
            if s.index(s[i]) != i:
                continue
            pre = int(self.deg[s[i]])
            self.deg[s[i]] -= mult
            delta = int(pre - mult == 1) - int(pre == 1)
            if delta:
                self.ones[s[i] >> 5] ^= 1 << (s[i] & 31)
            changes.append((s[i] >> (5 + self.shift), delta))
        for owner, delta in changes:            # the d shuffles
            self.count += delta
            self.own[owner] += delta
            self.incl[owner:] += delta
        self.unres[v] = False
        return before, chosen, v


def model_peel(var, erased, m, seed, max_steps, check_every_step=False):
    """The "xor" form over a batch: ``var`` int[(T,) n, dv], ``erased``
    bool[T, n]; returns the plain version's four outputs as tensors and
    each trial's list of models' per-step (count, chosen, v)."""
    var, erased = np.asarray(var), np.asarray(erased)
    trials, n = erased.shape
    low, high = peeling._draws(peeling.peel_key(seed), 0, max(max_steps, 1),
                               trials, "cpu")
    evolution = np.full((trials, max_steps + 1), -1, np.int64)
    unresolved = np.zeros((trials, n), bool)
    steps = np.zeros(trials, np.int64)
    num_erasures = np.zeros(trials, np.int64)
    paths = []
    for r in range(trials):
        model = XorModel(var[r] if var.ndim == 3 else var, erased[r], m)
        t, path = 0, []
        while model.count > 0 and t < max_steps:
            path.append(model.step(int(low[t, r]), int(high[t, r])))
            evolution[r, t] = path[-1][0]
            if check_every_step:
                model.check_state()
            t += 1
        success = t == model.num_erasures
        assert success == (not model.unres.any())
        if success:
            evolution[r, t] = 0
        unresolved[r] = model.unres
        steps[r] = t + success
        num_erasures[r] = model.num_erasures
        paths.append(path)
    return (torch.from_numpy(unresolved),
            torch.from_numpy(evolution).to(torch.int32),
            torch.from_numpy(steps).to(torch.int32),
            torch.from_numpy(num_erasures).to(torch.int32)), paths


def _plain(code, erased, seed, max_steps):
    chk, var, n, m = peeling._tables(code)
    return peeling._peel_sequential_plain(chk, var, erased, n, m, seed,
                                          max_steps)


def _erased(n, eps, seed, trials):
    rng = np.random.default_rng(seed)
    erased = rng.random((trials, n)) < eps
    erased[0] = False                       # a trial with no erasure
    return torch.from_numpy(erased)


def _multi_edge_code(n, dv, dc, seed):
    """A (dv, dc) code from an unrepaired socket permutation, so that some
    variables meet one check twice; the two tables agree as multisets."""
    m = n * dv // dc
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n * dv)
    var = (perm // dc).reshape(n, dv)
    chk = np.zeros(m * dc, np.int64)
    chk[perm] = np.repeat(np.arange(n), dv)
    var_t = torch.from_numpy(var).to(torch.int32).contiguous()
    chk_t = torch.from_numpy(chk.reshape(m, dc)).to(torch.int32).contiguous()
    return chk_t, var_t, m


def _codes(kind, trials):
    """(tables, n, m, batched) of a test code family."""
    if kind == "regular":
        return ensemble.sample_codes(3, 0, 1, 120, 3, 6).select(0), False
    if kind == "regular_batch":
        return ensemble.sample_codes(4, 0, trials, 120, 3, 6), True
    if kind == "irregular":
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(96, LAM, RHO)
        return irregular.sample_irregular_codes(5, 0, trials, spec), True
    spec = irregular.IrregularEnsembleSpec.from_lam_rho(96, LAM_MIX, RHO_MIX)
    return irregular.sample_irregular_codes(6, 0, 1, spec).select(0), False


# ---------------------------------------------------------------------------
# The model against the plain version, step by step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["regular", "regular_batch", "irregular",
                                  "irregular_mixed"])
@pytest.mark.parametrize("eps", [0.3, 0.45])
def test_model_equals_plain_step_by_step(kind, eps):
    trials = 3
    code, _ = _codes(kind, trials)
    chk, var, n, m = peeling._tables(code)
    erased = _erased(n, eps, seed=int(eps * 100) + n, trials=trials)
    got, paths = model_peel(var.numpy(), erased.numpy(), m, seed=11,
                            max_steps=n, check_every_step=True)
    want = _plain(code, erased, 11, n)
    for f, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f
    # after every step s the unresolved set is the plain version's cut at s
    longest = max(len(p) for p in paths)
    assert longest > 10
    for s in range(0, longest + 1, max(1, longest // 12)):
        cut, _ = model_peel(var.numpy(), erased.numpy(), m, seed=11,
                            max_steps=s)
        want = _plain(code, erased, 11, s)
        for f, a, b in zip(FIELDS, cut, want):
            assert torch.equal(a, b), (f, s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_on_multi_edge_codes(seed):
    """Hand-built codes with a variable that meets one check twice: the
    two sockets count as two edges and cancel as two."""
    n = 24
    chk, var, m = _multi_edge_code(n, 3, 6, seed)
    repeated = [v for v in range(n) if len(set(var[v].tolist())) < 3]
    assert repeated, "the permutation made no multi-edge"
    erased = _erased(n, 0.5, seed, trials=4)
    erased[1, repeated] = True
    got, _ = model_peel(var.numpy(), erased.numpy(), m, seed=seed,
                        max_steps=n, check_every_step=True)
    want = peeling._peel_sequential_plain(chk, var, erased, n, m, seed, n)
    for f, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f


def test_model_with_a_check_listed_twice_by_the_peeled_variable():
    """A variable whose row names check 0 twice is peeled through its
    other check: check 0 loses two edges at once (3 -> 1 sets its bit, 2
    -> 0 leaves it clear), as the lanes' final-degree rule requires."""
    # v0 meets check 0 twice; checks 0, 1 and 3 have three or four edges
    var = np.array([[0, 0, 1], [0, 2, 3], [0, 1, 3], [2, 3, 1]])
    m, n = 4, 4
    chk = [[] for _ in range(m)]
    for v in range(n):
        for c in var[v]:
            chk[c].append(v)
    dc = max(map(len, chk))
    chk_t = torch.tensor([r + [n] * (dc - len(r)) for r in chk],
                         dtype=torch.int32)
    var_t = torch.from_numpy(var).to(torch.int32)
    for pattern in ([1, 0, 0, 0], [1, 1, 0, 0], [1, 0, 1, 0], [1, 1, 1, 1],
                    [1, 0, 0, 1]):
        erased = torch.tensor([pattern, [0, 0, 0, 0]], dtype=torch.bool)
        for seed in range(4):
            got, _ = model_peel(var, erased.numpy(), m, seed=seed,
                                max_steps=n, check_every_step=True)
            want = peeling._peel_sequential_plain(chk_t, var_t, erased, n, m,
                                                  seed, n)
            for f, a, b in zip(FIELDS, got, want):
                assert torch.equal(a, b), (pattern, seed, f)


@pytest.mark.parametrize("max_steps", [0, 1, 7])
def test_model_with_max_steps_cut(max_steps):
    code, _ = _codes("regular_batch", 4)
    chk, var, n, m = peeling._tables(code)
    erased = _erased(n, 0.42, seed=8, trials=4)
    got, _ = model_peel(var.numpy(), erased.numpy(), m, seed=3,
                        max_steps=max_steps)
    want = _plain(code, erased, 3, max_steps)
    for f, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f
    assert int(got[2][0]) == 1 and int(got[1][0, 0]) == 0   # no erasure


def test_select_is_the_kth_set_bit_of_the_bitmap():
    """The select against a flat scan of the bitmap, at runs of 4, 8 and
    64 words (m = 96, 8,192, 65,535), empty words included."""
    rng = np.random.default_rng(0)
    for m in (96, 8192, 65_535):
        var = rng.integers(0, m, (2 * m, 3))
        model = XorModel(var, np.zeros(2 * m, bool), m)
        for density in (0.002, 0.3):
            bits = np.union1d(np.nonzero(rng.random(m) < density)[0],
                              [m - 1])
            model.ones[:] = 0
            for c in bits:
                model.ones[c >> 5] |= 1 << int(c & 31)
            model.own = np.array([sum(bin(int(w)).count("1") for w in
                                      model.ones[lane * model.per:
                                                 (lane + 1) * model.per])
                                  for lane in range(32)])
            model.incl = np.cumsum(model.own)
            for k in sorted({0, len(bits) - 1, *rng.integers(
                    0, len(bits), 20).tolist()}):
                assert model.select(int(k)) == bits[k]


def test_model_lanes_own_runs_of_the_bitmap():
    """At n = 16,384 (m = 8,192) each lane owns 8 bitmap words; at small m
    the runs are 4 words and most lanes own nothing."""
    assert peeling.peel_xor_layout(8192, 3)["per"] == 8
    assert peeling.peel_xor_layout(60, 3)["per"] == 4
    assert peeling.peel_xor_layout(65535, 1)["per"] == 64
    code = ensemble.sample_codes(2, 0, 1, 2400, 3, 6).select(0)
    chk, var, n, m = peeling._tables(code)
    erased = _erased(n, 0.45, seed=5, trials=2)
    model = XorModel(var.numpy(), erased[1].numpy(), m)
    assert model.per == 4 and (model.own[10:] == 0).all() and model.count
    got, _ = model_peel(var.numpy(), erased.numpy(), m, seed=1,
                        max_steps=n)
    want = _plain(code, erased, 1, n)
    for f, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f


# ---------------------------------------------------------------------------
# The model against JAX where the choices do not matter
# ---------------------------------------------------------------------------

def _carry_irregular(jcode):
    return irregular_code_from_numpy(
        *[np.asarray(getattr(jcode, f))
          for f in ("chk_to_var", "var_to_chk", "var_to_sock")],
        jcode.n, jcode.m)


@pytest.mark.parametrize("kind", ["regular", "irregular"])
@pytest.mark.parametrize("eps", [0.3, 0.42])
def test_model_equals_jax_where_the_choices_do_not_matter(kind, eps):
    if kind == "regular":
        jcode = jax_sample_code(jax.random.key(1), 240, 3, 6)
        code = code_from_numpy(np.asarray(jcode.chk_to_var), 240, 3, 6)
        jfn = jpeel.peel_decode
    else:
        jcode = jir.IrregularEnsembleSpec.from_lam_rho(96, LAM, RHO).sample(
            jax.random.key(5))
        code = _carry_irregular(jcode)
        jfn = jpeel.peel_decode_irregular
    _, var, n, m = peeling._tables(code)
    for s in range(3):
        rx = np.array(BEC(eps).transmit(jax.random.key(10 + s),
                                        jnp.zeros(n, jnp.int32)))
        want = jfn(jcode, jnp.asarray(rx), jax.random.key(3 + s))
        (unres, evo, steps, erasures), _ = model_peel(
            var.numpy(), (rx == 2)[None], m, seed=s, max_steps=n)
        assert np.array_equal(unres[0].numpy(), np.asarray(want.unresolved))
        assert int(steps[0]) == int(want.steps)
        assert int(erasures[0]) == int(want.num_erasures)
        w = np.asarray(want.one_degree_evolution)
        assert int(evo[0, 0]) == int(w[0])
        assert int((evo[0] >= 0).sum()) == int((w >= 0).sum())


# ---------------------------------------------------------------------------
# The shape rule and the wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, m, dc, dv, form", [
    (16_384, 8_192, 6, 3, "xor"),          # phase 33's shape
    (16_384, 8_192, 6, 4, "xor"),          # the irregular family
    (96, 48, 6, 3, "xor"),
    (65_535, 32_768, 6, 3, "xor"),         # the largest 16-bit variable
    (65_536, 32_768, 6, 3, "row"),
    (60_000, 65_535, 6, 1, "xor"),         # the largest 16-bit check + 1
    (60_000, 65_536, 6, 1, "row"),
    (1_000, 500, 15, 3, "xor"),            # 4-bit degrees
    (1_000, 500, 16, 3, "row"),
    (1_000, 500, 6, 8, "xor"),             # a variable's checks in registers
    (1_000, 500, 6, 9, "row"),
    (60_000, 34_000, 6, 3, "xor"),         # 229,208 bytes
    (60_000, 36_000, 6, 3, "row"),         # 242,208 bytes
    (300_000, 150_000, 6, 3, "row"),       # the 206 KB card test
])
def test_peel_form_by_shape(n, m, dc, dv, form):
    assert peeling.peel_form(n, m, dc, dv) == form


def test_xor_layout_words():
    lay = peeling.peel_xor_layout(8192, 3)
    assert (lay["shift"], lay["mx"], lay["stride"]) == (3, 8192, 4097)
    assert lay["bytes"] == 4 * (256 + 1024 + 3 * 4097 + 1) == 54_288
    # four trials an SM at (3,6), n = 16,384: 228 KB, 1 KB kept a block
    assert 4 * (lay["bytes"] + 1024) <= 228 * 1024
    assert peeling.peel_xor_layout(8192, 4)["bytes"] == 70_676
    assert peeling.peel_xor_layout(34_000, 3)["bytes"] == 229_208
    assert peeling.peel_xor_layout(36_000, 3)["bytes"] == 242_208
    # the layout grows with m: the rule's edge is one edge
    sizes = [peeling.peel_xor_layout(m, 3)["bytes"] for m in
             range(1, 40_000, 97)]
    assert sizes == sorted(sizes)


def test_source_holds_the_rule_and_the_layout():
    source = (build.SOURCE_DIR / "peel_sequential.cu").read_text()
    assert "n > 65535 || m > 65535 || dc > 15 || dv > 8" in source
    assert "l.stride = l.mx / 2 + 1;" in source
    assert "static_cast<long long>(dv) * l.stride + 1;" in source
    assert "l.shift = 2;" in source
    assert "(m + 31) / 32 + 31) / 32" in source
    assert build.SIGNATURES["ldpc_peel_sequential"][-2] is build._I


def test_wrapper_checks_its_form_and_records_none_on_the_cpu():
    code, _ = _codes("regular", 1)
    chk, var, n, m = peeling._tables(code)
    erased = _erased(n, 0.4, seed=2, trials=2)
    with pytest.raises(ValueError, match="form must be one of"):
        peeling.peel_sequential(chk, var, erased, n, m, 0, n, form="gather")
    for form in (None, "xor", "row"):
        got = peeling.peel_sequential(chk, var, erased, n, m, 0, n,
                                      form=form)
        want = _plain(code, erased, 0, n)
        for f, a, b in zip(FIELDS, got, want):
            assert torch.equal(a, b), f
    assert peeling.peel_sequential.launches == 0
    assert peeling.peel_sequential.form is None
