"""Kernel A's transform and K4's counter as numpy models of their CUDA
sources, on the CPU.

Kernel A (``csrc/awgn_llr.cu``) computes the float64 Box-Muller pair
without the math library: -2 ln u1 from the word's bits, a 32-entry table
and a polynomial; r by a reciprocal square root and two corrections; cos
and sin of the rounded angle by a quadrant reduction and two polynomials;
the float32 division by sigma^2 by products and two remainder corrections.
The model below reads the source's tables and constants and runs the same
steps in numpy float64 (without replaying the FMAs), held to numpy's
``log`` / ``cos`` / ``sin`` on the edge words, the octant boundaries and a
seeded sample; the division is replayed with exact FMAs and held to
float32 division.  The card checks every 32-bit word (``chip_smoke.py``
phase 18).

K4 (``csrc/per_trial_counts.cu``) counts with carry-save bit planes: its
model (the 16-row Harley-Seal step, the planes up to weight 128, the byte
lanes, the walkers' 16-bit sums, the run length the host picks) is held
exactly to JAX's ``per_trial_counts``.
"""

import math
import re
from decimal import Decimal, getcontext
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from iib_project_ldpc_codes_tpu.ops import bitops as jbitops

CSRC = Path(__file__).resolve().parent.parent / \
    "iib_project_ldpc_codes_tpu_torch" / "csrc"
A_SRC = (CSRC / "awgn_llr.cu").read_text()
K4_SRC = (CSRC / "per_trial_counts.cu").read_text()

getcontext().prec = 60


def _array(name: str) -> list[int]:
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", A_SRC, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body)]


def _hex_double(name: str) -> float:
    return float.fromhex(re.search(
        rf"constexpr double {name} = (-?0x[0-9a-fp.+-]+);", A_SRC).group(1))


def _int_const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _bits_double(hi: int, lo: int = 0) -> float:
    return float(np.array([(hi << 32) | lo], np.uint64).view(np.float64)[0])


COEF = [float.fromhex(x) for x in re.findall(
    r"(-?0x[0-9a-f]\.[0-9a-f]+p[+-]\d+)",
    A_SRC[A_SRC.index("Coef kCoef = {"):A_SRC.index("}};")])]
assert len(COEF) == 19
Q, S, C = COEF[:7], COEF[7:13], COEF[13:19]
INV_C = np.array([_bits_double(h) for h in _array("kInvC")])
LOG_LO = np.array([_bits_double(h) for h in _array("kLogLo")])
LOG_HI = np.array([float(np.array([v], np.uint64).view(np.float64)[0])
                   for v in (int(x, 16) for x in re.findall(
                       r"0x([0-9a-f]+)ull", A_SRC[A_SRC.index("kLogHi[32]"):]
                       [:1200]))])
FOLD = _int_const(A_SRC, "kFold")
TWO_LN2_HI, TWO_LN2_LO = _hex_double("kTwoLn2Hi"), _hex_double("kTwoLn2Lo")
HALF_PI_HI, HALF_PI_LO = _hex_double("kHalfPiHi"), _hex_double("kHalfPiLo")
TWO_PI_ULP, TWO_PI_BIAS = _hex_double("kTwoPiUlp"), _hex_double("kTwoPiBias")


def _pi() -> Decimal:
    def atan_inv(n):
        n, s, term, k, sign = Decimal(n), Decimal(0), 1 / Decimal(n), 1, 1
        while term > Decimal(10) ** -58:
            s += sign * term / k
            term /= n * n
            k, sign = k + 2, -sign
        return s
    return 16 * atan_inv(5) - 4 * atan_inv(239)


def _horner(cs, x):
    r = np.full_like(x, cs[-1])
    for c in reversed(cs[:-1]):
        r = r * x + c
    return r


def radius(a: np.ndarray) -> np.ndarray:
    """The kernel's r = sqrt(-2 ln u1), u1 = (a + 0.5) 2^-32, step by
    step (``radius`` in awgn_llr.cu)."""
    v = 2 * a.astype(np.uint64) + 1
    vd = v.astype(np.float64)                      # exact: v < 2^33
    e = np.frexp(vd)[1] - 1
    m = vd / np.ldexp(1.0, e)                      # [1, 2), exact
    i = ((m - 1) * 32).astype(np.int64)            # the top 5 bits
    k = (33 - e - (i >= FOLD)).astype(np.float64)
    t = m * INV_C[i] - 1                           # exact
    p = t * t * _horner(Q, t) + (t * -2 + LOG_LO[i])
    x = (k * TWO_LN2_HI + LOG_HI[i]) + (k * TWO_LN2_LO + p)
    return np.sqrt(x)


def cos_sin(b: np.ndarray):
    """The kernel's (cos theta, sin theta), theta = RN(2 pi b 2^-32)
    (``reduced_cos_sin`` and ``box_muller``), and theta."""
    b = b.astype(np.uint64)
    # fma(2^52 + b, 2 pi 2^-32, -2 pi 2^20) = RN(b 2 pi 2^-32): the FMA
    # rounds once, and 2^52 times the first constant is the second exactly
    theta = b.astype(np.float64) * TWO_PI_ULP
    q = ((b >> 29) + 1) >> 1
    x = (theta - q * HALF_PI_HI) - q * HALF_PI_LO
    z = x * x
    sx = x + x * z * _horner(S, z)
    cx = 1 + z * (-0.5 + z * _horner(C, z))
    odd, neg_c, neg_s = q % 2 == 1, (q + 1) & 2 > 0, q & 2 > 0
    cos = np.where(odd, sx, cx) * np.where(neg_c, -1.0, 1.0)
    sin = np.where(odd, cx, sx) * np.where(neg_s, -1.0, 1.0)
    return cos, sin, theta


def _edge_words() -> np.ndarray:
    ks = range(1, 33)
    return np.unique(np.array(
        [0, 1, 2, 3, (1 << 32) - 2, (1 << 32) - 1]
        + [(1 << k) - 1 for k in ks] + [(1 << k) % (1 << 32) for k in ks],
        dtype=np.uint64))


def _octant_words() -> np.ndarray:
    return np.array([(o << 29) + d for o in range(9) for d in (-1, 0, 1)
                     if 0 <= (o << 29) + d < 1 << 32], dtype=np.uint64)


def _sample(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 32, n,
                                                dtype=np.uint64)


# ---------------------------------------------------------------------------
# kernel A: the tables and constants of the source
# ---------------------------------------------------------------------------

def test_log_table_entries_are_exact_enough():
    ln2 = Decimal(2).ln()
    assert len(INV_C) == len(LOG_LO) == len(LOG_HI) == 32
    for i in range(32):
        invc = INV_C[i]
        mant, _ = math.frexp(invc)
        # at most 20 significant bits: m (33 bits) times 1/c is exact
        assert (mant * 2 ** 20).is_integer()
        lo_m, hi_m = 1 + i / 32, 1 + (i + 1) / 32
        assert max(abs(lo_m * invc - 1), abs(hi_m * invc - 1)) <= 2.0 ** -6
        fold = int(i >= FOLD)
        want = -2 * ((1 / Decimal(invc)).ln() - fold * ln2)
        # the high part on the 2^-40 grid, the rest to 2^-62
        assert (LOG_HI[i] * 2.0 ** 40).is_integer()
        assert abs(Decimal(LOG_HI[i]) + Decimal(LOG_LO[i]) - want) < \
            Decimal(2) ** -62
    assert INV_C[31] == 0.5 and LOG_HI[31] == 0 and LOG_LO[31] == 0


def test_split_constants():
    ln2, pi = Decimal(2).ln(), _pi()
    assert (TWO_LN2_HI * 2.0 ** 40).is_integer()
    assert abs(Decimal(TWO_LN2_HI) + Decimal(TWO_LN2_LO) - 2 * ln2) < \
        Decimal(2) ** -94
    # q pi/2 exact for q <= 4: pi/2's high part has at most 50 bits
    assert (HALF_PI_HI * 2.0 ** 49).is_integer()
    assert abs(Decimal(HALF_PI_HI) + Decimal(HALF_PI_LO) - pi / 2) < \
        Decimal(2) ** -104
    assert TWO_PI_ULP == 2 * math.pi * 2.0 ** -32
    assert TWO_PI_BIAS == TWO_PI_ULP * 2.0 ** 52


def test_theta_is_the_plain_versions_rounding():
    b = np.concatenate([_edge_words(), _sample(1 << 16, 5)])
    _, _, theta = cos_sin(b)
    assert np.array_equal(theta,
                          2.0 * math.pi * (b.astype(np.float64) * 2.0 ** -32))


# ---------------------------------------------------------------------------
# kernel A: the model against numpy's log / cos / sin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("words", ["edges", "octants", "sample"])
def test_radius_model_against_numpy(words):
    a = {"edges": _edge_words(), "octants": _octant_words(),
         "sample": _sample(1 << 20, 11)}[words]
    r = radius(a)
    ref = np.sqrt(-2 * np.log((a.astype(np.float64) + 0.5) * 2.0 ** -32))
    # within 2^-50 relative (about 4 ulps; numpy's log rounds to an ulp)
    assert np.all(np.abs(r - ref) <= 2.0 ** -50 * ref)
    if words == "edges":
        # the tail words: a = 0 gives r = sqrt(66 ln 2), a = 2^32 - 1 about
        # 2^-16, the most extreme normals the channel draws
        assert r[0] == pytest.approx(math.sqrt(66 * math.log(2)), rel=1e-15)
        assert r[-1] == pytest.approx(2.0 ** -16, rel=1e-9)


@pytest.mark.parametrize("words", ["edges", "octants", "sample"])
def test_cos_sin_model_against_numpy(words):
    b = {"edges": _edge_words(), "octants": _octant_words(),
         "sample": _sample(1 << 20, 12)}[words]
    cos, sin, theta = cos_sin(b)
    assert np.all(np.abs(cos - np.cos(theta)) <= 2.0 ** -50)
    assert np.all(np.abs(sin - np.sin(theta)) <= 2.0 ** -50)


def test_model_normals_round_as_the_plain_versions():
    """float32 z = RN(r cos), RN(r sin) of the model against the plain
    version's float64 formula, on a sample: equal but for a handful."""
    a, b = _sample(1 << 18, 13), _sample(1 << 18, 14)
    u1 = (a.astype(np.float64) + 0.5) * 2.0 ** -32
    theta = 2.0 * math.pi * (b.astype(np.float64) * 2.0 ** -32)
    r_ref = np.sqrt(-2.0 * np.log(u1))
    cos, sin, _ = cos_sin(b)
    r = radius(a)
    differ = np.sum((r * cos).astype(np.float32)
                    != (r_ref * np.cos(theta)).astype(np.float32)) + \
        np.sum((r * sin).astype(np.float32)
               != (r_ref * np.sin(theta)).astype(np.float32))
    assert differ <= 2


# ---------------------------------------------------------------------------
# kernel A: the float32 division by products
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """RN32(a b + c) of float32 arrays, exactly: a b is exact in float64,
    the sum is rounded to odd in float64 (TwoSum), then to float32."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(np.uint64) & 1) == 0
    toward = np.where(e > 0, np.inf, -np.inf)
    s = np.where((e != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def div_by_products(y, sigma_sq):
    """The kernel's RN(2y / sigma^2): Markstein's sequence on 2y with its
    remainders halved (``div_by_products`` in awgn_llr.cu)."""
    s_half = np.float32(0.5) * sigma_sq
    rcp2 = np.float32(2) * (np.float32(1) / sigma_sq)
    q0 = y * rcp2
    q1 = _fma32(_fma32(-q0, s_half, y), rcp2, q0)
    return _fma32(_fma32(-q1, s_half, y), rcp2, q1)


@pytest.mark.parametrize("sigma", [0.8, 0.841, 0.85, 1.3, 0.3, 3.7,
                                   2.0 ** -29.9, 2.0 ** 29.9])
def test_division_by_products_rounds_correctly(sigma):
    rng = np.random.default_rng(int(sigma * 1000) % 997)
    sigma_sq = np.float32(sigma) * np.float32(sigma)
    # |2y| over the kernel's whole range, [2^-23, 2^35], and y near 0 / 1
    mag = np.exp2(rng.uniform(-24, 34, 1 << 18))
    y = np.concatenate([
        mag * rng.choice([-1.0, 1.0], mag.size),
        1 + rng.integers(-2 ** 12, 2 ** 12, 1 << 14) * 2.0 ** -24,
        -1 + rng.integers(-2 ** 12, 2 ** 12, 1 << 14) * 2.0 ** -24,
        [0.0, 2.0 ** -24, -2.0 ** -24]]).astype(np.float32)
    want = (np.float32(2) * y) / sigma_sq
    assert np.array_equal(div_by_products(y, sigma_sq).view(np.uint32),
                          want.view(np.uint32))


def test_division_path_rule_in_the_source():
    """The product path takes sigma^2 in [2^-60, 2^60]; outside it the
    kernel keeps __fdiv_rn."""
    assert "sigma_sq >= 0x1p-60f && sigma_sq <= 0x1p60f" in A_SRC
    assert "__fdiv_rn(__fmul_rn(2.0f, y), sigma_sq)" in A_SRC


# ---------------------------------------------------------------------------
# K4: the bit-sliced counter
# ---------------------------------------------------------------------------

K4_COLS, K4_WALKERS, K4_GROUP, K4_MAX_RUN, K4_MIN_BLOCKS = (
    _int_const(K4_SRC, n) for n in ("kCols", "kWalkers", "kGroup", "kMaxRun",
                                    "kMinBlocks"))


def _csa(a, b, c):
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def _add16(d, p):
    """``add16``: 16 words into planes of weight 1..128."""
    for half in (0, 8):
        quads = []
        for pair in (half, half + 4):
            ta, p[0] = _csa(p[0], d[pair], d[pair + 1])
            tb, p[0] = _csa(p[0], d[pair + 2], d[pair + 3])
            f, p[1] = _csa(p[1], ta, tb)
            quads.append(f)
        e, p[2] = _csa(p[2], quads[0], quads[1])
        if half == 0:
            eights_a = e
        else:
            eights_b = e
    sixteens, p[3] = _csa(p[3], eights_a, eights_b)
    for k in range(4, 8):
        carry = p[k] & sixteens
        p[k] = p[k] ^ sixteens
        sixteens = carry
    assert not sixteens.any()


def k4_run(n: int, w: int) -> int:
    """The host's run length: the largest of 128 .. 16 leaving at least
    kMinBlocks blocks."""
    xblocks, run = -(-w // K4_COLS), K4_MAX_RUN
    while run > K4_GROUP and \
            xblocks * -(-n // (K4_WALKERS * run)) < K4_MIN_BLOCKS:
        run //= 2
    return run


def k4_counts(words: np.ndarray, run: int | None = None) -> np.ndarray:
    """The kernel's counts: each (walker, column) adds its run 16 rows at a
    time (the last group zero-padded), reads its planes into byte lanes,
    and a block's 8 walkers meet in 16-bit lanes."""
    words = words.view(np.uint32)
    n, w = words.shape
    run = run or k4_run(n, w)
    assert run <= K4_MAX_RUN and run % K4_GROUP == 0
    runs = -(-n // run)
    padded = np.zeros((runs * run + K4_GROUP, w), np.uint32)
    padded[:n] = words
    out = np.zeros(32 * w, np.int64)
    cols = np.arange(w) * 32
    for yb in range(-(-runs // K4_WALKERS)):
        partial = np.zeros((K4_WALKERS, w, 8), np.uint32)
        for walker in range(K4_WALKERS):
            r0 = (yb * K4_WALKERS + walker) * run
            p = [np.zeros(w, np.uint32) for _ in range(8)]
            for g in range(r0, min(r0 + run, n), K4_GROUP):
                d = [padded[g + k] if g + k < min(r0 + run, n)
                     else np.zeros(w, np.uint32) for k in range(K4_GROUP)]
                _add16(d, p)
            for b in range(8):
                partial[walker, :, b] = sum(
                    ((p[k] >> np.uint32(b)) & np.uint32(0x01010101))
                    << np.uint32(k) for k in range(8))
        lo = (partial & 0x00FF00FF).sum(0, dtype=np.uint32)
        hi = ((partial >> 8) & 0x00FF00FF).sum(0, dtype=np.uint32)
        for j in range(8):
            out[cols + j] += lo[:, j] & 0xFFFF
            out[cols + j + 8] += hi[:, j] & 0xFFFF
            out[cols + j + 16] += lo[:, j] >> 16
            out[cols + j + 24] += hi[:, j] >> 16
    return out


def _plane(n, w, p, seed):
    rng = np.random.default_rng(seed)
    bits = rng.random((n, 32 * w)) < p
    return (bits.reshape(n, w, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


# rows on both sides of the 16-row step and of the runs' ends (up to eight
# walkers of 128 rows: 1024), widths 1, 3, 4, 5 and 48 (48 only below 130
# rows, to keep the model quick)
K4_CASES = [(run, n, w) for run in (16, 128)
            for n in (1, 15, 16, 17, 127, 128, 129, 1023, 1024, 1025)
            for w in (1, 3, 4, 5, 48) if n <= 129 or w <= 5]


@pytest.mark.parametrize("run, n, w", K4_CASES)
def test_k4_model_equals_jax_across_flush_boundaries(run, n, w):
    for p, seed in ((0.42, n * 7 + w), (1.0, 0)):
        words = _plane(n, w, p, seed)
        want = np.asarray(jbitops.per_trial_counts(jnp.asarray(words)))
        assert np.array_equal(k4_counts(words, run), want)


@pytest.mark.parametrize("n, w", [(10_000, 768), (1_000_000, 48),
                                  (2048, 768), (1, 1), (129, 3)])
def test_k4_run_rule(n, w):
    run = k4_run(n, w)
    blocks = -(-w // K4_COLS) * -(-n // (K4_WALKERS * run))
    assert run in (16, 32, 64, 128)
    assert blocks >= K4_MIN_BLOCKS or run == K4_GROUP
    # the 16-bit lanes hold a block's sums: 8 walkers of at most 128 rows
    assert K4_WALKERS * K4_MAX_RUN < 1 << 16


def test_k4_model_at_the_rules_run_equals_jax():
    words = _plane(3000, 40, 0.5, 3)
    want = np.asarray(jbitops.per_trial_counts(jnp.asarray(words)))
    assert k4_run(3000, 40) == 16
    assert np.array_equal(k4_counts(words), want)


@pytest.mark.parametrize("entry, src", [
    ("ldpc_awgn_llr", A_SRC), ("ldpc_awgn_llr_check", A_SRC),
    ("ldpc_per_trial_counts", K4_SRC)])
def test_entry_points_match_their_ctypes_signatures(entry, src):
    from iib_project_ldpc_codes_tpu_torch.kernels.build import SIGNATURES

    params = re.search(rf'extern "C" int {entry}\((.*?)\)', src,
                       re.S).group(1)
    assert len(params.split(",")) == len(SIGNATURES[entry])
