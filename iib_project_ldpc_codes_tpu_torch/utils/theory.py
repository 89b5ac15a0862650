"""Analytic theory used by the port.

The port's own copy (numpy only, held to the originals by the tests at rel
1e-12) of the functions of the JAX package's
``iib_project_ldpc_codes_tpu/utils/theory.py`` that its experiments and
engine read:

  * per-edge BEC density evolution on a base graph and the threshold
    bisection over it, which :func:`..models.qc.design_protograph` ranks
    sampled bases by.  The threshold of the Z -> infinity lift of a base
    graph is the governing limit of the circulant lifts in
    ``models/qc.py``: a lifted waterfall follows its BASE graph's
    threshold, not the unstructured (lambda, rho) ensemble's;
  * density evolution and the BP threshold of (dv,dc)-regular and
    irregular (lambda, rho) ensembles, DE threshold eps*(3,6) ~= 0.4294375
    (test_de_threshold.py:7-28);
  * finite-length scaling: y*, x*, the scaling parameter alpha(3,6) ~=
    0.5595 (finite_length_scaling_calculation.py:9-21), the waterfall
    P_block ~= Phi(-sqrt(n)(eps*-eps)/alpha) with the finite-size shift
    beta(3,6) = 0.616949 (tools/density_evolution.py:4), and the variance
    at the critical point;
  * the peeling drift of the R-process and its critical point
    (peeling_decoder.py:101-123), regular and irregular, which
    ``utils/experiments.py`` compares the peeling trajectories with.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List

import numpy as np

#: finite-size threshold shift for the (3,6) ensemble
#: (tools/density_evolution.py:4): the default wherever a beta is needed
BETA_3_6 = 0.616949

#: the reference's commented waterfall-shift variant
#: (finite_length_scaling_calculation.py:40), an explicit opt-in
BETA_3_6_WATERFALL = 0.616045


def protograph_de(base_chk, nb: int, erasure_prob: float,
                  max_iterations: int = 10_000,
                  tolerance: float = 1e-9):
    """Per-edge BEC density evolution on a base graph.

    ``base_chk`` is an [mb, dcb(_max)] check->variable-block table
    (entries >= nb = padding, skipped -- both QCLDPCCode.base_chk and
    IrregularQCLDPCCode.base_chk work directly, as CPU tensors or numpy
    arrays).  Returns the vector of per-edge variable->check erasure
    probabilities at the fixed point (all ~0 iff decodable).

      x_e = eps * prod_{e' in v(e), e' != e} y_{e'}
      y_e = 1 - prod_{e' in c(e), e' != e} (1 - x_{e'})
    """
    base = np.asarray(base_chk)
    edges = [(c, int(base[c, j]))
             for c in range(base.shape[0])
             for j in range(base.shape[1]) if base[c, j] < nb]
    E = len(edges)
    chk_edges = {}
    var_edges = {}
    for e, (c, v) in enumerate(edges):
        chk_edges.setdefault(c, []).append(e)
        var_edges.setdefault(v, []).append(e)
    x = np.full(E, float(erasure_prob))
    for _ in range(max_iterations):
        # check -> variable
        y = np.empty(E)
        for c, es in chk_edges.items():
            prod_all = np.prod([1.0 - x[e] for e in es])
            for e in es:
                rest = prod_all / (1.0 - x[e]) if x[e] < 1.0 else \
                    np.prod([1.0 - x[o] for o in es if o != e])
                y[e] = 1.0 - rest
        # variable -> check
        new_x = np.empty(E)
        for v, es in var_edges.items():
            for e in es:
                others = np.prod([y[o] for o in es if o != e])
                new_x[e] = erasure_prob * others
        if np.max(np.abs(new_x - x)) < tolerance * 1e-3:
            x = new_x
            break
        x = new_x
    return x


def protograph_threshold(base_chk, nb: int, precision: float = 1e-5,
                         tolerance: float = 1e-6) -> float:
    """BP threshold of the Z->infinity lift of a base graph (bisection
    over :func:`protograph_de`).

    A regular base reproduces eps*(dv, dc) exactly (its universal cover
    is the regular tree); small irregular bases come out BELOW the
    unstructured (lambda, rho) ensemble threshold -- the frozen base
    connectivity is a constraint, quantifying round 5's measured
    base-size law.
    """
    lo, hi = 0.0, 1.0
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        x = protograph_de(base_chk, nb, mid, max_iterations=5_000,
                          tolerance=tolerance)
        if float(x.max()) < tolerance:
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Density evolution and the BP threshold (the JAX package's theory.py:39-121)
# ---------------------------------------------------------------------------

def density_evolution(erasure_prob: float, iterations: int, dv: int, dc: int,
                      threshold: float = 0.0) -> List[float]:
    """Edge-erasure DE recursion x_{t+1} = eps(1-(1-x_t)^(dc-1))^(dv-1).

    Returns the trajectory [eps, x_1, x_2, ...], truncated when the value
    drops to ``threshold`` (tools/density_evolution.py:9-16).
    """
    results = [erasure_prob]
    x = erasure_prob
    for _ in range(iterations):
        x = erasure_prob * (1.0 - (1.0 - x) ** (dc - 1)) ** (dv - 1)
        if x <= threshold:
            break
        results.append(x)
    return results

def modified_density_evolution(erasure_prob: float, iterations: int, dv: int,
                               dc: int, threshold: float = 0.0
                               ) -> List[float]:
    """Bit-erasure DE: tracks eps(1-(1-x)^(dc-1))^dv alongside the edge
    recursion -- the curve overlaid on simulated BER-vs-iteration plots
    (tools/density_evolution.py:18-28, used at tools/plotting.py:86)."""
    results = [erasure_prob]
    x = erasure_prob
    for _ in range(iterations):
        inner = 1.0 - (1.0 - x) ** (dc - 1)
        bit_prob = erasure_prob * inner ** dv
        x = erasure_prob * inner ** (dv - 1)
        if bit_prob <= threshold:
            break
        results.append(bit_prob)
    return results

def below_threshold(erasure_prob: float, dv: int, dc: int,
                    max_iterations: int = 100_000,
                    tolerance: float = 1e-6) -> bool:
    """Does DE drive the erasure probability below ``tolerance``?

    Same fixed point test as the reference (test_de_threshold.py:7-15) but
    with convergence early-exit instead of a fixed 100000-iteration burn.
    """
    x = erasure_prob
    for _ in range(max_iterations):
        new_x = erasure_prob * (1.0 - (1.0 - x) ** (dc - 1)) ** (dv - 1)
        if new_x < tolerance:
            return True
        # monotone decreasing recursion: stagnation => stuck above tolerance
        if x - new_x < 1e-15:
            return False
        x = new_x
    return x < tolerance

@lru_cache(maxsize=None)
def calc_threshold(dv: int, dc: int, precision: float = 1e-9) -> float:
    """BP threshold eps*(dv,dc) by bisection (test_de_threshold.py:17-28).

    Verified anchors: eps*(3,6) ~= 0.4294375, eps*(4,8) ~= 0.3834453.
    """
    lo, hi = 0.0, 1.0
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if below_threshold(mid, dv, dc):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Finite-length scaling (theory.py:129-183)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def threshold_y(threshold_erasure: float, dv: int, dc: int,
                tol: float = 1e-6) -> float:
    """Fixed point y* of y = 1-(1-eps* y^(dv-1))^(dc-1)
    (finite_length_scaling_calculation.py:10-16)."""
    prev, y = 0.0, 1.0
    while abs(y - prev) > tol:
        prev = y
        y = 1.0 - (1.0 - threshold_erasure * y ** (dv - 1)) ** (dc - 1)
    return y

def threshold_x(threshold_erasure: float, dv: int, dc: int) -> float:
    """x* = eps* (y*)^(dv-1) (finite_length_scaling_calculation.py:20)."""
    return threshold_erasure * threshold_y(threshold_erasure, dv, dc) ** (dv - 1)

def calculate_alpha(threshold: float, dv: int, dc: int) -> float:
    """Scaling parameter alpha = eps* sqrt(((dv-1)/dv)(1/x* - 1/y*))
    (finite_length_scaling_calculation.py:18-21).  alpha(3,6) ~= 0.5595."""
    y = threshold_y(threshold, dv, dc)
    x = threshold * y ** (dv - 1)
    return threshold * math.sqrt(((dv - 1) / dv) * (1.0 / x - 1.0 / y))

def _norm_cdf(z):
    return 0.5 * np.ones_like(z) * (1.0 + np.vectorize(math.erf)(
        np.asarray(z) / math.sqrt(2.0)))

def waterfall_block_error(n, erasure_probs, dv: int = 3, dc: int = 6,
                          finite_size_shift: bool = False,
                          beta: float = BETA_3_6) -> np.ndarray:
    """Scaling-law waterfall P_block(n, eps) = Phi(-sqrt(n)(eps*-eps)/alpha)
    (finite_length_scaling_calculation.py:41-43; optional beta n^(-2/3)
    shift).  ``beta`` defaults to the repo-wide :data:`BETA_3_6`; pass
    ``beta=BETA_3_6_WATERFALL`` for the reference's commented variant
    (finite_length_scaling_calculation.py:40)."""
    erasure_probs = np.asarray(erasure_probs, float)
    thr = calc_threshold(dv, dc)
    alpha = calculate_alpha(thr, dv, dc)
    shift = beta * float(n) ** (-2.0 / 3.0) if finite_size_shift else 0.0
    z = math.sqrt(n) * (thr - erasure_probs - shift)
    return _norm_cdf(-z / alpha)

def critical_point_variance(n: int, erasure_prob: float, dv: int, dc: int
                            ) -> float:
    """Variance of the degree-1 check count at the critical point
    (peeling_decoder.py:225)."""
    thr = calc_threshold(dv, dc)
    alpha = calculate_alpha(thr, dv, dc)
    y = threshold_y(thr, dv, dc)
    return n * dv ** 2 * (alpha * thr * (dc - 1) * y ** (2 * dv - 2)
                          * (1.0 - thr * y ** (dv - 1)) ** (dc - 2)) ** 2


# ---------------------------------------------------------------------------
# The peeling drift and its critical point (theory.py:191-301)
# ---------------------------------------------------------------------------

def peeling_drift_normalized(erasure_prob: float, dv: int, dc: int, y
                             ) -> np.ndarray:
    """Expected fraction-of-edges drift r(y) = eps y^(dv-1)
    (y - 1 + (1 - eps y^(dv-1))^(dc-1)) (test_peeling_decoder_path.py:12-14).
    ``y`` is the fraction of *unresolved* erased variables remaining."""
    y = np.asarray(y, float)
    x = erasure_prob * y ** (dv - 1)
    return x * (y - 1.0 + (1.0 - x) ** (dc - 1))

def peeling_drift(erasure_prob: float, dv: int, dc: int, n: int, steps
                  ) -> np.ndarray:
    """Expected degree-1 check count after ``steps`` peeling steps remain
    -- the reference's ``dv*n*f(...)`` in absolute time units
    (peeling_decoder.py:101-107): steps counts down from n*eps, and
    y = (1 - steps/(eps n))^(1/dv)."""
    steps = np.asarray(steps, float)
    y = (1.0 - steps / (erasure_prob * n)) ** (1.0 / dv)
    return dv * n * peeling_drift_normalized(erasure_prob, dv, dc, y)

def irregular_peeling_drift_normalized(erasure_prob: float, lam, rho, x
                                       ) -> np.ndarray:
    """Expected degree-1 fraction-of-edges drift for a (lambda, rho)
    ensemble: r1(x) = eps lambda(x) (x - 1 + rho(1 - eps lambda(x))).

    The irregular generalisation of :func:`peeling_drift_normalized`
    (LMSS "Efficient Erasure Correcting Codes" differential-equation
    analysis); with the degenerate distributions of
    :func:`regular_lam_rho` it reduces to the regular formula exactly
    (lambda(x) = x^(dv-1), rho(z) = z^(dc-1)).  ``x`` runs 1 -> 0 over
    the peel; the unresolved-erased-variable fraction at time x is
    eps * L(x) with L the node-perspective variable polynomial
    (:func:`node_perspective`), generalising the regular y^dv mapping.

    Sanity anchor at x=1 (before any peel): r1(1) = eps rho(1-eps), the
    direct expected fraction of edges in degree-1 checks after stripping
    the received bits.
    """
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    x = np.asarray(x, float)
    lx = np.polyval(lam[::-1], x)
    return erasure_prob * lx * (
        x - 1.0 + np.polyval(rho[::-1], 1.0 - erasure_prob * lx))

def _node_poly_val(lam, x):
    """L(x) = sum_d L_d x^d with L the node-perspective distribution."""
    node = node_perspective(lam)
    x = np.asarray(x, float)
    return sum(nd * x ** (i + 1) for i, nd in enumerate(node))

def _invert_node_poly(lam, target) -> np.ndarray:
    """x with L(x) = target (L monotone increasing on [0,1]); vectorised
    bisection."""
    target = np.asarray(target, float)
    lo = np.zeros_like(target)
    hi = np.ones_like(target)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = _node_poly_val(lam, mid) < target
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)

def irregular_peeling_drift(erasure_prob: float, lam, rho, n: int, steps,
                            avg_dv: float | None = None) -> np.ndarray:
    """Expected degree-1 check COUNT after ``steps`` peels of a length-n
    (lambda, rho) code -- the irregular analogue of :func:`peeling_drift`.

    Each peel resolves one variable, so the unresolved fraction after s
    peels is eps - s/n = eps L(x); inverting L gives the x to evaluate
    :func:`irregular_peeling_drift_normalized` at, scaled by the edge
    count E = n / int(lambda).
    """
    lam_c = _poly_check(lam, "lam")
    if avg_dv is None:
        avg_dv = 1.0 / float(sum(c / (i + 1)
                                 for i, c in enumerate(lam_c)))
    steps = np.asarray(steps, float)
    frac_left = np.clip(1.0 - steps / (erasure_prob * n), 0.0, 1.0)
    x = _invert_node_poly(lam, frac_left)
    return n * avg_dv * irregular_peeling_drift_normalized(
        erasure_prob, lam, rho, x)

def irregular_critical_x(lam, rho, erasure_prob: float | None = None
                         ) -> float:
    """The peeling-time x where the drift is at its interior minimum
    (at eps = eps* the minimum touches zero -- the critical point of the
    irregular R-process; regular inputs reproduce the tangency point of
    :func:`calculate_crit_point` in the x-coordinate y*).

    ``erasure_prob`` defaults to the ensemble's BP threshold.
    """
    if erasure_prob is None:
        erasure_prob = irregular_threshold(lam, rho, 1e-7)
    xs = np.linspace(1e-6, 1.0 - 1e-6, 200_001)
    r = irregular_peeling_drift_normalized(erasure_prob, lam, rho, xs)
    # r1 -> 0 at x=0 (completion) too, so look for the INTERIOR local
    # minimum -- the near-threshold dip where trajectories die; at
    # eps = eps* it touches zero (tangency).  Largest-x local minimum
    # wins (the first bottleneck the decoder must survive).
    interior = (r[1:-1] <= r[:-2]) & (r[1:-1] <= r[2:])
    idx = np.nonzero(interior)[0]
    if idx.size == 0:
        return float(xs[int(np.argmin(r))])
    return float(xs[idx[-1] + 1])


# ---------------------------------------------------------------------------
# Irregular (lambda, rho) ensembles (theory.py:529-617, 891)
# ---------------------------------------------------------------------------

def _poly_check(coeffs, name: str) -> np.ndarray:
    c = np.asarray(coeffs, float)
    if c.ndim != 1 or c.size < 2 or c[0] != 0.0:
        raise ValueError(
            f"{name} must be 1-D polynomial coefficients [c0, c1, ...] with "
            "c0 == 0 (no degree-1 edge mass) and degree >= 1")
    if (c < 0).any() or not math.isclose(float(c.sum()), 1.0, abs_tol=1e-9):
        raise ValueError(f"{name} coefficients must be >= 0 and sum to 1")
    return c

def _poly_val(c: np.ndarray, x: float) -> float:
    return float(np.polyval(c[::-1], x))

def irregular_density_evolution(erasure_prob: float, lam, rho,
                                iterations: int, threshold: float = 0.0
                                ) -> List[float]:
    """Edge-erasure DE x_{t+1} = eps * lambda(1 - rho(1 - x_t)).

    The irregular generalisation of :func:`density_evolution`; with the
    degenerate distributions of :func:`regular_lam_rho` the two recursions
    are identical.
    """
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    results = [erasure_prob]
    x = erasure_prob
    for _ in range(iterations):
        x = erasure_prob * _poly_val(lam, 1.0 - _poly_val(rho, 1.0 - x))
        if x <= threshold:
            break
        results.append(x)
    return results

def irregular_below_threshold(erasure_prob: float, lam, rho,
                              max_iterations: int = 100_000,
                              tolerance: float = 1e-6) -> bool:
    """Does irregular DE drive the edge erasure rate below ``tolerance``?"""
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    x = erasure_prob
    for _ in range(max_iterations):
        new_x = erasure_prob * _poly_val(lam, 1.0 - _poly_val(rho, 1.0 - x))
        if new_x < tolerance:
            return True
        # monotone decreasing recursion: stagnation => stuck above tolerance
        if x - new_x < 1e-15:
            return False
        x = new_x
    return x < tolerance

def irregular_threshold(lam, rho, precision: float = 1e-9) -> float:
    """BP threshold eps*(lambda, rho) by the same bisection as
    :func:`calc_threshold`.  Sanity properties (tested): equals the regular
    threshold on degenerate distributions, never exceeds the Shannon limit
    1 - design_rate, and never exceeds the stability limit
    1/(lambda'(0) rho'(1))."""
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    lo, hi = 0.0, 1.0
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if irregular_below_threshold(mid, lam, rho):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)

def node_perspective(lam) -> np.ndarray:
    """Edge-perspective lam -> node-perspective Lambda coefficients
    (Lambda[i] = fraction of *nodes* with degree i+1)."""
    lam = _poly_check(lam, "lam")
    degs = np.arange(1, lam.size + 1)
    node = np.where(lam > 0, lam / degs, 0.0)
    return node / node.sum()
