"""Analytic theory used by the port.

The port's own copy of the two protograph functions of the JAX package's
``iib_project_ldpc_codes_tpu/utils/theory.py`` (numpy only, held to the
originals by the tests): per-edge BEC density evolution on a base graph
and the threshold bisection over it, which :func:`..models.qc
.design_protograph` ranks sampled bases by.  The threshold of the
Z -> infinity lift of a base graph is the governing limit of the circulant
lifts in ``models/qc.py``: a lifted waterfall follows its BASE graph's
threshold, not the unstructured (lambda, rho) ensemble's.
"""

from __future__ import annotations

import numpy as np


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
