"""Linear-sum assignment for prediction<->label matching.

The reference uses scipy's Hungarian solver on 1 - IoU cost matrices at eval
time (reference: yogo/utils/prediction_formatting.py:297-303). scipy is used
when importable; otherwise a pure-numpy Jonker-Volgenant-style auction
fallback keeps eval runnable.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    from scipy.optimize import linear_sum_assignment as _scipy_lsa
except ImportError:  # pragma: no cover
    _scipy_lsa = None


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost assignment on a (possibly rectangular) cost matrix.
    Returns (row_idx, col_idx), rows sorted ascending (scipy convention)."""
    cost = np.asarray(cost, np.float64)
    if cost.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if _scipy_lsa is not None:
        r, c = _scipy_lsa(cost)
        return np.asarray(r, np.int64), np.asarray(c, np.int64)
    return _hungarian_numpy(cost)


def _hungarian_numpy(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """O(n^3) shortest-augmenting-path assignment (JV-style), pure numpy.
    Handles rectangular matrices by operating on the transposed orientation
    with n_rows <= n_cols."""
    transposed = cost.shape[0] > cost.shape[1]
    if transposed:
        cost = cost.T
    n, m = cost.shape
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.full(m + 1, n)  # p[j] = row assigned to column j (n = none)
    way = np.zeros(m + 1, np.int64)

    for i in range(n):
        p[m] = i
        j0 = m
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0, :] - u[i0] - v[:m]
            better = ~used[:m] & (cur < minv[:m])
            minv[:m] = np.where(better, cur, minv[:m])
            way[:m] = np.where(better, j0, way[:m])
            unused = ~used[:m]
            j1 = int(np.argmin(np.where(unused, minv[:m], INF)))
            delta = minv[j1]
            # update potentials along the alternating tree
            u[p[used]] += delta
            v_used = used[:m]
            v[:m][v_used] -= delta
            minv[:m][~v_used] -= delta
            j0 = j1
            if p[j0] == n:
                break
        while j0 != m:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1

    rows = np.empty(n, np.int64)
    cols = np.empty(n, np.int64)
    k = 0
    for j in range(m):
        if p[j] != n:
            rows[k] = p[j]
            cols[k] = j
            k += 1
    # sort by the axis that will be RETURNED as row indices (scipy sorts
    # its first output ascending): after a transpose, the original row
    # indices live in `cols`
    order = np.argsort(cols if transposed else rows)
    rows, cols = rows[order], cols[order]
    if transposed:
        return cols, rows
    return rows, cols
