"""Pareto frontier computation for (x, y) metric pairs (paper §3.7).

A numpy-only copy of ``repro.core.pareto``, kept so that the port imports
nothing of the JAX package.

"Plots depict the Pareto frontier over all runs of an algorithm; this gives
an immediate impression of the algorithm's general characteristics, at the
cost of concealing some of the detail."
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.metrics import METRICS, RunRecord


def frontier(
    points: Sequence[Tuple[float, float]],
    x_better: str = "higher",
    y_better: str = "higher",
) -> List[Tuple[float, float]]:
    """Return the Pareto-optimal subset, sorted by x.

    A point dominates another if it is at-least-as-good on both axes and
    strictly better on one.
    """
    if not points:
        return []
    sx = 1.0 if x_better == "higher" else -1.0
    sy = 1.0 if y_better == "higher" else -1.0
    pts = sorted(points, key=lambda p: (-sx * p[0], -sy * p[1]))
    out: List[Tuple[float, float]] = []
    best_y = -np.inf
    for x, y in pts:
        if sy * y > best_y:
            out.append((x, y))
            best_y = sy * y
    return sorted(out, key=lambda p: p[0])


def pareto_mask(xs: np.ndarray, ys: np.ndarray,
                x_better: str = "higher",
                y_better: str = "higher") -> np.ndarray:
    """Boolean mask of the Pareto-optimal points among (xs, ys).

    Unlike :func:`frontier` this keeps the caller's indexing — the tuner
    uses it to map frontier membership back onto operating points.
    """
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    sx = 1.0 if x_better == "higher" else -1.0
    sy = 1.0 if y_better == "higher" else -1.0
    n = xs.shape[0]
    mask = np.ones(n, bool)
    for i in range(n):
        dominated = ((sx * xs >= sx * xs[i]) & (sy * ys >= sy * ys[i])
                     & ((sx * xs > sx * xs[i]) | (sy * ys > sy * ys[i])))
        mask[i] = not bool(dominated.any())
    return mask


def metric_points(
    runs: Sequence[RunRecord], x_metric: str, y_metric: str
) -> Dict[str, List[Tuple[float, float, RunRecord]]]:
    """Group (x, y, run) triples by algorithm.

    Non-finite coordinates are dropped: NaN (undefined metrics) like
    before, but also ±inf — a degenerate zero-time run reports qps=inf
    (or queriessize=inf), and one such point would otherwise dominate and
    poison the whole frontier.
    """
    xm, ym = METRICS[x_metric], METRICS[y_metric]
    grouped: Dict[str, List[Tuple[float, float, RunRecord]]] = {}
    for run in runs:
        x, y = xm.function(run), ym.function(run)
        if not (np.isfinite(x) and np.isfinite(y)):
            continue
        grouped.setdefault(run.algorithm, []).append((x, y, run))
    return grouped


def algorithm_frontiers(
    runs: Sequence[RunRecord], x_metric: str = "k-nn", y_metric: str = "qps"
) -> Dict[str, List[Tuple[float, float]]]:
    xm, ym = METRICS[x_metric], METRICS[y_metric]
    grouped = metric_points(runs, x_metric, y_metric)
    return {
        algo: frontier([(x, y) for x, y, _ in pts], xm.better, ym.better)
        for algo, pts in grouped.items()
    }
