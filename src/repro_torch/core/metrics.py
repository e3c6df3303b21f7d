"""Quality and performance measures (paper §2.1, §2.2, Table 1).

A numpy-only copy of ``repro.core.metrics``, kept so that the port imports
nothing of the JAX package.

Quality measures are *distance based* to be robust against ties:

    recall(pi, pi*)   = |{p in pi : dist(p,q) <= dist(p*_k, q)}| / k
    recall_eps(pi,pi*) = |{p in pi : dist(p,q) <= (1+eps) dist(p*_k,q)}| / k

Every metric is a short function registered in ``METRICS``; the plotting and
results layers enumerate this registry, so "adding a new quality metric is a
matter of writing a short Python function and adding it to an internal data
structure" (§3.6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass
class RunRecord:
    """Everything the results layer stores for one (instance, query-args) run.

    ``neighbors``      [nq, k] int64, -1-padded candidate ids (as returned).
    ``distances``      [nq, k] float32, RE-COMPUTED by the framework.
    ``gt_neighbors``   [nq, k_gt] ground-truth ids.
    ``gt_distances``   [nq, k_gt] ground-truth distances (sorted).
    ``query_times``    [nq] seconds per query (empty in batch mode).
    ``total_time``     wall seconds for the whole query phase.
    ``build_time``     seconds of the preprocessing phase.
    ``index_size_kb``  kB after fit().
    ``count``          k requested.
    ``attrs``          free-form extras (dist_comps, candidates, ...).
    """

    algorithm: str
    instance_name: str
    query_arguments: tuple
    dataset: str
    count: int
    batch_mode: bool
    neighbors: np.ndarray
    distances: np.ndarray
    gt_neighbors: np.ndarray
    gt_distances: np.ndarray
    query_times: np.ndarray
    total_time: float
    build_time: float
    index_size_kb: float
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def nq(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def qps(self) -> float:
        return self.nq / self.total_time if self.total_time > 0 else float("inf")


# --------------------------------------------------------------------------
# quality metrics
# --------------------------------------------------------------------------

# ann-benchmarks' own numerical slack on the threshold comparison
# (their knn metric uses ``distances[count-1] + epsilon`` with eps=1e-3).
_ATOL = 1e-3


def recall_from_arrays(distances: np.ndarray, gt_distances: np.ndarray,
                       count: int, epsilon: float = 0.0,
                       neighbors: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-query distance-based (1+eps)-recall from raw arrays (paper §2.1).

    The single recall definition shared by the benchmark results layer
    (via :func:`recall` / :func:`recall_per_query`) and the serving path
    (launch/serve, examples/serve_ann, the CI serve-smoke gate) — so
    serve-time and benchmark-time recall cannot drift.

    ``distances``     [nq, >=count] re-computed distances of the returned
                      candidates (inf where missing).
    ``gt_distances``  [nq, >=count] true NN distances, sorted ascending.
    ``neighbors``     optional [nq, >=count] candidate ids; -1 entries are
                      treated as missing.
    """
    k = int(count)
    thresholds = gt_distances[:, k - 1]                # [nq]
    d = distances[:, :k]
    valid = neighbors[:, :k] >= 0 if neighbors is not None \
        else np.isfinite(d)
    within = (d <= (1.0 + epsilon) * thresholds[:, None] + _ATOL) & valid
    return np.sum(within, axis=1) / k


def recall(run: RunRecord, epsilon: float = 0.0) -> float:
    """Mean distance-based (1+eps)-recall over the query set (paper §2.1)."""
    return float(np.mean(recall_per_query(run, epsilon)))


def recall_per_query(run: RunRecord, epsilon: float = 0.0) -> np.ndarray:
    return recall_from_arrays(run.distances, run.gt_distances, run.count,
                              epsilon, neighbors=run.neighbors)


def set_recall(run: RunRecord) -> float:
    """Classical id-based recall (fragile under ties; kept for comparison)."""
    k = run.count
    hits = 0
    for row, gt in zip(run.neighbors[:, :k], run.gt_neighbors[:, :k]):
        hits += len(set(int(x) for x in row if x >= 0) & set(int(g) for g in gt))
    return hits / (k * run.nq)


# --------------------------------------------------------------------------
# performance metrics (Table 1)
# --------------------------------------------------------------------------

def qps(run: RunRecord) -> float:
    return run.qps


def build_time(run: RunRecord) -> float:
    return run.build_time


def index_size(run: RunRecord) -> float:
    return run.index_size_kb


def index_size_over_qps(run: RunRecord) -> float:
    """Fig 5's measure: index size (kB) scaled by achieved QPS."""
    q = run.qps
    return run.index_size_kb / q if q > 0 else float("inf")


def dist_computations(run: RunRecord) -> float:
    """Mean number of exact distance computations per query (Table 1's N)."""
    n = run.attrs.get("dist_comps")
    return float(n) / run.nq if n is not None else float("nan")


def percentile_time(run: RunRecord, p: float) -> float:
    if run.query_times.size == 0:
        return float("nan")
    return float(np.percentile(run.query_times, p))


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    description: str
    function: Callable[[RunRecord], float]
    worst: float                    # worst possible value, for pareto direction
    better: str                     # "higher" | "lower"


METRICS: Dict[str, Metric] = {}


def register_metric(name: str, description: str, better: str,
                    worst: float) -> Callable:
    def deco(fn: Callable[[RunRecord], float]) -> Callable[[RunRecord], float]:
        METRICS[name] = Metric(name, description, fn, worst, better)
        return fn

    return deco


register_metric("k-nn", "Recall", "higher", 0.0)(lambda r: recall(r, 0.0))
register_metric("epsilon-0.01", "Recall (1.01-approx)", "higher", 0.0)(
    lambda r: recall(r, 0.01))
register_metric("epsilon-0.1", "Recall (1.1-approx)", "higher", 0.0)(
    lambda r: recall(r, 0.1))
register_metric("set-recall", "Id-based recall", "higher", 0.0)(set_recall)
register_metric("qps", "Queries per second (1/s)", "higher", 0.0)(qps)
register_metric("build", "Index build time (s)", "lower", float("inf"))(build_time)
register_metric("indexsize", "Index size (kB)", "lower", float("inf"))(index_size)
register_metric("queriessize", "Index size (kB)/QPS (s)", "lower", float("inf"))(
    index_size_over_qps)
register_metric("distcomps", "Distance computations per query", "lower",
                float("inf"))(dist_computations)
register_metric("p50", "Median query time (s)", "lower", float("inf"))(
    lambda r: percentile_time(r, 50))
register_metric("p95", "95th percentile query time (s)", "lower", float("inf"))(
    lambda r: percentile_time(r, 95))
register_metric("p99", "99th percentile query time (s)", "lower", float("inf"))(
    lambda r: percentile_time(r, 99))


def compute_all(run: RunRecord) -> Dict[str, float]:
    return {name: m.function(run) for name, m in METRICS.items()}
