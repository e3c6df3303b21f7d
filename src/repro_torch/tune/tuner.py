"""Constrained auto-tuner over query-knob grids (``repro.tune.tuner``).

The paper names automatic parameter tuning as the benchmark's long-term
goal; Sun et al., *Automating Nearest Neighbor Search Configuration with
Constrained Optimization* (2023), frames it as constrained operating-point
selection: maximise one metric subject to a floor/ceiling on another (max
QPS s.t. recall >= target, max recall s.t. latency <= budget).

:func:`grid_search` is that selection over a cartesian query-knob grid:

  * **quality** -- the whole grid through
    :func:`repro_torch.ann.functional.search_sweep_points` (every point at
    the cap-sized window with its own mask); per-combination recall comes
    from the shared benchmark definition
    (:func:`repro_torch.core.metrics.recall_from_arrays`), so tuner recall
    and benchmark recall cannot drift.
  * **speed** -- each combination is timed through the bound search
    (:func:`repro_torch.ann.functional.bind_search` with the caps pinned,
    the window a serving engine would run), best of ``repetitions``
    host-clock passes, each ending in :func:`repro_torch.sync`.

The result carries every grid point, the Pareto-optimal subset, and the
constrained argmax; ``core.plotting.tune_plot_png`` draws it and
``launch/tune.py`` prints it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch import sync
from repro_torch.ann.functional import (IndexState, bind_search,
                                        get_functional, grid_combos,
                                        queries_on, search_sweep_points)
from repro_torch.core.metrics import recall_from_arrays
from repro_torch.core.pareto import pareto_mask


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One evaluated knob combination."""

    params: Dict[str, int]          # the swept knob values
    recall: float                   # mean distance-based recall@k
    qps: float                      # queries/s through the bound search
    latency: float                  # mean seconds per query (1 / qps)

    def metric(self, name: str) -> float:
        if name not in ("recall", "qps", "latency"):
            raise KeyError(f"unknown tuning metric {name!r} "
                           f"(known: recall, qps, latency)")
        return float(getattr(self, name))


#: tuning metrics where larger is better (latency is the odd one out).
_HIGHER_IS_BETTER = {"recall": True, "qps": True, "latency": False}


@dataclasses.dataclass(frozen=True)
class Constraint:
    """Constrained operating-point selection (Sun et al. 2023, §2).

    Maximise ``objective`` subject to ``bound_metric`` being at least /
    at most ``bound`` -- e.g. ``Constraint.min_recall(0.9)`` is "max QPS
    s.t. recall >= 0.9"; ``Constraint.max_latency(1e-3)`` is "max recall
    s.t. mean per-query latency <= 1 ms".
    """

    bound_metric: str
    bound: float
    op: str                          # ">=" | "<="
    objective: str

    @classmethod
    def min_recall(cls, bound: float, objective: str = "qps") -> "Constraint":
        return cls("recall", float(bound), ">=", objective)

    @classmethod
    def max_latency(cls, bound: float,
                    objective: str = "recall") -> "Constraint":
        return cls("latency", float(bound), "<=", objective)

    def feasible(self, point: OperatingPoint) -> bool:
        v = point.metric(self.bound_metric)
        return v >= self.bound if self.op == ">=" else v <= self.bound

    def score(self, point: OperatingPoint) -> float:
        """Objective value, oriented so larger is always better."""
        v = point.metric(self.objective)
        return v if _HIGHER_IS_BETTER[self.objective] else -v

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        direction = "max" if _HIGHER_IS_BETTER[self.objective] else "min"
        return (f"{direction} {self.objective} s.t. "
                f"{self.bound_metric} {self.op} {self.bound:g}")


@dataclasses.dataclass
class TuneResult:
    """Everything :func:`grid_search` measured.

    ``points``   every grid combination, in :func:`grid_combos` order.
    ``pareto``   the (recall, qps)-Pareto-optimal subset.
    ``best``     the constrained argmax, or ``None`` if no grid point
                 satisfies the constraint (check before serving!).
    """

    points: List[OperatingPoint]
    pareto: List[OperatingPoint]
    best: Optional[OperatingPoint]
    constraint: Optional[Constraint]

    @property
    def ok(self) -> bool:
        return self.constraint is None or self.best is not None

    def best_params(self) -> Dict[str, int]:
        if self.best is None:
            raise ValueError(
                f"no grid point satisfies the constraint ({self.constraint})"
                f"; widen the grid or relax the bound")
        return dict(self.best.params)


def _pareto_points(points: Sequence[OperatingPoint]) -> List[OperatingPoint]:
    xs = np.asarray([p.recall for p in points], np.float64)
    ys = np.asarray([p.qps for p in points], np.float64)
    mask = pareto_mask(xs, ys)
    return [p for p, m in zip(points, mask) if m]


def select(points: Sequence[OperatingPoint],
           constraint: Constraint) -> Optional[OperatingPoint]:
    """The constrained argmax over already-evaluated points (ties broken
    toward the better constrained metric, then the smaller knob values --
    the cheapest config among equals)."""
    feasible = [p for p in points if constraint.feasible(p)]
    if not feasible:
        return None
    better = 1.0 if _HIGHER_IS_BETTER[constraint.bound_metric] else -1.0

    def rank(p: OperatingPoint):
        return (constraint.score(p), better * p.metric(constraint.bound_metric),
                tuple(-v for v in p.params.values()))

    return max(feasible, key=rank)


def grid_search(
    state: IndexState,
    Q,
    gt_distances,
    *,
    k: int = 10,
    knob_grid: Mapping[str, Sequence[int]],
    constraint: Optional[Constraint] = None,
    repetitions: int = 3,
    query_params: Optional[Mapping[str, Any]] = None,
) -> TuneResult:
    """Evaluate a cartesian query-knob grid on the index's device and pick
    the constrained-optimal operating point.

    ``Q``               [nq, d] query batch (array or tensor).
    ``gt_distances``    [nq, >=k] true NN distances, sorted ascending
                        (``dataset.distances`` in the benchmark layout).
    ``knob_grid``       {knob: values} over the spec's traced-capable
                        knobs -- all of them may be swept together.
    ``constraint``      optional :class:`Constraint`; without one,
                        ``best`` is ``None`` and only the grid + Pareto
                        set are returned.
    ``repetitions``     best-of-n timing passes per combination.

    Recall is computed from the sweep's own (dist, id) rows via
    :func:`repro_torch.core.metrics.recall_from_arrays` -- every registered
    algorithm reranks candidates with exact distances, so these are the
    framework-recomputed distances of paper §3.6 already.
    """
    spec = get_functional(state.algo)
    combos = grid_combos(knob_grid)
    fixed = dict(query_params or {})
    Qd = queries_on(Q, state.metric, state.device)
    gt = np.asarray(gt_distances)
    nq = Qd.shape[0]
    if gt.shape[0] != nq:
        raise ValueError(
            f"gt_distances rows ({gt.shape[0]}) != queries ({nq})")
    if gt.shape[1] < k:
        raise ValueError(
            f"gt_distances is only {gt.shape[1]} wide; need >= k={k}")

    # ---- quality: the whole grid, one cap-sized window per point
    dists, ids = search_sweep_points(state, Qd, k=k, points=combos, **fixed)
    dists = dists.cpu().numpy()
    ids = ids.cpu().numpy()
    if state.metric == "euclidean":
        # algorithms rerank in squared L2; ground truth (and
        # recall_from_arrays thresholds) are true L2 -- take the root
        dists = np.sqrt(np.maximum(dists, 0.0))
    if ids.shape[-1] < k:
        # a tight cap can make the sweep output narrower than k; recall
        # must still be recall@k (missing columns are missing neighbors),
        # not recall@width -- pad like the benchmark results layer does
        short = k - ids.shape[-1]
        dists = np.concatenate(
            [dists, np.full(dists.shape[:-1] + (short,), np.inf,
                            dists.dtype)], axis=-1)
        ids = np.concatenate(
            [ids, np.full(ids.shape[:-1] + (short,), -1, ids.dtype)],
            axis=-1)
    recalls = [
        float(np.mean(recall_from_arrays(
            dists[i][:, :k], gt, k, neighbors=ids[i][:, :k])))
        for i in range(len(combos))
    ]

    # ---- speed: per-combination timings through the bound search
    knobs = tuple(knob_grid)
    caps = {spec.cap_for(kn): max(int(v) for v in knob_grid[kn])
            for kn in knobs}
    for cap_name in caps:
        caps[cap_name] = int(fixed.pop(cap_name, caps[cap_name]))
    bound = bind_search(spec.search, spec, traced=knobs)
    dev = state.device
    timings = []
    for combo in combos:
        args = {**combo, **caps, **fixed}
        bound(state, Qd, k=k, **args)                          # warm
        sync(dev)
        best_t = np.inf
        for _ in range(max(1, int(repetitions))):
            t0 = time.perf_counter()
            bound(state, Qd, k=k, **args)
            sync(dev)
            best_t = min(best_t, time.perf_counter() - t0)
        timings.append(best_t)

    points = [
        OperatingPoint(params=dict(combo), recall=rec,
                       qps=nq / t if t > 0 else float("inf"),
                       latency=t / nq)
        for combo, rec, t in zip(combos, recalls, timings)
    ]
    pareto = _pareto_points(points)
    best = select(points, constraint) if constraint is not None else None
    return TuneResult(points=points, pareto=pareto, best=best,
                      constraint=constraint)
