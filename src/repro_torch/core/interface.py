"""The paper's programmatic interface for k-NN algorithms (§3.1), as in
``repro.core.interface``.

  fit(X, device=None)       -- preprocessing phase: build the index on
                               ``device`` (``cuda`` unless told otherwise).
  set_query_arguments(...)  -- reconfigure query-time parameters.
  query(q, k)               -- single query -> up to k candidate row ids.
  batch_query(Q, k)         -- batch mode (§3.5); the framework calls
                               get_batch_results() off the clock.
  get_batch_results()       -- materialise batch results after the clock.
  get_additional()          -- extra per-run info (``dist_comps``).
  index_size()              -- size of the built data structure in kB.
  done()                    -- release resources.

:class:`FunctionalANN` maps this onto a functional ``(build, search)``
spec (:mod:`repro_torch.ann.functional`).
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, sync


class BaseANN(abc.ABC):
    """Abstract base class for all benchmarked k-NN implementations."""

    name: str = "BaseANN"
    supported_metrics: Sequence[str] = ("euclidean", "angular")

    def __init__(self, metric: str):
        if metric not in self.supported_metrics:
            raise ValueError(
                f"{type(self).__name__} does not support metric {metric!r} "
                f"(supported: {list(self.supported_metrics)})"
            )
        self.metric = metric
        self._batch_results: Optional[Any] = None

    @abc.abstractmethod
    def fit(self, X: np.ndarray, device=None) -> None:
        """Preprocessing phase: build the index for dataset X [n, d]."""

    def set_query_arguments(self, *args: Any) -> None:
        """Reconfigure query parameters on an already-built index."""

    @abc.abstractmethod
    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        """Return up to k candidate indices for a single query point."""

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        self._batch_results = np.stack([self.query(q, k) for q in Q])

    def get_batch_results(self) -> np.ndarray:
        """The last batch_query's result as an [nq, <=k] integer array."""
        if self._batch_results is None:
            raise RuntimeError("batch_query() has not been called")
        out = self._batch_results
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        self._batch_results = None
        return out

    def get_additional(self) -> Dict[str, Any]:
        return {}

    def index_size(self) -> float:
        return 0.0

    def done(self) -> None:
        """Release any resources held by the index."""

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


class FunctionalANN(BaseANN):
    """Generic BaseANN adapter over a functional ``(build, search)`` spec.

    The built index lives in ``self._state``; ``query`` and ``batch_query``
    both call the spec's ``search`` with the current query params.
    """

    batch_block: int = 4096

    def __init__(self, metric: str, algo: Optional[str] = None,
                 build_params: Optional[Dict[str, Any]] = None,
                 query_params: Optional[Dict[str, Any]] = None):
        from repro_torch.ann.functional import get_functional

        spec = get_functional(algo or type(self).registry_name)
        self.supported_metrics = spec.supported_metrics
        super().__init__(metric)
        self._spec = spec
        self._build_params = dict(build_params or {})
        self._qparams = spec.default_query_params()
        if query_params:
            self._qparams.update(query_params)
        self._state = None
        self._search = None
        self._traced_knobs: tuple = ()
        if algo is not None:
            self.name = f"Functional({spec.name})"

    def fit(self, X: np.ndarray, device=None) -> None:
        self._state = self._spec.build(X, metric=self.metric,
                                       device=resolve_device(device),
                                       **self._build_params)
        self._sync_state()
        self._rebind()

    def _sync_state(self) -> None:
        """Hook: subclasses mirror host-side attributes from the state."""

    def _rebind(self) -> None:
        from repro_torch.ann.functional import bind_search

        self._search = bind_search(self._search_fn(), self._spec,
                                   traced=self._traced_knobs)

    def _search_fn(self):
        """Hook: the search function to bind (default: the spec's)."""
        return self._spec.search

    def set_query_arguments(self, *args: Any) -> None:
        names = self._spec.query_params
        if len(args) > len(names):
            raise TypeError(
                f"{self._spec.name} takes at most {len(names)} query "
                f"arguments {names}, got {len(args)}")
        self._qparams.update(zip(names, args))

    def prepare_query_sweep(self, qgroups: Sequence[tuple]) -> tuple:
        """Pin each sweepable knob's ``max_*`` cap to the largest value
        across ``qgroups`` and pass the knob as a runtime value, so every
        group runs at one window size (the reference's one-trace sweep).
        Returns the knobs so treated."""
        traced = []
        for knob, cap in self._spec.traced_knobs:
            if knob not in self._spec.query_params:
                continue
            pos = self._spec.query_params.index(knob)
            vals = [g[pos] for g in qgroups
                    if len(g) > pos and isinstance(g[pos], (int, np.integer))]
            if len(set(vals)) < 2:
                continue
            default = self._qparams.get(knob)
            if isinstance(default, (int, np.integer)):
                vals.append(default)
            self._qparams[cap] = int(max(vals))
            traced.append(knob)
        if traced:
            self._traced_knobs = tuple(traced)
            if self._state is not None:
                self._rebind()
        return tuple(traced)

    def plan_query_sweep(self, qgroups: Sequence[tuple]):
        """Map positional query-args groups onto one sweep: ``(points,
        fixed)`` for :meth:`run_query_sweep`, or None when the groups cannot
        be served by one (ragged groups, a non-knob position varying,
        non-integer knob values, non-scalar fixed params)."""
        if self._state is None or not qgroups:
            return None
        names = self._spec.query_params
        lens = {len(g) for g in qgroups}
        if len(lens) != 1:
            return None
        width = lens.pop()
        if width == 0 or width > len(names):
            return None
        caps = dict(self._spec.traced_knobs)
        fixed = dict(self._qparams)
        points: list = [dict() for _ in qgroups]
        for pos, vals in enumerate(zip(*qgroups)):
            name = names[pos]
            if len(set(map(repr, vals))) == 1:
                fixed[name] = vals[0]
            elif name in caps and all(
                    isinstance(v, (int, np.integer)) for v in vals):
                for pt, v in zip(points, vals):
                    pt[name] = int(v)
            else:
                return None
        if not points[0]:
            return None
        for knob in points[0]:
            fixed.pop(knob, None)
            fixed.pop(caps[knob], None)
        if not all(isinstance(v, (int, float, bool, str, type(None)))
                   for v in fixed.values()):
            return None
        return points, fixed

    def run_query_sweep(self, Q, k: int, points, fixed):
        """Run the whole query-args grid (:func:`search_sweep_points`);
        returns device ``(dists, ids)`` of shape [n_groups, nq, kk], with
        the device's work finished (the caller times this call)."""
        from repro_torch.ann.functional import search_sweep_points

        out = search_sweep_points(self._state, Q, k=int(k), points=points,
                                  **fixed)
        sync(self._state.device)
        return out

    def _postprocess(self, out: Any, Q: Any, k: int):
        """Hook: raw search output -> (dists, ids); record per-run stats."""
        return out

    def _run_search(self, Q, k: int):
        out = self._search(self._state, Q, k=int(k), **self._qparams)
        return self._postprocess(out, Q, k)

    def _batch_block_size(self, k: int) -> int:
        return self.batch_block

    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        _, ids = self._run_search(np.asarray(q)[None, :], k)
        return ids[0].cpu().numpy()

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        from repro_torch.ann.functional import queries_on

        block = max(1, int(self._batch_block_size(k)))
        dev = self._state.device
        Qt = queries_on(Q, self.metric, dev)
        outs = []
        for s in range(0, Q.shape[0], block):
            _, ids = self._run_search(Qt[s:s + block], k)
            outs.append(ids)
        self._batch_results = torch.cat(outs, dim=0)
        sync(self._state.device)

    def index_size(self) -> float:
        if self._state is not None:
            return self._state.nbytes() / 1024.0
        return super().index_size()
