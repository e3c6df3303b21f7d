"""Functional index core: ``IndexState`` + pure search (``repro.ann.functional``).

Every algorithm is a pair of plain functions over a container of tensors:

    build(X, *, metric, device=None, **build_params) -> IndexState
    search(state, Q, *, k, **query_params) -> (dists [b, k], ids [b, k])

``IndexState`` holds the tensors (corpus, centroids, lists) on one device
plus a static dict of hyperparameters.  PyTorch runs eagerly, so there is
no trace to cache: :func:`bind_search` only pins the static knobs, and the
*traced* knobs of the reference (``n_probes`` under a ``max_probes`` cap,
``scan`` under ``max_scan``) arrive as 0-d tensors from which the search
builds the same in-window masks.  ``search_sweep_points`` (the reference's
vmapped grid path) is a loop over the points that returns the same
``[S, b, kk]`` stack.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bits import words_to_tensor


def _freeze(value: Any) -> Any:
    """Make a static value hashable (lists -> tuples, recursively)."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    return value


class IndexState:
    """A built index: named tensors on one device + static hyperparameters.

    Treat instances as frozen.
    """

    __slots__ = ("algo", "metric", "arrays", "static")

    def __init__(self, algo: str, metric: str,
                 arrays: Mapping[str, Any],
                 static: Optional[Mapping[str, Any]] = None):
        self.algo = algo
        self.metric = metric
        self.arrays = dict(arrays)
        self.static = {k: _freeze(v) for k, v in dict(static or {}).items()}

    def __getitem__(self, key: str):
        return self.arrays[key]

    def stat(self, key: str):
        return self.static[key]

    @property
    def device(self) -> torch.device:
        for a in self.arrays.values():
            if torch.is_tensor(a):
                return a.device
        return torch.device("cpu")

    def nbytes(self) -> int:
        """Bytes of every tensor, those inside a tuple or list included
        (HNSW's ``layers``), as the reference counts every tree leaf."""
        leaves = [leaf for a in self.arrays.values()
                  for leaf in (a if isinstance(a, (tuple, list)) else (a,))]
        return int(sum(a.numel() * a.element_size()
                       for a in leaves if torch.is_tensor(a)))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"IndexState({self.algo!r}, {self.metric!r}, "
                f"arrays={sorted(self.arrays)}, "
                f"{self.nbytes() / 1024:.0f} kB)")


@dataclasses.dataclass(frozen=True)
class FunctionalSpec:
    """One algorithm's functional API: ``build`` + ``search``.

    ``query_params``        positional order of query-time knobs (the
                            ``set_query_arguments`` convention).
    ``query_defaults``      default value per knob.
    ``static_query_params`` knobs that size the candidate window.
    ``traced_knobs``        (knob, cap) pairs: a knob that may be a runtime
                            value once its ``max_*`` cap is pinned; the
                            window is then sized by the cap and work past
                            the knob value is masked.
    """

    name: str
    build: Callable[..., IndexState]
    search: Callable[..., Tuple[Any, Any]]
    query_params: Tuple[str, ...] = ()
    query_defaults: Tuple[Any, ...] = ()
    static_query_params: Optional[Tuple[str, ...]] = None
    supported_metrics: Tuple[str, ...] = ("euclidean", "angular")
    traced_knobs: Tuple[Tuple[str, str], ...] = ()

    def default_query_params(self) -> Dict[str, Any]:
        return dict(zip(self.query_params, self.query_defaults))

    def cap_for(self, knob: str) -> str:
        """The static cap partner of a traced-capable knob."""
        caps = dict(self.traced_knobs)
        if knob not in caps:
            raise KeyError(
                f"{self.name} has no traced-cap treatment for knob "
                f"{knob!r}; traced knobs: {sorted(caps)}")
        return caps[knob]


def bind_search(fn: Callable, spec: FunctionalSpec,
                traced: Sequence[str] = ()) -> Callable:
    """``fn`` with the ``traced`` knobs passed as 0-d int32 tensors.

    The counterpart of the reference's ``jit_search_fn``: a traced knob
    needs its ``max_*`` cap at call time, which sizes the window; the knob
    value itself only feeds the masks.
    """
    traced = tuple(traced)
    caps = dict(spec.traced_knobs)
    unknown = [t for t in traced if t not in caps]
    if unknown:
        raise ValueError(
            f"{spec.name}: knob(s) {unknown} have no traced-cap treatment; "
            f"traceable knobs: {sorted(caps)}")

    @functools.wraps(fn)
    def search(state, Q, **kwargs):
        for knob in traced:
            if kwargs.get(knob) is not None:
                kwargs[knob] = torch.as_tensor(int(kwargs[knob]),
                                               dtype=torch.int32,
                                               device=state.device)
        return fn(state, Q, **kwargs)

    return search


FUNCTIONAL: Dict[str, FunctionalSpec] = {}


def _metric_checked_build(spec: FunctionalSpec) -> Callable[..., IndexState]:
    """Wrap a build fn so unsupported metrics fail fast."""
    import inspect

    original = spec.build
    default = inspect.signature(original).parameters["metric"].default

    @functools.wraps(original)
    def build(X, *, metric=default, **params) -> IndexState:
        if metric not in spec.supported_metrics:
            raise ValueError(
                f"{spec.name} does not support metric {metric!r} "
                f"(supported: {list(spec.supported_metrics)})")
        return original(X, metric=metric, **params)

    return build


def register_functional(spec: FunctionalSpec) -> FunctionalSpec:
    if spec.name in FUNCTIONAL:
        raise ValueError(f"duplicate functional registration: {spec.name}")
    spec = dataclasses.replace(spec, build=_metric_checked_build(spec))
    FUNCTIONAL[spec.name] = spec
    return spec


def get_functional(name: str) -> FunctionalSpec:
    """Resolve a functional spec, importing the algorithm package first."""
    import importlib

    importlib.import_module("repro_torch.ann")
    spec = FUNCTIONAL.get(name)
    if spec is None:
        raise KeyError(
            f"no functional spec for {name!r}; known: {sorted(FUNCTIONAL)}")
    return spec


def available_functional() -> Dict[str, FunctionalSpec]:
    """Every registered functional spec by name
    (``repro.ann.functional.available_functional``)."""
    import importlib

    importlib.import_module("repro_torch.ann")
    return dict(FUNCTIONAL)


def search_sweep_points(state: IndexState, Q, *, k: int,
                        points: Sequence[Mapping[str, Any]],
                        **query_params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate explicit knob combinations, one search per point.

    ``points`` is a non-empty sequence of ``{knob: value}`` dicts, all with
    the same set of traced-capable knobs.  Each knob's ``max_*`` cap is
    pinned to the max over points unless passed in ``query_params``, so
    every point runs at the cap-sized window with its own mask, as in the
    reference's vmapped sweep.  Returns ``(dists [S, b, kk], ids [S, b,
    kk])``; row ``i`` is what the static path returns for ``points[i]``.
    """
    spec = get_functional(state.algo)
    points = list(points)
    if not points:
        raise ValueError("points must be a non-empty sequence of knob dicts")
    knobs = tuple(points[0])
    if not knobs:
        raise ValueError("each point must set at least one knob")
    for pt in points:
        if tuple(pt) != knobs:
            raise ValueError(
                f"every point must set the same knobs; got {sorted(knobs)} "
                f"and {sorted(pt)}")
    fixed = dict(query_params)
    caps = {}
    for knob in knobs:
        cap_name = spec.cap_for(knob)
        if knob in fixed:
            raise ValueError(
                f"{knob!r} appears in both the sweep grid and "
                f"query_params; its value comes from the grid -- drop it "
                f"from query_params")
        vmax = max(int(pt[knob]) for pt in points)
        cap = fixed.pop(cap_name, None)
        if cap is None:
            cap = vmax
        elif vmax > int(cap):
            raise ValueError(
                f"sweep value {knob}={vmax} exceeds {cap_name}={int(cap)}; "
                f"the in-window mask would clamp it and mislabel the row -- "
                f"raise the cap or drop the value")
        caps[cap_name] = int(cap)
    search = bind_search(spec.search, spec, traced=knobs)
    outs = [search(state, Q, k=int(k), **caps, **fixed,
                   **{kn: int(pt[kn]) for kn in knobs}) for pt in points]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


# --------------------------------------------------------------------------
# shared build helpers
# --------------------------------------------------------------------------

def prepare_points(X: np.ndarray, metric: str) -> np.ndarray:
    """Host-side canonicalisation: float32 (unit-normalised for angular),
    packed uint32 words for hamming."""
    if metric == "hamming":
        return np.asarray(X, np.uint32)
    X = np.asarray(X, np.float32)
    if metric == "angular":
        X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    return X


def prepare_queries(Q, metric: str, device) -> torch.Tensor:
    """Device-side canonicalisation of a query batch."""
    if metric == "hamming":
        return words_to_tensor(Q, device)
    Q = torch.as_tensor(Q).to(device=device, dtype=torch.float32)
    if metric == "angular":
        Q = Q / torch.clamp_min(torch.linalg.norm(Q, dim=1, keepdim=True),
                                1e-12)
    return Q
