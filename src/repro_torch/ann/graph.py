"""k-NN-graph search -- the paper's graph-based family (KGraph, SWG, NSW;
Table 2), as ``repro.ann.graph``.

Build: the exact k-NN graph (:func:`repro_torch.data.exact_knn` on the
device), the self-edge dropped, optionally diversified on the host (the
occlusion pruning HNSW/NSG use), then ``extra_edges`` random shortcuts and
``n_entries`` entry points drawn from ``default_rng(seed)`` in the
reference's order.

Query: the reference vmaps one fixed-beam best-first ``lax.while_loop``
per query.  Here all ``b`` queries run at once on ``[b, cap]`` pools
(ids, distances, expanded flags, iterations): every step computes the
loop body for every lane, and a lane whose loop has ended keeps its state,
as the vmapped loop does.  Ties break as in the reference: the first
index of the smallest unexpanded distance, a stable (id, expanded-first)
order for the dedupe, a stable sort by distance for the selection.

``search_with_stats`` also returns the per-query expansion count (the
paper's distance-computation instrumentation); the registered ``search``
drops it to match the (dists, ids) contract.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann import distances as D
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        prepare_points, prepare_queries,
                                        register_functional)
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register


# --------------------------------------------------------------- functional
def build(X: np.ndarray, *, metric: str = "euclidean", degree: int = 16,
          diversify: bool = False, extra_edges: int = 2, n_entries: int = 16,
          seed: int = 0, device=None) -> IndexState:
    from repro_torch.data.groundtruth import exact_knn

    dev = resolve_device(device)
    X = prepare_points(X, metric)
    n, d = X.shape
    deg = min(int(degree), n - 1)
    nbrs, dists = exact_knn(X, X, deg + 1, metric, device=dev)
    # drop self-edges (first column after sort is the point itself)
    graph = np.where(nbrs[:, :1] == np.arange(n)[:, None],
                     nbrs[:, 1:deg + 1], nbrs[:, :deg])
    if diversify:
        graph = _diversify(X, graph, dists)
    rng = np.random.default_rng(int(seed))
    # Small-world shortcuts: a pure exact k-NN graph on clustered data is
    # near-disconnected across clusters (the paper's Q2 finding that graph
    # methods depend on global navigability); ``extra_edges`` uniform
    # random out-edges per node restore navigability.
    if int(extra_edges) > 0 and n > deg + 1:
        shortcuts = rng.integers(0, n, size=(n, int(extra_edges)))
        graph = np.concatenate([graph, shortcuts], axis=1)
    entries = rng.choice(n, size=min(int(n_entries), n),
                         replace=False).astype(np.int32)
    return IndexState("KNNGraph", metric, {
        "X": torch.as_tensor(X).to(dev),
        "graph": torch.as_tensor(graph.astype(np.int32)).to(dev),
        "entries": torch.as_tensor(entries).to(dev),
    }, {"n": n, "d": d, "degree": deg})


def _diversify(X, graph, dists):
    """Occlusion pruning (NSG/HNSW heuristic), per node."""
    n, deg = graph.shape
    keep = np.full_like(graph, -1)
    for i in range(n):
        cand = graph[i]
        kept: list[int] = []
        for c in cand:
            xc = X[c]
            ok = True
            for kpt in kept:
                # prune c if an already-kept neighbor is closer to c
                # than i is (c is "occluded")
                if np.sum((X[kpt] - xc) ** 2) < np.sum((X[i] - xc) ** 2):
                    ok = False
                    break
            if ok:
                kept.append(int(c))
            if len(kept) == deg:
                break
        while len(kept) < deg:          # refill with originals
            for c in cand:
                if int(c) not in kept:
                    kept.append(int(c))
                    break
        keep[i] = kept[:deg]
    return keep


def live_slots(cap: int, ef, device) -> torch.Tensor:
    """[cap] bool: the pool slots below ``ef`` (an int, or a 0-d tensor
    under a pinned cap)."""
    return torch.arange(cap, device=device) < torch.as_tensor(ef,
                                                              device=device)


def beam_search(dist_fn, adj, ids0, d0, *, ef, cap: int, max_iter):
    """Masked fixed-beam best-first search over a batch of queries, shared
    by KNNGraph and HNSW's layer 0 (:mod:`repro_torch.ann.hnsw`).

    Each query has a pool of ``cap`` (dist, id, expanded) entries
    (``ids0`` / ``d0`` [b, cap], with positions past ``ef`` already dead).
    Every step expands each lane's best unexpanded entry and dedupe-merges
    its adjacency row ``adj[cur]`` (distances via ``dist_fn(nbrs [b,
    deg])``), keeping the best ``cap`` by distance with slots past ``ef``
    re-masked to (+inf, -1).  A lane runs while it has an unexpanded finite
    entry and fewer than ``max_iter`` iterations; a lane that has stopped
    keeps its state while the others run on.  Returns ``(ids, d,
    expanded, iterations)``, each [b, cap] but the last [b] (int32).
    """
    b, deg = ids0.shape[0], adj.shape[1]
    dev = ids0.device
    live = live_slots(cap, ef, dev)[None, :]
    inf = torch.tensor(float("inf"), device=dev)
    ids, d = ids0, d0
    exp = torch.zeros((b, cap), dtype=torch.bool, device=dev)
    it = torch.zeros((b,), dtype=torch.int32, device=dev)
    fresh = torch.zeros((b, deg), dtype=torch.bool, device=dev)
    lead = torch.full((b, 1), -2, dtype=ids0.dtype, device=dev)
    max_iter = torch.as_tensor(max_iter, device=dev)
    while True:
        active = (~exp & torch.isfinite(d)).any(dim=1) & (it < max_iter)
        if not bool(active.any()):
            break
        sel = torch.argmin(torch.where(exp, inf, d), dim=1, keepdim=True)
        cur = ids.gather(1, sel)                           # [b, 1]
        nexp = exp.scatter(1, sel, True)
        nbrs = torch.where(cur >= 0, adj[torch.clamp_min(cur[:, 0], 0).long()],
                           -1)                             # [b, deg]
        nd = dist_fn(nbrs)
        all_ids = torch.cat([ids, nbrs], dim=1)
        all_d = torch.cat([d, nd], dim=1)
        all_exp = torch.cat([nexp, fresh], dim=1)
        # dedupe: stable sort by (id, not expanded); a duplicate has the
        # id of the entry before it (jnp.lexsort((~all_exp, all_ids)))
        key = all_ids.long() * 2 + (~all_exp).long()
        order = torch.sort(key, dim=1, stable=True).indices
        si = all_ids.gather(1, order)
        sd = all_d.gather(1, order)
        se = all_exp.gather(1, order)
        prev = torch.cat([lead, si[:, :-1]], dim=1)
        dup = (si == prev) | (si < 0)
        sd = torch.where(dup, inf, sd)
        si = torch.where(dup, -1, si)
        # keep the best cap by distance (stable), slots past ef re-masked
        order = torch.sort(sd, dim=1, stable=True).indices[:, :cap]
        si, sd, se = si.gather(1, order), sd.gather(1, order), \
            se.gather(1, order)
        si = torch.where(live, si, -1)
        sd = torch.where(live, sd, inf)
        se = se & live
        keep = active[:, None]
        ids = torch.where(keep, si, ids)
        d = torch.where(keep, sd, d)
        exp = torch.where(keep, se, exp)
        it = it + active.to(torch.int32)
    return ids, d, exp, it


def _start_pool(state: IndexState, Q, *, ef, cap: int):
    """The entries' pool [b, cap]: entries then empty slots, truncated to
    ``cap``, dead past ``ef``, stably sorted by distance."""
    entries = state["entries"]
    b, dev = Q.shape[0], Q.device
    n_entry = entries.shape[0]
    live = live_slots(cap, ef, dev)[None, :]
    e_ids = entries[None, :].expand(b, n_entry)
    e_d = D.masked_rows_to(state["X"], Q, e_ids, state.metric)
    ids0 = torch.cat([e_ids, torch.full((b, cap), -1, dtype=entries.dtype,
                                        device=dev)], dim=1)[:, :cap]
    d0 = torch.cat([e_d, torch.full((b, cap), float("inf"), device=dev)],
                   dim=1)[:, :cap]
    ids0 = torch.where(live, ids0, -1)
    d0 = torch.where(live, d0, float("inf"))
    order = torch.sort(d0, dim=1, stable=True).indices
    return ids0.gather(1, order), d0.gather(1, order)


def search_with_stats(state: IndexState, Q, *, k: int, ef: int = 32,
                      max_ef=None):
    """(dists [b, kk], ids [b, kk], expansions [b] int32), kk = min(k, cap).

    With ``max_ef`` the pool is allocated at the cap and ``ef`` may be a
    0-d tensor: one pool size serves every ef <= max_ef, equal to the
    static path for k <= ef (with ef < k the output keeps min(k, cap)
    columns, the tail being (+inf, -1) padding where the static path
    returns a narrower array).
    """
    Q = prepare_queries(Q, state.metric, state.device)
    if max_ef is None:
        ef = int(ef)
    cap = int(ef) if max_ef is None else int(max_ef)
    ids0, d0 = _start_pool(state, Q, ef=ef, cap=cap)
    X, metric = state["X"], state.metric
    ids, d, _, it = beam_search(
        lambda nbrs: D.masked_rows_to(X, Q, nbrs, metric), state["graph"],
        ids0, d0, ef=ef, cap=cap,
        max_iter=ef + state["entries"].shape[0])
    kk = min(k, cap)
    return d[:, :kk], ids[:, :kk], it


def search(state: IndexState, Q, *, k: int, ef: int = 32, max_ef=None):
    d, ids, _ = search_with_stats(state, Q, k=k, ef=ef, max_ef=max_ef)
    return d, ids


SPEC = register_functional(FunctionalSpec(
    name="KNNGraph", build=build, search=search,
    query_params=("ef", "max_ef"), query_defaults=(32, None),
    traced_knobs=(("ef", "max_ef"),),
))


# ------------------------------------------------------------ legacy class
@register("KNNGraph")
class KNNGraph(FunctionalANN):
    supported_metrics = ("euclidean", "angular")

    def __init__(self, metric: str, degree: int = 16, diversify: bool = False,
                 extra_edges: int = 2, n_entries: int = 16, seed: int = 0):
        super().__init__(metric, build_params=dict(
            degree=int(degree), diversify=bool(diversify),
            extra_edges=int(extra_edges), n_entries=int(n_entries),
            seed=int(seed)))
        self.degree = int(degree)
        self.diversify = bool(diversify)
        self.extra_edges = int(extra_edges)
        self.n_entries = int(n_entries)
        self.seed = int(seed)
        self.ef = 32
        self.name = (f"KNNGraph(deg={degree},rnd={extra_edges}"
                     f"{',div' if diversify else ''})")
        self._dist_comps = 0
        self._expansions = 0

    def set_query_arguments(self, ef: int) -> None:
        self.ef = max(1, int(ef))
        self._qparams["ef"] = self.ef

    def _search_fn(self):
        return search_with_stats

    def _postprocess(self, out, Q, k):
        d, ids, it = out
        exp = int(it.sum())
        self._expansions += exp
        self._dist_comps += (exp * int(self._state["graph"].shape[1])
                             + Q.shape[0] * self._state["entries"].shape[0])
        return d, ids

    def get_additional(self):
        return {"dist_comps": self._dist_comps,
                "expansions": self._expansions}
