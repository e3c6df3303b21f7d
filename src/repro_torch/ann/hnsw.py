"""HNSW -- Hierarchical Navigable Small World graphs (Malkov & Yashunin,
the paper's headline graph algorithm [28]), as ``repro.ann.hnsw``.

Build (host, numpy, line for line the reference's, so the layers are equal
bit for bit): each point draws a geometric level, greedily descends from
the top entry to its level, then runs an ef_construction beam search per
level, connecting to the M closest candidates (with the occlusion
heuristic) and trimming neighbours to M_max.  The result is an
:class:`IndexState` whose ``layers`` entry is a tuple of padded int32
adjacency tensors ``[n, M_max]`` (one per level) on the device.

Query (device, all queries at once): greedy single-entry descent through
the upper layers, each lane until it stops improving, then the fixed-beam
ef search on layer 0 (:func:`repro_torch.ann.graph.beam_search`).

Paper context (Q2): HNSW's *hierarchy* is what fails on Rand-Euclidean
("the 'small-world' structure of these two methods hurts performance").
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann import distances as D
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        prepare_points, prepare_queries,
                                        register_functional)
from repro_torch.ann.graph import beam_search
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register


# ------------------------------------------------------------- host build
def _host_dist(X, metric, i, cand):
    """distances from point i to candidate ids (numpy)."""
    diff = X[cand] - X[i]
    if metric == "angular":
        return 1.0 - X[cand] @ X[i]
    return np.einsum("nd,nd->n", diff, diff)


def _search_layer(X, metric, adj, q_vec, entry, ef):
    """Beam search on one layer's adjacency dict (host)."""
    def dist(ids):
        if metric == "angular":
            return 1.0 - X[ids] @ q_vec
        diff = X[ids] - q_vec
        return np.einsum("nd,nd->n", diff, diff)

    visited = {entry}
    ed = float(dist(np.array([entry]))[0])
    cand = [(ed, entry)]                 # min-heap by construction order
    best = [(ed, entry)]
    while cand:
        cand.sort()
        cd, c = cand.pop(0)
        best.sort()
        if cd > best[min(len(best), ef) - 1][0] and len(best) >= ef:
            break
        nbrs = [v for v in adj.get(c, []) if v not in visited]
        if not nbrs:
            continue
        visited.update(nbrs)
        ds = dist(np.array(nbrs))
        for dv, v in zip(ds, nbrs):
            worst = best[min(len(best), ef) - 1][0] if len(best) >= ef \
                else np.inf
            if dv < worst or len(best) < ef:
                cand.append((float(dv), v))
                best.append((float(dv), v))
                best.sort()
                if len(best) > ef:
                    best.pop()
    return best                           # sorted (dist, id)


def _select(X, metric, i, candidates, M):
    """Occlusion heuristic: keep c unless a kept node is closer to c."""
    kept: list[int] = []
    for d_c, c in sorted(candidates):
        ok = True
        for kpt in kept:
            dk = _host_dist(X, metric, c, np.array([kpt]))[0]
            if dk < d_c:
                ok = False
                break
        if ok:
            kept.append(c)
        if len(kept) >= M:
            break
    if not kept:
        kept = [c for _, c in sorted(candidates)[:M]]
    return kept


def build(X: np.ndarray, *, metric: str = "euclidean", M: int = 16,
          ef_construction: int = 100, seed: int = 0,
          device=None) -> IndexState:
    dev = resolve_device(device)
    X = prepare_points(X, metric)
    n, dim = X.shape
    M = int(M)
    ef_construction = int(ef_construction)
    rng = np.random.default_rng(int(seed))
    mL = 1.0 / np.log(max(M, 2))
    levels = np.minimum(
        (-np.log(rng.random(n)) * mL).astype(np.int32), 6)
    adj = [dict() for _ in range(int(levels.max()) + 1)]  # per level
    entry, entry_level = 0, int(levels[0])

    for i in range(n):
        li = int(levels[i])
        if i == 0:
            for lv in range(li + 1):
                adj[lv][0] = []
            continue
        # greedy descent from the top to li+1
        cur = entry
        for lv in range(entry_level, li, -1):
            improved = True
            while improved:
                improved = False
                nbrs = adj[lv].get(cur, [])
                if nbrs:
                    ds = _host_dist(X, metric, i, np.array(nbrs))
                    j = int(np.argmin(ds))
                    if ds[j] < _host_dist(X, metric, i,
                                          np.array([cur]))[0]:
                        cur = nbrs[j]
                        improved = True
        # insert at each level <= li
        for lv in range(min(li, entry_level), -1, -1):
            best = _search_layer(X, metric, adj[lv], X[i], cur,
                                 ef_construction)
            M_max = M * 2 if lv == 0 else M
            nbrs = _select(X, metric, i, best, M)
            adj[lv][i] = list(nbrs)
            for v in nbrs:
                lst = adj[lv].setdefault(v, [])
                lst.append(i)
                if len(lst) > M_max:      # trim by distance
                    ds = _host_dist(X, metric, v, np.array(lst))
                    order = np.argsort(ds)[:M_max]
                    adj[lv][v] = [lst[o] for o in order]
            cur = best[0][1]
        if li > entry_level:
            entry, entry_level = i, li

    # flatten to padded int32 tensors for the device query path
    layers = []
    for lv in range(entry_level + 1):
        M_max = M * 2 if lv == 0 else M
        arr = np.full((n, M_max), -1, np.int32)
        for node, lst in adj[lv].items():
            arr[node, :min(len(lst), M_max)] = lst[:M_max]
        layers.append(torch.as_tensor(arr).to(dev))
    return IndexState("HNSW", metric, {
        "X": torch.as_tensor(X).to(dev), "layers": tuple(layers),
    }, {"n": n, "d": dim, "M": M, "entry": int(entry),
        "top": int(entry_level)})


# ------------------------------------------------------------ device query
def _greedy_layer(state: IndexState, Q, cur, adj):
    """Greedy descent on one upper layer, every lane until it stops
    improving (a lane that has stopped keeps its ``cur``)."""
    X, metric = state["X"], state.metric
    curd = D.masked_rows_to(X, Q, cur[:, None], metric)[:, 0]
    improved = torch.ones_like(cur, dtype=torch.bool)
    while bool(improved.any()):
        nbrs = adj[cur.long()]                             # [b, M]
        nd = D.masked_rows_to(X, Q, nbrs, metric)
        j = torch.argmin(nd, dim=1, keepdim=True)
        ndj = nd.gather(1, j)[:, 0]
        step = improved & (ndj < curd)
        cur = torch.where(step, nbrs.gather(1, j)[:, 0], cur)
        curd = torch.where(step, ndj, curd)
        improved = step
    return cur


def _beam_layer0(state: IndexState, Q, entry, *, k: int, ef, max_ef=None):
    """Fixed-beam ef search on layer 0, from each query's entry point (the
    pool holds the entry in slot 0 and -1 elsewhere).  ``max_ef`` as in
    :func:`repro_torch.ann.graph.search_with_stats`."""
    b, dev = Q.shape[0], Q.device
    cap = int(ef) if max_ef is None else int(max_ef)
    X, metric = state["X"], state.metric
    ids0 = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    ids0[:, 0] = entry
    d0 = torch.full((b, cap), float("inf"), device=dev)
    d0[:, 0] = D.masked_rows_to(X, Q, entry[:, None], metric)[:, 0]
    ids, d, _, it = beam_search(
        lambda nbrs: D.masked_rows_to(X, Q, nbrs, metric),
        state["layers"][0], ids0, d0, ef=ef, cap=cap, max_iter=ef + 8)
    kk = min(k, cap)
    return d[:, :kk], ids[:, :kk], it


def search_with_stats(state: IndexState, Q, *, k: int, ef: int = 32,
                      max_ef=None):
    """(dists [b, kk], ids [b, kk], layer-0 iterations [b] int32)."""
    Q = prepare_queries(Q, state.metric, state.device)
    if max_ef is None:
        ef = int(ef)
    cur = torch.full((Q.shape[0],), state.stat("entry"), dtype=torch.int32,
                     device=Q.device)
    for lv in range(state.stat("top"), 0, -1):   # greedy upper layers
        cur = _greedy_layer(state, Q, cur, state["layers"][lv])
    return _beam_layer0(state, Q, cur, k=k, ef=ef, max_ef=max_ef)


def search(state: IndexState, Q, *, k: int, ef: int = 32, max_ef=None):
    d, ids, _ = search_with_stats(state, Q, k=k, ef=ef, max_ef=max_ef)
    return d, ids


SPEC = register_functional(FunctionalSpec(
    name="HNSW", build=build, search=search,
    query_params=("ef", "max_ef"), query_defaults=(32, None),
    traced_knobs=(("ef", "max_ef"),),
))


# ------------------------------------------------------------ legacy class
@register("HNSW")
class HNSW(FunctionalANN):
    supported_metrics = ("euclidean", "angular")

    def __init__(self, metric: str, M: int = 16, ef_construction: int = 100,
                 seed: int = 0):
        super().__init__(metric, build_params=dict(
            M=int(M), ef_construction=int(ef_construction), seed=int(seed)))
        self.M = int(M)
        self.ef_construction = int(ef_construction)
        self.seed = int(seed)
        self.ef = 32
        self.name = f"HNSW(M={M},efC={ef_construction})"
        self._dist_comps = 0

    def _sync_state(self):
        self._top = self._state.stat("top")
        self._entry = self._state.stat("entry")

    def set_query_arguments(self, ef: int) -> None:
        self.ef = max(1, int(ef))
        self._qparams["ef"] = self.ef

    def _search_fn(self):
        return search_with_stats

    def _postprocess(self, out, Q, k):
        d, ids, it = out
        self._dist_comps += int(it.sum()) * \
            int(self._state["layers"][0].shape[1])
        return d, ids

    def get_additional(self):
        return {"dist_comps": self._dist_comps, "top_level": self._top}
