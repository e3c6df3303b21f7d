"""RP-forest -- the Annoy analogue (paper Table 2, tree-based), as
``repro.ann.rpforest``.

Build (host, numpy, draw for draw the reference's): each tree recursively
splits the point set by the hyperplane equidistant to two randomly chosen
points (Annoy's rule; through-origin for angular).  Trees are flattened
into dense tensors in an :class:`IndexState`.

Query (device): every tree is descended once, recording |margin| at each
split; then the ``probe-1`` smallest-margin splits on the root paths get
their other child descended greedily too ("spill" search).  Candidates
from all leaves go through the shared exact rerank
(:func:`repro_torch.ann.lsh.rerank_candidates`).

The Hamming-space variant (bitsampling splits + popcount rerank) lives in
``repro_torch.ann.hamming``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        prepare_points, prepare_queries,
                                        register_functional)
from repro_torch.ann.lsh import live_mask, rerank_candidates
from repro_torch.ann.topk import topk_smallest
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register


class _TreeBuilder:
    def __init__(self, X: np.ndarray, leaf_size: int, angular: bool,
                 rng: np.random.Generator, max_depth: int):
        self.X, self.leaf_size, self.angular = X, leaf_size, angular
        self.rng, self.max_depth = rng, max_depth
        self.normals, self.offsets, self.children = [], [], []
        self.leaves: list[np.ndarray] = []

    def build(self, ids: np.ndarray, depth: int = 0) -> int:
        if len(ids) <= self.leaf_size or depth >= self.max_depth:
            self.leaves.append(ids)
            return -len(self.leaves)          # leaf id l encoded as -(l+1)
        w, b = self._split_plane(ids)
        side = self.X[ids] @ w > b
        if side.all() or (~side).all():       # degenerate: random halves
            side = self.rng.random(len(ids)) < 0.5
        node = len(self.normals)
        self.normals.append(w)
        self.offsets.append(b)
        self.children.append([0, 0])
        left = self.build(ids[~side], depth + 1)
        right = self.build(ids[side], depth + 1)
        self.children[node] = [left, right]
        return node

    def _split_plane(self, ids: np.ndarray):
        for _ in range(3):
            i, j = self.rng.choice(len(ids), 2, replace=False)
            p, q = self.X[ids[i]], self.X[ids[j]]
            w = p - q
            norm = np.linalg.norm(w)
            if norm > 1e-9:
                w = w / norm
                b = 0.0 if self.angular else float(w @ ((p + q) / 2.0))
                return w.astype(np.float32), b
        w = self.rng.standard_normal(self.X.shape[1]).astype(np.float32)
        w /= np.linalg.norm(w)
        return w, 0.0


# --------------------------------------------------------------- functional
def build(X: np.ndarray, *, metric: str = "euclidean", n_trees: int = 10,
          leaf_size: int = 32, seed: int = 0, rerank_kernel: bool = False,
          rerank_block=None, device=None) -> IndexState:
    dev = resolve_device(device)
    X = prepare_points(X, metric)
    n, d = X.shape
    n_trees, leaf_size = int(n_trees), int(leaf_size)
    rng = np.random.default_rng(int(seed))
    max_depth = int(np.ceil(np.log2(
        max(2.0, n / max(1, leaf_size))))) + 4

    trees = []
    for _ in range(n_trees):
        tb = _TreeBuilder(X, leaf_size, metric == "angular", rng, max_depth)
        root = tb.build(np.arange(n))
        trees.append((tb, root))

    max_nodes = max(max(len(tb.normals), 1) for tb, _ in trees)
    max_leaves = max(len(tb.leaves) for tb, _ in trees)
    T = n_trees
    normals = np.zeros((T, max_nodes, d), np.float32)
    offsets = np.zeros((T, max_nodes), np.float32)
    children = np.zeros((T, max_nodes, 2), np.int32)
    leaf_pts = np.full((T, max_leaves, leaf_size), -1, np.int32)
    roots = np.zeros((T,), np.int32)
    for t, (tb, root) in enumerate(trees):
        roots[t] = root
        for i, (w, b, ch) in enumerate(
                zip(tb.normals, tb.offsets, tb.children)):
            normals[t, i], offsets[t, i], children[t, i] = w, b, ch
        for li, ids in enumerate(tb.leaves):
            leaf_pts[t, li, :len(ids)] = ids[:leaf_size]
    arrays = {name: torch.as_tensor(a).to(dev) for name, a in (
        ("X", X), ("normals", normals), ("offsets", offsets),
        ("children", children), ("leaf_pts", leaf_pts), ("roots", roots))}
    if metric == "euclidean":
        arrays["xsq"] = torch.sum(arrays["X"] ** 2, dim=1)  # fused rerank
    return IndexState("RPForest", metric, arrays, {
        "n": n, "d": d, "n_trees": T, "leaf_size": leaf_size,
        "max_depth": max_depth, "rerank_kernel": bool(rerank_kernel),
        "rerank_block": None if rerank_block is None else int(rerank_block)})


def forest_window(T: int, trees, max_trees):
    """Resolve the consulted-tree window for a forest search (shared with
    the Hamming bitsampling variant).  Returns ``(T_window, traced_trees)``:

      * static path (``max_trees=None``): the window is ``trees`` itself --
        the forest is sliced -- and ``traced_trees`` is ``None``;
      * traced path: the window is the ``max_trees`` cap and
        ``traced_trees`` is the runtime knob for :func:`mask_dead_trees`
        (``None`` still means "all trees live").
    """
    if max_trees is None and trees is not None:
        return max(1, min(int(trees), T)), None
    if max_trees is not None:
        return max(1, min(int(max_trees), T)), trees
    return T, None


def mask_dead_trees(pts, trees):
    """Mask candidates of trees past the traced ``trees`` count to -1.
    Parity with the static slice holds because the rerank selects are
    canonical on the (id, dist) set (``topk_unique``)."""
    if trees is None:
        return pts
    live = live_mask(pts.shape[1], trees, pts.device)
    return torch.where(live[None, :, None], pts, torch.full_like(pts, -1))


def _descend(state: IndexState, Q, cur):
    """Greedy descent to leaves.  Q [b,d]; cur [b,T] signed node ids.
    Returns (leaf [b,T], margins [b,T,D], others [b,T,D])."""
    tree_ids = torch.arange(cur.shape[1], device=cur.device)[None, :]
    inf = torch.tensor(float("inf"), device=cur.device)
    margins, others = [], []
    for _ in range(state.stat("max_depth")):
        is_leaf = cur < 0
        node = torch.clamp_min(cur, 0).long()
        w = state["normals"][tree_ids, node]            # [b,T,d]
        b = state["offsets"][tree_ids, node]
        m = torch.einsum("btd,bd->bt", w, Q) - b
        side = (m > 0).long()
        nxt = state["children"][tree_ids, node, side]
        other = state["children"][tree_ids, node, 1 - side]
        margins.append(torch.where(is_leaf, inf, torch.abs(m)))
        others.append(torch.where(is_leaf, cur, other))
        cur = torch.where(is_leaf, cur, nxt)
    return cur, torch.stack(margins, -1), torch.stack(others, -1)


def leaf_candidates(leaf_table, leaves, trees, probe, max_probe):
    """[b, sum T*leaf] candidate ids from every visited leaf (shared with
    the bitsampling forest): unreached leaves, dead trees and -- under a
    ``max_probe`` cap -- alternates past ``probe`` are masked to -1."""
    b, T = leaves[0].shape
    tree_ids = torch.arange(T, device=leaves[0].device)[None, :]
    cands = []
    for j, lf in enumerate(leaves):
        lidx = torch.clamp_min(-lf - 1, 0).long()
        pts = leaf_table[tree_ids, lidx]                # [b,T,leaf]
        pts = torch.where((lf < 0)[..., None], pts, torch.full_like(pts, -1))
        pts = mask_dead_trees(pts, trees)               # traced trees knob
        if max_probe is not None and j > 0:
            # alternate j exists in the static path iff probe > j
            keep = torch.as_tensor(probe, device=pts.device) > j
            pts = torch.where(keep, pts, torch.full_like(pts, -1))
        cands.append(pts.reshape(b, -1))
    return torch.cat(cands, dim=1)


def search(state: IndexState, Q, *, k: int, probe: int = 1, trees=None,
           max_probe=None, max_trees=None):
    """Spill search + exact rerank.

    ``probe`` / ``max_probe``   spill width.  With a ``max_probe`` cap,
        ``probe`` may be a runtime value: candidates from alternates past
        ``probe`` are masked to -1.
    ``trees`` / ``max_trees``   how many of the built trees to consult
        (``None`` = all): a slice statically, a mask under the cap.
    """
    Q = prepare_queries(Q, state.metric, state.device)
    b = Q.shape[0]
    T, trees = forest_window(state.stat("n_trees"), trees, max_trees)
    P = max(1, int(probe)) if max_probe is None else max(1, int(max_probe))
    start = state["roots"][None, :T].expand(b, T)
    leaf, margins, others = _descend(state, Q, start)
    leaves = [leaf]
    if P > 1:
        # other-children of the (P-1) smallest-margin splits, ties to the
        # shallower split (jax.lax.top_k)
        nprobe = min(P - 1, margins.shape[-1])
        _, pos = topk_smallest(margins, nprobe)        # [b,T,p]
        alt = torch.take_along_dim(others, pos, dim=-1)
        for p in range(nprobe):
            alt_leaf, _, _ = _descend(state, Q, alt[..., p])
            leaves.append(alt_leaf)
    cand = leaf_candidates(state["leaf_pts"], leaves, trees, probe,
                           max_probe)
    return rerank_candidates(state, Q, cand, k)


SPEC = register_functional(FunctionalSpec(
    name="RPForest", build=build, search=search,
    query_params=("probe", "trees", "max_probe", "max_trees"),
    query_defaults=(1, None, None, None),
    traced_knobs=(("probe", "max_probe"), ("trees", "max_trees")),
))


# ------------------------------------------------------------ legacy class
@register("RPForest")
class RPForest(FunctionalANN):
    supported_metrics = ("euclidean", "angular")

    def __init__(self, metric: str, n_trees: int = 10, leaf_size: int = 32,
                 seed: int = 0, rerank_kernel: bool = False,
                 rerank_block=None):
        super().__init__(metric, build_params=dict(
            n_trees=int(n_trees), leaf_size=int(leaf_size), seed=int(seed),
            rerank_kernel=bool(rerank_kernel), rerank_block=rerank_block))
        self.n_trees = int(n_trees)
        self.leaf_size = int(leaf_size)
        self.seed = int(seed)
        self.probe = 1
        self.name = f"RPForest(T={n_trees},leaf={leaf_size})"
        self._dist_comps = 0

    def _sync_state(self):
        self._n = self._state.stat("n")
        self._d = self._state.stat("d")

    def set_query_arguments(self, probe: int, trees=None) -> None:
        self.probe = max(1, int(probe))
        self._qparams["probe"] = self.probe
        self._qparams["trees"] = None if trees is None \
            else max(1, min(int(trees), self.n_trees))

    def _batch_block_size(self, k: int) -> int:
        return max(1, 32_000_000 //
                   max(self.n_trees * self.probe * self.leaf_size
                       * self._d, 1))

    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        out = super().query(q, k)
        self._dist_comps += self.n_trees * self.probe * self.leaf_size
        return out

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        super().batch_query(Q, k)
        self._dist_comps += Q.shape[0] * self.n_trees * self.probe * self.leaf_size

    def get_additional(self):
        return {"dist_comps": self._dist_comps}
