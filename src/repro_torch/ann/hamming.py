"""Hamming-space algorithms (paper §4 Q4 and Figure 9), as
``repro.ann.hamming``.

  * ``BruteForceHamming``  XOR + popcount over packed codes (exact); with
                           ``backend="pallas"`` the hand-written Hopper
                           kernel ``kernels/csrc/hamming_topk.cu``.
  * ``BitsamplingAnnoy``   Annoy with tree nodes split on a single sampled
                           bit (Bitsampling LSH), popcount rerank.
  * ``MultiIndexHashing``  Norouzi et al.'s MIH: codes split into m
                           contiguous chunks; a query probes, per chunk,
                           every bucket within chunk-radius r.

All three share the sorted-bucket machinery of ``ann.lsh``; the two
candidate algorithms rerank through kernel 2's ``ham`` mode
(``rerank_kernel=True``).  Codes are the reference's uint32 words held in
int32 tensors (``repro_torch.bits``): a bit is read as ``(w >> s) & 1``,
never by a bare arithmetic shift.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch import resolve_device, sync
from repro_torch.ann.distances import hamming_matrix
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        prepare_queries, register_functional)
from repro_torch.ann.lsh import bucket_lookup, sorted_buckets
from repro_torch.ann.rpforest import forest_window, leaf_candidates
from repro_torch.ann.topk import chunked_topk, topk_smallest
from repro_torch.bits import words_to_tensor
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register
from repro_torch.kernels.rerank_topk import rerank_topk


def _hamming_rerank(state: IndexState, Q, cand, k: int):
    """Popcount rerank of a [b, C] candidate-id window through the shared
    rerank (XOR + popcount mode); ``rerank_kernel`` routes it through the
    Hopper kernel."""
    return rerank_topk(
        Q, state["X"], cand, k=k, metric="hamming",
        block=state.static.get("rerank_block"),
        use_kernel=bool(state.static.get("rerank_kernel", False)))


# ------------------------------------------------------- brute force popcount
def bruteforce_build(X: np.ndarray, *, metric: str = "hamming",
                     backend: str = "jnp", streaming: bool = False,
                     corpus_block: int = 65536, query_block: int = 4096,
                     device=None) -> IndexState:
    dev = resolve_device(device)
    X = np.asarray(X, np.uint32)
    return IndexState("BruteForceHamming", metric,
                      {"X": words_to_tensor(X, dev)}, {
                          "n": int(X.shape[0]), "backend": backend,
                          "streaming": bool(streaming),
                          "corpus_block": int(corpus_block),
                          "query_block": int(query_block),
                      })


def bruteforce_search(state: IndexState, Q, *, k: int):
    Q = prepare_queries(Q, "hamming", state.device)
    k = min(k, state.stat("n"))
    if state.stat("backend") == "pallas":
        from repro_torch.kernels.hamming import hamming_topk

        return hamming_topk(Q, state["X"], k=k)
    vals, idx = topk_smallest(hamming_matrix(Q, state["X"]), k)
    return vals, idx.to(torch.int32)


register_functional(FunctionalSpec(
    name="BruteForceHamming", build=bruteforce_build,
    search=bruteforce_search, supported_metrics=("hamming",),
))


@register("BruteForceHamming")
class BruteForceHamming(FunctionalANN):
    """``backend="pallas"`` means the hand-written Hopper kernel."""

    supported_metrics = ("hamming",)
    batch_block = 2048

    def __init__(self, metric: str, backend: str = "jnp",
                 streaming: bool = False, corpus_block: int = 65536,
                 query_block: int = 4096):
        super().__init__(metric, build_params=dict(
            backend=backend, streaming=bool(streaming),
            corpus_block=int(corpus_block), query_block=int(query_block)))
        self.backend = backend
        self.streaming = bool(streaming)
        self.corpus_block = int(corpus_block)
        self.query_block = int(query_block)
        suffix = ",streaming" if streaming else ""
        self.name = f"BruteForceHamming(backend={backend}{suffix})"
        self._dist_comps = 0

    def _sync_state(self):
        self._n = self._state.stat("n")

    def query(self, q, k):
        out = super().query(q, k)
        self._dist_comps += self._n
        return out

    def _batch_streaming(self, Qt, k):
        """Query-blocked corpus scan: per query block, stream corpus chunks
        through the Hamming top-k kernel and merge into a running (dist, id)
        state -- O(qblock * k) state, the corpus never gathered whole."""
        X = self._state["X"]
        if self.backend == "pallas":
            from repro_torch.kernels.hamming import hamming_topk

            def corpus_chunk(Qb):
                def chunk(s, size):
                    v, i = hamming_topk(Qb, X[s:s + size], k=min(k, size))
                    return v, i + s
                return chunk
        else:
            def corpus_chunk(Qb):
                def chunk(s, size):
                    d = hamming_matrix(Qb, X[s:s + size])
                    ids = s + torch.arange(size, dtype=torch.int32,
                                           device=X.device)
                    return d, ids.expand(d.shape[0], -1)
                return chunk
        outs = []
        for qs in range(0, Qt.shape[0], self.query_block):
            Qb = Qt[qs:qs + self.query_block]
            _, ids = chunked_topk(self._n, k, self.corpus_block,
                                  corpus_chunk(Qb))
            outs.append(ids)
        return torch.cat(outs, dim=0)

    def batch_query(self, Q, k):
        k = min(k, self._n)
        if self.streaming:
            dev = self._state.device
            self._batch_results = self._batch_streaming(
                words_to_tensor(np.asarray(Q, np.uint32), dev), k)
            sync(dev)
        else:
            super().batch_query(Q, k)
        self._dist_comps += self._n * Q.shape[0]

    def get_additional(self):
        return {"dist_comps": self._dist_comps}


# ------------------------------------------------------- bitsampling forest
def bitsampling_build(X: np.ndarray, *, metric: str = "hamming",
                      n_trees: int = 10, leaf_size: int = 32, seed: int = 0,
                      streaming: bool = False, rerank_block=None,
                      rerank_kernel: bool = False,
                      device=None) -> IndexState:
    """Annoy-style forest with single-bit splits (host build, draw for draw
    the reference's)."""
    dev = resolve_device(device)
    X = np.asarray(X, np.uint32)
    n, w = X.shape
    bits = w * 32
    n_trees, leaf_size = int(n_trees), int(leaf_size)
    rng = np.random.default_rng(int(seed))
    max_depth = int(np.ceil(np.log2(
        max(2.0, n / max(1, leaf_size))))) + 6

    # split on a random bit with the most even split among a few tries
    trees_bits, trees_children, trees_leaves, roots = [], [], [], []
    host_bit = lambda pts, b: (pts[:, b // 32] >> (b % 32)) & 1  # noqa: E731

    for _ in range(n_trees):
        node_bits: list[int] = []
        children: list[list[int]] = []
        leaves: list[np.ndarray] = []

        def rec(ids: np.ndarray, depth: int) -> int:
            if len(ids) <= leaf_size or depth >= max_depth:
                leaves.append(ids)
                return -len(leaves)
            best_b, best_bal = None, -1.0
            for b in rng.integers(0, bits, size=4):
                side = host_bit(X[ids], int(b)).astype(bool)
                frac = side.mean()
                bal = min(frac, 1 - frac)
                if bal > best_bal:
                    best_bal, best_b = bal, int(b)
            side = host_bit(X[ids], best_b).astype(bool)
            if side.all() or (~side).all():
                side = rng.random(len(ids)) < 0.5
            node = len(node_bits)
            node_bits.append(best_b)
            children.append([0, 0])
            left = rec(ids[~side], depth + 1)
            right = rec(ids[side], depth + 1)
            children[node] = [left, right]
            return node

        roots.append(rec(np.arange(n), 0))
        trees_bits.append(node_bits)
        trees_children.append(children)
        trees_leaves.append(leaves)

    T = n_trees
    max_nodes = max(max(len(b), 1) for b in trees_bits)
    max_leaves = max(len(lv) for lv in trees_leaves)
    bits_arr = np.zeros((T, max_nodes), np.int32)
    child_arr = np.zeros((T, max_nodes, 2), np.int32)
    leaf_arr = np.full((T, max_leaves, leaf_size), -1, np.int32)
    for t in range(T):
        for i, (b, ch) in enumerate(zip(trees_bits[t], trees_children[t])):
            bits_arr[t, i], child_arr[t, i] = b, ch
        for li, ids in enumerate(trees_leaves[t]):
            leaf_arr[t, li, :len(ids)] = ids[:leaf_size]
    return IndexState("BitsamplingAnnoy", metric, {
        "X": words_to_tensor(X, dev),
        "bits": torch.as_tensor(bits_arr).to(dev),
        "children": torch.as_tensor(child_arr).to(dev),
        "leaves": torch.as_tensor(leaf_arr).to(dev),
        "roots": torch.as_tensor(np.asarray(roots, np.int32)).to(dev),
    }, {"n": n, "w": w, "n_trees": T, "leaf_size": leaf_size,
        "depth": max_depth, "streaming": bool(streaming),
        "rerank_kernel": bool(rerank_kernel),
        "rerank_block": None if rerank_block is None else int(rerank_block)})


def _bitsampling_descend(state: IndexState, Q, cur):
    tree_ids = torch.arange(cur.shape[1], device=cur.device)[None, :]
    others = []
    for _ in range(state.stat("depth")):
        is_leaf = cur < 0
        node = torch.clamp_min(cur, 0).long()
        b = state["bits"][tree_ids, node]                  # [bq, T]
        wsel = torch.take_along_dim(Q, (b // 32).long(), dim=1)
        side = ((wsel >> (b % 32)) & 1).long()             # the bit, 0/1
        nxt = state["children"][tree_ids, node, side]
        other = state["children"][tree_ids, node, 1 - side]
        others.append(torch.where(is_leaf, cur, other))
        cur = torch.where(is_leaf, cur, nxt)
    return cur, others


def bitsampling_search(state: IndexState, Q, *, k: int, probe: int = 1,
                       trees=None, max_probe=None, max_trees=None):
    """With a ``max_probe`` cap every cap leaf is descended and the
    candidates of alternates past ``probe`` are masked to -1; ``trees`` /
    ``max_trees`` is the same treatment along the tree axis (``None`` =
    all built trees)."""
    Q = prepare_queries(Q, "hamming", state.device)
    bq = Q.shape[0]
    T, trees = forest_window(state.stat("n_trees"), trees, max_trees)
    P = max(1, int(probe)) if max_probe is None else max(1, int(max_probe))
    start = state["roots"][None, :T].expand(bq, T)
    leaf, others = _bitsampling_descend(state, Q, start)
    leaves = [leaf]
    # probe the deepest not-taken branches (bit splits have no margins)
    for p in range(min(P - 1, len(others))):
        alt, _ = _bitsampling_descend(state, Q, others[-(p + 1)])
        leaves.append(alt)
    cand = leaf_candidates(state["leaves"], leaves, trees, probe, max_probe)
    return _hamming_rerank(state, Q, cand, k)


register_functional(FunctionalSpec(
    name="BitsamplingAnnoy", build=bitsampling_build,
    search=bitsampling_search,
    query_params=("probe", "trees", "max_probe", "max_trees"),
    query_defaults=(1, None, None, None),
    supported_metrics=("hamming",),
    traced_knobs=(("probe", "max_probe"), ("trees", "max_trees")),
))


@register("BitsamplingAnnoy")
class BitsamplingAnnoy(FunctionalANN):
    """Annoy with bit-sampling splits (paper Q4's 'A (Ham.)' variant)."""

    supported_metrics = ("hamming",)
    batch_block = 2048

    def __init__(self, metric: str, n_trees: int = 10, leaf_size: int = 32,
                 seed: int = 0, streaming: bool = False,
                 rerank_block=None, rerank_kernel: bool = False):
        super().__init__(metric, build_params=dict(
            n_trees=int(n_trees), leaf_size=int(leaf_size), seed=int(seed),
            streaming=bool(streaming), rerank_block=rerank_block,
            rerank_kernel=bool(rerank_kernel)))
        self.n_trees = int(n_trees)
        self.leaf_size = int(leaf_size)
        self.seed = int(seed)
        self.streaming = bool(streaming)
        self.rerank_block = rerank_block
        self.probe = 1
        self.name = f"BitsamplingAnnoy(T={n_trees},leaf={leaf_size})"
        self._dist_comps = 0

    def set_query_arguments(self, probe: int, trees=None) -> None:
        self.probe = max(1, int(probe))
        self._qparams["probe"] = self.probe
        self._qparams["trees"] = None if trees is None \
            else max(1, min(int(trees), self.n_trees))

    def query(self, q, k):
        out = super().query(q, k)
        self._dist_comps += self.n_trees * self.probe * self.leaf_size
        return out

    def batch_query(self, Q, k):
        super().batch_query(Q, k)
        self._dist_comps += Q.shape[0] * self.n_trees * self.probe * self.leaf_size

    def get_additional(self):
        return {"dist_comps": self._dist_comps}


# ------------------------------------------------------- multi-index hashing
def mih_build(X: np.ndarray, *, metric: str = "hamming",
              n_chunks: int = 16, cap: int = 128, seed: int = 0,
              streaming: bool = False, rerank_block=None,
              rerank_kernel: bool = False, device=None) -> IndexState:
    dev = resolve_device(device)
    X = np.asarray(X, np.uint32)
    n, w = X.shape
    bits = w * 32
    m = int(n_chunks)
    chunk_bits = bits // m
    if chunk_bits > 30:
        raise ValueError("chunk too wide for int32 keys; use more chunks")
    # chunk substrings as int32 keys, one "table" per chunk
    keys = np.zeros((m, n), np.int32)
    unpacked = np.unpackbits(
        X.view(np.uint8), bitorder="little").reshape(n, bits)
    bit_weights = 2 ** np.arange(chunk_bits, dtype=np.int32)
    for c in range(m):
        seg = unpacked[:, c * chunk_bits:(c + 1) * chunk_bits]
        keys[c] = seg.astype(np.int64) @ bit_weights
    tkeys, tids = sorted_buckets(keys, dev)
    return IndexState("MultiIndexHashing", metric, {
        "X": words_to_tensor(X, dev), "keys": tkeys, "ids": tids,
        "bit_weights": torch.as_tensor(bit_weights).to(dev),
    }, {"n": n, "w": w, "n_chunks": m, "chunk_bits": chunk_bits,
        "cap": int(cap), "streaming": bool(streaming),
        "rerank_kernel": bool(rerank_kernel),
        "rerank_block": None if rerank_block is None else int(rerank_block)})


def _mih_query_chunks(state: IndexState, Q):
    """Q [b, w] words -> chunk keys [b, m] int32 + chunk bits
    [b, m, chunk_bits] int32."""
    bq = Q.shape[0]
    m = state.stat("n_chunks")
    chunk_bits = state.stat("chunk_bits")
    shifts = torch.arange(32, dtype=torch.int32, device=Q.device)
    bits = ((Q[:, :, None] >> shifts[None, None, :]) & 1).reshape(bq, -1)
    bits = bits[:, :m * chunk_bits].reshape(bq, m, chunk_bits)
    keys = torch.sum(bits * state["bit_weights"], dim=2).to(torch.int32)
    return keys, bits


def mih_search(state: IndexState, Q, *, k: int, radius: int = 0,
               max_radius=None):
    """With a ``max_radius`` cap the probe-key tensor is enumerated at the
    cap and columns whose flip count exceeds ``radius`` get key -1 (chunk
    keys are non-negative, so the lookup matches nothing)."""
    Q = prepare_queries(Q, "hamming", state.device)
    chunk_bits = state.stat("chunk_bits")
    R = int(radius) if max_radius is None else int(max_radius)
    base, bits = _mih_query_chunks(state, Q)               # [b, m]
    # probe keys: all chunk codes within hamming radius <= R
    flips: list[tuple[int, ...]] = [()]
    for r in range(1, R + 1):
        flips += list(itertools.combinations(range(chunk_bits), r))
    bw = state["bit_weights"]
    # flipping bit p adds -w_p where it is set, +w_p where it is clear
    step = torch.where(bits > 0, -bw, bw)                  # [b, m, bits]
    probe_keys = []
    for f in flips:
        delta = torch.zeros_like(base)
        for bitpos in f:
            delta = delta + step[:, :, bitpos]
        probe_keys.append(base + delta)
    qkeys = torch.stack(probe_keys, dim=-1)                # [b, m, P]
    if max_radius is not None:
        flip_r = torch.as_tensor([len(f) for f in flips], device=Q.device)
        live = flip_r <= torch.clamp_min(
            torch.as_tensor(radius, device=Q.device), 0)
        qkeys = torch.where(live[None, None, :], qkeys,
                            torch.full_like(qkeys, -1))
    cand = bucket_lookup(state["keys"], state["ids"], qkeys,
                         state.stat("cap"))
    return _hamming_rerank(state, Q, cand, k)


register_functional(FunctionalSpec(
    name="MultiIndexHashing", build=mih_build, search=mih_search,
    query_params=("radius", "max_radius"), query_defaults=(0, None),
    supported_metrics=("hamming",),
    traced_knobs=(("radius", "max_radius"),),
))


@register("MultiIndexHashing")
class MultiIndexHashing(FunctionalANN):
    supported_metrics = ("hamming",)
    batch_block = 1024

    def __init__(self, metric: str, n_chunks: int = 16, cap: int = 128,
                 seed: int = 0, streaming: bool = False,
                 rerank_block=None, rerank_kernel: bool = False):
        super().__init__(metric, build_params=dict(
            n_chunks=int(n_chunks), cap=int(cap), seed=int(seed),
            streaming=bool(streaming), rerank_block=rerank_block,
            rerank_kernel=bool(rerank_kernel)))
        self.n_chunks = int(n_chunks)
        self.cap = int(cap)
        self.streaming = bool(streaming)
        self.rerank_block = rerank_block
        self.radius = 0
        self.name = f"MIH(m={n_chunks},cap={cap})"
        self._dist_comps = 0

    def set_query_arguments(self, radius: int) -> None:
        self.radius = int(radius)
        self._qparams["radius"] = self.radius

    def query(self, q, k):
        out = super().query(q, k)
        self._dist_comps += self.n_chunks * self.cap
        return out

    def batch_query(self, Q, k):
        super().batch_query(Q, k)
        self._dist_comps += Q.shape[0] * self.n_chunks * self.cap

    def get_additional(self):
        return {"dist_comps": self._dist_comps}
