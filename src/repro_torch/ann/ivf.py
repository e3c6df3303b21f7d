"""IVF -- inverted file index with a k-means coarse quantizer (the FAISS-IVF
analogue of the paper's Table 2), as ``repro.ann.ivf``.

The inverted lists are stored *cluster-major* (corpus sorted by assigned
centroid, plus offsets), and a probe reads a fixed-size window of each
probed list with a validity mask.

``search(state, Q, k, n_probes, max_probes)``: with ``max_probes=None`` the
window is ``n_probes`` lists; with a ``max_probes`` cap the window is the
cap and ``n_probes`` (an int or a 0-d tensor) only masks probes past it, so
one window size serves every query-args group up to the cap.  ``scan`` /
``max_scan`` do the same for the per-list budget.

Rerank: the probed window goes through the shared rerank
(:func:`repro_torch.kernels.rerank_topk.rerank_topk`): the torch streaming
fold by default, or with ``rerank_kernel=True`` the hand-written Hopper
kernel ``kernels/csrc/rerank_topk.cu`` (its plain PyTorch version on the
CPU).  ``streaming`` is an accepted no-op, as in the reference.

``quantize=`` adds the compressed-domain stage: each inverted list keeps
its members' codes (cluster-major, like the corpus), the probed window is
scored by ADC lookups (``adc_window_topk``, m code bytes per candidate)
and only the ``n_cand`` best go through the exact fp32 rerank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann import distances as D
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        prepare_points, prepare_queries,
                                        register_functional)
from repro_torch.ann.kmeans import kmeans
from repro_torch.ann.topk import topk_smallest
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register
from repro_torch.kernels.rerank_topk import rerank_topk


def build(X: np.ndarray, *, metric: str = "euclidean",
          n_clusters: int = 100, n_iters: int = 10, seed: int = 0,
          streaming: bool = False, rerank_block=None,
          rerank_kernel: bool = False, quantize=None,
          keep_fp32: bool = True, adc_block=None,
          device=None) -> IndexState:
    """k-means + cluster-major corpus layout -> IndexState on ``device``.
    ``keep_fp32=False`` (quantized builds) drops the fp32 corpus and its
    norms: the ADC ordering is then the answer."""
    dev = resolve_device(device)
    X = prepare_points(X, metric)
    n, d = X.shape
    C = min(int(n_clusters), n)
    centers, assign = kmeans(X, C, n_iters=int(n_iters), seed=int(seed),
                             device=dev)
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=C)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    arrays = {
        "centers": torch.as_tensor(centers).to(dev),
        "X": torch.as_tensor(X[order]).to(dev),
        "ids": torch.as_tensor(order.astype(np.int32)).to(dev),
        "starts": torch.as_tensor(starts[:-1].astype(np.int32)).to(dev),
        "sizes": torch.as_tensor(sizes.astype(np.int32)).to(dev),
    }
    if metric == "euclidean":
        arrays["xsq"] = torch.sum(arrays["X"] ** 2, dim=1)
    static = {
        "n": n, "d": d, "n_clusters": C, "pad": int(sizes.max()),
        "streaming": bool(streaming), "rerank_kernel": bool(rerank_kernel),
        "rerank_block": None if rerank_block is None else int(rerank_block),
        "quant": None,
    }
    if quantize is not None:
        from repro_torch import quant

        qarrays, qstatic = quant.train_codec(X, quantize, metric=metric,
                                             device=dev)
        # codes follow the cluster-major corpus order, so the probed
        # window's row indices address codes and fp32 rows alike
        arrays["codes"] = qarrays["codes"][torch.as_tensor(order).to(dev)]
        arrays["codebooks"] = qarrays["codebooks"]
        if not keep_fp32:
            arrays.pop("X")
            arrays.pop("xsq", None)
        static.update({
            "quant": qstatic, "keep_fp32": bool(keep_fp32),
            "adc_block": None if adc_block is None else int(adc_block),
        })
    return IndexState("IVF", metric, arrays, static)


def search(state: IndexState, Q, *, k: int, n_probes=1, scan=None,
           n_cand=None, max_probes: Optional[int] = None,
           max_scan: Optional[int] = None,
           max_cand: Optional[int] = None, live=None, id_map=None):
    """Q [b, d] -> (dists [b, kk], ids [b, kk]).

    ``live`` ([n] bool, by corpus row) folds tombstones into the rerank's
    validity mask; ``id_map`` ([n] int32) relabels corpus rows.

    ``n_probes`` / ``max_probes``   lists to probe; the cap sizes the
        window and ``n_probes`` masks past it (see module docstring).
    ``scan`` / ``max_scan``   per-list scan budget: only the first ``scan``
        entries of each probed list are reranked (``None`` = whole list).
    ``n_cand`` / ``max_cand``   rerank depth, quantized builds only: how
        many ADC survivors of the probed window go through the exact fp32
        rerank (``None`` = all); under a ``max_cand`` cap a mask over the
        sorted ADC prefix.
    """
    quant = state.static.get("quant")
    if quant is not None and (live is not None or id_map is not None):
        raise ValueError(
            "live=/id_map= need the plain fp32 rerank path (the ADC scan "
            "has no tombstone mask input)")
    if quant is None and (n_cand is not None or max_cand is not None):
        raise ValueError(
            "n_cand/max_cand are the compressed-domain rerank knobs; "
            "build with quantize= to use them")
    Q, cand, valid = probe_window(state, Q, n_probes=n_probes, scan=scan,
                                  max_probes=max_probes, max_scan=max_scan)
    if quant is not None:
        return _rerank_quantized(state, Q, cand, valid, k=k, n_cand=n_cand,
                                 max_cand=max_cand)
    dev = state.device
    # tombstones: `live` is indexed by corpus row, the window by
    # cluster-major position -- translate through the ids permutation
    if live is not None:
        live = torch.as_tensor(live, device=dev).to(torch.bool)
        valid = valid & live[state["ids"].long()][cand.long()]
    rids = state["ids"] if id_map is None \
        else torch.as_tensor(id_map, device=dev).to(torch.int32)[
            state["ids"].long()]
    # 3. exact distances on the candidate window
    return rerank_topk(
        Q, state["X"], cand, k=k, metric=state.metric,
        xsq=state.arrays.get("xsq"), row_ids=rids, valid=valid,
        block=state.static.get("rerank_block"),
        use_kernel=bool(state.static.get("rerank_kernel", False)))


def _rerank_quantized(state: IndexState, Q, cand, valid, *, k: int,
                      n_cand, max_cand):
    """Compressed-domain stage 3: ADC-score the probed window (m code
    bytes per candidate), keep the n_cand best, exact-rerank those."""
    from repro_torch.kernels.adc_scan import adc_window_topk
    from repro_torch.quant import build_luts

    Cw = cand.shape[1]
    if max_cand is None:
        W = Cw if n_cand is None else max(1, min(int(n_cand), Cw))
        n_cand = None                   # window == budget: no mask needed
    else:
        W = max(1, min(int(max_cand), Cw))
    dev = state.device
    luts = build_luts(state["codebooks"], Q, state.metric)
    adc_d, rows = adc_window_topk(
        state["codes"], luts, cand, k=W, valid=valid,
        block=state.static.get("adc_block"))
    live = None
    if n_cand is not None:
        live = (torch.arange(W, device=dev)
                < torch.as_tensor(n_cand, device=dev))[None, :]
    if state.stat("keep_fp32"):
        return rerank_topk(
            Q, state["X"], rows, k=k, metric=state.metric,
            xsq=state.arrays.get("xsq"), row_ids=state["ids"], valid=live,
            block=state.static.get("rerank_block"),
            use_kernel=bool(state.static.get("rerank_kernel", False)))
    # no fp32 corpus kept: the ADC ordering is the answer; map the
    # cluster-major rows back to corpus ids
    bad = rows < 0
    if live is not None:
        bad = bad | ~live
    adc_d = torch.where(bad, torch.full_like(adc_d, float("inf")), adc_d)
    ids = torch.where(bad, torch.full_like(rows, -1),
                      state["ids"][torch.clamp_min(rows, 0).long()])
    kk = min(int(k), W)
    return adc_d[:, :kk], ids[:, :kk]


def probe_window(state: IndexState, Q, *, n_probes=1, scan=None,
                 max_probes: Optional[int] = None,
                 max_scan: Optional[int] = None):
    """Steps 1-2 of the search: (queries [b, d] on the device, candidate
    rows [b, P*M] int32 in the cluster-major corpus, validity [b, P*M])."""
    C = state.stat("n_clusters")
    n = state.stat("n")
    pad = state.stat("pad")
    if max_probes is None:
        P = min(int(n_probes), C)
    else:
        P = min(int(max_probes), C)
    if max_scan is None:
        M = pad if scan is None else max(1, min(int(scan), pad))
        scan = None                     # window == budget: no mask needed
    else:
        M = max(1, min(int(max_scan), pad))
    dev = state.device
    Q = prepare_queries(Q, state.metric, dev)
    b = Q.shape[0]
    # 1. coarse quantizer: the P nearest centroids (stable: ties to the
    #    lower centroid), probes past n_probes masked
    cd = D.sq_l2_matrix(Q, state["centers"])             # [b, C]
    _, probes = topk_smallest(cd, P)                     # [b, P]
    probe_live = torch.arange(P, dtype=torch.int32, device=dev) < n_probes
    # 2. padded window of each probed list, entries past the scan budget
    #    masked the same way
    starts = state["starts"][probes]                     # [b, P]
    sizes = state["sizes"][probes]                       # [b, P]
    offs = torch.arange(M, dtype=torch.int32, device=dev)
    cand = starts[..., None] + offs[None, None, :]       # [b, P, M]
    valid = offs[None, None, :] < sizes[..., None]
    valid = valid & probe_live[None, :, None]
    if scan is not None:
        valid = valid & (offs[None, None, :] < torch.clamp_min(
            torch.as_tensor(scan, device=dev), 1))
    cand = torch.clamp_max(cand, n - 1).reshape(b, -1)
    valid = valid.reshape(b, -1)                         # [b, P*M]
    return Q, cand, valid


SPEC = register_functional(FunctionalSpec(
    name="IVF", build=build, search=search,
    query_params=("n_probes", "scan", "n_cand",
                  "max_probes", "max_scan", "max_cand"),
    query_defaults=(1, None, None, None, None, None),
    static_query_params=("n_probes", "scan", "n_cand",
                         "max_probes", "max_scan", "max_cand"),
    traced_knobs=(("n_probes", "max_probes"), ("scan", "max_scan"),
                  ("n_cand", "max_cand")),
))


@register("IVF")
class IVF(FunctionalANN):
    """``IVF(metric, n_clusters, n_iters, seed, streaming, rerank_block,
    rerank_kernel, ...)`` with the reference's arguments.
    ``rerank_kernel=True`` means the hand-written Hopper rerank kernel."""

    supported_metrics = ("euclidean", "angular")

    def __init__(self, metric: str, n_clusters: int = 100, n_iters: int = 10,
                 seed: int = 0, streaming: bool = False,
                 rerank_block=None, rerank_kernel: bool = False,
                 quantize=None, keep_fp32: bool = True):
        super().__init__(metric, build_params=dict(
            n_clusters=int(n_clusters), n_iters=int(n_iters), seed=int(seed),
            streaming=bool(streaming), rerank_block=rerank_block,
            rerank_kernel=bool(rerank_kernel), quantize=quantize,
            keep_fp32=bool(keep_fp32)))
        self.n_clusters = int(n_clusters)
        self.n_iters = int(n_iters)
        self.seed = int(seed)
        self.streaming = bool(streaming)
        self.rerank_block = rerank_block
        self.n_probes = 1
        self.name = f"IVF(C={n_clusters})"
        self._dist_comps = 0

    def _sync_state(self):
        st = self._state
        self._n = st.stat("n")
        self._d = st.stat("d")
        self._pad = st.stat("pad")
        self._sizes_np = st["sizes"].cpu().numpy()
        self._centers = st["centers"]

    def set_query_arguments(self, n_probes: int, scan=None,
                            n_cand=None) -> None:
        self.n_probes = int(n_probes)
        self._qparams["n_probes"] = min(self.n_probes, self.n_clusters)
        self._qparams["scan"] = None if scan is None else int(scan)
        if n_cand is not None:
            self._qparams["n_cand"] = int(n_cand)

    def _effective_scan(self) -> int:
        scan = self._qparams.get("scan")
        if scan is None:
            return self._pad
        return max(1, min(int(scan), self._pad))

    def _batch_block_size(self, k: int) -> int:
        # block queries so [b, P*M, d] stays bounded (M: the effective scan)
        nprobe = self._qparams["n_probes"]
        M = self._effective_scan()
        return max(1, 64_000_000 // max(nprobe * M * self._d, 1))

    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        out = super().query(q, k)
        self._count_probes(np.asarray(q)[None, :])
        return out

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        super().batch_query(Q, k)
        self._count_probes(Q)

    def _count_probes(self, Q):
        # distance computations = centroid scan + probed list sizes, clamped
        # to the built cluster count and the scan budget
        nprobe = min(self._qparams["n_probes"], int(self._centers.shape[0]))
        cd = D.sq_l2_matrix(prepare_queries(Q, self.metric,
                                            self._centers.device),
                            self._centers)
        _, probes = topk_smallest(cd, nprobe)
        sizes = self._sizes_np[probes.cpu().numpy()]
        scan = self._qparams.get("scan")
        if scan is not None:
            sizes = np.minimum(sizes, max(1, int(scan)))
        self._dist_comps += int(sizes.sum()) \
            + Q.shape[0] * self._centers.shape[0]

    def get_additional(self):
        return {"dist_comps": self._dist_comps,
                "max_list_size": self._pad,
                "n_lists": int(self._centers.shape[0])}
