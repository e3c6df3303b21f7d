"""Exact brute force -- the baseline every paper figure includes and the
reference for correctness tests (``repro.ann.bruteforce``).

Two device paths, named as in the reference so one config drives both:

  * ``jnp``    : one [b, n] distance matrix + a stable top-k, in torch.
  * ``pallas`` : the streaming fused distance + top-k kernel -- in this port
                 the hand-written Hopper CUDA kernel
                 (``kernels/csrc/stream_topk.cu``; its plain PyTorch version
                 on the CPU).  The [nq, n] matrix never exists.  With
                 ``streaming=True`` batch mode also streams query blocks
                 (``stream_topk_batched``).

``quantize=`` (compressed-domain search) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device, sync
from repro_torch.ann import distances as D
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        prepare_points, prepare_queries,
                                        register_functional)
from repro_torch.ann.topk import topk_smallest, topk_unique
from repro_torch.bits import words_to_tensor
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register

QUANTIZE_TODO = ("quantize= (compressed-domain search) is not ported yet: "
                 "ROADMAP 'Modules to port' item 11")


def build(X: np.ndarray, *, metric: str = "euclidean",
          backend: str = "jnp", corpus_block: int = 65536,
          streaming: bool = False, query_block: int = 4096,
          quantize=None, keep_fp32: bool = True,
          adc_kernel: bool = False, adc_block=None,
          rerank_block=None, rerank_kernel: bool = False,
          device=None) -> IndexState:
    """Canonicalise the corpus into an IndexState on ``device``."""
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if streaming and (backend != "pallas" or metric == "hamming"):
        raise ValueError(
            "streaming requires backend='pallas' and a float metric "
            "(use BruteForceHamming(streaming=True) for hamming)")
    if quantize is not None:
        raise NotImplementedError(QUANTIZE_TODO)
    dev = resolve_device(device)
    X = prepare_points(X, metric)
    static = {
        "n": int(X.shape[0]), "d": int(X.shape[1]), "backend": backend,
        "corpus_block": int(corpus_block), "streaming": bool(streaming),
        "query_block": int(query_block), "quant": None,
    }
    if metric == "hamming":
        arrays = {"X": words_to_tensor(X, dev)}
    else:
        arrays = {"X": torch.as_tensor(X).to(dev)}
    if metric == "euclidean":
        arrays["xsq"] = torch.sum(arrays["X"] ** 2, dim=1)
    return IndexState("BruteForce", metric, arrays, static)


def search(state: IndexState, Q, *, k: int, n_cand=None, max_cand=None,
           live=None, id_map=None):
    """Exact (dists [b, kk], ids [b, kk]) with kk = min(k, n).  The pallas
    backend runs the streaming kernel, the jnp backend one [b, n] tile.

    ``live`` ([n] bool) masks corpus rows out (dead rows are forced to
    (+inf, -1) so they cannot surface even on distance ties); ``id_map``
    ([n] int32) relabels row positions.  Either switches the select to the
    canonical (dist, id)-ascending ``topk_unique`` over those ids.
    """
    metric = state.metric
    n = state.stat("n")
    k = min(k, n)
    masked = live is not None or id_map is not None
    if masked and state.stat("backend") == "pallas":
        raise ValueError(
            "live=/id_map= need the plain jnp fp32 path (the streaming "
            "kernel has no tombstone mask input)")
    if n_cand is not None or max_cand is not None:
        raise ValueError(
            "n_cand/max_cand are the compressed-domain rerank knobs; "
            "build with quantize= to use them")
    dev = state.device
    Q = prepare_queries(Q, metric, dev)
    if state.stat("backend") == "pallas" and metric != "hamming":
        from repro_torch.kernels.distance_topk import stream_topk

        return stream_topk(Q, state["X"], k=k, metric=metric)
    if metric == "euclidean":
        d = D.sq_l2_matrix(Q, state["X"], state["xsq"])
    elif metric == "angular":
        d = D.angular_matrix(Q, state["X"], normalized=False)
    else:
        d = D.hamming_matrix(Q, state["X"])
    if not masked:
        vals, idx = topk_smallest(d, k)
        return vals, idx.to(torch.int32)
    ids_row = (torch.arange(n, dtype=torch.int32, device=dev)
               if id_map is None
               else torch.as_tensor(id_map, device=dev).to(torch.int32))
    d = d.to(torch.float32)
    if live is not None:
        live = torch.as_tensor(live, device=dev).to(torch.bool)
        d = torch.where(live[None, :], d, torch.full_like(d, float("inf")))
        ids_row = torch.where(live, ids_row, torch.full_like(ids_row, -1))
    return topk_unique(d, ids_row[None, :].expand(d.shape[0], -1), k)


SPEC = register_functional(FunctionalSpec(
    name="BruteForce", build=build, search=search,
    query_params=("n_cand", "max_cand"),
    query_defaults=(None, None),
    static_query_params=("n_cand", "max_cand"),
    supported_metrics=("euclidean", "angular", "hamming"),
    traced_knobs=(("n_cand", "max_cand"),),
))


@register("BruteForce")
class BruteForce(FunctionalANN):
    """``BruteForce(metric, backend, ...)`` with the reference's arguments.
    ``backend="pallas"`` means the hand-written Hopper kernel."""

    supported_metrics = ("euclidean", "angular", "hamming")

    def __init__(self, metric: str, backend: str = "jnp",
                 corpus_block: int = 65536, streaming: bool = False,
                 query_block: int = 4096, quantize=None,
                 keep_fp32: bool = True, adc_kernel: bool = False):
        if quantize is not None:
            raise NotImplementedError(QUANTIZE_TODO)
        super().__init__(metric, build_params=dict(
            backend=backend, corpus_block=int(corpus_block),
            streaming=bool(streaming), query_block=int(query_block),
            keep_fp32=bool(keep_fp32), adc_kernel=bool(adc_kernel)))
        if backend not in ("jnp", "pallas"):
            raise ValueError(f"unknown backend {backend!r}")
        if streaming and (backend != "pallas" or metric == "hamming"):
            raise ValueError(
                "streaming requires backend='pallas' and a float metric "
                "(use BruteForceHamming(streaming=True) for hamming)")
        self.backend = backend
        self.corpus_block = int(corpus_block)
        self.streaming = bool(streaming)
        self.query_block = int(query_block)
        self.quantize = quantize
        suffix = ",streaming" if streaming else ""
        self.name = f"BruteForce(backend={backend}{suffix})"
        self._dist_comps = 0

    def _sync_state(self):
        self._n = self._state.stat("n")

    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        out = super().query(q, k)
        self._dist_comps += self._n
        return out

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        k = min(k, self._n)
        if self.backend == "pallas" and self.metric != "hamming" \
                and self.streaming:
            from repro_torch.kernels.distance_topk import stream_topk_batched

            dev = self._state.device
            # raw queries, as the reference passes them; device tensors
            # out, the host copy happens off the clock in get_batch_results()
            _, idx = stream_topk_batched(
                Q, self._state["X"], k=k, metric=self.metric,
                query_block=self.query_block, materialize=False)
            self._batch_results = idx
            sync(dev)
        else:
            super().batch_query(Q, k)
        self._dist_comps += self._n * Q.shape[0]

    def get_additional(self):
        return {"dist_comps": self._dist_comps}
