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

``quantize=`` switches to compressed-domain search: the corpus is encoded
through a :mod:`repro_torch.quant` codec and ``search`` becomes an ADC scan
over the codes (the Hopper kernel ``kernels/csrc/adc_scan.cu`` with
``adc_kernel=True``) followed by an exact rerank of the ``n_cand`` best.
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


def build(X: np.ndarray, *, metric: str = "euclidean",
          backend: str = "jnp", corpus_block: int = 65536,
          streaming: bool = False, query_block: int = 4096,
          quantize=None, keep_fp32: bool = True,
          adc_kernel: bool = False, adc_block=None,
          rerank_block=None, rerank_kernel: bool = False,
          device=None) -> IndexState:
    """Canonicalise the corpus into an IndexState on ``device``.

    ``quantize`` (``{"pq": {...}}`` / ``{"int8": {}}`` / ``"pq"``) encodes
    the corpus and makes ``search`` a two-stage ADC scan + exact rerank
    with the ``n_cand`` / ``max_cand`` knob pair.  ``keep_fp32`` keeps the
    fp32 corpus for the rerank; without it the ADC ordering (exact over
    the decoded corpus) is the answer.  ``adc_kernel`` routes the scan
    through the ADC kernel, ``rerank_kernel`` the rerank through kernel 2.
    """
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if streaming and (backend != "pallas" or metric == "hamming"):
        raise ValueError(
            "streaming requires backend='pallas' and a float metric "
            "(use BruteForceHamming(streaming=True) for hamming)")
    if quantize is not None and streaming:
        raise ValueError("streaming applies to the fp32 scan only; "
                         "quantize= already streams packed codes")
    dev = resolve_device(device)
    X = prepare_points(X, metric)
    static = {
        "n": int(X.shape[0]), "d": int(X.shape[1]), "backend": backend,
        "corpus_block": int(corpus_block), "streaming": bool(streaming),
        "query_block": int(query_block), "quant": None,
    }
    if quantize is not None:
        from repro_torch import quant

        arrays, qstatic = quant.train_codec(X, quantize, metric=metric,
                                            device=dev)
        if keep_fp32:
            arrays["X"] = torch.as_tensor(X).to(dev)
            if metric == "euclidean":
                arrays["xsq"] = torch.sum(arrays["X"] ** 2, dim=1)
        static.update({
            "quant": qstatic, "keep_fp32": bool(keep_fp32),
            "adc_kernel": bool(adc_kernel),
            "adc_block": None if adc_block is None else int(adc_block),
            "rerank_block": None if rerank_block is None
            else int(rerank_block),
            "rerank_kernel": bool(rerank_kernel),
        })
        return IndexState("BruteForce", metric, arrays, static)
    if metric == "hamming":
        arrays = {"X": words_to_tensor(X, dev)}
    else:
        arrays = {"X": torch.as_tensor(X).to(dev)}
    if metric == "euclidean":
        arrays["xsq"] = torch.sum(arrays["X"] ** 2, dim=1)
    return IndexState("BruteForce", metric, arrays, static)


def exact_angular(state: IndexState) -> IndexState:
    """``state`` taking its angular distances with float64 dots rounded
    once (``distances.angular_matrix_exact``): a pair's distance then
    depends on the matrix it sits in only at a float32 rounding boundary
    (see there).  A mutable index's BruteForce
    main uses it, so copies of a row in the main corpus and in the delta
    tie exactly.  No other metric changes."""
    return IndexState(state.algo, state.metric, state.arrays,
                      {**state.static, "exact_angular": True})


def distance_matrix(state: IndexState, Q, X, xsq=None) -> torch.Tensor:
    """[b, m] distances of canonical queries ``Q`` to rows ``X`` by this
    index's expression (``xsq``: the rows' squared norms, euclidean)."""
    if state.metric == "euclidean":
        return D.sq_l2_matrix(Q, X, xsq)
    if state.metric == "angular":
        if state.static.get("exact_angular", False):
            return D.angular_matrix_exact(Q, X)
        return D.angular_matrix(Q, X, normalized=False)
    return D.hamming_matrix(Q, X)


def search(state: IndexState, Q, *, k: int, n_cand=None, max_cand=None,
           live=None, id_map=None):
    """Exact (dists [b, kk], ids [b, kk]) with kk = min(k, n).  The pallas
    backend runs the streaming kernel, the jnp backend one [b, n] tile.

    ``live`` ([n] bool) masks corpus rows out (dead rows are forced to
    (+inf, -1) so they cannot surface even on distance ties); ``id_map``
    ([n] int32) relabels row positions.  Either switches the select to the
    canonical (dist, id)-ascending ``topk_unique`` over those ids.

    Quantized builds run the two-stage compressed path instead, with the
    ``n_cand`` / ``max_cand`` pair: ``n_cand`` sizes the ADC candidate
    window (``None`` = the whole corpus); under a ``max_cand`` cap it masks
    the canonically sorted ADC prefix, which equals the static window.
    """
    metric = state.metric
    n = state.stat("n")
    k = min(k, n)
    masked = live is not None or id_map is not None
    if masked and (state.static.get("quant") is not None
                   or state.stat("backend") == "pallas"):
        raise ValueError(
            "live=/id_map= need the plain jnp fp32 path (the streaming "
            "kernel and the ADC scan have no tombstone mask input)")
    if state.static.get("quant") is not None:
        return _search_quantized(state, Q, k=k, n_cand=n_cand,
                                 max_cand=max_cand)
    if n_cand is not None or max_cand is not None:
        raise ValueError(
            "n_cand/max_cand are the compressed-domain rerank knobs; "
            "build with quantize= to use them")
    dev = state.device
    Q = prepare_queries(Q, metric, dev)
    if state.stat("backend") == "pallas" and metric != "hamming":
        from repro_torch.kernels.distance_topk import stream_topk

        return stream_topk(Q, state["X"], k=k, metric=metric)
    d = distance_matrix(state, Q, state["X"], state.arrays.get("xsq"))
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


def _search_quantized(state: IndexState, Q, *, k: int, n_cand, max_cand):
    """ADC scan over packed codes -> top-C candidates -> exact rerank."""
    from repro_torch.kernels.adc_scan import adc_scan
    from repro_torch.kernels.rerank_topk import rerank_topk
    from repro_torch.quant import build_luts

    metric = state.metric
    n = state.stat("n")
    # candidate window: a static n_cand narrows it; a max_cand cap sizes it
    # instead and n_cand masks inside it
    if max_cand is None:
        C = n if n_cand is None else max(1, min(int(n_cand), n))
        n_cand = None                   # window == budget: no mask needed
    else:
        C = max(1, min(int(max_cand), n))
    dev = state.device
    Q = prepare_queries(Q, metric, dev)
    luts = build_luts(state["codebooks"], Q, metric)
    adc_d, rows = adc_scan(
        state["codes"], luts, k=C,
        block=state.static.get("adc_block"),
        use_kernel=bool(state.static.get("adc_kernel", False)))
    live = None
    if n_cand is not None:
        # the ADC output is sorted by (dist, row), so masking positions
        # >= n_cand of the top-max_cand prefix IS the static window
        live = (torch.arange(C, device=dev)
                < torch.as_tensor(n_cand, device=dev))[None, :]
    if state.stat("keep_fp32"):
        return rerank_topk(
            Q, state["X"], rows, k=k, metric=metric,
            xsq=state.arrays.get("xsq"), valid=live,
            block=state.static.get("rerank_block"),
            use_kernel=bool(state.static.get("rerank_kernel", False)))
    # no fp32 corpus kept: the ADC ordering (exact over the decoded
    # corpus) is the answer
    if live is not None:
        adc_d = torch.where(live, adc_d, torch.full_like(adc_d, float("inf")))
        rows = torch.where(live, rows, torch.full_like(rows, -1))
    kk = min(int(k), C)
    return adc_d[:, :kk], rows[:, :kk]


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
        super().__init__(metric, build_params=dict(
            backend=backend, corpus_block=int(corpus_block),
            streaming=bool(streaming), query_block=int(query_block),
            quantize=quantize, keep_fp32=bool(keep_fp32),
            adc_kernel=bool(adc_kernel)))
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
        if quantize is not None:
            from repro_torch.quant import normalize_quantize

            kind, _ = normalize_quantize(quantize)
            suffix += f",quantize={kind}"
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
