"""Distributed ANN serving on the generic sharded layer
(``repro.ann.sharded``; :mod:`repro_torch.dist.shard_state`): a built
``IndexState`` partitioned over the stacked mesh, a per-shard *streaming*
local top-k (never the [b, n_shard] matrix), and the compressed
hierarchical top-k merge (:func:`repro_torch.dist.collectives.
tree_merge_topk`).

Two shard plans are registered here:

* **row plan** (BruteForce -- plain, quantized, hamming): corpus rows are
  dealt round the shards in contiguous blocks; the local pass is a
  blockwise :mod:`repro_torch.ann.distances` scan folded through
  ``chunked_topk``, or kernel 1 (``kernels/csrc/stream_topk.cu``) with
  ``use_kernel=True`` at euclidean / angular, or for quantized builds the
  ADC scan (kernel 4 under ``adc_kernel``) + ``rerank_topk`` (kernel 2's
  generic entry under ``rerank_kernel``).
* **inverted-list plan** (IVF, quantized IVF): the coarse quantizer is
  replicated, whole inverted lists are greedy-balanced across shards
  (biggest cluster to the lightest shard); each shard reranks only the
  probed lists it owns through the generic ``rerank_topk`` window, ``[b,
  P*M]`` with the lists it does not own masked (kernel 2's generic entry
  under ``rerank_kernel``; the list entry single-device IVF takes is not
  used here, as in the reference).

Exactness invariant: each global id lives on exactly one shard and each
shard's local top-m keeps every global top-k element it owns, so

    topk_k( tree_merge( union_s topk_m(shard_s) ) ) == topk_k(corpus)

with ids exact under the merge tree's wire-precision tie budget (the u16
hamming codec is unconditionally exact).

The shard layouts are the reference's element for element (its numpy
deal and greedy balance); the port builds them with torch gathers on the
inner state's device.  States carry the mesh *recipe* in their static
dict, so checkpoints stay mesh-portable.

Two build keywords are the port's: ``adc_kernel`` / ``rerank_kernel``
pass through to the inner build (the reference sets them on an inner
state it shards itself through ``shard_index``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.ann import distances as D
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        register_functional)
from repro_torch.ann.topk import chunked_topk, topk_smallest
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register
from repro_torch.dist import shard_state as SS
from repro_torch.kernels.rerank_topk import rerank_topk

# static keys added by the sharding layer, stripped again on unshard
_SHARD_STATIC = ("L", "n_shards", "wire_codec", "fan_in", "carry",
                 "shard_arrays", "inner_algo", "shard_axes", "mesh_shape")


def _inner_static(state: IndexState) -> dict:
    return {k: v for k, v in state.static.items() if k not in _SHARD_STATIC}


def _inf(dev) -> torch.Tensor:
    return torch.tensor(float("inf"), device=dev)


# ----------------------------------------------------------------- row plan
def _row_shard(inner: IndexState, S: int):
    """Deal corpus rows round ``S`` shards: [n, ...] -> [S, L, ...] with
    id -1 / +inf-norm sentinels on the pad rows."""
    n = inner.stat("n")
    L = max(1, -(-n // S))
    dev = inner.device
    ids = torch.full((S * L,), -1, dtype=torch.int32, device=dev)
    ids[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    sh = {"ids": ids.reshape(S, L)}
    rep = {}
    for nm in ("X", "codes"):
        if nm in inner.arrays:
            a = inner[nm]
            ap = torch.zeros((S * L,) + tuple(a.shape[1:]), dtype=a.dtype,
                             device=dev)
            ap[:n] = a
            sh[nm] = ap.reshape((S, L) + tuple(a.shape[1:]))
    if "xsq" in inner.arrays:
        xsq = torch.full((S * L,), float("inf"), device=dev)
        xsq[:n] = inner["xsq"].to(torch.float32)
        sh["xsq"] = xsq.reshape(S, L)
    if "codebooks" in inner.arrays:
        rep["codebooks"] = inner["codebooks"]
    static = dict(inner.static)
    static["L"] = L
    return sh, rep, static


def _row_unshard(state: IndexState) -> IndexState:
    n = state.stat("n")
    ids = state["ids"].reshape(-1)
    sel = ids >= 0
    gid = ids[sel].long()
    arrays = {}
    for nm in ("X", "codes", "xsq"):
        if nm in state.arrays:
            flat = state[nm].reshape((-1,) + tuple(state[nm].shape[2:]))
            out = torch.zeros((n,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                              device=flat.device)
            out[gid] = flat[sel]
            arrays[nm] = out
    if "codebooks" in state.arrays:
        arrays["codebooks"] = state["codebooks"]
    return IndexState(state.stat("inner_algo"), state.metric, arrays,
                      _inner_static(state))


def _row_local_plain(q, loc, env, metric: str, m: int):
    """Blockwise streaming scan of this shard's rows: one [b, block]
    distance tile at a time folded into a running top-m, or kernel 1
    (``use_kernel``, euclidean / angular) with the pad rows masked."""
    x, ids = loc["X"], loc["ids"]
    L = ids.shape[0]
    if env.get("use_kernel") and metric in ("euclidean", "angular"):
        from repro_torch.kernels.distance_topk import stream_topk
        return stream_topk(q, x, k=min(m, L), metric=metric,
                           row_ids=ids, valid=ids >= 0)
    block = min(int(env.get("corpus_block") or 2048), L)
    inf = _inf(x.device)

    def chunk(start, size):
        xt = x[start:start + size]
        it = ids[start:start + size]
        if metric == "euclidean":
            d = D.sq_l2_matrix(q, xt, loc["xsq"][start:start + size])
        elif metric == "angular":
            d = D.angular_matrix(q, xt, normalized=True)
        else:
            d = D.hamming_matrix(q, xt)
        d = torch.where(it[None, :] >= 0, d, inf)
        return d, it[None, :].expand(d.shape)

    return chunked_topk(L, min(m, L), block, chunk)


def _row_local_quant(q, loc, rep, env, metric: str, m: int):
    """Compressed-domain local pass: ADC scan over this shard's packed
    codes, then (keep_fp32) the exact rerank fold over the survivors."""
    from repro_torch.kernels.adc_scan import adc_scan

    ids = loc["ids"]
    L = ids.shape[0]
    n_cand = env.get("sharded_n_cand")
    C = L if n_cand is None else max(1, min(int(n_cand), L))
    adc_d, rows = adc_scan(
        loc["codes"], rep["luts"], k=C, block=env.get("adc_block"),
        use_kernel=bool(env.get("adc_kernel", False)))
    # the zero code rows padding this shard to L score like real vectors
    # under ADC; their global id is -1, which is the pad signal
    gl = ids[torch.clamp_min(rows, 0).long()]
    ok = (rows >= 0) & (gl >= 0)
    if env.get("keep_fp32", True) and "X" in loc:
        return rerank_topk(
            q, loc["X"], rows, k=m, metric=metric, xsq=loc.get("xsq"),
            row_ids=ids, valid=ok, block=env.get("rerank_block"),
            use_kernel=bool(env.get("rerank_kernel", False)))
    return (torch.where(ok, adc_d, _inf(adc_d.device)),
            torch.where(ok, gl, torch.full_like(gl, -1)))


def _row_local(q, knobs, loc, rep, env, metric: str, m: int):
    if env.get("quant") is not None:
        return _row_local_quant(q, loc, rep, env, metric, m)
    return _row_local_plain(q, loc, env, metric, m)


def _luts(q, rep, env, metric: str) -> dict:
    """The ADC tables of a quantized build, once per call."""
    if env.get("quant") is None:
        return {}
    from repro_torch.quant import build_luts
    return {"luts": build_luts(rep["codebooks"], q, metric)}


SS.register_shard_plan(SS.ShardPlan(
    inner_algo="BruteForce", sharded_algo="ShardedBruteForce",
    shard=_row_shard, unshard=_row_unshard, local_topk=_row_local,
    prep=_luts,
))


# -------------------------------------------------------- inverted-list plan
def _ivf_layout(sizes: np.ndarray, S: int):
    """The reference's greedy balance, biggest list first (a stable
    argsort) to the lightest shard: (owner shard of each list [C], the
    largest shard load L, at least 1)."""
    C = sizes.shape[0]
    owner = np.zeros(C, np.int32)
    load = np.zeros(S, np.int64)
    for c in np.argsort(-sizes, kind="stable"):
        s = int(np.argmin(load))
        owner[c] = s
        load[s] += int(sizes[c])
    L = max(int(load.max()) if S else 0, 1)
    return owner, L


def _ivf_shard(inner: IndexState, S: int):
    """Partition whole inverted lists across shards, biggest cluster to
    the currently-lightest shard; each shard stores its own cluster-major
    sub-corpus padded to the max shard load."""
    C = inner.stat("n_clusters")
    g_starts = inner["starts"].cpu().numpy()
    g_sizes = inner["sizes"].cpu().numpy()
    owner, L = _ivf_layout(g_sizes, S)
    src = np.full((S, L), -1, np.int64)
    starts = np.zeros((S, C), np.int32)
    sizes = np.zeros((S, C), np.int32)
    cursor = np.zeros(S, np.int64)
    for c in range(C):
        s, sz, g0 = int(owner[c]), int(g_sizes[c]), int(g_starts[c])
        lo = int(cursor[s])
        starts[s, c] = lo
        sizes[s, c] = sz
        src[s, lo:lo + sz] = np.arange(g0, g0 + sz)
        cursor[s] += sz

    dev = inner.device
    idx = torch.as_tensor(src, device=dev)
    pad = idx < 0
    safe = torch.clamp_min(idx, 0)
    sh = {"ids": torch.where(pad, torch.full_like(idx, -1),
                             inner["ids"][safe].long()).to(torch.int32),
          "starts": torch.as_tensor(starts, device=dev),
          "sizes": torch.as_tensor(sizes, device=dev)}
    for nm in ("X", "codes"):
        if nm in inner.arrays:
            a = inner[nm][safe]                           # [S, L, ...]
            a[pad] = 0
            sh[nm] = a
    if "xsq" in inner.arrays:
        sh["xsq"] = torch.where(pad, _inf(dev),
                                inner["xsq"][safe].to(torch.float32))
    rep = {"centers": inner["centers"]}
    if "codebooks" in inner.arrays:
        rep["codebooks"] = inner["codebooks"]
    static = dict(inner.static)
    static["L"] = L
    return sh, rep, static


def _ivf_unshard(state: IndexState) -> IndexState:
    C = state.stat("n_clusters")
    s_starts = state["starts"].cpu().numpy()
    s_sizes = state["sizes"].cpu().numpy()
    L = state["ids"].shape[1]
    g_starts = np.zeros(C, np.int32)
    g_sizes = np.zeros(C, np.int32)
    src, cursor = [], 0
    for c in range(C):
        s = int(np.argmax(s_sizes[:, c]))
        sz = int(s_sizes[s, c])
        lo = int(s_starts[s, c])
        g_starts[c], g_sizes[c] = cursor, sz
        src.append(s * L + np.arange(lo, lo + sz))
        cursor += sz
    dev = state["ids"].device
    flat = torch.as_tensor(np.concatenate(src) if src else
                           np.zeros(0, np.int64), device=dev)
    arrays = {"centers": state["centers"]}
    for nm in ("ids", "X", "codes", "xsq"):
        if nm in state.arrays:
            a = state[nm]
            arrays[nm] = a.reshape((-1,) + tuple(a.shape[2:]))[flat]
    arrays["starts"] = torch.as_tensor(g_starts, device=dev)
    arrays["sizes"] = torch.as_tensor(g_sizes, device=dev)
    if "codebooks" in state.arrays:
        arrays["codebooks"] = state["codebooks"]
    return IndexState(state.stat("inner_algo"), state.metric, arrays,
                      _inner_static(state))


def _ivf_prep(q, rep, env, metric: str) -> dict:
    """The replicated coarse quantizer, once per call: the same top-P
    lists for every shard (ties to the lower centroid, as ``lax.top_k``
    on the negated distances), and a quantized build's ADC tables."""
    cd = D.sq_l2_matrix(q, rep["centers"])               # [b, C]
    _, probes = topk_smallest(cd, int(env["probe_cap"]))  # [b, P]
    return {"probes": probes, **_luts(q, rep, env, metric)}


def _ivf_local(q, knobs, loc, rep, env, metric: str, m: int):
    """One shard's IVF pass: this shard reranks only the probed lists it
    owns (an unowned list has size 0 here)."""
    P = int(env["probe_cap"])
    M = int(env["pad"])                       # max inverted-list length
    ids = loc["ids"]
    L = ids.shape[0]
    dev = ids.device
    probes = rep["probes"]
    n_live = torch.clamp(torch.as_tensor(knobs["n_probes"], device=dev),
                         1, P)
    probe_live = torch.arange(P, dtype=torch.int32, device=dev) < n_live
    starts = loc["starts"][probes]                       # [b, P]
    sizes = loc["sizes"][probes]                         # [b, P]
    offs = torch.arange(M, dtype=torch.int32, device=dev)
    cand = starts[..., None] + offs[None, None, :]       # [b, P, M]
    valid = offs[None, None, :] < sizes[..., None]
    valid = valid & probe_live[None, :, None]
    cand = torch.clamp_max(cand, L - 1).reshape(q.shape[0], -1)
    valid = valid.reshape(q.shape[0], -1)                # [b, P*M]
    if env.get("quant") is not None:
        return _ivf_local_quant(q, loc, rep, env, metric, m, cand, valid)
    return rerank_topk(
        q, loc["X"], cand, k=m, metric=metric, xsq=loc.get("xsq"),
        row_ids=ids, valid=valid, block=env.get("rerank_block"),
        use_kernel=bool(env.get("rerank_kernel", False)))


def _ivf_local_quant(q, loc, rep, env, metric, m, cand, valid):
    """Compressed-domain list pass, mirroring single-device IVF's
    ``_rerank_quantized``: ADC-score the probed window, keep the best,
    exact-rerank when the fp32 rows were retained."""
    from repro_torch.kernels.adc_scan import adc_window_topk

    Cw = cand.shape[1]
    n_cand = env.get("sharded_n_cand")
    W = Cw if n_cand is None else max(1, min(int(n_cand), Cw))
    adc_d, rows = adc_window_topk(loc["codes"], rep["luts"], cand, k=W,
                                  valid=valid, block=env.get("adc_block"))
    if env.get("keep_fp32", True) and "X" in loc:
        return rerank_topk(
            q, loc["X"], rows, k=m, metric=metric, xsq=loc.get("xsq"),
            row_ids=loc["ids"], valid=None,
            block=env.get("rerank_block"),
            use_kernel=bool(env.get("rerank_kernel", False)))
    gl = loc["ids"][torch.clamp_min(rows, 0).long()]
    ok = (rows >= 0) & (gl >= 0)
    return (torch.where(ok, adc_d, _inf(adc_d.device)),
            torch.where(ok, gl, torch.full_like(gl, -1)))


SS.register_shard_plan(SS.ShardPlan(
    inner_algo="IVF", sharded_algo="ShardedIVF",
    shard=_ivf_shard, unshard=_ivf_unshard, local_topk=_ivf_local,
    prep=_ivf_prep, knob_names=("n_probes",),
))


# ------------------------------------------------- sharded brute force
def bruteforce_build(X: np.ndarray, *, metric: str = "euclidean",
                     mesh=None, shard_axes: Optional[Sequence[str]] = None,
                     n_shards: Optional[int] = None,
                     corpus_block: Optional[int] = 2048,
                     wire_codec: Optional[str] = None, fan_in: int = 2,
                     carry: Optional[int] = None, quantize=None,
                     keep_fp32: bool = True, adc_kernel: bool = False,
                     rerank_kernel: bool = False,
                     device=None) -> IndexState:
    """Build the single-device BruteForce state on ``device`` (``cuda``
    unless told otherwise), then shard its rows."""
    from repro_torch.ann import bruteforce

    inner = bruteforce.build(
        np.asarray(X), metric=metric, quantize=quantize,
        keep_fp32=keep_fp32,
        corpus_block=int(corpus_block) if corpus_block else 65536,
        adc_kernel=adc_kernel, rerank_kernel=rerank_kernel, device=device)
    if mesh is not None and shard_axes is None:
        shard_axes = mesh.axis_names
    return SS.shard_index(inner, mesh=mesh, shard_axes=shard_axes,
                          n_shards=n_shards, wire_codec=wire_codec,
                          fan_in=fan_in, carry=carry)


def bruteforce_search(state: IndexState, Q, *, k: int, mesh=None,
                      n_cand=None, use_kernel: bool = False,
                      exact_vals: bool = True, shard_ok=None,
                      fault_hook: bool = True):
    """Exact sharded top-k: streaming per-shard scan + compressed merge
    tree over the state's mesh recipe (or ``mesh``).  ``n_cand`` narrows
    the quantized builds' local rerank window; ``use_kernel`` routes the
    fp32 local scan through kernel 1; ``exact_vals=False`` drops the
    full-precision root tiebreak (minimum wire bytes, wire-precision
    distances out).  ``shard_ok`` / ``fault_hook``: the degraded-mode
    keep-mask and the fault hook (see
    :func:`repro_torch.dist.shard_state.sharded_search`)."""
    k = min(int(k), state.stat("n"))
    env_extra = {"use_kernel": bool(use_kernel)}
    if n_cand is not None:
        env_extra["sharded_n_cand"] = int(n_cand)
    return SS.sharded_search(state, Q, k=k, mesh=mesh,
                             env_extra=env_extra, exact_vals=exact_vals,
                             shard_ok=shard_ok, fault_hook=fault_hook)


register_functional(FunctionalSpec(
    name="ShardedBruteForce", build=bruteforce_build,
    search=bruteforce_search, query_params=(),
    static_query_params=("mesh",),
    supported_metrics=("euclidean", "angular", "hamming"),
))


def _mesh_for(mesh, shard_axes, n_shards):
    if mesh is None and n_shards is None:
        return SS.default_mesh()
    if mesh is None:
        return SS.flat_mesh(int(n_shards))
    return mesh, shard_axes


@register("ShardedBruteForce")
class ShardedBruteForce(FunctionalANN):
    """Exact brute force over a sharded corpus.  On a 1-device host this
    degenerates to BruteForce; on a mesh it is the sharded serving
    path."""

    supported_metrics = ("euclidean", "angular", "hamming")

    def __init__(self, metric: str, mesh=None,
                 shard_axes: Optional[Sequence[str]] = None,
                 corpus_block: Optional[int] = None,
                 n_shards: Optional[int] = None,
                 wire_codec: Optional[str] = None, fan_in: int = 2):
        mesh, shard_axes = _mesh_for(mesh, shard_axes, n_shards)
        axes = tuple(shard_axes or mesh.axis_names)
        super().__init__(metric, build_params=dict(
            mesh=mesh, shard_axes=axes, corpus_block=corpus_block or 2048,
            wire_codec=wire_codec, fan_in=int(fan_in)),
            query_params={"mesh": mesh})
        self.mesh = mesh
        self.shard_axes = axes
        self.corpus_block = corpus_block
        suffix = ",streaming" if corpus_block else ""
        self.name = (f"ShardedBruteForce(axes={','.join(self.shard_axes)}"
                     f"{suffix})")
        self._dist_comps = 0

    def _sync_state(self):
        self._n = self._state.stat("n")

    def _n_shards(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.shard_axes]))

    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        out = super().query(q, k)
        self._dist_comps += self._n
        return out

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        super().batch_query(Q, k)
        self._dist_comps += self._n * Q.shape[0]

    def get_additional(self):
        return {"dist_comps": self._dist_comps,
                "n_shards": self._n_shards()}


# --------------------------------------------------------------- sharded IVF
def ivf_build(X: np.ndarray, *, metric: str = "euclidean",
              n_clusters: int = 100, mesh=None,
              shard_axes: Optional[Sequence[str]] = None,
              n_shards: Optional[int] = None, n_iters: int = 10,
              seed: int = 0, wire_codec: Optional[str] = None,
              fan_in: int = 2, carry: Optional[int] = None, quantize=None,
              keep_fp32: bool = True, rerank_kernel: bool = False,
              device=None) -> IndexState:
    """Single-device IVF build (k-means, cluster-major layout) on
    ``device``, then whole inverted lists greedy-balanced across the
    mesh."""
    from repro_torch.ann import ivf

    inner = ivf.build(np.asarray(X), metric=metric,
                      n_clusters=int(n_clusters), n_iters=int(n_iters),
                      seed=int(seed), quantize=quantize,
                      keep_fp32=keep_fp32, rerank_kernel=rerank_kernel,
                      device=device)
    if mesh is not None and shard_axes is None:
        shard_axes = mesh.axis_names
    return SS.shard_index(inner, mesh=mesh, shard_axes=shard_axes,
                          n_shards=n_shards, wire_codec=wire_codec,
                          fan_in=fan_in, carry=carry)


def ivf_search(state: IndexState, Q, *, k: int, n_probes=1,
               max_probes: Optional[int] = None, mesh=None, n_cand=None,
               exact_vals: bool = True, shard_ok=None,
               fault_hook: bool = True):
    """``max_probes`` sizes the probed window; ``n_probes`` may then be a
    runtime value (an int or a 0-d tensor) that masks probes past it, as
    single-device IVF's.  ``shard_ok`` / ``fault_hook``: see
    :func:`repro_torch.dist.shard_state.sharded_search`."""
    C = state.stat("n_clusters")
    k = min(int(k), state.stat("n"))
    if max_probes is None:
        cap = max(1, min(int(n_probes), C))
        n_probes = cap
    else:
        cap = max(1, min(int(max_probes), C))
    env_extra = {"probe_cap": cap}
    if n_cand is not None:
        env_extra["sharded_n_cand"] = int(n_cand)
    return SS.sharded_search(state, Q, k=k, mesh=mesh, knobs=(n_probes,),
                             env_extra=env_extra, exact_vals=exact_vals,
                             shard_ok=shard_ok, fault_hook=fault_hook)


register_functional(FunctionalSpec(
    name="ShardedIVF", build=ivf_build, search=ivf_search,
    query_params=("n_probes", "max_probes"), query_defaults=(1, None),
    static_query_params=("n_probes", "max_probes", "mesh"),
    traced_knobs=(("n_probes", "max_probes"),),
))


@register("ShardedIVF")
class ShardedIVF(FunctionalANN):
    """Distributed IVF: whole inverted lists partitioned across the mesh.

    fit(): k-means on the build device (identical centers to
    single-device IVF at the same seed); clusters are assigned to shards
    greedy-balanced by descending size; each shard stores its own
    cluster-major sub-corpus (padded to the max shard load).
    query(): replicated coarse quantizer -> top-nprobe lists; every shard
    reranks the probed lists IT OWNS and the compressed hierarchical merge
    combines the shards' results.
    """

    supported_metrics = ("euclidean", "angular")
    batch_block = 2048

    def __init__(self, metric: str, n_clusters: int = 100, mesh=None,
                 shard_axes: Optional[Sequence[str]] = None,
                 n_iters: int = 10, seed: int = 0,
                 n_shards: Optional[int] = None,
                 wire_codec: Optional[str] = None, fan_in: int = 2):
        mesh, shard_axes = _mesh_for(mesh, shard_axes, n_shards)
        axes = tuple(shard_axes or mesh.axis_names)
        super().__init__(metric, build_params=dict(
            n_clusters=int(n_clusters), mesh=mesh, shard_axes=axes,
            n_iters=int(n_iters), seed=int(seed), wire_codec=wire_codec,
            fan_in=int(fan_in)), query_params={"n_probes": 1, "mesh": mesh})
        self.mesh = mesh
        self.shard_axes = axes
        self.n_clusters = int(n_clusters)
        self.n_iters = int(n_iters)
        self.seed = int(seed)
        self.n_probes = 1
        self.name = f"ShardedIVF(C={n_clusters})"
        self._dist_comps = 0

    def _sync_state(self):
        self._n = self._state.stat("n")
        self._pad = self._state.stat("pad")

    def _n_shards(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.shard_axes]))

    def set_query_arguments(self, n_probes: int) -> None:
        self.n_probes = max(1, int(n_probes))
        self._qparams["n_probes"] = self.n_probes

    def _count(self, nq: int) -> None:
        C = int(self._state["centers"].shape[0])
        self._dist_comps += nq * (C + min(self.n_probes, C) * self._pad)

    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        out = super().query(q, k)
        self._count(1)
        return out

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        super().batch_query(Q, k)
        self._count(Q.shape[0])

    def get_additional(self):
        return {"dist_comps": self._dist_comps,
                "n_shards": self._n_shards(), "max_list": self._pad}


# ------------------------------------------------- raw-array entry
def make_sharded_topk(mesh, shard_axes: Sequence[str], k: int,
                      metric: str, corpus_block: Optional[int] = None,
                      wire_codec: Optional[str] = None, fan_in: int = 2):
    """Raw-array sharded top-k over stacked arrays: ``fn(q, x [S, L, d],
    ids [S, L], xsq [S, L]) -> (vals [b, k], ids [b, k])``, the exact
    global top-k of every shard's blockwise streaming local scan
    (``corpus_block`` rows a tile) folded by the compressed merge tree
    with its full-precision root tiebreak."""
    from repro_torch.dist import wire
    from repro_torch.dist.collectives import tree_merge_topk

    axes = tuple(shard_axes)
    codec = wire_codec or wire.default_codec(metric)
    axis_sizes = tuple(int(mesh.shape[a]) for a in axes)
    env = {"corpus_block": corpus_block}

    def fn(q, x, ids, xsq):
        outs = [_row_local_plain(q, {"X": x[s], "ids": ids[s],
                                     "xsq": xsq[s]}, env, metric, int(k))
                for s in range(x.shape[0])]
        return tree_merge_topk(
            torch.stack([v for v, _ in outs]),
            torch.stack([i for _, i in outs]), axes=axes,
            axis_sizes=axis_sizes, k=int(k), codec=codec,
            fan_in=int(fan_in), exact_vals=True)

    return fn
