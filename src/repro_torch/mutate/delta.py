"""Streaming index mutation: delta buffer + tombstones + compaction
(``repro.mutate.delta``).

The paper benchmarks frozen indexes; production corpora churn.  This
module makes a BruteForce or IVF main index *mutable* while keeping the
functional core's contracts (pure search, canonical ids):

  * **delta buffer** -- inserts land in fixed-capacity preallocated device
    tensors.  At query time the delta is scanned exhaustively by the
    distance the main index uses (a BruteForce main's distance matrix; an
    IVF main's rerank, with the delta as one list) and merged with the
    main index's top-k through
    :func:`repro_torch.kernels.rerank_topk.merge_topk_unique_rounds` -- the
    unique-by-id merge, because a re-inserted id can transiently appear in
    both operands.
  * **tombstones** -- deletes clear a validity bit on the main index
    (``main_live``) and the delta (``delta_live``); deleted rows are
    masked, never compacted out of the tensors.  IVF's main search takes
    them as the rerank's row mask (kernel 2's list entry with
    ``row_live`` on the card, with ``rerank_kernel=True``).
  * **compaction** -- :func:`compact` rebuilds a fresh main index from the
    live rows (main survivors + delta survivors) and returns a state with
    an empty delta.  A ``MutableBruteForce`` corpus is padded back to the
    same slot count; a ``MutableIVF`` rebuild re-clusters.

Every update is out of place: :func:`insert` and :func:`delete` return a
new state and leave the old one answering exactly as before (the
reference's ``_append`` / ``_tombstone`` are pure jitted functions; an
in-place ``index_copy_`` / ``masked_fill_`` would change every older
state that shares the tensor).  Id collisions are found by a binary
search of each id in the m sorted keys, not the reference's [n, m]
comparison matrix (1 GB at n = 10^6, m = 1,024), with the same answer;
freshly allocated ids cannot collide, so an insert without explicit ids
skips that search.

The delta's fill (``count``) and the next fresh id (``next_id``) are read
by the host on every insert, so they are kept as 0-d int32 tensors on the
CPU: no device read per insert.

Canonical ids: every select in the pipeline -- the main index's masked
search and the final unique merge over it and the delta -- orders by
(distance, *global id*) ascending.  That is what makes the
result equal to a brute-force oracle rebuilt from the live rows, even
under distance ties, and what guarantees a deleted id can never ride a tie
back into the results.

Global ids are stable across the index's lifetime: build rows get
``0..n-1``, inserts allocate from ``next_id`` (or take explicit ids --
re-inserting a live id upserts: the old copy is tombstoned in the same
append).  ``main_ids`` maps the main index's build-input rows to global
ids; compaction preserves ids.

Angular note: the raw (un-normalised) vectors are retained alongside the
canonical ones (``main_raw``/``delta_raw``) because compaction must feed
the rebuild *raw* rows -- normalising an already-normalised vector is not
bitwise idempotent.  Euclidean/hamming canonicalisation is a dtype cast,
so no raw copy is kept.

:func:`compact` calls the serving layer's fault-injection hook
(``serve.faults.compaction_attempt``) before anything else, as the
reference does: an installed plan with ``compact_fault`` scheduled raises
:class:`~repro_torch.serve.errors.CompactionError` there, before any new
state exists.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        get_functional, prepare_points,
                                        prepare_queries, queries_on,
                                        register_functional)
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register
from repro_torch.kernels.rerank_topk import merge_topk_unique_rounds

#: outer algo name per inner spec.
MUTABLE_ALGOS = {"BruteForce": "MutableBruteForce", "IVF": "MutableIVF"}
_INNER_OF = {v: k for k, v in MUTABLE_ALGOS.items()}


class DeltaFull(RuntimeError):
    """The delta buffer has no room for the requested insert; compact
    (``mutate.compact``) to fold the delta into the main index, or rebuild
    with a larger ``delta_capacity``."""


def is_mutable(state: IndexState) -> bool:
    return state.algo in _INNER_OF


def _require_mutable(state: IndexState, what: str) -> None:
    if not is_mutable(state):
        raise ValueError(
            f"{what} needs a mutable index state (one of "
            f"{sorted(_INNER_OF)}); got {state.algo!r} — build it through "
            f"the Mutable* spec to get a delta buffer and tombstones")


def _raw_dtype(metric: str):
    return np.uint32 if metric == "hamming" else np.float32


def _host_rows(t: torch.Tensor, metric: str) -> np.ndarray:
    """A device corpus tensor -> host rows in the reference's dtype."""
    a = t.cpu().numpy()
    return a.view(np.uint32) if metric == "hamming" else a


def _scalar(value: int) -> torch.Tensor:
    """A host-side 0-d int32 counter (``count``, ``next_id``)."""
    return torch.tensor(int(value), dtype=torch.int32)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

def _inner_build(inner: str, X, metric: str, params: dict,
                 device) -> IndexState:
    """Compaction/build indirection point: rebuilds the inner index.  A
    BruteForce main takes its angular distances with float64 dots rounded
    once (``bruteforce.exact_angular``): the delta is scanned in another
    matrix, and copies of a row in the two must tie exactly."""
    state = get_functional(inner).build(X, metric=metric, device=device,
                                        **dict(params))
    if inner == "BruteForce":
        from repro_torch.ann import bruteforce

        state = bruteforce.exact_angular(state)
    return state


def _fresh_arrays(new_inner: IndexState, ids: np.ndarray, live: np.ndarray,
                  feed: np.ndarray, metric: str, cap: int, d: int,
                  next_id) -> dict:
    """A mutable state's tensors around ``new_inner``: main ids and
    liveness, an empty delta of ``cap`` slots."""
    dev = new_inner.device
    cdt = torch.int32 if metric == "hamming" else torch.float32
    arrays = {
        "main": new_inner,
        "main_ids": torch.as_tensor(ids.astype(np.int32)).to(dev),
        "main_live": torch.as_tensor(live).to(dev),
        "delta_x": torch.zeros((cap, d), dtype=cdt, device=dev),
        "delta_ids": torch.full((cap,), -1, dtype=torch.int32, device=dev),
        "delta_live": torch.zeros((cap,), dtype=torch.bool, device=dev),
        "count": _scalar(0),
        "next_id": _scalar(next_id),
    }
    if metric == "euclidean":
        arrays["delta_xsq"] = torch.zeros((cap,), dtype=torch.float32,
                                          device=dev)
    if metric == "angular":
        arrays["main_raw"] = torch.as_tensor(feed).to(dev)
        arrays["delta_raw"] = torch.zeros((cap, d), dtype=torch.float32,
                                          device=dev)
    return arrays


def _build_mutable(X, *, metric: str, inner: str,
                   delta_capacity: int = 1024,
                   compact_threshold: float = 0.75, device=None,
                   **inner_params) -> IndexState:
    """Wrap an inner build in the mutable (delta + tombstone) state."""
    for bad in ("quantize", "streaming"):
        if inner_params.get(bad):
            raise ValueError(
                f"{MUTABLE_ALGOS[inner]} does not support {bad}= (the delta "
                f"scan and compaction paths need the plain fp32/uint32 "
                f"corpus); build a frozen {inner} index for that")
    if inner_params.get("backend") == "pallas":
        raise ValueError(
            "MutableBruteForce needs backend='jnp' (the streaming kernel "
            "has no tombstone mask input yet)")
    cap = int(delta_capacity)
    if cap < 1:
        raise ValueError(f"delta_capacity must be >= 1, got {delta_capacity}")
    dev = resolve_device(device)
    raw = np.asarray(X).astype(_raw_dtype(metric))
    n, d = raw.shape
    if inner == "BruteForce":
        # headroom: pad the corpus with dead slots so a compaction after up
        # to ``cap`` net inserts rebuilds into the SAME shapes
        feed = np.concatenate([raw, np.zeros((cap, d), raw.dtype)])
        ids = np.concatenate([np.arange(n, dtype=np.int32),
                              np.full(cap, -1, np.int32)])
        live = np.concatenate([np.ones(n, bool), np.zeros(cap, bool)])
    else:
        # IVF: dead pad rows would pollute k-means, so the inner corpus is
        # exactly the live set
        feed, ids, live = raw, np.arange(n, dtype=np.int32), np.ones(n, bool)
    inner_state = _inner_build(inner, feed, metric, inner_params, dev)
    arrays = _fresh_arrays(inner_state, ids, live, feed, metric, cap, d, n)
    static = {
        "inner": inner, "d": int(d), "delta_capacity": cap,
        "compact_threshold": float(compact_threshold),
        "build": dict(inner_params),
    }
    return IndexState(MUTABLE_ALGOS[inner], metric, arrays, static)


def build_bruteforce(X, *, metric: str = "euclidean",
                     delta_capacity: int = 1024,
                     compact_threshold: float = 0.75, device=None,
                     **inner_params) -> IndexState:
    """Mutable exact index: brute-force main + delta buffer."""
    return _build_mutable(X, metric=metric, inner="BruteForce",
                          delta_capacity=delta_capacity,
                          compact_threshold=compact_threshold,
                          device=device, **inner_params)


def build_ivf(X, *, metric: str = "euclidean", delta_capacity: int = 1024,
              compact_threshold: float = 0.75, device=None,
              **inner_params) -> IndexState:
    """Mutable IVF: cluster-probed main + exact delta scan (fresh rows are
    always found -- the delta is scanned exhaustively until compaction
    folds them into the inverted lists)."""
    return _build_mutable(X, metric=metric, inner="IVF",
                          delta_capacity=delta_capacity,
                          compact_threshold=compact_threshold,
                          device=device, **inner_params)


# --------------------------------------------------------------------------
# insert / delete: out-of-place updates (no shape ever changes)
# --------------------------------------------------------------------------

def _put(buf: torch.Tensor, start: int, rows: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``rows`` at [start, start + m): a new tensor."""
    return torch.cat([buf[:start], rows, buf[start + rows.shape[0]:]])


def _hits(ids: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """[n] bool: which of ``ids`` are in ``keys`` (int32, on one device).
    ``torch.isin``'s answer through a sort of the m keys and a binary
    search per id, with no [n, m] comparison matrix."""
    keys = torch.sort(keys).values
    pos = torch.searchsorted(keys, ids).clamp_(max=keys.shape[0] - 1)
    return keys[pos] == ids


def _append(state: IndexState, Xc: torch.Tensor, Xraw, ids_t: torch.Tensor,
            fresh: bool, start: int) -> dict:
    """Upsert ``m`` rows at delta slots [start, start+m).

    Colliding live copies of the incoming ids -- in the main index or in
    older delta slots -- are tombstoned in the same step, which is what
    keeps "one live copy per id" an invariant the merge can rely on.
    ``fresh`` ids (allocated from ``next_id``, above every id the index
    has held) collide with none, so that search is skipped.  The main
    corpus rides through by reference; every tensor that changes is a new
    one.
    """
    dev = ids_t.device
    m = ids_t.shape[0]
    out = {}
    dlive = state["delta_live"]
    if not fresh:
        out["main_live"] = state["main_live"] & ~_hits(state["main_ids"],
                                                       ids_t)
        dlive = dlive & ~_hits(state["delta_ids"], ids_t)
    out["delta_x"] = _put(state["delta_x"], start, Xc)
    if "delta_xsq" in state.arrays:
        xsq = torch.sum(Xc.to(torch.float32) ** 2, dim=1)
        out["delta_xsq"] = _put(state["delta_xsq"], start, xsq)
    if "delta_raw" in state.arrays:
        out["delta_raw"] = _put(state["delta_raw"], start,
                                torch.as_tensor(Xraw).to(dev))
    out["delta_ids"] = _put(state["delta_ids"], start, ids_t)
    out["delta_live"] = _put(dlive, start, torch.ones(
        (m,), dtype=torch.bool, device=dev))
    return out


def _tombstone(state: IndexState, del_ids: np.ndarray) -> dict:
    keys = torch.as_tensor(del_ids).to(state["main_ids"].device)
    return {"main_live": state["main_live"]
            & ~_hits(state["main_ids"], keys),
            "delta_live": state["delta_live"]
            & ~_hits(state["delta_ids"], keys)}


def insert(state: IndexState, X_new, ids=None):
    """Append rows to the delta buffer; returns ``(state', new_ids)``.

    ``ids`` assigns explicit global ids (an id already live anywhere in
    the index is upserted: the old copy is tombstoned); by default fresh
    ids are allocated from ``next_id``.  Raises :class:`DeltaFull` when
    the buffer cannot hold the batch -- compact first.  ``state`` itself
    is unchanged.
    """
    _require_mutable(state, "insert()")
    X_new = np.asarray(X_new)
    if X_new.ndim == 1:
        X_new = X_new[None, :]
    m = X_new.shape[0]
    cap = state.stat("delta_capacity")
    used = int(state["count"])
    if used + m > cap:
        raise DeltaFull(
            f"delta buffer holds {used}/{cap} rows; inserting {m} more "
            f"overflows it — compact() the index (or build with a larger "
            f"delta_capacity)")
    dev = state["main_ids"].device
    if ids is None:
        start_id = int(state["next_id"])
        new_ids = np.arange(start_id, start_id + m, dtype=np.int32)
        ids_t = torch.arange(start_id, start_id + m, dtype=torch.int32,
                             device=dev)
    else:
        new_ids = np.asarray(ids, np.int32).reshape(-1)
        if new_ids.shape[0] != m:
            raise ValueError(f"ids has {new_ids.shape[0]} entries for "
                             f"{m} rows")
        if len(np.unique(new_ids)) != m or (new_ids < 0).any():
            raise ValueError("explicit ids must be unique and >= 0")
        ids_t = torch.as_tensor(new_ids).to(dev)
    raw = X_new.astype(_raw_dtype(state.metric))
    canon = prepare_points(raw, state.metric)
    updated = _append(state, queries_on(canon, state.metric, dev), raw,
                      ids_t, ids is None, used)
    updated["count"] = _scalar(used + m)
    updated["next_id"] = _scalar(max(int(state["next_id"]),
                                     int(new_ids.max()) + 1))
    return state.replace(**updated), new_ids


def delete(state: IndexState, ids) -> IndexState:
    """Tombstone global ids everywhere (main + delta).  Idempotent: ids
    that are absent (or already dead) are silently skipped -- a delete is
    a statement about the corpus, not a lookup.  ``state`` itself is
    unchanged."""
    _require_mutable(state, "delete()")
    del_ids = np.asarray(ids, np.int32).reshape(-1)
    if del_ids.size == 0:
        return state
    return state.replace(**_tombstone(state, del_ids))


# --------------------------------------------------------------------------
# search: masked main + exact delta scan + unique merge
# --------------------------------------------------------------------------

def _delta_scan(state: IndexState, Qp, kk: int):
    """(dist, global id) candidates of the delta, by the distance the main
    index uses, dead slots at (+inf, -1) so they can never surface (even
    on ties).

    MutableBruteForce: every slot, by the inner index's own distance matrix
    (``bruteforce.distance_matrix``).  MutableIVF: the filled slots as one
    list through the inner index's rerank (kernel 2's list entry with
    ``rerank_kernel``, else the torch fold), the delta's own top-kk; the
    list entry computes each distance alone, so a copy of a row in the
    main lists and in the delta ties exactly."""
    from repro_torch.ann import bruteforce
    from repro_torch.kernels.rerank_topk import rerank_lists, rerank_topk

    inner = state["main"]
    live, ids = state["delta_live"], state["delta_ids"]
    xsq = state.arrays.get("delta_xsq")
    if state.stat("inner") == "BruteForce":
        dd = bruteforce.distance_matrix(inner, Qp, state["delta_x"], xsq)
        dd = torch.where(live[None, :], dd.to(torch.float32),
                         torch.full((), float("inf"), device=dd.device))
        dids = torch.where(live, ids, torch.full_like(ids, -1))
        return dd, dids[None, :].expand(dd.shape[0], -1)
    used = int(state["count"])
    if used == 0:
        return None
    b, dev = Qp.shape[0], Qp.device
    X, live, ids = state["delta_x"][:used], live[:used], ids[:used]
    xsq = None if xsq is None else xsq[:used]
    if inner.static.get("rerank_kernel", False):
        i32 = torch.int32
        return rerank_lists(
            Qp, X, torch.zeros((b, 1), dtype=i32, device=dev), k=kk,
            metric=state.metric, starts=torch.zeros(1, dtype=i32, device=dev),
            sizes=torch.full((1,), used, dtype=i32, device=dev), M=used,
            row_ids=ids, xsq=xsq, row_live=live)
    cand = torch.arange(used, dtype=torch.int32, device=dev)
    return rerank_topk(Qp, X, cand[None, :].expand(b, -1), k=kk,
                       metric=state.metric, xsq=xsq, row_ids=ids,
                       valid=live[None, :].expand(b, -1),
                       block=inner.static.get("rerank_block"))


def _merged_search(state: IndexState, Q, *, k: int, knobs=None):
    """The main index's canonical top-kk over its live rows, merged with
    the delta's candidates by the unique (dist, id) select.  For
    MutableBruteForce the candidates are every delta slot: a candidate
    outside a list's canonical top-kk is beaten by kk distinct ids of that
    list, so one select over the main list and the whole delta gives what
    the reference's two selects give, with one select fewer."""
    from repro_torch.ann import bruteforce, ivf

    inner = state["main"]
    cap = state.stat("delta_capacity")
    kk = min(int(k), inner.stat("n") + cap)
    if state.stat("inner") == "BruteForce":
        d1, g1 = bruteforce.search(inner, Q, k=kk, live=state["main_live"],
                                   id_map=state["main_ids"])
    else:
        d1, g1 = ivf.search(inner, Q, k=kk, live=state["main_live"],
                            id_map=state["main_ids"], **(knobs or {}))
    delta = _delta_scan(state, prepare_queries(Q, state.metric,
                                               inner.device), kk)
    if delta is None:
        cd, ci = d1.to(torch.float32), g1.to(torch.int32)
    else:
        cd = torch.cat([d1.to(torch.float32), delta[0].to(torch.float32)],
                       dim=1)
        ci = torch.cat([g1.to(torch.int32), delta[1].to(torch.int32)], dim=1)
    # unique merge: a re-inserted id may appear in BOTH operands
    return merge_topk_unique_rounds(cd, ci, kk)


def search_bruteforce(state: IndexState, Q, *, k: int):
    """Exact over the live set: masked main scan + delta scan, merged."""
    return _merged_search(state, Q, k=k)


def search_ivf(state: IndexState, Q, *, k: int, n_probes=1, scan=None,
               max_probes=None, max_scan=None):
    """IVF probe over the live main rows + exact delta scan, merged.
    Same traced-knob treatment as the frozen IVF spec (``n_probes`` under
    ``max_probes``, ``scan`` under ``max_scan``)."""
    return _merged_search(state, Q, k=k,
                          knobs=dict(n_probes=n_probes, scan=scan,
                                     max_probes=max_probes,
                                     max_scan=max_scan))


# --------------------------------------------------------------------------
# compaction
# --------------------------------------------------------------------------

def live_count(state: IndexState) -> int:
    """Host-side count of live rows (main survivors + delta survivors)."""
    _require_mutable(state, "live_count()")
    return int(state["main_live"].sum()) + int(state["delta_live"].sum())


def delta_fraction(state: IndexState) -> float:
    """Occupied fraction of the delta buffer -- the compaction pressure
    gauge ``compact_threshold`` is compared against."""
    _require_mutable(state, "delta_fraction()")
    return int(state["count"]) / state.stat("delta_capacity")


def live_items(state: IndexState):
    """``(global_ids [L], raw_rows [L, d])`` of every live row, main rows
    first (build-input order) then delta rows (slot order).  The rows are
    the *raw* vectors -- exactly what a fresh build (or the oracle) would
    be fed."""
    _require_mutable(state, "live_items()")
    metric = state.metric
    ids_m = state["main_ids"].cpu().numpy()
    sel_m = state["main_live"].cpu().numpy() & (ids_m >= 0)
    if metric == "angular":
        Xm = state["main_raw"].cpu().numpy()
    elif state.stat("inner") == "BruteForce":
        Xm = _host_rows(state["main"]["X"], metric)
    else:
        # IVF stores the corpus cluster-major; undo the permutation so the
        # gathered rows line up with main_ids (build-input order)
        cm = _host_rows(state["main"]["X"], metric)
        rows = state["main"]["ids"].cpu().numpy()
        Xm = np.empty_like(cm)
        Xm[rows] = cm
    sel_d = state["delta_live"].cpu().numpy()
    Xd = _host_rows(state["delta_raw" if metric == "angular"
                          else "delta_x"], metric)
    ids = np.concatenate([ids_m[sel_m],
                          state["delta_ids"].cpu().numpy()[sel_d]])
    X = np.concatenate([Xm[sel_m], Xd[sel_d]]).astype(_raw_dtype(metric))
    return ids.astype(np.int32), X


def compact(state: IndexState) -> IndexState:
    """Rebuild the main index from the live rows; empty the delta.

    The returned state answers every query identically to ``state`` (same
    live set, same global ids, canonical select).  For MutableBruteForce
    the rebuilt corpus is padded back to the previous slot count whenever
    the live set fits; if the live set outgrew the slots, they grow by
    ``delta_capacity`` headroom.  MutableIVF re-clusters.  ``state``
    itself is unchanged: persisting the new one is the caller's move
    (the atomic tmp-rename of :mod:`repro_torch.serve.checkpoint`), so a
    death anywhere in here leaves the last checkpoint untouched.  An
    installed fault plan may make it raise
    :class:`~repro_torch.serve.errors.CompactionError` first.
    """
    _require_mutable(state, "compact()")
    # fault-injection point: an installed FaultPlan with compact_fault
    # scheduled raises CompactionError HERE, before any new state exists,
    # so the caller's serving state is provably untouched (lazy import:
    # repro_torch.mutate stays importable without the serve package)
    from repro_torch.serve import faults as _faults
    _faults.compaction_attempt()
    metric = state.metric
    inner_name = state.stat("inner")
    cap = state.stat("delta_capacity")
    ids, X = live_items(state)
    L, d = X.shape[0], state.stat("d")
    if inner_name == "BruteForce":
        slots = state["main"].stat("n")
        if L > slots:
            slots = L + cap               # grow with headroom
        pad = slots - L
        feed = np.concatenate([X, np.zeros((pad, d), X.dtype)])
        new_ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
        live = np.concatenate([np.ones(L, bool), np.zeros(pad, bool)])
    else:
        feed, new_ids, live = X, ids, np.ones(L, bool)
    new_inner = _inner_build(inner_name, feed, metric,
                             dict(state.stat("build")), state["main"].device)
    arrays = _fresh_arrays(new_inner, new_ids, live, feed, metric, cap, d,
                           int(state["next_id"]))
    return IndexState(state.algo, metric, arrays, state.static)


# --------------------------------------------------------------------------
# registration: functional specs + adapter classes
# --------------------------------------------------------------------------

BRUTEFORCE_SPEC = register_functional(FunctionalSpec(
    name="MutableBruteForce", build=build_bruteforce,
    search=search_bruteforce,
    supported_metrics=("euclidean", "angular", "hamming"),
))

IVF_SPEC = register_functional(FunctionalSpec(
    name="MutableIVF", build=build_ivf, search=search_ivf,
    query_params=("n_probes", "scan", "max_probes", "max_scan"),
    query_defaults=(1, None, None, None),
    static_query_params=("n_probes", "scan", "max_probes", "max_scan"),
    supported_metrics=("euclidean", "angular"),
    traced_knobs=(("n_probes", "max_probes"), ("scan", "max_scan")),
))


@register("MutableBruteForce")
class MutableBruteForce(FunctionalANN):
    supported_metrics = ("euclidean", "angular", "hamming")

    def __init__(self, metric: str, delta_capacity: int = 1024,
                 compact_threshold: float = 0.75, **inner_params):
        super().__init__(metric, build_params=dict(
            delta_capacity=int(delta_capacity),
            compact_threshold=float(compact_threshold), **inner_params))
        self.name = f"MutableBruteForce(cap={int(delta_capacity)})"


@register("MutableIVF")
class MutableIVF(FunctionalANN):
    supported_metrics = ("euclidean", "angular")

    def __init__(self, metric: str, n_clusters: int = 100,
                 delta_capacity: int = 1024,
                 compact_threshold: float = 0.75, **inner_params):
        super().__init__(metric, build_params=dict(
            n_clusters=int(n_clusters), delta_capacity=int(delta_capacity),
            compact_threshold=float(compact_threshold), **inner_params))
        self.name = (f"MutableIVF(C={int(n_clusters)}, "
                     f"cap={int(delta_capacity)})")
