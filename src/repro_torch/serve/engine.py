"""Batching serve engine over the functional index core
(``repro.serve.engine``).

The experiment loop calls algorithms per query set; a serving system sees an
open-ended stream of variable-size requests.  ``Engine`` turns an immutable
:class:`~repro_torch.ann.functional.IndexState` into that serving surface:

  * **one batch shape** -- every request batch is padded up to a fixed
    micro-batch ``[batch_size, d]`` before the spec's pure ``search``
    runs.  The reference pads so that its jitted search is traced once;
    the port runs eagerly and has no trace, but pads all the same, so a
    micro-batch does the same work and ``stats["padded"]`` counts the same
    rows;
  * **micro-batching** -- ``submit()`` queues single queries and returns a
    :class:`Ticket` (a future: ``ticket.result()`` blocks, ``.done()``
    polls); ``search()`` streams arbitrarily large query sets through
    fixed-size micro-batches;
  * **deadlines** -- ``submit(q, deadline_ms=...)`` bounds how stale an
    answer may be: a request whose deadline expires before its
    micro-batch runs is answered with
    :class:`~repro_torch.serve.errors.DeadlineExceeded` instead of
    blocking or poisoning the batch it would have ridden in;
  * **checkpointing** -- ``save()``/``load()`` round-trip through
    :mod:`repro_torch.serve.checkpoint` (the reference's versioned
    ``.npz``, readable by either package; stale/garbage files raise
    :class:`~repro_torch.serve.checkpoint.CheckpointError`).

Query-time knobs ride along per engine (``query_params=``) and can be
overridden per ``search()`` call or per ``submit()``-ed request; a knob
whose static ``max_*`` cap partner is pinned in ``query_params`` is
automatically demoted to a traced runtime value (the spec's
``traced_knobs``; :func:`repro_torch.ann.functional.bind_search` passes it
as a 0-d tensor and the cap sizes the window), so per-request quality
settings -- e.g. IVF's ``n_probes`` under ``max_probes``, HNSW's ``ef``
under ``max_ef`` -- answer as the reference's traced search does.

``Engine`` itself is synchronous and single-threaded (a flush happens on
the caller's thread when a batch fills, a ``ticket.result()`` forces one);
background compaction runs on its own thread.  The reference's SLO-aware
pump (``AsyncEngine``) is not ported yet (ROADMAP.md §1), nor are sharded
states (item 6): an engine refuses a state whose ``static`` has
``shard_axes``.
"""

from __future__ import annotations

import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import sync
from repro_torch.ann.functional import IndexState, bind_search, get_functional
from repro_torch.serve import checkpoint as _ckpt
from repro_torch.serve.checkpoint import (ARCHIVE_VERSION,  # noqa: F401
                                          CHECKPOINT_VERSION, CheckpointError,
                                          load_state, save_state)
from repro_torch.serve.errors import DeadlineExceeded


class Ticket(int):
    """Future-style handle for one ``submit()``-ed request.

    ``ticket.result(timeout=)`` blocks until the request is answered and
    returns ``(dists [k], ids [k])`` (raising the request's typed error --
    e.g. :class:`DeadlineExceeded` -- if it failed); ``ticket.done()``
    polls without blocking.  On the synchronous :class:`Engine`,
    ``result()`` flushes the queue itself.

    Subclasses ``int`` (the submission sequence number) so one release of
    legacy call sites keeps working unchanged: ``eng.result(ticket)``,
    dict keys, and format strings all still see the bare-int ticket.
    That int protocol is the deprecation shim, not the API.
    """

    def __new__(cls, seq: int, resolver, *, deadline_s: Optional[float] = None,
                tenant: Optional[str] = None):
        t = super().__new__(cls, seq)
        t._resolver = resolver
        t._event = threading.Event()
        t._value: Optional[Tuple[np.ndarray, np.ndarray]] = None
        t._error: Optional[BaseException] = None
        t._submitted = time.perf_counter()
        t._deadline = (None if deadline_s is None
                       else t._submitted + deadline_s)
        t.tenant = tenant
        return t

    # ----------------------------------------------------------- client side
    def done(self) -> bool:
        """True once the request is answered (successfully or not)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until answered; return ``(dists, ids)`` or raise the
        request's error.  ``timeout`` (seconds) bounds the wait itself
        and raises a plain :class:`TimeoutError` -- distinct from
        :class:`DeadlineExceeded`, which means the *request* expired.

        The engine keeps an answered ticket for the deprecated
        ``Engine.result(ticket)`` until one of the two reads it."""
        if not self._event.is_set():
            self._resolver._realise(self, timeout)
        if not self._event.is_set():
            raise TimeoutError(
                f"request {int(self)} still unanswered after {timeout}s "
                f"(the request itself is still in flight)")
        self._resolver._forget(self)
        if self._error is not None:
            raise self._error
        return self._value

    # ------------------------------------------------------------ pump side
    def expired(self, now: Optional[float] = None) -> bool:
        if self._deadline is None:
            return False
        return (now if now is not None else time.perf_counter()) \
            > self._deadline

    def _resolve(self, dists: np.ndarray, ids: np.ndarray) -> None:
        self._value = (dists, ids)
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def _time_out(self) -> None:
        waited = (time.perf_counter() - self._submitted) * 1e3
        budget = (self._deadline - self._submitted) * 1e3
        self._fail(DeadlineExceeded(
            f"request {int(self)} missed its {budget:.1f} ms deadline "
            f"({waited:.1f} ms elapsed before its micro-batch ran)"))


# --------------------------------------------------------------------------
# background compaction handle
# --------------------------------------------------------------------------

class Compaction:
    """Handle for one ``Engine.compact(background=True)`` run.

    ``join()`` waits for it; ``error`` is the rebuild's exception (None
    on success).  A failed background compaction never touches the
    serving state -- the rebuild is pure and the swap only happens on
    success -- so ``error`` is a report, not a recovery problem.
    """

    def __init__(self):
        self._event = threading.Event()
        self.error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def ok(self) -> bool:
        """True once finished successfully (state swapped)."""
        return self._event.is_set() and self.error is None

    def join(self, timeout: Optional[float] = None) -> "Compaction":
        """Wait for the rebuild; raises ``TimeoutError`` if it is still
        running after ``timeout`` (the rebuild itself is NOT cancelled --
        it finishes or fails under the mutation lock either way)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"background compaction still running after {timeout}s")
        return self

    def _finish(self, error: Optional[BaseException]) -> None:
        self.error = error
        self._event.set()


def ensure_servable(state: IndexState) -> IndexState:
    """An unsharded state, as it is; a sharded one (``static`` has
    ``shard_axes``) raises, since the port has no sharded states yet."""
    if state.static.get("shard_axes"):
        raise NotImplementedError(
            f"{state.algo}: sharded states (static 'shard_axes') are not "
            f"served by the port yet; sharded serving is ROADMAP.md §1 "
            f"item 6")
    return state


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

class Engine:
    """Micro-batching query server over one device-resident IndexState.

    >>> eng = Engine.build("IVF", X, metric="euclidean",
    ...                    build_params={"n_clusters": 64},
    ...                    query_params={"n_probes": 8}, k=10)
    >>> dists, ids = eng.search(Q)          # any nq; fixed-shape batches
    >>> t = eng.submit(q); dists, ids = t.result()    # request path
    >>> eng.save("/tmp/ivf.ckpt"); eng2 = Engine.load("/tmp/ivf.ckpt")
    """

    def __init__(self, state: IndexState, *, k: int = 10,
                 batch_size: int = 256,
                 query_params: Optional[Dict[str, Any]] = None,
                 traced_params: Tuple[str, ...] = ()):
        self.spec = get_functional(state.algo)
        self.state = ensure_servable(state)
        self.k = int(k)
        self.batch_size = int(batch_size)
        self.query_params = self.spec.default_query_params()
        self.query_params.update(query_params or {})
        # ``traced_params`` demotes spec-static knobs to runtime values --
        # e.g. IVF's n_probes under a pinned max_probes cap.  Knobs whose
        # static cap partner is pinned in ``query_params`` are demoted
        # automatically.
        traced = list(traced_params)
        for knob, cap in self.spec.traced_knobs:
            if knob not in traced and self.query_params.get(cap) is not None:
                traced.append(knob)
        # A traced knob whose value is None (= "no limit", e.g. IVF's
        # ``scan``) is pinned to its cap: in traced mode the two are
        # semantically identical, and the reference pins it so that one
        # trace serves later integer updates (an autotuned value); the
        # port keeps the same query_params.
        for knob, cap in self.spec.traced_knobs:
            if (knob in traced and self.query_params.get(knob) is None
                    and self.query_params.get(cap) is not None):
                self.query_params[knob] = int(self.query_params[cap])
        self.traced_params = tuple(traced)
        self._search = bind_search(self.spec.search, self.spec,
                                   traced=self.traced_params)
        self._pending: list = []    # (Ticket, query [d], key, overrides)
        self._results: Dict[int, Ticket] = {}   # legacy result() buffer
        self._next_ticket = 0
        # serialises insert/delete/compact; the serving path never takes it
        # (state swaps are a single attribute write, _run_padded reads
        # self.state exactly once per batch)
        self._mutate_lock = threading.Lock()
        # outstanding background-compaction handles
        self._compactions: list = []
        self.stats = {"queries": 0, "batches": 0, "padded": 0,
                      "device_time_s": 0.0, "inserts": 0, "deletes": 0,
                      "compactions": 0, "compaction_failures": 0}

    # ---------------------------------------------------------- constructors
    @classmethod
    def build(cls, algo: str, X, *, metric: str,
              build_params: Optional[Dict[str, Any]] = None, device=None,
              **engine_kwargs) -> "Engine":
        """Build ``algo`` over ``X`` on ``device`` (``cuda`` unless
        ``"cpu"`` is asked for) and serve it."""
        spec = get_functional(algo)
        state = spec.build(X, metric=metric, device=device,
                           **(build_params or {}))
        return cls(state, **engine_kwargs)

    @classmethod
    def from_checkpoint_entry(cls, state: IndexState, extra: dict,
                              **overrides) -> "Engine":
        """Engine from one ``checkpoint.load`` entry (state + extras)."""
        state = ensure_servable(state)
        kwargs = {"k": extra.get("k", 10),
                  "batch_size": extra.get("batch_size", 256),
                  "query_params": extra.get("query_params") or {},
                  "traced_params": tuple(extra.get("traced_params") or ())}
        kwargs.update(overrides)
        return cls(state, **kwargs)

    @classmethod
    def load(cls, path, device=None, **overrides) -> "Engine":
        """Serve a checkpoint (either package's) on ``device`` (``cuda``
        unless ``"cpu"`` is asked for)."""
        state, extra = _ckpt.load(path, device=device).only
        return cls.from_checkpoint_entry(state, extra, **overrides)

    def _ckpt_extra(self) -> dict:
        return {
            "k": self.k, "batch_size": self.batch_size,
            "query_params": {k: v for k, v in self.query_params.items()
                             if _is_plain(v)},
            "traced_params": list(self.traced_params),
        }

    def save(self, path) -> Path:
        return _ckpt.save(path, self.state, extra=self._ckpt_extra())

    # -------------------------------------------------------------- serving
    def _check_caps(self, params) -> None:
        """Reject knob values above their static cap: the capped window
        would silently clamp them, which must not masquerade as the
        requested quality setting."""
        for knob, cap in self.spec.traced_knobs:
            cap_v, knob_v = params.get(cap), params.get(knob)
            if cap_v is None or knob_v is None:
                continue
            try:
                knob_i = _as_int(knob_v)
            except (TypeError, ValueError, RuntimeError):
                continue
            if knob_i > int(cap_v):
                raise ValueError(
                    f"{knob}={knob_i} exceeds the engine's static "
                    f"{cap}={int(cap_v)} (the trace would clamp it); "
                    f"rebuild the Engine with a larger {cap}")

    def _run_padded(self, Qb, n_live: int, overrides):
        """One fixed-shape device call: Qb is already [batch_size, d].

        Returns ``(dists, ids)`` as tensors on the state's device.
        ``self.state`` is read once, so a concurrent swap is seen whole or
        not at all."""
        params = dict(self.query_params)
        params.update(overrides)
        self._check_caps(params)
        state = self.state
        t0 = time.perf_counter()
        dists, ids = self._search(state, Qb, k=self.k, **params)
        sync(ids.device)
        self.stats["device_time_s"] += time.perf_counter() - t0
        self.stats["batches"] += 1
        self.stats["queries"] += n_live
        self.stats["padded"] += Qb.shape[0] - n_live
        return dists, ids

    def _pad_batch(self, Q: np.ndarray) -> np.ndarray:
        pad = self.batch_size - Q.shape[0]
        if pad == 0:
            return Q
        return np.concatenate(
            [Q, np.zeros((pad,) + Q.shape[1:], Q.dtype)], axis=0)

    def search(self, Q, **overrides) -> Tuple[np.ndarray, np.ndarray]:
        """Answer a query set of any size via fixed-shape micro-batches.

        Returns ``(dists [nq, k], ids [nq, k])`` as numpy arrays -- the
        same order as every functional ``spec.search``.  Keyword overrides
        are per-call query params.
        """
        Q = np.asarray(Q)
        nq = Q.shape[0]
        if nq == 0:
            return (np.empty((0, self.k), np.float32),
                    np.empty((0, self.k), np.int32))
        ids_out, dists_out = [], []
        for s in range(0, nq, self.batch_size):
            blk = Q[s:s + self.batch_size]
            live = blk.shape[0]
            dists, ids = self._run_padded(self._pad_batch(blk), live,
                                          overrides)
            ids_out.append(ids[:live].cpu().numpy())
            dists_out.append(dists[:live].cpu().numpy())
        return np.concatenate(dists_out), np.concatenate(ids_out)

    # ------------------------------------------------------------- mutation
    # All three swap ``self.state`` with a single attribute write -- the
    # serving path (_run_padded) reads the attribute exactly once per
    # micro-batch, so a concurrent query sees either the old state or the
    # new one, never a mix, and no ticket is ever dropped.  Mutations
    # serialise on ``_mutate_lock``.

    def insert(self, X_new, ids=None, *, auto_compact: bool = True):
        """Append rows to a mutable index (delta-buffer write).

        Returns the assigned global ids.  With ``auto_compact`` (default)
        a full delta buffer -- or one past the state's
        ``compact_threshold`` occupancy after the insert -- triggers
        :meth:`compact` inline; with ``auto_compact=False`` a full buffer
        raises :class:`~repro_torch.mutate.DeltaFull` for the caller to
        handle (e.g. to schedule compaction off the request path).
        """
        from repro_torch import mutate

        with self._mutate_lock:
            try:
                state, new_ids = mutate.insert(self.state, X_new, ids)
            except mutate.DeltaFull:
                if not auto_compact:
                    raise
                self.state = mutate.compact(self.state)
                self.stats["compactions"] += 1
                state, new_ids = mutate.insert(self.state, X_new, ids)
            self.state = state
            self.stats["inserts"] += len(new_ids)
            if auto_compact and mutate.delta_fraction(state) \
                    >= state.stat("compact_threshold"):
                self.state = mutate.compact(self.state)
                self.stats["compactions"] += 1
        return new_ids

    def delete(self, ids) -> None:
        """Tombstone global ids (masked, not compacted)."""
        from repro_torch import mutate

        with self._mutate_lock:
            self.state = mutate.delete(self.state, ids)
            self.stats["deletes"] += int(np.asarray(ids).reshape(-1).size)

    def compact(self, *, background: bool = False,
                on_done=None) -> Optional[Compaction]:
        """Fold the delta into a fresh main index and hot-swap it in.

        In-flight and concurrently submitted requests are never dropped:
        the rebuild happens off to the side and the swap is one attribute
        write (see the section comment).

        ``background=True`` runs the rebuild on its own thread -- still
        under the mutation lock (inserts/deletes queue behind it; the
        serving path never blocks) -- and returns a :class:`Compaction`
        handle immediately.  On success the new state hot-swaps in; on
        failure (including an injected
        :class:`~repro_torch.serve.errors.CompactionError`) the serving
        state is untouched, ``stats["compaction_failures"]`` increments,
        and the error lands on the handle (and ``on_done(error)``, if
        given) -- never on the serving threads.  A foreground failure
        raises.
        """
        from repro_torch import mutate

        if not background:
            with self._mutate_lock:
                try:
                    new_state = mutate.compact(self.state)
                except BaseException:
                    self.stats["compaction_failures"] += 1
                    raise
                self.state = new_state
                self.stats["compactions"] += 1
            if on_done is not None:
                on_done(None)
            return None

        handle = Compaction()
        self._compactions.append(handle)

        def run():
            error = None
            try:
                with self._mutate_lock:
                    new_state = mutate.compact(self.state)
                    self.state = new_state
                    self.stats["compactions"] += 1
            except BaseException as e:          # noqa: BLE001
                error = e
                self.stats["compaction_failures"] += 1
            handle._finish(error)
            if on_done is not None:
                on_done(error)

        threading.Thread(target=run, name="repro-serve-compact",
                         daemon=True).start()
        return handle

    def join_compactions(self, timeout: Optional[float] = None) -> bool:
        """Drain outstanding background compactions (True if all
        finished within ``timeout``).  Finished handles are pruned."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        for handle in list(self._compactions):
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.perf_counter()))
            if not handle._event.wait(remaining):
                return False
        self._compactions = [h for h in self._compactions if not h.done()]
        return True

    # ------------------------------------------------------- request stream
    def submit(self, q, *, deadline_ms: Optional[float] = None,
               **overrides) -> Ticket:
        """Queue one query; returns a :class:`Ticket` future.

        ``ticket.result()`` blocks until the answer is ready (flushing the
        queue if needed); a full batch flushes immediately.  Keyword
        overrides are per-request query params (e.g. a traced
        ``n_probes``): requests sharing the same overrides are answered in
        the same micro-batch.  ``deadline_ms`` bounds staleness: if the
        deadline passes before the request's micro-batch runs, the ticket
        resolves to :class:`DeadlineExceeded` instead of a late answer --
        and the rest of its batch is answered normally.
        """
        # Validate caps HERE, before anything is queued: a bad override
        # must fail its own submit(), never a later flush() that would
        # jeopardise other clients' queued tickets.
        merged = dict(self.query_params)
        merged.update(overrides)
        self._check_caps(merged)
        ticket = Ticket(self._next_ticket, self,
                        deadline_s=None if deadline_ms is None
                        else deadline_ms / 1e3)
        self._next_ticket += 1
        self._pending.append((ticket, np.asarray(q),
                              _override_key(overrides), overrides))
        if len(self._pending) >= self.batch_size:
            self.flush()
        return ticket

    def flush(self) -> None:
        """Answer every pending query in fixed-shape micro-batches,
        grouped by per-request overrides (submission order within each
        group is preserved).  Deadline-expired requests are answered as
        :class:`DeadlineExceeded` without riding in (or delaying) the
        batch.  Requests leave the queue only once their micro-batch
        succeeds, so a failure leaves the rest pending."""
        while self._pending:
            key0 = self._pending[0][2]
            chunk, rest = [], []
            for item in self._pending:
                if item[2] == key0 and len(chunk) < self.batch_size:
                    chunk.append(item)
                else:
                    rest.append(item)
            now = time.perf_counter()
            live_items = []
            for item in chunk:
                if item[0].expired(now):
                    item[0]._time_out()
                    self._results[int(item[0])] = item[0]
                else:
                    live_items.append(item)
            if not live_items:
                self._pending = rest
                continue
            Qb = np.stack([q for _, q, _, _ in live_items])
            live = Qb.shape[0]
            dists, ids = self._run_padded(self._pad_batch(Qb), live,
                                          live_items[0][3])
            self._pending = rest
            ids = ids.cpu().numpy()
            dists = dists.cpu().numpy()
            for i, (ticket, _, _, _) in enumerate(live_items):
                ticket._resolve(dists[i], ids[i])
                self._results[int(ticket)] = ticket

    def _realise(self, ticket: Ticket, timeout) -> None:
        """Ticket.result() hook: the sync engine answers its own queue."""
        self.flush()

    def _forget(self, ticket: Ticket) -> None:
        """Ticket.result() hook: the caller has its answer, so the
        legacy buffer lets the ticket go."""
        self._results.pop(int(ticket), None)

    def result(self, ticket) -> Tuple[np.ndarray, np.ndarray]:
        """(deprecated) ``(dists, ids)`` for a flushed ticket (pops it).

        The older redemption path, kept so bare-int call sites keep
        working.  New code holds the :class:`Ticket` from ``submit()`` and
        calls ``ticket.result()``.
        """
        warnings.warn("Engine.result(ticket) is deprecated; call "
                      "ticket.result() on the Ticket submit() returned",
                      DeprecationWarning, stacklevel=2)
        if int(ticket) not in self._results:
            raise KeyError(f"ticket {int(ticket)} not flushed "
                           f"(or already read)")
        t = self._results.pop(int(ticket))
        if t._error is not None:
            raise t._error
        return t._value

    # ------------------------------------------------------------ autotuning
    def autotune(self, Q, gt_distances, *, knob_grid,
                 constraint, repetitions: int = 3):
        """Pick this engine's knob defaults from the constrained tuner.

        Runs :func:`repro_torch.tune.grid_search` over ``knob_grid`` on the
        engine's own index state and, if a grid point satisfies the
        ``constraint`` (e.g. ``tune.Constraint.min_recall(0.9)``), adopts
        its knob values as the engine's ``query_params`` -- all subsequent
        ``search()``/``submit()`` traffic serves at that operating point.

        Every swept knob must be traced-capable.  If its static ``max_*``
        cap is below the grid maximum (or unset), the cap is raised to the
        grid maximum and the knob becomes traced.

        Returns the full :class:`repro_torch.tune.TuneResult` (grid,
        Pareto set, chosen point); an infeasible constraint leaves the
        engine's ``query_params`` untouched (``result.best is None``).
        """
        from repro_torch.tune import grid_search

        caps = dict(self.spec.traced_knobs)
        saved = (dict(self.query_params), self.traced_params, self._search)
        retrace_needed = False
        for knob, values in knob_grid.items():
            cap = caps.get(knob)
            if cap is None:
                raise ValueError(
                    f"{self.state.algo}: knob {knob!r} has no traced-cap "
                    f"treatment; tunable knobs: {sorted(caps)}")
            need = max(int(v) for v in values)
            have = self.query_params.get(cap)
            if have is None or int(have) < need:
                self.query_params[cap] = need
                retrace_needed = True
        traced = tuple(dict.fromkeys(
            list(self.traced_params) + list(knob_grid)))
        if retrace_needed or traced != self.traced_params:
            self.traced_params = traced
            self._search = bind_search(self.spec.search, self.spec,
                                       traced=traced)
        fixed = {name: v for name, v in self.query_params.items()
                 if name not in knob_grid}
        result = grid_search(self.state, Q, gt_distances, k=self.k,
                             knob_grid=knob_grid, constraint=constraint,
                             repetitions=repetitions, query_params=fixed)
        if result.best is None:
            # infeasible: restore EVERYTHING -- a raised cap (e.g. a fresh
            # max_scan) silently changes serving behaviour for knobs whose
            # value means "no limit", and the promise is untouched serving
            self.query_params, self.traced_params, self._search = saved
        else:
            self.query_params.update(result.best_params())
        return result

    # ------------------------------------------------------------- metadata
    @property
    def qps(self) -> float:
        t = self.stats["device_time_s"]
        return self.stats["queries"] / t if t > 0 else float("nan")

    def index_size_kb(self) -> float:
        return self.state.nbytes() / 1024.0

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Engine({self.state.algo}, k={self.k}, "
                f"batch={self.batch_size}, params={self.query_params})")


def _is_plain(v) -> bool:
    """query params that survive a JSON round-trip (tensors do not)."""
    return isinstance(v, (int, float, str, bool, type(None), tuple, list))


def _as_int(v) -> int:
    """A knob value (int, numpy scalar or 0-d tensor) as a python int."""
    if torch.is_tensor(v):
        return int(v.item())
    return int(np.asarray(v))


def _override_key(overrides: Dict[str, Any]) -> tuple:
    """Hashable grouping key for per-request overrides (scalar arrays and
    0-d tensors collapse to their python value, so torch.tensor(8) == 8)."""
    def norm(v):
        if torch.is_tensor(v):
            return v.item() if v.ndim == 0 else repr(v)
        if np.ndim(v) == 0 and not isinstance(v, (str, bytes)):
            try:
                return np.asarray(v).item()
            except (TypeError, ValueError):
                pass
        return repr(v)
    return tuple(sorted((name, norm(v)) for name, v in overrides.items()))
