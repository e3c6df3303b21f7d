"""SLO-aware async serving tier: a background pump over resident Engines
(``repro.serve.async_engine``).

The synchronous :class:`~repro_torch.serve.engine.Engine` batches well but
has no latency story: ``submit()`` queues and *somebody* must ``flush()``.
This module adds the production-shaped front end the open-stream workload
needs -- one process, one pump thread, many resident indexes:

    client threads --submit()-->  bounded queue  -->  pump thread
         ^                        (admission ctl)      | groups by
         | Ticket.result()                             | (tenant, overrides)
         +---------- tickets resolved <-- micro-batch -+ one padded shape
                     (or DeadlineExceeded)               per tenant

  * **timeout-based flush** -- the pump fires a micro-batch on whichever
    comes first of ``max_batch`` queued requests or the oldest request
    having waited ``max_wait_ms``; latency is bounded by design, not by
    caller discipline.
  * **per-request deadlines** -- an admitted request whose deadline passes
    before its batch runs is answered as
    :class:`~repro_torch.serve.errors.DeadlineExceeded` (swept out
    *without* delaying or poisoning the batch its group rides in).
  * **admission control** -- the queue is bounded (``max_queue``); at
    capacity ``submit()`` raises
    :class:`~repro_torch.serve.errors.AdmissionError` immediately.
    Overload sheds load at the door instead of growing an unbounded queue
    in which every deadline dies.
  * **multi-tenant serving** -- several resident
    :class:`~repro_torch.ann.functional.IndexState`\\ s (datasets /
    quality tiers) behind one pump: ``submit(q, tenant="west")`` routes to
    that tenant's Engine.  One archive checkpoints all of them
    (:mod:`repro_torch.serve.checkpoint`).
  * **latency accounting** -- every request's submit-to-answer latency
    lands in a :class:`~repro_torch.serve.metrics.ServeMetrics` histogram
    (p50/p95/p99 per tenant and overall), the numbers the reference's
    ``benchmarks/bench_serving.py`` gates.
  * **fault tolerance** -- transient faults retry with exponential backoff
    and deterministic jitter (:class:`~repro_torch.serve.retry.RetryPolicy`),
    and a pump supervisor fails every outstanding ticket with
    :class:`~repro_torch.serve.errors.EngineDegraded` if the pump thread
    ever dies, so ``ticket.result()`` can never hang on a dead pump.

The reference traces each tenant's search once (one ``jit`` trace per
tenant at its padded shape).  The port has no ``jit``: what stays is the
shape, since every device call of a tenant runs at ``[batch_size, d]``
(``Engine._pad_batch``), whatever the request mix, overrides included.

The pump is a plain daemon thread that runs torch on the tenant state's
device (made current in that thread for each batch).  Each micro-batch's
answers are copied to the host once, on the pump thread
(``.cpu().numpy()``, which waits for the device); tickets resolve with
numpy rows, as in the reference.  A device error (a CUDA fault included)
fails that batch's tickets and counts as ``failed``; it is never swallowed.

A sharded tenant's micro-batch may come back degraded (the fault layer
masked some shards): its tickets resolve with ``coverage < 1``
(``ticket.partial``), the pump counts them as ``degraded``, and every
served request's coverage goes into the metrics' coverage histogram.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.ann.functional import IndexState
from repro_torch.serve import checkpoint as _ckpt
from repro_torch.serve import faults as _faults
from repro_torch.serve.engine import Engine, Ticket, _override_key
from repro_torch.serve.errors import (AdmissionError, EngineClosed,
                                      EngineDegraded, RetriesExhausted)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.retry import RetryPolicy

#: tenant name used when an AsyncEngine wraps a single Engine.
DEFAULT_TENANT = "default"


class _Request:
    __slots__ = ("ticket", "q", "tenant", "key", "overrides")

    def __init__(self, ticket: Ticket, q: np.ndarray, tenant: str,
                 key: tuple, overrides: dict):
        self.ticket = ticket
        self.q = q
        self.tenant = tenant
        self.key = key
        self.overrides = overrides


def _cuda_device(state: IndexState) -> Optional[torch.device]:
    """The CUDA device a state's tensors live on (a mutable state's inner
    index included), or None for a state on the CPU."""
    for a in state.arrays.values():
        if isinstance(a, IndexState):
            dev = _cuda_device(a)
            if dev is not None:
                return dev
            continue
        for leaf in (a if isinstance(a, (tuple, list)) else (a,)):
            if torch.is_tensor(leaf) and leaf.is_cuda:
                return leaf.device
    return None


def _on_device(state: IndexState):
    """Make the state's device current on this thread (a plain thread
    starts on device 0)."""
    dev = _cuda_device(state)
    return torch.cuda.device(dev) if dev is not None \
        else contextlib.nullcontext()


class AsyncEngine:
    """Background micro-batch pump over one or more resident Engines.

    >>> eng = Engine.build("IVF", X, metric="euclidean",
    ...                    build_params={"n_clusters": 64},
    ...                    query_params={"n_probes": 8}, k=10)
    >>> with AsyncEngine(eng, max_wait_ms=5, max_queue=1024) as srv:
    ...     t = srv.submit(q, deadline_ms=50)
    ...     dists, ids = t.result()
    ...     srv.metrics.percentile(95)        # seconds, includes queueing

    ``engines`` is one :class:`Engine` or a mapping ``tenant -> Engine``;
    requests route by the ``tenant=`` keyword of :meth:`submit`.  The
    pump starts immediately and runs until :meth:`close` (or context
    exit), which stops admission and DRAINS: every already-admitted
    ticket is answered (or deadline-timed-out) before the pump exits.
    """

    def __init__(self, engines: Union[Engine, Mapping[str, Engine]], *,
                 max_wait_ms: float = 5.0,
                 max_batch: Optional[int] = None,
                 max_queue: int = 1024,
                 default_deadline_ms: Optional[float] = None,
                 metrics: Optional[ServeMetrics] = None,
                 retry: Optional[RetryPolicy] = None):
        if isinstance(engines, Engine):
            engines = {DEFAULT_TENANT: engines}
        self.engines: Dict[str, Engine] = dict(engines)
        if not self.engines:
            raise ValueError("AsyncEngine needs at least one resident "
                             "Engine (got an empty mapping)")
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        # flush threshold per tenant: the tenant's fixed micro-batch shape
        # caps it (a bigger batch can't ride one device call anyway)
        self._flush_at = {
            t: min(int(max_batch), e.batch_size) if max_batch else
            e.batch_size for t, e in self.engines.items()}
        self.default_deadline_s = (None if default_deadline_ms is None
                                   else float(default_deadline_ms) / 1e3)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # transient faults retry under this policy;
        # RetryPolicy(max_attempts=1) disables retrying
        self.retry = retry if retry is not None else RetryPolicy()
        self.last_service_s = 0.0     # most recent micro-batch device+host
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._degraded: Optional[BaseException] = None
        # the batch the pump popped but has not resolved yet -- only the
        # pump thread touches it, and the supervisor (which also runs on
        # the pump thread, as its last act) fails it on pump death so no
        # admitted ticket can ever be left hanging
        self._inflight: list = []
        # the earliest deadline among queued requests (None: none has
        # one), so that the pump's readiness test and its wake-up time
        # cost O(1) per wake instead of a pass over the queue
        self._earliest: Optional[float] = None
        self._seq = 0
        self._pump = threading.Thread(target=self._pump_main,
                                      name="repro-serve-pump", daemon=True)
        self._pump.start()

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "AsyncEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop admitting requests and drain the queue.

        Every ticket admitted before close() is resolved -- answered, or
        :class:`DeadlineExceeded` if its deadline lapses during the drain
        -- before the pump thread exits.  Any in-flight background
        compactions are joined too, so no daemon rebuild thread outlives
        the tier.  Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._pump.join(timeout)
        for eng in self.engines.values():
            eng.join_compactions(timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    def qsize(self) -> int:
        """Current queue depth (admitted, not yet batched)."""
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------- tenants
    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(sorted(self.engines))

    def _resolve_tenant(self, tenant: Optional[str]) -> str:
        if tenant is None:
            if len(self.engines) == 1:
                return next(iter(self.engines))
            raise ValueError(
                f"this AsyncEngine serves {len(self.engines)} tenants "
                f"{self.tenants}; pass tenant=")
        if tenant not in self.engines:
            raise ValueError(f"unknown tenant {tenant!r}; resident: "
                             f"{self.tenants}")
        return tenant

    # ------------------------------------------------------------ submission
    def submit(self, q, *, tenant: Optional[str] = None,
               deadline_ms: Optional[float] = None, **overrides) -> Ticket:
        """Admit one query; returns a :class:`Ticket` future.

        Raises :class:`AdmissionError` when the queue is at ``max_queue``
        (the request is NOT queued), :class:`EngineClosed` after
        :meth:`close`, and ``ValueError`` for unknown tenants or knob
        overrides above their static cap -- all *before* anything is
        admitted, so a bad request can never poison queued ones.
        """
        name = self._resolve_tenant(tenant)
        eng = self.engines[name]
        merged = dict(eng.query_params)
        merged.update(overrides)
        eng._check_caps(merged)
        deadline_s = (self.default_deadline_s if deadline_ms is None
                      else deadline_ms / 1e3)
        q = np.asarray(q)
        with self._cond:
            if self._degraded is not None:
                raise EngineDegraded(
                    "the pump thread died "
                    f"({type(self._degraded).__name__}: {self._degraded}); "
                    "this AsyncEngine no longer serves — rebuild it "
                    "(outstanding tickets were failed, not hung)"
                ) from self._degraded
            if self._closed:
                raise EngineClosed("submit() after close(); the pump no "
                                   "longer admits requests")
            if len(self._queue) >= self.max_queue:
                self.metrics.count("rejected", tenant=name)
                raise AdmissionError(
                    f"queue depth {self.max_queue} reached "
                    f"(tenant {name!r}); the request was rejected, not "
                    f"queued — retry with backoff or raise max_queue")
            ticket = Ticket(self._seq, self, deadline_s=deadline_s,
                            tenant=name)
            self._seq += 1
            self._queue.append(_Request(ticket, q, name,
                                        _override_key(overrides), overrides))
            self.metrics.count("submitted", tenant=name)
            # wake the pump only where this request changes what it waits
            # for: a new head (a new flush time), a full batch, or an
            # earlier deadline; otherwise its timed wait is still right
            wake = len(self._queue) == 1 or len(self._queue) \
                >= self._flush_at[self._queue[0].tenant]
            d = ticket._deadline
            if d is not None and (self._earliest is None
                                  or d < self._earliest):
                self._earliest = d
                wake = True
            if wake:
                self._cond.notify()
        return ticket

    def search(self, Q, *, tenant: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               timeout: Optional[float] = 60.0,
               **overrides) -> Tuple[np.ndarray, np.ndarray]:
        """Convenience closed-loop path: submit every row of ``Q`` and
        gather ``(dists [nq, k], ids [nq, k])``.  Mostly for parity tests
        and warmup -- an open-loop client holds the Tickets itself.
        (``nq`` must fit the admission bound; rows past ``max_queue``
        would be rejected.)"""
        tickets = [self.submit(q, tenant=tenant, deadline_ms=deadline_ms,
                               **overrides) for q in np.asarray(Q)]
        pairs = [t.result(timeout=timeout) for t in tickets]
        return (np.stack([d for d, _ in pairs]),
                np.stack([i for _, i in pairs]))

    def _realise(self, ticket: Ticket, timeout) -> None:
        """Ticket.result() hook: wait for the pump (never run its work
        on the client thread -- ordering belongs to the pump)."""
        ticket._event.wait(timeout)

    def _forget(self, ticket: Ticket) -> None:
        """Ticket.result() hook: the pump keeps no answered tickets."""

    # ------------------------------------------------------------ pump loop
    def _due_locked(self, now: float) -> bool:
        if not self._queue:
            return False
        head = self._queue[0]
        if len(self._queue) >= self._flush_at[head.tenant]:
            return True
        if now - head.ticket._submitted >= self.max_wait_s:
            return True
        # some queued request has expired
        return self._earliest is not None and now > self._earliest

    def _wake_in_locked(self, now: float) -> Optional[float]:
        """Seconds until the next flush/expiry is due (None: idle)."""
        if not self._queue:
            return None
        due = self._queue[0].ticket._submitted + self.max_wait_s
        if self._earliest is not None and self._earliest < due:
            due = self._earliest
        return max(due - now, 1e-4)

    def _set_earliest_locked(self) -> None:
        deadlines = [r.ticket._deadline for r in self._queue
                     if r.ticket._deadline is not None]
        self._earliest = min(deadlines) if deadlines else None

    def _pop_expired_locked(self, now: float) -> list:
        if self._earliest is None or now <= self._earliest:
            return []
        expired, keep = [], deque()
        for r in self._queue:
            (expired if r.ticket.expired(now) else keep).append(r)
        self._queue = keep
        self._set_earliest_locked()
        return expired

    def _pop_batch_locked(self) -> list:
        """Oldest request's (tenant, overrides) group, up to its flush
        threshold, submission order preserved; the rest stay queued."""
        head = self._queue[0]
        cap = self._flush_at[head.tenant]
        take, keep = [], deque()
        for r in self._queue:
            if (len(take) < cap and r.tenant == head.tenant
                    and r.key == head.key):
                take.append(r)
            else:
                keep.append(r)
        self._queue = keep
        self._set_earliest_locked()
        return take

    def _pump_main(self) -> None:
        """Pump thread entry: supervise :meth:`_pump_loop`.

        If the loop ever escapes with an exception (a bug, or an injected
        :class:`~repro_torch.serve.faults.PumpFault`), the tier must not
        hang every outstanding ``ticket.result()`` forever -- the
        supervisor marks the engine degraded and fails every
        admitted-but-unresolved ticket with :class:`EngineDegraded` before
        the thread exits."""
        try:
            self._pump_loop()
        except BaseException as e:                  # noqa: BLE001
            self._mark_degraded(e)

    def _mark_degraded(self, cause: BaseException) -> None:
        """Fail every outstanding ticket and refuse future admission.

        Runs on the (dying) pump thread, so ``_inflight`` -- touched only
        by the pump -- needs no lock; the queue sweep happens under
        ``_cond`` so no concurrent ``submit()`` can slip a ticket in
        between the sweep and the degraded flag."""
        with self._cond:
            self._degraded = cause
            queued = list(self._queue)
            self._queue = deque()
            self._earliest = None
            self._cond.notify_all()
        victims = self._inflight + queued
        self._inflight = []
        err = EngineDegraded(
            f"pump thread died: {type(cause).__name__}: {cause}")
        err.__cause__ = cause
        for r in victims:
            if not r.ticket.done():
                r.ticket._fail(err)
                self.metrics.count("failed", tenant=r.tenant)

    def _pump_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed \
                        and not self._due_locked(time.perf_counter()):
                    self._cond.wait(
                        timeout=self._wake_in_locked(time.perf_counter()))
                now = time.perf_counter()
                expired = self._pop_expired_locked(now)
                batch = self._pop_batch_locked() if self._queue else []
                done = self._closed and not self._queue \
                    and not batch and not expired
            for r in expired:
                r.ticket._time_out()
                self.metrics.count("timed_out", tenant=r.tenant)
            if batch:
                self._inflight = batch
                # deliberately OUTSIDE _serve's try: an injected pump
                # death must kill the loop (exercising the supervisor),
                # not be absorbed as a per-batch failure
                _faults.pump_tick()
                self._serve(batch)
                self._inflight = []
            if done:
                return

    def _retry_viable(self, live: list, delay_s: float,
                      now: float) -> bool:
        """Another attempt is worth it only if some live ticket could
        still meet its deadline after sleeping ``delay_s``."""
        return any(r.ticket._deadline is None
                   or r.ticket._deadline > now + delay_s for r in live)

    def _serve(self, batch: list) -> None:
        """One micro-batch through the tenant's fixed padded shape.

        Transient faults (:class:`~repro_torch.serve.errors.TransientFault`)
        retry under ``self.retry`` with exponential backoff and
        deterministic jitter, but only while some live ticket's deadline
        can still be met; exhausted budgets fail the batch's tickets with
        :class:`RetriesExhausted`."""
        eng = self.engines[batch[0].tenant]
        t0 = time.perf_counter()
        # re-check deadlines at service time (they may have lapsed between
        # the readiness check and here); expired requests are answered as
        # timeouts and the batch shrinks around them -- never poisoned
        live = []
        for r in batch:
            if r.ticket.expired(t0):
                r.ticket._time_out()
                self.metrics.count("timed_out", tenant=r.tenant)
            else:
                live.append(r)
        if not live:
            return
        tenant = live[0].tenant
        token = int(live[0].ticket)   # keys the deterministic jitter
        n = len(live)
        attempt = 0
        while True:
            attempt += 1
            try:
                Qb = np.stack([r.q for r in live])
                with _on_device(eng.state):
                    dists, ids, coverage = eng._run_padded(
                        eng._pad_batch(Qb), n, live[0].overrides)
                    # the one host copy of the micro-batch (waits for it)
                    dists = dists[:n].cpu().numpy()
                    ids = ids[:n].cpu().numpy()
                break
            except Exception as e:                  # noqa: BLE001
                if self.retry.retryable(e) \
                        and attempt < self.retry.max_attempts:
                    delay = self.retry.backoff_s(attempt, token=token)
                    if self._retry_viable(live, delay,
                                          time.perf_counter()):
                        self.metrics.count("retried", tenant=tenant)
                        time.sleep(delay)
                        continue
                    cause = e
                    e = RetriesExhausted(
                        f"attempt {attempt}/{self.retry.max_attempts} "
                        f"failed ({type(cause).__name__}: {cause}) and no "
                        f"live deadline survives the {delay * 1e3:.2f} ms "
                        f"backoff")
                    e.__cause__ = cause
                elif self.retry.retryable(e):
                    cause = e
                    e = RetriesExhausted(
                        f"all {self.retry.max_attempts} attempts failed; "
                        f"last: {type(cause).__name__}: {cause}")
                    e.__cause__ = cause
                # the pump must survive a poisoned batch (e.g. a bad query
                # vector): fail ITS tickets, keep serving everyone else
                for r in live:
                    r.ticket._fail(e)
                    self.metrics.count("failed", tenant=r.tenant)
                return
        done = time.perf_counter()
        self.last_service_s = done - t0
        # the batch's accounting in a few locked updates, before its
        # tickets resolve (a reader woken by its ticket sees it counted)
        metrics = self.metrics
        metrics.count("batches", tenant=tenant)
        metrics.count("padded", eng.batch_size - n, tenant=tenant)
        metrics.count("served", n, tenant=tenant)
        metrics.observe_many([done - r.ticket._submitted for r in live],
                             tenant=tenant)
        if coverage < 1.0:
            metrics.count("degraded", n, tenant=tenant)
        metrics.observe_coverage(coverage, tenant=tenant, n=n)
        for i, r in enumerate(live):
            r.ticket._resolve(dists[i], ids[i], coverage=coverage)

    # ------------------------------------------------------------- mutation
    # Thin passthroughs to the tenant Engine's mutation surface.  They are
    # pump-safe by construction: Engine mutations swap ``eng.state`` with
    # one attribute write and ``_serve`` reads it exactly once per
    # micro-batch (via ``eng._run_padded``), so a compaction racing the
    # pump resolves every admitted ticket against either the old or the
    # new state -- never an error, never a dropped ticket.

    def insert(self, X_new, ids=None, *, tenant: Optional[str] = None,
               **kwargs):
        """Append rows to a tenant's mutable index (delta-buffer write)."""
        return self.engines[self._resolve_tenant(tenant)].insert(
            X_new, ids, **kwargs)

    def delete(self, ids, *, tenant: Optional[str] = None) -> None:
        """Tombstone global ids on a tenant's mutable index."""
        self.engines[self._resolve_tenant(tenant)].delete(ids)

    def compact(self, *, tenant: Optional[str] = None,
                background: bool = False):
        """Compact a tenant's mutable index and hot-swap it under the
        pump without dropping in-flight tickets.

        ``background=True`` runs the rebuild on a worker thread and
        returns a :class:`~repro_torch.serve.engine.Compaction` handle
        immediately -- serving continues off the OLD state until the
        hot-swap; a failed rebuild leaves serving untouched and lands in
        ``metrics`` as ``compaction_failed``."""
        name = self._resolve_tenant(tenant)

        def on_done(error):
            self.metrics.count(
                "compaction_failed" if error is not None else "compactions",
                tenant=name)

        try:
            return self.engines[name].compact(background=background,
                                              on_done=on_done)
        except Exception as e:
            # foreground failure raises before Engine calls on_done
            on_done(e)
            raise

    # ---------------------------------------------------------- checkpoints
    def save(self, path):
        """Checkpoint ALL resident tenants into one archive file."""
        return _ckpt.save(path, {t: (e.state, e._ckpt_extra())
                                 for t, e in self.engines.items()})

    @classmethod
    def load(cls, path, *, device=None,
             engine_overrides: Optional[dict] = None,
             **pump_kwargs) -> "AsyncEngine":
        """Restore a multi-tenant archive (or a single-state checkpoint,
        which loads as tenant ``"default"``) into a fresh pump, on
        ``device`` (``cuda`` unless ``"cpu"`` is asked for).
        ``engine_overrides`` are per-Engine keyword overrides (e.g.
        ``{"batch_size": 128}``) applied to every tenant."""
        contents = _ckpt.load(path, device=device)
        engines = {t: Engine.from_checkpoint_entry(
                       state, extra, **(engine_overrides or {}))
                   for t, (state, extra) in contents.items()}
        return cls(engines, **pump_kwargs)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"AsyncEngine(tenants={list(self.tenants)}, "
                f"max_wait_ms={self.max_wait_s * 1e3:g}, "
                f"max_queue={self.max_queue}, closed={self._closed})")
