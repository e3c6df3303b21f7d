"""Typed errors for the serving tier (``repro.serve.errors``).

Every failure mode a client can hit has its own type, so callers (and the
reference's load-generator gates, ``benchmarks/bench_serving.py``)
discriminate by ``except`` clause instead of string-matching messages:

  * :class:`AdmissionError` — the bounded request queue is full; the
    request was REJECTED at ``submit()`` and never queued.  Load shedding
    is explicit: under overload the serving tier answers "no" immediately
    rather than queueing unboundedly and missing every deadline.
  * :class:`DeadlineExceeded` — the request WAS admitted but its
    per-request deadline expired before (or while) its micro-batch ran;
    ``ticket.result()`` raises this instead of returning stale answers.
    Subclasses :class:`TimeoutError` so generic timeout handling works.
  * :class:`EngineClosed` — ``submit()`` after the pump was shut down.
  * :class:`EngineDegraded` — the pump thread died; its supervisor failed
    every outstanding ticket with this (so ``ticket.result()`` can never
    hang on a dead pump) and ``submit()`` refuses new work.
  * :class:`TransientFault` / :class:`ShardFault` — retryable failures;
    the pump's ``RetryPolicy`` (``repro.serve.retry``) retries these with
    backoff before they surface.
  * :class:`RetriesExhausted` — a transient fault outlived the retry
    budget (attempts, or every live deadline); wraps the last cause.
  * :class:`CompactionError` — a compaction rebuild failed (including an
    injected fault); the serving state is guaranteed untouched.

:class:`~repro_torch.serve.checkpoint.CheckpointError` lives with the
checkpoint code; it is re-exported from :mod:`repro_torch.serve` alongside
these.  The whole tree is here, the async pump's errors (admission,
closed, degraded, retries) included; the port's ``AsyncEngine`` and
``RetryPolicy`` are not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class for serving-tier request failures."""


class AdmissionError(ServeError):
    """Request rejected at submit(): the bounded queue is at capacity."""


class DeadlineExceeded(ServeError, TimeoutError):
    """Request admitted but its deadline expired before it was answered."""


class EngineClosed(ServeError):
    """Request submitted to a pump that has been shut down."""


class EngineDegraded(ServeError):
    """The pump thread died: outstanding tickets were failed with this
    and ``submit()`` refuses new requests — build a fresh AsyncEngine
    (the resident Engines and their states are still intact)."""


class TransientFault(ServeError):
    """A retryable serving failure (the fault may pass on a retry).

    The async pump retries these under its ``RetryPolicy``; only an
    exhausted budget surfaces, as :class:`RetriesExhausted`."""


class ShardFault(TransientFault):
    """A sharded search attempt failed outright (e.g. an injected shard
    crash before dispatch) — transient, distinct from graceful
    degradation where the merge proceeds over the surviving shards."""


class RetriesExhausted(ServeError):
    """A transient fault persisted past the retry budget (max attempts,
    or no live request deadline could absorb another backoff)."""


class CompactionError(ServeError):
    """A compaction rebuild failed; the pre-compaction serving state is
    untouched (the rebuild is pure — nothing swaps until it succeeds)."""
