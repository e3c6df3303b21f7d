"""Deterministic fault injection for the serving stack
(``repro.serve.faults``).

The ANN-Benchmarks harness isolates every algorithm run so a crash can
never take down the tool; this module is the serving tier's equivalent
discipline made testable: every failure mode the stack must survive can
be *scheduled* — deterministically, from a seed — and driven through the
same production code paths a real fault would take.  No monkeypatching:
the production modules call the site hooks below explicitly, and every
hook is a no-op unless a :class:`FaultPlan` is installed.

Fault kinds and their hook sites:

  ==============  ====================================================
  ``shard_drop``  ``dist/shard_state.sharded_search`` (direct calls) and
                  ``serve.Engine._run_padded`` (the serving path):
                  per (call, shard) — the shard's local results are
                  masked to the merge tree's existing ``(+inf, -1)``
                  sentinel channel, so the merge stays exact over the
                  survivors and the response is *degraded* (``partial``
                  with ``coverage < 1``), never failed.
  ``shard_raise`` same sites, per call — the whole sharded search raises
                  :class:`~repro_torch.serve.errors.ShardFault` (transient;
                  the pump's RetryPolicy retries it).
  ``slow_shard``  same sites, per call — a host-side latency spike of
                  ``slow_ms`` before dispatch (creates deadline
                  pressure; the SPMD dispatch is synchronous, so one
                  slow shard slows its whole call).
  ``pump_death``  ``AsyncEngine`` pump loop, per served batch — raises
                  :class:`PumpFault` *outside* the per-batch handler,
                  simulating a bug escaping into the pump thread; the
                  supervisor must fail all outstanding tickets with
                  ``EngineDegraded`` instead of hanging them.
  ``compact_fault``  ``mutate/delta.compact``, per compaction — the
                  rebuild raises
                  :class:`~repro_torch.serve.errors.CompactionError` before
                  any new state exists (serving state untouched).
  ``ckpt_truncate``  ``serve/checkpoint.save``, per save — the written
                  file is truncated to ``truncate_frac`` of its bytes,
                  so the *load* hardening (typed ``CheckpointError``)
                  is exercised end to end.
  ==============  ====================================================

In the port, ``compaction_attempt`` (``mutate.delta.compact``) and
``checkpoint_keep_bytes`` (``serve.checkpoint.save``) have their callers.
The shard and pump hooks (``shard_events``, ``pump_tick``) are the same
schedule logic, but nothing calls them until the port has sharded states
and the async pump (ROADMAP.md §1, items 5 and 6).

Determinism: each site keeps an event counter, and the decision for
event ``n`` is a pure function of ``(seed, site, n[, shard])`` via a
counter-keyed PRNG — a plan replays identically given the same event
order (single pump thread + one client loop, the chaos-bench shape).
Tests that need exact placement use the explicit ``*_at=`` event-index
tuples instead of rates.

Install a plan process-wide with :func:`install`/:func:`clear`, or scope
it with the :func:`injected` context manager::

    with faults.injected(faults.FaultPlan(seed=7, shard_drop=0.1)):
        srv.submit(q).result()          # may come back partial

``FaultPlan.from_spec("seed=7,shard_drop=0.1,slow_ms=5")`` parses the
CLI/bench form (``--faults`` in the reference's ``repro.launch.serve``).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np

from repro_torch.serve.errors import CompactionError, ShardFault

#: hook sites, in the order their codes key the per-event PRNG.
SITES = ("shard_drop", "shard_raise", "slow_shard", "pump_death",
         "compact_fault", "ckpt_truncate")
_SITE_CODE = {s: i for i, s in enumerate(SITES)}

_RATES = ("shard_drop", "shard_raise", "slow_shard", "pump_death",
          "compact_fault", "ckpt_truncate")


class PumpFault(RuntimeError):
    """Injected pump-thread crash — deliberately NOT a ServeError: it
    models an unexpected bug escaping the per-batch handler, and the
    supervisor is what must translate it into typed ticket failures."""


class FaultPlan:
    """One seeded, deterministic schedule of injected faults.

    Rate knobs (``shard_drop=0.1`` …) are per-event probabilities in
    ``[0, 1]``; the ``*_at=`` tuples pin faults to exact event indices
    (``shard_drop_at`` takes ``(event, shard)`` pairs).  A plan is
    reusable but stateful (event counters) — build a fresh one per run
    for reproducible schedules.
    """

    def __init__(self, seed: int = 0, *,
                 shard_drop: float = 0.0,
                 shard_raise: float = 0.0,
                 slow_shard: float = 0.0,
                 slow_ms: float = 20.0,
                 pump_death: float = 0.0,
                 compact_fault: float = 0.0,
                 ckpt_truncate: float = 0.0,
                 truncate_frac: float = 0.5,
                 shard_drop_at: Tuple[Tuple[int, int], ...] = (),
                 shard_raise_at: Tuple[int, ...] = (),
                 slow_shard_at: Tuple[int, ...] = (),
                 pump_death_at: Tuple[int, ...] = (),
                 compact_fault_at: Tuple[int, ...] = (),
                 ckpt_truncate_at: Tuple[int, ...] = ()):
        self.seed = int(seed)
        self.shard_drop = float(shard_drop)
        self.shard_raise = float(shard_raise)
        self.slow_shard = float(slow_shard)
        self.slow_ms = float(slow_ms)
        self.pump_death = float(pump_death)
        self.compact_fault = float(compact_fault)
        self.ckpt_truncate = float(ckpt_truncate)
        self.truncate_frac = float(truncate_frac)
        for name in _RATES:
            rate = getattr(self, name)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name}={rate} is not a rate in [0, 1]")
        if not 0.0 < self.truncate_frac < 1.0:
            raise ValueError(f"truncate_frac={truncate_frac} must be in "
                             f"(0, 1) — 0 keeps nothing, 1 injects nothing")
        self.shard_drop_at = frozenset(
            (int(e), int(s)) for e, s in shard_drop_at)
        self.shard_raise_at = frozenset(int(e) for e in shard_raise_at)
        self.slow_shard_at = frozenset(int(e) for e in slow_shard_at)
        self.pump_death_at = frozenset(int(e) for e in pump_death_at)
        self.compact_fault_at = frozenset(int(e) for e in compact_fault_at)
        self.ckpt_truncate_at = frozenset(int(e) for e in ckpt_truncate_at)
        self._lock = threading.Lock()
        self._events = {s: 0 for s in SITES}

    # -------------------------------------------------------------- schedule
    def _next_event(self, site: str) -> int:
        with self._lock:
            n = self._events[site]
            self._events[site] = n + 1
        return n

    def events(self, site: str) -> int:
        """How many events this site has seen (for assertions/reports)."""
        if site not in _SITE_CODE:
            raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")
        with self._lock:
            return self._events[site]

    def _roll(self, site: str, n: int, extra: int = 0) -> float:
        """The deterministic uniform draw for event ``n`` at ``site``."""
        rng = np.random.default_rng(
            (self.seed, _SITE_CODE[site], int(n), int(extra)))
        return float(rng.random())

    def _hit(self, site: str, n: int, rate: float, extra: int = 0) -> bool:
        return rate > 0.0 and self._roll(site, n, extra) < rate

    # ---------------------------------------------------------------- parse
    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the CLI form: ``"seed=7,shard_drop=0.1,slow_ms=5"``.

        Keys are the scalar constructor knobs (rates, ``seed``,
        ``slow_ms``, ``truncate_frac``); the ``*_at`` schedules are
        API-only.  Unknown keys raise ``ValueError``.
        """
        kwargs = {}
        for item in filter(None, (p.strip() for p in spec.split(","))):
            key, sep, value = item.partition("=")
            if not sep:
                raise ValueError(f"bad --faults item {item!r}; expected "
                                 f"key=value")
            key = key.strip()
            if key == "seed":
                kwargs[key] = int(value)
            elif key in _RATES + ("slow_ms", "truncate_frac"):
                kwargs[key] = float(value)
            else:
                raise ValueError(
                    f"unknown fault knob {key!r}; known: seed, slow_ms, "
                    f"truncate_frac, {', '.join(_RATES)}")
        return cls(**kwargs)

    def describe(self) -> str:
        on = [f"{name}={getattr(self, name):g}" for name in _RATES
              if getattr(self, name) > 0.0 or getattr(self, name + "_at")]
        return (f"FaultPlan(seed={self.seed}"
                + (", " + ", ".join(on) if on else "") + ")")

    __repr__ = describe


# --------------------------------------------------------------------------
# installation
# --------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` process-wide (None clears)."""
    global _ACTIVE
    _ACTIVE = plan


def clear() -> None:
    install(None)


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def injected(plan: FaultPlan):
    """Scope a plan: install on entry, restore the previous one on exit."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


# --------------------------------------------------------------------------
# site hooks (called by production code; no-ops without a plan)
# --------------------------------------------------------------------------

def shard_events(n_shards: int) -> Optional[np.ndarray]:
    """Sharded-search hook: one call = one search dispatch.

    May raise :class:`~repro_torch.serve.errors.ShardFault` (``shard_raise``),
    sleep (``slow_shard``), and returns a ``[n_shards]`` bool keep-mask
    when any shard is dropped this call — or None (no degradation).
    """
    plan = _ACTIVE
    if plan is None:
        return None
    n = plan._next_event("shard_raise")
    if n in plan.shard_raise_at or plan._hit("shard_raise", n,
                                             plan.shard_raise):
        raise ShardFault(
            f"injected: sharded search raised before dispatch "
            f"(event {n}, seed {plan.seed}) — transient, retry")
    m = plan._next_event("slow_shard")
    if m in plan.slow_shard_at or plan._hit("slow_shard", m,
                                            plan.slow_shard):
        time.sleep(plan.slow_ms / 1e3)
    e = plan._next_event("shard_drop")
    drop = [s for s in range(int(n_shards))
            if (e, s) in plan.shard_drop_at
            or plan._hit("shard_drop", e, plan.shard_drop, extra=s + 1)]
    if not drop:
        return None
    keep = np.ones(int(n_shards), bool)
    keep[drop] = False
    return keep


def pump_tick() -> None:
    """AsyncEngine pump hook, called once per served batch OUTSIDE the
    per-batch error handler — an injected :class:`PumpFault` genuinely
    kills the loop, which is exactly what the supervisor must survive."""
    plan = _ACTIVE
    if plan is None:
        return
    n = plan._next_event("pump_death")
    if n in plan.pump_death_at or plan._hit("pump_death", n,
                                            plan.pump_death):
        raise PumpFault(f"injected: pump thread crashed "
                        f"(event {n}, seed {plan.seed})")


def compaction_attempt() -> None:
    """``mutate.delta.compact`` hook, called before the rebuild — an
    injected failure raises before any new state exists, so the caller's
    serving state is untouched by construction."""
    plan = _ACTIVE
    if plan is None:
        return
    n = plan._next_event("compact_fault")
    if n in plan.compact_fault_at or plan._hit("compact_fault", n,
                                               plan.compact_fault):
        raise CompactionError(
            f"injected: compaction rebuild failed (event {n}, "
            f"seed {plan.seed}); serving state untouched")


def checkpoint_keep_bytes(nbytes: int) -> Optional[int]:
    """``serve.checkpoint.save`` hook: how many bytes of the written file
    to KEEP (truncation injection), or None for an intact save."""
    plan = _ACTIVE
    if plan is None:
        return None
    n = plan._next_event("ckpt_truncate")
    if n in plan.ckpt_truncate_at or plan._hit("ckpt_truncate", n,
                                               plan.ckpt_truncate):
        return max(1, int(int(nbytes) * plan.truncate_frac))
    return None


# --------------------------------------------------------------------------
# degraded-call note (observability for direct sharded_search callers)
# --------------------------------------------------------------------------

_TLS = threading.local()


def note_degraded(coverage: float, failed_shards: Tuple[int, ...]) -> None:
    """Record this thread's most recent degraded search (coverage +
    failed shard indices).  The Engine path computes coverage itself;
    this note is how direct ``sharded_search`` callers observe what the
    installed plan did to their call."""
    _TLS.last = (float(coverage), tuple(int(s) for s in failed_shards))


def last_degraded() -> Optional[Tuple[float, Tuple[int, ...]]]:
    """``(coverage, failed_shards)`` of this thread's last degraded
    search, or None if none was noted."""
    return getattr(_TLS, "last", None)


def clear_degraded() -> None:
    _TLS.last = None
