"""Serving-tier metrics: latency percentiles + request counters
(``repro.serve.metrics``).

The paper's batch loop reports throughput (QPS) and recall; an open
request stream is judged on *tail latency* -- the p95/p99 a user actually
experiences, including queueing delay, not just device time.  This module
is the accounting layer the async serving tier threads every request
through:

  * :class:`LatencyHistogram` -- an O(1)-memory log-bucketed histogram
    (HdrHistogram-style): geometric buckets give a bounded ~5% relative
    error on any percentile regardless of sample count, so a serving
    process can record millions of requests without storing them.
  * :class:`ServeMetrics` -- thread-safe counters (submitted / served /
    timed_out / rejected / batches / padded) plus one latency histogram
    per tenant and one overall, with a ``snapshot()`` dict the CI gates
    and launchers print.

The pump records a micro-batch's latencies under one lock
(:meth:`ServeMetrics.observe_many`, and ``observe_coverage(..., n=)``);
the histograms and snapshots are those of one call per request.

Latencies are recorded in SECONDS (``time.perf_counter`` deltas measured
from ``submit()`` to ticket resolution -- queue wait + batching + device
time); snapshots report milliseconds, the unit SLOs are written in.
"""

from __future__ import annotations

import math
import threading
from collections import Counter
from typing import Dict, Optional, Sequence

#: counter names ServeMetrics tracks; anything else is rejected so typos
#: in instrumentation fail loudly instead of minting a new silent counter.
#: degraded / retried / failed / compaction* are the fault-tolerance
#: layer's accounting: degraded = served with coverage < 1 (a shard was
#: down), retried = micro-batch retry attempts, failed = tickets resolved
#: to a typed error other than deadline/admission.
COUNTERS = ("submitted", "served", "timed_out", "rejected", "batches",
            "padded", "degraded", "retried", "failed", "compactions",
            "compaction_failed")

#: aggregate key for the cross-tenant histogram / counters.
ALL_TENANTS = "__all__"


class LatencyHistogram:
    """Log-bucketed latency recorder with bounded-error percentiles.

    Buckets are geometric between ``lo_s`` and ``hi_s`` with
    ``bins_per_decade`` buckets per decade, so every percentile estimate
    is within half a bucket width (~``10**(1/(2*bins_per_decade)) - 1``
    relative error, ~2.4% at the default 48/decade) of the true sample
    percentile.  Samples outside the range clamp to the end buckets; the
    exact min/max/sum are tracked alongside, so ``mean`` and the extremes
    are exact.
    """

    def __init__(self, lo_s: float = 1e-6, hi_s: float = 120.0,
                 bins_per_decade: int = 48):
        self.lo_s = float(lo_s)
        self.hi_s = float(hi_s)
        self._scale = bins_per_decade / math.log(10.0)
        n = int(math.ceil(math.log(hi_s / lo_s) * self._scale)) + 1
        self._counts = [0] * n
        self.count = 0
        self.sum_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def _bucket(self, seconds: float) -> int:
        if seconds <= self.lo_s:
            return 0
        i = int(math.log(seconds / self.lo_s) * self._scale)
        return min(i, len(self._counts) - 1)

    def record(self, seconds: float, n: int = 1) -> None:
        """Record ``n`` samples of ``seconds`` (one bucket lookup)."""
        self._counts[self._bucket(seconds)] += n
        self.count += n
        self.sum_s += seconds * n
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile in seconds (nan when empty)."""
        if self.count == 0:
            return math.nan
        rank = max(1, math.ceil(self.count * p / 100.0))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                # geometric midpoint of the bucket, clamped to the exact
                # extremes so p0/p100 can never leave the observed range
                lo = self.lo_s * math.exp(i / self._scale)
                hi = self.lo_s * math.exp((i + 1) / self._scale)
                return min(max(math.sqrt(lo * hi), self.min_s), self.max_s)
        return self.max_s                     # pragma: no cover - defensive

    @property
    def mean_s(self) -> float:
        return self.sum_s / self.count if self.count else math.nan

    def snapshot_ms(self) -> Dict[str, float]:
        """{count, mean, p50, p95, p99, max} with latencies in ms."""
        ms = 1e3
        return {
            "count": self.count,
            "mean": self.mean_s * ms,
            "p50": self.percentile(50) * ms,
            "p95": self.percentile(95) * ms,
            "p99": self.percentile(99) * ms,
            "max": (self.max_s * ms) if self.count else math.nan,
        }


class ServeMetrics:
    """Thread-safe request counters + per-tenant latency histograms.

    The pump thread and any number of client threads record concurrently;
    a single lock guards every update (the critical sections are a few
    integer adds -- contention is negligible next to a device call).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {ALL_TENANTS: Counter()}
        self._hists: Dict[str, LatencyHistogram] = {
            ALL_TENANTS: LatencyHistogram()}
        # coverage fraction per served request (1.0 = every shard
        # answered); the histogram machinery is unit-agnostic, the
        # [1e-3, 1] range spans "one shard of a thousand survived" to
        # "full coverage" with the usual ~2.4% bucket error.
        self._coverage: Dict[str, LatencyHistogram] = {
            ALL_TENANTS: LatencyHistogram(lo_s=1e-3, hi_s=1.0)}

    def _tenant_counter(self, tenant: Optional[str]) -> Counter:
        if tenant is None:
            tenant = ALL_TENANTS
        if tenant not in self._counters:
            self._counters[tenant] = Counter()
        return self._counters[tenant]

    def count(self, name: str, n: int = 1,
              tenant: Optional[str] = None) -> None:
        if name not in COUNTERS:
            raise ValueError(f"unknown serve counter {name!r}; "
                             f"tracked: {COUNTERS}")
        with self._lock:
            self._counters[ALL_TENANTS][name] += n
            if tenant is not None:
                self._tenant_counter(tenant)[name] += n

    def observe(self, seconds: float, tenant: Optional[str] = None) -> None:
        """Record one request's submit-to-answer latency."""
        with self._lock:
            self._hists[ALL_TENANTS].record(seconds)
            if tenant is not None:
                if tenant not in self._hists:
                    self._hists[tenant] = LatencyHistogram()
                self._hists[tenant].record(seconds)

    def observe_many(self, seconds: Sequence[float],
                     tenant: Optional[str] = None) -> None:
        """Record a micro-batch's submit-to-answer latencies under one
        lock (the pump's path; the same histograms as :meth:`observe`)."""
        with self._lock:
            hists = [self._hists[ALL_TENANTS]]
            if tenant is not None:
                if tenant not in self._hists:
                    self._hists[tenant] = LatencyHistogram()
                hists.append(self._hists[tenant])
            for hist in hists:
                for s in seconds:
                    hist.record(s)

    def observe_coverage(self, coverage: float,
                         tenant: Optional[str] = None, n: int = 1) -> None:
        """Record ``n`` served requests' shard coverage (1.0 = full).

        Recorded for EVERY served request, not just degraded ones, so the
        per-tenant percentiles mean "the coverage the p-th worst request
        actually got" -- the number an availability SLO is written
        against."""
        with self._lock:
            self._coverage[ALL_TENANTS].record(coverage, n)
            if tenant is not None:
                if tenant not in self._coverage:
                    self._coverage[tenant] = LatencyHistogram(
                        lo_s=1e-3, hi_s=1.0)
                self._coverage[tenant].record(coverage, n)

    # ------------------------------------------------------------- reading
    def counter(self, name: str, tenant: Optional[str] = None) -> int:
        with self._lock:
            return self._counters.get(tenant or ALL_TENANTS,
                                      Counter())[name]

    def percentile(self, p: float, tenant: Optional[str] = None) -> float:
        """p-th latency percentile in SECONDS (nan when empty)."""
        with self._lock:
            hist = self._hists.get(tenant or ALL_TENANTS)
            return hist.percentile(p) if hist else math.nan

    def coverage_percentile(self, p: float,
                            tenant: Optional[str] = None) -> float:
        """p-th percentile of served coverage (nan when empty).  Low
        percentiles are the interesting tail: p5 is the coverage the 5%
        worst-covered requests got."""
        with self._lock:
            hist = self._coverage.get(tenant or ALL_TENANTS)
            return hist.percentile(p) if hist else math.nan

    @staticmethod
    def _coverage_snapshot(hist: LatencyHistogram) -> Dict[str, float]:
        return {
            "count": hist.count,
            "mean": hist.mean_s,
            "p5": hist.percentile(5),
            "p50": hist.percentile(50),
            "min": hist.min_s if hist.count else math.nan,
        }

    def snapshot(self) -> dict:
        """One JSON-able dict: overall counters + latency (ms) +
        coverage percentiles + the same per tenant -- what launchers
        print (the reference's ``bench_serving`` writes it into
        ``BENCH_serving.json``)."""
        with self._lock:
            out = {
                "counters": dict(self._counters[ALL_TENANTS]),
                "latency_ms": self._hists[ALL_TENANTS].snapshot_ms(),
                "coverage": self._coverage_snapshot(
                    self._coverage[ALL_TENANTS]),
                "tenants": {},
            }
            for tenant, hist in self._hists.items():
                if tenant == ALL_TENANTS:
                    continue
                entry = {
                    "counters": dict(self._counters.get(tenant, Counter())),
                    "latency_ms": hist.snapshot_ms(),
                }
                if tenant in self._coverage:
                    entry["coverage"] = self._coverage_snapshot(
                        self._coverage[tenant])
                out["tenants"][tenant] = entry
            return out
