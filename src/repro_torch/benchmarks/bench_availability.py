"""Chaos / availability benchmark (``benchmarks/bench_availability.py`` of
the reference): seeded faults against the sharded serving tier, gated on
availability, not latency.

An 8-shard ShardedBruteForce engine (8 logical devices stacked on one
card, :mod:`repro_torch.dist.mesh`) serves an open request stream through
the AsyncEngine pump while a seeded :class:`~repro_torch.serve.faults.
FaultPlan` injects a 10% per-shard drop rate plus occasional whole-call
transient raises.  Dropped shards degrade the merge (the failed shard's
lane enters the butterfly as the ``(+inf, -1)`` sentinel channel, so
answers stay exact over the survivors and responses carry ``coverage <
1``); transient raises retry under the pump's
:class:`~repro_torch.serve.retry.RetryPolicy`.

Gates, the reference's:

  * **all_admitted_resolve** -- 100% of admitted tickets resolve (served
    or typed error); nothing hangs under any seeded fault.
  * **availability_ge_99** -- served / admitted >= 99% with retries on.
  * **degraded_report_coverage** -- faults really fired, and every
    degraded response reports ``0 <= coverage < 1`` on its ticket, with
    the metrics counter agreeing.
  * **zero_retraces** -- the reference checks that the chaos loop rode
    the traces warmed before it (``functional.TRACE_COUNTS``).  The port
    has no jit; the gate keeps its name and checks the padded-shape
    identity that single trace stood for: every micro-batch of the loop,
    degraded ones included, ran at the one ``[batch_size, d]`` shape
    (``batches * batch_size == queries + padded`` over the loop, from the
    engine's stats).
  * **faultfree_recovery_bitwise** -- a fault-free search afterwards
    answers bitwise as the warm-up did.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_availability \
        [--scale smoke|default] [--device cpu]

Writes ``BENCH_availability.json`` and exits non-zero if any gate fails.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import Row, dataset_size, write_bench_json
from repro_torch.data import get_dataset
from repro_torch.dist.mesh import force_device_count
from repro_torch.serve import (AsyncEngine, Engine, FaultPlan, RetryPolicy,
                               ServeError, faults)

K = 10
BATCH = 16
N_SHARDS = 8
SHARD_DROP = 0.10                 # per (call, shard): degraded responses
SHARD_RAISE = 0.05                # per call: transient, retried


def run(scale: str = "default", device=None):
    """(rows, gates, extra) on ``device``, with the logical device count
    at 8 for the run (put back after it)."""
    dev = resolve_device(device)
    prev = force_device_count(N_SHARDS)
    try:
        return _run(scale, dev)
    finally:
        force_device_count(prev)


def _run(scale: str, dev):
    n = dataset_size(scale)
    ds = get_dataset(f"blobs-euclidean-{n}", device=dev)
    n_requests = 240 if scale == "smoke" else 640
    eng = Engine.build("ShardedBruteForce", ds.train, metric=ds.metric,
                       build_params={"n_shards": N_SHARDS}, device=dev,
                       k=K, batch_size=BATCH)
    srv = AsyncEngine(eng, max_wait_ms=5.0, max_queue=2 * n_requests,
                      retry=RetryPolicy(max_attempts=3, base_ms=1.0,
                                        jitter=0.5, seed=0))
    d_ref, i_ref = srv.search(ds.test[:BATCH])
    before = dict(eng.stats)

    plan = FaultPlan(seed=0, shard_drop=SHARD_DROP, shard_raise=SHARD_RAISE)
    rng = np.random.default_rng(1)
    sels = rng.integers(0, len(ds.test), n_requests)
    with faults.injected(plan):
        tickets = [srv.submit(ds.test[int(s)]) for s in sels]
        served = failed = hung = 0
        degraded, bad_coverage = [], 0
        for t in tickets:
            try:
                t.result(timeout=120)
                served += 1
                if t.partial:
                    degraded.append(t.coverage)
                    if not 0.0 <= t.coverage < 1.0:
                        bad_coverage += 1
            except ServeError:
                failed += 1
            if not t.done():
                hung += 1
    loop = {k: eng.stats[k] - before[k]
            for k in ("batches", "queries", "padded")}

    # fault-free epilogue: the tier recovered -- bitwise the warmup answer
    d_post, i_post = srv.search(ds.test[:BATCH])
    recovered = bool(np.array_equal(i_post, i_ref)
                     and np.array_equal(d_post, d_ref))
    srv.close()
    snap = srv.metrics.snapshot()
    counters = snap["counters"]
    availability = served / max(1, len(tickets))
    cov5 = snap["coverage"]["p5"]

    gates = {
        "all_admitted_resolve": hung == 0
            and served + failed == len(tickets),
        "availability_ge_99": availability >= 0.99,
        "degraded_report_coverage": len(degraded) > 0
            and bad_coverage == 0
            and counters.get("degraded", 0) == len(degraded),
        "zero_retraces": loop["batches"] * BATCH
            == loop["queries"] + loop["padded"],
        "faultfree_recovery_bitwise": recovered,
    }
    rows = [
        Row("availability/outcomes", 0.0,
            f"admitted={len(tickets)};served={served};failed={failed};"
            f"hung={hung};availability={availability:.4f};"
            f"retried={counters.get('retried', 0)};"
            f"shard_events={plan.events('shard_drop')}"),
        Row("availability/degraded", 0.0,
            f"degraded={len(degraded)};"
            f"degraded_frac={len(degraded) / max(1, served):.3f};"
            f"coverage_p5={cov5:.3f};"
            f"coverage_min={min(degraded) if degraded else 1.0:.3f}"),
        Row("availability/gates", 0.0,
            ";".join(f"{k}={'PASS' if v else 'FAIL'}"
                     for k, v in gates.items())),
    ]
    extra = {"gates": gates, "metrics": snap, "plan": plan.describe(),
             "padded_shape": loop, "device": str(dev),
             "device_name": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")}
    return rows, gates, extra


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--scale", default="default",
                   choices=["smoke", "default", "full"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()
    rows, gates, extra = run(args.scale, args.device)
    print("name,us_per_call,derived")
    for row in rows:
        print(row.csv())
    path = write_bench_json("availability", rows, scale=args.scale,
                            extra=extra)
    print(f"wrote {path}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"availability gates FAILED: {failed}")
    print(f"availability gates passed: {sorted(gates)}")
