"""The measurements of the reference's ``benchmarks/bench_serving.py`` on
the card, through the port's :class:`~repro_torch.serve.AsyncEngine`,
repeated to show their spread; and what a thread busy in Python does to
the pump's torch calls.

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_serving

Needs a CUDA card.  Each repetition runs the reference bench's two phases
at its default scale, with its constants: ``blobs-euclidean-20000``, two
tenants (IVF, 64 lists, n_probes 8 and 16 under max_probes 16) on one
state, micro-batches of 32, the service time probed as the max of five
warm ``search()`` calls a tenant; Poisson arrivals at 40 % of that
capacity (bursts of 1-4, 70/30 over the tenants, a 10 s deadline), then
a burst of 320 submits against ``max_queue`` 64 (a third overriding
n_probes).  It prints one JSON line per repetition with the bench's gates,
as the reference computes them, and the p95 / bound ratio of its
``p95_le_max_wait_plus_service`` gate.  The port does not ship that
bench, since that gate missed in some runs; these lines are why.

Then the pump's exposure to the GIL: torch gives the GIL up at every op,
so a thread busy in Python takes it for a switch interval each time.  One
IVF micro-batch of 256 at ``blobs-euclidean-100000-d128`` (256 lists,
n_probes 8) is timed alone and beside such a thread, at the default
switch interval and at 0.2 ms.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.ann import distances as D
from repro_torch.ann import ivf
from repro_torch.core.metrics import recall_from_arrays
from repro_torch.data import get_dataset
from repro_torch.serve import (AdmissionError, AsyncEngine, DeadlineExceeded,
                               Engine)

K = 10
BATCH = 32
MAX_PROBES = 16
TENANT_PROBES = {"std": 8, "gold": 16}
SUBCAP_FRACTION = 0.4
N_EVENTS = 400
REPS = 8


def tenants(ds):
    """Two Engines (quality tiers) sharing one index on the card."""
    state = ivf.build(ds.train, metric=ds.metric, n_clusters=64,
                      device="cuda")
    return {name: Engine(state, k=K, batch_size=BATCH,
                         query_params={"n_probes": probes,
                                       "max_probes": MAX_PROBES})
            for name, probes in TENANT_PROBES.items()}


def probe(engines, ds) -> float:
    """The bench's service budget: the max of five warm searches of one
    micro-batch a tenant, on the host clock."""
    samples = []
    for eng in engines.values():
        eng.search(ds.test[:BATCH])
        for _ in range(5):
            t0 = time.perf_counter()
            eng.search(ds.test[:BATCH])
            samples.append(time.perf_counter() - t0)
    return max(samples)


def recall(ds, sel, ids) -> float:
    dists = D.pairwise_rows(ds.test[sel], ds.train, ids[:, :K], ds.metric,
                            device="cuda")
    return float(np.mean(recall_from_arrays(
        dists, ds.distances[sel], K, neighbors=ids[:, :K])))


def subcapacity(engines, ds, svc_s, max_wait_ms, rng) -> dict:
    rate_qps = SUBCAP_FRACTION * BATCH / svc_s
    srv = AsyncEngine(engines, max_wait_ms=max_wait_ms,
                      max_queue=8 * BATCH, default_deadline_ms=10_000.0)
    names = list(TENANT_PROBES)
    inflight, rejected = [], 0
    for _ in range(N_EVENTS):
        burst = int(rng.integers(1, 5))
        tenant = names[0] if rng.random() < 0.7 else names[1]
        for _ in range(burst):
            sel = int(rng.integers(0, len(ds.test)))
            try:
                inflight.append(
                    (srv.submit(ds.test[sel], tenant=tenant), tenant, sel))
            except AdmissionError:
                rejected += 1
        time.sleep(rng.exponential(burst / rate_qps))
    timed_out, answered = 0, {t: ([], []) for t in names}
    for ticket, tenant, sel in inflight:
        try:
            _, ids = ticket.result(timeout=120)
        except DeadlineExceeded:
            timed_out += 1
            continue
        answered[tenant][0].append(sel)
        answered[tenant][1].append(ids)
    srv.close()
    lat = srv.metrics.snapshot()["latency_ms"]
    recalls = {t: recall(ds, np.asarray(s), np.stack(i))
               for t, (s, i) in answered.items() if s}
    bound_ms = max_wait_ms + 1.5 * len(engines) * svc_s * 1e3
    return {"rate_qps": rate_qps, "requests": len(inflight),
            "latency_ms": lat, "p95_bound_ms": bound_ms,
            "p95_over_bound": lat["p95"] / bound_ms, "recall": recalls,
            "gates": {"zero_rejected": rejected == 0,
                      "zero_timed_out": timed_out == 0,
                      "recall_per_tenant_ge_0.9":
                          all(r >= 0.9 for r in recalls.values()),
                      "p95_le_max_wait_plus_service":
                          lat["p95"] <= bound_ms}}


def burst(engines, ds, svc_s, rng) -> dict:
    max_queue = 2 * BATCH
    deadline_ms = max(2.5 * svc_s * 1e3, 20.0)
    srv = AsyncEngine(engines, max_wait_ms=50.0, max_queue=max_queue,
                      default_deadline_ms=deadline_ms)
    tickets, rejected = [], 0
    for _ in range(max_queue + 8 * BATCH):
        sel = int(rng.integers(0, len(ds.test)))
        overrides = ({"n_probes": int(rng.choice((4, MAX_PROBES)))}
                     if rng.random() < 0.33 else {})
        try:
            tickets.append(srv.submit(ds.test[sel], tenant="std",
                                      **overrides))
        except AdmissionError:
            rejected += 1
    answered = timed_out = 0
    for t in tickets:
        try:
            t.result(timeout=120)
            answered += 1
        except DeadlineExceeded:
            timed_out += 1
    srv.close()
    lat = srv.metrics.snapshot()["latency_ms"]
    return {"admitted": len(tickets), "rejected": rejected,
            "answered": answered, "timed_out": timed_out,
            "deadline_ms": deadline_ms, "max_latency_ms": lat["max"],
            "gates": {"burst_rejects_with_typed_error": rejected > 0,
                      "burst_admitted_all_resolve":
                          answered + timed_out == len(tickets),
                      "burst_deadlines_hold": answered == 0
                          or lat["max"] <= deadline_ms + 2e3 * svc_s}}


def busy(stop: threading.Event) -> None:
    """A thread that runs Python without a pause until told to stop."""
    x = 0
    while not stop.is_set():
        for i in range(100):
            x += i


def gil_exposure() -> None:
    ds = get_dataset("blobs-euclidean-100000-d128", device="cuda")
    state = ivf.build(ds.train, metric=ds.metric, n_clusters=256,
                      rerank_kernel=True, device="cuda")
    eng = Engine(state, batch_size=256,
                 query_params={"n_probes": 8, "max_probes": 16})
    Q = ds.test[:256]
    for _ in range(3):
        eng.search(Q)
    default = sys.getswitchinterval()
    for interval in (default, 2e-4):
        sys.setswitchinterval(interval)
        for with_busy in (False, True):
            stop = threading.Event()
            thread = threading.Thread(target=busy, args=(stop,))
            if with_busy:
                thread.start()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.search(Q)
                times.append((time.perf_counter() - t0) * 1e3)
            stop.set()
            if with_busy:
                thread.join()
            print(json.dumps({"switch_interval_s": interval,
                              "busy_python_thread": with_busy,
                              "micro_batch_ms": times}), flush=True)
    sys.setswitchinterval(default)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_serving: needs a CUDA card")
    ds = get_dataset("blobs-euclidean-20000", device="cuda")
    engines = tenants(ds)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for rep in range(REPS):
        rng = np.random.default_rng(rep)
        svc_s = probe(engines, ds)
        max_wait_ms = max(15.0, 3.0 * svc_s * 1e3)
        sub = subcapacity(engines, ds, svc_s, max_wait_ms, rng)
        out = burst(engines, ds, svc_s, rng)
        print(json.dumps({"rep": rep, "service_ms": svc_s * 1e3,
                          "max_wait_ms": max_wait_ms, "subcapacity": sub,
                          "burst": out}), flush=True)
    gil_exposure()


if __name__ == "__main__":
    main()
