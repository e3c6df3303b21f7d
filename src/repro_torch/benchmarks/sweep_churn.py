"""The churn loop of the reference's ``benchmarks/bench_churn.py`` on the
card, repeated to show its spread: a frozen IVF against a MutableIVF
that inserts, deletes and searches in turn.

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_churn

Needs a CUDA card.  ``blobs-euclidean-20000`` (the reference bench's
default scale), IVF with 64 lists, b = 32 queries at n_probes 8, batches
of 32 rows, a 832-slot delta.  Each repetition times, on the host clock
with the card synchronized at the end: 20 frozen searches, then 24
churn steps (insert a batch, delete the batch inserted two steps
earlier, search), with the host's time in each part of a step.  It
prints one JSON line per repetition, with interleaved / frozen QPS (the
reference bench gates >= 0.5).  The port does not ship that bench: both
loops are bound by the host's launches (about 150 a frozen search), so
the ratio follows the host's noise, and these lines are why.
"""

from __future__ import annotations

import json
import time

import torch

from repro_torch import mutate, sync
from repro_torch.ann import ivf
from repro_torch.ann.functional import queries_on
from repro_torch.data import get_dataset

K, QBATCH, BATCH, N_PROBES, N_LISTS = 10, 32, 32, 8, 64
ITERS, N_BATCHES, REPS = 24, 20, 6


def frozen_ms(state, Q) -> float:
    ivf.search(state, Q, k=K, n_probes=N_PROBES)
    sync("cuda")
    t0 = time.perf_counter()
    for _ in range(N_BATCHES):
        ivf.search(state, Q, k=K, n_probes=N_PROBES)
    sync("cuda")
    return (time.perf_counter() - t0) / N_BATCHES * 1e3


def churn_ms(state, Q, pool, cap: int):
    """(ms a step, host ms in insert / delete / search a step)."""
    parts = {"insert": 0.0, "delete": 0.0, "search": 0.0}
    batches = []

    def step(i):
        nonlocal state
        t0 = time.perf_counter()
        state, new = mutate.insert(state, pool[(i * BATCH) % cap:][:BATCH])
        batches.append(new)
        t1 = time.perf_counter()
        if len(batches) > 2:
            state = mutate.delete(state, batches.pop(0))
        t2 = time.perf_counter()
        mutate.IVF_SPEC.search(state, Q, k=K, n_probes=N_PROBES)
        t3 = time.perf_counter()
        for part, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[part] += dt

    step(0)
    sync("cuda")
    for part in parts:
        parts[part] = 0.0
    t0 = time.perf_counter()
    for i in range(1, ITERS + 1):
        step(i)
    sync("cuda")
    ms = (time.perf_counter() - t0) / ITERS * 1e3
    return ms, {k: v / ITERS * 1e3 for k, v in parts.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_churn: needs a CUDA card")
    ds = get_dataset("blobs-euclidean-20000", device="cuda")
    Q = queries_on(ds.test[:QBATCH], ds.metric, "cuda")
    cap = BATCH * (ITERS + 2)
    n0 = len(ds.train) - cap
    frozen = ivf.build(ds.train, metric=ds.metric, n_clusters=N_LISTS,
                       device="cuda")
    start = mutate.IVF_SPEC.build(ds.train[:n0], metric=ds.metric,
                                  n_clusters=N_LISTS, delta_capacity=cap,
                                  device="cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for rep in range(REPS):
        f_ms = frozen_ms(frozen, Q)
        c_ms, parts = churn_ms(start, Q, ds.train[n0:], cap)
        print(json.dumps({"rep": rep, "frozen_ms": f_ms, "step_ms": c_ms,
                          "qps_ratio": f_ms / c_ms, "host_ms": parts}),
              flush=True)


if __name__ == "__main__":
    main()
