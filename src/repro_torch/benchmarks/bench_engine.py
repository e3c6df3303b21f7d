"""Serving-path benchmark (``benchmarks/bench_engine.py`` of the
reference): the micro-batched :class:`~repro_torch.serve.Engine` against
the per-call ``BaseANN.batch_query`` loop, at equal recall.

Two workloads, both with identical index parameters (so recall is equal by
construction, verified through the shared
``core.metrics.recall_from_arrays`` definition, and the two paths' ids are
asserted equal):

  * **jittered** -- a stream of request batches whose sizes vary (the
    serving shape: request sizes are drawn fresh, they do not replay).
    In the reference this row measures retraces: its legacy path compiles
    its jitted search anew for every request size, while the Engine pads
    to one traced shape.  The port has no ``jit``, so nothing is compiled
    on either path, and the row measures what padding costs or saves: the
    Engine runs every request as whole ``[256, d]`` micro-batches, the
    legacy loop runs each request at its own size.
  * **fixed** -- every request is exactly batch_size queries, both paths
    warmed: per-call overhead only (the legacy adapter's blocking logic
    against the Engine's pad/slice).

Times are the host clock around calls that end in a host copy of the ids
(a device synchronisation), on the device the caller names (``cuda``
unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_engine \
        [--scale smoke|default|full] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.ann import distances as D
from repro_torch.benchmarks.common import Row, dataset_size
from repro_torch.core.metrics import recall_from_arrays
from repro_torch.core.registry import available
from repro_torch.data import get_dataset
from repro_torch.serve import Engine

K = 10
BATCH = 256
N_REQUESTS = 12


def _draw(ds, rng, n_requests, size=None):
    """(sels, Qs) for a stream of request batches."""
    sizes = ([size] * n_requests if size else
             rng.integers(BATCH // 4, BATCH + 1, size=n_requests))
    sels = [rng.integers(0, len(ds.test), s) for s in sizes]
    return sels, [ds.test[sel] for sel in sels]


def _recall(ds, Qs, ids_per_req, sels, device):
    recs = []
    for Q, ids, sel in zip(Qs, ids_per_req, sels):
        dists = D.pairwise_rows(Q, ds.train, ids[:, :K], ds.metric,
                                device=device)
        recs.append(np.mean(recall_from_arrays(
            dists, ds.distances[sel], K, neighbors=ids[:, :K])))
    return float(np.mean(recs))


def _time_legacy(algo, Qs):
    t0 = time.perf_counter()
    out = []
    for Q in Qs:
        algo.batch_query(Q, K)
        out.append(algo.get_batch_results())
    return time.perf_counter() - t0, out


def _time_engine(eng, Qs):
    t0 = time.perf_counter()
    out = []
    for Q in Qs:
        _, ids = eng.search(Q)
        out.append(ids)
    return time.perf_counter() - t0, out


def run(scale: str = "default", device=None):
    dev = resolve_device(device)
    n = dataset_size(scale)
    ds = get_dataset(f"blobs-euclidean-{n}", device=dev)
    rng = np.random.default_rng(0)
    build = {"n_clusters": 64}
    qargs = {"n_probes": 8}

    algo = available()["IVF"](ds.metric, **build)
    algo.fit(ds.train, device=dev)
    algo.set_query_arguments(qargs["n_probes"])
    eng = Engine.build("IVF", ds.train, metric=ds.metric,
                       build_params=build, query_params=qargs,
                       k=K, batch_size=BATCH, device=dev)

    rows = []
    # warmup: one jittered pass (different sizes from the timed pass) so
    # neither path pays first-call costs unrelated to the workload
    _, warm_Qs = _draw(ds, rng, 4)
    _time_legacy(algo, warm_Qs)
    _time_engine(eng, warm_Qs)

    # ---- jittered sizes: fresh draws
    for name, timer, serve in (
            ("legacy_batch_query_loop", _time_legacy, algo),
            ("engine_micro_batched", _time_engine, eng)):
        sels, Qs = _draw(ds, np.random.default_rng(1), N_REQUESTS)
        nq = sum(len(Q) for Q in Qs)
        t, ids = timer(serve, Qs)
        rec = _recall(ds, Qs, ids, sels, dev)
        rows.append(Row(f"serve/jittered/{name}", t / nq * 1e6,
                        f"qps={nq / t:.0f};recall={rec:.3f}"))
        if name.startswith("legacy"):
            legacy_t, legacy_ids, legacy_nq = t, ids, nq
        else:
            np.testing.assert_array_equal(
                np.sort(np.concatenate(legacy_ids), 1),
                np.sort(np.concatenate(ids), 1))
            rows.append(Row("serve/jittered/engine_speedup", 0.0,
                            f"x={legacy_t / t:.2f};equal_recall=True"))

    # ---- fixed size: both warm -- pure per-call overhead
    sels, Qs = _draw(ds, np.random.default_rng(2), N_REQUESTS, size=BATCH)
    nq = sum(len(Q) for Q in Qs)
    _time_legacy(algo, Qs[:1])          # warm this exact shape
    _time_engine(eng, Qs[:1])
    t_l, ids_l = _time_legacy(algo, Qs)
    t_e, ids_e = _time_engine(eng, Qs)
    np.testing.assert_array_equal(np.sort(np.concatenate(ids_l), 1),
                                  np.sort(np.concatenate(ids_e), 1))
    rec = _recall(ds, Qs, ids_e, sels, dev)
    rows.append(Row("serve/fixed/legacy_batch_query_loop", t_l / nq * 1e6,
                    f"qps={nq / t_l:.0f};recall={rec:.3f}"))
    rows.append(Row("serve/fixed/engine_micro_batched", t_e / nq * 1e6,
                    f"qps={nq / t_e:.0f};recall={rec:.3f};"
                    f"padded={eng.stats['padded']}"))
    rows.append(Row("serve/fixed/engine_speedup", 0.0,
                    f"x={t_l / t_e:.2f};equal_recall=True"))
    return rows


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--scale", default="default",
                   choices=["smoke", "default", "full"])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args()
    print("name,us_per_call,derived")
    for row in run(args.scale, args.device):
        print(row.csv())
