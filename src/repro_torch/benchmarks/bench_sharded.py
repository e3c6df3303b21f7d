"""Sharded serving benchmark (``benchmarks/bench_sharded.py`` of the
reference): per-shard streaming top-k feeding the compressed hierarchical
merge tree -- butterfly exchanges whose wire entries are int32 ids +
bf16/u16/int8 distances, with a full-precision root tiebreak restoring
exact f32 order -- on 8 logical devices stacked on one card
(:mod:`repro_torch.dist.mesh`; the reference forces 8 host devices).

Three gates, the reference's:

  * **exact ids** -- merged sharded top-10 ids are bitwise-identical to
    the single-device BruteForce result for all three metrics
    (euclidean / angular / hamming) at every shard count in {1,2,4,8},
    and ShardedIVF matches single-device IVF (the same lists) the same
    way.
  * **wire bytes** -- the merge tree at 8 shards / k=10 with the int8
    codec moves >= 4x fewer bytes per query than a flat f32
    ``all_gather`` of every shard's top-k, while its recall@10 stays
    within 0.01 of the exact reference (byte model pinned in
    ``repro_torch.dist.wire``; recall measured end to end with
    ``exact_vals=False`` -- the minimum-bytes configuration).  The
    reference measures that recall on the first ``QBATCH`` queries only;
    the port measures it on every test query of the set, ``QBATCH`` at a
    time, and reports the first batch's figure beside it.  On 32 queries
    the codec's mean loss (~0.5 % of the ids) sits close enough to the
    0.01 margin that some freshly drawn sets miss it by one id.
  * **zero retraces** -- the reference counts jit traces
    (``functional.TRACE_COUNTS``); the port has no jit and no counter.
    The gate keeps its name and checks the property the single trace
    gave: re-sweeping every warm shard count answers bitwise as the
    first sweep did, and every point of a ShardedIVF ``n_probes`` sweep
    runs at its ``max_probes`` cap's window (``search_sweep``), each
    point bitwise equal to that point's own static search.

Rows carry the card's device time per query batch for euclidean (CUDA
events; the host clock on ``--device cpu``, no device number).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_sharded \
        [--smoke | --scale default] [--device cpu]

Writes ``BENCH_sharded.json`` and exits non-zero if any gate fails.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann import bruteforce, ivf, sharded
from repro_torch.ann.functional import queries_on, search_sweep
from repro_torch.benchmarks.common import Row, timed, write_bench_json
from repro_torch.data import get_dataset
from repro_torch.dist import wire
from repro_torch.dist.mesh import device_count, force_device_count

K = 10
QBATCH = 32
SHARDS = (1, 2, 4, 8)
RECALL_TOL = 0.01         # bytes gate: int8 config within this of exact
MIN_BYTES_RATIO = 4.0     # bytes gate: flat f32 all_gather / merge tree
N_PROBES_SWEEP = (1, 2, 4, 8)

DATASETS = {
    "euclidean": "blobs-euclidean-{n}",
    "angular": "blobs-angular-{n}",
    "hamming": "random-hamming-{n}",
}
SCALE_N = {"smoke": 2000, "default": 20000, "full": 100000}


def _recall(pred_ids, true_ids):
    pred = np.asarray(torch.as_tensor(pred_ids).cpu())
    hits = sum(len(set(p[:K].tolist()) & set(t[:K].tolist()))
               for p, t in zip(pred, np.asarray(true_ids)))
    return hits / (len(true_ids) * K)


def _ids_phase(n, dev, reps):
    """Gate 1: bitwise parity with the single-device result, every metric
    x shard count.  Also the euclidean timing rows, and the warm states
    for the retrace phase."""
    rows, mismatches = [], []
    eu_states = {}
    for metric, pattern in DATASETS.items():
        ds = get_dataset(pattern.format(n=n), device=dev)
        Q = queries_on(ds.test[:QBATCH], metric, dev)
        ref = bruteforce.build(ds.train, metric=metric, device=dev)
        _, ref_ids = bruteforce.search(ref, Q, k=K)
        for S in SHARDS:
            state = sharded.bruteforce_build(ds.train, metric=metric,
                                             n_shards=S, device=dev)
            _, ids = sharded.bruteforce_search(state, Q, k=K)
            exact = bool(torch.equal(ids, ref_ids))
            if not exact:
                mismatches.append(f"BruteForce/{metric}/S={S}")
            codec = wire.default_codec(metric)
            bytes_q = wire.merge_wire_bytes(S, K, codec=codec)
            derived = (f"metric={metric};codec={codec};"
                       f"wire_bytes_per_query={bytes_q};"
                       f"bitwise={'PASS' if exact else 'FAIL'}")
            us = 0.0
            if metric == "euclidean":
                eu_states[S] = (state, Q, ids)
                us = timed(lambda st=state, q=Q: sharded.bruteforce_search(
                    st, q, k=K), n=reps, device=dev)
                derived += f";qps={QBATCH / (us / 1e6):.0f}"
            rows.append(Row(f"sharded/bf/{metric}/shards={S}", us, derived))

    # ShardedIVF against single-device IVF: the same k-means seed, the
    # same lists
    ds = get_dataset(DATASETS["euclidean"].format(n=n), device=dev)
    Q = queries_on(ds.test[:QBATCH], "euclidean", dev)
    ref = ivf.build(ds.train, metric="euclidean", n_clusters=32, device=dev)
    _, ref_ids = ivf.search(ref, Q, k=K, n_probes=8)
    for S in SHARDS:
        state = sharded.ivf_build(ds.train, metric="euclidean",
                                  n_clusters=32, n_shards=S, device=dev)
        _, ids = sharded.ivf_search(state, Q, k=K, n_probes=8)
        exact = bool(torch.equal(ids, ref_ids))
        if not exact:
            mismatches.append(f"IVF/euclidean/S={S}")
        rows.append(Row(f"sharded/ivf/euclidean/shards={S}", 0.0,
                        f"n_probes=8;bitwise={'PASS' if exact else 'FAIL'}"))
    return rows, mismatches, eu_states, state


def _bytes_phase(n, dev):
    """Gate 2: int8 merge tree >= 4x fewer wire bytes than the flat f32
    all_gather at equal recall@10 (minimum-bytes config: carry=k,
    exact_vals=False), the recalls over every test query."""
    S = 8
    flat = wire.flat_gather_wire_bytes(S, K)
    merged = wire.merge_wire_bytes(S, K, codec="int8", carry=K)
    ratio = flat / merged

    ds = get_dataset(DATASETS["euclidean"].format(n=n), device=dev)
    true = ds.neighbors[:, :K]
    ref = bruteforce.build(ds.train, metric="euclidean", device=dev)
    state = sharded.bruteforce_build(ds.train, metric="euclidean",
                                     n_shards=S, wire_codec="int8", carry=K,
                                     device=dev)
    ref_ids, ids8 = [], []
    for s in range(0, len(ds.test), QBATCH):
        Q = queries_on(ds.test[s:s + QBATCH], "euclidean", dev)
        ref_ids.append(bruteforce.search(ref, Q, k=K)[1].cpu())
        ids8.append(sharded.bruteforce_search(state, Q, k=K,
                                              exact_vals=False)[1].cpu())
    ref_recall = _recall(torch.cat(ref_ids), true)
    int8_recall = _recall(torch.cat(ids8), true)
    first_recall = _recall(ids8[0], true[:QBATCH])
    first_ref_recall = _recall(ref_ids[0], true[:QBATCH])

    ok = ratio >= MIN_BYTES_RATIO and int8_recall >= ref_recall - RECALL_TOL
    row = Row("sharded/wire/int8/shards=8", 0.0,
              f"flat_bytes={flat};merge_bytes={merged};ratio={ratio:.2f};"
              f"queries={len(true)};recall={int8_recall:.4f};"
              f"ref_recall={ref_recall:.4f};"
              f"recall_first{QBATCH}={first_recall:.4f};"
              f"ref_recall_first{QBATCH}={first_ref_recall:.4f}")
    return row, ok, {"flat_bytes": flat, "merge_bytes": merged,
                     "ratio": ratio, "queries": len(true),
                     "recall": int8_recall, "ref_recall": ref_recall,
                     f"recall_first{QBATCH}": first_recall,
                     f"ref_recall_first{QBATCH}": first_ref_recall}


def _retrace_phase(eu_states, state):
    """Gate 3 (see the module docstring): the warm shard-count sweep
    answers as before, and the ``n_probes`` sweep runs at the cap's
    window with every point equal to its static search."""
    same = all(torch.equal(sharded.bruteforce_search(st, Q, k=K)[1], ids)
               for st, Q, ids in eu_states.values())
    Q = eu_states[1][1]
    cap = max(N_PROBES_SWEEP)
    _, swept = search_sweep(state, Q, k=K,
                            knob_grid={"n_probes": N_PROBES_SWEEP},
                            max_probes=cap)
    points = sum(
        bool(torch.equal(swept[i],
                         sharded.ivf_search(state, Q, k=K, n_probes=p)[1]))
        for i, p in enumerate(N_PROBES_SWEEP))
    ok = same and points == len(N_PROBES_SWEEP)
    row = Row("sharded/retrace", 0.0,
              f"warm_sweep_bitwise={'PASS' if same else 'FAIL'};"
              f"ivf_cap_window_points={points}/{len(N_PROBES_SWEEP)}")
    return row, ok


def run(scale: str = "default", device=None):
    """(rows, gates, extra) on ``device``, with the logical device count
    at 8 for the run (put back after it)."""
    dev = resolve_device(device)
    prev = force_device_count(max(SHARDS))
    try:
        return _run(scale, dev)
    finally:
        force_device_count(prev)


def _run(scale: str, dev):
    n = SCALE_N.get(scale, SCALE_N["default"])
    reps = 3 if scale == "smoke" else 10

    id_rows, mismatches, eu_states, ivf8 = _ids_phase(n, dev, reps)
    bytes_row, bytes_ok, bytes_extra = _bytes_phase(n, dev)
    retrace_row, retrace_ok = _retrace_phase(eu_states, ivf8)

    gates = {
        "exact_ids_all_metrics_all_shard_counts": not mismatches,
        "wire_bytes_ge_4x_at_equal_recall": bytes_ok,
        "zero_retraces_across_shard_sweep": retrace_ok,
    }
    rows = id_rows + [bytes_row, retrace_row]
    rows.append(Row("sharded/gates", 0.0,
                    ";".join(f"{k}={'PASS' if v else 'FAIL'}"
                             for k, v in gates.items())))
    extra = {"gates": gates, "mismatches": mismatches,
             "wire": bytes_extra, "shards": list(SHARDS),
             "devices": device_count(), "device": str(dev),
             "device_name": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")}
    return rows, gates, extra


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--scale", default=None,
                   choices=["smoke", "default", "full"])
    p.add_argument("--smoke", action="store_true",
                   help="shorthand for --scale smoke (CI smoke lane)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args()
    scale = args.scale or ("smoke" if args.smoke else "default")
    rows, gates, extra = run(scale, args.device)
    print("name,us_per_call,derived")
    for row in rows:
        print(row.csv())
    path = write_bench_json("sharded", rows, scale=scale, extra=extra)
    print(f"wrote {path}")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"sharded gates FAILED: {failed}")
    print(f"sharded gates passed: {sorted(gates)}")
