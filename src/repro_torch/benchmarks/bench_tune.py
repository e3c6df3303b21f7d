"""Multi-knob grid sweep + auto-tuner benchmark
(``benchmarks/bench_tune.py`` of the reference).

Two measurements per algorithm, one pass each:

  * **per_combo_retrace** -- one static search per combination of a
    cartesian query-knob grid (the reference compiles each; the port runs
    eagerly);
  * **grid_sweep** -- the whole multi-knob grid through
    ``functional.search_sweep`` (every combination at the caps' window
    with its own masks).

Results are asserted identical per combination (equal recall by
construction), and a tuner gate runs ``tune.grid_search`` under a recall
floor and asserts the chosen config is feasible and QPS-optimal among the
feasible grid points.  The reference also asserts that the grid sweep took
exactly one jit trace (``functional.TRACE_COUNTS``) and prints
``traces=``; the port has no jit and no counter, so that assertion and
those fields are dropped.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_tune \
        [--smoke | --scale default] [--device cpu]
"""

from __future__ import annotations

import time

from repro_torch import resolve_device, sync, tune
from repro_torch.ann.functional import (get_functional, grid_combos,
                                        queries_on, search_sweep)
from repro_torch.benchmarks.common import Row, dataset_size, write_bench_json
from repro_torch.data import get_dataset

K = 10
NQ = 256

# algorithm -> (build params, cartesian grid over BOTH traced knob pairs)
GRIDS = {
    "IVF": ({"n_clusters": 64}, {"n_probes": (2, 8, 32), "scan": (16, 64)}),
    "RPForest": ({"n_trees": 8, "leaf_size": 32},
                 {"probe": (1, 2, 4), "trees": (4, 8)}),
}


def run(scale: str = "default", device=None):
    dev = resolve_device(device)
    n = dataset_size(scale)
    ds = get_dataset(f"blobs-euclidean-{n}", device=dev)
    Q = queries_on(ds.test[:NQ], ds.metric, dev)
    rows = []

    for name, (build_params, grid) in GRIDS.items():
        spec = get_functional(name)
        state = spec.build(ds.train, metric=ds.metric, device=dev,
                           **build_params)
        combos = grid_combos(grid)

        # one static call per combination
        t0 = time.perf_counter()
        outs = [spec.search(state, Q, k=K, **combo)[1] for combo in combos]
        sync(dev)
        t_retrace = time.perf_counter() - t0
        ids_static = [o.cpu() for o in outs]

        # the whole grid through search_sweep
        t0 = time.perf_counter()
        _, sweep_ids = search_sweep(state, Q, k=K, knob_grid=grid)
        sync(dev)
        t_sweep = time.perf_counter() - t0

        # equal recall by construction: identical neighbors per combination
        sweep_ids = sweep_ids.cpu()
        for i in range(len(combos)):
            w = ids_static[i].shape[1]
            assert ids_static[i].equal(sweep_ids[i][:, :w]), (
                f"{name}: search_sweep ids != static ids at {combos[i]}")

        shape = "x".join(str(len(v)) for v in grid.values())
        gridname = f"{'+'.join(grid)}[{shape}]"
        rows.append(Row(f"tune/{name}/per_combo_retrace/{gridname}",
                        t_retrace * 1e6, f"nq={NQ}"))
        rows.append(Row(f"tune/{name}/grid_sweep/{gridname}",
                        t_sweep * 1e6,
                        f"x={t_retrace / t_sweep:.2f};equal_recall=True"))

    # ---- tuner-constraint gate (IVF): chosen config must satisfy the
    # recall floor and maximize QPS among feasible grid points
    spec = get_functional("IVF")
    state = spec.build(ds.train, metric=ds.metric, n_clusters=64,
                       device=dev)
    floor = 0.9
    t0 = time.perf_counter()
    result = tune.grid_search(
        state, Q, ds.distances[:NQ], k=K,
        knob_grid={"n_probes": (1, 2, 4, 8, 16, 32, 64),
                   "scan": (32, state.stat("pad"))},
        constraint=tune.Constraint.min_recall(floor), repetitions=1)
    t_tune = time.perf_counter() - t0
    best = result.best
    assert best is not None, f"tuner found no config with recall>={floor}"
    assert best.recall >= floor
    for p in result.points:
        if p.recall >= floor:
            assert best.qps >= p.qps, (
                f"tuner chose {best.params} but feasible {p.params} "
                f"is faster")
    cfg = ",".join(f"{k}={v}" for k, v in best.params.items())
    rows.append(Row("tune/IVF/grid_search", t_tune * 1e6,
                    f"best={cfg};recall={best.recall:.3f};"
                    f"qps={best.qps:.0f};floor={floor};gate=pass"))
    return rows


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true",
                   help="tiny dataset (CI smoke lane)")
    p.add_argument("--scale", default=None,
                   choices=["smoke", "default", "full"])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args()
    scale = args.scale or ("smoke" if args.smoke else "default")
    rows = run(scale, args.device)
    print("name,us_per_call,derived")
    for row in rows:
        print(row.csv())
    print(f"wrote {write_bench_json('tune', rows, scale=scale)}")
