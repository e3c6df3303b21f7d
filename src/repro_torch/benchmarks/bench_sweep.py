"""Sweep benchmark (``benchmarks/bench_sweep.py`` of the reference): a
multi-value query-knob sweep through the traced-cap path and
``search_sweep`` against the per-group static path, at equal recall.

Three paths are timed over the same knob grid, one pass each:

  * **per_group_retrace** -- the static search, one call per value, the
    window sized by the value (the reference recompiles here; the port
    runs eagerly, so nothing is compiled);
  * **traced_cap** -- the search bound with the knob under its ``max_*``
    cap (``functional.bind_search``): every value at the cap's window with
    its own mask;
  * **search_sweep** -- the whole grid through ``functional.search_sweep``.

Results are asserted identical across paths per knob value (equal recall
by construction).  The reference's ``traces=`` fields count jit traces
(``functional.TRACE_COUNTS``); the port has no jit and no counter, so they
are dropped.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_sweep \
        [--smoke | --scale default] [--device cpu]
"""

from __future__ import annotations

import time

from repro_torch import resolve_device, sync
from repro_torch.ann.functional import (bind_search, get_functional,
                                        queries_on, search_sweep)
from repro_torch.benchmarks.common import Row, dataset_size, write_bench_json
from repro_torch.data import get_dataset

K = 10
NQ = 256

# algorithm -> (build params, knob values); caps = max(values)
SWEEPS = {
    "IVF": ({"n_clusters": 64}, (2, 8, 16, 32)),
    "RPForest": ({"n_trees": 8, "leaf_size": 32}, (1, 2, 3, 4)),
}


def _timed_sweep(step, values, device):
    """Total seconds for one pass over the grid, and each value's ids."""
    t0 = time.perf_counter()
    outs = [step(v) for v in values]
    sync(device)
    return time.perf_counter() - t0, [o[1].cpu() for o in outs]


def run(scale: str = "default", device=None):
    dev = resolve_device(device)
    n = dataset_size(scale)
    ds = get_dataset(f"blobs-euclidean-{n}", device=dev)
    Q = queries_on(ds.test[:NQ], ds.metric, dev)
    rows = []

    for name, (build_params, values) in SWEEPS.items():
        spec = get_functional(name)
        knob, cap_name = spec.traced_knobs[0]
        state = spec.build(ds.train, metric=ds.metric, device=dev,
                           **build_params)
        cap = max(values)

        t_retrace, ids_static = _timed_sweep(
            lambda v: spec.search(state, Q, k=K, **{knob: v}), values, dev)

        bound = bind_search(spec.search, spec, traced=(knob,))
        t_traced, ids_traced = _timed_sweep(
            lambda v: bound(state, Q, k=K, **{knob: v, cap_name: cap}),
            values, dev)

        t0 = time.perf_counter()
        _, sweep_ids = search_sweep(state, Q, k=K, knob_grid={knob: values})
        sync(dev)
        t_sweep = time.perf_counter() - t0
        sweep_ids = sweep_ids.cpu()

        # equal recall by construction: identical neighbors per knob value
        for i in range(len(values)):
            assert ids_static[i].equal(ids_traced[i]), (
                f"{name}: traced-cap ids != static ids at {knob}="
                f"{values[i]}")
            assert ids_static[i].equal(sweep_ids[i]), (
                f"{name}: search_sweep ids != static ids at {knob}="
                f"{values[i]}")

        grid = f"{knob}x{len(values)}"
        rows.append(Row(f"sweep/{name}/per_group_retrace/{grid}",
                        t_retrace * 1e6, f"nq={NQ}"))
        rows.append(Row(f"sweep/{name}/traced_cap/{grid}", t_traced * 1e6,
                        f"x={t_retrace / t_traced:.2f};equal_recall=True"))
        rows.append(Row(f"sweep/{name}/search_sweep/{grid}", t_sweep * 1e6,
                        f"x={t_retrace / t_sweep:.2f};equal_recall=True"))
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
    print(f"wrote {write_bench_json('sweep', rows, scale=scale)}")
