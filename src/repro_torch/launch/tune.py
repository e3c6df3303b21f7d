"""Auto-tuner launcher (``repro.launch.tune``): sweep a query-knob grid on
the card and print the constrained-optimal operating point (Sun et al.
2023-style selection over the paper's parameter sweep).

    PYTHONPATH=src python -m repro_torch.launch.tune \
        --dataset blobs-euclidean-20000 --algorithm IVF \
        --build n_clusters=64 --grid n_probes=1,2,4,8,16,32 scan=32,128,512 \
        --min-recall 0.9 --out-json /tmp/tuned.json --plot /tmp/tuned.png \
        [--device cpu]

The grid runs on ``--device`` (``cuda`` unless told otherwise): every
combination at the cap-sized window with its own mask, each timed through
the bound search (``functional.bind_search``), and the chosen config is
printed as a ready-to-paste ``--query`` string.  ``--out-json`` writes the
reference's schema.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch import resolve_device, tune
from repro_torch.ann.functional import get_functional
from repro_torch.data import get_dataset
from repro_torch.launch.knobs import (format_kv, parse_build, parse_grid,
                                      parse_kv)


def _point_row(p: tune.OperatingPoint) -> dict:
    return {"params": p.params, "recall": round(p.recall, 4),
            "qps": round(p.qps, 1), "latency_s": p.latency}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="blobs-euclidean-20000")
    p.add_argument("--algorithm", default="IVF")
    p.add_argument("--build", nargs="*", default=[],
                   help="build params as key=value (comma-separable)")
    p.add_argument("--query", nargs="*", default=[],
                   help="fixed query params as key=value (comma-separable)")
    p.add_argument("--grid", nargs="+", required=True,
                   help="swept knobs as knob=v1,v2,... (cartesian product)")
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--nq", type=int, default=256,
                   help="tuning query-batch size (from the test set)")
    p.add_argument("--repetitions", type=int, default=3)
    p.add_argument("--min-recall", type=float, default=None,
                   help="max QPS s.t. recall >= this")
    p.add_argument("--max-latency", type=float, default=None,
                   help="max recall s.t. mean s/query <= this")
    p.add_argument("--out-json", default=None,
                   help="write grid + pareto + chosen config as JSON")
    p.add_argument("--plot", default=None,
                   help="write the recall/QPS picture as a PNG")
    p.add_argument("--device", default="cuda",
                   help="where the index lives and the grid runs")
    args = p.parse_args(argv)

    if (args.min_recall is None) == (args.max_latency is None):
        raise SystemExit("pick exactly one of --min-recall / --max-latency")
    constraint = tune.Constraint.min_recall(args.min_recall) \
        if args.min_recall is not None \
        else tune.Constraint.max_latency(args.max_latency)

    device = resolve_device(args.device)
    ds = get_dataset(args.dataset, device=device)
    spec = get_functional(args.algorithm)
    grid = parse_grid(args.grid)
    t0 = time.perf_counter()
    state = spec.build(ds.train, metric=ds.metric, device=device,
                       **parse_build(args.build))
    print(f"[tune] built {spec.name} in {time.perf_counter() - t0:.2f}s; "
          f"grid {'x'.join(str(len(v)) for v in grid.values())} over "
          f"{sorted(grid)} ({constraint})")

    nq = min(args.nq, len(ds.test))
    result = tune.grid_search(
        state, ds.test[:nq], ds.distances[:nq], k=args.count,
        knob_grid=grid, constraint=constraint,
        repetitions=args.repetitions, query_params=parse_kv(args.query))

    pareto = {id(pt) for pt in result.pareto}
    header = f"{'config':<36}{'recall':>8}{'qps':>10}{'ms/q':>8}"
    print(header)
    for pt in result.points:
        cfg = ",".join(f"{k}={v}" for k, v in pt.params.items())
        mark = " *" if id(pt) in pareto else ""
        best = " <= chosen" if pt is result.best else ""
        print(f"{cfg:<36}{pt.recall:>8.3f}{pt.qps:>10.0f}"
              f"{pt.latency * 1e3:>8.3f}{mark}{best}")
    print("(* = pareto-optimal)")

    if result.best is None:
        print(f"[tune] NO grid point satisfies {constraint}; "
              f"widen the grid or relax the bound")
    else:
        chosen = format_kv(result.best.params)
        print(f"[tune] chosen: {chosen}  (recall={result.best.recall:.3f}, "
              f"{result.best.qps:.0f} QPS) -- serve with "
              f"--query {chosen}")

    if args.out_json:
        payload = {
            "dataset": ds.name, "algorithm": spec.name, "k": args.count,
            "constraint": str(constraint),
            "points": [_point_row(pt) for pt in result.points],
            "pareto": [_point_row(pt) for pt in result.pareto],
            "best": None if result.best is None else _point_row(result.best),
        }
        with open(args.out_json, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"[tune] wrote {args.out_json}")
    if args.plot:
        from repro_torch.core.plotting import tune_plot_png

        print(f"[tune] wrote {tune_plot_png(result, args.plot)}")
    return result


if __name__ == "__main__":
    main()
