"""Benchmark entry point of the port (``benchmarks/run.py`` of the
reference).

    python -m repro_torch.benchmarks.run [--scale smoke|default|full]
        [--only kernels,stream] [--device cuda|cpu] [--out DIR]

Runs on the card unless ``--device cpu`` is passed (the plain versions on
the CPU: a check that the path runs, no device metric).  Prints
``name,us_per_call,derived`` CSV; ``--out`` also writes one
``BENCH_<key>.json`` per module.  Ported so far:
    bench_kernels         kernel micro-benchmarks with bounds and parity
    bench_distance_topk   streaming vs materialising top-k, equal memory
The reference's other modules are still to port (ROADMAP).
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

MODULES = [
    ("kernels", "repro_torch.benchmarks.bench_kernels"),
    ("stream", "repro_torch.benchmarks.bench_distance_topk"),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scale", default="smoke",
                   choices=["smoke", "default", "full"])
    p.add_argument("--only", default=None,
                   help="comma-separated subset of: "
                        + ",".join(k for k, _ in MODULES))
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--out", default=None,
                   help="directory for BENCH_<key>.json artifacts")
    args = p.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and not only <= {k for k, _ in MODULES}:
        p.error(f"unknown module(s): {sorted(only - {k for k, _ in MODULES})}")

    from repro_torch import resolve_device
    from repro_torch.benchmarks.common import write_bench_json

    device = resolve_device(args.device)
    print("name,us_per_call,derived")
    failures = 0
    for key, modname in MODULES:
        if only and key not in only:
            continue
        t0 = time.time()
        try:
            rows = importlib.import_module(modname).run(args.scale, device)
            for row in rows:
                print(row.csv())
            if args.out:
                write_bench_json(key, rows, scale=args.scale,
                                 extra={"device": str(device)},
                                 out_dir=args.out)
            print(f"# {key}: {len(rows)} rows in {time.time() - t0:.1f}s",
                  file=sys.stderr)
        except Exception:
            failures += 1
            print(f"# {key} FAILED", file=sys.stderr)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
