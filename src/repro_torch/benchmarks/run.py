"""Benchmark entry point of the port (``benchmarks/run.py`` of the
reference).

    python -m repro_torch.benchmarks.run [--scale smoke|default|full]
        [--only fig4,fig9,...] [--device cuda|cpu] [--out DIR]

Runs on the card unless ``--device cpu`` is passed (the plain versions on
the CPU: a check that the path runs, no device metric).  Prints
``name,us_per_call,derived`` CSV; ``--out`` also writes one
``BENCH_<key>.json`` per module.  Modules map 1:1 onto the paper's
tables/figures, as in the reference:
    bench_recall_qps      Figure 4  (recall vs QPS)
    bench_index_size      Figure 5 + Table 1 (index size / QPS)
    bench_robustness      Figure 6 + Q2 (Rand-Euclidean)
    bench_approximation   Figure 8 + Q3 (eps-recall)
    bench_hamming         Figure 9 + Q4 (Hamming embeddings)
    bench_build_time      Figure 10 (build time)
    bench_batch_mode      Figure 11 + §4.4 (batch vs single)
    bench_kernels         kernel micro-benchmarks with bounds and parity
    bench_distance_topk   streaming vs materialising top-k, equal memory
    bench_engine          serving: Engine micro-batching vs legacy loop
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

MODULES = [
    ("fig4", "repro_torch.benchmarks.bench_recall_qps"),
    ("fig5", "repro_torch.benchmarks.bench_index_size"),
    ("fig6", "repro_torch.benchmarks.bench_robustness"),
    ("fig8", "repro_torch.benchmarks.bench_approximation"),
    ("fig9", "repro_torch.benchmarks.bench_hamming"),
    ("fig10", "repro_torch.benchmarks.bench_build_time"),
    ("fig11", "repro_torch.benchmarks.bench_batch_mode"),
    ("kernels", "repro_torch.benchmarks.bench_kernels"),
    ("stream", "repro_torch.benchmarks.bench_distance_topk"),
    ("serve", "repro_torch.benchmarks.bench_engine"),
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
