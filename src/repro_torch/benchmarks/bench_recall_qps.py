"""Paper Figure 4: Recall-QPS trade-off per algorithm (the headline plot),
as ``benchmarks/bench_recall_qps.py`` of the reference.

Runs the default algorithm sweep on a euclidean and an angular dataset, on
``device`` (the card unless the caller passes ``cpu``), and reports one
row per (instance, query-args).  ``derived`` = recall@10.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import REPETITIONS, Row, dataset_size
from repro_torch.core.metrics import recall
from repro_torch.core.runner import run_benchmark

CFG = """
float:
  euclidean:
    bruteforce: {constructor: BruteForce, base-args: ["@metric"]}
    ivf:
      constructor: IVF
      base-args: ["@metric"]
      run-groups:
        g: {args: [[64]], query-args: [[1, 4, 16, 64]]}
    rpforest:
      constructor: RPForest
      base-args: ["@metric"]
      run-groups:
        g: {args: [[10], [64]], query-args: [[1, 4]]}
    graph:
      constructor: KNNGraph
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16]], query-args: [[16, 64]]}
    hnsw:
      constructor: HNSW
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16], [80]], query-args: [[16, 64]]}
  angular:
    bruteforce: {constructor: BruteForce, base-args: ["@metric"]}
    ivf:
      constructor: IVF
      base-args: ["@metric"]
      run-groups:
        g: {args: [[64]], query-args: [[1, 4, 16, 64]]}
    hyperplane-lsh:
      constructor: HyperplaneLSH
      base-args: ["@metric"]
      run-groups:
        g: {args: [[8], [12], [256]], query-args: [[1, 6, 13]]}
    graph:
      constructor: KNNGraph
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16]], query-args: [[16, 64]]}
"""


def run(scale: str = "default", device=None):
    n = dataset_size(scale)
    rows = []
    for ds in (f"blobs-euclidean-{n}", f"blobs-angular-{n}"):
        records = run_benchmark(ds, CFG, count=10, batch=True, verbose=False,
                                repetitions=REPETITIONS, device=device)
        for r in records:
            us = 1e6 / r.qps if r.qps > 0 else float("nan")
            rows.append(Row(
                name=f"fig4/{ds}/{r.instance_name}/q={r.query_arguments}",
                us_per_call=us,
                derived=f"recall={recall(r):.3f}"))
    return rows
