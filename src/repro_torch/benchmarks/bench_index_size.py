"""Paper Figure 5 + Table 1: index size (kB) / QPS trade-off, as
``benchmarks/bench_index_size.py`` of the reference.

``derived`` = indexsize_kB and queriessize (kB/QPS), the paper's Fig-5
measure ("down and to the right is better").
"""

from __future__ import annotations

from repro_torch.benchmarks.common import REPETITIONS, Row, dataset_size
from repro_torch.core.metrics import METRICS, recall
from repro_torch.core.runner import run_benchmark

CFG = """
float:
  euclidean:
    bruteforce: {constructor: BruteForce, base-args: ["@metric"]}
    ivf:
      constructor: IVF
      base-args: ["@metric"]
      run-groups:
        g: {args: [[64]], query-args: [[8]]}
    rpforest:
      constructor: RPForest
      base-args: ["@metric"]
      run-groups:
        g: {args: [[10], [64]], query-args: [[2]]}
    graph:
      constructor: KNNGraph
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16]], query-args: [[32]]}
"""


def run(scale: str = "default", device=None):
    n = dataset_size(scale)
    records = run_benchmark(f"blobs-euclidean-{n}", CFG, count=10, batch=True,
                            verbose=False, repetitions=REPETITIONS,
                            device=device)
    rows = []
    qsize = METRICS["queriessize"].function
    for r in records:
        rows.append(Row(
            name=f"fig5/{r.instance_name}",
            us_per_call=1e6 / r.qps,
            derived=(f"recall={recall(r):.3f};index_kB={r.index_size_kb:.0f}"
                     f";kB_per_qps={qsize(r):.2f}")))
    return rows
