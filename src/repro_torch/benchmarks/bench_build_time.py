"""Paper Figure 10: index build time for indexes reaching recall >= 0.9, as
``benchmarks/bench_build_time.py`` of the reference.

The paper's spread: inverted files build in seconds, graphs take hours
(HNSW's build is a host loop, KNNGraph's takes its edges from the device's
exact k-NN).  ``us_per_call`` here is build time in us; ``derived`` =
recall achieved.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import REPETITIONS, Row, dataset_size
from repro_torch.core.metrics import recall
from repro_torch.core.runner import run_benchmark

CFG = """
float:
  euclidean:
    ivf:
      constructor: IVF
      base-args: ["@metric"]
      run-groups:
        g: {args: [[64]], query-args: [[16]]}
    rpforest:
      constructor: RPForest
      base-args: ["@metric"]
      run-groups:
        g: {args: [[10], [64]], query-args: [[4]]}
    graph:
      constructor: KNNGraph
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16]], query-args: [[64]]}
    hnsw:
      constructor: HNSW
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16], [80]], query-args: [[64]]}
    e2lsh:
      constructor: E2LSH
      base-args: ["@metric"]
      run-groups:
        g: {args: [[8], [6], [2.0], [256]], query-args: [[16]]}
"""


def run(scale: str = "default", device=None):
    n = dataset_size(scale)
    records = run_benchmark(f"blobs-euclidean-{n}", CFG, count=10, batch=True,
                            verbose=False, repetitions=REPETITIONS,
                            device=device)
    rows = []
    for r in records:
        rows.append(Row(
            name=f"fig10/build/{r.instance_name}",
            us_per_call=r.build_time * 1e6,
            derived=f"recall={recall(r):.3f};build_s={r.build_time:.2f}"))
    return rows
