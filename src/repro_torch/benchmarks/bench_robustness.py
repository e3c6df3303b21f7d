"""Paper Figure 6 + Q2: robustness on the adversarial Rand-Euclidean
dataset -- locally easy queries, no global structure (as
``benchmarks/bench_robustness.py`` of the reference).

The paper's finding: graph methods relying on "small-world" navigation
degrade here, while locality methods (trees, IVF) stay fast.  ``derived``
reports recall; compare against the same algorithms' Figure-4 recalls.
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
        g: {args: [[64]], query-args: [[4, 16]]}
    rpforest:
      constructor: RPForest
      base-args: ["@metric"]
      run-groups:
        g: {args: [[10], [64]], query-args: [[2]]}
    graph-pure-knn:
      constructor: KNNGraph
      base-args: ["@metric"]
      run-groups:
        # extra_edges=0: pure k-NN graph (the navigability-fragile variant)
        g: {args: [[16], [false], [0]], query-args: [[32]]}
    graph-smallworld:
      constructor: KNNGraph
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16], [false], [2]], query-args: [[32]]}
    hnsw:
      constructor: HNSW
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16], [80]], query-args: [[32]]}
"""


def run(scale: str = "default", device=None):
    n = dataset_size(scale)
    records = run_benchmark(f"random-euclidean-{n}", CFG, count=10, batch=True,
                            verbose=False, repetitions=REPETITIONS,
                            device=device)
    return [
        Row(name=f"fig6/rand-euclidean/{r.instance_name}/q={r.query_arguments}",
            us_per_call=1e6 / r.qps,
            derived=f"recall={recall(r):.3f}")
        for r in records
    ]
