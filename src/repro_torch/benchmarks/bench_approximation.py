"""Paper Figure 8 + Q3: effect of (1+eps)-approximate recall, as
``benchmarks/bench_approximation.py`` of the reference.

Same runs scored at eps in {0, 0.01, 0.1} -- no re-execution needed (the
results layer recomputes metrics from stored raw runs, §3.6).
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
        g: {args: [[64]], query-args: [[1, 4, 16]]}
    rpforest:
      constructor: RPForest
      base-args: ["@metric"]
      run-groups:
        g: {args: [[6], [64]], query-args: [[1]]}
"""


def run(scale: str = "default", device=None):
    n = dataset_size(scale)
    records = run_benchmark(f"mnist-like-{n}", CFG, count=10, batch=True,
                            verbose=False, repetitions=REPETITIONS,
                            device=device)
    rows = []
    for r in records:
        r0, r1, r10 = recall(r, 0.0), recall(r, 0.01), recall(r, 0.1)
        assert r10 >= r1 >= r0 - 1e-9
        rows.append(Row(
            name=f"fig8/{r.instance_name}/q={r.query_arguments}",
            us_per_call=1e6 / r.qps,
            derived=f"recall={r0:.3f};eps0.01={r1:.3f};eps0.1={r10:.3f}"))
    return rows
