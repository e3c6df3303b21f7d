"""Paper Figure 11 + §4.4: batch mode vs single-query mode, as
``benchmarks/bench_batch_mode.py`` of the reference.

The paper's GPU result (batched FAISS-IVF 20-30x over CPU; HNSW batched
3-5x over non-batched): device-resident batched querying against one call
per query.  Also compares the fused distance + top-k kernel
(``"pallas"``: ``kernels/csrc/stream_topk.cu``) against the two-pass torch
path (``"jnp"``: distance matrix, then a stable top-k).
"""

from __future__ import annotations

from repro_torch.benchmarks.common import REPETITIONS, Row, dataset_size
from repro_torch.core.metrics import recall
from repro_torch.core.runner import run_benchmark

CFG_BASE = """
float:
  euclidean:
    bruteforce: {constructor: BruteForce, base-args: ["@metric"]}
    bruteforce-fused:
      constructor: BruteForce
      base-args: ["@metric", "pallas"]
    ivf:
      constructor: IVF
      base-args: ["@metric"]
      run-groups:
        g: {args: [[64]], query-args: [[8]]}
"""


def run(scale: str = "default", device=None):
    n = dataset_size(scale)
    ds = f"blobs-euclidean-{n}"
    rows = []
    for batch in (False, True):
        records = run_benchmark(ds, CFG_BASE, count=10, batch=batch,
                                verbose=False, repetitions=REPETITIONS,
                                device=device)
        for r in records:
            mode = "batch" if batch else "single"
            rows.append(Row(
                name=f"fig11/{mode}/{r.instance_name}",
                us_per_call=1e6 / r.qps,
                derived=f"recall={recall(r):.3f};qps={r.qps:.0f}"))
    # derived speedup summary rows
    by = {r.name: r for r in rows}
    for algo in ("bruteforce(euclidean)", "ivf(euclidean_64)"):
        s = by.get(f"fig11/single/{algo}")
        b = by.get(f"fig11/batch/{algo}")
        if s and b and b.us_per_call > 0:
            rows.append(Row(
                name=f"fig11/speedup/{algo}",
                us_per_call=b.us_per_call,
                derived=f"batch_speedup={s.us_per_call / b.us_per_call:.1f}x"))
    return rows
