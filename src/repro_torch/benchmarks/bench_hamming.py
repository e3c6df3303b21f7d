"""Paper Figure 9 + Q4: Hamming-space embeddings, as
``benchmarks/bench_hamming.py`` of the reference.

Compares Hamming-aware implementations (popcount brute force, bitsampling-
Annoy, MIH) on packed binary data -- the paper's finding is that Hamming-
aware node splitting + popcount wins on low-dim codes.  The
``"pallas"`` backend is the port's hand-written popcount top-k kernel
(``kernels/csrc/hamming_topk.cu``).
"""

from __future__ import annotations

from repro_torch.benchmarks.common import REPETITIONS, Row, dataset_size
from repro_torch.core.metrics import recall
from repro_torch.core.runner import run_benchmark

CFG = """
bit:
  hamming:
    bruteforce-hamming:
      constructor: BruteForceHamming
      base-args: ["@metric"]
    bruteforce-hamming-pallas:
      constructor: BruteForceHamming
      base-args: ["@metric", "pallas"]
    bitsampling-annoy:
      constructor: BitsamplingAnnoy
      base-args: ["@metric"]
      run-groups:
        g: {args: [[10], [64]], query-args: [[1, 3]]}
    mih:
      constructor: MultiIndexHashing
      base-args: ["@metric"]
      run-groups:
        g: {args: [[16], [256]], query-args: [[0, 1]]}
"""


def run(scale: str = "default", device=None):
    n = dataset_size(scale)
    records = run_benchmark(f"random-hamming-{n}-b256", CFG, count=10,
                            batch=True, verbose=False, repetitions=REPETITIONS,
                            device=device)
    return [
        Row(name=f"fig9/{r.instance_name}/q={r.query_arguments}",
            us_per_call=1e6 / r.qps,
            derived=f"recall={recall(r):.3f}")
        for r in records
    ]
