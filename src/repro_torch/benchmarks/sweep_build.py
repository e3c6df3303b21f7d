"""Host seconds and peak device memory of the main set's k-means builds on
the card: IVF with 1,024 lists (10 Lloyd steps on the 10^6 x 128 corpus)
and PQ BruteForce (m = 16, 8 bits: 16 k-means of 256 centers) on
``blobs-euclidean-1000000-d128``, each built ``REPS`` times.

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_build

Needs a CUDA card.  The script imports only what every tree of the port
has, so running it against another tree's package (``PYTHONPATH=<tree>/src
python src/repro_torch/benchmarks/sweep_build.py``) times that tree's
k-means in the same call.  Peak memory is ``torch.cuda.max_memory_
allocated`` during the build, less what was allocated before it (the
corpus copy the build makes included).  It prints one JSON line per build.
"""

from __future__ import annotations

import json
import time

import torch

from repro_torch.ann import bruteforce, ivf
from repro_torch.data import get_dataset

MAIN = "blobs-euclidean-1000000-d128"
REPS = 3
BUILDS = {
    "ivf_1024": lambda X: ivf.build(X, metric="euclidean", n_clusters=1024,
                                    device="cuda"),
    "bf_pq16": lambda X: bruteforce.build(
        X, metric="euclidean", quantize={"pq": {"m": 16, "bits": 8}},
        device="cuda"),
}


def main() -> None:
    import repro_torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_build: needs a CUDA card")
    ds = get_dataset(MAIN, device="cuda")
    for name, build in BUILDS.items():
        for rep in range(REPS):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = build(ds.train)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            print(json.dumps({"build": name, "rep": rep, "seconds": seconds,
                              "peak_bytes": int(peak),
                              "package": repro_torch.__file__}),
                  flush=True)
            del state


if __name__ == "__main__":
    main()
