"""``bench_sharded``'s wire-bytes gate over fresh draws of its data set.

The synthetic sets are seeded by ``hash(name)``, which Python randomizes
per process, so each run of ``bench_sharded`` on an empty data directory
draws a new ``blobs-euclidean-<n>``.  This script runs the gate's phase
(``bench_sharded._bytes_phase``: the int8 merge tree at 8 shards against
the exact search) once per draw, each in a fresh process with
``PYTHONHASHSEED`` set to the draw's number and a data directory of its
own, and prints one JSON line per draw: the recall over every test query
(the gate's figure) and over the first ``QBATCH`` (the reference's).

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_wire_recall \
        [--draws 24] [--n 20000] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_CHILD = """
import json, sys
from repro_torch import resolve_device
from repro_torch.benchmarks import bench_sharded
from repro_torch.dist.mesh import force_device_count
force_device_count(max(bench_sharded.SHARDS))
_, ok, extra = bench_sharded._bytes_phase(int(sys.argv[1]),
                                          resolve_device(sys.argv[2]))
print(json.dumps({"gate": ok, **extra}))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--draws", type=int, default=24)
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    failed = 0
    for draw in range(args.draws):
        with tempfile.TemporaryDirectory() as data_dir:
            env = dict(os.environ, PYTHONHASHSEED=str(draw),
                       REPRO_DATA_DIR=data_dir)
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, str(args.n), args.device],
                env=env, capture_output=True, text=True, check=True)
        rec = {"draw": draw, "n": args.n,
               **json.loads(out.stdout.strip().splitlines()[-1])}
        failed += not rec["gate"]
        print(json.dumps(rec), flush=True)
    print(json.dumps({"draws": args.draws, "gate_failed": failed}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
