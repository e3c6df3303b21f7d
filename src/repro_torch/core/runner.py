"""Main experiment driver (the paper's ``run.py`` front-end), as
``repro.core.runner``.

Usage:
    PYTHONPATH=src python -m repro_torch.core.runner \
        --dataset blobs-euclidean-1000000-d128 --config my_config.yaml \
        --count 10 --batch --out results/ [--device cpu]

``--config`` is required (a YAML file, which needs PyYAML).  The run goes
on ``cuda`` unless ``--device cpu`` is given.

Runs every expanded algorithm instance from the config against the dataset,
stores one result file per (instance, query-args) run, and prints the
frontier summary.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

from repro_torch.core import config as config_mod
from repro_torch.core import results as results_mod
from repro_torch.core.experiment import ExperimentSettings, run_definition
from repro_torch.core.metrics import RunRecord
from repro_torch.core.plotting import ascii_frontier
from repro_torch.data.datasets import get_dataset


def run_benchmark(
    dataset_name: str,
    config_source,
    *,
    count: int = 10,
    batch: bool = False,
    algorithms: Optional[Sequence[str]] = None,
    out_dir: Optional[str] = None,
    isolated: bool = False,
    timeout: Optional[float] = None,
    repetitions: int = 1,
    query_block: Optional[int] = None,
    verbose: bool = True,
    device=None,
) -> List[RunRecord]:
    """Run every definition of ``config_source`` (a dict, YAML string or
    path) on the dataset.  As in the reference, a definition that fails
    with ``RuntimeError`` / ``TimeoutError`` is reported and skipped, so a
    caller that needs every definition must check the records it gets."""
    dataset = get_dataset(dataset_name, device=device)
    definitions = config_mod.get_definitions(
        config_source,
        point_type=dataset.point_type,
        metric=dataset.metric,
        dimension=dataset.dimension,
        count=count,
        algorithms=algorithms,
    )
    settings = ExperimentSettings(
        count=count, batch_mode=batch, isolated=isolated,
        timeout=timeout, repetitions=repetitions, query_block=query_block,
        device=device,
    )
    all_records: List[RunRecord] = []
    for definition in definitions:
        label = definition.instance_name
        t0 = time.perf_counter()
        try:
            records = run_definition(definition, dataset, settings)
        except (TimeoutError, RuntimeError) as e:
            if verbose:
                print(f"  [FAIL] {label}: {e}", file=sys.stderr)
            continue
        if verbose:
            dt = time.perf_counter() - t0
            print(f"  [ok] {label}: {len(records)} runs in {dt:.1f}s")
        for record in records:
            if out_dir:
                results_mod.store(out_dir, record)
        all_records.extend(records)
    return all_records


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--batch", action="store_true")
    p.add_argument("--algorithm", action="append", dest="algorithms")
    p.add_argument("--out", default="results")
    p.add_argument("--isolated", action="store_true")
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--query-block", type=int, default=None,
                   help="batch mode: stream queries in blocks of this size "
                        "(fixed memory for arbitrarily large query sets)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    records = run_benchmark(
        args.dataset, args.config, count=args.count, batch=args.batch,
        algorithms=args.algorithms, out_dir=args.out, isolated=args.isolated,
        timeout=args.timeout, repetitions=args.repetitions,
        query_block=args.query_block, device=args.device,
    )
    if records:
        print()
        print(ascii_frontier(records))


if __name__ == "__main__":
    main()
