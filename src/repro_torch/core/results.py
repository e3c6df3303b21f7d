"""Results store (paper §3.6).

A numpy-only copy of ``repro.core.results``, kept so that the port imports
nothing of the JAX package.

Each run is one ``.npz`` file (+ embedded JSON attrs) in a directory
hierarchy that encodes the configuration:

    <root>/<dataset>/<count>/<batch|single>/<algorithm>/<instance>__q=<args>.npz

"Keeping runs in separate files makes them easy to enumerate and easy to
re-run, and individual results — or sets of results — can easily be shared."
Metric values are NOT stored: they are always recomputed from the raw run by
the metric registry, so new metrics apply to old runs without re-running the
algorithms.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core.metrics import RunRecord


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.=,()\[\]-]", "_", str(s))


def run_path(root: str | Path, record: RunRecord) -> Path:
    mode = "batch" if record.batch_mode else "single"
    qa = ",".join(str(a) for a in record.query_arguments) or "none"
    return (
        Path(root)
        / _slug(record.dataset)
        / str(record.count)
        / mode
        / _slug(record.algorithm)
        / f"{_slug(record.instance_name)}__q={_slug(qa)}.npz"
    )


def store(root: str | Path, record: RunRecord) -> Path:
    path = run_path(root, record)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {
        "algorithm": record.algorithm,
        "instance_name": record.instance_name,
        "query_arguments": list(record.query_arguments),
        "dataset": record.dataset,
        "count": record.count,
        "batch_mode": record.batch_mode,
        "total_time": record.total_time,
        "build_time": record.build_time,
        "index_size_kb": record.index_size_kb,
        "attrs": _jsonable(record.attrs),
    }
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp,
        neighbors=record.neighbors,
        distances=record.distances,
        gt_neighbors=record.gt_neighbors,
        gt_distances=record.gt_distances,
        query_times=record.query_times,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)  # atomic publish
    return path


def load(path: str | Path) -> RunRecord:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        return RunRecord(
            algorithm=meta["algorithm"],
            instance_name=meta["instance_name"],
            query_arguments=tuple(meta["query_arguments"]),
            dataset=meta["dataset"],
            count=int(meta["count"]),
            batch_mode=bool(meta["batch_mode"]),
            neighbors=z["neighbors"],
            distances=z["distances"],
            gt_neighbors=z["gt_neighbors"],
            gt_distances=z["gt_distances"],
            query_times=z["query_times"],
            total_time=float(meta["total_time"]),
            build_time=float(meta["build_time"]),
            index_size_kb=float(meta["index_size_kb"]),
            attrs=meta.get("attrs", {}),
        )


def enumerate_runs(
    root: str | Path,
    dataset: Optional[str] = None,
    count: Optional[int] = None,
    batch_mode: Optional[bool] = None,
    algorithm: Optional[str] = None,
) -> Iterator[Path]:
    root = Path(root)
    if not root.exists():
        return
    pattern = [
        _slug(dataset) if dataset else "*",
        str(count) if count is not None else "*",
        ("batch" if batch_mode else "single") if batch_mode is not None else "*",
        _slug(algorithm) if algorithm else "*",
        "*.npz",
    ]
    yield from sorted(root.glob("/".join(pattern)))


def load_all(root: str | Path, **filters) -> List[RunRecord]:
    return [load(p) for p in enumerate_runs(root, **filters)]


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
