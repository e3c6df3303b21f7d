"""Dataset containers and registry (paper §3.2), as ``repro.data.datasets``.

A dataset file contains — field-for-field the paper's HDF5 schema, stored as
``.npz`` (h5py is unavailable offline):

    train       [n, d]  data points (float32; packed uint32 words for bit data)
    test        [nq, d] query points
    neighbors   [nq, k_gt] true nearest neighbor ids
    distances   [nq, k_gt] their distances, sorted ascending
    metric      euclidean | angular | hamming
    point_type  float | bit

"By default, the framework fetches datasets on demand": here, on-demand means
the synthetic builder runs (deterministically, seeded by name) the first time
a dataset is requested and the file is cached under ``data_dir``.

The schema and the cache directory are the reference's, so one file serves
both packages.  The port writes the file uncompressed (``np.savez``: a
0.5 GB corpus saves in about a second instead of tens); ``np.load`` reads
either form.  Ground truth is computed on ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch import resolve_device

DEFAULT_DATA_DIR = Path(os.environ.get("REPRO_DATA_DIR", "/tmp/repro_data"))
GT_K = 100  # paper: "a list of the true nearest k=100 neighbours"


@dataclasses.dataclass
class Dataset:
    name: str
    train: np.ndarray
    test: np.ndarray
    neighbors: np.ndarray
    distances: np.ndarray
    metric: str
    point_type: str = "float"

    @property
    def dimension(self) -> int:
        # For bit data the logical dimensionality is bits, not words.
        if self.point_type == "bit":
            return int(self.train.shape[1]) * 32
        return int(self.train.shape[1])

    @property
    def n(self) -> int:
        return int(self.train.shape[0])

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {"name": self.name, "metric": self.metric,
                "point_type": self.point_type}
        tmp = path.with_suffix(".tmp.npz")
        np.savez(
            tmp, train=self.train, test=self.test, neighbors=self.neighbors,
            distances=self.distances,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path: str | Path) -> "Dataset":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            return Dataset(
                name=meta["name"], train=z["train"], test=z["test"],
                neighbors=z["neighbors"], distances=z["distances"],
                metric=meta["metric"], point_type=meta["point_type"])


# --------------------------------------------------------------------------
# registry: name pattern -> builder
# --------------------------------------------------------------------------

_BUILDERS: Dict[str, Callable[..., Dataset]] = {}


def register_dataset(pattern: str):
    """Register a builder for names matching ``pattern`` (regex with named
    groups passed to the builder as ints where they look numeric)."""
    def deco(fn):
        _BUILDERS[pattern] = fn
        return fn
    return deco


def get_dataset(name: str, data_dir: Optional[str | Path] = None,
                device=None) -> Dataset:
    """Load ``name`` from the cache, or build it (ground truth on
    ``device``, ``cuda`` unless told otherwise) and cache it."""
    dev = resolve_device(device)
    data_dir = Path(data_dir or os.environ.get("REPRO_DATA_DIR",
                                               DEFAULT_DATA_DIR))
    cache = data_dir / f"{name}.npz"
    if cache.exists():
        return Dataset.load(cache)
    for pattern, builder in _BUILDERS.items():
        m = re.fullmatch(pattern, name)
        if m:
            kwargs = {
                k: (int(v) if v is not None and v.isdigit() else v)
                for k, v in m.groupdict().items()
            }
            ds = builder(name=name, device=dev, **kwargs)
            ds.save(cache)
            return ds
    raise KeyError(f"unknown dataset {name!r}; known patterns: "
                   f"{list(_BUILDERS)}")


def available_patterns():
    return list(_BUILDERS)


# builders register themselves on import
from repro_torch.data import synthetic as _synthetic  # noqa: E402,F401
