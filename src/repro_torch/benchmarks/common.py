"""Shared benchmark infrastructure (``benchmarks/common.py`` of the
reference).

Each benchmark module exposes ``run(scale, device) -> list[Row]``.  Rows
print as ``name,us_per_call,derived`` CSV.  The figure benches size their
datasets by :func:`dataset_size`.  On the card a time is device
time by CUDA events; on the CPU (``--device cpu``) it is the host clock of
the plain versions, a check that the path runs and no device metric.  The
bounds in ``derived`` come from the card's published peaks (:data:`PEAKS`)
and are printed only for runs on the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import time
from typing import Callable, List, Optional, Sequence, Union

import torch

from repro_torch import sync

# NVIDIA H100 data sheet, dense, without tensor cores for fp32:
# (fp32 FLOP/s, memory bytes/s) per form factor
PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12),
         "NVL": (60e12, 3.9e12)}
# CUDA C++ programming guide, arithmetic instruction throughput, compute
# capability 9.0: 32-bit population counts per clock per SM; and the
# shared-memory rate of 32 four-byte words per clock per SM
POPC_PER_CLOCK_SM = 16
LDS_WORDS_PER_CLOCK_SM = 32


@dataclasses.dataclass
class Row:
    name: str
    us_per_call: float
    derived: str = ""

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.1f},{self.derived}"


def write_bench_json(name: str, rows: List["Row"], *, scale: str,
                     extra: Optional[dict] = None,
                     out_dir: Optional[str] = None) -> pathlib.Path:
    """Machine-readable artifact ``BENCH_<name>.json`` in ``out_dir`` (or
    ``REPRO_BENCH_DIR``, or the working directory).  Schema: ``{bench,
    scale, rows: [{name, us_per_call, derived}], extra}``."""
    out = pathlib.Path(out_dir or os.environ.get("REPRO_BENCH_DIR", "."))
    out.mkdir(parents=True, exist_ok=True)
    payload = {
        "bench": name,
        "scale": scale,
        "unix_time": time.time(),
        "rows": [dataclasses.asdict(r) for r in rows],
        "extra": extra or {},
    }
    path = out / f"BENCH_{name}.json"
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


def timed(fn: Callable, *args, n: int = 3, warmup: int = 1,
          device=None) -> float:
    """Best-of-n microseconds per call: device time between CUDA events
    on a CUDA ``device``, the host clock otherwise."""
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn(*args)
    best = float("inf")
    for _ in range(n):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def best_s(fn: Callable, device, n: int = 5, warmup: int = 2) -> float:
    """Best-of-n host seconds of ``fn()``, each call waited for with
    :func:`repro_torch.sync` (the reference benches' ``block_until_ready``
    timing, host launches included)."""
    for _ in range(warmup):
        fn()
    sync(device)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def graph_ms(fn: Union[Callable, Sequence[Callable]],
             reps: int = 20) -> float:
    """Mean device time of a call over ``reps`` calls captured in one CUDA
    graph and replayed once, by CUDA events, after a warm-up call of each:
    the host's cost of a call (a Python wrapper, a ctypes launch) drops
    out, which matters where a kernel runs for tens of microseconds.
    ``fn`` is one callable, or several (the same work on other inputs)
    taken in turn: inputs whose data together exceed the L2 cache keep
    each call's reads as cold as a caller's first."""
    fns = [fn] if callable(fn) else list(fn)
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fns[r % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


SCALES = {
    # dataset size per scale; the figure benches pick n by scale
    "smoke": 2_000,
    "default": 20_000,
    "full": 100_000,
}


# query repetitions of every figure bench's run_benchmark (best of two): the
# first holds each instance's first call (a kernel's load, the allocator's
# first blocks), which no row is meant to time
REPETITIONS = 2


def dataset_size(scale: str) -> int:
    return SCALES.get(scale, SCALES["default"])


def form_factor(name: str) -> str:
    if "PCIe" in name:
        return "PCIe"
    if "NVL" in name:
        return "NVL"
    return "SXM"


def card_peaks(device) -> tuple:
    """(fp32 FLOP/s, bytes/s) of the card ``device`` lies on."""
    return PEAKS[form_factor(torch.cuda.get_device_name(device))]


def max_sm_clock_hz() -> float:
    """The card's top SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(ops: float, nbytes: float, ops_rate: float, bytes_rate: float):
    """(least time in microseconds, what bounds it): the larger of the
    operations over their peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / ops_rate, nbytes / bytes_rate
    if t_ops >= t_bytes:
        return t_ops * 1e6, "operations"
    return t_bytes * 1e6, "bytes"
