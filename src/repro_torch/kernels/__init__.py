"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their loader.

Each kernel lives in its own subpackage, mirroring ``repro.kernels``:

    <name>.py   the launch wrapper (ctypes call into ``csrc/<name>.cu``, with
                a launch counter) and the kernel's plain PyTorch version
    ops.py      the public wrapper (operand prep, masking, id remapping)
    ref.py      plain torch oracles the tests hold the kernels against

Kernels:
    distance_topk/ streaming fused distance + top-k (replaces
                   ``repro.kernels.distance_topk.stream_topk_pallas``)
    rerank_topk/   fused candidate gather + rerank + unique top-k (replaces
                   ``repro.kernels.rerank_topk.rerank_topk_pallas``)
    hamming/       XOR + popcount top-k over packed codes (replaces
                   ``repro.kernels.hamming.hamming_topk_pallas``)
    adc_scan/      ADC table-lookup scan + top-C (replaces
                   ``repro.kernels.adc_scan.adc_scan_pallas``)
    distance/      tiled distance matrix (replaces
                   ``repro.kernels.distance.distance_matrix_pallas``), and
                   the distance epilogue kernel 1 shares
    embedbag/      embedding-bag weighted gather-sum (replaces
                   ``repro.kernels.embedbag.embedding_bag_pallas``)
    decode_attn/   single-token GQA decode attention with online softmax
                   (replaces
                   ``repro.kernels.decode_attn.decode_attention_pallas``)

Kernels 1-4 keep their running top-k lists in shared memory, so they take
k <= ``MAX_K`` (C <= ``adc_scan.MAX_C``).  Above that each public op takes
a distances-out route: a second entry of the same source (or, for kernel
1, the distance-matrix kernel) writes a chunk of queries' distances into a
buffer of at most ``ROUTE_BYTES``, and a stable sort selects by (dist, id).

Build: every ``csrc/*.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (one ``nvcc`` process per source, all
started together) and loaded with ``ctypes``.  That happens at first use,
into ``build/kernels/<hash>/`` at the repository root (override with
``REPRO_TORCH_BUILD_DIR``), keyed by a hash of the sources and flags, so
an unchanged tree never rebuilds.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_K = 256          # largest k of the top-k kernels (see csrc/*.cu)
# The distances-out routes (k above MAX_K, C above adc_scan.MAX_C) write a
# [rows, n] float32 buffer per chunk of queries; this caps one chunk's.
ROUTE_BYTES = 2 << 30

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, str] = {}


def _build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return _build_root() / h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def build_all() -> Path:
    """Compile every ``csrc/*.cu`` that is not built yet, in parallel.

    Records each source's ``ptxas`` report (registers, spills) in
    :data:`BUILD_INFO`, and beside its library, from where a later process
    that finds the library built reads it; raises with the compiler's
    output on failure."""
    out = _build_dir()
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
    for src in _sources():
        log = out / f"lib{src.stem}.ptxas.txt"
        if src not in todo and src.stem not in BUILD_INFO and log.exists():
            BUILD_INFO[src.stem] = log.read_text()
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_INFO[src.stem] = log
        if proc.returncode != 0:
            errors.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        (out / f"lib{src.stem}.ptxas.txt").write_text(log)
        os.replace(tmp, out / f"lib{src.stem}.so")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def by_query_chunks(rows: int, dists, ids: torch.Tensor, k: int, *,
                    unique: bool = False):
    """A distances-out route: the k smallest (dist, id) of each of ``rows``
    query rows.  ``dists(start, end)`` writes the [end - start, L] float32
    distances of query rows [start, end); ``ids`` is the [L] id row every
    query shares or a [rows, L] window.  The chunks keep that buffer within
    :data:`ROUTE_BYTES`.  Each chunk selects by a stable sort on (dist, id)
    (``merge_topk_rounds``), or with ``unique`` each id once at its
    smallest distance (``merge_topk_unique_rounds``)."""
    # deferred: both modules import this package
    from repro_torch.kernels.distance_topk.distance_topk import \
        merge_topk_rounds
    from repro_torch.kernels.rerank_topk.rerank_topk import \
        merge_topk_unique_rounds

    merge = merge_topk_unique_rounds if unique else merge_topk_rounds
    step = max(1, ROUTE_BYTES // (4 * max(1, ids.shape[-1])))
    parts = []
    for s in range(0, rows, step):
        e = min(s + step, rows)
        part = ids[s:e] if ids.dim() == 2 else ids.expand(e - s, -1)
        parts.append(merge(dists(s, e), part, k))
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))
