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
    distance/      only the distance epilogue and oracle kernel 1 needs

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

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_K = 256          # largest k of the top-k kernels (see csrc/*.cu)

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
    :data:`BUILD_INFO`; raises with the compiler's output on failure."""
    out = _build_dir()
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
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
