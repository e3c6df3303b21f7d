"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port's entry points run on CUDA
unless the caller asks for the CPU -- without a card they raise instead of
falling back."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\.|"
                       r"from repro\.|import repro\s*$|from repro import)",
                       re.M)


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = list(_modules())
    assert "repro_torch.ann.ivf" in mods and "repro_torch.core.runner" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    assert not FORBIDDEN.findall(path.read_text())


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points(tmp_path):
    from repro_torch import resolve_device
    from repro_torch.ann import bruteforce, hamming, ivf, lsh, rpforest
    from repro_torch.quant import train_codec
    from repro_torch.ann.distances import pairwise_rows
    from repro_torch.ann.kmeans import kmeans
    from repro_torch.convert import state_from_reference
    from repro_torch.core.experiment import ExperimentSettings, run_definition
    from repro_torch.core.config import Definition
    from repro_torch.data import exact_knn, get_dataset

    X = np.random.default_rng(0).standard_normal((60, 8)).astype(np.float32)
    bf = Definition(algorithm="bf", constructor="BruteForce", module=None,
                    arguments=("euclidean", "pallas"),
                    query_argument_groups=((),))
    codes = np.random.default_rng(1).integers(
        0, 2**32, (60, 2), dtype=np.uint64).astype(np.uint32)
    return {
        "resolve_device": lambda dev: resolve_device(dev),
        "hyperplane_build": lambda dev: lsh.hyperplane_build(
            X, n_tables=2, n_bits=4, device=dev),
        "e2lsh_build": lambda dev: lsh.e2lsh_build(X, n_tables=2,
                                                   device=dev),
        "rpforest.build": lambda dev: rpforest.build(X, n_trees=2,
                                                     device=dev),
        "hamming.bruteforce_build": lambda dev: hamming.bruteforce_build(
            codes, backend="pallas", device=dev),
        "bitsampling_build": lambda dev: hamming.bitsampling_build(
            codes, n_trees=2, device=dev),
        "mih_build": lambda dev: hamming.mih_build(codes, n_chunks=4,
                                                   device=dev),
        "train_codec": lambda dev: train_codec(
            X, {"pq": {"m": 2, "bits": 2}}, metric="euclidean", device=dev),
        "quantized bruteforce.build": lambda dev: bruteforce.build(
            X, quantize="int8", adc_kernel=True, device=dev),
        "get_dataset": lambda dev: get_dataset(
            "blobs-euclidean-300", data_dir=tmp_path, device=dev),
        "exact_knn": lambda dev: exact_knn(X, X[:4], 3, "euclidean",
                                           device=dev),
        "kmeans": lambda dev: kmeans(X, 4, n_iters=2, device=dev),
        "bruteforce.build": lambda dev: bruteforce.build(
            X, backend="pallas", device=dev),
        "ivf.build": lambda dev: ivf.build(X, n_clusters=4, device=dev),
        "pairwise_rows": lambda dev: pairwise_rows(
            X[:4], X, np.zeros((4, 2), np.int64), "euclidean", device=dev),
        "state_from_reference": lambda dev: state_from_reference(
            "BruteForce", "euclidean", {"X": X}, {"n": 60}, device=dev),
        "run_definition": lambda dev: run_definition(
            bf, get_dataset("blobs-euclidean-300", data_dir=tmp_path,
                            device="cpu"),
            ExperimentSettings(count=3, batch_mode=True, device=dev)),
    }


ENTRY_POINTS = ["resolve_device", "get_dataset", "exact_knn", "kmeans",
                "bruteforce.build", "ivf.build", "pairwise_rows",
                "state_from_reference", "run_definition",
                "hyperplane_build", "e2lsh_build", "rpforest.build",
                "hamming.bruteforce_build", "bitsampling_build", "mih_build",
                "train_codec", "quantized bruteforce.build"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_without_cuda(no_cuda, tmp_path, name):
    fn = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(None)
    fn("cpu")                          # an explicit cpu runs


def test_runner_cli_requires_config_and_honours_device(no_cuda, tmp_path,
                                                       monkeypatch):
    from repro_torch.core import runner

    with pytest.raises(SystemExit):
        runner.main(["--dataset", "blobs-euclidean-300"])
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("float:\n  euclidean:\n    bf:\n      constructor: "
                   "BruteForce\n      base-args: ['@metric']\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.main(["--dataset", "blobs-euclidean-300", "--config",
                     str(cfg), "--out", str(tmp_path / "r")])
