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
    assert {"repro_torch.benchmarks.run", "repro_torch.kernels.distance.ops",
            "repro_torch.kernels.embedbag.ops",
            "repro_torch.kernels.decode_attn.ops", "repro_torch.tune",
            "repro_torch.tune.tuner", "repro_torch.launch.knobs",
            "repro_torch.launch.tune", "repro_torch.mutate",
            "repro_torch.mutate.delta", "repro_torch.benchmarks.bench_sweep",
            "repro_torch.benchmarks.bench_tune",
            "repro_torch.benchmarks.bench_pq",
            "repro_torch.benchmarks.sweep_rerank_block",
            "repro_torch.benchmarks.sweep_churn",
            "repro_torch.benchmarks.sweep_build", "repro_torch.serve",
            "repro_torch.serve.errors", "repro_torch.serve.faults",
            "repro_torch.serve.checkpoint", "repro_torch.serve.engine",
            "repro_torch.benchmarks.bench_engine",
            "repro_torch.serve.retry", "repro_torch.serve.metrics",
            "repro_torch.serve.async_engine",
            "repro_torch.launch.serve",
            "repro_torch.benchmarks.sweep_serving", "repro_torch.dist",
            "repro_torch.dist.mesh", "repro_torch.dist.wire",
            "repro_torch.dist.sharding", "repro_torch.dist.collectives",
            "repro_torch.dist.shard_state",
            "repro_torch.dist.grad_compression",
            "repro_torch.dist.compression", "repro_torch.ann.sharded",
            "repro_torch.benchmarks.bench_sharded",
            "repro_torch.benchmarks.bench_availability",
            "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.flash", "repro_torch.models.moe",
            "repro_torch.models.transformer", "repro_torch.configs",
            "repro_torch.configs.registry", "repro_torch.configs.shapes",
            "repro_torch.configs.phi4_mini_3_8b",
            "repro_torch.configs.gemma3_27b",
            "repro_torch.configs.qwen1_5_32b",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.deepseek_v2_236b"} <= set(mods)
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
    from repro_torch.ann import (bruteforce, graph, hamming, hnsw, ivf, lsh,
                                 rpforest)
    from repro_torch.quant import train_codec
    from repro_torch.ann.distances import pairwise_rows
    from repro_torch.ann.kmeans import kmeans
    from repro_torch.convert import state_from_reference
    from repro_torch.core.experiment import ExperimentSettings, run_definition
    from repro_torch.core.config import Definition
    from repro_torch.data import exact_knn, get_dataset
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.distance import distance_matrix
    from repro_torch.kernels.embedbag import embedding_bag
    from repro_torch.kernels.hamming import hamming_topk
    from repro_torch import mutate
    from repro_torch.benchmarks import bench_sweep
    from repro_torch.launch import tune as tune_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import AsyncEngine, Engine, checkpoint, load_state
    from repro_torch.ann import sharded
    from repro_torch.benchmarks import bench_availability, bench_sharded
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.models import transformer

    lm = get_arch("phi4-mini-3.8b").make_smoke_config()

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
        "hamming_topk": lambda dev: hamming_topk(codes[:3], codes, k=2,
                                                 device=dev),
        "distance_matrix": lambda dev: distance_matrix(X[:3], X,
                                                       device=dev),
        "embedding_bag": lambda dev: embedding_bag(
            X, [0, 5, 7], [0, 0, 1], n_bags=2, device=dev),
        "decode_attention": lambda dev: decode_attention(
            X[:2].reshape(2, 1, 8), X[:40].reshape(2, 20, 1, 8),
            X[20:60].reshape(2, 20, 1, 8), device=dev),
        "benchmarks.run": lambda dev: bench_run.main(
            ["--scale", "smoke", "--only", "stream"]
            + ([] if dev is None else ["--device", dev])),
        "graph.build": lambda dev: graph.build(X, degree=4, device=dev),
        "hnsw.build": lambda dev: hnsw.build(X, M=4, ef_construction=8,
                                             device=dev),
        "benchmarks.run fig8": lambda dev: _figure_bench(dev),
        "MutableBruteForce build": lambda dev: mutate.BRUTEFORCE_SPEC.build(
            X, delta_capacity=4, device=dev),
        "MutableIVF build": lambda dev: mutate.IVF_SPEC.build(
            X, n_clusters=4, delta_capacity=4, device=dev),
        "launch.tune": lambda dev: tune_cli.main(
            ["--dataset", "blobs-euclidean-300", "--build", "n_clusters=4",
             "--grid", "n_probes=1,2", "--nq", "8", "--repetitions", "1",
             "--min-recall", "0.1"]
            + ([] if dev is None else ["--device", dev])),
        "bench_sweep": lambda dev: bench_sweep.run("smoke", dev),
        "Engine.build": lambda dev: Engine.build(
            "IVF", X, metric="euclidean", build_params={"n_clusters": 4},
            device=dev),
        "Engine.load": lambda dev: Engine.load(_checkpoint_file(tmp_path, X),
                                               device=dev),
        "checkpoint.load": lambda dev: checkpoint.load(
            _checkpoint_file(tmp_path, X), device=dev),
        "load_state": lambda dev: load_state(_checkpoint_file(tmp_path, X),
                                             device=dev),
        "AsyncEngine.load": lambda dev: AsyncEngine.load(
            _checkpoint_file(tmp_path, X), device=dev).close(),
        "launch.serve": lambda dev: serve_cli.main(
            ["--dataset", "blobs-euclidean-300", "--build", "n_clusters=4",
             "--n-batches", "1", "--batch-size", "8"]
            + ([] if dev is None else ["--device", dev])),
        "sharded.bruteforce_build": lambda dev: sharded.bruteforce_build(
            X, n_shards=1, device=dev),
        "sharded.ivf_build": lambda dev: sharded.ivf_build(
            X, n_clusters=4, n_shards=1, device=dev),
        "bench_sharded": lambda dev: bench_sharded.run("smoke", dev),
        "bench_availability": lambda dev: bench_availability.run("smoke",
                                                                  dev),
        "transformer.init": lambda dev: transformer.init(0, lm, device=dev),
        "transformer.init_cache": lambda dev: transformer.init_cache(
            lm, 1, 8, device=dev),
        "lm_params_from_reference": lambda dev: lm_params_from_reference(
            {"embed": X, "runs": [{"w": X[None]}]}, device=dev),
    }


def _checkpoint_file(tmp_path, X):
    """A checkpoint written on the CPU (saving needs no device), for the
    loaders to read."""
    from repro_torch.ann import bruteforce
    from repro_torch.serve import checkpoint

    path = tmp_path / "bf.ckpt"
    if not path.exists():
        checkpoint.save(path, bruteforce.build(X, device="cpu"))
    return path


def _figure_bench(dev):
    """The cheapest figure bench through the entry point; an explicit
    ``cpu`` must run it to its end."""
    from repro_torch.benchmarks import run as bench_run

    rc = bench_run.main(["--scale", "smoke", "--only", "fig8"]
                        + ([] if dev is None else ["--device", dev]))
    assert rc == 0


ENTRY_POINTS = ["resolve_device", "get_dataset", "exact_knn", "kmeans",
                "bruteforce.build", "ivf.build", "pairwise_rows",
                "state_from_reference", "run_definition",
                "hyperplane_build", "e2lsh_build", "rpforest.build",
                "hamming.bruteforce_build", "bitsampling_build", "mih_build",
                "train_codec", "quantized bruteforce.build",
                "hamming_topk", "distance_matrix", "embedding_bag",
                "decode_attention", "benchmarks.run", "graph.build",
                "hnsw.build", "benchmarks.run fig8",
                "MutableBruteForce build", "MutableIVF build", "launch.tune",
                "bench_sweep", "Engine.build", "Engine.load",
                "checkpoint.load", "load_state", "AsyncEngine.load",
                "launch.serve", "sharded.bruteforce_build",
                "sharded.ivf_build", "bench_sharded", "bench_availability",
                "transformer.init", "transformer.init_cache",
                "lm_params_from_reference"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_without_cuda(no_cuda, tmp_path, monkeypatch,
                                        name):
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))   # the benches' cache
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


def test_embedbag_sweep_refuses_without_cuda(no_cuda):
    """Kernel 6's plan sweep measures the card: without one it stops.  The
    import test above loads it with every port module (no JAX)."""
    from repro_torch.benchmarks import sweep_embedbag_plan

    assert "repro_torch.benchmarks.sweep_embedbag_plan" in _modules()
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        sweep_embedbag_plan.main()


@pytest.mark.parametrize("name", ["sweep_rerank_block", "sweep_churn",
                                  "sweep_build", "sweep_serving"])
def test_card_sweeps_refuse_without_cuda(no_cuda, name):
    """The rerank-block, churn, build and serving sweeps measure the card:
    without one they stop before building anything."""
    import importlib

    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        mod.main()
