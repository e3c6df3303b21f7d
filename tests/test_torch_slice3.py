"""The third slice of the port as a whole.

1. The distances-out routes that lift the port's k and C limits, each
   against the JAX package's op on the CPU at k = 300 (C = 1,500 for the
   ADC scan): ``stream_topk``, ``hamming_topk``, ``rerank_topk(use_kernel=
   True)`` and ``adc_scan(use_kernel=True)``.  The reference's ops run as
   its own tests run them (Pallas in interpret mode, or the XLA fold); the
   port runs the routes' plain distance passes, which is what its wrappers
   do with CPU tensors.  Integer-valued inputs make every fp32 distance
   exact, so ids and distances are held bitwise; the ADC scan is held as
   ``test_torch_quant.py`` holds it (rtol=1e-5, atol=1e-5; ids outside the
   reference's near ties).
2. The kernel-benchmark entry point, ``python -m repro_torch.benchmarks.run
   --only kernels,stream --device cpu``: it runs, its rows name what the
   reference's rows name, its gates hold, and it prints no TPU constant.
"""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.adc_scan import adc_scan as jx_adc_scan  # noqa: E402
from repro.kernels.distance_topk import stream_topk as jx_stream  # noqa: E402
from repro.kernels.distance_topk import (  # noqa: E402
    stream_topk_batched as jx_stream_batched)
from repro.kernels.hamming import hamming_topk as jx_hamming  # noqa: E402
from repro.kernels.rerank_topk import rerank_topk as jx_rerank  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.adc_scan import MAX_C, adc_scan  # noqa: E402
from repro_torch.kernels.distance_topk import (stream_topk,  # noqa: E402
                                               stream_topk_batched)
from repro_torch.kernels.hamming import hamming_topk  # noqa: E402
from repro_torch.kernels.rerank_topk import rerank_topk  # noqa: E402

K = 300


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _codes(rng, n, w):
    return rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)


def assert_bitwise(want, got):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.fixture()
def small_route_buffer(monkeypatch):
    """A route buffer of a few rows, so every route runs several chunks."""
    monkeypatch.setattr(kernels, "ROUTE_BYTES", 3 * 4 * 1000)


@pytest.mark.parametrize("metric", ["euclidean", "ip", "angular"])
def test_stream_topk_above_max_k_matches_reference(metric,
                                                   small_route_buffer):
    rng = np.random.default_rng(len(metric))
    Q, X = _ints(rng, (11, 16)), _ints(rng, (900, 16))
    valid = rng.random(900) < 0.9
    row_ids = rng.permutation(900).astype(np.int32)
    want = jx_stream(Q, X, k=K, metric=metric, valid=valid, row_ids=row_ids)
    got = stream_topk(Q, torch.as_tensor(X), k=K, metric=metric,
                      valid=valid, row_ids=row_ids)
    assert K > kernels.MAX_K
    assert_bitwise(want, got)
    want = jx_stream_batched(Q, X, k=K, metric=metric, query_block=6)
    got = stream_topk_batched(Q, torch.as_tensor(X), k=K, metric=metric,
                              query_block=6)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_hamming_topk_above_max_k_matches_reference(small_route_buffer):
    rng = np.random.default_rng(1)
    X = _codes(rng, 1000, 4)
    Q = np.concatenate([X[:5], _codes(rng, 6, 4)])
    want = jx_hamming(Q, X, k=K, bn=128, interpret=True)
    assert_bitwise(want, hamming_topk(Q, X, k=K, bn=128, device="cpu"))


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_rerank_topk_above_max_k_matches_reference(metric,
                                                   small_route_buffer):
    """Masked slots and duplicate ids in the window; the reference's fold
    and its kernel give the same select."""
    rng = np.random.default_rng(2)
    b, C, n = 7, 700, 500
    if metric == "hamming":
        X = _codes(rng, n, 3)
        Q = X[:b]
        Xt, xsq, jxsq = X, None, None
    else:
        X, Q = _ints(rng, (n, 12)), _ints(rng, (b, 12))
        xsq = (X * X).sum(1) if metric == "euclidean" else None
        jxsq = None if xsq is None else jnp.asarray(xsq)
        xsq = None if xsq is None else torch.as_tensor(xsq)
        Xt = torch.as_tensor(X)
    cand = rng.integers(-1, n, (b, C)).astype(np.int32)
    cand[:, 400:500] = cand[:, :100]
    valid = rng.random((b, C)) < 0.9
    if metric == "hamming":
        from repro_torch.bits import words_to_tensor
        Xt = words_to_tensor(X, "cpu")
    want = jx_rerank(Q, X, cand, k=K, metric=metric, xsq=jxsq, valid=valid)
    got = rerank_topk(Q, Xt, cand, k=K, metric=metric, xsq=xsq, valid=valid,
                      use_kernel=True)
    assert_bitwise(want, got)
    ids = got[1].numpy()
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)


def assert_same_ids(want_d, want_i, got_i, atol=1e-4):
    """ids bitwise outside the reference's near ties (adjacent distances
    within ``atol``), where the reassociated ADC sums may swap a pair."""
    want_d, want_i, got_i = (np.asarray(a) for a in (want_d, want_i, got_i))
    bad = want_i != got_i
    near = np.zeros_like(bad)
    gap = np.abs(np.diff(want_d, axis=1)) <= atol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert int((bad & ~near).sum()) == 0, "id mismatches outside near ties"


def test_adc_scan_above_max_c_matches_reference(small_route_buffer):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 32, (2000, 8)).astype(np.uint8)
    luts = rng.random((6, 8, 32)).astype(np.float32)
    C = 1500
    assert C > MAX_C
    want = jx_adc_scan(jnp.asarray(codes), jnp.asarray(luts), k=C)
    got = adc_scan(torch.as_tensor(codes), torch.as_tensor(luts), k=C,
                   use_kernel=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    assert_same_ids(want[0], want[1], got[1], atol=1e-4)
    fold = adc_scan(torch.as_tensor(codes), torch.as_tensor(luts), k=C)
    assert torch.equal(fold[0], got[0]) and torch.equal(fold[1], got[1])


# ------------------------------------------------------------ bench path
def _port_rows(argv):
    from repro_torch.benchmarks import run

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(argv)
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    return [line.split(",", 2) for line in lines[1:]]


def _reference_names(monkeypatch):
    """The reference benches' row names: bench_kernels run with its timer
    stubbed out, bench_distance_topk's from its corpus sizes."""
    import benchmarks.bench_distance_topk as jx_stream_bench
    import benchmarks.bench_kernels as jx_kernel_bench

    monkeypatch.setattr(jx_kernel_bench, "timed", lambda *a, **k: 0.0)
    names = [r.name for r in jx_kernel_bench.run("smoke")]
    ns = jx_stream_bench.NS["smoke"]
    for n in ns:
        names += [f"distance_topk/materialize_n{n}",
                  f"distance_topk/streaming_n{n}"]
    return names + [f"distance_topk/equal_mem_4x_n{4 * ns[0]}"]


def _mapped(name: str) -> str:
    return name.replace("_pallas_interpret", "_plain").replace("_jnp",
                                                                "_torch")


def test_bench_entry_point_runs_on_the_cpu(monkeypatch):
    rows = _port_rows(["--scale", "smoke", "--only", "kernels,stream",
                       "--device", "cpu"])
    want = [_mapped(n) for n in _reference_names(monkeypatch)]
    assert [r[0] for r in rows] == want
    for name, us, derived in rows:
        assert float(us) > 0
        assert "tpu" not in derived.lower() and "bound_us" not in derived
    parity = {r[0]: r[2].split("parity=")[1] for r in rows
              if r[0].startswith("kernel/")}
    assert parity["kernel/hamming_topk_plain"] == "bitwise:1"
    assert parity["kernel/stream_topk_plain"] == "ids_equal:1.0000"
    assert parity["kernel/embedding_bag_plain"] == "max_abs_err:0"
    assert float(parity["kernel/decode_attention_plain"].split(":")[1]) \
        < 1e-5
    assert any("exact=1" in r[2] for r in rows)


def test_bench_entry_point_runs_as_a_module(tmp_path):
    """``python -m`` runs it; ``--out`` writes one artifact per module."""
    import json
    import os
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--scale",
         "smoke", "--only", "stream", "--device", "cpu", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr
    names = [line.split(",")[0] for line in out.stdout.splitlines()[1:]]
    assert names[-1] == "distance_topk/equal_mem_4x_n8000"
    art = json.loads((tmp_path / "BENCH_stream.json").read_text())
    assert [r["name"] for r in art["rows"]] == names
    assert art["extra"]["device"] == "cpu"
    from repro_torch.benchmarks import run

    with pytest.raises(SystemExit):
        run.main(["--only", "serve", "--device", "cpu"])


@pytest.mark.parametrize("bench, target", [
    ("bench_kernels", "distance_matrix_ref"),
    ("bench_distance_topk", "distance_matrix")])
def test_bench_gates_fail_on_a_wrong_distance(monkeypatch, bench, target):
    """A kernel row's parity and the materialise/stream equality are gates:
    a distance off by 1e-2 makes the bench raise."""
    import importlib

    from repro_torch.kernels import distance as pkg

    real = getattr(pkg, target)
    monkeypatch.setattr(pkg, target, lambda *a, **kw: real(*a, **kw) + 1e-2)
    mod = importlib.import_module(f"repro_torch.benchmarks.{bench}")
    with pytest.raises(AssertionError):
        mod.run("smoke", "cpu")
