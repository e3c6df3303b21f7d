"""``repro_torch.ann.distances.masked_rows_to`` and ``single`` against the
JAX package's functions on the same numpy inputs, made from a seed.

Tolerance: rtol=1e-5, atol=1e-5 for masked_rows_to (the same expression,
summed over d in another order), rtol=1e-5, atol=1e-4 for single (the
euclidean distance goes through the expansion |q|^2 - 2 q.x + |x|^2, whose
cancellation the order of the sums moves, and XLA's square root on the
CPU may differ from torch's by an ulp even on exact integer sums).  On
integer-valued inputs masked_rows_to is bitwise (every fp32 operation is
exact), as are hamming distances and the +inf of every negative id.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ann import distances as jx  # noqa: E402
from repro_torch.ann import distances  # noqa: E402


def _data(kind, rng, shape):
    if kind == "int":
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("ids_shape", [(50,), (4, 13)])
def test_masked_rows_to_matches_reference(metric, kind, ids_shape):
    rng = np.random.default_rng(len(metric) + len(kind) + len(ids_shape))
    X = _data(kind, rng, (300, 24))
    q = _data(kind, rng, (24,))
    if metric == "angular" and kind == "gauss":
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        q /= np.linalg.norm(q)
    ids = rng.integers(-3, 300, ids_shape).astype(np.int32)
    ids.flat[0] = -1                                   # at least one masked
    want = np.asarray(jx.masked_rows_to(jnp.asarray(X), jnp.asarray(q),
                                        jnp.asarray(ids), metric))
    got = distances.masked_rows_to(torch.from_numpy(X), torch.from_numpy(q),
                                   torch.from_numpy(ids), metric).numpy()
    assert got.shape == want.shape == ids_shape
    assert got.dtype == np.float32
    assert np.array_equal(np.isinf(got), ids < 0)
    assert np.array_equal(np.isinf(want), ids < 0)
    if kind == "int":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_single_matches_reference(metric, kind):
    rng = np.random.default_rng(len(metric) * 7 + len(kind))
    for _ in range(5):
        q, x = _data(kind, rng, (33,)), _data(kind, rng, (33,))
        want = jx.single(q, x, metric)
        got = distances.single(q, x, metric, device="cpu")
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-5, abs=1e-4)


def test_single_hamming_is_the_popcount():
    rng = np.random.default_rng(3)
    for _ in range(5):
        q = rng.integers(0, 2**32, (4,), dtype=np.uint64).astype(np.uint32)
        x = rng.integers(0, 2**32, (4,), dtype=np.uint64).astype(np.uint32)
        want = jx.single(q, x, "hamming")
        assert distances.single(q, x, "hamming", device="cpu") == want
        assert want == float(sum(bin(int(a) ^ int(b)).count("1")
                                 for a, b in zip(q, x)))


def test_single_on_a_tensor_keeps_its_device_and_refuses_a_bad_metric():
    q = torch.ones(3)
    assert distances.single(q, torch.zeros(3), "euclidean") == \
        pytest.approx(3 ** 0.5)
    with pytest.raises(ValueError):
        distances.single(q, q, "manhattan")
