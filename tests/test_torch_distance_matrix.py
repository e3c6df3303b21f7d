"""Kernel 5 of the port, the tiled distance matrix
(``repro_torch.kernels.distance``), against the JAX package on the same
numpy inputs.  The reference's Pallas kernel runs in interpret mode on the
CPU (as ``tests/test_kernels.py`` runs it); the port runs the kernel's plain
version, which is what its wrapper does with CPU tensors.

Tolerance: rtol=1e-5, atol=1e-4 (``tests/test_kernels.py`` uses the same):
the cross term is summed in another order.  On integer-valued inputs every
fp32 operation is exact, so there the port equals the reference bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.distance import distance_matrix as jx_distance_matrix  # noqa: E402
from repro.kernels.distance import distance_matrix_ref as jx_ref  # noqa: E402
from repro.kernels.distance.ops import pick_tiles as jx_pick_tiles  # noqa: E402
from repro_torch.kernels.distance import (distance_matrix,  # noqa: E402
                                          distance_matrix_kernel,
                                          distance_matrix_plain,
                                          distance_matrix_ref, pick_tiles)
from repro_torch.kernels.distance.distance import norm_operand  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
MODES = ["l2sq", "ip", "cos"]


def _data(kind, rng, shape):
    if kind == "int":
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nq,n,d,kind", [(37, 701, 130, "gauss"),
                                         (5, 129, 16, "int")])
def test_distance_matrix_matches_reference_kernel(mode, nq, n, d, kind):
    """Ragged nq and n; d = 130 spans two of the reference's d-tiles."""
    rng = np.random.default_rng(nq)
    Q, X = _data(kind, rng, (nq, d)), _data(kind, rng, (n, d))
    if mode == "cos" and kind == "gauss":
        Q /= np.linalg.norm(Q, axis=1, keepdims=True) + 1e-6
        X /= np.linalg.norm(X, axis=1, keepdims=True) + 1e-6
    want = np.asarray(jx_distance_matrix(Q, X, mode=mode, interpret=True))
    got = distance_matrix(Q, X, mode=mode, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (nq, n)
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_oracle_matches_reference_oracle(mode):
    rng = np.random.default_rng(1)
    Q, X = _data("gauss", rng, (9, 40)), _data("gauss", rng, (300, 40))
    want = np.asarray(jx_ref(jnp.asarray(Q), jnp.asarray(X), mode=mode))
    got = distance_matrix_ref(torch.as_tensor(Q), torch.as_tensor(X),
                              mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nq,n,d", [(3, 50, 7), (200, 10_000, 130),
                                    (1, 10**6, 960), (128, 512, 128)])
def test_pick_tiles_matches_reference(nq, n, d):
    assert pick_tiles(nq, n, d) == jx_pick_tiles(nq, n, d)


def test_plain_version_masks_rows_through_the_penalty_operand():
    """The xsq operand masks rows in every mode, as kernel 1's does."""
    rng = np.random.default_rng(2)
    Q = torch.as_tensor(_data("int", rng, (4, 12)))
    X = torch.as_tensor(_data("int", rng, (30, 12)))
    for mode in MODES:
        qsq, xsq = norm_operand(Q, mode), norm_operand(X, mode)
        xsq[::3] = float("inf")
        d = distance_matrix_plain(Q, X, qsq, xsq, mode=mode, bd=5)
        assert torch.isinf(d[:, ::3]).all()
        assert torch.isfinite(d[:, 1::3]).all()
        full = distance_matrix_plain(Q, X, qsq, xsq, mode=mode)
        assert torch.equal(d, full)          # integer inputs: exact


def test_kernel_wrapper_refuses_what_it_does_not_take():
    Q, X = torch.zeros((4, 8)), torch.zeros((100, 8))
    z4, z100 = torch.zeros(4), torch.zeros(100)
    with pytest.raises(ValueError, match="CUDA"):
        distance_matrix_kernel(Q, X, z4, z100, mode="l2sq")
    with pytest.raises(ValueError, match="mode"):
        distance_matrix_kernel(Q, X, z4, z100, mode="hamming")
    assert distance_matrix_kernel.launches == 0
