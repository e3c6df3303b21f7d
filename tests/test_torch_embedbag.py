"""Kernel 6 of the port, the embedding bag (``repro_torch.kernels.embedbag``),
against the JAX package on the same numpy inputs.  The reference's Pallas
kernel runs in interpret mode on the CPU (as ``tests/test_kernels.py`` runs
it); the port runs the kernel's plain version, which is what its wrapper
does with CPU tensors.

Tolerance: rtol=1e-5, atol=1e-5 (``tests/test_kernels.py`` uses the same).
Both sum each bag in lookup order, one rounded multiply and one rounded
add at a time, so the results are in fact bitwise equal, and the tests
check that too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedbag import embedding_bag as jx_embedding_bag  # noqa: E402
from repro.kernels.embedbag import embedding_bag_ref as jx_ref  # noqa: E402
from repro_torch.kernels.embedbag import (bag_runs, embedding_bag,  # noqa: E402
                                          embedding_bag_kernel,
                                          embedding_bag_plain,
                                          embedding_bag_ref)

RTOL, ATOL = 1e-5, 1e-5


def _case(seed, V=60, D=12, N=90, B=25):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, N).astype(np.int32)
    bags = rng.integers(0, B, N).astype(np.int32)
    w = rng.random(N).astype(np.float32)
    return table, idx, bags, w


def _both(table, idx, bags, w, n_bags, **kw):
    want = np.asarray(jx_embedding_bag(jnp.asarray(table), idx, bags, w,
                                       n_bags=n_bags, interpret=True, **kw))
    got = embedding_bag(torch.as_tensor(table), idx, bags, w, n_bags=n_bags,
                        **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, want)
    return got


def test_unsorted_bags_with_weights():
    table, idx, bags, w = _case(0)
    _both(table, idx, bags, w, 25)


def test_weights_none_is_a_plain_sum():
    table, idx, bags, _ = _case(1)
    _both(table, idx, bags, None, 25)


def test_empty_bags_are_zero():
    table, idx, bags, w = _case(2)
    bags = bags % 10 * 3                        # bags 1, 2, 4, ... stay empty
    got = _both(table, idx, bags, w, 31)
    empty = np.setdiff1d(np.arange(31), bags)
    assert empty.size and (got[empty] == 0).all()


def test_assume_sorted_with_unsorted_bags_keeps_the_last_run():
    """The Pallas kernel re-initialises a bag at each new run, so on
    ``[0, 1, 0]`` bag 0 holds only the third lookup."""
    table, _, _, _ = _case(3)
    got = _both(table, np.array([3, 4, 5]), np.array([0, 1, 0]),
                np.array([0.5, 2.0, 3.0], np.float32), 3,
                assume_sorted=True)
    np.testing.assert_array_equal(got[0], table[5] * np.float32(3.0))
    table, idx, bags, w = _case(4)
    _both(table, idx, bags, w, 25, assume_sorted=True)


def test_bfloat16_table_rounds_after_every_step():
    """The reference's Pallas kernel stores its output block in the table's
    type after every lookup (its interpret mode refuses a bf16 table, so
    the rule is checked here against a loop written out)."""
    table, idx, bags, w = _case(5)
    tb = torch.as_tensor(table).to(torch.bfloat16)
    got = embedding_bag(tb, idx, bags, w, n_bags=25)
    assert got.dtype == torch.bfloat16
    want = torch.zeros((25, 12), dtype=torch.bfloat16)
    seen = set()
    for i in np.argsort(bags, kind="stable"):
        row = tb[idx[i]].to(torch.float32) * float(w[i])
        b = int(bags[i])
        acc = row if b not in seen else want[b].to(torch.float32) + row
        want[b] = acc.to(torch.bfloat16)
        seen.add(b)
    assert torch.equal(got, want)


def test_oracle_matches_reference_oracle():
    table, idx, bags, w = _case(6)
    want = np.asarray(jx_ref(jnp.asarray(idx), jnp.asarray(bags),
                             jnp.asarray(w), jnp.asarray(table), n_bags=25))
    got = embedding_bag_ref(torch.as_tensor(idx), torch.as_tensor(bags),
                            torch.as_tensor(w), torch.as_tensor(table),
                            n_bags=25)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bag_runs_keep_the_last_run_of_each_bag():
    start, end, bag = bag_runs(torch.tensor([2, 2, 0, 1, 1, 2, 0, 0],
                                            dtype=torch.int32), n_bags=3)
    assert start.tolist() == [3, 5, 6]
    assert end.tolist() == [5, 6, 8]
    assert bag.tolist() == [1, 2, 0]
    assert all(t.dtype == torch.int32 for t in (start, end, bag))


def test_kernel_wrapper_refuses_what_it_does_not_take():
    table, idx, bags, w = _case(7)
    t = torch.as_tensor
    runs = bag_runs(t(np.sort(bags)), n_bags=25)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_kernel(t(idx), t(w), t(table), runs, n_bags=25)
    assert embedding_bag_kernel.launches == 0
    out = embedding_bag_plain(t(idx), t(w), t(table), runs, n_bags=25)
    assert out.shape == (25, 12)


@pytest.mark.parametrize("bad", ["bag_high", "bag_negative", "index_high",
                                 "index_negative"])
def test_ids_outside_their_range_raise(bad):
    """A bag id outside [0, n_bags) or a row outside [0, V) raises before
    any launch: the kernel writes and reads rows unchecked."""
    table, idx, bags, w = _case(8)
    if bad == "bag_high":
        bags[3] = 25
    elif bad == "bag_negative":
        bags[3] = -1
    elif bad == "index_high":
        idx[3] = table.shape[0]
    else:
        idx[3] = -1
    with pytest.raises(ValueError, match="outside"):
        embedding_bag(table, idx, bags, w, n_bags=25, device="cpu")
