"""Kernel 6's launch plan, its bag spans and its stream walk
(``repro_torch.kernels.embedbag``), on the CPU.

``plan`` / ``check_plan`` are pure: held here at the chip smoke's six
cases and at edge shapes.  ``bag_spans`` is held against a numpy build.
``stream_walk`` below is the kernel's walk in torch (bag ranges per
group, batches of U rows, resets at each bag's first lookup, stores at
its last, the lanes' vectors): it must equal ``embedding_bag_plain`` bit
for bit,
and the JAX package's ``embedding_bag`` (its Pallas kernel in interpret
mode) within rtol=1e-5, atol=1e-5 (``tests/test_kernels.py``'s
tolerance); both sum each bag in lookup order with one rounded multiply
and one rounded add a step, so that holds bit for bit too.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedbag import embedding_bag as jx_embedding_bag  # noqa: E402
from repro_torch.benchmarks import sweep_embedbag_plan  # noqa: E402
from repro_torch.kernels.embedbag import (bag_spans,  # noqa: E402
                                          embedding_bag_plain)
from repro_torch.kernels.embedbag.embedbag import (  # noqa: E402
    MAX_BLOCK_BAGS, MAX_REGS, VARIANTS, check_plan, plan, regs_estimate)

RTOL, ATOL = 1e-5, 1e-5
SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc" / "embedding_bag.cu"
# chip_smoke.py's cases: (n_bags, lookups, D, dtype)
CASES = [(B, sweep_embedbag_plan.N, D, dtype)
         for _, D, dtype, B in sweep_embedbag_plan.CASES]


def group_ranges(p: dict, n_bags: int) -> torch.Tensor:
    """[groups, 2] (first bag, end) of each group of the launch, by the
    kernel's arithmetic (block b owns bags from b * block_bags, its group g
    the ``bags_per_group`` from g * bags_per_group, cut at n_bags); empty
    ranges included."""
    gpb, bpg = p["groups_per_block"], p["bags_per_group"]
    block_bags = gpb * bpg
    b0 = torch.arange(p["grid"])[:, None] * block_bags
    nb = (n_bags - b0).clamp(max=block_bags)
    lb0 = torch.arange(gpb)[None, :] * bpg
    lb1 = torch.minimum(lb0 + bpg, nb)
    lo = (b0 + lb0).reshape(-1)
    return torch.stack([lo, torch.maximum(b0 + lb1, b0 + lb0).reshape(-1)],
                       dim=1)


def stream_walk(indices, weights, table, spans, *, n_bags: int, p: dict):
    """The kernel's walk in torch, for plan ``p``: every group of
    :func:`group_ranges` streams the lookups of its bags in order, U at a
    time (the batch's rows gathered together, then added one slot after
    another), resetting at a bag's first lookup and storing at its last;
    an empty bag gets zeros as the walk passes it.  Lane l of a group
    writes vectors v0 + l + lanes * t (t < cpl) of pass v0.  Raises unless
    every (bag, column) of the output is written exactly once."""
    start, end = (s.long() for s in spans)
    D = table.shape[1]
    E = p["vec"] // table.element_size()
    nv = D // E
    L, cpl, U = p["lanes"], p["cpl"], p["U"]
    ranges = group_ranges(p, n_bags)
    cover = torch.zeros(n_bags, dtype=torch.int64)
    for lo, hi in ranges.tolist():
        cover[lo:hi] += 1
    if not bool((cover == 1).all()):
        raise RuntimeError("stream_walk: the groups do not cover each bag "
                           "once")
    grp = torch.searchsorted(ranges[:, 1].contiguous(),
                             torch.arange(n_bags), right=True)
    lens = end - start
    slot_bag = torch.repeat_interleave(torch.arange(n_bags), lens)
    first_slot = torch.cumsum(lens, 0) - lens
    k = torch.arange(slot_bag.numel()) - first_slot[slot_bag]
    slot_pos = start[slot_bag] + k
    slot_first, slot_last = k == 0, k == lens[slot_bag] - 1
    slot_grp = grp[slot_bag]
    group_first = torch.full((ranges.shape[0],), slot_bag.numel(),
                             dtype=torch.int64).scatter_reduce(
        0, slot_grp, torch.arange(slot_bag.numel()), "amin")
    step = torch.arange(slot_bag.numel()) - group_first[slot_grp]
    out = torch.empty((n_bags, D), dtype=table.dtype)
    written = torch.zeros((n_bags, D), dtype=torch.int64)
    for v0 in range(0, nv, L * cpl):
        vecs = torch.tensor([v0 + l + L * t for l in range(L)
                             for t in range(cpl) if v0 + l + L * t < nv],
                            dtype=torch.int64)
        cols = (vecs[:, None] * E + torch.arange(E)).reshape(-1)
        empty = torch.nonzero(lens == 0).squeeze(1)
        out[empty[:, None], cols] = 0
        _count(written, empty, cols)
        acc = torch.zeros((ranges.shape[0], cols.numel()),
                          dtype=torch.float32)
        n_steps = int(step.max()) + 1 if step.numel() else 0
        for b0 in range(0, n_steps, U):
            batch = torch.nonzero((step >= b0) & (step < b0 + U)).squeeze(1)
            rows = table[indices[slot_pos[batch]].long()][:, cols] \
                .to(torch.float32)                        # the batch's ring
            for u in range(U):
                at = torch.nonzero(step[batch] == b0 + u).squeeze(1)
                s = batch[at]
                g = slot_grp[s]
                x = rows[at] * weights[slot_pos[s]][:, None]
                new = torch.where(slot_first[s][:, None], x, acc[g] + x)
                acc[g] = new.to(table.dtype).to(torch.float32)
                last = s[slot_last[s]]
                out[slot_bag[last][:, None], cols] = \
                    acc[slot_grp[last]].to(table.dtype)
                _count(written, slot_bag[last], cols)
    if not bool((written == 1).all()):
        raise RuntimeError("stream_walk: the lanes do not write each "
                           "(bag, column) once")
    return out


def _count(written, bags, cols):
    """Add one to ``written`` at every (bag, column), repeats included."""
    at = (bags[:, None].expand(-1, cols.numel()).reshape(-1),
          cols[None, :].expand(bags.numel(), -1).reshape(-1))
    written.index_put_(at, torch.ones_like(at[0]), accumulate=True)


def _covers_once(p, n_bags):
    lo, hi = group_ranges(p, n_bags).numpy().T
    assert (lo <= hi).all() and ((hi <= n_bags) | (lo == hi)).all()
    diff = np.zeros(n_bags + 1, np.int64)       # ranges counted at once
    live = lo < hi
    np.add.at(diff, lo[live], 1)
    np.add.at(diff, hi[live], -1)
    return bool((np.cumsum(diff)[:n_bags] == 1).all())


def _holds(p, n_bags, D, dtype, aligned):
    isz = torch.tensor([], dtype=dtype).element_size()
    assert (D * isz) % p["vec"] == 0
    assert aligned or p["vec"] == isz
    assert p["regs_estimate"] <= MAX_REGS
    assert p["lanes"] * p["cpl"] * p["passes"] >= D * isz // p["vec"]
    assert p["groups_per_block"] * p["bags_per_group"] <= MAX_BLOCK_BAGS
    assert _covers_once(p, n_bags)
    check_plan(p, n_bags, D, dtype, aligned)


def test_variants_match_the_kernel_source():
    listed = {tuple(int(x) for x in m) for m in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+)\)", CSRC.read_text())}
    assert listed == set(VARIANTS) and len(listed) == len(VARIANTS)
    assert all(regs_estimate(v, c, u, 4 if dt == 0 else 2) <= MAX_REGS
               for dt, v, c, u in VARIANTS)


@pytest.mark.parametrize("n_bags,N,D,dtype", CASES)
def test_plan_at_the_smoke_cases(n_bags, N, D, dtype):
    for per_sm in (1, 2, 4, 8):
        p = plan(n_bags, N, D, dtype, True, SMS, per_sm)
        _holds(p, n_bags, D, dtype, True)
        # one wave: every block resident at once (unless a block stages
        # all the bags it may), and the fewest bags a group that allow it
        cap = MAX_BLOCK_BAGS // p["groups_per_block"]
        assert p["grid"] <= SMS * per_sm or p["bags_per_group"] == cap
        assert p["bags_per_group"] == 1 or (p["bags_per_group"] - 1) \
            * SMS * per_sm * p["groups_per_block"] < n_bags
    p = plan(n_bags, N, D, dtype, True, SMS, 2)
    isz = 4 if dtype == torch.float32 else 2
    assert p["vec"] == {128: 16, 16: 16, 10: 8}[D]
    assert p["lanes"] == D * isz // p["vec"] and p["cpl"] == 1 \
        and p["passes"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", [1, 10, 16, 64, 128, 200, 256])
def test_plan_at_edge_shapes(D, aligned, dtype):
    for n_bags in (1, 97, 524_288):
        for N in (0, n_bags, 100 * n_bags):
            p = plan(n_bags, N, D, dtype, aligned, SMS, 3)
            _holds(p, n_bags, D, dtype, aligned)
    # a callable gives the variant's resident blocks
    seen = []
    p = plan(97, 900, D, dtype, aligned, SMS,
             lambda *v: seen.append(v) or 2)
    assert seen == [(p["dtype"], p["vec"], p["cpl"], p["U"],
                     8 * MAX_BLOCK_BAGS)] and p["blocks_per_sm"] == 2


def test_plan_pins_and_refusals():
    p = plan(1000, 8000, 128, torch.float32, True, SMS, 2, vec=8)
    assert (p["vec"], p["cpl"], p["lanes"], p["U"]) == (8, 2, 32, 4)
    p = plan(1000, 8000, 128, torch.float32, True, SMS, 2, cpl=2)
    assert (p["vec"], p["lanes"], p["passes"], p["U"]) == (16, 16, 1, 4)
    p = plan(1000, 8000, 128, torch.float32, True, SMS, 2, bags_per_group=3)
    assert p["bags_per_group"] == 3 and _covers_once(p, 1000)
    with pytest.raises(ValueError, match="variant"):
        plan(1000, 8000, 128, torch.float32, True, SMS, 2, vec=4, cpl=2)
    with pytest.raises(ValueError, match="bags a group"):
        plan(1000, 8000, 128, torch.float32, True, SMS, 2,
             bags_per_group=MAX_BLOCK_BAGS // 8 + 1)
    with pytest.raises(ValueError, match="vectors"):
        plan(1000, 8000, 10, torch.float32, True, SMS, 2, vec=16)
    with pytest.raises(ValueError, match="vectors"):
        plan(1000, 8000, 128, torch.float32, False, SMS, 2, vec=16)
    good = plan(1000, 8000, 128, torch.float32, True, SMS, 2)
    check_plan(good, 1000, 128, torch.float32, True)
    for bad in (dict(grid=good["grid"] - 1), dict(grid=good["grid"] + 1),
                dict(lanes=33), dict(U=5), dict(dtype=1),
                dict(smem=good["smem"] + 8),
                dict(bags_per_group=MAX_BLOCK_BAGS),
                dict(groups_per_block=1), dict(passes=2)):
        with pytest.raises(ValueError, match="does not fit"):
            check_plan(dict(good, **bad), 1000, 128, torch.float32, True)
    for other in ((1000, 200, torch.float32, True),      # other D
                  (1000, 128, torch.bfloat16, True),     # other dtype
                  (1000, 128, torch.float32, False),     # not aligned
                  (10**6, 128, torch.float32, True)):    # more bags
        with pytest.raises(ValueError, match="does not fit"):
            check_plan(good, *other)


def _np_spans(bags, n_bags):
    start = np.zeros(n_bags, np.int64)
    end = np.zeros(n_bags, np.int64)
    i = 0
    while i < len(bags):
        j = i
        while j < len(bags) and bags[j] == bags[i]:
            j += 1
        start[bags[i]], end[bags[i]] = i, j      # a later run overwrites
        i = j
    return start, end


@pytest.mark.parametrize("case", ["sorted", "empty_bags", "unsorted",
                                  "one_bag", "none"])
def test_bag_spans_match_numpy(case):
    rng = np.random.default_rng(11)
    B = 40
    bags = {"sorted": np.sort(rng.integers(0, B, 300)),
            "empty_bags": np.sort(rng.integers(0, B // 4, 300) * 4),
            "unsorted": rng.integers(0, 5, 300),
            "one_bag": np.full(7, 3),
            "none": np.zeros(0, np.int64)}[case]
    start, end = bag_spans(torch.as_tensor(bags, dtype=torch.int32),
                           n_bags=B)
    ws, we = _np_spans(bags, B)
    assert start.dtype == end.dtype == torch.int32
    np.testing.assert_array_equal(start.numpy(), ws)
    np.testing.assert_array_equal(end.numpy(), we)
    with pytest.raises(ValueError, match="outside"):
        bag_spans(torch.tensor([0, B], dtype=torch.int32), n_bags=B)


def _walk_case(seed, D, per_bag, B, dtype=torch.float32, V=50,
               unsorted=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    bags = np.repeat(np.arange(B), per_bag)
    if unsorted:                    # assume_sorted with unsorted bags
        bags = rng.integers(0, B, bags.size)
    idx = rng.integers(0, V, bags.size).astype(np.int32)
    w = rng.random(bags.size).astype(np.float32)
    return table, idx, bags.astype(np.int32), w, torch.as_tensor(
        table).to(dtype)


def _walk(table_t, idx, bags, w, B, p):
    t = torch.as_tensor
    spans = bag_spans(t(bags), n_bags=B)
    got = stream_walk(t(idx), t(w), table_t, spans, n_bags=B, p=p)
    want = embedding_bag_plain(t(idx), t(w), table_t, spans, n_bags=B)
    assert got.dtype == table_t.dtype
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("D", [10, 16])
@pytest.mark.parametrize("per_bag,B", [(1, 60), (100, 3)])
def test_stream_walk_matches_plain_and_reference(D, per_bag, B):
    table, idx, bags, w, table_t = _walk_case(D + per_bag, D, per_bag, B)
    p = plan(B, bags.size, D, torch.float32, True, SMS, 1,
             bags_per_group=max(1, 7 // per_bag))
    got = _walk(table_t, idx, bags, w, B, p).numpy()
    want = np.asarray(jx_embedding_bag(jnp.asarray(table), idx, bags, w,
                                       n_bags=B, assume_sorted=True,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,aligned,pins", [
    (1, True, {}), (10, True, {}), (16, True, dict(cpl=2)),
    (128, True, dict(vec=8, cpl=1)), (128, False, {}), (200, True, {}),
    (256, True, dict(cpl=4)), (64, True, dict(bags_per_group=1))])
def test_stream_walk_variants_match_plain(dtype, D, aligned, pins):
    """Lanes, vectors a lane, passes over wide rows, empty bags between
    full ones, runs longer than a batch and groups of one bag."""
    table, idx, bags, w, table_t = _walk_case(D, D, 0, 0, dtype)
    rng = np.random.default_rng(D)
    B = 23
    lens = rng.choice([0, 1, 2, 5, 9, 33], B)
    bags = np.repeat(np.arange(B), lens).astype(np.int32)
    idx = rng.integers(0, 50, bags.size).astype(np.int32)
    w = rng.random(bags.size).astype(np.float32)
    pins = dict(pins)
    pins.setdefault("bags_per_group", 3)
    p = plan(B, bags.size, D, dtype, aligned, SMS, 1, **pins)
    _walk(table_t, idx, bags, w, B, p)


def test_stream_walk_keeps_the_last_run():
    table, idx, bags, w, table_t = _walk_case(5, 12, 4, 9, unsorted=True)
    p = plan(9, bags.size, 12, torch.float32, True, SMS, 1,
             bags_per_group=2)
    got = _walk(table_t, idx, bags, w, 9, p)
    want = np.asarray(jx_embedding_bag(jnp.asarray(table), idx, bags, w,
                                       n_bags=9, assume_sorted=True,
                                       interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
