"""The fused rerank's list entry (``kernels/rerank_topk/lists.py``, IVF's
route with ``rerank_kernel=True``) on the CPU: IVF against the JAX
package's search on a reference-built index (whose kernel path runs the
Pallas kernel in interpret mode), the pair build against a numpy loop, the
launch plan for every k, and the list kernel's blocks and merge, emulated
step by step from the plan and the pair build, against the entry's plain
version.  Then the bound both entries are held to against the exact value
(``rerank_topk.EXACT_REL``): the plain version, which sums in the
kernel's order, meets it; TF32 operands and a dropped term do not.

Tolerances: as ``test_torch_algos``: float distances rtol=1e-5, atol=1e-4,
ids bitwise except at the reference's near ties (counted, expected 0).
The emulation runs on integer-valued inputs, where every distance is exact
whatever the order of the sums, so it is held bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ann import functional as jx_functional  # noqa: E402
from repro.ann import ivf as jx_ivf  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.ann import ivf  # noqa: E402
from repro_torch.ann.topk import topk_unique  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.kernels.rerank_topk import lists  # noqa: E402
from repro_torch.kernels.rerank_topk import (  # noqa: E402
    EXACT_REL, err_vs_exact, rerank_topk_plain)
from repro_torch.kernels.rerank_topk.ops import kernel_operands  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def assert_same(want, got, metric):
    """``test_torch_algos.assert_same``: distances within tolerance, ids
    bitwise outside the reference's near ties, none at them."""
    wd, wi = (np.asarray(a) for a in want)
    gd, gi = (a.numpy() for a in got)
    assert gi.shape == wi.shape and gi.dtype == np.int32
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    bad = gi != wi
    near = np.zeros_like(bad)
    gap = np.abs(np.diff(wd, axis=1)) <= ATOL
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert int((bad & ~near).sum()) == 0, "id mismatches outside near ties"
    assert int((bad & near).sum()) == 0, "id mismatches at near ties"


def _index(metric, n=900, d=12, n_clusters=24, seed=0, empty=None):
    """A reference IVF index (kernel path) and its port state; ``empty``
    names a list emptied in both (its rows become unreachable)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((19, d)).astype(np.float32)
    ref = jx_ivf.build(X, metric=metric, n_clusters=n_clusters,
                       rerank_kernel=True)
    arrays = {k: np.asarray(v) for k, v in ref.arrays.items()}
    if empty is not None:
        arrays["sizes"] = arrays["sizes"].copy()
        arrays["sizes"][empty] = 0
        ref = jx_functional.IndexState(
            "IVF", metric, {k: jnp.asarray(v) for k, v in arrays.items()},
            ref.static)
    st = state_from_reference("IVF", metric, arrays, ref.static,
                              device="cpu")
    assert st.static["rerank_kernel"]
    return ref, st, Q


KNOBS = [
    {"n_probes": 3},                                         # static
    {"n_probes": 4, "scan": 11},                             # static scan
    {"n_probes": 2, "max_probes": 6},                        # capped probes
    {"n_probes": 5, "max_probes": 5, "scan": 9, "max_scan": 30},
    {"n_probes": 1, "max_probes": 8, "scan": 40, "max_scan": 25},
]


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
@pytest.mark.parametrize("kw", KNOBS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_ivf_list_entry_matches_reference(metric, kw):
    ref, st, Q = _index(metric)
    assert_same(jx_ivf.search(ref, jnp.asarray(Q), k=10, **kw),
                ivf.search(st, Q, k=10, **kw), metric)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_ivf_list_entry_device_scalar_knobs(metric):
    """n_probes and scan as 0-d tensors (the grid sweep's form) give the
    static path's answer, as in the reference."""
    ref, st, Q = _index(metric, seed=1)
    for n_probes, scan in [(1, 5), (3, 30), (6, 12)]:
        got = ivf.search(st, Q, k=10, n_probes=torch.tensor(n_probes),
                         scan=torch.tensor(scan), max_probes=6,
                         max_scan=30)
        want = jx_ivf.search(ref, jnp.asarray(Q), k=10, n_probes=n_probes,
                             scan=scan, max_probes=6, max_scan=30)
        assert_same(want, got, metric)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_ivf_list_entry_live_and_id_map(metric):
    ref, st, Q = _index(metric, seed=2)
    rng = np.random.default_rng(2)
    live = rng.random(900) < 0.7
    id_map = (rng.permutation(900) // 2).astype(np.int32)   # ids repeat
    for kw in ({"live": live}, {"id_map": id_map},
               {"live": live, "id_map": id_map}):
        want = jx_ivf.search(ref, jnp.asarray(Q), k=10, n_probes=4,
                             max_probes=7,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        got = ivf.search(st, Q, k=10, n_probes=4, max_probes=7, **kw)
        assert_same(want, got, metric)
        ids = got[1].numpy()
        for row in ids:
            kept = row[row >= 0]
            assert len(set(kept.tolist())) == len(kept)
        if "live" in kw and "id_map" not in kw:
            assert not np.isin(ids, np.flatnonzero(~live)).any()


def test_ivf_list_entry_empty_list():
    """A probed list of length 0 contributes nothing."""
    ref, st, Q = _index("euclidean", seed=3)
    centers = np.asarray(ref["centers"])
    nearest = int(np.argmin(((Q[:1, None] - centers[None]) ** 2).sum(-1)))
    ref, st, Q = _index("euclidean", seed=3, empty=nearest)
    assert int(st["sizes"][nearest]) == 0
    assert_same(jx_ivf.search(ref, jnp.asarray(Q), k=10, n_probes=3),
                ivf.search(st, Q, k=10, n_probes=3), "euclidean")


def test_ivf_list_entry_k_above_window():
    """kk = min(k, P * M): a window of 3 lists x 2 rows returns 6 pairs."""
    ref, st, Q = _index("euclidean", seed=4)
    got = ivf.search(st, Q, k=10, n_probes=3, scan=2)
    assert got[0].shape == (Q.shape[0], 6)
    assert_same(jx_ivf.search(ref, jnp.asarray(Q), k=10, n_probes=3,
                              scan=2), got, "euclidean")


def test_ivf_list_entry_above_max_k():
    """k > kernels.MAX_K takes the window's distances-out route."""
    ref, st, Q = _index("angular", n=1500, seed=5)
    k = kernels.MAX_K + 44
    got = ivf.search(st, Q, k=k, n_probes=6)
    assert got[0].shape[1] == k
    assert_same(jx_ivf.search(ref, jnp.asarray(Q), k=k, n_probes=6), got,
                "angular")


def _pairs_numpy(probes, n_probes, n_lists, sizes):
    b, P = probes.shape
    keys = [[probes[q, p] if p < n_probes else n_lists for p in range(P)]
            for q in range(b)]
    flat = [key for row in keys for key in row]
    order = sorted(range(b * P), key=lambda i: (flat[i], i))
    counts = [sum(1 for key in flat if key == L) for L in range(n_lists)]
    pstart, acc = [], 0
    for c in counts:
        pstart.append(acc)
        acc += c
    perm = sorted(range(n_lists), key=lambda L: (-sizes[L], L))
    cum, acc = [], 0
    for L in perm:
        acc += -(-counts[L] // lists.BM)
        cum.append(acc)
    return order, counts, pstart, perm, cum


@pytest.mark.parametrize("n_probes", [None, 0, 3, 5, 9])
@pytest.mark.parametrize("b", [70, 300])
def test_pair_build_matches_numpy(n_probes, b):
    """A dead probe slot (p >= n_probes) takes the sentinel key; n_probes
    as a 0-d tensor, as the grid sweep passes it."""
    rng = np.random.default_rng(b + (n_probes or 0))
    P, n_lists = 5, 17
    probes = np.stack([rng.permutation(n_lists)[:P] for _ in range(b)])
    probes[:100] = probes[0]               # one list of more than BM pairs
    sizes = rng.integers(0, 50, n_lists).astype(np.int32)
    sizes[3] = sizes[7]                    # a tie: the lower list first
    got = lists.pair_build(
        torch.as_tensor(probes), None if n_probes is None
        else torch.tensor(n_probes, dtype=torch.int32), n_lists,
        torch.as_tensor(sizes))
    want = _pairs_numpy(probes, P if n_probes is None else n_probes,
                        n_lists, sizes.tolist())
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.int32, name
        assert g.tolist() == list(w), name


def _check_plan(b, P, n_lists, M, k):
    plan = lists.launch_plan(b, P, n_lists, M, k)
    kk = min(k, P * M)
    assert plan.kk == kk
    assert plan.kp == min(kk, M)
    assert plan.smem == lists.smem_bytes(plan.kp)
    assert plan.smem <= lists.SMEM_BLOCK
    # the grid covers every (list, chunk) whatever the probes: all b P
    # pairs in one list, or one pair in each of min(n_lists, b P) lists
    assert plan.grid_x >= -(-b * P // lists.BM)
    assert plan.grid_x >= min(n_lists, b * P)
    assert plan.grid_x >= n_lists + -(-b * P // lists.BM) - 1 \
        or b * P < n_lists
    return plan


@pytest.mark.parametrize("shape", [
    (10_000, 10, 1024, 4014),      # the main set's window at cap 10
    (2_000, 10, 1024, 689),        # the angular set's
    (1, 10, 1024, 4014),           # one query
    (7, 3, 5, 2),                  # a window below k
    (1, 1, 1, 1),
    (64, 1, 3, 1000),
    (10_000, 1024, 1024, 300),
])
def test_launch_plan_every_k(shape):
    for k in range(1, kernels.MAX_K + 1):
        _check_plan(*shape, k)


def test_launch_plan_choices():
    main = lists.launch_plan(10_000, 10, 1024, 4014, 10)
    assert main.kp == 10 and main.kk == 10
    assert main.grid_x == 1024 + -(-100_000 // 64)
    assert lists.launch_plan(10_000, 10, 1024, 4014, 256).kp == 256
    assert lists.launch_plan(1, 10, 1024, 4014, 10).grid_x == 1025
    assert lists.launch_plan(7, 3, 5, 2, 100)[:2] == (2, 6)
    with pytest.raises(ValueError):
        lists.launch_plan(10, 4, 8, 100, kernels.MAX_K + 1)
    with pytest.raises(ValueError):
        lists.launch_plan(0, 4, 8, 100, 10)


def _emulate(Q, qsq, X, xsq, probes, starts, sizes, row_ids, *, M, mode,
             k, n_probes, scan, row_live, plan):
    """The list kernel's blocks and the merge kernel, step by step, from
    the plan and the pair build: partial lists of each (query, probe
    slot), unread ones NaN, then each query's live ones merged."""
    b, P = probes.shape
    kp, rows = plan.kp, lists.BM
    pairs = lists.pair_build(probes, n_probes, starts.shape[0], sizes)
    part_d = torch.full((b, P, kp), float("nan"))
    part_i = torch.full((b, P, kp), -7, dtype=torch.int32)
    cum = pairs.cum.tolist()
    budget = M if scan is None else max(int(scan), 1)
    for blk in range(plan.grid_x):
        if blk >= cum[-1]:
            continue                       # past the end
        i = int(np.searchsorted(cum, blk, side="right"))
        L = int(pairs.perm[i])
        chunk = blk - (cum[i - 1] if i else 0)
        p0 = int(pairs.pstart[L]) + chunk * rows
        nrows = min(rows, int(pairs.counts[L]) - chunk * rows)
        length = min(int(sizes[L]), M, budget)
        r = torch.arange(int(starts[L]), int(starts[L]) + length)
        ids = row_ids[r].clone()
        if row_live is not None:
            ids[~row_live[r]] = -1
        for pair in pairs.order[p0:p0 + nrows].tolist():
            q = pair // P
            cross = X[r] @ Q[q]
            d = (qsq[q] - 2.0 * cross) + xsq[r] if mode == "l2sq" \
                else (1.0 - cross) + 0.0
            d = torch.where(ids < 0, torch.full_like(d, float("inf")), d)
            pd = torch.full((kp,), float("inf"))
            pi = torch.full((kp,), -1, dtype=torch.int32)
            if r.numel():
                vals, sel = topk_unique(d[None], ids[None], kp)
                m = vals.shape[1]
                pd[:m] = vals[0]
                pi[:m] = torch.where(torch.isfinite(vals[0]), sel[0],
                                     torch.full_like(sel[0], -1))
            part_d[q, pair % P], part_i[q, pair % P] = pd, pi
    live = P if n_probes is None else min(max(int(n_probes), 0), P)
    cd = part_d[:, :live].reshape(b, -1)
    ci = part_i[:, :live].reshape(b, -1)
    assert not torch.isnan(cd).any(), "a live partial list was not written"
    vals, sel = topk_unique(torch.cat([cd, torch.full((b, plan.kk),
                                                      float("inf"))], 1),
                            torch.cat([ci, torch.full((b, plan.kk), -1,
                                                      dtype=torch.int32)],
                                      1), plan.kk)
    return vals, torch.where(torch.isfinite(vals), sel,
                             torch.full_like(sel, -1))


@pytest.mark.parametrize("mode", ["l2sq", "cos"])
@pytest.mark.parametrize("b,k,n_probes,scan,use_live", [
    (40, 10, 3, None, False),      # several queries per list
    (1, 5, None, None, True),      # one query
    (3, 200, 2, 250, False),       # partial lists capped at the list
    (150, 7, torch.tensor(4), torch.tensor(1), True),   # 0-d knobs
])
def test_list_blocks_emulated_match_plain(mode, b, k, n_probes, scan,
                                          use_live):
    rng = np.random.default_rng(b + k)
    n, d, n_lists, P = 3000, 9, 11, 5
    X = torch.as_tensor(rng.integers(-3, 4, (n, d)).astype(np.float32))
    Q = torch.as_tensor(rng.integers(-3, 4, (b, d)).astype(np.float32))
    sizes = torch.as_tensor(rng.multinomial(n, np.ones(n_lists) / n_lists)
                            .astype(np.int32))
    sizes[4] = 0                                         # an empty list
    starts = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
    M = int(sizes.max())
    probes = torch.as_tensor(np.stack([rng.permutation(n_lists)[:P]
                                       for _ in range(b)]))
    row_ids = torch.as_tensor((rng.permutation(n) // 3).astype(np.int32))
    row_live = torch.as_tensor(rng.random(n) < 0.8) if use_live else None
    qsq = (Q * Q).sum(1) if mode == "l2sq" else torch.zeros(b)
    xsq = (X * X).sum(1)
    plan = lists.launch_plan(b, P, n_lists, M, k)
    kw = dict(M=M, mode=mode, k=k, n_probes=n_probes, scan=scan,
              row_live=row_live)
    want = lists.rerank_lists_plain(Q, qsq, X, xsq if mode == "l2sq"
                                    else None, probes, starts, sizes,
                                    row_ids, **kw)
    got = _emulate(Q, qsq, X, xsq, probes, starts, sizes, row_ids,
                   plan=plan, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _float_window(data, mode, seed, b=48, n=2000, C=700, d=128):
    """A rerank window at d = 128 (the main set's width): N(0, 9) rows, or
    blob rows (3 N(0, 1) centres plus N(0, 1)) whose queries sit in the
    rows' blobs, as on the main set.  Repeated rows, masked slots."""
    rng = np.random.default_rng(seed)
    if data == "N(0,9)":
        X = 3.0 * rng.standard_normal((n, d))
        Q = 3.0 * rng.standard_normal((b, d))
    else:
        centres = 3.0 * rng.standard_normal((20, d))
        X = centres[rng.integers(0, 20, n)] + rng.standard_normal((n, d))
        Q = centres[rng.integers(0, 20, b)] + rng.standard_normal((b, d))
    X, Q = (torch.as_tensor(a.astype(np.float32)) for a in (X, Q))
    if mode == "cos":
        X = X / X.norm(dim=1, keepdim=True)
        Q = Q / Q.norm(dim=1, keepdim=True)
    cand = torch.as_tensor(rng.integers(0, n, (b, C)).astype(np.int32))
    cand[:, 300:400] = cand[:, :100]
    bad = torch.as_tensor(rng.random((b, C)) < 0.3)
    metric = "euclidean" if mode == "l2sq" else "angular"
    qsq = (Q * Q).sum(1, keepdim=True) if mode == "l2sq" else None
    return kernel_operands(Q, X, qsq, (X * X).sum(1), cand, bad,
                           torch.arange(n, dtype=torch.int32), metric, 100)


def _tf32(t):
    """t with its mantissas rounded to TF32's 10 bits."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("mode", ["l2sq", "cos"])
@pytest.mark.parametrize("data", ["N(0,9)", "blobs"])
def test_exact_bound_holds_the_chain_and_flags_tf32_and_a_dropped_term(
        mode, data):
    """EXACT_REL lies above what one chain of products over d in index
    order errs by (the plain version sums in the kernel's order), and
    below what the same rerank reads on TF32 operands or without d's last
    term: a gate at it passes the kernel's arithmetic and no cheaper
    one."""
    ops = _float_window(data, mode, seed=len(data) + len(mode))
    out = rerank_topk_plain(**ops)
    assert bool((out[1] >= 0).all())
    err, rel = err_vs_exact(out, **ops)
    assert rel <= EXACT_REL / 2, (err, rel)
    lossy = dict(ops, Q=_tf32(ops["Q"].clone()), X=_tf32(ops["X"].clone()))
    _, rel_tf32 = err_vs_exact(rerank_topk_plain(**lossy), **ops)
    assert rel_tf32 > 5 * EXACT_REL, rel_tf32
    short = dict(ops, Q=ops["Q"].clone(), X=ops["X"].clone())
    short["Q"][:, -1] = 0.0
    _, rel_drop = err_vs_exact(rerank_topk_plain(**short), **ops)
    assert rel_drop > 100 * EXACT_REL, rel_drop


def test_err_vs_exact_is_zero_on_integers_and_reads_each_id_once():
    """Integer-valued operands give exact distances whatever the order;
    ids repeated across slots (one row each) map to their row, and an id
    outside the window is refused."""
    rng = np.random.default_rng(9)
    n, d, b, C = 300, 20, 16, 90
    X = torch.as_tensor(rng.integers(-3, 4, (n, d)).astype(np.float32))
    Q = torch.as_tensor(rng.integers(-3, 4, (b, d)).astype(np.float32))
    cand = torch.as_tensor(rng.integers(0, n, (b, C)).astype(np.int32))
    cand[:, 45:] = cand[:, :45]
    ids = torch.as_tensor((rng.permutation(n) + 7).astype(np.int32))
    ops = kernel_operands(Q, X, (Q * Q).sum(1, keepdim=True), (X * X).sum(1),
                          cand, torch.zeros(b, C, dtype=torch.bool), ids,
                          "euclidean", 10)
    out = rerank_topk_plain(**ops)
    assert err_vs_exact(out, **ops) == (0.0, 0.0)
    wrong = (out[0] + 0.5, out[1])
    err, rel = err_vs_exact(wrong, **ops)
    assert err == 0.5 and rel > 0
    with pytest.raises(ValueError):
        err_vs_exact((out[0], torch.full_like(out[1], 3)), **ops)
