"""The torch rerank fold against its one-chunk (materialized) form and
kernel 2 on the card, at the five high-probe cases of the reference's
``benchmarks/bench_rerank.py`` (its ``CASES``, at its default scale).

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_rerank_block

Needs a CUDA card.  Per case, each search is timed on the host clock with
the card synchronized (best of 5 after 2 warm-ups, as the reference bench
times): the window reranked in one chunk (``rerank_block`` >= C), the
fold at the block ``pick_rerank_block`` picks and at fixed blocks, and
the ``rerank_kernel`` build (kernel 2: IVF's list entry, the generic
window entry for the others).  Each line gives the fold's speedup over
the materialized window (the reference bench gates >= 1.3x on two
algorithms), whether its ids equal the materialized window's, and the
largest distance difference relative to the reference bench's tolerance
(rtol 1e-6, atol 1e-5; over 1 fails it).  The port does not ship that
bench: its gates are claims about the reference's CPU, and these lines
are why.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from repro_torch.ann.functional import get_functional, queries_on
from repro_torch.benchmarks.common import best_s
from repro_torch.data import get_dataset
from repro_torch.kernels.rerank_topk.ops import pick_rerank_block

K = 10
N, HAMMING_N = 20_000, 15_000
BLOCKS = (256, 1024, 4096, 8192)
# algorithm -> (dataset template, build params, query params, nq)
CASES = {
    "IVF": ("blobs-euclidean-{n}-d128", {"n_clusters": 64},
            {"n_probes": 64}, 256),
    "HyperplaneLSH": ("blobs-angular-{n}-d128",
                      {"n_tables": 8, "n_bits": 8, "cap": 128},
                      {"n_probes": 8}, 128),
    "E2LSH": ("blobs-euclidean-{n}-d128",
              {"n_tables": 8, "n_hashes": 8, "width": 2.0, "cap": 128},
              {"n_probes": 8}, 128),
    "RPForest": ("blobs-euclidean-{n}-d128",
                 {"n_trees": 10, "leaf_size": 64}, {"probe": 8}, 128),
    "MultiIndexHashing": ("random-hamming-{n}-b128",
                         {"n_chunks": 16, "cap": 64}, {"radius": 2}, 128),
}


def _tolerance_share(d, want) -> float:
    """max |d - want| / (1e-5 + 1e-6 |want|) over finite entries."""
    d, want = d.cpu().numpy(), want.cpu().numpy()
    ok = np.isfinite(want)
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(d[ok] - want[ok])
                        / (1e-5 + 1e-6 * np.abs(want[ok]))))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_rerank_block: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for name, (tmpl, build, query, nq) in CASES.items():
        hamming = "hamming" in tmpl
        ds = get_dataset(tmpl.format(n=HAMMING_N if hamming else N),
                         device="cuda")
        spec = get_functional(name)
        Q = ds.test
        while Q.shape[0] < nq:
            Q = np.concatenate([Q, Q])
        Q = queries_on(Q[:nq], ds.metric, "cuda")

        def timed(state):
            out = spec.search(state, Q, k=K, **query)
            return out, best_s(lambda: spec.search(state, Q, k=K, **query),
                               "cuda")

        mat = spec.build(ds.train, metric=ds.metric, rerank_block=1 << 30,
                         device="cuda", **build)
        (d_mat, i_mat), t_mat = timed(mat)
        C = _width(name, mat, build, query)
        variants = [("picked", {})] + [(b, {"rerank_block": b})
                                       for b in BLOCKS] \
            + [("kernel", {"rerank_kernel": True})]
        out = {"case": name, "b": nq, "C": C, "d": int(ds.train.shape[1]),
               "picked_block": pick_rerank_block(nq, C, ds.train.shape[1],
                                                 K),
               "materialized_ms": t_mat * 1e3}
        for label, extra in variants:
            state = spec.build(ds.train, metric=ds.metric, device="cuda",
                               **build, **extra)
            (d, i), t = timed(state)
            out[str(label)] = {
                "ms": t * 1e3, "x_vs_materialized": t_mat / t,
                "ids_equal": bool(torch.equal(i, i_mat)),
                "dist_tolerance_share": _tolerance_share(d, d_mat)}
        print(json.dumps(out), flush=True)


def _width(name, state, build, query) -> int:
    """The [b, C] window's width at the case's setting (the reference
    bench's ``_candidate_width``)."""
    if name == "IVF":
        return query["n_probes"] * state.stat("pad")
    if name in ("HyperplaneLSH", "E2LSH"):
        return build["n_tables"] * query["n_probes"] * build["cap"]
    if name == "RPForest":
        return build["n_trees"] * query["probe"] * build["leaf_size"]
    bits = state.stat("chunk_bits")
    return build["n_chunks"] * build["cap"] * sum(
        math.comb(bits, r) for r in range(query["radius"] + 1))


if __name__ == "__main__":
    main()
