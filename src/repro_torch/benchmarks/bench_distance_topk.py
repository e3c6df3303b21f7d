"""Streaming fused distance + top-k against materialise-then-top-k
(``benchmarks/bench_distance_topk.py`` of the reference).

The claim under test: at equal device memory the streaming kernel handles
a corpus at least 4x larger than the materialising path, with no recall
change -- both paths' results are held to the brute-force oracle on every
shape.

Memory model per query batch (fp32):
    materialise:  nq*n*4   (the [nq, n] distance matrix in device memory)
    streaming:    nq*k*8   (the (dist, id) lists; X is read in place)

On the card ``materialize`` is the distance-matrix kernel followed by a
stable top-k and ``streaming`` the streaming top-k kernel, both timed by
CUDA events; with ``device="cpu"`` both run their plain versions.

    python -m repro_torch.benchmarks.bench_distance_topk [--scale smoke]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import Row, timed

# corpus sizes per scale: full exercises the 1M-row regime the paper's
# datasets live in; smoke keeps a CPU run under seconds.
NS = {
    "smoke": [2_000, 8_000],
    "default": [64_000, 256_000],
    "full": [64_000, 256_000, 1_000_000],
}


def _mat_bytes(nq: int, n: int) -> int:
    return 4 * nq * n


def _stream_bytes(nq: int, k: int) -> int:
    return 8 * nq * k


def _gate(got, want, n: int):
    """The no-recall-change gate: distances within 1e-4, ids equal for
    more than 99.9 % of the slots."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert np.mean(got[1] == want[1]) > 0.999, n


def _np(pair):
    return tuple(t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
                 for t in pair)


def run(scale: str = "default", device=None):
    from repro_torch.ann.topk import topk_with_ids
    from repro_torch.kernels.distance import distance_matrix
    from repro_torch.kernels.distance_topk import (stream_topk,
                                                   stream_topk_batched,
                                                   stream_topk_ref)

    dev = resolve_device(device)
    rows = []
    rng = np.random.default_rng(0)
    nq = 16 if scale == "smoke" else 64
    d = 32 if scale == "smoke" else 64
    k = 10

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    for n in NS.get(scale, NS["default"]):
        X = tensor(rng.standard_normal((n, d)))
        Q = tensor(rng.standard_normal((nq, d)))
        ids = torch.arange(n, dtype=torch.int32, device=dev)[None, :]

        def materialize():
            D = distance_matrix(Q, X, mode="l2sq")
            return topk_with_ids(D, ids.expand(D.shape), k)

        def streaming():
            return stream_topk(Q, X, k=k, metric="euclidean")

        us_mat = timed(materialize, n=2, warmup=1, device=dev)
        us_str = timed(streaming, n=2, warmup=1, device=dev)
        want = _np(stream_topk_ref(Q, X, k=k, mode="l2sq"))
        _gate(_np(materialize()), want, n)
        _gate(_np(streaming()), want, n)
        ratio = _mat_bytes(nq, n) / _stream_bytes(nq, k)
        rows.append(Row(f"distance_topk/materialize_n{n}", us_mat,
                        f"peak_bytes={_mat_bytes(nq, n)}"))
        rows.append(Row(f"distance_topk/streaming_n{n}", us_str,
                        f"peak_bytes={_stream_bytes(nq, k)};"
                        f"capacity_ratio={ratio:.0f}x"))

    # equal-memory capacity: with the budget the materialising path needs
    # for the SMALLEST n, the streaming path runs 4x the LARGEST n (its
    # per-batch state does not depend on n) -- still exact.
    n_small, n_big = NS.get(scale, NS["default"])[0], \
        4 * NS.get(scale, NS["default"])[-1]
    if scale == "smoke":      # keep it fast but still >= 4x the small case
        n_big = 4 * n_small
    budget = _mat_bytes(nq, n_small)
    assert _stream_bytes(nq, k) <= budget, "streaming state exceeds budget"
    Xb = tensor(rng.standard_normal((n_big, d)))
    Qb = tensor(rng.standard_normal((nq, d)))

    def batched():
        return stream_topk_batched(Qb, Xb, k=k, metric="euclidean",
                                   query_block=nq, materialize=False)

    us = timed(batched, n=1, warmup=0, device=dev)
    _gate(_np(batched()), _np(stream_topk_ref(Qb, Xb, k=k, mode="l2sq")),
          n_big)
    rows.append(Row(f"distance_topk/equal_mem_4x_n{n_big}", us,
                    f"budget_bytes={budget};exact=1;"
                    f"n_vs_materialize={n_big / n_small:.0f}x"))
    return rows


if __name__ == "__main__":
    import argparse
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("--scale", default="default",
                   choices=["smoke", "default", "full"])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args()
    print("name,us_per_call,derived")
    for row in run(args.scale, args.device):
        print(row.csv())
    print(f"# bench_distance_topk OK ({args.scale})", file=sys.stderr)
