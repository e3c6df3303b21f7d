"""Kernel microbenchmarks (``benchmarks/bench_kernels.py`` of the
reference): each kernel of the port at the reference bench's shapes, with
its own least time on the card and its parity.

A row is ``kernel/<name>_cuda`` when its kernel ran on the card and
``kernel/<name>_plain`` when the plain version ran on the CPU (the
reference's ``_pallas_interpret`` rows); ``bruteforce_two_pass_torch`` is
the reference's ``_jnp`` two-pass baseline, here the distance-matrix
kernel followed by a stable top-k.  ``derived`` carries, on the card,
``bound_us`` (the larger of the operations over their peak rate and the
bytes over the memory rate, from :mod:`.common`'s peaks) and
``bound_by``; always ``parity``: the largest error, or the share of equal
ids, against the plain version on the same card, or against the oracle
(``ref.py``) where the plain version is what ran.  Parity is a gate: a
row outside its tolerance (``DIST_TOL`` for distances, bit for bit for
hamming_topk and, on the card, embedding_bag) raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import (POPC_PER_CLOCK_SM, Row, bound,
                                           card_peaks, max_sm_clock_hz,
                                           timed)
from repro_torch.bits import words_to_tensor

# rtol, atol of a distance against the plain version or the oracle (the
# distance-matrix kernel's stated tolerance); embedding_bag on the card is
# held bit for bit, decode_attention (fp32) within 1e-5, 1e-5.
DIST_TOL = (1e-5, 1e-4)


def _ids_equal(rtol, atol):
    """Share of equal ids; holds when every slot's distance agrees within
    ``rtol``/``atol`` (ids then differ only where distances tie)."""
    def parity(got, want):
        share = float((got[1] == want[1]).float().mean())
        return f"ids_equal:{share:.4f}", _close(got[0], want[0], rtol, atol)
    return parity


def _max_err(rtol, atol):
    """Largest error; holds within ``rtol``/``atol``."""
    def parity(got, want):
        err = (got.to(torch.float32) - want.to(torch.float32)).abs().max()
        return f"max_abs_err:{float(err):.3g}", _close(got, want, rtol, atol)
    return parity


def _bitwise(got, want):
    """Holds when every output tensor is bit for bit the plain version's."""
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    return f"bitwise:{int(same)}", same


def _close(got, want, rtol, atol) -> bool:
    g, w = got.to(torch.float32), want.to(torch.float32)
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


class _Rows:
    """Times each op, holds it against its plain version (card) or its
    oracle (CPU), and formats the row.  A row whose parity does not hold
    raises: the bench is a gate, not only a report."""

    def __init__(self, dev):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.flops, self.bw = card_peaks(dev)
        self.rows = []

    def add(self, name, op, plain, oracle, parity, *, ops, nbytes,
            ops_rate=None, extra=()):
        us = timed(op, device=self.dev)
        got = op()
        want = plain() if self.cuda else oracle()
        route = "cuda" if self.cuda else "plain"
        name = name.format(route=route)
        text, holds = parity(got, want)
        if not holds:
            against = "plain version" if self.cuda else "oracle"
            raise AssertionError(f"{name}: parity {text} against the "
                                 f"{against} is outside its tolerance")
        derived = []
        if self.cuda:
            b_us, by = bound(ops, nbytes, ops_rate or self.flops, self.bw)
            derived += [f"bound_us={b_us:.1f}", f"bound_by={by}"]
        derived += list(extra) + [f"parity={text}"]
        self.rows.append(Row(name, us, ";".join(derived)))


def run(scale: str = "default", device=None):
    from repro_torch.ann.topk import topk_smallest
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_plain,
                                                 decode_attention_ref)
    from repro_torch.kernels.distance import (distance_matrix,
                                              distance_matrix_plain,
                                              distance_matrix_ref)
    from repro_torch.kernels.distance.distance import norm_operand
    from repro_torch.kernels.distance_topk import (stream_topk,
                                                   stream_topk_plain,
                                                   stream_topk_ref)
    from repro_torch.kernels.embedbag import (embedding_bag,
                                              embedding_bag_plain,
                                              embedding_bag_ref)
    from repro_torch.kernels.embedbag.ops import bag_runs
    from repro_torch.kernels.hamming import (hamming_topk, hamming_topk_plain,
                                             hamming_topk_ref)

    dev = resolve_device(device)
    R = _Rows(dev)
    rng = np.random.default_rng(0)
    nq, n, d, k = (64, 8192, 128, 10) if scale != "smoke" else \
        (16, 1024, 64, 10)

    Q = torch.as_tensor(rng.standard_normal((nq, d)), dtype=torch.float32,
                        device=dev)
    X = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                        device=dev)
    qsq, xsq = norm_operand(Q, "l2sq"), norm_operand(X, "l2sq")
    dists = _ids_equal(*DIST_TOL)

    # two-pass: the full matrix, then a top-k (the memory-bound baseline)
    flops = 2.0 * nq * n * d
    bytes_2p = 4.0 * (nq * d + n * d + 2 * nq * n)
    R.add("kernel/bruteforce_two_pass_torch",
          lambda: topk_smallest(distance_matrix(Q, X, mode="l2sq"), k),
          lambda: topk_smallest(distance_matrix_plain(
              Q, X, qsq, xsq, mode="l2sq"), k),
          lambda: stream_topk_ref(Q, X, k=k),
          dists, ops=flops, nbytes=bytes_2p)

    bytes_fused = 4.0 * (nq * d + n * d) + 8.0 * nq * k
    R.add("kernel/stream_topk_{route}",
          lambda: stream_topk(Q, X, k=k, metric="euclidean"),
          lambda: stream_topk_plain(Q, X, qsq, xsq, mode="l2sq", k=k),
          lambda: stream_topk_ref(Q, X, k=k),
          dists, ops=flops, nbytes=bytes_fused,
          extra=[f"hbm_bytes_saved="
                 f"{(bytes_2p - bytes_fused) / 1e6:.1f}MB"])

    R.add("kernel/distance_matrix_{route}",
          lambda: distance_matrix(Q, X, mode="l2sq"),
          lambda: distance_matrix_plain(Q, X, qsq, xsq, mode="l2sq"),
          lambda: distance_matrix_ref(Q, X, mode="l2sq"),
          _max_err(*DIST_TOL), ops=flops, nbytes=bytes_2p - 4.0 * nq * n)

    # hamming
    w = 8
    Qh = rng.integers(0, 2**32, (nq, w), dtype=np.uint64).astype(np.uint32)
    Xh = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    Qw, Xw = words_to_tensor(Qh, dev), words_to_tensor(Xh, dev)
    popc_rate = None
    if R.cuda:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        popc_rate = POPC_PER_CLOCK_SM * sms * max_sm_clock_hz()
    R.add("kernel/hamming_topk_{route}",
          lambda: hamming_topk(Qw, Xw, k=k),
          lambda: hamming_topk_plain(Qw, Xw, n, k=k),
          lambda: hamming_topk_ref(Qw, Xw, k=k),
          _bitwise, ops=float(nq) * n * w,
          nbytes=4.0 * (nq * w + n * w) + 8.0 * nq * k, ops_rate=popc_rate)

    # embedding bag
    V, D, N, B = 10000, 64, 4096, 512
    table = torch.as_tensor(rng.standard_normal((V, D)), dtype=torch.float32,
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, V, N), dtype=torch.int32,
                          device=dev)
    bags = torch.as_tensor(np.sort(rng.integers(0, B, N)), dtype=torch.int32,
                           device=dev)
    ones = torch.ones(N, dtype=torch.float32, device=dev)
    R.add("kernel/embedding_bag_{route}",
          lambda: embedding_bag(table, idx, bags, n_bags=B,
                                assume_sorted=True),
          lambda: embedding_bag_plain(idx, ones, table,
                                      bag_runs(bags, n_bags=B), n_bags=B),
          lambda: embedding_bag_ref(idx, bags, ones, table, n_bags=B),
          _bitwise if R.cuda else _max_err(1e-5, 1e-5), ops=2.0 * N * D,
          nbytes=8.0 * N + 4.0 * (N * D + B * D))

    # decode attention
    Bq, H, KV, S, dh = 4, 8, 4, 2048, 64
    q = torch.as_tensor(rng.standard_normal((Bq, H, dh)), dtype=torch.float32,
                        device=dev)
    kk = torch.as_tensor(rng.standard_normal((Bq, S, KV, dh)),
                         dtype=torch.float32, device=dev)
    vv = torch.as_tensor(rng.standard_normal((Bq, S, KV, dh)),
                         dtype=torch.float32, device=dev)
    full = torch.full((Bq,), S, dtype=torch.int32, device=dev)
    G = H // KV

    def oracle():
        qg = q.reshape(Bq, KV, G, dh)
        return torch.stack([decode_attention_ref(qg[:, h], kk[:, :, h],
                                                 vv[:, :, h], full)
                            for h in range(KV)], dim=1).reshape(Bq, H, dh)

    R.add("kernel/decode_attention_{route}",
          lambda: decode_attention(q, kk, vv, bs=256),
          lambda: decode_attention_plain(q, kk, vv, full, bs=256),
          oracle, _max_err(1e-5, 1e-5), ops=4.0 * Bq * H * S * dh,
          nbytes=4.0 * (2 * Bq * S * KV * dh + 2 * Bq * H * dh) + 4.0 * Bq)
    return R.rows
