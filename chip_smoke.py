#!/usr/bin/env python3
"""Smoke run of the PyTorch/Hopper port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

 1. device: the card's name, power limit and top SM clock (``nvidia-smi``)
    and the build of every kernel under ``src/repro_torch/kernels/csrc``
    (nvcc, sm_90a, one process per source);
 2. each kernel against its plain PyTorch version at the main path's
    shapes, with times, bounds and errors: ``stream_topk`` and
    ``rerank_topk`` (every mode), ``hamming_topk`` (10^4 x 10^6 codes of
    256 bits, k = 10 and 100, plus a ragged, masked case) and ``adc_scan``
    (n = 10^6; PQ m = 16 and int8 m = 128 tables; C = 10, 256, 1024);
 3. the paths through ``repro_torch.core.runner.run_benchmark`` in batch
    mode (best of two repetitions), each with the launch counts set to 0
    just before it and read just after:
      * main: ``blobs-euclidean-1000000-d128`` (SIFT-1M's shape: n = 10^6,
        d = 128, 10^4 queries, k = 10) with BruteForce(pallas) and IVF(1024
        lists, rerank_kernel) over n_probes [1, 5, 10]; then BruteForce in
        single-query mode on the first 1,000 queries;
      * hamming: ``random-hamming-1000000-b256`` (sift-256-hamming's shape)
        with BruteForceHamming(pallas), BitsamplingAnnoy(rerank_kernel)
        over probe [1, 4, 16] and MultiIndexHashing(16 chunks,
        rerank_kernel) at radius [0, 1]; then BruteForceHamming in single
        mode on the first 1,000 queries;
      * compressed: the euclidean set with BruteForce(PQ m=16, adc_kernel)
        over n_cand [100, 400, 1000], BruteForce(int8, adc_kernel) at
        n_cand 200, and IVF(1024 lists, rerank_kernel, PQ m=16) at
        n_probes 10 over n_cand [100, 1000]; then the PQ BruteForce on
        ``random-euclidean-1000000-d128`` (the paper's Rand-Euclidean:
        ten neighbours planted at 0.1-0.5 per query), whose recall at
        n_cand 1000 must reach 1 - PQ_EPS;
      * lsh: E2LSH(rerank_kernel) on the euclidean set over n_probes
        [1, 4, 16];
      * angular: ``blobs-angular-200000-d100`` (GloVe-100's width, n cut
        from 1,183,514) with BruteForce, IVF, HyperplaneLSH and RPForest
        (both rerank_kernel) over their probe knobs.
    Recall is the repo's own distance-based measure against exact ground
    truth (``torch.matmul`` or popcount + stable top-k, no kernel).  Exact
    algorithms must give 1.0, every other recall must lie in (0, 1] and
    must not fall as its knob grows.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on its path and its numbers.
Datasets are cached under ``build/data`` beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
K = 10
MAIN = "blobs-euclidean-1000000-d128"
ANGULAR = "blobs-angular-200000-d100"
HAMMING = "random-hamming-1000000-b256"
PLANTED = "random-euclidean-1000000-d128"
PQ16 = {"pq": {"m": 16, "bits": 8}}
# On PLANTED, recall of PQ BruteForce at n_cand 1000 must reach 1 - PQ_EPS.
# Not on MAIN: there the ten neighbours are among ~4,000 points of one
# gaussian blob, whose distances to the query differ by less than the PQ
# reconstruction error, so the ADC order barely ranks inside a blob.
PQ_EPS = 0.05
# CUDA C++ programming guide, arithmetic instruction throughput, compute
# capability 9.0: 32-bit population counts per clock per SM; and the
# shared-memory rate of 32 four-byte words per clock per SM
POPC_PER_CLOCK_SM = 16
LDS_WORDS_PER_CLOCK_SM = 32

# NVIDIA H100 data sheet, dense, without tensor cores for fp32:
# (fp32 FLOP/s, memory bytes/s) per form factor
PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12),
         "NVL": (60e12, 3.9e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def form_factor(name: str) -> str:
    if "PCIe" in name:
        return "PCIe"
    if "NVL" in name:
        return "NVL"
    return "SXM"


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after a warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, got, want_k1, k: int, tol: float, exact: bool = False):
    """Kernel (dist, id) [b, k] against the plain version's [b, k+1]:
    largest distance error, and id mismatches outside near ties (places
    where the plain version's neighbouring distances, the (k+1)-th
    included, lie within ``tol``)."""
    gd, gi = got
    wd, wi = want_k1[0][:, :k + 1], want_k1[1][:, :k + 1]
    fin = torch.isfinite(wd[:, :k])
    check(bool(torch.equal(fin, torch.isfinite(gd))),
          "kernel and plain disagree on which slots are filled")
    err = (gd - wd[:, :k]).abs()[fin]
    max_err = float(err.max()) if err.numel() else 0.0
    bad = gi != wi[:, :k]
    gap = (wd[:, 1:] - wd[:, :-1]).abs() <= tol
    near = torch.zeros_like(bad)
    near[:, 1:] |= gap[:, :k - 1]
    near |= gap[:, :k]
    outside = int((bad & ~near).sum())
    at_ties = int((bad & near).sum())
    if exact:
        check(max_err == 0.0 and int(bad.sum()) == 0,
              "hamming kernel is not bit-exact")
    return max_err, outside, at_ties


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr}")
    clock_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    for name, text in kernels.BUILD_INFO.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(json.dumps({"phase": "build", "seconds": round(build_s, 3),
                    "max_sm_clock_hz": clock_hz}))
    return smi_line, clock_hz


def phase_stream_topk(torch, peaks):
    """Kernel 1 against its plain version: the main path's exact shape
    (l2sq, k=10, 10^4 queries) and nq=4096 for every mode and k."""
    from repro_torch.kernels.distance_topk import (stream_topk_kernel,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance_topk.ops import _corpus_row, _query_col

    flops_peak, bytes_peak = peaks
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = 1_000_000, 128
    X = torch.randn((n, d), generator=gen, device="cuda")
    Qall = torch.randn((10_000, d), generator=gen, device="cuda")
    main = None
    for mode, k, nq in [("l2sq", 10, 10_000), ("l2sq", 10, 4096),
                        ("l2sq", 100, 4096),
                        ("ip", 10, 4096), ("ip", 100, 4096),
                        ("cos", 10, 4096), ("cos", 100, 4096)]:
        Xm, Q = X, Qall[:nq].contiguous()
        if mode == "cos":
            Xm = X / X.norm(dim=1, keepdim=True)
            Q = Q / Q.norm(dim=1, keepdim=True)
        qsq, xsq = _query_col(Q, mode), _corpus_row(Xm, mode)
        got = stream_topk_kernel(Q, Xm, qsq, xsq, mode=mode, k=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = stream_topk_plain(Q, Xm, qsq, xsq, mode=mode, k=k + 1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        tol = 2e-3
        max_err, outside, at_ties = compare(torch, got, want, k, tol)
        ms = cuda_ms(torch, lambda: stream_topk_kernel(
            Q, Xm, qsq, xsq, mode=mode, k=k), reps=3)
        flops = 2.0 * nq * n * d
        nbytes = 4.0 * (nq * d + n * d + nq + n) + 8.0 * nq * k
        bound_ms = max(flops / flops_peak, nbytes / bytes_peak) * 1e3
        rec = {"kernel": "stream_topk", "mode": mode, "k": k, "nq": nq,
               "n": n, "d": d, "max_abs_err": max_err, "tol": tol,
               "id_mismatch_outside_near_ties": outside,
               "id_mismatch_at_near_ties": at_ties, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if flops / flops_peak
               >= nbytes / bytes_peak else "bytes",
               "tflops": flops / ms / 1e9}
        log(json.dumps(rec))
        check(max_err <= tol, f"stream_topk {mode} k={k}: error {max_err}")
        check(outside == 0, f"stream_topk {mode} k={k}: {outside} id "
              f"mismatches outside near ties")
        if main is None:
            main = rec
        del got, want, Xm, Q, qsq, xsq
    del X, Qall
    torch.cuda.empty_cache()
    return main


def phase_rerank_topk(torch, peaks, ivf_state, Q):
    """Kernel 2 against its plain version on the windows IVF produces for
    the main path (n_probes=5 under the max_probes=10 cap), in l2sq, cos
    and ham (ham: 128-bit codes drawn for the same rows)."""
    from repro_torch.ann import ivf
    from repro_torch.kernels.rerank_topk import (rerank_topk_kernel,
                                                 rerank_topk_plain)
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    flops_peak, bytes_peak = peaks
    Qp, cand, valid = ivf.probe_window(ivf_state, Q, n_probes=5,
                                       max_probes=10)
    b, C = cand.shape
    bad = ~valid
    rows = cand[valid]
    n_valid = int(rows.numel())
    n_rows = int(torch.unique(rows).numel())
    del rows
    X = ivf_state["X"]
    n, d = X.shape
    log(json.dumps({"phase": "rerank_window", "b": b, "C": C,
                    "pad": ivf_state.stat("pad"), "valid_candidates": n_valid,
                    "distinct_rows": n_rows}))
    gen = torch.Generator(device="cuda").manual_seed(1)
    main = None
    for metric, k in [("euclidean", 10), ("euclidean", 100),
                      ("angular", 10), ("angular", 100),
                      ("hamming", 10), ("hamming", 100)]:
        if metric == "euclidean":
            Xm, Qm = X, Qp
            qsq = torch.sum(Qm * Qm, dim=1, keepdim=True)
            xsq = ivf_state["xsq"]
        elif metric == "angular":
            Xm = X / X.norm(dim=1, keepdim=True)
            Qm = Qp / Qp.norm(dim=1, keepdim=True)
            qsq = xsq = None
        else:
            Xm = torch.randint(-2**31, 2**31 - 1, (n, 4), generator=gen,
                               device="cuda", dtype=torch.int32)
            Qm = torch.randint(-2**31, 2**31 - 1, (b, 4), generator=gen,
                               device="cuda", dtype=torch.int32)
            qsq = xsq = None
        ops = kernel_operands(Qm, Xm, qsq, xsq, cand, bad, ivf_state["ids"],
                              metric, k)
        got = rerank_topk_kernel(**ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rerank_topk_plain(**dict(ops, k=k + 1))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        tol = 0.0 if metric == "hamming" else 2e-3
        max_err, outside, at_ties = compare(torch, got, want, k, tol,
                                            exact=metric == "hamming")
        ms = cuda_ms(torch, lambda: rerank_topk_kernel(**ops), reps=3)
        words = Xm.shape[1]
        flops = 2.0 * n_valid * words
        nbytes = (12.0 * b * C + 4.0 * b * (words + 1)
                  + 4.0 * n_rows * words + 8.0 * b * k)
        bound_ms = max(flops / flops_peak, nbytes / bytes_peak) * 1e3
        mode = ops["mode"]
        rec = {"kernel": "rerank_topk", "mode": mode, "k": k, "b": b,
               "C": C, "d": words, "max_abs_err": max_err, "tol": tol,
               "id_mismatch_outside_near_ties": outside,
               "id_mismatch_at_near_ties": at_ties, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if flops / flops_peak
               >= nbytes / bytes_peak else "bytes",
               "gbytes_per_s": nbytes / ms / 1e6}
        log(json.dumps(rec))
        check(max_err <= tol, f"rerank_topk {mode} k={k}: error {max_err}")
        check(outside == 0, f"rerank_topk {mode} k={k}: {outside} id "
              f"mismatches outside near ties")
        if main is None:
            main = rec
        del ops, got, want, Xm, Qm
    del Qp, cand, valid, bad
    torch.cuda.empty_cache()
    return main


def phase_breakdown(torch, ivf_state, Q):
    """Where a query batch spends its time, stage by stage (host clock
    around synchronized stages): IVF at the main path's window (10^4
    queries, n_probes=5 under cap 10) and one BruteForce query alone."""
    from repro_torch.ann import ivf
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.distance_topk.ops import _corpus_row, _query_col
    from repro_torch.kernels.rerank_topk import rerank_topk_kernel
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    timed(lambda: ivf.search(ivf_state, Q, k=K, n_probes=5, max_probes=10))
    (Qp, cand, valid), window_ms = timed(lambda: ivf.probe_window(
        ivf_state, Q, n_probes=5, max_probes=10))
    qsq = torch.sum(Qp * Qp, dim=1, keepdim=True)
    ops, operands_ms = timed(lambda: kernel_operands(
        Qp, ivf_state["X"], qsq, ivf_state["xsq"], cand, ~valid,
        ivf_state["ids"], "euclidean", K))
    _, kernel_ms = timed(lambda: rerank_topk_kernel(**ops))
    _, search_ms = timed(lambda: ivf.search(ivf_state, Q, k=K, n_probes=5,
                                            max_probes=10))
    log(json.dumps({"phase": "breakdown", "what": "IVF search, b=10000",
                    "probe_window_ms": window_ms,
                    "kernel_operands_ms": operands_ms,
                    "rerank_kernel_ms": kernel_ms,
                    "search_total_ms": search_ms}))
    del Qp, cand, valid, ops
    X = ivf_state["X"]
    q1 = torch.as_tensor(Q[:1]).to("cuda")
    qsq1, xsq = _query_col(q1, "l2sq"), _corpus_row(X, "l2sq")
    one_ms = cuda_ms(torch, lambda: stream_topk_kernel(
        q1, X, qsq1, xsq, mode="l2sq", k=K), reps=20)
    log(json.dumps({"phase": "breakdown", "what": "stream_topk, nq=1",
                    "kernel_ms": one_ms}))


def phase_hamming_topk(torch, peaks, clock_hz):
    """Kernel 3 against its plain version: 10^4 queries against 10^6
    codes of 256 bits (8 words), padded as ``ops.hamming_topk`` pads them
    (rows past n_valid masked), k = 10 and 100; and a small ragged case
    whose padding rows are copies of the queries (distance 0: they must
    never win).  Ids and distances must be bitwise equal."""
    from repro_torch.kernels.hamming import (hamming_topk_kernel,
                                             hamming_topk_plain)

    _, bytes_peak = peaks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_rate = POPC_PER_CLOCK_SM * sms * clock_hz
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, w, nq = 1_000_000, 8, 10_000

    def words(rows):
        return torch.randint(-2**31, 2**31 - 1, (rows, w), generator=gen,
                             device="cuda", dtype=torch.int32)

    X = words(n)
    Q = words(nq)
    Q[: nq // 2] = X[torch.randint(0, n, (nq // 2,), generator=gen,
                                   device="cuda")] ^ (1 << 7)
    pad = torch.nn.functional.pad
    Xp = pad(X, (0, 0, 0, (-n) % 512)).contiguous()
    Qp = pad(Q, (0, 0, 0, (-nq) % 64)).contiguous()
    small_q = words(77)
    small_x = torch.cat([words(5000), small_q, small_q]).contiguous()
    main = None
    for k, Qm, Xm, n_valid in [(10, Qp, Xp, n), (100, Qp, Xp, n),
                               (10, small_q, small_x, 5000)]:
        got = hamming_topk_kernel(Qm, Xm, n_valid, k=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = hamming_topk_plain(Qm, Xm, n_valid, k=k)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        exact = bool(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]))
        ms = cuda_ms(torch, lambda: hamming_topk_kernel(Qm, Xm, n_valid,
                                                        k=k), reps=3)
        rows_q = Qm.shape[0]
        ops = float(rows_q) * n_valid * w           # popcounts
        nbytes = 4.0 * (rows_q * w + Xm.shape[0] * w) + 8.0 * rows_q * k
        rec = {"kernel": "hamming_topk", "k": k, "nq": rows_q,
               "n": int(Xm.shape[0]), "n_valid": n_valid, "words": w,
               "bitwise_equal": exact,
               "max_abs_err": float((got[0] - want[0]).abs().max()),
               "id_mismatch": int((got[1] != want[1]).sum()), "ms": ms,
               "plain_ms": plain_ms,
               "bound_ms": max(ops / popc_rate, nbytes / bytes_peak) * 1e3,
               "bound_by": "operations" if ops / popc_rate
               >= nbytes / bytes_peak else "bytes",
               "popcount_rate_per_s": popc_rate,
               "gpopc_per_s": ops / ms / 1e6}
        log(json.dumps(rec))
        check(exact, f"hamming_topk k={k} n_valid={n_valid}: not bitwise "
              f"equal to its plain version")
        check(bool((got[1] < n_valid).all()),
              "hamming_topk: a padding row won")
        if main is None:
            main = rec
        del got, want
    del X, Q, Xp, Qp
    torch.cuda.empty_cache()
    return main


def phase_adc_scan(torch, peaks, clock_hz):
    """Kernel 4 against its plain version over n = 10^6 codes: the
    compressed path's grid shape (PQ m = 16, b = 10^4 queries, C = 1000)
    first, then b = 4,096 (BruteForce's batch block) for PQ (m = 16: 16 KB
    tables) and int8 (m = 128: 128 KB tables, one query per block) at
    C = 10, 256, 1024.  Tables are random floats, codes random bytes."""
    from repro_torch.kernels.adc_scan import adc_scan_kernel, adc_scan_plain
    from repro_torch.kernels.adc_scan.adc_scan import plan

    flops_peak, bytes_peak = peaks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lds_rate = LDS_WORDS_PER_CLOCK_SM * sms * clock_hz
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, K = 1_000_000, 256
    main = None
    for codec, m, b, C in [("pq", 16, 10_000, 1000), ("pq", 16, 4096, 10),
                           ("pq", 16, 4096, 256), ("pq", 16, 4096, 1024),
                           ("int8", 128, 4096, 10), ("int8", 128, 4096, 256),
                           ("int8", 128, 4096, 1024)]:
        codes = torch.randint(0, K, (n, m), generator=gen, device="cuda",
                              dtype=torch.uint8)
        luts = torch.rand((b, m, K), generator=gen, device="cuda")
        got = adc_scan_kernel(codes, luts, k=C)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = adc_scan_plain(codes, luts, k=C + 1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        tol = 1e-5
        max_err, outside, at_ties = compare(torch, got, want, C, tol)
        ms = cuda_ms(torch, lambda: adc_scan_kernel(codes, luts, k=C),
                     reps=3)
        adds = float(b) * n * m
        nbytes = float(n) * m + 4.0 * b * m * K + 8.0 * b * C
        p = plan(b, n, m, K, C, sms)
        rec = {"kernel": "adc_scan", "codec": codec, "m": m, "K": K, "b": b,
               "n": n, "C": C, "queries_per_block": p["G"],
               "tables_in_shared_memory": p["lut_smem"],
               "splits": p["splits"], "max_abs_err": max_err, "tol": tol,
               "id_mismatch_outside_near_ties": outside,
               "near_tie_swaps": at_ties, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(adds / flops_peak, nbytes / bytes_peak) * 1e3,
               "bound_by": "operations" if adds / flops_peak
               >= nbytes / bytes_peak else "bytes",
               "lookup_bound_ms": adds / lds_rate * 1e3,
               "glookups_per_s": adds / ms / 1e6}
        log(json.dumps(rec))
        check(max_err <= tol, f"adc_scan {codec} C={C}: error {max_err}")
        check(outside == 0, f"adc_scan {codec} C={C}: {outside} id "
              f"mismatches outside near ties")
        if main is None:
            main = rec
        del codes, luts, got, want
    torch.cuda.empty_cache()
    return main


def config():
    """Every definition the paths run, by point type and metric; a path
    picks its own with ``algorithms=``."""
    bruteforce = {"constructor": "BruteForce", "base-args": ["@metric"],
                  "run-groups": {"kernel": {"args": ["pallas"]}}}
    ivf = {"constructor": "IVF", "base-args": ["@metric"],
           "run-groups": {"kernel": {
               "args": [1024, 10, 0, False, None, True],
               "query-args": [[1, 5, 10]]}}}
    euclidean = {
        "bruteforce": bruteforce, "ivf": ivf,
        "bf_pq": {"constructor": "BruteForce", "base-args": ["@metric"],
                  "run-groups": {"adc": {
                      "args": ["jnp", 65536, False, 4096, PQ16, True, True],
                      "query-args": [[100, 400, 1000]]}}},
        "bf_int8": {"constructor": "BruteForce", "base-args": ["@metric"],
                    "run-groups": {"adc": {
                        "args": ["jnp", 65536, False, 4096, {"int8": {}},
                                 True, True],
                        "query-args": [[200]]}}},
        "ivf_pq": {"constructor": "IVF", "base-args": ["@metric"],
                   "run-groups": {"adc": {
                       "args": [1024, 10, 0, False, None, True, PQ16],
                       "query-args": [[10], [None], [100, 1000]]}}},
        "e2lsh": {"constructor": "E2LSH", "base-args": ["@metric"],
                  "run-groups": {"kernel": {
                      "args": [8, 8, 4.0, 64, 0, True],
                      "query-args": [[1, 4, 16]]}}},
    }
    angular = {
        "bruteforce": bruteforce, "ivf": ivf,
        "hyperplane": {"constructor": "HyperplaneLSH",
                       "base-args": ["@metric"],
                       "run-groups": {"kernel": {
                           "args": [8, 16, 64, 0, True],
                           "query-args": [[1, 4, 16]]}}},
        "rpforest": {"constructor": "RPForest", "base-args": ["@metric"],
                     "run-groups": {"kernel": {
                         "args": [10, 32, 0, True],
                         "query-args": [[1, 4, 16]]}}},
    }
    hamming = {
        "bfh": {"constructor": "BruteForceHamming", "base-args": ["@metric"],
                "run-groups": {"kernel": {"args": ["pallas"]}}},
        "annoy": {"constructor": "BitsamplingAnnoy", "base-args": ["@metric"],
                  "run-groups": {"kernel": {
                      "args": [10, 32, 0, False, None, True],
                      "query-args": [[1, 4, 16]]}}},
        "mih": {"constructor": "MultiIndexHashing", "base-args": ["@metric"],
                "run-groups": {"kernel": {
                    "args": [16, 128, 0, False, None, True],
                    "query-args": [[0, 1]]}}},
    }
    return {"float": {"euclidean": euclidean, "angular": angular},
            "bit": {"hamming": hamming}}


EXACT = ("bruteforce", "bfh")


def _counted():
    from repro_torch.kernels.adc_scan import adc_scan_kernel
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.hamming import hamming_topk_kernel
    from repro_torch.kernels.rerank_topk import rerank_topk_kernel

    return {"stream_topk": stream_topk_kernel,
            "rerank_topk": rerank_topk_kernel,
            "hamming_topk": hamming_topk_kernel, "adc_scan": adc_scan_kernel}


def reset_counters():
    for fn in _counted().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in _counted().items()}


def _knobs(r):
    return tuple(a for a in r.query_arguments if a is not None)


def check_records(records, dataset: str, n: int, groups: dict):
    """Every definition gave its records (``groups``: algorithm -> number
    of query-args groups), ids are corpus rows or -1 (approximate
    algorithms pad with -1 when their window holds fewer than k points;
    exact ones never do), exact algorithms have recall 1.0, every other
    recall lies in (0, 1] and does not fall as its knob grows."""
    from repro_torch.core.metrics import recall

    out = {}
    for algo, n_groups in groups.items():
        recs = sorted((r for r in records if r.algorithm == algo), key=_knobs)
        check(len(recs) == n_groups,
              f"{dataset}: {algo} gave {len(recs)} records, not {n_groups}")
        rows = []
        for r in recs:
            found = r.neighbors >= 0
            check(r.neighbors.shape == (r.nq, K)
                  and bool((r.neighbors >= -1).all())
                  and bool((r.neighbors < n).all())
                  and (algo not in EXACT or bool(found.all())),
                  f"{dataset}: {r.instance_name} returned malformed "
                  f"neighbors")
            check(bool(np.isfinite(r.distances[found]).all()),
                  f"{dataset}: {r.instance_name} has non-finite distances")
            rec = {"dataset": dataset, "algorithm": algo,
                   "instance": r.instance_name,
                   "query_args": list(r.query_arguments),
                   "mode": "batch" if r.batch_mode else "single", "nq": r.nq,
                   "empty_slots": int((~found).sum()),
                   "recall": recall(r), "qps": r.qps,
                   "build_s": r.build_time, "index_kb": r.index_size_kb,
                   "attrs": {k: v for k, v in r.attrs.items()
                             if isinstance(v, (int, float, bool))}}
            log(json.dumps(rec))
            rows.append(rec)
        rec_all = [o["recall"] for o in rows]
        if algo in EXACT:
            check(all(x == 1.0 for x in rec_all),
                  f"{dataset}: {algo} recall {rec_all} != 1.0")
        check(all(0.0 < x <= 1.0 for x in rec_all),
              f"{dataset}: {algo} recall out of range: {rec_all}")
        check(all(a <= b for a, b in zip(rec_all, rec_all[1:])),
              f"{dataset}: {algo} recall falls as its knob grows: {rec_all}")
        out[algo] = rows
    return out


def run_path(torch, name: str, dataset: str, groups: dict, n: int,
             kernels: tuple):
    """One path through run_benchmark (batch mode, best of two
    repetitions) with the launch counts set to 0 just before it and read
    just after; every kernel of the path must have launched."""
    from repro_torch.core.runner import run_benchmark

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counters()
    records = run_benchmark(dataset, config(), count=K, batch=True,
                            algorithms=list(groups), repetitions=2,
                            device="cuda")
    launches = read_counters()
    log(json.dumps({"phase": name, "dataset": dataset, "launches": launches,
                    "seconds": time.perf_counter() - t0,
                    "max_memory_allocated":
                    torch.cuda.max_memory_allocated()}))
    rows = check_records(records, dataset, n, groups)
    check(all(launches[k] > 0 for k in kernels),
          f"{name}: a kernel of the path never launched: {launches}")
    return launches, rows


def run_single(torch, name: str, ds, algo: str, kernel: str):
    """``algo`` in single-query mode on the first 1,000 queries: exactly
    one launch of ``kernel`` per query."""
    from repro_torch.core.config import get_definitions
    from repro_torch.core.experiment import ExperimentSettings, run_definition
    from repro_torch.data.datasets import Dataset

    first = Dataset(name=ds.name, train=ds.train, test=ds.test[:1000],
                    neighbors=ds.neighbors[:1000],
                    distances=ds.distances[:1000], metric=ds.metric,
                    point_type=ds.point_type)
    definition = get_definitions(config(), point_type=ds.point_type,
                                 metric=ds.metric, dimension=ds.dimension,
                                 count=K, algorithms=[algo])[0]
    reset_counters()
    single = run_definition(definition, first, ExperimentSettings(
        count=K, batch_mode=False, device="cuda"))
    launches = read_counters()
    log(json.dumps({"phase": name, "launches": launches}))
    check_records(single, ds.name, ds.n, {algo: 1})
    check(launches[kernel] == 1000,
          f"single mode launched {kernel} {launches[kernel]} times for "
          f"1000 queries")
    return launches


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    os.environ["REPRO_DATA_DIR"] = str(ROOT / "build" / "data")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS[form_factor(name)]
    log(json.dumps({"phase": "device", "name": name,
                    "form_factor": form_factor(name),
                    "fp32_flops": peaks[0], "bytes_per_s": peaks[1],
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    # 1. device + build
    smi_line, clock_hz = phase_device(torch)

    # 2. kernels against their plain versions
    k1 = phase_stream_topk(torch, peaks)
    k3 = phase_hamming_topk(torch, peaks, clock_hz)
    k4 = phase_adc_scan(torch, peaks, clock_hz)
    from repro_torch.ann import ivf
    from repro_torch.data import get_dataset

    ds = get_dataset(MAIN, device="cuda")
    check(ds.train.shape == (1_000_000, 128) and ds.test.shape[0] == 10_000,
          f"{MAIN} has shape {ds.train.shape} / {ds.test.shape}")
    state = ivf.build(ds.train, metric="euclidean", n_clusters=1024,
                      rerank_kernel=True, device="cuda")
    k2 = phase_rerank_topk(torch, peaks, state, ds.test)
    phase_breakdown(torch, state, ds.test)
    del state
    torch.cuda.empty_cache()

    # 3. the paths, through the runner
    main_launches, _ = run_path(torch, "main_path", MAIN,
                                {"bruteforce": 1, "ivf": 3}, ds.n,
                                ("stream_topk", "rerank_topk"))
    run_single(torch, "single_query", ds, "bruteforce", "stream_topk")
    torch.cuda.empty_cache()

    comp_launches, _ = run_path(
        torch, "compressed", MAIN, {"bf_pq": 3, "bf_int8": 1, "ivf_pq": 2},
        ds.n, ("adc_scan", "rerank_topk"))
    run_path(torch, "lsh_euclidean", MAIN, {"e2lsh": 3}, ds.n,
             ("rerank_topk",))
    del ds
    torch.cuda.empty_cache()
    _, planted = run_path(torch, "compressed_planted", PLANTED, {"bf_pq": 3},
                          1_000_000, ("adc_scan",))
    deepest = planted["bf_pq"][-1]["recall"]
    check(deepest >= 1.0 - PQ_EPS,
          f"{PLANTED}: PQ recall {deepest} at n_cand 1000 is below "
          f"1 - {PQ_EPS}")
    torch.cuda.empty_cache()

    hds = get_dataset(HAMMING, device="cuda")
    check(hds.train.shape == (1_000_000, 8) and hds.test.shape[0] == 10_000,
          f"{HAMMING} has shape {hds.train.shape} / {hds.test.shape}")
    ham_launches, _ = run_path(torch, "hamming", HAMMING,
                               {"bfh": 1, "annoy": 3, "mih": 2}, hds.n,
                               ("hamming_topk", "rerank_topk"))
    run_single(torch, "hamming_single_query", hds, "bfh", "hamming_topk")
    del hds
    torch.cuda.empty_cache()

    run_path(torch, "angular", ANGULAR,
             {"bruteforce": 1, "ivf": 3, "hyperplane": 3, "rpforest": 3},
             200_000, ("stream_topk", "rerank_topk"))

    no_library = ("no single PyTorch call computes a fused distance + "
                  "(unique) top-k")
    kernels = [
        {"name": "stream_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/stream_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/distance_topk.py:122",
         "launches": main_launches["stream_topk"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "library_note": no_library},
        {"name": "rerank_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rerank_topk.cu",
         "replaces": "src/repro/kernels/rerank_topk/rerank_topk.py:153",
         "launches": main_launches["rerank_topk"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "library_note": no_library},
        {"name": "hamming_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming_topk.cu",
         "replaces": "src/repro/kernels/hamming/hamming.py:55",
         "launches": ham_launches["hamming_topk"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "library_note": "no PyTorch call computes a popcount distance; "
                         "no single call fuses it with a top-k"},
        {"name": "adc_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/adc_scan.cu",
         "replaces": "src/repro/kernels/adc_scan/adc_scan.py:96",
         "launches": comp_launches["adc_scan"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "library_note": "no single PyTorch call computes a table-lookup "
                         "sum with a top-k"},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
