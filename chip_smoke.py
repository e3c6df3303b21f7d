#!/usr/bin/env python3
"""Smoke run of the PyTorch/Hopper port on one CUDA card.

    python3 chip_smoke.py [--before DIR]

``--before DIR`` names the ``src/repro_torch/kernels/csrc`` of a checkout
of the parent commit: its kernels 1, 2, 4, 5 and 6 are built beside the
tree's and timed on the same inputs in the same run (parent, tree, tree,
parent), the BruteForce and IVF traces are taken on both, and IVF's
recall, search time and grid sweep are measured on both (the parent's
IVF: the window of the probed lists through its kernel 2), on the main
and angular sets; kernel 2's parent is also timed on each consumer's
window, and each consumer's search with it in the new kernel's place;
kernel 4's and kernel 6's parents must give the new kernel's answer bit
for bit at every shape, and the PQ and int8 BruteForce searches run with
each kernel 4 in its place (ids equal, recall equal, timed in turns).
Without it the run is the tree's alone.

Phases (any failure exits non-zero; nothing is caught and passed over):

 1. device: the card's name, power limit and top SM clock (``nvidia-smi``)
    and the build of every kernel under ``src/repro_torch/kernels/csrc``
    (nvcc, sm_90a, one process per source);
 2. each kernel against its plain PyTorch version at the main path's
    shapes, with times, bounds and errors: ``stream_topk`` (10^4 x 10^6 x
    128 at k = 10, and nq = 4,096 at k = 10, 100 and 256 in every mode,
    each with its launch plan: query rows per tile, splits, shared bytes,
    resident blocks per SM), ``rerank_topk``'s two entries on IVF's
    window (the generic entry in every mode, the list entry in l2sq and
    cos, bit for bit with the generic entry, each with its plan; both
    within ``EXACT_REL`` of the exact value) and the generic entry on the
    windows of its consumers, captured from their own searches (E2LSH and
    IVF-PQ on the main set, HyperplaneLSH and RPForest on the angular set,
    BitsamplingAnnoy and MIH on the Hamming set), ``hamming_topk`` (10^4 x
    10^6 codes of 256 bits, k = 10 and 100, plus a ragged, masked case) and
    ``adc_scan`` (n = 10^6; PQ m = 16 and int8 m = 128 tables; C = 10,
    256, 1024 at b = 4,096, the grid shape b = 10^4, C = 1,000 and int8 at
    b = 10^4, C = 200; bit for bit, each with its plan, the share of the
    lookup bound and ptxas's registers, no variant spilling);
    ``distance_matrix`` (1,024 x 10^6 x 128, every mode; the k = 256 route
    through it equals ``stream_topk`` bit for bit; k = 257 and 1,000),
    the other distances-out routes (``hamming_topk`` at k = 1,000,
    ``rerank_topk`` at k = 1,000 on IVF's window, ``adc_scan`` at
    C = 1,500), ``embedding_bag`` (Criteo-1TB's largest table, 39,884,406
    rows, 524,288 lookups: 65,536 bags of 8 on average, one a bag and 100
    a bag at D = 128 fp32, 65,536 bags in bf16 and at D = 16 and 10; bit
    for bit, each with its plan and ptxas's registers, no variant
    spilling, timed in CUDA graphs) and
    ``decode_attention`` (phi-4-mini at decode_32k: B = 128, 24 heads over
    8 KV heads, dh = 128, S = 32,768; gemma3-27b at long_500k: B = 1, 32
    heads over 16 KV heads, S = 524,288; bf16, within one bf16 ulp of the
    plain version at the kernel's partitions, each case's partition and
    combine passes timed apart by ``torch.profiler``; and fp32 at the
    kernel bench's shape).  Each new kernel is also timed against one
    PyTorch call that computes the same function (``library_ms``), which
    the port never calls;
 3. the paths through ``repro_torch.core.runner.run_benchmark`` in batch
    mode (best of two repetitions), each with the launch counts set to 0
    just before it and read just after:
      * main: ``blobs-euclidean-1000000-d128`` (SIFT-1M's shape: n = 10^6,
        d = 128, 10^4 queries, k = 10) with BruteForce(pallas) and IVF(1024
        lists, rerank_kernel: the list entry) over n_probes [1, 5, 10];
        then BruteForce in single-query mode on the first 1,000 queries;
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
    Before the paths, one ``stream_topk_batched`` call at the main path's
    shape (the 10^4 queries of the main set against its 10^6 rows, k = 10,
    one query block as the runner sends it), one ``ivf.search`` (n_probes
    5 under cap 10), one PQ BruteForce search (n_cand 1000) and one IVF-PQ
    search (n_probes 10, n_cand 1000) under ``torch.profiler``: the device
    time of each kernel and the idle share of the call's window; IVF's
    recall, search time and sweep (``ivf_compare``) and its stages (coarse
    quantizer, pair build, list kernel, merge); the PQ and int8
    BruteForce searches' recall and time (``adc_searches``).
    Between them and the paths, on the main set's IVF state, the ``tune``
    phase: ``tune.grid_search`` over all 10^4 queries, n_probes 1-32 x
    scan {256, pad}, max QPS s.t. recall >= 0.9 (best of 3 passes; each
    sweep row equal to its static search in ids, recall not falling with
    n_probes, the chosen point the fastest feasible one; every point
    logged), then ``launch.tune`` at its default dataset, which must
    choose a config; and the ``mutate`` phase: MutableIVF (1,024 lists,
    ``rerank_kernel``) from the first 10^6 - 16,384 rows, 8 times insert
    1,024 held-out rows / delete the batch of two iterations before /
    search all queries at n_probes 10, every base row that is a query's
    nearest neighbour deleted after the first insert (recall within 0.02
    of the frozen IVF's, against the exact oracle over the live rows; no
    deleted or unknown id returned; 198 of 200 queries equal to the same
    state's plain path on the CPU in ids; ms per insert, delete and
    search; then ``compact()``), and MutableBruteForce on the
    same churn (1,000 queries equal to the live-row oracle in ids before
    and after ``compact()``; a state kept from before the last insert
    gives its earlier answer); then the ``serve`` phase on the same IVF
    state: ``repro_torch.serve.Engine`` in micro-batches of 256 over IVF
    (n_probes 10 under max_probes 32) and BruteForce(pallas), each equal
    to its direct search over the 10^4 queries bit for bit (the Engine
    takes them from the host, as a caller sends them), one IVF
    micro-batch traced (device time, idle share); 1,000
    ``submit()``s equal to ``search()``'s rows, a per-request n_probes 4
    equal to the static search at 4, n_probes 33 refused, an expired
    request answered with DeadlineExceeded beside answered ones; the IVF
    engine's checkpoint saved and loaded bit for bit (a save cut by an
    injected truncation refused on load); and an Engine over MutableIVF
    (the same rows, one insert of 1,024 rows, every query's nearest base
    row deleted) against the live-row oracle before, during and after a
    background compaction, a failed one (an injected CompactionError)
    leaving its answers as they were.
    Recall is the repo's own distance-based measure against exact ground
    truth (``torch.matmul`` or popcount + stable top-k, no kernel).  Exact
    algorithms must give 1.0, every other recall must lie in (0, 1] and
    must not fall as its knob grows.
    After them, the graphs path (no TPU kernel: the beam search is torch
    ops): KNNGraph(degree 16) and HNSW(M 16, efC 80) on
    ``blobs-euclidean-10000-d128`` (SIFT's width; n cut because HNSW's
    build is a host loop of ~4 ms a point, and cut from 20,000 to keep the
    smoke near 600 s) and KNNGraph on the angular set, at ef [16, 64];
    then HNSW in single-query mode on the same index (the builds are kept,
    ``kept_builds``); for each index the first 100 queries on the card
    against a CPU copy of the same state, through the static path and the
    grid sweep the runner times (at least 99 equal in ids, and in
    expansions on the static path; each that differs is logged), and one
    batched search of each family at ef 64 under ``torch.profiler``
    (device launches, device ms, idle share).
 4. the bench path, counts set to 0 before and read after:
    ``repro_torch.benchmarks.run --scale default --only kernels,stream``
    and ``bench_distance_topk`` at ``full`` (n up to 10^6, equal-memory
    4 * 10^6); every kernel it reaches (1, 3, 5, 6, 7) must launch and
    every gate of the benches must hold: each kernel row against its plain
    version at the bench's own shapes (distances within rtol 1e-5, atol
    1e-4; hamming_topk and embedding_bag bit for bit; decode_attention
    within 1e-5), and both the materialising (kernel 5 + top-k) and the
    streaming top-k against the oracle at every n.  Then the figure path:
    ``repro_torch.benchmarks.run --scale smoke --only fig4,...,fig11``
    (n = 2,000), counts set to 0 before and read after: every module
    prints its rows (``FIGURE_ROWS``), and kernels 1 (fig11's
    BruteForce(pallas)) and 3 (fig9's BruteForceHamming(pallas)) launch.
    Last the ``benches`` phase: ``bench_sweep``, ``bench_tune``,
    ``bench_pq`` and ``bench_engine`` at ``default`` (n = 20,000), every
    gate holding and kernel 4 launching in ``bench_pq``.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its numbers and its launches, summed over the ANN
paths of phase 3 with the ``tune``, ``mutate``, ``serve`` and ``benches``
phases (kernels 1-4 and kernel 2's list entry) or on the bench path
(kernels 5-7).
Datasets are cached under ``build/data`` beside this script.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
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
# The graph family's SIFT-width set: n cut from 10^6 because HNSW's build
# is the reference's host loop (~4 ms a point on one core), and from the
# figure benches' 20,000 to keep the smoke near 600 s.
GRAPHS = "blobs-euclidean-10000-d128"
FIGURES = "fig4,fig5,fig6,fig8,fig9,fig10,fig11"
# rows each figure bench prints at --scale smoke (its config's runs;
# run_benchmark reports a failed definition and goes on, so a missing row
# is a failure here)
FIGURE_ROWS = {"fig4": 21, "fig5": 4, "fig6": 6, "fig8": 4, "fig9": 6,
               "fig10": 5, "fig11": 6}
PQ16 = {"pq": {"m": 16, "bits": 8}}
# On PLANTED, recall of PQ BruteForce at n_cand 1000 must reach 1 - PQ_EPS.
# Not on MAIN: there the ten neighbours are among ~4,000 points of one
# gaussian blob, whose distances to the query differ by less than the PQ
# reconstruction error, so the ADC order barely ranks inside a blob.
PQ_EPS = 0.05
# The card's peaks (fp32 FLOP/s, bytes/s; popcounts and shared-memory
# words per clock per SM) are in repro_torch/benchmarks/common.py.


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


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


def clocks_under(torch, fn, seconds: float = 2.0):
    """Median SM clock (MHz) and power draw (W) of the card while ``fn``
    runs back to back for ``seconds``: ``nvidia-smi`` sampled from a
    thread, the first third of the samples (the ramp) dropped."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60)
            parts = r.stdout.strip().splitlines()[0].split(",") \
                if r.returncode == 0 and r.stdout.strip() else []
            if len(parts) == 2:
                samples.append((float(parts[0]), float(parts[1])))
            stop.wait(0.2)

    thread = threading.Thread(target=sample)
    thread.start()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    kept = samples[len(samples) // 3:]
    check(bool(kept), "nvidia-smi gave no clock samples")
    clock = sorted(c for c, _ in kept)[len(kept) // 2]
    power = sorted(w for _, w in kept)[len(kept) // 2]
    return clock, power


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
              "kernel is not bit-exact against its plain version")
    return max_err, outside, at_ties


class Before:
    """The parent commit's kernels 1, 2, 4, 5 and 6, built from ``--before
    DIR`` and launched with the parent's wrappers' arguments, for same-call
    comparisons.  The parent's kernel 1 takes a launch plan (query rows,
    splits, rows per split): it is given this tree's ``kernel_plan``;
    kernel 2's parent takes the window operands of the generic entry;
    kernel 4's parent takes this tree's ``kernel_plan`` (its wrapper is
    the parent's); kernel 6's parent takes ``bag_runs``' runs."""

    SOURCES = ("stream_topk", "distance_matrix", "rerank_topk", "adc_scan",
               "embedding_bag")

    def __init__(self, src_dir: str):
        self.src = Path(src_dir).resolve()
        for name in self.SOURCES:
            check((self.src / f"{name}.cu").is_file(),
                  f"--before: {self.src / name}.cu not found")
        self.out = ROOT / "build" / "before"
        self.procs = []
        self.libs = {}

    def start_build(self):
        from repro_torch import kernels

        self.out.mkdir(parents=True, exist_ok=True)
        for name in self.SOURCES:
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                   str(self.out / f"lib{name}.so"),
                   str(self.src / f"{name}.cu")]
            self.procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))

    def finish_build(self):
        import ctypes

        for name, proc in self.procs:
            text, _ = proc.communicate()
            check(proc.returncode == 0, f"--before: nvcc {name}: {text}")
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  before {name}: {line.strip()}")
            self.libs[name] = ctypes.CDLL(str(self.out / f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = self.libs["stream_topk"].stream_topk_launch
        fn.argtypes = [p] * 8 + [i] * 8 + [p]
        fn.restype = i
        fn = self.libs["distance_matrix"].distance_matrix_launch
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_longlong, i, p]
        fn.restype = i
        fn = self.libs["rerank_topk"].rerank_topk_launch
        fn.argtypes = [p] * 8 + [i] * 5 + [p]
        fn.restype = i
        fn = self.libs["adc_scan"].adc_scan_launch
        fn.argtypes = [p] * 6 + [i] * 13 + [p]
        fn.restype = i
        fn = self.libs["embedding_bag"].embedding_bag_launch
        fn.argtypes = [p] * 7 + [i] * 3 + [p]
        fn.restype = i

    def stream_topk(self, Q, X, qsq, xsq, *, mode: str, k: int):
        import torch

        from repro_torch.kernels.distance_topk.distance_topk import (
            MODES, kernel_plan)

        nq, d = Q.shape
        n = X.shape[0]
        plan = kernel_plan(Q, X, k, mode)
        part_d = torch.empty((plan.splits, nq, k), device="cuda")
        part_i = torch.empty((plan.splits, nq, k), dtype=torch.int32,
                             device="cuda")
        out_d = torch.empty((nq, k), device="cuda")
        out_i = torch.empty((nq, k), dtype=torch.int32, device="cuda")
        status = self.libs["stream_topk"].stream_topk_launch(
            Q.data_ptr(), X.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), nq, n, d, k, MODES[mode], plan.rows,
            plan.splits, plan.rows_per_split,
            torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"before stream_topk: CUDA error {status}")
        return out_d, out_i

    def distance_matrix(self, Q, X, qsq, xsq, *, mode: str):
        import torch

        from repro_torch.kernels.distance.distance import MODES

        nq, d = Q.shape
        n = X.shape[0]
        out = torch.empty((nq, n), device="cuda")
        status = self.libs["distance_matrix"].distance_matrix_launch(
            Q.data_ptr(), X.data_ptr(), qsq.data_ptr(), xsq.data_ptr(),
            out.data_ptr(), nq, n, d, n, MODES[mode],
            torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"before distance_matrix: CUDA error {status}")
        return out


    def rerank_topk(self, cand_rows, Q, qsq, cand_ids, pen, X, *, mode: str,
                    k: int):
        import torch

        from repro_torch.kernels.rerank_topk.rerank_topk import MODES

        b, C = cand_rows.shape
        out_d = torch.empty((b, k), device="cuda")
        out_i = torch.empty((b, k), dtype=torch.int32, device="cuda")
        status = self.libs["rerank_topk"].rerank_topk_launch(
            cand_rows.data_ptr(), Q.data_ptr(), qsq.data_ptr(),
            cand_ids.data_ptr(), pen.data_ptr(), X.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), b, C, X.shape[1], k,
            MODES[mode], torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"before rerank_topk: CUDA error {status}")
        return out_d, out_i

    def adc_scan(self, codes, luts, *, k: int):
        import torch

        from repro_torch.kernels.adc_scan.adc_scan import kernel_plan

        n, m = codes.shape
        b, _, K = luts.shape
        p = kernel_plan(codes, luts, k)
        out_d = torch.empty((b, k), device="cuda")
        out_i = torch.empty((b, k), dtype=torch.int32, device="cuda")
        part_d, part_i = out_d, out_i
        if p["splits"] > 1:
            part_d = torch.empty((p["splits"], b, k), device="cuda")
            part_i = torch.empty((p["splits"], b, k), dtype=torch.int32,
                                 device="cuda")
        status = self.libs["adc_scan"].adc_scan_launch(
            codes.data_ptr(), luts.data_ptr(), part_d.data_ptr(),
            part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b, n, m,
            K, k, p["P"], p["BUF"], p["G"], p["R"], p["threads"],
            int(p["lut_smem"]), p["splits"], p["rows"],
            torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"before adc_scan: CUDA error {status}")
        return out_d, out_i

    def embedding_bag(self, indices, weights, table, runs, *, n_bags: int):
        """The parent's kernel 6 as its wrapper launched it: the runs of
        ``bag_runs`` (one warp a run) into a zero-filled output."""
        import torch

        start, end, bag = runs
        out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                          device="cuda")
        status = self.libs["embedding_bag"].embedding_bag_launch(
            indices.data_ptr(), weights.data_ptr(), table.data_ptr(),
            start.data_ptr(), end.data_ptr(), bag.data_ptr(), out.data_ptr(),
            start.shape[0], table.shape[1],
            0 if table.dtype == torch.float32 else 1,
            torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"before embedding_bag: CUDA error {status}")
        return out


def parent_ivf_search(torch, state, Q, before, *, n_probes, k: int = K,
                      max_probes: int = 10):
    """IVF's fp32 search as the parent ran it with ``rerank_kernel``: the
    window of the probed lists, the kernel's operands, the parent's
    kernel 2."""
    from repro_torch.ann import ivf
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    Qp, cand, valid = ivf.probe_window(state, Q, n_probes=n_probes,
                                       max_probes=max_probes)
    qsq = torch.sum(Qp * Qp, dim=1, keepdim=True) \
        if state.metric == "euclidean" else None
    ops = kernel_operands(Qp, state["X"], qsq, state.arrays.get("xsq"), cand,
                          ~valid, state["ids"], state.metric,
                          min(k, cand.shape[1]))
    return before.rerank_topk(**ops)


def same_call(torch, before_fn, after_fn, reps: int, timer=None):
    """Parent and tree timed in turns (parent, tree, tree, parent), each a
    ``cuda_ms`` of ``reps`` launches, or ``timer(fn, reps)``: ``{"before":
    [ms, ms], "after": [ms, ms]}``."""
    if timer is None:
        def timer(fn, reps):
            return cuda_ms(torch, fn, reps)
    b1 = timer(before_fn, reps)
    a1 = timer(after_fn, reps)
    a2 = timer(after_fn, reps)
    b2 = timer(before_fn, reps)
    return {"before": [b1, b2], "after": [a1, a2]}


def phase_device(torch, before):
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
    if before is not None:
        before.start_build()
    kernels.build_all()
    if before is not None:
        before.finish_build()
    build_s = time.perf_counter() - t0
    for name, text in kernels.BUILD_INFO.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(json.dumps({"phase": "build", "seconds": round(build_s, 3),
                    "max_sm_clock_hz": clock_hz}))
    return smi_line, clock_hz


def phase_stream_topk(torch, peaks, before):
    """Kernel 1 against its plain version: the main path's exact shape
    (l2sq, k=10, 10^4 queries) and nq=4096 for every mode at k = 10, 100
    and 256, each case with its launch plan; with ``before``, the parent's
    kernel timed in turns with the tree's on the same inputs."""
    from repro_torch.kernels.distance_topk import (stream_topk_kernel,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance_topk.distance_topk import (
        blocks_per_sm, kernel_plan)
    from repro_torch.kernels.distance.distance import norm_operand

    flops_peak, bytes_peak = peaks
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = 1_000_000, 128
    X = torch.randn((n, d), generator=gen, device="cuda")
    Qall = torch.randn((10_000, d), generator=gen, device="cuda")
    main = None
    for mode, k, nq in [("l2sq", 10, 10_000), ("l2sq", 10, 4096),
                        ("l2sq", 100, 4096), ("l2sq", 256, 4096),
                        ("ip", 10, 4096), ("ip", 100, 4096),
                        ("ip", 256, 4096),
                        ("cos", 10, 4096), ("cos", 100, 4096),
                        ("cos", 256, 4096)]:
        Xm, Q = X, Qall[:nq].contiguous()
        if mode == "cos":
            Xm = X / X.norm(dim=1, keepdim=True)
            Q = Q / Q.norm(dim=1, keepdim=True)
        qsq, xsq = norm_operand(Q, mode), norm_operand(Xm, mode)
        got = stream_topk_kernel(Q, Xm, qsq, xsq, mode=mode, k=k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = stream_topk_plain(Q, Xm, qsq, xsq, mode=mode, k=k + 1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        tol = 2e-3
        max_err, outside, at_ties = compare(torch, got, want, k, tol)
        plan = kernel_plan(Q, Xm, k, mode)

        def after():
            return stream_topk_kernel(Q, Xm, qsq, xsq, mode=mode, k=k)

        pair = None
        if before is None:
            ms = cuda_ms(torch, after, reps=3)
        else:
            old = before.stream_topk(Q, Xm, qsq, xsq, mode=mode, k=k)
            pair = same_call(torch, lambda: before.stream_topk(
                Q, Xm, qsq, xsq, mode=mode, k=k), after, reps=3)
            pair["before_equals_after_bitwise"] = bool(
                torch.equal(old[0], got[0]) and torch.equal(old[1], got[1]))
            ms = sum(pair["after"]) / 2
            del old
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
               "tflops": flops / ms / 1e9,
               "plan": {"query_rows": plan.rows, "splits": plan.splits,
                        "rows_per_split": plan.rows_per_split,
                        "smem_bytes": plan.smem,
                        "blocks_per_sm": blocks_per_sm(plan.rows, k, True,
                                                       mode)},
               "same_call": pair}
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


def phase_bruteforce_trace(torch, ds, before):
    """One ``stream_topk_batched`` call at the main path's shape (the 10^4
    queries of the main set against its 10^6 rows, k = 10, one query
    block: the runner sends the batch whole) under ``torch.profiler``:
    the device time of each kernel (the stream pass, the merge of the
    splits, the torch norm ops) and the idle share of the call's window.
    With ``before``, the same call on the parent's kernel."""
    from repro_torch.kernels.distance_topk import ops, stream_topk_batched

    X = torch.as_tensor(ds.train).to("cuda")   # as the index holds it

    def call():   # the queries come from the host, as the runner's do
        stream_topk_batched(ds.test, X, k=K, metric="euclidean",
                            query_block=ds.test.shape[0], materialize=False)

    runs = [("after", None)]
    if before is not None:
        runs = [("before", before.stream_topk), ("after", None)]
    out = {}
    for label, fn in runs:
        kept = ops.stream_topk_kernel
        if fn is not None:
            ops.stream_topk_kernel = fn
        try:
            by_name, idle, window_ms = profile_call(torch, call)
        finally:
            ops.stream_topk_kernel = kept
        rec = {"phase": "bruteforce_trace", "kernel": label,
               "nq": int(ds.test.shape[0]), "n": int(ds.train.shape[0]),
               "k": K, "window_ms": window_ms, "idle_share": idle,
               "device_ms": {name[:120]: ms for name, ms in
                             sorted(by_name.items(), key=lambda x: -x[1])}}
        log(json.dumps(rec))
        out[label] = rec
    del X
    torch.cuda.empty_cache()
    return out


def _entry_rec(name, rec, ms, pair, flops, nbytes, peaks):
    flops_peak, bytes_peak = peaks
    return dict(rec, kernel=name, ms=ms, same_call=pair,
                bound_ms=max(flops / flops_peak, nbytes / bytes_peak) * 1e3,
                bound_by="operations" if flops / flops_peak
                >= nbytes / bytes_peak else "bytes",
                gbytes_per_s=nbytes / ms / 1e6, tflops=flops / ms / 1e9)


def phase_rerank_topk(torch, peaks, ivf_state, Q, before):
    """Kernel 2's two entries against the plain version on the window IVF
    probes for the main path (n_probes 5 under the max_probes 10 cap, as
    0-d device tensors like the grid sweep's): the generic entry in l2sq,
    cos and ham (128-bit codes drawn for the same rows) at k = 10 and 100;
    the list entry (IVF's route) in l2sq and cos at k = 10, 100 and 256,
    each bit for bit with the generic entry on the window.  Each float
    case must lie within ``EXACT_REL`` of the exact value of the kernel's
    expression (``err_vs_exact``).  With ``before``, the parent's kernel
    timed in turns with each new entry on the same operands, and its
    error against the exact value."""
    from repro_torch.ann import ivf
    from repro_torch.kernels.rerank_topk import (EXACT_REL, err_vs_exact,
                                                 lists, rerank_lists_kernel,
                                                 rerank_topk_kernel,
                                                 rerank_topk_plain)
    from repro_torch.kernels.rerank_topk.ops import kernel_operands

    n_probes = torch.tensor(5, dtype=torch.int32, device="cuda")
    Qp, probes = ivf.coarse_probes(ivf_state, Q, n_probes=n_probes,
                                   max_probes=10)
    X = ivf_state["X"]
    n, d = X.shape
    starts, sizes = ivf_state["starts"], ivf_state["sizes"]
    ids, M = ivf_state["ids"], ivf_state.stat("pad")
    cand, valid = lists.list_window(probes, starts, sizes, M, n,
                                    n_probes=n_probes)
    b, C = cand.shape
    bad = ~valid
    rows = cand[valid]
    n_valid = int(rows.numel())
    n_rows = int(torch.unique(rows).numel())
    del rows
    probed = torch.zeros(starts.shape[0], dtype=torch.bool, device="cuda")
    probed[probes[:, :5].reshape(-1)] = True
    list_rows = int(torch.clamp_max(sizes[probed], M).sum())
    log(json.dumps({"phase": "rerank_window", "b": b, "C": C, "pad": M,
                    "valid_candidates": n_valid, "distinct_rows": n_rows,
                    "probed_list_rows": list_rows}))
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for metric, k in [("euclidean", 10), ("euclidean", 100),
                      ("euclidean", 256), ("angular", 10), ("angular", 100),
                      ("angular", 256), ("hamming", 10), ("hamming", 100)]:
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
        ops = kernel_operands(Qm, Xm, qsq, xsq, cand, bad, ids, metric, k)
        mode = ops["mode"]
        got = rerank_topk_kernel(**ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rerank_topk_plain(**dict(ops, k=k + 1))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        tol = 0.0 if metric == "hamming" else 2e-3
        max_err, outside, at_ties = compare(torch, got, want, k, tol,
                                            exact=metric == "hamming")
        check(max_err <= tol and outside == 0,
              f"rerank_topk {mode} k={k}: error {max_err}, {outside} id "
              f"mismatches outside near ties")

        def generic():
            return rerank_topk_kernel(**ops)

        old = pair_g = None
        if before is not None:
            old = before.rerank_topk(**ops)
            pair_g = same_call(torch, lambda: before.rerank_topk(**ops),
                               generic, reps=3)
            ms = sum(pair_g["after"]) / 2
        else:
            ms = cuda_ms(torch, generic, reps=3)
        words = Xm.shape[1]
        base = {"mode": mode, "k": k, "b": b, "C": C, "d": words,
                "max_abs_err": max_err, "tol": tol,
                "id_mismatch_outside_near_ties": outside,
                "id_mismatch_at_near_ties": at_ties, "plain_ms": plain_ms}
        if metric != "hamming":
            err, rel = err_vs_exact(got, **ops)
            base.update(max_err_vs_exact=err, max_rel_err_vs_exact=rel,
                        exact_rel_bound=EXACT_REL)
            check(rel <= EXACT_REL, f"rerank_topk {mode} k={k}: error "
                  f"{err} ({rel} of the cross term's weight) against the "
                  f"exact value, above {EXACT_REL}")
            if old is not None:
                err, rel = err_vs_exact(old, **ops)
                base.update(before_max_err_vs_exact=err,
                            before_max_rel_err_vs_exact=rel)
        rec = _entry_rec("rerank_topk", base, ms, pair_g,
                         2.0 * n_valid * words,
                         12.0 * b * C + 4.0 * b * (words + 1)
                         + 4.0 * n_rows * words + 8.0 * b * k, peaks)
        log(json.dumps(rec))
        out[("generic", mode, k)] = rec
        if metric != "hamming":
            qv = qsq.reshape(b) if qsq is not None else \
                torch.zeros(b, device="cuda")

            def listed():
                return rerank_lists_kernel(
                    Qm, qv, Xm, xsq, probes, starts, sizes, ids, M=M,
                    mode=mode, k=k, n_probes=n_probes)

            got_l = listed()
            same = bool(torch.equal(got_l[0], got[0])
                        and torch.equal(got_l[1], got[1]))
            check(same, f"rerank_lists {mode} k={k}: not bit for bit the "
                  f"generic entry on the window")
            l_err, l_outside, l_ties = compare(torch, got_l, want, k, tol)
            pair_l = None
            if before is not None:
                pair_l = same_call(torch, lambda: before.rerank_topk(**ops),
                                   listed, reps=3)
                l_ms = sum(pair_l["after"]) / 2
            else:
                l_ms = cuda_ms(torch, listed, reps=3)
            plan = lists.launch_plan(b, probes.shape[1], starts.shape[0],
                                     M, k)
            # each probed list's rows once, the queries, the partial lists
            # of the live slots and the outputs
            nbytes = 4.0 * words * list_rows + 4.0 * b * (words + 1) \
                + 8.0 * b * 5 * plan.kp + 8.0 * b * k
            rec = _entry_rec(
                "rerank_lists", dict(base, max_abs_err=l_err,
                                     id_mismatch_outside_near_ties=l_outside,
                                     id_mismatch_at_near_ties=l_ties,
                                     bitwise_equal_to_generic=same,
                                     plan=plan._asdict(),
                                     blocks_per_sm=lists.blocks_per_sm(
                                         plan.kp, True, mode)),
                l_ms, pair_l, 2.0 * n_valid * words, nbytes, peaks)
            log(json.dumps(rec))
            out[("lists", mode, k)] = rec
        del ops, got, want, Xm, Qm, old
    del Qp, probes, cand, valid, bad
    torch.cuda.empty_cache()
    return out[("generic", "l2sq", 10)], out[("lists", "l2sq", 10)]


def consumers():
    """The generic entry's consumers, each with its dataset, its build as
    its path's ``config()`` gives it and a search at the path's largest
    knob."""
    from repro_torch.ann import hamming, ivf, lsh, rpforest

    return [
        ("E2LSH n_probes 16", MAIN,
         lambda X: lsh.e2lsh_build(X, n_tables=8, n_hashes=8, width=4.0,
                                   cap=64, seed=0, rerank_kernel=True,
                                   device="cuda"),
         lambda st, Q: lsh.e2lsh_search(st, Q, k=K, n_probes=16)),
        ("IVF-PQ n_probes 10 n_cand 1000", MAIN,
         lambda X: ivf.build(X, metric="euclidean", n_clusters=1024,
                             n_iters=10, seed=0, rerank_kernel=True,
                             quantize=PQ16, device="cuda"),
         lambda st, Q: ivf.search(st, Q, k=K, n_probes=10, n_cand=1000)),
        ("HyperplaneLSH n_probes 16", ANGULAR,
         lambda X: lsh.hyperplane_build(X, n_tables=8, n_bits=16, cap=64,
                                        seed=0, rerank_kernel=True,
                                        device="cuda"),
         lambda st, Q: lsh.hyperplane_search(st, Q, k=K, n_probes=16)),
        ("RPForest probe 16", ANGULAR,
         lambda X: rpforest.build(X, metric="angular", n_trees=10,
                                  leaf_size=32, seed=0, rerank_kernel=True,
                                  device="cuda"),
         lambda st, Q: rpforest.search(st, Q, k=K, probe=16)),
        ("BitsamplingAnnoy probe 16", HAMMING,
         lambda X: hamming.bitsampling_build(X, n_trees=10, leaf_size=32,
                                             seed=0, rerank_kernel=True,
                                             device="cuda"),
         lambda st, Q: hamming.bitsampling_search(st, Q, k=K, probe=16)),
        ("MIH radius 1", HAMMING,
         lambda X: hamming.mih_build(X, n_chunks=16, cap=128, seed=0,
                                     rerank_kernel=True, device="cuda"),
         lambda st, Q: hamming.mih_search(st, Q, k=K, radius=1)),
    ]


def phase_rerank_consumers(torch, peaks, main_ds, before):
    """The generic entry on the windows of its consumers (``consumers()``),
    the operands captured from each one's own search: against the plain
    version (distances within 2e-3 and no id mismatch outside near ties;
    ham bit for bit) and, in l2sq and cos, within ``EXACT_REL`` of the
    exact value.  With ``before``, the parent's kernel timed in turns with
    the new one on the captured operands, and the whole search (host
    clock, synchronized, the queries from the host) timed with each kernel
    in its place, parent, new, new, parent."""
    from repro_torch.data import get_dataset
    from repro_torch.kernels.rerank_topk import ops as rerank_ops
    from repro_torch.kernels.rerank_topk import (EXACT_REL, err_vs_exact,
                                                 rerank_topk_plain)

    kept = rerank_ops.rerank_topk_kernel

    def search_with(kernel, st, Q, search):
        rerank_ops.rerank_topk_kernel = kernel
        try:
            return search(st, Q)
        finally:
            rerank_ops.rerank_topk_kernel = kept

    def host_ms(fn, reps=2):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    out, loaded = [], {MAIN: main_ds}
    for label, name, build, search in consumers():
        if name not in loaded:
            loaded = {MAIN: main_ds, name: get_dataset(name, device="cuda")}
        ds = loaded[name]
        st = build(ds.train)
        captured = []

        def capture(**ops):
            captured.append(ops)
            return kept(**ops)

        search_with(capture, st, ds.test, search)
        check(len(captured) == 1, f"{label}: {len(captured)} rerank kernel "
              f"calls in one search, not 1")
        ops = captured[0]
        mode, k = ops["mode"], ops["k"]
        b, C = ops["cand_rows"].shape
        words = ops["X"].shape[1]
        valid = (ops["cand_ids"] >= 0) & torch.isfinite(ops["pen"])
        n_valid = int(valid.sum())
        n_rows = int(torch.unique(ops["cand_rows"][valid]).numel())
        got = kept(**ops)
        want = rerank_topk_plain(**dict(ops, k=k + 1))
        tol = 0.0 if mode == "ham" else 2e-3
        max_err, outside, at_ties = compare(torch, got, want, k, tol,
                                            exact=mode == "ham")
        check(max_err <= tol and outside == 0,
              f"rerank_topk on {label}'s window: error {max_err}, "
              f"{outside} id mismatches outside near ties")
        base = {"window": label, "mode": mode, "k": k, "b": b, "C": C,
                "d": words, "valid_candidates": n_valid,
                "distinct_rows": n_rows, "max_abs_err": max_err, "tol": tol,
                "id_mismatch_at_near_ties": at_ties}
        if mode != "ham":
            err, rel = err_vs_exact(got, **ops)
            base.update(max_err_vs_exact=err, max_rel_err_vs_exact=rel,
                        exact_rel_bound=EXACT_REL)
            check(rel <= EXACT_REL, f"rerank_topk on {label}'s window: "
                  f"{rel} of the cross term's weight from the exact value, "
                  f"above {EXACT_REL}")
        pair = None
        if before is not None:
            pair = same_call(torch, lambda: before.rerank_topk(**ops),
                             lambda: kept(**ops), reps=3)
            ms = sum(pair["after"]) / 2

            def parent(**o):
                return before.rerank_topk(**o)

            def run(kernel):
                return host_ms(lambda: search_with(kernel, st, ds.test,
                                                   search))

            nq = int(ds.test.shape[0])
            searches = {"before": [run(parent)], "after": [run(kept)]}
            searches["after"].append(run(kept))
            searches["before"].append(run(parent))
            base["search_ms"] = searches
            base["search_qps"] = {key: nq / min(v) * 1e3
                                  for key, v in searches.items()}
        else:
            ms = cuda_ms(torch, lambda: kept(**ops), reps=3)
        rec = _entry_rec(
            "rerank_topk", base, ms, pair, 2.0 * n_valid * words,
            12.0 * b * C + 4.0 * b * (words + 1) + 4.0 * n_rows * words
            + 8.0 * b * k, peaks)
        log(json.dumps(rec))
        out.append(rec)
        del st, ops, got, want, captured, valid
        torch.cuda.empty_cache()
    del loaded
    torch.cuda.empty_cache()
    return out


def phase_ivf_trace(torch, ds, state, before):
    """One ``ivf.search`` at the main path's window (10^4 queries from the
    host, n_probes 5 under cap 10) under ``torch.profiler``: the device
    time of each kernel and the idle share of the call's window; with
    ``before``, the parent's search (the window, the operands, the
    parent's kernel 2) the same way."""
    from repro_torch.ann import ivf

    runs = [("after", lambda: ivf.search(state, ds.test, k=K, n_probes=5,
                                         max_probes=10))]
    if before is not None:
        runs.insert(0, ("before", lambda: parent_ivf_search(
            torch, state, ds.test, before, n_probes=5)))
    out = {}
    for label, fn in runs:
        by_name, idle, window_ms = profile_call(torch, fn)
        rec = {"phase": "ivf_trace", "kernel": label,
               "nq": int(ds.test.shape[0]), "n_probes": 5, "max_probes": 10,
               "window_ms": window_ms, "idle_share": idle,
               "device_ms": {name[:120]: ms for name, ms in
                             sorted(by_name.items(), key=lambda x: -x[1])}}
        log(json.dumps(rec))
        out[label] = rec
    return out


def phase_ivf_compare(torch, name, ds, state, before):
    """IVF's recall at n_probes 1, 5 and 10 under cap 10 (the runner's
    measure: distances recomputed, against exact ground truth), its search
    time at n_probes 5 and the three points of the grid sweep back to
    back (host clock, synchronized, best of two; the queries from the
    host, each point's n_probes a 0-d device tensor as ``bind_search``
    passes it).  With ``before``, the parent's search the same way, whose
    recall must equal the new path's within 1e-4."""
    from repro_torch.ann import ivf
    from repro_torch.core.experiment import _distances_for
    from repro_torch.core.metrics import recall_from_arrays

    def new(n_probes):
        return ivf.search(state, ds.test, k=K, max_probes=10,
                          n_probes=torch.tensor(n_probes, dtype=torch.int32,
                                                device="cuda"))

    def old(n_probes):
        return parent_ivf_search(torch, state, ds.test, before,
                                 n_probes=n_probes)

    def best_ms(fn, reps=2):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    routes = [("after", new)] + ([("before", old)] if before else [])
    nq = int(ds.test.shape[0])
    rec = {"phase": "ivf_compare", "dataset": name, "nq": nq}
    for label, search in routes:
        search(5)
        recalls = []
        for n_probes in (1, 5, 10):
            ids = search(n_probes)[1].cpu().numpy()
            dist = _distances_for(ds, ids, "cuda")
            recalls.append(float(np.mean(recall_from_arrays(
                dist, ds.distances, K, neighbors=ids))))
        sweep_ms = best_ms(lambda: [search(p) for p in (1, 5, 10)])
        rec[label] = {"recall": recalls,
                      "search_ms_n_probes_5": best_ms(lambda: search(5), 3),
                      "sweep_ms": sweep_ms,
                      "sweep_qps_uniform_share": 3 * nq / sweep_ms * 1e3}
    log(json.dumps(rec))
    if before is not None:
        diff = max(abs(a - b) for a, b in zip(rec["after"]["recall"],
                                              rec["before"]["recall"]))
        check(diff <= 1e-4, f"{name}: IVF recall moved by {diff} from the "
              f"parent's: {rec}")
    return rec


def phase_breakdown(torch, ivf_state, Q):
    """Where a query batch spends its time, stage by stage (host clock
    around synchronized stages): IVF at the main path's window (10^4
    queries from the host, n_probes 5 under cap 10: the coarse quantizer,
    the pair build, the list kernel, the merge), IVF's whole search at
    n_probes 1, 5 and 10 under the cap, and one BruteForce query alone."""
    from repro_torch.ann import ivf
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.distance.distance import norm_operand
    from repro_torch.kernels.rerank_topk import lists

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    st = ivf_state
    n_p = torch.tensor(5, dtype=torch.int32, device="cuda")
    timed(lambda: ivf.search(st, Q, k=K, n_probes=n_p, max_probes=10))
    (Qp, probes), coarse_ms = timed(lambda: ivf.coarse_probes(
        st, Q, n_probes=n_p, max_probes=10))
    M, n_lists = st.stat("pad"), st["starts"].shape[0]
    plan = lists.launch_plan(Qp.shape[0], probes.shape[1], n_lists, M, K)
    pairs, pair_ms = timed(lambda: lists.pair_build(
        probes, n_p, n_lists, st["sizes"]))
    qsq = torch.sum(Qp * Qp, dim=1)
    (part_d, part_i), list_ms = timed(lambda: lists.list_pass(
        Qp, qsq, st["X"], st["xsq"], st["ids"], None, st["starts"],
        st["sizes"], pairs, plan, M=M, mode="l2sq"))
    _, merge_ms = timed(lambda: lists.merge_pass(part_d, part_i, plan, n_p))
    search_ms = {}
    for n_probes in (1, 5, 10):
        _, search_ms[n_probes] = timed(lambda: ivf.search(
            st, Q, k=K, max_probes=10, n_probes=torch.tensor(
                n_probes, dtype=torch.int32, device="cuda")))
    log(json.dumps({"phase": "breakdown", "what": "IVF search, b=10000",
                    "coarse_quantizer_ms": coarse_ms,
                    "pair_build_ms": pair_ms, "list_kernel_ms": list_ms,
                    "merge_ms": merge_ms, "plan": plan._asdict(),
                    "search_total_ms": search_ms[5],
                    "search_ms_by_n_probes": search_ms}))
    del Qp, probes, pairs, part_d, part_i
    X = ivf_state["X"]
    q1 = torch.as_tensor(Q[:1]).to("cuda")
    qsq1, xsq = norm_operand(q1, "l2sq"), norm_operand(X, "l2sq")
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
    from repro_torch.benchmarks.common import POPC_PER_CLOCK_SM

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


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by mangled name."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"(?:Compiling entry function '|Function "
                        r"properties for )([\w$]+)", line)
        if hit:
            name = hit.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", line)
        if hit:
            out[name]["spill_bytes"] = int(hit.group(1)) + int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name]["registers"] = int(hit.group(1))
    return out


def adc_variants_ptxas() -> dict:
    """ptxas's report of each compiled scan variant of kernel 4, by
    (G, R, threads, tables in shared memory)."""
    import re

    from repro_torch import kernels

    out = {}
    for name, rep in ptxas_report(kernels.BUILD_INFO.get("adc_scan",
                                                         "")).items():
        hit = re.search(r"adc_scan_kernelILi(\d+)ELi(\d+)ELb([01])ELi(\d+)E",
                        name)
        if hit:
            out[(int(hit.group(1)), int(hit.group(2)), int(hit.group(4)),
                 hit.group(3) == "1")] = rep
    return out


def phase_adc_scan(torch, peaks, clock_hz, before):
    """Kernel 4 against its plain version over n = 10^6 codes, bit for bit:
    the compressed path's grid shape (PQ m = 16, b = 10^4 queries,
    C = 1000) first, then b = 4,096 (BruteForce's batch block) for PQ
    (m = 16: 16 KB tables) and int8 (m = 128: 128 KB tables, one query per
    block) at C = 10, 256, 1024, and int8 at the compressed path's b = 10^4,
    C = 200.  Tables are random floats, codes random bytes.  Each shape
    logs its plan (G, R, buffer, splits, shared bytes, resident blocks per
    SM by the occupancy calculator and by the plan's model), the share of
    the lookup bound and ptxas's registers and spills for the variant; no
    variant may spill.  With ``before``, the parent's kernel must give the
    same answer bit for bit and is timed in turns with the new one."""
    from repro_torch.kernels.adc_scan import adc_scan_kernel, adc_scan_plain
    from repro_torch.kernels.adc_scan.adc_scan import (VARIANTS, kernel_plan,
                                                       model_blocks_per_sm)

    flops_peak, bytes_peak = peaks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from repro_torch.benchmarks.common import LDS_WORDS_PER_CLOCK_SM

    lds_rate = LDS_WORDS_PER_CLOCK_SM * sms * clock_hz
    variants = adc_variants_ptxas()
    log(json.dumps({"phase": "adc_ptxas", "variants": {
        f"G={g},R={r},threads={nt},smem={int(sm)}": rep
        for (g, r, nt, sm), rep in sorted(variants.items())}}))
    check(set(variants) == set(VARIANTS) and all(
        rep.get("spill_bytes", 1) == 0 for rep in variants.values()),
        f"adc_scan: ptxas reports spills or misses a variant: {variants}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, K = 1_000_000, 256
    main = None
    for codec, m, b, C in [("pq", 16, 10_000, 1000), ("pq", 16, 4096, 10),
                           ("pq", 16, 4096, 256), ("pq", 16, 4096, 1024),
                           ("int8", 128, 4096, 10), ("int8", 128, 4096, 256),
                           ("int8", 128, 4096, 1024),
                           ("int8", 128, 10_000, 200)]:
        codes = torch.randint(0, K, (n, m), generator=gen, device="cuda",
                              dtype=torch.uint8)
        luts = torch.rand((b, m, K), generator=gen, device="cuda")
        got = adc_scan_kernel(codes, luts, k=C)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = adc_scan_plain(codes, luts, k=C + 1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_err, outside, at_ties = compare(torch, got, want, C, 0.0,
                                            exact=True)

        def after():
            return adc_scan_kernel(codes, luts, k=C)

        pair = None
        if before is None:
            ms = cuda_ms(torch, after, reps=3)
        else:
            old = before.adc_scan(codes, luts, k=C)
            check(bool(torch.equal(old[0], got[0])
                       and torch.equal(old[1], got[1])),
                  f"adc_scan {codec} b={b} C={C}: not bit for bit with the "
                  f"parent's kernel")
            pair = same_call(torch, lambda: before.adc_scan(codes, luts, k=C),
                             after, reps=3)
            pair["before_equals_after_bitwise"] = True
            ms = sum(pair["after"]) / 2
            del old
        adds = float(b) * n * m
        nbytes = float(n) * m + 4.0 * b * m * K + 8.0 * b * C
        p = kernel_plan(codes, luts, C)
        lookup_bound_ms = adds / lds_rate * 1e3
        rec = {"kernel": "adc_scan", "codec": codec, "m": m, "K": K, "b": b,
               "n": n, "C": C, "plan": dict(
                   p, model_blocks_per_sm=model_blocks_per_sm(
                       p["G"], p["R"], p["threads"], p["lut_smem"], p["smem"])),
               "ptxas": variants[(p["G"], p["R"], p["threads"],
                                  p["lut_smem"])],
               "max_abs_err": max_err, "tol": 0.0, "bitwise_equal": True,
               "id_mismatch_outside_near_ties": outside,
               "near_tie_swaps": at_ties, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(adds / flops_peak, nbytes / bytes_peak) * 1e3,
               "bound_by": "operations" if adds / flops_peak
               >= nbytes / bytes_peak else "bytes",
               "lookup_bound_ms": lookup_bound_ms,
               "lookup_bound_share": lookup_bound_ms / ms,
               "glookups_per_s": adds / ms / 1e6, "same_call": pair}
        log(json.dumps(rec))
        if main is None:
            main = rec
        del codes, luts, got, want
    torch.cuda.empty_cache()
    return main


def phase_adc_searches(torch, ds, before):
    """The compressed path's kernel-4 consumers on the main set, built as
    ``config()`` builds them: BruteForce(PQ m=16) searched at n_cand 1000
    and BruteForce(int8) at n_cand 200, 10^4 queries from the host.  Each
    search's recall (the runner's measure) and, with ``before``, the same
    search with the parent's kernel 4 in the new one's place: ids bit for
    bit, recall equal, and the search timed in turns (host clock,
    synchronized, best of 2: parent, new, new, parent).  Then two traces
    under ``torch.profiler``: the PQ search (kernel 4's share of the
    device time and the idle share of the call's window) and IVF-PQ's
    search (1024 lists, PQ m=16) at n_probes 10, n_cand 1000, whose
    window goes through the torch fold, kernel 2 and the host's gaps."""
    from repro_torch.ann import bruteforce, ivf
    from repro_torch.core.experiment import _distances_for
    from repro_torch.core.metrics import recall_from_arrays
    from repro_torch.kernels.adc_scan import ops as adc_ops

    kept = adc_ops.adc_scan_kernel

    def with_kernel(kernel, fn):
        adc_ops.adc_scan_kernel = kernel
        try:
            return fn()
        finally:
            adc_ops.adc_scan_kernel = kept

    def host_ms(fn, reps=2):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    def recall_of(ids):
        ids = ids.cpu().numpy()
        dist = _distances_for(ds, ids, "cuda")
        return float(np.mean(recall_from_arrays(dist, ds.distances, K,
                                                neighbors=ids)))

    nq = int(ds.test.shape[0])
    out = {}
    for label, quantize, n_cand in [("BruteForce(PQ m=16)", PQ16, 1000),
                                    ("BruteForce(int8)", {"int8": {}}, 200)]:
        st = bruteforce.build(ds.train, metric="euclidean",
                              quantize=quantize, adc_kernel=True,
                              device="cuda")

        def search():
            return bruteforce.search(st, ds.test, k=K, n_cand=n_cand)

        ids = search()[1]
        rec = {"phase": "adc_searches", "search": label, "nq": nq,
               "n_cand": n_cand, "recall": recall_of(ids)}
        if before is not None:
            def parent(codes, luts, *, k):
                return before.adc_scan(codes, luts, k=k)

            old = with_kernel(parent, search)[1]
            check(bool(torch.equal(old, ids)),
                  f"{label}: ids differ from the parent kernel's")
            rec["recall_parent"] = recall_of(old)
            check(rec["recall_parent"] == rec["recall"],
                  f"{label}: recall moved from the parent's: {rec}")
            searches = {"before": [host_ms(lambda: with_kernel(parent,
                                                               search))],
                        "after": [host_ms(search)]}
            searches["after"].append(host_ms(search))
            searches["before"].append(host_ms(lambda: with_kernel(parent,
                                                                  search)))
            rec["search_ms"] = searches
            rec["search_qps"] = {key: nq / min(v) * 1e3
                                 for key, v in searches.items()}
        else:
            rec["search_ms"] = host_ms(search)
            rec["search_qps"] = nq / rec["search_ms"] * 1e3
        if quantize is PQ16:
            by_name, idle, window_ms = profile_call(torch, search)
            adc_ms = sum(t for name, t in by_name.items()
                         if "adc_scan_kernel" in name)
            rec["trace"] = {"window_ms": window_ms, "idle_share": idle,
                            "kernel4_ms": adc_ms,
                            "kernel4_share": adc_ms / window_ms,
                            "device_total_ms": sum(by_name.values()),
                            "device_ms": top_device_ms(by_name)}
        log(json.dumps(rec))
        out[label] = rec
        del st
        torch.cuda.empty_cache()
    st = ivf.build(ds.train, metric="euclidean", n_clusters=1024, n_iters=10,
                   seed=0, rerank_kernel=True, quantize=PQ16, device="cuda")

    def ivf_pq():
        return ivf.search(st, ds.test, k=K, n_probes=10, n_cand=1000)

    recall = recall_of(ivf_pq()[1])
    search_ms = host_ms(ivf_pq)
    by_name, idle, window_ms, launches = profile_call(torch, ivf_pq,
                                                      count=True)
    rec = {"phase": "adc_searches", "search": "IVF-PQ(1024 lists, PQ m=16)",
           "n_probes": 10, "n_cand": 1000, "nq": nq, "recall": recall,
           "search_ms": search_ms, "search_qps": nq / search_ms * 1e3,
           "trace": {"window_ms": window_ms, "idle_share": idle,
                     "device_launches": launches,
                     "device_total_ms": sum(by_name.values()),
                     "device_ms": top_device_ms(by_name)}}
    log(json.dumps(rec))
    out["IVF-PQ"] = rec
    del st
    torch.cuda.empty_cache()
    return out


def top_device_ms(by_name, top: int = 25) -> dict:
    """The ``top`` largest device times of a trace by name cut to 120
    characters, each the sum over the full names that share those
    characters (kernel instances of one template often do)."""
    cut = {}
    for name, ms in by_name.items():
        cut[name[:120]] = cut.get(name[:120], 0.0) + ms
    return dict(sorted(cut.items(), key=lambda x: -x[1])[:top])


def within(torch, got, want, rtol: float, atol: float):
    """(largest |got - want|, largest |got - want| - rtol * |want|): the
    second must not exceed ``atol``."""
    diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
    excess = diff - rtol * want.to(torch.float32).abs()
    return float(diff.max()), float(excess.max())


def bf16_ulps(torch, got, want) -> float:
    """Largest distance in units of the last place of ``want`` (bf16: a
    unit at |w| is 2**(floor(log2 |w|) - 7))."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    mag = torch.clamp_min(w.abs(), 2.0 ** -126)
    return float(((g - w).abs()
                  / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def phase_distance_matrix(torch, peaks, before):
    """Kernel 5 against its plain version at 1,024 queries x 10^6 rows x
    128 (SIFT-1M's width; a 4.1 GB output) in every mode, timed beside
    ``torch.mm(-Q, X.T)`` (ip mode's function in one library call, TF32
    off), with the card's SM clock and power draw under each (l2sq), and
    with ``before`` beside the parent's kernel 5 (l2sq, in turns); then
    the distances-out route of ``ops.stream_topk``: at k = 256 kernel 1
    and the route through kernel 5 must agree bit for bit, and at k = 257
    and 1,000 the route must agree with the plain version."""
    from repro_torch.kernels.distance import (distance_matrix_kernel,
                                              distance_matrix_plain)
    from repro_torch.kernels.distance.distance import norm_operand
    from repro_torch.kernels.distance_topk import (stream_topk,
                                                   stream_topk_kernel,
                                                   stream_topk_plain)
    from repro_torch.kernels.distance_topk.ops import distances_route

    flops_peak, bytes_peak = peaks
    gen = torch.Generator(device="cuda").manual_seed(4)
    nq, n, d = 1024, 1_000_000, 128
    X = torch.randn((n, d), generator=gen, device="cuda")
    Qa = torch.randn((nq, d), generator=gen, device="cuda")
    rtol, atol = 1e-5, 1e-4
    main = None
    for mode in ("l2sq", "ip", "cos"):
        Xm, Q = X, Qa
        if mode == "cos":
            Xm = X / X.norm(dim=1, keepdim=True)
            Q = Qa / Qa.norm(dim=1, keepdim=True)
        qsq, xsq = norm_operand(Q, mode), norm_operand(Xm, mode)
        got = distance_matrix_kernel(Q, Xm, qsq, xsq, mode=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = distance_matrix_plain(Q, Xm, qsq, xsq, mode=mode)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_err, excess = within(torch, got, want, rtol, atol)
        del got, want
        ms = cuda_ms(torch, lambda: distance_matrix_kernel(
            Q, Xm, qsq, xsq, mode=mode), reps=3)
        library_ms = cuda_ms(torch, lambda: torch.mm(-Q, Xm.T), reps=3)
        under = {}
        if mode == "l2sq" and before is not None:
            under["same_call"] = same_call(
                torch, lambda: before.distance_matrix(Q, Xm, qsq, xsq,
                                                      mode=mode),
                lambda: distance_matrix_kernel(Q, Xm, qsq, xsq, mode=mode),
                reps=3)
        if mode == "l2sq":
            under |= {"kernel_sm_mhz_w": clocks_under(
                torch, lambda: distance_matrix_kernel(Q, Xm, qsq, xsq,
                                                      mode=mode)),
                     "library_sm_mhz_w": clocks_under(
                         torch, lambda: torch.mm(-Q, Xm.T))}
        flops = 2.0 * nq * n * d
        nbytes = 4.0 * (nq * d + n * d + nq + n + nq * n)
        rec = {"kernel": "distance_matrix", "mode": mode, "nq": nq, "n": n,
               "d": d, "max_abs_err": max_err, "rtol": rtol, "atol": atol,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "torch.mm(-Q, X.T), TF32 off",
               "bound_ms": max(flops / flops_peak, nbytes / bytes_peak) * 1e3,
               "bound_by": "operations" if flops / flops_peak
               >= nbytes / bytes_peak else "bytes",
               "tflops": flops / ms / 1e9, **under}
        log(json.dumps(rec))
        check(excess <= atol, f"distance_matrix {mode}: error {max_err} "
              f"beyond rtol {rtol}, atol {atol}")
        if main is None:
            main = rec
        del Xm, Q, qsq, xsq
    for mode in ("l2sq", "ip", "cos"):
        Xm, Q = X, Qa
        if mode == "cos":
            Xm = X / X.norm(dim=1, keepdim=True)
            Q = Qa / Qa.norm(dim=1, keepdim=True)
        qsq, xsq = norm_operand(Q, mode), norm_operand(Xm, mode)
        a = stream_topk_kernel(Q, Xm, qsq, xsq, mode=mode, k=256)
        b = distances_route(Q, Xm, qsq, xsq, mode=mode, k=256)
        same = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
        log(json.dumps({"route": "stream_topk via distance_matrix",
                        "mode": mode, "k": 256, "nq": nq, "n": n,
                        "bitwise_equal_to_stream_topk": same}))
        check(same, f"k=256 {mode}: the route through distance_matrix does "
              f"not equal stream_topk bit for bit")
        del a, b, Xm, Q
    qsq, xsq = norm_operand(Qa, "l2sq"), norm_operand(X, "l2sq")
    for k in (257, 1000):
        got = stream_topk(Qa, X, k=k)
        want = stream_topk_plain(Qa, X, qsq, xsq, mode="l2sq", k=k + 1)
        max_err, outside, at_ties = compare(torch, got, want, k, 2e-3)
        route_ms = cuda_ms(torch, lambda: stream_topk(Qa, X, k=k), reps=2)
        log(json.dumps({"route": "stream_topk via distance_matrix",
                        "mode": "l2sq", "k": k, "nq": nq, "n": n,
                        "max_abs_err": max_err,
                        "id_mismatch_outside_near_ties": outside,
                        "id_mismatch_at_near_ties": at_ties,
                        "ms": route_ms}))
        check(max_err <= 2e-3 and outside == 0,
              f"stream_topk k={k}: the route disagrees with the plain "
              f"version ({max_err}, {outside} ids)")
        del got, want
    del X, Qa
    torch.cuda.empty_cache()
    return main


def phase_routes(torch, ivf_state, Q):
    """The other distances-out routes against their plain versions, with
    their times: ``hamming_topk`` at k = 1,000 (1,024 queries x 10^6 codes
    of 256 bits; bit for bit), ``rerank_topk`` at k = 1,000 on IVF's window
    for the first 2,048 queries (n_probes 5 under cap 10), ``adc_scan`` at
    C = 1,500 (1,024 queries, PQ m = 16 over 10^6 codes; bit for bit)."""
    from repro_torch.ann import ivf
    from repro_torch.kernels.adc_scan import adc_scan, adc_scan_plain
    from repro_torch.kernels.hamming import hamming_topk, hamming_topk_plain
    from repro_torch.kernels.rerank_topk import rerank_topk_plain
    from repro_torch.kernels.rerank_topk.ops import (distances_route,
                                                     kernel_operands)

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    n, w, nq = 1_000_000, 8, 1024
    X = torch.randint(-2**31, 2**31 - 1, (n, w), generator=gen,
                      device="cuda", dtype=torch.int32)
    Qh = X[torch.randint(0, n, (nq,), generator=gen, device="cuda")] ^ 1
    got = hamming_topk(Qh, X, k=1000)
    want = hamming_topk_plain(Qh, X, n, k=1001)
    compare(torch, got, want, 1000, 0.0, exact=True)
    ms = cuda_ms(torch, lambda: hamming_topk(Qh, X, k=1000), reps=2)
    out["hamming_topk"] = {"k": 1000, "nq": nq, "n": n, "words": w,
                           "bitwise_equal": True, "ms": ms}
    del X, Qh, got, want

    Qp, cand, valid = ivf.probe_window(ivf_state, Q[:2048], n_probes=5,
                                       max_probes=10)
    qsq = torch.sum(Qp * Qp, dim=1, keepdim=True)
    ops = kernel_operands(Qp, ivf_state["X"], qsq, ivf_state["xsq"], cand,
                          ~valid, ivf_state["ids"], "euclidean", 1000)
    got = distances_route(**ops)
    want = rerank_topk_plain(**dict(ops, k=1001))
    max_err, outside, at_ties = compare(torch, got, want, 1000, 2e-3)
    check(max_err <= 2e-3 and outside == 0,
          f"rerank_topk k=1000: the route disagrees with the plain version "
          f"({max_err}, {outside} ids)")
    ms = cuda_ms(torch, lambda: distances_route(**ops), reps=2)
    out["rerank_topk"] = {"k": 1000, "b": int(cand.shape[0]),
                          "C": int(cand.shape[1]), "max_abs_err": max_err,
                          "id_mismatch_at_near_ties": at_ties, "ms": ms}
    del Qp, cand, valid, ops, got, want

    codes = torch.randint(0, 256, (n, 16), generator=gen, device="cuda",
                          dtype=torch.uint8)
    luts = torch.rand((nq, 16, 256), generator=gen, device="cuda")
    got = adc_scan(codes, luts, k=1500, use_kernel=True)
    want = adc_scan_plain(codes, luts, k=1501)
    compare(torch, got, want, 1500, 0.0, exact=True)
    ms = cuda_ms(torch, lambda: adc_scan(codes, luts, k=1500,
                                         use_kernel=True), reps=2)
    out["adc_scan"] = {"C": 1500, "b": nq, "n": n, "m": 16,
                       "bitwise_equal": True, "ms": ms}
    del codes, luts, got, want
    log(json.dumps({"phase": "routes", "routes": out}))
    torch.cuda.empty_cache()
    return out


def embedbag_variants_ptxas() -> dict:
    """ptxas's report of each compiled variant of kernel 6, by (dtype, vec,
    cpl, U) as ``embedbag.VARIANTS`` names them."""
    import re

    from repro_torch import kernels

    out = {}
    for name, rep in ptxas_report(kernels.BUILD_INFO.get("embedding_bag",
                                                         "")).items():
        hit = re.search(r"embedding_bag_streamI(f|13__nv_bfloat16)"
                        r"Li(\d+)ELi(\d+)ELi(\d+)E", name)
        if hit:
            out[(0 if hit.group(1) == "f" else 1, int(hit.group(2)),
                 int(hit.group(3)), int(hit.group(4)))] = rep
    return out


def phase_embedding_bag(torch, peaks, before):
    """Kernel 6 against its plain version on the largest table of
    Criteo-1TB (``models/recsys.py`` CRITEO_1TB_VOCABS: 39,884,406 rows) at
    the six cases of ``sweep_embedbag_plan.CASES``: 524,288 uniform
    lookups with weights in [0, 1) into 65,536 bags (the recsys train
    batch; 8 lookups a bag on average, every thousandth bag empty), into
    one bag each, or 100 each; at embed_dim 128 in fp32 (20.4 GB) and
    bf16, and at DCN-v2's 16 and FM's 10 in fp32.  Each case: the plan and
    the variant's ptxas registers and spills (no variant may spill), bit
    for bit with the plain version, the output in the table's type, every
    empty bag zero though the output's memory held NaNs just before (the
    kernel writes it; no zero fill), and the time (a CUDA graph of
    launches that take ``SETS`` draws of the lookups in turn, so the rows
    are read cold) beside the bound by bytes (element size from the
    table's type) and ``torch.nn.functional.embedding_bag``.  With
    ``before``, the parent's kernel (one warp a run, on ``bag_runs``) must
    give the same bits and is timed in turns with the new one; at Criteo
    and one-hot also what the op runs around each kernel: ``bag_spans``
    and the kernel against ``bag_runs``, the zero fill and the parent's
    kernel."""
    import itertools

    from repro_torch.benchmarks.common import graph_ms
    from repro_torch.benchmarks.sweep_embedbag_plan import (CASES, N, SETS,
                                                            V, lookups)
    from repro_torch.kernels.embedbag import (bag_runs, bag_spans,
                                              embedding_bag_kernel,
                                              embedding_bag_plain)
    from repro_torch.kernels.embedbag.embedbag import VARIANTS, kernel_plan

    flops_peak, bytes_peak = peaks
    variants = embedbag_variants_ptxas()
    log(json.dumps({"phase": "embedbag_ptxas", "variants": {
        f"dtype={dt},vec={v},cpl={c},U={u}": rep
        for (dt, v, c, u), rep in sorted(variants.items())}}))
    check(set(variants) == set(VARIANTS) and all(
        rep.get("spill_bytes", 1) == 0 for rep in variants.values()),
        f"embedding_bag: ptxas reports spills or misses a variant: "
        f"{variants}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    tables = {}
    recs = []
    for name, D, dtype, B in CASES:
        key = (D, dtype)
        if key not in tables:
            tables.clear()
            torch.cuda.empty_cache()
            tables[key] = torch.randn((V, D), generator=gen,
                                      device="cuda").to(dtype)
        table = tables[key]
        bags, draws = lookups(name, B, V, gen, SETS)
        idx, w = draws[0]
        spans = bag_spans(bags, n_bags=B)
        p = kernel_plan(idx, table, B)
        poison = torch.full((B, D), float("nan"), dtype=table.dtype,
                            device="cuda")
        del poison                     # the output may reuse its memory
        got = embedding_bag_kernel(idx, w, table, spans, n_bags=B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = embedding_bag_plain(idx, w, table, spans, n_bags=B)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        exact = bool(torch.equal(got, want))
        empty = spans[0] == spans[1]
        n_empty = int(empty.sum())
        check(got.dtype == table.dtype and exact,
              f"embedding_bag {name}: not bit for bit with its plain "
              f"version (or not in the table's type)")
        check(bool((got[empty] == 0).all())
              and not bool(torch.isnan(got).any()),
              f"embedding_bag {name}: an empty bag is not zero")
        after = [lambda i=i, x=x: embedding_bag_kernel(i, x, table, spans,
                                                        n_bags=B)
                 for i, x in draws]
        pair = op_pair = None
        if before is None:
            ms = graph_ms(after)
        else:
            runs = bag_runs(bags, n_bags=B)
            old = before.embedding_bag(idx, w, table, runs, n_bags=B)
            check(bool(torch.equal(old, got)),
                  f"embedding_bag {name}: not bit for bit with the parent's "
                  f"kernel")
            pair = same_call(
                torch, [lambda i=i, x=x: before.embedding_bag(
                    i, x, table, runs, n_bags=B) for i, x in draws],
                after, reps=20, timer=graph_ms)
            pair["before_equals_after_bitwise"] = True
            ms = sum(pair["after"]) / 2
            if name in ("criteo", "one_hot"):
                # the op's work around the kernel, host syncs included
                old_ops = itertools.cycle(
                    [lambda i=i, x=x: before.embedding_bag(
                        i, x, table, bag_runs(bags, n_bags=B), n_bags=B)
                     for i, x in draws])
                new_ops = itertools.cycle(
                    [lambda i=i, x=x: embedding_bag_kernel(
                        i, x, table, bag_spans(bags, n_bags=B), n_bags=B)
                     for i, x in draws])
                op_pair = same_call(torch, lambda: next(old_ops)(),
                                    lambda: next(new_ops)(), reps=20)
                op_pair["bag_runs_ms"] = cuda_ms(
                    torch, lambda: bag_runs(bags, n_bags=B), reps=20)
                op_pair["bag_spans_ms"] = cuda_ms(
                    torch, lambda: bag_spans(bags, n_bags=B), reps=20)
            del old, runs
        offsets = torch.searchsorted(bags, torch.arange(
            B, device="cuda", dtype=torch.int32))
        lib_in = [(i.long(), x.to(table.dtype)) for i, x in draws]

        def library(i, x):
            return torch.nn.functional.embedding_bag(
                i, table, offsets, mode="sum", per_sample_weights=x)

        lib = library(*lib_in[0])
        library_err = float((lib.float() - want.float()).abs().max())
        library_ms = graph_ms([lambda i=i, x=x: library(i, x)
                               for i, x in lib_in])
        isz = table.element_size()
        nbytes = float(isz) * N * D + 8.0 * N + 8.0 * B + float(isz) * B * D
        ops = 2.0 * N * D
        bound_ms = max(ops / flops_peak, nbytes / bytes_peak) * 1e3
        rec = {"kernel": "embedding_bag", "case": name, "V": V, "D": D,
               "dtype": str(dtype), "bags": B, "lookups": N,
               "lookup_sets": SETS, "empty_bags": n_empty, "plan": p,
               "ptxas": variants[(p["dtype"], p["vec"], p["cpl"], p["U"])],
               "bitwise_equal": exact,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "torch.nn.functional.embedding_bag(mode='sum', "
                          "per_sample_weights in the table's type)",
               "library_max_abs_err": library_err, "bound_ms": bound_ms,
               "bound_by": "operations" if ops / flops_peak
               >= nbytes / bytes_peak else "bytes",
               "bound_share": bound_ms / ms,
               "gbytes_per_s": nbytes / ms / 1e6, "same_call": pair,
               "op_same_call": op_pair}
        log(json.dumps(rec))
        recs.append(rec)
        del idx, w, bags, draws, spans, got, want, lib, offsets, lib_in
        del after, empty
    tables.clear()
    torch.cuda.empty_cache()
    check(recs[0]["empty_bags"] > 0,
          "embedding_bag: the Criteo case has no empty bag")
    return recs[0]


def profile_call(torch, fn, count: bool = False):
    """One call of ``fn`` under ``torch.profiler``, after one call under
    it that is not read (the profiler's own first-launch cost): the device
    time of each kernel and copy it ran (ms, by name), the share of the
    call's window (from the call to the end of
    ``torch.cuda.synchronize()``) in which the device ran nothing, and the
    window (ms); with ``count``, also the number of device kernels and
    copies in the window.  Read from the profiler's raw events, which hold
    the device work of torch's own ops as well as that of the port's
    kernels.  Fails if the trace holds no device activity in the
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name in ("smoke_warm", "smoke_call"):
            with record_function(name):
                fn()
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == "smoke_call"
              and e.device_type() == DeviceType.CPU]
    check(len(window) == 1, "profiler: no window of the call in the trace")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    spans, by_name = [], {}
    for e in events:
        t0, t1 = e.start_ns(), e.end_ns()
        if e.device_type() != DeviceType.CUDA or e.name().startswith(
                "smoke_") or t1 <= w0 or t0 >= w1:
            continue
        by_name[e.name()] = by_name.get(e.name(), 0.0) + (t1 - t0) / 1e6
        spans.append((max(t0, w0), min(t1, w1)))
    check(bool(spans), "profiler: the trace holds no device activity")
    busy, reach = 0, w0
    for t0, t1 in sorted(spans):
        t0 = max(t0, reach)
        if t1 > t0:
            busy += t1 - t0
            reach = t1
    out = (by_name, 1.0 - busy / (w1 - w0), (w1 - w0) / 1e6)
    return out + (len(spans),) if count else out


def decode_case(torch, peaks, q, k, v, lengths, label):
    """One bf16 case of kernel 7 at bs = 512 and the partitions it picks:
    against its plain version at the same ``part_blocks`` (within one
    bf16 ulp), timed beside ``scaled_dot_product_attention`` on the same
    cache (each KV head's G query heads as its query rows, a length mask),
    and one call traced by the profiler for the device time of each pass
    and the idle share of the call's window."""
    from repro_torch.kernels.decode_attn import (decode_attention_kernel,
                                                 decode_attention_plain)
    from repro_torch.kernels.decode_attn.decode_attn import (
        heads_per_launch, kernel_partitions)

    flops_peak, bytes_peak = peaks
    B, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    bs = 512
    sdpa = torch.nn.functional.scaled_dot_product_attention
    part_blocks, P = kernel_partitions(q, k, bs)
    grid_blocks = B * KV * P * -(-G // heads_per_launch(G, dh, bs))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    got = decode_attention_kernel(q, k, v, lengths, bs=bs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = decode_attention_plain(q, k, v, lengths, bs=bs,
                                  part_blocks=part_blocks)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ulps = bf16_ulps(torch, got, want)
    max_err = float((got.float() - want.float()).abs().max())
    ms = cuda_ms(torch, lambda: decode_attention_kernel(
        q, k, v, lengths, bs=bs), reps=3)
    by_name, idle, window_ms = profile_call(
        torch, lambda: decode_attention_kernel(q, k, v, lengths, bs=bs))
    passes = {f"{name}_ms": sum(t for n, t in by_name.items()
                                if f"decode_attn_{name}<" in n)
              for name in ("part", "combine")}
    mask = (torch.arange(S, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qv, kv, vv = (q.view(B, KV, G, dh), k.permute(0, 2, 1, 3),
                  v.permute(0, 2, 1, 3))
    lib = sdpa(qv, kv, vv, attn_mask=mask).reshape(B, H, dh)
    library_err = float((lib.float() - want.float()).abs().max())
    library_ms = cuda_ms(torch, lambda: sdpa(qv, kv, vv, attn_mask=mask),
                         reps=3)
    rows = float(lengths.clamp(0, S).sum())
    nbytes = 2.0 * 2 * rows * KV * dh + 2.0 * 2 * B * H * dh + 4.0 * B
    ops = 4.0 * H * dh * rows
    rec = {"kernel": "decode_attention", "lengths": label, "B": B,
           "H": H, "KV": KV, "dh": dh, "S": S, "dtype": "bfloat16",
           "bs": bs, "P": P, "part_blocks": part_blocks,
           "grid_blocks": grid_blocks, "valid_rows": rows,
           "max_abs_err": max_err, "max_bf16_ulps": ulps, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "scaled_dot_product_attention on [B, KV, S, dh] "
                      "views, G query rows per KV head, length mask",
           "library_max_abs_err": library_err,
           "bound_ms": max(ops / flops_peak, nbytes / bytes_peak) * 1e3,
           "bound_by": "operations" if ops / flops_peak
           >= nbytes / bytes_peak else "bytes",
           "gbytes_per_s": nbytes / ms / 1e6, **passes,
           "profiled_device_ms": by_name, "profiled_window_ms": window_ms,
           "profiled_idle_share": idle}
    log(json.dumps(rec))
    check(ulps <= 1.0, f"decode_attention {label}: {ulps} bf16 ulps from "
          f"its plain version")
    check(grid_blocks >= 2 * n_sm, f"decode_attention {label}: "
          f"{grid_blocks} partition blocks, fewer than two per SM")
    check(passes["part_ms"] > 0 and passes["combine_ms"] > 0,
          f"decode_attention {label}: the trace lacks a pass: {by_name}")
    return rec


def phase_decode_attention(torch, peaks):
    """Kernel 7 in bf16 at phi-4-mini's decode_32k (``configs/
    phi4_mini_3_8b.py``: 24 heads over 8 KV heads, dh = 128;
    ``configs/shapes.py``: B = 128, S = 32,768; a 17.2 GB cache), lengths
    uniform in [1, S], then full; then at gemma3-27b's long_500k, one
    global layer (``configs/gemma3_27b.py``: 32 heads over 16 KV heads,
    dh = 128; B = 1, S = 524,288; a 4.29 GB cache), lengths full, then
    S // 3 + 1.  Each case by ``decode_case``.  Then fp32 at the kernel
    bench's shape, lengths 0 / 1 / 1000 / S, within rtol 1e-5."""
    from repro_torch.kernels.decode_attn import (decode_attention_kernel,
                                                 decode_attention_plain)
    from repro_torch.kernels.decode_attn.decode_attn import kernel_partitions

    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16
    main = None
    for B, H, KV, dh, S, cases in [
            (128, 24, 8, 128, 32_768, ("uniform", "full")),
            (1, 32, 16, 128, 524_288, ("full", "third"))]:
        q = torch.randn((B, H, dh), generator=gen, device="cuda", dtype=bf16)
        k = torch.randn((B, S, KV, dh), generator=gen, device="cuda",
                        dtype=bf16)
        v = torch.randn((B, S, KV, dh), generator=gen, device="cuda",
                        dtype=bf16)
        for label in cases:
            if label == "uniform":
                lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                        device="cuda", dtype=torch.int32)
            else:
                n = S if label == "full" else S // 3 + 1
                lengths = torch.full((B,), n, dtype=torch.int32,
                                     device="cuda")
            rec = decode_case(torch, peaks, q, k, v, lengths, label)
            if main is None:
                main = rec
        del q, k, v
        torch.cuda.empty_cache()
    Bq, H, KV, S, dh = 4, 8, 4, 2048, 64
    q = torch.randn((Bq, H, dh), generator=gen, device="cuda")
    k = torch.randn((Bq, S, KV, dh), generator=gen, device="cuda")
    v = torch.randn((Bq, S, KV, dh), generator=gen, device="cuda")
    lengths = torch.tensor([0, 1, 1000, S], dtype=torch.int32, device="cuda")
    part_blocks, P = kernel_partitions(q, k, 256)
    got = decode_attention_kernel(q, k, v, lengths, bs=256)
    want = decode_attention_plain(q, k, v, lengths, bs=256,
                                  part_blocks=part_blocks)
    max_err, excess = within(torch, got, want, 1e-5, 1e-5)
    log(json.dumps({"kernel": "decode_attention", "dtype": "float32",
                    "B": Bq, "H": H, "KV": KV, "S": S, "dh": dh, "bs": 256,
                    "P": P, "part_blocks": part_blocks,
                    "lengths": lengths.tolist(), "max_abs_err": max_err}))
    check(excess <= 1e-5, f"decode_attention fp32: error {max_err}")
    return main


def phase_bench(torch):
    """The bench path: ``repro_torch.benchmarks.run --scale default --only
    kernels,stream``, then ``bench_distance_topk`` at ``full``, with the
    launch counts set to 0 before and read after.  The benches hold every
    kernel they run against its plain version (or the oracle) at their own
    shapes and raise outside the tolerance; ``run`` then returns 1."""
    from repro_torch.benchmarks import bench_distance_topk
    from repro_torch.benchmarks import run as bench_run

    out = ROOT / "build" / "bench"
    art = out / "BENCH_kernels.json"
    if art.exists():
        art.unlink()
    t0 = time.perf_counter()
    reset_counters()
    rc = bench_run.main(["--scale", "default", "--only", "kernels,stream",
                         "--out", str(out)])
    check(rc == 0, "repro_torch.benchmarks.run failed (a row outside its "
          "parity tolerance raises there)")
    for row in bench_distance_topk.run("full", "cuda"):
        log(row.csv())
    launches = read_counters()
    # Each kernel row ran on the card and held its gate (bench_kernels
    # raises otherwise); check the artifact says so, row by row.
    rows = {r["name"]: r["derived"]
            for r in json.loads(art.read_text())["rows"]}
    for name in ("stream_topk", "distance_matrix", "hamming_topk",
                 "embedding_bag", "decode_attention"):
        derived = rows.get(f"kernel/{name}_cuda", "")
        check("bound_us=" in derived and "parity=" in derived,
              f"bench: no parity-checked card row for {name}: {rows}")
    check(rows["kernel/hamming_topk_cuda"].endswith("parity=bitwise:1")
          and rows["kernel/embedding_bag_cuda"].endswith("parity=bitwise:1"),
          f"bench: hamming_topk / embedding_bag not bit for bit: {rows}")
    log(json.dumps({"phase": "bench", "launches": launches,
                    "seconds": time.perf_counter() - t0}))
    on_path = ("stream_topk", "hamming_topk", "distance_matrix",
               "embedding_bag", "decode_attention")
    check(all(launches[k] > 0 for k in on_path),
          f"bench: a kernel of the path never launched: {launches}")
    return launches


def live_oracle(torch, X_live, gids, Q, k: int, chunk: int = 250):
    """Exact (squared L2 [nq, k], global ids [nq, k]) over the live rows:
    ``D.sq_l2_matrix`` (``torch.matmul``) and a stable sort on the card,
    no kernel.  ``live_items`` lists the rows in global-id order, so the
    stable order is the canonical (distance, id) order."""
    from repro_torch.ann import distances as D

    X = torch.as_tensor(X_live).to("cuda")
    xsq = torch.sum(X ** 2, dim=1)
    Qd = torch.as_tensor(np.ascontiguousarray(Q)).to("cuda")
    gmap = torch.as_tensor(gids.astype(np.int64)).to("cuda")
    dists, ids = [], []
    for s in range(0, Qd.shape[0], chunk):
        d = D.sq_l2_matrix(Qd[s:s + chunk], X, xsq)
        v, i = torch.sort(d, dim=1, stable=True)
        dists.append(v[:, :k].cpu())
        ids.append(gmap[i[:, :k]].cpu())
    return torch.cat(dists).numpy(), torch.cat(ids).numpy()


def sq_recall(d_sq, ids, gt, k: int = K) -> float:
    """The tuner's recall: each answer's own squared distance, rooted,
    against the exact k-th L2 distance ``gt`` (``recall_from_arrays``)."""
    from repro_torch.core.metrics import recall_from_arrays

    return float(np.mean(recall_from_arrays(
        np.sqrt(np.maximum(d_sq, 0.0)), gt, k, neighbors=ids)))


def timed_s(torch, fn):
    """(result, host seconds) of ``fn()``, the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_tune(torch, ds, state):
    """``tune.grid_search`` on the main set's IVF (1,024 lists,
    ``rerank_kernel``: kernel 2's list entry) over all 10^4 queries,
    n_probes 1-32 x scan {256, pad}, max QPS s.t. recall >= 0.9, best of 3
    timing passes.  Every sweep row must equal its combination's static
    search (ids bit for bit), recall must not fall as n_probes grows, and
    the chosen point must be feasible and the fastest feasible one.  Then
    ``launch.tune`` at its default dataset must choose a config."""
    from repro_torch import tune
    from repro_torch.ann import ivf
    from repro_torch.ann.functional import grid_combos, search_sweep
    from repro_torch.launch import tune as tune_cli

    t0 = time.perf_counter()
    grid = {"n_probes": (1, 2, 4, 8, 16, 32),
            "scan": (256, state.stat("pad"))}
    Q = torch.as_tensor(ds.test).to("cuda")
    reset_counters()
    result = tune.grid_search(state, Q, ds.distances, k=K, knob_grid=grid,
                              constraint=tune.Constraint.min_recall(0.9),
                              repetitions=3)
    launches = read_counters()
    _, sweep_ids = search_sweep(state, Q, k=K, knob_grid=grid)
    combos = grid_combos(grid)
    for row, combo in enumerate(combos):
        static = ivf.search(state, Q, k=K, **combo)[1]
        check(torch.equal(sweep_ids[row], static),
              f"tune: sweep row {combo} differs from the static search")
    pareto = {id(p) for p in result.pareto}
    table = [{"params": p.params, "recall": p.recall, "qps": p.qps,
              "ms_per_query": p.latency * 1e3, "pareto": id(p) in pareto,
              "chosen": p is result.best} for p in result.points]
    for row in table:
        log(json.dumps({"tune_point": row}))
    for scan in grid["scan"]:
        rec = [p.recall for p in result.points if p.params["scan"] == scan]
        check(all(a <= b for a, b in zip(rec, rec[1:])),
              f"tune: recall falls as n_probes grows at scan {scan}: {rec}")
    best = result.best
    check(best is not None and best.recall >= 0.9,
          f"tune: no feasible point chosen: {table}")
    check(all(best.qps >= p.qps for p in result.points if p.recall >= 0.9),
          f"tune: {best.params} is not the fastest feasible point")
    check(launches["rerank_lists"] > 0,
          f"tune: kernel 2's list entry never launched: {launches}")
    t_grid = time.perf_counter() - t0
    out = ROOT / "build" / "tune.json"
    cli = tune_cli.main(["--grid", "n_probes=1,2,4,8,16,32",
                         "scan=32,128,512", "--build", "n_clusters=64",
                         "--min-recall", "0.9", "--out-json", str(out)])
    payload = json.loads(out.read_text())
    check(cli.best is not None and payload["best"] is not None,
          f"launch.tune chose no config: {payload}")
    log(json.dumps({"phase": "tune", "chosen": best.params,
                    "recall": best.recall, "qps": best.qps,
                    "launches": launches, "grid_seconds": t_grid,
                    "cli_chosen": payload["best"],
                    "seconds": time.perf_counter() - t0}))
    return launches


def state_on_cpu(state):
    """A copy of a (mutable) IndexState with every tensor on the CPU."""
    from repro_torch.ann.functional import IndexState

    return IndexState(state.algo, state.metric, {
        k: state_on_cpu(v) if isinstance(v, IndexState)
        else v.cpu() if hasattr(v, "cpu") else v
        for k, v in state.arrays.items()}, state.static)


def phase_mutate(torch, ds, state):
    """Streaming mutation at full width on the main set.  MutableIVF
    (1,024 lists, ``rerank_kernel``) built from the first 10^6 - 16,384
    rows with a 16,384-slot delta; 8 times: insert 1,024 held-out rows,
    delete the batch inserted two iterations earlier, search all 10^4
    queries at n_probes 10; after the first insert, also delete every
    base row that is some query's true nearest neighbour, so the
    tombstones mask rows the queries would return.  Its recall against
    the exact oracle over the live rows must lie within 0.02 of the frozen
    IVF's (``state``) at n_probes 10; no answer may be a deleted or an
    unknown id; on 200 queries its ids must equal the same state's plain
    path on the CPU in at least 198 (each deleted row is its query's
    nearest, so a kernel that ignored ``row_live`` would differ in
    nearly all); kernel 2's list entry must launch; then ``compact()``.
    MutableBruteForce on the same base and churn: 1,000 queries equal the
    live-row oracle in ids before and after ``compact()``, and a state
    kept from before the last insert still gives its earlier answer."""
    from repro_torch import mutate
    from repro_torch.ann import ivf

    t_phase = time.perf_counter()
    cap, batch, iters, n_probes, n_cpu = 16_384, 1_024, 8, 10, 200
    n0 = ds.n - cap
    base, held = ds.train[:n0], ds.train[n0:]
    nearest = np.unique(ds.neighbors[:, 0])
    dead_main = nearest[nearest < n0].astype(np.int32)
    Q = torch.as_tensor(ds.test).to("cuda")
    fd, fi = ivf.search(state, Q, k=K, n_probes=n_probes)
    frozen = sq_recall(fd.cpu().numpy(), fi.cpu().numpy(), ds.distances)

    def churn(st, search, label, probe=None):
        """The churn loop; returns the last state and, with ``probe``,
        the state before the last insert with ``probe``'s answer on it."""
        inserted, times, kept = [], {"insert": [], "delete": [],
                                     "delete_main": [], "search": []}, None
        for it in range(iters):
            if it == iters - 1 and probe is not None:
                kept = (st, probe(st))
            (st, new_ids), dt = timed_s(torch, lambda: mutate.insert(
                st, held[it * batch:(it + 1) * batch]))
            times["insert"].append(dt)
            inserted.append(new_ids)
            if it == 0:
                st, dt = timed_s(torch, lambda: mutate.delete(st, dead_main))
                times["delete_main"].append(dt)
            if len(inserted) > 2:
                st, dt = timed_s(torch, lambda: mutate.delete(
                    st, inserted.pop(0)))
                times["delete"].append(dt)
            if search is not None:
                _, dt = timed_s(torch, lambda: search(st))
                times["search"].append(dt)
        ms = {k: [t * 1e3 for t in v] for k, v in times.items()}
        log(json.dumps({"phase": f"mutate_{label}_churn", "ms": ms,
                        "delta_fraction": mutate.delta_fraction(st),
                        "live": mutate.live_count(st),
                        "deleted_main": int(dead_main.size)}))
        return st, kept

    # MutableIVF
    reset_counters()
    mst, t_build = timed_s(torch, lambda: mutate.IVF_SPEC.build(
        base, metric="euclidean", n_clusters=1024, rerank_kernel=True,
        delta_capacity=cap, device="cuda"))

    def ivf_search(st):
        return mutate.IVF_SPEC.search(st, Q, k=K, n_probes=n_probes)

    mst, _ = churn(mst, ivf_search, "ivf")
    launches = read_counters()
    gids, X_live = mutate.live_items(mst)
    od = np.sqrt(np.maximum(live_oracle(torch, X_live, gids, ds.test,
                                        K)[0], 0.0))
    d, i = ivf_search(mst)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    churned = sq_recall(d, i, od)
    check(np.isin(i[i >= 0], gids).all() and not np.isin(i, dead_main).any(),
          "mutate: MutableIVF returned a deleted or unknown id")
    wd, wi = mutate.IVF_SPEC.search(state_on_cpu(mst), ds.test[:n_cpu], k=K,
                                    n_probes=n_probes)
    same = (wi.numpy() == i[:n_cpu]).all(axis=1)
    log(json.dumps({"phase": "mutate_ivf_vs_cpu", "queries": n_cpu,
                    "ids_equal": int(same.sum()),
                    "max_abs_dist_diff": float(np.abs(
                        wd.numpy() - d[:n_cpu])[same].max(initial=0.0))}))
    check(int(same.sum()) >= n_cpu - 2,
          f"mutate: MutableIVF on the card differs from its plain path on "
          f"the CPU in {n_cpu - int(same.sum())} of {n_cpu} queries")
    cst, t_compact = timed_s(torch, lambda: mutate.compact(mst))
    d, i = ivf_search(cst)
    compacted = sq_recall(d.cpu().numpy(), i.cpu().numpy(), od)
    log(json.dumps({"phase": "mutate_ivf", "build_s": t_build,
                    "frozen_recall": frozen, "churn_recall": churned,
                    "compact_s": t_compact, "compact_recall": compacted,
                    "launches": launches}))
    check(abs(churned - frozen) <= 0.02,
          f"mutate: MutableIVF recall {churned} is not within 0.02 of "
          f"frozen IVF's {frozen}")
    check(launches["rerank_lists"] > 0,
          f"mutate: kernel 2's list entry never launched: {launches}")
    del mst, cst
    torch.cuda.empty_cache()

    # MutableBruteForce: ids equal the live-row oracle
    Qb = ds.test[:1000]

    def bf_search(st, chunk=250):
        return torch.cat([mutate.BRUTEFORCE_SPEC.search(
            st, Qb[s:s + chunk], k=K)[1] for s in range(0, 1000, chunk)])

    bst, t_build_bf = timed_s(torch, lambda: mutate.BRUTEFORCE_SPEC.build(
        base, metric="euclidean", delta_capacity=cap, device="cuda"))
    bst, (kept, kept_ids) = churn(bst, None, "bruteforce", probe=bf_search)
    gids, X_live = mutate.live_items(bst)
    _, want = live_oracle(torch, X_live, gids, Qb, K)
    got = bf_search(bst).cpu().numpy()
    check(np.array_equal(got, want),
          f"mutate: MutableBruteForce differs from the live-row oracle in "
          f"{int((got != want).any(axis=1).sum())} of 1000 queries")
    cbst, t_compact_bf = timed_s(torch, lambda: mutate.compact(bst))
    got = bf_search(cbst).cpu().numpy()
    check(np.array_equal(got, want),
          "mutate: MutableBruteForce after compact() differs from the "
          "live-row oracle")
    check(torch.equal(bf_search(kept), kept_ids),
          "mutate: a state kept from before the last insert changed its "
          "answer")
    log(json.dumps({"phase": "mutate_bruteforce", "build_s": t_build_bf,
                    "compact_s": t_compact_bf, "oracle_equal": 1000,
                    "seconds": time.perf_counter() - t_phase}))
    return launches


def phase_serve(torch, ds, state):
    """The synchronous Engine at full width on the main set, launch
    counts set to 0 before and read after (kernels 1 and 2's list entry
    must launch):
      * micro-batches of 256: an Engine over the IVF state (n_probes 10
        under max_probes 32, traced) and one over BruteForce(pallas)
        answer the 10^4 queries as the direct search does, ids and
        distances bit for bit; ms per micro-batch and QPS beside the
        direct search's; one IVF micro-batch of 256 under
        ``torch.profiler`` (its device time and the idle share of its
        window);
      * requests: 1,000 single queries through ``submit()`` equal
        ``search()``'s rows; 100 at a per-request n_probes 4 equal the
        static search at 4; n_probes 33 is refused at ``submit()``; an
        already expired request gets DeadlineExceeded and the rest of its
        micro-batch is answered;
      * checkpoint: ``save()`` and ``Engine.load()`` of the IVF engine
        answer bit for bit (seconds and bytes logged); a save cut by an
        injected truncation raises CheckpointError on load;
      * MutableIVF (the same rows, 1,024 lists, the list entry) under an
        Engine: one insert of 1,024 rows, every query's nearest base row
        deleted; recall against the live-row oracle within 0.02 of the
        frozen IVF engine's and no deleted or unknown id, before and after
        ``compact(background=True)`` runs beside 10 ``search()`` calls; a
        background compaction under an injected CompactionError leaves
        the answers as they were and counts one failure."""
    from repro_torch import mutate
    from repro_torch.ann import bruteforce, ivf
    from repro_torch.serve import (CheckpointError, CompactionError,
                                   DeadlineExceeded, Engine, FaultPlan,
                                   faults)

    t_phase = time.perf_counter()
    reset_counters()
    Q = torch.as_tensor(ds.test).to("cuda")
    qp = {"n_probes": 10, "max_probes": 32}

    def vs_direct(label, eng, direct):
        """Engine.search of the host's queries, as a caller sends them,
        against the direct search of the queries on the card: bitwise,
        timed."""
        eng.search(ds.test[:256])
        direct()
        before = dict(eng.stats)
        (d, i), t_eng = timed_s(torch, lambda: eng.search(ds.test))
        (wd, wi), t_direct = timed_s(torch, direct)
        wd, wi = wd.cpu().numpy(), wi.cpu().numpy()
        differ = int(((i != wi) | (d != wd)).any(axis=1).sum())
        batches = eng.stats["batches"] - before["batches"]
        searched = eng.stats["device_time_s"] - before["device_time_s"]
        rec = {"engine_s": t_eng, "direct_s": t_direct,
               "ms_per_micro_batch": t_eng * 1e3 / batches,
               "synced_search_ms_per_micro_batch": searched * 1e3 / batches,
               "engine_qps": Q.shape[0] / t_eng,
               "direct_qps": Q.shape[0] / t_direct,
               "queries_differing": differ, "stats": eng.stats}
        log(json.dumps({"phase": f"serve_{label}", **rec}))
        check(differ == 0, f"serve: {label} Engine.search differs from the "
                           f"direct search in {differ} queries")
        return d, i

    # 1. micro-batched search, IVF and BruteForce(pallas)
    eng = Engine(state, batch_size=256, query_params=qp)
    check(eng.traced_params == ("n_probes",),
          f"serve: n_probes not traced under max_probes: {eng.traced_params}")
    d_ivf, i_ivf = vs_direct("ivf", eng, lambda: ivf.search(
        state, Q, k=K, **qp))
    frozen = sq_recall(d_ivf, i_ivf, ds.distances)
    by_name, idle, window_ms, n_device = profile_call(
        torch, lambda: eng.search(ds.test[:256]), count=True)
    log(json.dumps({"phase": "serve_ivf_trace", "window_ms": window_ms,
                    "idle_share": idle,
                    "device_ms": sum(by_name.values()),
                    "device_kernels_and_copies": n_device,
                    "by_name_ms": by_name}))
    bstate = bruteforce.build(ds.train, backend="pallas", device="cuda")
    vs_direct("bruteforce", Engine(bstate, batch_size=256),
              lambda: bruteforce.search(bstate, Q, k=K))
    del bstate

    # 2. requests
    t0 = time.perf_counter()
    tickets = [eng.submit(ds.test[j]) for j in range(1000)]
    eng.flush()
    t_submit = time.perf_counter() - t0
    got = np.stack([t.result()[1] for t in tickets])
    got_d = np.stack([t.result()[0] for t in tickets])
    check(np.array_equal(got, i_ivf[:1000])
          and np.array_equal(got_d, d_ivf[:1000]),
          "serve: submit()'s answers differ from search()'s rows")
    four = [eng.submit(ds.test[j], n_probes=4) for j in range(100)]
    wd, wi = ivf.search(state, Q[:100], k=K, n_probes=4)
    check(np.array_equal(np.stack([t.result()[1] for t in four]),
                         wi.cpu().numpy())
          and np.array_equal(np.stack([t.result()[0] for t in four]),
                             wd.cpu().numpy()),
          "serve: a per-request n_probes 4 differs from the static search "
          "at 4")
    check(not np.array_equal(wi.cpu().numpy(), i_ivf[:100]),
          "serve: n_probes 4 answered as n_probes 10 does")
    try:
        eng.submit(ds.test[0], n_probes=33)
        check(False, "serve: n_probes 33 above max_probes 32 was accepted")
    except ValueError:
        pass
    ok1, late, ok2 = (eng.submit(ds.test[0]),
                      eng.submit(ds.test[1], deadline_ms=-1.0),
                      eng.submit(ds.test[2]))
    eng.flush()
    try:
        late.result()
        check(False, "serve: an expired request was answered")
    except DeadlineExceeded:
        pass
    check(np.array_equal(ok1.result()[1], i_ivf[0])
          and np.array_equal(ok2.result()[1], i_ivf[2]),
          "serve: an expired request's micro-batch was not answered")
    log(json.dumps({"phase": "serve_requests", "submitted": 1000,
                    "submit_flush_s": t_submit, "override_n_probes": 4,
                    "stats": eng.stats}))

    # 3. checkpoint at full size
    out = ROOT / "build" / "serve"
    path, cut = out / "ivf.ckpt", out / "cut.ckpt"
    _, t_save = timed_s(torch, lambda: eng.save(path))
    loaded, t_load = timed_s(torch, lambda: Engine.load(path, device="cuda"))
    d, i = loaded.search(ds.test)
    check(np.array_equal(i, i_ivf) and np.array_equal(d, d_ivf),
          "serve: the engine loaded from its checkpoint answers otherwise")
    with faults.injected(FaultPlan(ckpt_truncate_at=(0,))):
        eng.save(cut)
    try:
        Engine.load(cut, device="cuda")
        check(False, "serve: a truncated checkpoint loaded")
    except CheckpointError:
        pass
    log(json.dumps({"phase": "serve_checkpoint", "save_s": t_save,
                    "load_s": t_load, "bytes": path.stat().st_size,
                    "truncated_bytes": cut.stat().st_size}))
    path.unlink()
    cut.unlink()
    del eng, loaded

    # 4. live mutation under the engine
    meng, t_build = timed_s(torch, lambda: Engine.build(
        "MutableIVF", ds.train, metric="euclidean",
        build_params={"n_clusters": 1024, "rerank_kernel": True,
                      "delta_capacity": 4096},
        batch_size=256, query_params=qp, device="cuda"))
    rng = np.random.default_rng(0)
    src = rng.choice(ds.n, 1024, replace=False)
    new = ds.train[src] + rng.normal(0.0, 0.01, (1024, ds.train.shape[1]))
    meng.insert(new.astype(np.float32))
    dead = np.unique(ds.neighbors[:, 0]).astype(np.int32)
    meng.delete(dead)
    gids, X_live = mutate.live_items(meng.state)
    od = np.sqrt(np.maximum(live_oracle(torch, X_live, gids, ds.test,
                                        K)[0], 0.0))

    def held(label, d, i):
        rec = sq_recall(d, i, od)
        check(np.isin(i[i >= 0], gids).all() and not np.isin(i, dead).any(),
              f"serve: MutableIVF ({label}) returned a deleted or unknown "
              f"id")
        check(abs(rec - frozen) <= 0.02,
              f"serve: MutableIVF recall {rec} ({label}) is not within 0.02 "
              f"of the frozen engine's {frozen}")
        return rec

    d0, i0 = meng.search(ds.test)
    churn_recall = held("after the churn", d0, i0)
    before = meng.state
    with faults.injected(FaultPlan(compact_fault_at=(0,))):
        failed = meng.compact(background=True).join(timeout=600)
    d1, i1 = meng.search(ds.test)
    check(isinstance(failed.error, CompactionError)
          and meng.state is before
          and meng.stats["compaction_failures"] == 1
          and np.array_equal(i1, i0) and np.array_equal(d1, d0),
          f"serve: a failed background compaction changed serving: "
          f"{failed.error!r}, {meng.stats}")
    handle = meng.compact(background=True)
    during, served_before_swap = [], 0
    for _ in range(10):
        d, i = meng.search(ds.test)
        served_before_swap += not handle.done()
        during.append(held("during the compaction", d, i))
    t0 = time.perf_counter()
    handle.join(timeout=600)
    t_join = time.perf_counter() - t0
    check(handle.ok and meng.stats["compactions"] == 1
          and int(meng.state["count"]) == 0,
          f"serve: the background compaction failed: {handle.error!r}")
    d2, i2 = meng.search(ds.test)
    after = held("after the compaction", d2, i2)
    launches = read_counters()
    log(json.dumps({"phase": "serve_mutate", "build_s": t_build,
                    "frozen_recall": frozen, "churn_recall": churn_recall,
                    "recall_during": during, "compact_recall": after,
                    "searches_before_swap": served_before_swap,
                    "join_wait_s": t_join, "stats": meng.stats,
                    "launches": launches,
                    "seconds": time.perf_counter() - t_phase}))
    check(launches["stream_topk"] > 0 and launches["rerank_lists"] > 0,
          f"serve: kernel 1 or kernel 2's list entry never launched: "
          f"{launches}")
    del meng, before
    torch.cuda.empty_cache()
    return launches


def phase_benches(torch):
    """The sweep / tuner / compressed / serving benches at ``default``
    scale (n = 20,000) on the card, each with the launch counts set to 0
    before it and read after.  Every gate of each must hold (the modules
    assert them), and kernel 4 must launch in ``bench_pq``."""
    from repro_torch.benchmarks import (bench_engine, bench_pq, bench_sweep,
                                        bench_tune)
    from repro_torch.benchmarks.common import write_bench_json

    out = ROOT / "build" / "benches"
    total, per = {}, {}
    t0 = time.perf_counter()
    for name, mod in (("sweep", bench_sweep), ("tune", bench_tune),
                      ("pq", bench_pq), ("serve", bench_engine)):
        t_bench = time.perf_counter()
        reset_counters()
        extra = None
        if name == "pq":
            rows, extra = mod.run_with_summary("default", "cuda")
        else:
            rows = mod.run("default", "cuda")
        launches = read_counters()
        write_bench_json(name, rows, scale="default", extra=extra,
                         out_dir=str(out))
        for row in rows:
            log(row.csv())
        per[name] = {"launches": {k: v for k, v in launches.items() if v},
                     "seconds": time.perf_counter() - t_bench}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    log(json.dumps({"phase": "benches", "per_bench": per,
                    "seconds": time.perf_counter() - t0}))
    check(per["pq"]["launches"].get("adc_scan", 0) > 0,
          f"bench_pq: kernel 4 never launched: {per['pq']}")
    return total


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
    graph = {"constructor": "KNNGraph", "base-args": ["@metric"],
             "run-groups": {"g": {"args": [16], "query-args": [[16, 64]]}}}
    euclidean["graph"] = graph
    euclidean["hnsw"] = {"constructor": "HNSW", "base-args": ["@metric"],
                         "run-groups": {"g": {"args": [16, 80],
                                              "query-args": [[16, 64]]}}}
    angular = {
        "bruteforce": bruteforce, "ivf": ivf, "graph": graph,
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
    from repro_torch.kernels.adc_scan import adc_scan_kernel, adc_sums_kernel
    from repro_torch.kernels.decode_attn import decode_attention_kernel
    from repro_torch.kernels.distance import distance_matrix_kernel
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.embedbag import embedding_bag_kernel
    from repro_torch.kernels.hamming import (hamming_dist_kernel,
                                             hamming_topk_kernel)
    from repro_torch.kernels.rerank_topk import (rerank_dist_kernel,
                                                 rerank_lists_kernel,
                                                 rerank_topk_kernel)

    return {"stream_topk": stream_topk_kernel,
            "rerank_topk": rerank_topk_kernel,
            "rerank_lists": rerank_lists_kernel,
            "hamming_topk": hamming_topk_kernel, "adc_scan": adc_scan_kernel,
            "distance_matrix": distance_matrix_kernel,
            "embedding_bag": embedding_bag_kernel,
            "decode_attention": decode_attention_kernel,
            "hamming_dist": hamming_dist_kernel,
            "rerank_dist": rerank_dist_kernel, "adc_sums": adc_sums_kernel}


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


@contextlib.contextmanager
def kept_builds(names):
    """While open, each functional spec of ``names`` keeps the index it
    builds: a later build of the same points with the same parameters
    returns it (HNSW's host build takes minutes), and ``kept[(algo,
    metric)]`` holds the newest state of each for the smoke's own
    checks."""
    import dataclasses
    import hashlib

    from repro_torch.ann.functional import FUNCTIONAL

    cache, kept, saved = {}, {}, {name: FUNCTIONAL[name] for name in names}

    def keeping(name, build):
        def kept_build(X, **params):
            key = (name, hashlib.sha1(np.ascontiguousarray(X)).hexdigest(),
                   repr(sorted(params.items())))
            if key not in cache:
                cache[key] = build(X, **params)
            kept[name, params.get("metric")] = cache[key]
            return cache[key]
        return kept_build

    for name, spec in saved.items():
        FUNCTIONAL[name] = dataclasses.replace(
            spec, build=keeping(name, spec.build))
    try:
        yield kept
    finally:
        FUNCTIONAL.update(saved)


def graph_agreement(torch, label, mod, state, Q, efs=(16, 64),
                    n: int = 100):
    """The first ``n`` queries searched on the card and on a CPU copy of
    the same state (its tensors as numpy arrays, through
    ``state_from_reference``), at each ef of ``efs``: through the static
    path (ids and expansions) and through the grid sweep the runner times
    (``search_sweep_points``: ef a 0-d tensor under ``max_ef``, ids).  At
    least 99 of 100 queries must agree on each; each static query that
    differs is logged with its first differing id and distance.  The graph
    family has no kernel and so no plain version to hold one against: this
    check stands in."""
    from repro_torch.ann.functional import search_sweep_points
    from repro_torch.convert import state_from_reference

    arrays = {k: tuple(t.cpu().numpy() for t in v) if isinstance(v, tuple)
              else v.cpu().numpy() for k, v in state.arrays.items()}
    cpu = state_from_reference(state.algo, state.metric, arrays,
                               state.static, device="cpu")
    n = min(n, len(Q))
    q = np.asarray(Q[:n])
    points = [{"ef": ef} for ef in efs]
    gsi = search_sweep_points(state, q, k=K, points=points)[1].cpu()
    csi = search_sweep_points(cpu, q, k=K, points=points)[1]
    recs = []
    for s, ef in enumerate(efs):
        gd, gi, git = (t.cpu() for t in mod.search_with_stats(
            state, q, k=K, ef=ef))
        cd, ci, cit = mod.search_with_stats(cpu, q, k=K, ef=ef)
        same = (gi == ci).all(dim=1) & (git == cit)
        same_sweep = int((gsi[s] == csi[s]).all(dim=1).sum())
        differ = []
        for row in torch.nonzero(~same).flatten().tolist():
            cols = torch.nonzero(gi[row] != ci[row]).flatten().tolist()
            j = cols[0] if cols else None
            differ.append({
                "query": row, "expansions": [int(git[row]), int(cit[row])],
                "first_col": j,
                "ids": None if j is None else [int(gi[row, j]),
                                               int(ci[row, j])],
                "dists": None if j is None else [float(gd[row, j]),
                                                 float(cd[row, j])]})
        rec = {"phase": "graph_agreement", "what": label, "ef": ef, "n": n,
               "equal": int(same.sum()), "equal_sweep": same_sweep,
               "differ": differ,
               "max_abs_err_equal": float((gd - cd)[same].abs().max())
               if bool(same.any()) else None,
               "expansions_mean": float(git.float().mean()),
               "expansions_max": int(git.max())}
        log(json.dumps(rec))
        check(int(same.sum()) >= 0.99 * n,
              f"{label} ef {ef}: card and CPU differ on "
              f"{n - int(same.sum())} of {n} queries")
        check(same_sweep >= 0.99 * n,
              f"{label} ef {ef}: the sweep's ids differ on card and CPU on "
              f"{n - same_sweep} of {n} queries")
        check(bool((git > 0).all()), f"{label}: a query expanded nothing")
        recs.append(rec)
    return recs


def graph_profile(torch, label, mod, state, Q, ef: int):
    """One batched search under ``torch.profiler``: device launches,
    device ms by name, idle share of the window, and the iterations the
    longest lane took (each iteration is one step of every lane)."""
    out = {}

    def call():
        out["it"] = mod.search_with_stats(state, Q, k=K, ef=ef)[2]

    by_name, idle, window_ms, launches = profile_call(torch, call,
                                                      count=True)
    rec = {"phase": "graph_profile", "what": label, "ef": ef,
           "nq": int(Q.shape[0]), "window_ms": window_ms,
           "device_ms": sum(by_name.values()), "idle": idle,
           "launches": launches, "iterations": int(out["it"].max()),
           "top": top_device_ms(by_name, 12)}
    log(json.dumps(rec))
    return rec


def graph_single(torch, ds, algo: str):
    """``algo`` in single-query mode on every query of ``ds`` (the kept
    index: no second build)."""
    from repro_torch.core.config import get_definitions
    from repro_torch.core.experiment import ExperimentSettings, run_definition

    definition = get_definitions(config(), point_type=ds.point_type,
                                 metric=ds.metric, dimension=ds.dimension,
                                 count=K, algorithms=[algo])[0]
    t0 = time.perf_counter()
    single = run_definition(definition, ds, ExperimentSettings(
        count=K, batch_mode=False, device="cuda"))
    log(json.dumps({"phase": "graphs_single", "dataset": ds.name,
                    "seconds": time.perf_counter() - t0}))
    rows = check_records(single, ds.name, ds.n, {algo: 2})[algo]
    check(all(r["attrs"].get("dist_comps", 0) > 0 for r in rows),
          f"{algo} single mode counted no distance computations")
    return rows


def phase_graphs(torch):
    """The graph family (KNNGraph, HNSW; no TPU kernel: the beam search is
    torch ops) through ``run_benchmark`` in batch mode at ef [16, 64],
    then HNSW in single mode, each set's card-against-CPU agreement and
    one profiled batched search of each family at ef 64."""
    from repro_torch.ann import graph, hnsw
    from repro_torch.data import get_dataset

    t0 = time.perf_counter()
    out = {}
    with kept_builds(("KNNGraph", "HNSW")) as kept:
        ds = get_dataset(GRAPHS, device="cuda")
        check(ds.test.shape[0] == ds.n // 100,
              f"{GRAPHS} has shape {ds.train.shape} / {ds.test.shape}")
        _, out["sift"] = run_path(torch, "graphs_sift", GRAPHS,
                                  {"graph": 2, "hnsw": 2}, ds.n, ())
        t1 = time.perf_counter()
        out["hnsw_single"] = graph_single(torch, ds, "hnsw")
        t2 = time.perf_counter()
        for algo, mod in (("KNNGraph", graph), ("HNSW", hnsw)):
            out[f"agree_{algo}"] = graph_agreement(
                torch, f"{algo} {GRAPHS}", mod, kept[algo, "euclidean"],
                ds.test)
        Q = torch.as_tensor(ds.test, device="cuda")
        out["profile_hnsw"] = graph_profile(
            torch, f"HNSW {GRAPHS}", hnsw, kept["HNSW", "euclidean"], Q, 64)
        t3 = time.perf_counter()
        ads = get_dataset(ANGULAR, device="cuda")
        _, out["glove"] = run_path(torch, "graphs_glove", ANGULAR,
                                   {"graph": 2}, ads.n, ())
        t4 = time.perf_counter()
        state = kept["KNNGraph", "angular"]
        out["agree_KNNGraph_angular"] = graph_agreement(
            torch, f"KNNGraph {ANGULAR}", graph, state, ads.test)
        Q = torch.as_tensor(ads.test, device="cuda")
        out["profile_knngraph"] = graph_profile(
            torch, f"KNNGraph {ANGULAR}", graph, state, Q, 64)
    log(json.dumps({"phase": "graphs", "seconds": time.perf_counter() - t0,
                    "sift_batch_s": t1 - t0, "hnsw_single_s": t2 - t1,
                    "sift_checks_s": t3 - t2, "glove_batch_s": t4 - t3,
                    "glove_checks_s": time.perf_counter() - t4}))
    return out


def phase_figures(torch):
    """The figure path: ``repro_torch.benchmarks.run --scale smoke --only
    fig4,...,fig11``, launch counts set to 0 before and read after.  Every
    module must print its rows (``FIGURE_ROWS``), named under its key, and
    kernels 1 (fig11's BruteForce(pallas)) and 3 (fig9's
    BruteForceHamming(pallas)) must launch."""
    import io

    from repro_torch.benchmarks import run as bench_run

    out = ROOT / "build" / "figures"
    for key in FIGURE_ROWS:
        art = out / f"BENCH_{key}.json"
        if art.exists():
            art.unlink()
    t0 = time.perf_counter()
    reset_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_run.main(["--scale", "smoke", "--only", FIGURES,
                             "--out", str(out), "--device", "cuda"])
    launches = read_counters()
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(line)
    check(rc == 0, "repro_torch.benchmarks.run failed on the figures")
    rows = {}
    for key, n_rows in FIGURE_ROWS.items():
        names = [r["name"] for r in json.loads(
            (out / f"BENCH_{key}.json").read_text())["rows"]]
        check(len(names) == n_rows and all(
            name.startswith(f"{key}/") for name in names),
            f"{key}: rows {names}, not {n_rows} under {key}/")
        rows[key] = len(names)
    log(json.dumps({"phase": "figures", "rows": rows, "launches": launches,
                    "seconds": seconds}))
    check(launches["stream_topk"] > 0 and launches["hamming_topk"] > 0,
          f"figures: kernel 1 or 3 never launched: {launches}")
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
    args = sys.argv[1:]
    check(not args or (len(args) == 2 and args[0] == "--before"),
          f"usage: chip_smoke.py [--before DIR], not {args}")
    os.environ["REPRO_DATA_DIR"] = str(ROOT / "build" / "data")
    sys.path.insert(0, str(SRC))
    before = Before(args[1]) if args else None
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.benchmarks.common import PEAKS, form_factor

    card = torch.cuda.get_device_name(0)
    peaks = PEAKS[form_factor(card)]
    log(json.dumps({"phase": "device", "name": card,
                    "form_factor": form_factor(card),
                    "fp32_flops": peaks[0], "bytes_per_s": peaks[1],
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    # 1. device + build
    smi_line, clock_hz = phase_device(torch, before)

    # 2. kernels against their plain versions
    k1 = phase_stream_topk(torch, peaks, before)
    k3 = phase_hamming_topk(torch, peaks, clock_hz)
    k4 = phase_adc_scan(torch, peaks, clock_hz, before)
    k5 = phase_distance_matrix(torch, peaks, before)
    k6 = phase_embedding_bag(torch, peaks, before)
    k7 = phase_decode_attention(torch, peaks)
    from repro_torch.ann import ivf
    from repro_torch.data import get_dataset

    ds = get_dataset(MAIN, device="cuda")
    check(ds.train.shape == (1_000_000, 128) and ds.test.shape[0] == 10_000,
          f"{MAIN} has shape {ds.train.shape} / {ds.test.shape}")
    phase_bruteforce_trace(torch, ds, before)
    state = ivf.build(ds.train, metric="euclidean", n_clusters=1024,
                      rerank_kernel=True, device="cuda")
    k2, k2_lists = phase_rerank_topk(torch, peaks, state, ds.test, before)
    phase_rerank_consumers(torch, peaks, ds, before)
    phase_adc_searches(torch, ds, before)
    phase_ivf_trace(torch, ds, state, before)
    phase_ivf_compare(torch, MAIN, ds, state, before)
    phase_breakdown(torch, state, ds.test)
    routes = phase_routes(torch, state, ds.test)
    tune_launches = phase_tune(torch, ds, state)
    mutate_launches = phase_mutate(torch, ds, state)
    serve_launches = phase_serve(torch, ds, state)
    del state
    torch.cuda.empty_cache()
    if before is not None:
        ads = get_dataset(ANGULAR, device="cuda")
        astate = ivf.build(ads.train, metric="angular", n_clusters=1024,
                           rerank_kernel=True, device="cuda")
        phase_ivf_compare(torch, ANGULAR, ads, astate, before)
        del ads, astate
        torch.cuda.empty_cache()

    # 3. the paths, through the runner; ``paths`` sums each kernel's
    # launches over them (single-query runs apart)
    paths = {}
    for launches in (tune_launches, mutate_launches, serve_launches):
        for kernel, count in launches.items():
            paths[kernel] = paths.get(kernel, 0) + count

    def path(*args):
        launches, rows = run_path(torch, *args)
        for name, count in launches.items():
            paths[name] = paths.get(name, 0) + count
        return rows

    path("main_path", MAIN, {"bruteforce": 1, "ivf": 3}, ds.n,
         ("stream_topk", "rerank_lists"))
    run_single(torch, "single_query", ds, "bruteforce", "stream_topk")
    torch.cuda.empty_cache()

    path("compressed", MAIN, {"bf_pq": 3, "bf_int8": 1, "ivf_pq": 2}, ds.n,
         ("adc_scan", "rerank_topk"))
    path("lsh_euclidean", MAIN, {"e2lsh": 3}, ds.n, ("rerank_topk",))
    del ds
    torch.cuda.empty_cache()
    planted = path("compressed_planted", PLANTED, {"bf_pq": 3}, 1_000_000,
                   ("adc_scan",))
    deepest = planted["bf_pq"][-1]["recall"]
    check(deepest >= 1.0 - PQ_EPS,
          f"{PLANTED}: PQ recall {deepest} at n_cand 1000 is below "
          f"1 - {PQ_EPS}")
    torch.cuda.empty_cache()

    hds = get_dataset(HAMMING, device="cuda")
    check(hds.train.shape == (1_000_000, 8) and hds.test.shape[0] == 10_000,
          f"{HAMMING} has shape {hds.train.shape} / {hds.test.shape}")
    path("hamming", HAMMING, {"bfh": 1, "annoy": 3, "mih": 2}, hds.n,
         ("hamming_topk", "rerank_topk"))
    run_single(torch, "hamming_single_query", hds, "bfh", "hamming_topk")
    del hds
    torch.cuda.empty_cache()

    path("angular", ANGULAR,
         {"bruteforce": 1, "ivf": 3, "hyperplane": 3, "rpforest": 3},
         200_000, ("stream_topk", "rerank_topk", "rerank_lists"))
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "ann_paths", "launches": paths}))
    phase_graphs(torch)
    torch.cuda.empty_cache()

    # 4. the bench path, then the figure path
    bench_launches = phase_bench(torch)
    phase_figures(torch)
    for kernel, count in phase_benches(torch).items():
        paths[kernel] = paths.get(kernel, 0) + count

    no_library = ("no single PyTorch call computes a fused distance + "
                  "(unique) top-k")
    kernels = [
        {"name": "stream_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/stream_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/distance_topk.py:122",
         "launches": paths["stream_topk"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "library_note": no_library},
        {"name": "rerank_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rerank_topk.cu",
         "replaces": "src/repro/kernels/rerank_topk/rerank_topk.py:153",
         "launches": paths["rerank_topk"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "library_note": no_library},
        {"name": "rerank_lists", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rerank_topk.cu",
         "replaces": "src/repro/kernels/rerank_topk/rerank_topk.py:153",
         "launches": paths["rerank_lists"],
         "max_abs_err": k2_lists["max_abs_err"], "ms": k2_lists["ms"],
         "plain_ms": k2_lists["plain_ms"], "bound_ms": k2_lists["bound_ms"],
         "bound_by": k2_lists["bound_by"], "library_ms": None,
         "library_note": no_library},
        {"name": "hamming_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming_topk.cu",
         "replaces": "src/repro/kernels/hamming/hamming.py:55",
         "launches": paths["hamming_topk"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "library_note": "no PyTorch call computes a popcount distance; "
                         "no single call fuses it with a top-k"},
        {"name": "adc_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/adc_scan.cu",
         "replaces": "src/repro/kernels/adc_scan/adc_scan.py:96",
         "launches": paths["adc_scan"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "library_note": "no single PyTorch call computes a table-lookup "
                         "sum with a top-k"},
        {"name": "distance_matrix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_matrix.cu",
         "replaces": "src/repro/kernels/distance/distance.py:75",
         "launches": bench_launches["distance_matrix"],
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
         "library_note": k5["library"]},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedbag/embedbag.py:49",
         "launches": bench_launches["embedding_bag"],
         "max_abs_err": k6["max_abs_err"], "ms": k6["ms"],
         "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": k6["library_ms"],
         "library_note": k6["library"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn/decode_attn.py:69",
         "launches": bench_launches["decode_attention"],
         "max_abs_err": k7["max_abs_err"], "ms": k7["ms"],
         "plain_ms": k7["plain_ms"], "bound_ms": k7["bound_ms"],
         "bound_by": k7["bound_by"], "library_ms": k7["library_ms"],
         "library_note": k7["library"]},
    ]
    log(json.dumps({"distances_out_routes": routes}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
