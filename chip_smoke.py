#!/usr/bin/env python3
"""Smoke run of the PyTorch/Hopper port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

 1. device: the card's name and power limit (``nvidia-smi``) and the build
    of every kernel under ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
 2. each kernel against its plain PyTorch version at the main path's
    shapes, in every mode, with times, bounds and errors;
 3. the main path through ``repro_torch.core.runner.run_benchmark``:
    ``blobs-euclidean-1000000-d128`` (SIFT-1M's shape: n = 10^6, d = 128,
    10^4 queries, k = 10) in batch mode with BruteForce(pallas) and
    IVF(1024 lists, rerank_kernel) over n_probes [1, 5, 10]; BruteForce in
    single-query mode on the first 1,000 queries; the same two definitions
    on ``blobs-angular-200000-d100`` (GloVe-100's width, n cut from
    1,183,514).  Recall is the repo's own distance-based measure against
    exact ground truth (``torch.matmul`` + stable top-k, no kernel).

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path and its numbers.
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
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    for name, text in kernels.BUILD_INFO.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(json.dumps({"phase": "build", "seconds": round(build_s, 3)}))
    return smi_line


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


def config():
    """BruteForce on the streaming kernel and IVF on the rerank kernel, the
    same definitions for both metrics."""
    algos = {
        "bruteforce": {"constructor": "BruteForce", "base-args": ["@metric"],
                       "run-groups": {"kernel": {"args": ["pallas"]}}},
        "ivf": {"constructor": "IVF", "base-args": ["@metric"],
                "run-groups": {"kernel": {
                    "args": [1024, 10, 0, False, None, True],
                    "query-args": [[1, 5, 10]]}}},
    }
    return {"float": {"euclidean": algos, "angular": algos}}


def reset_counters():
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.rerank_topk import rerank_topk_kernel

    stream_topk_kernel.launches = 0
    rerank_topk_kernel.launches = 0


def read_counters():
    from repro_torch.kernels.distance_topk import stream_topk_kernel
    from repro_torch.kernels.rerank_topk import rerank_topk_kernel

    return {"stream_topk": stream_topk_kernel.launches,
            "rerank_topk": rerank_topk_kernel.launches}


def check_records(records, dataset: str, n: int, batch: bool):
    """Every definition produced its records, ids are corpus rows or -1
    (IVF pads with -1 when the probed lists hold fewer than k points;
    BruteForce never does), BruteForce is exact, IVF's recall does not fall
    as n_probes grows."""
    from repro_torch.core.metrics import recall

    bf = [r for r in records if r.algorithm == "bruteforce"]
    iv = sorted((r for r in records if r.algorithm == "ivf"),
                key=lambda r: r.query_arguments)
    check(len(bf) == 1, f"{dataset}: BruteForce gave {len(bf)} records")
    check(len(iv) == (3 if batch else 0),
          f"{dataset}: IVF gave {len(iv)} records")
    out = []
    for r in bf + iv:
        found = r.neighbors >= 0
        check(r.neighbors.shape == (r.nq, K)
              and bool((r.neighbors >= -1).all())
              and bool((r.neighbors < n).all())
              and (r.algorithm != "bruteforce" or bool(found.all())),
              f"{dataset}: {r.instance_name} returned malformed neighbors")
        check(bool(np.isfinite(r.distances[found]).all()),
              f"{dataset}: {r.instance_name} has non-finite distances")
        rec = {"dataset": dataset, "algorithm": r.algorithm,
               "instance": r.instance_name,
               "query_args": list(r.query_arguments),
               "mode": "batch" if r.batch_mode else "single", "nq": r.nq,
               "empty_slots": int((~found).sum()),
               "recall": recall(r), "qps": r.qps,
               "build_s": r.build_time, "index_kb": r.index_size_kb,
               "attrs": {k: v for k, v in r.attrs.items()
                         if isinstance(v, (int, float, bool))}}
        log(json.dumps(rec))
        out.append(rec)
    check(out[0]["recall"] == 1.0,
          f"{dataset}: BruteForce recall {out[0]['recall']} != 1.0")
    rec_ivf = [o["recall"] for o in out[1:]]
    check(all(a <= b for a, b in zip(rec_ivf, rec_ivf[1:])),
          f"{dataset}: IVF recall falls as n_probes grows: {rec_ivf}")
    check(all(0.0 < x <= 1.0 for x in rec_ivf),
          f"{dataset}: IVF recall out of range: {rec_ivf}")
    return out


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
    smi_line = phase_device(torch)

    # 2. kernels against their plain versions
    k1 = phase_stream_topk(torch, peaks)
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

    # 3. the main path, through the runner
    from repro_torch.core.config import get_definitions
    from repro_torch.core.experiment import ExperimentSettings, run_definition
    from repro_torch.core.runner import run_benchmark
    from repro_torch.data.datasets import Dataset

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    records = run_benchmark(MAIN, config(), count=K, batch=True,
                            device="cuda")
    launches = read_counters()
    log(json.dumps({"phase": "main_path", "dataset": MAIN,
                    "launches": launches,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    check_records(records, MAIN, ds.n, batch=True)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    reset_counters()
    first = Dataset(name=ds.name, train=ds.train, test=ds.test[:1000],
                    neighbors=ds.neighbors[:1000],
                    distances=ds.distances[:1000], metric=ds.metric)
    bf_def = get_definitions(config(), metric="euclidean", dimension=128,
                             count=K, algorithms=["bruteforce"])[0]
    single = run_definition(bf_def, first, ExperimentSettings(
        count=K, batch_mode=False, device="cuda"))
    single_launches = read_counters()
    log(json.dumps({"phase": "single_query", "launches": single_launches}))
    check_records(single, MAIN, ds.n, batch=False)
    check(single_launches["stream_topk"] == 1000,
          f"single mode launched stream_topk "
          f"{single_launches['stream_topk']} times for 1000 queries")
    del ds, first
    torch.cuda.empty_cache()

    reset_counters()
    records = run_benchmark(ANGULAR, config(), count=K, batch=True,
                            device="cuda")
    ang_launches = read_counters()
    log(json.dumps({"phase": "angular", "dataset": ANGULAR,
                    "launches": ang_launches}))
    check_records(records, ANGULAR, 200_000, batch=True)
    check(all(v > 0 for v in ang_launches.values()),
          f"a kernel of the angular path never launched: {ang_launches}")

    no_library = ("no single PyTorch call computes a fused distance + "
                  "(unique) top-k")
    kernels = [
        {"name": "stream_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/stream_topk.cu",
         "replaces": "src/repro/kernels/distance_topk/distance_topk.py:122",
         "launches": launches["stream_topk"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "library_note": no_library},
        {"name": "rerank_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rerank_topk.cu",
         "replaces": "src/repro/kernels/rerank_topk/rerank_topk.py:153",
         "launches": launches["rerank_topk"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "library_note": no_library},
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
