"""Compressed-domain search benchmark (``benchmarks/bench_pq.py`` of the
reference).

The memory story of the paper's large-scale regime: a d=128 fp32 corpus
costs 512 bytes/vector; PQ at m=16 sub-codebooks stores 16 code bytes
(32x) and int8 affine stores 128 (4x), with the two-stage ADC scan +
exact fp32 rerank buying the recall back.  Per codec, the swept
``n_cand`` rerank depth traces the recall/QPS curve in one
``search_sweep``, and the equal-recall operating point -- the smallest
depth whose recall@10 matches the exact fp32 scan within 0.01 -- is
reported alongside its QPS.

Gates:

  * **compression** -- PQ (m=16, 8-bit) stores >= 4x fewer scan-stage
    corpus bytes per vector than fp32 (it achieves 32x at d=128);
  * **equal recall** -- some swept ``n_cand`` reaches the exact scan's
    recall@10 within 0.01;
  * **kernel parity** -- the ADC kernel (``kernels/csrc/adc_scan.cu`` on
    the card, its plain version on the CPU) returns bit-identical ids to
    the torch gather-fold through the full search path.

The reference's equal-recall gate also asserts that the sweep took exactly
one jit trace (``functional.TRACE_COUNTS``) and prints ``sweep_traces``;
the port has no jit and no counter, so that assertion and those fields are
dropped.  The kernel row reports the device it ran on where the
reference's says ``interpret=True``.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_pq \
        [--smoke | --scale default] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import resolve_device, sync
from repro_torch.ann.functional import (get_functional, queries_on,
                                        search_sweep)
from repro_torch.benchmarks.common import Row, best_s, write_bench_json
from repro_torch.data import get_dataset
from repro_torch.quant import bytes_per_vector

K = 10
MIN_RATIO = 4.0           # compression gate: corpus bytes/vector vs fp32
RECALL_TOL = 0.01         # equal-recall gate: within this of the exact scan
KERNEL_NQ = 8             # kernel parity on the reference's small batch
N_CAND_GRID = (25, 50, 100, 200, 400, 800)

CODEC_CASES = {
    "pq_m16_b8": {"pq": {"m": 16, "bits": 8}},
    "int8": "int8",
}

SCALE_N = {"smoke": 2000, "default": 20000, "full": 100000}
SCALE_NQ = {"smoke": 64, "default": 256, "full": 256}


def _recall(ids: np.ndarray, gt: np.ndarray) -> float:
    """Mean fraction of the exact top-K recovered, per query."""
    return float(np.mean([np.isin(row, g).mean()
                          for row, g in zip(ids, gt)]))


def run(scale: str = "default", device=None):
    """Harness contract: ``run(scale, device) -> list[Row]``."""
    rows, _ = run_with_summary(scale, device)
    return rows


def run_with_summary(scale: str = "default", device=None):
    dev = resolve_device(device)
    n = SCALE_N[scale]
    nq = SCALE_NQ[scale]
    ds = get_dataset(f"blobs-euclidean-{n}-d128", device=dev)
    spec = get_functional("BruteForce")
    Q = ds.test
    while Q.shape[0] < nq:
        Q = np.concatenate([Q, Q])
    Q = queries_on(Q[:nq], ds.metric, dev)
    d_dim = ds.train.shape[1]
    grid = tuple(v for v in N_CAND_GRID if v < n)

    # the fp32 baseline both gates measure against
    exact = spec.build(ds.train, metric=ds.metric, device=dev)
    t_exact = best_s(lambda: spec.search(exact, Q, k=K), dev)
    gt = spec.search(exact, Q, k=K)[1].cpu().numpy()
    fp32_bytes = 4 * d_dim
    rows = [Row("pq/fp32_exact/scan", t_exact * 1e6,
                f"b={nq};n={n};d={d_dim};bytes_per_vec={fp32_bytes};"
                f"qps={nq / t_exact:.0f};recall=1.000")]

    summary = {"shape": {"n": n, "d": d_dim, "b": nq, "k": K},
               "fp32_bytes_per_vec": fp32_bytes}
    for name, quantize in CODEC_CASES.items():
        st = spec.build(ds.train, metric=ds.metric, quantize=quantize,
                        device=dev)
        code_bytes = bytes_per_vector(st.stat("quant"))
        ratio = fp32_bytes / code_bytes

        # one sweep serves the whole n_cand recall/QPS curve
        _, sweep_ids = search_sweep(st, Q, k=K, knob_grid={"n_cand": grid})
        sweep_ids = sweep_ids.cpu().numpy()
        recalls = {v: _recall(sweep_ids[i], gt) for i, v in enumerate(grid)}

        # equal-recall operating point: the exact scan's recall is 1.0
        # against its own ground truth, so the bar is 1.0 - RECALL_TOL
        equal = [v for v in grid if recalls[v] >= 1.0 - RECALL_TOL]
        assert equal, (
            f"{name}: no swept n_cand within {RECALL_TOL} of the exact "
            f"scan's recall@{K} (best {max(recalls.values()):.3f}); "
            f"widen N_CAND_GRID")
        v_eq = equal[0]
        t_q = best_s(lambda: spec.search(st, Q, k=K, n_cand=v_eq), dev)
        summary[name] = {
            "bytes_per_vec": code_bytes, "ratio": round(ratio, 2),
            "equal_recall_n_cand": v_eq,
            "recall_at_equal": round(recalls[v_eq], 4),
            "recall_curve": {str(v): round(r, 4)
                             for v, r in sorted(recalls.items())},
            "qps": round(nq / t_q), "qps_fp32_exact": round(nq / t_exact),
        }
        rows.append(Row(
            f"pq/{name}/adc_rerank", t_q * 1e6,
            f"b={nq};n={n};d={d_dim};bytes_per_vec={code_bytes};"
            f"ratio={ratio:.0f}x;n_cand={v_eq};"
            f"recall={recalls[v_eq]:.3f};qps={nq / t_q:.0f}"))

    # compression gate: the headline PQ config
    pq_ratio = summary["pq_m16_b8"]["ratio"]
    assert pq_ratio >= MIN_RATIO, (
        f"pq m=16 bits=8 compresses only {pq_ratio}x vs fp32 "
        f"(gate: >= {MIN_RATIO}x at equal recall)")

    # kernel parity gate: ADC kernel ids == torch fold ids, end to end
    st_fold = spec.build(ds.train, metric=ds.metric,
                         quantize=CODEC_CASES["pq_m16_b8"], device=dev)
    st_kern = spec.build(ds.train, metric=ds.metric,
                         quantize=CODEC_CASES["pq_m16_b8"],
                         adc_kernel=True, device=dev)
    Qk = Q[:KERNEL_NQ]
    v_mid = grid[len(grid) // 2]
    _, i_fold = spec.search(st_fold, Qk, k=K, n_cand=v_mid)
    sync(dev)
    t_kern = time.perf_counter()
    _, i_kern = spec.search(st_kern, Qk, k=K, n_cand=v_mid)
    sync(dev)
    t_kern = time.perf_counter() - t_kern
    assert i_kern.equal(i_fold), "ADC kernel != torch gather-fold (ids)"
    rows.append(Row("pq/pq_m16_b8/adc_kernel", t_kern * 1e6,
                    f"b={KERNEL_NQ};n_cand={v_mid};device={dev.type};"
                    f"parity=ids_bitwise"))
    summary["kernel_ids_bitwise"] = True
    return rows, summary


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--smoke", action="store_true",
                   help="tiny dataset (CI smoke lane)")
    p.add_argument("--scale", default=None,
                   choices=["smoke", "default", "full"])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args()
    scale = args.scale or ("smoke" if args.smoke else "default")
    rows, summary = run_with_summary(scale, args.device)
    print("name,us_per_call,derived")
    for row in rows:
        print(row.csv())
    path = write_bench_json("pq", rows, scale=scale, extra=summary)
    print(f"wrote {path}")
