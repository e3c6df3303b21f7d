"""Kernel 1's launch plan against the card: the streaming distance + top-k
kernel timed at fixed shapes across split counts and both query-row
variants, beside the plan's modelled cost of each launch.

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_stream_plan

Needs a CUDA card.  The corpus is 10^6 x 128 float32 (SIFT-1M's shape,
normal from seed 0), l2sq; the cases are the main path's (10^4 queries,
k = 10) and nq = 4,096 at k = 10, 100 and 256.  Prints one JSON line per
launch: its plan, its time (CUDA events, mean of 2 after a warm-up), the
model's cost (``distance_topk.plan_cost``, in 128-row tiles) and whether
its answer equals the default plan's bit for bit; then, per case, the
default plan.  ``distance_topk``'s cost constants (``TILE_TIME``,
``ALONE``, ``INSERT_TIME``) are fitted to these times: rerun it after a
change to the kernel's loop or its selection.
"""

from __future__ import annotations

import json

import torch

from repro_torch.kernels.distance.distance import norm_operand
from repro_torch.kernels.distance_topk.distance_topk import (
    BN, Plan, blocks_per_sm, kernel_plan, plan_cost, smem_bytes,
    stream_topk_kernel)

N, D = 1_000_000, 128
CASES = [(10_000, 10, [(128, s) for s in (3, 6, 10, 20, 33, 66)]
          + [(64, s) for s in (5, 10)]),
         (4096, 10, [(128, s) for s in (3, 6, 8, 10, 20, 33, 66)]
          + [(64, s) for s in (5, 10)]),
         (4096, 100, [(64, s) for s in (1, 2, 4, 5, 8, 12, 16, 33, 66)]
          + [(128, s) for s in (2, 4, 8, 16, 33)]),
         (4096, 256, [(64, s) for s in (1, 2, 3, 4, 8, 16, 33)])]


def cuda_ms(fn, reps: int = 2) -> float:
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


def plan_for(rows: int, splits: int, k: int) -> Plan:
    tiles = -(-N // BN)
    per = -(-tiles // splits)
    return Plan(rows, -(-tiles // per), per * BN, smem_bytes(rows, k))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_stream_plan: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((N, D), generator=gen, device="cuda")
    Qall = torch.randn((10_000, D), generator=gen, device="cuda")
    xsq = norm_operand(X, "l2sq")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms,
                      "n": N, "d": D}), flush=True)
    for nq, k, sweep in CASES:
        Q = Qall[:nq].contiguous()
        qsq = norm_operand(Q, "l2sq")
        default = kernel_plan(Q, X, k, "l2sq")
        ref = stream_topk_kernel(Q, X, qsq, xsq, mode="l2sq", k=k)
        for rows, splits in sweep:
            plan = plan_for(rows, splits, k)
            if plan.smem > 232_448:
                continue
            per_sm = blocks_per_sm(rows, k, True, "l2sq")
            got = stream_topk_kernel(Q, X, qsq, xsq, mode="l2sq", k=k,
                                     plan=plan)
            same = bool(torch.equal(got[0], ref[0])
                        and torch.equal(got[1], ref[1]))
            ms = cuda_ms(lambda: stream_topk_kernel(
                Q, X, qsq, xsq, mode="l2sq", k=k, plan=plan))
            print(json.dumps({
                "nq": nq, "k": k, "rows": rows, "splits": plan.splits,
                "rows_per_split": plan.rows_per_split,
                "blocks": -(-nq // rows) * plan.splits,
                "blocks_per_sm": per_sm, "ms": ms,
                "model_tiles": plan_cost(nq, N, k, sms, per_sm, rows,
                                         plan.splits),
                "equal_to_default": same}), flush=True)
        print(json.dumps({"nq": nq, "k": k, "default_plan":
                          default._asdict()}), flush=True)


if __name__ == "__main__":
    main()
