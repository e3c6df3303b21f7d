"""Kernel 4's launch plan against the card: the ADC code scan timed at fixed
shapes for every variant (queries per block G, rows per lane R, threads
per block) with the plan's splits for it, and the default variant across
split counts, beside the plan's modelled cost of each launch and its
split rule's choice.

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_adc_plan

Needs a CUDA card.  The codes are n = 10^6 rows of uniform random bytes and
the tables uniform in [0, 1), from seed 3; the cases are the compressed
path's (PQ m = 16 at b = 10^4, C = 1,000; int8 m = 128 at b = 10^4,
C = 200), b = 4,096 at C = 10 for both, PQ at b = 4,096, C = 256 and
1,024, int8 at b = 4,096, C = 10 over n = 2.5 * 10^5 rows, whose 32 MB of
codes stay in L2 (the 10^6 rows' 128 MB do not), and small batches (b = 1,
8, 64 at C = 10 for both), whose splits come from ``split_rule`` and are
timed against 1 to 128.
Prints one JSON line per launch: its plan, its time (CUDA events, mean of 2 after a warm-up), the
model's cost (``adc_scan.plan_cost``, in SM cycles) and whether its answer
equals the default plan's bit for bit; then, per case, the default plan.
``adc_scan``'s cost constants (``LOOKUP_CYCLES``, ``BLOCK_CYCLES``,
``CAS_CYCLES``) are fitted to these times: rerun it after a change to the
kernel's loop or its selection, and to time a new variant add it to the
kernel's ``scan_variant`` and to ``adc_scan.VARIANTS``.
"""

from __future__ import annotations

import json

import torch

from repro_torch.kernels.adc_scan.adc_scan import (VARIANTS, adc_scan_kernel,
                                                   blocks_per_sm, plan)

K = 256
CASES = [("pq", 16, 10_000, 1000, 10**6), ("pq", 16, 4096, 10, 10**6),
         ("pq", 16, 4096, 256, 10**6), ("pq", 16, 4096, 1024, 10**6),
         ("int8", 128, 4096, 10, 10**6), ("int8", 128, 10_000, 200, 10**6),
         ("int8", 128, 4096, 10, 250_000)] + [
             (codec, m, b, 10, 10**6) for codec, m in (("pq", 16),
                                                        ("int8", 128))
             for b in (1, 8, 64)]
SPLITS = (1, 2, 3, 4, 8, 16)
SMALL_SPLITS = (1, 2, 4, 8, 16, 32, 64, 128)   # below b = 4,096


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_adc_plan: needs a CUDA card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(3)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms,
                      "K": K}), flush=True)
    for codec, m, b, C, n in CASES:
        codes = torch.randint(0, K, (n, m), generator=gen, device="cuda",
                              dtype=torch.uint8)
        luts = torch.rand((b, m, K), generator=gen, device="cuda")
        default = plan(b, n, m, K, C, sms, occupancy=blocks_per_sm)
        ref = adc_scan_kernel(codes, luts, k=C)
        tried = set()
        pins = [dict(G=g, R=r, threads=nt) for g, r, nt, _ in VARIANTS] + [
            dict(G=default["G"], R=default["R"], threads=default["threads"],
                 splits=s) for s in (SPLITS if b >= 4096 else SMALL_SPLITS)]
        for pin in pins:
            try:
                p = plan(b, n, m, K, C, sms, occupancy=blocks_per_sm, **pin)
            except ValueError:          # the variant does not fit
                continue
            key = (p["G"], p["R"], p["threads"], p["BUF"], p["splits"])
            if key in tried:
                continue
            tried.add(key)
            got = adc_scan_kernel(codes, luts, k=C, plan=p)
            same = bool(torch.equal(got[0], ref[0])
                        and torch.equal(got[1], ref[1]))
            ms = cuda_ms(lambda: adc_scan_kernel(codes, luts, k=C, plan=p))
            print(json.dumps({
                "codec": codec, "m": m, "b": b, "C": C, "n": n, "G": p["G"],
                "R": p["R"], "threads": p["threads"], "BUF": p["BUF"],
                "splits": p["splits"],
                "smem": p["smem"], "blocks_per_sm": p["blocks_per_sm"],
                "ms": ms, "model_cycles": p["cost_cycles"],
                "equal_to_default": same}), flush=True)
        print(json.dumps({"codec": codec, "m": m, "b": b, "C": C, "n": n,
                          "default_plan": default}), flush=True)
        del codes, luts, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
