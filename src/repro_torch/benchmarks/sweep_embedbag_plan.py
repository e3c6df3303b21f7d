"""Kernel 6's launch plan against the card: the embedding-bag kernel timed
at fixed cases for every compiled variant that takes the rows (vector
bytes, lanes per row) and across bags per group, beside the plan's
choice.

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_embedbag_plan

Needs a CUDA card.  The cases (:data:`CASES`, which ``chip_smoke.py``
runs too) are 524,288 uniform lookups with weights in [0, 1) into
Criteo-1TB's largest table (39,884,406 rows, from seed 5): 65,536 bags
(8 lookups a bag on average, every thousandth empty), 524,288 bags (one
lookup each) and 5,243 bags (100 each) at D = 128 fp32; 65,536 bags at
D = 128 bf16, at DCN-v2's D = 16 and FM's D = 10 in fp32.  Three cases
more (:data:`EXTRA`): the 65,536 bags with the lookups drawn from the
first 3,906,250 rows (a 2 GB slice) of the same 20.4 GB table, to tell
whether page walks or DRAM set the random-gather rate; and at D = 16 and
10 from the first 300,000 and 500,000 rows (19 and 20 MB, which stay in
the 50 MB L2), to tell whether DRAM or the kernel sets the rate of the
narrow rows.
Prints one JSON line per launch: its plan, its time (the mean of 20
launches captured in a CUDA graph after a warm-up, taking :data:`SETS`
draws of the lookups in turn, so that the rows one draw touches have
left the L2 when it comes again), its rate in GB/s of the bytes the case
must move, and whether its answer equals the default plan's bit for bit;
then, per case, the default plan.  ``embedbag``'s ``ROWS_IN_FLIGHT`` and
its one-wave rule for bags per group are fitted to these times: rerun it
after a change to the kernel's walk, and to time another U or vector
width, change the kernel's ``EMBEDBAG_VARIANTS`` and ``embedbag``'s
tables with it.
"""

from __future__ import annotations

import json

import torch

from repro_torch.benchmarks.common import graph_ms
from repro_torch.kernels.embedbag import bag_spans, embedding_bag_kernel
from repro_torch.kernels.embedbag.embedbag import (VARIANTS, DTYPES,
                                                   blocks_per_sm, plan)

V, N = 39_884_406, 524_288
SLICE = 3_906_250            # rows of a 2 GB slice of the fp32 table
SETS = 4                     # draws of a case's lookups a timing takes
# (name, D, dtype, bags): lookups drawn from all V rows
CASES = (("criteo", 128, torch.float32, 65_536),
         ("one_hot", 128, torch.float32, 524_288),
         ("long_bags", 128, torch.float32, 5_243),
         ("bf16", 128, torch.bfloat16, 65_536),
         ("dcn_v2_width", 16, torch.float32, 65_536),
         ("fm_width", 10, torch.float32, 65_536))
# (name, D, dtype, bags, rows the lookups are drawn from)
EXTRA = (("criteo_2gb_slice", 128, torch.float32, 65_536, SLICE),
         ("dcn_v2_width_in_l2", 16, torch.float32, 65_536, 300_000),
         ("fm_width_in_l2", 10, torch.float32, 65_536, 500_000))
BAGS_PER_GROUP = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def lookups(name: str, B: int, rows: int, gen, sets: int = 1):
    """The sorted int32 bag ids of a case (one lookup a bag for
    ``one_hot``, 100 for ``long_bags``, else uniform over ``B`` bags with
    every thousandth left empty) and ``sets`` draws of its lookups:
    (int32 rows uniform in [0, rows), float32 weights in [0, 1))."""
    if name == "one_hot":
        bags = torch.arange(N, device="cuda")
    elif name == "long_bags":
        bags = torch.arange(N, device="cuda") // 100
    else:
        bags = torch.randint(0, B, (N,), generator=gen, device="cuda")
        bags = torch.sort(bags + (bags % 1000 == 7)).values
    if int(bags.max()) >= B:
        raise ValueError(f"embedding_bag case {name}: bag ids past {B}")
    draws = [(torch.randint(0, rows, (N,), generator=gen, device="cuda",
                            dtype=torch.int32),
              torch.rand((N,), generator=gen, device="cuda"))
             for _ in range(sets)]
    return bags.to(torch.int32), draws


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_embedbag_plan: needs a CUDA card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(5)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms,
                      "sets": SETS}), flush=True)
    table, key = None, None
    cases = [c + (V,) for c in CASES] + list(EXTRA)
    cases.sort(key=lambda c: (c[1], str(c[2])))      # one table at a time
    for name, D, dtype, B, rows in cases:
        if key != (D, dtype):
            table = None
            torch.cuda.empty_cache()
            table = torch.randn((V, D), generator=gen,
                                device="cuda").to(dtype)
            key = (D, dtype)
        bags, draws = lookups(name, B, rows, gen, SETS)
        spans = bag_spans(bags, n_bags=B)
        isz = table.element_size()
        nbytes = float(isz) * N * D + 8.0 * N + 8.0 * B + float(isz) * B * D
        default = plan(B, N, D, dtype, True, sms, blocks_per_sm)
        idx, w = draws[0]
        ref = embedding_bag_kernel(idx, w, table, spans, n_bags=B,
                                   plan=default)
        pins = [dict(vec=v, cpl=c) for dt, v, c, _ in VARIANTS
                if dt == DTYPES[dtype]] + [
            dict(vec=default["vec"], cpl=default["cpl"], bags_per_group=g)
            for g in BAGS_PER_GROUP]
        tried = set()
        for pin in pins:
            try:
                p = plan(B, N, D, dtype, True, sms, blocks_per_sm, **pin)
            except ValueError:     # vectors that do not divide a row, or
                continue           # more bags a group than a block stages
            k = (p["vec"], p["cpl"], p["bags_per_group"])
            if k in tried:
                continue
            tried.add(k)
            got = embedding_bag_kernel(idx, w, table, spans, n_bags=B,
                                       plan=p)
            same = bool(torch.equal(got, ref))
            del got
            ms = graph_ms([
                lambda i=i, w=w, p=p: embedding_bag_kernel(
                    i, w, table, spans, n_bags=B, plan=p)
                for i, w in draws])
            print(json.dumps({
                "case": name, "D": D, "dtype": str(dtype), "bags": B,
                "rows": rows, "vec": p["vec"], "cpl": p["cpl"],
                "lanes": p["lanes"], "passes": p["passes"], "U": p["U"],
                "bags_per_group": p["bags_per_group"], "grid": p["grid"],
                "blocks_per_sm": p["blocks_per_sm"], "ms": ms,
                "gbytes_per_s": nbytes / ms / 1e6,
                "equal_to_default": same}), flush=True)
        print(json.dumps({"case": name, "default_plan": default}),
              flush=True)
        del idx, w, bags, draws, spans, ref
    del table
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
