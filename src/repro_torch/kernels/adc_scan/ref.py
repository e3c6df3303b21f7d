"""Plain torch oracle for the ADC scan (``repro.kernels.adc_scan.ref``):
the full [b, n] table-lookup distances (subspaces summed in index order)
and one canonical ``topk_unique``."""

from __future__ import annotations

import torch

from repro_torch.kernels.adc_scan.adc_scan import lookup


def adc_scan_ref(codes, luts, *, k: int):
    """(adc_dists [b, kk], rows [b, kk]) over the whole code table;
    kk = min(k, n), rows sorted by (dist, row) ascending."""
    from repro_torch.ann.topk import topk_unique   # deferred: import cycle

    n = codes.shape[0]
    d = lookup(codes, luts)
    rows = torch.arange(n, dtype=torch.int32,
                        device=luts.device).expand(d.shape[0], -1)
    return topk_unique(d, rows, min(k, n))
