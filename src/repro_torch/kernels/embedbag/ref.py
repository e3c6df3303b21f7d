"""Plain torch oracle for the embedding bag
(``repro.kernels.embedbag.ref``): gather + segment sum."""

from __future__ import annotations

import torch


def embedding_bag_ref(indices, bags, weights, table, *, n_bags: int):
    rows = table[indices.long()] * weights[:, None]
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                      device=table.device)
    return out.index_add_(0, bags.long(), rows)
