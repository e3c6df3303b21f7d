from repro_torch.kernels.embedbag.embedbag import (embedding_bag_kernel,
                                                   embedding_bag_plain)
from repro_torch.kernels.embedbag.ops import (bag_runs, bag_spans,
                                              embedding_bag)
from repro_torch.kernels.embedbag.ref import embedding_bag_ref

__all__ = ["bag_runs", "bag_spans", "embedding_bag", "embedding_bag_kernel",
           "embedding_bag_plain", "embedding_bag_ref"]
