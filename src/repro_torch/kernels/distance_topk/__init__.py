from repro_torch.kernels.distance_topk.distance_topk import (
    merge_topk_rounds, stream_topk_kernel, stream_topk_plain)
from repro_torch.kernels.distance_topk.ops import (stream_topk,
                                                   stream_topk_batched)
from repro_torch.kernels.distance_topk.ref import (stream_topk_ref,
                                                   stream_topk_ref_scan)

__all__ = ["merge_topk_rounds", "stream_topk", "stream_topk_batched",
           "stream_topk_kernel", "stream_topk_plain", "stream_topk_ref",
           "stream_topk_ref_scan"]
