from repro_torch.kernels.rerank_topk.ops import (pick_rerank_block,
                                                 rerank_topk)
from repro_torch.kernels.rerank_topk.ref import rerank_topk_ref
from repro_torch.kernels.rerank_topk.rerank_topk import (
    merge_topk_unique_rounds, rerank_topk_kernel, rerank_topk_plain)

__all__ = ["merge_topk_unique_rounds", "pick_rerank_block", "rerank_topk",
           "rerank_topk_kernel", "rerank_topk_plain", "rerank_topk_ref"]
