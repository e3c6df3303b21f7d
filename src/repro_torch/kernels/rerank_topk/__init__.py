from repro_torch.kernels.rerank_topk.lists import (
    launch_plan, pair_build, rerank_lists_kernel, rerank_lists_plain)
from repro_torch.kernels.rerank_topk.ops import (pick_rerank_block,
                                                 rerank_lists, rerank_topk)
from repro_torch.kernels.rerank_topk.ref import rerank_topk_ref
from repro_torch.kernels.rerank_topk.rerank_topk import (
    EXACT_REL, err_vs_exact, merge_topk_unique_rounds, rerank_dist_kernel,
    rerank_dist_plain, rerank_topk_kernel, rerank_topk_plain)

__all__ = ["EXACT_REL", "err_vs_exact", "launch_plan",
           "merge_topk_unique_rounds", "pair_build", "pick_rerank_block",
           "rerank_dist_kernel", "rerank_dist_plain", "rerank_lists",
           "rerank_lists_kernel", "rerank_lists_plain", "rerank_topk",
           "rerank_topk_kernel", "rerank_topk_plain", "rerank_topk_ref"]
