from repro_torch.kernels.hamming.hamming import (hamming_dist_kernel,
                                                 hamming_dist_plain,
                                                 hamming_topk_kernel,
                                                 hamming_topk_plain)
from repro_torch.kernels.hamming.ops import hamming_topk
from repro_torch.kernels.hamming.ref import hamming_topk_ref

__all__ = ["hamming_dist_kernel", "hamming_dist_plain", "hamming_topk",
           "hamming_topk_kernel", "hamming_topk_plain", "hamming_topk_ref"]
