"""PyTorch implementations of the paper's algorithm families (Table 2).

Importing this package registers every ported algorithm with the core
registry.  Ported so far: BruteForce and IVF.
"""

from repro_torch.ann import distances, topk
from repro_torch.ann.bruteforce import BruteForce
from repro_torch.ann.ivf import IVF

__all__ = ["distances", "topk", "BruteForce", "IVF"]
