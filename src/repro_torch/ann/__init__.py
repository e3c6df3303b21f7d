"""PyTorch implementations of the paper's algorithm families (Table 2).

Importing this package registers every ported algorithm with the core
registry.  Ported so far: BruteForce, IVF, RPForest, HyperplaneLSH, E2LSH,
BruteForceHamming, BitsamplingAnnoy and MultiIndexHashing.
"""

from repro_torch.ann import distances, topk
from repro_torch.ann.bruteforce import BruteForce
from repro_torch.ann.ivf import IVF
from repro_torch.ann.rpforest import RPForest
from repro_torch.ann.lsh import HyperplaneLSH, E2LSH
from repro_torch.ann.hamming import (BitsamplingAnnoy, BruteForceHamming,
                                     MultiIndexHashing)

__all__ = [
    "distances", "topk", "BruteForce", "IVF", "RPForest", "HyperplaneLSH",
    "E2LSH", "BitsamplingAnnoy", "BruteForceHamming", "MultiIndexHashing",
]
