"""PyTorch implementations of the paper's algorithm families (Table 2).

Importing this package registers every ported algorithm with the core
registry.  Ported so far: BruteForce, IVF, RPForest, HyperplaneLSH, E2LSH,
BruteForceHamming, BitsamplingAnnoy, MultiIndexHashing, KNNGraph, HNSW,
and the mutable variants MutableBruteForce and MutableIVF
(:mod:`repro_torch.mutate`).
"""

from repro_torch.ann import distances, topk
from repro_torch.ann.bruteforce import BruteForce
from repro_torch.ann.ivf import IVF
from repro_torch.ann.rpforest import RPForest
from repro_torch.ann.lsh import HyperplaneLSH, E2LSH
from repro_torch.ann.hamming import (BitsamplingAnnoy, BruteForceHamming,
                                     MultiIndexHashing)
from repro_torch.ann.graph import KNNGraph
from repro_torch.ann.hnsw import HNSW
# the mutable (delta-buffered) variants live outside this package but
# register through the same registries; a plain module import (no name
# access -- repro_torch.mutate imports back into this package) keeps the
# cycle resolvable from either entry point
import repro_torch.mutate  # noqa: E402,F401

__all__ = [
    "distances", "topk", "BruteForce", "IVF", "RPForest", "HyperplaneLSH",
    "E2LSH", "BitsamplingAnnoy", "BruteForceHamming", "MultiIndexHashing",
    "KNNGraph", "HNSW",
]
