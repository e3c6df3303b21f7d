"""ANN-Benchmarks core in PyTorch: the paper's benchmarking framework.

Public surface:
    BaseANN            algorithm interface (paper §3.1)
    get_definitions    config expansion (paper §3.3)
    run_definition     experiment loop (paper §3.4)
    METRICS            metric registry (paper §2, §3.6)
    store/load runs    results layer (paper §3.6)
"""

from repro_torch.core.interface import BaseANN
from repro_torch.core.config import Definition, get_definitions, instantiate
from repro_torch.core.experiment import ExperimentSettings, run_definition
from repro_torch.core.metrics import METRICS, RunRecord, compute_all, recall
from repro_torch.core import results
from repro_torch.core.pareto import algorithm_frontiers, frontier

__all__ = [
    "BaseANN", "Definition", "get_definitions", "instantiate",
    "ExperimentSettings", "run_definition", "METRICS", "RunRecord",
    "compute_all", "recall", "results", "algorithm_frontiers", "frontier",
]
