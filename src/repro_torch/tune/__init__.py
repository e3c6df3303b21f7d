"""Constrained auto-tuning over query-knob grids (``repro.tune``): Sun et
al. 2023-style operating-point selection on top of
``functional.search_sweep``.

    from repro_torch import tune

    result = tune.grid_search(state, Q, ds.distances, k=10,
                              knob_grid={"n_probes": (1, 4, 16, 64)},
                              constraint=tune.Constraint.min_recall(0.9))
    result.best_params()        # e.g. {"n_probes": 16} -- max QPS at the floor
"""

from repro_torch.tune.tuner import (Constraint, OperatingPoint, TuneResult,
                                    grid_search, select)

__all__ = ["Constraint", "OperatingPoint", "TuneResult", "grid_search",
           "select"]
