"""Carry a reference index across: the arrays of a ``repro`` IndexState,
as numpy arrays, become a port :class:`IndexState` that the port's search
functions take.

    ref = repro.ann.ivf.build(X, metric="euclidean", n_clusters=64)
    arrays = {k: np.asarray(v) for k, v in ref.arrays.items()}
    st = state_from_reference("IVF", ref.metric, arrays, ref.static,
                              device="cpu")
    repro_torch.ann.ivf.search(st, Q, k=10, n_probes=5)

The function takes numpy only, so it imports nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann.functional import IndexState
from repro_torch.bits import words_to_tensor


def state_from_reference(algo: str, metric: str,
                         arrays: Mapping[str, np.ndarray],
                         static: Mapping[str, Any],
                         device=None) -> IndexState:
    """An IndexState on ``device`` holding the same arrays and statics.
    uint32 arrays (packed codes) become int32 tensors with the same bits;
    a tuple or list of arrays (HNSW's ``layers``, one width per level)
    becomes a tuple of tensors; a nested port state (a mutable index's
    ``main``) is kept as it is."""
    dev = resolve_device(device)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return words_to_tensor(a, dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    out = {name: a if isinstance(a, IndexState)
           else tuple(tensor(x) for x in a) if isinstance(a, (tuple, list))
           else tensor(a) for name, a in arrays.items()}
    return IndexState(algo, metric, out, dict(static))
