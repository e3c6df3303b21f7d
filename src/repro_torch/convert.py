"""Carry a reference index across: the arrays of a ``repro`` IndexState,
as numpy arrays, become a port :class:`IndexState` that the port's search
functions take.

    ref = repro.ann.ivf.build(X, metric="euclidean", n_clusters=64)
    arrays = {k: np.asarray(v) for k, v in ref.arrays.items()}
    st = state_from_reference("IVF", ref.metric, arrays, ref.static,
                              device="cpu")
    repro_torch.ann.ivf.search(st, Q, k=10, n_probes=5)

A reference ``Sharded*`` state carries across the same way: its
``[n_shards, ...]`` arrays as they are, its mesh recipe (``shard_axes``,
``mesh_shape``) in ``static``; the port serves it on the stacked mesh
(:mod:`repro_torch.dist.shard_state`).

An LM's weights and decode caches carry across the same way
(:func:`lm_params_from_reference`, :func:`caches_from_reference`):

    ref = repro.models.transformer.init(jax.random.PRNGKey(0), cfg)
    params = lm_params_from_reference(jax.tree.map(np.asarray, ref),
                                      device="cpu")

The functions take numpy only, so they import nothing of JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

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


def _reference_tensor(a, dev) -> torch.Tensor:
    """A numpy array as a tensor on ``dev``.  A bfloat16 array (JAX hands
    bf16 leaves out as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses) is taken by its bits: viewed as int16, then as bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16), copy=True))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _tree_to_torch(tree, dev):
    if isinstance(tree, Mapping):
        return {k: _tree_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, dev) for v in tree)
    return _reference_tensor(tree, dev)


def lm_params_from_reference(arrays: Mapping[str, Any],
                             device=None) -> dict:
    """The reference's LM params tree (``{"embed", "final_ln", "runs":
    [...], "lm_head"?}``, numpy leaves) as the port's tree of tensors on
    ``device``, leaf for leaf: each run's leaves keep their stacked
    leading layer axis."""
    return _tree_to_torch(arrays, resolve_device(device))


def caches_from_reference(caches: Sequence, device=None) -> list:
    """The reference's decode caches (one tuple of numpy arrays a run) as
    the port's list of tuples of tensors on ``device``."""
    return _tree_to_torch(list(caches), resolve_device(device))
