"""The port's mesh: ``S`` logical devices stacked on one torch device.

The reference shards over a JAX device mesh; its tests and benches force
``N`` host devices with ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
and search them from one process.  The port's counterpart is a *stacked*
mesh: the logical devices of a :class:`Mesh` all live on one torch device,
every sharded array keeps the reference's leading ``[n_shards, ...]`` dim
there, and each collective acts on that dim
(:mod:`repro_torch.dist.collectives`).  Real multi-GPU placement is not
part of this module: the same merge also runs one shard per rank of a
``torch.distributed`` group, which is how several processes realise it.

:func:`device_count` is the logical device count, the counterpart of
``jax.device_count()`` under forced host devices:

  * the value set by :func:`force_device_count`, if one was set;
  * else ``N`` from ``--xla_force_host_platform_device_count=N`` in
    ``XLA_FLAGS`` (the reference's own switch, so its documented commands
    carry over);
  * else 1.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Optional, Tuple

import torch

_FORCED: Optional[int] = None
_FLAG = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def force_device_count(n: Optional[int]) -> Optional[int]:
    """Set the logical device count (``None`` returns to ``XLA_FLAGS``);
    returns the setting it replaces, for a caller to put back."""
    global _FORCED
    if n is not None and int(n) < 1:
        raise ValueError(f"device count must be >= 1, got {n}")
    prev, _FORCED = _FORCED, (None if n is None else int(n))
    return prev


def device_count() -> int:
    """The logical device count (module docstring)."""
    if _FORCED is not None:
        return _FORCED
    found = _FLAG.findall(os.environ.get("XLA_FLAGS", ""))
    return int(found[-1]) if found else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``prod(sizes)`` logical devices over the named axes, all on
    ``device`` (``None``: wherever the arrays placed on it already are).

    ``mesh.shape[axis]`` and ``mesh.axis_names`` read as in JAX.  Lanes
    are numbered row-major over the axes, as a sharded array's dim 0 is
    laid out over them."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: Optional[torch.device] = None

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.sizes)
        axes = tuple(str(a) for a in self.axis_names)
        if len(sizes) != len(axes) or any(s < 1 for s in sizes):
            raise ValueError(f"mesh shape {sizes} does not fit axes {axes}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh axes repeat: {axes}")
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "axis_names", axes)
        if self.device is not None:
            object.__setattr__(self, "device", torch.device(self.device))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)
