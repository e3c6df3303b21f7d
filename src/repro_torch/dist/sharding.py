"""Logical-axis sharding, the resolution half (``repro.dist.sharding``).

Models annotate arrays with *logical* axis names ("batch", "embed",
"mlp", ...); this module maps them onto whatever *physical* mesh axes
exist.  A logical name absent from the table is treated as a physical axis
name.  Specs are plain tuples here, one entry per array dim: a physical
axis name, a tuple of them, or ``None`` (replicated) -- the reference's
``PartitionSpec`` entries.

The model half (``constrain``, ``named_sharding``, ``is_axes_leaf``,
``spec_tree_to_shardings``) annotates the models' arrays.  On the stacked
mesh every logical device lives on one torch device, so an annotation
places nothing: ``constrain`` returns its input, as the reference's
``with_sharding_constraint`` never changes a value, and the sharding of
an array is its resolved spec tuple.  The ANN layer needs only the rule
for its corpus arrays: dim 0 over the shard axes (:func:`rows_sharding`),
which the stacked mesh realises by keeping that dim on one device
(:mod:`repro_torch.dist.mesh`).
"""

from __future__ import annotations

from typing import Sequence

# logical axis -> physical mesh axes, in priority order.  Entries missing
# from the mesh (or already claimed by an earlier dim of the same spec) are
# dropped, so the same model code runs on any mesh.
LOGICAL_AXES = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "rows": ("pod", "data", "model"),     # fully-sharded corpus rows (ANN)
    "embed": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "seq_model": ("model",),
}


def _resolve(mesh, entry, used: set):
    if entry is None:
        return None
    phys = LOGICAL_AXES.get(entry, (entry,))
    picked = tuple(a for a in phys if a in mesh.axis_names and a not in used)
    used.update(picked)
    if not picked:
        return None
    return picked if len(picked) > 1 else picked[0]


def partition_spec(mesh, *entries) -> tuple:
    """The spec for logical ``entries`` (one per array dim, or none for
    fully replicated): a tuple of physical axes (or ``None``) per dim."""
    used: set = set()
    return tuple(_resolve(mesh, e, used) for e in entries)


def named_sharding(mesh, *entries) -> tuple:
    """The sharding of an array under logical ``entries``: on the stacked
    mesh, its resolved spec (:func:`partition_spec`)."""
    return partition_spec(mesh, *entries)


def constrain(x, mesh, *entries):
    """The reference's sharding constraint under a logical spec: ``x``
    itself, with or without a mesh (a constraint changes no value, and
    the stacked mesh keeps every logical device on ``x``'s device)."""
    return x


def is_axes_leaf(x) -> bool:
    """True for a tuple of logical axis names (a spec-tree leaf)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def spec_tree_to_shardings(spec_tree, mesh):
    """Map a tree (dicts, lists, tuples) of logical-axes tuples to their
    shardings (:func:`named_sharding`), keeping the tree's structure."""
    if is_axes_leaf(spec_tree):
        return named_sharding(mesh, *spec_tree)
    if isinstance(spec_tree, dict):
        return {k: spec_tree_to_shardings(v, mesh)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(spec_tree_to_shardings(v, mesh)
                               for v in spec_tree)
    if spec_tree is None:
        return None
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def rows_sharding(mesh, axes: Sequence[str]) -> tuple:
    """The spec of index arrays with a leading ``[n_shards, ...]`` dim:
    dim 0 laid out jointly over ``axes`` (row-major, the first axis
    outermost), every trailing dim replicated."""
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh's "
                         f"{mesh.axis_names}")
    return (tuple(axes),)


def mesh_axes_size(mesh, axes: Sequence[str]) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size
