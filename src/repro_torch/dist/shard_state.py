"""Generic sharded serving layer: shard any registered ``IndexState``
(``repro.dist.shard_state``).

A :class:`ShardPlan` teaches this module how one single-device algorithm's
state partitions across shards (``shard``/``unshard``) and how one shard
answers a query locally (``local_topk``).  Everything else -- the mesh
recipe, the compressed hierarchical top-k merge
(:func:`repro_torch.dist.collectives.tree_merge_topk`), resharding, and
checkpoint portability -- is shared here, so adding a sharded algorithm
is a plan registration (:mod:`repro_torch.ann.sharded` registers the row
plan for BruteForce -- plain, quantized, hamming -- and the inverted-list
plan for IVF).

States from :func:`shard_index` are ordinary ``IndexState``s: the sharded
arrays carry a leading ``[n_shards, ...]`` dim, laid out over the mesh
recipe recorded in ``static`` (``shard_axes`` + ``mesh_shape``), so
checkpoints stay mesh-portable -- :func:`resolve_mesh` rebuilds the mesh
on load, :func:`reshard` moves a state to a different shard count, and
:func:`ensure_servable` reshards a recipe larger than this host's logical
device count (:func:`repro_torch.dist.mesh.device_count`).  Every shard
lives on the state's one torch device (the stacked mesh).

The reference compiles one ``shard_map`` program per (mesh, k, statics)
and caches it (``cached_fn``, ``_SHARDED_FNS``).  The port runs eagerly,
so there is nothing to compile or cache: :func:`sharded_search` runs each
shard's local pass in turn and folds the stacked results, and the fault
hook runs on the host on every call, since there is no trace to defer it
from.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.dist import wire
from repro_torch.dist.collectives import tree_merge_topk
from repro_torch.dist.mesh import Mesh, device_count
from repro_torch.dist.sharding import mesh_axes_size


class ShardingError(ValueError):
    """A state's mesh recipe cannot be realised on this host."""


# ------------------------------------------------------------ mesh plumbing
def mesh_for(shape: tuple, axes: tuple) -> Mesh:
    return Mesh(tuple(shape), tuple(axes))


def default_mesh():
    """All logical devices on one flat 'data' axis."""
    return mesh_for((device_count(),), ("data",)), ("data",)


def flat_mesh(n_shards: int):
    """``n_shards`` logical devices on one flat 'data' axis (errors if the
    host has fewer -- simulate with
    ``--xla_force_host_platform_device_count`` or ``force_device_count``)."""
    if n_shards > device_count():
        raise ShardingError(
            f"n_shards={n_shards} needs {n_shards} devices but only "
            f"{device_count()} are visible (set XLA_FLAGS="
            f"--xla_force_host_platform_device_count={n_shards} to simulate)")
    return mesh_for((int(n_shards),), ("data",)), ("data",)


def mesh_recipe(mesh: Mesh, axes: tuple) -> dict:
    return {"shard_axes": tuple(axes),
            "mesh_shape": tuple(int(mesh.shape[a]) for a in axes)}


def resolve_mesh(state, mesh: Optional[Mesh] = None):
    """(mesh, axes) for a sharded state -- from the caller's mesh or the
    state's recorded recipe; raises :class:`ShardingError` with the fix
    when the recipe needs more devices than this host has."""
    axes = tuple(state.stat("shard_axes"))
    if mesh is not None:
        return mesh, axes
    shape = tuple(state.stat("mesh_shape"))
    need = int(np.prod(shape))
    have = device_count()
    if need > have:
        raise ShardingError(
            f"index was sharded for mesh shape {shape} over axes {axes} "
            f"({need} devices) but only {have} logical device(s) are "
            f"visible; reshard it first — repro_torch.dist.shard_state."
            f"reshard(state, n_shards={have}) — or restore through "
            f"ensure_servable()")
    return mesh_for(shape, axes), axes


# ------------------------------------------------------------ plan registry
@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one algorithm's IndexState shards and answers locally.

    ``shard(inner, n_shards) -> (shard_arrays, rep_arrays, static)``:
    partition a single-device state; every tensor in ``shard_arrays`` has
    a leading ``[n_shards, ...]`` dim, ``rep_arrays`` are replicated.

    ``unshard(state) -> IndexState``: exact inverse (drives ``reshard``).

    ``local_topk(q, knobs, loc, rep, env, metric, m) -> (vals, ids)``:
    one shard's [b, w] best (f32 distance, *global* id) candidates, w <= m;
    ``loc`` = this shard's arrays (leading dim stripped), ``rep`` =
    replicated arrays (+ ``prep`` outputs), ``knobs`` = the runtime knobs
    by name (ints or 0-d tensors), ``env`` = the state's static dict plus
    the caller's per-call statics.  Invalid slots come back (+inf, -1).

    ``prep(q, rep, env, metric) -> dict``: optional per-query replicated
    tensors computed once per call for every shard (ADC tables, IVF's
    probes), merged into ``rep``.  The reference gates its prep with
    ``prep_when`` / ``prep_names`` to shape its compiled program; the port
    has no program, so a prep returns what its state needs.
    """
    inner_algo: str
    sharded_algo: str
    shard: Callable
    unshard: Callable
    local_topk: Callable
    prep: Optional[Callable] = None
    knob_names: tuple = ()


SHARD_PLANS: dict = {}
_BY_SHARDED: dict = {}


def _registered() -> None:
    """Import the algorithm package, which registers the plans."""
    import importlib

    importlib.import_module("repro_torch.ann")


def register_shard_plan(plan: ShardPlan) -> ShardPlan:
    SHARD_PLANS[plan.inner_algo] = plan
    _BY_SHARDED[plan.sharded_algo] = plan
    return plan


def sharded_algos() -> tuple:
    """Registered sharded algorithm names (e.g. for launcher validation)."""
    _registered()
    return tuple(sorted(_BY_SHARDED))


def plan_for(state) -> ShardPlan:
    _registered()
    plan = _BY_SHARDED.get(state.algo)
    if plan is None:
        raise ShardingError(f"no shard plan registered for sharded state "
                            f"{state.algo!r} (known: {sorted(_BY_SHARDED)})")
    return plan


# ------------------------------------------------------------- build / serve
def shard_index(inner, *, mesh: Optional[Mesh] = None,
                shard_axes: Optional[Sequence[str]] = None,
                n_shards: Optional[int] = None,
                wire_codec: Optional[str] = None, fan_in: int = 2,
                carry: Optional[int] = None):
    """Shard a built single-device ``IndexState`` across a mesh; the
    shards stay on the inner state's device.

    ``wire_codec`` picks the merge-tree distance codec (default:
    :func:`repro_torch.dist.wire.default_codec` -- u16 for hamming, bf16
    else); ``carry`` is the per-fold tie budget (default 2k at query time).
    """
    from repro_torch.ann.functional import IndexState

    _registered()
    plan = SHARD_PLANS.get(inner.algo)
    if plan is None:
        raise ShardingError(f"no shard plan registered for {inner.algo!r} "
                            f"(known: {sorted(SHARD_PLANS)})")
    if mesh is None:
        mesh, shard_axes = (flat_mesh(int(n_shards)) if n_shards
                            else default_mesh())
    axes = tuple(shard_axes or mesh.axis_names)
    S = mesh_axes_size(mesh, axes)
    codec = wire.check_codec(wire_codec or wire.default_codec(inner.metric))
    shard_arrays, rep_arrays, static = plan.shard(inner, S)
    arrays = dict(shard_arrays)
    arrays.update(rep_arrays)
    static = dict(static)
    static.update(mesh_recipe(mesh, axes))
    static.update({
        "n_shards": S, "wire_codec": codec, "fan_in": int(fan_in),
        "carry": None if carry is None else int(carry),
        "shard_arrays": tuple(sorted(shard_arrays)),
        "inner_algo": inner.algo,
    })
    return IndexState(plan.sharded_algo, inner.metric, arrays, static)


def shard_coverage(state, keep) -> float:
    """Fraction of the index's live rows owned by the surviving shards.

    ``keep`` is a ``[n_shards]`` bool mask.  Both registered plans keep
    the global-id map in the ``ids`` shard array (``[S, L]`` with ``-1``
    padding), so per-shard live-row counts fall out of ``ids >= 0`` --
    this is the ``coverage`` a degraded response reports."""
    ids = state["ids"]
    live = (ids.reshape(ids.shape[0], -1) >= 0).sum(dim=1).cpu().numpy()
    total = int(live.sum())
    if total == 0:
        return 1.0
    return float(live[np.asarray(keep, bool).reshape(-1)].sum()) / total


def sharded_search(state, Q, *, k: int, mesh: Optional[Mesh] = None,
                   knobs: Sequence = (), env_extra: Optional[dict] = None,
                   exact_vals: bool = True, shard_ok=None,
                   fault_hook: bool = True):
    """Replicated exact top-k over a sharded state: ``plan.local_topk`` on
    each shard's slice in turn, then the compressed butterfly merge over
    the stacked results.  ``knobs`` are the plan's runtime knobs (order =
    ``plan.knob_names``); ``env_extra`` overlays per-call statics onto the
    state's static dict (the reference's ``cache_extra``, which keys its
    compiled function, has no counterpart).

    ``exact_vals`` (default on) is the full-precision root tiebreak: the
    returned distances are the owners' exact f32 values and the final
    k-selection happens in f32, so results are order-identical to the
    single-device index.  Turning it off returns wire-precision distances
    (ids still exact up to the carry tie budget).

    ``shard_ok`` is an optional ``[n_shards]`` bool keep-mask: a masked
    shard's local results are forced to the merge tree's ``(+inf, -1)``
    sentinel channel, so the merge stays *exact over the surviving
    shards* (results equal a single-device search over only the
    survivors' rows).

    ``fault_hook`` runs :func:`repro_torch.serve.faults.shard_events` for
    this call (it may raise ``ShardFault``, sleep, or mask shards; a
    degraded call is noted for :func:`~repro_torch.serve.faults.
    last_degraded`).  A caller that ran the hook itself passes its mask as
    ``shard_ok`` with ``fault_hook=False`` -- the Engine does, once per
    micro-batch, as the reference's hook is skipped under its outer trace.
    """
    from repro_torch.ann.functional import prepare_queries

    plan = plan_for(state)
    mesh, axes = resolve_mesh(state, mesh)
    sizes = tuple(int(mesh.shape[a]) for a in axes)
    S = int(np.prod(sizes))
    k = int(k)

    mask = None
    if shard_ok is not None:
        mask = np.asarray(torch.as_tensor(shard_ok).cpu(), bool).reshape(-1)
        if mask.shape[0] != S:
            raise ShardingError(
                f"shard_ok has {mask.shape[0]} entries for {S} shards")
    if fault_hook:
        from repro_torch.serve import faults as _faults

        drop = _faults.shard_events(S)     # may raise ShardFault / sleep
        if drop is not None:
            mask = drop if mask is None else (mask & drop)
        if mask is not None and not mask.all():
            _faults.note_degraded(
                shard_coverage(state, mask),
                tuple(int(s) for s in np.flatnonzero(~mask)))
    carry_s = state.static.get("carry")
    carry = 2 * k if carry_s is None else max(k, int(carry_s))
    env = dict(state.static)
    env.update(env_extra or {})
    metric = state.metric
    shard_names = tuple(state.stat("shard_arrays"))
    rep = {nm: a for nm, a in state.arrays.items() if nm not in shard_names}
    dev = state["ids"].device
    Qp = prepare_queries(Q, metric, dev)
    if plan.prep is not None:
        rep.update(plan.prep(Qp, rep, env, metric))
    kn = dict(zip(plan.knob_names, knobs))

    outs = []
    for s in range(S):
        loc = {nm: state[nm][s] for nm in shard_names}
        vals, ids = plan.local_topk(Qp, kn, loc, rep, env, metric, carry)
        if mask is not None and not mask[s]:
            # a dead shard presents every candidate as the merge tree's
            # (+inf, -1) sentinel -- exactly a shard with zero valid rows,
            # so the fold stays exact over the survivors
            vals = torch.full_like(vals, float("inf"))
            ids = torch.full_like(ids, -1)
        outs.append((vals, ids))
    return tree_merge_topk(
        torch.stack([v for v, _ in outs]), torch.stack([i for _, i in outs]),
        axes=axes, axis_sizes=sizes, k=k, codec=state.stat("wire_codec"),
        carry=carry, fan_in=state.stat("fan_in"),
        exact_vals=bool(exact_vals))


# --------------------------------------------------------------- resharding
def reshard(state, *, mesh: Optional[Mesh] = None,
            shard_axes: Optional[Sequence[str]] = None,
            n_shards: Optional[int] = None):
    """Move a sharded state to a different mesh / shard count by exact
    unshard -> reshard round-trip (same ids, same wire settings)."""
    plan = plan_for(state)
    return shard_index(
        plan.unshard(state), mesh=mesh, shard_axes=shard_axes,
        n_shards=n_shards, wire_codec=state.stat("wire_codec"),
        fan_in=state.stat("fan_in"), carry=state.static.get("carry"))


def ensure_servable(state):
    """Make a (possibly foreign) checkpointed state servable here: states
    whose mesh recipe fits the logical devices pass through untouched;
    oversized recipes are resharded onto all of them."""
    _registered()
    if state.algo not in _BY_SHARDED:
        return state
    try:
        resolve_mesh(state, None)
        return state
    except ShardingError:
        return reshard(state, n_shards=device_count())

