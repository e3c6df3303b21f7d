"""Explicit collectives (``repro.dist.collectives``).

``tree_merge_topk`` is the sharded-ANN merge: each lane's local top-m
(distance, global id) candidates fold into the exact global top-k by a
log-depth butterfly over every mesh axis, the distances travelling in a
compressed wire format (:mod:`repro_torch.dist.wire`).

The fold is written once, against a small exchange interface
(``ppermute``, ``pmin``, ``pmax``, ``psum``, ``axis_index``), which has two
realisations:

  * :class:`Stacked` -- the port's stacked mesh (:mod:`repro_torch.dist.
    mesh`): every lane on one torch device, ``vals [S, b, m]``.
    ``ppermute`` gathers lanes by the permutation's sources, the ``p*``
    reductions run over the lanes of an axis, and every lane folds its
    own concatenation as each device does.  All lanes finish identical,
    so the merge returns lane 0.  ``sharded_search`` uses this one.
  * :class:`ProcessGroup` -- one lane per rank of a ``torch.distributed``
    group, ``vals [b, m]`` on each.  ``ppermute`` is a pair of
    ``batch_isend_irecv`` operations (the wire tensor's bytes, whatever
    its codec's type), ``pmin`` / ``pmax`` are ``all_reduce`` (over the
    group when the axis spans it, else a gather of the axis's lanes).
    ``psum`` gathers the lanes and adds them in lane order, as the stacked
    realisation does, so its rounding does not depend on a backend's
    reduction schedule.

``sharded_embed_lookup`` is the row-sharded embedding gather (stacked).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.dist import wire

_EMBED_AXIS = "model"


# ------------------------------------------------------------- exchanges
class Stacked:
    """Lanes stacked on dim 0 (``S = prod(sizes)``, row-major over
    ``axes``), all on one device."""

    def __init__(self, axes: Sequence[str], sizes: Sequence[int]):
        self.axes = tuple(axes)
        self.sizes = tuple(int(s) for s in sizes)

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.sizes + tuple(x.shape[1:]))

    def ppermute(self, x, axis: str, perm):
        pos = self.axes.index(axis)
        src = [0] * self.sizes[pos]
        for s, d in perm:
            src[d] = s
        idx = torch.tensor(src, dtype=torch.long, device=x.device)
        return self._grid(x).index_select(pos, idx).reshape(x.shape)

    def _reduce(self, x, axes, fn):
        g = self._grid(x)
        for axis in ((axes,) if isinstance(axes, str) else axes):
            g = fn(g, self.axes.index(axis)).expand(g.shape)
        return g.reshape(x.shape)

    def pmin(self, x, axes):
        return self._reduce(x, axes, lambda g, p: g.amin(p, keepdim=True))

    def pmax(self, x, axes):
        return self._reduce(x, axes, lambda g, p: g.amax(p, keepdim=True))

    def psum(self, x, axes):
        """The sum over the lanes of ``axes`` (one axis or several at
        once), added in lane order (row-major over ``axes``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axes.index(a) for a in axes]
        g = self._grid(x)
        lanes = torch.movedim(g, pos, list(range(len(pos))))
        lanes = lanes.reshape((-1,) + tuple(lanes.shape[len(pos):]))
        acc = lanes[0]
        for lane in lanes[1:]:
            acc = acc + lane
        for p in sorted(pos):
            acc = acc.unsqueeze(p)
        return acc.expand(g.shape).reshape(x.shape)

    def axis_index(self, axis: str) -> torch.Tensor:
        """[S] each lane's coordinate along ``axis``."""
        pos = self.axes.index(axis)
        coords = np.unravel_index(np.arange(math.prod(self.sizes)),
                                  self.sizes)[pos]
        return torch.as_tensor(coords, dtype=torch.int32)


class ProcessGroup:
    """One lane per rank of ``group`` (``None``: the default group); the
    ranks are numbered row-major over ``axes`` as stacked lanes are."""

    def __init__(self, axes: Sequence[str], sizes: Sequence[int],
                 group=None):
        import torch.distributed as dist

        self.dist = dist
        self.axes = tuple(axes)
        self.sizes = tuple(int(s) for s in sizes)
        self.group = group
        world, need = dist.get_world_size(group), math.prod(self.sizes)
        if need != world:
            raise ValueError(f"mesh {self.sizes} needs {need} ranks; the "
                             f"group has {world}")
        self.rank = dist.get_rank(group)
        self.coords = [int(c) for c in np.unravel_index(self.rank,
                                                        self.sizes)]

    def _peer(self, lane: int) -> int:
        if self.group is None or self.group is self.dist.group.WORLD:
            return lane
        return self.dist.get_global_rank(self.group, lane)

    def _lane(self, pos: int, coord: int) -> int:
        c = list(self.coords)
        c[pos] = coord
        return int(np.ravel_multi_index(c, self.sizes))

    def ppermute(self, x, axis: str, perm):
        dist = self.dist
        pos = self.axes.index(axis)
        me = self.coords[pos]
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.view(torch.uint8),
                          self._peer(self._lane(pos, d)), self.group)
               for d in dst]
        ops += [dist.P2POp(dist.irecv, out.view(torch.uint8),
                           self._peer(self._lane(pos, s)), self.group)
                for s in src]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def _slice_lanes(self, axes) -> list:
        """The ranks of my slice along ``axes``, in lane order."""
        pos = [self.axes.index(a) for a in axes]
        lanes = []
        for flat in range(math.prod(self.sizes[p] for p in pos)):
            c = list(self.coords)
            for p, v in zip(pos, np.unravel_index(
                    flat, [self.sizes[p] for p in pos])):
                c[p] = int(v)
            lanes.append(int(np.ravel_multi_index(c, self.sizes)))
        return lanes

    def _gather(self, x):
        parts = [torch.empty_like(x) for _ in range(math.prod(self.sizes))]
        self.dist.all_gather(parts, x.contiguous(), group=self.group)
        return parts

    def _minmax(self, x, axes, op, fn):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        lanes = self._slice_lanes(axes)
        if len(lanes) == math.prod(self.sizes):
            out = x.clone()
            self.dist.all_reduce(out, op=op, group=self.group)
            return out
        parts = self._gather(x)
        return fn(torch.stack([parts[i] for i in lanes]), 0)

    def pmin(self, x, axes):
        return self._minmax(x, axes, self.dist.ReduceOp.MIN,
                            lambda t, d: t.amin(d))

    def pmax(self, x, axes):
        return self._minmax(x, axes, self.dist.ReduceOp.MAX,
                            lambda t, d: t.amax(d))

    def psum(self, x, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        parts = self._gather(x)
        lanes = self._slice_lanes(axes)
        acc = parts[lanes[0]]
        for i in lanes[1:]:
            acc = acc + parts[i]
        return acc

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]


# ------------------------------------------------------ embedding lookup
def sharded_embed_lookup(emb, tokens, mesh=None, axis: str = _EMBED_AXIS):
    """emb [V, d] row-sharded over ``axis``; tokens int[...] -> [..., d].

    Each lane of the stacked mesh answers with a masked gather of its own
    rows, and a psum over ``axis`` combines the one non-zero contribution
    per token.  Falls back to a plain gather when there is no mesh, the
    axis is absent, or the vocab does not divide evenly across the axis.
    """
    tokens = torch.as_tensor(tokens, device=emb.device)
    if mesh is None or axis not in mesh.axis_names:
        return emb[tokens.long()]
    n_shards = mesh.shape[axis]
    V = emb.shape[0]
    if n_shards <= 1 or V % n_shards != 0:
        return emb[tokens.long()]
    ex = Stacked(mesh.axis_names, mesh.sizes)
    per = V // n_shards
    shard = ex.axis_index(axis).to(emb.device)                   # [S]
    local = emb.reshape(n_shards, per, -1)[shard.long()]         # [S, per, d]
    lead = (-1,) + (1,) * tokens.dim()
    rel = tokens.to(torch.int32)[None] - shard.reshape(lead) * per
    ok = (rel >= 0) & (rel < per)
    safe = torch.where(ok, rel, torch.zeros_like(rel)).long()
    lane = torch.arange(local.shape[0], device=emb.device).reshape(lead)
    out = torch.where(ok[..., None], local[lane, safe],
                      torch.zeros((), dtype=emb.dtype, device=emb.device))
    return ex.psum(out.to(emb.dtype), axis)[0]


# ------------------------------------------------- hierarchical top-k merge
def _butterfly_perm(S: int, stride: int, f: int, t: int):
    """ppermute pairs for butterfly round digit-shift ``t``: device p
    receives from the device whose base-``f`` digit at ``stride`` is
    ``(digit(p) + t) mod f``."""
    perm = []
    for p in range(S):
        d = (p // stride) % f
        base = p - d * stride
        perm.append((base + ((d + t) % f) * stride, p))
    return perm


def _axis_schedule(S: int, fan_in: int):
    """(rounds) for one mesh axis: a list of (stride, f) butterfly rounds.
    Power-of-fan_in sizes get the full log-depth ladder; anything else
    falls back to a single fan_in=S exchange round (still compressed)."""
    f = max(2, int(fan_in))
    rounds, s = [], 1
    n = S
    while n % f == 0:
        rounds.append((s, f))
        s *= f
        n //= f
    if n != 1:                      # ragged axis: one flat exchange round
        return [(1, S)]
    return rounds


def _fold(vals, ids, ex, *, axes, axis_sizes, k: int, codec: str,
          carry: Optional[int], fan_in: int, exact_vals: bool):
    """The merge on every lane of ``ex`` at once: ``vals`` / ``ids`` are
    each lane's local candidates ([..., b, m]), the result each lane's
    [..., b, k]."""
    from repro_torch.kernels.rerank_topk import (     # deferred: import cycle
        merge_topk_unique_rounds)

    wire.check_codec(codec)
    m = vals.shape[-1]
    carry = max(int(k), 2 * int(k) if carry is None else int(carry))
    inf = torch.tensor(float("inf"), device=vals.device)
    valid = ids >= 0
    vals = torch.where(valid, vals.to(torch.float32), inf)
    ids = torch.where(valid, ids.to(torch.int32),
                      torch.full_like(ids, -1, dtype=torch.int32))
    if m > carry:
        vals, ids = merge_topk_unique_rounds(vals, ids, carry)
    elif m < carry:
        vals = torch.nn.functional.pad(vals, (0, carry - m),
                                       value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, carry - m), value=-1)

    live_axes = [(ax, int(s)) for ax, s in zip(axes, axis_sizes) if s > 1]
    if not live_axes:                  # single shard: nothing to exchange
        return merge_topk_unique_rounds(vals, ids, int(k))
    lo = hi = None
    if wire.needs_scale(codec):
        finite = torch.isfinite(vals)
        lo = torch.where(finite, vals, inf).amin(-1, keepdim=True)
        hi = torch.where(finite, vals, -inf).amax(-1, keepdim=True)
        for ax, _ in live_axes:
            lo = ex.pmin(lo, ax)
            hi = ex.pmax(hi, ax)
    own_vals, own_ids = vals, ids          # f32, for the exact_vals root
    # snap local values into wire precision so every fold compares in the
    # same (idempotent) domain regardless of merge grouping
    vals = wire.decode(wire.encode(vals, codec, lo, hi), codec, lo, hi, ids)

    for ax, S in reversed(live_axes):
        for stride, f in _axis_schedule(S, fan_in):
            w = wire.encode(vals, codec, lo, hi)
            parts_v, parts_i = [vals], [ids]
            for t in range(1, f):
                perm = _butterfly_perm(S, stride, f, t)
                wt = ex.ppermute(w, ax, perm)
                it = ex.ppermute(ids, ax, perm)
                parts_v.append(wire.decode(wt, codec, lo, hi, it))
                parts_i.append(it)
            vals, ids = merge_topk_unique_rounds(
                torch.cat(parts_v, dim=-1), torch.cat(parts_i, dim=-1),
                carry)

    if exact_vals:
        # full-precision root tiebreak: each owner contributes its f32
        # value for any carried id it holds; one psum replicates them.
        # Every sum adds one non-zero value to zeros, so it is exact in
        # any order.
        match = (ids[..., :, None] == own_ids[..., None, :]) \
            & (own_ids[..., None, :] >= 0)
        safe = torch.where(torch.isfinite(own_vals), own_vals,
                           torch.zeros((), device=vals.device))
        contrib = torch.where(match, safe[..., None, :],
                              torch.zeros((), device=vals.device)).sum(-1)
        count = match.sum(-1).to(torch.float32)
        stacked = torch.stack([contrib, count], dim=-1)
        for ax, _ in live_axes:
            stacked = ex.psum(stacked, ax)
        vals = torch.where(stacked[..., 1] > 0, stacked[..., 0], inf)
        ids = torch.where(stacked[..., 1] > 0, ids, torch.full_like(ids, -1))
    return merge_topk_unique_rounds(vals, ids, int(k))


def tree_merge_topk(vals, ids, *, axes: Sequence[str],
                    axis_sizes: Sequence[int], k: int,
                    codec: str = "f32", carry: Optional[int] = None,
                    fan_in: int = 2, exact_vals: bool = False, group=None):
    """Global top-k merge: fold every lane's local candidates into the
    exact top-k.

    Stacked (``group=None``): ``vals [S, b, m]`` f32 distances / ``ids
    [S, b, m]`` int32 *global* ids of each lane's local candidates (id -1
    = invalid), ``S = prod(axis_sizes)`` lanes row-major over ``axes``;
    returns ``(vals [b, k], ids [b, k])``.  Process group (``group`` a
    ``torch.distributed`` group, or ``torch.distributed.group.WORLD``):
    this rank's ``vals [b, m]`` / ``ids [b, m]``; every rank returns the
    same ``[b, k]``.  Each global id must live on exactly one lane.

    The fold is a butterfly: per mesh axis (innermost first), ``log_f(S)``
    rounds of ``f - 1`` ``ppermute`` exchanges of ``carry`` compressed
    entries, each concatenated and re-folded with
    ``merge_topk_unique_rounds``.  Every lane finishes with the
    *identical* top-k (the fold is a selection under the (value, id)
    total order, so it is independent of arrival order).

    Exactness: distances are snapped to wire precision *before* the first
    fold, so the tree computes the exact top-``carry`` of the union under
    the wire total order.  A true top-k id can only be lost if more than
    ``carry - k`` smaller-id candidates share its exact wire bucket --
    ``carry`` (default 2k) is the tie budget.  The u16 codec (hamming's
    integer distances) is unconditionally exact.  Returned values are wire
    precision; ``exact_vals=True`` adds the full-precision root tiebreak:
    one psum re-scores the carried candidate set from the owners' f32
    values before the final k-selection.
    """
    if group is None:
        ex = Stacked(axes, axis_sizes)
        d, i = _fold(vals, ids, ex, axes=axes, axis_sizes=axis_sizes, k=k,
                     codec=codec, carry=carry, fan_in=fan_in,
                     exact_vals=exact_vals)
        return d[0], i[0]
    ex = ProcessGroup(axes, axis_sizes, group)
    return _fold(vals, ids, ex, axes=axes, axis_sizes=axis_sizes, k=k,
                 codec=codec, carry=carry, fan_in=fan_in,
                 exact_vals=exact_vals)
