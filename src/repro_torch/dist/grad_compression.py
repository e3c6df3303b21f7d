"""Error-feedback gradient compression, the training wire codec
(``repro.dist.grad_compression``).

Each step quantises ``g + error`` to a per-tensor int8 grid, all-means the
compressed tensors across the mesh, and carries the quantisation residual
into the next step.  Non-finite entries carry no signal and are zeroed
before quantisation, so over the sanitised gradient stream no signal is
lost: ``sum(dequantised outputs) + residual == sum(sanitised gradients)``.

One guard the reference lacks: its scale ``maxabs / 127`` goes subnormal
for a tensor whose largest entry is below ``127 * tiny`` (tiny: float32's
smallest normal), and where subnormals are flushed to zero the divide by
it gives NaN.  The port's scale is never below ``tiny``; above it the two
agree bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

_TINY = torch.finfo(torch.float32).tiny
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def _tree_map(fn, *trees):
    """``fn`` over the leaves of matching dicts / lists / tuples."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def init_error_state(grads):
    """Zero residual tree matching ``grads``."""
    return _tree_map(lambda g: torch.zeros(torch.as_tensor(g).shape,
                                           dtype=torch.float32,
                                           device=torch.as_tensor(g).device),
                     grads)


def _sanitize(x):
    """Zero out NaN/inf entries -- they carry no signal and would
    otherwise poison the error-feedback residual permanently."""
    return torch.where(torch.isfinite(x), x, torch.zeros((), device=x.device))


def _int8_grid(x):
    """(grid steps q, scale) of the per-tensor int8 grid: x ~ q * scale."""
    x = _sanitize(torch.as_tensor(x).to(torch.float32))
    maxabs = x.abs().max()
    # all-zero (or fully non-finite) tensor: any positive scale maps it to
    # exact zeros -- 1.0; a scale under float32's smallest normal would be
    # subnormal (see the module docstring): it is raised to it
    # maxabs / 127 as the reference's traced program computes it: XLA
    # multiplies by the float32 reciprocal of the constant
    scale = torch.where(maxabs > 0.0,
                        torch.clamp_min(maxabs * _INV127, _TINY),
                        torch.ones((), device=x.device))
    return torch.round(x / scale), scale


def _quantize_int8(x):
    q, scale = _int8_grid(x)
    return q * scale


def _residual(u, q, scale):
    """``u - q * scale`` rounded once, as the reference's traced program
    computes it (XLA fuses the multiply-add); ``q * scale`` (|q| <= 127)
    is exact in float64."""
    return (u.to(torch.float64) - q.to(torch.float64)
            * scale.to(torch.float64)).to(torch.float32)


def compress_gradients(grads, err_state, *, mesh=None,
                       axes: Optional[Sequence[str]] = None, group=None):
    """(compressed-and-reduced grads, new error state).

    Without a mesh this is pure local quantisation with error feedback.
    With a stacked ``mesh`` (:class:`repro_torch.dist.mesh.Mesh`) of more
    than one logical device, the replicated quantised tensors are
    all-meaned over ``axes`` (default: every mesh axis) as the reference's
    ``psum(...) / size`` does: the sum of ``size`` copies, added in lane
    order, over ``size``.  With ``group`` (a ``torch.distributed`` group)
    each rank holds one copy and the group is the mesh: the copies are
    gathered and added in rank order, then divided by the group's size.
    """
    from repro_torch.dist.collectives import ProcessGroup, Stacked

    upd = _tree_map(lambda g, e: _sanitize(torch.as_tensor(g)
                                           .to(torch.float32)) + e,
                    grads, err_state)
    qs = _tree_map(_int8_grid, upd)
    comp = _tree_map(lambda u, qs: qs[0] * qs[1], upd, qs)
    new_err = _tree_map(lambda u, qs: _residual(u, *qs), upd, qs)
    if group is not None:
        import torch.distributed as dist

        size = dist.get_world_size(group)
        if size > 1:
            ex = ProcessGroup(("ranks",), (size,), group)
            comp = _tree_map(lambda x: ex.psum(x, "ranks") / size, comp)
    elif mesh is not None and mesh.size > 1:
        red_axes = tuple(axes) if axes is not None else tuple(mesh.axis_names)
        size = math.prod(mesh.shape[a] for a in red_axes)
        ex = Stacked(mesh.axis_names, mesh.sizes)

        def allmean(x):
            lanes = x[None].expand((mesh.size,) + tuple(x.shape))
            return ex.psum(lanes, red_axes)[0] / size

        comp = _tree_map(allmean, comp)
    return comp, new_err
