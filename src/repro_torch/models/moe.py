"""Mixture-of-Experts layer (``repro.models.moe``): softmax router, top-k
routed experts + shared experts, SwiGLU expert MLPs.

Three execution paths, same parameters, picked by :func:`moe` as the
reference picks them:

  * ``gather`` (T * top_k <= 8192, decode): each token gathers its k
    experts' weights.
  * ``local``: dropless; tokens sorted by expert (a stable sort), one
    product per expert over its contiguous group (the reference's
    ``ragged_dot``), unsorted by a sum in a fixed order.
  * ``ep``: fixed-capacity expert parallelism over the ``"model"`` axis of
    a stacked mesh (:mod:`repro_torch.dist.mesh`).  Each token block is a
    lane; the reference's ``all_to_all`` is an exchange of the
    ``[ep, e_local, cap, d]`` bucket blocks among the lanes of that axis,
    and the capacity drops are the reference's.

Sums over a token's experts run in a fixed order (no ``index_add_``,
whose float atomics on CUDA add in any order).
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense, dense_specs, fp32_accumulation,
                                       init_dense, init_mlp, mlp, mlp_specs,
                                       silu, trunc_normal)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_scale: bool = False       # normalise top-k gates to sum 1
    path: str = "local"              # "local" | "ep"


def init_moe(gen, cfg: MoEConfig, dtype):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    scale = d ** -0.5
    p = {
        "router": init_dense(gen, d, E, torch.float32),
        "w_gate": trunc_normal(gen, (E, d, f), scale, dtype),
        "w_up": trunc_normal(gen, (E, d, f), scale, dtype),
        "w_down": trunc_normal(gen, (E, f, d), f ** -0.5, dtype),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, d, f * cfg.n_shared, dtype)
    return p


def moe_specs(cfg: MoEConfig):
    s = {
        "router": dense_specs("fsdp", None),
        "w_gate": ("expert", "fsdp", None),
        "w_up": ("expert", "fsdp", None),
        "w_down": ("expert", None, "fsdp"),
    }
    if cfg.n_shared:
        s["shared"] = mlp_specs()
    return s


def _route(params, cfg: MoEConfig, x):
    """x [T, d] -> (gates [T,k], experts [T,k] int32, aux_loss).  The top
    k by a stable descending sort: ties go to the lower expert index, as
    ``jax.lax.top_k`` gives them."""
    logits = dense(params["router"], x.to(torch.float32))      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = ranked[:, :cfg.top_k], order[:, :cfg.top_k]
    if cfg.router_scale:
        gates = gates / torch.clamp(
            torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    # Switch load-balance loss: E * sum_e f_e * P_e
    E = cfg.n_experts
    onehot = F.one_hot(experts[:, 0], E).to(torch.float32)    # top-1 share
    f_e = torch.mean(onehot, dim=0)
    p_e = torch.mean(probs, dim=0)
    aux = E * torch.sum(f_e * p_e)
    return gates.to(x.dtype), experts.to(torch.int32), aux


def _segment_sum(contrib, seg, num_segments: int, per: int):
    """``jax.ops.segment_sum(contrib, seg, num_segments)`` where every
    segment holds ``per`` rows: each segment's rows added to zero one at a
    time, in the order the rows come."""
    rows = torch.sort(seg, stable=True).indices.reshape(num_segments, per)
    out = torch.zeros((num_segments,) + tuple(contrib.shape[1:]),
                      dtype=contrib.dtype, device=contrib.device)
    for j in range(per):
        out = out + contrib[rows[:, j]]
    return out


def _ragged_dot(x, w, sizes):
    """``jax.lax.ragged_dot``: rows of ``x`` in contiguous groups of
    ``sizes``, group g times ``w[g]``."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    start = 0
    for g, n in enumerate(sizes):
        if n:
            torch.matmul(x[start:start + n], w[g],
                         out=out[start:start + n])
        start += n
    return out


def _experts_local(params, cfg: MoEConfig, x, gates, experts):
    """Dropless sort + one product per expert group."""
    T, d = x.shape
    k, E = cfg.top_k, cfg.n_experts
    flat_e = experts.reshape(-1)                                # [T*k]
    flat_t = torch.arange(T, dtype=torch.int32,
                          device=x.device).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    tok_sorted = flat_t[order]
    xin = x[tok_sorted.long()]                                  # [T*k, d]
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    h = silu(_ragged_dot(xin, params["w_gate"], sizes)) \
        * _ragged_dot(xin, params["w_up"], sizes)
    out_sorted = _ragged_dot(h, params["w_down"], sizes)
    gate_sorted = gates.reshape(-1)[order]
    contrib = out_sorted * gate_sorted[:, None].to(out_sorted.dtype)
    return _segment_sum(contrib, tok_sorted, T, k)


def _experts_ep(params, cfg: MoEConfig, x, gates, experts, mesh):
    """Fixed-capacity expert parallelism over the 'model' axis of a
    stacked mesh.

    Tokens are split over (pod, data, model) jointly, the first axis
    outermost, as the reference's token spec splits them; a lane that
    differs from another only on an axis outside those holds the same
    tokens and computes the same answer, so each token block runs once.
    """
    ep = mesh.shape["model"]
    E = cfg.n_experts
    assert E % ep == 0, (E, ep)
    e_local = E // ep
    k = cfg.top_k
    n_blocks = math.prod(mesh.shape[a] for a in ("pod", "data", "model")
                         if a in mesh.axis_names)
    T, d = x.shape
    Tl = T // n_blocks
    cap = max(8, int(cfg.capacity_factor * Tl * k / E))

    # dispatch: each block's [E, cap, d] buckets, as [ep, e_local, cap, d]
    plans, send = [], []
    for b in range(n_blocks):
        xs = x[b * Tl:(b + 1) * Tl]
        flat_e = experts[b * Tl:(b + 1) * Tl].reshape(-1).long()
        flat_t = torch.arange(Tl, device=x.device).repeat_interleave(k)
        flat_g = gates[b * Tl:(b + 1) * Tl].reshape(-1)
        # position of each (token, expert) pair within its expert bucket
        onehot = F.one_hot(flat_e, E)                           # [Tl*k, E]
        pos = torch.cumsum(onehot, dim=0) - 1
        pos = torch.sum(pos * onehot, dim=1)                    # [Tl*k]
        keep = pos < cap
        slot = flat_e * cap + torch.where(keep, pos, cap)       # drop -> OOB
        buckets = torch.zeros((E * cap, d), dtype=xs.dtype, device=x.device)
        buckets[slot[keep]] = xs[flat_t[keep]]                  # unique slots
        send.append(buckets.reshape(ep, e_local, cap, d))
        plans.append((slot, keep, flat_t, flat_g))
    n_outer = n_blocks // ep
    send = torch.stack(send).reshape(n_outer, ep, ep, e_local, cap, d)
    # all_to_all over "model": lane m receives block m of every peer j
    recv = send.transpose(1, 2)
    outs = []
    for o, m in itertools.product(range(n_outer), range(ep)):
        r = recv[o, m].transpose(0, 1).reshape(e_local, ep * cap, d)
        lo, hi = m * e_local, (m + 1) * e_local
        h = torch.bmm(r, params["w_gate"][lo:hi])
        h = silu(h) * torch.bmm(r, params["w_up"][lo:hi])
        out = torch.bmm(h, params["w_down"][lo:hi])             # [e_l,ep*cap,d]
        outs.append(out.reshape(e_local, ep, cap, d).transpose(0, 1))
    back = torch.stack(outs).reshape(n_outer, ep, ep, e_local, cap, d) \
        .transpose(1, 2)
    # combine: each block gathers its pairs' rows back
    routed = []
    for b, (slot, keep, flat_t, flat_g) in enumerate(plans):
        rows = back[b // ep, b % ep].reshape(E * cap, d)
        gathered = rows[torch.clamp(slot, max=E * cap - 1)]
        gathered = torch.where(keep[:, None], gathered,
                               torch.zeros((), dtype=gathered.dtype,
                                           device=x.device))
        contrib = gathered * flat_g[:, None].to(gathered.dtype)
        routed.append(_segment_sum(contrib, flat_t, Tl, k))
    return torch.cat(routed)


def _experts_gather(params, cfg: MoEConfig, x, gates, experts):
    """Low-batch decode path: gather the k selected experts' weights per
    token (what serving systems do when tokens << experts x capacity)."""
    e = experts.long()
    wg = params["w_gate"][e]                  # [T, k, d, f]
    wu = params["w_up"][e]
    wd = params["w_down"][e]                  # [T, k, f, d]
    xr = x[:, None, None, :]                  # td,tkdf->tkf
    h = silu(torch.matmul(xr, wg)[:, :, 0]) * torch.matmul(xr, wu)[:, :, 0]
    out = torch.matmul(h[:, :, None, :], wd)[:, :, 0]          # tkf,tkfd->tkd
    return torch.sum(out * gates[..., None].to(out.dtype), dim=1)


@fp32_accumulation()
def moe(params, cfg: MoEConfig, x, *, mesh=None):
    """x [B, S, d] -> (out [B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gates, experts, aux = _route(params, cfg, xt)
    n_shards = 1
    if mesh is not None:
        for a in ("pod", "data", "model"):
            if a in mesh.axis_names:
                n_shards *= mesh.shape[a]
    if T * cfg.top_k <= 8192:
        routed = _experts_gather(params, cfg, xt, gates, experts)
    elif (cfg.path == "ep" and mesh is not None
          and "model" in mesh.axis_names and mesh.shape["model"] > 1
          and T % max(n_shards, 1) == 0):
        routed = _experts_ep(params, cfg, xt, gates, experts, mesh)
    else:
        routed = _experts_local(params, cfg, xt, gates, experts)
    out = routed
    if cfg.n_shared:
        out = out + mlp(params["shared"], xt, mesh=mesh)
    return out.reshape(B, S, d), aux
