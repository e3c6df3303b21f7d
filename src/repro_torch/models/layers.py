"""Shared model layers (``repro.models.layers``), functional and
dict-param style.

Every layer is a pair (init_xxx, xxx); params are plain dicts of tensors;
logical sharding axes for each parameter come from the matching
``xxx_specs`` helper and resolve against a mesh in
:mod:`repro_torch.dist.sharding`.

Each function copies the reference's expression tree: the casts to fp32
and back, the ``-1e30`` masks, the score scale after the dot in decode
(before the exponent in flash).  An ``init_xxx`` takes a
``torch.Generator`` in place of a JAX key and draws on its device; the
draws are the port's own (the reference's weights carry across through
``repro_torch.convert.lm_params_from_reference``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.dist.sharding import constrain


@contextlib.contextmanager
def fp32_accumulation():
    """bf16 products accumulate in fp32, as the reference's do: cuBLAS
    may otherwise reduce split-K partial sums in bf16 (torch's default
    ``allow_bf16_reduced_precision_reduction``).  The setting is restored
    on exit; the LM entry points run under it (also as a decorator)."""
    m = torch.backends.cuda.matmul
    prev = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = prev


def trunc_normal(gen: torch.Generator, shape, scale, dtype):
    """N(0, 1) truncated to [-2, 2] in fp32, times ``scale``, cast to
    ``dtype``; drawn on ``gen``'s device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x), each op in x's dtype."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------- rmsnorm
def init_rmsnorm(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].to(torch.float32)).to(x.dtype)


def rmsnorm_specs():
    return {"scale": (None,)}


# ------------------------------------------------------------------ dense
def init_dense(gen, d_in, d_out, dtype, bias=False, scale=None):
    scale = scale if scale is not None else (d_in ** -0.5)
    p = {"w": trunc_normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(params, x):
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def dense_specs(in_axis=None, out_axis=None, bias=False):
    s = {"w": (in_axis, out_axis)}
    if bias:
        s["b"] = (out_axis,)
    return s


# ------------------------------------------------------------------- rope
def rope_cache(positions: torch.Tensor, dim: int, theta: float):
    """positions [*] -> (cos, sin) [*, dim/2] fp32."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, H, dim]; cos/sin [S, dim/2] (broadcast over heads)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    cos = cos[:, None, :]              # [S, d/2] -> [S, 1(heads), d/2]
    sin = sin[:, None, :]
    while cos.dim() < x1.dim():        # prepend batch dims -> [1, S, 1, d/2]
        cos = cos[None]
        sin = sin[None]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------- GQA attention
@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    softcap: float = 0.0
    qk_norm: bool = False
    flash_block_q: int = 512
    flash_block_k: int = 1024
    flash_block_skip: bool = False


def init_attention(gen, cfg: AttnConfig, dtype):
    H, KV, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    p = {
        "wq": init_dense(gen, d, H * dh, dtype, cfg.qkv_bias),
        "wk": init_dense(gen, d, KV * dh, dtype, cfg.qkv_bias),
        "wv": init_dense(gen, d, KV * dh, dtype, cfg.qkv_bias),
        "wo": init_dense(gen, H * dh, d, dtype,
                         scale=(H * dh) ** -0.5),
    }
    if cfg.qk_norm:
        p["qnorm"] = init_rmsnorm(dh, dtype, gen.device)
        p["knorm"] = init_rmsnorm(dh, dtype, gen.device)
    return p


def attention_specs(cfg: AttnConfig):
    s = {
        "wq": dense_specs("fsdp", "heads", cfg.qkv_bias),
        "wk": dense_specs("fsdp", "heads", cfg.qkv_bias),
        "wv": dense_specs("fsdp", "heads", cfg.qkv_bias),
        "wo": dense_specs("heads", "fsdp"),
    }
    if cfg.qk_norm:
        s["qnorm"] = rmsnorm_specs()
        s["knorm"] = rmsnorm_specs()
    return s


def _attn_mask(q_pos, k_pos, window: Optional[int]):
    """Causal (+ optional sliding window) mask [Sq, Sk] bool (True=keep)."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        causal &= k_pos[None, :] > q_pos[:, None] - window
    return causal


def attention(params, cfg: AttnConfig, x, positions, *, window=None,
              mesh=None, kv_cache=None, cache_len=None):
    """x [B,S,d].  Training/prefill when kv_cache is None; decode otherwise.

    kv_cache: (k [B,W,KV,dh], v [B,W,KV,dh]) ring/linear buffer with
    cache_len valid entries; returns (out, new_cache).  Decode writes the
    new slot into the given cache tensors in place (the reference's
    donated ``dynamic_update_slice``) and returns them.
    """
    B, S, d = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(params["wq"], x).reshape(B, S, H, dh)
    k = dense(params["wk"], x).reshape(B, S, KV, dh)
    v = dense(params["wv"], x).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q)
        k = rmsnorm(params["knorm"], k)
    cos, sin = rope_cache(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = constrain(q, mesh, "batch", None, "heads", None)
    k = constrain(k, mesh, "batch", None, "kv_heads", None)

    g = H // KV
    if kv_cache is not None:
        # Ring-buffer cache: W == sliding window for local layers, W ==
        # max_seq for global layers.  RoPE is applied at write time, so
        # slots only need a validity mask, not re-positioning.
        ck, cv = kv_cache
        W = ck.shape[1]
        assert S == 1, "decode step handles one token"
        cache_len = int(cache_len)
        slot = cache_len % W
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        slot_ids = torch.arange(W, device=x.device)
        # last position written to slot s: t - ((t - s) mod W); < 0 => empty
        k_pos = cache_len - ((cache_len - slot_ids) % W)
        mask = (k_pos >= 0)[None, :]                  # [Sq=1, W]
        qg = q.reshape(B, S, KV, g, dh)
        scores = torch.einsum("bsKgh,btKh->bKgst", qg.to(torch.float32),
                              ck.to(torch.float32)) / (dh ** 0.5)
        if cfg.softcap > 0:
            scores = cfg.softcap * torch.tanh(scores / cfg.softcap)
        scores = scores.masked_fill(~mask[None, None, None, :, :], -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bKgst,btKh->bsKgh", probs, cv)
        new_cache = (ck, cv)
    else:
        # prefill / training: blocked flash attention (O(S) memory)
        from repro_torch.models.flash import flash_attention

        qg = q.reshape(B, S, KV, g, dh)
        ctx = flash_attention(qg, k, v, positions, positions, causal=True,
                              window=window, softcap=cfg.softcap,
                              bq=cfg.flash_block_q, bk=cfg.flash_block_k,
                              block_skip=cfg.flash_block_skip)
        # expose (k, v) so prefill can collect the cache
        new_cache = (k, v)
    ctx = ctx.reshape(B, S, H * dh)
    out = dense(params["wo"], ctx)
    out = constrain(out, mesh, "batch", None, "embed")
    return out, new_cache


# ------------------------------------------------------------- SwiGLU MLP
def init_mlp(gen, d_model, d_ff, dtype):
    return {
        "gate": init_dense(gen, d_model, d_ff, dtype),
        "up": init_dense(gen, d_model, d_ff, dtype),
        "down": init_dense(gen, d_ff, d_model, dtype,
                           scale=d_ff ** -0.5),
    }


def mlp_specs():
    return {"gate": dense_specs("fsdp", "mlp"),
            "up": dense_specs("fsdp", "mlp"),
            "down": dense_specs("mlp", "fsdp")}


def mlp(params, x, mesh=None):
    mid = (None,) * (x.dim() - 2)      # rank-2 [T,d] or rank-3 [B,S,d]
    h = silu(dense(params["gate"], x)) * dense(params["up"], x)
    h = constrain(h, mesh, "batch", *mid, "mlp")
    out = dense(params["down"], h)
    return constrain(out, mesh, "batch", *mid, "embed")


# --------------------------------------------------------------- MLA attn
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int          # 0 = dense q projection
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_head: int
    rope_theta: float = 10_000.0
    flash_block_q: int = 512
    flash_block_k: int = 1024
    flash_block_skip: bool = False


def init_mla(gen, cfg: MLAConfig, dtype):
    H = cfg.n_heads
    p = {}
    if cfg.q_lora:
        p["q_down"] = init_dense(gen, cfg.d_model, cfg.q_lora, dtype)
        p["q_norm"] = init_rmsnorm(cfg.q_lora, dtype, gen.device)
        p["q_up"] = init_dense(gen, cfg.q_lora,
                               H * (cfg.qk_nope + cfg.qk_rope), dtype)
    else:
        p["q_proj"] = init_dense(gen, cfg.d_model,
                                 H * (cfg.qk_nope + cfg.qk_rope), dtype)
    p["kv_down"] = init_dense(gen, cfg.d_model,
                              cfg.kv_lora + cfg.qk_rope, dtype)
    p["kv_norm"] = init_rmsnorm(cfg.kv_lora, dtype, gen.device)
    p["k_up"] = init_dense(gen, cfg.kv_lora, H * cfg.qk_nope, dtype)
    p["v_up"] = init_dense(gen, cfg.kv_lora, H * cfg.v_head, dtype)
    p["wo"] = init_dense(gen, H * cfg.v_head, cfg.d_model, dtype,
                         scale=(H * cfg.v_head) ** -0.5)
    return p


def mla_specs(cfg: MLAConfig):
    s = {
        "kv_down": dense_specs("fsdp", None),
        "kv_norm": rmsnorm_specs(),
        "k_up": dense_specs("fsdp", "heads"),
        "v_up": dense_specs("fsdp", "heads"),
        "wo": dense_specs("heads", "fsdp"),
    }
    if cfg.q_lora:
        s["q_down"] = dense_specs("fsdp", None)
        s["q_norm"] = rmsnorm_specs()
        s["q_up"] = dense_specs("fsdp", "heads")
    else:
        s["q_proj"] = dense_specs("fsdp", "heads")
    return s


def mla_attention(params, cfg: MLAConfig, x, positions, *, mesh=None,
                  latent_cache=None, cache_len=None):
    """DeepSeek-V2 multi-head latent attention.

    Training/prefill: decompressed form (standard MHA over recovered K/V).
    Decode (latent_cache [B, S, kv_lora] / [B, S, qk_rope]): *absorbed*
    form, the cache stays compressed; q_nope is absorbed through k_up so
    scores are taken directly against the latent.  Decode writes slot
    ``cache_len`` of the given cache tensors in place, clamped to the last
    slot as ``dynamic_update_slice`` clamps its start.
    """
    B, S, d = x.shape
    H = cfg.n_heads
    if cfg.q_lora:
        q = dense(params["q_up"],
                  rmsnorm(params["q_norm"], dense(params["q_down"], x)))
    else:
        q = dense(params["q_proj"], x)
    q = q.reshape(B, S, H, cfg.qk_nope + cfg.qk_rope)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope, cfg.qk_rope], dim=-1)
    cos, sin = rope_cache(positions, cfg.qk_rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    ckv = dense(params["kv_down"], x)                      # [B,S,kv+rope]
    c_kv, k_rope = torch.split(ckv, [cfg.kv_lora, cfg.qk_rope], dim=-1)
    c_kv = rmsnorm(params["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    if latent_cache is None:
        # decompressed training path via blocked flash attention: fold the
        # shared rope key into per-head keys, concat [nope|rope] per head.
        from repro_torch.models.flash import flash_attention

        k_nope = dense(params["k_up"], c_kv).reshape(B, S, H, cfg.qk_nope)
        v = dense(params["v_up"], c_kv).reshape(B, S, H, cfg.v_head)
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope)],
            dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        ctx = flash_attention(
            q_full[:, :, :, None, :],          # KV=H heads, G=1
            k_full, v, positions, positions, causal=True,
            bq=cfg.flash_block_q, bk=cfg.flash_block_k,
            block_skip=cfg.flash_block_skip)
        ctx = ctx[:, :, :, 0, :]
        out = dense(params["wo"], ctx.reshape(B, S, H * cfg.v_head))
        # expose the latent cache for prefill collection
        return constrain(out, mesh, "batch", None, "embed"), (c_kv, k_rope)

    # ---------------- absorbed decode path ----------------
    assert S == 1
    cache, crope = latent_cache                            # [B,W,kv],[B,W,rope]
    W = cache.shape[1]
    cache_len = int(cache_len)
    at = min(max(cache_len, 0), W - 1)
    cache[:, at] = c_kv[:, 0]
    crope[:, at] = k_rope[:, 0]
    # absorb: q_eff[h] = q_nope[h] @ k_up[:, h]^T  -> latent space
    k_up = params["k_up"]["w"].reshape(cfg.kv_lora, H, cfg.qk_nope)
    q_eff = torch.einsum("bshn,lhn->bshl", q_nope.to(torch.float32),
                         k_up.to(torch.float32))           # [B,1,H,kv_lora]
    scale = (cfg.qk_nope + cfg.qk_rope) ** -0.5
    scores = (torch.einsum("bshl,btl->bhst", q_eff,
                           cache.to(torch.float32))
              + torch.einsum("bshr,btr->bhst", q_rope.to(torch.float32),
                             crope.to(torch.float32))) * scale
    valid = torch.arange(W, device=x.device)[None, :] <= cache_len
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx_latent = torch.einsum("bhst,btl->bshl", probs,
                              cache.to(torch.float32))     # [B,1,H,kv_lora]
    v_up = params["v_up"]["w"].reshape(cfg.kv_lora, H, cfg.v_head)
    ctx = torch.einsum("bshl,lhv->bshv", ctx_latent,
                       v_up.to(torch.float32)).to(x.dtype)
    out = dense(params["wo"], ctx.reshape(B, S, H * cfg.v_head))
    return (constrain(out, mesh, "batch", None, "embed"),
            (cache, crope))


# ------------------------------------------------------------------- loss
def cross_entropy(logits, labels, *, ignore_index: int = -100):
    """Mean CE over valid positions; logits [..., V], labels [...] int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    valid = labels != ignore_index
    return torch.sum(torch.where(valid, nll, 0.0)) / torch.clamp(
        torch.sum(valid), min=1)
