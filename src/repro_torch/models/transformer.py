"""Decoder-only transformer LM (``repro.models.transformer``), the
inference half, covering the five LM architectures: dense GQA (phi4,
qwen), local/global sliding-window GQA (gemma3), and MLA + MoE
(deepseek-v2, moonshot/moonlight).

Structure: layers are grouped into maximal *runs* of identical
(attention-kind, moe-ness) signature; each run's parameters are stacked
on a leading axis, as the reference stacks them for ``lax.scan``, and the
port runs each stacked run as a loop over its layers.  gemma3's
5-local:1-global pattern yields runs [5L,1G]x10+[2L]; deepseek's
first-dense-then-moe yields [1 dense][59 moe].

Steps:
    init(rng, cfg, device)                   -> params
    forward(params, cfg, tokens, mesh)       -> (hidden, aux_loss)
    prefill_step(params, cfg, tokens, mesh)  -> last logits, decode caches
    init_cache(cfg, batch, max_seq, device)  -> decode cache tree
    serve_step(params, cfg, token, cache, cache_len, mesh) -> logits, cache

``init`` and ``init_cache`` run on ``cuda`` unless the caller asks for
another device; the steps follow the device of ``params`` and run under
``layers.fp32_accumulation`` (bf16 products accumulate in fp32).  The training
steps (``chunked_lm_loss``, ``loss_fn``, ``make_train_step``) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.dist.collectives import sharded_embed_lookup
from repro_torch.dist.sharding import constrain, is_axes_leaf
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, init_moe, moe, moe_specs


@dataclasses.dataclass(frozen=True)
class MLAParams:
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_head: int


@dataclasses.dataclass(frozen=True)
class MoEParams:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_k_dense: int = 0
    aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    softcap: float = 0.0
    window: Optional[int] = None             # sliding window for local layers
    pattern: Tuple[str, ...] = ("global",)   # periodic, e.g. ("local",)*5+("global",)
    attn: str = "gqa"                        # "gqa" | "mla"
    mla: Optional[MLAParams] = None
    moe_cfg: Optional[MoEParams] = None
    embed_scale: bool = False                # gemma multiplies by sqrt(d)
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    remat: bool = True                       # no effect without gradients
    loss_chunk: int = 2048
    moe_path: str = "local"                  # "local" | "ep"
    flash_block_q: int = 512
    flash_block_k: int = 1024
    flash_block_skip: bool = False
    seq_shard: bool = False

    def layer_signature(self, i: int):
        kind = self.pattern[i % len(self.pattern)]
        is_moe = (self.moe_cfg is not None
                  and i >= self.moe_cfg.first_k_dense)
        return (kind, is_moe)

    def runs(self) -> Sequence[Tuple[Tuple[str, bool], int]]:
        """[(signature, n_layers_in_run), ...] in layer order."""
        out = []
        for i in range(self.n_layers):
            sig = self.layer_signature(i)
            if out and out[-1][0] == sig:
                out[-1] = (sig, out[-1][1] + 1)
            else:
                out.append((sig, 1))
        return out

    def attn_config(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            softcap=self.softcap, flash_block_q=self.flash_block_q,
            flash_block_k=self.flash_block_k,
            flash_block_skip=self.flash_block_skip)

    def mla_config(self) -> L.MLAConfig:
        assert self.mla is not None
        return L.MLAConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            q_lora=self.mla.q_lora, kv_lora=self.mla.kv_lora,
            qk_nope=self.mla.qk_nope, qk_rope=self.mla.qk_rope,
            v_head=self.mla.v_head, rope_theta=self.rope_theta,
            flash_block_q=self.flash_block_q,
            flash_block_k=self.flash_block_k,
            flash_block_skip=self.flash_block_skip)

    def moe_config(self) -> MoEConfig:
        assert self.moe_cfg is not None
        return MoEConfig(
            d_model=self.d_model, n_experts=self.moe_cfg.n_experts,
            top_k=self.moe_cfg.top_k, d_ff_expert=self.moe_cfg.d_ff_expert,
            n_shared=self.moe_cfg.n_shared, path=self.moe_path)


# ------------------------------------------------------------------- trees
def _map_leaves(fn, *trees):
    """Apply ``fn`` leaf-wise over trees of dicts / lists / tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map_leaves(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _layer(run_params, i: int):
    """Layer ``i`` of a stacked run (views, no copy)."""
    return _map_leaves(lambda t: t[i], run_params)


# ------------------------------------------------------------------ params
def _init_layer(gen, cfg: LMConfig, is_moe: bool):
    p = {"ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
         "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device)}
    if cfg.attn == "mla":
        p["attn"] = L.init_mla(gen, cfg.mla_config(), cfg.dtype)
    else:
        p["attn"] = L.init_attention(gen, cfg.attn_config(), cfg.dtype)
    if is_moe:
        p["moe"] = init_moe(gen, cfg.moe_config(), cfg.dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    return p


def init(rng, cfg: LMConfig, device=None):
    """Random weights drawn on ``device`` (``cuda`` unless asked) from a
    ``torch.Generator`` seeded with the int ``rng``; the reference's tree
    of shapes and dtypes."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(rng))
    params = {"embed": L.trunc_normal(gen, (cfg.vocab, cfg.d_model), 1.0,
                                      cfg.dtype),
              "final_ln": L.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
              "runs": []}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(gen, cfg.d_model, cfg.vocab,
                                         cfg.dtype)
    for sig, n in cfg.runs():
        stacked = [_init_layer(gen, cfg, sig[1]) for _ in range(n)]
        params["runs"].append(
            _map_leaves(lambda *xs: torch.stack(xs), *stacked))
        del stacked
    return params


def param_specs(cfg: LMConfig):
    """Tree of logical-axis tuples mirroring init()'s output."""
    def layer_spec(is_moe):
        s = {"ln1": L.rmsnorm_specs(), "ln2": L.rmsnorm_specs()}
        if cfg.attn == "mla":
            s["attn"] = L.mla_specs(cfg.mla_config())
        else:
            s["attn"] = L.attention_specs(cfg.attn_config())
        if is_moe:
            s["moe"] = moe_specs(cfg.moe_config())
        else:
            s["mlp"] = L.mlp_specs()
        # prepend the stacked layer axis
        return _prepend_stack(s)

    specs = {"embed": ("vocab", "fsdp"),
             "final_ln": L.rmsnorm_specs(),
             "runs": [layer_spec(sig[1]) for sig, _ in cfg.runs()]}
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.dense_specs("fsdp", "vocab")
    return specs


def _prepend_stack(s):
    if is_axes_leaf(s):
        return ("stack",) + tuple(s)
    return {k: _prepend_stack(v) for k, v in s.items()}


# ----------------------------------------------------------------- forward
def _block(cfg: LMConfig, sig, layer_params, x, positions, mesh,
           cache=None, cache_len=None):
    kind, is_moe = sig
    window = cfg.window if kind == "local" else None
    if cfg.seq_shard and cache is None:
        x = constrain(x, mesh, "batch", "seq_model", "embed")
    h = L.rmsnorm(layer_params["ln1"], x)
    if cfg.attn == "mla":
        h, new_cache = L.mla_attention(
            layer_params["attn"], cfg.mla_config(), h, positions, mesh=mesh,
            latent_cache=cache, cache_len=cache_len)
    else:
        h, new_cache = L.attention(
            layer_params["attn"], cfg.attn_config(), h, positions,
            window=window, mesh=mesh, kv_cache=cache, cache_len=cache_len)
    x = x + h
    h = L.rmsnorm(layer_params["ln2"], x)
    if is_moe:
        h, aux = moe(layer_params["moe"], cfg.moe_config(), h, mesh=mesh)
    else:
        h, aux = L.mlp(layer_params["mlp"], h, mesh=mesh), 0.0
    return x + h, aux, new_cache


def _embed(params, cfg: LMConfig, tokens, mesh):
    x = sharded_embed_lookup(params["embed"], tokens, mesh).to(cfg.dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the model dtype first, as the reference does
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype).item()
    return x


@L.fp32_accumulation()
def forward(params, cfg: LMConfig, tokens, mesh=None):
    """tokens [B, S] -> (hidden [B, S, d], aux_loss)."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, mesh)
    x = constrain(x, mesh, "batch", None, "embed")
    positions = torch.arange(S, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for run_params, (sig, n) in zip(params["runs"], cfg.runs()):
        for i in range(n):
            x, a, _ = _block(cfg, sig, _layer(run_params, i), x, positions,
                             mesh)
            aux_total = aux_total + a
    x = L.rmsnorm(params["final_ln"], x)
    return x, aux_total


def _output_weight(params, cfg: LMConfig):
    if cfg.tie_embeddings:
        return params["embed"].T                    # [d, V]
    return params["lm_head"]["w"]


@L.fp32_accumulation()
def prefill_step(params, cfg: LMConfig, tokens, mesh=None):
    """Prefill: run the full sequence, return last-position logits AND the
    populated decode caches (ring-sliced for local sliding-window runs).

    Requires S % window == 0 for local runs so the last-window slice aligns
    with ring slots.
    """
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, mesh)
    x = constrain(x, mesh, "batch", None, "embed")
    positions = torch.arange(S, device=x.device)
    caches = []
    for run_params, (sig, n) in zip(params["runs"], cfg.runs()):
        layer_caches = []
        for i in range(n):
            x, _, cache = _block(cfg, sig, _layer(run_params, i), x,
                                 positions, mesh)
            layer_caches.append(cache)
        run_cache = tuple(torch.stack(cs) for cs in zip(*layer_caches))
        del layer_caches
        kind, _ = sig
        if cfg.attn != "mla" and kind == "local" and cfg.window \
                and cfg.window < S:
            assert S % cfg.window == 0, (S, cfg.window)
            run_cache = tuple(c[:, :, -cfg.window:] for c in run_cache)
        caches.append(run_cache)
    x = L.rmsnorm(params["final_ln"], x)
    logits = (x[:, -1, :] @ _output_weight(params, cfg)).to(torch.float32)
    logits = constrain(logits, mesh, "batch", "vocab")
    return logits, caches


# ------------------------------------------------------------------- serve
def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None):
    """Decode cache tree on ``device`` (``cuda`` unless asked): one
    stacked entry per run.

    GQA: (k, v) [n, B, W, KV, dh] with W = window for local runs.
    MLA: (latent, rope) [n, B, S, kv_lora] / [n, B, S, qk_rope].
    """
    dev = resolve_device(device)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    caches = []
    for sig, n in cfg.runs():
        kind, _ = sig
        if cfg.attn == "mla":
            m = cfg.mla
            caches.append((zeros((n, batch, max_seq, m.kv_lora)),
                           zeros((n, batch, max_seq, m.qk_rope))))
        else:
            W = min(cfg.window, max_seq) if (kind == "local" and cfg.window) \
                else max_seq
            shape = (n, batch, W, cfg.n_kv_heads, cfg.d_head)
            caches.append((zeros(shape), zeros(shape)))
    return caches


def cache_specs(cfg: LMConfig, shard_seq: bool = False,
                model_shards: int = 1):
    """Logical axes for the cache tree.

    Default: batch over (pod,data), KV heads over model.  When kv_heads
    don't divide the model axis the cache SEQUENCE dim is sharded over
    model instead.  ``shard_seq=True`` (batch too small to shard): the
    seq dim additionally takes the (pod,data) axes.
    """
    b_ax = None if shard_seq else "batch"
    kv_ok = cfg.n_kv_heads % max(model_shards, 1) == 0
    kv_ax = "kv_heads" if kv_ok else None
    s_ax = "longseq" if shard_seq else (None if kv_ok else "seq_model")
    specs = []
    for sig, _ in cfg.runs():
        if cfg.attn == "mla":
            specs.append(((None, b_ax, s_ax, None),
                          (None, b_ax, s_ax, None)))
        else:
            specs.append(((None, b_ax, s_ax, kv_ax, None),) * 2)
    return specs


@L.fp32_accumulation()
def serve_step(params, cfg: LMConfig, token, caches, cache_len, mesh=None):
    """One decode step.  token [B, 1] -> (logits [B, V], caches).

    The new slot of every layer is written in place into the cache
    tensors given (the reference donates its caches to an in-place
    ``dynamic_update_slice``); the returned caches are those tensors."""
    x = _embed(params, cfg, token, mesh)
    cache_len = int(cache_len)
    positions = torch.full((1,), cache_len, dtype=torch.int32,
                           device=x.device)
    for run_params, run_cache, (sig, n) in zip(params["runs"], caches,
                                               cfg.runs()):
        for i in range(n):
            x, _, _ = _block(cfg, sig, _layer(run_params, i), x, positions,
                             mesh, cache=tuple(c[i] for c in run_cache),
                             cache_len=cache_len)
    x = L.rmsnorm(params["final_ln"], x)
    logits = (x[:, 0, :] @ _output_weight(params, cfg)).to(torch.float32)
    logits = constrain(logits, mesh, "batch", "vocab")
    return logits, caches
