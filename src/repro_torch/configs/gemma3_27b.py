"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window pattern, 128k context
[hf:google/gemma-3-*-pt].

Simplifications recorded per DESIGN.md: single RoPE theta (gemma3 uses 10k
local / 1M global); logit softcapping retained; GeGLU approximated with
SwiGLU gates (same FLOPs/memory).
"""

import torch

from repro_torch.configs.registry import ArchSpec, register_arch
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

PATTERN = ("local",) * 5 + ("global",)


def make_config() -> LMConfig:
    return LMConfig(
        name="gemma3-27b",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
        d_ff=21504, vocab=262_144,
        pattern=PATTERN, window=1024, embed_scale=True,
        rope_theta=1_000_000.0,
        dtype=torch.bfloat16,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="gemma3-smoke",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, pattern=PATTERN, window=16, embed_scale=True,
        dtype=torch.float32, loss_chunk=128)


register_arch(ArchSpec(
    arch_id="gemma3-27b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={},
    notes=("long_500k RUNS: 5/6 of layers hold only a 1024-token sliding "
           "window cache (sub-quadratic by architecture)."),
))
