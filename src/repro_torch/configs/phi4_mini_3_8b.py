"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905]."""

import torch

from repro_torch.configs.registry import ArchSpec, register_arch
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="phi4-mini-3.8b",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
        d_ff=8192, vocab=200_064, rope_theta=10_000.0,
        dtype=torch.bfloat16,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="phi4-smoke",
        n_layers=4, d_model=48, n_heads=6, n_kv_heads=2, d_head=8,
        d_ff=96, vocab=384, dtype=torch.float32, loss_chunk=128)


register_arch(ArchSpec(
    arch_id="phi4-mini-3.8b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full attention; no sub-quadratic mechanism "
                        "(skip mandated by the assignment; see DESIGN.md)"},
))
