"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40 => MHA) d_ff=27392
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-*]."""

import torch

from repro_torch.configs.registry import ArchSpec, register_arch
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-32b",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
        d_ff=27392, vocab=152_064, qkv_bias=True, rope_theta=1_000_000.0,
        dtype=torch.bfloat16,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=160, vocab=384, qkv_bias=True, dtype=torch.float32,
        loss_chunk=128)


register_arch(ArchSpec(
    arch_id="qwen1.5-32b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={"long_500k": "pure full attention; no sub-quadratic mechanism "
                        "(skip mandated by the assignment; see DESIGN.md)"},
    notes=("decode_32k KV cache at kv=40,B=128 is 5.5 TB bf16 — exceeds a "
           "single 256-chip v5e pod; baseline reported as-is, int8 KV "
           "quantisation applied in §Perf."),
))
