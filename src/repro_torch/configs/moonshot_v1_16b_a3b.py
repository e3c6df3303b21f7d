"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B].

Per the HF config this is a DeepSeek-V3-family MoE: 2 shared experts,
first layer dense (dense d_ff 11264), routed expert d_ff 1408.
"""

import torch

from repro_torch.configs.registry import ArchSpec, register_arch
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig, MoEParams


def make_config() -> LMConfig:
    return LMConfig(
        name="moonshot-v1-16b-a3b",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=11264, vocab=163_840, rope_theta=50_000.0,
        moe_cfg=MoEParams(n_experts=64, top_k=6, d_ff_expert=1408,
                          n_shared=2, first_k_dense=1),
        dtype=torch.bfloat16,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="moonshot-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=384,
        moe_cfg=MoEParams(n_experts=8, top_k=2, d_ff_expert=32,
                          n_shared=1, first_k_dense=1),
        dtype=torch.float32, loss_chunk=128)


register_arch(ArchSpec(
    arch_id="moonshot-v1-16b-a3b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={},
    notes=("long_500k RUNS: GQA kv=16 at d_head=128, B=1 -> 412 GB cache "
           "sharded over the pod (1.6 GB/chip)."),
))
