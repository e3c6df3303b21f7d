"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, MoE 2 shared + 160 routed top-6 [arXiv:2405.04434].

MLA dims (paper §2.1): q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
v_head=128; first layer dense with d_ff=12288.
"""

import torch

from repro_torch.configs.registry import ArchSpec, register_arch
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig, MLAParams, MoEParams


def make_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
        d_ff=12288, vocab=102_400, rope_theta=10_000.0,
        attn="mla",
        mla=MLAParams(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                      v_head=128),
        moe_cfg=MoEParams(n_experts=160, top_k=6, d_ff_expert=1536,
                          n_shared=2, first_k_dense=1),
        dtype=torch.bfloat16,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=384, attn="mla",
        mla=MLAParams(q_lora=32, kv_lora=32, qk_nope=16, qk_rope=8,
                      v_head=16),
        moe_cfg=MoEParams(n_experts=8, top_k=2, d_ff_expert=32,
                          n_shared=1, first_k_dense=1),
        dtype=torch.float32, loss_chunk=128)


register_arch(ArchSpec(
    arch_id="deepseek-v2-236b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=LM_SHAPES,
    skips={},
    notes=("long_500k RUNS: MLA latent cache is 576 floats/token regardless "
           "of the 128 heads (1.1 GB total at B=1) — the paper's own "
           "motivation for MLA."),
))
