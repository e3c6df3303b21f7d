from repro_torch.kernels.decode_attn.decode_attn import (
    decode_attention_kernel, decode_attention_plain)
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.decode_attn.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_kernel",
           "decode_attention_plain", "decode_attention_ref"]
