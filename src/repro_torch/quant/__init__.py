"""Vector codecs for compressed-domain search (``repro.quant``): corpus
compression for the search path (PQ and per-dimension int8)."""

from repro_torch.quant.codec import (CODECS, build_luts, bytes_per_vector,
                                     decode, normalize_quantize,
                                     subspace_split, train_codec)

__all__ = [
    "CODECS", "build_luts", "bytes_per_vector", "decode",
    "normalize_quantize", "subspace_split", "train_codec",
]
