"""Deprecated compatibility shim (``repro.dist.compression``): the gradient
wire codec lives in :mod:`repro_torch.dist.grad_compression` (corpus vector
codecs are :mod:`repro_torch.quant`, the ANN merge-tree codecs
:mod:`repro_torch.dist.wire`).  Import from
``repro_torch.dist.grad_compression`` directly; this module will be
removed.
"""

import warnings

from repro_torch.dist.grad_compression import (_quantize_int8,  # noqa: F401
                                               compress_gradients,
                                               init_error_state)

warnings.warn(
    "repro_torch.dist.compression is deprecated: import from "
    "repro_torch.dist.grad_compression (gradient codec) or "
    "repro_torch.dist.wire (ANN merge-tree codecs) instead",
    DeprecationWarning, stacklevel=2)

__all__ = ["compress_gradients", "init_error_state"]
