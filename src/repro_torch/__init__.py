"""PyTorch port of the ANN benchmark (``repro``), for NVIDIA Hopper GPUs.

The package mirrors ``repro``'s subpackage layout: ``repro_torch.ann.ivf``
is the counterpart of ``repro.ann.ivf``, and given the same input arrays
it returns the same answers.  It imports ``torch`` and numpy only.

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``
(a ``device=`` argument, ``ExperimentSettings.device``, the runner's
``--device`` flag).  Without a GPU and without an explicit ``cpu`` they
raise; nothing falls back to the CPU on its own.  On the CPU the kernel
wrappers run their plain PyTorch versions.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "sync"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for (or implied) and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): the
    counterpart of ``jax.block_until_ready`` around a timed call."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
