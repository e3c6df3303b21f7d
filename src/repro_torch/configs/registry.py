"""Architecture registry (``repro.configs.registry``): ``--arch <id>``
resolution for launchers and tests.

Each arch module registers an ArchSpec with:
    make_config()        full published configuration
    make_smoke_config()  reduced same-family config for CPU smoke tests
    shapes               dict of shape-name -> shape params
    skips                shape-name -> reason (recorded, not silently dropped)
    family               "lm" | "gnn" | "recsys"

The port registers the five LM architectures.  The reference's GNN and
recsys ids are listed in :data:`NOT_PORTED`; :func:`get_arch` names them
as such.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict

_ARCHS: Dict[str, "ArchSpec"] = {}

_MODULES = [
    "repro_torch.configs.gemma3_27b",
    "repro_torch.configs.phi4_mini_3_8b",
    "repro_torch.configs.qwen1_5_32b",
    "repro_torch.configs.moonshot_v1_16b_a3b",
    "repro_torch.configs.deepseek_v2_236b",
]

# The reference's archs whose models the port does not have yet.
NOT_PORTED = ("pna", "dcn-v2", "dlrm-mlperf", "fm", "bert4rec")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    make_config: Callable[[], object]
    make_smoke_config: Callable[[], object]
    shapes: dict
    skips: dict = dataclasses.field(default_factory=dict)
    notes: str = ""


def register_arch(spec: ArchSpec) -> ArchSpec:
    _ARCHS[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _load()
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet (its model "
                       f"family is not in repro_torch.models); not yet "
                       f"ported: {sorted(NOT_PORTED)}; known: "
                       f"{sorted(_ARCHS)}")
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]


def all_archs() -> Dict[str, ArchSpec]:
    _load()
    return dict(_ARCHS)


def all_cells():
    """Every (arch, shape) cell, including skipped ones (with reasons)."""
    _load()
    cells = []
    for arch_id, spec in sorted(_ARCHS.items()):
        for shape_name in spec.shapes:
            cells.append((arch_id, shape_name,
                          spec.skips.get(shape_name)))
    return cells


def _load():
    for m in _MODULES:
        importlib.import_module(m)
