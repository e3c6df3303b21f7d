"""Wire codecs for the distributed top-k merge tree (``repro.dist.wire``).

The sharded search merge (:func:`repro_torch.dist.collectives.
tree_merge_topk`) exchanges per-shard candidate sets -- (distance, global
id) pairs -- across mesh axes.  The flat baseline moves both halves of
every pair as 8 bytes (f32 dist + int32 id); this module shrinks the
*distance* half, which is only ever used for ordering, to 1-2 bytes:

    f32    4 B  identity (the uncompressed reference wire format)
    bf16   2 B  round-to-nearest-even f32 -> bf16 -- scale-free and
                *monotone*, so quantized-domain merge order can only
                differ from exact order inside a bf16 tie bucket
    u16    2 B  lossless for integer-valued distances < 65535 -- the
                hamming codec (popcount distances are small ints)
    int8   1 B  affine over a shared per-query [lo, hi] range (a 2-float
                collective pre-pass), 254 levels + an overflow/invalid
                sentinel; the aggressive wire-bytes option

Ids always travel as int32.  Every codec is monotone, so comparing
*decoded* values is equivalent to comparing wire values.  Invalid entries
are signalled by ``id == -1``; ``decode`` forces their value to +inf.

The expression trees are the reference's, operation for operation, so
the port's wire values equal those of the reference's traced merge bit
for bit.
"""

from __future__ import annotations

import math

import torch

#: distance bytes per wire entry, by codec (ids add ID_BYTES each).
CODEC_DIST_BYTES = {"f32": 4, "bf16": 2, "u16": 2, "int8": 1}
ID_BYTES = 4
WIRE_CODECS = tuple(CODEC_DIST_BYTES)

_U16_INF = 65535
_I8_LEVELS = 254          # 0..253 payload, 254 = overflow, 255 unused
_I8_INF = 255
_I8_STEP = float(torch.tensor(1.0 / (_I8_LEVELS - 1), dtype=torch.float32))


def default_codec(metric: str) -> str:
    """bf16 for float metrics; u16 (lossless integer) for hamming."""
    return "u16" if metric == "hamming" else "bf16"


def check_codec(codec: str) -> str:
    if codec not in CODEC_DIST_BYTES:
        raise ValueError(
            f"unknown wire codec {codec!r}; known: {sorted(CODEC_DIST_BYTES)}")
    return codec


def needs_scale(codec: str) -> bool:
    return codec == "int8"


def _inf(d: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float("inf"), dtype=torch.float32, device=d.device)


def encode(d, codec: str, lo=None, hi=None) -> torch.Tensor:
    """f32 distances -> wire tensor (same shape, codec dtype).

    ``lo``/``hi`` are the shared affine range for int8 -- [..., 1] (or
    scalar) f32 tensors that MUST be identical on every participating
    lane (a pmin/pmax pre-pass); other codecs ignore them.
    """
    d = torch.as_tensor(d).to(torch.float32)
    if codec == "f32":
        return d
    if codec == "bf16":
        return d.to(torch.bfloat16)
    if codec == "u16":
        w = torch.clamp(d, 0.0, float(_U16_INF - 1))
        w = torch.where(torch.isfinite(d), w,
                        torch.full_like(w, float(_U16_INF)))
        return w.to(torch.uint16)
    # int8: affine onto 0..253; anything past hi (or non-finite) -> sentinel
    span = torch.clamp_min(hi - lo, 1e-30)
    q = torch.round((d - lo) / span * float(_I8_LEVELS - 1))
    q = torch.clamp(q, 0, _I8_LEVELS - 1)
    q = torch.where(torch.isfinite(d) & (d <= hi), q,
                    torch.full_like(q, float(_I8_INF)))
    return q.to(torch.uint8)


def decode(w: torch.Tensor, codec: str, lo=None, hi=None,
           ids=None) -> torch.Tensor:
    """Wire tensor -> f32 values; entries with ``ids < 0`` (or the codec's
    overflow sentinel) decode to +inf."""
    if codec in ("f32", "bf16"):
        out = w.to(torch.float32)
    elif codec == "u16":
        out = torch.where(w == _U16_INF, _inf(w), w.to(torch.float32))
    else:
        span = torch.clamp_min(hi - lo, 1e-30)
        # span / 253 and lo + w * step as the reference's traced merge
        # computes them: XLA multiplies by the float32 reciprocal of the
        # constant and fuses the multiply-add (rounded once here: w * step
        # is exact in float64)
        step = span * _I8_STEP
        val = (lo.to(torch.float64) + w.to(torch.float64)
               * step.to(torch.float64)).to(torch.float32)
        out = torch.where(w == _I8_INF, _inf(w), val)
    if ids is not None:
        out = torch.where(ids < 0, _inf(out), out)
    return out


# ------------------------------------------------------------- byte models
def entry_bytes(codec: str) -> int:
    """Wire bytes for one (id, dist) candidate entry."""
    return ID_BYTES + CODEC_DIST_BYTES[check_codec(codec)]


def flat_gather_wire_bytes(n_shards: int, k: int) -> int:
    """Per-device candidate-buffer bytes per query for the flat f32
    ``all_gather`` merge: every shard's k (f32, int32) pairs land on every
    device."""
    return n_shards * k * (4 + ID_BYTES)


def merge_wire_bytes(n_shards: int, k: int, *, codec: str = "bf16",
                     fan_in: int = 2, carry: int | None = None) -> int:
    """Per-device candidate-buffer bytes per query for the hierarchical
    merge tree: ``log_fan_in(n_shards)`` butterfly rounds, each moving
    ``fan_in - 1`` windows of ``carry`` compressed entries (+ the int8
    codec's 2-float shared-range pre-pass)."""
    if n_shards <= 1:
        return 0
    carry = k if carry is None else int(carry)
    rounds = max(1, math.ceil(math.log(n_shards, max(2, fan_in))))
    total = rounds * (fan_in - 1) * carry * entry_bytes(codec)
    if needs_scale(codec):
        total += 8                       # per-query lo/hi f32 pre-pass
    return total
