"""Shared CLI parsing for build/query knob overrides and knob grids
(``repro.launch.knobs``).

Every launcher that accepts ``--build``/``--query`` knob strings
(``repro_torch.launch.tune``) parses them through THIS module, so
``--query ef=64,n_probes=8`` means the same thing -- and fails with the
same message, letter for letter the reference's -- everywhere.  Accepted
forms:

  * ``key=value`` tokens, space-separated (argparse ``nargs``):
    ``--query n_probes=8 max_probes=32``
  * comma-packed assignments inside one token (the form ``launch.tune``
    prints as its ready-to-paste serve config): ``--query ef=64,n_probes=8``
  * grids (``parse_grid``): ``knob=v1,v2,...`` per token, commas are the
    VALUE separator there -- ``--grid n_probes=1,2,4 scan=32,128``

Values coerce ``int`` -> ``float`` -> ``bool`` (``true``/``false``)
-> ``str``, in that order.  Errors raise :class:`SystemExit` with a message
naming the offending token (these are CLI entry points; tests assert the
message is identical across launchers).

``--build`` strings go through :func:`parse_build`, which additionally
folds the flat compressed-domain form ``quantize=pq,m=16,bits=8`` into
the nested ``{"quantize": {"pq": {"m": 16, "bits": 8}}}`` build param the
algorithms take (validated through
``repro_torch.quant.normalize_quantize`` so a bad codec fails at the CLI,
with the codec module's own message, not deep inside the build).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

#: flat CLI spellings of the per-codec training knobs folded under
#: ``quantize=<codec>`` by :func:`parse_build` (lowercase ``m`` -- HNSW's
#: build knob is the distinct capital ``M``).
QUANTIZE_KEYS = ("m", "bits")


def coerce(token: str):
    """One CLI value -> int | float | bool | str (first parse that fits)."""
    try:
        return int(token)
    except ValueError:
        try:
            return float(token)
        except ValueError:
            if token in ("True", "true"):
                return True
            if token in ("False", "false"):
                return False
            return token


def parse_kv(tokens: Sequence[str]) -> Dict[str, object]:
    """``["a=1", "b=2,c=x"]`` -> ``{"a": 1, "b": 2, "c": "x"}``.

    Each token may pack several comma-separated assignments; later
    assignments win on duplicate keys (CLI override semantics).
    """
    out: Dict[str, object] = {}
    for token in tokens:
        for part in token.split(","):
            key, sep, value = part.partition("=")
            if not sep or not key:
                raise SystemExit(
                    f"expected key=value (comma-separable), got {part!r} "
                    f"in {token!r}")
            out[key] = coerce(value)
    return out


def nest_quantize(params: Dict[str, object]) -> Dict[str, object]:
    """Fold flat ``quantize=<codec>`` + codec knobs into the nested form.

    ``{"quantize": "pq", "m": 16, "bits": 8, ...}`` becomes
    ``{"quantize": {"pq": {"m": 16, "bits": 8}}, ...}``; the spec is
    validated through ``repro_torch.quant.normalize_quantize`` so unknown
    codecs, bad ``bits`` and int8-with-knobs fail here -- as
    :class:`SystemExit` with the codec module's exact message -- instead
    of deep inside the build.  Codec knobs without a ``quantize=`` are an
    orphan-knob error.  Builds that never mention quantize pass through
    untouched.
    """
    params = dict(params)
    kind = params.pop("quantize", None)
    codec_knobs = {k: params.pop(k) for k in QUANTIZE_KEYS if k in params}
    if kind is None:
        if codec_knobs:
            raise SystemExit(
                f"codec knob(s) {sorted(codec_knobs)} need a "
                f"quantize=<codec>; pass e.g. quantize=pq,m=16,bits=8")
        return params
    from repro_torch.quant import normalize_quantize

    try:
        normalize_quantize({kind: codec_knobs})
    except ValueError as e:
        raise SystemExit(str(e)) from e
    params["quantize"] = {kind: codec_knobs}
    return params


def parse_build(tokens: Sequence[str]) -> Dict[str, object]:
    """:func:`parse_kv` for ``--build`` strings: flat kv plus the folded
    ``quantize=pq,m=16,bits=8`` compressed-domain form
    (:func:`nest_quantize`)."""
    return nest_quantize(parse_kv(tokens))


def parse_grid(tokens: Sequence[str]) -> Dict[str, List[object]]:
    """``["n_probes=1,2,4", "scan=32,128"]`` -> ``{"n_probes": [1,2,4], ...}``

    One knob per token; commas separate the swept VALUES (so grids and
    packed kv strings cannot be mixed in one flag -- grids have their own
    ``--grid``).
    """
    grid: Dict[str, List[object]] = {}
    for token in tokens:
        key, sep, values = token.partition("=")
        if not sep or not key or not values:
            raise SystemExit(f"expected knob=v1,v2,..., got {token!r}")
        grid[key] = [coerce(v) for v in values.split(",")]
    return grid


def format_kv(params: Dict[str, object]) -> str:
    """Inverse of :func:`parse_kv` for one packed token: ``a=1,b=2`` --
    what ``launch.tune`` prints as a ready-to-paste ``--query`` string."""
    return ",".join(f"{k}={v}" for k, v in params.items())
