"""The one checkpoint surface for the serving tier
(``repro.serve.checkpoint``).

Everything that persists an :class:`~repro_torch.ann.functional.IndexState`
goes through this module -- ``Engine.save``/``Engine.load`` and the
standalone helpers are thin wrappers over ONE documented entry pair:

    checkpoint.save(path, target, extra=...)   # target: IndexState | mapping
    checkpoint.load(path, device=None) -> CheckpointContents
                                               # tenant -> (state, extra)

Two on-disk formats, auto-detected on load, byte for byte the reference's
layout, so a file written by either package loads in the other:

  * **single state** -- one ``.npz``: the IndexState's array leaves plus a
    JSON metadata record (format version, algo, metric, static dict,
    engine extras).  Written when ``target`` is an ``IndexState``.
  * **multi-tenant archive** -- one zip with a ``manifest.json`` and one
    single-state member per resident tenant, so a multi-tenant serving
    process checkpoints/restores ALL of its indexes atomically in one
    file.  Written when ``target`` is a mapping ``tenant -> IndexState``
    (or ``tenant -> (IndexState, extra)``).

**Version negotiation** is explicit: every rejection says which version
the file has, which this build reads, and -- for known historical
versions -- WHY the file is unusable (v1 pre-dates the cached ``xsq``
norms table, so euclidean E2LSH/RPForest states would load and then fail
at query time) versus the generic stale/newer messages.  All failure
modes raise :class:`CheckpointError`, with the reference's texts.

**What the port adds to the layout, and takes back out.**  Arrays go to
the host (``.cpu().numpy()``) before ``np.savez``; a load puts them on the
device the caller resolves (``cuda`` unless ``device="cpu"``).  Three
port conventions are not in the reference's files, so ``save`` undoes
them and ``load`` redoes them:

  * packed binary codes (a hamming state's corpus ``X`` and a mutable
    index's ``delta_x``) live in int32 tensors in the port
    (:func:`repro_torch.bits.words_to_tensor`) and are written as the
    reference's uint32; any uint32 array read back becomes such a tensor;
  * a mutable index keeps its ``count`` and ``next_id`` counters on the
    CPU (the host reads them on every insert), wherever the rest lives;
  * a MutableBruteForce main carries the port-only static flag
    ``exact_angular`` (``bruteforce.exact_angular``): it is dropped from
    the file and set again on load, so a reference-written mutable state
    scans its delta as a port-built one does.

**Mesh portability**: sharded states (``Sharded*``) are saved exactly like
any other state -- their ``[n_shards, ...]`` arrays go to the host and
their ``static`` dict carries the mesh *recipe* (``shard_axes`` +
``mesh_shape``) as plain JSON.  No device topology is in the file, so it
restores on any host: a recipe larger than the logical device count is
rejected by ``search`` with the reshard instruction, or resharded by
:func:`repro_torch.dist.shard_state.ensure_servable` (the ``Engine``
restore path).
"""

from __future__ import annotations

import io
import json
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann.functional import IndexState
from repro_torch.convert import state_from_reference

#: single-state format version; bump when the on-disk layout changes.
#: v2: euclidean E2LSH/RPForest states grew a cached ``xsq`` array (the
#: fused-rerank norms table) -- v1 checkpoints of those indexes would load
#: but fail at query time, so v1 is rejected with that explanation.
#: v3: compressed-domain (``quantize=``) states carry ``codes``/
#: ``codebooks`` leaves and the ``quant`` static descriptor; pre-quant v2
#: metadata has no codec contract, so v2 is rejected with that explanation.
#: v4: streaming-mutation (Mutable*) states nest a whole inner IndexState
#: under the ``main`` leaf plus delta-buffer/tombstone arrays; the v3
#: array layout is flat-only, so v3 is rejected with that explanation.
CHECKPOINT_VERSION = 4

#: multi-tenant archive format version (manifest + member layout).
ARCHIVE_VERSION = 1

_META_KEY = "__repro_meta__"
_MANIFEST = "manifest.json"

#: a hamming state's arrays that hold packed uint32 words.
_WORDS = ("X", "delta_x")
#: static keys only the port sets; never written to a file.
_PORT_ONLY_STATIC = ("exact_angular",)

#: why a known old single-state version is rejected -- each gets its own
#: message so operators can tell "rebuild required" from "wrong build".
_VERSION_NOTES = {
    1: ("v1 pre-dates the cached xsq norms table: euclidean E2LSH/RPForest "
        "states would load but fail at query time; rebuild the index "
        "(Engine.build) and re-save"),
    2: ("v2 pre-dates compressed-domain search: quantized (quantize=) "
        "states carry codes/codebooks and a quant descriptor the v2 "
        "metadata cannot express, so a PQ/int8 index restored from it "
        "would search without its codec; rebuild the index (Engine.build) "
        "and re-save"),
    3: ("v3 pre-dates streaming mutation: mutable (Mutable*) states nest "
        "an inner IndexState plus delta-buffer and tombstone leaves the "
        "flat v3 layout cannot express — pending inserts would be lost "
        "and deleted rows resurrected; rebuild the index (Engine.build) "
        "and re-save"),
}


class CheckpointError(RuntimeError):
    """Raised for unreadable, stale, or mismatched checkpoints."""


class CheckpointContents(Dict[str, Tuple[IndexState, dict]]):
    """What :func:`load` returns: ``tenant -> (state, extra)``.

    A single-state checkpoint loads as one ``"default"`` entry; ``.only``
    unwraps it (and raises on a multi-tenant archive, so code written for
    one index cannot silently pick an arbitrary tenant).
    """

    @property
    def only(self) -> Tuple[IndexState, dict]:
        if len(self) != 1:
            raise CheckpointError(
                f"checkpoint holds {len(self)} tenant states "
                f"({sorted(self)}); load it with checkpoint.load / "
                f"AsyncEngine.load, not the single-state API")
        return next(iter(self.values()))


# --------------------------------------------------------------------------
# single-state format: IndexState <-> npz bytes
# --------------------------------------------------------------------------

def _host(value, name: str, metric: str) -> np.ndarray:
    """One leaf as the reference writes it: a host array, packed words as
    uint32."""
    a = (value.detach().cpu().numpy() if torch.is_tensor(value)
         else np.asarray(value))
    if metric == "hamming" and name in _WORDS and a.dtype == np.int32:
        a = a.view(np.uint32)
    return a


def _file_static(static: Mapping[str, Any]) -> dict:
    return {k: _jsonable(v) for k, v in static.items()
            if k not in _PORT_ONLY_STATIC}


def _flatten_arrays(arrays: Dict[str, Any], metric: str, prefix: str = ""):
    """name -> tensor | tuple-of-tensors | IndexState  ==>  flat {key: np}.

    A nested :class:`IndexState` value (the mutable indexes' ``main``
    leaf, v4) recurses with a ``name::`` key prefix; its layout entry
    records everything needed to rebuild it (algo/metric/static +
    sub-layout), so arbitrary nesting round-trips.
    """
    flat: Dict[str, np.ndarray] = {}
    layout: Dict[str, Any] = {}
    for name in sorted(arrays):
        value = arrays[name]
        if isinstance(value, IndexState):
            sub_flat, sub_layout = _flatten_arrays(
                value.arrays, value.metric, prefix=f"{prefix}{name}::")
            flat.update(sub_flat)
            layout[name] = {"state": {
                "algo": value.algo, "metric": value.metric,
                "static": _file_static(value.static),
                "layout": sub_layout,
            }}
        elif isinstance(value, (tuple, list)):
            layout[name] = len(value)
            for i, leaf in enumerate(value):
                flat[f"{prefix}{name}:{i}"] = _host(leaf, name, metric)
        else:
            layout[name] = None
            flat[f"{prefix}{name}"] = _host(value, name, metric)
    return flat, layout


def _unflatten_arrays(npz, layout: Dict[str, Any], device,
                      prefix: str = "") -> Dict[str, Any]:
    """The host arrays of one layout level (nested states built first);
    :func:`_state_on` puts them on the device."""
    arrays: Dict[str, Any] = {}
    for name, entry in layout.items():
        if isinstance(entry, dict):
            sub = entry["state"]
            arrays[name] = _state_on(
                sub["algo"], sub["metric"],
                _unflatten_arrays(npz, sub["layout"], device,
                                  prefix=f"{prefix}{name}::"),
                {k: _unjsonable(v) for k, v in sub["static"].items()},
                device)
        elif entry is None:
            arrays[name] = npz[f"{prefix}{name}"]
        else:
            arrays[name] = tuple(npz[f"{prefix}{name}:{i}"]
                                 for i in range(entry))
    return arrays


def _state_on(algo: str, metric: str, arrays: Dict[str, Any],
              static: Dict[str, Any], device) -> IndexState:
    """A port state on ``device`` from a file's arrays and statics, with
    the port's own conventions restored (module docstring)."""
    state = state_from_reference(algo, metric, arrays, static, device=device)
    from repro_torch import mutate

    if mutate.is_mutable(state):
        fix = {name: state[name].cpu() for name in ("count", "next_id")}
        if state.stat("inner") == "BruteForce":
            from repro_torch.ann import bruteforce

            fix["main"] = bruteforce.exact_angular(state["main"])
        state = state.replace(**fix)
    return state


def _jsonable(v):
    if isinstance(v, tuple):
        return {"__tuple__": [_jsonable(x) for x in v]}
    return v


def _unjsonable(v):
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_unjsonable(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return tuple(_unjsonable(x) for x in v)
    return v


def _state_npz_bytes(state: IndexState, extra: Optional[dict]) -> bytes:
    flat, layout = _flatten_arrays(state.arrays, state.metric)
    meta = {
        "version": CHECKPOINT_VERSION,
        "algo": state.algo,
        "metric": state.metric,
        "static": _file_static(state.static),
        "layout": layout,
        "extra": extra or {},
    }
    blob = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **{_META_KEY: blob}, **flat)
    return buf.getvalue()


def _check_version(what: str, version) -> None:
    if version == CHECKPOINT_VERSION:
        return
    if isinstance(version, int) and version > CHECKPOINT_VERSION:
        hint = ("written by a NEWER build — upgrade this install to read "
                "it (or re-save from the old one)")
    else:
        hint = _VERSION_NOTES.get(
            version, "rebuild the index (Engine.build) and re-save")
    raise CheckpointError(
        f"{what} has format version {version!r}, this build reads "
        f"version {CHECKPOINT_VERSION}; {hint}")


def _state_from_npz(file_like, what: str, device,
                    nbytes: Optional[int] = None) -> Tuple[IndexState, dict]:
    """Parse one single-state npz; every way a truncated or bit-flipped
    file can fail (bad zip directory, short member, zlib CRC, mangled
    JSON, missing array key) surfaces as :class:`CheckpointError` naming
    the file and its byte size -- never a raw decoder traceback."""
    size = "" if nbytes is None else f" ({nbytes} bytes on disk)"
    try:
        with np.load(file_like) as z:
            if _META_KEY not in z:
                raise CheckpointError(
                    f"{what} is not an Engine checkpoint (missing metadata "
                    f"record; was it written by the old pickle path?)")
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
            _check_version(what, meta.get("version"))
            arrays = _unflatten_arrays(z, meta["layout"], device)
    except (zipfile.BadZipFile, zlib.error, ValueError, OSError,
            EOFError, KeyError) as e:
        raise CheckpointError(
            f"unreadable or corrupt checkpoint {what}{size}: "
            f"{type(e).__name__}: {e} — the file is likely truncated or "
            f"bit-flipped; restore from a good copy (save() writes "
            f"atomically, so a crashed writer cannot produce this)") from e
    static = {k: _unjsonable(v) for k, v in meta["static"].items()}
    state = _state_on(meta["algo"], meta["metric"], arrays, static, device)
    return state, meta.get("extra", {})


# --------------------------------------------------------------------------
# the entry pair
# --------------------------------------------------------------------------

def save(path, target, *, extra: Optional[dict] = None) -> Path:
    """Serialise ``target`` to ``path`` (atomically, via a tmp rename).

    ``target`` is either one :class:`IndexState` (single-state ``.npz``;
    ``extra`` rides in its metadata record) or a mapping ``tenant ->
    IndexState`` / ``tenant -> (IndexState, extra_dict)`` (multi-tenant
    archive; ``extra=`` is then disallowed -- extras are per tenant).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    if isinstance(target, IndexState):
        tmp.write_bytes(_state_npz_bytes(target, extra))
    elif isinstance(target, Mapping):
        if extra is not None:
            raise ValueError("extra= is per-tenant for archives; pass "
                             "tenant -> (state, extra) pairs instead")
        members = {}
        for i, (tenant, value) in enumerate(sorted(target.items())):
            state, tenant_extra = (value if isinstance(value, tuple)
                                   else (value, None))
            members[str(tenant)] = (f"states/{i}.npz",
                                    _state_npz_bytes(state, tenant_extra))
        manifest = {
            "archive_version": ARCHIVE_VERSION,
            "checkpoint_version": CHECKPOINT_VERSION,
            "tenants": {t: m for t, (m, _) in members.items()},
        }
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr(_MANIFEST, json.dumps(manifest, indent=2))
            for member, blob in members.values():
                zf.writestr(member, blob)
    else:
        raise TypeError(f"cannot checkpoint {type(target).__name__}; "
                        f"pass an IndexState or a tenant mapping")
    # fault-injection point: a FaultPlan with ckpt_truncate scheduled
    # chops the TMP file before the atomic rename, simulating a torn
    # write that somehow got renamed (e.g. a dying disk acking early) --
    # load() must answer with CheckpointError, never a decoder traceback
    from repro_torch.serve import faults as _faults
    keep = _faults.checkpoint_keep_bytes(tmp.stat().st_size)
    if keep is not None:
        with open(tmp, "r+b") as f:
            f.truncate(keep)
    tmp.replace(path)
    return path


def load(path, device=None) -> CheckpointContents:
    """Deserialise ``path`` -> :class:`CheckpointContents` (either format),
    every tensor on ``device`` (``cuda`` unless ``"cpu"`` is asked for).

    Raises :class:`CheckpointError` on missing files, non-checkpoint
    files, or any format-version mismatch (see the module docstring for
    the negotiation rules).
    """
    device = resolve_device(device)
    path = Path(path)
    if not path.exists():
        raise CheckpointError(f"no checkpoint at {path}")
    nbytes = path.stat().st_size
    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            if _MANIFEST in names:
                return _load_archive(path, zf, device)
            if f"{_META_KEY}.npy" not in names:
                raise CheckpointError(
                    f"{path} is not an Engine checkpoint (missing metadata "
                    f"record; was it written by the old pickle path?)")
    except (zipfile.BadZipFile, EOFError, OSError) as e:
        raise CheckpointError(
            f"unreadable or corrupt checkpoint {path} ({nbytes} bytes on "
            f"disk): {type(e).__name__}: {e} — the file is likely "
            f"truncated or bit-flipped; restore from a good copy") from e
    state, extra = _state_from_npz(path, str(path), device, nbytes=nbytes)
    return CheckpointContents(default=(state, extra))


def _load_archive(path: Path, zf: zipfile.ZipFile,
                  device) -> CheckpointContents:
    try:
        manifest = json.loads(zf.read(_MANIFEST).decode())
    except ValueError as e:
        raise CheckpointError(
            f"unreadable archive manifest in {path}: {e}") from e
    version = manifest.get("archive_version")
    if version != ARCHIVE_VERSION:
        raise CheckpointError(
            f"archive {path} has archive version {version!r}, this build "
            f"reads archive version {ARCHIVE_VERSION}; re-save the archive "
            f"(AsyncEngine.save) with a matching build")
    out = CheckpointContents()
    for tenant, member in manifest.get("tenants", {}).items():
        what = f"{path}[{tenant}]"
        try:
            blob = zf.read(member)
        except KeyError as e:
            raise CheckpointError(
                f"archive {path} names member {member!r} for tenant "
                f"{tenant!r} but it is missing") from e
        except (zipfile.BadZipFile, zlib.error, OSError, EOFError) as e:
            raise CheckpointError(
                f"archive member {member!r} for tenant {tenant!r} in "
                f"{path} is unreadable ({type(e).__name__}: {e}) — the "
                f"archive is likely truncated or bit-flipped; restore "
                f"from a good copy") from e
        out[tenant] = _state_from_npz(io.BytesIO(blob), what, device,
                                      nbytes=len(blob))
    if not out:
        raise CheckpointError(f"archive {path} holds no tenant states")
    return out


# --------------------------------------------------------------------------
# single-state helpers
# --------------------------------------------------------------------------

def save_state(state: IndexState, path, extra: Optional[dict] = None) -> Path:
    """Serialise one IndexState (+ engine metadata) -- ``save(path, state)``."""
    return save(path, state, extra=extra)


def load_state(path, device=None) -> Tuple[IndexState, dict]:
    """Deserialise one ``(IndexState, extra)`` -- ``load(path).only``."""
    return load(path, device=device).only
