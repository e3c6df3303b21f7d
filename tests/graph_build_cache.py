"""Shared graph builds for the port's parity tests.

``shared_graph_builds()`` wraps the KNNGraph and HNSW specs of both
packages (``repro`` and ``repro_torch``) so that each package builds an
index once per set of points and parameters while the context is open; a
later build of the same points returns the same state.  HNSW's build is a
host loop of a few ms a point, and several tests build the same index.
"""

import contextlib
import dataclasses
import hashlib

import numpy as np

NAMES = ("KNNGraph", "HNSW")


@contextlib.contextmanager
def shared_graph_builds():
    from repro.ann import functional as jx_functional
    from repro_torch.ann import functional

    saved = []
    for pkg in (jx_functional, functional):
        for name in NAMES:
            spec = pkg.get_functional(name)
            cache = {}

            def build(X, *, _build=spec.build, _cache=cache, **params):
                key = (hashlib.sha1(np.ascontiguousarray(X)).hexdigest(),
                       repr(sorted(params.items())))
                if key not in _cache:
                    _cache[key] = _build(X, **params)
                return _cache[key]

            saved.append((pkg.FUNCTIONAL, name, spec))
            pkg.FUNCTIONAL[name] = dataclasses.replace(spec, build=build)
    try:
        yield
    finally:
        for registry, name, spec in saved:
            registry[name] = spec
