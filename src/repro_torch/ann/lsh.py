"""Locality-sensitive hashing (paper Table 2: FALCONN/MPLSH family), as
``repro.ann.lsh``.

Two schemes over a shared sorted-bucket layout:

  * ``HyperplaneLSH`` (angular): b sign-bits of random hyperplanes per table
    (SimHash).  Multiprobe flips the bits with the smallest |margin|.
  * ``E2LSH`` (euclidean): m quantised random projections
    floor((a.x + b)/w) per table, combined into one key.  Multiprobe
    perturbs the projections closest to a quantisation boundary (Dong et
    al.'s multi-probe LSH).

Buckets are not pointer-chased: each table stores its keys sorted
(keys[n], ids[n]); a lookup is ``searchsorted`` + a fixed-width masked
window gather.  The window width (``cap``) bounds worst-case bucket reads.

Candidate verification runs through the shared rerank
(:func:`rerank_candidates`): the torch streaming fold, or with
``rerank_kernel=True`` the hand-written Hopper kernel
``kernels/csrc/rerank_topk.cu``.

Integer arithmetic follows the reference's int32: E2LSH keys are sums of
int32 products that wrap modulo 2**32 before the reduction mod a prime
(:func:`_wrap32`).  torch sums int32 tensors into int64, which would not
wrap, so the wrap is explicit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ann.functional import (FunctionalSpec, IndexState,
                                        prepare_points, prepare_queries,
                                        register_functional)
from repro_torch.ann.topk import topk_smallest
from repro_torch.core.interface import FunctionalANN
from repro_torch.core.registry import register
from repro_torch.kernels.rerank_topk import rerank_topk

_E2_PRIME = (1 << 31) - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Integer values -> the int32 that two's-complement wraparound gives
    (as int64, so that further arithmetic cannot overflow)."""
    x = torch.remainder(x.to(torch.int64), 1 << 32)
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def live_mask(size: int, knob, device) -> torch.Tensor:
    """[size] bool: positions below ``max(knob, 1)`` (knob: int or 0-d
    tensor), the traced-knob mask of the reference."""
    knob = torch.clamp_min(torch.as_tensor(knob, device=device), 1)
    return torch.arange(size, device=device) < knob


def sorted_buckets(keys: np.ndarray, device):
    """Sort per-table (key, id) arrays: keys [L, n] -> (keys, ids) tensors."""
    order = np.argsort(keys, axis=1, kind="stable")
    return (torch.as_tensor(np.take_along_axis(keys, order, axis=1)).to(device),
            torch.as_tensor(order.astype(np.int32)).to(device))


def bucket_lookup(keys, ids, qkeys: torch.Tensor, cap: int) -> torch.Tensor:
    """qkeys [b, L, P] -> candidate ids [b, L*P*cap] int32 (-1 invalid)."""
    b, L, P = qkeys.shape
    n = keys.shape[1]
    offs = torch.arange(cap, device=qkeys.device)
    out = []
    for t in range(L):
        kq = qkeys[:, t, :].contiguous()                     # [b, P]
        start = torch.searchsorted(keys[t], kq, side="left")
        pos = torch.clamp_max(start[..., None] + offs, n - 1)  # [b, P, cap]
        found = keys[t][pos] == kq[..., None]
        cand = torch.where(found, ids[t][pos], torch.full_like(ids[t][pos],
                                                                -1))
        out.append(cand.reshape(b, -1))
    return torch.cat(out, dim=1).to(torch.int32)


def rerank_candidates(state: IndexState, Q, cand, k: int):
    """Exact rerank of a [b, C] candidate-id window (float metrics) through
    the shared rerank (:func:`repro_torch.kernels.rerank_topk.rerank_topk`):
    -1 ids never win, duplicate ids collapse.  ``rerank_kernel`` routes it
    through the Hopper kernel; ``rerank_block`` overrides the fold's block.
    Shared by the LSH schemes and RPForest."""
    return rerank_topk(
        Q, state["X"], cand, k=k, metric=state.metric,
        xsq=state.arrays.get("xsq"),
        block=state.static.get("rerank_block"),
        use_kernel=bool(state.static.get("rerank_kernel", False)))


# ----------------------------------------------------------- hyperplane LSH
def hyperplane_build(X: np.ndarray, *, metric: str = "angular",
                     n_tables: int = 8, n_bits: int = 16, cap: int = 64,
                     seed: int = 0, rerank_kernel: bool = False,
                     rerank_block=None, device=None) -> IndexState:
    if int(n_bits) > 30:
        raise ValueError("n_bits must be <= 30 (int32 keys)")
    dev = resolve_device(device)
    X = prepare_points(X, metric)
    n, d = X.shape
    rng = np.random.default_rng(int(seed))
    planes = torch.as_tensor(
        rng.standard_normal((int(n_tables), int(n_bits), d))
        .astype(np.float32)).to(dev)
    pow2 = torch.as_tensor(2 ** np.arange(int(n_bits), dtype=np.int32)).to(dev)
    Xt = torch.as_tensor(X).to(dev)
    proj = torch.einsum("lbd,nd->lnb", planes, Xt)        # [L, n, b]
    bits = (proj > 0).to(torch.int32)
    keys = torch.sum(bits * pow2[None, None, :], dim=-1).to(torch.int32)
    del proj, bits
    tkeys, tids = sorted_buckets(keys.cpu().numpy(), dev)
    return IndexState("HyperplaneLSH", metric, {
        "X": Xt, "planes": planes, "pow2": pow2,
        "keys": tkeys, "ids": tids,
    }, {"n": n, "d": d, "n_tables": int(n_tables), "n_bits": int(n_bits),
        "cap": int(cap), "rerank_kernel": bool(rerank_kernel),
        "rerank_block": None if rerank_block is None else int(rerank_block)})


def _hyperplane_probe_keys(state: IndexState, Q, probes: int):
    planes, pow2 = state["planes"], state["pow2"]
    n_bits = state.stat("n_bits")
    proj = torch.einsum("lbd,qd->qlb", planes, Q)        # [b_q, L, bits]
    bits = (proj > 0).to(torch.int32)
    base = torch.sum(bits * pow2[None, None, :], dim=-1).to(torch.int32)
    keys = [base]
    if probes > 1:
        nflip = min(probes - 1, n_bits)
        # smallest |margin| first, ties to the lower bit (jax.lax.top_k)
        _, flip_pos = topk_smallest(torch.abs(proj), nflip)      # [bq,L,p]
        sgn = torch.where(bits > 0, -pow2[None, None, :], pow2[None, None, :])
        for p in range(nflip):
            delta = torch.take_along_dim(sgn, flip_pos[..., p:p + 1],
                                         dim=-1)[..., 0]
            keys.append(base + delta)
    return torch.stack(keys, dim=-1)                     # [bq, L, P]


def _mask_probe_keys(qkeys, n_probes):
    """Dead probe columns get key -1 (bucket keys are non-negative, so the
    lookup matches nothing): probes past the traced ``n_probes``
    contribute no candidates."""
    live = live_mask(qkeys.shape[-1], n_probes, qkeys.device)
    return torch.where(live[None, None, :], qkeys, torch.full_like(qkeys, -1))


def _mask_tables(qkeys, tables):
    """Same treatment along the TABLE axis: tables past the traced
    ``tables`` count get key -1.  Parity with the static slice holds
    because the rerank select (``topk_unique``) is canonical on the
    (id, dist) set."""
    live = live_mask(qkeys.shape[1], tables, qkeys.device)
    return torch.where(live[None, :, None], qkeys, torch.full_like(qkeys, -1))


def _table_window(qkeys, tables, max_tables):
    """Static path: consult only the first ``tables`` tables (a slice);
    traced path (a ``max_tables`` cap): keep all tables and mask the dead
    ones."""
    if max_tables is not None:
        return qkeys if tables is None else _mask_tables(qkeys, tables)
    if tables is not None:
        return qkeys[:, :max(1, min(int(tables), qkeys.shape[1]))]
    return qkeys


def hyperplane_search(state: IndexState, Q, *, k: int, n_probes: int = 1,
                      tables=None, max_probes=None, max_tables=None):
    """Query knobs: ``n_probes`` (multiprobe flips per table) under
    ``max_probes`` and ``tables`` (hash tables consulted, ``None`` = all)
    under ``max_tables``."""
    Q = prepare_queries(Q, state.metric, state.device)
    P = max(1, int(n_probes)) if max_probes is None else max(1, int(max_probes))
    qkeys = _hyperplane_probe_keys(state, Q, P)
    if max_probes is not None:
        qkeys = _mask_probe_keys(qkeys, n_probes)
    qkeys = _table_window(qkeys, tables, max_tables)
    cand = bucket_lookup(state["keys"], state["ids"], qkeys,
                         state.stat("cap"))
    return rerank_candidates(state, Q, cand, k)


register_functional(FunctionalSpec(
    name="HyperplaneLSH", build=hyperplane_build, search=hyperplane_search,
    query_params=("n_probes", "tables", "max_probes", "max_tables"),
    query_defaults=(1, None, None, None),
    supported_metrics=("angular",),
    traced_knobs=(("n_probes", "max_probes"), ("tables", "max_tables")),
))


# ------------------------------------------------------------------- E2LSH
def e2lsh_build(X: np.ndarray, *, metric: str = "euclidean",
                n_tables: int = 8, n_hashes: int = 8, width: float = 4.0,
                cap: int = 64, seed: int = 0, rerank_kernel: bool = False,
                rerank_block=None, device=None) -> IndexState:
    # ``width`` is RELATIVE to the dataset's sampled NN-distance scale
    dev = resolve_device(device)
    Xf = np.asarray(X, np.float32)
    m = min(256, Xf.shape[0])
    rng_s = np.random.default_rng(int(seed) + 1)
    sample = Xf[rng_s.choice(Xf.shape[0], m, replace=False)]
    d2 = (np.sum(sample**2, 1)[:, None] - 2 * sample @ sample.T
          + np.sum(sample**2, 1)[None, :])
    np.fill_diagonal(d2, np.inf)
    scale = float(np.median(np.sqrt(np.maximum(d2.min(1), 0))))

    X = prepare_points(X, metric)
    n, d = X.shape
    w = float(width) * max(scale, 1e-6)
    rng = np.random.default_rng(int(seed))
    a = torch.as_tensor(rng.standard_normal(
        (int(n_tables), int(n_hashes), d)).astype(np.float32)).to(dev)
    b = torch.as_tensor(
        (rng.random((int(n_tables), int(n_hashes))) * w)
        .astype(np.float32)).to(dev)
    combine = torch.as_tensor(rng.integers(
        1, _E2_PRIME, size=(int(n_tables), int(n_hashes)))
        .astype(np.int32)).to(dev)
    Xt = torch.as_tensor(X).to(dev)
    state = IndexState("E2LSH", metric, {
        "X": Xt, "a": a, "b": b, "combine": combine,
        "xsq": torch.sum(Xt * Xt, dim=1),     # cached for the fused rerank
    }, {"n": n, "d": d, "n_tables": int(n_tables),
        "n_hashes": int(n_hashes), "cap": int(cap), "w_eff": w,
        "rerank_kernel": bool(rerank_kernel),
        "rerank_block": None if rerank_block is None else int(rerank_block)})
    h, _ = _e2_hash(state, Xt)
    tkeys, tids = sorted_buckets(_e2_key(state, h).cpu().numpy(), dev)
    return IndexState(state.algo, metric,
                      dict(state.arrays, keys=tkeys, ids=tids), state.static)


def _e2_hash(state: IndexState, X):
    """[L, n, m] integer hashes + fractional part (for multiprobe)."""
    proj = (torch.einsum("lmd,nd->lnm", state["a"], X)
            + state["b"][:, None, :]) / state.stat("w_eff")
    fl = torch.floor(proj)
    return fl.to(torch.int32), proj - fl


def _e2_key(state: IndexState, h):
    """[L, n] keys: sum_j h_j * combine_j in int32 (wrapping), mod the
    prime."""
    prod = _wrap32(h.to(torch.int64)
                   * state["combine"][:, None, :].to(torch.int64))
    s = _wrap32(torch.sum(prod, dim=-1))
    return torch.remainder(s, _E2_PRIME).to(torch.int32)


def _e2_probe_keys(state: IndexState, Q, probes: int):
    n_hashes = state.stat("n_hashes")
    h, frac = _e2_hash(state, Q)                          # [L, bq, m]
    base = _e2_key(state, h).transpose(0, 1)              # [bq, L]
    h = h.transpose(0, 1)                                 # [bq, L, m]
    frac = frac.transpose(0, 1)
    keys = [base]
    if probes > 1:
        # boundary distances: +1 costs (1-frac), -1 costs frac
        cost = torch.cat([frac, 1.0 - frac], dim=-1)      # [bq, L, 2m]
        nprobe = min(probes - 1, 2 * n_hashes)
        _, pos = topk_smallest(cost, nprobe)
        comb = state["combine"][None, :, :].expand(h.shape)
        for p in range(nprobe):
            j = pos[..., p] % n_hashes
            sign = torch.where(pos[..., p] < n_hashes, -1, 1)
            coeff = torch.take_along_dim(comb, j[..., None], dim=-1)[..., 0]
            key = _wrap32(base.to(torch.int64) + sign * coeff.to(torch.int64))
            keys.append(torch.remainder(key, _E2_PRIME).to(torch.int32))
    return torch.stack(keys, dim=-1)


def e2lsh_search(state: IndexState, Q, *, k: int, n_probes: int = 1,
                 tables=None, max_probes=None, max_tables=None):
    """Same knob pairs as :func:`hyperplane_search`; E2 keys are reduced
    mod a positive prime, so the masks' -1 sentinel matches no bucket."""
    Q = prepare_queries(Q, state.metric, state.device)
    P = max(1, int(n_probes)) if max_probes is None else max(1, int(max_probes))
    qkeys = _e2_probe_keys(state, Q, P)
    if max_probes is not None:
        qkeys = _mask_probe_keys(qkeys, n_probes)
    qkeys = _table_window(qkeys, tables, max_tables)
    cand = bucket_lookup(state["keys"], state["ids"], qkeys,
                         state.stat("cap"))
    return rerank_candidates(state, Q, cand, k)


register_functional(FunctionalSpec(
    name="E2LSH", build=e2lsh_build, search=e2lsh_search,
    query_params=("n_probes", "tables", "max_probes", "max_tables"),
    query_defaults=(1, None, None, None),
    supported_metrics=("euclidean",),
    traced_knobs=(("n_probes", "max_probes"), ("tables", "max_tables")),
))


# ------------------------------------------------------------ legacy classes
class _LSHBase(FunctionalANN):
    def __init__(self, metric: str, n_tables: int, cap: int, seed: int,
                 build_params: dict):
        super().__init__(metric, build_params=build_params)
        self.n_tables = int(n_tables)
        self.cap = int(cap)
        self.seed = int(seed)
        self.n_probes = 1
        self._dist_comps = 0

    def _sync_state(self):
        self._n = self._state.stat("n")
        self._d = self._state.stat("d")

    def set_query_arguments(self, n_probes: int, tables=None) -> None:
        self.n_probes = max(1, int(n_probes))
        self._qparams["n_probes"] = self.n_probes
        self._qparams["tables"] = None if tables is None \
            else max(1, min(int(tables), self.n_tables))

    def _batch_block_size(self, k: int) -> int:
        return max(1, 32_000_000 // max(
            self.n_tables * self.n_probes * self.cap * self._d, 1))

    def query(self, q: np.ndarray, k: int) -> np.ndarray:
        out = super().query(q, k)
        self._dist_comps += self.n_tables * self.n_probes * self.cap
        return out

    def batch_query(self, Q: np.ndarray, k: int) -> None:
        super().batch_query(Q, k)
        self._dist_comps += Q.shape[0] * self.n_tables * self.n_probes * self.cap

    def get_additional(self):
        return {"dist_comps": self._dist_comps}


@register("HyperplaneLSH")
class HyperplaneLSH(_LSHBase):
    supported_metrics = ("angular",)

    def __init__(self, metric: str, n_tables: int = 8, n_bits: int = 16,
                 cap: int = 64, seed: int = 0, rerank_kernel: bool = False,
                 rerank_block=None):
        super().__init__(metric, n_tables, cap, seed, dict(
            n_tables=int(n_tables), n_bits=int(n_bits), cap=int(cap),
            seed=int(seed), rerank_kernel=bool(rerank_kernel),
            rerank_block=rerank_block))
        if int(n_bits) > 30:
            raise ValueError("n_bits must be <= 30 (int32 keys)")
        self.n_bits = int(n_bits)
        self.name = f"HyperplaneLSH(L={n_tables},b={n_bits},cap={cap})"


@register("E2LSH")
class E2LSH(_LSHBase):
    supported_metrics = ("euclidean",)

    def __init__(self, metric: str, n_tables: int = 8, n_hashes: int = 8,
                 width: float = 4.0, cap: int = 64, seed: int = 0,
                 rerank_kernel: bool = False, rerank_block=None):
        super().__init__(metric, n_tables, cap, seed, dict(
            n_tables=int(n_tables), n_hashes=int(n_hashes),
            width=float(width), cap=int(cap), seed=int(seed),
            rerank_kernel=bool(rerank_kernel), rerank_block=rerank_block))
        self.n_hashes = int(n_hashes)
        self.width = float(width)
        self.name = (f"E2LSH(L={n_tables},m={n_hashes},w={width},cap={cap})")
