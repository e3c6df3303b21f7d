"""The port's sharded ANN layer (``repro_torch.ann.sharded``,
``repro_torch.dist.shard_state``) against the JAX package's.

  * The row and inverted-list shard layouts equal the reference's
    ``_row_shard`` / ``_ivf_shard`` (numpy) element for element.
  * ShardedBruteForce (euclidean, angular, hamming, PQ) and ShardedIVF
    (fp32, PQ) at S in {1, 2, 4, 8} give ids bitwise equal to the
    reference's single-device search, in process (``bench_sharded``'s
    gate); the quantized states are the reference's, carried across.
  * With ``exact_vals=False`` (wire-precision values) the port equals the
    reference's sharded search on 8 forced host devices, ids and values
    bitwise, on small-integer grid rows (every euclidean distance exact),
    for meshes (8,) and (4, 2) and every float codec, and hamming's u16;
    ``search_sweep`` on ShardedIVF equals the reference's sweep.
  * ``reshard`` round trips; an oversized recipe is refused with the
    reshard instruction and adapted by ``ensure_servable`` (and
    ``Engine.load``).
  * 8-shard archives interchange both ways.
  * Every keep-mask of 4 shards, on three metrics, equals a single-device
    search over the survivors' rows (``tests/test_faults.py``'s oracle).

The reference side on 8 devices runs in ONE module-scoped subprocess that
computes every case and writes an ``.npz``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ann  # noqa: E402,F401
from repro.ann import bruteforce as jx_bf  # noqa: E402
from repro.ann import ivf as jx_ivf  # noqa: E402
from repro.ann import sharded as jx_sh  # noqa: E402
from repro_torch.ann import bruteforce, functional, sharded  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.dist import shard_state as SS  # noqa: E402
from repro_torch.dist.mesh import Mesh, force_device_count  # noqa: E402
from repro_torch.serve import Engine, checkpoint, faults  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
K = 10
SHARDS = (1, 2, 4, 8)
SWEEP = (1, 2, 4, 8, 16)


@pytest.fixture(autouse=True)
def _eight_devices():
    """8 logical devices, as the reference's forced host devices."""
    prev = force_device_count(8)
    faults.clear()
    yield
    force_device_count(prev)


def _carry(ref):
    arrays = {k: np.asarray(v) for k, v in ref.arrays.items()}
    return state_from_reference(ref.algo, ref.metric, arrays, ref.static,
                                device="cpu")


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _grid(rng, m, d):
    return rng.integers(-8, 8, size=(m, d)).astype(np.float32)


@pytest.fixture(scope="module")
def normal_data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((900, 24)).astype(np.float32)
    Q = rng.standard_normal((16, 24)).astype(np.float32)
    Xh = rng.integers(0, 2, (700, 64)).astype(np.uint8)
    Qh = rng.integers(0, 2, (8, 64)).astype(np.uint8)
    return X, Q, Xh, Qh


@pytest.fixture(scope="module")
def grid_data():
    rng = np.random.default_rng(5)
    Xh = rng.integers(0, 2 ** 32, (500, 2), dtype=np.uint64) \
        .astype(np.uint32)
    Qh = rng.integers(0, 2 ** 32, (12, 2), dtype=np.uint64) \
        .astype(np.uint32)
    return _grid(rng, 600, 12), _grid(rng, 24, 12), Xh, Qh


REFERENCE = """
    import sys
    import numpy as np, jax
    import repro.ann  # noqa: F401
    from repro.ann import functional, sharded
    from repro.serve import checkpoint

    d = sys.argv[1]
    z = np.load(f"{d}/data.npz")
    Xg, Qg, Xh, Qh = z["Xg"], z["Qg"], z["Xh"], z["Qh"]
    out = {}
    meshes = {"8": jax.make_mesh((8,), ("data",)),
              "4x2": jax.make_mesh((4, 2), ("data", "model"))}
    for name, mesh in meshes.items():
        for codec in ("f32", "bf16", "int8"):
            st = sharded.bruteforce_build(Xg, metric="euclidean", mesh=mesh,
                                          wire_codec=codec)
            v, i = sharded.bruteforce_search(st, Qg, k=10, exact_vals=False)
            out[f"bf_{name}_{codec}_v"] = np.asarray(v)
            out[f"bf_{name}_{codec}_i"] = np.asarray(i)
        st = sharded.bruteforce_build(Xh, metric="hamming", mesh=mesh)
        v, i = sharded.bruteforce_search(st, Qh, k=10, exact_vals=False)
        out[f"ham_{name}_v"], out[f"ham_{name}_i"] = np.asarray(v), \\
            np.asarray(i)

    bf8 = sharded.bruteforce_build(Xg, metric="euclidean", n_shards=8)
    ivf8 = sharded.ivf_build(Xg, metric="euclidean", n_clusters=16,
                             n_shards=8)
    checkpoint.save(f"{d}/ref_bf8.npz", bf8)
    checkpoint.save(f"{d}/ref_ivf8.npz", ivf8)
    out["ref_bf8_i"] = np.asarray(sharded.bruteforce_search(bf8, Qg,
                                                            k=10)[1])
    out["ref_ivf8_i"] = np.asarray(sharded.ivf_search(ivf8, Qg, k=10,
                                                      n_probes=4)[1])
    v, i = sharded.ivf_search(ivf8, Qg, k=10, n_probes=4, exact_vals=False)
    out["ivf8_v"], out["ivf8_i"] = np.asarray(v), np.asarray(i)
    sv, si = functional.search_sweep(ivf8, Qg, k=10,
                                     knob_grid={"n_probes": %(sweep)r})
    out["sweep_v"], out["sweep_i"] = np.asarray(sv), np.asarray(si)

    for name in ("port_bf8", "port_ivf8"):
        st, _ = checkpoint.load(f"{d}/{name}.npz").only
        assert tuple(st.stat("mesh_shape")) == (8,)
        if st.algo == "ShardedIVF":
            out[f"{name}_i"] = np.asarray(sharded.ivf_search(
                st, Qg, k=10, n_probes=4)[1])
        else:
            out[f"{name}_i"] = np.asarray(sharded.bruteforce_search(
                st, Qg, k=10)[1])
    np.savez(f"{d}/ref_out.npz", **out)
    print("OK", jax.device_count())
""" % {"sweep": SWEEP}


@pytest.fixture(scope="module")
def reference(grid_data, tmp_path_factory):
    """The reference on 8 forced host devices (one subprocess): its
    sharded searches, its 8-shard archives, and its searches of the
    port's 8-shard archives (written here first)."""
    d = tmp_path_factory.mktemp("sharded")
    Xg, Qg, Xh, Qh = grid_data
    np.savez(d / "data.npz", Xg=Xg, Qg=Qg, Xh=Xh, Qh=Qh)
    prev = force_device_count(8)
    try:
        checkpoint.save(d / "port_bf8.npz", sharded.bruteforce_build(
            Xg, metric="euclidean", n_shards=8, device="cpu"))
        checkpoint.save(d / "port_ivf8.npz", sharded.ivf_build(
            Xg, metric="euclidean", n_clusters=16, n_shards=8,
            device="cpu"))
    finally:
        force_device_count(prev)
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", ""),
           "HOME": str(d), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(d)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK 8" in out.stdout
    return d, dict(np.load(d / "ref_out.npz"))


# ------------------------------------------------------------------ layouts

@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["euclidean", "hamming", "pq"])
def test_row_layout_equals_reference(normal_data, kind, S):
    X, _, Xh, _ = normal_data
    if kind == "hamming":
        ref = jx_bf.build(Xh, metric="hamming")
    else:
        ref = jx_bf.build(X, metric="euclidean",
                          quantize={"pq": {"m": 4}} if kind == "pq" else None)
    want_sh, want_rep, want_static = jx_sh._row_shard(ref, S)
    got_sh, got_rep, got_static = sharded._row_shard(_carry(ref), S)
    assert sorted(got_sh) == sorted(want_sh)
    assert sorted(got_rep) == sorted(want_rep)
    for name, want in want_sh.items():
        np.testing.assert_array_equal(_np(got_sh[name]).view(want.dtype)
                                      if want.dtype == np.uint32
                                      else _np(got_sh[name]), want)
    assert got_static == dict(want_static)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("quantize", [None, {"pq": {"m": 4}}])
def test_ivf_layout_equals_reference(normal_data, quantize, S):
    X = normal_data[0]
    ref = jx_ivf.build(X, metric="euclidean", n_clusters=20,
                       quantize=quantize)
    want_sh, want_rep, want_static = jx_sh._ivf_shard(ref, S)
    got_sh, got_rep, got_static = sharded._ivf_shard(_carry(ref), S)
    assert sorted(got_sh) == sorted(want_sh)
    assert sorted(got_rep) == sorted(want_rep)
    for name, want in want_sh.items():
        np.testing.assert_array_equal(_np(got_sh[name]), want)
    assert got_static == dict(want_static)


# -------------------------------------- against the single-device reference

@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_sharded_bruteforce_equals_reference_single_device(normal_data,
                                                           metric, S):
    X, Q, Xh, Qh = normal_data
    X, Q = (Xh, Qh) if metric == "hamming" else (X, Q)
    _, want = jx_bf.search(jx_bf.build(X, metric=metric), Q, k=K)
    st = sharded.bruteforce_build(X, metric=metric, n_shards=S,
                                  device="cpu")
    assert st.stat("wire_codec") == ("u16" if metric == "hamming"
                                     else "bf16")
    _, got = sharded.bruteforce_search(st, Q, k=K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if metric != "hamming":
        _, got = sharded.bruteforce_search(st, Q, k=K, use_kernel=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_pq_bruteforce_equals_reference_single_device(normal_data,
                                                              S):
    X, Q, _, _ = normal_data
    ref = jx_bf.build(X, metric="euclidean", quantize={"pq": {"m": 8}})
    _, want = jx_bf.search(ref, Q, k=K)
    st = SS.shard_index(_carry(ref), n_shards=S)
    for flags in ({}, {"adc_kernel": True, "rerank_kernel": True}):
        st.static.update(flags)
        _, got = sharded.bruteforce_search(st, Q, k=K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("quantize", [None, {"pq": {"m": 8}}])
def test_sharded_ivf_equals_reference_single_device(normal_data, quantize,
                                                    S):
    X, Q, _, _ = normal_data
    ref = jx_ivf.build(X, metric="euclidean", n_clusters=20,
                       quantize=quantize)
    _, want = jx_ivf.search(ref, Q, k=K, n_probes=4)
    st = SS.shard_index(_carry(ref), n_shards=S)
    _, got = sharded.ivf_search(st, Q, k=K, n_probes=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if quantize is None:
        st.static["rerank_kernel"] = True
        _, got = sharded.ivf_search(st, Q, k=K, n_probes=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------- against the reference's sharded path

@pytest.mark.parametrize("mesh", ["8", "4x2"])
@pytest.mark.parametrize("codec", ["f32", "bf16", "int8", "u16"])
def test_wire_precision_values_equal_reference_sharded(reference, grid_data,
                                                       mesh, codec):
    _, out = reference
    Xg, Qg, Xh, Qh = grid_data
    m = (Mesh((8,), ("data",)) if mesh == "8"
         else Mesh((4, 2), ("data", "model")))
    if codec == "u16":
        st = sharded.bruteforce_build(Xh, metric="hamming", mesh=m,
                                      device="cpu")
        v, i = sharded.bruteforce_search(st, Qh, k=K, exact_vals=False)
        want_v, want_i = out[f"ham_{mesh}_v"], out[f"ham_{mesh}_i"]
    else:
        st = sharded.bruteforce_build(Xg, metric="euclidean", mesh=m,
                                      wire_codec=codec, device="cpu")
        v, i = sharded.bruteforce_search(st, Qg, k=K, exact_vals=False)
        want_v = out[f"bf_{mesh}_{codec}_v"]
        want_i = out[f"bf_{mesh}_{codec}_i"]
    assert st.stat("shard_axes") == m.axis_names
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                  want_v.view(np.uint32))


def test_sharded_ivf_and_its_sweep_equal_reference(reference, grid_data):
    d, out = reference
    _, Qg, _, _ = grid_data
    st, _ = checkpoint.load(d / "ref_ivf8.npz", device="cpu").only
    v, i = sharded.ivf_search(st, Qg, k=K, n_probes=4, exact_vals=False)
    np.testing.assert_array_equal(i.numpy(), out["ivf8_i"])
    np.testing.assert_array_equal(v.numpy(), out["ivf8_v"])
    sv, si = functional.search_sweep(st, Qg, k=K,
                                     knob_grid={"n_probes": SWEEP})
    np.testing.assert_array_equal(si.numpy(), out["sweep_i"])
    np.testing.assert_array_equal(sv.numpy(), out["sweep_v"])
    # each row is the port's own static search at that value
    for row, p in enumerate(SWEEP):
        _, ids = sharded.ivf_search(st, Qg, k=K, n_probes=p)
        assert torch.equal(si[row], ids)


# ------------------------------------------------------- reshard / archives

def test_reshard_round_trips(normal_data):
    X, Q, _, _ = normal_data
    inner = bruteforce.build(X, metric="euclidean", device="cpu")
    _, want = bruteforce.search(inner, Q, k=K)
    st8 = SS.shard_index(inner, n_shards=8)
    for target in ({"n_shards": 4}, {"n_shards": 1},
                   {"mesh": Mesh((4, 2), ("data", "model")),
                    "shard_axes": ("data", "model")}):
        st = SS.reshard(st8, **target)
        _, got = sharded.bruteforce_search(st, Q, k=K)
        assert torch.equal(got, want)
        back = SS.plan_for(st).unshard(st)
        for name in inner.arrays:
            assert torch.equal(back[name], inner[name])
        assert back.static == inner.static
    ref = jx_ivf.build(X, metric="euclidean", n_clusters=20)
    ivf_inner = _carry(ref)
    st = SS.reshard(SS.shard_index(ivf_inner, n_shards=8), n_shards=3)
    back = SS.plan_for(st).unshard(st)
    for name in ivf_inner.arrays:
        assert torch.equal(back[name], ivf_inner[name]), name
    _, want = jx_ivf.search(ref, Q, k=K, n_probes=5)
    np.testing.assert_array_equal(
        sharded.ivf_search(st, Q, k=K, n_probes=5)[1].numpy(),
        np.asarray(want))


def test_oversized_recipe_refused_then_adapted(reference, grid_data):
    """An 8-shard recipe on 2 logical devices: search refuses with the
    reshard instruction; ensure_servable (the Engine restore path)
    reshards it."""
    d, out = reference
    _, Qg, _, _ = grid_data
    force_device_count(2)
    restored, _ = checkpoint.load(d / "ref_bf8.npz", device="cpu").only
    with pytest.raises(SS.ShardingError) as exc:
        sharded.bruteforce_search(restored, Qg, k=5)
    assert "8 devices" in str(exc.value) and "reshard" in str(exc.value)
    served = SS.ensure_servable(restored)
    assert tuple(served.stat("mesh_shape")) == (2,)
    np.testing.assert_array_equal(
        sharded.bruteforce_search(served, Qg, k=K)[1].numpy(),
        out["ref_bf8_i"])
    eng = Engine.load(d / "ref_bf8.npz", device="cpu", k=K)
    assert tuple(eng.state.stat("mesh_shape")) == (2,)
    np.testing.assert_array_equal(eng.search(Qg)[1], out["ref_bf8_i"])
    with pytest.raises(SS.ShardingError, match="needs 4 devices"):
        sharded.bruteforce_build(Qg, n_shards=4, device="cpu")


@pytest.mark.parametrize("name", ["bf8", "ivf8"])
def test_eight_shard_archives_interchange(reference, grid_data, name):
    d, out = reference
    _, Qg, _, _ = grid_data
    # the reference's archive, in the port
    st, _ = checkpoint.load(d / f"ref_{name}.npz", device="cpu").only
    assert tuple(st.stat("mesh_shape")) == (8,)
    assert st["ids"].shape[0] == 8
    search = (sharded.ivf_search if name == "ivf8"
              else sharded.bruteforce_search)
    kw = {"n_probes": 4} if name == "ivf8" else {}
    np.testing.assert_array_equal(search(st, Qg, k=K, **kw)[1].numpy(),
                                  out[f"ref_{name}_i"])
    # the port's archive, in the reference
    pst, _ = checkpoint.load(d / f"port_{name}.npz", device="cpu").only
    np.testing.assert_array_equal(search(pst, Qg, k=K, **kw)[1].numpy(),
                                  out[f"port_{name}_i"])


# -------------------------------------------------- degraded masks: oracle

def _oracle(X, ids_per_shard, mask, Q, k, metric):
    """tests/test_faults.py's oracle: the reference's single-device
    search over only the surviving shards' rows."""
    alive = [ids_per_shard[s] for s in range(len(mask)) if mask[s]]
    keep = np.concatenate(alive) if alive else np.empty(0, np.int32)
    keep = np.sort(keep[keep >= 0])
    if keep.size == 0:
        return np.full((Q.shape[0], k), -1, np.int32)
    _, loc = jx_bf.search(jx_bf.build(X[keep], metric=metric), Q, k=k)
    loc = np.asarray(loc)
    return np.where(loc >= 0, keep[np.clip(loc, 0, None)], -1).astype(
        np.int32)


@pytest.mark.parametrize("metric", ["euclidean", "angular", "hamming"])
def test_every_mask_of_four_shards_equals_survivors_oracle(metric):
    rng = np.random.default_rng(0)
    Xe = rng.standard_normal((640, 16)).astype(np.float32)
    Qe = rng.standard_normal((8, 16)).astype(np.float32)
    Xh = rng.integers(0, 2, (512, 64)).astype(np.uint8)
    Qh = rng.integers(0, 2, (6, 64)).astype(np.uint8)
    X, Q = {"euclidean": (Xe, Qe), "hamming": (Xh, Qh),
            "angular": (Xe / np.linalg.norm(Xe, axis=1, keepdims=True),
                        Qe)}[metric]
    st = sharded.bruteforce_build(X, metric=metric, n_shards=4,
                                  device="cpu")
    ids_per_shard = st["ids"].numpy().reshape(4, -1)
    for m in range(16):
        mask = np.array([(m >> s) & 1 for s in range(4)], bool)
        _, got = sharded.bruteforce_search(st, Q, k=8, shard_ok=mask)
        want = _oracle(X, ids_per_shard, mask, Q, 8, metric)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=str(mask.tolist()))
