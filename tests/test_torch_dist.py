"""The port's distributed substrate (``repro_torch.dist``) against the JAX
package's ``repro.dist``.

  * ``wire``: encode / decode bit for bit on drawn arrays with +inf
    distances and -1 ids, for every codec; the byte models, the codec
    table and the texts.
  * ``collectives``: the butterfly permutations and schedules; the stacked
    ``tree_merge_topk`` against the reference's under ``shard_map`` on 8
    forced host devices, on meshes (8,), (4, 2), (2, 4) and a ragged (3,),
    every codec, ``exact_vals`` on and off, ``carry`` default and 3k: ids
    and values bitwise; ``sharded_embed_lookup`` on (2, 4).
  * ``grad_compression``: the stacked all-mean on (8,) bitwise against
    the reference's (the reference side skipped only where its scale goes
    subnormal), the error-feedback property with a float32 bound, and the
    deprecated ``compression`` shim.
  * The process-group realisation: 8 gloo ranks (a subgroup of 4 for the
    4-rank cases) equal the stacked lanes bitwise, for the merge and the
    gradient all-mean.

The reference side runs in ONE module-scoped subprocess that computes
every case and writes an ``.npz`` (the pytest process keeps JAX's single
device); the gloo side in ONE ``torch.multiprocessing.spawn`` of 8 ranks
with a ``file://`` store.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist import collectives as jx_coll  # noqa: E402
from repro.dist import sharding as jx_sharding  # noqa: E402
from repro.dist import wire as jx_wire  # noqa: E402
from repro_torch.dist import collectives, mesh as pmesh, sharding  # noqa: E402
from repro_torch.dist import wire  # noqa: E402
from repro_torch.dist.grad_compression import (_quantize_int8,  # noqa: E402
                                               compress_gradients,
                                               init_error_state)

SRC = str(Path(__file__).resolve().parents[1] / "src")
TESTS = str(Path(__file__).resolve().parent)
K = 10
CODECS = sorted(wire.CODEC_DIST_BYTES)
MESHES = {"8": ((8,), ("data",)), "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")), "3": ((3,), ("data",)),
          "4": ((4,), ("data",))}
MERGE_CASES = [(mesh, codec, exact, carry)
               for mesh in MESHES for codec in CODECS
               for exact in (False, True) for carry in (None, 3 * K)]
GLOO_CASES = ([(mesh, codec, exact, None) for mesh in ("8", "4x2", "2x4")
               for codec in ("bf16", "int8") for exact in (False, True)]
              + [("4", "f32", True, None), ("4", "u16", False, None)])
GRAD_SEEDS = (0, 1, 2, 3)


def _merge_inputs(S: int, seed: int):
    """[S, b, m] lanes of candidates with wire ties, +inf and -1 slots;
    each id lives on one lane."""
    rng = np.random.default_rng(seed)
    b, m = 6, 25
    vals = np.round(np.abs(rng.standard_normal((S, b, m))) * 20, 1)
    vals = vals.astype(np.float32)
    vals[rng.random(vals.shape) < 0.08] = np.inf
    ids = np.empty((S, b, m), np.int32)
    for q in range(b):
        ids[:, q, :] = rng.permutation(3 * S * m)[:S * m].reshape(S, m)
    ids[rng.random(ids.shape) < 0.08] = -1
    return vals, ids


def _grads(seed: int):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(40) * 10.0 ** rng.integers(-3, 3)).astype(
        np.float32)
    e = (rng.standard_normal(40) * 1e-3).astype(np.float32)
    if seed == 3:
        # 1 + 2**-23 steps: a sum of 8 copies rounds differently when
        # added in lane order than in a tree
        g = (1.0 + np.arange(40) * 2.0 ** -23).astype(np.float32)
        e[:] = 0.0
    return g, e


REFERENCE = """
    import json, math, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import repro.ann  # noqa: F401  (registers; breaks an import cycle)
    from repro.dist.collectives import tree_merge_topk, sharded_embed_lookup
    from repro.dist.grad_compression import compress_gradients

    d = sys.argv[1]
    spec = json.load(open(f"{d}/spec.json"))
    devs = jax.devices()
    for name, sizes, axes, codec in spec["merge"]:
        sizes, axes = tuple(sizes), tuple(axes)
        mesh = Mesh(np.array(devs[:math.prod(sizes)]).reshape(sizes), axes)
        z = np.load(f"{d}/in_{name}.npz")

        def local(v, i):
            outs = []
            for exact in (False, True):
                for carry in (None, 3 * spec["k"]):
                    outs += list(tree_merge_topk(
                        v[0], i[0], axes=axes, axis_sizes=sizes,
                        k=spec["k"], codec=codec, carry=carry,
                        exact_vals=exact))
            return tuple(outs)

        fn = jax.jit(shard_map(local, mesh=mesh,
                               in_specs=(P(axes), P(axes)),
                               out_specs=(P(),) * 8, check_rep=False))
        outs = [np.asarray(o) for o in fn(z["vals"], z["ids"])]
        np.savez(f"{d}/ref_{name}_{codec}.npz", *outs)

    mesh8 = jax.make_mesh((8,), ("data",))
    for seed in spec["grad_seeds"]:
        z = np.load(f"{d}/grad_{seed}.npz")
        out, err = jax.jit(lambda g, e: compress_gradients(
            g, e, mesh=mesh8, axes=("data",)))(
            {"w": jnp.asarray(z["g"])}, {"w": jnp.asarray(z["e"])})
        np.savez(f"{d}/ref_grad_{seed}.npz", out=np.asarray(out["w"]),
                 err=np.asarray(err["w"]))

    mesh24 = jax.make_mesh((2, 4), ("data", "model"))
    z = np.load(f"{d}/embed.npz")
    emb = jax.device_put(jnp.asarray(z["emb"]),
                         NamedSharding(mesh24, P("model", None)))
    got = jax.jit(lambda e, t: sharded_embed_lookup(e, t, mesh24))(
        emb, jnp.asarray(z["toks"]))
    np.save(f"{d}/ref_embed.npy", np.asarray(got))
    print("OK", jax.device_count())
"""


@pytest.fixture(autouse=True)
def _no_forced_count():
    yield
    pmesh.force_device_count(None)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs of every case, written once."""
    d = tmp_path_factory.mktemp("dist")
    for name, (sizes, _) in MESHES.items():
        vals, ids = _merge_inputs(math.prod(sizes), seed=len(name))
        np.savez(d / f"in_{name}.npz", vals=vals, ids=ids)
    for seed in GRAD_SEEDS:
        g, e = _grads(seed)
        np.savez(d / f"grad_{seed}.npz", g=g, e=e)
    rng = np.random.default_rng(1)
    np.savez(d / "embed.npz",
             emb=rng.standard_normal((64, 8)).astype(np.float32),
             toks=rng.integers(0, 64, (16, 5)).astype(np.int32))
    return d


@pytest.fixture(scope="module")
def reference(work):
    """The reference's outputs on 8 forced host devices (one subprocess)."""
    spec = {"k": K, "grad_seeds": list(GRAD_SEEDS),
            "merge": [[name, list(sizes), list(axes), codec]
                      for name, (sizes, axes) in MESHES.items()
                      for codec in CODECS]}
    (work / "spec.json").write_text(json.dumps(spec))
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", ""),
           "HOME": str(work), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(work)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK 8" in out.stdout
    return work


def _case_kwargs(mesh, codec, exact, carry):
    sizes, axes = MESHES[mesh]
    return dict(axes=axes, axis_sizes=sizes, k=K, codec=codec, carry=carry,
                fan_in=2, exact_vals=exact)


def _stacked(work, mesh, codec, exact, carry, lanes=False):
    z = np.load(work / f"in_{mesh}.npz")
    kw = _case_kwargs(mesh, codec, exact, carry)
    vals, ids = torch.as_tensor(z["vals"]), torch.as_tensor(z["ids"])
    if lanes:
        ex = collectives.Stacked(kw["axes"], kw["axis_sizes"])
        return collectives._fold(vals, ids, ex, **kw)
    return collectives.tree_merge_topk(vals, ids, **kw)


@pytest.fixture(scope="module")
def gloo(work):
    """Every gloo case on 8 ranks (one spawn); returns the out dir."""
    from torch_gloo_ranks import run

    out = work / "gloo"
    out.mkdir()
    cases = []
    for mesh, codec, exact, carry in GLOO_CASES:
        sizes, axes = MESHES[mesh]
        cases.append((f"m_{mesh}_{codec}_{exact}", math.prod(sizes),
                      str(work / f"in_{mesh}.npz"),
                      dict(axes=axes, sizes=sizes, k=K, codec=codec,
                           carry=carry, fan_in=2, exact_vals=exact)))
    for n in (4, 8):
        cases.append((f"g_{n}", n, str(work / "grad_0.npz"),
                      {"kind": "grads"}))
    sys.path.insert(0, TESTS)
    try:
        torch.multiprocessing.spawn(
            run, args=(8, f"file://{work / 'store'}", cases, str(out)),
            nprocs=8, join=True)
    finally:
        sys.path.remove(TESTS)
    return out


# --------------------------------------------------------------------- wire

def _bits(a) -> np.ndarray:
    """The raw bits of a wire or value array (either package's)."""
    if torch.is_tensor(a):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


@pytest.mark.parametrize("codec", CODECS)
def test_wire_encode_decode_bitwise(codec):
    """Against the reference's codecs as its merge runs them, traced."""
    rng = np.random.default_rng(7)
    for scale in (0.01, 3.0, 1e4, 7e4):
        d = (np.abs(rng.standard_normal((32, 40))) * scale).astype(
            np.float32)
        d[rng.random(d.shape) < 0.1] = np.inf
        d[0, :4] = [0.0, 65534.0, 65535.5, 1e6]
        ids = rng.integers(-1, 100, d.shape).astype(np.int32)
        fin = np.isfinite(d)
        lo = np.where(fin, d, np.inf).min(1, keepdims=True)
        hi = np.where(fin, d, -np.inf).max(1, keepdims=True) * 0.8
        lo, hi = lo.astype(np.float32), hi.astype(np.float32)
        jw = jax.jit(jx_wire.encode, static_argnums=1)(
            jnp.asarray(d), codec, jnp.asarray(lo), jnp.asarray(hi))
        pw = wire.encode(torch.as_tensor(d), codec, torch.as_tensor(lo),
                         torch.as_tensor(hi))
        assert str(pw.dtype).split(".")[-1] == str(jw.dtype)
        np.testing.assert_array_equal(_bits(pw), _bits(np.asarray(jw)))
        jd = jax.jit(jx_wire.decode, static_argnums=1)(
            jw, codec, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(ids))
        pd = wire.decode(pw, codec, torch.as_tensor(lo),
                         torch.as_tensor(hi), torch.as_tensor(ids))
        np.testing.assert_array_equal(_bits(pd), _bits(np.asarray(jd)))


def test_wire_helpers_and_texts_equal():
    assert wire.CODEC_DIST_BYTES == jx_wire.CODEC_DIST_BYTES
    assert wire.WIRE_CODECS == jx_wire.WIRE_CODECS
    for metric in ("euclidean", "angular", "hamming"):
        assert wire.default_codec(metric) == jx_wire.default_codec(metric)
    for codec in CODECS:
        assert wire.needs_scale(codec) == jx_wire.needs_scale(codec)
        assert wire.entry_bytes(codec) == jx_wire.entry_bytes(codec)
    with pytest.raises(ValueError) as got:
        wire.check_codec("fp8")
    with pytest.raises(ValueError) as want:
        jx_wire.check_codec("fp8")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_byte_models_equal(S):
    for k in (1, 10, 100):
        assert wire.flat_gather_wire_bytes(S, k) \
            == jx_wire.flat_gather_wire_bytes(S, k)
        for codec in CODECS:
            for fan_in in (2, 4):
                for carry in (None, k, 3 * k):
                    assert wire.merge_wire_bytes(
                        S, k, codec=codec, fan_in=fan_in, carry=carry) \
                        == jx_wire.merge_wire_bytes(
                            S, k, codec=codec, fan_in=fan_in, carry=carry)


# ------------------------------------------------------------- collectives

def test_butterfly_perm_and_schedule_equal():
    for S in range(1, 17):
        for fan_in in (2, 3, 4, 8):
            assert collectives._axis_schedule(S, fan_in) \
                == jx_coll._axis_schedule(S, fan_in)
            for stride, f in collectives._axis_schedule(S, fan_in):
                for t in range(1, f):
                    assert collectives._butterfly_perm(S, stride, f, t) \
                        == jx_coll._butterfly_perm(S, stride, f, t)


@pytest.mark.parametrize("mesh,codec,exact,carry", MERGE_CASES)
def test_tree_merge_stacked_equals_reference(reference, mesh, codec, exact,
                                             carry):
    z = np.load(reference / f"ref_{mesh}_{codec}.npz")
    slot = 2 * (2 * int(exact) + int(carry is not None))
    want_v, want_i = z[f"arr_{slot}"], z[f"arr_{slot + 1}"]
    got_v, got_i = _stacked(reference, mesh, codec, exact, carry)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy().view(np.uint32),
                                  want_v.view(np.uint32))


def test_stacked_lanes_finish_identical(work):
    """Every lane folds its own concatenation; all end with lane 0's."""
    for mesh in MESHES:
        for codec in CODECS:
            v, i = _stacked(work, mesh, codec, True, None, lanes=True)
            assert torch.equal(i, i[:1].expand_as(i))
            assert torch.equal(v, v[:1].expand_as(v))


def test_sharded_embed_lookup_equals_reference(reference):
    z = np.load(reference / "embed.npz")
    want = np.load(reference / "ref_embed.npy")
    m = pmesh.Mesh((2, 4), ("data", "model"))
    got = collectives.sharded_embed_lookup(torch.as_tensor(z["emb"]),
                                           torch.as_tensor(z["toks"]), m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), z["emb"][z["toks"]])
    # the fallbacks: no mesh, no such axis, a vocab the axis does not split
    emb = torch.as_tensor(z["emb"])
    toks = torch.as_tensor(z["toks"])
    for mesh, e in ((None, emb), (pmesh.Mesh((8,), ("data",)), emb),
                    (pmesh.Mesh((2, 3), ("data", "model")), emb)):
        assert torch.equal(collectives.sharded_embed_lookup(e, toks, mesh),
                           e[toks.long()])


def test_partition_spec_and_rows_equal_reference():
    m = pmesh.Mesh((2, 2), ("data", "model"))
    jm = jax.make_mesh((1, 1), ("data", "model"))
    for entries in [(), ("batch", "embed"), ("rows",), ("batch", "fsdp"),
                    ("mlp", "heads"), (None, "vocab"), ("pod", "data")]:
        assert sharding.partition_spec(m, *entries) \
            == tuple(jx_sharding.partition_spec(jm, *entries))
    assert sharding.rows_sharding(m, ("data", "model")) \
        == tuple(jx_sharding.rows_sharding(jm, ("data", "model")).spec)
    assert sharding.mesh_axes_size(m, ("data", "model")) == 4
    assert sharding.LOGICAL_AXES == jx_sharding.LOGICAL_AXES


def test_device_count_reads_the_references_switch(monkeypatch):
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    assert pmesh.device_count() == 1
    monkeypatch.setenv("XLA_FLAGS", "--foo --xla_force_host_platform_"
                                    "device_count=6")
    assert pmesh.device_count() == 6
    pmesh.force_device_count(3)
    assert pmesh.device_count() == 3
    pmesh.force_device_count(None)
    assert pmesh.device_count() == 6
    with pytest.raises(ValueError):
        pmesh.force_device_count(0)
    m = pmesh.Mesh((4, 2), ("data", "model"))
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.axis_names == ("data", "model")


# ---------------------------------------------------------- gradient codec

def jx_q(x):
    """The reference's quantiser, traced as its compress_gradients runs."""
    from repro.dist.grad_compression import _quantize_int8 as jq
    return jax.jit(jq)(jnp.asarray(x))


@pytest.mark.parametrize("seed", GRAD_SEEDS)
def test_compress_gradients_stacked_equals_reference(reference, seed):
    z = np.load(reference / f"grad_{seed}.npz")
    want = np.load(reference / f"ref_grad_{seed}.npz")
    m = pmesh.Mesh((8,), ("data",))
    out, err = compress_gradients({"w": torch.as_tensor(z["g"])},
                                  {"w": torch.as_tensor(z["e"])}, mesh=m,
                                  axes=("data",))
    np.testing.assert_array_equal(out["w"].numpy().view(np.uint32),
                                  want["out"].view(np.uint32))
    np.testing.assert_array_equal(err["w"].numpy().view(np.uint32),
                                  want["err"].view(np.uint32))
    # no mesh: local quantisation with error feedback only
    jq = np.asarray(jx_q(z["g"] + z["e"]))
    np.testing.assert_array_equal(
        _quantize_int8(torch.as_tensor(z["g"] + z["e"])).numpy(), jq)


_ADVERSARIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45,
                         np.finfo(np.float32).tiny], np.float32)


def _adversarial_steps(rng):
    """2-4 steps of 1-32 entries: float32 values within +-1e30 (a float32
    bound), NaN, +-inf, zeros and denormals."""
    steps = []
    for _ in range(int(rng.integers(2, 5))):
        n = int(rng.integers(1, 33))
        vals = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 31, n))
        vals = np.clip(vals, float(np.float32(-1e30)),
                       float(np.float32(1e30))).astype(np.float32)
        pick = rng.random(n) < 0.3
        vals[pick] = rng.choice(_ADVERSARIAL, int(pick.sum()))
        steps.append(vals)
    return steps


def test_error_feedback_property_with_a_float32_bound():
    """``tests/test_property.py``'s adversarial property on the port, with
    draws inside float32's range: non-finite entries are dropped, every
    output and residual stays finite, and over the sanitised stream
    nothing is lost.  Includes a one-entry gradient at the smallest
    normal, where the reference's scale goes subnormal."""
    rng = np.random.default_rng(0)
    draws = [_adversarial_steps(rng) for _ in range(300)]
    draws.append([np.array([np.finfo(np.float32).tiny], np.float32)] * 2)
    for steps in draws:
        width = max(len(s) for s in steps)
        outs, want = [], np.zeros(width, np.float64)
        err = init_error_state({"w": torch.zeros(width)})
        for s in steps:
            raw = np.zeros(width, np.float32)
            raw[:len(s)] = s
            out, err = compress_gradients({"w": torch.as_tensor(raw)}, err)
            outs.append(out["w"].numpy())
            want += np.where(np.isfinite(raw), raw, 0.0)
            assert np.isfinite(outs[-1]).all()
            assert np.isfinite(err["w"].numpy()).all()
        total = np.sum(outs, axis=0) + err["w"].numpy()
        scale = np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(total / scale, want / scale,
                                   rtol=1e-3, atol=1e-2)


def test_quantize_scale_never_subnormal():
    tiny = np.finfo(np.float32).tiny
    for x in ([tiny], [tiny, -tiny / 4], [127 * tiny, 1e-40]):
        q = _quantize_int8(torch.tensor(x, dtype=torch.float32))
        assert torch.isfinite(q).all()
        assert float(q.abs().max()) <= max(abs(v) for v in x) * 1.01
    # at or above 127 * tiny the scale is the reference's, bit for bit
    x = np.array([3e-36, -1e-37, 0.0], np.float32)
    np.testing.assert_array_equal(_quantize_int8(torch.as_tensor(x)).numpy(),
                                  np.asarray(jx_q(x)))


def test_compression_shim_warns_and_reexports():
    import repro_torch.dist.compression as shim
    from repro_torch.dist import grad_compression

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(DeprecationWarning,
                           match="repro_torch.dist.compression is "
                                 "deprecated"):
            importlib.reload(shim)
    with pytest.warns(DeprecationWarning):
        shim = importlib.reload(shim)
    assert shim.compress_gradients is grad_compression.compress_gradients
    assert shim.init_error_state is grad_compression.init_error_state


# ----------------------------------------------------------- process group

@pytest.mark.parametrize("mesh,codec,exact,carry", GLOO_CASES)
def test_process_group_merge_equals_stacked(work, gloo, mesh, codec, exact,
                                            carry):
    v, i = _stacked(work, mesh, codec, exact, carry)
    for rank in range(math.prod(MESHES[mesh][0])):
        z = np.load(gloo / f"m_{mesh}_{codec}_{exact}.{rank}.npz")
        np.testing.assert_array_equal(z["ids"], i.numpy())
        np.testing.assert_array_equal(z["vals"].view(np.uint32),
                                      v.numpy().view(np.uint32))


@pytest.mark.parametrize("n", [4, 8])
def test_process_group_allmean_equals_stacked(work, gloo, n):
    z = np.load(work / "grad_0.npz")
    out, err = compress_gradients({"w": torch.as_tensor(z["g"])},
                                  {"w": torch.as_tensor(z["e"])},
                                  mesh=pmesh.Mesh((n,), ("data",)))
    for rank in range(n):
        got = np.load(gloo / f"g_{n}.{rank}.npz")
        np.testing.assert_array_equal(got["out"].view(np.uint32),
                                      out["w"].numpy().view(np.uint32))
        np.testing.assert_array_equal(got["err"], err["w"].numpy())
