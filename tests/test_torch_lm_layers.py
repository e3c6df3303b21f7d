"""The port's LM layers (``repro_torch.models.{layers,flash,moe}``) and
the model half of ``repro_torch.dist.sharding`` against the JAX
package's, on the same numpy inputs and weights.

Tolerances: fp32 outputs within rtol = atol = 2e-5 (the reference's own
flash test uses 2e-5 against its naive attention); bf16 outputs within
two bf16 ulps, rtol = 2**-6, atol = 2**-6 times the output's largest
magnitude (bf16 rounds each op of both packages; XLA and torch on the CPU
do not share every rounding point inside a product).  ``flash`` with and
without ``block_skip`` are bit for bit in the port, as in the reference.

``moe``: ``_route``'s experts equal on untied inputs, a planted tie goes
to the lower expert index (``jax.lax.top_k``'s rule); the gather path
(T * k <= 8192) and the local path (T * k > 8192); ``_experts_ep`` and
``moe`` on the ep path against the reference's under ``shard_map`` on 8
forced host devices (ONE module-scoped subprocess writing an ``.npz``),
on meshes (2, 4), (8,) and (2, 2, 2) with ``model`` > 1, with capacity
drops planted.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist import sharding as jx_sharding  # noqa: E402
from repro.models import flash as jx_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as jx_moe  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.dist import mesh as pmesh, sharding  # noqa: E402
from repro_torch.models import flash, layers as L, moe  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
F32_TOL = 2e-5
BF16_TOL = 2.0 ** -6
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    want = _f32(want)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        assert got.dtype == torch.bfloat16
        scale = float(np.max(np.abs(want))) or 1.0
        np.testing.assert_allclose(_np(got), want, rtol=BF16_TOL,
                                   atol=BF16_TOL * scale)


def _both(a, dtype):
    """One numpy array as (a jnp array, a CPU tensor) of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    return j, lm_params_from_reference({"a": np.asarray(j)},
                                       device="cpu")["a"].to(tdt)


def _params(jparams):
    return lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _x(shape, seed, dtype):
    return _both(np.random.default_rng(seed).standard_normal(shape), dtype)


# ---------------------------------------------------------------- basics

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_dense_and_mlp(dtype):
    jdt = DTYPES[dtype][0]
    jx, tx = _x((3, 5, 64), 0, dtype)
    rng = np.random.default_rng(1)
    jn = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(64), jdt)}
    _close(L.rmsnorm(_params(jn), tx), JL.rmsnorm(jn, jx), dtype)
    jd = JL.init_dense(jax.random.PRNGKey(1), 64, 48, jdt, bias=True)
    jd["b"] = jnp.asarray(rng.standard_normal(48), jdt)
    _close(L.dense(_params(jd), tx), JL.dense(jd, jx), dtype)
    jm = JL.init_mlp(jax.random.PRNGKey(2), 64, 96, jdt)
    _close(L.mlp(_params(jm), tx), JL.mlp(jm, jx), dtype)
    _close(L.mlp(_params(jm), tx[0]), JL.mlp(jm, jx[0]), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope(dtype):
    pos = np.arange(37)
    cos, sin = L.rope_cache(torch.as_tensor(pos), 16, 10_000.0)
    jcos, jsin = JL.rope_cache(jnp.asarray(pos), 16, 10_000.0)
    _close(cos, jcos, "f32")
    _close(sin, jsin, "f32")
    jx, tx = _x((2, 37, 3, 16), 3, dtype)
    _close(L.apply_rope(tx, cos, sin), JL.apply_rope(jx, jcos, jsin), dtype)
    jx, tx = _x((37, 1, 16), 4, dtype)
    _close(L.apply_rope(tx, cos, sin), JL.apply_rope(jx, jcos, jsin), dtype)


def test_trunc_normal_and_cross_entropy():
    gen = torch.Generator().manual_seed(0)
    t = L.trunc_normal(gen, (64, 32), 0.5, torch.bfloat16)
    assert t.shape == (64, 32) and t.dtype == torch.bfloat16
    assert float(t.abs().max()) <= 1.0 and float(t.float().std()) > 0.2
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 6, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (4, 6)).astype(np.int32)
    labels[0, :3] = -100
    got = L.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    _close(got, want, "f32")


def test_attn_mask():
    q, k = np.arange(9), np.arange(12)
    for window in (None, 4):
        got = L._attn_mask(torch.as_tensor(q), torch.as_tensor(k), window)
        want = JL._attn_mask(jnp.asarray(q), jnp.asarray(k), window)
        assert np.array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- attention

ATTN = {"plain": {}, "bias_softcap": {"qkv_bias": True, "softcap": 30.0},
        "qk_norm": {"qk_norm": True}}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(ATTN))
@pytest.mark.parametrize("window", [None, 8])
def test_attention_prefill(dtype, kind, window):
    cfg = L.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                       flash_block_q=16, flash_block_k=8, **ATTN[kind])
    jcfg = JL.AttnConfig(**cfg.__dict__)
    jp = JL.init_attention(jax.random.PRNGKey(0), jcfg, DTYPES[dtype][0])
    if cfg.qkv_bias:
        jp = {k: dict(v, b=v["w"][0] * 0.5) if "b" in v else v
              for k, v in jp.items()}
    jx, tx = _x((2, 32, 64), 6, dtype)
    pos = np.arange(32)
    jout, (jk, jv) = JL.attention(jp, jcfg, jx, jnp.asarray(pos),
                                  window=window)
    out, (k, v) = L.attention(_params(jp), cfg, tx, torch.as_tensor(pos),
                              window=window)
    _close(out, jout, dtype)
    _close(k, jk, dtype)
    _close(v, jv, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("W", [8, 20])
def test_attention_decode_across_the_ring(dtype, softcap, W):
    """13 steps into a W-slot cache: the 8-slot ring wraps past its end;
    every step's output and the whole cache match."""
    cfg = L.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                       softcap=softcap)
    jcfg = JL.AttnConfig(**cfg.__dict__)
    jp = JL.init_attention(jax.random.PRNGKey(1), jcfg, DTYPES[dtype][0])
    p = _params(jp)
    jc, tc = _both(np.zeros((2, W, 2, 16)), dtype)
    jcache, cache = (jc, jc), (tc, tc.clone())
    for t in range(13):
        jx, tx = _x((2, 1, 64), 10 + t, dtype)
        jout, jcache = JL.attention(jp, jcfg, jx, jnp.full((1,), t),
                                    kv_cache=jcache, cache_len=t)
        out, cache = L.attention(p, cfg, tx, torch.full((1,), t),
                                 kv_cache=cache, cache_len=t)
        _close(out, jout, dtype)
        _close(cache[0], jcache[0], dtype)
        _close(cache[1], jcache[1], dtype)


MLA = {"q_lora": dict(q_lora=24, kv_lora=32, qk_nope=16, qk_rope=8,
                      v_head=12),
       "dense_q": dict(q_lora=0, kv_lora=32, qk_nope=16, qk_rope=8,
                       v_head=12)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(MLA))
def test_mla_prefill_and_absorbed_decode(dtype, kind):
    """Both paths: the decompressed prefill (latent caches too), and the
    absorbed decode over 10 steps of an 8-slot cache (the reference's
    write clamps to the last slot from step 8 on)."""
    cfg = L.MLAConfig(d_model=64, n_heads=4, flash_block_q=8,
                      flash_block_k=16, **MLA[kind])
    jcfg = JL.MLAConfig(**cfg.__dict__)
    jp = JL.init_mla(jax.random.PRNGKey(2), jcfg, DTYPES[dtype][0])
    p = _params(jp)
    jx, tx = _x((2, 16, 64), 20, dtype)
    pos = np.arange(16)
    jout, jlat = JL.mla_attention(jp, jcfg, jx, jnp.asarray(pos))
    out, lat = L.mla_attention(p, cfg, tx, torch.as_tensor(pos))
    _close(out, jout, dtype)
    for g, w in zip(lat, jlat):
        _close(g, w, dtype)
    jl, tl = _both(np.zeros((2, 8, 32)), dtype)
    jr, tr = _both(np.zeros((2, 8, 8)), dtype)
    jcache, cache = (jl, jr), (tl, tr)
    for t in range(10):
        jx, tx = _x((2, 1, 64), 30 + t, dtype)
        jout, jcache = JL.mla_attention(jp, jcfg, jx, jnp.full((1,), t),
                                        latent_cache=jcache, cache_len=t)
        out, cache = L.mla_attention(p, cfg, tx, torch.full((1,), t),
                                     latent_cache=cache, cache_len=t)
        _close(out, jout, dtype)
        _close(cache[0], jcache[0], dtype)
        _close(cache[1], jcache[1], dtype)


# ------------------------------------------------------------------ flash

def _flash_inputs(B=2, S=96, KV=2, G=2, dh=16, dv=None, seed=0,
                  dtype="f32"):
    rng = np.random.default_rng(seed)
    dv = dv or dh
    q = _both(rng.standard_normal((B, S, KV, G, dh)), dtype)
    k = _both(rng.standard_normal((B, S, KV, dh)), dtype)
    v = _both(rng.standard_normal((B, S, KV, dv)), dtype)
    return q, k, v, np.arange(S)


def _flash_both(inputs, **kw):
    (jq, tq), (jk, tk), (jv, tv), pos = inputs
    want = jx_flash.flash_attention(jq, jk, jv, jnp.asarray(pos),
                                    jnp.asarray(pos), **kw)
    got = flash.flash_attention(tq, tk, tv, torch.as_tensor(pos),
                                torch.as_tensor(pos), **kw)
    return got, want


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 17, 48])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_matches_the_reference(dtype, window, softcap):
    got, want = _flash_both(_flash_inputs(dtype=dtype), causal=True,
                            window=window, softcap=softcap, bq=32, bk=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 32])
def test_flash_block_skip_identical(window):
    inputs = _flash_inputs(S=128, seed=1)
    a, want = _flash_both(inputs, causal=True, window=window, bq=32, bk=32)
    b, _ = _flash_both(inputs, causal=True, window=window, bq=32, bk=32,
                       block_skip=True)
    assert torch.equal(a, b)
    _close(b, want, "f32")


def test_flash_different_value_dim():
    got, want = _flash_both(_flash_inputs(dh=24, dv=8), causal=True,
                            bq=32, bk=32)
    assert got.shape[-1] == 8
    _close(got, want, "f32")


def test_flash_noncausal():
    for skip in (False, True):
        got, want = _flash_both(_flash_inputs(seed=2), causal=False, bq=48,
                                bk=48, block_skip=skip)
        _close(got, want, "f32")


def test_pick_block():
    for size, target in ((4096, 512), (200, 512), (96, 64), (7, 4),
                         (2048, 1024), (64, 1024)):
        assert flash.pick_block(size, target) == \
            jx_flash.pick_block(size, target)


# -------------------------------------------------------------------- moe

MOE = dict(d_model=64, n_experts=8, top_k=2, d_ff_expert=32, n_shared=1)


def _moe_params(dtype, seed=0):
    jcfg = jx_moe.MoEConfig(**MOE)
    jp = jx_moe.init_moe(jax.random.PRNGKey(seed), jcfg, DTYPES[dtype][0])
    return jcfg, moe.MoEConfig(**MOE), jp, _params(jp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_matches_on_untied_inputs(dtype):
    jcfg, cfg, jp, p = _moe_params(dtype)
    jx, tx = _x((300, 64), 7, dtype)
    jg, je, jaux = jx_moe._route(jp, jcfg, jx)
    g, e, aux = moe._route(p, cfg, tx)
    assert e.dtype == torch.int32
    assert np.array_equal(e.numpy(), np.asarray(je))
    _close(g, jg, dtype)
    _close(aux, jaux, "f32")


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_breaks_a_planted_tie_to_the_lower_index(top_k):
    """Experts 2 and 5 get equal router columns, far above the rest: the
    top-1 is expert 2, then 5, in both packages."""
    cfg = dict(MOE, top_k=top_k)
    jcfg, tcfg = jx_moe.MoEConfig(**cfg), moe.MoEConfig(**cfg)
    rng = np.random.default_rng(8)
    w = rng.standard_normal((64, 8)).astype(np.float32) * 0.01
    x = np.abs(rng.standard_normal((50, 64))).astype(np.float32)
    w[:, 2] = w[:, 5] = 1.0
    jp = {"router": {"w": jnp.asarray(w)}}
    _, je, _ = jx_moe._route(jp, jcfg, jnp.asarray(x))
    _, e, _ = moe._route(_params(jp), tcfg, torch.as_tensor(x))
    assert np.array_equal(e.numpy(), np.asarray(je))
    assert (e[:, 0] == 2).all()
    if top_k > 1:
        assert (e[:, 1] == 5).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T", [24, 4200])
def test_moe_gather_and_local_paths(dtype, T):
    """T * k = 48 takes the gather path, 8,400 the local path."""
    jcfg, cfg, jp, p = _moe_params(dtype, seed=T)
    jx, tx = _x((1, T, 64), T, dtype)
    jout, jaux = jx_moe.moe(jp, jcfg, jx)
    out, aux = moe.moe(p, cfg, tx)
    _close(out, jout, dtype)
    _close(aux, jaux, "f32")
    xt = tx.reshape(T, 64)
    g, e, _ = moe._route(p, cfg, xt)
    want = (jx_moe._experts_gather if T * 2 <= 8192
            else jx_moe._experts_local)(jp, jcfg, jx.reshape(T, 64),
                                        jnp.asarray(_np(g)).astype(
                                            DTYPES[dtype][0]),
                                        jnp.asarray(e.numpy()))
    fn = moe._experts_gather if T * 2 <= 8192 else moe._experts_local
    _close(fn(p, cfg, xt, g, e), want, dtype)


def test_moe_local_path_equals_gather_path():
    """The two dropless paths compute the same function."""
    _, cfg, _, p = _moe_params("f32", seed=3)
    _, tx = _x((500, 64), 9, "f32")
    g, e, _ = moe._route(p, cfg, tx)
    torch.testing.assert_close(moe._experts_local(p, cfg, tx, g, e),
                               moe._experts_gather(p, cfg, tx, g, e),
                               rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------- the ep path

EP_MESHES = {"2x4": ((2, 4), ("data", "model")), "8": ((8,), ("model",)),
             "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
EP_T = 512               # direct _experts_ep: 64 tokens a lane
MOE_EP_T = 4224          # moe(): T * k > 8192, T % 8 == 0

EP_REFERENCE = """
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.models import moe as M

    d = sys.argv[1]
    spec = json.load(open(f"{d}/spec.json"))
    z = np.load(f"{d}/in.npz")
    cfg = M.MoEConfig(**spec["cfg"])
    p = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("w_")}
    p["router"] = {"w": jnp.asarray(z["router"])}
    p["shared"] = {n: {"w": jnp.asarray(z["shared_" + n])}
                   for n in ("gate", "up", "down")}
    out = {}
    for name, (sizes, axes) in spec["meshes"].items():
        devs = np.array(jax.devices()[:int(np.prod(sizes))])
        mesh = Mesh(devs.reshape(sizes), tuple(axes))
        out["ep_" + name] = np.asarray(jax.jit(
            lambda x, g, e: M._experts_ep(p, cfg, x, g, e, mesh))(
            z["x"], z["gates"], z["experts"]))
        ecfg = M.MoEConfig(**dict(spec["cfg"], path="ep"))
        o, aux = jax.jit(lambda x: M.moe(p, ecfg, x, mesh=mesh))(
            z["x_moe"])
        out["moe_" + name] = np.asarray(o)
        out["aux_" + name] = np.asarray(aux)
    np.savez(f"{d}/ref.npz", **out)
    print("OK", jax.device_count())
"""


@pytest.fixture(scope="module")
def ep_case(tmp_path_factory):
    """Inputs, and the reference's ep outputs on 8 forced host devices
    (one subprocess)."""
    d = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(11)
    E, dm, f, k = MOE["n_experts"], MOE["d_model"], MOE["d_ff_expert"], 2
    arrays = {
        "router": rng.standard_normal((dm, E)) * dm ** -0.5,
        "w_w_gate": rng.standard_normal((E, dm, f)) * dm ** -0.5,
        "w_w_up": rng.standard_normal((E, dm, f)) * dm ** -0.5,
        "w_w_down": rng.standard_normal((E, f, dm)) * f ** -0.5,
        "shared_gate": rng.standard_normal((dm, f)) * dm ** -0.5,
        "shared_up": rng.standard_normal((dm, f)) * dm ** -0.5,
        "shared_down": rng.standard_normal((f, dm)) * f ** -0.5,
        "x": rng.standard_normal((EP_T, dm)),
        "x_moe": rng.standard_normal((1, MOE_EP_T, dm)),
    }
    arrays = {n: a.astype(np.float32) for n, a in arrays.items()}
    # skewed routing: expert 0 is every token's first choice, so its
    # bucket overflows the capacity and drops pairs
    experts = np.stack([np.zeros(EP_T, np.int64),
                        rng.integers(1, E, EP_T)], 1).astype(np.int32)
    gates = rng.random((EP_T, k)).astype(np.float32)
    np.savez(d / "in.npz", experts=experts, gates=gates, **arrays)
    spec = {"cfg": MOE,
            "meshes": {n: [list(s), list(a)]
                       for n, (s, a) in EP_MESHES.items()}}
    (d / "spec.json").write_text(json.dumps(spec))
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", ""),
           "HOME": str(d), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(EP_REFERENCE), str(d)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK 8" in out.stdout
    z = np.load(d / "in.npz")
    params = {"router": {"w": torch.as_tensor(z["router"])},
              "shared": {n: {"w": torch.as_tensor(z["shared_" + n])}
                         for n in ("gate", "up", "down")}}
    for n in ("w_gate", "w_up", "w_down"):
        params[n] = torch.as_tensor(z["w_" + n])
    return {"in": z, "ref": np.load(d / "ref.npz"), "params": params}


@pytest.mark.parametrize("mesh", sorted(EP_MESHES))
def test_experts_ep_matches_the_reference(ep_case, mesh):
    sizes, axes = EP_MESHES[mesh]
    z = ep_case["in"]
    cfg = moe.MoEConfig(**MOE)
    got = moe._experts_ep(ep_case["params"], cfg, torch.as_tensor(z["x"]),
                          torch.as_tensor(z["gates"]),
                          torch.as_tensor(z["experts"]),
                          pmesh.Mesh(sizes, axes))
    want = ep_case["ref"]["ep_" + mesh]
    _close(got, want, "f32")
    # the capacity dropped pairs: the answer is not the dropless one
    dropless = moe._experts_local(ep_case["params"], cfg,
                                  torch.as_tensor(z["x"]),
                                  torch.as_tensor(z["gates"]),
                                  torch.as_tensor(z["experts"]))
    assert not torch.allclose(got, dropless, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mesh", sorted(EP_MESHES))
def test_moe_takes_the_ep_path_on_a_mesh(ep_case, mesh, monkeypatch):
    sizes, axes = EP_MESHES[mesh]
    cfg = moe.MoEConfig(**dict(MOE, path="ep"))
    taken = []
    real = moe._experts_ep
    monkeypatch.setattr(moe, "_experts_ep",
                        lambda *a: taken.append(1) or real(*a))
    out, aux = moe.moe(ep_case["params"], cfg,
                       torch.as_tensor(ep_case["in"]["x_moe"]),
                       mesh=pmesh.Mesh(sizes, axes))
    assert taken == [1]
    _close(out, ep_case["ref"]["moe_" + mesh], "f32")
    _close(aux, ep_case["ref"]["aux_" + mesh], "f32")


# ----------------------------------------------- dist.sharding, model half

SPEC_MESHES = {"dm": ((1, 1), ("data", "model")),
               "pdm": ((1, 1, 1), ("pod", "data", "model")),
               "m": ((1,), ("model",))}
ENTRIES = [(), ("batch", None, "embed"), ("stack", "fsdp", "heads"),
           ("batch", "seq_model", "embed"), ("rows",), ("vocab", "fsdp"),
           ("expert", "fsdp", None), ("data", "model"), ("batch", "data"),
           (None, "batch", "longseq", "kv_heads", None)]


def _meshes(name):
    sizes, axes = SPEC_MESHES[name]
    return jax.make_mesh(sizes, axes), pmesh.Mesh(sizes, axes)


@pytest.mark.parametrize("mesh", sorted(SPEC_MESHES))
def test_named_sharding_is_the_references_spec(mesh):
    jm, m = _meshes(mesh)
    for e in ENTRIES:
        assert sharding.named_sharding(m, *e) == \
            tuple(jx_sharding.named_sharding(jm, *e).spec)


@pytest.mark.parametrize("mesh", sorted(SPEC_MESHES))
def test_spec_tree_to_shardings_keeps_the_tree(mesh):
    from repro.models import transformer as JT
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    jm, m = _meshes(mesh)
    for arch in ("gemma3-27b", "deepseek-v2-236b"):
        cfg = get_arch(arch).make_config()
        for tree in (T.param_specs(cfg), T.cache_specs(cfg, False, 16)):
            got = sharding.spec_tree_to_shardings(tree, m)
            want = jax.tree.map(
                lambda s: tuple(s.spec),
                jx_sharding.spec_tree_to_shardings(tree, jm))
            assert jax.tree.structure(got) == jax.tree.structure(want)
            assert jax.tree.leaves(got) == jax.tree.leaves(want)
    assert sharding.spec_tree_to_shardings(None, m) is None


def test_constrain_returns_its_input():
    x = torch.arange(12.0).reshape(3, 4)
    for m in (None, pmesh.Mesh((2, 4), ("data", "model"))):
        assert sharding.constrain(x, m, "batch", "embed") is x


def test_is_axes_leaf():
    for x in ((), ("a", None), (None,)):
        assert sharding.is_axes_leaf(x) == jx_sharding.is_axes_leaf(x)
        assert sharding.is_axes_leaf(x)
    for x in ((("a",), ("b",)), ["a"], "a", None, ("a", 1)):
        assert sharding.is_axes_leaf(x) == jx_sharding.is_axes_leaf(x)
        assert not sharding.is_axes_leaf(x)
