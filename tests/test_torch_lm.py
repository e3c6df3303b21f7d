"""The port's LM serving path (``repro_torch.configs``,
``repro_torch.models.transformer``) against the JAX package's, on the
five LM smoke configs.

The reference draws its weights (``init(PRNGKey(0))``); they carry into
the port through ``convert.lm_params_from_reference``, and both packages
run the same numpy tokens.  Per config:

  * ``init``'s tree of shapes and dtypes, ``param_specs`` and
    ``cache_specs`` equal the reference's;
  * ``forward`` (hidden and aux loss), ``prefill_step`` (last logits and
    caches) on a 32-token prompt, then 3 ``serve_step`` calls from the
    reference's prefill caches copied into a 40-slot cache (gemma3's
    16-slot ring wraps) match the reference: fp32 within rtol = 1e-5,
    atol = 1e-4 (the logits reach ~60; the observed gap is ~1e-5);
  * the port alone: prefill equals stepwise decode within the reference's
    own tolerance, rtol = atol = 2e-2
    (``tests/test_models_smoke.py::test_lm_prefill_matches_decode``).

And the registry: every field of ``make_config()`` and
``make_smoke_config()`` equals the reference's (jnp dtypes mapped to
torch's), ``all_cells()`` gives the reference's LM rows, and the five
archs of other families are refused as not yet ported.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jx_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import (caches_from_reference,  # noqa: E402
                                 lm_params_from_reference)
from repro_torch.models import transformer as T  # noqa: E402

LM_ARCHS = ["gemma3-27b", "phi4-mini-3.8b", "qwen1.5-32b",
            "moonshot-v1-16b-a3b", "deepseek-v2-236b"]
# The reference's archs of the families this slice does not port.
NOT_PORTED = {"pna", "dcn-v2", "dlrm-mlperf", "fm", "bert4rec"}
RTOL, ATOL = 1e-5, 1e-4
B, S, MAX_SEQ, STEPS = 2, 32, 40, 3
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _copy_into(cache_shapes, prefill_caches):
    """The reference's prefill caches written into zeroed caches of
    ``cache_shapes`` (slots [0, S), or the whole ring)."""
    out = []
    for shapes, run in zip(cache_shapes, prefill_caches):
        pair = []
        for shape, c in zip(shapes, run):
            z = np.zeros(shape, np.asarray(c).dtype)
            z[:, :, :c.shape[2]] = np.asarray(c)
            pair.append(z)
        out.append(tuple(pair))
    return out


@pytest.fixture(scope="module", params=LM_ARCHS)
def case(request):
    """Both packages' outputs on one smoke config (computed once)."""
    arch = request.param
    jcfg = jx_registry.get_arch(arch).make_smoke_config()
    cfg = registry.get_arch(arch).make_smoke_config()
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + STEPS))
    toks = toks.astype(np.int32)
    prompt, nxt = toks[:, :S], toks[:, S:]
    out = {"arch": arch, "jcfg": jcfg, "cfg": cfg, "jp": jp,
           "params": params}
    out["ref_fwd"] = JT.forward(jp, jcfg, jnp.asarray(prompt))
    out["fwd"] = T.forward(params, cfg, torch.as_tensor(prompt))
    jl, jc = JT.prefill_step(jp, jcfg, jnp.asarray(prompt))
    out["ref_prefill"] = (jl, jc)
    out["prefill"] = T.prefill_step(params, cfg, torch.as_tensor(prompt))
    shapes = [tuple(c.shape for c in run)
              for run in JT.init_cache(jcfg, B, MAX_SEQ)]
    start = _copy_into(shapes, jc)
    step = jax.jit(lambda p, t, c, n: JT.serve_step(p, jcfg, t, c, n))
    ref_caches = [tuple(jnp.asarray(c) for c in run) for run in start]
    caches = caches_from_reference(start, device="cpu")
    out["steps"] = []
    for t in range(STEPS):
        tok = nxt[:, t:t + 1]
        rl, ref_caches = step(jp, jnp.asarray(tok), ref_caches,
                              jnp.int32(S + t))
        got, caches = T.serve_step(params, cfg, torch.as_tensor(tok),
                                   caches, S + t)
        out["steps"].append((got.clone(), rl))
    out["caches"] = (caches, ref_caches)
    return out


def test_init_tree_shapes_and_dtypes(case):
    want = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0),
                                          case["jcfg"]))
    got = T.init(0, case["cfg"], device="cpu")
    want_leaves, want_tree = jax.tree.flatten(want)
    got_leaves, got_tree = jax.tree.flatten(got)
    assert got_tree == want_tree
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == DTYPES[w.dtype.type]
        assert g.device.type == "cpu"


def test_param_and_cache_specs_equal_the_references(case):
    cfg, jcfg = case["cfg"], case["jcfg"]
    assert T.param_specs(cfg) == JT.param_specs(jcfg)
    for shard_seq in (False, True):
        for shards in (1, 3, 16):
            assert (T.cache_specs(cfg, shard_seq, shards)
                    == JT.cache_specs(jcfg, shard_seq, shards))


def test_params_carry_across_leaf_for_leaf(case):
    want = jax.tree.leaves(case["jp"])
    got = jax.tree.leaves(case["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def test_forward_matches_the_reference(case):
    (h, aux), (jh, jaux) = case["fwd"], case["ref_fwd"]
    assert h.dtype == torch.float32 and h.shape == jh.shape
    _close(h, jh)
    _close(aux, jaux)


def test_prefill_logits_and_caches_match_the_reference(case):
    (logits, caches), (jl, jc) = case["prefill"], case["ref_prefill"]
    assert logits.shape == (B, case["cfg"].vocab)
    _close(logits, jl)
    assert len(caches) == len(jc)
    for run, jrun in zip(caches, jc):
        for c, jc_ in zip(run, jrun):
            assert tuple(c.shape) == jc_.shape
            _close(c, jc_)


def test_serve_steps_match_the_reference(case):
    for got, want in case["steps"]:
        assert torch.isfinite(got).all()
        _close(got, want)
    caches, ref = case["caches"]
    for run, jrun in zip(caches, ref):
        for c, jc in zip(run, jrun):
            _close(c, jc)


def test_forward_on_a_stacked_mesh_equals_no_mesh(case):
    """On a (2, 4) stacked mesh the embedding is looked up lane by lane
    (``sharded_embed_lookup``); the annotations place nothing, so the
    hidden states equal the meshless forward's bit for bit."""
    from repro_torch.dist.mesh import Mesh

    toks = torch.as_tensor(
        np.random.default_rng(3).integers(0, case["cfg"].vocab, (2, 8)))
    got, _ = T.forward(case["params"], case["cfg"], toks,
                       mesh=Mesh((2, 4), ("data", "model")))
    want, _ = T.forward(case["params"], case["cfg"], toks)
    assert torch.equal(got, want)


def test_prefill_equals_stepwise_decode(case):
    """The port alone, as the reference's own test checks itself."""
    cfg = case["cfg"]
    n = cfg.window * 2 if cfg.window else 8
    params = T.init(1, cfg, device="cpu")
    toks = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab, (1, n)))
    logits_pre, _ = T.prefill_step(params, cfg, toks)
    caches = T.init_cache(cfg, 1, n, device="cpu")
    for t in range(n):
        logits_step, caches = T.serve_step(params, cfg, toks[:, t:t + 1],
                                           caches, t)
    torch.testing.assert_close(logits_pre, logits_step, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("entry", ["forward", "prefill_step", "serve_step",
                                   "moe"])
def test_entry_points_accumulate_bf16_in_fp32(entry, monkeypatch):
    """Each LM entry point runs with cuBLAS's bf16 reduced-precision
    reductions off (the reference accumulates bf16 products in fp32) and
    gives the caller's setting back."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    flag = torch.backends.cuda.matmul
    seen = []
    rmsnorm, route = L.rmsnorm, M._route

    def spy(fn):
        def wrapped(*args, **kw):
            seen.append(flag.allow_bf16_reduced_precision_reduction)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(L, "rmsnorm", spy(rmsnorm))
    monkeypatch.setattr(M, "_route", spy(route))
    monkeypatch.setattr(flag, "allow_bf16_reduced_precision_reduction",
                        True)
    cfg = registry.get_arch("moonshot-v1-16b-a3b").make_smoke_config()
    toks = torch.as_tensor(
        np.random.default_rng(4).integers(0, cfg.vocab, (1, 4)))
    if entry == "moe":
        mcfg = cfg.moe_config()
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((1, 4, cfg.d_model), generator=gen)
        M.moe(M.init_moe(gen, mcfg, torch.float32), mcfg, x)
    else:
        params = T.init(0, cfg, device="cpu")
        if entry == "serve_step":
            T.serve_step(params, cfg, toks[:, :1],
                         T.init_cache(cfg, 1, 4, device="cpu"), 0)
        else:
            getattr(T, entry)(params, cfg, toks)
    assert seen and not any(seen)
    assert flag.allow_bf16_reduced_precision_reduction


# ------------------------------------------------------------- registry

def _fields(c):
    out = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("which", ["make_config", "make_smoke_config"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_fields_equal_the_references(arch, which):
    got = _fields(getattr(registry.get_arch(arch), which)())
    want = _fields(getattr(jx_registry.get_arch(arch), which)())
    assert DTYPES[want.pop("dtype")] == got.pop("dtype")
    assert got == want


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_arch_spec_equals_the_references(arch):
    got, want = registry.get_arch(arch), jx_registry.get_arch(arch)
    for name in ("arch_id", "family", "shapes", "skips", "notes"):
        assert getattr(got, name) == getattr(want, name)
    assert got.make_config().runs() == want.make_config().runs()


def test_all_cells_are_the_references_lm_rows():
    want = [c for c in jx_registry.all_cells() if c[0] in LM_ARCHS]
    assert registry.all_cells() == want
    assert set(registry.all_archs()) == set(LM_ARCHS)
    assert NOT_PORTED == set(jx_registry.all_archs()) - set(LM_ARCHS)
    assert set(registry.NOT_PORTED) == NOT_PORTED


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_unported_archs_are_refused_by_name(arch):
    with pytest.raises(KeyError, match="not ported yet"):
        registry.get_arch(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")


def test_shapes_are_the_references():
    from repro.configs import shapes as jx_shapes
    from repro_torch.configs import shapes

    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        assert getattr(shapes, name) == getattr(jx_shapes, name)
    for fanout in ((15, 10), (5,), ()):
        assert (shapes.subgraph_budget(1024, fanout)
                == jx_shapes.subgraph_budget(1024, fanout))

