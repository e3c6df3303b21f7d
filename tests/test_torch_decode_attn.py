"""Kernel 7 of the port, single-token GQA decode attention
(``repro_torch.kernels.decode_attn``), against the JAX package on the same
numpy inputs.  The reference's Pallas kernel runs in interpret mode on the
CPU (as ``tests/test_kernels.py`` runs it); the port runs the kernel's plain
version, which is what its wrapper does with CPU tensors.

Tolerance: rtol=1e-5, atol=1e-5 in float32 (``tests/test_kernels.py`` uses
the same): the dot products are summed in another order.  In bf16 the
output may differ by one unit in the last place.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import decode_attention as jx_decode  # noqa: E402
from repro.kernels.decode_attn import decode_attention_ref as jx_ref  # noqa: E402
from repro_torch.kernels.decode_attn import (decode_attention,  # noqa: E402
                                             decode_attention_kernel,
                                             decode_attention_plain,
                                             decode_attention_ref)

RTOL, ATOL = 1e-5, 1e-5


def _case(seed, B=4, H=8, KV=2, S=257, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("bs", [64, 512])
def test_matches_reference_kernel(bs):
    """S = 257 with bs = 64 pads the cache to 320 rows; H / KV = 4; length
    0 averages v over the padded length, as the reference does."""
    q, k, v = _case(0)
    lengths = np.array([0, 1, 100, 257], np.int32)
    want = np.asarray(jx_decode(q, k, v, jnp.asarray(lengths), bs=bs,
                                interpret=True))
    got = decode_attention(q, k, v, lengths, bs=bs, device="cpu")
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_lengths_default_to_the_whole_cache():
    q, k, v = _case(1, B=2, H=6, KV=3, S=130)
    want = np.asarray(jx_decode(q, k, v, bs=64, interpret=True))
    got = decode_attention(q, k, v, bs=64, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bfloat16_within_one_ulp_of_the_reference():
    q, k, v = _case(2, S=100)
    lengths = np.array([3, 50, 99, 100], np.int32)
    bf = jnp.bfloat16
    want = jx_decode(jnp.asarray(q, bf), jnp.asarray(k, bf),
                     jnp.asarray(v, bf), jnp.asarray(lengths), bs=32,
                     interpret=True)
    t = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    got = decode_attention(t(q), t(k), t(v), lengths, bs=32)
    assert got.dtype == torch.bfloat16
    g = got.to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    assert (np.abs(g - w) <= ulp).all()


def test_oracle_matches_reference_oracle_per_kv_head():
    q, k, v = _case(3, S=90)
    lengths = np.array([1, 40, 89, 90], np.int32)
    B, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, dh)
    for h in range(KV):
        want = np.asarray(jx_ref(jnp.asarray(qg[:, h]), jnp.asarray(k[:, :, h]),
                                 jnp.asarray(v[:, :, h]),
                                 jnp.asarray(lengths)))
        got = decode_attention_ref(torch.as_tensor(qg[:, h]),
                                   torch.as_tensor(k[:, :, h]),
                                   torch.as_tensor(v[:, :, h]),
                                   torch.as_tensor(lengths))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        blocked = decode_attention_plain(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            torch.as_tensor(lengths), bs=32).reshape(B, KV, -1, dh)[:, h]
        np.testing.assert_allclose(blocked.numpy(), want, rtol=RTOL,
                                   atol=ATOL)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    q, k, v = (torch.as_tensor(a) for a in _case(4, S=20))
    lengths = torch.full((4,), 20, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(q, k, v, lengths, bs=8)
    assert decode_attention_kernel.launches == 0
    with pytest.raises(ValueError, match="group"):
        decode_attention(q[:, :7], k, v, lengths)


def test_heads_per_launch_is_the_kernels_contract():
    """Groups of query heads fit one block (G * dh <= 2,048 outputs,
    shared memory <= 232,448 bytes); only a head that alone needs more
    shared memory is refused."""
    from repro_torch.kernels.decode_attn.decode_attn import (
        SMEM_LIMIT, heads_per_launch, smem_bytes)

    assert heads_per_launch(3, 128, 512) == 3          # phi-4-mini
    assert heads_per_launch(17, 128, 512) == 16
    assert heads_per_launch(40, 64, 16) == 32
    for G, dh, bs in [(64, 32, 4096), (200, 8, 512), (8, 512, 2048)]:
        g = heads_per_launch(G, dh, bs)
        assert 1 <= g <= G and g * dh <= 2048
        assert smem_bytes(g, dh, bs) <= SMEM_LIMIT
        assert g == G or smem_bytes(g + 1, dh, bs) > SMEM_LIMIT \
            or (g + 1) * dh > 2048
    with pytest.raises(ValueError, match="232448"):
        heads_per_launch(1, 1024, 512)
    with pytest.raises(ValueError, match="shared memory"):
        heads_per_launch(2, 128, 60000)
