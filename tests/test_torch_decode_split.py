"""Kernel 7's split over the cache (``repro_torch.kernels.decode_attn``):
the plain version run with the kernel's partitions and combine
(``part_blocks``) against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs; and the contract of ``partitions``, which
picks the kernel's partitions.

S = 257 with bs = 32 is 9 blocks, not a whole number of them; lengths 0,
1, mid, S and S + 7, so that some partitions lie wholly past a length.
Tolerance: rtol=1e-5, atol=1e-5 in float32 (the partials are merged in
another order than the reference's one sequence); one unit in the last
place in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import decode_attention as jx_decode  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attention_plain  # noqa: E402
from repro_torch.kernels.decode_attn.decode_attn import (  # noqa: E402
    SLICE, WAVES, partitions)

B, H, KV, S, DH, BS = 5, 8, 2, 257, 16, 32
N_BLOCKS = -(-S // BS)                                  # 9
LENGTHS = np.array([0, 1, 130, S, S + 7], np.int32)
PART_BLOCKS = [1, 2, 3, N_BLOCKS, None]  # P = 9, 5 (last 1), 3, 1; sequence


def _inputs():
    rng = np.random.default_rng(17)
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    return q, k, v


@pytest.fixture(scope="module")
def fp32_case():
    q, k, v = _inputs()
    want = np.asarray(jx_decode(q, k, v, jnp.asarray(LENGTHS), bs=BS,
                                interpret=True))
    return (q, k, v), want


@pytest.fixture(scope="module")
def bf16_case():
    bf = jnp.bfloat16
    q, k, v = (np.array(jnp.asarray(a, bf).astype(jnp.float32))
               for a in _inputs())
    want = jx_decode(jnp.asarray(q, bf), jnp.asarray(k, bf),
                     jnp.asarray(v, bf), jnp.asarray(LENGTHS), bs=BS,
                     interpret=True)
    return (q, k, v), np.asarray(want, np.float32)


@pytest.mark.parametrize("part_blocks", PART_BLOCKS)
def test_partitions_match_reference_fp32(fp32_case, part_blocks):
    (q, k, v), want = fp32_case
    t = torch.as_tensor
    got = decode_attention_plain(t(q), t(k), t(v), t(LENGTHS), bs=BS,
                                 part_blocks=part_blocks)
    assert got.dtype == torch.float32 and got.shape == (B, H, DH)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("part_blocks", PART_BLOCKS)
def test_partitions_match_reference_bf16(bf16_case, part_blocks):
    (q, k, v), want = bf16_case
    t = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    got = decode_attention_plain(t(q), t(k), t(v), torch.as_tensor(LENGTHS),
                                 bs=BS, part_blocks=part_blocks)
    assert got.dtype == torch.bfloat16
    g = got.to(torch.float32).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(g - want) <= ulp).all()


SHAPES = [  # (B, KV, bs, S, n_sm, per_sm)
    (128, 8, 512, 32_768, 132, 5),      # phi-4-mini decode_32k
    (1, 16, 512, 524_288, 132, 5),      # gemma3-27b long_500k, B = 1
    (1, 1, 16, 40, 132, 8),             # fewer blocks than the waves want
    (65_537, 1, 16, 40, 132, 8),        # pairs past one batch slice
    (4, 4, 256, 2_048, 132, 5),
    (3, 2, 7, 1_000, 114, 3),
    (512, 8, 512, 32_768, 132, 5),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_partitions_contract(shape):
    """Whole blocks that cover n_blocks, no partition empty; 1 <= P <=
    n_blocks; P = 1 exactly where the pairs fill the waves; otherwise more
    than half the partitions the waves ask for; the same answer twice."""
    Bb, KVk, bs, Ss, n_sm, per_sm = shape
    n_blocks = -(-Ss // bs)
    part_blocks, P = partitions(*shape)
    assert 1 <= P <= n_blocks and 1 <= part_blocks <= n_blocks
    assert (P - 1) * part_blocks < n_blocks <= P * part_blocks
    pairs = min(Bb, SLICE) * KVk
    want = WAVES * n_sm * per_sm
    assert (P == 1) == (pairs >= want or n_blocks == 1)
    if pairs < want:
        target = min(n_blocks, -(-want // pairs))
        assert target / 2 < P <= target
    assert partitions(*shape) == (part_blocks, P)


def test_partitions_at_the_measured_shapes():
    """The choices the H100 run times (132 SMs, 5 blocks per SM)."""
    assert partitions(128, 8, 512, 32_768, 132, 5) == (6, 11)
    assert partitions(1, 16, 512, 524_288, 132, 5) == (2, 512)
    assert partitions(65_537, 1, 16, 40, 132, 8) == (3, 1)
