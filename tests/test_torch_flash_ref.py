"""The port's plain flash-attention versions against the JAX package's.

Same numpy inputs (fixed seed) through ``repro.kernels.ref`` /
``repro.kernels.ops`` and ``repro_torch.kernels.ref`` /
``repro_torch.kernels.ops``; f32 on the CPU, tolerance 1e-5 (the same
online softmax in f32, differing only in summation order). The sweep
covers causal and non-causal attention, Sq < Skv (queries are the last Sq
positions), GQA 15/5 (smollm's grouping), several K/V blocks, and the
Pallas kernel itself in interpret mode. Both ops refuse an Skv over 256
that is not a multiple of 256 (the reference's length contract, which the
port keeps on purpose). The CUDA kernel runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5

# (B, Sq, Skv, H, KVH, D, causal, chunk_kv)
CASES = [
    (2, 16, 16, 15, 5, 16, True, 8),      # GQA 15/5, two K/V blocks
    (1, 8, 24, 6, 2, 16, True, 8),        # Sq < Skv, three blocks
    (2, 12, 40, 4, 4, 8, False, 8),       # non-causal, MHA
    (1, 24, 24, 15, 5, 8, False, 512),    # non-causal GQA, one block
    (2, 64, 256, 6, 2, 8, True, 64),      # Sq < Skv over four blocks
]


def _inputs(b, sq, skv, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,chunk", CASES)
def test_flash_ref_matches_jax(b, sq, skv, h, kvh, d, causal, chunk):
    q, k, v = _inputs(b, sq, skv, h, kvh, d, seed=sq + skv)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = np.asarray(jref.flash_attention_chunked(
        jq, jk, jv, causal=causal, chunk_kv=chunk))
    got = ref.flash_attention_chunked(tq, tk, tv, causal=causal,
                                      chunk_kv=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    naive_j = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    naive_t = ref.flash_attention_ref(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(naive_t, naive_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, naive_t, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal", [
    (1, 16, 16, 15, 5, 16, True),
    (2, 64, 128, 6, 2, 16, True),
    (1, 32, 64, 4, 2, 8, False),
])
def test_flash_op_matches_pallas_interpret(b, sq, skv, h, kvh, d, causal):
    """The port's op on CPU tensors against the Pallas kernel itself,
    interpreted (the JAX package's own kernel tests run it so)."""
    q, k, v = _inputs(b, sq, skv, h, kvh, d, seed=7 + sq)
    want = np.asarray(jops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        impl="pallas_interpret"))
    before = dict(fk.LAUNCHES)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert fk.LAUNCHES == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("skv", [300, 704])
def test_both_ops_refuse_lengths_the_reference_refuses(skv):
    """Skv > 256 and not a multiple of 256: the JAX reference asserts
    (``ref.py`` ``flash_attention_chunked``), so the port's op raises
    ValueError for the same input instead of serving a length the
    reference cannot; 512 passes in both."""
    q, k, v = _inputs(1, skv, skv, 3, 1, 8, seed=skv)
    with pytest.raises(AssertionError):
        jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                             impl="xla_chunked")
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    q, k, v = _inputs(1, 512, 512, 3, 1, 8, seed=512)
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           impl="xla_chunked"))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_flash_kernel_wrapper_refuses_cpu_and_bad_shapes():
    """The kernel wrapper takes CUDA tensors only (never a quiet detour
    through the plain version) and refuses what the kernel does not take."""
    q = torch.zeros(1, 15, 8, 64)
    kv = torch.zeros(1, 5, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_bhsd(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_bhsd(torch.zeros(1, 15, 8, 48),
                                torch.zeros(1, 5, 8, 48),
                                torch.zeros(1, 5, 8, 48))
    with pytest.raises(ValueError, match="Sq <= Skv"):
        fk.flash_attention_bhsd(torch.zeros(1, 15, 9, 64), kv, kv)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                            kv.transpose(1, 2), impl="pallas")
