"""The flash backward's plain versions and the autograd Function that runs
the backward kernel on the card, against the JAX package, on the CPU.

The JAX package has no backward kernel: it trains by differentiating its
chunked flash attention (``repro.kernels.ref.flash_attention_chunked``).
So JAX's gradients are ``jax.vjp`` of that function, and the port's are
the formulas the backward kernel runs (``ref.flash_attention_bwd``: P from
the forward's logsumexp, dS = P (dP - rowsum(dO o))). Inputs come from
numpy seeds; everything runs in f32.

* ``ref.flash_attention_lse`` gives JAX's output and the rows' logsumexp
  (a numpy logsumexp of the scaled, masked scores) within 2e-5, and
  ``ref.flash_attention_bwd`` JAX's q, k and v gradients within 2e-5 of
  each gradient's largest magnitude: causal with Sq = Skv and Sq < Skv,
  non-causal with Sq != Skv (cross attention), groups 1, 3 and 6, head
  dims 64, 80 and 128, K/V blocks that divide Skv and a ragged last one.
* ``gradcheck`` of ``ops.FlashAttentionFunction`` in f64 with the plain
  forward and backward standing in for the kernels (``ops.flash_plain``),
  grouped and causal with Sq < Skv.
* The parameter gradients of reduced smollm-360m's and whisper-tiny's
  losses with ``ops.flash_attention`` routed through the Function and the
  plain stand-ins, as the card routes it through the kernels, against
  ``jax.grad`` of the JAX loss on the same weights (``params_from_jax``):
  within 5e-4 relative, the bound of ``tests/test_torch_train.py``.
* The backward kernel's wrapper refuses CPU tensors and mismatched
  statistics before any launch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.common import all_f64, flatten_tree, unflatten_tree  # noqa: E402
from repro_torch.train.step import _loss_and_grads  # noqa: E402

TOL = 2e-5

# (B, Sq, Skv, H, KVH, D, causal, JAX's chunk, the plain backward's block)
CASES = {
    "causal G1 D64": (2, 32, 32, 2, 2, 64, True, 16, 16),
    "causal G3 D80": (2, 24, 24, 6, 2, 80, True, 24, 10),
    "causal G6 D128": (1, 16, 16, 6, 1, 128, True, 8, 16),
    "causal Sq<Skv G3": (2, 12, 40, 3, 1, 64, True, 20, 16),
    "cross G1 D64": (2, 9, 40, 2, 2, 64, False, 40, 12),
    "non-causal G6 D80": (1, 20, 20, 6, 1, 80, False, 10, 20),
}


def _inputs(b, sq, skv, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _lse_np(q, k, causal):
    """Each row's logsumexp of its scaled, masked scores, (B, H, Sq)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), h // kvh, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * d ** -0.5
    if causal:
        ok = np.arange(skv)[None, :] <= np.arange(sq)[:, None] + (skv - sq)
        s = np.where(ok, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp(case):
    b, sq, skv, h, kvh, d, causal, chunk, block = CASES[case]
    q, k, v, do = _inputs(b, sq, skv, h, kvh, d, seed=len(case))
    jout, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_chunked(
        q, k, v, causal=causal, chunk_kv=chunk), *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = ref.flash_attention_lse(*t[:3], causal=causal, chunk_kv=chunk)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert _gap(out, jout) <= TOL
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, k, causal),
                               atol=TOL, rtol=0)
    grads = ref.flash_attention_bwd(*t[:3], out, t[3], lse, causal=causal,
                                    block_kv=block)
    for name, got, want in zip("qkv", grads, jgrads):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _gap(got, want) <= TOL, f"d{name}"


@pytest.mark.parametrize("sq,skv,causal,block", [(6, 10, True, 5),
                                                 (8, 8, True, 4),
                                                 (5, 9, False, 3)])
def test_function_gradcheck_with_plain_stand_ins(sq, skv, causal, block):
    g = torch.Generator().manual_seed(9)
    q = torch.randn(2, sq, 6, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn(2, skv, 2, 8, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    fn = lambda q, k, v: ops.FlashAttentionFunction.apply(  # noqa: E731
        q, k, v, causal, None, *ops.flash_plain(block))
    with all_f64():
        assert torch.autograd.gradcheck(fn, (q, k, v))


def _routed(calls):
    """``ops.flash_attention`` through the Function and the plain pair."""
    def flash_attention(q, k, v, *, causal=True, scale=None, impl="auto",
                        block_kv=ops.FLASH_BLOCK_KV):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return ops.FlashAttentionFunction.apply(q, k, v, causal, scale,
                                                *ops.flash_plain(block_kv))
    return flash_attention


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-tiny"])
def test_loss_gradients_through_the_function_match_jax(arch, monkeypatch):
    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = reduced(ARCHS[arch])
        jmodel = jbuild(jreduced(JARCHS[arch]))
        jparams = jax.jit(jmodel.init)(jax.random.key(0))
        batch = _batch(cfg, 2, 32, seed=4)
        _, jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        calls = []
        monkeypatch.setattr(ops, "flash_attention", _routed(calls))
        _, _, grads = _loss_and_grads(model, unflatten_tree(state),
                                      {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    finally:
        torch.set_num_threads(n)
    # every attention of the step went through the Function: smollm's
    # self attention, in the forward and again in each layer's
    # checkpointed recompute; whisper's decoder self attention, encoder
    # and cross attention (not rematerialized)
    assert len(calls) == cfg.num_layers * (3 if arch == "whisper-tiny"
                                           else 2)
    if arch == "whisper-tiny":
        assert {c for _, _, c in calls} == {True, False}
    want = flatten_tree(jax.tree.map(np.asarray, jgrads))
    got = flatten_tree(grads)
    assert got.keys() == want.keys()
    for name in want:
        a = np.asarray(got[name], np.float64)
        b = np.asarray(want[name], np.float64)
        assert np.linalg.norm(a - b) <= 5e-4 * np.linalg.norm(b), name


def test_backward_wrapper_refuses_cpu_and_bad_statistics():
    q = torch.zeros(1, 6, 8, 64)
    kv = torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(1, 6, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fk.flash_attention_bwd(q, kv, kv, q, q, lse)
    with pytest.raises(ValueError, match="lse must be"):
        fk.flash_attention_bwd(q, kv, kv, q, q, lse[..., :4])
    with pytest.raises(ValueError, match="dout must be"):
        fk.flash_attention_bwd(q, kv, kv, q, q.double(), lse)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention_bwd(q[..., :48], kv[..., :48], kv[..., :48],
                               q[..., :48], q[..., :48], lse)
