"""The port's plain paged-attention versions against the JAX oracles.

Same numpy inputs (fixed seed) through ``repro.kernels.ref`` and
``repro_torch.kernels.ref``; f32 on the CPU, tolerance 1e-5 (both compute
the same masked softmax in f32, differing only in summation order). The
sweep covers GQA group 1 and 3, page sizes 8 and 16, lengths 0..3 pages
(page boundaries +-1), dead rows, shuffled physical pages, and chunks with
``valid`` 0, partial and full. Also checks ``ops`` dispatch: CPU tensors go
to the plain versions, the kernel wrappers refuse CPU tensors (no silent
plain path), and int8 pools with scales take ``dequantize_pages`` and the
f32 plain versions (``test_torch_int8_ref.py`` holds them against the
Pallas int8 branch). The kernels themselves
run only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5
KVH, D, MP, P = 2, 16, 4, 20


def _pool(rng, page):
    k = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    v = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    return k, v


def _tables(rng, n):
    """n block-table rows of distinct shuffled physical pages (never 0)."""
    return np.stack([rng.permutation(np.arange(1, P))[:MP]
                     for _ in range(n)]).astype(np.int32)


def _both(fn_j, fn_t, *arrays, **kw):
    out_j = np.asarray(jax.jit(fn_j)(*[jnp.asarray(a) for a in arrays], **kw))
    out_t = fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    return out_j, out_t.numpy()


def _lengths(page):
    return np.array([0, 1, page - 1, page, page + 1, 2 * page + 3,
                     3 * page], np.int32)


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("group", [1, 3])
def test_paged_attention_ref_matches_jax(group, page):
    rng = np.random.default_rng(100 * group + page)
    k, v = _pool(rng, page)
    lengths = _lengths(page)
    q = rng.standard_normal((len(lengths), KVH * group, D)).astype(np.float32)
    bt = _tables(rng, len(lengths))
    oj, ot = _both(jref.paged_attention_ref, tref.paged_attention_ref,
                   q, k, v, bt, lengths)
    np.testing.assert_allclose(ot, oj, atol=TOL, rtol=TOL)
    assert (ot[0] == 0).all()  # length 0: exact zeros


@pytest.mark.parametrize("valid", ["zero", "partial", "full"])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("group", [1, 3])
def test_paged_prefill_attention_ref_matches_jax(group, page, valid):
    rng = np.random.default_rng(7 * group + page)
    k, v = _pool(rng, page)
    c = 8
    nvalid = {"zero": 0, "partial": 5, "full": c}[valid]
    bt = _tables(rng, 1)[0]
    q = rng.standard_normal((c, KVH * group, D)).astype(np.float32)
    # histories of 0, straddling a page boundary, and the last page
    for start in (0, page - 3, 2 * page + 1, MP * page - c):
        oj, ot = _both(
            jref.paged_prefill_attention_ref, tref.paged_prefill_attention_ref,
            q, k, v, bt, np.int32(start), np.int32(nvalid))
        np.testing.assert_allclose(ot, oj, atol=TOL, rtol=TOL)
        assert (ot[nvalid:] == 0).all()  # padded queries: exact zeros


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("group", [1, 3])
def test_paged_mixed_attention_ref_matches_jax(group, page):
    rng = np.random.default_rng(31 * group + page)
    k, v = _pool(rng, page)
    last_pos = np.concatenate([_lengths(page) - 1, [-1, 5, -1]]).astype(
        np.int32)
    r = len(last_pos)
    q = rng.standard_normal((r, KVH * group, D)).astype(np.float32)
    bt = _tables(rng, r)
    oj, ot = _both(jref.paged_mixed_attention_ref, tref.paged_mixed_attention_ref,
                   q, k, v, bt, last_pos)
    np.testing.assert_allclose(ot, oj, atol=TOL, rtol=TOL)
    assert (ot[last_pos < 0] == 0).all()  # dead rows: exact zeros


@pytest.mark.parametrize("valid", [0, 3, 8])
@pytest.mark.parametrize("group", [1, 3])
def test_mixed_split_matches_generic_and_jax_ops(group, valid):
    """The decode-rows + one-chunk evaluation under ``num_decode`` equals
    the generic mixed oracle and the JAX op's own split (ops.py:292-313)."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(group + valid)
    page, s, c, start = 8, 3, 8, 9
    k, v = _pool(rng, page)
    bt = _tables(rng, s + 1)
    tables = np.concatenate([bt[:s], np.repeat(bt[s:], c, axis=0)])
    last_pos = np.concatenate([
        [4, -1, 3 * page - 1],
        [start + i if i < valid else -1 for i in range(c)]]).astype(np.int32)
    q = rng.standard_normal((s + c, KVH * group, D)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, k, v, tables, last_pos)]
    split = tref.paged_mixed_attention_split_ref(*args, s).numpy()
    generic = tref.paged_mixed_attention_ref(*args).numpy()
    via_ops = ops.paged_mixed_attention(*args, num_decode=s).numpy()
    jax_split = np.asarray(jax.jit(functools.partial(
        jops.paged_mixed_attention, impl="xla_chunked", num_decode=s))(
        *[jnp.asarray(a) for a in (q, k, v, tables, last_pos)]))
    np.testing.assert_allclose(split, generic, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(via_ops, split)
    np.testing.assert_allclose(split, jax_split, atol=TOL, rtol=TOL)


def test_ops_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    k, v = _pool(rng, 8)
    q = rng.standard_normal((3, KVH * 3, D)).astype(np.float32)
    bt = _tables(rng, 3)
    lengths = np.array([0, 9, 17], np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, bt, lengths)]
    before = dict(pk.LAUNCHES)
    np.testing.assert_array_equal(
        ops.paged_attention(*args).numpy(),
        tref.paged_attention_ref(*args).numpy())
    np.testing.assert_array_equal(
        ops.paged_mixed_attention(*args[:4], args[4] - 1).numpy(),
        tref.paged_mixed_attention_ref(*args[:4], args[4] - 1).numpy())
    np.testing.assert_array_equal(
        ops.paged_prefill_attention(args[0], *args[1:3], args[3][0],
                                    torch.tensor(4), torch.tensor(3)).numpy(),
        tref.paged_prefill_attention_ref(args[0], *args[1:3], args[3][0],
                                         4, 3).numpy())
    assert pk.LAUNCHES == before  # no kernel launched for CPU tensors


def test_ops_refuse_what_is_not_ported():
    rng = np.random.default_rng(6)
    k, v = _pool(rng, 8)
    q = torch.from_numpy(rng.standard_normal((2, KVH, D)).astype(np.float32))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    bt = torch.from_numpy(_tables(rng, 2))
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    # int8 pages with scales (ROADMAP A.5, ported): the plain versions
    # over the dequantized pool, and no kernel launch for CPU tensors
    kq, ks = tref.quantize_kv(kt)
    vq, vs = tref.quantize_kv(vt)
    kd, vd = tref.dequantize_pages(kq, ks), tref.dequantize_pages(vq, vs)
    before = dict(pk.LAUNCHES)
    np.testing.assert_array_equal(
        ops.paged_attention(q, kq, vq, bt, lengths, k_scale=ks,
                            v_scale=vs).numpy(),
        tref.paged_attention_ref(q, kd, vd, bt, lengths).numpy())
    np.testing.assert_array_equal(
        ops.paged_mixed_attention(q, kq, vq, bt, lengths, k_scale=ks,
                                  v_scale=vs).numpy(),
        tref.paged_mixed_attention_ref(q, kd, vd, bt, lengths).numpy())
    np.testing.assert_array_equal(
        ops.paged_prefill_attention(q, kq, vq, bt[0], torch.tensor(4),
                                    torch.tensor(2), k_scale=ks,
                                    v_scale=vs).numpy(),
        tref.paged_prefill_attention_ref(q, kd, vd, bt[0], 4, 2).numpy())
    assert pk.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown impl"):
        ops.paged_attention(q, kt, vt, bt, lengths, impl="pallas")
    # the kernel wrappers take CUDA tensors only: a CPU tensor is an error,
    # never a quiet detour through the plain version
    with pytest.raises(ValueError, match="CUDA"):
        pk.paged_attention_bkgd(torch.zeros(2, KVH, 1, 64),
                                torch.zeros(P, 8, KVH, 64),
                                torch.zeros(P, 8, KVH, 64), bt, lengths)
    with pytest.raises(ValueError, match="head_dim"):
        pk.paged_mixed_attention_rkgd(
            torch.zeros(2, KVH, 1, 48), torch.zeros(P, 8, KVH, 48),
            torch.zeros(P, 8, KVH, 48), bt, lengths)
