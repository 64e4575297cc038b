"""The bf16 tensor-core SSD scan's roundings fit inside the card's 5e-2
bound, with a 2x margin.

``ssd_scan.cu``'s ``ssd_scan_mma_kernel`` (bf16 x, B and C) walks 64-token
sub-chunks and rounds where the plain versions do not. Its products take
bf16 operands with f32 sums: ``G = C B^T`` (exact products), ``M = G o
e^{cs_i - cs_j} dt_j`` (j <= i) rounded to bf16 once and multiplied by x
(exact), ``y_off = e^{cs_i} C state^T`` over a bf16 copy of the entering
state, and the update ``state' = e^{cs_last} state + xw^T B`` with ``xw =
x dt e^{cs_last - cs}`` rounded to bf16 once, accumulated into the f32
state, which is never rounded itself. ``_mma_scan`` emulates exactly that
in plain PyTorch on the CPU. On seeded numpy inputs at mamba2-1.3b's head
width (P 64, H cut to 4), N 128 and zamba2-2.7b's N 64, it stays within
2.5e-2 (atol and rtol) of the JAX package's Pallas kernel in interpret
mode and of the port's ``ref.ssd_chunked``, both in f32 on the same
inputs: one 64-token chunk from a carried state with a dt = 0 tail, S 200
from zero (a ragged end), and the engine's pattern, 7 chained 64-token
calls carrying the state against one call over 448 tokens, which shows
whether rounding compounds through the carried state. The card's own
check (``chip_smoke.py`` phase 10, ``tests/test_torch_kernels_cuda.py``)
adds the output's bf16 rounding, which the emulation includes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ssd_scan import scan_rows  # noqa: E402

Q = 64        # the kernel's sub-chunk
H, P = 4, 64  # mamba2-1.3b's head width, H cut from 64 for time
BOUND = 2.5e-2  # the card's bf16 bound 5e-2, halved


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _mma_scan(x, dt, A, Bm, Cm, init=None):
    """The tensor-core kernel's arithmetic: x (B, S, H, P), Bm/Cm (B, S, N)
    f32 holding bf16 values; dt (B, S, H), A (H,), init (B, H, P, N) f32.
    Returns (y (B, S, H, P) rounded to bf16 as the kernel stores it, the
    f32 final state)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    state = torch.zeros(b, h, p, n) if init is None else init.clone()
    ys = []
    for s0 in range(0, s, Q):
        q = min(Q, s - s0)
        pad = (0, 0, 0, Q - q)
        xs = torch.nn.functional.pad(x[:, s0:s0 + q], (0, 0) + pad)
        ds = torch.nn.functional.pad(dt[:, s0:s0 + q], pad)
        bs = torch.nn.functional.pad(Bm[:, s0:s0 + q], pad)
        cs_ = torch.nn.functional.pad(Cm[:, s0:s0 + q], pad)
        xh = xs.permute(0, 2, 1, 3)                       # (b, h, j, p)
        dth = ds.permute(0, 2, 1)                         # (b, h, j)
        cs = torch.cumsum(dth * A[None, :, None], -1)     # (b, h, i)
        g = cs_ @ bs.transpose(-1, -2)                    # (b, i, j)
        causal = torch.ones(Q, Q, dtype=torch.bool).tril()
        decay = torch.exp((cs[..., :, None] - cs[..., None, :])
                          .masked_fill(~causal, float("-inf")))
        m = _bf16(g[:, None] * decay * dth[..., None, :])  # (b, h, i, j)
        y_off = torch.exp(cs)[..., None] * (
            cs_[:, None] @ _bf16(state).transpose(-1, -2))  # (b, h, i, p)
        y = m @ xh + y_off
        ys.append(_bf16(y[:, :, :q]).permute(0, 2, 1, 3))
        xw = _bf16(xh * (dth * torch.exp(cs[..., -1:] - cs))[..., None])
        state = (torch.exp(cs[..., -1])[..., None, None] * state
                 + xw.transpose(-1, -2) @ bs[:, None])
    return torch.cat(ys, 1), state


def _inputs(seed, s, n, with_init, valid=None):
    """tests/test_kernels.py's SSD distribution, x, B and C rounded to
    bf16 (the kernel's inputs), as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, s, H, P)).astype(np.float32)
    dt = (0.1 + 0.9 * rng.random((1, s, H))).astype(np.float32)
    if valid is not None:
        dt[:, valid:] = 0.0
    A = (-1.0 * rng.random((H,)) - 0.1).astype(np.float32)
    Bm = (rng.standard_normal((1, s, n)) / np.sqrt(n)).astype(np.float32)
    Cm = (rng.standard_normal((1, s, n)) / np.sqrt(n)).astype(np.float32)
    x, Bm, Cm = (_bf16(torch.from_numpy(a)).numpy() for a in (x, Bm, Cm))
    h0 = (rng.standard_normal((1, H, P, n)).astype(np.float32)
          if with_init else None)
    return x, dt, A, Bm, Cm, h0


def _references(x, dt, A, Bm, Cm, h0):
    """(y, state) of the Pallas kernel in interpret mode and of
    ``ref.ssd_chunked`` (at the kernel's 64-token chunk, padded with dt =
    0 as ``ops.ssd_scan`` pads), both f32."""
    jy, jfs = jops.ssd_scan(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=Q,
        impl="pallas_interpret",
        init_state=None if h0 is None else jnp.asarray(h0))
    s = x.shape[1]
    pad = (-s) % Q
    t = [torch.nn.functional.pad(torch.from_numpy(a), (0, 0) * (a.ndim - 2)
                                 + (0, pad)) for a in (x, dt, Bm, Cm)]
    ry, rfs = ref.ssd_chunked(t[0], t[1], torch.from_numpy(A), t[2], t[3],
                              None if h0 is None else torch.from_numpy(h0),
                              chunk=Q)
    return {"pallas_interpret": (np.asarray(jy), np.asarray(jfs)),
            "ref.ssd_chunked": (ry[:, :s].numpy(), rfs.numpy())}


def _within(got, want, what):
    err = np.abs(got - want)
    lim = BOUND + BOUND * np.abs(want)
    assert np.isfinite(got).all(), what
    assert (err <= lim).all(), (
        f"{what}: {int((err > lim).sum())} elements outside atol=rtol="
        f"{BOUND} (max abs err {err.max():.3e})")


@pytest.mark.parametrize("n", [128, 64])
@pytest.mark.parametrize("case", ["chunk valid 41 from a state",
                                  "S 200 from zero"])
def test_mma_scan_within_bound(case, n):
    if case == "S 200 from zero":
        args = _inputs(n + 1, 200, n, with_init=False)
    else:
        args = _inputs(n + 2, Q, n, with_init=True, valid=41)
    x, dt, A, Bm, Cm, h0 = args
    y, fs = _mma_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                      None if h0 is None else torch.from_numpy(h0))
    for name, (wy, wfs) in _references(*args).items():
        _within(y.numpy(), wy, f"{case} N {n} y vs {name}")
        _within(fs.numpy(), wfs, f"{case} N {n} state vs {name}")


@pytest.mark.parametrize("n", [128, 64])
def test_mma_scan_chained_chunks_do_not_compound(n):
    """The engine's pattern: seven 64-token prefill calls, each starting
    from the state the last one returned (f32, never rounded), held against
    one f32 scan over all 448 tokens from the same entering state."""
    x, dt, A, Bm, Cm, h0 = _inputs(n + 3, 7 * Q, n, with_init=True)
    state = torch.from_numpy(h0)
    ys = []
    for k in range(7):
        sl = slice(k * Q, (k + 1) * Q)
        y, state = _mma_scan(*(torch.from_numpy(a[:, sl])
                               for a in (x, dt)), torch.from_numpy(A),
                             *(torch.from_numpy(a[:, sl]) for a in (Bm, Cm)),
                             state)
        ys.append(y)
    y = torch.cat(ys, 1).numpy()
    for name, (wy, wfs) in _references(x, dt, A, Bm, Cm, h0).items():
        _within(y, wy, f"7 chained chunks N {n} y vs {name}")
        _within(state.numpy(), wfs, f"7 chained chunks N {n} state vs "
                                    f"{name}")


@pytest.mark.parametrize("dtype,p,n,rows", [
    ("bfloat16", 64, 128, 32),   # mamba2-1.3b
    ("bfloat16", 64, 64, 32),    # zamba2-2.7b
    ("bfloat16", 16, 16, 16),    # the reduced configs
    ("bfloat16", 64, 256, 32),   # R x N capped at 8192
    ("bfloat16", 48, 128, 16),
    ("bfloat16", 8, 16, 0),      # P not a multiple of 16
    ("bfloat16", 64, 8, 0),      # N below 16
    ("bfloat16", 64, 272, 0),    # N above 256
    ("float32", 64, 128, 0),     # f32: the CUDA-core kernel
])
def test_scan_path_by_shape(dtype, p, n, rows):
    """The wrapper's choice between the tensor-core kernel (P rows a
    block) and the CUDA-core template (0) depends on dtype and shape
    alone."""
    assert scan_rows(getattr(torch, dtype), p, n) == rows
