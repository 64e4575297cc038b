"""The port's SSD ops (their plain versions, on the CPU) against the JAX
package's Pallas SSD kernels and its sequential oracle.

Same numpy-seeded inputs (the distribution of ``tests/test_kernels.py``)
go through ``repro_torch.kernels.ops.ssd_scan`` / ``ssd_decode_step`` on
CPU tensors and through JAX ``ops.ssd_scan`` / ``ops.ssd_decode_step`` with
``impl="pallas_interpret"`` (the Pallas kernels in interpret mode, as the
JAX package's own tests run them on the CPU), and against JAX
``ref.ssd_sequential``. f32 throughout, held to 1e-4 (atol and rtol, the
JAX package's SSD f32 bound). Covers padding (S not a multiple of the
chunk), a carried ``init_state``, dt = 0 rows, and decode = a length-1
scan, plus the port's in-place, ``active``-gated decode step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-4


def _inputs(seed, b, s, h, p, n, zero_dt_from=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.1 + 0.9 * rng.random((b, s, h))).astype(np.float32)
    if zero_dt_from is not None:
        dt[:, zero_dt_from:] = 0.0
    A = (-1.0 * rng.random((h,)) - 0.1).astype(np.float32)
    Bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL, rtol=TOL)


# (b, s, h, p, n, chunk, dt = 0 from row, with init_state)
SCAN_CASES = [
    (1, 32, 2, 8, 16, 16, None, False),   # S a multiple of the chunk
    (2, 40, 3, 8, 16, 16, None, True),    # padded tail (40 = 2*16 + 8)
    (1, 32, 2, 16, 32, 32, 19, True),     # a chunk whose tail has dt = 0
    (2, 9, 4, 8, 16, 256, 5, False),      # chunk > S: one short chunk
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,zero_from,with_init", SCAN_CASES)
def test_ssd_scan_matches_jax(b, s, h, p, n, chunk, zero_from, with_init):
    x, dt, A, Bm, Cm, h0 = _inputs(s + h, b, s, h, p, n, zero_from)
    init = h0 if with_init else None
    y, fs = ops.ssd_scan(
        *map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=chunk,
        init_state=None if init is None else torch.from_numpy(init))
    assert y.shape == (b, s, h, p) and fs.shape == (b, h, p, n)
    jy, jfs = jops.ssd_scan(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
        impl="pallas_interpret",
        init_state=None if init is None else jnp.asarray(init))
    _close(y, jy)
    _close(fs, jfs)
    sy, sfs = jref.ssd_sequential(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)),
        init_state=None if init is None else jnp.asarray(init))
    _close(y, sy)
    _close(fs, sfs)


def test_ssd_scan_dt_zero_rows_are_identities():
    """Rows with dt = 0 leave the state exactly where the valid prefix put
    it: scanning a chunk whose tail has dt = 0 gives the state of scanning
    the prefix alone (the engine's padded last chunk)."""
    x, dt, A, Bm, Cm, h0 = _inputs(7, 1, 24, 2, 8, 16, zero_dt_from=13)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    _, fs_all = ops.ssd_scan(*t, chunk=8, init_state=torch.from_numpy(h0))
    pre = [a[:, :13] for a in (t[0], t[1])] + [t[2]] + [a[:, :13]
                                                        for a in t[3:]]
    _, fs_pre = ops.ssd_scan(*pre, chunk=8, init_state=torch.from_numpy(h0))
    _close(fs_all, fs_pre)


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_decode_step_matches_jax_and_scan(seed):
    """One decode step against the Pallas decode kernel (interpret mode)
    and against a length-1 scan continued from the same state. The port's
    op advances its state in place, so it gets a copy of h0."""
    b, h, p, n = 3, 4, 8, 16
    x, dt, A, Bm, Cm, h0 = _inputs(seed, b, 1, h, p, n)
    args = (h0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    state = torch.from_numpy(h0.copy())
    y, st = ops.ssd_decode_step(state, *map(torch.from_numpy, args[1:]))
    assert st.data_ptr() == state.data_ptr()
    jy, jst = jops.ssd_decode_step(*map(jnp.asarray, args),
                                   impl="pallas_interpret")
    _close(y, jy)
    _close(st, jst)
    ys, sts = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                           init_state=torch.from_numpy(h0))
    _close(y, ys[:, 0])
    _close(st, sts)


def test_ssd_decode_step_inplace_gated_by_active():
    """The op advances the given state tensor in place; rows with
    active == 0 keep their old state bit for bit while their y is still the
    advanced state's readout (the JAX engine's ``_mask_state`` semantics).
    The out-of-place plain step gives the ungated answer."""
    b, h, p, n = 4, 2, 8, 16
    x, dt, A, Bm, Cm, h0 = _inputs(3, b, 1, h, p, n)
    args = [torch.from_numpy(a) for a in (x[:, 0], dt[:, 0], A, Bm[:, 0],
                                          Cm[:, 0])]
    y_all, st_all = ref.ssd_decode_step(torch.from_numpy(h0), *args)
    state = torch.from_numpy(h0.copy())
    active = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    y, st = ops.ssd_decode_step(state, *args, active=active)
    assert st.data_ptr() == state.data_ptr()
    assert torch.equal(y, y_all)
    assert torch.equal(state[active == 1], st_all[active == 1])
    assert torch.equal(state[active == 0], torch.from_numpy(h0)[active == 0])
