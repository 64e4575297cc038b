"""ctypes wrappers for the Mamba2 SSD CUDA kernels (``csrc/ssd_scan.cu``).

Two kernels, each replacing a Pallas TPU kernel of the JAX package:

* ``ssd_scan_bshp``      — the chunked prefill scan
  (``repro/kernels/ssd_scan.py`` ``ssd_scan_bhsp``), reading the ops layout
  ``(B, S, H, P)`` directly, continuing from an optional ``init_state`` and
  taking any S (the kernel pads its ragged last sub-chunk with dt = 0);
* ``ssd_decode_step_bh`` — the one-token recurrence
  (``ssd_decode_step_bh``), advancing the state in place, gated per slot
  by an optional ``active`` vector.

Each wrapper checks device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()``, raises when the launch reports an error,
and adds one to its entry of :data:`LAUNCHES` per launch. They accept CUDA
tensors only: the plain versions for the CPU live in
:mod:`repro_torch.kernels.ref` and the choice between the two is
:mod:`repro_torch.kernels.ops`'.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches per kernel since the last reset_launches()
LAUNCHES = {"ssd_scan_bshp": 0, "ssd_decode_step_bh": 0}

MAX_STATE = 256  # N: the scan stages (64, N) tiles of B and C in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        lib.ssd_decode.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        lib.ssd_decode.restype = _I
        lib.ssd_scan_chunked.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        lib.ssd_scan_chunked.restype = _I
        _lib = lib
    return _lib


def _check(device, tensors: dict, shapes: dict, dtypes: dict) -> None:
    for name, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device} "
                             f"(got {t.device}); the CPU path is ref.py")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def ssd_scan_bshp(
    x: torch.Tensor,    # (B, S, H, P) f32 | bf16
    dt: torch.Tensor,   # (B, S, H) f32
    A: torch.Tensor,    # (H,) f32
    Bm: torch.Tensor,   # (B, S, N) in x's dtype
    Cm: torch.Tensor,   # (B, S, N) in x's dtype
    init_state: torch.Tensor | None = None,  # (B, H, P, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) f32)."""
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"x must be (B, S, H, P) and Bm (B, S, N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {list(_DTYPES)}, got {x.dtype}")
    if s < 1 or n > MAX_STATE:
        raise ValueError(f"need S >= 1 and N <= {MAX_STATE}; got S={s}, N={n}")
    f32 = torch.float32
    tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    shapes = {"x": (b, s, h, p), "dt": (b, s, h), "A": (h,), "Bm": (b, s, n),
              "Cm": (b, s, n), "init_state": (b, h, p, n)}
    dtypes = {"x": x.dtype, "dt": f32, "A": f32, "Bm": x.dtype,
              "Cm": x.dtype, "init_state": f32}
    if init_state is not None:
        tensors["init_state"] = init_state
    _check(x.device, tensors, shapes, dtypes)
    y = torch.empty_like(x)
    fs = torch.empty((b, h, p, n), dtype=f32, device=x.device)
    err = _library().ssd_scan_chunked(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), _ptr(init_state), y.data_ptr(), fs.data_ptr(),
        b, s, h, p, n, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ssd_scan_bshp")
    LAUNCHES["ssd_scan_bshp"] += 1
    return y, fs


def ssd_decode_step_bh(
    state: torch.Tensor,  # (B, H, P, N) f32
    x_t: torch.Tensor,    # (B, H, P) f32 | bf16
    dt_t: torch.Tensor,   # (B, H) f32
    A: torch.Tensor,      # (H,) f32
    B_t: torch.Tensor,    # (B, N) in x's dtype
    C_t: torch.Tensor,    # (B, N) in x's dtype
    *,
    active: torch.Tensor | None = None,  # (B,) int32, 0 = leave the state
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence, advancing ``state`` in place. Returns
    (y (B, H, P) in x's dtype, ``state``). Rows whose ``active`` entry is 0
    keep their old state (their y still comes from the advanced state)."""
    if state.dim() != 4:
        raise ValueError(f"state must be (B, H, P, N); got "
                         f"{tuple(state.shape)}")
    b, h, p, n = state.shape
    if x_t.dtype not in _DTYPES:
        raise TypeError(f"x_t must be one of {list(_DTYPES)}, got {x_t.dtype}")
    if n % 4:
        raise ValueError(f"N must be a multiple of 4 (16-byte rows); got {n}")
    if state.data_ptr() % 16:
        raise ValueError("state must be 16-byte aligned")
    f32 = torch.float32
    tensors = {"state": state, "x_t": x_t, "dt_t": dt_t, "A": A, "B_t": B_t,
               "C_t": C_t}
    shapes = {"state": (b, h, p, n), "x_t": (b, h, p), "dt_t": (b, h),
              "A": (h,), "B_t": (b, n), "C_t": (b, n), "active": (b,)}
    dtypes = {"state": f32, "x_t": x_t.dtype, "dt_t": f32, "A": f32,
              "B_t": x_t.dtype, "C_t": x_t.dtype, "active": torch.int32}
    if active is not None:
        tensors["active"] = active
    _check(state.device, tensors, shapes, dtypes)
    y = torch.empty_like(x_t)
    err = _library().ssd_decode(
        state.data_ptr(), x_t.data_ptr(), dt_t.data_ptr(),
        A.data_ptr(), B_t.data_ptr(), C_t.data_ptr(), _ptr(active),
        y.data_ptr(), b, h, p, n, _DTYPES[x_t.dtype],
        torch.cuda.current_stream(state.device).cuda_stream)
    _raise_on(err, "ssd_decode_step_bh")
    LAUNCHES["ssd_decode_step_bh"] += 1
    return y, state
