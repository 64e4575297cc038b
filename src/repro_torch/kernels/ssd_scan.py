"""ctypes wrappers for the Mamba2 SSD CUDA kernels (``csrc/ssd_scan.cu``).

Two kernels, each replacing a Pallas TPU kernel of the JAX package:

* ``ssd_scan_bshp``      — the chunked prefill scan
  (``repro/kernels/ssd_scan.py`` ``ssd_scan_bhsp``), reading the ops layout
  ``(B, S, H, P)`` directly, continuing from an optional ``init_state`` and
  taking any S (the kernel zero-fills its ragged last 64-token sub-chunk:
  dt = 0, x = B = C = 0). bf16 with P and N multiples of 16 and N <= 256
  runs the tensor-core kernel (``ssd_scan_mma_kernel``, :func:`scan_rows`
  P rows a block); every other shape, and f32, the CUDA-core template
  (``ssd_scan_kernel``). The choice is by shape alone;
* ``ssd_decode_step_bh`` — the one-token recurrence
  (``ssd_decode_step_bh``), advancing the state in place, gated per slot
  by an optional ``active`` vector.

Both kernels are forwards only: their outputs have no ``grad_fn``. So
each wrapper refuses inputs that require grad while grad mode is on,
before any other check, instead of cutting the gradient silently;
training goes through ``ops.ssd_scan``, whose ``torch.autograd.Function``
runs the scan wrapper as its forward (where grad mode is off).

Each wrapper checks device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()``, raises when the launch reports an error,
and adds one to its entry of :data:`LAUNCHES` per launch (the scan also
to its path's entry of :data:`LAUNCHES_BY_PATH`). They accept CUDA
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
# scan launches per kernel: tensor cores (bf16) or the CUDA-core template
LAUNCHES_BY_PATH = {"mma": 0, "cuda_core": 0}

# N: both scan kernels stage 64 x N tiles of B and C in shared memory, and
# the tensor-core kernel holds a block's R x N state in registers
MAX_STATE = 256
# P rows a tensor-core scan block owns where P allows it: the fastest of 16,
# 32 and 64 at the engine's shape (tools/ssd_ablation.py)
MMA_ROWS = 32
MMA_STATE_ELEMS = 64 * 128  # R x N at most: 8 16x16 state tiles a warp
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_PATH):
        for k in counts:
            counts[k] = 0


def scan_rows(dtype: torch.dtype, p: int, n: int) -> int:
    """P rows a block of the tensor-core scan owns for these shapes, or 0
    for the CUDA-core template: bf16 with P and N multiples of 16, 16 <= N
    <= MAX_STATE; MMA_ROWS where it divides P and R x N <= MMA_STATE_ELEMS,
    else 32, else 16."""
    if dtype != torch.bfloat16 or p % 16 or n % 16 or not 16 <= n <= MAX_STATE:
        return 0
    return next(r for r in (MMA_ROWS, 32, 16)
                if p % r == 0 and r * n <= MMA_STATE_ELEMS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        lib.ssd_decode.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        lib.ssd_decode.restype = _I
        lib.ssd_scan_chunked.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        lib.ssd_scan_chunked.restype = _I
        lib.ssd_scan_info.argtypes = [_I] * 4 + [_P]
        lib.ssd_scan_info.restype = _I
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


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward kernel and gives no gradient: call it "
            f"under torch.no_grad() or on tensors that do not require grad, "
            f"or train through ops.ssd_scan (its autograd Function)")


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
    _refuse_grad("ssd_scan_bshp", x, dt, A, Bm, Cm, init_state)
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
    rows = scan_rows(x.dtype, p, n)
    if rows and any(tensors[k].data_ptr() % 16 for k in tensors
                    if k in ("x", "Bm", "Cm", "init_state")):
        raise ValueError("x, Bm, Cm and init_state must be 16-byte aligned "
                         "(the tensor-core scan copies 16-byte chunks)")
    y = torch.empty_like(x)
    fs = torch.empty((b, h, p, n), dtype=f32, device=x.device)
    err = _library().ssd_scan_chunked(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), _ptr(init_state), y.data_ptr(), fs.data_ptr(),
        b, s, h, p, n, _DTYPES[x.dtype], rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ssd_scan_bshp")
    build.count_launch((LAUNCHES, "ssd_scan_bshp"),
                       (LAUNCHES_BY_PATH, "mma" if rows else "cuda_core"))
    return y, fs


def ssd_scan_info(dtype: torch.dtype, s: int, p: int, n: int) -> dict:
    """The scan kernel a call of this dtype and S, P, N launches, as the
    card runs it: its path and P rows a block, registers and local
    (spilled) bytes a thread, dynamic shared memory a block, blocks
    resident per SM."""
    rows = scan_rows(dtype, p, n)
    info = (ctypes.c_int * 4)()
    _raise_on(_library().ssd_scan_info(_DTYPES[dtype], rows, s, n, info),
              "ssd_scan_info")
    return {"path": "mma" if rows else "cuda_core", "rows": rows or 16,
            "registers": info[0], "local_bytes": info[1],
            "smem_bytes": info[2], "blocks_per_sm": info[3]}


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
    _refuse_grad("ssd_decode_step_bh", state, x_t, dt_t, A, B_t, C_t)
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
    build.count_launch((LAUNCHES, "ssd_decode_step_bh"))
    return y, state
