"""ctypes wrappers for the flash-attention CUDA kernels: the forward
(``csrc/flash_attention.cu``) and its backward (``csrc/flash_backward.cu``).

``flash_attention_bhsd`` replaces the Pallas TPU kernel of the same name
(``repro/kernels/flash_attention.py``): dense grouped-query attention over
q ``(B, H, Sq, D)`` and k/v ``(B, KVH, Skv, D)``, causal or not, with the
causal queries the last Sq of the Skv positions. bf16 inputs run the
tensor-core kernel (``mma.sync`` products, ``cp.async`` K/V tiles; its
copies need 16-byte aligned tensors, as torch allocates them, and a
launch with any other reports error -2), f32 inputs the CUDA-core one
that the f32 parity runs compare with the plain version. It checks
device, dtype, shape and contiguity, launches on
``torch.cuda.current_stream()``, raises when the launch reports an error,
and adds one to :data:`LAUNCHES` per launch. It takes CUDA tensors only: the plain versions for the CPU live in
:mod:`repro_torch.kernels.ref` and the choice between the two is
:mod:`repro_torch.kernels.ops`'.

With ``return_lse=True`` the forward also returns each row's logsumexp
(f32 (B, H, Sq)), which :func:`flash_attention_bwd` takes. The backward
replaces no Pallas kernel (the JAX package differentiates its plain
chunked version): from q, k, v, the forward's output and row statistics
and the upstream gradient it returns dq, dk and dv in the inputs' dtype
(for bf16, Hopper ``wgmma`` kernels on TMA tiles with f32 sums, which
build four tensor maps on the host each call; CUDA-core ones for f32,
which take their own row statistics and every sum in f64; no float
atomics: two calls give the same bits). It adds one to
``LAUNCHES["flash_attention_bwd"]`` per call.

Neither wrapper's output has a ``grad_fn``. So the forward refuses
inputs that require grad while grad mode is on, before any other check,
instead of cutting the gradient silently; training goes through
``ops.flash_attention``, whose ``torch.autograd.Function`` runs this
forward (where grad mode is off) and this backward.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches since the last reset_launches()
LAUNCHES = {"flash_attention_bhsd": 0, "flash_attention_bwd": 0}

HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_bwd_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.flash_attention_forward.argtypes = (
            [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _P])
        lib.flash_attention_forward.restype = _I
        _lib = lib
    return _lib


def _backward_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load("flash_backward")
        lib.flash_attention_backward.argtypes = (
            [_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _P])
        lib.flash_attention_backward.restype = _I
        lib.flash_attention_backward_info.argtypes = (
            [_I, _I, ctypes.POINTER(ctypes.c_int)])
        lib.flash_attention_backward_info.restype = _I
        _bwd_lib = lib
    return _bwd_lib


def _check_qkv(q, k, v, causal):
    """(b, h, kvh, sq, skv, d) after the shape, dtype and head-dim checks
    the two kernels share."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k/v (B, KVH, Skv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    kb, kvh, skv, kd = k.shape
    if kb != b or kd != d or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head_dim, H % KVH)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (kernel: {HEAD_DIMS})")
    if causal and sq > skv:
        raise ValueError(f"causal attention needs Sq <= Skv, got {sq} > {skv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share a dtype in {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    return b, h, kvh, sq, skv, d


def _check_device(first, **tensors):
    """Every tensor a contiguous CUDA tensor on ``first``'s device."""
    for name, t in tensors.items():
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{name} must be a CUDA tensor on {first.device} "
                             f"(got {t.device}); the CPU path is ref.py")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KVH, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Returns (B, H, Sq, D) in q's dtype, and with ``return_lse`` also
    each row's logsumexp of its scaled, masked scores, f32 (B, H, Sq).
    Any Sq and Skv (ragged tiles are masked in the kernel); causal needs
    Sq <= Skv."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_bhsd is a forward kernel and gives no gradient: "
            "call it under torch.no_grad() or on tensors that do not require "
            "grad, or train through ops.flash_attention (its autograd "
            "Function)")
    b, h, kvh, sq, skv, d = _check_qkv(q, k, v, causal)
    _check_device(q, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _library().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, kvh, sq, skv, d,
        int(causal), scale if scale is not None else d ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bhsd launch failed: error {err}")
    build.count_launch((LAUNCHES, "flash_attention_bhsd"))
    return (out, lse) if return_lse else out


def flash_attention_bwd(
    q: torch.Tensor,     # (B, H, Sq, D)
    k: torch.Tensor,     # (B, KVH, Skv, D)
    v: torch.Tensor,
    o: torch.Tensor,     # (B, H, Sq, D): the forward's output
    dout: torch.Tensor,  # (B, H, Sq, D): the upstream gradient
    lse: torch.Tensor,   # (B, H, Sq) f32: the forward's row statistics
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_bhsd`: (dq, dk, dv) in the
    inputs' dtype and layouts. ``lse`` is what the forward returned with
    ``return_lse=True`` for the same q, k, v, causal and scale."""
    b, h, kvh, sq, skv, d = _check_qkv(q, k, v, causal)
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype}; "
                             f"got {tuple(t.shape)} {t.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    _check_device(q, q=q, k=k, v=v, o=o, dout=dout, lse=lse)
    # scratch: di (bf16), or each row's f64 logsumexp and di (f32)
    di = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
          if q.dtype == torch.bfloat16 else
          torch.empty((b, h, sq, 2), dtype=torch.float64, device=q.device))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = _backward_library().flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq, skv, d, int(causal),
        scale if scale is not None else d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: error {err}")
    build.count_launch((LAUNCHES, "flash_attention_bwd"))
    return dq, dk, dv
