"""ctypes wrapper for the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

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

The kernel is a forward only: its output has no ``grad_fn``. So the
wrapper refuses inputs that require grad while grad mode is on, before
any other check, instead of cutting the gradient silently; training goes
through ``ops.flash_attention``, whose ``torch.autograd.Function`` runs
this wrapper as its forward (where grad mode is off).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches since the last reset_launches()
LAUNCHES = {"flash_attention_bhsd": 0}

HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def reset_launches() -> None:
    LAUNCHES["flash_attention_bhsd"] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.flash_attention_forward.argtypes = (
            [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _P])
        lib.flash_attention_forward.restype = _I
        _lib = lib
    return _lib


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KVH, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, H, Sq, D) in q's dtype. Any Sq and Skv (ragged tiles
    are masked in the kernel); causal needs Sq <= Skv."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_bhsd is a forward kernel and gives no gradient: "
            "call it under torch.no_grad() or on tensors that do not require "
            "grad, or train through ops.flash_attention (its autograd "
            "Function)")
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device} "
                             f"(got {t.device}); the CPU path is ref.py")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    err = _library().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kvh, sq, skv, d, int(causal),
        scale if scale is not None else d ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bhsd launch failed: error {err}")
    build.count_launch((LAUNCHES, "flash_attention_bhsd"))
    return out
