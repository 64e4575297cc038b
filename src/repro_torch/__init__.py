"""PyTorch/CUDA port of the ``repro`` package.

Same module paths and public names as ``repro``; the serving hot path
(paged continuous batching of the dense decoder) runs on an NVIDIA H100
through hand-written CUDA kernels for paged attention
(``kernels/csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Nothing here imports JAX or the ``repro`` package.
"""
