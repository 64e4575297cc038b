"""Attention and Mamba2 SSD ops: hand-written CUDA kernels for Hopper
(``csrc/``, built by :mod:`repro_torch.kernels.build`) and their plain
PyTorch versions (:mod:`repro_torch.kernels.ref`), chosen per call by
:mod:`repro_torch.kernels.ops`."""
