"""Roofline terms for the NVIDIA H100 from a counted step.

The port of ``repro/analysis/roofline.py``, with the same arithmetic:

    compute    = FLOPs_per_rank / peak_flops
    memory     = HBM_bytes_per_rank / hbm_bw
    collective = sum_k coll_bytes_k * ring_factor_k / ici_bw

Ring factors: all-reduce moves ~2x its payload on a ring reduce-scatter +
all-gather schedule; the others ~1x. The dominant term approximates step
time at perfect overlap; their sum bounds it without. ``bound_s`` (the
largest term) is a lower bound on a step's time: a measured step faster
than it means the count is wrong.

The one card (``HW()``'s default), NVIDIA H100 SXM: the rates are NVIDIA's
data sheet (dense, no sparsity, at the full 700 W power limit), the memory
size the card's own ``torch.cuda.get_device_properties(0).total_memory``
as ``chip_smoke.py``'s phase 38 prints it on an NVIDIA H100 80GB HBM3 at
700.00 W:

* ``peak_flops`` 989e12: bf16 (and fp16) tensor-core FLOP/s;
* ``f32_flops`` 67e12: f32 FLOP/s outside the tensor cores;
* ``hbm_bw`` 3.35e12: HBM3 bytes/s;
* ``ici_bw`` 450e9: NVLink 4 bytes/s per GPU per direction (900 GB/s both
  ways). One NVLink domain is the 8 GPUs of a host: a mesh's 16-rank
  ``model`` axis spans two domains, whose links (InfiniBand, ~50 GB/s a
  GPU) this term does not model;
* ``hbm_per_chip``: 85,017,493,504 bytes (79.18 GiB).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.cost import StepCost


@dataclass(frozen=True)
class HW:
    name: str = "h100_sxm"
    peak_flops: float = 989e12       # bf16 dense
    hbm_bw: float = 3.35e12          # bytes/s
    ici_bw: float = 450e9            # NVLink bytes/s per GPU per direction
    hbm_per_chip: float = 85_017_493_504
    f32_flops: float = 67e12         # f32 outside the tensor cores


RING_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
    "collective-broadcast": 1.0,
}


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float            # with the hand-written kernels' regions fused
    collective_s: float
    flops: float
    hbm_bytes: float           # kernelized bytes
    collective_bytes: dict[str, float]
    model_flops: float = 0.0   # analytic 6*N*D (per rank), for the waste ratio
    memory_xla_s: float = 0.0  # every op of the eager step unfused

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much computed work is useful."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-work time / bound time, vs the dominant resource."""
        if self.bound_s == 0:
            return 0.0
        return min(1.0, (self.model_flops / self.flops if self.flops else 0.0)) * (
            self.compute_s / self.bound_s
        )

    def as_row(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_xla_s": self.memory_xla_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(cost: StepCost, hw: HW = HW(),
                   model_flops_per_chip: float = 0.0) -> RooflineTerms:
    coll_s = sum(
        bytes_ * RING_FACTOR.get(kind, 1.0) / hw.ici_bw
        for kind, bytes_ in cost.collective_bytes.items()
    )
    kb = cost.hbm_bytes_kernelized or cost.hbm_bytes
    return RooflineTerms(
        compute_s=cost.flops / hw.peak_flops,
        memory_s=kb / hw.hbm_bw,
        collective_s=coll_s,
        flops=cost.flops,
        hbm_bytes=kb,
        collective_bytes=dict(cost.collective_bytes),
        model_flops=model_flops_per_chip,
        memory_xla_s=cost.hbm_bytes / hw.hbm_bw,
    )


def model_flops_per_chip(cfg, shape, n_chips: int) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (3x for fwd+bwd), 2*N*D inference;
    MoE uses N_active. D = tokens processed in the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens / n_chips
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens / n_chips
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch / n_chips
