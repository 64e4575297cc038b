from repro_torch.parallel.axes import (
    DEFAULT_RULES,
    PartitionSpec,
    Sharding,
    constrain,
    current_mesh,
    current_rules,
    logical_to_spec,
    make_shardings,
    sharding_context,
)
from repro_torch.parallel.collectives import (
    all_gather_logits,
    pmean_tp,
    psum_tp,
    tensor_parallel,
    tp_axis,
)
from repro_torch.parallel.group import Mesh

__all__ = [
    "DEFAULT_RULES",
    "Mesh",
    "PartitionSpec",
    "Sharding",
    "all_gather_logits",
    "constrain",
    "logical_to_spec",
    "make_shardings",
    "pmean_tp",
    "psum_tp",
    "sharding_context",
    "current_mesh",
    "current_rules",
    "tensor_parallel",
    "tp_axis",
]
