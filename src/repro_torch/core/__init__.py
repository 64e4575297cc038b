# Jup2Kub core runtime, as far as the PyTorch port has it.
#
#   podspec                            C3: pod specs (+ real k8s YAML)
#   storage                            C4: PV/PVC two-tier artifact store
#   bus, registry                      C5: Kafka-style topics + service discovery
#   executor, probes, autoscaler,      C6: worker pods, liveness/readiness,
#   faults, events                         HPA, chaos injection, event log
#
# The notebook/DAG layer (notebook, dag, splitter, capsule, deployer,
# scheduler, elastic) is still to be ported (ROADMAP A.12).

from repro_torch.core.bus import TopicBus
from repro_torch.core.podspec import PodSpec, ResourceLimits, render_k8s_yaml
from repro_torch.core.storage import ArtifactStore, VolumeClaim

__all__ = ["TopicBus", "ArtifactStore", "VolumeClaim", "PodSpec",
           "ResourceLimits", "render_k8s_yaml"]
