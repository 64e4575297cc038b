# Jup2Kub core runtime, as far as the PyTorch port has it.
#
#   storage                            C4: PV/PVC two-tier artifact store
#   bus, registry                      C5: Kafka-style topics + service discovery
#   events, autoscaler                 C6: event log, HPA
#
# The notebook/DAG layer (notebook, dag, splitter, capsule, podspec,
# deployer, scheduler, executor, probes, elastic, faults) is still to be
# ported (ROADMAP A.12).

from repro_torch.core.bus import TopicBus
from repro_torch.core.storage import ArtifactStore, VolumeClaim

__all__ = ["TopicBus", "ArtifactStore", "VolumeClaim"]
