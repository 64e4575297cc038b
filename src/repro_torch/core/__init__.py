# Jup2Kub core: the paper's contribution as a composable runtime.
#
#   notebook -> dag -> splitter        C1: piped-section splitting
#   capsule                            C2: ReproZip-style dependency capture
#   podspec -> deployer                C3: dynamic pod deployment (+ real k8s YAML)
#   storage                            C4: PV/PVC two-tier artifact store
#   bus, registry                      C5: Kafka-style topics + service discovery
#   scheduler, executor, probes,       C6: ReplicaSets, liveness/readiness,
#   autoscaler, elastic, faults            rolling updates, HPA, retries

from repro_torch.core.notebook import Cell, Notebook
from repro_torch.core.dag import StepGraph, Step
from repro_torch.core.splitter import split_pipeline
from repro_torch.core.capsule import Capsule, seal_step
from repro_torch.core.bus import TopicBus
from repro_torch.core.storage import ArtifactStore, VolumeClaim
from repro_torch.core.podspec import PodSpec, ResourceLimits, render_k8s_yaml
from repro_torch.core.deployer import PodManager, DynamicPodDeployer
from repro_torch.core.scheduler import RetryPolicy, WorkflowScheduler

__all__ = [
    "Cell", "Notebook", "StepGraph", "Step", "split_pipeline",
    "Capsule", "seal_step", "TopicBus", "ArtifactStore", "VolumeClaim",
    "PodSpec", "ResourceLimits", "render_k8s_yaml",
    "PodManager", "DynamicPodDeployer", "RetryPolicy", "WorkflowScheduler",
]
