"""PodManager + DynamicPodDeployer (paper §3.2), both runtime and YAML targets.

``PodManager`` derives per-step pod details (producer/consumer role, topics)
from the StepGraph — exactly the paper's §3.2.1 responsibility. The deployer
"applies" them: for the in-process runtime it wires a WorkflowScheduler; for
a real cluster it renders the Deployment/PV/PVC manifests into a directory
(`kubectl apply -f` ready).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.core.dag import StepGraph
from repro_torch.core.podspec import PodSpec, ResourceLimits, render_k8s_yaml, render_pv_pvc_yaml

log = logging.getLogger("jup2kub.deploy")


class PodManager:
    """Holds pod details: role (producer/consumer) and topics per step."""

    def __init__(self, graph: StepGraph):
        self.graph = graph

    def role_of(self, name: str) -> str:
        has_in = bool(self.graph.deps(name))
        has_out = bool(self.graph.consumers(name))
        if has_in and has_out:
            return "both"
        return "consumer" if has_in else "producer"

    def topics_of(self, name: str) -> tuple[list[str], list[str]]:
        in_topics = sorted(f"pipe.{d}.{name}" for d in self.graph.deps(name))
        out_topics = sorted(f"pipe.{name}.{c}" for c in self.graph.consumers(name))
        return in_topics, out_topics

    def pod_specs(
        self,
        default_replicas: int = 3,
        resources: dict[str, ResourceLimits] | None = None,
    ) -> list[PodSpec]:
        specs = []
        for name, step in self.graph.steps.items():
            in_t, out_t = self.topics_of(name)
            res = (resources or {}).get(name, ResourceLimits())
            specs.append(
                PodSpec(
                    name=name,
                    image=f"jup2kub/{name}:latest",
                    role=self.role_of(name),
                    in_topics=in_t,
                    out_topics=out_t,
                    replicas=1 if step.long_running else max(step.replicas, default_replicas),
                    resources=res,
                    env={"STEP_NAME": name},
                    claim_name=f"{name}-efs-pvc",
                )
            )
        return specs


@dataclass
class DynamicPodDeployer:
    """Renders + 'applies' pod deployments (paper §3.2.3)."""

    manager: PodManager
    out_dir: Path | None = None
    kafka_broker: str = "my-broker-address"
    applied: list[PodSpec] = field(default_factory=list)
    device: str = "cuda"  # where the pods run; "cpu" on a machine without a card

    def load_kube_config(self) -> dict:
        """config.load_kube_config() analogue: resolve the runtime context."""
        import torch

        from repro_torch.models.common import resolve_device

        return {
            "context": "jup2kub-sim",
            "devices": torch.cuda.device_count(),
            "backend": resolve_device(self.device).type,
        }

    def deploy_all(self, resources: dict[str, ResourceLimits] | None = None) -> list[PodSpec]:
        cfg = self.load_kube_config()
        log.info("deploying with context %s", cfg)
        specs = self.manager.pod_specs(resources=resources)
        for spec in specs:
            try:
                self._apply(spec)
                self.applied.append(spec)
                log.info("deployed %s role=%s replicas=%d", spec.name, spec.role, spec.replicas)
            except Exception:
                log.exception("failed to deploy %s", spec.name)
                raise
        return specs

    def _apply(self, spec: PodSpec):
        if self.out_dir is None:
            return
        self.out_dir.mkdir(parents=True, exist_ok=True)
        (self.out_dir / f"{spec.name}-deployment.yaml").write_text(
            render_k8s_yaml(spec, kafka_broker=self.kafka_broker)
        )
        (self.out_dir / f"{spec.name}-storage.yaml").write_text(
            render_pv_pvc_yaml(spec.name, tier="shared")
        )
