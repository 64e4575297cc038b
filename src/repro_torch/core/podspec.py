"""PodSpec + the paper's Listing-1 Kubernetes Deployment template.

Two render targets from one spec:
  * runtime objects for our in-process scheduler (a pod = mesh-slice lease
    + host worker), resources in chips/HBM instead of cpu/mem;
  * REAL Kubernetes YAML faithful to the paper's Listing 1 (ReplicaSet=3,
    RollingUpdate maxSurge/maxUnavailable=1, liveness/readiness probes,
    KAFKA_BROKER env, EFS PVC mount) — written by examples/notebook demo so
    the translation to an actual cluster is inspectable.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ResourceLimits:
    # runtime (TPU) resources
    chips: int = 0
    hbm_gb: float = 0.0
    # paper (k8s) resources, kept for YAML fidelity
    cpu_limit: str = "1"
    mem_limit: str = "1Gi"
    cpu_request: str = "500m"
    mem_request: str = "500Mi"


@dataclass
class PodSpec:
    name: str
    image: str                      # StepImage.tag
    role: str = "consumer"          # producer | consumer | both (paper §3.2.1)
    in_topics: list[str] = field(default_factory=list)
    out_topics: list[str] = field(default_factory=list)
    replicas: int = 3               # paper §3.5 ReplicaSet default
    max_surge: int = 1
    max_unavailable: int = 1
    resources: ResourceLimits = field(default_factory=ResourceLimits)
    env: dict = field(default_factory=dict)
    claim_name: str = ""
    liveness_interval_s: float = 5.0
    readiness_timeout_s: float = 30.0
    node_affinity: str | None = None  # set when a node-tier volume is claimed


def serving_worker_spec(name: str, *, replicas: int = 2,
                        liveness_interval_s: float = 2.0,
                        readiness_timeout_s: float = 60.0,
                        env: dict | None = None) -> PodSpec:
    """PodSpec for one serving-engine worker deployment.

    The serving fleet's workers are consumers of the supervisor's
    ``fleet.work`` topic and producers on ``fleet.events``; readiness is
    dominated by model load + XLA compile, so its timeout is much longer
    than the liveness interval. The same spec drives both the in-process
    :class:`repro_torch.serving.fleet.FleetSupervisor` (restart parameters,
    probe windows) and :func:`render_k8s_yaml` for the paper's Listing-1
    Deployment."""
    return PodSpec(
        name=name,
        image=f"{name}:latest",
        role="both",
        in_topics=["fleet.work", "fleet.control"],
        out_topics=["fleet.events", "health"],
        replicas=replicas,
        resources=ResourceLimits(chips=1, hbm_gb=16.0,
                                 cpu_limit="4", mem_limit="16Gi"),
        env=dict(env or {}),
        liveness_interval_s=liveness_interval_s,
        readiness_timeout_s=readiness_timeout_s,
    )


def render_k8s_yaml(spec: PodSpec, kafka_broker: str = "my-broker-address",
                    tag: str = "latest") -> str:
    """The paper's Listing 1, filled in (indentation bugs of the paper fixed)."""
    image_name, _, img_tag = spec.image.partition(":")
    env_lines = "".join(
        f"        - name: {k}\n          value: \"{v}\"\n" for k, v in spec.env.items()
    )
    claim = spec.claim_name or f"{spec.name}-efs-pvc"
    return f"""apiVersion: apps/v1
kind: Deployment
metadata:
  name: {spec.name}-deployment
spec:
  replicas: {spec.replicas}
  strategy:
    type: RollingUpdate
    rollingUpdate:
      maxUnavailable: {spec.max_unavailable}
      maxSurge: {spec.max_surge}
  selector:
    matchLabels:
      app: {spec.name}
  template:
    metadata:
      labels:
        app: {spec.name}
    spec:
      containers:
      - name: {spec.name}-container
        image: {image_name}:{img_tag or tag}
        env:
        - name: KAFKA_BROKER
          value: "{kafka_broker}"
        - name: POD_ROLE
          value: "{spec.role}"
        - name: IN_TOPICS
          value: "{','.join(spec.in_topics)}"
        - name: OUT_TOPICS
          value: "{','.join(spec.out_topics)}"
{env_lines}        resources:
          limits:
            cpu: "{spec.resources.cpu_limit}"
            memory: "{spec.resources.mem_limit}"
          requests:
            cpu: "{spec.resources.cpu_request}"
            memory: "{spec.resources.mem_request}"
        livenessProbe:
          httpGet:
            path: /healthz
            port: 8080
        readinessProbe:
          httpGet:
            path: /readiness
            port: 8080
        volumeMounts:
        - name: efs-volume
          mountPath: /mnt/efs
      volumes:
      - name: efs-volume
        persistentVolumeClaim:
          claimName: {claim}
"""


def render_pv_pvc_yaml(name: str, tier: str, capacity: str = "10Gi",
                       node: str | None = None) -> str:
    """PV + PVC pair (paper §3.3): local (node-affine) or EFS-style shared."""
    if tier == "node":
        affinity = f"""
  nodeAffinity:
    required:
      nodeSelectorTerms:
      - matchExpressions:
        - key: kubernetes.io/hostname
          operator: In
          values: ["{node or 'node0'}"]"""
        source = f"  local:\n    path: /mnt/local/{name}"
        sc = "local-storage"
    else:
        affinity = ""
        source = f"  csi:\n    driver: efs.csi.aws.com\n    volumeHandle: fs-{name}"
        sc = "efs-sc"
    return f"""apiVersion: v1
kind: PersistentVolume
metadata:
  name: {name}-pv
spec:
  capacity:
    storage: {capacity}
  accessModes: ["ReadWriteMany"]
  storageClassName: {sc}
{source}{affinity}
---
apiVersion: v1
kind: PersistentVolumeClaim
metadata:
  name: {name}-efs-pvc
spec:
  accessModes: ["ReadWriteMany"]
  storageClassName: {sc}
  resources:
    requests:
      storage: {capacity}
"""
