"""ArtifactStore: the PV/PVC analogue (paper §3.3), two-tier and content-addressed.

Tiers (the paper's local-PV vs EBS/EFS split):
  * ``node``   — per-node fast storage (node-affine; a pod claiming a node
    tier is pinned to that node, exactly like PV nodeAffinity);
  * ``shared`` — cluster-wide storage (EFS analogue) for inter-pod pipes
    and checkpoints.

Objects are content-addressed (``sha256``) so pipes are immutable, dedup'd
and integrity-checkable; refs look like ``shared://ab12cd.../tensor`` and are
what actually travels on the TopicBus. ``VolumeClaim`` reserves a named
directory with a capacity (enforced on put) — the PVC analogue, used by the
CheckpointManager as its backing volume.
"""

from __future__ import annotations

import hashlib
import io
import json
import pickle
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

TIERS = ("node", "shared")


@dataclass(frozen=True)
class VolumeClaim:
    name: str
    tier: str
    capacity_bytes: int
    path: Path

    def used_bytes(self) -> int:
        return sum(f.stat().st_size for f in self.path.rglob("*") if f.is_file())


class ArtifactStore:
    def __init__(self, root: str | Path, node_id: str = "node0"):
        self.root = Path(root)
        self.node_id = node_id
        (self.root / "shared" / "objects").mkdir(parents=True, exist_ok=True)
        (self.root / "node" / node_id / "objects").mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    def _objects(self, tier: str) -> Path:
        if tier == "shared":
            return self.root / "shared" / "objects"
        if tier == "node":
            return self.root / "node" / self.node_id / "objects"
        raise ValueError(f"unknown tier {tier!r}; want one of {TIERS}")

    @staticmethod
    def _encode(obj: Any) -> tuple[bytes, str]:
        if isinstance(obj, bytes):
            return obj, "bytes"
        if isinstance(obj, np.ndarray):
            buf = io.BytesIO()
            np.save(buf, obj)
            return buf.getvalue(), "ndarray"
        try:
            return json.dumps(obj).encode(), "json"
        except (TypeError, ValueError):
            return pickle.dumps(obj), "pickle"

    @staticmethod
    def _decode(blob: bytes, kind: str) -> Any:
        if kind == "bytes":
            return blob
        if kind == "ndarray":
            return np.load(io.BytesIO(blob))
        if kind == "json":
            return json.loads(blob)
        return pickle.loads(blob)  # noqa: S301 — same-trust-domain pipes

    # ------------------------------------------------------------------
    def put(self, obj: Any, tier: str = "shared", name: str = "obj") -> str:
        blob, kind = self._encode(obj)
        digest = hashlib.sha256(blob).hexdigest()
        d = self._objects(tier) / digest
        d.mkdir(exist_ok=True)
        f = d / "data"
        if not f.exists():  # content-addressed: idempotent
            tmp = d / ".tmp"
            tmp.write_bytes(blob)
            tmp.rename(f)
            (d / "meta.json").write_text(json.dumps({"kind": kind, "name": name}))
        return f"{tier}://{digest}/{name}"

    def get(self, ref: str) -> Any:
        tier, rest = ref.split("://", 1)
        digest = rest.split("/", 1)[0]
        d = self._objects(tier) / digest
        blob = (d / "data").read_bytes()
        if hashlib.sha256(blob).hexdigest() != digest:
            raise IOError(f"integrity failure for {ref}")
        kind = json.loads((d / "meta.json").read_text())["kind"]
        return self._decode(blob, kind)

    def exists(self, ref: str) -> bool:
        tier, rest = ref.split("://", 1)
        digest = rest.split("/", 1)[0]
        return (self._objects(tier) / digest / "data").exists()

    def put_tree(self, tree: Any, tier: str = "shared", name: str = "tree") -> str:
        """Store a pytree (torch/np arrays + containers) as one artifact."""
        from torch.utils._pytree import tree_flatten

        leaves, treedef = tree_flatten(tree)
        refs = [self.put(np.asarray(v), tier=tier, name=f"{name}.{i}") for i, v in enumerate(leaves)]
        meta = {"treedef": str(treedef), "leaves": refs}
        return self.put(meta, tier=tier, name=name)

    # ------------------------------------------------------------------
    def claim(self, name: str, tier: str = "shared", capacity_bytes: int = 1 << 34) -> VolumeClaim:
        base = self.root / tier if tier == "shared" else self.root / tier / self.node_id
        path = base / "claims" / name
        path.mkdir(parents=True, exist_ok=True)
        return VolumeClaim(name=name, tier=tier, capacity_bytes=capacity_bytes, path=path)

    def release(self, claim: VolumeClaim):
        shutil.rmtree(claim.path, ignore_errors=True)
