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
import os
import pickle
import shutil
import threading
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
        return self._put_blob(*self._encode(obj), tier=tier, name=name)

    def _put_blob(self, blob: bytes, kind: str, tier: str, name: str) -> str:
        digest = hashlib.sha256(blob).hexdigest()
        d = self._objects(tier) / digest
        d.mkdir(exist_ok=True)
        f = d / "data"
        if not f.exists():  # content-addressed: idempotent
            # writers of one object (engine workers flushing the same
            # prefix page) each stage a private file and replace
            # atomically, the meta before the data, so a reader that finds
            # the data finds its meta; a shared ".tmp" raced: the second
            # rename found the first writer had moved it
            tag = f"{os.getpid()}.{threading.get_ident()}"
            meta = d / f".meta.{tag}"
            meta.write_text(json.dumps({"kind": kind, "name": name}))
            meta.replace(d / "meta.json")
            tmp = d / f".tmp.{tag}"
            tmp.write_bytes(blob)
            tmp.replace(f)
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
        """Store a pytree (torch/np arrays + containers) as one artifact.

        Leaves, their order, their bytes and the meta are the JAX
        package's for the same values (``jax.tree.flatten`` order: dict
        keys sorted, lists and tuples in order, None an empty node), so
        both packages give the same refs: a tensor is stored from the CPU
        and detached, a bf16 one as the 16-bit pattern JAX's numpy view
        writes (read back as ``V2``)."""
        leaves, treedef = tree_flatten(tree)
        refs = [self._put_leaf(v, tier=tier, name=f"{name}.{i}")
                for i, (_, v) in enumerate(leaves)]
        meta = {"treedef": treedef, "leaves": refs}
        return self.put(meta, tier=tier, name=name)

    def _put_leaf(self, leaf: Any, tier: str, name: str) -> str:
        return self._put_blob(npy_bytes(leaf), "ndarray", tier=tier,
                              name=name)

    # ------------------------------------------------------------------
    def claim(self, name: str, tier: str = "shared", capacity_bytes: int = 1 << 34) -> VolumeClaim:
        base = self.root / tier if tier == "shared" else self.root / tier / self.node_id
        path = base / "claims" / name
        path.mkdir(parents=True, exist_ok=True)
        return VolumeClaim(name=name, tier=tier, capacity_bytes=capacity_bytes, path=path)

    def release(self, claim: VolumeClaim):
        shutil.rmtree(claim.path, ignore_errors=True)


def tree_flatten(tree: Any) -> tuple[list[tuple[str, Any]], str]:
    """``tree``'s leaves in ``jax.tree.flatten`` order, each beside its key
    path as ``jax.tree_util.keystr`` prints it (``['params']['embed']``,
    ``[0]``), and its structure as JAX prints it (``PyTreeDef(...)``)."""
    leaves: list = []
    return leaves, f"PyTreeDef({_flatten(tree, leaves, '')})"


def _flatten(node: Any, leaves: list, path: str) -> str:
    """Append ``node``'s (key path, leaf) pairs to ``leaves`` in
    ``jax.tree.flatten`` order and return its structure as JAX prints it
    inside ``PyTreeDef(...)``."""
    if node is None:
        return "None"
    if isinstance(node, dict):
        inner = ", ".join(f"{k!r}: {_flatten(node[k], leaves, f'{path}[{k!r}]')}"
                          for k in sorted(node))
        return "{" + inner + "}"
    if isinstance(node, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves, f"{path}[{i}]")
                          for i, v in enumerate(node))
        if isinstance(node, list):
            return f"[{inner}]"
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    leaves.append((path, node))
    return "*"


def host_array(leaf: Any) -> np.ndarray:
    """A leaf as the numpy array ``np.save`` writes: a tensor detached,
    on the CPU and contiguous; a bf16 tensor as its 16-bit patterns
    (int16; :func:`npy_bytes` gives it JAX's bf16 header)."""
    import torch

    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def npy_bytes(leaf: Any, bf16: bool | None = None) -> bytes:
    """The ``.npy`` file JAX's ``np.save`` writes for the same values. A
    bf16 tensor (or, with ``bf16=True``, an int16 array of bf16 patterns
    from :func:`host_array`) gets JAX's bfloat16 header, descr ``'<V2'``
    (plain numpy's V2 would write ``'|V2'``), then its raw bits."""
    import torch

    if bf16 is None:
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    arr = host_array(leaf)
    buf = io.BytesIO()
    if not bf16:
        np.save(buf, arr)
        return buf.getvalue()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": "<V2", "fortran_order": False, "shape": tuple(arr.shape)})
    buf.write(np.ascontiguousarray(arr).tobytes())
    return buf.getvalue()
