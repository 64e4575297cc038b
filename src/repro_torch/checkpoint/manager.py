"""Distributed checkpointing: atomic, integrity-checked, JAX-compatible.

Layout (one directory per step, one .npy per pytree leaf), the JAX
package's (``repro/checkpoint/manager.py``):

    <root>/step_000123/
        MANIFEST.json   — tree structure, shapes, dtypes, sha256 per leaf,
                          user metadata, "committed": true (written LAST)
        leaf_00000.npy ...

Leaves go in ``jax.tree.flatten`` order under ``jax.tree_util.keystr``
keys, each file the bytes JAX's ``np.save`` writes for the same values
(bf16 under JAX's ``'<V2'`` header), and the treedef as JAX prints it
(``core/storage.py``'s rendering), so a train state of the same values
gives the same manifest leaf for leaf, and either package restores the
other's checkpoints.

Fault-tolerance properties (the paper's C6, adapted):
  * atomic commit: leaves are written into a ``.tmp`` dir which is fsynced
    and renamed; a crash mid-save never corrupts the latest checkpoint;
  * integrity: sha256 per leaf, verified on restore;
  * async: ``save(..., sync=False)`` snapshots to host then writes in a
    background thread, so the train loop overlaps I/O with compute;
  * leaves are written and hashed, and read and verified, by a pool of
    threads, each leaf's sha256 taken over the bytes written (the JAX
    package re-reads each file to hash it).

Elastic restore onto another device mesh (``restore(shardings=...)``)
needs tensor parallelism (ROADMAP A.10) and raises until then.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.core.storage import host_array, npy_bytes, tree_flatten


_IO_THREADS = 8


def _leaf_dtype(leaf: Any) -> str:
    """The dtype name JAX's manifest gives the leaf (``"bfloat16"``,
    ``"float32"``, ``"int32"``)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _from_npy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A loaded leaf as a CPU tensor of ``dtype``; bf16 files load as V2
    (16-bit patterns)."""
    if arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(dtype)


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def steps(self) -> list[int]:
        out = []
        for d in self.root.glob("step_*"):
            mf = d / "MANIFEST.json"
            if mf.exists():
                try:
                    if json.loads(mf.read_text()).get("committed"):
                        out.append(int(d.name.split("_")[1]))
                except (json.JSONDecodeError, ValueError, IndexError):
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def wait(self):
        """Block until a pending async save completes (re-raises its error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, meta: dict | None = None, sync: bool = True):
        self.wait()
        # snapshot to host memory first: the device->host copy that the
        # async thread must not race with (the train step updates its
        # state in place)
        leaves, structure = tree_flatten(tree)
        host = [(k, host_array(v), _leaf_dtype(v)) for k, v in leaves]

        def write():
            try:
                self._write(step, host, structure, meta or {})
            except BaseException as e:  # surfaced on next wait()/save()
                self._error = e

        if sync:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step: int, host: list, structure: str, meta: dict):
        final = self._step_dir(step)
        tmp = final.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        def one(i, keypath, arr, dtype):
            fname = f"leaf_{i:05d}.npy"
            blob = npy_bytes(arr, bf16=dtype == "bfloat16")
            (tmp / fname).write_bytes(blob)
            return {
                "key": keypath,
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype,
                "sha256": hashlib.sha256(blob).hexdigest(),
            }

        # leaves are written and hashed in parallel (file I/O and hashlib
        # release the GIL): a full-width train state is 3.6 GB
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            entries = list(pool.map(one, range(len(host)), *zip(*host)))
        manifest = {
            "step": step,
            "leaves": entries,
            "treedef": structure,
            "meta": meta,
            "committed": True,
        }
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(
        self,
        like: Any,
        step: int | None = None,
        shardings: Any = None,
        verify: bool = True,
    ) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of nested dicts
        whose leaves have ``shape`` and ``dtype``: tensors, e.g. on the
        ``meta`` device). Returns (the tree of CPU tensors in ``like``'s
        dtypes, the saved meta)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) places leaves on a device mesh, which "
                "the port does not have yet (ROADMAP A.10)")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.root}")
        d = self._step_dir(step)
        manifest = json.loads((d / "MANIFEST.json").read_text())
        by_key = {e["key"]: e for e in manifest["leaves"]}

        flat_like, _ = tree_flatten(like)
        for key, _ in flat_like:
            if key not in by_key:
                raise KeyError(f"checkpoint {d} missing leaf {key}")

        def one(key, ref):
            e = by_key[key]
            raw = (d / e["file"]).read_bytes()
            if verify:
                digest = hashlib.sha256(raw).hexdigest()
                if digest != e["sha256"]:
                    raise IOError(f"integrity failure for {key} in {d}")
            arr = np.load(io.BytesIO(raw))
            want_shape = tuple(ref.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"{key}: ckpt {arr.shape} vs expected {want_shape}")
            return key, _from_npy(arr, ref.dtype)

        with ThreadPoolExecutor(_IO_THREADS) as pool:
            out = dict(pool.map(one, *zip(*flat_like)))
        return _rebuild(like, out, ""), manifest["meta"]


def _rebuild(like: Any, by_key: dict, path: str) -> Any:
    """``like``'s nested dicts with each leaf replaced by ``by_key``'s
    entry at its key path."""
    if isinstance(like, dict):
        return {k: _rebuild(v, by_key, f"{path}[{k!r}]")
                for k, v in like.items()}
    return by_key[path]
