"""Capsule: ReproZip-style dependency capture, PyTorch/CUDA edition (paper §2.1, §3.1).

ReproZip traces syscalls to capture everything an experiment needs. A
PyTorch pipeline step has a much cleaner closure, which we capture *exactly*:

  * code      — source (or disassembly-stable qualname) of every cell/fn,
  * config    — the step's resolved configuration (dataclasses -> dict),
  * packages  — versions of every imported top-level package (torch and
    numpy always),
  * platform  — python version, machine, torch's CUDA version, the backend
    of the device the step runs on (``"cuda"`` or ``"cpu"``) and the
    number of CUDA devices,
  * data      — content hashes of consumed artifacts,
  * seeds     — RNG seeds.

``capsule_id`` is the sha256 over the canonical JSON — two steps with the
same id are bit-reproducible modulo hardware nondeterminism. ``seal_step``
turns (step, config) into a ``StepImage`` — the Docker-image analogue: a
frozen fn + capsule that the deployer ships to pods.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import inspect
import json
import platform
import sys
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.models.common import resolve_device


def _canon(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__, **{
            f.name: _canon(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }}
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(str(v) for v in obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _source_of(fn: Callable) -> str:
    try:
        return inspect.getsource(fn)
    except (OSError, TypeError):
        return getattr(fn, "__qualname__", repr(fn))


def package_versions(names: set[str]) -> dict[str, str]:
    out = {}
    for name in sorted(names):
        try:
            mod = importlib.import_module(name)
            out[name] = str(getattr(mod, "__version__", "unversioned"))
        except ImportError:
            out[name] = "missing"
    return out


@dataclass(frozen=True)
class Capsule:
    code: dict[str, str]
    config: dict
    packages: dict[str, str]
    platform: dict[str, str]
    data_hashes: dict[str, str] = field(default_factory=dict)
    seeds: dict[str, int] = field(default_factory=dict)

    @property
    def capsule_id(self) -> str:
        blob = json.dumps(_canon(dataclasses.asdict(self)), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["capsule_id"] = self.capsule_id
        return json.dumps(_canon(d), indent=1)

    @classmethod
    def from_json(cls, blob: str) -> "Capsule":
        d = json.loads(blob)
        d.pop("capsule_id", None)
        return cls(**d)


def capture(
    step,
    config: Any = None,
    data_hashes: dict[str, str] | None = None,
    seeds: dict[str, int] | None = None,
    extra_packages: set[str] | None = None,
    device="cuda",
) -> Capsule:
    """Capture a Step's full closure (the ReproZip `config.yml` analogue).
    ``device``: where the step runs (asking for CUDA without a card
    raises)."""
    code: dict[str, str] = {}
    if step.fn is not None:
        code[step.name] = _source_of(step.fn)
    for c in step.cells:
        code[c.name or "cell"] = c.source or _source_of(c.fn)
    pkgs = {"torch", "numpy"} | (extra_packages or set())
    plat = {
        "python": sys.version.split()[0],
        "machine": platform.machine(),
        "torch_cuda": str(torch.version.cuda),
        "torch_backend": resolve_device(device).type,
        "device_count": str(torch.cuda.device_count()),
    }
    return Capsule(
        code=code,
        config=_canon(config) if config is not None else {},
        packages=package_versions(pkgs),
        platform=plat,
        data_hashes=dict(data_hashes or {}),
        seeds=dict(seeds or {}),
    )


@dataclass
class StepImage:
    """The 'Docker image' of a step: sealed fn + capsule."""

    step: Any
    capsule: Capsule

    @property
    def tag(self) -> str:
        return f"{self.step.name}:{self.capsule.capsule_id[:12]}"

    def verify_against(self, other: "Capsule") -> list[str]:
        """Environment-drift report (paper: 'keeps working as tools change')."""
        drift = []
        for pkg, ver in self.capsule.packages.items():
            cur = other.packages.get(pkg)
            if cur != ver:
                drift.append(f"package {pkg}: captured {ver} vs current {cur}")
        for k, v in self.capsule.platform.items():
            cur = other.platform.get(k)
            if cur != v:
                drift.append(f"platform {k}: captured {v} vs current {cur}")
        return drift


def seal_step(step, config: Any = None, **kw) -> StepImage:
    return StepImage(step=step, capsule=capture(step, config, **kw))
