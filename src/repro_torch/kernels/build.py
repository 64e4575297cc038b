"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/<name>-<hash>.so`` at the repository root (``build/``
is git-ignored). The hash covers the source text, every header in
``csrc/`` (``*.cuh``, which a source may include) and the compiler flags,
so an edited kernel or header rebuilds on first use and an unchanged one
loads from the directory. All libraries not yet built compile in parallel, one ``nvcc``
per source. Building and loading hold one process-wide lock, so engines
created on several threads at once (the serve driver's workers) compile
each library once and never load a half-written one. Nothing here runs at
import time: the CPU tests import the package on machines with no
compiler.

    python -m repro_torch.kernels.build      # build every kernel, print times
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("paged_attention", "ssd_scan", "flash_attention")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()  # build() and load(); load() calls build()
# per library: seconds the build took in this process (0.0 = loaded as built)
build_seconds: dict[str, float] = {}
# per library: what ptxas reported (registers, shared memory, spills)
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _flags() -> list[str]:
    return ARCH_FLAGS + NVCC_FLAGS


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named library that is not built yet, all ``nvcc``
    processes started together; raises with the compiler output on failure."""
    with _lock:
        return _build(names)


def _build(names) -> dict[str, Path]:
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    for n in out:
        build_seconds.setdefault(n, 0.0)
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for n, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        build_seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, p)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first when needed."""
    with _lock:
        if name not in _loaded:
            path = build((name,))[name]
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


if __name__ == "__main__":
    paths = build()
    for n, p in paths.items():
        print(f"{n}: {p} ({build_seconds[n]:.1f} s)")
        if build_log.get(n):
            print(build_log[n])
