"""The port's kernel build under concurrency, with a stand-in compiler.

The serve driver creates one engine per worker thread, and each engine's
first kernel call builds and loads the CUDA libraries. Several threads
building at once must compile each library once and never see a
half-written one. A fake ``nvcc`` (a script that takes a while and then
writes its ``-o`` file) stands in for the compiler, so this runs on the
CPU.
"""

import os
import stat
import sys
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({calls!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.3)
with open(out, "wb") as f:
    f.write(b"built")
"""


def test_concurrent_builds_compile_each_library_once(tmp_path, monkeypatch):
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")

    errors, results = [], []

    def worker():
        try:
            results.append(build.build())
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 4 and all(r == results[0] for r in results)
    for name, path in results[0].items():
        assert path.read_bytes() == b"built", name
    compiled = calls.read_text().split()
    assert len(compiled) == len(build.SOURCES)  # once per library
    assert not [p for p in os.listdir(tmp_path / "kernels")
                if p.endswith(".tmp")]


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_path_follows_headers(name, tmp_path, monkeypatch):
    """A library's path (the hash it is cached under) changes when a
    ``.cuh`` header in ``csrc/`` changes, or when one is added, so an
    edited header rebuilds (with the stand-in compiler) instead of loading
    a stale library; an unchanged tree builds nothing the second time."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")

    def compiles():
        return len(calls.read_text().split()) if calls.exists() else 0

    before = build.build((name,))[name]
    assert build.build((name,))[name] == before and compiles() == 1
    header = csrc / "attention_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = build.build((name,))[name]
    assert edited != before and edited.exists() and compiles() == 2
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path(name) not in (before, edited)
