"""The PyTorch port stands alone: no JAX, no ``repro``, no silent fallback.

An AST walk of every file under ``src/repro_torch/`` and of
``chip_smoke.py`` asserts that none imports ``jax``/``jaxlib`` or any
``repro`` module (``repro_torch`` is the port itself), and that no ``try``
around an attention or SSD op or kernel launch has a handler that
carries on instead of raising, and that no handler anywhere calls a plain
version or an op: a CUDA tensor reaches its kernel or an error, never the
plain version behind the caller's back.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}
KERNEL_CALLS = {
    "flash_attention", "flash_attention_bhsd", "flash_attention_forward",
    "paged_attention", "paged_prefill_attention", "paged_mixed_attention",
    "paged_attention_bkgd", "paged_prefill_attention_ckgd",
    "paged_mixed_attention_rkgd", "paged_attention_decode",
    "paged_attention_prefill", "paged_attention_mixed",
    "ssd_scan", "ssd_decode_step", "ssd_scan_bshp", "ssd_decode_step_bh",
    "ssd_scan_chunked", "ssd_decode",
    # the model steps that reach them
    "decode_step_paged", "prefill_chunk", "mixed_step_paged",
    "decode_step_ssm", "prefill_chunk_ssm", "prefill", "decode_step",
    "prefill_whole",
}


def _ids(files):
    return [str(f.relative_to(REPO)) for f in files]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute):
                yield f.attr
            elif isinstance(f, ast.Name):
                yield f.id


def test_port_files_found():
    assert len(PORT_FILES) > 20
    assert (REPO / "src/repro_torch/kernels/csrc/paged_attention.cu").exists()
    assert (REPO / "src/repro_torch/kernels/csrc/ssd_scan.cu").exists()
    assert (REPO / "src/repro_torch/kernels/csrc/flash_attention.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=_ids(PORT_FILES))
def test_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=_ids(PORT_FILES))
def test_no_fallback_around_kernel_launches(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            called = set(_called_names(handler))
            assert not {n for n in called
                        if n.startswith(("paged_", "ssd_", "flash_"))} | (
                called & KERNEL_CALLS), (
                f"{path.name}:{handler.lineno}: an except handler runs "
                f"attention or the SSD itself (a fallback)")
        body_calls = {n for stmt in node.body for n in _called_names(stmt)}
        if not body_calls & KERNEL_CALLS:
            continue
        for handler in node.handlers:
            assert handler.body and isinstance(handler.body[-1], ast.Raise), (
                f"{path.name}:{handler.lineno}: an except around a kernel "
                f"launch must re-raise, not fall back")
