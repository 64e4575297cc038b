"""Notebook model + AST dataflow extraction (paper §3.1, first half).

A ``Notebook`` is an ordered list of ``Cell``s. Cells carry Python source
(as in .ipynb) or a Python callable (the programmatic API used by the ML
pipelines). For source cells we statically extract

  * ``reads``  — names loaded before being stored (free inputs),
  * ``writes`` — names stored at the top level (outputs),

which is exactly the information Jup2Kub needs to reconstruct the implicit
dataflow that the linear notebook hides.
"""

from __future__ import annotations

import ast
import builtins
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable


_BUILTINS = set(dir(builtins))


class _Usage(ast.NodeVisitor):
    """Collect top-level reads (free loads) and writes (stores)."""

    def __init__(self):
        self.reads: set[str] = set()
        self.writes: set[str] = set()
        self._local_scopes: list[set[str]] = []

    # --- name accounting ---
    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            if node.id not in self.writes and node.id not in _BUILTINS:
                if not any(node.id in s for s in self._local_scopes):
                    self.reads.add(node.id)
        elif isinstance(node.ctx, (ast.Store, ast.Del)):
            if self._local_scopes:
                self._local_scopes[-1].add(node.id)
            else:
                self.writes.add(node.id)
        self.generic_visit(node)

    def visit_Import(self, node):
        for a in node.names:
            self.writes.add((a.asname or a.name).split(".")[0])

    def visit_ImportFrom(self, node):
        for a in node.names:
            self.writes.add(a.asname or a.name)

    def _visit_scoped(self, node, params: list[str]):
        # function/lambda bodies get a local scope seeded with parameters
        self._local_scopes.append(set(params))
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self._local_scopes.pop()

    def visit_FunctionDef(self, node):
        self.writes.add(node.name)
        params = [a.arg for a in node.args.args + node.args.kwonlyargs]
        if node.args.vararg:
            params.append(node.args.vararg.arg)
        if node.args.kwarg:
            params.append(node.args.kwarg.arg)
        self._visit_scoped(node, params)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._visit_scoped(node, [a.arg for a in node.args.args])

    # comprehensions have their own scope in py3 — targets are not
    # module-level writes, and element reads of targets are not free reads
    def _visit_comp(self, node):
        self._local_scopes.append(set())
        for gen in node.generators:
            self.visit(gen.iter)
            self.visit(gen.target)  # Store -> local scope (pushed above)
            for cond in gen.ifs:
                self.visit(cond)
        if isinstance(node, ast.DictComp):
            self.visit(node.key)
            self.visit(node.value)
        else:
            self.visit(node.elt)
        self._local_scopes.pop()

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    def visit_ClassDef(self, node):
        self.writes.add(node.name)
        self._visit_scoped(node, [])

    def visit_AugAssign(self, node):
        # x += 1 both reads and writes x
        if isinstance(node.target, ast.Name):
            if not any(node.target.id in s for s in self._local_scopes):
                self.reads.add(node.target.id)
        self.generic_visit(node)

    def visit_Assign(self, node):
        # evaluation order: RHS first — `total = total + row` READS total
        self.visit(node.value)
        for t in node.targets:
            self.visit(t)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self.visit(node.value)
        self.visit(node.target)


def extract_usage(source: str) -> tuple[set[str], set[str]]:
    tree = ast.parse(source)
    u = _Usage()
    u.visit(tree)
    return u.reads, u.writes


@dataclass
class Cell:
    """One notebook cell: source xor fn."""

    source: str | None = None
    fn: Callable[[dict], dict] | None = None
    name: str = ""
    reads: set[str] = field(default_factory=set)
    writes: set[str] = field(default_factory=set)
    tags: set[str] = field(default_factory=set)  # e.g. {"pipe"} forces a boundary

    def __post_init__(self):
        if self.source is not None and not (self.reads or self.writes):
            self.reads, self.writes = extract_usage(self.source)
        if self.source is not None:
            for line in self.source.splitlines():
                ls = line.strip()
                if ls.startswith("# %%") or ls.startswith("#%%"):
                    self.tags.update(
                        t for t in ls.replace("#", "").replace("%", "").split() if t
                    )
        if self.fn is not None:
            assert self.reads or self.writes or self.name, (
                "callable cells must declare reads/writes"
            )

    def run(self, env: dict) -> dict:
        """Execute against an environment dict; returns {written: value}."""
        if self.fn is not None:
            out = self.fn({k: env[k] for k in self.reads if k in env})
            assert set(out) >= self.writes, (self.name, set(out), self.writes)
            env.update(out)
            return out
        assert self.source is not None
        exec(compile(self.source, f"<cell:{self.name}>", "exec"), env)  # noqa: S102
        return {k: env[k] for k in self.writes if k in env}


@dataclass
class Notebook:
    cells: list[Cell]
    name: str = "notebook"

    @classmethod
    def from_ipynb(cls, path: str | Path) -> "Notebook":
        raw = json.loads(Path(path).read_text())
        cells = []
        for i, c in enumerate(raw.get("cells", [])):
            if c.get("cell_type") != "code":
                continue
            src = "".join(c.get("source", []))
            if src.strip():
                cells.append(Cell(source=src, name=f"cell{i}"))
        return cls(cells, name=Path(path).stem)

    @classmethod
    def from_sources(cls, sources: list[str], name: str = "notebook") -> "Notebook":
        return cls(
            [Cell(source=s, name=f"cell{i}") for i, s in enumerate(sources)], name=name
        )

    def run_linear(self, env: dict | None = None) -> dict:
        """Execute the notebook the classic way (single kernel, in order)."""
        env = dict(env or {})
        for c in self.cells:
            c.run(env)
        return env
