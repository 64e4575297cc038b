"""Step graph: the workflow DAG that the splitter produces and the scheduler runs.

A ``Step`` is an executable unit (one or more fused notebook cells, or a
programmatic step like "train"). Edges carry the *pipe artifacts* — the
variable names that flow between steps (stored in the ArtifactStore at run
time, referenced by content hash on the bus).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from repro_torch.core.notebook import Cell


@dataclass
class Step:
    name: str
    cells: list[Cell] = field(default_factory=list)
    fn: Callable[[dict], dict] | None = None
    reads: set[str] = field(default_factory=set)
    writes: set[str] = field(default_factory=set)
    # deployment knobs (paper §3.2/§3.5) — consumed by PodSpec/Scheduler
    replicas: int = 1
    max_attempts: int = 3
    resources: dict = field(default_factory=dict)
    long_running: bool = False  # train-style step: checkpointed, resumable

    def run(self, inputs: dict) -> dict:
        env = dict(inputs)
        if self.fn is not None:
            out = self.fn(inputs)
            assert set(out) >= self.writes, (self.name, set(out), self.writes)
            return {k: out[k] for k in self.writes}
        for c in self.cells:
            c.run(env)
        return {k: env[k] for k in self.writes if k in env}


@dataclass
class StepGraph:
    steps: dict[str, Step]
    edges: dict[tuple[str, str], set[str]]  # (src, dst) -> pipe artifact names
    external_inputs: set[str] = field(default_factory=set)

    # ------------------------------------------------------------------
    def deps(self, name: str) -> set[str]:
        return {s for (s, d) in self.edges if d == name}

    def consumers(self, name: str) -> set[str]:
        return {d for (s, d) in self.edges if s == name}

    def topological(self) -> list[str]:
        order, seen, temp = [], set(), set()

        def visit(n: str):
            if n in seen:
                return
            if n in temp:
                raise ValueError(f"cycle involving step {n!r}")
            temp.add(n)
            for d in sorted(self.deps(n)):
                visit(d)
            temp.discard(n)
            seen.add(n)
            order.append(n)

        for n in sorted(self.steps):
            visit(n)
        return order

    def validate(self):
        self.topological()  # raises on cycles
        for (s, d), names in self.edges.items():
            assert s in self.steps and d in self.steps, (s, d)
            assert names <= self.steps[s].writes, (
                f"edge {s}->{d} carries {names - self.steps[s].writes} "
                f"not written by {s}"
            )
        return self

    def to_dot(self) -> str:
        lines = ["digraph workflow {"]
        for n in self.steps:
            lines.append(f'  "{n}";')
        for (s, d), names in sorted(self.edges.items()):
            label = ",".join(sorted(names))
            lines.append(f'  "{s}" -> "{d}" [label="{label}"];')
        lines.append("}")
        return "\n".join(lines)


def build_cell_dag(cells: Iterable[Cell]) -> list[tuple[int, int, set[str]]]:
    """Cell-level dataflow edges (i -> j means j reads something i last wrote)."""
    cells = list(cells)
    last_writer: dict[str, int] = {}
    edges: list[tuple[int, int, set[str]]] = []
    for j, c in enumerate(cells):
        by_src: dict[int, set[str]] = {}
        for name in c.reads:
            if name in last_writer:
                by_src.setdefault(last_writer[name], set()).add(name)
        for i, names in sorted(by_src.items()):
            edges.append((i, j, names))
        for name in c.writes:
            last_writer[name] = j
    return edges
