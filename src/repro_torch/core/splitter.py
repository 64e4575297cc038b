"""Piped-section splitting (paper §3.1 — the "algorithms" in the title).

The paper splits a notebook "based on its piped sections" (via nbmanips).
We make the algorithm precise:

  1. extract per-cell read/write sets (AST; ``notebook.py``),
  2. build the cell-level dataflow DAG,
  3. contract *linear private chains*: cell j is merged into the group of
     cell i when i is j's unique producer group, j is the only consumer of
     everything that group exports, and no group boundary was forced —
     i.e. the pipe between them is private, so shipping it through the
     broker would be pure overhead,
  4. a ``# %%pipe`` tag (or any group fan-out/fan-in) forces a boundary,
  5. each group becomes a Step; group-crossing dataflow becomes the pipe
     artifacts on the edges.

This maximizes parallelism (fan-out cells end up in distinct pods) while
never paying broker+storage latency for dataflow that no other step needs.
"""

from __future__ import annotations

from repro_torch.core.dag import Step, StepGraph, build_cell_dag
from repro_torch.core.notebook import Cell, Notebook


def split_pipeline(nb: Notebook) -> StepGraph:
    cells = nb.cells
    n = len(cells)
    edges = build_cell_dag(cells)
    consumers: dict[int, set[int]] = {i: set() for i in range(n)}
    producers: dict[int, set[int]] = {i: set() for i in range(n)}
    for i, j, _names in edges:
        consumers[i].add(j)
        producers[j].add(i)

    # --- group assignment (union-find over the chain-contraction rule) ---
    group = list(range(n))

    def find(i: int) -> int:
        while group[i] != i:
            group[i] = group[group[i]]
            i = group[i]
        return i

    for j in range(n):
        if "pipe" in cells[j].tags:
            continue  # forced boundary: j starts its own group
        prods = {find(i) for i in producers[j]}
        if len(prods) != 1:
            continue  # fan-in (or source cell): boundary
        g = prods.pop()
        # j must be the ONLY consumer of group g's members
        g_members = [m for m in range(n) if find(m) == g]
        outside = {
            c for m in g_members for c in consumers[m] if find(c) not in (g, find(j))
        }
        if outside:
            continue  # group g fans out elsewhere: boundary
        group[j] = g

    # --- build steps ---
    by_group: dict[int, list[int]] = {}
    for i in range(n):
        by_group.setdefault(find(i), []).append(i)

    def step_name(members: list[int]) -> str:
        first = cells[members[0]]
        return first.name or f"step{members[0]}"

    steps: dict[str, Step] = {}
    gname: dict[int, str] = {}
    for g, members in sorted(by_group.items()):
        members.sort()
        name = step_name(members)
        reads: set[str] = set()
        writes: set[str] = set()
        internal_writes: set[str] = set()
        for m in members:
            reads |= cells[m].reads - internal_writes
            internal_writes |= cells[m].writes
        # exports = names written here and read by other groups (or final)
        writes = set(internal_writes)
        steps[name] = Step(name=name, cells=[cells[m] for m in members],
                           reads=reads, writes=writes)
        gname[g] = name

    # --- group-crossing edges ---
    gedges: dict[tuple[str, str], set[str]] = {}
    for i, j, names in edges:
        gi, gj = find(i), find(j)
        if gi == gj:
            continue
        key = (gname[gi], gname[gj])
        gedges.setdefault(key, set()).update(names)

    # NOTE: steps export all their writes. Only the names on EDGES travel as
    # pipes between pods; the rest are recorded as (possibly final) workflow
    # outputs — statically we cannot tell a junk intermediate from a result
    # the scientist wants, so we keep them (storage is content-addressed and
    # dedup'd, the cost is negligible).

    ext = set().union(*[c.reads for c in cells] or [set()])
    produced = set().union(*[c.writes for c in cells] or [set()])
    graph = StepGraph(steps=steps, edges=gedges, external_inputs=ext - produced)
    return graph.validate()
