"""Advisory import-graph orphan report over ``src/repro_torch``.

Builds the static import graph of the port (stdlib ``ast``, no code
executed) and reports modules unreachable from the entry-point roots:

  * the ``repro_torch.core`` / ``batch`` / ``serve`` / ``analysis``
    packages (the PC pipeline's public API and this suite),
  * every driver directly under ``repro_torch.launch``,
  * whatever ``tests/``, ``scripts/`` and ``chip_smoke.py`` import.

Orphans are ADVISORY, not findings: an orphan here is a prompt to either
wire the module up or delete it, not a failed run.
"""
from __future__ import annotations

import ast
from pathlib import Path

PACKAGE = "repro_torch"
ROOT_PACKAGES = tuple(f"{PACKAGE}.{p}" for p in ("core", "batch", "serve", "analysis"))


def _module_name(py: Path, src: Path) -> str:
    parts = list(py.relative_to(src).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_relative(mod: str, node: ast.ImportFrom) -> str | None:
    if not node.level:
        return node.module
    base = mod.split(".")
    base = base[: len(base) - node.level]
    if node.module:
        base = base + node.module.split(".")
    return ".".join(base) if base else None


def _edges(py: Path, mod: str, is_pkg: bool) -> set[str]:
    try:
        tree = ast.parse(py.read_text())
    except (OSError, SyntaxError):
        return set()
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            # an __init__ module's package is itself: resolve as one level down
            base = _resolve_relative(mod + "._" if is_pkg else mod, node)
            if base:
                out.add(base)
                # `from pkg import sub` may bind a submodule
                out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _known(dep: str, modules) -> str | None:
    """The longest prefix of ``dep`` that is a module of the port."""
    cand = dep
    while cand and cand not in modules:
        cand = cand.rpartition(".")[0]
    return cand if cand and cand.startswith(PACKAGE) else None


def build_graph(repo_root: str | Path) -> tuple[dict[str, set[str]], set[str]]:
    """(adjacency over repro_torch.* module names, root module set)."""
    repo_root = Path(repo_root)
    src = repo_root / "src"
    modules: dict[str, Path] = {}
    for py in sorted((src / PACKAGE).rglob("*.py")):
        if "__pycache__" not in py.parts:
            modules[_module_name(py, src)] = py

    graph: dict[str, set[str]] = {}
    for mod, py in modules.items():
        deps = {_known(d, modules) for d in _edges(py, mod, py.name == "__init__.py")}
        graph[mod] = {d for d in deps if d} - {mod}

    roots = {r for r in ROOT_PACKAGES if r in graph}
    roots.update(m for m in graph
                 if m.startswith(f"{PACKAGE}.launch.") and m.count(".") == 2)
    extra = [repo_root / "chip_smoke.py"]
    for extra_dir in ("tests", "scripts"):
        d = repo_root / extra_dir
        if d.is_dir():
            extra += sorted(d.glob("*.py"))
    for py in extra:
        if py.exists():
            roots.update(r for r in (_known(d, graph) for d in _edges(py, py.stem, False)) if r)
    return graph, roots


def reachable(graph: dict[str, set[str]], roots: set[str]) -> set[str]:
    seen: set[str] = set()
    stack = [r for r in roots if r in graph]
    while stack:
        mod = stack.pop()
        if mod in seen:
            continue
        seen.add(mod)
        # reaching a module implies importing its package chain
        parent = mod.rpartition(".")[0]
        if parent in graph and parent not in seen:
            stack.append(parent)
        stack.extend(d for d in graph.get(mod, ()) if d not in seen)
    return seen


def orphans(repo_root: str | Path) -> list[str]:
    graph, roots = build_graph(repo_root)
    live = reachable(graph, roots)
    out = []
    for mod in sorted(graph):
        if mod in live or mod.endswith(".__main__"):  # `python -m` entry
            continue
        # a package whose members are all orphaned reports once
        if any(mod.startswith(o + ".") for o in out):
            continue
        out.append(mod)
    return out


def report(repo_root: str | Path) -> list[str]:
    """Human-readable advisory lines (empty when the tree is fully live)."""
    orphan_list = orphans(repo_root)
    if not orphan_list:
        return []
    lines = [f"advisory: {len(orphan_list)} module(s) of the port unreachable from the "
             "entry-point roots (core/batch/serve/analysis, launch drivers, tests, "
             "scripts, chip_smoke.py):"]
    return lines + [f"  - {m}" for m in orphan_list]


__all__ = ["build_graph", "reachable", "orphans", "report", "ROOT_PACKAGES"]
