"""Finding records shared by every analysis layer of the port.

A finding is one violation of a machine-checked contract, identified by a
ruff-style code: ``RPR0xx`` source (AST) rules, ``RPR1xx`` dispatch-mode
analyzers over the entry points, ``RPR2xx`` checks of the CUDA kernels on
the card. The codes mirror ``src/repro/analysis``'s, so each rule finds
its counterpart there. Its *key* — ``CODE path::context::detail`` —
deliberately omits the line number so baseline entries survive unrelated
edits to the same file; the line is carried separately for display and
``--format github`` annotations.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    code: str  # e.g. "RPR001"
    path: str  # repo-relative posix path ("src/repro_torch/core/levels.py")
    line: int  # 1-based; 0 when the finding is not tied to a source line
    message: str  # human sentence, shown next to the location
    context: str = "<module>"  # enclosing symbol (function / entry / kernel name)
    detail: str = ""  # the specific primitive/argument that fired

    @property
    def key(self) -> str:
        """Line-independent identity used by the baseline and allowlist."""
        return f"{self.code} {self.path}::{self.context}::{self.detail}"

    def format(self, fmt: str = "text") -> str:
        if fmt == "github":
            return (
                f"::error file={self.path},line={max(self.line, 1)},"
                f"title={self.code}::{self.message}"
            )
        return f"{self.path}:{self.line}: {self.code} [{self.context}] {self.message}"


#: Rule catalog: code -> one-line description (its torch meaning). Each
#: layer registers its rules on import; ``--list-rules`` prints them.
RULE_CATALOG: dict[str, str] = {}


def register_rule(code: str, description: str) -> str:
    """Register a rule code in the catalog (idempotent; returns the code)."""
    existing = RULE_CATALOG.get(code)
    if existing is not None and existing != description:
        raise ValueError(f"rule {code} registered twice with different text")
    RULE_CATALOG[code] = description
    return code


@dataclass
class Report:
    """One analysis run: gating findings, advisory notes, and the tables a
    layer measured on the way (``tables[name]``: a list of row dicts, such
    as each entry's kernel counts or each kernel's resources)."""

    findings: list[Finding] = field(default_factory=list)
    advisories: list[str] = field(default_factory=list)
    tables: dict[str, list[dict]] = field(default_factory=dict)

    def extend(self, fs) -> None:
        self.findings.extend(fs)

    def sorted(self) -> list[Finding]:
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.code))
