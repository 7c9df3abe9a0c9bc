"""vtlint engine for the PyTorch/CUDA port: one AST parse per file,
shared by every pass.

A Project caches one FileContext per file — the parsed tree, an
import-alias map (`import numpy as np` -> np resolves to numpy), and
the `# vtlint: disable=<pass>` suppression table — and the passes share
it, so a lint run parses server.py once however many passes read it.

Suppression syntax (per line; a comment alone on its line also covers
the next line, so long statements can carry one above them):

    x = dev.cpu()  # vtlint: disable=torch-hot-path -- flush boundary

The reason string after `--` is mandatory: a suppression without one is
itself reported (pass name `vtlint`), so silencing a finding always
leaves a reviewable sentence behind.
"""

from __future__ import annotations

import ast
import pathlib
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

REPO = pathlib.Path(__file__).resolve().parent.parent.parent

_SUPPRESS_RE = re.compile(
    r"#\s*vtlint:\s*disable=([A-Za-z0-9_,-]+)"
    r"(?:\s+--\s*(.*?))?\s*(?:#|$)")


@dataclass(frozen=True)
class Finding:
    """One problem one pass found. `file` is project-relative ("" for
    project-level findings such as a missing required counter)."""
    pass_name: str
    file: str
    line: int
    message: str

    def format(self) -> str:
        loc = self.file or "<project>"
        if self.line:
            loc += f":{self.line}"
        return f"{loc}: [{self.pass_name}] {self.message}"


@dataclass
class Suppression:
    passes: Tuple[str, ...]
    reason: str
    line: int            # the line the comment is on


class FileContext:
    """One parsed Python file: tree + alias map + suppressions."""

    def __init__(self, root: pathlib.Path, rel: str, source: str):
        self.root = root
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=rel)
        # local name -> canonical dotted path, from this file's imports
        self.aliases: Dict[str, str] = {}
        # effective line -> suppression active there
        self.suppressions: Dict[int, Suppression] = {}
        self._build_aliases()
        self._build_suppressions()

    # -- alias / symbol resolution ------------------------------------------
    def _build_aliases(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Raw dotted name of a Name/Attribute chain, None for anything
        else (calls, subscripts)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path of a Name/Attribute chain with the
        file's import aliases applied: `np.asarray` -> numpy.asarray,
        `z` (from x import y as z) -> x.y."""
        raw = self.dotted(node)
        if raw is None:
            return None
        head, _, rest = raw.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    # -- suppressions --------------------------------------------------------
    def _build_suppressions(self) -> None:
        for lineno, text in enumerate(self.source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            passes = tuple(p.strip() for p in m.group(1).split(",")
                           if p.strip())
            sup = Suppression(passes, (m.group(2) or "").strip(), lineno)
            self.suppressions[lineno] = sup
            # a comment-only line suppresses the statement below it too
            if text.split("#", 1)[0].strip() == "":
                self.suppressions.setdefault(lineno + 1, sup)

    def suppressed(self, pass_name: str, line: int) -> bool:
        sup = self.suppressions.get(line)
        return bool(sup and (pass_name in sup.passes
                             or "all" in sup.passes))


class Project:
    """Root + parsed-file cache. `parse_count` exists so tests can pin
    the one-parse-per-file contract."""

    def __init__(self, root) -> None:
        self.root = pathlib.Path(root)
        self._files: Dict[str, Optional[FileContext]] = {}
        self.parse_count = 0

    def file(self, rel: str) -> Optional[FileContext]:
        """FileContext for a project-relative path; None when the file
        is missing or unparseable (passes report that themselves)."""
        if rel not in self._files:
            path = self.root / rel
            ctx = None
            if path.is_file():
                try:
                    ctx = FileContext(self.root, rel, path.read_text())
                    self.parse_count += 1
                except SyntaxError:
                    ctx = None
            self._files[rel] = ctx
        return self._files[rel]

    def exists(self, rel: str) -> bool:
        return (self.root / rel).is_file()

    def files(self, *entries: str) -> Iterable[FileContext]:
        """Every parseable .py under the given project-relative files or
        directories, in sorted order, via the cache."""
        rels: List[str] = []
        for entry in entries:
            p = self.root / entry
            if p.is_file():
                rels.append(entry)
            elif p.is_dir():
                rels.extend(
                    str(f.relative_to(self.root))
                    for f in sorted(p.rglob("*.py")))
        for rel in rels:
            ctx = self.file(rel)
            if ctx is not None:
                yield ctx


def filter_suppressed(project: Project, findings: List[Finding]
                      ) -> List[Finding]:
    """Drop findings their file suppresses, and report any suppression
    comment missing a reason string (pass name `vtlint`)."""
    kept = []
    for f in findings:
        ctx = project.file(f.file) if f.file.endswith(".py") else None
        if ctx is not None and f.line \
                and ctx.suppressed(f.pass_name, f.line):
            continue
        kept.append(f)
    return kept


def reasonless_suppressions(project: Project) -> List[Finding]:
    """Framework self-check: every `# vtlint: disable=` comment must
    carry a `-- reason`. Scans only files already parsed this run, so
    it costs no extra parse."""
    out = []
    for rel, ctx in sorted(project._files.items()):
        if ctx is None:
            continue
        seen = set()
        for sup in ctx.suppressions.values():
            if id(sup) in seen:
                continue
            seen.add(id(sup))
            if not sup.reason:
                out.append(Finding(
                    "vtlint", rel, sup.line,
                    "suppression without a reason — write "
                    "`# vtlint: disable=<pass> -- <why>`"))
    return out
