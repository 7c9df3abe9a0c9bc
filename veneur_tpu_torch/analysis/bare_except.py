"""vtlint pass: no silent error swallowing in the egress paths.

Fails on two patterns inside the port's egress modules:

  except:                      # bare except — catches KeyboardInterrupt
  except Exception: pass       # swallow with NO logging/accounting

Both hide exactly the failures the reliability layer exists to count: a
dropped flush that is neither retried, spilled, nor reported is an
invisible data loss. `except BaseException:` with a bare re-raise
passes (the resource-cleanup idiom); a body that does real work passes.
"""

from __future__ import annotations

import ast
from typing import List

from veneur_tpu_torch.analysis.core import Finding, Project

NAME = "bare-except"
DOC = ("egress paths never swallow errors silently "
       "(no bare except, no `except Exception: pass`)")

# the egress surface: everything that ships data out of the process
EGRESS = [
    "veneur_tpu_torch/sinks",
    "veneur_tpu_torch/forward",
    "veneur_tpu_torch/reliability",
    "veneur_tpu_torch/server/server.py",
]


def _is_swallow(handler: ast.ExceptHandler) -> bool:
    """True for a body that does nothing at all."""
    return all(isinstance(stmt, ast.Pass)
               or (isinstance(stmt, ast.Expr)
                   and isinstance(stmt.value, ast.Constant)
                   and stmt.value.value is Ellipsis)
               for stmt in handler.body)


def _is_reraise_only(handler: ast.ExceptHandler) -> bool:
    return (len(handler.body) == 1
            and isinstance(handler.body[0], ast.Raise)
            and handler.body[0].exc is None)


def run(project: Project, egress: List[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    for ctx in project.files(*(egress or EGRESS)):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None and not _is_reraise_only(node):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    "bare `except:` in egress path"))
            elif (isinstance(node.type, ast.Name)
                  and node.type.id in ("Exception", "BaseException")
                  and _is_swallow(node)):
                findings.append(Finding(
                    NAME, ctx.rel, node.lineno,
                    f"`except {node.type.id}:` swallows silently "
                    "(log it or count it)"))
    return findings
