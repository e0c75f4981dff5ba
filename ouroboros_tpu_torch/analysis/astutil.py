"""Shared AST plumbing for the ouro-lint passes."""
from __future__ import annotations

import ast
import os
from typing import Iterable, Iterator, List, Optional, Tuple

from . import REPO_ROOT


def iter_py_files(*subdirs: str, exclude: Iterable[str] = (),
                  exclude_dirs: Iterable[str] = ()) -> Iterator[str]:
    """Yield absolute paths of .py files under repo-relative `subdirs`
    (an entry may also be a single repo-relative .py FILE, e.g. a
    top-level script like bench.py), skipping repo-relative paths in
    `exclude` and whole repo-relative directory prefixes in
    `exclude_dirs`."""
    excluded = {e.replace("/", os.sep) for e in exclude}
    dir_prefixes = tuple(d.rstrip("/").replace("/", os.sep) + os.sep
                         for d in exclude_dirs)
    for sub in subdirs:
        base = os.path.join(REPO_ROOT, sub)
        if os.path.isfile(base):
            if base.endswith(".py") and \
                    os.path.relpath(base, REPO_ROOT) not in excluded:
                yield base
            continue
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, REPO_ROOT)
                if rel in excluded or rel.startswith(dir_prefixes):
                    continue
                yield path


def parse_file(path: str) -> ast.Module:
    with open(path, "rb") as f:
        return ast.parse(f.read(), filename=path)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class QualnameVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing def/class qualname, the way
    the baseline identifies findings.  Subclasses read `self.qualname`."""

    def __init__(self):
        self._stack: List[str] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) or "<module>"

    def _visit_scope(self, node):
        self._stack.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._stack.pop()

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_ClassDef = _visit_scope


def assignment_line(tree: ast.Module, attr: str) -> int:
    """Line where module attribute `attr` is (last) assigned, or 1.

    Handles tuple targets (`SPEC, CODEC, X = wrap(...)`) too — used by the
    protocol pass to anchor registry findings back to source."""
    line = 1

    def targets(node):
        for t in getattr(node, "targets", None) or [node.target]:
            if isinstance(t, (ast.Tuple, ast.List)):
                yield from t.elts
            else:
                yield t

    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in targets(node):
                if isinstance(t, ast.Name) and t.id == attr:
                    line = node.lineno
    return line
