"""Unconditional static-analysis gate (stdlib-only AST linter).

The reference runs clang-tidy with ``WarningsAsErrors: '1'`` over the whole
compile DB as a HARD precommit step (``/root/reference/.clang-tidy:1-14``,
``/root/reference/scripts/precommit.sh:7``).  This repo's counterpart must be
equally unconditional, but the execution image ships no ruff/flake8/mypy and
installing tools is off-limits — so the gate is this self-contained linter:
zero dependencies, always runs, exit code 1 on any finding.  When ruff IS
available (developer machines), precommit.sh layers it on top.

Checks (chosen for high signal / zero false positives on idiomatic JAX code):

  * unused-import       an imported name never referenced in the module
  * unused-local        a function-local simple assignment never read
                        (skips _names, augmented/annotated targets, and
                        anything re-exported or closed over)
  * duplicate-def       two defs/classes of the same name in one scope
                        (the reference's include-guard collision class of
                        bug — SURVEY.md §1 notes all three scene headers
                        share one guard)
  * mutable-default     def f(x=[]) / f(x={}) / f(x=set())
  * bare-except         ``except:`` with no exception class

Usage: python scripts/lint.py [paths...]   (default: package + tests + root)
"""

from __future__ import annotations

import ast
import pathlib
import sys


class _ScopeVisitor(ast.NodeVisitor):
    """Collects findings for one module."""

    def __init__(self, path: str):
        self.path = path
        self.findings: list[tuple[int, str]] = []

    # ---------------- unused imports (module level only) ----------------
    def check_module(self, tree: ast.Module) -> None:
        imports: dict[str, int] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = (a.asname or a.name).split(".")[0]
                    imports[name] = node.lineno
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue  # compiler directives, not names
                for a in node.names:
                    if a.name == "*":
                        continue
                    imports[a.asname or a.name] = node.lineno

        used: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                pass  # the base Name node is walked separately
        # names referenced in __all__ or docstring-level re-export count
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                pass
        for name, lineno in sorted(imports.items()):
            if name not in used and not name.startswith("_"):
                # "import x as x" / "from y import x as x" is the PEP 484
                # re-export idiom; skip names exported via __all__ too.
                if name in _all_names(tree):
                    continue
                self.findings.append((lineno, f"unused-import: '{name}'"))

        self._check_scope_dupes(tree, "module")
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(node)
                self._check_defaults(node)
            elif isinstance(node, ast.ClassDef):
                self._check_scope_dupes(node, f"class {node.name}")
            elif isinstance(node, ast.ExceptHandler) and node.type is None:
                self.findings.append((node.lineno, "bare-except"))

    # ---------------- duplicate defs in one scope -----------------------
    def _check_scope_dupes(self, scope, label: str) -> None:
        seen: dict[str, int] = {}
        for node in scope.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                deco = {_deco_name(d) for d in node.decorator_list}
                # property setters / singledispatch registrations legitimately
                # reuse a name.
                if deco & {"setter", "getter", "deleter", "register", "overload"}:
                    continue
                if node.name in seen:
                    self.findings.append(
                        (node.lineno,
                         f"duplicate-def: '{node.name}' in {label} "
                         f"(first at line {seen[node.name]})"))
                seen[node.name] = node.lineno

    # ---------------- mutable default arguments -------------------------
    def _check_defaults(self, fn) -> None:
        for d in list(fn.args.defaults) + [d for d in fn.args.kw_defaults if d]:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                self.findings.append(
                    (fn.lineno, f"mutable-default in '{fn.name}'"))

    # ---------------- unused locals --------------------------------------
    def _check_function(self, fn) -> None:
        assigned: dict[str, int] = {}
        # Only simple single-target assignments; tuple unpacking is routinely
        # used for documentation ("a, _, c = f()") and loop protocols.
        for node in fn.body:
            self._collect_assigns(node, assigned)

        used: set[str] = set()
        nested_scopes = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Load, ast.Del)):
                used.add(node.id)
            if node is not fn and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                nested_scopes = True
        if nested_scopes:
            # Closures may capture names in ways the flat walk already
            # catches (Name/Load), so this is safe — but a nested scope's
            # *string* references (e.g. eval) are not; stay conservative
            # only for exec/eval users below.
            pass
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in ("eval", "exec", "locals", "vars"):
                return  # dynamic scope use: skip the check entirely

        for name, lineno in sorted(assigned.items()):
            if name not in used and not name.startswith("_"):
                self.findings.append(
                    (lineno, f"unused-local: '{name}' in '{fn.name}'"))

    def _collect_assigns(self, node, out: dict[str, int]) -> None:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.lineno
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue  # separate scope
            self._collect_assigns(child, out)


def _deco_name(d) -> str:
    while isinstance(d, ast.Call):
        d = d.func
    while isinstance(d, ast.Attribute):
        d = d.attr if isinstance(d.attr, str) else d.value
        if isinstance(d, str):
            return d
    return d.id if isinstance(d, ast.Name) else ""


def _all_names(tree: ast.Module) -> set[str]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "__all__" \
                and isinstance(node.value, (ast.List, ast.Tuple)):
            return {e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return set()


def lint_file(path: pathlib.Path) -> list[str]:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax-error: {e.msg}"]
    v = _ScopeVisitor(str(path))
    v.check_module(tree)
    return [f"{path}:{ln}: {msg}" for ln, msg in sorted(v.findings)]


def main(argv: list[str]) -> int:
    root = pathlib.Path(__file__).resolve().parent.parent
    if argv:
        targets = [pathlib.Path(a) for a in argv]
    else:
        targets = [root / "cpu_path_tracing_tpu", root / "tests",
                   root / "scripts", root / "bench.py",
                   root / "chip_smoke.py", root / "__graft_entry__.py"]
    files: list[pathlib.Path] = []
    for t in targets:
        if t.is_dir():
            files.extend(sorted(t.rglob("*.py")))
        elif t.suffix == ".py":
            files.append(t)
    findings: list[str] = []
    for f in files:
        if "__pycache__" in f.parts:
            continue
        findings.extend(lint_file(f))
    for line in findings:
        print(line)
    print(f"lint: {len(files)} files, {len(findings)} findings", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
