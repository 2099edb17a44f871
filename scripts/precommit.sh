#!/usr/bin/env bash
# Lint + smoke harness — the counterpart of the reference's
# scripts/precommit.sh (clang-format + cmake-format + clang-tidy).
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== repo hygiene =="
# __graft_entry__.py is the one sanctioned root-level _* file (driver harness).
if git ls-files | grep '^_' | grep -vq '^__graft_entry__'; then
    echo "ERROR: root-level _* scratch files are not allowed:" >&2
    git ls-files | grep '^_' | grep -v '^__graft_entry__' >&2
    exit 1
fi

echo "== compile check =="
python -m compileall -q cpu_path_tracing_tpu tests bench.py chip_smoke.py __graft_entry__.py

echo "== format gate (unconditional; scripts/format.py, stdlib) =="
# The reference's clang-format diff gate (its precommit.sh:3-5) — run the
# normalizer in check mode; any diff fails the commit.
python scripts/format.py --check

echo "== lint (unconditional; scripts/lint.py, stdlib AST) =="
# The reference's clang-tidy gate is unconditional (WarningsAsErrors: '1',
# scripts/precommit.sh:7 there); this one must be too — scripts/lint.py has
# zero dependencies, so there is no "linter not installed" escape hatch.
python scripts/lint.py

if command -v ruff >/dev/null 2>&1; then
    echo "== ruff (supplementary, when available) =="
    ruff check cpu_path_tracing_tpu tests
fi
# Type checking: no mypy/pyright ships in the execution image and installs
# are off-limits there; run it when a dev machine has it (supplementary,
# like ruff — the unconditional gate above never silently vanishes).
if command -v mypy >/dev/null 2>&1; then
    echo "== mypy (supplementary, when available) =="
    mypy --ignore-missing-imports cpu_path_tracing_tpu
fi

echo "== native build =="
make -C native >/dev/null

echo "== fast tests =="
t0=$(date +%s)
# Two workers, whole files per worker (pytest-xdist when available): the
# tier is dominated by a few compile-heavy files, so loadfile keeps their
# session-scoped compile caches warm while the other worker drains the long
# tail.  -x is incompatible with xdist scheduling; failures still fail.
if python -c "import xdist" >/dev/null 2>&1; then
    python -m pytest tests/ -q -m "not slow" -n 2 --dist loadfile
else
    python -m pytest tests/ -q -m "not slow" -x
fi
echo "fast tier took $(( $(date +%s) - t0 ))s"

echo "precommit OK"
