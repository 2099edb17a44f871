"""Zero-dependency Python formatter gate.

The reference makes clang-format an *unconditional* diff-check gate
(``/root/reference/scripts/precommit.sh:3-5``: format, then fail on any
diff).  This execution image ships no Python formatter (no ruff/black, and
installs are off-limits), so — like scripts/lint.py for clang-tidy — the
gate is implemented on the stdlib: a deterministic whitespace normalizer
with ``--check`` (diff gate, used by precommit) and in-place fix modes.

Normalizations (the mechanically-safe formatter subset; style-level
reflowing needs a real formatter and is left to the opportunistic ruff
hook in precommit.sh):

* strip trailing whitespace
* LF line endings (no CRLF)
* no hard tabs in indentation (4 spaces each)
* exactly one newline at end of file; no blank lines at EOF
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOTS = ("cpu_path_tracing_tpu", "tests", "scripts", "bench.py", "chip_smoke.py",
         "__graft_entry__.py")


def normalize(text: str) -> str:
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    lines = text.split("\n")
    out = []
    for ln in lines:
        stripped = ln.rstrip()
        # expand leading tabs only (string literals keep interior tabs)
        lead = len(stripped) - len(stripped.lstrip("\t "))
        head = stripped[:lead].replace("\t", "    ")
        out.append(head + stripped[lead:])
    while out and out[-1] == "":
        out.pop()
    return "\n".join(out) + "\n" if out else ""


def py_files() -> list[Path]:
    files: list[Path] = []
    for root in ROOTS:
        p = Path(root)
        if p.is_file():
            files.append(p)
        else:
            files.extend(sorted(p.rglob("*.py")))
    return files


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="fail (listing files) instead of rewriting")
    args = ap.parse_args()
    dirty = []
    for f in py_files():
        src = f.read_text()
        fixed = normalize(src)
        if fixed != src:
            dirty.append(str(f))
            if not args.check:
                f.write_text(fixed)
    if dirty:
        verb = "would reformat" if args.check else "reformatted"
        print(f"format.py: {verb} {len(dirty)} file(s):", file=sys.stderr)
        for d in dirty:
            print(f"  {d}", file=sys.stderr)
        return 1 if args.check else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
