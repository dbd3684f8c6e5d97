#!/usr/bin/env python
"""Body-statement overlap sweep vs the reference.

For each (repo file, reference file) pair: strip docstrings/comments,
drop import/signature/decorator lines, keep normalized code lines longer
than 30 chars, and report the fraction of repo lines that appear verbatim
in the reference file. Gate: <15% per rewritten file.

Usage: python tools/overlap_sweep.py [repo_file ref_file]...
With no args, runs the default audit pairs.
"""

import ast
import io
import re
import sys
import tokenize

DEFAULT_PAIRS = [
    ("genjax_tpu/core/mask.py",
     "/root/reference/src/genjax/_src/core/generative/functional_types.py"),
    ("genjax_tpu/core/choice_map.py",
     "/root/reference/src/genjax/_src/core/generative/choice_map.py"),
    ("genjax_tpu/inference/sp.py",
     "/root/reference/src/genjax/_src/inference/sp.py"),
    ("genjax_tpu/adev/primitives.py",
     "/root/reference/src/genjax/_src/adev/primitives.py"),
    ("genjax_tpu/distributions/distribution.py",
     "/root/reference/src/genjax/_src/generative_functions/distributions/"
     "distribution.py"),
]

SKIP = re.compile(
    r"^\s*(import\s|from\s|def\s|class\s|@|\)|\]|\}|return$|pass$|else:|try:|finally:)"
)


def code_lines(path: str) -> list[str]:
    src = open(path).read()
    # Remove comments and docstrings via tokenization.
    out_tokens = []
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except tokenize.TokenizeError:
        toks = []
    drop_strings = set()
    try:
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                body = node.body
                if body and isinstance(body[0], ast.Expr) and isinstance(
                        body[0].value, ast.Constant) and isinstance(
                        body[0].value.value, str):
                    drop_strings.add(body[0].lineno)
    except SyntaxError:
        pass
    lines = src.splitlines()
    kept = []
    in_doc = 0
    for tok in toks:
        pass
    for i, raw in enumerate(lines, 1):
        line = raw.split("#")[0]
        norm = re.sub(r"\s+", " ", line.strip())
        if not norm or len(norm) <= 30:
            continue
        if SKIP.match(line.strip()):
            continue
        if norm.startswith(('"""', "'''", '"', "'", 'r"""', "f'")):
            continue
        kept.append(norm)
    # Crude docstring removal: drop lines inside triple-quoted spans.
    src_nodoc = re.sub(r'("""|\'\'\')(?:.|\n)*?\1', "", src)
    lines2 = []
    for raw in src_nodoc.splitlines():
        line = raw.split("#")[0]
        norm = re.sub(r"\s+", " ", line.strip())
        if not norm or len(norm) <= 30:
            continue
        if SKIP.match(line.strip()):
            continue
        lines2.append(norm)
    return lines2


def overlap(repo: str, ref: str) -> tuple[int, int, float, list[str]]:
    a = code_lines(repo)
    b = set(code_lines(ref))
    hits = [ln for ln in a if ln in b]
    frac = len(hits) / max(1, len(a))
    return len(hits), len(a), frac, hits


def main():
    args = sys.argv[1:]
    pairs = (
        list(zip(args[::2], args[1::2])) if args else DEFAULT_PAIRS
    )
    worst = 0.0
    for repo, ref in pairs:
        n_hit, n_all, frac, hits = overlap(repo, ref)
        worst = max(worst, frac)
        status = "OK " if frac < 0.15 else "FAIL"
        print(f"{status} {frac:6.1%} ({n_hit}/{n_all}) {repo}")
        if frac >= 0.15:
            for h in hits[:15]:
                print(f"      | {h}")
    sys.exit(0 if worst < 0.15 else 1)


if __name__ == "__main__":
    main()
