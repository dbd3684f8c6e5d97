"""Static documentation site builder.

The reference ships an mkdocs site with strict CI
(`/root/reference/mkdocs.yml`); this container has no mkdocs (zero
egress), so this builder renders the same documentation surface —
README, docs/API.md, docs/library/*.md, and the 29 executable cookbook
chapters — into a self-contained static HTML site with a navigation
sidebar, using the in-image `markdown` + `pygments` packages.

Usage:
    python tools/build_docs.py [--out docs/site]

Cookbook chapters are rendered literately: the module docstring becomes
the page intro, and the source (which CI executes via
tests/core/test_cookbook.py) is syntax-highlighted below it.
tests/test_docs_build.py builds the site in CI and asserts every page
exists and every nav link resolves.
"""

import argparse
import pathlib
import re
import shutil

import markdown
from pygments import highlight
from pygments.formatters import HtmlFormatter
from pygments.lexers import PythonLexer

ROOT = pathlib.Path(__file__).resolve().parents[1]

MD_EXTENSIONS = ["tables", "fenced_code", "toc"]

PAGE_TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — genjax_tpu</title>
<style>
:root {{ --fg: #1a1c1f; --bg: #ffffff; --accent: #0b5fff; --muted: #5b6572;
         --side: #f6f7f9; --border: #e3e6ea; }}
* {{ box-sizing: border-box; }}
body {{ margin: 0; font: 16px/1.6 system-ui, -apple-system, "Segoe UI",
       sans-serif; color: var(--fg); background: var(--bg); display: flex; }}
nav {{ width: 270px; min-height: 100vh; background: var(--side);
      border-right: 1px solid var(--border); padding: 1.2rem 1rem;
      flex-shrink: 0; position: sticky; top: 0; height: 100vh;
      overflow-y: auto; }}
nav h1 {{ font-size: 1.05rem; margin: 0 0 1rem; }}
nav h2 {{ font-size: .75rem; text-transform: uppercase; letter-spacing: .06em;
         color: var(--muted); margin: 1.1rem 0 .3rem; }}
nav a {{ display: block; color: var(--fg); text-decoration: none;
        font-size: .88rem; padding: .12rem .4rem; border-radius: 5px; }}
nav a:hover {{ background: #eceef2; }}
nav a.active {{ color: var(--accent); font-weight: 600; }}
main {{ padding: 2rem 3rem; max-width: 60rem; min-width: 0; }}
main h1, main h2, main h3 {{ line-height: 1.25; }}
main a {{ color: var(--accent); }}
pre {{ background: #f6f8fa; border: 1px solid var(--border);
      border-radius: 8px; padding: .8rem 1rem; overflow-x: auto;
      font-size: .85rem; }}
code {{ font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
       font-size: .9em; }}
:not(pre) > code {{ background: #f1f3f5; border-radius: 4px;
                   padding: .08em .3em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid var(--border); padding: .3rem .6rem; }}
{pygments_css}
</style>
</head>
<body>
<nav>
<h1><a href="{root}index.html" style="padding:0">genjax_tpu</a></h1>
{nav}
</nav>
<main>
{body}
</main>
</body>
</html>
"""


def _md(text: str) -> str:
    return markdown.markdown(text, extensions=MD_EXTENSIONS)


def _literate_py(path: pathlib.Path) -> str:
    """Render a cookbook chapter: docstring intro + highlighted source."""
    src = path.read_text()
    m = re.match(r'\s*(?:r?)"""(.*?)"""\s*\n', src, re.S)
    intro, rest = ("", src)
    if m:
        intro, rest = m.group(1), src[m.end():]
    parts = [_md(intro)]
    parts.append(
        "<p><em>Executable chapter — run "
        f"<code>python docs/cookbook/{path.name}</code> "
        "(CI runs it via <code>tests/core/test_cookbook.py</code>).</em></p>"
    )
    parts.append(highlight(rest, PythonLexer(), HtmlFormatter()))
    return "\n".join(parts)


def collect_pages():
    """Return [(out_rel_path, title, section, html_body)]."""
    pages = []
    pages.append(
        ("index.html", "Overview", "Start", _md((ROOT / "README.md").read_text()))
    )
    for name, title in (
        ("ARCHITECTURE.md", "Architecture"),
        ("PERF.md", "Performance"),
        ("PARITY.md", "Reference parity"),
        ("MIGRATION.md", "Migrating from genjax"),
    ):
        p = ROOT / name
        if p.exists():
            pages.append(
                (name.lower().replace(".md", ".html"), title, "Start",
                 _md(p.read_text()))
            )
    pages.append(
        ("api.html", "API index", "Reference", _md((ROOT / "docs/API.md").read_text()))
    )
    for p in sorted((ROOT / "docs/library").glob("*.md")):
        pages.append(
            (f"library_{p.stem}.html", p.stem.replace("_", " ").title(),
             "Reference", _md(p.read_text()))
        )
    cb = ROOT / "docs/cookbook"
    pages.append(
        ("cookbook.html", "Cookbook index", "Cookbook",
         _md((cb / "README.md").read_text()))
    )
    for p in sorted(cb.glob("*.py")):
        title = p.stem.split("_", 1)[-1].replace("_", " ")
        pages.append(
            (f"cookbook_{p.stem}.html", f"{p.stem[:2]} {title}", "Cookbook",
             _literate_py(p))
        )
    return pages


def build(out_dir: pathlib.Path) -> list[pathlib.Path]:
    pages = collect_pages()
    out_dir.mkdir(parents=True, exist_ok=True)
    pygments_css = HtmlFormatter().get_style_defs(".highlight")

    written = []
    for rel, title, section, body in pages:
        nav_parts = []
        current = None
        for r2, t2, s2, _ in pages:
            if s2 != current:
                nav_parts.append(f"<h2>{s2}</h2>")
                current = s2
            cls = ' class="active"' if r2 == rel else ""
            nav_parts.append(f'<a href="{r2}"{cls}>{t2}</a>')
        html = PAGE_TEMPLATE.format(
            title=title,
            nav="\n".join(nav_parts),
            body=body,
            root="",
            pygments_css=pygments_css,
        )
        path = out_dir / rel
        path.write_text(html)
        written.append(path)
    return written


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "docs" / "site"))
    ap.add_argument("--clean", action="store_true")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    if args.clean and out.exists():
        shutil.rmtree(out)
    written = build(out)
    print(f"built {len(written)} pages -> {out}")


if __name__ == "__main__":
    main()
