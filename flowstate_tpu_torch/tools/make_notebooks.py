"""Write the notebook form of each demo of ``flowstate_tpu_torch/demos``.

Port of ``tools/make_notebooks.py``, into
``flowstate_tpu_torch/demos/notebooks/``.  A notebook holds three cells:

  1 (markdown)  the demo's docstring under its name,
  2 (code)      the module's imports and set-up,
  3 (code)      the body of ``main()`` dedented, its keyword defaults
                bound first and a trailing ``return x`` shown as ``x``,

so that it runs cell by cell without a ``__main__`` guard.  The files
are nbformat-4 JSON written without nbformat; writing them again gives
the same bytes, and a test holds the committed notebooks to the demos.

    python -m flowstate_tpu_torch.tools.make_notebooks
"""

from __future__ import annotations

import ast
import json
import os
import textwrap

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_DIR = os.path.join(PACKAGE, "demos")
OUT_DIR = os.path.join(DEMO_DIR, "notebooks")


def demo_scripts() -> list:
    return sorted(f for f in os.listdir(DEMO_DIR)
                  if f.endswith(".py") and f != "__init__.py")


def _cells_from_script(path: str):
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    tree = ast.parse(src)
    docstring = ast.get_docstring(tree) or os.path.basename(path)
    main_def = None
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "main":
            main_def = node
    if main_def is None:
        raise ValueError(f"{path}: no main() found")

    # set-up: everything between the docstring and main()
    first = tree.body[0]
    setup_start = first.end_lineno if isinstance(
        first, ast.Expr) and isinstance(first.value, ast.Constant) else 0
    setup = "\n".join(lines[setup_start:main_def.lineno - 1]).strip("\n")

    body_nodes = list(main_def.body)
    tail_expr = None
    if isinstance(body_nodes[-1], ast.Return):
        ret = body_nodes.pop()
        if ret.value is not None:
            tail_expr = ast.unparse(ret.value)
    body = textwrap.dedent("\n".join(
        lines[body_nodes[0].lineno - 1:body_nodes[-1].end_lineno]))
    if tail_expr:
        body += f"\n\n{tail_expr}"
    args = main_def.args
    defaults = [f"{arg.arg} = {ast.unparse(default)}" for arg, default in
                zip(args.args[len(args.args) - len(args.defaults):],
                    args.defaults)]
    if defaults:
        body = "\n".join(defaults) + "\n\n" + body
    return docstring, setup, body


def _code_cell(source: str) -> dict:
    return {"cell_type": "code", "execution_count": None, "metadata": {},
            "outputs": [], "source": source.splitlines(keepends=True)}


def make_notebook(script: str) -> dict:
    docstring, setup, body = _cells_from_script(script)
    name = os.path.splitext(os.path.basename(script))[0]
    title = f"# {name.replace('_', ' ')}\n\n{docstring}"
    cells = [{"cell_type": "markdown", "metadata": {},
              "source": title.splitlines(keepends=True)}]
    if setup:
        cells.append(_code_cell(setup))
    cells.append(_code_cell(body))
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def notebook_path(script_name: str) -> str:
    return os.path.join(OUT_DIR, script_name.replace(".py", ".ipynb"))


def main() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    for fname in demo_scripts():
        nb = make_notebook(os.path.join(DEMO_DIR, fname))
        with open(notebook_path(fname), "w") as f:
            json.dump(nb, f, indent=1, sort_keys=True)
            f.write("\n")
        print("wrote", os.path.relpath(notebook_path(fname),
                                       os.path.dirname(PACKAGE)))


if __name__ == "__main__":
    main()
