#!/usr/bin/env python3
"""The public names each JAX module has and its port lacks.

Parses both packages' sources (imports neither): for every module path
given (default: every ``.py`` both ``bigdl_tpu/`` and ``bigdl_tpu_torch/``
have) it lists the top-level classes, functions and assigned names
without a leading underscore that ``bigdl_tpu/<path>`` defines and
``bigdl_tpu_torch/<path>`` does not; a module the port lacks is listed
whole. Exits 1 when any name is missing.

    python3 tools/torch_name_diff.py [nn/misc.py models/autoencoder.py ...]
"""

from __future__ import annotations

import ast
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def public_names(path: str):
    """Top-level public names of the module at ``path``, or ``None`` when
    there is no such file."""
    if not os.path.exists(path):
        return None
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def common_modules():
    jax_root = os.path.join(ROOT, "bigdl_tpu")
    out = []
    for d, _, files in os.walk(jax_root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), jax_root)
            if f.endswith(".py") and os.path.exists(
                    os.path.join(ROOT, "bigdl_tpu_torch", rel)):
                out.append(rel)
    return sorted(out)


def main(argv) -> int:
    missing_any = False
    for rel in argv or common_modules():
        want = public_names(os.path.join(ROOT, "bigdl_tpu", rel)) or set()
        have = public_names(os.path.join(ROOT, "bigdl_tpu_torch", rel))
        missing = sorted(want if have is None else want - have)
        missing_any = missing_any or bool(missing)
        print(f"{rel}: {'(no port module) ' if have is None else ''}"
              f"missing {missing}")
    return 1 if missing_any else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
