#!/usr/bin/env python3
"""The public names each JAX module has and its port lacks.

Parses both packages' sources (imports neither): for every module path
given (default: every ``.py`` both ``bigdl_tpu/`` and ``bigdl_tpu_torch/``
have) it lists

* the top-level classes, functions and assigned names without a leading
  underscore that ``bigdl_tpu/<path>`` defines and
  ``bigdl_tpu_torch/<path>`` does not (a module the port lacks is listed
  whole), and
* the public methods, properties and classmethods that a class of
  ``bigdl_tpu/<path>`` defines in its body and the same-named class of
  ``bigdl_tpu_torch/<path>`` lacks. A port class has a name when its body
  defines or assigns it, or a base class has it: a port base is parsed
  the same way, a base from outside the port (``nn.Module``,
  ``Exception``) is looked up with ``dir()`` (the tool imports torch for
  that, never either package).

A difference on purpose is in :data:`ON_PURPOSE`, with why; the tool
names only what is not there. One line per module, ``<path>: missing
[...] methods [...]``. Exits 1 when anything is named.

    python3 tools/torch_name_diff.py [nn/misc.py models/autoencoder.py ...]
"""

from __future__ import annotations

import ast
import builtins
import importlib
import os
import sys
from typing import Dict, Optional, Set, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "bigdl_tpu_torch"

#: ``"<path>::<Class>.<method>"`` (``"*::<method>"`` for every class,
#: ``"<path>::<name>"`` for a module-level name) the port leaves out on
#: purpose or queues for later, each with why.
ON_PURPOSE: Dict[str, str] = {
    "*::forward": "nn.Module's name: the JAX forward (which keeps "
                  "`output`) is update_output, forward computes only",
    "*::parameters": "nn.Module's name: it yields the nn.Parameters; the "
                     "JAX (weights, grads) pair is get_parameters()",
    "*::apply": "nn.Module's name (fn over submodules); the JAX pure "
                "apply(params, x) is torch.func.functional_call",
    "*::training": "nn.Module's bool attribute; the JAX training() method "
                   "is train()",
    "*::init_params": "the JAX pure init; a port layer makes its "
                      "parameters at construction (reset() redraws them)",
    "*::init_state": "the JAX state pytree is the module's buffers",
    "*::sub_modules": "nn.Module's children() / modules()",
    "*::to_ir": "lowers to a jaxpr; the port has no IR of its own",
    "nn/init_methods.py::*.init": "the port's init methods fill a tensor "
                                  "in place: fill(tensor, generator)",
    "serving/kv_pool.py::KVPool.used_per_shard": "A.2.g (sharded "
                                                 "serving), queued",
    "serving/metrics.py::ServingMetrics.set_mesh_shape": "A.2.g (sharded "
                                                         "serving), queued",
    "serving/metrics.py::ServingMetrics.on_shard_slots": "A.2.g (sharded "
                                                         "serving), queued",
    "serving/lora.py::AdapterSpec.scale": "alpha / rank; the port's "
                                          "AdapterBank takes no alpha "
                                          "(ROADMAP A, left out on purpose)",
    **{f"models/transformer.py::{n}": "A.2.g (sharded serving), queued"
       for n in ("adapter_bank_specs", "get_batch_decode_step",
                 "get_batch_prefill_step", "get_batch_verify_step",
                 "serving_carry_specs", "tp_param_specs")},
    "serving/sampling.py::knob_partition_specs": "A.2.g (sharded "
                                                 "serving), queued",
    "native/__init__.py::is_available": "A.7 group 7 (the native "
                                        "runtime's probes), queued",
    "native/__init__.py::unavailable_reason": "A.7 group 7, queued",
    "serving/faults.py::CLOCK_SITES": "A.9 (the analyzer's site "
                                      "tables), queued",
    "serving/fences.py::DELAYED_CONSUMER_SITES": "A.9, queued",
    "serving/fences.py::WINDOW_KNOBS": "A.9, queued",
}


def _module_file(dotted: str) -> Optional[str]:
    rel = dotted.replace(".", os.sep)
    for cand in (rel + ".py", os.path.join(rel, "__init__.py")):
        path = os.path.join(ROOT, cand)
        if os.path.exists(path):
            return path
    return None


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


def _body_names(cls: ast.ClassDef, with_assigns: bool) -> Set[str]:
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif with_assigns and isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif with_assigns and isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            out.add(node.target.id)
    return out


def jax_class_methods(path: str) -> Dict[str, Set[str]]:
    """``{class: public names its body defines}`` of the module."""
    if not os.path.exists(path):
        return {}
    return {node.name: {n for n in _body_names(node, False)
                        if not n.startswith("_")}
            for node in ast.parse(open(path).read()).body
            if isinstance(node, ast.ClassDef)}


class _PortIndex:
    """Parsed port modules: each class's own names, its bases, and the
    module's imports, resolved on demand."""

    def __init__(self) -> None:
        self._mods: Dict[str, Tuple[Dict, Dict]] = {}
        self._names: Dict[Tuple[str, str], Set[str]] = {}

    def _module(self, dotted: str):
        if dotted not in self._mods:
            path = _module_file(dotted)
            classes, imports = {}, {}
            if path is not None:
                tree = ast.parse(open(path).read())
                for node in ast.walk(tree):
                    if isinstance(node, ast.ImportFrom) and node.module:
                        for a in node.names:
                            imports[a.asname or a.name] = (node.module,
                                                           a.name)
                    elif isinstance(node, ast.Import):
                        for a in node.names:
                            imports[a.asname or a.name.split(".")[0]] = (
                                a.name if a.asname else a.name.split(".")[0],
                                None)
                for node in tree.body:
                    if isinstance(node, ast.ClassDef):
                        classes[node.name] = node
            self._mods[dotted] = (classes, imports)
        return self._mods[dotted]

    def class_names(self, dotted: str, cls: str) -> Optional[Set[str]]:
        """Every name the port class has (own, then bases'), or ``None``
        when the module has no such class."""
        key = (dotted, cls)
        if key in self._names:
            return self._names[key]
        classes, imports = self._module(dotted)
        node = classes.get(cls)
        if node is None:
            return None
        self._names[key] = names = set(_body_names(node, True))
        for base in node.bases:
            names |= self._base_names(dotted, base, classes, imports)
        return names

    def _base_names(self, dotted, base, classes, imports) -> Set[str]:
        parts = []
        while isinstance(base, ast.Attribute):
            parts.insert(0, base.attr)
            base = base.value
        if not isinstance(base, ast.Name):
            return set()
        head = base.id
        if not parts and head in classes:
            return self.class_names(dotted, head) or set()
        if head in imports:
            mod, name = imports[head]
            target = mod.split(".") + ([] if name is None else [name]) + parts
        else:
            target = [head] + parts
        if target[0] == PORT:
            return self.class_names(".".join(target[:-1]),
                                    target[-1]) or set()
        return _foreign_names(target)


def _foreign_names(target) -> Set[str]:
    """``dir()`` of a base class from outside the port."""
    if len(target) == 1:
        obj = getattr(builtins, target[0], None)
        return set(dir(obj)) if obj is not None else set()
    for cut in range(len(target) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(target[:cut]))
        except ImportError:
            continue
        try:
            for attr in target[cut:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return set()
        return set(dir(obj))
    return set()


def _on_purpose(rel: str, cls: str, meth: str) -> bool:
    return any(k in ON_PURPOSE for k in (
        f"*::{meth}", f"{rel}::{cls}.{meth}", f"{rel}::*.{meth}"))


def missing_methods(rel: str, index: _PortIndex):
    want = jax_class_methods(os.path.join(ROOT, "bigdl_tpu", rel))
    dotted = PORT + "." + rel[:-3].replace(os.sep, ".")
    out = []
    for cls, meths in sorted(want.items()):
        have = index.class_names(dotted, cls)
        if have is None:      # the class itself is in the names diff
            continue
        out += [f"{cls}.{m}" for m in sorted(meths - have)
                if not _on_purpose(rel, cls, m)]
    return out


def common_modules():
    jax_root = os.path.join(ROOT, "bigdl_tpu")
    out = []
    for d, _, files in os.walk(jax_root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), jax_root)
            if f.endswith(".py") and os.path.exists(
                    os.path.join(ROOT, PORT, rel)):
                out.append(rel)
    return sorted(out)


def main(argv) -> int:
    index = _PortIndex()
    missing_any = False
    for rel in argv or common_modules():
        want = public_names(os.path.join(ROOT, "bigdl_tpu", rel)) or set()
        have = public_names(os.path.join(ROOT, PORT, rel))
        missing = sorted(n for n in (want if have is None else want - have)
                         if f"{rel}::{n}" not in ON_PURPOSE)
        methods = [] if have is None else missing_methods(rel, index)
        missing_any = missing_any or bool(missing) or bool(methods)
        print(f"{rel}: {'(no port module) ' if have is None else ''}"
              f"missing {missing} methods {methods}")
    return 1 if missing_any else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
