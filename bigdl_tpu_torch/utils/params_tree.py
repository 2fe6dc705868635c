"""JAX-layout params trees ↔ the port's parameter names.

The JAX package keys a container's params by ``"{i}:{child name}"`` and a
layer's by leaf name (``weight``, ``bias``, ...). The port's modules carry
the same structure, but the names after the ``:`` hold per-process
instance counters and differ between two builds of one model, so children
are matched by the integer before the ``:``. :func:`named_leaves` maps a
tree of that shape (numpy leaves, e.g. ``jax.device_get(lm.params)`` or
one slot tree of an Adam state) onto ``model.named_parameters()`` names,
or, with ``kind="buffers"``, a state tree (``g.state``: BatchNorm running
statistics) onto ``model.named_buffers()``. A ``Graph`` is a container
(children by index); a ``FusedGraph`` shares its wrapped graph's tree, as
in JAX. :func:`load_jax_tree` copies both trees into a model.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.containers import Container


def named_leaves(model: nn.Module, tree: Dict,
                 kind: str = "parameters") -> Dict[str, np.ndarray]:
    """``{parameter (or buffer) name: array}`` for every leaf of ``tree``.
    Every leaf must exist on both sides with equal shape."""
    from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph

    if kind not in ("parameters", "buffers"):
        raise ValueError(f"kind must be 'parameters' or 'buffers', not {kind!r}")
    out: Dict[str, np.ndarray] = {}

    def walk(m: nn.Module, t: Dict, prefix: str) -> None:
        if isinstance(m, FusedGraph):
            walk(m.graph, t, f"{prefix}graph.")
            return
        own = dict(m.named_parameters(recurse=False) if kind == "parameters"
                   else m.named_buffers(recurse=False))
        children = dict(m.named_children())
        if isinstance(m, Container):
            by_index = {int(k.split(":", 1)[0]): v for k, v in t.items()}
            keys = list(children)
            if set(by_index) != set(range(len(keys))):
                raise ValueError(
                    f"{prefix or 'model'}: JAX children {sorted(by_index)} "
                    f"do not match the port's {len(keys)}")
            for i, key in enumerate(keys):
                walk(children[key], by_index[i], f"{prefix}{key}.")
            return
        if set(t) != set(own) | set(children):
            raise ValueError(
                f"{prefix or 'model'}: JAX keys {sorted(t)} do not match the "
                f"port's {sorted(set(own) | set(children))}")
        for key, val in t.items():
            if key in children:
                walk(children[key], val, f"{prefix}{key}.")
                continue
            arr = np.asarray(val)
            if tuple(arr.shape) != tuple(own[key].shape):
                raise ValueError(f"{prefix}{key}: shape {arr.shape} vs "
                                 f"{tuple(own[key].shape)}")
            out[prefix + key] = arr

    walk(model, tree, "")
    return out


def load_jax_tree(model: nn.Module, params: Dict,
                  state: Optional[Dict] = None) -> nn.Module:
    """Copy a JAX model's params tree (``jax.device_get(g.params)``) into
    ``model``'s parameters and, when given, its state tree (``g.state``,
    BatchNorm running statistics) into its buffers, matching children by
    index; works for a ``Graph`` and a ``FusedGraph`` alike."""
    with torch.no_grad():
        for kind, tree, named in (
                ("parameters", params, dict(model.named_parameters())),
                ("buffers", state, dict(model.named_buffers()))):
            if tree is None:
                continue
            for name, arr in named_leaves(model, tree, kind).items():
                t = named[name]
                t.copy_(torch.from_numpy(np.array(arr)).to(t.dtype))
    return model
