"""AbstractModule — the port's layer base (``bigdl_tpu/nn/module.py:61``).

The JAX package keeps every layer as a pure ``init_params``/``apply``
pair over a params pytree. The port keeps PyTorch's idiom instead: a
layer is an ``nn.Module`` whose learnable tensors are ``nn.Parameter``s,
created at construction on an explicit device from an explicit
``torch.Generator``. What carries over from the JAX base is what the
serving slice needs: a per-instance ``name`` (class name + a process
counter, the key suffix containers use), the evaluate/training mode, and
``module.inputs(...)`` (``bigdl_tpu/nn/graph.py:38-43``), which attaches
the module to a :class:`~bigdl_tpu_torch.nn.graph.Graph` DAG node.
The ``forward``/``backward`` facade and the loaders come with later
slices.
"""

from __future__ import annotations

import itertools

import torch
from torch import nn

_instance_counter = itertools.count()


class AbstractModule(nn.Module):
    """Base class for every layer and container of the port."""

    def __init__(self) -> None:
        super().__init__()
        self.name: str = f"{type(self).__name__}{next(_instance_counter)}"

    def evaluate(self) -> "AbstractModule":
        """Switch to eval mode (the reference's ``evaluate()``)."""
        self.eval()
        return self

    def inputs(self, *nodes):
        """Attach this module to the graph after ``nodes`` and return its
        :class:`~bigdl_tpu_torch.nn.graph.ModuleNode`."""
        from bigdl_tpu_torch.nn.graph import ModuleNode

        return ModuleNode(self, nodes)


class TensorModule(AbstractModule):
    """Marker base for modules whose input and output are one tensor."""


class Identity(TensorModule):
    def forward(self, x):
        return x


def new_param(shape, device, init) -> nn.Parameter:
    """An f32 parameter of ``shape`` on ``device``, filled in place by
    ``init(tensor)`` under ``torch.no_grad()``."""
    p = torch.empty(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        init(p)
    return nn.Parameter(p)
