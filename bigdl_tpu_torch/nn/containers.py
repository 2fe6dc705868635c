"""Containers — ``Container``, ``Sequential``, ``Concat`` and
``ConcatTable`` (``bigdl_tpu/nn/containers.py:21``, ``:61``, ``:82``,
``:108``).

Children are registered under ``f"{i}:{child.name}"`` exactly as the
JAX container keys its params tree (``containers.py:33``), so the two
trees line up index by index (:func:`bigdl_tpu_torch.models.transformer.
load_jax_params` matches children by the integer before the ``:``; the
names after it carry per-process instance counters and differ between
builds). A child is keyed by the name it has when it is added, so
``set_name`` comes before ``add`` (``AbstractModule.set_name`` refuses a
later rename).
"""

from __future__ import annotations

from typing import List

import torch

from bigdl_tpu_torch.nn.module import AbstractModule


class Container(AbstractModule):
    def add(self, module: AbstractModule) -> "Container":
        key = f"{len(self._modules)}:{module.name}"
        self.add_module(key, module)
        module._container_key = key
        return self

    def layers(self) -> List[AbstractModule]:
        """The children in insertion order (the JAX ``modules`` list)."""
        return list(self._modules.values())

    def _child_key(self, i: int) -> str:
        return list(self._modules)[i]

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, i: int) -> AbstractModule:
        return self.layers()[i]


class Sequential(Container):
    """Feed-forward chain (reference ``nn/Sequential.scala``)."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class Concat(Container):
    """Every child on the same input, the outputs concatenated along
    ``dimension`` (1-based; ``Concat(2)`` is the channel axis of NCHW),
    Inception's block (reference ``nn/Concat.scala``)."""

    def __init__(self, dimension: int) -> None:
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()],
                         dim=self.dimension - 1)


class ConcatTable(Container):
    """Every child on the same input; the output is the list of their
    outputs (reference ``nn/ConcatTable.scala``)."""

    def forward(self, x):
        return [m(x) for m in self._modules.values()]
