"""Containers — ``Container`` and ``Sequential``
(``bigdl_tpu/nn/containers.py:21`` and ``:61``).

Children are registered under ``f"{i}:{child.name}"`` exactly as the
JAX container keys its params tree (``containers.py:33``), so the two
trees line up index by index (:func:`bigdl_tpu_torch.models.transformer.
load_jax_params` matches children by the integer before the ``:``; the
names after it carry per-process instance counters and differ between
builds).
"""

from __future__ import annotations

from typing import List

from bigdl_tpu_torch.nn.module import AbstractModule


class Container(AbstractModule):
    def add(self, module: AbstractModule) -> "Container":
        self.add_module(f"{len(self._modules)}:{module.name}", module)
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
