"""Containers — ``Container``, ``Sequential``, ``Concat``,
``ConcatTable``, ``ParallelTable``, ``MapTable``, ``Bottle`` and
``Remat`` (``bigdl_tpu/nn/containers.py:21``, ``:61``, ``:82``, ``:108``,
``:127``, ``:146``, ``:171``, ``:195``).

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

import contextlib
from typing import List

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.nn.module import AbstractModule, current_rng, use_rng


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


class ParallelTable(Container):
    """Child i on element i of the input table; the output is the list
    of their outputs (reference ``nn/ParallelTable.scala``)."""

    def forward(self, xs):
        return [m(x) for m, x in zip(self._modules.values(), xs)]


class MapTable(Container):
    """One child applied to every element of the input table, its
    parameters shared by every application (reference
    ``nn/MapTable.scala``)."""

    def __init__(self, module: AbstractModule = None) -> None:
        super().__init__()
        if module is not None:
            self.add(module)

    def forward(self, xs):
        return [self[0](x) for x in xs]


class Bottle(Container):
    """The child on the input with its leading dims folded into one batch
    dim, the output's leading dims restored (reference
    ``nn/Bottle.scala``): the last ``n_input_dim - 1`` dims are the
    child's per-row input."""

    def __init__(self, module: AbstractModule, n_input_dim: int = 2,
                 n_output_dim: int = 2) -> None:
        super().__init__()
        self.add(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def forward(self, x):
        split = x.dim() - self.n_input_dim + 1
        lead, rest = tuple(x.shape[:split]), tuple(x.shape[split:])
        out = self[0](x.reshape((-1,) + rest))
        return out.reshape(lead + tuple(out.shape[1:]))


class Remat(Container):
    """Gradient checkpointing (``containers.py:195``): the child's
    activations are not kept for the backward pass but recomputed, through
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``. The child
    sits under JAX's child key, so a JAX params tree loads unchanged.

    The child runs through ``functional_call`` on the tensors its
    parameters and buffers hold when the forward runs, and the recompute
    is handed the same tensors, so it differentiates the weights a train
    step's own ``functional_call`` swapped in. A generator made current by
    :func:`~bigdl_tpu_torch.nn.module.use_rng` is current in the recompute
    too, rewound to its state at the forward, so a dropout mask is drawn
    again bit for bit. A child's running statistics (BatchNorm) would be
    updated again by the recompute; the transformer blocks have none."""

    def __init__(self, module: AbstractModule) -> None:
        super().__init__()
        self.add(module)

    def forward(self, x):
        child = self[0]
        named = list(child.named_parameters()) + list(child.named_buffers())
        names = [n for n, _ in named]
        gen = current_rng()
        gen_state = None if gen is None else gen.get_state()
        calls = [0]

        def run(inp, *tensors):
            calls[0] += 1
            with contextlib.ExitStack() as stack:
                if gen is not None and calls[0] > 1:   # the recompute
                    now = gen.get_state()
                    gen.set_state(gen_state)
                    stack.callback(gen.set_state, now)
                stack.enter_context(use_rng(gen))
                return functional_call(child, dict(zip(names, tensors)),
                                       (inp,))

        return checkpoint(run, x, *[t for _, t in named],
                          use_reentrant=False)
