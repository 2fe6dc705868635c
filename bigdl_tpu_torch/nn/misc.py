"""LookupTable — embedding lookup (``bigdl_tpu/nn/misc.py:49``).

Indices are 1-based like the reference; ids below 1 (the text
pipeline's padding id 0) embed to the zero vector, and ids past the
table clamp to its last row, as the JAX gather does.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import AbstractModule, new_param


class LookupTable(AbstractModule):
    def __init__(self, n_index: int, n_output: int, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        # the reference's default RandomNormal(0, 1)
        self.weight = new_param((n_index, n_output), device,
                                lambda t: t.normal_(generator=generator))

    def forward(self, ids):
        idx = ids.long() - 1
        out = self.weight[idx.clamp(0, self.n_index - 1)]
        return torch.where((idx < 0)[..., None], 0.0, out)
