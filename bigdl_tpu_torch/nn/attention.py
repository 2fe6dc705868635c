"""MultiHeadAttention (``bigdl_tpu/nn/attention.py:25``).

The ``wq``/``wk``/``wv``/``wo`` projections (each a ``(H, H)`` weight
with Xavier init and a zero bias, the JAX params layout) and the local
forward over ``(batch, time, hidden)``, dense or through
:func:`bigdl_tpu_torch.ops.flash_attention.flash_attention`.

``use_flash`` is the JAX policy with the card in place of the TPU:
``"auto"`` sends a CUDA input to the flash kernels and a CPU input to the
dense path, ``"always"`` calls ``flash_attention`` on every input (its
plain version on the CPU), ``"never"`` takes the dense path. The
sequence-parallel modes come with a later slice.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import AbstractModule
from bigdl_tpu_torch.ops.flash_attention import flash_attention


class MultiHeadAttention(AbstractModule):
    def __init__(self, hidden_size: int, n_heads: int, causal: bool = False,
                 use_flash: str = "auto", device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"hidden {hidden_size} % heads {n_heads} != 0")
        if use_flash not in ("auto", "always", "never"):
            raise ValueError(f"unknown use_flash {use_flash!r}")
        self.use_flash = use_flash
        self.hidden_size = hidden_size
        self.n_heads = n_heads
        self.head_dim = hidden_size // n_heads
        self.causal = causal
        bound = (6.0 / (2 * hidden_size)) ** 0.5     # Xavier (Glorot) uniform

        def xavier(t):
            t.uniform_(-bound, bound, generator=generator)

        for name in ("wq", "wk", "wv", "wo"):
            self.add_module(name, Linear(hidden_size, hidden_size,
                                         device=device, weight_init=xavier,
                                         bias_init=torch.nn.init.zeros_))

    def forward(self, x):
        B, T, _ = x.shape

        def split(t):  # (B, T, H*D) -> (B, T, H, D)
            return t.reshape(B, T, self.n_heads, self.head_dim)

        q, k, v = split(self.wq(x)), split(self.wk(x)), split(self.wv(x))
        if self.use_flash == "always" or (self.use_flash == "auto"
                                          and x.device.type == "cuda"):
            out = flash_attention(q, k, v, causal=self.causal)
            return self.wo(out.reshape(B, T, -1))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.head_dim ** -0.5
        if self.causal:
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            s = torch.where(mask, s, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, -1)
        return self.wo(out)
