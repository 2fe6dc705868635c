"""MultiHeadAttention (``bigdl_tpu/nn/attention.py:25``).

The ``wq``/``wk``/``wv``/``wo`` projections (each a ``(H, H)`` weight
with Xavier init and a zero bias, the JAX params layout) and the local
forward over ``(batch, time, hidden)``, dense or through
:func:`bigdl_tpu_torch.ops.flash_attention.flash_attention`.

``use_flash`` is the JAX policy with the card in place of the TPU:
``"auto"`` sends a CUDA input to the flash kernels and a CPU input to the
dense path, ``"always"`` calls ``flash_attention`` on every input (its
plain version on the CPU), ``"never"`` takes the dense path.

``sequence_parallel`` picks the distributed attention of
:mod:`bigdl_tpu_torch.parallel.ring_attention` over the mesh axis
``sp_axis`` (the input is this rank's sequence shard): ``"ring"`` (flash
blocks when the policy above allows them, else the einsum ring),
``"striped_ring"`` (causal only, flash only; the input must be in stripe
layout) or ``"ulysses"``. ``flash_block`` is the TPU kernel's VMEM tile
length: it is validated (a positive multiple of 128) and stored, and
chooses nothing on the card, whose kernels pick their own tiles (as the
kernel wrappers' ``block``).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.init_methods import RandomUniform, Zeros
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import AbstractModule
from bigdl_tpu_torch.ops.flash_attention import flash_attention


class MultiHeadAttention(AbstractModule):
    def __init__(self, hidden_size: int, n_heads: int, causal: bool = False,
                 sequence_parallel: Optional[str] = None,
                 sp_axis: str = "seq", use_flash: str = "auto",
                 flash_block: Optional[int] = None, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        if hidden_size % n_heads:
            raise ValueError(f"hidden {hidden_size} % heads {n_heads} != 0")
        if sequence_parallel not in (None, "ring", "striped_ring", "ulysses"):
            raise ValueError(f"unknown sequence_parallel {sequence_parallel!r}")
        if sequence_parallel == "striped_ring" and not causal:
            raise ValueError("striped_ring is a causal-only schedule — "
                             "use 'ring' for bidirectional attention")
        if sequence_parallel == "striped_ring" and use_flash == "never":
            raise ValueError("striped_ring has no non-flash path — it IS "
                             "a flash-kernel schedule; use 'ring' with "
                             "use_flash='never'")
        if use_flash not in ("auto", "always", "never"):
            raise ValueError(f"unknown use_flash {use_flash!r}")
        if flash_block is not None and (flash_block % 128 or flash_block <= 0):
            raise ValueError(
                f"flash_block must be a positive multiple of 128, "
                f"got {flash_block}")
        self.sequence_parallel = sequence_parallel
        self.sp_axis = sp_axis
        self.flash_block = flash_block
        self.use_flash = use_flash
        self.hidden_size = hidden_size
        self.n_heads = n_heads
        self.head_dim = hidden_size // n_heads
        self.causal = causal
        bound = (6.0 / (2 * hidden_size)) ** 0.5     # Xavier (Glorot) uniform
        for name in ("wq", "wk", "wv", "wo"):
            self.add_module(name, Linear(
                hidden_size, hidden_size, device=device, generator=generator,
                init_weight=RandomUniform(-bound, bound), init_bias=Zeros()))

    def forward(self, x):
        B, T, _ = x.shape

        def split(t):  # (B, T, H*D) -> (B, T, H, D)
            return t.reshape(B, T, self.n_heads, self.head_dim)

        q, k, v = split(self.wq(x)), split(self.wk(x)), split(self.wv(x))
        flash_ok = self.use_flash == "always" or (
            self.use_flash == "auto" and x.device.type == "cuda")
        if self.sequence_parallel is not None:
            from bigdl_tpu_torch.parallel.ring_attention import (
                ring_attention, striped_ring_attention, ulysses_attention,
            )

            if self.sequence_parallel == "ring":
                out = ring_attention(q, k, v, self.sp_axis,
                                     causal=self.causal, use_flash=flash_ok)
            elif self.sequence_parallel == "striped_ring":
                out = striped_ring_attention(q, k, v, self.sp_axis)
            else:
                out = ulysses_attention(q, k, v, self.sp_axis,
                                        causal=self.causal,
                                        use_flash=flash_ok)
            return self.wo(out.reshape(B, T, -1))
        if flash_ok:
            out = flash_attention(q, k, v, causal=self.causal,
                                  block=self.flash_block)
            return self.wo(out.reshape(B, T, -1))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.head_dim ** -0.5
        if self.causal:
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            s = torch.where(mask, s, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, -1)
        return self.wo(out)
