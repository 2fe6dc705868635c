"""Recurrent layers (``bigdl_tpu/nn/recurrent.py``): ``Cell`` (``:29``),
``_FusedInputCell`` (``:114``), ``LSTM`` (``:165``), ``Recurrent``
(``:419``) and ``BiRecurrent`` (``:501``).

Activity is ``(batch, time, feature)``. The JAX ``Recurrent`` is one
``lax.scan``; here it is a loop over time in Python. As in JAX, the
input leg of every gate runs once over the whole sequence before the
loop (``precompute_input``: one ``(B·T, I) × (I, 4H)`` product), so each
time step launches only the hidden-to-hidden product (``addmm``, which
adds it to the step's precomputed slice) and the gate's elementwise ops.
A reversed ``Recurrent`` runs from the last step to the first and stores
each output at its original time index (``:493-496``), so its
whole-sequence state sits at ``t = 0``.

``LSTM(p=)`` is variational dropout (``:455-481``): in training mode,
with a generator current (:func:`bigdl_tpu_torch.nn.module.use_rng`),
``Recurrent`` draws one mask per sequence for the input and one for the
hidden state, shared by every time step.

Parameters are JAX's leaves (``w_ih`` ``(4H, I)``, ``w_hh`` ``(4H, H)``,
``b_ih``, ``b_hh``; gate order i, f, g, o; ``RandomUniform`` weights and
zero biases) and containers key their children ``"{i}:{name}"``, so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries a JAX
tree across. The carry starts as f32 zeros, as JAX's, and a product of
two dtypes runs in the wider one, as ``jnp.matmul`` promotes.

Not ported yet (``ROADMAP.md`` A.7): ``RnnCell``, ``GRU``,
``LSTMPeephole``, ``ConvLSTMPeephole``, ``RecurrentDecoder``,
``TimeDistributed`` and ``MultiRNNCell``.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch

from bigdl_tpu_torch.nn.containers import Container
from bigdl_tpu_torch.nn.init_methods import RandomUniform, Zeros
from bigdl_tpu_torch.nn.misc import keep_mask
from bigdl_tpu_torch.nn.module import AbstractModule, current_rng, new_param


class Cell(AbstractModule):
    """Base of the recurrent cells: ``step(x_t, carry) -> (out_t,
    carry)`` over the cell's own parameters. Through the facade a cell
    takes the table ``[x_t, *carry]`` and returns ``[out_t, *carry]``
    (the reference's ``T(input, hidden)``)."""

    # the leaves each regularizer of the train step applies to
    _reg_w_keys = ("w_ih",)
    _reg_u_keys = ("w_hh",)
    _reg_b_keys = ("b_ih", "b_hh")
    #: number of carry tensors (2 for the LSTM's (h, c))
    carry_len = 1

    def __init__(self, hidden_size: int) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.p = 0.0

    def init_carry(self, batch_size: int, device) -> tuple:
        return tuple(torch.zeros(batch_size, self.hidden_size,
                                 dtype=torch.float32, device=device)
                     for _ in range(self.carry_len))

    @property
    def input_dropout_p(self) -> float:
        """Dropout of the sequence input, applied by the driving
        ``Recurrent``."""
        return self.p

    def dropout_specs(self):
        """``[(p, width)]``: one per-sequence mask of the hidden state per
        entry, drawn by the driving ``Recurrent``."""
        return [(self.p, self.hidden_size)]

    def mask_carry(self, carry, h_masks):
        m = h_masks[0]
        if m is None:
            return carry
        return (carry[0] * m,) + tuple(carry[1:])

    def precompute_input(self, x):
        """The input leg over a whole ``(B, T, I)`` sequence (default:
        none)."""
        return x

    def step_pre(self, pre_t, carry):
        return self.step(pre_t, carry)

    def step(self, x_t, carry):
        raise NotImplementedError

    def forward(self, xs):
        x_t, carry = xs[0], tuple(xs[1:])
        if not carry:
            carry = self.init_carry(x_t.shape[0], x_t.device)
        out, new_carry = self.step(x_t, carry)
        return [out, *new_carry]


class _FusedInputCell(Cell):
    """A cell whose input leg is one gate projection ``x @ w_ih^T +
    b_ih``, hoisted over the sequence by ``Recurrent``."""

    def precompute_input(self, x):
        dt = torch.promote_types(x.dtype, self.w_ih.dtype)
        return torch.matmul(x.to(dt), self.w_ih.t().to(dt)) + self.b_ih

    def step(self, x_t, carry):
        return self.step_pre(self.precompute_input(x_t), carry)


class LSTM(_FusedInputCell):
    """LSTM cell (reference ``nn/LSTM.scala``), gates i, f, g, o in the
    fused weights; ``p`` is the variational dropout of the driving
    ``Recurrent``."""

    carry_len = 2  # (h, c)

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__(hidden_size)
        self.input_size = input_size
        self.p = p
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        self._generator = generator
        h4 = 4 * hidden_size
        self.w_ih = new_param((h4, input_size), device, lambda t: t)
        self.w_hh = new_param((h4, hidden_size), device, lambda t: t)
        self.b_ih = new_param((h4,), device, lambda t: t)
        self.b_hh = new_param((h4,), device, lambda t: t)
        self.reset_parameters()

    def reset_parameters(self) -> "LSTM":
        """Refill the weights (``RandomUniform``) and biases (zeros) from
        the cell's generator."""
        for w in (self.w_ih, self.w_hh):
            RandomUniform().fill(w.data, self._generator)
        for b in (self.b_ih, self.b_hh):
            Zeros().fill(b.data)
        return self

    def step_pre(self, pre_t, carry):
        h, c = carry
        dt = torch.promote_types(pre_t.dtype,
                                 torch.promote_types(h.dtype, self.w_hh.dtype))
        # pre_t + h @ w_hh^T in one launch, then + b_hh, JAX's order
        gates = torch.addmm(pre_t.to(dt), h.to(dt),
                            self.w_hh.t().to(dt)) + self.b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class Recurrent(Container):
    """Unrolls its one cell over the time axis of ``(B, T, F)`` input
    (reference ``nn/Recurrent.scala``); output ``(B, T, H)``. ``reverse``
    runs from the last step and keeps each output at its own index."""

    def __init__(self) -> None:
        super().__init__()
        self.reverse = False

    def add(self, cell: Cell) -> "Recurrent":
        if len(self):
            raise ValueError("a Recurrent holds one cell")
        return super().add(cell)

    @property
    def cell(self) -> Optional[Cell]:
        return self[0] if len(self) else None

    def forward(self, x):
        cell = self.cell
        batch, steps = x.shape[0], x.shape[1]
        h_masks = None
        gen = current_rng()
        p_in = cell.input_dropout_p
        specs = cell.dropout_specs()
        if self.training and gen is not None and (
                p_in > 0.0 or any(p_h > 0.0 for p_h, _ in specs)):
            if p_in > 0.0:
                keep = 1.0 - p_in
                x = x * (keep_mask((batch, 1) + tuple(x.shape[2:]), keep,
                                   x, gen) / keep)
            masks = [keep_mask((batch, width), 1.0 - p_h, x, gen)
                     / (1.0 - p_h) if p_h > 0.0 else None
                     for p_h, width in specs]
            if any(m is not None for m in masks):
                h_masks = masks
        pre = cell.precompute_input(x)                 # (B, T, ...)
        carry = cell.init_carry(batch, x.device)
        outs: List[Optional[torch.Tensor]] = [None] * steps
        order = range(steps - 1, -1, -1) if self.reverse else range(steps)
        for t in order:
            if h_masks is not None:
                carry = cell.mask_carry(carry, h_masks)
            outs[t], carry = cell.step_pre(pre[:, t], carry)
        return torch.stack(outs, dim=1)


class BiRecurrent(Container):
    """A forward and a time-reversed ``Recurrent`` over the same input,
    merged per step: ``merge="add"`` (default) sums them, ``"concat"``
    joins them on the feature axis (reference ``nn/BiRecurrent.scala``).
    ``add(cell)`` gives the reverse direction a deep copy named
    ``name + "_rev"`` with its own freshly drawn weights, as JAX inits
    the copy from its own key."""

    def __init__(self, merge: Optional[str] = None) -> None:
        super().__init__()
        self.merge_mode = merge or "add"
        if self.merge_mode not in ("add", "concat"):
            raise ValueError(f"unknown merge {merge!r}")
        bwd = Recurrent()
        bwd.reverse = True
        super().add(Recurrent())
        super().add(bwd)

    @property
    def fwd(self) -> Recurrent:
        return self[0]

    @property
    def bwd(self) -> Recurrent:
        return self[1]

    def add(self, cell: Cell) -> "BiRecurrent":
        gen = getattr(cell, "_generator", None)
        memo = {} if gen is None else {id(gen): gen}
        rev = copy.deepcopy(cell, memo)
        rev.name = cell.name + "_rev"
        rev.reset_parameters()
        self.fwd.add(cell)
        self.bwd.add(rev)
        return self

    def forward(self, x):
        fo, bo = self.fwd(x), self.bwd(x)
        if self.merge_mode == "add":
            return fo + bo
        return torch.cat([fo, bo], dim=-1)
