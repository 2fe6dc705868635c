"""Recurrent layers (``bigdl_tpu/nn/recurrent.py``): ``Cell`` (``:29``),
``_FusedInputCell`` (``:114``), ``RnnCell`` (``:127``), ``LSTM``
(``:165``), ``LSTMPeephole`` (``:209``), ``ConvLSTMPeephole``
(``:243``), ``GRU`` (``:356``), ``Recurrent`` (``:419``),
``BiRecurrent`` (``:501``), ``RecurrentDecoder`` (``:562``),
``TimeDistributed`` (``:607``) and ``MultiRNNCell`` (``:641``).

Activity is ``(batch, time, feature)``. The JAX ``Recurrent`` is one
``lax.scan``; here it is a loop over time in Python. As in JAX, the
input leg of every gate runs once over the whole sequence before the
loop (``precompute_input``: one ``(B·T, I) × (I, G·H)`` product, or one
convolution over the ``B·T`` frames of a ``ConvLSTMPeephole``), so each
time step launches only the hidden-to-hidden product and the gates'
elementwise ops. A reversed ``Recurrent`` runs from the last step to the
first and stores each output at its original time index
(``:493-496``), so its whole-sequence state sits at ``t = 0``. The carry
is sized by ``Cell.init_carry_for(x)`` (a ConvLSTM's state is spatial)
and the step is ``Cell.with_masks(h_masks)`` when dropout masks are
drawn (a ``MultiRNNCell`` binds its inter-layer input masks there).

A cell's ``p`` is variational dropout (``:455-481``): in training mode,
with a generator current (:func:`bigdl_tpu_torch.nn.module.use_rng`),
``Recurrent`` draws one mask per sequence for the input and one for each
hidden state, shared by every time step (a ConvLSTM's per (batch,
channel), broadcast over the frame).

Parameters are JAX's leaves (``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``,
the peepholes ``w_pi``/``w_pf``/``w_po``; gate orders i, f, g, o and, for
the GRU, r, z, n; ``RandomUniform`` weights and zero biases) and
containers key their children ``"{i}:{name}"``, so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries a JAX
tree across. ``RnnCell``'s activation is not a child: JAX keys no params
for it. The carry starts as f32 zeros, as JAX's, and a product of two
dtypes runs in the wider one, as ``jnp.matmul`` promotes. XLA lowers
all of it without Pallas, so it is plain PyTorch here: cuBLAS products
and cuDNN convolutions on the card.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch
import torch.nn.functional as F

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

    def init_carry_for(self, x) -> tuple:
        """The zero carry for input ``x`` (a sequence ``(B, T, ...)`` or a
        step ``(B, ...)``); a spatial cell sizes it from the frame."""
        return self.init_carry(x.shape[0], x.device)

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

    def with_masks(self, h_masks):
        """The step with per-sequence masks bound beyond what
        :meth:`mask_carry` applies: none for a plain cell."""
        return self.step_pre

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
            carry = self.init_carry_for(x_t)
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


def _wider(*ts) -> torch.dtype:
    """The dtype ``jnp.matmul`` promotes ``ts`` to."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _fill(weights, biases, generator) -> None:
    """``RandomUniform`` weights and zero biases, JAX's cell init."""
    for w in weights:
        RandomUniform().fill(w.data, generator)
    for b in biases:
        Zeros().fill(b.data)


class RnnCell(_FusedInputCell):
    """Vanilla RNN (reference ``nn/RnnCell.scala``): ``h' = act(W_ih x +
    b_ih + W_hh h + b_hh)``, both biases as torch keeps them. The
    activation (default ``Tanh``) holds no parameters in JAX's tree, so
    it is kept out of the module tree too."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: Optional[AbstractModule] = None,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__(hidden_size)
        from bigdl_tpu_torch.nn.activations import Tanh

        self.input_size = input_size
        # in __dict__, not _modules: no child for named_leaves, freeze or
        # the quantizer to see
        self.__dict__["activation"] = activation or Tanh()
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        self._generator = generator
        self.w_ih = new_param((hidden_size, input_size), device)
        self.w_hh = new_param((hidden_size, hidden_size), device)
        self.b_ih = new_param((hidden_size,), device)
        self.b_hh = new_param((hidden_size,), device)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> "RnnCell":
        _fill((self.w_ih, self.w_hh), (self.b_ih, self.b_hh),
              self._draws(generator))
        return self

    def step_pre(self, pre_t, carry):
        (h,) = carry
        dt = _wider(pre_t, h, self.w_hh)
        a = torch.addmm(pre_t.to(dt), h.to(dt),
                        self.w_hh.t().to(dt)) + self.b_hh
        out = self.activation(a)
        return out, (out,)


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
        self.w_ih = new_param((h4, input_size), device)
        self.w_hh = new_param((h4, hidden_size), device)
        self.b_ih = new_param((h4,), device)
        self.b_hh = new_param((h4,), device)
        LSTM.reset_parameters(self)

    def reset_parameters(self, generator=None) -> "LSTM":
        """Refill the weights (``RandomUniform``) and biases (zeros) from
        ``generator``, else the cell's own."""
        _fill((self.w_ih, self.w_hh), (self.b_ih, self.b_hh),
              self._draws(generator))
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


class LSTMPeephole(LSTM):
    """LSTM with diagonal peepholes ``w_pi``, ``w_pf``, ``w_po`` (H,) from
    the cell state into the i, f and o gates (reference
    ``nn/LSTMPeephole.scala``): i and f read the old ``c``, o reads the
    new one."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__(input_size, hidden_size, p, w_regularizer,
                         u_regularizer, b_regularizer, device, generator)
        dev = self.w_ih.device
        self.w_pi = new_param((hidden_size,), dev)
        self.w_pf = new_param((hidden_size,), dev)
        self.w_po = new_param((hidden_size,), dev)
        _fill((self.w_pi, self.w_pf, self.w_po), (), self._generator)

    def reset_parameters(self, generator=None) -> "LSTMPeephole":
        super().reset_parameters(generator)
        _fill((self.w_pi, self.w_pf, self.w_po), (), self._draws(generator))
        return self

    def step_pre(self, pre_t, carry):
        h, c = carry
        dt = _wider(pre_t, h, self.w_hh)
        gates = torch.addmm(pre_t.to(dt), h.to(dt),
                            self.w_hh.t().to(dt)) + self.b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i = torch.sigmoid(i + self.w_pi * c)
        f = torch.sigmoid(f + self.w_pf * c)
        new_c = f * c + i * torch.tanh(g)
        o = torch.sigmoid(o + self.w_po * new_c)
        new_h = o * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM with per-channel peepholes over ``(B, C, H, W)``
    frames (reference ``nn/ConvLSTMPeephole.scala``): the gates are
    SAME-padded stride-1 convolutions of the input frame (``w_ih``,
    ``b_ih``) and the hidden state (``w_hh``, no bias); the state (h, c)
    is ``(B, output_size, H, W)``; the peepholes are ``(O, 1, 1)``.
    Driven by ``Recurrent`` over ``(B, T, C, H, W)``, the input leg of all
    four gates is one convolution over the ``B·T`` frames."""

    carry_len = 2  # (h, c)
    _reg_b_keys = ("b_ih",)

    def __init__(self, input_size: int, output_size: int,
                 kernel_i: int = 3, kernel_c: int = 3, stride: int = 1,
                 p: float = 0.0, with_peephole: bool = True,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__(output_size)
        if stride != 1:
            raise ValueError("ConvLSTMPeephole: state recurrence needs "
                             "stride 1 (reference contract)")
        self.input_size = input_size
        self.output_size = output_size
        self.kernel_i = kernel_i
        self.kernel_c = kernel_c
        self.p = p
        self.with_peephole = with_peephole
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        self._generator = generator
        o4 = 4 * output_size
        self.w_ih = new_param((o4, input_size, kernel_i, kernel_i), device)
        self.w_hh = new_param((o4, output_size, kernel_c, kernel_c), device)
        self.b_ih = new_param((o4,), device)
        if with_peephole:
            for name in ("w_pi", "w_pf", "w_po"):
                setattr(self, name, new_param((output_size, 1, 1), device))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> "ConvLSTMPeephole":
        peep = ((self.w_pi, self.w_pf, self.w_po) if self.with_peephole
                else ())
        _fill((self.w_ih, self.w_hh) + peep, (self.b_ih,),
              self._draws(generator))
        return self

    @staticmethod
    def _conv(x, w, b=None):
        dt = _wider(x, w)
        out = F.conv2d(x.to(dt), w.to(dt), padding="same")
        return out if b is None else out + b[:, None, None]

    def init_carry_for(self, x) -> tuple:
        shape = (x.shape[0], self.output_size) + tuple(x.shape[-2:])
        return tuple(torch.zeros(shape, dtype=torch.float32, device=x.device)
                     for _ in range(self.carry_len))

    def init_carry(self, batch_size: int, device) -> tuple:
        raise ValueError(
            "ConvLSTMPeephole state needs the frame's spatial dims — drive "
            "it through Recurrent (which uses init_carry_for)")

    def dropout_specs(self):
        # per-(batch, channel) masks, broadcast over the frame
        return [(self.p, self.output_size)]

    def mask_carry(self, carry, h_masks):
        m = h_masks[0]
        if m is None:
            return carry
        return (carry[0] * m[:, :, None, None],) + tuple(carry[1:])

    def precompute_input(self, x):
        """``(B, T, C, H, W)``: T folded into the batch for one gate
        convolution."""
        b, t = x.shape[:2]
        pre = self._conv(x.reshape((b * t,) + tuple(x.shape[2:])),
                         self.w_ih, self.b_ih)
        return pre.reshape((b, t) + tuple(pre.shape[1:]))

    def step_pre(self, pre_t, carry):
        h, c = carry
        gates = pre_t + self._conv(h, self.w_hh)
        i, f, g, o = gates.chunk(4, dim=1)
        if self.with_peephole:
            i = i + self.w_pi * c
            f = f + self.w_pf * c
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        if self.with_peephole:
            o = o + self.w_po * new_c
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)

    def step(self, x_t, carry):
        return self.step_pre(self._conv(x_t, self.w_ih, self.b_ih), carry)


class GRU(_FusedInputCell):
    """GRU cell (reference ``nn/GRU.scala``), gates r, z, n with separate
    input and hidden biases: ``n = tanh(W_in x + b_in + r * (W_hn h +
    b_hn))``, torch's form. ``reset_after=False`` is the keras-1 form,
    ``n = tanh(W_in x + b_in + W_hn (r * h) + b_hn)``, which splits
    ``w_hh`` into its r/z half and its n half."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 reset_after: bool = True, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__(hidden_size)
        self.input_size = input_size
        self.p = p
        self.reset_after = reset_after
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        self._generator = generator
        h3 = 3 * hidden_size
        self.w_ih = new_param((h3, input_size), device)
        self.w_hh = new_param((h3, hidden_size), device)
        self.b_ih = new_param((h3,), device)
        self.b_hh = new_param((h3,), device)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> "GRU":
        _fill((self.w_ih, self.w_hh), (self.b_ih, self.b_hh),
              self._draws(generator))
        return self

    def step_pre(self, pre_t, carry):
        (h,) = carry
        dt = _wider(pre_t, h, self.w_hh)
        hd, w, b = h.to(dt), self.w_hh.to(dt), self.b_hh.to(dt)
        xr, xz, xn = pre_t.to(dt).chunk(3, dim=-1)
        if self.reset_after:
            hr, hz, hn = F.linear(hd, w, b).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
        else:
            H = self.hidden_size
            hr, hz = F.linear(hd, w[:2 * H], b[:2 * H]).chunk(2, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + F.linear(r * hd, w[2 * H:], b[2 * H:]))
        new_h = (1.0 - z) * n + z * h
        return new_h, (new_h,)


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
        carry = cell.init_carry_for(x)
        step = cell.step_pre if h_masks is None else cell.with_masks(h_masks)
        outs: List[Optional[torch.Tensor]] = [None] * steps
        order = range(steps - 1, -1, -1) if self.reverse else range(steps)
        for t in order:
            if h_masks is not None:
                carry = cell.mask_carry(carry, h_masks)
            outs[t], carry = step(pre[:, t], carry)
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
        # the copy draws from the cells' own generators, not copies of them
        gens = (getattr(m, "_generator", None) for m in cell.modules())
        memo = {id(g): g for g in gens if g is not None}
        rev = copy.deepcopy(cell, memo)
        rev.name = cell.name + "_rev"
        rev.reset()
        self.fwd.add(cell)
        self.bwd.add(rev)
        return self

    def forward(self, x):
        fo, bo = self.fwd(x), self.bwd(x)
        if self.merge_mode == "add":
            return fo + bo
        return torch.cat([fo, bo], dim=-1)


class RecurrentDecoder(Container):
    """Decoder unroll (reference ``nn/RecurrentDecoder.scala``): the input
    is the first step ``(B, F)``; each step's output is the next step's
    input (through ``cell.step``), for ``output_length`` steps; output
    ``(B, output_length, H)``. The cell's output size must equal its
    input size."""

    def __init__(self, output_length: int) -> None:
        super().__init__()
        self.output_length = output_length

    def add(self, cell: Cell) -> "RecurrentDecoder":
        if len(self):
            raise ValueError("a RecurrentDecoder holds one cell")
        return super().add(cell)

    @property
    def cell(self) -> Optional[Cell]:
        return self[0] if len(self) else None

    def forward(self, x):
        cell = self.cell
        carry = cell.init_carry_for(x)
        outs = []
        for _ in range(self.output_length):
            x, carry = cell.step(x, carry)
            outs.append(x)
        return torch.stack(outs, dim=1)


class TimeDistributed(Container):
    """Its one layer applied to every time step of ``(B, T, ...)``
    activity (reference ``nn/TimeDistributed.scala``): (B, T) folded into
    one batch, the layer run once, the output unfolded. A container, so
    the quantizer's walk swaps a ``Linear`` inside it."""

    def __init__(self, layer: AbstractModule) -> None:
        super().__init__()
        self.add(layer)

    @property
    def layer(self) -> AbstractModule:
        return self[0]

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        out = self[0](x.reshape((b * t,) + tuple(x.shape[2:])))
        return out.reshape((b, t) + tuple(out.shape[1:]))


class MultiRNNCell(Cell, Container):
    """A stack of cells run as one cell (reference
    ``nn/MultiRNNCell.scala``): each sub-cell's output feeds the next,
    the carry is the sub-cells' carries laid end to end, and only the
    first sub-cell's input leg is hoisted over the sequence. Children are
    keyed ``"{i}:{name}"``; a cell already held by another container
    (``examples/languagemodel.py`` stacks a trained model's cells) keeps
    that container's key."""

    def __init__(self, cells: List[Cell]) -> None:
        super().__init__(cells[-1].hidden_size)
        for i, c in enumerate(cells):
            self.add_module(f"{i}:{c.name}", c)
            if c._container_key is None:
                c._container_key = f"{i}:{c.name}"
        self.carry_len = sum(c.carry_len for c in cells)

    @property
    def cells(self) -> List[Cell]:
        return self.layers()

    def init_carry(self, batch_size: int, device) -> tuple:
        return tuple(t for c in self.cells
                     for t in c.init_carry(batch_size, device))

    def init_carry_for(self, x) -> tuple:
        # stride-1 stacks keep a spatial state's frame layer to layer
        return tuple(t for c in self.cells for t in c.init_carry_for(x))

    @property
    def input_dropout_p(self) -> float:
        return self.cells[0].p

    def _n_h_specs(self) -> int:
        return sum(len(c.dropout_specs()) for c in self.cells)

    def dropout_specs(self):
        """The sub-cells' recurrent specs, then one input spec per later
        sub-cell: its ``p`` drops the previous cell's per-step output."""
        cells = self.cells
        out = [spec for c in cells for spec in c.dropout_specs()]
        out += [(cells[i].p, cells[i - 1].hidden_size)
                for i in range(1, len(cells))]
        return out

    def mask_carry(self, carry, h_masks):
        new, idx, mi = list(carry), 0, 0
        for c in self.cells:
            n = len(c.dropout_specs())
            new[idx: idx + c.carry_len] = c.mask_carry(
                tuple(new[idx: idx + c.carry_len]), h_masks[mi: mi + n])
            idx += c.carry_len
            mi += n
        return tuple(new)

    def with_masks(self, h_masks):
        in_masks = h_masks[self._n_h_specs():]
        return lambda pre_t, carry: self._run_stack(pre_t, carry, in_masks)

    def precompute_input(self, x):
        return self.cells[0].precompute_input(x)

    def step_pre(self, pre_t, carry):
        return self._run_stack(pre_t, carry, None)

    def _run_stack(self, pre_t, carry, in_masks):
        new, h, idx = [], pre_t, 0
        for i, c in enumerate(self.cells):
            sub = tuple(carry[idx: idx + c.carry_len])
            idx += c.carry_len
            if i == 0:
                h, nc = c.step_pre(h, sub)
            else:
                if in_masks is not None and in_masks[i - 1] is not None:
                    h = h * in_masks[i - 1]
                h, nc = c.step(h, sub)
            new.extend(nc)
        return h, tuple(new)

    def step(self, x_t, carry):
        return self.step_pre(self.precompute_input(x_t), carry)
