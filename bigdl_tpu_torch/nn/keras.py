"""Keras-style API — ``Sequential``/``Model`` with shape inference
(``bigdl_tpu/nn/keras.py``).

A Keras-1.2 flavoured layer set (``Dense``, ``Convolution2D``,
``MaxPooling2D``, ...) over the port's core layers: each Keras layer is a
thin shape-aware wrapper whose ``build`` makes its core module, so only
the first layer declares ``input_shape`` and every later one infers it at
``Sequential.add`` or at ``layer(node)`` (the functional API). Shapes
exclude the batch dim; images are CHW, as the core NCHW convolution.

What the port adds to JAX's layers:

* **Placement.** A core makes its parameters when it is built, so every
  Keras layer takes ``device=`` and ``generator=`` and hands them to its
  core. A layer that has none takes them from where it is built: the
  Keras ``Sequential`` it is added to, or the :func:`Input` its node
  descends from. The default device is the card (``cuda``); without one
  building raises unless ``device="cpu"`` is asked for.
* **The params tree.** JAX's Keras layer returns its core's tree as its
  own, with no level of its own (``keras.py:66-68``). The port's layer
  holds its core as the child ``_core`` and declares it with
  ``_tree_through``, so :mod:`bigdl_tpu_torch.utils.params_tree` walks
  through it: a JAX Keras model's tree loads into the port's unchanged.
* **Classes the serializer can rebuild.** ``Highway``'s core and
  ``Permute``'s are module-level classes here (JAX defines them inside
  ``build_core``, so its ``load_module`` refuses them).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn import activations as _act
from bigdl_tpu_torch.nn import containers as _containers
from bigdl_tpu_torch.nn.module import AbstractModule, Identity, TensorModule
from bigdl_tpu_torch.utils.device import resolve_device

Shape = Tuple[int, ...]

_ACTIVATIONS = {
    "relu": _act.ReLU, "tanh": _act.Tanh, "sigmoid": _act.Sigmoid,
    "softmax": _act.SoftMax, "log_softmax": _act.LogSoftMax,
    "elu": _act.ELU, "softplus": _act.SoftPlus, "softsign": _act.SoftSign,
    "gelu": _act.GELU, "linear": None, None: None,
}


class KerasLayer(AbstractModule):
    """Base: a shape-aware layer that makes its core module in ``build``."""

    #: params_tree walks a Keras layer's core as the layer itself
    _tree_through = "_core"

    def __init__(self, input_shape: Optional[Sequence[int]] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.input_shape: Optional[Shape] = (
            tuple(input_shape) if input_shape is not None else None)
        self.output_shape: Optional[Shape] = None
        self.device = device
        self.generator = generator
        self._core: Optional[AbstractModule] = None

    # subclass contract ----------------------------------------------------

    def build_core(self, input_shape: Shape) -> AbstractModule:
        raise NotImplementedError

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        raise NotImplementedError

    # plumbing -------------------------------------------------------------

    def place(self, device=None, generator=None) -> "KerasLayer":
        """Settle the device and generator: the layer's own, else the
        ones given (its container's or its input node's)."""
        self.device = resolve_device(self.device if self.device is not None
                                     else device)
        if self.generator is None:
            self.generator = generator
        return self

    def _kw(self) -> dict:
        """The placement a core with parameters (or buffers) takes."""
        return {"device": self.device, "generator": self.generator}

    def build(self, input_shape: Shape, device=None,
              generator=None) -> "KerasLayer":
        self.place(device, generator)
        self.input_shape = tuple(input_shape)
        self._core = self.build_core(self.input_shape)
        self.output_shape = self.compute_output_shape(self.input_shape)
        return self

    def get_output_shape(self) -> Shape:
        if self.output_shape is None:
            raise ValueError(f"{self.name} is not built yet")
        return self.output_shape

    def forward(self, x):
        if self._core is None:
            raise ValueError(f"{self.name} is not built yet")
        return self._core(x)

    # functional (Model) API: layer(node) builds from the node's shape
    def __call__(self, node):
        if isinstance(node, KerasNode):
            self.build(node.shape, node.device, node.generator)
            return KerasNode(self.get_output_shape(), self, [node],
                             node.device, node.generator)
        return super().__call__(node)


class KerasNode:
    """A symbolic tensor of the functional API: its shape, the layer that
    produces it and the nodes that feed it; ``device``/``generator`` pass
    on to the layers built from it."""

    def __init__(self, shape: Shape, layer: Optional[KerasLayer],
                 inbound: Sequence["KerasNode"], device=None,
                 generator: torch.Generator = None) -> None:
        self.shape = tuple(shape)
        self.layer = layer
        self.inbound = list(inbound)
        self.device = device
        self.generator = generator


def Input(shape: Sequence[int], device=None,
          generator: torch.Generator = None) -> KerasNode:
    """Entry point of the functional API (batch dim excluded); the layers
    built downstream take ``device``/``generator`` unless they have their
    own."""
    return KerasNode(tuple(shape), None, [], device, generator)


def _activation(name) -> AbstractModule:
    if isinstance(name, AbstractModule):
        return name
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r} (known: "
                         f"{sorted(k for k in _ACTIVATIONS if k)})")
    cls = _ACTIVATIONS[name]
    return Identity() if cls is None else cls()


def _maybe_activation(core: AbstractModule, activation) -> AbstractModule:
    if activation is None or activation == "linear":
        return core
    return _containers.Sequential().add(core).add(_activation(activation))


class Dense(KerasLayer):
    def __init__(self, output_dim: int, activation=None, bias: bool = True,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.output_dim = output_dim
        self.activation = activation
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.linear import Linear

        return _maybe_activation(
            Linear(input_shape[-1], self.output_dim, with_bias=self.bias,
                   **self._kw()),
            self.activation)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class _IdentityShaped(KerasLayer):
    """Shared base of the shape-preserving layers."""

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class Activation(_IdentityShaped):
    def __init__(self, activation: str, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.activation = activation

    def build_core(self, input_shape):
        return _activation(self.activation)


class Dropout(_IdentityShaped):
    def __init__(self, p: float, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.p = p

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.misc import Dropout as CoreDropout

        return CoreDropout(self.p)


class Flatten(KerasLayer):
    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.shape_ops import Reshape as CoreReshape

        return CoreReshape([int(np.prod(input_shape))], batch_mode=True)

    def compute_output_shape(self, input_shape):
        return (int(np.prod(input_shape)),)


class Reshape(KerasLayer):
    def __init__(self, target_shape: Sequence[int], input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.target_shape = tuple(target_shape)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.shape_ops import Reshape as CoreReshape

        return CoreReshape(list(self.target_shape), batch_mode=True)

    def compute_output_shape(self, input_shape):
        return self.target_shape


class Convolution2D(KerasLayer):
    """CHW input; ``border_mode``: 'valid' | 'same' (Keras-1.2 names)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample: Tuple[int, int] = (1, 1),
                 border_mode: str = "valid", activation=None,
                 bias: bool = True, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.subsample = tuple(subsample)
        self.border_mode = border_mode
        self.activation = activation
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.conv import SpatialConvolution

        pad = -1 if self.border_mode == "same" else 0
        return _maybe_activation(
            SpatialConvolution(
                input_shape[0], self.nb_filter, self.nb_col, self.nb_row,
                self.subsample[1], self.subsample[0], pad, pad,
                with_bias=self.bias, **self._kw()),
            self.activation)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        sh, sw = self.subsample
        if self.border_mode == "same":
            return (self.nb_filter, -(-h // sh), -(-w // sw))
        return (self.nb_filter, (h - self.nb_row) // sh + 1,
                (w - self.nb_col) // sw + 1)


class _Pooling2D(KerasLayer):
    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid",
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides is not None else self.pool_size
        self.border_mode = border_mode

    def _core_cls(self):
        raise NotImplementedError

    def build_core(self, input_shape):
        pad = -1 if self.border_mode == "same" else 0
        return self._core_cls()(
            self.pool_size[1], self.pool_size[0],
            self.strides[1], self.strides[0], pad, pad)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        ph, pw = self.pool_size
        sh, sw = self.strides
        if self.border_mode == "same":
            return (c, -(-h // sh), -(-w // sw))
        return (c, (h - ph) // sh + 1, (w - pw) // sw + 1)


class MaxPooling2D(_Pooling2D):
    def _core_cls(self):
        from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling

        return SpatialMaxPooling


class AveragePooling2D(_Pooling2D):
    def _core_cls(self):
        from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling

        return SpatialAveragePooling


class BatchNormalization(_IdentityShaped):
    """Keras's ``momentum`` keeps the old statistic; the core's moves to
    the new one, so the core gets ``1 - momentum``."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.epsilon = epsilon
        self.momentum = momentum

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn import normalization as _norm

        cls = (_norm.SpatialBatchNormalization if len(input_shape) == 3
               else _norm.BatchNormalization)       # CHW maps, else (D,)
        n = input_shape[0] if len(input_shape) == 3 else input_shape[-1]
        return cls(n, eps=self.epsilon, momentum=1 - self.momentum,
                   **self._kw())


class _ShiftIndices(TensorModule):
    """Keras token ids are 0-based; the core LookupTable is 1-based (the
    reference's convention): shift by +1, keeping the integer dtype."""

    def forward(self, x):
        return x + 1


class Embedding(KerasLayer):
    def __init__(self, input_dim: int, output_dim: int, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.misc import LookupTable

        return (_containers.Sequential()
                .add(_ShiftIndices())
                .add(LookupTable(self.input_dim, self.output_dim,
                                 **self._kw())))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class _KerasRecurrent(KerasLayer):
    def __init__(self, output_dim: int, return_sequences: bool = False,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.output_dim = output_dim
        self.return_sequences = return_sequences

    def _cell(self, input_shape):
        """The recurrent cell for the whole (unbatched) input shape:
        vector cells take ``input_shape[-1]``, ConvLSTM2D the channel and
        spatial dims."""
        raise NotImplementedError

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.recurrent import Recurrent
        from bigdl_tpu_torch.nn.shape_ops import Select

        rec = Recurrent().add(self._cell(input_shape))
        if self.return_sequences:
            return rec
        return _containers.Sequential().add(rec).add(Select(2, -1))

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], self.output_dim)
        return (self.output_dim,)


class LSTM(_KerasRecurrent):
    """Sigmoid gates and a tanh output (Keras 1.2's ``activation`` and
    ``inner_activation`` must be these for a loaded model to compute the
    same function; the importer refuses others)."""

    def _cell(self, input_shape):
        from bigdl_tpu_torch.nn.recurrent import LSTM as CoreLSTM

        return CoreLSTM(input_shape[-1], self.output_dim, **self._kw())


class GRU(_KerasRecurrent):
    def _cell(self, input_shape):
        from bigdl_tpu_torch.nn.recurrent import GRU as CoreGRU

        # the keras-1 GRU: the reset gate applies BEFORE the candidate's
        # product, and load_keras routes keras-1 GRU weights here
        return CoreGRU(input_shape[-1], self.output_dim, reset_after=False,
                       **self._kw())


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.padding = tuple(padding)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import SpatialZeroPadding

        ph, pw = self.padding
        return SpatialZeroPadding(pw, pw, ph, ph)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        ph, pw = self.padding
        return (c, h + 2 * ph, w + 2 * pw)


class UpSampling2D(KerasLayer):
    def __init__(self, size=(2, 2), input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        if size[0] != size[1]:
            raise ValueError(f"UpSampling2D wants a square scale, got {size}")
        self.size = tuple(size)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import SpatialUpSamplingNearest

        return SpatialUpSamplingNearest(self.size[0])

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h * self.size[0], w * self.size[1])


class GlobalAveragePooling2D(KerasLayer):
    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling
        from bigdl_tpu_torch.nn.shape_ops import Reshape as CoreReshape

        pool = SpatialAveragePooling(1, 1, 1, 1, global_pooling=True)
        return _containers.Sequential().add(pool).add(
            CoreReshape([input_shape[0]], batch_mode=True))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class Merge(KerasLayer):
    """Combine a list of inputs: ``mode`` in sum|mul|max|concat (Keras-1.2
    ``Merge``). ``concat_axis`` indexes the BATCHED tensor, as in Keras
    (axis 0 is the batch and raises; -1 is the last)."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        if mode not in ("sum", "mul", "max", "concat"):
            raise ValueError(f"Merge mode {mode!r} is not one of "
                             "sum, mul, max, concat")
        if mode == "concat" and concat_axis == 0:
            raise ValueError("cannot concat along the batch axis")
        self.mode = mode
        self.concat_axis = concat_axis
        self._n_inputs = 2  # refined when called with functional nodes
        self._input_shapes = None

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn import shape_ops as S

        if self.mode == "sum":
            return S.CAddTable()
        if self.mode == "mul":
            return S.CMulTable()
        if self.mode == "max":
            return S.CMaxTable()
        # JoinTable's n_input_dims handles the implicit batch dim, so the
        # batched axis k is the 1-based non-batch dim k
        ax = self.concat_axis
        dim = len(self.input_shape) if ax == -1 else ax
        return S.JoinTable(dim, len(self.input_shape))

    def compute_output_shape(self, input_shape):
        if self.mode != "concat":
            return tuple(input_shape)
        shape = list(input_shape)
        ax = self.concat_axis if self.concat_axis != -1 else len(shape)
        # batchless index ax - 1 of the batched axis; the inputs' own
        # widths when the functional call gave them (JAX multiplies the
        # first input's width by the input count)
        shape[ax - 1] = (sum(s[ax - 1] for s in self._input_shapes)
                         if self._input_shapes else
                         shape[ax - 1] * self._n_inputs)
        return tuple(shape)

    def __call__(self, nodes):
        if isinstance(nodes, (list, tuple)) and nodes and isinstance(
                nodes[0], KerasNode):
            self._n_inputs = len(nodes)
            self._input_shapes = [n.shape for n in nodes]
            first = nodes[0]
            self.build(first.shape, first.device, first.generator)
            return KerasNode(self.get_output_shape(), self, list(nodes),
                             first.device, first.generator)
        return super().__call__(nodes)


class HighwayCore(_containers.Container):
    """``t·h(x) + (1−t)·x`` with ``h`` = activation(Linear) and the
    transform gate ``t`` = sigmoid(Linear); the two Linears are children
    0 and 1, as JAX keys them (``0:<h.name>``, ``1:<t.name>``)."""

    def __init__(self, d: int, activation="relu", device=None,
                 generator: torch.Generator = None) -> None:
        from bigdl_tpu_torch.nn.linear import Linear

        super().__init__()
        self.add(Linear(d, d, device=device, generator=generator))
        self.add(Linear(d, d, device=device, generator=generator))
        self.activation = activation
        # kept out of _modules: JAX's tree has no key for it
        self.__dict__["act"] = _activation(activation)

    def forward(self, x):
        h = self.act(self[0](x))
        t = torch.sigmoid(self[1](x))
        return t * h + (1 - t) * x


class Highway(_IdentityShaped):
    """Keras-1.2 Highway layer: ``t·h(x) + (1−t)·x`` with learned transform
    and carry gates."""

    def __init__(self, activation="relu", input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.activation = activation

    def build_core(self, input_shape):
        return HighwayCore(input_shape[-1], self.activation, **self._kw())


class Sequential(KerasLayer):
    """Keras-style Sequential: the first layer carries ``input_shape``;
    every later layer infers its shape at ``add``. Layers without a
    device or generator of their own take the Sequential's."""

    def __init__(self, device=None, generator: torch.Generator = None
                 ) -> None:
        super().__init__(None, device, generator)
        self._core = _containers.Sequential()
        self.__dict__["layers"] = []     # the Keras layers, in _core too
        self._cur: Optional[Shape] = None

    def add(self, layer: KerasLayer) -> "Sequential":
        if self._cur is None:
            if layer.input_shape is None:
                raise ValueError("the first layer needs input_shape=...")
            self._cur = layer.input_shape
            self.input_shape = layer.input_shape
        layer.build(self._cur, self.device, self.generator)
        self._cur = layer.get_output_shape()
        self.output_shape = self._cur
        self.layers.append(layer)
        self._core.add(layer)
        return self

    def build_core(self, input_shape):
        return self._core

    def compute_output_shape(self, input_shape):
        return self._cur

    def get_output_shape(self) -> Shape:
        if self._cur is None:
            raise ValueError("empty keras Sequential")
        return self._cur


class Model(KerasLayer):
    """Functional API: ``Model(input=node(s), output=node(s))`` lowers
    the KerasNode DAG to a core :class:`~bigdl_tpu_torch.nn.graph.Graph`,
    one graph node per Keras node (a node feeding several layers stays
    one node)."""

    def __init__(self, input, output) -> None:
        from bigdl_tpu_torch.nn.graph import Graph
        from bigdl_tpu_torch.nn.graph import Input as GraphInput

        ins = input if isinstance(input, (list, tuple)) else [input]
        super().__init__(None, ins[0].device, ins[0].generator)
        node_map = {}

        def lower(kn: KerasNode):
            nid = id(kn)
            if nid in node_map:
                return node_map[nid]
            if kn.layer is None:
                gn = GraphInput()
            else:
                gn = kn.layer.inputs(*[lower(p) for p in kn.inbound])
            node_map[nid] = gn
            return gn

        outs = output if isinstance(output, (list, tuple)) else [output]
        g_outs = [lower(o) for o in outs]
        missing = [i for i in ins if id(i) not in node_map]
        if missing:
            raise ValueError("a model input does not reach any output")
        g_ins = [node_map[id(i)] for i in ins]
        self._core = Graph(g_ins if len(g_ins) > 1 else g_ins[0],
                           g_outs if len(g_outs) > 1 else g_outs[0])
        self.input_shape = tuple(ins[0].shape)
        self.output_shape = tuple(outs[0].shape)

    def build_core(self, input_shape):
        return self._core

    def compute_output_shape(self, input_shape):
        return self.output_shape


# ---------------------------------------------------------------------------
# the second batch (the reference's nn/keras layer inventory)
# ---------------------------------------------------------------------------

class SimpleRNN(_KerasRecurrent):
    def _cell(self, input_shape):
        from bigdl_tpu_torch.nn.recurrent import RnnCell

        return RnnCell(input_shape[-1], self.output_dim, **self._kw())


class Bidirectional(KerasLayer):
    """A Keras recurrent layer's cell run both ways in a BiRecurrent
    (reference ``nn/keras/Bidirectional.scala``); ``merge_mode``
    "concat" | "sum"."""

    def __init__(self, layer: _KerasRecurrent, merge_mode: str = "concat",
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape or layer.input_shape, **placement)
        if not layer.return_sequences:
            raise ValueError("Bidirectional requires return_sequences=True "
                             "(the reference's rule)")
        self.__dict__["layer"] = layer   # a spec: only its cell is built
        self.merge_mode = merge_mode

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.recurrent import BiRecurrent

        merge = "concat" if self.merge_mode == "concat" else "add"
        self.layer.place(self.device, self.generator)
        return BiRecurrent(merge=merge).add(self.layer._cell(input_shape))

    def compute_output_shape(self, input_shape):
        h = self.layer.output_dim
        if self.merge_mode == "concat":
            h *= 2
        return (input_shape[0], h)


class TimeDistributed(KerasLayer):
    """An inner Keras layer applied to every time step (reference
    ``nn/keras/TimeDistributed.scala``)."""

    def __init__(self, layer: KerasLayer, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.__dict__["layer"] = layer   # its core is the wrapped module

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.recurrent import TimeDistributed as CoreTD

        self.layer.build(tuple(input_shape[1:]), self.device, self.generator)
        return CoreTD(self.layer._core)

    def compute_output_shape(self, input_shape):
        inner = self.layer.compute_output_shape(tuple(input_shape[1:]))
        return (input_shape[0],) + tuple(inner)


class Convolution1D(KerasLayer):
    """Temporal convolution over (steps, input_dim) input (reference
    ``nn/keras/Convolution1D.scala``); ``border_mode`` "valid" | "same"."""

    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 bias: bool = True, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = subsample_length
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import TemporalConvolution
        from bigdl_tpu_torch.nn.shape_ops import Padding

        core = TemporalConvolution(input_shape[-1], self.nb_filter,
                                   self.filter_length, self.subsample,
                                   **self._kw())
        # the core always has a bias, so bias=False keeps one, as in JAX
        if self.border_mode == "same":
            pad = self.filter_length - 1
            # symmetric time padding before the valid convolution
            core = (_containers.Sequential()
                    .add(Padding(1, -(pad // 2), 2))
                    .add(Padding(1, pad - pad // 2, 2))
                    .add(core))
        return _maybe_activation(core, self.activation)

    def compute_output_shape(self, input_shape):
        t = input_shape[0]
        if self.border_mode == "valid":
            t = (t - self.filter_length) // self.subsample + 1
        else:
            t = (t + self.subsample - 1) // self.subsample
        return (t, self.nb_filter)


class SeparableConvolution2D(KerasLayer):
    """Depthwise-separable convolution over NCHW (reference
    ``nn/keras/SeparableConvolution2D.scala``)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, depth_multiplier: int = 1,
                 border_mode: str = "valid", subsample=(1, 1),
                 bias: bool = True, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.activation = activation
        self.depth_multiplier = depth_multiplier
        self.border_mode = border_mode
        self.subsample = tuple(subsample)
        self.bias = bias

    def _pads(self):
        if self.border_mode == "same":
            return (self.nb_col // 2, self.nb_row // 2)
        return (0, 0)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import SpatialSeparableConvolution

        pw, ph = self._pads()
        core = SpatialSeparableConvolution(
            input_shape[0], self.nb_filter, self.depth_multiplier,
            self.nb_col, self.nb_row, self.subsample[1], self.subsample[0],
            pw, ph, with_bias=self.bias, **self._kw())
        return _maybe_activation(core, self.activation)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        pw, ph = self._pads()
        oh = (h + 2 * ph - self.nb_row) // self.subsample[0] + 1
        ow = (w + 2 * pw - self.nb_col) // self.subsample[1] + 1
        return (self.nb_filter, oh, ow)


class LocallyConnected1D(KerasLayer):
    def __init__(self, nb_filter: int, filter_length: int, activation=None,
                 subsample_length: int = 1, bias: bool = True,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.activation = activation
        self.subsample = subsample_length
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import LocallyConnected1D as Core

        core = Core(input_shape[0], input_shape[1], self.nb_filter,
                    self.filter_length, self.subsample, with_bias=self.bias,
                    **self._kw())
        return _maybe_activation(core, self.activation)

    def compute_output_shape(self, input_shape):
        t = (input_shape[0] - self.filter_length) // self.subsample + 1
        return (t, self.nb_filter)


class LocallyConnected2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, subsample=(1, 1), bias: bool = True,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.activation = activation
        self.subsample = tuple(subsample)
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import LocallyConnected2D as Core

        c, h, w = input_shape
        core = Core(c, w, h, self.nb_filter, self.nb_col, self.nb_row,
                    self.subsample[1], self.subsample[0],
                    with_bias=self.bias, **self._kw())
        return _maybe_activation(core, self.activation)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        oh = (h - self.nb_row) // self.subsample[0] + 1
        ow = (w - self.nb_col) // self.subsample[1] + 1
        return (self.nb_filter, oh, ow)


class Cropping1D(KerasLayer):
    def __init__(self, cropping=(1, 1), input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.cropping = tuple(cropping)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.shape_ops import Narrow

        lo, hi = self.cropping
        # Narrow's offset is 1-based (the reference's convention)
        return Narrow(2, lo + 1, input_shape[0] - lo - hi)

    def compute_output_shape(self, input_shape):
        return (input_shape[0] - sum(self.cropping),) + tuple(input_shape[1:])


class Cropping2D(KerasLayer):
    def __init__(self, heightCrop=(0, 0), widthCrop=(0, 0),
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.hc, self.wc = tuple(heightCrop), tuple(widthCrop)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import Cropping2D as Core

        return Core(self.hc, self.wc)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h - sum(self.hc), w - sum(self.wc))


class Cropping3D(KerasLayer):
    def __init__(self, dim1Crop=(0, 0), dim2Crop=(0, 0), dim3Crop=(0, 0),
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.crops = (tuple(dim1Crop), tuple(dim2Crop), tuple(dim3Crop))

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import Cropping3D as Core

        return Core(*self.crops)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        (a, b), (e, f), (g, k) = self.crops
        return (c, d - a - b, h - e - f, w - g - k)


class PermuteCore(TensorModule):
    """Permute the non-batch dims by the 1-based ``dims``."""

    def __init__(self, dims: Sequence[int]) -> None:
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)


class Permute(KerasLayer):
    """Permute the non-batch dims (1-based dims, reference
    ``nn/keras/Permute.scala``)."""

    def __init__(self, dims: Sequence[int], input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.dims = tuple(dims)

    def build_core(self, input_shape):
        return PermuteCore(self.dims)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[d - 1] for d in self.dims)


class RepeatVector(KerasLayer):
    """(features,) → (n, features) (reference ``nn/keras/RepeatVector.scala``)."""

    def __init__(self, n: int, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.n = n

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import Replicate

        return Replicate(self.n, 1)

    def compute_output_shape(self, input_shape):
        return (self.n,) + tuple(input_shape)


class MaxoutDense(KerasLayer):
    def __init__(self, output_dim: int, nb_feature: int = 4, bias: bool = True,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.output_dim = output_dim
        self.nb_feature = nb_feature
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import Maxout

        return Maxout(input_shape[-1], self.output_dim, self.nb_feature,
                      with_bias=self.bias, **self._kw())

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[:-1]) + (self.output_dim,)


class ThresholdedReLU(_IdentityShaped):
    def __init__(self, theta: float = 1.0, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.theta = theta

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import Threshold

        return Threshold(self.theta, 0.0)


class SReLU(_IdentityShaped):
    def __init__(self, shared_axes=None, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.shared_axes = shared_axes

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import SReLU as Core

        return Core(tuple(input_shape), self.shared_axes, **self._kw())


class GaussianNoise(_IdentityShaped):
    def __init__(self, sigma: float, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.sigma = sigma

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import GaussianNoise as Core

        return Core(self.sigma)


class GaussianDropout(_IdentityShaped):
    def __init__(self, p: float, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.p = p

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import GaussianDropout as Core

        return Core(self.p)


class SpatialDropout1D(_IdentityShaped):
    def __init__(self, p: float = 0.5, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.p = p

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import SpatialDropout1D as Core

        return Core(self.p)


class SpatialDropout2D(_IdentityShaped):
    def __init__(self, p: float = 0.5, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.p = p

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import SpatialDropout2D as Core

        return Core(self.p)


class Masking(_IdentityShaped):
    def __init__(self, mask_value: float = 0.0, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.mask_value = mask_value

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import Masking as Core

        return Core(self.mask_value)


class LeakyReLU(_IdentityShaped):
    def __init__(self, alpha: float = 0.3, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.alpha = alpha

    def build_core(self, input_shape):
        return _act.LeakyReLU(self.alpha)


class ELU(_IdentityShaped):
    def __init__(self, alpha: float = 1.0, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.alpha = alpha

    def build_core(self, input_shape):
        return _act.ELU(self.alpha)


# -- the 1-D/3-D pooling family, padding, up-sampling, 3-D convolution ------


class _Pooling1D(KerasLayer):
    """(steps, dim) input; border_mode 'valid' | 'same'."""

    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 border_mode: str = "valid", input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        if border_mode not in ("valid", "same"):
            raise ValueError(
                f"border_mode must be 'valid' or 'same', got {border_mode!r}")
        self.pool_length = pool_length
        self.stride = stride if stride is not None else pool_length
        self.border_mode = border_mode

    def _core_cls(self):
        raise NotImplementedError

    def build_core(self, input_shape):
        return self._core_cls()(self.pool_length, self.stride,
                                pad_mode=self.border_mode.upper())

    def compute_output_shape(self, input_shape):
        steps, dim = input_shape
        if self.border_mode == "same":
            return (-(-steps // self.stride), dim)
        return ((steps - self.pool_length) // self.stride + 1, dim)


class MaxPooling1D(_Pooling1D):
    def _core_cls(self):
        from bigdl_tpu_torch.nn.layers_more import TemporalMaxPooling

        return TemporalMaxPooling


class AveragePooling1D(_Pooling1D):
    def _core_cls(self):
        from bigdl_tpu_torch.nn.layers_more import TemporalAveragePooling

        return TemporalAveragePooling


class GlobalMaxPooling1D(KerasLayer):
    """(steps, dim) → (dim,)."""

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.misc import Max

        return Max(1, n_input_dims=2)

    def compute_output_shape(self, input_shape):
        return (input_shape[1],)


class GlobalAveragePooling1D(KerasLayer):
    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.misc import Mean

        return Mean(1, n_input_dims=2)

    def compute_output_shape(self, input_shape):
        return (input_shape[1],)


class GlobalMaxPooling2D(KerasLayer):
    """(C, H, W) → (C,): one max pool whose window is the whole image."""

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.pooling import SpatialMaxPooling
        from bigdl_tpu_torch.nn.shape_ops import Reshape as CoreReshape

        c, h, w = input_shape
        return (_containers.Sequential()
                .add(SpatialMaxPooling(w, h))
                .add(CoreReshape([c], batch_mode=True)))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class _Pooling3D(KerasLayer):
    """(C, D, H, W) input; border_mode 'valid' only (the reference's keras1
    Pooling3D contract)."""

    def __init__(self, pool_size=(2, 2, 2), strides=None,
                 border_mode: str = "valid", input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        if border_mode != "valid":
            raise ValueError(
                "Pooling3D supports only border_mode='valid' (the "
                "reference's keras1 contract)")
        self.pool_size = tuple(pool_size)
        self.strides = (tuple(strides) if strides is not None
                        else self.pool_size)

    def _core_cls(self):
        raise NotImplementedError

    def build_core(self, input_shape):
        kt, kh, kw = self.pool_size
        dt, dh, dw = self.strides
        return self._core_cls()(kt, kw, kh, dt, dw, dh)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        (kt, kh, kw), (dt, dh, dw) = self.pool_size, self.strides
        return (c, (d - kt) // dt + 1, (h - kh) // dh + 1,
                (w - kw) // dw + 1)


class MaxPooling3D(_Pooling3D):
    def _core_cls(self):
        from bigdl_tpu_torch.nn.layers_extra import VolumetricMaxPooling

        return VolumetricMaxPooling


class AveragePooling3D(_Pooling3D):
    def _core_cls(self):
        from bigdl_tpu_torch.nn.layers_extra import VolumetricAveragePooling

        return VolumetricAveragePooling


class GlobalMaxPooling3D(KerasLayer):
    """(C, D, H, W) → (C,)."""

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.misc import Max

        return (_containers.Sequential()
                .add(Max(4, n_input_dims=4))
                .add(Max(3, n_input_dims=3))
                .add(Max(2, n_input_dims=2)))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class GlobalAveragePooling3D(KerasLayer):
    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.misc import Mean

        return (_containers.Sequential()
                .add(Mean(4, n_input_dims=4))
                .add(Mean(3, n_input_dims=3))
                .add(Mean(2, n_input_dims=2)))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class ZeroPadding1D(KerasLayer):
    """(steps, dim): ``padding`` zero time steps on each side."""

    def __init__(self, padding: int = 1, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.padding = padding

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.shape_ops import Padding

        return (_containers.Sequential()
                .add(Padding(1, -self.padding, 2))
                .add(Padding(1, self.padding, 2)))

    def compute_output_shape(self, input_shape):
        steps, dim = input_shape
        return (steps + 2 * self.padding, dim)


class ZeroPadding3D(KerasLayer):
    """(C, D, H, W): symmetric zero padding of the three spatial dims."""

    def __init__(self, padding=(1, 1, 1), input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.padding = tuple(padding)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import VolumetricZeroPadding

        pt, ph, pw = self.padding
        return VolumetricZeroPadding(pt, ph, pw)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        pt, ph, pw = self.padding
        return (c, d + 2 * pt, h + 2 * ph, w + 2 * pw)


class UpSampling1D(KerasLayer):
    def __init__(self, length: int = 2, input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.length = length

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import UpSampling1D as Core

        return Core(self.length)

    def compute_output_shape(self, input_shape):
        steps, dim = input_shape
        return (steps * self.length, dim)


class UpSampling3D(KerasLayer):
    def __init__(self, size=(2, 2, 2), input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        self.size = tuple(size)

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import UpSampling3D as Core

        return Core(self.size)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        ft, fh, fw = self.size
        return (c, d * ft, h * fh, w * fw)


class SpatialDropout3D(_IdentityShaped):
    def __init__(self, p: float = 0.5, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.p = p

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_more import SpatialDropout3D as Core

        return Core(self.p)


class Convolution3D(KerasLayer):
    """(C, D, H, W) input; border_mode 'valid' only (the reference's keras1
    Convolution3D contract)."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, subsample=(1, 1, 1),
                 border_mode: str = "valid", activation=None,
                 bias: bool = True, input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        if border_mode != "valid":
            raise ValueError(
                "Convolution3D supports only border_mode='valid' "
                "(the reference's keras1 contract)")
        self.nb_filter = nb_filter
        self.kernel = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.subsample = tuple(subsample)
        self.activation = activation
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import VolumetricConvolution

        kt, kh, kw = self.kernel
        dt, dh, dw = self.subsample
        return _maybe_activation(
            VolumetricConvolution(
                input_shape[0], self.nb_filter, kt, kw, kh, dt, dw, dh,
                with_bias=self.bias, **self._kw()),
            self.activation)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        (kt, kh, kw), (dt, dh, dw) = self.kernel, self.subsample
        return (self.nb_filter, (d - kt) // dt + 1, (h - kh) // dh + 1,
                (w - kw) // dw + 1)


class Deconvolution2D(KerasLayer):
    """Transposed convolution of (C, H, W) input (the reference's keras1
    Deconvolution2D over SpatialFullConvolution)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample=(1, 1), activation=None, bias: bool = True,
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.subsample = tuple(subsample)
        self.activation = activation
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.conv import SpatialFullConvolution

        return _maybe_activation(
            SpatialFullConvolution(
                input_shape[0], self.nb_filter, self.nb_col, self.nb_row,
                self.subsample[1], self.subsample[0],
                no_bias=not self.bias, **self._kw()),
            self.activation)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        sh, sw = self.subsample
        return (self.nb_filter, (h - 1) * sh + self.nb_row,
                (w - 1) * sw + self.nb_col)


class ConvLSTM2D(_KerasRecurrent):
    """Convolutional LSTM over (T, C, H, W) sequences (keras1 ConvLSTM2D
    over the ConvLSTMPeephole core), positional ``(nb_filter, nb_row,
    nb_col)`` as ``Convolution2D``; the core's kernel is square, so
    ``nb_row`` must equal ``nb_col``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 return_sequences: bool = False,
                 with_peephole: bool = True, input_shape=None,
                 **placement) -> None:
        if nb_row != nb_col:
            raise ValueError(
                f"ConvLSTM2D kernel must be square, got {nb_row}x{nb_col}")
        super().__init__(nb_filter, return_sequences, input_shape,
                         **placement)
        self.nb_filter = nb_filter
        self.nb_kernel = nb_row
        self.with_peephole = with_peephole

    def _cell(self, input_shape):
        from bigdl_tpu_torch.nn.recurrent import ConvLSTMPeephole

        t, c, h, w = input_shape
        return ConvLSTMPeephole(c, self.nb_filter, self.nb_kernel,
                                self.nb_kernel,
                                with_peephole=self.with_peephole,
                                **self._kw())

    def compute_output_shape(self, input_shape):
        t, c, h, w = input_shape
        if self.return_sequences:
            return (t, self.nb_filter, h, w)
        return (self.nb_filter, h, w)


class AtrousConvolution2D(KerasLayer):
    """Dilated 2-D convolution of CHW input (keras1 AtrousConvolution2D
    over SpatialDilatedConvolution; border_mode 'valid' only, the keras1
    contract)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample=(1, 1), atrous_rate=(1, 1), activation=None,
                 bias: bool = True, border_mode: str = "valid",
                 input_shape=None, **placement) -> None:
        super().__init__(input_shape, **placement)
        if border_mode != "valid":
            raise ValueError("AtrousConvolution2D supports only "
                             "border_mode='valid' (keras1 contract)")
        self.nb_filter = nb_filter
        self.nb_row = nb_row
        self.nb_col = nb_col
        self.subsample = tuple(subsample)
        self.atrous_rate = tuple(atrous_rate)
        self.activation = activation
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import SpatialDilatedConvolution

        return _maybe_activation(
            SpatialDilatedConvolution(
                input_shape[0], self.nb_filter, self.nb_col, self.nb_row,
                self.subsample[1], self.subsample[0], 0, 0,
                self.atrous_rate[1], self.atrous_rate[0],
                with_bias=self.bias, **self._kw()),
            self.activation)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        (sh, sw), (rh, rw) = self.subsample, self.atrous_rate
        eff_h = (self.nb_row - 1) * rh + 1
        eff_w = (self.nb_col - 1) * rw + 1
        return (self.nb_filter, (h - eff_h) // sh + 1, (w - eff_w) // sw + 1)


class AtrousConvolution1D(KerasLayer):
    """Dilated 1-D convolution of (steps, dim) input (keras1
    AtrousConvolution1D; 'valid' only), run as a width-1 dilated 2-D
    convolution as the reference does."""

    def __init__(self, nb_filter: int, filter_length: int,
                 subsample_length: int = 1, atrous_rate: int = 1,
                 activation=None, bias: bool = True,
                 border_mode: str = "valid", input_shape=None,
                 **placement) -> None:
        super().__init__(input_shape, **placement)
        if border_mode != "valid":
            raise ValueError("AtrousConvolution1D supports only "
                             "border_mode='valid' (keras1 contract)")
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.subsample_length = subsample_length
        self.atrous_rate = atrous_rate
        self.activation = activation
        self.bias = bias

    def build_core(self, input_shape):
        from bigdl_tpu_torch.nn.layers_extra import SpatialDilatedConvolution
        from bigdl_tpu_torch.nn.shape_ops import Squeeze, Transpose, Unsqueeze

        steps, dim = input_shape
        conv = SpatialDilatedConvolution(
            dim, self.nb_filter, 1, self.filter_length,
            1, self.subsample_length, 0, 0, 1, self.atrous_rate,
            with_bias=self.bias, **self._kw())
        # (B, steps, dim) -> (B, dim, steps, 1) -> conv -> back
        core = (_containers.Sequential()
                .add(Transpose([(2, 3)]))           # (B, dim, steps)
                .add(Unsqueeze(4))                  # (B, dim, steps, 1)
                .add(conv)
                .add(Squeeze(4))                    # (B, F, steps')
                .add(Transpose([(2, 3)])))          # (B, steps', F)
        return _maybe_activation(core, self.activation)

    def compute_output_shape(self, input_shape):
        steps, dim = input_shape
        eff = (self.filter_length - 1) * self.atrous_rate + 1
        return ((steps - eff) // self.subsample_length + 1, self.nb_filter)
