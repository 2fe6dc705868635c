"""AbstractModule — the port's layer base (``bigdl_tpu/nn/module.py:61``).

The JAX package keeps every layer as a pure ``init_params``/``apply``
pair over a params pytree, with a stateful facade around it. The port
keeps PyTorch's idiom instead: a layer is an ``nn.Module`` whose
learnable tensors are ``nn.Parameter``s, created at construction on an
explicit device from an explicit ``torch.Generator``, and ``forward`` is
the layer's computation. What carries over from the JAX base:

* a per-instance ``name`` (class name + a process counter) with
  ``set_name``/``get_name``; containers key their children by it when
  they are added, so ``set_name`` must come before ``add`` (a later
  rename raises instead of leaving a stale key);
* the facade (``:292-341``): ``update_output`` runs the forward and keeps
  ``output``; ``backward(input, grad_output)`` re-runs the forward under
  autograd and takes the vector-Jacobian product, as the JAX facade's
  ``jax.vjp`` does, keeping ``grad_input`` and ADDING each parameter's
  gradient into its ``.grad`` (the JAX ``grad_params``);
  ``update_grad_input``/``acc_grad_parameters`` alias it;
  ``zero_grad_parameters``, ``get_parameters``, ``n_parameters``,
  ``get_weights``/``set_weights``;
* ``evaluate()`` (eval mode) and ``evaluate(dataset, methods,
  batch_size)``, ``predict``/``predict_class`` through
  :mod:`bigdl_tpu_torch.optim.evaluator`;
* ``save``/``load`` (:mod:`bigdl_tpu_torch.utils.file_io`);
* ``freeze``/``unfreeze``/``frozen_flag``/``is_frozen`` (``:199-252``,
  the reference's transfer-learning freeze): a tri-state flag per module
  (``None`` inherits the parent's, ``True``/``False`` are explicit, so an
  explicit ``False`` overrides a frozen ancestor and ``model.freeze();
  model.unfreeze("head")`` trains the head). The train steps read it
  through :func:`bigdl_tpu_torch.optim.train_step.frozen_mask_tree`;
* ``module.inputs(...)`` (``bigdl_tpu/nn/graph.py:38-43``), which
  attaches the module to a :class:`~bigdl_tpu_torch.nn.graph.Graph` node;
* the ``rng`` of the JAX ``apply``: stochastic layers (``Dropout``, a
  recurrent cell's variational dropout) draw from the
  ``torch.Generator`` that :func:`use_rng` makes current (the train step
  does, with the step's generator) and are the identity when none is,
  as JAX's are with ``rng=None``; they never draw from torch's global
  generator. The facade passes no generator.

Names the JAX facade shares with ``nn.Module`` keep PyTorch's meaning,
because PyTorch's optimizers and utilities call them:

* ``parameters()`` yields the ``nn.Parameter``s; the JAX ``(weights,
  grads)`` pair is ``get_parameters()`` (flattened) or ``get_weights()``;
* ``apply(fn)`` applies ``fn`` to every submodule; the JAX pure
  ``apply(params, input, ...)`` is ``torch.func.functional_call``, as
  :func:`bigdl_tpu_torch.optim.train_step.make_eval_step` uses it;
* ``training`` is a bool attribute; the JAX ``training()`` method is
  ``train()``;
* the JAX ``state`` pytree is the module's buffers
  (``named_buffers()``);
* ``forward`` computes and keeps nothing; the JAX ``forward`` (which
  keeps ``output``) is ``update_output``.

Leaf order: ``get_parameters``/``get_weights``/``set_weights`` walk the
parameters in the JAX tree's leaf order, keys sorted at every level (the
parameter name split at its dots), so the flat vectors equal JAX's.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

_instance_counter = itertools.count()
_rng: contextvars.ContextVar = contextvars.ContextVar("bigdl_tpu_torch_rng",
                                                     default=None)


@contextlib.contextmanager
def use_rng(generator: Optional[torch.Generator]):
    """Make ``generator`` the one stochastic layers draw from inside the
    ``with`` block (``None``: they draw nothing)."""
    token = _rng.set(generator)
    try:
        yield generator
    finally:
        _rng.reset(token)


def current_rng() -> Optional[torch.Generator]:
    """The generator :func:`use_rng` made current, or ``None``."""
    return _rng.get()


class AbstractModule(nn.Module):
    """Base class for every layer and container of the port."""

    def __init__(self) -> None:
        super().__init__()
        self.name: str = f"{type(self).__name__}{next(_instance_counter)}"
        self.output: Any = None
        self.grad_input: Any = None
        # the key a container registered this module under (set by add)
        self._container_key = None

    # -- naming / modes ----------------------------------------------------

    def set_name(self, name: str) -> "AbstractModule":
        if self._container_key is not None and name != self.name:
            raise ValueError(
                f"set_name({name!r}) on {self.name!r} after it was added to "
                f"a container under {self._container_key!r}: call set_name "
                "before add, as the container keys its children by name")
        self.name = name
        return self

    def get_name(self) -> str:
        return self.name

    def evaluate(self, dataset=None, methods=None, batch_size: int = 32):
        """No dataset: switch to eval mode (the reference's
        ``evaluate()``). With a dataset and ValidationMethods: run batched
        evaluation and return the results (``Evaluator.test``)."""
        if dataset is not None:
            from bigdl_tpu_torch.optim.evaluator import Evaluator

            return Evaluator(self).test(dataset, methods or [], batch_size)
        self.eval()
        return self

    def inputs(self, *nodes):
        """Attach this module to the graph after ``nodes`` and return its
        :class:`~bigdl_tpu_torch.nn.graph.ModuleNode`."""
        from bigdl_tpu_torch.nn.graph import ModuleNode

        return ModuleNode(self, nodes)

    # -- freezing (reference Graph.freeze/unfreeze: transfer learning) ----

    def freeze(self, *names: str) -> "AbstractModule":
        """Stop training this module (no names) or the named sub-modules:
        the train steps zero their gradients and restore their weights
        bit for bit after every optimizer update. Optimizer slots of
        frozen leaves still step with zero gradients (momentum decays);
        only the WEIGHTS are guaranteed untouched."""
        self._set_frozen(True, names)
        return self

    def unfreeze(self, *names: str) -> "AbstractModule":
        """With names: explicitly unfreeze those sub-modules (overriding
        frozen ancestors). Without names: clear EVERY freeze flag in the
        whole tree."""
        if not names:
            for m in self.modules():
                m._frozen = None
            return self
        self._set_frozen(False, names)
        return self

    def _set_frozen(self, value, names) -> None:
        if not names:
            self._frozen = value
            return
        found = set()
        for m in self.modules():
            if getattr(m, "name", None) in names:
                m._frozen = value
                found.add(m.name)
        missing = set(names) - found
        if missing:
            raise ValueError(f"freeze/unfreeze: no sub-module named "
                             f"{sorted(missing)}")

    def frozen_flag(self):
        """None (inherit) / True / False — see :meth:`freeze`."""
        return getattr(self, "_frozen", None)

    def is_frozen(self) -> bool:
        return bool(getattr(self, "_frozen", None))

    # -- facade: parameters ------------------------------------------------

    def _jax_ordered(self) -> List[Tuple[str, nn.Parameter]]:
        return sorted(self.named_parameters(),
                      key=lambda kv: tuple(kv[0].split(".")))

    def _facade_device(self) -> torch.device:
        for t in itertools.chain(self.parameters(), self.buffers()):
            return t.device
        return torch.device("cpu")

    def get_parameters(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One flattened (weight, grad) vector pair (reference
        ``getParameters``); a parameter with no gradient yet counts as
        zeros."""
        ps = [p for _, p in self._jax_ordered()]
        if not ps:
            z = torch.zeros(0, device=self._facade_device())
            return z, z.clone()
        flat_w = torch.cat([p.detach().reshape(-1) for p in ps])
        flat_g = torch.cat([(p.grad if p.grad is not None
                             else torch.zeros_like(p)).reshape(-1)
                            for p in ps])
        return flat_w, flat_g

    def zero_grad_parameters(self) -> None:
        for p in self.parameters():
            p.grad = torch.zeros_like(p)

    def n_parameters(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def get_weights(self) -> List[np.ndarray]:
        """The weights as numpy arrays in the JAX leaf order (pyspark
        ``get_weights``)."""
        return [p.detach().cpu().numpy() for _, p in self._jax_ordered()]

    def set_weights(self, weights) -> "AbstractModule":
        """Assign weights from a list in ``get_weights`` order (pyspark
        ``set_weights``)."""
        named = self._jax_ordered()
        if len(weights) != len(named):
            raise ValueError(f"set_weights got {len(weights)} arrays for "
                             f"{len(named)} parameter leaves")
        with torch.no_grad():
            for (k, p), w in zip(named, weights):
                w = torch.as_tensor(np.asarray(w))
                if tuple(w.shape) != tuple(p.shape):
                    raise ValueError(f"set_weights shape mismatch at {k}: "
                                     f"{tuple(w.shape)} vs {tuple(p.shape)}")
                p.copy_(w.to(p.dtype))
        return self

    # -- facade: forward / backward ----------------------------------------

    def _activity(self, x):
        """Host arrays (or lists of them) → tensors on the module's
        device."""
        from bigdl_tpu_torch.optim.evaluator import to_device

        return to_device(x, self._facade_device())

    def update_output(self, input: Any) -> Any:
        """The JAX facade's ``forward``: compute and keep ``output``."""
        self.output = self(self._activity(input))
        return self.output

    def backward(self, input: Any, grad_output: Any) -> Any:
        """gradInput = d(loss)/d(input) for ``grad_output`` = d(loss)/d(out);
        also ADDS each parameter's gradient into its ``.grad`` (reference
        ``updateGradInput`` + ``accGradParameters``, one vjp). The forward
        is re-run on copies of the buffers, so a training-mode BatchNorm's
        running statistics do not move, as the JAX facade discards the
        re-run's state."""
        from torch.func import functional_call

        x = self._activity(input)
        g = self._activity(grad_output)
        named = dict(self.named_parameters())
        leaves = {k: p.detach().requires_grad_() for k, p in named.items()}
        buffers = {k: b.clone() for k, b in self.named_buffers()}
        xs = x if isinstance(x, list) else [x]
        xs = [v.detach().requires_grad_() if v.is_floating_point() else v
              for v in xs]
        diff_x = [v for v in xs if v.requires_grad]
        with torch.enable_grad():
            out = functional_call(self, {**leaves, **buffers},
                                  (xs if isinstance(x, list) else xs[0],))
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            gs = g if isinstance(g, list) else [g]
            grads = torch.autograd.grad(
                outs, list(leaves.values()) + diff_x,
                grad_outputs=[v.to(o.dtype) for v, o in zip(gs, outs)],
                allow_unused=True)
        with torch.no_grad():
            for (k, p), gp in zip(named.items(), grads[:len(leaves)]):
                gp = torch.zeros_like(p) if gp is None else gp
                p.grad = gp if p.grad is None else p.grad + gp
        gx = [torch.zeros_like(v) if gv is None else gv
              for v, gv in zip(diff_x, grads[len(leaves):])]
        self.grad_input = gx if isinstance(x, list) else (
            gx[0] if gx else None)
        return self.grad_input

    def update_grad_input(self, input: Any, grad_output: Any) -> Any:
        return self.backward(input, grad_output)

    def acc_grad_parameters(self, input: Any, grad_output: Any) -> None:
        self.backward(input, grad_output)

    # -- evaluation / prediction -------------------------------------------

    def predict(self, inputs, batch_size: int = 32):
        """Batched prediction in eval mode (``Predictor.predict``); a
        training-mode module returns to training mode afterwards."""
        from bigdl_tpu_torch.optim.evaluator import Predictor

        was_training = self.training
        try:
            return Predictor(self).predict(inputs, batch_size)
        finally:
            if was_training:
                self.train()

    def predict_image(self, image_frame, output_layer=None,
                      share_buffer: bool = False,
                      batch_per_partition: int = 4,
                      predict_key: str = "predict",
                      feature_key: str = "floats"):
        """Reference pyspark ``model.predict_image`` (``Predictor.
        predictImage``): every ImageFeature's tensor under ``feature_key``
        (``MatToTensor``'s output) through :meth:`predict` in batches of
        ``batch_per_partition``, each output attached to its feature under
        ``predict_key`` (a list per feature for a multi-output model).
        Returns the same frame. ``share_buffer`` is accepted and ignored;
        ``output_layer`` is refused (build a graph ending at that node)."""
        if output_layer is not None:
            raise NotImplementedError(
                "predict_image(output_layer=...) is not supported — build "
                "a Graph ending at that node and predict with it")
        feats = image_frame.features
        missing = [i for i, f in enumerate(feats) if feature_key not in f]
        if missing:
            raise ValueError(
                f"predict_image: features {missing[:5]} have no "
                f"{feature_key!r} tensor — run MatToTensor (or pass "
                "feature_key=) first")
        x = np.stack([np.asarray(f[feature_key], np.float32) for f in feats])
        out = self.predict(x, batch_size=max(1, int(batch_per_partition)))
        if isinstance(out, (list, tuple)):   # a multi-output graph
            for j, f in enumerate(feats):
                f[predict_key] = [np.asarray(o)[j] for o in out]
        else:
            out = np.asarray(out)
            for j, f in enumerate(feats):
                f[predict_key] = out[j]
        return image_frame

    def predict_class(self, inputs, batch_size: int = 32) -> np.ndarray:
        """1-based predicted classes (``Predictor.predict_class``)."""
        from bigdl_tpu_torch.optim.evaluator import Predictor

        was_training = self.training
        try:
            return Predictor(self).predict_class(inputs, batch_size)
        finally:
            if was_training:
                self.train()

    def quantize(self, scheme: str = "dynamic") -> "AbstractModule":
        """int8 inference model of this trained model, in place
        (reference ``module.quantize()``; :class:`~bigdl_tpu_torch.nn.
        quantized.Quantizer`); ``scheme="weight_only"`` keeps activations
        bf16 (the serving mode)."""
        from bigdl_tpu_torch.nn.quantized import Quantizer

        return Quantizer.quantize(self, scheme=scheme)

    # -- persistence -------------------------------------------------------

    def save(self, path: str, over_write: bool = False) -> "AbstractModule":
        """Pickle ``{"module", "params", "state"}`` to ``path`` atomically,
        every tensor in host memory (:mod:`bigdl_tpu_torch.utils.file_io`);
        the JAX package cannot read it, nor the port a JAX snapshot
        (each pickles its own classes)."""
        from bigdl_tpu_torch.utils.file_io import File

        File.save({"module": self,
                   "params": dict(self.named_parameters()),
                   "state": dict(self.named_buffers())},
                  path, over_write=over_write)
        return self

    @staticmethod
    def load(path: str, device=None) -> "AbstractModule":
        """A :meth:`save` snapshot (or an optimizer checkpoint's ``model``
        file) with its ``params``/``state`` loaded, placed on
        ``device`` (default ``cuda``; raises without a card unless
        ``device="cpu"``)."""
        from bigdl_tpu_torch.utils.device import resolve_device
        from bigdl_tpu_torch.utils.file_io import File

        dev = resolve_device(device)
        blob = File.load(path)
        m: AbstractModule = blob["module"]
        with torch.no_grad():
            for kind, named in (("params", dict(m.named_parameters())),
                                ("state", dict(m.named_buffers()))):
                tree = blob.get(kind) or {}
                if set(tree) != set(named):
                    raise ValueError(
                        f"{path}: {kind} keys {sorted(tree)} do not match "
                        f"the module's {sorted(named)}")
                for k, t in named.items():
                    t.copy_(tree[k])
        return m.to(dev)

    def __getstate__(self):
        d = dict(self.__dict__)
        # activations are not part of a snapshot
        d["output"] = None
        d["grad_input"] = None
        return d


class TensorModule(AbstractModule):
    """Marker base for modules whose input and output are one tensor."""


class Identity(TensorModule):
    def forward(self, x):
        return x


class Echo(TensorModule):
    """Debug layer: prints its name and the input's shape at every
    forward and returns the input (``module.py:529``; under JAX's jit it
    prints once, at the trace)."""

    def forward(self, x):
        shape = getattr(x, "shape", None)
        print(f"[Echo {self.name}] shape="
              f"{None if shape is None else tuple(shape)}")
        return x


def new_param(shape, device, init) -> nn.Parameter:
    """An f32 parameter of ``shape`` on ``device``, filled in place by
    ``init(tensor)`` under ``torch.no_grad()``."""
    p = torch.empty(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        init(p)
    return nn.Parameter(p)
