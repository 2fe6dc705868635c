"""Structured module serialization — ``save_module`` / ``load_module``
(``bigdl_tpu/utils/serializer.py``).

The reference's versioned, reflection-driven module format, distinct from
the pickle of ``Module.save``. The file is a zip holding

* ``spec.json`` — the magic, the format version and a flat object table
  (so a module shared by two containers, or a Graph's nodes, keep their
  identity) of port classes with their JSON-encoded attributes, and a
  tensor table (so aliased tensors stay one tensor);
* ``arrays.npz`` — every tensor's and array's data, referenced by index.

Loading runs no code of the file's choosing: it instantiates only
classes defined at module level in a ``bigdl_tpu_torch`` module, the
class's own ``__module__`` and ``__qualname__`` being the names the file
gives (so a foreign class that a port module imports is refused), with
``cls.__new__`` plus the attribute restore, through ``__setstate__``
where the class has one (``nn.Module``'s fills what an older torch did
not save); a dtype name must name a ``torch.dtype``.

What an ``nn.Module``'s ``__dict__`` holds is encoded too: ordered dicts
(``_parameters``, ``_buffers``, ``_modules``, the hook dicts), sets
(``_non_persistent_buffers_set``), ``torch.dtype`` and ``torch.device``.
A tensor or ``nn.Parameter`` is stored as an array with its dtype and
``requires_grad``; bf16 as its 16-bit pattern (numpy has no bf16). A
``torch.Generator`` is stored as its device, seed and state, and comes
back with that state on a device of the same type, else seeded with its
seed. A callable (a lambda layer's function, a hook) is refused with the
class's name. Everything loads onto ``device`` (default ``cuda``):
tensors, generators and every saved ``torch.device``.

The JAX package writes ``bigdl_tpu.module`` files of its own classes; the
port refuses them (its classes and attribute states differ), and weights
cross with :func:`bigdl_tpu_torch.models.transformer.load_jax_params` or
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree`.
"""

from __future__ import annotations

import collections
import functools
import importlib
import io
import json
import os
import tempfile
import types
import zipfile
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

MAGIC = "bigdl_tpu_torch.module"
FORMAT_VERSION = 1

_ALLOWED_ROOT = "bigdl_tpu_torch"
_JAX_MAGIC = "bigdl_tpu.module"
#: code, which the format refuses to store
_CODE = (types.FunctionType, types.BuiltinFunctionType, types.MethodType,
         functools.partial, type)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class _Encoder:
    def __init__(self) -> None:
        self.objs: List[Dict[str, Any]] = []
        self.obj_ids: Dict[int, int] = {}
        self.tensors: List[Dict[str, Any]] = []
        self.tensor_ids: Dict[int, int] = {}
        self.arrays: List[np.ndarray] = []
        self.array_ids: Dict[int, int] = {}
        # the originals, so the ids above stay valid while encoding
        self._refs: List[Any] = []
        self._where: List[str] = []      # the classes being encoded

    def _array(self, a: np.ndarray) -> int:
        self.arrays.append(np.ascontiguousarray(a))
        return len(self.arrays) - 1

    def encode(self, x: Any) -> Any:
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        if isinstance(x, np.generic):  # numpy scalar
            return {"__npscalar__": [x.dtype.str, x.item()]}
        if isinstance(x, torch.Tensor):
            return {"__tensor__": self._encode_tensor(x)}
        if isinstance(x, np.ndarray):
            idx = self.array_ids.get(id(x))
            if idx is None:
                idx = self.array_ids[id(x)] = self._array(x)
                self._refs.append(x)
            return {"__array__": idx}
        if isinstance(x, torch.dtype):
            return {"__dtype__": _dtype_name(x)}
        if isinstance(x, torch.device):
            return {"__device__": str(x)}
        if isinstance(x, torch.Generator):
            return {"__generator__": {
                "device": x.device.type, "seed": x.initial_seed(),
                "state": self._array(x.get_state().numpy())}}
        if isinstance(x, (list, tuple)):
            tag = "__tuple__" if isinstance(x, tuple) else "__list__"
            return {tag: [self.encode(v) for v in x]}
        if isinstance(x, (set, frozenset)):
            tag = "__frozenset__" if isinstance(x, frozenset) else "__set__"
            return {tag: [self.encode(v) for v in sorted(x, key=repr)]}
        if isinstance(x, dict):
            tag = ("__odict__" if isinstance(x, collections.OrderedDict)
                   else "__map__")
            return {tag: [[self.encode(k), self.encode(v)]
                          for k, v in x.items()]}
        cls = type(x)
        where = f" (in {self._where[-1]})" if self._where else ""
        if isinstance(x, _CODE):
            raise TypeError(
                f"save_module: {where.strip(' ()') or 'the module'} holds "
                f"the callable {getattr(x, '__qualname__', cls.__name__)}, "
                "which the format does not store (it holds no code)")
        if cls.__module__.split(".")[0] == _ALLOWED_ROOT:
            if "." in cls.__qualname__:
                raise TypeError(
                    f"save_module: {cls.__module__}.{cls.__qualname__}"
                    f"{where} is a class local to a function, which "
                    "load_module could not rebuild")
            return {"__obj__": self._encode_obj(x)}
        raise TypeError(
            f"save_module: cannot serialize {cls.__module__}."
            f"{cls.__qualname__}{where}; only JSON scalars, arrays, tensors, "
            "containers and bigdl_tpu_torch objects are supported")

    def _encode_tensor(self, t: torch.Tensor) -> int:
        tid = self.tensor_ids.get(id(t))
        if tid is not None:
            return tid
        data = t.detach().cpu()
        if data.dtype == torch.bfloat16:
            arr = data.view(torch.int16).numpy()   # the bits
        else:
            arr = data.numpy()
        self.tensors.append({
            "array": self._array(arr), "dtype": _dtype_name(t.dtype),
            "parameter": isinstance(t, nn.Parameter),
            "requires_grad": bool(t.requires_grad)})
        self.tensor_ids[id(t)] = tid = len(self.tensors) - 1
        self._refs.append(t)
        return tid

    def _encode_obj(self, x: Any) -> int:
        oid = self.obj_ids.get(id(x))
        if oid is not None:
            return oid
        oid = len(self.objs)
        self.obj_ids[id(x)] = oid
        self._refs.append(x)
        cls = type(x)
        entry: Dict[str, Any] = {"class": f"{cls.__module__}:{cls.__qualname__}"}
        self.objs.append(entry)  # reserve the slot: attrs may refer back
        state = x.__getstate__() if hasattr(x, "__getstate__") else None
        if state is None:  # object.__getstate__ returns None for no state
            state = dict(getattr(x, "__dict__", {}))
        elif isinstance(state, tuple) and len(state) == 2:
            # object.__getstate__ of a __slots__ class: (dict, slots)
            d, slots = state
            state = dict(d or {})
            state.update(slots or {})
        if not isinstance(state, dict):
            raise TypeError(
                f"save_module: {cls.__qualname__}.__getstate__ returned "
                f"{type(state).__name__}; only dict state is supported")
        self._where.append(cls.__qualname__)
        try:
            entry["attrs"] = {k: self.encode(v) for k, v in state.items()}
        finally:
            self._where.pop()
        return oid


class _Decoder:
    def __init__(self, payload: Dict[str, Any], arrays: Dict[str, np.ndarray],
                 device: torch.device):
        self.spec_objs = payload["objects"]
        self.spec_tensors = payload["tensors"]
        self.arrays = arrays
        self.device = device
        self.built: Dict[int, Any] = {}
        self.built_tensors: Dict[int, torch.Tensor] = {}

    def _arr(self, idx: int) -> np.ndarray:
        return self.arrays[f"a{idx}"]

    def decode(self, x: Any) -> Any:
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        if isinstance(x, dict) and len(x) == 1:
            (tag, v), = x.items()
            if tag == "__npscalar__":
                return np.dtype(v[0]).type(v[1])
            if tag == "__array__":
                return self._arr(v)
            if tag == "__tensor__":
                return self._decode_tensor(v)
            if tag == "__dtype__":
                return _torch_dtype(v)
            if tag == "__device__":
                return self.device
            if tag == "__generator__":
                g = torch.Generator(device=self.device)
                if v["device"] == self.device.type:
                    g.set_state(torch.from_numpy(self._arr(v["state"])))
                else:
                    g.manual_seed(v["seed"])
                return g
            if tag == "__list__":
                return [self.decode(e) for e in v]
            if tag == "__tuple__":
                return tuple(self.decode(e) for e in v)
            if tag == "__set__":
                return {self.decode(e) for e in v}
            if tag == "__frozenset__":
                return frozenset(self.decode(e) for e in v)
            if tag in ("__map__", "__odict__"):
                d = collections.OrderedDict() if tag == "__odict__" else {}
                for k, e in v:
                    d[self.decode(k)] = self.decode(e)
                return d
            if tag == "__obj__":
                return self._decode_obj(v)
        raise ValueError(f"load_module: malformed spec node {x!r}")

    def _decode_tensor(self, tid: int) -> torch.Tensor:
        if tid in self.built_tensors:
            return self.built_tensors[tid]
        spec = self.spec_tensors[tid]
        arr = self._arr(spec["array"])
        t = torch.from_numpy(np.array(arr))
        dtype = _torch_dtype(spec["dtype"])
        t = t.view(dtype) if dtype == torch.bfloat16 else t.to(dtype)
        t = t.to(self.device)
        if spec["parameter"]:
            t = nn.Parameter(t, requires_grad=spec["requires_grad"])
        elif spec["requires_grad"]:
            t.requires_grad_()
        self.built_tensors[tid] = t
        return t

    def _decode_obj(self, oid: int) -> Any:
        if oid in self.built:
            return self.built[oid]
        entry = self.spec_objs[oid]
        mod_name, _, qual = entry["class"].partition(":")
        if mod_name.split(".")[0] != _ALLOWED_ROOT or "." in qual:
            raise ValueError(
                f"load_module: refusing to instantiate {entry['class']!r}: "
                f"a {MAGIC} file holds only module-level classes of "
                f"{_ALLOWED_ROOT}")
        cls = getattr(importlib.import_module(mod_name), qual, None)
        if not (isinstance(cls, type) and cls.__module__ == mod_name
                and cls.__qualname__ == qual):
            raise ValueError(
                f"load_module: {entry['class']!r} is not a class of "
                f"{_ALLOWED_ROOT} defined there")
        obj = cls.__new__(cls)
        self.built[oid] = obj  # register before attrs: back-references
        attrs = {k: self.decode(v) for k, v in entry["attrs"].items()}
        if hasattr(obj, "__setstate__"):
            obj.__setstate__(attrs)
        else:
            for k, v in attrs.items():  # object.__setattr__ covers __slots__
                object.__setattr__(obj, k, v)
        return obj


def _torch_dtype(name) -> torch.dtype:
    dtype = getattr(torch, name, None) if isinstance(name, str) else None
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"load_module: {name!r} is not a torch dtype")
    return dtype


def save_module(module, path: str, over_write: bool = False) -> None:
    """Write ``module`` (topology, parameters, buffers; no gradients) to
    ``path`` atomically, creating its directory."""
    if os.path.exists(path) and not over_write:
        raise FileExistsError(f"{path} exists (pass over_write=True)")
    enc = _Encoder()
    root = enc.encode(module)
    payload = {"magic": MAGIC, "version": FORMAT_VERSION, "root": root,
               "objects": enc.objs, "tensors": enc.tensors}
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": a for i, a in enumerate(enc.arrays)})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as z:
                z.writestr("spec.json", json.dumps(payload))
                # stored: deflating float weights costs seconds, gains little
                z.writestr("arrays.npz", buf.getvalue(),
                           compress_type=zipfile.ZIP_STORED)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_module(path: str, device=None):
    """A module written by :func:`save_module`, every tensor on
    ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``)."""
    from bigdl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        payload = json.loads(z.read("spec.json"))
        with np.load(io.BytesIO(z.read("arrays.npz"))) as npz:
            arrays = dict(npz)
    magic = payload.get("magic")
    if magic == _JAX_MAGIC:
        raise ValueError(
            f"{path}: a {_JAX_MAGIC} file of the JAX package; the port reads "
            f"{MAGIC} files (carry JAX weights across with load_jax_params "
            "or load_jax_tree)")
    if magic != MAGIC:
        raise ValueError(f"{path}: not a {MAGIC} file (magic {magic!r})")
    if payload.get("version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"{path}: {MAGIC} format version {payload['version']} is newer "
            f"than the supported {FORMAT_VERSION}")
    return _Decoder(payload, arrays, dev).decode(payload["root"])
