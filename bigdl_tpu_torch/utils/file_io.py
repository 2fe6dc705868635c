"""File — snapshot save/load for modules, optim methods and raw objects
(``bigdl_tpu/utils/file_io.py``).

``pickle`` for the object structure, with every tensor moved to host
memory as it is written (a card's tensors become CPU tensors, shared
tensors stay shared), so a snapshot loads on a machine without a card;
the caller places what it loads (``Module.load(path, device=)``).
``torch.Generator`` objects are dropped (written as ``None``): a
snapshot carries weights, not the generator that made them. The write is
atomic (a temporary file in the target's directory, then a rename), so
an interrupted checkpoint never leaves a torn file.

``torch.load`` is not used: its ``weights_only`` default refuses module
objects. The two packages cannot read each other's snapshots, since each
pickles its own classes; JAX weights cross with
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree`. Load only files
this program wrote: unpickling runs code.
"""

from __future__ import annotations

import io
import os
import pickle
import tempfile
from typing import Any

import torch


def _none():
    return None


def _host_parameter(data: torch.Tensor, requires_grad: bool):
    return torch.nn.Parameter(data, requires_grad=requires_grad)


def _host_tensor(data: torch.Tensor) -> torch.Tensor:
    return data


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Generator):
            return _none, ()
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            host = obj.detach().cpu()
            if isinstance(obj, torch.nn.Parameter):
                return _host_parameter, (host, obj.requires_grad)
            return _host_tensor, (host,)
        return NotImplemented


class _File:
    def save(self, obj: Any, path: str, over_write: bool = False) -> None:
        if os.path.exists(path) and not over_write:
            raise FileExistsError(
                f"{path} already exists; pass over_write=True to replace it")
        buf = io.BytesIO()
        _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(buf.getbuffer())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self, path: str) -> Any:
        with open(path, "rb") as f:
            return pickle.load(f)


File = _File()
