"""ModelBroadcast — one model's weights on every rank
(``bigdl_tpu/parallel/broadcast.py:21-47``).

The reference broadcasts the model once per job; the JAX package places
its params replicated over the mesh. The port's ranks each build their own
model, so ``broadcast(mesh, model)`` overwrites every rank's parameters and
buffers with rank 0's, one broadcast per dtype over the mesh's group (the
tensors of a dtype packed into one flat buffer and unpacked after). Every
rank then starts from rank 0's weights, whatever its own initialisation
drew.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.parallel.all_reduce import broadcast_from


def broadcast_tensors(tensors, group=None, src_rank: int = 0) -> None:
    """Overwrite ``tensors`` in place with the group's ``src_rank``
    values: one broadcast per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            broadcast_from(flat, src_rank, group)
            for t, v in zip(ts, torch.split(flat, [t.numel() for t in ts])):
                t.copy_(v.view_as(t))


class ModelBroadcast:
    """``ModelBroadcast().broadcast(mesh, model)``; ``value()`` is the
    broadcast params (``{name: parameter}``), ``model()`` the module."""

    def __init__(self) -> None:
        self._params = None
        self._model = None

    def broadcast(self, mesh, model) -> "ModelBroadcast":
        group = mesh.get_group(0) if mesh is not None else None
        broadcast_tensors(list(model.parameters()) + list(model.buffers()),
                          group)
        self._params = dict(model.named_parameters())
        self._model = model
        return self

    def value(self):
        if self._params is None:
            raise RuntimeError("broadcast() first")
        return self._params

    def model(self):
        return self._model
