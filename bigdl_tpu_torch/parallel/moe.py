"""Expert parallelism: a mixture of experts with all-to-all dispatch
(``bigdl_tpu/parallel/moe.py``).

GShard/Switch dense dispatch: gating, top-k selection and capacity
masking are dense ``(tokens, experts, capacity)`` one-hot tensors
(:func:`top_k_gating`: positions within an expert in token order,
overflow dropped, the surviving top-k gates renormalized per token). The
slabs bound for expert e travel to the rank that holds e with
``all_to_all_single`` (:func:`bigdl_tpu_torch.parallel.axis.all_to_all`,
whose backward is the same exchange), the rank's experts run at once,
and a second all-to-all brings the results home.

One difference from JAX: ``expert_fn`` takes the rank's experts' STACKED
parameters (each leaf ``(E_local, ...)``) and their ``(E_local, N, d)``
slabs, and runs every expert at once; JAX ``vmap``s a one-expert
function. :func:`mlp_expert` is one batched matmul per weight.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.parallel import axis as _axis


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: all zeros where ``idx`` is outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k_gating(logits, k: int, capacity: int):
    """``(dispatch, combine)``, each (T, E, C), from router logits (T, E)
    (``:26``): ``dispatch`` the 0/1 routing, ``combine`` the renormalized
    gate on the same support."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    masked = probs
    dispatch_e = torch.zeros_like(probs)
    for _ in range(k):                    # k is small and static
        onehot = _one_hot(torch.argmax(masked, dim=-1), E, probs.dtype)
        dispatch_e = dispatch_e + onehot
        masked = masked * (1.0 - onehot)
    # each token's position in its expert's queue, in token order
    pos = torch.cumsum(dispatch_e, dim=0) - dispatch_e
    keep = dispatch_e * (pos < capacity)
    pos_onehot = _one_hot(pos.to(torch.int32), capacity, probs.dtype)
    dispatch = keep[..., None] * pos_onehot
    gates = probs * keep
    denom = gates.sum(-1, keepdim=True).clamp_min(1e-9)
    combine = (gates / denom)[..., None] * pos_onehot
    return dispatch, combine


def moe_layer(x, router_w, expert_params, expert_fn: Callable,
              axis_name: str = "expert", top_k: int = 1,
              capacity_factor: float = 1.25,
              capacity: Optional[int] = None):
    """Expert-parallel MoE block (``:63``) over the mesh axis
    ``axis_name``: ``x`` this rank's tokens (T_local, d), ``router_w``
    the replicated router (d, E), ``expert_params`` this rank's experts'
    parameters, each leaf (E_local, ...). Returns (T_local, d)."""
    ax = _axis.axis(axis_name)
    n_dev = ax.size
    T, d = x.shape
    E = router_w.shape[1]
    assert E % n_dev == 0, f"{E} experts over {n_dev} ranks"
    e_local = E // n_dev
    if capacity is None:
        capacity = max(1, int(capacity_factor * top_k * T / E))

    logits = torch.matmul(x, router_w)
    dispatch, combine = top_k_gating(logits, top_k, capacity)
    # (T,E,C) x (T,d) -> (E,C,d); rank j then receives every rank's slabs
    # for its own experts
    slabs = torch.einsum("tec,td->ecd", dispatch, x)
    slabs = _axis.all_to_all(slabs.reshape(n_dev, e_local, capacity, d), ax)
    # expert e now sees n_dev * C token slots
    slabs = slabs.transpose(0, 1).reshape(e_local, n_dev * capacity, d)
    out = expert_fn(expert_params, slabs)
    out = out.reshape(e_local, n_dev, capacity, d).transpose(0, 1)
    out = _axis.all_to_all(out, ax).reshape(E, capacity, d)
    return torch.einsum("tec,ecd->td", combine, out)


def mlp_expert(params, tokens):
    """The default expert net, a GELU MLP (``:112``), over stacked
    experts: ``params = {"w1": (E, d, h), "b1": (E, h), "w2": (E, h, d),
    "b2": (E, d)}`` and ``tokens`` (E, N, d): one batched matmul per
    weight (JAX's is one expert, ``vmap``ped)."""
    h = F.gelu(torch.matmul(tokens, params["w1"])
               + params["b1"].unsqueeze(-2), approximate="tanh")
    return torch.matmul(h, params["w2"]) + params["b2"].unsqueeze(-2)
