"""AllReduceParameter — the partitioned parameter plane
(``bigdl_tpu/parallel/all_reduce.py:35-169``).

The reference flattens every parameter into one 1-D vector, cuts it into
``n`` partitions, one per executor, and per iteration reduce-scatters the
gradients (``putGradients`` + ``aggregateGradientPartition``), lets each
owner update its partition, and all-gathers the weights
(``sendWeightPartition`` + ``getWeights``). The JAX package runs that
dataflow as XLA collectives inside one program; the port runs it as
``torch.distributed`` collectives between processes, one device each:

    lax.all_gather(tiled)       →  all_gather_into_tensor
    lax.psum_scatter(tiled)     →  reduce_scatter_tensor (sum)
    FP16CompressedTensor        →  the cotangent cast to bf16/f16 first

**The flat layout is JAX's**: the leaves in the order ``ravel_pytree``
flattens the JAX params tree (``AbstractModule._jax_ordered``: keys sorted
level by level, a container's children by their ``"i:"`` keys), then
zeros up to a multiple of ``n``. Rank ``r``'s shard is therefore row ``r``
of JAX's ``init_shards`` for the same weights, padding included.

:meth:`AllReduceParameter.get_weights` is differentiable: its forward is
the all-gather, its backward the (compressed) reduce-scatter, so the
gradient of the loss with respect to a rank's shard IS the reference's
aggregated gradient partition (the sum over ranks; the caller divides by
``n``). The gathered buffer is split into the leaves with one
``torch.split``, whose backward is one ``cat``: per-leaf slicing would
zero-fill a full-size gradient for every leaf.

Every collective of the port's parameter plane goes through the counted
wrappers here: :data:`comm` holds the calls and the bytes of the full
buffer each one covers (the gathered output, the reduce-scatter's input,
an all-reduced or broadcast tensor) since it was last reset.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

#: collective calls and bytes since the last reset (callers set them to 0)
comm = {"calls": 0, "bytes": 0}


def _dist():
    import torch.distributed as dist

    return dist


def _count(t: torch.Tensor) -> None:
    comm["calls"] += 1
    comm["bytes"] += t.numel() * t.element_size()


def all_gather_into(out: torch.Tensor, shard: torch.Tensor, group=None):
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor      # torch < 2.13 has only the old name
    _count(out)
    fn(out, shard, group=group)
    return out


def reduce_scatter_into(out: torch.Tensor, full: torch.Tensor, group=None):
    dist = _dist()
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    _count(full)
    fn(out, full, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the group (the caller divides by ``n`` for a
    mean, as JAX's ``pmean`` is ``psum / n``)."""
    _count(t)
    _dist().all_reduce(t, group=group)
    return t


def broadcast_from(t: torch.Tensor, src_rank: int = 0, group=None):
    """In-place broadcast from the group's rank ``src_rank``."""
    dist = _dist()
    src = dist.get_global_rank(group, src_rank) if group is not None \
        else src_rank
    _count(t)
    dist.broadcast(t, src, group=group)
    return t


def flatten_params(model, params: Optional[Dict[str, torch.Tensor]] = None):
    """(flat 1-D tensor of ``params`` (default: the model's) in the JAX
    order, ``unflatten(flat) -> {name: view}``)."""
    arp = AllReduceParameter(model, 1)
    if params is None:
        params = dict(model.named_parameters())
    return arp.flatten(params), arp.unflatten


def pad_to_multiple(flat: torch.Tensor, n: int):
    """``flat`` zero-padded to a multiple of ``n``; (padded, pad count)."""
    pad = (-flat.shape[0]) % n
    if not pad:
        return flat, 0
    return torch.cat([flat, flat.new_zeros(pad)]), pad


class _GatherWeights(torch.autograd.Function):
    """forward: all-gather of the shards; backward: the reduce-scatter of
    the cotangent, cast to the compress dtype and back."""

    @staticmethod
    def forward(ctx, shard, arp):
        ctx.arp = arp
        out = shard.new_empty(arp.padded_size)
        return all_gather_into(out, shard.contiguous(), arp.group)

    @staticmethod
    def backward(ctx, ct):
        arp = ctx.arp
        orig = ct.dtype
        if arp.compress is not None:
            ct = ct.to(arp.compress_dtype)
        out = ct.new_empty(arp.shard_size)
        reduce_scatter_into(out, ct.contiguous(), arp.group)
        return out.to(orig), None


class AllReduceParameter:
    """The partition arithmetic and the differentiable gather of one
    model's flat parameter vector over ``n_partitions`` ranks of
    ``group`` (default: the world).

    Usage, on every rank of the group::

        arp = AllReduceParameter(model, n, group, compress)
        full = arp.get_weights(my_shard)     # {name: view}, differentiable
        ... loss ...; (gshard,) = torch.autograd.grad(loss, [my_shard])
        gshard /= n                          # sum of per-rank means → mean
    """

    def __init__(self, model, n_partitions: int, group=None,
                 compress: Optional[str] = None) -> None:
        if compress not in (None, "bf16", "fp16"):
            raise ValueError(f"unknown compress {compress!r}")
        self.n = int(n_partitions)
        self.group = group
        self.compress = compress
        self.compress_dtype = {"bf16": torch.bfloat16,
                               "fp16": torch.float16}.get(compress)
        # (name, shape) in the JAX flatten order
        self.layout = [(k, p.shape) for k, p in model._jax_ordered()]
        self.sizes = [s.numel() for _, s in self.layout]
        self.total_size = sum(self.sizes)
        self.padded_size = -(-self.total_size // self.n) * self.n
        self.shard_size = self.padded_size // self.n

    # -- layout ------------------------------------------------------------

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``params`` as one padded flat vector (a new tensor)."""
        flat = torch.cat([params[k].detach().reshape(-1)
                          for k, _ in self.layout])
        return pad_to_multiple(flat, self.n)[0]

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{name: view}`` of a padded (or unpadded) flat vector: one
        ``split``, so autograd's backward is one ``cat``."""
        sizes = self.sizes + [flat.shape[0] - self.total_size]
        parts = torch.split(flat, sizes)
        return {k: v.view(s) for (k, s), v in zip(self.layout, parts)}

    def shard_of(self, flat_padded: torch.Tensor, part: int) -> torch.Tensor:
        return flat_padded[part * self.shard_size:
                           (part + 1) * self.shard_size]

    # -- host-side setup ---------------------------------------------------

    def init_shards(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Full params → the stacked partitions, ``(n, shard_size)``: row
        ``r`` is rank ``r``'s shard."""
        return self.flatten(params).reshape(self.n, self.shard_size)

    def gather_flat(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's shard → the padded flat vector on every rank."""
        with torch.no_grad():
            out = shard.new_empty(self.padded_size)
            return all_gather_into(out, shard.contiguous(), self.group)

    def to_full(self, shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every rank's shard → the full params on every rank (an
        all-gather; fresh tensors, not views of the shard)."""
        return self.unflatten(self.gather_flat(shard))

    # -- the step ----------------------------------------------------------

    def get_weights(self, my_shard: torch.Tensor) -> Dict[str, torch.Tensor]:
        """All-gather the partitions → ``{name: view}`` of the full
        weights; differentiable with respect to ``my_shard`` (module
        docstring)."""
        return self.unflatten(_GatherWeights.apply(my_shard, self))
