"""DistriOptimizer — the data-parallel trainer
(``bigdl_tpu/optim/distri_optimizer.py:56-804``).

One process per device: where the JAX package has one process driving n
chips through a ``shard_map`` program over a ``Mesh``, the port has n
``torch.distributed`` ranks, each holding one device, and a
``DeviceMesh`` with the dimension ``"data"`` (``Engine.mesh()``). Every
rank runs the same host loop (``Optimizer.optimize``) on its own shard of
the data (``DataSet.distributed``); ``batch_size`` is global and each rank
batches ``batch_size / world`` rows. Before the first step every rank
takes rank 0's parameters and buffers (``ModelBroadcast``).

``parameter_mode``:

* ``"partitioned"`` (default) — ``AllReduceParameter``'s dataflow: each
  rank owns ``1/n`` of the flat f32 parameter vector (the JAX flatten
  order, zero-padded) and the optimizer slots of that shard only. A step
  all-gathers the weights, runs forward and backward through them, and
  the gather's backward reduce-scatters the gradient (cast to bf16/f16
  first under ``compress``); the shard gradient is divided by n, clipped
  (the global L2 norm from an all-reduce of per-shard square sums) and
  the owner updates its shard.
* ``"allreduce"`` — every rank holds the whole flat vector; the gradient
  is all-reduced once (sum, then divided by n), the regularizers and
  clipping act on the mean, and every rank makes the same update.
* ``"blockstore"`` — the reference's BlockManager exchange on a host
  block store (``parallel/block_store.py``; by default the process group's
  own store): the gradient comes to the host, its remote slices are put,
  the owner aggregates its partition with the straggler drop
  (``set_drop_module_property``), clips it, updates its slice on the
  device, publishes it and every rank assembles the weights. It is the
  reference's straggler mode, not the fast path.

After each step the loss and the float buffers (BatchNorm running
statistics; integer buffers stay) are averaged over the ranks, one
all-reduce per dtype. Regularizers act on the f32 masters: as a loss term
in the partitioned and blockstore modes, on the averaged gradient in the
allreduce mode, as in JAX. Stochastic layers draw from a generator seeded
with (seed, ``neval``, rank), the counterpart of JAX's ``fold_in(rng,
axis_index)``: the ranks draw unrelated masks, and a resumed run draws
those of an uninterrupted one.

The layout hooks map the flat or partitioned vector to ``{parameter name:
tensor}`` for checkpoints, summaries and the write-back (a partitioned
vector and its slots are all-gathered on the device), so checkpoints have
``LocalOptimizer``'s layout. Validation gathers the weights on the device
once per validation, each rank scores its own validation data, and the
results merge across the ranks (``set_validation``'s batch size is
global). The counterparts of JAX's collectives are ``torch.distributed``'s
explicit ones (``parallel/all_reduce.py``), not DDP or FSDP.

Frozen layers (``Module.freeze``) are a flat boolean mask over the
step's vector (the JAX layout, padding unfrozen), as in JAX
(``:189``, ``:284``, ``:392``): the frozen elements' gradient is zeroed
and, after the update, their weights are written back bit for bit from
a copy taken before it. The partitioned and blockstore modes zero the
owner's shard before the clipping (the global norm leaves them out), the
allreduce mode after the regularizers and the clipping, each where JAX
does; a rank's shard restores exactly the frozen elements it owns.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn.module import use_rng
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.train_step import (
    apply_module_regularizers, cast_floats, frozen_mask_tree,
    module_regularizers, regularizer_loss, resolve_dtype, step_seed,
)
from bigdl_tpu_torch.optim.upload import PinnedUploader
from bigdl_tpu_torch.parallel.all_reduce import (
    AllReduceParameter, all_reduce_sum,
)
from bigdl_tpu_torch.utils.engine import Engine, world_and_rank

logger = logging.getLogger("bigdl_tpu_torch")

_MODES = ("partitioned", "allreduce", "blockstore")


def pmean_(tensors, n: int, group=None) -> None:
    """Replace each tensor by its mean over the group, in place: one
    all-reduce per dtype over the tensors packed flat (sum, then / n)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_sum(flat, group).div_(n)
        torch._foreach_copy_(ts, [v.view_as(t) for t, v in zip(
            ts, torch.split(flat, [t.numel() for t in ts]))])


class DistriOptimizer(Optimizer):
    def __init__(self, model=None, dataset=None, criterion=None,
                 batch_size: Optional[int] = None, end_trigger=None,
                 parameter_mode: str = "partitioned",
                 compress: Optional[str] = None,
                 mesh=None, block_store=None, **kw) -> None:
        n = mesh.size() if mesh is not None else world_and_rank()[0]
        if batch_size is not None:
            if batch_size % n:
                raise ValueError(f"global batch {batch_size} must divide "
                                 f"the {n}-process topology")
            batch_size //= n
        super().__init__(model, dataset, criterion, batch_size, end_trigger,
                         **kw)
        if parameter_mode not in _MODES:
            raise ValueError(f"unknown parameter_mode {parameter_mode!r}")
        if compress not in (None, "bf16", "fp16"):
            raise ValueError(f"unknown compress {compress!r}")
        self.parameter_mode = parameter_mode
        self.compress = compress
        self._mesh = mesh
        self._block_store = block_store
        self._drop_policy = None
        self._bsp = None
        self._arp: Optional[AllReduceParameter] = None
        #: host bytes moved per blockstore step (device↔host copies)
        self.host_bytes = 0

    def set_drop_module_property(self, drop_percentage: float,
                                 max_drop_percentage: Optional[float] = None,
                                 batch_size: int = 100,
                                 warmup_iteration: int = 20
                                 ) -> "DistriOptimizer":
        """Reference ``setDropModuleProperty``: after ``warmup_iteration``
        iterations, stop waiting for late gradient contributions once
        ``1 - drop_percentage`` arrived (``batch_size`` calibration
        samples; at most ``max_drop_percentage`` dropped). Blockstore mode
        only: a collective cannot partially complete."""
        if self.parameter_mode != "blockstore":
            raise ValueError(
                "gradient drop requires parameter_mode='blockstore' (the "
                "collective modes cannot partially complete; see "
                "parallel/block_store.py)")
        from bigdl_tpu_torch.parallel.block_store import GradientDropPolicy

        self._drop_policy = GradientDropPolicy(
            drop_percentage, max_drop_percentage,
            compute_threshold_batch_size=batch_size,
            warmup_iteration=warmup_iteration)
        return self

    def set_validation(self, trigger, dataset=None, methods=None,
                       batch_size=None, **kw):
        """The batch size is global, as in training: each rank scores
        local batches of ``batch_size / world``. The pyspark order is
        normalized before dividing."""
        n = self._mesh.size() if self._mesh is not None \
            else world_and_rank()[0]
        if n > 1:
            if isinstance(trigger, int):        # pyspark positional order
                batch_size, dataset, trigger, methods = (
                    trigger, dataset, methods, batch_size)
            if batch_size is not None:
                if batch_size % n:
                    raise ValueError(
                        f"global validation batch {batch_size} must divide "
                        f"the {n}-process topology")
                batch_size //= n
            # the merge is a collective: fail early, on every rank, if a
            # method cannot bring an empty result
            for m in list(methods or []) + list(kw.get("val_method") or []):
                if getattr(m, "_result_cls", None) is None:
                    raise ValueError(
                        f"{type(m).__name__} needs _result_cls set for pod "
                        "validation (see ValidationMethod.empty_result)")
        return super().set_validation(trigger, dataset, methods, batch_size,
                                      **kw)

    def _teardown(self) -> None:
        if self._bsp is not None:
            try:
                self._bsp._join_puts()
            except Exception as e:
                logger.warning("draining async gradient puts failed: %s", e)

    def mesh(self):
        if self._mesh is None:
            self._mesh = Engine.mesh(("data",))
        return self._mesh

    def _step_seed(self, neval: int) -> int:
        return step_seed(self.seed, neval, self._rank)

    # -- the step's shared pieces ------------------------------------------

    def _loss(self, p_full, model_state, rng, inputs, targets, with_reg):
        """Forward through the gathered weights; the loss (× loss scale),
        with the regularizers' penalty on the f32 masters when asked."""
        x = inputs
        if self._device_preprocess is not None:
            x = self._device_preprocess(x)
        p = p_full
        if self._compute_dtype is not None:
            p = cast_floats(p, self._compute_dtype)
            x = cast_floats(x, self._compute_dtype)
        with use_rng(rng):
            out = functional_call(self.model, {**p, **model_state}, (x,))
        if self._compute_dtype is not None:
            out = cast_floats(out, torch.float32)
        loss = self.criterion.apply(out, targets)
        if with_reg and self._regs:
            loss = loss + regularizer_loss(self._regs, p_full)
        return loss * self.loss_scale

    def _grad(self, master, unflatten, model_state, rng, inputs, targets,
              with_reg):
        """(loss, gradient with respect to ``master``) through
        ``unflatten(master)``; both divided by the loss scale."""
        leaf = master.detach().requires_grad_()
        with torch.enable_grad():
            loss = self._loss(unflatten(leaf), model_state, rng, inputs,
                              targets, with_reg)
            (g,) = torch.autograd.grad(loss, [leaf])
        loss = loss.detach()
        if self.loss_scale != 1.0:
            loss = loss / self.loss_scale
            g = g / self.loss_scale
        return loss, g

    def _clip(self, g, group=None):
        """Clipping on a flat gradient; with ``group`` the L2 norm is the
        all-reduce of every rank's square sum (the shards tile the full
        vector)."""
        l2 = self.grad_clip.get("l2_norm")
        if l2 is not None:
            total = (g.float() ** 2).sum().reshape(1)
            if group is not None:
                all_reduce_sum(total, group)
            g = g * torch.clamp(l2 / (torch.sqrt(total) + 1e-6), max=1.0)
        if self.grad_clip.get("constant") is not None:
            lo, hi = self.grad_clip["constant"]
            g = g.clamp(lo, hi)
        return g

    def _pmean_state(self, loss, model_state, n, group):
        """The loss and the float buffers averaged over the ranks."""
        loss = loss.reshape(1)
        floats = [b for b in model_state.values() if b.is_floating_point()]
        with torch.no_grad():
            pmean_([loss] + floats, n, group)
        return loss.reshape(())

    def _frozen_elements(self, arp, lo: int = 0, hi: Optional[int] = None):
        """(mask, indices) of the frozen elements of ``arp``'s padded flat
        vector in ``[lo, hi)``, on the device, or ``(None, None)`` when
        nothing is frozen. The indices are taken once here, so the step
        gathers and scatters them without a host sync."""
        named = dict(self.model.named_parameters())
        mask = frozen_mask_tree(self.model, named)
        if mask is None:
            return None, None
        with torch.no_grad():
            flat = arp.flatten({k: torch.full_like(p, float(mask[k]))
                                for k, p in named.items()})[lo:hi] > 0.5
        return flat, flat.nonzero().squeeze(1)

    @staticmethod
    def _put_back(vec, idx, kept) -> None:
        """Write the frozen elements' copies ``kept`` back at ``idx``."""
        if idx is not None:
            with torch.no_grad():
                vec.index_copy_(0, idx, kept)

    # -- the three steps ----------------------------------------------------

    def _build_partitioned_step(self, group, n, rank):
        arp = self._arp = AllReduceParameter(self.model, n, group,
                                             self.compress)
        optim = self.optim_method
        fr, idx = self._frozen_elements(
            arp, rank * arp.shard_size, (rank + 1) * arp.shard_size)

        def step(shard, opt_state, model_state, rng, inputs, targets):
            loss, gshard = self._grad(shard, arp.get_weights, model_state,
                                      rng, inputs, targets, True)
            gshard = gshard / n
            if fr is not None:
                gshard = gshard.masked_fill(fr, 0.0)
            gshard = self._clip(gshard, group)
            kept = None if idx is None else shard.index_select(0, idx)
            _, new_opt = optim.update({"flat": gshard}, opt_state,
                                      {"flat": shard})
            self._put_back(shard, idx, kept)
            return shard, new_opt, model_state, self._pmean_state(
                loss, model_state, n, group)

        flat = arp.flatten(dict(self.model.named_parameters()))
        shard = arp.shard_of(flat, rank).clone()
        return step, shard, optim.init_state({"flat": shard})

    def _build_allreduce_step(self, group, n):
        arp = self._arp = AllReduceParameter(self.model, 1)
        optim = self.optim_method
        fr, idx = self._frozen_elements(arp)

        def step(flat, opt_state, model_state, rng, inputs, targets):
            loss, g = self._grad(flat, arp.unflatten, model_state, rng,
                                 inputs, targets, False)
            all_reduce_sum(g, group).div_(n)
            if self._regs:
                grads = arp.unflatten(g)
                params = arp.unflatten(flat)
                new = apply_module_regularizers(self._regs, params, grads)
                with torch.no_grad():
                    for name, _ in self._regs:
                        grads[name].copy_(new[name])
            g = self._clip(g)
            if fr is not None:
                g = g.masked_fill(fr, 0.0)
            kept = None if idx is None else flat.index_select(0, idx)
            _, new_opt = optim.update({"flat": g}, opt_state, {"flat": flat})
            self._put_back(flat, idx, kept)
            return flat, new_opt, model_state, self._pmean_state(
                loss, model_state, n, group)

        flat = arp.flatten(dict(self.model.named_parameters())).clone()
        return step, flat, optim.init_state({"flat": flat})

    def _build_blockstore_step(self, n, rank):
        from bigdl_tpu_torch.parallel.block_store import (
            BlockStoreParameter, default_block_store,
        )

        arp = self._arp = AllReduceParameter(self.model, n)
        store = self._block_store or default_block_store()
        if self._bsp is not None:
            # an earlier attempt's async put may still be in flight
            try:
                self._bsp._join_puts()
            except Exception as e:
                logger.warning("draining the previous attempt's gradient "
                               "puts: %s", e)
        bsp = self._bsp = BlockStoreParameter(
            store, n, rank, arp.total_size, compress=self.compress,
            drop_policy=self._drop_policy,
            async_puts=self._drop_policy is not None)
        bsp.sweep_stale(aux_names=("loss", "gnorm2", "mstate"))
        optim, total = self.optim_method, arp.total_size
        lo, hi = rank * bsp.shard_size, (rank + 1) * bsp.shard_size
        l2 = self.grad_clip.get("l2_norm")
        const = self.grad_clip.get("constant")
        counter = {"t": 0}
        fr, idx = self._frozen_elements(arp, lo, hi)
        fr_host = None if fr is None else fr.cpu().numpy()

        def to_host(t):
            self.host_bytes += t.numel() * t.element_size()
            return t.detach().float().cpu().numpy()

        def step(master, opt_state, model_state, rng, inputs, targets):
            t = counter["t"]
            loss, g = self._grad(master, arp.unflatten, model_state, rng,
                                 inputs, targets, True)
            gflat = to_host(g[:total])
            floats = [b for b in model_state.values() if b.is_floating_point()]
            # loss and buffers go out before the gradient blobs, so an
            # owner that drops this rank's gradient still averages them
            if n > 1:
                bsp.publish_aux(t, "loss", np.float32(to_host(loss)))
                if floats:
                    bsp.publish_aux(t, "mstate", np.concatenate(
                        [to_host(b).ravel() for b in floats]))
            bsp.put_gradients(t, gflat)
            g_my, _, dropped = bsp.aggregate_my_partition(t)
            if dropped:
                self.metrics.add("dropped gradients", float(len(dropped)))
            if fr_host is not None:
                g_my = np.where(fr_host, np.float32(0.0), g_my)
            if l2 is not None:
                bsp.publish_aux(t, "gnorm2", np.float64(
                    np.sum(g_my.astype(np.float64) ** 2)))
                parts = bsp.gather_aux(t, "gnorm2", blocking=True)
                norm = float(np.sqrt(sum(float(v) for v in parts.values())))
                g_my = g_my * min(1.0, l2 / (norm + 1e-6))
            if const is not None:
                g_my = np.clip(g_my, const[0], const[1])
            mine = master[lo:hi]
            g_dev = torch.from_numpy(np.ascontiguousarray(g_my, np.float32))
            self.host_bytes += g_dev.numel() * 4
            kept = None if idx is None else mine.index_select(0, idx)
            _, new_opt = optim.update({"flat": g_dev.to(master.device)},
                                      opt_state, {"flat": mine})
            self._put_back(mine, idx, kept)
            bsp.publish_weights(t + 1, to_host(mine))
            wfull = torch.from_numpy(bsp.get_weights(t + 1))
            self.host_bytes += wfull.numel() * 4
            with torch.no_grad():
                master[:total].copy_(wfull)
                if n > 1:
                    # after get_weights(t+1), a barrier every live owner
                    # passes only after publishing its aux for t
                    ms = bsp.gather_aux(t, "mstate", blocking=False)
                    if floats and ms:
                        mean = torch.from_numpy(np.mean(
                            np.stack(list(ms.values())), axis=0))
                        parts = torch.split(mean, [b.numel() for b in floats])
                        for b, v in zip(floats, parts):
                            b.copy_(v.view_as(b))
                    losses = bsp.gather_aux(t, "loss", blocking=False)
                    if losses:
                        loss = torch.tensor(np.float32(np.mean(
                            [float(v) for v in losses.values()])))
            counter["t"] = t + 1
            return master, new_opt, model_state, loss

        master = arp.flatten(dict(self.model.named_parameters()))
        return step, master, optim.init_state({"flat": master[lo:hi]})

    # -- Optimizer hooks ----------------------------------------------------

    def _prepare(self):
        from bigdl_tpu_torch.parallel.broadcast import ModelBroadcast

        self._device = next(self.model.parameters()).device
        self._compute_dtype = resolve_dtype(self.compute_dtype)
        self._regs = module_regularizers(self.model)
        if self.parameter_mode == "blockstore" and self._mesh is None:
            mesh, group = None, None
            n, rank = world_and_rank()
            if n > 1:
                mesh = self.mesh()
        else:
            mesh = self.mesh()
        if mesh is not None:
            group = mesh.get_group(0)
            n, rank = mesh.size(), mesh.get_local_rank(0)
            ModelBroadcast().broadcast(mesh, self.model)
        self._n, self._rank, self._group = n, rank, group
        if self.parameter_mode == "partitioned":
            step, params, opt_state = self._build_partitioned_step(
                group, n, rank)
        elif self.parameter_mode == "allreduce":
            step, params, opt_state = self._build_allreduce_step(group, n)
        else:
            step, params, opt_state = self._build_blockstore_step(n, rank)
        model_state = {k: b.detach().clone()
                       for k, b in self.model.named_buffers()}
        self._upload = PinnedUploader(self._device)

        def place_batch(batch):
            return self._upload(batch.get_input(), batch.get_target())

        return step, place_batch, params, opt_state, model_state

    def _full(self, params):
        """``{name: tensor}`` of the step's weights, on the device (an
        all-gather in the partitioned mode)."""
        if self.parameter_mode == "partitioned":
            return self._arp.to_full(params)
        return self._arp.unflatten(params)

    def _mine(self, flat):
        """This rank's share of a padded flat vector in the step's layout."""
        if self.parameter_mode == "partitioned":
            return self._arp.shard_of(flat, self._rank)
        return flat

    def _run_validation(self, params, model_state, state):
        with torch.no_grad():
            full = self._full(params)
        return super()._run_validation(full, model_state, state)

    def _ckpt_params_to_host(self, params):
        with torch.no_grad():
            return {k: v.clone() for k, v in self._full(params).items()}

    def _host_params_to_device(self, params):
        with torch.no_grad():
            return self._mine(self._arp.flatten(params)).clone()

    def _ckpt_opt_state_to_host(self, opt_state):
        if self.parameter_mode == "blockstore":
            return opt_state        # the owner's slice, per rank (proc_<r>)
        out = dict(opt_state)
        with torch.no_grad():
            for key, slot in opt_state.items():
                if isinstance(slot, dict):
                    out[key] = {k: v.clone() for k, v in
                                self._full(slot["flat"]).items()}
        return out

    def _opt_state_to_device(self, opt_state):
        if self.parameter_mode == "blockstore":
            return opt_state
        out = dict(opt_state)
        with torch.no_grad():
            for key, slot in opt_state.items():
                if isinstance(slot, dict):
                    out[key] = {"flat": self._mine(
                        self._arp.flatten(slot)).clone()}
        return out

    def _writeback(self, params, opt_state, model_state) -> None:
        full = self._full(params)
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(full[k])
            for k, b in self.model.named_buffers():
                b.copy_(model_state[k])
        self._final_opt_state = opt_state
