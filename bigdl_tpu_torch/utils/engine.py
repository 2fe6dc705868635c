"""Engine — the runtime topology (``bigdl_tpu/utils/engine.py:26-295``).

``EngineType`` is the JAX package's enum; its values are accepted for
source compatibility and select no code.

``Engine`` is the process-wide singleton of the reference's ``object
Engine``. The JAX package runs one process per host driving all its chips;
the port runs one process per device, the PyTorch idiom, so a JAX process
count becomes the ``torch.distributed`` world size and a JAX mesh axis a
``DeviceMesh`` dimension:

* :meth:`Engine.init_distributed` starts the process group: NCCL for the
  card, gloo only where the caller asks for the CPU. It must run before
  :meth:`Engine.init`, as in JAX. The rendezvous is the caller's
  ``coordinator_address`` (``host:port``, ``tcp://...`` or ``file://...``),
  else torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``), else, for one process, an in-memory store (no
  socket). A failure to set the group up raises; nothing falls back.
* :meth:`Engine.init` fixes ``node_number`` (the world size) and
  ``core_number`` (devices per process: 1) from the arguments, the
  ``BIGDL_*`` environment variables or the live group.
* :meth:`Engine.mesh` returns a ``DeviceMesh`` over the world with the
  given dimension names (``("data",)`` by default); it raises when no
  process group is up. :meth:`Engine.hybrid_mesh` builds the two-level
  mesh, a leading ``dcn`` dimension over slices and the ICI dimensions
  inside each. The last mesh either built is ``Engine.current_mesh()``:
  the mesh whose dimensions the parallel planes' axis names
  (``sp_axis``, ``"model"``, ``"pipe"``, ``"expert"``) resolve against
  (:mod:`bigdl_tpu_torch.parallel.axis`), where JAX binds them with a
  ``shard_map``.

Not ported: ``default_pool`` (the host thread pool,
``utils/thread_pool.py``: A.7); it raises.
"""

from __future__ import annotations

import datetime
import os
from enum import Enum
from typing import Optional, Sequence

import torch


class EngineType(Enum):
    MklBlas = "mklblas"
    MklDnn = "mkldnn"
    TPU = "tpu"

    @staticmethod
    def parse(name: str) -> "EngineType":
        key = name.strip().lower()
        for e in EngineType:
            if e.value == key or e.name.lower() == key:
                return e
        raise ValueError(f"unknown engine type: {name!r}")


def _env(name: str, default=None):
    return os.environ.get(name, default)


def _dist():
    import torch.distributed as dist

    return dist


def _prod(sizes) -> int:
    out = 1
    for v in sizes:
        out *= int(v)
    return out


def _check_devices(devices) -> None:
    if devices is not None:
        raise ValueError("the port's meshes cover every process of the "
                         "group, one device each: devices must be None")


def world_and_rank():
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def group_device_type() -> Optional[str]:
    """``"cuda"`` for an NCCL default group, ``"cpu"`` for gloo, ``None``
    without a group."""
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


class _EngineSingleton:
    """Process-wide runtime state (reference ``object Engine``)."""

    def __init__(self) -> None:
        self._initialized = False
        self._distributed_initialized = False
        self._node_number = 1
        self._core_number = 1
        self._engine_type = EngineType.TPU
        self._local_mode = True
        self._seed: Optional[int] = None
        self._mesh = None

    # -- lifecycle ---------------------------------------------------------

    def init(self, node_number: Optional[int] = None,
             core_number: Optional[int] = None,
             engine_type=None, local_mode: Optional[bool] = None
             ) -> "_EngineSingleton":
        """Validate and fix the topology: ``node_number`` is the number of
        processes (the world size), ``core_number`` the devices each drives
        (1). Defaults: ``BIGDL_NODE_NUMBER``/``BIGDL_CORE_NUMBER``, then the
        live process group."""
        if engine_type is None:
            engine_type = _env("BIGDL_ENGINE_TYPE", "tpu")
        if isinstance(engine_type, str):
            engine_type = EngineType.parse(engine_type)
        self._engine_type = engine_type
        if node_number is None:
            node_number = int(_env("BIGDL_NODE_NUMBER", world_and_rank()[0]))
        if core_number is None:
            core_number = int(_env("BIGDL_CORE_NUMBER", 1))
        if node_number < 1 or core_number < 1:
            raise ValueError(f"invalid topology: node_number={node_number} "
                             f"core_number={core_number}")
        self._node_number = node_number
        self._core_number = core_number
        self._local_mode = (
            local_mode if local_mode is not None
            else _env("BIGDL_LOCAL_MODE", str(node_number == 1)).lower()
            in ("1", "true"))
        seed = _env("BIGDL_SEED")
        if seed is not None:
            self._seed = int(seed)
        self._initialized = True
        return self

    def init_distributed(self, coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device: Optional[str] = None,
                         timeout_s: float = 600.0
                         ) -> "_EngineSingleton":
        """Start the process group, then run :meth:`init`.

        ``backend`` defaults to NCCL (``device`` ``"cuda"``, the default)
        or gloo (``device="cpu"``). With NCCL the process first takes its
        card (``LOCAL_RANK``, else ``process_id`` modulo the card count).
        ``timeout_s`` bounds the rendezvous and every collective."""
        dist = _dist()
        if self._distributed_initialized:
            return self.init()
        if self._initialized:
            raise RuntimeError(
                "Engine.init_distributed() must run BEFORE Engine.init() or "
                "any distributed work: call it first in your main")
        if dist.is_initialized():
            raise RuntimeError("a torch.distributed process group is "
                               "already up; Engine.init_distributed starts it")
        device = device or ("cpu" if backend == "gloo" else "cuda")
        if backend is None:
            backend = "nccl" if device == "cuda" else "gloo"
        timeout = datetime.timedelta(seconds=timeout_s)
        env = os.environ
        if num_processes is None and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None and "RANK" in env:
            process_id = int(env["RANK"])
        num_processes = 1 if num_processes is None else int(num_processes)
        process_id = 0 if process_id is None else int(process_id)
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "NCCL needs a CUDA device; pass device='cpu' to run "
                    "the gloo ranks on the CPU")
            local = int(env.get("LOCAL_RANK",
                                process_id % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        kw = dict(backend=backend, world_size=num_processes,
                  rank=process_id, timeout=timeout)
        if coordinator_address is not None:
            addr = coordinator_address
            if "://" not in addr:
                addr = f"tcp://{addr}"
            dist.init_process_group(init_method=addr, **kw)
        elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
            dist.init_process_group(init_method="env://", **kw)
        elif num_processes == 1:
            dist.init_process_group(store=dist.HashStore(), **kw)
        else:
            raise ValueError(
                f"{num_processes} processes need a rendezvous: pass "
                "coordinator_address or run under torchrun")
        self._distributed_initialized = True
        return self.init()

    def shutdown(self) -> None:
        """Destroy the process group this engine started and forget the
        topology."""
        dist = _dist()
        if self._distributed_initialized and dist.is_initialized():
            dist.destroy_process_group()
        self._distributed_initialized = False
        self._mesh = None
        self.reset()

    def reset(self) -> None:
        """Forget the topology, so the next :meth:`init` reads it anew."""
        self._initialized = False

    def _ensure_init(self) -> None:
        if not self._initialized:
            self.init()

    # -- topology accessors ------------------------------------------------

    def node_number(self) -> int:
        self._ensure_init()
        return self._node_number

    def core_number(self) -> int:
        self._ensure_init()
        return self._core_number

    def engine_type(self) -> EngineType:
        self._ensure_init()
        return self._engine_type

    def is_local_mode(self) -> bool:
        self._ensure_init()
        return self._local_mode

    def device_count(self) -> int:
        """Devices of the whole group: one per process."""
        return world_and_rank()[0]

    def devices(self):
        """The device this process drives (its rank's card, or the CPU)."""
        if group_device_type() == "cpu":
            return [torch.device("cpu")]
        if torch.cuda.is_available():
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cpu")]

    def _device_mesh(self, shape, names):
        from torch.distributed.device_mesh import init_device_mesh

        if not _dist().is_initialized():
            raise RuntimeError(
                "Engine.mesh() needs a process group: call "
                "Engine.init_distributed() first (one process needs no "
                "rendezvous)")
        self._mesh = init_device_mesh(group_device_type(), tuple(shape),
                                      mesh_dim_names=tuple(names))
        return self._mesh

    def mesh(self, axis_names: Sequence[str] = ("data",),
             axis_sizes: Optional[Sequence[int]] = None, devices=None):
        """A ``DeviceMesh`` over every process, one device each: the
        default is 1-D data parallelism over the world. The process group
        must be up (:meth:`init_distributed`). ``devices`` must be
        ``None``, as for :meth:`hybrid_mesh`."""
        _check_devices(devices)
        n = world_and_rank()[0]
        if axis_sizes is None:
            axis_sizes = [n] + [1] * (len(axis_names) - 1)
        if _prod(axis_sizes) != n:
            raise ValueError(
                f"axis_sizes {tuple(axis_sizes)} do not cover {n} devices")
        return self._device_mesh(axis_sizes, axis_names)

    def hybrid_mesh(self, ici_axis_names: Sequence[str] = ("data",),
                    ici_axis_sizes: Optional[Sequence[int]] = None,
                    dcn_axis_name: str = "dcn",
                    num_slices: Optional[int] = None, devices=None):
        """The two-level mesh (``engine.py:239``): a leading
        ``dcn_axis_name`` dimension across slices and ``ici_axis_names``
        inside each. ``num_slices`` partitions the flat rank list into
        that many consecutive slices, as JAX's CPU simulation does; by
        default there is one slice (the card machines expose no slice
        index). ``devices`` is accepted and must be ``None``: the mesh
        covers every process of the group, one device each."""
        _check_devices(devices)
        n = world_and_rank()[0]
        num_slices = 1 if num_slices is None else int(num_slices)
        if num_slices < 1 or n % num_slices:
            raise ValueError(
                f"{n} devices do not split into {num_slices} slices")
        per_slice = n // num_slices
        if ici_axis_sizes is None:
            ici_axis_sizes = [per_slice] + [1] * (len(ici_axis_names) - 1)
        if _prod(ici_axis_sizes) != per_slice:
            raise ValueError(
                f"ici_axis_sizes {tuple(ici_axis_sizes)} do not cover the "
                f"{per_slice} devices of one slice")
        return self._device_mesh([num_slices] + list(ici_axis_sizes),
                                 (dcn_axis_name, *ici_axis_names))

    def current_mesh(self):
        """The mesh :meth:`mesh` or :meth:`hybrid_mesh` built last (``None``
        before either, and after :meth:`shutdown`)."""
        return self._mesh

    def default_pool(self):
        raise NotImplementedError(
            "Engine.default_pool (utils/thread_pool.py's host pool) is not "
            "ported yet: ROADMAP.md A.7")

    model_pool = default_pool

    # -- misc --------------------------------------------------------------

    def set_seed(self, seed: int) -> None:
        self._seed = seed

    def seed(self) -> Optional[int]:
        return self._seed


Engine = _EngineSingleton()
