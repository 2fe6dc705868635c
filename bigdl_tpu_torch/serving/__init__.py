"""bigdl_tpu_torch.serving — the continuous-batching engine of the port.

Many requests share one pooled, slot-indexed KV cache (``kv_pool.py``)
and one per-row decode step with a fused per-row sampler
(``sampling.py``). Admission is batched in power-of-two length buckets
with an optional shared-prefix cache (``admission.py``,
``prefix_cache.py``), chunked between decode steps (``chunked.py``), or
per request. The scheduler (``scheduler.py``) orders requests FIFO or by
priority and deadline; the engine (``engine.py``) preempts loss-free,
sheds and degrades under overload, recovers from failed steps (with a
seeded fault injector and virtual clocks in ``faults.py``), and reads
back only token ids and their log-probs, once per step (``fences.py``),
optionally up to ``dispatch_ahead`` steps behind their dispatch.
``speculative.py`` adds draft-and-verify decoding, ``lora.py`` a pooled
bank of per-tenant LoRA adapters selected per row, and ``constrain.py``
per-row token automata that mask the sampler (structured output).
``kv_tier.py`` parks rows and evicted prefixes in host memory under a
byte budget, and ``disagg.py`` splits serving into a prefill pool and
decode pools that hand KV rows across a wire, with pool health,
failover, graceful drain and an occupancy autoscaler (``health.py``,
over ``autopilot.Controller``).
"""

from bigdl_tpu_torch.serving.admission import Degrade, bucket_len
from bigdl_tpu_torch.serving.autopilot import Controller
from bigdl_tpu_torch.serving.constrain import (
    ConstraintCursor, ConstraintError, TokenDFA, fixed_sequence,
    from_token_sets,
)
from bigdl_tpu_torch.serving.disagg import (
    ROW_PAYLOAD_KEYS, BlockStoreTransfer, DecodeWorker, DisaggregatedEngine,
    InProcessTransfer, KVTransfer, PrefillWorker, pack_payload,
    payload_header, unpack_payload,
)
from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.faults import (
    FaultError, FaultInjector, SteppingClock, VirtualClock, WatchdogConfig,
)
from bigdl_tpu_torch.serving.fences import FENCE_SITES, fence, fence_wait
from bigdl_tpu_torch.serving.health import (
    AutoscalerConfig, HealthConfig, OccupancyAutoscaler, PoolHealth,
    TransferRetryConfig,
)
from bigdl_tpu_torch.serving.kv_pool import KVPool
from bigdl_tpu_torch.serving.kv_tier import TieredKVStore
from bigdl_tpu_torch.serving.lora import AdapterBank, AdapterSpec
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.sampling import SamplingParams
from bigdl_tpu_torch.serving.scheduler import Request, Scheduler
from bigdl_tpu_torch.serving.speculative import SpeculativeConfig

__all__ = ["ServingEngine", "KVPool", "Scheduler", "Request",
           "SamplingParams", "ServingMetrics", "FaultError",
           "FaultInjector", "VirtualClock", "SteppingClock",
           "WatchdogConfig", "PrefixCache", "Degrade", "bucket_len",
           "SpeculativeConfig", "AdapterBank", "AdapterSpec", "TokenDFA",
           "ConstraintCursor", "ConstraintError", "fixed_sequence",
           "from_token_sets", "FENCE_SITES", "fence", "fence_wait",
           "DisaggregatedEngine", "PrefillWorker", "DecodeWorker",
           "KVTransfer", "InProcessTransfer", "BlockStoreTransfer",
           "ROW_PAYLOAD_KEYS", "pack_payload", "payload_header",
           "unpack_payload", "HealthConfig", "PoolHealth",
           "TransferRetryConfig", "AutoscalerConfig",
           "OccupancyAutoscaler", "TieredKVStore", "Controller"]
