"""bigdl_tpu_torch.serving — the continuous-batching engine of the port.

Many requests share one pooled, slot-indexed KV cache (``kv_pool.py``)
and one per-row decode step with a fused per-row sampler
(``sampling.py``); admission is batched in power-of-two length buckets
(``admission.py``); the engine (``engine.py``) reads back only token ids
and their log-probs, once per step (``fences.py``).
"""

from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.faults import FaultError, WatchdogConfig
from bigdl_tpu_torch.serving.kv_pool import KVPool
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.sampling import SamplingParams
from bigdl_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["ServingEngine", "KVPool", "Scheduler", "Request",
           "SamplingParams", "ServingMetrics", "FaultError",
           "WatchdogConfig"]
