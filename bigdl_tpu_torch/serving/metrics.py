"""Serving counters (``bigdl_tpu/serving/metrics.py``), on top of
:class:`bigdl_tpu_torch.optim.metrics.Metrics`.

The slice records, under the ``serving/`` prefix:

* ``ttft_s``        — per request, submit → first generated token on host
* ``tokens_out`` / ``latency_s`` / ``finished`` — at finish; with the
  first/last step timestamps they give ``tokens_per_sec``
* ``decode_step_s`` — per decode step, dispatch → fenced readback (the
  fence waits for the card, so this is device work plus launch)
* ``host_step_s``   — per step, step wall minus the fence wait: the host
  Python the card waits on
* ``finish_<reason>`` — one counter per disposition (closed vocabulary)
* ``queue_depth`` / ``slot_occupancy`` / ``batch_active`` per step,
  ``rows_sampled`` / ``rows_greedy``, ``prefill_batch`` (+ ``_padded``),
  ``retries`` / ``recovered_rows``, and the KV format
  (``kv_bits``, ``kv_bytes_per_slot``, ``kv_slots_per_gib``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from bigdl_tpu_torch.optim.metrics import Metrics


class ServingMetrics:
    """Queue/latency/throughput counters for :class:`ServingEngine`."""

    #: THE closed finish-reason vocabulary of this slice.
    FINISH_REASONS = frozenset({
        "eos",      # the request's private eos token appeared
        "stop",     # stop-token / stop-sequence hit
        "length",   # max_new_tokens reached
        "error",    # fault-recovery retry budget exhausted
    })

    #: phases during which the host is blocked on the card
    DEVICE_PHASES = frozenset({"fence_wait"})

    def __init__(self, backing: Optional[Metrics] = None) -> None:
        self.metrics = backing if backing is not None else Metrics()
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None
        self._device_s = 0.0
        self._n_decode_steps = 0

    # -- engine hooks ------------------------------------------------------

    def on_submit(self) -> None:
        self.metrics.add("serving/submitted", 1.0)

    def on_step(self, queue_depth: int, occupancy: float,
                batch_active: int) -> None:
        now = time.perf_counter()
        if self._t_start is None:
            self._t_start = now
        self._t_last = now
        self.metrics.add("serving/queue_depth", float(queue_depth))
        self.metrics.add("serving/slot_occupancy", float(occupancy))
        self.metrics.add("serving/batch_active", float(batch_active))

    def on_first_token(self, ttft_s: float) -> None:
        self.metrics.add("serving/ttft_s", float(ttft_s))

    def on_finish(self, latency_s: float, n_tokens: int,
                  mean_logprob: Optional[float] = None) -> None:
        self.metrics.add("serving/finished", 1.0)
        self.metrics.add("serving/latency_s", float(latency_s))
        self.metrics.add("serving/tokens_out", float(n_tokens))
        if mean_logprob is not None:
            self.metrics.add("serving/mean_logprob", float(mean_logprob))

    def on_finish_reason(self, reason: str) -> None:
        if reason not in self.FINISH_REASONS:
            raise ValueError(
                f"unknown finish_reason {reason!r} — known: "
                f"{sorted(self.FINISH_REASONS)}")
        self.metrics.add(f"serving/finish_{reason}", 1.0)

    def on_retry(self) -> None:
        self.metrics.add("serving/retries", 1.0)

    def on_recovered(self) -> None:
        self.metrics.add("serving/recovered_rows", 1.0)

    def on_sample_rows(self, n_sampled: int, n_greedy: int) -> None:
        self.metrics.add("serving/rows_sampled", float(n_sampled))
        self.metrics.add("serving/rows_greedy", float(n_greedy))

    def on_prefill_batch(self, n_rows: int, n_padded: int) -> None:
        self.metrics.add("serving/prefill_batch", float(n_rows))
        self.metrics.add("serving/prefill_batch_padded", float(n_padded))

    def set_kv_format(self, kv_dtype: str, bytes_per_slot: int) -> None:
        bits = {"fp32": 32.0, "bf16": 16.0, "int8": 8.0}.get(kv_dtype, 0.0)
        self.metrics.set("serving/kv_bits", bits)
        self.metrics.set("serving/kv_bytes_per_slot", float(bytes_per_slot))
        self.metrics.set("serving/kv_slots_per_gib",
                         float((1 << 30) // max(int(bytes_per_slot), 1)))

    def add_phase(self, name: str, seconds: float) -> None:
        self.metrics.add(f"serving/{name}_s", float(seconds))
        if name == "decode_step":
            self._n_decode_steps += 1
        if name in self.DEVICE_PHASES:
            self._device_s += float(seconds)

    @property
    def device_seconds(self) -> float:
        return self._device_s

    @property
    def decode_step_count(self) -> int:
        return self._n_decode_steps

    # -- derived views -----------------------------------------------------

    def tokens_per_sec(self) -> float:
        """Generated tokens over the first-step → last-step window."""
        total, _ = self.metrics.get("serving/tokens_out")
        if self._t_start is None or self._t_last is None \
                or self._t_last <= self._t_start:
            return 0.0
        return total / (self._t_last - self._t_start)

    def _pctl(self, name: str, qs) -> Dict[str, float]:
        vals = self.metrics.values(f"serving/{name}")
        if not vals:
            return {f"p{q}": 0.0 for q in qs}
        arr = np.asarray(vals)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def ttft_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        return self._pctl("ttft_s", qs)

    def decode_step_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        return self._pctl("decode_step_s", qs)

    def host_step_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        return self._pctl("host_step_s", qs)

    def summary(self) -> Dict[str, float]:
        """Means of every counter plus throughput, percentiles and the
        count-like counters as SUMS — one flat dict."""
        out = {k: v for k, v in self.metrics.summary().items()
               if k.startswith("serving/")}
        out["serving/tokens_per_sec"] = self.tokens_per_sec()
        n_s, _ = self.metrics.get("serving/rows_sampled")
        n_g, _ = self.metrics.get("serving/rows_greedy")
        if n_s + n_g > 0:
            out["serving/sampled_row_frac"] = n_s / (n_s + n_g)
        for name in ("submitted", "finished", "retries", "recovered_rows",
                     *(f"finish_{r}" for r in sorted(self.FINISH_REASONS))):
            total, n = self.metrics.get(f"serving/{name}")
            if n:
                out[f"serving/{name}"] = total
        for metric, fn in (("ttft", self.ttft_percentiles),
                           ("decode_step", self.decode_step_percentiles),
                           ("host_step", self.host_step_percentiles)):
            for k, v in fn((50, 99)).items():
                out[f"serving/{metric}_{k}_s"] = v
        return out
