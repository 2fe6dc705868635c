"""Serving counters (``bigdl_tpu/serving/metrics.py``), on top of
:class:`bigdl_tpu_torch.optim.metrics.Metrics`.

Counters, under the ``serving/`` prefix:

* ``ttft_s``        — per request, submit → first generated token on host
* ``tokens_out`` / ``latency_s`` / ``finished`` — at finish; with the
  first/last step timestamps they give ``tokens_per_sec``;
  ``finished_in_slo`` / ``deadline_missed`` for requests with a deadline
  (no-deadline finishes count as met), and ``goodput`` in ``summary()``
* ``decode_step_s`` — per decode step, dispatch → fenced readback (the
  fence waits for the card, so this is device work plus launch)
* ``host_step_s``   — per step, step wall minus the fence wait: the host
  Python the card waits on
* ``decode_gap_s``  — wall gap between consecutive healthy decode
  dispatches while rows stayed in flight: the decode-stall signal chunked
  admission bounds
* ``draft_s``       — per speculative super-step, the chained draft
  dispatches through their completion wait (the verify dispatch lands in
  ``decode_step_s``); ``draft_tokens`` / ``accepted_tokens`` /
  ``spec_rows`` — drafts proposed, drafts that landed in outputs, and
  active rows; ``summary()`` derives ``accept_rate`` (accepted/drafted)
  and ``tokens_per_step`` ((accepted + rows)/rows, 1.0 = plain decode)
* ``finish_<reason>`` — one counter per disposition (closed vocabulary)
* ``queue_depth`` / ``slot_occupancy`` / ``batch_active`` per step,
  ``rows_sampled`` / ``rows_greedy``, ``prefill_batch`` (+ ``_padded``),
  ``prefill_bucket_compiles`` (novel prefill shapes),
  ``prefix_lookups`` / ``prefix_hits`` / ``prefix_hit_tokens``,
  ``chunks`` / ``chunk_tokens`` / ``partial_rows`` (chunked admission),
  ``preempted``, ``shed``, ``infeasible``, ``degraded`` /
  ``degrade_restored``, ``cancelled``, ``retries`` / ``recovered_rows``,
  ``resumed_without_prefill``, and the KV format (``kv_bits``,
  ``kv_bytes_per_slot``, ``kv_slots_per_gib``)
* the disaggregated plane (``disagg.py``, ``health.py``): ``handoffs`` /
  ``transfer_bytes`` / ``transfer_s`` per handoff,
  ``prefill_occupancy`` / ``decode_occupancy`` per front-end step,
  ``pool_deaths``, ``failovers`` / ``failover_s``, ``migrated_rows`` /
  ``replayed_rows``, ``transfer_timeouts``, ``autoscale_up`` /
  ``autoscale_down``; ``summary()`` derives
  ``transfer_bytes_per_handoff``, ``transfer_p99_s`` and
  ``failover_p50_s`` / ``failover_p99_s``
* the host KV tier (``kv_tier.py``): ``spills`` / ``spill_bytes``,
  ``fetches`` / ``fetch_bytes`` / ``fetch_s``, ``tier_evictions`` and the
  ``tier_bytes`` gauge; ``summary()`` derives ``spill_bytes_per_row`` and
  ``fetch_p99_s``.

Count-like counters surface in ``summary()`` as sums, the rest as means.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.optim.metrics import Metrics


class ServingMetrics:
    """Queue/latency/throughput counters for :class:`ServingEngine`."""

    #: THE closed finish-reason vocabulary.
    FINISH_REASONS = frozenset({
        "eos",         # the request's private eos token appeared
        "stop",        # stop-token / stop-sequence hit
        "length",      # max_new_tokens reached
        "shed",        # queue-full backpressure at submit
        "deadline",    # expired while WAITING
        "infeasible",  # feasibility admission control drop
        "error",       # fault-recovery retry budget exhausted
        "cancelled",   # caller cancel()
    })

    #: phases during which the host is blocked on the card: a readback's
    #: wait, and the draft chain's completion wait. ``decode_step`` (from
    #: dispatch to readback) overlaps host work under a dispatch-ahead
    #: window, so it is not one of them
    DEVICE_PHASES = frozenset({"fence_wait", "draft"})

    #: counters ``summary()`` reports as sums
    _SUMS = ("submitted", "finished", "retries", "recovered_rows",
             "preempted", "shed", "deadline_missed", "degraded",
             "degrade_restored", "finished_in_slo", "infeasible", "chunks",
             "chunk_tokens", "resumed_without_prefill", "handoffs",
             "transfer_bytes", "pool_deaths", "failovers", "migrated_rows",
             "replayed_rows", "transfer_timeouts", "autoscale_up",
             "autoscale_down", "spills", "fetches", "spill_bytes",
             "fetch_bytes", "tier_evictions")

    def __init__(self, backing: Optional[Metrics] = None) -> None:
        self.metrics = backing if backing is not None else Metrics()
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None
        # recent decode steps for the feasibility estimate: _admit reads
        # it every step, so it stays O(window), and a recent window
        # follows drift where a lifetime median lags
        self._step_window: deque = deque(maxlen=512)
        # the draft-phase twin: a speculative super-step's wall is its
        # verify dispatch plus its draft chain
        self._draft_window: deque = deque(maxlen=512)
        # running sums of the speculative counters for the estimate
        self._spec_acc = 0.0
        self._spec_rows = 0.0
        self._device_s = 0.0
        self._n_decode_steps = 0

    # -- engine hooks ------------------------------------------------------

    def on_submit(self) -> None:
        self.metrics.add("serving/submitted", 1.0)

    def on_step(self, queue_depth: int, occupancy: float,
                batch_active: int) -> None:
        # serve-duration anchors on the wall clock: observability, never
        # a scheduling decision (those run on the engine clock)
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
                  mean_logprob: Optional[float] = None,
                  met_deadline: Optional[bool] = None) -> None:
        self.metrics.add("serving/finished", 1.0)
        self.metrics.add("serving/latency_s", float(latency_s))
        self.metrics.add("serving/tokens_out", float(n_tokens))
        if mean_logprob is not None:
            self.metrics.add("serving/mean_logprob", float(mean_logprob))
        if met_deadline is not None:
            self.metrics.add("serving/finished_in_slo" if met_deadline
                             else "serving/deadline_missed", 1.0)

    def on_finish_reason(self, reason: str) -> None:
        if reason not in self.FINISH_REASONS:
            raise ValueError(
                f"unknown finish_reason {reason!r} — known: "
                f"{sorted(self.FINISH_REASONS)}")
        self.metrics.add(f"serving/finish_{reason}", 1.0)

    def on_preempt(self) -> None:
        self.metrics.add("serving/preempted", 1.0)

    def on_shed(self, deadline: bool = False) -> None:
        """A request shed without running; ``deadline=True`` (an expired
        or infeasible waiter) also counts as a deadline miss."""
        self.metrics.add("serving/shed", 1.0)
        if deadline:
            self.metrics.add("serving/deadline_missed", 1.0)

    def on_retry(self) -> None:
        self.metrics.add("serving/retries", 1.0)

    def on_recovered(self) -> None:
        self.metrics.add("serving/recovered_rows", 1.0)

    def on_degrade(self) -> None:
        self.metrics.add("serving/degraded", 1.0)

    def on_degrade_restored(self) -> None:
        self.metrics.add("serving/degrade_restored", 1.0)

    def on_cancel(self) -> None:
        self.metrics.add("serving/cancelled", 1.0)

    def on_sample_rows(self, n_sampled: int, n_greedy: int) -> None:
        self.metrics.add("serving/rows_sampled", float(n_sampled))
        self.metrics.add("serving/rows_greedy", float(n_greedy))

    def on_spec_step(self, n_drafted: int, n_accepted: int,
                     n_rows: int) -> None:
        """One speculative super-step: drafts proposed over the active
        rows, drafts that LANDED in outputs (confirmed and not cut by a
        stop mid-chunk), and the active rows; every row also emits one
        non-draft draw, so emitted tokens = accepted + rows."""
        self.metrics.add("serving/draft_tokens", float(n_drafted))
        self.metrics.add("serving/accepted_tokens", float(n_accepted))
        self.metrics.add("serving/spec_rows", float(n_rows))
        self._spec_acc += float(n_accepted)
        self._spec_rows += float(n_rows)

    def on_prefill_batch(self, n_rows: int, n_padded: int) -> None:
        self.metrics.add("serving/prefill_batch", float(n_rows))
        self.metrics.add("serving/prefill_batch_padded", float(n_padded))

    def on_bucket_compile(self) -> None:
        self.metrics.add("serving/prefill_bucket_compiles", 1.0)

    def on_prefix_lookup(self, matched_tokens: int,
                         total_tokens: int) -> None:
        self.metrics.add("serving/prefix_lookups", 1.0)
        if matched_tokens > 0:
            self.metrics.add("serving/prefix_hits", 1.0)
            self.metrics.add("serving/prefix_hit_tokens",
                             float(matched_tokens))

    def on_chunk(self, n_tokens: int) -> None:
        """One chunk prefill carrying ``n_tokens`` prompt tokens."""
        self.metrics.add("serving/chunks", 1.0)
        self.metrics.add("serving/chunk_tokens", float(n_tokens))

    def on_partial_rows(self, n: int) -> None:
        self.metrics.add("serving/partial_rows", float(n))

    def on_decode_gap(self, gap_s: float) -> None:
        self.metrics.add("serving/decode_gap_s", float(gap_s))

    def on_infeasible(self) -> None:
        self.metrics.add("serving/infeasible", 1.0)

    def on_resume_without_prefill(self) -> None:
        """A mid-stream row re-seated from its stashed ``row_state``."""
        self.metrics.add("serving/resumed_without_prefill", 1.0)

    # -- the disaggregated plane (disagg.py, health.py) ----------------------

    def on_handoff(self, n_bytes: int, seconds: float) -> None:
        """One prefill→decode row handoff: the packed payload's size and
        the pack + send wall on the sending clock."""
        self.metrics.add("serving/handoffs", 1.0)
        self.metrics.add("serving/transfer_bytes", float(n_bytes))
        self.metrics.add("serving/transfer_s", float(seconds))

    def on_pool_occupancy(self, prefill_occ: float, decode_occs) -> None:
        """Per front-end step: the prefill pool's peak slot occupancy and
        each active decode pool's (one sample per pool)."""
        self.metrics.add("serving/prefill_occupancy", float(prefill_occ))
        for occ in decode_occs:
            self.metrics.add("serving/decode_occupancy", float(occ))

    def on_pool_death(self) -> None:
        """A decode pool classified DEAD (silence, send failures, kill)."""
        self.metrics.add("serving/pool_deaths", 1.0)

    def on_failover(self, n_migrated: int, n_replayed: int,
                    seconds: float) -> None:
        """One pool failover: rows moved with a current payload against
        rows replayed through prefill, and the failover's wall."""
        self.metrics.add("serving/failovers", 1.0)
        if n_migrated:
            self.metrics.add("serving/migrated_rows", float(n_migrated))
        if n_replayed:
            self.metrics.add("serving/replayed_rows", float(n_replayed))
        self.metrics.add("serving/failover_s", float(seconds))

    def on_migrated(self, n_rows: int) -> None:
        """Rows moved pool to pool loss-free by a graceful drain."""
        if n_rows:
            self.metrics.add("serving/migrated_rows", float(n_rows))

    def on_transfer_timeout(self) -> None:
        """A handoff send past ``send_timeout_s``: delivery unconfirmed,
        the request resends (the receiver deduplicates)."""
        self.metrics.add("serving/transfer_timeouts", 1.0)

    def on_autoscale(self, direction: str) -> None:
        """One autoscaler action, ``"up"`` or ``"down"``."""
        if direction not in ("up", "down"):
            raise ValueError(
                f"autoscale direction must be 'up' or 'down', "
                f"got {direction!r}")
        self.metrics.add(f"serving/autoscale_{direction}", 1.0)

    # -- the host KV tier (kv_tier.py) ---------------------------------------

    def on_spill(self, n_bytes: int) -> None:
        """One row or prefix entry written into the host tier."""
        self.metrics.add("serving/spills", 1.0)
        self.metrics.add("serving/spill_bytes", float(n_bytes))

    def on_fetch(self, n_bytes: int, seconds: float) -> None:
        """One tier entry read back (readmission or prefix promotion):
        its size and the host unpack wall."""
        self.metrics.add("serving/fetches", 1.0)
        self.metrics.add("serving/fetch_bytes", float(n_bytes))
        self.metrics.add("serving/fetch_s", float(seconds))

    def on_tier_bytes(self, n_bytes: int) -> None:
        """The tier's resident bytes (a gauge)."""
        self.metrics.set("serving/tier_bytes", float(n_bytes))

    def on_tier_evict(self) -> None:
        """A tier entry evicted by the byte budget (LRU)."""
        self.metrics.add("serving/tier_evictions", 1.0)

    def set_kv_format(self, kv_dtype: str, bytes_per_slot: int) -> None:
        bits = {"fp32": 32.0, "bf16": 16.0, "int8": 8.0}.get(kv_dtype, 0.0)
        self.metrics.set("serving/kv_bits", bits)
        self.metrics.set("serving/kv_bytes_per_slot", float(bytes_per_slot))
        self.metrics.set("serving/kv_slots_per_gib",
                         float((1 << 30) // max(int(bytes_per_slot), 1)))

    def add_phase(self, name: str, seconds: float) -> None:
        self.metrics.add(f"serving/{name}_s", float(seconds))
        if name == "decode_step":
            self._step_window.append(float(seconds))
            self._n_decode_steps += 1
        elif name == "draft":
            self._draft_window.append(float(seconds))
        if name in self.DEVICE_PHASES:
            self._device_s += float(seconds)

    @property
    def device_seconds(self) -> float:
        return self._device_s

    @property
    def decode_step_count(self) -> int:
        return self._n_decode_steps

    # -- estimates and windows -----------------------------------------------

    def decode_step_estimate(self, n: int = 64) -> Optional[float]:
        """Median of the last ``n`` decode-step samples (seconds), None
        before the first: robust to the cold first step and to stalls."""
        if not self._step_window:
            return None
        return self._window_stats(list(self._step_window)[-int(n):])["p50"]

    def service_time_estimate(self) -> Optional[float]:
        """Estimated seconds per emitted token — what feasibility
        admission multiplies a request's remaining budget by: the
        decode-step median plus, on a speculative engine, the draft
        phase's median, over the measured tokens per step (1.0 plain)."""
        est = self.decode_step_estimate()
        if est is None:
            return None
        if self._draft_window:
            est += self._window_stats(list(self._draft_window)[-64:])["p50"]
        if self._spec_rows:
            est /= (self._spec_acc + self._spec_rows) / self._spec_rows
        return est

    @staticmethod
    def _window_stats(vals) -> Dict[str, float]:
        arr = np.asarray(vals, dtype=float)
        return {"n": int(arr.size), "mean": float(arr.mean()),
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}

    def window(self, name: str, n: int) -> Optional[Dict[str, float]]:
        """mean/p50/p99 (and the sample count ``n``) over the last ``n``
        samples of ``serving/<name>``; None before the first sample."""
        if n < 1:
            raise ValueError(f"window size must be >= 1, got {n}")
        vals = self._values(name)
        if not vals:
            return None
        return self._window_stats(vals[-int(n):])

    # -- derived views -----------------------------------------------------

    def _values(self, name: str) -> List[float]:
        return self.metrics.values(f"serving/{name}")

    def tokens_per_sec(self) -> float:
        """Generated tokens over the first-step → last-step window."""
        total, _ = self.metrics.get("serving/tokens_out")
        if self._t_start is None or self._t_last is None \
                or self._t_last <= self._t_start:
            return 0.0
        return total / (self._t_last - self._t_start)

    def _pctl(self, name: str, qs) -> Dict[str, float]:
        vals = self._values(name)
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

    def decode_gap_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        return self._pctl("decode_gap_s", qs)

    def transfer_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Percentiles of the per-handoff pack + send wall (seconds)."""
        return self._pctl("transfer_s", qs)

    def failover_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Percentiles of the per-failover wall (seconds)."""
        return self._pctl("failover_s", qs)

    def fetch_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        """Percentiles of the per-fetch host wall (seconds)."""
        return self._pctl("fetch_s", qs)

    def summary(self) -> Dict[str, float]:
        """Means of every counter plus throughput, percentiles and the
        count-like counters as SUMS — one flat dict."""
        out = {k: v for k, v in self.metrics.summary().items()
               if k.startswith("serving/")}
        out["serving/tokens_per_sec"] = self.tokens_per_sec()
        n_look, _ = self.metrics.get("serving/prefix_lookups")
        if n_look:
            n_hit, _ = self.metrics.get("serving/prefix_hits")
            out["serving/prefix_hit_rate"] = n_hit / n_look
        n_s, _ = self.metrics.get("serving/rows_sampled")
        n_g, _ = self.metrics.get("serving/rows_greedy")
        if n_s + n_g > 0:
            out["serving/sampled_row_frac"] = n_s / (n_s + n_g)
        for name in (*self._SUMS,
                     *(f"finish_{r}" for r in sorted(self.FINISH_REASONS))):
            total, n = self.metrics.get(f"serving/{name}")
            if n:
                out[f"serving/{name}"] = total
        n_sub, _ = self.metrics.get("serving/submitted")
        if n_sub:
            n_slo, _ = self.metrics.get("serving/finished_in_slo")
            out["serving/goodput"] = n_slo / n_sub
        n_draft, _ = self.metrics.get("serving/draft_tokens")
        n_acc, _ = self.metrics.get("serving/accepted_tokens")
        n_rows, _ = self.metrics.get("serving/spec_rows")
        if n_draft:
            out["serving/accept_rate"] = n_acc / n_draft
        if n_rows:
            out["serving/tokens_per_step"] = (n_acc + n_rows) / n_rows
        _, n_gap = self.metrics.get("serving/decode_gap_s")
        if n_gap:
            out["serving/decode_gap_p99_s"] = \
                self.decode_gap_percentiles()["p99"]
        n_hand, _ = self.metrics.get("serving/handoffs")
        if n_hand:
            nb, _ = self.metrics.get("serving/transfer_bytes")
            out["serving/transfer_bytes_per_handoff"] = nb / n_hand
            out["serving/transfer_p99_s"] = \
                self.transfer_percentiles()["p99"]
        n_sp, _ = self.metrics.get("serving/spills")
        if n_sp:
            sb, _ = self.metrics.get("serving/spill_bytes")
            out["serving/spill_bytes_per_row"] = sb / n_sp
        _, n_fe = self.metrics.get("serving/fetch_s")
        if n_fe:
            out["serving/fetch_p99_s"] = self.fetch_percentiles()["p99"]
        _, n_fo = self.metrics.get("serving/failover_s")
        if n_fo:
            fp = self.failover_percentiles()
            out["serving/failover_p50_s"] = fp["p50"]
            out["serving/failover_p99_s"] = fp["p99"]
        for metric, fn in (("ttft", self.ttft_percentiles),
                           ("decode_step", self.decode_step_percentiles),
                           ("host_step", self.host_step_percentiles)):
            for k, v in fn((50, 99)).items():
                out[f"serving/{metric}_{k}_s"] = v
        return out
