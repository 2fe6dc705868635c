"""Speculative decoding: draft and verify (``bigdl_tpu/serving/
speculative.py``).

A small DRAFT model proposes ``k`` tokens per row each super-step (``k +
1`` chained calls of the port's batched decode step); the TARGET model
scores every proposed position in ONE call of
:func:`~bigdl_tpu_torch.models.transformer.make_batch_verify_step`; each
row advances by the draws the target confirms — 1 (every draft rejected:
exactly the plain decode step) to ``k + 1``.

* **Greedy rows** verify by argmax agreement, so their output is the
  plain engine's token for token.
* **Seeded rows replay**: the verify step draws every chunk position from
  the row's own lane in order and advances it by the emitted count only,
  so a fixed-seed request emits the plain engine's stream, whatever the
  draft, the batch or the admission mode. The draft decides how many
  draws land per step, never their values: a bad draft costs steps, not
  tokens. On the int8 cache this holds bit for bit: the verify step
  merges scales and writes bytes for ACCEPTED columns only.
* **KV rollback** is pointer arithmetic on both caches: ``pos`` advances
  by the emitted count, rejected positions stay behind it as stale bytes.
  The draft loop runs ``k + 1`` steps so the k-th draft's K/V lands too.

The draft's pooled carry rides the target's slots
(:meth:`~bigdl_tpu_torch.serving.kv_pool.KVPool.attach_draft`) and
keeps a plain cache in the compute dtype whatever the engine's KV format,
as the JAX draft plane does: on an int8 engine only the target's cache is
quantized, and a rejected draft leaves no scale growth behind in the
draft's cache, so the accept rate is the JAX engine's.

With an adapter bank the verify step scores each row under its own
adapter, while drafts stay pinned to the null adapter: ``submit`` refuses
an adapted request unless it passes ``draft_tokens=0``. A constrained row
drafts nothing (its mask is per position, so a chunk would verify later
positions against a stale mask).

    eng = ServingEngine(lm, n_slots=8,
                        speculative=SpeculativeConfig(draft_lm, k=4))
    eng.submit([3, 7, 2], max_new_tokens=64)
    eng.submit([9, 9], max_new_tokens=8, draft_tokens=0)   # plain row
    eng.drain()
    eng.summary()["serving/accept_rate"]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from bigdl_tpu_torch.serving.admission import bucket_len
from bigdl_tpu_torch.serving.faults import FaultError
from bigdl_tpu_torch.serving.fences import fence, fence_wait


@dataclass(frozen=True)
class SpeculativeConfig:
    """``draft``: a TransformerLM-shaped model over the target's
    vocabulary (its ids go to the target as they are), with ``max_len``
    at least the target's, on the engine's device. ``k``: drafts
    proposed per super-step; ``submit(..., draft_tokens=)`` can lower it
    per request."""

    draft: Any
    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(
                f"k must be >= 1 (draft tokens per super-step), got "
                f"{self.k} — a k=0 engine is the plain ServingEngine")


class Speculator:
    """The engine's speculative plane: the draft model's serving state
    (params, decode and prefill steps, the pooled carry it attaches) and
    the draft → verify → emit super-step. Built by
    :class:`~bigdl_tpu_torch.serving.engine.ServingEngine` when its
    ``speculative=`` knob is set."""

    def __init__(self, engine, config, kv_quant: bool = False) -> None:
        from bigdl_tpu_torch.models.transformer import (
            make_batch_decode_step, make_batch_prefill_step,
            make_batch_verify_step, serving_params,
        )

        if not isinstance(config, SpeculativeConfig):
            config = SpeculativeConfig(draft=config)
        self.engine = engine
        self.k = int(config.k)
        self.width = self.k + 1
        draft = config.draft
        if draft[0].n_index != engine._vocab:
            raise ValueError(
                f"draft vocab {draft[0].n_index} != target vocab "
                f"{engine._vocab} — draft proposals are target token ids")
        self.draft_max_len = draft[1].max_len
        if self.draft_max_len < engine.max_len:
            raise ValueError(
                f"draft max_len {self.draft_max_len} < target max_len "
                f"{engine.max_len} — the draft cache tracks the same "
                "positions as the target's")
        if draft[0].weight.device != engine.model[0].weight.device:
            raise ValueError(
                f"the draft lives on {draft[0].weight.device} but the "
                f"target on {engine.model[0].weight.device}")
        dtype = engine.compute_dtype
        # the target's one step: the fixed-width verify step (a length-1
        # row IS plain decode), over the decode step's carry layout, each
        # row under its adapter; the draft plane below has none
        self.verify_fn, self.pool_init = make_batch_verify_step(
            engine.model, dtype, width=self.width, kv_quant=kv_quant,
            adapter=engine._adapter_spec)
        # the draft plane: plain cache in the compute dtype, greedy
        # proposals (the JAX plane's, whatever the target's KV format)
        self._draft_step_fn, self._draft_init = make_batch_decode_step(
            draft, dtype)
        self._draft_prefill_fn = make_batch_prefill_step(draft, dtype)
        self._draft_params = serving_params(draft, dtype)
        # one fresh B=1 carry for every draft prefill (prefill never
        # writes its input carry)
        self._zero_draft1 = self._draft_init(1)

    def attach_pool(self, pool) -> None:
        pool.attach_draft(self._draft_init)

    # -- admission -----------------------------------------------------------

    def prefill_draft(self, slot: int, req) -> None:
        """Ingest an admitted request's fed stream (prompt + anything
        emitted before an eviction) into the DRAFT cache; the engine
        calls it from slot configuration, so every admission path feeds
        the draft alike. A bucketed B=1 prefill, routed through the
        engine's fault hook ("prefill"); a raised FaultError reaches the
        caller, which evicts the row."""
        eng = self.engine
        fed = [t - 1 for t in req.prompt] + [t - 1 for t in req.output]
        pf = fed[:-1]
        if not pf:
            eng.pool.set_draft_pos(slot, 0)
            return
        L = bucket_len(len(pf), self.draft_max_len)
        toks = np.zeros((1, L), np.int64)
        toks[0, :len(pf)] = pf
        _, dc = eng._dispatch(
            "prefill", self._draft_prefill_fn, self._draft_params,
            eng._upload(toks), np.asarray([len(pf)], np.int64),
            self._zero_draft1)
        eng.pool.write_draft_prefill(slot, dc, len(pf))

    # -- the super-step ------------------------------------------------------

    def _draft_budget(self, slot: int, req) -> int:
        """Row ``slot``'s draft count this super-step: the engine's ``k``,
        capped by the request's ``draft_tokens`` hint and the remaining
        token budget (a chunk must not overshoot ``max_new_tokens``, or the
        lane would run ahead of the plain stream); 0 while the row's
        min-tokens ban is up or the row is constrained (the ban and the
        allow mask are per-step host state a chunk must not cross). The
        autopilot's engine-wide ``draft_cap`` caps every row."""
        k = self.k if req.draft_tokens is None \
            else min(int(req.draft_tokens), self.k)
        cap = self.engine.draft_cap
        if cap is not None:
            k = min(k, int(cap))
        if self.engine._knobs["ban"][slot] or slot in self.engine._constraints:
            k = 0
        rem = req.max_new_tokens - len(req.output)
        return max(0, min(k, rem - 1))

    def _chunk_unhealthy(self, nxt, lps, nem, lengths, active):
        """"garbage" when an active row's emit count lies outside
        ``1..lengths[r]`` or its emitted columns hold a non-finite
        log-prob or an out-of-range token, else None."""
        if not active.any():
            return None
        a_nem = nem[active]
        if (a_nem < 1).any() or (a_nem > lengths[active]).any():
            return "garbage"
        emit = np.arange(nxt.shape[1])[None, :] < nem[:, None]
        emit &= active[:, None]
        if (not np.isfinite(lps[emit]).all() or (nxt[emit] < 0).any()
                or (nxt[emit] >= self.engine._vocab).any()):
            return "garbage"
        return None

    def step(self, running) -> Dict[int, int]:
        """One draft-and-verify super-step over every running row:
        propose (up to ``k + 1`` chained draft dispatches), verify (ONE
        target dispatch and ONE readback), roll the draft cache back to
        the accepted prefix, then account the emitted tokens as the plain
        loop does, token by token, cutting a chunk at its first stop.
        Returns ``{req_id: last emitted 1-based token}``; empty when the
        step faulted (a raised dispatch, garbage outputs, a watchdog
        timeout), after every implicated row was evicted for replay."""
        eng = self.engine
        t_start = eng._clock()
        N = eng.pool.n_slots
        tokens = np.zeros((N,), np.int64)
        active = np.zeros((N,), bool)
        k_r = np.zeros((N,), np.int64)
        n_sampled = 0
        for slot, req in list(running.items()):
            if slot not in eng._configured:
                try:
                    eng._configure_slot(slot, req)
                except FaultError:
                    eng._recover_admission([(slot, req)])
                    continue
            tokens[slot] = req.next_token
            active[slot] = True
            k_r[slot] = self._draft_budget(slot, req)
            n_sampled += not req.sampling.is_greedy
        if not active.any():
            return {}
        running = {slot: req for slot, req in running.items()
                   if active[slot]}
        if eng._knobs_device is None:
            eng._knobs_device = {k: eng._upload(v)
                                 for k, v in eng._knobs.items()}
        knobs = eng._knobs_device

        # propose: kmax + 1 chained draft steps (kmax = the largest row
        # budget); step j is active for row r while j <= k_r[r], so a row's
        # last step writes its k_r-th draft's K/V
        t0 = eng._clock()
        tok_dev = eng._upload(tokens)
        u = tok_dev
        dcarry = eng.pool.draft_carry
        kmax = int(k_r[active].max())
        drafts = []
        try:
            for j in range(kmax + 1):
                act_j = eng._upload(active & (k_r >= j))
                logp_d, dcarry = eng._dispatch(
                    "draft", self._draft_step_fn, self._draft_params, u,
                    act_j, dcarry)
                u = torch.argmax(logp_d, dim=-1)
                if j < self.k:
                    drafts.append(u)
        except FaultError:
            eng._recover_step(running)
            return {}
        while len(drafts) < self.k:
            drafts.append(torch.zeros_like(tok_dev))
        # the draft timer's completion wait: the last draft step's output
        # depends on every earlier one; the drafts stay on the card
        fence_wait("draft", u)
        eng.metrics.add_phase("draft", eng._clock() - t0)

        # verify: ONE fixed-width target dispatch for every row
        lengths = np.where(active, k_r + 1, 0)
        vtoks = torch.stack([tok_dev] + drafts, dim=1)
        t0 = eng._clock()
        try:
            vt, vlp, n_emit, _ = eng._dispatch(
                "verify", self.verify_fn, eng.params, vtoks,
                eng._upload(lengths), eng.pool.carry, knobs,
                *eng._adapter_args())
        except FaultError:
            eng._recover_step(running)
            return {}
        # ONE batched readback of tokens, log-probs and emit counts. The
        # verify site consumes at once: the next super-step's draft
        # budgets are host decisions made from this readback
        t_f = eng._clock()
        nxt, lps, nem = fence("verify", vt, vlp, n_emit)
        now_f = eng._clock()
        eng.metrics.add_phase("fence_wait", now_f - t_f)
        eng.metrics.add_phase("decode_step", now_f - t0)
        bad = self._chunk_unhealthy(nxt, lps, nem, lengths, active)
        if bad is None and eng._timed_out(eng._clock() - t_start):
            bad = "timeout"
        if bad is not None:
            eng._recover_step(running)
            return {}
        eng._warm = True

        # draft rollback: the loop advanced active rows by k_r + 1; keep
        # the accepted prefix and the emission that is fed next
        dpos = dcarry["pos"]
        dcarry["pos"] = torch.where(
            eng._upload(active), dpos - (eng._upload(k_r) + 1) + n_emit,
            dpos).to(dpos.dtype)

        eng.metrics.on_step(eng.scheduler.queue_depth,
                            eng.pool.occupancy(), int(active.sum()))
        eng.metrics.on_sample_rows(n_sampled, len(running) - n_sampled)

        # emission: the per-token accounting, applied to each chunk token
        # in order and cut at the first stop (the row leaves; its lane and
        # counts ran ahead only in the freed slot)
        emitted: Dict[int, int] = {}
        n_landed = 0
        now = eng._clock()
        for slot, req in running.items():
            m = int(nem[slot])
            reason = None
            for j in range(m):
                reason = eng._account_token(slot, req, int(nxt[slot, j]),
                                            float(lps[slot, j]), now,
                                            emitted)
                n_landed += 1
                if reason is not None:
                    break
            if reason is not None:
                eng._finish_row(req, reason, now)
            else:
                req.next_token = int(nxt[slot, m - 1])
                eng._maybe_flip_ban(slot, req)
                eng._advance_constraint(slot, req)
        # counted after the cut: accepted = landed minus one non-draft
        # draw per row
        n_rows = int(active.sum())
        eng.metrics.on_spec_step(int(k_r[active].sum()), n_landed - n_rows,
                                 n_rows)
        return emitted
