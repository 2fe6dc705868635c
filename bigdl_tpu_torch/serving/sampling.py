"""Per-row sampled decoding (``bigdl_tpu/serving/sampling.py``).

:class:`SamplingParams` carries one request's knobs; :func:`make_knob_rows`
/ :func:`knob_row_values` lay them out as per-slot arrays; and
:func:`sample_rows` — fused into the decode step — turns ``(N, vocab)``
log-probs into one token and its raw model log-prob per row, every knob a
per-row tensor so greedy and sampled rows share one step.
``temperature == 0`` rows are exact argmax.

RNG lanes. The JAX lanes are threefry keys split once per draw; PyTorch
cannot reproduce those bits, so the port's lane is counter-based: row
``r`` carries ``rng[r] = (seed, draws)`` (int64) and draw number ``t``
hashes ``(seed, t, vocab index)`` to uniforms for a Gumbel-max draw
(:func:`lane_uniforms`). A row's stream therefore depends only on its
seed and its draw count — the same stream alone or batched, in any slot,
after readmission — and :func:`advance_lane` is the pure ``draws + n``.
The hash is 32-bit integer arithmetic spelled in int64 tensors, so the
CPU and the card give identical bits. Seeded replay is a contract WITHIN
the port; across frameworks only greedy rows compare.

Knob order (as in JAX): repetition penalty, presence penalty, frequency
penalty, min-tokens ban (fixed ``(N, MAX_BAN_IDS)`` id rows), then
temperature, top-k (ties at the k-th value kept),
top-p over the top-k-filtered distribution (top token always kept), and
the draw. The returned log-prob is the RAW model log-prob of the chosen
token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: Fixed width of the device-side banned-id row (eos + stop token ids
#: subject to the min-tokens ban).
MAX_BAN_IDS = 8

_M32 = 0xFFFFFFFF


def _as_tuple_of_ints(x) -> Tuple[int, ...]:
    return tuple(int(t) for t in x)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (1-based token ids, like ``submit()``).
    The default is GREEDY (``temperature=0``) with every other knob a
    no-op. ``seed=None`` asks the engine to derive a lane from its own
    seed and the request id; an explicit ``seed`` pins the stream."""

    temperature: float = 0.0
    top_k: int = 0                      # 0 = no top-k restriction
    top_p: float = 1.0                  # 1.0 = no nucleus restriction
    repetition_penalty: float = 1.0     # 1.0 = off; > 1 discourages
    presence_penalty: float = 0.0       # 0.0 = off; > 0 discourages
    frequency_penalty: float = 0.0      # 0.0 = off; > 0 discourages
    seed: Optional[int] = None          # None = engine-derived lane
    max_tokens: Optional[int] = None    # None = submit()'s max_new_tokens
    min_tokens: int = 0
    stop_token_ids: Tuple[int, ...] = ()            # 1-based ids
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()  # 1-based id runs

    def __post_init__(self):
        object.__setattr__(self, "stop_token_ids",
                           _as_tuple_of_ints(self.stop_token_ids))
        object.__setattr__(self, "stop_sequences", tuple(
            _as_tuple_of_ints(s) for s in self.stop_sequences))
        self.validate()

    def validate(self) -> None:
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must lie in (0, 1], got {self.top_p}")
        if self.repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got "
                f"{self.repetition_penalty}")
        if self.min_tokens < 0:
            raise ValueError(
                f"min_tokens must be >= 0, got {self.min_tokens}")
        if self.max_tokens is not None and self.max_tokens <= 0:
            raise ValueError(
                f"max_tokens must be positive, got {self.max_tokens}")
        if any(t <= 0 for t in self.stop_token_ids):
            raise ValueError(
                f"stop_token_ids are 1-based positive ids, got "
                f"{self.stop_token_ids}")
        if any(not s for s in self.stop_sequences) or any(
                t <= 0 for s in self.stop_sequences for t in s):
            raise ValueError(
                "stop_sequences must be non-empty runs of 1-based "
                f"positive ids, got {self.stop_sequences}")
        if len(self.stop_token_ids) > MAX_BAN_IDS - 1:
            raise ValueError(
                f"at most {MAX_BAN_IDS - 1} stop_token_ids (the device "
                f"ban row is {MAX_BAN_IDS} wide incl. eos), got "
                f"{len(self.stop_token_ids)}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


# -- counter-based RNG lanes -----------------------------------------------


def _mulmod32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) without
    overflowing int64: split ``c`` into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (xorshift-multiply rounds) on int64
    tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix32_int(x: int) -> int:
    return int(_mix32(torch.tensor(x & _M32, dtype=torch.int64)))


def lane_key(seed: int):
    """THE seed → lane rule: ``(seed, 0 draws)``."""
    return np.asarray([int(seed), 0], np.int64)


def fold_lane(seed: int, data: int):
    """A fresh lane derived from ``seed`` and ``data`` (the engine folds
    the request id into its base seed for ``seed=None`` requests)."""
    mixed = _mix32_int(_mix32_int(int(seed)) ^ (int(data) & _M32))
    return lane_key((1 << 32) | mixed)


def advance_lane(key, n: int):
    """The lane after ``n`` more draws — a pure function of the seed and
    the draw count."""
    key = np.asarray(key, np.int64).copy()
    key[1] += int(n)
    return key


def lane_uniforms(lanes, vocab: int):
    """(N, vocab) f32 uniforms in (0, 1) for each row's NEXT draw, from
    ``lanes`` (N, 2) int64 ``(seed, draws)``."""
    seed, draws = lanes[:, 0], lanes[:, 1]
    k = _mix32((seed & _M32) ^ 0x9E3779B9)
    k = _mix32(k ^ ((seed >> 32) & _M32))
    k = _mix32(k ^ (draws & _M32))
    col = _mix32(torch.arange(vocab, device=lanes.device,
                              dtype=torch.int64) + 0x632BE5AB)
    h = _mix32(k[:, None] ^ col[None, :])
    # 23 bits + 0.5 keeps every value exact in f32 and strictly inside
    # (0, 1), so the Gumbel transform never sees 0 or 1
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))


# -- knob rows -------------------------------------------------------------


def make_knob_rows(n_slots: int):
    """Host-side per-slot knob arrays in their no-op (greedy) state (the
    constrained-decoding ``allow`` mask comes with ROADMAP A.2.h)."""
    return {
        "temperature": np.zeros((n_slots,), np.float32),
        "top_k": np.zeros((n_slots,), np.int32),
        "top_p": np.ones((n_slots,), np.float32),
        "repetition_penalty": np.ones((n_slots,), np.float32),
        "presence_penalty": np.zeros((n_slots,), np.float32),
        "frequency_penalty": np.zeros((n_slots,), np.float32),
        "ban": np.zeros((n_slots,), bool),
        "ban_ids": np.full((n_slots, MAX_BAN_IDS), -1, np.int32),
    }


def knob_row_values(params: SamplingParams, eos_id: int):
    """(scalar knob dict, 0-based banned-id row) for one request;
    ``eos_id`` (1-based or -1) joins the stop tokens in the ban row."""
    ban_row = np.full((MAX_BAN_IDS,), -1, np.int32)
    ids = [eos_id] if eos_id > 0 else []
    ids += [t for t in params.stop_token_ids if t != eos_id]
    for j, t in enumerate(ids[:MAX_BAN_IDS]):
        ban_row[j] = t - 1                       # 0-based on device
    return {
        "temperature": np.float32(params.temperature),
        "top_k": np.int32(params.top_k),
        "top_p": np.float32(params.top_p),
        "repetition_penalty": np.float32(params.repetition_penalty),
        "presence_penalty": np.float32(params.presence_penalty),
        "frequency_penalty": np.float32(params.frequency_penalty),
        "ban": bool(params.min_tokens > 0 and ids),
    }, ban_row


# -- the sampler -----------------------------------------------------------


def sample_rows(logp, lanes, knobs, counts, prompt_mask):
    """The per-row sampler, fused into the decode step.

    ``logp`` (N, V) f32 log-probs; ``lanes`` (N, 2) int64; ``knobs`` the
    :func:`make_knob_rows` dict as tensors; ``counts`` (N, V) int32
    generated-token counts; ``prompt_mask`` (N, V) bool. Returns
    ``(tokens (N,) int64, chosen_logp (N,) f32, new_lanes, new_counts)``;
    the caller masks inactive rows."""
    N, V = logp.shape
    rows = torch.arange(N, device=logp.device)
    lg = logp
    # 1..3: penalties (defaults are exact no-ops: *1.0, -0.0)
    seen = (counts > 0) | prompt_mask
    lg = torch.where(seen, lg * knobs["repetition_penalty"][:, None], lg)
    lg = lg - knobs["presence_penalty"][:, None] * (counts > 0)
    lg = lg - knobs["frequency_penalty"][:, None] * counts
    # 4: min-tokens ban (fixed-width id rows; -1 pads never match)
    ban_hit = (torch.arange(V, device=logp.device)[None, None, :]
               == knobs["ban_ids"][:, :, None]).any(dim=1)
    lg = torch.where(knobs["ban"][:, None] & ban_hit, -1e30, lg)
    greedy_tok = torch.argmax(lg, dim=-1)
    # 5: temperature, then top-k / top-p in one descending sort
    temp = knobs["temperature"]
    ls = lg / torch.clamp(temp, min=1e-6)[:, None]
    sl = torch.sort(ls, dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(knobs["top_k"] > 0, knobs["top_k"], V),
                        1, V).long()
    kth = torch.gather(sl, 1, (k_eff - 1)[:, None])            # (N, 1)
    slm = torch.where(sl < kth, -1e30, sl)
    ps = torch.softmax(slm, dim=-1)
    cum = torch.cumsum(ps, dim=-1)
    # keep a token while the mass BEFORE it is < top_p
    keep = (cum - ps) < knobs["top_p"][:, None]
    cut = torch.where(keep, slm, float("inf")).amin(dim=-1)[:, None]
    ls = torch.where((ls < kth) | (ls < cut), -1e30, ls)
    # 6: the draw — Gumbel argmax over the row's own lane uniforms
    u = lane_uniforms(lanes, V)
    sampled = torch.argmax(ls - torch.log(-torch.log(u)), dim=-1)
    tok = torch.where(temp > 0.0, sampled, greedy_tok)
    chosen_logp = logp[rows, tok]                 # RAW model log-prob
    new_counts = counts.clone()
    new_counts[rows, tok] += 1
    new_lanes = lanes.clone()
    new_lanes[:, 1] += 1
    return tok, chosen_logp, new_lanes, new_counts


def match_stop_sequences(output: Sequence[int],
                         stop_sequences) -> Optional[Tuple[int, ...]]:
    """The matched sequence if ``output`` (1-based ids) ends with any of
    ``stop_sequences``, else None."""
    n = len(output)
    for seq in stop_sequences:
        k = len(seq)
        if k and n >= k and tuple(output[n - k:]) == tuple(seq):
            return tuple(seq)
    return None
