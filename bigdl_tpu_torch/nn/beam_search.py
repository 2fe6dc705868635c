"""Sequence beam search (``bigdl_tpu/nn/beam_search.py``; reference
``nn/SequenceBeamSearch.scala``).

The JAX search is one ``lax.scan`` with static shapes; here it is a Python
loop over the decode length on fixed ``(batch, beam)`` tensors, with the
same arithmetic: alive and finished pools of ``beam`` entries each,
candidates ranked by a stable top-k (equal scores keep index order, as
``lax.top_k`` does), and the GNMT length penalty ``((5 + len) / 6) **
alpha`` on finished scores. Every leaf of the decoder's carry is gathered
by parent beam each step.

Two surfaces: :func:`beam_search`, the function, and
:class:`SequenceBeamSearch`, the module facade that tiles a per-example
carry across beams.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from bigdl_tpu_torch.nn.module import AbstractModule

_NEG = -1.0e9


def _length_penalty(length: float, alpha: float) -> float:
    return ((5.0 + length) / 6.0) ** alpha


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _top_k(x, k: int):
    """``lax.top_k`` along the last axis: the k largest, equal values in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(step_fn: Callable[[Any, Any, Any], Any], params: Any,
                init_carry: Any, batch_size: int, beam_size: int,
                vocab_size: int, decode_length: int, sos_id: int = 1,
                eos_id: int = 2, alpha: float = 0.0,
                padding_value: Optional[int] = None):
    """Run beam search.

    ``step_fn(params, tokens (B*K,), carry) -> (logits (B*K, V), carry)``;
    every tensor leaf of ``init_carry`` has leading dim ``B*K``
    (beam-major within each example). Returns ``(sequences (B, K, L)
    int64, scores (B, K) f32)`` on the carry's device, best first; an
    example with no finished beam returns its alive beams (scores
    length-penalised at L). With ``padding_value`` every position after
    an eos takes that value."""
    B, K, V, L = batch_size, beam_size, vocab_size, decode_length
    first = _first_tensor(init_carry)
    dev = first.device if first is not None else torch.device("cpu")
    base = (torch.arange(B, device=dev) * K)[:, None]

    def gather_carry(tree, parents):
        rows = (base + parents).reshape(B * K)
        return _tree_map(lambda x: x.index_select(0, rows)
                         if isinstance(x, torch.Tensor) else x, tree)

    def take(x, idx):                      # take_along_axis on axis 1
        if x.dim() == 3:
            idx = idx[:, :, None].expand(-1, -1, x.shape[2])
        return torch.gather(x, 1, idx)

    seqs = torch.full((B, K, L + 1), sos_id, dtype=torch.int64, device=dev)
    alive_logp = torch.full((B, K), _NEG, dtype=torch.float32, device=dev)
    alive_logp[:, 0] = 0.0
    fin_seq = torch.zeros((B, K, L + 1), dtype=torch.int64, device=dev)
    fin_scores = torch.full((B, K), _NEG, dtype=torch.float32, device=dev)
    fin_flags = torch.zeros((B, K), dtype=torch.bool, device=dev)
    carry = init_carry
    for t in range(L):
        logits, new_carry = step_fn(params, seqs[:, :, t].reshape(B * K),
                                    carry)
        logp = torch.log_softmax(logits.reshape(B, K, V).float(), dim=-1)
        flat = (alive_logp[..., None] + logp).reshape(B, K * V)
        top_lp, top_idx = _top_k(flat, 2 * K)
        parents = top_idx // V
        toks = top_idx % V
        seq2 = take(seqs, parents)
        seq2[:, :, t + 1] = toks

        is_eos = toks == eos_id
        fin_cand = torch.where(
            is_eos, top_lp / _length_penalty(float(t + 1), alpha), _NEG)
        all_seq = torch.cat([fin_seq, seq2], dim=1)
        all_sc = torch.cat([fin_scores, fin_cand], dim=1)
        all_fl = torch.cat([fin_flags, is_eos], dim=1)
        fin_scores, idx = _top_k(all_sc, K)
        fin_seq = take(all_seq, idx)
        fin_flags = take(all_fl, idx)

        alive_cand = torch.where(is_eos, _NEG, top_lp)
        alive_logp, a_idx = _top_k(alive_cand, K)
        seqs = take(seq2, a_idx)
        carry = gather_carry(new_carry, take(parents, a_idx))

    alive_scores = alive_logp / _length_penalty(float(L), alpha)
    has_fin = fin_flags.any(dim=1)
    out_seq = torch.where(has_fin[:, None, None], fin_seq, seqs)[:, :, 1:]
    out_scores = torch.where(has_fin[:, None], fin_scores, alive_scores)
    if padding_value is not None:
        # blank everything after the eos (the eos itself stays)
        hit = (out_seq == eos_id).long()
        out_seq = torch.where(torch.cumsum(hit, dim=-1) - hit > 0,
                              padding_value, out_seq)
    return out_seq, out_scores


class SequenceBeamSearch(AbstractModule):
    """Module facade over :func:`beam_search` (reference
    ``nn/SequenceBeamSearch.scala``): built with the decoder's
    ``symbols_to_logits(params, tokens (N,), carry) -> (logits (N, V),
    carry)``, the vocabulary, beam width, length-penalty ``alpha`` and
    ids. Its input is the per-example initial carry (a tensor or a
    dict/list of tensors with leading dim ``batch``), tiled ``beam_size``
    times here; it returns ``[sequences, scores]``."""

    def __init__(self, symbols_to_logits: Callable, vocab_size: int,
                 beam_size: int, alpha: float = 0.0, decode_length: int = 32,
                 sos_id: int = 1, eos_id: int = 2,
                 padding_value: int = 0) -> None:
        super().__init__()
        self.symbols_to_logits = symbols_to_logits
        self.vocab_size = vocab_size
        self.beam_size = beam_size
        self.alpha = alpha
        self.decode_length = decode_length
        self.sos_id = sos_id
        self.eos_id = eos_id
        self.padding_value = padding_value

    def forward(self, input, params=None):
        batch = _first_tensor(input).shape[0]
        tiled = _tree_map(
            lambda x: torch.repeat_interleave(x, self.beam_size, dim=0),
            input)
        return list(beam_search(
            self.symbols_to_logits, params, tiled, batch, self.beam_size,
            self.vocab_size, self.decode_length, self.sos_id, self.eos_id,
            self.alpha, self.padding_value))
