"""Per-row token-mask constrained decoding (``bigdl_tpu/serving/
constrain.py``, a copy of its host-side core).

Structured-output requests (JSON mode, tool-call grammars, fixed
templates) restrict the sampler to the tokens a grammar allows at THIS
position. Like the min-tokens ban, the restriction rides the knob rows as
runtime data of the one decode step:

* a host-side automaton (:class:`TokenDFA`) advances one state per
  EMITTED token, and
* its current state's allow-set is written into the row of the pooled
  ``(n_slots, vocab)`` bool ``allow`` knob
  (``sampling.make_knob_rows(n_slots, vocab=...)``), which
  ``sample_rows`` applies as a hard mask (disallowed logits → ``-1e30``)
  before the greedy argmax and the sampled draw.

An unconstrained row's mask is all-True, and masking with all-True is
the identity, so constrained and unconstrained rows mix in one step and
unconstrained streams stay token-identical to an engine without
constraints (pinned by tests/test_torch_serving_constrain.py).

Replay: the automaton state is a PURE function of (the request's
constraint, the emitted prefix). The engine never checkpoints a cursor:
preemption and fault recovery rebuild it by replaying ``request.output``
through :meth:`TokenDFA.cursor` (``ServingEngine._configure_slot``), so a
fixed-seed constrained stream replays draw for draw.

Token ids are 1-based throughout (the ``submit()`` convention); the mask
is written 0-based (column ``id - 1``), matching the logit layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ConstraintError(ValueError):
    """An emitted token the current automaton state does not allow:
    replaying a prefix through a DIFFERENT constraint, or a mask row that
    was never written. Raised loudly: resynchronizing quietly would emit
    grammar-violating output."""


class TokenDFA:
    """A deterministic token automaton: ``states[i]`` is ``(allow,
    edges, default)`` where

    * ``allow`` — the set of 1-based token ids permitted in this state,
      or ``None`` = unconstrained (every token permitted);
    * ``edges`` — ``{token_id: next_state}`` explicit transitions;
    * ``default`` — the next state for a permitted token with no explicit
      edge (``None`` = stay in this state).

    Prefer the factories (:func:`fixed_sequence`, :func:`from_token_sets`)
    over hand-written state tuples.
    """

    def __init__(self, states: Sequence[Tuple[Optional[frozenset],
                                              Dict[int, int],
                                              Optional[int]]],
                 start: int = 0) -> None:
        if not states:
            raise ValueError("a TokenDFA needs at least one state")
        norm = []
        for allow, edges, default in states:
            allow = None if allow is None else frozenset(
                int(t) for t in allow)
            if allow is not None and any(t <= 0 for t in allow):
                raise ValueError("allow-sets hold 1-based positive ids")
            edges = {int(t): int(s) for t, s in (edges or {}).items()}
            for t, s in edges.items():
                if not 0 <= s < len(states):
                    raise ValueError(f"edge {t}->{s} leaves the DFA")
                if allow is not None and t not in allow:
                    raise ValueError(
                        f"edge on token {t} not in the state's allow-set")
            if default is not None and not 0 <= default < len(states):
                raise ValueError(f"default state {default} out of range")
            norm.append((allow, edges, default))
        self.states = tuple(norm)
        if not 0 <= start < len(self.states):
            raise ValueError(f"start state {start} out of range")
        self.start = int(start)

    def cursor(self, prefix: Sequence[int] = ()) -> "ConstraintCursor":
        """A fresh cursor, advanced over an already-emitted ``prefix`` —
        THE replay rule (state = f(constraint, prefix))."""
        cur = ConstraintCursor(self)
        for tok in prefix:
            cur.advance(tok)
        return cur


class ConstraintCursor:
    """One row's live position in its :class:`TokenDFA` (host-side,
    engine-owned; advanced once per emitted token)."""

    __slots__ = ("dfa", "state")

    def __init__(self, dfa: TokenDFA) -> None:
        self.dfa = dfa
        self.state = dfa.start

    @property
    def allow(self) -> Optional[frozenset]:
        return self.dfa.states[self.state][0]

    def advance(self, token: int) -> None:
        token = int(token)
        allow, edges, default = self.dfa.states[self.state]
        if allow is not None and token not in allow:
            raise ConstraintError(
                f"token {token} not allowed in state {self.state} "
                f"(allowed: {sorted(allow)})")
        nxt = edges.get(token, default)
        if nxt is not None:
            self.state = nxt

    def mask_row(self, vocab: int, out=None):
        """The state's ``(vocab,)`` bool allow-mask (0-based columns);
        written into ``out`` when given (the engine passes its knob row:
        one in-place write, no allocation per step)."""
        row = np.empty((vocab,), bool) if out is None else out
        allow = self.allow
        if allow is None:
            row[:] = True
        else:
            row[:] = False
            for t in allow:
                if t <= vocab:
                    row[t - 1] = True
        return row


# -- factories --------------------------------------------------------------


def fixed_sequence(ids: Sequence[int]) -> TokenDFA:
    """Force exactly ``ids`` (1-based), then unconstrained — the template
    constraint, and the sharpest replay test (the output IS the
    constraint)."""
    ids = [int(t) for t in ids]
    if not ids or any(t <= 0 for t in ids):
        raise ValueError(
            f"fixed_sequence needs non-empty 1-based ids, got {ids}")
    states = []
    for i, t in enumerate(ids):
        states.append((frozenset((t,)), {t: i + 1}, None))
    states.append((None, {}, None))      # exhausted: unconstrained
    return TokenDFA(states)


def from_token_sets(sets: Sequence[Optional[Sequence[int]]]) -> TokenDFA:
    """Position-indexed allow-sets: step ``i`` may emit any id in
    ``sets[i]`` (``None`` = unconstrained at that position), then the
    constraint exhausts to unconstrained."""
    if not sets:
        raise ValueError("from_token_sets needs at least one position")
    states: List[tuple] = []
    for i, s in enumerate(sets):
        allow = None if s is None else frozenset(int(t) for t in s)
        states.append((allow, {}, i + 1))
    states.append((None, {}, None))
    return TokenDFA(states)
