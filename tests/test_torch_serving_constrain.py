"""The port's constrained decoding (bigdl_tpu_torch/serving/constrain.py,
the sampler's ``allow`` mask and the engine's cursors) against the JAX
package's, on the CPU at make_pair()'s size (V=29, hidden 32, 4 heads, 2
layers, max_len 48); the twin of tests/test_serving_constrain.py without
its disaggregated test:

* ``TokenDFA``, ``ConstraintCursor`` and the factories: validation, cursor
  steps and mask rows, equal to JAX's;
* ``sample_rows`` with an ``allow`` mask against JAX's deterministic part
  (greedy rows, and a top_k=1 sampled row), and an all-True mask is the
  identity;
* forced templates come out verbatim (greedy and sampled rows), and
  constrained greedy rows equal the JAX engine's at fp32 where the free
  positions' top-2 gaps clear ``GAP``;
* a permissive constraint is the identity; base-only and constrained
  traffic share one step input layout; seeded replay through priority
  preemption; constrained rows on the speculative engine draft nothing
  and equal the plain engine; ``dispatch_ahead`` 1 and 2 with
  constrained rows are byte-identical to W=0, in batched and chunked
  admission, and chunked tokens equal batched ones.

Tolerances: tokens, masks and chosen log-probs of the sampler exactly
(f32 on the same inputs); engine log-probs against JAX ``LOGP_TOL`` 1e-4;
``GAP`` 1e-2; within the port, streams byte for byte."""

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    make_pair, one_torch_thread, top2_gaps,
)

LOGP_TOL = 1e-4
GAP = 1e-2


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _port(tlm, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    kw.setdefault("n_slots", 2)
    return ServingEngine(tlm, device="cpu", **kw)


# -- the automaton ----------------------------------------------------------------

def test_dfa_validation():
    from bigdl_tpu_torch.serving import (
        TokenDFA, fixed_sequence, from_token_sets,
    )

    with pytest.raises(ValueError, match="at least one state"):
        TokenDFA([])
    with pytest.raises(ValueError, match="1-based"):
        TokenDFA([(frozenset({0}), {}, None)])
    with pytest.raises(ValueError, match="leaves the DFA"):
        TokenDFA([(None, {3: 7}, None)])
    with pytest.raises(ValueError, match="allow-set"):
        TokenDFA([(frozenset({2}), {3: 0}, None)])
    with pytest.raises(ValueError, match="out of range"):
        TokenDFA([(None, {}, 5)])
    with pytest.raises(ValueError, match="start"):
        TokenDFA([(None, {}, None)], start=2)
    with pytest.raises(ValueError):
        fixed_sequence([])
    with pytest.raises(ValueError):
        fixed_sequence([0, 3])
    with pytest.raises(ValueError):
        from_token_sets([])


def test_cursor_advance_and_mask():
    from bigdl_tpu_torch.serving import (
        ConstraintError, fixed_sequence, from_token_sets,
    )

    dfa = fixed_sequence([4, 9])
    cur = dfa.cursor()
    assert cur.allow == frozenset({4})
    assert cur.mask_row(6).tolist() == [False, False, False, True, False,
                                        False]
    cur.advance(4)
    assert cur.allow == frozenset({9})
    with pytest.raises(ConstraintError):
        cur.advance(5)
    cur.advance(9)
    assert cur.allow is None and cur.mask_row(6).all()
    assert dfa.cursor([4, 9]).state == cur.state      # the replay rule
    with pytest.raises(ConstraintError):
        dfa.cursor([4, 5])                             # a foreign prefix
    out = np.zeros((6,), bool)
    assert from_token_sets([[2, 5]]).cursor().mask_row(6, out=out) is out
    assert out.tolist() == [False, True, False, False, True, False]
    assert fixed_sequence([99]).cursor().mask_row(6).sum() == 0


def test_dfa_matches_jax():
    """The factories make JAX's states, and every cursor step writes
    JAX's mask row."""
    from bigdl_tpu.serving import (
        fixed_sequence as jfixed, from_token_sets as jsets,
    )
    from bigdl_tpu_torch.serving import fixed_sequence, from_token_sets

    for ours, theirs, walk in (
            (fixed_sequence([4, 9, 2]), jfixed([4, 9, 2]), [4, 9, 2, 7]),
            (from_token_sets([[3, 1], None, [7]]),
             jsets([[3, 1], None, [7]]), [1, 28, 7, 5])):
        assert ours.states == theirs.states and ours.start == theirs.start
        a, b = ours.cursor(), theirs.cursor()
        for tok in walk:
            np.testing.assert_array_equal(a.mask_row(29), b.mask_row(29))
            a.advance(tok)
            b.advance(tok)
            assert a.state == b.state


# -- the sampler ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["greedy", "top_k_1", "all_true"])
def test_sample_rows_allow_matches_jax(case):
    """Random allow masks (every row keeps at least one token, one row
    keeps exactly one): the deterministic draws and chosen log-probs equal
    JAX ``sample_rows``; an all-True mask gives the mask-less sampler's
    outputs exactly."""
    import jax.numpy as jnp

    from bigdl_tpu.serving.sampling import (
        make_knob_rows as jax_knobs, sample_rows as jax_sample,
    )
    from bigdl_tpu_torch.serving.sampling import make_knob_rows, sample_rows

    N, V = 4, 29
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((N, V)).astype(np.float32) * 3
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    counts = rng.integers(0, 3, size=(N, V)).astype(np.int32)
    prompt = rng.random((N, V)) < 0.2
    knobs = make_knob_rows(N, vocab=V)
    assert knobs["allow"].shape == (N, V) and knobs["allow"].all()
    if case != "all_true":
        knobs["allow"][:] = rng.random((N, V)) < 0.3
        knobs["allow"][:, 0] = True
        knobs["allow"][1] = False
        knobs["allow"][1, 17] = True
    knobs["repetition_penalty"][:] = [1.0, 1.3, 2.0, 1.1]
    if case == "top_k_1":
        knobs["temperature"][:] = 0.7
        knobs["top_k"][:] = 1
    jk = jax_knobs(N, vocab=V)
    jk.update({k: jnp.asarray(v) for k, v in knobs.items()})
    jtok, jchosen, _, _ = jax_sample(
        jnp.asarray(logp), jnp.zeros((N, 2), jnp.uint32), jk,
        jnp.asarray(counts), jnp.asarray(prompt))
    args = (torch.from_numpy(logp), torch.zeros((N, 2), dtype=torch.int64))
    rest = (torch.from_numpy(counts), torch.from_numpy(prompt))
    tk = {k: torch.from_numpy(v) for k, v in knobs.items()}
    tok, chosen, _, _ = sample_rows(*args, tk, *rest)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
    assert knobs["allow"][np.arange(N), tok.numpy()].all()
    if case != "all_true":
        assert tok[1] == 17
    else:
        del tk["allow"]
        tok2, chosen2, _, _ = sample_rows(*args, tk, *rest)
        assert torch.equal(tok, tok2) and torch.equal(chosen, chosen2)


# -- the engine -------------------------------------------------------------------

def test_submit_validates_constraint(pair):
    _, tlm = pair
    with pytest.raises(ValueError, match="constraint"):
        _port(tlm).submit([3, 2], max_new_tokens=2, constraint=object())


def test_fixed_sequence_forces_output(pair):
    """The template overrides the model: greedy and sampled rows emit
    exactly the forced ids, then decode free; the free greedy tail equals
    the JAX engine's (gaps checked)."""
    from bigdl_tpu.serving import ServingEngine as JaxEngine
    from bigdl_tpu.serving import fixed_sequence as jfixed
    from bigdl_tpu_torch.serving import SamplingParams, fixed_sequence

    jlm, tlm = pair
    forced = [4, 9, 2]
    eng = _port(tlm, seed=11)
    r0 = eng.submit([3, 7], max_new_tokens=7,
                    constraint=fixed_sequence(forced))
    r1 = eng.submit([3, 7], max_new_tokens=5,
                    sampling=SamplingParams(temperature=0.9, top_k=10,
                                            seed=42),
                    constraint=fixed_sequence(forced))
    outs = eng.drain()
    assert list(outs[r0])[:3] == forced and list(outs[r1])[:3] == forced
    jeng = JaxEngine(jlm, n_slots=2)
    j0 = jeng.submit([3, 7], max_new_tokens=7, constraint=jfixed(forced))
    want = jeng.drain()[j0]
    assert top2_gaps(jlm, [3, 7], want.tolist())[3:].min() > GAP
    np.testing.assert_array_equal(outs[r0], want)
    np.testing.assert_allclose(eng.logprobs(r0), jeng.logprobs(j0),
                               atol=LOGP_TOL, rtol=0)
    assert not eng._constraints                  # cursors left with rows


def test_permissive_mask_is_identity(pair):
    """A constraint allowing the whole vocabulary at every position leaves
    greedy AND seeded sampled streams and their log-probs bitwise the
    unconstrained engine's."""
    from bigdl_tpu_torch.serving import SamplingParams, from_token_sets

    _, tlm = pair
    sp = SamplingParams(temperature=0.8, top_k=10, seed=77)
    full = from_token_sets([list(range(1, 30))] * 8)
    runs = []
    for cons in (None, full):
        eng = _port(tlm, seed=11)
        r = [eng.submit([3, 7, 2], max_new_tokens=8, constraint=cons),
             eng.submit([5, 1], max_new_tokens=8, sampling=sp,
                        constraint=cons)]
        o = eng.drain()
        runs.append([(o[i].tobytes(), eng.logprobs(i).tobytes())
                     for i in r])
    assert runs[0] == runs[1]


def test_constrained_and_base_traffic_share_the_step_inputs(pair):
    """One input layout for every step of unconstrained then mixed
    constrained traffic (the port's twin of zero extra compiles): the
    mask is a knob row, all-True for free rows."""
    from bigdl_tpu_torch.serving import fixed_sequence

    _, tlm = pair
    eng = _port(tlm, seed=11)
    seen = []
    step = eng._step_fn

    def recording(*args):
        flat = list(args[1:3]) + list(args[4].values())
        seen.append(tuple((tuple(t.shape), t.dtype) for t in flat))
        return step(*args)

    eng._step_fn = recording
    eng.submit([3, 7, 2], max_new_tokens=4)
    eng.submit([5, 1], max_new_tokens=4)
    eng.drain()
    eng.submit([3, 7, 2], max_new_tokens=4,
               constraint=fixed_sequence([4, 9]))
    eng.submit([5, 1], max_new_tokens=4)
    eng.drain()
    assert len(seen) == 8 and len(set(seen)) == 1


def test_constrained_replay_through_preemption(pair):
    """A fixed-seed constrained stream evicted mid-template resumes draw
    for draw: the cursor is rebuilt from the emitted prefix."""
    from bigdl_tpu_torch.serving import SamplingParams, from_token_sets

    _, tlm = pair
    cons = from_token_sets([[4, 9, 2], None, [1, 2, 3], None, [7, 8]])
    sp = SamplingParams(temperature=0.9, top_k=10, seed=31)
    base = _port(tlm)
    r0 = base.submit([3, 7, 2, 9, 4], max_new_tokens=10, sampling=sp,
                     constraint=cons)
    want = base.drain()[r0]
    eng = _port(tlm, n_slots=1, policy="priority")
    r1 = eng.submit([3, 7, 2, 9, 4], max_new_tokens=10, sampling=sp,
                    constraint=cons)
    for _ in range(3):
        eng.step()
    eng.submit([5, 5], max_new_tokens=2, priority=5)   # forces eviction
    outs = eng.drain()
    assert eng.request(r1).preemptions >= 1
    np.testing.assert_array_equal(outs[r1], want)


def test_constrained_rows_on_the_speculative_engine(pair):
    """Constrained rows draft nothing (budget 0: the mask is per
    position) and match the plain engine token for token; free rows keep
    drafting."""
    from bigdl_tpu_torch.serving import SpeculativeConfig, fixed_sequence

    _, tlm = pair
    _, draft = make_pair(hidden=16, heads=2, layers=1, seed=21)
    cons = fixed_sequence([4, 9, 2])
    base = _port(tlm, seed=7)
    b0 = base.submit([3, 7], max_new_tokens=6, constraint=cons)
    b1 = base.submit([5, 1, 8], max_new_tokens=6)
    want = base.drain()
    se = _port(tlm, seed=7, speculative=SpeculativeConfig(draft, k=3))
    budgets = []
    budget = se._spec._draft_budget

    def recording(slot, req):
        k = budget(slot, req)
        budgets.append((req.constraint is not None, k))
        return k

    se._spec._draft_budget = recording
    s0 = se.submit([3, 7], max_new_tokens=6, constraint=cons)
    s1 = se.submit([5, 1, 8], max_new_tokens=6)
    got = se.drain()
    np.testing.assert_array_equal(want[b0], got[s0])
    np.testing.assert_array_equal(want[b1], got[s1])
    assert all(k == 0 for c, k in budgets if c)
    assert any(k > 0 for c, k in budgets if not c)


@pytest.mark.parametrize("admission", ["batched", "chunked"])
def test_window_with_constrained_rows_is_byte_identical(pair, admission):
    """``dispatch_ahead`` 1 and 2 with constrained, free greedy and seeded
    rows in one pool: every stream and log-prob byte-identical to W=0 (a
    constrained row keeps the window closed), in batched and in chunked
    admission; chunked tokens equal batched ones (its log-probs differ
    by float rounding: chunks sum in another order)."""
    from bigdl_tpu_torch.serving import (
        SamplingParams, fixed_sequence, from_token_sets,
    )

    _, tlm = pair
    reqs = [([3, 7], fixed_sequence([4, 9, 2]), None),
            ([5, 1, 8, 8], None, None),
            ([2, 2, 6], from_token_sets([None, [1, 2], None, [5]]),
             SamplingParams(temperature=0.8, seed=3)),
            ([9], None, SamplingParams(temperature=0.7, top_k=5, seed=8)),
            ([4, 4, 4, 4, 4], fixed_sequence([1]), None)]
    mode = {} if admission == "batched" else {"admission": "chunked",
                                               "chunk_budget": 2}
    runs = []
    for kw in ({}, {"dispatch_ahead": 1}, {"dispatch_ahead": 2}, None):
        kw = {} if kw is None else dict(mode, **kw)
        eng = _port(tlm, n_slots=3, seed=2, **kw)
        r = [eng.submit(p, max_new_tokens=7, constraint=c, sampling=sp)
             for p, c, sp in reqs]
        o = eng.drain()
        runs.append([(o[i].tobytes(), eng.logprobs(i).tobytes())
                     for i in r])
        assert not eng._window and not eng._constraints
    assert runs[0] == runs[1] == runs[2]
    assert [t for t, _ in runs[0]] == [t for t, _ in runs[3]]
    assert list(np.frombuffer(runs[0][0][0], np.int32))[:3] == [4, 9, 2]
