"""The port's own KV-cached decoder (``make_decode_step``,
``get_decode_step``/``get_prefill_step``, ``generate``, ``beam_generate``
in bigdl_tpu_torch/models/transformer.py) and its beam search
(bigdl_tpu_torch/nn/beam_search.py) against the JAX package's, on the CPU:

* beam search: the twins of tests/test_beam_search.py (brute force,
  greedy rollout, wider beams, eos pooling, the module facade, the carry
  gather, padding) and the JAX search on the same Markov tables;
* the decode step: the JAX step fed the same params (``load_jax_params``)
  and tokens, the full forward, runtime params against the model's own,
  bf16 against f32, and the carry layout shared with the engine's pool;
* ``generate``/``beam_generate``: the twins of tests/test_transformer.py
  (:204, :221, :245) and JAX's own outputs on prompts whose top-2 gaps
  clear ``GAP``;
* the engine held against ``generate``: the twins of
  tests/test_serving.py:136 and tests/test_serving_sampling.py:58 (greedy
  rows, fp32 and bf16), and a seeded sampled request (one stream through
  the engine and through ``generate``).

Tolerances: decode-step log-probs against JAX within 1e-5 at f32 and
5e-2 at bf16 (two frameworks' bf16 matmuls round differently; the query is
scaled and cast to bf16 before the score dot in both, so no other rounding
differs); bf16 against f32 within 0.15 with the same argmax (the JAX
test's bound); against the full forward 2e-4 (the JAX test's bound);
beam scores against JAX and against the brute-force oracle 1e-4 absolute,
sequences exactly; greedy ids against JAX exactly on gap-cleared prompts
(top-2 log-prob gap > ``GAP`` = 1e-2 at every step); within the port
(engine against ``generate``, runtime against own params) ids exactly,
and the engine's log-probs against ``generate``'s within 1e-6 (on the CPU
a row's GEMM rounding depends on the batch's row count: 3 engine rows
against 1)."""

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    make_pair, one_torch_thread, top2_gaps,
)

GAP = 1e-2


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _lm(V, hidden=16, heads=2, layers=1, max_len=24, seed=0):
    from bigdl_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(V, hidden_size=hidden, n_heads=heads,
                       n_layers=layers, max_len=max_len, device="cpu",
                       seed=seed)
    lm.evaluate()
    return lm


def _markov_step(table):
    """Logits that depend only on the previous token (the carry rides)."""
    t = torch.as_tensor(table)

    def step(params, tokens, carry):
        return t[tokens], carry

    return step


def _beam(*args, **kw):
    from bigdl_tpu_torch.nn.beam_search import beam_search

    seqs, scores = beam_search(*args, **kw)
    return seqs.numpy(), scores.numpy()


# -- beam search ---------------------------------------------------------------

def test_beam_search_exhaustive_matches_brute_force(rng):
    V, L = 4, 4
    K = V ** (L - 1)
    table = rng.randn(V, V).astype(np.float32)
    logp = np.log(np.exp(table) / np.exp(table).sum(-1, keepdims=True))
    seqs, scores = _beam(_markov_step(table), None, torch.zeros((K, 1)),
                         1, K, V, L, sos_id=0, eos_id=V + 7, alpha=0.0)
    best, best_seq = -np.inf, None
    for idx in np.ndindex(*([V] * L)):
        s, prev = 0.0, 0
        for t in idx:
            s += logp[prev, t]
            prev = t
        if s > best:
            best, best_seq = s, idx
    assert abs(float(scores[0, 0]) - best) <= 1e-4
    assert tuple(seqs[0, 0]) == best_seq


def test_greedy_beam_matches_argmax_rollout(rng):
    V, L = 6, 5
    table = rng.randn(V, V).astype(np.float32)
    seqs, _ = _beam(_markov_step(table), None, torch.zeros((2, 1)),
                    2, 1, V, L, sos_id=1, eos_id=V + 7)
    tok, want = 1, []
    for _ in range(L):
        tok = int(np.argmax(table[tok]))
        want.append(tok)
    assert list(seqs[0, 0]) == want and list(seqs[1, 0]) == want


def test_wider_beam_never_worse(rng):
    V, L = 5, 6
    table = rng.randn(V, V).astype(np.float32)
    best = {K: float(_beam(_markov_step(table), None, torch.zeros((K, 1)),
                           1, K, V, L, sos_id=0, eos_id=V + 7)[1][0, 0])
            for K in (1, 2, 4)}
    assert best[2] >= best[1] - 1e-6 and best[4] >= best[2] - 1e-6


def _eos_table(V=4, eos=3):
    table = np.full((V, V), -5.0, np.float32)
    table[1, 2] = 5.0
    table[2, eos] = 8.0
    return table


def test_eos_finishes_and_outranks():
    seqs, scores = _beam(_markov_step(_eos_table()), None,
                         torch.zeros((2, 1)), 1, 2, 4, 6, sos_id=1,
                         eos_id=3, alpha=0.6)
    assert list(seqs[0, 0][:2]) == [2, 3]
    assert np.isfinite(scores[0, 0])


def test_module_facade_tiles_carry(rng):
    from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch

    V = 5
    table = rng.randn(V, V).astype(np.float32)
    m = SequenceBeamSearch(_markov_step(table), vocab_size=V, beam_size=3,
                           decode_length=4, sos_id=0, eos_id=V + 7)
    seqs, scores = m(torch.zeros((3, 2)))
    assert tuple(seqs.shape) == (3, 3, 4) and tuple(scores.shape) == (3, 3)
    assert torch.equal(seqs[0], seqs[1])


def test_beam_search_carry_follows_parent(rng):
    """The carry is gathered by parent beam: a counting leaf equals the
    step count in every row, and logits that depend on a hash of each
    row's fed history (carried) give JAX's sequences and scores — a row
    fed another beam's history would score differently."""
    import jax.numpy as jnp

    from bigdl_tpu.nn.beam_search import beam_search as jbeam

    V, L, K, M = 5, 5, 3, 7
    table = rng.randn(V, V).astype(np.float32)
    bias = rng.randn(M, V).astype(np.float32) * 3
    seen = {}

    # the decoder state of this toy step: a step count and a history hash
    def tstep(params, tokens, state):
        h = (state["h"] * 3 + tokens + 1) % M
        seen["n"] = state["n"]
        return (torch.as_tensor(table)[tokens] + torch.as_tensor(bias)[h],
                {"n": state["n"] + 1.0, "h": h})

    def jstep(params, tokens, state):
        h = (state["h"] * 3 + tokens + 1) % M
        return (jnp.asarray(table)[tokens] + jnp.asarray(bias)[h],
                {"n": state["n"] + 1.0, "h": h})

    ts, tsc = _beam(tstep, None, {"n": torch.zeros((K,)),
                                  "h": torch.zeros((K,), dtype=torch.int64)},
                    1, K, V, L, sos_id=0, eos_id=V + 7)
    js, jsc = jbeam(jstep, None, {"n": np.zeros((K,), np.float32),
                                  "h": np.zeros((K,), np.int32)},
                    1, K, V, L, sos_id=0, eos_id=V + 7)
    assert ts.shape == (1, K, L)
    assert torch.equal(seen["n"], torch.full((K,), float(L - 1)))
    np.testing.assert_array_equal(ts, np.asarray(js))
    np.testing.assert_allclose(tsc, np.asarray(jsc), atol=1e-4, rtol=0)


def test_padding_value_blanks_after_eos():
    seqs, _ = _beam(_markov_step(_eos_table()), None, torch.zeros((2, 1)),
                    1, 2, 4, 6, sos_id=1, eos_id=3, alpha=0.6,
                    padding_value=0)
    assert list(seqs[0, 0]) == [2, 3, 0, 0, 0, 0]


@pytest.mark.parametrize("alpha,eos", [(0.0, 11), (0.6, 2)])
def test_beam_search_matches_jax(rng, alpha, eos):
    """The same Markov table through both searches: sequences exactly,
    scores within 1e-4 (eos reachable in the second case)."""
    import jax.numpy as jnp

    from bigdl_tpu.nn.beam_search import beam_search as jbeam

    V, K, L, B = 6, 3, 5, 2
    table = rng.randn(V, V).astype(np.float32) * 2

    def jstep(params, tokens, carry):
        return jnp.asarray(table)[tokens], carry

    js, jsc = jbeam(jstep, None, np.zeros((B * K, 1), np.float32), B, K, V,
                    L, sos_id=1, eos_id=eos, alpha=alpha, padding_value=-1)
    ts, tsc = _beam(_markov_step(table), None, torch.zeros((B * K, 1)), B,
                    K, V, L, sos_id=1, eos_id=eos, alpha=alpha,
                    padding_value=-1)
    np.testing.assert_array_equal(ts, np.asarray(js))
    np.testing.assert_allclose(tsc, np.asarray(jsc), atol=1e-4, rtol=0)


# -- the decode step -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_step_matches_jax(pair, rng, dtype):
    """The JAX step and the port's on the same params and tokens, 8
    steps at batch 2: log-probs within 1e-5 (f32) / 5e-2 (bf16)."""
    import jax.numpy as jnp

    from bigdl_tpu.models.transformer import make_decode_step as jmake
    from bigdl_tpu_torch.models.transformer import make_decode_step

    jlm, tlm = pair
    jdt, tdt, tol = {"fp32": (None, None, 1e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}[dtype]
    jstep, jinit = jmake(jlm, compute_dtype=jdt)
    tstep, tinit = make_decode_step(tlm, compute_dtype=tdt)
    jc, tc = jinit(2), tinit(2)
    assert tc["k0"].dtype == (tdt or torch.float32)
    toks = rng.randint(0, 29, size=(8, 2))
    for t in range(8):
        jl, jc = jstep(None, jnp.asarray(toks[t], jnp.int32), jc)
        tl, tc = tstep(None, torch.as_tensor(toks[t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=0)
    assert tc["pos"].tolist() == [8, 8]


def test_decode_step_matches_full_forward(rng):
    from bigdl_tpu_torch.models.transformer import make_decode_step

    V, T = 11, 6
    lm = _lm(V, layers=2, max_len=T)
    ids = rng.randint(1, V + 1, size=(1, T))
    with torch.no_grad():
        full = lm(torch.as_tensor(ids, dtype=torch.float32)).numpy()
    step, init = make_decode_step(lm)
    carry = init(1)
    for t in range(T):
        logp, carry = step(None, torch.as_tensor([ids[0, t] - 1]), carry)
        np.testing.assert_allclose(logp[0].numpy(), full[0, t], atol=2e-4,
                                   rtol=0)


def test_decode_step_runtime_params_match_own(rng):
    """tests/test_transformer.py:514: step(serving_params) equals
    step(None) bitwise at bf16."""
    from bigdl_tpu_torch.models.transformer import (
        make_decode_step, serving_params,
    )

    lm = _lm(21, hidden=32, heads=4, layers=2, max_len=10, seed=51)
    step, init = make_decode_step(lm, compute_dtype=torch.bfloat16)
    P = serving_params(lm, torch.bfloat16)
    c_none, c_p = init(1), init(1)
    for t in rng.randint(1, 22, size=(5,)):
        tok = torch.as_tensor([int(t) - 1])
        l_none, c_none = step(None, tok, c_none)
        l_p, c_p = step(P, tok, c_p)
    assert torch.equal(l_none, l_p)


def test_decode_step_bf16_tracks_f32(rng):
    """The bf16 half of tests/test_transformer.py:469."""
    from bigdl_tpu_torch.models.transformer import make_decode_step

    lm = _lm(27, hidden=32, heads=4, layers=2, max_len=12, seed=41)
    d32, i32 = make_decode_step(lm)
    dbf, ibf = make_decode_step(lm, compute_dtype=torch.bfloat16)
    c32, cbf = i32(1), ibf(1)
    assert cbf["k0"].dtype == torch.bfloat16
    for t in rng.randint(1, 28, size=(6,)):
        tok = torch.as_tensor([int(t) - 1])
        l32, c32 = d32(None, tok, c32)
        lbf, cbf = dbf(None, tok, cbf)
    np.testing.assert_allclose(lbf.numpy(), l32.numpy(), atol=0.15, rtol=0)
    assert int(l32.argmax()) == int(lbf.argmax())


def test_step_caches_and_carry_layout(pair):
    """get_* return the same steps per (model, dtype), a copy of the model
    builds its own, and the cache does not keep a dropped model alive; the
    decode carry is the engine pool's float layout without sampling
    state."""
    import copy
    import gc
    import weakref

    from bigdl_tpu_torch.models.transformer import (
        get_decode_step, get_prefill_step, make_batch_decode_step,
    )

    _, tlm = pair
    a = get_decode_step(tlm)
    assert get_decode_step(tlm) is a
    assert get_decode_step(tlm, torch.bfloat16) is not a
    assert get_prefill_step(tlm) is get_prefill_step(tlm)
    twin = copy.deepcopy(tlm)
    assert get_decode_step(twin) is not a
    assert get_decode_step(twin) is get_decode_step(twin)
    gone = weakref.ref(twin)
    del twin
    gc.collect()
    assert gone() is None
    carry = a[1](3)
    _, pool_init = make_batch_decode_step(tlm)
    pool = pool_init(3)
    assert carry.keys() == pool.keys()
    for k in carry:
        assert carry[k].shape == pool[k].shape
        assert carry[k].dtype == pool[k].dtype


# -- generate and beam_generate ----------------------------------------------

def test_beam_generate_transformer():
    from bigdl_tpu_torch.models.transformer import beam_generate

    V = 17
    seqs, scores = beam_generate(_lm(V), [3, 7, 2], beam_size=3,
                                 decode_length=5)
    assert seqs.shape == (3, 5)
    assert ((seqs >= 1) & (seqs <= V)).all()
    assert np.isfinite(scores).all()
    assert scores[0] >= scores[1] >= scores[2]


def test_generate_greedy_and_sampled():
    from bigdl_tpu_torch.models.transformer import generate, make_decode_step

    V = 13
    lm = _lm(V, max_len=20)
    g1 = generate(lm, [2, 5], length=6, temperature=0.0)
    g2 = generate(lm, [2, 5], length=6, temperature=0.0)
    assert (g1 == g2).all() and ((g1 >= 1) & (g1 <= V)).all()
    s1 = generate(lm, [2, 5], length=6, temperature=1.0, top_k=4, seed=1)
    assert ((s1 >= 1) & (s1 <= V)).all()
    assert (s1 == generate(lm, [2, 5], length=6, temperature=1.0, top_k=4,
                           seed=1)).all()
    step, init = make_decode_step(lm)
    carry = init(1)
    _, carry = step(None, torch.as_tensor([1]), carry)       # token 2
    logp, _ = step(None, torch.as_tensor([4]), carry)        # token 5
    assert g1[0] == int(logp[0].argmax()) + 1


def test_generate_rejects_overlong_decode():
    from bigdl_tpu_torch.models.transformer import beam_generate, generate

    lm = _lm(9, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        generate(lm, [1, 2, 3], length=10)
    with pytest.raises(ValueError, match="max_len"):
        beam_generate(lm, [1, 2], beam_size=2, decode_length=8)
    with pytest.raises(ValueError, match="non-empty"):
        generate(lm, [], length=2)
    assert generate(lm, [1, 2, 3], length=6, temperature=0.0).shape == (6,)


def test_greedy_generate_and_beam_generate_match_jax(pair, rng):
    """Greedy ``generate`` (ids and log-probs) and ``beam_generate``
    against JAX's on prompts whose greedy top-2 gaps clear GAP."""
    from bigdl_tpu.models.transformer import (
        beam_generate as jbeam, generate as jgen,
    )
    from bigdl_tpu_torch.models.transformer import beam_generate, generate

    jlm, tlm = pair
    checked = 0
    for _ in range(6):
        prompt = rng.randint(1, 30, size=(int(rng.randint(2, 7)),)).tolist()
        want, wlp = jgen(jlm, prompt, length=8, temperature=0.0,
                         return_logprobs=True)
        if top2_gaps(jlm, prompt, list(want)).min() <= GAP:
            continue
        got, glp = generate(tlm, prompt, length=8, temperature=0.0,
                            return_logprobs=True)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(glp, wlp, atol=1e-5, rtol=0)
        checked += 1
        if checked == 2:
            break
    assert checked == 2
    js, jsc = jbeam(jlm, prompt, beam_size=3, decode_length=6, eos_id=5)
    ts, tsc = beam_generate(tlm, prompt, beam_size=3, decode_length=6,
                            eos_id=5)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, atol=1e-4, rtol=0)


# -- the engine against generate ------------------------------------------------

def _mixed_requests(rng, n, plen=(1, 6), gen=(3, 12)):
    return [(rng.randint(1, 30, size=(int(rng.randint(*plen)),)).tolist(),
             int(rng.randint(*gen))) for _ in range(n)]


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_engine_parity_with_sequential_generate(pair, rng, dtype_name):
    """tests/test_serving.py:136: staggered arrivals into fewer slots than
    requests; every request's engine stream equals greedy ``generate``."""
    from bigdl_tpu_torch.models.transformer import generate
    from bigdl_tpu_torch.serving import ServingEngine

    _, tlm = pair
    dtype = None if dtype_name == "fp32" else torch.bfloat16
    reqs = _mixed_requests(rng, 7)
    eng = ServingEngine(tlm, n_slots=3, compute_dtype=dtype, device="cpu")
    ids = [eng.submit(*reqs[0]), eng.submit(*reqs[1])]
    eng.step()
    eng.step()
    ids += [eng.submit(*r) for r in reqs[2:5]]
    eng.step()
    ids += [eng.submit(*r) for r in reqs[5:]]
    outs = eng.drain()
    for rid, (prompt, n_new) in zip(ids, reqs):
        want = generate(tlm, prompt, length=n_new, temperature=0.0,
                        compute_dtype=dtype)
        np.testing.assert_array_equal(outs[rid], want,
                                      err_msg=f"{prompt} {dtype_name}")
    assert eng.pool.free_slots == eng.pool.n_slots


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_temperature_zero_matches_greedy_generate(pair, rng, dtype_name):
    """tests/test_serving_sampling.py:58: default and explicit greedy
    params on the sampled step degrade exactly to ``generate``'s argmax."""
    from bigdl_tpu_torch.models.transformer import generate
    from bigdl_tpu_torch.serving import SamplingParams, ServingEngine

    _, tlm = pair
    dtype = None if dtype_name == "fp32" else torch.bfloat16
    reqs = _mixed_requests(rng, 5, gen=(3, 10))
    eng = ServingEngine(tlm, n_slots=3, compute_dtype=dtype, device="cpu")
    ids = [eng.submit(p, max_new_tokens=n,
                      sampling=SamplingParams(temperature=0.0) if i % 2
                      else None)
           for i, (p, n) in enumerate(reqs)]
    outs = eng.drain()
    for rid, (p, n) in zip(ids, reqs):
        np.testing.assert_array_equal(
            outs[rid], generate(tlm, p, length=n, temperature=0.0,
                                compute_dtype=dtype))


def test_seeded_generate_is_the_engine_stream(pair):
    """A fixed-seed sampled request: one stream (ids and log-probs)
    through a batched engine beside other rows and through
    ``generate``."""
    from bigdl_tpu_torch.models.transformer import generate
    from bigdl_tpu_torch.serving import SamplingParams, ServingEngine

    _, tlm = pair
    sp = SamplingParams(temperature=0.9, top_k=8, top_p=0.95, seed=123,
                        repetition_penalty=1.1)
    prompt = [3, 7, 2]
    eng = ServingEngine(tlm, n_slots=3, device="cpu")
    eng.submit([5, 5, 1], max_new_tokens=6)
    rid = eng.submit(prompt, max_new_tokens=10, sampling=sp)
    eng.submit([9], max_new_tokens=4,
               sampling=SamplingParams(temperature=1.0, seed=5))
    outs = eng.drain()
    ids, lps = generate(tlm, prompt, length=10, sampling=sp,
                        return_logprobs=True)
    np.testing.assert_array_equal(outs[rid], ids)
    np.testing.assert_allclose(eng.logprobs(rid), lps, atol=1e-6, rtol=0)
