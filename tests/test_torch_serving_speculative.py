"""The port's speculative decoding (bigdl_tpu_torch/serving/speculative.py
and ``make_batch_verify_step``) against the JAX package's, on the CPU at
make_pair()'s size (V=29, hidden 32, 4 heads, 2 layers, max_len 48), the
twin of tests/test_serving_speculative.py (its sharded test aside):

* ``make_batch_verify_step`` against JAX's at fp32 and int8 KV: drawn
  tokens, log-probs, ``n_emit`` and the carry (K/V, scales, ``pos``,
  counts; the lane advanced by exactly ``n_emit`` draws);
* greedy speculative output equals the port's plain engine and the JAX
  speculative engine at fp32, with a weight-tied ("good") draft and with
  an unrelated ("bad") one; at int8 it leaves the plain engine's stream
  only at a near-tie;
* int8 draft independence: two verify calls from one state whose
  REJECTED draft columns differ leave bitwise the same carry;
* seeded sampled streams replay across the speculative and plain engines
  and across the three admission modes (within the port: the RNG lanes
  differ from JAX's);
* stop conditions inside a chunk, the rollback and the draft pool's
  lifecycle, cancel between super-steps, the ``attach_draft`` guards,
  the preemption stash's draft leaf restored bitwise,
  ``Degrade(draft_tokens=)`` applied and reverted, the window knob inert,
  seeded faults recovered with the JAX engine's fault counts, and
  ``accept_rate`` / ``tokens_per_step`` equal to the JAX engine's at fp32
  and int8 KV (the draft's cache is float on both sides).

Tolerances: tokens, emit counts, counters and int carry leaves exactly;
log-probs 1e-4 and f32 caches 1e-5 (f32 math, sums in another order);
int8 caches within one quantum on at most 1% of values (a value on a
rounding boundary). Greedy streams are compared at fp32, where the chunked
verify and the single-token step agree (at bf16 an untrained near-tie may
flip between them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    make_pair, np_tree, one_torch_thread,
)

LOGP_TOL = 1e-4
F32_TOL = 1e-5
BAD = dict(seed=31, hidden=16, heads=2, layers=1)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def good():
    """A weight-tied draft (the target's seed and config): its proposals
    follow the target's greedy path, so most land."""
    return make_pair()


@pytest.fixture(scope="module")
def bad():
    """An unrelated draft (another seed, width and depth): proposals are
    noise and acceptance is near 0 — the output must not care."""
    return make_pair(**BAD)


def _port(tlm, draft=None, k=3, **kw):
    from bigdl_tpu_torch.serving import ServingEngine, SpeculativeConfig

    kw.setdefault("n_slots", 3)
    spec = None if draft is None else SpeculativeConfig(draft, k=k)
    return ServingEngine(tlm, device="cpu", speculative=spec, **kw)


def _jax(jlm, draft=None, k=3, **kw):
    from bigdl_tpu.serving import ServingEngine, SpeculativeConfig

    kw.setdefault("n_slots", 3)
    spec = None if draft is None else SpeculativeConfig(draft, k=k)
    return ServingEngine(jlm, speculative=spec, **kw)


def _reqs(seed=0, n=5):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 30, size=(int(rng.randint(1, 6)),)).tolist(),
             int(rng.randint(3, 10))) for _ in range(n)]


def _run(eng, reqs, **kw):
    rids = [eng.submit(p, max_new_tokens=n, **kw) for p, n in reqs]
    outs = eng.drain()
    return [outs[r].tolist() for r in rids]


# -- config validation --------------------------------------------------------

def test_speculative_config_validation(pair, good):
    from bigdl_tpu_torch.serving import SpeculativeConfig

    _, tlm = pair
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpeculativeConfig(good[1], k=0)
    with pytest.raises(ValueError, match="vocab"):
        _port(tlm, make_pair(V=17, seed=3)[1])
    with pytest.raises(ValueError, match="max_len"):
        _port(tlm, make_pair(max_len=24, seed=3)[1])
    eng = _port(tlm, good[1])
    with pytest.raises(ValueError, match="draft_tokens"):
        eng.submit([3], max_new_tokens=4, draft_tokens=-1)


# -- the verify step ----------------------------------------------------------

def _cache_close(got, want, key):
    if want.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, key
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0,
                                   err_msg=key)


def _verify_pair(jlm, tlm, kv_quant, width=4):
    """(JAX verify, prefill, params, knobs), (port ones): the prefill has
    written rows 0 and 1 of a 3-row sampling carry."""
    from bigdl_tpu.models import transformer as jt
    from bigdl_tpu.serving.sampling import make_knob_rows as jknob_rows
    from bigdl_tpu_torch.models import transformer as tt
    from bigdl_tpu_torch.serving.sampling import make_knob_rows

    toks = np.random.default_rng(3).integers(0, 29, size=(3, 8))
    ln = np.asarray([7, 4, 0], np.int32)
    jv, jinit = jt.make_batch_verify_step(jlm, None, width=width,
                                          kv_quant=kv_quant)
    jP = jt.serving_params(jlm, None)
    _, jc = jt.make_batch_prefill_step(jlm, None, kv_quant=kv_quant)(
        jP, jnp.asarray(toks, jnp.int32), ln, jinit(3))
    tv, tinit = tt.make_batch_verify_step(tlm, None, width=width,
                                          kv_quant=kv_quant)
    tP = tt.serving_params(tlm, None)
    with torch.no_grad():
        _, tc = tt.make_batch_prefill_step(tlm, None, kv_quant=kv_quant)(
            tP, torch.from_numpy(toks), ln.astype(np.int64), tinit(3))
    jk = {k: jnp.asarray(v) for k, v in jknob_rows(3, vocab=29).items()}
    tk = {k: torch.from_numpy(v) for k, v in make_knob_rows(3).items()}
    return (jv, jc, jP, jk), (tv, tc, tP, tk)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_verify_step_matches_jax(pair, kv):
    """Row 0 runs a 4-wide chunk whose first two drafts are the target's
    own greedy draws and whose third is not (n_emit 3), row 1 one position
    (plain decode), row 2 is ballast: tokens, log-probs, emit counts and
    every carry leaf agree with JAX, and the ballast row is untouched."""
    jlm, tlm = pair
    (jv, jc, jP, jk), (tv, tc, tP, tk) = _verify_pair(jlm, tlm,
                                                      kv == "int8")
    lengths = np.asarray([4, 1, 0], np.int32)
    fresh = lambda: jax.tree_util.tree_map(jnp.array, jc)  # noqa: E731

    def draws(row0):
        toks = np.asarray([row0, [8, 0, 0, 0], [1, 2, 3, 4]], np.int32)
        return np.asarray(jv(jP, jnp.asarray(toks), jnp.asarray(lengths),
                             fresh(), jk)[0])[0]

    d0 = int(draws([5, 0, 0, 0])[0])
    d1 = int(draws([5, d0, 0, 0])[1])
    d2 = int(draws([5, d0, d1, 0])[2])
    toks = np.asarray([[5, d0, d1, (d2 + 1) % 29],
                       [8, 0, 0, 0], [1, 2, 3, 4]], np.int32)
    jt_, jl, jn, jc2 = jv(jP, jnp.asarray(toks), jnp.asarray(lengths),
                          fresh(), jk)
    before = {k: v[2].clone() for k, v in tc.items()}
    draws0 = tc["rng"][:, 1].clone()
    with torch.no_grad():
        tt_, tl, tn, tc2 = tv(tP, torch.from_numpy(toks).long(),
                              torch.from_numpy(lengths).long(), tc, tk)
    jn, jt_, jl = np.asarray(jn), np.asarray(jt_), np.asarray(jl)
    np.testing.assert_array_equal(tn.numpy(), jn)
    assert jn.tolist() == [3, 1, 0]
    live = np.arange(4)[None] < lengths[:, None]
    np.testing.assert_array_equal(tt_.numpy()[live], jt_[live])
    np.testing.assert_allclose(tl.numpy()[live], jl[live], atol=LOGP_TOL,
                               rtol=0)
    got, want = np_tree(tc2), np_tree(jax.device_get(jc2))
    for key in want:
        if key == "rng":
            continue
        if key in ("pos", "tok_counts", "prompt_mask"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        elif key.endswith("_scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=F32_TOL,
                                       atol=0, err_msg=key)
        else:
            _cache_close(got[key], want[key], key)
    np.testing.assert_array_equal((tc2["rng"][:, 1] - draws0).numpy(), jn)
    for k, v in tc2.items():
        assert torch.equal(v[2], before[k]), k


def test_int8_draft_independence_exact(pair):
    """Two verify calls from one state whose rejected draft columns
    differ (the same accepted outcome) return bitwise the same carry:
    scales and stored bytes included, all-rejected and partly accepted."""
    from bigdl_tpu_torch.models import transformer as tt
    from bigdl_tpu_torch.serving.sampling import lane_key, make_knob_rows

    _, tlm = pair
    V = 29
    verify, init = tt.make_batch_verify_step(tlm, None, width=4,
                                             kv_quant=True)
    P = tt.serving_params(tlm, None)
    knobs = {k: torch.from_numpy(v) for k, v in make_knob_rows(2).items()}

    def call(tokens):
        c = init(2)
        c["rng"][:] = torch.from_numpy(lane_key(3))
        with torch.no_grad():
            t, _, ne, carry = verify(P, torch.tensor(tokens),
                                     torch.tensor([4, 0]), c, knobs)
        return t.numpy(), ne.numpy(), carry

    d0 = int(call([[2, 0, 0, 0], [0] * 4])[0][0, 0])
    d1 = int(call([[2, d0, 0, 0], [0] * 4])[0][0, 1])
    for n_emit, a, b in (
            (1, [2, (d0 + 1) % V, (d0 + 3) % V, (d0 + 5) % V],
             [2, (d0 + 2) % V, (d0 + 7) % V, (d0 + 11) % V]),
            (2, [2, d0, (d1 + 1) % V, (d1 + 3) % V],
             [2, d0, (d1 + 2) % V, (d1 + 7) % V])):
        _, ne_a, ca = call([a, [0] * 4])
        _, ne_b, cb = call([b, [0] * 4])
        assert ne_a[0] == ne_b[0] == n_emit
        for k, v in ca.items():
            assert torch.equal(v, cb[k]), f"rejected drafts reached {k}"


# -- greedy token identity ---------------------------------------------------

@pytest.mark.parametrize("which", ["good", "bad"])
def test_greedy_spec_matches_plain_and_jax_engines(pair, good, bad, which):
    jlm, tlm = pair
    jd, td = good if which == "good" else bad
    reqs = _reqs()
    want = _run(_port(tlm), reqs)
    eng = _port(tlm, td)
    assert _run(eng, reqs) == want
    assert eng.pool.free_slots == eng.pool.n_slots
    assert _run(_jax(jlm, jd), reqs) == want


def _model_logp(tlm, ids):
    """The f32 model's log-probs after every prefix of ``ids`` (1-based):
    (len(ids), V)."""
    x = torch.tensor([ids], dtype=torch.float32)
    with torch.no_grad():
        return torch.log_softmax(tlm(x)[0].float(), dim=-1)


def _lp_err(tlm, prompt, out, lps):
    """The largest |engine log-prob − f32 model log-prob| over one
    request's emitted tokens, the model teacher-forced on its stream."""
    lp = _model_logp(tlm, list(prompt) + list(out))
    at = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out))
    want = lp[at, torch.tensor(out) - 1].numpy()
    return float(np.abs(np.asarray(lps) - want).max())


@pytest.mark.parametrize("which", ["good", "bad"])
def test_greedy_spec_matches_plain_engine_int8(pair, good, bad, which):
    """At int8 KV every row runs to its length with valid tokens, and a
    greedy row may leave the plain int8 engine's stream only at a
    near-tie: the chunked verify reads its own columns' K/V unrounded
    where the plain step reads the int8 round trip, so the two engines'
    log-probs each lie off the f32 model's. Where a row first differs, the
    f32 model's log-probs of the two chosen tokens must lie within twice
    the larger of the two engines' measured log-prob errors (each engine
    ordered the pair its own way, so the model's gap is at most the sum
    of its two errors there)."""
    _, tlm = pair
    draft = (good if which == "good" else bad)[1]
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(1, 30, size=(int(rng.randint(1, 7)),)).tolist(),
             int(rng.randint(4, 11))) for _ in range(6)]
    runs = []
    for eng in (_port(tlm, draft, kv_dtype="int8"),
                _port(tlm, kv_dtype="int8")):
        rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = eng.drain()
        runs.append([(outs[r].tolist(), eng.logprobs(r)) for r in rids])
    for (prompt, n), (got, g_lp), (want, w_lp) in zip(reqs, *runs):
        assert len(got) == len(want) == n
        assert min(got) >= 1 and max(got) <= 29
        assert np.isfinite(g_lp).all() and (g_lp <= 0).all()
        if got == want:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        err = max(_lp_err(tlm, prompt, got[:i + 1], g_lp[:i + 1]),
                  _lp_err(tlm, prompt, want[:i + 1], w_lp[:i + 1]))
        lp = _model_logp(tlm, prompt + want[:i])[-1]
        gap = abs(float(lp[got[i] - 1] - lp[want[i] - 1]))
        assert gap <= 2 * err, (prompt, i, gap, err)


# -- seeded replay ------------------------------------------------------------

def test_seed_replay_across_spec_and_plain_engines(pair, good, bad):
    """A fixed-seed sampled request emits one stream through the plain
    engine, through speculative engines (good and bad drafts, beside a
    draft_tokens=0 sampled row and a greedy row) and after readmission
    into a recycled slot."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    sp = SamplingParams(temperature=0.9, top_k=8, top_p=0.95, seed=123)
    prompt = [3, 7, 2]
    base = _port(tlm)
    rb = base.submit(prompt, max_new_tokens=8, sampling=sp)
    want = base.drain()[rb].tolist()
    for draft in (good[1], bad[1]):
        eng = _port(tlm, draft)
        r = eng.submit(prompt, max_new_tokens=8, sampling=sp)
        eng.submit([4, 4], max_new_tokens=5, draft_tokens=0,
                   sampling=SamplingParams(temperature=1.3, seed=7))
        eng.submit([9], max_new_tokens=8)
        assert eng.drain()[r].tolist() == want
    eng1 = _port(tlm, bad[1], k=2, n_slots=1)
    eng1.submit([1, 2], max_new_tokens=3,
                sampling=SamplingParams(temperature=1.1, seed=55))
    eng1.drain()
    r2 = eng1.submit(prompt, max_new_tokens=8, sampling=sp)
    assert eng1.drain()[r2].tolist() == want


def test_seed_replay_across_admission_modes(pair, good):
    """batched, per_request and chunked admission feed the same stream
    (the draft prefill rides slot configuration)."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    sp = SamplingParams(temperature=0.8, top_k=6, seed=77)
    outs = []
    for kw in ({"admission": "batched"}, {"admission": "per_request"},
               {"admission": "chunked", "chunk_budget": 3}):
        eng = _port(tlm, good[1], n_slots=2, **kw)
        r = eng.submit([5, 9, 2, 2], max_new_tokens=7, sampling=sp)
        eng.submit([1], max_new_tokens=4)
        outs.append(eng.drain()[r].tolist())
    assert outs[0] == outs[1] == outs[2]


# -- stops, rollback, pool lifecycle ------------------------------------------

def test_stop_conditions_truncate_chunks(pair, good):
    """eos, stop tokens, stop sequences and min_tokens act as in the plain
    engine when they fire mid-chunk."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    free = _run(_port(tlm), [([3, 7], 8)])[0]
    eos = free[3]
    cut = free.index(eos)
    eng = _port(tlm, good[1], n_slots=2)
    a = eng.submit([3, 7], max_new_tokens=8, eos_id=eos)
    b = eng.submit([3, 7], max_new_tokens=8)
    outs = eng.drain()
    assert outs[a].tolist() == free[:cut + 1]
    assert outs[b].tolist() == free
    assert eng.request(a).done_reason == "eos"
    assert eng.request(b).done_reason == "length"
    st = free[2]
    c = eng.submit([3, 7], max_new_tokens=8,
                   sampling=SamplingParams(stop_token_ids=(st,)))
    out_c = eng.drain()[c].tolist()
    assert out_c == free[:free.index(st) + 1]
    assert eng.request(c).finish_reason == "stop"
    seq = tuple(free[1:3])
    d = eng.submit([3, 7], max_new_tokens=8,
                   sampling=SamplingParams(stop_sequences=(seq,)))
    out_d = eng.drain()[d].tolist()
    assert tuple(out_d[-2:]) == seq and len(out_d) <= 3
    e = eng.submit([3, 7], max_new_tokens=8, eos_id=eos,
                   sampling=SamplingParams(min_tokens=6))
    out_e = eng.drain()[e].tolist()
    base = _port(tlm)
    e2 = base.submit([3, 7], max_new_tokens=8, eos_id=eos,
                     sampling=SamplingParams(min_tokens=6))
    assert out_e == base.drain()[e2].tolist()
    assert len(out_e) >= 6 and eos not in out_e[:5]


def test_rollback_and_draft_pool_lifecycle(pair, bad):
    """A long generation through a rejecting draft (rollback every step)
    matches the plain engine; both position counters reset with their
    slots; draft-pool misuse raises."""
    _, tlm = pair
    reqs = [([3, 7, 2], 20)]
    eng = _port(tlm, bad[1], n_slots=2)
    assert _run(eng, reqs) == _run(_port(tlm), reqs)
    assert eng.pool.free_slots == eng.pool.n_slots
    assert not eng.pool.carry["pos"].any()
    assert not eng.pool.draft_carry["pos"].any()
    with pytest.raises(ValueError, match="not allocated"):
        eng.pool.set_draft_pos(0, 3)


def test_cancel_running_mid_chunk(pair, good):
    """Cancelling a running row between super-steps frees its target and
    draft rows at once and freezes its output; a row admitted into the
    recycled slot decodes as the plain engine does."""
    _, tlm = pair
    plain = _run(_port(tlm), [([5, 1], 12), ([9], 5)])
    eng = _port(tlm, good[1], n_slots=2)
    a = eng.submit([3, 7, 2], max_new_tokens=20)
    b = eng.submit([5, 1], max_new_tokens=12)
    eng.step()
    eng.step()
    assert eng.cancel(a)
    frozen = list(eng.request(a).output)
    assert frozen and len(frozen) < 20
    assert eng.request(a).state == "cancelled"
    assert eng.pool.free_slots == 1
    assert not eng.cancel(a)
    c = eng.submit([9], max_new_tokens=5)
    outs = eng.drain()
    assert a not in outs and list(eng.request(a).output) == frozen
    assert [outs[b].tolist(), outs[c].tolist()] == plain
    assert not eng.pool.carry["pos"].any()
    assert not eng.pool.draft_carry["pos"].any()


def test_attach_draft_guards(pair, good):
    _, tlm = pair
    eng = _port(tlm, good[1], n_slots=2)
    with pytest.raises(ValueError, match="already attached"):
        eng.pool.attach_draft(eng._spec._draft_init)
    plain = _port(tlm, n_slots=2)
    with pytest.raises(ValueError, match="no draft carry"):
        plain.pool.set_draft_pos(0, 0)


# -- preemption, degrade, window, faults --------------------------------------

def test_preemption_stash_restores_the_draft_leaf_bitwise(pair, good):
    """A preempted speculative row's stash carries its draft row; every
    restore writes it back bitwise, and every stream equals the plain
    engine's."""
    _, tlm = pair
    reqs = [([3, 7, 2], 20), ([5, 1], 18), ([9], 6), ([4, 4, 4, 4], 8)]
    want = _run(_port(tlm, n_slots=2), reqs)
    eng = _port(tlm, good[1], n_slots=2, policy="priority")
    restored = []
    restore = eng.pool.restore_row

    def restore_and_snapshot(slot, payload):
        restore(slot, payload)
        restored.append((payload["draft"], eng.pool.row_state(slot)["draft"]))

    eng.pool.restore_row = restore_and_snapshot
    low = [eng.submit(p, max_new_tokens=n) for p, n in reqs[:2]]
    eng.step()
    hi = [eng.submit(p, max_new_tokens=n, priority=5) for p, n in reqs[2:]]
    outs = eng.drain()
    assert [outs[r].tolist() for r in low + hi] == want
    assert eng.metrics.summary()["serving/preempted"] >= 1 and restored
    for stash, after in restored:
        assert set(stash) == set(after)
        for k, v in stash.items():
            assert torch.equal(after[k], v), k


def test_degrade_draft_tokens_applies_and_reverts(pair, good):
    from bigdl_tpu_torch.serving import Degrade

    _, tlm = pair
    with pytest.raises(ValueError, match="draft_tokens"):
        Degrade(draft_tokens=-1)
    eng = _port(tlm, good[1], n_slots=1, degrade_at=1)
    eng.submit([3, 7], max_new_tokens=6)
    r = eng.submit([5, 1], max_new_tokens=6, draft_tokens=3,
                   degrade=Degrade(max_new_tokens=4, draft_tokens=0))
    eng.submit([9], max_new_tokens=3)
    eng.drain()
    done = eng.request(r)
    assert done.degraded and done.draft_tokens == 0
    assert len(done.output) == 4
    # the revert half, on a request that still waits
    from bigdl_tpu_torch.serving import Request

    w = Request(req_id=99, prompt=[1], max_new_tokens=8, draft_tokens=2,
                degrade=Degrade(max_new_tokens=3, draft_tokens=0))
    assert eng._apply_degrade(w)
    assert (w.max_new_tokens, w.draft_tokens) == (3, 0)
    assert eng._restore_degrade(w)
    assert (w.max_new_tokens, w.draft_tokens, w.degraded) == (8, 2, False)


def test_window_knob_is_inert_on_a_speculative_engine(pair, good):
    _, tlm = pair
    reqs = _reqs()
    eng = _port(tlm, good[1], dispatch_ahead=2)
    assert _run(eng, reqs) == _run(_port(tlm), reqs)
    assert not eng._window


@pytest.mark.parametrize("seed", [1, 2])
def test_seeded_faults_recover_with_the_jax_fault_counts(pair, good, seed):
    """Failed and garbage draft, verify and prefill dispatches: every
    stream recovers to the plain engine's, and the JAX speculative engine
    on the same schedule counts the same faults and retries."""
    from bigdl_tpu.serving import FaultInjector as JInj
    from bigdl_tpu.serving import WatchdogConfig as JWd
    from bigdl_tpu_torch.serving import FaultInjector, WatchdogConfig

    jlm, tlm = pair
    reqs = _reqs()
    kw = dict(seed=seed, p_fail=0.1, p_garbage=0.1, p_admit_fail=0.1)
    eng = _port(tlm, good[1], watchdog=WatchdogConfig(max_retries=None),
                faults=FaultInjector(**kw))
    assert _run(eng, reqs) == _run(_port(tlm), reqs)
    assert eng._faults.total > 0
    jeng = _jax(jlm, good[0], watchdog=JWd(max_retries=None),
                faults=JInj(**kw))
    _run(jeng, reqs)
    assert {k: v for k, v in jeng._faults.counts.items()
            if k in eng._faults.counts} == eng._faults.counts
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    assert s["serving/retries"] == js["serving/retries"]


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_spec_metrics_match_jax(pair, good, kv):
    """draft_tokens / accepted_tokens / spec_rows per super-step, and
    summary()'s accept_rate and tokens_per_step, equal the JAX engine's;
    emitted tokens = accepted + row-steps. At int8 KV too: the draft
    plane keeps a float cache on both sides, so the accept rate is not
    the port's own."""
    jlm, tlm = pair
    reqs = [([3, 7], 8), ([5, 1], 8), ([9], 6)]
    eng = _port(tlm, good[1], n_slots=2, kv_dtype=kv)
    outs = _run(eng, reqs, draft_tokens=None)
    jeng = _jax(jlm, good[0], n_slots=2, kv_dtype=kv)
    assert _run(jeng, reqs) == outs
    m = eng.metrics.metrics
    n_acc, _ = m.get("serving/accepted_tokens")
    n_rows, _ = m.get("serving/spec_rows")
    assert n_acc + n_rows == sum(len(o) for o in outs)
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    for key in ("serving/accept_rate", "serving/tokens_per_step"):
        assert s[key] == pytest.approx(js[key], rel=1e-12), key
    assert s["serving/tokens_per_step"] > 1.0
    for name in ("draft_tokens", "accepted_tokens", "spec_rows"):
        assert m.get(f"serving/{name}")[0] == \
            jeng.metrics.metrics.get(f"serving/{name}")[0], name
