"""The port's multi-tenant LoRA serving (bigdl_tpu_torch/serving/lora.py,
the adapted steps of models/transformer.py and the engine's adapter
plane) against the JAX package's, on the CPU at make_pair()'s size (V=29,
hidden 32, 4 heads, 2 layers, max_len 48); the twin of
tests/test_serving_lora.py without its sharded and disaggregated tests:

* the bank: site shapes, keys and arrays equal to the JAX bank's after
  the same ``alloc``/``free`` calls, and the slot lifecycle;
* the gathered delta (``_lora_product`` over ``_gather_factors``) against
  JAX's ``_adapter_delta`` for decode ``(N, in)`` and chunk
  ``(N, S, in)`` inputs, f32 and bf16 ``h``;
* the prefill, decode and verify steps built with ``adapter=`` against
  JAX's with the same bank, at fp32 and int8 KV;
* adapted greedy rows equal to the JAX engine's at fp32, on requests
  whose top-2 gaps under their own adapter clear ``GAP``, log-probs
  within ``LOGP_TOL``;
* the null-adapter identity: a bank-ed engine serving only id-0 traffic
  is bitwise the bank-less engine (tokens and log-probs), fp32 and bf16,
  float and int8 KV;
* validation, refcounts released on every terminal path, seeded replay
  through preemption, the preemption stash's adapter id, the prefix
  cache's adapter namespaces (a freed and re-alloc'd slot's new tenant
  never reads its predecessor's K/V), chunked admission, one input layout for
  base-only and mixed traffic, and the speculative draft pin.

Tolerances: tokens and integer carry leaves exactly; the delta
1e-5 relative and absolute (f32 products, sums in another order);
log-probs ``LOGP_TOL`` 1e-4 and f32 caches 1e-5 of their largest value
(the amplitude-1 factors put K/V values near 50); int8 caches within one
quantum on at most 1% of values (a value on a rounding boundary), their
scales 1e-5 relative; ``GAP`` 1e-2."""

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
GAP = 1e-2


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _banks(jlm, tlm, rank=2, n_slots=4, seeds=(1, 2), amp=1.0):
    """(JAX bank, port bank) with the same tenants alloc'd in the same
    order (visible amplitude: adapted streams really diverge)."""
    from bigdl_tpu.serving import AdapterBank as JaxBank
    from bigdl_tpu_torch.serving import AdapterBank

    jb, tb = JaxBank(jlm, rank, n_slots), AdapterBank(tlm, rank, n_slots)
    for s in seeds:
        assert jb.alloc(jb.random_factors(s, amp)) == \
            tb.alloc(tb.random_factors(s, amp))
    return jb, tb


@pytest.fixture(scope="module")
def banks(pair):
    return _banks(*pair)


def _trace(vocab=29, n=6, seed=3):
    from bigdl_tpu_torch.serving import SamplingParams

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        prompt = rng.randint(1, vocab + 1, size=([3, 7, 5][i % 3],)).tolist()
        sp = (SamplingParams(temperature=0.8, top_k=10, seed=100 + i)
              if i % 2 else None)
        out.append((prompt, 6, sp))
    return out


def _port(tlm, bank=None, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    kw.setdefault("n_slots", 3)
    return ServingEngine(tlm, device="cpu", adapters=bank, **kw)


# -- the bank -------------------------------------------------------------------

def test_bank_matches_the_jax_bank(pair, banks):
    from bigdl_tpu.models.transformer import adapter_site_shapes as jshapes
    from bigdl_tpu_torch.models.transformer import (
        ADAPTER_SITES, adapter_site_shapes,
    )

    jlm, tlm = pair
    assert adapter_site_shapes(tlm) == jshapes(jlm)
    assert set(adapter_site_shapes(tlm)[0]) == set(ADAPTER_SITES)
    jb, tb = _banks(jlm, tlm, n_slots=3, seeds=(5, 6))
    ts, js = tb.spec, jb.spec
    # the port's delta is unscaled: JAX's default scale, alpha = rank
    assert (ts.rank, ts.n_slots, 1.0) == (js.rank, js.n_slots, js.scale)
    tb.free(1)
    jb.free(1)
    assert tb.alloc(tb.random_factors(7)) == jb.alloc(jb.random_factors(7))
    assert list(tb.arrays) == list(jb.arrays)
    for k in jb.arrays:
        np.testing.assert_array_equal(tb.arrays[k], jb.arrays[k], err_msg=k)
    assert tb.live == jb.live and tb.version == jb.version
    dev = tb.device_arrays("cpu")
    for k, v in dev.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), tb.arrays[k])
        assert v.data_ptr() != tb.arrays[k].ctypes.data     # a copy


def test_bank_lifecycle_and_validation(pair):
    from bigdl_tpu_torch.serving import AdapterBank

    _, tlm = pair
    b = AdapterBank(tlm, rank=2, n_slots=3)
    assert b.n_free == 2                    # slot 0 is the null adapter
    factors = b.random_factors(seed=5)
    aid = b.alloc(factors)
    assert aid != 0 and b.is_live(aid) and b.live == {aid: 1}
    v = b.version
    b.retain(aid)
    assert b.live[aid] == 2
    b.free(aid)
    assert b.is_live(aid) and b.version == v
    b.free(aid)
    assert not b.is_live(aid) and b.n_free == 2 and b.version == v + 1
    for k in b.arrays:                      # freed rows are zeroed
        assert not np.any(b.arrays[k][aid])
    # a namespace names one allocation: the slot's next tenant gets another
    ns = b.namespaces()
    with pytest.raises(KeyError):
        b.namespace(aid)
    assert b.alloc(factors) == aid and b.namespace(0) == 0
    assert b.namespace(aid) not in ns and b.namespaces() == ns | {
        b.namespace(aid)}
    b.free(aid)
    with pytest.raises(ValueError):
        b.free(0)
    b.retain(0)                             # no-op
    with pytest.raises(KeyError):
        b.alloc({"nope_a": np.zeros((2, 2), np.float32)})
    bad = dict(factors)
    bad[next(iter(bad))] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError):
        b.alloc(bad)
    b.alloc(b.random_factors(seed=6))
    b.alloc(b.random_factors(seed=7))
    with pytest.raises(RuntimeError):
        b.alloc(b.random_factors(seed=8))
    with pytest.raises(KeyError):
        b.retain(99)
    with pytest.raises(ValueError):
        AdapterBank(tlm, rank=0)
    with pytest.raises(ValueError):
        AdapterBank(tlm, rank=2, n_slots=1)


# -- the delta -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", ["decode", "chunk"])
def test_adapter_delta_matches_jax(banks, shape, dtype):
    from bigdl_tpu.models.transformer import _adapter_delta as jdelta
    from bigdl_tpu_torch.models.transformer import (
        _gather_factors, _lora_product,
    )

    jb, tb = banks
    ids = np.asarray([2, 0, 1, 2], np.int64)
    size = (4, 32) if shape == "decode" else (4, 5, 32)
    h = np.random.default_rng(4).normal(size=size).astype(np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    if dtype == "bf16":
        jh, th = jh.astype(jnp.bfloat16), th.to(torch.bfloat16)
        np.testing.assert_array_equal(
            np.asarray(jh.astype(jnp.float32)), th.float().numpy())
    jbank = {k: jnp.asarray(v) for k, v in jb.arrays.items()}
    bank = tb.device_arrays("cpu")
    for site in ("wq1", "fc10", "fc20"):
        if site == "fc20":             # its input is the 4x-wide MLP
            h2 = np.random.default_rng(5).normal(
                size=size[:-1] + (128,)).astype(np.float32)
            jh, th = jnp.asarray(h2), torch.from_numpy(h2)
            if dtype == "bf16":
                jh, th = jh.astype(jnp.bfloat16), th.to(torch.bfloat16)
        want = np.asarray(jdelta(jbank, site, jnp.asarray(ids, jnp.int32),
                                 jh, 1.0))
        got = _lora_product(*_gather_factors(bank, torch.from_numpy(ids),
                                             site), th.float())
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=site)
        assert not got.numpy()[1].any()       # the null adapter: exact 0


def test_a_bank_elsewhere_raises(pair, banks):
    """The ids and the bank must live on the step's device; a bank
    elsewhere raises instead of being moved."""
    from bigdl_tpu_torch.models import transformer as tt

    _, tlm = pair
    _, tb = banks
    step, init = tt.make_batch_decode_step(tlm, None, adapter=tb.spec)
    params = tt.serving_params(tlm, None)
    toks = torch.zeros((2,), dtype=torch.int64)
    act = torch.ones((2,), dtype=torch.bool)
    ids = torch.zeros((2,), dtype=torch.int64)
    meta = {k: torch.empty(v.shape, device="meta")
            for k, v in tb.arrays.items()}
    with torch.no_grad():
        with pytest.raises(ValueError, match="bank lives on meta"):
            step(params, toks, act, init(2), ids, meta)
        with pytest.raises(ValueError, match="adapter_ids"):
            step(params, toks, act, init(2), ids.to("meta"),
                 tb.device_arrays("cpu"))
        with pytest.raises(ValueError, match="adapter"):
            step(params, toks, act, init(2))


# -- the three steps ------------------------------------------------------------

def _cache_close(got, want, key):
    if want.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, key
    elif key.endswith("_scale"):
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=0,
                                   err_msg=key)
    else:
        np.testing.assert_allclose(
            got, want, atol=F32_TOL * max(1.0, np.abs(want).max()), rtol=0,
            err_msg=key)


def _carry_close(tc, jc, skip=("rng",)):
    got, want = np_tree(tc), np_tree(jax.device_get(jc))
    for key in want:
        if key in skip:
            continue
        if key in ("pos", "tok_counts", "prompt_mask"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            _cache_close(got[key], want[key], key)


def _prefilled(jlm, tlm, jb, tb, kv_quant, sampling):
    """Both frameworks' adapted prefill of rows 0-1 of a 3-row carry
    (row 2 ballast), ids [1, 2, 0]: (JAX carry, port carry, the adapter
    args of each, params of each)."""
    from bigdl_tpu.models import transformer as jt
    from bigdl_tpu_torch.models import transformer as tt

    toks = np.random.default_rng(3).integers(0, 29, size=(3, 8))
    ln = np.asarray([7, 4, 0], np.int32)
    ids = np.asarray([1, 2, 0])
    jargs = (jnp.asarray(ids, jnp.int32),
             {k: jnp.asarray(v) for k, v in jb.arrays.items()})
    targs = (torch.from_numpy(ids), tb.device_arrays("cpu"))
    _, jinit = jt.make_batch_decode_step(jlm, None, sampling=sampling,
                                         kv_quant=kv_quant)
    _, tinit = tt.make_batch_decode_step(tlm, None, sampling=sampling,
                                         kv_quant=kv_quant)
    jP, tP = jt.serving_params(jlm, None), tt.serving_params(tlm, None)
    jlp, jc = jt.make_batch_prefill_step(
        jlm, None, kv_quant=kv_quant, carry_sampling=sampling,
        adapter=jb.spec)(jP, jnp.asarray(toks, jnp.int32), ln, jinit(3),
                         *jargs)
    with torch.no_grad():
        tlp, tc = tt.make_batch_prefill_step(
            tlm, None, kv_quant=kv_quant, adapter=tb.spec)(
            tP, torch.from_numpy(toks), ln.astype(np.int64), tinit(3),
            *targs)
    return (jlp, jc, jargs, jP), (tlp, tc, targs, tP)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("step", ["prefill", "decode", "verify"])
def test_adapted_steps_match_jax(pair, banks, step, kv):
    """Rows 0 and 1 under tenants 1 and 2, row 2 ballast under the null
    adapter: each step's log-probs (or draws) and carry agree with JAX's
    built with the same bank; the ballast row's carry is untouched."""
    from bigdl_tpu.models import transformer as jt
    from bigdl_tpu.serving.sampling import make_knob_rows as jknob_rows
    from bigdl_tpu_torch.models import transformer as tt
    from bigdl_tpu_torch.serving.sampling import make_knob_rows

    jlm, tlm = pair
    jb, tb = banks
    kv_quant = kv == "int8"
    (jlp, jc, jargs, jP), (tlp, tc, targs, tP) = _prefilled(
        jlm, tlm, jb, tb, kv_quant, sampling=step == "verify")
    if step == "prefill":
        np.testing.assert_allclose(tlp.numpy()[:2], np.asarray(jlp)[:2],
                                   atol=LOGP_TOL, rtol=0)
        _carry_close(tc, jc)
        return
    before = {k: v[2].clone() for k, v in tc.items()}
    if step == "decode":
        jstep, _ = jt.make_batch_decode_step(jlm, None, kv_quant=kv_quant,
                                             adapter=jb.spec)
        tstep, _ = tt.make_batch_decode_step(tlm, None, kv_quant=kv_quant,
                                             adapter=tb.spec)
        toks = np.asarray([5, 11, 0])
        act = np.asarray([True, True, False])
        jout, jc2 = jstep(jP, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(act), jc, *jargs)
        with torch.no_grad():
            tout, tc2 = tstep(tP, torch.from_numpy(toks),
                              torch.from_numpy(act), tc, *targs)
        np.testing.assert_allclose(tout.numpy()[:2], np.asarray(jout)[:2],
                                   atol=LOGP_TOL, rtol=0)
    else:
        jv, _ = jt.make_batch_verify_step(jlm, None, width=3,
                                          kv_quant=kv_quant, adapter=jb.spec)
        tv, _ = tt.make_batch_verify_step(tlm, None, width=3,
                                          kv_quant=kv_quant, adapter=tb.spec)
        toks = np.asarray([[5, 7, 2], [11, 0, 0], [1, 2, 3]])
        lengths = np.asarray([3, 1, 0])
        jk = {k: jnp.asarray(v) for k, v in jknob_rows(3, vocab=29).items()}
        tk = {k: torch.from_numpy(v)
              for k, v in make_knob_rows(3, vocab=29).items()}
        jt_, jl, jn, jc2 = jv(jP, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(lengths, jnp.int32), jc, jk, *jargs)
        with torch.no_grad():
            tt_, tl, tn, tc2 = tv(tP, torch.from_numpy(toks),
                                  torch.from_numpy(lengths), tc, tk, *targs)
        jn = np.asarray(jn)
        np.testing.assert_array_equal(tn.numpy(), jn)
        emit = np.arange(3)[None] < jn[:, None]
        np.testing.assert_array_equal(tt_.numpy()[emit],
                                      np.asarray(jt_)[emit])
        np.testing.assert_allclose(tl.numpy()[emit], np.asarray(jl)[emit],
                                   atol=LOGP_TOL, rtol=0)
    _carry_close(tc2, jc2)
    for k, v in tc2.items():
        assert torch.equal(v[2], before[k]), k


def test_no_adapter_step_is_the_plain_step(pair, banks):
    """A step built with an adapter, fed only null-adapter rows, equals
    the step built without one bitwise (the delta adds an exact 0.0)."""
    from bigdl_tpu_torch.models import transformer as tt

    _, tlm = pair
    _, tb = banks
    plain, init = tt.make_batch_decode_step(tlm, None, kv_quant=True)
    adapted, _ = tt.make_batch_decode_step(tlm, None, kv_quant=True,
                                           adapter=tb.spec)
    params = tt.serving_params(tlm, None)
    toks = torch.tensor([3, 9, 1])
    act = torch.tensor([True, True, False])
    args = (torch.zeros((3,), dtype=torch.int64), tb.device_arrays("cpu"))
    with torch.no_grad():
        a, ca = plain(params, toks, act, init(3))
        b, cb = adapted(params, toks, act, init(3), *args)
        c, _ = adapted(params, toks, act, cb, *args)   # reuses the gathers
        d, _ = plain(params, toks, act, ca)
    assert torch.equal(a, b) and torch.equal(c, d)
    for k in ca:
        assert torch.equal(ca[k], cb[k]), k


# -- the engine -----------------------------------------------------------------

def test_engine_submit_validation(pair, banks):
    from bigdl_tpu_torch.serving import ServingEngine

    _, tlm = pair
    _, tb = banks
    eng = _port(tlm, tb, n_slots=2)
    with pytest.raises(ValueError, match="adapter"):
        eng.submit([3, 2], max_new_tokens=2, adapter_id=3)   # not live
    with pytest.raises(ValueError, match="adapter"):
        _port(tlm).submit([3, 2], max_new_tokens=2, adapter_id=1)
    with pytest.raises(ValueError, match="adapters require"):
        ServingEngine(tlm, n_slots=2, device="cpu", adapters=tb,
                      admission="per_request")
    assert eng.summary().get("serving/submitted", 0) == 0
    assert tb.live == {1: 1, 2: 1}


def _adapted_gaps(jlm, jb, prompt, output, aid):
    """Top-1 minus top-2 log-prob at each generated position under the
    request's adapter, teacher-forced through the JAX adapted prefill."""
    from bigdl_tpu.models import transformer as jt

    prefill = jt.make_batch_prefill_step(jlm, None, adapter=jb.spec)
    _, init = jt.make_batch_decode_step(jlm, None)
    P = jt.serving_params(jlm, None)
    bank = {k: jnp.asarray(v) for k, v in jb.arrays.items()}
    seq = [t - 1 for t in prompt + list(output[:-1])]
    n = len(output)
    toks = np.zeros((n, 24), np.int32)
    ln = np.zeros((n,), np.int32)
    for i in range(n):
        m = len(prompt) + i
        toks[i, :m] = seq[:m]
        ln[i] = m
    lp, _ = prefill(P, jnp.asarray(toks), ln, init(n),
                    jnp.full((n,), aid, jnp.int32), bank)
    lp = np.asarray(lp)
    gaps = []
    for i, tok in enumerate(output):
        gaps.append(lp[i, tok - 1] - np.delete(lp[i], tok - 1).max())
    return np.asarray(gaps)


def test_adapted_greedy_rows_match_the_jax_engine(pair, banks):
    """Base and two tenants round-robin, more requests than slots: greedy
    tokens equal JAX's at fp32 (every position's gap under the row's own
    adapter clears GAP), log-probs within LOGP_TOL; adapted rows differ
    from the base model's."""
    from bigdl_tpu.serving import ServingEngine as JaxEngine

    jlm, tlm = pair
    jb, tb = banks
    rng = np.random.RandomState(14)
    reqs = [(rng.randint(1, 30, size=(int(rng.randint(1, 8)),)).tolist(),
             int(rng.randint(4, 9)), i % 3) for i in range(7)]
    jeng = JaxEngine(jlm, n_slots=3, adapters=jb)
    jr = [jeng.submit(p, max_new_tokens=n, adapter_id=a) for p, n, a in reqs]
    jouts = jeng.drain()
    eng = _port(tlm, tb)
    tr = [eng.submit(p, max_new_tokens=n, adapter_id=a) for p, n, a in reqs]
    outs = eng.drain()
    for (p, n, a), j, t in zip(reqs, jr, tr):
        want = jouts[j]
        assert len(want) == n
        assert _adapted_gaps(jlm, jb, p, want.tolist(), a).min() > GAP, p
        np.testing.assert_array_equal(outs[t], want, err_msg=str(p))
        np.testing.assert_allclose(eng.logprobs(t), jeng.logprobs(j),
                                   atol=LOGP_TOL, rtol=0)
    assert eng.pool.free_slots == eng.pool.n_slots
    assert not eng.pool.adapter_ids.any()
    assert tb.live == {1: 1, 2: 1}
    base = _port(tlm)
    br = [base.submit(p, max_new_tokens=n) for p, n, _ in reqs]
    bouts = base.drain()
    assert any(not np.array_equal(bouts[b], outs[t])
               for (_, _, a), b, t in zip(reqs, br, tr) if a)


@pytest.mark.parametrize("dtype,kv", [("fp32", None), ("bf16", None),
                                      ("fp32", "int8"), ("bf16", "int8")])
def test_null_adapter_identical_to_the_plain_engine(pair, banks, dtype, kv):
    """THE contract: a bank-ed engine serving only null-adapter traffic is
    bitwise the engine built without a bank, tokens AND log-probs."""
    _, tlm = pair
    _, tb = banks
    dt = None if dtype == "fp32" else torch.bfloat16
    trace = _trace()
    outs = []
    for bank in (None, tb):
        eng = _port(tlm, bank, seed=11, compute_dtype=dt, kv_dtype=kv)
        rids = [eng.submit(p, max_new_tokens=n, sampling=sp)
                for p, n, sp in trace]
        o = eng.drain()
        outs.append([(o[r].tobytes(), eng.logprobs(r).tobytes())
                     for r in rids])
    assert outs[0] == outs[1]


def test_adapted_rows_diverge_per_tenant(pair, banks):
    _, tlm = pair
    _, tb = banks
    eng = _port(tlm, tb, seed=11)
    r = [eng.submit([3, 7, 2], max_new_tokens=8, adapter_id=a)
         for a in (0, 1, 2)]
    o = eng.drain()
    assert list(o[r[1]]) != list(o[r[0]])
    assert list(o[r[2]]) != list(o[r[1]])


@pytest.mark.parametrize("path", ["finish", "cancel_waiting",
                                  "cancel_running", "shed", "deadline",
                                  "infeasible", "error"])
def test_refcount_released_on_every_terminal_path(pair, path):
    """submit() retains the tenant's slot; whichever way the request
    leaves, the reference is dropped exactly once."""
    from bigdl_tpu_torch.serving import (
        AdapterBank, FaultInjector, VirtualClock, WatchdogConfig,
    )

    _, tlm = pair
    b = AdapterBank(tlm, rank=2, n_slots=3)
    aid = b.alloc(b.random_factors(seed=5, amp=1.0))
    clock = VirtualClock()
    kw = dict(n_slots=1, clock=clock)
    if path == "shed":
        kw["max_queue"] = 0
    if path == "infeasible":
        kw["deadline_feasibility"] = True
    if path == "error":
        kw.update(faults=FaultInjector(seed=0, p_fail=1.0, clock=clock),
                  watchdog=WatchdogConfig(max_retries=0))
    eng = _port(tlm, b, **kw)
    if path in ("cancel_waiting", "shed", "deadline"):
        eng.submit([5, 5], max_new_tokens=8)         # holds the one slot
        eng.step()
    if path == "infeasible":
        for _ in range(5):                         # 0.1 s per decode step
            eng.metrics.add_phase("decode_step", 0.1)
    rid = eng.submit([3, 2, 4], max_new_tokens=30 if path == "infeasible"
                     else 3, adapter_id=aid,
                     deadline_s=1.0 if path in ("deadline", "infeasible")
                     else None)
    if path != "shed":
        assert b.live[aid] == 2
    if path == "cancel_running":
        eng.step()
        assert eng.cancel(rid)
    elif path == "cancel_waiting":
        assert eng.cancel(rid)
    elif path == "deadline":
        clock.advance(5.0)
    eng.drain()
    reason = {"finish": "length", "cancel_waiting": None,
              "cancel_running": None, "shed": "shed", "deadline": "deadline",
              "infeasible": "infeasible", "error": "error"}[path]
    assert eng.request(rid).finish_reason == reason
    assert b.live == {aid: 1}
    b.free(aid)
    assert not b.is_live(aid)


def test_adapted_replay_through_preemption(pair, banks):
    """A fixed-seed adapted stream evicted mid-flight by a higher priority
    resumes draw for draw: the adapter id rides the preemption stash."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    _, tb = banks
    sp = SamplingParams(temperature=0.9, top_k=10, seed=31)
    base = _port(tlm, tb, n_slots=2)
    r0 = base.submit([3, 7, 2, 9, 4], max_new_tokens=10, sampling=sp,
                     adapter_id=1)
    want = base.drain()[r0]
    eng = _port(tlm, tb, n_slots=1, policy="priority", prefix_cache=True)
    r1 = eng.submit([3, 7, 2, 9, 4], max_new_tokens=10, sampling=sp,
                    adapter_id=1)
    for _ in range(3):
        eng.step()
    eng.submit([5, 5], max_new_tokens=2, priority=5)   # forces eviction
    outs = eng.drain()
    assert eng.request(r1).preemptions >= 1
    np.testing.assert_array_equal(outs[r1], want)


def test_row_state_carries_adapter(pair, banks):
    _, tlm = pair
    _, tb = banks
    eng = _port(tlm, tb, n_slots=2)
    rid = eng.submit([3, 7, 2], max_new_tokens=6, adapter_id=2)
    eng.step()
    slot = next(s for s, r in eng.scheduler.running.items()
                if r.req_id == rid)
    payload = eng.pool.row_state(slot)
    assert payload["adapter"] == 2
    del payload["adapter"]                  # a payload without the key
    eng.pool.restore_row(slot, payload)
    assert eng.pool.adapter_ids[slot] == 0
    eng.pool.adapter_ids[slot] = 2
    eng.drain()
    assert eng.pool.adapter_ids.tolist() == [0, 0]


def test_prefix_cache_is_namespaced_by_adapter(pair, banks):
    """A prompt cached under one tenant never serves another; each
    tenant's stream with the cache equals its stream without."""
    _, tlm = pair
    _, tb = banks
    p = [3, 7, 2, 9, 4, 4, 1]
    reqs = [(p, 1), (p, 0), (p, 1), (p + [5], 2), (p + [5], 1)]
    plain = _port(tlm, tb)
    want = [plain.submit(q, max_new_tokens=5, adapter_id=a) for q, a in reqs]
    wo = plain.drain()
    for admission in ("batched", "chunked"):
        eng = _port(tlm, tb, n_slots=1, prefix_cache=True,
                    admission=admission)
        got = [eng.submit(q, max_new_tokens=5, adapter_id=a)
               for q, a in reqs]
        go = eng.drain()
        for w, g in zip(want, got):
            np.testing.assert_array_equal(go[g], wo[w])
        # hits: request 3 on request 1's entry (tenant 1), request 5 on
        # tenant 1's prefix; requests 2 and 4 are the first of their
        # namespace
        hits, _ = eng.metrics.metrics.get("serving/prefix_hits")
        assert hits == 2, admission


@pytest.mark.parametrize("admission", ["batched", "chunked"])
def test_prefix_cache_forgets_a_freed_tenant(pair, admission):
    """A slot freed and re-alloc'd to another tenant starts with an empty
    namespace: the same prompt under the new factors equals a cache-less
    engine's stream (not the old tenant's cached K/V), and the old
    tenant's entries leave the cache."""
    from bigdl_tpu_torch.serving import AdapterBank

    _, tlm = pair
    b = AdapterBank(tlm, rank=2, n_slots=2)
    p = [3, 7, 2, 9, 4, 4, 1]
    eng = _port(tlm, b, n_slots=1, prefix_cache=True, admission=admission)
    streams = []
    for seed in (1, 2):
        aid = b.alloc(b.random_factors(seed, 1.0))
        assert aid == 1
        got = eng.submit(p, max_new_tokens=5, adapter_id=aid)
        again = eng.submit(p, max_new_tokens=5, adapter_id=aid)
        go = eng.drain()
        plain = _port(tlm, b)
        want = plain.submit(p, max_new_tokens=5, adapter_id=aid)
        np.testing.assert_array_equal(go[got], plain.drain()[want])
        np.testing.assert_array_equal(go[again], go[got])
        streams.append(go[got].tolist())
        b.free(aid)
    assert streams[0] != streams[1]
    hits, _ = eng.metrics.metrics.get("serving/prefix_hits")
    assert hits == 2                      # the repeats, never across tenants
    eng.submit([5, 5], max_new_tokens=2)  # a dispatch sees the bank move
    eng.drain()
    assert set(eng.prefix_cache._roots) == {0}


def test_chunked_admission_matches_batched(pair, banks):
    _, tlm = pair
    _, tb = banks
    trace = _trace(n=6, seed=8)
    outs = []
    for kw in ({}, {"admission": "chunked", "chunk_budget": 3}):
        eng = _port(tlm, tb, seed=4, **kw)
        rids = [eng.submit(p, max_new_tokens=n, sampling=sp,
                           adapter_id=i % 3)
                for i, (p, n, sp) in enumerate(trace)]
        o = eng.drain()
        outs.append([o[r].tolist() for r in rids])
    assert outs[0] == outs[1]


def test_base_only_and_mixed_traffic_share_the_step_inputs(pair, banks):
    """One engine serves base-only then mixed traffic through ONE decode
    input layout (the port's twin of JAX's zero extra compiles): the same
    argument shapes and dtypes every step, knobs included."""
    _, tlm = pair
    _, tb = banks
    eng = _port(tlm, tb, seed=11)
    seen = []
    step = eng._step_fn

    def recording(*args):
        flat = list(args[1:3]) + list(args[4].values()) + list(args[5:6])
        seen.append(tuple((tuple(t.shape), t.dtype) for t in flat)
                    + (len(args[6]),))
        return step(*args)

    eng._step_fn = recording
    for wave in range(2):
        for i, (p, n, sp) in enumerate(_trace(seed=7 + wave)):
            eng.submit(p, max_new_tokens=n, sampling=sp,
                       adapter_id=[0, 1, 2][i % 3] if wave else 0)
        eng.drain()
    assert len(seen) > 4 and len(set(seen)) == 1


def test_speculative_pins_drafts_to_the_null_adapter(pair, banks):
    """An adapted submit on a speculative engine must pass draft_tokens=0;
    with the pin its stream equals the plain adapter engine's, and
    null-adapter rows still draft."""
    from bigdl_tpu_torch.serving import ServingEngine, SpeculativeConfig

    _, tlm = pair
    _, tb = banks
    _, draft = make_pair(hidden=16, heads=2, layers=1, seed=21)
    base = _port(tlm, tb, seed=7)
    b1 = base.submit([3, 7, 2], max_new_tokens=8, adapter_id=1)
    b2 = base.submit([5, 1, 8], max_new_tokens=8)
    want = base.drain()
    se = ServingEngine(tlm, n_slots=3, seed=7, adapters=tb, device="cpu",
                       speculative=SpeculativeConfig(draft, k=3))
    with pytest.raises(ValueError, match="draft_tokens=0"):
        se.submit([3, 7, 2], max_new_tokens=8, adapter_id=1)
    s1 = se.submit([3, 7, 2], max_new_tokens=8, adapter_id=1,
                   draft_tokens=0)
    s2 = se.submit([5, 1, 8], max_new_tokens=8)
    got = se.drain()
    np.testing.assert_array_equal(want[b1], got[s1])
    np.testing.assert_array_equal(want[b2], got[s2])
    assert se.summary()["serving/spec_rows"] > 0
    assert tb.live == {1: 1, 2: 1}
