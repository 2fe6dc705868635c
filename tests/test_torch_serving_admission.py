"""The port's admission modes (bigdl_tpu_torch/serving/: per-request
admission, the prefix cache, chunked admission) against the JAX
package's, on the CPU at make_pair()'s size (V=29, hidden 32, 4 heads, 2
layers, max_len 48):

* ``make_prefill_step`` vs JAX's at fp32 and with int8 KV, and its
  fresh-carry guard; ``get_prefill_step(kv_quant=True)`` its own cache
  entry with JAX's int8 carry; ``AdmissionController(prefill_rows=)``'s
  row count, shapes and streams against JAX's;
* the per-request engine vs the JAX per-request engine (fp32 and int8
  KV), and vs the port's batched engine;
* ``PrefixCache``'s hit, miss, truncation, refcount and LRU sequences,
  with ``stats()`` equal to the JAX cache's after the same operations;
* the prefix-cache engine vs JAX's (hits and matched tokens equal) and vs
  the cache-less engine; a cached entry stays bitwise unchanged after a
  hit and after the hitting row decodes;
* the chunked engine vs JAX's chunked engine (the same chunks in the same
  steps, within the budget) and vs batched; a cancelled mid-prefill row
  frees everything; chunk progress resets with its slot.

Tolerances: prefill log-probs and float K/V within ``KV_TOL`` = 1e-5
absolute (f32 in both; sums in another order); int8 scales within 1e-6
relative and int8 values within one quantum (a value on a rounding
boundary). Engine streams: chosen log-probs within ``LOGP_TOL`` = 1e-3
absolute, and tokens equal only on requests whose top-2 log-prob gap
clears ``GAP`` = 1e-2 at every generated position (checked from the JAX
model); at least half of every request set must clear it."""

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    make_pair, np_tree, one_torch_thread, top2_gaps,
)

KV_TOL = 1e-5
LOGP_TOL = 1e-3
GAP = 1e-2


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _reqs(n=8, seed=14, max_plen=12, vocab=29):
    """Ragged prompts (a 1-token prompt first), more requests than the
    engines' 3 slots so slots recycle."""
    rng = np.random.RandomState(seed)
    reqs = [([int(rng.randint(1, vocab + 1))], 5)]
    for _ in range(n - 1):
        plen = int(rng.randint(2, max_plen + 1))
        reqs.append((rng.randint(1, vocab + 1, size=(plen,)).tolist(),
                     int(rng.randint(4, 11))))
    return reqs


def _drive(eng, reqs, stagger=0):
    """Submit ``reqs`` (the first ``stagger`` ones, two steps, then the
    rest when ``stagger``), drain; returns (outputs, log-probs)."""
    head = reqs[:stagger] if stagger else reqs
    rids = [eng.submit(p, max_new_tokens=n) for p, n in head]
    if stagger:
        eng.step()
        eng.step()
        rids += [eng.submit(p, max_new_tokens=n) for p, n in reqs[stagger:]]
    outs = eng.drain()
    return ([outs[r] for r in rids],
            [np.asarray(eng.logprobs(r)) for r in rids])


def _assert_streams(jlm, reqs, want, got):
    """``got`` equals ``want`` under the module's rule: equal lengths;
    tokens and log-probs on requests whose top-2 gaps clear GAP."""
    compared = 0
    for (p, _), w, g, wl, gl in zip(reqs, want[0], got[0], want[1], got[1]):
        assert len(g) == len(w), p
        if top2_gaps(jlm, p, list(w)).min() > GAP:
            np.testing.assert_array_equal(g, w, err_msg=str(p))
            np.testing.assert_allclose(gl, wl, atol=LOGP_TOL, rtol=0)
            compared += 1
    assert compared >= len(reqs) // 2, compared


def _port(tlm, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    kw.setdefault("n_slots", 3)
    return ServingEngine(tlm, device="cpu", **kw)


def _jax(jlm, **kw):
    from bigdl_tpu.serving import ServingEngine

    kw.setdefault("n_slots", 3)
    return ServingEngine(jlm, **kw)


# -- make_prefill_step --------------------------------------------------------

def _assert_prefilled(tlp, tc, jlp, jc, kvq, n):
    """The port's prefill log-probs and carry against JAX's, under the
    module's KV tolerances, ``n`` tokens in."""
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=KV_TOL,
                               rtol=0)
    jc, tc = np_tree(jc), np_tree(tc)
    assert tc["pos"].tolist() == [n, n] and jc["pos"].tolist() == [n, n]
    for i in range(2):
        for kind in ("k", "v"):
            key = f"{kind}{i}"
            if kvq:
                np.testing.assert_allclose(tc[f"{key}_scale"],
                                           jc[f"{key}_scale"], rtol=1e-6)
                diff = np.abs(tc[key].astype(np.int32)
                              - jc[key].astype(np.int32))
                assert diff.max() <= 1, key
            else:
                np.testing.assert_allclose(tc[key], jc[key], atol=KV_TOL,
                                           rtol=0)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefill_step_matches_jax(pair, kv_dtype):
    import jax.numpy as jnp

    from bigdl_tpu.models import transformer as jtm
    from bigdl_tpu_torch.models import transformer as tm

    jlm, tlm = pair
    kvq = kv_dtype == "int8"
    toks = np.random.RandomState(3).randint(0, 29, size=(2, 9))
    _, jinit = jtm.make_batch_decode_step(jlm, kv_quant=kvq)
    jlp, jc = jtm.make_prefill_step(jlm, kv_quant=kvq)(
        None, jnp.asarray(toks, jnp.int32), jinit(2))
    _, tinit = tm.make_batch_decode_step(tlm, kv_quant=kvq)
    zero = tinit(2)
    prefill = tm.make_prefill_step(tlm, kv_quant=kvq)
    tlp, tc = prefill(tm.serving_params(tlm), torch.from_numpy(toks), zero)
    _assert_prefilled(tlp, tc, jlp, jc, kvq, 9)
    # the input carry is never written
    assert all(float(v.abs().sum()) == 0 for v in zero.values())
    zero["pos"][1] = 3
    with pytest.raises(ValueError, match="fresh carry"):
        prefill(tm.serving_params(tlm), torch.from_numpy(toks), zero)


def test_get_prefill_step_kv_quant_is_its_own_cache_entry(pair):
    """``get_prefill_step(kv_quant=True)``: a cache entry apart from the
    float one, as JAX keys it, and JAX's int8 carry."""
    import jax.numpy as jnp

    from bigdl_tpu.models import transformer as jtm
    from bigdl_tpu_torch.models import transformer as tm

    jlm, tlm = pair
    f32, i8 = tm.get_prefill_step(tlm), tm.get_prefill_step(tlm,
                                                            kv_quant=True)
    assert i8 is not f32
    assert i8 is tm.get_prefill_step(tlm, kv_quant=True)
    assert f32 is tm.get_prefill_step(tlm)
    jf = jtm.get_prefill_step(jlm, kv_quant=True)
    assert jf is not jtm.get_prefill_step(jlm)
    toks = np.random.RandomState(8).randint(0, 29, size=(2, 7))
    _, jinit = jtm.make_batch_decode_step(jlm, kv_quant=True)
    jlp, jc = jf(None, jnp.asarray(toks, jnp.int32), jinit(2))
    _, tinit = tm.make_batch_decode_step(tlm, kv_quant=True)
    tlp, tc = i8(tm.serving_params(tlm), torch.from_numpy(toks), tinit(2))
    assert tc["k0"].dtype == torch.int8
    _assert_prefilled(tlp, tc, jlp, jc, True, 7)


def test_prefill_rows_sets_the_batch_prefill_row_count(pair):
    """``AdmissionController(prefill_rows=2)`` on 3 slots: every batch
    prefill has 2 rows, the (B, L) shapes JAX's controller runs, and the
    streams JAX's; 0 (the default) means the slot count."""
    from bigdl_tpu.serving.admission import AdmissionController as JA
    from bigdl_tpu_torch.serving.admission import AdmissionController as TA

    jlm, tlm = pair
    reqs = _reqs(n=7, seed=21)
    jeng, teng = _jax(jlm), _port(tlm)
    jeng.admitter = JA(jeng, prefill_rows=2)
    teng.admitter = TA(teng, prefill_rows=2)
    want, got = _drive(jeng, reqs), _drive(teng, reqs)
    shapes = teng.admitter.traced_shapes
    assert shapes and {b for b, _ in shapes} == {2}
    assert shapes == jeng.admitter.traced_shapes
    _assert_streams(jlm, reqs, want, got)
    assert TA(_port(tlm)).prefill_rows == JA(_jax(jlm)).prefill_rows == 3


# -- per-request admission ----------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_per_request_engine_matches_jax_and_batched(pair, kv_dtype):
    jlm, tlm = pair
    reqs = _reqs()
    want = _drive(_jax(jlm, kv_dtype=kv_dtype, admission="per_request"),
                  reqs, stagger=3)
    eng = _port(tlm, kv_dtype=kv_dtype, admission="per_request")
    got = _drive(eng, reqs, stagger=3)
    _assert_streams(jlm, reqs, want, got)
    _assert_streams(jlm, reqs, got,
                    _drive(_port(tlm, kv_dtype=kv_dtype), reqs, stagger=3))
    assert eng.pool.free_slots == eng.pool.n_slots


def test_per_request_knob_refusals(pair):
    from bigdl_tpu_torch.serving import ServingEngine

    _, tlm = pair
    with pytest.raises(ValueError, match="prefix_cache"):
        ServingEngine(tlm, device="cpu", admission="per_request",
                      prefix_cache=True)
    with pytest.raises(ValueError, match="chunk_budget"):
        ServingEngine(tlm, device="cpu", chunk_budget=8)
    with pytest.raises(ValueError, match="chunk_budget"):
        ServingEngine(tlm, device="cpu", admission="chunked",
                      chunk_budget=0)
    with pytest.raises(ValueError, match="admission mode"):
        ServingEngine(tlm, device="cpu", admission="streamed")
    from bigdl_tpu_torch.serving import AdapterBank

    with pytest.raises(ValueError, match="adapters require"):
        ServingEngine(tlm, device="cpu", admission="per_request",
                      adapters=AdapterBank(tlm, rank=2, n_slots=2))


# -- PrefixCache --------------------------------------------------------------

def _carry(n_tokens, tag, jax_side):
    """A carry-shaped stand-in: the cache reads nothing but ``pos``."""
    if jax_side:
        import jax.numpy as jnp

        return {"pos": jnp.full((1,), n_tokens, jnp.int32),
                "k0": np.full((1, 4), tag, np.float32)}
    return {"pos": torch.full((1,), n_tokens, dtype=torch.int32),
            "k0": torch.full((1, 4), float(tag))}


def _lookup_sequence(cache_cls, jax_side):
    """test_serving_admission.py:269's operations; returns what each
    lookup saw and the final stats."""
    pc = cache_cls(max_entries=8)
    seen = []

    def look(tokens):
        carry, m, lease = pc.acquire(tokens)
        seen.append((m, None if carry is None else (
            int(np.asarray(carry["pos"])[0]), float(carry["k0"][0, 0]))))
        pc.release(lease)

    look([1, 2, 3])                                  # cold miss
    pc.insert([1, 2, 3, 4], _carry(4, 1.0, jax_side))
    look([1, 2, 3, 4])                               # exact hit
    look([1, 2, 9, 9])                               # truncated hit
    look([7, 1, 2])                                  # miss at token 0
    pc.insert([1, 2], _carry(2, 2.0, jax_side))
    look([1, 2, 3, 4, 5])                            # the deeper entry
    with pytest.raises(ValueError, match="empty"):
        pc.insert([], _carry(0, 0.0, jax_side))
    return seen, pc.stats()


def test_prefix_cache_lookup_hit_miss_and_truncation():
    from bigdl_tpu.serving import PrefixCache as JaxCache
    from bigdl_tpu_torch.serving import PrefixCache

    seen, stats = _lookup_sequence(PrefixCache, False)
    assert seen == [(0, None), (4, (4, 1.0)), (2, (2, 1.0)), (0, None),
                    (4, (4, 1.0))]
    assert (seen, stats) == _lookup_sequence(JaxCache, True)
    assert stats["entries"] == 2 and stats["hit_rate"] > 0


def _lru_sequence(cache_cls, jax_side):
    """test_serving_admission.py:297's operations."""
    pc = cache_cls(max_entries=2)
    pc.insert([1, 1], _carry(2, 1.0, jax_side))
    pc.insert([2, 2], _carry(2, 2.0, jax_side))
    _, _, lease1 = pc.acquire([1, 1])               # pin entry 1
    assert lease1.refs == 1
    pc.insert([3, 3], _carry(2, 3.0, jax_side))     # evicts entry 2
    entries = [pc.entries]
    assert pc.acquire([2, 2]) == (None, 0, None)
    _, m, lease3 = pc.acquire([3, 3])
    assert m == 2
    pc.release(lease3)
    pc.release(lease1)
    with pytest.raises(ValueError, match="release"):
        pc.release(lease1)
    la = pc.acquire([1, 1])[2]
    lb = pc.acquire([3, 3])[2]
    pc.insert([4, 4], _carry(2, 4.0, jax_side))     # all leased: overflow
    entries.append(pc.entries)
    pc.release(la)
    pc.release(lb)
    pc.insert([5, 5], _carry(2, 5.0, jax_side))     # eviction catches up
    entries.append(pc.entries)
    return entries, pc.cached_prefixes(), pc.stats()


def test_prefix_cache_refcount_and_lru_eviction():
    from bigdl_tpu.serving import PrefixCache as JaxCache
    from bigdl_tpu_torch.serving import PrefixCache

    got = _lru_sequence(PrefixCache, False)
    assert got[0] == [2, 3, 2]
    assert got == _lru_sequence(JaxCache, True)
    with pytest.raises(ValueError, match="max_entries"):
        PrefixCache(0)
    tier = object()
    assert PrefixCache(tier=tier).tier is tier


# -- the prefix-cache engine --------------------------------------------------

def _shared_prefix_reqs(seed=5, n=7):
    """A 20-token shared head with distinct 2-5-token tails, an exact
    repeat (a full hit) and a prompt that is a strict prefix of another
    (a truncated hit)."""
    rng = np.random.RandomState(seed)
    head = rng.randint(1, 30, size=(20,)).tolist()
    reqs = [(head + rng.randint(1, 30, size=(int(rng.randint(2, 6)),))
             .tolist(), int(rng.randint(4, 9))) for _ in range(n)]
    reqs.append((reqs[0][0], 5))
    reqs.append((head[:12], 6))
    return reqs


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefix_cache_engine_matches_jax_and_the_cacheless_engine(
        pair, kv_dtype):
    jlm, tlm = pair
    reqs = _shared_prefix_reqs()
    jeng = _jax(jlm, n_slots=2, kv_dtype=kv_dtype, prefix_cache=True)
    want = _drive(jeng, reqs, stagger=2)
    eng = _port(tlm, n_slots=2, kv_dtype=kv_dtype, prefix_cache=True)
    got = _drive(eng, reqs, stagger=2)
    _assert_streams(jlm, reqs, want, got)
    if kv_dtype == "fp32":
        # on int8 a continued prefix quantizes under its cached scale
        # history, not the one-shot prefill's (the grow-only merge), in
        # both packages: cached and cache-less streams differ there by
        # int8 rounding
        _assert_streams(jlm, reqs, got,
                        _drive(_port(tlm, n_slots=2), reqs, stagger=2))
    for name in ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
                 "prefill_batch"):
        assert (eng.metrics.metrics.get(f"serving/{name}")
                == jeng.metrics.metrics.get(f"serving/{name}")), name
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert eng.metrics.metrics.get("serving/prefix_hits")[0] >= len(reqs) - 2


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_cached_entry_is_unchanged_by_hits_and_decoding(pair, kv_dtype):
    """Full, partial and truncated hits copy from or continue a cached
    entry; neither they nor the hitting rows' decode steps write it."""
    _, tlm = pair
    head = list(range(3, 19))
    eng = _port(tlm, n_slots=3, kv_dtype=kv_dtype, prefix_cache=True)
    eng.submit(head, max_new_tokens=3)
    eng.drain()
    entries = [n for n in eng.prefix_cache._carry_nodes]
    snap = [{k: v.clone() for k, v in n.carry.items()} for n in entries]
    ids = [eng.submit(head, max_new_tokens=6),            # full hit
           eng.submit(head + [5, 9], max_new_tokens=6),   # partial hit
           eng.submit(head[:9], max_new_tokens=6)]        # truncated hit
    eng.step()
    hits, _ = eng.metrics.metrics.get("serving/prefix_hits")
    assert hits == 3
    eng.drain()
    assert all(len(eng.result(r)) == 6 for r in ids)
    for node, before in zip(entries, snap):
        for k, v in before.items():
            assert torch.equal(node.carry[k], v), k


# -- chunked admission --------------------------------------------------------

def _chunk_steps(eng, reqs):
    """Drive a chunked engine step by step; returns the prompt tokens
    each step spent on chunks and the outputs/log-probs."""
    rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    spends, last = [], 0.0
    while not eng.scheduler.idle():
        eng.step()
        total, _ = eng.metrics.metrics.get("serving/chunk_tokens")
        spends.append(total - last)
        last = total
    return spends, ([eng.result(r) for r in rids],
                    [np.asarray(eng.logprobs(r)) for r in rids])


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_chunked_matches_jax_and_batched(pair, kv_dtype):
    jlm, tlm = pair
    reqs = _reqs(seed=21, max_plen=30)
    jeng = _jax(jlm, kv_dtype=kv_dtype, admission="chunked", chunk_budget=7)
    jspend, want = _chunk_steps(jeng, reqs)
    eng = _port(tlm, kv_dtype=kv_dtype, admission="chunked", chunk_budget=7)
    spend, got = _chunk_steps(eng, reqs)
    assert spend == jspend and max(spend) <= 7
    for name in ("chunks", "chunk_tokens"):
        assert (eng.metrics.metrics.get(f"serving/{name}")
                == jeng.metrics.metrics.get(f"serving/{name}"))
    assert eng.admitter.traced_shapes == jeng.admitter.traced_shapes
    _assert_streams(jlm, reqs, want, got)
    if kv_dtype == "fp32":
        # on int8 early chunks requantize as the scale grows (within half
        # a quantum), in both packages: chunked and one-shot streams
        # differ there by int8 rounding
        _assert_streams(jlm, reqs, got, _drive(_port(tlm), reqs))
    assert eng.pool.free_slots == eng.pool.n_slots
    assert not eng.scheduler.partial and not eng.admitter.partial_slots
    assert eng.summary()["serving/decode_gap_p99_s"] > 0
    recent = eng.metrics.window("decode_step_s", 4)
    assert recent["n"] == 4 and recent["p99"] >= recent["p50"] > 0
    assert eng.metrics.window("no_such_counter", 4) is None


def test_chunked_cancel_partial_row_frees_everything(pair):
    _, tlm = pair
    rng = np.random.RandomState(2)
    eng = _port(tlm, n_slots=2, admission="chunked", chunk_budget=4,
                kv_dtype="int8")
    r0 = eng.submit(rng.randint(1, 30, size=(3,)).tolist(),
                    max_new_tokens=12)
    r1 = eng.submit(rng.randint(1, 30, size=(30,)).tolist(),
                    max_new_tokens=5)
    eng.step()                  # r1 admitted PARTIAL (budget went to r0)
    eng.step()                  # r1's first chunk fed
    slot = next(iter(eng.scheduler.partial))
    assert eng.admitter.partial_slots == [slot]
    assert eng.pool.chunk_target[slot] == 29
    assert 0 < eng.pool.chunk_done[slot] < 29
    assert eng.cancel(r1)
    assert eng.pool.chunk_done[slot] == 0 and eng.pool.chunk_target[slot] == 0
    assert slot not in eng.admitter._plans
    assert slot not in eng.admitter._order
    eng.drain()
    assert eng.request(r1).state == "cancelled"
    assert eng.request(r1).output == []
    assert len(eng.result(r0)) == 12
    assert eng.pool.free_slots == 2


def test_chunk_progress_resets_with_slot(pair):
    from bigdl_tpu_torch.models.transformer import make_batch_decode_step
    from bigdl_tpu_torch.serving import KVPool

    _, tlm = pair
    _, init = make_batch_decode_step(tlm, sampling=True)
    pool = KVPool(init, 2)
    slot = pool.alloc()
    pool.begin_chunks(slot, 0, 20)
    assert pool.chunk_remaining(slot) == 20
    pool.write_prefill(slot, init(1), 7)
    assert pool.chunk_done[slot] == 7 and pool.chunk_remaining(slot) == 13
    pool.free(slot)
    assert pool.chunk_done[slot] == 0 and pool.chunk_target[slot] == 0
    slot2 = pool.alloc()
    assert pool.chunk_done[slot2] == 0 and pool.chunk_target[slot2] == 0
    pool.set_pos(slot2, 3)
    assert pool.chunk_done[slot2] == 3
    pool.free(slot2)
    with pytest.raises(ValueError, match="not allocated"):
        pool.begin_chunks(slot2, 0, 4)
    slot3 = pool.alloc()
    with pytest.raises(ValueError, match="chunk plan"):
        pool.begin_chunks(slot3, 5, 4)
    with pytest.raises(ValueError, match="chunk plan"):
        pool.begin_chunks(slot3, 0, pool.max_len + 1)


def test_chunked_prefix_cache_skips_chunks(pair):
    """A cached prefix lands in the slot in one copy and its tokens never
    enter the chunk plan."""
    jlm, tlm = pair
    reqs = _shared_prefix_reqs(seed=8, n=4)
    eng = _port(tlm, n_slots=2, admission="chunked", chunk_budget=6,
                prefix_cache=True)
    got = _drive(eng, reqs)
    _assert_streams(jlm, reqs, got, _drive(_port(tlm, n_slots=2), reqs))
    total, _ = eng.metrics.metrics.get("serving/chunk_tokens")
    assert total < sum(len(p) - 1 for p, _ in reqs) - 20
