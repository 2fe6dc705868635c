"""The port's host KV tier (bigdl_tpu_torch/serving/kv_tier.py, the
engine's ``tier=``, ``PrefixCache(tier=)`` and the scheduler's
cold-first victims) against the JAX package's, on the CPU at
make_pair()'s size (V=29, hidden 32, 4 heads, 2 layers, max_len 48):

* spill → fetch byte identity through preemption (greedy and seeded
  sampled rows, fp32 and bf16, int8 KV with its scales): a tiered
  engine's streams equal the tier-less engine's, and the resumes came
  from the tier without a re-prefill;
* a budget-evicted row downgrades to replay; a stale row entry is
  dropped, never served; a meta-only blob fetches as nothing;
* the disaggregated plane's one shared tier through handoff and a pool
  kill drains to zero;
* prefix demote/promote: the round trip, refcounts and leases, namespace
  isolation, promotion into an engine's prefix cache, and a freed
  tenant's namespace dropped from the tier;
* the LRU byte budget (order, touch, the protect rule);
* the tier metrics, pinned to the store's own counts;
* the spill/fetch/eviction counts and the cold-first victim order equal
  the JAX tier's and scheduler's on the same trace.

Tolerances: within the port, a tiered stream equals the tier-less one
exactly (tokens and chosen log-probs: the restore is bitwise and the
arithmetic the same), and promoted prefix carries are bitwise the
demoted ones. Against JAX: counts and victim orders exactly (byte sizes
differ: the port's RNG lanes are int64 pairs, JAX's uint32 keys)."""

import numpy as np
import pytest
import torch

from tests.torch_parity import make_pair, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def tlm(pair):
    return pair[1]


def _run_preempt(lm, tier, jax_side=False, **ekw):
    """Two low-priority rows decode a few steps on a 2-slot pool, then two
    high-priority arrivals preempt them loss-free; everything drains.
    Returns (outputs by submission index, log-probs, engine)."""
    if jax_side:
        from bigdl_tpu.serving import SamplingParams, ServingEngine
    else:
        from bigdl_tpu_torch.serving import SamplingParams, ServingEngine

        ekw["device"] = "cpu"
    eng = ServingEngine(lm, n_slots=2, policy="priority", preemption=True,
                        tier=tier, **ekw)
    rids = [
        eng.submit([3, 7, 2], max_new_tokens=10, eos_id=1, priority=0),
        eng.submit([4, 9, 6], max_new_tokens=10, eos_id=1, priority=0,
                   sampling=SamplingParams(temperature=0.9, top_k=7,
                                           seed=11)),
    ]
    for _ in range(3):
        eng.step()
    rids.append(eng.submit([5, 6, 8], max_new_tokens=6, eos_id=1,
                           priority=5))
    rids.append(eng.submit([2, 2, 3, 4], max_new_tokens=6, eos_id=1,
                           priority=5,
                           sampling=SamplingParams(temperature=0.8,
                                                   top_p=0.9, seed=23)))
    out = eng.drain()
    return ({i: np.asarray(out[r]) for i, r in enumerate(rids)},
            {i: np.asarray(eng.logprobs(r)) for i, r in enumerate(rids)},
            eng)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


# -- spill → fetch byte identity ----------------------------------------------

@pytest.mark.parametrize("variant", ["fp32", "bf16", "int8"])
def test_preemption_spill_byte_identity(tlm, variant):
    from bigdl_tpu_torch.serving import TieredKVStore

    kw = ({"compute_dtype": torch.bfloat16} if variant == "bf16" else
          {"kv_dtype": "int8"} if variant == "int8" else {})
    ref, ref_lp, ref_eng = _run_preempt(tlm, None, **kw)
    got, got_lp, eng = _run_preempt(tlm, TieredKVStore(), **kw)
    _assert_same(ref, got)
    _assert_same(ref_lp, got_lp)
    s = eng.metrics.summary()
    assert s["serving/preempted"] >= 2
    assert s["serving/spills"] >= 2 and s["serving/fetches"] >= 2
    assert s["serving/resumed_without_prefill"] >= 2
    assert "serving/spills" not in ref_eng.metrics.summary()
    assert eng.tier.entries == 0


def test_tier_counts_and_victims_equal_jax(pair):
    """The same preemption trace through both tiered engines: the same
    spills, fetches, resumes and preemptions."""
    from bigdl_tpu.serving import TieredKVStore as JTier
    from bigdl_tpu_torch.serving import TieredKVStore

    jlm, tlm = pair
    _, _, jeng = _run_preempt(jlm, JTier(), jax_side=True)
    _, _, teng = _run_preempt(tlm, TieredKVStore())
    js, ts = jeng.tier.stats(), teng.tier.stats()
    for k in ("spills", "fetches", "evictions", "entries"):
        assert ts[k] == js[k], k
    for k in ("serving/preempted", "serving/resumed_without_prefill"):
        assert teng.summary().get(k) == jeng.metrics.summary().get(k), k


def test_cold_first_victim_order_equals_jax():
    """With a tier attached the victim within a priority class is the
    row whose last decode is oldest; without one, the latest arrival."""
    from bigdl_tpu.serving import Request as JReq, Scheduler as JSched
    from bigdl_tpu_torch.serving import Request, Scheduler

    def victims(sched_cls, req_cls, tier):
        s = sched_cls("priority", tier=tier)
        for i in range(4):
            s.submit(req_cls(req_id=i, prompt=[1], max_new_tokens=4,
                             priority=1 if i == 3 else 0))
        for slot in range(4):
            s.admit(slot)
        out = []
        for decoded in ([0, 2, 3], [1, 2, 3], [0, 1, 3]):
            s.note_decoded(decoded)
            out.append(s.lowest_running().req_id)
        return out

    for tier in (None, object()):
        got = victims(Scheduler, Request, tier)
        assert got == victims(JSched, JReq, tier)
    # slot 0 holds the priority-1 request (admitted first), slots 1-3
    # requests 0-2: the coldest priority-0 row each time
    assert victims(Scheduler, Request, object()) == [0, 2, 1]
    assert victims(Scheduler, Request, None) == [2, 2, 2]


def test_budget_evicted_row_downgrades_to_replay(tlm):
    from bigdl_tpu_torch.serving import TieredKVStore

    ref, ref_lp, _ = _run_preempt(tlm, None)
    tier = TieredKVStore(host_budget_bytes=1024)
    got, got_lp, eng = _run_preempt(tlm, tier)
    _assert_same(ref, got)
    s = eng.metrics.summary()
    assert s["serving/spills"] >= 2 and s["serving/tier_evictions"] >= 1
    assert eng.tier.resident_bytes <= 1024 or eng.tier.entries <= 1


def test_stale_row_entry_is_dropped_not_served(tlm):
    from bigdl_tpu_torch.serving import ServingEngine, TieredKVStore
    from bigdl_tpu_torch.serving.disagg import pack_payload, request_meta

    tier = TieredKVStore()
    eng = ServingEngine(tlm, n_slots=2, tier=tier, device="cpu")
    rid = eng.submit([3, 7, 2], max_new_tokens=6, eos_id=1)
    eng.step()
    eng.step()
    (slot, req), = eng.scheduler.running.items()
    tier.put_row(req, eng.pool.row_state(slot))
    assert tier.has_row(rid) and tier.header(rid)["request"]["req_id"] == rid
    req.output.append(4)                   # decoded past the spill
    assert tier.fetch_row(req) is None and not tier.has_row(rid)
    req.output.pop()
    tier.put_packed(pack_payload(request_meta(req), None), req_id=rid)
    assert tier.fetch_row(req) is None     # a replay form restores nothing
    tier.put_row(req, eng.pool.row_state(slot))
    assert tier.prefetch([req]) == 1
    payload = tier.fetch_row(req)
    assert payload is not None and tier.has_row(rid)   # kept after a fetch
    assert torch.equal(payload["carry"]["k0"], eng.pool.row_state(slot)
                       ["carry"]["k0"])
    eng.drain()
    assert tier.entries == 0


# -- the disaggregated plane: one tier --------------------------------------------

def test_plane_handoff_and_pool_kill_drain_the_tier(tlm):
    from bigdl_tpu_torch.serving import (
        DisaggregatedEngine, SamplingParams, ServingEngine,
    )

    prompts = [[3, 7, 2], [4, 9, 6], [5, 6, 8], [2, 2, 3, 4]]

    def submit_all(e):
        return [e.submit(p, max_new_tokens=8, eos_id=1,
                         sampling=(SamplingParams(temperature=0.8, top_k=9,
                                                  seed=100 + i)
                                   if i % 2 else None))
                for i, p in enumerate(prompts)]

    mono = ServingEngine(tlm, n_slots=4, device="cpu")
    r0 = submit_all(mono)
    ref = mono.drain()
    d = DisaggregatedEngine(tlm, prefill_slots=2, decode_slots=2,
                            decode_pools=2, device="cpu")
    assert d.tier is d.prefill.engine.tier
    assert all(d.tier is w.engine.tier for w in d.decoders)
    r1 = submit_all(d)
    for _ in range(4):
        d.step()
    d.kill_pool(0)
    out = d.drain()
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(out[b], ref[a])
    assert d.tier.entries == 0 and d.tier.resident_bytes == 0
    s = d.metrics.summary()
    assert s["serving/handoffs"] >= 4
    assert s["serving/spills"] >= 4 and s["serving/fetches"] >= 4


# -- prefix demote / promote ----------------------------------------------------------

def _carry(v, n=6):
    return {"k0": (torch.arange(n, dtype=torch.float32) + v).reshape(1, n),
            "pos": torch.full((1,), n, dtype=torch.int32)}


def test_prefix_demote_promote_round_trip():
    from bigdl_tpu_torch.serving import PrefixCache, TieredKVStore

    tier = TieredKVStore()
    pc = PrefixCache(max_entries=1, tier=tier)
    pc.insert((3, 7, 2), _carry(0.0))
    pc.insert((4, 9), _carry(100.0))        # evicts (3, 7, 2): demoted
    assert tier.prefix_entries == 1 and tier.stats()["spills"] == 1
    carry, matched, lease = pc.acquire([3, 7, 2, 8])
    assert matched == 3 and lease is not None
    assert torch.equal(carry["k0"], _carry(0.0)["k0"])
    assert tier.prefix_entries == 1 and tier.stats()["fetches"] == 1
    pc.release(lease)


def test_prefix_promotion_respects_refcounts_and_leases():
    from bigdl_tpu_torch.serving import PrefixCache, TieredKVStore

    tier = TieredKVStore()
    pc = PrefixCache(max_entries=1, tier=tier)
    pc.insert((3, 7, 2), _carry(0.0))
    _, matched, lease = pc.acquire([3, 7, 2])
    assert matched == 3
    pc.insert((4, 9), _carry(100.0))        # over capacity, but leased
    assert pc.entries == 2 and tier.prefix_entries == 0
    pc.release(lease)
    pc.insert((5, 5), _carry(200.0))
    assert tier.prefix_entries >= 1


def test_prefix_demote_promote_is_namespaced():
    from bigdl_tpu_torch.serving import PrefixCache, TieredKVStore

    tier = TieredKVStore()
    pc = PrefixCache(max_entries=1, tier=tier)
    pc.insert((3, 7, 2), _carry(0.0), namespace=7)
    pc.insert((4, 9), _carry(100.0), namespace=7)   # demotes under 7
    assert tier.prefix_entries == 1
    assert pc.acquire([3, 7, 2], namespace=0) == (None, 0, None)
    carry, matched, _ = pc.acquire([3, 7, 2], namespace=7)
    assert matched == 3 and torch.equal(carry["k0"], _carry(0.0)["k0"])
    pc.insert((1, 1), _carry(5.0), namespace=9)
    pc.insert((2, 2), _carry(6.0), namespace=9)     # demotes under 9
    assert 9 in tier._prefixes and tier.prefix_entries >= 1
    pc.drop_namespaces(keep={7})
    assert 9 not in tier._prefixes
    assert tier.promote_prefix((1, 1), 0, adapter_id=9) is None


def test_prefix_cache_engine_promotes_from_the_tier(tlm):
    """An engine whose one-entry prefix cache evicts into the tier serves
    later shared-prefix requests from promoted entries, with the streams
    of an engine whose cache holds every entry on the device."""
    from bigdl_tpu_torch.serving import PrefixCache, ServingEngine

    rng = np.random.RandomState(5)
    heads = [rng.randint(1, 30, size=(12,)).tolist() for _ in range(2)]
    prompts = [heads[i % 2] + [i + 1, 3] for i in range(6)]

    def run(tier):
        eng = ServingEngine(tlm, n_slots=1, device="cpu",
                            prefix_cache=PrefixCache(
                                max_entries=1 if tier else 64),
                            tier=tier)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        out = eng.drain()
        return [out[r] for r in rids], [eng.logprobs(r) for r in rids], eng

    ref, ref_lp, _ = run(None)
    got, got_lp, eng = run(True)
    for a, b, la, lb in zip(ref, got, ref_lp, got_lp):
        np.testing.assert_array_equal(a, b)
        assert la.tobytes() == lb.tobytes()
    assert eng.prefix_cache.tier is eng.tier
    assert eng.tier.stats()["fetches"] >= 1
    hits, _ = eng.metrics.metrics.get("serving/prefix_hits")
    assert hits >= 4


# -- the LRU byte budget --------------------------------------------------------

def test_host_budget_evicts_lru_first():
    from bigdl_tpu_torch.serving import TieredKVStore

    tier = TieredKVStore()
    tier.demote_prefix((1, 2), _carry(0.0))
    per = tier.resident_bytes
    tier2 = TieredKVStore(host_budget_bytes=int(per * 2.5))
    tier2.demote_prefix((1, 2), _carry(0.0))
    tier2.demote_prefix((3, 4), _carry(1.0))
    assert tier2.promote_prefix((1, 2), 0) is not None
    tier2.demote_prefix((1, 2), _carry(0.0))     # back in, freshest
    tier2.demote_prefix((5, 6), _carry(2.0))     # over budget: evicts
    assert tier2.stats()["evictions"] >= 1
    assert tier2.promote_prefix((3, 4), 0) is None
    assert tier2.promote_prefix((5, 6), 0) is not None
    tier3 = TieredKVStore(host_budget_bytes=max(1, per // 2))
    tier3.demote_prefix((1, 2), _carry(0.0))
    assert tier3.entries == 1                    # the protect rule
    assert tier3.promote_prefix((1, 2), 0) is not None
    with pytest.raises(ValueError):
        TieredKVStore(host_budget_bytes=0)


# -- metrics --------------------------------------------------------------------

def test_tier_metrics_runtime_pinned(tlm):
    from bigdl_tpu_torch.serving import TieredKVStore

    tier = TieredKVStore()
    _, _, eng = _run_preempt(tlm, tier)
    s, st = eng.metrics.summary(), tier.stats()
    assert s["serving/spills"] == st["spills"] > 0
    assert s["serving/fetches"] == st["fetches"] > 0
    assert s["serving/spill_bytes"] == st["spill_bytes"] > 0
    assert s["serving/fetch_bytes"] == st["fetch_bytes"] > 0
    assert s["serving/tier_bytes"] == 0.0
    assert s["serving/spill_bytes_per_row"] == \
        pytest.approx(st["spill_bytes"] / st["spills"])
    assert s["serving/fetch_p99_s"] >= 0.0
    _, _, ref = _run_preempt(tlm, None)
    rs = ref.metrics.summary()
    for k in ("serving/spills", "serving/fetches", "serving/spill_bytes",
              "serving/tier_evictions", "serving/spill_bytes_per_row",
              "serving/fetch_p99_s"):
        assert k not in rs, k
    assert rs["serving/resumed_without_prefill"] >= 2
