"""The port's resilient serving (bigdl_tpu_torch/serving/: the priority
scheduler, loss-free preemption, the fault injector and virtual clocks,
shedding, deadlines, degradation, cancellation) against the JAX
package's, on the CPU at make_pair()'s size (V=29, hidden 32, 4 heads, 2
layers, max_len 48):

* priority order and the EDF tiebreak: the same admission order as the
  JAX scheduler;
* preemption: every stream equals the unpreempted run's, the stash
  restores bitwise (``row_state`` → ``restore_row``), and a prefix cache
  shares the victim's state;
* ``FaultInjector``: counts by kind (the "transfer" site's stalls
  included) equal JAX's for the same seed and call sequence, and through the engine the same faults fire on the same
  dispatches as in the JAX engine; fail, garbage, stall and admission
  faults recover to the fault-free streams; a persistent fault errors
  out and never wedges;
* overload: max_queue shedding, deadline drops under a ``VirtualClock``,
  feasibility drops, degrade and its revert, and a shed preempted
  request dropping its stash — each disposition equal to the JAX
  engine's on the same submits;
* ``cancel``, ``pop_result`` and ``keep_finished``.

Tolerances: within the port, a stream that replays (preemption, fault
recovery) must equal the undisturbed stream exactly, greedy and seeded
sampled alike (the same arithmetic on the same rows). Against JAX:
dispositions, counters and fault counts exactly, and greedy tokens on
requests whose top-2 log-prob gap clears ``GAP`` = 1e-2 at every
generated position (the rule of tests/test_torch_serving_admission.py);
sampled streams are compared within the port only (the RNG lanes
differ)."""

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


def _trace(sampled=True):
    """Greedy rows, seeded sampled rows (penalties make the rebuilt
    counts matter), a 1-token prompt (no prefill)."""
    from bigdl_tpu_torch.serving import SamplingParams

    sp1 = SamplingParams(temperature=0.9, top_k=8, seed=123) \
        if sampled else None
    sp3 = SamplingParams(temperature=1.1, seed=7, repetition_penalty=1.2,
                         frequency_penalty=0.2) if sampled else None
    return [([3, 7, 2], 10, None), ([5, 1], 8, sp1), ([9], 6, None),
            ([4, 4, 4, 4], 9, sp3), ([8, 2, 6, 1, 3, 5], 7, None)]


def _port(tlm, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    kw.setdefault("n_slots", 2)
    kw.setdefault("kv_dtype", "int8")
    return ServingEngine(tlm, device="cpu", **kw)


def _jax(jlm, **kw):
    from bigdl_tpu.serving import ServingEngine

    kw.setdefault("n_slots", 2)
    kw.setdefault("kv_dtype", "int8")
    return ServingEngine(jlm, **kw)


def _run(eng, trace):
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp)
            for p, n, sp in trace]
    outs = eng.drain()
    return [outs[r].tolist() for r in rids]


@pytest.fixture(scope="module")
def baseline(pair):
    return _run(_port(pair[1]), _trace())


# -- the priority queue -------------------------------------------------------

def test_priority_order_and_edf_tiebreak():
    from bigdl_tpu.serving import Request as JReq, Scheduler as JSched
    from bigdl_tpu_torch.serving import Request, Scheduler

    def order(sched_cls, req_cls):
        s = sched_cls("priority")
        for i, (pri, dl) in enumerate([(0, None), (0, None), (5, 9.0),
                                       (5, 2.0), (0, 1.0), (5, None)]):
            s.submit(req_cls(req_id=i, prompt=[1], max_new_tokens=4,
                             priority=pri, deadline_s=dl, submit_time=0.0))
        peek = [r.req_id for r in s.peek_waiting(3)]
        assert s.top_waiting().req_id == peek[0]
        assert s.waiting_higher_than(0) == 3
        return peek + [s.admit(i).req_id for i in range(6)]

    got = order(Scheduler, Request)
    assert got == [3, 2, 5] + [3, 2, 5, 4, 0, 1]
    assert got == order(JSched, JReq)


# -- preemption ---------------------------------------------------------------

def _preempting_run(eng, trace):
    """Fill both slots with priority-0 rows, step 3 times, then submit the
    rest at priority 5."""
    low = [eng.submit(p, max_new_tokens=n, sampling=sp)
           for p, n, sp in trace[:2]]
    for _ in range(3):
        eng.step()
    hi = [eng.submit(p, max_new_tokens=n, sampling=sp, priority=5)
          for p, n, sp in trace[2:]]
    outs = eng.drain()
    return [outs[r].tolist() for r in low + hi]


@pytest.mark.parametrize("admission", ["batched", "chunked"])
def test_preemption_streams_equal_the_unpreempted_run(pair, baseline,
                                                      admission):
    _, tlm = pair
    eng = _port(tlm, policy="priority", admission=admission)
    assert _preempting_run(eng, _trace()) == baseline
    s = eng.summary()
    assert s["serving/preempted"] == 2
    assert s["serving/resumed_without_prefill"] == 2
    assert eng.pool.free_slots == 2


def test_preemption_matches_the_jax_engine(pair):
    jlm, tlm = pair
    trace = _trace(sampled=False)
    jeng = _jax(jlm, policy="priority")
    want = _preempting_run(jeng, trace)
    eng = _port(tlm, policy="priority")
    got = _preempting_run(eng, trace)
    for (p, _, _), w, g in zip(trace, want, got):
        assert len(g) == len(w)
        if top2_gaps(jlm, p, w).min() > GAP:
            assert g == w, p
    for name in ("preempted", "resumed_without_prefill"):
        assert (eng.metrics.metrics.get(f"serving/{name}")
                == jeng.metrics.metrics.get(f"serving/{name}"))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_row_state_round_trip_is_bitwise(pair, kv_dtype):
    """A victim's stash is a fresh copy of its whole slot: restored into
    another slot it reproduces the slot bitwise, and the stash is not
    written by the restore or by later decoding."""
    _, tlm = pair
    eng = _port(tlm, n_slots=3, kv_dtype=kv_dtype, policy="priority",
                admission="chunked", chunk_budget=4)
    eng.submit([3, 7, 2, 9, 1, 4], max_new_tokens=12,
               sampling=_trace()[1][2])
    for _ in range(4):
        eng.step()
    slot = next(iter(eng.scheduler.running))
    payload = eng.pool.row_state(slot)
    snap = {k: v.clone() for k, v in payload["carry"].items()}
    other = eng.pool.alloc()
    eng.pool.restore_row(other, payload)
    again = eng.pool.row_state(other)
    for k, v in payload["carry"].items():
        assert torch.equal(again["carry"][k], v), k
    for k in ("chunk_done", "chunk_target", "adapter", "draft"):
        assert again[k] == payload[k]
    eng.pool.free(other)
    eng.drain()
    for k, v in snap.items():
        assert torch.equal(payload["carry"][k], v), k


@pytest.mark.parametrize("max_entries", [16, 1])
def test_preemption_shares_prefix_cache_and_replays(pair, baseline,
                                                    max_entries):
    from bigdl_tpu_torch.serving import PrefixCache

    _, tlm = pair
    cache = PrefixCache(max_entries=max_entries)
    eng = _port(tlm, policy="priority", prefix_cache=cache)
    assert _preempting_run(eng, _trace()) == baseline
    assert eng.summary()["serving/preempted"] >= 1
    assert cache.entries >= 1


# -- the fault injector -------------------------------------------------------

def test_fault_injector_counts_match_jax():
    from bigdl_tpu.serving import FaultInjector as JFI, VirtualClock as JVC
    from bigdl_tpu_torch.serving import (
        FaultError, FaultInjector, SteppingClock, VirtualClock,
    )

    sites = ["prefill", "decode", "transfer", "decode", "prefill"] * 60

    def drive(inj, out):
        seen = []
        for site in sites:
            try:
                seen.append("garbage" if inj.call(site, lambda: out)
                            is not out else "ok")
            except RuntimeError as e:       # either package's FaultError
                seen.append(e.kind)
        return seen, inj.counts

    kw = dict(seed=4, p_fail=0.2, p_garbage=0.1, p_stall=0.1,
              p_admit_fail=0.3, p_transfer_stall=0.25, stall_s=2.0,
              max_faults=50)
    out = (torch.zeros(3), torch.zeros(3, dtype=torch.int64), {"pos": 1})
    clk = VirtualClock()
    got, counts = drive(FaultInjector(clock=clk, **kw), out)
    jclk = JVC()
    want, jcounts = drive(JFI(clock=jclk, **kw),
                          (np.zeros(3, np.float32), np.zeros(3, np.int64),
                           {"pos": 1}))
    assert got == want
    assert counts == jcounts
    assert counts["transfer_stall"] > 0 and clk.t == jclk.t > 0
    assert sum(counts.values()) == 50
    bad = FaultInjector(seed=0, p_garbage=1.0).call(
        "decode", lambda: out)
    assert bool(torch.isnan(bad[0]).all()) and (bad[1] == -1).all()
    assert bad[2] is out[2]
    with pytest.raises(ValueError, match="VirtualClock"):
        FaultInjector(p_stall=0.1)
    step = SteppingClock(tick_s=0.5)
    assert [step(), step()] == [0.5, 1.0] and step.t == 1.0
    with pytest.raises(ValueError, match="rewind"):
        step.advance(-1.0)
    with pytest.raises(ValueError, match="VirtualClock"):
        FaultInjector(p_transfer_stall=0.1)
    with pytest.raises(ValueError, match="site"):
        FaultInjector().call("bogus", lambda: out)
    assert issubclass(FaultError, RuntimeError)


@pytest.mark.parametrize("admission", ["batched", "per_request", "chunked"])
def test_faults_fire_as_in_the_jax_engine_and_recover(pair, admission):
    """Fail, garbage, stall and admission faults from one seed, through
    each admission mode: the port's engine makes the same dispatches in
    the same order as JAX's, so the same faults fire; every stream
    replays to the fault-free one."""
    from bigdl_tpu.serving import (
        FaultInjector as JFI, VirtualClock as JVC, WatchdogConfig as JW,
    )
    from bigdl_tpu_torch.serving import (
        FaultInjector, VirtualClock, WatchdogConfig,
    )

    jlm, tlm = pair
    trace = _trace(sampled=False)
    kw = dict(seed=3, p_fail=0.15, p_garbage=0.1, p_stall=0.1,
              p_admit_fail=0.3, stall_s=30.0)
    jclk, clk = JVC(), VirtualClock()
    jeng = _jax(jlm, admission=admission, clock=jclk,
                watchdog=JW(step_timeout_s=5.0, max_retries=None),
                faults=JFI(clock=jclk, **kw))
    jgot = _run(jeng, trace)
    eng = _port(tlm, admission=admission, clock=clk,
                watchdog=WatchdogConfig(step_timeout_s=5.0,
                                        max_retries=None),
                faults=FaultInjector(clock=clk, **kw))
    got = _run(eng, trace)
    assert got == _run(_port(tlm), trace)           # fault-free replay
    for (p, _, _), w, g in zip(trace, jgot, got):
        if top2_gaps(jlm, p, w).min() > GAP:
            assert g == w, p
    counts = eng._faults.counts
    assert counts == jeng._faults.counts
    # a monolithic engine sends no handoff: no transfer stall can fire
    assert counts["transfer_stall"] == 0
    assert all(counts[k] > 0 for k in counts if k != "transfer_stall"), \
        counts
    assert (eng.summary()["serving/retries"]
            == jeng.metrics.summary()["serving/retries"] > 0)
    assert eng.pool.free_slots == eng.pool.n_slots


def test_sampled_streams_replay_through_faults(pair, baseline):
    from bigdl_tpu_torch.serving import (
        FaultInjector, VirtualClock, WatchdogConfig,
    )

    _, tlm = pair
    clk = VirtualClock()
    eng = _port(tlm, prefix_cache=True, clock=clk,
                watchdog=WatchdogConfig(step_timeout_s=5.0,
                                        max_retries=None),
                faults=FaultInjector(seed=8, p_fail=0.2, p_garbage=0.15,
                                     p_stall=0.1, p_admit_fail=0.2,
                                     clock=clk))
    assert _run(eng, _trace()) == baseline
    assert eng.summary()["serving/recovered_rows"] > 0
    for r in eng._finished.values():
        assert r.finish_reason == "length"


def test_persistent_fault_errors_out_never_wedges(pair):
    from bigdl_tpu_torch.serving import FaultInjector, WatchdogConfig

    _, tlm = pair
    eng = _port(tlm, watchdog=WatchdogConfig(max_retries=2),
                faults=FaultInjector(seed=14, p_fail=1.0))
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp)
            for p, n, sp in _trace()]
    eng.drain()
    for r in rids:
        assert eng.request(r).finish_reason == "error"
        assert eng.request(r).retries == 3
    assert eng.pool.free_slots == eng.pool.n_slots
    s = eng.summary()
    assert s.get("serving/recovered_rows", 0.0) == 0.0
    assert s["serving/goodput"] == 0.0


# -- overload: shedding, deadlines, degradation -------------------------------

def _dispositions(eng, rids):
    return [(eng.request(r).state, eng.request(r).finish_reason,
             len(eng.request(r).output)) for r in rids]


def test_bounded_queue_sheds_and_deadline_drops(pair):
    """Mirrors tests/test_serving_faults.py:305 on both engines."""
    jlm, tlm = pair

    def drive(eng, clk):
        a = eng.submit([3, 7, 2], max_new_tokens=8)
        eng.step()                       # a admitted; the queue is empty
        b = eng.submit([5, 1], max_new_tokens=6, deadline_s=0.5)
        c = eng.submit([9], max_new_tokens=4)
        d = eng.submit([2, 2], max_new_tokens=4)     # shed at the door
        assert eng.request(d).finish_reason == "shed"
        assert len(eng.result(d)) == 0
        clk.advance(1.0)                 # b expires while waiting
        eng.step()
        outs = eng.drain()
        assert sorted(outs) == sorted([a, c])
        s = eng.metrics.summary()
        return (_dispositions(eng, [a, b, c, d]),
                [s[f"serving/{k}"] for k in ("shed", "deadline_missed",
                                             "goodput")])

    from bigdl_tpu.serving import VirtualClock as JVC
    from bigdl_tpu_torch.serving import VirtualClock

    clk, jclk = VirtualClock(), JVC()
    got = drive(_port(tlm, n_slots=1, max_queue=2, clock=clk), clk)
    assert got[1] == [2.0, 1.0, 0.5]
    assert got[0][1] == ("shed", "deadline", 0)
    assert got == drive(_jax(jlm, n_slots=1, max_queue=2, clock=jclk), jclk)


def test_max_queue_bounds_backlog_not_capacity(pair):
    _, tlm = pair
    eng = _port(tlm, max_queue=0)
    a = eng.submit([3, 7, 2], max_new_tokens=4)   # free slots absorb it
    b = eng.submit([5, 1], max_new_tokens=4)
    c = eng.submit([9], max_new_tokens=4)         # beyond capacity: shed
    assert eng.request(c).finish_reason == "shed"
    assert sorted(eng.drain()) == sorted([a, b])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([3], max_new_tokens=0)         # raises, never sheds
    assert eng.metrics.metrics.get("serving/submitted") == (3.0, 3)
    for bad in ({"max_queue": -1}, {"degrade_at": -1},
                {"keep_finished": -1}, {"preemption": True},
                {"dispatch_ahead": -1}):
        with pytest.raises(ValueError):
            _port(tlm, **bad)


def test_degrade_under_pressure_and_its_revert(pair):
    """tests/test_serving_faults.py:367 and the revert of
    tests/test_serving_autopilot.py:219, on both engines."""
    jlm, tlm = pair

    def pressure(make, Degrade):
        eng = make(n_slots=1, degrade_at=1)
        a = eng.submit([3, 7, 2], max_new_tokens=8,
                       degrade=Degrade(max_new_tokens=3))
        b = eng.submit([5, 1], max_new_tokens=8,
                       degrade=Degrade(max_new_tokens=3))
        c = eng.submit([9], max_new_tokens=8)
        eng.drain()
        return (_dispositions(eng, [a, b, c]),
                [eng.request(r).degraded for r in (a, b, c)],
                eng.metrics.summary()["serving/degraded"])

    def revert(make, Degrade):
        eng = make(n_slots=1, policy="priority", degrade_at=2)
        a = eng.submit([3, 7, 2, 9], max_new_tokens=8,
                       degrade=Degrade(max_new_tokens=3))
        d1 = eng.submit([5, 5], max_new_tokens=1)
        d2 = eng.submit([6, 6], max_new_tokens=1)
        eng.step()                       # a seats at depth 2: degraded
        eng.cancel(d1)
        eng.cancel(d2)
        eng.submit([4, 4], max_new_tokens=2, priority=5)   # evicts a
        eng.drain()
        s = eng.metrics.summary()
        return (eng.request(a).degraded, len(eng.result(a)),
                s["serving/degraded"], s["serving/degrade_restored"])

    from bigdl_tpu.serving import Degrade as JDegrade
    from bigdl_tpu_torch.serving import Degrade

    port = (lambda **kw: _port(tlm, **kw), Degrade)
    jax_ = (lambda **kw: _jax(jlm, **kw), JDegrade)
    got = pressure(*port)
    assert [n for _, _, n in got[0]] == [3, 3, 8]
    assert got[1] == [True, True, False] and got[2] == 2
    assert got == pressure(*jax_)
    assert revert(*port) == revert(*jax_) == (False, 8, 1.0, 1.0)


def test_deadline_feasibility_drops_infeasible(pair):
    """tests/test_serving_chunked.py:332 on both engines: no estimate, no
    drop; with one, an infeasible waiter is dropped and a feasible one
    served."""
    from bigdl_tpu.serving import VirtualClock as JVC
    from bigdl_tpu_torch.serving import VirtualClock

    jlm, tlm = pair

    def drive(make, clk):
        eng = make(admission="chunked", deadline_feasibility=True,
                   clock=clk)
        prompt = [4, 9, 13, 2]
        warm = eng.submit(prompt, max_new_tokens=3, deadline_s=1e-9)
        eng.drain()
        for _ in range(5):
            eng.metrics.add_phase("decode_step", 0.1)
        bad = eng.submit(prompt, max_new_tokens=30, deadline_s=1.0)
        ok = eng.submit(prompt, max_new_tokens=30, deadline_s=1e6)
        eng.drain()
        s = eng.metrics.summary()
        return (_dispositions(eng, [warm, bad, ok]),
                [s[f"serving/{k}"] for k in ("infeasible", "shed",
                                             "deadline_missed")])

    got = drive(lambda **kw: _port(tlm, **kw), VirtualClock())
    assert got[0][1] == ("shed", "infeasible", 0)
    assert got[0][2] == ("finished", "length", 30)
    assert got == drive(lambda **kw: _jax(jlm, **kw), JVC())


def test_shed_preempted_request_drops_its_stash(pair):
    from bigdl_tpu_torch.serving import VirtualClock

    _, tlm = pair
    clk = VirtualClock()
    eng = _port(tlm, n_slots=1, admission="chunked", policy="priority",
                clock=clk)
    lo = eng.submit([5, 3, 8, 1, 7], max_new_tokens=8, deadline_s=100.0)
    eng.step()
    eng.step()
    hi = eng.submit([6, 2, 9, 4], max_new_tokens=4, priority=10)
    eng.step()                                  # preempts lo
    waiting = eng.scheduler.waiting[0]
    assert waiting.req_id == lo and waiting.resume_carry is not None
    clk.advance(200.0)                          # lo's deadline expires
    eng.drain()
    assert eng.request(lo).finish_reason == "deadline"
    assert eng.request(lo).resume_carry is None
    assert len(eng.result(hi)) == 4


# -- cancellation and the ledger ----------------------------------------------

def test_cancel_waiting_and_running_requests(pair):
    _, tlm = pair
    want = _run(_port(tlm), [([9], 3, None)])[0]
    eng = _port(tlm, n_slots=1)
    a = eng.submit([3, 7], max_new_tokens=4)
    b = eng.submit([5, 2], max_new_tokens=4)
    c = eng.submit([9], max_new_tokens=3)
    eng.step()                               # a runs; b, c wait
    assert eng.cancel(b) and not eng.cancel(b)
    assert eng.queue_depth == 1
    assert eng.cancel(a)
    assert eng.request(a).state == "cancelled"
    out_a = list(eng.request(a).output)
    assert len(out_a) == 1 and eng.pool.free_slots == 1
    outs = eng.drain()
    assert a not in outs and b not in outs
    assert list(eng.request(a).output) == out_a
    assert eng.request(b).done_reason is None
    assert len(eng.result(b)) == 0
    assert outs[c].tolist() == want
    assert eng.metrics.metrics.get("serving/cancelled") == (2.0, 2)
    assert eng.summary()["serving/finish_cancelled"] == 2


def test_pop_result_and_keep_finished_bound_the_ledger(pair):
    _, tlm = pair
    eng = _port(tlm, keep_finished=2)
    rids = [eng.submit([3, i + 2], max_new_tokens=3) for i in range(5)]
    eng.drain()
    assert len(eng._finished) == 2
    assert eng.result(rids[0]) is None
    kept = [r for r in rids if eng.result(r) is not None]
    assert len(kept) == 2
    out = eng.pop_result(kept[0])
    assert out is not None and len(out) == 3
    assert eng.result(kept[0]) is None and eng.pop_result(kept[0]) is None
