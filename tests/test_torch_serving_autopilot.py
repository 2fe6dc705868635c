"""The port's SLO autopilot (bigdl_tpu_torch/serving/autopilot.py, the
least-laxity key of scheduler.py, the engine's deadline victims and
per-step sample, tools/torch_serving_zoo.py) against the JAX package's,
on the CPU at make_pair()'s size (V=29, hidden 32, 4 heads, 2 layers):

* ``AutopilotConfig`` validation, the ``ACTUATION_SITES`` vocabulary, the
  windowed metrics the loop reads;
* the bus: per-class degrade and its revert, the loop closed through
  ``step()``, the draft cap on a speculative engine;
* deadline-aware preemption: the waiter seats in time, the victim's
  stream equals an unpreempted run's (also through the dispatch-ahead
  window's flush), an infeasible waiter evicts nobody;
* actuations change no decode input layout (the port's twin of JAX's
  zero extra compiles);
* the least-laxity key orders the queue as the JAX scheduler does;
* the seeded workload zoo: the port's copy of the trace equals the JAX
  bench's, a replay gives JAX's actuation log, goodput, misses by class,
  schedule and output lengths exactly (virtual time counts the engine's
  clock reads, so the two engines must read their clocks alike), and the
  closed loop beats every static pass.

Tolerances: everything here is exact. Schedules, logs, counters and
virtual times are host bookkeeping; streams compared within the port run
the same arithmetic on the same rows."""

import importlib

import numpy as np
import pytest

import tools.torch_serving_zoo as zoo
from tests.torch_parity import make_pair, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def zoo_pair():
    # max_len covers the zoo's longest row (24-token RAG prompt + 48)
    return make_pair(max_len=80)


def _port(tlm, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    return ServingEngine(tlm, device="cpu", **kw)


def _req(eng, rid):
    """The Request wherever it lives: running, waiting or finished."""
    for r in eng.scheduler.running.values():
        if r.req_id == rid:
            return r
    for e in eng.scheduler._waiting:
        if e[1].req_id == rid:
            return e[1]
    return eng.request(rid)


# -- config, vocabulary, windows ---------------------------------------------

def test_autopilot_config_validation():
    from bigdl_tpu_torch.serving import AutopilotConfig

    AutopilotConfig()
    for kw, msg in (({"gap_target_s": 0.0}, "gap_target_s"),
                    ({"gap_low": 2.0, "gap_high": 1.0}, "gap_low < gap_high"),
                    ({"queue_low": 5.0, "queue_high": 5.0},
                     "queue_low < queue_high"),
                    ({"accept_low": 0.9}, "accept_low < accept_high"),
                    ({"chunk_min": 64, "chunk_max": 8}, "chunk_min"),
                    ({"window": 0}, "window"), ({"sustain": 0}, "sustain"),
                    ({"cooldown": -1}, "cooldown"),
                    ({"preempt_margin_s": -0.1}, "preempt_margin_s")):
        with pytest.raises(ValueError, match=msg):
            AutopilotConfig(**kw)


def test_actuation_sites_name_real_methods():
    """Every site of the closed vocabulary is a method of the port, and
    the vocabulary is JAX's."""
    from bigdl_tpu.serving.autopilot import ACTUATION_SITES as JSITES
    from bigdl_tpu_torch.serving import ACTUATION_SITES
    from bigdl_tpu_torch.serving.autopilot import ActuatorBus
    from bigdl_tpu_torch.serving.disagg import DisaggregatedEngine
    from bigdl_tpu_torch.serving.engine import ServingEngine

    assert ACTUATION_SITES == JSITES
    owners = {"ActuatorBus": ActuatorBus, "ServingEngine": ServingEngine,
              "DisaggregatedEngine": DisaggregatedEngine}
    for site in ACTUATION_SITES:
        _, cls, meth = site.split(".")
        assert callable(getattr(owners[cls], meth)), site


def test_window_and_service_estimate_match_jax():
    """The two readers the loop adds: ``window`` (bounded recency) and the
    service estimate following a phase shift, on both packages."""
    from bigdl_tpu.serving import ServingMetrics as JM
    from bigdl_tpu_torch.serving import ServingMetrics as TM

    got = []
    for M in (JM, TM):
        m = M()
        assert m.window("decode_gap_s", 8) is None
        assert m.service_time_estimate() is None
        for v in (0.1, 0.2, 0.3, 0.4):
            m.metrics.add("serving/decode_gap_s", v)
        with pytest.raises(ValueError, match="window size"):
            m.window("decode_gap_s", 0)
        for _ in range(70):
            m.add_phase("decode_step", 1.0)
        est = [m.service_time_estimate()]
        for _ in range(64):
            m.add_phase("decode_step", 0.01)
        est.append(m.service_time_estimate())
        m.on_actuation("degrade")
        got.append((m.window("decode_gap_s", 2), m.window("decode_gap_s", 100),
                    est, m.summary()["serving/actuations"]))
    assert got[0] == got[1]
    assert got[1][2] == [1.0, 0.01]


def test_window_reads_only_its_tail(monkeypatch):
    """``window`` runs once per control sample, so it copies the last ``n``
    samples and never the whole series (which grows with the run)."""
    from bigdl_tpu_torch.serving import ServingMetrics

    m = ServingMetrics()
    for v in range(1000):
        m.metrics.add("serving/decode_gap_s", float(v))

    def whole_series(name):
        raise AssertionError(f"window copied the whole {name} series")

    monkeypatch.setattr(m.metrics, "values", whole_series)
    assert m.metrics.tail("serving/decode_gap_s", 3) == [997.0, 998.0, 999.0]
    assert m.metrics.tail("serving/none", 3) == []
    w = m.window("decode_gap_s", 64)
    assert w["n"] == 64 and w["mean"] == float(np.mean(range(936, 1000)))


def test_least_laxity_key_orders_as_jax():
    """With a service estimate attached, the priority key orders deadlines
    by latest feasible start; the key is taken when a request enters the
    queue."""
    from bigdl_tpu.serving.scheduler import Request as JR, Scheduler as JS
    from bigdl_tpu_torch.serving.scheduler import Request as TR, Scheduler as TS

    rows = [(0, 1.0, 4), (0, 1.0, 40), (0, 0.9, 2), (0, None, 8),
            (1, 5.0, 3), (0, 0.95, 30), (1, 4.0, 60)]
    orders = []
    for R, S in ((JR, JS), (TR, TS)):
        s = S("priority")
        est = [0.01]
        s.service_estimate = lambda: est[0]
        for i, (pri, dl, n) in enumerate(rows):
            s.submit(R(req_id=i, prompt=[1], max_new_tokens=n,
                       priority=pri, deadline_s=dl))
        est[0] = 0.5                    # later drift moves no queued key
        orders.append([r.req_id for r in s.waiting])
    assert orders[0] == orders[1]
    assert orders[1][:2] == [6, 4]      # class first, then least laxity
    assert orders[1].index(1) < orders[1].index(0)


# -- the bus -------------------------------------------------------------------

def test_bus_degrade_is_per_class_and_revertible(pair):
    from bigdl_tpu_torch.serving import Autopilot, Degrade

    _, tlm = pair
    ap = Autopilot()
    eng = _port(tlm, n_slots=1, policy="priority", autopilot=ap)
    eng.submit([3, 7], max_new_tokens=24, priority=0)   # slot hog
    eng.step()
    lo = eng.submit([2, 9], max_new_tokens=8, priority=0,
                    degrade=Degrade(max_new_tokens=2))
    hi = eng.submit([4, 8], max_new_tokens=8, priority=3,
                    degrade=Degrade(max_new_tokens=2))
    assert ap.bus.degrade_waiting(below_priority=0) == 1
    assert _req(eng, lo).degraded and _req(eng, lo).max_new_tokens == 2
    assert not _req(eng, hi).degraded
    assert ap.bus.restore_waiting() == 1
    assert not _req(eng, lo).degraded
    assert _req(eng, lo).max_new_tokens == 8
    assert [(a, v) for _, a, v in ap.bus.log] == [("degrade", 1),
                                                  ("restore", 1)]
    s = eng.metrics.summary()
    assert s["serving/actuations"] == 2
    assert s["serving/actuation_degrade"] == 1
    assert not ap.bus.set_chunk_budget(8)     # no chunked pump here
    assert ap.bus.set_draft_cap(1) and not ap.bus.set_draft_cap(1)


def test_sample_drives_degrade_from_live_queue_depth(pair):
    """The degrade loop closed through ``step()``: a queue spike degrades
    the waiting batch tier, the lull restores it, as on the JAX engine."""
    from bigdl_tpu.serving import (Autopilot as JA, AutopilotConfig as JC,
                                   Degrade as JD, ServingEngine as JE)
    from bigdl_tpu_torch.serving import Autopilot, AutopilotConfig, Degrade

    jlm, tlm = pair

    def run(make, ap, D):
        eng = make(ap)
        eng.submit([3, 7], max_new_tokens=30, priority=0)
        rows = [eng.submit([2 + i, 9], max_new_tokens=8, priority=0,
                           degrade=D(max_new_tokens=2)) for i in range(3)]
        eng.step()
        degraded = [_req(eng, r).degraded for r in rows]
        for r in rows[1:]:
            eng.cancel(r)
        eng.step()
        return degraded, _req(eng, rows[0]).degraded, ap.bus.log

    cfg = dict(queue_high=2.0, queue_low=1.0, sustain=1, cooldown=0)
    port = run(lambda ap: _port(tlm, n_slots=1, policy="priority",
                                autopilot=ap),
               Autopilot(AutopilotConfig(**cfg)), Degrade)
    ref = run(lambda ap: JE(jlm, n_slots=1, policy="priority", autopilot=ap),
              JA(JC(**cfg)), JD)
    assert port == ref
    assert port[0] == [True] * 3 and not port[1]
    assert [a for _, a, _ in port[2]] == ["degrade", "restore"]


def test_draft_cap_is_runtime_data_and_streams_identical(pair):
    from bigdl_tpu_torch.serving import Autopilot, SpeculativeConfig

    _, tlm = pair
    _, draft = make_pair(hidden=16, heads=2, layers=1, seed=31)
    prompt, gen = [3, 7, 2, 9], 12
    base = _port(tlm, n_slots=1)
    r = base.submit(prompt, max_new_tokens=gen)
    want = base.drain()[r]
    ap = Autopilot()
    eng = _port(tlm, n_slots=1, autopilot=ap,
                speculative=SpeculativeConfig(draft, k=3))
    r = eng.submit(prompt, max_new_tokens=gen)
    eng.step()
    drafted, _ = eng.metrics.metrics.get("serving/draft_tokens")
    assert drafted > 0
    assert ap.bus.set_draft_cap(0)
    outs = eng.drain()
    assert eng.metrics.metrics.get("serving/draft_tokens")[0] == drafted
    assert np.array_equal(outs[r], want)
    assert ("draft_cap", 0) in [(a, v) for _, a, v in ap.bus.log]


def test_autopilot_binds_to_one_engine(pair):
    from bigdl_tpu_torch.serving import Autopilot

    _, tlm = pair
    ap = Autopilot()
    eng = _port(tlm, n_slots=1, autopilot=ap)
    with pytest.raises(ValueError, match="one instance per engine"):
        _port(tlm, n_slots=1, autopilot=ap)
    with pytest.raises(ValueError, match="not attached"):
        ap.sample(_port(tlm, n_slots=1))
    assert eng.scheduler.service_estimate is not None
    assert eng.draft_cap is None


# -- deadline-aware preemption -------------------------------------------------

def _deadline_trace(tlm, autopilot, deadline_s=0.1, **kw):
    from bigdl_tpu_torch.serving import SteppingClock

    eng = _port(tlm, n_slots=1, policy="priority",
                clock=SteppingClock(0.002), autopilot=autopilot, **kw)
    long_row = eng.submit([3, 7, 2, 9, 4], max_new_tokens=20, priority=0)
    for _ in range(4):
        eng.step()
    short_row = eng.submit([5, 8], max_new_tokens=4, priority=0,
                           deadline_s=deadline_s)
    return eng, eng.drain(), long_row, short_row


@pytest.mark.parametrize("window,deadline_s", [(0, 0.1), (2, 0.15)])
def test_deadline_preemption_is_loss_free_and_seats_the_waiter(
        pair, window, deadline_s):
    """A knife-edge waiter of the SAME class evicts the long-slack row and
    makes its deadline; the victim's stream equals the run with
    preemption off (at window 2 through the window's flush; its steps
    take longer on the stepping clock, which the deadline allows for)."""
    from bigdl_tpu_torch.serving import Autopilot, AutopilotConfig

    _, tlm = pair
    on = Autopilot(AutopilotConfig(preempt_margin_s=0.12))
    off = Autopilot(AutopilotConfig(preempt=False))
    eng1, outs1, l1, s1 = _deadline_trace(tlm, on, deadline_s,
                                          dispatch_ahead=window)
    eng0, outs0, l0, s0 = _deadline_trace(tlm, off, deadline_s,
                                          dispatch_ahead=window)
    assert eng1.metrics.summary().get("serving/preempted", 0) >= 1
    assert eng0.metrics.summary().get("serving/preempted", 0) == 0
    r1 = eng1.request(s1)
    assert r1.finish_time <= r1.deadline_time
    assert r1.finish_reason in ("length", "stop")
    assert eng0.request(s0).finish_reason == "deadline"
    assert np.array_equal(outs1[l1], outs0[l0])
    dropped = np.asarray(eng0.request(s0).output, np.int32)
    assert np.array_equal(dropped, outs1[s1][:len(dropped)])
    assert len(outs1[s1]) == 4
    assert len(outs1[l1]) == 20 and eng1.request(l1).preemptions >= 1
    assert not eng1._window


def test_deadline_preemption_matches_jax(pair):
    """The same trace on the JAX engine: the same finish times, reasons,
    preemptions and victim stream."""
    from bigdl_tpu.serving import (Autopilot as JA, AutopilotConfig as JC,
                                   ServingEngine as JE, SteppingClock as JS)
    from bigdl_tpu_torch.serving import Autopilot, AutopilotConfig

    jlm, tlm = pair

    def facts(eng, outs, lr, sr):
        return ([(eng.request(r).finish_time, eng.request(r).finish_reason,
                  eng.request(r).preemptions) for r in (lr, sr)],
                outs[lr].tolist())

    port = facts(*_deadline_trace(
        tlm, Autopilot(AutopilotConfig(preempt_margin_s=0.12))))
    jeng = JE(jlm, n_slots=1, policy="priority", clock=JS(0.002),
              autopilot=JA(JC(preempt_margin_s=0.12)))
    lr = jeng.submit([3, 7, 2, 9, 4], max_new_tokens=20, priority=0)
    for _ in range(4):
        jeng.step()
    sr = jeng.submit([5, 8], max_new_tokens=4, priority=0, deadline_s=0.1)
    ref = facts(jeng, jeng.drain(), lr, sr)
    assert port[0] == pytest.approx(ref[0], abs=1e-12)
    assert port[1] == ref[1]


def test_infeasible_waiter_never_triggers_eviction(pair):
    from bigdl_tpu_torch.serving import (Autopilot, AutopilotConfig,
                                         SteppingClock)

    _, tlm = pair
    eng = _port(tlm, n_slots=1, policy="priority", clock=SteppingClock(0.002),
                autopilot=Autopilot(AutopilotConfig(preempt_margin_s=0.12)))
    eng.submit([3, 7, 2], max_new_tokens=16, priority=0)
    for _ in range(4):
        eng.step()
    eng.submit([5, 8], max_new_tokens=30, priority=0, deadline_s=0.001)
    eng.drain()
    assert eng.metrics.summary().get("serving/preempted", 0) == 0


def test_actuations_keep_one_decode_input_layout(pair):
    """Flipping the chunk budget and the degrade knobs mid-run changes no
    shape or dtype the decode step is fed (the twin of JAX's zero extra
    compiles)."""
    from bigdl_tpu_torch.serving import Autopilot, AutopilotConfig, Degrade

    _, tlm = pair
    ap = Autopilot(AutopilotConfig(queue_high=2.0, queue_low=1.0,
                                   sustain=1, cooldown=0))
    eng = _port(tlm, n_slots=2, admission="chunked", chunk_budget=16,
                policy="priority", autopilot=ap)
    seen = []
    step = eng._step_fn

    def recording(*args):
        seen.append(zoo.decode_layout(args))
        return step(*args)

    eng._step_fn = recording
    prompts = [list(range(3, 13)), list(range(4, 14))]
    eng.submit(prompts[0], max_new_tokens=4)
    eng.step()
    assert ap.bus.set_chunk_budget(8)
    eng.submit(prompts[1], max_new_tokens=4,
               degrade=Degrade(max_new_tokens=2))
    eng.drain()
    ap.bus.set_chunk_budget(16)
    eng.submit(prompts[0], max_new_tokens=3)
    eng.drain()
    assert ap.bus.log and len(seen) > 4 and len(set(seen)) == 1


# -- the workload zoo ----------------------------------------------------------

def test_zoo_trace_is_seed_deterministic_and_equals_jax_s():
    bench = importlib.import_module("benchmarks.serving_bench")
    cfg = {"vocab": 29}
    t1 = zoo.make_zoo_trace(cfg, 43)
    assert t1 == zoo.make_zoo_trace(cfg, 43) == bench.make_zoo_trace(cfg, 43)
    assert zoo.make_zoo_trace(cfg, 7) != t1
    assert [r[0] for r in t1] == sorted(r[0] for r in t1)
    for arrival, prompt, max_new, _, deadline_s, _ in t1:
        assert prompt and all(1 <= t <= 29 for t in prompt)
        assert max_new >= 1 and arrival >= 0.0
        assert deadline_s is None or deadline_s > 0
    assert any(r[3] > 0 for r in t1) and any(r[5] for r in t1)


@pytest.mark.parametrize("name", ["closed", "chunk32_degrade"])
def test_zoo_replay_matches_jax_exactly(zoo_pair, name):
    """One zoo pass on both engines: the same actuation log, goodput,
    misses by class, virtual time, step count, preemptions, degrades and
    per-row output lengths."""
    bench = importlib.import_module("benchmarks.serving_bench")
    from bigdl_tpu.serving import Autopilot as JA, AutopilotConfig as JC

    jlm, tlm = zoo_pair
    trace = zoo.make_zoo_trace({"vocab": 29}, 43)
    knobs = zoo.STATIC_SWEEP.get(name, {})
    jap = pap = None
    if name == "closed":
        jap = JA(JC(queue_high=3.0, queue_low=1.0, sustain=2, cooldown=4,
                    chunk_min=8, chunk_max=64, gap_target_s=0.05,
                    preempt_margin_s=0.12))
        pap = zoo.default_autopilot()
        assert pap.config.__dict__ == jap.config.__dict__
    jeng, jouts, _, js = bench._run_zoo_engine(jlm, None, trace, 4,
                                               autopilot=jap, **knobs)
    run = zoo.run_zoo_engine(tlm, trace, autopilot=pap, device="cpu",
                             **knobs)
    keys = ("virtual_s", "steps", "goodput", "finished_in_slo",
            "deadline_missed", "hi_missed", "preempted", "degraded",
            "degrade_restored", "actuations")
    assert {k: run.stats[k] for k in keys} == {k: js[k] for k in keys}
    hi = {ti for ti, r in enumerate(trace) if r[3] > 0}
    j_lo = sum(1 for ti in range(len(trace)) if ti not in hi
               and (jeng.request(ti) is None
                    or jeng.request(ti).finish_reason not in ("length",
                                                              "stop")
                    or jeng.request(ti).finish_time
                    > jeng.request(ti).deadline_time))
    assert run.stats["lo_missed"] == j_lo
    assert {t: len(o) for t, o in run.outs.items()} == \
        {t: len(o) for t, o in jouts.items()}
    assert run.stats["decode_layouts"] == 1
    if jap is not None:
        assert pap.bus.log == jap.bus.log and pap.bus.log


def test_closed_loop_beats_every_static_pass(zoo_pair):
    """The port's run_autopilot on the tiny model: closed-loop goodput
    strictly above every static pass, high-priority misses not above the
    best static's, one decode input layout per pass, and clean rows
    identical between the closed pass and the reference static pass."""
    _, tlm = zoo_pair
    out = zoo.run_autopilot(tlm, device="cpu")
    best = max(s["goodput"] for s in out["static"].values())
    assert out["closed"]["goodput"] > best
    assert out["identical_rows"] > 0 and not out["partings"]
    assert out["closed"]["sample_us_p50"] > 0
    assert out["closed"]["samples"] == out["closed"]["steps"]
