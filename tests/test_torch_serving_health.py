"""Pool health of the port's disaggregated plane (bigdl_tpu_torch/serving/
health.py, autopilot.Controller, and the failover / drain / autoscaler /
transfer-hardening machinery of serving/disagg.py) against the JAX
package's, on the CPU at make_pair()'s size (V=29, hidden 32, 4 heads, 2
layers, max_len 48):

* ``Controller``: validation, sustain, cooldown, the hold-down veto, the
  can-gates and flap-freedom, each decision sequence equal to the JAX
  controller's on the same signal;
* ``PoolHealth`` classification and the config validation; the
  autoscaler's hysteresis;
* ``kill_pool`` chaos at three seeds (fp32, and bf16 at two), the
  block-store wire re-route, heartbeat discovery on a ``VirtualClock``,
  suspect routing, ``drain_pool``, the autoscaler up then down, the
  exponential backoff, the transfer-stall fault mode, send-timeout dedup
  at 1 and 2 pools, an idle lull, the cancel sweep of the backoff lot and
  of the wire, failover percentiles, and the last pool's death with and
  without a standby;
* a pool kill's counters (deaths, failovers, the migrated/replayed split,
  dispositions) equal the JAX plane's on the same submits.

Tolerances: streams through a pool death, a drain or a transfer fault
equal the undisturbed monolithic port engine's: tokens exactly (greedy
and seeded sampled), log-probs within ``GEOMETRY_TOL`` = 1e-5 — the
plane's prefill pool frees its slots at every handoff, so it batches
other rows together than the oracle does, a replayed row re-prefills in
a batch of its own, and the CPU's GEMM picks its kernel by row count.
Controller decisions, health states, backoff times and counters exactly,
and equal to JAX's."""

import numpy as np
import pytest
import torch

from tests.torch_parity import make_pair

GEOMETRY_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def tlm(pair):
    return pair[1]


def _trace(V=29, n=8, seed=3):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 13, size=(n,))
    return [rng.randint(1, V + 1, size=(int(k),)).tolist() for k in lens]


def _samplings(n=8, seed=0):
    from bigdl_tpu_torch.serving import SamplingParams

    mixes = [None,
             SamplingParams(temperature=0.8, top_k=8, seed=11 + seed),
             None,
             SamplingParams(temperature=1.1, top_p=0.9),   # engine lane
             SamplingParams(temperature=0.7, repetition_penalty=1.3,
                            seed=5 + seed),
             None,
             SamplingParams(temperature=0.9, min_tokens=3, seed=7),
             None]
    return (mixes * ((n // len(mixes)) + 1))[:n]


def _mono(tlm, prompts, sps, gen=8, slots=8, dtype=None):
    from bigdl_tpu_torch.serving import ServingEngine

    eng = ServingEngine(tlm, n_slots=slots, compute_dtype=dtype,
                        device="cpu")
    rids = [eng.submit(p, max_new_tokens=gen, sampling=sp)
            for p, sp in zip(prompts, sps)]
    outs = eng.drain()
    return {r: (outs[r], eng.logprobs(r)) for r in rids}


def _plane(tlm, **kw):
    from bigdl_tpu_torch.serving import DisaggregatedEngine

    return DisaggregatedEngine(tlm, device="cpu", **kw)


def _finished(d):
    """Every FINISHED request of the plane, once: a request finishing in
    two pools fails (a resend admitted twice)."""
    outs = {}
    for eng in d._engines():
        for rid, req in eng._finished.items():
            if req.state == "finished":
                assert rid not in outs, f"request {rid} finished twice"
                outs[rid] = (np.asarray(req.output, np.int32),
                             np.asarray(req.logprobs, np.float32))
    return outs


def _assert_same(want, got, lp_tol=GEOMETRY_TOL):
    assert set(want) == set(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid][0], want[rid][0],
                                      err_msg=f"request {rid}")
        if lp_tol is None:
            assert got[rid][1].tobytes() == want[rid][1].tobytes(), rid
        else:
            np.testing.assert_allclose(got[rid][1], want[rid][1],
                                       atol=lp_tol, rtol=0)


def _both(fn):
    """``fn(Controller)`` with the port's and JAX's classes; equal."""
    from bigdl_tpu.serving import Controller as JController
    from bigdl_tpu_torch.serving import Controller

    got = fn(Controller)
    assert got == fn(JController)
    return got


# -- Controller (autopilot.py) --------------------------------------------------

def _ctl(cls, **kw):
    args = dict(high_water=0.8, low_water=0.2, sustain=3, cooldown=8)
    args.update(kw)
    return cls(**args)


def test_controller_validation():
    from bigdl_tpu_torch.serving import Controller

    with pytest.raises(ValueError, match="low_water < high_water"):
        Controller(high_water=0.2, low_water=0.8)
    with pytest.raises(ValueError, match="sustain"):
        _ctl(Controller, sustain=0)
    with pytest.raises(ValueError, match="cooldown"):
        _ctl(Controller, cooldown=-1)


def test_controller_sustain_demands_consecutive_evidence():
    def run(cls):
        c = _ctl(cls, sustain=3, cooldown=0)
        return [c.observe(s) for s in (0.9, 0.9, 0.5, 0.9, 0.9, 0.9)]

    assert _both(run) == [None] * 5 + ["up"]


def test_controller_born_ready_and_cooldown_spacing():
    def run(cls):
        c = _ctl(cls, sustain=1, cooldown=4)
        return [c.observe(0.9) for _ in range(6)]

    assert _both(run) == ["up", None, None, None, None, "up"]


def test_controller_low_side_and_hold_down_veto():
    def run(cls):
        c = _ctl(cls, sustain=2, cooldown=0)
        c2 = _ctl(cls, sustain=2, cooldown=0)
        return [c.observe(0.1), c.observe(0.1),
                c2.observe(0.1, hold_down=True),
                c2.observe(0.1, hold_down=True), c2.observe(0.1),
                c2.observe(0.1), c2.observe(0.9, hold_down=True),
                c2.observe(0.9, hold_down=True)]

    assert _both(run) == [None, "down", None, None, None, "down", None, "up"]


def test_controller_can_gates_do_not_consume_the_run():
    def run(cls):
        c = _ctl(cls, sustain=2, cooldown=0)
        return [c.observe(0.9, can_up=False), c.observe(0.9, can_up=False),
                c.observe(0.9)]

    assert _both(run) == [None, None, "up"]


def test_controller_flap_free_on_boundary_riding_signal():
    def run(cls):
        c = _ctl(cls, sustain=3, cooldown=0)
        band = [c.observe(s) for _ in range(100) for s in (0.9, 0.5)]
        c2 = _ctl(cls, sustain=2, cooldown=10)
        square = [c2.observe(s) for s in [0.9] * 50 + [0.1] * 50]
        return band, square

    band, square = _both(run)
    assert band == [None] * 200
    fired = [i for i, a in enumerate(square) if a is not None]
    assert fired and all(b - a > 10 for a, b in zip(fired, fired[1:]))


def test_autoscaler_is_a_controller():
    from bigdl_tpu_torch.serving import Controller, OccupancyAutoscaler

    a = OccupancyAutoscaler()
    assert isinstance(a, Controller)
    cfg = a.config
    for _ in range(cfg.sustain):
        d = a.observe(cfg.high_water, backlog=0, can_up=True, can_down=True)
    assert d == "up"


# -- the health model ----------------------------------------------------------

def _walk(mod):
    clk = mod.VirtualClock()
    h = mod.PoolHealth(clk, mod.HealthConfig(
        suspect_after_s=1.0, dead_after_s=3.0, suspect_after_failures=2,
        dead_after_failures=4))
    seen = [h.state()]
    clk.advance(1.5)
    seen.append(h.state())
    h.beat()
    seen.append(h.state())
    clk.advance(3.5)
    seen.append(h.state())
    h.beat()
    for op in ("on_transfer_failure", "on_transfer_failure",
               "on_transfer_ok") + ("on_transfer_failure",) * 4:
        getattr(h, op)()
        seen.append(h.state())
    h2 = mod.PoolHealth(clk)
    h2.force_dead()
    h2.beat()
    seen.append(h2.state())
    with pytest.raises(ValueError):
        h2.reset()
    return seen


def test_pool_health_classification():
    import bigdl_tpu.serving as jmod
    import bigdl_tpu_torch.serving as tmod

    got = _walk(tmod)
    assert got == ["healthy", "suspect", "healthy", "dead", "healthy",
                   "suspect", "healthy", "healthy", "suspect", "suspect",
                   "dead", "dead"]
    assert got == _walk(jmod)


def test_health_and_retry_config_validation():
    from bigdl_tpu.serving import TransferRetryConfig as JRetry
    from bigdl_tpu_torch.serving import (
        AutoscalerConfig, HealthConfig, TransferRetryConfig,
    )

    for bad in (lambda: HealthConfig(suspect_after_s=5.0, dead_after_s=1.0),
                lambda: HealthConfig(suspect_after_failures=0),
                lambda: TransferRetryConfig(send_timeout_s=0.0),
                lambda: AutoscalerConfig(low_water=0.9, high_water=0.5),
                lambda: AutoscalerConfig(sustain=0),
                lambda: AutoscalerConfig(min_pools=0)):
        with pytest.raises(ValueError):
            bad()
    r = TransferRetryConfig(backoff_base_s=0.5, backoff_cap_s=3.0)
    got = [r.delay(n) for n in (0, 1, 2, 3, 4)]
    assert got == [0.0, 0.5, 1.0, 2.0, 3.0]
    jr = JRetry(backoff_base_s=0.5, backoff_cap_s=3.0)
    assert got == [jr.delay(n) for n in (0, 1, 2, 3, 4)]


def test_autoscaler_hysteresis_never_flaps():
    from bigdl_tpu_torch.serving import AutoscalerConfig, OccupancyAutoscaler

    cfg = AutoscalerConfig(high_water=0.8, low_water=0.3, sustain=3,
                           cooldown=5)
    sc = OccupancyAutoscaler(cfg)
    seq = [sc.observe(o, 0, True, True)
           for o in (0.9, 0.9, 0.5, 0.9, 0.9, 0.9)]
    assert seq == [None] * 5 + ["up"]
    assert [sc.observe(0.0, 0, True, True) for _ in range(6)] == \
        [None] * 5 + ["down"]
    sc2 = OccupancyAutoscaler(cfg)
    assert all(sc2.observe(0.1, backlog=4, can_up=True, can_down=True)
               is None for _ in range(10))
    sc3 = OccupancyAutoscaler(cfg)
    assert all(sc3.observe(0.9 if i % 2 else 0.1, 0, True, True) is None
               for i in range(40))


# -- pool-death chaos ----------------------------------------------------------

@pytest.mark.parametrize("fault_seed,variant", [
    (0, "fp32"), (1, "fp32"), (2, "fp32"), (0, "bf16"), (2, "bf16")])
def test_pool_death_chaos_byte_identical(tlm, fault_seed, variant):
    """Kill a decode pool mid-stream (the seed picks the victim, the kill
    step and the lanes): every stream equals the monolithic engine's at
    the decode pools' geometry, and every request lands in one
    disposition."""
    dt = None if variant == "fp32" else torch.bfloat16
    prompts = _trace(seed=3 + fault_seed)
    sps = _samplings(seed=fault_seed)
    want = _mono(tlm, prompts, sps, slots=4, dtype=dt)
    d = _plane(tlm, prefill_slots=4, decode_slots=4, decode_pools=2,
               compute_dtype=dt)
    for p, sp in zip(prompts, sps):
        d.submit(p, max_new_tokens=8, sampling=sp)
    for _ in range(1 + fault_seed):
        d.step()
    victim = fault_seed % 2
    d.kill_pool(victim)
    d.drain()
    _assert_same(want, _finished(d))
    s = d.summary()
    assert s["serving/pool_deaths"] == s["serving/failovers"] == 1.0
    assert s.get("serving/migrated_rows", 0.0) \
        + s.get("serving/replayed_rows", 0.0) >= 1.0
    assert sum(v for k, v in s.items()
               if k.startswith("serving/finish_")) == len(prompts)
    assert d.pool_states()[victim] == "dead"
    assert d.tier.entries == 0


def test_pool_kill_counters_equal_the_jax_plane(pair):
    from bigdl_tpu.serving import DisaggregatedEngine as JaxPlane

    jlm, tlm = pair
    prompts = _trace(seed=4)
    summaries = []
    for d in (JaxPlane(jlm, prefill_slots=4, decode_slots=4,
                       decode_pools=2),
              _plane(tlm, prefill_slots=4, decode_slots=4, decode_pools=2)):
        for p in prompts:
            d.submit(p, max_new_tokens=8)
        d.step()
        d.step()
        d.kill_pool(0)
        d.drain()
        summaries.append(d.summary())
    js, ts = summaries
    for k in ("serving/pool_deaths", "serving/failovers",
              "serving/migrated_rows", "serving/replayed_rows",
              "serving/handoffs", "serving/finish_length"):
        assert ts.get(k) == js.get(k), k


def test_pool_death_blockstore_wire_reroute(tlm, tmp_path):
    """Handoffs sit unconsumed in the dead pool's block-store channel:
    failover re-routes the packed bytes to the survivor."""
    from bigdl_tpu_torch.parallel.block_store import FsBlockStore
    from bigdl_tpu_torch.serving import BlockStoreTransfer

    for fault_seed in (0, 1):
        prompts = _trace(n=6, seed=11 + fault_seed)
        sps = _samplings(6, seed=fault_seed)
        want = _mono(tlm, prompts, sps, gen=6, slots=6)
        store = FsBlockStore(str(tmp_path / f"bs{fault_seed}"))
        d = _plane(tlm, prefill_slots=6, decode_slots=6, decode_pools=2,
                   transfer_factory=lambda i, s=store:
                   BlockStoreTransfer(s, f"d{i}"))
        for p, sp in zip(prompts, sps):
            d.submit(p, max_new_tokens=6, sampling=sp)
        for req, payload in d.prefill.pump():
            d._handoff(req, payload)
        victim = fault_seed % 2
        assert d.decoders[victim].transfer.pending() > 0
        d.kill_pool(victim)
        d.drain()
        _assert_same(want, _finished(d))
        assert d.summary()["serving/migrated_rows"] >= 1


def test_heartbeat_detection_on_virtual_clock(tlm):
    from bigdl_tpu_torch.serving import HealthConfig, VirtualClock

    prompts, sps = _trace(n=6), _samplings(6)
    want = _mono(tlm, prompts, sps, slots=6)
    clk = VirtualClock()
    d = _plane(tlm, prefill_slots=6, decode_slots=6, decode_pools=2,
               clock=clk,
               health=HealthConfig(suspect_after_s=1.0, dead_after_s=3.0))
    for p, sp in zip(prompts, sps):
        d.submit(p, max_new_tokens=8, sampling=sp)
    d.step()
    d.step()
    d.kill_pool(1, immediate=False)
    assert d.pool_health(1) == "healthy"
    clk.advance(1.5)
    d.step()
    assert d.pool_health(1) == "suspect" and d.pool_states()[1] == "active"
    clk.advance(2.0)
    d.step()
    assert d.pool_states()[1] == "dead"
    d.drain()
    _assert_same(want, _finished(d))
    assert d.summary()["serving/pool_deaths"] == 1.0


def test_transfer_failures_mark_pool_suspect_and_route_around(tlm):
    from bigdl_tpu_torch.serving import HealthConfig, InProcessTransfer

    class Deaf(InProcessTransfer):
        attempts = 0

        def send(self, blob):
            Deaf.attempts += 1
            raise OSError("link down")

    prompts, sps = _trace(n=6), _samplings(6)
    want = _mono(tlm, prompts, sps, slots=6)
    deaf = Deaf()
    d = _plane(tlm, prefill_slots=6, decode_slots=6, decode_pools=2,
               health=HealthConfig(suspect_after_failures=2,
                                   dead_after_failures=50),
               transfer_factory=lambda i: deaf if i == 0
               else InProcessTransfer())
    for p, sp in zip(prompts, sps):
        d.submit(p, max_new_tokens=8, sampling=sp)
    d.drain()
    _assert_same(want, _finished(d))
    assert Deaf.attempts >= 2 and d.pool_health(0) == "suspect"
    n, _ = d.decoders[1].engine.metrics.metrics.get("serving/finished")
    assert n == len(prompts)


# -- graceful drain and the autoscaler -----------------------------------------

def test_drain_pool_migrates_mid_stream_loss_free(tlm):
    prompts, sps = _trace(), _samplings()
    want = _mono(tlm, prompts, sps, slots=4)
    d = _plane(tlm, prefill_slots=4, decode_slots=4, decode_pools=2)
    for p, sp in zip(prompts, sps):
        d.submit(p, max_new_tokens=8, sampling=sp)
    for _ in range(3):
        d.step()
    n = d.drain_pool(0)
    assert n >= 1 and d.pool_states() == ["standby", "active"]
    assert d.decoders[0].engine.scheduler.idle()
    d.drain()
    _assert_same(want, _finished(d))
    s = d.summary()
    assert s["serving/migrated_rows"] >= n
    assert s.get("serving/pool_deaths", 0.0) == 0.0
    # reactivated, it serves again: greedy and explicit-seed rows replay
    # (engine-derived lanes fold in the request id)
    d._activate_pool(0)
    rids2 = [d.submit(p, max_new_tokens=8, sampling=sp)
             for p, sp in zip(prompts, sps)]
    outs2 = d.drain()
    for rid_m, rid_d, sp in zip(sorted(want), rids2, sps):
        if sp is None or sp.seed is not None:
            np.testing.assert_array_equal(outs2[rid_d], want[rid_m][0])


def test_drain_pool_validation(tlm):
    d = _plane(tlm, prefill_slots=2, decode_slots=2, decode_pools=1,
               standby_pools=1)
    for bad in (lambda: d.drain_pool(0), lambda: d.drain_pool(1),
                lambda: d.drain_pool(7)):
        with pytest.raises(ValueError):
            bad()
    d.kill_pool(1)
    with pytest.raises(ValueError):
        d.kill_pool(1)
    with pytest.raises(ValueError):
        _plane(tlm, decode_pools=1, standby_pools=-1)
    with pytest.raises(ValueError):
        _plane(tlm, decode_pools=0)


def test_autoscaler_cycle_up_then_down(tlm):
    from bigdl_tpu_torch.serving import AutoscalerConfig

    prompts, sps = _trace(), _samplings()
    want = _mono(tlm, prompts, sps, gen=12, slots=2)
    d = _plane(tlm, prefill_slots=2, decode_slots=2, decode_pools=1,
               standby_pools=1,
               autoscaler=AutoscalerConfig(high_water=0.9, low_water=0.3,
                                           sustain=2, cooldown=3))
    for p, sp in zip(prompts, sps):
        d.submit(p, max_new_tokens=12, sampling=sp)
    d.drain()
    _assert_same(want, _finished(d))
    assert d.summary()["serving/autoscale_up"] == 1.0
    for _ in range(12):
        d.step()
    s = d.summary()
    assert s["serving/autoscale_down"] == 1.0
    assert d.pool_states().count("active") == 1
    assert s["serving/autoscale_up"] + s["serving/autoscale_down"] == 2.0


# -- transfer hardening ---------------------------------------------------------

def _flaky(clk, fail_first, slow=False):
    from bigdl_tpu_torch.serving import InProcessTransfer

    class Flaky(InProcessTransfer):
        def __init__(self):
            super().__init__()
            self.left = fail_first
            self.attempt_times = []

        def send(self, blob):
            self.attempt_times.append(clk())
            if self.left > 0:
                self.left -= 1
                if slow:
                    clk.advance(1.0)          # returns late, but lands
                else:
                    raise OSError("fabric hiccup")
            super().send(blob)

    return Flaky()


def _drive(d, clk, dt, limit):
    while not d.idle() and limit:
        d.step()
        clk.advance(dt)
        limit -= 1
    assert d.idle()


def test_transfer_backoff_is_exponential_on_virtual_clock(tlm):
    from bigdl_tpu_torch.serving import (
        TransferRetryConfig, VirtualClock, WatchdogConfig,
    )

    clk = VirtualClock()
    tx = _flaky(clk, 3)
    d = _plane(tlm, prefill_slots=2, decode_slots=2, decode_pools=1,
               clock=clk, watchdog=WatchdogConfig(max_retries=5),
               transfer_retry=TransferRetryConfig(backoff_base_s=1.0,
                                                  backoff_cap_s=8.0),
               transfer_factory=lambda i: tx)
    d.submit(_trace(n=1)[0], max_new_tokens=4)
    _drive(d, clk, 0.25, 400)
    t = tx.attempt_times
    assert len(t) == 4                        # 3 failures + the delivery
    for gap, want in zip(np.diff(t), (1.0, 2.0, 4.0)):
        assert want - 1e-9 <= gap <= want + 0.5, t
    req = d.request(0)
    assert req.finish_reason == "length" and len(req.output) == 4


def test_transfer_stall_fault_mode_is_bounded(tlm):
    from bigdl_tpu_torch.serving import (
        FaultInjector, TransferRetryConfig, VirtualClock, WatchdogConfig,
    )

    prompts, sps = _trace(n=6), _samplings(6)
    want = _mono(tlm, prompts, sps, slots=6)
    clk = VirtualClock()
    inj = FaultInjector(seed=2, p_transfer_stall=0.3, stall_s=1.0,
                        clock=clk, max_faults=4)
    d = _plane(tlm, prefill_slots=6, decode_slots=6, decode_pools=2,
               clock=clk, faults=inj,
               watchdog=WatchdogConfig(max_retries=10),
               transfer_retry=TransferRetryConfig(send_timeout_s=0.5,
                                                  backoff_base_s=0.1))
    for p, sp in zip(prompts, sps):
        d.submit(p, max_new_tokens=8, sampling=sp)
    _drive(d, clk, 0.05, 1000)
    _assert_same(want, _finished(d))
    assert inj.counts["transfer_stall"] >= 1
    retries, _ = d.prefill.engine.metrics.metrics.get("serving/retries")
    assert retries >= inj.counts["transfer_stall"]


@pytest.mark.parametrize("pools", [1, 2])
def test_send_timeout_resends_and_receiver_dedups(tlm, pools):
    """A send returning past send_timeout_s resends; the slow original
    landed too, so the duplicate is dropped by request id — across pools
    through the shared claims registry. Served exactly once."""
    from bigdl_tpu_torch.serving import (
        InProcessTransfer, TransferRetryConfig, VirtualClock,
    )

    prompts = _trace(n=3, seed=5)
    want = _mono(tlm, prompts, [None] * 3, gen=6, slots=3)
    clk = VirtualClock()
    tx = _flaky(clk, 1, slow=True)
    d = _plane(tlm, prefill_slots=3, decode_slots=3, decode_pools=pools,
               clock=clk,
               transfer_retry=TransferRetryConfig(send_timeout_s=0.5,
                                                  backoff_base_s=0.1),
               transfer_factory=lambda i: tx if i == 0
               else InProcessTransfer())
    for p in prompts:
        d.submit(p, max_new_tokens=6)
    _drive(d, clk, 0.05, 400)
    _assert_same(want, _finished(d))
    s = d.summary()
    assert s["serving/transfer_timeouts"] >= 1.0
    assert s["serving/finish_length"] == len(prompts)


def test_idle_lull_does_not_kill_healthy_pools(tlm):
    from bigdl_tpu_torch.serving import HealthConfig, VirtualClock

    prompts = _trace(n=4, seed=17)
    want = _mono(tlm, prompts, [None] * 4, gen=6, slots=4)
    clk = VirtualClock()
    d = _plane(tlm, prefill_slots=4, decode_slots=4, decode_pools=2,
               clock=clk,
               health=HealthConfig(suspect_after_s=1.0, dead_after_s=3.0))
    rids1 = [d.submit(p, max_new_tokens=6) for p in prompts]
    outs1 = d.drain()
    clk.advance(60.0)
    rids2 = [d.submit(p, max_new_tokens=6) for p in prompts]
    outs2 = d.drain()
    assert d.pool_states() == ["active", "active"]
    assert d.summary().get("serving/pool_deaths", 0.0) == 0.0
    for rid_m, r1, r2 in zip(sorted(want), rids1, rids2):
        np.testing.assert_array_equal(outs1[r1], want[rid_m][0])
        np.testing.assert_array_equal(outs2[r2], want[rid_m][0])


def test_cancel_reaches_backoff_parking_lot(tlm):
    from bigdl_tpu_torch.serving import TransferRetryConfig, VirtualClock

    clk = VirtualClock()
    d = _plane(tlm, prefill_slots=2, decode_slots=2, decode_pools=1,
               clock=clk,
               transfer_retry=TransferRetryConfig(backoff_base_s=5.0),
               transfer_factory=lambda i: _flaky(clk, 1))
    rid = d.submit(_trace(n=1, seed=19)[0], max_new_tokens=6)
    d.step()                                  # the send fails: deferred
    assert not d.prefill.idle()
    assert d.cancel(rid) is True
    clk.advance(10.0)
    for _ in range(4):
        d.step()
    assert d.idle()
    req = d.request(rid)
    assert req.state == "cancelled" and req.output == []
    assert req.resume_carry is None and d.tier.entries == 0
    s = d.summary()
    assert s["serving/finish_cancelled"] == 1.0
    assert s.get("serving/finish_length", 0.0) == 0.0


def test_cancel_sweeps_inflight_handoff(tlm):
    prompts = _trace(n=4, seed=7)
    d = _plane(tlm, prefill_slots=4, decode_slots=4, decode_pools=1)
    rids = [d.submit(p, max_new_tokens=6) for p in prompts]
    for req, payload in d.prefill.pump():
        d._handoff(req, payload)
    assert d.decoders[0].transfer.pending() == len(prompts)
    assert d.cancel(rids[1]) is True
    assert d.cancel(rids[1]) is False
    outs = d.drain()
    assert rids[1] not in outs
    req = d.request(rids[1])
    assert req.state == "cancelled" and req.resume_carry is None
    s = d.summary()
    assert s["serving/finish_cancelled"] == 1.0
    assert sum(v for k, v in s.items()
               if k.startswith("serving/finish_")) == len(prompts)
    want = _mono(tlm, prompts, [None] * 4, gen=6, slots=4)
    for rid in rids:
        if rid != rids[1]:
            np.testing.assert_array_equal(outs[rid], want[rid][0])
    assert d.tier.entries == 0


def test_failover_latency_percentiles_reported(tlm):
    d = _plane(tlm, prefill_slots=4, decode_slots=2, decode_pools=3)
    for p in _trace(n=6):
        d.submit(p, max_new_tokens=6)
    d.step()
    d.step()
    d.kill_pool(0)
    d.step()
    d.kill_pool(2)
    d.drain()
    s = d.summary()
    assert s["serving/pool_deaths"] == s["serving/failovers"] == 2.0
    assert 0.0 <= s["serving/failover_p50_s"] <= s["serving/failover_p99_s"]
    assert d.metrics.failover_percentiles()["p90"] >= 0.0


def test_last_pool_death_with_standby_activates_it(tlm):
    prompts = _trace(n=4, seed=13)
    want = _mono(tlm, prompts, [None] * 4, gen=6, slots=4)
    d = _plane(tlm, prefill_slots=4, decode_slots=4, decode_pools=1,
               standby_pools=1)
    for p in prompts:
        d.submit(p, max_new_tokens=6)
    d.step()
    d.step()
    d.kill_pool(0)
    d.drain()
    _assert_same(want, _finished(d))
    assert d.pool_states() == ["dead", "active"]
    d2 = _plane(tlm, prefill_slots=4, decode_slots=4, decode_pools=1)
    d2.submit(prompts[0], max_new_tokens=6)
    d2.step()
    d2.step()
    d2.kill_pool(0)
    with pytest.raises(RuntimeError, match="no surviving active"):
        d2.drain()


# -- a real second process dies ----------------------------------------------------

_CHILD = r"""
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.parallel.block_store import FsBlockStore, encode_array
from bigdl_tpu_torch.serving import BlockStoreTransfer, DecodeWorker

lm = TransformerLM(29, hidden_size=32, n_heads=4, n_layers=2, max_len=48,
                   device="cpu", seed=9)
lm.evaluate()
store = FsBlockStore({root!r})
w = DecodeWorker(lm, n_slots=4, device="cpu",
                 transfer=BlockStoreTransfer(store, "handoff"))
want, published = {n}, set()
deadline = time.time() + 300
while len(published) < want and time.time() < deadline:
    if not w.step():
        time.sleep(0.01)
    for rid, req in list(w.engine._finished.items()):
        if rid not in published and req.state == "finished":
            store.put(f"result_{{rid}}",
                      encode_array(np.asarray(req.output, np.int32)))
            published.add(rid)
sys.exit(0 if len(published) == want else 1)
"""


@pytest.mark.slow
def test_two_process_pool_death_reroutes_wire(tmp_path):
    """A real process death at 3 seeds: a child process serves wave A over
    an FsBlockStore channel and exits; wave B's handoffs land on the wire
    after it is gone (sent, never consumed). The parent re-routes the
    packed bytes to its local pool, and every stream of both waves equals
    the monolithic engine's."""
    import pathlib
    import subprocess
    import sys

    from bigdl_tpu_torch.parallel.block_store import (
        FsBlockStore, decode_array,
    )
    from bigdl_tpu_torch.serving import (
        BlockStoreTransfer, DecodeWorker, PrefillWorker,
    )

    from bigdl_tpu_torch.models.transformer import TransformerLM

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    # the child builds the same weights from the same seed
    tlm = TransformerLM(29, hidden_size=32, n_heads=4, n_layers=2,
                        max_len=48, device="cpu", seed=9)
    tlm.evaluate()
    for fault_seed in range(3):
        prompts = _trace(n=6, seed=21 + fault_seed)
        sps = _samplings(6, seed=fault_seed)
        want = _mono(tlm, prompts, sps, gen=6, slots=6)
        rids = sorted(want)
        n_a = 3
        root = str(tmp_path / f"store{fault_seed}")
        store = FsBlockStore(root)
        child = subprocess.Popen(
            [sys.executable, "-c", _CHILD.format(repo=repo, root=root,
                                                 n=n_a)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            pw = PrefillWorker(tlm, n_slots=6, device="cpu")
            remote = BlockStoreTransfer(store, "handoff")
            local = DecodeWorker(tlm, n_slots=6, device="cpu")

            def send_wave(wave):
                for p, sp in wave:
                    pw.submit(p, max_new_tokens=6, sampling=sp)
                while not pw.idle():
                    for req, payload in pw.pump():
                        pw.send_handoff(remote, req, payload,
                                        pw.engine.metrics)

            send_wave(list(zip(prompts, sps))[:n_a])
            wave_a = {rid: decode_array(store.get_blocking(
                f"result_{rid}", timeout_s=300)) for rid in rids[:n_a]}
            child.wait(timeout=300)
            assert child.returncode == 0, \
                child.stderr.read().decode()[-2000:]
            send_wave(list(zip(prompts, sps))[n_a:])
            assert remote.pending() > 0
            # the wave-A results are the delivery acks: the receive
            # cursor resumes after them (the child consumed their keys)
            remote._received = n_a
            while True:
                blob = remote.recv()
                if blob is None:
                    break
                local.transfer.send(blob)
            while not local.idle():
                local.step()
            for rid in rids[:n_a]:
                np.testing.assert_array_equal(wave_a[rid].numpy(),
                                              want[rid][0])
            for rid in rids[n_a:]:
                np.testing.assert_array_equal(
                    local.engine._finished[rid].output, want[rid][0])
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
