"""The port's dispatch-ahead window (``ServingEngine(dispatch_ahead=W)``,
bigdl_tpu_torch/serving/engine.py) against the JAX engine's, on the CPU
at make_pair()'s size (V=29, hidden 32, 4 heads, 2 layers, max_len 48),
the twin of tests/test_serving_async.py's engine tests:

* byte identity: at W in {1, 2, 3} every stream — greedy and seeded
  sampled, tokens and log-probs, slots recycling across 4 requests in 2
  slots — equals the port's W=0 run byte for byte, at fp32 and int8 KV;
  the greedy rows equal the JAX engine's at the same W;
* the window really runs ahead: a dispatch is issued while up to W
  earlier readbacks are still unconsumed, and never more;
* preemption, cancellation and chunked admission under a window, faults
  mid-window (fault counts by kind and retries equal the JAX engine's on
  the same seeded schedule), and the stall watchdog firing through the
  deferred readback under a ``VirtualClock`` — a replayed int8 row
  re-prefills under its own scale history, so there the tokens are
  compared (as the JAX suite does) and the log-probs are not;
* the host/device split: ``host_step_s``, ``decode_step_s`` and
  ``fence_wait_s`` keep one sample per consumed step, and ``drain()``
  leaves nothing in flight.

Tolerances: within the port everything is exact. Against JAX, the greedy
rows' tokens exactly (each was checked to clear the top-2 log-prob gap
rule of tests/test_torch_serving_admission.py), counters and fault
counts exactly; sampled streams within the port only (the RNG lanes
differ)."""

import pytest

from tests.torch_parity import make_pair, one_torch_thread  # noqa: F401

GREEDY = (0, 2)             # the trace's greedy requests


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _trace(sampling_cls):
    """Greedy rows, seeded sampled rows (penalties included) and a
    1-token prompt: 4 requests through 2 slots, so rows recycle while
    dispatches are in flight."""
    return [
        ([3, 7, 2], 10, None),
        ([5, 1], 8, sampling_cls(temperature=0.9, top_k=8, seed=123)),
        ([9], 6, None),
        ([4, 4, 4, 4], 9, sampling_cls(temperature=1.1, seed=7,
                                       repetition_penalty=1.2,
                                       frequency_penalty=0.2)),
    ]


def _port(tlm, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    kw.setdefault("n_slots", 2)
    return ServingEngine(tlm, device="cpu", **kw)


def _jax(jlm, **kw):
    from bigdl_tpu.serving import ServingEngine

    kw.setdefault("n_slots", 2)
    return ServingEngine(jlm, **kw)


def _run(eng, trace=None):
    """(token streams, log-prob streams) of the trace through ``eng``."""
    if trace is None:
        if type(eng).__module__.startswith("bigdl_tpu_torch"):
            from bigdl_tpu_torch.serving import SamplingParams
        else:
            from bigdl_tpu.serving import SamplingParams
        trace = _trace(SamplingParams)
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp)
            for p, n, sp in trace]
    outs = eng.drain()
    return ([outs[r].tolist() for r in rids],
            [eng.logprobs(r).tobytes() for r in rids])


@pytest.fixture(scope="module")
def baseline(pair):
    """The port's W=0 streams per KV dtype."""
    return {kv: _run(_port(pair[1], kv_dtype=kv)) for kv in ("fp32", "int8")}


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("W", [1, 2, 3])
def test_window_byte_identity(pair, baseline, W, kv):
    jlm, tlm = pair
    eng = _port(tlm, kv_dtype=kv, dispatch_ahead=W)
    toks, lps = _run(eng)
    assert (toks, lps) == baseline[kv]
    assert not eng._window
    assert eng.pool.free_slots == eng.pool.n_slots
    jtoks, _ = _run(_jax(jlm, kv_dtype=kv, dispatch_ahead=W))
    for i in GREEDY:
        assert toks[i] == jtoks[i], i


def test_window_zero_is_the_default_and_validated(pair, baseline):
    _, tlm = pair
    eng = _port(tlm, kv_dtype="int8", dispatch_ahead=0)
    assert eng.dispatch_ahead == 0 and _port(tlm).dispatch_ahead == 0
    assert _run(eng) == baseline["int8"]
    with pytest.raises(ValueError, match="dispatch_ahead"):
        _port(tlm, dispatch_ahead=-1)


@pytest.mark.parametrize("W", [0, 1, 2])
def test_window_runs_ahead_of_its_readbacks(pair, W):
    """Count the readbacks outstanding when each decode dispatch starts:
    at most W, and exactly W in the steady state."""
    from bigdl_tpu_torch.serving import fences

    _, tlm = pair
    eng = _port(tlm, kv_dtype="int8", dispatch_ahead=W)
    state = {"out": 0, "max": 0, "at_w": 0}
    step_fn, wait = eng._step_fn, fences.Readback.wait

    def counting_step(*a):
        state["max"] = max(state["max"], state["out"])
        state["at_w"] += state["out"] == W
        state["out"] += 1
        return step_fn(*a)

    def counting_wait(self):
        state["out"] -= 1
        return wait(self)

    eng._step_fn = counting_step
    fences.Readback.wait = counting_wait
    try:
        _run(eng)
    finally:
        fences.Readback.wait = wait
    assert state["out"] == 0 and state["max"] == W
    assert state["at_w"] >= 10


def test_window_preemption_byte_identity(pair, baseline):
    """Priority preemption while dispatches are in flight: the window is
    consumed before the stash, and every stream matches the W=0 run."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    trace = _trace(SamplingParams)
    eng = _port(tlm, kv_dtype="int8", policy="priority", dispatch_ahead=2)
    low = [eng.submit(p, max_new_tokens=n, sampling=sp)
           for p, n, sp in trace[:2]]
    for _ in range(3):
        eng.step()
    hi = [eng.submit(p, max_new_tokens=n, sampling=sp, priority=5)
          for p, n, sp in trace[2:]]
    outs = eng.drain()
    assert [outs[r].tolist() for r in low + hi] == baseline["int8"][0]
    assert eng.metrics.summary()["serving/preempted"] >= 1
    assert not eng._window


def test_window_chunked_admission_byte_identity(pair):
    """Chunked admission with staggered submits: W=2 equals W=0."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    trace = _trace(SamplingParams)

    def run(W):
        eng = _port(tlm, kv_dtype="int8", admission="chunked",
                    chunk_budget=5, dispatch_ahead=W)
        ids = [eng.submit(p, max_new_tokens=n, sampling=sp)
               for p, n, sp in trace[:2]]
        eng.step()
        eng.step()
        ids += [eng.submit(p, max_new_tokens=n, sampling=sp)
                for p, n, sp in trace[2:]]
        outs = eng.drain()
        assert eng.pool.free_slots == eng.pool.n_slots
        return [outs[r].tolist() for r in ids], \
            [eng.logprobs(r).tobytes() for r in ids]

    assert run(2) == run(0)


@pytest.mark.parametrize("seed", [1, 3])
def test_faults_mid_window_byte_identity(pair, baseline, seed):
    """Failed dispatches and garbage readbacks with W=2 in flight: a
    failed dispatch consumes the healthy window first, a garbage entry
    discards every newer one, and replay restores the exact streams. The
    JAX engine on the same schedule counts the same faults and retries."""
    from bigdl_tpu.serving import FaultInjector as JInj
    from bigdl_tpu.serving import WatchdogConfig as JWd
    from bigdl_tpu_torch.serving import FaultInjector, WatchdogConfig

    jlm, tlm = pair
    kw = dict(seed=seed, p_fail=0.25, p_garbage=0.15)
    eng = _port(tlm, kv_dtype="int8", dispatch_ahead=2,
                watchdog=WatchdogConfig(max_retries=None),
                faults=FaultInjector(**kw))
    assert _run(eng)[0] == baseline["int8"][0]
    assert eng._faults.total > 0
    s = eng.metrics.summary()
    assert s["serving/recovered_rows"] > 0
    assert eng.pool.free_slots == eng.pool.n_slots
    jeng = _jax(jlm, kv_dtype="int8", dispatch_ahead=2,
                watchdog=JWd(max_retries=None), faults=JInj(**kw))
    _run(jeng)
    js = jeng.metrics.summary()
    assert {k: v for k, v in jeng._faults.counts.items()
            if k in eng._faults.counts} == eng._faults.counts
    for k in ("serving/retries", "serving/recovered_rows"):
        assert s[k] == js[k], k


def test_stall_watchdog_fires_through_deferred_readback(pair, baseline):
    """A stalled dispatch (the shared VirtualClock advanced at dispatch)
    surfaces at the delayed consumer: elapsed runs from dispatch to the
    readback landing, so the timeout trips a full window later, and
    replay restores the exact streams."""
    from bigdl_tpu_torch.serving import (
        FaultInjector, VirtualClock, WatchdogConfig,
    )

    _, tlm = pair
    clk = VirtualClock()
    eng = _port(tlm, kv_dtype="int8", dispatch_ahead=2, clock=clk,
                watchdog=WatchdogConfig(step_timeout_s=5.0,
                                        max_retries=None),
                faults=FaultInjector(seed=6, p_stall=0.35, stall_s=30.0,
                                     clock=clk))
    assert _run(eng)[0] == baseline["int8"][0]
    assert eng._faults.counts["stall"] > 0
    assert eng.metrics.summary()["serving/retries"] > 0


def test_host_split_pairing_survives_window(pair):
    """host_step_s, decode_step_s and fence_wait_s keep one sample per
    consumed step at W=2 (a flush pads host_step with zeros), and the
    device phases are the blocked ones: decode_step overlaps host work
    under a window and stays out of device_seconds."""
    from bigdl_tpu_torch.serving.metrics import ServingMetrics

    assert "fence_wait" in ServingMetrics.DEVICE_PHASES
    assert "decode_step" not in ServingMetrics.DEVICE_PHASES
    _, tlm = pair
    eng = _port(tlm, kv_dtype="int8", dispatch_ahead=2)
    _run(eng)
    m = eng.metrics.metrics
    _, n_host = m.get("serving/host_step_s")
    _, n_dec = m.get("serving/decode_step_s")
    _, n_fence = m.get("serving/fence_wait_s")
    assert n_host == n_dec == n_fence == eng.metrics.decode_step_count >= 4
    s = eng.metrics.summary()
    assert s["serving/host_step_p50_s"] <= s["serving/host_step_p99_s"]


def test_fence_vocabulary_matches_jax():
    """The fence sites the port uses are among JAX's. ``fence_wait`` hands
    its tree back untouched; an unknown site raises."""
    import torch

    from bigdl_tpu.serving import fences as jf
    from bigdl_tpu_torch.serving import fences as tf

    assert tf.FENCE_SITES <= jf.FENCE_SITES
    tree = {"u": torch.arange(3)}
    assert tf.fence_wait("draft", tree) is tree
    with pytest.raises(ValueError, match="FENCE_SITES"):
        tf.start_readback("nowhere", tree["u"])


def test_cancel_while_dispatches_are_in_flight(pair, baseline):
    """Cancelling a running row with W=2 dispatches in flight frees its
    slot at once; the consumer drops the cancelled row's in-flight values
    (its output stays a prefix of its undisturbed stream), and every
    other stream equals the W=0 run."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    eng = _port(tlm, kv_dtype="int8", dispatch_ahead=2)
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp)
            for p, n, sp in _trace(SamplingParams)]
    for _ in range(4):
        eng.step()
    assert eng._window
    assert eng.cancel(rids[0])
    frozen = list(eng.request(rids[0]).output)
    outs = eng.drain()
    want = baseline["int8"][0]
    assert list(eng.request(rids[0]).output) == frozen
    assert frozen == want[0][:len(frozen)] and len(frozen) < len(want[0])
    assert [outs[r].tolist() for r in rids[1:]] == want[1:]
    assert not eng._window and eng.pool.free_slots == eng.pool.n_slots
