"""The port's serving engine (bigdl_tpu_torch/serving/) against the JAX
package's, on the CPU at V=29, hidden 32, 4 heads, 2 layers, max_len 48:

* ``ServingEngine(device="cpu", kv_dtype=...)`` vs the JAX
  ``ServingEngine`` on the same submits, more requests than slots so
  slots recycle: greedy tokens EQUAL at fp32 compute, on a request set
  whose top-2 log-prob gaps this test checks from the JAX model itself
  (every generated position must clear ``GAP``); chosen log-probs within
  ``LOGP_TOL``;
* seeded sampled rows replay identically within the port across batch
  composition, slot placement, slot count and fault-recovery replay
  (counter-based lanes; torch cannot reproduce JAX's threefry draws, so
  sampled streams are not compared across frameworks);
* the fused sampler's deterministic part (penalties, bans, top-k=1) vs
  JAX ``sample_rows``;
* entry points raise without a card unless ``device="cpu"``; knobs
  outside the slice raise ``NotImplementedError``; pool, fence and
  metrics contracts.

Tolerances: ``LOGP_TOL`` 1e-3 absolute on chosen log-probs (f32 math in
both; an int8 cache value on a rounding boundary may land one quantum
apart between the two frameworks); ``GAP`` 1e-2, ten times that."""

import numpy as np
import pytest
import torch

from tests.torch_parity import make_pair, top2_gaps

LOGP_TOL = 1e-3
GAP = 1e-2


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _reqs(n=8, vocab=29, seed=14):
    """More requests than the engines' 3 slots, so later requests are
    admitted into recycled slots."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, vocab + 1,
                         size=(int(rng.randint(1, 8)),)).tolist(),
             int(rng.randint(4, 11))) for _ in range(n)]


def _run_port(tlm, reqs, sampling=None, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    kw.setdefault("device", "cpu")
    eng = ServingEngine(tlm, **kw)
    sampling = sampling or [None] * len(reqs)
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp)
            for (p, n), sp in zip(reqs, sampling)]
    return eng, rids, eng.drain()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp32"])
def test_engine_greedy_matches_jax_engine(pair, kv_dtype):
    from bigdl_tpu.serving import ServingEngine as JaxEngine

    jlm, tlm = pair
    reqs = _reqs()
    jeng = JaxEngine(jlm, n_slots=3, kv_dtype=kv_dtype)
    jrids = [jeng.submit(p, max_new_tokens=n) for p, n in reqs]
    jouts = jeng.drain()
    eng, rids, outs = _run_port(tlm, reqs, n_slots=3, kv_dtype=kv_dtype)
    for (p, n), jr, r in zip(reqs, jrids, rids):
        want = jouts[jr]
        assert len(want) == n
        assert top2_gaps(jlm, p, want.tolist()).min() > GAP, p
        np.testing.assert_array_equal(outs[r], want, err_msg=str(p))
        np.testing.assert_allclose(eng.logprobs(r), jeng.logprobs(jr),
                                   atol=LOGP_TOL, rtol=0)
    assert eng.pool.free_slots == eng.pool.n_slots     # clean drain
    assert eng.summary()["serving/finish_length"] == len(reqs)


def test_seeded_sampling_replays_across_batching_and_slots(pair):
    """One seeded sampled request gives ONE stream alone, behind other
    traffic (another slot), in a smaller pool (admitted late into a
    recycled slot) and under a different engine seed."""
    from bigdl_tpu_torch.serving import SamplingParams

    _, tlm = pair
    sp = SamplingParams(temperature=0.9, top_k=8, top_p=0.95, seed=123)
    probe = ([3, 7, 2], 10)
    _, r, o = _run_port(tlm, [probe], sampling=[sp], n_slots=3,
                        kv_dtype="int8")
    want = o[r[0]]
    other = _reqs(4, seed=5)
    mixed = [SamplingParams(temperature=1.2, seed=7), None, None, None]
    for n_slots, seed in ((3, 0), (2, 0), (2, 11)):
        _, rids, outs = _run_port(
            tlm, other + [probe], sampling=mixed + [sp], n_slots=n_slots,
            kv_dtype="int8", seed=seed)
        np.testing.assert_array_equal(outs[rids[-1]], want)


def test_fault_recovery_replays_streams_loss_free(pair):
    """Evicting every running row mid-stream (the recovery path a failed
    or unhealthy step takes) replays each request from prompt + output:
    greedy and seeded sampled streams come out unchanged."""
    from bigdl_tpu_torch.serving import SamplingParams, ServingEngine

    _, tlm = pair
    reqs = _reqs(5, seed=3)
    sps = [SamplingParams(temperature=0.8, seed=i) if i % 2 else None
           for i in range(len(reqs))]
    _, rids, want = _run_port(tlm, reqs, sampling=sps, n_slots=3,
                              kv_dtype="int8")
    eng = ServingEngine(tlm, n_slots=3, kv_dtype="int8", device="cpu")
    got_ids = [eng.submit(p, max_new_tokens=n, sampling=sp)
               for (p, n), sp in zip(reqs, sps)]
    for _ in range(3):
        eng.step()
    eng._recover_rows(list(eng.scheduler.running.items()))
    outs = eng.drain()
    for a, b in zip(rids, got_ids):
        np.testing.assert_array_equal(outs[b], want[a])
    s = eng.summary()
    assert s["serving/retries"] == 3 and s["serving/recovered_rows"] == 3


@pytest.mark.parametrize("case", ["greedy_penalties", "ban", "top_k_1"])
def test_sampler_matches_jax_sample_rows(case):
    """The sampler's deterministic paths equal JAX ``sample_rows`` token
    for token (temperature 0 with penalties; the min-tokens ban; a
    temperature > 0 row with top_k=1, which leaves one candidate)."""
    import jax.numpy as jnp

    from bigdl_tpu.serving.sampling import (
        make_knob_rows as jax_knobs, sample_rows as jax_sample,
    )
    from bigdl_tpu_torch.serving.sampling import (
        make_knob_rows, sample_rows,
    )

    N, V = 4, 29
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((N, V)).astype(np.float32) * 3
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    counts = rng.integers(0, 3, size=(N, V)).astype(np.int32)
    prompt = rng.random((N, V)) < 0.2
    knobs = make_knob_rows(N)
    knobs["repetition_penalty"][:] = [1.0, 1.3, 2.0, 1.1]
    knobs["presence_penalty"][:] = [0.0, 0.5, 0.0, 0.2]
    knobs["frequency_penalty"][:] = [0.0, 0.0, 0.4, 0.1]
    if case == "ban":
        knobs["ban"][:] = True
        knobs["ban_ids"][:, :2] = np.argsort(-logp, axis=-1)[:, :2]
    if case == "top_k_1":
        knobs["temperature"][:] = 0.7
        knobs["top_k"][:] = 1
    jk = jax_knobs(N)
    jk.update({k: jnp.asarray(v) for k, v in knobs.items()})
    jtok, jchosen, _, jcounts = jax_sample(
        jnp.asarray(logp), jnp.zeros((N, 2), jnp.uint32), jk,
        jnp.asarray(counts), jnp.asarray(prompt))
    tk = {k: torch.from_numpy(v) for k, v in knobs.items()}
    tok, chosen, lanes, tcounts = sample_rows(
        torch.from_numpy(logp), torch.zeros((N, 2), dtype=torch.int64), tk,
        torch.from_numpy(counts), torch.from_numpy(prompt))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert lanes[:, 1].tolist() == [1] * N


def test_lane_uniforms_depend_only_on_seed_and_draws():
    from bigdl_tpu_torch.serving.sampling import (
        advance_lane, fold_lane, lane_key, lane_uniforms,
    )

    lanes = torch.as_tensor(np.stack([lane_key(5), advance_lane(
        lane_key(5), 3), fold_lane(0, 1), lane_key(6)]))
    u = lane_uniforms(lanes, 1000)
    assert u.dtype == torch.float32 and bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.mean()) - 0.5) < 0.03
    alone = lane_uniforms(lanes[1:2], 1000)
    assert torch.equal(alone[0], u[1])                 # batch-independent
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[3])
    np.testing.assert_array_equal(advance_lane(lane_key(5), 3), [5, 3])


def test_entry_points_need_a_card_or_cpu_by_name(pair):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import ServingEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tlm = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tlm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(29, hidden_size=32, n_heads=4, n_layers=1, max_len=8)


@pytest.mark.parametrize("where,knob", [
    ("engine", {"mesh": object()}), ("engine", {"parallelism": {"data": 2}}),
    ("engine", {"autopilot": object()})])
def test_knobs_outside_the_slice_raise(pair, where, knob):
    from bigdl_tpu_torch.serving import ServingEngine

    _, tlm = pair
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(tlm, device="cpu", **knob)


def test_kv_dtype_validation(pair):
    from bigdl_tpu_torch.serving import ServingEngine

    _, tlm = pair
    with pytest.raises(ValueError, match="conflicts"):
        ServingEngine(tlm, device="cpu", kv_dtype="bf16")
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        ServingEngine(tlm, device="cpu", kv_dtype="fp8")
    with pytest.raises(TypeError):
        ServingEngine(tlm, device="cpu", no_such_knob=1)


def test_pool_recycles_slots_and_resets_scales(pair):
    """free() resets pos and the int8 scales of the slot (a recycled slot
    must not inherit its occupant's range); alloc/free invariants."""
    from bigdl_tpu_torch.models.transformer import make_batch_decode_step
    from bigdl_tpu_torch.serving import KVPool

    _, tlm = pair
    _, init = make_batch_decode_step(tlm, kv_quant=True, sampling=True)
    pool = KVPool(init, 2, kv_dtype="int8")
    assert pool.kv_bytes_per_slot == 2 * 2 * (48 * 32 + 4 * 4)
    a = pool.alloc()
    pool.carry["k1_scale"][a] = 3.0
    pool.carry["pos"][a] = 9
    pool.write_sampling(a, [4, 2], [1, 5], output_ids=[5, 5, 7])
    assert pool.carry["tok_counts"][a, 4] == 2
    assert bool(pool.carry["prompt_mask"][a, 0])
    row = pool.read_row(a)
    assert row["k1_scale"].shape == (1, 4)
    assert float(row["k1_scale"][0, 0]) == 3.0
    pool.carry["k1_scale"][a] = 5.0                    # a fresh copy
    assert float(row["k1_scale"][0, 0]) == 3.0
    pool.free(a)
    assert float(pool.carry["k1_scale"][a].abs().sum()) == 0.0
    assert int(pool.carry["pos"][a]) == 0
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(a)
    assert {pool.alloc(), pool.alloc()} == {0, 1} and pool.alloc() is None
    with pytest.raises(ValueError, match="kv_dtype"):
        KVPool(init, 2, kv_dtype="fp32")


def test_fence_reads_back_exact_values_in_one_copy():
    from bigdl_tpu_torch.serving.fences import fence

    tok = torch.tensor([3, -1, 2 ** 40], dtype=torch.int64)
    lp = torch.tensor([-0.5, float("nan"), -1e-30])
    a, b = fence("decode", tok, lp)
    np.testing.assert_array_equal(a, tok.numpy())
    np.testing.assert_array_equal(b, lp.numpy())
    assert fence("decode", tok).tolist() == tok.tolist()
    with pytest.raises(ValueError, match="FENCE_SITES"):
        fence("nowhere", tok)


def test_fifo_policy_runs_batches_to_completion(pair):
    """fifo refills only after the running batch drained; outputs equal
    the default policy's (per-row independence)."""
    _, tlm = pair
    reqs = _reqs(5, seed=9)
    _, r1, o1 = _run_port(tlm, reqs, n_slots=2, kv_dtype="int8")
    eng, r2, o2 = _run_port(tlm, reqs, n_slots=2, kv_dtype="int8",
                            policy="fifo")
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(o1[a], o2[b])
    s = eng.summary()
    assert s["serving/ttft_p50_s"] > 0 and s["serving/tokens_per_sec"] > 0
    assert s["serving/decode_step_p50_s"] > 0


def test_stop_tokens_and_eos_finish_rows(pair):
    """A row stops on its own eos or on a stop token (the token is
    emitted, then the row finishes with that reason); min_tokens bans
    both on the card until the floor is met."""
    from bigdl_tpu_torch.serving import SamplingParams, ServingEngine

    _, tlm = pair
    _, r, o = _run_port(tlm, [([3, 7, 2], 10)], n_slots=1, kv_dtype="int8")
    free_run = o[r[0]].tolist()
    eos, stop = free_run[2], free_run[1]
    eng = ServingEngine(tlm, n_slots=3, kv_dtype="int8", device="cpu")
    a = eng.submit([3, 7, 2], max_new_tokens=10, eos_id=eos)
    b = eng.submit([3, 7, 2], max_new_tokens=10, sampling=SamplingParams(
        stop_token_ids=(stop,)))
    c = eng.submit([3, 7, 2], max_new_tokens=10, eos_id=eos,
                   sampling=SamplingParams(min_tokens=6))
    eng.drain()
    assert eng.result(a).tolist() == free_run[:free_run.index(eos) + 1]
    assert eng.request(a).finish_reason == "eos"
    assert eng.result(b).tolist() == free_run[:free_run.index(stop) + 1]
    assert eng.request(b).finish_reason == "stop"
    assert eos not in eng.result(c).tolist()[:5]
    assert len(eng.result(c)) >= 6


def test_watchdog_timeout_replays_then_fails_out(pair):
    """A step that overruns ``step_timeout_s`` (armed after the first
    healthy step) is discarded and its rows replayed; past
    ``max_retries`` the request finishes with ``finish_reason='error'``,
    keeping the tokens of its healthy steps — the engine never wedges.
    One-token prompts start decoding with no prefill."""
    from bigdl_tpu_torch.serving import ServingEngine, WatchdogConfig

    _, tlm = pair
    eng = ServingEngine(tlm, n_slots=2, kv_dtype="int8", device="cpu",
                        watchdog=WatchdogConfig(step_timeout_s=1e-9,
                                                max_retries=1))
    rids = [eng.submit([4], max_new_tokens=6),
            eng.submit([3, 7, 2], max_new_tokens=6)]
    outs = eng.drain()
    for r in rids:
        assert eng.request(r).finish_reason == "error"
        assert len(outs[r]) == 1 and eng.request(r).retries == 2
    s = eng.summary()
    assert s["serving/finish_error"] == 2 and s["serving/retries"] == 2
    assert eng.pool.free_slots == 2
