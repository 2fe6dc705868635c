"""The port's disaggregated serving plane (bigdl_tpu_torch/serving/
disagg.py, parallel/block_store.py, the "transfer" fence) against the
JAX package's, on the CPU at make_pair()'s size (V=29, hidden 32, 4
heads, 2 layers, max_len 48):

* the array codec: JAX blobs decode bitwise in the port and port blobs
  in JAX (f32, bf16 through ``ml_dtypes`` on the JAX side, int8, int32,
  int64, bool, 0-d), byte-identical both ways;
* ``fence`` reads back a bf16, an int8 and an f32 value in one copy;
* the wire header (``payload_header``) of a port handoff equals JAX's for
  the same request (budgets, sampling, adapter id, constraint meta, the
  chunk mirrors and the carry key lists);
* ``row_state`` → pack → unpack → ``restore_row`` round-trips every
  field bitwise (int8 with a speculative draft row, and bf16 KV);
* the plane's streams equal the monolithic port engine's: fp32 and bf16,
  prefix cache, chunked admission, evict/readmit inside a decode pool,
  transfer faults, ``BlockStoreTransfer`` over both stores, adapters and
  constraints through a pool kill;
* greedy streams, counters and dispositions equal the JAX plane's on the
  same submits.

Tolerances: within the port, plane streams equal the monolithic engine's
exactly (tokens and chosen log-probs, greedy and seeded sampled alike:
the same arithmetic on the same rows) wherever the plane's pools batch
as many rows as the oracle; where a decode pool holds fewer slots than
the oracle (evict/readmit), tokens exactly and log-probs within
``GEOMETRY_TOL`` = 1e-5, since the CPU's GEMM picks its kernel by row
count. Codec, wire and restore round trips are bitwise. Against JAX: blobs, headers, counters and
dispositions exactly; greedy tokens on requests whose top-2 log-prob gap
clears ``GAP`` = 1e-2 at every generated position (the rule of
tests/test_torch_serving_admission.py), their chosen log-probs within
``LOGP_TOL`` = 1e-3; sampled streams within the port only (the RNG lanes
differ)."""

import json

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    make_pair, one_torch_thread, top2_gaps,
)

GAP = 1e-2
LOGP_TOL = 1e-3
GEOMETRY_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _trace(V=29, n=8, seed=3):
    """Mixed prompts: a 1-token prompt, a shared prefix pair, ragged
    lengths (the JAX suite's trace)."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, V + 1, size=(k,)).tolist()
               for k in (4, 7, 1, 12, 5, 9, 6, 11)][:n]
    if n >= 4:
        prompts[3] = prompts[1][:5] + prompts[3][:4]
    return prompts


def _samplings(n=8):
    from bigdl_tpu_torch.serving import SamplingParams

    mixes = [None,
             SamplingParams(temperature=0.8, top_k=8, seed=11),
             None,
             SamplingParams(temperature=1.1, top_p=0.9),      # engine lane
             SamplingParams(temperature=0.7, repetition_penalty=1.3,
                            seed=5),
             None,
             SamplingParams(temperature=0.9, min_tokens=3,
                            frequency_penalty=0.2, seed=7),
             None]
    return mixes[:n]


def _mono(tlm, prompts, sps, gen=8, slots=6, **kw):
    from bigdl_tpu_torch.serving import ServingEngine

    eng = ServingEngine(tlm, n_slots=slots, device="cpu", **kw)
    rids = [eng.submit(p, max_new_tokens=gen, sampling=sp)
            for p, sp in zip(prompts, sps)]
    outs = eng.drain()
    return {r: (outs[r], eng.logprobs(r)) for r in rids}


def _plane(tlm, slots=6, **kw):
    from bigdl_tpu_torch.serving import DisaggregatedEngine

    kw.setdefault("decode_pools", 2)
    return DisaggregatedEngine(tlm, prefill_slots=slots, decode_slots=slots,
                               device="cpu", **kw)


def _drain_plane(d, prompts, sps, gen=8):
    rids = [d.submit(p, max_new_tokens=gen, sampling=sp)
            for p, sp in zip(prompts, sps)]
    outs = d.drain()
    return {r: (outs[r], d.logprobs(r)) for r in rids}


def _assert_same(want, got, lp_tol=None):
    """Tokens equal; log-probs bitwise, or within ``lp_tol`` where the
    plane's pools batch other row counts than the oracle."""
    assert set(want) == set(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid][0], want[rid][0],
                                      err_msg=f"request {rid}")
        if lp_tol is None:
            assert got[rid][1].tobytes() == want[rid][1].tobytes(), rid
        else:
            np.testing.assert_allclose(got[rid][1], want[rid][1],
                                       atol=lp_tol, rtol=0)


# -- the codec and the fence --------------------------------------------------

_ARRAYS = {
    "f32": lambda r: r.standard_normal((3, 5)).astype(np.float32),
    "bf16": lambda r: r.standard_normal((4, 3)).astype(np.float32),
    "int8": lambda r: r.integers(-128, 128, (2, 7)).astype(np.int8),
    "int32": lambda r: r.integers(-2 ** 31, 2 ** 31, (5,)).astype(np.int32),
    "int64": lambda r: r.integers(-2 ** 62, 2 ** 62, (2, 2)),
    "bool": lambda r: r.random((3, 4)) < 0.5,
    "0-d": lambda r: np.asarray(r.integers(0, 99), np.int32),
}


@pytest.mark.parametrize("kind", sorted(_ARRAYS))
def test_codec_blobs_cross_the_packages_bitwise(kind):
    import ml_dtypes

    from bigdl_tpu.parallel import block_store as jbs
    from bigdl_tpu_torch.parallel import block_store as tbs

    host = _ARRAYS[kind](np.random.default_rng(7))
    if kind == "bf16":
        jarr = host.astype(ml_dtypes.bfloat16)
        tarr = torch.from_numpy(host).to(torch.bfloat16)
    else:
        jarr, tarr = host, torch.from_numpy(np.array(host))
    jblob, tblob = jbs.encode_array(jarr), tbs.encode_array(tarr)
    assert jblob == tblob
    assert tbs.encode_array(host if kind != "bf16" else tarr) == jblob
    got = tbs.decode_array(jblob)                 # JAX blob, port decode
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == host.shape
    assert got.dtype == tarr.dtype
    assert got.contiguous().view(-1).view(torch.uint8).numpy().tobytes() \
        == tarr.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
    back = jbs.decode_array(tblob)                # port blob, JAX decode
    assert back.dtype == jarr.dtype and back.shape == host.shape
    assert back.tobytes() == np.ascontiguousarray(jarr).tobytes()
    with pytest.raises(ValueError, match="block-store"):
        tbs.decode_array(b"XXXX" + tblob[4:])


def test_fence_reads_back_bf16_int8_and_f32_in_one_copy():
    from bigdl_tpu_torch.serving import FENCE_SITES, fence

    r = torch.Generator().manual_seed(3)
    bf = torch.randn(3, 5, generator=r).to(torch.bfloat16)
    i8 = torch.randint(-128, 128, (4,), generator=r, dtype=torch.int8)
    f32 = torch.randn(2, 2, generator=r)
    got_bf, got_i8, got_f32 = fence("transfer", bf, i8, f32)
    assert isinstance(got_bf, torch.Tensor) and got_bf.dtype == torch.bfloat16
    assert torch.equal(got_bf.view(torch.int16), bf.view(torch.int16))
    assert got_i8.dtype == np.int8 and (got_i8 == i8.numpy()).all()
    assert got_f32.dtype == np.float32 and \
        got_f32.tobytes() == f32.numpy().tobytes()
    assert "transfer" in FENCE_SITES
    assert torch.equal(fence("decode", torch.zeros(3, dtype=torch.bfloat16)),
                       torch.zeros(3, dtype=torch.bfloat16))


# -- the wire header against JAX's ---------------------------------------------

def test_payload_header_equals_jax_for_the_same_request(pair):
    """The prefill pool's handoff of the same submits, packed in each
    package: the JSON headers are identical (the leaves are each
    package's own carry)."""
    from bigdl_tpu.serving import (
        PrefillWorker as JPW, SamplingParams as JSP, VirtualClock as JVC,
        from_token_sets as jsets,
    )
    from bigdl_tpu.serving.disagg import (
        pack_payload as jpack, payload_header as jhead,
        request_meta as jmeta,
    )
    from bigdl_tpu_torch.serving import (
        PrefillWorker, SamplingParams, VirtualClock, from_token_sets,
    )
    from bigdl_tpu_torch.serving.disagg import (
        pack_payload, payload_header, request_meta,
    )

    jlm, tlm = pair

    def handoffs(worker, sp, sets):
        worker.submit([3, 7, 2, 9], max_new_tokens=6, eos_id=4,
                      sampling=sp(temperature=0.8, top_k=5, seed=3,
                                  stop_token_ids=(2,)),
                      priority=2, deadline_s=9.0)
        worker.submit([5, 1], max_new_tokens=4,
                      constraint=sets([[4, 9], None, [1, 2]]))
        return worker.pump()

    want = handoffs(JPW(jlm, n_slots=2, kv_dtype="int8", clock=JVC()), JSP,
                    jsets)
    got = handoffs(PrefillWorker(tlm, n_slots=2, kv_dtype="int8",
                                 clock=VirtualClock(), device="cpu"),
                   SamplingParams, from_token_sets)
    assert len(got) == len(want) == 2
    for (jr, jp), (tr, tp) in zip(want, got):
        jh = jhead(jpack(jmeta(jr), jp))
        th = payload_header(pack_payload(request_meta(tr), tp))
        assert json.dumps(th, sort_keys=True) == \
            json.dumps(jh, sort_keys=True)
        assert th["carry_keys"] and th["draft_keys"] is None


# -- row_state round trips -------------------------------------------------------

def _wipe_and_restore(eng, req, restored):
    """Finish ``req`` out of its slot (the pool resets it), take the slot
    back and restore ``restored`` into it: every leaf as before."""
    slot = req.slot
    before = {k: v.clone() for k, v in eng.pool.carry.items()}
    dbefore = None if eng.pool.draft_carry is None else {
        k: v.clone() for k, v in eng.pool.draft_carry.items()}
    eng.pool.free(eng.scheduler.finish(req, 0.0))
    assert eng.pool.alloc() == slot              # LIFO free list
    eng.pool.restore_row(slot, restored)
    for k, v in before.items():
        assert torch.equal(eng.pool.carry[k][slot], v[slot]), k
    for k, v in (dbefore or {}).items():
        assert torch.equal(eng.pool.draft_carry[k][slot], v[slot]), k


def test_row_state_round_trips_every_field_int8_speculative(pair):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import (
        SamplingParams, ServingEngine, SpeculativeConfig, pack_payload,
        unpack_payload,
    )
    from bigdl_tpu_torch.serving.disagg import request_meta

    _, tlm = pair
    draft = TransformerLM(29, hidden_size=16, n_heads=2, n_layers=1,
                          max_len=48, device="cpu", seed=21)
    draft.evaluate()
    eng = ServingEngine(tlm, n_slots=3, kv_dtype="int8", device="cpu",
                        speculative=SpeculativeConfig(draft, k=2))
    eng.submit([3, 7, 2, 9], max_new_tokens=6,
               sampling=SamplingParams(temperature=0.8, top_k=6, seed=13))
    eng.step()
    eng.step()
    (slot, req), = eng.scheduler.running.items()
    eng.pool.chunk_target[slot] = 9
    state = eng.pool.row_state(slot)
    assert state["draft"] is not None
    meta, restored = unpack_payload(pack_payload(request_meta(req), state))
    assert meta["req_id"] == req.req_id and meta["output"] == req.output
    assert all(v.device.type == "cpu" for v in restored["carry"].values())
    _wipe_and_restore(eng, req, restored)
    assert int(eng.pool.chunk_target[slot]) == 9
    assert any(k.endswith("_scale") for k in state["carry"])
    assert {"rng", "tok_counts", "prompt_mask"} <= set(state["carry"])


def test_row_state_round_trips_bf16_kv(pair):
    from bigdl_tpu_torch.serving import (
        ServingEngine, pack_payload, unpack_payload,
    )
    from bigdl_tpu_torch.serving.disagg import request_meta

    _, tlm = pair
    eng = ServingEngine(tlm, n_slots=2, compute_dtype=torch.bfloat16,
                        device="cpu")
    eng.submit([3, 7, 2, 9, 4], max_new_tokens=6)
    eng.step()
    eng.step()
    (slot, req), = eng.scheduler.running.items()
    state = eng.pool.row_state(slot)
    assert state["carry"]["k0"].dtype == torch.bfloat16
    _, restored = unpack_payload(pack_payload(request_meta(req), state))
    assert restored["carry"]["k0"].dtype == torch.bfloat16
    _wipe_and_restore(eng, req, restored)


def test_payload_wire_roundtrip_keeps_adapter(pair):
    from bigdl_tpu_torch.serving import AdapterBank, ServingEngine
    from bigdl_tpu_torch.serving.disagg import (
        pack_payload, request_from_meta, request_meta, unpack_payload,
    )

    _, tlm = pair
    bank = AdapterBank(tlm, 2, 3)
    aid = bank.alloc(bank.random_factors(1, 1.0))
    eng = ServingEngine(tlm, n_slots=2, adapters=bank, device="cpu")
    rid = eng.submit([3, 7, 2], max_new_tokens=6, adapter_id=aid)
    eng.step()
    req = next(r for r in eng.scheduler.running.values() if r.req_id == rid)
    meta, back = unpack_payload(pack_payload(request_meta(req),
                                             eng.pool.row_state(req.slot)))
    assert back["adapter"] == aid
    assert request_from_meta(meta).adapter_id == aid
    eng.drain()


# -- the plane against the monolithic engine ------------------------------------

@pytest.mark.parametrize("variant", ["fp32", "bf16"])
def test_plane_parity_mixed_trace(pair, variant):
    _, tlm = pair
    dt = None if variant == "fp32" else torch.bfloat16
    prompts, sps = _trace(), _samplings()
    want = _mono(tlm, prompts, sps, compute_dtype=dt)
    d = _plane(tlm, compute_dtype=dt)
    _assert_same(want, _drain_plane(d, prompts, sps))
    s = d.summary()
    assert s["serving/handoffs"] == len(prompts)
    assert d.tier.entries == 0 and d.tier.resident_bytes == 0


def test_plane_prefix_cache_interop(pair):
    _, tlm = pair
    prompts = _trace()
    prompts[5] = prompts[1] + [2, 4]
    prompts[6] = prompts[1] + [8]
    sps = [None] * len(prompts)
    want = _mono(tlm, prompts, sps, prefix_cache=True)
    d = _plane(tlm, prefix_cache=True)
    _assert_same(want, _drain_plane(d, prompts, sps))
    hits, _ = d.prefill.engine.metrics.metrics.get("serving/prefix_hits")
    assert hits > 0


def test_plane_chunked_admission_parity(pair):
    _, tlm = pair
    prompts, sps = _trace(), _samplings()
    want = _mono(tlm, prompts, sps, admission="chunked", chunk_budget=6)
    d = _plane(tlm, admission="chunked", chunk_budget=6)
    _assert_same(want, _drain_plane(d, prompts, sps))
    assert d.prefill.engine.metrics.summary().get("serving/chunks", 0) > 0


def test_plane_evict_readmit_in_decode_pool(pair):
    """Priority preemption inside a decode pool: a handed-off row is
    evicted to the tier and readmitted bitwise."""
    from bigdl_tpu_torch.serving import DisaggregatedEngine

    _, tlm = pair
    prompts, sps = _trace(n=6), _samplings(6)
    want = _mono(tlm, prompts, sps)
    d = DisaggregatedEngine(tlm, prefill_slots=6, decode_slots=2,
                            decode_pools=1, policy="priority", device="cpu")
    rids = [d.submit(p, max_new_tokens=8, sampling=sp, priority=0)
            for p, sp in zip(prompts[:4], sps[:4])]
    for _ in range(3):
        d.step()
    rids += [d.submit(p, max_new_tokens=8, sampling=sp, priority=5)
             for p, sp in zip(prompts[4:], sps[4:])]
    outs = d.drain()
    _assert_same(want, {r: (outs[r], d.logprobs(r)) for r in rids},
                 lp_tol=GEOMETRY_TOL)
    s = d.summary()
    assert s["serving/preempted"] >= 1
    n, _ = d.decoders[0].engine.metrics.metrics.get(
        "serving/resumed_without_prefill")
    assert n >= 1


class _Flaky:
    """A transfer wrapper whose first ``fail_first`` sends raise."""

    def __new__(cls, fail_first):
        from bigdl_tpu_torch.serving import InProcessTransfer

        class Flaky(InProcessTransfer):
            def __init__(self):
                super().__init__()
                self.fails_left = fail_first

            def send(self, blob):
                if self.fails_left > 0:
                    self.fails_left -= 1
                    raise OSError("transfer fabric hiccup")
                super().send(blob)

        return Flaky()


def test_fault_during_transfer_recovers_loss_free(pair):
    _, tlm = pair
    prompts, sps = _trace(), _samplings()
    want = _mono(tlm, prompts, sps)
    d = _plane(tlm, transfer_factory=lambda i: _Flaky(2))
    _assert_same(want, _drain_plane(d, prompts, sps))
    retries, _ = d.prefill.engine.metrics.metrics.get("serving/retries")
    assert retries >= 1


def test_persistent_transfer_failure_errors_out(pair):
    from bigdl_tpu_torch.serving import DisaggregatedEngine, WatchdogConfig

    _, tlm = pair
    d = DisaggregatedEngine(tlm, prefill_slots=2, decode_slots=2,
                            decode_pools=1, device="cpu",
                            watchdog=WatchdogConfig(max_retries=2),
                            transfer_factory=lambda i: _Flaky(10 ** 9))
    rids = [d.submit(p, max_new_tokens=4) for p in _trace(n=3)]
    d.drain()
    for rid in rids:
        req = d.request(rid)
        assert req.finish_reason == "error" and req.retries == 3
    assert d.summary()["serving/finish_error"] == len(rids)
    assert d.tier.entries == 0


def test_blockstore_backend_in_process(pair, tmp_path):
    import os

    from bigdl_tpu_torch.parallel.block_store import (
        FsBlockStore, MemBlockStore,
    )
    from bigdl_tpu_torch.serving import BlockStoreTransfer

    _, tlm = pair
    prompts, sps = _trace(), _samplings()
    want = _mono(tlm, prompts, sps)
    root = str(tmp_path / "bs")
    for store in (MemBlockStore(), FsBlockStore(root)):
        d = _plane(tlm, transfer_factory=lambda i, s=store:
                   BlockStoreTransfer(s, f"decode{i}"))
        _assert_same(want, _drain_plane(d, prompts, sps))
    assert os.listdir(root) == []                 # consumed and deleted


def test_plane_metrics_and_accounting(pair):
    from bigdl_tpu_torch.serving import DisaggregatedEngine

    _, tlm = pair
    d = DisaggregatedEngine(tlm, prefill_slots=2, decode_slots=2,
                            decode_pools=2, max_queue=0, device="cpu")
    rids = [d.submit(p, max_new_tokens=4) for p in _trace(n=6)]
    d.drain()
    s = d.summary()
    n_fin = s.get("serving/finish_length", 0)
    n_shed = s.get("serving/finish_shed", 0)
    assert n_fin + n_shed == len(rids) and n_shed > 0
    assert s["serving/handoffs"] == n_fin
    assert s["serving/transfer_bytes_per_handoff"] > 0
    assert s["serving/transfer_p99_s"] >= 0
    assert 0 <= s["serving/decode_occupancy"] <= 1
    shed = [r for r in rids if d.request(r).finish_reason == "shed"]
    assert len(shed) == n_shed
    for r in shed:
        assert d.result(r) is not None and len(d.result(r)) == 0

def test_plane_autopilot_registers_the_pool_scaler(pair):
    """tests/test_serving_autopilot.py:440 on the port: the autopilot
    attaches to the prefill engine, the autoscaler registers on its
    bus as "pool_scale", and streams equal the monolithic engine's."""
    from bigdl_tpu_torch.serving import (
        Autopilot, DisaggregatedEngine, ServingEngine,
    )
    from bigdl_tpu_torch.serving.health import OccupancyAutoscaler

    _, tlm = pair
    prompts = [[3, 7, 2], [9, 4, 5], [6, 1, 8]]
    mono = ServingEngine(tlm, n_slots=2, device="cpu")
    want = [mono.submit(p, max_new_tokens=6) for p in prompts]
    want = [mono.drain()[r].tolist() for r in want]
    ap = Autopilot()
    d = DisaggregatedEngine(tlm, prefill_slots=2, decode_slots=2,
                            decode_pools=2, standby_pools=1,
                            autoscaler=True, autopilot=ap, device="cpu")
    rids = [d.submit(p, max_new_tokens=6) for p in prompts]
    got = d.drain()
    assert [got[r].tolist() for r in rids] == want
    assert isinstance(ap.controllers["pool_scale"], OccupancyAutoscaler)
    assert ap.bus is not None and ap.bus.engine is d.prefill.engine


# -- adapters and constraints across the wire ------------------------------------

def test_adapted_replay_through_pool_failover(pair):
    from bigdl_tpu_torch.serving import AdapterBank, SamplingParams

    _, tlm = pair
    bank = AdapterBank(tlm, 2, 4)
    for s in (1, 2):
        bank.alloc(bank.random_factors(s, 1.0))
    sps = [SamplingParams(temperature=0.8, top_k=10, seed=40 + i)
           for i in range(4)]
    prompts = [[3, 7, 2], [5, 1, 8, 2], [9, 4], [6, 6, 6]]
    aids = [0, 1, 2, 1]

    def submit(e):
        return [e.submit(p, max_new_tokens=8, sampling=sp, adapter_id=a)
                for p, sp, a in zip(prompts, sps, aids)]

    from bigdl_tpu_torch.serving import DisaggregatedEngine, ServingEngine

    mono = ServingEngine(tlm, n_slots=4, seed=7, adapters=bank, device="cpu")
    mr = submit(mono)
    want = mono.drain()
    d = DisaggregatedEngine(tlm, prefill_slots=4, decode_slots=2,
                            decode_pools=2, seed=7, adapters=bank,
                            device="cpu")
    dr = submit(d)
    for _ in range(3):
        d.step()
    d.kill_pool(0)
    got = d.drain()
    for a, b in zip(mr, dr):
        np.testing.assert_array_equal(want[a], got[b])
    assert bank.live == {1: 1, 2: 1}         # only the allocations' own


def test_constraint_crosses_the_wire(pair):
    from bigdl_tpu_torch.serving import (
        DisaggregatedEngine, SamplingParams, ServingEngine, TokenDFA,
        from_token_sets,
    )
    from bigdl_tpu_torch.serving.disagg import request_from_meta, request_meta
    from bigdl_tpu_torch.serving.scheduler import Request

    _, tlm = pair
    cons = from_token_sets([[4, 9, 2], None, [1, 2, 3]])
    req = Request(req_id=5, prompt=[3], max_new_tokens=4, constraint=cons)
    back = request_from_meta(json.loads(json.dumps(request_meta(req))))
    assert back.constraint.states == cons.states
    assert TokenDFA.from_meta(cons.to_meta()).start == cons.start

    sp = SamplingParams(temperature=0.8, top_k=10, seed=40)
    mono = ServingEngine(tlm, n_slots=4, seed=7, device="cpu")
    m0 = mono.submit([3, 7, 2], max_new_tokens=8, sampling=sp,
                     constraint=cons)
    m1 = mono.submit([5, 1, 8], max_new_tokens=8)
    want = mono.drain()
    d = DisaggregatedEngine(tlm, prefill_slots=2, decode_slots=2,
                            decode_pools=2, seed=7, device="cpu")
    d0 = d.submit([3, 7, 2], max_new_tokens=8, sampling=sp, constraint=cons)
    d1 = d.submit([5, 1, 8], max_new_tokens=8)
    for _ in range(3):
        d.step()
    d.kill_pool(0)
    got = d.drain()
    np.testing.assert_array_equal(want[m0], got[d0])
    np.testing.assert_array_equal(want[m1], got[d1])
    assert got[d0][0] in (4, 9, 2) and got[d0][2] in (1, 2, 3)


def test_constraint_meta_equals_jax():
    from bigdl_tpu.serving import from_token_sets as jsets, fixed_sequence \
        as jfixed
    from bigdl_tpu_torch.serving import fixed_sequence, from_token_sets

    for tm, jm in ((from_token_sets([[4, 9, 2], None, [1, 2, 3]]),
                    jsets([[4, 9, 2], None, [1, 2, 3]])),
                   (fixed_sequence([5, 3, 5]), jfixed([5, 3, 5]))):
        assert json.dumps(tm.to_meta()) == json.dumps(jm.to_meta())


# -- against the JAX plane ---------------------------------------------------------

def test_greedy_streams_and_counters_equal_the_jax_plane(pair):
    """The same greedy submits through both planes (int8 KV, 2 decode
    pools): dispositions, handoffs, per-pool finishes and gap-cleared
    streams equal."""
    from bigdl_tpu.serving import DisaggregatedEngine as JaxPlane

    jlm, tlm = pair
    prompts = _trace()
    jd = JaxPlane(jlm, prefill_slots=6, decode_slots=6, decode_pools=2,
                  kv_dtype="int8")
    td = _plane(tlm, kv_dtype="int8")
    outs = []
    for d in (jd, td):
        rids = [d.submit(p, max_new_tokens=8) for p in prompts]
        o = d.drain()
        outs.append([(np.asarray(o[r]), np.asarray(d.logprobs(r)))
                     for r in rids])
    js, ts = jd.summary(), td.summary()
    for k in ("serving/handoffs", "serving/finish_length",
              "serving/finished", "serving/tokens_out"):
        assert ts[k] == js[k], k
    for je, te in zip(jd._engines(), td._engines()):
        assert te.metrics.metrics.get("serving/finished") == \
            je.metrics.metrics.get("serving/finished")
    compared = 0
    for p, (w, wl), (g, gl) in zip(prompts, *outs):
        assert len(g) == len(w)
        if top2_gaps(jlm, p, list(w)).min() > GAP:
            np.testing.assert_array_equal(g, w, err_msg=str(p))
            np.testing.assert_allclose(gl, wl, atol=LOGP_TOL, rtol=0)
            compared += 1
    assert compared >= len(prompts) // 2, compared


# -- two processes over a shared directory ------------------------------------------

_TWO_PROC_CHILD = r"""
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
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
def test_two_process_blockstore_handoff(tmp_path):
    """This process runs the prefill pool, a child process a decode pool,
    and rows cross through an FsBlockStore: outputs equal the monolithic
    engine's (both processes build the same weights from the seed)."""
    import pathlib
    import subprocess
    import sys

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.parallel.block_store import (
        FsBlockStore, decode_array,
    )
    from bigdl_tpu_torch.serving import BlockStoreTransfer, PrefillWorker

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    tlm = TransformerLM(29, hidden_size=32, n_heads=4, n_layers=2,
                        max_len=48, device="cpu", seed=9)
    tlm.evaluate()
    prompts, sps = _trace(n=5), _samplings(5)
    want = _mono(tlm, prompts, sps, gen=6, slots=5)
    root = str(tmp_path / "store")
    store = FsBlockStore(root)
    child = subprocess.Popen(
        [sys.executable, "-c",
         _TWO_PROC_CHILD.format(repo=repo, root=root, n=len(prompts))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        pw = PrefillWorker(tlm, n_slots=5, device="cpu",
                           transfer=BlockStoreTransfer(store, "handoff"))
        for p, sp in zip(prompts, sps):
            pw.submit(p, max_new_tokens=6, sampling=sp)
        while not pw.idle():
            pw.pump()
        for rid in want:
            got = decode_array(store.get_blocking(f"result_{rid}",
                                                  timeout_s=300))
            np.testing.assert_array_equal(got.numpy(), want[rid][0])
    finally:
        try:
            child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
    assert child.returncode == 0, child.stderr.read().decode()[-2000:]
    assert pw.engine.metrics.summary()["serving/handoffs"] == len(prompts)
