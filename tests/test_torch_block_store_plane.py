"""The port's block-store parameter plane (``parallel/block_store.py``:
``GradientDropPolicy``, ``BlockStoreParameter``, ``CoordServiceBlockStore``)
and ``DistriOptimizer(parameter_mode="blockstore")`` on one process, the
twin of ``tests/test_block_store.py``.

The exchange takes (pid, n_procs) explicitly, so threads sharing one
``FsBlockStore`` drive the whole putGradients → aggregate-with-drop →
publish/get weights dataflow as processes would; the same exchange runs
through the JAX package's ``BlockStoreParameter`` on the same inputs and
both are held to the numpy oracle and to each other. Deadlines are wide
(0.5 s floor, 2 s straggler) so six busy pytest workers cannot push an
honest contribution past them."""

import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.parallel.block_store import (
    BlockStoreParameter, CoordServiceBlockStore, FsBlockStore,
    GradientDropPolicy, decode_array, encode_array,
)
from tests.straggler import DelayedGradientPuts
from tests.torch_parity import one_torch_thread  # noqa: F401


# -- the drop policy -------------------------------------------------------

def test_drop_policy_warmup_and_threshold():
    from bigdl_tpu.parallel.block_store import GradientDropPolicy as JPolicy

    for cls in (GradientDropPolicy, JPolicy):
        p = cls(0.3, compute_threshold_batch_size=10, warmup_iteration=3,
                min_deadline_s=0.0)
        assert p.deadline(0) is None
        for d in [0.1] * 7 + [1.0] * 3:
            p.record(d)
        assert p.deadline(2) is None
        dl = p.deadline(3)
        assert dl is not None and dl < 0.5
        assert p.min_arrivals(3) == 3
        assert cls(0.5).min_arrivals(4) == 2
        assert cls(0.9).min_arrivals(10) == 1
    j = JPolicy(0.3, warmup_iteration=0, min_deadline_s=0.0)
    t = GradientDropPolicy(0.3, warmup_iteration=0, min_deadline_s=0.0)
    for d in np.random.RandomState(0).rand(40):
        j.record(d)
        t.record(d)
    assert t.deadline(5) == j.deadline(5)


def test_drop_policy_floor_and_validation():
    p = GradientDropPolicy(0.5, warmup_iteration=0, min_deadline_s=0.25)
    p.record(0.001)
    assert p.deadline(1) == 0.25
    with pytest.raises(ValueError):
        GradientDropPolicy(1.0)
    with pytest.raises(ValueError):
        GradientDropPolicy(0.5, max_drop_percentage=0.2)


# -- the threaded exchange -------------------------------------------------

def _run_exchange(cls, store, n, total, grads, w0, n_iters=1, policies=None,
                  put_delays=None, lr=0.1, compress=None):
    """n ``cls`` (the port's or JAX's BlockStoreParameter) driven by
    threads: each iteration every pid contributes its gradient, owners
    aggregate and SGD-update their slice, everyone assembles the vector.
    Returns (final weights per pid, the parameter objects)."""
    results, bsps, errors = [None] * n, [None] * n, []

    def worker(pid):
        try:
            st = store
            if put_delays and put_delays.get(pid):
                st = DelayedGradientPuts(store, *put_delays[pid])
            bsp = cls(st, n, pid, total, compress=compress,
                      drop_policy=policies[pid] if policies else None,
                      timeout_s=60.0)
            bsps[pid] = bsp
            w = w0.copy()
            for t in range(n_iters):
                bsp.put_gradients(t, grads[pid])
                gmy, _, _ = bsp.aggregate_my_partition(t)
                lo = pid * bsp.shard_size
                new_w = bsp._pad(w)[lo:lo + bsp.shard_size] - lr * gmy
                bsp.publish_weights(t + 1, new_w)
                w = bsp.get_weights(t + 1)
            results[pid] = w
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append((pid, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    return results, bsps


@pytest.mark.parametrize("compress", [None, "bf16"])
def test_threaded_exchange_matches_numpy_and_jax(tmp_path, compress):
    """3 contributors over 103 elements (padding), two SGD steps: every pid
    assembles the numpy oracle (f32: 1e-6; bf16-compressed remote slices:
    2e-2), and the port's vector equals JAX's exchange on the same
    inputs bitwise (bf16: the same round-to-nearest-even)."""
    from bigdl_tpu.parallel.block_store import (
        BlockStoreParameter as JBlockStoreParameter,
        FsBlockStore as JFsBlockStore,
    )

    rs = np.random.RandomState(1)
    total, n = 103, 3
    w0 = rs.rand(total).astype(np.float32)
    gs = [rs.rand(total).astype(np.float32) for _ in range(n)]
    got, _ = _run_exchange(BlockStoreParameter, FsBlockStore(
        str(tmp_path / "t")), n, total, gs, w0, n_iters=2, compress=compress)
    want, _ = _run_exchange(JBlockStoreParameter, JFsBlockStore(
        str(tmp_path / "j")), n, total, gs, w0, n_iters=2, compress=compress)
    oracle = w0 - 0.1 * np.mean(gs, axis=0) * 2
    tol = 1e-6 if compress is None else 2e-2
    for pid in range(n):
        np.testing.assert_array_equal(got[pid], got[0])
        np.testing.assert_allclose(got[pid], oracle, rtol=tol, atol=tol)
        np.testing.assert_array_equal(got[pid], want[pid])


def test_blobs_decode_in_either_package(tmp_path):
    """A bf16-compressed gradient blob the port writes decodes in the JAX
    package to the same values, and the other way round."""
    from bigdl_tpu.parallel.block_store import (
        BlockStoreParameter as JBlockStoreParameter, FsBlockStore as JFs,
    )

    g = np.random.RandomState(5).randn(64).astype(np.float32)
    port = BlockStoreParameter(FsBlockStore(str(tmp_path / "a")), 2, 0, 64,
                               compress="bf16")
    jax_ = JBlockStoreParameter(JFs(str(tmp_path / "b")), 2, 0, 64,
                                compress="bf16")
    np.testing.assert_array_equal(
        JBlockStoreParameter._decode(port._encode(g)),
        BlockStoreParameter._decode(jax_._encode(g)))


def test_threaded_exchange_drops_straggler(tmp_path):
    """pid 2's gradient puts are 2 s late from iteration 1 on: owners 0
    and 1 aggregate without it after the warm-up (mean over 2), pid 2's
    own partition still sees all 3, and every pid assembles the same
    weights."""
    total, n, n_iters = 60, 3, 3
    gs = [np.full(total, float(pid + 1), np.float32) for pid in range(n)]
    policies = [GradientDropPolicy(0.34, warmup_iteration=1,
                                   min_deadline_s=0.5) for _ in range(n)]
    results, bsps = _run_exchange(
        BlockStoreParameter, FsBlockStore(str(tmp_path / "bs")), n, total,
        gs, np.zeros(total, np.float32), n_iters=n_iters, policies=policies,
        put_delays={2: (2.0,)})
    for pid in range(1, n):
        np.testing.assert_array_equal(results[0], results[pid])
    assert bsps[0].dropped_total == n_iters - 1
    assert bsps[1].dropped_total == n_iters - 1
    assert bsps[2].dropped_total == 0
    assert set(bsps[0].dropped_by_src) == {2}
    sh = bsps[0].shard_size
    mean01, mean012 = 1.5, 2.0
    exp = np.zeros(total, np.float32)
    exp[:2 * sh] -= 0.1 * (mean012 + 2 * mean01)
    exp[2 * sh:] -= 0.1 * (3 * mean012)
    np.testing.assert_allclose(results[0], exp, rtol=1e-6, atol=1e-6)


def test_drop_deadline_recovers_after_straggler(tmp_path):
    """A deadline-truncated wait is never recorded; a dropped contribution
    that lands late is probed by the next aggregation, so its real
    duration enters the window and the block is reaped."""
    store = FsBlockStore(str(tmp_path / "bs"))
    policy = GradientDropPolicy(0.5, warmup_iteration=0,
                                compute_threshold_batch_size=8,
                                min_deadline_s=0.05)
    owner = BlockStoreParameter(store, 2, 0, 8, drop_policy=policy,
                                timeout_s=5.0)
    peer = BlockStoreParameter(store, 2, 1, 8, timeout_s=5.0)
    g = np.ones(8, np.float32)
    peer.put_gradients(0, g)
    owner.put_gradients(0, g)
    owner.aggregate_my_partition(0)
    assert len(policy._samples) == 1
    owner.put_gradients(1, g)
    _, arrived, dropped = owner.aggregate_my_partition(1)
    assert arrived == 1 and dropped == [1] and owner.dropped_total == 1
    assert len(policy._samples) == 1
    peer.put_gradients(1, g * 2.0)          # lands after the drop
    time.sleep(0.06)
    peer.put_gradients(2, g)
    owner.put_gradients(2, g)
    owner.aggregate_my_partition(2)
    assert [s for s in policy._samples if s > 0.05], list(policy._samples)
    assert store.try_get(owner._gkey(1, 0, 1)) is None
    assert not owner._late_probes


def test_calibration_uses_publish_time(tmp_path):
    """A contribution that sat in the store before the owner began
    aggregating records its publish-to-arrival time, not ~0 s."""
    store = FsBlockStore(str(tmp_path / "bs"))
    policy = GradientDropPolicy(0.5, warmup_iteration=0, min_deadline_s=0.05)
    owner = BlockStoreParameter(store, 2, 0, 8, drop_policy=policy,
                                timeout_s=5.0)
    peer = BlockStoreParameter(store, 2, 1, 8, timeout_s=5.0)
    g = np.ones(8, np.float32)
    peer.put_gradients(0, g)
    time.sleep(0.2)
    owner.put_gradients(0, g)
    owner.aggregate_my_partition(0)
    assert policy._samples[0] >= 0.15, list(policy._samples)


def test_late_blocks_garbage_collected(tmp_path):
    store = FsBlockStore(str(tmp_path / "bs"))
    bsp = BlockStoreParameter(store, 2, 0, 10, timeout_s=5.0)
    peer = BlockStoreParameter(store, 2, 1, 10, timeout_s=5.0)
    g = np.ones(10, np.float32)
    for t in range(4):
        peer.put_gradients(t, g * (t + 1))
        bsp.put_gradients(t, g)
        bsp.aggregate_my_partition(t)
        store.put(bsp._gkey(t, 0, 1), encode_array(g[:bsp.shard_size]))
    assert store.try_get(bsp._gkey(0, 0, 1)) is None
    assert store.try_get(bsp._gkey(1, 0, 1)) is None


def test_sweep_stale_reaps_previous_attempt(tmp_path):
    store = FsBlockStore(str(tmp_path / "bs"))
    bsp = BlockStoreParameter(store, 2, 0, 10, timeout_s=5.0)
    g = np.ones(10, np.float32)
    for t in range(5):
        bsp.put_gradients(t, g)
        bsp._my_slice_cache = None
        bsp.publish_weights(t + 1, g[:bsp.shard_size])
        bsp.publish_aux(t, "loss", np.float32(1.0))
    assert store.try_get(bsp._gkey(4, 1, 0)) is not None
    fresh = BlockStoreParameter(store, 2, 0, 10, timeout_s=5.0)
    fresh.sweep_stale(aux_names=("loss",))
    for t in range(2, 6):
        assert store.try_get(fresh._gkey(t, 1, 0)) is None, t
        assert store.try_get(fresh._wkey(t, 0)) is None, t
    assert store.try_get(f"{fresh.ns}/pos/0") is None
    fresh.sweep_stale()


def test_async_puts_surface_errors(tmp_path):
    class Broken(FsBlockStore):
        def put(self, key, value):
            if "/g/" in key:
                raise OSError("store down")
            super().put(key, value)

    bsp = BlockStoreParameter(Broken(str(tmp_path / "bs")), 2, 0, 8,
                              async_puts=True, timeout_s=5.0)
    bsp.put_gradients(0, np.ones(8, np.float32))
    with pytest.raises(OSError, match="store down"):
        bsp._join_puts()


def test_coord_service_store_over_a_c10d_store():
    """``CoordServiceBlockStore`` keeps the block-store contract over a
    c10d store (here a ``HashStore``; in a run, the process group's)."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="process group"):
        CoordServiceBlockStore()
    st = CoordServiceBlockStore(store=dist.HashStore())
    assert st.try_get("a/b") is None and not st.contains("a/b")
    st.put("a/b", b"xyz")
    assert st.try_get("a/b") == b"xyz" and st.contains("a/b")
    st.put("a/b", b"over")
    assert st.try_get("a/b") == b"over"
    st.delete("a/b")
    assert st.try_get("a/b") is None
    blob = encode_array(torch.arange(4, dtype=torch.bfloat16))
    st.put("w", blob)
    assert torch.equal(decode_array(st.get_blocking("w", 1.0)),
                       torch.arange(4, dtype=torch.bfloat16))
    with pytest.raises(TimeoutError):
        st.get_blocking("missing", timeout_s=0.05)


# -- DistriOptimizer(parameter_mode="blockstore") on one process -----------

def _lenet_samples():
    from bigdl_tpu_torch.dataset import Sample

    rs = np.random.RandomState(0)
    return [Sample(rs.rand(1, 28, 28).astype(np.float32),
                   np.float32(i % 10 + 1)) for i in range(64)]


def test_blockstore_mode_matches_local(tmp_path):
    """One process: the blockstore round trip (host copies, store, owner
    update) tracks LocalOptimizer within 2e-5, losses included."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (
        SGD, DistriOptimizer, LocalOptimizer, Optimizer, Trigger,
    )

    samples = _lenet_samples()

    def train(mode):
        model = LeNet5(10, device="cpu",
                       generator=torch.Generator().manual_seed(7))
        kw = {}
        if mode == "blockstore":
            kw = dict(distributed=True, parameter_mode="blockstore",
                      block_store=FsBlockStore(str(tmp_path / "bs")))
        losses = []

        def record(state):
            if state["loss"] is not None:
                losses.append(state["loss"])
            return state["neval"] > 4

        opt = Optimizer(model, DataSet.array(samples), ClassNLLCriterion(),
                        batch_size=16, end_trigger=Trigger(
                            record, Trigger.max_iteration(4).peek), **kw)
        assert isinstance(opt, DistriOptimizer if kw else LocalOptimizer)
        opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
        opt.optimize()
        return (np.concatenate([w.ravel() for w in model.get_weights()]),
                losses, opt)

    w_local, l_local, _ = train("local")
    w_bs, l_bs, opt = train("blockstore")
    np.testing.assert_allclose(w_bs, w_local, rtol=0, atol=2e-5)
    np.testing.assert_allclose(l_bs, l_local, rtol=1e-5)
    assert len(l_bs) == 4 and np.abs(w_bs - w_local).max() < 2e-5
    # per step, f32 each: the gradient down, the owner's aggregated slice
    # up, its updated weights down, the assembled vector up (one owner)
    assert opt.host_bytes == 4 * 4 * 4 * w_bs.size


def test_blockstore_mode_applies_regularizer_gradient(tmp_path):
    """With zero data gradient only the L2 regularizer acts: one step
    multiplies the weights by (1 - lr * wd)."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Linear, LogSoftMax
    from bigdl_tpu_torch.nn import Sequential
    from bigdl_tpu_torch.optim import SGD, L2Regularizer, Optimizer, Trigger

    lin = Linear(4, 4, with_bias=False, w_regularizer=L2Regularizer(0.5),
                 device="cpu", generator=torch.Generator().manual_seed(3))
    model = Sequential().add(lin).add(LogSoftMax())
    w_before = lin.weight.detach().clone()
    samples = [Sample(np.zeros(4, np.float32), np.float32(1))
               for _ in range(8)]
    opt = Optimizer(model, DataSet.distributed(samples), ClassNLLCriterion(),
                    batch_size=8, parameter_mode="blockstore",
                    block_store=FsBlockStore(str(tmp_path / "bs")),
                    end_trigger=Trigger.max_iteration(1))
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.optimize()
    torch.testing.assert_close(lin.weight.detach(),
                               w_before * (1 - 0.1 * 0.5), rtol=1e-5,
                               atol=1e-6)


def test_drop_property_requires_blockstore_mode():
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import DistriOptimizer

    for mode in ("partitioned", "allreduce"):
        opt = DistriOptimizer(LeNet5(10, device="cpu"),
                              DataSet.array(_lenet_samples()),
                              ClassNLLCriterion(), batch_size=16,
                              parameter_mode=mode)
        with pytest.raises(ValueError, match="blockstore"):
            opt.set_drop_module_property(0.1)
    opt = DistriOptimizer(LeNet5(10, device="cpu"),
                          DataSet.array(_lenet_samples()),
                          ClassNLLCriterion(), batch_size=16,
                          parameter_mode="blockstore")
    assert opt.set_drop_module_property(0.1) is opt
    assert opt._drop_policy.drop_percentage == 0.1
