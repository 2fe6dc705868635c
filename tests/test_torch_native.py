"""The port's native host runtime (``bigdl_tpu_torch/native``) against the
JAX package's (``bigdl_tpu.native``, built here too: this box has g++),
and the lifetime of the native f32 feed.

Tolerances, with their reasons:

* ``augment_batch``, ``resize_bilinear``, ``decode_cifar``,
  ``recs_index`` and ``NativeLoader``: bitwise (the same C++ source and
  flags on both sides);
* the native f32 feed against the numpy iterator (``plain_iter``): the
  same crops, flips and order bitwise, values within one f32 ulp of the
  numpy ``(x - m) / s`` (the native code multiplies by ``1 / s``).
"""

import os
import threading
import time

import numpy as np
import pytest
from tests.torch_parity import one_torch_thread  # noqa: F401

import bigdl_tpu.native as jnative
from bigdl_tpu_torch import native as tnative
from bigdl_tpu_torch.native import build as tbuild

MEAN, STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    assert jnative.is_available(), jnative.unavailable_reason()


def _imgs(n, h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c),
                                                dtype=np.uint8)


def test_library_builds_under_a_content_hash_into_build_dir():
    path = tbuild.build_library()
    assert path == tbuild.library_path()
    assert os.path.dirname(path) == tbuild.BUILD_DIR
    assert tbuild.BUILD_DIR.endswith(os.path.join("bigdl_tpu_torch",
                                                  "_build"))
    assert os.path.basename(path).startswith("libbigdl_native-")
    assert tbuild.FLAGS == ["-O3", "-std=c++17", "-fPIC", "-shared",
                            "-pthread"]
    assert [os.path.basename(s) for s in tbuild.sources()] == [
        "bigdl_native.cpp", "image_decode.cpp"]


def test_build_raises_oserror_with_no_compiler(monkeypatch, tmp_path):
    """No fallback: a host without g++ raises (JAX's returns None)."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(OSError, match="g.. not found"):
        tbuild.build_library()


@pytest.mark.parametrize("n,h,w,c,crop", [(5, 20, 18, 3, (16, 14)),
                                          (3, 9, 9, 1, (9, 9)),
                                          (7, 32, 40, 3, (24, 24))])
def test_augment_batch_is_bitwise_jax(n, h, w, c, crop):
    imgs = _imgs(n, h, w, c, seed=n)
    rng = np.random.default_rng(h)
    oy = rng.integers(0, h - crop[0] + 1, n).astype(np.int32)
    ox = rng.integers(0, w - crop[1] + 1, n).astype(np.int32)
    fl = (rng.random(n) < 0.5).astype(np.uint8)
    mean, std = MEAN[:c], STD[:c]
    for threads in (1, 3):
        got = tnative.augment_batch(imgs, oy, ox, fl, *crop, mean, std,
                                    n_threads=threads)
        want = jnative.augment_batch(imgs, oy, ox, fl, *crop, mean, std,
                                     n_threads=threads)
        assert got.shape == (n, c, *crop) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,dst", [((4, 17, 23, 3), (8, 9)),
                                       ((2, 5, 5, 1), (12, 7)),
                                       ((3, 32, 32, 3), (32, 32))])
def test_resize_and_cifar_split_are_bitwise_jax(shape, dst):
    imgs = _imgs(*shape, seed=sum(shape))
    np.testing.assert_array_equal(tnative.resize_bilinear(imgs, *dst),
                                  jnative.resize_bilinear(imgs, *dst))
    recs = np.random.default_rng(1).integers(0, 256, 3073 * 5,
                                             dtype=np.uint8)
    for got, want in zip(tnative.decode_cifar(recs),
                         jnative.decode_cifar(recs)):
        np.testing.assert_array_equal(got, want)


def test_recs_index_is_jax_and_grows_and_refuses_bad_shards():
    from bigdl_tpu_torch.dataset.seqfile import write_shards
    import tempfile

    rng = np.random.default_rng(3)
    recs = [(int(rng.integers(0, 2 ** 40)), rng.bytes(int(rng.integers(
        0, 40)))) for _ in range(3000)]      # more than the first guess
    with tempfile.TemporaryDirectory() as d:
        (path,) = write_shards(recs, d, n_shards=1)
        buf = np.fromfile(path, np.uint8)
    for got, want in zip(tnative.recs_index(buf), jnative.recs_index(buf)):
        np.testing.assert_array_equal(got, want)
    assert len(tnative.recs_index(buf)[0]) == 3000
    for bad in (buf[:3], buf[:-5], np.frombuffer(b"RECX", np.uint8)):
        with pytest.raises(ValueError, match="malformed"):
            tnative.recs_index(bad)


def test_native_loader_is_bitwise_jax_and_stops():
    imgs, labels = _imgs(12, 20, 18, seed=9), np.arange(12, dtype=np.int32)
    rng = np.random.default_rng(5)
    jobs = [(rng.integers(0, 5, 4).astype(np.int32),
             rng.integers(0, 5, 4).astype(np.int32),
             (rng.random(4) < 0.5).astype(np.uint8)) for _ in range(3)]
    out = {}
    for name, mod in (("port", tnative), ("jax", jnative)):
        with mod.NativeLoader(4, 20, 18, 3, 16, 14, MEAN, STD,
                              queue_depth=2, n_workers=3) as loader:
            got = []
            for i, (oy, ox, fl) in enumerate(jobs):
                sel = slice(4 * i, 4 * i + 4)
                loader.push(imgs[sel], labels[sel], oy, ox, fl)
                got.append(loader.pop())
            out[name] = got
    for (a, la), (b, lb) in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    # a pop blocked on an empty queue returns when another thread stops it
    loader = tnative.NativeLoader(4, 20, 18, 3, 16, 14, MEAN, STD)
    caught = []

    def pop():
        try:
            loader.pop()
        except RuntimeError as e:
            caught.append(str(e))

    t = threading.Thread(target=pop)
    t.start()
    time.sleep(0.05)
    loader.stop()
    t.join(5)
    assert not t.is_alive() and caught == ["NativeLoader stopped and drained"]
    with pytest.raises(RuntimeError, match="stopped"):
        loader.push(imgs[:4], labels[:4], *jobs[0])
    loader.close()
    loader.close()                          # idempotent
    with pytest.raises(ValueError, match="push expects"):
        tnative.NativeLoader(4, 20, 18, 3, 16, 14, MEAN, STD).push(
            imgs[:3], labels[:3], *jobs[0])
    with pytest.raises(ValueError, match="mean and std"):
        tnative.NativeLoader(4, 20, 18, 3, 16, 14, MEAN[:2], STD)
    # sizes and bounds are checked before a pointer reaches the library
    oy, ox, fl = jobs[0]
    with pytest.raises(ValueError, match="crop leaves"):
        tnative.augment_batch(imgs[:4], oy + 5, ox, fl, 16, 14, MEAN, STD)
    with pytest.raises(ValueError, match="need 4 crop offsets"):
        tnative.augment_batch(imgs[:4], oy[:3], ox, fl, 16, 14, MEAN, STD)
    with tnative.NativeLoader(4, 20, 18, 3, 16, 14, MEAN, STD) as loader:
        with pytest.raises(ValueError, match="4 labels"):
            loader.push(imgs[:4], labels[:3], oy, ox, fl)
        with pytest.raises(ValueError, match="crop leaves"):
            loader.push(imgs[:4], labels[:4], oy, ox - 10, fl)


# ------------------------------------------------- the native f32 feed


def _pipe(**kw):
    from bigdl_tpu_torch.dataset import NativeImagePipeline

    imgs = _imgs(20, 20, 18, seed=2)
    labels = (np.arange(20) % 10 + 1).astype(np.int32)
    args = dict(batch_size=4, crop=(16, 14), mean=MEAN, std=STD, seed=3)
    args.update(kw)
    return NativeImagePipeline(imgs, labels, **args)


def _producers():
    return [t for t in threading.enumerate()
            if t.name == "NativeImagePipeline-producer"]


@pytest.mark.parametrize("train", [True, False])
def test_native_feed_is_the_plain_iterator_within_an_ulp(train):
    pipe = _pipe(pad=2)
    native, plain = pipe.data(train), pipe.plain_iter(train)
    n = 0
    for a, b in zip(native, plain):
        assert a.input.shape == b.input.shape == (4, 3, 16, 14)
        np.testing.assert_array_equal(a.target, b.target)
        np.testing.assert_array_max_ulp(a.input, b.input, maxulp=1)
        n += 1
        if n == 12:                      # three epochs of train batches
            break
    assert n == (12 if train else 5)
    native.close()
    assert not _producers()


def test_abandoned_and_closed_feeds_free_their_loader():
    import gc

    pipe = _pipe(queue_depth=2, n_workers=2)
    it = pipe.data(True)
    next(it)
    assert len(_producers()) == 1        # blocked on a full queue
    it.close()
    assert not _producers()
    it = pipe.data(True)
    next(it)
    del it
    gc.collect()
    assert not _producers()


def test_a_producer_failure_reaches_the_consumer(monkeypatch):
    pipe = _pipe()
    monkeypatch.setattr(pipe, "_params",
                        lambda *a: (_ for _ in ()).throw(KeyError("drawn")))
    it = pipe.data(True)
    with pytest.raises(KeyError, match="drawn"):
        next(it)
    assert not _producers()


def test_optimizer_closes_its_data_iterator_when_it_stops():
    """``optimize()`` and its validation close the native feeds, so no
    worker pool or producer thread outlives the call."""
    import torch

    from bigdl_tpu_torch.nn import (
        ClassNLLCriterion, Linear, LogSoftMax, Reshape, Sequential,
    )
    from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger

    model = Sequential().add(Reshape([3 * 16 * 14], batch_mode=True)).add(
        Linear(3 * 16 * 14, 10, device="cpu")).add(LogSoftMax())
    seen = []

    def spied(pipe):
        data = pipe.data

        def spy(train):
            it = data(train)
            seen.append(it)
            return it

        pipe.data = spy
        return pipe

    opt = Optimizer(model=model, dataset=spied(_pipe(batch_size=4)),
                    criterion=ClassNLLCriterion(),
                    end_trigger=Trigger.max_iteration(7))
    opt.set_optim_method(SGD(learning_rate=0.01))
    opt.set_validation(Trigger.every_epoch(), spied(_pipe(batch_size=4)),
                       [Top1Accuracy()])
    opt.optimize()
    assert len(seen) == 2           # train; the validation after epoch 1
    assert all(it.gi_frame is None for it in seen)            # closed
    assert not _producers()
    assert all(torch.isfinite(p).all() for p in model.parameters())
