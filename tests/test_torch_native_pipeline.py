"""The port's uint8-NHWC image feed (``bigdl_tpu_torch/dataset/
native_pipeline.py``) and ``set_device_preprocess`` against the JAX
package on the CPU.

Tolerances, with their reasons:

* batches: bitwise (the same RandomState draws, the same uint8 copies and
  the same f32 normalize: the port's f32 feed runs through its native
  loader, held to JAX's C++ loader, ``(x - m) * (1 / s)`` on both sides;
  the numpy iterators' ``(x - m) / s`` differs from it by up to an ulp);
* ``DeviceImageNormalizer``: within 1e-6 absolute (one f32 subtract and
  divide on each side; XLA may fold the divide into a multiply);
* three LeNet SGD steps fed uint8: parameters within 2e-6 absolute, the
  tolerance of ``test_optimizer_optimize_matches_jax_local_optimizer``
  (f32 forward and backward summed in other orders);
* Evaluator/Predictor outputs within 1e-5 absolute, accuracies exactly.
"""

import jax
import numpy as np
import pytest
import torch
from tests.torch_parity import one_torch_thread  # noqa: F401

MEAN, STD = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)


def _images(n=24, h=20, w=18, c=3, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, h, w, c), dtype=np.uint8),
            (np.arange(n) % 10 + 1).astype(np.int32))


def _pipes(output, pad, **kw):
    from bigdl_tpu.dataset.native_pipeline import NativeImagePipeline as J
    from bigdl_tpu_torch.dataset import NativeImagePipeline as T

    imgs, labels = _images()
    args = dict(batch_size=8, crop=(16, 14), mean=MEAN, std=STD, pad=pad,
                seed=7, output=output, **kw)
    return J(imgs, labels, **args), T(imgs, labels, **args)


def _jax_iter(pipe, train):
    """The JAX feed: its host iterator for u8, its C++ loader for f32
    (built here: this box has g++)."""
    import bigdl_tpu.native as jax_native

    if pipe.output == "u8_nhwc":
        return pipe._u8_iter(train)
    assert jax_native.is_available(), jax_native.unavailable_reason()
    return pipe._native_iter(train)


@pytest.mark.parametrize("output", ["u8_nhwc", "f32_nchw"])
@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("hflip", [True, False])
def test_batches_are_bitwise_the_jax_feeds(output, pad, hflip):
    jp, tp = _pipes(output, pad, hflip=hflip)
    assert tp.size() == jp.size() == 24
    jt, tt = _jax_iter(jp, True), tp.data(train=True)
    for _ in range(6):                  # two epochs of three batches
        a, b = next(jt), next(tt)
        assert b.input.dtype == a.input.dtype
        assert b.input.shape == a.input.shape == (
            (8, 16, 14, 3) if output == "u8_nhwc" else (8, 3, 16, 14))
        np.testing.assert_array_equal(b.input, a.input)
        np.testing.assert_array_equal(b.target, a.target)
        assert b.target.dtype == np.float32
    ev_j, ev_t = list(_jax_iter(jp, False)), list(tp.data(train=False))
    assert len(ev_t) == len(ev_j) == 3
    for a, b in zip(ev_j, ev_t):
        np.testing.assert_array_equal(b.input, a.input)
        np.testing.assert_array_equal(b.target, a.target)


@pytest.mark.parametrize("output", ["u8_nhwc", "f32_nchw"])
def test_queue_depth_and_n_workers_are_accepted_as_in_jax(output):
    """The native loader's two knobs: taken and kept as JAX keeps them;
    the f32 feed's loader runs with them (the u8 feed does not use them,
    nor does JAX's), and the batches stay JAX's bitwise."""
    jp, tp = _pipes(output, 1, queue_depth=2, n_workers=3)
    assert (tp.queue_depth, tp.n_workers) == (jp.queue_depth,
                                               jp.n_workers) == (2, 3)
    _, default = _pipes(output, 1)
    assert (default.queue_depth, default.n_workers) == (4, 4)
    jt, tt = _jax_iter(jp, True), tp.data(train=True)
    for _ in range(4):
        a, b = next(jt), next(tt)
        np.testing.assert_array_equal(b.input, a.input)
        np.testing.assert_array_equal(b.target, a.target)


def test_u8_feed_normalized_equals_the_f32_feed():
    (_, u8), (_, f32) = _pipes("u8_nhwc", 2), _pipes("f32_nchw", 2)
    norm = u8.device_normalizer()
    for a, b in zip(u8.data(train=True), f32.data(train=True)):
        got = norm(torch.from_numpy(a.input))
        assert got.shape == b.input.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), b.input, atol=1e-6, rtol=0)
        break


def test_device_normalizer_matches_jax():
    from bigdl_tpu.dataset.native_pipeline import DeviceImageNormalizer as J
    from bigdl_tpu_torch.dataset import DeviceImageNormalizer as T

    x, _ = _images(n=5, h=7, w=9)
    want = np.asarray(jax.jit(J(MEAN, STD))(x))
    t = T(MEAN, STD)
    got = t(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert list(t._on) == [torch.device("cpu")]   # kept on the batch's device


def test_pipeline_refuses_bad_arguments():
    from bigdl_tpu_torch.dataset import NativeImagePipeline

    imgs, labels = _images(n=4, h=8, w=8)
    with pytest.raises(ValueError, match="unknown output"):
        NativeImagePipeline(imgs, labels, batch_size=2, mean=MEAN, std=STD,
                            output="f16")
    with pytest.raises(ValueError, match="exceeds"):
        NativeImagePipeline(imgs, labels, batch_size=2, crop=(9, 8),
                            mean=MEAN, std=STD)
    with pytest.raises(ValueError, match="uint8"):
        NativeImagePipeline(imgs[0], labels, batch_size=2, mean=MEAN,
                            std=STD)


# ---------------------------------------------- training and evaluation


def _lenet_pair(seed=9):
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(seed)
    jm = JLeNet5(10)
    jm._ensure_params()
    tm = LeNet5(10, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    return jm, tm


def _mnist_pipes(n, seed=0):
    """(JAX pipeline, port pipeline) over the same uint8 28x28x1 digits,
    fed uint8 and normalized on the device (``test_native.py:236``)."""
    from bigdl_tpu.dataset.native_pipeline import NativeImagePipeline as J
    from bigdl_tpu_torch.dataset import NativeImagePipeline as T

    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, size=(64, 28, 28, 1)).astype(np.uint8)[:n]
    labels = (np.arange(64) % 10 + 1).astype(np.int32)[:n]
    kw = dict(batch_size=16, crop=(28, 28), mean=(33.3,), std=(78.6,),
              hflip=False, output="u8_nhwc")
    return J(imgs, labels, **kw), T(imgs, labels, **kw)


def _train(pkg, steps=3, validate=False, caplog=None):
    if pkg == "jax":
        from bigdl_tpu.nn import ClassNLLCriterion
        from bigdl_tpu.optim import SGD, Optimizer, Top1Accuracy, Trigger
        side, logger = 0, "bigdl_tpu"
    else:
        from bigdl_tpu_torch.nn import ClassNLLCriterion
        from bigdl_tpu_torch.optim import (
            SGD, Optimizer, Top1Accuracy, Trigger,
        )
        side, logger = 1, "bigdl_tpu_torch"
    model = _lenet_pair()[side]
    train = _mnist_pipes(64)[side]
    opt = Optimizer(model=model, dataset=train,
                    criterion=ClassNLLCriterion(),
                    end_trigger=Trigger.max_iteration(steps))
    assert opt.set_device_preprocess(train.device_normalizer()) is opt
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    if validate:
        opt.set_validation(Trigger.several_iteration(2),
                           _mnist_pipes(32)[side], [Top1Accuracy()],
                           batch_size=16)
    if caplog is None:
        return opt.optimize(), []
    import logging

    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        trained = opt.optimize()
    return trained, [r.getMessage() for r in caplog.records
                     if r.name == logger and "validation" in r.getMessage()]


def test_three_u8_fed_sgd_steps_match_jax():
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    (jm, _), (tm, _) = _train("jax"), _train("port")
    got = dict(tm.named_parameters())
    for k, w in named_leaves(tm, jax.device_get(jm.params)).items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=2e-6, err_msg=k)


def test_validation_runs_the_preprocess_like_jax(caplog):
    _, jlines = _train("jax", validate=True, caplog=caplog)
    _, tlines = _train("port", validate=True, caplog=caplog)
    assert len(tlines) == len(jlines) == 1          # iteration 3
    assert tlines[0].split(": ", 1) == jlines[0].split(": ", 1)
    assert "count=32" in tlines[0]


def test_evaluator_and_predictor_apply_the_preprocess():
    """The local half of ``test_eval_viz.py``'s preprocess test."""
    from bigdl_tpu.optim import Evaluator as JEvaluator
    from bigdl_tpu.optim import Predictor as JPredictor
    from bigdl_tpu.optim import Top1Accuracy as JTop1
    from bigdl_tpu_torch.optim import Evaluator, Predictor, Top1Accuracy

    jm, tm = _lenet_pair(seed=3)
    jp, tp = _mnist_pipes(40)
    jb, tb = list(jp._u8_iter(False)), list(tp.data(train=False))
    (jr,) = JEvaluator(jm, device_preprocess=jp.device_normalizer()).test(
        jb, [JTop1()], 16)
    (tr,) = Evaluator(tm, device_preprocess=tp.device_normalizer()).test(
        tb, [Top1Accuracy()], 16)
    assert tr.result() == jr.result() and tr.result()[1] == 32
    xs = np.concatenate([b.input for b in tb])
    want = np.asarray(JPredictor(
        jm, device_preprocess=jp.device_normalizer()).predict(xs, 16))
    got = Predictor(tm, device_preprocess=tp.device_normalizer()).predict(
        xs, 16)
    assert got.shape == (32, 10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # without the preprocess the raw uint8 batch reaches the model
    raw = Predictor(tm).predict(xs.astype(np.float32), 16)
    assert not np.allclose(raw, got, atol=1e-3)
