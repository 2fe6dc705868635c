"""The port's twin of ``tests/test_resnet_convergence.py``: a CIFAR-shape
ResNet-8 (shortcut A, zero gamma, MSRA init) trains 10 epochs through the
CIFAR pickle-batch reader with SGD + momentum + weight decay + a Step
schedule, through the port's ``Optimizer.optimize()``, from the JAX
model's initial weights and on the JAX run's batch stream. It must clear
the JAX test's Top-1 bar, and land within its ``PARITY_TOL`` of the JAX
run's Top-1 (two f32 trainings whose sums run in other orders drift
apart over 200 steps; the bar and the tolerance are the JAX test's)."""

import jax
import numpy as np
import pytest
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.integration   # as the JAX test: a 10-epoch run

BATCH = 64
EPOCHS = 10
N_TRAIN = 1280
STEPS = EPOCHS * N_TRAIN // BATCH   # 200
LR = 0.1
MOMENTUM = 0.9
WEIGHT_DECAY = 5e-4
STEP_SIZE, GAMMA = 150, 0.2
ACCURACY_BAR = 0.90
PARITY_TOL = 0.04


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    from bigdl_tpu_torch.dataset.cifar import generate_batch_dataset

    d = tmp_path_factory.mktemp("cifar_batches")
    generate_batch_dataset(str(d), n_train=N_TRAIN, n_test=512, seed=5,
                           noise=180.0)
    return str(d)


def _stream(pkg, cifar_dir, kind, train):
    """The normalized samples of ``kind``, batched (the JAX test's
    pipeline in each package: DataSet seed 13, BGRImgNormalizer with the
    CIFAR train mean and std, batches of 64)."""
    if pkg == "jax":
        from bigdl_tpu.dataset import DataSet, SampleToMiniBatch
        from bigdl_tpu.dataset.cifar import TRAIN_MEAN, TRAIN_STD, load_samples
        from bigdl_tpu.dataset.image import BGRImgNormalizer
    else:
        from bigdl_tpu_torch.dataset import (
            BGRImgNormalizer, DataSet, SampleToMiniBatch,
        )
        from bigdl_tpu_torch.dataset.cifar import (
            TRAIN_MEAN, TRAIN_STD, load_samples,
        )
    samples = load_samples(cifar_dir, kind, synthetic_fallback=False)
    ds = (DataSet.array(samples, seed=13)
          .transform(BGRImgNormalizer(TRAIN_MEAN, TRAIN_STD))
          .transform(SampleToMiniBatch(BATCH, drop_remainder=train)))
    if not train:
        return list(ds.data(train=False))
    it = ds.data(train=True)
    return [next(it) for _ in range(STEPS)]


def _run(pkg, cifar_dir, init=None):
    """Train and score one package; returns (Top-1, scored, the model's
    initial params and state)."""
    if pkg == "jax":
        from bigdl_tpu.dataset import DataSet
        from bigdl_tpu.models.resnet import ResNet
        from bigdl_tpu.nn import ClassNLLCriterion
        from bigdl_tpu.optim import SGD, Optimizer, Top1Accuracy, Trigger
        from bigdl_tpu.optim.evaluator import Evaluator
        from bigdl_tpu.optim.optim_method import Step
        from bigdl_tpu.utils.random_gen import RNG

        RNG.set_seed(17)
        model = ResNet(10, {"depth": 8, "shortcutType": "A",
                            "dataSet": "cifar10"})
        model._ensure_params()
        init = (jax.device_get(model.params), jax.device_get(model.state))
    else:
        from bigdl_tpu_torch.dataset import DataSet
        from bigdl_tpu_torch.models.resnet import ResNet
        from bigdl_tpu_torch.nn import ClassNLLCriterion
        from bigdl_tpu_torch.optim import (
            SGD, Evaluator, Optimizer, Step, Top1Accuracy, Trigger,
        )
        from bigdl_tpu_torch.utils.params_tree import load_jax_tree

        model = load_jax_tree(
            ResNet(10, {"depth": 8, "shortcutType": "A",
                        "dataSet": "cifar10"}, device="cpu"), *init)
    opt = Optimizer(model=model,
                    dataset=DataSet.array(_stream(pkg, cifar_dir, "train",
                                                  True)),
                    criterion=ClassNLLCriterion(),
                    end_trigger=Trigger.max_iteration(STEPS))
    opt.set_optim_method(SGD(learning_rate=LR, momentum=MOMENTUM,
                             weight_decay=WEIGHT_DECAY,
                             learning_rate_schedule=Step(STEP_SIZE, GAMMA)))
    trained = opt.optimize()
    (res,) = Evaluator(trained).test(
        _stream(pkg, cifar_dir, "test", False), [Top1Accuracy()], BATCH)
    acc, scored = res.result()
    return acc, scored, init, trained


def test_port_resnet8_converges_within_parity_of_jax(cifar_dir):
    import torch

    jax_acc, jn, init, _ = _run("jax", cifar_dir)
    acc, n, _, trained = _run("port", cifar_dir, init)
    assert n == jn == 512
    assert acc >= ACCURACY_BAR, f"port Top-1 {acc:.4f} < {ACCURACY_BAR}"
    assert abs(acc - jax_acc) <= PARITY_TOL, (acc, jax_acc)
    # BN bookkeeping is live: the running means moved off zero
    means = [b for k, b in trained.named_buffers() if "running_mean" in k]
    assert means and max(float(b.abs().max()) for b in means) > 1e-3
    assert all(torch.isfinite(p).all() for p in trained.parameters())
