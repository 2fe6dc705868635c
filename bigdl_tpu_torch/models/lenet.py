"""LeNet-5 — BASELINE config #1, MNIST through LocalOptimizer
(``bigdl_tpu/models/lenet.py``).

Reshape → Conv(1,6,5,5) → Tanh → MaxPool → Conv(6,12,5,5) → Tanh →
MaxPool → Reshape → Linear(12*4*4,100) → Tanh → Linear(100,classNum) →
LogSoftMax, with the JAX model's layer names (``conv1_5x5``,
``conv2_5x5``, ``fc1``, ``fc2``) and child order, so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries a JAX
``LeNet5``'s weights across. Weights are f32, made on ``device``
(default ``cuda``; raises without a card unless ``device="cpu"``) from
``generator`` (default: torch's global generator).

``train_main``/``test_main`` are the reference's Train/Test mains
(``models/utils.py``), with ``--device`` (default ``cuda``). Their
pipelines normalize the images as the reference's ``Train.scala`` and
``Test.scala`` do (``GreyImgNormalizer`` with the MNIST train, resp. test,
mean and std, applied per epoch in the data pipeline); the JAX package's
mains feed the raw 0-255 pixels instead, under which LeNet trains to a
lower Top-1 on the noisy generated digits.
"""

from __future__ import annotations

from bigdl_tpu_torch.nn import (
    Linear, LogSoftMax, Reshape, Sequential, SpatialConvolution,
    SpatialMaxPooling, Tanh,
)
from bigdl_tpu_torch.utils.device import resolve_device


def LeNet5(class_num: int = 10, device=None, generator=None) -> Sequential:
    kw = {"device": resolve_device(device), "generator": generator}
    return (
        Sequential()
        .add(Reshape([1, 28, 28]))
        .add(SpatialConvolution(1, 6, 5, 5, **kw).set_name("conv1_5x5"))
        .add(Tanh())
        .add(SpatialMaxPooling(2, 2, 2, 2))
        .add(SpatialConvolution(6, 12, 5, 5, **kw).set_name("conv2_5x5"))
        .add(Tanh())
        .add(SpatialMaxPooling(2, 2, 2, 2))
        .add(Reshape([12 * 4 * 4]))
        .add(Linear(12 * 4 * 4, 100, **kw).set_name("fc1"))
        .add(Tanh())
        .add(Linear(100, class_num, **kw).set_name("fc2"))
        .add(LogSoftMax())
    )


def mnist_dataset(args, kind: str):
    """The mains' sample dataset: the idx files under ``args.folder`` (or
    the synthetic digits), normalized with ``kind``'s mean and std."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.dataset.image import GreyImgNormalizer

    samples = mnist.load_samples(args.folder or "/nonexistent", kind,
                                 synthetic_count=args.synthetic)
    mean, std = ((mnist.TRAIN_MEAN, mnist.TRAIN_STD) if kind == "train"
                 else (mnist.TEST_MEAN, mnist.TEST_STD))
    return DataSet.array(samples) >> GreyImgNormalizer(mean, std)


def train_main(argv=None):
    """Reference ``models/lenet/Train.scala`` main (``--env local``:
    LeNet-5 on MNIST via LocalOptimizer); returns the trained model."""
    from bigdl_tpu_torch.models.utils import run_training, train_parser
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

    args = train_parser("LeNet-5 on MNIST", batch_size=128,
                        learning_rate=0.05, max_epoch=5).parse_args(argv)
    model = LeNet5(10, device=args.device)
    return run_training(model, mnist_dataset(args, "train"),
                        ClassNLLCriterion(), args)


def test_main(argv=None):
    """Reference ``models/lenet/Test.scala`` main: Top-1 of a snapshot;
    returns the results."""
    from bigdl_tpu_torch.models.utils import run_test, test_parser

    args = test_parser("LeNet-5 MNIST evaluation").parse_args(argv)
    return run_test(args.model, mnist_dataset(args, "test"), args.batchSize,
                    args.device)


if __name__ == "__main__":
    train_main()
