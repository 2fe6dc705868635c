"""VGG (``bigdl_tpu/models/vgg.py``) — BASELINE config #2, VGG-16 on
CIFAR-10.

``VggForCifar10`` is thirteen 3×3 conv → BN(eps 1e-3) → ReLU layers in
five ceil-mode max-pooled stages, ``Dropout`` between them, and a
512-wide BN head ending in ``LogSoftMax``; ``Vgg_16``/``Vgg_19`` are the
plain ImageNet towers (no BN, 4096-wide heads). The child order and the
params and state trees are the JAX models', so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries a JAX
model's weights and BN statistics across. Weights are f32, made on
``device`` (default ``cuda``; raises without a card unless
``device="cpu"``) from ``generator`` (default: torch's global
generator). Every convolution is cuDNN's ``F.conv2d``, as JAX leaves
them to XLA: no Pallas kernel is on this path.

``train_main``/``test_main`` are the reference's Train/Test mains over
``models/utils.py`` (SGD, ``ClassNLLCriterion``, CIFAR-10 from ``-f`` or
the synthetic set), with ``--device`` (default ``cuda``).
"""

from __future__ import annotations

from bigdl_tpu_torch.nn import (
    BatchNormalization, Dropout, Linear, LogSoftMax, ReLU, Reshape,
    Sequential, SpatialBatchNormalization, SpatialConvolution,
    SpatialMaxPooling,
)
from bigdl_tpu_torch.utils.device import resolve_device


def VggForCifar10(class_num: int = 10, has_dropout: bool = True,
                  device=None, generator=None) -> Sequential:
    kw = {"device": resolve_device(device), "generator": generator}
    model = Sequential()

    def conv_bn_relu(n_in, n_out):
        model.add(SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, **kw))
        model.add(SpatialBatchNormalization(n_out, 1e-3, **kw))
        model.add(ReLU(True))

    def dropout(p):
        if has_dropout:
            model.add(Dropout(p))

    def pool():
        model.add(SpatialMaxPooling(2, 2, 2, 2).ceil())

    # five stages of (width, convolutions, dropout between them)
    n_in = 3
    for width, n_conv, p in ((64, 2, 0.3), (128, 2, 0.4), (256, 3, 0.4),
                             (512, 3, 0.4), (512, 3, 0.4)):
        for i in range(n_conv):
            if i:
                dropout(p)
            conv_bn_relu(n_in, width)
            n_in = width
        pool()

    model.add(Reshape([512], batch_mode=True))
    dropout(0.5)
    model.add(Linear(512, 512, **kw))
    model.add(BatchNormalization(512, **kw))
    model.add(ReLU(True))
    dropout(0.5)
    model.add(Linear(512, class_num, **kw))
    model.add(LogSoftMax())
    return model


def _vgg_tower(cfg, class_num: int, has_dropout: bool = True, device=None,
               generator=None) -> Sequential:
    kw = {"device": resolve_device(device), "generator": generator}
    model = Sequential()
    n_in = 3
    for item in cfg:
        if item == "M":
            model.add(SpatialMaxPooling(2, 2, 2, 2))
        else:
            model.add(SpatialConvolution(n_in, item, 3, 3, 1, 1, 1, 1, **kw))
            model.add(ReLU(True))
            n_in = item
    model.add(Reshape([512 * 7 * 7], batch_mode=True))
    model.add(Linear(512 * 7 * 7, 4096, **kw))
    model.add(ReLU(True))
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(4096, 4096, **kw))
    model.add(ReLU(True))
    if has_dropout:
        model.add(Dropout(0.5))
    model.add(Linear(4096, class_num, **kw))
    model.add(LogSoftMax())
    return model


def Vgg_16(class_num: int = 1000, has_dropout: bool = True, device=None,
           generator=None) -> Sequential:
    return _vgg_tower(
        [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
        class_num, has_dropout, device, generator)


def Vgg_19(class_num: int = 1000, has_dropout: bool = True, device=None,
           generator=None) -> Sequential:
    return _vgg_tower(
        [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
        class_num, has_dropout, device, generator)


def train_main(argv=None):
    """Reference ``models/vgg/Train.scala`` main (BASELINE target #2,
    one device); returns the trained model."""
    from bigdl_tpu_torch.dataset.cifar import load_samples
    from bigdl_tpu_torch.models.utils import run_training, train_parser
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

    args = train_parser("VGG on CIFAR-10", batch_size=128,
                        learning_rate=0.01, max_epoch=10).parse_args(argv)
    samples = load_samples(args.folder or "/nonexistent", "train",
                           synthetic_count=args.synthetic)
    return run_training(VggForCifar10(10, device=args.device), samples,
                        ClassNLLCriterion(), args)


def test_main(argv=None):
    """Reference ``models/vgg/Test.scala`` main: Top-1 of a snapshot;
    returns the results."""
    from bigdl_tpu_torch.dataset.cifar import load_samples
    from bigdl_tpu_torch.models.utils import run_test, test_parser

    args = test_parser("VGG CIFAR-10 evaluation").parse_args(argv)
    samples = load_samples(args.folder or "/nonexistent", "test",
                           synthetic_count=args.synthetic)
    return run_test(args.model, samples, args.batchSize, args.device)


if __name__ == "__main__":
    train_main()
