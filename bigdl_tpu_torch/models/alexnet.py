"""AlexNet (``bigdl_tpu/models/alexnet.py``): ``AlexNet_OWT``, the "one
weird trick" single tower (Krizhevsky 2014: 64-192-384-256-256 maps, no
LRN, ``propagate_back=False`` on conv1), and ``AlexNet``, the Caffe
layout (96-256-384-384-256 maps, cross-map LRN after conv1 and conv2,
two-group conv2, conv4 and conv5). Both end in the 4096-4096 head and
``LogSoftMax``, with Xavier weights and zero biases, f32 on ``device``
(default ``cuda``; raises without a card unless ``device="cpu"``) from
``generator`` (default: torch's global generator). The child order and
params tree are the JAX models', so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries their
weights across. The convolutions are cuDNN's (``F.conv2d``, grouped for
``n_group=2``), as JAX leaves them to XLA: no port kernel is on this
path.

``train_main`` is the reference's ImageNet Train main through
:func:`bigdl_tpu_torch.models.utils.run_training`: ``AlexNet_OWT(1000)``,
``ClassNLLCriterion``, SGD at the JAX main's defaults (batch 64, learning
rate 0.01, momentum 0.9, 2 epochs) on the class-per-subdirectory image
folder under ``-f`` at 224² or ``synthetic_imagenet_samples``;
``--device`` (default ``cuda``).
"""

from __future__ import annotations

from bigdl_tpu_torch.nn import (
    Dropout, Linear, LogSoftMax, ReLU, Reshape, Sequential,
    SpatialConvolution, SpatialCrossMapLRN, SpatialMaxPooling, Xavier, Zeros,
)
from bigdl_tpu_torch.utils.device import resolve_device


def _head(model: Sequential, class_num: int, has_dropout: bool, kw) -> None:
    model.add(Reshape([256 * 6 * 6], batch_mode=True))
    for i, (n_in, n_out) in enumerate(((256 * 6 * 6, 4096), (4096, 4096))):
        model.add(Linear(n_in, n_out, **kw).set_name(f"fc{6 + i}"))
        model.add(ReLU(True).set_name(f"relu{6 + i}"))
        if has_dropout:
            model.add(Dropout(0.5).set_name(f"drop{6 + i}"))
    model.add(Linear(4096, class_num, **kw).set_name("fc8"))
    model.add(LogSoftMax().set_name("logsoftmax"))


def _kw(device, generator) -> dict:
    return {"init_weight": Xavier(), "init_bias": Zeros(),
            "device": resolve_device(device), "generator": generator}


def AlexNet_OWT(class_num: int = 1000, has_dropout: bool = True,
                first_layer_propagate_back: bool = False, device=None,
                generator=None) -> Sequential:
    kw = _kw(device, generator)
    model = Sequential()
    model.add(SpatialConvolution(
        3, 64, 11, 11, 4, 4, 2, 2,
        propagate_back=first_layer_propagate_back, **kw).set_name("conv1"))
    model.add(ReLU(True).set_name("relu1"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
    model.add(SpatialConvolution(64, 192, 5, 5, 1, 1, 2, 2, **kw)
              .set_name("conv2"))
    model.add(ReLU(True).set_name("relu2"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
    for i, (n_in, n_out) in enumerate(((192, 384), (384, 256), (256, 256))):
        model.add(SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, **kw)
                  .set_name(f"conv{3 + i}"))
        model.add(ReLU(True).set_name(f"relu{3 + i}"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"))
    _head(model, class_num, has_dropout, kw)
    return model


def AlexNet(class_num: int = 1000, has_dropout: bool = True, device=None,
            generator=None) -> Sequential:
    """Caffe-style AlexNet (cross-map LRN after conv1 and conv2)."""
    kw = _kw(device, generator)
    model = Sequential()
    model.add(SpatialConvolution(3, 96, 11, 11, 4, 4, **kw).set_name("conv1"))
    model.add(ReLU(True).set_name("relu1"))
    model.add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
    model.add(SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, n_group=2, **kw)
              .set_name("conv2"))
    model.add(ReLU(True).set_name("relu2"))
    model.add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm2"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
    for i, (n_in, n_out, g) in enumerate(((256, 384, 1), (384, 384, 2),
                                          (384, 256, 2))):
        model.add(SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1,
                                     n_group=g, **kw).set_name(f"conv{3 + i}"))
        model.add(ReLU(True).set_name(f"relu{3 + i}"))
    model.add(SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"))
    _head(model, class_num, has_dropout, kw)
    return model


def train_main(argv=None):
    """Reference ``models/alexnet`` Train main (the OWT variant, synthetic
    ImageNet unless ``-f`` is an image folder); returns the trained
    model."""
    from bigdl_tpu_torch.models.utils import (
        run_training, synthetic_imagenet_samples, train_parser,
    )
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion

    args = train_parser("AlexNet-OWT on ImageNet", batch_size=64,
                        learning_rate=0.01, max_epoch=2).parse_args(argv)
    if args.folder:
        from bigdl_tpu_torch.dataset.image import image_folder_samples

        samples = image_folder_samples(args.folder, image_size=224)
    else:
        samples = synthetic_imagenet_samples(args.synthetic)
    return run_training(AlexNet_OWT(1000, device=args.device), samples,
                        ClassNLLCriterion(), args)


if __name__ == "__main__":
    train_main()
