"""Inception (``bigdl_tpu/models/inception.py``) — BASELINE config #4,
GoogLeNet on ImageNet with a poly learning rate.

``Inception_v1_NoAuxClassifier`` is the 7×7/2 stem, two LRNs, nine
inception blocks (``Concat(2)`` of 1×1 | 1×1→3×3 | 1×1→5×5 | pool→1×1)
and a 7×7 average pool → ``Dropout(0.4)`` → ``Linear(1024, classNum)``
→ ``LogSoftMax`` head; ``Inception_v1`` adds the two auxiliary heads and
outputs the table ``[main, aux@4d, aux@4a]`` (train it through
``ParallelCriterion(repeat_target=True)`` with weights 1, 0.3, 0.3);
``Inception_v2`` is BN-Inception. Every convolution and linear layer is
Xavier/Zeros-initialized and named as in JAX; the child order and the
params and state trees are the JAX models', so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries JAX
weights across. Weights are f32, made on ``device`` (default ``cuda``;
raises without a card unless ``device="cpu"``) from ``generator``
(default: torch's global generator). The convolutions are cuDNN's
``F.conv2d`` and the LRN plain ops, as JAX leaves both to XLA: no Pallas
kernel is on this path.

``train_main`` is the reference's TrainInceptionV1 main (SGD with
``Poly(0.5, 62000)``) over ``models/utils.py``, on synthetic ImageNet
samples or, with ``-f``, a class-per-subdirectory image folder
(``dataset/image.py::image_folder_samples`` at 224²).
"""

from __future__ import annotations

from bigdl_tpu_torch.nn import (
    Concat, ConcatTable, Dropout, FlattenTable, Linear, LogSoftMax, ReLU,
    Reshape, Sequential, SpatialAveragePooling, SpatialBatchNormalization,
    SpatialConvolution, SpatialCrossMapLRN, SpatialMaxPooling, Xavier, Zeros,
)
from bigdl_tpu_torch.utils.device import resolve_device


class _Builder:
    """Makes the layers on one device from one generator."""

    def __init__(self, device, generator) -> None:
        self.kw = {"device": resolve_device(device), "generator": generator}

    def conv(self, n_in, n_out, kw, kh, sw, sh, pw, ph, name):
        return SpatialConvolution(
            n_in, n_out, kw, kh, sw, sh, pw, ph, init_weight=Xavier(),
            init_bias=Zeros(), **self.kw).set_name(name)

    def linear(self, n_in, n_out, name):
        return Linear(n_in, n_out, init_weight=Xavier(), init_bias=Zeros(),
                      **self.kw).set_name(name)

    def conv_relu(self, seq, n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0,
                  name: str = "") -> Sequential:
        """``_conv_relu``: append a Xavier conv and a ReLU to ``seq``."""
        seq.add(self.conv(n_in, n_out, kw, kh, sw, sh, pw, ph, name))
        seq.add(ReLU(True))
        return seq

    def conv_bn_relu(self, seq, n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0,
                     name: str = "") -> Sequential:
        """``_conv_bn_relu``: a Xavier conv, BN(eps 1e-3) and a ReLU."""
        seq.add(self.conv(n_in, n_out, kw, kh, sw, sh, pw, ph, name))
        seq.add(SpatialBatchNormalization(n_out, 1e-3, **self.kw)
                .set_name(name + "/bn"))
        seq.add(ReLU(True))
        return seq


def _pool(kw, kh, dw, dh, name, pad=0):
    return SpatialMaxPooling(kw, kh, dw, dh, pad, pad).ceil().set_name(name)


def Inception_Layer_v1(input_size: int, config, name_prefix: str = "",
                       device=None, generator=None) -> Concat:
    """One inception block; ``config`` is ``[[out1x1], [reduce3x3,
    out3x3], [reduce5x5, out5x5], [pool_proj]]``."""
    b = _Builder(device, generator)
    c = [list(branch) for branch in config]
    concat = Concat(2)
    concat.add(b.conv_relu(Sequential(), input_size, c[0][0], 1, 1,
                           name=name_prefix + "1x1"))
    b2 = b.conv_relu(Sequential(), input_size, c[1][0], 1, 1,
                     name=name_prefix + "3x3_reduce")
    concat.add(b.conv_relu(b2, c[1][0], c[1][1], 3, 3, 1, 1, 1, 1,
                           name=name_prefix + "3x3"))
    b3 = b.conv_relu(Sequential(), input_size, c[2][0], 1, 1,
                     name=name_prefix + "5x5_reduce")
    concat.add(b.conv_relu(b3, c[2][0], c[2][1], 5, 5, 1, 1, 2, 2,
                           name=name_prefix + "5x5"))
    b4 = Sequential().add(_pool(3, 3, 1, 1, name_prefix + "pool", pad=1))
    concat.add(b.conv_relu(b4, input_size, c[3][0], 1, 1,
                           name=name_prefix + "pool_proj"))
    return concat


#: the input size and config of each v1 block, by the block's name
_V1_BLOCKS = {
    "3a": (192, [[64], [96, 128], [16, 32], [32]]),
    "3b": (256, [[128], [128, 192], [32, 96], [64]]),
    "4a": (480, [[192], [96, 208], [16, 48], [64]]),
    "4b": (512, [[160], [112, 224], [24, 64], [64]]),
    "4c": (512, [[128], [128, 256], [24, 64], [64]]),
    "4d": (512, [[112], [144, 288], [32, 64], [64]]),
    "4e": (528, [[256], [160, 320], [32, 128], [128]]),
    "5a": (832, [[256], [160, 320], [32, 128], [128]]),
    "5b": (832, [[384], [192, 384], [48, 128], [128]]),
}


def _v1_block(b: _Builder, seq: Sequential, key: str) -> None:
    size, cfg = _V1_BLOCKS[key]
    seq.add(Inception_Layer_v1(size, cfg, f"inception_{key}/", **b.kw))


def _v1_stem(b: _Builder, seq: Sequential) -> None:
    """conv1 → pool1 → norm1 → conv2 (reduce, 3×3) → norm2 → pool2."""
    b.conv_relu(seq, 3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2")
    seq.add(_pool(3, 3, 2, 2, "pool1/3x3_s2"))
    seq.add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("pool1/norm1"))
    b.conv_relu(seq, 64, 64, 1, 1, name="conv2/3x3_reduce")
    b.conv_relu(seq, 64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3")
    seq.add(SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("conv2/norm2"))
    seq.add(_pool(3, 3, 2, 2, "pool2/3x3_s2"))


def _v1_head(b: _Builder, seq: Sequential, class_num: int,
             has_dropout: bool) -> None:
    """pool5 → [dropout] → loss3 classifier → LogSoftMax."""
    seq.add(SpatialAveragePooling(7, 7, 1, 1).set_name("pool5/7x7_s1"))
    if has_dropout:
        seq.add(Dropout(0.4).set_name("pool5/drop_7x7_s1"))
    seq.add(Reshape([1024], batch_mode=True))
    seq.add(b.linear(1024, class_num, "loss3/classifier"))
    seq.add(LogSoftMax().set_name("loss3/loss3"))


def Inception_v1_NoAuxClassifier(class_num: int = 1000,
                                 has_dropout: bool = True, device=None,
                                 generator=None) -> Sequential:
    b = _Builder(device, generator)
    model = Sequential()
    _v1_stem(b, model)
    _v1_block(b, model, "3a")
    _v1_block(b, model, "3b")
    model.add(_pool(3, 3, 2, 2, "pool3/3x3_s2"))
    for key in ("4a", "4b", "4c", "4d", "4e"):
        _v1_block(b, model, key)
    model.add(_pool(3, 3, 2, 2, "pool4/3x3_s2"))
    _v1_block(b, model, "5a")
    _v1_block(b, model, "5b")
    _v1_head(b, model, class_num, has_dropout)
    return model


def _aux_head(input_size: int, class_num: int, name_prefix: str,
              b: _Builder) -> Sequential:
    """The auxiliary classifier: 5×5/3 average pool → 1×1 conv(128) →
    fc(1024) → ReLU → Dropout(0.7) → fc(classes) → LogSoftMax."""
    s = Sequential()
    s.add(SpatialAveragePooling(5, 5, 3, 3).set_name(name_prefix + "ave_pool"))
    b.conv_relu(s, input_size, 128, 1, 1, name=name_prefix + "conv")
    s.add(Reshape([128 * 4 * 4], batch_mode=True))
    s.add(b.linear(128 * 4 * 4, 1024, name_prefix + "fc"))
    s.add(ReLU(True))
    s.add(Dropout(0.7).set_name(name_prefix + "drop_fc"))
    s.add(b.linear(1024, class_num, name_prefix + "classifier"))
    s.add(LogSoftMax().set_name(name_prefix + "loss"))
    return s


def Inception_v1(class_num: int = 1000, has_dropout: bool = True,
                 device=None, generator=None) -> Sequential:
    """GoogLeNet with its two auxiliary classifiers; the output is the
    table ``[main, aux@4d, aux@4a]``."""
    b = _Builder(device, generator)
    feature1 = Sequential()
    _v1_stem(b, feature1)
    _v1_block(b, feature1, "3a")
    _v1_block(b, feature1, "3b")
    feature1.add(_pool(3, 3, 2, 2, "pool3/3x3_s2"))
    _v1_block(b, feature1, "4a")
    output1 = _aux_head(512, class_num, "loss1/", b)

    feature2 = Sequential()
    for key in ("4b", "4c", "4d"):
        _v1_block(b, feature2, key)
    output2 = _aux_head(528, class_num, "loss2/", b)

    output3 = Sequential()
    _v1_block(b, output3, "4e")
    output3.add(_pool(3, 3, 2, 2, "pool4/3x3_s2"))
    _v1_block(b, output3, "5a")
    _v1_block(b, output3, "5b")
    _v1_head(b, output3, class_num, has_dropout)

    main = Sequential().add(feature2).add(
        ConcatTable().add(output3).add(output2))
    return Sequential().add(feature1).add(
        ConcatTable().add(main).add(output1)).add(FlattenTable())


def Inception_Layer_v2(input_size: int, config, name_prefix: str = "",
                       device=None, generator=None) -> Concat:
    """BN-inception block: 1×1 | 1×1→3×3 | 1×1→3×3→3×3 | pool→proj, every
    conv followed by BN and ReLU. ``config[0][0] == 0`` marks a stride-2
    reduction block (no 1×1 branch, an unprojected max pool);
    ``config[3]`` is ``(pool_type, proj)``, pool_type "avg" or "max"."""
    b = _Builder(device, generator)
    c = [list(branch) for branch in config]
    out1 = int(c[0][0])
    stride2 = out1 == 0
    s = 2 if stride2 else 1
    concat = Concat(2)
    if not stride2:
        concat.add(b.conv_bn_relu(Sequential(), input_size, out1, 1, 1,
                                  name=name_prefix + "1x1"))
    r3, o3 = c[1]
    b2 = b.conv_bn_relu(Sequential(), input_size, r3, 1, 1,
                        name=name_prefix + "3x3_reduce")
    concat.add(b.conv_bn_relu(b2, r3, o3, 3, 3, s, s, 1, 1,
                              name=name_prefix + "3x3"))
    rd, od = c[2]
    b3 = b.conv_bn_relu(Sequential(), input_size, rd, 1, 1,
                        name=name_prefix + "double3x3_reduce")
    b.conv_bn_relu(b3, rd, od, 3, 3, 1, 1, 1, 1,
                   name=name_prefix + "double3x3a")
    concat.add(b.conv_bn_relu(b3, od, od, 3, 3, s, s, 1, 1,
                              name=name_prefix + "double3x3b"))
    pool_type, proj = c[3][0], int(c[3][1])
    b4 = Sequential()
    if stride2:
        b4.add(_pool(3, 3, 2, 2, name_prefix + "pool"))
    elif pool_type == "avg":
        b4.add(SpatialAveragePooling(3, 3, 1, 1, 1, 1, ceil_mode=True)
               .set_name(name_prefix + "pool"))
    else:
        b4.add(_pool(3, 3, 1, 1, name_prefix + "pool", pad=1))
    if proj:
        b.conv_bn_relu(b4, input_size, proj, 1, 1,
                       name=name_prefix + "pool_proj")
    concat.add(b4)
    return concat


def Inception_v2(class_num: int = 1000, device=None,
                 generator=None) -> Sequential:
    """BN-Inception's main tower (reference ``Inception_v2``)."""
    b = _Builder(device, generator)
    model = Sequential()
    b.conv_bn_relu(model, 3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2")
    model.add(_pool(3, 3, 2, 2, "pool1/3x3_s2"))
    b.conv_bn_relu(model, 64, 64, 1, 1, name="conv2/3x3_reduce")
    b.conv_bn_relu(model, 64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3")
    model.add(_pool(3, 3, 2, 2, "pool2/3x3_s2"))
    for size, cfg, key in (
            (192, [[64], [64, 64], [64, 96], ["avg", 32]], "3a"),
            (256, [[64], [64, 96], [64, 96], ["avg", 64]], "3b"),
            (320, [[0], [128, 160], [64, 96], ["max", 0]], "3c"),
            (576, [[224], [64, 96], [96, 128], ["avg", 128]], "4a"),
            (576, [[192], [96, 128], [96, 128], ["avg", 128]], "4b"),
            (576, [[160], [128, 160], [128, 160], ["avg", 96]], "4c"),
            (576, [[96], [128, 192], [160, 192], ["avg", 96]], "4d"),
            (576, [[0], [128, 192], [192, 256], ["max", 0]], "4e"),
            (1024, [[352], [192, 320], [160, 224], ["avg", 128]], "5a"),
            (1024, [[352], [192, 320], [192, 224], ["max", 128]], "5b")):
        model.add(Inception_Layer_v2(size, cfg, f"inception_{key}/",
                                     **b.kw))
    model.add(SpatialAveragePooling(7, 7, 1, 1).set_name("pool5/7x7_s1"))
    model.add(Reshape([1024], batch_mode=True))
    model.add(b.linear(1024, class_num, "loss3/classifier"))
    model.add(LogSoftMax().set_name("loss3/loss3"))
    return model


def train_main(argv=None):
    """Reference ``models/inception/TrainInceptionV1.scala`` main
    (BASELINE target #4): ``Inception_v1_NoAuxClassifier(1000)`` on the
    image folder under ``-f`` (``image_folder_samples`` at 224²) or
    ``synthetic_imagenet_samples``, SGD with ``Poly(0.5, 62000)``;
    ``--device`` (default ``cuda``). Returns the trained model."""
    from bigdl_tpu_torch.models.utils import (
        run_training, synthetic_imagenet_samples, train_parser,
    )
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim.optim_method import SGD, Poly

    args = train_parser("Inception-v1 on ImageNet", batch_size=64,
                        learning_rate=0.01, max_epoch=2).parse_args(argv)
    if args.folder:
        from bigdl_tpu_torch.dataset.image import image_folder_samples

        samples = image_folder_samples(args.folder, image_size=224)
    else:
        samples = synthetic_imagenet_samples(args.synthetic)
    method = SGD(learning_rate=args.learningRate, momentum=args.momentum,
                 weight_decay=args.weightDecay,
                 learning_rate_schedule=Poly(0.5, 62000))
    return run_training(
        Inception_v1_NoAuxClassifier(1000, device=args.device), samples,
        ClassNLLCriterion(), args, optim_method=method)


if __name__ == "__main__":
    train_main()
