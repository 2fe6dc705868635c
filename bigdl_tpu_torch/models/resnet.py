"""ResNet (``bigdl_tpu/models/resnet.py``): ``ResNet(classNum, {"depth":
50, "shortcutType": "B", "dataSet": "ImageNet"})`` builds a ``Graph`` of
conv-BN blocks with MSRA init and no-bias convolutions, the last BN of
every residual block zero-initialized ("zero gamma"). ImageNet depths
18/34 use basic blocks, 50/101/152/200 bottleneck blocks (expansion 4);
CIFAR-10 depths are 6n+2 basic blocks over 16/32/64 planes. Shortcut type
A is a strided identity with zero-padded channels, B a 1×1 projection on a
change of shape, C always a projection.

The graph, its child order and its params/state trees are the JAX
package's, so :func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree`
carries a JAX model's weights and BN statistics across. Weights are f32,
made on ``device`` (default ``cuda``; raises without a card unless
``device="cpu"``) from a ``torch.Generator`` seeded with ``seed``.
Wrap the result with :func:`bigdl_tpu_torch.nn.tpu_fusion.maybe_fuse` for
the fused NHWC execution. ``train_main`` is the reference's
TrainImageNet/TrainCIFAR10 main over ``models/utils.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.graph import Graph, Input
from bigdl_tpu_torch.nn.init_methods import MsraFiller, Xavier, Zeros
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import CAddTable, Reshape
from bigdl_tpu_torch.utils.device import resolve_device


class _PaddedShortcut(TensorModule):
    """Type-A shortcut: stride the identity spatially and zero-pad the
    channels."""

    def __init__(self, n_in: int, n_out: int, stride: int) -> None:
        super().__init__()
        self.n_in, self.n_out, self.stride = n_in, n_out, stride

    def forward(self, x):
        x = x[:, :, ::self.stride, ::self.stride]
        if self.n_out > self.n_in:
            x = F.pad(x, (0, 0, 0, 0, 0, self.n_out - self.n_in))
        return x


class _Builder:
    """Makes the layers on one device from one generator."""

    def __init__(self, device, generator) -> None:
        self.kw = {"device": device, "generator": generator}

    def conv(self, n_in, n_out, k, stride=1, pad=0):
        return SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad,
                                  with_bias=False,
                                  init_weight=MsraFiller(False), **self.kw)

    def bn(self, n, zero_gamma=False):
        bn = SpatialBatchNormalization(n, **self.kw)
        if zero_gamma:
            bn.set_init_method(weight_init=Zeros())
        return bn

    def shortcut(self, n_in, n_out, stride, shortcut_type):
        if shortcut_type == "C" or (shortcut_type == "B" and n_in != n_out):
            return (Sequential().add(self.conv(n_in, n_out, 1, stride))
                    .add(self.bn(n_out)))
        if n_in != n_out or stride != 1:
            return _PaddedShortcut(n_in, n_out, stride)
        return None  # identity

    def basic_block(self, n_in, planes, stride, zero_gamma):
        residual = (Sequential()
                    .add(self.conv(n_in, planes, 3, stride, 1))
                    .add(self.bn(planes)).add(ReLU(True))
                    .add(self.conv(planes, planes, 3, 1, 1))
                    .add(self.bn(planes, zero_gamma)))
        return residual, planes

    def bottleneck_block(self, n_in, planes, stride, zero_gamma):
        n_out = planes * 4
        residual = (Sequential()
                    .add(self.conv(n_in, planes, 1))
                    .add(self.bn(planes)).add(ReLU(True))
                    .add(self.conv(planes, planes, 3, stride, 1))
                    .add(self.bn(planes)).add(ReLU(True))
                    .add(self.conv(planes, n_out, 1))
                    .add(self.bn(n_out, zero_gamma)))
        return residual, n_out

    def residual(self, node, n_in, planes, stride, block_fn, shortcut_type,
                 zero_gamma):
        """residual(x) + shortcut(x) → ReLU, as a graph sub-DAG."""
        residual, n_out = block_fn(n_in, planes, stride, zero_gamma)
        res_node = residual.inputs(node)
        sc = self.shortcut(n_in, n_out, stride, shortcut_type)
        sc_node = node if sc is None else sc.inputs(node)
        add = CAddTable().inputs(res_node, sc_node)
        return ReLU(True).inputs(add), n_out

    def linear(self, n_in, n_out):
        return Linear(n_in, n_out, init_weight=Xavier(), init_bias=Zeros(),
                      **self.kw)


_IMAGENET_CFG: Dict[int, tuple] = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


def ResNet(class_num: int = 1000, opt: Optional[dict] = None, device=None,
           seed: int = 0) -> Graph:
    """The reference entry ``ResNet(classNum, T("depth" -> 50,
    "shortcutType" -> "B", "dataSet" -> "ImageNet"))``."""
    opt = dict(opt or {})
    depth = int(opt.get("depth", 50))
    shortcut_type = str(opt.get("shortcutType", opt.get("shortcut_type", "B")))
    dataset = str(opt.get("dataSet", opt.get("dataset", "ImageNet")))
    zero_gamma = bool(opt.get("zeroGamma", opt.get("zero_gamma", True)))
    dev = resolve_device(device)
    b = _Builder(dev, torch.Generator(device=dev).manual_seed(int(seed)))
    if dataset.lower() == "cifar10":
        return _resnet_cifar(b, class_num, depth, shortcut_type, zero_gamma)
    return _resnet_imagenet(b, class_num, depth, shortcut_type, zero_gamma)


def _resnet_imagenet(b: _Builder, class_num, depth, shortcut_type,
                     zero_gamma) -> Graph:
    if depth not in _IMAGENET_CFG:
        raise ValueError(f"unsupported ImageNet ResNet depth {depth}")
    kind, counts = _IMAGENET_CFG[depth]
    block_fn = b.basic_block if kind == "basic" else b.bottleneck_block
    inp = Input()
    x = b.conv(3, 64, 7, 2, 3).inputs(inp)
    x = b.bn(64).inputs(x)
    x = ReLU(True).inputs(x)
    x = SpatialMaxPooling(3, 3, 2, 2, 1, 1).inputs(x)
    n_in = 64
    for stage, (planes, count) in enumerate(zip((64, 128, 256, 512), counts)):
        for i in range(count):
            stride = 2 if (stage > 0 and i == 0) else 1
            x, n_in = b.residual(x, n_in, planes, stride, block_fn,
                                 shortcut_type, zero_gamma)
    x = SpatialAveragePooling(7, 7, 1, 1).inputs(x)
    x = Reshape([n_in], batch_mode=True).inputs(x)
    return Graph(inp, b.linear(n_in, class_num).inputs(x))


def _resnet_cifar(b: _Builder, class_num, depth, shortcut_type,
                  zero_gamma) -> Graph:
    if (depth - 2) % 6 != 0:
        raise ValueError(
            "CIFAR ResNet depth must be 6n+2 (20, 32, 44, 56, 110)")
    n = (depth - 2) // 6
    inp = Input()
    x = b.conv(3, 16, 3, 1, 1).inputs(inp)
    x = b.bn(16).inputs(x)
    x = ReLU(True).inputs(x)
    n_in = 16
    for stage, planes in enumerate((16, 32, 64)):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            x, n_in = b.residual(x, n_in, planes, stride, b.basic_block,
                                 shortcut_type, zero_gamma)
    x = SpatialAveragePooling(8, 8, 1, 1).inputs(x)
    x = Reshape([64], batch_mode=True).inputs(x)
    x = b.linear(64, class_num).inputs(x)
    return Graph(inp, LogSoftMax().inputs(x))


def train_main(argv=None):
    """Reference ``models/resnet/TrainImageNet.scala`` /
    ``TrainCIFAR10.scala`` mains: ``--dataset cifar10`` trains ResNet-20
    (shortcut A) on the CIFAR pickle batches under ``-f`` or the synthetic
    set, ``--dataset imagenet`` ResNet-50 (shortcut B) on
    ``synthetic_imagenet_samples``, both with nesterov SGD; ``--device``
    (default ``cuda``). Returns the trained model."""
    from bigdl_tpu_torch.models.utils import run_training, train_parser
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim.optim_method import SGD

    p = train_parser("ResNet training", batch_size=128,
                     learning_rate=0.1, max_epoch=10)
    p.add_argument("--dataset", default="cifar10",
                   choices=["cifar10", "imagenet"])
    p.add_argument("--depth", type=int, default=None,
                   help="default: 20 (cifar10) / 50 (imagenet)")
    p.add_argument("--warmupEpoch", type=int, default=0)
    args = p.parse_args(argv)

    if args.dataset == "cifar10":
        from bigdl_tpu_torch.dataset.cifar import load_samples

        samples = load_samples(args.folder or "/nonexistent", "train",
                               synthetic_count=args.synthetic)
        model = ResNet(10, {"depth": args.depth or 20, "shortcutType": "A",
                            "dataSet": "cifar10"}, device=args.device)
    else:
        from bigdl_tpu_torch.models.utils import synthetic_imagenet_samples

        if args.folder:
            raise NotImplementedError(
                "-f with --dataset imagenet reads an image folder "
                "(image_folder_samples), which comes with the host data "
                "plane (ROADMAP.md A.6); omit -f for synthetic data")
        samples = synthetic_imagenet_samples(args.synthetic)
        model = ResNet(1000, {"depth": args.depth or 50, "shortcutType": "B"},
                       device=args.device)
    method = SGD(learning_rate=args.learningRate, momentum=args.momentum,
                 weight_decay=args.weightDecay, nesterov=True)
    return run_training(model, samples, CrossEntropyCriterion(), args,
                        optim_method=method)


if __name__ == "__main__":
    train_main()
