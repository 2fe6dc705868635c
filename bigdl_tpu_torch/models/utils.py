"""Shared Train/Test option parsing and bodies of the model mains
(``bigdl_tpu/models/utils.py``).

The reference knob names (``-f`` data dir, ``-b`` batchSize,
``--learningRate``, ``--maxEpoch``, ``--cache`` checkpoint dir,
``--overWrite``, ``--model``/``--state`` snapshots to resume from,
``--computeDtype``, ``--summary`` TensorBoard log dir), plus
``--device`` (default ``cuda``; ``cpu`` only when asked for). A main
without ``-f`` (or with a missing directory) falls back to synthetic
data; ``synthetic_imagenet_samples`` is the ImageNet-scale mains' one.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional


def _device_option(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def train_parser(description: str, batch_size: int = 128,
                 learning_rate: float = 0.01,
                 max_epoch: int = 10) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default=None,
                   help="data dir (synthetic data when absent)")
    p.add_argument("-b", "--batchSize", type=int, default=batch_size)
    p.add_argument("--learningRate", type=float, default=learning_rate)
    p.add_argument("--learningRateDecay", type=float, default=0.0)
    p.add_argument("--weightDecay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--maxEpoch", type=int, default=max_epoch)
    p.add_argument("--maxIteration", type=int, default=None,
                   help="overrides --maxEpoch when set")
    p.add_argument("--cache", default=None, help="checkpoint directory")
    p.add_argument("--overWrite", action="store_true",
                   help="overwrite checkpoint files")
    p.add_argument("--model", default=None, help="model snapshot to resume")
    p.add_argument("--state", default=None, help="optim state snapshot")
    p.add_argument("--summary", default=None, help="TensorBoard log dir")
    p.add_argument("--computeDtype", default=None,
                   choices=["bf16", "fp16", "fp32"],
                   help="mixed-precision compute dtype")
    p.add_argument("--synthetic", type=int, default=512,
                   help="synthetic sample count when no data dir")
    _device_option(p)
    return p


def test_parser(description: str,
                batch_size: int = 128) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default=None)
    p.add_argument("-b", "--batchSize", type=int, default=batch_size)
    p.add_argument("--model", required=True,
                   help="model snapshot to evaluate")
    p.add_argument("--synthetic", type=int, default=512)
    _device_option(p)
    return p


def configure_optimizer(opt, args):
    """Apply the shared CLI knobs onto an Optimizer (end trigger,
    checkpoint, summary, dtype). Returns the optimizer."""
    from bigdl_tpu_torch.optim.trigger import Trigger
    from bigdl_tpu_torch.visualization import TrainSummary

    if args.maxIteration:
        opt.set_end_when(Trigger.max_iteration(args.maxIteration))
    else:
        opt.set_end_when(Trigger.max_epoch(args.maxEpoch))
    if args.cache:
        opt.set_checkpoint(args.cache, Trigger.every_epoch())
        if args.overWrite:
            opt.over_write_checkpoint()
    if args.summary:
        opt.set_train_summary(TrainSummary(args.summary, "train"))
    if args.computeDtype and args.computeDtype != "fp32":
        opt.set_compute_dtype(args.computeDtype)
    return opt


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")


def synthetic_imagenet_samples(count: int, seed: int = 0):
    """Random (3, 224, 224) images with 1-based labels in 1..1000 — the
    ImageNet-scale mains' synthetic data, the JAX package's draws."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample

    rng = np.random.default_rng(seed)
    return [Sample(rng.standard_normal((3, 224, 224)).astype(np.float32),
                   np.int32(rng.integers(1, 1001)))
            for _ in range(count)]


def run_training(model, samples, criterion, args,
                 optim_method: Optional[object] = None):
    """The shared Train.scala body: dataset → Optimizer → optimize."""
    from bigdl_tpu_torch.nn.module import AbstractModule
    from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
    from bigdl_tpu_torch.optim.optimizer import Optimizer

    setup_logging()
    if args.model:  # resume from snapshot
        model = AbstractModule.load(args.model, device=args.device)
    opt = Optimizer(model=model, dataset=samples, criterion=criterion,
                    batch_size=args.batchSize)
    method = optim_method or SGD(
        learning_rate=args.learningRate,
        learning_rate_decay=args.learningRateDecay,
        weight_decay=args.weightDecay, momentum=args.momentum)
    if args.state:
        method = OptimMethod.load(args.state)
    opt.set_optim_method(method)
    configure_optimizer(opt, args)
    return opt.optimize()


def run_test(model_path: str, samples, batch_size: int, device=None):
    """The shared Test.scala body: load snapshot → Top-1 evaluate."""
    from bigdl_tpu_torch.nn.module import AbstractModule
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    setup_logging()
    model = AbstractModule.load(model_path, device=device)
    results = model.evaluate(samples, [Top1Accuracy()], batch_size=batch_size)
    for r in results:
        logging.getLogger("bigdl_tpu_torch").info("test result: %s", r)
    return results
