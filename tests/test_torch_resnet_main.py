"""ResNet's training main (``bigdl_tpu_torch/models/resnet.py::
train_main``), ``models/utils.py``'s ``--summary`` and
``synthetic_imagenet_samples``, ``dataset/cifar.py``, and the CIFAR and
basic-block ResNets' forward, against the JAX package on the CPU.

Tolerances, with their reasons:

* ``train_main`` on cifar10: the ``Loss`` scalars within 1e-4 relative
  (ResNet-20 in f32; two steps, each through 21 conv-BN layers summed in
  other orders; the second step's loss reads the first step's update);
* the synthetic data and the CIFAR files: bitwise (the same numpy draws);
* forwards: 1e-5 relative to the output's largest magnitude (f32, about
  20 layers with sums in other orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.models import resnet as jres
from bigdl_tpu.utils.random_gen import RNG
from bigdl_tpu_torch.dataset import cifar as tcifar
from bigdl_tpu_torch.models import resnet as tres
from bigdl_tpu_torch.utils.params_tree import load_jax_tree


# ------------------------------------------------------------ cifar files


@pytest.mark.parametrize("n,seed", [(64, 21), (10, 22), (7, 0)])
def test_synthetic_cifar_sets_equal_jax(n, seed):
    for got, want in ((tcifar._synthetic(n, seed), jcifar._synthetic(n, seed)),
                      (tcifar._synthetic_learnable(n, seed, 90.0),
                       jcifar._synthetic_learnable(n, seed, 90.0))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert tcifar.TRAIN_MEAN == jcifar.TRAIN_MEAN
    assert tcifar.TRAIN_STD == jcifar.TRAIN_STD


def test_batch_files_are_byte_identical_and_read_both_ways(tmp_path):
    dirs = {}
    for name, mod in (("jax", jcifar), ("port", tcifar)):
        dirs[name] = str(tmp_path / name)
        mod.generate_batch_dataset(dirs[name], n_train=53, n_test=17, seed=4,
                                   noise=70.0)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) == [
        f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for f in names:
        with open(os.path.join(dirs["jax"], f), "rb") as a, \
                open(os.path.join(dirs["port"], f), "rb") as b:
            assert a.read() == b.read(), f
    for kind in ("train", "test"):
        for d in dirs.values():
            (ti, tl), (ji, jl) = (tcifar.read_data_sets(d, kind),
                                  jcifar.read_data_sets(d, kind))
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)
        ts = tcifar.load_samples(dirs["port"], kind)
        js = jcifar.load_samples(dirs["port"], kind)
        assert len(ts) == len(js) == (53 if kind == "train" else 17)
        for t, j in zip(ts, js):
            np.testing.assert_array_equal(t.feature(), j.feature())
            assert t.label() == j.label() and t.label().dtype == np.float32
    with pytest.raises(FileNotFoundError):
        tcifar.read_data_sets(str(tmp_path / "none"),
                              synthetic_fallback=False)
    imgs, labels = tcifar.read_data_sets(str(tmp_path / "none"), "test",
                                         synthetic_count=9)
    np.testing.assert_array_equal(imgs, jcifar._synthetic(9, 22)[0])


@pytest.mark.parametrize("count,seed", [(3, 0), (2, 5)])
def test_synthetic_imagenet_samples_equal_jax(count, seed):
    from bigdl_tpu.models.utils import synthetic_imagenet_samples as jsyn
    from bigdl_tpu_torch.models.utils import synthetic_imagenet_samples

    got, want = synthetic_imagenet_samples(count, seed), jsyn(count, seed)
    assert len(got) == len(want) == count
    for g, w in zip(got, want):
        assert g.feature().shape == (3, 224, 224)
        np.testing.assert_array_equal(g.feature(), w.feature())
        assert g.label() == w.label() and g.label().dtype == np.int32


# --------------------------------------------------------------- forwards


def _perturbed(jm, seed):
    """The JAX model's params and state with every 1-D leaf moved off its
    initial value (non-zero gammas, so every residual branch counts;
    running statistics away from 0 and 1, so eval mode reads them)."""
    rng = np.random.default_rng(seed)

    def walk(t, state):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, state)
                continue
            a = np.array(v)
            if a.ndim == 1:
                d = rng.uniform(0.2, 0.6, a.shape).astype(np.float32)
                a = a + d if (not state or "mean" in k) else a * (1 + d)
            out[k] = a
        return out

    return (walk(jax.device_get(jm.params), False),
            walk(jax.device_get(jm.state), True))


def _close(got, want, rtol, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= rtol, f"{what}: relative error {err} > {rtol}"


@pytest.mark.parametrize("shortcut", ["A", "B", "C"])
@pytest.mark.parametrize("net", ["cifar20", "resnet18"])
def test_cifar_and_basic_block_forwards_match_jax(net, shortcut):
    """ResNet-20 CIFAR at 32² (batch 2) and ResNet-18 at 193², the least
    input whose last stage is 7² for the 7×7 head (batch 1: its BNs still
    average 49 or more values), training (batch statistics) and evaluate
    (running statistics) mode."""
    cfg = ((10, {"depth": 20, "shortcutType": shortcut, "dataSet": "cifar10"},
            32, 2) if net == "cifar20" else
           (1000, {"depth": 18, "shortcutType": shortcut}, 193, 1))
    RNG.set_seed(3)
    jm = jres.ResNet(cfg[0], cfg[1])
    jm._ensure_params()
    params, state = _perturbed(jm, 4)
    tm = tres.ResNet(cfg[0], cfg[1], device="cpu")
    x = np.random.default_rng(5).standard_normal(
        (cfg[3], 3, cfg[2], cfg[2])).astype(np.float32)
    for training in (True, False):
        # the port's training forward updates the running statistics in
        # place (JAX returns them): start each mode from the same state
        load_jax_tree(tm, params, state)
        want, _ = jm.apply(params, jnp.asarray(x), state, training=training)
        with torch.no_grad():
            got = (tm.train() if training else tm.eval())(torch.from_numpy(x))
        _close(got, want, 1e-5, f"{net}/{shortcut} training={training}")


# ------------------------------------------------------------- the mains


def _capture_jax_init(monkeypatch):
    """Make JAX's ``train_main`` keep its model's initial trees, and the
    port's build its model with them."""
    init = {}
    jax_build, port_build = jres.ResNet, tres.ResNet

    def jax_resnet(*a, **kw):
        m = jax_build(*a, **kw)
        m._ensure_params()
        init["trees"] = (jax.device_get(m.params), jax.device_get(m.state))
        return m

    def port_resnet(*a, **kw):
        return load_jax_tree(port_build(*a, **kw), *init["trees"])

    monkeypatch.setattr(jres, "ResNet", jax_resnet)
    monkeypatch.setattr(tres, "ResNet", port_resnet)


def test_cifar10_train_main_matches_jax(monkeypatch, tmp_path):
    """The twin of ``tests/test_model_mains.py::
    test_resnet_cifar_train_main``, with ``--summary``."""
    from bigdl_tpu.visualization.summary import TrainSummary as JSummary
    from bigdl_tpu_torch.visualization import TrainSummary

    _capture_jax_init(monkeypatch)
    argv = ["--synthetic", "64", "-b", "16", "--maxIteration", "2",
            "--dataset", "cifar10", "--depth", "20"]
    RNG.set_seed(11)
    jres.train_main(argv + ["--summary", str(tmp_path / "jax")])
    model = tres.train_main(argv + ["--summary", str(tmp_path / "port"),
                                    "--device", "cpu"])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    want = JSummary(str(tmp_path / "jax"), "train").read_scalar("Loss")
    got = TrainSummary(str(tmp_path / "port"), "train").read_scalar("Loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    for tag in ("Throughput", "LearningRate"):
        assert len(TrainSummary(str(tmp_path / "port"), "train")
                   .read_scalar(tag)) == 2


def test_imagenet_branch_builds_resnet50_b_with_nesterov_sgd(monkeypatch,
                                                             tmp_path):
    """The branch's model, data and optim method, handed to the shared
    ``run_training`` (stubbed here: the card's ``resnet_main`` phase
    trains it; ``test_cifar10_train_main_matches_jax`` runs the body)."""
    from bigdl_tpu_torch.models import utils as tutils

    seen = {}

    def capture(model, samples, criterion, args, optim_method=None):
        seen.update(model=model, samples=samples, args=args,
                    method=optim_method, criterion=criterion)
        return model

    monkeypatch.setattr(tutils, "run_training", capture)
    model = tres.train_main(["--dataset", "imagenet", "--synthetic", "2",
                             "-b", "2", "--device", "cpu", "--momentum",
                             "0.8", "--weightDecay", "1e-4"])
    assert model is seen["model"]
    assert sum(p.numel() for p in model.parameters()) == 25557032
    assert not any("Padded" in type(m).__name__ for m in model.modules())
    assert next(model.parameters()).device.type == "cpu"
    m = seen["method"]
    assert (m.nesterov, m.momentum, m.weight_decay, m.learning_rate) == (
        True, 0.8, 1e-4, 0.1)
    assert type(seen["criterion"]).__name__ == "CrossEntropyCriterion"
    want = tutils.synthetic_imagenet_samples(2)
    assert len(seen["samples"]) == 2
    np.testing.assert_array_equal(seen["samples"][1].feature(),
                                  want[1].feature())
    with pytest.raises(NotImplementedError, match="A.6"):
        tres.train_main(["--dataset", "imagenet", "-f", str(tmp_path),
                         "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tres.train_main(["--synthetic", "16", "-b", "16",
                             "--maxIteration", "1"])
