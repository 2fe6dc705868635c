"""LeNet-5 (BASELINE config #1) in the port against the JAX package on the
CPU: the idx data files, the module facade, ``save``/``load``, the model
itself, its 160-step accuracy twin of tests/test_accuracy_parity.py, and
the ``train_main``/``test_main`` entry points.

JAX's ``LeNet5(10)`` weights (``RNG.set_seed(42)``) go into the port's
with ``load_jax_tree``; both packages build their own batch stream from
the same idx files, and the test checks the streams are equal.

Tolerances, with their reasons:

* forward, input gradient and parameter gradients of the facade: 1e-5
  absolute (f32, convolutions and matmuls summed in other orders);
* each of the first 10 SGD steps, teacher-forced from JAX's parameters:
  every tensor within 1e-5 of its largest magnitude (f32, lr 0.1,
  gradients that differ by rounding), except the conv layers below a
  max-pool near-tie: a 2x2 window whose top two inputs are equal in one
  framework and an ulp apart in the other has its gradient routed to
  different positions (both valid subgradients), and the 4th batch of
  this stream has one;
* the two Optimizers' parameters after 10 steps: the fc layers within
  1e-5 of scale, the conv layers within 1e-3 (they carry that step's
  parting on; measured 1.2e-4 and 2.5e-4 of scale on the CPU);
* final Top-1 after 160 steps: each at least 0.97, and within 0.02 of
  each other (the documented parity tolerance of the JAX harness).
"""

import os

import jax
import numpy as np
import pytest
import torch

BATCH = 128
STEPS = 160
LR = 0.1


@pytest.fixture(scope="module")
def idx_dirs(tmp_path_factory):
    """(JAX-written dir, port-written dir): 4,096 train and 1,024 test
    images at noise 220, as the JAX harness makes them."""
    from bigdl_tpu.dataset.mnist import generate_idx_dataset as jgen
    from bigdl_tpu_torch.dataset.mnist import generate_idx_dataset

    j, t = (str(tmp_path_factory.mktemp(n)) for n in ("jax_idx", "port_idx"))
    jgen(j, n_train=4096, n_test=1024, seed=7, noise=220.0)
    generate_idx_dataset(t, n_train=4096, n_test=1024, seed=7, noise=220.0)
    return j, t


@pytest.fixture(scope="module")
def pair():
    """(JAX LeNet5, port LeNet5) holding the same initial weights."""
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(42)
    jm = JLeNet5(10)
    jm._ensure_params()
    tm = LeNet5(10, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    return jm, tm


def _fresh_pair(pair):
    """Copies of the pair, so a test may train them."""
    import copy

    jm, tm = pair
    jc = copy.deepcopy(jm)
    jc.params = jax.tree_util.tree_map(np.array, jm.params)
    jc.grad_params = None
    return jc, copy.deepcopy(tm)


# ------------------------------------------------------------- data files


def test_idx_files_are_byte_identical(idx_dirs):
    j, t = idx_dirs
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(t)) and len(names) == 4
    for n in names:
        with open(os.path.join(j, n), "rb") as a, \
                open(os.path.join(t, n), "rb") as b:
            assert a.read() == b.read(), n


@pytest.mark.parametrize("kind", ["train", "test"])
def test_each_reader_reads_the_others_files(idx_dirs, kind):
    from bigdl_tpu.dataset.mnist import read_data_sets as jread
    from bigdl_tpu_torch.dataset.mnist import load_samples, read_data_sets

    j, t = idx_dirs
    for mine, theirs in ((read_data_sets(j, kind, synthetic_fallback=False),
                          jread(j, kind, synthetic_fallback=False)),
                         (read_data_sets(t, kind, synthetic_fallback=False),
                          jread(t, kind, synthetic_fallback=False))):
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    samples = load_samples(t, kind, synthetic_fallback=False)
    imgs, labels = jread(j, kind, synthetic_fallback=False)
    assert len(samples) == len(imgs)
    assert samples[3].feature().shape == (1, 28, 28)
    assert np.array_equal(samples[3].feature()[0], imgs[3].astype(np.float32))
    assert samples[3].label() == np.float32(labels[3] + 1)   # 1-based


def test_synthetic_fallback_and_normalizer_match_jax():
    from bigdl_tpu.dataset.image import GreyImgNormalizer as JNorm
    from bigdl_tpu.dataset.mnist import TRAIN_MEAN as JMEAN
    from bigdl_tpu.dataset.mnist import load_samples as jload
    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.dataset.image import GreyImgNormalizer

    assert (mnist.TRAIN_MEAN, mnist.TEST_STD) == (JMEAN, 0.31048024294290553
                                                  * 255)
    mine = list(GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)(
        mnist.load_samples("/nonexistent", "test", synthetic_count=16)))
    theirs = list(JNorm(JMEAN, mnist.TRAIN_STD)(
        jload("/nonexistent", "test", synthetic_count=16)))
    for a, b in zip(mine, theirs):
        assert a.feature().dtype == np.float32
        assert np.array_equal(a.feature(), np.asarray(b.feature()))
        assert a.label() == b.label()


# ---------------------------------------------------------------- modules


def test_lenet_keys_names_and_jax_outputs(pair):
    from bigdl_tpu_torch.nn import Linear, Sequential, Tanh

    jm, tm = pair
    assert [k for k, _ in tm.named_parameters()] == [
        "1:conv1_5x5.weight", "1:conv1_5x5.bias", "4:conv2_5x5.weight",
        "4:conv2_5x5.bias", "8:fc1.weight", "8:fc1.bias", "10:fc2.weight",
        "10:fc2.bias"]
    assert tm[1].get_name() == "conv1_5x5"
    assert tm.n_parameters() == jm.n_parameters() == 6 * 25 + 6 + 12 * 150 \
        + 12 + 192 * 100 + 100 + 100 * 10 + 10
    fc = Linear(3, 2, device="cpu")
    Sequential().add(fc)
    with pytest.raises(ValueError, match="before add"):
        fc.set_name("head")
    assert Tanh().set_name("t").get_name() == "t"
    x = np.random.default_rng(0).standard_normal((5, 1, 28, 28)).astype(
        np.float32)
    jm.evaluate()
    tm.evaluate()
    want = np.asarray(jm.forward(x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # one unbatched image: the Reshape head keeps no batch dim, as in JAX
    np.testing.assert_allclose(tm(torch.from_numpy(x[0])).detach().numpy(),
                               np.asarray(jm.forward(x[0])), atol=1e-5)
    jm.training()
    tm.train()


def _facade_pairs():
    from bigdl_tpu.nn import Linear as JLinear
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.nn import Linear
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(3)
    jl = JLinear(7, 4)
    jl._ensure_params()
    tl = Linear(7, 4, device="cpu")
    load_jax_tree(tl, jax.device_get(jl.params))
    return {"linear": (jl, tl, (6, 7), (6, 4))}


@pytest.mark.parametrize("which", ["lenet", "linear"])
def test_forward_backward_facade_matches_jax(pair, which):
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    if which == "lenet":
        jm, tm = _fresh_pair(pair)
        in_shape, out_shape = (6, 1, 28, 28), (6, 10)
    else:
        jm, tm, in_shape, out_shape = _facade_pairs()["linear"]
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(in_shape).astype(np.float32) for _ in range(2)]
    gs = [rng.standard_normal(out_shape).astype(np.float32) for _ in range(2)]
    jm.zero_grad_parameters()
    tm.zero_grad_parameters()
    assert float(tm.get_parameters()[1].abs().sum()) == 0.0
    for x, g in zip(xs, gs):          # two backward calls accumulate
        out = tm.update_output(x)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jm.forward(x)), atol=1e-5)
        assert tm.output is out
        gx = tm.backward(x, g)
        want_gx = np.asarray(jm.backward(x, g))
        assert tm.grad_input is gx
        np.testing.assert_allclose(gx.numpy(), want_gx, atol=1e-5, rtol=0)
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    want = named_leaves(tm, jax.device_get(jm.grad_params))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    jw, jg = jm.get_parameters()
    tw, tg = tm.get_parameters()
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    assert [w.shape for w in tm.get_weights()] == [
        np.asarray(w).shape for w in jm.get_weights()]
    # the aliases run the same vjp
    tm.zero_grad_parameters()
    assert tm.update_grad_input(xs[0], gs[0]) is tm.grad_input
    once = tm.get_parameters()[1].clone()
    tm.acc_grad_parameters(xs[0], gs[0])
    assert torch.equal(tm.get_parameters()[1], once * 2)


def test_set_weights_round_trip_in_jax_order(pair):
    jm, tm = _fresh_pair(pair)
    ws = [w * 0 + i for i, w in enumerate(jm.get_weights())]
    jm.set_weights(ws)
    tm.set_weights(ws)
    for a, b in zip(tm.get_weights(), jm.get_weights()):
        assert np.array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="arrays"):
        tm.set_weights(ws[:-1])
    with pytest.raises(ValueError, match="shape"):
        tm.set_weights(ws[::-1])


def test_save_and_load_round_trip(pair, tmp_path):
    from bigdl_tpu_torch.nn.module import AbstractModule

    _, tm = _fresh_pair(pair)
    path = str(tmp_path / "lenet.bigdl")
    tm.save(path)
    with pytest.raises(FileExistsError):
        tm.save(path)
    tm.save(path, over_write=True)
    back = AbstractModule.load(path, device="cpu")
    assert back is not tm and type(back) is type(tm)
    assert [k for k, _ in back.named_parameters()] == [
        k for k, _ in tm.named_parameters()]
    for a, b in zip(back.parameters(), tm.parameters()):
        assert torch.equal(a, b) and a.requires_grad
    x = torch.randn(3, 1, 28, 28)
    assert torch.equal(back(x), tm(x))
    assert back[1].get_name() == "conv1_5x5" and back.output is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AbstractModule.load(path)


def test_tanh_and_engine_type_match_jax():
    from bigdl_tpu.nn import Tanh as JTanh
    from bigdl_tpu.utils.engine import EngineType as JEngineType
    from bigdl_tpu_torch.nn import Tanh
    from bigdl_tpu_torch.utils.engine import EngineType

    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    np.testing.assert_allclose(Tanh()(torch.from_numpy(x)).numpy(),
                               np.asarray(JTanh().forward(x)), atol=1e-6)
    for name in ("tpu", "MklDnn", " mklblas ", "MKLBLAS"):
        assert EngineType.parse(name).value == JEngineType.parse(name).value
    assert [e.value for e in EngineType] == [e.value for e in JEngineType]
    with pytest.raises(ValueError, match="unknown engine type"):
        EngineType.parse("cuda-graphs")


# ----------------------------------------------------- the accuracy twin


def _streams(idx_dirs):
    """Each package's 160-batch train stream (seed 11, normalized)."""
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset import SampleToMiniBatch as JBatch
    from bigdl_tpu.dataset.image import GreyImgNormalizer as JNorm
    from bigdl_tpu.dataset.mnist import load_samples as jload
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.dataset.image import GreyImgNormalizer

    j, t = idx_dirs
    norm = (mnist.TRAIN_MEAN, mnist.TRAIN_STD)
    jit = (JDataSet.array(jload(j, "train", synthetic_fallback=False),
                          seed=11)
           .transform(JNorm(*norm)).transform(JBatch(BATCH))).data(True)
    tit = (DataSet.array(mnist.load_samples(t, "train",
                                            synthetic_fallback=False),
                         seed=11)
           .transform(GreyImgNormalizer(*norm))
           .transform(SampleToMiniBatch(BATCH))).data(True)
    return ([next(jit) for _ in range(STEPS)],
            [next(tit) for _ in range(STEPS)])


@pytest.fixture(scope="module")
def twin(pair, idx_dirs):
    """Both packages trained through their own Optimizer: the parameters
    after 10 steps, then the 150 further steps' models."""
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import Optimizer as JOptimizer
    from bigdl_tpu.optim import Trigger as JTrigger
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jm, tm = _fresh_pair(pair)
    jb, tb = _streams(idx_dirs)
    for a, b in zip(jb, tb):
        assert np.array_equal(a.get_input(), b.get_input())
        assert np.array_equal(a.get_target(), b.get_target())
    jopt = JOptimizer(model=jm, dataset=JDataSet.array(jb),
                      criterion=JNLL(),
                      end_trigger=JTrigger.max_iteration(10))
    jopt.set_optim_method(JSGD(learning_rate=LR))
    topt = Optimizer(tm, DataSet.array(tb), ClassNLLCriterion(),
                     end_trigger=Trigger.max_iteration(10))
    topt.set_optim_method(SGD(learning_rate=LR))
    jopt.optimize()
    topt.optimize()
    want = named_leaves(tm, jax.device_get(jm.params))
    after10 = {k: (p.detach().numpy().copy(), want[k])
               for k, p in tm.named_parameters()}
    # the same two optimizers on to step 160 (each restarts its stream)
    jopt.set_end_when(JTrigger.max_iteration(STEPS))
    topt.set_end_when(Trigger.max_iteration(STEPS))
    jopt.optimize()
    topt.optimize()
    return after10, jm, tm, topt


def _pool_near_ties(tm, x):
    """Output channels of conv1 and conv2 whose 2x2 max-pool windows, in
    the port's forward of ``x``, have their top two inputs within four
    f32 ulps: the frameworks may route such a window's gradient to
    different positions."""
    import torch.nn.functional as F

    def tied(h):
        w = h.unfold(2, 2, 2).unfold(3, 2, 2).reshape(
            *h.shape[:2], -1, 4).sort(-1, descending=True).values
        near = (w[..., 0] - w[..., 1]) <= 4 * 2.0 ** -23 * w[..., 0].abs()
        return set(torch.nonzero(near.any(-1).any(0)).ravel().tolist())

    with torch.no_grad():
        h1 = torch.tanh(tm[1](x))
        h2 = torch.tanh(tm[4](F.max_pool2d(h1, 2)))
    return tied(h1), tied(h2)


def test_each_of_the_first_10_steps_matches_jax(pair, idx_dirs):
    """Teacher-forced: each of the Optimizer stream's first 10 steps starts
    both packages from JAX's parameters; every tensor of the result within
    1e-5 of its largest magnitude. On a step whose forward has a max-pool
    near-tie (``_pool_near_ties``) the conv layers below that pool are not
    compared; the layers above the pools still are."""
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves

    jm, tm = _fresh_pair(pair)
    jb, _ = _streams(idx_dirs)
    order = JDataSet.array(jb).data(train=True)
    jstep = jax.jit(jmake(jm, JNLL(), JSGD(LR)))
    tstep = make_train_step(tm, ClassNLLCriterion(), SGD(LR))
    jp, tied_steps = jax.device_get(jm.params), []
    for i in range(10):
        b = next(order)
        x, y = b.get_input(), b.get_target()
        load_jax_tree(tm, jp)
        t1, t2 = _pool_near_ties(tm, torch.from_numpy(x))
        tp = {k: p.detach().clone() for k, p in tm.named_parameters()}
        tp, *_ = tstep(tp, SGD(LR).init_state(tp), {}, None,
                       torch.from_numpy(x), torch.from_numpy(y))
        jp, *_ = jstep(jp, JSGD(LR).init_state(jp), jm.state,
                       jax.random.PRNGKey(0), x, y)
        jp = jax.device_get(jp)
        below = ({"1:conv1_5x5.weight"} if t1 else set()) | (
            {"1:conv1_5x5", "4:conv2_5x5"} if t2 else set())
        if below:
            tied_steps.append(i)
        for k, w in named_leaves(tm, jp).items():
            if k in below or k.split(".")[0] in below:
                continue
            err = np.abs(tp[k].numpy() - w).max() / np.abs(w).max()
            assert err <= 1e-5, (i, k, err)
    assert len(tied_steps) <= 2, tied_steps   # the rest compared in full


def test_twin_parameters_after_10_optimizer_steps(twin):
    """The two Optimizers' parameters after 10 steps: the layers above the
    pools within 1e-5 of each tensor's scale; the conv layers within 1e-3,
    since the stream's 4th step has a max-pool near-tie (see
    test_each_of_the_first_10_steps_matches_jax) whose parted gradient the
    later steps carry on (measured: 1.2e-4 and 2.5e-4 of scale)."""
    after10, *_ = twin
    for k, (g, w) in after10.items():
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= (1e-3 if "conv" in k else 1e-5), (k, err)


def _val_batches(idx_dir):
    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.dataset.image import GreyImgNormalizer
    from bigdl_tpu_torch.dataset.sample import MiniBatch

    from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch

    samples = mnist.load_samples(idx_dir, "test", synthetic_fallback=False)
    norm = GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
    xs = np.stack([s.feature() for s in norm(iter(samples))])
    ys = np.array([s.label() for s in samples], np.float32)  # 1-based
    cuts = range(0, len(xs), BATCH)
    return ([MiniBatch(xs[i:i + BATCH], ys[i:i + BATCH]) for i in cuts],
            [JMiniBatch(xs[i:i + BATCH], ys[i:i + BATCH]) for i in cuts])


def test_twin_trains_to_the_bar_and_within_parity_of_jax(twin, idx_dirs):
    from bigdl_tpu.optim import Top1Accuracy as JTop1
    from bigdl_tpu.optim.evaluator import Evaluator as JEvaluator
    from bigdl_tpu_torch.optim.evaluator import Evaluator
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    _, jm, tm, topt = twin
    assert topt.optim_method.state["neval"] == STEPS + 1
    batches, jbatches = _val_batches(idx_dirs[1])
    jacc, jn = JEvaluator(jm).test(jbatches, [JTop1()], BATCH)[0].result()
    tacc, tn = Evaluator(tm).test(batches, [Top1Accuracy()], BATCH)[0].result()
    assert jn == tn == 1024
    assert tacc >= 0.97, f"port Top-1 {tacc:.4f} < 0.97"
    assert abs(tacc - jacc) <= 0.02, (tacc, jacc)


# ------------------------------------------------------------ entry points


def test_train_main_and_test_main_on_the_cpu(idx_dirs, tmp_path):
    from types import SimpleNamespace

    from bigdl_tpu_torch.models.lenet import (
        mnist_dataset, test_main, train_main,
    )
    from bigdl_tpu_torch.optim.validation import AccuracyResult, Top1Accuracy

    d = idx_dirs[1]
    ckpt = str(tmp_path / "ckpt")
    model = train_main(["-f", d, "-b", "128", "--maxEpoch", "1",
                        "--cache", ckpt, "--device", "cpu"])
    assert sorted(os.listdir(ckpt)) == ["model", "optimMethod"]
    (res,) = test_main(["-f", d, "--model", os.path.join(ckpt, "model"),
                        "--device", "cpu"])
    assert isinstance(res, AccuracyResult) and res.count == 1024
    # the checkpoint holds the trained weights the main returned
    test_set = mnist_dataset(SimpleNamespace(folder=d, synthetic=0), "test")
    (again,) = model.evaluate(test_set, [Top1Accuracy()], 128)
    assert again.correct == res.correct and res.result()[0] > 0.5
    # --summary is ported: a TrainSummary under <dir>/train/train
    from bigdl_tpu_torch.visualization import TrainSummary

    train_main(["-f", d, "--maxIteration", "2", "--summary", str(tmp_path),
                "--device", "cpu"])
    loss = TrainSummary(str(tmp_path), "train").read_scalar("Loss")
    assert [s for s, _ in loss] == [1, 2] and all(v > 0 for _, v in loss)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["-f", d])


def test_parsers_keep_the_jax_knobs():
    from bigdl_tpu.models.utils import test_parser as jtest
    from bigdl_tpu.models.utils import train_parser as jtrain
    from bigdl_tpu_torch.models.utils import test_parser, train_parser

    for mine, theirs, argv in (
            (train_parser("x", 128, 0.05, 5), jtrain("x", 128, 0.05, 5), []),
            (test_parser("x"), jtest("x"), ["--model", "m"])):
        a, b = vars(mine.parse_args(argv)), vars(theirs.parse_args(argv))
        assert a.pop("device") == "cuda"
        assert a == b
