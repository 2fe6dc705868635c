"""The facade methods the method-level name diff found the port lacking,
held against the JAX package on the CPU, and the diff itself.

``tools/torch_name_diff.py`` lists, besides module-level names, the
public methods a JAX class defines and the same-named port class lacks
(its own, a port base's or ``nn.Module``'s), less its list of differences
on purpose; over every module both packages have it must name nothing.

The repairs: ``AbstractModule.reset`` (held within the port: one
generator seed gives one tree, the shapes are JAX's tree's, and the init
laws are JAX's, read from the range and spread of a large draw of each,
but ``Linear``'s bias law, an open fault of the port, ROADMAP C.1; a
loaded model resets, and a dropped model is freed with no cyclic
collection), ``is_training``, ``set_init_method`` on ``Linear``, ``LookupTable`` and
``SpatialShareConvolution`` (the refilled tensors equal JAX's), the
criteria's ``update_output`` / ``update_grad_input``, ``OptimMethod.
optimize`` and ``get_learning_rate`` (SGD and Adam over three calls: the
same ``x``, losses and ``state["neval"]`` as JAX's within 1e-6),
``MiniBatch.slice``, ``AbstractDataSet.shuffle``, ``SamplingParams.
greedy``, and the loaders still queued (``load_caffe_model``,
``load_tf``) raising ``NotImplementedError`` that names their queue.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import max_rel_err, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _diff(*modules):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_name_diff.py"),
         *modules], capture_output=True, text=True, timeout=120)


def test_method_level_name_diff_is_empty():
    done = _diff()
    assert done.returncode == 0, done.stdout + done.stderr
    lines = done.stdout.strip().splitlines()
    assert lines and all(ln.endswith("missing [] methods []")
                         for ln in lines), done.stdout


def test_keras_path_modules_are_ported():
    mods = ["nn/keras.py", "utils/keras_loader.py", "utils/serializer.py"]
    done = _diff(*mods)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.count("missing [] methods []") == len(mods)


def test_name_diff_finds_a_missing_method(tmp_path):
    """The method check sees a gap: a copy of the tool run over a port
    class stripped of one method names it."""
    import shutil

    root = tmp_path / "repo"
    for pkg in ("bigdl_tpu/nn", "bigdl_tpu_torch/nn"):
        (root / pkg).mkdir(parents=True)
    (root / "tools").mkdir()
    shutil.copy(os.path.join(ROOT, "tools", "torch_name_diff.py"),
                root / "tools")
    (root / "bigdl_tpu/nn/m.py").write_text(
        "class A:\n    def keep(self): pass\n    def gone(self): pass\n")
    (root / "bigdl_tpu_torch/nn/m.py").write_text(
        "class Base:\n    def keep(self): pass\n\nclass A(Base):\n"
        "    pass\n")
    done = subprocess.run([sys.executable, str(root / "tools" /
                                               "torch_name_diff.py"),
                           "nn/m.py"], capture_output=True, text=True)
    assert done.returncode == 1
    assert "methods ['A.gone']" in done.stdout


# -- reset -------------------------------------------------------------------

def _models():
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    def build(N, **kw):
        return (N.Sequential()
                .add(N.SpatialConvolution(3, 8, 3, 3, **kw))
                .add(N.SpatialBatchNormalization(8, **kw))
                .add(N.ReLU())
                .add(N.Reshape([8 * 4 * 4], batch_mode=True))
                .add(N.Linear(128, 16, **kw)))

    rec = (lambda N, **kw: N.Recurrent().add(N.LSTM(6, 5, **kw)))
    return [(build(J), build(T, device="cpu")),
            (rec(J), rec(T, device="cpu"))]


def test_reset_one_seed_one_tree_and_jax_shapes():
    from bigdl_tpu_torch.utils.params_tree import named_leaves
    from tests.torch_parity import numpy_trees

    for jm, tm in _models():
        trees = []
        for seed in (3, 3, 4):
            tm.reset(torch.Generator().manual_seed(seed))
            trees.append({k: p.detach().clone()
                          for k, p in tm.named_parameters()})
        assert all(torch.equal(trees[0][k], trees[1][k]) for k in trees[0])
        assert any(not torch.equal(trees[0][k], trees[2][k])
                   for k in trees[0])
        params, state = numpy_trees(jm, 0)
        # every JAX leaf is on the port's side with its shape
        assert set(named_leaves(tm, params)) == set(trees[0])
        named_leaves(tm, state, "buffers")


def test_reset_draws_jax_init_laws():
    """A large draw of each law (every tensor 3,000 values or more): the
    same spread (std, 90th percentile of |w|) and, for a bounded law, the
    same bound (max |w|) as JAX's init of the same layer, within 5%. One
    law differs, ROADMAP C.1's open fault: ``Linear``'s bias is uniform
    ±1/sqrt(in) in the port, ±1/sqrt(out) in JAX (its length as fan)."""
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    pairs = {
        "Linear": (J.Linear(400, 3000), T.Linear(400, 3000, device="cpu")),
        "LookupTable": (J.LookupTable(500, 64),
                        T.LookupTable(500, 64, device="cpu")),
        "SpatialConvolution": (J.SpatialConvolution(8, 3000, 3, 3),
                               T.SpatialConvolution(8, 3000, 3, 3,
                                                    device="cpu")),
        "LSTM": (J.LSTM(100, 750), T.LSTM(100, 750, device="cpu")),
    }
    for name, (jl, tl) in pairs.items():
        want = jax.device_get(jl.init_params(jax.random.PRNGKey(0)))
        tl.reset(torch.Generator().manual_seed(0))
        got = dict(tl.named_parameters())
        for k, w in want.items():
            w, g = np.asarray(w), got[k].detach().numpy()
            assert g.shape == w.shape, (name, k)
            if (name, k) == ("Linear", "bias"):    # the C.1 difference
                bound_in, bound_out = 400 ** -0.5, 3000 ** -0.5
                assert abs(np.abs(g).max() / bound_in - 1) < 0.05
                assert abs(np.abs(w).max() / bound_out - 1) < 0.05
                continue
            if w.std() == 0:                       # a constant law
                assert np.array_equal(g, w), (name, k)
                continue
            if np.abs(w).max() < 2 * w.std():      # bounded (uniform)
                assert abs(np.abs(g).max() / np.abs(w).max() - 1) < 0.05, \
                    (name, k)
            assert abs(np.quantile(np.abs(g), 0.9)
                       / np.quantile(np.abs(w), 0.9) - 1) < 0.05, (name, k)
            assert abs(g.std() / w.std() - 1) < 0.05, (name, k)


def test_reset_restores_running_statistics_and_needs_a_law(tmp_path):
    """Running statistics go back to 0 and 1; a loaded model resets as
    the one it was saved from (the init methods are part of the file);
    a parameter without an init method (a quantized layer's) is
    refused with its name."""
    import bigdl_tpu_torch.nn as T
    from bigdl_tpu_torch.nn.module import AbstractModule

    bn = T.SpatialBatchNormalization(4, device="cpu")
    bn.train()
    bn(torch.randn(3, 4, 5, 5) * 3 + 2)
    assert not torch.equal(bn.running_mean, torch.zeros(4))
    bn.reset()
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))
    p = str(tmp_path / "m.bigdl")
    m = (T.Sequential().add(T.Linear(3, 4, device="cpu"))
         .add(T.PReLU(4, device="cpu")).add(T.Scale([4], device="cpu")))
    m.save_module(p)
    loaded = AbstractModule.load_module(p, device="cpu")
    for mm in (m, loaded):
        mm.reset(torch.Generator().manual_seed(2))
    for (k, a), (_, b) in zip(m.named_parameters(),
                              loaded.named_parameters()):
        assert torch.equal(a, b), k
    q = T.QuantizedLinear.from_linear(T.Linear(3, 2, device="cpu"))
    with pytest.raises(ValueError, match="weight_q has no init method"):
        q.reset()


@pytest.mark.parametrize("kind", ["layers", "keras"])
def test_a_dropped_model_is_freed_at_once(kind):
    """Nothing a layer keeps for reset refers back to it: a dropped model
    and its parameters go with their last reference, no cyclic
    collection needed."""
    import gc
    import weakref

    import bigdl_tpu_torch.nn as T
    from bigdl_tpu_torch.nn import keras as K

    def build():
        g = torch.Generator().manual_seed(0)
        if kind == "keras":
            return (K.Sequential(device="cpu", generator=g)
                    .add(K.Embedding(10, 4, input_shape=(5,)))
                    .add(K.LSTM(3)).add(K.Dense(2)))
        return (T.Sequential()
                .add(T.SpatialConvolution(3, 4, 3, 3, device="cpu",
                                          generator=g))
                .add(T.SpatialBatchNormalization(4, device="cpu"))
                .add(T.Reshape([4 * 4 * 4], batch_mode=True))
                .add(T.Linear(64, 5, device="cpu", generator=g))
                .add(T.LookupTable(5, 3, device="cpu"))
                .add(T.SReLU([3], device="cpu", generator=g)))

    was = gc.isenabled()
    gc.disable()
    try:
        m = build()
        m.reset(torch.Generator().manual_seed(1))
        refs = [weakref.ref(m)] + [weakref.ref(p) for p in m.parameters()]
        del m
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()


def test_is_training():
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    for m in (J.Linear(2, 2), T.Linear(2, 2, device="cpu")):
        assert m.is_training()
        m.evaluate()
        assert not m.is_training()
    t = T.Linear(2, 2, device="cpu")
    t.evaluate()
    assert t.train().is_training()


@pytest.mark.parametrize("cls", ["Linear", "LookupTable",
                                 "SpatialShareConvolution"])
def test_set_init_method_refills_as_jax(cls):
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    args = {"Linear": (5, 3), "LookupTable": (6, 4),
            "SpatialShareConvolution": (2, 3, 3, 3)}[cls]
    jl = getattr(J, cls)(*args)
    tl = getattr(T, cls)(*args, device="cpu")
    methods = [(J.ConstInitMethod(0.25), T.ConstInitMethod(0.25)),
               (J.Zeros(), T.Zeros())]
    assert tl.set_init_method(methods[0][1], methods[1][1]) is tl
    jl.set_init_method(methods[0][0], methods[1][0])
    want = jax.device_get(jl.init_params(jax.random.PRNGKey(1)))
    got = {k: p.detach().numpy() for k, p in tl.named_parameters()}
    flat = {k.split(".")[-1]: v for k, v in got.items()}
    assert set(flat) == set(want)
    for k, w in want.items():
        assert np.array_equal(flat[k], np.asarray(w)), k
    tl.reset(torch.Generator().manual_seed(0))      # the new law sticks
    assert all(np.array_equal(p.detach().numpy(), flat[k.split(".")[-1]])
               for k, p in tl.named_parameters())


def test_criterion_update_aliases_match_jax():
    import jax.numpy as jnp

    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    rs = np.random.default_rng(5)
    x = np.log(rs.dirichlet(np.ones(4), 3)).astype(np.float32)
    y = np.array([1, 4, 2], np.float32)
    jc, tc = J.ClassNLLCriterion(), T.ClassNLLCriterion()
    want = jc.update_output(jnp.asarray(x), jnp.asarray(y))
    got = tc.update_output(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(got - want) <= 1e-6 * abs(want)
    gw = np.asarray(jc.update_grad_input(jnp.asarray(x), jnp.asarray(y)))
    gg = tc.update_grad_input(torch.from_numpy(x), torch.from_numpy(y))
    assert max_rel_err(gg.numpy(), gw) <= 1e-6
    assert got == tc.forward(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("method", ["SGD", "Adam"])
def test_optimize_matches_jax(method):
    import jax.numpy as jnp

    import bigdl_tpu.optim as JO
    from bigdl_tpu_torch.optim import optim_method as TO

    kw = ({"learning_rate": 0.1, "momentum": 0.9} if method == "SGD"
          else {"learning_rate": 0.05})
    jo, to = getattr(JO, method)(**kw), getattr(TO, method)(**kw)
    target = np.array([0.5, -1.0, 2.0], np.float32)
    x0 = np.array([1.0, 2.0, -1.0], np.float32)

    def jfeval(v):
        d = v - target
        return jnp.sum(d * d), 2 * d

    def tfeval(v):
        d = v - torch.from_numpy(target)
        return (d * d).sum(), 2 * d

    jx, tx = jnp.asarray(x0), torch.from_numpy(x0.copy())
    for _ in range(3):
        jx, jl = jo.optimize(jfeval, jx)
        tx, tl = to.optimize(tfeval, tx)
        assert max_rel_err(tx.numpy(), np.asarray(jx)) <= 1e-6
        assert abs(tl[0] - jl[0]) <= 1e-6 * abs(jl[0])
    assert to.state["neval"] == jo.state["neval"] == 4
    assert to.get_learning_rate() == jo.get_learning_rate() == \
        kw["learning_rate"]
    to.clear_history()
    assert to.state["neval"] == 1 and to._facade_state is None


def test_minibatch_slice_shuffle_and_greedy():
    from bigdl_tpu.dataset.sample import MiniBatch as JB
    from bigdl_tpu.serving.sampling import SamplingParams as JS
    from bigdl_tpu_torch.dataset.dataset import DataSet, LocalDataSet
    from bigdl_tpu_torch.dataset.sample import MiniBatch
    from bigdl_tpu_torch.serving.sampling import SamplingParams

    rs = np.random.default_rng(2)
    xs, ys = rs.standard_normal((6, 3)), np.arange(6)
    for inp in (xs, [xs, xs * 2]):
        j, t = JB(inp, ys).slice(2, 3), MiniBatch(inp, ys).slice(2, 3)
        assert t.size() == j.size() == 3
        for a, b in zip(t.input if isinstance(inp, list) else [t.input],
                        j.input if isinstance(inp, list) else [j.input]):
            assert np.array_equal(a, b)
        assert np.array_equal(t.target, j.target)
    ds = DataSet.array(list(range(5)))
    assert isinstance(ds, LocalDataSet) and ds.shuffle() is None
    assert SamplingParams.greedy() == SamplingParams()
    assert SamplingParams.greedy().is_greedy and JS.greedy().is_greedy


@pytest.mark.parametrize("name,args", [
    ("load_caffe_model", ("a.prototxt",)),
    ("load_tf", ("g.pb", ["in"], ["out"]))])
def test_queued_loaders_name_their_queue(name, args):
    from bigdl_tpu_torch.nn.module import AbstractModule

    with pytest.raises(NotImplementedError, match="A.7 group 5"):
        getattr(AbstractModule, name)(*args)
