"""The port's ResNet path against the JAX package on the CPU: each new
layer against its JAX ``apply``; ``Graph`` and ``FusedGraph`` on a
two-block bottleneck graph (the twin of ``tests/test_tpu_fusion.py::
tiny_bottleneck``) — forward in training and evaluate mode, gradients,
BatchNorm running statistics; the ResNet-50 params and state trees; and
``make_train_step`` SGD steps. The JAX params and state trees are carried
into the port with ``load_jax_tree``; inputs are numpy-seeded.

Tolerances, f32 on both sides (sums in other orders): layer outputs and
running statistics 2e-5 relative to the tensor's largest magnitude
(1e-5 absolute for the running buffers); whole-graph outputs 1e-4 and
gradients 1e-3 relative per tensor (the errors of 20+ layers compound,
and a BN divides by a batch variance of 2 × 8 × 8 values); three SGD
steps: losses 1e-5 relative, parameters 1e-5 absolute. bf16 compute:
one step, loss 2e-2 relative; the updates are held to the f32 update:
the port's bf16 updates may stray from it no more than 1.5x as far as
JAX's bf16 updates do (BN's training backward in bf16 subtracts nearly
equal terms at this tiny batch, up to ~15% per tensor in JAX itself, and
the two frameworks round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import resnet as jres
from bigdl_tpu.nn import Graph as JGraph, Input as JInput, Linear as JLinear
from bigdl_tpu.nn import Reshape as JReshape, ReLU as JReLU
from bigdl_tpu.nn import SpatialAveragePooling as JAvg
from bigdl_tpu.nn.tpu_fusion import FusedGraph as JFused
from bigdl_tpu.utils.random_gen import RNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.resnet import ResNet, _Builder
from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph, maybe_fuse
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves


def _close(got, want, rtol=2e-5, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: relative error {err} > {rtol}"


def _np(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


# ------------------------------------------------------------------ layers


def _layer_pair(jm, tm, seed=0):
    """Give the port layer the JAX layer's freshly initialized params."""
    jp = jm.init_params(jax.random.PRNGKey(seed))
    load_jax_tree(tm, jax.device_get(jp))
    return jp


@pytest.mark.parametrize("cfg", [
    dict(n_in=4, n_out=6, k=3, stride=2, pad=1, group=1, bias=True),
    dict(n_in=4, n_out=6, k=3, stride=2, pad=-1, group=1, bias=False),
    dict(n_in=4, n_out=6, k=1, stride=1, pad=0, group=2, bias=True),
])
def test_spatial_convolution_matches_jax(cfg):
    from bigdl_tpu.nn import SpatialConvolution as JConv

    args = (cfg["n_in"], cfg["n_out"], cfg["k"], cfg["k"], cfg["stride"],
            cfg["stride"], cfg["pad"], cfg["pad"], cfg["group"])
    jm = JConv(*args, with_bias=cfg["bias"])
    tm = tnn.SpatialConvolution(*args, with_bias=cfg["bias"], device="cpu")
    jp = _layer_pair(jm, tm)
    for shape in ((2, 4, 9, 7), (4, 8, 8)):
        x = _np(1, *shape)
        want, _ = jm.apply(jp, jnp.asarray(x))
        _close(tm(torch.from_numpy(x)), want, what=str(shape))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 5), (4, 5, 3, 3)])
def test_batch_normalization_train_and_eval_match_jax(shape, dtype):
    from bigdl_tpu.nn import BatchNormalization as JBN

    jm, tm = JBN(5), tnn.BatchNormalization(5, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    jp = {"weight": jnp.asarray(_np(2, 5, scale=0.5, shift=1.0)),
          "bias": jnp.asarray(_np(3, 5, scale=0.3))}
    load_jax_tree(tm, jax.device_get(jp))
    x = _np(4, *shape, scale=3.0, shift=2.0)
    jx = jnp.asarray(x) if dtype == "f32" else jnp.asarray(x).astype(
        jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype == "f32" else torch.from_numpy(
        x).to(torch.bfloat16)
    if dtype == "bf16":  # the params as the bf16 train step hands them over
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
        tm.weight.data = tm.weight.data.to(torch.bfloat16)
        tm.bias.data = tm.bias.data.to(torch.bfloat16)
    rtol = 2e-5 if dtype == "f32" else 2 ** -7
    state = jm.init_state()
    for step in range(2):
        want, state = jm.apply(jp, jx, state, training=True)
        got = tm.train()(tx)
        assert got.dtype == tx.dtype
        _close(got.float(), np.asarray(want.astype(jnp.float32)), rtol,
               f"train step {step}")
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(tm, key).numpy(),
                                       np.asarray(state[key]), atol=1e-5,
                                       rtol=2e-5, err_msg=key)
    want, _ = jm.apply(jp, jx, state, training=False)
    _close(tm.evaluate()(tx).float(), np.asarray(want.astype(jnp.float32)),
           rtol, "eval")


def test_pooling_reshape_caddtable_match_jax():
    from bigdl_tpu.nn import CAddTable as JAdd
    from bigdl_tpu.nn import SpatialMaxPooling as JMax

    x = _np(5, 2, 3, 9, 7)
    cases = [
        (JMax(3, 3, 2, 2, 1, 1), tnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1)),
        (JMax(3, 3, 2, 2).ceil(), tnn.SpatialMaxPooling(3, 3, 2, 2).ceil()),
        (JAvg(3, 3, 2, 2, 1, 1, count_include_pad=False),
         tnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                   count_include_pad=False)),
        (JAvg(2, 2, 2, 2, ceil_mode=True, divide=False),
         tnn.SpatialAveragePooling(2, 2, 2, 2, ceil_mode=True, divide=False)),
        (JAvg(1, 1, global_pooling=True),
         tnn.SpatialAveragePooling(1, 1, global_pooling=True)),
        (JReshape([3 * 9 * 7], batch_mode=True),
         tnn.Reshape([3 * 9 * 7], batch_mode=True)),
        (JReshape([2, 189]), tnn.Reshape([2, 189])),
    ]
    for jm, tm in cases:
        want, _ = jm.apply({}, jnp.asarray(x))
        _close(tm(torch.from_numpy(x)), want, what=type(tm).__name__)
    y = _np(6, 2, 3, 9, 7)
    want, _ = JAdd().apply({}, [jnp.asarray(x), jnp.asarray(y)])
    _close(tnn.CAddTable()([torch.from_numpy(x), torch.from_numpy(y)]), want)


# ------------------------------------------------------ graphs and fusion


def _jax_tiny(planes):
    """tests/test_tpu_fusion.py::tiny_bottleneck."""
    inp = JInput()
    x = jres._conv(3, 2 * planes, 3, 1, 1).inputs(inp)
    x = jres._bn(2 * planes).inputs(x)
    x = JReLU(True).inputs(x)
    n_in = 2 * planes
    x, n_in = jres._residual(x, n_in, planes, 1, jres._bottleneck_block, "B",
                             True)
    x, n_in = jres._residual(x, n_in, 2 * planes, 2, jres._bottleneck_block,
                             "B", True)
    x = JAvg(4, 4, 1, 1).inputs(x)
    x = JReshape([n_in], batch_mode=True).inputs(x)
    return JGraph(inp, JLinear(n_in, 10).inputs(x))


def _port_tiny(planes):
    b = _Builder("cpu", torch.Generator().manual_seed(0))
    inp = tnn.Input()
    x = b.conv(3, 2 * planes, 3, 1, 1).inputs(inp)
    x = b.bn(2 * planes).inputs(x)
    x = tnn.ReLU(True).inputs(x)
    n_in = 2 * planes
    x, n_in = b.residual(x, n_in, planes, 1, b.bottleneck_block, "B", True)
    x, n_in = b.residual(x, n_in, 2 * planes, 2, b.bottleneck_block, "B",
                         True)
    x = tnn.SpatialAveragePooling(4, 4, 1, 1).inputs(x)
    x = tnn.Reshape([n_in], batch_mode=True).inputs(x)
    return tnn.Graph(inp, tnn.Linear(n_in, 10, device="cpu").inputs(x))


def _tiny_pair(planes, seed=3):
    """(JAX graph, port graph) with the same weights. Every 1-D parameter
    (BN gamma/beta, the head's bias) is perturbed from its init, so the
    zero-gamma BNs pass signal and gradients."""
    RNG.set_seed(seed)
    jg = _jax_tiny(planes)
    jg._ensure_params()
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return jnp.asarray(a)
        return jnp.asarray(a + rng.standard_normal(a.shape).astype(
            np.float32) * 0.4)

    jg.params = jax.tree_util.tree_map(perturb, jg.params)
    tg = _port_tiny(planes)
    load_jax_tree(tg, jax.device_get(jg.params), jax.device_get(jg.state))
    return jg, tg


def _kernel_edges(fused, min_c):
    """Fused edges whose BN has at least ``min_c`` channels."""
    return sum(e.bn.module.n_output >= min_c for e in fused._edges.values())


def _x(seed=0, batch=2, hw=8):
    return _np(seed, batch, 3, hw, hw)


def _buffers(model):
    return {k: v.detach().clone() for k, v in model.named_buffers()}


@pytest.mark.parametrize("planes", [8, 128])
def test_graph_and_fused_graph_match_jax(planes, monkeypatch):
    """Training forward, running statistics and gradients of the Graph and
    of FusedGraph with every edge on the kernel route (threshold 8), and
    the evaluate-mode forward after one training step. At planes 128 only
    the FusedGraph (the Graph's layers are the same as at planes 8)."""
    monkeypatch.setenv("BIGDL_PALLAS_MIN_C", "8")
    jg, tg = _tiny_pair(planes)
    jf, tf = JFused(jg), FusedGraph(tg)
    assert len(jf._edges) == len(tf._edges) == 4
    assert _kernel_edges(tf, 8) == 4
    x = _x()
    tgt = _np(1, 2, 10)
    state0 = _buffers(tg)

    def jloss(p, model):
        out, st = model.apply(p, jnp.asarray(x), jg.state, training=True)
        return jnp.mean((out - jnp.asarray(tgt)) ** 2), (out, st)

    pairs = ((jg, tg), (jf, tf)) if planes == 8 else ((jf, tf),)
    for jm, tm in pairs:
        name = type(tm).__name__
        (_, (jout, jstate)), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, jm), has_aux=True))(jg.params)
        for k, v in tg.named_buffers():
            v.data.copy_(state0[k])
        tm.train()
        out = tm(torch.from_numpy(x))
        _close(out, jout, 1e-4, f"{name} forward")
        want_state = named_leaves(tm, jax.device_get(jstate), "buffers")
        for k, v in tm.named_buffers():
            np.testing.assert_allclose(v.numpy(), want_state[k], atol=1e-5,
                                       rtol=2e-5, err_msg=f"{name} {k}")
        loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
        params = dict(tm.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        want = named_leaves(tm, jax.device_get(jgrads))
        for (k, _), g in zip(params.items(), grads):
            _close(g, want[k], 1e-3, f"{name} grad {k}")
    # evaluate mode reads the running statistics the step left
    jout, _ = jf.apply(jg.params, jnp.asarray(x), jstate, training=False)
    _close(tf.evaluate()(torch.from_numpy(x)), jout, 1e-4, "eval")


def test_fused_graph_shares_the_graph_tree_and_passes_through():
    _, tg = _tiny_pair(8)
    tf = maybe_fuse(tg)
    assert isinstance(tf, FusedGraph)
    assert [p for _, p in tg.named_parameters()] == \
        [p for _, p in tf.named_parameters()]
    assert [b for _, b in tg.named_buffers()] == \
        [b for _, b in tf.named_buffers()]
    cifar = ResNet(10, {"depth": 20, "shortcutType": "A",
                        "dataSet": "cifar10"}, device="cpu")
    assert maybe_fuse(cifar) is cifar      # basic blocks: no 1×1 convs
    out = cifar.train()(torch.from_numpy(_np(2, 2, 3, 32, 32)))
    assert tuple(out.shape) == (2, 10)


def test_fused_graph_keeps_its_edges_through_copy_and_load(monkeypatch,
                                                          tmp_path):
    """A deep copy or a ``Module.load`` (a checkpoint's ``model`` file)
    gives every graph node a new id; the plan, keyed by node ids, is
    rebuilt, so the copy still runs its 4 kernel edges (threshold 8) and
    gives the original's output bitwise."""
    import copy

    from bigdl_tpu_torch.nn import tpu_fusion as tfu
    from bigdl_tpu_torch.nn.module import AbstractModule

    monkeypatch.setenv("BIGDL_PALLAS_MIN_C", "8")
    calls = []
    real = tfu.bn_relu_conv1x1

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tfu, "bn_relu_conv1x1", counted)
    f = maybe_fuse(_tiny_pair(8)[1]).evaluate()
    f.save(str(tmp_path / "m"))
    x = torch.from_numpy(_x(4))
    want = f(x)
    for other in (copy.deepcopy(f),
                  AbstractModule.load(str(tmp_path / "m"), device="cpu")):
        assert set(other._edges) <= {id(p) for p in other._pnodes}
        assert len(other._edges) == len(f._edges)
        calls.clear()
        assert torch.equal(other.evaluate()(x), want)
        assert len(calls) == 4


def test_resnet50_trees_load_from_jax_and_fuse_28_edges(monkeypatch):
    """No full-size forward: the port's ResNet-50 takes the JAX model's
    params and state trees leaf for leaf, and FusedGraph finds the 31
    fused edges, 28 of them at C >= 128."""
    monkeypatch.setenv("BIGDL_PALLAS_MIN_C", "128")
    RNG.set_seed(0)
    jm = jres.ResNet(1000, {"depth": 50, "shortcutType": "B"})
    jm._ensure_params()
    tm = ResNet(1000, {"depth": 50, "shortcutType": "B"}, device="cpu")
    params = jax.device_get(jm.params)
    state = jax.device_get(jm.state)
    assert len(named_leaves(tm, params)) == len(list(tm.parameters())) == 161
    assert len(named_leaves(tm, state, "buffers")) == 106
    tf = maybe_fuse(tm)
    load_jax_tree(tf, params, state)
    assert sum(p.numel() for p in tf.parameters()) == 25_557_032
    some = list(tf.named_parameters())[5]
    np.testing.assert_array_equal(
        some[1].detach().numpy(), named_leaves(tf, params)[some[0]])
    assert len(tf._edges) == len(JFused(jm)._edges) == 31
    assert _kernel_edges(tf, 128) == 28


def _train_pair(compute, planes=8, steps=3, monkeypatch=None):
    from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JCE
    from bigdl_tpu.optim.optim_method import SGD as JSGD
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    jg, tg = _tiny_pair(planes, seed=7)
    jf, tf = JFused(jg), FusedGraph(tg)
    sgd = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    jdt = None if compute == "fp32" else jnp.bfloat16
    jstep = jax.jit(jmake(jf, JCE(), JSGD(**sgd), compute_dtype=jdt))
    tstep = make_train_step(tf, CrossEntropyCriterion(), SGD(**sgd),
                            compute_dtype=compute)
    jp, jst = jg.params, jg.state
    js = JSGD(**sgd).init_state(jp)
    tp = {k: p.detach().clone() for k, p in tf.named_parameters()}
    tst = _buffers(tf)
    ts = SGD(**sgd).init_state(tp)
    p0 = {k: v.clone() for k, v in tp.items()}
    jl, tl = [], []
    for i in range(steps):
        x = _x(10 + i)
        y = np.random.default_rng(i).integers(1, 11, size=2).astype(np.int32)
        jp, js, jst, loss = jstep(jp, js, jst, jax.random.PRNGKey(0),
                                  jnp.asarray(x), jnp.asarray(y))
        jl.append(float(loss))
        tp, ts, tst, tloss = tstep(tp, ts, tst, None, torch.from_numpy(x),
                                   torch.from_numpy(y))
        tl.append(float(tloss))
    return tf, p0, (jl, jp, jst), (tl, tp, tst)


def test_three_f32_sgd_steps_of_the_fused_graph_match_jax(monkeypatch):
    monkeypatch.setenv("BIGDL_PALLAS_MIN_C", "8")
    tf, _, (jl, jp, jst), (tl, tp, tst) = _train_pair("fp32")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = named_leaves(tf, jax.device_get(jp))
    assert set(want) == set(tp)
    for k, w in want.items():
        np.testing.assert_allclose(tp[k].numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=k)
    want = named_leaves(tf, jax.device_get(jst), "buffers")
    assert set(want) == set(tst)
    for k, w in want.items():
        np.testing.assert_allclose(tst[k].numpy(), w, atol=1e-5, rtol=2e-5,
                                   err_msg=k)


def test_one_bf16_sgd_step_of_the_fused_graph_matches_jax(monkeypatch):
    """bf16 compute moves the port's update off the f32 update no more
    than it moves JAX's: over all parameters, the largest and the mean
    relative distance of the port's bf16 update from JAX's f32 update are
    within 1.5x JAX's own bf16-to-f32 distances."""
    monkeypatch.setenv("BIGDL_PALLAS_MIN_C", "8")
    tf, p0, (jl, jp, _), (tl, tp, tst) = _train_pair("bf16", steps=1)
    _, _, (_, jp32, _), _ = _train_pair("fp32", steps=1)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    want = named_leaves(tf, jax.device_get(jp))
    want32 = named_leaves(tf, jax.device_get(jp32))

    def rel(a, b):
        return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)

    port, ref = [], []
    for k, w in want.items():
        assert tp[k].dtype == torch.float32
        start = p0[k].numpy()
        exact = want32[k] - start
        port.append(rel(tp[k].numpy() - start, exact))
        ref.append(rel(w - start, exact))
    assert max(port) <= 1.5 * max(ref), (max(port), max(ref))
    assert np.mean(port) <= 1.5 * np.mean(ref), (np.mean(port), np.mean(ref))
    assert all(t.dtype == torch.float32 for t in tst.values())
