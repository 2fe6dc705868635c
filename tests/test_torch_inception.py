"""Inception (``bigdl_tpu_torch/models/inception.py``) and the table
layers it needs against the JAX package on the CPU:

* ``Concat``, ``ConcatTable``, ``FlattenTable``, ``Select``,
  ``SpatialCrossMapLRN`` (window 5, and 4, where ``F.local_response_norm``
  would pad otherwise) and ``ParallelCriterion``: forward and gradient;
* one ``Inception_Layer_v1`` and one ``Inception_Layer_v2`` block at
  narrow widths: forwards and three SGD steps;
* ``Inception_v1_NoAuxClassifier``, ``Inception_v1`` (the table of three
  heads) and ``Inception_v2``: layer names and one eval forward at batch
  1, 224², the JAX reference's trees drawn with numpy (``numpy_trees``)
  and its forward jitted, once per model;
* ``Inception_v1``'s train step through ``ParallelCriterion``, and
  ``train_main`` (SGD with ``Poly(0.5, 62000)``) at two iterations, and
  its ``-f`` branch's samples (bitwise JAX's ``image_folder_samples``).

Tolerances, with their reasons:

* table layers and LRN: 1e-6 relative to the largest magnitude (a few f32
  operations; the LRN's window sum in another order);
* blocks: 1e-5 relative (f32, two or three convolutions summed in other
  orders); each SGD step's parameter updates within 1e-4 of their
  layer's largest update and the losses within 1e-5 relative;
* whole networks: 1e-4 relative to each head's largest log-probability
  magnitude (f32, 57-69 convolutions and two LRNs, batch statistics in
  v2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import inception as jinc
from bigdl_tpu_torch.models import inception as tinc
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
from tests.torch_parity import numpy_trees, one_torch_thread  # noqa: F401


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _vjp_pair(jfn, tfn, x, seed):
    """(forward, input gradient) of the JAX and the port function under
    one random cotangent per output."""
    jout, jvjp = jax.vjp(jfn, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tfn(xt)
    jouts = jout if isinstance(jout, list) else [jout]
    touts = tout if isinstance(tout, list) else [tout]
    rng = np.random.default_rng(seed)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in jouts]
    (jg,) = jvjp([jnp.asarray(c) for c in cots] if isinstance(jout, list)
                 else jnp.asarray(cots[0]))
    (tg,) = torch.autograd.grad(touts, xt, [torch.from_numpy(c)
                                            for c in cots])
    return jouts, touts, np.asarray(jg), tg


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- table layers, LRN, ParallelCriterion -------------------------------------

def _pair_of(jmod, tmod):
    jmod._ensure_params()
    return load_jax_tree(tmod, jax.device_get(jmod.params))


@pytest.mark.parametrize("kind", ["Concat", "ConcatTable"])
def test_concat_and_concat_table_match_jax(kind):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch import nn as tnn

    RNG.set_seed(5)
    make = {"Concat": lambda n: n.Concat(2), "ConcatTable": lambda n:
            n.ConcatTable()}[kind]
    jm, tm = make(jnn), make(tnn)
    for n_out in (3, 5):
        jm.add(jnn.SpatialConvolution(4, n_out, 1, 1))
        tm.add(tnn.SpatialConvolution(4, n_out, 1, 1, device="cpu"))
    jm.add(jnn.Identity())
    tm.add(tnn.Identity())
    _pair_of(jm, tm)
    assert [k.split(":")[0] for k in jm.params] == ["0", "1", "2"]
    x = _x((2, 4, 3, 3))
    jouts, touts, jg, tg = _vjp_pair(
        lambda v: jm.apply(jm.params, v)[0], tm, x, 6)
    if kind == "Concat":
        assert touts[0].shape == (2, 12, 3, 3)
    assert len(touts) == len(jouts)
    for a, b in zip(touts, jouts):
        assert _rel(a, b) <= 1e-6
    assert _rel(tg, jg) <= 1e-6


def test_flatten_table_and_select_match_jax():
    from bigdl_tpu.nn import FlattenTable as JFlat, Select as JSelect
    from bigdl_tpu_torch.nn import FlattenTable, Select

    a, b, c = (torch.from_numpy(_x((2, 3), s)) for s in (1, 2, 3))
    nested = [[a, [b]], c]
    got = FlattenTable()(nested)
    want, _ = JFlat().apply({}, [[a.numpy(), [b.numpy()]], c.numpy()])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    x = _x((2, 5, 4))
    for dim, index in ((2, -1), (1, 2), (-1, 1), (3, -2), (2, 3)):
        jouts, touts, jg, tg = _vjp_pair(
            lambda v: JSelect(dim, index).apply({}, v)[0],
            Select(dim, index), x, 7)
        np.testing.assert_array_equal(touts[0].detach().numpy(),
                                      np.asarray(jouts[0]))
        np.testing.assert_array_equal(tg.numpy(), jg)


@pytest.mark.parametrize("size", [5, 4, 3])
@pytest.mark.parametrize("batched", [True, False])
def test_cross_map_lrn_matches_jax(size, batched):
    from bigdl_tpu.nn import SpatialCrossMapLRN as JLRN
    from bigdl_tpu_torch.nn import SpatialCrossMapLRN

    x = _x((2, 7, 5, 6) if batched else (7, 5, 6)) * 3.0
    args = (size, 0.5, 0.75, 2.0)
    jouts, touts, jg, tg = _vjp_pair(
        lambda v: JLRN(*args).apply({}, v)[0], SpatialCrossMapLRN(*args),
        x, 8)
    assert _rel(touts[0], jouts[0]) <= 1e-6
    assert _rel(tg, jg) <= 1e-6


@pytest.mark.parametrize("repeat", [True, False])
def test_parallel_criterion_matches_jax(repeat):
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.nn import ParallelCriterion as JPC
    from bigdl_tpu_torch.nn import ClassNLLCriterion, ParallelCriterion

    logp = [torch.log_softmax(torch.from_numpy(_x((4, 6), s)), -1)
            for s in (1, 2, 3)]
    target = np.array([1, 6, 3, 2], np.float32)
    targets = target if repeat else [target, target[::-1].copy(),
                                     np.array([2, 2, 5, 1], np.float32)]
    jc = JPC(repeat_target=repeat)
    tc = ParallelCriterion(repeat_target=repeat)
    for w in (1.0, 0.3, 0.3):
        jc.add(JNLL(), w)
        tc.add(ClassNLLCriterion(), w)
    xs = [v.detach().numpy() for v in logp]
    want = float(jc.forward([jnp.asarray(v) for v in xs], targets))
    assert tc.forward(xs, targets) == pytest.approx(want, rel=1e-6)
    jg = jc.backward([jnp.asarray(v) for v in xs], targets)
    tg = tc.backward(xs, targets)
    assert len(tg) == len(jg) == 3
    for g, w in zip(tg, jg):
        assert _rel(g, w) <= 1e-6


# -- single blocks -------------------------------------------------------------

_BLOCKS = {
    "v1": (lambda m, **kw: m.Inception_Layer_v1(
        12, [[4], [4, 6], [2, 3], [5]], "inception_x/", **kw), 18),
    "v2": (lambda m, **kw: m.Inception_Layer_v2(
        12, [[4], [4, 6], [3, 5], ["avg", 5]], "inception_x/", **kw), 20),
    "v2_reduce": (lambda m, **kw: m.Inception_Layer_v2(
        12, [[0], [4, 6], [3, 5], ["max", 0]], "inception_x/", **kw), 23),
}


@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_single_block_forwards_and_three_sgd_steps_match_jax(name):
    from bigdl_tpu.nn import Reshape as JReshape, Sequential as JSeq
    from bigdl_tpu.nn import LogSoftMax as JLSM
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import (
        ClassNLLCriterion, LogSoftMax, Reshape, Sequential,
    )
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    build, out_c = _BLOCKS[name]
    side = 4 if name == "v2_reduce" else 8
    # the block, then its flattened output as the classifier's log-probs
    jm = JSeq().add(build(jinc)).add(JReshape([out_c * side * side],
                                              batch_mode=True)).add(JLSM())
    tm = Sequential().add(build(tinc, device="cpu")).add(
        Reshape([out_c * side * side], batch_mode=True)).add(LogSoftMax())
    params, state = numpy_trees(jm, 9)
    load_jax_tree(tm, params, state)
    x = _x((2, 12, 8, 8))
    for training in (True, False):
        load_jax_tree(tm, params, state)
        want, _ = jm.apply(params, jnp.asarray(x), state, training=training)
        with torch.no_grad():
            got = (tm.train() if training else tm.eval())(torch.from_numpy(x))
        assert _rel(got, want) <= 1e-5, training
    load_jax_tree(tm, params, state)
    jstep = jax.jit(jmake(jm, JNLL(), JSGD(0.05, momentum=0.9)))
    method = SGD(0.05, momentum=0.9)
    tstep = make_train_step(tm.train(), ClassNLLCriterion(), method)
    jp, js, jopt = params, state, JSGD(0.05, momentum=0.9).init_state(params)
    tp = {k: p.detach().clone() for k, p in tm.named_parameters()}
    ts = {k: b.detach().clone() for k, b in tm.named_buffers()}
    topt = method.init_state(tp)
    y = np.array([3, 77], np.float32)
    for i in range(3):
        xi = _x((2, 12, 8, 8), 30 + i)
        before = {k: v.clone() for k, v in tp.items()}
        was = named_leaves(tm, jax.device_get(jp))
        jp, jopt, js, jloss = jstep(jp, jopt, js, jax.random.PRNGKey(0),
                                    jnp.asarray(xi), jnp.asarray(y))
        tp, topt, ts, tloss = tstep(tp, topt, ts, None, torch.from_numpy(xi),
                                    torch.from_numpy(y))
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
        now = named_leaves(tm, jax.device_get(jp))
        scale = {}
        for k in now:
            layer = k.rsplit(".", 1)[0]
            scale[layer] = max(scale.get(layer, 0.0),
                               float(np.abs(now[k] - was[k]).max()))
        for k in now:
            d = (tp[k] - before[k]).numpy() - (now[k] - was[k])
            err = float(np.abs(d).max()) / scale[k.rsplit(".", 1)[0]]
            assert err <= 1e-4, (i, k, err)


# -- whole networks ----------------------------------------------------------

_NETS = {
    "Inception_v1_NoAuxClassifier": dict(class_num=1000),
    "Inception_v1": dict(class_num=1000),
    "Inception_v2": dict(class_num=1000),
}


@pytest.fixture(scope="module")
def nets():
    """name → (JAX model, numpy trees, jitted eval forward), built once."""
    out = {}
    for seed, (name, kw) in enumerate(sorted(_NETS.items())):
        jm = getattr(jinc, name)(**kw)
        params, state = numpy_trees(jm, 40 + seed)
        fwd = jax.jit(lambda p, s, x, jm=jm: jm.apply(p, x, s)[0])
        out[name] = (jm, params, state, fwd)
    return out


def _named(tree):
    """The set_name'd layer names in a JAX tree (auto names hold the
    class name and a process counter)."""
    out = set()
    for k, v in tree.items():
        if ":" not in k:
            continue
        if "/" in k.split(":", 1)[1]:
            out.add(k.split(":", 1)[1])
        if isinstance(v, dict):
            out |= _named(v)
    return out


@pytest.mark.parametrize("name", sorted(_NETS))
def test_network_names_inits_and_eval_forward_match_jax(nets, name):
    from bigdl_tpu_torch.nn import Linear, SpatialConvolution, Xavier, Zeros

    jm, params, state, fwd = nets[name]
    tm = getattr(tinc, name)(device="cpu", **_NETS[name])
    load_jax_tree(tm, params, state)
    port_names = {k.split(":", 1)[1] for k, _ in tm.named_modules()
                  if ":" in k.rsplit(".", 1)[-1]} | {
        m.name for m in tm.modules()}
    assert _named(params) <= port_names
    assert _named(params) >= {"conv1/7x7_s2", "loss3/classifier"}
    for m in tm.modules():
        if isinstance(m, SpatialConvolution):
            assert isinstance(m.weight_init, Xavier)
            assert isinstance(m.bias_init, Zeros)
        if isinstance(m, Linear):
            assert "/" in m.name
    x = _x((1, 3, 224, 224), 11)
    want = fwd(params, state, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    assert len(gots) == len(wants) == (3 if name == "Inception_v1" else 1)
    for g, w in zip(gots, wants):
        assert g.shape == (1, 1000)
        assert _rel(g, w) <= 1e-4, name


def test_inception_v1_trains_three_heads_through_parallel_criterion():
    """One step of the port's train step on ``Inception_v1``'s table
    output: the loss is the criterion's weighted sum of the heads' NLL on
    the forward of the same weights (Dropout inactive: no generator)."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion, ParallelCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    tm = tinc.Inception_v1(1000, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    crit = ParallelCriterion(repeat_target=True)
    for w in (1.0, 0.3, 0.3):
        crit.add(ClassNLLCriterion(), w)
    x = torch.from_numpy(_x((2, 3, 224, 224), 12))
    y = torch.tensor([5.0, 900.0])
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    state = {k: b.detach().clone() for k, b in tm.named_buffers()}
    with torch.no_grad():
        heads = tm.train()(x)
    want = sum(w * float(ClassNLLCriterion().apply(h, y))
               for w, h in zip((1.0, 0.3, 0.3), heads))
    method = SGD(0.01)
    step = make_train_step(tm, crit, method)
    new, _, _, loss = step(params, method.init_state(params), state, None,
                           x, y)
    assert float(loss) == pytest.approx(want, rel=1e-6)
    moved = [k for k in params if not torch.equal(new[k], tm.state_dict()[k])]
    assert any(k.startswith("0:") for k in moved)      # the trunk
    assert any("loss1" in k for k in moved)            # an auxiliary head


def test_train_main_trains_noaux_with_poly_sgd(monkeypatch, tmp_path):
    from bigdl_tpu_torch.models import utils as tutils

    seen = {}
    run = tutils.run_training

    def spy(model, samples, criterion, args, optim_method=None):
        seen.update(model=model, method=optim_method, n=len(samples),
                    samples=samples)
        return run(model, samples, criterion, args, optim_method)

    monkeypatch.setattr(tutils, "run_training", spy)
    model = tinc.train_main(["--synthetic", "4", "-b", "2", "--maxIteration",
                             "2", "--device", "cpu"])
    assert model is seen["model"] and seen["n"] == 4
    assert all(torch.isfinite(p).all() for p in model.parameters())
    sched = seen["method"].learning_rate_schedule
    assert type(sched).__name__ == "Poly"
    assert (sched.power, sched.max_iteration) == (0.5, 62000)
    assert sum(p.numel() for p in model.parameters()) == 6998552
    # -f: the image folder at 224², JAX's samples (PNG: bitwise PIL's)
    from PIL import Image

    from bigdl_tpu.dataset.image import image_folder_samples

    rng = np.random.RandomState(1)
    for c in ("a", "b"):
        (tmp_path / c).mkdir()
        Image.fromarray(rng.randint(0, 256, (31, 45, 3)).astype(
            np.uint8)).save(tmp_path / c / "0.png")
    model = tinc.train_main(["-f", str(tmp_path), "-b", "2",
                             "--maxIteration", "1", "--device", "cpu"])
    assert seen["n"] == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())
    want = image_folder_samples(str(tmp_path), image_size=224)
    for a, b in zip(seen["samples"], want):
        np.testing.assert_array_equal(a.feature(), b.feature())
        np.testing.assert_array_equal(a.label(), b.label())
