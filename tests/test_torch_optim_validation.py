"""SGD's learning-rate schedules, the per-layer regularizers, the new
triggers, the validation methods, ``Evaluator``/``Predictor`` and
``Optimizer.set_validation`` of the port against the JAX package on the
CPU, on numpy-seeded inputs.

Tolerances, with their reasons:

* learning rates: exactly equal at f32 over 300 steps (the port repeats
  the JAX schedule's f32 operations one by one; JAX is run op by op, as
  its schedule runs outside ``jit``);
* one regularized train step: parameters within 1e-6 absolute (f32, the
  forward and backward summed in other orders, lr 0.1);
* accuracies and trigger firings: exactly equal; losses and outputs
  within 1e-6 relative / 1e-5 absolute (f32 reductions in other orders).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.torch_parity import one_torch_thread  # noqa: F401

# --------------------------------------------------------------- schedules


def _schedules(m):
    """name → schedule built from module ``m`` (JAX's or the port's)."""
    seq = m.SequentialSchedule(50)
    seq.add(m.Warmup(0.0007), 20).add(m.Step(50, 0.5), 100).add(
        m.Poly(1.0, 200), 200)
    return {"default": m.Default(0.05), "step": m.Step(30, 0.5),
            "multistep": m.MultiStep([50, 120, 200], 0.3),
            "exponential": m.Exponential(40, 0.96),
            "exponential_stair": m.Exponential(40, 0.96, stair_case=True),
            "poly": m.Poly(0.5, 250), "poly_square": m.Poly(2.0, 310),
            "warmup": m.Warmup(0.001, 100), "sequential": seq}


@pytest.mark.parametrize("name", [
    "default", "step", "multistep", "exponential", "exponential_stair",
    "poly", "poly_square", "warmup", "sequential"])
def test_schedule_rates_equal_jax_at_f32(name):
    from bigdl_tpu.optim import optim_method as jom
    from bigdl_tpu_torch.optim import optim_method as tom

    js, ts = _schedules(jom)[name], _schedules(tom)[name]
    for base in (0.05, 0.1):
        want = [np.float32(js.lr(base, jnp.int32(i))) for i in range(300)]
        got = [np.float32(ts.lr(base, i)) for i in range(300)]
        assert got == want, next(i for i, (a, b) in enumerate(zip(got, want))
                                 if a != b)


def test_plateau_rates_equal_jax_under_scripted_scores():
    from bigdl_tpu.optim.optim_method import Plateau as JPlateau
    from bigdl_tpu_torch.optim.optim_method import Plateau

    scores = np.random.default_rng(3).uniform(0, 1, 30).round(3)
    scores[10:] = np.minimum.accumulate(scores[10:])[::-1]  # a plateau
    for kw in (dict(mode="max", patience=2, factor=0.5, cooldown=1),
               dict(mode="min", patience=3, factor=0.3, epsilon=0.05,
                    min_lr=0.004)):
        j, t = JPlateau(**kw), Plateau(**kw)
        for step in range(300):
            if step % 10 == 0:
                s = float(scores[step // 10])
                j.record_score(s)
                t.record_score(s)
            assert np.float32(t.lr(0.05, step)) == np.float32(
                j.lr(0.05, jnp.int32(step))), (kw, step)
        assert (t._scale, t._best, t._wait) == (j._scale, j._best, j._wait)
        assert t._scale < 1.0


def test_sgd_with_a_step_schedule_updates_as_jax():
    from bigdl_tpu.optim import optim_method as jom
    from bigdl_tpu_torch.optim import optim_method as tom

    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    jm = jom.SGD(0.2, momentum=0.9, learning_rate_schedule=jom.Step(2, 0.5))
    tm = tom.SGD(0.2, momentum=0.9, learning_rate_schedule=tom.Step(2, 0.5))
    jp, tp = {"w": jnp.asarray(p["w"])}, {"w": torch.from_numpy(p["w"].copy())}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for _ in range(5):
        g = rng.standard_normal((4, 3)).astype(np.float32)
        jp, js = jm.update({"w": jnp.asarray(g)}, js, jp)
        tp, ts = tm.update({"w": torch.from_numpy(g)}, ts, tp)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ regularizers


def _reg_models(kind):
    """(JAX model, port model) with the same weights: a conv and a linear
    layer, both carrying ``kind``'s weight and bias regularizers."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.optim import regularizer as jreg
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.optim import regularizer as treg
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    def regs(r):
        return {"l1": (r.L1Regularizer(0.01), r.L1Regularizer(0.02)),
                "l2": (r.L2Regularizer(0.03), r.L2Regularizer(0.01)),
                "l1l2": (r.L1L2Regularizer(0.01, 0.02),
                         r.L1L2Regularizer(0.005, 0.01))}[kind]

    def build(n, r, **kw):
        (cw, cb), (lw, lb) = regs(r), regs(r)[::-1]
        return (n.Sequential()
                .add(n.SpatialConvolution(2, 3, 3, 3, w_regularizer=cw,
                                          b_regularizer=cb, **kw))
                .add(n.Tanh()).add(n.Reshape([3 * 4 * 4]))
                .add(n.Linear(48, 5, w_regularizer=lw, b_regularizer=lb,
                              **kw))
                .add(n.LogSoftMax()))

    RNG.set_seed(5)
    jm = build(jnn, jreg)
    jm._ensure_params()
    tm = build(tnn, treg, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    return jm, tm


@pytest.mark.parametrize("kind", ["l1", "l2", "l1l2"])
def test_regularized_train_step_matches_jax(kind):
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import (
        make_train_step, module_regularizers,
    )
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jm, tm = _reg_models(kind)
    assert [k for k, _ in module_regularizers(tm)] == [
        k for k, _ in tm.named_parameters()]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 2, 6, 6)).astype(np.float32)
    y = rng.integers(1, 6, size=4).astype(np.float32)
    jp, *_ = jax.jit(jmake(jm, JNLL(), JSGD(0.1)))(
        jm.params, JSGD(0.1).init_state(jm.params), jm.state,
        jax.random.PRNGKey(0), x, y)
    tp = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tp, *_ = make_train_step(tm, ClassNLLCriterion(), SGD(0.1))(
        tp, SGD(0.1).init_state(tp), {}, None, torch.from_numpy(x),
        torch.from_numpy(y))
    # the regularizers moved the weights: without them the step differs
    plain = {k: p.detach().clone() for k, p in tm.named_parameters()}
    for m in tm.modules():
        m.w_regularizer = m.b_regularizer = None
    plain, *_ = make_train_step(tm, ClassNLLCriterion(), SGD(0.1))(
        plain, SGD(0.1).init_state(plain), {}, None, torch.from_numpy(x),
        torch.from_numpy(y))
    moved = 0.0
    for k, w in named_leaves(tm, jax.device_get(jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), w, atol=1e-6, rtol=0,
                                   err_msg=k)
        moved = max(moved, float((tp[k] - plain[k]).abs().max()))
    assert moved > 1e-4


@pytest.fixture(scope="module")
def lenet_l2():
    """(JAX LeNet5, port LeNet5) with the same weights, both convolutions
    and both linear layers carrying an L2 regularizer on weight and bias."""
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu.optim import regularizer as jreg
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.optim import regularizer as treg
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(11)
    jm = JLeNet5(10)
    jm._ensure_params()
    tm = LeNet5(10, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    for mods, reg in ((jm.modules, jreg), (list(tm.children()), treg)):
        for m in mods:
            if type(m).__name__ in ("SpatialConvolution", "Linear"):
                m.w_regularizer = reg.L2Regularizer(0.02)
                m.b_regularizer = reg.L2Regularizer(0.005)
    return jm, tm


@pytest.mark.parametrize("form", ["model", "list"])
def test_regularizer_functions_take_jax_model_form(lenet_l2, form):
    """``apply_module_regularizers`` and ``regularizer_loss`` called as
    JAX calls them, with the model (``bigdl_tpu/optim/train_step.py:94``,
    ``:177``), and with the port's list from ``module_regularizers``:
    the same gradients and penalty as JAX's on LeNet-5 with L2 on every
    conv and linear layer (1e-6 relative: f32 sums in another order)."""
    from bigdl_tpu.optim import train_step as jts
    from bigdl_tpu_torch.optim import train_step as tts
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jm, tm = lenet_l2
    rng = np.random.default_rng(12)
    jgrads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32)), jm.params)
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    grads = {k: torch.from_numpy(np.asarray(v).copy())
             for k, v in named_leaves(tm, jax.device_get(jgrads)).items()}
    target = tm if form == "model" else tts.module_regularizers(tm)
    got = tts.apply_module_regularizers(target, params, grads)
    want = named_leaves(tm, jax.device_get(
        jts.apply_module_regularizers(jm, jm.params, jgrads)))
    assert set(got) == set(want) == set(params)
    moved = 0.0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        moved = max(moved, float((got[k] - grads[k]).abs().max()))
    assert moved > 1e-4                       # the regularizers acted
    loss = float(tts.regularizer_loss(target, params))
    assert loss == pytest.approx(
        float(jts.regularizer_loss(jm, jm.params)), rel=1e-6)
    assert loss > 0


def test_regularizer_terms_match_jax():
    from bigdl_tpu.optim import regularizer as jreg
    from bigdl_tpu_torch.optim import regularizer as treg

    rng = np.random.default_rng(7)
    p = rng.standard_normal((5, 4)).astype(np.float32)
    p[0, 0] = 0.0                               # sign(0) = 0 in both
    g = rng.standard_normal((5, 4)).astype(np.float32)
    for jr, tr in ((jreg.L1Regularizer(0.1), treg.L1Regularizer(0.1)),
                   (jreg.L2Regularizer(0.2), treg.L2Regularizer(0.2)),
                   (jreg.L1L2Regularizer(0.1, 0.2),
                    treg.L1L2Regularizer(0.1, 0.2))):
        np.testing.assert_allclose(
            tr.grad_update(torch.from_numpy(p), torch.from_numpy(g)).numpy(),
            np.asarray(jr.grad_update(jnp.asarray(p), jnp.asarray(g))),
            rtol=1e-6, atol=1e-7)
        assert float(tr.loss_term(torch.from_numpy(p))) == pytest.approx(
            float(jr.loss_term(jnp.asarray(p))), rel=1e-6)


def test_frozen_layers_are_still_refused():
    """Frozen layers are ported: ``make_train_step`` no longer refuses a
    frozen module, and a step under weight decay leaves its weights
    bitwise as they were (``tests/test_torch_freeze.py`` holds the
    training against JAX)."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Linear
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    m = Linear(3, 2, device="cpu").freeze()
    sgd = SGD(0.1, weight_decay=0.1)
    params = {k: p.detach().clone() for k, p in m.named_parameters()}
    before = {k: v.clone() for k, v in params.items()}
    params, _, _, loss = make_train_step(m, ClassNLLCriterion(), sgd)(
        params, sgd.init_state(params), {}, None, torch.randn(4, 3),
        torch.tensor([1.0, 2.0, 1.0, 2.0]))
    assert torch.isfinite(loss)
    for k, v in params.items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------- triggers


def _states():
    """A scripted run: 3 epochs of 4 iterations, with losses and scores."""
    out, neval = [], 1
    rng = np.random.default_rng(8)
    for epoch in (1, 2, 3):
        for it in range(4):
            neval += 1
            last = it == 3
            out.append({"epoch": epoch + (1 if last else 0), "neval": neval,
                        "epoch_finished": last,
                        "loss": float(rng.uniform(0, 2)),
                        "score": None if it < 2 else float(rng.uniform())})
    return out


@pytest.mark.parametrize("make", [
    lambda T: T.every_epoch(), lambda T: T.several_iteration(3),
    lambda T: T.min_loss(0.8), lambda T: T.max_score(0.5),
    lambda T: T.every_epoch().or_(T.several_iteration(5)),
    lambda T: T.max_epoch(2).and_(T.min_loss(1.5))],
    ids=["every_epoch", "several_iteration", "min_loss", "max_score",
         "every_epoch_or", "max_epoch_and_min_loss"])
def test_trigger_firing_sequences_equal_jax(make):
    from bigdl_tpu.optim.trigger import Trigger as JT
    from bigdl_tpu_torch.optim.trigger import Trigger as TT

    j, t = make(JT), make(TT)
    fired_j, fired_t, peeks = [], [], []
    for s in _states():
        peeks.append((t.peek(s), j.peek(s)))   # no side effect on firing
        fired_j.append(j(s))
        fired_t.append(t(s))
        fired_t[-1] = (fired_t[-1], t.peek(s))
        fired_j[-1] = (fired_j[-1], j.peek(s))
    assert fired_t == fired_j
    assert all(a == b for a, b in peeks)
    assert any(f for f, _ in fired_t)


# ---------------------------------------------------------- validation


def _outputs(seed=9, n=37, c=10):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return logp, rng.integers(1, c + 1, size=n).astype(np.float32)


@pytest.mark.parametrize("name", ["top1", "top5", "loss", "loss_ce", "mae"])
def test_validation_methods_equal_jax(name):
    from bigdl_tpu.nn import CrossEntropyCriterion as JCE
    from bigdl_tpu.optim import validation as jv
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import validation as tv

    logp, y = _outputs()
    j, t = {"top1": (jv.Top1Accuracy(), tv.Top1Accuracy()),
            "top5": (jv.Top5Accuracy(), tv.Top5Accuracy()),
            "loss": (jv.Loss(), tv.Loss()),
            "loss_ce": (jv.Loss(JCE()), tv.Loss(CrossEntropyCriterion())),
            "mae": (jv.MAE(), tv.MAE())}[name]
    if name == "mae":
        y = np.random.default_rng(2).standard_normal(logp.shape).astype(
            np.float32)
    halves = (slice(0, 20), slice(20, None))
    jr = [j.apply(jnp.asarray(logp[h]), y[h]) for h in halves]
    tr = [t.apply(torch.from_numpy(logp[h]), y[h]) for h in halves]
    jsum, tsum = jr[0] + jr[1], tr[0] + tr[1]
    assert t.name == j.name
    if name.startswith("top"):
        assert tsum.result() == jsum.result()
        assert repr(tsum) == repr(jsum)
        assert tsum.merge_across_processes() is tsum
    else:
        assert tsum.result()[1] == jsum.result()[1] == 37
        assert tsum.result()[0] == pytest.approx(jsum.result()[0], rel=1e-6)


def _lenet_pair():
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(12)
    jm = JLeNet5(10)
    jm._ensure_params()
    tm = LeNet5(10, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    return jm, tm


def _samples(n=70, seed=10):
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu_torch.dataset import Sample

    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, 1, 28, 28)).astype(np.float32)
    ys = rng.integers(1, 11, size=n).astype(np.float32)
    return ([JSample(x, y) for x, y in zip(xs, ys)],
            [Sample(x, y) for x, y in zip(xs, ys)], xs)


def test_evaluator_and_predictor_equal_jax_with_a_partial_batch():
    """70 samples at batch 32: two full batches and a trailing 6."""
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.optim import validation as jv
    from bigdl_tpu.optim.evaluator import Evaluator as JEvaluator
    from bigdl_tpu.optim.evaluator import Predictor as JPredictor
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import validation as tv
    from bigdl_tpu_torch.optim.evaluator import Evaluator, Predictor

    jm, tm = _lenet_pair()
    js, ts, xs = _samples()
    jres = JEvaluator(jm).test(JDataSet.array(js), [
        jv.Top1Accuracy(), jv.Top5Accuracy(), jv.Loss()], 32)
    for data in (DataSet.array(ts), ts):
        tres = Evaluator(tm).test(data, [
            tv.Top1Accuracy(), tv.Top5Accuracy(), tv.Loss()], 32)
        assert [r.result() for r in tres[:2]] == [r.result()
                                                  for r in jres[:2]]
        assert tres[0].count == 70 and not tm.training
        assert tres[2].result()[0] == pytest.approx(jres[2].result()[0],
                                                    rel=1e-6)
    want = JPredictor(jm).predict(xs, 32)
    got = Predictor(tm).predict(xs, 32)
    assert got.shape == (70, 10)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    top2 = np.sort(np.asarray(want), axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    cls = Predictor(tm).predict_class(ts, 32)
    assert (cls == got.argmax(-1) + 1).all()
    assert (cls[clear] == JPredictor(jm).predict_class(js, 32)[clear]).all()


def test_module_evaluate_and_predict_modes():
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    _, tm = _lenet_pair()
    _, ts, xs = _samples(n=9)
    tm.train()
    got = tm.predict(xs, batch_size=4)
    assert got.shape == (9, 10) and tm.training
    assert (tm.predict_class(xs, 4) == got.argmax(-1) + 1).all()
    (r,) = tm.evaluate(ts, [Top1Accuracy()], batch_size=4)
    assert r.count == 9 and not tm.training
    tm.train()
    assert tm.evaluate() is tm and not tm.training


def _val_run(pkg, dialect, caplog):
    """Train a LeNet 3 epochs with validation each epoch; returns the
    validation log records and the Plateau schedule."""
    if pkg == "jax":
        from bigdl_tpu.nn import ClassNLLCriterion
        from bigdl_tpu.optim import SGD, Optimizer, Trigger
        from bigdl_tpu.optim.optim_method import Plateau
        from bigdl_tpu.optim.validation import Loss, Top1Accuracy
        side = 0
        logger = "bigdl_tpu"
    else:
        from bigdl_tpu_torch.nn import ClassNLLCriterion
        from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
        from bigdl_tpu_torch.optim.optim_method import Plateau
        from bigdl_tpu_torch.optim.validation import Loss, Top1Accuracy
        side = 1
        logger = "bigdl_tpu_torch"
    model = _lenet_pair()[side]
    data, val = _samples(48, 11)[side], _samples(22, 12)[side]
    # score = Top-1: never "improves" by epsilon 10 after the first, so
    # the rate halves at the third validation, the run's last
    sched = Plateau(mode="max", patience=2, factor=0.5, epsilon=10.0)
    opt = Optimizer(model=model, dataset=data, criterion=ClassNLLCriterion(),
                    batch_size=16, end_trigger=Trigger.max_epoch(3))
    opt.set_optim_method(SGD(0.05, learning_rate_schedule=sched))
    methods = [Top1Accuracy(), Loss()]
    if dialect == "scala":
        opt.set_validation(Trigger.every_epoch(), val, methods, 8)
    else:
        opt.set_validation(8, val, Trigger.every_epoch(), methods)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        opt.optimize()
    return [r.getMessage() for r in caplog.records
            if r.name == logger and "validation" in r.getMessage()], sched


@pytest.mark.parametrize("dialect", ["scala", "pyspark"])
def test_set_validation_scores_and_feeds_plateau_like_jax(dialect, caplog):
    jlines, jsched = _val_run("jax", dialect, caplog)
    tlines, tsched = _val_run("torch", dialect, caplog)
    assert len(tlines) == len(jlines) == 6       # 2 methods x 3 epochs
    for t, j in zip(tlines, jlines):
        head_t, head_j = t.split(": ", 1), j.split(": ", 1)
        assert head_t[0] == head_j[0]             # method, epoch, iteration
        if "Top1" in t:
            assert head_t[1] == head_j[1]         # counts include the 6 tail
            assert "count=22" in t
    assert (tsched._scale, tsched._wait) == (jsched._scale, jsched._wait) \
        == (0.5, 0)
    assert tsched._best == jsched._best
