"""The port's training path against the JAX package on the CPU: criteria,
Adam and SGD, ``make_train_step`` and ``Optimizer(...).optimize()``.

Inputs are numpy-seeded and handed to both packages; the LM weights are
carried across with ``load_jax_params`` (tests/torch_parity.py). The
port's flash attention takes its plain version on the CPU; the JAX side
runs its Pallas kernels in interpret mode (``use_flash="always"``).

Tolerances, with their reasons:

* criteria and single optimizer updates: 1e-6 relative / 1e-7 absolute
  (f32 both sides; one reduction order apart);
* three f32 train steps: losses 1e-5 relative, parameters 2e-6 absolute
  (f32 end to end, different summation orders in the matmuls and the
  attention backward, three Adam steps of lr 1e-3 normalising the
  gradients);
* three bf16-compute train steps: losses 2e-2 relative; parameters
  within 6e-3 absolute, and at most 1% of all elements more than 5e-4
  apart (bf16 rounds at other points in the two frameworks —
  the forward's matmul outputs, LayerNorm's and GELU's inputs — so the
  gradients agree to a few bf16 ulps; Adam turns a gradient near zero
  into a step of +-lr = 1e-3 whatever its size, so where the two
  gradients' signs differ a parameter moves up to 2 lr apart per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import make_pair, one_torch_thread  # noqa: F401

V, T, B = 29, 16, 4


def _jnp_tree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


# ------------------------------------------------------------- criteria


def _criteria():
    from bigdl_tpu.nn import criterion as jc
    from bigdl_tpu.nn import criterion_more as jcm
    from bigdl_tpu_torch.nn import criterion as tc
    from bigdl_tpu_torch.nn import criterion_more as tcm

    rng = np.random.default_rng(11)
    logits = rng.standard_normal((4, 6, 7)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(1, 8, size=(4, 6)).astype(np.float32)
    masked = labels.copy()
    masked[:, -2:] = 0.0                     # padding steps
    w = rng.uniform(0.5, 2.0, size=7).astype(np.float32)
    return {
        "class_nll": (jc.ClassNLLCriterion(), tc.ClassNLLCriterion(),
                      logp[:, 0], labels[:, 0]),
        "class_nll_weighted_sum": (
            jc.ClassNLLCriterion(weights=w, size_average=False),
            tc.ClassNLLCriterion(weights=w, size_average=False),
            logp[:, 0], labels[:, 0]),
        "class_nll_probs": (
            jc.ClassNLLCriterion(log_prob_as_input=False),
            tc.ClassNLLCriterion(log_prob_as_input=False),
            np.exp(logp[:, 0]), labels[:, 0]),
        "cross_entropy": (jc.CrossEntropyCriterion(weights=w),
                          tc.CrossEntropyCriterion(weights=w),
                          logits[:, 0], labels[:, 0]),
        "time_distributed": (
            jc.TimeDistributedCriterion(jc.ClassNLLCriterion(), True),
            tc.TimeDistributedCriterion(tc.ClassNLLCriterion(), True),
            logp, labels),
        "time_distributed_mask": (
            jcm.TimeDistributedMaskCriterion(jc.ClassNLLCriterion(), 0),
            tcm.TimeDistributedMaskCriterion(tc.ClassNLLCriterion(), 0),
            logp, masked),
        "masked_softmax_ce": (jcm.MaskedSoftmaxCECriterion(0),
                              tcm.MaskedSoftmaxCECriterion(0),
                              logits, masked),
    }


@pytest.mark.parametrize("name", sorted(_criteria()))
def test_criterion_value_and_input_grad_match_jax(name):
    jcrit, tcrit, x, y = _criteria()[name]
    want = float(jcrit.apply(jnp.asarray(x), jnp.asarray(y)))
    got = tcrit.forward(torch.from_numpy(x), torch.from_numpy(y))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    gwant = np.asarray(jcrit.backward(jnp.asarray(x), jnp.asarray(y)))
    ggot = tcrit.backward(torch.from_numpy(x), y).numpy()
    np.testing.assert_allclose(ggot, gwant, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- optim methods


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 3), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("kind", [
    "adam", "adam_decay", "sgd", "sgd_momentum_wd", "sgd_nesterov"])
def test_optim_method_updates_match_jax(kind):
    from bigdl_tpu.optim import optim_method as jom
    from bigdl_tpu_torch.optim import optim_method as tom

    kw = {"adam": ("Adam", dict(learning_rate=1e-2)),
          "adam_decay": ("Adam", dict(learning_rate=1e-2,
                                      learning_rate_decay=0.1, beta1=0.8)),
          "sgd": ("SGD", dict(learning_rate=0.1)),
          "sgd_momentum_wd": ("SGD", dict(learning_rate=0.1, momentum=0.9,
                                          weight_decay=1e-2,
                                          learning_rate_decay=0.05)),
          "sgd_nesterov": ("SGD", dict(learning_rate=0.1, momentum=0.9,
                                       nesterov=True))}[kind]
    jm, tm = getattr(jom, kw[0])(**kw[1]), getattr(tom, kw[0])(**kw[1])
    params, grads = _params_and_grads(5)
    jp = _jnp_tree(params)
    js = jm.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tm.init_state(tp)
    for g in grads:
        jp, js = jm.update(_jnp_tree(g), js, jp)
        tp, ts = tm.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
    assert ts["neval"] == int(js["neval"]) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_unported_optim_knobs_raise():
    from bigdl_tpu_torch.optim.optim_method import SGD, Adam, Step

    # Adam's bf16 slots and stochastic rounding are ported: both build
    # and step (tests/test_torch_lm_knobs.py holds them against JAX)
    for kw, dtype in (({"state_dtype": "bf16"}, torch.float32),
                      ({"stochastic_rounding": True}, torch.bfloat16)):
        adam = Adam(1e-2, **kw)
        w = {"w": torch.ones(3, dtype=dtype)}
        st = adam.init_state(w)
        w, st = adam.update({"w": torch.ones(3)}, st, w)
        assert st["neval"] == 1 and w["w"].dtype == dtype
        assert (w["w"].float() < 1.0).all()
    with pytest.raises(ValueError, match="state_dtype"):
        Adam(state_dtype="fp8")
    # SGD's schedules are ported: a Step schedule drives the update's rate
    sgd = SGD(learning_rate=0.1, learning_rate_schedule=Step(2, 0.5))
    p = {"w": torch.ones(3)}
    state = sgd.init_state(p)
    for _ in range(3):
        p, state = sgd.update({"w": torch.ones(3)}, state, p)
    assert torch.allclose(p["w"], torch.full((3,), 1 - 0.1 - 0.1 - 0.05))


# ------------------------------------------------------------ train step


def _lm_pair():
    """A logits-head LM with the flash path on both sides, same weights."""
    return make_pair(V=V, max_len=T, output="logits", use_flash="always")


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, V + 1, size=(B, T)).astype(np.int32)
    y = rng.integers(1, V + 1, size=(B, T)).astype(np.float32)
    y[:, -3:] = 0.0                          # padding steps, masked
    return x, y


# The key projection's bias gets a gradient that is zero in exact
# arithmetic (it adds q.bk to every score of a query row, which the
# softmax cancels): in both frameworks it is f32 rounding noise, which
# Adam normalises to +-lr per step. It is held to 3 steps x 2 lr.
_NOISE_ATOL = 6e-3


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_train_step_three_steps_match_jax(compute):
    from bigdl_tpu.nn.criterion_more import MaskedSoftmaxCECriterion as JCE
    from bigdl_tpu.optim.optim_method import Adam as JAdam
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn.criterion_more import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.optim.optim_method import Adam
    from bigdl_tpu_torch.optim.train_step import make_train_step
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jlm, tlm = _lm_pair()
    jdt = None if compute == "fp32" else jnp.bfloat16
    jstep = jax.jit(jmake(jlm, JCE(0), JAdam(1e-3), compute_dtype=jdt))
    tstep = make_train_step(tlm, MaskedSoftmaxCECriterion(0), Adam(1e-3),
                            compute_dtype=compute)
    jp = jlm.params
    js = JAdam(1e-3).init_state(jp)
    tp = {k: p.detach().clone() for k, p in tlm.named_parameters()}
    ts = Adam(1e-3).init_state(tp)
    jl, tl = [], []
    for i in range(3):
        x, y = _batch(i)
        jp, js, _, loss = jstep(jp, js, jlm.state, jax.random.PRNGKey(0),
                                jnp.asarray(x), jnp.asarray(y))
        jl.append(float(loss))
        tp, ts, _, tloss = tstep(tp, ts, {}, None, torch.from_numpy(x),
                                 torch.from_numpy(y))
        tl.append(float(tloss))
    loss_rtol, atol = (1e-5, 2e-6) if compute == "fp32" else (2e-2, 6e-3)
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    want = named_leaves(tlm, jax.device_get(jp))
    assert set(want) == set(tp)
    far = total = 0
    for k, w in want.items():
        np.testing.assert_allclose(tp[k].numpy(), w, rtol=0, err_msg=k,
                                   atol=_NOISE_ATOL if k.endswith(
                                       "wk.bias") else atol)
        if not k.endswith("wk.bias"):
            far += int((np.abs(tp[k].numpy() - w) > 5e-4).sum())
            total += w.size
    assert far <= 0.01 * total
    # the optimizer state carries across too
    from bigdl_tpu_torch.optim.optim_method import load_jax_opt_state

    tjs = load_jax_opt_state(tlm, jax.device_get(js))
    assert tjs["neval"] == ts["neval"] == 3
    for k in tp:
        np.testing.assert_allclose(ts["m"][k].numpy(), tjs["m"][k].numpy(),
                                   atol=atol, rtol=0)


def test_token_ids_stay_integer_under_bf16_compute():
    from bigdl_tpu_torch.optim.train_step import cast_floats

    ids = torch.tensor([[300, 301]], dtype=torch.int32)
    out = cast_floats({"x": ids, "w": torch.ones(2)}, torch.bfloat16)
    assert out["x"].dtype == torch.int32 and out["w"].dtype == torch.bfloat16


# ------------------------------------------------------------- optimizer


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(1, V + 1, size=T).astype(np.int32)
        y = rng.integers(1, V + 1, size=T).astype(np.float32)
        y[-2:] = 0.0
        out.append((x, y))
    return out


def test_optimizer_optimize_matches_jax_local_optimizer():
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.nn.criterion_more import MaskedSoftmaxCECriterion as JCE
    from bigdl_tpu.optim import Adam as JAdam
    from bigdl_tpu.optim import Optimizer as JOptimizer
    from bigdl_tpu.optim import Trigger as JTrigger
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Optimizer, Trigger
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jlm, tlm = _lm_pair()
    data = _samples(10, seed=3)               # 2 full batches per epoch
    jopt = JOptimizer(model=jlm, dataset=[JSample(x, y) for x, y in data],
                      criterion=JCE(0), batch_size=4,
                      end_trigger=JTrigger.max_iteration(5))
    jopt.set_optim_method(JAdam(1e-3))
    jopt.optimize()
    topt = Optimizer(tlm, [Sample(x, y) for x, y in data],
                     MaskedSoftmaxCECriterion(0), batch_size=4,
                     end_trigger=Trigger.max_iteration(5))
    assert isinstance(topt, LocalOptimizer)
    topt.set_optim_method(Adam(1e-3))
    tlm.evaluate()                  # optimize() switches it to training
    assert topt.optimize() is tlm
    assert all(m.training is True for m in tlm.modules())
    assert (topt.optim_method.state["neval"]
            == jopt.optim_method.state["neval"] == 6)
    assert (topt.optim_method.state["epoch"]
            == jopt.optim_method.state["epoch"] == 2)
    assert topt.metrics.get("records/second")[1] == 5
    got = dict(tlm.named_parameters())
    for k, w in named_leaves(tlm, jax.device_get(jlm.params)).items():
        np.testing.assert_allclose(
            got[k].detach().numpy(), w, rtol=0, err_msg=k,
            atol=10e-3 if k.endswith("wk.bias") else 2e-6)


def test_optimizer_refuses_unported_knobs_and_does_not_retry(tmp_path):
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    _, tlm = _lm_pair()
    calls = []

    class Failing(MaskedSoftmaxCECriterion):
        def apply(self, input, target):
            calls.append(1)
            raise RuntimeError("kernel failed")

    opt = Optimizer(tlm, [Sample(x, y) for x, y in _samples(4, 0)],
                    Failing(0), batch_size=4,
                    end_trigger=Trigger.max_iteration(2))
    # the summaries, the profile window and preemption are ported: each
    # knob now returns the optimizer
    from bigdl_tpu_torch.visualization import TrainSummary

    assert opt.set_train_summary(TrainSummary(str(tmp_path), "app")) is opt
    assert opt.set_profile(str(tmp_path / "trace")) is opt
    assert opt.handle_preemption() is opt
    opt.handle_preemption(False)        # it would ask for a checkpoint
    before = {k: p.detach().clone() for k, p in tlm.named_parameters()}
    with pytest.raises(RuntimeError, match="kernel failed"):
        opt.optimize()
    assert calls == [1]                       # one attempt, no retry
    # checkpoints, validation and resume are ported: each now works here
    from bigdl_tpu_torch.optim.validation import Loss

    ckpt = str(tmp_path / "ckpt")
    assert opt.set_checkpoint(ckpt, Trigger.every_epoch()) is opt
    assert opt.set_validation(Trigger.every_epoch(), [
        Sample(x, y) for x, y in _samples(4, 1)], [Loss(Failing(0))], 4) is opt
    with pytest.raises(RuntimeError, match="kernel failed"):
        opt.optimize(resume=True)             # nothing saved yet: fresh
    assert calls == [1, 1]                    # again one attempt
    for k, p in tlm.named_parameters():
        assert torch.equal(p.detach(), before[k])


# ------------------------------------------------- clipping, triggers, data


def test_gradient_clipping_matches_jax():
    from bigdl_tpu.optim import train_step as jts
    from bigdl_tpu_torch.optim import train_step as tts

    _, grads = _params_and_grads(8)
    g = grads[0]
    jg, tg = _jnp_tree(g), {k: torch.from_numpy(v) for k, v in g.items()}
    for jclip, tclip in ((jts.clip_by_global_norm(jg, 0.5),
                          tts.clip_by_global_norm(tg, 0.5)),
                         (jts.clip_by_global_norm(jg, 1e3),
                          tts.clip_by_global_norm(tg, 1e3)),
                         (jts.clip_by_value(jg, -0.3, 0.2),
                          tts.clip_by_value(tg, -0.3, 0.2))):
        for k in g:
            np.testing.assert_allclose(tclip[k].numpy(), np.asarray(jclip[k]),
                                       rtol=1e-6, atol=1e-7)


def test_triggers_compose_and_peek_like_jax():
    from bigdl_tpu.optim.trigger import Trigger as JT
    from bigdl_tpu_torch.optim.trigger import Trigger as TT

    states = [{"epoch": e, "neval": n} for e in (1, 2, 3) for n in (1, 4, 9)]
    for make in (lambda T: T.max_epoch(2), lambda T: T.max_iteration(4),
                 lambda T: T.max_epoch(1).and_(T.max_iteration(5)),
                 lambda T: T.max_epoch(2).or_(T.max_iteration(8))):
        j, t = make(JT), make(TT)
        assert [t(s) for s in states] == [j(s) for s in states]
        assert [t.peek(s) for s in states] == [j.peek(s) for s in states]


def test_dataset_batches_in_the_jax_order():
    from bigdl_tpu.dataset.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JBatch
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch

    data = _samples(7, seed=1)
    jit = (JDataSet.array([JSample(x, y) for x, y in data], seed=4)
           >> JBatch(3)).data(train=True)
    tit = (DataSet.array([Sample(x, y) for x, y in data], seed=4)
           >> SampleToMiniBatch(3)).data(train=True)
    for _ in range(6):                       # crosses epoch boundaries
        jb, tb = next(jit), next(tit)
        assert tb.size() == jb.size() == 3
        np.testing.assert_array_equal(tb.get_input(), jb.get_input())
        np.testing.assert_array_equal(tb.get_target(), jb.get_target())
    once = list(DataSet.array([Sample(x, y) for x, y in data]).data(False))
    assert [s.feature().tolist() for s in once] == [x.tolist() for x, _ in data]


def test_eval_step_matches_jax_forward():
    from bigdl_tpu.optim.train_step import make_eval_step as jeval
    from bigdl_tpu_torch.optim.train_step import make_eval_step

    jlm, tlm = _lm_pair()
    x, _ = _batch(4)
    want = jeval(jlm)(jlm.params, jlm.state, jnp.asarray(x))
    got = make_eval_step(tlm)(dict(tlm.named_parameters()), {},
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("config", ["sgd_l2_clip", "adam_value_clip"])
def test_clipped_optimize_runs_match_jax(config):
    """``Optimizer`` with each clipping setter against the JAX loop on the
    same samples (SGD: parameters 2e-6 absolute, f32 three steps; Adam:
    as the unclipped run, ``wk.bias`` held to a few lr)."""
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.nn.criterion_more import MaskedSoftmaxCECriterion as JCE
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import Adam as JAdam
    from bigdl_tpu.optim import Optimizer as JOptimizer
    from bigdl_tpu.optim import Trigger as JTrigger
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.optim import SGD, Adam, Optimizer, Trigger
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jlm, tlm = _lm_pair()
    data = _samples(8, seed=6)
    opts = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            o = JOptimizer(model=jlm, dataset=[JSample(x, y) for x, y in data],
                           criterion=JCE(0), batch_size=4,
                           end_trigger=JTrigger.max_iteration(3))
            sgd, adam = JSGD, JAdam
        else:
            o = Optimizer(tlm, [Sample(x, y) for x, y in data],
                          MaskedSoftmaxCECriterion(0), batch_size=4,
                          end_trigger=Trigger.max_iteration(3))
            sgd, adam = SGD, Adam
        if config == "sgd_l2_clip":
            o.set_optim_method(sgd(learning_rate=0.5, momentum=0.9))
            o.set_gradient_clipping_by_l2_norm(0.05)
        else:
            o.set_optim_method(adam(1e-3))
            o.set_constant_gradient_clipping(-1e-3, 1e-3)
        o.optimize()
        opts.append(o)
    got = dict(tlm.named_parameters())
    for k, w in named_leaves(tlm, jax.device_get(jlm.params)).items():
        noisy = config != "sgd_l2_clip" and k.endswith("wk.bias")
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   err_msg=k, atol=6e-3 if noisy else 2e-6)


def test_dtype_helpers_match_jax():
    from bigdl_tpu.optim import train_step as jts
    from bigdl_tpu_torch.optim import train_step as tts

    assert tts.resolve_dtype("bf16") == torch.bfloat16
    assert tts.resolve_dtype("fp32") is None and jts.resolve_dtype("fp32") is None
    with pytest.raises(ValueError, match="unknown compute dtype"):
        tts.resolve_dtype("int4")
    ref = {"w": torch.zeros(2), "n": torch.zeros(2, dtype=torch.int32)}
    tree = tts.cast_floats({"w": torch.ones(2), "n": torch.ones(
        2, dtype=torch.int32)}, torch.bfloat16)
    back = tts.restore_dtypes(tree, ref)
    jback = jts.restore_dtypes(
        jts.cast_floats({"w": jnp.ones(2), "n": jnp.ones(2, jnp.int32)},
                        jnp.bfloat16),
        {"w": jnp.zeros(2), "n": jnp.zeros(2, jnp.int32)})
    assert back["w"].dtype == torch.float32 and back["n"].dtype == torch.int32
    assert str(jback["w"].dtype) == "float32" and str(jback["n"].dtype) == "int32"
