"""The port's stochastic layers and the train step's generator
(``bigdl_tpu_torch/nn/misc.py::Dropout``, ``nn/module.py::use_rng``,
``optim/train_step.py``, ``Optimizer``'s per-step seeding) on the CPU.

The masks cannot match JAX's threefry draws, so JAX parity is held where
Dropout is the identity (eval mode, ``p = 0``, no generator), and the
rest within the port: the keep rate, the 1/keep scaling and its
gradient, one mask for one (seed, ``neval``) and another for the next
``neval``, no draw from torch's global generator, and a run resumed from
a checkpoint bitwise equal to an uninterrupted one with dropout on.

Tolerances: the identity cases and every port-against-port comparison
are exact; the keep rate is within 5 standard deviations of a binomial
over 200,000 draws.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401


def _x(shape=(4, 6, 5), seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("case", ["eval", "p0", "no_rng"])
def test_dropout_is_jax_where_it_is_the_identity(case):
    import jax

    from bigdl_tpu.nn import Dropout as JDropout
    from bigdl_tpu_torch.nn import Dropout
    from bigdl_tpu_torch.nn.module import use_rng

    x = _x()
    p = 0.0 if case == "p0" else 0.4
    training = case != "eval"
    key = None if case == "no_rng" else jax.random.PRNGKey(0)
    want, _ = JDropout(p).apply({}, jnp.asarray(x), {}, training=training,
                                rng=key)
    d = Dropout(p)
    d.train(training)
    gen = None if case == "no_rng" else torch.Generator().manual_seed(0)
    with use_rng(gen):
        got = d(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x)
    assert d.set_p(0.25) is d and d.p == 0.25


@pytest.mark.parametrize("scale", [True, False])
def test_keep_rate_scaling_and_gradient(scale):
    from bigdl_tpu_torch.nn import Dropout
    from bigdl_tpu_torch.nn.module import use_rng

    p, n = 0.3, 200_000
    x = torch.from_numpy(_x((n,)) + 5.0).requires_grad_()
    d = Dropout(p, scale=scale)
    with use_rng(torch.Generator().manual_seed(1)):
        out = d(x)
    kept = out != 0
    rate = float(kept.float().mean())
    assert abs(rate - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n), rate
    want = x.detach() / (1 - p) if scale else x.detach()
    torch.testing.assert_close(out[kept], want[kept], rtol=0, atol=0)
    (g,) = torch.autograd.grad(out.sum(), x)
    factor = 1 / (1 - p) if scale else 1.0
    torch.testing.assert_close(g, kept.float() * factor, rtol=0, atol=0)


def _tiny(seed=4, p=0.5):
    """A conv → BN → ReLU → Dropout → pool → Linear classifier."""
    from bigdl_tpu_torch.nn import (
        Dropout, Linear, LogSoftMax, ReLU, Reshape, Sequential,
        SpatialBatchNormalization, SpatialConvolution, SpatialMaxPooling,
    )

    g = torch.Generator().manual_seed(seed)
    kw = {"device": "cpu", "generator": g}
    return (Sequential()
            .add(SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw))
            .add(SpatialBatchNormalization(8, 1e-3, **kw))
            .add(ReLU(True))
            .add(Dropout(p))
            .add(SpatialMaxPooling(2, 2, 2, 2))
            .add(Reshape([8 * 4 * 4], batch_mode=True))
            .add(Linear(8 * 4 * 4, 5, **kw))
            .add(LogSoftMax()))


def _batch(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, 3, 8, 8))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(1, 6, n).astype(np.float32)))


def _one_step(model, rng):
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    method = SGD(learning_rate=0.1)
    step = make_train_step(model.train(), ClassNLLCriterion(), method)
    x, y = _batch()
    params, _, _, loss = step(params, method.init_state(params), state, rng,
                              x, y)
    return float(loss), params


def test_train_step_draws_from_its_generator_and_nothing_else():
    import copy

    model = _tiny()
    before = torch.get_rng_state()
    a = _one_step(copy.deepcopy(model), torch.Generator().manual_seed(7))
    assert torch.equal(torch.get_rng_state(), before)
    b = _one_step(copy.deepcopy(model), torch.Generator().manual_seed(7))
    c = _one_step(copy.deepcopy(model), torch.Generator().manual_seed(8))
    assert a[0] == b[0] and a[0] != c[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    # no generator: Dropout is the identity, the step of the model
    # without it
    off = _tiny()
    off[3].set_p(0.0)
    assert _one_step(copy.deepcopy(model), None)[0] == \
        _one_step(off, torch.Generator().manual_seed(7))[0]


def test_step_seed_is_per_seed_and_neval():
    from bigdl_tpu_torch.optim.train_step import step_seed

    seeds = {(s, n): step_seed(s, n) for s in (0, 1, 2) for n in range(1, 40)}
    assert len(set(seeds.values())) == len(seeds)
    assert step_seed(3, 17) == step_seed(3, 17)
    assert all(0 <= v < 2 ** 64 for v in seeds.values())


def _train(model, ckpt=None, epochs=3, resume=False, seed=0):
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    x, y = _batch(n=24)
    samples = [Sample(a, b) for a, b in zip(x.numpy(), y.numpy())]
    opt = Optimizer(model, samples, ClassNLLCriterion(), batch_size=6,
                    end_trigger=Trigger.max_epoch(epochs))
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    opt.set_seed(seed)
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.every_epoch())
    opt.optimize(resume=resume)
    return model, opt


def test_optimizer_masks_follow_seed_and_neval_and_resume_bitwise(tmp_path):
    """Three epochs of four steps with Dropout(0.5): the same seed gives
    the same parameters, another seed others; a run stopped after epoch
    1 and resumed into a freshly built model equals the uninterrupted
    run bitwise."""
    ref, ropt = _train(_tiny())
    assert ropt.optim_method.state["neval"] == 13
    again, _ = _train(_tiny())
    other, _ = _train(_tiny(), seed=1)
    no_dropout, _ = _train(_tiny(p=0.0))
    ckpt = str(tmp_path / "ckpt")
    _train(_tiny(), ckpt=ckpt, epochs=1)
    assert sorted(os.listdir(ckpt)) == ["model", "optimMethod"]
    resumed, _ = _train(_tiny(seed=99), ckpt=ckpt, resume=True)
    for (k, a), b, c, d, e in zip(
            ref.named_parameters(), again.parameters(), other.parameters(),
            resumed.parameters(), no_dropout.parameters()):
        assert torch.equal(a, b), k
        assert torch.equal(a, d), k
        assert not torch.equal(a, c) and not torch.equal(a, e), k
