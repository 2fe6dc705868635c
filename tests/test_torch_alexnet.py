"""AlexNet (``bigdl_tpu_torch/models/alexnet.py``) against the JAX
package on the CPU: both models' trees (keys and shapes, with and
without Dropout), their eval forwards and one SGD step at batch 2 from
the same numpy-drawn weights (``numpy_trees``; JAX's own init of 61M
weights costs seconds), and ``train_main``, as
``tests/test_model_mains.py:126-133`` runs JAX's; the twin of
``tests/test_models.py:89``. ``AlexNet_OWT`` takes 224² images (conv1
pads 2); the Caffe-style ``AlexNet`` takes Caffe's 227² crops (no conv1
padding and floor-mode pooling, as in JAX: at 224² its last pool gives
5², not the 6² its head expects, in both packages).

The parity models have no Dropout (its draws cannot be compared across
frameworks; ``tests/test_torch_dropout.py`` holds it within the port).
The JAX side of each model is one module-scoped fixture that jits its
forward and its train step once.

Tolerances: the forward's log-probabilities within 1e-5 of JAX's
relative to their largest magnitude (f32, convolutions and products
summing up to 9,216 terms in other orders); the step's loss within 1e-5
relative; each parameter's update (new minus old) within 2e-4 of its
tensor's largest update: a weight or bias gradient sums up to 6,050
terms per element (conv1 over 2 images of 55² positions) in another
order, and those sums cancel (measured: up to 6.5e-5, conv1's bias in
the Caffe layout; 2.0e-5 elsewhere). No max-pool or ReLU near-tie
(``tests/test_torch_vgg.py``) occurs on these inputs; one would show as
a larger update error in the layers below it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import alexnet as jalex
from bigdl_tpu_torch.models import alexnet as talex
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
from tests.torch_parity import (  # noqa: F401
    max_rel_err, numpy_trees, one_torch_thread,
)

MODELS = ["AlexNet_OWT", "AlexNet"]
#: each model's input side
SIDE = {"AlexNet_OWT": 224, "AlexNet": 227}


def _x(seed, name):
    side = SIDE[name]
    return np.random.default_rng(seed).standard_normal(
        (2, 3, side, side)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """model → (params, eval output, (loss, params) after one SGD step)
    from JAX on the same numpy inputs."""
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim.train_step import make_train_step as jmake

    out = {}
    for i, name in enumerate(MODELS):
        jm = getattr(jalex, name)(1000, has_dropout=False)
        params, _ = numpy_trees(jm, 30 + i)
        fwd = jax.jit(lambda p, x, jm=jm: jm.apply(p, x, {},
                                                   training=False)[0])
        want = np.asarray(fwd(params, jnp.asarray(_x(1, name))))
        method = JSGD(0.01, momentum=0.9)
        step = jax.jit(jmake(jm, JNLL(), method))
        y = jnp.float32([3, 917])
        new, _, _, loss = step(params, method.init_state(params), {},
                               jax.random.PRNGKey(0),
                               jnp.asarray(_x(2, name)), y)
        out[name] = (params, want, (float(loss), jax.device_get(new)))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_tree_matches_jax(name):
    """Children (types, names), params keys and shapes against JAX's
    (``jax.eval_shape``), with Dropout; the parameter count of
    ``tests/test_models.py:89``."""
    jm = getattr(jalex, name)(1000)
    tm = getattr(talex, name)(1000, device="cpu")
    assert [type(m).__name__ for m in tm] == [type(m).__name__
                                             for m in jm.modules]
    # every child but the Reshape carries the reference's name (the
    # Reshape's is its class name and a per-process counter)
    named = [(a.name, b.name) for a, b in zip(tm, jm.modules)
             if type(b).__name__ != "Reshape"]
    assert len(named) == len(tm) - 1 and all(a == b for a, b in named)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    assert set(named_leaves(tm, zeros)) == {k for k, _ in
                                            tm.named_parameters()}
    assert 55e6 < tm.n_parameters() < 65e6
    assert tm.n_parameters() == sum(int(np.prod(s.shape)) for s in
                                    jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(jax_side, name):
    params, want, _ = jax_side[name]
    tm = load_jax_tree(getattr(talex, name)(1000, has_dropout=False,
                                            device="cpu"), params)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(_x(1, name))).numpy()
    assert got.shape == (2, 1000)
    err = max_rel_err(got, want)
    assert err <= 1e-5, f"{name} forward: {err}"


@pytest.mark.parametrize("name", MODELS)
def test_sgd_step_matches_jax(jax_side, name):
    """One step of the port's train step (SGD 0.01, momentum 0.9,
    ``ClassNLLCriterion``) against JAX's jitted step: the loss and every
    parameter's update."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    params, _, (loss_want, new_want) = jax_side[name]
    tm = load_jax_tree(getattr(talex, name)(1000, has_dropout=False,
                                            device="cpu"), params)
    before = named_leaves(tm, params)
    after = named_leaves(tm, new_want)
    tp = {k: p.detach().clone() for k, p in tm.named_parameters()}
    method = SGD(0.01, momentum=0.9)
    step = make_train_step(tm.train(), ClassNLLCriterion(), method)
    tp, _, _, loss = step(tp, method.init_state(tp), {}, None,
                          torch.from_numpy(_x(2, name)),
                          torch.tensor([3., 917.]))
    assert abs(float(loss) - loss_want) <= 1e-5 * abs(loss_want)
    for k, v in tp.items():
        want = after[k] - before[k]
        err = max_rel_err(v.numpy() - before[k], want)
        assert err <= 2e-4, f"{name}.{k} update: {err}"


def test_train_main_runs_one_iteration():
    """``train_main`` as ``tests/test_model_mains.py:126`` runs JAX's: one
    iteration at batch 8 on 16 synthetic images, finite weights."""
    model = talex.train_main(["-b", "8", "--maxIteration", "1",
                              "--synthetic", "16", "--device", "cpu"])
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert next(model.parameters()).device.type == "cpu"
