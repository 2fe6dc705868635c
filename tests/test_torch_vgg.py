"""VGG (``bigdl_tpu_torch/models/vgg.py``) against the JAX package on
the CPU: ``VggForCifar10``'s tree and forwards at batch 4, 32², three
teacher-forced SGD steps at batch 4, ``Vgg_16``/``Vgg_19``'s tree keys
and shapes, and the ``train_main``/``test_main`` mains (with Dropout on)
at two iterations.

The JAX reference's trees are drawn with numpy (``numpy_trees``; JAX's
own init of VGG costs about 12 s here) and its step is jitted once.
Dropout cannot be compared draw for draw (``tests/test_torch_dropout.py``
holds it within the port), so the parity runs have it inactive: eval
mode, or the training forward with no generator, or ``has_dropout=False``.

Batch 4, not 2: at batch 2 the head's ``BatchNormalization`` normalizes
two values per feature, and its forward and backward amplify f32
rounding so much that each framework's first update lies 5e-4 to 1e-3
from a float64 run of the port (measured); at 4 it is well conditioned.

Tolerances, with their reasons:

* forwards: 1e-5 relative to the output's largest magnitude in eval mode
  (f32, 16 layers, sums in other orders), 5e-5 in training mode (batch
  statistics over as few as 4 values per channel: each framework measured
  up to 1.2e-5 from the float64 run);
* each step: the loss within 1e-5 relative; every parameter's update
  within 1e-3 of the largest update of its layer (a BatchNorm scale's
  gradient is a sum of g·x̂ over 4-16 values per channel that cancels:
  measured up to 1.2e-4); the new BN statistics within 1e-5 relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu_torch.models import vgg as tvgg
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
from tests.torch_parity import numpy_trees, one_torch_thread  # noqa: F401


def _close(got, want, rtol, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= rtol, f"{what}: relative error {err} > {rtol}"


@pytest.fixture(scope="module")
def cifar_vgg():
    """(JAX VggForCifar10, its numpy trees) with Dropout layers."""
    jm = jvgg.VggForCifar10(10)
    return jm, numpy_trees(jm, 6)


def _x(n=2, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 32, 32)).astype(np.float32)


def test_cifar_vgg_tree_and_forwards_match_jax(cifar_vgg):
    """Keys (by child index) and shapes of params and BN state; the
    forward in training mode (batch statistics, Dropout without a
    generator) and in eval mode."""
    from bigdl_tpu_torch.nn import Dropout

    jm, (params, state) = cifar_vgg
    tm = tvgg.VggForCifar10(10, device="cpu")
    assert len(tm) == len(jm.modules) == 60
    assert [type(m).__name__ for m in tm] == [
        type(m).__name__ for m in jm.modules]
    assert [m.p for m in tm if isinstance(m, Dropout)] == [0.3] + [0.4] * 7 \
        + [0.5] * 2
    assert set(named_leaves(tm, params)) == {
        k for k, _ in tm.named_parameters()}
    assert set(named_leaves(tm, state, "buffers")) == {
        k for k, _ in tm.named_buffers()}
    x = _x(n=4)
    fwd = jax.jit(lambda p, s, x, t: jm.apply(p, x, s, training=t)[0],
                  static_argnums=3)
    for training in (True, False):
        load_jax_tree(tm, params, state)
        want = fwd(params, state, jnp.asarray(x), training)
        with torch.no_grad():
            got = (tm.train() if training else tm.eval())(torch.from_numpy(x))
        _close(got, want, 1e-5 if not training else 5e-5,
               f"training={training}")


@pytest.mark.parametrize("name,n_params", [("Vgg_16", 138357544),
                                           ("Vgg_19", 143667240)])
def test_imagenet_towers_tree_keys_and_shapes(name, n_params):
    """The towers' params trees, keys and shapes, against JAX's
    (``jax.eval_shape``: neither side fills 138M weights for JAX)."""
    jm = getattr(jvgg, name)(1000)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    tm = getattr(tvgg, name)(1000, device="cpu")
    leaves = named_leaves(tm, zeros)
    assert set(leaves) == {k for k, _ in tm.named_parameters()}
    assert tm.n_parameters() == n_params
    assert [type(m).__name__ for m in tm] == [
        type(m).__name__ for m in jm.modules]
    no_drop = getattr(tvgg, name)(10, has_dropout=False, device="cpu")
    assert len(no_drop) == len(tm) - 2


#: the layers whose gradient routing a near-tie decides
_ROUTERS = ("ReLU", "SpatialMaxPooling")


def _jax_router_inputs(jm):
    """(child indices of the ReLUs and max pools, a jitted function of
    (params, state, x) giving each one's input in a training forward)."""
    routers = [i for i, m in enumerate(jm.modules)
               if type(m).__name__ in _ROUTERS]

    def inputs(p, s, x):
        out = []
        for i, m in enumerate(jm.modules):
            k = jm._child_key(i)
            if i in routers:
                out.append(x)
            x, _ = m.apply(p.get(k, {}), x, s.get(k, {}), training=True)
        return out

    return routers, jax.jit(inputs)


def _routes_differ(a, b) -> bool:
    """Whether a ReLU's (2-D) or a 2x2/2 max pool's (4-D) input routes a
    gradient differently in the two forwards: a sign that differs, or a
    window whose first maximum sits elsewhere."""
    if a.ndim == 2 or a.shape[-1] % 2:
        return bool(((a > 0) != (b > 0)).any())

    def first_max(v):
        n, c, h, w = v.shape
        return v.reshape(n, c, h // 2, 2, w // 2, 2).transpose(
            0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4).argmax(-1)

    return bool(((a > 0) != (b > 0)).any()
                or (first_max(a) != first_max(b)).any())


def test_three_sgd_steps_match_jax(cifar_vgg):
    """``VggForCifar10(has_dropout=False)`` from the same trees, three
    steps of JAX's jitted train step and the port's (SGD, momentum 0.9),
    teacher-forced: each step starts both from JAX's parameters, BN
    statistics and velocity. Each step's loss, parameter updates and new
    BN statistics are compared. On a step where some ReLU input has
    another sign in the two forwards (a value within an ulp or so of 0,
    whose sign the summation order decides), the gradients below that
    ReLU differ by design, so the layers below it are not compared on
    that step; the same for a max-pool window whose two largest inputs
    are so close that the two forwards pick different ones. Every layer
    must still be compared on some step."""
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.optim_method import load_jax_opt_state
    from bigdl_tpu_torch.optim.train_step import make_train_step

    _, (params, state) = cifar_vgg
    jm = jvgg.VggForCifar10(10, has_dropout=False)
    jp, js = _reindexed(params, jm), _reindexed(state, jm)
    tm = load_jax_tree(tvgg.VggForCifar10(10, has_dropout=False,
                                          device="cpu"), jp, js)
    jmethod, method = JSGD(0.01, momentum=0.9), SGD(0.01, momentum=0.9)
    jstep = jax.jit(jmake(jm, JNLL(), jmethod))
    tstep = make_train_step(tm.train(), ClassNLLCriterion(), method)
    routers, jax_inputs = _jax_router_inputs(jm)
    seen = []
    for i in routers:
        tm[i].register_forward_pre_hook(
            lambda m, args: seen.append(args[0].detach().clone()))
    jopt = jmethod.init_state(jp)
    rng = np.random.default_rng(8)
    compared, tied_steps = set(), []
    for i in range(3):
        x = _x(n=4, seed=20 + i)
        y = rng.integers(1, 11, 4).astype(np.float32)
        tp = {k: torch.from_numpy(np.array(v))
              for k, v in named_leaves(tm, jax.device_get(jp)).items()}
        ts = {k: torch.from_numpy(np.array(v)) for k, v in
              named_leaves(tm, jax.device_get(js), "buffers").items()}
        before = {k: v.clone() for k, v in tp.items()}
        topt = load_jax_opt_state(tm, jax.device_get(jopt))
        seen.clear()
        tp, topt, ts, tloss = tstep(tp, topt, ts, None, torch.from_numpy(x),
                                    torch.from_numpy(y))
        flips = [r for r, a, b in zip(routers, seen,
                                      jax_inputs(jp, js, jnp.asarray(x)))
                 if _routes_differ(a.numpy(), np.asarray(b))]
        jp2, jopt, js, jloss = jstep(jp, jopt, js, jax.random.PRNGKey(0),
                                     jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        below = max(flips, default=-1)
        if flips:
            tied_steps.append(i)
        want_p, was_p = (named_leaves(tm, jax.device_get(t))
                         for t in (jp2, jp))
        # each update against the largest of its layer's updates: a
        # conv bias before a BN has a gradient of 0 up to rounding
        scale = {}
        for k, w in want_p.items():
            layer = int(k.split(":")[0])
            scale[layer] = max(scale.get(layer, 0.0),
                               float(np.abs(w - was_p[k]).max()))
        for k, w in want_p.items():
            layer = int(k.split(":")[0])
            if layer > below:
                err = float(np.abs((tp[k] - before[k]).numpy()
                                   - (w - was_p[k])).max()) / scale[layer]
                assert err <= 1e-3, (i, k, err)
                compared.add(k)
        for k, w in named_leaves(tm, jax.device_get(js), "buffers").items():
            _close(ts[k], w, 1e-5, f"step {i} {k}")
        jp = jp2
    assert compared == {k for k, _ in tm.named_parameters()}, tied_steps


def _reindexed(tree, jm):
    """A VggForCifar10 tree as the tree of ``jm``, the same layers
    without Dropout: Dropout has no params or state, but its child index
    and key count."""
    kept = [v for k, v in sorted(tree.items(),
                                 key=lambda kv: int(kv[0].split(":")[0]))
            if "Dropout" not in k]
    assert len(kept) == len(jm.modules)
    return {jm._child_key(i): v for i, v in enumerate(kept)}


def test_train_main_and_test_main_on_the_cpu(tmp_path):
    """The mains as a user runs them, Dropout on (the step's generator),
    two iterations on the synthetic CIFAR set, then the snapshot's Top-1;
    without a card the default device raises."""
    from bigdl_tpu_torch.optim.validation import AccuracyResult

    ckpt = str(tmp_path / "ckpt")
    model = tvgg.train_main(["--synthetic", "8", "-b", "4",
                             "--maxIteration", "2", "--cache", ckpt,
                             "--device", "cpu"])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert sorted(os.listdir(ckpt)) == ["model", "optimMethod"]
    (res,) = tvgg.test_main(["--synthetic", "6", "-b", "3", "--model",
                             os.path.join(ckpt, "model"), "--device", "cpu"])
    assert isinstance(res, AccuracyResult)
    top1, scored = res.result()
    assert scored == 6 and 0.0 <= top1 <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvgg.train_main(["--synthetic", "4", "-b", "4",
                             "--maxIteration", "1"])
