"""The port's remaining criteria (``bigdl_tpu_torch/nn/criterion.py``:
``MSECriterion``, ``AbsCriterion``, ``BCECriterion``,
``SmoothL1Criterion``, ``MultiLabelSoftMarginCriterion``,
``MarginCriterion``, ``DistKLDivCriterion``; ``nn/criterion_more.py``:
``L1HingeEmbeddingCriterion``, ``PoissonCriterion``,
``MeanAbsolutePercentageCriterion``, ``MeanSquaredLogarithmicCriterion``,
``KullbackLeiblerDivergenceCriterion``, ``CategoricalCrossEntropy``)
held against the JAX package's on the CPU, the twin of
``tests/test_criterion.py``.

Each case feeds the same numpy-seeded input and target to both: the loss
and the gradient with respect to the input (a list for the table input
of ``L1HingeEmbeddingCriterion``) agree within f32 rounding (rel 1e-6,
abs 1e-7 for the loss; rtol 1e-5, atol 1e-7 for the gradient). The JAX
side runs once, in one module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401


def _cases():
    from bigdl_tpu.nn import criterion as jc
    from bigdl_tpu.nn import criterion_more as jcm
    from bigdl_tpu_torch.nn import criterion as tc
    from bigdl_tpu_torch.nn import criterion_more as tcm

    rng = np.random.default_rng(17)

    def f32(*shape, lo=None, hi=None):
        if lo is None:
            return rng.standard_normal(shape).astype(np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)

    x, y = f32(6, 5), f32(6, 5)
    p, t01 = f32(6, 5, lo=0.02, hi=0.98), (f32(6, 5, lo=0, hi=1) > 0.5)
    t01 = t01.astype(np.float32)
    w = f32(5, lo=0.5, hi=2.0)
    pm1 = np.where(f32(6, 5) > 0, 1.0, -1.0).astype(np.float32)
    logp = np.log(p / p.sum(-1, keepdims=True)).astype(np.float32)
    dist = f32(6, 5, lo=0.0, hi=1.0)
    dist[0, :2] = 0.0                       # zero targets are skipped
    dist /= dist.sum(-1, keepdims=True)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    pos, pos_t = f32(6, 5, lo=0.1, hi=3.0), f32(6, 5, lo=0.1, hi=3.0)
    pair = [f32(4, 3), f32(4, 3)]
    return {
        "mse": (jc.MSECriterion(), tc.MSECriterion(), x, y),
        "mse_sum": (jc.MSECriterion(False), tc.MSECriterion(False), x, y),
        "abs": (jc.AbsCriterion(), tc.AbsCriterion(), x, y),
        "abs_sum": (jc.AbsCriterion(False), tc.AbsCriterion(False), x, y),
        "bce": (jc.BCECriterion(), tc.BCECriterion(), p, t01),
        "bce_weighted_sum": (jc.BCECriterion(w, False),
                             tc.BCECriterion(w, False), p, t01),
        "smooth_l1": (jc.SmoothL1Criterion(), tc.SmoothL1Criterion(),
                      2 * x, y),
        "smooth_l1_sum": (jc.SmoothL1Criterion(False),
                          tc.SmoothL1Criterion(False), 2 * x, y),
        "multilabel_soft_margin": (jc.MultiLabelSoftMarginCriterion(),
                                   tc.MultiLabelSoftMarginCriterion(),
                                   x, t01),
        "multilabel_soft_margin_weighted_sum": (
            jc.MultiLabelSoftMarginCriterion(w, False),
            tc.MultiLabelSoftMarginCriterion(w, False), x, t01),
        "margin": (jc.MarginCriterion(), tc.MarginCriterion(), x, pm1),
        "margin_sum": (jc.MarginCriterion(0.5, False),
                       tc.MarginCriterion(0.5, False), x, pm1),
        "dist_kl_div": (jc.DistKLDivCriterion(), tc.DistKLDivCriterion(),
                        logp, dist),
        "dist_kl_div_sum": (jc.DistKLDivCriterion(False),
                            tc.DistKLDivCriterion(False), logp, dist),
        "l1_hinge_similar": (jcm.L1HingeEmbeddingCriterion(2.0),
                             tcm.L1HingeEmbeddingCriterion(2.0), pair,
                             np.float32([1.0])),
        "l1_hinge_dissimilar": (jcm.L1HingeEmbeddingCriterion(9.0),
                                tcm.L1HingeEmbeddingCriterion(9.0), pair,
                                np.float32([-1.0])),
        "poisson": (jcm.PoissonCriterion(), tcm.PoissonCriterion(),
                    pos, pos_t),
        "mean_abs_percentage": (jcm.MeanAbsolutePercentageCriterion(),
                                tcm.MeanAbsolutePercentageCriterion(), x, y),
        "mean_squared_log": (jcm.MeanSquaredLogarithmicCriterion(),
                             tcm.MeanSquaredLogarithmicCriterion(),
                             pos, pos_t),
        "kullback_leibler": (jcm.KullbackLeiblerDivergenceCriterion(),
                             tcm.KullbackLeiblerDivergenceCriterion(),
                             p / p.sum(-1, keepdims=True), dist),
        "categorical_cross_entropy": (jcm.CategoricalCrossEntropy(),
                                      tcm.CategoricalCrossEntropy(),
                                      p, onehot),
    }


CASES = sorted(_cases())


def _jnp(v):
    return ([jnp.asarray(a) for a in v] if isinstance(v, list)
            else jnp.asarray(v))


@pytest.fixture(scope="module")
def jax_refs():
    """Every case's JAX loss and input gradient, computed once."""
    out = {}
    for name, (jcrit, _, x, y) in _cases().items():
        loss = float(jcrit.apply(_jnp(x), jnp.asarray(y)))
        g = jcrit.backward(_jnp(x), jnp.asarray(y))
        out[name] = (loss, [np.asarray(v) for v in g]
                     if isinstance(g, list) else np.asarray(g))
    return out


def _torch(v):
    return ([torch.from_numpy(a) for a in v] if isinstance(v, list)
            else torch.from_numpy(v))


@pytest.mark.parametrize("name", CASES)
def test_criterion_value_and_input_grad_match_jax(jax_refs, name):
    _, tcrit, x, y = _cases()[name]
    want, gwant = jax_refs[name]
    got = tcrit.forward(_torch(x), torch.from_numpy(y))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    ggot = tcrit.backward(_torch(x), y)
    if isinstance(gwant, list):
        assert isinstance(ggot, list) and len(ggot) == len(gwant)
        for a, b in zip(ggot, gwant):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(ggot.numpy(), gwant, rtol=1e-5, atol=1e-7)


def test_clipped_bounds_take_jax_half_gradient():
    """At an exact clamp bound (``jnp.maximum``) JAX passes half the
    gradient, and so does the port (``torch.clamp`` would pass all of
    it): ``PoissonCriterion``'s clamp at eps, hit exactly."""
    from bigdl_tpu.nn import criterion_more as jcm
    from bigdl_tpu_torch.nn import criterion_more as tcm

    x = np.float32([[1e-7, 0.5], [2.0, 1e-7]])
    t = np.float32([[1.0, 2.0], [0.5, 3.0]])
    want = np.asarray(jcm.PoissonCriterion().backward(jnp.asarray(x),
                                                      jnp.asarray(t)))
    got = tcm.PoissonCriterion().backward(torch.from_numpy(x), t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
