"""The port's ``nn/criterion_extra.py`` held against the JAX package's on
the CPU, the twin of ``tests/test_criterion_extra.py`` (its cases and
more: each mode and option a parametrized case).

Each case feeds the same numpy-seeded input and target to both criteria:
the loss (``forward``) within 1e-6 of JAX's relative to its magnitude
(1e-7 absolute near 0), and the gradient with respect to the input
(``backward``, a list for a table input, against ``jax.grad``) within
1e-5 of JAX's relative to its largest magnitude (f32 rounding, sums in
other orders). The JAX side runs once, in one module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_parity import max_rel_err, one_torch_thread  # noqa: F401


def _cases():
    """name → (JAX criterion, port criterion, input, target)."""
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    rng = np.random.default_rng(23)

    def f32(*shape, lo=None, hi=None):
        if lo is None:
            return rng.standard_normal(shape).astype(np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)

    pair = [f32(5, 8), f32(5, 8)]
    pm1 = np.float32([1, -1, 1, -1, 1])
    scores = f32(4, 6)
    labels = np.float32([1, 3, 6, 2])
    class_w = f32(6, lo=0.5, hi=2.0)
    ml_x = f32(3, 5)
    ml_t = np.float32([[2, 4, 0, 0, 0], [1, 0, 0, 0, 0], [3, 5, 1, 0, 0]])
    logits = f32(4, 5)
    y5 = np.float32([1, 2, 3, 4])
    ignored = np.float32([1, 2, 2, 4])
    gauss = [f32(4, 3), f32(4, 3, lo=-1.0, hi=1.0)]
    probs = f32(3, 2, 4, 4, lo=0.0, hi=1.0)
    masks = (f32(3, 2, 4, 4, lo=0.0, hi=1.0) > 0.5).astype(np.float32)

    def multi(mod):
        return (mod.MultiCriterion().add(mod.MSECriterion(), 0.5)
                .add(mod.AbsCriterion(), 2.0))

    return {
        "CosineEmbedding": (J.CosineEmbeddingCriterion(0.3),
                            T.CosineEmbeddingCriterion(0.3), pair, pm1),
        "CosineEmbedding_sum": (J.CosineEmbeddingCriterion(-0.2, False),
                                T.CosineEmbeddingCriterion(-0.2, False),
                                pair, pm1),
        "HingeEmbedding": (J.HingeEmbeddingCriterion(1.0),
                           T.HingeEmbeddingCriterion(1.0),
                           np.abs(f32(6)), np.float32([1, -1, 1, -1, -1, 1])),
        "HingeEmbedding_sum": (J.HingeEmbeddingCriterion(2.0, False),
                               T.HingeEmbeddingCriterion(2.0, False),
                               np.abs(f32(6)),
                               np.float32([1, -1, -1, -1, 1, 1])),
        "MarginRanking": (J.MarginRankingCriterion(0.5),
                          T.MarginRankingCriterion(0.5), [f32(5), f32(5)],
                          pm1),
        "MarginRanking_sum": (J.MarginRankingCriterion(0.1, False),
                              T.MarginRankingCriterion(0.1, False),
                              [f32(5), f32(5)], -pm1),
        "MultiMargin_p1": (J.MultiMarginCriterion(1),
                           T.MultiMarginCriterion(1), scores, labels),
        "MultiMargin_p2": (J.MultiMarginCriterion(2),
                           T.MultiMarginCriterion(2), scores, labels),
        "MultiMargin_weighted_sum": (
            J.MultiMarginCriterion(1, class_w, 0.5, False),
            T.MultiMarginCriterion(1, class_w, 0.5, False),
            scores, labels),
        "MultiMargin_1d": (J.MultiMarginCriterion(), T.MultiMarginCriterion(),
                           scores[0], labels[:1]),
        "MultiLabelMargin": (J.MultiLabelMarginCriterion(),
                             T.MultiLabelMarginCriterion(), ml_x, ml_t),
        "MultiLabelMargin_sum_1d": (J.MultiLabelMarginCriterion(False),
                                    T.MultiLabelMarginCriterion(False),
                                    ml_x[2], ml_t[2]),
        "L1Cost": (J.L1Cost(), T.L1Cost(), logits, None),
        "SoftmaxWith": (J.SoftmaxWithCriterion(), T.SoftmaxWithCriterion(),
                        logits, y5),
        "SoftmaxWith_ignore_valid": (J.SoftmaxWithCriterion(2),
                                     T.SoftmaxWithCriterion(2), logits,
                                     ignored),
        "SoftmaxWith_ignore_full": (J.SoftmaxWithCriterion(2, "FULL"),
                                    T.SoftmaxWithCriterion(2, "FULL"),
                                    logits, ignored),
        "SoftmaxWith_batch_size": (J.SoftmaxWithCriterion(None, "BATCH_SIZE"),
                                   T.SoftmaxWithCriterion(None, "BATCH_SIZE"),
                                   logits, y5),
        "SoftmaxWith_none": (J.SoftmaxWithCriterion(4, "NONE"),
                             T.SoftmaxWithCriterion(4, "NONE"), logits, y5),
        "DiceCoefficient": (J.DiceCoefficientCriterion(),
                            T.DiceCoefficientCriterion(), probs, masks),
        "DiceCoefficient_sum_eps": (J.DiceCoefficientCriterion(False, 0.5),
                                    T.DiceCoefficientCriterion(False, 0.5),
                                    probs, masks),
        "MultiCriterion": (multi(J), multi(T), f32(4, 3), f32(4, 3)),
        "KLD": (J.KLDCriterion(), T.KLDCriterion(), gauss, None),
        "KLD_sum": (J.KLDCriterion(False), T.KLDCriterion(False), gauss,
                    None),
        "Gaussian": (J.GaussianCriterion(), T.GaussianCriterion(), gauss,
                     f32(4, 3)),
        "CosineDistance": (J.CosineDistanceCriterion(),
                           T.CosineDistanceCriterion(), pair[0], pair[1]),
        "CosineDistance_sum": (J.CosineDistanceCriterion(False),
                               T.CosineDistanceCriterion(False), pair[0],
                               pair[1]),
        "SoftMargin": (J.SoftMarginCriterion(), T.SoftMarginCriterion(),
                       scores, np.sign(f32(4, 6))),
        "SoftMargin_large_logits_sum": (
            J.SoftMarginCriterion(False), T.SoftMarginCriterion(False),
            np.float32([[80.0, -80.0, 100.0]]), np.float32([[-1, 1, 1]])),
        "CosineProximity": (J.CosineProximityCriterion(),
                            T.CosineProximityCriterion(), pair[0], pair[1]),
        "ClassSimplex": (J.ClassSimplexCriterion(5),
                         T.ClassSimplexCriterion(5), f32(4, 5), y5),
        "ClassSimplex_sum": (J.ClassSimplexCriterion(4, False),
                             T.ClassSimplexCriterion(4, False), f32(4, 4),
                             np.float32([4, 1, 1, 3])),
    }


CASES = sorted(_cases())


@pytest.fixture(scope="module")
def jax_refs():
    """name → (loss, input gradient (a list for a table)) from JAX."""
    out = {}
    for name, (jc, _, x, t) in _cases().items():
        xin = ([jnp.asarray(v) for v in x] if isinstance(x, list)
               else jnp.asarray(x))
        tin = None if t is None else jnp.asarray(t)
        loss, g = jax.jit(jax.value_and_grad(
            lambda v, t, jc=jc: jc.apply(v, t)))(xin, tin)
        out[name] = (float(loss), jax.device_get(g))
    return out


@pytest.mark.parametrize("name", CASES)
def test_criterion_matches_jax(jax_refs, name):
    _, crit, x, t = _cases()[name]
    loss_want, g_want = jax_refs[name]
    loss = crit.forward(x, t)
    assert abs(loss - loss_want) <= 1e-6 * abs(loss_want) + 1e-7, (
        name, loss, loss_want)
    got = crit.backward(x, t)
    gots = got if isinstance(got, list) else [got]
    wants = g_want if isinstance(g_want, list) else [g_want]
    assert len(gots) == len(wants)
    for a, b in zip(gots, wants):
        err = max_rel_err(a.numpy(), b)
        assert err <= 1e-5, f"{name} input grad: {err}"


def test_class_simplex_vertices_equal_jax():
    """The simplex (built with numpy by both) is JAX's, bitwise: unit
    rows with equal pairwise angles."""
    from bigdl_tpu.nn import ClassSimplexCriterion as J
    from bigdl_tpu_torch.nn import ClassSimplexCriterion as T

    for n in (2, 5, 10):
        v = T._build_simplex(n)
        assert np.array_equal(v, J._build_simplex(n))
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0,
                                   rtol=1e-6)
        off = (v @ v.T)[~np.eye(n, dtype=bool)]
        np.testing.assert_allclose(off, off[0], rtol=1e-5)


def test_softmax_with_refuses_unknown_mode():
    from bigdl_tpu_torch.nn import SoftmaxWithCriterion

    with pytest.raises(ValueError, match="normalize_mode"):
        SoftmaxWithCriterion(normalize_mode="MEAN")
