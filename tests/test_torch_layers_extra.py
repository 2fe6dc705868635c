"""The port's ``nn/layers_extra.py`` held against the JAX package's on
the CPU, the twin of ``tests/test_layers_extra.py``: every layer with
the JAX test's inputs and more (one parametrized case each).

Each case draws its input with numpy from a seed, takes the JAX layer's
params from ``numpy_trees``, loads them into the port's layer and
compares the training-mode output (no generator: ``RReLU`` takes its
midpoint slope, ``GaussianSampler`` returns the mean, the noise layers
the input, as JAX's with ``rng=None``), each float input's gradient and
each parameter's gradient (the vector-Jacobian product of one numpy
cotangent; ``GradientReversal`` and ``L1Penalty`` through their
hand-written backward against ``jax.custom_vjp``'s). Tolerance: every
tensor within 1e-5 of JAX's relative to its largest magnitude (f32
rounding; sums in other orders); the 3-D convolutions and poolings
within 1e-4 (sums of up to 54 products per output in another order, and
their backward). The JAX side runs once, in one module-scoped fixture.

The random layers are held within the port, drawing from the generator
that ``use_rng`` makes current: ``RReLU``'s slopes in [lower, upper]
with their mean, the noise layers' scale, ``GaussianSampler``'s spread,
and a bitwise repeat for one seed (another seed draws otherwise).
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    check_layer, layer_vjp_refs, one_torch_thread,
)


def _x(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _cases():
    """name → (JAX layer, port layer, input, tol)."""
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    x2, x4 = _x(4, 6), _x(2, 3, 5, 4, seed=1)
    pair = [_x(4, 7, seed=2), _x(4, 7, seed=3)]
    trio = [_x(2, 2, seed=4), _x(2, 2, seed=5), _x(2, 2, seed=6)]
    seq = np.stack([_x(3, 4, seed=7)] * 2)
    seq[:, 1] = 0.0                                 # a masked time step
    vol = _x(2, 2, 6, 6, 6, seed=8)
    img = _x(2, 3, 5, 5, seed=9)
    c = {
        # similarity / distance
        "Cosine": (J.Cosine(6, 4), T.Cosine(6, 4), _x(3, 6, seed=10)),
        "Euclidean": (J.Euclidean(5, 3), T.Euclidean(5, 3),
                      _x(4, 5, seed=11)),
        "DotProduct": (J.DotProduct(), T.DotProduct(), pair),
        "PairwiseDistance_p2": (J.PairwiseDistance(2),
                                T.PairwiseDistance(2), pair),
        "PairwiseDistance_p1": (J.PairwiseDistance(1),
                                T.PairwiseDistance(1), pair),
        "CosineDistance": (J.CosineDistance(), T.CosineDistance(), pair),
        # activations
        "SoftMin": (J.SoftMin(), T.SoftMin(), x2),
        "LogSigmoid": (J.LogSigmoid(), T.LogSigmoid(), 4 * x2),
        "Threshold": (J.Threshold(0.2, -1.0), T.Threshold(0.2, -1.0), x2),
        "RReLU_no_generator": (J.RReLU(), T.RReLU(), x2),
        "HardSigmoid": (J.HardSigmoid(), T.HardSigmoid(), 4 * x2),
        "TanhShrink": (J.TanhShrink(), T.TanhShrink(), x2),
        "SoftShrink": (J.SoftShrink(0.3), T.SoftShrink(0.3), x2),
        "HardShrink": (J.HardShrink(0.3), T.HardShrink(0.3), x2),
        # table / shape
        "Replicate": (J.Replicate(4, 1), T.Replicate(4, 1), _x(2, 3)),
        "Replicate_dim2": (J.Replicate(3, 2), T.Replicate(3, 2), x4),
        "Index": (J.Index(1), T.Index(1),
                  [_x(3, 4, seed=12), np.int32([2, 1, 3])]),
        "Index_dim2": (J.Index(2), T.Index(2),
                       [_x(2, 5, seed=13), np.int32([5, 1])]),
        "Masking": (J.Masking(0.0), T.Masking(0.0), seq),
        "SelectTable": (J.SelectTable(2), T.SelectTable(2), trio),
        "SelectTable_last": (J.SelectTable(-1), T.SelectTable(-1), trio),
        "NarrowTable": (J.NarrowTable(2, 2), T.NarrowTable(2, 2), trio),
        "SpatialZeroPadding": (J.SpatialZeroPadding(1, 2, 1, 0),
                               T.SpatialZeroPadding(1, 2, 1, 0), img),
        "SpatialZeroPadding_crop": (J.SpatialZeroPadding(-1, -1, -1, -1),
                                    T.SpatialZeroPadding(-1, -1, -1, -1),
                                    img),
        "SpatialZeroPadding_mixed_chw": (J.SpatialZeroPadding(2, -1, -2, 1),
                                         T.SpatialZeroPadding(2, -1, -2, 1),
                                         img[0]),
        "Scale": (J.Scale((3,)), T.Scale((3,)), _x(2, 3, 4, 4, seed=14)),
        "Negative": (J.Negative(), T.Negative(), x2),
        # gradient and noise layers
        "GradientReversal": (J.GradientReversal(0.5),
                             T.GradientReversal(0.5), _x(3, 4, seed=15)),
        "L1Penalty": (J.L1Penalty(0.1), T.L1Penalty(0.1), _x(3, 4, seed=16)),
        "L1Penalty_size_average": (J.L1Penalty(0.1, True),
                                   T.L1Penalty(0.1, True),
                                   _x(3, 4, seed=16)),
        "GaussianSampler_no_generator": (
            J.GaussianSampler(), T.GaussianSampler(),
            [_x(5, 2, seed=17), _x(5, 2, seed=18, scale=0.3)]),
        "GaussianNoise_no_generator": (J.GaussianNoise(0.5),
                                       T.GaussianNoise(0.5), x2),
        "GaussianDropout_no_generator": (J.GaussianDropout(0.2),
                                         T.GaussianDropout(0.2), x2),
        # temporal / dilated convolution, up-sampling, bilinear
        "TemporalConvolution": (J.TemporalConvolution(5, 8, 3, 2),
                                T.TemporalConvolution(5, 8, 3, 2),
                                _x(2, 9, 5, seed=19)),
        "TemporalConvolution_unbatched": (J.TemporalConvolution(5, 4, 2),
                                          T.TemporalConvolution(5, 4, 2),
                                          _x(7, 5, seed=20)),
        "SpatialDilatedConvolution": (
            J.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, 2, 2),
            T.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, 2, 2),
            _x(2, 3, 8, 8, seed=21)),
        "SpatialDilatedConvolution_strided_no_bias": (
            J.SpatialDilatedConvolution(3, 4, 3, 2, 2, 1, 1, 0, 1, 2,
                                        with_bias=False),
            T.SpatialDilatedConvolution(3, 4, 3, 2, 2, 1, 1, 0, 1, 2,
                                        with_bias=False),
            _x(3, 9, 7, seed=22)),
        "SpatialUpSamplingNearest": (J.SpatialUpSamplingNearest(2),
                                     T.SpatialUpSamplingNearest(2),
                                     _x(2, 3, 4, 4, seed=23)),
        "SpatialUpSamplingBilinear": (J.SpatialUpSamplingBilinear(2),
                                      T.SpatialUpSamplingBilinear(2),
                                      _x(2, 3, 4, 4, seed=24)),
        "SpatialUpSamplingBilinear_x3_chw": (J.SpatialUpSamplingBilinear(3),
                                             T.SpatialUpSamplingBilinear(3),
                                             _x(3, 4, 5, seed=25)),
        "Bilinear": (J.Bilinear(5, 6, 3), T.Bilinear(5, 6, 3),
                     [_x(4, 5, seed=26), _x(4, 6, seed=27)]),
        "Bilinear_no_bias": (J.Bilinear(5, 6, 3, bias_res=False),
                             T.Bilinear(5, 6, 3, bias_res=False),
                             [_x(4, 5, seed=26), _x(4, 6, seed=27)]),
    }
    out = {k: (j, t, x, 1e-5) for k, (j, t, x) in c.items()}
    # 3-D convolution and pooling: their own bound (see the docstring)
    three_d = {
        "VolumetricConvolution": (
            J.VolumetricConvolution(2, 4, 3, 3, 3, 1, 1, 1, 1, 1, 1),
            T.VolumetricConvolution(2, 4, 3, 3, 3, 1, 1, 1, 1, 1, 1), vol),
        "VolumetricConvolution_strided_no_bias": (
            J.VolumetricConvolution(2, 3, 2, 3, 2, 2, 1, 2, 0, 1, 1,
                                    with_bias=False),
            T.VolumetricConvolution(2, 3, 2, 3, 2, 2, 1, 2, 0, 1, 1,
                                    with_bias=False), vol[0]),
        "VolumetricMaxPooling": (J.VolumetricMaxPooling(2, 2, 2),
                                 T.VolumetricMaxPooling(2, 2, 2), vol),
        "VolumetricMaxPooling_padded": (
            J.VolumetricMaxPooling(3, 3, 3, 2, 2, 2, 1, 1, 1),
            T.VolumetricMaxPooling(3, 3, 3, 2, 2, 2, 1, 1, 1), vol),
        "VolumetricAveragePooling": (J.VolumetricAveragePooling(2, 2, 2),
                                     T.VolumetricAveragePooling(2, 2, 2),
                                     vol),
        "VolumetricAveragePooling_padded": (
            J.VolumetricAveragePooling(3, 2, 3, 2, 1, 2, 1, 0, 1),
            T.VolumetricAveragePooling(3, 2, 3, 2, 1, 2, 1, 0, 1), vol[1]),
    }
    out.update({k: (j, t, x, 1e-4) for k, (j, t, x) in three_d.items()})
    return out


CASES = sorted(_cases())


@pytest.fixture(scope="module")
def jax_refs():
    return layer_vjp_refs(_cases())


@pytest.mark.parametrize("name", CASES)
def test_layer_matches_jax(jax_refs, name):
    _, layer, x, tol = _cases()[name]
    check_layer(name, layer, x, jax_refs[name], tol)


def test_similarity_helpers_match_jax():
    """``l2_normalize`` and ``cosine_similarity`` (with a zero row, where
    the clamp decides) against JAX's, along either axis."""
    import jax.numpy as jnp

    from bigdl_tpu.nn import layers_extra as jle
    from bigdl_tpu_torch.nn import layers_extra as tle

    x, y = _x(4, 5, seed=30), _x(4, 5, seed=31)
    x[2] = 0.0
    for axis in (-1, 0):
        np.testing.assert_allclose(
            tle.l2_normalize(torch.from_numpy(x), axis).numpy(),
            np.asarray(jle.l2_normalize(jnp.asarray(x), axis)), rtol=1e-6,
            atol=1e-7)
        np.testing.assert_allclose(
            tle.cosine_similarity(torch.from_numpy(x), torch.from_numpy(y),
                                  axis).numpy(),
            np.asarray(jle.cosine_similarity(jnp.asarray(x), jnp.asarray(y),
                                             axis)), rtol=1e-6, atol=1e-7)


def _drawn(layer, x, seed):
    """``layer``'s training forward with a generator seeded ``seed``."""
    from bigdl_tpu_torch.nn.module import use_rng

    with use_rng(torch.Generator().manual_seed(seed)):
        return layer.train()(x)


@pytest.mark.parametrize("kind", ["RReLU", "GaussianNoise", "GaussianDropout",
                                  "GaussianSampler"])
def test_random_layers_within_the_port(kind):
    """The draws' law per layer, a bitwise repeat per seed, another
    draw for another seed, and the deterministic form in eval mode (the
    sampler: with no generator)."""
    from bigdl_tpu_torch import nn as T

    ones = torch.ones(4000, 8)
    if kind == "RReLU":
        layer, x = T.RReLU(0.1, 0.3), -ones
        out = _drawn(layer, x, 1)
        slopes = -out
        assert float(slopes.min()) >= 0.1 and float(slopes.max()) <= 0.3
        assert abs(float(slopes.mean()) - 0.2) < 0.005
        assert torch.equal(layer.eval()(x), -0.2 * ones)
        assert torch.equal(_drawn(layer, ones, 1), ones)  # x >= 0 kept
    elif kind == "GaussianNoise":
        layer, x = T.GaussianNoise(0.5), ones
        out = _drawn(layer, x, 1)
        assert abs(float((out - 1).std()) - 0.5) < 0.01
        assert abs(float((out - 1).mean())) < 0.01
        assert torch.equal(layer.eval()(x), x)
    elif kind == "GaussianDropout":
        layer, x = T.GaussianDropout(0.2), ones
        out = _drawn(layer, x, 1)
        assert abs(float(out.mean()) - 1.0) < 0.01
        assert abs(float(out.std()) - 0.5) < 0.01          # sqrt(.2 / .8)
        assert torch.equal(layer.eval()(x), x)
        assert torch.equal(_drawn(T.GaussianDropout(0.0), x, 1), x)
    else:
        layer = T.GaussianSampler()
        x = [torch.zeros(4000, 8), torch.full((4000, 8), float(np.log(0.25)))]
        out = _drawn(layer, x, 1)
        assert abs(float(out.std()) - 0.5) < 0.01
        assert torch.equal(layer(x), x[0])
    assert torch.equal(_drawn(layer, x, 1), out)
    assert not torch.equal(_drawn(layer, x, 2), out)


def test_gradient_reversal_and_l1_penalty_through_the_facade():
    """``backward`` (the module facade) of the two hand-written gradients,
    as JAX's ``tests/test_layers_extra.py:129`` drives them."""
    from bigdl_tpu_torch.nn import GradientReversal, L1Penalty

    x, g = _x(3, 4, seed=40), _x(3, 4, seed=41)
    m = GradientReversal(0.5)
    assert np.array_equal(m.update_output(x).numpy(), x)
    np.testing.assert_allclose(m.backward(x, g).numpy(), -0.5 * g, atol=1e-7)
    p = L1Penalty(0.1)
    np.testing.assert_allclose(p.backward(x, g).numpy(),
                               g + 0.1 * np.sign(x), atol=1e-7)
