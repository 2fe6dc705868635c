"""The port's ``nn/layers_more.py`` held against the JAX package's on the
CPU, the twin of ``tests/test_layers_more.py``'s layer tests: every layer
with the JAX test's inputs and more (one parametrized case each).

Each case draws its input with numpy from a seed, takes the JAX layer's
params from ``numpy_trees``, loads them into the port's layer and
compares the training-mode output (no generator: the spatial dropouts
are the identity, as JAX's with ``rng=None``), each float input's
gradient and each parameter's gradient (the vector-Jacobian product of
one numpy cotangent; ``NegativeEntropyPenalty`` through its hand-written
backward against ``jax.custom_vjp``'s). Tolerance: every tensor within
1e-5 of JAX's relative to its largest magnitude (f32 rounding); the 3-D
transposed convolution within 1e-4; the Torch7 normalizations
(``SpatialWithinChannelLRN`` and the subtractive, divisive and
contrastive forms) within 1e-4, because they divide by local sums of
81 products per channel taken in another order, then differentiate
through the division and a square root. ``MaskedSelect`` and
``DenseToSparse`` are host-side in JAX (no gradient there): their
outputs are compared exactly. The JAX side runs once, in one
module-scoped fixture.

The spatial dropouts are held within the port: one keep decision per
(sample, channel), the keep rate, the 1 / keep scale, a bitwise repeat
for one seed, and the identity in eval mode and at p = 0.
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

    pair = [_x(2, 3, seed=1), _x(2, 3, seed=2)]
    x3 = _x(2, 3, 4, seed=3)
    seq = _x(2, 7, 4, seed=4)
    img = _x(2, 3, 6, 6, seed=5)
    vol = _x(2, 3, 4, 5, 6, seed=6)
    probs = np.random.default_rng(7).dirichlet(np.ones(5), 3).astype(
        np.float32)
    c = {
        # table / shape
        "Pack_dim1": (J.Pack(1), T.Pack(1), pair),
        "Pack_dim2": (J.Pack(2), T.Pack(2), pair),
        "Pack_single": (J.Pack(2), T.Pack(2), pair[0]),
        "Tile": (J.Tile(2, 3), T.Tile(2, 3), pair[0]),
        "Tile_last": (J.Tile(-1, 2), T.Tile(-1, 2), x3),
        "Reverse": (J.Reverse(1), T.Reverse(1), pair[0]),
        "Reverse_dim3": (J.Reverse(3), T.Reverse(3), x3),
        "InferReshape": (J.InferReshape([-1, 4]), T.InferReshape([-1, 4]),
                         x3),
        "InferReshape_copy": (J.InferReshape([0, -1]),
                              T.InferReshape([0, -1]), x3),
        "InferReshape_batch": (J.InferReshape([-1], batch_mode=True),
                               T.InferReshape([-1], batch_mode=True), x3),
        "BifurcateSplitTable": (J.BifurcateSplitTable(2),
                                T.BifurcateSplitTable(2), _x(3, 8, seed=8)),
        "MixtureTable": (J.MixtureTable(), T.MixtureTable(),
                         [_x(3, 2, seed=9), _x(3, 2, 4, seed=10)]),
        # activations
        "SReLU": (J.SReLU((4,)), T.SReLU((4,)), _x(3, 4, seed=11)),
        "SReLU_shared_axes": (J.SReLU((2, 3, 3), shared_axes=[2, 3]),
                              T.SReLU((2, 3, 3), shared_axes=[2, 3]),
                              _x(2, 2, 3, 3, seed=12)),
        "Maxout": (J.Maxout(5, 3, 2), T.Maxout(5, 3, 2), _x(4, 5, seed=13)),
        "Maxout_no_bias": (J.Maxout(5, 2, 3, with_bias=False),
                           T.Maxout(5, 2, 3, with_bias=False),
                           _x(4, 5, seed=14)),
        # temporal pooling / padding / up-sampling / cropping
        "TemporalMaxPooling": (J.TemporalMaxPooling(2),
                               T.TemporalMaxPooling(2), seq),
        "TemporalMaxPooling_same": (J.TemporalMaxPooling(3, 2, "SAME"),
                                    T.TemporalMaxPooling(3, 2, "SAME"), seq),
        "TemporalMaxPooling_unbatched": (J.TemporalMaxPooling(3, 1),
                                         T.TemporalMaxPooling(3, 1), seq[0]),
        "TemporalAveragePooling": (J.TemporalAveragePooling(2),
                                   T.TemporalAveragePooling(2), seq),
        "TemporalAveragePooling_same": (
            J.TemporalAveragePooling(3, 2, "SAME"),
            T.TemporalAveragePooling(3, 2, "SAME"), seq),
        "TemporalAveragePooling_same_stride1": (
            J.TemporalAveragePooling(4, 1, "SAME"),
            T.TemporalAveragePooling(4, 1, "SAME"), seq[1]),
        "VolumetricZeroPadding": (J.VolumetricZeroPadding(1, 2, 1),
                                  T.VolumetricZeroPadding(1, 2, 1), vol),
        "UpSampling1D": (J.UpSampling1D(3), T.UpSampling1D(3), seq),
        "UpSampling3D": (J.UpSampling3D((2, 1, 3)),
                         T.UpSampling3D((2, 1, 3)), vol),
        "Cropping2D": (J.Cropping2D((1, 0), (2, 1)),
                       T.Cropping2D((1, 0), (2, 1)), img),
        "Cropping2D_nhwc": (J.Cropping2D((0, 2), (1, 1), "NHWC"),
                            T.Cropping2D((0, 2), (1, 1), "NHWC"),
                            img.transpose(0, 2, 3, 1).copy()),
        "Cropping3D": (J.Cropping3D((1, 0), (0, 1), (1, 2)),
                       T.Cropping3D((1, 0), (0, 1), (1, 2)), vol),
        # convolutions
        "LocallyConnected2D": (J.LocallyConnected2D(2, 6, 5, 3, 3, 2),
                               T.LocallyConnected2D(2, 6, 5, 3, 3, 2),
                               _x(1, 2, 5, 6, seed=15)),
        "LocallyConnected2D_strided_padded": (
            J.LocallyConnected2D(3, 6, 6, 4, 3, 3, 2, 2, 1, 1),
            T.LocallyConnected2D(3, 6, 6, 4, 3, 3, 2, 2, 1, 1), img),
        "LocallyConnected2D_no_bias_chw": (
            J.LocallyConnected2D(3, 6, 6, 2, 2, 3, with_bias=False),
            T.LocallyConnected2D(3, 6, 6, 2, 2, 3, with_bias=False), img[1]),
        "LocallyConnected1D": (J.LocallyConnected1D(7, 4, 3, 3, 2),
                               T.LocallyConnected1D(7, 4, 3, 3, 2), seq),
        "LocallyConnected1D_unbatched_no_bias": (
            J.LocallyConnected1D(7, 4, 5, 2, with_bias=False),
            T.LocallyConnected1D(7, 4, 5, 2, with_bias=False), seq[0]),
        "SpatialShareConvolution": (
            J.SpatialShareConvolution(3, 5, 3, 3, 1, 1, 1, 1),
            T.SpatialShareConvolution(3, 5, 3, 3, 1, 1, 1, 1), img),
        "SpatialSeparableConvolution": (
            J.SpatialSeparableConvolution(3, 8, 2, 3, 3, p_w=1, p_h=1),
            T.SpatialSeparableConvolution(3, 8, 2, 3, 3, p_w=1, p_h=1), img),
        "SpatialSeparableConvolution_strided_no_bias": (
            J.SpatialSeparableConvolution(3, 4, 1, 2, 3, 2, 1,
                                          with_bias=False),
            T.SpatialSeparableConvolution(3, 4, 1, 2, 3, 2, 1,
                                          with_bias=False), img[0]),
        "SpatialConvolutionMap_full": (
            J.SpatialConvolutionMap(J.SpatialConvolutionMap.full(3, 4), 3, 3,
                                    pad_w=1, pad_h=1),
            T.SpatialConvolutionMap(T.SpatialConvolutionMap.full(3, 4), 3, 3,
                                    pad_w=1, pad_h=1), img),
        "SpatialConvolutionMap_one_to_one": (
            J.SpatialConvolutionMap(J.SpatialConvolutionMap.one_to_one(3),
                                    3, 3, pad_w=1, pad_h=1),
            T.SpatialConvolutionMap(T.SpatialConvolutionMap.one_to_one(3),
                                    3, 3, pad_w=1, pad_h=1), img),
        "SpatialConvolutionMap_random_strided": (
            J.SpatialConvolutionMap(J.SpatialConvolutionMap.random(
                3, 4, fan_in=2), 2, 3, 2, 1),
            T.SpatialConvolutionMap(T.SpatialConvolutionMap.random(
                3, 4, fan_in=2), 2, 3, 2, 1), img[0]),
        # dropout without a generator, penalty
        "SpatialDropout1D_no_generator": (J.SpatialDropout1D(0.5),
                                          T.SpatialDropout1D(0.5), seq),
        "SpatialDropout2D_no_generator": (J.SpatialDropout2D(0.5),
                                          T.SpatialDropout2D(0.5), img),
        "SpatialDropout3D_no_generator": (J.SpatialDropout3D(0.5),
                                          T.SpatialDropout3D(0.5), vol),
        "NegativeEntropyPenalty": (J.NegativeEntropyPenalty(0.1),
                                   T.NegativeEntropyPenalty(0.1), probs),
    }
    out = {k: (j, t, x, 1e-5) for k, (j, t, x) in c.items()}
    k1 = np.float32([1.0, 2.0, 1.0])
    own = {
        "VolumetricFullConvolution": (
            J.VolumetricFullConvolution(3, 4, 2, 3, 3, d_t=2, d_w=1, d_h=2,
                                        pad_t=1, pad_w=1, pad_h=0),
            T.VolumetricFullConvolution(3, 4, 2, 3, 3, d_t=2, d_w=1, d_h=2,
                                        pad_t=1, pad_w=1, pad_h=0), vol),
        "VolumetricFullConvolution_adj_groups_no_bias": (
            J.VolumetricFullConvolution(4, 2, 3, 2, 2, 2, 2, 1, adj_t=1,
                                        adj_w=1, n_group=2, no_bias=True),
            T.VolumetricFullConvolution(4, 2, 3, 2, 2, 2, 2, 1, adj_t=1,
                                        adj_w=1, n_group=2, no_bias=True),
            _x(4, 3, 3, 3, seed=16)),
        "SpatialWithinChannelLRN": (J.SpatialWithinChannelLRN(3),
                                    T.SpatialWithinChannelLRN(3), img),
        "SpatialWithinChannelLRN_even": (
            J.SpatialWithinChannelLRN(4, 0.5, 0.6),
            T.SpatialWithinChannelLRN(4, 0.5, 0.6), img[0]),
        "SpatialSubtractiveNormalization": (
            J.SpatialSubtractiveNormalization(3),
            T.SpatialSubtractiveNormalization(3), _x(2, 3, 10, 10, seed=17)),
        "SpatialSubtractiveNormalization_1d_kernel": (
            J.SpatialSubtractiveNormalization(3, k1),
            T.SpatialSubtractiveNormalization(3, k1), img),
        "SpatialDivisiveNormalization": (
            J.SpatialDivisiveNormalization(1),
            T.SpatialDivisiveNormalization(1), _x(2, 1, 10, 10, seed=18)),
        "SpatialDivisiveNormalization_kernel": (
            J.SpatialDivisiveNormalization(3, np.ones((3, 4), np.float32)),
            T.SpatialDivisiveNormalization(3, np.ones((3, 4), np.float32)),
            img),
        "SpatialContrastiveNormalization": (
            J.SpatialContrastiveNormalization(1),
            T.SpatialContrastiveNormalization(1), _x(2, 1, 9, 9, seed=19)),
        "SpatialContrastiveNormalization_1d_kernel_chw": (
            J.SpatialContrastiveNormalization(3, k1, 0.05, 0.5),
            T.SpatialContrastiveNormalization(3, k1, 0.05, 0.5), img[0]),
    }
    out.update({k: (j, t, x, 1e-4) for k, (j, t, x) in own.items()})
    return out


CASES = sorted(_cases())


@pytest.fixture(scope="module")
def jax_refs():
    return layer_vjp_refs(_cases())


@pytest.mark.parametrize("name", CASES)
def test_layer_matches_jax(jax_refs, name):
    _, layer, x, tol = _cases()[name]
    check_layer(name, layer, x, jax_refs[name], tol)


def _host_side_cases():
    rng = np.random.default_rng(20)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    mask = (rng.uniform(size=(3, 4)) > 0.5).astype(np.float32)
    sparse = x * mask
    return {"MaskedSelect": ([x, mask], None),
            "MaskedSelect_int_mask": ([x, mask.astype(np.int32)], None),
            "DenseToSparse": (sparse, None),
            "DenseToSparse_capacity": (sparse, 16)}


@pytest.mark.parametrize("name", sorted(_host_side_cases()))
def test_host_side_layers_match_jax(name):
    """``MaskedSelect`` and ``DenseToSparse``: JAX's host-side outputs
    (the selected values; the COO indices, values and shape) exactly."""
    import jax.numpy as jnp

    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    x, cap = _host_side_cases()[name]
    if name.startswith("MaskedSelect"):
        want = np.asarray(J.MaskedSelect().apply({}, [jnp.asarray(v)
                                                     for v in x])[0])
        got = T.MaskedSelect()([torch.from_numpy(v) for v in x])
        assert np.array_equal(got.numpy(), want)
        return
    want = J.DenseToSparse(cap).apply({}, jnp.asarray(x))[0]
    got = T.DenseToSparse(cap)(torch.from_numpy(x))
    assert got.shape == want.shape
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert np.array_equal(got.values.numpy(), np.asarray(want.values))
    assert np.array_equal(got.to_dense().numpy(), x)


def test_mixture_table_of_expert_tables_matches_jax():
    """``MixtureTable`` with the experts as a table of E tensors (JAX
    stacks them), forward and every input's gradient."""
    import jax
    import jax.numpy as jnp

    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    g, e1, e2 = _x(3, 2, seed=21), _x(3, 4, seed=22), _x(3, 4, seed=23)
    ct = _x(3, 4, seed=24)
    want, pull = jax.vjp(lambda a, b, c: J.MixtureTable().apply(
        {}, [a, [b, c]])[0], *map(jnp.asarray, (g, e1, e2)))
    ins = [torch.from_numpy(v).requires_grad_() for v in (g, e1, e2)]
    got = T.MixtureTable()([ins[0], [ins[1], ins[2]]])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    grads = torch.autograd.grad(got, ins, torch.from_numpy(ct))
    for a, b in zip(grads, pull(jnp.asarray(ct))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_connection_tables_equal_jax():
    """``SpatialConvolutionMap``'s table constructors give JAX's tables."""
    from bigdl_tpu.nn import SpatialConvolutionMap as JMap
    from bigdl_tpu_torch.nn import SpatialConvolutionMap as TMap

    assert np.array_equal(TMap.full(3, 4), JMap.full(3, 4))
    assert np.array_equal(TMap.one_to_one(5), JMap.one_to_one(5))
    for seed in (0, 3):
        t = TMap.random(6, 4, fan_in=2, seed=seed)
        assert np.array_equal(t, JMap.random(6, 4, fan_in=2, seed=seed))
        assert t.shape == (8, 2) and t[:, 0].max() <= 6


@pytest.mark.parametrize("case", ["subtractive_constant_image",
                                  "divisive_scale_invariance",
                                  "divisive_thresval"])
def test_local_normalization_closed_forms(case):
    """The JAX tests' closed forms (``tests/test_layers_more.py:302-333``,
    ``:466``) on the port: a constant image subtracts to 0 (the border
    correction makes the local mean exact), the divisive form cancels a
    global scale, and a deviation below the threshold is replaced."""
    from bigdl_tpu_torch import nn as T

    if case == "subtractive_constant_image":
        x = torch.full((1, 3, 8, 8), 5.0)
        out = T.SpatialSubtractiveNormalization(3)(x)
        assert float(out.abs().max()) < 1e-4
    elif case == "divisive_scale_invariance":
        x = torch.from_numpy(_x(1, 1, 10, 10, seed=25))
        m = T.SpatialDivisiveNormalization(1)
        np.testing.assert_allclose(m(x).numpy(), m(x * 10.0).numpy(),
                                   atol=1e-3)
    else:
        x = torch.full((1, 1, 9, 9), 1e-6)
        out = T.SpatialDivisiveNormalization(1, threshold=1e-4,
                                             thresval=1.5)(x)
        np.testing.assert_allclose(out.numpy(), (x / 1.5).numpy(),
                                   atol=1e-9)


def _per_channel(o):
    """One value per (sample, channel): NC... maps and NC tables."""
    return o.flatten(2).amax(-1) == o.flatten(2).amin(-1)


def _per_last_channel(o):
    """One value per (sample, last-axis channel)."""
    flat = o.reshape(o.shape[0], -1, o.shape[-1])
    return flat.amax(1) == flat.amin(1)


@pytest.mark.parametrize("kind,fmt,shape,per", [
    ("SpatialDropout1D", None, (40, 30, 50), _per_last_channel),
    ("SpatialDropout2D", "NCHW", (40, 50, 5, 6), _per_channel),
    ("SpatialDropout2D", "NHWC", (40, 5, 6, 50), _per_last_channel),
    ("SpatialDropout3D", "NCDHW", (40, 50, 2, 3, 3), _per_channel),
    ("SpatialDropout3D", "NDHWC", (40, 2, 3, 3, 50), _per_last_channel),
])
def test_spatial_dropout_within_the_port(kind, fmt, shape, per):
    """One keep decision per (sample, channel) over the spatial axes (the
    channel axis after the batch, or last for the channels-last forms),
    kept values scaled by 1 / keep, the keep rate, a bitwise repeat per
    seed, and the identity in eval mode, at p = 0 and with no
    generator."""
    from bigdl_tpu_torch import nn as T
    from bigdl_tpu_torch.nn.module import use_rng

    def make(p):
        return getattr(T, kind)(p) if fmt is None else getattr(T, kind)(
            p, fmt)

    x = torch.ones(shape)
    layer = make(0.3)

    def drawn(seed, m=layer):
        with use_rng(torch.Generator().manual_seed(seed)):
            return m.train()(x)

    out = drawn(1)
    assert bool(per(out).all())
    assert set(torch.unique(out).tolist()) <= {0.0, np.float32(1 / 0.7)}
    assert abs(float((out > 0).float().mean()) - 0.7) < 0.03
    assert torch.equal(drawn(1), out)
    assert not torch.equal(drawn(2), out)
    assert torch.equal(layer.train()(x), x)
    assert torch.equal(layer.eval()(x), x)
    assert torch.equal(drawn(1, make(0.0)), x)
