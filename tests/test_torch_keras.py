"""The port's Keras API (``bigdl_tpu_torch/nn/keras.py``) held against the
JAX package's ``bigdl_tpu/nn/keras.py`` on the CPU.

Every Keras class runs in a one-layer Keras ``Sequential`` (``Merge`` and
the functional API through ``Model``), built from the same calls in both
packages. The JAX model's params and state come from ``numpy_trees`` and
load into the port's unchanged (``load_jax_tree`` walks through a Keras
layer to its core, as JAX's tree has no level for it); each case compares
the inferred output shape, the training-mode output without a generator
(the noise and dropout layers are then the identity, as JAX's with
``rng=None``), each float input's gradient and each parameter's gradient
(one numpy cotangent; BatchNormalization on its batch statistics).
Tolerances, relative to each tensor's largest magnitude: 1e-5 for the
element-wise, pooling and shape layers, 1e-4 for layers with products,
convolutions or recurrences. The JAX side runs once, in one
module-scoped fixture.

Besides: ``Merge``'s concat axis (axis 0 refused), 0-based ``Embedding``
ids, the refusals JAX makes, one SGD step of a Keras ``Sequential``
against JAX's, a two-block Keras ResNet (8 channels, 16²) through
``Model``, forward and one SGD step against JAX's, and placement (a
layer takes its container's or its input node's device and generator,
or raises without a card).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    check_layer, layer_vjp_refs, max_rel_err, numpy_trees, one_torch_thread,
)


def _x(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ids(*shape, high=10, seed=0):
    return np.random.default_rng(seed).integers(0, high, shape).astype(
        np.int32)


# name -> (build(K) -> keras layer with input_shape, input, tol)
_ELEMENT, _PRODUCT = 1e-5, 1e-4


def _layer_cases():
    seq, img, vol = _x(2, 8, 4, seed=1), _x(2, 3, 8, 8, seed=2), \
        _x(2, 3, 4, 6, 8, seed=3)
    vec = _x(3, 6, seed=4)
    c = {
        "Dense": (lambda K: K.Dense(4, activation="relu",
                                    input_shape=(6,)), vec, _PRODUCT),
        "Dense_no_bias": (lambda K: K.Dense(4, bias=False,
                                            input_shape=(6,)), vec, _PRODUCT),
        "Dense_3d": (lambda K: K.Dense(5, activation="tanh",
                                       input_shape=(8, 4)), seq, _PRODUCT),
        "Activation_tanh": (lambda K: K.Activation(
            "tanh", input_shape=(6,)), vec, _ELEMENT),
        "Activation_softmax": (lambda K: K.Activation(
            "softmax", input_shape=(6,)), vec, _ELEMENT),
        "Activation_log_softmax": (lambda K: K.Activation(
            "log_softmax", input_shape=(6,)), vec, _ELEMENT),
        "Dropout": (lambda K: K.Dropout(0.5, input_shape=(6,)), vec,
                    _ELEMENT),
        "Flatten": (lambda K: K.Flatten(input_shape=(3, 8, 8)), img,
                    _ELEMENT),
        "Reshape": (lambda K: K.Reshape((4, 8), input_shape=(8, 4)), seq,
                    _ELEMENT),
        "Convolution2D": (lambda K: K.Convolution2D(
            4, 3, 3, input_shape=(3, 8, 8)), img, _PRODUCT),
        "Convolution2D_same_strided": (lambda K: K.Convolution2D(
            4, 3, 2, subsample=(2, 2), border_mode="same", activation="relu",
            input_shape=(3, 8, 8)), img, _PRODUCT),
        "MaxPooling2D": (lambda K: K.MaxPooling2D(
            (2, 2), input_shape=(3, 8, 8)), img, _ELEMENT),
        "MaxPooling2D_strided": (lambda K: K.MaxPooling2D(
            (3, 3), strides=(2, 2), input_shape=(3, 8, 8)), img, _ELEMENT),
        "AveragePooling2D_same": (lambda K: K.AveragePooling2D(
            (2, 2), border_mode="same", input_shape=(3, 9, 9)),
            _x(2, 3, 9, 9, seed=5), _ELEMENT),
        "BatchNormalization_spatial": (lambda K: K.BatchNormalization(
            input_shape=(3, 8, 8)), img, _ELEMENT),
        "BatchNormalization_vector": (lambda K: K.BatchNormalization(
            epsilon=1e-5, momentum=0.9, input_shape=(6,)), vec, _ELEMENT),
        "Embedding": (lambda K: K.Embedding(10, 4, input_shape=(5,)),
                      _ids(2, 5), _ELEMENT),
        "LSTM": (lambda K: K.LSTM(6, input_shape=(8, 4)), seq, _PRODUCT),
        "LSTM_sequences": (lambda K: K.LSTM(
            6, return_sequences=True, input_shape=(8, 4)), seq, _PRODUCT),
        "GRU_keras1": (lambda K: K.GRU(5, input_shape=(8, 4)), seq,
                       _PRODUCT),
        "SimpleRNN": (lambda K: K.SimpleRNN(
            5, return_sequences=True, input_shape=(8, 4)), seq, _PRODUCT),
        "ZeroPadding2D": (lambda K: K.ZeroPadding2D(
            (1, 2), input_shape=(3, 8, 8)), img, _ELEMENT),
        "UpSampling2D": (lambda K: K.UpSampling2D(
            (2, 2), input_shape=(3, 8, 8)), img, _ELEMENT),
        "GlobalAveragePooling2D": (lambda K: K.GlobalAveragePooling2D(
            input_shape=(3, 8, 8)), img, _ELEMENT),
        "Highway": (lambda K: K.Highway(input_shape=(6,)), vec, _PRODUCT),
        "Highway_tanh": (lambda K: K.Highway(
            activation="tanh", input_shape=(6,)), vec, _PRODUCT),
        "Bidirectional_concat": (lambda K: K.Bidirectional(
            K.LSTM(4, return_sequences=True), input_shape=(8, 4)), seq,
            _PRODUCT),
        "Bidirectional_sum_gru": (lambda K: K.Bidirectional(
            K.GRU(4, return_sequences=True), merge_mode="sum",
            input_shape=(8, 4)), seq, _PRODUCT),
        "TimeDistributed": (lambda K: K.TimeDistributed(
            K.Dense(3), input_shape=(8, 4)), seq, _PRODUCT),
        "Convolution1D": (lambda K: K.Convolution1D(
            5, 3, activation="relu", input_shape=(8, 4)), seq, _PRODUCT),
        "Convolution1D_same_strided": (lambda K: K.Convolution1D(
            5, 4, border_mode="same", subsample_length=2,
            input_shape=(8, 4)), seq, _PRODUCT),
        "SeparableConvolution2D": (lambda K: K.SeparableConvolution2D(
            5, 3, 3, depth_multiplier=2, border_mode="same",
            input_shape=(3, 8, 8)), img, _PRODUCT),
        "LocallyConnected1D": (lambda K: K.LocallyConnected1D(
            4, 3, input_shape=(8, 4)), seq, _PRODUCT),
        "LocallyConnected2D": (lambda K: K.LocallyConnected2D(
            3, 2, 3, subsample=(2, 1), input_shape=(3, 8, 8)), img,
            _PRODUCT),
        "Cropping1D": (lambda K: K.Cropping1D(
            (1, 2), input_shape=(8, 4)), seq, _ELEMENT),
        "Cropping2D": (lambda K: K.Cropping2D(
            (1, 1), (2, 0), input_shape=(3, 8, 8)), img, _ELEMENT),
        "Cropping3D": (lambda K: K.Cropping3D(
            (1, 0), (0, 1), (1, 1), input_shape=(3, 4, 6, 8)), vol,
            _ELEMENT),
        "Permute": (lambda K: K.Permute(
            (2, 3, 1), input_shape=(3, 8, 8)), img, _ELEMENT),
        "RepeatVector": (lambda K: K.RepeatVector(4, input_shape=(6,)),
                         vec, _ELEMENT),
        "MaxoutDense": (lambda K: K.MaxoutDense(3, 4, input_shape=(6,)),
                        vec, _PRODUCT),
        "ThresholdedReLU": (lambda K: K.ThresholdedReLU(
            0.5, input_shape=(6,)), vec, _ELEMENT),
        "SReLU": (lambda K: K.SReLU(input_shape=(6,)), vec, _ELEMENT),
        "SReLU_shared": (lambda K: K.SReLU(
            shared_axes=[2, 3], input_shape=(3, 8, 8)), img, _ELEMENT),
        "GaussianNoise": (lambda K: K.GaussianNoise(
            0.3, input_shape=(8, 4)), seq, _ELEMENT),
        "GaussianDropout": (lambda K: K.GaussianDropout(
            0.5, input_shape=(8, 4)), seq, _ELEMENT),
        "SpatialDropout1D": (lambda K: K.SpatialDropout1D(
            0.5, input_shape=(8, 4)), seq, _ELEMENT),
        "SpatialDropout2D": (lambda K: K.SpatialDropout2D(
            0.5, input_shape=(3, 8, 8)), img, _ELEMENT),
        "SpatialDropout3D": (lambda K: K.SpatialDropout3D(
            0.5, input_shape=(3, 4, 6, 8)), vol, _ELEMENT),
        "Masking": (lambda K: K.Masking(0.0, input_shape=(8, 4)),
                    np.where(np.arange(8)[None, :, None] % 3 == 0, 0.0,
                             seq).astype(np.float32), _ELEMENT),
        "LeakyReLU": (lambda K: K.LeakyReLU(0.1, input_shape=(6,)), vec,
                      _ELEMENT),
        "ELU": (lambda K: K.ELU(0.7, input_shape=(6,)), vec, _ELEMENT),
        "MaxPooling1D": (lambda K: K.MaxPooling1D(2, input_shape=(8, 4)),
                         seq, _ELEMENT),
        "MaxPooling1D_same": (lambda K: K.MaxPooling1D(
            3, 2, border_mode="same", input_shape=(8, 4)), seq, _ELEMENT),
        "AveragePooling1D": (lambda K: K.AveragePooling1D(
            3, 2, border_mode="same", input_shape=(8, 4)), seq, _ELEMENT),
        "GlobalMaxPooling1D": (lambda K: K.GlobalMaxPooling1D(
            input_shape=(8, 4)), seq, _ELEMENT),
        "GlobalAveragePooling1D": (lambda K: K.GlobalAveragePooling1D(
            input_shape=(8, 4)), seq, _ELEMENT),
        "GlobalMaxPooling2D": (lambda K: K.GlobalMaxPooling2D(
            input_shape=(3, 8, 8)), img, _ELEMENT),
        "MaxPooling3D": (lambda K: K.MaxPooling3D(
            (2, 2, 2), input_shape=(3, 4, 6, 8)), vol, _ELEMENT),
        "AveragePooling3D": (lambda K: K.AveragePooling3D(
            (2, 3, 2), strides=(1, 2, 2), input_shape=(3, 4, 6, 8)), vol,
            _ELEMENT),
        "GlobalMaxPooling3D": (lambda K: K.GlobalMaxPooling3D(
            input_shape=(3, 4, 6, 8)), vol, _ELEMENT),
        "GlobalAveragePooling3D": (lambda K: K.GlobalAveragePooling3D(
            input_shape=(3, 4, 6, 8)), vol, _ELEMENT),
        "ZeroPadding1D": (lambda K: K.ZeroPadding1D(2, input_shape=(8, 4)),
                          seq, _ELEMENT),
        "ZeroPadding3D": (lambda K: K.ZeroPadding3D(
            (1, 2, 1), input_shape=(3, 4, 6, 8)), vol, _ELEMENT),
        "UpSampling1D": (lambda K: K.UpSampling1D(3, input_shape=(8, 4)),
                         seq, _ELEMENT),
        "UpSampling3D": (lambda K: K.UpSampling3D(
            (2, 1, 2), input_shape=(3, 4, 6, 8)), vol, _ELEMENT),
        "Convolution3D": (lambda K: K.Convolution3D(
            4, 2, 3, 3, activation="relu", input_shape=(3, 4, 6, 8)), vol,
            _PRODUCT),
        "Deconvolution2D": (lambda K: K.Deconvolution2D(
            4, 3, 3, subsample=(2, 2), input_shape=(3, 8, 8)), img,
            _PRODUCT),
        "ConvLSTM2D": (lambda K: K.ConvLSTM2D(
            3, 3, 3, input_shape=(3, 2, 5, 6)), _x(2, 3, 2, 5, 6, seed=6),
            _PRODUCT),
        "ConvLSTM2D_sequences": (lambda K: K.ConvLSTM2D(
            3, 3, 3, return_sequences=True, with_peephole=False,
            input_shape=(3, 2, 5, 6)), _x(2, 3, 2, 5, 6, seed=7),
            _PRODUCT),
        "AtrousConvolution2D": (lambda K: K.AtrousConvolution2D(
            4, 3, 3, atrous_rate=(2, 2), input_shape=(3, 8, 8)), img,
            _PRODUCT),
        "AtrousConvolution1D": (lambda K: K.AtrousConvolution1D(
            4, 3, atrous_rate=2, input_shape=(8, 4)), seq, _PRODUCT),
    }
    return c


def _merge_model(K, inp, mode, **kw):
    a = K.Dense(4)(inp)
    b = K.Dense(4, activation="tanh")(inp)
    c = K.Dense(4)(inp)
    return K.Model(input=inp, output=K.Merge(mode, **kw)([a, b, c]))


def _functional_cases():
    """name -> (build(K, input node) -> model, input shape, input, tol)."""
    vec = _x(3, 6, seed=8)
    img = _x(2, 3, 6, 6, seed=9)

    def conv_merge(K, inp):
        a = K.Convolution2D(3, 3, 3, border_mode="same")(inp)
        b = K.Convolution2D(3, 1, 1)(inp)
        m = K.Merge("concat", concat_axis=1)([a, b])
        return K.Model(input=inp, output=K.GlobalAveragePooling2D()(m))

    return {
        "Model_Merge_sum": (lambda K, i: _merge_model(K, i, "sum"), (6,),
                            vec, _PRODUCT),
        "Model_Merge_mul": (lambda K, i: _merge_model(K, i, "mul"), (6,),
                            vec, _PRODUCT),
        "Model_Merge_max": (lambda K, i: _merge_model(K, i, "max"), (6,),
                            vec, _PRODUCT),
        "Model_Merge_concat_last": (
            lambda K, i: _merge_model(K, i, "concat"), (6,), vec, _PRODUCT),
        "Model_Merge_concat_channels": (conv_merge, (3, 6, 6), img,
                                        _PRODUCT),
    }


@functools.lru_cache(maxsize=1)
def _cases():
    """name → (JAX model, port model, input, tol)."""
    from bigdl_tpu.nn import keras as JK
    from bigdl_tpu_torch.nn import keras as TK

    out = {}
    for name, (build, x, tol) in _layer_cases().items():
        out[name] = (JK.Sequential().add(build(JK)),
                     TK.Sequential(device="cpu").add(build(TK)), x, tol)
    for name, (build, shape, x, tol) in _functional_cases().items():
        out[name] = (build(JK, JK.Input(shape)),
                     build(TK, TK.Input(shape, device="cpu")), x, tol)
    return out


CASES = sorted(set(_layer_cases()) | set(_functional_cases()))


@pytest.fixture(scope="module")
def jax_refs():
    return layer_vjp_refs(_cases(), with_state=True)


@pytest.mark.parametrize("name", CASES)
def test_keras_layer_matches_jax(jax_refs, name):
    jm, tm, x, tol = _cases()[name]
    want_shape = (jm.get_output_shape() if hasattr(jm, "_cur")
                  else jm.output_shape)
    got_shape = (tm.get_output_shape() if hasattr(tm, "_cur")
                 else tm.output_shape)
    assert got_shape == want_shape
    assert tuple(np.shape(jax_refs[name][1])[1:]) == want_shape
    check_layer(name, tm, x, jax_refs[name], tol)


def test_every_keras_class_is_covered():
    """Each public Keras layer class of the JAX module runs in a case
    above (or, for the bases and containers, under every case)."""
    import inspect

    from bigdl_tpu.nn import keras as JK

    covered = set()
    for name, (jm, *_rest) in _cases().items():
        for m in [jm] + getattr(jm, "layers", []):
            covered.add(type(m).__name__)
            inner = getattr(m, "layer", None)
            if inner is not None:
                covered.add(type(inner).__name__)
        if name.startswith("Model_Merge"):
            covered.update({"Model", "Merge"})
    classes = {n for n, c in vars(JK).items() if inspect.isclass(c)
               and issubclass(c, JK.KerasLayer) and not n.startswith("_")}
    assert classes - covered == {"KerasLayer"}, sorted(classes - covered)


def test_merge_concat_axis_and_refusals():
    from bigdl_tpu_torch.nn import keras as K

    a = K.Input((3,), device="cpu")
    h1, h2 = K.Dense(3)(a), K.Dense(3)(a)
    merged = K.Merge("concat", concat_axis=1)([h1, h2])
    assert merged.shape == (6,)
    out = K.Model(input=a, output=merged)(torch.randn(4, 3))
    assert out.shape == (4, 6)
    # inputs of unequal widths concatenate to their sum (JAX infers
    # the first width times the input count, and builds the next layer
    # for that)
    c = K.Dense(5)(a)
    uneven = K.Merge("concat")([h1, c])
    assert uneven.shape == (8,)
    head = K.Dense(2)(uneven)
    assert K.Model(input=a, output=head)(torch.randn(4, 3)).shape == (4, 2)
    with pytest.raises(ValueError, match="batch axis"):
        K.Merge("concat", concat_axis=0)
    with pytest.raises(ValueError, match="square"):
        K.ConvLSTM2D(4, 3, 5)
    with pytest.raises(ValueError, match="valid"):
        K.MaxPooling3D(border_mode="same")
    with pytest.raises(ValueError, match="border_mode"):
        K.MaxPooling1D(2, border_mode="SAME")
    with pytest.raises(ValueError, match="return_sequences"):
        K.Bidirectional(K.LSTM(4))
    with pytest.raises(ValueError, match="input_shape"):
        K.Sequential(device="cpu").add(K.Dense(3))


def test_embedding_ids_are_zero_based():
    from bigdl_tpu_torch.nn import keras as K

    m = K.Sequential(device="cpu").add(K.Embedding(10, 4, input_shape=(3,)))
    table = m.layers[0]._core[1].weight
    ids = torch.tensor([[0, 1, 9]], dtype=torch.int32)
    out = m(ids)
    assert torch.equal(out[0], table[[0, 1, 9]])
    assert ids.dtype == torch.int32 and m.layers[0]._core[0](ids).dtype \
        == torch.int32


def test_placement_flows_from_container_and_input():
    from bigdl_tpu_torch.nn import keras as K

    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = K.Sequential(device="cpu", generator=g1).add(
        K.Dense(4, input_shape=(3,))).add(K.Dense(2))
    inp = K.Input((3,), device="cpu", generator=g2)
    b = K.Model(input=inp, output=K.Dense(2)(K.Dense(4)(inp)))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert pa.device.type == "cpu" and torch.equal(pa, pb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            K.Sequential().add(K.Dense(2, input_shape=(3,)))


def _nll_step_refs(jm, x, y, lr, seed, with_state=True):
    """JAX: the ClassNLL loss of ``jm`` in training mode and its params
    after one SGD step, from ``numpy_trees``."""
    import jax.numpy as jnp

    from bigdl_tpu.nn import ClassNLLCriterion
    from bigdl_tpu.optim import SGD

    params, state = numpy_trees(jm, seed)
    crit = ClassNLLCriterion()

    def loss(p):
        out, _ = jm.apply(p, jnp.asarray(x), state, training=True)
        return crit.apply(out, jnp.asarray(y))

    value, grads = jax.value_and_grad(loss)(params)
    opt = SGD(learning_rate=lr, momentum=0.9)
    new, _ = opt.update(grads, opt.init_state(params), params)
    return params, state, float(value), jax.device_get(new)


def _port_step(tm, params, state, x, y, lr):
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    load_jax_tree(tm, params, state)
    tm.train()
    named = dict(tm.named_parameters())
    out = tm(torch.from_numpy(x))
    value = ClassNLLCriterion().apply(out, torch.from_numpy(y))
    grads = torch.autograd.grad(value, list(named.values()))
    opt = SGD(learning_rate=lr, momentum=0.9)
    ps = {k: p.detach().clone() for k, p in named.items()}
    opt.update(dict(zip(named, grads)), opt.init_state(ps), ps)
    return value.item(), ps


def _check_step(tm, new_jax, value_jax, value, ps, tol):
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    assert abs(value - value_jax) <= tol * max(1.0, abs(value_jax))
    want = named_leaves(tm, new_jax)
    assert set(want) == set(ps)
    for k, w in want.items():
        assert max_rel_err(ps[k].numpy(), w) <= tol, k


def test_sgd_step_of_a_keras_sequential_matches_jax():
    from bigdl_tpu.nn import keras as JK
    from bigdl_tpu_torch.nn import keras as TK

    def build(K, **placement):
        return (K.Sequential(**placement)
                .add(K.Convolution2D(4, 3, 3, activation="relu",
                                     input_shape=(2, 6, 6)))
                .add(K.MaxPooling2D((2, 2)))
                .add(K.Flatten())
                .add(K.Dense(8, activation="tanh"))
                .add(K.Dense(3, activation="log_softmax")))

    x = _x(4, 2, 6, 6, seed=20)
    y = np.array([1, 2, 3, 1], np.float32)
    jm, tm = build(JK), build(TK, device="cpu")
    params, state, vj, new = _nll_step_refs(jm, x, y, 0.1, seed=21)
    value, ps = _port_step(tm, params, state, x, y, 0.1)
    _check_step(tm, new, vj, value, ps, 1e-4)


def test_two_block_keras_resnet_matches_jax():
    """Keras 1.2.2's ResNet structure at 8 channels on 16² input: the
    stem, one conv_block and one identity_block (each ending in
    Merge(mode="sum")), average pool, Dense; forward in training mode and
    one SGD step against JAX's."""
    from bigdl_tpu.nn import keras as JK
    from bigdl_tpu_torch.examples.keras_apps import resnet50
    from bigdl_tpu_torch.nn import keras as TK

    kw = dict(classes=5, blocks=(2,), widths=(2,), stem=8, pool=3)
    jm = resnet50(JK, JK.Input((3, 16, 16)), **kw)
    tm = resnet50(TK, TK.Input((3, 16, 16), device="cpu"), **kw)
    assert tm.output_shape == jm.output_shape == (5,)
    assert sum(isinstance(m, TK.Merge) for m in tm.modules()) == 2
    x = _x(4, 3, 16, 16, seed=30)
    y = np.array([1, 5, 2, 4], np.float32)
    params, state, vj, new = _nll_step_refs(jm, x, y, 0.1, seed=31)
    value, ps = _port_step(tm, params, state, x, y, 0.1)
    _check_step(tm, new, vj, value, ps, 1e-4)


def test_published_resnet50_parameter_count():
    """The full-width ``resnet50`` has Keras's published 25,636,712 (53,120 of
    them BatchNormalization's running statistics)."""
    from bigdl_tpu_torch.examples.keras_apps import (
        RESNET50_PARAMS, RESNET50_RUNNING_STATS, resnet50,
    )
    from bigdl_tpu_torch.nn import keras as K

    m = resnet50(K, K.Input((3, 224, 224), device="cpu"))
    learn = sum(p.numel() for p in m.parameters())
    stats = sum(b.numel() for n, b in m.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    assert (learn + stats, stats) == (RESNET50_PARAMS, RESNET50_RUNNING_STATS)
    assert m.output_shape == (1000,)
