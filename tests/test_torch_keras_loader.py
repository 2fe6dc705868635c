"""The port's Keras-1.2 importer (``bigdl_tpu_torch/utils/keras_loader.py``)
held against the JAX package's ``bigdl_tpu/utils/keras_loader.py`` on the
CPU.

The same JSON and HDF5 files (written with h5py in the keras-1 layout, as
``tests/test_keras_loader.py`` writes them) go through both loaders, and
the two models' eval-mode outputs agree within 1e-4 of the largest
magnitude (convolutions, products and recurrences in another order): a
``th`` and a ``tf`` ordered convolutional model (the tf one exercising the
kernel transpose and the HWC→CHW row permutation of the first Dense after
``Flatten``), a recurrent model (Embedding, Convolution1D, LSTM, GRU,
SimpleRNN) and the IMDB CNN-LSTM of Keras 1.2.2's examples at small
widths. JAX's refusals (an unknown layer, gates the names do not identify,
a mismatched JSON/HDF5 pair, an orphan weight, a shared functional layer,
functional-model weights) raise the same exception types in the port.

Two faults of the reference are not copied: JAX's importer ignores a
recurrent layer's ``activation`` and ``inner_activation``, so a Keras 1.2
LSTM with its default ``hard_sigmoid`` gates imports with sigmoid gates
and computes another function (the port refuses such a config; the test
shows JAX accepting it), JAX drops ``go_backwards`` and ``stateful`` of
a recurrent layer and ``mask_zero`` of an ``Embedding`` (refused in the
port likewise), and JAX leaves a bias-free Convolution1D's bias
at its random init (the port imports zeros). Without h5py, ``load_keras``
of weights raises an ImportError naming it.
"""

import json
import sys

import numpy as np
import pytest
import torch

from tests.torch_parity import max_rel_err, one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

TOL = 1e-4


def _write_h5(path, by_layer):
    """keras-1 layout: root attr layer_names; per layer a group with
    attr weight_names, in the given list order."""
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [n.encode() for n in by_layer]
        for name, named in by_layer.items():
            g = f.create_group(name)
            g.attrs["weight_names"] = [w.encode() for w, _ in named]
            for w, arr in named:
                g[w] = arr


def _seq(entries):
    return json.dumps({"class_name": "Sequential", "config": [
        {"class_name": c, "config": cfg} for c, cfg in entries]})


def _rs(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=0.3):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _conv_model(ordering):
    """(json, {layer: [(name, array)]}, input) of a conv / BN / Dense
    model in ``ordering``, with the same weights either way."""
    rng = _rs(1)
    C, H, W = 3, 8, 8
    k1, b1 = _f32(rng, 4, C, 3, 3), _f32(rng, 4, scale=0.1)
    k2, b2 = _f32(rng, 5, 4, 3, 3), _f32(rng, 5, scale=0.1)
    # after conv(3) valid: 6x6, pool 2: 3x3, conv 3 same: 3x3 -> 45 feats
    w_chw = _f32(rng, 5 * 3 * 3, 6)
    gamma = (1 + _f32(rng, 6, scale=0.1))
    beta, mean = _f32(rng, 6, scale=0.1), _f32(rng, 6, scale=0.1)
    var = (1 + np.abs(_f32(rng, 6, scale=0.2))).astype(np.float32)
    w2, bd2 = _f32(rng, 6, 3), _f32(rng, 3, scale=0.1)
    bd1 = _f32(rng, 6, scale=0.1)
    if ordering == "tf":
        k1 = np.transpose(k1, (2, 3, 1, 0))
        k2 = np.transpose(k2, (2, 3, 1, 0))
        w1 = np.transpose(w_chw.reshape(5, 3, 3, 6),
                          (1, 2, 0, 3)).reshape(45, 6)
        shape = [None, H, W, C]
    else:
        w1, shape = w_chw, [None, C, H, W]
    conv = dict(dim_ordering=ordering, border_mode="valid",
                activation="relu")
    js = _seq([
        ("Convolution2D", dict(name="conv_1", nb_filter=4, nb_row=3,
                               nb_col=3, batch_input_shape=shape, **conv)),
        ("MaxPooling2D", dict(name="pool_1", pool_size=[2, 2],
                              dim_ordering=ordering)),
        ("Convolution2D", dict(name="conv_2", nb_filter=5, nb_row=3,
                               nb_col=3, **{**conv, "border_mode": "same"})),
        ("Flatten", dict(name="flat_1")),
        ("Dense", dict(name="dense_1", output_dim=6, activation="linear")),
        ("BatchNormalization", dict(name="bn_1", epsilon=1e-3, mode=0)),
        ("Activation", dict(name="act_1", activation="tanh")),
        ("Dense", dict(name="dense_2", output_dim=3,
                       activation="softmax")),
    ])
    weights = {"conv_1": [("conv_1_W", k1), ("conv_1_b", b1)],
               "conv_2": [("conv_2_W", k2), ("conv_2_b", b2)],
               "dense_1": [("dense_1_W", w1), ("dense_1_b", bd1)],
               "bn_1": [("bn_1_gamma", gamma), ("bn_1_beta", beta),
                        ("bn_1_running_mean", mean),
                        ("bn_1_running_std", var)],
               "dense_2": [("dense_2_W", w2), ("dense_2_b", bd2)]}
    return js, weights, _f32(rng, 2, C, H, W, scale=1.0)


def _gates(rng, prefix, gates, i, h):
    out = []
    for g in gates:
        out += [(f"{prefix}_W_{g}", _f32(rng, i, h)),
                (f"{prefix}_U_{g}", _f32(rng, h, h)),
                (f"{prefix}_b_{g}", _f32(rng, h, scale=0.1))]
    return out


def _recurrent_model():
    rng = _rs(2)
    V, T, E, F = 12, 9, 5, 6
    rec = dict(activation="tanh", inner_activation="sigmoid")
    js = _seq([
        ("Embedding", dict(name="emb_1", input_dim=V, output_dim=E,
                           batch_input_shape=[None, T])),
        ("Convolution1D", dict(name="conv1d_1", nb_filter=F,
                               filter_length=3, border_mode="same",
                               activation="relu")),
        ("LSTM", dict(name="lstm_1", output_dim=4, return_sequences=True,
                      **rec)),
        ("GRU", dict(name="gru_1", output_dim=4, return_sequences=True,
                     **rec)),
        ("SimpleRNN", dict(name="rnn_1", output_dim=3, activation="tanh")),
        ("Dense", dict(name="dense_1", output_dim=2, activation="sigmoid")),
    ])
    weights = {
        "emb_1": [("emb_1_W", _f32(rng, V, E, scale=1.0))],
        "conv1d_1": [("conv1d_1_W", _f32(rng, 3, 1, E, F)),
                     ("conv1d_1_b", _f32(rng, F, scale=0.1))],
        "lstm_1": _gates(rng, "lstm_1", "icfo", F, 4),
        "gru_1": _gates(rng, "gru_1", "zrh", 4, 4),
        "rnn_1": [("rnn_1_W", _f32(rng, 4, 3)), ("rnn_1_U", _f32(rng, 3, 3)),
                  ("rnn_1_b", _f32(rng, 3, scale=0.1))],
        "dense_1": [("dense_1_W", _f32(rng, 3, 2)),
                    ("dense_1_b", _f32(rng, 2, scale=0.1))],
    }
    return js, weights, rng.integers(0, V, (3, T)).astype(np.int32)


def _imdb_model():
    from bigdl_tpu_torch.examples.keras_apps import (
        imdb_cnn_lstm_json, imdb_cnn_lstm_weights,
    )

    js = imdb_cnn_lstm_json(max_features=50, maxlen=20, embedding_size=8,
                            nb_filter=6, filter_length=5, pool_length=4,
                            lstm_output_size=7)
    ids = _rs(3).integers(0, 50, (4, 20)).astype(np.int32)
    return js, imdb_cnn_lstm_weights(js, seed=4), ids


MODELS = {"conv_th": lambda: _conv_model("th"),
          "conv_tf": lambda: _conv_model("tf"),
          "recurrent": _recurrent_model, "imdb_cnn_lstm": _imdb_model}


def _files(tmp_path, js, weights):
    (tmp_path / "m.json").write_text(js)
    _write_h5(tmp_path / "m.h5", weights)
    return str(tmp_path / "m.json"), str(tmp_path / "m.h5")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_both_loaders_give_the_same_forward(tmp_path, name):
    from bigdl_tpu.utils.keras_loader import load_keras as jax_load
    from bigdl_tpu_torch.nn.module import AbstractModule

    js, weights, x = MODELS[name]()
    jp, hp = _files(tmp_path, js, weights)
    jm = jax_load(jp, hp)
    jm.evaluate()
    want = np.asarray(jm.forward(x))
    tm = AbstractModule.load_keras(jp, hp, device="cpu")
    tm.evaluate()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert max_rel_err(got, want) <= TOL


def test_conv_th_and_tf_twins_agree():
    """The tf-ordered save of the same weights builds the same CHW model."""
    from bigdl_tpu_torch.utils.keras_loader import (
        load_keras_json, load_keras_weights,
    )

    outs = []
    for ordering in ("th", "tf"):
        js, weights, x = _conv_model(ordering)
        m = load_keras_weights(load_keras_json(js, device="cpu"), js,
                               weights)
        m.evaluate()
        with torch.no_grad():
            outs.append(m(torch.from_numpy(x)).numpy())
    assert max_rel_err(outs[1], outs[0]) <= 1e-5


def test_arrays_and_hdf5_load_the_same_weights(tmp_path):
    """load_keras_weights (plain arrays, the card's route) and load_keras
    (HDF5) fill the same parameters bit for bit."""
    from bigdl_tpu_torch.utils.keras_loader import (
        load_keras, load_keras_json, load_keras_weights,
    )

    js, weights, _ = _recurrent_model()
    a = load_keras_weights(load_keras_json(js, device="cpu"), js, weights)
    b = load_keras(*_files(tmp_path, js, weights), device="cpu")
    for (ka, pa), (kb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert torch.equal(pa, pb), (ka, kb)


def _lstm_json(**rec):
    return _seq([("LSTM", dict(name="lstm_1", output_dim=3,
                               batch_input_shape=[None, 4, 2], **rec))])


def _functional_json(shared=False):
    inbound = [[["input_1", 0, 0]]]
    layers = [{"class_name": "InputLayer", "name": "input_1",
               "config": {"name": "input_1", "batch_input_shape": [None, 4]},
               "inbound_nodes": []},
              {"class_name": "Dense", "name": "dense_1",
               "config": {"name": "dense_1", "output_dim": 3,
                          "activation": "linear"},
               "inbound_nodes": inbound * (2 if shared else 1)}]
    return json.dumps({"class_name": "Model", "config": {
        "name": "m", "layers": layers,
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["dense_1", 0, 0]]}})


_DENSE = ("Dense", dict(name="dense_1", output_dim=3, activation="linear",
                        batch_input_shape=[None, 4]))
_SIGMOID = dict(activation="tanh", inner_activation="sigmoid")


def _refusals():
    """name -> (json, weights or None, exception, match)."""
    z = np.zeros
    return {
        "unknown_layer": (_seq([("SomeExotic", dict(
            name="x", batch_input_shape=[None, 4]))]), None, ValueError,
            "SomeExotic"),
        "lstm_gates_unnamed": (_lstm_json(**_SIGMOID), {"lstm_1": [
            (f"lstm_1_p{i}", z((2, 3), np.float32)) for i in range(12)]},
            NotImplementedError, "LSTM"),
        "gru_gates_unnamed": (_seq([("GRU", dict(
            name="gru_1", output_dim=3, batch_input_shape=[None, 4, 2],
            **_SIGMOID))]), {"gru_1": [("gru_1_param_0",
                                        z((2, 3), np.float32))]},
            NotImplementedError, "gates"),
        "mismatched_pair": (_seq([_DENSE]), {"dense_7": [
            ("dense_7_W", z((4, 3), np.float32)),
            ("dense_7_b", z(3, np.float32))]}, ValueError, "does not match"),
        "orphan_bias": (_seq([("Dense", dict(_DENSE[1], bias=False))]),
                        {"dense_1": [("dense_1_W", z((4, 3), np.float32)),
                                     ("dense_1_b", z(3, np.float32))]},
                        ValueError, "does not match"),
        "extra_h5_layer": (_seq([_DENSE]), {
            "dense_1": [("dense_1_W", z((4, 3), np.float32)),
                        ("dense_1_b", z(3, np.float32))],
            "dense_9": [("dense_9_W", z((4, 3), np.float32))]},
            ValueError, "does not match"),
        "shared_functional_layer": (_functional_json(shared=True), None,
                                    ValueError, "shared keras layer"),
        "functional_weights": (_functional_json(), {"dense_1": [
            ("dense_1_W", z((4, 3), np.float32))]}, NotImplementedError,
            "Sequential"),
        "bn_legacy_mode": (_seq([("BatchNormalization", dict(
            name="bn_1", mode=1, batch_input_shape=[None, 4]))]), None,
            ValueError, "mode"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_jax_refusals_raise_in_the_port(tmp_path, name):
    from bigdl_tpu.utils.keras_loader import load_keras as jax_load
    from bigdl_tpu_torch.utils.keras_loader import load_keras

    js, weights, exc, match = _refusals()[name]
    (tmp_path / "m.json").write_text(js)
    hp = None
    if weights is not None:
        _write_h5(tmp_path / "m.h5", weights)
        hp = str(tmp_path / "m.h5")
    with pytest.raises(exc, match=match):
        jax_load(str(tmp_path / "m.json"), hp)
    with pytest.raises(exc, match=match):
        load_keras(str(tmp_path / "m.json"), hp, device="cpu")


@pytest.mark.parametrize("cls,cfg,key", [
    ("LSTM", {"activation": "tanh"}, "inner_activation"),
    ("LSTM", {"activation": "tanh", "inner_activation": "hard_sigmoid"},
     "inner_activation"),
    ("GRU", {"inner_activation": "sigmoid", "activation": "relu"},
     "activation"),
    ("SimpleRNN", {"activation": "relu"}, "activation"),
])
def test_recurrent_activation_refused_where_jax_accepts(cls, cfg, key):
    """JAX ignores the keys and builds sigmoid gates / a tanh output (a
    different function from the Keras layer's); the port refuses, naming
    the layer and the key."""
    from bigdl_tpu.utils.keras_loader import load_keras_json as jax_json
    from bigdl_tpu_torch.utils.keras_loader import load_keras_json

    js = _seq([(cls, dict(name="rec_1", output_dim=3,
                          batch_input_shape=[None, 4, 2], **cfg))])
    jm = jax_json(js)
    assert np.asarray(jm.forward(np.zeros((1, 4, 2), np.float32))).shape \
        == (1, 3)
    with pytest.raises(ValueError, match=f"'rec_1'.*{key}="):
        load_keras_json(js, device="cpu")


@pytest.mark.parametrize("cls,key", [
    ("LSTM", "go_backwards"), ("GRU", "stateful"),
    ("SimpleRNN", "go_backwards"), ("Embedding", "mask_zero")])
def test_flags_jax_drops_are_refused(cls, key):
    """A reversed or stateful recurrent layer, or a masking Embedding:
    JAX drops the key and builds a layer that reads the sequence forward,
    from a zero state, unmasked; the port refuses, naming the layer and
    the key."""
    from bigdl_tpu.utils.keras_loader import load_keras_json as jax_json
    from bigdl_tpu_torch.utils.keras_loader import load_keras_json

    if cls == "Embedding":
        layers = [(cls, dict(name="flag_1", input_dim=7, output_dim=2,
                             batch_input_shape=[None, 4], **{key: True})),
                  ("LSTM", dict(name="rec_2", output_dim=3,
                                inner_activation="sigmoid"))]
        x = np.ones((1, 4), np.int32)
    else:
        layers = [(cls, dict(name="flag_1", output_dim=3,
                             inner_activation="sigmoid",
                             batch_input_shape=[None, 4, 2], **{key: True}))]
        x = np.zeros((1, 4, 2), np.float32)
    if cls == "SimpleRNN":
        del layers[0][1]["inner_activation"]
    js = _seq(layers)
    assert np.asarray(jax_json(js).forward(x)).shape == (1, 3)
    with pytest.raises(ValueError, match=f"'flag_1' has {key}=True"):
        load_keras_json(js, device="cpu")


def test_bias_free_convolution1d_imports_a_zero_bias():
    """Both packages' core keeps a bias for ``bias=False``; JAX's importer
    leaves it at its random init, the port's loads zeros, so the import
    computes the Keras layer's function."""
    from bigdl_tpu_torch.utils.keras_loader import (
        load_keras_json, load_keras_weights,
    )

    rng = _rs(5)
    k = _f32(rng, 3, 1, 4, 2)
    js = _seq([("Convolution1D", dict(
        name="c", nb_filter=2, filter_length=3, bias=False,
        activation="linear", batch_input_shape=[None, 6, 4]))])
    m = load_keras_weights(load_keras_json(js, device="cpu"), js,
                           {"c": [("c_W", k)]})
    x = _f32(rng, 2, 6, 4, scale=1.0)
    want = np.stack([sum(x[:, t + i] @ k[i, 0] for i in range(3))
                     for t in range(4)], 1)
    with torch.no_grad():
        assert max_rel_err(m(torch.from_numpy(x)).numpy(), want) <= 1e-5


def test_without_h5py_load_keras_names_it(tmp_path, monkeypatch):
    from bigdl_tpu_torch.utils.keras_loader import load_keras

    js, weights, _ = _conv_model("th")
    jp, hp = _files(tmp_path, js, weights)
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert load_keras(jp, device="cpu") is not None   # no weights: no h5py
    with pytest.raises(ImportError, match="h5py"):
        load_keras(jp, hp, device="cpu")
