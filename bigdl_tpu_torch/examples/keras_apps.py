"""Two public Keras 1.2.2 models, written against a Keras layer module.

* :func:`resnet50` is ``keras/applications/resnet50.py::ResNet50``
  (``include_top=True``, ``th`` ordering) through the functional API:
  the 7x7 stem, ``conv_block`` / ``identity_block`` stages ending in
  ``Merge(mode="sum")`` and relu, then ``AveragePooling2D``, ``Flatten``
  and ``Dense``. Its head is ``log_softmax``, not the published
  ``softmax``, so that ``ClassNLLCriterion`` trains it; ``blocks``,
  ``widths``, ``stem`` and ``pool`` shrink it for tests. These functions
  call only the Keras API, so ``K`` may be :mod:`bigdl_tpu_torch.nn.keras`
  or any module with the same layer names; the caller makes the input
  node (the port's :func:`~bigdl_tpu_torch.nn.keras.Input` takes the
  device and generator every layer inherits).
* :func:`imdb_cnn_lstm_json` is the ``model.to_json()`` text of Keras
  1.2.2's ``examples/imdb_cnn_lstm.py`` (Embedding, Dropout,
  Convolution1D, MaxPooling1D, LSTM, Dense, sigmoid), and
  :func:`imdb_cnn_lstm_weights` seeded weights in the keras-1 HDF5
  layout (``{layer name: [(weight name, array), ...]}``) for
  :func:`bigdl_tpu_torch.utils.keras_loader.load_keras_weights`. The
  example's LSTM runs Keras's default ``inner_activation``
  ``hard_sigmoid``; the importer refuses that (its core cell has sigmoid
  gates), so the JSON states ``"sigmoid"``.

``RESNET50_PARAMS`` and ``RESNET50_RUNNING_STATS`` are Keras's published
summary counts of ``ResNet50(include_top=True)``: 25,636,712 in all, of
which 53,120 are BatchNormalization's running statistics.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

RESNET50_PARAMS = 25_636_712
RESNET50_RUNNING_STATS = 53_120


def _bn_relu(K, x, relu: bool = True):
    x = K.BatchNormalization()(x)          # th ordering: the channel axis
    return K.Activation("relu")(x) if relu else x


def identity_block(K, x, kernel_size: int, filters: Sequence[int]):
    """Three convolutions (1x1, k x k same, 1x1) and the input added back."""
    f1, f2, f3 = filters
    y = _bn_relu(K, K.Convolution2D(f1, 1, 1)(x))
    y = _bn_relu(K, K.Convolution2D(f2, kernel_size, kernel_size,
                                    border_mode="same")(y))
    y = _bn_relu(K, K.Convolution2D(f3, 1, 1)(y), relu=False)
    return K.Activation("relu")(K.Merge(mode="sum")([y, x]))


def conv_block(K, x, kernel_size: int, filters: Sequence[int],
               strides: Tuple[int, int] = (2, 2)):
    """As :func:`identity_block`, the first 1x1 strided, with a strided
    1x1 convolution and BatchNormalization on the shortcut."""
    f1, f2, f3 = filters
    y = _bn_relu(K, K.Convolution2D(f1, 1, 1, subsample=strides)(x))
    y = _bn_relu(K, K.Convolution2D(f2, kernel_size, kernel_size,
                                    border_mode="same")(y))
    y = _bn_relu(K, K.Convolution2D(f3, 1, 1)(y), relu=False)
    shortcut = _bn_relu(
        K, K.Convolution2D(f3, 1, 1, subsample=strides)(x), relu=False)
    return K.Activation("relu")(K.Merge(mode="sum")([y, shortcut]))


def resnet50(K, inp, classes: int = 1000,
             blocks: Sequence[int] = (3, 4, 6, 3),
             widths: Sequence[int] = (64, 128, 256, 512), stem: int = 64,
             pool: int = 7):
    """Keras 1.2.2's ResNet50 from the input node ``inp`` (3 x 224 x 224
    at the published size); returns ``K.Model``."""
    x = K.ZeroPadding2D((3, 3))(inp)
    x = _bn_relu(K, K.Convolution2D(stem, 7, 7, subsample=(2, 2))(x))
    x = K.MaxPooling2D((3, 3), strides=(2, 2))(x)
    for stage, (n, w) in enumerate(zip(blocks, widths)):
        filters = (w, w, 4 * w)
        x = conv_block(K, x, 3, filters,
                       strides=(1, 1) if stage == 0 else (2, 2))
        for _ in range(n - 1):
            x = identity_block(K, x, 3, filters)
    x = K.AveragePooling2D((pool, pool))(x)
    x = K.Flatten()(x)
    x = K.Dense(classes, activation="log_softmax")(x)
    return K.Model(input=inp, output=x)


def imdb_cnn_lstm_json(max_features: int = 20000, maxlen: int = 100,
                       embedding_size: int = 128, nb_filter: int = 64,
                       filter_length: int = 5, pool_length: int = 4,
                       lstm_output_size: int = 70) -> str:
    """The Keras 1.2.2 ``to_json()`` of ``examples/imdb_cnn_lstm.py`` at
    the example's widths (the defaults)."""
    def layer(cls, **cfg):
        return {"class_name": cls, "config": {"trainable": True, **cfg}}

    config = [
        layer("Embedding", name="embedding_1", input_dim=max_features,
              output_dim=embedding_size, input_length=maxlen,
              batch_input_shape=[None, maxlen], input_dtype="int32",
              init="uniform", mask_zero=False, dropout=0.0,
              W_regularizer=None, activity_regularizer=None,
              W_constraint=None),
        layer("Dropout", name="dropout_1", p=0.25),
        layer("Convolution1D", name="convolution1d_1", nb_filter=nb_filter,
              filter_length=filter_length, border_mode="valid",
              activation="relu", subsample_length=1, init="glorot_uniform",
              bias=True, input_dim=None, input_length=None,
              W_regularizer=None, b_regularizer=None,
              activity_regularizer=None, W_constraint=None,
              b_constraint=None),
        layer("MaxPooling1D", name="maxpooling1d_1",
              pool_length=pool_length, stride=None, border_mode="valid"),
        layer("LSTM", name="lstm_1", output_dim=lstm_output_size,
              activation="tanh", inner_activation="sigmoid",
              return_sequences=False, go_backwards=False, stateful=False,
              unroll=False, consume_less="cpu", init="glorot_uniform",
              inner_init="orthogonal", forget_bias_init="one",
              dropout_W=0.0, dropout_U=0.0, W_regularizer=None,
              U_regularizer=None, b_regularizer=None),
        layer("Dense", name="dense_1", output_dim=1, activation="linear",
              bias=True, init="glorot_uniform", input_dim=None,
              W_regularizer=None, b_regularizer=None,
              activity_regularizer=None, W_constraint=None,
              b_constraint=None),
        layer("Activation", name="activation_1", activation="sigmoid"),
    ]
    return json.dumps({"class_name": "Sequential", "config": config,
                       "keras_version": "1.2.2"})


def imdb_cnn_lstm_weights(json_str: str, seed: int = 0
                          ) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    """Keras-1 weight arrays for the model of ``json_str``, drawn from
    ``seed`` (glorot-uniform kernels, uniform(±0.05) embeddings, small
    biases), in the HDF5 save's layout and list order."""
    rng = np.random.default_rng(seed)
    cfg = {e["config"]["name"]: e["config"]
           for e in json.loads(json_str)["config"]}

    def glorot(shape, fan_in, fan_out):
        b = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-b, b, shape).astype(np.float32)

    def small(n):
        return rng.uniform(-0.05, 0.05, n).astype(np.float32)

    emb, conv, lstm = (cfg["embedding_1"], cfg["convolution1d_1"],
                       cfg["lstm_1"])
    e, f, k, h = (emb["output_dim"], conv["nb_filter"],
                  conv["filter_length"], lstm["output_dim"])
    out = {
        "embedding_1": [("embedding_1_W", rng.uniform(
            -0.05, 0.05, (emb["input_dim"], e)).astype(np.float32))],
        "convolution1d_1": [
            ("convolution1d_1_W", glorot((k, 1, e, f), k * e, k * f)),
            ("convolution1d_1_b", small(f))],
        "lstm_1": [],
        "dense_1": [("dense_1_W", glorot((h, 1), h, 1)),
                    ("dense_1_b", small(1))],
    }
    for gate in "icfo":                  # keras-1's own list order
        out["lstm_1"] += [(f"lstm_1_W_{gate}", glorot((f, h), f, h)),
                          (f"lstm_1_U_{gate}", glorot((h, h), h, h)),
                          (f"lstm_1_b_{gate}", small(h))]
    return out
