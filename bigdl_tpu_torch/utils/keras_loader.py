"""Keras 1.2 model import — the reference's ``Model.load_keras``
(``bigdl_tpu/utils/keras_loader.py``).

A Keras 1.2.2 architecture (``model.to_json()``) becomes a model of the
port's Keras layer set (:mod:`bigdl_tpu_torch.nn.keras`), and its HDF5
weights are copied in. Nothing Keras-side runs: the JSON is parsed
directly and the HDF5 file is read with h5py, imported only inside
:func:`load_keras` (the card's machine has no h5py; the weights can be
handed to :func:`load_keras_weights` as plain arrays instead).

Scope, enforced with clear errors (JAX's, plus the keys JAX drops):

* architectures — ``Sequential`` and functional ``Model`` configs over
  the layer table of :func:`_build_layer`; another class name raises with
  the name. A recurrent layer whose ``activation`` / ``inner_activation``
  is not what the core cell computes (tanh output, sigmoid gates) is
  refused: Keras 1.2's default ``inner_activation`` is ``hard_sigmoid``,
  and JAX's importer, which ignores both keys, builds a model that
  computes another function from such a config. So is a recurrent layer
  with ``go_backwards`` or ``stateful`` set and an ``Embedding`` with
  ``mask_zero`` set, which JAX drops as well: the port's layers read the
  sequence forward, from a zero state, unmasked.
* weights — Sequential models, for Dense / Convolution1D/2D /
  BatchNormalization (keras1 stores [gamma, beta, running_mean,
  running_std], ``running_std`` being the running VARIANCE) / Embedding /
  LSTM / SimpleRNN / GRU (the gates named by the keras1 weight NAMES); a
  bias-free Convolution1D imports a zero bias (its core always has one;
  JAX leaves it at its random init). Functional-model weights raise
  ``NotImplementedError``.
* ``dim_ordering``: ``"th"`` maps 1:1 (the port is CHW/NCHW); ``"tf"``
  configs get their input shapes and conv kernels moved to CHW (the
  loaded model takes CHW input), and the first Dense after a ``Flatten``
  of tf-ordered features has its kernel rows permuted HWC-flat →
  CHW-flat.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _strip_batch(shape) -> tuple:
    return tuple(int(s) for s in shape[1:])


def _to_chw(shape: tuple, dim_ordering: str) -> tuple:
    if dim_ordering == "tf" and len(shape) == 3:
        h, w, c = shape
        return (c, h, w)
    return shape


def _activation_name(cfg: Dict[str, Any]) -> Optional[str]:
    act = cfg.get("activation")
    return None if act in (None, "linear") else act


class _Unsupported(ValueError):
    pass


#: what the core cells compute, against Keras 1.2's defaults for a key
#: the config leaves out: (key, what the cell runs, Keras's default)
_RECURRENT_ACTIVATIONS = {
    "LSTM": (("activation", "tanh", "tanh"),
             ("inner_activation", "sigmoid", "hard_sigmoid")),
    "GRU": (("activation", "tanh", "tanh"),
            ("inner_activation", "sigmoid", "hard_sigmoid")),
    "SimpleRNN": (("activation", "tanh", "tanh"),),
}


#: keys that, set, make the layer compute what the port's does not
_REFUSED_FLAGS = {"LSTM": ("go_backwards", "stateful"),
                  "GRU": ("go_backwards", "stateful"),
                  "SimpleRNN": ("go_backwards", "stateful"),
                  "Embedding": ("mask_zero",)}


def _check_semantics(class_name: str, cfg: Dict[str, Any]):
    """Refuse a config whose layer the port would import as another
    function (see the module's scope)."""
    for key in _REFUSED_FLAGS.get(class_name, ()):
        if cfg.get(key, False):
            raise ValueError(
                f"load_keras: {class_name} layer {cfg.get('name', '?')!r} "
                f"has {key}={cfg[key]!r}, which the port's {class_name} "
                "does not implement; importing it would compute another "
                "function")
    for key, runs, default in _RECURRENT_ACTIVATIONS.get(class_name, ()):
        got = cfg.get(key, default)
        if got != runs:
            raise ValueError(
                f"load_keras: {class_name} layer {cfg.get('name', '?')!r} "
                f"has {key}={got!r}"
                f"{'' if key in cfg else ' (the Keras 1.2 default)'}, but "
                f"the core cell computes {runs!r}; importing it would "
                "compute another function")


def _build_layer(class_name: str, cfg: Dict[str, Any],
                 input_shape: Optional[tuple]):
    """keras1 layer config → port Keras layer (not yet built)."""
    from bigdl_tpu_torch.nn import keras as K

    kw = {}
    if input_shape is not None:
        kw["input_shape"] = input_shape

    if class_name == "Dense":
        return K.Dense(cfg["output_dim"], activation=_activation_name(cfg),
                       bias=cfg.get("bias", True), **kw)
    if class_name == "Activation":
        return K.Activation(cfg["activation"], **kw)
    if class_name == "Dropout":
        return K.Dropout(cfg["p"], **kw)
    if class_name == "Flatten":
        return K.Flatten(**kw)
    if class_name == "Reshape":
        return K.Reshape(tuple(cfg["target_shape"]), **kw)
    if class_name == "Permute":
        return K.Permute(tuple(cfg["dims"]), **kw)
    if class_name == "RepeatVector":
        return K.RepeatVector(cfg["n"], **kw)
    if class_name == "Highway":
        return K.Highway(activation=_activation_name(cfg), **kw)
    if class_name == "Masking":
        return K.Masking(cfg.get("mask_value", 0.0), **kw)
    if class_name == "Convolution1D":
        return K.Convolution1D(
            cfg["nb_filter"], cfg["filter_length"],
            subsample_length=cfg.get("subsample_length", 1),
            border_mode=cfg.get("border_mode", "valid"),
            activation=_activation_name(cfg),
            bias=cfg.get("bias", True), **kw)
    if class_name == "Convolution2D":
        return K.Convolution2D(
            cfg["nb_filter"], cfg["nb_row"], cfg["nb_col"],
            subsample=tuple(cfg.get("subsample", (1, 1))),
            border_mode=cfg.get("border_mode", "valid"),
            activation=_activation_name(cfg),
            bias=cfg.get("bias", True), **kw)
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        return getattr(K, class_name)(
            pool_size=tuple(cfg.get("pool_size", (2, 2))),
            strides=tuple(cfg["strides"]) if cfg.get("strides") else None,
            border_mode=cfg.get("border_mode", "valid"), **kw)
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        return getattr(K, class_name)(
            pool_length=cfg.get("pool_length", 2), stride=cfg.get("stride"),
            border_mode=cfg.get("border_mode", "valid"), **kw)
    if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                      "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        return getattr(K, class_name)(**kw)
    if class_name == "BatchNormalization":
        if cfg.get("mode", 0) != 0:
            raise _Unsupported(
                "BatchNormalization mode!=0 (keras1 legacy modes)")
        return K.BatchNormalization(epsilon=cfg.get("epsilon", 1e-3),
                                    momentum=cfg.get("momentum", 0.99), **kw)
    if class_name == "Embedding":
        _check_semantics(class_name, cfg)
        return K.Embedding(cfg["input_dim"], cfg["output_dim"], **kw)
    if class_name in ("LSTM", "GRU", "SimpleRNN"):
        _check_semantics(class_name, cfg)
        return getattr(K, class_name)(
            cfg["output_dim"],
            return_sequences=cfg.get("return_sequences", False), **kw)
    if class_name == "ZeroPadding2D":
        return K.ZeroPadding2D(tuple(cfg.get("padding", (1, 1))), **kw)
    if class_name == "UpSampling2D":
        return K.UpSampling2D(tuple(cfg.get("size", (2, 2))), **kw)
    if class_name == "Merge":
        return K.Merge(mode=cfg.get("mode", "sum"),
                       concat_axis=cfg.get("concat_axis", -1))
    if class_name == "LeakyReLU":
        return K.LeakyReLU(cfg.get("alpha", 0.3), **kw)
    if class_name == "ELU":
        return K.ELU(cfg.get("alpha", 1.0), **kw)
    if class_name == "ThresholdedReLU":
        return K.ThresholdedReLU(cfg.get("theta", 1.0), **kw)
    if class_name == "GaussianNoise":
        return K.GaussianNoise(cfg.get("sigma", cfg.get("stddev", 0.1)), **kw)
    if class_name == "GaussianDropout":
        return K.GaussianDropout(cfg.get("p", cfg.get("rate", 0.1)), **kw)
    raise _Unsupported(
        f"keras layer {class_name!r} is not supported by load_keras "
        "(see utils/keras_loader.py for the supported table)")


def _build_sequential(layer_cfgs: List[Dict[str, Any]], device, generator):
    from bigdl_tpu_torch.nn import keras as K

    model = K.Sequential(device=device, generator=generator)
    for i, entry in enumerate(layer_cfgs):
        cname, cfg = entry["class_name"], entry["config"]
        input_shape = None
        if i == 0:
            bis = cfg.get("batch_input_shape")
            if bis is None:
                raise ValueError(
                    "first keras layer carries no batch_input_shape")
            input_shape = _to_chw(_strip_batch(bis),
                                  cfg.get("dim_ordering", "th"))
        model.add(_build_layer(cname, cfg, input_shape))
    return model


def _build_functional(config: Dict[str, Any], device, generator):
    from bigdl_tpu_torch.nn import keras as K

    nodes: Dict[str, Any] = {}  # layer name -> KerasNode (output port 0)
    for entry in config["layers"]:
        cname, cfg, name = (entry["class_name"], entry["config"],
                            entry["name"])
        inbound = entry.get("inbound_nodes") or []
        if cname == "InputLayer":
            shape = _to_chw(_strip_batch(cfg["batch_input_shape"]),
                            cfg.get("dim_ordering", "th"))
            nodes[name] = K.Input(shape, device=device, generator=generator)
            continue
        if len(inbound) != 1:
            raise _Unsupported(
                f"layer {name!r} is applied {len(inbound)} times (shared "
                "keras layer) — load_keras supports single-application "
                "functional graphs")
        for ref in inbound[0]:
            if len(ref) > 1 and (ref[1] != 0 or (len(ref) > 2 and
                                                 ref[2] != 0)):
                raise _Unsupported(
                    f"layer {name!r} consumes node port {ref[1:]} of "
                    f"{ref[0]!r} — multi-application/multi-output "
                    "references are not supported")
        srcs = [nodes[ref[0]] for ref in inbound[0]]
        layer = _build_layer(cname, cfg, None)
        nodes[name] = layer(srcs if len(srcs) > 1 else srcs[0])
    ins = [nodes[r[0]] for r in config["input_layers"]]
    outs = [nodes[r[0]] for r in config["output_layers"]]
    return K.Model(input=ins if len(ins) > 1 else ins[0],
                   output=outs if len(outs) > 1 else outs[0])


def load_keras_json(json_str: str, device=None,
                    generator: torch.Generator = None):
    """Build a model from a Keras-1.2 ``model.to_json()`` string, its
    parameters made on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``) from ``generator``."""
    blob = json.loads(json_str)
    cls = blob.get("class_name")
    if cls == "Sequential":
        return _build_sequential(blob["config"], device, generator)
    if cls == "Model":
        return _build_functional(blob["config"], device, generator)
    raise ValueError(f"not a keras model json (class_name={cls!r})")


# -- weights ---------------------------------------------------------------

# classes whose keras1 save carries weight arrays (supported or not —
# missing arrays for any of these means a mismatched json/h5 pair)
_WEIGHTED_CLASSES = frozenset({
    "Dense", "Convolution1D", "Convolution2D", "BatchNormalization",
    "Embedding", "LSTM", "GRU", "SimpleRNN", "Highway",
})

Named = List[Tuple[str, np.ndarray]]


def _h5_layer_weights(f) -> Dict[str, Named]:
    """keras1 HDF5 layout: root attr ``layer_names``; one group per layer
    with attr ``weight_names``. Returns ``(weight_name, array)`` pairs per
    layer name; recurrent gates are told apart by the NAMES
    (``.._W_i``/``.._U_f``), robust to keras1's list order."""
    root = f["model_weights"] if "model_weights" in f else f
    out = {}
    for lname in [n.decode() if isinstance(n, bytes) else n
                  for n in root.attrs.get("layer_names", [])]:
        g = root[lname]
        wnames = [n.decode() if isinstance(n, bytes) else n
                  for n in g.attrs.get("weight_names", [])]
        out[lname] = [(w, np.asarray(g[w])) for w in wnames]
    return out


def _named_gates(named: Named, kind: str,
                 gates: str) -> Optional[Dict[str, np.ndarray]]:
    """keras1 recurrent arrays by name suffix ``_{kind}_{gate}`` (e.g.
    ``lstm_1_W_i``); None when any gate is missing."""
    out = {}
    for g in gates:
        hits = [a for n, a in named if n.endswith(f"_{kind}_{g}")]
        if len(hits) != 1:
            return None
        out[g] = hits[0]
    return out


def _fused_gates(named: Named, gates: str, order: str, cell: str):
    W = _named_gates(named, "W", gates)
    U = _named_gates(named, "U", gates)
    b = _named_gates(named, "b", gates)
    if not (W and U and b):
        raise NotImplementedError(
            f"load_keras: {cell} weight names do not follow the keras1 "
            f"_W_{gates[0]}/_U_{gates[1]}/_b_{gates[-1]} pattern — cannot "
            "identify gates")
    return {"w_ih": np.concatenate([W[g].T for g in order]),
            "w_hh": np.concatenate([U[g].T for g in order]),
            "b_ih": np.concatenate([b[g] for g in order]),
            "b_hh": np.zeros(sum(b[g].size for g in order), np.float32)}


def convert_weights(class_name: str, cfg: Dict[str, Any],
                    named: Named) -> Tuple[Dict, Dict]:
    """One layer's keras1 ``(weight name, array)`` pairs → (parameter
    updates, buffer updates), keyed by the core's leaf names."""
    dim_ordering = cfg.get("dim_ordering", "th")
    arrays = [a for _, a in named]
    if class_name == "LSTM":
        # the core's fused layout is i, f, g(= keras c), o
        return _fused_gates(named, "ifco", "ifco", "LSTM"), {}
    if class_name == "GRU":
        # keras1 gates z (update), r (reset), h (candidate); the core's
        # fused layout is r, z, n
        return _fused_gates(named, "zrh", "rzh", "GRU"), {}
    if class_name == "SimpleRNN":
        Ws = [a for n, a in named if n.endswith("_W")]
        Us = [a for n, a in named if n.endswith("_U")]
        bs = [a for n, a in named if n.endswith("_b")]
        if not (len(Ws) == len(Us) == len(bs) == 1):
            raise NotImplementedError(
                "load_keras: SimpleRNN weight names do not follow the "
                "keras1 _W/_U/_b pattern")
        return {"w_ih": Ws[0].T, "w_hh": Us[0].T, "b_ih": bs[0],
                "b_hh": np.zeros(bs[0].size, np.float32)}, {}
    if class_name == "Dense":
        p = {"weight": arrays[0].T}
    elif class_name == "Convolution2D":
        k = arrays[0]
        if dim_ordering == "tf":          # (r, c, in, out) -> OIHW
            k = np.transpose(k, (3, 2, 0, 1))
        p = {"weight": k}
    elif class_name == "Convolution1D":
        # keras1 1-D kernel: (filter_length, 1, in, out) -> (out, in, L)
        k = arrays[0]
        if k.ndim == 4:
            k = np.transpose(k[:, 0], (2, 1, 0))
        p = {"weight": k}
        if not cfg.get("bias", True):
            # the core always has a bias (JAX's too, which keeps its
            # random init here): a bias-free layer imports a zero one
            p["bias"] = np.zeros(k.shape[0], np.float32)
    elif class_name == "BatchNormalization":
        gamma, beta, mean, var = arrays  # keras1 "running_std" IS variance
        return ({"weight": gamma, "bias": beta},
                {"running_mean": mean, "running_var": var})
    elif class_name == "Embedding":
        return {"weight": arrays[0]}, {}
    else:
        raise NotImplementedError(
            f"load_keras: weight import for {class_name!r} is not supported "
            "(architecture was built; set weights manually or retrain)")
    if len(arrays) > 1:
        p["bias"] = arrays[1]
    return p, {}


def _apply_updates(layer, index: int, updates: Dict[str, np.ndarray],
                   kind: str) -> None:
    """Copy ``updates`` into the one module of Keras layer ``layer`` that
    holds the first update's name as its own parameter (or buffer)."""
    def own(m):
        return dict(m.named_parameters(recurse=False) if kind == "params"
                    else m.named_buffers(recurse=False))

    anchor = next(iter(updates))
    hits = [m for m in layer.modules() if anchor in own(m)]
    if len(hits) != 1:
        raise ValueError(
            f"load_keras: could not locate the {anchor!r}-holding "
            f"{kind} of layer {index} unambiguously")
    target = own(hits[0])
    with torch.no_grad():
        for k, v in updates.items():
            if k not in target:
                # loading an orphan key would "succeed" while the layer
                # never reads it (e.g. an h5 bias for a bias=false json)
                raise ValueError(
                    f"load_keras: layer {index} has no parameter {k!r} "
                    f"(built: {sorted(target)}) — the json/h5 pair does "
                    "not match")
            t = target[k]
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(
                    f"load_keras: layer {index} weight {k!r} shape "
                    f"{v.shape} does not match the built model's "
                    f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(v, np.float32)))


def load_keras_weights(model, json_str: str, by_layer: Dict[str, Named],
                       source: str = "the weights"):
    """Copy keras1 weights, ``{layer name: [(weight name, array), ...]}``
    (what an HDF5 save holds), into ``model`` built from ``json_str`` by
    :func:`load_keras_json`; returns ``model``. ``source`` names where the
    arrays came from in the errors."""
    blob = json.loads(json_str)
    if blob["class_name"] != "Sequential":
        raise NotImplementedError(
            "load_keras: weight import is supported for Sequential models "
            "(functional architectures import without weights)")
    consumed = set()
    # tf ordering: load_keras_json moved input shapes and conv kernels to CHW,
    # so the model FLATTENS in CHW order, but a tf-ordered save's first
    # post-Flatten Dense kernel has its rows in HWC-flat order. Track the
    # Flatten of tf-ordered spatial features and permute that kernel's
    # input rows HWC-flat -> CHW-flat.
    pending_perm = None
    cur_tf = False
    for i, entry in enumerate(blob["config"]):
        cname, cfg = entry["class_name"], entry["config"]
        if "dim_ordering" in cfg:
            cur_tf = cfg["dim_ordering"] == "tf"
        if cname == "Flatten":
            shp = model.layers[i].input_shape
            if cur_tf and shp is not None and len(shp) == 3:
                c, h, w = shp
                # perm[chw_flat_position] = hwc_flat_row of the keras kernel
                pending_perm = np.arange(h * w * c).reshape(
                    (h, w, c)).transpose(2, 0, 1).ravel()
            else:
                pending_perm = None
        lname = cfg.get("name", "")
        arrays = by_layer.get(lname)
        if not arrays:
            if cname in _WEIGHTED_CLASSES:
                # random weights would "load" and predict garbage
                raise ValueError(
                    f"load_keras: weight-bearing layer {lname!r} ({cname}) "
                    f"has no weights in {source} — the json/h5 pair does "
                    f"not match (weight layers: {sorted(by_layer)})")
            continue
        consumed.add(lname)
        p_upd, s_upd = convert_weights(cname, cfg, arrays)
        if cname in _WEIGHTED_CLASSES and pending_perm is not None:
            if cname == "Dense":
                p_upd["weight"] = p_upd["weight"][:, pending_perm]
                pending_perm = None  # downstream features are 1-D again
            elif cname == "BatchNormalization":
                # per-feature vectors reorder the same way; the features
                # STAY HWC-flat, so the perm stays pending for the Dense
                p_upd = {k: v[pending_perm] for k, v in p_upd.items()}
                s_upd = {k: v[pending_perm] for k, v in s_upd.items()}
            else:
                raise NotImplementedError(
                    f"load_keras: tf-dim_ordering Flatten followed by "
                    f"{cname} — permuting this layer's weights from "
                    "HWC-flat to CHW-flat feature order is not "
                    "implemented; loading unpermuted weights would "
                    "silently predict garbage")
        layer = model.layers[i]
        if p_upd:
            _apply_updates(layer, i, p_upd, "params")
        if s_upd:
            _apply_updates(layer, i, s_upd, "buffers")
    orphans = {n for n, a in by_layer.items() if a} - consumed
    if orphans:
        raise ValueError(
            f"load_keras: weight layers {sorted(orphans)} in {source} match "
            "no layer in the json — the json/h5 pair does not match")
    return model


def load_keras(json_path: Optional[str] = None,
               hdf5_path: Optional[str] = None, device=None,
               generator: torch.Generator = None):
    """Reference ``Model.load_keras(json_path, hdf5_path)``: the
    architecture from the JSON definition and, with ``hdf5_path``, the
    Keras-1.2 HDF5 weights (Sequential models; read with h5py)."""
    if json_path is None:
        raise ValueError("load_keras needs json_path")
    with open(json_path) as f:
        json_str = f.read()
    model = load_keras_json(json_str, device=device, generator=generator)
    if hdf5_path is None:
        return model
    if json.loads(json_str)["class_name"] != "Sequential":
        raise NotImplementedError(
            "load_keras: weight import is supported for Sequential models "
            "(functional architectures import without weights)")
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "load_keras: reading Keras HDF5 weights needs h5py; without it "
            "pass the arrays to load_keras_weights") from e
    with h5py.File(hdf5_path, "r") as f:
        by_layer = _h5_layer_weights(f)
    return load_keras_weights(model, json_str, by_layer,
                              source=repr(hdf5_path))
