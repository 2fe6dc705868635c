"""The port's structured module format (``bigdl_tpu_torch/utils/
serializer.py``, ``save_module`` / ``load_module``), the twin of
``tests/test_serializer.py``'s sweep.

One case per module class that ``bigdl_tpu_torch.nn`` exports and per
Keras class of ``bigdl_tpu_torch.nn.keras``: the module is built, put in
eval mode, run, saved, loaded back onto the CPU, and its output must be
bitwise the one before (the same weights and ops on the same device); a
bare recurrent cell compares its parameters instead. The layers and
inputs come from the port's parity tests where they have a case
(``tests/test_torch_nn_tail.py``, ``test_torch_layers_extra.py``,
``test_torch_layers_more.py``, ``test_torch_sparse.py``,
``test_torch_keras.py``), else from the table below. The completeness
check holds every exported class to a case or to ``EXEMPT``, each member
with why.

Besides: the version check, aliased tensors keeping identity (and tied
weights staying tied), bf16 tensors, directories made, a generator's
state, the refusal of a JAX ``bigdl_tpu.module`` file, of a class from
outside the port (also one a port module imports), of a dtype name that
names no dtype and of a callable, and ``Highway`` (which JAX saves but
cannot load) round-tripping.
"""

import functools
import json
import zipfile

import numpy as np
import pytest
import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.nn import keras as K
from bigdl_tpu_torch.nn.module import AbstractModule
from tests.torch_parity import one_torch_thread  # noqa: F401

R = np.random.default_rng(7)


def x(*shape):
    return torch.from_numpy(R.standard_normal(shape).astype(np.float32))


def _cell(kind):
    return {"RnnCell": lambda: nn.RnnCell(3, 4, device="cpu"),
            "LSTM": lambda: nn.LSTM(3, 4, device="cpu"),
            "GRU": lambda: nn.GRU(3, 4, device="cpu"),
            "LSTMPeephole": lambda: nn.LSTMPeephole(3, 4, device="cpu"),
            "ConvLSTMPeephole": lambda: nn.ConvLSTMPeephole(
                2, 3, 3, 3, device="cpu"),
            "MultiRNNCell": lambda: nn.MultiRNNCell(
                [nn.LSTM(3, 4, device="cpu"), nn.LSTM(4, 4, device="cpu")]),
            }[kind]()


def _graph():
    inp = nn.Input()
    a = nn.Linear(4, 3, device="cpu").inputs(inp)
    b = nn.Tanh().inputs(inp)
    c = nn.Linear(4, 3, device="cpu").inputs(b)
    out = nn.CAddTable().inputs(a, c)
    return nn.Graph(inp, out)


def _quantized_linear():
    return nn.QuantizedLinear.from_linear(nn.Linear(4, 3, device="cpu"))


def _quantized_conv():
    return nn.QuantizedSpatialConvolution.from_conv(
        nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, device="cpu"))


#: class name -> (factory, input or None for a bare cell)
OWN = {
    "Linear": (lambda: nn.Linear(4, 3, device="cpu"), x(2, 4)),
    "ReLU": (lambda: nn.ReLU(), x(2, 4)),
    "Tanh": (lambda: nn.Tanh(), x(2, 4)),
    "LogSoftMax": (lambda: nn.LogSoftMax(), x(2, 4)),
    "Identity": (lambda: nn.Identity(), x(2, 4)),
    "Echo": (lambda: nn.Echo(), x(2, 4)),
    "Dropout": (lambda: nn.Dropout(0.4), x(2, 4)),
    "Reshape": (lambda: nn.Reshape([2, 6], batch_mode=True), x(2, 3, 4)),
    "Select": (lambda: nn.Select(2, -1), x(2, 3, 4)),
    "CAddTable": (lambda: nn.CAddTable(), [x(2, 3), x(2, 3)]),
    "FlattenTable": (lambda: nn.FlattenTable(),
                     [x(2, 3), [x(2, 2), x(2, 1)]]),
    "BatchNormalization": (lambda: nn.BatchNormalization(4, device="cpu"),
                           x(3, 4)),
    "SpatialBatchNormalization": (
        lambda: nn.SpatialBatchNormalization(3, device="cpu"),
        x(2, 3, 4, 4)),
    "SpatialConvolution": (lambda: nn.SpatialConvolution(
        3, 4, 3, 3, 1, 1, 1, 1, device="cpu"), x(2, 3, 6, 6)),
    "SpatialMaxPooling": (lambda: nn.SpatialMaxPooling(2, 2, 2, 2),
                          x(2, 3, 6, 6)),
    "SpatialAveragePooling": (lambda: nn.SpatialAveragePooling(2, 2, 2, 2),
                              x(2, 3, 6, 6)),
    "SpatialCrossMapLRN": (lambda: nn.SpatialCrossMapLRN(3), x(2, 4, 5, 5)),
    "Sequential": (lambda: nn.Sequential().add(
        nn.Linear(4, 3, device="cpu")).add(nn.ReLU()), x(2, 4)),
    "Concat": (lambda: nn.Concat(2).add(nn.Linear(4, 3, device="cpu")).add(
        nn.Linear(4, 2, device="cpu")), x(2, 4)),
    "ConcatTable": (lambda: nn.ConcatTable().add(nn.Identity()).add(
        nn.Linear(4, 2, device="cpu")), x(2, 4)),
    "Remat": (lambda: nn.Remat(nn.Linear(4, 3, device="cpu")), x(2, 4)),
    "Graph": (_graph, x(2, 4)),
    "Recurrent": (lambda: nn.Recurrent().add(nn.LSTM(3, 4, device="cpu")),
                  x(2, 5, 3)),
    "BiRecurrent": (lambda: nn.BiRecurrent().add(
        nn.GRU(3, 4, device="cpu")), x(2, 5, 3)),
    "RecurrentDecoder": (lambda: nn.RecurrentDecoder(3).add(
        nn.LSTM(4, 4, device="cpu")), x(2, 4)),
    "TimeDistributed": (lambda: nn.TimeDistributed(
        nn.Linear(3, 2, device="cpu")), x(2, 5, 3)),
    "MultiHeadAttention": (lambda: nn.MultiHeadAttention(
        8, 2, device="cpu"), x(2, 5, 8)),
    "QuantizedLinear": (_quantized_linear, x(2, 4)),
    "QuantizedSpatialConvolution": (_quantized_conv, x(2, 3, 5, 5)),
    "MaskedSelect": (lambda: nn.MaskedSelect(),
                     [x(2, 3), torch.tensor([[1., 0., 1.], [0., 1., 1.]])]),
    "keras.Sequential": (lambda: K.Sequential(device="cpu").add(
        K.Dense(3, input_shape=(4,))).add(K.Dropout(0.2)), x(2, 4)),
    "DenseToSparse": (lambda: nn.DenseToSparse(),
                      torch.tensor([[0., 1.5, 0.], [2., 0., -1.]])),
    **{k: (functools.partial(_cell, k), None)
       for k in ("RnnCell", "LSTM", "GRU", "LSTMPeephole",
                 "ConvLSTMPeephole", "MultiRNNCell")},
}

#: bases, aliases and classes that cannot round-trip, each with why
EXEMPT = {
    "AbstractModule": "the base class; no forward of its own",
    "TensorModule": "a marker base; no forward of its own",
    "Container": "the containers' base; no forward of its own",
    "Cell": "the recurrent cells' base; no forward of its own",
    "Module": "an alias of AbstractModule",
    "StaticGraph": "an alias of Graph (its case)",
    "SequenceBeamSearch": "holds the caller's symbols_to_logits function, "
                          "code the format does not store (refused, see "
                          "test_callable_is_refused)",
}


def _torch(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v))
    if isinstance(v, list):
        return [_torch(e) for e in v]
    return v


@functools.lru_cache(maxsize=1)
def _from_parity_tests():
    """class name -> (factory, input) of the first case of each class in
    the port's layer parity tests, and ``keras.<class>`` likewise."""
    import tests.test_torch_keras as tk
    import tests.test_torch_layers_extra as te
    import tests.test_torch_layers_more as tm
    import tests.test_torch_nn_tail as tt
    import tests.test_torch_sparse as ts

    out = {}
    for mod in (tt, te, tm):
        for name, (_, layer, inp, _) in mod._cases().items():
            out.setdefault(type(layer).__name__, (
                functools.partial(lambda n, m: m._cases()[n][1], name, mod),
                _torch(inp)))
    for name, (_, layer, inp) in ts._layer_cases().items():
        port = [p[1] for p in inp] if isinstance(inp, list) else inp[1]
        out.setdefault(type(layer).__name__, (
            functools.partial(lambda n: ts._layer_cases()[n][1], name),
            port))
    for name, (_, model, inp, _) in tk._cases().items():
        inner = model.layers[0] if isinstance(model, K.Sequential) else None
        for m in ([model] if inner is None else [inner]):
            out.setdefault(f"keras.{type(m).__name__}", (
                functools.partial(lambda n: tk._cases()[n][1], name),
                _torch(inp)))
        if name.startswith("Model_Merge"):
            out.setdefault("keras.Merge", (
                functools.partial(lambda n: tk._cases()[n][1], name),
                _torch(inp)))
    return out


def _exported():
    return {n for n in dir(nn) if isinstance(getattr(nn, n), type)
            and issubclass(getattr(nn, n), AbstractModule)}


def _keras_classes():
    return {f"keras.{n}" for n, c in vars(K).items() if isinstance(c, type)
            and issubclass(c, K.KerasLayer) and not n.startswith("_")
            and c is not K.KerasLayer}


CASES = sorted((_exported() - set(EXEMPT)) | _keras_classes())


def _factory(name):
    return OWN[name] if name in OWN else _from_parity_tests()[name]


def test_sweep_is_complete():
    """Every exported class and every Keras class has a case or is in
    EXEMPT."""
    covered = set(OWN) | set(_from_parity_tests())
    missing = set(CASES) - covered
    assert not missing, sorted(missing)
    assert set(EXEMPT) <= _exported()


def _same(a, b):
    from bigdl_tpu_torch.tensor import SparseTensor

    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, SparseTensor):
        _same([a.indices, a.values], [b.indices, b.values])
        assert tuple(a.shape) == tuple(b.shape)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_roundtrip(name, tmp_path):
    factory, inp = _factory(name)
    m = factory()
    m.evaluate()
    before = None
    if inp is not None:
        with torch.no_grad():
            before = m(inp)
    path = str(tmp_path / "m.bigdl")
    m.save_module(path)
    m2 = AbstractModule.load_module(path, device="cpu")
    assert type(m2) is type(m)
    m2.evaluate()
    if inp is not None:
        with torch.no_grad():
            _same(before, m2(inp))
    else:   # a bare cell: its parameters
        _same([p for _, p in m.named_parameters()],
              [p for _, p in m2.named_parameters()])
    assert [n for n, _ in m.named_buffers()] == \
        [n for n, _ in m2.named_buffers()]


def _rewrite(path, edit):
    with zipfile.ZipFile(path) as z:
        spec = json.loads(z.read("spec.json"))
        arrays = z.read("arrays.npz")
    edit(spec)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("spec.json", json.dumps(spec))
        z.writestr("arrays.npz", arrays)


def test_version_check(tmp_path):
    from bigdl_tpu_torch.utils.serializer import FORMAT_VERSION

    p = str(tmp_path / "m.bigdl")
    nn.Linear(2, 2, device="cpu").save_module(p)
    _rewrite(p, lambda s: s.update(version=FORMAT_VERSION + 1))
    with pytest.raises(ValueError, match="newer"):
        AbstractModule.load_module(p, device="cpu")
    with pytest.raises(FileExistsError):
        nn.Linear(2, 2, device="cpu").save_module(p)


def test_aliased_tensors_keep_identity(tmp_path):
    """A module used twice stays one module, a tied weight one Parameter,
    and the pair trains as one."""
    a = nn.Linear(4, 4, device="cpu")
    b = nn.Linear(4, 4, device="cpu")
    b.weight = a.weight                               # tie
    m = nn.Sequential().add(a).add(b).add(a)
    p = str(tmp_path / "tied.bigdl")
    m.save_module(p)
    m2 = AbstractModule.load_module(p, device="cpu")
    assert m2[1].weight is m2[0].weight
    assert m2[2] is m2[0]
    with zipfile.ZipFile(p) as z:
        assert len(json.loads(z.read("spec.json"))["tensors"]) == 3


def test_bf16_tensors_and_dtypes(tmp_path):
    m = nn.Linear(3, 5, device="cpu").to(torch.bfloat16)
    m.register_buffer("steps", torch.arange(4, dtype=torch.int64))
    m.register_buffer("flags", torch.tensor([True, False]))
    p = str(tmp_path / "bf16.bigdl")
    m.save_module(p)
    m2 = AbstractModule.load_module(p, device="cpu")
    for name, t in list(m.named_parameters()) + list(m.named_buffers()):
        t2 = dict(list(m2.named_parameters()) + list(m2.named_buffers()))[name]
        assert t2.dtype == t.dtype and torch.equal(t2, t), name
    assert m2.weight.requires_grad and isinstance(m2.weight, torch.nn.Parameter)
    frozen = nn.Linear(2, 2, device="cpu")
    frozen.weight.requires_grad_(False)
    frozen.save_module(p, over_write=True)
    assert not AbstractModule.load_module(p, device="cpu").weight.requires_grad


def test_generator_state_round_trips(tmp_path):
    """A layer's generator comes back with its state: the next draws
    agree."""
    g = torch.Generator().manual_seed(11)
    conv = nn.SpatialConvolution(2, 3, 3, 3, device="cpu", generator=g)
    torch.rand(5, generator=g)
    p = str(tmp_path / "gen.bigdl")
    conv.save_module(p)
    conv2 = AbstractModule.load_module(p, device="cpu")
    assert torch.equal(torch.rand(7, generator=conv._generator),
                       torch.rand(7, generator=conv2._generator))


def test_directories_are_created_and_the_write_is_atomic(tmp_path):
    p = tmp_path / "new" / "sub" / "m.bigdl"
    nn.Linear(3, 2, device="cpu").save_module(str(p))
    assert p.exists() and [f.name for f in p.parent.iterdir()] == ["m.bigdl"]
    AbstractModule.load_module(str(p), device="cpu")


def test_jax_file_is_refused(tmp_path):
    import bigdl_tpu.nn as J

    p = str(tmp_path / "jax.bigdl")
    J.Linear(3, 2).save_module(p)
    with pytest.raises(ValueError, match="bigdl_tpu.module.*JAX"):
        AbstractModule.load_module(p, device="cpu")


def test_foreign_class_is_refused(tmp_path):
    p = str(tmp_path / "m.bigdl")
    nn.Linear(3, 2, device="cpu").save_module(p)

    def foreign(spec):
        spec["objects"][0]["class"] = "collections:OrderedDict"

    _rewrite(p, foreign)
    with pytest.raises(ValueError, match="refusing.*bigdl_tpu_torch"):
        AbstractModule.load_module(p, device="cpu")

    class Outside(nn.Identity):     # a subclass defined outside the port
        pass

    with pytest.raises(TypeError, match="cannot serialize.*Outside"):
        Outside().save_module(p, over_write=True)
    with pytest.raises(TypeError, match="cannot serialize"):
        bad = nn.Identity()
        bad.note = object()
        bad.save_module(p, over_write=True)


@pytest.mark.parametrize("name", [
    "bigdl_tpu_torch.native.decode:ThreadPoolExecutor",
    "bigdl_tpu_torch.serving.engine:deque"])
def test_foreign_class_imported_by_a_port_module_is_refused(tmp_path, name):
    """The file names a port module, but the class found there was
    defined elsewhere: nothing of it is built."""
    p = str(tmp_path / "m.bigdl")
    nn.Linear(3, 2, device="cpu").save_module(p)
    _rewrite(p, lambda s: s["objects"][0].update({"class": name}))
    with pytest.raises(ValueError, match="not a class of bigdl_tpu_torch "
                                         "defined there"):
        AbstractModule.load_module(p, device="cpu")


@pytest.mark.parametrize("where", ["node", "tensor"])
def test_a_dtype_name_must_name_a_dtype(tmp_path, where):
    """A dtype node (an attribute that holds a dtype) or a tensor's dtype
    that names another torch attribute, a function here, is refused."""
    p = str(tmp_path / "m.bigdl")
    m = nn.Linear(3, 2, device="cpu")
    m.compute_dtype = torch.float16
    m.save_module(p)
    assert AbstractModule.load_module(p, device="cpu").compute_dtype \
        is torch.float16

    def edit(spec):
        if where == "tensor":
            spec["tensors"][0]["dtype"] = "load"
        else:
            attrs = spec["objects"][0]["attrs"]
            assert attrs["compute_dtype"] == {"__dtype__": "float16"}
            attrs["compute_dtype"] = {"__dtype__": "load"}

    _rewrite(p, edit)
    with pytest.raises(ValueError, match="'load' is not a torch dtype"):
        AbstractModule.load_module(p, device="cpu")


def test_callable_is_refused(tmp_path):
    search = nn.SequenceBeamSearch(lambda ids, i, c: (ids, c),
                                   vocab_size=5, beam_size=2)
    with pytest.raises(TypeError, match="SequenceBeamSearch.*callable"):
        search.save_module(str(tmp_path / "s.bigdl"))


def test_highway_round_trips(tmp_path):
    """JAX saves a Highway but refuses to load it (its core is a class
    local to build_core); the port's core is a module-level class."""
    m = K.Sequential(device="cpu").add(K.Highway(input_shape=(6,))).add(
        K.Dense(2))
    xx = x(3, 6)
    before = m(xx)
    p = str(tmp_path / "hw.bigdl")
    m.save_module(p)
    m2 = AbstractModule.load_module(p, device="cpu")
    assert torch.equal(m2(xx), before)
    assert type(m2.layers[0]._core) is K.HighwayCore


def test_load_module_defaults_to_the_card(tmp_path):
    p = str(tmp_path / "m.bigdl")
    nn.Linear(2, 2, device="cpu").save_module(p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            AbstractModule.load_module(p)
