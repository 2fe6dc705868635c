"""The port's int8 inference (bigdl_tpu_torch/nn/quantized.py) against the
JAX package's (bigdl_tpu/nn/quantized.py) on the CPU, from the same float
weights (numpy-seeded inputs):

* ``quantize_symmetric``: scales within one f32 ulp, codes equal except
  where ``|w / scale|`` lies within 1e-6 (relative) of a .5 boundary,
  where a scale one ulp apart may round the other way (counted, and the
  count bounded); half-to-even on exact .5 ties;
* ``QuantizedLinear`` and ``QuantizedSpatialConvolution`` (stride,
  SAME padding, groups, a 3-D input) under both schemes: the exact int32
  product and the outputs;
* the cases of tests/test_quantized.py the port can run (Sequential,
  Graph, LeNet-5 and VGG-CIFAR argmax agreement, the scheme check), the
  FusedGraph refusal, a quantized ResNet-8's tree keys, shapes and dtypes,
  a JAX quantized tree loaded with ``load_jax_tree``, ``Module.save`` /
  ``load`` bitwise, and evaluation (``Evaluator``, ``evaluate``,
  ``predict``, ``predict_class``) on a quantized Graph and Sequential.

Tolerances: weight_only outputs 1e-5 relative to the output's largest
magnitude (f32 sums in another order; every bf16 product is exact);
dynamic outputs the same, plus, per activation code that rounded the
other way at a boundary, one code step times the largest scale product;
int32 accumulators bitwise wherever the codes agree; argmax agreement of
a quantized model with JAX's quantized model 100% where the JAX top-two
gap exceeds 1e-4, and with the float model at the JAX test's bars."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn import quantized as jq
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.utils.params_tree import load_jax_tree
from tests.torch_parity import numpy_trees, one_torch_thread  # noqa: F401

OUT_RTOL = 1e-5
BOUNDARY = 1e-6


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _code_mismatches(w, scale, got_q, want_q):
    """Positions where the codes differ; each must lie at a .5 boundary
    of ``w / scale``."""
    r = np.abs(np.asarray(w, np.float64) / np.asarray(scale, np.float64))
    off = np.abs(r - np.floor(r) - 0.5)
    bad = np.asarray(got_q) != np.asarray(want_q)
    assert np.all(off[bad] <= BOUNDARY * np.maximum(r[bad], 1.0)), \
        "a code differs away from a rounding boundary"
    assert np.all(np.abs(np.asarray(got_q, np.int32)[bad]
                         - np.asarray(want_q, np.int32)[bad]) == 1)
    return int(bad.sum())


# -------------------------------------------------------- quantize_symmetric


@pytest.mark.parametrize("shape,dims,axis", [
    ((48, 40), -1, 1),
    ((16, 8, 3, 3), (-3, -2, -1), (1, 2, 3)),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spelling", ["dims", "axis_keyword"])
def test_quantize_symmetric_matches_jax(shape, dims, axis, seed, spelling):
    """Both spellings: the port's negative dims positionally, and JAX's own
    call, ``axis=`` by keyword with JAX's dims (``quantized.py:66``,
    ``:134``)."""
    w = _np(seed, *shape, scale=0.3)
    w.reshape(shape[0], -1)[0] = 0.0           # an all-zero channel: 1e-8
    jqv, jscale = jq.quantize_symmetric(jnp.asarray(w), axis=axis)
    if spelling == "dims":
        got_q, got_s = tq.quantize_symmetric(torch.from_numpy(w), dims)
    else:
        got_q, got_s = tq.quantize_symmetric(torch.from_numpy(w), axis=axis)
    jqv, jscale = np.asarray(jqv), np.asarray(jscale)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_s.shape == jscale.shape
    assert _ulps(got_s.numpy(), jscale).max() <= 1
    n = _code_mismatches(w, jscale, got_q.numpy(), jqv)
    assert n <= max(1, w.size // 1000), n


def test_quantize_symmetric_rounds_half_to_even_and_clips():
    """amax 127 gives scale 1.0 exactly: ties round to even, as in JAX."""
    w = np.asarray([[127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 126.5, 1.49]],
                   np.float32)
    jqv, jscale = jq.quantize_symmetric(jnp.asarray(w), 1)
    got_q, got_s = tq.quantize_symmetric(torch.from_numpy(w), -1)
    assert got_s.item() == np.asarray(jscale).item() == 1.0
    assert got_q.tolist() == np.asarray(jqv).tolist() == \
        [[127, 2, 4, -2, 0, 0, 126, 1]]


# ------------------------------------------------------ the quantized layers


def _linear_pair(n_in, n_out, seed, bias=True):
    from bigdl_tpu.nn import Linear as JLinear
    from bigdl_tpu_torch.nn import Linear

    jl = JLinear(n_in, n_out, with_bias=bias)
    jl.params = {"weight": jnp.asarray(_np(seed, n_out, n_in, scale=0.2))}
    if bias:
        jl.params["bias"] = jnp.asarray(_np(seed + 1, n_out, scale=0.1))
    tl = Linear(n_in, n_out, with_bias=bias, device="cpu")
    load_jax_tree(tl, jax.device_get(jl.params))
    return jl, tl


def test_int8_matmul_is_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, size=(7, 37)).astype(np.int8)
    b = rng.integers(-127, 128, size=(10, 37)).astype(np.int8)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("scheme", ["dynamic", "weight_only"])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_quantized_linear_matches_jax(scheme, lead, bias):
    jl, tl = _linear_pair(24, 40, seed=4, bias=bias)
    x = _np(9, *lead, 24, scale=2.0)
    jm = jq.QuantizedLinear.from_linear(jl, scheme)
    tm = tq.QuantizedLinear.from_linear(tl, scheme)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jm.params)
    w_scale = tm.w_scale.numpy()
    n_codes = _code_mismatches(tl.weight.detach().numpy(), w_scale,
                               tm.weight_q.numpy(), np.asarray(
                                   jm.params["weight_q"]))
    # a weight code one step off moves one product by |bf16(x)| * scale
    slack = n_codes * float(np.abs(x).max()) * float(w_scale.max())
    if scheme == "dynamic":
        xs = np.asarray(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), -1,
                                            keepdims=True), 1e-8) / 127.0)
        xq_j = np.clip(np.round(x / xs), -127, 127)
        xq_t, xs_t = tq._quantize_rows(torch.from_numpy(x), -1)
        assert _ulps(xs_t.numpy(), xs).max() <= 1
        n_codes += _code_mismatches(x, xs, xq_t.numpy(), xq_j)
        slack = n_codes * 127 * float(xs.max()) * float(w_scale.max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= OUT_RTOL * float(np.abs(want).max()) + slack, err


def test_dynamic_linear_accumulators_bitwise_where_codes_agree():
    """The int32 product of JAX's own codes through the port's
    ``int8_matmul`` equals JAX's ``dot_general(preferred=int32)``."""
    jl, tl = _linear_pair(40, 24, seed=6)
    jm = jq.QuantizedLinear.from_linear(jl, "dynamic")
    x = _np(11, 9, 40, scale=3.0)
    xs = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), -1, keepdims=True),
                     1e-8) / 127.0
    xq = jnp.clip(jnp.round(jnp.asarray(x) / xs), -127, 127).astype(jnp.int8)
    want = jax.lax.dot_general(xq, jm.params["weight_q"],
                               (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tq.int8_matmul(torch.from_numpy(np.array(xq)),
                         torch.from_numpy(np.array(jm.params["weight_q"])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CONV_CASES = [
    dict(n_in=3, n_out=8, k=3, stride=1, pad=1, group=1, bias=True),
    dict(n_in=4, n_out=6, k=3, stride=2, pad=-1, group=1, bias=False),
    dict(n_in=4, n_out=6, k=1, stride=1, pad=0, group=2, bias=True),
    dict(n_in=3, n_out=5, k=5, stride=2, pad=2, group=1, bias=True),
]


@pytest.mark.parametrize("scheme", ["dynamic", "weight_only"])
@pytest.mark.parametrize("cfg", CONV_CASES)
def test_quantized_conv_matches_jax(cfg, scheme):
    from bigdl_tpu.nn import SpatialConvolution as JConv
    from bigdl_tpu_torch.nn import SpatialConvolution

    args = (cfg["n_in"], cfg["n_out"], cfg["k"], cfg["k"], cfg["stride"],
            cfg["stride"], cfg["pad"], cfg["pad"], cfg["group"])
    jc = JConv(*args, with_bias=cfg["bias"])
    jc.params = {"weight": jnp.asarray(_np(
        5, cfg["n_out"], cfg["n_in"] // cfg["group"], cfg["k"], cfg["k"],
        scale=0.3))}
    if cfg["bias"]:
        jc.params["bias"] = jnp.asarray(_np(6, cfg["n_out"], scale=0.1))
    tc = SpatialConvolution(*args, with_bias=cfg["bias"], device="cpu")
    load_jax_tree(tc, jax.device_get(jc.params))
    jm = jq.QuantizedSpatialConvolution.from_conv(jc, scheme)
    tm = tq.QuantizedSpatialConvolution.from_conv(tc, scheme)
    assert tm.w_scale.shape == (cfg["n_out"], 1, 1, 1)
    w_scale = tm.w_scale.numpy()
    n_w = _code_mismatches(tc.weight.detach().numpy(), w_scale,
                           tm.weight_q.numpy(),
                           np.asarray(jm.params["weight_q"]))
    for shape in ((2, cfg["n_in"], 9, 7), (cfg["n_in"], 8, 8)):
        x = _np(7, *shape, scale=2.0)
        want = np.asarray(jm.forward(jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        slack = n_w * float(np.abs(x).max()) * float(w_scale.max())
        if scheme == "dynamic":
            x4 = x if x.ndim == 4 else x[None]
            xs = np.asarray(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x4)),
                                                (1, 2, 3), keepdims=True),
                                        1e-8) / 127.0)
            xq_t, xs_t = tq._quantize_rows(torch.from_numpy(x4), (1, 2, 3))
            assert _ulps(xs_t.numpy(), xs).max() <= 1
            n = n_w + _code_mismatches(
                x4, xs, xq_t.numpy(), np.clip(np.round(x4 / xs), -127, 127))
            slack = n * 127 * float(xs.max()) * float(w_scale.max())
        err = float(np.abs(got.numpy() - want).max())
        assert err <= OUT_RTOL * float(np.abs(want).max()) + slack, \
            (shape, err)


def test_dynamic_conv_accumulators_bitwise_and_chunked(monkeypatch):
    """The im2col int32 convolution equals JAX's int8 ``conv_general_
    dilated`` bitwise on the same codes, in one chunk and in chunks of
    one image."""
    from bigdl_tpu_torch.nn import SpatialConvolution

    conv = SpatialConvolution(4, 6, 3, 3, 2, 2, -1, -1, 2, device="cpu")
    tm = tq.QuantizedSpatialConvolution.from_conv(conv, "dynamic")
    xq = np.random.default_rng(8).integers(-127, 128, size=(3, 4, 9, 11)
                                           ).astype(np.int8)
    (ph, pw) = conv._padding(9, 11)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(tm.weight_q.numpy()), (2, 2),
        (ph, pw), dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=2, preferred_element_type=jnp.int32))
    got = tm._int8_conv(torch.from_numpy(xq))
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(tq, "IM2COL_CHUNK", 1)
    np.testing.assert_array_equal(tm._int8_conv(torch.from_numpy(xq)).numpy(),
                                  want)


# ------------------------------------------------------------ whole models


def test_module_quantize_sequential():
    from bigdl_tpu.nn import Linear as JL, ReLU as JR, Sequential as JS
    from bigdl_tpu_torch import nn as tnn

    jm = JS().add(JL(12, 24)).add(JR()).add(JL(24, 5))
    jm._ensure_params()
    tm = (tnn.Sequential().add(tnn.Linear(12, 24, device="cpu"))
          .add(tnn.ReLU()).add(tnn.Linear(24, 5, device="cpu")))
    load_jax_tree(tm, jax.device_get(jm.params))
    x = _np(3, 3, 12)
    with torch.no_grad():
        want_f = tm(torch.from_numpy(x)).numpy()
    keys = list(tm._modules)
    q = tm.quantize()
    assert q is tm and not q.training and list(q._modules) == keys
    assert isinstance(q[0], tnn.QuantizedLinear)
    assert isinstance(q[2], tnn.QuantizedLinear)
    assert q[0].name == keys[0].split(":", 1)[1]
    want = np.asarray(jm.quantize().forward(jnp.asarray(x)))
    with torch.no_grad():
        got = q(torch.from_numpy(x))
    assert _rel(got, want_f) < 0.1
    assert _rel(got, want) <= 1e-4


def test_module_quantize_graph():
    from bigdl_tpu.nn import Graph as JG, Input as JI, Linear as JL
    from bigdl_tpu.nn import ReLU as JR
    from bigdl_tpu_torch import nn as tnn

    inp = JI()
    h = JR().inputs(JL(10, 20).inputs(inp))
    jg = JG(inp, JL(20, 4).inputs(h))
    jg._ensure_params()
    inp = tnn.Input()
    h = tnn.ReLU().inputs(tnn.Linear(10, 20, device="cpu").inputs(inp))
    tg = tnn.Graph(inp, tnn.Linear(20, 4, device="cpu").inputs(h))
    load_jax_tree(tg, jax.device_get(jg.params))
    x = _np(4, 5, 10)
    with torch.no_grad():
        want_f = tg(torch.from_numpy(x)).numpy()
    q = tg.quantize("weight_only")
    assert sum(isinstance(m, tnn.QuantizedLinear) for m in q.layers()) == 2
    assert all(n.module in q.layers() for n in q.topo)
    want = np.asarray(jg.quantize("weight_only").forward(jnp.asarray(x)))
    with torch.no_grad():
        got = q(torch.from_numpy(x))
    assert _rel(got, want_f) < 0.1
    assert _rel(got, want) <= OUT_RTOL


def test_unknown_scheme_raises_even_with_nothing_to_quantize():
    from bigdl_tpu_torch import nn as tnn

    for m in (tnn.Sequential().add(tnn.ReLU()),
              tnn.Sequential().add(tnn.Linear(3, 2, device="cpu"))):
        with pytest.raises(ValueError, match="scheme"):
            tq.Quantizer.quantize(m, scheme="int4")
    with pytest.raises(ValueError, match="scheme"):
        tq.QuantizedLinear(torch.zeros(2, 3, dtype=torch.int8),
                           torch.ones(2, 1), scheme="int4")


def test_weight_only_scheme_closer_than_dynamic():
    """tests/test_quantized.py's twin: weight_only never rounds the
    activations, so it lands at least as close to the float output."""
    from bigdl_tpu_torch import nn as tnn

    m = (tnn.Sequential()
         .add(tnn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, device="cpu",
                                     generator=torch.Generator()
                                     .manual_seed(1)))
         .add(tnn.ReLU()))
    x = torch.from_numpy(_np(2, 2, 3, 8, 8))
    with torch.no_grad():
        want = m(x)
        twin = copy.deepcopy(m)
        got_d = tq.Quantizer.quantize(m, "dynamic")(x)
        got_w = tq.Quantizer.quantize(twin, "weight_only")(x)
    err_w = float((got_w - want).abs().max())
    err_d = float((got_d - want).abs().max())
    assert err_w <= err_d + 1e-6, (err_w, err_d)
    assert err_w < 0.1 * max(1.0, float(want.abs().max()))


def _top2_gap(out):
    s = np.sort(np.asarray(out), -1)
    return s[:, -1] - s[:, -2]


def _argmax_checks(jm, tm, x, scheme, bar):
    """Quantize both; the port's argmax equals JAX's quantized argmax
    wherever JAX's top-two gap exceeds 1e-4, and agrees with the float
    model at the JAX test's bar."""
    with torch.no_grad():
        want_f = tm(torch.from_numpy(x)).numpy().argmax(-1)
    jout = np.asarray(jq.Quantizer.quantize(jm, scheme).forward(
        jnp.asarray(x)))
    with torch.no_grad():
        got = tm.quantize(scheme)(torch.from_numpy(x)).numpy()
    clear = _top2_gap(jout) > 1e-4
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  jout.argmax(-1)[clear])
    assert (got.argmax(-1) == want_f).mean() >= bar


@pytest.mark.parametrize("scheme", ["dynamic", "weight_only"])
def test_quantized_lenet_agrees_with_jax_and_float(scheme):
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.lenet import LeNet5

    RNG.set_seed(42)
    jm = JLeNet5(10)
    jm._ensure_params()
    jm.evaluate()
    tm = LeNet5(10, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    tm.evaluate()
    x = np.random.default_rng(0).random((32, 28 * 28)).astype(np.float32)
    _argmax_checks(jm, tm, x, scheme, 0.9)


def test_quantized_vgg_cifar_agrees_with_jax_and_float():
    from bigdl_tpu.models import vgg as jvgg
    from bigdl_tpu_torch.models import vgg as tvgg

    jm = jvgg.VggForCifar10(10, has_dropout=False)
    params, state = numpy_trees(jm, 6)
    jm.params, jm.state = params, state
    jm.evaluate()
    tm = tvgg.VggForCifar10(10, has_dropout=False, device="cpu")
    load_jax_tree(tm, params, state)
    tm.evaluate()
    x = np.random.default_rng(1).random((8, 3, 32, 32)).astype(np.float32)
    _argmax_checks(jm, tm, x, "dynamic", 0.75)


def test_fused_graph_refused_as_jax_cannot_run_it():
    """JAX's Quantizer returns a FusedGraph whose forward raises (its
    fused plan still holds the float convolutions), a fault of the
    reference (ROADMAP C.1); the port refuses the FusedGraph up front and
    leaves it float."""
    from tests.test_torch_resnet import _tiny_pair, _x
    from bigdl_tpu.nn.tpu_fusion import FusedGraph as JFused
    from bigdl_tpu_torch.nn import SpatialConvolution
    from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph

    jg, tg = _tiny_pair(8)
    jf = jq.Quantizer.quantize(JFused(jg), "dynamic")
    with pytest.raises(KeyError):
        jf.forward(_x())
    tf = FusedGraph(tg)
    with pytest.raises(NotImplementedError, match="FusedGraph"):
        tq.Quantizer.quantize(tf, "dynamic")
    with pytest.raises(NotImplementedError, match="FusedGraph"):
        from bigdl_tpu_torch.nn import Sequential

        Sequential().add(FusedGraph(_tiny_pair(8)[1])).quantize()
    assert any(isinstance(m, SpatialConvolution) for m in tg.modules())


# ----------------------------------------------------- ResNet-8 and its tree


def _flat(tree, prefix=""):
    """{index path: (shape, dtype)} of a params tree, children by index."""
    out = {}
    for k, v in tree.items():
        key = k.split(":", 1)[0]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}/"))
        else:
            out[prefix + key] = (tuple(v.shape),
                                 str(v.dtype).replace("torch.", ""))
    return out


@pytest.fixture(scope="module")
def resnet8():
    """(JAX ResNet-8 with numpy trees, its trees)."""
    from bigdl_tpu.models.resnet import ResNet as JResNet

    jm = JResNet(10, {"depth": 8, "shortcutType": "A",
                      "dataSet": "cifar10"})
    params, state = numpy_trees(jm, 12)
    return jm, params, state


def _port_resnet8(params, state):
    from bigdl_tpu_torch.models.resnet import ResNet

    tm = ResNet(10, {"depth": 8, "shortcutType": "A", "dataSet": "cifar10"},
                device="cpu")
    load_jax_tree(tm, params, state)
    return tm.evaluate()


def _jax_quantized(resnet8, scheme):
    jm, params, state = resnet8
    jm = copy.deepcopy(jm)
    jm.params, jm.state = params, state
    jm.evaluate()
    return jq.Quantizer.quantize(jm, scheme)


@pytest.mark.parametrize("scheme", ["dynamic", "weight_only"])
def test_quantized_resnet8_tree_equals_jax(resnet8, scheme):
    from bigdl_tpu_torch.models.transformer import _params_tree

    jqm = _jax_quantized(resnet8, scheme)
    tm = _port_resnet8(*resnet8[1:]).quantize(scheme)
    want = _flat(jax.device_get(jqm.params))
    assert _flat(_params_tree(tm)) == want
    assert sum(v[1] == "int8" for v in want.values()) == 8   # 7 conv + fc


def test_jax_quantized_tree_loads_and_outputs_match(resnet8, tmp_path):
    """The JAX quantized tree goes through ``load_jax_tree`` into a port
    ResNet-8 quantized the same way: codes bitwise, outputs within
    OUT_RTOL; then ``save``/``load`` round-trips the model bitwise."""
    from bigdl_tpu_torch.nn import AbstractModule
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jqm = _jax_quantized(resnet8, "dynamic")
    tm = _port_resnet8(*resnet8[1:]).quantize("dynamic")
    jp = jax.device_get(jqm.params)
    load_jax_tree(tm, jp, jax.device_get(jqm.state))
    leaves = named_leaves(tm, jp)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.from_numpy(np.array(leaves[name])).dtype
        np.testing.assert_array_equal(p.detach().numpy(), leaves[name],
                                      err_msg=name)
    x = _np(13, 4, 3, 32, 32)
    want = np.asarray(jqm.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert _rel(got, want) <= OUT_RTOL
    path = str(tmp_path / "q.model")
    tm.save(path)
    back = AbstractModule.load(path, device="cpu")
    for (k, a), (k2, b) in zip(tm.state_dict().items(),
                               back.state_dict().items()):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    assert type(back[len(back) - 2]).__name__ == "QuantizedLinear"
    with torch.no_grad():
        assert torch.equal(back(torch.from_numpy(x)), got)


def test_evaluation_of_quantized_graph_and_sequential(resnet8):
    """Evaluator, Validator, ``evaluate(dataset, methods)``, ``predict``
    and ``predict_class`` run on a quantized Graph (ResNet-8) and
    Sequential (LeNet-5), and score what the forward computes on the
    batches each of them forms (4, 4, 3, 4 and 3 rows): the CPU's f32
    products are not batch-invariant, and the weight-only path rounds
    every activation to bf16 (``ops/w8a16.py``), so one f32 ulp of a
    batch-10 forward can become a bf16 ulp, which batching does not
    promise to match. The LeNet's weights come from a seeded generator."""
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy, Validator

    rng = np.random.default_rng(21)
    lenet = LeNet5(10, device="cpu",
                   generator=torch.Generator().manual_seed(21))
    cases = [(_port_resnet8(*resnet8[1:]).quantize("dynamic"),
              _np(22, 10, 3, 32, 32)),
             (lenet.quantize("weight_only"),
              rng.random((10, 28 * 28)).astype(np.float32))]
    labels = (np.arange(10) % 10 + 1).astype(np.float32)
    for model, x in cases:
        def forward_in_batches(size, model=model, x=x):
            # a batch-1 tail comes out of LeNet's Reshape without its
            # batch dim; the Predictor puts it back, and so does this
            with torch.no_grad():
                return np.concatenate([
                    model(torch.from_numpy(x[i:i + size])).numpy().reshape(
                        len(x[i:i + size]), -1)
                    for i in range(0, len(x), size)])

        def top1(out):
            return float((out.argmax(-1) + 1 == labels).mean())

        out4, out3 = forward_in_batches(4), forward_in_batches(3)
        samples = [Sample(x[i], labels[i]) for i in range(10)]
        for scorer in (Evaluator, Validator):
            (res,) = scorer(model).test(samples, [Top1Accuracy()], 4)
            assert res.result() == (pytest.approx(top1(out4)), 10)
        (res,) = model.evaluate(samples, [Top1Accuracy()], 3)
        assert res.result()[0] == pytest.approx(top1(out3))
        np.testing.assert_allclose(model.predict(x, batch_size=4), out4,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(model.predict_class(x, batch_size=3),
                                      out3.argmax(-1) + 1)
