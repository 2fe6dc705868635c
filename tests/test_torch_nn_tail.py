"""The port's remaining layers held against the JAX package's on the
CPU: the activations (``bigdl_tpu_torch/nn/activations.py``), the misc
ops and ``LookupTable``'s restored arguments (``nn/misc.py``), the shape
and table ops (``nn/shape_ops.py``), ``ParallelTable``/``MapTable``/
``Bottle`` (``nn/containers.py``), ``SpatialFullConvolution``
(``nn/conv.py``), ``Normalize`` (``nn/normalization.py``),
``BilinearFiller`` (``nn/init_methods.py``) and ``Echo``
(``nn/module.py``); the twin of ``tests/test_layers.py:209`` and
``:255``.

Each case draws its input and a cotangent with numpy from a seed, builds
the JAX layer, takes its params (JAX's own init), loads them into the
port's layer (``load_jax_tree``) and compares the output, the input
gradient and every parameter gradient (the vector-Jacobian product of
the cotangent). Tolerance: f32 rounding, rtol 1e-5 / atol 1e-6 (1e-4 for
the transposed convolutions, as JAX's own test against torch). The JAX
side runs once for every case, in one module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401


def _x(*shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _cases():
    """name → (JAX layer, port layer, input (array or list), tol)."""
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    x2, x4 = _x(4, 6), _x(2, 3, 5, 4, seed=1)
    pos = _x(4, 6, seed=2, lo=0.1, hi=3.0)
    pair = [_x(4, 5, seed=3), _x(4, 5, seed=4)]
    pos_pair = [pair[0], _x(4, 5, seed=5, lo=0.5, hi=2.0)]
    trio = pair + [_x(4, 5, seed=6)]
    c = {
        # activations
        "ReLU6": (J.ReLU6(), T.ReLU6(), 4 * x2),
        "Sigmoid": (J.Sigmoid(), T.Sigmoid(), x2),
        "SoftMax_2d": (J.SoftMax(), T.SoftMax(), x2),
        "SoftMax_4d": (J.SoftMax(), T.SoftMax(), x4),
        "PReLU_shared": (J.PReLU(), T.PReLU(), x2),
        "PReLU_channels": (J.PReLU(3), T.PReLU(3), x4),
        "ELU": (J.ELU(0.7), T.ELU(0.7), x2),
        "LeakyReLU": (J.LeakyReLU(0.1), T.LeakyReLU(0.1), x2),
        "HardTanh": (J.HardTanh(-0.5, 0.8), T.HardTanh(-0.5, 0.8), x2),
        "SoftPlus": (J.SoftPlus(2.0), T.SoftPlus(2.0), x2),
        "SoftSign": (J.SoftSign(), T.SoftSign(), x2),
        "GELU": (J.GELU(), T.GELU(), x2),
        # misc
        "MulConstant": (J.MulConstant(2.5), T.MulConstant(2.5), x2),
        "AddConstant": (J.AddConstant(-1.5), T.AddConstant(-1.5), x2),
        "Power": (J.Power(3.0, 0.5, 1.0), T.Power(3.0, 0.5, 1.0), x2),
        "Square": (J.Square(), T.Square(), x2),
        "Sqrt": (J.Sqrt(), T.Sqrt(), pos),
        "Abs": (J.Abs(), T.Abs(), x2),
        "Log": (J.Log(), T.Log(), pos),
        "Exp": (J.Exp(), T.Exp(), x2),
        "Clamp": (J.Clamp(-0.3, 0.6), T.Clamp(-0.3, 0.6), x2),
        "Mean": (J.Mean(2), T.Mean(2), x4),
        "Sum_batched": (J.Sum(1, n_input_dims=2), T.Sum(1, n_input_dims=2),
                        _x(3, 4, 5, seed=7)),
        "Max_keepdim": (J.Max(2, squeeze=False), T.Max(2, squeeze=False), x4),
        "Min": (J.Min(-1), T.Min(-1), x4),
        "MM": (J.MM(trans_b=True), T.MM(trans_b=True),
               [_x(2, 3, 4, seed=8), _x(2, 5, 4, seed=9)]),
        "MV": (J.MV(trans=True), T.MV(trans=True),
               [_x(2, 4, 3, seed=10), _x(2, 4, seed=11)]),
        "Mul": (J.Mul(), T.Mul(), x2),
        "Add": (J.Add(6), T.Add(6), x2),
        "CMul": (J.CMul((1, 6)), T.CMul((1, 6)), x2),
        "CAdd": (J.CAdd((1, 6)), T.CAdd((1, 6)), x2),
        "LookupTable": (
            J.LookupTable(9, 4, padding_value=3, max_norm=1.5),
            T.LookupTable(9, 4, padding_value=3, max_norm=1.5),
            np.float32([[1, 3, 9], [0, 2, 3]])),
        # shape and table ops
        "View": (J.View(3, 2), T.View(3, 2), x2),
        "Narrow": (J.Narrow(2, 2, 3), T.Narrow(2, 2, 3), x2),
        "Narrow_negative": (J.Narrow(-1, -3, -2), T.Narrow(-1, -3, -2), x4),
        "Squeeze": (J.Squeeze(2), T.Squeeze(2), _x(4, 1, 5, seed=12)),
        "Squeeze_all": (J.Squeeze(), T.Squeeze(), _x(4, 1, 5, 1, seed=13)),
        "Unsqueeze_batched": (J.Unsqueeze(1, 2), T.Unsqueeze(1, 2),
                              _x(3, 4, 5, seed=14)),
        "Transpose": (J.Transpose([(1, 2), (2, 4)]),
                      T.Transpose([(1, 2), (2, 4)]), x4),
        "Contiguous": (J.Contiguous(), T.Contiguous(), x2),
        "Padding_before": (J.Padding(2, -2, 2, 0.5), T.Padding(2, -2, 2, 0.5),
                           _x(3, 4, 5, seed=15)),
        "Padding_after": (J.Padding(1, 3, 2, -1.0), T.Padding(1, 3, 2, -1.0),
                          _x(3, 4, 5, seed=16)),
        "CMulTable": (J.CMulTable(), T.CMulTable(), trio),
        "CSubTable": (J.CSubTable(), T.CSubTable(), pair),
        "CDivTable": (J.CDivTable(), T.CDivTable(), pos_pair),
        "CMaxTable": (J.CMaxTable(), T.CMaxTable(), trio),
        "CMinTable": (J.CMinTable(), T.CMinTable(), trio),
        "CAveTable": (J.CAveTable(), T.CAveTable(), trio),
        "JoinTable_batched": (J.JoinTable(1, 1), T.JoinTable(1, 1), pair),
        "SplitTable": (J.SplitTable(2), T.SplitTable(2), x4),
        # containers
        "ParallelTable": (
            J.ParallelTable().add(J.Linear(5, 3)).add(J.Tanh()),
            T.ParallelTable().add(T.Linear(5, 3)).add(T.Tanh()), pair),
        "MapTable": (J.MapTable(J.Linear(5, 2)), T.MapTable(T.Linear(5, 2)),
                     trio),
        "Bottle": (J.Bottle(J.Linear(4, 3)), T.Bottle(T.Linear(4, 3)),
                   _x(2, 3, 5, 4, seed=17)),
        # normalization
        "Normalize": (J.Normalize(), T.Normalize(), x2),
        "Normalize_p3": (J.Normalize(3.0), T.Normalize(3.0), x4),
    }
    out = {k: (j, t, x, 1e-5) for k, (j, t, x) in c.items()}
    for g, s, p, adj in [(1, 1, 0, 0), (1, 2, 1, 1), (2, 2, 1, 0)]:
        out[f"SpatialFullConvolution_g{g}s{s}p{p}a{adj}"] = (
            J.SpatialFullConvolution(4, 6, 3, 3, s, s, p, p, adj_w=adj,
                                     adj_h=adj, n_group=g),
            T.SpatialFullConvolution(4, 6, 3, 3, s, s, p, p, adj_w=adj,
                                     adj_h=adj, n_group=g, device="cpu"),
            _x(2, 4, 5, 5, seed=18), 1e-4)
    out["SpatialFullConvolution_no_bias_3d"] = (
        J.SpatialFullConvolution(3, 2, 2, 3, 2, 1, 0, 1, no_bias=True),
        T.SpatialFullConvolution(3, 2, 2, 3, 2, 1, 0, 1, no_bias=True,
                                 device="cpu"),
        _x(3, 4, 6, seed=19), 1e-4)
    return out


CASES = sorted(_cases())


def _vjp_inputs(x):
    return [jnp.asarray(v) for v in x] if isinstance(x, list) \
        else jnp.asarray(x)


@pytest.fixture(scope="module")
def jax_refs():
    """name → (params, output, cotangent, input grad, param grads); the
    cotangent is drawn with numpy (seed 99) in the output's shape."""
    out = {}
    for name, (jl, _, x, _) in _cases().items():
        params = jax.device_get(jl.init_params(jax.random.PRNGKey(3)))
        integer = name == "LookupTable"
        xin = _vjp_inputs(x)

        def f(p, xv):
            return jl.apply(p, xv, {}, training=True)[0]

        y, pull = jax.vjp(lambda p: f(p, xin), params) if integer else \
            jax.vjp(f, params, xin)
        rng = np.random.default_rng(99)
        ct = (jax.tree_util.tree_map(
            lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), y))
        grads = pull(ct)
        gp = grads[0]
        gx = None if integer else grads[1]
        out[name] = (params, jax.device_get(y), jax.device_get(ct),
                     jax.device_get(gx), jax.device_get(gp))
    return out


def _flat(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", CASES)
def test_layer_matches_jax(jax_refs, name):
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves

    _, layer, x, tol = _cases()[name]
    params, want, ct, gx_want, gp_want = jax_refs[name]
    if params:
        load_jax_tree(layer, params)
    integer = name == "LookupTable"
    xs = [torch.from_numpy(v) for v in (x if isinstance(x, list) else [x])]
    if not integer:
        xs = [v.requires_grad_() for v in xs]
    leaves = dict(layer.named_parameters())
    out = layer(xs if isinstance(x, list) else xs[0])
    outs = out if isinstance(out, list) else [out]
    cts = ct if isinstance(ct, list) else [ct]
    wants = want if isinstance(want, list) else [want]
    assert len(outs) == len(wants)
    for o, w in zip(outs, wants):
        np.testing.assert_allclose(o.detach().numpy(), w, rtol=tol,
                                   atol=tol / 10, err_msg=name)
    wrt = list(leaves.values()) + ([] if integer else xs)
    grads = torch.autograd.grad(outs, wrt, [torch.from_numpy(np.asarray(c))
                                            for c in cts])
    if params:
        by_name = named_leaves(layer, gp_want)
        for (k, _), g in zip(leaves.items(), grads):
            np.testing.assert_allclose(g.numpy(), by_name[k], rtol=tol,
                                       atol=tol / 10, err_msg=f"{name}.{k}")
    if not integer:
        gxs = grads[len(leaves):]
        for g, w in zip(gxs, _flat(gx_want)):
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol / 10,
                                       err_msg=f"{name} input grad")


def test_bilinear_filler_matches_jax():
    from bigdl_tpu.nn.init_methods import BilinearFiller as JBF
    from bigdl_tpu_torch.nn import BilinearFiller

    for shape in [(3, 2, 4, 4), (2, 1, 3, 5)]:
        want = np.asarray(JBF().init(jax.random.PRNGKey(0), shape))
        got = BilinearFiller().fill(torch.empty(shape))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="4D"):
        BilinearFiller().fill(torch.empty(3, 3))


def test_echo_prints_as_jax(capsys):
    from bigdl_tpu.nn import Echo as JEcho
    from bigdl_tpu_torch.nn import Echo

    x = _x(2, 3)
    je, te = JEcho().set_name("probe"), Echo().set_name("probe")
    je.apply({}, jnp.asarray(x))
    want = capsys.readouterr().out
    got = te(torch.from_numpy(x))
    assert capsys.readouterr().out == want == "[Echo probe] shape=(2, 3)\n"
    assert torch.equal(got, torch.from_numpy(x))


def test_lookup_table_keeps_jax_defaults_and_init():
    """The restored arguments default as JAX's, and ``init_weight``
    fills the table (``ConstInitMethod`` here)."""
    from bigdl_tpu_torch.nn import ConstInitMethod, LookupTable

    t = LookupTable(5, 3, device="cpu")
    assert (t.padding_value, t.max_norm, t.norm_type) == (0, float("inf"),
                                                          2.0)
    c = LookupTable(5, 3, init_weight=ConstInitMethod(0.25), device="cpu")
    assert torch.equal(c.weight, torch.full((5, 3), 0.25))
