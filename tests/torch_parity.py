"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
JAX TransformerLM and its port twin holding the same weights, carried
across with ``load_jax_params``, numpy conversions, the top-2 gap
check that decides which greedy streams may be compared token for
token, ``numpy_trees`` (a JAX model's trees drawn without its init),
``one_torch_thread``, a fixture a test module takes up by importing it,
and the layer harness ``layer_vjp_refs`` / ``check_layer`` (a JAX
layer's vector-Jacobian product held against the port layer's). No test
functions; imported by the test files."""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the importing module's tests on one torch intra-op thread,
    restored after the module. The suite runs several pytest workers on
    the box's cores at once; with a thread per core in every worker,
    torch's small CPU ops spend their time in contention (one module
    measured about ten times slower beside a second busy worker than
    alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def make_pair(V=29, hidden=32, heads=4, layers=2, max_len=48, seed=9,
              **lm_kw):
    """(JAX model, port model) with identical f32 weights, both in
    evaluate mode; the port model lives on the CPU. ``lm_kw`` (e.g.
    ``output=``, ``use_flash=``) goes to both constructors."""
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.transformer import (
        TransformerLM, load_jax_params,
    )

    RNG.set_seed(seed)
    jlm = JaxLM(V, hidden_size=hidden, n_heads=heads, n_layers=layers,
                max_len=max_len, **lm_kw)
    jlm._ensure_params()
    jlm.evaluate()
    tlm = TransformerLM(V, hidden_size=hidden, n_heads=heads,
                        n_layers=layers, max_len=max_len, device="cpu",
                        seed=seed, **lm_kw)
    load_jax_params(tlm, jax.device_get(jlm.params))
    tlm.evaluate()
    return jlm, tlm


def np_tree(tree):
    """A dict of JAX or torch arrays as a dict of numpy arrays."""
    out = {}
    for k, v in tree.items():
        out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def top2_gaps(jlm, prompt, output):
    """Top-1 minus top-2 log-prob of the JAX model at every generated
    position of ``output`` (1-based ids), teacher-forced; negative where
    the chosen token is not the argmax."""
    import jax.numpy as jnp

    seq = np.asarray(prompt + list(output[:-1]), np.float32)[None]
    lp = np.asarray(jlm.forward(jnp.asarray(seq)))[0]
    gaps = []
    for i, tok in enumerate(output):
        row = lp[len(prompt) - 1 + i]
        others = np.delete(row, tok - 1)
        gaps.append(row[tok - 1] - others.max())
    return np.asarray(gaps)


def numpy_trees(jm, seed):
    """(params, state) trees for the JAX model ``jm`` drawn with numpy,
    without running its init (``jax.eval_shape`` gives the shapes; JAX's
    own init of a large model costs tens of seconds on the CPU): weights
    Xavier-uniform, 1-D ``weight`` leaves (BN scales) in [0.8, 1.2],
    other 1-D leaves (biases, BN shifts) in [-0.1, 0.1]; running means in
    [-0.1, 0.1] and running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if len(shape) >= 2:
            receptive = int(np.prod(shape[2:]))
            bound = np.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
            a = rng.uniform(-bound, bound, shape)
        elif name == "weight":
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.uniform(-0.1, 0.1, shape)
        return a.astype(np.float32)

    def state_leaf(path, leaf):
        lo, hi = ((0.5, 1.5) if str(path[-1].key) == "running_var"
                  else (-0.1, 0.1))
        return rng.uniform(lo, hi, np.shape(leaf)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    state = jax.tree_util.tree_map_with_path(state_leaf,
                                             jax.device_get(jm.init_state()))
    return params, state


def _flat_tensors(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def max_rel_err(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zeros and got
    is not)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    return diff / scale if scale > 0 else diff


def layer_vjp_refs(cases, seed: int = 11):
    """For each ``name → (JAX layer, port layer, input, tol)``: the JAX
    layer's params (``numpy_trees``), its training-mode output without a
    key (a random layer is then deterministic), a numpy cotangent (seed
    99) and the vector-Jacobian product: ``name → (params, output,
    cotangent, [input grads of the float32 inputs], param grads)``. An
    input that is not float32 (ids, indices, masks) is held fixed."""
    import jax.numpy as jnp

    out = {}
    for name, (jl, _, x, _) in cases.items():
        params, _ = numpy_trees(jl, seed)
        table = isinstance(x, list)
        xs = _flat_tensors(x)
        diff = [i for i, v in enumerate(xs)
                if np.asarray(v).dtype == np.float32]

        def f(p, *dx, xs=xs, diff=diff, table=table, jl=jl):
            full = [jnp.asarray(v) for v in xs]
            for i, v in zip(diff, dx):
                full[i] = v
            return jl.apply(p, full if table else full[0], {},
                            training=True)[0]

        dx = [jnp.asarray(xs[i]) for i in diff]
        rng = np.random.default_rng(99)
        ct = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            jax.eval_shape(f, params, *dx))

        def fwd_bwd(p, ct, *dx, f=f):
            y, pull = jax.vjp(f, p, *dx)
            return y, pull(ct)

        y, grads = jax.device_get(jax.jit(fwd_bwd)(params, ct, *dx))
        out[name] = (params, y, ct, [np.asarray(g) for g in grads[1:]],
                     grads[0])
    return out


def check_layer(name, layer, x, ref, tol: float) -> None:
    """The port's ``layer`` (in training mode, no generator current)
    against ``layer_vjp_refs``'s ``ref``: the output, each float32
    input's gradient and each parameter's gradient, every tensor within
    ``tol`` of the JAX one relative to its largest magnitude."""
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves

    params, want, ct, gx_want, gp_want = ref
    if params:
        load_jax_tree(layer, params)
    layer.train()
    table = isinstance(x, list)
    xs = [torch.from_numpy(np.array(v)) for v in _flat_tensors(x)]
    diff = [v.requires_grad_() for v in xs if v.dtype == torch.float32]
    out = layer(xs if table else xs[0])
    outs, wants = _flat_tensors(out), _flat_tensors(want)
    assert len(outs) == len(wants), name
    for i, (o, w) in enumerate(zip(outs, wants)):
        err = max_rel_err(o.detach().numpy(), w)
        assert err <= tol, f"{name} output {i}: {err} > {tol}"
    leaves = dict(layer.named_parameters())
    wrt = list(leaves.values()) + diff
    if not wrt:
        return
    grads = torch.autograd.grad(
        outs, wrt, [torch.from_numpy(np.array(c)) for c in _flat_tensors(ct)],
        allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(wrt, grads)]
    if params:
        by_name = named_leaves(layer, gp_want)
        for k, g in zip(leaves, grads):
            err = max_rel_err(g.numpy(), by_name[k])
            assert err <= tol, f"{name}.{k} grad: {err} > {tol}"
    for i, (g, w) in enumerate(zip(grads[len(leaves):], gx_want)):
        err = max_rel_err(g.numpy(), w)
        assert err <= tol, f"{name} input {i} grad: {err} > {tol}"
