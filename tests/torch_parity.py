"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
JAX TransformerLM and its port twin holding the same weights, carried
across with ``load_jax_params``, numpy conversions, the top-2 gap
check that decides which greedy streams may be compared token for
token, ``numpy_trees`` (a JAX model's trees drawn without its init), and
``one_torch_thread``, a fixture a test module takes up by importing it. No test functions; imported by the test files."""

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
