"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
JAX TransformerLM and its port twin holding the same weights, carried
across with ``load_jax_params``, plus numpy conversions. A plain module
(no fixtures, no test functions), imported by the test files."""

import jax
import numpy as np
import torch


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
