"""The port's pooled decode attention (bigdl_tpu_torch/ops/decode_attention.py)
against the JAX package's: the plain PyTorch version vs the JAX reference
and vs the Pallas kernel run in interpret mode on the CPU, for int8 K/V
with per-(row, head) scales, bf16 and fp32 K/V, rows at pos 0 and L-1,
and cache lengths that are not a multiple of 128. Inputs are made with
numpy from a seed and handed to both frameworks.

Tolerances: 2e-5 absolute where the math is f32 end to end (fp32 and
int8 K/V — the bound tests/test_decode_attention.py pins between the JAX
reference and kernel); 2e-2 for bf16 K/V, where p is rounded to bf16
before the p.v contraction (normalized in the references, unnormalized
in the kernel), a relative error of up to 2**-8 per probability.

The CUDA kernel itself needs the card: tests/test_torch_cuda.py holds it
to the plain version there (and so does chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.decode_attention import (
    decode_attention_reference as jax_reference,
    pooled_decode_attention as jax_kernel,
)
from bigdl_tpu_torch.ops import decode_attention as tda

TOL = {"fp32": 2e-5, "int8": 2e-5, "bf16": 2e-2}


def _inputs(kind, n=4, L=48, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, h, d)).astype(np.float32)
    pos = rng.integers(0, L, size=(n,)).astype(np.int32)
    pos[0], pos[-1] = 0, L - 1
    if kind == "int8":
        k = rng.integers(-127, 128, size=(n, L, h, d)).astype(np.int8)
        v = rng.integers(-127, 128, size=(n, L, h, d)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, size=(n, h)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, size=(n, h)).astype(np.float32)
        return q, k, v, pos, ks, vs
    k = rng.standard_normal((n, L, h, d)).astype(np.float32)
    v = rng.standard_normal((n, L, h, d)).astype(np.float32)
    return q, k, v, pos, None, None


def _jax(kind, q, k, v, pos, ks, vs):
    kv_dt = jnp.bfloat16 if kind == "bf16" else None
    cast = (lambda a: jnp.asarray(a, kv_dt)) if kv_dt else jnp.asarray
    return (jnp.asarray(q), cast(k), cast(v), jnp.asarray(pos),
            None if ks is None else jnp.asarray(ks),
            None if vs is None else jnp.asarray(vs))


def _torch(kind, q, k, v, pos, ks, vs, device="cpu"):
    def t(a):
        x = torch.from_numpy(a).to(device)
        return x.to(torch.bfloat16) if kind == "bf16" else x
    return (torch.from_numpy(q).to(device), t(k), t(v),
            torch.from_numpy(pos).to(device),
            None if ks is None else torch.from_numpy(ks).to(device),
            None if vs is None else torch.from_numpy(vs).to(device))


@pytest.mark.parametrize("L", [48, 130])
@pytest.mark.parametrize("kind", ["int8", "bf16", "fp32"])
def test_plain_version_matches_jax_reference(kind, L):
    args = _inputs(kind, L=L)
    ks, vs = args[4], args[5]
    jq, jk, jv, jp, jks, jvs = _jax(kind, *args)
    want = np.asarray(jax_reference(jq, jk, jv, jp, k_scale=jks,
                                    v_scale=jvs, out_dtype=jnp.float32))
    tq, tk, tv, tp, tks, tvs = _torch(kind, *args)
    got = tda.decode_attention_reference(tq, tk, tv, tp, k_scale=tks,
                                         v_scale=tvs,
                                         out_dtype=torch.float32)
    assert (ks is None) == (kind != "int8") and (vs is None) == (ks is None)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[kind], rtol=0)


@pytest.mark.parametrize("L", [48, 130])
@pytest.mark.parametrize("kind", ["int8", "bf16", "fp32"])
def test_plain_version_matches_jax_interpret_kernel(kind, L):
    args = _inputs(kind, L=L, seed=1)
    jq, jk, jv, jp, jks, jvs = _jax(kind, *args)
    want = np.asarray(jax_kernel(jq, jk, jv, jp, k_scale=jks, v_scale=jvs,
                                 interpret=True, out_dtype=jnp.float32))
    tq, tk, tv, tp, tks, tvs = _torch(kind, *args)
    got = tda.decode_attention_reference(tq, tk, tv, tp, k_scale=tks,
                                         v_scale=tvs,
                                         out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[kind], rtol=0)


def test_cpu_dispatch_takes_the_plain_version():
    """On CPU tensors the dispatcher is the plain version, bit for bit,
    and launches nothing."""
    tq, tk, tv, tp, tks, tvs = _torch("int8", *_inputs("int8"))
    before = tda.launches
    got = tda.decode_attention(tq, tk, tv, tp, k_scale=tks, v_scale=tvs)
    want = tda.decode_attention_reference(tq, tk, tv, tp, k_scale=tks,
                                          v_scale=tvs)
    assert torch.equal(got, want) and got.dtype == tq.dtype
    assert tda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel runs on the card only: a CPU tensor raises instead of
    silently taking another path."""
    tq, tk, tv, tp, tks, tvs = _torch("int8", *_inputs("int8"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tda.pooled_decode_attention(tq, tk, tv, tp, k_scale=tks,
                                    v_scale=tvs)


def test_validation():
    tq, tk, tv, tp, tks, tvs = _torch("int8", *_inputs("int8"))
    with pytest.raises(ValueError, match="BOTH"):
        tda.decode_attention_reference(tq, tk, tv, tp, k_scale=tks)
    with pytest.raises(ValueError, match="int8"):
        tda.decode_attention_reference(tq, tk.float(), tv.float(), tp,
                                       k_scale=tks, v_scale=tvs)
    with pytest.raises(ValueError, match="do not match"):
        tda.decode_attention_reference(tq, tk[:, :, :2], tv[:, :, :2], tp)
    with pytest.raises(ValueError, match="pos"):
        tda.decode_attention_reference(tq, tk, tv, tp[:2], k_scale=tks,
                                       v_scale=tvs)
