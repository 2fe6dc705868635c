"""The port's flash attention (``bigdl_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas kernels, run in interpret mode on the
CPU as tests/test_flash_attention.py runs them. On the CPU the port takes
its plain version, so these pin the plain version's numerics — the
contract the CUDA kernels are held to on the card
(tests/test_torch_cuda.py).

Inputs are numpy-seeded f32. Tolerance 2e-5 absolute for outputs and
LSE, 1e-4 for gradients (f32 both sides; the JAX kernels sum block by
block with an online softmax, the plain version in one pass, and the
gradient sums run over up to 200 keys of values up to ~10 in magnitude).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import flash_attention as tfa

# the module (bigdl_tpu.ops re-exports a function of the same name)
jfa = importlib.import_module("bigdl_tpu.ops.flash_attention")

ATOL = 2e-5
GRAD_ATOL = 1e-4


def _arrays(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for t in (tq, tk, tk, tq)]                   # q, k, v, dO


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# (B, Tq, Tk, H, D, causal, causal_offset). The strict-causal case uses a
# T that is a multiple of the JAX kernel's block (128), where its fully
# masked row 0 averages exactly the real keys (module docstring).
CASES = [
    (2, 100, 100, 3, 16, True, None),
    (2, 100, 100, 3, 16, False, None),
    (1, 70, 130, 2, 8, False, None),          # Tq != Tk, ragged
    (1, 130, 70, 2, 8, True, None),           # Tq > Tk, causal
    (1, 128, 128, 2, 16, True, -1),           # strict causal
]


@pytest.mark.parametrize("case", CASES)
def test_forward_and_lse_match_jax_interpret(case):
    b, tq, tk, h, d, causal, off = case
    q, k, v, _ = _arrays(b, tq, tk, h, d, seed=tq + tk)
    jo, jlse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        causal_offset=off, interpret=True)
    to, tlse = tfa.flash_attention_with_lse(*_t(q, k, v), causal=causal,
                                            causal_offset=off)
    assert tlse.shape == (b, h, tq) and tlse.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_block_grads_match_jax_interpret(case):
    b, tq, tk, h, d, causal, off = case
    q, k, v, do = _arrays(b, tq, tk, h, d, seed=tq * tk)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal,
                                            causal_offset=off, interpret=True)
    want = jfa.flash_attention_block_grads(jq, jk, jv, jo, jlse, jdo,
                                           causal=causal, causal_offset=off,
                                           interpret=True)
    got = tfa.flash_attention_block_grads(
        *_t(q, k, v, np.asarray(jo), np.asarray(jlse), do), causal=causal,
        causal_offset=off)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(causal):
    q, k, v, w = _arrays(2, 40, 40, 2, 16, seed=7)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal,
                                           interpret=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for t, ww in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ww),
                                   atol=GRAD_ATOL, rtol=0)


def test_bf16_plain_version_rounds_like_the_kernels():
    """bf16 in: the plain forward agrees with JAX's interpret kernel on
    the same bf16 inputs within 2e-2 (p rounded to bf16 relative to the
    running max there, to the final max here, plus bf16 outputs)."""
    q, k, v, _ = _arrays(1, 96, 96, 2, 16, seed=3)
    jo, _ = jfa.flash_attention_with_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        interpret=True)
    to, _ = tfa.flash_attention_with_lse(
        *(t.to(torch.bfloat16) for t in _t(q, k, v)), causal=True)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_causal_offset_without_causal_raises():
    q, k, v, _ = _t(*_arrays(1, 8, 8, 1, 8, seed=0))
    with pytest.raises(ValueError, match="causal_offset requires"):
        tfa.flash_attention_with_lse(q, k, v, causal_offset=-1)


def test_cpu_tensors_never_reach_the_kernel_wrappers():
    q, k, v, _ = _t(*_arrays(1, 8, 8, 1, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_fwd_cuda(q, k, v, 0.3)
    counts = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    tfa.flash_attention(q, k, v, causal=True)
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == counts


def test_row_rule_passes_an_online_softmax_and_fails_a_late_row_fault():
    """The per-row rule the CUDA kernels are held to
    (``max_row_rel_err`` <= ``ROW_RTOL``): JAX's bf16 interpret kernel,
    whose online softmax rounds p relative to the running max as the CUDA
    kernels do, passes it against the plain version at T=512; a planted
    fault confined to the late rows (keys from 256 on read a stale V
    tile, as a kernel that skipped a tile load would) fails it many times
    over."""
    q, k, v, _ = _arrays(1, 512, 512, 2, 64, seed=11)
    bf = [t.to(torch.bfloat16) for t in _t(q, k, v)]
    jo, _ = jfa.flash_attention_with_lse(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        interpret=True)
    to, _ = tfa.flash_attention_with_lse(*bf, causal=True)
    rtol = tfa.ROW_RTOL[torch.bfloat16]
    jo_t = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    assert tfa.max_row_rel_err(jo_t, to) <= rtol
    stale = bf[2].clone()
    stale[:, 256:] = bf[2][:, 192:256].repeat(1, 4, 1, 1)
    bad, _ = tfa.flash_attention_with_lse(bf[0], bf[1], stale, causal=True)
    assert tfa.max_row_rel_err(bad[:, :256], to[:, :256]) == 0.0
    assert tfa.max_row_rel_err(bad, to) > 10 * rtol


def test_delta_matches_the_jax_wrapper(monkeypatch):
    """``_delta`` (``sum_d dO * O``, which the dq kernel computes on the
    card) against the delta the JAX wrapper computes before its kernels
    (``bigdl_tpu/ops/flash_attention.py:355-356``), taken from the operands
    it hands the dq kernel's ``pallas_call``: f32, 1e-6 absolute (sums of
    16 products of values up to ~5, in another order)."""
    b, t, h, d = 2, 100, 3, 16
    q, k, v, do = _arrays(b, t, t, h, d, seed=5)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa.flash_attention_with_lse(jq, jk, jv, causal=True,
                                            interpret=True)
    seen = []
    real = jfa.pl.pallas_call

    def spy(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*operands):
            seen.append(operands)
            return call(*operands)
        return run

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    jfa.flash_attention_block_grads(jq, jk, jv, jo, jlse, jdo, causal=True,
                                    interpret=True)
    # the dq call's operands: q, k, v, dO, lse, delta (BH, T padded, 1), off
    want = np.asarray(seen[0][5])[:, :t, 0].reshape(b, h, t)
    got = tfa._delta(*_t(np.asarray(jo), do))
    assert got.shape == (b, h, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
