"""The weight-only int8 projection's launch arithmetic
(bigdl_tpu_torch/ops/w8a16.py) against the JAX package on the CPU:

* ``w8a16_split_reference``, the kernel's split-K sum in plain PyTorch
  (one f32 partial per split of K, summed in split order, as the cluster
  sums them), against JAX's weight-only ``_serving_proj``
  (bigdl_tpu/models/transformer.py:674-681, f32 and bf16 activations) and
  ``QuantizedLinear`` (bigdl_tpu/nn/quantized.py:83-92, with and without
  its bias) at 1, 2, 3 and 8 splits, splits wholly past K included;
* ``launch_plan``'s invariants over a grid of (M, N, K, SM count): the
  regime changes where its docstring says (M 16, and the prefill's
  dtype and alignment conditions); every K depth and every output column
  and row is covered exactly once; a cluster holds 1 to 8 blocks and no
  split is empty; the ring fits its budget;
* the kernels' K permutation: within a 64-deep stage the slots a thread
  fills cover each position once, for x and the weights alike.

The kernels themselves are held to the plain version on the card in
tests/test_torch_cuda.py.

Tolerances: 1e-5 of the output's largest magnitude at f32 (f32 sums in
another order; every bf16 product is exact in f32) and 2^-6 of it at bf16
(the cast and the bias add may each round one bf16 ulp apart, at most
2^-7 of a value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import w8a16 as w8
from tests.torch_parity import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6
#: K of 200: 64-deep stages leave a ragged last one, and 8 splits of 64
#: leave splits 4-7 wholly past K (3 splits of 128: the last one too)
K, N = 200, 48
SPLITS = [1, 2, 3, 8]


def _inputs(seed, lead=(5,)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(N, K)).astype(np.int8)
    scale = (rng.random((N, 1)) * 2e-2 + 1e-3).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    return x, wq, scale, bias


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_split_reference_matches_jax_serving_proj(splits, dtype):
    from bigdl_tpu.models.transformer import _serving_proj as jproj

    x, wq, scale, bias = _inputs(splits, lead=(2, 3))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jparams = {"weight_q": jnp.asarray(wq), "w_scale": jnp.asarray(scale),
               "bias": jnp.asarray(bias).astype(jdt)}
    want = np.asarray(jproj(jparams, jnp.asarray(x).astype(jdt))
                      .astype(jnp.float32))
    k_split = -(-K // (splits * 64)) * 64
    if splits == 8:
        assert 4 * k_split >= K          # splits 4-7 add nothing
    got = w8.w8a16_split_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wq),
        torch.from_numpy(scale), torch.from_numpy(bias).to(tdt), tdt,
        splits=splits, k_split=k_split)
    assert got.dtype == tdt and got.shape == (2, 3, N)
    tol = (F32_TOL if dtype == "fp32" else BF16_TOL) * float(
        np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) <= tol
    # the split sum is the plain version's function
    plain = w8.w8a16_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(wq),
                           torch.from_numpy(scale),
                           torch.from_numpy(bias).to(tdt), tdt)
    assert float((got.float() - plain.float()).abs().max()) <= tol


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("bias", [True, False])
def test_split_reference_matches_jax_quantized_linear(splits, bias):
    from bigdl_tpu.nn import Linear as JLinear
    from bigdl_tpu.nn import quantized as jq

    x, _, _, _ = _inputs(10 + splits)
    rng = np.random.default_rng(20 + splits)
    jl = JLinear(K, N, with_bias=bias)
    jl.params = {"weight": jnp.asarray(
        rng.standard_normal((N, K)).astype(np.float32) * 0.2)}
    if bias:
        jl.params["bias"] = jnp.asarray(
            rng.standard_normal(N).astype(np.float32))
    jm = jq.QuantizedLinear.from_linear(jl, "weight_only")
    want = np.asarray(jm.forward(jnp.asarray(x)))
    p = jax.device_get(jm.params)
    got = w8.w8a16_split_reference(
        torch.from_numpy(x), torch.from_numpy(np.array(p["weight_q"])),
        torch.from_numpy(np.array(p["w_scale"])),
        torch.from_numpy(np.array(p["bias"])) if bias else None,
        torch.float32, splits=splits)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= \
        F32_TOL * float(np.abs(want).max())


def test_split_reference_refuses_splits_short_of_k():
    x, wq, scale, _ = (torch.from_numpy(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="do not cover"):
        w8.w8a16_split_reference(x, wq, scale, splits=3, k_split=64)


# --------------------------------------------------------------- launch_plan

GRID_M = [1, 2, 8, 16, 17, 64, 256, 2048]
GRID_NK = [(3072, 768), (768, 3072), (32768, 768), (1000, 2048), (91, 203),
           (7, 16), (5000, 64), (130, 4096)]
GRID_SMS = [1, 8, 132]


def _covers_once(length, tile, count):
    """The ``count`` tiles of ``tile`` cover [0, length) once, none past."""
    seen = np.zeros(length, np.int64)
    for i in range(count):
        seen[i * tile:min(length, (i + 1) * tile)] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("sms", GRID_SMS)
@pytest.mark.parametrize("n,k", GRID_NK)
def test_launch_plan_invariants(n, k, sms):
    for m in GRID_M:
        for x_bf16 in (True, False):
            for tma in (True, False):
                for out_bf16 in (True, False):
                    plan = w8.launch_plan(m, n, k, sms, x_bf16, tma,
                                          out_bf16)
                    ctx = (m, n, k, sms, x_bf16, tma, out_bf16, plan)
                    if m <= w8.DECODE_ROWS:
                        want = "decode"
                    elif x_bf16 and tma:
                        want = "prefill"
                    else:
                        want = "rows"
                    assert plan.regime == want, ctx
                    assert 1 <= plan.splits <= w8.MAX_SPLITS, ctx
                    assert plan.k_split % plan.stage_k == 0, ctx
                    # every depth once: the splits cover K, none is empty
                    assert _covers_once(k, plan.k_split, plan.splits), ctx
                    assert (plan.splits - 1) * plan.k_split < k, ctx
                    # every output column and row once
                    assert _covers_once(n, plan.bn, -(-n // plan.bn)), ctx
                    assert _covers_once(m, plan.bm, -(-m // plan.bm)), ctx
                    per = plan.k_split // plan.stage_k
                    assert 1 <= plan.ring <= per, ctx
                    if want == "decode":
                        assert plan.bm == 16 and plan.bn in (32, 64, 128)
                        assert plan.stage_k == w8.DECODE_STAGE_K, ctx
                        assert plan.ring <= w8.DECODE_RING, ctx
                    elif want == "rows":
                        assert (plan.bm, plan.bn, plan.stage_k) == \
                            (64, 64, 64), ctx
                        stage = w8._stage_bytes(64, 64, 64,
                                                2 if x_bf16 else 4)
                        assert plan.ring == 1 or \
                            plan.ring * stage <= w8.RING_BYTES, ctx
                    else:
                        assert plan.splits == 1 and plan.bm == 128, ctx
                        assert plan.bn in ((128, 256) if out_bf16
                                           else (128,)), ctx


def test_launch_plan_decode_shapes_of_the_137m_lm():
    """The 16-slot engine's projections on an H100's 132 SMs: fc1 fills
    the card with 32-column tiles, fc2 splits K over a cluster of 4, the
    head takes 64-column tiles, M 1 plans as M 16."""
    plans = {name: w8.launch_plan(16, n, k, 132)
             for name, n, k in (("fc1", 3072, 768), ("fc2", 768, 3072),
                                ("head", 32768, 768))}
    assert (plans["fc1"].bn, plans["fc1"].splits) == (32, 1)
    assert (plans["fc2"].bn, plans["fc2"].splits) == (32, 4)
    assert (plans["head"].bn, plans["head"].splits) == (64, 1)
    for name, n, k in (("fc1", 3072, 768), ("fc2", 768, 3072),
                       ("head", 32768, 768)):
        assert w8.launch_plan(1, n, k, 132) == plans[name]


def test_stage_permutation_covers_each_position_once():
    """Thread (g, t4)'s k16 step s fills mma slots {2 t4, 2 t4 + 1} and
    {2 t4 + 8, 2 t4 + 9} with the stage's positions 16 t4 + 4 s + {0, 1}
    and + {2, 3} (csrc/w8a16.cu, x_frag and the weight words): over the
    four steps and four t4 every one of the 64 positions is summed once,
    and each step's 16 slots hold 16 distinct positions."""
    seen = np.zeros(64, np.int64)
    for s in range(4):
        slots = {}
        for t4 in range(4):
            for j, slot in enumerate((2 * t4, 2 * t4 + 1, 2 * t4 + 8,
                                      2 * t4 + 9)):
                slots[slot] = 16 * t4 + 4 * s + j
        assert sorted(slots) == list(range(16))
        for pos in slots.values():
            seen[pos] += 1
    assert (seen == 1).all()
