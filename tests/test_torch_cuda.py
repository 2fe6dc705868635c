"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs on a
machine without them; tests/conftest.py imports jax, so there run it as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: 2e-5 absolute where the math is f32 end to end (f32 and int8
K/V with f32 output); 2e-2 for bf16 K/V, where p is rounded to bf16
before the p.v contraction (normalized in the plain version, not in the
kernel); 1.6e-2 — two bf16 ulps at |out| <= 2 — for a bf16 output."""

import pytest
import torch

TOL = {"fp32": 2e-5, "int8": 2e-5, "bf16": 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(kind, n, L, h, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(n, h, d, device="cuda", generator=g)
    pos = torch.randint(0, L, (n,), device="cuda", generator=g,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, L - 1
    k = torch.randn(n, L, h, d, device="cuda", generator=g)
    v = torch.randn(n, L, h, d, device="cuda", generator=g)
    if kind == "int8":
        ks = k.abs().amax(dim=(1, 3)) / 100.0
        vs = v.abs().amax(dim=(1, 3)) / 100.0
        k = torch.round(k / ks[:, None, :, None]).to(torch.int8)
        v = torch.round(v / vs[:, None, :, None]).to(torch.int8)
        return q, k, v, pos, ks, vs
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return q, k.to(dt), v.to(dt), pos, None, None


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("L", [512, 300])
@pytest.mark.parametrize("kind", ["int8", "bf16", "fp32"])
def test_decode_attention_kernel_matches_plain_version(card, kind, L, d):
    from bigdl_tpu_torch.ops import decode_attention as da

    q, k, v, pos, ks, vs = _inputs(kind, 16, L, 12 if d == 64 else 4, d,
                                   seed=L + d)
    before = da.launches
    got = da.pooled_decode_attention(q, k, v, pos, ks, vs,
                                     out_dtype=torch.float32)
    want = da.decode_attention_reference(q, k, v, pos, ks, vs,
                                         out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    assert float((got - want).abs().max()) <= TOL[kind]


@pytest.mark.cuda
def test_decode_attention_bf16_in_and_out_as_the_engine_calls_it(card):
    from bigdl_tpu_torch.ops import decode_attention as da

    q, k, v, pos, ks, vs = _inputs("int8", 16, 512, 12, 64, seed=1)
    q = q.to(torch.bfloat16)
    got = da.decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    want = da.decode_attention_reference(q, k, v, pos, k_scale=ks,
                                         v_scale=vs)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= 1.6e-2


@pytest.mark.cuda
def test_decode_attention_kernel_refuses_what_it_does_not_support(card):
    from bigdl_tpu_torch.ops import decode_attention as da

    q, k, v, pos, ks, vs = _inputs("fp32", 2, 8, 2, 48, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        da.pooled_decode_attention(q, k, v, pos)
    q, k, v, pos, ks, vs = _inputs("fp32", 2, 8, 2, 32, seed=0)
    with pytest.raises(ValueError, match="dtype"):
        da.pooled_decode_attention(q, k.half(), v.half(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        da.pooled_decode_attention(q, k.transpose(1, 2).contiguous()
                                   .transpose(1, 2), v, pos)
    with pytest.raises(ValueError, match="CUDA tensor"):
        da.pooled_decode_attention(q, k, v, pos.cpu())
