"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs on a
machine without them; tests/conftest.py imports jax, so there run it as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: 2e-5 absolute where the math is f32 end to end (f32 and int8
K/V with f32 output); 2e-2 for bf16 K/V, where p is rounded to bf16
before the p.v contraction (normalized in the plain version, not in the
kernel); 1.6e-2 — two bf16 ulps at |out| <= 2 — for a bf16 output.

Flash attention errors are taken row by row, relative to the largest
magnitude of the same row of the plain result
(``flash_attention.max_row_rel_err``; under causal masking row magnitudes
span orders, so a tensor-wide scale would hide a fault in the late rows):
2e-5 for f32 (sums in another order), 2e-2 for bf16 (p and ds are rounded
to bf16 relative to the running max in the kernels and to the final max in
the plain version, and outputs are bf16: a few bf16 ulps).

The weight-only int8 projection (W8A16) is held row by row too, within
5e-5 of each row's largest plain value: the kernel and its plain version
differ only in the order of f32 sums (every bf16 product is exact); the
dynamic scheme's int8 product bitwise the CPU's."""

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


# The kernel splits each (row, head)'s live columns 0..pos over
# split_count(N*H, L, SMs) blocks of one cluster, ceil((pos + 1) / splits)
# columns each, and merges them in split order. The shapes below reach 1, 2
# and MAX_SPLITS splits on any card: N*H >= 4 SMs gives 1, 2 SMs <= N*H < 4
# SMs gives 2, N*H <= SMs/2 with L >= 256 gives 8. Positions lie on and next
# to the split boundaries and below the split count (empty splits); every
# result must repeat bitwise.
def _split_shape(splits, sms):
    """(N, H) at which split_count gives ``splits`` with ``sms`` SMs."""
    if splits == 1:
        return sms, 4
    if splits == 2:
        return -(-sms // 2), 4
    return max(sms // 2, 1), 1


def _boundary_positions(splits, L, n):
    """pos below the split count (empty splits), pos where the share steps
    from j to j + 1 columns (pos + 1 = splits*j - 1, splits*j, splits*j + 1),
    pos on and next to s*j for a few shares j, and L - 1."""
    pos = list(range(splits)) + [L - 1]
    for j in (1, 3, 17, 37):
        pos += [splits * j - 2, splits * j - 1, splits * j]
    for j in (3, 17, 64):
        for s in range(1, splits):
            pos += [j * s - 1, j * s, j * s + 1]
    pos = sorted({min(max(p, 0), L - 1) for p in pos})
    return (pos * n)[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("kind", ["int8", "bf16", "fp32"])
def test_decode_attention_splits_at_their_boundaries(card, kind, splits):
    from bigdl_tpu_torch.ops import decode_attention as da

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    (n, h), L = _split_shape(splits, sms), 300
    assert da.split_count(n * h, L, sms) == splits
    q, k, v, _, ks, vs = _inputs(kind, n, L, h, 64, seed=splits)
    pos = torch.tensor(_boundary_positions(splits, L, n), device="cuda",
                       dtype=torch.int32)
    before = da.launches
    got = da.pooled_decode_attention(q, k, v, pos, ks, vs,
                                     out_dtype=torch.float32)
    again = da.pooled_decode_attention(q, k, v, pos, ks, vs,
                                       out_dtype=torch.float32)
    want = da.decode_attention_reference(q, k, v, pos, ks, vs,
                                         out_dtype=torch.float32)
    merged = da.decode_attention_split_reference(
        q, k, v, pos, ks, vs, out_dtype=torch.float32, splits=splits)
    torch.cuda.synchronize()
    assert da.launches == before + 2
    assert float((got - want).abs().max()) <= TOL[kind]
    assert float((got - merged).abs().max()) <= TOL[kind]
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_decode_attention_reads_bf16_q_and_int64_pos_as_they_arrive(card):
    """The int8 path widens q exactly and pos is read in either width, so
    bf16 q with int64 pos (the engine's call) gives bitwise what the same
    values as f32 q and int32 pos give."""
    from bigdl_tpu_torch.ops import decode_attention as da

    q, k, v, pos, ks, vs = _inputs("int8", 16, 512, 12, 64, seed=4)
    qb = q.to(torch.bfloat16)
    got = da.pooled_decode_attention(qb, k, v, pos.long(), ks, vs,
                                     out_dtype=torch.bfloat16)
    same = da.pooled_decode_attention(qb.float(), k, v, pos, ks, vs,
                                      out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    with pytest.raises(ValueError, match="pos dtype"):
        da.pooled_decode_attention(qb, k, v, pos.short(), ks, vs)


def _flash_inputs(b, tq, tk, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(t):
        return torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)

    return rand(tq), rand(tk), rand(tk), rand(tq)


# (B, Tq, Tk, H, D, causal, causal_offset)
FLASH_CASES = [
    (2, 256, 256, 4, 64, True, None),      # tile multiple, causal
    (2, 300, 300, 3, 64, False, None),     # ragged T, non-causal
    (1, 100, 300, 2, 64, False, None),     # Tq != Tk
    (1, 300, 100, 2, 64, True, None),      # Tq > Tk, causal
    (2, 192, 192, 2, 64, True, -1),        # strict causal: row 0 fully masked
    (1, 130, 130, 2, 128, True, None),     # head dim 128
    (1, 70, 70, 2, 16, True, None),        # head dim 16
    (1, 70, 90, 2, 40, False, None),       # head dim padded to 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain_versions(card, case, dtype):
    from bigdl_tpu_torch.ops import flash_attention as fa

    b, tq, tk, h, d, causal, off = case
    q, k, v, do = _flash_inputs(b, tq, tk, h, d, dtype, seed=tq + d)
    scale = d ** -0.5
    counts = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                         causal_offset=off)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, scale, causal,
                                                off or 0)
    grads = fa.flash_attention_block_grads(q, k, v, o_ref, lse_ref, do,
                                           causal=causal, causal_offset=off)
    refs = fa.flash_backward_reference(q, k, v, o_ref, lse_ref, do, scale,
                                       causal, off or 0)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + 1 for c in counts)
    assert o.dtype == dtype and lse.dtype == torch.float32
    rtol = fa.ROW_RTOL[dtype]
    assert fa.max_row_rel_err(o, o_ref) <= rtol
    # lse: f32 on both sides; masked rows hold the -1e30 sentinel
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    for got, want in zip(grads, refs):
        assert got.shape == want.shape and got.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert fa.max_row_rel_err(got, want) <= rtol


# The kernels' tile edges (the forward and dq: 128 query rows by 64 keys;
# dk/dv: 128 keys by 64 queries; head dims in 64-wide panels):
# (B, Tq, Tk, H, D, causal, causal_offset)
FLASH_EDGE_CASES = [
    (1, 127, 127, 2, 64, True, None),
    (1, 128, 128, 2, 64, True, None),
    (1, 129, 129, 2, 64, False, None),
    (1, 257, 257, 2, 64, True, -1),        # strict causal past two tiles
    (1, 257, 129, 2, 16, True, None),      # Tq > Tk, head dim 16
    (1, 128, 257, 2, 40, False, None),     # head dim 40 in a 64-wide panel
    (1, 257, 257, 2, 128, True, -1),       # head dim 128: two panels
    (2, 129, 127, 3, 128, True, None),     # Tq > Tk across the tile height
    (1, 257, 191, 2, 64, True, None),      # Tq = 128n + 1, Tk = 64n - 1
    (1, 255, 193, 2, 64, False, None),     # Tq = 128n - 1, Tk = 64n + 1
    (2, 40, 200, 3, 64, True, None),       # Tq < 64: key blocks no query sees
    (1, 40, 200, 2, 64, False, None),      # Tq < 64 with Tk > 128
    (1, 130, 130, 2, 8, True, None),       # head dim 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_EDGE_CASES)
def test_flash_kernels_at_the_tile_edges_repeat_bitwise(card, case):
    from bigdl_tpu_torch.ops import flash_attention as fa

    b, tq, tk, h, d, causal, off = case
    q, k, v, do = _flash_inputs(b, tq, tk, h, d, torch.bfloat16,
                                seed=tq + tk + d)
    scale = d ** -0.5
    counts = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                         causal_offset=off)
    o2, lse2 = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           causal_offset=off)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, scale, causal,
                                                off or 0)
    grads = fa.flash_attention_block_grads(q, k, v, o_ref, lse_ref, do,
                                           causal=causal, causal_offset=off)
    grads2 = fa.flash_attention_block_grads(q, k, v, o_ref, lse_ref, do,
                                            causal=causal, causal_offset=off)
    refs = fa.flash_backward_reference(q, k, v, o_ref, lse_ref, do, scale,
                                       causal, off or 0)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (
        counts[0] + 2, counts[1] + 2, counts[2] + 2)
    rtol = fa.ROW_RTOL[torch.bfloat16]
    assert bool(torch.isfinite(o).all())
    assert fa.max_row_rel_err(o, o_ref) <= rtol
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    # no atomics: a second launch is bitwise equal
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    for got, again, want in zip(grads, grads2, refs):
        assert fa.max_row_rel_err(got, want) <= rtol
        assert torch.equal(again, got)


# The delta the dq kernel writes for dk/dv, through the C entry point:
# (B, Tq, Tk, H, D, causal)
FLASH_DELTA_CASES = [
    (2, 300, 300, 3, 64, True),
    (1, 257, 129, 2, 128, False),
    (1, 40, 200, 2, 8, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_DELTA_CASES)
def test_flash_dq_kernel_writes_delta(card, case):
    """delta = sum_d dO * O of every query row, as the bf16 dq kernel
    writes it, within 1e-5 of the largest |delta| of the plain version (f32
    sums of the same products taken in another order)."""
    from bigdl_tpu_torch.ops import flash_attention as fa

    b, tq, tk, h, d, causal = case
    q, k, v, do = _flash_inputs(b, tq, tk, h, d, torch.bfloat16,
                                seed=tq + d)
    scale = d ** -0.5
    o, lse = fa.flash_forward_reference(q, k, v, scale, causal)
    o, lse = o.contiguous(), lse.contiguous()  # as the wrapper passes them
    delta = torch.full((b, h, tq), float("nan"), device="cuda")
    dq = torch.empty_like(q)
    err = fa._library().bigdl_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h,
        tq, tk, d, int(causal), 0, scale, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = fa._delta(o, do)
    assert float((delta - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_flash_autograd_runs_the_three_kernels(card):
    from bigdl_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(2, 200, 200, 3, 64, torch.bfloat16, seed=4)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + 1 for c in counts)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o_ref, lse_ref = fa.flash_forward_reference(qd, kd, vd, 64 ** -0.5, True)
    refs = fa.flash_backward_reference(qd, kd, vd, o_ref, lse_ref, do,
                                       64 ** -0.5, True)
    rtol = fa.ROW_RTOL[torch.bfloat16]
    assert fa.max_row_rel_err(out.detach(), o_ref) <= rtol
    for t, want in zip((q, k, v), refs):
        assert fa.max_row_rel_err(t.grad, want) <= rtol


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_support(card):
    from bigdl_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_inputs(1, 16, 16, 2, 12, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_fwd_cuda(q, k, v, 0.3)
    q, k, v, _ = _flash_inputs(1, 16, 16, 2, 64, torch.float16, seed=0)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_fwd_cuda(q, k, v, 0.3)
    q, k, v, _ = _flash_inputs(1, 16, 16, 2, 64, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_fwd_cuda(q, k.cpu(), v, 0.3)


# Fused BN -> ReLU -> 1x1 conv (bigdl_tpu_torch/ops/fused_conv.py). Each
# output row (z, y, dp: a row over channels; dW: an input channel's row)
# against the same row of the plain version, relative to its largest
# magnitude (fused_conv.ROW_RTOL: 1e-5 f32, 1e-2 bf16 — one bf16 rounding
# of outputs whose f32 sums differ in order); the f32 channel sums (zstats,
# q) within 1e-4 of each sum row's largest magnitude.
FUSED_CASES = [
    # (M, C, K, residual, want_y / extra dy)
    (4096, 256, 64, True, True),       # the stage-1 join shape, smaller M
    (1000, 128, 256, False, False),    # ragged M
    (777, 100, 72, True, True),        # C, K not tile (or 8) multiples
]


def _fused_inputs(m, c, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    x = rand(m, c, scale=2.0) + 0.5
    mean, var = x.mean(0), x.var(0, correction=0)
    inv_std = torch.rsqrt(var + 1e-5)
    gamma, beta = rand(c, scale=0.5) + 1.0, rand(c, scale=0.3)
    scale = gamma * inv_std
    shift = beta - mean * scale
    return dict(x=x.to(dtype), r=rand(m, c).to(dtype),
                w=(rand(c, k) / c ** 0.5).to(dtype), dz=rand(m, k).to(dtype),
                dy=rand(m, c).to(dtype), scale=scale, shift=shift, mean=mean,
                inv_std=inv_std)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_conv_kernels_match_plain_versions(card, case, dtype):
    from bigdl_tpu_torch.ops import fused_conv as fc

    m, c, k, res, extra = case
    d = _fused_inputs(m, c, k, dtype, seed=m + c)
    r = d["r"] if res else None
    g = d["dy"] if extra else None
    counts = (fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches)
    got = fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"], d["w"], r, extra)
    want = fc.fused_fwd_reference(d["x"], d["scale"], d["shift"], d["w"], r,
                                  extra)
    dp, q = fc.fused_dgrad_cuda(d["dz"], d["w"], d["x"], d["scale"],
                                d["shift"], d["mean"], d["inv_std"], r, g)
    dp_ref, q_ref = fc.fused_dgrad_reference(
        d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
        d["inv_std"], r, g)
    dw = fc.fused_wgrad_cuda(d["x"], d["scale"], d["shift"], d["dz"], r,
                             out_dtype=dtype)
    dw_ref = fc.fused_wgrad_reference(d["x"], d["scale"], d["shift"],
                                      d["dz"], r, out_dtype=dtype)
    torch.cuda.synchronize()
    assert (fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches) == tuple(
        n + 1 for n in counts)
    rtol = fc.ROW_RTOL[dtype]
    pairs = [(got[0], want[0]), (dp, dp_ref), (dw, dw_ref)]
    if extra:
        pairs.append((got[2], want[2]))
    for a, b in pairs:
        assert a.dtype == dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert fc.max_row_rel_err(a, b) <= rtol
    assert fc.max_row_rel_err(got[1], want[1]) <= 1e-4
    assert fc.max_row_rel_err(q, q_ref) <= 1e-4
    # the two-stage sums are deterministic: a second run is bitwise equal
    again = fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"], d["w"], r,
                              extra)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert torch.equal(fc.fused_wgrad_cuda(d["x"], d["scale"], d["shift"],
                                           d["dz"], r, out_dtype=dtype), dw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,z_dtype", [(torch.bfloat16, torch.float32),
                                           (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_forward_out_dtype_matches_plain_version(card, case, dtype,
                                                       z_dtype):
    """z in another dtype than x (JAX's ``out_dtype``): the zcast kernel
    against the plain version, z at z's tolerance, y at x's."""
    from bigdl_tpu_torch.ops import fused_conv as fc

    m, c, k, res, extra = case
    d = _fused_inputs(m, c, k, dtype, seed=2 * m + c)
    args = (d["x"], d["scale"], d["shift"], d["w"], d["r"] if res else None,
            extra)
    before = fc.fwd_launches
    got = fc.fused_fwd_cuda(*args, out_dtype=z_dtype)
    want = fc.fused_fwd_reference(*args, out_dtype=z_dtype)
    torch.cuda.synchronize()
    assert fc.fwd_launches == before + 1
    assert got[0].dtype == want[0].dtype == z_dtype
    assert fc.max_row_rel_err(got[0], want[0]) <= fc.ROW_RTOL[z_dtype]
    assert fc.max_row_rel_err(got[1], want[1]) <= 1e-4
    if extra:
        assert got[2].dtype == dtype
        assert fc.max_row_rel_err(got[2], want[2]) <= fc.ROW_RTOL[dtype]


# ResNet-50's 10 (C, K) pairs of the fused edges, run at a small ragged M
# (several 128-row tiles), and whether the edge reads the residual (those
# also want y and take an extra dy). In bf16 they cover every tile shape
# of the wgmma kernels: the dgrad's BN 64 (K <= 128) and BN 128; the
# forward's BN 64 (K 64), BN 128 with 1 to 4 N tiles, and its resident y
# panel (K > 256 without a residual); the wgrad's 256 x 64, 128 x 128 and
# 128 x 64 tiles.
RESNET50_EDGES = [(256, 64, True), (256, 128, True), (128, 512, False),
                  (512, 128, True), (512, 256, True), (256, 1024, False),
                  (1024, 256, True), (1024, 512, True), (512, 2048, False),
                  (2048, 512, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,k,res", RESNET50_EDGES)
def test_fused_forward_at_resnet50_shapes_repeats_bitwise(card, c, k, res,
                                                          dtype):
    from bigdl_tpu_torch.ops import fused_conv as fc

    m = 1000 + c % 97                     # several 128-row tiles, ragged
    d = _fused_inputs(m, c, k, dtype, seed=c + 3 * k)
    args = (d["x"], d["scale"], d["shift"], d["w"], d["r"] if res else None,
            res)
    before = fc.fwd_launches
    got = fc.fused_fwd_cuda(*args)
    again = fc.fused_fwd_cuda(*args)
    want = fc.fused_fwd_reference(*args)
    torch.cuda.synchronize()
    assert fc.fwd_launches == before + 2
    assert len(got) == len(want) == (3 if res else 2)
    for j, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        rtol = 1e-4 if j == 1 else fc.ROW_RTOL[dtype]
        assert fc.max_row_rel_err(a, b) <= rtol
        assert torch.equal(a, again[j])


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,k,res", RESNET50_EDGES)
def test_fused_wgrad_at_resnet50_shapes_repeats_bitwise(card, c, k, res,
                                                        out_dtype):
    from bigdl_tpu_torch.ops import fused_conv as fc

    m = 1000 + c % 97                     # several 128-row tiles, ragged
    d = _fused_inputs(m, c, k, torch.bfloat16, seed=c + 5 * k)
    args = (d["x"], d["scale"], d["shift"], d["dz"], d["r"] if res else None,
            out_dtype)
    before = fc.wgrad_launches
    dw = fc.fused_wgrad_cuda(*args)
    dw2 = fc.fused_wgrad_cuda(*args)
    dw_ref = fc.fused_wgrad_reference(*args)
    torch.cuda.synchronize()
    assert fc.wgrad_launches == before + 2
    assert dw.dtype == out_dtype and dw.shape == (c, k)
    assert bool(torch.isfinite(dw).all())
    # bf16 dW: one rounding of f32 sums taken in another order; f32 dW: the
    # order alone (bf16 products are exact in f32), the f32 sums' 1e-4
    rtol = fc.ROW_RTOL[torch.bfloat16] if out_dtype == torch.bfloat16 else 1e-4
    assert fc.max_row_rel_err(dw, dw_ref) <= rtol
    assert torch.equal(dw, dw2)


# Rows past M and ragged C and K on the bf16 wgmma route: shift > 0 on
# every channel, so relu(x*scale + shift) of the zero rows TMA fills in
# past M is not zero, and the kernels must zero them (zstats would count
# them); M of 1, one short of a 128-row tile and one past it. (C, K,
# residual): the stage-1 join's pair; C 72, K 40 (multiples of 8, not of
# 64: ragged 64-wide panels); C 328, K 264 (the forward keeps its y panel
# of six 64-channel tiles, the last holding 8 channels, over three N tiles,
# the last holding 8 columns; the wgrad's third 128-channel tile holds one
# panel of 8 channels and one wholly past C)
PADDED_ROW_CASES = [(256, 64, True), (72, 40, True), (328, 264, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 127, 129])
@pytest.mark.parametrize("c,k,res", PADDED_ROW_CASES)
def test_fused_wgmma_kernels_add_nothing_from_rows_past_m(card, c, k, res, m):
    from bigdl_tpu_torch.ops import fused_conv as fc

    d = _fused_inputs(m, c, k, torch.bfloat16, seed=m + c + k)
    shift = d["shift"].abs() + 0.5
    r = d["r"] if res else None
    got = fc.fused_fwd_cuda(d["x"], d["scale"], shift, d["w"], r, res)
    want = fc.fused_fwd_reference(d["x"], d["scale"], shift, d["w"], r, res)
    dw = fc.fused_wgrad_cuda(d["x"], d["scale"], shift, d["dz"], r,
                             out_dtype=torch.bfloat16)
    dw_ref = fc.fused_wgrad_reference(d["x"], d["scale"], shift, d["dz"], r,
                                      out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rtol = fc.ROW_RTOL[torch.bfloat16]
    assert fc.max_row_rel_err(got[1], want[1]) <= 1e-4
    for a, b in [(got[0], want[0]), (dw, dw_ref)] + (
            [(got[2], want[2])] if res else []):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert fc.max_row_rel_err(a, b) <= rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,k,res", RESNET50_EDGES)
def test_fused_dgrad_at_resnet50_shapes_repeats_bitwise(card, c, k, res,
                                                        dtype):
    from bigdl_tpu_torch.ops import fused_conv as fc

    m = 1000 + c % 97                     # several 128-row tiles, ragged
    d = _fused_inputs(m, c, k, dtype, seed=c + k)
    r = d["r"] if res else None
    g = d["dy"] if res else None
    args = (d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
            d["inv_std"], r, g)
    before = fc.dgrad_launches
    dp, q = fc.fused_dgrad_cuda(*args)
    dp2, q2 = fc.fused_dgrad_cuda(*args)
    dp_ref, q_ref = fc.fused_dgrad_reference(*args)
    torch.cuda.synchronize()
    assert fc.dgrad_launches == before + 2
    assert dp.dtype == dtype and bool(torch.isfinite(dp).all())
    assert fc.max_row_rel_err(dp, dp_ref) <= fc.ROW_RTOL[dtype]
    assert fc.max_row_rel_err(q, q_ref) <= 1e-4
    assert torch.equal(dp, dp2) and torch.equal(q, q2)


@pytest.mark.cuda
def test_bn_relu_conv1x1_autograd_runs_the_three_kernels(card):
    from bigdl_tpu_torch.ops import fused_conv as fc

    d = _fused_inputs(2048, 128, 64, torch.float32, seed=3)
    x = d["x"].requires_grad_()
    gamma = torch.ones(128, device="cuda", requires_grad=True)
    beta = torch.zeros(128, device="cuda", requires_grad=True)
    w = d["w"].requires_grad_()
    mean, var = d["x"].detach().mean(0), d["x"].detach().var(0, correction=0)
    counts = (fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches)
    z, zstats = fc.bn_relu_conv1x1(x, gamma, beta, mean, var, w)
    grads = torch.autograd.grad(z, (x, gamma, beta, w), d["dz"])
    torch.cuda.synchronize()
    assert (fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches) == tuple(
        n + 1 for n in counts)
    assert not zstats.requires_grad
    cpu = [t.detach().cpu().requires_grad_() for t in (x, gamma, beta, w)]
    zc, _ = fc.bn_relu_conv1x1(cpu[0], cpu[1], cpu[2], mean.cpu(), var.cpu(),
                               cpu[3])
    want = torch.autograd.grad(zc, cpu, d["dz"].cpu())
    assert fc.max_row_rel_err(z.cpu(), zc) <= 1e-5
    for a, b in zip(grads, want):
        assert fc.max_row_rel_err(a.cpu().reshape(-1, a.shape[-1]),
                                  b.reshape(-1, b.shape[-1])) <= 1e-4


@pytest.mark.cuda
def test_fused_conv_kernels_refuse_rather_than_fall_back(card):
    from bigdl_tpu_torch.ops import fused_conv as fc

    d = _fused_inputs(64, 16, 8, torch.float32, seed=0)
    with pytest.raises(ValueError, match="one dtype"):
        fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"],
                          d["w"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fc.fused_fwd_cuda(d["x"].half(), d["scale"], d["shift"],
                          d["w"].half())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fc.fused_wgrad_cuda(d["x"], d["scale"], d["shift"], d["dz"].cpu())


# 3x3 stride-1 conv (bigdl_tpu_torch/ops/conv3x3.py): each output pixel's K
# channels against the same pixel of the plain version, relative to its
# largest magnitude (conv3x3.ROW_RTOL: 1e-5 f32 — the same products summed
# in another order; 1e-2 bf16 — one bf16 rounding of the outputs).
CONV3X3_CASES = [
    # (N, H, W, C, K)
    (3, 13, 11, 40, 72),     # ragged: C and K not tile multiples
    (1, 1, 1, 3, 5),         # one pixel; C and K below 8 (scalar loads)
    (2, 7, 7, 64, 64),       # ResNet-50 stage 4 images, both in one tile
    (2, 20, 9, 32, 130),     # several pixel tiles; K % 8 != 0 (loads by hand)
    (3, 5, 9, 64, 64),       # 135 pixels: a tile straddling rows and images
    (2, 6, 7, 520, 72),      # C past eight 64-channel chunks, ragged
    (2, 5, 6, 24, 129),      # K = 129: one past a 128-channel tile
]


def _conv3x3_inputs(n, h, w, c, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, w, c, device="cuda", generator=g).to(dtype)
    w9 = (torch.randn(9, c, k, device="cuda", generator=g) * 0.05).to(dtype)
    return x, w9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CONV3X3_CASES)
def test_conv3x3_kernel_matches_plain_version(card, case, dtype):
    from bigdl_tpu_torch.ops import conv3x3 as cv

    x, w9 = _conv3x3_inputs(*case, dtype, seed=sum(case))
    before = cv.launches
    got = cv.conv3x3(x, w9)
    want = cv.conv3x3_reference(x, w9)
    torch.cuda.synchronize()
    assert cv.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert cv.max_row_rel_err(got, want) <= cv.ROW_RTOL[dtype]
    # no atomics: a second launch is bitwise equal
    again = cv.conv3x3(x, w9)
    torch.cuda.synchronize()
    assert cv.launches == before + 2
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_conv3x3_kernel_takes_views_and_refuses_rather_than_falls_back(card):
    from bigdl_tpu_torch.ops import conv3x3 as cv

    x, w9 = _conv3x3_inputs(3, 6, 5, 16, 24, torch.float32, seed=0)
    # a contiguous image slice and weights at an unaligned storage offset
    buf = torch.cat([torch.zeros(1, device="cuda"), w9.reshape(-1)])
    w9_off = buf[1:].view(9, 16, 24)
    got = cv.conv3x3(x[1:], w9_off)
    assert cv.max_row_rel_err(got, cv.conv3x3_reference(x[1:], w9)) <= 1e-5
    with pytest.raises(ValueError, match="both"):
        cv.conv3x3(x, w9.to(torch.bfloat16))
    with pytest.raises(ValueError, match="both"):
        cv.conv3x3(x.half(), w9.half())
    with pytest.raises(ValueError, match="contiguous"):
        cv.conv3x3(x.transpose(1, 2), w9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cv.conv3x3(x, w9.cpu())


# -- the int8 KV cache's grow-only requantize ------------------------------

#: (n, L, h, d, byte offset into the buffer): the serving shape and a small
#: one on 16-byte loads, an odd head dim and a misaligned view on byte
#: loads, and L 300 with 170 positions a chunk (not a multiple of it)
REQUANT_CASES = [(16, 512, 12, 64, 0), (3, 37, 5, 32, 0), (3, 37, 5, 20, 0),
                 (2, 9, 3, 48, 8), (2, 300, 3, 64, 0)]


def _requant_inputs(n, L, h, d, offset, seed):
    """Seeded int8 caches (possibly a view at a byte offset), old scales
    and new-value maxima: row 0 zero-scaled and growing (ratio 0), row 1
    inactive (amax 0, ratio 1), the rest mixing grown and not-grown
    heads. Returns ``(kc, vc, ks, vs, k_amax, v_amax)``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    numel = n * L * h * d

    def cache():
        buf = torch.randint(-127, 128, (numel + offset,), dtype=torch.int8,
                            device="cuda", generator=g)
        return buf[offset:].view(n, L, h, d)

    def scales():
        s_old = torch.rand(n, h, device="cuda", generator=g) * 0.1
        s_old[0] = 0.0
        grow = torch.rand(n, h, device="cuda", generator=g) < 0.5
        grow[0], grow[1] = True, False
        amax = torch.where(grow, (s_old + 0.01) * 127 * 2, s_old * 127 * 0.5)
        amax[1] = 0.0
        return s_old, amax

    (ks, ka), (vs, va) = scales(), scales()
    return cache(), cache(), ks, vs, ka, va


@pytest.mark.cuda
@pytest.mark.parametrize("case", REQUANT_CASES)
def test_kv_requant_kernel_matches_plain_version_bitwise(card, case):
    from bigdl_tpu_torch.ops import kv_requant as kr

    kc, vc, ks, vs, ka, va = _requant_inputs(*case, seed=sum(case))
    want = kr.kv_merge_reference(kc, vc, ks, vs, ka, va)
    k0 = kc.clone()
    kr.launches = 0
    got = kr.kv_requant(kc, vc, ks, vs, ka, va)
    torch.cuda.synchronize()
    assert kr.launches == 1 and got[0] is kc and got[1] is vc
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    k_ratio = kr.kv_scale_merge(ks, ka)[2]
    kept = (k_ratio == 1.0)[:, None, :, None].expand_as(kc)
    assert torch.equal(kc[kept], k0[kept])        # ratio 1: untouched
    assert (kc[0] == 0).all()                     # ratio 0: zeroed
    k1, v1 = kc.clone(), vc.clone()
    again = kr.kv_requant(kc, vc, got[2], got[3], torch.zeros_like(ka),
                          torch.zeros_like(va))   # no growth: no change
    assert torch.equal(kc, k1) and torch.equal(vc, v1)
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize("growth", ["none", "all", "mixed"])
@pytest.mark.parametrize("L", [512, 300])
def test_kv_requant_kernel_growth_cases_bitwise(card, growth, L):
    """No pair grown (every block leaves, the caches untouched), every pair
    grown and a mix, each with a zero-scale row (row 0: grows from zero in
    "all" and "mixed", stays zero in "none") and an inactive row (row 1,
    amax 0): caches and scales bitwise the plain version; at L 300 the
    row's last chunk is partial."""
    from bigdl_tpu_torch.ops import kv_requant as kr

    n, h, d = 4, 12, 64
    g = torch.Generator(device="cuda").manual_seed(L + len(growth))

    def cache():
        return torch.randint(-127, 128, (n, L, h, d), dtype=torch.int8,
                             device="cuda", generator=g)

    def scales():
        s_old = torch.rand(n, h, device="cuda", generator=g) * 0.1 + 0.01
        s_old[0] = 0.0
        grow = torch.rand(n, h, device="cuda", generator=g) < 0.5
        grow[:] = grow if growth == "mixed" else growth == "all"
        amax = torch.where(grow, (s_old + 0.01) * 127 * 2, s_old * 127 * 0.5)
        amax[1] = 0.0
        return s_old, amax

    kc, vc = cache(), cache()
    (ks, ka), (vs, va) = scales(), scales()
    want = kr.kv_merge_reference(kc, vc, ks, vs, ka, va)
    k0, v0 = kc.clone(), vc.clone()
    got = kr.kv_requant(kc, vc, ks, vs, ka, va)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    if growth == "none":
        assert torch.equal(kc, k0) and torch.equal(vc, v0)
    else:
        assert not torch.equal(kc, k0) and not torch.equal(vc, v0)


@pytest.mark.cuda
def test_kv_requant_kernel_refuses_rather_than_falls_back(card):
    from bigdl_tpu_torch.ops import kv_requant as kr

    kc, vc, ks, vs, ka, va = _requant_inputs(2, 8, 3, 32, 0, seed=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kr.kv_requant_cuda(kc.cpu(), vc.cpu(), ks.cpu(), vs.cpu(), ka.cpu(),
                           va.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        strided = kc.transpose(1, 2).contiguous().transpose(1, 2)
        kr.kv_requant_cuda(strided, vc, ks, vs, ka, va)
    with pytest.raises(ValueError, match="f32"):
        kr.kv_requant(kc, vc, ks, vs, ka.double(), va)


# -- the weight-only int8 projection (W8A16) --------------------------------

#: (M, N, K): decode rows (the 137m LM's fc2 and fc1), a prefill (the
#: wgmma kernel for bf16 x, 64-row mma.sync tiles for f32 x), ResNet-50's
#: head at batch 256, a ragged case where no dimension is a multiple of 16,
#: the regime boundary (M 16 decode, M 17 the next regime) at the 137m
#: LM's fc1, the head's prefill (256-row wgmma tiles for a bf16 output),
#: and decode rows with a ragged N and K
W8A16_CASES = [(1, 768, 3072), (4, 3072, 768), (2048, 768, 3072),
               (256, 1000, 2048), (37, 91, 203), (16, 3072, 768),
               (17, 3072, 768), (512, 32768, 768), (5, 91, 203)]
#: per output row, relative to the row's largest plain value: the kernel
#: and the plain version differ only in the order of f32 sums (every bf16
#: product is exact in f32)
W8A16_ROW_RTOL = 5e-5


def _w8a16_inputs(m, n, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda",
                       generator=g)
    scale = torch.rand(n, 1, device="cuda", generator=g) * 1e-2 + 1e-4
    return x, wq, scale


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["f32", "f32_bias", "bf16_bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", W8A16_CASES)
def test_w8a16_kernel_matches_plain_version(card, case, dtype, epilogue):
    """The f32 output (QuantizedLinear, with and without its bias) within
    ``W8A16_ROW_RTOL``; the bf16 output and bias (the bf16 serving
    projection) within 2^-6 of the row's largest value more: the output's
    and the bias add's roundings may each land one bf16 ulp apart, and an
    ulp is at most 2^-7 of its value."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import w8a16 as w8

    x, wq, scale = _w8a16_inputs(*case, dtype, seed=sum(case))
    out_dt = torch.bfloat16 if epilogue.startswith("bf16") else torch.float32
    bias = (torch.randn(case[1], device="cuda").to(out_dt)
            if epilogue.endswith("bias") else None)
    w8.launches = 0
    got = w8.w8a16(x, wq, scale, bias, out_dt)
    again = w8.w8a16(x, wq, scale, bias, out_dt)
    torch.cuda.synchronize()
    assert w8.launches == 2 and got.dtype == out_dt
    assert torch.equal(got, again)          # the split sums run in order
    want = w8.w8a16_plain(x, wq, scale, bias, out_dt)
    tol = W8A16_ROW_RTOL + (2.0 ** -6 if out_dt == torch.bfloat16 else 0.0)
    assert fa.max_row_rel_err(got, want, floor=0.0) <= tol


#: decode shapes whose plan on the card splits K over a cluster of 1, 2
#: or 8 blocks (searched through launch_plan with the card's SM count)
W8A16_SPLIT_SHAPES = [(3072, 768), (2048, 768), (4096, 768), (768, 3072),
                      (320, 2048), (192, 4096), (96, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a16_kernel_at_planned_split_counts(card, splits, dtype):
    """A decode call whose ``launch_plan`` splits K over ``splits`` blocks
    of one cluster: within the tolerance of the plain version, bitwise
    the same on a repeat (the cluster sums the splits in order)."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import w8a16 as w8

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shape = next(((n, k) for n, k in W8A16_SPLIT_SHAPES
                  if w8.launch_plan(8, n, k, sms).splits == splits), None)
    assert shape is not None, f"no shape plans {splits} splits on {sms} SMs"
    n, k = shape
    x, wq, scale = _w8a16_inputs(8, n, k, dtype, seed=splits)
    bias = torch.randn(n, device="cuda").to(dtype)
    got = w8.w8a16(x, wq, scale, bias, dtype)
    again = w8.w8a16(x, wq, scale, bias, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = w8.w8a16_plain(x, wq, scale, bias, dtype)
    tol = W8A16_ROW_RTOL + (2.0 ** -6 if dtype == torch.bfloat16 else 0.0)
    assert fa.max_row_rel_err(got, want, floor=0.0) <= tol


@pytest.mark.cuda
def test_w8a16_kernel_refuses_rather_than_falls_back(card):
    from bigdl_tpu_torch.ops import w8a16 as w8

    x, wq, scale = _w8a16_inputs(4, 64, 64, torch.float32, seed=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        w8.w8a16_cuda(x.cpu(), wq.cpu(), scale.cpu())
    with pytest.raises(ValueError, match="int8"):
        w8.w8a16(x, wq.float(), scale)
    with pytest.raises(ValueError, match="f32 or bf16"):
        w8.w8a16(x.half(), wq, scale)
    with pytest.raises(ValueError, match="contiguous"):
        w8.w8a16(x, wq.t().contiguous().t(), scale)
    with pytest.raises(ValueError, match="bias"):
        w8.w8a16(x, wq, scale, torch.zeros(64, device="cuda"),
                 torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(5, 10, 147), (300, 64, 576),
                                   (17, 1000, 2048)])
def test_dynamic_int8_product_bitwise_the_cpu_integer_product(card, m, n, k):
    """``torch._int_mm`` over zero-padded operands (rows, K and N off its
    shape rules included) against the CPU's int32 matmul, bitwise."""
    from bigdl_tpu_torch.nn.quantized import int8_matmul

    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    b = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
    got = int8_matmul(a.to(card), b.to(card))
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8_matmul(a, b))


# -- the serving engine's admission and scheduling modes on the card -------

def _serving_lm():
    """make_pair()'s vocabulary, width, depth and max_len on the card,
    with one head so the head dim is the kernel's smallest (32)."""
    from bigdl_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(29, hidden_size=32, n_heads=1, n_layers=2,
                       max_len=48, device="cuda", seed=9)
    lm.evaluate()
    return lm


def _serving_engine(**kw):
    from bigdl_tpu_torch.serving import ServingEngine

    kw.setdefault("n_slots", 3)
    return ServingEngine(_serving_lm(), kv_dtype="int8", **kw)


def _serving_reqs(n=7, seed=14):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randint(1, 30, (int(torch.randint(1, 20, (1,),
                                                      generator=g)),),
                           generator=g).tolist(), 8) for _ in range(n)]


@pytest.mark.cuda
def test_serving_row_state_round_trip_is_bitwise(card):
    eng = _serving_engine()
    with torch.no_grad():
        eng.submit(list(range(3, 20)), max_new_tokens=12)
        for _ in range(3):
            eng.step()
        slot = next(iter(eng.scheduler.running))
        payload = eng.pool.row_state(slot)
        other = eng.pool.alloc()
        eng.pool.restore_row(other, payload)
        again = eng.pool.row_state(other)
    assert set(again["carry"]) == set(payload["carry"])
    for k, v in payload["carry"].items():
        assert v.is_cuda and torch.equal(again["carry"][k], v), k


@pytest.mark.cuda
def test_serving_prefix_hit_leaves_the_cached_entry_unchanged(card):
    head = list(range(3, 19))
    eng = _serving_engine(prefix_cache=True)
    with torch.no_grad():
        eng.submit(head, max_new_tokens=3)
        eng.drain()
        nodes = list(eng.prefix_cache._carry_nodes)
        snap = [{k: v.clone() for k, v in n.carry.items()} for n in nodes]
        rids = [eng.submit(head, max_new_tokens=6),
                eng.submit(head + [5, 9], max_new_tokens=6),
                eng.submit(head[:9], max_new_tokens=6)]
        eng.drain()
    assert eng.metrics.metrics.get("serving/prefix_hits")[0] == 3
    assert all(len(eng.result(r)) == 6 for r in rids)
    for node, before in zip(nodes, snap):
        for k, v in before.items():
            assert torch.equal(node.carry[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{"admission": "per_request"},
                                  {"admission": "chunked", "chunk_budget": 8},
                                  {"policy": "priority"}])
def test_serving_modes_launch_decode_attention_every_step(card, mode):
    from bigdl_tpu_torch.ops import decode_attention as da

    eng = _serving_engine(**mode)
    reqs = _serving_reqs()
    with torch.no_grad():
        rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs[:3]]
        eng.step()
        rids += [eng.submit(p, max_new_tokens=n, priority=1)
                 for p, n in reqs[3:]]
        da.launches = 0
        steps = -eng.metrics.decode_step_count
        eng.drain()
    steps += eng.metrics.decode_step_count
    assert steps > 0 and da.launches == steps * 2
    assert all(eng.request(r).finish_reason == "length" for r in rids)
    assert eng.pool.free_slots == eng.pool.n_slots


@pytest.mark.cuda
def test_serving_seeded_faults_finish_every_request(card):
    from bigdl_tpu_torch.serving import FaultInjector, WatchdogConfig

    inj = FaultInjector(seed=0, p_fail=0.1, p_garbage=0.1,
                        p_admit_fail=0.1, max_faults=8)
    eng = _serving_engine(faults=inj,
                          watchdog=WatchdogConfig(max_retries=8))
    with torch.no_grad():
        rids = [eng.submit(p, max_new_tokens=n)
                for p, n in _serving_reqs(seed=3)]
        eng.drain()
    assert inj.total > 0
    assert all(eng.request(r).finish_reason == "length" for r in rids)
    assert all(len(eng.result(r)) == 8 for r in rids)
    assert eng.summary()["serving/retries"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2])
def test_serving_window_streams_equal_the_unwindowed_run(card, W):
    from bigdl_tpu_torch.ops import kv_requant as kr

    def run(W):
        eng = _serving_engine(dispatch_ahead=W)
        with torch.no_grad():
            rids = [eng.submit(p, max_new_tokens=n) for p, n in
                    _serving_reqs()]
            kr.launches = 0
            eng.drain()
        assert kr.launches == eng.metrics.decode_step_count * 2
        assert not eng._window
        return [(eng.result(r).tobytes(), eng.logprobs(r).tobytes())
                for r in rids]

    assert run(W) == run(0)


@pytest.mark.cuda
def test_serving_speculative_greedy_rows_equal_the_plain_engine(card):
    """f32 compute and KV, a weight-tied draft: the speculative engine's
    greedy streams are the plain engine's. On int8 KV every request runs
    to its length (there the chunked verify reads its own K/V unrounded
    and the plain step the int8 round trip, so a near-tie may break
    apart), the verify step's commit launches kv_requant once per target
    layer, and the draft's float cache launches no decode attention."""
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine, SpeculativeConfig

    reqs = _serving_reqs(seed=5)
    outs = []
    for spec in (None, SpeculativeConfig(_serving_lm(), k=3)):
        eng = ServingEngine(_serving_lm(), n_slots=3, kv_dtype="fp32",
                            speculative=spec)
        with torch.no_grad():
            rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
            eng.drain()
        outs.append([eng.result(r).tolist() for r in rids])
    assert outs[0] == outs[1]
    assert eng.summary()["serving/tokens_per_step"] > 1.0
    eng = _serving_engine(speculative=SpeculativeConfig(_serving_lm(), k=3))
    with torch.no_grad():
        rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        da.launches = kr.launches = 0
        eng.drain()
    assert da.launches == 0
    assert kr.launches == eng.metrics.decode_step_count * 2
    assert all(len(eng.result(r)) == 8 for r in rids)


# -- multi-tenant LoRA and constrained decoding on the card ----------------

def _lora_bank(lm, amp=0.5):
    from bigdl_tpu_torch.serving import AdapterBank

    bank = AdapterBank(lm, rank=2, n_slots=4)
    for seed in (1, 2):
        bank.alloc(bank.random_factors(seed=seed, amp=amp))
    return bank


def _adapted_top2_gap(lm, bank, prompt, prefix, aid):
    """Top-1 minus top-2 log-prob of ``lm`` under adapter ``aid`` after
    ``prompt + prefix`` (1-based), through the adapted batch prefill."""
    from bigdl_tpu_torch.models import transformer as tm

    dev = lm[0].weight.device
    prefill = tm.make_batch_prefill_step(lm, adapter=bank.spec)
    _, init = tm.make_batch_decode_step(lm)
    seq = [t - 1 for t in prompt + prefix]
    with torch.no_grad():
        lp, _ = prefill(tm.serving_params(lm),
                        torch.tensor([seq], device=dev),
                        [len(seq)], init(1),
                        torch.tensor([aid], device=dev),
                        bank.device_arrays(dev))
    top2 = lp[0].topk(2).values
    return float(top2[0] - top2[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_serving_lora_null_rows_are_the_bankless_engine(card, kv):
    """Mixed traffic on a bank-ed engine on the card (base rows, two
    tenants, a forced template): every unconstrained null-adapter row's
    tokens and log-probs are bitwise the bank-less engine's, constrained
    rows emit their template, and on int8 KV decode attention and
    kv_requant launch once per layer per decode step."""
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine, fixed_sequence

    lm = _serving_lm()
    bank = _lora_bank(lm)
    reqs = _serving_reqs(n=9, seed=3)
    runs = []
    for adapters in (None, bank):
        eng = ServingEngine(lm, n_slots=3, kv_dtype=kv, adapters=adapters)
        with torch.no_grad():
            rids = []
            for i, (p, n) in enumerate(reqs):
                mixed = adapters is not None
                rids.append(eng.submit(
                    p, max_new_tokens=n, adapter_id=i % 3 if mixed else 0,
                    constraint=fixed_sequence([4, 9, 2])
                    if mixed and i % 4 == 3 else None))
            da.launches = kr.launches = 0
            eng.drain()
        runs.append([(eng.result(r).tobytes(), eng.logprobs(r).tobytes())
                     for r in rids])
        if kv == "int8":
            want = eng.metrics.decode_step_count * 2
            assert da.launches == want and kr.launches == want
    for i, (plain, mixed) in enumerate(zip(*runs)):
        if i % 3 == 0 and i % 4 != 3:
            assert plain == mixed, i
        if i % 4 == 3:
            assert list(torch.frombuffer(bytearray(mixed[0]),
                                         dtype=torch.int32))[:3] == [4, 9, 2]
    assert bank.live == {1: 1, 2: 1}


@pytest.mark.cuda
def test_serving_lora_on_the_card_matches_the_cpu(card):
    """f32 compute, KV and bank with TF32 off: a bank-ed engine on the
    card emits the same engine's CPU tokens row for row (base and both
    tenants); a row may leave the CPU stream only where the CPU model's
    top-2 gap under its adapter is below 1e-3 (a near-tie f32 rounding
    may break apart)."""
    import copy

    from bigdl_tpu_torch.serving import ServingEngine

    lm = _serving_lm()
    lm_cpu = copy.deepcopy(lm).to("cpu")
    bank = _lora_bank(lm)
    reqs = _serving_reqs(n=7, seed=5)
    outs = []
    for model, dev in ((lm, "cuda"), (lm_cpu, "cpu")):
        eng = ServingEngine(model, n_slots=3, kv_dtype="fp32",
                            adapters=bank, device=dev)
        with torch.no_grad():
            rids = [eng.submit(p, max_new_tokens=n, adapter_id=i % 3)
                    for i, (p, n) in enumerate(reqs)]
            eng.drain()
        outs.append([eng.result(r).tolist() for r in rids])
    for i, ((p, _), got, want) in enumerate(zip(reqs, *outs)):
        if got != want:
            j = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            assert _adapted_top2_gap(lm_cpu, bank, p, want[:j], i % 3) \
                < 1e-3, (i, got, want)


# -- the disaggregated plane on the card -----------------------------------

def _top2_gap(lm, prompt, prefix):
    """Top-1 minus top-2 log-prob of ``lm`` after ``prompt + prefix``
    (1-based), through the batch prefill."""
    from bigdl_tpu_torch.models import transformer as tm

    dev = lm[0].weight.device
    prefill = tm.make_batch_prefill_step(lm)
    _, init = tm.make_batch_decode_step(lm)
    seq = [t - 1 for t in prompt + prefix]
    with torch.no_grad():
        lp, _ = prefill(tm.serving_params(lm), torch.tensor([seq], device=dev),
                        [len(seq)], init(1))
    top2 = lp[0].topk(2).values
    return float(top2[0] - top2[1])


@pytest.mark.cuda
def test_serving_disagg_plane_on_the_card_matches_the_cpu(card):
    """f32 with TF32 off: a two-pool plane on the card, with decode pool 0
    killed mid-stream, emits the same plane's CPU tokens row for row; a
    row may leave the CPU stream only where the CPU model's top-2 gap is
    below 1e-3. Both kernels run on every decode pool of the card."""
    import copy

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import DisaggregatedEngine

    lm = _serving_lm()
    lm_cpu = copy.deepcopy(lm).to("cpu")
    reqs = _serving_reqs(n=7, seed=8)
    outs, summaries = [], []
    for model, dev in ((lm, "cuda"), (lm_cpu, "cpu")):
        d = DisaggregatedEngine(model, prefill_slots=3, decode_slots=3,
                                decode_pools=2, kv_dtype="int8", device=dev)
        da.launches = kr.launches = 0
        with torch.no_grad():
            rids = [d.submit(p, max_new_tokens=n) for p, n in reqs]
            d.step()
            d.step()
            d.kill_pool(0)
            d.drain()
        if dev == "cuda":
            steps = sum(w.engine.metrics.decode_step_count
                        for w in d.decoders)
            assert da.launches == kr.launches == steps * 2 > 0
        outs.append([d.result(r).tolist() for r in rids])
        summaries.append(d.summary())
    for s in summaries:
        assert s["serving/pool_deaths"] == 1.0
        assert s["serving/finish_length"] == len(reqs)
    for (p, _), got, want in zip(reqs, *outs):
        if got != want:
            j = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            assert _top2_gap(lm_cpu, p, want[:j]) < 1e-3, (p, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serving_row_packs_on_the_card_and_restores_bitwise(card, kv):
    """A row of a card pool through the wire: packed (one fenced copy),
    unpacked to host tensors, restored into another slot (one upload):
    every leaf bitwise, bf16 K/V included."""
    from bigdl_tpu_torch.serving import (
        ServingEngine, pack_payload, unpack_payload,
    )
    from bigdl_tpu_torch.serving.disagg import request_meta

    eng = ServingEngine(_serving_lm(), n_slots=3, kv_dtype=kv,
                        compute_dtype=torch.bfloat16)
    with torch.no_grad():
        eng.submit(list(range(3, 20)), max_new_tokens=12)
        for _ in range(3):
            eng.step()
        slot, req = next(iter(eng.scheduler.running.items()))
        payload = eng.pool.row_state(slot)
        _, back = unpack_payload(pack_payload(request_meta(req), payload))
        assert all(v.device.type == "cpu" for v in back["carry"].values())
        other = eng.pool.alloc()
        eng.pool.restore_row(other, back)
        again = eng.pool.row_state(other)
    want = torch.bfloat16 if kv == "bf16" else torch.int8
    assert payload["carry"]["k0"].dtype == want
    for k, v in payload["carry"].items():
        assert again["carry"][k].is_cuda and torch.equal(again["carry"][k], v), k


# -- the SLO autopilot and the LM's own decoder on the card ------------------

@pytest.mark.cuda
def test_serving_autopilot_on_the_card_matches_the_cpu(card):
    """The closed loop on the zoo trace (int8 KV, f32 compute, TF32 off):
    the card's actuation log, goodput and misses equal the CPU's exactly
    (the schedule is host bookkeeping on a stepping clock), both kernels
    launch once per layer per decode step, and each row's tokens equal
    the CPU's or part where the CPU model's top-2 gap is below 1e-3."""
    import copy

    import tools.torch_serving_zoo as zoo
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr

    lm = TransformerLM(29, hidden_size=32, n_heads=1, n_layers=2,
                       max_len=80, device="cuda", seed=9)
    lm.evaluate()
    lm_cpu = copy.deepcopy(lm).to("cpu")
    trace = zoo.make_zoo_trace({"vocab": 29}, 43)
    runs = []
    for model, dev in ((lm, "cuda"), (lm_cpu, "cpu")):
        da.launches = kr.launches = 0
        ap = zoo.default_autopilot()
        with torch.no_grad():
            r = zoo.run_zoo_engine(model, trace, autopilot=ap,
                                   kv_dtype="int8", device=dev)
        if dev == "cuda":
            steps = r.stats["decode_steps"]
            assert da.launches == kr.launches == steps * 2 > 0
        runs.append((r, ap.bus.log))
    (gpu, gpu_log), (cpu, cpu_log) = runs
    assert gpu_log == cpu_log and gpu_log
    for k in ("goodput", "hi_missed", "lo_missed", "preempted", "degraded",
              "steps", "virtual_s"):
        assert gpu.stats[k] == cpu.stats[k], k
    for ti, want in cpu.outs.items():
        got, want = gpu.outs[ti].tolist(), want.tolist()
        if got != want:
            j = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            assert _top2_gap(lm_cpu, trace[ti][1], want[:j]) < 1e-3, ti


@pytest.mark.cuda
def test_generate_and_beam_generate_on_the_card_match_the_cpu(card):
    """f32 with TF32 off: ``generate`` (greedy and seeded-sampled) and
    ``beam_generate`` on the card emit the CPU's ids (a greedy row may
    part only where the CPU model's top-2 gap is below 1e-3), beam scores
    within 1e-4, and the decode-attention kernel launches once per layer
    per decode step."""
    import copy

    from bigdl_tpu_torch.models.transformer import beam_generate, generate
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.serving import SamplingParams

    lm = _serving_lm()
    lm_cpu = copy.deepcopy(lm).to("cpu")
    sp = SamplingParams(temperature=0.9, top_k=8, seed=21)
    for prompt, n in _serving_reqs(n=4, seed=8):
        for sampling in (None, sp):
            da.launches = 0
            got = generate(lm, prompt, length=n, temperature=0.0,
                           sampling=sampling).tolist()
            assert da.launches == n * 2
            want = generate(lm_cpu, prompt, length=n, temperature=0.0,
                            sampling=sampling).tolist()
            if got != want:
                assert sampling is None, (prompt, got, want)
                j = next(j for j, (a, b) in enumerate(zip(got, want))
                         if a != b)
                assert _top2_gap(lm_cpu, prompt, want[:j]) < 1e-3
    da.launches = 0
    seqs, scores = beam_generate(lm, [3, 7, 2, 9], beam_size=4,
                                 decode_length=10)
    assert da.launches == 10 * 2
    seqs_c, scores_c = beam_generate(lm_cpu, [3, 7, 2, 9], beam_size=4,
                                     decode_length=10)
    assert (seqs == seqs_c).all()
    assert abs(scores - scores_c).max() <= 1e-4


@pytest.mark.cuda
def test_lenet_steps_on_the_card_match_the_cpu(card):
    """LeNet-5 (f32, TF32 off) trained 8 SGD steps (momentum 0.9) through
    ``Optimizer`` on the card and on the CPU from the same weights and
    batches: losses within 1e-5 relative, parameters within 1e-5
    absolute (sums in other orders; cuDNN against the CPU's
    convolutions)."""
    import copy

    import numpy as np

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(14)
    xs = rng.standard_normal((256, 1, 28, 28)).astype(np.float32)
    ys = rng.integers(1, 11, size=256).astype(np.float32)
    cpu = LeNet5(10, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = copy.deepcopy(cpu).to("cuda")
    losses = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        seen = []

        def record(state, seen=seen):
            if state["loss"] is not None:
                seen.append(state["loss"])
            return state["neval"] > 8

        opt = Optimizer(model, [Sample(x, y) for x, y in zip(xs, ys)],
                        ClassNLLCriterion(), batch_size=64,
                        end_trigger=Trigger(record,
                                            Trigger.max_iteration(8).peek))
        opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
        opt.optimize()
        losses[name] = seen
    assert len(losses["cuda"]) == 8
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for a, b in zip(gpu.parameters(), cpu.parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_pinned_upload_stages_the_batch_behind_a_copy_event(card):
    """``PinnedUploader`` (the optimizer's ``place_batch``): the batch on
    the card equals the host batch; the copy runs on the side stream
    without holding up the host, and the compute stream's work queued
    after the upload waits for the copy's event. The side stream is held
    by a ~50 ms device spin first, so the order shows in the events."""
    import time

    import numpy as np

    from bigdl_tpu_torch.optim.upload import PinnedUploader

    rng = np.random.default_rng(15)
    up = PinnedUploader(card)
    batches = [(rng.integers(0, 256, (16, 24, 24, 3), dtype=np.uint8),
                rng.integers(1, 11, 16).astype(np.float32))
               for _ in range(3)]
    torch.cuda.synchronize()
    up(*batches[0])                         # creates the side stream
    torch.cuda.synchronize()
    with torch.cuda.stream(up._stream):
        torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    x, y = up(*batches[1])
    host_s = time.perf_counter() - t0
    after = torch.cuda.Event()
    after.record()                          # on the compute stream
    copied = up._copied[1]
    assert not copied.query() and not after.query()
    assert host_s < 0.02, host_s            # the host did not wait
    total = x.float().sum()                 # a step's read
    torch.cuda.synchronize()
    assert copied.query() and after.query()
    assert x.dtype == torch.uint8 and x.device.type == "cuda"
    assert torch.equal(x.cpu(), torch.from_numpy(batches[1][0]))
    assert torch.equal(y.cpu(), torch.from_numpy(batches[1][1]))
    assert float(total) == float(batches[1][0].astype(np.float64).sum())
    # the third batch reuses slot 0's staging buffer after its copy
    x3, y3 = up(*batches[2])
    torch.cuda.synchronize()
    assert torch.equal(x3.cpu(), torch.from_numpy(batches[2][0]))
    assert torch.equal(y3.cpu(), torch.from_numpy(batches[2][1]))


@pytest.mark.cuda
def test_u8_fed_fused_bottleneck_steps_on_the_card_match_the_cpu(
        card, monkeypatch):
    """A two-block bottleneck graph (``maybe_fuse``, every 1×1 edge on the
    kernels at threshold 8) fed uint8 NHWC batches through
    ``set_device_preprocess``, three f32 SGD steps (momentum 0.9, weight
    decay 1e-4) through ``Optimizer`` on the card and on the CPU (plain
    versions) from the same weights: losses within 1e-5 relative,
    parameters within 5e-5 absolute (``resnet_check``'s tolerances)."""
    import copy

    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset import NativeImagePipeline
    from bigdl_tpu_torch.models.resnet import _Builder
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph
    from bigdl_tpu_torch.ops import fused_conv as fc
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    monkeypatch.setenv("BIGDL_PALLAS_MIN_C", "8")
    torch.backends.cudnn.allow_tf32 = False
    b = _Builder("cpu", torch.Generator().manual_seed(4))
    inp = tnn.Input()
    x = b.conv(3, 16, 3, 1, 1).inputs(inp)
    x = tnn.ReLU(True).inputs(b.bn(16).inputs(x))
    x, n = b.residual(x, 16, 8, 1, b.bottleneck_block, "B", True)
    x, n = b.residual(x, n, 16, 2, b.bottleneck_block, "B", True)
    x = tnn.SpatialAveragePooling(4, 4, 1, 1).inputs(x)
    x = tnn.Reshape([n], batch_mode=True).inputs(x)
    cpu = FusedGraph(tnn.Graph(inp, b.linear(n, 10).inputs(x)))
    with torch.no_grad():           # non-zero gammas: every block counts
        for p in cpu.parameters():
            if p.dim() == 1:
                p.add_(0.3)
    gpu = copy.deepcopy(cpu).to(card)
    rng = np.random.default_rng(16)
    imgs = rng.integers(0, 256, (16, 10, 10, 3), dtype=np.uint8)
    labels = rng.integers(1, 11, 16)
    losses = {}
    fc.fwd_launches = fc.dgrad_launches = fc.wgrad_launches = 0
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        pipe = NativeImagePipeline(imgs, labels, batch_size=4, crop=(8, 8),
                                   mean=(120.0, 115.0, 100.0),
                                   std=(60.0, 61.0, 62.0), seed=3,
                                   output="u8_nhwc")
        seen = []

        def record(state, seen=seen):
            if state["loss"] is not None:
                seen.append(state["loss"])
            return state["neval"] > 3

        opt = Optimizer(model, pipe, CrossEntropyCriterion(),
                        end_trigger=Trigger(record,
                                            Trigger.max_iteration(3).peek))
        opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                                 weight_decay=1e-4))
        opt.set_device_preprocess(pipe.device_normalizer())
        opt.optimize()
        losses[name] = seen
    assert [fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches] == [12] * 3
    assert len(losses["cuda"]) == 3
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for a, b_ in zip(gpu.parameters(), cpu.parameters()):
        assert float((a.detach().cpu() - b_.detach()).abs().max()) <= 5e-5


@pytest.mark.cuda
def test_keras_model_on_the_card_round_trips_through_save_module(
        card, tmp_path):
    """A small Keras model (Convolution2D, BatchNormalization, Merge(sum)
    through ``Model``) built on the card: its eval-mode output
    within 1e-5 of the same weights' on the CPU (TF32 off), and bitwise
    after ``save_module`` / ``load_module(device="cuda")``."""
    import copy

    from bigdl_tpu_torch.nn import keras as K
    from bigdl_tpu_torch.nn.module import AbstractModule

    torch.backends.cudnn.allow_tf32 = False
    inp = K.Input((3, 12, 12), device="cuda",
                  generator=torch.Generator("cuda").manual_seed(4))
    a = K.Activation("relu")(K.BatchNormalization()(
        K.Convolution2D(6, 3, 3, border_mode="same")(inp)))
    b = K.Convolution2D(6, 1, 1)(inp)
    out = K.Dense(5, activation="log_softmax")(K.Flatten()(
        K.MaxPooling2D((2, 2))(K.Merge(mode="sum")([a, b]))))
    model = K.Model(input=inp, output=out)
    assert all(p.is_cuda for p in model.parameters())
    model.evaluate()
    x = torch.randn(4, 3, 12, 12, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = model(x.to(card))
        cpu = copy.deepcopy(model).to("cpu")
        want = cpu(x)
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    path = str(tmp_path / "keras.bigdl")
    model.save_module(path)
    loaded = AbstractModule.load_module(path, device="cuda")
    loaded.evaluate()
    assert all(p.is_cuda for p in loaded.parameters())
    with torch.no_grad():
        assert torch.equal(loaded(x.to(card)), got)
