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
the plain version, and outputs are bf16: a few bf16 ulps)."""

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


# ResNet-50's 10 dgrad (C, K) pairs at a small ragged M (the bf16 kernel
# takes its BN 64 shape for K <= 128 and its BN 128 shape above), and
# whether the edge reads the residual and an extra dy
RESNET50_DGRAD = [(256, 64, True), (256, 128, True), (128, 512, False),
                  (512, 128, True), (512, 256, True), (256, 1024, False),
                  (1024, 256, True), (1024, 512, True), (512, 2048, False),
                  (2048, 512, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,k,res", RESNET50_DGRAD)
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
