#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``bigdl_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (built kernels land in
``bigdl_tpu_torch/_build/``) and nothing outside the repository. It
imports neither ``jax`` nor the JAX package. Phases, one JSON line each;
any failure raises, so the exit code is non-zero and no result prints:

1. env      — the card's name and power limit (``nvidia-smi``), torch and
              CUDA versions; TF32 is switched off for f32 matmuls and
              convolutions, so every f32 reference is full f32;
2. build    — every kernel of ``bigdl_tpu_torch/csrc/`` with one ``nvcc``
              per source, all started together; registers and spills from
              ``ptxas -v``, and the count of ``HGMMA`` (wgmma) instructions
              in the SASS (``cuobjdump -sass``) of each wgmma kernel
              (conv3x3's, the flash forward, dq and dk/dv, the fused-conv
              dgrad), which must be above zero; a ptxas line reporting wgmma
              serialized in dq, dk/dv or the dgrad fails the build;
3. kernels  — each kernel against its plain PyTorch version on the card at
              its main path's shapes: decode attention at the serving shape
              (N=16 rows, H=12 heads, L=512, D=64) with per-row positions
              that include 0 and L-1, plus a ragged L, timed with the mean,
              median and min-max of its repetitions beside SDPA's; the
              flash forward, dq and dk/dv kernels at the training shape
              (B=8, T=2048, H=12, D=64, bf16, causal), non-causal at a
              ragged T=300, Tq != Tk,
              and strict causal (causal_offset=-1): each output row's error
              relative to that row's largest plain value against the
              stated tolerance, kernel, plain and library times, and the
              least time the card could take; at the training shape the
              delta the dq kernel writes for dk/dv against the plain
              delta;
4. kv_merge — the cost of the int8 grow check the decode step makes (a
              host read of one flag) against the unconditional requantize;
5. check    — a small model's int8-KV decode step on the card against the
              same step on the CPU, teacher-forced, f32;
6. train_check — a small LM's three ``make_train_step`` steps (f32,
              ``use_flash="always"``, SGD) on the card against the same
              steps on the CPU: losses and parameters;
7. serve    — the serving path at full width: the 137m TransformerLM
              (vocab 32768, hidden 768, 12 layers, 12 heads, max_len 512,
              random weights from seed 0) served bf16 with int8 KV by
              ``ServingEngine(n_slots=16)``: 24 requests, prompts of 16-256
              tokens, 32 new tokens each, greedy and seeded-sampled rows;
              then the device launches per decode step (``torch.profiler``
              over 8 steps of a full pool);
8. train    — the training path at full width: the same 137m model at
              max_len = T = 2048, ``output="logits"``, trained through
              ``Optimizer(...).optimize()`` with
              ``MaskedSoftmaxCECriterion(0)``, ``Adam(1e-4)``, bf16 compute,
              batch 8, 2 warm + 5 timed steps on one seeded batch: step ms
              p50, tokens/s, MFU, peak memory, first and last loss;
9. fused_conv — the fused BN → ReLU → 1×1-conv forward, dgrad and wgrad
              kernels against their plain versions: the stage-1 block join
              (M 802,816, C 256, K 64, residual, y and extra dy, bf16), the
              stage-4 bn2 edge (M 12,544, C 512, K 2048, bf16) and an f32
              case with ragged M, C and K; per-row errors and channel-sum
              errors against the stated tolerances, kernel, plain, bare
              cuBLAS product and unfused-torch times, and the bound;
10. fused_shapes — the three fused-conv kernels at each of the 10 (M, C,
              K) that ResNet-50's step launches them at (batch 256, bf16):
              the dgrad against its plain version, each kernel's median and
              min-max time beside its bound, the cuBLAS product and the
              unfused sequence, and per kernel the step's sum of launches x
              (time - bound);
11. resnet_check — a bottleneck graph's three f32 SGD steps (every edge
              on the kernels) on the card against the CPU: losses,
              parameters and BN running statistics;
12. resnet_train — ResNet-50 at batch 256, 224², bf16 compute, SGD 0.1 /
              momentum 0.9 / weight decay 1e-4, ``maybe_fuse`` with
              ``BIGDL_PALLAS_MIN_C=128``, through ``optimize()``, 2 warm + 5
              timed steps: step ms p50, images/s, peak memory, losses; then
              the unfused ``Graph`` on the same recipe;
13. conv3x3 — the twin of ``benchmarks/pallas_conv3x3_experiment.py``'s
              ``main()``, the one path of its TPU kernel: the 3x3 stride-1
              conv kernel at ResNet-50's four 3x3 shapes (batch 256, 56² x
              64 to 7² x 512, bf16) plus a ragged and a one-pixel f32 case,
              each output pixel against the plain version and the first two
              images against F.conv2d in f32; the four shapes timed (the
              kernel through its C entry point and through the wrapper,
              one launch each on the unpadded input; plain) beside cuDNN's
              F.conv2d, with TFLOP/s and the bound.

Each path's kernel launch counts are set to 0 just before it runs and read
just after; each of its kernels must have launched (decode attention once
per layer per decode step, each flash kernel once per layer per step, each
fused-conv kernel exactly 28 times per ResNet-50 step, the conv3x3 kernel
once per checked case and 33 times per timed shape).

The last lines are the ``{"kernels": [...]}`` summary, the card's
``name, power.limit`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12                # H100 SXM f32 peak outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
HOST_GUARD_CYCLES = 2_000_000    # ~1 ms of device spin while the host enqueues


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Registers and spills over a library's template variants, from
    ``nvcc -Xptxas -v``."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    return {"variants": len(regs), "max_registers": max(regs, default=0),
            "max_spill_store_bytes": max(spills, default=0)}


#: the wgmma kernels, by library: each must hold HGMMA instructions
WGMMA_KERNELS = {"conv3x3": ("conv3x3_wgmma",),
                 "flash_attention": ("fwd_wgmma", "dq_wgmma", "dkv_wgmma"),
                 "fused_conv": ("dgrad_wgmma",)}
#: kernels that must build without a "wgmma ... serialized" ptxas line
NO_SERIALIZED_WGMMA = ("dq_wgmma", "dkv_wgmma", "dgrad_wgmma")


def hgmma_per_kernel(name: str) -> dict:
    """``HGMMA`` (warpgroup matrix multiply) instructions in the SASS of
    each wgmma kernel of the built library ``name``, summed over the
    kernel's template variants: above zero where wgmma was emitted."""
    import shutil

    from bigdl_tpu_torch.utils import cuda_build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", cuda_build.library_path(name)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = dict.fromkeys(WGMMA_KERNELS[name], 0)
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = next((k for k in counts if k in m.group(1)), None)
        elif kernel is not None and re.search(r"\bHGMMA\.", line):
            counts[kernel] += 1
    return counts


def serialized_wgmma(log: str) -> list:
    """The ptxas lines (``-Xptxas -v``) that report wgmma serialized
    (C7510-C7520) in a kernel of ``NO_SERIALIZED_WGMMA``."""
    return [line.strip() for line in log.splitlines()
            if re.search(r"C75(1\d|20)", line) and "wgmma" in line
            and any(k in line for k in NO_SERIALIZED_WGMMA)]


#: host time to enqueue the event pair and ``fn`` of each timed launch of
#: this run (:func:`time_stats`): the longest, the launches, those that
#: took longer than the guard's spin (so the pair may hold host time; each
#: is taken again) and those kept all the same (retakes ran out)
HOST_ENQUEUE = {"max_ms": 0.0, "launches": 0, "over_guard": 0,
                "kept_over_guard": 0}
_GUARD_MS: list = []


def guard_ms() -> float:
    """Device time of one host guard (``torch.cuda._sleep`` of
    ``HOST_GUARD_CYCLES``), by CUDA events, measured once."""
    import torch

    if not _GUARD_MS:
        torch.cuda._sleep(HOST_GUARD_CYCLES)          # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(HOST_GUARD_CYCLES)
        end.record()
        end.synchronize()
        _GUARD_MS.append(start.elapsed_time(end))
    return _GUARD_MS[0]


def time_stats(fn, reps: int = 30, flush=None) -> dict:
    """Device times of ``fn`` by CUDA events, one pair around each of
    ``reps`` launches after 3 warm-up calls: mean, median, min and max in
    ms, and the host's longest enqueue of one. ``flush`` (a large buffer)
    is overwritten before each launch so the caches start cold, as the
    decode step finds the KV cache after the other layers' work. Then the
    card spins (``torch.cuda._sleep``) while the host enqueues the events
    and ``fn``: without it a host slower than the flush leaves the card
    idle inside the event pair, and the time of a short kernel measures
    its wrapper's Python instead. A launch that
    the host took longer to enqueue than the guard spins is taken again,
    up to ``reps`` times in all; :data:`HOST_ENQUEUE` counts them."""
    import torch

    guard = guard_ms()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, retakes, host_max = [], reps, 0.0
    while len(times) < reps:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_GUARD_CYCLES)
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        host_max = max(host_max, host_ms)
        HOST_ENQUEUE["max_ms"] = max(HOST_ENQUEUE["max_ms"], host_ms)
        HOST_ENQUEUE["launches"] += 1
        if host_ms >= guard:
            HOST_ENQUEUE["over_guard"] += 1
            if retakes > 0:
                retakes -= 1
                continue
            HOST_ENQUEUE["kept_over_guard"] += 1
        times.append(start.elapsed_time(end))
    return {"mean": float(np.mean(times)), "median": float(np.median(times)),
            "min": min(times), "max": max(times), "host_ms_max": host_max}


def time_ms(fn, reps: int = 30, flush=None) -> float:
    """Mean device time of ``fn`` (:func:`time_stats`)."""
    return time_stats(fn, reps, flush)["mean"]


def bound(ops: float, n_bytes: float, peak: float):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of ``ops`` at ``peak`` and ``n_bytes`` at the memory rate."""
    t_ops, t_bytes = ops / peak, n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_inputs(kind, n, L, h, d, seed):
    """Seeded inputs on the card; int8 K/V are quantized from normal
    values with the engine's per-(row, head) scale rule."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(n, h, d, device="cuda", generator=g)
    pos = torch.randint(0, L, (n,), device="cuda", generator=g,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, L - 1
    k = torch.randn(n, L, h, d, device="cuda", generator=g)
    v = torch.randn(n, L, h, d, device="cuda", generator=g)
    if kind.startswith("int8"):
        ks = k.abs().amax(dim=(1, 3)) / 127.0 * 1.25
        vs = v.abs().amax(dim=(1, 3)) / 127.0 * 1.25
        k = torch.round(k / ks[:, None, :, None]).clamp(-127, 127)
        v = torch.round(v / vs[:, None, :, None]).clamp(-127, 127)
        return q, k.to(torch.int8), v.to(torch.int8), pos, ks, vs
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return q, k.to(dt), v.to(dt), pos, None, None


# the serving decode step's call: 16 pooled rows, cache 512, 12 heads, D 64
SERVING_DECODE = (16, 512, 12, 64)


def decode_work(q, k_scale, pos, h, d):
    """(live columns, bytes, operations) of one int8 decode-attention call:
    the live K and V columns read once, q in and the output out (q's
    dtype), both scales and pos; q.k and p.v, a multiply and an add each."""
    cols = int((pos.long() + 1).sum())
    n_bytes = (cols * h * d * 2 + q.numel() * q.element_size() * 2
               + 2 * k_scale.numel() * 4 + pos.numel() * pos.element_size())
    return cols, n_bytes, cols * h * d * 4


def dequantized_sdpa(q, k, v, pos, k_scale, v_scale):
    """The int8 decode kernel's library yardstick: one SDPA call over K/V
    dequantized to q's dtype, with the per-row mask. Everything but the
    call is prepared here, outside any timing; the call returns (N, H, 1,
    D)."""
    import torch
    import torch.nn.functional as F

    def deq(t, s):
        t = (t.float() * s[:, None, :, None]).to(q.dtype)
        return t.transpose(1, 2).contiguous()

    kd, vd = deq(k, k_scale), deq(v, v_scale)
    mask = (torch.arange(k.shape[1], device=q.device)[None, None, None, :]
            <= pos.long()[:, None, None, None])
    qs = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)


def kernels_phase():
    """decode_attention against its plain version; returns the kernel's
    summary entry (times at the main path's call: bf16 q and output,
    int8 K/V)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da

    n, L, h, d = SERVING_DECODE
    # (case, q/out dtype, L, tolerance and why)
    cases = [
        ("int8_serving", torch.bfloat16, L, 1.6e-2,
         "bf16 output: two bf16 ulps at |out| <= 2"),
        ("int8", torch.float32, L, 2e-5, "f32 math, sums in another order"),
        ("int8_ragged_L300", torch.float32, 300, 2e-5,
         "f32 math, L not a tile multiple"),
        ("bf16", torch.float32, L, 2e-2,
         "p rounded to bf16 before p.v (unnormalized in the kernel)"),
        ("fp32", torch.float32, L, 2e-5, "f32 math, sums in another order"),
    ]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entry = None
    for i, (case, qdt, Lc, tol, why) in enumerate(cases):
        kind = case.split("_")[0]
        q, k, v, pos, ks, vs = attention_inputs(kind, n, Lc, h, d, seed=i)
        q = q.to(qdt)
        got = da.pooled_decode_attention(q, k, v, pos, ks, vs,
                                         out_dtype=qdt)
        want = da.decode_attention_reference(q, k, v, pos, ks, vs,
                                             out_dtype=qdt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        finite = bool(torch.isfinite(got).all())
        emit("kernels", kernel="decode_attention", case=case,
             shape=[n, Lc, h, d], kv_dtype=str(k.dtype), out_dtype=str(qdt),
             max_abs_err=err, tol=tol, why=why, finite=finite)
        if not finite or err > tol:
            raise AssertionError(
                f"decode_attention {case}: max abs err {err} > tol {tol}")
        if case != "int8_serving":
            continue
        kern = time_stats(lambda: da.pooled_decode_attention(
            q, k, v, pos, ks, vs, out_dtype=qdt), flush=flush)
        ms = kern["mean"]
        plain_ms = time_ms(lambda: da.decode_attention_reference(
            q, k, v, pos, ks, vs, out_dtype=qdt), flush=flush)
        sdpa = dequantized_sdpa(q, k, v, pos, ks, vs)
        lib_err = float((sdpa()[:, :, 0].float() - want.float()).abs().max())
        lib_t = time_stats(sdpa, flush=flush)
        library_ms = lib_t["mean"]
        cols, n_bytes, ops = decode_work(q, ks, pos, h, d)
        bound_ms, bound_by = bound(ops, n_bytes, F32_FLOPS)
        emit("kernels", kernel="decode_attention", case=case, ms=ms,
             ms_median=kern["median"], ms_min_max=[kern["min"], kern["max"]],
             host_ms_max=kern["host_ms_max"],
             splits=da.split_count(n * h, Lc, torch.cuda.get_device_properties(
                 0).multi_processor_count),
             plain_ms=plain_ms, library_ms=library_ms,
             library_ms_median=lib_t["median"],
             library_ms_min_max=[lib_t["min"], lib_t["max"]],
             library_host_ms_max=lib_t["host_ms_max"],
             library="F.scaled_dot_product_attention, bf16 dequantized K/V",
             library_max_abs_err=lib_err, bound_ms=bound_ms,
             bound_by=bound_by, bytes=n_bytes, ops=ops, key_columns=cols,
             roofline_share=bound_ms / ms)
        entry = {"name": "decode_attention", "route": "cuda",
                 "source": "bigdl_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "bigdl_tpu/ops/decode_attention.py:126",
                 "launches": None, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms}
    return entry


def lm_flops_per_token(vocab: int, hidden: int, layers: int, t: int,
                       mlp_ratio: int = 4) -> float:
    """6 N_matmul + 12 L T H (the PaLM convention of
    ``benchmarks/llm_mfu_bench.py:55-63``, copied): forward + backward
    matmul FLOPs per token, attention counted over the full T x T."""
    attn_params = 4 * hidden * hidden
    mlp_params = 2 * hidden * (mlp_ratio * hidden)
    n_matmul = layers * (attn_params + mlp_params) + hidden * vocab
    return 6.0 * n_matmul + 12.0 * layers * t * hidden


def flash_work(b, tq, tk, h, d, causal, off, nbytes):
    """(FLOPs per kernel, bytes per kernel) that this call's data needs:
    the (query, key) pairs the mask keeps (a fully masked row visits every
    key), 2 FLOPs per multiply-add over D for each matmul — 2 in the
    forward, 3 in dq, 4 in dk/dv — and each operand read once, each
    output written once (dq reads O and writes delta too)."""
    rows = np.arange(tq)
    if causal:
        seen = np.clip(rows + off + 1, 0, tk)
        seen = np.where(rows + off < 0, tk, seen)
    else:
        seen = np.full(tq, tk)
    pairs = float(seen.sum()) * b * h
    mm = 2.0 * d * pairs
    q_bytes = b * tq * h * d * nbytes
    kv_bytes = b * tk * h * d * nbytes
    row_f32 = b * h * tq * 4
    return {"fwd": (2 * mm, q_bytes * 2 + kv_bytes * 2 + row_f32),
            "dq": (3 * mm, q_bytes * 4 + kv_bytes * 2 + row_f32 * 2),
            "dkv": (4 * mm, q_bytes * 2 + kv_bytes * 4 + row_f32 * 2)}


# (case, B, Tq, Tk, H, D, causal, causal_offset)
FLASH_CASES = [("train_main", 8, 2048, 2048, 12, 64, True, 0),
               ("noncausal_T300", 2, 300, 300, 12, 64, False, 0),
               ("tq_ne_tk", 2, 200, 520, 12, 64, True, 0),
               ("strict_causal", 2, 512, 512, 12, 64, True, -1)]


def flash_inputs(i: int, dtype):
    """Seeded q, k, v, dO on the card for case ``FLASH_CASES[i]``."""
    import torch

    _, b, tq, tk, h, d, _, _ = FLASH_CASES[i]
    g = torch.Generator(device="cuda").manual_seed(100 + i)

    def rand(t):
        return torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)

    return rand(tq), rand(tk), rand(tk), rand(tq)


def flash_phase():
    """The flash forward, dq and dk/dv kernels against their plain
    versions; returns their summary entries (times at the main shape)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import flash_attention as fa

    # each row of each output against the same row of the plain version,
    # relative to that row's largest magnitude (fa.max_row_rel_err)
    rtol = fa.ROW_RTOL[torch.bfloat16]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entries = {}
    for i, (case, b, tq, tk, h, d, causal, off) in enumerate(FLASH_CASES):
        q, k, v, do = flash_inputs(i, torch.bfloat16)
        scale = d ** -0.5
        o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, off)
        o_ref, lse_ref = fa.flash_forward_reference(q, k, v, scale, causal,
                                                    off)
        got = fa.flash_bwd_cuda(q, k, v, o_ref, lse_ref, do, scale, causal,
                                off)
        want = fa.flash_backward_reference(q, k, v, o_ref, lse_ref, do,
                                           scale, causal, off)
        torch.cuda.synchronize()
        outs = {"fwd": [(o, o_ref)], "dq": [(got[0], want[0])],
                "dkv": [(got[1], want[1]), (got[2], want[2])]}
        lse_err = float((lse - lse_ref).abs().max())
        work = flash_work(b, tq, tk, h, d, causal, off, 2)
        for name, pairs in outs.items():
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in pairs)
            row_err = max(fa.max_row_rel_err(a, r) for a, r in pairs)
            finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
            emit("kernels", kernel=f"flash_{name}", case=case,
                 shape=[b, tq, tk, h, d], causal=causal, causal_offset=off,
                 max_abs_err=err, max_row_rel_err=row_err, rtol=rtol,
                 why=("per row, relative to the row's largest |plain|: bf16 "
                      "rounding of p/ds and of the outputs"),
                 lse_max_abs_err=lse_err if name == "fwd" else None,
                 lse_tol=1e-4 if name == "fwd" else None, finite=finite)
            if (not finite or row_err > rtol
                    or (name == "fwd" and lse_err > 1e-4)):
                raise AssertionError(
                    f"flash {name} {case}: row-relative err {row_err} > "
                    f"{rtol} (lse err {lse_err})")
        if case != "train_main":
            continue
        # dq and dk/dv are timed one launch each through the C entry
        # points (the wrapper launches both); the plain version computes
        # all three gradients at once, so both rows show its time. The dq
        # kernel writes delta, which dk/dv reads: held here against the
        # plain delta (f32 sums of bf16 products in another order)
        delta = torch.empty((b, h, tq), dtype=torch.float32, device="cuda")
        dqb, dkb, dvb = (torch.empty_like(t) for t in (q, k, v))
        geo = (b, h, tq, tk, d, 1, 0, float(scale), 1,
               torch.cuda.current_stream().cuda_stream)
        lib_c = fa._library()
        oc, lc = o_ref.contiguous(), lse_ref.contiguous()  # as the wrapper
        dq_in = (q.data_ptr(), k.data_ptr(), v.data_ptr(), oc.data_ptr(),
                 do.data_ptr(), lc.data_ptr(), delta.data_ptr())
        dkv_in = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lc.data_ptr(), delta.data_ptr())
        launched(lib_c.bigdl_flash_dq(*dq_in, dqb.data_ptr(), *geo))
        torch.cuda.synchronize()
        delta_ref = fa._delta(o_ref, do)
        delta_err = float((delta - delta_ref).abs().max())
        delta_tol = 1e-5 * float(delta_ref.abs().max())
        emit("kernels", kernel="flash_dq delta", case=case,
             max_abs_err=delta_err, tol=delta_tol,
             why="1e-5 of the largest |delta|: f32 sums of bf16 products "
                 "taken in another order")
        if not delta_err <= delta_tol:
            raise AssertionError(f"flash dq delta {case}: err {delta_err} > "
                                 f"{delta_tol}")

        def plain_bwd():
            fa.flash_backward_reference(q, k, v, o_ref, lse_ref, do, scale,
                                        True)

        runs = {
            "fwd": (lambda: fa.flash_fwd_cuda(q, k, v, scale, True),
                    lambda: fa.flash_forward_reference(q, k, v, scale, True)),
            "dq": (lambda: launched(lib_c.bigdl_flash_dq(
                *dq_in, dqb.data_ptr(), *geo)), plain_bwd),
            "dkv": (lambda: launched(lib_c.bigdl_flash_dkv(
                *dkv_in, dkb.data_ptr(), dvb.data_ptr(), *geo)), plain_bwd)}
        # the library yardstick: SDPA forward and backward over the same
        # bf16 inputs in its (B, H, T, D) layout, prepared outside timing
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dos = do.transpose(1, 2).contiguous()
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), flush=flush)
        lo = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lo, (qs, ks, vs), dos, retain_graph=True), flush=flush)
        lib = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
        # the backward as a whole (dq with its delta, and dk/dv, through
        # the wrapper) against SDPA's backward, which computes dq, dk and
        # dv together
        bwd_ms = time_ms(lambda: fa.flash_bwd_cuda(
            q, k, v, o_ref, lse_ref, do, scale, True), flush=flush)
        bwd_flops = work["dq"][0] + work["dkv"][0]
        emit("kernels", kernel="flash_bwd (delta + dq + dk/dv)", case=case,
             ms=bwd_ms, library_ms=lib_bwd,
             library="F.scaled_dot_product_attention backward",
             flops=bwd_flops, tflops_per_s=bwd_flops / bwd_ms / 1e9,
             vs_library=bwd_ms / lib_bwd)
        for name, (kern, plain) in runs.items():
            ms = time_ms(kern, flush=flush)
            plain_ms = time_ms(plain, reps=5, flush=flush)
            flops, n_bytes = work[name]
            bound_ms, bound_by = bound(flops, n_bytes, BF16_FLOPS)
            emit("kernels", kernel=f"flash_{name}", case=case, ms=ms,
                 plain_ms=plain_ms, library_ms=lib[name],
                 library=("F.scaled_dot_product_attention forward"
                          if name == "fwd" else
                          "F.scaled_dot_product_attention backward "
                          "(dq, dk and dv together)"),
                 bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                 bytes=n_bytes, tflops_per_s=flops / ms / 1e9,
                 roofline_share=bound_ms / ms)
            entries[name] = {
                "name": f"flash_attention_{name}", "route": "cuda",
                "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
                "replaces": FLASH_REPLACES[name], "launches": None,
                "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib[name]}
        for name, pairs in outs.items():
            entries[name]["max_abs_err"] = max(
                float((a.float() - r.float()).abs().max()) for a, r in pairs)
            entries[name]["max_row_rel_err"] = max(
                fa.max_row_rel_err(a, r) for a, r in pairs)
    return entries


def launched(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")


FLASH_REPLACES = {"fwd": "bigdl_tpu/ops/flash_attention.py:52",
                  "dq": "bigdl_tpu/ops/flash_attention.py:149",
                  "dkv": "bigdl_tpu/ops/flash_attention.py:213"}


# (case, M, C, K, dtype, residual, want_y and extra dy): the stage-1 block
# join (batch 256 at 56x56), the stage-4 bn2 -> conv3 edge (batch 256 at
# 7x7), and an f32 case with ragged M and C, K that are not tile multiples
FUSED_CASES = [("stage1_join", 256 * 56 * 56, 256, 64, "bf16", True, True),
               ("stage4_bn2", 256 * 7 * 7, 512, 2048, "bf16", False, False),
               ("f32_ragged", 3001, 100, 72, "f32", True, True)]
FUSED_REPLACES = {"fwd": "bigdl_tpu/ops/fused_conv.py:141",
                  "dgrad": "bigdl_tpu/ops/fused_conv.py:281",
                  "wgrad": "bigdl_tpu/ops/fused_conv.py:405"}


def fused_inputs(m, c, k, dtype, seed):
    """Seeded rows on the card: pre-BN x with its batch statistics folded
    into scale/shift, a residual, W, dz and an extra dy."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*s, scale=1.0):
        return torch.randn(*s, device="cuda", generator=g) * scale

    x = rand(m, c, scale=2.0) + 0.5
    mean, var = x.mean(0), x.var(0, correction=0)
    inv_std = torch.rsqrt(var + 1e-5)
    scale = (rand(c, scale=0.5) + 1.0) * inv_std
    shift = rand(c, scale=0.3) - mean * scale
    return dict(x=x.to(dtype), r=rand(m, c).to(dtype),
                w=(rand(c, k) / c ** 0.5).to(dtype), dz=rand(m, k).to(dtype),
                dy=rand(m, c).to(dtype), scale=scale, shift=shift, mean=mean,
                inv_std=inv_std)


def fused_work(m, c, k, es, res, extra):
    """(FLOPs, bytes) per kernel: 2·M·C·K for each product, each operand
    read once and each output written once (f32 vectors included)."""
    act, out = m * c * es, m * k * es
    w, vec = c * k * es, c * 4
    r = act if res else 0
    flops = 2.0 * m * c * k
    return {"fwd": (flops, act + r + w + out + (act if extra else 0)
                    + 2 * vec + 2 * k * 4),
            "dgrad": (flops, out + w + act + r + (act if extra else 0)
                      + act + 4 * vec + 2 * c * 4),
            "wgrad": (flops, act + r + out + w + 2 * vec)}


def unfused_sequences(d, dtype, res, extra):
    """The unfused PyTorch sequences of the forward, dgrad and wgrad in
    the data dtype, on the rows ``d`` of :func:`fused_inputs` (with the
    residual if ``res``, with the extra dy if ``extra``)."""
    import torch

    sc, sh = d["scale"].to(dtype), d["shift"].to(dtype)
    r = d["r"] if res else 0
    g = d["dy"] if extra else 0

    def fwd():
        yy = torch.relu(d["x"] * sc + sh + r)
        z = (yy @ d["w"]).float()
        return z.sum(0), (z * z).sum(0)

    def dgrad():
        dy = d["dz"] @ d["w"].t() + g
        p = d["x"] * sc + sh + r
        dp = torch.where(p > 0, dy, 0)
        xhat = (d["x"] - d["mean"].to(dtype)) * d["inv_std"].to(dtype)
        return dp.float().sum(0), (dp * xhat).float().sum(0)

    def wgrad():
        yy = torch.relu(d["x"] * sc + sh + r)
        return yy.t() @ d["dz"]

    return {"fwd": fwd, "dgrad": dgrad, "wgrad": wgrad}


def fused_conv_phase():
    """The forward, dgrad and wgrad kernels against their plain versions at
    the main path's shapes and a ragged f32 case, each timed beside its
    plain version, bare product and unfused sequence; returns their
    summary entries (times at the stage-1 join)."""
    import torch

    from bigdl_tpu_torch.ops import fused_conv as fc

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entries = {}
    for i, (case, m, c, k, dt, res, extra) in enumerate(FUSED_CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        d = fused_inputs(m, c, k, dtype, seed=200 + i)
        r = d["r"] if res else None
        g = d["dy"] if extra else None
        calls = {
            "fwd": (lambda: fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"],
                                              d["w"], r, extra),
                    lambda: fc.fused_fwd_reference(d["x"], d["scale"],
                                                   d["shift"], d["w"], r,
                                                   extra)),
            "dgrad": (lambda: fc.fused_dgrad_cuda(
                d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
                d["inv_std"], r, g),
                lambda: fc.fused_dgrad_reference(
                d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
                d["inv_std"], r, g)),
            "wgrad": (lambda: fc.fused_wgrad_cuda(d["x"], d["scale"],
                                                  d["shift"], d["dz"], r,
                                                  out_dtype=dtype),
                      lambda: fc.fused_wgrad_reference(d["x"], d["scale"],
                                                       d["shift"], d["dz"], r,
                                                       out_dtype=dtype))}
        # the bare cuBLAS product of each kernel (the library yardstick) and
        # the unfused PyTorch sequence in the data dtype, both on the same
        # inputs; y is made outside the timing
        y = torch.relu(d["x"] * d["scale"].to(dtype) + d["shift"].to(dtype)
                       + (r if res else 0))
        lib = {"fwd": (lambda: y @ d["w"], "torch.matmul y @ W (cuBLAS)"),
               "dgrad": (lambda: d["dz"] @ d["w"].t(),
                         "torch.matmul dz @ W^T (cuBLAS)"),
               "wgrad": (lambda: y.t() @ d["dz"],
                         "torch.matmul y^T @ dz (cuBLAS)")}
        unfused = unfused_sequences(d, dtype, res, extra)
        rtol = fc.ROW_RTOL[dtype]
        work = fused_work(m, c, k, 2 if dt == "bf16" else 4, res, extra)
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            # outputs held row by row; the f32 channel sums (zstats, q) by
            # their rows too, at 1e-4
            errs, sums = [], []
            for j, (a, b) in enumerate(zip(got, want)):
                is_sum = name != "wgrad" and j == 1
                (sums if is_sum else errs).append(fc.max_row_rel_err(a, b))
            abs_err = max(float((a.float() - b.float()).abs().max())
                          for j, (a, b) in enumerate(zip(got, want))
                          if name == "wgrad" or j != 1)
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            row_err, sum_err = max(errs), max(sums, default=0.0)
            emit("fused_conv", kernel=f"fused_{name}", case=case,
                 shape=[m, c, k], dtype=dt, residual=res, want_y_extra=extra,
                 max_abs_err=abs_err, max_row_rel_err=row_err, rtol=rtol,
                 max_sum_rel_err=sum_err, sum_rtol=1e-4, finite=finite,
                 why=("per row, relative to the row's largest |plain|: one "
                      "rounding of bf16 outputs whose f32 sums run in "
                      "another order; f32: the order alone"))
            if not finite or row_err > rtol or sum_err > 1e-4:
                raise AssertionError(
                    f"fused {name} {case}: row err {row_err} > {rtol} or "
                    f"sum err {sum_err} > 1e-4")
            del got, want
            ms = time_ms(kern, flush=flush)
            plain_ms = time_ms(plain, reps=5, flush=flush)
            library_ms = time_ms(lib[name][0], flush=flush)
            unfused_ms = time_ms(unfused[name], flush=flush)
            flops, n_bytes = work[name]
            bound_ms, bound_by = bound(
                flops, n_bytes, BF16_FLOPS if dt == "bf16" else F32_FLOPS)
            emit("fused_conv", kernel=f"fused_{name}", case=case, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 library=lib[name][1], unfused_torch_ms=unfused_ms,
                 bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                 bytes=n_bytes, roofline_share=bound_ms / ms)
            if case == "stage1_join":
                entries[name] = {
                    "name": f"fused_conv_{name}", "route": "cuda",
                    "source": "bigdl_tpu_torch/csrc/fused_conv.cu",
                    "replaces": FUSED_REPLACES[name], "launches": None,
                    "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms,
                    "max_row_rel_err": row_err}
        del d, y
        torch.cuda.empty_cache()
    return entries


# ResNet-50's fused edges at batch 256 (shortcut B, maybe_fuse with
# BIGDL_PALLAS_MIN_C=128; counted on the CPU at batch 1 through the port's
# plain versions): (M, C, K, residual with want_y and extra dy, launches per
# step). Each edge launches the forward, the dgrad and the wgrad once per
# step, so each kernel runs 28 times over these 10 (M, C, K).
RESNET50_EDGES = [(802816, 256, 64, True, 2), (802816, 256, 128, True, 1),
                  (200704, 128, 512, False, 4), (200704, 512, 128, True, 3),
                  (200704, 512, 256, True, 1), (50176, 256, 1024, False, 6),
                  (50176, 1024, 256, True, 5), (50176, 1024, 512, True, 1),
                  (12544, 512, 2048, False, 3), (12544, 2048, 512, True, 2)]


def fused_shapes_phase():
    """The three fused-conv kernels at every (M, C, K) of ResNet-50's step
    (bf16, batch 256): the dgrad held to its plain version at each (the
    forward and wgrad are held at FUSED_CASES), each kernel's median time
    beside its bound, the bare cuBLAS product and the unfused PyTorch
    sequence; then per kernel the sum over the step of launches x (time -
    bound), the time a kernel at its bound would save per step."""
    import torch

    from bigdl_tpu_torch.ops import fused_conv as fc

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dtype = torch.bfloat16
    lost = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0}
    kernel_ms = dict.fromkeys(lost, 0.0)
    rtol = fc.ROW_RTOL[dtype]
    for i, (m, c, k, res, n) in enumerate(RESNET50_EDGES):
        d = fused_inputs(m, c, k, dtype, seed=400 + i)
        r = d["r"] if res else None
        g = d["dy"] if res else None
        sc, sh = d["scale"].to(dtype), d["shift"].to(dtype)
        dp, q = fc.fused_dgrad_cuda(d["dz"], d["w"], d["x"], d["scale"],
                                    d["shift"], d["mean"], d["inv_std"], r, g)
        dp_ref, q_ref = fc.fused_dgrad_reference(
            d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
            d["inv_std"], r, g)
        torch.cuda.synchronize()
        row_err = fc.max_row_rel_err(dp, dp_ref)
        sum_err = fc.max_row_rel_err(q, q_ref)
        finite = bool(torch.isfinite(dp).all())
        del dp, q, dp_ref, q_ref
        if not finite or row_err > rtol or sum_err > 1e-4:
            raise AssertionError(f"fused dgrad at {(m, c, k)}: row err "
                                 f"{row_err} > {rtol} or sum err {sum_err}")
        y = torch.relu(d["x"] * sc + sh + (r if res else 0))
        unfused = unfused_sequences(d, dtype, res, res)
        runs = {
            "fwd": (lambda: fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"],
                                              d["w"], r, res),
                    lambda: y @ d["w"], unfused["fwd"]),
            "dgrad": (lambda: fc.fused_dgrad_cuda(
                d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
                d["inv_std"], r, g), lambda: d["dz"] @ d["w"].t(),
                unfused["dgrad"]),
            "wgrad": (lambda: fc.fused_wgrad_cuda(d["x"], d["scale"],
                                                  d["shift"], d["dz"], r,
                                                  out_dtype=dtype),
                      lambda: y.t() @ d["dz"], unfused["wgrad"])}
        work = fused_work(m, c, k, 2, res, res)
        for name, (kern, lib, unf) in runs.items():
            t = time_stats(kern, flush=flush)
            lib_ms = time_stats(lib, flush=flush)["median"]
            unf_ms = time_stats(unf, flush=flush)["median"]
            bound_ms, bound_by = bound(*work[name], BF16_FLOPS)
            lost[name] += n * (t["median"] - bound_ms)
            kernel_ms[name] += n * t["median"]
            emit("fused_shapes", kernel=f"fused_{name}", shape=[m, c, k],
                 residual=res, launches_per_step=n, ms_median=t["median"],
                 ms_min_max=[t["min"], t["max"]],
                 host_ms_max=t["host_ms_max"], bound_ms=bound_ms,
                 bound_by=bound_by, roofline_share=bound_ms / t["median"],
                 cublas_ms=lib_ms, unfused_torch_ms=unf_ms,
                 dgrad_max_row_rel_err=row_err if name == "dgrad" else None,
                 dgrad_max_sum_rel_err=sum_err if name == "dgrad" else None)
        del d, y
        torch.cuda.empty_cache()
    emit("fused_shapes", what="per ResNet-50 step (28 launches each)",
         kernel_ms_per_step=kernel_ms,
         launches_x_time_minus_bound_ms=lost)
    return lost


# (case, N, H, W, C, K, dtype): ResNet-50's four 3x3 conv shapes at batch
# 256 (the experiment's SHAPES, benchmarks/pallas_conv3x3_experiment.py:112-
# 117, C = K, bf16), a ragged f32 case and a one-pixel f32 case
CONV3X3_CASES = [("s1 56² 64", 256, 56, 56, 64, 64, "bf16"),
                 ("s2 28² 128", 256, 28, 28, 128, 128, "bf16"),
                 ("s3 14² 256", 256, 14, 14, 256, 256, "bf16"),
                 ("s4 7² 512", 256, 7, 7, 512, 512, "bf16"),
                 ("f32_ragged", 3, 13, 11, 40, 72, "f32"),
                 ("f32_tiny", 1, 1, 1, 3, 5, "f32")]
# the first two images against F.conv2d in f32 with TF32 off (the
# experiment's check, :141-148): a bf16 output is one bf16 rounding from the
# f32 result; an f32 output differs by sum order and by the algorithm cuDNN
# picks (a Winograd or FFT transform rounds in other places)
CONV3X3_LIB_RTOL = {"bf16": 1e-2, "f32": 1e-4}
CONV3X3_TIMED_CALLS = 3 + 30      # time_ms: 3 warm-up calls + 30 timed


def conv3x3_phase():
    """The twin of the experiment's ``main()``: can the hand-written 3x3
    conv keep up with the library conv at ResNet-50's four 3x3 shapes?
    Each case is held to the plain version row by row and to F.conv2d;
    the ResNet shapes are then timed: the kernel through its C entry
    point, the wrapper (one launch on x as it lies), the plain version and
    cuDNN
    (F.conv2d on the channels-last bf16 tensor with the OIHW weight). The
    launch count over the phase is asserted; returns the kernel's summary
    entry (times at s1 56²)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import conv3x3 as cv

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lib_c = cv._library()
    stream = torch.cuda.current_stream().cuda_stream
    cv.launches = 0
    expected = 0
    entry = None
    for i, (case, n, h, w, c, k, dt) in enumerate(CONV3X3_CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn(n, h, w, c, device="cuda", generator=g).to(dtype)
        w9 = (torch.randn(9, c, k, device="cuda", generator=g) * 0.05
              ).to(dtype)
        got = cv.conv3x3(x, w9)
        expected += 1
        want = cv.conv3x3_reference(x, w9)
        lib_ref = F.conv2d(x[:2].float().permute(0, 3, 1, 2),
                           cv.oihw_from_w9(w9).float(), padding=1
                           ).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        rtol, lib_rtol = cv.ROW_RTOL[dtype], CONV3X3_LIB_RTOL[dt]
        row_err = cv.max_row_rel_err(got, want)
        lib_err = cv.max_row_rel_err(got[:2], lib_ref)
        abs_err = float((got.float() - want.float()).abs().max())
        finite = bool(torch.isfinite(got).all())
        emit("conv3x3", case=case, shape=[n, h, w, c, k], dtype=dt,
             max_abs_err=abs_err, max_row_rel_err=row_err, rtol=rtol,
             conv2d_f32_row_rel_err=lib_err, conv2d_rtol=lib_rtol,
             finite=finite,
             why=("per output pixel, relative to its largest |plain|: bf16 "
                  "outputs round once from f32 sums taken in another order; "
                  "f32: the order alone"))
        if not finite or row_err > rtol or lib_err > lib_rtol:
            raise AssertionError(
                f"conv3x3 {case}: row err {row_err} > {rtol} or conv2d err "
                f"{lib_err} > {lib_rtol}")
        del got, want, lib_ref
        if dt != "bf16":
            continue
        out = torch.empty(n, h, w, k, dtype=dtype, device="cuda")
        ms = time_ms(lambda: launched(lib_c.bigdl_conv3x3(
            x.data_ptr(), w9.data_ptr(), out.data_ptr(), n, h, w, c, k, 1,
            stream)), flush=flush)
        entry_ms = time_ms(lambda: cv.conv3x3(x, w9), flush=flush)
        expected += CONV3X3_TIMED_CALLS
        plain_ms = time_ms(lambda: cv.conv3x3_reference(x, w9), reps=5,
                           flush=flush)
        # the library: one cuDNN call on the same bf16 values, x as its
        # channels-last NCHW view, the OIHW weight channels-last too
        xl = x.permute(0, 3, 1, 2)
        wl = cv.oihw_from_w9(w9).contiguous(memory_format=torch.channels_last)
        library_ms = time_ms(lambda: F.conv2d(xl, wl, padding=1),
                             flush=flush)
        lib_out = F.conv2d(xl, wl, padding=1).permute(0, 2, 3, 1)
        lib_vs_plain = cv.max_row_rel_err(lib_out, cv.conv3x3_reference(x, w9))
        del out, lib_out
        flops = 2.0 * n * h * w * c * k * 9
        n_bytes = (x.numel() + w9.numel() + n * h * w * k) * 2
        bound_ms, bound_by = bound(flops, n_bytes, BF16_FLOPS)
        emit("conv3x3", case=case, ms=ms, entry_ms=entry_ms,
             plain_ms=plain_ms, library_ms=library_ms,
             library="F.conv2d (cuDNN), channels-last bf16, OIHW weight",
             library_row_rel_err_vs_plain=lib_vs_plain,
             ratio_library_over_kernel=library_ms / ms,
             ratio_library_over_entry=library_ms / entry_ms,
             tflops_per_s=flops / ms / 1e9,
             library_tflops_per_s=flops / library_ms / 1e9, flops=flops,
             bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
             roofline_share=bound_ms / ms)
        if entry is None:
            entry = {"name": "conv3x3", "route": "cuda",
                     "source": "bigdl_tpu_torch/csrc/conv3x3.cu",
                     "replaces": "benchmarks/pallas_conv3x3_experiment.py:49",
                     "launches": None, "max_abs_err": abs_err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "entry_ms": entry_ms, "max_row_rel_err": row_err,
                     "path": ("chip_smoke.py conv3x3 phase, the twin of the "
                              "experiment's main() (on no package path): "
                              "one checked call per case, 33 timed entry "
                              "calls per ResNet-50 shape; ms is the kernel "
                              "through its C entry point, entry_ms one "
                              "launch through the wrapper, both at s1 "
                              "56² 64")}
        del x, w9, xl, wl
        torch.cuda.empty_cache()
    if cv.launches != expected:
        raise AssertionError(f"conv3x3 launched {cv.launches} times, "
                             f"expected {expected}")
    entry["launches"] = cv.launches
    return entry


def tiny_bottleneck(device, planes=8, seed=0):
    """A twin of tests/test_tpu_fusion.py::tiny_bottleneck: a conv-BN-ReLU
    stem, two bottleneck blocks (the second strided, projection
    shortcuts), global average pooling and a Linear head."""
    import torch

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.models.resnet import _Builder

    b = _Builder(device, torch.Generator(device=device).manual_seed(seed))
    inp = tnn.Input()
    x = b.conv(3, 2 * planes, 3, 1, 1).inputs(inp)
    x = tnn.ReLU(True).inputs(b.bn(2 * planes).inputs(x))
    n_in = 2 * planes
    x, n_in = b.residual(x, n_in, planes, 1, b.bottleneck_block, "B", True)
    x, n_in = b.residual(x, n_in, 2 * planes, 2, b.bottleneck_block, "B",
                         True)
    x = tnn.SpatialAveragePooling(4, 4, 1, 1).inputs(x)
    x = tnn.Reshape([n_in], batch_mode=True).inputs(x)
    return tnn.Graph(inp, b.linear(n_in, 10).inputs(x))


def resnet_check_phase():
    """The fused bottleneck graph's three f32 SGD train steps (momentum
    0.9, weight decay 1e-4) on the card, every edge on the kernels
    (threshold 8), against the same steps on the CPU (plain versions).
    Tolerances: losses 1e-5 relative; parameters and BN running statistics
    5e-5 absolute (f32 on both sides, sums and cuDNN's convolutions in
    other orders; the CPU parity tests hold the port to JAX at 1e-5 on
    the same recipe)."""
    import os

    import torch

    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph
    from bigdl_tpu_torch.ops import fused_conv as fc
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    saved = os.environ.get("BIGDL_PALLAS_MIN_C")
    os.environ["BIGDL_PALLAS_MIN_C"] = "8"
    rng = np.random.default_rng(7)
    batches = [(rng.standard_normal((4, 3, 8, 8)).astype(np.float32),
                rng.integers(1, 11, size=4).astype(np.int32))
               for _ in range(3)]
    results = []
    fc.fwd_launches = fc.dgrad_launches = fc.wgrad_launches = 0
    try:
        for dev in ("cpu", "cuda"):
            model = FusedGraph(tiny_bottleneck("cpu")).to(dev)
            with torch.no_grad():      # non-zero gammas: every block passes
                for p in model.parameters():
                    if p.dim() == 1:
                        p.add_(0.3)
            sgd = SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
            step = make_train_step(model, CrossEntropyCriterion(), sgd)
            params = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            state = {k: b.detach().clone() for k, b in model.named_buffers()}
            opt = sgd.init_state(params)
            model.train()
            losses = []
            for x, y in batches:
                params, opt, state, loss = step(
                    params, opt, state, None, torch.from_numpy(x).to(dev),
                    torch.from_numpy(y).to(dev))
                losses.append(float(loss))
            results.append((losses, [p.cpu() for p in params.values()],
                            [b.cpu() for b in state.values()]))
    finally:
        if saved is None:
            os.environ.pop("BIGDL_PALLAS_MIN_C")
        else:
            os.environ["BIGDL_PALLAS_MIN_C"] = saved
    (l_cpu, p_cpu, s_cpu), (l_gpu, p_gpu, s_gpu) = results
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
    stat_err = max(float((a - b).abs().max()) for a, b in zip(s_gpu, s_cpu))
    launches = [fc.fwd_launches, fc.dgrad_launches, fc.wgrad_launches]
    emit("resnet_check", what="3 f32 SGD steps, fused bottleneck graph "
         "(4 kernel edges), card vs CPU", losses_cpu=l_cpu, losses_card=l_gpu,
         loss_rel_err=loss_err, param_max_abs_err=param_err,
         bn_stat_max_abs_err=stat_err, tol_loss=1e-5, tol_param=5e-5,
         tol_stat=5e-5, card_fused_launches=launches)
    if not (loss_err <= 1e-5 and param_err <= 5e-5 and stat_err <= 5e-5):
        raise AssertionError(f"card vs CPU resnet steps: loss {loss_err}, "
                             f"params {param_err}, stats {stat_err}")
    if launches != [12, 12, 12]:           # 4 edges x 3 steps, card only
        raise AssertionError(f"fused launches {launches}, expected 12 each")


def resnet_run(fuse: bool, warm: int, timed: int, batch: int = 256):
    """ResNet-50 trained through ``optimize()`` on one seeded batch (bf16
    compute, SGD 0.1 / momentum 0.9 / weight decay 1e-4, the recipe of
    bench.py:33-67); returns (losses, step seconds, peak GiB, wall s)."""
    import torch

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import maybe_fuse
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    model = ResNet(1000, {"depth": 50, "shortcutType": "B"}, seed=0)
    if fuse:
        model = maybe_fuse(model)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, 3, 224, 224), dtype=np.float32)
    y = rng.integers(1, 1001, size=batch).astype(np.int32)
    samples = [Sample(x[i], y[i]) for i in range(batch)]
    steps = warm + timed
    losses = []

    def record_then_stop(state):       # the trigger reads every step's loss
        if state["loss"] is not None:
            losses.append(state["loss"])
        return state["neval"] > steps

    opt = Optimizer(model, samples, CrossEntropyCriterion(), batch_size=batch,
                    end_trigger=Trigger(record_then_stop,
                                        Trigger.max_iteration(steps).peek))
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                             weight_decay=1e-4)).set_compute_dtype("bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_s = opt.metrics.values("computing time")[warm:]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del opt, model, samples
    torch.cuda.empty_cache()
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"resnet losses {losses}")
    return losses, step_s, peak, wall


def resnet_train_phase(warm: int = 2, timed: int = 5, batch: int = 256):
    """The ResNet-50 training path at full size, fused with
    BIGDL_PALLAS_MIN_C=128; returns the fused kernels' launch counts over
    its ``optimize()`` run. The unfused Graph runs the same recipe after
    it, for comparison."""
    import os

    from bigdl_tpu_torch.ops import fused_conv as fc

    saved = os.environ.get("BIGDL_PALLAS_MIN_C")
    os.environ["BIGDL_PALLAS_MIN_C"] = "128"
    try:
        fc.fwd_launches = fc.dgrad_launches = fc.wgrad_launches = 0
        losses, step_s, peak, wall = resnet_run(True, warm, timed, batch)
        launches = {"fwd": fc.fwd_launches, "dgrad": fc.dgrad_launches,
                    "wgrad": fc.wgrad_launches}
    finally:
        if saved is None:
            os.environ.pop("BIGDL_PALLAS_MIN_C")
        else:
            os.environ["BIGDL_PALLAS_MIN_C"] = saved
    steps = warm + timed
    for name, n in launches.items():
        if n != 28 * steps:
            raise AssertionError(f"fused {name} launched {n} times, expected "
                                 f"28 edges x {steps} steps")
    p50 = float(np.median(step_s))
    u_losses, u_step_s, u_peak, _ = resnet_run(False, warm, timed, batch)
    u_p50 = float(np.median(u_step_s))
    emit("resnet_train", model="ResNet-50", batch=batch, image=224,
         compute="bf16", optim="SGD(0.1, momentum 0.9, weight decay 1e-4)",
         fused="maybe_fuse, BIGDL_PALLAS_MIN_C=128", steps=steps,
         timed_steps=timed, step_ms=[s * 1e3 for s in step_s], wall_s=wall,
         fused_launches=launches, peak_mem_gib=peak, losses=losses,
         loss_fell=bool(losses[-1] < losses[0]),
         unfused_step_ms=[s * 1e3 for s in u_step_s],
         unfused_peak_mem_gib=u_peak, unfused_losses=u_losses)
    print(json.dumps({"resnet50_step_ms_p50": p50 * 1e3,
                      "images_per_s": batch / p50, "peak_mem_gib": peak,
                      "first_loss": losses[0], "last_loss": losses[-1],
                      "unfused_step_ms_p50": u_p50 * 1e3,
                      "unfused_images_per_s": batch / u_p50,
                      "unfused_peak_mem_gib": u_peak}))
    return launches


def kv_merge_phase():
    """Per-layer cost, at the pool's shape, of the decode step's int8 grow
    check (host read of the flag, no growth) vs the unconditional merge."""
    import torch

    from bigdl_tpu_torch.models import transformer as tm

    n, L, h, d = 16, 512, 12, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    kc = torch.randint(-127, 128, (n, L, h, d), device="cuda", generator=g,
                       dtype=torch.int8)
    vc = kc.clone()
    s = torch.rand(n, h, device="cuda", generator=g) + 0.5
    amax = torch.rand(n, h, device="cuda", generator=g)   # no row grows
    reps = 50
    tm._kv_quant_merge_step(kc, vc, s, s, amax, amax)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tm._kv_quant_merge_step(kc, vc, s, s, amax, amax)
    host_read_ms = (time.perf_counter() - t0) / reps * 1e3

    def unconditional():
        tm._kv_quant_merge(kc, s, amax)
        tm._kv_quant_merge(vc, s, amax)

    merge_ms = time_ms(unconditional)
    emit("kv_merge", shape=[n, L, h, d], host_read_ms_per_layer=host_read_ms,
         unconditional_ms_per_layer=merge_ms, layers=12,
         host_read_ms_per_step=12 * host_read_ms,
         unconditional_ms_per_step=12 * merge_ms)


def check_phase():
    """A small model's int8-KV decode on the card vs on the CPU (same
    weights, same prefill, same fed tokens, f32): log-probs within 2e-3
    (f32 math on both; an int8 value on a rounding boundary may land one
    quantum apart, 0.4% of its row's range)."""
    import torch

    from bigdl_tpu_torch.models import transformer as tm

    lm_cpu = tm.TransformerLM(97, hidden_size=128, n_heads=4, n_layers=2,
                              max_len=64, device="cpu", seed=3)
    lm_gpu = tm.TransformerLM(97, hidden_size=128, n_heads=4, n_layers=2,
                              max_len=64, device="cpu", seed=3).to("cuda")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 97, size=(4, 16))
    lengths = np.asarray([16, 5, 0, 11])
    feeds = rng.integers(0, 97, size=(6, 4))
    active = torch.tensor([True, True, False, True])
    outs = []
    for lm, dev in ((lm_cpu, "cpu"), (lm_gpu, "cuda")):
        prefill = tm.make_batch_prefill_step(lm, kv_quant=True)
        step, init = tm.make_batch_decode_step(lm, kv_quant=True)
        P = tm.serving_params(lm)
        with torch.no_grad():
            _, carry = prefill(P, torch.from_numpy(toks).to(dev), lengths,
                               init(4))
            logps = []
            for f in feeds:
                lp, carry = step(P, torch.from_numpy(f).to(dev),
                                 active.to(dev), carry)
                logps.append(lp.cpu().numpy())
        outs.append(np.stack(logps))
    err = float(np.abs(outs[0] - outs[1])[:, active.numpy()].max())
    emit("check", what="int8-KV decode step, card vs CPU, small model",
         steps=len(feeds), max_abs_logp_err=err, tol=2e-3)
    if not err <= 2e-3:
        raise AssertionError(f"card vs CPU decode: max abs err {err}")


def train_check_phase():
    """A small LM's three f32 train steps on the card vs on the CPU, with
    the flash path forced (``use_flash="always"``: the f32 kernels on the
    card, the plain version on the CPU) and SGD, whose update is linear
    in the gradients, so the parameters show any gradient difference.
    Tolerances: losses 1e-5 relative, parameters 1e-5 absolute (f32 on
    both sides, sums in other orders; 3 steps of lr 0.1)."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim.optim_method import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    V, T, B = 29, 16, 4
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        x = rng.integers(1, V + 1, size=(B, T)).astype(np.int32)
        y = rng.integers(1, V + 1, size=(B, T)).astype(np.float32)
        y[:, -3:] = 0.0
        batches.append((x, y))
    results = []
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    for dev in ("cpu", "cuda"):
        lm = TransformerLM(V, hidden_size=32, n_heads=4, n_layers=2,
                           max_len=T, output="logits", use_flash="always",
                           device="cpu", seed=9).to(dev)
        opt = SGD(learning_rate=0.1, momentum=0.9)
        step = make_train_step(lm, MaskedSoftmaxCECriterion(0), opt)
        params = {k: p.detach().clone() for k, p in lm.named_parameters()}
        state = opt.init_state(params)
        losses = []
        for x, y in batches:
            params, state, _, loss = step(
                params, state, {}, None, torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))
            losses.append(float(loss))
        # the two builds' parameter names differ in their instance
        # counters; the order is the same
        results.append((losses, [p.cpu() for p in params.values()]))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_err = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
    launches = [fa.fwd_launches, fa.dq_launches, fa.dkv_launches]
    emit("train_check", what="3 f32 train steps, small LM, card vs CPU",
         losses_cpu=l_cpu, losses_card=l_gpu, loss_rel_err=loss_err,
         param_max_abs_err=param_err, tol_loss=1e-5, tol_param=1e-5,
         card_flash_launches=launches)
    if not (loss_err <= 1e-5 and param_err <= 1e-5):
        raise AssertionError(f"card vs CPU train steps: loss {loss_err}, "
                             f"params {param_err}")
    if launches != [6, 6, 6]:              # 2 layers x 3 steps, card only
        raise AssertionError(f"flash launches {launches}, expected 6 each")


def train_phase(warm: int = 2, timed: int = 5):
    """The training path at full width; returns the flash kernels'
    launch counts over the ``optimize()`` run."""
    import torch

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger

    V, hidden, layers, heads, T, B = 32768, 768, 12, 12, 2048, 8
    lm = TransformerLM(V, hidden_size=hidden, n_heads=heads, n_layers=layers,
                       max_len=T, output="logits", seed=0)
    n_params = sum(p.numel() for p in lm.parameters())
    rng = np.random.default_rng(0)
    x = rng.integers(1, V + 1, size=(B, T)).astype(np.int32)
    y = rng.integers(1, V + 1, size=(B, T)).astype(np.float32)
    samples = [Sample(x[i], y[i]) for i in range(B)]
    steps = warm + timed
    losses = []

    def record_then_stop(state):       # the trigger reads every step's loss
        if state["loss"] is not None:
            losses.append(state["loss"])
        return state["neval"] > steps

    opt = Optimizer(lm, samples, MaskedSoftmaxCECriterion(0), batch_size=B,
                    end_trigger=Trigger(record_then_stop,
                                        Trigger.max_iteration(steps).peek))
    opt.set_optim_method(Adam(learning_rate=1e-4)).set_compute_dtype("bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches}
    step_s = opt.metrics.values("computing time")[warm:]
    p50 = float(np.median(step_s))
    tokens_per_s = B * T / p50
    fpt = lm_flops_per_token(V, hidden, layers, T)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"one batch repeated {steps} times did not "
                             f"lower the loss: {losses}")
    for name, n in launches.items():
        if n != layers * steps:
            raise AssertionError(
                f"flash {name} launched {n} times, expected {steps} steps "
                f"x {layers} layers")
    emit("train", model="137m", params=n_params, vocab=V, hidden=hidden,
         layers=layers, heads=heads, T=T, batch=B, compute="bf16",
         optim="Adam(1e-4)", steps=steps, timed_steps=timed,
         step_ms=[s * 1e3 for s in step_s], wall_s=wall,
         flash_launches=launches, peak_mem_gib=peak_gib, losses=losses)
    print(json.dumps({"train_step_ms_p50": p50 * 1e3,
                      "tokens_per_s": tokens_per_s,
                      "mfu": tokens_per_s * fpt / BF16_FLOPS,
                      "flops_per_token": fpt}))
    return launches


def decode_step_launches(engine, vocab, rng, steps: int = 8) -> float:
    """Device launches (kernels, copies, fills) per decode step, counted by
    ``torch.profiler`` over ``steps`` steps with all 16 slots decoding
    (after one admission step), as ``tools/torch_serving_profile.py``
    counts them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = engine()
    for _ in range(16):
        p = rng.integers(1, vocab + 1, size=int(rng.integers(16, 257)))
        eng.submit(p.tolist(), max_new_tokens=16)
    with torch.no_grad():
        eng.step()                         # admission: the prefills
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
        eng.drain()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / steps


def serve_phase():
    """The main path at the 137m width; returns decode_attention launches."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.serving import SamplingParams, ServingEngine

    V, layers = 32768, 12
    t0 = time.perf_counter()
    lm = TransformerLM(V, hidden_size=768, n_heads=12, n_layers=layers,
                       max_len=512, output="logits", seed=0)
    lm.evaluate()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())

    def engine():
        return ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                             kv_dtype="int8")

    # warm-up: library handles and allocator pools, outside the counts
    warm = engine()
    for p in ([5, 9, 2] * 7, [4] * 40):
        warm.submit(p, max_new_tokens=3)
    with torch.no_grad():
        warm.drain()
    del warm

    rng = np.random.default_rng(0)
    eng = engine()
    reqs = []
    for i in range(24):
        prompt = rng.integers(1, V + 1, size=int(rng.integers(16, 257)))
        sp = (SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i)
              if i % 3 == 2 else None)
        reqs.append((eng.submit(prompt.tolist(), max_new_tokens=32,
                                sampling=sp), sp))
    torch.cuda.synchronize()
    da.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = da.launches
    steps = eng.metrics.decode_step_count
    for rid, _ in reqs:
        out, lps = outs[rid], eng.logprobs(rid)
        if not (len(out) == 32 and out.min() >= 1 and out.max() <= V):
            raise AssertionError(f"request {rid}: bad output {out}")
        if not (np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"request {rid}: bad logprobs {lps}")
        if eng.request(rid).finish_reason != "length":
            raise AssertionError(f"request {rid} did not run to length")
    if launches != steps * layers:
        raise AssertionError(
            f"decode_attention launched {launches} times, expected "
            f"{steps} decode steps x {layers} layers")
    s = eng.summary()
    per_step = decode_step_launches(engine, V, rng)
    emit("serve", model="137m", params=n_params, build_s=build_s,
         requests=len(reqs), new_tokens=32 * len(reqs), wall_s=wall,
         decode_steps=steps, decode_attention_launches=launches,
         decode_step_device_launches=per_step,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps({"tokens_per_s": s["serving/tokens_per_sec"]}))
    print(json.dumps({"ttft_p50_s": s["serving/ttft_p50_s"],
                      "ttft_p99_s": s["serving/ttft_p99_s"]}))
    print(json.dumps({"decode_step_p50_s": s["serving/decode_step_p50_s"],
                      "host_step_p50_s": s["serving/host_step_p50_s"]}))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "the card", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    hgmma = {name: hgmma_per_kernel(name) for name in WGMMA_KERNELS}
    serialized = [line for log in logs.values()
                  for line in serialized_wgmma(log)]
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: ptxas_summary(log) for name, log in logs.items()},
         hgmma=hgmma, wgmma_serialized=serialized)
    for name, counts in hgmma.items():
        for kernel, n in counts.items():
            if n <= 0:
                raise AssertionError(f"no HGMMA instruction in {kernel} of "
                                     f"{name}: wgmma was not emitted")
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    entry = kernels_phase()
    flash = flash_phase()
    kv_merge_phase()
    check_phase()
    train_check_phase()
    entry["launches"] = serve_phase()
    if not entry["launches"]:
        raise AssertionError("decode_attention never launched on the main path")
    for name, n in train_phase().items():
        flash[name]["launches"] = n
    fused = fused_conv_phase()
    fused_shapes_phase()
    resnet_check_phase()
    for name, n in resnet_train_phase().items():
        fused[name]["launches"] = n
    conv = conv3x3_phase()
    emit("timing_guard", guard_ms=guard_ms(),
         host_enqueue_ms_max=HOST_ENQUEUE["max_ms"],
         timed_launches=HOST_ENQUEUE["launches"],
         launches_enqueued_after_the_guard=HOST_ENQUEUE["over_guard"],
         kept_all_the_same=HOST_ENQUEUE["kept_over_guard"])
    print(json.dumps({"kernels": [entry]
                      + [flash[n] for n in ("fwd", "dq", "dkv")]
                      + [fused[n] for n in ("fwd", "dgrad", "wgrad")]
                      + [conv]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
