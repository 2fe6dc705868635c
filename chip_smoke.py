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
              forward, dgrad and wgrad), which must be above zero; a ptxas
              line reporting wgmma serialized in dq, dk/dv or a fused-conv
              kernel fails the build;
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
4. kernels  — (kv_requant) the int8 cache's grow-only requantize kernel
              against its plain version, bitwise, at the decode step's
              shape (16 rows, 512 positions, 12 heads, D 64) with no scale
              grown, every scale grown, and a mix (zero-scale, inactive,
              grown and not-grown rows); its time per case beside the
              plain unconditional requantize, the whole merge step and
              the earlier host-read step, and the bound;
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
              then the device launches, device-to-host copies and host
              waits per decode step (``torch.profiler`` over 8 steps of a
              full pool): one copy and one wait, the step's readback;
8. serve_modes — the admission and scheduling modes of ``ServingEngine`` on
              the same model (bf16, int8 KV, 16 slots), each run held to:
              every request at its length, ids in 1..V, finite log-probs
              <= 0, and decode-attention launches = decode steps x 12:
              ``per_request`` on the serve phase's 24 requests; ``prefix``
              (prefix cache on 24 chat requests, one shared 192-token
              head with 16-64-token tails: every request after the first
              round must hit);
              ``chunked`` (budget 64 on the serve requests: no step may
              spend more, its decode-gap p99 beside the serve phase's);
              ``priority`` (16 priority-0 requests of 64 new tokens fill
              the slots, 8 priority-1 ones arrive after 4 steps: 8
              preemptions, every stash restored bitwise); ``faults``
              (a seeded ``FaultInjector``, up to 8 faults, 8 retries: all
              finish at length, faults and retries happen);
9. serve_async — the serve phase's engine and requests at
              ``dispatch_ahead`` W in 0, 1, 2, 4: every W's token and
              log-prob streams byte-identical to W = 0's; tok/s, decode
              step p50, the share of the wall spent waiting on readbacks,
              host step p50;
10. serve_spec — speculative serving of the same target (k=3) on
              ``serving_bench``'s mixed speculative trace (16 requests, 24
              new tokens; half greedy speculative, a quarter
              ``draft_tokens=0``, a quarter seeded sampled) with a
              weight-tied draft (accept rate above 0, tokens per step
              above 1) and, shorter, an independently seeded 2-layer draft;
              then fp32 greedy rows held to the plain engine's (a row may
              differ only from a near-tie, top-two gap below 1e-3, on);
11. serve_lora — multi-tenant LoRA and constrained decoding on the same
              model (bf16, int8 KV, 16 slots) with ``AdapterBank(rank=16,
              n_slots=4)`` and three tenants (``random_factors`` seeds
              50-52, amp 0.05) on ``serving_bench``'s multitenant trace (24
              requests, 32 new tokens; adapter ids round-robin over 0-3,
              every fourth request forced through a 3-token
              ``fixed_sequence``, odd ones seeded-sampled): a bank-less
              oracle, then base-only (ids and constraints stripped) and
              mixed passes; null-adapter rows bitwise the oracle's, forced
              rows verbatim, adapted rows leave the oracle's stream, one
              decode input layout, references released; tok/s, step p50,
              TTFT p50/p99 and the multitenant overhead; launches, copies
              and waits per decode step for the bank-less, base-only and
              mixed engines;
12. train    — the training path at full width: the same 137m model at
              max_len = T = 2048, ``output="logits"``, trained through
              ``Optimizer(...).optimize()`` with
              ``MaskedSoftmaxCECriterion(0)``, ``Adam(1e-4)``, bf16 compute,
              batch 8, 2 warm + 5 timed steps on one seeded batch: step ms
              p50, tokens/s, MFU, peak memory, first and last loss;
13. fused_conv — the fused BN → ReLU → 1×1-conv forward, dgrad and wgrad
              kernels against their plain versions: the stage-1 block join
              (M 802,816, C 256, K 64, residual, y and extra dy, bf16), the
              stage-4 bn2 edge (M 12,544, C 512, K 2048, bf16) and an f32
              case with ragged M, C and K; per-row errors and channel-sum
              errors against the stated tolerances, kernel, plain, bare
              cuBLAS product and unfused-torch times, and the bound;
14. fused_shapes — the three fused-conv kernels at each of the 10 (M, C,
              K) that ResNet-50's step launches them at (batch 256, bf16):
              each against its plain version, each kernel's median and
              min-max time beside its bound, the cuBLAS product and the
              unfused sequence, and per kernel the step's sum of launches x
              (time - bound);
15. resnet_check — a bottleneck graph's three f32 SGD steps (every edge
              on the kernels) on the card against the CPU: losses,
              parameters and BN running statistics;
16. resnet_train — ResNet-50 at batch 256, 224², bf16 compute, SGD 0.1 /
              momentum 0.9 / weight decay 1e-4, ``maybe_fuse`` with
              ``BIGDL_PALLAS_MIN_C=128``, through ``optimize()``, 2 warm + 5
              timed steps: step ms p50, images/s, peak memory, losses; then
              the unfused ``Graph`` on the same recipe;
17. conv3x3 — the twin of ``benchmarks/pallas_conv3x3_experiment.py``'s
              ``main()``, the one path of its TPU kernel: the 3x3 stride-1
              conv kernel at ResNet-50's four 3x3 shapes (batch 256, 56² x
              64 to 7² x 512, bf16) plus a ragged and a one-pixel f32 case,
              each output pixel against the plain version and the first two
              images against F.conv2d in f32; the four shapes timed (the
              kernel through its C entry point and through the wrapper,
              one launch each on the unpadded input; plain) beside cuDNN's
              F.conv2d, with TFLOP/s and the bound.

Each path's kernel launch counts are set to 0 just before it runs and read
just after; each of its kernels must have launched (decode attention and
kv_requant once per layer per decode step in serve, serve_modes,
serve_async and serve_lora; in serve_spec decode attention once per draft layer per draft
step and kv_requant besides once per target layer per verify step; each
flash kernel once per layer per step, each
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
                 "fused_conv": ("fwd_wgmma", "fwd_panel_wgmma", "dgrad_wgmma",
                                "wgrad_wgmma")}
#: kernels, by library, that must build without a "wgmma ... serialized"
#: ptxas line (by library: both libraries have a ``fwd_wgmma``)
NO_SERIALIZED_WGMMA = {"flash_attention": ("dq_wgmma", "dkv_wgmma"),
                       "fused_conv": ("fwd_wgmma", "fwd_panel_wgmma",
                                      "dgrad_wgmma", "wgrad_wgmma")}


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


def serialized_wgmma(name: str, log: str) -> list:
    """The ptxas lines (``-Xptxas -v``) of library ``name`` that report
    wgmma serialized (C7510-C7520) in a kernel of its
    ``NO_SERIALIZED_WGMMA``."""
    kernels = NO_SERIALIZED_WGMMA.get(name, ())
    return [line.strip() for line in log.splitlines()
            if re.search(r"C75(1\d|20)", line) and "wgmma" in line
            and any(k in line for k in kernels)]


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


def fused_calls(d, dtype, r, g, want_y):
    """The three fused-conv kernels and their plain versions on the rows
    ``d`` of :func:`fused_inputs`: ``{name: (kernel, plain)}``; r, g: the
    residual and extra dy or None; want_y: the forward also returns y."""
    from bigdl_tpu_torch.ops import fused_conv as fc

    return {
        "fwd": (lambda: fc.fused_fwd_cuda(d["x"], d["scale"], d["shift"],
                                          d["w"], r, want_y),
                lambda: fc.fused_fwd_reference(d["x"], d["scale"], d["shift"],
                                               d["w"], r, want_y)),
        "dgrad": (lambda: fc.fused_dgrad_cuda(
            d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
            d["inv_std"], r, g),
            lambda: fc.fused_dgrad_reference(
            d["dz"], d["w"], d["x"], d["scale"], d["shift"], d["mean"],
            d["inv_std"], r, g)),
        "wgrad": (lambda: fc.fused_wgrad_cuda(d["x"], d["scale"], d["shift"],
                                              d["dz"], r, out_dtype=dtype),
                  lambda: fc.fused_wgrad_reference(d["x"], d["scale"],
                                                   d["shift"], d["dz"], r,
                                                   out_dtype=dtype))}


def fused_errors(name, kern, plain):
    """Runs a fused kernel and its plain version: (max per-row relative
    error of the outputs, of the f32 channel sums — zstats, q: output 1 of
    fwd and dgrad; 0 for the wgrad —, max abs error of the outputs, all
    finite)."""
    import torch

    from bigdl_tpu_torch.ops import fused_conv as fc

    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    outs = [(a, b) for j, (a, b) in enumerate(zip(got, want))
            if name == "wgrad" or j != 1]
    row_err = max(fc.max_row_rel_err(a, b) for a, b in outs)
    sum_err = 0.0 if name == "wgrad" else fc.max_row_rel_err(got[1], want[1])
    abs_err = max(float((a.float() - b.float()).abs().max()) for a, b in outs)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    return row_err, sum_err, abs_err, finite


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
        calls = fused_calls(d, dtype, r, g, extra)
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
            # outputs held row by row; the f32 channel sums (zstats, q) by
            # their rows too, at 1e-4
            row_err, sum_err, abs_err, finite = fused_errors(name, kern,
                                                             plain)
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
    (bf16, batch 256): each held to its plain version at each (outputs row
    by row, the f32 sums at 1e-4), each kernel's median time beside its
    bound, the bare cuBLAS product and the unfused PyTorch sequence; then
    per kernel the sum over the step of launches x (time - bound), the time
    a kernel at its bound would save per step."""
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
        calls = fused_calls(d, dtype, r, g, res)
        errs = {}
        for name, (kern, plain) in calls.items():
            row_err, sum_err, _, finite = fused_errors(name, kern, plain)
            errs[name] = (row_err, sum_err)
            if not finite or row_err > rtol or sum_err > 1e-4:
                raise AssertionError(
                    f"fused {name} at {(m, c, k)}: row err {row_err} > "
                    f"{rtol} or sum err {sum_err} > 1e-4")
        torch.cuda.empty_cache()
        y = torch.relu(d["x"] * sc + sh + (r if res else 0))
        unfused = unfused_sequences(d, dtype, res, res)
        runs = {
            "fwd": (calls["fwd"][0], lambda: y @ d["w"], unfused["fwd"]),
            "dgrad": (calls["dgrad"][0], lambda: d["dz"] @ d["w"].t(),
                      unfused["dgrad"]),
            "wgrad": (calls["wgrad"][0], lambda: y.t() @ d["dz"],
                      unfused["wgrad"])}
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
                 max_row_rel_err=errs[name][0],
                 max_sum_rel_err=errs[name][1] if name != "wgrad" else None)
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


def requant_inputs(case: str, seed: int):
    """Seeded int8 caches at the decode step's shape (16 rows, 512
    positions, 12 heads, D 64) with the step's old scales and new-value
    maxima: ``"none"`` grows no scale, ``"all"`` grows every one, and
    ``"mixed"`` has a zero-scale row that grows (its stale bytes go to
    zero), an inactive row (amax 0), a row that does not grow, and the
    other (row, head) pairs grown or not at random."""
    import torch

    n, L, h, d = SERVING_DECODE
    g = torch.Generator(device="cuda").manual_seed(seed)

    def cache():
        return torch.randint(-127, 128, (n, L, h, d), dtype=torch.int8,
                             device="cuda", generator=g)

    def scales():
        s_old = torch.rand(n, h, device="cuda", generator=g) * 0.1 + 0.01
        grow = torch.rand(n, h, device="cuda", generator=g) < 0.5
        if case == "mixed":
            s_old[0] = 0.0
            grow[0], grow[1], grow[2] = True, False, False
        else:
            grow[:] = case == "all"
        amax = torch.where(grow, (s_old + 0.01) * 127 * 2,
                           s_old * 127 * 0.5)
        if case == "mixed":
            amax[1] = 0.0
        return s_old, amax

    kc, vc = cache(), cache()
    (ks, ka), (vs, va) = scales(), scales()
    return kc, vc, ks, vs, ka, va


def parent_merge_step(kc, vc, ks_old, vs_old, k_amax, v_amax):
    """The decode-step merge as the port spelled it before the kv_requant
    kernel: read the ``grew`` flag back to the host, requantize only on
    growth (the yardstick of the host read)."""
    from bigdl_tpu_torch.models import transformer as tm

    grew = bool(((k_amax / 127.0 > ks_old).any()
                 | (v_amax / 127.0 > vs_old).any()).item())
    if grew:
        kc.copy_(tm._kv_quant_merge(kc, ks_old, k_amax)[0])
        vc.copy_(tm._kv_quant_merge(vc, vs_old, v_amax)[0])


def kv_requant_phase():
    """The kv_requant kernel (the scale rule and the requantize of both
    caches) against its plain version, bitwise, at the decode step's shape
    in three cases (no growth, every pair grown, mixed); the kernel's time
    per case beside the plain unconditional merge, the decode step's merge
    call and the parent's host-read step (scale rule in PyTorch, the grew
    flag read back, the requantize on growth), by the host clock with a
    synchronize, and the bound. Returns the kernel's summary entry (the
    mixed case)."""
    import torch

    from bigdl_tpu_torch.models import transformer as tm
    from bigdl_tpu_torch.ops import kv_requant as kr

    n, L, h, d = SERVING_DECODE
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    entry = None
    for i, case in enumerate(("none", "all", "mixed")):
        kc, vc, ks, vs, ka, va = requant_inputs(case, seed=40 + i)
        want = kr.kv_merge_reference(kc, vc, ks, vs, ka, va)
        got = tm._kv_quant_merge_step(kc.clone(), vc.clone(), ks, vs, ka, va)
        torch.cuda.synchronize()
        err = max(int((got[0].int() - want[0].int()).abs().max()),
                  int((got[1].int() - want[1].int()).abs().max()),
                  max(float((g - w).abs().max())
                      for g, w in zip(got[2:], want[2:])))
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        k_ratio = kr.kv_scale_merge(ks, ka)[2]
        v_ratio = kr.kv_scale_merge(vs, va)[2]
        grown = int((k_ratio != 1.0).sum() + (v_ratio != 1.0).sum())
        emit("kernels", kernel="kv_requant", case=case, shape=[n, L, h, d],
             grown_pairs=grown, pairs=2 * n * h, max_abs_err=err,
             tol=0, why="the same f32 operations, each rounded to nearest: "
                        "bitwise (caches and the four scale tensors)",
             bitwise=bitwise)
        if not bitwise:
            raise AssertionError(f"kv_requant {case}: not bitwise equal to "
                                 f"its plain version (max abs err {err})")
        kern = time_stats(lambda: kr.kv_requant_cuda(kc, vc, ks, vs, ka, va),
                          flush=flush)

        def plain():
            k2, v2, *_ = kr.kv_merge_reference(kc, vc, ks, vs, ka, va)
            kc.copy_(k2)
            vc.copy_(v2)

        plain_ms = time_ms(plain, flush=flush)

        def host_ms(fn, reps=50):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        step_ms = host_ms(lambda: tm._kv_quant_merge_step(kc, vc, ks, vs,
                                                          ka, va))
        parent_ms = host_ms(lambda: parent_merge_step(kc, vc, ks, vs, ka,
                                                      va))
        # in: 4 (n, h) f32 tensors; out: 4; grown pairs read + write L x D
        n_bytes = 8 * n * h * 4 + grown * L * d * 2
        bound_ms, bound_by = bound(grown * L * d * 2, n_bytes, F32_FLOPS)
        emit("kernels", kernel="kv_requant", case=case, ms=kern["mean"],
             ms_median=kern["median"], ms_min_max=[kern["min"], kern["max"]],
             host_ms_max=kern["host_ms_max"], plain_ms=plain_ms,
             plain="scale rule + round(q * ratio) of both caches, copied "
                   "back (the unconditional merge)",
             step_host_ms=step_ms, parent_step_host_ms=parent_ms,
             parent="scale rule in PyTorch, host read of the grew flag, "
                    "requantize on growth",
             bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
             library_ms=None)
        if case == "mixed":
            entry = {"name": "kv_requant", "route": "cuda",
                     "source": "bigdl_tpu_torch/csrc/kv_requant.cu",
                     "replaces": "bigdl_tpu/models/transformer.py:653",
                     "launches": None, "max_abs_err": float(err),
                     "ms": kern["mean"], "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
    return entry


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


#: the CUDA runtime calls that block the host on the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")


def decode_step_trace(engine, vocab, rng, steps: int = 8, submit_kw=None,
                      between=None):
    """Per decode step, over ``steps`` steps with all 16 slots decoding
    (after one admission step; ``submit_kw(i)`` adds keyword arguments to
    request i's ``submit``; ``between(i)`` runs before traced step i),
    counted by ``torch.profiler`` as ``tools/torch_serving_profile.py``
    counts them: device launches (kernels, copies, fills), device→host
    copies, and host waits on the card. The waits are the ``SYNC_CALLS``
    of the window less those of a window with no step in it (the
    profiler's own and the ``torch.cuda.synchronize()`` that closes it),
    so no step's count hangs on the profiler placing a call's time
    against a span's. Also returns the window's wait calls by name, in
    and out of the steps' host spans, and the empty window's count."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    eng = engine()
    for i in range(16):
        p = rng.integers(1, vocab + 1, size=int(rng.integers(16, 257)))
        eng.submit(p.tolist(), max_new_tokens=16,
                   **({} if submit_kw is None else submit_kw(i)))
    with torch.no_grad():
        eng.step()                         # admission: the prefills
        torch.cuda.synchronize()
        with profile(activities=activities) as empty:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for i in range(steps):
                if between is not None:
                    between(i)
                with record_function("serve_step"):
                    eng.step()
            torch.cuda.synchronize()
        eng.drain()
    events = list(prof.events())
    # a record_function span also shows on the card's timeline as a user
    # annotation; that is no launch, and no host span
    cpu_type = torch.autograd.DeviceType.CPU
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != "serve_step"]
    dtoh = sum(1 for e in cuda if "DtoH" in e.name)
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "serve_step" and e.device_type == cpu_type]
    waits = {}
    for e in events:
        if e.name in SYNC_CALLS:
            inside = any(a <= e.time_range.start <= b for a, b in spans)
            key = f"{e.name} {'in' if inside else 'outside'} a step"
            waits[key] = waits.get(key, 0) + 1
    own = sum(1 for e in empty.events() if e.name in SYNC_CALLS)
    waits["in the empty window"] = own
    syncs = sum(1 for e in events if e.name in SYNC_CALLS) - own
    return len(cuda) / steps, dtoh / steps, syncs / steps, waits


def serve_traffic(rng, vocab: int):
    """The serve phase's 24 requests: prompts of 16-256 tokens, every
    third one sampled (seeded), the rest greedy; ``(prompt, sampling)``."""
    from bigdl_tpu_torch.serving import SamplingParams

    out = []
    for i in range(24):
        prompt = rng.integers(1, vocab + 1, size=int(rng.integers(16, 257)))
        sp = (SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i)
              if i % 3 == 2 else None)
        out.append((prompt.tolist(), sp))
    return out


def lm_137m(n_layers: int = 12, seed: int = 0):
    """The "137m" TransformerLM (``benchmarks/serving_bench.py:146``) on
    the card, random weights from ``seed``; ``n_layers`` cuts its depth
    (a draft). Returns (model, build seconds)."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM

    t0 = time.perf_counter()
    lm = TransformerLM(32768, hidden_size=768, n_heads=12,
                       n_layers=n_layers, max_len=512, output="logits",
                       seed=seed)
    lm.evaluate()
    torch.cuda.synchronize()
    return lm, time.perf_counter() - t0


def serve_phase():
    """The main path at the 137m width; returns decode_attention and
    kv_requant launches and the run's decode-gap p99 (the chunked run's
    yardstick)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    V, layers = 32768, 12
    lm, build_s = lm_137m()
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
    reqs = [(eng.submit(prompt, max_new_tokens=32, sampling=sp), sp)
            for prompt, sp in serve_traffic(rng, V)]
    torch.cuda.synchronize()
    da.launches = kr.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, requant = da.launches, kr.launches
    steps = eng.metrics.decode_step_count
    for rid, _ in reqs:
        out, lps = outs[rid], eng.logprobs(rid)
        if not (len(out) == 32 and out.min() >= 1 and out.max() <= V):
            raise AssertionError(f"request {rid}: bad output {out}")
        if not (np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"request {rid}: bad logprobs {lps}")
        if eng.request(rid).finish_reason != "length":
            raise AssertionError(f"request {rid} did not run to length")
    for name, n in (("decode_attention", launches), ("kv_requant", requant)):
        if n != steps * layers:
            raise AssertionError(
                f"{name} launched {n} times, expected {steps} decode "
                f"steps x {layers} layers")
    s = eng.summary()
    per_step, dtoh, syncs, waits = decode_step_trace(engine, V, rng)
    emit("serve", model="137m", params=n_params, build_s=build_s,
         requests=len(reqs), new_tokens=32 * len(reqs), wall_s=wall,
         decode_steps=steps, decode_attention_launches=launches,
         kv_requant_launches=requant,
         decode_step_device_launches=per_step,
         decode_step_device_to_host_copies=dtoh,
         decode_step_host_waits=syncs, traced_wait_calls=waits,
         decode_gap_p99_s=s["serving/decode_gap_p99_s"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps({"tokens_per_s": s["serving/tokens_per_sec"]}))
    print(json.dumps({"ttft_p50_s": s["serving/ttft_p50_s"],
                      "ttft_p99_s": s["serving/ttft_p99_s"]}))
    print(json.dumps({"decode_step_p50_s": s["serving/decode_step_p50_s"],
                      "host_step_p50_s": s["serving/host_step_p50_s"]}))
    if dtoh != 1 or syncs != 1:
        raise AssertionError(
            f"a decode step made {dtoh} device-to-host copies and {syncs} "
            "host waits; the step's one readback (the fence) is all it "
            "may make")
    return launches, requant, s["serving/decode_gap_p99_s"]


def serve_modes_run(lm, mode, knobs, submit, between=None):
    """Serve one traffic through ``ServingEngine(**knobs)`` at the 137m
    width (bf16, int8 KV, 16 slots): ``submit(eng)`` queues requests and
    returns their ids, ``between(eng, step)`` runs after each step (more
    arrivals, checks). Checks every request ran to its length with ids in
    1..V and finite log-probs <= 0; returns (engine, ids, line fields)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    V = lm[0].n_index
    eng = ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                        kv_dtype="int8", **knobs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.launches = kr.launches = 0
    rids = submit(eng)
    t0 = time.perf_counter()
    n = 0
    with torch.no_grad():
        while not eng.scheduler.idle():
            eng.step()
            n += 1
            if between is not None:
                rids += between(eng, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid in rids:
        req, out, lps = eng.request(rid), eng.result(rid), eng.logprobs(rid)
        if req is None or req.finish_reason != "length" \
                or len(out) != req.max_new_tokens:
            raise AssertionError(f"{mode}: request {rid} did not run to "
                                 f"its length ({req and req.finish_reason})")
        if not (out.min() >= 1 and out.max() <= V):
            raise AssertionError(f"{mode}: request {rid}: bad ids {out}")
        if not (np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"{mode}: request {rid}: bad logprobs")
    s = eng.summary()
    m = eng.metrics.metrics
    fields = dict(
        mode=mode, requests=len(rids), wall_s=wall,
        new_tokens=int(m.get("serving/tokens_out")[0]),
        tokens_per_s=s["serving/tokens_per_sec"],
        ttft_p50_s=s["serving/ttft_p50_s"], ttft_p99_s=s["serving/ttft_p99_s"],
        decode_step_p50_s=s["serving/decode_step_p50_s"],
        decode_gap_p99_s=s.get("serving/decode_gap_p99_s", 0.0),
        prefix_hits=m.get("serving/prefix_hits")[0],
        prefix_matched_tokens=m.get("serving/prefix_hit_tokens")[0],
        chunks=m.get("serving/chunks")[0],
        preempted=m.get("serving/preempted")[0],
        retries=m.get("serving/retries")[0], shed=m.get("serving/shed")[0],
        decode_steps=eng.metrics.decode_step_count,
        decode_attention_launches=da.launches,
        kv_requant_launches=kr.launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return eng, rids, fields


def serve_modes_phase(batched_gap_p99_s):
    """The admission and scheduling modes of ``ServingEngine`` at the 137m
    width, each on its own traffic (see the module docstring);
    ``batched_gap_p99_s`` is the serve phase's decode-gap p99 on the same
    requests as the chunked run. Returns the decode_attention and the
    kv_requant launches of all runs."""
    import torch

    from bigdl_tpu_torch.serving import FaultInjector, WatchdogConfig

    lm, _ = lm_137m()
    V, layers = 32768, 12
    traffic = serve_traffic(np.random.default_rng(0), V)

    def serve_submit(eng):
        return [eng.submit(p, max_new_tokens=32, sampling=sp)
                for p, sp in traffic]

    def check_launches(f):
        for name in ("decode_attention", "kv_requant"):
            if f[f"{name}_launches"] != f["decode_steps"] * layers:
                raise AssertionError(
                    f"{f['mode']}: {name} launched "
                    f"{f[f'{name}_launches']} times, expected "
                    f"{f['decode_steps']} decode steps x {layers} layers")

    launches = 0
    runs = {}

    _, _, f = serve_modes_run(lm, "per_request",
                              {"admission": "per_request"}, serve_submit)
    runs["per_request"] = f

    # chat traffic behind one system prompt: a shared 192-token head and
    # distinct 16-64-token tails
    rng = np.random.default_rng(1)
    head = rng.integers(1, V + 1, size=192).tolist()
    chat = [head + rng.integers(1, V + 1, size=int(rng.integers(16, 65)))
            .tolist() for _ in range(24)]
    eng, _, f = serve_modes_run(
        lm, "prefix", {"prefix_cache": True},
        lambda e: [e.submit(p, max_new_tokens=32) for p in chat])
    fed = sum(len(p) - 1 for p in chat)
    f["prefix_matched_share"] = f["prefix_matched_tokens"] / fed
    if f["prefix_hits"] != 24 - 16:
        raise AssertionError(f"prefix: {f['prefix_hits']} hits, expected "
                             "every request after the first round (8)")
    runs["prefix"] = f

    spend = []

    def chunk_spend(eng, n):
        total = eng.metrics.metrics.get("serving/chunk_tokens")[0]
        spend.append(total - sum(spend))
        return []

    _, _, f = serve_modes_run(lm, "chunked", {"admission": "chunked",
                                              "chunk_budget": 64},
                              serve_submit, chunk_spend)
    f["max_chunk_tokens_per_step"] = max(spend)
    f["batched_decode_gap_p99_s"] = batched_gap_p99_s
    if max(spend) > 64:
        raise AssertionError(f"chunked: a step spent {max(spend)} prompt "
                             "tokens, over the budget of 64")
    runs["chunked"] = f

    # 16 priority-0 requests fill the slots; after 4 steps 8 priority-1
    # requests arrive and preempt 8 of them; every restore of a stash is
    # held bitwise against the slot it lands in. Inside the timed loop a
    # restore only snapshots its slot (device copies, no read back); the
    # compares run once the wall time is taken
    rng = np.random.default_rng(2)
    low = [rng.integers(1, V + 1, size=int(rng.integers(16, 257))).tolist()
           for _ in range(16)]
    high = [rng.integers(1, V + 1, size=int(rng.integers(16, 257))).tolist()
            for _ in range(8)]
    restored = []           # (stashed payload, its slot right after)

    def arrive(eng, n):
        if n != 4:
            return []
        restore = eng.pool.restore_row

        def restore_and_snapshot(slot, payload):
            restore(slot, payload)
            restored.append((payload["carry"],
                             eng.pool.row_state(slot)["carry"]))

        eng.pool.restore_row = restore_and_snapshot
        return [eng.submit(p, max_new_tokens=32, priority=1) for p in high]

    eng, _, f = serve_modes_run(
        lm, "priority", {"policy": "priority"},
        lambda e: [e.submit(p, max_new_tokens=64) for p in low], arrive)
    f["resumed_without_prefill"] = \
        eng.metrics.metrics.get("serving/resumed_without_prefill")[0]
    restores = [all(torch.equal(after[k], v) for k, v in stash.items())
                for stash, after in restored]
    f["restores_bitwise"] = f"{sum(restores)}/{len(restores)}"
    f["stash_bytes_per_row"] = max(
        (sum(v.numel() * v.element_size() for v in stash.values())
         for stash, _ in restored), default=0)
    if f["preempted"] != 8 or not restores or not all(restores) \
            or f["resumed_without_prefill"] <= 0:
        raise AssertionError(f"priority: {f}")
    runs["priority"] = f

    inj = FaultInjector(seed=0, p_fail=0.05, p_garbage=0.05,
                        p_admit_fail=0.05, max_faults=8)
    _, _, f = serve_modes_run(
        lm, "faults", {"faults": inj,
                       "watchdog": WatchdogConfig(max_retries=8)},
        serve_submit)
    f["faults"] = dict(inj.counts)
    # a failed dispatch raises before the step runs and a garbage step
    # still launches, so every counted decode step launched once a layer
    if not (inj.total > 0 and f["retries"] > 0):
        raise AssertionError(f"faults: {f}")
    f["healthy_decode_steps"] = f["decode_steps"] - inj.counts["garbage"]
    runs["faults"] = f

    requant = 0
    for f in runs.values():
        check_launches(f)
        launches += f["decode_attention_launches"]
        requant += f["kv_requant_launches"]
        emit("serve_modes", **f)
    return launches, requant


#: the dispatch-ahead windows of the serve_async phase
#: (``benchmarks/serving_bench.py``'s ``--scenario async``)
ASYNC_WINDOWS = (0, 1, 2, 4)


def lm_layers(lm) -> int:
    from bigdl_tpu_torch.models.transformer import TransformerBlock

    return sum(isinstance(m, TransformerBlock) for m in lm.layers())


def serve_async_phase():
    """The serve phase's engine (137m, bf16, int8 KV, 16 slots) and 24
    requests at ``dispatch_ahead`` W in ``ASYNC_WINDOWS``: every W's token
    and log-prob streams byte-identical to W = 0's, decode_attention and
    kv_requant launched once per layer per decode step; per W tok/s, the
    decode step p50, the share of the wall spent waiting on readbacks
    and the host step p50. Returns both kernels' launches."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    traffic = serve_traffic(np.random.default_rng(0), V)
    streams, totals = {}, [0, 0]
    for W in ASYNC_WINDOWS:
        eng = ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                            kv_dtype="int8", dispatch_ahead=W)
        rids = [eng.submit(p, max_new_tokens=32, sampling=sp)
                for p, sp in traffic]
        torch.cuda.synchronize()
        da.launches = kr.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.metrics.decode_step_count
        streams[W] = [(outs[r].tobytes(), eng.logprobs(r).tobytes())
                      for r in rids]
        for rid in rids:
            if len(outs[rid]) != 32 or eng.request(rid).finish_reason \
                    != "length":
                raise AssertionError(f"async W={W}: request {rid} did not "
                                     "run to its length")
        s = eng.summary()
        fence_s = eng.metrics.metrics.get("serving/fence_wait_s")[0]
        f = dict(dispatch_ahead=W, requests=len(rids), wall_s=wall,
                 tokens_per_s=s["serving/tokens_per_sec"],
                 decode_steps=steps,
                 decode_step_p50_s=s["serving/decode_step_p50_s"],
                 host_step_p50_s=s["serving/host_step_p50_s"],
                 fence_wait_share=fence_s / wall,
                 decode_attention_launches=da.launches,
                 kv_requant_launches=kr.launches,
                 streams_identical_to_w0=streams[W] == streams[0],
                 in_flight_after_drain=len(eng._window))
        emit("serve_async", **f)
        if not f["streams_identical_to_w0"] or eng._window:
            raise AssertionError(f"async W={W}: streams differ from W=0's "
                                 "or dispatches were left in flight")
        for name in ("decode_attention", "kv_requant"):
            if f[f"{name}_launches"] != steps * layers:
                raise AssertionError(
                    f"async W={W}: {name} launched {f[f'{name}_launches']} "
                    f"times, expected {steps} decode steps x {layers}")
        totals[0] += da.launches
        totals[1] += kr.launches
    return totals


def spec_trace(vocab: int, n_requests: int = 16, gen_tokens: int = 24,
               seed: int = 23):
    """``benchmarks/serving_bench.py``'s ``make_spec_trace``: prompts of 5,
    9 and 17 tokens; half the requests greedy speculative, a quarter
    ``draft_tokens=0`` (plain rows in the speculative batch), a quarter
    sampled with their own seeds. ``(prompt, new tokens, sampling,
    draft_tokens)``."""
    from bigdl_tpu_torch.serving import SamplingParams

    rng = np.random.RandomState(seed)
    buckets = [5, 9, 17]
    trace = []
    for i in range(n_requests):
        prompt = rng.randint(1, vocab + 1,
                             size=(buckets[i % len(buckets)],)).tolist()
        if i % 4 == 3:
            sp, dt = SamplingParams(temperature=0.8, top_k=20,
                                    seed=200 + i), None
        elif i % 4 == 1:
            sp, dt = None, 0
        else:
            sp, dt = None, None
        trace.append((prompt, gen_tokens, sp, dt))
    return trace


def spec_run(lm, draft, dtype, kv, trace, k: int = 3):
    """One drain of ``trace`` through a 16-slot engine (speculative when
    ``draft`` is given), kernel launch counts set to 0 just before and
    read just after. Returns (engine, request ids, outputs, fields)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine, SpeculativeConfig

    eng = ServingEngine(lm, n_slots=16, compute_dtype=dtype, kv_dtype=kv,
                        speculative=None if draft is None
                        else SpeculativeConfig(draft, k=k))
    draft_steps = [0]
    if draft is not None:
        step = eng._spec._draft_step_fn

        def counted(*a):
            draft_steps[0] += 1
            return step(*a)

        eng._spec._draft_step_fn = counted
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp, draft_tokens=dt)
            for p, n, sp, dt in trace]
    torch.cuda.synchronize()
    da.launches = kr.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    V = lm[0].n_index
    for rid, (_, n, _, _) in zip(rids, trace):
        out, lps = outs[rid], eng.logprobs(rid)
        if not (len(out) == n and out.min() >= 1 and out.max() <= V
                and np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"spec: request {rid}: bad output {out}")
    s = eng.summary()
    fields = dict(requests=len(rids), wall_s=wall,
                  tokens_per_s=s["serving/tokens_per_sec"],
                  accept_rate=s.get("serving/accept_rate"),
                  tokens_per_step=s.get("serving/tokens_per_step"),
                  verify_steps=eng.metrics.decode_step_count,
                  draft_steps=draft_steps[0],
                  decode_attention_launches=da.launches,
                  kv_requant_launches=kr.launches)
    return eng, rids, outs, fields


def serve_spec_phase():
    """Speculative serving of the 137m target (bf16, int8 KV, 16 slots,
    k=3) on ``spec_trace``: a same-seed weight-tied draft (drafts land:
    accept rate above 0, tokens per step above 1) and, on a short run, an
    independently seeded 2-layer draft (drafts rejected). In both, the
    verify step's int8 commit launches kv_requant once per target layer
    per verify step, and nothing launches decode_attention: the draft keeps
    a bf16 cache, as the JAX draft plane does, and the verify step attends
    in plain PyTorch, as JAX's reaches no kernel. Then the tied draft at fp32 (fp32 KV) on the trace's
    greedy rows: each must equal the plain fp32 engine's, or differ first
    where the plain model's top-two log-prob gap is below 1e-3 (a
    near-tie the chunked verify and the single-token step may break
    apart). Returns both kernels' launches of the bf16 runs."""
    import torch

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    tied, _ = lm_137m()
    other, _ = lm_137m(n_layers=2, seed=1)
    trace = spec_trace(V)
    totals = [0, 0]
    for name, draft, tr in (("tied", tied, trace),
                            ("independent", other, trace[:8])):
        d_layers = lm_layers(draft)
        _, _, _, f = spec_run(lm, draft, torch.bfloat16, "int8", tr)
        f.update(draft=name, draft_layers=d_layers)
        emit("serve_spec", **f)
        want_da, want_kr = 0, f["verify_steps"] * layers
        if (f["decode_attention_launches"] != want_da
                or f["kv_requant_launches"] != want_kr):
            raise AssertionError(
                f"spec {name}: launches {f['decode_attention_launches']} / "
                f"{f['kv_requant_launches']}, expected {want_da} / {want_kr}")
        if name == "tied" and not (f["accept_rate"] > 0
                                   and f["tokens_per_step"] > 1):
            raise AssertionError(f"spec tied: no draft landed: {f}")
        totals[0] += f["decode_attention_launches"]
        totals[1] += f["kv_requant_launches"]

    greedy = [t for t in trace if t[2] is None]
    _, rs, outs_s, f = spec_run(lm, tied, None, "fp32", greedy)
    _, rb, outs_b, _ = spec_run(lm, None, None, "fp32", greedy)
    equal, ties = 0, []
    for a, b, (prompt, _, _, _) in zip(rs, rb, greedy):
        got, want = outs_s[a].tolist(), outs_b[b].tolist()
        if got == want:
            equal += 1
            continue
        i = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        ids = torch.tensor([prompt + want[:i]], dtype=torch.float32,
                           device=lm[0].weight.device)
        with torch.no_grad():
            lp = torch.log_softmax(lm(ids)[0, -1].float(), dim=-1)
        top2 = lp.topk(2).values
        ties.append({"request": a, "position": i,
                     "top2_gap": float(top2[0] - top2[1])})
    emit("serve_spec", draft="tied", dtype="fp32", kv="fp32",
         greedy_requests=len(greedy), equal_to_plain=equal,
         differ_at_near_ties=ties, accept_rate=f["accept_rate"],
         tokens_per_step=f["tokens_per_step"])
    if any(t["top2_gap"] >= 1e-3 for t in ties):
        raise AssertionError(f"spec fp32: greedy rows differ from the plain "
                             f"engine off a near-tie: {ties}")
    return totals


#: serve_lora: tenants in the bank (``serving_bench.run_multitenant``'s 3,
#: factor seeds 50-52) and their rank
LORA_TENANTS = 3
LORA_RANK = 16


def multitenant_trace(vocab: int, n_requests: int = 24, gen_tokens: int = 32,
                      n_tenants: int = LORA_TENANTS, seed: int = 29):
    """``benchmarks/serving_bench.py``'s ``make_multitenant_trace``: prompts
    of 5, 9 and 17 tokens, adapter ids round-robin over 0 (base) and the
    tenants, every fourth request forced through a 3-token
    ``fixed_sequence``, odd requests seeded-sampled. ``(prompt, new
    tokens, sampling, adapter id, constraint, forced ids)``."""
    from bigdl_tpu_torch.serving import SamplingParams, fixed_sequence

    rng = np.random.RandomState(seed)
    buckets = [5, 9, 17]
    trace = []
    for i in range(n_requests):
        plen = buckets[i % len(buckets)]
        prompt = rng.randint(1, vocab + 1, size=(plen,)).tolist()
        sp = SamplingParams(temperature=0.8, top_k=20, seed=300 + i) \
            if i % 2 else None
        aid = i % (n_tenants + 1)
        forced = rng.randint(1, vocab + 1, size=(3,)).tolist() \
            if i % 4 == 3 else None
        cons = None if forced is None else fixed_sequence(forced)
        trace.append((prompt, gen_tokens, sp, aid, cons, forced))
    return trace


def lora_run(lm, trace, bank, tenants_on: bool):
    """One drain of ``trace`` through a 16-slot bf16 / int8-KV engine with
    ``adapters=bank`` (``bank=None``: the bank-less oracle);
    ``tenants_on=False`` strips adapter ids and constraints (the base-only
    pass). Kernel launch counts are set to 0 just before the drain and read
    just after; the shapes of every decode dispatch's inputs are recorded.
    Returns (engine, request ids, fields, input layouts)."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import ServingEngine

    eng = ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                        kv_dtype="int8", adapters=bank, seed=5)
    layouts = set()
    step = eng._step_fn

    def recording(*args):
        flat = [args[1], args[2], *args[4].values(), *args[5:6],
                *(args[6].values() if len(args) > 6 else ())]
        layouts.add(tuple((tuple(t.shape), str(t.dtype)) for t in flat))
        return step(*args)

    eng._step_fn = recording
    rids = [eng.submit(p, max_new_tokens=n, sampling=sp,
                       adapter_id=aid if tenants_on else 0,
                       constraint=cons if tenants_on else None)
            for p, n, sp, aid, cons, _ in trace]
    torch.cuda.synchronize()
    da.launches = kr.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    V = lm[0].n_index
    for rid, (_, n, _, _, _, _) in zip(rids, trace):
        out, lps = outs[rid], eng.logprobs(rid)
        if not (len(out) == n and out.min() >= 1 and out.max() <= V
                and np.isfinite(lps).all() and (lps <= 0).all()):
            raise AssertionError(f"lora: request {rid}: bad output {out}")
    s = eng.summary()
    fields = dict(requests=len(rids), wall_s=wall,
                  tokens_per_s=s["serving/tokens_per_sec"],
                  decode_step_p50_s=s["serving/decode_step_p50_s"],
                  ttft_p50_s=s["serving/ttft_p50_s"],
                  ttft_p99_s=s["serving/ttft_p99_s"],
                  decode_steps=eng.metrics.decode_step_count,
                  decode_attention_launches=da.launches,
                  kv_requant_launches=kr.launches)
    return eng, rids, fields, layouts


def serve_lora_phase():
    """Multi-tenant LoRA and constrained decoding on the 137m model (bf16,
    int8 KV, 16 slots) as ``serving_bench.run_multitenant`` drives it: an
    ``AdapterBank(rank=16, n_slots=4)`` with three tenants
    (``random_factors`` seeds 50-52, amp 0.05), ``multitenant_trace`` (24
    requests, 32 new tokens), a bank-less oracle pass, a short warm pass,
    then a base-only pass (ids and constraints stripped) and a mixed pass
    on engines with the bank. Held to: every unconstrained null-adapter
    row of the mixed pass bitwise the oracle's (tokens and log-probs);
    every constrained row emits its forced ids; at least one adapted row
    leaves the oracle's stream; one decode input layout, the same in both
    passes; decode_attention and kv_requant launched once per layer per
    decode step in each; every request's adapter reference released (then
    ``bank.free`` empties the bank). Then launches, device-to-host copies
    and host waits per decode step (``decode_step_trace``, one readback
    each) for the bank-less, base-only and mixed engines, and for mixed
    traffic while a spare tenant is alloc'd and freed between steps (the
    bank re-uploaded every step, still without a host wait). Last, the
    oracle, base-only and mixed passes in alternating order over four
    rounds: the bank's decode-step cost and mixed against base-only,
    within each round. Returns both kernels' launches of the base-only and
    mixed passes."""
    import torch

    from bigdl_tpu_torch.serving import (
        AdapterBank, ServingEngine, fixed_sequence,
    )

    lm, _ = lm_137m()
    V, layers = lm[0].n_index, lm_layers(lm)
    bank = AdapterBank(lm, rank=LORA_RANK, n_slots=LORA_TENANTS + 1)
    for t in range(LORA_TENANTS):
        bank.alloc(bank.random_factors(seed=50 + t))
    trace = multitenant_trace(V)
    eng_p, rids_p, f_plain, _ = lora_run(lm, trace, None, False)
    lora_run(lm, [(p, 2, sp, a, c, f) for p, _, sp, a, c, f in trace],
             bank, True)                                 # warm
    _, _, f_base, lay_b = lora_run(lm, trace, bank, False)
    eng_m, rids_m, f_mixed, lay_m = lora_run(lm, trace, bank, True)
    null_rows = equal_null = diverged = 0
    for (_, _, _, aid, cons, forced), rp, rm in zip(trace, rids_p, rids_m):
        want, got = eng_p.result(rp), eng_m.result(rm)
        if aid == 0 and cons is None:
            null_rows += 1
            equal_null += bool(np.array_equal(want, got) and (
                eng_p.logprobs(rp).tobytes() == eng_m.logprobs(rm).tobytes()))
        if cons is not None and list(got)[:3] != forced:
            raise AssertionError(f"lora: request {rm} did not emit its "
                                 f"forced ids {forced}: {got}")
        if aid != 0 and cons is None:
            diverged += not np.array_equal(want, got)
    live_after = bank.live
    for t in range(1, LORA_TENANTS + 1):
        bank.free(t)
    checks = dict(
        null_rows=null_rows, null_rows_bitwise_equal=equal_null,
        adapted_rows_diverged=diverged,
        constrained_rows_forced=sum(c is not None for *_, c, _ in trace),
        layouts_base_only=len(lay_b), layouts_mixed=len(lay_m),
        same_layout=lay_b == lay_m,
        live_after_passes={str(k): v for k, v in live_after.items()},
        live_after_free=len(bank.live))
    for name, f in (("oracle", f_plain), ("base_only", f_base),
                    ("mixed", f_mixed)):
        emit("serve_lora", run=name, model="137m", rank=LORA_RANK,
             tenants=LORA_TENANTS, **f)
        for k in ("decode_attention", "kv_requant"):
            if f[f"{k}_launches"] != f["decode_steps"] * layers:
                raise AssertionError(
                    f"lora {name}: {k} launched {f[f'{k}_launches']} "
                    f"times, expected {f['decode_steps']} x {layers}")
    emit("serve_lora", run="checks", multitenant_overhead_pct=100.0 * (
        f_base["tokens_per_s"] / f_mixed["tokens_per_s"] - 1.0), **checks)
    if not (equal_null == null_rows > 0 and diverged > 0
            and len(lay_b) == 1 and lay_b == lay_m
            and live_after == {t: 1 for t in range(1, LORA_TENANTS + 1)}
            and not bank.live):
        raise AssertionError(f"lora: a check failed: {checks}")

    # launches, copies and waits per decode step of a full pool; "churn"
    # serves mixed traffic from a bank with one slot more, whose spare
    # tenant is alloc'd before one traced step and freed before the next,
    # so every step re-uploads the bank
    for t in range(LORA_TENANTS):
        bank.alloc(bank.random_factors(seed=50 + t))
    churn = AdapterBank(lm, rank=LORA_RANK, n_slots=LORA_TENANTS + 2)
    for t in range(LORA_TENANTS):
        churn.alloc(churn.random_factors(seed=50 + t))
    spare_factors, spare = churn.random_factors(seed=50 + LORA_TENANTS), []

    def churn_step(i):
        if spare:
            churn.free(spare.pop())
        else:
            spare.append(churn.alloc(spare_factors))

    forced = np.random.default_rng(7).integers(1, V + 1, size=(16, 3))

    def mixed_kw(i):
        return {"adapter_id": i % (LORA_TENANTS + 1),
                "constraint": fixed_sequence(forced[i].tolist())
                if i % 4 == 3 else None}

    per_step = {}
    for name, adapters, kw, between in (
            ("no_bank", None, None, None), ("base_only", bank, None, None),
            ("mixed", bank, mixed_kw, None),
            ("churn", churn, mixed_kw, churn_step)):
        def engine(adapters=adapters):
            return ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                                 kv_dtype="int8", adapters=adapters)

        n, dtoh, syncs, waits = decode_step_trace(
            engine, V, np.random.default_rng(1), submit_kw=kw,
            between=between)
        per_step[name] = dict(device_launches=n, device_to_host_copies=dtoh,
                              host_waits=syncs, traced_wait_calls=waits)
    per_step["churn"]["bank_versions"] = churn.version
    emit("serve_lora", run="per_decode_step", **per_step)
    for name, f in per_step.items():
        if f["device_to_host_copies"] != 1 or f["host_waits"] != 1:
            raise AssertionError(f"lora {name}: a decode step made more than "
                                 f"its one readback: {f}")

    # the bank's cost per decode step: the three engines in alternating
    # order (ABC, CBA, ABC, CBA), so the drift between passes of one
    # process falls on each alike; differences are taken within a round
    order = ("oracle", "base_only", "mixed")
    rounds = {name: [] for name in order}
    for r in range(4):
        for name in order if r % 2 == 0 else order[::-1]:
            _, _, f, _ = lora_run(lm, trace, None if name == "oracle"
                                  else bank, name == "mixed")
            rounds[name].append(f)
    added = (per_step["base_only"]["device_launches"]
             - per_step["no_bank"]["device_launches"])
    step = {n: [f["decode_step_p50_s"] for f in fs]
            for n, fs in rounds.items()}
    bank_ms = [1e3 * (b - o) for b, o in zip(step["base_only"],
                                            step["oracle"])]
    emit("serve_lora", run="alternating", rounds=4, order="ABC CBA ABC CBA",
         decode_step_p50_s=step,
         tokens_per_s={n: [f["tokens_per_s"] for f in fs]
                       for n, fs in rounds.items()},
         bank_step_ms=bank_ms,
         host_us_per_added_launch=[1e3 * d / added for d in bank_ms],
         added_launches_per_step=added,
         mixed_minus_base_step_ms=[
             1e3 * (m - b) for m, b in zip(step["mixed"],
                                           step["base_only"])],
         multitenant_overhead_pct=[
             100.0 * (b["tokens_per_s"] / m["tokens_per_s"] - 1.0)
             for b, m in zip(rounds["base_only"], rounds["mixed"])])
    return (f_base["decode_attention_launches"]
            + f_mixed["decode_attention_launches"],
            f_base["kv_requant_launches"] + f_mixed["kv_requant_launches"])


def window_counts(fn, label: str, n: int):
    """Run ``fn()`` once under ``torch.profiler`` and count, per unit of
    ``n`` (handoffs, restores or decode steps): device launches
    (kernels, copies, fills), device→host and host→device copies as the
    card's records show them, the host's copy calls
    (``cudaMemcpyAsync``), and host waits on the card (the window's
    ``SYNC_CALLS`` less those of an empty window, as ``decode_step_trace``
    counts them). The card's records of a window of large copies can come
    back short (observed: 12 of 16 handoff copies); the host's calls are
    what the host did."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as empty:
        torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=activities) as prof:
        with record_function(label):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != label]
    own = sum(1 for e in empty.events() if e.name in SYNC_CALLS)
    syncs = sum(1 for e in events if e.name in SYNC_CALLS) - own
    host_copies = sum(1 for e in events if e.name == "cudaMemcpyAsync")
    return {"device_launches": len(cuda) / n,
            "device_to_host_copies": sum("DtoH" in e.name for e in cuda) / n,
            "host_to_device_copies": sum("HtoD" in e.name for e in cuda) / n,
            "host_copy_calls": host_copies / n, "host_waits": syncs / n}


def tiered_trace(vocab: int, n_requests: int = 24, gen_tokens: int = 32,
                 seed: int = 31):
    """``serving_bench.make_tiered_trace`` (``:1527-1547``): prompts of 5,
    9 and 17 tokens in turn, every odd request seeded-sampled;
    ``(prompt, new tokens, sampling)``."""
    from bigdl_tpu_torch.serving import SamplingParams

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_requests):
        prompt = rng.randint(1, vocab + 1, size=([5, 9, 17][i % 3],))
        sp = (SamplingParams(temperature=0.8, top_k=20, seed=400 + i)
              if i % 2 else None)
        out.append((prompt.tolist(), gen_tokens, sp))
    return out


def streams_of(eng, rids):
    """Each request's (token bytes, log-prob bytes)."""
    return [(np.asarray(eng.result(r), np.int32).tobytes(),
             np.asarray(eng.logprobs(r), np.float32).tobytes())
            for r in rids]


def check_served(name, eng, rids, lengths, vocab):
    """Every request at its length, ids in 1..V, finite log-probs <= 0."""
    for rid, n in zip(rids, lengths):
        out, lps = eng.result(rid), eng.logprobs(rid)
        if not (out is not None and len(out) == n and out.min() >= 1
                and out.max() <= vocab and np.isfinite(lps).all()
                and (lps <= 0).all()):
            raise AssertionError(f"{name}: request {rid}: bad output {out}")


def serve_disagg_phase():
    """The disaggregated plane, the host KV tier and pool health on the
    137m model (bf16, int8 KV, seed 0) with the serve phase's 24 requests:
    (1) handoff — ``DisaggregatedEngine(prefill_slots=16, decode_slots=16,
    decode_pools=2)`` against ``ServingEngine(n_slots=16)``: every stream
    bitwise the oracle's, 24 handoffs, the tier empty after the drain, both
    kernels once per layer per decode step summed over the pools;
    (2) failover — the plane at ``decode_slots=8``, ``kill_pool(0)`` after
    3 steps: every request at its length, one pool death, the migrated
    rows bitwise an undisturbed pass of the same plane, the replayed rows'
    identity counted, the survivor's launches = its decode steps x 12;
    (3) tier — ``serving_bench``'s two-wave trace (seed 31: 16 priority-0
    rows, 3 steps, 8 priority-5 rows) through a priority engine with a
    ``TieredKVStore`` against its ``tier=None`` twin: bitwise, >= 8 spills,
    fetches and resumes without prefill, no bytes left; then a tier whose
    budget holds one row: evictions, every row but the evicted (replayed)
    ones bitwise, the replayed rows' identity counted; (4) codec — a bf16 and an int8 row of
    a card pool packed, unpacked and restored into another slot bitwise.
    Then launches, copies and waits per decode step of a full decode pool,
    per handoff and per restore. Returns both kernels' launches."""
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da
    from bigdl_tpu_torch.ops import kv_requant as kr
    from bigdl_tpu_torch.serving import (
        DisaggregatedEngine, ServingEngine, TieredKVStore, pack_payload,
        payload_header, unpack_payload,
    )
    from bigdl_tpu_torch.serving.disagg import request_meta

    lm, _ = lm_137m()
    torch.cuda.reset_peak_memory_stats()     # the phase's own peak
    V, layers = lm[0].n_index, lm_layers(lm)
    bf16 = torch.bfloat16
    traffic = serve_traffic(np.random.default_rng(0), V)
    totals = [0, 0]

    def plane(**kw):
        kw.setdefault("prefill_slots", 16)
        return DisaggregatedEngine(lm, compute_dtype=bf16, kv_dtype="int8",
                                   **kw)

    def counted(name, fn, steps_of):
        """Run ``fn`` with the launch counts at 0; both kernels must have
        launched once per layer per decode step (``steps_of()``)."""
        torch.cuda.synchronize()
        da.launches = kr.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = steps_of()
        for k, n in (("decode_attention", da.launches),
                     ("kv_requant", kr.launches)):
            if n != steps * layers:
                raise AssertionError(f"disagg {name}: {k} launched {n} "
                                     f"times, expected {steps} x {layers}")
        totals[0] += da.launches
        totals[1] += kr.launches
        return out, wall, steps

    # (1) handoff against the monolithic oracle
    oracle = ServingEngine(lm, n_slots=16, compute_dtype=bf16,
                           kv_dtype="int8")
    o_rids = [oracle.submit(p, max_new_tokens=32, sampling=sp)
              for p, sp in traffic]
    _, o_wall, o_steps = counted("oracle", oracle.drain,
                                 lambda: oracle.metrics.decode_step_count)
    d = plane(decode_slots=16, decode_pools=2)
    d_rids = [d.submit(p, max_new_tokens=32, sampling=sp)
              for p, sp in traffic]
    _, d_wall, d_steps = counted(
        "handoff", d.drain,
        lambda: sum(w.engine.metrics.decode_step_count for w in d.decoders))
    check_served("disagg handoff", d, d_rids, [32] * 24, V)
    want, got = streams_of(oracle, o_rids), streams_of(d, d_rids)
    differ = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    s, so = d.summary(), oracle.summary()
    tp = d.metrics.transfer_percentiles((50, 99))
    handoff = dict(
        run="handoff", model="137m", requests=24,
        oracle_tokens_per_s=24 * 32 / o_wall, plane_tokens_per_s=24 * 32 / d_wall,
        oracle_metric_tokens_per_s=so["serving/tokens_per_sec"],
        oracle_decode_gap_p99_s=so["serving/decode_gap_p99_s"],
        plane_decode_gap_p99_s=s["serving/decode_gap_p99_s"],
        oracle_decode_steps=o_steps, plane_decode_steps=d_steps,
        pool_decode_steps=[w.engine.metrics.decode_step_count
                           for w in d.decoders],
        handoffs=s["serving/handoffs"],
        transfer_bytes_per_handoff=s["serving/transfer_bytes_per_handoff"],
        transfer_p50_ms=1e3 * tp["p50"], transfer_p99_ms=1e3 * tp["p99"],
        prefill_occupancy=s["serving/prefill_occupancy"],
        decode_occupancy=s["serving/decode_occupancy"],
        tier_entries=d.tier.entries, tier_bytes=d.tier.resident_bytes,
        streams_bitwise_equal=24 - len(differ), differing_rows=differ)
    emit("serve_disagg", **handoff)
    if differ or s["serving/handoffs"] != 24 or d.tier.entries \
            or d.tier.resident_bytes:
        raise AssertionError(f"disagg handoff: a check failed: {handoff}")
    del d, oracle

    # (2) failover: decode pools of 8 slots, pool 0 killed after 3 steps
    def failover_pass(kill: bool):
        f = plane(decode_slots=8, decode_pools=2)
        rids = [f.submit(p, max_new_tokens=32, sampling=sp)
                for p, sp in traffic]
        info = {}
        with torch.no_grad():
            for _ in range(3):
                f.step()
            if kill:
                w0 = f.decoders[0]
                wire = {payload_header(b)["request"]["req_id"]
                        for b in w0.transfer._q}
                sched = w0.engine.scheduler
                owned = [e[1] for e in sched._waiting] \
                    + list(sched.running.values()) \
                    + list(sched.partial.values())
                current = set()
                for req in owned:
                    h = f.tier.header(req.req_id)
                    if h is not None and h["carry_keys"] is not None and \
                            h["request"]["output"] == list(req.output):
                        current.add(req.req_id)
                info["migrated"] = sorted(wire | current)
                info["replayed"] = sorted({r.req_id for r in owned}
                                          - current)
                f.kill_pool(0)
                survivor = f.decoders[1].engine.metrics
                before = survivor.decode_step_count
                _, wall, steps = counted(
                    "failover survivor", f.drain,
                    lambda: survivor.decode_step_count - before)
                info.update(wall_s=wall, survivor_decode_steps=steps)
            else:
                f.drain()
        check_served(f"disagg failover kill={kill}", f, rids, [32] * 24, V)
        return f, rids, info

    ref, ref_rids, _ = failover_pass(False)
    f, f_rids, info = failover_pass(True)
    want, got = streams_of(ref, ref_rids), streams_of(f, f_rids)
    mig_bad = [r for r in info["migrated"] if want[r] != got[r]]
    rep_same = sum(want[r] == got[r] for r in info["replayed"])
    rep_tokens = sum(want[r][0] == got[r][0] for r in info["replayed"])
    s = f.summary()
    fp = f.metrics.failover_percentiles((50, 99))
    failover = dict(
        run="failover", decode_slots=8, pool_deaths=s["serving/pool_deaths"],
        migrated_rows=s.get("serving/migrated_rows", 0.0),
        replayed_rows=s.get("serving/replayed_rows", 0.0),
        migrated=info["migrated"], replayed=info["replayed"],
        migrated_bitwise_equal=len(info["migrated"]) - len(mig_bad),
        replayed_bitwise_equal=rep_same, replayed_tokens_equal=rep_tokens,
        failover_p50_ms=1e3 * fp["p50"], failover_p99_ms=1e3 * fp["p99"],
        survivor_decode_steps=info["survivor_decode_steps"],
        tier_entries=f.tier.entries)
    emit("serve_disagg", **failover)
    if s["serving/pool_deaths"] != 1.0 or mig_bad or not info["migrated"] \
            or f.tier.entries:
        raise AssertionError(f"disagg failover: a check failed: {failover}")
    del ref, f

    # (3) the host tier under two-wave priority traffic
    trace = tiered_trace(V)

    def tier_pass(tier):
        eng = ServingEngine(lm, n_slots=16, compute_dtype=bf16,
                            kv_dtype="int8", policy="priority",
                            preemption=True, seed=5, tier=tier)

        def run():
            rids = [eng.submit(p, max_new_tokens=n, sampling=sp, priority=0)
                    for p, n, sp in trace[:16]]
            for _ in range(3):
                eng.step()
            rids += [eng.submit(p, max_new_tokens=n, sampling=sp,
                                priority=5) for p, n, sp in trace[16:]]
            eng.drain()
            return rids

        rids, wall, steps = counted(
            "tier", run, lambda: eng.metrics.decode_step_count)
        check_served("disagg tier", eng, rids, [n for _, n, _ in trace], V)
        return eng, rids, wall

    twin, t_rids, twin_wall = tier_pass(None)
    eng, e_rids, eng_wall = tier_pass(TieredKVStore())
    want, got = streams_of(twin, t_rids), streams_of(eng, e_rids)
    s = eng.summary()
    fetch = eng.metrics.fetch_percentiles((50, 99))
    tier = dict(
        run="tier", requests=len(trace), twin_tokens_per_s=
        sum(n for _, n, _ in trace) / twin_wall,
        tiered_tokens_per_s=sum(n for _, n, _ in trace) / eng_wall,
        preempted=s["serving/preempted"], spills=s["serving/spills"],
        fetches=s["serving/fetches"],
        resumed_without_prefill=s["serving/resumed_without_prefill"],
        spill_bytes_per_row=s["serving/spill_bytes_per_row"],
        fetch_p50_ms=1e3 * fetch["p50"], fetch_p99_ms=1e3 * fetch["p99"],
        tier_bytes_after=s["serving/tier_bytes"],
        streams_bitwise_equal=sum(a == b for a, b in zip(want, got)))
    emit("serve_disagg", **tier)
    if want != got or min(s["serving/spills"], s["serving/fetches"],
                          s["serving/resumed_without_prefill"]) < 8 \
            or s["serving/tier_bytes"] != 0.0:
        raise AssertionError(f"disagg tier: a check failed: {tier}")
    row_bytes = int(s["serving/spill_bytes_per_row"])
    del eng
    # a starved tier: a budget of one row's bytes evicts all but the
    # newest spill, and the evicted rows replay through prefill
    starved = TieredKVStore(host_budget_bytes=row_bytes)
    fetch_row, from_tier = starved.fetch_row, set()

    def fetch_noting(req):
        payload = fetch_row(req)
        if payload is not None:
            from_tier.add(req.req_id)
        return payload

    starved.fetch_row = fetch_noting
    eng, e_rids, _ = tier_pass(starved)
    got = streams_of(eng, e_rids)
    s = eng.summary()
    replayed = [i for i, r in enumerate(e_rids)
                if eng.request(r).preemptions and r not in from_tier]
    differ = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    starve = dict(run="tier_starved", host_budget_bytes=row_bytes,
                  tier_evictions=s.get("serving/tier_evictions", 0.0),
                  resumed_from_tier=len(from_tier), replayed=replayed,
                  replayed_bitwise_equal=sum(i not in differ
                                             for i in replayed),
                  replayed_tokens_equal=sum(want[i][0] == got[i][0]
                                            for i in replayed),
                  streams_bitwise_equal=len(trace) - len(differ),
                  differing_rows=differ)
    emit("serve_disagg", **starve)
    if not s.get("serving/tier_evictions") or not replayed \
            or any(i not in replayed for i in differ):
        raise AssertionError(f"disagg starved tier: {starve}")
    del eng, twin

    # (4) the codec on the card: bf16 and int8 rows through the wire
    codec = {}
    for kv in ("bf16", "int8"):
        e = ServingEngine(lm, n_slots=2, compute_dtype=bf16, kv_dtype=kv)
        with torch.no_grad():
            e.submit(traffic[0][0], max_new_tokens=8)
            for _ in range(3):
                e.step()
            slot, req = next(iter(e.scheduler.running.items()))
            payload = e.pool.row_state(slot)
            _, back = unpack_payload(pack_payload(request_meta(req), payload))
            other = e.pool.alloc()
            e.pool.restore_row(other, back)
            again = e.pool.row_state(other)
        codec[kv] = all(torch.equal(again["carry"][k], v)
                        for k, v in payload["carry"].items())
        e.pool.free(other)
        with torch.no_grad():
            e.drain()
    emit("serve_disagg", run="codec", rows_bitwise=codec)
    if not all(codec.values()):
        raise AssertionError(f"disagg codec: a row did not round-trip {codec}")

    # launches, copies and waits: per decode step of a full decode pool,
    # per handoff, per restore
    rng = np.random.default_rng(1)
    p = plane(decode_slots=16, decode_pools=1)
    for _ in range(16):
        prompt = rng.integers(1, V + 1, size=int(rng.integers(16, 257)))
        p.submit(prompt.tolist(), max_new_tokens=16)
    with torch.no_grad():
        out = p.prefill.pump()
    per_handoff = window_counts(
        lambda: [p._handoff(r, pl) for r, pl in out], "handoffs", len(out))
    w = p.decoders[0]

    def restore():
        w.poll()
        w.engine._admit()

    per_restore = window_counts(restore, "restores", len(out))
    with torch.no_grad():
        w.step()                      # the first decode of the 16 rows

    def steps8():
        for _ in range(8):
            w.step()

    per_step = window_counts(steps8, "decode_steps", 8)
    with torch.no_grad():
        p.drain()
    emit("serve_disagg", run="per_unit", handoffs=len(out),
         per_handoff=per_handoff, per_restore=per_restore,
         per_decode_step=per_step,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # a handoff's one copy call is its readback (the leaves' cat is a
    # kernel)
    if (per_handoff["host_copy_calls"] != 1
            or per_handoff["host_waits"] != 1
            or per_restore["host_waits"] != 0
            or per_step["device_to_host_copies"] != 1
            or per_step["host_waits"] != 1):
        raise AssertionError(
            f"disagg: copies or waits off their budget: handoff "
            f"{per_handoff}, restore {per_restore}, step {per_step}")
    return totals


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
    serialized = [line for name, log in logs.items()
                  for line in serialized_wgmma(name, log)]
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
    requant = kv_requant_phase()
    flash = flash_phase()
    check_phase()
    train_check_phase()
    entry["launches"], requant["launches"], batched_gap_p99_s = serve_phase()
    if not (entry["launches"] and requant["launches"]):
        raise AssertionError("decode_attention or kv_requant never launched "
                             "on the main path")
    for phase in (lambda: serve_modes_phase(batched_gap_p99_s),
                  serve_async_phase, serve_spec_phase, serve_lora_phase,
                  serve_disagg_phase):
        n_da, n_kr = phase()
        entry["launches"] += n_da
        requant["launches"] += n_kr
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
                      + [conv, requant]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
