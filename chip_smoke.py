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
              per source, all started together;
3. kernels  — each kernel against its plain PyTorch version on the card at
              the serving shapes (N=16 rows, H=12 heads, L=512, D=64) with
              per-row positions that include 0 and L-1, plus a ragged L:
              max abs error against the stated tolerance, kernel, plain and
              library times, and the least time the card could take;
4. kv_merge — the cost of the int8 grow check the decode step makes (a
              host read of one flag) against the unconditional requantize;
5. check    — a small model's int8-KV decode step on the card against the
              same step on the CPU, teacher-forced, f32;
6. serve    — the main path at full width: the 137m TransformerLM (vocab
              32768, hidden 768, 12 layers, 12 heads, max_len 512, random
              weights from seed 0) served bf16 with int8 KV by
              ``ServingEngine(n_slots=16)``: 24 requests, prompts of 16-256
              tokens, 32 new tokens each, greedy and seeded-sampled rows.
              Every kernel's launch count is set to 0 just before ``drain``
              and read just after; each must have launched (decode
              attention: once per layer per decode step).

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


def time_ms(fn, reps: int = 30, flush=None) -> float:
    """Mean device time of ``fn`` by CUDA events. ``flush`` (a large
    buffer) is overwritten before each launch so the caches start cold,
    as the decode step finds the KV cache after the other layers' work,
    and the write keeps the card busy while the host enqueues ``fn``."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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


def kernels_phase():
    """decode_attention against its plain version; returns the kernel's
    summary entry (times at the main path's call: bf16 q and output,
    int8 K/V)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import decode_attention as da

    n, L, h, d = 16, 512, 12, 64
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
        ms = time_ms(lambda: da.pooled_decode_attention(
            q, k, v, pos, ks, vs, out_dtype=qdt), flush=flush)
        plain_ms = time_ms(lambda: da.decode_attention_reference(
            q, k, v, pos, ks, vs, out_dtype=qdt), flush=flush)
        # the library yardstick: one SDPA call over dequantized bf16 K/V
        # with the per-row mask (prepared outside the timing)
        kd = (k.float() * ks[:, None, :, None]).to(qdt).transpose(1, 2)
        vd = (v.float() * vs[:, None, :, None]).to(qdt).transpose(1, 2)
        kd, vd = kd.contiguous(), vd.contiguous()
        mask = (torch.arange(Lc, device="cuda")[None, None, None, :]
                <= pos.long()[:, None, None, None])
        qs = q[:, :, None, :]
        lib = F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)
        lib_err = float((lib[:, :, 0].float() - want.float()).abs().max())
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask), flush=flush)
        cols = int((pos.long() + 1).sum())
        n_bytes = (cols * h * d * 2            # int8 K and V columns read
                   + q.numel() * q.element_size() * 2      # q in, out
                   + 2 * ks.numel() * 4 + pos.numel() * 4)
        ops = cols * h * d * 4                 # q.k and p.v, mul + add
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S
                    >= ops / F32_FLOPS else "operations")
        emit("kernels", kernel="decode_attention", case=case, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
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
    emit("serve", model="137m", params=n_params, build_s=build_s,
         requests=len(reqs), new_tokens=32 * len(reqs), wall_s=wall,
         decode_steps=steps, decode_attention_launches=launches,
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
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: ptxas_summary(log) for name, log in logs.items()})
    entry = kernels_phase()
    kv_merge_phase()
    check_phase()
    entry["launches"] = serve_phase()
    if not entry["launches"]:
        raise AssertionError("decode_attention never launched on the main path")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
