#!/usr/bin/env python3
"""Device times of the port's decode-attention, fused-conv, W8A16 and
kv_requant kernels at their main-path shapes, for comparing two checkouts
in one run.

    python3 tools/torch_kernel_times.py [--repo DIR] [--reps N]
        [--only decode,fused,w8a16,kv_requant,int8_decode]

Imports ``bigdl_tpu_torch`` from DIR (default: the checkout holding this
script), builds its kernels, and times them through their public wrappers
with this checkout's ``chip_smoke.py`` (its ``time_stats``, inputs, bounds
and unfused sequences), so two checkouts are timed by one method:

* decode attention at the serving shape (16 rows, cache 512, 12 heads,
  D 64, int8 K/V with per-(row, head) scales, bf16 q and output, int64
  positions as the engine passes them), beside one SDPA call on the
  dequantized bf16 K/V;
* the fused forward, dgrad and wgrad (bf16) at ``chip_smoke.FUSED_CASES``'
  ResNet-50 shapes, the stage-1 join (M 802,816, C 256, K 64, residual,
  y and extra dy) and the stage-4 edge (M 12,544, C 512, K 2048), each
  beside its unfused PyTorch sequence;
* the W8A16 projection at the 137m LM's fc1, fc2 and head at M 1, 16
  (decode) and 2048 (prefill), called as the bf16 serving projection
  calls it, and at ResNet-50's weight-only head (M 256, f32 x, output and
  bias), beside cuBLAS's bf16 ``F.linear`` on a pre-cast weight;
* kv_requant at the decode step's shape (16 rows, 512 positions, 12
  heads, D 64) with no scale grown, every scale grown and a mix;
* the 137m LM's weight-only int8 decode step (``chip_smoke.decode_run``:
  127-token prompt, 256 greedy tokens) at batch 1 and 8: step p50 and
  tok/s.

One JSON line per kernel: median, mean, min and max in ms over N launches
(CUDA events around each launch, the host's enqueue hidden behind a
guard), for W8A16 and kv_requant also ``device_us``, the kernels' own
time by ``torch.profiler`` (without the event pair's launch gap), the
least time the card could take (bound) and the share of it reached by
the median; a last line with the timing guard's device time and the
host's longest enqueue of a timed launch. Needs one CUDA card; imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(name, t, bound_ms, **extra):
    print(json.dumps({"kernel": name, **t, **extra, "bound_ms": bound_ms,
                      "roofline_share": bound_ms / t["median"]}), flush=True)


def decode(cs, reps, flush):
    import torch

    from bigdl_tpu_torch.ops import decode_attention as da

    n, L, h, d = cs.SERVING_DECODE
    q, k, v, pos, ks, vs = cs.attention_inputs("int8", n, L, h, d, seed=0)
    q, pos = q.to(torch.bfloat16), pos.long()
    _, n_bytes, ops = cs.decode_work(q, ks, pos, h, d)
    bound_ms, _ = cs.bound(ops, n_bytes, cs.F32_FLOPS)
    t = cs.time_stats(lambda: da.pooled_decode_attention(
        q, k, v, pos, ks, vs, out_dtype=torch.bfloat16), reps, flush)
    emit("decode_attention", t, bound_ms)
    emit("sdpa_dequantized", cs.time_stats(
        cs.dequantized_sdpa(q, k, v, pos, ks, vs), reps, flush), bound_ms)


def fused(cs, reps, flush):
    import torch

    for i, (case, m, c, k, dt, res, extra) in enumerate(cs.FUSED_CASES):
        if dt != "bf16":
            continue
        dtype = torch.bfloat16
        d = cs.fused_inputs(m, c, k, dtype, seed=200 + i)
        r = d["r"] if res else None
        g = d["dy"] if extra else None
        work = cs.fused_work(m, c, k, 2, res, extra)
        unfused = cs.unfused_sequences(d, dtype, res, extra)
        calls = cs.fused_calls(d, dtype, r, g, extra)
        for name, (kern, _) in calls.items():
            bound_ms, _ = cs.bound(*work[name], cs.BF16_FLOPS)
            emit(f"fused_{name} {case}", cs.time_stats(kern, reps, flush),
                 bound_ms, shape=[m, c, k])
            emit(f"unfused {name} {case}",
                 cs.time_stats(unfused[name], reps, flush), bound_ms,
                 shape=[m, c, k])
        del d, unfused
        torch.cuda.empty_cache()


def w8a16(cs, reps, flush):
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import w8a16 as w8

    g = torch.Generator(device="cuda").manual_seed(21)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(name, m, k, n, bf16) for name, k, n in cs.W8A16_SHAPES
             for m in (1, 16, 2048)]
    cases.append(("resnet50_head", 256, 2048, 1000, f32))
    for name, m, k, n, dt in cases:
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           device="cuda", generator=g)
        scale = torch.rand(n, 1, device="cuda", generator=g) * 2e-3 + 1e-4
        x = torch.randn(m, k, device="cuda", generator=g).to(dt)
        bias = torch.randn(n, device="cuda", generator=g).to(dt)
        n_bytes = (n * k + m * k * x.element_size() + n * 4
                   + n * bias.element_size() + m * n * x.element_size())
        bound_ms, _ = cs.bound(2.0 * m * n * k, n_bytes, cs.BF16_FLOPS)

        def kern():
            return w8.w8a16(x, wq, scale, bias, dt)

        emit(f"w8a16 {name} m{m}", cs.time_stats(kern, reps, flush),
             bound_ms, shape=[m, k, n],
             device_us=cs.device_us(kern, flush, reps))
        w_bf16, xb, bb = wq.to(bf16), x.to(bf16), bias.to(bf16)

        def lib():
            return F.linear(xb, w_bf16, bb)

        emit(f"cublas_bf16 {name} m{m}", cs.time_stats(lib, reps, flush),
             bound_ms, shape=[m, k, n],
             device_us=cs.device_us(lib, flush, reps))
        del w_bf16


def kv_requant(cs, reps, flush):
    from bigdl_tpu_torch.ops import kv_requant as kr

    n, L, h, d = cs.SERVING_DECODE
    for i, case in enumerate(("none", "all", "mixed")):
        kc, vc, ks, vs, ka, va = cs.requant_inputs(case, seed=40 + i)
        grown = int((kr.kv_scale_merge(ks, ka)[2] != 1.0).sum()
                    + (kr.kv_scale_merge(vs, va)[2] != 1.0).sum())
        n_bytes = 8 * n * h * 4 + grown * L * d * 2
        bound_ms, _ = cs.bound(grown * L * d * 2, n_bytes, cs.F32_FLOPS)

        def kern():
            return kr.kv_requant_cuda(kc, vc, ks, vs, ka, va)

        emit(f"kv_requant {case}", cs.time_stats(kern, reps, flush),
             bound_ms, grown_pairs=grown,
             device_us=cs.device_us(kern, flush, reps))


def int8_decode(cs):
    import copy

    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(32768, hidden_size=768, n_heads=12, n_layers=12,
                       max_len=cs.PROMPT_137M + cs.GEN_137M, output="logits",
                       seed=17).evaluate()
    qlm = copy.deepcopy(lm).quantize("weight_only")
    del lm
    for batch in (1, 8):
        tok_s, p50, _, _ = cs.decode_run(qlm, torch.bfloat16, batch)
        print(json.dumps({"int8_decode": f"b{batch}", "step_p50_ms": p50,
                          "tok_s": tok_s}), flush=True)


PARTS = ("decode", "fused", "w8a16", "kv_requant", "int8_decode")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", default=",".join(PARTS),
                    help="comma-separated parts to time, of " +
                         ", ".join(PARTS))
    args = ap.parse_args(argv)
    parts = args.only.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--only takes {PARTS}")
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import bigdl_tpu_torch

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": cs.nvidia_smi(), "package": os.path.dirname(
        bigdl_tpu_torch.__file__)}), flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    if "decode" in parts:
        decode(cs, args.reps, flush)
    if "fused" in parts:
        fused(cs, args.reps, flush)
    if "w8a16" in parts:
        w8a16(cs, args.reps, flush)
    if "kv_requant" in parts:
        kv_requant(cs, args.reps, flush)
    if "int8_decode" in parts:
        int8_decode(cs)
    print(json.dumps({"guard_ms": cs.guard_ms(),
                      "host_enqueue": cs.HOST_ENQUEUE}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
