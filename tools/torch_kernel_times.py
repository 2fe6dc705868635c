#!/usr/bin/env python3
"""Device times of the port's decode-attention and fused-conv kernels at
their main-path shapes, for comparing two checkouts in one run.

    python3 tools/torch_kernel_times.py [--repo DIR] [--reps N]

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
  beside its unfused PyTorch sequence.

One JSON line per kernel: median, mean, min and max in ms over N launches,
the least time the card could take (bound) and the share of it reached by
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
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
    decode(cs, args.reps, flush)
    fused(cs, args.reps, flush)
    print(json.dumps({"guard_ms": cs.guard_ms(),
                      "host_enqueue": cs.HOST_ENQUEUE}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
