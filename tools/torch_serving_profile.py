#!/usr/bin/env python3
"""Where the port's serving time goes on one NVIDIA GPU.

    python3 tools/torch_serving_profile.py [--trace out.json]

Builds the 137m TransformerLM (vocab 32768, hidden 768, 12 layers, 12
heads, max_len 512; random weights from seed 0) on the card, serves it
bf16 with int8 KV through ``bigdl_tpu_torch.serving.ServingEngine`` with
16 slots, warms up, submits 16 requests (prompts of 16-256 tokens from seed 1, 16
new tokens each) and traces two windows under ``torch.profiler``: the
first ``step()`` (admission: the bucketed prefills plus one decode step)
and the next 8 steps (pure decode, all 16 slots running). One JSON line
per window: wall time, device busy time (the kernels' device intervals,
overlaps merged), the device's idle share, kernel launches per step,
host synchronisation calls, the decode-attention kernel's share, and the
top kernels by device time.

It imports neither jax nor the JAX package. Run it on the card; with no
card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _window(name, prof, wall, steps):
    """Print one traced window: busy/idle, launches, top kernels."""
    import torch

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:                        # merge overlapping intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy_s = busy / 1e6                       # profiler times are in us
    syncs = sum(1 for e in prof.events()
                if e.name in ("cudaStreamSynchronize",
                              "cudaDeviceSynchronize", "cudaMemcpyAsync"))
    by_name = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    total = sum(t for t, _ in by_name.values()) or 1.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    da = [v for k, v in by_name.items() if "decode_attention" in k]
    print(json.dumps({
        "window": name, "steps": steps, "wall_s": wall,
        "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
        "kernel_launches": len(events),
        "launches_per_step": len(events) / max(steps, 1),
        "sync_or_copy_calls": syncs,
        "decode_attention_ms": sum(t for t, _ in da) / 1e3,
        "decode_attention_calls": sum(n for _, n in da),
        "decode_attention_share": sum(t for t, _ in da) / total,
        "top": [{"name": k[:80], "device_ms": t / 1e3, "calls": n,
                 "share": t / total} for k, (t, n) in top]}))


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the decode window's chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    V = 32768
    lm = TransformerLM(V, hidden_size=768, n_heads=12, n_layers=12,
                       max_len=512, output="logits", seed=0)
    lm.evaluate()
    rng = np.random.default_rng(1)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def engine():
        eng = ServingEngine(lm, n_slots=16, compute_dtype=torch.bfloat16,
                            kv_dtype="int8")
        for _ in range(16):
            p = rng.integers(1, V + 1, size=int(rng.integers(16, 257)))
            eng.submit(p.tolist(), max_new_tokens=16)
        return eng

    with torch.no_grad():
        engine().drain()                      # warm-up
        torch.cuda.synchronize()
        eng = engine()
        for name, n_steps in (("admission", 1), ("decode", 8)):
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _window(name, prof, wall, n_steps)
        if args.trace:
            prof.export_chrome_trace(args.trace)
        eng.drain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
