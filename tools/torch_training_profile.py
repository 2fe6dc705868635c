#!/usr/bin/env python3
"""Where the port's training time goes on one NVIDIA GPU.

    python3 tools/torch_training_profile.py [--trace out.json]

Builds the 137m TransformerLM at the training width (vocab 32768, hidden
768, 12 layers, 12 heads, max_len = T = 2048, ``output="logits"``; random
weights from seed 0) on the card and runs the step that
``Optimizer.optimize()`` runs (``make_train_step`` with
``MaskedSoftmaxCECriterion(0)``, ``Adam(1e-4)``, bf16 compute) on one
seeded batch of 8 sequences. Three JSON lines:

* ``flash`` — 2 warm steps, then 5 steps timed on the host clock, each
  ending in the loss read (the optimizer's one sync per step);
* ``profile`` — 2 more steps under ``torch.profiler``: wall time, device
  busy time (kernel intervals, overlaps merged), the device's idle share,
  launches per step, and device time by kernel group (flash kernels,
  matmuls, elementwise, reductions, the optimizer's foreach updates,
  copies) and by top kernel;
* ``dense`` — the same model with ``use_flash="never"`` (dense attention
  in PyTorch ops, the yardstick), 1 warm + 3 timed steps, and its peak
  memory.

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

V, HIDDEN, LAYERS, HEADS, T, B = 32768, 768, 12, 12, 2048, 8

# kernel-name fragments of each group, first match wins
GROUPS = [("flash_fwd", ("fwd_mma", "fwd_simt")),
          ("flash_dq", ("dq_mma", "dq_simt")),
          ("flash_dkv", ("dkv_mma", "dkv_simt")),
          ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
          ("foreach (optimizer)", ("foreach", "multi_tensor")),
          ("reduction", ("reduce", "softmax", "logsumexp", "norm")),
          ("copy/cast", ("copy", "cast", "convert")),
          ("elementwise", ("elementwise", "vectorized", "unrolled"))]


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _step_fn(use_flash: str):
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.optim.train_step import make_train_step

    lm = TransformerLM(V, hidden_size=HIDDEN, n_heads=HEADS,
                       n_layers=LAYERS, max_len=T, output="logits",
                       use_flash=use_flash, seed=0)
    opt = Adam(learning_rate=1e-4)
    step = make_train_step(lm, MaskedSoftmaxCECriterion(0), opt,
                           compute_dtype="bf16")
    params = {k: p.detach().clone() for k, p in lm.named_parameters()}
    carry = [params, opt.init_state(params)]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, V + 1, size=(B, T)).astype(
        np.int32)).cuda()
    y = torch.from_numpy(rng.integers(1, V + 1, size=(B, T)).astype(
        np.float32)).cuda()
    del lm

    def run() -> float:
        carry[0], carry[1], _, loss = step(carry[0], carry[1], {}, None, x, y)
        return float(loss)

    return run


def _timed(run, warm: int, n: int):
    for _ in range(warm):
        run()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _window(prof, wall, steps, group=_group):
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
    by_name, by_group = {}, {}
    for e in events:
        us = e.time_range.elapsed_us()
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us, n + 1)
        g = group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
    total = sum(by_group.values()) or 1.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"steps": steps, "wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1 - busy_s / wall,
            "launches_per_step": len(events) / steps,
            "groups_ms_per_step": {g: t / 1e3 / steps for g, t in sorted(
                by_group.items(), key=lambda kv: -kv[1])},
            "group_share": {g: t / total for g, t in by_group.items()},
            "top": [{"name": k[:90], "device_ms_per_step": t / 1e3 / steps,
                     "calls_per_step": n / steps} for k, (t, n) in top]}


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the profiled window's chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)

    run = _step_fn("auto")
    torch.cuda.reset_peak_memory_stats()
    ms = _timed(run, warm=2, n=5)
    print(json.dumps({"run": "flash", "device": card, "step_ms": ms,
                      "step_ms_p50": float(np.median(ms)),
                      "tokens_per_s": B * T / (float(np.median(ms)) / 1e3),
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30}), flush=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps({"run": "profile", **_window(prof, wall, 2)}),
          flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    del run
    torch.cuda.empty_cache()

    run = _step_fn("never")
    torch.cuda.reset_peak_memory_stats()
    ms = _timed(run, warm=1, n=3)
    print(json.dumps({"run": "dense", "device": card, "step_ms": ms,
                      "step_ms_p50": float(np.median(ms)),
                      "tokens_per_s": B * T / (float(np.median(ms)) / 1e3),
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2 ** 30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
