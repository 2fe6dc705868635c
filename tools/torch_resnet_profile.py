#!/usr/bin/env python3
"""Where the port's ResNet-50 training time goes on one NVIDIA GPU.

    python3 tools/torch_resnet_profile.py [--trace out.json]

Builds ResNet-50 (``ResNet(1000, {"depth": 50, "shortcutType": "B"})``,
random weights from seed 0) on the card and runs the step that
``Optimizer.optimize()`` runs (``make_train_step`` with
``CrossEntropyCriterion``, SGD 0.1 / momentum 0.9 / weight decay 1e-4,
bf16 compute; the recipe of ``bench.py:33-67``) on one seeded batch of
256 images at 224². For the fused model (``maybe_fuse`` with
``BIGDL_PALLAS_MIN_C=128``) and for the unfused ``Graph``, two JSON lines
each:

* ``timed`` — 2 warm steps, then 5 steps on the host clock, each ending in
  the loss read (the optimizer's one sync per step), and peak memory;
* ``profile`` — 2 more steps under ``torch.profiler``: wall time, device
  busy time, the device's idle share, launches per step, and device time
  by kernel group (the three fused-conv kernels and their partial sums,
  cuDNN convolutions, matmuls, elementwise, reductions, pooling, copies,
  the optimizer's foreach updates) and by top kernel.

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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_training_profile import _timed, _window  # noqa: E402

B = 256

# kernel-name fragments of each group, first match wins (the fused-conv
# kernels come first: cuDNN's own kernels are also called dgrad/wgrad)
GROUPS = [("fused_conv fwd", ("::fwd_kernel<",)),
          ("fused_conv dgrad", ("::dgrad_kernel<",)),
          ("fused_conv wgrad", ("::wgrad_kernel<",)),
          ("fused_conv partial sums", ("::sum_rows<",)),
          ("layout transform (cuDNN)", ("nchwtonhwc", "nhwctonchw")),
          ("convolution (cuDNN)", ("implicit_gemm", "conv", "fprop",
                                   "wgrad", "dgrad", "cudnn")),
          ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
          ("pooling", ("pool",)),
          ("foreach (optimizer)", ("foreach", "multi_tensor")),
          ("reduction", ("reduce", "softmax", "logsumexp", "norm")),
          ("copy/cast", ("copy", "cast", "convert", "transpose")),
          ("elementwise", ("elementwise", "vectorized", "unrolled"))]


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _step_fn(fuse: bool):
    import torch

    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.tpu_fusion import maybe_fuse
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    model = ResNet(1000, {"depth": 50, "shortcutType": "B"}, seed=0)
    if fuse:
        model = maybe_fuse(model)
    model.train()
    opt = SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, CrossEntropyCriterion(), opt,
                           compute_dtype="bf16")
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    carry = [params, opt.init_state(params)]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (B, 3, 224, 224), dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(1, 1001, size=B).astype(
        np.int32)).cuda()

    def run() -> float:
        carry[0], carry[1], _, loss = step(carry[0], carry[1], state, None,
                                           x, y)
        return float(loss)

    return run


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", help="write the fused run's chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    os.environ["BIGDL_PALLAS_MIN_C"] = "128"
    for fuse in (True, False):
        name = "fused" if fuse else "unfused"
        run = _step_fn(fuse)
        torch.cuda.reset_peak_memory_stats()
        ms = _timed(run, warm=2, n=5)
        p50 = float(np.median(ms))
        print(json.dumps({"run": name, "what": "timed", "device": card,
                          "step_ms": ms, "step_ms_p50": p50,
                          "images_per_s": B / (p50 / 1e3),
                          "peak_mem_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30}), flush=True)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps({"run": name, "what": "profile",
                          **_window(prof, wall, 2, _group)}), flush=True)
        if args.trace and fuse:
            prof.export_chrome_trace(args.trace)
        del run, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
