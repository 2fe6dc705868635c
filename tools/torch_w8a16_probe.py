#!/usr/bin/env python3
"""Where the W8A16 prefill kernel's time goes: device times of
``w8a16_wgmma`` built four ways from ``bigdl_tpu_torch/csrc/w8a16.cu``.

    python3 tools/torch_w8a16_probe.py [--reps N] [--out DIR]

* ``base``: the kernel as the package builds it;
* ``no_convert`` (``-DW8_NO_CONVERT``): the A fragments are constants, so
  no int8 code is read from shared memory or converted;
* ``no_mma`` (``-DW8_NO_MMA``): no wgmma is issued (the fragments feed a
  plain add, so the conversion is kept);
* ``neither``: both, leaving the TMA ring, the barriers and the epilogue.

Each runs at the 137m LM's prefill shapes (M 2048; fc1, fc2 and the head,
bf16 x, output and bias) with the package's plan, timed by
``torch.profiler`` (``chip_smoke.device_us``: kernel time on the card,
the L2 flushed before each launch), with cuBLAS's bf16 ``F.linear`` on a pre-cast weight beside it.
The probe builds give wrong outputs on purpose and are never loaded by
the package: they go into ``--out`` (default ``chiprun_out/w8a16_probe``).
One JSON line per shape. Needs one CUDA card; imports neither jax nor the
JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"base": [], "no_convert": ["-DW8_NO_CONVERT"],
            "no_mma": ["-DW8_NO_MMA"],
            "neither": ["-DW8_NO_CONVERT", "-DW8_NO_MMA"]}
SHAPES = (("fc1", 768, 3072), ("fc2", 3072, 768), ("head", 768, 32768))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "w8a16_probe"))
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops import w8a16 as w8
    from bigdl_tpu_torch.utils import cuda_build

    os.makedirs(args.out, exist_ok=True)
    src = os.path.join(cuda_build.CSRC, "w8a16.cu")
    jobs = {name: subprocess.Popen(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
         os.path.join(args.out, f"libw8a16_{name}.so"), src])
        for name, flags in VARIANTS.items()}
    if any(job.wait() != 0 for job in jobs.values()):
        print("a probe build failed", file=sys.stderr)
        return 1
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(args.out, f"libw8a16_{name}.so"))
        lib.bigdl_w8a16.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.bigdl_w8a16.restype = ctypes.c_int
        libs[name] = lib
    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, m = torch.bfloat16, 2048
    for name, k, n in SHAPES:
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           device="cuda", generator=g)
        scale = torch.rand(n, 1, device="cuda", generator=g) * 2e-3 + 1e-4
        x = torch.randn(m, k, device="cuda", generator=g).to(bf16)
        bias = torch.randn(n, device="cuda", generator=g).to(bf16)
        out = torch.empty(m, n, dtype=bf16, device="cuda")
        plan = w8.launch_plan(m, n, k, sms)
        rec = {"shape": name, "m": m, "k": k, "n": n, "plan": plan._asdict()}
        for vname, lib in libs.items():
            def call(lib=lib, vname=vname):
                err = lib.bigdl_w8a16(
                    x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), m, n, k,
                    w8.REGIMES[plan.regime], plan.bn, plan.splits,
                    plan.k_split, plan.stage_k, plan.ring, 1, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{vname}: cudaError {err}")
            rec[f"{vname}_us"] = cs.device_us(call, flush, args.reps)
        w_bf16 = wq.to(bf16)
        rec["cublas_bf16_us"] = cs.device_us(
            lambda: F.linear(x, w_bf16, bias), flush, args.reps)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
