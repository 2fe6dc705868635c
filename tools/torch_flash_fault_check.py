#!/usr/bin/env python3
"""Planted faults against the flash kernels' comparison rule, on one
NVIDIA GPU.

    python3 tools/torch_flash_fault_check.py [--out faults.json]

Builds ``bigdl_tpu_torch/csrc/flash_attention.cu`` as it is and in one
copy per fault below, each copy with one fault planted by a string
replacement, in a temporary directory (the repository's source is never
written). Every build runs ``chip_smoke.py``'s flash cases in bf16 (the
main path's dtype; the unmutated build in f32 too), and every output (O,
dq, dk, dv) is compared with the plain version under two rules:

* tensor-wide: max abs error <= 2e-2 x the tensor's largest |plain|;
* per row (what ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold
  the kernels to): ``flash_attention.max_row_rel_err`` <= ``ROW_RTOL``;

and LSE within 1e-4 under both. One JSON line per (build, case, dtype)
with each output's readings as a ratio to its limit (a rule holds when
every ratio is <= 1), then a summary line per build. Exits non-zero when
the unmutated build fails the per-row rule or a faulty build passes it in
every case. It imports neither jax nor the JAX package; with no card it
exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TENSOR_RTOL = 2e-2
LSE_TOL = 1e-4

# name -> (what the fault does, source text, replacement); each source text
# occurs once in the kernel file
FAULTS = {
    "fwd_no_rescale": (
        "forward: the accumulator is not rescaled when the running max "
        "grows (l still is)",
        "acc[4 * n + e] *= alpha[e >> 1];",
        "acc[4 * n + e] *= 1.f;"),
    "fwd_stale_v": (
        "forward: V tiles from key 512 on are tile 7's",
        "      wg::tma_load_4d(sm + L::kV + at, &tv, full + s, 64 * p, h, t0, "
        "b);\n",
        "      const int vt = j < 8 ? j : 7;\n"
        "      wg::tma_load_4d(sm + L::kV + at, &tv, full + s, 64 * p, h,\n"
        "                      vt * kFwdKeys, b);\n"),
    "dq_stale_k": (
        "dq: K tiles from key 512 on are tile 7's",
        "      wg::tma_load_4d(sm + L::kK + at, &tk, full + s, 64 * p, h, "
        "j * kN, b);\n",
        "      wg::tma_load_4d(sm + L::kK + at, &tk, full + s, 64 * p, h,\n"
        "                      (j < 8 ? j : 7) * kN, b);\n"),
    "dkv_stale_do": (
        "dk/dv: dO tiles from query 512 on are tile 7's",
        "        wg::tma_load_4d(sm + L::kDO + at, &tdo, full + s, 64 * p, h, "
        "t0, b);\n",
        "        wg::tma_load_4d(sm + L::kDO + at, &tdo, full + s, 64 * p, h,\n"
        "                        (qt < 8 ? qt : 7) * QN, b);\n"),
    "dkv_stale_delta": (
        "dk/dv: a stale delta: in the last 64 query rows (1984 on) the dq "
        "kernel writes rows r + 8 with the delta of row r, so dk/dv reads "
        "the wrong delta for half of them",
        "delta[static_cast<size_t>(bh) * Tq + row] = dl[i];",
        "delta[static_cast<size_t>(bh) * Tq + row] =\n"
        "          row >= 1984 && i == 1 ? dl[0] : dl[i];"),
}


def _last_tile(name: str, loop: str):
    """The stale-tile fault ``name`` confined to the last tile of the main
    case (T = 2048 is 32 tiles): a small error in rows whose values are
    small."""
    what, old, new = FAULTS[name]
    what = (what.replace("from key 512 on", "of the last key tile")
            .replace("from query 512 on", "of the last query tile")
            .replace("tile 7", "tile 30"))
    return what, old, new.replace(f"{loop} < 8 ? {loop} : 7",
                                  f"{loop} < 31 ? {loop} : 30")


FAULTS.update({f"{n}_last": _last_tile(n, loop) for n, loop in (
    ("fwd_stale_v", "j"), ("dq_stale_k", "j"), ("dkv_stale_do", "qt"))})


def build_all(tmp: str) -> dict:
    """One ``nvcc`` per build, all started together; returns name ->
    bound library."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.utils import cuda_build

    with open(os.path.join(cuda_build.CSRC, "flash_attention.cu")) as f:
        source = f.read()
    jobs = {}
    for name, (_, old, new) in [("unmutated", (None, "", ""))] + list(
            FAULTS.items()):
        if old:
            if source.count(old) != 1:
                raise RuntimeError(f"fault {name}: its source text occurs "
                                   f"{source.count(old)} times, not once")
            text = source.replace(old, new)
        else:
            text = source
        src = os.path.join(tmp, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(tmp, f"lib{name}.so")
        jobs[name] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = fa.bind(ctypes.CDLL(lib))
    return libs


def readings(outs, lse, lse_ref, rtol) -> dict:
    from bigdl_tpu_torch.ops import flash_attention as fa

    r = {}
    for name, (got, want) in outs.items():
        err = float((got.float() - want.float()).abs().max())
        r[name] = {
            "max_abs_err": err,
            "tensor_ratio": err / (TENSOR_RTOL
                                   * float(want.float().abs().max())),
            "row_rel_err": fa.max_row_rel_err(got, want),
            "row_ratio": fa.max_row_rel_err(got, want) / rtol}
    r["lse_ratio"] = float((lse - lse_ref).abs().max()) / LSE_TOL
    return r


def holds(r: dict, key: str) -> bool:
    return r["lse_ratio"] <= 1 and all(
        v[key] <= 1 for k, v in r.items() if k != "lse_ratio")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import FLASH_CASES, flash_inputs, nvidia_smi

    from bigdl_tpu_torch.ops import flash_attention as fa

    lines = [{"card": nvidia_smi()}]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        verdict = {n: {"tensor_wide": True, "per_row": True} for n in libs}
        saved = list(fa._LIB)
        try:
            for dtype in (torch.bfloat16, torch.float32):
                rtol = fa.ROW_RTOL[dtype]
                for i, (case, b, tq, tk, h, d, causal, off) in enumerate(
                        FLASH_CASES):
                    q, k, v, do = flash_inputs(i, dtype)
                    scale = d ** -0.5
                    o_ref, lse_ref = fa.flash_forward_reference(
                        q, k, v, scale, causal, off)
                    refs = fa.flash_backward_reference(
                        q, k, v, o_ref, lse_ref, do, scale, causal, off)
                    for name, lib in libs.items():
                        if dtype == torch.float32 and name != "unmutated":
                            continue   # the faults sit in the bf16 kernels
                        fa._LIB[:] = [lib]
                        o, lse = fa.flash_fwd_cuda(q, k, v, scale, causal,
                                                   off)
                        got = fa.flash_bwd_cuda(q, k, v, o_ref, lse_ref, do,
                                                scale, causal, off)
                        torch.cuda.synchronize()
                        r = readings({"o": (o, o_ref), "dq": (got[0], refs[0]),
                                      "dk": (got[1], refs[1]),
                                      "dv": (got[2], refs[2])},
                                     lse, lse_ref, rtol)
                        line = {"build": name, "case": case,
                                "dtype": str(dtype).split(".")[-1],
                                "rtol": rtol, "tensor_wide_holds":
                                holds(r, "tensor_ratio"),
                                "per_row_holds": holds(r, "row_ratio"), **r}
                        verdict[name]["tensor_wide"] &= line[
                            "tensor_wide_holds"]
                        verdict[name]["per_row"] &= line["per_row_holds"]
                        lines.append(line)
                        print(json.dumps(line), flush=True)
                    del q, k, v, do, o_ref, lse_ref, refs
        finally:
            fa._LIB[:] = saved
    for name, v in verdict.items():
        line = {"summary": name,
                "fault": FAULTS[name][0] if name in FAULTS else None,
                "tensor_wide_holds_in_every_case": v["tensor_wide"],
                "per_row_holds_in_every_case": v["per_row"]}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    ok = verdict["unmutated"]["per_row"] and not any(
        v["per_row"] for n, v in verdict.items() if n != "unmutated")
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
