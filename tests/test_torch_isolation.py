"""The port stands alone: ``bigdl_tpu_torch`` (and ``chip_smoke.py`` and
the ``tools/torch_*.py`` scripts, which drive it on the card) import
neither ``jax`` nor anything of the JAX package ``bigdl_tpu`` — jax-free
modules included — nor ``ml_dtypes`` (the card's machine has no jax, so
bf16 crosses the wire by the port's own codec), nor ``PIL``,
``tensorboard`` or ``tensorflow`` (the card's machine has none of them:
the event files are written by the port's own encoder).

Two checks: a fresh interpreter imports every module of the package and
finds no ``jax*`` module and no module whose first dotted part is
``bigdl_tpu`` in ``sys.modules`` (a subprocess, because this test
process has jax loaded through tests/conftest.py; note that
``bigdl_tpu_torch`` itself starts with the letters ``bigdl_tpu``), and an
AST scan of every source file for such imports, lazy ones inside
functions included."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "bigdl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "bigdl_tpu", "ml_dtypes", "PIL", "tensorboard",
             "tensorflow")


def _modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_package_has_the_slice_modules():
    mods = set(_modules())
    for m in ("bigdl_tpu_torch.utils.device", "bigdl_tpu_torch.nn.module",
              "bigdl_tpu_torch.models.transformer",
              "bigdl_tpu_torch.ops.decode_attention",
              "bigdl_tpu_torch.serving.engine",
              "bigdl_tpu_torch.serving.scheduler",
              "bigdl_tpu_torch.serving.faults",
              "bigdl_tpu_torch.serving.prefix_cache",
              "bigdl_tpu_torch.serving.chunked",
              "bigdl_tpu_torch.ops.flash_attention",
              "bigdl_tpu_torch.nn.criterion",
              "bigdl_tpu_torch.nn.criterion_more",
              "bigdl_tpu_torch.optim.optim_method",
              "bigdl_tpu_torch.optim.train_step",
              "bigdl_tpu_torch.optim.trigger",
              "bigdl_tpu_torch.optim.optimizer",
              "bigdl_tpu_torch.dataset.sample",
              "bigdl_tpu_torch.dataset.dataset",
              "bigdl_tpu_torch.dataset.transformer",
              "bigdl_tpu_torch.utils.params_tree",
              "bigdl_tpu_torch.nn.init_methods", "bigdl_tpu_torch.nn.conv",
              "bigdl_tpu_torch.nn.normalization",
              "bigdl_tpu_torch.nn.pooling", "bigdl_tpu_torch.nn.shape_ops",
              "bigdl_tpu_torch.nn.graph", "bigdl_tpu_torch.nn.tpu_fusion",
              "bigdl_tpu_torch.models.resnet",
              "bigdl_tpu_torch.ops.fused_conv",
              "bigdl_tpu_torch.ops.conv3x3",
              "bigdl_tpu_torch.ops.kv_requant",
              "bigdl_tpu_torch.serving.speculative",
              "bigdl_tpu_torch.serving.lora",
              "bigdl_tpu_torch.serving.constrain",
              "bigdl_tpu_torch.parallel.block_store",
              "bigdl_tpu_torch.serving.kv_tier",
              "bigdl_tpu_torch.serving.disagg",
              "bigdl_tpu_torch.parallel.axis",
              "bigdl_tpu_torch.parallel.ring_attention",
              "bigdl_tpu_torch.parallel.tensor_parallel",
              "bigdl_tpu_torch.parallel.pipeline",
              "bigdl_tpu_torch.parallel.moe",
              "bigdl_tpu_torch.serving.health",
              "bigdl_tpu_torch.serving.autopilot",
              "bigdl_tpu_torch.nn.beam_search",
              "bigdl_tpu_torch.models.lenet", "bigdl_tpu_torch.models.utils",
              "bigdl_tpu_torch.dataset.mnist", "bigdl_tpu_torch.dataset.image",
              "bigdl_tpu_torch.optim.validation",
              "bigdl_tpu_torch.optim.evaluator",
              "bigdl_tpu_torch.optim.regularizer",
              "bigdl_tpu_torch.utils.file_io", "bigdl_tpu_torch.utils.engine",
              "bigdl_tpu_torch.utils.protowire",
              "bigdl_tpu_torch.visualization",
              "bigdl_tpu_torch.visualization.tensorboard",
              "bigdl_tpu_torch.visualization.summary",
              "bigdl_tpu_torch.optim.upload",
              "bigdl_tpu_torch.dataset.native_pipeline",
              "bigdl_tpu_torch.dataset.cifar",
              "bigdl_tpu_torch.native", "bigdl_tpu_torch.native.build",
              "bigdl_tpu_torch.native.decode",
              "bigdl_tpu_torch.dataset.seqfile",
              "bigdl_tpu_torch.dataset.hadoop_seqfile",
              "bigdl_tpu_torch.dataset.news20",
              "bigdl_tpu_torch.dataset.text",
              "bigdl_tpu_torch.transform.vision.image"):
        assert m in mods
    for src in ("decode_attention.cu", "flash_attention.cu", "fused_conv.cu",
                "conv3x3.cu", "kv_requant.cu"):
        assert (PKG / "csrc" / src).exists()
    for src in ("bigdl_native.cpp", "bigdl_native.h", "image_decode.cpp"):
        assert (PKG / "native" / "src" / src).exists()


def test_fresh_interpreter_imports_no_jax_and_no_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) > 0


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "tools/torch_serving_profile.py",
       "tools/torch_training_profile.py",
       "tools/torch_flash_fault_check.py", "tools/torch_resnet_profile.py",
       "tools/torch_kernel_times.py", "tools/torch_serving_zoo.py",
       "tools/torch_lenet_card_vs_cpu.py"]))
def test_no_source_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            hits += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                hits.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            hits.append(node.args[0].value)
    assert not hits, f"{path} imports {hits}"
