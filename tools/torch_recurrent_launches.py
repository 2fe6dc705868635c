#!/usr/bin/env python3
"""What the text classifier's BiRecurrent LSTM step launches, for
holding the recurrent path of two checkouts to the same count.

    python3 tools/torch_recurrent_launches.py [--repo DIR] [--device cuda|cpu]

Imports ``bigdl_tpu_torch`` from DIR (default: the checkout holding this
script) and runs ``chip_smoke.py``'s textclassifier window with it: the
model of ``train_main``'s defaults (vocab 500, seqLen 50, 5 classes,
embedding 64, hidden 128, a fixed seed), two ``Optimizer`` iterations of
``Adagrad(0.05)`` at batch 32 on 96 synthetic samples, after one warm-up
window. On ``cuda`` it prints, three times, the device launches per step
as ``torch.profiler`` records them (this checkout's
``chip_smoke.window_counts``) and per time step and direction (/ 100);
on ``cpu`` the aten operations of the two steps, which do not depend on
the profiler's device records. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import collections
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=HERE)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.models.textclassifier import (
        TextClassifier, synthetic_samples,
    )
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adagrad

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cpu":
        torch.set_num_threads(1)
    model = TextClassifier(5, embedding_dim=64, vocab_size=500,
                           embedding_input=False, device=args.device,
                           generator=torch.Generator(args.device)
                           .manual_seed(5))
    window = cs.optimizer_window(model.train(),
                                 synthetic_samples(96, 500, 5, 50),
                                 ClassNLLCriterion(), Adagrad(0.05), 32, 2)
    window()
    if args.device == "cpu":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            window()
        ops = collections.Counter(e.name for e in prof.events()
                                  if e.name.startswith("aten::"))
        print(json.dumps({"repo": repo, "device": "cpu",
                          "aten_ops_two_steps": sum(ops.values())}))
        return 0
    card = cs.nvidia_smi()
    for _ in range(3):
        n = cs.window_counts(window, "textclassifier_train", 2)[
            "device_launches"]
        print(json.dumps({"repo": repo, "card": card, "per_step": n,
                          "per_time_step_and_direction": n / 100}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
