"""Where LeNet-5's card and CPU training runs part, step by step.

Trains the port's LeNet-5 (seeded weights, the first 20 normalized
MNIST-sized batches that ``chip_smoke.py``'s lenet phase uses) through the
port's train step on the CPU and prints, per step, the smallest gap
between the top two inputs of any 2x2 max-pool window: a gap near the
rounding difference between two devices is a window whose choice, and so
whose gradient's route, either device may take. With ``--device cuda`` it
then repeats the run on the card, with ``cudnn.deterministic`` off and on,
and prints per step the largest parameter difference from the CPU run and
the number of pool windows that chose differently; then the lenet phase's
own Optimizer run (another batch order) repeated; then both in float64.

    python tools/torch_lenet_card_vs_cpu.py --device cuda --reps 12
    python tools/torch_lenet_card_vs_cpu.py --device cpu      # gaps only
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bigdl_tpu_torch.dataset import DataSet, MiniBatch, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import mnist  # noqa: E402
from bigdl_tpu_torch.dataset.image import GreyImgNormalizer  # noqa: E402
from bigdl_tpu_torch.models.lenet import LeNet5  # noqa: E402
from bigdl_tpu_torch.nn import ClassNLLCriterion  # noqa: E402
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger  # noqa: E402
from bigdl_tpu_torch.optim.train_step import make_train_step  # noqa: E402


def pool_windows(x):
    """(n, c, h, w) -> (n, c, h/2, w/2, 4): each 2x2 window's inputs."""
    n, c, h, w = x.shape
    return (x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
            .reshape(n, c, h // 2, w // 2, 4))


def trajectory(model, batches, crit):
    """Losses, parameters after each step (float64 on the CPU), and each
    step's pool choices and smallest top-two gap per pool."""
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(pool_windows(inp[0].detach())))
        for m in model.modules() if type(m).__name__ == "SpatialMaxPooling"]
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = {k: b.detach().clone() for k, b in model.named_buffers()}
    method = SGD(learning_rate=0.05, momentum=0.9)
    opt = method.init_state(params)
    step = make_train_step(model.train(), crit, method)
    losses, snaps, choices, gaps = [], [], [], []
    for b in batches:
        seen.clear()
        x = torch.as_tensor(np.asarray(b.get_input())).to(dev, dtype)
        y = torch.as_tensor(np.asarray(b.get_target())).to(dev)
        params, opt, state, loss = step(params, opt, state, None, x, y)
        losses.append(float(loss))
        snaps.append({k: v.detach().to("cpu", torch.float64, copy=True)
                      for k, v in params.items()})
        choices.append([w.argmax(-1).cpu() for w in seen])
        top = [w.sort(-1, descending=True).values for w in seen]
        gaps.append([float((t[..., 0] - t[..., 1]).min()) for t in top])
    for h in hooks:
        h.remove()
    return losses, snaps, choices, gaps


def against(ref, got):
    _, rs, rc, _ = ref
    _, gs, gc, _ = got
    err = [max(float((g[k] - r[k]).abs().max()) for k in r)
           for r, g in zip(rs, gs)]
    flips = [sum(int((a != b).sum()) for a, b in zip(r, g))
             for r, g in zip(rc, gc)]
    return {"final_err": err[-1], "per_step_err": err, "flips": flips,
            "first_flip_step": next((i for i, f in enumerate(flips) if f),
                                    None)}


def optimizer_err(base, batches, crit, steps, dtype):
    """The lenet phase's card-vs-CPU run: ``steps`` Optimizer iterations
    from ``base``'s weights on each device; the largest parameter gap."""
    cast = [MiniBatch(np.asarray(b.get_input(), dtype=dtype), b.get_target())
            for b in batches]
    models = []
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(base).to(dev, getattr(torch, np.dtype(dtype).name))
        o = Optimizer(m, DataSet.array(cast), crit,
                      end_trigger=Trigger.max_iteration(steps))
        o.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
        o.optimize()
        models.append(m)
    return max(float((a.detach() - b.detach().cpu()).abs().max())
               for a, b in zip(*(m.parameters() for m in models)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="lenet_gaps_")
    try:
        mnist.generate_idx_dataset(work, n_train=60000, n_test=16, seed=7,
                                   noise=220.0)
        samples = mnist.load_samples(work, "train", synthetic_fallback=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    batches = [b for _, b in zip(range(args.steps), (
        DataSet.array(samples)
        >> GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
        >> SampleToMiniBatch(128)).data(train=True))]
    crit = ClassNLLCriterion()
    base = LeNet5(10, device="cpu", generator=torch.Generator().manual_seed(11))
    ref = trajectory(copy.deepcopy(base), batches, crit)
    print(json.dumps({"cpu_pool_min_gap_per_step": ref[3]}), flush=True)
    if args.device == "cpu":
        return 0
    from chip_smoke import nvidia_smi

    print(json.dumps({"card": nvidia_smi()}), flush=True)
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        for rep in range(args.reps):
            got = trajectory(copy.deepcopy(base).to("cuda"), batches, crit)
            print(json.dumps({"f32": True, "deterministic": det, "rep": rep,
                              **against(ref, got)}), flush=True)
    torch.backends.cudnn.deterministic = False
    print(json.dumps({"optimizer_f32_errs": [
        optimizer_err(base, batches, crit, args.steps, np.float32)
        for _ in range(args.reps)]}), flush=True)
    b64 = copy.deepcopy(base).double()
    ref64 = trajectory(copy.deepcopy(b64), batches, crit)
    got64 = against(ref64, trajectory(copy.deepcopy(b64).to("cuda"),
                                      batches, crit))
    print(json.dumps({"f64": True, **got64,
                      "optimizer_f64_err": optimizer_err(
                          base, batches, crit, args.steps, np.float64)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
