"""``Optimizer.handle_preemption``, ``TrainingPreempted`` and
``Optimizer.set_profile`` of the port on the CPU, twins of
``tests/test_observability.py``'s preemption, checkpoint-guard and
profiler tests.

The preemption run is a real eviction: a worker process that imports
only ``bigdl_tpu_torch`` trains until the parent sends SIGTERM, writes its
checkpoint at the iteration it stopped at and exits with
``TrainingPreempted``; the parent resumes from that checkpoint and must
end bitwise equal to an uninterrupted run (f32 on the CPU, the same
operations in the same order)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL = """
import numpy as np
import torch
from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.nn import (
    ClassNLLCriterion, Linear, LogSoftMax, ReLU, Sequential,
)
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger


def make(end, ckpt=None):
    torch.manual_seed(5)
    model = (Sequential().add(Linear(4, 8, device="cpu")).add(ReLU())
             .add(Linear(8, 3, device="cpu")).add(LogSoftMax()))
    rs = np.random.RandomState(0)
    samples = [Sample(rs.randn(4).astype(np.float32),
                      np.float32(rs.randint(1, 4))) for _ in range(40)]
    opt = Optimizer(model=model, dataset=DataSet.array(samples),
                    criterion=ClassNLLCriterion(), batch_size=10,
                    end_trigger=end)
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger(lambda s: False))
    return model, opt
"""

WORKER = MODEL + """
import sys, time
from bigdl_tpu_torch.optim import TrainingPreempted


def report(s):
    print("STEP", s["neval"], flush=True)
    time.sleep(0.05)           # the parent's SIGTERM lands mid-run
    return s["neval"] > 100000


model, opt = make(Trigger(report, lambda s: s["neval"] > 100000),
                  ckpt=sys.argv[1])
opt.handle_preemption()
try:
    opt.optimize()
    print("NOT_PREEMPTED", flush=True)
    sys.exit(1)
except TrainingPreempted as e:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
    print("PREEMPTED", opt.optim_method.state["neval"], bad, e, flush=True)
    sys.exit(7)
"""


def _model_module():
    scope = {}
    exec(compile(MODEL, "model", "exec"), scope)
    return scope["make"]


def test_sigterm_checkpoints_raises_and_resumes_bitwise(tmp_path):
    from bigdl_tpu_torch.optim import Trigger

    ckpt = str(tmp_path / "ckpt")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen([sys.executable, str(script), ckpt], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline, line = time.time() + 120, ""
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.strip() == "STEP 3" or (line == "" and
                                            proc.poll() is not None):
                break
        assert line.strip() == "STEP 3", f"the loop never reached step 3: " \
            f"{line}"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 7, out
    words = next(ln for ln in out.splitlines()
                 if ln.startswith("PREEMPTED")).split()
    stop, bad = int(words[1]), words[2]
    assert bad == "[]"                       # bigdl_tpu_torch only
    assert stop >= 3 and f"evicted at iteration {stop}" in out
    assert sorted(os.listdir(ckpt)) == ["model", "optimMethod"]

    make = _model_module()
    model, opt = make(Trigger.max_iteration(stop + 4), ckpt=ckpt)
    snap = opt._latest_checkpoint()
    assert snap[1]["neval"] == stop          # the iteration it stopped at
    opt.optimize(resume=True)
    assert opt.optim_method.state["neval"] == stop + 5
    ref, ref_opt = make(Trigger.max_iteration(stop + 4))
    ref_opt.optimize()
    for (k, a), b in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), k


def test_handle_preemption_requires_a_checkpoint():
    from bigdl_tpu_torch.optim import Trigger

    model, opt = _model_module()(Trigger.max_iteration(1))
    assert opt.handle_preemption() is opt
    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(ValueError, match="set_checkpoint"):
        opt.optimize()
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))
    opt.handle_preemption(False)
    opt.optimize()                          # disabled: no guard


def test_the_sigterm_handler_is_restored_and_main_thread_only(tmp_path,
                                                             caplog):
    import logging

    from bigdl_tpu_torch.optim import Trigger

    def mine(signum, frame):
        pass

    prev = signal.signal(signal.SIGTERM, mine)
    try:
        _, opt = _model_module()(Trigger.max_iteration(2),
                                 ckpt=str(tmp_path / "a"))
        opt.handle_preemption().optimize()
        assert signal.getsignal(signal.SIGTERM) is mine

        class Boom(RuntimeError):
            pass

        def boom(s):
            if s["neval"] == 2:
                raise Boom()
            return False

        _, opt = _model_module()(Trigger(boom), ckpt=str(tmp_path / "b"))
        with pytest.raises(Boom):
            opt.handle_preemption().optimize()
        assert signal.getsignal(signal.SIGTERM) is mine
        # off the main thread the hook is not installed; training runs
        _, opt = _model_module()(Trigger.max_iteration(2),
                                 ckpt=str(tmp_path / "c"))
        opt.handle_preemption()
        errors = []

        def run():
            try:
                opt.optimize()
            except Exception as e:           # reported to the test below
                errors.append(e)

        with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch"):
            t = threading.Thread(target=run)
            t.start()
            t.join(timeout=60)
        assert not t.is_alive() and errors == []
        assert any("not on the main thread" in r.getMessage()
                   for r in caplog.records)
        assert opt.optim_method.state["neval"] == 3
    finally:
        signal.signal(signal.SIGTERM, prev)


def _losses_run(profile_dir=None, start=2, n=2, steps=5):
    from bigdl_tpu_torch.optim import Trigger

    losses = []

    def record(s):
        if s["loss"] is not None:
            losses.append(s["loss"])
        return s["neval"] > steps

    model, opt = _model_module()(
        Trigger(record, Trigger.max_iteration(steps).peek))
    if profile_dir is not None:
        assert opt.set_profile(profile_dir, start_iteration=start,
                               n_iterations=n) is opt
    opt.optimize()
    return losses, model


@pytest.mark.parametrize("start,n", [(2, 2), (4, 10)])
def test_set_profile_writes_a_trace_and_leaves_training_unchanged(
        tmp_path, start, n):
    """(4, 10): the loop ends inside the window, which is closed and
    written at loop exit."""
    d = str(tmp_path / "trace")
    got, gm = _losses_run(d, start, n)
    want, wm = _losses_run()
    assert got == want and len(got) == 5
    assert all(torch.equal(a, b) for a, b in zip(gm.parameters(),
                                                 wm.parameters()))
    (name,) = os.listdir(d)
    assert name == f"iterations_{start}-{start + n - 1}.pt.trace.json"
    with open(os.path.join(d, name)) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)      # Perfetto slices
    assert any("addmm" in e.get("name", "") or "linear" in e.get("name", "")
               for e in events)
