"""Checkpoints and resume in the port (``Optimizer.set_checkpoint``,
``optimize(resume=True)``, ``utils/file_io.py``, ``OptimMethod.save``/
``load``) against the JAX package on the CPU, and the knobs that stay
refused.

A resumed run must equal the uninterrupted one bitwise (same device,
same operations in the same order: the restore copies the checkpoint's
tensors and the stream is replayed, not skipped). Against JAX the
resumed parameters are held within 2e-6 absolute (f32, a small MLP, lr
0.1 with momentum, sums in other orders).
"""

import os

import jax
import numpy as np
import pytest
import torch
from tests.torch_parity import one_torch_thread  # noqa: F401

N, BATCH = 60, 16          # 4 batches per epoch, the last one crosses it


def _data():
    rng = np.random.default_rng(21)
    xs = rng.standard_normal((N, 6)).astype(np.float32)
    ys = (rng.integers(0, 3, size=N) + 1).astype(np.float32)
    return xs, ys


def _mlp(pkg, seed=None):
    """An MLP with auto-named layers: instance counters in every key."""
    if pkg == "jax":
        from bigdl_tpu.nn import Linear, LogSoftMax, Sequential, Tanh
        from bigdl_tpu.utils.random_gen import RNG

        RNG.set_seed(seed)
        m = (Sequential().add(Linear(6, 16)).add(Tanh()).add(Linear(16, 3))
             .add(LogSoftMax()))
        m._ensure_params()
        return m
    from bigdl_tpu_torch.nn import Linear, LogSoftMax, Sequential, Tanh

    g = torch.Generator().manual_seed(seed if seed is not None else 0)
    return (Sequential().add(Linear(6, 16, device="cpu", generator=g))
            .add(Tanh()).add(Linear(16, 3, device="cpu", generator=g))
            .add(LogSoftMax()))


def _optimizer(pkg, model, iters, ckpt=None, every=3, overwrite=True):
    xs, ys = _data()
    if pkg == "jax":
        from bigdl_tpu.dataset.sample import Sample
        from bigdl_tpu.nn import ClassNLLCriterion
        from bigdl_tpu.optim import SGD, Optimizer, Trigger
    else:
        from bigdl_tpu_torch.dataset import Sample
        from bigdl_tpu_torch.nn import ClassNLLCriterion
        from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    opt = Optimizer(model=model, dataset=[Sample(x, y) for x, y in zip(xs, ys)],
                    criterion=ClassNLLCriterion(), batch_size=BATCH,
                    end_trigger=Trigger.max_iteration(iters))
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.several_iteration(every))
        opt.overwrite_checkpoint = overwrite
    return opt


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def test_checkpoint_names_and_blobs_equal_jax(tmp_path):
    from bigdl_tpu.utils.file_io import File as JFile
    from bigdl_tpu_torch.utils.file_io import File

    for overwrite in (True, False):
        dirs = {p: str(tmp_path / f"{p}_{overwrite}") for p in ("jax", "pt")}
        _optimizer("jax", _mlp("jax", 1), 8, dirs["jax"],
                   overwrite=overwrite).optimize()
        _optimizer("pt", _mlp("pt", 1), 8, dirs["pt"],
                   overwrite=overwrite).optimize()
        jnames = sorted(f for f in os.listdir(dirs["jax"]) if f != "LATEST")
        names = sorted(os.listdir(dirs["pt"]))
        assert names == jnames
        assert names == (["model", "optimMethod"] if overwrite else
                         ["model.4", "model.7", "optimMethod.4",
                          "optimMethod.7"])
        for name in names:
            mine = File.load(os.path.join(dirs["pt"], name))
            theirs = JFile.load(os.path.join(dirs["jax"], name))
            assert set(mine) == set(theirs), name
            for key in ("epoch", "neval", "seen"):
                if key in theirs:
                    assert mine[key] == theirs[key], (name, key)
            if "opt_state" in mine:
                assert set(mine["opt_state"]) == set(theirs["opt_state"])
                assert mine["opt_state"]["neval"] == int(
                    theirs["opt_state"]["neval"])
    opt = _optimizer("pt", _mlp("pt", 1), 1)
    opt.overwrite_checkpoint = False
    assert opt.over_write_checkpoint() is opt and opt.overwrite_checkpoint


@pytest.mark.parametrize("overwrite", [True, False])
def test_resume_equals_the_uninterrupted_run_bitwise(tmp_path, overwrite):
    """Stop after 8 steps (the last checkpoint after step 6: iteration 7,
    32 records into epoch 2), resume into a model rebuilt with other instance
    counters and other initial weights, run to 14: bitwise the
    uninterrupted 14-step run."""
    whole = _mlp("pt", 1)
    _optimizer("pt", whole, 14).optimize()
    ckpt = str(tmp_path / "ckpt")
    _optimizer("pt", _mlp("pt", 1), 8, ckpt, overwrite=overwrite).optimize()
    rebuilt = _mlp("pt", 99)
    assert [k for k, _ in rebuilt.named_parameters()] != [
        k for k, _ in whole.named_parameters()]
    opt = _optimizer("pt", rebuilt, 14, ckpt, overwrite=overwrite)
    snap = opt._latest_checkpoint()
    assert (snap[1]["neval"], snap[1]["epoch"], snap[1]["seen"]) == (7, 2, 32)
    opt.optimize(resume=True)
    assert opt.optim_method.state["neval"] == 15
    for a, b in zip(_params(rebuilt), _params(whole)):
        assert torch.equal(a, b)
    assert opt.metrics.get("computing time")[1] == 8      # steps 7..14


def test_resume_matches_the_jax_resume(tmp_path):
    """Both packages: 8 checkpointed steps from the same weights, then a
    resume to 14 in a rebuilt model."""
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves

    jm = _mlp("jax", 1)
    tm = _mlp("pt")
    load_jax_tree(tm, jax.device_get(jm.params))
    for pkg, model in (("jax", jm), ("pt", tm)):
        _optimizer(pkg, model, 8, str(tmp_path / pkg)).optimize()
    jr, tr = _mlp("jax", 5), _mlp("pt", 5)
    _optimizer("jax", jr, 14, str(tmp_path / "jax")).optimize(resume=True)
    _optimizer("pt", tr, 14, str(tmp_path / "pt")).optimize(resume=True)
    want = named_leaves(tr, jax.device_get(jr.params))
    for k, p in tr.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=2e-6,
                                   rtol=0, err_msg=k)


def test_module_load_opens_a_checkpoint_and_optim_method_round_trips(
        tmp_path):
    from bigdl_tpu_torch.nn.module import AbstractModule
    from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod, Step

    ckpt = str(tmp_path / "ckpt")
    model = _mlp("pt", 3)
    opt = _optimizer("pt", model, 6, ckpt)
    opt.optimize()                    # the checkpoint after the last step
    back = AbstractModule.load(os.path.join(ckpt, "model"), device="cpu")
    for a, b in zip(_params(back), _params(model)):
        assert torch.equal(a, b)
    m = SGD(0.3, momentum=0.5, learning_rate_schedule=Step(4, 0.1))
    m.state["neval"] = 12
    path = str(tmp_path / "sgd")
    assert m.save(path) is m
    with pytest.raises(FileExistsError):
        m.save(path)
    m2 = OptimMethod.load(path)
    assert (type(m2), m2.learning_rate, m2.momentum, m2.state["neval"]) == (
        SGD, 0.3, 0.5, 12)
    assert m2.learning_rate_schedule.lr(0.3, 9) == m.learning_rate_schedule.lr(
        0.3, 9)
    assert m2.clear_history() is m2 and m2.state == {"epoch": 1, "neval": 1}


def test_resume_refuses_another_architecture(tmp_path):
    from bigdl_tpu_torch.nn import Linear, LogSoftMax, Sequential

    ckpt = str(tmp_path / "ckpt")
    _optimizer("pt", _mlp("pt", 1), 4, ckpt).optimize()
    other = (Sequential().add(Linear(6, 3, device="cpu"))
             .add(LogSoftMax()))
    with pytest.raises(ValueError, match="different architecture"):
        _optimizer("pt", other, 8, ckpt).optimize(resume=True)
    # no checkpoint under the path: a fresh start, as in JAX
    fresh = _optimizer("pt", _mlp("pt", 1), 2, str(tmp_path / "empty"))
    fresh.optimize(resume=True)
    assert fresh.optim_method.state["neval"] == 3


def test_file_io_moves_tensors_to_the_host_and_drops_generators(tmp_path):
    from bigdl_tpu_torch.utils.file_io import File

    t = torch.nn.Parameter(torch.arange(4.0))
    blob = {"a": t, "b": t, "g": torch.Generator().manual_seed(1), "n": 3}
    path = str(tmp_path / "d" / "blob")
    File.save(blob, path)
    assert os.listdir(tmp_path / "d") == ["blob"]     # no temporary left
    back = File.load(path)
    assert back["a"] is back["b"] and isinstance(back["a"],
                                                 torch.nn.Parameter)
    assert torch.equal(back["a"], t) and back["g"] is None and back["n"] == 3
    with pytest.raises(FileExistsError):
        File.save(blob, path)


def test_refused_knobs_and_checkpoint_dialects(tmp_path):
    from bigdl_tpu_torch.optim import Trigger

    opt = _optimizer("pt", _mlp("pt", 1), 2)
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

    # the five knobs are ported: each returns the optimizer
    for name, arg in (
            ("set_train_summary", TrainSummary(str(tmp_path), "app")),
            ("set_val_summary", ValidationSummary(str(tmp_path), "app")),
            ("set_profile", str(tmp_path / "trace")),
            ("set_device_preprocess", lambda x: x), ("handle_preemption",
                                                      True)):
        assert getattr(opt, name)(arg) is opt
    for backend in ("orbax", "orbax_async"):
        with pytest.raises(NotImplementedError, match="orbax"):
            opt.set_checkpoint(str(tmp_path), Trigger.every_epoch(),
                               backend=backend)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        opt.set_checkpoint(str(tmp_path), Trigger.every_epoch(),
                           backend="hdf5")
    with pytest.raises(ValueError, match="both a path and a trigger"):
        opt.set_checkpoint(str(tmp_path))
    trig = Trigger.every_epoch()
    assert opt.set_checkpoint(trig, str(tmp_path)).checkpoint_path == str(
        tmp_path)
    opt.set_checkpoint(checkpoint_trigger=trig, checkpoint_path="x")
    assert (opt.checkpoint_path, opt.checkpoint_trigger) == ("x", trig)
