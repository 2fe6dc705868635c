"""The port's TensorBoard summaries (``bigdl_tpu_torch/visualization``)
against the JAX package's on the CPU: the CRC, the event records byte for
byte (``wall_time`` fixed), each package's files read by the other's
reader, and the summaries ``Optimizer`` writes during training.

Tolerances, with their reasons: records are compared byte for byte; the
``Loss`` scalars within 1e-5 relative (f32 forward and backward summed in
other orders, then rounded to the record's f32); ``LearningRate``,
``Throughput``'s step numbers and ``Top1Accuracy`` exactly (accuracies are
counts). The runs use a ``Step`` schedule, which both packages compute in
f32 on the host: JAX's ``Default`` schedule, evaluated outside ``jit`` for
the summary, computes in float64 and so differs by up to one f32 ulp from
the rate its own step applied, which is the value the port records."""

import os
import re

import jax
import numpy as np
import pytest
import torch

WALL = 1_700_000_000.25


def _histogram_tags(path):
    """An event file's histograms as (tag, step) pairs."""
    from bigdl_tpu_torch.visualization.tensorboard import (
        parse_message, read_events,
    )

    out = []
    for ev in read_events(path):
        for summary in ev.get(5, []):
            for value in parse_message(summary).get(1, []):
                v = parse_message(value)
                if 5 in v:
                    out.append((v[1][0].decode(), ev[2][0]))
    return out


def test_crc32c_known_vectors():
    from bigdl_tpu_torch.visualization.tensorboard import crc32c

    assert crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


@pytest.mark.parametrize("tag,value,step", [
    ("Loss", 0.6931471805599453, 0), ("Throughput", 1234.5, 7),
    ("LearningRate", 1e-3, 2 ** 40), ("Top1Accuracy", 0.0, 300)])
def test_scalar_records_are_byte_identical(tag, value, step):
    from bigdl_tpu.visualization import tensorboard as jtb
    from bigdl_tpu_torch.visualization import tensorboard as ttb

    want = jtb.frame_record(jtb.scalar_event(tag, value, step, WALL))
    assert ttb.frame_record(ttb.scalar_event(tag, value, step, WALL)) == want


@pytest.mark.parametrize("shape,bins", [((1000,), 30), ((7, 5), 4),
                                        ((0,), 30), ((3, 3, 2, 2), 30)])
def test_histogram_records_are_byte_identical(shape, bins):
    from bigdl_tpu.visualization import tensorboard as jtb
    from bigdl_tpu_torch.visualization import tensorboard as ttb

    v = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = jtb.histogram_event("Parameters/0:Linear/weight", v, 5, bins,
                               WALL)
    for values in (v, torch.from_numpy(v)):
        got = ttb.histogram_event("Parameters/0:Linear/weight",
                                  ttb.to_host(values), 5, bins, WALL)
        assert got == want


def test_version_record_matches_up_to_wall_time():
    from bigdl_tpu.visualization import tensorboard as jtb
    from bigdl_tpu_torch.visualization import tensorboard as ttb

    got, want = ttb.version_event(), jtb.version_event()
    assert got[0] == want[0] and len(got) == len(want)
    assert got[9:] == want[9:]          # after the tag + 8-byte double


def test_each_reader_reads_the_others_files(tmp_path):
    from bigdl_tpu.visualization import tensorboard as jtb
    from bigdl_tpu_torch.visualization import tensorboard as ttb

    writes = [("Loss", 2.5, 1), ("Loss", 1.25, 2), ("Throughput", 80.0, 2)]
    files = {}
    for name, mod in (("jax", jtb), ("port", ttb)):
        w = mod.FileWriter(str(tmp_path / name))
        for tag, v, s in writes:
            w.add_scalar(tag, v, s)
        w.add_histogram("Parameters/w", np.arange(6.0), 2)
        w.close()
        files[name] = w.path
    for path in files.values():
        assert jtb.read_scalars(path) == ttb.read_scalars(path) == writes
        assert _histogram_tags(path) == [("Parameters/w", 2)]
    assert os.path.basename(files["port"]).startswith("events.out.tfevents.")


def test_summary_layout_and_read_scalar(tmp_path):
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

    ts = TrainSummary(str(tmp_path), "app")
    for i in range(5):
        ts.add_scalar("Loss", 1.0 / (i + 1), i)
    ts.close()
    assert ts.log_dir == os.path.join(str(tmp_path), "app", "train")
    got = dict(TrainSummary(str(tmp_path), "app").read_scalar("Loss"))
    assert got == {i: pytest.approx(1.0 / (i + 1)) for i in range(5)}
    vs = ValidationSummary(str(tmp_path), "app")
    vs.add_scalar("Top1Accuracy", 0.5, 10).close()
    assert vs.log_dir.endswith(os.path.join("app", "validation"))
    assert vs.read_scalar("Top1Accuracy") == [(10, 0.5)]
    assert not ts.should_record("Parameters", {"neval": 3})
    ts.set_summary_trigger("Parameters", Trigger.several_iteration(2))
    assert ts.should_record("Parameters", {"neval": 3})
    assert not ts.should_record("Parameters", {"neval": 4})


def _toy_pair(n_feat=6, n_cls=3):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(21)
    jm = jnn.Sequential().add(jnn.Linear(n_feat, n_cls)).add(jnn.LogSoftMax())
    jm._ensure_params()
    tm = (tnn.Sequential().add(tnn.Linear(n_feat, n_cls, device="cpu"))
          .add(tnn.LogSoftMax()))
    load_jax_tree(tm, jax.device_get(jm.params))
    return jm, tm


def _toy_samples(n=32, n_feat=6, n_cls=3):
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu_torch.dataset import Sample

    rng = np.random.RandomState(42)
    xs = rng.randn(n, n_feat).astype(np.float32)
    ys = rng.randint(1, n_cls + 1, size=n).astype(np.float32)
    return ([JSample(x, y) for x, y in zip(xs, ys)],
            [Sample(x, y) for x, y in zip(xs, ys)])


def _summary_run(pkg, log_dir, histograms=False):
    """``tests/test_eval_viz.py::test_optimizer_writes_summaries`` in one
    package: 2 epochs of 4 iterations, a Top-1 validation every epoch;
    with ``histograms``, 5 iterations with a ``several_iteration(2)``
    Parameters trigger instead."""
    if pkg == "jax":
        from bigdl_tpu.dataset import DataSet
        from bigdl_tpu.nn.criterion import ClassNLLCriterion
        from bigdl_tpu.optim import SGD, Optimizer, Top1Accuracy, Trigger
        from bigdl_tpu.optim.optim_method import Step
        from bigdl_tpu.visualization import TrainSummary, ValidationSummary
    else:
        from bigdl_tpu_torch.dataset import DataSet
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
        from bigdl_tpu_torch.optim import (
            SGD, Optimizer, Step, Top1Accuracy, Trigger,
        )
        from bigdl_tpu_torch.visualization import (
            TrainSummary, ValidationSummary,
        )
    side = 0 if pkg == "jax" else 1
    m = _toy_pair()[side]
    samples = _toy_samples()[side]
    opt = Optimizer(model=m, dataset=DataSet.array(samples),
                    criterion=ClassNLLCriterion(), batch_size=8)
    opt.set_optim_method(SGD(learning_rate=0.1,
                             learning_rate_schedule=Step(3, 0.5)))
    ts = TrainSummary(log_dir, "job")
    vs = ValidationSummary(log_dir, "job")
    if histograms:
        ts.set_summary_trigger("Parameters", Trigger.several_iteration(2))
        opt.set_end_when(Trigger.max_iteration(5))
    else:
        opt.set_end_when(Trigger.max_epoch(2))
    assert opt.set_train_summary(ts) is opt
    assert opt.set_val_summary(vs) is opt
    opt.set_validation(Trigger.every_epoch(), samples, [Top1Accuracy()],
                       batch_size=8)
    opt.optimize()
    ts.close()
    vs.close()
    return ts, vs


@pytest.fixture(scope="module")
def summary_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("summaries")
    return {pkg: _summary_run(pkg, str(d / pkg)) for pkg in ("jax", "port")}


def test_optimizer_writes_the_jax_scalars(summary_runs):
    (jts, jvs), (tts, tvs) = summary_runs["jax"], summary_runs["port"]
    jloss, tloss = jts.read_scalar("Loss"), tts.read_scalar("Loss")
    assert [s for s, _ in tloss] == [s for s, _ in jloss] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in tloss], [v for _, v in jloss],
                               rtol=1e-5)
    assert tts.read_scalar("LearningRate") == jts.read_scalar("LearningRate")
    assert [v for _, v in tts.read_scalar("LearningRate")] == [
        pytest.approx(0.1 * 0.5 ** (i // 3), rel=1e-7) for i in range(8)]
    assert ([s for s, _ in tts.read_scalar("Throughput")]
            == [s for s, _ in jts.read_scalar("Throughput")])
    assert all(v > 0 for _, v in tts.read_scalar("Throughput"))
    top1 = tvs.read_scalar("Top1Accuracy")
    assert top1 == jvs.read_scalar("Top1Accuracy") and len(top1) == 2
    assert [s for s, _ in top1] == [5, 9]


def test_parameter_histograms_match_jax_steps_and_tags(tmp_path):
    def hist(pkg):
        ts, _ = _summary_run(pkg, str(tmp_path / pkg), histograms=True)
        out = []
        for name in sorted(os.listdir(ts.log_dir)):
            for tag, step in _histogram_tags(
                    os.path.join(ts.log_dir, name)):
                # the names after each "i:" carry instance counters
                out.append((re.sub(r":[^/]*", "", tag), step))
        return out

    want, got = hist("jax"), hist("port")
    assert sorted(got) == sorted(want)   # JAX writes a step's in key order
    assert sorted(set(s for _, s in got)) == [2, 4]   # neval 3 and 5
    assert {t for t, _ in got} == {"Parameters/0/weight", "Parameters/0/bias"}
