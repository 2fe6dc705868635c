"""The port's ``DistriOptimizer`` (A.5.b) over ``torch.distributed`` gloo
ranks on the CPU, held against JAX's ``DistriOptimizer`` on an n-device
slice of the 8 virtual CPU devices, the twin of
``tests/test_distri_optimizer.py``.

The port runs one process per device, so each world size (2 and 3) is one
launch of that many worker processes: a script written under ``tmp_path``
that imports ``bigdl_tpu_torch`` only, meets at a ``file://`` rendezvous,
runs every scenario below and pickles its results. JAX runs in this
process on ``Mesh(jax.devices()[:n])`` meanwhile. The test model's flat
size (173) divides neither 2 nor 3, so the partition padding is
exercised, and its 12 children put index 10 before 2 in the JAX flatten
order. The global batch (24) equals the data set, so each step of either
framework averages the gradient of the same 24 rows: the two differ only
in the summation order (JAX's own tolerance, 2e-5).
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.torch_parity import numpy_trees, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS, BATCH, LAUNCH_TIMEOUT_S = 24, 24, 240

MODELS = r'''
import numpy as np
import torch
from bigdl_tpu_torch.nn import (
    BatchNormalization, ClassNLLCriterion, Dropout, Linear, LogSoftMax, ReLU,
    Sequential, Tanh,
)


def chain(seed=0):
    """Linear(6,5), 4 x (Tanh, Linear(5,5)), Tanh, Linear(5,3), LogSoftMax:
    173 parameters in 12 children."""
    g = torch.Generator().manual_seed(seed)
    m = Sequential().add(Linear(6, 5, device="cpu", generator=g))
    for _ in range(4):
        m.add(Tanh()).add(Linear(5, 5, device="cpu", generator=g))
    return (m.add(Tanh()).add(Linear(5, 3, device="cpu", generator=g))
            .add(LogSoftMax()))


def bn_net(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (Sequential().add(Linear(6, 8, device="cpu", generator=g))
            .add(BatchNormalization(8, device="cpu")).add(ReLU())
            .add(Linear(8, 3, device="cpu", generator=g)).add(LogSoftMax()))


def drop_net(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (Sequential().add(Linear(6, 16, device="cpu", generator=g))
            .add(Dropout(0.5)).add(Linear(16, 3, device="cpu", generator=g))
            .add(LogSoftMax()))
'''

WORKER = MODELS + r'''
import pickle
import sys
import traceback

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
rdv, spec_path, out_path = sys.argv[3], sys.argv[4], sys.argv[5]

from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.optim import (
    SGD, DistriOptimizer, Evaluator, Loss, Optimizer, Predictor,
    Top1Accuracy, Trigger,
)
from bigdl_tpu_torch.optim import distri_optimizer as dmod
from bigdl_tpu_torch.optim.train_step import make_train_step
from bigdl_tpu_torch.optim.validation import AccuracyResult, LossResult
from bigdl_tpu_torch.parallel import AllReduceParameter, ModelBroadcast
from bigdl_tpu_torch.parallel import all_reduce as ar
from bigdl_tpu_torch.utils.engine import Engine

Engine.init_distributed(coordinator_address="file://" + rdv,
                        num_processes=world, process_id=rank, device="cpu",
                        timeout_s=60)
spec = pickle.load(open(spec_path, "rb"))
x, y = spec["x"], spec["y"]
samples = [Sample(x[i], y[i]) for i in range(len(x))]
out = {}


def flat(m):
    return np.concatenate([p.detach().numpy().ravel()
                           for _, p in m._jax_ordered()])


def train(cfg, build=chain, weights=None, data=None, **extra):
    m = build()
    if weights is not None:
        m.set_weights(weights)
    opt = Optimizer(m, DataSet.distributed(data or samples),
                    ClassNLLCriterion(), batch_size=BATCH,
                    end_trigger=Trigger.max_iteration(cfg["steps"]),
                    parameter_mode=cfg["mode"], compress=cfg.get("compress"),
                    **extra)
    opt.set_optim_method(SGD(0.1, momentum=cfg.get("momentum", 0.0)))
    if cfg.get("l2") is not None:
        opt.set_gradient_clipping_by_l2_norm(cfg["l2"])
    if cfg.get("const") is not None:
        opt.set_constant_gradient_clipping(*cfg["const"])
    return m, opt


def scenario(name):
    def wrap(fn):
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        return fn
    return wrap


BATCH = spec["batch"]


@scenario("parity")
def _():
    res, shards = {}, []
    orig = dmod.DistriOptimizer._build_partitioned_step

    def capture(self, *a):
        step, shard, opt_state = orig(self, *a)
        shards.append(shard.detach().clone().numpy())
        return step, shard, opt_state

    dmod.DistriOptimizer._build_partitioned_step = capture
    for key, cfg in spec["cfgs"].items():
        m, opt = train(cfg, weights=spec["weights"])
        before = ar.comm["bytes"]
        opt.optimize()
        res[key] = flat(m)
        res[key + "_bytes"] = ar.comm["bytes"] - before
    dmod.DistriOptimizer._build_partitioned_step = orig
    res["first_shard"] = shards[0]
    return res


@scenario("reduce_scatter")
def _():
    """The gather's backward on this rank's own cotangent (seed 7, row
    ``rank``): the reduce-scatter, compressed or not."""
    res = {}
    for compress in (None, "bf16", "fp16"):
        arp = AllReduceParameter(chain(), world, compress=compress)
        ct = np.random.RandomState(7).randn(world, arp.padded_size)[rank]
        shard = torch.zeros(arp.shard_size, requires_grad=True)
        full = ar._GatherWeights.apply(shard, arp)
        (g,) = torch.autograd.grad(full, [shard], torch.from_numpy(
            ct.astype(np.float32)))
        res[compress] = g.numpy()
    return res


@scenario("bn")
def _():
    m, opt = train({"mode": "partitioned", "steps": 1}, build=bn_net)
    w0 = [p.detach().clone() for _, p in m._jax_ordered()]
    opt.optimize()
    got = [b.clone().numpy() for b in m.buffers() if b.is_floating_point()]
    # this rank's own step on its own first batch, from the same start
    ref = bn_net()
    ref.set_weights(w0)
    batch = next(DataSet.distributed(samples).transform(
        SampleToMiniBatch(BATCH // world)).data(train=True))
    params = {k: p.detach().clone() for k, p in ref.named_parameters()}
    state = {k: b.detach().clone() for k, b in ref.named_buffers()}
    sgd = SGD(0.1)
    make_train_step(ref.train(), ClassNLLCriterion(), sgd)(
        params, sgd.init_state(params), state, None,
        torch.from_numpy(batch.get_input()),
        torch.from_numpy(batch.get_target()))
    own = [v.numpy() for v in state.values() if v.is_floating_point()]
    return {"distri": got, "own": own}


@scenario("dropout")
def _():
    runs = []
    for _ in range(2):
        m, opt = train({"mode": "partitioned", "steps": 2}, build=drop_net)
        masks = []
        m[1].register_forward_hook(
            lambda mod, inp, o: masks.append((o != 0).numpy().copy()))
        opt.set_seed(11)
        opt.optimize()
        runs.append(masks)
    return runs


@scenario("divide")
def _():
    try:
        DistriOptimizer(chain(), DataSet.distributed(samples),
                        ClassNLLCriterion(), batch_size=4 * world + 1)
    except ValueError as e:
        return str(e)
    return "no error"


@scenario("frozen")
def _():
    """A frozen first layer through every mode: (its weights kept
    bitwise, the rest moved) per mode."""
    res = {}
    for mode in ("partitioned", "allreduce", "blockstore"):
        m, opt = train({"mode": mode, "steps": 2, "momentum": 0.9},
                       weights=spec["weights"])
        m.freeze(m[0].name)
        before = [p.detach().clone() for p in m.parameters()]
        opt.optimize()
        after = list(m.parameters())
        res[mode] = (all(torch.equal(a, b) for a, b in
                         zip(after[:2], before[:2])),
                     all(not torch.equal(a, b) for a, b in
                         zip(after[2:], before[2:])))
    return res


class Scalars:
    def __init__(self):
        self.rows = []

    def add_scalar(self, name, value, step):
        self.rows.append((name, value, step))


def pre(x):
    return x.float() / 255.0 - 0.5


@scenario("validation")
def _():
    res = {}
    vx, vy = spec["val_x"], spec["val_y"]
    vsamples = [Sample(vx[i], vy[i]) for i in range(len(vx))]
    for mode in ("partitioned", "allreduce"):
        m, opt = train({"mode": mode, "steps": 2})
        vs = Scalars()
        opt.set_validation(Trigger.several_iteration(1),
                           DataSet.distributed(vsamples),
                           [Top1Accuracy(), Loss()], batch_size=4 * world)
        opt.set_val_summary(vs)
        opt.optimize()
        whole = Evaluator(m).test(vsamples, [Top1Accuracy(), Loss()], 52)
        mesh = Engine.mesh()
        sharded = Evaluator(m, mesh=mesh).test(
            vsamples, [Top1Accuracy(), Loss()], 52)
        res[mode] = {
            "logged": vs.rows[-2:],
            "whole": [r.result() for r in whole],
            "sharded": [r.result() for r in sharded],
            "predict_sharded": Predictor(m, mesh=mesh).predict(vx, 52),
            "predict_whole": Predictor(m).predict(vx, 52)}
    # set_device_preprocess reaches the sharded validation
    u8 = spec["u8"]
    usamples = [Sample(u8[i], y[i]) for i in range(len(u8))]
    m, opt = train({"mode": "partitioned", "steps": 1}, data=usamples)
    opt.set_device_preprocess(pre)
    vs = Scalars()
    opt.set_validation(Trigger.several_iteration(1),
                       DataSet.distributed(usamples), [Loss()],
                       batch_size=4 * world)
    opt.set_val_summary(vs)
    opt.optimize()
    (want,) = Evaluator(m, device_preprocess=pre).test(usamples, [Loss()], 24)
    res["preprocess"] = {"logged": vs.rows[-1], "whole": want.result()}
    return res


@scenario("merge")
def _():
    a = AccuracyResult(rank + 1, 10 + rank).merge_across_processes()
    lo = LossResult(0.5 * (rank + 1), 2).merge_across_processes()
    return [a.correct, a.count, lo.loss, lo.count]


@scenario("pyspark")
def _():
    opt = DistriOptimizer(chain(), DataSet.distributed(samples),
                          ClassNLLCriterion(), batch_size=2 * world)
    opt.set_validation(12 * world, DataSet.distributed(samples),
                       Trigger.every_epoch(), [Top1Accuracy()])
    probe = next(iter(opt.validation_dataset.data(train=False))).size()
    errors = []
    try:
        opt.set_validation(12 * world + 1, DataSet.distributed(samples),
                           Trigger.every_epoch(), [Top1Accuracy()])
    except ValueError as e:
        errors.append(str(e))

    class NoCls(Top1Accuracy):
        _result_cls = None

    try:
        opt.set_validation(12 * world, DataSet.distributed(samples),
                           Trigger.every_epoch(), [NoCls()])
    except ValueError as e:
        errors.append(str(e))
    return {"probe": probe, "errors": errors}


@scenario("broadcast")
def _():
    m = chain(seed=100 + rank)
    before = flat(m)
    ModelBroadcast().broadcast(Engine.mesh(), m)
    return {"before": before, "after": flat(m)}


@scenario("topology")
def _():
    ds = DataSet.distributed(list(range(10)))
    again = Engine.init_distributed()        # idempotent once started
    return {"shard": list(ds._data), "partition": (ds.partition_num,
                                                   ds.partition_index),
            "node_number": Engine.node_number(),
            "core_number": Engine.core_number(),
            "device_count": Engine.device_count(),
            "mesh": (Engine.mesh().size(), Engine.mesh().mesh_dim_names),
            "again": again is Engine}


out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
pickle.dump(out, open(f"{out_path}.{rank}", "wb"))
Engine.shutdown()
'''


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    return env


def launch(argvs, logdir, timeout_s=LAUNCH_TIMEOUT_S):
    """Start one process per argv, each writing its output to
    ``logdir/rank<i>.log`` (a file, so no rank blocks on a full pipe);
    returns a ``wait()`` that waits for all within ``timeout_s``, kills
    them all when it runs out, and fails with every rank's log."""
    os.makedirs(logdir, exist_ok=True)
    logs = [os.path.join(logdir, f"rank{i}.log") for i in range(len(argvs))]
    procs = []
    for a, log in zip(argvs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(a, cwd=ROOT, env=_env(), stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.time() + timeout_s

    def report():
        return "\n".join(f"--- {log} (rc {p.returncode}):\n"
                         + open(log).read()[-4000:]
                         for p, log in zip(procs, logs))

    def wait():
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            pytest.fail(f"ranks still running after {timeout_s}s: killed\n"
                        + report())
        if any(p.returncode for p in procs):
            pytest.fail("a rank failed\n" + report())
        return [open(log).read() for log in logs]

    return wait


# --------------------------------------------------------------- the data


def _data():
    rs = np.random.RandomState(0)
    x = rs.randn(N_ROWS, 6).astype(np.float32)
    y = (rs.randint(0, 3, N_ROWS) + 1).astype(np.float32)
    vx = rs.randn(52, 6).astype(np.float32)
    vy = (rs.randint(0, 3, 52) + 1).astype(np.float32)
    u8 = rs.randint(0, 256, (N_ROWS, 6)).astype(np.uint8)
    return x, y, vx, vy, u8


CFGS = {
    "allreduce_1": {"mode": "allreduce", "steps": 1},
    "partitioned_1": {"mode": "partitioned", "steps": 1},
    "blockstore_1": {"mode": "blockstore", "steps": 1},
    "partitioned_3": {"mode": "partitioned", "steps": 3, "momentum": 0.9},
    "allreduce_3": {"mode": "allreduce", "steps": 3, "momentum": 0.9},
    "blockstore_3": {"mode": "blockstore", "steps": 3, "momentum": 0.9},
    "bf16_3": {"mode": "partitioned", "steps": 3, "momentum": 0.9,
               "compress": "bf16"},
    "l2_partitioned": {"mode": "partitioned", "steps": 1, "l2": 0.05},
    "l2_allreduce": {"mode": "allreduce", "steps": 1, "l2": 0.05},
    "const_partitioned": {"mode": "partitioned", "steps": 1,
                          "const": (-0.01, 0.01)},
    "const_allreduce": {"mode": "allreduce", "steps": 1,
                        "const": (-0.01, 0.01)},
}
#: the JAX run each port configuration is held against
JAX_OF = {"allreduce_1": "allreduce_1", "partitioned_1": "partitioned_1",
          "blockstore_1": "allreduce_1", "partitioned_3": "partitioned_3",
          "allreduce_3": "partitioned_3", "blockstore_3": "partitioned_3",
          "bf16_3": "bf16_3", "l2_partitioned": "l2_partitioned",
          "l2_allreduce": "l2_partitioned",
          "const_partitioned": "const_allreduce",
          "const_allreduce": "const_allreduce"}
JAX_RUNS = sorted(set(JAX_OF.values()))


def _jax_chain():
    from bigdl_tpu.nn import Linear, LogSoftMax, Sequential, Tanh

    m = Sequential().add(Linear(6, 5))
    for _ in range(4):
        m.add(Tanh()).add(Linear(5, 5))
    return m.add(Tanh()).add(Linear(5, 3)).add(LogSoftMax())


def _jax_run(cfg, n, x, y):
    """JAX's DistriOptimizer over n devices from the seed-21 trees; its
    params as one vector in the flatten order."""
    import jax
    from jax.sharding import Mesh

    from bigdl_tpu.dataset.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim import SGD as JSGD, Trigger as JTrigger
    from bigdl_tpu.optim.distri_optimizer import (
        DistriOptimizer as JDistriOptimizer,
    )

    jm = _jax_chain()
    # the same numbers under this instance's own child keys
    jm.params, jm.state = numpy_trees(jm, 21)[0], jm.init_state()
    opt = JDistriOptimizer(
        model=jm, dataset=JDataSet.distributed(
            [JSample(x[i], y[i]) for i in range(len(x))]),
        criterion=JNLL(), batch_size=BATCH, parameter_mode=cfg["mode"],
        compress=cfg.get("compress"),
        mesh=Mesh(np.asarray(jax.devices()[:n]), ("data",)))
    opt.set_optim_method(JSGD(learning_rate=0.1,
                              momentum=cfg.get("momentum", 0.0)))
    opt.set_end_when(JTrigger.max_iteration(cfg["steps"]))
    if cfg.get("l2") is not None:
        opt.set_gradient_clipping_by_l2_norm(cfg["l2"])
    if cfg.get("const") is not None:
        opt.set_constant_gradient_clipping(*cfg["const"])
    opt.retry_times = 1
    opt.optimize()
    return np.concatenate([np.asarray(leaf).ravel() for leaf in
                           jax.tree_util.tree_leaves(jm.params)])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both world sizes launched at once; the JAX references computed
    while the ranks run. {n: {"ranks": [results per rank], "jax": {...},
    "tree": JAX params tree, "local": {...}}}."""
    import jax

    from bigdl_tpu.parallel.all_reduce import AllReduceParameter as JARP

    x, y, vx, vy, u8 = _data()
    tree, _ = numpy_trees(_jax_chain(), 21)
    weights = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]
    spec = {"x": x, "y": y, "val_x": vx, "val_y": vy, "u8": u8,
            "batch": BATCH, "weights": weights, "cfgs": CFGS}
    tmp = tmp_path_factory.mktemp("distri")
    (tmp / "spec.pkl").write_bytes(pickle.dumps(spec))
    (tmp / "worker.py").write_text(WORKER)
    waits = {}
    for n in (2, 3):
        argvs = [[sys.executable, str(tmp / "worker.py"), str(r), str(n),
                  str(tmp / f"rdv{n}"), str(tmp / "spec.pkl"),
                  str(tmp / f"out{n}")] for r in range(n)]
        waits[n] = launch(argvs, str(tmp / f"logs{n}"))
    out = {}
    for n in (2, 3):
        out[n] = {"jax": {k: _jax_run(CFGS[k], n, x, y)
                          for k in JAX_RUNS},
                  "init_shards": np.asarray(JARP(tree, n).init_shards(tree)),
                  "tree_flat": np.concatenate([w.ravel() for w in weights])}
    for n in (2, 3):
        waits[n]()
        out[n]["ranks"] = [pickle.loads((tmp / f"out{n}.{r}").read_bytes())
                           for r in range(n)]
    return out


def _ok(res, name):
    got = res[name]
    assert not (isinstance(got, dict) and "error" in got), got.get("error")
    return got


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# -------------------------------------------------- held against JAX's mesh


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("key", sorted(CFGS))
def test_modes_match_jax_mesh(worlds, n, key):
    """Every mode, compress and clip configuration against JAX's
    DistriOptimizer on n devices: f32 within JAX's own 2e-5 (one step
    and three momentum steps over the whole data set), bf16-compressed
    gradients within 2e-3 of scale. bf16 rounds each exchanged gradient,
    and an f32 ulp between the two frameworks' gradients that flips one
    rounding moves that weight by a bf16 ulp of its gradient: the runs
    part by 6.3e-4 (n = 2) and 7.1e-4 (n = 3) of scale, as far as an f32
    exchange lies from either, so the exchange itself is held bitwise in
    ``test_compressed_reduce_scatter_matches_jax``."""
    w = worlds[n]
    want = w["jax"][JAX_OF[key]]
    for res in w["ranks"]:
        got = _ok(res, "parity")[key]
        assert got.shape == want.shape
        if key.startswith("bf16"):
            assert _rel(got, want) < 2e-3, key
            assert np.abs(got - w["tree_flat"]).max() > 1e-3  # it trained
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=key)
    # every rank ends with the same weights
    for res in w["ranks"][1:]:
        np.testing.assert_array_equal(_ok(res, "parity")[key],
                                      _ok(w["ranks"][0], "parity")[key])


def _jax_reduce_scatter(n, compress):
    """JAX's gather backward (``AllReduceParameter._make_gather``) over n
    devices on the cotangents the ranks use: the reduce-scattered
    gradient, every rank's shard in rank order."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from bigdl_tpu.parallel.all_reduce import AllReduceParameter as JARP
    from bigdl_tpu.utils.compat import shard_map

    arp = JARP(numpy_trees(_jax_chain(), 21)[0], n, "data",
               compress=compress)
    gather = arp._make_gather()
    cts = np.random.RandomState(7).randn(n, arp.padded_size).astype(
        np.float32)

    def bwd(shard, ct):
        _, pull = jax.vjp(gather, shard[0])
        return pull(ct[0])[0][None]

    step = jax.jit(shard_map(bwd, mesh=Mesh(np.asarray(jax.devices()[:n]),
                                            ("data",)),
                             in_specs=(P("data"), P("data")),
                             out_specs=P("data")))
    return np.asarray(step(np.zeros((n, arp.shard_size), np.float32),
                           cts)).reshape(-1), cts


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("compress", [None, "bf16", "fp16"])
def test_compressed_reduce_scatter_matches_jax(worlds, n, compress):
    """The gather's backward on the same per-rank cotangents: f32 within
    an f32 ulp of JAX's psum_scatter; compressed, every element is a
    value of the wire dtype (an f32 exchange fails here: its sums are
    not) and equals JAX's at n = 2. At n = 3 JAX sums the three rounded
    inputs in f32 and rounds once, while gloo rounds after each addition:
    each rounding is within half an ulp, in the wire dtype, of the sum of
    the inputs' magnitudes, so the two lie within one such ulp."""
    want, cts = _jax_reduce_scatter(n, compress)
    got = np.concatenate([_ok(res, "reduce_scatter")[compress]
                          for res in worlds[n]["ranks"]])
    if compress is None:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    dtype, mantissa = {"bf16": (torch.bfloat16, 7),
                       "fp16": (torch.float16, 10)}[compress]

    def wire(a):
        return torch.from_numpy(a).to(dtype).float().numpy()

    np.testing.assert_array_equal(wire(got), got)
    assert np.abs(got - cts.sum(0)).max() > 1e-3       # it rounded
    if n == 2:
        np.testing.assert_array_equal(got, want)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(wire(cts)).sum(0)))
                      - mantissa)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("n", [2, 3])
def test_compress_halves_the_reduce_scatter(worlds, n):
    """``compress="bf16"`` through ``DistriOptimizer``: the run's
    collectives move 2 bytes fewer per element of the padded vector on
    each step's reduce-scatter than the f32 run's, and nothing else
    differs."""
    padded = -(-173 // n) * n
    for res in worlds[n]["ranks"]:
        p = _ok(res, "parity")
        assert p["partitioned_3_bytes"] - p["bf16_3_bytes"] == 2 * padded * 3


def test_clipping_acts(worlds):
    """The clip thresholds are below the unclipped update, so the clipped
    runs part from the plain one-step run."""
    w = worlds[2]["jax"]
    for k in ("l2_partitioned", "const_allreduce"):
        assert np.abs(w[k] - w["partitioned_1"]).max() > 1e-4, k


@pytest.mark.parametrize("n", [2, 3])
def test_one_step_equals_local_step(worlds, n):
    """One data-parallel step equals one LocalOptimizer step on the whole
    batch (the port's own, in this process)."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

    scope = {}
    exec(compile(MODELS, "models", "exec"), scope)
    x, y, *_ = _data()
    m = scope["chain"]()
    m.set_weights([w for w in _weights()])
    opt = Optimizer(m, DataSet.array([Sample(x[i], y[i])
                                      for i in range(N_ROWS)]),
                    ClassNLLCriterion(), batch_size=BATCH,
                    end_trigger=Trigger.max_iteration(1))
    opt.set_optim_method(SGD(0.1)).optimize()
    local = np.concatenate([p.detach().numpy().ravel()
                            for _, p in m._jax_ordered()])
    for res in worlds[n]["ranks"]:
        for key in ("allreduce_1", "partitioned_1", "blockstore_1"):
            np.testing.assert_allclose(_ok(res, "parity")[key], local,
                                       atol=2e-5, rtol=0)


def _weights():
    import jax

    tree, _ = numpy_trees(_jax_chain(), 21)
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("n", [2, 3])
def test_rank_shard_is_jax_init_shards_row(worlds, n):
    """Rank r's partitioned shard is row r of JAX's
    ``AllReduceParameter.init_shards``: the flatten order and the padding
    are JAX's."""
    w = worlds[n]
    assert w["init_shards"].shape[0] == n
    assert w["init_shards"].size > 173 and 173 % n
    for r, res in enumerate(w["ranks"]):
        np.testing.assert_array_equal(_ok(res, "parity")["first_shard"],
                                      w["init_shards"][r])


# ------------------------------------------------------------ within the port


@pytest.mark.parametrize("n", [2, 3])
def test_bn_buffers_are_mean_of_ranks(worlds, n):
    ranks = worlds[n]["ranks"]
    own = [_ok(r, "bn")["own"] for r in ranks]
    for res in ranks:
        got = _ok(res, "bn")["distri"]
        assert len(got) == len(own[0]) == 2        # running mean and var
        for k, v in enumerate(got):
            np.testing.assert_allclose(
                v, np.mean([o[k] for o in own], axis=0), rtol=1e-6,
                atol=1e-7)
    assert np.abs(own[0][0] - own[1][0]).max() > 1e-4   # they differed


@pytest.mark.parametrize("n", [2, 3])
def test_dropout_masks_per_rank(worlds, n):
    """Masks differ across ranks, repeat for one (seed, neval, rank), and
    differ between iterations."""
    ranks = [_ok(r, "dropout") for r in worlds[n]["ranks"]]
    for runs in ranks:
        first, second = runs
        assert len(first) == 2
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(first[0], first[1])
        assert 0.3 < first[0].mean() < 0.7
    for other in ranks[1:]:
        assert not np.array_equal(ranks[0][0][0], other[0][0])


@pytest.mark.parametrize("n", [2, 3])
def test_batch_must_divide_and_frozen_raises(worlds, n):
    """The global batch must divide the topology. A frozen layer no
    longer raises: every mode trains the others and keeps its weights
    bitwise (``tests/test_torch_freeze.py`` holds the modes against
    JAX)."""
    for res in worlds[n]["ranks"]:
        assert "divide" in _ok(res, "divide")
        frozen = _ok(res, "frozen")
        assert sorted(frozen) == ["allreduce", "blockstore", "partitioned"]
        assert all(kept and moved for kept, moved in frozen.values()), frozen


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_validation_scores_as_whole(worlds, n):
    """In-training validation over the ranks' shards (52 rows, ragged
    local batches) merges to the whole set's score; ``Evaluator(mesh=)``
    and ``Predictor(mesh=)`` pad the 52-row batch to the mesh and trim."""
    for res in worlds[n]["ranks"]:
        v = _ok(res, "validation")
        for mode in ("partitioned", "allreduce"):
            r = v[mode]
            (top1, count1), (loss, count2) = r["whole"]
            assert count1 == count2 == 52
            logged = {name: val for name, val, _ in r["logged"]}
            assert logged["Top1Accuracy"] == top1
            assert abs(logged["Loss"] - loss) <= 1e-6 * abs(loss)
            assert r["sharded"][0] == r["whole"][0]
            assert abs(r["sharded"][1][0] - loss) <= 1e-6 * abs(loss)
            np.testing.assert_allclose(r["predict_sharded"],
                                       r["predict_whole"], rtol=1e-6,
                                       atol=1e-7)
        name, val, _ = v["preprocess"]["logged"]
        want, count = v["preprocess"]["whole"]
        assert name == "Loss" and count == N_ROWS
        assert abs(val - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("n", [2, 3])
def test_merge_across_processes(worlds, n):
    want = [n * (n + 1) / 2, sum(10 + r for r in range(n)),
            0.5 * n * (n + 1) / 2, 2 * n]
    for res in worlds[n]["ranks"]:
        assert _ok(res, "merge") == want


def test_pyspark_order_set_validation(worlds):
    for res in worlds[2]["ranks"]:
        got = _ok(res, "pyspark")
        assert got["probe"] <= 12
        assert "divide" in got["errors"][0]
        assert "_result_cls" in got["errors"][1]


@pytest.mark.parametrize("n", [2, 3])
def test_model_broadcast(worlds, n):
    ranks = [_ok(r, "broadcast") for r in worlds[n]["ranks"]]
    assert not np.array_equal(ranks[0]["before"], ranks[1]["before"])
    for r in ranks:
        np.testing.assert_array_equal(r["after"], ranks[0]["before"])


@pytest.mark.parametrize("n", [2, 3])
def test_distributed_dataset_and_topology(worlds, n):
    for r, res in enumerate(worlds[n]["ranks"]):
        t = _ok(res, "topology")
        assert t["shard"] == list(range(10))[r::n]
        assert t["partition"] == (n, r)
        assert (t["node_number"], t["core_number"], t["device_count"]) == \
            (n, 1, n)
        assert t["mesh"] == (n, ("data",)) and t["again"]
        assert res["modules"] == []             # bigdl_tpu_torch only


def test_engine_init_distributed_must_come_first():
    from bigdl_tpu_torch.utils.engine import Engine

    Engine.reset()
    try:
        Engine.init(node_number=1)
        assert Engine.node_number() == 1 and Engine.core_number() == 1
        with pytest.raises(RuntimeError, match="BEFORE"):
            Engine.init_distributed(num_processes=1, device="cpu")
        with pytest.raises(RuntimeError, match="init_distributed"):
            Engine.mesh()                   # no group: nothing starts one
        with pytest.raises(RuntimeError, match="init_distributed"):
            Engine.hybrid_mesh()            # nor does the hybrid mesh
        with pytest.raises(NotImplementedError, match="A.7"):
            Engine.default_pool()
    finally:
        Engine.reset()
    # the hybrid mesh is ported: on a one-process gloo group, its shape
    try:
        Engine.init_distributed(num_processes=1, device="cpu")
        mesh = Engine.hybrid_mesh(("data", "model"), num_slices=1)
        assert tuple(mesh.shape) == (1, 1, 1)
        assert mesh.mesh_dim_names == ("dcn", "data", "model")
        assert Engine.current_mesh() is mesh
        with pytest.raises(ValueError, match="slices"):
            Engine.hybrid_mesh(num_slices=2)
    finally:
        Engine.shutdown()
    assert Engine.current_mesh() is None
    assert not torch.distributed.is_initialized()


def test_factory_dispatches_distri():
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.dataset.dataset import DistributedDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import DistriOptimizer, LocalOptimizer, Optimizer

    scope = {}
    exec(compile(MODELS, "models", "exec"), scope)
    x, y, *_ = _data()
    samples = [Sample(x[i], y[i]) for i in range(N_ROWS)]
    opt = Optimizer(scope["chain"](), DataSet.distributed(samples),
                    ClassNLLCriterion(), batch_size=8,
                    parameter_mode="allreduce")
    assert isinstance(opt, DistriOptimizer)
    assert opt.parameter_mode == "allreduce"
    assert isinstance(DataSet.distributed(samples), DistributedDataSet)
    opt = Optimizer(scope["chain"](), DataSet.array(samples),
                    ClassNLLCriterion(), batch_size=8, distributed=True)
    assert isinstance(opt, DistriOptimizer)
    assert isinstance(Optimizer(scope["chain"](), DataSet.array(samples),
                                ClassNLLCriterion(), batch_size=8),
                      LocalOptimizer)
    with pytest.raises(ValueError, match="parameter_mode"):
        DistriOptimizer(scope["chain"](), DataSet.array(samples),
                        ClassNLLCriterion(), batch_size=8,
                        parameter_mode="ring")


# ---------------------------------------------- the example: resume bitwise


def _pod(tmp, tag, ckpt, max_it, resume=False):
    argvs = []
    for r in range(2):
        a = [sys.executable, "-m", "bigdl_tpu_torch.examples.distributed_pod",
             "--device", "cpu", "--coordinator", f"file://{tmp}/rdv_{tag}",
             "--nProcs", "2", "--procId", str(r), "-b", "32", "--nSamples",
             "128", "--maxIteration", str(max_it), "--checkpoint", ckpt]
        argvs.append(a + (["--resume"] if resume else []))
    return launch(argvs, str(tmp / f"logs_{tag}"))


def test_distributed_pod_resume_is_bitwise(tmp_path):
    """Two gloo ranks through ``examples/distributed_pod``: a run stopped
    at iteration 5 and resumed with ``--resume`` to 10 ends with the
    checkpoint of an uninterrupted run to 10, bitwise; each rank writes
    ``proc_<r>`` with a LATEST marker."""
    from bigdl_tpu_torch.utils.file_io import File

    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    w1 = _pod(tmp_path, "a", whole, 10)
    w2 = _pod(tmp_path, "b", part, 5)
    w1()
    w2()
    outs = _pod(tmp_path, "c", part, 10, resume=True)()
    assert all("done:" in o for o in outs)
    for d in (whole, part):
        assert sorted(os.listdir(d)) == ["proc_0", "proc_1"]
    for r in range(2):
        for d in (whole, part):
            assert sorted(os.listdir(os.path.join(d, f"proc_{r}"))) == \
                ["LATEST", "model", "optimMethod"]
            assert open(os.path.join(d, f"proc_{r}", "LATEST")).read() == "11"
        a = File.load(os.path.join(whole, f"proc_{r}", "model"))["params"]
        b = File.load(os.path.join(part, f"proc_{r}", "model"))["params"]
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        oa = File.load(os.path.join(whole, f"proc_{r}", "optimMethod"))
        ob = File.load(os.path.join(part, f"proc_{r}", "optimMethod"))
        assert oa["neval"] == ob["neval"] == 11
        for k, v in oa["opt_state"]["velocity"].items():
            assert torch.equal(v, ob["opt_state"]["velocity"][k]), k
