"""Frozen layers in the port (``AbstractModule.freeze``/``unfreeze``,
``optim/train_step.py``'s mask, ``DistriOptimizer``'s flat mask) held
against the JAX package on the CPU, the twin of ``tests/test_freeze.py:
49``, ``:74`` and ``:107``.

The three-layer MLP of JAX's test (fc1 6→8, fc2 8→4, fc3 4→2, MSE) is
built by JAX from its seed and its weights are loaded into the port's.
Frozen layers must stay BIT-identical through training — also under
weight decay inside the optimizer (``SGD(weight_decay=…)``), which zeroed
gradients alone would not stop — and the trained layer must match JAX's
within 2e-5 (f32 summation order). The local mode runs here, on JAX's
32 samples in batches of 8. The allreduce, partitioned and blockstore
modes run on two gloo ranks (the launcher of
``tests/test_torch_distri_optimizer.py``) on 24 rows in a global batch
of 24, so every step of either framework averages the same rows; JAX
runs its ``DistriOptimizer`` on two of its CPU devices meanwhile (its
blockstore mode needs processes, so the port's is held against JAX's
allreduce run, the same arithmetic without clipping). An l2 clip
separates the orders: the partitioned step zeroes frozen gradients
before the global norm, the allreduce step after it, as JAX's do.
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_distri_optimizer import launch
from tests.torch_parity import one_torch_thread  # noqa: F401

NAMES = ("fc1", "fc2", "fc3")
STEPS = 6

BUILD = r'''
import torch
from bigdl_tpu_torch.nn import Linear, MSECriterion, Sequential
from bigdl_tpu_torch.optim import SGD, RMSprop


def tmodel(weights):
    m = (Sequential().add(Linear(6, 8, device="cpu").set_name("fc1"))
         .add(Linear(8, 4, device="cpu").set_name("fc2"))
         .add(Linear(4, 2, device="cpu").set_name("fc3")))
    return m.set_weights(weights)


def method(kind):
    return (SGD(learning_rate=0.1, momentum=0.9, weight_decay=0.1)
            if kind == "sgd" else RMSprop(learning_rate=0.01))


def layers(m):
    out = {}
    for k, p in m.named_parameters():
        layer, leaf = k.split(".")
        out.setdefault(layer.split(":")[1], {})[leaf] = p.detach().numpy().copy()
    return out
'''

WORKER = BUILD + r'''
import pickle
import sys

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
rdv, spec_path, out_path = sys.argv[3], sys.argv[4], sys.argv[5]

from bigdl_tpu_torch.dataset import DataSet, Sample
from bigdl_tpu_torch.optim import DistriOptimizer, Trigger
from bigdl_tpu_torch.utils.engine import Engine

Engine.init_distributed(coordinator_address="file://" + rdv,
                        num_processes=world, process_id=rank, device="cpu",
                        timeout_s=60)
spec = pickle.load(open(spec_path, "rb"))
samples = [Sample(spec["x"][i], spec["y"][i]) for i in range(len(spec["x"]))]
out = {}
for key, cfg in spec["cfgs"].items():
    m = tmodel(spec["weights"])
    if cfg.get("head"):
        m.freeze()
        m.unfreeze("fc3")
    else:
        m.freeze("fc1", "fc3")
    opt = DistriOptimizer(m, DataSet.distributed(samples), MSECriterion(),
                          batch_size=len(samples),
                          end_trigger=Trigger.max_iteration(spec["steps"]),
                          parameter_mode=cfg["mode"])
    opt.set_optim_method(method(cfg["optim"]))
    if cfg.get("l2") is not None:
        opt.set_gradient_clipping_by_l2_norm(cfg["l2"])
    opt.optimize()
    out[key] = layers(m)
pickle.dump(out, open(f"{out_path}.{rank}", "wb"))
Engine.shutdown()
'''

#: port configuration → (mode, optimizer, l2 clip, JAX run it is held to)
CFGS = {
    "allreduce_sgd": {"mode": "allreduce", "optim": "sgd"},
    "allreduce_rmsprop": {"mode": "allreduce", "optim": "rmsprop"},
    "allreduce_sgd_l2": {"mode": "allreduce", "optim": "sgd", "l2": 0.05},
    "allreduce_head": {"mode": "allreduce", "optim": "sgd", "head": True},
    "partitioned_sgd": {"mode": "partitioned", "optim": "sgd"},
    "partitioned_rmsprop": {"mode": "partitioned", "optim": "rmsprop"},
    "partitioned_sgd_l2": {"mode": "partitioned", "optim": "sgd",
                           "l2": 0.05},
    "blockstore_sgd": {"mode": "blockstore", "optim": "sgd"},
}
JAX_OF = {k: k for k in CFGS}
JAX_OF["blockstore_sgd"] = "allreduce_sgd"


def _jmodel():
    from bigdl_tpu.nn import Linear, Sequential
    from bigdl_tpu.utils.random_gen import RNG

    RNG.set_seed(3)
    m = (Sequential()
         .add(Linear(6, 8).set_name("fc1"))
         .add(Linear(8, 4).set_name("fc2"))
         .add(Linear(4, 2).set_name("fc3")))
    m._ensure_params()
    return m


def _weights():
    return [np.array(w) for w in _jmodel().get_weights()]


def _jlayers(m):
    return {k.split(":")[1]: {leaf: np.array(v) for leaf, v in d.items()}
            for k, d in jax.device_get(m.params).items()}


def _jmethod(kind):
    from bigdl_tpu.optim import SGD, RMSprop

    return (SGD(learning_rate=0.1, momentum=0.9, weight_decay=0.1)
            if kind == "sgd" else RMSprop(learning_rate=0.01))


def _local_samples(n=32):
    rs = np.random.RandomState(0)
    return [(rs.rand(6).astype(np.float32), rs.rand(2).astype(np.float32))
            for _ in range(n)]


def _scope():
    scope = {}
    exec(compile(BUILD, "build", "exec"), scope)
    return scope


def _held(got, want, frozen, before):
    """Frozen layers bitwise their start, every layer within 2e-5 of
    JAX's, the trained ones moved."""
    for n in NAMES:
        for leaf, v in got[n].items():
            if n in frozen:
                np.testing.assert_array_equal(v, before[n][leaf], (n, leaf))
                np.testing.assert_array_equal(want[n][leaf], before[n][leaf])
            np.testing.assert_allclose(v, want[n][leaf], rtol=0, atol=2e-5,
                                       err_msg=f"{n}.{leaf}")
    trained = [n for n in NAMES if n not in frozen]
    assert trained and all(
        any(np.abs(got[n][k] - before[n][k]).max() > 1e-6 for k in got[n])
        for n in trained), "an unfrozen layer did not train"


def _jax_local(kind, head=False):
    from bigdl_tpu.dataset.dataset import DataSet
    from bigdl_tpu.dataset.sample import Sample
    from bigdl_tpu.nn import MSECriterion
    from bigdl_tpu.optim import Optimizer, SGD, Trigger

    m = _jmodel()
    if head:
        m.freeze()
        m.unfreeze("fc3")
    else:
        m.freeze("fc1", "fc3")
    opt = Optimizer(model=m, dataset=DataSet.array(
        [Sample(x, y) for x, y in _local_samples()]),
        criterion=MSECriterion(), batch_size=8,
        end_trigger=Trigger.max_iteration(STEPS))
    opt.set_optim_method(SGD(learning_rate=0.1, weight_decay=0.05) if head
                         else _jmethod(kind))
    opt.optimize()
    return _jlayers(m)


@pytest.mark.parametrize("kind", ["sgd", "rmsprop"])
def test_frozen_layers_stay_bit_identical_local(kind):
    """``tests/test_freeze.py:49`` in the local mode (``LocalOptimizer``
    through ``make_train_step``)."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import Optimizer, Trigger

    s = _scope()
    m = s["tmodel"](_weights()).freeze("fc1", "fc3")
    before = s["layers"](m)
    opt = Optimizer(m, DataSet.array([Sample(x, y)
                                      for x, y in _local_samples()]),
                    MSECriterion(), batch_size=8,
                    end_trigger=Trigger.max_iteration(STEPS))
    opt.set_optim_method(s["method"](kind))
    opt.optimize()
    _held(s["layers"](m), _jax_local(kind), {"fc1", "fc3"}, before)


def test_freeze_all_then_unfreeze_head():
    """``tests/test_freeze.py:107``: ``freeze(); unfreeze("fc3")`` trains
    the head only, as JAX's does; a bare ``unfreeze()`` clears every
    flag and the mask is then ``None``."""
    from bigdl_tpu_torch.dataset import DataSet, Sample
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.optim.train_step import frozen_mask_tree

    s = _scope()
    m = s["tmodel"](_weights())
    m.freeze()
    m.unfreeze("fc3")
    before = s["layers"](m)
    opt = Optimizer(m, DataSet.array([Sample(x, y)
                                      for x, y in _local_samples()]),
                    MSECriterion(), batch_size=8,
                    end_trigger=Trigger.max_iteration(STEPS))
    opt.set_optim_method(SGD(learning_rate=0.1, weight_decay=0.05))
    opt.optimize()
    _held(s["layers"](m), _jax_local("sgd", head=True), {"fc1", "fc2"},
          before)
    m2 = s["tmodel"](_weights()).freeze("fc1")
    m2.unfreeze()
    assert not m2[0].is_frozen()
    assert frozen_mask_tree(m2, dict(m2.named_parameters())) is None


def test_unfreeze_and_whole_module_freeze():
    """``tests/test_freeze.py:74``: the tri-state flags and the error for
    an unknown name, as JAX's."""
    m = _scope()["tmodel"](_weights())
    m.freeze()
    assert m.is_frozen() and m.frozen_flag() is True
    m.unfreeze()
    assert not m.is_frozen() and m.frozen_flag() is None
    m.freeze("fc2")
    assert m[1].is_frozen() and not m[0].is_frozen()
    m.unfreeze("fc2")
    assert not m[1].is_frozen() and m[1].frozen_flag() is False
    with pytest.raises(ValueError, match="no sub-module"):
        m.freeze("nope")


def test_mask_names_the_frozen_leaves():
    """``frozen_mask_tree`` keys the params by name, an explicit
    ``False`` overriding a frozen ancestor; ``child_for_key`` resolves a
    parameter name and a JAX ``"{i}:{name}"`` key to the child."""
    from bigdl_tpu_torch.optim.train_step import (
        apply_frozen, child_for_key, frozen_mask_tree, zero_frozen_grads,
    )

    m = _scope()["tmodel"](_weights())
    m.freeze()
    m.unfreeze("fc2")
    params = dict(m.named_parameters())
    mask = frozen_mask_tree(m, params)
    assert {k: v for k, v in mask.items()} == {
        k: not k.startswith("1:") for k in params}
    assert child_for_key(m, "1:fc2.weight") is m[1]
    assert child_for_key(m, "2:Linear77") is m[2]    # a JAX tree's key
    assert child_for_key(m[0], "weight") is None
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    zeroed = zero_frozen_grads(mask, grads)
    assert all(bool((g == 0).all()) == mask[k] for k, g in zeroed.items())
    new = {k: p.detach().clone() + 1 for k, p in params.items()}
    apply_frozen(mask, new, params)
    for k, p in params.items():
        assert torch.equal(new[k], p) == mask[k]


def test_frozen_grads_leave_the_global_norm():
    """``make_train_step`` with an l2 clip: the frozen gradients are
    zeroed BEFORE the clip (JAX's order), so one step equals JAX's."""
    import jax.numpy as jnp

    from bigdl_tpu.nn import MSECriterion as JMSE
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    data = _local_samples(8)
    x = np.stack([a for a, _ in data])
    y = np.stack([b for _, b in data])
    jm = _jmodel().freeze("fc1")
    jsgd = JSGD(learning_rate=0.5, weight_decay=0.1)
    jp, _, _, _ = jmake(jm, JMSE(), jsgd, grad_clip={"l2_norm": 0.01})(
        jm.params, jsgd.init_state(jm.params), jm.state, None,
        jnp.asarray(x), jnp.asarray(y))
    s = _scope()
    m = s["tmodel"](_weights()).freeze("fc1")
    before = s["layers"](m)
    sgd = SGD(learning_rate=0.5, weight_decay=0.1)
    params = {k: p.detach().clone() for k, p in m.named_parameters()}
    step = make_train_step(m, MSECriterion(), sgd,
                           grad_clip={"l2_norm": 0.01})
    params, _, _, _ = step(params, sgd.init_state(params), {}, None,
                           torch.from_numpy(x), torch.from_numpy(y))
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
    _held(s["layers"](m), {k.split(":")[1]: {a: np.asarray(b)
                                             for a, b in d.items()}
                           for k, d in jp.items()}, {"fc1"}, before)


def test_batchnorm_statistics_still_update_under_freeze():
    """Running statistics are model state, not params: a frozen BN's
    weights stay, its running mean and variance move (as in JAX)."""
    from bigdl_tpu_torch.nn import (
        BatchNormalization, Linear, MSECriterion, Sequential,
    )
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.optim.train_step import make_train_step

    g = torch.Generator().manual_seed(0)
    m = (Sequential().add(BatchNormalization(6, device="cpu")
                          .set_name("bn"))
         .add(Linear(6, 2, device="cpu", generator=g)))
    m.freeze("bn")
    params = {k: p.detach().clone() for k, p in m.named_parameters()}
    before = {k: v.clone() for k, v in params.items()}
    state = {k: b.detach().clone() for k, b in m.named_buffers()}
    sgd = SGD(0.1, weight_decay=0.1)
    x = torch.randn(8, 6, generator=g) + 3.0
    params, _, state, _ = make_train_step(m.train(), MSECriterion(), sgd)(
        params, sgd.init_state(params), state, None, x, torch.zeros(8, 2))
    for k, v in params.items():
        assert torch.equal(v, before[k]) == k.startswith("0:bn")
    assert float(state["0:bn.running_mean"].abs().max()) > 0.1


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two gloo ranks' results and JAX's mesh runs of every
    configuration, computed while the ranks run."""
    from jax.sharding import Mesh

    from bigdl_tpu.dataset.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.nn import MSECriterion as JMSE
    from bigdl_tpu.optim import Trigger as JTrigger
    from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri

    rs = np.random.RandomState(1)
    x = rs.rand(24, 6).astype(np.float32)
    y = rs.rand(24, 2).astype(np.float32)
    spec = {"x": x, "y": y, "weights": _weights(), "steps": STEPS,
            "cfgs": CFGS}
    tmp = tmp_path_factory.mktemp("freeze")
    (tmp / "spec.pkl").write_bytes(pickle.dumps(spec))
    (tmp / "worker.py").write_text(WORKER)
    wait = launch([[sys.executable, str(tmp / "worker.py"), str(r), "2",
                    str(tmp / "rdv"), str(tmp / "spec.pkl"),
                    str(tmp / "out")] for r in range(2)], str(tmp / "logs"))
    jax_out = {}
    for key in sorted(set(JAX_OF.values())):
        cfg = CFGS[key]
        jm = _jmodel()
        if cfg.get("head"):
            jm.freeze()
            jm.unfreeze("fc3")
        else:
            jm.freeze("fc1", "fc3")
        opt = JDistri(model=jm, dataset=JDataSet.distributed(
            [JSample(x[i], y[i]) for i in range(24)]), criterion=JMSE(),
            batch_size=24, parameter_mode=cfg["mode"],
            mesh=Mesh(np.asarray(jax.devices()[:2]), ("data",)))
        opt.set_optim_method(_jmethod(cfg["optim"]))
        opt.set_end_when(JTrigger.max_iteration(STEPS))
        if cfg.get("l2") is not None:
            opt.set_gradient_clipping_by_l2_norm(cfg["l2"])
        opt.retry_times = 1
        opt.optimize()
        jax_out[key] = _jlayers(jm)
    wait()
    got = [pickle.loads((tmp / f"out.{r}").read_bytes()) for r in range(2)]
    return got, jax_out


@pytest.mark.parametrize("key", sorted(CFGS))
def test_frozen_layers_stay_bit_identical_distri(ranks, key):
    """``tests/test_freeze.py:49`` in the allreduce and partitioned modes
    (and the port's blockstore mode), with SGD's weight decay and
    RMSprop; every rank ends with the same weights."""
    got, jax_out = ranks
    before = _scope()["layers"](_scope()["tmodel"](_weights()))
    frozen = {"fc1", "fc2"} if CFGS[key].get("head") else {"fc1", "fc3"}
    for res in got:
        _held(res[key], jax_out[JAX_OF[key]], frozen, before)
        for n in NAMES:
            for leaf in res[key][n]:
                np.testing.assert_array_equal(res[key][n][leaf],
                                              got[0][key][n][leaf])


def test_clip_order_differs_between_modes(ranks):
    """JAX's partitioned step zeroes frozen gradients before the l2
    norm, its allreduce step after it; so the two clipped runs part, in
    JAX and in the port alike."""
    got, jax_out = ranks
    for src in (got[0], jax_out):
        a, p = src["allreduce_sgd_l2"]["fc2"], src["partitioned_sgd_l2"]["fc2"]
        assert np.abs(a["weight"] - p["weight"]).max() > 1e-4
