"""The port's remaining OptimMethods (``bigdl_tpu_torch/optim/
optim_method.py``: ``Adadelta``, ``Adamax``, ``RMSprop``, ``Ftrl``,
``LarsSGD``) held against the JAX package's on the CPU, the twin of
``tests/test_optim_methods.py:83``, ``:171`` and ``:206``.

Trajectories: the same params (three tensors, one all zeros, which
exercises LarsSGD's ratio fallback) and the same ten numpy-seeded
gradient dicts through both updates; after every step the params, and
after the tenth every slot, agree within f32 rounding (rtol 1e-5, atol
1e-6; the two packages may round a multiply-add once or twice). ``LarsSGD`` is held to its trust
ratio ``trust·‖w‖ / (‖g‖ + wd·‖w‖ + ε)`` (1 for a zero tensor) in both
packages. The convergence runs mirror JAX's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401

STEPS = 10


def _methods():
    from bigdl_tpu.optim import optim_method as J
    from bigdl_tpu_torch.optim import optim_method as T

    return {
        "Adadelta": (J.Adadelta(0.9, 1e-6), T.Adadelta(0.9, 1e-6)),
        "Adamax": (J.Adamax(0.01), T.Adamax(0.01)),
        "RMSprop": (J.RMSprop(0.01, 0.1, 0.9), T.RMSprop(0.01, 0.1, 0.9)),
        "Ftrl": (J.Ftrl(0.05), T.Ftrl(0.05)),
        "Ftrl_l1_l2": (J.Ftrl(0.05, -0.5, 0.1, 0.02, 0.05),
                       T.Ftrl(0.05, -0.5, 0.1, 0.02, 0.05)),
        "LarsSGD": (J.LarsSGD(0.5, momentum=0.9, weight_decay=0.01,
                              trust=0.02),
                    T.LarsSGD(0.5, momentum=0.9, weight_decay=0.01,
                              trust=0.02)),
        "LarsSGD_no_momentum": (J.LarsSGD(0.5, momentum=0.0, trust=0.02),
                                T.LarsSGD(0.5, momentum=0.0, trust=0.02)),
    }


def _params():
    rng = np.random.default_rng(5)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "z": np.zeros((4,), np.float32)}


def _grads():
    rng = np.random.default_rng(6)
    return [{k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in _params().items()} for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs():
    """name → (params after each step, final state), JAX's update over
    the ten gradient dicts."""
    out = {}
    for name, (jm, _) in _methods().items():
        params = {k: jnp.asarray(v) for k, v in _params().items()}
        state = jm.init_state(params)
        traj = []
        for g in _grads():
            params, state = jm.update({k: jnp.asarray(v) for k, v in
                                       g.items()}, state, params)
            traj.append(jax.device_get(params))
        out[name] = (traj, jax.device_get(state))
    return out


@pytest.mark.parametrize("name", sorted(_methods()))
def test_trajectory_matches_jax(jax_runs, name):
    _, tm = _methods()[name]
    traj, jstate = jax_runs[name]
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    state = tm.init_state(params)
    for i, g in enumerate(_grads()):
        params, state = tm.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, state, params)
        for k, v in params.items():
            np.testing.assert_allclose(v.numpy(), traj[i][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {i} {k}")
    assert state["neval"] == int(jstate["neval"]) == STEPS
    for slot, tree in jstate.items():
        if slot == "neval":
            continue
        for k, v in tree.items():
            np.testing.assert_allclose(state[slot][k].numpy(), v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {slot}")


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_lars_step_is_its_trust_ratio(wd):
    """One momentum-free step moves each tensor by ``clr·ratio·(g +
    wd·w)`` with the ratio of the formula, in both packages."""
    from bigdl_tpu.optim import LarsSGD as JLars
    from bigdl_tpu_torch.optim import LarsSGD

    p0, g = _params(), _grads()[0]
    trust, eps, lr = 0.02, 1e-9, 0.5
    want_ratio = {k: (trust * np.linalg.norm(v)
                      / (np.linalg.norm(g[k]) + wd * np.linalg.norm(v) + eps)
                      if np.linalg.norm(v) > 0 else 1.0)
                  for k, v in p0.items()}
    tm = LarsSGD(lr, momentum=0.0, weight_decay=wd, trust=trust)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ratios = tm.trust_ratios({k: torch.from_numpy(v) for k, v in g.items()},
                             tp)
    np.testing.assert_allclose(ratios.numpy(), [want_ratio[k] for k in tp],
                               rtol=1e-6)
    tm.update({k: torch.from_numpy(v) for k, v in g.items()},
              tm.init_state(tp), tp)
    jm = JLars(lr, momentum=0.0, weight_decay=wd, trust=trust)
    jp, _ = jm.update({k: jnp.asarray(v) for k, v in g.items()},
                      jm.init_state(p0), {k: jnp.asarray(v)
                                          for k, v in p0.items()})
    for k, v in p0.items():
        want = v - lr * want_ratio[k] * (g[k] + wd * v)
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(jp[k]), want, rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("name,iters", [("RMSprop", 100), ("Adadelta", 3000),
                                        ("Adamax", 100), ("Ftrl", 100)])
def test_methods_converge_on_a_quadratic(name, iters):
    """``tests/test_optim_methods.py:83``'s run, on the port."""
    from bigdl_tpu_torch.optim import Adadelta, Adamax, Ftrl, RMSprop

    method = {"RMSprop": lambda: RMSprop(learning_rate=0.05),
              "Adadelta": lambda: Adadelta(epsilon=1e-4),
              "Adamax": lambda: Adamax(learning_rate=0.1),
              "Ftrl": lambda: Ftrl(learning_rate=0.5)}[name]()
    target = torch.arange(4.0)
    params = {"x": torch.zeros(4)}
    state = method.init_state(params)
    for _ in range(iters):
        params, state = method.update({"x": params["x"] - target}, state,
                                      params)
    loss = float(((params["x"] - target) ** 2).sum())
    assert loss < 1.0, f"{name} did not converge: {loss}"


def test_lars_sgd_trains():
    """``tests/test_optim_methods.py:171``: a linear fit's loss falls by
    10x in 60 LARS steps."""
    from bigdl_tpu_torch.optim import LarsSGD

    rng = np.random.default_rng(2)
    w_true = torch.from_numpy(rng.standard_normal((6, 2)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((128, 6)).astype(np.float32))
    y = x @ w_true
    params = {"w": torch.from_numpy(
        (rng.standard_normal((6, 2)) * 0.1).astype(np.float32)),
              "b": torch.zeros(2)}
    opt = LarsSGD(learning_rate=1.0, momentum=0.9, trust=0.01)
    state = opt.init_state(params)
    losses = []
    for _ in range(60):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = ((x @ leaves["w"] + leaves["b"] - y) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, [leaves["w"], leaves["b"]])
        params, state = opt.update({"w": gw, "b": gb}, state, params)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.1, f"{losses[0]} -> {losses[-1]}"
