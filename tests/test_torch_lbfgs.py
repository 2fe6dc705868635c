"""The port's L-BFGS and strong-Wolfe line search
(``bigdl_tpu_torch/optim/lbfgs.py``) against the JAX package's on the
CPU: the cases of ``tests/test_lbfgs.py`` (``:6`` the quadratic, ``:28``
Rosenbrock, ``:45`` a small classifier from JAX's weights, ``:76`` the
line search alone); on the quadratic the first iterations' losses and
accepted step sizes against JAX's, and the strong-Wolfe conditions at
every accepted step.

Tolerances: the first five iterations' losses and step sizes 1e-4
relative (f32 dot products summed in other orders, fed back through the
two-loop recursion); the minimizers within JAX's test bars (1e-2); the
line search on a 1-D quadratic exactly (host float arithmetic, the same
operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.optim import lbfgs as jlbfgs
from bigdl_tpu_torch.optim import lbfgs as tlbfgs
from tests.torch_parity import one_torch_thread  # noqa: F401


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((6, 6)).astype(np.float32)
    A = A @ A.T + 0.5 * np.eye(6, dtype=np.float32)   # SPD
    b = rng.standard_normal(6).astype(np.float32)
    return A, b


def _recording(module, monkeypatch):
    """Wrap ``module.strong_wolfe`` to record ``(t, f_t, f0, g0, g_t)``
    of every accepted step (``g_t`` the directional derivative there)."""
    seen = []
    real = module.strong_wolfe

    def wrapped(feval_dir, t, f0, g0, *a, **kw):
        out = real(feval_dir, t, f0, g0, *a, **kw)
        g_t = feval_dir(out[0])[1]
        seen.append((out[0], out[1], f0, g0, g_t))
        return out

    monkeypatch.setattr(module, "strong_wolfe", wrapped)
    return seen


def test_quadratic_matches_jax_and_holds_strong_wolfe(monkeypatch):
    A, b = _quadratic()
    jseen = _recording(jlbfgs, monkeypatch)
    tseen = _recording(tlbfgs, monkeypatch)

    @jax.jit
    def jfeval(x):
        return 0.5 * jnp.vdot(x, A @ x) - jnp.vdot(b, x), A @ x - b

    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def tfeval(x):
        return 0.5 * torch.dot(x, At @ x) - torch.dot(bt, x), At @ x - bt

    jx, jl = jlbfgs.LBFGS(max_iter=50, max_eval=500).optimize(
        jfeval, np.zeros(6, np.float32))
    tx, tl = tlbfgs.LBFGS(max_iter=50, max_eval=500).optimize(
        tfeval, torch.zeros(6))
    x_star = np.linalg.solve(A.astype(np.float64), b)
    assert np.abs(tx.numpy() - x_star).max() < 1e-2
    assert tl[-1] < tl[0]
    assert np.abs(np.asarray(jx) - x_star).max() < 1e-2
    k = 5
    assert len(tseen) >= k and len(jseen) >= k
    for (tt, tf, *_), (jt, jf, *_) in zip(tseen[:k], jseen[:k]):
        assert abs(tt - jt) <= 1e-4 * abs(jt)
        assert abs(tf - jf) <= 1e-4 * max(abs(jf), 1.0)
    np.testing.assert_allclose(tl[:k + 1], jl[:k + 1], rtol=1e-4, atol=1e-6)
    for t, f_t, f0, g0, g_t in tseen:
        assert f_t <= f0 + 1e-4 * t * g0            # Armijo
        assert abs(g_t) <= -0.9 * g0                # strong curvature


def test_rosenbrock_reaches_the_minimum():
    def rosen(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1 - x[:-1]) ** 2)

    def feval(x):
        x = x.detach().requires_grad_()
        f = rosen(x)
        return f.detach(), torch.autograd.grad(f, x)[0]

    opt = tlbfgs.LBFGS(max_iter=200, max_eval=2000, tol_fun=1e-9)
    x, losses = opt.optimize(feval, torch.zeros(4))
    assert float((x - 1.0).abs().max()) < 1e-2, (x, losses[-1])
    assert opt.state["neval"] == 2


def test_trains_tiny_net_from_jax_weights():
    """Full-batch L-BFGS on a small classifier over a dict of the
    model's parameters, from JAX's weights: the first loss equals JAX's,
    the loss falls below JAX's test bar and accuracy passes it."""
    from torch.func import functional_call

    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.nn import Linear as JL, LogSoftMax as JLS
    from bigdl_tpu.nn import Sequential as JS, Tanh as JT
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(1)
    jm = JS().add(JL(6, 16)).add(JT()).add(JL(16, 3)).add(JLS())
    jm._ensure_params()
    tm = (tnn.Sequential().add(tnn.Linear(6, 16, device="cpu"))
          .add(tnn.Tanh()).add(tnn.Linear(16, 3, device="cpu"))
          .add(tnn.LogSoftMax()))
    load_jax_tree(tm, jax.device_get(jm.params))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 6)).astype(np.float32)
    y = (np.arange(30) % 3 + 1).astype(np.int32)
    x += np.eye(3)[y - 1].repeat(2, -1).astype(np.float32) * 2
    crit, jcrit = tnn.ClassNLLCriterion(), JNLL()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def feval(params):
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = crit.apply(functional_call(tm, ps, (xt,)), yt)
        grads = torch.autograd.grad(loss, list(ps.values()))
        return loss.detach(), dict(zip(ps, grads))

    want0 = float(jcrit.apply(jm.apply(jm.params, jnp.asarray(x),
                                       jm.state)[0], jnp.asarray(y)))
    params = {k: p.detach() for k, p in tm.named_parameters()}
    new, losses = tlbfgs.LBFGS(max_iter=30).optimize(feval, params)
    assert set(new) == set(params)
    assert all(new[k].shape == params[k].shape for k in params)
    assert abs(losses[0] - want0) <= 1e-6 * abs(want0)
    assert losses[-1] < 0.2, f"{losses[:3]}...{losses[-3:]}"
    with torch.no_grad():
        pred = functional_call(tm, new, (xt,)).argmax(-1).numpy() + 1
    assert (pred == y).mean() > 0.95


@pytest.mark.parametrize("start", [1.0, 0.1, 5.0])
def test_strong_wolfe_matches_jax_on_a_parabola(start):
    f0, g0 = 4.0, -4.0                   # f(t) = (t - 2)^2 at t = 0

    def fe(t):
        return (t - 2.0) ** 2, 2.0 * (t - 2.0)

    got = tlbfgs.strong_wolfe(fe, start, f0, g0)
    assert got == jlbfgs.strong_wolfe(fe, start, f0, g0)
    t, f_t, _ = got
    assert f_t <= f0 + 1e-4 * t * g0
    assert abs(2.0 * (t - 2.0)) <= 0.9 * abs(g0)
    payload = tlbfgs.strong_wolfe(lambda t: fe(t) + (t * 10,), start, f0, g0)
    assert payload[:3] == got and payload[3] == got[0] * 10


def test_cubic_interpolate_matches_jax():
    for args in [(0.0, 4.0, -4.0, 3.0, 1.0, 2.0), (1.0, 1.0, -2.0, 0.0,
                                                   4.0, -4.0),
                 (0.0, 1.0, 1.0, 1.0, 0.0, 1.0)]:
        assert tlbfgs._cubic_interpolate(*args) == \
            jlbfgs._cubic_interpolate(*args)
