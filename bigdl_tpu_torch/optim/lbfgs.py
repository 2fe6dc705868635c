"""L-BFGS and its strong-Wolfe line search (``bigdl_tpu/optim/lbfgs.py``;
reference ``optim/LBFGS.scala`` and ``LineSearch.scala``).

The outer loop runs on the host, as JAX's does: the bracketing line
search and the history pruning depend on the data. Every vector
operation runs where the parameters lie, over ONE flat f32 vector (the
leaves of ``x`` laid end to end, a dict's keys sorted as JAX's
``ravel_pytree`` orders them). The two-loop recursion keeps its α and β
on the device; the host reads a number only where JAX's loop does: the
loss, the gradient's largest magnitude, the directional derivatives of
the line search, ``yᵀs`` and the step's largest magnitude.

``LBFGS.optimize(feval, x)`` takes a tensor, an array or a (nested) dict
of them and ``feval(x) -> (loss, grad)`` over the same structure, and
returns ``(new_x, [loss history])`` in that structure (tensors).
L-BFGS is for full-batch problems (the reference's use), so it has no
``update`` for the train step.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.optim.optim_method import OptimMethod


def _cubic_interpolate(x1, f1, g1, x2, f2, g2):
    """Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2), clamped
    to the interval; torch's recipe."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    sq = d1 * d1 - g1 * g2
    if sq < 0:
        return (x1 + x2) / 2.0
    d2 = np.sqrt(sq)
    if x1 <= x2:
        t = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
    else:
        t = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
    lo, hi = min(x1, x2), max(x1, x2)
    return float(min(max(t, lo), hi))


def strong_wolfe(feval_dir: Callable, t: float, f0: float, g0: float,
                 c1: float = 1e-4, c2: float = 0.9, max_ls: int = 25):
    """Strong-Wolfe line search along a direction (reference ``lswolfe``).

    ``feval_dir(t) -> (f, g)`` with ``g`` the directional derivative at
    step ``t``, or ``(f, g, payload)``, in which case the accepted point's
    payload comes back too (L-BFGS passes the full gradient through, so
    the caller never evaluates the accepted point again). Returns ``(t,
    f_t, n_evals)`` without payloads, ``(t, f_t, n_evals, payload)``
    with."""
    def fe(tt):
        out = feval_dir(tt)
        return out if len(out) == 3 else (out[0], out[1], None)

    prev = (0.0, f0, g0, None)          # (t, f, g_dir, payload)
    ft, gt, pt = fe(t)
    has_payload = pt is not None
    cur = (t, ft, gt, pt)
    n_evals = 1

    def ret(point):
        if has_payload:
            return point[0], point[1], n_evals, point[3]
        return point[0], point[1], n_evals

    bracket = None
    for _ in range(max_ls):
        t, f_t, g_t, _ = cur
        if f_t > f0 + c1 * t * g0 or (n_evals > 1 and f_t >= prev[1]):
            bracket = (prev, cur)
            break
        if abs(g_t) <= -c2 * g0:
            return ret(cur)
        if g_t >= 0:
            bracket = (cur, prev)
            break
        prev = cur
        t = min(10 * t, 1e8)
        ft, gt, pt = fe(t)
        cur = (t, ft, gt, pt)
        n_evals += 1
    if bracket is None:  # ran out of extrapolations
        return ret(cur)
    # zoom: lo and hi are whole points, so the accepted return carries
    # its own (f, payload)
    lo, hi = bracket
    for _ in range(max_ls):
        t = _cubic_interpolate(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])
        span = abs(hi[0] - lo[0])
        if span < 1e-9:
            break
        if min(abs(t - lo[0]), abs(t - hi[0])) < 0.1 * span:
            t = (lo[0] + hi[0]) / 2.0
        ft, gt, pt = fe(t)
        cur = (t, ft, gt, pt)
        n_evals += 1
        if ft > f0 + c1 * t * g0 or ft >= lo[1]:
            hi = cur
        else:
            if abs(gt) <= -c2 * g0:
                return ret(cur)
            if gt * (hi[0] - lo[0]) >= 0:
                hi = lo
            lo = cur
    return ret(lo)


def _leaves(tree, out):
    """Append ``tree``'s tensor leaves to ``out`` in ``ravel_pytree``'s
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(torch.as_tensor(tree))
    return out


def _ravel(tree):
    """(flat f32 vector, unravel) of a tensor or a nested dict of them."""
    leaves = _leaves(tree, [])
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])

    def unravel(v):
        it = iter(torch.split(v, [t.numel() for t in leaves]))

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            ref = torch.as_tensor(node)
            return next(it).reshape(ref.shape).to(ref.dtype)

        return build(tree)

    return flat, unravel


class LBFGS(OptimMethod):
    """Full-batch L-BFGS over the flattened parameter vector."""

    def __init__(self, max_iter: int = 20, max_eval: Optional[int] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: Optional[str] = "strong_wolfe") -> None:
        super().__init__()
        self.max_iter = max_iter
        self.max_eval = (max_eval if max_eval is not None
                         else int(max_iter * 1.25))
        self.tol_fun = tol_fun
        self.tol_x = tol_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search

    def optimize(self, feval: Callable, x):
        """Up to ``max_iter`` iterations from ``x``; ``(new_x, [loss
        history])``."""
        flat0, unravel = _ravel(x)

        def fe(v):
            loss, grad = feval(unravel(v))
            gflat, _ = _ravel(grad)
            return float(loss), gflat.to(v.device)

        xk = flat0
        f, g = fe(xk)
        losses: List[float] = [f]
        n_evals = 1
        s_hist: List[torch.Tensor] = []
        y_hist: List[torch.Tensor] = []
        rho_hist: List[float] = []
        gamma = 1.0

        for it in range(self.max_iter):
            if float(g.abs().max()) <= self.tol_fun:
                break
            # two-loop recursion; α and β stay device scalars
            q = g
            alphas = []
            for s, y, rho in zip(reversed(s_hist), reversed(y_hist),
                                 reversed(rho_hist)):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            d = gamma * q
            for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist),
                                      reversed(alphas)):
                b = rho * torch.dot(y, d)
                d = d + (a - b) * s
            d = -d
            gtd = float(torch.dot(g, d))
            if gtd > -1e-12:  # not a descent direction: reset the history
                d = -g
                gtd = -float(torch.dot(g, g))
                s_hist, y_hist, rho_hist = [], [], []

            t0 = (self.learning_rate if it > 0 or s_hist
                  else min(1.0, 1.0 / max(float(g.abs().sum()), 1e-12))
                  * self.learning_rate)
            accepted = None
            if self.line_search == "strong_wolfe":
                def fe_dir(t):
                    ft, gt = fe(xk + t * d)
                    return ft, float(torch.dot(gt, d)), gt

                t, f_ls, ls_evals, g_ls = strong_wolfe(fe_dir, t0, f, gtd)
                n_evals += ls_evals
                if g_ls is not None:
                    accepted = (f_ls, g_ls)
            else:
                t = t0

            x_new = xk + t * d
            f_old = f
            if accepted is not None:
                f, g_new = accepted
            else:  # no search, or the search fell back to t = 0
                f, g_new = fe(x_new)
                n_evals += 1
            losses.append(f)

            s = x_new - xk
            y = g_new - g
            ys = float(torch.dot(y, s))
            if ys > 1e-10:
                if len(s_hist) >= self.n_correction:
                    s_hist.pop(0)
                    y_hist.pop(0)
                    rho_hist.pop(0)
                s_hist.append(s)
                y_hist.append(y)
                rho_hist.append(1.0 / ys)
                gamma = (torch.tensor(ys, dtype=torch.float32,
                                      device=y.device) / torch.dot(y, y))
            xk, g = x_new, g_new

            if n_evals >= self.max_eval:
                break
            if float(s.abs().max()) <= self.tol_x:
                break
            if abs(f - f_old) < self.tol_fun:
                break

        self.state["neval"] = self.state.get("neval", 1) + 1
        return unravel(xk), losses
