"""L-BFGS (the counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

Limited-memory BFGS with an optional strong-Wolfe line search and the
closure API, ``step(closure)``.  The quasi-Newton arithmetic runs on one
flat f32 vector on the parameters' device: the history's dot products
and the two-loop recursion are a few vector operations, not a loop over
parameters.

Eager only, by design: each closure evaluation's loss and several dot
products are read on the host (``float(loss.item())``) to steer the
line search and the stopping tests, as in the JAX package.  Do not run
it inside a captured step.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


class LBFGS(Optimizer):
    """``parameters``: the tensors to optimize (``requires_grad``);
    ``step(closure)`` runs up to ``max_iter`` iterations and returns the
    first evaluation's loss."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if weight_decay is not None or grad_clip is not None:
            # the closure computes f without them: the line search's f and
            # g would disagree
            raise NotImplementedError(
                "LBFGS does not support weight_decay/grad_clip: fold the "
                "penalty into the closure's loss instead")
        if parameters is None:
            raise ValueError("parameters must be given "
                             "(pass model.parameters())")
        super().__init__(learning_rate, parameters, None, None, name,
                         multi_precision=False)
        if max_eval is None:
            max_eval = max_iter * 5 // 4
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                f"only 'strong_wolfe' line search is supported, got "
                f"{line_search_fn!r}")
        self.max_iter = max_iter
        self.max_eval = max_eval
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._hist_s: list = []
        self._hist_y: list = []
        self._rho: list = []
        self._first_iter = True
        self._n_evals = 0
        self._last_loss_tensor = None

    # -- flat <-> parameters -------------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    def _gather(self, attr):
        ps = self._params()
        if attr == "data":
            return _flat(ps)
        return _flat([p.grad if p.grad is not None else torch.zeros_like(p)
                      for p in ps])

    @torch.no_grad()
    def _scatter(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].view(p.shape).to(p.dtype))
            off += n

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is not None and set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def _closure_eval(self, closure, x=None):
        if x is not None:
            self._scatter(x)
        self.clear_grad()
        with torch.enable_grad():
            loss = closure()
        self._last_loss_tensor = loss  # step() returns the tensor
        self._n_evals += 1
        return float(loss.item()), self._gather("grad")

    # -- two-loop recursion --------------------------------------------------
    def _direction(self, g):
        q = -g
        if not self._hist_s:
            return q
        alphas = []
        for s, y, rho in zip(reversed(self._hist_s),
                             reversed(self._hist_y),
                             reversed(self._rho)):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        s_last, y_last = self._hist_s[-1], self._hist_y[-1]
        gamma = torch.dot(s_last, y_last) / torch.clamp(
            torch.dot(y_last, y_last), min=1e-20)
        q = q * gamma
        for (s, y, rho), a in zip(zip(self._hist_s, self._hist_y,
                                      self._rho), reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return q

    def _push_history(self, s, y):
        ys = float(torch.dot(y, s))
        if ys > 1e-10:
            self._hist_s.append(s)
            self._hist_y.append(y)
            self._rho.append(1.0 / ys)
            if len(self._hist_s) > self.history_size:
                self._hist_s.pop(0)
                self._hist_y.pop(0)
                self._rho.pop(0)

    # -- strong-Wolfe line search (bracket, then bisection) ------------------
    def _strong_wolfe(self, closure, x0, d, f0, g0, t, c1=1e-4, c2=0.9,
                      max_ls=25):
        dg0 = float(torch.dot(g0, d))
        if dg0 >= 0:  # not a descent direction: no move
            return f0, g0, 0.0

        def phi(t_):
            f, g = self._closure_eval(closure, x0 + t_ * d)
            return f, g, float(torch.dot(g, d))

        # bracket phase
        t_prev, f_prev, dg_prev = 0.0, f0, dg0
        g_prev = g0
        bracket = None
        for _ in range(max_ls):
            f_new, g_new, dg_new = phi(t)
            if f_new > f0 + c1 * t * dg0 or f_new >= f_prev:
                bracket = (t_prev, t, f_prev, f_new, g_prev, g_new,
                           dg_prev, dg_new)
                break
            if abs(dg_new) <= -c2 * dg0:
                return f_new, g_new, t
            if dg_new >= 0:
                bracket = (t, t_prev, f_new, f_prev, g_new, g_prev,
                           dg_new, dg_prev)
                break
            t_prev, f_prev, g_prev, dg_prev = t, f_new, g_new, dg_new
            t = t * 2.0
        else:
            # exhausted: the last point evaluated (t was doubled after it)
            return f_new, g_new, t_prev

        # zoom phase
        lo, hi, f_lo, f_hi, g_lo, g_hi, dg_lo, dg_hi = bracket
        for _ in range(max_ls):
            if abs(hi - lo) * abs(dg0) < self.tolerance_change:
                break
            t = 0.5 * (lo + hi)
            f_new, g_new, dg_new = phi(t)
            if f_new > f0 + c1 * t * dg0 or f_new >= f_lo:
                hi, f_hi, g_hi, dg_hi = t, f_new, g_new, dg_new
            else:
                if abs(dg_new) <= -c2 * dg0:
                    return f_new, g_new, t
                if dg_new * (hi - lo) >= 0:
                    hi, f_hi, g_hi, dg_hi = lo, f_lo, g_lo, dg_lo
                lo, f_lo, g_lo, dg_lo = t, f_new, g_new, dg_new
        return f_lo, g_lo, lo

    # -- the closure-driven step --------------------------------------------
    def step(self, closure=None):
        """One L-BFGS pass (up to ``max_iter`` iterations).  ``closure``
        evaluates the loss and calls ``loss.backward()``; the first
        evaluation's loss is returned."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        self._n_evals = 0
        lr = self.get_lr()

        loss, flat_grad = self._closure_eval(closure)
        orig_loss = self._last_loss_tensor
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return orig_loss

        x = self._gather("data")
        for _ in range(self.max_iter):
            d = self._direction(flat_grad)
            if self._first_iter:
                t = min(1.0, 1.0 / max(float(flat_grad.abs().sum()),
                                       1e-10)) * lr
                self._first_iter = False
            else:
                t = lr

            if self.line_search_fn == "strong_wolfe":
                f_new, g_new, t = self._strong_wolfe(
                    closure, x, d, loss, flat_grad, t)
                x_new = x + t * d
                self._scatter(x_new)
            else:
                x_new = x + t * d
                f_new, g_new = self._closure_eval(closure, x_new)

            self._push_history(x_new - x, g_new - flat_grad)
            delta_x = float((x_new - x).abs().max()) if t != 0 else 0.0
            delta_f = abs(f_new - loss)
            x, loss, flat_grad = x_new, f_new, g_new

            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            if t == 0.0 or delta_x <= self.tolerance_change \
                    or delta_f <= self.tolerance_change:
                break
            if self._n_evals >= self.max_eval:
                break
        self._scatter(x)
        return orig_loss

    # -- checkpointing -------------------------------------------------------
    def state_dict(self):
        """The JAX package's keys: ``global_step``, ``LR_Scheduler`` under
        a scheduler, and ``lbfgs`` (the history as numpy arrays)."""
        out = {"global_step": self._global_step}
        if self._learning_rate_scheduler is not None:
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["lbfgs"] = {
            "hist_s": [s.cpu().numpy() for s in self._hist_s],
            "hist_y": [y.cpu().numpy() for y in self._hist_y],
            "rho": list(self._rho),
            "first_iter": self._first_iter,
        }
        return out

    def set_state_dict(self, state):
        state = dict(state)  # the caller's dict stays as it is
        lb = state.pop("lbfgs", {})
        if "LR_Scheduler" in state and \
                self._learning_rate_scheduler is not None:
            self._learning_rate.set_state_dict(state.pop("LR_Scheduler"))
        self._global_step = int(state.pop("global_step", 0))
        ps = self._params()
        device = ps[0].device if ps else torch.device("cpu")

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
        self._hist_s = [dev(s) for s in lb.get("hist_s", [])]
        self._hist_y = [dev(y) for y in lb.get("hist_y", [])]
        self._rho = list(lb.get("rho", []))
        self._first_iter = bool(lb.get("first_iter", True))
