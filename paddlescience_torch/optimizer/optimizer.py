"""Optimizers (counterpart of ``paddlescience_tpu/optimizer/optimizer.py``),
factory style: ``Adam(lr)(model)``.

Adam follows optax's update rule: bias-corrected moments and ``eps``
outside the square root, p <- p - lr(t) * m_hat / (sqrt(v_hat) + eps) with
lr evaluated at the step count before the update. ``torch.optim.Adam``
computes exactly that. On CUDA it runs with ``capturable=True`` and its
learning rate is a device tensor that :meth:`Optimizer.step` writes from
the schedule's tensor form, so a train step holds no host value and can be
captured in a CUDA graph; on the CPU the schedule's Python form sets the
learning rate each step.

Adam's state (moments and step counters) is made when the optimizer is
built, as torch would make it at the first step, so that the solver can
snapshot and checkpoint it from step 0 and a captured step never
allocates it.

AdamW is ``optax.adamw``: Adam's update plus the decoupled decay lr(t) *
wd * p on every parameter (``torch.optim.AdamW``, capturable on CUDA as
Adam is).

LBFGS is ``optax.lbfgs`` as the JAX package builds it (``scale_by_lbfgs``
with the scaled initial preconditioner, then ``scale_by_zoom_linesearch``,
``optimizer/linesearch.py``), on one flat float32 vector of the model's
parameters (in ``named_parameters`` order, the order
``utils/jax_params.py`` carries them across). ``torch.optim.LBFGS`` is
another algorithm (its first step, its strong-Wolfe search and its
tolerances differ) and is not used.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from paddlescience_torch.optimizer.linesearch import ZoomLineSearch

__all__ = ["Optimizer", "Adam", "AdamW", "LBFGS", "LBFGSOptimizer"]

Schedule = Union[float, Callable]


class Optimizer:
    """A torch optimizer driven by a schedule ``lr_fn(step)``; ``lr_t`` is
    the device learning rate of a capturable optimizer (None on the CPU)."""

    def __init__(self, torch_opt: torch.optim.Optimizer, lr_fn: Callable, name: str,
                 lr_t: Optional[torch.Tensor] = None):
        self.torch_opt = torch_opt
        self.lr_fn = lr_fn
        self.name = name
        self.lr_t = lr_t

    is_lbfgs = False

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.torch_opt.param_groups for p in group["params"]]

    def state_tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The optimizer's state as live tensors, per parameter index."""
        return {str(i): dict(self.torch_opt.state[p]) for i, p in enumerate(self.params())}

    def add_params(self, params: List[torch.Tensor]) -> None:
        """Optimize ``params`` too (a solver's learnable equation
        parameters), with the same rule, learning rate and schedule, their
        state made now as for the model's."""
        cuda = self.lr_t is not None
        self.torch_opt.add_param_group({"params": list(params)})
        for p in params:
            self.torch_opt.state[p].update(
                step=torch.zeros((), dtype=torch.float32, device=p.device if cuda else None),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))

    def zero_grad(self) -> None:
        """Zero the gradients in place (their tensors stay where a captured
        step reads them)."""
        self.torch_opt.zero_grad(set_to_none=False)

    def step(self, step):
        """Apply one update at global step ``step`` and return the lr used:
        with ``lr_t`` set, ``step`` is the float32 device step counter and
        the lr a device tensor; otherwise an int and a float."""
        lr = self.lr_fn(step)
        if self.lr_t is not None:
            if isinstance(lr, torch.Tensor):
                self.lr_t.copy_(lr)
            else:
                self.lr_t.fill_(lr)
        else:
            lr = float(lr)
            for group in self.torch_opt.param_groups:
                group["lr"] = lr
        self.torch_opt.step()
        return lr


class Adam:
    """Adam with the JAX package's defaults (beta1 0.9, beta2 0.999, eps
    1e-8; other values are not ported)."""

    def __init__(self, learning_rate: Schedule = 0.001):
        self.lr_fn = learning_rate if callable(learning_rate) else (lambda step, _lr=learning_rate: _lr)

    def __call__(self, *models) -> Optimizer:
        params = [p for m in models for p in m.parameters() if p.requires_grad]
        cuda = bool(params) and params[0].is_cuda
        lr0 = float(self.lr_fn(0))
        lr_t = torch.tensor(lr0, device=params[0].device) if cuda else None
        opt = torch.optim.Adam(params, lr=lr_t if cuda else lr0, betas=(0.9, 0.999), eps=1e-8,
                               capturable=cuda, foreach=True if cuda else None)
        for p in params:
            opt.state[p].update(
                step=torch.zeros((), dtype=torch.float32, device=p.device if cuda else None),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
        return Optimizer(opt, self.lr_fn, "Adam", lr_t)


class AdamW:
    """AdamW with the JAX package's defaults (beta1 0.9, beta2 0.999, eps
    1e-8, weight decay 0.01); ``grad_clip`` is not ported."""

    def __init__(self, learning_rate: Schedule = 0.001, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.01, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError("AdamW's grad_clip is not ported yet")
        self.lr_fn = learning_rate if callable(learning_rate) else (lambda step, _lr=learning_rate: _lr)
        self.betas = (beta1, beta2)
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def __call__(self, *models) -> Optimizer:
        params = [p for m in models for p in m.parameters() if p.requires_grad]
        cuda = bool(params) and params[0].is_cuda
        lr0 = float(self.lr_fn(0))
        lr_t = torch.tensor(lr0, device=params[0].device) if cuda else None
        opt = torch.optim.AdamW(params, lr=lr_t if cuda else lr0, betas=self.betas, eps=self.epsilon,
                                weight_decay=self.weight_decay, capturable=cuda, foreach=True if cuda else None)
        for p in params:
            opt.state[p].update(
                step=torch.zeros((), dtype=torch.float32, device=p.device if cuda else None),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(p, memory_format=torch.preserve_format))
        return Optimizer(opt, self.lr_fn, "AdamW", lr_t)


ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class LBFGSOptimizer:
    """optax's ``lbfgs(memory_size=history_size, linesearch=
    scale_by_zoom_linesearch(max_linesearch_steps))`` on the flat vector of
    ``params``; every state tensor lives on the parameters' device.

    :meth:`step` takes the value and gradient at the current parameters
    (the solver reuses those the previous search stored, as
    ``optax.value_and_grad_from_state`` does) and a ``value_and_grad(flat)``
    closure over this step's batch, and moves the parameters in place.
    """

    is_lbfgs = True

    def __init__(self, params: List[torch.Tensor], history_size: int, max_linesearch_steps: int):
        if history_size < 1:
            raise ValueError("memory_size must be >= 1")
        self._params = list(params)
        self.history_size = history_size
        flat = self.flat_params()
        m, n, dev = history_size, flat.numel(), flat.device
        self.state: Dict[str, torch.Tensor] = {
            "count": torch.zeros((), dtype=torch.int64, device=dev),
            "params": torch.zeros(n, dtype=torch.float32, device=dev),
            "updates": torch.zeros(n, dtype=torch.float32, device=dev),
            "diff_params_memory": torch.zeros(m, n, dtype=torch.float32, device=dev),
            "diff_updates_memory": torch.zeros(m, n, dtype=torch.float32, device=dev),
            "weights_memory": torch.zeros(m, dtype=torch.float32, device=dev),
        }
        self.count = 0  # the host's copy of state["count"]
        self.linesearch = ZoomLineSearch(max_linesearch_steps)
        self.linesearch.init_state(flat)
        self.evaluations: List[int] = []  # value-and-gradient evaluations of each step taken

    def params(self) -> List[torch.Tensor]:
        return self._params

    def flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self._params])

    @torch.no_grad()
    def set_flat_params(self, flat: torch.Tensor) -> None:
        ofs = 0
        for p in self._params:
            p.copy_(flat[ofs: ofs + p.numel()].view_as(p))
            ofs += p.numel()

    def flat_grad(self, grads) -> torch.Tensor:
        return torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                          for g, p in zip(grads, self._params)])

    def state_tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"lbfgs": dict(self.state), "linesearch": dict(self.linesearch.state)}

    def sync_from_state(self) -> None:
        """Re-read the host's step count after the state was loaded in place."""
        self.count = int(self.state["count"])

    def stored_value_and_grad(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The value and gradient the last search stored, or None when the
        value is not finite (at the first step: optax then evaluates)."""
        value = self.linesearch.state["value"]
        if not bool(torch.isfinite(value)):
            return None
        return value.clone(), self.linesearch.state["grad"].clone()

    @torch.no_grad()
    def _precondition(self, grad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """optax ``scale_by_lbfgs``: write this step's (s, y) pair into the
        ring, then the two-loop recursion P_k g (Nocedal and Wright,
        Algorithm 7.4) with gamma = <s, y> / <y, y> (min(1, 1 / |g|) at the
        first step). Ring slots never written hold zeros and change nothing
        (optax runs them anyway), so only the written ones are visited."""
        st, m, c = self.state, self.history_size, self.count
        mem_idx, prev_idx = c % m, (c - 1) % m
        if c > 0:
            dp, du = w - st["params"], grad - st["updates"]
            vd = torch.dot(du, dp)
            weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            den = torch.dot(du, du)
            scale = torch.where(den > 0.0, vd / den, torch.ones_like(den))
        else:
            dp = du = torch.zeros_like(w)
            weight = torch.zeros((), dtype=torch.float32, device=w.device)
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        st["diff_params_memory"][prev_idx].copy_(dp)
        st["diff_updates_memory"][prev_idx].copy_(du)
        st["weights_memory"][prev_idx].copy_(weight)
        rhos, dps, dus = (st[k].unbind(0) for k in ("weights_memory", "diff_params_memory", "diff_updates_memory"))
        written = [(mem_idx + j) % m for j in range(m)][m - min(c, m):]  # oldest first
        vec, alphas = grad, []
        for idx in reversed(written):  # vec + (-alpha) dus[idx], as optax's add_scale
            alpha = rhos[idx] * torch.dot(dps[idx], vec)
            vec = torch.addcmul(vec, alpha, dus[idx], value=-1.0)
            alphas.append(alpha)
        vec = scale * vec
        for idx, alpha in zip(written, reversed(alphas)):
            beta = rhos[idx] * torch.dot(dus[idx], vec)
            vec = torch.addcmul(vec, alpha - beta, dps[idx])
        st["params"].copy_(w)
        st["updates"].copy_(grad)
        self.count = c + 1
        st["count"].fill_(self.count)
        return vec

    def step(self, value: torch.Tensor, grad: torch.Tensor, value_and_grad: ValueAndGrad,
             evaluated: bool = False) -> torch.Tensor:
        """One L-BFGS step from the current parameters, where the objective
        is ``value`` with gradient ``grad`` (``evaluated``: they were
        computed for this step, not taken from the last search). Moves the
        parameters to w + eta d and returns eta."""
        w = self.flat_params()
        direction = -self._precondition(grad.detach(), w)
        eta = self.linesearch.search(w, direction, value, grad.detach(), value_and_grad)
        self.set_flat_params(w + eta * direction)
        self.evaluations.append(int(evaluated) + len(self.linesearch.trace))
        return eta


class LBFGS:
    """Full-batch L-BFGS with optax's zoom line search (the JAX package's
    ``LBFGS``: ``max_iter`` is the line search's largest number of trials
    a step, ``history_size`` the memory). ``learning_rate``,
    ``max_eval``, ``tolerance_grad`` and ``tolerance_change`` are kept for
    the signature and, as in JAX, unused under ``"strong_wolfe"``; the JAX
    solver cannot run another ``line_search_fn`` (it finds no stored value
    to start from), so the port refuses one."""

    def __init__(self, learning_rate: float = 1.0, max_iter: int = 20, max_eval: Optional[int] = None,
                 tolerance_grad: float = 1e-8, tolerance_change: float = 1e-9, history_size: int = 100,
                 line_search_fn: Optional[str] = "strong_wolfe"):
        if line_search_fn != "strong_wolfe":
            raise ValueError(f"line_search_fn={line_search_fn!r}: only 'strong_wolfe' is supported (the solver's "
                             "L-BFGS step starts from the value and gradient the line search stores)")
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.max_eval = max_eval
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn

    def __call__(self, *models) -> LBFGSOptimizer:
        params = [p for m in models for p in m.parameters() if p.requires_grad]
        return LBFGSOptimizer(params, self.history_size, self.max_iter)
