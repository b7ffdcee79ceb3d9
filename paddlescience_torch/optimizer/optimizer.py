"""Optimizers (counterpart of ``paddlescience_tpu/optimizer/optimizer.py``),
factory style: ``Adam(lr)(model)``.

Every rule is optax's, as the JAX package chains it (``_chain``): the
gradient clip first (``grad_clip``), then the coupled weight decay
(``weight_decay``: g + wd * p, optax ``add_decayed_weights``), then the
base rule, whose update is scaled by -lr(t), lr evaluated at the step
count before the update. The clip and the decay act on the gradients in
place before the base rule (:func:`_preprocess`):

* ``{"name": "global_norm", "clip_norm": c}`` is optax
  ``clip_by_global_norm``: every gradient becomes (g / |G|) * c when the
  global norm |G| is at least c, else stays (no 1e-6 added, as torch's
  ``clip_grad_norm_`` adds);
* ``{"name": "norm", "clip_norm": c}`` is optax ``clip_by_block_rms``:
  each array on its own is divided by max(1, rms(g) / c), a per-array RMS
  clip, not an L2 norm;
* ``{"name": "value", "clip_value": v}`` is optax ``clip``.

Base rules: Adam (``optax.adam``) and AdamW (``optax.adamw``: Adam's
update plus the decoupled decay lr(t) * wd * p) run on ``torch.optim.Adam``
/ ``torch.optim.AdamW``, which compute exactly optax's update; SGD,
Momentum (optax ``sgd`` with ``trace``, optionally Nesterov), RMSProp and
Adam's ``amsgrad`` run on :class:`_OptaxRule`, written out by hand where
torch's rules differ from optax's: optax's ``rmsprop`` divides by
sqrt(nu + eps), eps inside the root (torch: sqrt(v) + eps), and applies
its momentum trace after the learning rate; optax's ``amsgrad`` keeps the
running maximum of the bias-corrected nu_hat (torch: of the raw second
moment, corrected afterwards).

Every update is made of ``torch._foreach_*`` and tensor ops with the
step counts and (on CUDA) the learning rate as device tensors: no host
read, no host branch on a tensor, so the solver's K-step CUDA graph
captures it. On CUDA the learning rate is a device tensor ``lr_t`` that
:meth:`Optimizer.step` writes from the schedule's tensor form; on the CPU
the schedule's Python form sets it each step. The optimizer's state is
made when it is built, as torch would make it at the first step, so that
the solver can snapshot and checkpoint it from step 0 and a captured step
never allocates it.

``OptimizerList`` holds one optimizer per parameter group (each built on
its own model, as ``Adam(lr)(model_a)``), stepped together.

LBFGS is ``optax.lbfgs`` as the JAX package builds it (``scale_by_lbfgs``
with the scaled initial preconditioner, then ``scale_by_zoom_linesearch``,
``optimizer/linesearch.py``), on one flat float32 vector of the model's
parameters (in ``named_parameters`` order, the order
``utils/jax_params.py`` carries them across) followed by the solver's
learnable equation parameters. ``torch.optim.LBFGS`` is another
algorithm (its first step, its strong-Wolfe search and its tolerances
differ) and is not used.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from paddlescience_torch.optimizer.linesearch import ZoomLineSearch

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "RMSProp", "LBFGS", "LBFGSOptimizer", "OptimizerList"]

Schedule = Union[float, Callable]
_CLIP_NAMES = {"global_norm": "global_norm", "ClipGradByGlobalNorm": "global_norm", "norm": "norm",
               "ClipGradByNorm": "norm", "value": "value", "ClipGradByValue": "value"}


def _as_schedule(lr: Schedule) -> Callable:
    return lr if callable(lr) else (lambda step, _lr=lr: _lr)


def _check_clip(grad_clip: Optional[dict]) -> Optional[dict]:
    if not grad_clip:
        return None
    name = grad_clip.get("name", "global_norm")
    if name not in _CLIP_NAMES:
        raise ValueError(f"unknown grad_clip '{name}'")
    return {**grad_clip, "name": _CLIP_NAMES[name]}


@torch.no_grad()
def _preprocess(params: Sequence[torch.Tensor], grad_clip: Optional[dict], weight_decay: Optional[float]) -> None:
    """The JAX package's ``_chain`` before the base rule, on the gradients
    in place: the clip, then the coupled weight decay."""
    grads = [p.grad for p in params]
    if grad_clip is not None:
        kind = grad_clip["name"]
        if kind == "global_norm":
            c = float(grad_clip["clip_norm"])
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < c
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * c))
        elif kind == "norm":
            c = float(grad_clip["clip_norm"])
            for g in grads:
                g.div_(torch.clamp(torch.sqrt((g * g).mean()) / c, min=1.0))
        else:
            v = float(grad_clip["clip_value"])
            torch._foreach_clamp_min_(grads, -v)
            torch._foreach_clamp_max_(grads, v)
    if weight_decay:
        torch._foreach_add_(grads, [p.detach() for p in params], alpha=weight_decay)


def _zeros_state(p: torch.Tensor, names: Sequence[str], cuda: bool) -> Dict[str, torch.Tensor]:
    state = {"step": torch.zeros((), dtype=torch.float32, device=p.device if cuda else None)}
    state.update((n, torch.zeros_like(p, memory_format=torch.preserve_format)) for n in names)
    return state


class _OptaxRule(torch.optim.Optimizer):
    """optax's ``sgd`` (``momentum`` None: no trace), ``sgd`` with
    ``trace(momentum, nesterov)``, ``rmsprop(decay, eps, momentum)`` (no
    centering, no bias correction, nu from 0) and ``amsgrad(b1, b2, eps)``,
    by hand (module docstring). ``lr`` is a float or, on CUDA, the device
    tensor the wrapper writes each step."""

    STATE = {"sgd": (), "momentum": ("trace",), "rmsprop": ("nu", "trace"), "amsgrad": ("mu", "nu", "nu_max")}

    def __init__(self, params, lr, kind: str, momentum: float = 0.0, nesterov: bool = False, decay: float = 0.9,
                 eps: float = 1e-8, b1: float = 0.9, b2: float = 0.999):
        if kind not in self.STATE:
            raise ValueError(f"unknown rule {kind}")
        super().__init__(params, dict(lr=lr, kind=kind, momentum=momentum, nesterov=nesterov, decay=decay,
                                      eps=eps, b1=b1, b2=b2))

    def state_names(self, group) -> Tuple[str, ...]:
        names = self.STATE[group["kind"]]
        return tuple(n for n in names if n != "trace" or group["momentum"])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            lr, kind, m = group["lr"], group["kind"], group["momentum"]
            torch._foreach_add_([st["step"] for st in states], 1.0)
            if kind == "amsgrad":
                b1, b2, eps = group["b1"], group["b2"], group["eps"]
                mu, nu, nu_max = ([st[n] for st in states] for n in ("mu", "nu", "nu_max"))
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
                torch._foreach_mul_(nu, b2)
                torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
                updates = []
                for st, mu_i, nu_i, max_i in zip(states, mu, nu, nu_max):
                    c = st["step"]
                    nu_hat = nu_i / (1.0 - torch.pow(b2, c))
                    torch.maximum(max_i, nu_hat, out=max_i)
                    updates.append((mu_i / (1.0 - torch.pow(b1, c))) / (torch.sqrt(max_i) + eps))
                torch._foreach_add_(params, torch._foreach_mul(updates, -lr))
                continue
            if kind == "rmsprop":
                d, eps = group["decay"], group["eps"]
                nu = [st["nu"] for st in states]
                torch._foreach_mul_(nu, d)
                torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - d))
                updates = torch._foreach_mul(grads, torch._foreach_rsqrt(torch._foreach_add(nu, eps)))
                updates = torch._foreach_mul(updates, -lr)
                if m:
                    updates = self._trace(states, updates, m, group["nesterov"])
                torch._foreach_add_(params, updates)
                continue
            updates = list(grads)
            if kind == "momentum":
                updates = self._trace(states, updates, m, group["nesterov"])
            torch._foreach_add_(params, torch._foreach_mul(updates, -lr))

    @staticmethod
    def _trace(states, updates, decay: float, nesterov: bool):
        """optax ``trace``: t <- g + decay * t; the update is t (Nesterov:
        g + decay * t)."""
        trace = [st["trace"] for st in states]
        torch._foreach_mul_(trace, decay)
        torch._foreach_add_(trace, updates)
        if nesterov:
            return torch._foreach_add(updates, torch._foreach_mul(trace, decay))
        return trace


class Optimizer:
    """A torch optimizer driven by a schedule ``lr_fn(step)``; ``lr_t`` is
    the device learning rate of a capturable optimizer (None on the CPU);
    ``grad_clip`` and ``weight_decay`` (coupled) act on the gradients
    before the rule (:func:`_preprocess`)."""

    def __init__(self, torch_opt: torch.optim.Optimizer, lr_fn: Callable, name: str,
                 lr_t: Optional[torch.Tensor] = None, grad_clip: Optional[dict] = None,
                 weight_decay: Optional[float] = None):
        self.torch_opt = torch_opt
        self.lr_fn = lr_fn
        self.name = name
        self.lr_t = lr_t
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        for p in self.params():
            self._init_state(p)

    is_lbfgs = False

    def _state_names(self) -> Tuple[str, ...]:
        if isinstance(self.torch_opt, _OptaxRule):
            return self.torch_opt.state_names(self.torch_opt.param_groups[0])
        return ("exp_avg", "exp_avg_sq")

    def _init_state(self, p: torch.Tensor) -> None:
        self.torch_opt.state[p].update(_zeros_state(p, self._state_names(), self.lr_t is not None))

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.torch_opt.param_groups for p in group["params"]]

    def state_tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The optimizer's state as live tensors, per parameter index."""
        return {str(i): dict(self.torch_opt.state[p]) for i, p in enumerate(self.params())}

    def add_params(self, params: List[torch.Tensor]) -> None:
        """Optimize ``params`` too (a solver's learnable equation
        parameters), with the same rule, learning rate and schedule, their
        state made now as for the model's."""
        self.torch_opt.add_param_group({"params": list(params)})
        for p in params:
            self._init_state(p)

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
        if self.grad_clip is not None or self.weight_decay:
            _preprocess(self.params(), self.grad_clip, self.weight_decay)
        self.torch_opt.step()
        return lr


def _build(models, lr_fn, name: str, make: Callable, grad_clip=None, weight_decay=None) -> Optimizer:
    """The wrapper around ``make(params, lr)`` for the trainable parameters
    of ``models``: lr a device tensor on CUDA (capturable), else a float."""
    params = [p for m in models for p in m.parameters() if p.requires_grad]
    cuda = bool(params) and params[0].is_cuda
    lr0 = float(lr_fn(0))
    lr_t = torch.tensor(lr0, device=params[0].device) if cuda else None
    return Optimizer(make(params, lr_t if cuda else lr0, cuda), lr_fn, name, lr_t, _check_clip(grad_clip),
                     weight_decay or None)


class SGD:
    """optax ``sgd(lr)``: p <- p - lr(t) g, after the clip and the coupled
    weight decay."""

    def __init__(self, learning_rate: Schedule = 0.001, weight_decay: Optional[float] = None, grad_clip=None):
        self.lr_fn = _as_schedule(learning_rate)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def __call__(self, *models) -> Optimizer:
        return _build(models, self.lr_fn, "SGD", lambda ps, lr, cuda: _OptaxRule(ps, lr, "sgd"),
                      self.grad_clip, self.weight_decay)


class Momentum:
    """optax ``sgd(lr, momentum, nesterov)``: the trace t <- g + m t, then
    p <- p - lr(t) t (Nesterov: p <- p - lr(t) (g + m t))."""

    def __init__(self, learning_rate: Schedule, momentum: float = 0.9, weight_decay: Optional[float] = None,
                 grad_clip=None, use_nesterov: bool = False):
        self.lr_fn = _as_schedule(learning_rate)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.use_nesterov = use_nesterov

    def __call__(self, *models) -> Optimizer:
        make = lambda ps, lr, cuda: _OptaxRule(ps, lr, "momentum", momentum=self.momentum,
                                               nesterov=self.use_nesterov)
        return _build(models, self.lr_fn, "Momentum", make, self.grad_clip, self.weight_decay)


class Adam:
    """optax ``adam(lr, b1, b2, eps)`` (``amsgrad``: optax ``amsgrad``),
    after the clip and the coupled weight decay, with the JAX package's
    defaults."""

    def __init__(self, learning_rate: Schedule = 0.001, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: Optional[float] = None, grad_clip=None,
                 amsgrad: bool = False):
        self.lr_fn = _as_schedule(learning_rate)
        self.betas = (beta1, beta2)
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.amsgrad = amsgrad

    def __call__(self, *models) -> Optimizer:
        (b1, b2), eps = self.betas, self.epsilon
        if self.amsgrad:
            make = lambda ps, lr, cuda: _OptaxRule(ps, lr, "amsgrad", b1=b1, b2=b2, eps=eps)
        else:
            make = lambda ps, lr, cuda: torch.optim.Adam(ps, lr=lr, betas=(b1, b2), eps=eps, capturable=cuda,
                                                         foreach=True if cuda else None)
        return _build(models, self.lr_fn, "Adam", make, self.grad_clip, self.weight_decay)


class AdamW:
    """optax ``adamw(lr, b1, b2, eps, weight_decay)`` after the clip, with
    the JAX package's defaults (``torch.optim.AdamW``, capturable on CUDA
    as Adam is)."""

    def __init__(self, learning_rate: Schedule = 0.001, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.01, grad_clip=None):
        self.lr_fn = _as_schedule(learning_rate)
        self.betas = (beta1, beta2)
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def __call__(self, *models) -> Optimizer:
        make = lambda ps, lr, cuda: torch.optim.AdamW(ps, lr=lr, betas=self.betas, eps=self.epsilon,
                                                      weight_decay=self.weight_decay, capturable=cuda,
                                                      foreach=True if cuda else None)
        return _build(models, self.lr_fn, "AdamW", make, self.grad_clip)


class RMSProp:
    """optax ``rmsprop(lr, decay=rho, eps, momentum)``: nu <- rho nu + (1 -
    rho) g^2 from nu = 0, the update -lr(t) g / sqrt(nu + eps), then the
    momentum trace of the scaled updates; after the clip and the coupled
    weight decay."""

    def __init__(self, learning_rate: Schedule, rho: float = 0.95, epsilon: float = 1e-6, momentum: float = 0.0,
                 weight_decay: Optional[float] = None, grad_clip=None):
        self.lr_fn = _as_schedule(learning_rate)
        self.rho = rho
        self.epsilon = epsilon
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def __call__(self, *models) -> Optimizer:
        make = lambda ps, lr, cuda: _OptaxRule(ps, lr, "rmsprop", decay=self.rho, eps=self.epsilon,
                                               momentum=self.momentum)
        return _build(models, self.lr_fn, "RMSProp", make, self.grad_clip, self.weight_decay)


class OptimizerList:
    """One optimizer per parameter group (the JAX package's
    ``OptimizerList``, an ``optax.multi_transform`` over the ModelList's
    children): each was built on its own model; they step together at the
    same global step. The first optimizer's schedule is the list's, and
    learnable equation parameters join the first, as in JAX (label
    ``"0"``)."""

    is_lbfgs = False

    def __init__(self, optimizer_list: List[Optimizer]):
        self.optimizer_list = list(optimizer_list)
        if any(getattr(o, "is_lbfgs", False) for o in self.optimizer_list):
            raise ValueError("OptimizerList takes first-order optimizers only")
        self.lr_fn = self.optimizer_list[0].lr_fn
        self.lr_t = self.optimizer_list[0].lr_t
        self.name = "OptimizerList(" + ", ".join(o.name for o in self.optimizer_list) + ")"

    def __getitem__(self, i):
        return self.optimizer_list[i]

    def __len__(self):
        return len(self.optimizer_list)

    def params(self) -> List[torch.Tensor]:
        return [p for o in self.optimizer_list for p in o.params()]

    def state_tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {f"{k}.{i}": st for k, o in enumerate(self.optimizer_list) for i, st in o.state_tensors().items()}

    def add_params(self, params: List[torch.Tensor]) -> None:
        self.optimizer_list[0].add_params(params)

    def zero_grad(self) -> None:
        for o in self.optimizer_list:
            o.zero_grad()

    def step(self, step):
        lrs = [o.step(step) for o in self.optimizer_list]
        return lrs[0]


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
        self.max_linesearch_steps = max_linesearch_steps
        self._init_state()

    def add_params(self, params: List[torch.Tensor]) -> None:
        """Optimize ``params`` too (a solver's learnable equation
        parameters), appended to the flat vector, as the JAX solver runs
        L-BFGS on (params, eq_params); the memory and the line search's
        state are made anew for the longer vector (before any step)."""
        if self.count:
            raise RuntimeError("L-BFGS parameters can only be added before the first step")
        self._params.extend(params)
        self._init_state()

    def _init_state(self) -> None:
        history_size, max_linesearch_steps = self.history_size, self.max_linesearch_steps
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
