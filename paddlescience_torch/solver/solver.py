"""Solver — the training engine (counterpart of
``paddlescience_tpu/solver/solver.py``).

A train step:

1. sample each device-sampled constraint's batch from the solver's
   ``torch.Generator`` (full-batch constraints were staged once; an
   indexed dataset's loader gives a new host batch each step, copied to
   the device from pinned memory);
2. evaluate every constraint's expressions and loss
   (``_constraint_losses``);
3. aggregate with the aggregator's weights (detached), back-propagate, and
   take the optimizer step at the schedule's learning rate.

Every ``update_freq`` steps a GradNorm-style aggregator's weights are
refreshed, outside the step, from per-loss gradient norms on a batch of
their own (``_maybe_refresh_agg_weights``, as the JAX solver's amortized
refresh). With ``loss_granularity="key"`` the aggregator sees one loss per
output key of each constraint, named ``"{constraint}.{key}"``
(``_loss_names``), and the refresh takes one gradient norm per key.

``state`` is the training state as a detached copy (``state_dict``), and
assigning to it copies a state into the live tensors (``_load_state``):
``next_solver.state = solver.state`` carries parameters, optimizer
moments, the step the schedule reads, the aggregator's weights and the
batch generator from one solver into the next, as the JAX solver's
``state`` does between the stages of a curriculum.

``train()`` runs epochs ``last_epoch + 1 .. epochs`` in chunks of K steps,
as the JAX solver's ``_train_fused_static`` runs K steps per ``lax.scan``
dispatch. On CUDA a chunk of K > 1 steps is captured once in a
``torch.cuda.CUDAGraph`` and replayed once per chunk: the graph holds the
batch draws (the generator is registered with it), the kernels, the
backward and the optimizer update, so a chunk is one host call. Between
chunks the aggregator refresh runs eagerly and writes its weights into the
tensor the graph reads. A constraint over an indexed dataset (a
``BatchLoader`` of a ``NamedArrayDataset``) draws K host batches before
each chunk into a static (K, B, ...) device buffer, and step i of the chunk
reads slice i, as the JAX solver's ``_train_fused`` stacks K batches a
scan; the aggregator refresh sees the chunk's first batch. On the CPU (and
for K = 1) a chunk runs K eager steps. Before the first chunk of a static
K-step run, ``solver/autotune.py::maybe_autotune`` may time the
derivative-path candidates and pin the fastest, as the JAX solver does
before it builds its scan. After each epoch: eval every ``eval_freq``
epochs from ``start_eval_epoch`` (keeping ``best_model``), ``epoch_<k>``
every ``save_freq`` epochs, and ``latest``. ``eval()`` runs the validators,
``predict()`` the model (and expressions) on given inputs, and
``output_dir/checkpoints/`` holds the checkpoints that ``checkpoint_path``
resumes from.

With an L-BFGS optimizer (``optimizer/optimizer.py::LBFGS``) a step is the
JAX solver's ``_build_lbfgs_step``: the objective is the plain sum of the
constraint losses (no aggregator); the step starts from the value and
gradient the previous line search stored (computed on the previous step's
batch), as ``optax.value_and_grad_from_state`` does, evaluating them only
at the first step; the line search then evaluates the objective on this
step's batch. Such a step is a host loop (each trial reads its value and
slope), so ``train()`` runs L-BFGS steps one by one, eagerly, without the
autotuner, as the JAX solver never fuses them; the derivative path is the
process default.

Learnable equation parameters (``PDE.create_parameter``, e.g.
``Vibration``'s k1, k2) are moved to the solver's device and optimized by
the model's optimizer with its schedule (L-BFGS: on the one flat vector of
the model's parameters and theirs), as the JAX solver's transform runs on
(params, eq_params); they are part of ``state_dict`` (and so of
checkpoints, resume and the carried ``state``) and are updated in place, so
a captured graph reads them. With a ``ModelList`` the solver's models are
its children, each with its own derivative stack; a child frozen by
``Arch.freeze`` requires no gradient and stays out of the optimizer, so
its parameters never change (the JAX solver zeroes its updates).

Aggregators: a weight-based one (``loss/mtl``) gives the total from the
losses, the device step and the solver's generator (Relobralo's lookback
draw), writing its moving state in place; a gradient-surgery one (PCGrad,
AGDA: ``needs_grads``) gets one backward per loss into flat gradient
vectors over the optimizer's parameters, and its merged vector is written
into their gradients (the logged total is the plain sum of the losses),
as the JAX solver's step does. With ``ema_avg`` (``utils/ema.py``) the
averaged parameters are updated in place after each update, inside the
captured step; they are part of the state (checkpoints, resume) and
``eval()`` runs on them, ``predict()`` on the parameters, as in JAX.

Training randomness inside a model (the Earthformer family's dropout and
noisy MoE gates) draws from the solver's generator: before each train step
(and each aggregator refresh, which the JAX solver computes inside its
step) every model with a ``set_train_rng`` method is handed
``self.generator``; ``eval()`` and ``predict()`` hand it None, as the JAX
solver hands a fresh key a step and resets it for eval and predict. The
draws are thus part of the captured chunks (the generator is registered
with each graph, so each replay draws anew), and a checkpoint's generator
state repeats them on resume. ``AFNONet`` has no ``set_train_rng`` and
keeps its own ``dropout_generator`` attribute, which the solver leaves
alone: the JAX solver never hands AFNONet a key (it has no
``set_train_rng`` there either), so handing it this generator would turn
on dropout that the reference does not run.

Not ported yet: microbatching, gradient accumulation and the
multi-process branches.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlescience_torch.arch.model_list import ModelList
from paddlescience_torch.autodiff import ad
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss import mtl
from paddlescience_torch.utils import expression, save_load
from paddlescience_torch.utils.step_graph import StepGraph

__all__ = ["Solver"]


def _batch_mode(cst) -> str:
    return getattr(cst.dataset, "batch_mode", "indexed")


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


class Solver:
    """Trains ``model`` on ``constraint`` with ``optimizer``, evaluates it
    on ``validator`` and saves checkpoints under ``output_dir`` (None: no
    checkpoints). ``device`` is where batches are drawn and the model runs
    (CUDA when None); ``seed`` seeds the solver's batch generator there."""

    def __init__(
        self,
        model,
        constraint: Optional[Dict[str, object]] = None,
        output_dir: Optional[str] = "./output",
        optimizer=None,
        epochs: int = 5,
        iters_per_epoch: int = 20,
        save_freq: int = 0,
        log_freq: int = 10,
        eval_during_train: bool = False,
        start_eval_epoch: int = 1,
        eval_freq: int = 1,
        seed: int = 42,
        equation: Optional[Dict[str, object]] = None,
        validator: Optional[Dict[str, object]] = None,
        pretrained_model_path: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        compute_metric_by_batch: bool = False,
        loss_aggregator: Optional[mtl.LossAggregator] = None,
        loss_granularity: str = "constraint",
        ema_avg=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.constraint = dict(constraint or {})
        self.output_dir = output_dir
        self.optimizer = optimizer
        self.epochs = epochs
        self.iters_per_epoch = iters_per_epoch
        self.save_freq = save_freq
        self.log_freq = log_freq
        self.eval_during_train = eval_during_train
        self.start_eval_epoch = start_eval_epoch
        self.eval_freq = eval_freq
        self.validator = validator
        self.compute_metric_by_batch = compute_metric_by_batch
        self.equation = equation or {}
        self.eq_params = self._place_eq_params()
        if self.eq_params and optimizer is not None:
            optimizer.add_params(list(self.eq_params.values()))
        if loss_granularity not in ("constraint", "key"):
            raise ValueError(f"loss_granularity must be 'constraint' or 'key', got {loss_granularity}")
        self.loss_granularity = loss_granularity
        self.loss_aggregator = loss_aggregator or mtl.Sum(model, len(self._loss_names()))
        self.agg_state = self.loss_aggregator.init_state(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.models = list(model.model_list) if isinstance(model, ModelList) else [model]
        self.ema_avg = ema_avg
        # the averaged parameters, independent copies (the JAX solver's state["avg_params"])
        self.avg_params: Dict[str, torch.Tensor] = (
            {n: p.detach().clone() for n, p in self.model.named_parameters()} if ema_avg is not None else {})
        self.step = 0
        # the schedule's step counter on the device, advanced inside each (captured) step
        self._step_t = torch.zeros((), dtype=torch.float32, device=self.device)
        self.best_metric = {"metric": float("inf"), "epoch": 0}
        self.last_epoch = 0
        self.loss_history: List[Tuple[int, float]] = []
        # per constraint / validator: the derivative components its expressions request
        self._jet_requests: Dict[str, dict] = {name: {} for name in self.constraint}
        self._eval_requests: Dict[str, dict] = {}
        # full-batch constraints without transforms feed the same arrays every step: stage once
        static = [name for name, cst in self.constraint.items() if cst.data_iter is not None
                  and _batch_mode(cst) == "full" and getattr(cst.dataset, "transforms", None) is None]
        self._static_batches = {name: tuple(self._to_device(part) for part in next(self.constraint[name].data_iter))
                                for name in static}
        # the others (indexed, generator, transformed full batches): a new host batch each step, staged per
        # chunk into static (K, B, ...) device buffers that step i of the chunk reads at slice i
        self._indexed = [name for name, cst in self.constraint.items()
                         if cst.data_iter is not None and name not in static]
        self._chunk_bufs: Dict[tuple, tuple] = {}
        self._chunk: Dict[str, tuple] = {}
        self._chunk_pos = 0
        # K-step chunks, captured in CUDA graphs on the card (utils/step_graph.py); the loop reaches the
        # solver weakly, so a dropped solver frees its graphs at once
        me = weakref.proxy(self)
        self.loop = StepGraph(lambda i: me._chunk_step(i), self.device, snapshot=lambda: me.state,
                              restore=lambda snap: me._load_state(snap), generator=self.generator)
        self._last_save_t: Optional[float] = None

        if pretrained_model_path is not None:
            self.load_pretrain(pretrained_model_path)
        if checkpoint_path is not None:
            restored = save_load.load_checkpoint(checkpoint_path)
            metric = restored.pop("_metric", {})
            self._load_state(restored)
            if "metric" in metric:
                self.best_metric = {"metric": metric["metric"], "epoch": int(metric.get("epoch", 0))}
            self.last_epoch = int(metric.get("last_epoch", metric.get("epoch", 0)))

    # ------------------------------------------------------------ state --

    def _to_device(self, tree: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=self.device) for k, v in tree.items()}

    def _place_eq_params(self) -> Dict[str, torch.Tensor]:
        """The equations' learnable parameters by name, each moved to the
        solver's device as a leaf that requires a gradient and put back
        into its equation (whose closures read it from there); later
        equations win on a shared name, as the JAX solver's merge."""
        params: Dict[str, torch.Tensor] = {}
        for eq in self.equation.values():
            learnable = getattr(eq, "learnable_parameters", None) or {}
            for name, value in learnable.items():
                learnable[name] = params[name] = value.detach().to(self.device, torch.float32).requires_grad_(True)
        return params

    @property
    def _lbfgs(self) -> bool:
        return bool(getattr(self.optimizer, "is_lbfgs", False))

    def state_dict(self) -> Dict[str, object]:
        """The training state, as live tensors: model parameters, the
        learnable equation parameters and the model's buffers, the
        optimizer's state per parameter (in the optimizer's order, the
        equation parameters last; L-BFGS: its memory and the line search's
        state), the aggregator's state, the batch generator's state, the
        step and, with ``ema_avg``, the averaged parameters."""
        extra = {"avg_params": dict(self.avg_params)} if self.ema_avg is not None else {}
        return {**extra,
            "params": dict(self.model.named_parameters()),
            "eq_params": dict(self.eq_params),
            "buffers": dict(self.model.named_buffers()),
            "opt_state": self.optimizer.state_tensors() if self.optimizer is not None else {},
            "agg_state": dict(self.agg_state),
            "generator": self.generator.get_state(),
            "step": self.step,
        }

    @torch.no_grad()
    def _load_state(self, state: Dict[str, object], params_only: bool = False) -> None:
        """Copy ``state`` (as :meth:`state_dict` gives it) into the live
        tensors in place, so a captured graph keeps reading them."""
        named = dict(self.model.named_parameters())
        if set(state["params"]) != set(named):
            raise KeyError(f"checkpoint parameters {sorted(state['params'])} != model's {sorted(named)}")
        for n, v in state["params"].items():
            named[n].copy_(v)
        if params_only:
            return
        eq_params = state.get("eq_params", {})
        if set(eq_params) != set(self.eq_params):
            raise KeyError(f"checkpoint equation parameters {sorted(eq_params)} != {sorted(self.eq_params)}")
        for n, v in eq_params.items():
            self.eq_params[n].copy_(v)
        buffers = dict(self.model.named_buffers())
        for n, v in state["buffers"].items():
            buffers[n].copy_(v)
        opt = self.optimizer.state_tensors() if self.optimizer is not None else {}
        for i, tensors in opt.items():
            for k, v in state["opt_state"][i].items():
                tensors[k].copy_(v)
        if self._lbfgs:
            self.optimizer.sync_from_state()
        for k, v in state["agg_state"].items():
            self.agg_state[k].copy_(v)
        if self.ema_avg is not None:
            for n, v in state.get("avg_params", state["params"]).items():
                self.avg_params[n].copy_(v)
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])
        self._step_t.fill_(self.step)

    @property
    def state(self) -> Dict[str, object]:
        """A detached copy of :meth:`state_dict`."""
        return _clone(self.state_dict())

    @state.setter
    def state(self, state: Dict[str, object]) -> None:
        self._load_state(state)

    def release_graphs(self) -> None:
        """Drop the captured graphs and the staged batch buffers (their
        memory pools go with them); the next chunk captures anew."""
        self.loop.release()
        self._chunk_bufs.clear()
        self._chunk.clear()

    def load_state_params(self, other: "Solver") -> None:
        """Copy ``other``'s model parameters into this solver's (a second
        phase that starts from the first's, as ``polish.state["params"] =
        solver.state["params"]`` in JAX)."""
        self._load_state({"params": other.state["params"]}, params_only=True)

    def load_pretrain(self, pretrained_model_path: str) -> None:
        """Load the model parameters of a checkpoint (nothing else)."""
        params = save_load.load_pretrain(pretrained_model_path, dict(self.model.named_parameters()))
        self._load_state({"params": params}, params_only=True)

    def _save(self, prefix: str, metric=None, print_log: bool = True) -> None:
        save_load.save_checkpoint(self.state_dict(), self.output_dir, prefix, metric=metric, print_log=print_log)

    # ------------------------------------------------------- train step --

    def _batches(self) -> Dict[str, tuple]:
        batches = dict(self._static_batches)
        for name in self._indexed:
            batches[name] = tuple({k: v[self._chunk_pos] for k, v in part.items()} for part in self._chunk[name])
        for name, cst in self.constraint.items():
            if cst.data_iter is None:
                batches[name] = cst.dataset.sample_fn(self.generator)
        return batches

    def _stage_host_batches(self, k: int) -> None:
        """Draw ``k`` batches from each indexed constraint's loader and copy
        them, from pinned host memory on CUDA, into that constraint's static
        (k, B, ...) device buffers (allocated at first use, so a captured
        graph keeps reading them). Raises ValueError when k > 1 and a
        batch's shapes differ from the buffers' (a loader with
        ``drop_last=False``); an eager single step (k = 1, never captured)
        takes its batch at any shape, as the JAX solver retraces for the
        short last batch."""
        for name in self._indexed:
            draws = [next(self.constraint[name].data_iter) for _ in range(k)]
            host = []
            for i in range(3):
                part = {}
                for key in draws[0][i]:
                    arrs = [np.asarray(d[i][key], dtype=np.float32) for d in draws]
                    if any(a.shape != arrs[0].shape for a in arrs):
                        raise ValueError(f"constraint '{name}': batches of '{key}' differ in shape "
                                         f"{sorted({a.shape for a in arrs})}; keep drop_last=True")
                    part[key] = np.stack(arrs)
                host.append(part)
            bufs = self._chunk_bufs.get((name, k))
            if bufs is not None and k == 1 and any(
                    v.shape != tuple(buf[key].shape) for part, buf in zip(host, bufs) for key, v in part.items()):
                bufs = None  # an eager step's batch of another shape: buffers of its own
            if bufs is None:
                bufs = tuple({key: torch.empty(v.shape, dtype=torch.float32, device=self.device)
                              for key, v in part.items()} for part in host)
                self._chunk_bufs[(name, k)] = bufs
            for part, buf in zip(host, bufs):
                shapes = {key: tuple(v.shape) for key, v in part.items()}
                if shapes != {key: tuple(v.shape) for key, v in buf.items()}:
                    raise ValueError(f"constraint '{name}': a batch of shapes {shapes} does not fit the staged "
                                     f"buffers {({key: tuple(v.shape) for key, v in buf.items()})}; every batch "
                                     f"must have one shape (drop_last=True)")
                for key, v in part.items():
                    src = torch.from_numpy(v)
                    if self.device.type == "cuda":
                        buf[key].copy_(src.pin_memory(), non_blocking=True)
                    else:
                        buf[key].copy_(src)
            self._chunk[name] = bufs

    def _loss_names(self) -> List[str]:
        """The names of the losses the aggregator sees, in its order: the
        constraints; under ``loss_granularity="key"`` each constraint's
        ``output_keys`` (else its expressions' keys) as
        ``"{constraint}.{key}"``."""
        if self.loss_granularity == "constraint":
            return list(self.constraint)
        names = []
        for name, cst in self.constraint.items():
            keys = tuple(getattr(cst, "output_keys", ()) or ()) or tuple((cst.output_expr or {}).keys())
            names.extend(f"{name}.{k}" for k in keys)
        return names

    def _constraint_losses(self, batches) -> Dict[str, torch.Tensor]:
        """The losses by name (:meth:`_loss_names`): per constraint the sum
        of its per-key losses, or under ``loss_granularity="key"`` each
        key's loss."""
        losses = {}
        for name, cst in self.constraint.items():
            inp, lab, wgt = batches[name]
            outputs = expression.evaluate_expressions(self.models, inp, cst.output_expr,
                                                      request_cache=self._jet_requests[name],
                                                      extra_values=self.eq_params)
            per_key = cst.loss(outputs, lab, wgt if wgt else None)
            if self.loss_granularity == "key":
                losses.update((f"{name}.{k}", v) for k, v in per_key.items())
            else:
                losses[name] = sum(per_key.values())
        return losses

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _set_train_rng(self, generator: Optional[torch.Generator]) -> None:
        """Hand ``generator`` (None: no training randomness) to every model
        that takes one."""
        for m in self.models:
            if hasattr(m, "set_train_rng"):
                m.set_train_rng(generator)

    def _refresh_agg_weights(self) -> None:
        """Per-loss gradient norms over all parameters -> aggregator weights,
        written into the aggregator's tensors in place."""
        self._set_train_rng(self.generator)
        losses = self._constraint_losses(self._batches())
        names = self._loss_names()
        params = self._params()
        norms = []
        for i, name in enumerate(names):
            grads = torch.autograd.grad(losses[name], params, retain_graph=i < len(names) - 1,
                                        allow_unused=True)
            norms.append(torch.sqrt(sum((g * g).sum() for g in grads if g is not None)))
        new = self.loss_aggregator.update_weights(self.agg_state, torch.stack(norms))
        with torch.no_grad():
            for k, v in new.items():
                self.agg_state[k].copy_(v)

    def _maybe_refresh_agg_weights(self, global_step: int, span: int = 1) -> None:
        """Refresh the aggregator's weights if [global_step, global_step +
        span) holds a multiple of its update frequency."""
        agg = self.loss_aggregator
        if not agg.needs_grad_norms:
            return
        freq = agg.update_freq
        first_multiple = ((global_step + freq - 1) // freq) * freq
        if global_step <= first_multiple < global_step + span:
            self._refresh_agg_weights()

    def _lbfgs_step(self) -> Dict[str, torch.Tensor]:
        """One L-BFGS step (the JAX solver's ``_build_lbfgs_step``): start
        from the stored value and gradient (evaluated here only when none
        is stored), search along the L-BFGS direction with the objective on
        this step's batch. Logs the starting value, as JAX does."""
        batches = self._batches()
        names = self._loss_names()
        params = self.optimizer.params()
        self._set_train_rng(self.generator)

        def value_and_grad(flat: torch.Tensor):
            self.optimizer.set_flat_params(flat)
            losses = self._constraint_losses(batches)
            total = torch.stack([losses[n] for n in names]).sum()
            grads = torch.autograd.grad(total, params, allow_unused=True)
            return total.detach(), self.optimizer.flat_grad(grads)

        stored = self.optimizer.stored_value_and_grad()
        value, grad = stored if stored is not None else value_and_grad(self.optimizer.flat_params())
        self.optimizer.step(value, grad, value_and_grad, evaluated=stored is None)
        self._step_t += 1
        return {"loss": value.clone(), "lr": torch.zeros((), device=self.device)}

    def _step(self, step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step at global step ``step``, touching no host
        state: what a CUDA graph captures (an L-BFGS step is a host loop,
        :meth:`_lbfgs_step`, and is never captured). Returns the step's logs
        as tensors."""
        if self._lbfgs:
            return self._lbfgs_step()
        self._set_train_rng(self.generator)
        losses = self._constraint_losses(self._batches())
        names = self._loss_names()
        agg = self.loss_aggregator
        self.optimizer.zero_grad()
        if agg.needs_grads:
            total = torch.stack([losses[n] for n in names]).sum()
            self._surgery_grads([losses[n] for n in names])
        else:
            total, _ = agg.aggregate([losses[n] for n in names], self.agg_state, self._step_t, self.generator)
            total.backward()
        lr = self.optimizer.step(self._step_t if self.optimizer.lr_t is not None else step)
        self._step_t += 1
        if self.ema_avg is not None:
            named = dict(self.model.named_parameters())
            self.ema_avg.update_(list(self.avg_params.values()), [named[n] for n in self.avg_params], self._step_t)
        logs = {"loss": total.detach(), **{f"loss/{n}": losses[n].detach() for n in names}}
        logs["lr"] = lr.detach() if isinstance(lr, torch.Tensor) else torch.tensor(lr)
        return logs

    def _surgery_grads(self, losses: List[torch.Tensor]) -> None:
        """A gradient-surgery aggregator's step: one backward per loss into
        a flat vector over the optimizer's parameters (the equation
        parameters included), the (K, P) stack transformed, and the merged
        vector written into the parameters' gradients."""
        params = self.optimizer.params()
        flats = []
        for i, loss in enumerate(losses):
            grads = torch.autograd.grad(loss, params, retain_graph=i < len(losses) - 1, allow_unused=True)
            flats.append(torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                                    for g, p in zip(grads, params)]))
        merged, _ = self.loss_aggregator.transform_grads(torch.stack(flats), self.agg_state)
        ofs = 0
        with torch.no_grad():
            for p in params:
                g = merged[ofs: ofs + p.numel()].view_as(p)
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
                ofs += p.numel()

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One eager optimizer step (after the aggregator refresh when one
        is due). Returns the step's logs as tensors on the device (reading
        them synchronises)."""
        return self.train_chunk(1)

    def train_steps(self, num_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Run ``num_steps`` eager train steps (default: epochs *
        iters_per_epoch from the current step). Every ``log_freq`` steps and
        at the end the logs are read back and printed; returns those logged
        values."""
        if num_steps is None:
            num_steps = self.epochs * self.iters_per_epoch - self.step
        logged = []
        t0 = time.perf_counter()
        for i in range(num_steps):
            logs = self.train_step()
            if self.step % self.log_freq == 0 or i == num_steps - 1:
                vals = self._read_logs(logs, self.step)
                logged.append(vals)
                parts = ", ".join(f"{k.split('/', 1)[1]}: {v:.5f}" for k, v in vals.items() if k.startswith("loss/"))
                print(f"[Train][Step {self.step}] lr: {vals['lr']:.2e}, loss: {vals['loss']:.5f} "
                      f"({parts}), {time.perf_counter() - t0:.1f}s", flush=True)
        return logged

    def _read_logs(self, logs: Dict[str, torch.Tensor], step: int) -> Dict[str, float]:
        vals = {k: float(v) for k, v in logs.items()}
        vals["step"] = step
        self.loss_history.append((step, vals["loss"]))
        return vals

    # ------------------------------------------------- captured chunks --

    @property
    def graph_stats(self) -> Dict[int, Dict[str, float]]:
        """Per K: the seconds of the last K-step capture's warm-up and
        capture, and the replays since (``StepGraph.stats``)."""
        return self.loop.stats

    def _chunk_step(self, i: int) -> Dict[str, torch.Tensor]:
        """The chunk's i-th step: it reads slice i of the staged batches."""
        self._chunk_pos = i
        return self._step(self.step + i)

    def train_chunk(self, k: int, global_step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One chunk of ``k`` steps from the current step: the aggregator
        refresh if [global_step, global_step + k) holds a refresh step
        (``global_step`` defaults to the current step), then the ``k``
        steps: one replay of the captured graph on CUDA when k > 1, else
        eager steps. Indexed constraints draw their ``k`` host batches first
        (:meth:`_stage_host_batches`); the refresh sees the first. Returns
        the last step's logs as device tensors."""
        self._stage_host_batches(k)
        self._chunk_pos = 0
        self._maybe_refresh_agg_weights(self.step if global_step is None else global_step, span=k)
        if self._lbfgs and k > 1 and self.device.type == "cuda":
            raise ValueError("an L-BFGS step is a host loop and is not captured: train it with K = 1")
        logs = self.loop.run(k, graphed=k > 1)
        self.step += k
        return logs

    def _all_constraints_static(self) -> bool:
        """True when every constraint samples on the device or feeds the
        same full batch every step (no transforms): then a chunk of K steps
        needs no batch from the host."""
        for cst in self.constraint.values():
            if cst.data_iter is None:
                continue
            ds = getattr(cst, "dataset", None)
            if getattr(ds, "batch_mode", "indexed") != "full" or getattr(ds, "transforms", None) is not None:
                return False
        return True

    def _auto_fuse_steps(self) -> int:
        """The largest divisor of iters_per_epoch up to ``PSCI_FUSE_CAP``
        (default: the whole epoch, one chunk and one log line per epoch)."""
        cap = max(1, min(int(os.environ.get("PSCI_FUSE_CAP", self.iters_per_epoch)), self.iters_per_epoch))
        for k in range(cap, 1, -1):
            if self.iters_per_epoch % k == 0:
                return k
        return 1

    # ------------------------------------------------------------ train --

    def train(self, num_fused_steps: Optional[int] = None) -> List[Dict[str, float]]:
        """Train epochs ``last_epoch + 1 .. epochs`` in chunks of
        ``num_fused_steps`` steps (None: :meth:`_auto_fuse_steps` when every
        constraint is static, else 1; 1: eager steps; L-BFGS: 1, and a K > 1
        raises). Logs at every chunk that reaches a multiple of ``log_freq``
        and at each epoch's end; returns those logged values."""
        if self.optimizer is None:
            raise ValueError("no optimizer: this solver can eval and predict only")
        k = num_fused_steps
        if self._lbfgs and (k or 1) > 1:
            raise ValueError(f"num_fused_steps={k}: L-BFGS steps run one by one (a host loop each), as the JAX "
                             "solver runs them")
        if k is None:
            static = self.iters_per_epoch > 1 and self._all_constraints_static()
            k = self._auto_fuse_steps() if static and not self._lbfgs else 1
        if self.iters_per_epoch % k != 0:
            raise ValueError(f"num_fused_steps({k}) must divide iters_per_epoch({self.iters_per_epoch})")
        if k > 1 and self._all_constraints_static():
            from paddlescience_torch.solver import autotune

            autotune.maybe_autotune(self, self._static_batches, k)
        n_chunks = self.iters_per_epoch // k
        total_steps = self.epochs * self.iters_per_epoch
        start_epoch = int(self.last_epoch) + 1
        logged = []
        global_start = time.perf_counter()
        for epoch in range(start_epoch, self.epochs + 1):
            for chunk in range(n_chunks):
                logs = self.train_chunk(k, (epoch - 1) * self.iters_per_epoch + chunk * k)
                step = (epoch - 1) * self.iters_per_epoch + (chunk + 1) * k
                if step % max(self.log_freq, k) < k or chunk == n_chunks - 1:
                    vals = self._read_logs(logs, step)
                    logged.append(vals)
                    done = max(step - (start_epoch - 1) * self.iters_per_epoch, 1)
                    eta = (time.perf_counter() - global_start) / done * (total_steps - step)
                    parts = ", ".join(f"{n.split('/', 1)[1]}: {v:.5f}" for n, v in vals.items()
                                      if n.startswith("loss/"))
                    print(f"[Train][Epoch {epoch}/{self.epochs}][Iter {(chunk + 1) * k}/{self.iters_per_epoch}] "
                          f"lr: {vals['lr']:.2e}, loss: {vals['loss']:.5f} ({parts}), eta: {eta:.0f}s", flush=True)
            self.last_epoch = epoch
            if (self.eval_during_train and self.validator and epoch % self.eval_freq == 0
                    and epoch >= self.start_eval_epoch):
                target_metric, _ = self.eval(epoch)
                if target_metric < self.best_metric["metric"]:
                    self.best_metric = {"metric": target_metric, "epoch": epoch}
                    self._save("best_model", metric={**self.best_metric, "last_epoch": epoch})
            if self.save_freq > 0 and epoch % self.save_freq == 0:
                self._save(f"epoch_{epoch}")
            now = time.perf_counter()
            if epoch == self.epochs or self._last_save_t is None or now - self._last_save_t > 60.0:
                self._save("latest", metric={"metric": self.best_metric["metric"],
                                             "epoch": self.best_metric["epoch"], "last_epoch": epoch},
                           print_log=False)
                self._last_save_t = now
        return logged

    # ------------------------------------------------------------- eval --

    @torch.no_grad()
    def eval(self, epoch_id: Optional[int] = None) -> Tuple[float, Dict[str, Dict[str, float]]]:
        """Run every validator batch by batch; metrics on the concatenated
        outputs (or per batch, averaged, under ``compute_metric_by_batch``).
        Returns (the first metric value, {validator: {metric.key: value}})."""
        if not self.validator:
            raise ValueError("no validator available")
        self._set_train_rng(None)
        if self.ema_avg is not None:  # the averaged parameters, as the JAX solver's eval
            named = dict(self.model.named_parameters())
            live = {n: p.detach().clone() for n, p in named.items()}
            for n, v in self.avg_params.items():
                named[n].copy_(v)
            try:
                return self._eval(epoch_id)
            finally:
                for n, v in live.items():
                    named[n].copy_(v)
        return self._eval(epoch_id)

    def _eval(self, epoch_id: Optional[int] = None) -> Tuple[float, Dict[str, Dict[str, float]]]:
        metric_group: Dict[str, Dict[str, float]] = {}
        target_metric = None
        all_losses: List[float] = []
        for name, v in self.validator.items():
            cache = self._eval_requests.setdefault(name, {})
            all_out: Dict[str, List[torch.Tensor]] = {}
            all_lab: Dict[str, List[torch.Tensor]] = {}
            losses = []
            it = iter(v.data_loader)
            for _ in range(max(len(v.data_loader), 1)):
                inp, lab, _ = next(it)
                inp, lab = self._to_device(inp), self._to_device(lab)
                out = expression.evaluate_expressions(self.models, inp, v.output_expr, request_cache=cache,
                                                      extra_values=self.eq_params)
                losses.append(float(sum(v.loss(out, lab, None).values())))
                for k in v.output_keys:
                    all_out.setdefault(k, []).append(out[k])
                for k in lab:
                    all_lab.setdefault(k, []).append(lab[k])
            metric_group[name] = {}
            if self.compute_metric_by_batch:
                accum: Dict[str, List[float]] = {}
                for m_name, metric_fn in v.metric.items():
                    for bo, bl in zip(zip(*all_out.values()), zip(*all_lab.values())):
                        for key, val in metric_fn(dict(zip(all_out, bo)), dict(zip(all_lab, bl))).items():
                            accum.setdefault(f"{m_name}.{key}", []).append(float(val))
                for key, vals in accum.items():
                    metric_group[name][key] = float(np.mean(vals))
            else:
                full_out = {k: torch.cat(t, 0) for k, t in all_out.items()}
                full_lab = {k: torch.cat(t, 0) for k, t in all_lab.items()}
                for m_name, metric_fn in v.metric.items():
                    for key, val in metric_fn(full_out, full_lab).items():
                        metric_group[name][f"{m_name}.{key}"] = float(val)
            if target_metric is None and metric_group[name]:
                target_metric = next(iter(metric_group[name].values()))
            all_losses.extend(losses)
            loss_str = f"{np.mean(losses):.5f}" if losses else "n/a"
            print(f"[Eval][{name}] loss: {loss_str}, "
                  + ", ".join(f"{k}: {val:.5f}" for k, val in metric_group[name].items()), flush=True)
        if target_metric is None:
            target_metric = float(np.mean(all_losses)) if all_losses else float("nan")
        return target_metric, metric_group

    # ---------------------------------------------------------- predict --

    @torch.no_grad()
    def predict(self, input_dict: Dict[str, np.ndarray], expr_dict: Optional[Dict[str, Callable]] = None,
                batch_size: Optional[int] = 64, return_numpy: bool = False) -> Dict[str, object]:
        """The model's outputs (or, given ``expr_dict``, those expressions)
        on ``input_dict``, in batches of ``batch_size`` rows (all at once
        when None); numpy arrays with ``return_numpy``, else tensors on the
        device. Single process only."""
        self._set_train_rng(None)
        num = len(next(iter(input_dict.values())))
        if batch_size is None or batch_size >= num:
            batch_size = num
        cache: Dict = {}
        outs: Dict[str, List[torch.Tensor]] = {}
        for lo in range(0, num, batch_size):
            batch = self._to_device({k: np.asarray(v)[lo: lo + batch_size] for k, v in input_dict.items()})
            if expr_dict is None:
                with ad.tape_context() as tape:
                    out = expression.forward_with_derivatives(self.models, batch, tape)
                out = {k: v for k, v in out.items() if k not in batch}  # a transform may rename outputs
            else:
                out = expression.evaluate_expressions(self.models, batch, expr_dict, request_cache=cache,
                                                      extra_values=self.eq_params)
            for k, val in out.items():
                outs.setdefault(k, []).append(val)
        result = {k: torch.cat(v, 0) for k, v in outs.items()}
        return {k: v.cpu().numpy() for k, v in result.items()} if return_numpy else result
