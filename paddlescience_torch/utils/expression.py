"""Expression evaluator (counterpart of
``paddlescience_tpu/utils/expression.py``).

For one constraint: run the models on the inputs, register everything on a
derivative tape, serve the derivative components the expressions ask for
(order <= 2 from one fused jet forward per model, the rest by nested jvp,
``autodiff/ad.py``), and evaluate the expressions.

The JAX package discovers which components the expressions request by
replaying the evaluation under ``jax.eval_shape``. The port replays it on
a one-row slice of the batch under ``torch.no_grad()`` with the tape in
collecting mode: derivative requests are recorded and answered with zero
stand-ins, so the replay runs no jet forward and no kernel (the jvp of a
composed expression runs the plain forward on that row). A caller that
evaluates the same expressions every step (the solver) passes a cache, so
the replay runs once.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from paddlescience_torch.autodiff import ad
from paddlescience_torch.autodiff import jet as jetmod
from paddlescience_torch.autodiff import path as deriv_path

__all__ = ["forward_with_derivatives", "evaluate_expressions"]


def _jet_fn(model):
    def jet_fn(xb, dmultis):
        idx = jetmod.build_index(dmultis)
        jout = model.forward_jet(jetmod.seed(xb, idx))
        return {tuple(sorted(m)): jout.component(m) for m in dmultis}

    return jet_fn


def _pointwise_fn(model, diff_keys: Tuple[str, ...], out_keys: Tuple[str, ...]):
    """The model's plain batched forward as a function of the (N, d)
    coordinates (columns in ``diff_keys`` order) and the per-point extras:
    what the nested-jvp path differentiates."""

    def fn(x: torch.Tensor, extras: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feed = {k: x[..., i : i + 1] for i, k in enumerate(diff_keys)}
        feed.update(extras)
        o = model(feed)
        return torch.cat([o[k] for k in out_keys], dim=-1)

    return fn


def forward_with_derivatives(models: Sequence, input_dict: Mapping[str, torch.Tensor],
                             tape: ad.Tape) -> Dict[str, torch.Tensor]:
    """Run each model on the constraint inputs and register everything on
    the tape so ``jacobian`` works on the results. Returns the input
    coordinates plus all model outputs.

    A model's (N, 1) input columns are the coordinates it is differentiated
    along; its other inputs ride along as per-point extras. A model with
    such columns gets a derivative stack (with its jet forward where the
    derivative path has one and there are no extras). A model with none,
    e.g. on the (sets, points, 1) inputs of an integral constraint, runs its
    batched forward only and its outputs take no derivatives, as in the JAX
    package.
    """
    out: Dict[str, torch.Tensor] = {}
    for k, v in input_dict.items():
        tape.register_coord(k, v)
        out[k] = v

    for model in models:
        in_keys = tuple(model.input_keys)
        missing = [k for k in in_keys if k not in input_dict]
        if missing:
            raise KeyError(f"model inputs {missing} not found in constraint inputs {list(input_dict)}")
        feed = {k: input_dict[k] for k in in_keys}
        batched_out = model(feed)
        diff_keys = tuple(k for k in in_keys if feed[k].ndim == 2 and feed[k].shape[-1] == 1)
        if not diff_keys:
            out.update(batched_out)
            continue
        extras = {k: feed[k] for k in in_keys if k not in diff_keys}
        x = torch.cat([input_dict[k] for k in diff_keys], dim=-1)
        key_index = {k: i for i, k in enumerate(diff_keys)}
        out_keys = tuple(model.output_keys)
        out_index, ofs = {}, 0
        for k in out_keys:
            out_index[k] = ofs
            ofs += int(batched_out[k].shape[-1])
        jet_fn = None
        if deriv_path.flag("PSCI_JET", "1") == "1" and not extras and model.supports_jet():
            jet_fn = _jet_fn(model)
        stack = tape.add_stack(_pointwise_fn(model, diff_keys, out_keys), x, key_index, out_index,
                               extras=extras, jet_fn=jet_fn, out_width=ofs)
        for k in out_keys:
            tape.register_output(batched_out[k], stack, out_index[k])
            out[k] = batched_out[k]
    return out


def _collect_jet_requests(models, input_dict, output_exprs, extra_values=None):
    """Which derivative components will the expressions ask for? One
    ordered request set per stack, from a replay on the batch's first row."""
    if not any(m.supports_jet() for m in models):
        return None
    first_row = {k: v[:1] for k, v in input_dict.items()}
    with torch.no_grad(), ad.tape_context() as tape:
        tape.collecting = True
        out = forward_with_derivatives(models, first_row, tape)
        out.update(extra_values or {})
        wrapped = ad.wrap_tape_outputs(tape, out)
        for expr in output_exprs.values():
            expr(wrapped)
        return [tuple(s.requested) for s in tape._stacks]


def evaluate_expressions(
    models: Sequence,
    input_dict: Mapping[str, torch.Tensor],
    output_exprs: Mapping[str, Callable],
    request_cache: Optional[Dict] = None,
    extra_values: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Evaluate named output expressions (python closures over ``out``)
    against the model forwards and the derivative tape. ``extra_values``
    (the solver's learnable equation parameters) join ``out`` by name, as
    in the JAX package.

    ``request_cache``, a dict owned by the caller for one fixed set of
    models and expressions, keeps the discovered jet requests per input
    signature, so the replay runs once per signature, as the JAX package
    traces once per input shape."""
    for name, expr in output_exprs.items():
        if not callable(expr):
            raise TypeError(f"output expression '{name}' must be callable, got {type(expr)}")
    if request_cache is None:
        jet_requests = _collect_jet_requests(models, input_dict, output_exprs, extra_values)
    else:
        key = (deriv_path.flag("PSCI_JET", "1"),
               tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in input_dict.items()))
        if key not in request_cache:
            request_cache[key] = _collect_jet_requests(models, input_dict, output_exprs, extra_values)
        jet_requests = request_cache[key]
    with ad.tape_context() as tape:
        out = forward_with_derivatives(models, input_dict, tape)
        if jet_requests is not None:
            for stack, reqs in zip(tape._stacks, jet_requests):
                stack.precompute(reqs)
        out.update(extra_values or {})
        wrapped = ad.wrap_tape_outputs(tape, out)
        results = {name: ad.unwrap(expr(wrapped)) for name, expr in output_exprs.items()}
        # the area and sdf columns ride along for the losses that weight by them
        for aux in ("area", "sdf"):
            if aux in out and aux not in results:
                results[aux] = out[aux]
        return results
