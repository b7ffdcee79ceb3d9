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

Input and output transforms (``arch/base.py``) take the JAX package's
three branches here: the input-transform key remap, the derivative-taking
or renaming output transform on the tape, and the pass-through of a
non-coordinate model's renamed outputs (:func:`forward_with_derivatives`).
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


def _pointwise_fn(model, diff_keys: Tuple[str, ...], out_keys: Tuple[str, ...], forward=None):
    """The model's plain batched forward (``forward``, the model's call
    when None) as a function of the (N, d) coordinates (columns in
    ``diff_keys`` order) and the per-point extras: what the nested-jvp path
    differentiates."""
    forward = model if forward is None else forward

    def fn(x: torch.Tensor, extras: Mapping[str, torch.Tensor]) -> torch.Tensor:
        feed = {k: x[..., i : i + 1] for i, k in enumerate(diff_keys)}
        feed.update(extras)
        o = forward(feed)
        return torch.cat([o[k] for k in out_keys], dim=-1)

    return fn


def _raw_forward(model, feed):
    """The model's forward with its output transform switched off."""
    saved = model._output_transform
    model._output_transform = None
    try:
        return model(feed)
    finally:
        model._output_transform = saved


def _column_index(batched_out, keys) -> Tuple[Dict[str, int], int]:
    index, ofs = {}, 0
    for k in keys:
        index[k] = ofs
        ofs += int(batched_out[k].shape[-1])
    return index, ofs


def _forward_transform_on_tape(model, input_dict, tape: ad.Tape) -> Dict[str, torch.Tensor]:
    """Forward of a model whose output transform differentiates (a stream
    function: u = psi_y, v = -psi_x) or renames outputs: the raw net runs as
    a derivative stack, the transform gets TapeArray views of its inputs
    and outputs, so ``jacobian``/``hessian`` work inside it, and the
    transformed outputs of that stack become a derived stack, which the
    equations can differentiate further. Other outputs pass through."""
    in_keys = tuple(model.input_keys)
    diff_keys = tuple(k for k in in_keys if input_dict[k].ndim == 2 and input_dict[k].shape[-1] == 1)
    if not diff_keys:
        raise ValueError(f"model {type(model).__name__} has a derivative-using output transform but no (N, 1) "
                         "coordinate inputs to differentiate along")
    feed = {k: input_dict[k] for k in in_keys}
    raw_out = _raw_forward(model, feed)
    x = torch.cat([input_dict[k] for k in diff_keys], dim=-1)
    extras = {k: input_dict[k] for k in in_keys if k not in diff_keys}
    key_index = {k: i for i, k in enumerate(diff_keys)}
    raw_keys = tuple(raw_out)
    out_index, width = _column_index(raw_out, raw_keys)
    raw_fn = _pointwise_fn(model, diff_keys, raw_keys, forward=lambda f: _raw_forward(model, f))
    stack = tape.add_stack(raw_fn, x, key_index, out_index, extras=extras, out_width=width)

    wrapped_out: Dict[str, object] = {}
    for k in raw_keys:
        tape.register_output(raw_out[k], stack, out_index[k])
        c, w = out_index[k], int(raw_out[k].shape[-1])
        wrapped_out[k] = ad.TapeArray(raw_out[k], lambda xv, ex, _c=c, _w=w: raw_fn(xv, ex)[..., _c : _c + _w], stack)
    wrapped_in = {k: (ad.TapeArray(input_dict[k], lambda xv, ex, _i=key_index[k]: xv[..., _i : _i + 1], stack)
                      if k in key_index else input_dict[k]) for k in in_keys}
    transformed = model._output_transform(wrapped_in, wrapped_out)

    result: Dict[str, torch.Tensor] = {}
    tracked = [(k, v) for k, v in transformed.items() if isinstance(v, ad.TapeArray) and v.stack is stack]
    if tracked:
        t_index, ofs = _column_index({k: v.value for k, v in tracked}, [k for k, _ in tracked])
        pfs = tuple(v.pf for _, v in tracked)
        t_fn = lambda xv, ex: torch.cat([pf(xv, ex) for pf in pfs], dim=-1)
        tstack = tape.add_stack(t_fn, x, key_index, t_index, extras=extras, out_width=ofs)
        for k, v in tracked:
            tape.register_output(v.value, tstack, t_index[k])
            result[k] = v.value
    for k, v in transformed.items():
        if k not in result:
            result[k] = ad.unwrap(v)
    return result


def _grid_forward(model, feed, grid_keys, batched_out, tape: ad.Tape) -> Dict[str, torch.Tensor]:
    """A separable model on a product grid (SPINN: per-axis coordinate
    columns, grid-shaped outputs), as the JAX package: its outputs on a grid
    stack, whose derivatives are one jvp per axis."""
    out_keys = tuple(model.output_keys)
    out_index, _ = _column_index(batched_out, out_keys)

    def grid_fn(*coords):
        o = model(dict(zip(grid_keys, coords)))
        return torch.cat([o[k] for k in out_keys], dim=-1)

    stack = tape.add_grid_stack(grid_fn, {k: feed[k] for k in grid_keys}, {k: i for i, k in enumerate(grid_keys)},
                                out_index)
    for k in out_keys:
        tape.register_output(batched_out[k], stack, out_index[k])
    return {k: batched_out[k] for k in out_keys}


def _transform_needs_tape(model, feed) -> Tuple[bool, Optional[Dict[str, torch.Tensor]]]:
    """Whether ``model``'s output transform calls ``jacobian``/``hessian``
    (then its plain call raises for want of tape records), and the plain
    call's outputs when it does not. The answer is kept per registered
    transform, so a step does not run the failing call again."""
    if getattr(model, "_psci_tape_transform", None) is model._output_transform:
        return True, None
    try:
        return False, model(feed)
    except (ValueError, RuntimeError) as e:
        if "tape" not in str(e).lower():
            raise
        model._psci_tape_transform = model._output_transform
        return True, None


def forward_with_derivatives(models: Sequence, input_dict: Mapping[str, torch.Tensor],
                             tape: ad.Tape) -> Dict[str, torch.Tensor]:
    """Run each model on the constraint inputs and register everything on
    the tape so ``jacobian`` works on the results. Returns the input
    coordinates plus all model outputs.

    A separable model on a product grid (per-axis columns of different
    lengths, or outputs of more than two dimensions: SPINN) gets a grid
    stack (:func:`_grid_forward`).

    A model's (N, 1) input columns are the coordinates it is differentiated
    along; its other inputs ride along as per-point extras. A model with
    such columns gets a derivative stack (with its jet forward where the
    derivative path has one and there are no extras). A model with none,
    e.g. on the (sets, points, 1) inputs of an integral constraint, runs its
    batched forward only and its outputs take no derivatives, as in the JAX
    package.

    Transforms, as in the JAX package: a model whose input keys are not all
    among the constraint's inputs but which has an input transform gets
    every constraint input (but ``area`` and ``sdf``) and is differentiated
    along them (deephpms: the transform maps (t, x) onto u and its
    x-derivatives). A model whose output transform differentiates, or which
    renames the outputs of a coordinate model, runs through
    :func:`_forward_transform_on_tape`; a non-coordinate model's renamed
    outputs pass through untracked. Any other transform sits inside the
    model's call, which the nested jvp differentiates.
    """
    out: Dict[str, torch.Tensor] = {}
    for k, v in input_dict.items():
        tape.register_coord(k, v)
        out[k] = v

    for model in models:
        in_keys = tuple(model.input_keys)
        missing = [k for k in in_keys if k not in input_dict]
        if missing:
            if getattr(model, "_input_transform", None) is None:
                raise KeyError(f"model inputs {missing} not found in constraint inputs {list(input_dict)}")
            in_keys = tuple(k for k in input_dict if k not in ("area", "sdf"))
        feed = {k: input_dict[k] for k in in_keys}
        diff_keys = tuple(k for k in in_keys if feed[k].ndim == 2 and feed[k].shape[-1] == 1)
        batched_out = None
        if getattr(model, "_output_transform", None) is not None:
            on_tape, batched_out = _transform_needs_tape(model, feed)
            if on_tape or (diff_keys and set(batched_out) != set(model.output_keys)):
                out.update(_forward_transform_on_tape(model, input_dict, tape))
                continue
            if set(batched_out) != set(model.output_keys):
                out.update(batched_out)  # a non-coordinate model's renamed outputs
                continue
        if batched_out is None:
            batched_out = model(feed)
        if not diff_keys:
            out.update(batched_out)
            continue
        if any(v.ndim > 2 for v in batched_out.values()) or len({feed[k].shape[0] for k in diff_keys}) > 1:
            out.update(_grid_forward(model, feed, diff_keys, batched_out, tape))
            continue
        extras = {k: feed[k] for k in in_keys if k not in diff_keys}
        x = torch.cat([input_dict[k] for k in diff_keys], dim=-1)
        key_index = {k: i for i, k in enumerate(diff_keys)}
        out_keys = tuple(model.output_keys)
        out_index, width = _column_index(batched_out, out_keys)
        jet_fn = None
        if deriv_path.flag("PSCI_JET", "1") == "1" and not extras and model.supports_jet():
            jet_fn = _jet_fn(model)
        stack = tape.add_stack(_pointwise_fn(model, diff_keys, out_keys), x, key_index, out_index,
                               extras=extras, jet_fn=jet_fn, out_width=width)
        for k in out_keys:
            tape.register_output(batched_out[k], stack, out_index[k])
            out[k] = batched_out[k]
    return out


def _collect_jet_requests(models, input_dict, output_exprs, extra_values=None):
    """Which derivative components will the expressions ask for? One
    ordered request set per stack, from a replay on the batch's first row.
    None when no model has a jet forward, or when the replay fails, as in
    the JAX package: an expression over the whole batch (an integral
    equation's matrix product) does not take one row. Each stack's jet
    then serves its requests one by one; a fault of the expressions
    themselves shows in the evaluation that follows."""
    if not any(m.supports_jet() for m in models):
        return None
    first_row = {k: v[:1] for k, v in input_dict.items()}
    try:
        with torch.no_grad(), ad.tape_context() as tape:
            tape.collecting = True
            out = forward_with_derivatives(models, first_row, tape)
            out.update(extra_values or {})
            wrapped = ad.wrap_tape_outputs(tape, out)
            for expr in output_exprs.values():
                expr(wrapped)
            return [tuple(s.requested) for s in tape._stacks]
    except Exception:  # noqa: BLE001 - the evaluation re-raises a real fault
        return None


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
