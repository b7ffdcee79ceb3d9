"""Constraints (counterpart of
``paddlescience_tpu/constraint/constraints.py``). Ported:
``InteriorConstraint``, ``BoundaryConstraint``, ``InitialConstraint`` and
``IntegralConstraint`` over a geometry, and ``SupervisedConstraint`` in
its dict-config form.

Geometry sampling happens on the host when the constraint is built, with
the JAX package's ``np.random`` calls in its order; the sampled arrays
become the configured dataset: the JAX default ``NamedArrayDataset``,
batched by a ``BatchLoader`` (a new batch each step), or an
``IterableNamedArrayDataset`` (the solver moves it to the device once and
feeds it every step). ``criteria`` is a callable of the
coordinate columns or a string that evaluates to one here, as in the JAX
package (``"lambda t, x, y: np.isclose(x, -4.0)"``). Labels and weights
are numbers, callables of the input dict, or sympy expressions over the
geometry's coordinates: sympy is not installed where the port runs, so
such an expression is read from its ``str`` by ``utils/symbolic.py`` into
a numpy function of the coordinates (no sympy import); a form outside that
reader's grammar (``Derivative``, an unknown function) raises naming it.
``PeriodicConstraint`` pairs boundary points with their periodic images.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np

from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.data import _DATASETS
from paddlescience_torch.utils.symbolic import read_expression

__all__ = ["InteriorConstraint", "BoundaryConstraint", "InitialConstraint", "PeriodicConstraint",
           "IntegralConstraint", "SupervisedConstraint", "prepare_label", "prepare_weight"]

Spec = Union[float, int, Callable]


def _is_sympy(value) -> bool:
    """A sympy object, recognised without importing sympy."""
    return type(value).__module__.startswith("sympy")


def _sympy_array(value, input: Dict[str, np.ndarray], dim_keys, ref: np.ndarray, what: str) -> np.ndarray:
    """A sympy label or weight over the coordinates ``dim_keys``, read
    from ``str(value)`` and evaluated with numpy on the sampled columns,
    broadcast to ``ref``'s shape and dtype (the JAX package lambdifies it
    over the same keys)."""
    expr = read_expression(str(value), what)
    unknown = [n for n in expr.names if n not in dim_keys]
    if unknown:
        raise NotImplementedError(f"{what} = {value}: names {unknown} are not coordinates {tuple(dim_keys)}")
    out = expr({k: input[k] for k in expr.names}, "numpy")
    return np.broadcast_to(np.asarray(out, dtype=ref.dtype), ref.shape).copy()


def _criteria(criteria: Optional[Union[Callable, str]]) -> Optional[Callable]:
    """A string criteria is evaluated here, where ``np`` is numpy, as the
    JAX package evaluates it."""
    return eval(criteria) if isinstance(criteria, str) else criteria  # noqa: S307 (configuration strings)


def prepare_label(label_dict: Dict[str, Spec], input: Dict[str, np.ndarray],
                  dim_keys=()) -> Dict[str, np.ndarray]:
    """Label arrays aligned with the sampled inputs: a number fills the
    shape of the inputs, a callable of the input dict gives the array, a
    sympy expression is evaluated over the geometry's coordinates
    ``dim_keys`` (read without sympy)."""
    ref = next(iter(input.values()))
    label = {}
    for key, value in label_dict.items():
        if isinstance(value, (int, float)):
            label[key] = np.full_like(ref, value)
        elif _is_sympy(value):
            label[key] = _sympy_array(value, input, dim_keys, ref, f"label {key!r}")
        elif callable(value):
            label[key] = value(input)
            if isinstance(label[key], (int, float)):
                label[key] = np.full_like(ref, label[key])
        else:
            raise NotImplementedError(f"type of {type(value)} is invalid yet.")
    return label


def prepare_weight(weight_dict: Optional[Dict[str, Union[Spec, str]]], input, label,
                   dim_keys=()) -> Optional[Dict[str, np.ndarray]]:
    """Weight arrays: ones for every label key, then a number, a callable
    of the input dict, or "sdf" (the sampled sdf column) per given key;
    ``dim_keys`` as for :func:`prepare_label`."""
    if weight_dict is None:
        return None
    ref = next(iter(label.values()))
    weight = {key: np.ones_like(ref) for key in label}
    for key, value in weight_dict.items():
        if isinstance(value, str):
            if value != "sdf":
                raise NotImplementedError(f"string '{value}' is invalid yet.")
            weight[key] = input["sdf"]
        elif isinstance(value, (int, float)):
            weight[key] = np.full_like(ref, float(value))
        elif _is_sympy(value):
            weight[key] = _sympy_array(value, input, dim_keys, ref, f"weight {key!r}")
        elif callable(value):
            weight[key] = value(input)
            if isinstance(weight[key], (int, float)):
                weight[key] = np.full_like(ref, weight[key])
        else:
            raise NotImplementedError(f"type of {type(value)} is invalid yet.")
    return weight


def _build_geom_dataset(input, label, weight, dataloader_cfg):
    ds_cfg = dataloader_cfg.get("dataset", "NamedArrayDataset")
    name = ds_cfg if isinstance(ds_cfg, str) else ds_cfg["name"]
    if name not in _DATASETS:
        raise NotImplementedError(f"dataset '{name}' is not ported; available: {sorted(_DATASETS)}")
    return _DATASETS[name](input, label, weight)


def _n_samples(dataloader_cfg) -> int:
    return dataloader_cfg["batch_size"] * dataloader_cfg.get("iters_per_epoch", 1)


def _select_outputs(cst, output_expr, label_dict):
    cst.label_dict = label_dict
    cst.output_keys = tuple(label_dict.keys())
    cst.output_expr = {k: v for k, v in output_expr.items() if k in cst.output_keys}


def _finish(cst, geom, input, label_dict, weight_dict, dataloader_cfg, loss, name) -> None:
    """Labels and weights of the sampled ``input``, its dataset, and the
    base constructor."""
    label = prepare_label(label_dict, input, geom.dim_keys)
    weight = prepare_weight(weight_dict, input, label, geom.dim_keys)
    Constraint.__init__(cst, _build_geom_dataset(input, label, weight, dataloader_cfg), dataloader_cfg, loss, name)


class InteriorConstraint(Constraint):
    """PDE residuals over interior points of ``geom`` (with the "sdf"
    column)."""

    def __init__(self, output_expr: Dict[str, Callable], label_dict: Dict[str, Spec], geom,
                 dataloader_cfg: Dict[str, Any], loss, random: str = "pseudo",
                 criteria: Optional[Union[Callable, str]] = None, evenly: bool = False,
                 weight_dict: Optional[Dict[str, Union[Spec, str]]] = None,
                 compute_sdf_derivatives: bool = False, name: str = "EQ"):
        _select_outputs(self, output_expr, label_dict)
        self.input_keys = geom.dim_keys
        input = geom.sample_interior(_n_samples(dataloader_cfg), random, _criteria(criteria), evenly,
                                     compute_sdf_derivatives)
        _finish(self, geom, input, label_dict, weight_dict, dataloader_cfg, loss, name)


class BoundaryConstraint(Constraint):
    """Dirichlet/Neumann/Robin terms over boundary points of ``geom``
    (normals as normal_x/normal_y/..., and "area" on a mesh)."""

    def __init__(self, output_expr: Dict[str, Callable], label_dict: Dict[str, Spec], geom,
                 dataloader_cfg: Dict[str, Any], loss, random: str = "pseudo",
                 criteria: Optional[Union[Callable, str]] = None, evenly: bool = False,
                 weight_dict: Optional[Dict[str, Union[Spec, str]]] = None, name: str = "BC"):
        _select_outputs(self, output_expr, label_dict)
        self.input_keys = geom.dim_keys
        input = geom.sample_boundary(_n_samples(dataloader_cfg), random, _criteria(criteria), evenly)
        _finish(self, geom, input, label_dict, weight_dict, dataloader_cfg, loss, name)


class InitialConstraint(Constraint):
    """Initial conditions over interior points at t = t0 of a
    ``TimeXGeometry`` (its ``sample_initial_interior``)."""

    def __init__(self, output_expr: Dict[str, Callable], label_dict: Dict[str, Spec], geom,
                 dataloader_cfg: Dict[str, Any], loss, random: str = "pseudo",
                 criteria: Optional[Union[Callable, str]] = None, evenly: bool = False,
                 weight_dict: Optional[Dict[str, Union[Spec, str]]] = None,
                 compute_sdf_derivatives: bool = False, name: str = "IC"):
        _select_outputs(self, output_expr, label_dict)
        self.input_keys = geom.dim_keys
        input = geom.sample_initial_interior(_n_samples(dataloader_cfg), random, _criteria(criteria), evenly,
                                             compute_sdf_derivatives)
        _finish(self, geom, input, label_dict, weight_dict, dataloader_cfg, loss, name)


class PeriodicConstraint(Constraint):
    """Ties u(x) to u at x's periodic image along ``periodic_key``: the
    batch is the sampled boundary points followed by their images
    (``geom.periodic_point``), every label 0, and the loss a periodic one
    comparing the two halves (as the JAX class: half the batch size of
    points, the images appended)."""

    def __init__(self, output_expr: Dict[str, Callable], label_dict: Dict[str, Spec], geom, periodic_key: str,
                 dataloader_cfg: Dict[str, Any], loss, random: str = "pseudo",
                 criteria: Optional[Union[Callable, str]] = None, evenly: bool = False,
                 weight_dict: Optional[Dict[str, Union[Spec, str]]] = None, name: str = "PeriodicBC"):
        self.label_dict = label_dict
        self.input_keys = geom.dim_keys
        self.output_keys = tuple(output_expr.keys())
        self.output_expr = output_expr
        n_half = (dataloader_cfg["batch_size"] // 2) * dataloader_cfg.get("iters_per_epoch", 1)
        component = geom.dim_keys.index(periodic_key) - int("t" in geom.dim_keys)
        input = geom.sample_boundary(n_half, random, _criteria(criteria), evenly)
        coords = {k: input[k] for k in geom.dim_keys}
        mirrored = geom.periodic_point(coords, component)
        full = {k: np.concatenate([coords[k], mirrored[k]], axis=0) for k in geom.dim_keys}
        _finish(self, geom, full, {k: 0.0 for k in output_expr}, weight_dict, dataloader_cfg, loss, name)


class IntegralConstraint(Constraint):
    """Monte-Carlo integral constraints: each sample is a set of
    ``integral_batch_size`` boundary points whose integral must match a
    scalar label. Inputs are (sets, points, 1), with "area" = the
    geometry's area / points; labels and weights (sets, 1)."""

    def __init__(self, output_expr: Dict[str, Callable], label_dict: Dict[str, Spec], geom,
                 dataloader_cfg: Dict[str, Any], loss, random: str = "pseudo",
                 criteria: Optional[Union[Callable, str]] = None,
                 weight_dict: Optional[Dict[str, Union[Spec, str]]] = None,
                 integral_batch_size: int = 1024, name: str = "IgC"):
        _select_outputs(self, output_expr, label_dict)
        self.input_keys = geom.dim_keys
        criteria = _criteria(criteria)
        n_sets = _n_samples(dataloader_cfg)
        samples = [geom.sample_boundary(integral_batch_size, random, criteria) for _ in range(n_sets)]
        input = {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}  # (n_sets, m, 1)
        area = getattr(geom, "perimeter", None) or getattr(geom, "area", 1.0)
        input["area"] = np.full((n_sets, integral_batch_size, 1), area / integral_batch_size, dtype=np.float32)
        ref = np.zeros((n_sets, 1), np.float32)
        label = {}
        for key, value in label_dict.items():
            if isinstance(value, (int, float)):
                label[key] = np.full_like(ref, value)
            elif callable(value):
                label[key] = np.asarray(value(input), np.float32).reshape(n_sets, 1)
            else:
                raise NotImplementedError(f"integral label of type {type(value)} unsupported")
        weight = prepare_weight(weight_dict, input, label, geom.dim_keys)
        super().__init__(_build_geom_dataset(input, label, weight, dataloader_cfg), dataloader_cfg, loss, name)


class SupervisedConstraint(Constraint):
    """Data-driven constraint over a configured dataset:
    ``{"dataset": {"name": ..., "input": {...}, "label": {...}}}``."""

    def __init__(self, dataloader_cfg: Dict[str, Any], loss,
                 output_expr: Optional[Dict[str, Callable]] = None, name: str = "Sup"):
        ds_cfg = dict(dataloader_cfg["dataset"])
        ds_name = ds_cfg.pop("name")
        if ds_name not in _DATASETS:
            raise NotImplementedError(f"dataset '{ds_name}' is not ported; available: {sorted(_DATASETS)}")
        dataset = _DATASETS[ds_name](**ds_cfg)
        if hasattr(dataset, "input"):  # a generator dataset has no input arrays to name its keys
            self.input_keys = tuple(dataset.input.keys())
        self.output_keys = tuple(output_expr.keys()) if output_expr is not None else tuple(dataset.label.keys())
        if output_expr is None:
            output_expr = {key: (lambda out, k=key: out[k]) for key in self.output_keys}
        self.output_expr = output_expr
        super().__init__(dataset, dataloader_cfg, loss, name)
