"""Validators, the eval-side mirror of constraints (counterpart of
``paddlescience_tpu/validate/__init__.py``): a dataset, a loader over it,
output expressions, a loss and a dict of metrics. ``Solver.eval`` runs
them batch by batch."""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Union

from paddlescience_torch import data as data_mod
from paddlescience_torch.constraint.constraints import prepare_label

__all__ = ["Validator", "GeometryValidator", "SupervisedValidator", "build_validator"]


class Validator:
    """Dataset + loader (``dataloader_cfg``) + loss + metric dict."""

    def __init__(self, dataset, dataloader_cfg, loss, metric, name: str):
        self.dataset = dataset
        self.data_loader = data_mod.build_dataloader(dataset, dataloader_cfg)
        self.loss = loss
        self.metric = metric or {}
        self.name = name

    def __str__(self):
        return ", ".join([self.__class__.__name__, f"name = {self.name}",
                          f"len(dataloader) = {len(self.data_loader)}", f"metric = {list(self.metric.keys())}"])


class GeometryValidator(Validator):
    """Expressions against labels on ``dataloader_cfg["total_size"]``
    points sampled in ``geom`` when built (``np.random``, in the JAX
    package's order), read in batches of ``batch_size``. Labels are numbers
    or callables of the input dict (``constraint/constraints.py::prepare_label``)."""

    def __init__(self, output_expr: Dict[str, Callable], label_dict: Dict[str, Union[float, Callable]], geom,
                 dataloader_cfg: Dict[str, Any], loss, random: str = "pseudo", criteria: Optional[Callable] = None,
                 evenly: bool = False, metric: Optional[Dict[str, Any]] = None, with_initial: bool = False,
                 name: Optional[str] = None):
        self.output_expr = output_expr
        self.label_dict = label_dict
        self.input_keys = geom.dim_keys
        self.output_keys = tuple(label_dict.keys())
        nx = dataloader_cfg["total_size"]
        batch_size = dataloader_cfg.get("batch_size", nx)
        if with_initial and hasattr(geom, "sample_initial_interior"):
            input = geom.sample_initial_interior(nx, random, criteria, evenly)
        else:
            input = geom.sample_interior(nx, random, criteria, evenly)
        label = prepare_label(label_dict, input, geom.dim_keys)
        ds_cfg = dataloader_cfg.get("dataset", {"name": "NamedArrayDataset"})
        ds_cfg = dict({"name": ds_cfg} if isinstance(ds_cfg, str) else ds_cfg)
        ds_cfg.update({"input": input, "label": label})
        super().__init__(data_mod.build_dataset(ds_cfg), {"batch_size": batch_size}, loss, metric,
                         name or "GeoValidator")


class SupervisedValidator(Validator):
    """Expressions against a supervised dataset (``dataloader_cfg["dataset"]``)."""

    def __init__(self, dataloader_cfg: Dict[str, Any], loss, output_expr: Optional[Dict[str, Callable]] = None,
                 metric: Optional[Dict[str, Any]] = None, name: Optional[str] = None):
        dataloader_cfg = dict(dataloader_cfg)
        dataset = data_mod.build_dataset(dataloader_cfg["dataset"])
        self.input_keys = tuple(dataset.input.keys())
        self.output_keys = (tuple(output_expr.keys()) if output_expr is not None
                            else tuple(getattr(dataset, "label", {}).keys()))
        if output_expr is None:
            output_expr = {key: (lambda out, k=key: out[k]) for key in self.output_keys}
        self.output_expr = output_expr
        super().__init__(dataset, dataloader_cfg, loss, metric, name or "SupValidator")


def build_validator(cfg, equation_dict=None, geom_dict=None):
    """Validators from a config: a shared ``dataloader`` block and a
    ``content`` list of ``{ClassName: kwargs}``; a string ``geom`` names an
    entry of ``geom_dict``, a string ``output_expr`` entry an equation of
    ``equation_dict``, and ``loss``/``metric`` sub-configs go through
    ``build_loss``/``build_metric``."""
    from paddlescience_torch.loss import build_loss
    from paddlescience_torch.metric import build_metric

    if cfg is None:
        return None
    cfg = copy.deepcopy(dict(cfg))
    global_dl = dict(cfg.get("dataloader", {}))
    out = {}
    for item in cfg["content"]:
        cls_name = next(iter(item.keys()))
        c = dict(item[cls_name])
        name = c.get("name", cls_name)
        if isinstance(c.get("geom"), str):
            c["geom"] = geom_dict[c.pop("geom")]
        if "output_expr" in c and equation_dict:
            for k, expr in list(c["output_expr"].items()):
                if isinstance(expr, str) and expr in equation_dict:
                    c["output_expr"][k] = equation_dict[expr].equations[k]
        dl = dict(c.pop("dataloader", {}))
        dl.update(global_dl)
        c["dataloader_cfg"] = dl
        if "loss" in c and not callable(c["loss"]):
            c["loss"] = build_loss(c["loss"])
        if c.get("metric") and not callable(next(iter(c["metric"].values()), None)):
            c["metric"] = {k: build_metric(v) if isinstance(v, dict) else v for k, v in c["metric"].items()}
        out[name] = globals()[cls_name](**c)
    return out
