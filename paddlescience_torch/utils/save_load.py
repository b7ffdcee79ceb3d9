"""Checkpoint save and load (counterpart of
``paddlescience_tpu/utils/save_load.py``), on ``torch.save``.

The directory layout is the JAX package's: one directory per tag
(``latest``, ``best_model``, ``epoch_<k>``) under
``<output_dir>/checkpoints/``, holding the training state (here one
``state.pt``) and, when given, ``metric.json``. The state is the dict
``Solver.state_dict()`` returns: model parameters and buffers, optimizer
state, aggregator state, the batch generator's state and the step.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_pretrain", "STATE_FILE"]

STATE_FILE = "state.pt"


def _ckpt_dir(output_dir: str, prefix: str) -> str:
    return os.path.abspath(os.path.join(output_dir, "checkpoints", prefix))


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(state: Dict[str, Any], output_dir: Optional[str], prefix: str = "latest",
                    metric: Optional[Dict[str, float]] = None, print_log: bool = True) -> None:
    """Save ``state`` (tensors copied to the host) and the metric dict under
    ``output_dir/checkpoints/prefix``; ``output_dir`` None skips the save."""
    if output_dir is None:
        print("output_dir is None, skip save_checkpoint", flush=True)
        return
    path = _ckpt_dir(output_dir, prefix)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    mpath = os.path.join(path, "metric.json")
    if metric:
        with open(mpath, "w") as f:
            json.dump({k: float(v) for k, v in metric.items()}, f)
    elif os.path.exists(mpath):
        os.remove(mpath)
    if print_log:
        print(f"Finish saving checkpoint to: {path}", flush=True)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The state saved under checkpoint directory ``path``, with its metric
    dict (empty when none was saved) under ``"_metric"``; tensors on the CPU."""
    path = os.path.abspath(path)
    file = os.path.join(path, STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    state = torch.load(file, map_location="cpu", weights_only=True)
    mpath = os.path.join(path, "metric.json")
    metric = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            metric = json.load(f)
    state["_metric"] = metric
    print(f"Finish loading checkpoint from: {path}", flush=True)
    return state


def load_pretrain(path: str, params_like: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Only the model parameters of the checkpoint at ``path``. With
    ``params_like`` (name -> tensor), the names and shapes must match, else
    ``ValueError``."""
    state = load_checkpoint(path)
    params = state.get("params", state)
    if params_like is not None:
        want = {k: tuple(v.shape) for k, v in params_like.items()}
        got = {k: tuple(v.shape) for k, v in params.items()}
        if want != got:
            raise ValueError(f"pretrained params at '{path}' do not match the model's parameters.\n"
                             f"  model:      {want}\n  checkpoint: {got}\n"
                             "Check the architecture config matches the one that was trained.")
    return params
