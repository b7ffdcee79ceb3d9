"""Carry parameters from the JAX package into the port.

``paddlescience_tpu`` modules expose their state as nested plain dicts
(``Module.param_tree()`` / ``buffer_tree()``). Given those trees as numpy
arrays, :func:`load_jax_params` copies them into a port module whose
parameters and buffers have the same dotted names (``linears.0.weight_v``,
``fourier_emb.kernel``, ``period_emb.freq_x``, ``last_fc.bias``, a
weight-normed ModifiedMLP's ``embed_u.weight_g``, a Stan or Swish
activation's ``acts.0.beta``, ``embed_act_u.beta`` or
``blocks.0.act1.beta`` (Swish's a scalar), a
DeepONet's ``branch_net.linears.0.weight``, ``trunk_net.last_fc.bias`` and
``b``, an FNO's ``fno_blocks.convs.0.w0_re``/``_im`` and
``fno_blocks.fno_skips.0.weight``, an LNO's ``laplace.residue_re``,
``conv_w``, ``conv_b`` and ``fc0.weight``, a ``ModelList``'s
``model_list.0.linears.0.weight_v`` from the JAX tree's
``params["model_list"]["0"]``, a SPINN's ``branch_nets.0.embed_u.weight``
from ``params["branch_nets"]["0"]``, a UNO's ``convs.1.w2_im`` and
``h_skips.0.weight``, an AFNO's ``blocks.0.filter.w1``,
``blocks.0.norm1.scale`` and ``pos_embed``, a CViT's
``encoder.blocks.0.attn.q.weight``, a CuboidTransformer's ``pos``,
``init_global``, ``initial_encoder.convs.0.weight``,
``enc_levels.0.0.attns.1.rel_bias``, ``enc_levels.0.0.g_lns.0.scale``,
``dec_cross.0.0.attns.0.kv.weight`` and ``g_proj.0.bias``, an
ExtFormer-MoE's stacked experts ``inner.enc_levels.0.0.ffns.0.w_in`` and
gate tables ``...ffns.0.gate.latent_table``, a Koopman embedding's
``k_ut`` with its ``mean`` and ``std`` buffers, ...). The layout is the JAX one on
both sides (W of shape (in, out), a complex weight as its real and
imaginary parts, a LayerNorm's ``scale`` and ``shift``), so nothing is
transposed, but for the kernels of ``nn.layers.Conv``: JAX keeps them as
(*window, in, out), torch as (out, in, *window), and a module names such
parameters in its ``jax_layout`` ({"weight": "conv"}). Buffers that a module rebuilds
from its arguments (the LNO's grids ``laplace.t_0``, ``laplace.lam_0``,
..., the cylinder embedding's band indices) need not be passed, and the
cuboid attention's masks and relative-position indices are no buffers at
all (built in numpy and kept per device by the module code). This module imports no JAX: callers hand it numpy
arrays. :func:`load_jax_eq_params` carries a JAX solver's learnable
equation parameters (``state["eq_params"]``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["flatten_tree", "load_jax_params", "load_jax_eq_params"]


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": x}} -> {"a.b": x}."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key + "."))
        else:
            flat[key] = v
    return flat


@torch.no_grad()
def load_jax_params(module: nn.Module, params: Mapping[str, Any],
                    buffers: Optional[Mapping[str, Any]] = None) -> None:
    """Copy a JAX param tree (and buffer tree) into ``module`` in place.

    Every parameter of ``module`` must be covered and every tree entry must
    name a parameter (or buffer) of matching shape; anything else raises
    ``KeyError``/``ValueError``.
    """
    targets = dict(module.named_parameters())
    flat = flatten_tree(params)
    missing = sorted(set(targets) - set(flat))
    unexpected = sorted(set(flat) - set(targets))
    if missing or unexpected:
        raise KeyError(f"param trees differ: missing {missing}, unexpected {unexpected}")
    named_buffers = dict(module.named_buffers())
    flat_buffers = flatten_tree(buffers or {})
    unexpected = sorted(set(flat_buffers) - set(named_buffers))
    if unexpected:
        raise KeyError(f"unexpected buffers {unexpected}")
    for name, value in list(flat.items()) + list(flat_buffers.items()):
        dst = targets.get(name)
        if dst is None:
            dst = named_buffers[name]
        value = np.array(value, dtype=np.float32)
        owner, _, leaf = name.rpartition(".")
        if getattr(module.get_submodule(owner), "jax_layout", {}).get(leaf) == "conv":
            value = np.moveaxis(value, (-1, -2), (0, 1)).copy()  # (*window, in, out) -> (out, in, *window)
        src = torch.from_numpy(value)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)


@torch.no_grad()
def load_jax_eq_params(targets: Mapping[str, torch.Tensor], eq_params: Mapping[str, Any]) -> None:
    """Copy a JAX solver's ``state["eq_params"]`` ({name: scalar}) into the
    port's learnable equation parameters in place (``Solver.eq_params``, or
    a PDE's ``learnable_parameters``). The names must be the same."""
    if set(targets) != set(eq_params):
        raise KeyError(f"equation parameters differ: {sorted(targets)} != {sorted(eq_params)}")
    for name, value in eq_params.items():
        targets[name].copy_(torch.tensor(np.asarray(value, dtype=np.float32)).reshape(targets[name].shape))
