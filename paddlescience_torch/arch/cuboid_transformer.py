"""CuboidTransformer (Earthformer) and ExtFormerMoECuboid (counterpart of
``paddlescience_tpu/arch/cuboid_transformer.py``).

A non-autoregressive space-time encoder-decoder over (B, T, H, W, C)
volumes: an initial conv encoder and a learned position parameter, a
hierarchical encoder (cuboid self-attention blocks, a 2 x 2 patch merge
between levels, channels doubling), and a decoder from the coarsest level
down (self-attention blocks and cross-attention into the encoder's memory
of that level, a nearest upsample and conv between levels), seeded from
the coarsest memory (``z_init_method``), then a final conv decoder.

Attention is split into cuboids: a named pattern ("axial", "divided_st",
"video_swin_PxM", "spatial_lg_M", "axial_space_dilate_K"; cross:
"cross_KxK[_lg|_heter]"), explicit per-layer lists, or the legacy single
``cuboid_size`` give each block's layers, each with a cuboid, a local or
dilated ("l"/"d") strategy per axis and a shift. A layer pads the volume,
rolls it by the shift, regroups it into cuboids (:func:`cuboid_reorder`,
one reshape and one permute) and runs masked multi-head attention in each
(:func:`_masked_mha`, plain ``torch.einsum`` and ``softmax`` as the JAX
package's plain ``jnp``). The masks (padded tokens with
``padding_type="ignore"``, Swin shift regions) and the relative-position
indices are built in numpy, as in the JAX package, and copied to each
device at their first use and kept there, so a step captured in a CUDA
graph makes no host copy. A fully masked query row gives zeros: the
softmax is multiplied by the mask after a -1e9 fill (which
``scaled_dot_product_attention`` with a boolean mask would not give).
Global vectors ride every encoder self-attention layer: their keys and
values are concatenated onto each cuboid's before the softmax, and they
update by attending over all tokens (``separate_global_qkv``,
``global_dim_ratio``, ``use_global_self_attn``, a per-layer global FFN).
GELU is the tanh form (``jax.nn.gelu``'s default); the conv stacks use
leaky ReLU with slope 0.1.

Training randomness (dropout after the attention softmax, after the
output projections and inside the FFNs, and the MoE gates' noise) draws
from the ``torch.Generator`` installed with :meth:`set_train_rng` (the
``Solver`` installs its own before each train step and removes it for
eval and predict); with none installed the forward is deterministic.
``remat=True`` checkpoints every block (``torch.utils.checkpoint``,
non-reentrant); the recompute replays the generator's draws by restoring
its state, which a step captured in a CUDA graph cannot do, so a remat
model with active dropout or MoE noise trains eagerly.

With ``moe_config`` (or ``num_experts`` > 0) every FFN is a
``MixtureFFN`` (and with ``use_attn_moe`` every qkv projection a
``MixtureLinear``), and the output dict gains ``aux_loss`` (1, 1), the sum
of the gates' load-balancing losses. ``ExtFormerMoECuboid`` is that model
with the reference MoE defaults. Not implemented, as in the JAX package:
the "nearest" padding type.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.extformer_moe import MixtureFFN, MixtureLinear, default_moe_config
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, LayerNorm, Linear
from paddlescience_torch.nn.resize import resize

__all__ = ["CuboidTransformer", "ExtFormerMoECuboid", "CuboidSelfAttention", "CuboidCrossAttention",
           "CuboidSelfAttentionPatterns", "CuboidCrossAttentionPatterns", "cuboid_reorder",
           "cuboid_reorder_reverse"]

Gen = Optional[torch.Generator]


# ------------------------------------------------------------ patterns --


class _SelfPatterns:
    """Named self-attention decompositions: ``get(name)(input_shape)`` ->
    (cuboid sizes, strategies, shifts), one entry per attention layer."""

    def __init__(self):
        self.patterns = {"full": self.full_attention, "axial": self.axial, "divided_st": self.divided_space_time}
        for p in [1, 2, 4, 8, 10]:
            for m in [1, 2, 4, 8, 16, 32]:
                self.patterns[f"video_swin_{p}x{m}"] = functools.partial(self.video_swin, P=p, M=m)
        for m in [1, 2, 4, 8, 16, 32]:
            self.patterns[f"spatial_lg_{m}"] = functools.partial(self.spatial_lg_v1, M=m)
        for k in [2, 4, 8]:
            self.patterns[f"axial_space_dilate_{k}"] = functools.partial(self.axial_space_dilate_K, K=k)

    def get(self, name):
        return self.patterns[name]

    def full_attention(self, input_shape):
        T, H, W = input_shape[:3]
        return [(T, H, W)], [("l", "l", "l")], [(0, 0, 0)]

    def axial(self, input_shape):
        T, H, W = input_shape[:3]
        return [(T, 1, 1), (1, H, 1), (1, 1, W)], [("l", "l", "l")] * 3, [(0, 0, 0)] * 3

    def divided_space_time(self, input_shape):
        T, H, W = input_shape[:3]
        return [(T, 1, 1), (1, H, W)], [("l", "l", "l")] * 2, [(0, 0, 0)] * 2

    def video_swin(self, input_shape, P=2, M=4):
        T, H, W = input_shape[:3]
        P, M = min(P, T), min(M, H, W)
        return [(P, M, M), (P, M, M)], [("l", "l", "l")] * 2, [(0, 0, 0), (P // 2, M // 2, M // 2)]

    def spatial_lg_v1(self, input_shape, M=4):
        T, H, W = input_shape[:3]
        if H <= M and W <= M:
            return [(T, 1, 1), (1, H, W)], [("l", "l", "l")] * 2, [(0, 0, 0)] * 2
        return ([(T, 1, 1), (1, M, M), (1, M, M)], [("l", "l", "l"), ("l", "l", "l"), ("d", "d", "d")],
                [(0, 0, 0)] * 3)

    def axial_space_dilate_K(self, input_shape, K=2):
        T, H, W = input_shape[:3]
        K = min(K, H, W)
        cuboid_size = [(T, 1, 1), (1, H // K, 1), (1, H // K, 1), (1, 1, W // K), (1, 1, W // K)]
        strategy = [("l", "l", "l"), ("d", "d", "d"), ("l", "l", "l"), ("d", "d", "d"), ("l", "l", "l")]
        return cuboid_size, strategy, [(0, 0, 0)] * 5


class _CrossPatterns:
    """Named cross-attention decompositions: ``get(name)(mem_shape)`` ->
    (cuboid (h, w), shift (h, w), strategy, n_temporal) lists."""

    def __init__(self):
        self.patterns = {}
        for k in [1, 2, 4, 8]:
            self.patterns[f"cross_{k}x{k}"] = functools.partial(self.cross_KxK, K=k)
            self.patterns[f"cross_{k}x{k}_lg"] = functools.partial(self.cross_KxK_lg, K=k)
            self.patterns[f"cross_{k}x{k}_heter"] = functools.partial(self.cross_KxK_heter, K=k)

    def get(self, name):
        return self.patterns[name]

    def cross_KxK(self, mem_shape, K):
        K = min(K, mem_shape[1], mem_shape[2])
        return [(K, K)], [(0, 0)], [("l", "l", "l")], [1]

    def cross_KxK_lg(self, mem_shape, K):
        K = min(K, mem_shape[1], mem_shape[2])
        return [(K, K)] * 2, [(0, 0)] * 2, [("l", "l", "l"), ("d", "d", "d")], [1, 1]

    def cross_KxK_heter(self, mem_shape, K):
        K = min(K, mem_shape[1], mem_shape[2])
        return ([(K, K)] * 3, [(0, 0), (0, 0), (K // 2, K // 2)], [("l", "l", "l"), ("d", "d", "d"), ("l", "l", "l")],
                [1, 1, 1])


CuboidSelfAttentionPatterns = _SelfPatterns()
CuboidCrossAttentionPatterns = _CrossPatterns()


# ------------------------------------------------- cuboid decomposition --


def _clamp_cuboid(data_shape, cuboid_size, shift_size, strategy):
    """Clamp the cuboid to the data shape; no shift on a clamped or dilated
    axis."""
    cub, shf = list(cuboid_size), list(shift_size)
    for i in range(3):
        if strategy[i] == "d":
            shf[i] = 0
        if data_shape[i] <= cuboid_size[i]:
            cub[i] = data_shape[i]
            shf[i] = 0
    return tuple(cub), tuple(shf)


def _reorder_plan(shape, cuboid_size, strategy):
    """(intermediate shape, permutation) of :func:`cuboid_reorder`."""
    T, H, W = shape
    inter, nblock_axis, block_axis = [], [], []
    for i, (b, total, s) in enumerate(zip(cuboid_size, (T, H, W), strategy)):
        if s == "l":
            inter.extend([total // b, b])
            nblock_axis.append(2 * i + 1)
            block_axis.append(2 * i + 2)
        elif s == "d":
            inter.extend([b, total // b])
            nblock_axis.append(2 * i + 2)
            block_axis.append(2 * i + 1)
        else:
            raise NotImplementedError(f"strategy {s!r} is invalid")
    return inter, (0, *nblock_axis, *block_axis, 7)


def cuboid_reorder(x: torch.Tensor, cuboid_size, strategy) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, num_cuboids, bT * bH * bW, C): "l" groups
    contiguous blocks of an axis, "d" strided ones."""
    B, T, H, W, C = x.shape
    inter, perm = _reorder_plan((T, H, W), cuboid_size, strategy)
    nc = (T // cuboid_size[0]) * (H // cuboid_size[1]) * (W // cuboid_size[2])
    return x.reshape(B, *inter, C).permute(perm).reshape(B, nc, math.prod(cuboid_size), C)


def cuboid_reorder_reverse(x: torch.Tensor, cuboid_size, strategy, orig_shape) -> torch.Tensor:
    """Inverse of :func:`cuboid_reorder`."""
    B, C = x.shape[0], x.shape[-1]
    T, H, W = orig_shape
    perm = [0]
    for i, s in enumerate(strategy):
        if s == "l":
            perm.extend([i + 1, i + 4])
        elif s == "d":
            perm.extend([i + 4, i + 1])
        else:
            raise NotImplementedError(f"strategy {s!r} is invalid")
    perm.append(7)
    x = x.reshape(B, T // cuboid_size[0], H // cuboid_size[1], W // cuboid_size[2], *cuboid_size, C)
    return x.permute(perm).reshape(B, T, H, W, C)


def _np_cuboid_reorder(data: np.ndarray, cuboid_size, strategy) -> np.ndarray:
    """numpy twin of :func:`cuboid_reorder`, for the masks."""
    B, T, H, W, C = data.shape
    inter, perm = _reorder_plan((T, H, W), cuboid_size, strategy)
    nc = (T // cuboid_size[0]) * (H // cuboid_size[1]) * (W // cuboid_size[2])
    return data.reshape((B, *inter, C)).transpose(perm).reshape(B, nc, int(np.prod(cuboid_size)), C)


@functools.lru_cache(maxsize=256)
def _self_attn_mask(data_shape, cuboid_size, shift_size, strategy, padding_type):
    """(num_cuboids, vol, vol) bool mask: padded tokens out ("ignore"
    padding), shift regions apart; None when nothing is masked."""
    T, H, W = data_shape
    pad_t = (cuboid_size[0] - T % cuboid_size[0]) % cuboid_size[0]
    pad_h = (cuboid_size[1] - H % cuboid_size[1]) % cuboid_size[1]
    pad_w = (cuboid_size[2] - W % cuboid_size[2]) % cuboid_size[2]
    padded = (pad_t or pad_h or pad_w) and padding_type == "ignore"
    shifted = any(s > 0 for s in shift_size)
    if not padded and not shifted:
        return None
    Tp, Hp, Wp = T + pad_t, H + pad_h, W + pad_w
    data_mask = np.pad(np.ones((1, T, H, W, 1), dtype=bool), ((0, 0), (0, pad_t), (0, pad_h), (0, pad_w), (0, 0)))
    if shifted:
        data_mask = np.roll(data_mask, shift=(-shift_size[0], -shift_size[1], -shift_size[2]), axis=(1, 2, 3))
    data_mask = _np_cuboid_reorder(data_mask, cuboid_size, strategy)[0, :, :, 0]
    # the reference's slice triplets: on a zero-shift axis the middle slice is empty and the last covers the
    # whole axis, so that axis splits no region
    shift_mask = np.zeros((1, Tp, Hp, Wp, 1))
    cnt = 0
    for t in (slice(-cuboid_size[0]), slice(-cuboid_size[0], -shift_size[0]), slice(-shift_size[0], None)):
        for h in (slice(-cuboid_size[1]), slice(-cuboid_size[1], -shift_size[1]), slice(-shift_size[1], None)):
            for w in (slice(-cuboid_size[2]), slice(-cuboid_size[2], -shift_size[2]), slice(-shift_size[2], None)):
                shift_mask[:, t, h, w, :] = cnt
                cnt += 1
    shift_mask = _np_cuboid_reorder(shift_mask, cuboid_size, strategy)[0, :, :, 0]
    mask = shift_mask[:, None, :] == shift_mask[:, :, None]
    if padding_type == "ignore":
        mask = mask & data_mask[:, None, :] & data_mask[:, :, None]
    return mask


@functools.lru_cache(maxsize=256)
def _cross_attn_mask(T_x, T_mem, H, W, n_temporal, cuboid_hw, shift_hw, strategy, padding_type):
    """(num_cuboids, x_vol, mem_vol) bool mask of cross attention:
    left-padded memory frames out, shift regions apart; None when nothing
    is masked."""
    pad_t_mem = (n_temporal - T_mem % n_temporal) % n_temporal
    pad_t_x = (n_temporal - T_x % n_temporal) % n_temporal
    pad_h = (cuboid_hw[0] - H % cuboid_hw[0]) % cuboid_hw[0]
    pad_w = (cuboid_hw[1] - W % cuboid_hw[1]) % cuboid_hw[1]
    shifted = any(s > 0 for s in shift_hw)
    if not (pad_t_mem or pad_t_x or pad_h or pad_w) and not shifted:
        return None
    Hp, Wp = H + pad_h, W + pad_w
    mem_cuboid = ((T_mem + pad_t_mem) // n_temporal,) + tuple(cuboid_hw)
    x_cuboid = ((T_x + pad_t_x) // n_temporal,) + tuple(cuboid_hw)

    def _mk_mask(T, pad_t, t_pad_left, cuboid):
        m = np.ones((1, T, H, W, 1), dtype=bool)
        tpad = (pad_t, 0) if t_pad_left else (0, pad_t)
        m = np.pad(m, ((0, 0), tpad, (0, pad_h), (0, pad_w), (0, 0)))
        if shifted:
            m = np.roll(m, shift=(-shift_hw[0], -shift_hw[1]), axis=(2, 3))
        return _np_cuboid_reorder(m, cuboid, strategy)[0, :, :, 0]

    mem_mask = _mk_mask(T_mem, pad_t_mem, True, mem_cuboid)
    x_mask = _mk_mask(T_x, pad_t_x, False, x_cuboid)
    shift_mask = np.zeros((1, 1, Hp, Wp, 1))
    cnt = 0
    for h in (slice(-cuboid_hw[0]), slice(-cuboid_hw[0], -shift_hw[0]), slice(-shift_hw[0], None)):
        for w in (slice(-cuboid_hw[1]), slice(-cuboid_hw[1], -shift_hw[1]), slice(-shift_hw[1], None)):
            shift_mask[:, :, h, w, :] = cnt
            cnt += 1
    sm = _np_cuboid_reorder(shift_mask, (1,) + tuple(cuboid_hw), strategy)[0, :, :, 0]
    # the region ids of each spatial window, over the temporal extents and the temporal blocks
    n_sp, xt, mt = sm.shape[0], x_cuboid[0], mem_cuboid[0]
    sm_x = np.tile(sm[:, None, :], (1, xt, 1)).reshape(n_sp, xt * sm.shape[1])
    sm_m = np.tile(sm[:, None, :], (1, mt, 1)).reshape(n_sp, mt * sm.shape[1])
    reps = x_mask.shape[0] // n_sp
    sm_x, sm_m = np.tile(sm_x, (reps, 1)), np.tile(sm_m, (reps, 1))
    mask = sm_x[:, :, None] == sm_m[:, None, :]
    if padding_type == "ignore":
        mask = mask & x_mask[:, :, None] & mem_mask[:, None, :]
    return mask


@functools.lru_cache(maxsize=256)
def _relpos_index_self(cuboid_size, table_cuboid=None):
    """(vol, vol) flat index into the ((2t-1)(2h-1)(2w-1), heads) table of
    ``table_cuboid`` (default: the cuboid itself; a clamped cuboid indexes
    the larger table built for the configured one)."""
    t, h, w = cuboid_size
    t0, h0, w0 = table_cuboid or cuboid_size
    coords = np.stack(np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij"), axis=-1).reshape(-1, 3)
    rel = coords[:, None, :] - coords[None, :, :] + np.array([t0 - 1, h0 - 1, w0 - 1])
    return ((rel[..., 0] * (2 * h0 - 1) + rel[..., 1]) * (2 * w0 - 1) + rel[..., 2]).astype(np.int32)


@functools.lru_cache(maxsize=256)
def _relpos_index_cross(t_x, t_mem, cuboid_hw, max_t_rel, table_hw=None):
    """(x_vol, mem_vol) flat index into a ((2 max_t_rel - 1)(2h-1)(2w-1))
    table (of ``table_hw``, default the window itself); temporal offsets
    are clamped into the table."""
    h, w = cuboid_hw
    h0, w0 = table_hw or cuboid_hw
    grid = lambda t: np.stack(np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij"),  # noqa: E731
                              axis=-1).reshape(-1, 3)
    rel = grid(t_x)[:, None, :] - grid(t_mem)[None, :, :]
    rel_t = np.clip(rel[..., 0] + max_t_rel - 1, 0, 2 * max_t_rel - 2)
    return ((rel_t * (2 * h0 - 1) + rel[..., 1] + h0 - 1) * (2 * w0 - 1) + rel[..., 2] + w0 - 1).astype(np.int32)


_DEVICE_TABLES: Dict[tuple, torch.Tensor] = {}


def _on_device(table: Optional[np.ndarray], key: tuple, device: torch.device, dtype: torch.dtype):
    """A mask or index table on ``device``, copied there at its first use
    (an eager step) and kept: a captured step makes no host copy."""
    if table is None:
        return None
    key = key + (str(device), dtype)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = torch.from_numpy(np.ascontiguousarray(table)).to(device=device, dtype=dtype)
    return _DEVICE_TABLES[key]


# ------------------------------------------------------------ attention --


def _dropout(x: torch.Tensor, rate: float, generator: Gen) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``generator``;
    identity without one or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _masked_mha(q, k, v, heads: int, mask=None, bias=None, extra_kv=None, l2g_q=None, attn_drop: float = 0.0,
                generator: Gen = None) -> torch.Tensor:
    """Cuboid-batched multi-head attention. q (B, nc, Lq, C), k and v (B,
    nc, Lk, C); ``mask`` (nc, Lq, Lk) bool or None; ``bias`` (heads, Lq,
    Lk) or None; ``extra_kv`` a (k_g, v_g) pair of (B, G, C) global tokens
    appended to every cuboid's keys (never masked), scored against
    ``l2g_q`` (B, nc, Lq, C) when given, else against q. Dropout on the
    weights after the softmax; a fully masked query row gives zeros."""
    B, nc, Lq, C = q.shape
    Lk = k.shape[2]
    d = C // heads
    qh = q.reshape(B, nc, Lq, heads, d)
    kh = k.reshape(B, nc, Lk, heads, d)
    vh = v.reshape(B, nc, Lk, heads, d)
    score = torch.einsum("bnlhd,bnmhd->bnhlm", qh, kh) / math.sqrt(d)
    if bias is not None:
        score = score + bias[None, None]
    if extra_kv is not None:
        kg, vg = extra_kv
        G = kg.shape[1]
        kgh, vgh = kg.reshape(B, G, heads, d), vg.reshape(B, G, heads, d)
        qg_h = (l2g_q if l2g_q is not None else q).reshape(B, nc, Lq, heads, d)
        score = torch.cat([score, torch.einsum("bnlhd,bghd->bnhlg", qg_h, kgh) / math.sqrt(d)], dim=-1)
    if mask is not None:
        m = torch.cat([mask, mask.new_ones(mask.shape[:-1] + (G,))], dim=-1) if extra_kv is not None else mask
        m = m[None, :, None]
        score = torch.where(m, score, torch.full_like(score, -1e9))
        att = torch.softmax(score, dim=-1) * m
    else:
        att = torch.softmax(score, dim=-1)
    att = _dropout(att, attn_drop, generator)
    if extra_kv is not None:
        out = (torch.einsum("bnhlm,bnmhd->bnlhd", att[..., :Lk], vh)
               + torch.einsum("bnhlg,bghd->bnlhd", att[..., Lk:], vgh))
    else:
        out = torch.einsum("bnhlm,bnmhd->bnlhd", att, vh)
    return out.reshape(B, nc, Lq, C)


def _trunc_normal(shape, generator: torch.Generator, std: float = 0.02) -> nn.Parameter:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2.0, 2.0, generator=generator)
    return nn.Parameter(t)


def _pad5(x: torch.Tensor, t: Tuple[int, int], h: int, w: int) -> torch.Tensor:
    """Zero-pad (B, T, H, W, C): T by (before, after), H and W after."""
    if not (t[0] or t[1] or h or w):
        return x
    return F.pad(x, (0, 0, 0, w, 0, h, t[0], t[1]))


class CuboidSelfAttention(nn.Module):
    """One cuboid self-attention layer: local or dilated decomposition,
    optional shift, padding/shift mask, relative-position bias, optional
    global vectors."""

    def __init__(self, dim: int, num_heads: int, cuboid_size: Tuple[int, int, int],
                 shift_size: Union[bool, Tuple[int, int, int]] = (0, 0, 0),
                 strategy: Tuple[str, str, str] = ("l", "l", "l"), use_global: bool = False,
                 use_relative_pos: bool = True, padding_type: str = "ignore", attn_drop: float = 0.0,
                 proj_drop: float = 0.0, separate_global_qkv: bool = False, global_dim_ratio: int = 1,
                 use_global_self_attn: bool = False, *, generator: torch.Generator):
        super().__init__()
        if global_dim_ratio != 1 and not separate_global_qkv:
            raise ValueError("global_dim_ratio != 1 requires separate_global_qkv=True")
        g = generator
        self.qkv = Linear(dim, 3 * dim, generator=g)
        self.proj = Linear(dim, dim, generator=g)
        self.h = num_heads
        self.cuboid = tuple(cuboid_size)
        if isinstance(shift_size, bool):  # True: a half-cuboid shift
            shift_size = tuple(c // 2 for c in self.cuboid) if shift_size else (0, 0, 0)
        self.shift = tuple(shift_size)
        self.strategy = tuple(strategy)
        self.padding_type = padding_type
        self.use_global = use_global
        self.use_relative_pos = use_relative_pos
        self.attn_drop = float(attn_drop)
        self.proj_drop = float(proj_drop)
        self.separate_global_qkv = separate_global_qkv
        self.global_dim_ratio = int(global_dim_ratio)
        self.use_global_self_attn = use_global_self_attn
        if use_relative_pos:
            t, h, w = self.cuboid
            self.rel_bias = _trunc_normal(((2 * t - 1) * (2 * h - 1) * (2 * w - 1), num_heads), g)
        if use_global:
            gdim = self.global_dim_ratio * dim
            self.g_norm = LayerNorm(gdim)
            if separate_global_qkv:
                self.l2g_q = Linear(dim, dim, generator=g)
                self.l2g_global_kv = Linear(gdim, 2 * dim, generator=g)
                self.g2l_global_q = Linear(gdim, dim, generator=g)
                self.g2l_k = Linear(dim, dim, generator=g)
                self.g2l_v = Linear(dim, gdim, generator=g)
                if use_global_self_attn:
                    self.g2g_global_qkv = Linear(gdim, 3 * gdim, generator=g)
            else:
                self.global_qkv = Linear(dim, 3 * dim, generator=g)
            self.global_proj = Linear(gdim, gdim, generator=g)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None, qkv_vol: Optional[torch.Tensor] = None,
                generator: Gen = None):
        """(y, global update or None). ``qkv_vol``: a precomputed (B, T, H,
        W, 3C) projection (the attention MoE routes it per token before the
        decomposition)."""
        B, T, H, W, C = x.shape
        cub, shf = _clamp_cuboid((T, H, W), self.cuboid, self.shift, self.strategy)
        pad_t, pad_h, pad_w = ((c - n % c) % c for c, n in zip(cub, (T, H, W)))
        x_p = _pad5(x, (0, pad_t), pad_h, pad_w)
        if qkv_vol is not None:
            qkv_vol = _pad5(qkv_vol, (0, pad_t), pad_h, pad_w)
        shifted = any(s > 0 for s in shf)
        if shifted:
            x_p = torch.roll(x_p, shifts=(-shf[0], -shf[1], -shf[2]), dims=(1, 2, 3))
            if qkv_vol is not None:
                qkv_vol = torch.roll(qkv_vol, shifts=(-shf[0], -shf[1], -shf[2]), dims=(1, 2, 3))
        shape_p = x_p.shape[1:4]
        tok = cuboid_reorder(x_p, cub, self.strategy)  # (B, nc, vol, C)
        src = self.qkv(tok) if qkv_vol is None else cuboid_reorder(qkv_vol, cub, self.strategy)
        qkv = src.reshape(*tok.shape[:3], 3, C)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

        mask_args = ((T, H, W), cub, shf, self.strategy, self.padding_type)
        mask = _on_device(_self_attn_mask(*mask_args), ("self",) + mask_args, x.device, torch.bool)
        bias = None
        if self.use_relative_pos:
            table = None if cub == self.cuboid else self.cuboid
            idx = _on_device(_relpos_index_self(cub, table), ("relpos_self", cub, table), x.device, torch.int64)
            bias = self.rel_bias[idx].permute(2, 0, 1)  # (heads, vol, vol)

        extra_kv = l2g_q = gn = qg = None
        if self.use_global and g is not None:
            gn = self.g_norm(g)
            G = g.shape[1]
            if self.separate_global_qkv:
                g_kv = self.l2g_global_kv(gn).reshape(B, G, 2, C)
                extra_kv = (g_kv[:, :, 0], g_kv[:, :, 1])
                l2g_q = self.l2g_q(tok)
            else:
                g_qkv = self.global_qkv(gn).reshape(B, G, 3, C)
                qg, extra_kv = g_qkv[:, :, 0], (g_qkv[:, :, 1], g_qkv[:, :, 2])
        out = _masked_mha(q, k, v, self.h, mask, bias, extra_kv, l2g_q=l2g_q, attn_drop=self.attn_drop,
                          generator=generator)
        out = _dropout(self.proj(out), self.proj_drop, generator)
        y = cuboid_reorder_reverse(out, cub, self.strategy, shape_p)
        if shifted:
            y = torch.roll(y, shifts=shf, dims=(1, 2, 3))
        if pad_t or pad_h or pad_w:
            y = y[:, :T, :H, :W]
        if gn is None:
            return y, None
        # the globals attend over every (unpadded, unshifted) token, and over each other with use_global_self_attn
        gdim = self.global_dim_ratio * C
        d = C // self.h
        gd = self.global_dim_ratio * d
        flat = x.reshape(B, T * H * W, C)
        if self.separate_global_qkv:
            g_q, k_all, v_all = self.g2l_global_q(gn), self.g2l_k(flat), self.g2l_v(flat)
        else:
            g_q = qg
            kv = self.qkv(flat).reshape(B, -1, 3, C)
            k_all, v_all = kv[:, :, 1], kv[:, :, 2]
        L = k_all.shape[1]
        qh = g_q.reshape(B, G, self.h, d)
        kh = k_all.reshape(B, L, self.h, d)
        vh = v_all.reshape(B, L, self.h, gd)
        score = torch.einsum("bghd,blhd->bhgl", qh, kh) / math.sqrt(d)
        if self.use_global_self_attn:
            if self.separate_global_qkv:
                gg = self.g2g_global_qkv(gn).reshape(B, G, 3, gdim)
                gg_q, gg_k, gg_v = (gg[:, :, i].reshape(B, G, self.h, gd) for i in range(3))
            else:
                gg_q = qg.reshape(B, G, self.h, d)
                gg_k = extra_kv[0].reshape(B, G, self.h, d)
                gg_v = extra_kv[1].reshape(B, G, self.h, gd)
            score = torch.cat([score, torch.einsum("bghd,bmhd->bhgm", gg_q, gg_k) / math.sqrt(d)], dim=-1)
            vh = torch.cat([vh, gg_v], dim=1)
        att = _dropout(torch.softmax(score, dim=-1), self.attn_drop, generator)
        g_upd = torch.einsum("bhgl,blhd->bghd", att, vh).reshape(B, G, gdim)
        return y, _dropout(self.global_proj(g_upd), self.proj_drop, generator)


class CuboidCrossAttention(nn.Module):
    """Decoder cross-attention: queries from the decoder volume, keys and
    values from one encoder memory level, in (H, W) windows with
    ``n_temporal`` dilated temporal groups."""

    def __init__(self, dim, num_heads, cuboid_hw=(4, 4), shift_hw=(0, 0), strategy=("l", "l", "l"),
                 n_temporal: int = 1, max_temporal_relative: int = 50, cross_last_n_frames: Optional[int] = None,
                 use_global=False, use_relative_pos=True, padding_type="ignore", attn_drop: float = 0.0,
                 proj_drop: float = 0.0, global_dim_ratio: int = 1, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.q = Linear(dim, dim, generator=g)
        self.kv = Linear(dim, 2 * dim, generator=g)
        self.proj = Linear(dim, dim, generator=g)
        self.attn_drop = float(attn_drop)
        self.proj_drop = float(proj_drop)
        self.h = num_heads
        self.cuboid_hw = tuple(cuboid_hw)
        self.shift_hw = tuple(shift_hw)
        self.strategy = tuple(strategy)
        self.n_temporal = int(n_temporal)
        self.max_t_rel = max_temporal_relative
        self.cross_last_n_frames = cross_last_n_frames
        self.padding_type = padding_type
        self.use_global = use_global
        self.use_relative_pos = use_relative_pos
        if use_relative_pos:
            h, w = self.cuboid_hw
            self.rel_bias = _trunc_normal(((2 * max_temporal_relative - 1) * (2 * h - 1) * (2 * w - 1), num_heads), g)
        if use_global:
            self.g_kv = Linear(global_dim_ratio * dim, 2 * dim, generator=g)

    def forward(self, x, mem, g=None, generator: Gen = None):
        if self.cross_last_n_frames is not None:
            mem = mem[:, -min(self.cross_last_n_frames, mem.shape[1]):]
        B, T_x, H, W, C = x.shape
        T_mem = mem.shape[1]
        ch, cw = min(self.cuboid_hw[0], H), min(self.cuboid_hw[1], W)
        shf = tuple(s if c > 1 else 0 for s, c in zip(self.shift_hw, (ch, cw)))
        n_t = min(self.n_temporal, T_x, T_mem)
        pad_t_mem = (n_t - T_mem % n_t) % n_t
        pad_t_x = (n_t - T_x % n_t) % n_t
        pad_h, pad_w = (ch - H % ch) % ch, (cw - W % cw) % cw
        mem_p = _pad5(mem, (pad_t_mem, 0), pad_h, pad_w)  # memory pads left: the latest frames stay aligned
        x_p = _pad5(x, (0, pad_t_x), pad_h, pad_w)
        shifted = any(s > 0 for s in shf)
        if shifted:
            x_p = torch.roll(x_p, shifts=(-shf[0], -shf[1]), dims=(2, 3))
            mem_p = torch.roll(mem_p, shifts=(-shf[0], -shf[1]), dims=(2, 3))
        mem_cub = (mem_p.shape[1] // n_t, ch, cw)
        x_cub = (x_p.shape[1] // n_t, ch, cw)
        rx = cuboid_reorder(x_p, x_cub, self.strategy)
        rm = cuboid_reorder(mem_p, mem_cub, self.strategy)
        q = self.q(rx)
        kv = self.kv(rm).reshape(*rm.shape[:3], 2, C)
        k, v = kv[..., 0, :], kv[..., 1, :]

        mask_args = (T_x, T_mem, H, W, n_t, (ch, cw), shf, self.strategy, self.padding_type)
        mask = _on_device(_cross_attn_mask(*mask_args), ("cross",) + mask_args, x.device, torch.bool)
        bias = None
        if self.use_relative_pos:
            table = None if (ch, cw) == self.cuboid_hw else self.cuboid_hw
            key = (x_cub[0], mem_cub[0], (ch, cw), self.max_t_rel, table)
            idx = _on_device(_relpos_index_cross(*key), ("relpos_cross",) + key, x.device, torch.int64)
            bias = self.rel_bias[idx].permute(2, 0, 1)
        extra_kv = None
        if self.use_global and g is not None:
            g_kv = self.g_kv(g).reshape(B, g.shape[1], 2, C)
            extra_kv = (g_kv[:, :, 0], g_kv[:, :, 1])
        out = _masked_mha(q, k, v, self.h, mask, bias, extra_kv, attn_drop=self.attn_drop, generator=generator)
        out = _dropout(self.proj(out), self.proj_drop, generator)
        y = cuboid_reorder_reverse(out, x_cub, self.strategy, x_p.shape[1:4])
        if shifted:
            y = torch.roll(y, shifts=shf, dims=(2, 3))
        return y[:, :T_x, :H, :W]


# --------------------------------------------------------------- blocks --


class _FFN(nn.Module):
    """Positionwise FFN, tanh GELU, dropout after the activation and after
    the output layer."""

    def __init__(self, dim, hidden, ffn_drop: float = 0.0, out_dim=None, *, generator: torch.Generator):
        super().__init__()
        self.fc1 = Linear(dim, hidden, generator=generator)
        self.fc2 = Linear(hidden, out_dim or dim, generator=generator)
        self.ffn_drop = float(ffn_drop)

    def forward(self, x, generator: Gen = None):
        h = _dropout(F.gelu(self.fc1(x), approximate="tanh"), self.ffn_drop, generator)
        return _dropout(self.fc2(h), self.ffn_drop, generator)


class _CuboidBlock(nn.Module):
    """Pre-norm cuboid self-attention layers (one pattern expansion:
    ``layers`` of (cuboid, strategy, shift)), each followed by its own FFN
    (a ``MixtureFFN`` with ``moe_config``), with the global-vector pathway.
    Returns (x, g, aux loss)."""

    def __init__(self, dim, num_heads, layers, mlp_ratio, moe_config=None, expert_shape=None, use_global=False,
                 use_relative_pos=True, padding_type="ignore", attn_drop: float = 0.0, proj_drop: float = 0.0,
                 ffn_drop: float = 0.0, separate_global_qkv: bool = False, global_dim_ratio: int = 1,
                 use_global_self_attn: bool = False, use_global_vector_ffn: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        gen = generator
        self.use_moe = bool(moe_config) and moe_config.get("use_ffn_moe", True)
        self.use_attn_moe = bool(moe_config) and moe_config.get("use_attn_moe", False)
        self.use_global = use_global
        self.use_global_vector_ffn = use_global_vector_ffn
        gdim = global_dim_ratio * dim
        attns, ffns, ln1, ln2, qkv_moes, g_ffns = [], [], [], [], [], []
        for cub, strat, shift in layers:
            ln1.append(LayerNorm(dim))
            attns.append(CuboidSelfAttention(
                dim, num_heads, cub, shift, strat, use_global=use_global, use_relative_pos=use_relative_pos,
                padding_type=padding_type, attn_drop=attn_drop, proj_drop=proj_drop,
                separate_global_qkv=separate_global_qkv, global_dim_ratio=global_dim_ratio,
                use_global_self_attn=use_global_self_attn, generator=gen))
            ln2.append(LayerNorm(dim))
            if self.use_moe:
                ffns.append(MixtureFFN(dim, int(dim * mlp_ratio), expert_shape, moe_config, generator=gen))
            else:
                ffns.append(_FFN(dim, int(dim * mlp_ratio), ffn_drop, generator=gen))
            if use_global and use_global_vector_ffn:
                g_ffns.append(_FFN(gdim, int(gdim * mlp_ratio), ffn_drop, generator=gen))
            if self.use_attn_moe:
                qkv_moes.append(MixtureLinear(dim, 3 * dim, expert_shape, moe_config, generator=gen))
        self.attns = nn.ModuleList(attns)
        self.ffns = nn.ModuleList(ffns)
        self.ln1 = nn.ModuleList(ln1)
        self.ln2 = nn.ModuleList(ln2)
        if self.use_attn_moe:
            self.qkv_moes = nn.ModuleList(qkv_moes)
        if use_global and use_global_vector_ffn:
            self.g_ffns = nn.ModuleList(g_ffns)
            self.g_lns = nn.ModuleList([LayerNorm(gdim) for _ in layers])

    def forward(self, x, g=None, generator: Gen = None):
        aux = torch.zeros((), device=x.device)
        for i, (attn, ffn) in enumerate(zip(self.attns, self.ffns)):
            xn = self.ln1[i](x)
            qkv_vol = None
            if self.use_attn_moe:
                qkv_vol, a_aux = self.qkv_moes[i](xn, generator)
                aux = aux + a_aux
            a, g_upd = attn(xn, g, qkv_vol=qkv_vol, generator=generator)
            x = x + a
            if g_upd is not None:
                g = g + g_upd
                if self.use_global_vector_ffn:
                    g = g + self.g_ffns[i](self.g_lns[i](g), generator)
            if self.use_moe:
                y, m_aux = ffn(self.ln2[i](x), generator)
                x = x + y
                aux = aux + m_aux
            else:
                x = x + ffn(self.ln2[i](x), generator)
        return x, g, aux


class _CrossBlock(nn.Module):
    """Pre-norm cuboid cross-attention layers into one memory level
    (``layers`` of (cuboid_hw, shift_hw, strategy, n_temporal)), each
    followed by its own FFN (a ``MixtureFFN`` with ``moe_config``).
    Returns (x, aux loss)."""

    def __init__(self, dim, num_heads, layers, mlp_ratio, max_temporal_relative=50, cross_last_n_frames=None,
                 use_global=False, use_relative_pos=True, padding_type="ignore", attn_drop: float = 0.0,
                 proj_drop: float = 0.0, ffn_drop: float = 0.0, global_dim_ratio: int = 1, moe_config=None,
                 expert_shape=None, *, generator: torch.Generator):
        super().__init__()
        gen = generator
        self.use_moe = bool(moe_config) and moe_config.get("use_ffn_moe", True)
        attns, ffns, ln_q, ln_kv, ln2 = [], [], [], [], []
        for chw, shw, strat, n_t in layers:
            ln_q.append(LayerNorm(dim))
            ln_kv.append(LayerNorm(dim))
            attns.append(CuboidCrossAttention(
                dim, num_heads, chw, shw, strat, n_t, max_temporal_relative, cross_last_n_frames,
                use_global=use_global, use_relative_pos=use_relative_pos, padding_type=padding_type,
                attn_drop=attn_drop, proj_drop=proj_drop, global_dim_ratio=global_dim_ratio, generator=gen))
            ln2.append(LayerNorm(dim))
            if self.use_moe:
                ffns.append(MixtureFFN(dim, int(dim * mlp_ratio), expert_shape, moe_config, generator=gen))
            else:
                ffns.append(_FFN(dim, int(dim * mlp_ratio), ffn_drop, generator=gen))
        self.attns = nn.ModuleList(attns)
        self.ffns = nn.ModuleList(ffns)
        self.ln_q = nn.ModuleList(ln_q)
        self.ln_kv = nn.ModuleList(ln_kv)
        self.ln2 = nn.ModuleList(ln2)

    def forward(self, x, mem, g=None, generator: Gen = None):
        aux = torch.zeros((), device=x.device)
        for i, (attn, ffn) in enumerate(zip(self.attns, self.ffns)):
            x = x + attn(self.ln_q[i](x), self.ln_kv[i](mem), g, generator=generator)
            if self.use_moe:
                y, m_aux = ffn(self.ln2[i](x), generator)
                x = x + y
                aux = aux + m_aux
            else:
                x = x + ffn(self.ln2[i](x), generator)
        return x, aux


def _frames_conv(convs, x: torch.Tensor) -> torch.Tensor:
    """Each frame of (B, T, H, W, C) through ``convs`` (channel-first 2-D
    convs), leaky ReLU 0.1 after each; returns (B, T, H, W, C')."""
    B, T, H, W, C = x.shape
    h = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    for conv in convs:
        h = F.leaky_relu(conv(h), 0.1)
    return h.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)


class _PatchMerge(nn.Module):
    """2 x 2 spatial merge, LayerNorm and a channel projection."""

    def __init__(self, dim, out_dim, *, generator: torch.Generator):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, out_dim, generator=generator)

    def forward(self, x):
        B, T, H, W, C = x.shape
        pad_h, pad_w = H % 2, W % 2
        if pad_h or pad_w:
            x = _pad5(x, (0, 0), pad_h, pad_w)
            H, W = H + pad_h, W + pad_w
        x = x.reshape(B, T, H // 2, 2, W // 2, 2, C).permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


class _Upsample3D(nn.Module):
    """Nearest spatial upsample (``jax.image.resize``'s rule) and a 3 x 3
    conv."""

    def __init__(self, dim, out_dim, kernel=3, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv(dim, out_dim, (kernel, kernel), padding="SAME", generator=generator)

    def forward(self, x, target_hw):
        B, T, H, W, C = x.shape
        h = resize(x.reshape(B * T, H, W, C), (B * T, target_hw[0], target_hw[1], C), "nearest")
        h = self.conv(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return h.reshape(B, T, target_hw[0], target_hw[1], -1)


class _InitialEncoder(nn.Module):
    """3 x 3 convs to ``dim`` channels, then LayerNorm."""

    def __init__(self, c_in, dim, num_conv=2, *, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(Conv(c_in if i == 0 else dim, dim, (3, 3), padding="SAME", generator=generator)
                                   for i in range(num_conv))
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.norm(_frames_conv(self.convs, x))


class _FinalDecoder(nn.Module):
    """3 x 3 convs, LayerNorm and a linear head."""

    def __init__(self, dim, c_out, num_conv=2, *, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList(Conv(dim, dim, (3, 3), padding="SAME", generator=generator)
                                   for _ in range(num_conv))
        self.norm = LayerNorm(dim)
        self.head = Linear(dim, c_out, generator=generator)

    def forward(self, x):
        return self.head(self.norm(_frames_conv(self.convs, x)))


def _expand_self_layers(pattern, shape, cuboid_size, strategy, shift, depth):
    """Per-block layer lists of one level: a named ``pattern``, else
    explicit lists, else the legacy single cuboid (one layer a block, odd
    blocks half-shifted)."""
    if pattern is not None:
        cs, st, sh = CuboidSelfAttentionPatterns.get(pattern)(shape)
        layers = list(zip([tuple(c) for c in cs], [tuple(s) for s in st], [tuple(s) for s in sh]))
        return [layers for _ in range(depth)]
    if cuboid_size and isinstance(cuboid_size[0], (tuple, list)):
        layers = list(zip([tuple(c) for c in cuboid_size], [tuple(s) for s in strategy], [tuple(s) for s in shift]))
        return [layers for _ in range(depth)]
    cub = tuple(cuboid_size)
    return [[(cub, ("l", "l", "l"), tuple(c // 2 for c in cub) if d % 2 == 1 else (0, 0, 0))] for d in range(depth)]


def _expand_cross_layers(pattern, mem_shape, cuboid_hw, shift_hw, strategy, n_temporal):
    """The cross layers of one level: a named pattern or explicit lists."""
    if pattern is not None:
        chw, shw, st, nt = CuboidCrossAttentionPatterns.get(pattern)(mem_shape)
        return list(zip([tuple(c) for c in chw], [tuple(s) for s in shw], [tuple(s) for s in st], list(nt)))
    if cuboid_hw and isinstance(cuboid_hw[0], (tuple, list)):
        return list(zip([tuple(c) for c in cuboid_hw], [tuple(s) for s in shift_hw], [tuple(s) for s in strategy],
                        list(n_temporal)))
    return [(tuple(cuboid_hw), (0, 0), ("l", "l", "l"), 1)]


def _replaying(generator: torch.Generator):
    """``context_fn`` of a checkpointed block: the recompute draws what the
    forward drew (the generator's state is restored for it, then put back)."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        saved["state"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        after = generator.get_state()
        generator.set_state(saved["state"])
        try:
            yield
        finally:
            generator.set_state(after)

    return forward(), recompute()


class CuboidTransformer(Arch):
    """Earthformer hierarchical encoder-decoder: (B, T_in, H, W, C_in) ->
    (B, T_out, H, W, C_out). ``enc_depth``/``dec_depth`` give the blocks
    per level; every level halves H and W and doubles the channels."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...],
                 input_shape: Tuple[int, int, int, int], target_shape: Tuple[int, int, int, int],
                 base_units: int = 64, num_heads: int = 4, enc_depth: Tuple[int, ...] = (4, 4),
                 dec_depth: Tuple[int, ...] = (2, 2), cuboid_size: Tuple[int, int, int] = (2, 4, 4),
                 mlp_ratio: float = 4.0, downsample: int = 2, remat: bool = False, num_experts: int = 0,
                 moe_config: Optional[Dict] = None, num_global_vectors: int = 4,
                 dec_cross_cuboid_hw: Tuple[int, int] = (4, 4), initial_conv_layers: int = 2,
                 final_conv_layers: int = 2, self_pattern: Optional[str] = None,
                 cross_self_pattern: Optional[str] = None, cross_pattern: Optional[str] = None,
                 enc_cuboid_size=None, enc_cuboid_strategy=None, enc_shift_size=None, dec_self_cuboid_size=None,
                 dec_self_cuboid_strategy=None, dec_self_shift_size=None, dec_cross_cuboid_strategy=None,
                 dec_cross_shift_hw=None, dec_cross_n_temporal=None, dec_cross_start: int = 0,
                 dec_use_first_self_attn: bool = False, cross_last_n_frames: Optional[int] = None,
                 use_relative_pos: bool = True, padding_type: str = "ignore", z_init_method: str = "nearest_interp",
                 attn_drop: float = 0.0, proj_drop: float = 0.0, ffn_drop: float = 0.0,
                 separate_global_qkv: bool = False, global_dim_ratio: int = 1, use_global_self_attn: bool = False,
                 use_global_vector_ffn: bool = True, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, **kwargs):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        T_in, H, W, C_in = input_shape
        T_out, _, _, C_out = target_shape
        self.T_in, self.T_out, self.C_out = T_in, T_out, C_out
        self.remat = remat
        self.num_levels = len(enc_depth)
        if len(dec_depth) != self.num_levels:
            raise ValueError(f"dec_depth {dec_depth} must have one entry per encoder level {enc_depth}")
        self.num_global = num_global_vectors
        self.dec_cross_start = dec_cross_start
        self.use_first_self_attn = dec_use_first_self_attn
        if z_init_method not in ("zeros", "nearest_interp", "last", "mean"):
            raise ValueError(f"z_init_method {z_init_method!r} invalid")
        if padding_type not in ("ignore", "zeros"):
            raise NotImplementedError(f"padding_type {padding_type!r} (ignore, zeros)")
        self.z_init_method = z_init_method
        dims = self.dims = [base_units * (2**i) for i in range(self.num_levels)]
        hw = self.hw = [(max(H >> i, 1), max(W >> i, 1)) for i in range(self.num_levels)]
        enc_shapes = [(T_in, hw[i][0], hw[i][1], dims[i]) for i in range(self.num_levels)]
        dec_shapes = [(T_out, hw[i][0], hw[i][1], dims[i]) for i in range(self.num_levels)]
        if moe_config is None and num_experts > 0:
            moe_config = default_moe_config(num_experts=num_experts, out_planes=min(4, max(2, num_experts)))
        self.moe_config = moe_config
        self._train_gen: Gen = None

        self.initial_encoder = _InitialEncoder(C_in, base_units, initial_conv_layers, generator=gen)
        self.pos = _trunc_normal((1, T_in, H, W, base_units), gen)
        self.global_dim_ratio = int(global_dim_ratio)
        self._has_dropout = max(attn_drop, proj_drop, ffn_drop) > 0.0
        if self.num_global > 0:
            self.init_global = _trunc_normal((1, self.num_global, self.global_dim_ratio * base_units), gen)
            self.g_proj = nn.ModuleList(
                Linear(self.global_dim_ratio * dims[i], self.global_dim_ratio * dims[i + 1], generator=gen)
                for i in range(self.num_levels - 1))
        drops = dict(attn_drop=attn_drop, proj_drop=proj_drop, ffn_drop=ffn_drop)
        common = dict(use_relative_pos=use_relative_pos, padding_type=padding_type, **drops)

        enc_levels, mergers = [], []
        for lev, depth in enumerate(enc_depth):
            per_block = _expand_self_layers(self_pattern, enc_shapes[lev], enc_cuboid_size or cuboid_size,
                                            enc_cuboid_strategy, enc_shift_size, depth)
            enc_levels.append(nn.ModuleList(
                _CuboidBlock(dims[lev], num_heads, layers, mlp_ratio, moe_config, (T_in, *hw[lev]),
                             use_global=self.num_global > 0, separate_global_qkv=separate_global_qkv,
                             global_dim_ratio=global_dim_ratio, use_global_self_attn=use_global_self_attn,
                             use_global_vector_ffn=use_global_vector_ffn, generator=gen, **common)
                for layers in per_block))
            if lev < self.num_levels - 1:
                mergers.append(_PatchMerge(dims[lev], dims[lev + 1], generator=gen))
        self.enc_levels = nn.ModuleList(enc_levels)
        self.mergers = nn.ModuleList(mergers)

        # the decoder from the coarsest level down; without use_first_self_attn the coarsest leads with cross
        max_t_rel = T_in + T_out
        dec_self, dec_cross, upsamplers = [], [], []
        for i, lev in enumerate(reversed(range(self.num_levels))):
            n_self = dec_depth[lev]
            if not self.use_first_self_attn and i == 0:
                n_self = max(n_self - 1, 0)
            self_layers = _expand_self_layers(cross_self_pattern, dec_shapes[lev], dec_self_cuboid_size or cuboid_size,
                                              dec_self_cuboid_strategy, dec_self_shift_size, max(n_self, 1))
            dec_self.append(nn.ModuleList(
                _CuboidBlock(dims[lev], num_heads, self_layers[d], mlp_ratio, moe_config, (T_out, *hw[lev]),
                             use_global=False, generator=gen, **common)
                for d in range(n_self)))
            cross_layers = _expand_cross_layers(cross_pattern, enc_shapes[lev], dec_cross_cuboid_hw,
                                                dec_cross_shift_hw, dec_cross_cuboid_strategy, dec_cross_n_temporal)
            n_cross = dec_depth[lev] if lev >= dec_cross_start else 0
            dec_cross.append(nn.ModuleList(
                _CrossBlock(dims[lev], num_heads, cross_layers, mlp_ratio, max_temporal_relative=max_t_rel,
                            cross_last_n_frames=cross_last_n_frames, use_global=self.num_global > 0,
                            global_dim_ratio=global_dim_ratio, moe_config=moe_config,
                            expert_shape=(T_out, *hw[lev]), generator=gen, **common)
                for _ in range(n_cross)))
            if lev > 0:
                upsamplers.append(_Upsample3D(dims[lev], dims[lev - 1], generator=gen))
        self.dec_self = nn.ModuleList(dec_self)
        self.dec_cross = nn.ModuleList(dec_cross)
        self.upsamplers = nn.ModuleList(upsamplers)
        self.final_decoder = _FinalDecoder(base_units, C_out, final_conv_layers, generator=gen)
        self.to(resolve_device(device))

    def set_train_rng(self, generator: Gen) -> None:
        """Install the generator that dropout and the MoE gates' noise draw
        from in the following forwards (None: deterministic)."""
        self._train_gen = generator

    def _block(self, blk, *args):
        gen = args[-1]
        if not self.remat:
            return blk(*args)
        if gen is None:
            return checkpoint(blk, *args, use_reentrant=False)
        return checkpoint(blk, *args, use_reentrant=False, context_fn=lambda: _replaying(gen))

    def _initial_z(self, final_mem: torch.Tensor) -> torch.Tensor:
        if self.z_init_method == "zeros":
            B, _, Hc, Wc, C = final_mem.shape
            return final_mem.new_zeros((B, self.T_out, Hc, Wc, C))
        if self.z_init_method == "last":
            return final_mem[:, -1:].repeat_interleave(self.T_out, dim=1)
        if self.z_init_method == "mean":
            return final_mem.mean(dim=1, keepdim=True).repeat_interleave(self.T_out, dim=1)
        T_mem = final_mem.shape[1]
        idx = torch.clamp(torch.arange(self.T_out, device=final_mem.device) * T_mem // max(self.T_out, 1), 0, T_mem - 1)
        return torch.index_select(final_mem, 1, idx)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        h = x[self.input_keys[0]]
        B = h.shape[0]
        h = self.initial_encoder(h) + self.pos
        active = self.moe_config is not None or self._has_dropout
        gen = self._train_gen if active else None
        total_aux = torch.zeros((), device=h.device)
        g = self.init_global.expand((B,) + self.init_global.shape[1:]) if self.num_global > 0 else None

        mem_l, g_l = [], []
        for lev, blocks in enumerate(self.enc_levels):
            for blk in blocks:
                h, g, aux = self._block(blk, h, g, gen)
                total_aux = total_aux + aux
            mem_l.append(h)
            g_l.append(g)
            if lev < self.num_levels - 1:
                h = self.mergers[lev](h)
                if g is not None:
                    g = self.g_proj[lev](g)

        z = self._initial_z(mem_l[-1])
        for i, lev in enumerate(reversed(range(self.num_levels))):
            selfs, crosses = list(self.dec_self[i]), list(self.dec_cross[i])
            if not self.use_first_self_attn and i == 0 and crosses:
                z, aux = self._block(crosses[0], z, mem_l[lev], g_l[lev], gen)
                total_aux = total_aux + aux
                crosses = crosses[1:]
            for d, sblk in enumerate(selfs):
                z, _, aux = self._block(sblk, z, None, gen)
                total_aux = total_aux + aux
                if d < len(crosses):
                    z, aux = self._block(crosses[d], z, mem_l[lev], g_l[lev], gen)
                    total_aux = total_aux + aux
            if lev > 0:
                z = self.upsamplers[i](z, self.hw[lev - 1])

        result = {self.output_keys[0]: self.final_decoder(z)}
        if self.moe_config is not None:
            result["aux_loss"] = total_aux.reshape(1, 1)
        return result


class ExtFormerMoECuboid(Arch):
    """The cuboid transformer with noisy top-k MoE FFNs (``moe_config``,
    default: ``default_moe_config`` with ``num_experts`` and top-min(4,
    max(2, num_experts))); its outputs carry ``aux_loss``."""

    def __init__(self, input_keys, output_keys, input_shape, target_shape, base_units=64, num_heads=4,
                 enc_depth=(2,), dec_depth=(2,), cuboid_size=(2, 4, 4), mlp_ratio=4.0, num_experts=4,
                 moe_config: Optional[Dict] = None, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, **kwargs):
        super().__init__()
        if moe_config is None:
            moe_config = default_moe_config(num_experts=num_experts, out_planes=min(4, max(2, num_experts)))
        self.inner = CuboidTransformer(input_keys, output_keys, input_shape, target_shape, base_units, num_heads,
                                       enc_depth, dec_depth, cuboid_size, mlp_ratio, moe_config=moe_config,
                                       generator=generator, device=device, **kwargs)
        self.input_keys = self.inner.input_keys
        self.output_keys = self.inner.output_keys
        self.moe_config = moe_config

    def set_train_rng(self, generator: Gen) -> None:
        self.inner.set_train_rng(generator)

    def forward(self, x):
        return self.inner(x)
