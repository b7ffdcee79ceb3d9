"""The port's Earthformer slice against paddlescience_tpu on the CPU:
the cuboid reorder, the attention masks and the relative-position indices
(bitwise), ``_masked_mha`` (a fully masked row, a bias, global keys, a
separate global query; 1e-6), each self-attention pattern and cross_1x1
(1e-5), ``CuboidTransformer`` with 0 and 2 global vectors (outputs 1e-5,
parameter gradients 1e-4 of the largest magnitude), the ENSO and SEVIR
windows (bitwise), ``sevir_skill_scores`` (1e-6), and three steps of the
ENSO example at dropout 0, its network cut to one level of base 8 with
one full-volume attention layer a block (losses 1e-4; the SEVIR
example's steps are ``test_torch_extformer_moe.py``'s, the train
generator's tests ``test_torch_train_generator.py``'s).

JAX runs at "highest" matmul precision (``_operator_parity.py``); its
bigger functions are jitted at XLA's lowest optimisation level
(``_earthformer_parity.py``), the small ones run eagerly."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import check_arch, fast_call, numpy_init, three_steps, one_torch_thread  # noqa: F401
from _operator_parity import close, highest_precision  # noqa: F401
from paddlescience_tpu.arch import cuboid_transformer as jct
from paddlescience_tpu.data.dataset import domain_dataset as jdd
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import cuboid_transformer as tct
from paddlescience_torch.data.dataset import domain_dataset as tdd
from paddlescience_torch.examples import earthformer_enso as tenso
from paddlescience_torch.examples import earthformer_sevir as tsevir
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import earthformer_enso as jenso  # noqa: E402  (the JAX examples)
import earthformer_sevir as jsevir  # noqa: E402  (its skill scores)


# --------------------------------------------- reorder, masks, indices --

REORDER = [((2, 4, 8, 6, 3), (2, 2, 3), ("l", "l", "l")), ((1, 4, 8, 6, 2), (4, 2, 2), ("l", "d", "d")),
           ((2, 6, 4, 8, 1), (3, 4, 2), ("d", "l", "d")), ((1, 3, 5, 7, 2), (3, 5, 7), ("l", "l", "l"))]


@pytest.mark.parametrize("shape,cub,strat", REORDER, ids=["local", "dilated_hw", "mixed", "whole"])
def test_cuboid_reorder_matches_jax(shape, cub, strat):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jct.cuboid_reorder(jnp.asarray(x), cub, strat))
    got = tct.cuboid_reorder(torch.from_numpy(x), cub, strat)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tct.cuboid_reorder_reverse(got, cub, strat, shape[1:4])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(tct._np_cuboid_reorder(x, cub, strat), jct._np_cuboid_reorder(x, cub, strat))


SELF_MASKS = [((4, 6, 10), (2, 4, 4), (0, 0, 0), ("l", "l", "l"), "ignore"),
              ((4, 8, 8), (2, 4, 4), (1, 2, 2), ("l", "l", "l"), "ignore"),
              ((4, 6, 10), (2, 4, 4), (1, 2, 2), ("l", "l", "l"), "ignore"),
              ((4, 6, 10), (2, 4, 4), (1, 2, 2), ("l", "l", "l"), "zeros"),
              ((4, 8, 8), (1, 4, 4), (0, 0, 0), ("l", "d", "d"), "ignore"),
              ((4, 8, 8), (4, 1, 1), (0, 0, 0), ("l", "l", "l"), "ignore")]
CROSS_MASKS = [(4, 3, 6, 10, 1, (2, 2), (0, 0), ("l", "l", "l"), "ignore"),
               (5, 3, 8, 8, 2, (2, 2), (1, 1), ("l", "l", "l"), "ignore"),
               (4, 4, 8, 8, 1, (4, 4), (2, 2), ("d", "d", "d"), "zeros"),
               (4, 4, 8, 8, 1, (1, 1), (0, 0), ("l", "l", "l"), "ignore")]


@pytest.mark.parametrize("args", SELF_MASKS, ids=["padded", "shifted", "padded_shifted", "zeros_pad", "dilated",
                                                   "none"])
def test_self_attention_masks_match_jax(args):
    want, got = jct._self_attn_mask(*args), tct._self_attn_mask(*args)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", CROSS_MASKS, ids=["padded", "temporal_shifted", "dilated_zeros", "none"])
def test_cross_attention_masks_match_jax(args):
    want, got = jct._cross_attn_mask(*args), tct._cross_attn_mask(*args)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cub", [(2, 4, 4), (4, 1, 1), (1, 3, 5)])
def test_relative_position_indices_match_jax(cub):
    np.testing.assert_array_equal(tct._relpos_index_self(cub), jct._relpos_index_self(cub))
    hw = cub[1:]
    np.testing.assert_array_equal(tct._relpos_index_cross(cub[0], 3, hw, 7), jct._relpos_index_cross(cub[0], 3, hw, 7))


# ------------------------------------------------------------ attention --

def _mha_inputs(case):
    rng = np.random.default_rng(1)
    B, nc, L, C, heads, G = 2, 3, 6, 8, 2, 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = dict(q=f(B, nc, L, C), k=f(B, nc, L, C), v=f(B, nc, L, C))
    kw = {}
    if "mask" in case:
        mask = rng.random((nc, L, L)) < 0.6
        mask[1, 2] = False  # a fully masked query row
        kw["mask"] = mask
    if "bias" in case:
        kw["bias"] = f(heads, L, L)
    if "global" in case:
        kw["extra_kv"] = (f(B, G, C), f(B, G, C))
    if "l2g" in case:
        kw["l2g_q"] = f(B, nc, L, C)
    return args, kw, heads


@pytest.mark.parametrize("case", ["plain", "mask", "mask_bias", "mask_bias_global", "global_l2g"])
def test_masked_mha_matches_jax(case):
    args, kw, heads = _mha_inputs(case)
    conv = lambda v, f: tuple(f(a) for a in v) if isinstance(v, tuple) else f(v)  # noqa: E731
    want = np.asarray(jct._masked_mha(*map(jnp.asarray, args.values()), heads,
                                      **{k: conv(v, jnp.asarray) for k, v in kw.items()}))
    got = tct._masked_mha(*map(torch.from_numpy, args.values()), heads,
                          **{k: conv(v, torch.from_numpy) for k, v in kw.items()})
    close(got, want, 1e-6)
    if "mask" in case:  # the fully masked row: zeros from its local keys (the global keys stay unmasked)
        assert not got[:, 1, 2].abs().sum() if "global" not in case else True


ATTN = [dict(shape=(2, 4, 8, 8, 8), cub=(4, 1, 1), shift=(0, 0, 0), strat=("l", "l", "l"), pad="ignore", g=2),
        dict(shape=(1, 4, 8, 8, 8), cub=(2, 4, 4), shift=(1, 2, 2), strat=("l", "l", "l"), pad="ignore", g=0),
        dict(shape=(1, 3, 6, 10, 8), cub=(2, 4, 4), shift=(0, 0, 0), strat=("l", "l", "l"), pad="ignore", g=2,
             sep=True),
        dict(shape=(1, 4, 8, 8, 8), cub=(1, 4, 4), shift=(0, 0, 0), strat=("d", "d", "d"), pad="zeros", g=0)]


@pytest.mark.parametrize("cfg", ATTN, ids=["axial_t_global", "shifted_local", "ignore_padding_separate_global",
                                           "dilated_zeros"])
def test_self_attention_pattern_matches_jax(cfg):
    use_g = cfg["g"] > 0
    kw = dict(use_global=use_g, padding_type=cfg["pad"], separate_global_qkv=cfg.get("sep", False),
              use_global_self_attn=cfg.get("sep", False))
    with numpy_init():
        jm = jct.CuboidSelfAttention(8, 2, cfg["cub"], cfg["shift"], cfg["strat"], rngs=Rngs(3), **kw)
    tm = tct.CuboidSelfAttention(8, 2, cfg["cub"], cfg["shift"], cfg["strat"], generator=torch.Generator(), **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    rng = np.random.default_rng(4)
    x = rng.standard_normal(cfg["shape"]).astype(np.float32)
    g = rng.standard_normal((cfg["shape"][0], cfg["g"], 8)).astype(np.float32) if use_g else None
    params = jm.param_tree()

    def fwd(p, x, g):
        with jm.bind(p, {}):
            return jm(x, g)

    jy, jg = fast_call(fwd, params, jnp.asarray(x), None if g is None else jnp.asarray(g))
    ty, tg = tm(torch.from_numpy(x), None if g is None else torch.from_numpy(g))
    close(ty, np.asarray(jy), 1e-5)
    if use_g:
        close(tg, np.asarray(jg), 1e-5)


def test_cross_1x1_attention_matches_jax():
    with numpy_init():
        jm = jct.CuboidCrossAttention(8, 2, (1, 1), max_temporal_relative=7, use_global=True, rngs=Rngs(5))
    tm = tct.CuboidCrossAttention(8, 2, (1, 1), max_temporal_relative=7, use_global=True, generator=torch.Generator())
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    rng = np.random.default_rng(6)
    x, mem, g = (rng.standard_normal(s).astype(np.float32) for s in ((2, 3, 4, 6, 8), (2, 4, 4, 6, 8), (2, 2, 8)))

    def fwd(p, *a):
        with jm.bind(p, {}):
            return jm(*a)

    want = np.asarray(fast_call(fwd, jm.param_tree(), jnp.asarray(x), jnp.asarray(mem), jnp.asarray(g)))
    close(tm(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(g)), want, 1e-5)


# ---------------------------------------------------------------- model --

MODEL = dict(base_units=8, num_heads=2, enc_depth=(1,), dec_depth=(1,))
PATTERNS = {0: dict(self_pattern="divided_st", cross_self_pattern="divided_st", cross_pattern="cross_2x2"),
            2: dict(self_pattern="divided_st", cross_self_pattern="divided_st", cross_pattern="cross_1x1")}


@pytest.mark.parametrize("num_global", [0, 2])
def test_cuboid_transformer_matches_jax(num_global):
    shapes = ((4, 8, 8, 1), (2, 8, 8, 1))
    kw = dict(MODEL, num_global_vectors=num_global, **PATTERNS[num_global])
    with numpy_init():
        jm = jct.CuboidTransformer(("x",), ("y",), *shapes, rngs=Rngs(7), **kw)
    tm = tct.CuboidTransformer(("x",), ("y",), *shapes, device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    check_arch(jm, tm, {"x": np.random.default_rng(8).standard_normal((2,) + shapes[0]).astype(np.float32)})


# ------------------------------------------------------------- datasets --

def test_enso_and_sevir_windows_are_jax_bitwise():
    for jcls, tcls, kw in ((jdd.ENSODataset, tdd.ENSODataset, dict(in_len=6, out_len=4, lat=16, lon=32)),
                           (jdd.ExtMoEENSODataset, tdd.ExtMoEENSODataset, dict(in_len=12, out_len=14, stride=3)),
                           (jdd.SEVIRDataset, tdd.SEVIRDataset, dict(in_len=8, out_len=6, img_height=32,
                                                                     img_width=24, num_events=3))):
        j, t = jcls(("x",), ("y",), **kw), tcls(("x",), ("y",), **kw)
        assert len(j) == len(t) > 0
        for a, b in ((j.input["x"], t.input["x"]), (j.label["y"], t.label["y"])):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    d = np.random.default_rng(9).standard_normal((4, 36, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdd._cmip_fold(d), jdd._cmip_fold(d))


def test_sevir_skill_scores_match_jax():
    rng = np.random.default_rng(10)
    raw = rng.uniform(0, 255, (2, 3, 8, 8, 1)).astype(np.float32)
    pred = (raw + rng.normal(0, 30, raw.shape).astype(np.float32)) * tsevir._VIL_SCALE + 0
    lab = (raw / 47.54 - 33.44 / 47.54).astype(np.float32)
    pred = (pred - 33.44 / 47.54).astype(np.float32)
    want = jsevir.sevir_skill_scores({"vil": jnp.asarray(pred)}, {"vil": jnp.asarray(lab)})
    got = tsevir.sevir_skill_scores({"vil": torch.from_numpy(pred)}, {"vil": torch.from_numpy(lab)})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, atol=1e-6, err_msg=k)


# ------------------------------------------------------------- examples --

# the examples' networks cut to one level of base 8, one full-volume attention layer a block and no global
# vectors (the axial pattern and the global vectors have their own tests above), no dropout
CUT = dict(base_units=8, enc_depth=(1,), dec_depth=(1,), num_global_vectors=0, self_pattern="full",
           cross_self_pattern="full", attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0)


@pytest.fixture
def cut_jax_cuboid(monkeypatch):
    orig = psci.arch.CuboidTransformer
    monkeypatch.setattr(psci.arch, "CuboidTransformer", lambda *a, **kw: orig(*a, **{**kw, **CUT}))


def test_enso_example_three_steps_match_jax(tmp_path, cut_jax_cuboid, monkeypatch):
    shapes = dict(in_len=4, out_len=2, lat=8, lon=16)
    for k, v in shapes.items():
        monkeypatch.setattr(jenso, k.upper(), v)
    with numpy_init():
        js = jenso.build_solver(epochs=2, output_dir=str(tmp_path / "jax"))
    cut = {k: v for k, v in CUT.items() if not k.endswith("_drop")}
    ts = tenso.make_solver(epochs=2, output_dir=None, device="cpu", drop=0.0, **shapes, **cut)
    three_steps(js, ts)
