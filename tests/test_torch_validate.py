"""The port's eval side against paddlescience_tpu on the CPU: the ETDRK4
reference solution of the Allen-Cahn example, the metrics, the indexed
dataset and its batch loader, the validators, ``Solver.eval`` with the
Allen-Cahn ``u_validator`` and ``Solver.predict``.

The eval and predict tests build the JAX example itself
(``examples/allen_cahn.py``, its MLP cut to 2 x 32 with Fourier 32, its
reference solution the port's, which is bitwise the same) and the port's
``build_solver`` at the same sizes, and load the JAX weights into the
port. Tolerances: the solution bitwise; metrics 1e-6 relative (float32,
other summation orders); eval (L2Rel and the validator's loss over 98304
points) 1e-5; predicted fields 1e-6, the residual through the jet 1e-4 as
the other residual tests.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu import data as jdata
from paddlescience_tpu import metric as jmetric
from paddlescience_tpu import validate as jvalidate
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_torch import data as tdata
from paddlescience_torch import metric as tmetric
from paddlescience_torch import validate as tvalidate
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.equation import AllenCahn as TAllenCahn
from paddlescience_torch.examples import allen_cahn as tallen_cahn
from paddlescience_torch.loss import MSELoss as TMSELoss
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import allen_cahn as jallen_cahn  # noqa: E402  (the JAX example)

CUT = dict(num_layers=2, hidden_size=32, fourier_dim=32)


@pytest.fixture(autouse=True)
def _float32_and_paths(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PSCI_AUTOTUNE", "0")
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The port's reference solution, solved once into a temporary cache."""
    return tallen_cahn.get_reference_solution(str(tmp_path_factory.mktemp("ref") / "allen_cahn_ref.npz"))


def _close(got, ref, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


# ----------------------------------------------------- reference solution --


@pytest.mark.parametrize("kw", [dict(nx=64, nt=11, t_max=0.1), dict(nx=128, nt=21, t_max=0.05, eps2=1e-3), {}],
                         ids=["nx64", "nx128_eps", "default"])
def test_etdrk4_solution_is_bitwise_the_jax_examples(kw):
    got = tallen_cahn.solve_allen_cahn_spectral(**kw)
    ref = jallen_cahn.solve_allen_cahn_spectral(**kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    if not kw:  # the example's grid: the initial condition is its row 0
        t_ic, x_ic, u_ic = tallen_cahn.ic_data(512)
        np.testing.assert_array_equal(u_ic[:, 0], got[2][0])
        np.testing.assert_array_equal(x_ic[:, 0], got[1])
        assert (t_ic == got[0][0]).all()


def test_reference_cache_is_written_once_and_read_back(tmp_path, monkeypatch, reference):
    path = str(tmp_path / "sub" / "ref.npz")
    monkeypatch.setattr(tallen_cahn, "solve_allen_cahn_spectral", lambda: reference)
    first = tallen_cahn.get_reference_solution(path)
    monkeypatch.setattr(tallen_cahn, "solve_allen_cahn_spectral", lambda: pytest.fail("solved twice"))
    second = tallen_cahn.get_reference_solution(path)
    assert os.listdir(tmp_path / "sub") == ["ref.npz"]
    for a, b, c in zip(first, second, reference):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


# ------------------------------------------------------------------ metrics --


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    out = {"u": rng.standard_normal(shape).astype(np.float32), "v": rng.standard_normal(shape).astype(np.float32)}
    lab = {k: (v + 0.3 * rng.standard_normal(shape)).astype(np.float32) for k, v in out.items()}
    return out, lab


METRICS = {
    "L2Rel": (lambda m: m.L2Rel(), (64, 1)),
    "MeanL2Rel": (lambda m: m.MeanL2Rel(), (16, 5)),
    "MeanL2Rel_keep": (lambda m: m.MeanL2Rel(keep_batch=True), (16, 5)),
    "MAE": (lambda m: m.MAE(), (16, 5)),
    "MAE_keep": (lambda m: m.MAE(keep_batch=True), (16, 2, 3)),
    "MSE": (lambda m: m.MSE(), (16, 5)),
    "MSE_keep": (lambda m: m.MSE(keep_batch=True), (16, 2, 3)),
    "RMSE": (lambda m: m.RMSE(), (16, 5)),
    "MaxAE": (lambda m: m.MaxAE(), (16, 5)),
    "LatitudeWeightedACC": (lambda m: m.LatitudeWeightedACC(6), (3, 2, 6, 8)),
    "LatitudeWeightedACC_mean_keep": (
        lambda m: m.LatitudeWeightedACC(6, keep_batch=True, mean={"u": np.full((2, 6, 8), 0.2, np.float32)}),
        (3, 2, 6, 8)),
    "LatitudeWeightedRMSE": (lambda m: m.LatitudeWeightedRMSE(6), (3, 2, 6, 8)),
    "LatitudeWeightedRMSE_std_keep": (
        lambda m: m.LatitudeWeightedRMSE(6, keep_batch=True, std={"v": np.float32(1.7)}), (3, 2, 6, 8)),
    "FunctionalMetric": (lambda m: m.FunctionalMetric(lambda o, l: {"s": (o["u"] * l["v"]).sum()}), (16, 5)),
}


@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_jax(name):
    make, shape = METRICS[name]
    out, lab = _fields(shape)
    j = make(jmetric)({k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in lab.items()})
    t = make(tmetric)({k: torch.from_numpy(v) for k, v in out.items()}, {k: torch.from_numpy(v) for k, v in lab.items()})
    assert set(t) == set(j)
    for key in j:
        _close(t[key], j[key], 1e-6)


def test_l2rel_of_a_zero_label_is_the_norm_over_1e_12():
    zero = {"u": torch.zeros(4, 1)}
    got = tmetric.L2Rel()({"u": torch.full((4, 1), 1e-12)}, zero)["u"]
    ref = jmetric.L2Rel()({"u": jnp.full((4, 1), 1e-12)}, {"u": jnp.zeros((4, 1))})["u"]
    _close(got, ref, 1e-6)


def test_build_metric_matches_jax():
    cfg = [{"name": "L2Rel"}, {"name": "MSE", "keep_batch": True}]
    j, t = jmetric.build_metric(cfg), tmetric.build_metric(cfg)
    assert list(t) == list(j) == ["L2Rel", "MSE"]
    assert isinstance(t["MSE"], tmetric.MSE) and t["MSE"].keep_batch
    assert isinstance(tmetric.build_metric({"name": "MaxAE"}), tmetric.MaxAE)
    for bad in ({"name": "Nope"}, {"name": "build_metric"}):
        with pytest.raises(ValueError, match="unknown metric"):
            tmetric.build_metric(bad)


# ------------------------------------------------------- dataset + loader --


def _dataset(mod, n):
    x = np.arange(n, dtype=np.float32).reshape(n, 1)
    return mod.NamedArrayDataset({"x": x, "y": -x}, {"u": 2 * x}, {"u": np.ones_like(x)})


@pytest.mark.parametrize("n,batch_size,drop_last", [(20, 8, True), (20, 8, False), (24, 8, True), (24, 8, False),
                                                     (5, 8, True), (5, 8, False), (20, None, True)])
def test_batches_match_jax(n, batch_size, drop_last):
    """Two passes of a loader without shuffling: the same batches as the
    JAX loader's, the short last one included where drop_last is False."""
    jl = jdata.BatchLoader(_dataset(jdata, n), batch_size, shuffle=False, drop_last=drop_last, num_replicas=1, rank=0)
    tl = tdata.BatchLoader(_dataset(tdata, n), batch_size, shuffle=False, drop_last=drop_last)
    assert len(tl) == len(jl)
    ji, ti = iter(jl), iter(tl)
    for _ in range(2 * len(jl)):
        for jp, tp in zip(next(ji), next(ti)):
            assert set(tp) == set(jp)
            for k in jp:
                np.testing.assert_array_equal(tp[k], jp[k])


def test_shuffled_passes_are_permutations_from_the_generator():
    n, bs = 23, 5
    loader = lambda seed: tdata.BatchLoader(_dataset(tdata, n), bs, shuffle=True, drop_last=False,
                                            generator=torch.Generator().manual_seed(seed))
    a, b, c = iter(loader(1)), iter(loader(1)), iter(loader(2))
    passes = []
    for _ in range(2):
        got = [next(a)[0]["x"][:, 0] for _ in range(len(loader(1)))]
        assert [len(g) for g in got] == [5, 5, 5, 5, 3]
        passes.append(np.concatenate(got))
        np.testing.assert_array_equal(np.sort(passes[-1]), np.arange(n))
        again = np.concatenate([next(b)[0]["x"][:, 0] for _ in range(5)])
        np.testing.assert_array_equal(again, passes[-1])
    assert not np.array_equal(passes[0], passes[1])
    assert not np.array_equal(np.concatenate([next(c)[0]["x"][:, 0] for _ in range(5)]), passes[0])


def test_build_dataset_and_dataloader_match_jax():
    x = np.linspace(0, 1, 30, dtype=np.float32).reshape(-1, 1)
    cfg = {"name": "NamedArrayDataset", "input": {"x": x}, "label": {"u": x ** 2}}
    jd, td = jdata.build_dataset(cfg), tdata.build_dataset(cfg)
    assert isinstance(td, tdata.NamedArrayDataset) and len(td) == len(jd) == 30
    dl_cfg = {"batch_size": 7, "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}}
    jl, tl = jdata.build_dataloader(jd, dl_cfg), tdata.build_dataloader(td, dl_cfg)
    assert len(tl) == len(jl) == 5 and not tl.drop_last
    np.testing.assert_array_equal(next(iter(tl))[1]["u"], next(iter(jl))[1]["u"])
    full = tdata.build_dataset({"name": "IterableNamedArrayDataset", "input": {"x": x}})
    assert len(tdata.build_dataloader(full, {})) == 1 and next(iter(tdata.BatchLoader(full)))[0]["x"] is full.input["x"]
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.build_dataset({"name": "MatDataset"})
    # a transforms config and a batch_transforms config give JAX's batches
    tcfg = {**cfg, "transforms": [{"name": "Scale", "scale": {"x": 2.0}}]}
    np.testing.assert_array_equal(tdata.build_dataset(tcfg)[np.arange(3)][0]["x"],
                                  jdata.build_dataset(tcfg)[np.arange(3)][0]["x"])
    bt = {"batch_size": 7, "batch_transforms": [
        {"FunctionalBatchTransform": {"transform_func": lambda i, lab, w: ({"x": i["x"] + 1}, lab, w)}}]}
    np.testing.assert_array_equal(next(iter(tdata.build_dataloader(td, bt)))[0]["x"],
                                  next(iter(jdata.build_dataloader(jd, bt)))[0]["x"])
    with pytest.raises(TypeError, match="no host loader"):
        next(iter(tdata.BatchLoader(tdata.DeviceSampledDataset(lambda g: None))))


# -------------------------------------------------------------- validators --


def _sup_cfg(n=50, batch_size=16):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    return {"dataset": {"name": "NamedArrayDataset", "input": {"x": x}, "label": {"u": np.sin(3 * x)}},
            "batch_size": batch_size}


def test_supervised_validator_matches_jax():
    jv = jvalidate.SupervisedValidator(_sup_cfg(), psci.loss.MSELoss("mean"), metric={"L2Rel": jmetric.L2Rel()})
    tv = tvalidate.SupervisedValidator(_sup_cfg(), TMSELoss("mean"), metric={"L2Rel": tmetric.L2Rel()})
    assert (tv.name, tv.input_keys, tv.output_keys, len(tv.data_loader)) == (
        jv.name, jv.input_keys, jv.output_keys, len(jv.data_loader)) == ("SupValidator", ("x",), ("u",), 3)
    assert str(tv) == str(jv)
    out = {"u": torch.ones(2, 1), "x": torch.zeros(2, 1)}
    assert tv.output_expr["u"](out) is out["u"]
    assert tvalidate.SupervisedValidator(_sup_cfg(), TMSELoss(), output_expr={}).output_expr == {}


def test_build_validator_matches_jax():
    """A shared dataloader block merged into each item's, loss and metric
    sub-configs built."""
    cfg = {"dataloader": {"batch_size": 8},
           "content": [{"SupervisedValidator": {
               "dataloader": {"dataset": _sup_cfg()["dataset"]},
               "loss": {"name": "MSELoss", "reduction": "sum"},
               "metric": {"MSE": {"name": "MSE"}}, "name": "sup"}}]}
    j, t = jvalidate.build_validator(cfg), tvalidate.build_validator(cfg)
    assert list(t) == list(j) == ["sup"]
    assert len(t["sup"].data_loader) == len(j["sup"].data_loader) == 6
    assert t["sup"].loss.reduction == "sum" and isinstance(t["sup"].metric["MSE"], tmetric.MSE)
    assert tvalidate.build_validator(None) is None


# ------------------------------------------------------------ eval, predict --


def _solvers(monkeypatch, tmp_path, reference, **kw):
    """The JAX example's solver cut to MLP 2 x 32 (Fourier 32) and the
    port's, the JAX weights loaded into the port."""
    mlp = psci.arch.MLP

    def cut_mlp(i, o, num_layers, hidden_size, fourier=None, **rest):
        return mlp(i, o, num_layers=CUT["num_layers"], hidden_size=CUT["hidden_size"],
                   fourier={**fourier, "dim": CUT["fourier_dim"]}, **rest)

    monkeypatch.setattr(psci.arch, "MLP", cut_mlp)
    monkeypatch.setattr(jallen_cahn, "get_reference_solution", lambda: reference)
    js, _ = jallen_cahn.build_solver(batch_size=256, output_dir=str(tmp_path / "jax"), **kw)
    ts = tallen_cahn.build_solver(batch_size=256, output_dir=str(tmp_path / "port"), deriv="jet_pallas_full",
                                  device="cpu", **CUT, **kw)
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]),
                    jax.tree.map(np.asarray, js.state["rest"]))
    return js, ts


class _LossRecorder:
    def __init__(self, loss):
        self.loss, self.values = loss, []

    def __call__(self, out, lab, wgt):
        res = self.loss(out, lab, wgt)
        self.values.append(float(sum(np.asarray(v) if not isinstance(v, torch.Tensor) else v.item()
                                     for v in res.values())))
        return res


def test_allen_cahn_eval_matches_jax(monkeypatch, tmp_path, reference, tmp_path_factory):
    monkeypatch.setattr(tallen_cahn, "get_reference_solution", lambda path=None: reference)
    js, ts = _solvers(monkeypatch, tmp_path, reference)
    jv, tv = js.validator["u_validator"], ts.validator["u_validator"]
    assert len(tv.data_loader) == len(jv.data_loader) == 6  # 201 x 512 points, batches of 16384, the short one dropped
    for part in ("input", "label"):
        for k, arr in getattr(jv.dataset, part).items():
            np.testing.assert_array_equal(getattr(tv.dataset, part)[k], arr)
    jv.loss, tv.loss = _LossRecorder(jv.loss), _LossRecorder(tv.loss)
    j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert set(t_group) == {"u_validator"} and set(t_group["u_validator"]) == set(j_group["u_validator"]) == {"L2Rel.u"}
    _close(t_metric, j_metric, 1e-5)
    _close(t_group["u_validator"]["L2Rel.u"], j_group["u_validator"]["L2Rel.u"], 1e-5)
    assert len(tv.loss.values) == len(jv.loss.values) == 6
    _close(np.mean(tv.loss.values), np.mean(jv.loss.values), 1e-5)
    # per batch, averaged: the same under compute_metric_by_batch
    js.compute_metric_by_batch = ts.compute_metric_by_batch = True
    _close(ts.eval()[0], js.eval()[0], 1e-5)


def test_eval_without_a_validator_raises(monkeypatch, tmp_path, reference):
    ts = tallen_cahn.build_solver(batch_size=64, with_validator=False, device="cpu", output_dir=None, **CUT)
    with pytest.raises(ValueError, match="no validator"):
        ts.eval()


@pytest.mark.parametrize("batch_size", [1000, None, 64])
def test_predict_matches_jax(monkeypatch, tmp_path, reference, batch_size):
    """The model's outputs (and the AllenCahn residual through the jet) on
    2500 points, with a short last batch where batch_size leaves one."""
    monkeypatch.setattr(tallen_cahn, "get_reference_solution", lambda path=None: reference)
    js, ts = _solvers(monkeypatch, tmp_path, reference, with_validator=False)
    rng = np.random.default_rng(11)
    n = 2500 if batch_size != 64 else 200
    inp = {"t": rng.uniform(0, 1, (n, 1)).astype(np.float32), "x": rng.uniform(-1, 1, (n, 1)).astype(np.float32)}
    j = js.predict(inp, batch_size=batch_size, return_numpy=True)
    t = ts.predict(inp, batch_size=batch_size, return_numpy=True)
    assert set(t) == set(j) == {"u"} and isinstance(t["u"], np.ndarray)
    _close(t["u"], j["u"], 1e-6)
    tt = ts.predict(inp, batch_size=batch_size)
    assert isinstance(tt["u"], torch.Tensor) and tt["u"].shape == (n, 1)
    with jpath.override(jpath.CANDIDATES["jet"]):
        jr = js.predict(inp, expr_dict=psci.equation.AllenCahn(eps=0.01).equations, batch_size=batch_size,
                        return_numpy=True)
    tr = ts.predict(inp, expr_dict=TAllenCahn(eps=0.01).equations, batch_size=batch_size, return_numpy=True)
    _close(tr["allen_cahn"], jr["allen_cahn"], 1e-4)
