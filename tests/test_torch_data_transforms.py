"""The port's data transforms against paddlescience_tpu on the CPU: every
sample transform (``data/process/transform.py``), ``build_transforms``,
the batch transforms (``FunctionalBatchTransform``,
``build_batch_transforms``), and datasets and
loaders built from ``transforms`` and ``batch_transforms`` configs: the
same numpy batches in, equal numpy batches out (the same numpy
arithmetic). The solver stages a transformed full-batch dataset anew
each step, as the JAX solver takes a fresh batch from it."""

import numpy as np
import pytest
import torch

import paddlescience_tpu.data as jdata
import paddlescience_torch.data as tdata
from paddlescience_tpu.data.process import transform as jtr
from paddlescience_torch.data.process import transform as ttr


def batch(seed=0, n=6):
    rng = np.random.default_rng(seed)
    inp = {"x": rng.uniform(0.1, 2, (n, 2, 5, 7)).astype(np.float32), "t": rng.uniform(0, 1, (n, 1)).astype(np.float32)}
    lab = {"u": rng.uniform(0.1, 3, (n, 2, 5, 7)).astype(np.float32)}
    return inp, lab, {"u": np.ones((n, 1), np.float32)}


def same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def swap(inp, lab, wgt):
    return {**inp, "x": inp["x"] * 2 - 1}, lab, wgt


MEAN = np.array([[[0.5]], [[1.0]]], np.float32)
TRANSFORMS = [
    ("Translate", dict(offset={"x": 1.5, "missing": 3.0})),
    ("Scale", dict(scale={"x": 0.25, "t": 10.0})),
    ("Normalize", dict(mean=MEAN, std=np.float32(2.0))),
    ("Normalize", dict(mean=0.3, std=1.7, apply_keys=("label",))),
    ("Log1p", dict(scale=2.0)),
    ("Log1p", dict(apply_keys=("input",))),
    ("CropData", dict(xmin=(1, 2), xmax=(4, 6))),
    ("CropData", dict(xmin=(0, 1), xmax=(5, 3), apply_keys=("label",))),
    ("SqueezeData", dict()),
    ("FunctionalTransform", dict(transform_func=swap)),
]


@pytest.mark.parametrize("name,kw", TRANSFORMS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(TRANSFORMS)])
def test_each_transform_matches_jax(name, kw):
    b = batch()
    if name == "SqueezeData":
        b = ({**b[0], "x": b[0]["x"].reshape(2, 3, 2, 5, 7)}, b[1], b[2])
    same(getattr(ttr, name)(**kw)(*b), getattr(jtr, name)(**kw)(*b))


def test_build_transforms_matches_jax():
    cfg = [{"name": "Scale", "scale": {"x": 3.0}}, {"name": "Log1p", "scale": 1.5},
           {"name": "CropData", "xmin": (0, 0), "xmax": (3, 3)}, {"name": "Normalize", "mean": 0.1, "std": 0.9}]
    t, j = ttr.build_transforms(cfg), jtr.build_transforms(cfg)
    assert isinstance(t, ttr.Compose) and len(t.transforms) == 4
    same(t(*batch(1)), j(*batch(1)))
    assert cfg[0] == {"name": "Scale", "scale": {"x": 3.0}}  # the config is left as it was
    assert ttr.build_transforms(None).transforms == []
    with pytest.raises(ValueError):
        ttr.build_transforms([{"name": "Rotate"}])


def test_batch_transforms_match_jax():
    def shift(inp, lab, wgt):
        return {k: v + 1 for k, v in inp.items()}, lab, wgt

    def double(inp, lab, wgt):
        return inp, {k: 2 * v for k, v in lab.items()}, wgt

    cfg = [{"FunctionalBatchTransform": {"transform_func": shift}}, {"FunctionalBatchTransform": {"transform_func": double}}]
    same(tdata.build_batch_transforms(cfg)(*batch(2)), jdata.build_batch_transforms(cfg)(*batch(2)))
    assert tdata.build_batch_transforms(None) is None and tdata.build_batch_transforms(shift) is shift
    with pytest.raises(ValueError):
        tdata.build_batch_transforms([{"Mixup": {}}])


def test_dataset_and_loader_from_configs_give_jax_batches():
    inp, lab, _ = batch(3, n=10)

    def flip(i, l, w):
        return {k: v[..., ::-1] for k, v in i.items()}, l, w

    ds_cfg = {"name": "NamedArrayDataset", "input": inp, "label": lab,
              "transforms": [{"name": "Scale", "scale": {"x": 2.0}}, {"name": "Normalize", "mean": 1.0, "std": 0.5}]}
    dl_cfg = {"batch_size": 4, "sampler": {"shuffle": False, "drop_last": False},
              "batch_transforms": [{"FunctionalBatchTransform": {"transform_func": flip}}]}
    tl = tdata.build_dataloader(tdata.build_dataset(ds_cfg), dl_cfg)
    jl = jdata.build_dataloader(jdata.build_dataset(ds_cfg), dl_cfg)
    assert len(tl) == len(jl) == 3
    for got, want, _ in zip(iter(tl), iter(jl), range(4)):
        same(got, want)
    # a callable transforms entry is kept; the full-batch and generator sets apply theirs too
    same(tdata.build_dataset({**ds_cfg, "transforms": swap})[np.arange(3)],
         jdata.build_dataset({**ds_cfg, "transforms": swap})[np.arange(3)])
    full = {"name": "IterableNamedArrayDataset", "input": inp, "label": lab, "transforms": swap}
    same(next(iter(tdata.build_dataset(full))), next(iter(jdata.build_dataset(full))))
    gen = {"name": "ContinuousNamedArrayDataset", "input": lambda: dict(inp), "label": lambda i: dict(lab),
           "transforms": ttr.build_transforms([{"name": "Log1p"}])}
    same(next(iter(tdata.build_dataset(gen))), next(iter(jdata.build_dataset(gen))))


def test_solver_draws_a_transformed_full_batch_each_step():
    from paddlescience_torch.arch.mlp import MLP
    from paddlescience_torch.constraint.constraints import SupervisedConstraint
    from paddlescience_torch.loss.losses import MSELoss
    from paddlescience_torch.optimizer.optimizer import Adam
    from paddlescience_torch.solver.solver import Solver

    calls = []

    def noisy(i, l, w):
        calls.append(1)
        return {"x": i["x"] + len(calls)}, l, w

    x = np.linspace(0, 1, 8, dtype=np.float32)[:, None]
    model = MLP(("x",), ("u",), 2, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    sup = SupervisedConstraint({"dataset": {"name": "IterableNamedArrayDataset", "input": {"x": x},
                                            "label": {"u": x ** 2}, "transforms": noisy}}, MSELoss("mean"), name="Sup")
    solver = Solver(model, {"Sup": sup}, None, Adam(1e-3)(model), epochs=1, iters_per_epoch=3, device="cpu")
    assert "Sup" in solver._indexed and not solver._static_batches and not solver._all_constraints_static()
    solver.train_steps(3)
    assert len(calls) == 3
