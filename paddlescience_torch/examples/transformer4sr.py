"""Transformer for symbolic regression on the port (counterpart of
``examples/transformer4sr.py``).

An encoder-decoder Transformer (``arch/misc_nets.py``: d_model 128, 4
heads, 2 layers each side, d_ff 512) maps a quantised (x, y) table (24
points, 64 bins) to the prefix tokens of the expression that made it
(vocabulary PAD, SOS, add, mul, sin, cos, x, c; 8 tokens with SOS first).
The expressions are the JAX example's random ones of depth <= 2
(:func:`make_dataset`, a numpy copy bitwise equal to it: 2048 training
and 256 test tables). Loss: the teacher-forced next-token cross-entropy
over non-PAD targets; Adam on a cosine schedule with a warmup of a tenth
of the epochs (5e-4); shuffled batches of 64, 10 steps an epoch; the
validator's next-token accuracy.

Run on the GPU: ``python -m paddlescience_torch.examples.transformer4sr
[epochs]`` (each epoch one CUDA graph of 10 steps).
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.misc_nets import Transformer
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import FunctionalLoss
from paddlescience_torch.metric import FunctionalMetric
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["build_solver", "make_dataset", "sample_expr", "xent", "token_acc"]

SEED = 42  # the JAX example's set_random_seed

VOCAB = ["PAD", "SOS", "add", "mul", "sin", "cos", "x", "c"]
PAD, SOS = 0, 1
TGT_LEN = 8
N_POINTS = 24
N_BINS = 64


def sample_expr(rng):
    """A random prefix expression of depth <= 2: (tokens, fn(x, c))."""
    def leaf():
        if rng.random() < 0.7:
            return (["x"], lambda x, c: x)
        return (["c"], lambda x, c: np.full_like(x, c))

    def unary(sub):
        op = rng.choice(["sin", "cos"])
        t, f = sub
        g = np.sin if op == "sin" else np.cos
        return ([op] + t, lambda x, c, f=f, g=g: g(f(x, c)))

    def binary(a, b):
        op = rng.choice(["add", "mul"])
        ta, fa = a
        tb, fb = b
        h = (lambda u, v: u + v) if op == "add" else (lambda u, v: u * v)
        return ([op] + ta + tb, lambda x, c, fa=fa, fb=fb, h=h: h(fa(x, c), fb(x, c)))

    r = rng.random()
    if r < 0.3:
        return unary(leaf())
    if r < 0.7:
        return binary(leaf(), leaf())
    return binary(unary(leaf()), leaf())


def make_dataset(n: int, seed: int = 0):
    """``n`` (source tokens (n, 24), target tokens (n, 8)) pairs."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2, 2, N_POINTS).astype("float32")
    src, tgt = [], []
    for _ in range(n):
        tokens, fn = sample_expr(rng)
        cval = float(rng.uniform(-2, 2))
        y = np.clip(fn(xs, cval), -4, 4)
        src.append(np.clip(((y + 4) / 8 * (N_BINS - 1)).astype(np.int64), 0, N_BINS - 1))
        ids = [VOCAB.index(t) for t in tokens][: TGT_LEN - 1]
        tgt.append([SOS] + ids + [PAD] * (TGT_LEN - 1 - len(ids)))
    return np.stack(src), np.asarray(tgt, np.int64)


def xent(out, label, weight=None):
    """Mean cross-entropy of tokens 1..L from their prefixes, PAD masked."""
    logits = out["logits"][:, :-1]
    targets = label["tokens"][:, 1:].to(torch.int64)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
    mask = (targets != PAD).to(torch.float32)
    return {"xent": torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)}


def token_acc(out, label):
    pred = torch.argmax(out["logits"][:, :-1], dim=-1)
    targets = label["tokens"][:, 1:].to(torch.int64)
    mask = (targets != PAD).to(torch.float32)
    return {"token_acc": torch.sum((pred == targets).to(torch.float32) * mask) / torch.clamp(torch.sum(mask), min=1.0)}


def build_solver(epochs: int = 50, iters_per_epoch: int = 10, output_dir: Optional[str] = "./outputs_transformer4sr",
                 n_train: int = 2048, n_test: int = 256, batch_size: int = 64, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 2, learning_rate: float = 5e-4, *, device: DeviceLike = None) -> Solver:
    """The symbolic-regression solver of the JAX example (its data bitwise;
    the weights from a ``torch.Generator`` seeded with ``SEED``)."""
    device = resolve_device(device)
    np.random.seed(SEED)
    random.seed(SEED)
    src_tr, tgt_tr = make_dataset(n_train, seed=0)
    src_te, tgt_te = make_dataset(n_test, seed=1)
    model = Transformer(("src", "tgt"), ("logits",), src_vocab_size=N_BINS, tgt_vocab_size=len(VOCAB),
                        d_model=d_model, num_heads=num_heads, num_layers=num_layers, d_ff=4 * d_model,
                        max_len=max(N_POINTS, TGT_LEN), generator=torch.Generator().manual_seed(SEED), device=device)
    sup = SupervisedConstraint(
        {"dataset": {"name": "NamedArrayDataset", "input": {"src": src_tr, "tgt": tgt_tr}, "label": {"tokens": tgt_tr}},
         "batch_size": batch_size, "iters_per_epoch": iters_per_epoch,
         "sampler": {"name": "BatchSampler", "shuffle": True, "drop_last": True}},
        FunctionalLoss(xent), {"logits": lambda out: out["logits"]}, name="Sup")
    validator = {
        "sr_valid": SupervisedValidator(
            {"dataset": {"name": "NamedArrayDataset", "input": {"src": src_te, "tgt": tgt_te},
                         "label": {"tokens": tgt_te}},
             "total_size": n_test, "batch_size": n_test,
             "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}},
            FunctionalLoss(xent), {"logits": lambda out: out["logits"]},
            metric={"Acc": FunctionalMetric(token_acc)}, name="sr_valid")
    }
    lr = Cosine(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=learning_rate,
                warmup_epoch=max(epochs // 10, 1))()
    return Solver(model, {"Sup": sup}, output_dir, Adam(lr)(model), epochs=epochs, iters_per_epoch=iters_per_epoch,
                  eval_during_train=False, validator=validator, seed=SEED, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 50)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"sr_valid: {solver.eval()[1]['sr_valid']}")
