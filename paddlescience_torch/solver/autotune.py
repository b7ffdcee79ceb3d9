"""Measured derivative-path selection for the train step (counterpart of
``paddlescience_tpu/solver/autotune.py``).

Which derivative path (``autodiff/path.py``: ``jvp``, ``jet``, the
``jet_pallas*`` kernel paths) trains a solver fastest is a measured
property of the arch, the derivative components, the batch and the card:
on the H100 the cylinder2d matched workload (MLP 5x50, 299,280 points a
step) runs faster on the plain jet path than on the MLP kernels, while the
256-512 wide nets run faster on the kernels. :func:`autotune` times K train
steps of every candidate as one captured CUDA graph (``Solver.loop``;
K eager steps on the CPU), installs the fastest as the process default and
caches the decision on disk, keyed by :func:`signature`, so a later run
skips the timing.

Timing does not train the model: the solver's state (parameters, optimizer
and schedule state, aggregator weights, batch generator) is snapshotted
before the first candidate and restored after each. Each candidate is
pinned whole with ``set_default`` (an ``override`` would not reach the
graph cache, which is keyed by the process default). Only the slower
graphs are dropped as the timing goes, so at most two candidates' graphs
hold device memory at once.

A candidate is dropped only where the jet kernels refuse its shapes before
any launch (``ops/jet_mlp.py::KernelRefusal``); a failed build, a launch
error, a capture failure or running out of device memory propagate. The
JAX package drops any candidate that throws; here that would hide a
kernel.

``PSCI_AUTOTUNE``: ``auto`` (default) tunes a static K-step ``train()`` of
at least ``PSCI_AUTOTUNE_MIN_STEPS`` (20000) steps with more than one
candidate, ``1`` always, ``0`` never. ``PSCI_AUTOTUNE_FUSED`` (50) caps K,
``PSCI_AUTOTUNE_CALLS`` (3) is the number of timed replays a candidate,
``PSCI_AUTOTUNE_CACHE`` moves the cache from
``~/.cache/paddlescience_torch/deriv_autotune.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.ops.jet_mlp import KernelRefusal
from paddlescience_torch.utils.step_graph import graph_key

__all__ = ["autotune", "maybe_autotune", "candidate_names", "signature"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "paddlescience_torch", "deriv_autotune.json")
_KERNEL_CANDIDATES = ("jet_pallas", "jet_pallas_full", "jet_pallas_full_sb")


def _log(msg: str) -> None:
    print(f"[autotune] {msg}", flush=True)


def _cache_path() -> str:
    return os.environ.get("PSCI_AUTOTUNE_CACHE", _DEFAULT_CACHE)


def _load_cache() -> Dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_cache(cache: Dict) -> None:
    p = _cache_path()
    try:
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(p, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
    except OSError:
        pass  # a read-only home: the decision still holds for this process


def _source_version() -> str:
    """Hash of the sources the timed programs run: the jet, the path flags,
    both segment modules and every kernel source, so that a kernel change
    re-measures instead of serving an old decision."""
    files = [os.path.join(_PKG, *rel) for rel in (("autodiff", "jet.py"), ("autodiff", "path.py"),
                                                  ("ops", "jet_mlp.py"), ("ops", "jet_gated.py"))]
    csrc = os.path.join(_PKG, "csrc")
    files += [os.path.join(csrc, f) for f in sorted(os.listdir(csrc)) if os.path.isfile(os.path.join(csrc, f))]
    h = hashlib.sha1()
    for path in files:
        h.update(os.path.relpath(path, _PKG).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _shape_sig(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shape_sig(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (tuple, list)):
        return [s for i, v in enumerate(tree) for s in _shape_sig(v, f"{prefix}[{i}]")]
    return [f"{prefix}:{tuple(getattr(tree, 'shape', ()))}:{getattr(tree, 'dtype', type(tree).__name__)}"]


def signature(solver, batches) -> str:
    """Hash of what the winner depends on: the card, the float32 matmul
    precision, the models (classes, named parameter shapes and dtypes), the
    staged batches' shapes and each device-sampled constraint's sample
    shapes, the aggregator, the ``PSCI_JET*`` environment and the sources
    (:func:`_source_version`)."""
    if solver.device.type == "cuda":
        dev = f"{torch.cuda.get_device_name(solver.device)}|n={torch.cuda.device_count()}"
    else:
        dev = "cpu"
    params = [f"{n}:{tuple(p.shape)}:{p.dtype}" for m in solver.models for n, p in m.named_parameters()]
    parts = [
        "src=" + _source_version(),
        "dev=" + dev,
        f"prec={torch.backends.cuda.matmul.allow_tf32}|{torch.get_float32_matmul_precision()}",
        "models=" + ",".join(type(m).__name__ for m in solver.models),
        "params=" + ";".join(params),
        "batches=" + ";".join(_shape_sig(batches)),
        "agg=" + type(solver.loss_aggregator).__name__,
        "env=" + ",".join(f"{k}={v}" for k, v in sorted(os.environ.items()) if k.startswith("PSCI_JET")),
    ]
    gen = torch.Generator(device=solver.device).manual_seed(0)  # a draw of its own: the solver's stays put
    for name, cst in solver.constraint.items():
        if cst.data_iter is None:
            parts.append(f"dsamp[{name}]=" + ";".join(_shape_sig(cst.dataset.sample_fn(gen))))
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()


def candidate_names(solver) -> List[str]:
    """The structurally distinct candidates for this solver: ``jvp``; ``jet``
    where some model has a jet forward; on CUDA, where some model is
    eligible for the fused segments under the ``jet_pallas`` flags, the
    three kernel candidates. On the CPU the segments run their plain
    versions, so timing them would measure no kernel (the JAX counterpart:
    no Pallas lowering on the CPU).

    The ``*_full`` candidates are always offered. The JAX package keeps
    them out at "highest" matmul precision, a guard against a Mosaic
    compile time on the TPU that has no counterpart here."""
    names = ["jvp"]
    if any(m.supports_jet() for m in solver.models):
        names.append("jet")
        if solver.device.type == "cuda":
            with deriv_path.override(deriv_path.CANDIDATES["jet_pallas"]):
                if any(getattr(m, "jet_pallas_eligible", lambda: False)() for m in solver.models):
                    names.extend(_KERNEL_CANDIDATES)
    return names


def _time_candidate(solver, k: int, calls: int) -> float:
    """Seconds per step of the current default path: on CUDA ``calls``
    replays of the K-step graph (captured first, then one replay as a
    warm-up), on the CPU ``calls`` runs of K eager steps after one. A
    solver with indexed constraints first draws K host batches from their
    loaders into its chunk buffers, as a ``train_chunk`` does, and every
    run reads those."""
    solver._stage_host_batches(k)
    if solver.device.type == "cuda":
        graph, _ = solver.loop.graph(k)
        graph.replay()
        torch.cuda.synchronize(solver.device)
        t0 = time.perf_counter()
        for _ in range(calls):
            graph.replay()
        torch.cuda.synchronize(solver.device)
        return (time.perf_counter() - t0) / (calls * k)

    def run():
        for i in range(k):
            solver._chunk_pos = i
            solver._step(solver.step + i)

    run()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    return (time.perf_counter() - t0) / (calls * k)


def _drop_graph(solver, k: int, name: str) -> None:
    solver.loop.graphs.pop(graph_key(k, deriv_path.CANDIDATES[name]), None)
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
        torch.cuda.empty_cache()


def autotune(solver, batches, fused: int) -> str:
    """Time every candidate of :func:`candidate_names` on ``solver`` (K =
    ``min(fused, PSCI_AUTOTUNE_FUSED)`` steps a run), install the fastest
    with ``set_default`` and return its name; a cached decision for the
    same :func:`signature` and candidates is installed without timing.
    ``batches`` are the solver's staged batches (their shapes key the
    cache). The solver's state is left as it was."""
    names = candidate_names(solver)
    if len(names) == 1:
        deriv_path.set_default(deriv_path.CANDIDATES[names[0]])
        return names[0]
    # the candidate set is part of the key: widening it invalidates cached winners
    sig = signature(solver, batches) + "-" + "+".join(names)
    cache = _load_cache()
    hit = cache.get(sig)
    if hit and hit.get("winner") in names:
        deriv_path.set_default(deriv_path.CANDIDATES[hit["winner"]])
        _log(f"deriv path = {hit['winner']} (cached; {_cache_path()})")
        return hit["winner"]

    k = max(1, min(fused, int(os.environ.get("PSCI_AUTOTUNE_FUSED", "50"))))
    calls = int(os.environ.get("PSCI_AUTOTUNE_CALLS", "3"))
    caller_default = deriv_path.get_default()
    snap = solver.state
    stats = dict(solver.graph_stats.get(k, {}))
    timings: Dict[str, float] = {}
    refused: Dict[str, str] = {}
    best: Optional[str] = None
    done = False
    try:
        for name in names:
            deriv_path.set_default(deriv_path.CANDIDATES[name])
            try:
                timings[name] = _time_candidate(solver, k, calls)
            except KernelRefusal as e:
                refused[name] = str(e)
                _log(f"{name}: the kernels refuse this shape ({e}); dropped")
                continue
            finally:
                solver._load_state(snap)
            _log(f"{name}: {timings[name] * 1e3:.4f} ms/step")
            if best is None or timings[name] < timings[best]:
                if best is not None:
                    _drop_graph(solver, k, best)
                best = name
                stats = dict(solver.graph_stats.get(k, {}))
            else:
                _drop_graph(solver, k, name)
        done = True
    finally:
        if not done:
            deriv_path.set_default(caller_default)
    if best is None:
        raise RuntimeError(f"autotune: the kernels refuse every candidate: {refused}")
    deriv_path.set_default(deriv_path.CANDIDATES[best])
    if solver.device.type == "cuda" and stats:
        solver.graph_stats[k] = {**stats, "replays": 0}  # the winner's capture, kept for training
    cache[sig] = {
        "winner": best,
        "timings_ms_per_step": {n: t * 1e3 for n, t in timings.items()},
        "refused": refused,
        "k_fused": k,
        "device": torch.cuda.get_device_name(solver.device) if solver.device.type == "cuda" else "cpu",
    }
    _store_cache(cache)
    _log(f"deriv path = {best}")
    return best


def maybe_autotune(solver, batches, fused: int) -> Optional[str]:
    """The solver's hook before a static K-step ``train()``: tune when
    forced (``PSCI_AUTOTUNE=1``) or, in auto mode, when the run has at
    least ``PSCI_AUTOTUNE_MIN_STEPS`` steps and more than one candidate.
    Skipped under ``torch.distributed`` with more than one process: ranks
    timing on their own could pin different paths."""
    mode = os.environ.get("PSCI_AUTOTUNE", "auto")
    if mode == "0":
        return None
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        _log(f"skipped under multi-process training (world size {torch.distributed.get_world_size()}); "
             f"using the default path")
        return None
    if mode != "1":
        total = solver.epochs * solver.iters_per_epoch
        if total < int(os.environ.get("PSCI_AUTOTUNE_MIN_STEPS", "20000")):
            return None
        if len(candidate_names(solver)) == 1:
            return None
    return autotune(solver, batches, fused)
