#!/usr/bin/env python3
"""Time the operator examples' graphed train steps with cuDNN's default
algorithms against its deterministic ones, on one GPU, in one process.

Run from the repository root::

    python3 compare_cudnn_determinism.py [rounds]

cuDNN's default algorithms may sum a convolution's weight gradient with
atomics, so a graphed step and the same step run eagerly can differ in the
last bits; the port keeps those defaults and holds cuDNN to its
deterministic algorithms only where graphed steps are compared with eager
ones (``utils/step_graph.py::deterministic_convs``). This script measures
what that choice is worth: each example at its default size captures one
K-step graph under each setting (a graph is kept per setting), then
``rounds`` rounds (default 4) time 10 replays under each setting, the
order of the two settings alternating from round to round. Prints one JSON
line per example (steps/s under each setting in every round, their medians,
and default over deterministic) and the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPLAYS = 10


def examples(tmp):
    """name -> (a zero-argument chunk runner, K) for each operator example."""
    from paddlescience_torch.examples import (adv_cvit, catheter, darcy_tfno, darcy_uno, fourcastnet, ns_cvit,
                                              sfno_swe, velocitygan_fwi, yinglong)

    data = darcy_tfno.make_data(1100, 16)
    solvers = {
        "darcy_uno": lambda: darcy_uno.build_solver(data=data, output_dir=tmp, device="cuda"),
        "catheter": lambda: catheter.build_solver(data_dir=None, output_dir=tmp, device="cuda"),
        "fourcastnet": lambda: fourcastnet.build_solver(output_dir=tmp, device="cuda"),
        "sfno_swe": lambda: sfno_swe.build_solver(output_dir=tmp, device="cuda"),
        "adv_cvit": lambda: adv_cvit.build_solver(data_dir=None, output_dir=tmp, device="cuda"),
        "ns_cvit": lambda: ns_cvit.build_solver(output_dir=tmp, device="cuda"),
    }
    for name, build in solvers.items():
        solver = build()
        k = solver.iters_per_epoch
        yield name, (lambda s=solver, k=k: s.train_chunk(k)), k
    yl = yinglong.YingLong(device="cuda")
    yield "yinglong", (lambda: yl.loop.run(10)), 10
    gan = velocitygan_fwi.build(device="cuda")
    yield "velocitygan", (lambda: gan.loop.run(20)), 20


def steps_per_s(run, k: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPLAYS):
        run()
    torch.cuda.synchronize()
    return REPLAYS * k / (time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_cudnn_determinism: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from paddlescience_torch.utils.step_graph import deterministic_convs

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="compare_cudnn_") as tmp:
        for name, run, k in examples(tmp):
            run()  # capture and one replay under each setting
            with deterministic_convs():
                run()
            rates = {"default": [], "deterministic": []}
            for r in range(rounds):
                for mode in (("default", "deterministic") if r % 2 == 0 else ("deterministic", "default")):
                    if mode == "deterministic":
                        with deterministic_convs():
                            rates[mode].append(steps_per_s(run, k))
                    else:
                        rates[mode].append(steps_per_s(run, k))
            med = {m: statistics.median(v) for m, v in rates.items()}
            print(json.dumps({"example": name, "K": k, "replays": REPLAYS, "steps_per_s": rates, "median": med,
                              "default_over_deterministic": med["default"] / med["deterministic"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
