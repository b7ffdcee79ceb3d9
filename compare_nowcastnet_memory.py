#!/usr/bin/env python3
"""NowcastNet at the JAX defaults (9 of 29 frames at 512^2, ngf 32, batch 2,
through the ``Solver`` on ``RadarDataset``): its eager train step before and
after a CUDA graph of 2 steps is captured, and that graph's replay, under
cuDNN's default and its deterministic algorithms (one process each).

Run from the repository root on a GPU machine::

    python3 compare_nowcastnet_memory.py [default|deterministic]

With cuDNN's benchmark mode off (PyTorch's default) a convolution takes
the first algorithm of cuDNN's heuristic ranking whose workspace can be
allocated, so the choice depends on the device memory free at the call:
a captured graph's pool and the allocator's cache hold tens of GiB at this
size. Prints, for each setting asked for (both by default), the ms of an
eager step (3 steps, two warm-up steps first), of staging a chunk's 2 host
batches, of a graphed chunk of 2 steps (staging included, the capture
before), of the replay alone, and of an eager step after the capture, with
the memory reserved at each point; then the card's name and power limit.
"""

import contextlib
import json
import subprocess
import sys
import time

import torch

CONFIG = dict(height=512, width=512, input_length=9, total_length=29, ngf=32, batch_size=2, num_cases=2,
              iters_per_epoch=2)


def ms(fn, n: int = 3) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def measure(setting: str) -> dict:
    from paddlescience_torch.examples import nowcastnet_radar
    from paddlescience_torch.utils.step_graph import deterministic_convs

    solver = nowcastnet_radar.build_solver(epochs=1, output_dir=None, device="cuda", **CONFIG)
    gib = lambda: torch.cuda.memory_reserved() / 2**30  # noqa: E731
    out = {"setting": setting}
    with deterministic_convs() if setting == "deterministic" else contextlib.nullcontext():
        solver.train_step()
        solver.train_step()
        out["eager_step_ms"], out["reserved_gib_eager"] = ms(solver.train_step), gib()
        out["stage_2_batches_ms"] = ms(lambda: solver._stage_host_batches(2))
        solver.train_chunk(2)  # the capture
        out["graphed_chunk_of_2_ms"], out["reserved_gib_graph"] = ms(lambda: solver.train_chunk(2)), gib()
        out["replay_of_2_ms"] = ms(lambda: solver.loop.run(2))
        out["eager_step_after_capture_ms"] = ms(solver.train_step)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_nowcastnet_memory: no CUDA device", file=sys.stderr)
        return 2
    settings = sys.argv[1:] or ["default", "deterministic"]
    if len(settings) > 1:  # one process a setting: each starts with the card's memory free
        for setting in settings:
            subprocess.run([sys.executable, __file__, setting], check=True)
    else:
        print(json.dumps(measure(settings[0])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
