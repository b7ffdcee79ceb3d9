#!/usr/bin/env python3
"""Time ``jet_mlp_bwd`` built from several sources on one GPU.

Run from the repository root::

    python3 compare_mlp_bwd.py --source base=<dir>/paddlescience_torch/csrc/jet_mlp_bwd.cu

where ``<dir>`` holds another revision of the repository, e.g. unpacked
with ``git archive <commit> paddlescience_torch/csrc | tar -x -C <dir>``
into a directory that ``.gitignore`` lists (``_checkout*/``). The
repository's own ``paddlescience_torch/csrc/jet_mlp_bwd.cu`` is always
included, as ``repo``; ``--source`` may be given several times.

Each source is compiled as ``compare_gated_bwd.py`` compiles its sources
(nvcc for sm_90a, the ``jet_common.cuh`` beside it, one nvcc per source,
all started together), then called through the port's wrapper
``ops/jet_mlp.py::jet_mlp_bwd`` at each shape of ``SHAPES``, on the same
inputs, in turns (every source, then every source in reverse order). The
entry point's signature is the same in every revision, but each build is
passed the tile plan it was written for: a source that sizes its shared
memory with ``bwd_smem`` (the 512-thread kernel on the cp.async ring) gets
``ops/jet_mlp.py::bwd_parks``; an older one (256 threads, one padded
weight chunk, always parked at 8-row tiles) gets ``old_parks``. Each
result is held against the ``repo`` build's on the same inputs (max abs
error over every output).

Prints, per source, the registers and spill bytes of each kernel instance
(``-Xptxas -v``), per shape and source the time of one call (CUDA events,
ms, each turn) beside the shape's bound, then the card's name and power
limit and one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# label -> (streams, batch rows, widths, activation name)
SHAPES = {
    "aneurysm_S7": (7, 2048, (3,) + (512,) * 6, "silu"),
    "aneurysm_unsteady_S8": (8, 2048, (3,) + (512,) * 6, "silu"),
    "aneurysm_S5_two_tiles": (5, 2048, (3,) + (512,) * 6, "silu"),
    "mlp4x256_S4": (4, 4096, (256,) * 5, "tanh"),
    "mlp5x50_padded52_S4": (4, 4096, (256,) + (52,) * 5, "tanh"),
}
PARK_ARG = 16  # position of park among the launch arguments (11 pointers, S, L, N, kmax, bm, park)


def old_parks(S, dims) -> bool:
    """The cotangent placement of the 256-thread kernel: parked at 8-row
    tiles, and at 16 where two tiles and one padded weight chunk do not fit."""
    from paddlescience_torch.ops import jet_mlp as J

    kmax = -(-max(dims) // 4) * 4
    rows = J.tile_rows(S, dims)
    return rows == J.BM_WIDE or (2 * S * kmax * rows + J.KC * (kmax + 4)) * 4 > J.SMEM_LIMIT


def bound(S, N, dims):
    """(FLOPs, bytes) of one call: two products a layer; the input streams,
    the boundaries and the output cotangents read once, the input
    cotangents and every gz written once, the weights read once."""
    L = len(dims) - 1
    flops = 2 * sum(S * 2.0 * N * dims[l] * dims[l + 1] for l in range(L))
    stream = [S * N * d * 4.0 for d in dims]
    w = sum((dims[l] * dims[l + 1] + dims[l + 1]) * 4.0 for l in range(L))
    return flops, 2 * stream[0] + 2 * sum(stream[1:]) + w


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_mlp_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import bound_ms, card_line, cuda_ms, make_inputs, ptxas_by_function
    from compare_gated_bwd import build
    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import cuda_build
    from paddlescience_torch.ops import jet_mlp as J

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], help="label=path of a jet_mlp_bwd.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma-separated labels of SHAPES")
    a = ap.parse_args()
    sources = {"repo": str(cuda_build.CSRC / "jet_mlp_bwd.cu")}
    for item in a.source:
        label, path = item.split("=", 1)
        sources[label] = os.path.abspath(path)
    built = build(sources)
    result = {"card": card_line(), "ptxas": {}, "shapes": {}}
    libs = {}
    for label, (path, text) in built.items():
        lib = ctypes.CDLL(path)
        fn = lib.jet_mlp_bwd
        fn.argtypes = [cuda_build.P] * 11 + [cuda_build.I] * 7 + [cuda_build.F, cuda_build.P]
        fn.restype = ctypes.c_int
        libs[label] = (fn, "bwd_smem(" in open(sources[label]).read())
        result["ptxas"][label] = ptxas_by_function(text)
        for name, (regs, st, ld) in sorted(result["ptxas"][label].items()):
            print(f"[ptxas] {label} {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")

    def use(label, S, dims):
        fn, ring_plan = libs[label]
        park = int(J.bwd_parks(S, dims) if ring_plan else old_parks(S, dims))

        def shim(name, *args):
            if name != "jet_mlp_bwd":
                return cuda_build.launch(name, *args)
            rc = fn(*args[:PARK_ARG], park, *args[PARK_ARG + 1:])
            if rc != 0:
                raise RuntimeError(f"{label}: CUDA error {rc}")
        J.launch = shim

    acts = {"silu": (jet.SILU, 0.0), "tanh": J.TANH}
    for shape in a.shapes.split(","):
        S, N, dims, act_name = SHAPES[shape]
        act = acts[act_name]
        idx, streams, weights, biases, g_out = make_inputs(S, N, dims)
        _, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True, act=act)
        args = (streams, bounds, weights, biases, g_out, idx, act)
        flops, nbytes = bound(S, N, dims)
        entry = result["shapes"][shape] = {
            "bound_ms": bound_ms(flops, nbytes)[0], "tile_rows": J.tile_rows(S, dims), "ms": {}, "max_abs_err": {},
            "parks": {label: bool(J.bwd_parks(S, dims) if libs[label][1] else old_parks(S, dims)) for label in libs}}
        use("repo", S, dims)
        ref = J.jet_mlp_bwd(*args)
        ref = [*ref[0], *ref[1]]
        for label in sources:
            use(label, S, dims)
            got = J.jet_mlp_bwd(*args)
            torch.cuda.synchronize()
            entry["max_abs_err"][label] = max(float((g - r).abs().max()) for g, r in zip([*got[0], *got[1]], ref))
        for label in list(sources) + list(sources)[::-1]:
            use(label, S, dims)
            entry["ms"].setdefault(label, []).append(cuda_ms(lambda: J.jet_mlp_bwd(*args), a.reps))
        for label in sources:
            shown = " ".join(f"{t:.4f}" for t in entry["ms"][label])
            print(f"[time] {shape} {label}: {shown} ms (bound {entry['bound_ms']:.4f} ms, "
                  f"{'parked' if entry['parks'][label] else 'two tiles'}, "
                  f"max abs err vs repo {entry['max_abs_err'][label]:.3e})", flush=True)
        del args, ref, streams, bounds, weights, biases, g_out
        torch.cuda.empty_cache()
    J.launch = cuda_build.launch
    print(result["card"])
    print(json.dumps(result))
    return 0 if all(math.isfinite(e) for s in result["shapes"].values() for e in s["max_abs_err"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
