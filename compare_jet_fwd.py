#!/usr/bin/env python3
"""Time the forward jet kernels (``jet_mlp_fwd``, ``jet_gated_fwd``) built
from several sources on one GPU.

Run from the repository root::

    python3 compare_jet_fwd.py --source base=<dir>/paddlescience_torch/csrc

where ``<dir>`` holds another revision of the repository, e.g. unpacked
with ``git archive <commit> paddlescience_torch/csrc | tar -x -C <dir>``
into a directory that ``.gitignore`` lists (``_checkout*/``). A source is a
directory holding ``jet_mlp_fwd.cu``, ``jet_gated_fwd.cu`` and the
``jet_common.cuh`` they include. The repository's own
``paddlescience_torch/csrc`` is always included, as ``repo``; ``--source``
may be given several times.

Each source's two kernels are compiled by nvcc for sm_90a with the flags of
``paddlescience_torch/ops/cuda_build.py`` (one nvcc per file, all started
together), then called through the port's wrappers
(``ops/jet_mlp.py::jet_mlp_fwd``, ``ops/jet_gated.py::jet_gated_fwd``) at
each shape of ``SHAPES``, on the same inputs, in turns (every source, then
every source in reverse order) so that a drift of the card's clock spreads
over all of them. The entry points' signatures are the same in every
revision; each build is passed the tile stride it was written for: a
source with the tensor-core product (``fwd_ring_stride`` in its
``jet_common.cuh``) gets ``ops/jet_mlp.py::fwd_kst``, an older one the
widest layer rounded up to 4. Each result is held against the ``repo``
build's on the same inputs (max abs error over every output and saved
boundary), and every build against the plain PyTorch version (max abs
error, and relative to the plain output's largest magnitude, which the
``repo`` build must keep within 1e-4).

Prints, per source, the registers and spill bytes of each kernel instance
(``-Xptxas -v``), per shape and source the time of one call (CUDA events,
ms, each turn) beside the shape's two bounds (3xTF32: 3 x FLOPs at the
495 TFLOP/s TF32 peak; float32 outside the tensor cores: FLOPs at 67
TFLOP/s; each against bytes at 3.35 TB/s), then the card's name and power
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
KERNEL_FILES = {"mlp": "jet_mlp_fwd", "gated": "jet_gated_fwd"}
# label -> ("gated", S, N, W, program name, blocks or layers) or ("mlp", S, N, widths, activation, save bounds)
SHAPES = {
    "piratenet9_S4_W256": ("gated", 4, 4096, 256, "piratenet", 9),
    "bare_piratenet9_S4_W256": ("gated", 4, 4096, 256, "bare", 9),
    "modified_mlp_3+1_S4_W256": ("gated", 4, 4096, 256, "modified_mlp", (3, 1)),
    "piratenet9_S5_W256": ("gated", 5, 4096, 256, "piratenet", 9),
    "piratenet9_S6_W256": ("gated", 6, 4096, 256, "piratenet", 9),
    "piratenet9_S7_W256": ("gated", 7, 4096, 256, "piratenet", 9),
    "piratenet9_S8_W256": ("gated", 8, 4096, 256, "piratenet", 9),
    "piratenet9_S4_W64": ("gated", 4, 4096, 64, "piratenet", 9),
    "piratenet9_S4_W128": ("gated", 4, 4096, 128, "piratenet", 9),
    "piratenet9_S8_W64": ("gated", 8, 4096, 64, "piratenet", 9),
    "piratenet9_S8_W128": ("gated", 8, 4096, 128, "piratenet", 9),
    "aneurysm_S7": ("mlp", 7, 2048, (3,) + (512,) * 6, "silu", False),
    "aneurysm_S7_save_bounds": ("mlp", 7, 2048, (3,) + (512,) * 6, "silu", True),
    "aneurysm_S5": ("mlp", 5, 2048, (3,) + (512,) * 6, "silu", False),
    "aneurysm_S5_save_bounds": ("mlp", 5, 2048, (3,) + (512,) * 6, "silu", True),
    "aneurysm_unsteady_S8": ("mlp", 8, 2048, (3,) + (512,) * 6, "silu", False),
    "aneurysm_unsteady_S8_save_bounds": ("mlp", 8, 2048, (3,) + (512,) * 6, "silu", True),
    "mlp4x256_S4": ("mlp", 4, 4096, (256,) * 5, "tanh", False),
    "mlp4x256_S4_save_bounds": ("mlp", 4, 4096, (256,) * 5, "tanh", True),
    "mlp5x50_padded52_S4": ("mlp", 4, 4096, (256,) + (52,) * 5, "tanh", False),
}
KMAX_ARG = {"jet_mlp_fwd": 12, "jet_gated_fwd": 16}  # position of kmax among the entry point's arguments


def mlp_bound(S, N, dims, save_bounds):
    """(FLOPs, bytes) of one jet_mlp_fwd call: the products; the input
    streams read once, the output streams (and boundaries) written once,
    the weights and biases read once."""
    L = len(dims) - 1
    flops = sum(S * 2.0 * N * dims[l] * dims[l + 1] for l in range(L))
    nbytes = S * N * (dims[0] + dims[-1] + (sum(dims[1:-1]) if save_bounds else 0)) * 4.0
    return flops, nbytes + sum((dims[l] * dims[l + 1] + dims[l + 1]) * 4.0 for l in range(L))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_jet_fwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import (bound_ms, card_line, cuda_ms, gated_bound, make_gated_inputs, make_inputs,
                            ptxas_by_function, tc_bound_ms)
    from compare_gated_bwd import build
    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import cuda_build
    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], help="label=directory of jet_{mlp,gated}_fwd.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma-separated labels of SHAPES")
    a = ap.parse_args()
    dirs = {"repo": str(cuda_build.CSRC)}
    for item in a.source:
        label, path = item.split("=", 1)
        dirs[label] = os.path.abspath(path)
    built = build({f"{label}.{k}": os.path.join(d, f"{f}.cu") for label, d in dirs.items()
                   for k, f in KERNEL_FILES.items()})
    result = {"card": card_line(), "ptxas": {}, "shapes": {}}
    fns = {}  # (label, entry point) -> (function, tile stride of the source's plan)
    for key, (path, text) in built.items():
        label, kind = key.split(".")
        entry = KERNEL_FILES[kind]
        fn = getattr(ctypes.CDLL(path), entry)
        fn.argtypes = cuda_build._ENTRY_POINTS[entry][1]
        fn.restype = ctypes.c_int
        tc = "fwd_ring_stride" in open(os.path.join(dirs[label], "jet_common.cuh")).read()
        fns[(label, entry)] = (fn, tc)
        result["ptxas"][key] = ptxas_by_function(text)
        for name, (regs, st, ld) in sorted(result["ptxas"][key].items()):
            print(f"[ptxas] {label} {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")

    def use(label, dims):
        def shim(name, *args):
            if (label, name) not in fns:
                return cuda_build.launch(name, *args)
            fn, tc = fns[(label, name)]
            kmax = J.fwd_kst(dims) if tc else -(-max(dims) // 4) * 4
            k = KMAX_ARG[name]
            rc = fn(*args[:k], kmax, *args[k + 1:])
            if rc != 0:
                raise RuntimeError(f"{label} {name}: CUDA error {rc}")
        J.launch = G.launch = shim

    acts = {"silu": (jet.SILU, 0.0), "tanh": J.TANH}
    flat = lambda out: [out] if isinstance(out, torch.Tensor) else [t for part in out for t in flat(part)]
    for shape in a.shapes.split(","):
        spec = SHAPES[shape]
        if spec[0] == "gated":
            _, S, N, W, kind, n = spec
            progs = ([G.modified_mlp_program(k) for k in n] if kind == "modified_mlp"
                     else [G.piratenet_program(n)])
            calls, plains, flops, nbytes = [], [], 0.0, 0.0
            for program in progs:
                idx, y, u, v, weights, biases, alphas, _ = make_gated_inputs(S, N, W, program)
                if kind == "bare":
                    program, u, v, alphas = tuple(op & G.STAGE for op in program), (), (), ()
                args = (y, u, v, weights, biases, alphas, program, idx)
                calls.append(lambda args=args: G.jet_gated_fwd(*args))
                plains.append(lambda args=args: G.jet_gated_fwd_plain(*args))
                f, b = gated_bound(S, N, W, program)[:2]
                flops, nbytes = flops + f, nbytes + b - (2 * S * N * W * 4.0 if kind == "bare" else 0.0)
            dims = [W] * 2
        else:
            _, S, N, dims, act_name, save = spec
            idx, streams, weights, biases, _ = make_inputs(S, N, dims)
            act = acts[act_name]
            calls = [lambda: J.jet_mlp_fwd(streams, weights, biases, idx, save, act)]
            plains = [lambda: J.jet_mlp_fwd_plain(streams, weights, biases, idx, save, act)]
            flops, nbytes = mlp_bound(S, N, dims, save)
        run = lambda fs: [t for f in fs for t in flat(f())]
        entry = result["shapes"][shape] = {
            "bound_ms_3xtf32": tc_bound_ms(flops, nbytes)[0], "bound_ms_fp32": bound_ms(flops, nbytes)[0],
            "ms": {}, "max_abs_err_vs_plain": {}, "rel_err_vs_plain": {}, "max_abs_err_vs_repo": {}}
        plain = run(plains)
        use("repo", dims)
        ref = run(calls)
        for label in dirs:
            use(label, dims)
            got = run(calls)
            torch.cuda.synchronize()
            entry["max_abs_err_vs_plain"][label] = max(float((g - r).abs().max()) for g, r in zip(got, plain))
            entry["rel_err_vs_plain"][label] = max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
                                                   for g, r in zip(got, plain))
            entry["max_abs_err_vs_repo"][label] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        for label in list(dirs) + list(dirs)[::-1]:
            use(label, dims)
            entry["ms"].setdefault(label, []).append(cuda_ms(lambda: run(calls), a.reps))
        for label in dirs:
            shown = " ".join(f"{t:.4f}" for t in entry["ms"][label])
            print(f"[time] {shape} {label}: {shown} ms (bound 3xTF32 {entry['bound_ms_3xtf32']:.4f} ms, "
                  f"float32 {entry['bound_ms_fp32']:.4f} ms; vs plain max abs err "
                  f"{entry['max_abs_err_vs_plain'][label]:.3e}, relative {entry['rel_err_vs_plain'][label]:.2e}; "
                  f"vs repo {entry['max_abs_err_vs_repo'][label]:.3e})", flush=True)
        del calls, plains, ref, plain
        torch.cuda.empty_cache()
    J.launch = G.launch = cuda_build.launch
    print(result["card"])
    print(json.dumps(result))
    errs = [e for s in result["shapes"].values() for e in s["max_abs_err_vs_plain"].values()]
    rels = [s["rel_err_vs_plain"]["repo"] for s in result["shapes"].values()]
    return 0 if all(math.isfinite(e) for e in errs) and all(r <= 1e-4 for r in rels) else 1


if __name__ == "__main__":
    sys.exit(main())
