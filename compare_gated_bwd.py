#!/usr/bin/env python3
"""Time ``jet_gated_bwd`` built from several sources on one GPU.

Run from the repository root::

    python3 compare_gated_bwd.py --source base=<dir>/paddlescience_torch/csrc/jet_gated_bwd.cu

where ``<dir>`` holds another revision of the repository, e.g. unpacked
with ``git archive <commit> paddlescience_torch/csrc | tar -x -C <dir>``
into a directory that ``.gitignore`` lists (``_checkout*/``). The
repository's own ``paddlescience_torch/csrc/jet_gated_bwd.cu`` is always
included, as ``repo``; ``--source`` may be given several times.

Each source is compiled by nvcc for sm_90a with the flags of
``paddlescience_torch/ops/cuda_build.py`` and the ``jet_common.cuh`` beside
it (one nvcc per source, all started together), then called through the
port's wrapper ``ops/jet_gated.py::jet_gated_bwd`` at each shape of
``SHAPES``, on the same inputs, in turns (every source, then every source in
reverse order) so that a drift of the card's clock spreads over all of
them. A source whose entry point takes no ``park`` argument (before the
one-tile plan for S >= 7 at width 256) is called without it, and a shape it
cannot take is reported as refused. Each result is held against the
``repo`` build's on the same inputs (max abs error over every output).

Prints, per source, the registers and spill bytes of each kernel instance
(``-Xptxas -v``), per shape and source the time of one call (CUDA events,
ms, each turn) beside the shape's bound, then the card's name and power
limit and one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# label -> (S, N, W, program name, blocks or layers)
SHAPES = {
    "piratenet9_S4_W256": (4, 4096, 256, "piratenet", 9),
    "bare_piratenet9_S4_W256": (4, 4096, 256, "bare", 9),
    "modified_mlp4_S4_W256": (4, 4096, 256, "modified_mlp", 4),
    "piratenet9_S6_W256": (6, 4096, 256, "piratenet", 9),
    "piratenet9_S7_W256": (7, 4096, 256, "piratenet", 9),
    "piratenet9_S8_W64": (8, 4096, 64, "piratenet", 9),
    "piratenet9_S8_W128": (8, 4096, 128, "piratenet", 9),
}
PARK_ARG = 22  # position of park among the entry point's arguments (after S, L, N, kmax)


def build(sources):
    """{label: (library path, nvcc log)}; one nvcc per source, in parallel."""
    from paddlescience_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        h = hashlib.sha256(open(src, "rb").read())
        h.update(open(os.path.join(os.path.dirname(src), "jet_common.cuh"), "rb").read())
        out = cuda_build.BUILD_DIR / f"compare-{label}-{h.hexdigest()[:16]}.so"
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", os.path.dirname(src), "-o", str(out), src]
        procs[label] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        built[label] = (str(out), text)
    return built


def entry(path: str, src: str):
    """(bound entry point, whether it takes park)."""
    from paddlescience_torch.ops.cuda_build import F, I, P

    lib = ctypes.CDLL(path)
    text = open(src).read()
    sig = text[text.index('extern "C" int jet_gated_bwd('):]
    has_park = "int park" in sig[: sig.index("{")]
    fn = lib.jet_gated_bwd
    fn.argtypes = [P] * 18 + [I] * (6 if has_park else 5) + [F, P]
    fn.restype = ctypes.c_int
    return fn, has_park


def inputs(S, N, W, kind, n):
    """The program and inputs of one shape, made on the card from a seed."""
    import torch

    from chip_smoke import jet_index, make_gated_inputs
    from paddlescience_torch.ops import jet_gated as G

    program = G.modified_mlp_program(n) if kind == "modified_mlp" else G.piratenet_program(n)
    idx, y, u, v, weights, biases, alphas, g_out = make_gated_inputs(S, N, W, program)
    assert len(idx) == S, (S, len(idx))
    _, bounds = G.jet_gated_fwd(y, u, v, weights, biases, alphas, program, idx, save_bounds=True)
    if kind == "bare":
        program, u, v, alphas = tuple(op & G.STAGE for op in program), (), (), ()
    torch.cuda.synchronize()
    return (y, u, v, bounds, weights, biases, alphas, g_out, program, idx)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_gated_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import bound_ms, card_line, cuda_ms, gated_bound, ptxas_by_function
    from paddlescience_torch.ops import cuda_build
    from paddlescience_torch.ops import jet_gated as G

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], help="label=path of a jet_gated_bwd.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", default=",".join(SHAPES), help="comma-separated labels of SHAPES")
    a = ap.parse_args()
    sources = {"repo": str(cuda_build.CSRC / "jet_gated_bwd.cu")}
    for item in a.source:
        label, path = item.split("=", 1)
        sources[label] = os.path.abspath(path)
    built = build(sources)
    result = {"card": card_line(), "ptxas": {}, "shapes": {}}
    fns = {}
    for label, (path, text) in built.items():
        fns[label] = entry(path, sources[label])
        result["ptxas"][label] = ptxas_by_function(text)
        for fn, (regs, st, ld) in sorted(result["ptxas"][label].items()):
            print(f"[ptxas] {label} {fn}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")

    def use(label):
        fn, has_park = fns[label]

        def shim(name, *args):
            if name != "jet_gated_bwd":
                return cuda_build.launch(name, *args)
            rc = fn(*(args if has_park else args[:PARK_ARG] + args[PARK_ARG + 1:]))
            if rc != 0:
                raise RuntimeError(f"{label}: CUDA error {rc}")
        G.launch = shim

    flat = lambda out: [out] if isinstance(out, torch.Tensor) else [t for part in out for t in flat(part)]
    for shape in a.shapes.split(","):
        S, N, W, kind, n = SHAPES[shape]
        args = inputs(S, N, W, kind, n)
        b = gated_bound(S, N, W, args[8])
        entry_ = result["shapes"][shape] = {"bound_ms": bound_ms(b[2], b[3])[0], "ms": {}, "max_abs_err": {}}
        use("repo")
        ref = flat(G.jet_gated_bwd(*args))
        ok = []
        for label in sources:
            use(label)
            try:
                got = flat(G.jet_gated_bwd(*args))
                torch.cuda.synchronize()
            except RuntimeError as e:
                entry_["ms"][label] = f"refused ({e})"
                continue
            entry_["max_abs_err"][label] = max(float((g - r).abs().max()) for g, r in zip(got, ref) if r.numel())
            ok.append(label)
        for label in ok + ok[::-1]:
            use(label)
            entry_["ms"].setdefault(label, []).append(cuda_ms(lambda: G.jet_gated_bwd(*args), a.reps))
        for label in sources:
            ms = entry_["ms"][label]
            shown = ms if isinstance(ms, str) else " ".join(f"{t:.4f}" for t in ms)
            err = entry_["max_abs_err"].get(label)
            print(f"[time] {shape} {label}: {shown} ms (bound {entry_['bound_ms']:.4f} ms"
                  + (f", max abs err vs repo {err:.3e})" if err is not None else ")"), flush=True)
        del args, ref
        torch.cuda.empty_cache()
    print(result["card"])
    print(json.dumps(result))
    return 0 if all(math.isfinite(e) for s in result["shapes"].values() for e in s["max_abs_err"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
