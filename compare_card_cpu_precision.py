#!/usr/bin/env python3
"""How far float32 gradients of the Earthformer family stray at the
reference ENSO pretrain width, on the card and on the CPU, against a
float64 reference.

Run from the repository root on a GPU machine::

    python3 compare_card_cpu_precision.py [samples]

Builds the ENSO Earthformer and ExtFormer-MoE (10 experts) at
``chip_smoke.py``'s ``ENSO_FULL`` width and takes the first ``samples``
(default 2) of their first batch. For each model, in eval mode, computes
the outputs and the parameter gradient of sum(out * c) for one random
cotangent c four ways: on the card in float32, on the CPU in float32 with
oneDNN (torch's default) and without it, and on the CPU in float64. Prints
the card's name and power limit, then for each float32 way the largest
output error and the whole gradient's largest error over its largest
magnitude against float64, its worst parameters, and the card against each
CPU way (what ``chip_smoke.py``'s card-against-CPU check would see in
float32); one JSON line a model.
"""

import copy
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def outputs_and_grads(model, inputs, device, dtype, onednn=True):
    m = model if device == "cuda" else copy.deepcopy(model).cpu()
    m = m.to(dtype)
    with torch.backends.mkldnn.flags(enabled=onednn):
        out = m({k: v.to(device, dtype) for k, v in inputs.items()})["target"]
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(device, dtype)
        names, ps = zip(*m.named_parameters())
        gs = torch.autograd.grad((out * cot).sum(), ps, allow_unused=True)
    grads = {n: (g if g is not None else torch.zeros_like(p)).detach().cpu().double() for n, g, p in zip(names, gs, ps)}
    return out.detach().cpu().double(), grads


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_card_cpu_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from paddlescience_torch.arch.cuboid_transformer import ExtFormerMoECuboid
    from paddlescience_torch.arch.extformer_moe import default_moe_config
    from paddlescience_torch.examples import earthformer_enso

    samples = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    models = {"earthformer_enso": {}, "extformer_moe_enso": dict(model_cls=ExtFormerMoECuboid,
                                                                 moe_config=default_moe_config())}
    for name, kw in models.items():
        solver = earthformer_enso.make_solver(output_dir=None, device="cuda", **kw, **chip_smoke.ENSO_FULL)
        model = solver.model
        model.set_train_rng(None)
        inputs = {k: v[:samples] for k, v in chip_smoke._first_batch(solver, name).items()}
        ways = {"card float32": ("cuda", torch.float32, True), "cpu float32 onednn": ("cpu", torch.float32, True),
                "cpu float32 native": ("cpu", torch.float32, False), "cpu float64": ("cpu", torch.float64, False)}
        res = {way: outputs_and_grads(model, inputs, *args) for way, args in ways.items()}
        ref_out, ref_g = res["cpu float64"]
        whole = lambda g: torch.cat([v.reshape(-1) for v in g.values()])  # noqa: E731
        vmax = float(whole(ref_g).abs().max())
        report = {"model": name, "samples": samples}
        for way in ("card float32", "cpu float32 onednn", "cpu float32 native"):
            out, g = res[way]
            worst = sorted(((float((g[n] - ref_g[n]).abs().max()) / vmax, n) for n in g), reverse=True)[:3]
            report[way] = {"output_vs_float64": rel(out, ref_out), "gradient_vs_float64": rel(whole(g), whole(ref_g)),
                           "worst_parameters": [[n, e] for e, n in worst]}
        for way in ("cpu float32 onednn", "cpu float32 native"):
            report[f"card vs {way}"] = rel(whole(res["card float32"][1]), whole(res[way][1]))
        print(json.dumps(report), flush=True)
        del solver, model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
