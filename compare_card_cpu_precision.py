#!/usr/bin/env python3
"""How far float32 gradients stray, on the card and on the CPU, against a
float64 reference: the Earthformer family at the reference ENSO pretrain
width, and TGCN (tgcn_pems at 16 and at 307 sensors, batch 64).

Run from the repository root on a GPU machine::

    python3 compare_card_cpu_precision.py [samples] [models]

``models`` is a comma-separated list of ``earthformer_enso``,
``extformer_moe_enso`` (both by default; at ``chip_smoke.py``'s
``ENSO_FULL`` width), ``tgcn_pems16`` and ``tgcn_pems307``. Takes the
first ``samples`` (default 2) of each model's first batch. For each model,
in eval mode, computes the outputs and the parameter gradient of sum(out *
c) for one random cotangent c five ways: on the card in float32 with cuDNN
(torch's default) and without it, on the CPU in float32 with oneDNN
(torch's default) and without it, and on the CPU in float64. Prints
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


def outputs_and_grads(model, inputs, device, dtype, onednn=True, cudnn=True):
    m = copy.deepcopy(model).to(device, dtype)
    with torch.backends.mkldnn.flags(enabled=onednn), torch.backends.cudnn.flags(
            enabled=cudnn, benchmark=False, deterministic=False, allow_tf32=False):
        out = next(iter(m({k: v.to(device, dtype) for k, v in inputs.items()}).values()))
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

    from paddlescience_torch.examples import tgcn_pems

    samples = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    chosen = sys.argv[2].split(",") if len(sys.argv) > 2 else ["earthformer_enso", "extformer_moe_enso"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    makers = {
        "earthformer_enso": lambda: earthformer_enso.make_solver(output_dir=None, device="cuda",
                                                                 **chip_smoke.ENSO_FULL),
        "extformer_moe_enso": lambda: earthformer_enso.make_solver(
            output_dir=None, device="cuda", model_cls=ExtFormerMoECuboid, moe_config=default_moe_config(),
            **chip_smoke.ENSO_FULL),
        "tgcn_pems16": lambda: tgcn_pems.build_solver(epochs=1, num_nodes=16, output_dir=None, device="cuda"),
        "tgcn_pems307": lambda: tgcn_pems.build_solver(epochs=1, num_nodes=307, output_dir=None, device="cuda"),
    }
    for name in chosen:
        solver = makers[name]()
        model = solver.model
        model.set_train_rng(None)
        inputs = {k: v[:samples] for k, v in chip_smoke._first_batch(solver, name).items()}
        ways = {"card float32": ("cuda", torch.float32), "card float32 no cudnn": ("cuda", torch.float32, True, False),
                "cpu float32 onednn": ("cpu", torch.float32, True), "cpu float32 native": ("cpu", torch.float32, False),
                "cpu float64": ("cpu", torch.float64, False)}
        res = {way: outputs_and_grads(model, inputs, *args) for way, args in ways.items()}
        ref_out, ref_g = res["cpu float64"]
        whole = lambda g: torch.cat([v.reshape(-1) for v in g.values()])  # noqa: E731
        vmax = float(whole(ref_g).abs().max())
        report = {"model": name, "samples": samples}
        for way in ("card float32", "card float32 no cudnn", "cpu float32 onednn", "cpu float32 native"):
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
