#!/usr/bin/env python3
"""Hold cuFFT's inverse real FFTs against the CPU's (pocketfft, what numpy
and the JAX package compute) on spectra that are not Hermitian, at every
shape the port's spectral layers use, on one GPU.

Run from the repository root::

    python3 compare_irfft.py

A spectral layer that writes complex weights into its kept modes (an FNO
or UNO spectral conv, AFNO's block MLP, FNO1d, the inverse spherical
harmonics transform) hands ``torch.fft.irfftn``/``irfft`` a spectrum whose
DC bin (and Nyquist bin, for an even length) along the real axis carries
an imaginary part. pocketfft reads only the real part of those bins;
cuFFT's complex-to-real transform documents nothing for such input. One
forward of each spectral model at its example's default size on the card
records every inverse real FFT it makes (input shape, lengths, axes,
norm); for each, a seeded random complex spectrum of that shape goes
through the inverse on the card and on the CPU, as is and with the
imaginary parts of those bins set to zero. Prints one JSON line per shape
(max |card - CPU| over the CPU's largest magnitude) and a summary line;
exits 1 if any shape differs by more than 1e-5 of its largest magnitude.
"""

import json
import os
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LIMIT = 1e-5


def record_calls():
    """Each spectral model's inverse real FFT calls, as
    {model: [(shape, s, dims, norm), ...]}."""
    from paddlescience_torch.examples import catheter, darcy_tfno, darcy_uno, fourcastnet, sfno_swe, yinglong

    irfftn, irfft = torch.fft.irfftn, torch.fft.irfft
    calls = []

    def rec_irfftn(x, s=None, dim=None, norm=None):
        calls.append((tuple(x.shape), tuple(s), tuple(d % x.ndim for d in dim), norm))
        return irfftn(x, s=s, dim=dim, norm=norm)

    def rec_irfft(x, n=None, dim=-1, norm=None):
        calls.append((tuple(x.shape), (n,), (dim % x.ndim,), norm))
        return irfft(x, n=n, dim=dim, norm=norm)

    tmp = tempfile.mkdtemp(prefix="compare_irfft_")
    data = darcy_tfno.make_data(120, 16)
    makers = {
        "darcy_tfno": lambda: darcy_tfno.build_solver(data=data, n_train=100, n_eval=20, output_dir=tmp,
                                                      device="cuda"),
        "darcy_uno": lambda: darcy_uno.build_solver(data=data, n_train=100, n_eval=20, output_dir=tmp, device="cuda"),
        "catheter": lambda: catheter.build_solver(data_dir=None, output_dir=tmp, device="cuda"),
        "fourcastnet": lambda: fourcastnet.build_solver(output_dir=tmp, device="cuda"),
        "sfno_swe": lambda: sfno_swe.build_solver(output_dir=tmp, device="cuda"),
    }
    per_model = {}
    torch.fft.irfftn, torch.fft.irfft = rec_irfftn, rec_irfft
    try:
        for name, build in makers.items():
            solver = build()
            inp, _, _ = next(iter(solver.constraint.values())).data_iter.__next__()
            del calls[:]
            with torch.no_grad():
                solver.model({k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in inp.items()})
            per_model[name] = list(dict.fromkeys(calls))
        yl = yinglong.YingLong(device="cuda")
        del calls[:]
        with torch.no_grad():
            yl.model({"input": yl.x[:2]})
        per_model["yinglong"] = list(dict.fromkeys(calls))
    finally:
        torch.fft.irfftn, torch.fft.irfft = irfftn, irfft
    return per_model


def zero_edge_imag(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``x`` with the imaginary parts of the DC bin (and the Nyquist bin
    when n is even) along axis d set to zero."""
    x = x.clone()
    for b in ([0, n // 2] if n % 2 == 0 else [0]):
        if b < x.shape[d]:
            idx = [slice(None)] * x.ndim
            idx[d] = b
            x[tuple(idx)] = x[tuple(idx)].real.to(x.dtype)
    return x


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_irfft: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for model, keys in record_calls().items():
        for shape, s, dim, norm in keys:
            x = torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))
            row = {"model": model, "shape": list(shape), "s": list(s), "dim": list(dim), "norm": norm}
            for tag, spec in (("card_vs_cpu", x), ("card_vs_cpu_edge_imag_zeroed", zero_edge_imag(x, s[-1], dim[-1]))):
                cpu = torch.fft.irfftn(spec, s=s, dim=dim, norm=norm)
                card = torch.fft.irfftn(spec.cuda(), s=s, dim=dim, norm=norm).cpu()
                row[tag] = float((card - cpu).abs().max()) / float(cpu.abs().max())
            rows.append(row)
            print(json.dumps(row), flush=True)
    worst = max(r["card_vs_cpu"] for r in rows)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shapes": len(rows), "worst_card_vs_cpu": worst,
                      "limit": LIMIT}))
    return 0 if worst <= LIMIT else 1


if __name__ == "__main__":
    sys.exit(main())
