#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddlescience_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each fatal
on failure:

1. build   - compile every kernel of the main path from
             ``paddlescience_torch/csrc`` with nvcc for sm_90a, in parallel;
2. kernels - hold each kernel against its plain PyTorch version (and the
             backward against ``torch.autograd`` through the plain forward)
             on the card, at the main-path shape (S=4 streams, N=4096,
             W=256) and every segment depth a driven path runs (L=4 on
             jet_pallas_full, L=3 and L=1 on jet_pallas), and at a ragged
             N=4095;
3. main    - train the port's Allen-Cahn solver at full width (MLP 4x256,
             Fourier 256, 4096 PDE + 512 IC points) on the jet_pallas_full
             path, and a few steps on jet_pallas (segments of 3+1 layers);
             each path's kernel launch counts are read around its own run;
4. check   - on one batch, the loss and its gradient through the kernels,
             on each driven path, agree with the plain-PyTorch jet path on
             the card;
5. timing  - train steps per second; device time per step by kernel and
             the device's busy share (torch.profiler); per kernel: time,
             plain-version time, bound, library time.

Tolerance (kernels against plain versions): the float32 sums run in
another order, so each output may differ by at most 1e-4 times the largest
magnitude of the reference tensor (``REL_TOL``).

The line before the last holds a JSON object ``{"kernels": [...]}``; the
line before it the card's name and power limit; the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
CUDA is unavailable or the port is not beside this script.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

REL_TOL = 1e-4
FP32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
HBM_BYTES = 3.35e12  # H100 SXM device-memory rate
MAIN = dict(S=4, N=4096, W=256, L=4)
PATHS = {"jet_pallas_full": 20, "jet_pallas": 3}  # derivative path -> train steps
TIMED_STEPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(got, ref) -> float:
    return float((got - ref).abs().max())


def check_close(what: str, got, ref) -> float:
    err, scale = max_err(got, ref), float(ref.abs().max())
    if not math.isfinite(err) or err > REL_TOL * max(scale, 1e-30):
        raise AssertionError(f"{what}: max abs err {err:.3e} > {REL_TOL} * {scale:.3e}")
    return err


def make_inputs(S, N, W, L, seed=0):
    import torch

    from paddlescience_torch.autodiff import jet

    gen = torch.Generator(device="cuda").manual_seed(seed)
    idx = jet.build_index([(0,), (1,), (1, 1)][: S - 1])
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    streams = [rn(N, W) for _ in range(S)]
    weights = [rn(W, W) / math.sqrt(W) for _ in range(L)]
    biases = [0.1 * rn(W) for _ in range(L)]
    g_out = [rn(N, W) for _ in range(S)]
    return idx, streams, weights, biases, g_out


def check_kernels(S, N, W, L):
    """Kernels against plain versions at one shape; returns max abs errors."""
    import torch

    from paddlescience_torch.ops import jet_mlp as J

    idx, streams, weights, biases, g_out = make_inputs(S, N, W, L)
    tag = f"S={S} N={N} W={W} L={L}"
    errs = {"jet_mlp_fwd": 0.0, "jet_mlp_bwd": 0.0, "jet_wgrad": 0.0}
    ref_outs, ref_bounds = J.jet_mlp_fwd_plain(streams, weights, biases, idx, save_bounds=True)
    outs, _ = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=False)
    outs_sb, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True)
    for s in range(S):
        errs["jet_mlp_fwd"] = max(errs["jet_mlp_fwd"], check_close(f"fwd {tag} out[{s}]", outs[s], ref_outs[s]),
                                  check_close(f"fwd(save) {tag} out[{s}]", outs_sb[s], ref_outs[s]))
    for l, (b, rb) in enumerate(zip(bounds, ref_bounds)):
        errs["jet_mlp_fwd"] = max(errs["jet_mlp_fwd"], check_close(f"fwd {tag} bound[{l}]", b, rb))

    ref_gin, ref_gz = J.jet_mlp_bwd_plain(streams, ref_bounds, weights, biases, g_out, idx)
    g_in, gzs = J.jet_mlp_bwd(streams, ref_bounds, weights, biases, g_out, idx)
    for s in range(S):
        errs["jet_mlp_bwd"] = max(errs["jet_mlp_bwd"], check_close(f"bwd {tag} g_in[{s}]", g_in[s], ref_gin[s]))
    for l in range(L):
        errs["jet_mlp_bwd"] = max(errs["jet_mlp_bwd"], check_close(f"bwd {tag} gz[{l}]", gzs[l], ref_gz[l]))

    ys = [streams] + [b.unbind(0) for b in ref_bounds]
    ref_dw, ref_db = J.jet_wgrad_plain(ys, ref_gz)
    dws, dbs = J.jet_wgrad(ys, ref_gz)
    for l in range(L):
        errs["jet_wgrad"] = max(errs["jet_wgrad"], check_close(f"wgrad {tag} dW[{l}]", dws[l], ref_dw[l]),
                                check_close(f"wgrad {tag} db[{l}]", dbs[l], ref_db[l]))

    # the hand-derived backward against torch.autograd through the plain forward
    leaves = [t.clone().requires_grad_() for t in (*streams, *weights, *biases)]
    o, _ = J.jet_mlp_fwd_plain(leaves[:S], leaves[S : S + L], leaves[S + L :], idx)
    auto = torch.autograd.grad(sum((a * g).sum() for a, g in zip(o, g_out)), leaves)
    k_dw, k_db = J.jet_wgrad(ys, gzs)
    for what, got, ref in zip(("g_in",) * S + ("dW",) * L + ("db",) * L, (*g_in, *k_dw, *k_db), auto):
        check_close(f"kernels vs autograd {tag} {what}", got, ref)
    torch.cuda.synchronize()
    log(f"[kernels] {tag}: max abs err fwd {errs['jet_mlp_fwd']:.3e} bwd {errs['jet_mlp_bwd']:.3e} "
        f"wgrad {errs['jet_wgrad']:.3e}")
    return errs


@contextlib.contextmanager
def on_path(deriv: str):
    """Pin exactly the candidate ``deriv`` as the process default. (An
    ``override`` alone lets flags the candidate does not set, such as
    ``PSCI_JET_SEG``, fall through to the default of another candidate.)"""
    from paddlescience_torch.autodiff import path as deriv_path

    saved = deriv_path.get_default()
    deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    try:
        yield
    finally:
        deriv_path.set_default(saved)


def run_path(solver, deriv: str, steps: int):
    """Train ``steps`` steps on ``deriv`` with the launch counters set to 0
    just before; returns (logs, counts)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.ops import jet_mlp as J

    deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    torch.cuda.synchronize()
    J.reset_counters()
    logs = solver.train(steps)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in (J.jet_mlp_fwd, J.jet_mlp_bwd, J.jet_wgrad)}
    plain = {fn.__name__: fn.cuda_calls for fn in (J.jet_mlp_fwd_plain, J.jet_mlp_bwd_plain, J.jet_wgrad_plain)}
    for entry in logs:
        for k, v in entry.items():
            if k.startswith("loss") and not math.isfinite(v):
                raise AssertionError(f"{deriv}: non-finite {k} = {v} at step {entry['step']}")
    if min(counts.values()) < 1 or any(plain.values()):
        raise AssertionError(f"{deriv}: kernel launches {counts}, plain versions on CUDA {plain}")
    log(f"[main] {deriv}: {steps} steps, final loss {logs[-1]['loss']:.6f}, launches {counts}, "
        f"plain versions on CUDA {plain}")
    return logs, counts


def check_against_plain_path(solver, derivs):
    """Loss and parameter gradient on one batch: each kernel path in
    ``derivs`` vs the plain jet path (plain PyTorch on the card)."""
    import torch

    batches = solver._batches()
    results = {}
    for deriv in (*derivs, "jet"):
        with on_path(deriv):
            losses = solver._constraint_losses(batches)
            params = solver._params()
            grads = torch.autograd.grad(losses["PDE"], params)
        results[deriv] = (losses["PDE"].detach(), torch.cat([g.reshape(-1) for g in grads]))
    lp, gp = results["jet"]
    for deriv in derivs:
        lk, gk = results[deriv]
        loss_err = float((lk - lp).abs() / lp.abs())
        grad_err = float((gk - gp).norm() / gp.norm())
        log(f"[check] {deriv}: PDE loss kernels {float(lk):.8f} vs plain {float(lp):.8f} "
            f"(rel {loss_err:.2e}); gradient rel err {grad_err:.2e}")
        if not (loss_err < 1e-4 and grad_err < 1e-3):
            raise AssertionError(f"{deriv} disagrees with the plain jet path")


def time_kernels(errs, counts, steps, device_ms):
    """Per wrapper: ms, plain-version ms, bound and library ms at the main
    shape; ``device_ms`` (from the profile) gives the per-step device time of
    each kernel function a wrapper launches."""
    import torch

    from paddlescience_torch.ops import jet_mlp as J

    S, N, W, L = MAIN["S"], MAIN["N"], MAIN["W"], MAIN["L"]
    idx, streams, weights, biases, g_out = make_inputs(S, N, W, L)
    _, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True)
    _, gzs = J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx)
    ys = [streams] + [b.unbind(0) for b in bounds]
    mm_flops = L * S * 2.0 * N * W * W
    stream_bytes = S * N * W * 4.0
    w_bytes = L * (W * W + W) * 4.0

    rows = []

    def row(name, fn, plain, flops, nbytes, library=None, extra=None):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
        b, by = bound_ms(flops, nbytes)
        r = {"name": name, "route": "cuda", "source": f"paddlescience_torch/csrc/{name}.cu",
             "replaces": REPLACES[name], "launches": counts[name], "max_abs_err": errs[name],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
             "library_ms": cuda_ms(library) if library is not None else None,
             "device_ms_per_step": {fn: v for fn, v in device_ms.items() if fn.startswith(name)}}
        r.update(extra or {})
        rows.append(r)
        log(f"[timing] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b:.4f} ms by {by}"
            + (f", library {r['library_ms']:.4f} ms" if library is not None else "")
            + f"), launches per step {counts[name] / steps:.2f}")

    row("jet_mlp_fwd",
        lambda: J.jet_mlp_fwd(streams, weights, biases, idx),
        lambda: J.jet_mlp_fwd_plain(streams, weights, biases, idx),
        mm_flops, 2 * stream_bytes + w_bytes,
        extra={"ms_save_bounds": cuda_ms(lambda: J.jet_mlp_fwd(streams, weights, biases, idx, True))})
    row("jet_mlp_bwd",
        lambda: J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx),
        lambda: J.jet_mlp_bwd_plain(streams, bounds, weights, biases, g_out, idx),
        2 * mm_flops, (2 * L + 2) * stream_bytes + w_bytes)
    Y = torch.stack([torch.cat(y, 0) for y in ys])          # (L, S*N, W)
    GZ = torch.stack([g.reshape(S * N, W) for g in gzs])    # (L, S*N, W)
    row("jet_wgrad",
        lambda: J.jet_wgrad(ys, gzs),
        lambda: J.jet_wgrad_plain(ys, gzs),
        mm_flops + L * N * W, 2 * L * stream_bytes + w_bytes,
        library=lambda: torch.bmm(Y.transpose(1, 2), GZ))
    return rows


def profile_steps(solver, step_ms: float, steps: int = 5, top: int = 12) -> dict:
    """Device time per train step by kernel (torch.profiler), and the
    device's busy share of the unprofiled step time. Returns the ms per
    step of each device kernel of the port (a wrapper may launch more than
    one), by kernel function name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            solver.train_step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side kernels only: CPU-side ranges (aten ops, autograd
        # functions) and GPU user annotations (Optimizer.step) repeat the
        # time of the kernels inside them
        if getattr(e, "device_type", None) != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / steps / 1e3, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return {}
    log(f"[profile] device busy {busy:.3f} ms per step of {step_ms:.3f} ms wall "
        f"({100 * busy / step_ms:.1f}% busy, {100 * (1 - busy / step_ms):.1f}% idle); "
        f"{sum(r[1] for r in rows):.0f} kernels per step")
    port = {}
    for i, (ms, count, name) in enumerate(rows):
        fn = name.split("(")[0].split()[-1]
        if fn.startswith("jet_"):
            port[fn] = ms
        if i < top or fn.startswith("jet_"):
            log(f"[profile]   {ms:8.4f} ms  x{count:5.1f}  {name[:90]}")
    return port


REPLACES = {
    "jet_mlp_fwd": "paddlescience_tpu/ops/jet_pallas.py:361",
    "jet_mlp_bwd": "paddlescience_tpu/ops/jet_pallas.py:557",
    "jet_wgrad": "paddlescience_tpu/ops/jet_pallas.py:526",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddlescience_torch  # noqa: F401
        from paddlescience_torch.ops import cuda_build, jet_mlp as J
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 3
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build_logs = cuda_build.build()
    log(f"[build] {len(build_logs)} kernels built in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples.allen_cahn import build_solver

    # the driven paths, and the segment depths at which each runs the kernels
    solvers = {deriv: build_solver(deriv=deriv, log_freq=1, device="cuda") for deriv in PATHS}
    depths = {}
    for deriv, solver in solvers.items():
        with on_path(deriv):
            depths[deriv] = solver.model.jet_segment_lengths()
        if not depths[deriv]:
            raise AssertionError(f"{deriv} runs no fused segment")
    log(f"[kernels] segment depths per path: {depths}")

    errs = {"jet_mlp_fwd": 0.0, "jet_mlp_bwd": 0.0, "jet_wgrad": 0.0}
    for L in sorted({l for ls in depths.values() for l in ls}, reverse=True):
        for k, v in check_kernels(MAIN["S"], MAIN["N"], MAIN["W"], L).items():
            errs[k] = max(errs[k], v)
    check_kernels(MAIN["S"], MAIN["N"] - 1, MAIN["W"], MAIN["L"])

    solver = solvers["jet_pallas_full"]
    logs, counts = run_path(solver, "jet_pallas_full", PATHS["jet_pallas_full"])
    run_path(solvers["jet_pallas"], "jet_pallas", PATHS["jet_pallas"])
    deriv_path.set_default(deriv_path.CANDIDATES["jet_pallas_full"])
    check_against_plain_path(solver, tuple(PATHS))

    # steady-state step rate and launches per step on the main path
    solver.train_step()
    torch.cuda.synchronize()
    J.reset_counters()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        solver.train_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steady = {fn.__name__: fn.launches for fn in (J.jet_mlp_fwd, J.jet_mlp_bwd, J.jet_wgrad)}
    log(f"[timing] train step: {TIMED_STEPS / dt:.2f} steps/s ({dt / TIMED_STEPS * 1e3:.3f} ms/step), "
        f"launches per step {({k: v / TIMED_STEPS for k, v in steady.items()})}")
    device_ms = profile_steps(solver, dt / TIMED_STEPS * 1e3)
    rows = time_kernels(errs, steady, TIMED_STEPS, device_ms)
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        sys.exit(1)
