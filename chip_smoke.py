#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddlescience_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each fatal
on failure:

1. build   - compile every kernel of the driven paths from
             ``paddlescience_torch/csrc`` with nvcc for sm_90a, in parallel
             and in the background (nice 19) while the kernel-free
             [operators], [operators2], [earthformer], [koopman], [graphs]
             and [unetex] phases run;
2. kernels - hold each kernel against its plain PyTorch version (and the
             backwards against ``torch.autograd`` through the plain forward)
             on the card, at the main-path shapes and every depth a driven
             path runs: the Allen-Cahn MLP segment (tanh, S=4 streams,
             N=4096, W=256) at L=4 (jet_pallas_full), L=3 and L=1
             (jet_pallas); the gated segment for PirateNet groups of 9 and 3
             blocks and ModifiedMLP segments of 3 and 1 layers, in recompute
             and save-bounds mode; the aneurysm MLP segment (SiLU, S=7,
             N=2048, 3 -> 512 -> ... -> 512) at L=6 (jet_pallas_full) and
             3 + 3 (jet_pallas); all at a ragged N too; d alpha, summed by
             jet_wgrad, against jet_alpha_reduce_plain; two jet_wgrad calls
             bitwise equal (dW, db, d alpha) at the PirateNet and aneurysm
             shapes, two jet_gated_bwd calls bitwise equal (every output)
             on the PirateNet and ModifiedMLP programs, two jet_mlp_bwd
             calls bitwise equal at the aneurysm and MLP 4x256 shapes, two
             calls of each forward bitwise equal in both modes (PirateNet
             and ModifiedMLP programs; aneurysm and MLP 4x256); each
             kernel's largest error over the main-path checks;
             the MLP kernels at width 512 with S=5 (two 8-row tiles in the
             backward) and S=8 (one tile, the cotangent parked), 3 -> 512
             x 3 at a ragged N; the gated kernels
             at S=7, W=256, where the backward keeps one tile and parks
             the cotangent; every activation at S=4, W=256, L=2, ungated
             and as a ModifiedMLP program (the relu family by the
             either-side check of ``ops/kinks.py`` at kinks); the LBM
             kernel for 1 and 200 steps at 256 x 256 and 1 step at
             1000 x 1000;
3. main    - train the port's solvers at full width: the Allen-Cahn MLP
             4x256 on jet_pallas_full and jet_pallas (segments of 3+1
             layers), PirateNet 9 blocks x 256 on jet_pallas_full (one
             group) and jet_pallas (groups of 3), ModifiedMLP 4x256 on
             jet_pallas; the aneurysm MLP 6x512 (SiLU, weight norm, the
             3-D NavierStokes residual on 2048 points, three boundary and
             two integral constraints) on jet_pallas_full and jet_pallas;
             run the lid-driven cavity at 256 x 256, Re 400, for 1000
             steps; train the Allen-Cahn solver with cylinder2d's MLP 5x50
             on jet_pallas_full for 2 steps: its widths are no multiple of
             4, so its segment runs zero-padded to 52 through the MLP
             kernels. Each path's kernel launch counts are set to 0
             just before it and read just after. The aneurysm STLs are written
             by ``tools/gen_aneurysm_stl.py`` (run as a separate process)
             into ``dataset/aneurysm`` when they are missing;
4. check   - on one batch, the PDE loss and its gradient through the
             kernels, on each driven training path (MLP 5x50 too), agree
             with the plain-PyTorch jet path on the card;
   graph   - the Allen-Cahn example's run through its entry points:
             ``build_solver(arch="mlp", epochs=2, iters_per_epoch=200,
             eval_freq=1)`` and ``train()``, auto-fused into one chunk of
             K = 200 steps an epoch, captured once in a CUDA graph and
             replayed, eval against the ETDRK4 solution every epoch,
             ``best_model`` and ``latest`` saved; PirateNet 9x256 (3 chunks
             of 20) and the aneurysm (3 of 10) for one epoch; the launch
             counts set to 0 before each train() (a replay launches through
             no wrapper: the counts are the warm-up's and the capture's);
             ``eval()``: the final L2Rel, finite, and the aneurysm's residual
             validator through the forward kernel; two graphed chunks
             against eager steps across a GradNorm refresh (MLP 4x256 and
             PirateNet 9x256: parameters to 1e-6 relative, bitwise or not,
             the same generator state); three replays drawing three
             different batches; a run resumed from ``latest`` bitwise equal
             to an uninterrupted one; graphed against eager steps/s with
             device busy and idle per step, on one solver each;
   cylinder - the cylinder2d TIPC workload (``build_matched_solver``:
             299,280 points a step, MLP 5x50 zero-padded to 52) on
             jet_pallas_full: host build time; the MLP kernels at S=6,
             N=282,600 (and a ragged N) against their plain versions;
             3 eager steps through the kernels and the peak device
             memory; one batch's PDE loss and gradient against the plain
             jet path and against nested jvp; 2 graphed chunks of 10
             steps against 20 eager steps; graphed and eager steps/s (10
             eager steps timed),
             points/s, busy and capture time on jet_pallas_full and on
             the plain jet path;
   euler_beam - the example's ``train()`` for 30 of its 100 epochs of
             one 10-step graph: u, u_x, u_xx through the MLP kernels,
             u_xxx and the fourth-order residual by nested jvp inside the
             graph) and its L2Rel against the analytic solution; the
             boundary loss and gradient against the plain jet path and
             nested jvp; at the TIPC shape (100 + 4 points) graphed
             chunks against eager steps and the step rates;
   laplace2d, ldc2d, deeponet - each BASELINE example's ``train()`` at
             the JAX defaults with no derivative path pinned (laplace2d
             20 x 1 eager steps, ldc2d_steady 50 x 50 as 50-step graphs,
             DeepONet 100 x 32 eager steps over its indexed data set),
             the final metric (MSE.u, the residual MSE, L2Rel.G), graphed
             and eager steps/s of the same solver with device busy, and
             the peak memory; one DeepONet epoch as one 32-step graph
             (32 host batches staged a replay) bitwise equal to 32 eager
             steps;
   lbfgs    - ldc2d_steady with ``lbfgs=True`` (optax's L-BFGS with its
             zoom line search, a host loop a step) through ``train()`` for
             3 of the example's 50 epochs of 50 steps (cut for time), no
             path pinned: steps/s,
             value-and-gradient evaluations a step (mean, max), the
             residual MSEs, the peak memory; Adam then L-BFGS (50 steps
             from the ldc2d phase's Adam-trained parameters: the objective
             falls; the residual MSEs before and after); 3 L-BFGS steps on
             jet_pallas_full (the MLP kernels under every evaluation of the
             line search)
             against the plain jet path: losses within 1e-4, the stored
             gradient within 1e-3, the same evaluations;
   operators - BASELINE's operator config at the examples' defaults, one
             CUDA graph an epoch (``train(num_fused_steps=iters_per_epoch)``,
             the host batches staged a replay): Darcy TFNO (1100 samples
             generated on the host, 10 of the example's 300 epochs of 62
             steps, l2 every 10 epochs) and the Brusselator LNO (1000
             samples generated on the card, 2 of them held against the CPU
             generator within 1e-4 x max |u|; 10 of 300 epochs of 16
             steps, the decoded L2Rel);
             for each a graphed epoch against eager steps (1e-6), graphed
             and eager steps/s with device busy, the final metric;
   recipes  - the Allen-Cahn variants on the NTK aggregator at full width
             (``build_solver(**recipe(name))``, jet_pallas_full):
             default_ntk (MLP 4x256) and sota (ModifiedMLP 4x256, batch
             8192), ``train()`` for 2 epochs of one 150-step graph (NTK
             refreshed at each epoch's start), the NTK weights, L2Rel every
             epoch, graphed and eager steps/s with device busy;
   ldc      - the LDC Re-curriculum recipes (PirateNet 4x256, ModifiedMLP
             5x256, MLP 4x256) at full width and batch, cut to the first
             two stages (Re 100, 400) of one 100-step epoch each (the
             recipes' own: 1000), in graphs of 50 steps (the recipes'
             own: one graph an epoch, which takes a minute or more to
             capture): the
             cavity generator on the card (one 2000-step chunk at 33^2 as
             20 replays of a 100-step graph, against eager steps on the card within 1e-6 and
             against the CPU within 1e-5 x max), the two stages' reference
             fields solved on the card on a 65^2 grid (the recipes' own:
             257^2) and timed; the gated and MLP kernels against their plain
             versions at the recipes' shapes (S = 5, the 2-D NavierStokes
             jet: PirateNet 4 blocks at N = 4096, ModifiedMLP 5 layers at
             8192, MLP 2 -> 256 x 4 at 4096, and a ragged N);
             ``train_curriculum`` on jet_pallas_full (the state carried
             across stages; per stage steps/s, the GradNorm weights,
             L2Rel.U and the Ghia RMSE); 3 eager steps of each recipe on
             jet_pallas_full against the plain jet path (every per-key loss
             within 1e-4, each gradient within 1e-3) and the kernel
             launches per step; one graphed 10-step chunk of the PirateNet
             recipe against 10 eager steps (1e-6); graphed and eager
             steps/s with device busy;
   elasticity - the control arm (``examples/control_arm.py``: two MLPs
             6x512, SiLU, weight norm, in a ModelList; LinearElasticity in
             mixed form on the capsule-bar mesh, sdf-weighted interior
             residuals; each constraint samples one iteration's points,
             2048 interior and 128 + 128 + 512 boundary, where the example
             feeds batch x iters_per_epoch) at full width: the solver's
             build with the C++ ray cast and with its numpy version, and
             the aneurysm's 2048 interior points drawn by both (the same
             points, the sdf within 1e-6); the MLP kernels at its
             interior shape (S = 4: u, u_x, u_y, u_z; N = 2048 and 2047;
             3 -> 512 x 6, the weight-normed weights) against their plain
             versions and the
             S = 4 instances' registers and spills; no path pinned: the
             autotuner's pick; 3 steps on jet_pallas_full against the
             plain jet path (losses 1e-4, gradients 1e-3); two graphed
             chunks of 10 steps against 20 eager steps (1e-6);
             ``train()`` for 1 of the example's 2000 epochs (100-step
             graphs); graphed and eager steps/s; the inverse problem for 1
             of its 100 epochs on the trained networks, frozen (bitwise
             unchanged, no jet_mlp_bwd or jet_wgrad launched), the Lame
             networks moved, the validator's L2Rel; bracket_elasticity
             (two MLPs 4x64, 20,480 interior points a step) for 1 of its 30
             epochs: the autotuner's pick, ``train()``, the rates;
   viv      - the viv inverse problem at the JAX defaults (100 epochs of one
             20-step graph): the learnable k1, k2 finite and moved from
             their starting values, graphed and eager steps/s;
   transforms - the examples of arch input and output transforms and of
             the integral equations (poiseuille_flow, heat_pinn,
             ldc2d_unsteady_Re10, volterra_ide, biharmonic2d, gpinn,
             fractional_poisson_2d, bubble, and deephpms's three stages
             for burgers and ks) at their JAX defaults, no path pinned,
             train() cut (``TRANSFORM_EXAMPLES``, ``DEEPHPMS_RUN``): two graphed
             chunks of 2 steps against 4 eager steps (1e-6), train() with
             no kernel launched and no plain version on CUDA (a
             transformed net has no jet forward), the example's metric,
             graphed and eager steps/s with busy share and kernels a step;
   xpinn    - XPINN at the JAX defaults (three MLPs 2 -> 20 x 4, tanh,
             the Laplacian's 5-stream jet on 2000, 900, 900 residual rows
             and 100 on each interface): the MLP kernels at those rows
             against their plain versions; one batch's loss and gradient on
             jet_pallas_full (pinned whole) against the plain jet path and
             nested jvp (1e-4, 1e-3); per residual evaluation (7 a step)
             one launch of jet_mlp_bwd and jet_wgrad and two of
             jet_mlp_fwd (the backward's recompute); graphed chunks against eager
             steps (1e-6); 500 steps (10 graphs of 50) with the counters
             set to 0 just before, l2_rel; graphed and eager steps/s on
             jet_pallas_full and the plain jet path;
   hpinns   - hPINNs at the JAX defaults (three MLPs 15 -> 48 x 4, 1500 +
             5000 points, nested jvp): graphed chunks against eager steps;
             one outer iteration of 100 steps (graphs of 20) and the
             multiplier update in place; the PDE MSE and the objective;
             graphed and eager steps/s;
   operators2 - darcy_uno, catheter, fourcastnet, fourcastnet_finetune,
             sfno_swe, adv_cvit and ns_cvit through their solvers, epochs
             cut (``OPERATORS2_RUN``), yinglong and the velocity GAN
             through their hand loops: each model on the card against a
             copy on the CPU with the same weights (outputs and gradients
             within 1e-4 x their largest magnitude: cuFFT against pocketfft,
             the strided convs, the resizes), a graphed epoch (or chunk)
             against eager steps (1e-6), train() one graph an epoch, the
             metric (l2, L2Rel, RMSE and ACC, the rollout RMSEs, the GAN's
             L1), graphed and eager steps/s with device busy;
   earthformer - the ENSO Earthformer and ExtFormer-MoE (10 experts,
             top-4) at the reference ENSO pretrain width (12 -> 14 months
             at 24 x 48, base 64, batch 8, dropout 0.1) and SEVIR at its
             example's size: card against CPU in float64 (float32
             measured beside it), one graphed epoch against eager steps
             (bitwise expected; dropout and the gates' noise drawn inside
             the graph), the training randomness on in train mode and off
             in eval, train() in graphed chunks, eval() (RMSE, SEVIR's
             skill scores), steps/s, busy, kernels a step, peak memory;
   koopman - lorenz_koopman, both rossler stages and both
             physformer_lorenz stages (stage 1 a 60-step graph of its hand
             loop): a few graphed epochs, the loss and metric, steps/s,
             and the Physformer's rollout on the card against the CPU;
   graphs  - tgcn_pems through ``Solver.train`` in graphed epochs at the
             example's 16 sensors and at PEMSD4's 307 (full width, batch
             64; epochs cut, ``TGCN_EPOCHS``): card against CPU on one
             batch, a graphed epoch against eager steps, dropout on in
             train and off in eval, the val MAE; the fixed-order segment
             sum and gather (``nn/segment.py``) two calls bitwise equal,
             forward and backward, against ``index_add_`` and timed beside
             it at the AMGNet example's graph and a 4096-node kNN graph;
             the AMGNet (airfoil, cylinder), CFDGCN, GraphCast and CGCNN
             hand loops (one captured graph a sample graph): card against
             CPU on one sample, graphed against eager steps, the examples'
             steps with the loss falling, GraphCast's RMSE;
   unetex  - topopt and deepcfd_unetex through their solvers: card
             against CPU on one batch, a graphed epoch against eager
             steps, train(), Binary_Acc and IoU, the MSE; for every path
             of [graphs] and [unetex] graphed and eager steps/s with the
             spread of the timed calls, busy share, kernels a step and
             peak memory;
   misc    - the recurrent, misc and generative slice at the examples'
             full widths: epnn_elastoplastic, phygeonet, phygeonet_bc,
             iops, chip_heat (100 + 100 of its 500 + 500 fields),
             transformer4sr and regae through their solvers, and the
             hand loops phylstm_seismic (types 2 and 3), phycrnet_burgers
             and tempogan_lite, whose 16 frames come from 800 LBM steps
             through the lbm_collide_stream kernel (launched, no plain
             version on CUDA, the frames within 1e-4 of lbm_step_plain's
             on the card; the kernel timed at 64 x 64): card against CPU
             on one batch in float32 and float64, a graphed chunk bitwise
             the eager steps (cuDNN deterministic where a model has
             convolutions), the metric or the loss (a hand loop's fallen),
             graphed and eager steps/s (3 calls of a chunk and of 5 eager
             steps; chip_heat 2 calls and phylstm 3 of 1 eager step, their
             eager steps not profiled; median and range), busy share,
             kernels a step and peak memory; tempogan_lite's launches
             count in the LBM kernel's row;
   autotune - ``solver/autotune.py::autotune`` (K = 3, 2 replays a
             candidate, a temporary cache) on the Allen-Cahn MLP 4x256,
             PirateNet 9x256, the aneurysm, cylinder2d matched,
             euler_beam, laplace2d and ldc2d_steady: every candidate's
             ms/step, the winner the argmin, the kernel candidates
             through their kernels, the solver's state bitwise unchanged,
             a second call served from the cache without timing;
5. timing  - train steps per second of the Allen-Cahn MLP, PirateNet and
             ModifiedMLP solvers and of the aneurysm solver; device time per step by
             kernel and the device's busy share (torch.profiler); per
             kernel: time, plain-version time, bound, library time, at the
             Allen-Cahn shapes and, for the MLP kernels, at the aneurysm's
             (jet_mlp_bwd also at its unsteady S=8) and at the cylinder
             workload's (S=6, N=282,600, 3 -> 52 x 5), at the LDC
             recipes' (S=5: PirateNet 4 blocks, ModifiedMLP 5 layers, MLP
             2 -> 256 x 4) and at the control arm's (SiLU, S=4, N=2048,
             3 -> 512 x 6), heart's, aneurysm_flow's, nsfnet net 3's and
             XPINN's (tanh, S=5, N=2000, 2 -> 20 x 4);
             jet_wgrad over the 27 PirateNet layers beside one torch.mm a
             layer (the library time of every jet_wgrad row) and torch.bmm, with
             and without the d alpha sum and against a separate sum (and
             that sum alone: jet_alpha_reduce_plain and Tensor.sum(0));
             jet_gated_fwd and jet_gated_bwd on the PirateNet stages
             without gates and residuals, and so the share of the
             elementwise traffic, and jet_gated_bwd on the PirateNet
             program at S=6, 7 (parked) and 8 (W=64, 128); every jet
             kernel instance's registers and spills (-Xptxas -v). The
             forwards' bound is that of their 3xTF32 tensor-core route
             (3 TF32 products per float32 product at 495 TFLOP/s, or the
             bytes), with the float32 one (67 TFLOP/s) beside it.
6. radar  - DGMR at the reference defaults (4 context frames of 256^2
             -> 18, latent 768, context 384, 53.6M generator parameters,
             batch 2) as a grid-cell hand loop, NowcastNet at the JAX
             defaults (9 of 29 frames at 512^2, ngf 32, batch 2) through
             the Solver on RadarDataset, MoFlow at the example's and the
             reference QM9 depth (10 bond, 27 atom blocks, hidden 128):
             graphed chunks bitwise the eager steps (cuDNN deterministic),
             card against CPU in float32 and float64 on one sample (DGMR's
             sampler cut to 2 forecast steps, NowcastNet on a 256^2 field,
             in float32 its evolution network and its generative half
             apart, the latter fed the CPU's float64 advected frames),
             graphed and eager steps/s (median and range of 3 calls), busy
             share, kernels a step, peak memory and seconds by part; the
             18 frames scored by DGMRDiscriminator (spatial 4, temporal 3
             layers); whether torch.linalg.slogdet (and its backward) and
             solve can be captured in a CUDA graph and repeat bitwise
             (MoFlow's train step runs graphed: a refused capture of
             slogdet fails the phase; solve's is recorded); the dgmr,
             nowcastnet_radar, moflow_qm9 and moflow_optimize examples at
             their own configurations with their checks (the grid-cell
             loss not above the first step's, the round trip within
             1e-4). Last: NowcastNet at 512^2 leaves the card's memory
             pools large and fragmented.

Tolerance (kernels against plain versions): the float32 sums run in
another order, so each output may differ by at most 1e-4 times the largest
magnitude of the reference tensor (``REL_TOL``). d alpha, a sum of
S * N * W signed products that largely cancel, is held to 1e-4 times the
larger of its reference and sqrt(S * N * W).

The line before the last holds the card's name and power limit; the line
before it a JSON object ``{"kernels": [...]}``; the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
CUDA is unavailable or the port is not beside this script.

``python3 chip_smoke.py --only xpinn,hpinns,operators2,earthformer,koopman,graphs,unetex,misc,radar``
runs only the named phases (a probe: it prints their summaries and no
result line); it waits for the kernel build only when a named phase
launches a kernel of the port.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

REL_TOL = 1e-4
FP32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
HBM_BYTES = 3.35e12  # H100 SXM device-memory rate
MAIN = dict(S=4, N=4096, W=256, L=4)
ANEURYSM = dict(N=2048, dims=(3,) + (512,) * 6)  # the interior batch and the hidden layers' widths
NS3D = [(0,), (1,), (2,), (0, 0), (1, 1), (2, 2)]  # the 3-D NavierStokes jet: S = 7 streams
ACT_CHECK = dict(S=4, N=1024, W=256)  # the shape at which every activation is checked
# driven training paths: name -> (build_solver arguments, derivative path, train steps)
PATHS = {
    "mlp/jet_pallas_full": (dict(arch="mlp"), "jet_pallas_full", 10),
    "mlp/jet_pallas": (dict(arch="mlp"), "jet_pallas", 3),
    "piratenet/jet_pallas_full": (dict(arch="piratenet", piratenet_blocks=9), "jet_pallas_full", 20),
    "piratenet/jet_pallas": (dict(arch="piratenet", piratenet_blocks=9), "jet_pallas", 3),
    "modified_mlp/jet_pallas": (dict(arch="modified_mlp"), "jet_pallas", 3),
    # one aneurysm solver drives both paths (its host sampling takes seconds)
    "aneurysm/jet_pallas_full": (None, "jet_pallas_full", 5),
    "aneurysm/jet_pallas": (None, "jet_pallas", 3),
}
# paths that are timed and profiled
TIMED = ("mlp/jet_pallas_full", "piratenet/jet_pallas_full", "modified_mlp/jet_pallas", "aneurysm/jet_pallas_full")
# cylinder2d's MLP 5x50 (bench.py:165): widths that are no multiple of 4, run zero-padded to 52
PADDED = dict(arch="mlp", num_layers=5, hidden_size=50)
PADDED_PATH, PADDED_STEPS = "mlp_5x50/jet_pallas_full", 2
# the constraint whose loss and gradient each kernel path is held to the plain jet path on
PDE_CONSTRAINT = {"mlp": "PDE", "mlp_5x50": "PDE", "piratenet": "PDE", "modified_mlp": "PDE", "aneurysm": "interior",
                  "cylinder": "EQ", "euler_beam": "BC", "nsfnet net 3": "EQ"}
# the cylinder2d TIPC workload (bench.py:148-207) at its full size: MLP 5x50 (padded to 52) on
# 282,600 + 4,830 + 2,430 + 9,420 points a step; its residual jet has S = 6 streams (u, u_t, u_x,
# u_xx, u_y, u_yy); the kernels are checked at its interior batch and at a second ragged N
CYLINDER = dict(S=6, N=282600, points=299280, dims=(3,) + (52,) * 5, check_n=(282600, 9419), eager_steps=3, K=10,
                replays=3)
CYLINDER_PATH = "cylinder/jet_pallas_full"
# euler_beam: the example's train() (EULER_RUN epochs x 10 steps, one graph of 10 steps
# an epoch), then the TIPC shape (one iteration per epoch: 100 + 4 points a step) in graphed chunks
EULER_TIPC_K, EULER_REPLAYS = 10, 5
EULER_RUN = dict(epochs=30)  # of the example's 100 x 10 (cut for the script's time)
HERE = os.path.dirname(os.path.abspath(__file__))
STL_DIR = os.path.join(HERE, "dataset", "aneurysm")  # listed in .gitignore
CAVITY = dict(nx=256, ny=256, re=400.0, u_lid=0.1, steps=1000)
LBM_TIMED = 2048  # lattice edge at which the LBM kernel is timed
TIMED_STEPS = 10  # eager steps timed against the graphed chunks (cut for the script's time)
T0 = 0.0  # when main() started
KERNELS = ("jet_mlp_fwd", "jet_mlp_bwd", "jet_wgrad", "jet_gated_fwd", "jet_gated_bwd", "lbm_collide_stream")
# kernel instance -> [registers, spill store bytes, spill load bytes], per jet kernel
PTXAS = {"jet_mlp_fwd": {}, "jet_gated_fwd": {}, "jet_mlp_bwd": {}, "jet_gated_bwd": {}, "jet_wgrad": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


_MARK = [None]


def mark(phase: str) -> None:
    """Log the seconds since the previous mark (the first: since the start
    of main), so each phase's share of the script's time is in the log."""
    now = time.perf_counter()
    since = _MARK[0] if _MARK[0] is not None else T0
    log(f"[time] {phase}: {now - since:.1f} s ({now - T0:.1f} s in all)")
    _MARK[0] = now


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


def tc_bound_ms(flops: float, nbytes: float):
    """The bound of a float32 product on the 3xTF32 tensor-core route: three
    TF32 products per float32 one at the TF32 peak, or the bytes."""
    t_ops, t_bytes = 3 * flops / TF32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(got, ref) -> float:
    return float((got - ref).abs().max())


def check_close(what: str, got, ref) -> float:
    err, scale = max_err(got, ref), float(ref.abs().max())
    if not math.isfinite(err) or err > REL_TOL * max(scale, 1e-30):
        raise AssertionError(f"{what}: max abs err {err:.3e} > {REL_TOL} * {scale:.3e}")
    return err


def jet_index(S):
    """A jet of S streams: the Allen-Cahn index (u, u_t, u_x, u_xx) cut to
    S <= 4 (what a driven path runs), a 2-D second-order one at S = 5, 6,
    the 3-D NavierStokes one at S = 7 (the aneurysm's), with u_xy at S = 8;
    above, the order <= 2 multi-indices of 3, 4 or 5 inputs (:func:`order2`)."""
    from paddlescience_torch.autodiff import jet

    if S <= 4:
        return jet.build_index([(0,), (1,), (1, 1)][: S - 1])
    if S <= 6:
        return jet.build_index([(0,), (1,), (0, 0), (1, 1), (0, 1)][: S - 1])
    if S <= 8:
        return jet.build_index(NS3D + [(0, 1)] * (S - 7))
    return jet.build_index(order2(3 if S <= 10 else 4 if S <= 15 else 5)[: S - 1])


def order2(d):
    """Every multi-index of order 1 and 2 of d inputs, singles first: at
    d = 3 the 3-D Hooke jet (S = 10), at d = 4 the (x, y, z, t) one (15)."""
    return [(i,) for i in range(d)] + [(i, j) for i in range(d) for j in range(i, d)]


def make_inputs(S, N, dims, seed=0):
    """A segment's inputs on the card: S streams (N, dims[0]), layers
    dims[l] -> dims[l + 1], output cotangents (N, dims[-1])."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    L = len(dims) - 1
    streams = [rn(N, dims[0]) for _ in range(S)]
    weights = [rn(dims[l], dims[l + 1]) / math.sqrt(dims[l]) for l in range(L)]
    biases = [0.1 * rn(dims[l + 1]) for l in range(L)]
    g_out = [rn(N, dims[-1]) for _ in range(S)]
    return jet_index(S), streams, weights, biases, g_out


def act_name(act) -> str:
    from paddlescience_torch.autodiff import jet

    return jet.ACT_NAMES[act[0]] + (f"({act[1]})" if act[1] else "")


def check_kernels(S, N, dims, act=None, log_it=True, params=None, index=None):
    """Kernels against plain versions at one shape, activation ``act``
    (tanh when None), with random layers or the (weights, biases) of
    ``params`` and the jet of ``index`` (``jet_index(S)`` when None);
    returns max abs errors. For the relu family the
    forward and backward outputs are held by the either-side check of
    ``ops/kinks.py`` (a row with a pre-activation within float32 rounding
    of a kink may take either side, at the same limit), and the checks
    after it run on output cotangents that are 0 on those rows, which makes
    them independent of the side taken."""
    import torch

    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J
    from paddlescience_torch.ops import kinks as K

    act = act or J.TANH
    idx, streams, weights, biases, g_out = make_inputs(S, N, dims)
    if params is not None:
        weights, biases = params
    idx = index or idx
    L = len(dims) - 1
    tag = f"{act_name(act)} S={S} N={N} dims={dims[0]}->{'x'.join(map(str, dims[1:]))}"
    errs = {"jet_mlp_fwd": 0.0, "jet_mlp_bwd": 0.0, "jet_wgrad": 0.0}
    ref_outs, ref_bounds = J.jet_mlp_fwd_plain(streams, weights, biases, idx, save_bounds=True, act=act)
    outs, _ = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=False, act=act)
    outs_sb, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True, act=act)
    if act[0] in K.KINKS:
        case = dict(y=streams, u=[], v=[], ws=weights, bs=biases, alphas=[], g_out=g_out, bounds=ref_bounds)
        ref = dict(zip(("out", "bound", "g_y", "gz"), (ref_outs, ref_bounds, *J.jet_mlp_bwd_plain(
            streams, ref_bounds, weights, biases, g_out, idx, act))))
        g_in, gzs = J.jet_mlp_bwd(streams, ref_bounds, weights, biases, g_out, idx, act)
        for o in (outs, outs_sb):
            K.kink_aware_close(case, {"out": o, "bound": bounds, "g_y": g_in, "gz": gzs}, ref, G.mlp_program(L), idx,
                               act, REL_TOL)
        g_out = K.zero_rows(g_out, K.kink_rows(case, G.mlp_program(L), idx, act))
    else:
        for s in range(S):
            errs["jet_mlp_fwd"] = max(errs["jet_mlp_fwd"],
                                      check_close(f"fwd {tag} out[{s}]", outs[s], ref_outs[s]),
                                      check_close(f"fwd(save) {tag} out[{s}]", outs_sb[s], ref_outs[s]))
        for l, (b, rb) in enumerate(zip(bounds, ref_bounds)):
            errs["jet_mlp_fwd"] = max(errs["jet_mlp_fwd"], check_close(f"fwd {tag} bound[{l}]", b, rb))

    ref_gin, ref_gz = J.jet_mlp_bwd_plain(streams, ref_bounds, weights, biases, g_out, idx, act)
    g_in, gzs = J.jet_mlp_bwd(streams, ref_bounds, weights, biases, g_out, idx, act)
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
    o, _ = J.jet_mlp_fwd_plain(leaves[:S], leaves[S : S + L], leaves[S + L :], idx, act=act)
    auto = torch.autograd.grad(sum((a * g).sum() for a, g in zip(o, g_out)), leaves)
    k_dw, k_db = J.jet_wgrad(ys, gzs)
    for what, got, ref in zip(("g_in",) * S + ("dW",) * L + ("db",) * L, (*g_in, *k_dw, *k_db), auto):
        check_close(f"kernels vs autograd {tag} {what}", got, ref)
    torch.cuda.synchronize()
    if log_it:
        log(f"[kernels] {tag}: max abs err fwd {errs['jet_mlp_fwd']:.3e} bwd {errs['jet_mlp_bwd']:.3e} "
            f"wgrad {errs['jet_wgrad']:.3e}")
    return errs


def make_gated_inputs(S, N, W, program, seed=1):
    """Inputs of a gated segment on the card; alphas drawn in (0.1, 0.9)
    (alpha = 0, the PirateNet init, would zero every block gradient)."""
    import torch

    from paddlescience_torch.ops import jet_gated as G

    gen = torch.Generator(device="cuda").manual_seed(seed)
    idx = jet_index(S)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    L = len(program)
    y, u, v, g_out = ([rn(N, W) for _ in range(S)] for _ in range(4))
    weights = [rn(W, W) / math.sqrt(W) for _ in range(L)]
    biases = [0.1 * rn(W) for _ in range(L)]
    alphas = [0.1 + 0.8 * torch.rand(1, generator=gen, device="cuda") for op in program if op & G.RESIDUAL]
    return idx, y, u, v, weights, biases, alphas, g_out


def alpha_tol(ref, n_terms: int) -> float:
    return REL_TOL * max(float(ref.abs().max()), math.sqrt(n_terms))


def check_gated_kernels(S, N, W, program, tag, act=None, log_it=True):
    """Gated forward (recompute and save-bounds), backward and the
    weight-gradient and d alpha sums of its outputs (one jet_wgrad call)
    against the plain versions and against torch.autograd through the plain
    forward, activation ``act`` (tanh when None); returns max abs errors
    (d alpha's sum against jet_alpha_reduce_plain under "d_alpha")."""
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J
    from paddlescience_torch.ops import kinks as K

    act = act or J.TANH
    kinky = act[0] in K.KINKS
    idx, y, u, v, weights, biases, alphas, g_out = make_gated_inputs(S, N, W, program)
    L = len(program)
    tag = f"{tag} {act_name(act)} S={S} N={N} W={W} L={L}"
    errs = {"jet_gated_fwd": 0.0, "jet_gated_bwd": 0.0, "jet_wgrad": 0.0, "d_alpha": 0.0}

    def hold(key, what, got, ref):
        errs[key] = max(errs[key], check_close(f"{what} {tag}", got, ref))

    ref_outs, ref_bounds = G.jet_gated_fwd_plain(y, u, v, weights, biases, alphas, program, idx, True, act)
    outs, none = G.jet_gated_fwd(y, u, v, weights, biases, alphas, program, idx, False, act)
    outs_sb, bounds = G.jet_gated_fwd(y, u, v, weights, biases, alphas, program, idx, True, act)
    if none or len(bounds) != len(ref_bounds):
        raise AssertionError(f"{tag}: {len(none)} / {len(bounds)} boundaries, expected 0 / {len(ref_bounds)}")
    if kinky:  # the either-side check; what follows runs on cotangents that are 0 on the kink rows
        names = ("g_y", "g_u", "g_v", "gz", "in")
        case = dict(y=y, u=u, v=v, ws=weights, bs=biases, alphas=alphas, g_out=g_out, bounds=ref_bounds)
        got = G.jet_gated_bwd(y, u, v, ref_bounds, weights, biases, alphas, g_out, program, idx, act)
        ref = G.jet_gated_bwd_plain(y, u, v, ref_bounds, weights, biases, alphas, g_out, program, idx, act)
        for o in (outs, outs_sb):
            K.kink_aware_close(case, {"out": o, "bound": bounds, **dict(zip(names, got[:5]))},
                               {"out": ref_outs, "bound": ref_bounds, **dict(zip(names, ref[:5]))}, program, idx,
                               act, REL_TOL)
        g_out = K.zero_rows(g_out, K.kink_rows(case, program, idx, act))
    else:
        for s in range(S):
            hold("jet_gated_fwd", f"fwd out[{s}]", outs[s], ref_outs[s])
            hold("jet_gated_fwd", f"fwd(save) out[{s}]", outs_sb[s], ref_outs[s])
        for l, (b, rb) in enumerate(zip(bounds, ref_bounds)):
            hold("jet_gated_fwd", f"fwd bound[{l}]", b, rb)

    ref = G.jet_gated_bwd_plain(y, u, v, ref_bounds, weights, biases, alphas, g_out, program, idx, act)
    got = G.jet_gated_bwd(y, u, v, ref_bounds, weights, biases, alphas, g_out, program, idx, act)
    for name, gs, rs in zip(("g_y", "g_u", "g_v", "gz"), got[:4], ref[:4]):
        if len(gs) != len(rs):
            raise AssertionError(f"{tag}: {len(gs)} {name} tensors, expected {len(rs)}")
        for k, (g, r) in enumerate(zip(gs, rs)):
            hold("jet_gated_bwd", f"bwd {name}[{k}]", g, r)
    if not kinky:  # the layer inputs are values: held by the either-side check above for the relu family
        for l, (g, r) in enumerate(zip(got[4], ref[4])):
            hold("jet_gated_bwd", f"bwd layer input[{l}]", torch.stack(g), torch.stack(r))
    dws, dbs, d_alpha = J.jet_wgrad(got[4], got[3], alpha_partials=got[5])
    if alphas:
        hold("d_alpha", "d alpha vs jet_alpha_reduce_plain", d_alpha, G.jet_alpha_reduce_plain(got[5]))
        err = max_err(d_alpha, ref[5])
        if not err <= alpha_tol(ref[5], S * N * W):
            raise AssertionError(f"d alpha {tag}: max abs err {err:.3e} > {alpha_tol(ref[5], S * N * W):.3e}")
        errs["jet_gated_bwd"] = max(errs["jet_gated_bwd"], err)
    ref_dw, ref_db = J.jet_wgrad_plain(ref[4], ref[3])
    for l in range(L):
        hold("jet_wgrad", f"wgrad dW[{l}]", dws[l], ref_dw[l])
        hold("jet_wgrad", f"wgrad db[{l}]", dbs[l], ref_db[l])

    # the autograd.Function (both modes) against torch.autograd through the plain forward
    groups = (y, u, v, weights, biases, alphas)
    leaves = [[t.clone().requires_grad_() for t in ts] for ts in groups]
    o, _ = G.jet_gated_fwd_plain(*leaves, program, idx, act=act)
    flat = [t for ts in leaves for t in ts]
    auto = torch.autograd.grad(sum((a * g).sum() for a, g in zip(o, g_out)), flat)
    for save_bounds in (False, True):
        lv = [[t.clone().requires_grad_() for t in ts] for ts in groups]
        out = G.jet_gated_segment(jet.Jet(lv[0], idx), jet.Jet(lv[1], idx), jet.Jet(lv[2], idx), lv[3], lv[4],
                                  lv[5], program, save_bounds=save_bounds, act=act)
        kern = torch.autograd.grad(sum((a * g).sum() for a, g in zip(out.streams, g_out)),
                                   [t for ts in lv for t in ts])
        n_alpha = len(alphas)
        for k, (g, r) in enumerate(zip(kern, auto)):
            if k >= len(auto) - n_alpha:
                if not max_err(g, r) <= alpha_tol(r, S * N * W):
                    raise AssertionError(f"kernels vs autograd {tag} d alpha: {float(g)} vs {float(r)}")
            else:
                check_close(f"kernels vs autograd {tag} (save_bounds={save_bounds}) leaf {k}", g, r)
    torch.cuda.synchronize()
    if log_it:
        log(f"[kernels] {tag}: max abs err " + " ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def check_wgrad_repeat():
    """Two jet_wgrad calls on the same inputs give bitwise the same dW, db
    and d alpha: the PirateNet group of 9 blocks with its d alpha partials,
    and the aneurysm's 6-layer segment (narrow units for its 3 inputs)."""
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J

    S, N, W = MAIN["S"], MAIN["N"], MAIN["W"]
    program = G.piratenet_program(9)
    idx, y, u, v, weights, biases, alphas, g_out = make_gated_inputs(S, N, W, program)
    _, bounds = G.jet_gated_fwd(y, u, v, weights, biases, alphas, program, idx, save_bounds=True)
    *_, gzs, ins, partials = G.jet_gated_bwd(y, u, v, bounds, weights, biases, alphas, g_out, program, idx)
    cases = {"piratenet 9 blocks": (ins, gzs, partials)}
    silu = (jet.SILU, 0.0)
    idx, streams, weights, biases, g_out = make_inputs(len(NS3D) + 1, ANEURYSM["N"], ANEURYSM["dims"])
    _, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True, act=silu)
    _, gzs = J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx, silu)
    cases["aneurysm"] = ([streams] + [b.unbind(0) for b in bounds], gzs, None)
    flat = lambda out: [t for part in out for t in (part if isinstance(part, tuple) else (part,))]
    for name, (ys, gzs, partials) in cases.items():
        first = flat(J.jet_wgrad(ys, gzs, alpha_partials=partials))
        second = flat(J.jet_wgrad(ys, gzs, alpha_partials=partials))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"jet_wgrad {name}: two calls on the same inputs differ")
    log(f"[kernels] jet_wgrad: two calls bitwise equal (dW, db, d alpha) at {', '.join(cases)}")


def check_gated_bwd_repeat():
    """Two jet_gated_bwd calls on the same inputs give bitwise the same
    outputs (g_y, g_u, g_v, every gz and layer input, the d alpha
    partials), on the PirateNet group of 9 blocks and the ModifiedMLP
    program of 4 layers, at a ragged batch."""
    import torch

    from paddlescience_torch.ops import jet_gated as G

    S, N, W = MAIN["S"], MAIN["N"] - 1, MAIN["W"]
    flat = lambda out: [out] if isinstance(out, torch.Tensor) else [t for part in out for t in flat(part)]
    programs = {"piratenet 9 blocks": G.piratenet_program(9), "modified_mlp 4": G.modified_mlp_program(4)}
    for name, program in programs.items():
        idx, y, u, v, weights, biases, alphas, g_out = make_gated_inputs(S, N, W, program)
        _, bounds = G.jet_gated_fwd(y, u, v, weights, biases, alphas, program, idx, save_bounds=True)
        args = (y, u, v, bounds, weights, biases, alphas, g_out, program, idx)
        first, second = flat(G.jet_gated_bwd(*args)), flat(G.jet_gated_bwd(*args))
        torch.cuda.synchronize()
        if not (len(first) == len(second) > 0 and all(torch.equal(a, b) for a, b in zip(first, second))):
            raise AssertionError(f"jet_gated_bwd {name}: two calls on the same inputs differ")
    log("[kernels] jet_gated_bwd: two calls bitwise equal (every output) on the piratenet 9-block and "
        "modified_mlp 4-layer programs")


def check_mlp_bwd_repeat():
    """Two jet_mlp_bwd calls on the same inputs give bitwise the same input
    cotangents and gz: the aneurysm's 6-layer segment (SiLU, S = 7, 8-row
    tiles, the cotangent parked) and the Allen-Cahn MLP 4x256 (tanh, S = 4,
    two 16-row tiles), at ragged batches."""
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_mlp as J

    cases = {"aneurysm": (len(NS3D) + 1, ANEURYSM["N"] - 1, ANEURYSM["dims"], (jet.SILU, 0.0)),
             "mlp 4x256": (MAIN["S"], MAIN["N"] - 1, (MAIN["W"],) * (MAIN["L"] + 1), J.TANH)}
    for name, (S, N, dims, act) in cases.items():
        idx, streams, weights, biases, g_out = make_inputs(S, N, dims)
        _, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True, act=act)
        first = J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx, act)
        second = J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx, act)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip([*first[0], *first[1]], [*second[0], *second[1]])):
            raise AssertionError(f"jet_mlp_bwd {name}: two calls on the same inputs differ")
    log(f"[kernels] jet_mlp_bwd: two calls bitwise equal (input cotangents, every gz) at {', '.join(cases)}")


def check_fwd_repeat():
    """Two calls of each forward on the same inputs give bitwise the same
    outputs and boundaries, in both modes: jet_gated_fwd on the PirateNet
    group of 9 blocks and the ModifiedMLP program of 4 layers, jet_mlp_fwd
    on the aneurysm's 6-layer segment (SiLU, S = 7, 8-row tiles) and the
    Allen-Cahn MLP 4x256 (tanh, S = 4, 16-row tiles), at ragged batches."""
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J

    S, N, W = MAIN["S"], MAIN["N"] - 1, MAIN["W"]
    calls = {}
    for name, program in (("piratenet 9 blocks", G.piratenet_program(9)), ("modified_mlp 4", G.modified_mlp_program(4))):
        idx, y, u, v, weights, biases, alphas, _ = make_gated_inputs(S, N, W, program)
        args = (y, u, v, weights, biases, alphas, program, idx)
        calls[f"jet_gated_fwd {name}"] = lambda sb, args=args: G.jet_gated_fwd(*args, save_bounds=sb)
    for name, (S_, N_, dims, act) in (("aneurysm", (len(NS3D) + 1, ANEURYSM["N"] - 1, ANEURYSM["dims"], (jet.SILU, 0.0))),
                                      ("mlp 4x256", (S, N, (W,) * (MAIN["L"] + 1), J.TANH))):
        idx, streams, weights, biases, _ = make_inputs(S_, N_, dims)
        calls[f"jet_mlp_fwd {name}"] = (lambda sb, a=(streams, weights, biases, idx), act=act:
                                        J.jet_mlp_fwd(*a, save_bounds=sb, act=act))
    for name, call in calls.items():
        for sb in (False, True):
            first, second = call(sb), call(sb)
            torch.cuda.synchronize()
            a, b = [*first[0], *first[1]], [*second[0], *second[1]]
            if not (len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))):
                raise AssertionError(f"{name} (save_bounds={sb}): two calls on the same inputs differ")
    log(f"[kernels] forwards: two calls bitwise equal (outputs and boundaries, both modes) at {', '.join(calls)}")


def ptxas_by_function(text: str):
    """(registers, spill store bytes, spill load bytes) by kernel function
    from nvcc's -Xptxas -v report."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out.setdefault(fn, [None, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, [None, 0, 0])[0] = int(m.group(1))
    return out


def make_lattice(ny, nx, seed=0):
    """A perturbed equilibrium lattice on the card: every direction and
    wall in play."""
    import torch

    from paddlescience_torch.ops import lbm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda: torch.randn(ny, nx, generator=gen, device="cuda")
    return lbm._equilibrium(1.0 + 0.05 * rn(), 0.05 * rn(), 0.05 * rn())


def check_lbm_kernel(ny, nx, steps, tau=0.62, u_lid=0.1):
    import torch

    from paddlescience_torch.ops import lbm

    got = ref = make_lattice(ny, nx)
    err = check_close(f"lbm_collide_stream {ny}x{nx}", lbm.lbm_collide_stream(got, tau),
                      lbm.lbm_collide_stream_plain(ref, tau))
    for _ in range(steps):
        got = lbm.lbm_step(got, tau, u_lid)
        ref = lbm.lbm_step_plain(ref, tau, u_lid)
    torch.cuda.synchronize()
    err = max(err, check_close(f"lbm {ny}x{nx} {steps} steps", got, ref))
    log(f"[kernels] lbm_collide_stream {ny}x{nx}, {steps} step(s): max abs err {err:.3e}")
    return err


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


def reset_counts() -> None:
    from paddlescience_torch.ops import jet_gated, jet_mlp, lbm

    for mod in (jet_mlp, jet_gated, lbm):
        mod.reset_counters()


def read_counts():
    """(kernel launches by kernel name, plain-version calls on CUDA tensors)."""
    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J
    from paddlescience_torch.ops import lbm

    wrappers = {"jet_mlp_fwd": J.jet_mlp_fwd, "jet_mlp_bwd": J.jet_mlp_bwd, "jet_wgrad": J.jet_wgrad,
                "jet_gated_fwd": G.jet_gated_fwd, "jet_gated_bwd": G.jet_gated_bwd,
                "lbm_collide_stream": lbm.lbm_collide_stream}
    plains = (J.jet_mlp_fwd_plain, J.jet_mlp_bwd_plain, J.jet_wgrad_plain, J.jet_alpha_reduce_plain,
              G.jet_gated_fwd_plain, G.jet_gated_bwd_plain, lbm.lbm_collide_stream_plain)
    return ({name: fn.launches for name, fn in wrappers.items()},
            {fn.__name__: fn.cuda_calls for fn in plains})


def expected_kernels(path: str):
    """The kernels a driven path must launch."""
    if path.startswith(("mlp/", "aneurysm/", "mlp_5x50/", "cylinder/", "euler_beam/", "recipes/default_ntk",
                        "ldc/re1000_plain", "elasticity/", "heart/", "aneurysm_flow/", "toolkit/")):
        return ("jet_mlp_fwd", "jet_mlp_bwd", "jet_wgrad")
    if path.startswith(("piratenet/", "modified_mlp/", "recipes/sota", "ldc/re3200")):
        return ("jet_gated_fwd", "jet_gated_bwd", "jet_wgrad")
    return ("lbm_collide_stream",)


def check_counts(path: str, counts, plain, steps: int = 1) -> None:
    """Every kernel of the path launched at least once a step; no plain
    version ran on CUDA tensors."""
    missing = [k for k in expected_kernels(path) if counts[k] < steps]
    if missing or any(plain.values()):
        raise AssertionError(f"{path}: kernels not launched {missing}; launches {counts}; "
                             f"plain versions on CUDA {plain}")


def run_path(solver, path: str, deriv: str, steps: int):
    """Train ``steps`` steps on ``deriv`` with the launch counters set to 0
    just before; returns (logs, counts)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path

    deriv_path.set_default(deriv_path.CANDIDATES[deriv])
    torch.cuda.synchronize()
    reset_counts()
    logs = solver.train_steps(steps)
    torch.cuda.synchronize()
    counts, plain = read_counts()
    for entry in logs:
        for k, v in entry.items():
            if k.startswith("loss") and not math.isfinite(v):
                raise AssertionError(f"{path}: non-finite {k} = {v} at step {entry['step']}")
    check_counts(path, counts, plain, steps)
    log(f"[main] {path}: {steps} steps, final loss {logs[-1]['loss']:.6f}, launches "
        f"{ {k: v for k, v in counts.items() if v} }, plain versions on CUDA {sum(plain.values())}")
    return logs, counts


def run_cavity_path():
    """The lid-driven cavity through the LBM kernel: finite fields of the
    lattice's shape, mass kept, the lid dragging the fluid in +x."""
    import torch

    from paddlescience_torch.ops import lbm

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rho, ux, uy = lbm.run_cavity(**CAVITY)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    check_counts("cavity", counts, plain)
    for name, field in (("rho", rho), ("ux", ux), ("uy", uy)):
        if tuple(field.shape) != (CAVITY["ny"], CAVITY["nx"]) or not bool(torch.isfinite(field).all()):
            raise AssertionError(f"cavity: {name} has shape {tuple(field.shape)} or non-finite values")
    mass, drag = float(rho.mean()), float(ux[-2].mean())
    if abs(mass - 1.0) > 0.05 or not drag > 0:
        raise AssertionError(f"cavity: mean density {mass}, mean ux under the lid {drag}")
    log(f"[main] cavity {CAVITY}: {dt:.2f} s ({CAVITY['steps'] / dt:.0f} steps/s), mean rho {mass:.6f}, "
        f"mean ux under the lid {drag:.5f}, launches {counts['lbm_collide_stream']}, "
        f"plain versions on CUDA {sum(plain.values())}")
    return counts


def run_padded_path():
    """The Allen-Cahn solver with MLP 5x50 on jet_pallas_full: its widths
    are no multiple of 4, so its one 5-layer segment runs zero-padded to 52
    through the MLP kernels. Every step must launch them, with finite
    losses; on one batch its PDE loss and gradient must agree with the
    plain jet path's. Returns the launch counts."""
    from paddlescience_torch.examples.allen_cahn import build_solver

    solver = build_solver(deriv="jet_pallas_full", log_freq=1, device="cuda", **PADDED)
    with on_path("jet_pallas_full"):
        lengths = solver.model.jet_segment_lengths()
    if lengths != [PADDED["num_layers"]]:
        raise AssertionError(f"{PADDED_PATH}: segments {lengths}, expected one of {PADDED['num_layers']} layers")
    _, counts = run_path(solver, PADDED_PATH, "jet_pallas_full", PADDED_STEPS)
    check_against_plain_path(solver, "mlp_5x50", ("jet_pallas_full",), ())
    return counts


def check_against_plain_path(solver, name: str, derivs, parts=("alpha", "embed_u", "embed_v"), refs=("jet",)):
    """PDE loss and parameter gradient on one batch: each kernel path in
    ``derivs`` vs each reference path in ``refs`` (the plain jet path,
    plain PyTorch on the card; ``jvp``, nested jvp of the plain forward),
    over all parameters and for the parameters named by ``parts`` alone
    (PirateNet's gates and residuals, the weight-normed layers' g, v and
    biases)."""
    import torch

    batches = solver._batches()
    names = [n for n, p in solver.model.named_parameters() if p.requires_grad]
    pde = PDE_CONSTRAINT[name]
    results = {}
    for deriv in (*derivs, *refs):
        with on_path(deriv):
            losses = solver._constraint_losses(batches)
            grads = torch.autograd.grad(losses[pde], solver._params())
        results[deriv] = (losses[pde].detach(), grads)
    for ref in refs:
        lp, gp = results[ref]
        rel = lambda gk, keep: float(
            torch.cat([(a - b).reshape(-1) for a, b, n in zip(gk, gp, names) if keep(n)]).norm()
            / torch.cat([b.reshape(-1) for b, n in zip(gp, names) if keep(n)]).norm())
        for deriv in derivs:
            lk, gk = results[deriv]
            loss_err = float((lk - lp).abs() / lp.abs())
            errs = {"all": rel(gk, lambda n: True)}
            for part in parts:
                if any(part in n for n in names):
                    errs[part] = rel(gk, lambda n, _p=part: _p in n)
            log(f"[check] {name} {deriv} vs {ref}: {pde} loss {float(lk):.8f} vs {float(lp):.8f} "
                f"(rel {loss_err:.2e}); gradient rel err " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            if not (loss_err < 1e-4 and all(v < 1e-3 for v in errs.values())):
                raise AssertionError(f"{name} {deriv} disagrees with the {ref} path")


def gated_bound(S, N, W, program):
    """(forward FLOPs, forward bytes, backward FLOPs, backward bytes) of a
    gated segment: matrix products only (the elementwise rules add under
    1%); every input read once, every output written once."""
    from paddlescience_torch.ops import jet_gated as G

    L = len(program)
    inner = sum(1 for l, op in enumerate(program) if l > 0 and not op & G.STAGE)
    stages = L - inner
    mm = S * 2.0 * N * W * W
    stream = S * N * W * 4.0
    w_bytes = L * (W * W + W) * 4.0
    fwd = (L * mm, 4 * stream + w_bytes)  # y, u, v in; out
    # backward: 2 products per layer (z and gz @ W^T); reads y, u, v, g_out and the stages - 1
    # boundaries; writes g_y, g_u, g_v, L gz and the inner layer inputs
    bwd = (2 * L * mm, (4 + stages - 1 + 3 + L + inner) * stream + w_bytes)
    return fwd + bwd


def gated_args(S, N, W, program):
    """The gated kernels' arguments at one shape (``make_gated_inputs``):
    (forward arguments, backward arguments with the forward's saved
    bounds)."""
    from paddlescience_torch.ops import jet_gated as G

    idx, y, u, v, weights, biases, alphas, g_out = make_gated_inputs(S, N, W, program)
    _, bounds = G.jet_gated_fwd(y, u, v, weights, biases, alphas, program, idx, save_bounds=True)
    return ((y, u, v, weights, biases, alphas, program, idx),
            (y, u, v, bounds, weights, biases, alphas, g_out, program, idx))


def time_mlp_shape(rows, key, S, N, dims, act, per_step, index=None):
    """The MLP kernels' rows (the first three of ``rows``) at one more
    shape, under ``key``: time, plain-version time, bound, the library time
    (for jet_wgrad one ``torch.mm`` a layer with the streams folded into
    the inner dimension, Y_l^T GZ_l of (S*N, K) and (S*N, J); beside it
    ``torch.bmm`` over the layers after the first, whose input is the few
    coordinates) and ``per_step[name]``, the launches per step. Returns
    (FLOPs, stream bytes per layer boundary, weight bytes) of the forward
    for further bounds."""
    import torch

    from paddlescience_torch.ops import jet_mlp as J

    L = len(dims) - 1
    idx, streams, weights, biases, g_out = make_inputs(S, N, dims)
    idx = index or idx
    _, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True, act=act)
    _, gzs = J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx, act)
    ys = [streams] + [b.unbind(0) for b in bounds]
    flops = sum(S * 2.0 * N * dims[l] * dims[l + 1] for l in range(L))
    stream = [S * N * d * 4.0 for d in dims]
    w = sum((dims[l] * dims[l + 1] + dims[l + 1]) * 4.0 for l in range(L))
    Y = torch.stack([torch.cat(y, 0) for y in ys[1:]])  # (L - 1, S*N, width)
    GZ = torch.stack([g.reshape(S * N, -1) for g in gzs[1:]])
    Ys, GZs = [torch.cat(y, 0) for y in ys], [g.reshape(S * N, -1) for g in gzs]  # per layer (S*N, K), (S*N, J)
    work = {
        "jet_mlp_fwd": (lambda: J.jet_mlp_fwd(streams, weights, biases, idx, act=act),
                        lambda: J.jet_mlp_fwd_plain(streams, weights, biases, idx, act=act),
                        flops, stream[0] + stream[-1] + w, None),
        "jet_mlp_bwd": (lambda: J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx, act),
                        lambda: J.jet_mlp_bwd_plain(streams, bounds, weights, biases, g_out, idx, act),
                        2 * flops, 2 * stream[0] + 2 * sum(stream[1:]) + w, None),
        "jet_wgrad": (lambda: J.jet_wgrad(ys, gzs), lambda: J.jet_wgrad_plain(ys, gzs),
                      flops + L * N * dims[-1], sum(stream[:-1]) + sum(stream[1:]) + w,
                      lambda: [torch.mm(a.T, b) for a, b in zip(Ys, GZs)]),
    }
    for r in rows[:3]:
        fn, plain, fl, nbytes, library = work[r["name"]]
        ms, plain_ms = cuda_ms(fn, 10), cuda_ms(plain, 3, 1)
        b, by = (tc_bound_ms if r["name"] in TC_KERNELS else bound_ms)(fl, nbytes)
        r[key] = {"shape": f"{act_name(act)} S={S} N={N} dims={'->'.join(map(str, dims))}", "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                  "library_ms": cuda_ms(library, 10) if library is not None else None,
                  "launches_per_step": per_step[r["name"]]}
        if r["name"] == "jet_mlp_fwd":
            r[key]["ms_save_bounds"] = cuda_ms(lambda: J.jet_mlp_fwd(streams, weights, biases, idx, True, act), 10)
            r[key]["bound_ms_fp32"] = bound_ms(fl, nbytes)[0]
        if r["name"] == "jet_wgrad":
            r[key]["library_ms_bmm_after_the_first_layer"] = cuda_ms(lambda: torch.bmm(Y.transpose(1, 2), GZ), 10)
        log(f"[timing] {r['name']} at the {key} shape: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b:.4f} ms "
            f"by {by}" + (f", library {r[key]['library_ms']:.4f} ms" if library is not None else "")
            + (f" (one torch.mm a layer; torch.bmm over the layers after the first "
               f"{r[key]['library_ms_bmm_after_the_first_layer']:.4f} ms)" if r["name"] == "jet_wgrad" else "")
            + f"), launches per step {per_step[r['name']]}")
    del Y, GZ, Ys, GZs, ys, gzs, bounds, streams
    torch.cuda.empty_cache()
    return flops, stream, w


def time_kernels(errs, launches, device_ms):
    """Per wrapper: ms, plain-version ms, bound and library ms. The jet MLP
    kernels at the Allen-Cahn MLP path's shape (tanh, L=4) and, under the
    key "aneurysm", at the aneurysm path's (SiLU, S=7, the 6-layer
    segment); the gated kernels at the PirateNet path's (one group of 9
    blocks, L=27), the LBM kernel at LBM_TIMED^2 (and at the cavity's
    lattice, extra keys); ``device_ms`` (from the profiles) gives the
    per-step device time of each kernel function a wrapper launches,
    ``launches`` the counts per driven path."""
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J
    from paddlescience_torch.ops import lbm

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the torch.bmm yardsticks would not be float32")
    S, N, W, L = MAIN["S"], MAIN["N"], MAIN["W"], MAIN["L"]
    rows = []
    steps = {p: PATHS[p][2] for p in launches if p in PATHS}

    def row(name, source, fn, plain, flops, nbytes, library=None, extra=None, reps=20):
        ms, plain_ms = cuda_ms(fn, reps), cuda_ms(plain, reps)
        b, by = (tc_bound_ms if name in TC_KERNELS else bound_ms)(flops, nbytes)
        r = {"name": name, "route": "cuda", "source": f"paddlescience_torch/csrc/{source}.cu",
             "replaces": REPLACES[name], "launches": sum(c[name] for c in launches.values()),
             "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
             "library_ms": cuda_ms(library, reps) if library is not None else None,
             "launches_by_path": {p: c[name] for p, c in launches.items() if c[name]},
             "device_ms_per_step": {p: {fn: v for fn, v in d.items() if fn.startswith(name)}
                                    for p, d in device_ms.items()}}
        if name in TC_KERNELS:
            r["bound_ms_fp32"] = bound_ms(flops, nbytes)[0]
            r["registers_spills"] = PTXAS[name]
        r.update(extra or {})
        rows.append(r)
        log(f"[timing] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b:.4f} ms by {by}"
            + (f" (3xTF32; float32 {r['bound_ms_fp32']:.4f} ms)" if name in TC_KERNELS else "")
            + (f", library {r['library_ms']:.4f} ms" if library is not None else "") + ")")

    idx, streams, weights, biases, g_out = make_inputs(S, N, (W,) * (L + 1))
    _, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True)
    _, gzs = J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx)
    ys = [streams] + [b.unbind(0) for b in bounds]
    mm_flops = L * S * 2.0 * N * W * W
    stream_bytes = S * N * W * 4.0
    w_bytes = L * (W * W + W) * 4.0
    row("jet_mlp_fwd", "jet_mlp_fwd",
        lambda: J.jet_mlp_fwd(streams, weights, biases, idx),
        lambda: J.jet_mlp_fwd_plain(streams, weights, biases, idx),
        mm_flops, 2 * stream_bytes + w_bytes,
        extra={"ms_save_bounds": cuda_ms(lambda: J.jet_mlp_fwd(streams, weights, biases, idx, True))})
    row("jet_mlp_bwd", "jet_mlp_bwd",
        lambda: J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx),
        lambda: J.jet_mlp_bwd_plain(streams, bounds, weights, biases, g_out, idx),
        2 * mm_flops, (2 * L + 2) * stream_bytes + w_bytes)
    Y = torch.stack([torch.cat(y, 0) for y in ys])          # (L, S*N, W)
    GZ = torch.stack([g.reshape(S * N, W) for g in gzs])    # (L, S*N, W)
    # the library yardstick: one torch.mm a layer, the streams folded into the inner dimension
    row("jet_wgrad", "jet_wgrad",
        lambda: J.jet_wgrad(ys, gzs),
        lambda: J.jet_wgrad_plain(ys, gzs),
        mm_flops + L * N * W, 2 * L * stream_bytes + w_bytes,
        library=lambda: [torch.mm(Y[l].T, GZ[l]) for l in range(L)],
        extra={"library_ms_bmm": cuda_ms(lambda: torch.bmm(Y.transpose(1, 2), GZ))})
    # the gated kernels on the same ungated program and inputs: what the MLP path would pay for them
    ungated = G.mlp_program(L)
    rows[0]["gated_kernel_ms"] = cuda_ms(lambda: G.jet_gated_fwd(streams, (), (), weights, biases, (), ungated, idx))
    rows[1]["gated_kernel_ms"] = cuda_ms(
        lambda: G.jet_gated_bwd(streams, (), (), bounds, weights, biases, (), g_out, ungated, idx))
    log(f"[timing] the gated kernels on the ungated {L}-layer program: fwd {rows[0]['gated_kernel_ms']:.4f} ms "
        f"(jet_mlp_fwd {rows[0]['ms']:.4f}), bwd {rows[1]['gated_kernel_ms']:.4f} ms "
        f"(jet_mlp_bwd {rows[1]['ms']:.4f})")
    del Y, GZ, ys, gzs, bounds

    # the MLP kernels at the aneurysm shape: SiLU, S = 7, N = 2048, the six hidden layers as one segment
    silu = (jet.SILU, 0.0)
    dims = ANEURYSM["dims"]
    S7, NA = len(NS3D) + 1, ANEURYSM["N"]
    per_step = {name: {p: launches[p][name] / steps[p] for p in launches if p.startswith("aneurysm/")}
                for name in ("jet_mlp_fwd", "jet_mlp_bwd", "jet_wgrad")}
    a_flops, a_stream, a_w = time_mlp_shape(rows, "aneurysm", S7, NA, dims, silu, per_step)
    rows[1]["aneurysm"]["registers_spills"] = PTXAS["jet_mlp_bwd"]
    # jet_mlp_bwd at the unsteady aneurysm's S = 8 (its NavierStokes jet adds u_xy), the same widths
    S8 = S7 + 1
    idx, streams, weights, biases, g_out = make_inputs(S8, NA, dims)
    _, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True, act=silu)
    r = rows[1]["aneurysm"]
    r["ms_S8"] = cuda_ms(lambda: J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx, silu), 10)
    r["bound_ms_S8"] = bound_ms(2 * a_flops * S8 / S7, (2 * a_stream[0] + 2 * sum(a_stream[1:])) * S8 / S7 + a_w)[0]
    log(f"[timing] jet_mlp_bwd at the aneurysm widths, S={S8}: {r['ms_S8']:.4f} ms (bound {r['bound_ms_S8']:.4f} ms)")
    del bounds, streams

    program = G.piratenet_program(9)
    args, bargs = gated_args(S, N, W, program)
    y, _, _, bounds, weights, biases, _, g_out, _, idx = bargs
    f_flops, f_bytes, b_flops, b_bytes = gated_bound(S, N, W, program)
    row("jet_gated_fwd", "jet_gated_fwd",
        lambda: G.jet_gated_fwd(*args), lambda: G.jet_gated_fwd_plain(*args), f_flops, f_bytes, reps=5,
        extra={"program": "piratenet 9 blocks (L=27)",
               "ms_save_bounds": cuda_ms(lambda: G.jet_gated_fwd(*args, save_bounds=True), 5)})
    # the same stages with no gate and no residual: the products and the jet rule alone
    bare = tuple(op & G.STAGE for op in program)
    r = rows[-1]
    r["ms_without_gates_and_residuals"] = cuda_ms(
        lambda: G.jet_gated_fwd(y, (), (), weights, biases, (), bare, idx), 10)
    r["ms_elementwise_share"] = r["ms"] - r["ms_without_gates_and_residuals"]
    log(f"[timing] jet_gated_fwd, the same stages without gates and residuals: "
        f"{r['ms_without_gates_and_residuals']:.4f} ms; elementwise share (gates, residuals) "
        f"{r['ms_elementwise_share']:.4f} ms")
    row("jet_gated_bwd", "jet_gated_bwd",
        lambda: G.jet_gated_bwd(*bargs), lambda: G.jet_gated_bwd_plain(*bargs), b_flops, b_bytes, reps=5,
        extra={"program": "piratenet 9 blocks (L=27)"})
    # the same stages with no gate and no residual: the products, gz and layer inputs alone
    r = rows[-1]
    r["ms_without_gates_and_residuals"] = cuda_ms(
        lambda: G.jet_gated_bwd(y, (), (), bounds, weights, biases, (), g_out, bare, idx), 5)
    r["ms_elementwise_share"] = r["ms"] - r["ms_without_gates_and_residuals"]
    r["registers_spills"] = PTXAS["jet_gated_bwd"]
    log(f"[timing] jet_gated_bwd, the same stages without gates and residuals: "
        f"{r['ms_without_gates_and_residuals']:.4f} ms; elementwise share (gates, residuals) "
        f"{r['ms_elementwise_share']:.4f} ms")
    # the PirateNet program at the other stream counts: S = 6 (the widest S with two tiles at 256),
    # S = 7 (one tile, the cotangent parked) and S = 8 at narrow widths
    r["ms_by_shape"], r["bound_ms_by_shape"] = {}, {}
    for s_, w_ in ((6, W), (7, W), (8, 64), (8, 128)):
        key = f"S={s_} W={w_}" + (" parked" if J.bwd_parks(s_, [w_]) else "")
        _, ba_ = gated_args(s_, N, w_, program)
        r["ms_by_shape"][key] = cuda_ms(lambda: G.jet_gated_bwd(*ba_), 5)
        r["bound_ms_by_shape"][key] = bound_ms(*gated_bound(s_, N, w_, program)[2:])[0]
        del ba_
    log("[timing] jet_gated_bwd, PirateNet 9 blocks at other stream counts: " + ", ".join(
        f"{k} {v:.4f} ms (bound {r['bound_ms_by_shape'][k]:.4f})" for k, v in r["ms_by_shape"].items()))
    # jet_wgrad over the 27 layers of the group, as the PirateNet backward calls it (with the d alpha
    # partials), without them, and without them followed by a separate sum of d alpha; in turns
    *_, gzs27, ins27, partials = G.jet_gated_bwd(*bargs)
    Y = torch.stack([torch.cat(y, 0) for y in ins27])          # (27, S*N, W)
    GZ = torch.stack([g.reshape(S * N, W) for g in gzs27])
    with_alpha = lambda: J.jet_wgrad(ins27, gzs27, alpha_partials=partials)
    without = lambda: J.jet_wgrad(ins27, gzs27)
    separate = lambda: (J.jet_wgrad(ins27, gzs27), partials.sum(0))
    turns = [(k, cuda_ms(f, 20)) for k, f in (("with", with_alpha), ("without", without), ("separate", separate),
                                              ("separate", separate), ("without", without), ("with", with_alpha))]
    t0 = time.perf_counter()
    for _ in range(20):
        with_alpha()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    r = rows[2]
    r["ms_27_layers"] = [ms for k, ms in turns if k == "with"]
    r["ms_27_layers_without_d_alpha"] = [ms for k, ms in turns if k == "without"]
    r["ms_27_layers_then_separate_d_alpha_sum"] = [ms for k, ms in turns if k == "separate"]
    r["host_ms_per_call_27_layers"] = host_ms
    r["bound_ms_27_layers"] = bound_ms(27 * S * 2.0 * N * W * W, 2 * 27 * stream_bytes + 27 * (W * W + W) * 4.0)[0]
    r["library_ms_27_layers"] = cuda_ms(lambda: [torch.mm(Y[l].T, GZ[l]) for l in range(27)], 20)
    r["library_ms_27_layers_bmm"] = cuda_ms(lambda: torch.bmm(Y.transpose(1, 2), GZ), 20)
    r["d_alpha_max_abs_err"] = errs["d_alpha"]
    r["d_alpha_plain_ms"] = cuda_ms(lambda: J.jet_alpha_reduce_plain(partials))
    r["d_alpha_library_ms"] = cuda_ms(lambda: partials.sum(0))
    r["d_alpha_partials_shape"] = list(partials.shape)
    log(f"[timing] jet_wgrad over the 27 PirateNet layers (one launch, with d alpha): {r['ms_27_layers']} ms, "
        f"without d alpha {r['ms_27_layers_without_d_alpha']} ms, then a separate partials.sum(0) "
        f"{r['ms_27_layers_then_separate_d_alpha_sum']} ms; host {host_ms:.4f} ms per call; bound "
        f"{r['bound_ms_27_layers']:.4f} ms; one torch.mm a layer {r['library_ms_27_layers']:.4f} ms, torch.bmm "
        f"{r['library_ms_27_layers_bmm']:.4f} ms; inputs gz + layer "
        f"inputs {2 * 27 * stream_bytes / 1e6:.0f} MB; d alpha vs jet_alpha_reduce_plain max abs err "
        f"{errs['d_alpha']:.3e} (plain jet_alpha_reduce_plain {r['d_alpha_plain_ms']:.4f} ms, library "
        f"Tensor.sum(0) {r['d_alpha_library_ms']:.4f} ms, partials {tuple(partials.shape)})")
    del Y, GZ, gzs27, ins27, bounds

    tau, u_lid = 0.62, 0.1
    f_big = make_lattice(LBM_TIMED, LBM_TIMED)
    f_cav = make_lattice(CAVITY["ny"], CAVITY["nx"])
    cells = lambda f: f.shape[1] * f.shape[2]
    # ~100 FLOPs a cell; the lattice read once and written once
    row("lbm_collide_stream", "lbm_collide_stream",
        lambda: lbm.lbm_collide_stream(f_big, tau), lambda: lbm.lbm_collide_stream_plain(f_big, tau),
        100.0 * cells(f_big), 2 * 9 * cells(f_big) * 4.0,
        extra={"shape": f"{LBM_TIMED}x{LBM_TIMED}",
               "ms_whole_step": cuda_ms(lambda: lbm.lbm_step(f_big, tau, u_lid)),
               "plain_ms_whole_step": cuda_ms(lambda: lbm.lbm_step_plain(f_big, tau, u_lid)),
               "ms_cavity_lattice": cuda_ms(lambda: lbm.lbm_collide_stream(f_cav, tau)),
               "ms_whole_step_cavity_lattice": cuda_ms(lambda: lbm.lbm_step(f_cav, tau, u_lid)),
               "plain_ms_whole_step_cavity_lattice": cuda_ms(lambda: lbm.lbm_step_plain(f_cav, tau, u_lid)),
               "bound_ms_cavity_lattice": bound_ms(100.0 * cells(f_cav), 2 * 9 * cells(f_cav) * 4.0)[0]})
    r = rows[-1]
    log(f"[timing] lbm_step (kernel + walls and lid in plain ops): {r['ms_whole_step']:.4f} ms at "
        f"{LBM_TIMED}x{LBM_TIMED} (plain {r['plain_ms_whole_step']:.4f} ms); at the cavity's lattice kernel "
        f"{r['ms_cavity_lattice']:.4f} ms, step {r['ms_whole_step_cavity_lattice']:.4f} ms "
        f"(plain {r['plain_ms_whole_step_cavity_lattice']:.4f} ms)")
    return rows


def profile_steps(solver, name: str, step_ms: float, steps: int = 5, top: int = 12, run=None,
                  steps_per_run: int = 1):
    """Device time per train step by kernel (torch.profiler), and the
    device's busy share of the unprofiled step time ``step_ms``, over
    ``steps`` calls of ``run`` (default ``solver.train_step``), each
    ``steps_per_run`` train steps. Returns (the ms per step of each device
    kernel of the port (a wrapper may launch more than one) by kernel
    function name, device busy ms per step, kernels per step); busy None
    when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = run or solver.train_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    steps *= steps_per_run
    # the raw events, summed by name: key_averages() would first build the
    # profiler's Python event tree, about 0.1 ms an event (10 s for one
    # replay of a graph of 100,000 kernels). Device-side events only:
    # CPU-side ranges (aten ops, autograd functions) and GPU user
    # annotations (Optimizer.step) repeat the time of the kernels inside
    # them; asynchronous events count no time, as in key_averages()
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation() or e.is_async()
                or e.start_thread_id() != e.end_thread_id() or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        ns, count = totals.get(e.name(), (0, 0))
        totals[e.name()] = (ns + e.duration_ns(), count + 1)
    rows = [(ns / steps / 1e6, count / steps, name) for name, (ns, count) in totals.items() if ns > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log(f"[profile] {name}: the profiler recorded no device time: not measured")
        return {}, None, 0
    log(f"[profile] {name}: device busy {busy:.3f} ms per step of {step_ms:.3f} ms wall "
        f"({100 * busy / step_ms:.1f}% busy, {100 * (1 - busy / step_ms):.1f}% idle); "
        f"{sum(r[1] for r in rows):.0f} kernels per step")
    port = {}
    for i, (ms, count, kname) in enumerate(rows):
        fn = re.sub(r"<.*", "", kname.split("(")[0]).split()[-1]  # "void f<7, 8>(P)" -> "f"
        ours = fn.startswith(("jet_", "lbm_"))
        if ours:
            port[fn] = port.get(fn, 0.0) + ms
        if i < top or ours:
            log(f"[profile]   {ms:8.4f} ms  x{count:5.1f}  {kname[:90]}")
    return port, busy, sum(r[1] for r in rows)


def time_steps(solver, name: str, steps: int = TIMED_STEPS):
    """Steady-state step rate and launches per step; returns (ms per step,
    launches over ``steps`` steps)."""
    import torch

    solver.train_step()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        solver.train_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, _ = read_counts()
    log(f"[timing] {name} train step: {steps / dt:.2f} steps/s ({dt / steps * 1e3:.3f} ms/step), "
        f"launches per step { {k: v / steps for k, v in counts.items() if v} }")
    return dt / steps * 1e3, counts


# ------------------------------------------------------- the graphed run --

# the Allen-Cahn example's train(): epochs of one auto-fused chunk (K = iters_per_epoch) each, eval every epoch
GRAPH_MLP = dict(arch="mlp", epochs=2, iters_per_epoch=200, eval_freq=1)
# one epoch of a few chunks: (build arguments, K)
GRAPH_PIRATENET = (dict(arch="piratenet", piratenet_blocks=9, epochs=1, iters_per_epoch=60), 20)
GRAPH_ANEURYSM = (dict(epochs=1, iters_per_epoch=30), 10)
CHECK_K = 8  # graphed against eager: 2 chunks of 8 steps, a GradNorm refresh (update_freq 8) between them
RESUME_K = 10  # resume: 1 epoch of one 10-step chunk saved, then the second epoch
GRAPH_TIMED = {"mlp": 2, "piratenet": 2, "aneurysm": 3}  # replays timed per solver


def graph_train(solver, name: str, num_fused_steps=None):
    """``solver.train()`` on the card with the launch counters set to 0 just
    before: every kernel of the path launched (at the warm-up and the
    capture; a replay launches through no wrapper), none of the plain
    versions, finite losses, the checkpoints written. Returns the counts."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logged = solver.train(num_fused_steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    check_counts(f"{name}/graph", counts, plain)
    bad = [e for e in logged if not all(math.isfinite(v) for k, v in e.items() if k.startswith("loss"))]
    if bad or not logged:
        raise AssertionError(f"{name}: non-finite or no logged losses {bad or logged}")
    (k, stats), = solver.graph_stats.items()
    steps = solver.epochs * solver.iters_per_epoch
    if stats["replays"] != steps // k:
        raise AssertionError(f"{name}: {stats['replays']} replays of {k} steps for {steps} steps")
    ckpts = sorted(os.listdir(os.path.join(solver.output_dir, "checkpoints")))
    if "latest" not in ckpts:
        raise AssertionError(f"{name}: checkpoints {ckpts}, no latest")
    log(f"[graph] {name}: train() {solver.epochs} epoch(s) x {solver.iters_per_epoch} steps, K={k} steps a graph, "
        f"warm-up {stats['warmup_s']:.2f} s, capture {stats['capture_s']:.2f} s, {stats['replays']} replays; "
        f"{dt:.2f} s in all (evals and checkpoints included); final loss {logged[-1]['loss']:.6f}; checkpoints "
        f"{ckpts}; best {solver.best_metric}; launches at the warm-up and capture "
        f"{ {n: v for n, v in counts.items() if v} }, plain versions on CUDA {sum(plain.values())}")
    return counts


def graph_solver(arch_kwargs, k, **extra):
    from paddlescience_torch.examples.allen_cahn import build_solver

    args = dict(deriv="jet_pallas_full", with_validator=False, output_dir=None, update_freq=k, device="cuda")
    return build_solver(**{**args, **arch_kwargs, **extra})


def flat_params(solver):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in solver.model.parameters()])


def check_graph_against_eager(name: str, arch_kwargs, k=CHECK_K):
    """The same seed and state through 2 chunks of k steps graphed and 2k
    eager steps, with a GradNorm refresh at step 0 and between the chunks
    (update_freq = k): parameters to 1e-6 relative (and whether bitwise),
    the same generator state and aggregator weights."""
    import torch

    graphed, eager = graph_solver(arch_kwargs, k), graph_solver(arch_kwargs, k)
    for _ in range(2):
        graphed.train_chunk(k)
    eager.train_steps(2 * k)
    torch.cuda.synchronize()
    a, b = flat_params(graphed), flat_params(eager)
    rel = float((a - b).norm() / b.norm())
    same_gen = torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    w_a, w_b = graphed.agg_state["weight"], eager.agg_state["weight"]
    w_rel = float((w_a - w_b).abs().max() / w_b.abs().max())
    log(f"[graph] {name}: 2 graphed chunks of {k} steps vs {2 * k} eager steps, GradNorm refreshed at steps 0 and "
        f"{k}: parameters rel err {rel:.3e}, bitwise {torch.equal(a, b)}; generator state equal {same_gen}; "
        f"GradNorm weights {w_a.tolist()} vs {w_b.tolist()} (rel {w_rel:.3e}); step {graphed.step} / {eager.step}")
    if not (rel <= 1e-6 and same_gen and w_rel <= 1e-6 and graphed.step == eager.step == 2 * k):
        raise AssertionError(f"{name}: the graphed chunks disagree with the eager steps")


def check_batches_change(k=CHECK_K):
    """Consecutive replays draw new collocation batches: the PDE batch is
    copied out inside the graph and read after each replay."""
    import torch

    solver = graph_solver(dict(arch="mlp"), 1000)
    ds = solver.constraint["PDE"].dataset
    draw, seen = ds.sample_fn, {}

    def spy(gen):
        out = draw(gen)
        for key, v in out[0].items():
            seen.setdefault(key, torch.empty_like(v)).copy_(v)
        return out

    ds.sample_fn = spy
    batches = []
    for _ in range(3):
        solver.train_chunk(k)
        batches.append({key: v.clone() for key, v in seen.items()})
    torch.cuda.synchronize()
    same = [key for key in batches[0] for i in range(2) if torch.equal(batches[i][key], batches[i + 1][key])]
    if same or solver.graph_stats[k]["replays"] != 3:
        raise AssertionError(f"replays drew the same batch ({same}) or did not replay: {solver.graph_stats}")
    log(f"[graph] batches: 3 replays of {k} steps, each last step's PDE batch (t, x) differs from the previous "
        f"replay's (t[:3] {[round(float(v), 5) for v in batches[0]['t'][:3, 0]]} -> "
        f"{[round(float(v), 5) for v in batches[1]['t'][:3, 0]]})")


def check_resume(tmp: str, k=RESUME_K):
    """One epoch of one graphed chunk saved as ``latest``, a new solver
    built from it (``checkpoint_path``) trains the second epoch: bitwise the
    parameters, Adam state, GradNorm weights, generator state, step and
    last_epoch of one uninterrupted two-epoch run."""
    import torch

    kw = dict(arch="mlp", iters_per_epoch=k)
    first = graph_solver(kw, k, epochs=1, output_dir=os.path.join(tmp, "first"))
    first.train()
    latest = os.path.join(tmp, "first", "checkpoints", "latest")
    resumed = graph_solver(kw, k, epochs=2, output_dir=os.path.join(tmp, "resumed"), checkpoint_path=latest)
    if resumed.last_epoch != 1 or resumed.step != k:
        raise AssertionError(f"resume: last_epoch {resumed.last_epoch}, step {resumed.step}")
    resumed.train()
    whole = graph_solver(kw, k, epochs=2, output_dir=os.path.join(tmp, "whole"))
    whole.train()
    torch.cuda.synchronize()
    sa, sb = resumed.state_dict(), whole.state_dict()
    diff = [f"params.{n}" for n in sa["params"] if not torch.equal(sa["params"][n], sb["params"][n])]
    diff += [f"opt.{i}.{key}" for i in sa["opt_state"] for key in sa["opt_state"][i]
             if not torch.equal(sa["opt_state"][i][key], sb["opt_state"][i][key])]
    diff += [key for key in ("generator",) if not torch.equal(sa[key], sb[key])]
    diff += ["agg"] * (not torch.equal(sa["agg_state"]["weight"], sb["agg_state"]["weight"]))
    diff += ["step/last_epoch"] * (not (sa["step"] == sb["step"] == 2 * k and resumed.last_epoch == whole.last_epoch == 2))
    if diff:
        raise AssertionError(f"resume: differs from the uninterrupted run in {diff}")
    log(f"[graph] resume: epoch 1 saved ({k} steps, one graphed chunk), rebuilt from checkpoints/latest, epoch 2 "
        f"trained: bitwise the parameters, Adam state, GradNorm weights, generator state, step {sa['step']} and "
        f"last_epoch 2 of an uninterrupted run")


def time_graphed(solver, name: str, k: int, replays: int, eager_steps: int = TIMED_STEPS, profiled: int = 1):
    """Eager train_step (``eager_steps`` timed, ``profiled`` profiled; 0:
    the eager busy share not measured) against graphed chunks of k steps on
    one solver, in this call: steps/s (host clock around whole calls ending
    in a synchronize) and, from the profile, device busy and idle per step.
    Returns the numbers."""
    import torch

    t_start = time.perf_counter()
    eager_ms, _ = time_steps(solver, f"{name} eager", eager_steps)
    eager_port, eager_busy, eager_kernels = ({}, None, 0) if not profiled else profile_steps(
        solver, f"{name} eager", eager_ms, steps=profiled, top=5)
    solver.train_chunk(k)  # the capture if this k is new, and one replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(replays):
        solver.train_chunk(k)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) / (replays * k) * 1e3
    graph_port, graph_busy, graph_kernels = profile_steps(solver, f"{name} graphed (K={k})", graph_ms, steps=1,
                                                          top=5, run=lambda: solver.train_chunk(k), steps_per_run=k)
    # busy comes from a profiled run, the step time from an unprofiled one: their ratio may pass 100%
    share = lambda busy, ms: "not measured" if busy is None else f"{100 * busy / ms:.1f}% busy"
    out = {"eager_steps_per_s": 1e3 / eager_ms, "eager_ms": eager_ms, "eager_busy_ms": eager_busy,
           "graphed_steps_per_s": 1e3 / graph_ms, "graphed_ms": graph_ms, "graphed_busy_ms": graph_busy,
           "kernels_per_step": [eager_kernels, graph_kernels], "K": k,
           "kernel_ms_per_step": {"eager": eager_port, "graphed": graph_port}}
    log(f"[graph] timing {name}: eager {1e3 / eager_ms:.2f} steps/s ({eager_ms:.3f} ms, {share(eager_busy, eager_ms)}), "
        f"graphed {1e3 / graph_ms:.2f} steps/s ({graph_ms:.3f} ms, {share(graph_busy, graph_ms)}), K={k}, "
        f"{replays} replays timed; speed-up {eager_ms / graph_ms:.2f}x; the timing took "
        f"{time.perf_counter() - t_start:.1f} s")
    return out


def run_graph_phase(ane, tmp: str):
    """The slice's run through the example's entry points on the card:
    train() by epochs in CUDA-graph chunks (MLP 4x256 two epochs with eval,
    PirateNet 9x256 and the aneurysm one epoch of a few chunks), graphed
    against eager, batches per replay, eval against the ETDRK4 solution and
    the aneurysm residual validator, resume, and the step rates. Returns
    (launch counts by run, timings)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples.allen_cahn import build_solver, get_reference_solution

    t0 = time.perf_counter()
    get_reference_solution()
    log(f"[graph] the ETDRK4 reference solution (201 x 512) ready in {time.perf_counter() - t0:.1f} s")
    launches, timing = {}, {}
    mlp = build_solver(output_dir=os.path.join(tmp, "mlp"), device="cuda", **GRAPH_MLP)
    launches["graph mlp"] = graph_train(mlp, "mlp")
    metric, group = mlp.eval()
    n_eval = len(mlp.validator["u_validator"].data_loader) * 16384
    log(f"[graph] eval mlp: final L2Rel.u = {metric:.4e} against the ETDRK4 solution after {mlp.step} steps "
        f"({n_eval} of the 201 x 512 points, batches of 16384); best {mlp.best_metric}; {group}")
    if not math.isfinite(metric):
        raise AssertionError(f"mlp: L2Rel {metric}")

    kwargs, k = GRAPH_PIRATENET
    pn = build_solver(output_dir=os.path.join(tmp, "piratenet"), with_validator=False, device="cuda", **kwargs)
    launches["graph piratenet"] = graph_train(pn, "piratenet", k)

    kwargs, k = GRAPH_ANEURYSM
    deriv_path.set_default(deriv_path.CANDIDATES["jet_pallas_full"])
    ane.epochs, ane.iters_per_epoch, ane.last_epoch = kwargs["epochs"], kwargs["iters_per_epoch"], 0
    ane.output_dir = os.path.join(tmp, "aneurysm")
    launches["graph aneurysm"] = graph_train(ane, "aneurysm", k)
    torch.cuda.synchronize()
    reset_counts()
    metric, group = ane.eval()
    torch.cuda.synchronize()
    counts, plain = read_counts()
    if not (math.isfinite(metric) and counts["jet_mlp_fwd"] > 0) or any(plain.values()):
        raise AssertionError(f"aneurysm eval: MSE {metric}, launches {counts}, plain on CUDA {plain}")
    log(f"[graph] eval aneurysm residual validator: {group}, jet_mlp_fwd launches {counts['jet_mlp_fwd']} "
        f"(forward only), plain versions on CUDA {sum(plain.values())}")

    check_graph_against_eager("mlp 4x256", dict(arch="mlp"))
    check_graph_against_eager("piratenet 9x256", dict(arch="piratenet", piratenet_blocks=9))
    check_batches_change()
    check_resume(tmp)

    for name, solver in (("mlp", mlp), ("piratenet", pn), ("aneurysm", ane)):
        k = next(iter(solver.graph_stats))
        timing[name] = time_graphed(solver, name, k, GRAPH_TIMED[name])
    return launches, timing


def check_graph_against_eager_rewound(solver, name: str, k: int):
    """Two graphed chunks of k steps against 2k eager steps from the same
    state on one solver (its state snapshot restored in place between the
    two runs; a second solver of the cylinder's size would cost seconds of
    host sampling): parameters to 1e-6 relative, and whether bitwise."""
    import torch

    snap = solver.state
    for _ in range(2):
        solver.train_chunk(k)
    graphed = flat_params(solver).clone()
    solver._load_state(snap)
    solver.train_steps(2 * k)
    torch.cuda.synchronize()
    eager = flat_params(solver)
    rel = float((graphed - eager).norm() / eager.norm())
    log(f"[graph] {name}: 2 graphed chunks of {k} steps vs {2 * k} eager steps from the same state: parameters "
        f"rel err {rel:.3e}, bitwise {torch.equal(graphed, eager)}")
    if not rel <= 1e-6:
        raise AssertionError(f"{name}: the graphed chunks disagree with the eager steps (rel {rel:.3e})")


def run_cylinder_phase():
    """The cylinder2d TIPC workload at its full size through
    ``build_matched_solver`` on jet_pallas_full: host build time and points
    per step; the MLP kernels at its shape (S = 6, 3 -> 52 x 5) against
    their plain versions in both forward modes; eager train steps through
    the kernels (every kernel launched each step, the peak device memory);
    the PDE loss and gradient of one full batch against the plain jet path
    and against nested jvp; graphed chunks against eager steps; graphed and
    eager steps/s with device busy, on jet_pallas_full and on the plain jet
    path. Returns (kernel errors, launches of the eager steps, timings)."""
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.examples.cylinder2d_unsteady import build_matched_solver

    c = CYLINDER
    t0 = time.perf_counter()
    solver, points = build_matched_solver(c["K"], deriv="jet_pallas_full", device="cuda")
    build_s = time.perf_counter() - t0
    shapes = {n: tuple(b[0]["t"].shape) for n, b in solver._static_batches.items()}
    log(f"[cylinder] matched solver built in {build_s:.2f} s (host sampling of every constraint): {points} points "
        f"a step, {shapes}")
    if points != c["points"] or shapes["EQ"][0] != c["N"]:
        raise AssertionError(f"cylinder: {points} points a step, batches {shapes}")
    with on_path("jet_pallas_full"):
        lengths = solver.model.jet_segment_lengths()
    if lengths != [5]:
        raise AssertionError(f"cylinder: segments {lengths}, expected one of 5 layers")

    errs = {"jet_mlp_fwd": 0.0, "jet_mlp_bwd": 0.0, "jet_wgrad": 0.0}
    for n in c["check_n"]:
        for key, v in check_kernels(c["S"], n, c["dims"]).items():
            errs[key] = max(errs[key], v)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _, counts = run_path(solver, CYLINDER_PATH, "jet_pallas_full", c["eager_steps"])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_streams = {len(jet.build_index(r)) for reqs in solver._jet_requests["EQ"].values() for r in reqs}
    log(f"[cylinder] residual jet: {n_streams} streams; peak device memory over {c['eager_steps']} eager steps "
        f"{peak_gb:.2f} GiB (torch.cuda.max_memory_allocated)")
    if n_streams != {c["S"]}:
        raise AssertionError(f"cylinder: the residual jet has {n_streams} streams, expected {c['S']}")
    check_against_plain_path(solver, "cylinder", ("jet_pallas_full",), (), refs=("jet", "jvp"))
    torch.cuda.empty_cache()

    with on_path("jet_pallas_full"):
        check_graph_against_eager_rewound(solver, "cylinder", c["K"])
    timing = {"points_per_step": points, "build_s": build_s, "peak_memory_gib_eager": peak_gb}
    for deriv in ("jet_pallas_full", "jet"):
        torch.cuda.reset_peak_memory_stats()
        with on_path(deriv):
            t = time_graphed(solver, f"cylinder {deriv}", c["K"], c["replays"])
        t["capture_s"] = solver.graph_stats[c["K"]]["capture_s"]
        t["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        t["graphed_points_per_s"] = points * t["graphed_steps_per_s"]
        t["eager_points_per_s"] = points * t["eager_steps_per_s"]
        timing[deriv] = t
        log(f"[cylinder] {deriv}: graphed {t['graphed_points_per_s']:.0f} points/s, eager "
            f"{t['eager_points_per_s']:.0f} points/s; capture {t['capture_s']:.2f} s; peak device memory "
            f"{t['peak_memory_gib']:.2f} GiB; device ms per step by kernel {t['kernel_ms_per_step']}")
    del solver
    torch.cuda.empty_cache()
    return errs, counts, timing


def run_euler_beam_phase(tmp: str):
    """The euler_beam example on jet_pallas_full: ``train()`` for
    ``EULER_RUN``'s epochs (one CUDA graph of 10 steps an epoch: the boundary's u, u_x,
    u_xx through the MLP kernels, u_xxx and the fourth-order residual by
    nested jvp, all inside the graph) and the L2Rel against the analytic
    solution; the boundary loss and gradient against the plain jet path
    and nested jvp; at the TIPC shape (100 + 4 points a step) graphed
    chunks against eager steps and the step rates. Returns (launches of
    the train() run, timings)."""
    import torch

    from paddlescience_torch.examples import euler_beam

    solver = euler_beam.build_solver(output_dir=os.path.join(tmp, "euler_beam"), device="cuda", **EULER_RUN)
    counts = graph_train(solver, "euler_beam")
    metric, group = solver.eval()
    reqs = {n: sorted({m for rs in r.values() for stack in rs for m in stack}) for n, r in solver._jet_requests.items()}
    log(f"[euler_beam] after train() ({solver.epochs} epochs x {solver.iters_per_epoch} steps): L2Rel.u = "
        f"{metric:.4e} against the analytic solution; derivative requests by constraint {reqs} (orders above 2 "
        f"by nested jvp)")
    if not math.isfinite(metric):
        raise AssertionError(f"euler_beam: L2Rel {metric}")
    check_against_plain_path(solver, "euler_beam", ("jet_pallas_full",), (), refs=("jet", "jvp"))

    tipc = euler_beam.build_solver(epochs=1, iters_per_epoch=1, output_dir=None, device="cuda")
    points = sum(next(iter(b[0].values())).shape[0] for b in tipc._static_batches.values())
    check_graph_against_eager_rewound(tipc, "euler_beam (TIPC shape)", EULER_TIPC_K)
    timing = time_graphed(tipc, "euler_beam", EULER_TIPC_K, EULER_REPLAYS, profiled=1)
    timing.update(points_per_step=points, l2rel=metric, capture_s=tipc.graph_stats[EULER_TIPC_K]["capture_s"],
                  graphed_points_per_s=points * timing["graphed_steps_per_s"])
    log(f"[euler_beam] TIPC shape: {points} points a step, graphed {timing['graphed_points_per_s']:.0f} points/s; "
        f"capture of {EULER_TIPC_K} steps {timing['capture_s']:.2f} s")
    torch.cuda.synchronize()
    return counts, timing


# ------------------------------------- the BASELINE configs and the autotuner --

# the JAX examples' train() at their defaults, no derivative path pinned: (graphed chunk K and replays timed)
EXAMPLE_TIMED = {"laplace2d": (10, 5), "ldc2d": (50, 3), "deeponet": (32, 5)}
# cut for the script's time: ldc2d_steady 5 of its 50 epochs, DeepONet 20 of its 100
EXAMPLE_RUN = {"ldc2d": dict(epochs=5), "deeponet": dict(epochs=20)}
# K = 3, 2 timed calls a candidate: cut for the script's time
AUTOTUNE_ENV = {"PSCI_AUTOTUNE_FUSED": "3", "PSCI_AUTOTUNE_CALLS": "2"}


def state_diff(a, b):
    """The entries of two ``Solver.state_dict()``s that are not bitwise equal."""
    import torch

    diff = [f"params.{n}" for n in a["params"] if not torch.equal(a["params"][n], b["params"][n])]
    diff += [f"buffers.{n}" for n in a["buffers"] if not torch.equal(a["buffers"][n], b["buffers"][n])]
    diff += [f"opt.{i}.{k}" for i in a["opt_state"] for k in a["opt_state"][i]
             if not torch.equal(a["opt_state"][i][k], b["opt_state"][i][k])]
    diff += [f"agg.{k}" for k in a["agg_state"] if not torch.equal(a["agg_state"][k], b["agg_state"][k])]
    diff += ["generator"] * (not torch.equal(a["generator"], b["generator"]))
    diff += ["step"] * (a["step"] != b["step"])
    return diff


def run_example(name: str, solver, metric_name: str):
    """``solver.train()`` as the example runs it (no path pinned), with the
    launch counters set to 0 just before; then eval, the graphed and eager
    step rates of the same solver (device busy from the profile) and the
    peak device memory. Returns (launch counts, numbers)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # what earlier phases and this solver's set-up hold
    reset_counts()
    t0 = time.perf_counter()
    logged = solver.train()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    bad = [e for e in logged if not all(math.isfinite(v) for k, v in e.items() if k.startswith("loss"))]
    if bad or not logged or any(plain.values()):
        raise AssertionError(f"{name}: non-finite or no losses {bad or logged}, plain versions on CUDA {plain}")
    metric, group = solver.eval()
    if not math.isfinite(metric):
        raise AssertionError(f"{name}: {metric_name} {metric}")
    steps = solver.epochs * solver.iters_per_epoch
    k_train = next(iter(solver.graph_stats), 1)
    points = sum(next(iter(b[0].values())).shape[0] for b in solver._batches().values())
    log(f"[{name}] train() {solver.epochs} epochs x {solver.iters_per_epoch} steps ({steps} steps, K={k_train}, "
        f"{points} points a step) in {dt:.2f} s, final loss {logged[-1]['loss']:.6e}; {metric_name} = {metric:.6e}; "
        f"{group}; path flags {deriv_path.get_default() or 'unpinned (the process default)'}; kernel launches "
        f"{ {k: v for k, v in counts.items() if v} }, plain versions on CUDA {sum(plain.values())}")
    k, replays = EXAMPLE_TIMED[name]
    timing = time_graphed(solver, name, k, replays)
    timing.update(metric=metric, metric_name=metric_name, train_s=dt, steps=steps, K_train=k_train,
                  points_per_step=points, peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                  memory_held_before_gib=held)
    log(f"[{name}] peak device memory {timing['peak_memory_gib']:.3f} GiB (torch.cuda.max_memory_allocated), of "
        f"which {held:.3f} GiB were allocated before train()")
    return counts, timing


def check_deeponet_graph(tmp: str):
    """The staged indexed graph: one epoch of ``train(num_fused_steps=32)``
    (32 host batches copied into the (32, 312, .) buffers a replay) against
    one epoch of eager steps, both from the same freshly built state (seed,
    weights, loader order): parameters bitwise equal."""
    import torch

    from paddlescience_torch.examples import deeponet

    runs = {}
    for k in (1, 32):
        s = deeponet.build_solver(epochs=1, output_dir=os.path.join(tmp, f"deeponet_k{k}"), device="cuda")
        s.train(num_fused_steps=k)
        runs[k] = s
    torch.cuda.synchronize()
    a, b = flat_params(runs[1]), flat_params(runs[32])
    replays = runs[32].graph_stats[32]["replays"]
    log(f"[deeponet] one epoch as one graph of 32 steps (the 32 host batches staged a replay) vs 32 eager steps "
        f"from the same fresh state: parameters bitwise {torch.equal(a, b)} (max abs diff "
        f"{float((a - b).abs().max()):.3e}), {replays} replay(s)")
    if not torch.equal(a, b) or replays != 1:
        raise AssertionError("deeponet: the staged indexed graph disagrees with the eager steps")


def run_example_phases(tmp: str):
    """laplace2d, ldc2d_steady and DeepONet through their examples' entry
    points at the JAX defaults, no path pinned. Returns (launch counts by
    run, numbers, the Adam-trained ldc2d_steady parameters)."""
    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import deeponet, laplace2d, ldc2d_steady

    launches, timing = {}, {}
    deriv_path.set_default(None)
    for name, build, metric_name in (
            ("laplace2d", laplace2d.build_solver, "MSE.u"),
            ("ldc2d", ldc2d_steady.build_solver, "residual MSE.continuity"),
            ("deeponet", deeponet.build_solver, "L2Rel.G")):
        t0 = time.perf_counter()
        solver = build(output_dir=os.path.join(tmp, name), device="cuda", **EXAMPLE_RUN.get(name, {}))
        log(f"[{name}] solver built in {time.perf_counter() - t0:.2f} s")
        launches[f"example {name}"], timing[name] = run_example(name, solver, metric_name)
        timing[name]["build_s"] = time.perf_counter() - t0
        if name == "ldc2d":
            ldc2d_params = {n: p.detach().clone() for n, p in solver.model.named_parameters()}
        del solver
    check_deeponet_graph(tmp)
    return launches, timing, ldc2d_params


LBFGS_CHECK_STEPS = 3  # L-BFGS steps held on jet_pallas_full against the plain jet path
LBFGS_REFINE_STEPS = 50  # L-BFGS steps after the [ldc2d] phase's Adam training
LBFGS_EPOCHS = 3  # of the example's 50 epochs of 50 L-BFGS steps: cut for the script's time
OPERATOR_EPOCHS = 10  # of the operator examples' 300 epochs: cut for the script's time
OPERATOR_TIMED = {"darcy": 5, "brusselator": 10}  # graphed replays timed per solver
BRUSSELATOR_CHECK = 2  # samples of the generator held on the card against the CPU
BRUSSELATOR_TOL = 1e-4  # x max |u|: cuFFT against the CPU's FFT over the 9500 steps of the rollout


def lbfgs_residuals(solver):
    """The residual validator's three MSEs."""
    return {k: round(v, 9) for k, v in solver.eval()[1]["residual"].items()}


def lbfgs_objective(solver) -> float:
    """The L-BFGS objective (the plain sum of the constraint losses) at
    the current parameters on the solver's batch."""
    import torch

    with torch.no_grad():
        return float(torch.stack(list(solver._constraint_losses(solver._batches()).values())).sum())


def run_lbfgs_phase(tmp: str, adam_params):
    """ldc2d_steady with ``lbfgs=True`` through ``train()`` for
    ``LBFGS_EPOCHS`` of the example's 50 epochs of 50 steps (no path pinned: the process default, the plain jet at
    width 50): steps/s, line-search evaluations a step, the residual MSEs,
    the peak memory; then the Adam+L-BFGS recipe: a second L-BFGS solver
    from the [ldc2d] phase's Adam-trained parameters for 50 steps; then 3
    L-BFGS steps on jet_pallas_full against the plain jet path from the
    same state: each step's loss within 1e-4 relative, the gradient the
    search stores within 1e-3 of its largest magnitude, the same number of
    evaluations, and the MLP kernels launched under the closure. Returns
    (the kernel path's launch counts, numbers)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import ldc2d_steady

    deriv_path.set_default(None)
    out = {}
    solver = ldc2d_steady.build_solver(epochs=LBFGS_EPOCHS, lbfgs=True, output_dir=os.path.join(tmp, "ldc2d_lbfgs"),
                                       device="cuda")
    start = lbfgs_objective(solver)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    t0 = time.perf_counter()
    logged = solver.train()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    steps = solver.epochs * solver.iters_per_epoch
    evals = solver.optimizer.evaluations
    if len(evals) != steps or any(plain.values()) or not all(math.isfinite(e["loss"]) for e in logged):
        raise AssertionError(f"lbfgs: {len(evals)} of {steps} steps, plain versions on CUDA {plain}, logs {logged}")
    res = lbfgs_residuals(solver)
    out["train"] = {"steps": steps, "seconds": dt, "steps_per_s": steps / dt, "evals_mean": sum(evals) / steps,
                    "evals_max": max(evals), "evals_total": sum(evals), "objective": [start, lbfgs_objective(solver)],
                    "residual_mse": res, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "memory_held_before_gib": held, "path_flags": deriv_path.get_default(),
                    "kernel_launches": {k: v for k, v in counts.items() if v}}
    log(f"[lbfgs] ldc2d_steady lbfgs=True train(): {steps} L-BFGS steps in {dt:.2f} s ({steps / dt:.2f} steps/s), "
        f"value-and-gradient evaluations a step mean {sum(evals) / steps:.3f}, max {max(evals)} "
        f"({sum(evals)} in all); objective {start:.6e} -> {out['train']['objective'][1]:.6e}; residual MSE {res}; "
        f"peak device memory "
        f"{out['train']['peak_memory_gib']:.3f} GiB ({held:.3f} held before); path flags "
        f"{deriv_path.get_default() or 'unpinned (the process default)'}")
    _, busy, kernels = profile_steps(solver, "lbfgs", dt / steps * 1e3, steps=10, top=8)
    out["train"].update(busy_ms_per_step=busy, kernels_per_step=kernels)
    del solver

    refine = ldc2d_steady.build_solver(epochs=1, iters_per_epoch=LBFGS_REFINE_STEPS, lbfgs=True,
                                       output_dir=os.path.join(tmp, "ldc2d_refine"), device="cuda")
    refine._load_state({"params": adam_params}, params_only=True)
    before, obj_before = lbfgs_residuals(refine), lbfgs_objective(refine)
    t0 = time.perf_counter()
    refine.train()
    torch.cuda.synchronize()
    after, obj_after = lbfgs_residuals(refine), lbfgs_objective(refine)
    out["adam_then_lbfgs"] = {"steps": LBFGS_REFINE_STEPS, "seconds": time.perf_counter() - t0,
                              "objective": [obj_before, obj_after], "residual_mse_before": before,
                              "residual_mse_after": after, "evals": refine.optimizer.evaluations}
    log(f"[lbfgs] Adam then L-BFGS: from the [ldc2d] phase's Adam-trained parameters, {LBFGS_REFINE_STEPS} L-BFGS "
        f"steps in {out['adam_then_lbfgs']['seconds']:.2f} s: objective {obj_before:.6e} -> {obj_after:.6e}; "
        f"residual MSE {before} -> {after}")
    if not (obj_after < obj_before and all(math.isfinite(v) for v in after.values())):
        raise AssertionError(f"lbfgs refinement: objective {obj_before} -> {obj_after}, residual MSE {after}")
    del refine

    runs, launches = {}, None
    for deriv in ("jet", "jet_pallas_full"):
        s = ldc2d_steady.build_solver(lbfgs=True, output_dir=None, device="cuda", deriv=deriv)
        rows = []
        reset_counts()
        for _ in range(LBFGS_CHECK_STEPS):
            loss = float(s.train_step()["loss"])
            st = s.optimizer.linesearch.state
            rows.append((loss, st["grad"].clone(), len(s.optimizer.linesearch.trace)))
        torch.cuda.synchronize()
        counts, plain = read_counts()
        if deriv == "jet_pallas_full":
            check_counts("mlp/lbfgs", counts, plain, LBFGS_CHECK_STEPS)
            launches = counts
        runs[deriv] = (rows, s.optimizer.evaluations)
        del s
    deriv_path.set_default(None)
    checks = []
    for i, (a, b) in enumerate(zip(*(runs[d][0] for d in ("jet_pallas_full", "jet")))):
        loss_rel = abs(a[0] - b[0]) / abs(b[0])
        grad_rel = float((a[1] - b[1]).abs().max() / b[1].abs().max())
        checks.append({"step": i + 1, "loss": [a[0], b[0]], "loss_rel": loss_rel, "grad_rel": grad_rel,
                       "trials": [a[2], b[2]]})
        log(f"[lbfgs] step {i + 1}: jet_pallas_full vs plain jet: loss {a[0]:.8e} vs {b[0]:.8e} (rel {loss_rel:.2e}), "
            f"stored gradient rel {grad_rel:.2e}, line-search trials {a[2]} vs {b[2]}")
        if loss_rel > REL_TOL or grad_rel > 1e-3 or a[2] != b[2]:
            raise AssertionError(f"lbfgs: the kernel path disagrees with the plain jet path at step {i + 1}")
    if runs["jet_pallas_full"][1] != runs["jet"][1]:
        raise AssertionError(f"lbfgs: evaluations {runs['jet_pallas_full'][1]} vs {runs['jet'][1]}")
    out["kernel_vs_plain"] = checks
    log(f"[lbfgs] {LBFGS_CHECK_STEPS} L-BFGS steps through the MLP kernels (every evaluation of the line search): "
        f"launches { {k: v for k, v in launches.items() if v} }, evaluations {runs['jet'][1]} on both paths")
    return launches, out


def check_operator_graph(name: str, build, phase: str = "operators"):
    """One epoch as one graph of k = iters_per_epoch steps (k host batches
    staged a replay) against k eager steps, both from a fresh solver and
    under cuDNN's deterministic algorithms: parameters within 1e-6
    relative (and whether bitwise)."""
    import torch

    from paddlescience_torch.utils.step_graph import deterministic_convs

    runs = {}
    with deterministic_convs():  # cuDNN's atomics would reorder a conv's weight-gradient sums
        for fused in ("eager", "graphed"):
            s = build()
            k = s.iters_per_epoch
            s.epochs = 1
            s.train(num_fused_steps=k if fused == "graphed" else 1)
            runs[k if fused == "graphed" else 1] = s
        torch.cuda.synchronize()
    a, b = flat_params(runs[k]), flat_params(runs[1])
    rel = float((a - b).norm() / b.norm())
    log(f"[{phase}] {name}: one epoch as one graph of {k} steps vs {k} eager steps from the same fresh state: "
        f"parameters rel err {rel:.3e}, bitwise {torch.equal(a, b)}, {runs[k].graph_stats[k]['replays']} replay(s)")
    if rel > 1e-6 or runs[k].graph_stats[k]["replays"] != 1:
        raise AssertionError(f"{name}: the graphed epoch disagrees with the eager steps")
    return {"rel_err": rel, "bitwise": torch.equal(a, b)}


def train_operator(name: str, solver, metric_name: str):
    """``train(num_fused_steps=iters_per_epoch)`` (one graph an epoch), the
    final metric, then graphed and eager steps/s with device busy."""
    import torch

    k = solver.iters_per_epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logged = solver.train(num_fused_steps=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    metric, group = solver.eval()
    if not math.isfinite(metric) or not all(math.isfinite(e["loss"]) for e in logged):
        raise AssertionError(f"{name}: {metric_name} {metric}, logs {logged[-3:]}")
    steps = solver.epochs * k
    log(f"[operators] {name} train(): {solver.epochs} epochs x {k} steps as one graph an epoch ({steps} steps) in "
        f"{dt:.2f} s, final loss {logged[-1]['loss']:.6e}; {metric_name} = {metric:.6e}; {group}")
    timing = time_graphed(solver, name, k, OPERATOR_TIMED[name])
    timing.update(train_s=dt, steps=steps, metric=metric, metric_name=metric_name,
                  peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    return timing


@functools.lru_cache(maxsize=None)
def _darcy_data():
    """The Darcy examples' 1100 samples at 16^2 (generated on the host once)."""
    from paddlescience_torch.examples import darcy_tfno

    return darcy_tfno.make_data(1100, 16)


def run_operator_phase(tmp: str):
    """BASELINE's operator config through the examples' entry points at
    their defaults, the epochs cut to ``OPERATOR_EPOCHS`` (of 300): Darcy
    TFNO (1000 + 100 generated samples at 16^2, epochs of 62 steps) and the
    Brusselator LNO (800 + 200 samples generated on the card, held against
    the same generator on the CPU for 2 samples; epochs of 16 steps), each
    epoch one CUDA graph; a
    graphed epoch against eager steps for each. Returns the numbers."""
    import numpy as np
    import torch

    from paddlescience_torch.data.dataset import brusselator
    from paddlescience_torch.examples import brusselator3d_lno, darcy_tfno

    out = {}
    t0 = time.perf_counter()
    darcy_data = _darcy_data()
    gen_s = time.perf_counter() - t0
    log(f"[operators] darcy: {len(darcy_data[0])} samples at 16^2 generated (host, numpy and scipy) in {gen_s:.2f} s")
    build = lambda tag: darcy_tfno.build_solver(epochs=OPERATOR_EPOCHS, data=darcy_data,
                                                output_dir=os.path.join(tmp, tag), device="cuda")
    out["darcy"] = {"generation_s": gen_s, "graph_check": check_operator_graph("darcy", lambda: build("darcy_chk"))}
    out["darcy"].update(train_operator("darcy", build("darcy"), "l2"))

    ic = brusselator.initial_perturbation()
    coefs = brusselator.forcings(BRUSSELATOR_CHECK, 7)
    gpu = brusselator.simulate(coefs, ic, "cuda").cpu().numpy()
    cpu = brusselator.simulate(coefs, ic, "cpu").numpy()
    err = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    log(f"[operators] brusselator generator: {BRUSSELATOR_CHECK} samples on the card vs the CPU: max abs diff "
        f"{err:.3e} x max |u| (limit {BRUSSELATOR_TOL})")
    if err > BRUSSELATOR_TOL:
        raise AssertionError("brusselator: the generator on the card disagrees with the CPU")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = brusselator.generate(device="cuda")
    gen_s = time.perf_counter() - t0
    log(f"[operators] brusselator: 800 + 200 samples (39 frames of 28^2, 9500 IMEX steps) generated on the card "
        f"in {gen_s:.2f} s")
    build = lambda tag: brusselator3d_lno.build_solver(epochs=OPERATOR_EPOCHS, data=data,
                                                       output_dir=os.path.join(tmp, tag), device="cuda")
    out["brusselator"] = {"generation_s": gen_s, "generator_rel_err_vs_cpu": err,
                          "graph_check": check_operator_graph("brusselator", lambda: build("bru_chk"))}
    out["brusselator"].update(train_operator("brusselator", build("brusselator"), "decoded.L2Rel"))
    return out


def run_autotune_phase(solvers):
    """``autotune`` on each driven solver (no path pinned before), K = the
    solver's own (at most PSCI_AUTOTUNE_FUSED, AUTOTUNE_ENV), a temporary cache:
    every candidate's ms/step, the winner, the seconds; the winner the
    argmin of the cached timings; the kernel candidates launched their
    kernels and no plain version ran on CUDA; the solver's state bitwise
    what it was; a second call served from the cache without timing.
    Returns the numbers by solver."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.solver import autotune

    real, timed, results = autotune._time_candidate, [], {}
    saved_env = {k: os.environ.get(k) for k in ("PSCI_AUTOTUNE_CACHE", *AUTOTUNE_ENV)}

    def counting(solver, k, calls):
        timed.append(deriv_path.get_default())
        return real(solver, k, calls)

    with tempfile.TemporaryDirectory(prefix="psci_autotune_") as tmp:
        os.environ.update(AUTOTUNE_ENV, PSCI_AUTOTUNE_CACHE=os.path.join(tmp, "deriv_autotune.json"))
        autotune._time_candidate = counting
        try:
            for name, solver in solvers.items():
                deriv_path.set_default(None)
                k = solver._auto_fuse_steps()
                k_timed = max(1, min(k, int(AUTOTUNE_ENV["PSCI_AUTOTUNE_FUSED"])))
                names = autotune.candidate_names(solver)
                before = solver.state
                torch.cuda.synchronize()
                reset_counts()
                n0, t0 = len(timed), time.perf_counter()
                winner = autotune.autotune(solver, solver._static_batches, k)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts, plain = read_counts()
                with open(os.environ["PSCI_AUTOTUNE_CACHE"]) as f:
                    entry = json.load(f)[autotune.signature(solver, solver._static_batches) + "-" + "+".join(names)]
                times = entry["timings_ms_per_step"]
                diff = state_diff(solver.state_dict(), before)
                kernel_path = any(n.startswith("jet_pallas") for n in names)
                gated = type(solver.model).__name__ in ("PirateNet", "ModifiedMLP")
                pair = ("jet_gated_fwd", "jet_gated_bwd") if gated else ("jet_mlp_fwd", "jet_mlp_bwd")
                missing = [kk for kk in pair + ("jet_wgrad",) if kernel_path and not counts[kk]]
                if (winner != min(times, key=times.get) or entry["refused"] or len(timed) - n0 != len(names)
                        or diff or missing or any(plain.values())
                        or deriv_path.get_default() != deriv_path.CANDIDATES[winner]):
                    raise AssertionError(f"autotune {name}: winner {winner}, timings {times}, refused "
                                         f"{entry['refused']}, {len(timed) - n0} timed, state diff {diff}, kernels "
                                         f"not launched {missing}, plain versions on CUDA {plain}")
                deriv_path.set_default(None)
                n1 = len(timed)
                again = autotune.autotune(solver, solver._static_batches, k)
                if again != winner or len(timed) != n1:
                    raise AssertionError(f"autotune {name}: the second call gave {again}, timing {len(timed) - n1}")
                results[name] = {"winner": winner, "ms_per_step": times, "K": k_timed, "seconds": seconds,
                                 "launches": {kk: v for kk, v in counts.items() if v}}
                log(f"[autotune] {name}: K={k_timed} (the solver's chunk {k}), {len(names)} candidates in "
                    f"{seconds:.2f} s; ms/step "
                    + ", ".join(f"{n} {t:.4f}" for n, t in times.items()) + f"; winner {winner} (the argmin); "
                    f"state bitwise unchanged; kernel launches while timing "
                    f"{results[name]['launches']}; a second call served from the cache, nothing timed")
                solver.release_graphs()
                torch.cuda.empty_cache()
        finally:
            autotune._time_candidate = real
            for key, v in saved_env.items():
                if v is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = v
    return results


def autotune_solvers(solvers, ane):
    """The solvers the autotuner runs on: the Allen-Cahn MLP 4x256 and
    PirateNet 9x256 of the main phase, the aneurysm, and, built here with
    no path pinned, the cylinder2d matched workload, euler_beam, laplace2d
    and ldc2d_steady at their examples' defaults."""
    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import euler_beam, laplace2d, ldc2d_steady
    from paddlescience_torch.examples.cylinder2d_unsteady import build_matched_solver

    deriv_path.set_default(None)
    return {"mlp 4x256": solvers["mlp/jet_pallas_full"], "piratenet 9x256": solvers["piratenet/jet_pallas_full"],
            "aneurysm": ane, "cylinder matched": build_matched_solver(10, device="cuda")[0],
            "euler_beam": euler_beam.build_solver(output_dir=None, device="cuda"),
            "laplace2d": laplace2d.build_solver(output_dir=None, device="cuda"),
            "ldc2d_steady": ldc2d_steady.build_solver(output_dir=None, device="cuda")}


def time_cylinder_kernels(rows, errs, launches, device_ms):
    """The MLP kernels' rows at the cylinder workload's shape (tanh, S = 6,
    N = 282,600, 3 -> 52 x 5), under the key "cylinder", with their errors
    there and their device time per step from the eager profile."""
    from paddlescience_torch.ops import jet_mlp as J

    c = CYLINDER
    per_step = {name: launches[name] / c["eager_steps"] for name in errs}
    time_mlp_shape(rows, "cylinder", c["S"], c["N"], c["dims"], J.TANH, per_step)
    for r in rows[:3]:
        r["cylinder"].update(max_abs_err=errs[r["name"]],
                             device_ms_per_step={f: v for f, v in device_ms.items() if f.startswith(r["name"])})

# ------------------------------------------- the recipes and the LDC curriculum --

# [recipes]: the Allen-Cahn variants the NTK aggregator drives, at full width through train(): 2 epochs of
# one K-step graph each (K = iters_per_epoch), NTK refreshed at each epoch's start, L2Rel every epoch
RECIPE_NAMES = ("default_ntk", "sota")
RECIPE_RUN = dict(epochs=2, iters_per_epoch=150, update_freq=150, eval_freq=1)
RECIPE_TIMED = (50, 2)  # (K, replays) of the graphed-against-eager timing
# [ldc]: the three curriculum recipes at full width and batch, cut to their first two stages (Re 100, 400) of
# one 100-step epoch each (the recipes' own: 1000 steps an epoch; cut for the script's time),
# the reference fields solved on a 65^2 grid (the recipes' own: 257^2)
LDC_CUT = dict(Re=(100, 400), epochs=(1, 1), reference_n=65, iters_per_epoch=100)
LDC_K = 50  # steps a graph in the curricula (the recipes' own: one 1000-step graph an epoch,
#             whose capture took 49-103 s a stage for PirateNet on the H100)
LDC_CHECK_N = 33  # the generator on the card against the CPU: one 2000-step chunk at Re 100
LDC_CHECK_STEPS = 3  # eager steps of each recipe on jet_pallas_full against the plain jet path
LDC_GRAPH_K = 10  # graphed chunk against eager steps (PirateNet recipe)
LDC_TIMED = (20, 2)  # (K, replays) of the graphed-against-eager timing
NS2D = [(0,), (1,), (0, 0), (1, 1)]  # the steady 2-D NavierStokes jet: u, u_x, u_y, u_xx, u_yy (S = 5)
# the LDC recipes' kernel shapes: S = 5 at the PDE batch; (recipe, kind, N, program or dims)
LDC_SHAPES = (("re3200_piratenet", "gated", 4096, ("piratenet", 4)),
              ("re3200_sota", "gated", 8192, ("modified_mlp", 5)),
              ("re1000_plain", "mlp", 4096, (2,) + (256,) * 4))


def run_recipe_phase(tmp: str):
    """default_ntk (MLP 4x256) and sota (ModifiedMLP 4x256, batch 8192)
    through ``build_solver(**recipe(name))`` and ``train()`` on
    jet_pallas_full: NTK weights refreshed (sum |g| / |g_i|, finite, not
    1), the L2Rel every epoch, the kernels launched, then graphed and eager
    steps/s with device busy. Returns (launch counts by run, numbers)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import allen_cahn as ac

    launches, out = {}, {}
    for name in RECIPE_NAMES:
        solver = ac.build_solver(**ac.recipe(name, deriv="jet_pallas_full", device="cuda",
                                             log_freq=RECIPE_RUN["iters_per_epoch"],
                                             output_dir=os.path.join(tmp, f"recipe_{name}"), **RECIPE_RUN))
        if type(solver.loss_aggregator).__name__ != "NTK":
            raise AssertionError(f"recipes/{name}: aggregator {type(solver.loss_aggregator).__name__}, expected NTK")
        with on_path("jet_pallas_full"):
            launches[f"recipes/{name}"] = graph_train(solver, f"recipes/{name}")
            w = solver.agg_state["weight"].tolist()
            if not all(math.isfinite(v) for v in w) or all(v == 1.0 for v in w):
                raise AssertionError(f"recipes/{name}: NTK weights {w} after train()")
            metric, _ = solver.eval()
            if not math.isfinite(metric):
                raise AssertionError(f"recipes/{name}: L2Rel {metric}")
            log(f"[recipes] {name}: {type(solver.model).__name__} batch {ac.recipe(name).get('batch_size', 4096)}, "
                f"NTK weights after {solver.step} steps {w} (PDE, IC); L2Rel.u {metric:.6f} (best "
                f"{solver.best_metric})")
            timing = time_graphed(solver, f"recipes/{name}", *RECIPE_TIMED)
        out[name] = {"ntk_weights": w, "L2Rel": metric, **timing}
        del solver
        torch.cuda.empty_cache()
    deriv_path.set_default(None)
    return launches, out


def check_generator():
    """The cavity generator on the card: one 2000-step chunk at Re 100 on
    the LDC_CHECK_N grid graphed (20 replays of a 100-step graph), against the same chunk in
    eager steps on the card (1e-6 x max) and on the CPU (1e-5 x max; cuFFT
    against pocketfft). Returns the numbers."""
    import numpy as np

    from paddlescience_torch.data.dataset import ldc_reference as R

    n, steps = LDC_CHECK_N, R.CHUNK
    runs = {}
    for key, kw in (("graphed", dict(device="cuda")), ("eager", dict(device="cuda", graphed=False)),
                    ("cpu", dict(device="cpu"))):
        t0 = time.perf_counter()
        runs[key] = R.solve_cavity(100.0, n=n, steps=steps, report=log, **kw)
        runs[key]["s"] = time.perf_counter() - t0
    out = {"n": n, "steps": steps, **{f"{k}_s": v["s"] for k, v in runs.items()}}
    for other, limit in (("eager", 1e-6), ("cpu", 1e-5)):
        for f in ("u", "v", "psi", "omega"):
            ref = runs[other][f]
            rel = float(np.abs(runs["graphed"][f] - ref).max() / np.abs(ref).max())
            out[f"{f}_vs_{other}"] = rel
            if not rel <= limit:
                raise AssertionError(f"generator: {f} graphed on the card vs {other}: {rel:.3e} > {limit} x max")
    log(f"[ldc] generator, Re 100 on {n}^2, one {steps}-step chunk: graphed {runs['graphed']['s']:.2f} s (capture "
        f"included), eager on the card {runs['eager']['s']:.2f} s, CPU {runs['cpu']['s']:.2f} s; graphed vs eager "
        + ", ".join(f"{f} {out[f + '_vs_eager']:.2e}" for f in ("u", "v", "psi", "omega")) + "; vs the CPU "
        + ", ".join(f"{f} {out[f + '_vs_cpu']:.2e}" for f in ("u", "v", "psi", "omega")) + " (x max)")
    return out


def check_ldc_kernels():
    """The gated and MLP kernels against their plain versions at the LDC
    recipes' shapes (S = 5, the 2-D NavierStokes jet), and at a ragged N.
    Returns the max abs errors by kernel."""
    from paddlescience_torch.ops import jet_gated as G

    if jet_index(len(NS2D) + 1).multis[1:] != tuple(NS2D):
        raise AssertionError(f"jet_index(5) is not the 2-D NavierStokes jet {NS2D}")
    errs = {}
    for name, kind, n, spec in LDC_SHAPES:
        for n_ in (n, n - 1):
            if kind == "gated":
                program = getattr(G, f"{spec[0]}_program")(spec[1])
                e = check_gated_kernels(len(NS2D) + 1, n_, 256, program, f"ldc {name}")
            else:
                e = check_kernels(len(NS2D) + 1, n_, spec)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
    return errs


def ldc_stage(cfg, Re: float = 100.0, epochs: int = 1):
    """A fresh model, optimizer and GradNorm of ``cfg`` and its stage
    solver at ``Re``."""
    from paddlescience_torch.examples import ldc_curriculum as C

    model = C.make_model(cfg, "cuda")
    opt, gn = C.make_training(cfg, model)
    return C.build_stage_solver(cfg, model, opt, gn, Re, epochs, None, "cuda")


def check_ldc_against_plain_path(solver, name: str, phase: str = "ldc", kernel_path: str = "jet_pallas_full"):
    """LDC_CHECK_STEPS eager steps from one state on ``kernel_path`` and on
    the plain jet path (the same batches, a GradNorm refresh at step 0):
    every per-key loss within 1e-4, each step's gradient within 1e-3.
    Returns the kernel launches per step of the steps after the first.
    (The [elasticity], [heart] and [toolkit] phases run it too, as
    ``phase``.)"""
    import torch

    snap, runs, per_step = solver.state, {}, None
    for deriv in (kernel_path, "jet"):
        solver._load_state(snap)
        losses, grads = [], []
        with on_path(deriv):
            for i in range(LDC_CHECK_STEPS):
                if i == 1:
                    torch.cuda.synchronize()
                    reset_counts()
                logs = solver.train_step()
                losses.append({k: float(v) for k, v in logs.items() if k.startswith("loss")})
                grads.append(torch.cat([p.grad.reshape(-1) for p in solver._params()]).clone())
            torch.cuda.synchronize()
        counts, plain = read_counts()
        if deriv == kernel_path:
            check_counts(f"{phase}/{name}", counts, plain, LDC_CHECK_STEPS - 1)
            per_step = {k: v / (LDC_CHECK_STEPS - 1) for k, v in counts.items() if v}
        runs[deriv] = (losses, grads)
    (lk, gk), (lp, gp) = runs[kernel_path], runs["jet"]
    loss_err = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(lk, lp) for k in b)
    grad_err = max(float((a - b).norm() / b.norm()) for a, b in zip(gk, gp))
    log(f"[{phase}] {name}: {LDC_CHECK_STEPS} steps on {kernel_path} vs the plain jet path: losses "
        f"{[round(s['loss'], 6) for s in lk]} vs {[round(s['loss'], 6) for s in lp]}, every per-key loss rel err "
        f"<= {loss_err:.2e}, gradient rel err <= {grad_err:.2e}; kernel launches per step {per_step}")
    if not (loss_err < 1e-4 and grad_err < 1e-3):
        raise AssertionError(f"{phase} {name}: the kernel path disagrees with the plain jet path")
    solver._load_state(snap)
    return per_step


def run_ldc_phase(tmp: str):
    """The LDC Re-curriculum recipes on the card: the generator against the
    CPU and graphed against eager; the stages' reference fields solved on
    the card; the kernels at the recipes' shapes; each recipe's
    ``train_curriculum`` on jet_pallas_full (two stages, the state carried:
    L2Rel.U and the Ghia RMSE a stage, the kernels launched); each
    recipe's kernel path against the plain jet path over 3 steps; one
    graphed chunk against eager steps; graphed and eager steps/s. Returns
    (launch counts by run, kernel launches per step by recipe, max abs
    errors, numbers)."""
    import numpy as np
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.data.dataset import ldc_reference as R
    from paddlescience_torch.examples import ldc_curriculum as C

    out = {"generator": check_generator()}
    ref_dir = os.path.join(tmp, "ldc_reference")
    for Re in LDC_CUT["Re"]:
        t0 = time.perf_counter()
        fields = R.solve_cavity(float(Re), n=LDC_CUT["reference_n"], report=log)
        dt = time.perf_counter() - t0
        os.makedirs(ref_dir, exist_ok=True)
        np.savez(R.reference_path(Re, LDC_CUT["reference_n"], ref_dir), **fields)
        out[f"generator_Re{Re}"] = {"n": LDC_CUT["reference_n"], "steps": int(fields["steps"]), "s": dt,
                                    "psi_min": float(fields["psi"].min())}
        log(f"[ldc] reference field Re {Re} on {LDC_CUT['reference_n']}^2 solved on the card: {int(fields['steps'])} "
            f"steps in {dt:.2f} s ({int(fields['steps']) / dt:.0f} steps/s), psi_min {fields['psi'].min():.6f}")
    errs = check_ldc_kernels()
    launches, per_step = {}, {}
    for name in C.RECIPES:
        cfg = C.RECIPES[name](reference_dir=ref_dir, **LDC_CUT)
        torch.cuda.synchronize()
        reset_counts()
        results = C.train_curriculum(cfg, output_dir=os.path.join(tmp, f"ldc_{name}"), device="cuda",
                                     deriv="jet_pallas_full", num_fused_steps=LDC_K)
        torch.cuda.synchronize()
        counts, plain = read_counts()
        check_counts(f"ldc/{name}", counts, plain)
        launches[f"ldc/{name}"] = counts
        rows = []
        for r in results:
            stats = next(iter(r["graph_stats"].values()))
            steps = r["epochs"] * cfg["iters_per_epoch"]
            loop_s = r["train_s"] - stats["warmup_s"] - stats["capture_s"]
            bad = [e for e in r["logs"] if not all(math.isfinite(v) for k, v in e.items() if k.startswith("loss"))]
            if bad or not math.isfinite(r["metric"]) or not all(math.isfinite(w) for w in r["weights"]):
                raise AssertionError(f"ldc {name} Re {r['Re']}: non-finite losses, metric or weights {bad[:1]} "
                                     f"{r['metric']} {r['weights']}")
            rows.append({"Re": r["Re"], "L2Rel.U": r["metric"], "ghia": r["ghia"], "gradnorm": r["weights"],
                         "step": r["step"], "train_s": r["train_s"], "warmup_s": stats["warmup_s"],
                         "capture_s": stats["capture_s"], "replays": stats["replays"],
                         "steps_per_s": steps / loop_s, "final_loss": r["logs"][-1]["loss"]})
            log(f"[ldc] {name} Re {r['Re']}: {steps} steps in {r['train_s']:.2f} s (warm-up {stats['warmup_s']:.2f} s, "
                f"capture {stats['capture_s']:.2f} s, {stats['replays']} replays of K = {next(iter(r['graph_stats']))}: "
                f"{steps / loop_s:.2f} steps/s); final loss {r['logs'][-1]['loss']:.6f}; GradNorm {r['weights']}; "
                f"L2Rel.U {r['metric']:.6f}; Ghia {r['ghia'] or 'no table at this Re'}")
        if results[-1]["step"] != sum(LDC_CUT["epochs"]) * cfg["iters_per_epoch"]:
            raise AssertionError(f"ldc {name}: the carried step is {results[-1]['step']}")
        out[name] = {"stages": rows, "launches_at_warmup_and_capture": {k: v for k, v in counts.items() if v}}
        solver = ldc_stage(cfg)
        per_step[name] = check_ldc_against_plain_path(solver, name)
        if name == "re3200_piratenet":
            check_graph_against_eager_rewound(solver, f"ldc {name}", LDC_GRAPH_K)
        with on_path("jet_pallas_full"):
            out[name]["timing"] = time_graphed(solver, f"ldc/{name}", *LDC_TIMED)
        del solver
        torch.cuda.empty_cache()
    deriv_path.set_default(None)
    return launches, per_step, errs, out


def time_gated_shape(rows, key, S, N, W, program, tag, per_step):
    """The gated kernels' rows and jet_wgrad's (over the segment's layers,
    with the d alpha partials where the program has alphas) at one more
    shape, under ``key``, as :func:`time_mlp_shape` does for the MLP
    kernels: time, plain-version time, bound, the library time and
    ``per_step[name]``, the launches per step."""
    import torch

    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J

    by = {r["name"]: r for r in rows}
    fargs, bargs = gated_args(S, N, W, program)
    alphas = bargs[6]
    f_flops, f_bytes, b_flops, b_bytes = gated_bound(S, N, W, program)
    *_, gzs, ins, partials = G.jet_gated_bwd(*bargs)
    L = len(program)
    Y = [torch.cat(t, 0) for t in ins]
    GZ = [g.reshape(S * N, W) for g in gzs]
    stream = S * N * W * 4.0
    work = {"jet_gated_fwd": (lambda: G.jet_gated_fwd(*fargs), lambda: G.jet_gated_fwd_plain(*fargs),
                              f_flops, f_bytes, None),
            "jet_gated_bwd": (lambda: G.jet_gated_bwd(*bargs), lambda: G.jet_gated_bwd_plain(*bargs),
                              b_flops, b_bytes, None),
            "jet_wgrad": (lambda: J.jet_wgrad(ins, gzs, alpha_partials=partials if alphas else None),
                          lambda: J.jet_wgrad_plain(ins, gzs), f_flops + L * N * W,
                          2 * L * stream + L * (W * W + W) * 4.0,
                          lambda: [torch.mm(a.T, b) for a, b in zip(Y, GZ)])}
    for kname, (fn, plain, fl, nbytes, library) in work.items():
        ms, plain_ms = cuda_ms(fn, 10), cuda_ms(plain, 3, 1)
        b, bound_by = (tc_bound_ms if kname in TC_KERNELS else bound_ms)(fl, nbytes)
        by[kname][key] = {"shape": f"tanh S={S} N={N} W={W} {tag} L={L}", "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b, "bound_by": bound_by,
                          "library_ms": cuda_ms(library, 10) if library is not None else None,
                          "launches_per_step": per_step.get(kname, 0)}
        log(f"[timing] {kname} at the {key} shape ({by[kname][key]['shape']}): {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {b:.4f} ms by {bound_by}"
            + (f", library {by[kname][key]['library_ms']:.4f} ms" if library is not None else "")
            + f"), launches per step {by[kname][key]['launches_per_step']}")
    del fargs, bargs, gzs, ins, partials, Y, GZ
    torch.cuda.empty_cache()


def time_ldc_kernels(rows, per_step):
    """The kernels' rows at the LDC recipes' shapes (S = 5), under the keys
    "ldc_piratenet", "ldc_sota" (the gated kernels and jet_wgrad over the
    segment's layers) and "ldc_plain" (the MLP kernels): time, plain time,
    bound and the launches per eager step of the recipe's kernel path."""
    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J

    S = len(NS2D) + 1
    names = [r["name"] for r in rows]
    for name, kind, n, spec in LDC_SHAPES:
        key = "ldc_" + name.split("_")[-1]
        if kind == "mlp":
            time_mlp_shape(rows, key, S, n, spec, J.TANH, {k: per_step[name].get(k, 0) for k in names})
        else:
            program = getattr(G, f"{spec[0]}_program")(spec[1])
            time_gated_shape(rows, key, S, n, 256, program, spec[0], per_step[name])


# --------------------------------------------- the elasticity and viv phases --

ARM_JET = [(0,), (1,), (2,)]  # each control-arm network's interior jet: the value and d/dx, d/dy, d/dz (S = 4)
ELASTICITY = dict(N=2048, dims=(3,) + (512,) * 6)  # the interior batch and each network's hidden layers
# 1 of the example's 2000 epochs (and 1 of the inverse's 100), each as one graph: the forward's 50 of its 100
# steps (cut for the script's time), the inverse's 100; each constraint samples one iteration's points
# (2048 interior, 128 + 128 + 512 boundary), not the example's batch x 100
ARM_FORWARD = dict(epochs=1, iters_per_epoch=50, sample_iters=1)
ARM_INVERSE = dict(epochs=1, iters_per_epoch=100, sample_iters=1)
ARM_GRAPH_K = 10  # graphed chunks against eager steps
BRACKET_RUN = dict(epochs=1, iters_per_epoch=20)  # 1 of the example's 30 epochs of 20 steps
# (K, replays) of the graphed-against-eager timings; the control arm's K cut for the script's time
ELASTICITY_TIMED = {"control_arm": (20, 3), "control_arm inverse": (100, 2), "bracket": (20, 3), "viv": (20, 5)}


def arm_index():
    from paddlescience_torch.autodiff import jet

    return jet.build_index(ARM_JET)


def check_elasticity_kernels(fwd):
    """The MLP kernels against their plain versions at the control arm's
    interior shape (S = 4: u, u_x, u_y, u_z; N = 2048 and a ragged 2047;
    SiLU; 3 -> 512 x 6) with the displacement network's weight-normed
    effective weights, as the example forms them; the registers and spills
    of the S = 4 instances. Returns the max abs errors."""
    import torch

    from paddlescience_torch.arch.mlp import _linear_eff
    from paddlescience_torch.autodiff import jet

    with torch.no_grad():
        ws, bs = zip(*(_linear_eff(layer) for layer in fwd.models[0].linears))
        params = ([w.detach().clone().contiguous() for w in ws], [b.detach().clone() for b in bs])
    errs = {}
    for n in (ELASTICITY["N"], ELASTICITY["N"] - 1):
        for k, v in check_kernels(len(ARM_JET) + 1, n, ELASTICITY["dims"], (jet.SILU, 0.0), params=params,
                                  index=arm_index()).items():
            errs[k] = max(errs.get(k, 0.0), v)
    for name in ("jet_mlp_fwd", "jet_mlp_bwd"):
        for fn, (regs, st, ld) in PTXAS.get(name, {}).items():
            if re.search(r"ILi4E", fn):
                log(f"[elasticity] {name}.cu S=4 instance {fn}: {regs} registers, {st} bytes spill stores, "
                    f"{ld} bytes spill loads")
    return errs


def run_elasticity_phase(tmp: str, ane_native_s: float):
    """control_arm forward and inverse and bracket_elasticity on the card:
    the seconds to build the solver with the C++ ray cast and with its
    numpy version, and to draw the aneurysm's interior points with each
    (the same points); the kernels at the control arm's
    shape; the forward problem unpinned through the autotuner (its pick),
    3 steps on jet_pallas_full against the plain jet path (losses 1e-4,
    gradients 1e-3), graphed chunks against eager steps (1e-6), ``train()``
    in 100-step graphs, graphed and eager steps/s; the inverse problem on
    the trained networks (frozen networks bitwise unchanged, the Lame
    networks moved, no backward kernel, the validator's L2Rel); the
    bracket's autotuner pick, ``train()`` and rates. Returns (launch counts
    by run, kernel launches per step, max abs errors, numbers)."""
    import numpy as np
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import bracket_elasticity, control_arm
    from paddlescience_torch.geometry.mesh import Mesh

    out, launches = {}, {}
    geom_path = control_arm.write_arm_stl(os.path.join(tmp, "control_arm.stl"))
    deriv_path.set_default(None)
    build_s = {}
    for native in (False, True):
        t0 = time.perf_counter()
        fwd, geom = control_arm.build_forward(output_dir=os.path.join(tmp, f"control_arm_{native}"),
                                              geom_path=geom_path, native=native, device="cuda", **ARM_FORWARD)
        build_s["native" if native else "numpy"] = time.perf_counter() - t0
    # the aneurysm's interior draw (2048 points, 9216 faces) on both versions: the same points, the sdf within 1e-6
    draws = {}
    for native in (True, False):
        mesh = Mesh(os.path.join(STL_DIR, "aneurysm_closed.stl"), native=native)
        np.random.seed(0)
        t0 = time.perf_counter()
        draws[native] = mesh.sample_interior(ANEURYSM["N"])
        build_s["aneurysm interior " + ("native" if native else "numpy")] = time.perf_counter() - t0
    same = all(np.array_equal(draws[True][k], draws[False][k]) for k in ("x", "y", "z"))
    sdf_err = float(np.abs(draws[True]["sdf"] - draws[False]["sdf"]).max() / np.abs(draws[False]["sdf"]).max())
    if not same or sdf_err > 1e-6:
        raise AssertionError(f"the C++ ray cast kept other points ({not same}) or its sdf is off by {sdf_err:.2e}")
    build_s["aneurysm solver native"] = ane_native_s
    out["build_s"] = build_s
    points = {n: tuple(next(iter(b[0].values())).shape)[0] for n, b in fwd._static_batches.items()}
    log(f"[elasticity] control_arm solver built in {build_s['native']:.2f} s with the C++ ray cast, "
        f"{build_s['numpy']:.2f} s with its numpy version; the aneurysm's {ANEURYSM['N']} interior points in "
        f"{build_s['aneurysm interior native']:.2f} s and {build_s['aneurysm interior numpy']:.2f} s (the same "
        f"points, sdf within {sdf_err:.1e} x max; the aneurysm solver built in {ane_native_s:.2f} s, [main]); "
        f"points a step {points}")

    errs = check_elasticity_kernels(fwd)
    fwd.train_step()  # collects the derivative requests, at the process default path
    req = fwd._jet_requests["INTERIOR"]
    n_streams = {len(jet.build_index(stack)) for reqs in req.values() for stack in reqs if stack}
    if n_streams != {len(ARM_JET) + 1}:
        raise AssertionError(f"control_arm: the interior jets have {n_streams} streams, expected {len(ARM_JET) + 1}")
    pick = run_autotune_phase({"control_arm": fwd})["control_arm"]
    out["autotune"] = pick
    per_step = check_ldc_against_plain_path(fwd, "control_arm", phase="elasticity")
    with on_path(pick["winner"]):
        check_graph_against_eager_rewound(fwd, "control_arm", ARM_GRAPH_K)
    logged, dt, counts = train_on_pick(fwd, "elasticity", "control_arm", pick["winner"])
    launches["elasticity control_arm"] = counts
    k = fwd._auto_fuse_steps()
    stats = fwd.graph_stats[k]
    log(f"[elasticity] control_arm train() {fwd.epochs} epochs x {fwd.iters_per_epoch} steps on "
        f"{pick['winner']} (the autotuner's pick), K={k}: {dt:.2f} s (capture {stats['capture_s']:.2f} s), "
        f"losses {[round(e['loss'], 6) for e in logged]}; launches at the warm-up and capture "
        f"{ {n: v for n, v in counts.items() if v} }")
    out["control_arm"] = time_graphed(fwd, "control_arm", *ELASTICITY_TIMED["control_arm"])
    out["control_arm"].update(final_loss=logged[-1]["loss"], train_s=dt, capture_s=stats["capture_s"],
                              launches_per_step_jet_pallas_full=per_step)

    inv = control_arm.build_inverse(fwd, geom, output_dir=os.path.join(tmp, "control_arm_inverse"), **ARM_INVERSE)
    frozen = {n: p.detach().clone() for n, p in inv.model.named_parameters() if not p.requires_grad}
    live = {n: p.detach().clone() for n, p in inv.model.named_parameters() if p.requires_grad}
    if not frozen or not all(n.startswith(("model_list.0.", "model_list.1.")) for n in frozen):
        raise AssertionError(f"control_arm inverse: frozen parameters {sorted(frozen)[:4]}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logged = inv.train()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    changed = [n for n, p in inv.model.named_parameters() if n in frozen and not torch.equal(p, frozen[n])]
    moved = [n for n, p in inv.model.named_parameters() if n in live and not torch.equal(p, live[n])]
    if changed or not moved or any(plain.values()):
        raise AssertionError(f"control_arm inverse: frozen parameters changed {changed[:4]}, Lame parameters moved "
                             f"{len(moved)}, plain versions on CUDA {plain}")
    metric, group = inv.eval()
    snap = inv.state
    torch.cuda.synchronize()
    reset_counts()
    inv.train_steps(2)
    torch.cuda.synchronize()
    step_counts, _ = read_counts()
    inv._load_state(snap)
    inv_per_step = {n: v / 2 for n, v in step_counts.items() if v}
    if step_counts["jet_mlp_bwd"] or step_counts["jet_wgrad"]:
        raise AssertionError(f"control_arm inverse: backward kernels launched for the frozen networks {step_counts}")
    log(f"[elasticity] control_arm inverse train() {inv.epochs} epoch x {inv.iters_per_epoch} steps in {dt:.2f} s: "
        f"the {len(frozen)} frozen parameter tensors bitwise unchanged, {len(moved)} of the Lame networks' "
        f"moved; final loss {logged[-1]['loss']:.6e}; validator {group}; kernel launches a step {inv_per_step} "
        f"(no jet_mlp_bwd, no jet_wgrad)")
    out["control_arm inverse"] = time_graphed(inv, "control_arm inverse", *ELASTICITY_TIMED["control_arm inverse"])
    out["control_arm inverse"].update(l2rel=group["elasticity"], launches_per_step=inv_per_step,
                                      final_loss=logged[-1]["loss"])
    launches["elasticity control_arm inverse"] = counts
    del inv, fwd
    torch.cuda.empty_cache()

    deriv_path.set_default(None)
    br = bracket_elasticity.build_solver(output_dir=os.path.join(tmp, "bracket"), device="cuda", **BRACKET_RUN)
    out["bracket autotune"] = run_autotune_phase({"bracket": br})["bracket"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logged = br.train()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    tip = bracket_elasticity.tip_deflection(br)
    if not all(math.isfinite(e["loss"]) for e in logged) or not math.isfinite(tip) or any(plain.values()):
        raise AssertionError(f"bracket: losses {logged}, tip {tip}, plain versions on CUDA {plain}")
    points = sum(next(iter(b[0].values())).shape[0] for b in br._static_batches.values())
    log(f"[elasticity] bracket train() {br.epochs} epoch x {br.iters_per_epoch} steps ({points} points a step) on "
        f"{out['bracket autotune']['winner']} in {dt:.2f} s: final loss {logged[-1]['loss']:.6e}, tip w {tip:.4e}; "
        f"launches {({n: v for n, v in counts.items() if v})}")
    out["bracket"] = time_graphed(br, "bracket", *ELASTICITY_TIMED["bracket"])
    out["bracket"].update(points_per_step=points, tip_w=tip)
    deriv_path.set_default(None)
    return launches, per_step, errs, out


def run_viv_phase(tmp: str):
    """The viv example at the JAX defaults (100 epochs of one 20-step graph,
    no path pinned): k1, k2 at the end, finite and moved from their
    starting values, the data misfit, graphed and eager steps/s."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import viv

    deriv_path.set_default(None)
    solver = viv.build_solver(output_dir=os.path.join(tmp, "viv"), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logged = solver.train()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = (float(solver.eq_params[k].detach()) for k in ("k1", "k2"))
    if not (math.isfinite(k1) and math.isfinite(k2) and k1 != viv.K1_INIT and k2 != viv.K2_INIT):
        raise AssertionError(f"viv: k1 {k1}, k2 {k2} (started at {viv.K1_INIT}, {viv.K2_INIT})")
    k, stats = next(iter(solver.graph_stats.items()))
    steps = solver.epochs * solver.iters_per_epoch
    log(f"[viv] train() {solver.epochs} epochs x {solver.iters_per_epoch} steps (K={k}, {stats['replays']} replays) "
        f"in {dt:.2f} s ({steps / (dt - stats['warmup_s'] - stats['capture_s']):.1f} steps/s between the captures): "
        f"k1 {k1:.6f} (from {viv.K1_INIT}, true {viv.K1_TRUE}), k2 {k2:.6f} (from {viv.K2_INIT}, true "
        f"{viv.K2_TRUE}); final loss {logged[-1]['loss']:.6e}")
    timing = time_graphed(solver, "viv", *ELASTICITY_TIMED["viv"])
    timing.update(k1=k1, k2=k2, train_s=dt, final_loss=logged[-1]["loss"])
    return timing


def time_elasticity_kernels(rows, per_step):
    """The MLP kernels' rows at the control arm's interior shape, under the
    key "control_arm", with the launches per step of its jet_pallas_full
    path."""
    from paddlescience_torch.autodiff import jet

    names = [r["name"] for r in rows]
    time_mlp_shape(rows, "control_arm", len(ARM_JET) + 1, ELASTICITY["N"], ELASTICITY["dims"], (jet.SILU, 0.0),
                   {k: per_step.get(k, 0) for k in names}, index=arm_index())


# ------------------------------- more than 8 streams: heart, aneurysm_flow --

HOOKE_JET = order2(3)  # heart's interior jet: u and every first and second derivative in 3-D (S = 10)
HEART = dict(N=1024, dims=(3,) + (256,) * 6)  # heart's interior batch (one iteration's points) and hidden layers
FLOW = dict(N=20480, dims=(3,) + (128,) * 5)  # aneurysm_flow's interior batch (2048 x 10 iterations) and layers
# (S, N, dims) of the halves kernels' checks: heart's shape at S = 9 and 10 with a ragged batch; S = 15 and 16 at
# width 256 (8-row tiles); aneurysm_flow's width at S = 10
HALVES_CHECKS = [(9, 1024, HEART["dims"]), (10, 1024, HEART["dims"]), (9, 1023, HEART["dims"]),
                 (10, 1023, HEART["dims"]), (15, 4096, (4,) + (256,) * 4), (16, 4096, (5,) + (256,) * 4),
                 (10, 2048, FLOW["dims"])]
# heart: each constraint samples one iteration's points (1024 interior, 128 on each boundary), not the example's
# batch x 20 iterations; 100 of the example's 200 epochs of 20 steps (the inverse's too)
HEART_RUN = dict(sample_iters=1, epochs=20)  # of 200 (cut for the script's time)
HEART_TIMED = (20, 3)  # (K, replays) of the graphed-against-eager timing
FLOW_TIMED = (10, 3)
PINN_SUITE = ("burgers", "shock_wave", "nlsmb_soliton", "nlsmb_rogue_wave", "heat_exchanger")
# train() cut for the script's time (PERF.md §4): of 40, 20 and 50 epochs
# shock_wave: 2 of 20 epochs (7282 kernels a step through nested jvp)
PINN_SUITE_RUN = {"burgers": dict(epochs=5), "shock_wave": dict(epochs=2), "nlsmb_rogue_wave": dict(epochs=10)}
PINN_CHECK_K = 3  # two graphed chunks of 3 steps against 6 eager steps
# the graphed-against-eager timing of each: K = 5, 5 eager steps timed, the eager steps not profiled
PINN_TIMED = dict(k=5, replays=3, eager_steps=5, profiled=0)

# the [transforms] phase: the examples at their JAX defaults, no path pinned, train() cut (PERF.md §4):
# name -> build_solver arguments
TRANSFORM_EXAMPLES = {
    "poiseuille_flow": dict(epochs=4),  # of 40 epochs x 50 steps
    "heat_pinn": dict(epochs=10),  # of 50 x 20
    "ldc2d_unsteady_Re10": dict(epochs=30),  # of 20000 x 1 (eager steps: one step an epoch)
    "volterra_ide": {},  # 50 x 20
    "biharmonic2d": dict(epochs=1),  # of 40 x 25, in graphs of TRANSFORM_FUSE["biharmonic2d"]
    "gpinn": dict(epochs=30),  # of 20000 x 1
    "fractional_poisson_2d": {},  # 200 x 1
    "bubble": dict(epochs=30),  # of 10000 x 1
}
# deephpms: pde -> each stage's epochs of one step (the example's: 60); KdV (order 3, between the
# two) runs on the CPU only: its two ETDRK4 fields alone take 11 s of host time
DEEPHPMS_RUN = {"burgers": (20, 20, 20), "ks": (2, 2, 2)}  # cut for the script's time (PERF.md §4)
TRANSFORM_CHECK_K = 2  # two graphed chunks of 2 steps against 4 eager steps (cut for the script's time)
# the graphed-against-eager timing: the check's 2-step graph replayed 3 times, 2 eager steps, none profiled
# (the profiler took 30 s over one eager step of biharmonic2d's or deephpms ks's nested jvp)
# train()'s graph size where one epoch's graph takes long to capture (19,463 kernels a step)
TRANSFORM_FUSE = {"biharmonic2d": 5}
TRANSFORM_TIMED = dict(k=TRANSFORM_CHECK_K, replays=3, eager_steps=2, profiled=0)


# the [toolkit] phase: the PINN-toolkit examples at their JAX defaults, train() cut (PERF.md §4)
NSFNET3_JET = [(0,), (1,), (2,), (3,), (0, 0), (1, 1), (2, 2)]  # nsfnet net 3's interior jet (x, y, z, t): S = 8
# its interior batch (the 2601 lattice points sampled for the epoch's 10 iterations at once, 10 permutations, as
# the JAX example's PointCloud samples them) and MLP 10x100 (4 inputs); the kernels are also timed at 2601 rows
NSFNET3 = dict(N=26010, N_points=2601, dims=(4,) + (100,) * 10)
TOOLKIT_RUN = {
    "nsfnet net 1": dict(epochs=10),  # of 2000 epochs x 10 steps
    "nsfnet net 3": dict(epochs=5),  # of 2000 x 10
    "darcy2d": dict(epochs=4),  # of 40 x 25
    "quick_start case 1": dict(epochs=2),  # of 10 x 100
    "quick_start case 2": dict(epochs=2),  # of 10 x 100
    "quick_start case 3": dict(epochs=5),  # of 50 L-BFGS steps
    "spinn_helmholtz3d": dict(epochs=1, iters_per_epoch=10),  # of 50 x 1000 (an eager step takes 0.5 s: capture)
}
# train()'s chunks (graphs; capturing a chunk costs about K eager steps, 0.15-0.65 s each in the nested-jvp stages)
TOOLKIT_K = {"nsfnet net 1": 10, "nsfnet net 3": 10, "spinn_helmholtz3d": 10, "deephpms": 5}
# of 60 epochs x 20 steps each (cut for the script's time)
DEEPHPMS_TOOLKIT = {"deephpms_ns": (10, 10), "deephpms_schrodinger": (10, 10, 1)}
TOOLKIT_CHECK_K = 2  # two graphed chunks of 2 steps against 4 eager steps (cut for the script's time)
TOOLKIT_TIMED = dict(k=TOOLKIT_CHECK_K, replays=3, eager_steps=2, profiled=0)


def check_halves_kernels():
    """The MLP kernels above 8 streams (the halves kernels) against their
    plain versions at HALVES_CHECKS, two calls bitwise equal at S = 10 and
    16, the registers and spills of every halves instance, and the
    refusals: S = 17, and the first refused S at width 512 (9), raise
    KernelRefusal before any launch. Returns the max abs errors."""
    import torch

    from paddlescience_torch.ops import jet_mlp as J

    errs = {}
    for S_, n, dims in HALVES_CHECKS:
        tag = f"S={S_} N={n} {dims[0]}->{'x'.join(map(str, dims[1:]))}"
        if not J.kernels_take(S_, dims) or not J.bwd_parks(S_, dims):
            raise AssertionError(f"the kernels were expected to take {tag}, the backward parked")
        for k, v in check_kernels(S_, n, dims, log_it=False).items():
            errs[k] = max(errs.get(k, 0.0), v)
        log(f"[kernels] halves {tag} (tile rows {J.tile_rows(S_, dims)}): fwd, bwd, wgrad within {REL_TOL} x max "
            f"of their plain versions and the backward of autograd")
    log("[kernels] halves: max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for S_, dims in ((10, HEART["dims"]), (16, (5,) + (256,) * 4)):
        idx, streams, weights, biases, g_out = make_inputs(S_, 4095, dims)
        calls = {"jet_mlp_fwd": lambda: J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True)}
        _, bounds = calls["jet_mlp_fwd"]()
        _, gzs = J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx)
        ys = [streams] + [b.unbind(0) for b in bounds]
        calls["jet_mlp_bwd"] = lambda: J.jet_mlp_bwd(streams, bounds, weights, biases, g_out, idx)
        calls["jet_wgrad"] = lambda: J.jet_wgrad(ys, gzs)
        for name, call in calls.items():
            first, second = call(), call()
            torch.cuda.synchronize()
            a, b = [*first[0], *first[1]], [*second[0], *second[1]]
            if not (len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))):
                raise AssertionError(f"{name} S={S_}: two calls on the same inputs differ")
        del streams, bounds, gzs, ys
    log("[kernels] halves: jet_mlp_fwd (outputs, boundaries), jet_mlp_bwd (input cotangents, gz), jet_wgrad "
        "(dW, db): two calls bitwise equal at S=10 (heart, N=4095) and S=16 (width 256)")
    for name in ("jet_mlp_fwd", "jet_mlp_bwd"):
        for fn, (regs, st, ld) in PTXAS.get(name, {}).items():
            if "halves" in fn:
                log(f"[kernels] {name}.cu {fn}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    for fn, (regs, st, ld) in PTXAS.get("jet_wgrad", {}).items():
        log(f"[kernels] jet_wgrad.cu {fn} (any S): {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    first_wide = min(S_ for S_ in range(1, J.MAX_STREAMS + 2) if not J.kernels_take(S_, ANEURYSM["dims"]))
    for S_, dims in ((J.MAX_STREAMS + 1, HEART["dims"]), (first_wide, ANEURYSM["dims"])):
        idx, streams, weights, biases, g_out = make_inputs(S_, 64, dims)
        torch.cuda.synchronize()
        reset_counts()
        refused = []
        for name, call in (("jet_mlp_fwd", lambda: J.jet_mlp_fwd(streams, weights, biases, idx)),
                           ("jet_mlp_bwd", lambda: J.jet_mlp_bwd(streams, [], weights, biases, g_out, idx))):
            try:
                call()
            except J.KernelRefusal as e:
                refused.append(f"{name}: {e}")
        counts, plain = read_counts()
        if len(refused) != 2 or any(counts.values()) or any(plain.values()):
            raise AssertionError(f"S={S_} {dims}: refusals {refused}, launches {counts}, plain calls {plain}")
        log(f"[kernels] S={S_} at {dims[0]}->{'x'.join(map(str, dims[1:]))}: KernelRefusal before any launch "
            f"({refused[0]})")
    return errs


def interior_streams(solver, name: str):
    """The stream counts of the jets that constraint ``name`` asks for."""
    from paddlescience_torch.autodiff import jet

    req = solver._jet_requests[name]
    return {len(jet.build_index(stack)) for reqs in req.values() for stack in reqs if stack}


def check_fresh_graph_against_eager(build, name: str, k: int):
    """A solver with an indexed constraint (its host batches drawn per
    chunk): one epoch of ``train(num_fused_steps=k)`` against one epoch of
    eager steps, each on a freshly built solver (the same seed, weights and
    loader order): parameters and equation parameters within 1e-6."""
    import torch

    runs = {}
    for kk in (1, k):
        solver = build()
        solver.train(num_fused_steps=kk)
        torch.cuda.synchronize()
        runs[kk] = torch.cat([flat_params(solver)] + [p.detach().reshape(-1) for p in solver.eq_params.values()])
    a, b = runs[1], runs[k]
    rel = float((a - b).norm() / a.norm())
    log(f"[graph] {name}: one epoch as graphed chunks of {k} steps vs eager steps from the same fresh state: "
        f"parameters rel err {rel:.3e}, bitwise {torch.equal(a, b)}")
    if not rel <= 1e-6:
        raise AssertionError(f"{name}: the graphed epoch disagrees with the eager one (rel {rel:.3e})")
    return rel


def train_on_pick(solver, phase: str, name: str, pick: str, k=None):
    """``train(num_fused_steps=k)`` on the autotuner's pick with the launch
    counters set to 0 just before (and the solver's captured graphs
    dropped, so that the run captures its own): every kernel of a kernel
    pick launched, no plain version on CUDA, finite losses. Returns (logs,
    seconds, launch counts)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path

    deriv_path.set_default(deriv_path.CANDIDATES[pick])
    solver.release_graphs()  # train() captures its own graph: the counters see its warm-up and capture launches
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logged = solver.train(num_fused_steps=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    if pick.startswith("jet_pallas"):
        check_counts(f"{phase}/{name}", counts, plain)
    bad = [e for e in logged if not all(math.isfinite(v) for k, v in e.items() if k.startswith("loss"))]
    if bad or not logged or any(plain.values()):
        raise AssertionError(f"{name}: non-finite or no losses {bad or logged}, plain versions on CUDA {plain}")
    return logged, dt, counts


def run_heart_phase(tmp: str):
    """heart and heart_inverse on the card, each: the interior jet's 10
    streams; the autotuner's pick over every candidate; 3 steps on
    jet_pallas_full against the plain jet path (losses 1e-4, gradients
    1e-3; the three MLP kernels launched every step); graphed chunks against
    eager steps (1e-6); ``train()`` for ``HEART_RUN``'s epochs (of the
    example's 200) x 20 steps on the pick; the L2Rel of u, v, w against the data (and E_hat); graphed and
    eager steps/s. Returns (launch counts by run, kernel launches a step
    on jet_pallas_full, numbers)."""
    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import heart

    out, launches, per_step = {}, {}, {}
    for problem in ("forward", "inverse"):
        name = "heart" if problem == "forward" else "heart_inverse"
        deriv_path.set_default(None)
        t0 = time.perf_counter()
        solver = heart.build_solver(problem, output_dir=os.path.join(tmp, name), geom_dir=os.path.join(tmp, "heart"),
                                    device="cuda", **HEART_RUN)
        build_s = time.perf_counter() - t0
        points = {n: tuple(next(iter(b[0].values())).shape)[0] for n, b in solver._static_batches.items()}
        pick = run_autotune_phase({name: solver})[name]
        per_step[name] = check_ldc_against_plain_path(solver, name, phase="heart")
        streams = interior_streams(solver, "INTERIOR")
        if streams != {len(HOOKE_JET) + 1}:
            raise AssertionError(f"{name}: the interior jets have {streams} streams, expected {len(HOOKE_JET) + 1}")
        with on_path(pick["winner"]):
            graph_rel = check_fresh_graph_against_eager(
                lambda: heart.build_solver(problem, output_dir=None, geom_dir=os.path.join(tmp, "heart"), device="cuda",
                                           **{**HEART_RUN, "epochs": 1}), name, HEART_TIMED[0])
        # the DATA loader is indexed, so train() alone would run eager steps: one graph of 20 steps an epoch
        logged, dt, counts = train_on_pick(solver, "heart", name, pick["winner"], HEART_TIMED[0])
        launches[f"heart {name}"] = counts
        rep = heart.report(solver)
        n_data = solver.constraint["DATA"].dataset.input["x"].shape[0]
        log(f"[heart] {name}: built in {build_s:.2f} s, points a step {points} + DATA {n_data}; interior jet "
            f"{streams} streams; train() {solver.epochs} epochs x {solver.iters_per_epoch} steps on {pick['winner']} "
            f"(the autotuner's pick), K={HEART_TIMED[0]}: {dt:.2f} s, final loss {logged[-1]['loss']:.6e}; {rep}; "
            f"launches {({n: v for n, v in counts.items() if v})}")
        out[name] = time_graphed(solver, name, *HEART_TIMED)
        out[name].update(report=rep, autotune=pick, train_s=dt, final_loss=logged[-1]["loss"], build_s=build_s,
                         graph_vs_eager_rel=graph_rel,
                         launches_per_step_jet_pallas_full=per_step[name], points_per_step=points)
        del solver
    deriv_path.set_default(None)
    return launches, per_step, out


def run_aneurysm_flow_phase(tmp: str):
    """aneurysm_flow on the card: the interior jet's 7 streams at width
    128; the autotuner's pick; 3 steps on jet_pallas_full against the plain
    jet path; graphed chunks against eager steps; ``train()`` for the
    example's 10 x 10 steps on the pick; the centerline w; graphed and
    eager steps/s. Returns (launch counts, launches a step, numbers)."""
    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import aneurysm_flow

    deriv_path.set_default(None)
    t0 = time.perf_counter()
    solver = aneurysm_flow.build_solver(output_dir=os.path.join(tmp, "aneurysm_flow"),
                                        stl_path=os.path.join(tmp, "aneurysm_tube.stl"), device="cuda")
    build_s = time.perf_counter() - t0
    points = {n: tuple(next(iter(b[0].values())).shape)[0] for n, b in solver._static_batches.items()}
    pick = run_autotune_phase({"aneurysm_flow": solver})["aneurysm_flow"]
    per_step = check_ldc_against_plain_path(solver, "aneurysm_flow", phase="aneurysm_flow")
    streams = interior_streams(solver, "EQ")
    if streams != {len(NS3D) + 1}:
        raise AssertionError(f"aneurysm_flow: the interior jets have {streams} streams, expected {len(NS3D) + 1}")
    with on_path(pick["winner"]):
        check_graph_against_eager_rewound(solver, "aneurysm_flow", FLOW_TIMED[0])
    logged, dt, counts = train_on_pick(solver, "aneurysm_flow", "aneurysm_flow", pick["winner"])
    w = aneurysm_flow.centerline_w(solver)
    log(f"[aneurysm_flow] built in {build_s:.2f} s, points a step {points}; interior jet {streams} streams; train() "
        f"{solver.epochs} epochs x {solver.iters_per_epoch} steps on {pick['winner']} (the autotuner's pick) in "
        f"{dt:.2f} s, losses {[round(e['loss'], 6) for e in logged]}; centerline w {w:.6f} (inlet plug 0.5); "
        f"launches {({n: v for n, v in counts.items() if v})}")
    out = time_graphed(solver, "aneurysm_flow", *FLOW_TIMED)
    out.update(centerline_w=w, autotune=pick, train_s=dt, final_loss=logged[-1]["loss"], build_s=build_s,
               launches_per_step_jet_pallas_full=per_step, points_per_step=points)
    deriv_path.set_default(None)
    return {"aneurysm_flow": counts}, per_step, out


def run_pinn_suite_phase(tmp: str):
    """The five small PINN examples at their JAX defaults, no path pinned
    (widths 50-64, under the lane gate: the plain jet path or nested jvp,
    no kernel): two graphed chunks of 3 steps against 6 eager steps from
    the same state (1e-6), the state restored;
    ``train()`` at the example's epochs (``PINN_SUITE_RUN`` cuts three);
    its final metric; graphed and
    eager steps/s and kernels a step. Returns the numbers."""
    import importlib

    import torch

    from paddlescience_torch.autodiff import path as deriv_path

    out = {}
    for name in PINN_SUITE:
        module = importlib.import_module(f"paddlescience_torch.examples.{name}")
        deriv_path.set_default(None)
        t0 = time.perf_counter()
        solver = module.build_solver(output_dir=os.path.join(tmp, name), device="cuda",
                                     **PINN_SUITE_RUN.get(name, {}))
        build_s = time.perf_counter() - t0
        snap = solver.state
        check_graph_against_eager_rewound(solver, name, PINN_CHECK_K)
        solver._load_state(snap)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logged = solver.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts, plain = read_counts()
        if not logged or not all(math.isfinite(e["loss"]) for e in logged) or any(plain.values()):
            raise AssertionError(f"{name}: losses {logged}, plain versions on CUDA {plain}")
        if name == "burgers":
            metric = {"L2Rel": module.l2rel(solver)}
        elif name == "shock_wave":
            metric = dict(zip(("rho_left", "rho_right"), module.density_jump(solver)))
        elif name.startswith("nlsmb"):
            metric = {"L2Rel": module.l2rel(solver)}
        else:
            metric = {"final_loss": module.final_loss(logged)}
        if not all(math.isfinite(v) for v in metric.values()):
            raise AssertionError(f"{name}: metric {metric}")
        k = solver._auto_fuse_steps()
        stats = solver.graph_stats[k]
        log(f"[pinn_suite] {name}: built in {build_s:.2f} s; train() {solver.epochs} epochs x "
            f"{solver.iters_per_epoch} steps (K={k}, capture {stats['capture_s']:.2f} s) in {dt:.2f} s, final loss "
            f"{logged[-1]['loss']:.6e}; {metric}; kernel launches {({n: v for n, v in counts.items() if v})}")
        out[name] = time_graphed(solver, name, **PINN_TIMED)
        out[name].update(metric=metric, train_s=dt, final_loss=logged[-1]["loss"], build_s=build_s,
                         kernel_launches=counts)
        del solver
        torch.cuda.empty_cache()
    deriv_path.set_default(None)
    return out


def _transform_metric(name: str, module, solver):
    if name == "heat_pinn":
        return {"mse_vs_fdm": module.evaluate_vs_fdm(solver)}
    if name == "ldc2d_unsteady_Re10":
        return module.residual_mse(solver)
    if name == "bubble":
        return module.field_mse(solver)
    return {"L2Rel": module.l2rel(solver)}


def _transform_run(label: str, solver, build_s: float, metric_fn, timed=None, k=None):
    """One solver of the [transforms] phase: two graphed chunks against
    eager steps from the same state (on ``timed`` where given: a solver of
    the same example whose batches take a graph), the state restored;
    ``train()`` with the kernel launches counted (none may run: every
    transformed net has no jet forward, the others sit under the lane gate
    with no path pinned, and no plain version may run on CUDA); the metric;
    graphed and eager steps/s, busy share and kernels a step (the trained
    state restored afterwards); ``k`` steps a graph in train() (None: the
    solver's default). Returns the numbers."""
    import torch

    timed = solver if timed is None else timed
    transformed = [m for m in solver.models if m.has_transform]
    if any(m.supports_jet() or m.jet_pallas_eligible() for m in transformed):
        raise AssertionError(f"{label}: a transformed net offers a jet forward or a fused segment")
    snap = timed.state
    check_graph_against_eager_rewound(timed, label, TRANSFORM_CHECK_K)
    timed._load_state(snap)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logged = solver.train(k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    if any(counts.values()) or any(plain.values()):
        raise AssertionError(f"{label}: kernel launches {counts}, plain versions on CUDA {plain}")
    if not logged or not all(math.isfinite(e["loss"]) for e in logged):
        raise AssertionError(f"{label}: losses {logged}")
    metric = metric_fn()
    if not all(math.isfinite(v) for v in metric.values()):
        raise AssertionError(f"{label}: metric {metric}")
    log(f"[transforms] {label}: built in {build_s:.2f} s; {len(transformed)} of {len(solver.models)} nets "
        f"transformed (nested jvp); train() {solver.epochs} epochs x {solver.iters_per_epoch} steps (K="
        f"{solver._auto_fuse_steps() if solver._all_constraints_static() else 1}) in {dt:.2f} s, final loss "
        f"{logged[-1]['loss']:.6e}; {metric}; kernel launches 0, plain versions on CUDA 0")
    trained = timed.state
    out = time_graphed(timed, label, **TRANSFORM_TIMED)
    timed._load_state(trained)
    out.update(metric=metric, train_s=dt, final_loss=logged[-1]["loss"], build_s=build_s,
               transformed=len(transformed), nets=len(solver.models))
    return out


def run_transforms_phase(tmp: str):
    """The nine examples of slice 16 on the card at their JAX defaults, no
    path pinned (``TRANSFORM_EXAMPLES``, their train() cut; deephpms's
    three stages for each pde of ``DEEPHPMS_RUN``): per solver,
    :func:`_transform_run`. bubble's graphed check and timing run on a
    second solver that feeds the whole training set each step: the
    example's 2419-point batches leave a short last one, which a static
    graph cannot take (its train() runs them eagerly). Returns the numbers."""
    import importlib

    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import deephpms

    out = {}
    for name, kwargs in TRANSFORM_EXAMPLES.items():
        module = importlib.import_module(f"paddlescience_torch.examples.{name}")
        deriv_path.set_default(None)
        t0 = time.perf_counter()
        solver = module.build_solver(output_dir=os.path.join(tmp, name), device="cuda", **kwargs)
        build_s = time.perf_counter() - t0
        timed = None
        if name == "bubble":
            n_train = len(solver.constraint["Sup"].dataset)
            timed = module.build_solver(output_dir=None, device="cuda", sup_batch=n_train, **kwargs)
        out[name] = _transform_run(name, solver, build_s, lambda: _transform_metric(name, module, solver), timed,
                                   TRANSFORM_FUSE.get(name))
        del solver, timed
        torch.cuda.empty_cache()
    for pde, epochs in DEEPHPMS_RUN.items():
        deriv_path.set_default(None)
        t0 = time.perf_counter()
        stages = deephpms.stages(epochs, output_dir=os.path.join(tmp, f"deephpms_{pde}"), pde=pde, device="cuda")
        for i, solver in enumerate(stages):
            build_s = time.perf_counter() - t0
            label = f"deephpms_{pde}/stage{i + 1}"
            out[label] = _transform_run(label, solver, build_s, lambda: {"L2Rel": solver.eval()[0]})
            t0 = time.perf_counter()
        torch.cuda.empty_cache()
    deriv_path.set_default(None)
    return out

def toolkit_state(solver):
    """Parameters, the aggregator's state and the averaged parameters, flat."""
    import torch

    parts = [flat_params(solver)] + [v.reshape(-1) for v in solver.agg_state.values()]
    parts += [v.reshape(-1) for v in solver.avg_params.values()] + [v.reshape(-1) for v in solver.eq_params.values()]
    return torch.cat(parts).detach().clone()


def check_toolkit_graph(solver, name: str, k: int = TOOLKIT_CHECK_K):
    """Two graphed chunks of k steps against 2k eager steps from the same
    state on one solver: parameters, the aggregator's state and the
    averaged parameters within 1e-6 relative. The state is restored."""
    import torch

    snap = solver.state
    for _ in range(2):
        solver.train_chunk(k)
    torch.cuda.synchronize()
    graphed = toolkit_state(solver)
    solver._load_state(snap)
    solver.train_steps(2 * k)
    torch.cuda.synchronize()
    eager = toolkit_state(solver)
    solver._load_state(snap)
    rel = float((graphed - eager).norm() / eager.norm())
    log(f"[toolkit] {name}: 2 graphed chunks of {k} steps vs {2 * k} eager steps from the same state: parameters"
        f"{', aggregator state' if solver.agg_state else ''}{', averaged parameters' if solver.avg_params else ''} "
        f"rel err {rel:.3e}, bitwise {torch.equal(graphed, eager)}")
    if not (rel <= 1e-6 and torch.isfinite(graphed).all()):
        raise AssertionError(f"{name}: the graphed chunks disagree with the eager steps (rel {rel:.3e})")
    return rel


def _toolkit_run(name: str, solver, build_s: float, metric_fn, k=None):
    """One solver of the [toolkit] phase: the graphed check;
    ``train(num_fused_steps=k)`` with the launch counters set to 0 just
    before (no plain version may run on CUDA); finite losses and metric;
    graphed and eager steps/s. Returns the numbers."""
    import torch

    t_start = time.perf_counter()
    rel = check_toolkit_graph(solver, name)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logged = solver.train(num_fused_steps=k)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    if any(plain.values()) or not logged or not all(math.isfinite(e["loss"]) for e in logged):
        raise AssertionError(f"{name}: losses {logged}, plain versions on CUDA {plain}")
    metric = metric_fn()
    if not all(math.isfinite(v) for v in metric.values()):
        raise AssertionError(f"{name}: metric {metric}")
    launches = {n: v for n, v in counts.items() if v}
    log(f"[toolkit] {name}: built in {build_s:.2f} s; train() {solver.epochs} epochs x {solver.iters_per_epoch} steps "
        f"(K={k or 1}) in {dt:.2f} s, final loss {logged[-1]['loss']:.6e}; {metric}; kernel launches {launches}, "
        f"plain versions on CUDA 0")
    out = {"metric": metric, "train_s": dt, "final_loss": logged[-1]["loss"], "build_s": build_s,
           "graph_vs_eager_rel": rel, "kernel_launches": launches}
    trained = solver.state
    out.update(time_graphed(solver, name, **TOOLKIT_TIMED))
    solver._load_state(trained)
    out["seconds"] = time.perf_counter() - t_start
    log(f"[toolkit] {name}: {out['seconds']:.1f} s for the check, train(), the metric and the timing")
    return out


def run_nsfnet3(tmp: str):
    """nsfnet net 3 (Beltrami, MLP 10x100, S = 8 on 26010 rows): the
    interior jet's streams; the interior loss and gradient of one batch on
    jet_pallas_full_sb against the plain jet path, then 3 steps on
    jet_pallas_full_sb and on jet_pallas_full against it (losses 1e-4,
    gradients 1e-3; the MLP kernels launched every step); the autotuner's pick;
    graphed chunks against eager steps; train() on the pick. Returns
    (numbers, launches a step on jet_pallas_full_sb, on jet_pallas_full,
    train() launches)."""
    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import nsfnet

    deriv_path.set_default(None)
    t0 = time.perf_counter()
    solver = nsfnet.build_solver(3, output_dir=os.path.join(tmp, "nsfnet3"), device="cuda",
                                 **TOOLKIT_RUN["nsfnet net 3"])
    build_s = time.perf_counter() - t0
    sizes = {"EQ": int(next(iter(solver._static_batches["EQ"][0].values())).shape[0]),
             **{n: len(solver.constraint[n].dataset) for n in ("Sup_b", "Sup_0")}}
    if sizes != {"EQ": NSFNET3["N"], "Sup_b": 59400, "Sup_0": 29791}:
        raise AssertionError(f"nsfnet net 3: batches {sizes}")
    solver._stage_host_batches(1)  # the supervised sets' batch (indexed loaders), which _batches() reads
    solver._chunk_pos = 0
    check_against_plain_path(solver, "nsfnet net 3", ("jet_pallas_full_sb",), parts=("linears", "last_fc"))
    per_sb = check_ldc_against_plain_path(solver, "nsfnet net 3", phase="toolkit", kernel_path="jet_pallas_full_sb")
    per_full = check_ldc_against_plain_path(solver, "nsfnet net 3", phase="toolkit")
    streams = interior_streams(solver, "EQ")
    if streams != {len(NSFNET3_JET) + 1}:
        raise AssertionError(f"nsfnet net 3: the interior jets have {streams} streams, expected {len(NSFNET3_JET) + 1}")
    pick = run_autotune_phase({"nsfnet net 3": solver})["nsfnet net 3"]
    with on_path(pick["winner"]):
        rel = check_toolkit_graph(solver, "nsfnet net 3")
    logged, dt, counts = train_on_pick(solver, "toolkit", "nsfnet net 3", pick["winner"], TOOLKIT_K["nsfnet net 3"])
    metric = nsfnet.l2rel(solver)
    if not all(math.isfinite(v) for v in metric.values()):
        raise AssertionError(f"nsfnet net 3: metric {metric}")
    log(f"[toolkit] nsfnet net 3: built in {build_s:.2f} s, batches {sizes}; interior jet {streams} streams; train() "
        f"{solver.epochs} epochs x {solver.iters_per_epoch} steps on {pick['winner']} (the autotuner's pick), K="
        f"{TOOLKIT_K['nsfnet net 3']}: {dt:.2f} s, final loss {logged[-1]['loss']:.6e}; {metric}; launches "
        f"{({n: v for n, v in counts.items() if v})}")
    with on_path(pick["winner"]):
        out = time_graphed(solver, "nsfnet net 3", **TOOLKIT_TIMED)
    out.update(metric=metric, autotune=pick, train_s=dt, final_loss=logged[-1]["loss"], build_s=build_s,
               graph_vs_eager_rel=rel, launches_per_step_jet_pallas_full_sb=per_sb,
               launches_per_step_jet_pallas_full=per_full)
    deriv_path.set_default(None)
    return out, per_sb, per_full, counts


def run_toolkit_phase(tmp: str):
    """The PINN-toolkit examples on the card at their JAX defaults, no path
    pinned (``TOOLKIT_RUN``: train() cut): nsfnet nets 1 and 3, darcy2d,
    quick_start cases 1-3, spinn_helmholtz3d, deephpms_ns and
    deephpms_schrodinger (``DEEPHPMS_TOOLKIT``), each through
    :func:`_toolkit_run`, nsfnet net 3 through :func:`run_nsfnet3`; then a
    PCGrad, a Relobralo and an EMA variant of darcy2d, each held graphed
    against eager. quick_start's shuffled loaders are held on fresh
    solvers (``check_fresh_graph_against_eager``); case 3 is L-BFGS, a host
    loop a step that is never captured. Returns (numbers, nsfnet net 3's
    launches a step on jet_pallas_full_sb and jet_pallas_full, its train()
    launches)."""
    import torch

    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import (darcy2d, deephpms_ns, deephpms_schrodinger, nsfnet, quick_start,
                                              spinn_helmholtz3d)
    from paddlescience_torch.loss import mtl
    from paddlescience_torch.optimizer import Adam
    from paddlescience_torch.optimizer.lr_scheduler import OneCycleLR
    from paddlescience_torch.solver import Solver
    from paddlescience_torch.utils import ema

    out = {}

    def build(fn):
        deriv_path.set_default(None)
        t0 = time.perf_counter()
        solver = fn()
        return solver, time.perf_counter() - t0

    solver, b = build(lambda: nsfnet.build_solver(1, output_dir=os.path.join(tmp, "nsfnet1"),
                                                                   device="cuda", **TOOLKIT_RUN["nsfnet net 1"]))
    out["nsfnet net 1"] = _toolkit_run("nsfnet net 1", solver, b, lambda: nsfnet.l2rel(solver),
                                       TOOLKIT_K["nsfnet net 1"])
    del solver
    out["nsfnet net 3"], per_sb, per_full, nsfnet3_counts = run_nsfnet3(tmp)
    torch.cuda.empty_cache()

    darcy = lambda **kw: darcy2d.build_solver(output_dir=os.path.join(tmp, "darcy2d"), device="cuda", **kw)
    solver, b = build(lambda: darcy(**TOOLKIT_RUN["darcy2d"]))
    out["darcy2d"] = _toolkit_run("darcy2d", solver, b, lambda: {"L2Rel": darcy2d.l2rel(solver)})
    for label, extra in (("darcy2d PCGrad", dict(loss_aggregator=mtl.PCGrad(None, 2))),
                         ("darcy2d Relobralo", dict(loss_aggregator=mtl.Relobralo(None, 2))),
                         ("darcy2d EMA", dict(ema_avg=ema.ExponentialMovingAverage(decay=0.9)))):
        base = darcy(epochs=1)
        lr = OneCycleLR(epochs=1, iters_per_epoch=base.iters_per_epoch, max_learning_rate=1e-3)()
        variant = Solver(base.model, base.constraint, None, Adam(lr)(base.model), epochs=1,
                         iters_per_epoch=base.iters_per_epoch, equation=base.equation, device="cuda", **extra)
        out[label] = {"graph_vs_eager_rel": check_toolkit_graph(variant, label)}
        if label == "darcy2d EMA":
            variant.train_steps(5)
            avg = torch.cat([v.reshape(-1) for v in variant.avg_params.values()])
            if torch.equal(avg, flat_params(variant)) or not torch.isfinite(avg).all():
                raise AssertionError("darcy2d EMA: the averaged parameters did not average")
        out[label].update(time_graphed(variant, label, **TOOLKIT_TIMED))
        del base, variant
    torch.cuda.empty_cache()

    for case in (1, 2):
        label = f"quick_start case {case}"
        make = getattr(quick_start, f"build_case{case}")
        rel = check_fresh_graph_against_eager(
            lambda: make(epochs=1, output_dir=None, device="cuda")[0], label, 10)
        (solver, ref), b = build(lambda: make(output_dir=os.path.join(tmp, "quick_start"), device="cuda",
                                                      **TOOLKIT_RUN[label]))
        deriv_path.set_default(None)
        reset_counts()
        t0 = time.perf_counter()
        l2 = quick_start.run_1d_case(solver, ref)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts, plain = read_counts()
        if any(plain.values()) or not math.isfinite(l2):
            raise AssertionError(f"{label}: l2_rel {l2}, plain versions on CUDA {plain}")
        log(f"[toolkit] {label}: built in {b:.2f} s; train() {solver.epochs} epochs x {solver.iters_per_epoch} steps "
            f"(K=1: a shuffled loader) in {dt:.2f} s, final loss {solver.loss_history[-1][1]:.6e}; l2_rel {l2:.5f}")
        out[label] = {"metric": {"l2_rel": l2}, "train_s": dt, "build_s": b, "graph_vs_eager_rel": rel}
        out[label].update(time_graphed(solver, label, **TOOLKIT_TIMED))
        del solver
    solver, b = build(lambda: quick_start.build_case3(
        output_dir=os.path.join(tmp, "quick_start3"), device="cuda", **TOOLKIT_RUN["quick_start case 3"]))
    reset_counts()
    t0 = time.perf_counter()
    w_max = quick_start.run_case3(solver)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    if any(plain.values()) or not math.isfinite(w_max) or not all(math.isfinite(v) for _, v in solver.loss_history):
        raise AssertionError(f"quick_start case 3: max |w| {w_max}, losses {solver.loss_history}, plain {plain}")
    log(f"[toolkit] quick_start case 3: built in {b:.2f} s (Halton: 20000 interior, 10000 + 10000 edge points); "
        f"{solver.epochs} L-BFGS steps (a host loop each, not captured) in {dt:.2f} s ({dt / solver.epochs * 1e3:.1f} ms "
        f"a step, {sum(solver.optimizer.evaluations)} value-and-gradient evaluations); losses "
        f"{solver.loss_history[0][1]:.6e} -> {solver.loss_history[-1][1]:.6e}; max |w| {w_max:.4e} m")
    out["quick_start case 3"] = {"metric": {"max_w": w_max}, "train_s": dt, "build_s": b,
                                 "evaluations": sum(solver.optimizer.evaluations)}
    del solver
    torch.cuda.empty_cache()

    solver, b = build(lambda: spinn_helmholtz3d.build_solver(
        output_dir=os.path.join(tmp, "spinn"), device="cuda", **TOOLKIT_RUN["spinn_helmholtz3d"]))
    snap = solver.state
    solver.model.branch_calls = 0
    solver.train_step()
    if solver.model.branch_calls != 12:  # the forward and one nested jvp per second derivative, 3 branch nets each
        raise AssertionError(f"spinn_helmholtz3d: {solver.model.branch_calls} branch-net calls a step, expected 12")
    solver._load_state(snap)
    out["spinn_helmholtz3d"] = _toolkit_run("spinn_helmholtz3d", solver, b,
                                            lambda: {"L2Rel": spinn_helmholtz3d.l2rel(solver)},
                                            TOOLKIT_K["spinn_helmholtz3d"])
    del solver
    torch.cuda.empty_cache()

    for name, epochs in DEEPHPMS_TOOLKIT.items():
        module = deephpms_ns if name == "deephpms_ns" else deephpms_schrodinger
        deriv_path.set_default(None)
        t0 = time.perf_counter()
        for i, solver in enumerate(module.stages(epochs, output_dir=os.path.join(tmp, name), device="cuda")):
            label = f"{name}/stage{i + 1}"
            out[label] = _toolkit_run(label, solver, time.perf_counter() - t0, lambda: {"L2Rel": solver.eval()[0]},
                                      TOOLKIT_K["deephpms"])
            t0 = time.perf_counter()
        torch.cuda.empty_cache()
    deriv_path.set_default(None)
    return out, per_sb, per_full, nsfnet3_counts


def time_nsfnet_kernels(rows, per_sb, per_full):
    """The MLP kernels' rows at nsfnet net 3's interior shape (S = 8, N =
    26010, 4 -> 100 x 10, tanh; key "nsfnet_net3") and at 2601 rows (the
    lattice points once; key "nsfnet_net3_2601_rows"), with the launches
    per step of the interior batch on jet_pallas_full_sb (and, beside
    them, on jet_pallas_full)."""
    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_mlp as J

    names = [r["name"] for r in rows]
    for key, n in (("nsfnet_net3", NSFNET3["N"]), ("nsfnet_net3_2601_rows", NSFNET3["N_points"])):
        time_mlp_shape(rows, key, len(NSFNET3_JET) + 1, n, NSFNET3["dims"], J.TANH,
                       {k: per_sb.get(k, 0) for k in names}, index=jet.build_index(NSFNET3_JET))
        for r in rows[:3]:
            r[key]["launches_per_step_jet_pallas_full"] = per_full.get(r["name"], 0)


def time_heart_flow_kernels(rows, heart_per_step, flow_per_step):
    """The MLP kernels' rows at heart's interior shape (S = 10, N = 1024,
    3 -> 256 x 6; key "heart") and aneurysm_flow's (S = 7, N = 20480, 3 ->
    128 x 5; key "aneurysm_flow"), with the launches per step of each
    forward problem's jet_pallas_full path."""
    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_mlp as J

    names = [r["name"] for r in rows]
    time_mlp_shape(rows, "heart", len(HOOKE_JET) + 1, HEART["N"], HEART["dims"], J.TANH,
                   {k: heart_per_step.get(k, 0) for k in names}, index=jet.build_index(HOOKE_JET))
    time_mlp_shape(rows, "aneurysm_flow", len(NS3D) + 1, FLOW["N"], FLOW["dims"], J.TANH,
                   {k: flow_per_step.get(k, 0) for k in names}, index=jet.build_index(NS3D))


# ------------------------------------- the eighteenth slice: XPINN, hPINNs, the operators --

XPINN_JET = [(0, 0), (1, 1)]  # each net's Laplacian: u_xx and u_yy, with u, u_x, u_y the jet has 5 streams
XPINN = dict(N=2000, dims=(2,) + (20,) * 4, rows=(2000, 900, 900, 100))  # the middle strip, the sides, an interface
XPINN_RESIDUALS = 7  # residual evaluations a step: 3 strips + 2 interfaces x 2 nets
XPINN_K = 50  # steps a graph: one epoch of the JAX configuration (10 x 50)
XPINN_JET_K = 10  # steps a graph when the plain jet path is timed beside the kernels
HPINNS_K = 10  # inner steps a graph: one outer iteration of 100 steps is 10 replays
HAND_TIMED = dict(replays=3, eager_steps=3, profiled=1)
GRAPH_TOL = 1e-6


class _HandLoop:
    """The ``train_step`` / ``train_chunk`` face that :func:`time_graphed`
    drives, over a hand loop's ``StepGraph``."""

    def __init__(self, loop):
        self.loop = loop

    def train_step(self):
        return self.loop.run(1, graphed=False)

    def train_chunk(self, k):
        return self.loop.run(k)


def check_hand_graph(name: str, loop, k: int, phase: str, bitwise: bool = False, convs: bool = True):
    """Two graphed chunks of k steps against 2k eager steps from one state
    of a hand loop, under cuDNN's deterministic algorithms where it runs
    ``convs``: everything a step changes within 1e-6 relative (with
    ``bitwise``: equal); the state restored after. Returns the relative
    error."""
    import torch

    from paddlescience_torch.utils.step_graph import deterministic_convs

    snap = loop.snapshot()
    with deterministic_convs() if convs else contextlib.nullcontext():  # cuDNN's atomics reorder its sums
        for _ in range(2):
            loop.run(k)
        torch.cuda.synchronize()
        graphed = torch.cat([t.detach().reshape(-1).float() for t in loop.state()])
        loop.restore(snap)
        loop.run(2 * k, graphed=False)
        torch.cuda.synchronize()
        eager = torch.cat([t.detach().reshape(-1).float() for t in loop.state()])
    loop.restore(snap)
    rel = float((graphed - eager).norm() / eager.norm())
    log(f"[{phase}] {name}: 2 graphed chunks of {k} steps vs {2 * k} eager steps from one state: parameters and "
        f"optimizer state rel err {rel:.3e}, bitwise {torch.equal(graphed, eager)}")
    if not (rel <= GRAPH_TOL and torch.isfinite(graphed).all()) or (bitwise and not torch.equal(graphed, eager)):
        raise AssertionError(f"{name}: the graphed chunks disagree with the eager steps (rel {rel:.3e})")
    return rel


def run_xpinn_phase():
    """XPINN at the JAX defaults (three MLPs 2 -> 20 x 4, tanh; 2000, 900,
    900 residual rows and 100 on each interface): the MLP kernels at each
    residual's rows against their plain versions; on one batch, the loss
    and gradient on jet_pallas_full (pinned whole) against the plain jet
    path and nested jvp (loss 1e-4, gradient 1e-3 of the largest
    magnitude); per residual evaluation one launch of jet_mlp_bwd and of
    jet_wgrad and two of jet_mlp_fwd (the backward's recompute);
    graphed chunks against eager steps; 500 steps (10 graphs of 50) on
    jet_pallas_full with the counters set to 0 just before (the warm-up's
    and the capture's steps launch through the wrappers, the replays
    through none), l2_rel; graphed and eager steps/s on jet_pallas_full and
    on the plain jet path.
    Returns (numbers, launches per step on jet_pallas_full, kernel errors,
    the 500 steps' launches)."""
    import torch

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.examples import xpinn
    from paddlescience_torch.utils.step_graph import WARMUP_STEPS

    t_start = time.perf_counter()
    errs = {}
    for n in sorted(set(XPINN["rows"]), reverse=True):
        for k, v in check_kernels(len(XPINN_JET) * 2 + 1, n, XPINN["dims"], index=jet.build_index(XPINN_JET)).items():
            errs[k] = max(errs.get(k, 0.0), v)
    model = xpinn.build(device="cuda")
    grads = {}
    for deriv in ("jet", "jvp", "jet_pallas_full"):
        with on_path(deriv):
            torch.cuda.synchronize()
            reset_counts()
            loss, *g = model.gradients()
            torch.cuda.synchronize()
            counts, plain = read_counts()
        grads[deriv] = (float(loss), torch.cat([t.reshape(-1) for t in g]))
        if deriv == "jet_pallas_full":
            per_step = counts
            # the backward recomputes the stage boundaries with a second forward (no save_bounds on this path)
            want = {"jet_mlp_fwd": 2 * XPINN_RESIDUALS, "jet_mlp_bwd": XPINN_RESIDUALS, "jet_wgrad": XPINN_RESIDUALS}
            got = {n: counts[n] for n in want}
            if got != want or any(v for n, v in counts.items() if n not in want) or any(plain.values()):
                raise AssertionError(f"xpinn: launches {counts} (expected per residual evaluation one forward, "
                                     f"its recompute, one jet_mlp_bwd and one jet_wgrad: {want}), plain versions "
                                     f"on CUDA {plain}")
    k_loss, k_grad = grads["jet_pallas_full"]
    cmp = {}
    for ref in ("jet", "jvp"):
        r_loss, r_grad = grads[ref]
        cmp[ref] = {"loss_rel": abs(k_loss - r_loss) / abs(r_loss),
                    "grad_rel": float((k_grad - r_grad).abs().max() / r_grad.abs().max())}
        log(f"[xpinn] one batch, jet_pallas_full vs {ref}: loss {k_loss:.9e} vs {r_loss:.9e} (rel "
            f"{cmp[ref]['loss_rel']:.3e}), gradient max abs diff {cmp[ref]['grad_rel']:.3e} x its largest magnitude")
        if cmp[ref]["loss_rel"] > 1e-4 or cmp[ref]["grad_rel"] > 1e-3:
            raise AssertionError(f"xpinn: jet_pallas_full disagrees with {ref}: {cmp[ref]}")
    log(f"[xpinn] jet_pallas_full: one batch launches {({n: v for n, v in per_step.items() if v})}: for each of the "
        f"{XPINN_RESIDUALS} residual evaluations one forward, its recompute in the backward, one jet_mlp_bwd and one "
        f"jet_wgrad; plain versions on CUDA 0")
    out = {"vs_plain_paths": cmp, "launches_per_step": {n: v for n, v in per_step.items() if v}}
    with on_path("jet_pallas_full"):
        out["graph_vs_eager_rel"] = check_hand_graph("xpinn", model.loop, 5, "xpinn")
        steps = model.cfg["epochs"] * model.cfg["iters_per_epoch"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss = model.train_steps(steps, XPINN_K)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts, plain = read_counts()
        l2 = model.l2_rel()
        # a replay launches through no wrapper: the counts are the warm-up's and the capture's steps
        counted = {n: (WARMUP_STEPS + XPINN_K) * v for n, v in out["launches_per_step"].items()}
        if any(counts[n] != v for n, v in counted.items()) or any(plain.values()) \
                or not (math.isfinite(loss) and math.isfinite(l2)):
            raise AssertionError(f"xpinn: {steps} steps: loss {loss}, l2_rel {l2}, launches {counts}, plain {plain}")
        log(f"[xpinn] {steps} steps on jet_pallas_full ({steps // XPINN_K} graphs of {XPINN_K}) in {train_s:.2f} s: "
            f"final loss {loss:.6e}, l2_rel {l2:.6e}; launches {({n: v for n, v in counts.items() if v})}")
        out.update(steps=steps, train_s=train_s, final_loss=loss, l2_rel=l2)
        out["jet_pallas_full"] = time_graphed(_HandLoop(model.loop), "xpinn jet_pallas_full", XPINN_K, **HAND_TIMED)
    with on_path("jet"):  # 3210 kernels a step on this path: graphs of XPINN_JET_K steps keep the capture short
        out["jet"] = time_graphed(_HandLoop(model.loop), "xpinn jet", XPINN_JET_K, **HAND_TIMED)
    out["seconds"] = time.perf_counter() - t_start
    log(f"[xpinn] {out['seconds']:.1f} s")
    return out, per_step, errs, counts


def run_hpinns_phase():
    """hPINNs at the JAX defaults (three MLPs 15 -> 48 x 4, 1500 objective
    and 5000 PDE points; nested jvp, no kernel): graphed chunks against
    eager steps; one outer iteration of 100 inner steps (5 graphs of 20)
    and the multiplier update in place; the PDE MSE and the objective,
    finite; graphed and eager steps/s."""
    import torch

    from paddlescience_torch.examples import hpinns

    t_start = time.perf_counter()
    model = hpinns.build(device="cuda")
    out = {"graph_vs_eager_rel": check_hand_graph("hpinns", model.loop, 3, "hpinns")}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logs = model.train_steps(100, HPINNS_K)
    mu0 = float(model.mu)
    model.lagrangian_update()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts, plain = read_counts()
    ev = model.evaluate()
    lam = float(model.lam_re.abs().max())
    if not all(math.isfinite(v) for v in list(logs.values()) + list(ev.values())) or any(plain.values()) \
            or float(model.mu) != 2 * mu0 or not lam > 0:
        raise AssertionError(f"hpinns: logs {logs}, {ev}, mu {float(model.mu)}, max |lambda| {lam}, plain {plain}")
    log(f"[hpinns] one outer iteration: 100 inner steps ({100 // HPINNS_K} graphs of {HPINNS_K}) and the multiplier "
        f"update in {train_s:.2f} s: loss {logs['loss']:.6e}, PDE MSE {ev['pde_mse']:.6e}, objective "
        f"{ev['objective']:.6e}, mu {mu0} -> {float(model.mu)}, max |lambda_re| {lam:.4e}; kernel launches "
        f"{({n: v for n, v in counts.items() if v})} (none expected)")
    out.update(train_s=train_s, **ev, final_loss=logs["loss"], mu=float(model.mu))
    out.update(time_graphed(_HandLoop(model.loop), "hpinns", HPINNS_K, replays=3, eager_steps=2, profiled=1))
    out["seconds"] = time.perf_counter() - t_start
    log(f"[hpinns] {out['seconds']:.1f} s")
    return out


# the [operators2] phase: each new operator example, cut (PERF.md §4)
OPERATORS2_RUN = {"darcy_uno": dict(epochs=2), "catheter": dict(epochs=20), "fourcastnet": {},
                  "fourcastnet_finetune": {}, "sfno_swe": {}, "adv_cvit": dict(epochs=3), "ns_cvit": dict(epochs=3)}
OPERATORS2_TIMED = dict(replays=3, eager_steps=3, profiled=1)
VGAN_STEPS, VGAN_K = 60, 20
YINGLONG_K = 10


def card_cpu_errors(model, inputs, dtype=None):
    """The module on the card against a copy of it on the CPU with the same
    weights, on the same inputs (both copies cast to ``dtype`` when given):
    the largest error of any output and of the parameter gradient of
    sum(out * c) (all parameters as one vector), each over its largest
    magnitude."""
    import copy

    import torch

    card = model if dtype is None else copy.deepcopy(model).to(dtype)
    cpu = copy.deepcopy(card).cpu()
    gen = torch.Generator().manual_seed(3)
    outs = {}
    for tag, m, dev in (("card", card, next(model.parameters()).device), ("cpu", cpu, "cpu")):
        feed = {k: v.to(dev, dtype or v.dtype) for k, v in inputs.items()}
        o = m(feed)
        if tag == "card":
            cots = {k: torch.randn(v.shape, generator=gen) for k, v in o.items()}
        loss = sum((v * cots[k].to(dev)).sum() for k, v in o.items())
        ps = [p for p in m.parameters() if p.requires_grad]
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        # the gradient as one vector: a parameter whose gradient is zero in exact arithmetic (an attention
        # key's bias: softmax ignores a shift) holds float32 noise, which only the whole gradient can scale
        outs[tag] = ([v.detach().cpu() for v in o.values()],
                     [torch.cat([(g if g is not None else torch.zeros_like(p)).detach().cpu().reshape(-1)
                                 for g, p in zip(gs, ps)])])
    rel = lambda a, b: float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))  # noqa: E731
    return (max(rel(a, b) for a, b in zip(outs["card"][0], outs["cpu"][0])),
            max(rel(a, b) for a, b in zip(outs["card"][1], outs["cpu"][1])))


def card_vs_cpu(name: str, model, inputs, phase: str = "operators2", dtype=None):
    """:func:`card_cpu_errors` held to 1e-4 of the largest magnitude (the
    FFT and padding traps show here). Returns the larger error."""
    worst = 0.0
    for part, err in zip(("output", "gradient"), card_cpu_errors(model, inputs, dtype)):
        worst = max(worst, err)
        if err > REL_TOL:
            raise AssertionError(f"{name}: the card disagrees with the CPU ({part}: {err:.3e} of the largest "
                                 "magnitude)")
    log(f"[{phase}] {name}: card vs CPU, same weights and inputs{'' if dtype is None else ', in ' + str(dtype)}: "
        f"outputs and parameter gradients within {worst:.3e} x their largest magnitude (limit {REL_TOL})")
    return worst


def _first_batch(solver, name: str):
    """The constraint's first host batch as CPU tensors."""
    import torch

    inp, _, _ = next(iter(solver.constraint.values())).data_iter.__next__()
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in inp.items()}


def run_operators2_phase(tmp: str):
    """The new operator examples at their defaults (epochs cut,
    ``OPERATORS2_RUN``): darcy_uno, catheter, fourcastnet and its finetune,
    sfno_swe, adv_cvit and ns_cvit through their solvers (card against CPU
    on a batch; one graphed epoch against eager steps; train() one graph an
    epoch; the metric; graphed and eager steps/s), yinglong and the
    velocity GAN through their hand loops (card against CPU; graphed
    against eager; the fit or the GAN's steps; the metric). Returns the
    numbers."""
    import torch

    from paddlescience_torch.examples import (adv_cvit, catheter, darcy_uno, fourcastnet, fourcastnet_finetune,
                                              ns_cvit, sfno_swe, velocitygan_fwi, yinglong)

    out = {}
    darcy_data = _darcy_data()  # the [operators] phase's samples
    makers = {
        "darcy_uno": lambda tag, **kw: darcy_uno.build_solver(data=darcy_data, output_dir=os.path.join(tmp, tag),
                                                              device="cuda", **kw),
        "catheter": lambda tag, **kw: catheter.build_solver(data_dir=None, output_dir=os.path.join(tmp, tag),
                                                            device="cuda", **kw),
        "fourcastnet": lambda tag, **kw: fourcastnet.build_solver(output_dir=os.path.join(tmp, tag), device="cuda",
                                                                  **kw),
        "fourcastnet_finetune": lambda tag, **kw: fourcastnet_finetune.build_solver(
            os.path.join(tmp, "fourcastnet", "checkpoints", "latest"), output_dir=os.path.join(tmp, tag),
            device="cuda", **kw),
        "sfno_swe": lambda tag, **kw: sfno_swe.build_solver(output_dir=os.path.join(tmp, tag), device="cuda", **kw),
        "adv_cvit": lambda tag, **kw: adv_cvit.build_solver(data_dir=None, output_dir=os.path.join(tmp, tag),
                                                            device="cuda", **kw),
        "ns_cvit": lambda tag, **kw: ns_cvit.build_solver(output_dir=os.path.join(tmp, tag), device="cuda", **kw),
    }
    for name, build in makers.items():
        t_start = time.perf_counter()
        solver = build(name, **OPERATORS2_RUN[name])
        num = {"card_vs_cpu": card_vs_cpu(name, solver.model, _first_batch(solver, name))}
        num["graph_check"] = check_operator_graph(name, lambda: build(name + "_chk", **OPERATORS2_RUN[name]))
        k = solver.iters_per_epoch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logged = solver.train(num_fused_steps=k)
        torch.cuda.synchronize()
        num["train_s"] = time.perf_counter() - t0
        metric, group = solver.eval()
        if name == "fourcastnet":
            solver._save("latest", print_log=False)
        if not math.isfinite(metric) or not all(math.isfinite(e["loss"]) for e in logged):
            raise AssertionError(f"{name}: metric {metric}, logs {logged[-3:]}")
        num.update(metric=metric, metrics=group, epochs=solver.epochs, steps=solver.epochs * k)
        log(f"[operators2] {name}: train() {solver.epochs} epochs x {k} steps, one graph an epoch, in "
            f"{num['train_s']:.2f} s; final loss {logged[-1]['loss']:.6e}; {group}")
        num.update(time_graphed(solver, name, k, **OPERATORS2_TIMED))
        num["seconds"] = time.perf_counter() - t_start
        out[name] = num

    t_start = time.perf_counter()
    yl = yinglong.YingLong(device="cuda")
    num = {"card_vs_cpu": card_vs_cpu("yinglong", yl.model, {"input": yl.x[:2]})}
    num["graph_vs_eager_rel"] = check_hand_graph("yinglong", yl.loop, 5, "operators2")
    num["fit_loss"] = yl.fit(40, YINGLONG_K)
    num["rollout_rmse"] = yl.rollout(4)
    if not all(math.isfinite(v) for v in num["rollout_rmse"] + [num["fit_loss"]]):
        raise AssertionError(f"yinglong: {num}")
    log(f"[operators2] yinglong: 40 fit steps (graphs of {YINGLONG_K}): loss {num['fit_loss']:.6e}; rollout RMSE "
        f"per step {[round(r, 6) for r in num['rollout_rmse']]}")
    num.update(time_graphed(_HandLoop(yl.loop), "yinglong", YINGLONG_K, **OPERATORS2_TIMED))
    num["seconds"] = time.perf_counter() - t_start
    out["yinglong"] = num

    t_start = time.perf_counter()
    gan = velocitygan_fwi.build(device="cuda")
    num = {"card_vs_cpu_generator": card_vs_cpu("velocity generator", gan.gen, {"data": gan.x[:4]}),
           "card_vs_cpu_discriminator": card_vs_cpu("velocity discriminator", gan.disc, {"velocity": gan.y[:4]})}
    num["graph_vs_eager_rel"] = check_hand_graph("velocitygan", gan.loop, 5, "operators2")
    first = gan.train_steps(1)
    last = gan.train_steps(VGAN_STEPS, VGAN_K)
    if not all(math.isfinite(v) for v in list(last.values()) + [first["l1"]]) or not last["l1"] < first["l1"]:
        raise AssertionError(f"velocitygan: L1 {first['l1']} -> {last}")
    num.update(first_l1=first["l1"], last_l1=last["l1"], d_loss=last["d_loss"], g_loss=last["g_loss"])
    log(f"[operators2] velocitygan: 1 + {VGAN_STEPS} step pairs (graphs of {VGAN_K}): L1 {first['l1']:.6f} -> "
        f"{last['l1']:.6f}, d loss {last['d_loss']:.6f}, g loss {last['g_loss']:.6f}")
    num.update(time_graphed(_HandLoop(gan.loop), "velocitygan", VGAN_K, **OPERATORS2_TIMED))
    num["seconds"] = time.perf_counter() - t_start
    out["velocitygan"] = num
    return out


# ----------------------- the nineteenth slice: the Earthformer family, the Koopman embeddings, Physformer --

# the reference ENSO pretrain width (tests/test_extformer_param_parity.py), batch 8
ENSO_FULL = dict(in_len=12, out_len=14, lat=24, lon=48, base_units=64, num_global_vectors=0, batch_size=8)
EARTHFORMER_EPOCHS = 2  # train() epochs of the example's 3 steps (cut for the script's time, PERF.md §4)
EARTHFORMER_TIMED = dict(replays=3, eager_steps=2, profiled=1)  # 2 eager steps: cut for the script's time
CARD_VS_CPU_SAMPLES = 1  # samples of the first batch held on the card against the CPU
# epochs: 5 of lorenz_koopman's 50 and of each rossler stage's 20 (cut for the script's time); physformer_lorenz its 4
KOOPMAN_RUN = {"lorenz_koopman": dict(epochs=5), "rossler": dict(epochs=5), "physformer_lorenz": {}}
KOOPMAN_TIMED = dict(replays=3, eager_steps=3, profiled=0)
GENERATE_LEN = 32  # entries of the Physformer rollout held on the card against the CPU


def check_dropout_active(name: str, solver, inputs, phase: str = "earthformer"):
    """Two train-mode forwards from different generator states differ, and
    two eval-mode forwards (no generator) are bitwise equal."""
    import torch

    model = solver.model
    feed = {k: v.cuda() for k, v in inputs.items()}
    outs = []
    with torch.no_grad():
        for seed in (1, 2, None, None):
            model.set_train_rng(None if seed is None else torch.Generator(device="cuda").manual_seed(seed))
            outs.append(next(iter(model(feed).values())))
    model.set_train_rng(None)
    differ, same = not torch.equal(outs[0], outs[1]), torch.equal(outs[2], outs[3])
    log(f"[{phase}] {name}: train-mode forwards from two generator states differ: {differ}; eval-mode forwards "
        f"bitwise equal: {same}")
    if not (differ and same):
        raise AssertionError(f"{name}: the training randomness is not active in train mode or not off in eval")


def train_slice_solver(phase: str, name: str, solver, k: int, timed):
    """``train(num_fused_steps=k)`` (one graph a chunk), ``eval()``, the
    numbers finite and no plain kernel version on CUDA; graphed and eager
    steps/s with the busy share and kernels per step; the peak memory the
    training held. Returns the numbers."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logged = solver.train(num_fused_steps=k)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    _, plain = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    metric, group = solver.eval()
    values = [metric] + [e["loss"] for e in logged] + [v for g in group.values() for v in g.values()]
    if not all(math.isfinite(v) for v in values) or any(plain.values()):
        raise AssertionError(f"{name}: metric {metric}, logs {logged[-3:]}, plain versions on CUDA {plain}")
    steps = solver.epochs * solver.iters_per_epoch
    log(f"[{phase}] {name}: train() {solver.epochs} epochs x {solver.iters_per_epoch} steps in graphs of {k} in "
        f"{train_s:.2f} s (the capture included), final loss {logged[-1]['loss']:.6e}, peak memory {peak:.3f} GiB; "
        f"{group}")
    num = {"train_s": train_s, "steps": steps, "final_loss": logged[-1]["loss"], "metric": metric,
           "metrics": group, "peak_memory_gib": peak}
    num.update(time_graphed(solver, name, k, **timed))
    return num


def run_earthformer_phase(tmp: str):
    """The ENSO Earthformer and ExtFormer-MoE at the reference ENSO pretrain
    width (input (12, 24, 48, 1), target (14, 24, 48, 1), base 64, 4 heads,
    depth (1, 1), no global vectors, axial / axial / cross_1x1, dropout 0.1
    at the three sites, batch 8; the MoE one with ``default_moe_config()``:
    10 experts, top-4, cuboid-latent gates) and SEVIR at the example's
    size, each through its solver: the card against the CPU on the first
    batch's first samples in eval mode; one graphed epoch against eager
    steps from one fresh state (dropout and the gates' noise drawn inside
    the graph); the training randomness on in train mode and off in eval;
    train() in graphed chunks, eval() (RMSE; SEVIR's skill scores); graphed
    and eager steps/s, busy share, kernels per step, peak memory. Returns
    the numbers."""
    import torch

    from paddlescience_torch.arch.cuboid_transformer import ExtFormerMoECuboid
    from paddlescience_torch.arch.extformer_moe import default_moe_config
    from paddlescience_torch.examples import earthformer_enso, earthformer_sevir

    full = dict(ENSO_FULL, epochs=EARTHFORMER_EPOCHS, device="cuda")
    makers = {
        "earthformer_enso": lambda tag: earthformer_enso.make_solver(output_dir=os.path.join(tmp, tag), **full),
        "extformer_moe_enso": lambda tag: earthformer_enso.make_solver(
            ExtFormerMoECuboid, output_dir=os.path.join(tmp, tag), moe_config=default_moe_config(), **full),
        "earthformer_sevir": lambda tag: earthformer_sevir.make_solver(
            epochs=EARTHFORMER_EPOCHS, output_dir=os.path.join(tmp, tag), device="cuda"),
    }
    out = {}
    torch.zeros(1, device="cuda")  # the CUDA context, outside the first build's seconds
    for name, build in makers.items():
        t_start = time.perf_counter()
        solver = build(name)
        num = {"build_s": time.perf_counter() - t_start,
               "parameters": sum(p.numel() for p in solver.model.parameters())}
        inputs = {k: v[:CARD_VS_CPU_SAMPLES] for k, v in _first_batch(solver, name).items()}
        solver.model.set_train_rng(None)
        t0 = time.perf_counter()
        # held in float32, the precision that trains (a TF32 or conv-algorithm fault shows here), and in float64,
        # where rounding is out of the way and only a fault of the logic would show; one sample: at two the
        # float32 gradient's rounding reaches the limit on either device (PERF.md §6)
        num["card_vs_cpu_float32"] = card_vs_cpu(name, solver.model, inputs, phase="earthformer")
        num["card_vs_cpu"] = card_vs_cpu(name, solver.model, inputs, phase="earthformer", dtype=torch.float64)
        num["card_vs_cpu_s"] = time.perf_counter() - t0
        log(f"[earthformer] {name}: both card vs CPU comparisons {num['card_vs_cpu_s']:.1f} s")
        check_dropout_active(name, solver, inputs)
        t0 = time.perf_counter()
        num["graph_check"] = check_operator_graph(name, lambda: build(name + "_chk"), phase="earthformer")
        num["graph_check_s"] = time.perf_counter() - t0
        num.update(train_slice_solver("earthformer", name, solver, solver.iters_per_epoch, EARTHFORMER_TIMED))
        num["seconds"] = time.perf_counter() - t_start
        log(f"[earthformer] {name}: {num['parameters']} parameters; {num['seconds']:.1f} s")
        out[name] = num
        del solver
        torch.cuda.empty_cache()
    return out


def run_koopman_phase(tmp: str):
    """lorenz_koopman, both rossler stages and both physformer_lorenz
    stages at the examples' sizes (epochs cut, ``KOOPMAN_RUN``): a few
    graphed epochs each (the Physformer stage-1 hand loop as one graph of
    its 60 steps, checked against eager steps), the loss and metric;
    graphed and eager steps/s; the Physformer's ``generate`` on the card
    against the CPU. Returns the numbers."""
    import copy

    import torch

    from paddlescience_torch.examples import lorenz_koopman, physformer_lorenz, rossler

    out = {}
    t_start = time.perf_counter()
    s = lorenz_koopman.build_solver(output_dir=os.path.join(tmp, "lorenz_koopman"), device="cuda",
                                    **KOOPMAN_RUN["lorenz_koopman"])
    out["lorenz_koopman"] = train_slice_solver("koopman", "lorenz_koopman", s, s.iters_per_epoch, KOOPMAN_TIMED)
    out["lorenz_koopman"]["seconds"] = time.perf_counter() - t_start

    t_start = time.perf_counter()
    run = KOOPMAN_RUN["rossler"]
    s = rossler.build_embedding(output_dir=os.path.join(tmp, "rossler"), device="cuda", **run)
    out["rossler_embedding"] = train_slice_solver("koopman", "rossler embedding", s, s.iters_per_epoch,
                                                  KOOPMAN_TIMED)
    s2 = rossler.build_transformer(s.model, output_dir=os.path.join(tmp, "rossler2"), device="cuda", **run)
    out["rossler_transformer"] = train_slice_solver("koopman", "rossler transformer", s2, s2.iters_per_epoch,
                                                    KOOPMAN_TIMED)
    out["rossler_transformer"]["seconds"] = time.perf_counter() - t_start

    t_start = time.perf_counter()
    stage1 = physformer_lorenz.EmbeddingPretrain(device="cuda")
    num = {"graph_vs_eager_rel": check_hand_graph("physformer stage 1", stage1.loop, 10, "koopman")}
    num["stage1_loss"] = stage1.train(60, 60)
    if not math.isfinite(num["stage1_loss"]):
        raise AssertionError(f"physformer stage 1: loss {num['stage1_loss']}")
    log(f"[koopman] physformer stage 1: 60 Adam steps as one graph, loss {num['stage1_loss']:.6e}")
    s = physformer_lorenz.build_solver(output_dir=os.path.join(tmp, "physformer"), embedding_model=stage1.model,
                                       device="cuda", **KOOPMAN_RUN["physformer_lorenz"])
    num.update(train_slice_solver("koopman", "physformer_lorenz", s, s.iters_per_epoch, KOOPMAN_TIMED))
    model = s.model
    x = torch.as_tensor(s.constraint["Sup"].dataset.input["embeds"][:4, :1], device="cuda")
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        card, ref = model.generate(x, GENERATE_LEN).cpu(), cpu.generate(x.cpu(), GENERATE_LEN)
    err = float((card - ref).abs().max() / ref.abs().max())
    log(f"[koopman] physformer generate: {GENERATE_LEN}-entry rollout of 4 sequences, card vs CPU within {err:.3e} "
        f"x the largest magnitude (limit {REL_TOL})")
    if not (err <= REL_TOL and card.shape == (4, GENERATE_LEN, x.shape[-1])):
        raise AssertionError(f"physformer generate: card vs CPU {err:.3e}, shape {tuple(card.shape)}")
    num.update(generate_card_vs_cpu=err, seconds=time.perf_counter() - t_start)
    out["physformer_lorenz"] = num
    return out


def time_xpinn_kernels(rows, per_step):
    """The MLP kernels' rows at XPINN's middle strip (S = 5: u, u_x, u_y,
    u_xx, u_yy; N = 2000; 2 -> 20 x 4, tanh; key "xpinn"), with the
    launches per step on jet_pallas_full (one of each per residual
    evaluation, 7 a step)."""
    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.ops import jet_mlp as J

    names = [r["name"] for r in rows]
    time_mlp_shape(rows, "xpinn", len(XPINN_JET) * 2 + 1, XPINN["N"], XPINN["dims"], J.TANH,
                   {k: per_step.get(k, 0) for k in names}, index=jet.build_index(XPINN_JET))


# ------------- the twentieth slice: the graph networks (segment sums), the transforms and UNetEx --

TGCN_NODES = (16, 307)  # the example's ring of sensors and PEMSD4's 307, both at full width, batch 64
TGCN_EPOCHS = {16: 10, 307: 2}  # of the example's 100 epochs of 44 steps (cut for the script's time, PERF.md §4)
# samples of the first batch held card against CPU in float64: at 307 nodes the CPU's float64 pass over the whole
# batch takes about 7 s, so 8 of its 64 (cut for the script's time, PERF.md §4)
TGCN_FLOAT64_ROWS = {16: 64, 307: 8}
GRAPH_FITS = {"amgnet_airfoil": 40, "amgnet_cylinder": 40, "cfdgcn": 60, "graphcast": 60, "cgcnn_property": 80}
SEGMENT_GRAPHS = {"amgnet": (64, 4), "knn4096": (4096, 4)}  # (nodes, neighbours) of the kNN graphs timed, hidden 64
SEGMENT_HIDDEN = 64
SLICE_TIMED = dict(calls=3, eager_steps=5, profiled=2)  # timed calls (a chunk, or eager_steps steps), profiled ones
DEV = "cuda"  # where this slice's phases run
UNETEX_RUN = {"topopt": dict(epochs=8), "deepcfd_unetex": dict(epochs=4)}  # the examples' own epochs


def _spread(times, steps: int):
    """(median ms a step, min, max) over timed calls of ``steps`` steps each."""
    ms = sorted(t / steps * 1e3 for t in times)
    return ms[len(ms) // 2], ms[0], ms[-1]


def time_slice_path(name: str, phase: str, eager, graphed, k: int, calls: int, eager_steps: int, profiled: int):
    """``eager()`` (one eager step) and ``graphed()`` (one call of ``k``
    graphed steps, captured already) of one path: steps/s from the median
    of ``calls`` timed calls each (host clock, each call ending in a
    synchronize; eager calls of ``eager_steps`` steps) with the fastest and
    slowest call beside it, the device's busy share and kernels a step from
    a profile of each (``profiled`` eager steps, one graphed call), and the
    peak memory over both. Returns the numbers."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager()
    graphed()
    torch.cuda.synchronize()
    times = {"eager": [], "graphed": []}
    for _ in range(calls):
        for tag, fn, n in (("eager", eager, eager_steps), ("graphed", graphed, 1)):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            times[tag].append(time.perf_counter() - t0)
    e_ms, e_lo, e_hi = _spread(times["eager"], eager_steps)
    g_ms, g_lo, g_hi = _spread(times["graphed"], k)
    _, e_busy, e_kernels = profile_steps(None, f"{name} eager", e_ms, steps=profiled, top=5, run=eager)
    _, g_busy, g_kernels = profile_steps(None, f"{name} graphed (K={k})", g_ms, steps=1, top=5, run=graphed,
                                         steps_per_run=k)
    peak = torch.cuda.max_memory_allocated() / 2**30
    share = lambda busy, ms: "not measured" if busy is None else f"{100 * busy / ms:.1f}% busy"  # noqa: E731
    log(f"[{phase}] timing {name}: eager {1e3 / e_ms:.2f} steps/s ({e_ms:.4f} ms a step, calls {e_lo:.4f}-{e_hi:.4f}, "
        f"{share(e_busy, e_ms)}, {e_kernels:.0f} kernels a step), graphed {1e3 / g_ms:.2f} steps/s ({g_ms:.4f} ms, "
        f"calls {g_lo:.4f}-{g_hi:.4f}, {share(g_busy, g_ms)}), K={k}, {calls} calls each; peak memory {peak:.3f} GiB")
    return {"eager_steps_per_s": 1e3 / e_ms, "eager_ms": e_ms, "eager_ms_range": [e_lo, e_hi],
            "eager_busy_ms": e_busy, "graphed_steps_per_s": 1e3 / g_ms, "graphed_ms": g_ms,
            "graphed_ms_range": [g_lo, g_hi], "graphed_busy_ms": g_busy, "kernels_per_step": [e_kernels, g_kernels],
            "K": k, "peak_memory_gib": peak}


def time_solver_path(name: str, phase: str, solver, k: int):
    return time_slice_path(name, phase, solver.train_step, lambda: solver.train_chunk(k), k, **SLICE_TIMED)


def _cast(tree, dtype):
    """Floating tensors of a nested input cast to ``dtype``."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


def _move(tree, device):
    """Tensors of a nested input (dicts, tuples, lists) moved to ``device``;
    host index arrays kept."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _move(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_move(v, device) for v in tree)
    return tree


def card_vs_cpu_both(name: str, model, inputs, phase: str, rows=None):
    """:func:`card_vs_cpu` in float32 on the first sample (the training
    precision: float32 gradient sums over a whole batch after a
    batch-statistics norm, or through cuDNN's weight-gradient algorithms,
    stray past 1e-4 from float64 on the card and the CPU alike, PERF.md
    §6) and in float64 on the whole batch, or its first ``rows`` samples
    (only a fault of the logic shows). Returns both errors."""
    import torch

    one = {k: v[:CARD_VS_CPU_SAMPLES] for k, v in inputs.items()}
    some = {k: v[:rows] for k, v in inputs.items()}
    return {"card_vs_cpu_float32": card_vs_cpu(name, model, one, phase=phase),
            "card_vs_cpu": card_vs_cpu(name, model, some, phase=phase, dtype=torch.float64)}


def graph_card_vs_cpu(name: str, model, inputs, phase: str = "graphs", dtype=None):
    """The graph model on the card against a copy on the CPU with the same
    weights (both cast to ``dtype`` when given), on one sample's inputs
    (graph indices on the host): the outputs and the whole parameter
    gradient of sum(out * c), each within 1e-4 of its largest magnitude.
    Returns the larger error."""
    import copy

    import torch

    card = model if dtype is None else copy.deepcopy(model).to(dtype)
    cpu = copy.deepcopy(card).cpu()
    gen = torch.Generator().manual_seed(3)
    outs = {}
    for tag, m, dev in (("card", card, DEV), ("cpu", cpu, "cpu")):
        feed = _move(inputs, dev)
        if dtype is not None:
            feed = _cast(feed, dtype)
        o = m(feed)
        if tag == "card":
            cots = {key: torch.randn(v.shape, generator=gen) for key, v in o.items()}
        loss = sum((v * cots[key].to(dev)).sum() for key, v in o.items())
        ps = [p for p in m.parameters() if p.requires_grad]
        gs = torch.autograd.grad(loss, ps)
        outs[tag] = (torch.cat([v.detach().cpu().reshape(-1) for v in o.values()]),
                     torch.cat([g.detach().cpu().reshape(-1) for g in gs]))
    errs = [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30)) for a, b in zip(outs["card"], outs["cpu"])]
    log(f"[{phase}] {name}: card vs CPU on one sample{'' if dtype is None else ', in ' + str(dtype)}: outputs "
        f"{errs[0]:.3e}, parameter gradient {errs[1]:.3e} of their largest magnitude (limit {REL_TOL})")
    if not max(errs) <= REL_TOL:
        raise AssertionError(f"{name}: the card disagrees with the CPU ({errs})")
    return max(errs)


def check_fit_graph(name: str, fit, steps: int, phase: str = "graphs"):
    """``steps`` graphed steps (each sample's own captured graph) against
    the same steps eager, from one state: parameters and Adam's state
    within 1e-6 relative (and whether bitwise); the state restored after."""
    import torch

    snap, step0 = fit.snapshot(), fit.step
    fit.train_steps(steps, graphed=True)
    torch.cuda.synchronize()
    graphed = torch.cat([t.detach().reshape(-1).float() for t in fit.state()])
    fit.restore(snap, step0)
    fit.train_steps(steps, graphed=False)
    torch.cuda.synchronize()
    eager = torch.cat([t.detach().reshape(-1).float() for t in fit.state()])
    fit.restore(snap, step0)
    rel = float((graphed - eager).norm() / eager.norm())
    bitwise = torch.equal(graphed, eager)
    log(f"[{phase}] {name}: {steps} graphed steps ({len(fit.loops)} captured graphs, one a sample) vs {steps} eager "
        f"steps from one state: rel err {rel:.3e}, bitwise {bitwise}")
    if not (rel <= GRAPH_TOL and torch.isfinite(graphed).all()):
        raise AssertionError(f"{name}: the graphed steps disagree with the eager ones (rel {rel:.3e})")
    return {"rel_err": rel, "bitwise": bitwise}


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one ``fn()`` call: ``reps`` calls captured in one CUDA
    graph (after warm-up calls on a side stream), its replay timed with
    CUDA events, so the host's launch work is out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5, warmup=1) / reps


def check_segment_pair(tag: str, n_nodes: int, k: int, rows):
    """The fixed-order segment sum and gather (``nn/segment.py``) at a kNN
    graph of ``n_nodes`` nodes, ``k`` neighbours, hidden 64: two calls
    bitwise equal, forward and backward; within 1e-5 of the largest
    magnitude of the ``index_add_`` version; the times (CUDA events) of
    each beside the byte bound. Appends a row to ``rows``; returns it."""
    import numpy as np
    import torch

    from paddlescience_torch.data.dataset.domain_dataset import make_synthetic_graph
    from paddlescience_torch.nn import segment as seg

    _, _, s, r, _ = make_synthetic_graph(np.random.default_rng(0), n_nodes, k, 5, 3, 3)
    F_ = SEGMENT_HIDDEN
    g = torch.Generator(device=DEV).manual_seed(0)
    e = torch.randn((len(r), F_), generator=g, device=DEV, requires_grad=True)
    x = torch.randn((n_nodes, F_), generator=g, device=DEV, requires_grad=True)
    cot_n, cot_e = torch.randn((n_nodes, F_), generator=g, device=DEV), torch.randn((len(r), F_), generator=g,
                                                                                        device=DEV)
    r_t, s_t = torch.as_tensor(r, device=DEV).long(), torch.as_tensor(s, device=DEV).long()

    def ours():
        agg, rows_ = seg.segment_sum(e, r, n_nodes), seg.gather(x, s)
        return (agg, rows_) + torch.autograd.grad((agg * cot_n).sum() + (rows_ * cot_e).sum(), (e, x))

    def plain():
        agg, rows_ = seg.segment_sum_plain(e, r_t, n_nodes), seg.gather_plain(x, s_t)
        return (agg, rows_) + torch.autograd.grad((agg * cot_n).sum() + (rows_ * cot_e).sum(), (e, x))

    a, b = [t.detach() for t in ours()], [t.detach() for t in ours()]
    bitwise = all(torch.equal(p, q) for p, q in zip(a, b))
    ref = [t.detach() for t in plain()]
    err = max(float((p - q).abs().max() / max(float(q.abs().max()), 1e-30)) for p, q in zip(a, ref))
    plan = seg.segments(r, n_nodes)
    ed = e.detach()
    fns = {"sum": lambda: seg.segment_sum(ed, r, n_nodes), "index_add": lambda: seg.segment_sum_plain(ed, r_t, n_nodes),
           "pair": ours, "plain_pair": plain}
    call_ms = {key: cuda_ms(fn, reps=20) for key, fn in fns.items()}  # back-to-back calls: the host's work included
    device_ms = {key: graph_ms(fn) for key, fn in fns.items()}  # replayed from a CUDA graph: the device's alone
    nbytes = 4 * (len(r) * F_ + n_nodes * F_) + 8 * (len(r) + n_nodes)  # rows read, sums written, order, offsets
    bound, by = bound_ms(len(r) * F_, nbytes)
    row = {"graph": tag, "nodes": n_nodes, "edges": len(r), "hidden": F_, "max_in_degree": int(plan.counts.max()),
           "bitwise_two_calls": bitwise, "rel_err_vs_index_add": err, "call_ms": call_ms, "device_ms": device_ms,
           "sum_bound_ms": bound, "sum_bound_by": by}
    log(f"[graphs] segment pair at {tag} ({n_nodes} nodes, {len(r)} edges, hidden {F_}, max in-degree "
        f"{int(plan.counts.max())}): two calls bitwise {bitwise} (forward and backward), vs index_add_ {err:.3e} of the "
        f"largest magnitude; device ms a call (graph replay): fixed-order sum {device_ms['sum']:.4f} vs index_add_ "
        f"{device_ms['index_add']:.4f} (bound {bound:.4f} by {by}), gather + sum forward and backward "
        f"{device_ms['pair']:.4f} vs the plain pair {device_ms['plain_pair']:.4f}; back-to-back calls (host "
        f"included): {call_ms['sum']:.4f} / {call_ms['index_add']:.4f} / {call_ms['pair']:.4f} / "
        f"{call_ms['plain_pair']:.4f}")
    if not (bitwise and err <= 1e-5):
        raise AssertionError(f"segment pair at {tag}: bitwise {bitwise}, error {err:.3e}")
    rows.append(row)
    return row


def run_graphs_phase(tmp: str):
    """The graph slice on the card: tgcn_pems through ``Solver.train``
    (graphed, at the example's 16 sensors and at PEMSD4's 307, full width,
    batch 64; graphed = eager; dropout on in train and off in eval; card
    against CPU on one batch; the final val MAE), the segment-sum pair at
    the AMGNet example's graph and at a 4096-node kNN graph, and the
    AMGNet (airfoil, cylinder), CFDGCN, GraphCast and CGCNN hand loops
    (card against CPU on one sample, graphed = eager, the examples' steps
    with the loss falling, GraphCast's RMSE); every path's graphed and
    eager steps/s with their spread, busy share, kernels a step and peak
    memory. Returns the numbers."""
    import torch

    from paddlescience_torch.examples import (amgnet_airfoil, amgnet_cylinder, cfdgcn, cgcnn_property, graphcast,
                                              tgcn_pems)

    out = {}
    torch.zeros(1, device=DEV)
    for nodes in TGCN_NODES:
        name = f"tgcn_pems {nodes} nodes"
        t_start = time.perf_counter()
        build = lambda tag, n=nodes: tgcn_pems.build_solver(  # noqa: E731
            epochs=TGCN_EPOCHS[n], num_nodes=n, output_dir=os.path.join(tmp, tag), device=DEV)
        solver = build(f"tgcn{nodes}")
        inputs = _first_batch(solver, name)
        solver.model.set_train_rng(None)
        parts = {"build": time.perf_counter() - t_start}
        num = card_vs_cpu_both(name, solver.model, inputs, "graphs", rows=TGCN_FLOAT64_ROWS[nodes])
        check_dropout_active(name, solver, inputs, phase="graphs")
        parts["card_vs_cpu"] = time.perf_counter() - t_start - sum(parts.values())
        num["graph_check"] = check_operator_graph(name, lambda: build(f"tgcn{nodes}_chk"), phase="graphs")
        parts["graph_check"] = time.perf_counter() - t_start - sum(parts.values())
        k = solver.iters_per_epoch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logged = solver.train(num_fused_steps=k)
        torch.cuda.synchronize()
        num["train_s"] = time.perf_counter() - t0
        metric, group = solver.eval()
        if not all(math.isfinite(v) for v in [metric] + [e["loss"] for e in logged]):
            raise AssertionError(f"{name}: val MAE {metric}, logs {logged[-3:]}")
        num.update(val_mae=group["pems_valid"]["MAE.label"], metrics=group, final_loss=logged[-1]["loss"],
                   steps=solver.epochs * k)
        log(f"[graphs] {name}: train() {solver.epochs} epochs x {k} steps, one graph an epoch, in "
            f"{num['train_s']:.2f} s, final loss {logged[-1]['loss']:.6e}; {group}")
        parts["train_eval"] = time.perf_counter() - t_start - sum(parts.values())
        num.update(time_solver_path(name, "graphs", solver, k))
        parts["timing"] = time.perf_counter() - t_start - sum(parts.values())
        num["seconds"], num["seconds_by_part"] = time.perf_counter() - t_start, parts
        log(f"[graphs] {name}: val MAE {num['val_mae']:.4f} after {solver.epochs} epochs; {num['seconds']:.1f} s "
            f"({', '.join(f'{key} {v:.1f}' for key, v in parts.items())})")
        out[name] = num
        del solver

    t0 = time.perf_counter()
    out["segment_pair"] = [check_segment_pair(tag, n, k, []) for tag, (n, k) in SEGMENT_GRAPHS.items()]
    log(f"[graphs] segment pairs: {time.perf_counter() - t0:.1f} s")

    builders = {"amgnet_airfoil": amgnet_airfoil.build, "amgnet_cylinder": amgnet_cylinder.build,
                "cfdgcn": cfdgcn.build, "graphcast": graphcast.build, "cgcnn_property": cgcnn_property.build}
    for name, build in builders.items():
        t_start = time.perf_counter()
        fit = build(device=DEV)
        inp, _ = fit.samples[0]
        num = {"card_vs_cpu_float32": graph_card_vs_cpu(name, fit.model, inp),
               "card_vs_cpu": graph_card_vs_cpu(name, fit.model, inp, dtype=torch.float64)}
        num["graph_check"] = check_fit_graph(name, fit, 2 * len(fit.samples))
        steps = GRAPH_FITS[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, last = fit.fit(steps)
        num.update(first_loss=first, last_loss=last, fit_s=time.perf_counter() - t0, steps=steps)
        if name == "graphcast":
            num["rmse"] = graphcast.rmse(fit)
        log(f"[graphs] {name}: {steps} Adam steps ({len(fit.loops)} captured graphs, one a sample) in "
            f"{num['fit_s']:.2f} s: loss {first:.6f} -> {last:.6f}"
            + (f"; per-node RMSE {num['rmse']:.6f}" if "rmse" in num else ""))
        n = len(fit.samples)
        t0 = time.perf_counter()
        num.update(time_slice_path(name, "graphs", lambda: fit.train_steps(1, graphed=False),
                                   lambda: fit.train_steps(n, graphed=True), n, **SLICE_TIMED))
        num["seconds"], num["timing_s"] = time.perf_counter() - t_start, time.perf_counter() - t0
        log(f"[graphs] {name}: {num['seconds']:.1f} s (timing {num['timing_s']:.1f})")
        out[name] = num
        fit.release()
    return out


def run_unetex_phase(tmp: str):
    """topopt and deepcfd_unetex through their solvers at the examples'
    defaults: card against CPU on one batch, one graphed epoch against
    eager steps (under cuDNN's deterministic algorithms), train() (topopt
    eager step by step, as its short last batch requires; deepcfd one graph
    an epoch), the metrics (Binary_Acc and IoU; MSE), graphed and eager
    steps/s with their spread, busy share, kernels a step and peak memory
    (topopt's timing loader drops the short last batch, so that every
    chunk has one shape). Returns the numbers."""
    import torch

    from paddlescience_torch.data import build_dataloader
    from paddlescience_torch.examples import deepcfd_unetex, topopt

    out = {}
    makers = {"topopt": topopt.build_solver, "deepcfd_unetex": deepcfd_unetex.build_solver}
    for name, make in makers.items():
        t_start = time.perf_counter()
        build = lambda tag, make=make, name=name: make(output_dir=os.path.join(tmp, tag), device=DEV,  # noqa: E731
                                                       **UNETEX_RUN[name])
        solver = build(name)
        num = card_vs_cpu_both(name, solver.model, _first_batch(solver, name), "unetex")
        num["graph_check"] = check_operator_graph(name, lambda: build(name + "_chk"), phase="unetex")
        k = solver.iters_per_epoch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logged = solver.train() if name == "topopt" else solver.train(num_fused_steps=k)
        torch.cuda.synchronize()
        num["train_s"] = time.perf_counter() - t0
        metric, group = solver.eval()
        values = [metric] + [e["loss"] for e in logged] + [v for g in group.values() for v in g.values()]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{name}: metric {metric}, logs {logged[-3:]}")
        num.update(metrics=group, final_loss=logged[-1]["loss"], steps=solver.epochs * k)
        log(f"[unetex] {name}: train() {solver.epochs} epochs x {k} steps "
            f"({'eager steps' if name == 'topopt' else 'one graph an epoch'}) in {num['train_s']:.2f} s, final loss "
            f"{logged[-1]['loss']:.6e}; {group}")
        if name == "topopt":
            cst = solver.constraint["sup_constraint"]
            cst.data_loader = build_dataloader(cst.dataset, {"batch_size": cst.data_loader.batch_size,
                                                             "sampler": {"shuffle": True, "drop_last": True}})
            cst.data_iter = iter(cst.data_loader)
        num.update(time_solver_path(name, "unetex", solver, k))
        num["seconds"] = time.perf_counter() - t_start
        out[name] = num
        del solver
    return out


# steps a graph: an epoch where an epoch is at most 25 steps, else 5; where a step is thousands of kernels
# (capturing costs ~65 us a launch: chip_heat 16,560 kernels a step, phylstm 7,337 and 10,453) 2 for the
# solver (train_chunk(1) runs eagerly) and 1 for the hand loops (cut for the script's time, PERF.md §4)
MISC_K = {"epnn_elastoplastic": 4, "phygeonet": 5, "phygeonet_bc": 5, "iops": 25, "chip_heat": 2,
          "transformer4sr": 5, "regae": 4, "phylstm_seismic": 1, "phylstm3_seismic": 1, "phycrnet_burgers": 5,
          "tempogan_lite": 5}
# timed calls of a chunk and of eager steps (median and range), profiled eager steps; where an eager step takes
# 0.2-0.8 s on the H100 (chip_heat, phylstm), 1 eager step a call and none profiled (the eager busy share not
# measured), chip_heat 2 calls (cut for the script's time, PERF.md §4)
MISC_TIMED = dict(calls=3, eager_steps=5, profiled=1)
_ONE_EAGER = dict(calls=3, eager_steps=1, profiled=0)
MISC_TIMED_CUT = {"chip_heat": dict(_ONE_EAGER, calls=2), "phylstm_seismic": _ONE_EAGER,
                  "phylstm3_seismic": _ONE_EAGER}
# chip_heat's Gaussian random fields: 100 + 100 of the example's 500 + 500 (each constraint's loader permutes the
# product of points, fields, types and boundary samples: 324 million indices at 500 + 500; cut for the script's
# time, PERF.md §4)
MISC_CHIP_HEAT = dict(nu=100, nbc=100)
MISC_FRAMES = dict(n_frames=16, nx=64)  # tempogan_lite's LBM frames: the example's own


class _Laps:
    """Seconds of the named parts of one path, each call closing a part."""

    def __init__(self):
        self.t = self.t0 = time.perf_counter()
        self.parts = {}

    def __call__(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part], self.t = now - self.t, now

    def total(self) -> float:
        return self.t - self.t0

    def __str__(self) -> str:
        return f"{self.total():.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in self.parts.items()) + ")"


def _has_convs(module) -> bool:
    """Whether cuDNN runs any of the module's layers (then a graphed-against-
    eager check holds it to its deterministic algorithms, and the timing,
    under its defaults, captures its own graph)."""
    from paddlescience_torch.nn.layers import Conv

    return any(isinstance(m, Conv) for m in module.modules())


def _rollout_module(model):
    """PhyCRNet's rollout from rest as a module of {"input": x} -> {"x1":
    ..., "x4": ...} (what :func:`card_cpu_errors` drives)."""
    import torch

    class Rollout(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, feed):
            out = self.inner({"initial_state": None, "input": feed["input"]})
            return {f"x{i + 1}": o for i, o in enumerate(out["outputs"])}

    return Rollout(model)


def misc_card_vs_cpu(name: str, model, inputs):
    """:func:`card_vs_cpu` on one batch in float32 (the training
    precision) and in float64 (a fault of the logic only), each held to
    REL_TOL. Returns both errors."""
    import torch

    return {"card_vs_cpu_float32": card_vs_cpu(name, model, inputs, phase="misc"),
            "card_vs_cpu_float64": card_vs_cpu(name, model, inputs, phase="misc", dtype=torch.float64)}


def check_misc_solver_graph(name: str, solver, k: int, phase: str = "misc", eager_first: bool = False):
    """One chunk of k steps as one CUDA graph against the same k steps
    eager, from one state of ``solver`` and on the same k staged host
    batches (a model with convolutions under cuDNN's deterministic
    algorithms): the parameters bitwise equal; the state restored after,
    the graph kept. With ``eager_first`` the eager steps run before the
    graph is captured: a captured graph's memory pool stays held, and where
    a step's convolutions are large (NowcastNet at 512^2) cuDNN then picks
    other algorithms for the eager steps that follow (less workspace free),
    so eager steps after a capture differ from those before it while the
    graph equals the eager steps run under the same memory. Returns the
    check's numbers."""
    import torch

    from paddlescience_torch.utils.step_graph import deterministic_convs

    loop = solver.loop
    solver._stage_host_batches(k)
    snap = loop.snapshot()
    runs = {}
    with deterministic_convs() if _has_convs(solver.model) else contextlib.nullcontext():
        for graphed_run in ((False, True) if eager_first else (True, False)):
            loop.restore(snap)
            loop.run(k, graphed=graphed_run)
            torch.cuda.synchronize()
            runs[graphed_run] = flat_params(solver).clone()
    graphed, eager = runs[True], runs[False]
    loop.restore(snap)
    rel = float((graphed - eager).norm() / eager.norm())
    bitwise = torch.equal(graphed, eager)
    log(f"[{phase}] {name}: one graph of {k} steps vs {k} eager steps from one state, on the same staged batches: "
        f"parameters rel err {rel:.3e}, bitwise {bitwise}, {solver.graph_stats[k]['replays']} replay(s)")
    if not (bitwise and solver.graph_stats[k]["replays"] == 1 and torch.isfinite(graphed).all()):
        raise AssertionError(f"{name}: the graphed chunk is not bitwise the eager steps (rel {rel:.3e})")
    return {"rel_err": rel, "bitwise": bitwise}


def misc_frames():
    """tempogan_lite's LBM frames on the card, the launch counters set to 0
    just before: every collide-and-stream step through the kernel (no plain
    version on CUDA), the frames within REL_TOL of the plain step's on the
    card. Returns (frames, launch counts, numbers)."""
    import torch

    from paddlescience_torch.examples import tempogan_lite
    from paddlescience_torch.ops import lbm

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    frames = tempogan_lite.make_lbm_frames(device=DEV, **MISC_FRAMES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, plain = read_counts()
    steps = MISC_FRAMES["n_frames"] * 50
    check_counts("misc tempogan_lite", counts, plain, steps=steps)
    ref = tempogan_lite.make_lbm_frames(device=DEV, step=lbm.lbm_step_plain, **MISC_FRAMES)
    err = check_close("tempogan_lite frames vs lbm_step_plain", frames, ref)
    nx = MISC_FRAMES["nx"]
    f = make_lattice(nx, nx)
    tau = 3.0 * (0.1 * nx / 400.0) + 0.5
    kernel_ms = graph_ms(lambda: lbm.lbm_collide_stream(f, tau))
    # back-to-back calls, host included: the method of the row's cavity-lattice time (ms_cavity_lattice)
    calls_ms = cuda_ms(lambda: lbm.lbm_collide_stream(f, tau))
    step_ms = cuda_ms(lambda: lbm.lbm_step(f, tau, 0.1))  # the walls index with host lists: not capturable
    bound, by = bound_ms(100.0 * nx * nx, 2 * 9 * nx * nx * 4.0)
    num = {"frames_s": dt, "launches": counts["lbm_collide_stream"], "launches_per_frame": counts["lbm_collide_stream"]
           / MISC_FRAMES["n_frames"], "max_abs_err_vs_plain": err, "kernel_ms_64": kernel_ms,
           "kernel_calls_ms_64": calls_ms, "step_ms_64": step_ms, "bound_ms_64": bound, "bound_by": by}
    log(f"[misc] tempogan_lite frames: {MISC_FRAMES['n_frames']} frames of {nx}x{nx}, {steps} LBM steps in "
        f"{dt:.3f} s, lbm_collide_stream launches {counts['lbm_collide_stream']} ({num['launches_per_frame']:.0f} a "
        f"frame), plain versions on CUDA {sum(plain.values())}; frames vs lbm_step_plain on the card max abs err "
        f"{err:.3e}; at {nx}x{nx} the kernel {kernel_ms:.4f} ms (device, graph replay), {calls_ms:.4f} ms "
        f"(back-to-back calls, host included), the whole step "
        f"{step_ms:.4f} ms (back-to-back calls, host included), bound {bound:.5f} ms by {by}")
    return frames, counts, num


def run_misc_phase(tmp: str):
    """The recurrent, misc and generative slice on the card at the
    examples' full widths: the solver examples (epnn_elastoplastic,
    phygeonet, phygeonet_bc, iops, chip_heat, transformer4sr, regae) and
    the hand loops (phylstm_seismic types 2 and 3, phycrnet_burgers,
    tempogan_lite on frames made by the LBM kernel): card against CPU on
    one batch (float32, and float64), graphed = eager bitwise, the metric
    or the loss finite (a hand loop's fallen), graphed and eager steps/s
    (3 calls of a chunk and of 5 eager steps: median and range), busy
    share, kernels a step and peak memory. Returns (the numbers, the LBM
    launch counts of tempogan_lite's frames)."""
    import torch

    from paddlescience_torch.examples import (chip_heat, epnn_elastoplastic, iops, phycrnet_burgers, phygeonet,
                                              phylstm_seismic, regae, tempogan_lite, transformer4sr)
    from paddlescience_torch.nn.resize import resize

    torch.zeros(1, device=DEV)
    out = {}
    def validators(solver):
        return solver, lambda s: s.eval()[1]

    def geo(d):
        solver, data = phygeonet.build_solver(output_dir=d, device=DEV)
        ref = phygeonet.jacobi_reference(data)
        return solver, lambda s: {"ev": phygeonet.evaluate_field(s, data, ref)}

    def geo_bc(d):
        solver, aux = phygeonet.build_solver_bc(output_dir=d, device=DEV)
        return solver, lambda s: {"ev": phygeonet.evaluate_field_bc(s, aux)}

    makers = {  # output dir -> (solver, its metrics once trained)
        "epnn_elastoplastic": lambda d: validators(epnn_elastoplastic.build_solver(output_dir=d, device=DEV)),
        "phygeonet": geo,
        "phygeonet_bc": geo_bc,
        "iops": lambda d: validators(iops.build_solver(output_dir=d, device=DEV)),
        "chip_heat": lambda d: validators(chip_heat.build_solver(output_dir=d, device=DEV, **MISC_CHIP_HEAT)),
        "transformer4sr": lambda d: validators(transformer4sr.build_solver(output_dir=d, device=DEV)),
        "regae": lambda d: validators(regae.build_solver(output_dir=d, device=DEV)),
    }
    for name, make in makers.items():
        lap = _Laps()
        k = MISC_K[name]
        solver, metrics = make(os.path.join(tmp, name))
        lap("build")
        num = {"graph_check": check_misc_solver_graph(name, solver, k)}
        lap("graph check")
        num.update(misc_card_vs_cpu(name, solver.model, _first_batch(solver, name)))
        lap("card vs CPU")
        num.update(time_slice_path(name, "misc", solver.train_step, lambda: solver.train_chunk(k), k,
                                   **MISC_TIMED_CUT.get(name, MISC_TIMED)))
        lap("timing")
        group = metrics(solver)
        values = [v for g in group.values() for v in (g.values() if isinstance(g, dict) else [g])]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{name}: metrics {group}")
        lap("metrics")
        num.update(metrics=group, seconds=lap.total(), seconds_by_part=lap.parts)
        log(f"[misc] {name}: {group}; {lap}")
        out[name] = num
        del solver

    frames, lbm_counts, out["tempogan_lite frames"] = misc_frames()
    loops = {
        "phylstm_seismic": lambda: phylstm_seismic.build(2, device=DEV),
        "phylstm3_seismic": lambda: phylstm_seismic.build(3, device=DEV),
        "phycrnet_burgers": lambda: phycrnet_burgers.build(device=DEV),
        "tempogan_lite": lambda: tempogan_lite.TempoGAN(device=DEV, frames=frames, **MISC_FRAMES),
    }
    for name, make in loops.items():
        lap = _Laps()
        k = MISC_K[name]
        fit = make()
        first = fit.train_steps(1)
        lap("build and a step")
        num = {}
        if name == "tempogan_lite":
            up = resize(fit.lo, fit.lo.shape[:2] + (fit.nx, fit.nx), "nearest")  # the generator's input
            num["generator"] = misc_card_vs_cpu(name + " generator", fit.gen, {"in": up})
            num["discriminator"] = misc_card_vs_cpu(name + " discriminator", fit.disc, {"x": fit.hi})
        elif name == "phycrnet_burgers":
            num.update(misc_card_vs_cpu(name, _rollout_module(fit.model), {"input": fit.u0}))
        else:
            num.update(misc_card_vs_cpu(name, fit.model, fit.inputs))
        lap("card vs CPU")
        num["graph_vs_eager_rel"] = check_hand_graph(name, fit.loop, k, "misc", bitwise=True,
                                                     convs=any(_has_convs(m) for m in fit.modules))
        lap("graph check")
        num.update(time_slice_path(name, "misc", lambda: fit.loop.run(1, graphed=False), lambda: fit.loop.run(k), k,
                                   **MISC_TIMED_CUT.get(name, MISC_TIMED)))
        lap("timing")
        last = {key: float(v) for key, v in fit.loop.run(k).items()}
        key = "pix" if name == "tempogan_lite" else "loss"
        if not (all(math.isfinite(v) for v in last.values()) and last[key] < first[key]):
            raise AssertionError(f"{name}: {key} {first[key]} -> {last[key]}")
        lap("last chunk")
        num.update(first=first, last=last, seconds=lap.total(), seconds_by_part=lap.parts)
        log(f"[misc] {name}: {key} {first[key]:.6f} -> {last[key]:.6f}; {lap}")
        out[name] = num
        fit.loop.release()
    return out, lbm_counts


# the [radar] phase: DGMR at the reference defaults (4 context frames of 256^2 -> 18, latent 768, context
# 384: 53.6M generator parameters), batch 2; its card-against-CPU check on one sample with the sampler cut to
# RADAR_CPU_STEPS forecast steps (every channel width and 256^2 kept: an 18-step forward and backward is ~1.5
# TFLOP a sample, minutes of CPU in float64), PERF.md §4
RADAR_DGMR = dict(t_in=4, t_out=18, hw=256, n_seq=2, latent_channels=768, context_channels=384)
RADAR_CPU_STEPS = 2
# NowcastNet at the JAX defaults (9 of 29 frames at 512^2, ngf 32) through the Solver on RadarDataset at 512^2,
# batch 2; card against CPU on one sample of a 256^2 field (the parameters do not depend on the field's size;
# the CPU at 512^2 would take tens of seconds in float64), PERF.md §4
RADAR_NOWCAST = dict(height=512, width=512, input_length=9, total_length=29, ngf=32, batch_size=2, num_cases=4)
RADAR_NOWCAST_CPU_HW = 256
# MoFlow at the reference QM9 depth (hidden 128, 10 bond blocks, 27 atom blocks)
RADAR_MOFLOW_QM9 = dict(b_hidden=128, a_hidden=128, b_n_blocks=10, a_n_blocks=27)
# the card's float32 gradient error against float64 is held to twice the CPU's in the same run, or this: the
# largest such error read on either device in PR 22's runs (card 1.49e-2, CPU 1.14e-2), rounded up (PERF.md §6)
F32_GRAD_FLOOR = 2e-2
RADAR_K = {"dgmr": 2, "nowcastnet": 2, "moflow_qm9": 10, "moflow_qm9 reference depth": 5}
RADAR_TIMED = {"dgmr": dict(calls=3, eager_steps=1, profiled=1), "nowcastnet": dict(calls=3, eager_steps=2, profiled=1),
               "moflow_qm9": dict(calls=3, eager_steps=5, profiled=1),
               "moflow_qm9 reference depth": dict(calls=3, eager_steps=2, profiled=1)}


def linalg_capture():
    """Whether ``torch.linalg.slogdet`` (forward, and with its backward) and
    ``torch.linalg.solve`` can be captured in a CUDA graph on this card and
    repeat bitwise: each captured (after a warm-up on a side stream),
    replayed twice, and held to the same call made eagerly. MoFlow's train
    step runs graphed, so a refused capture of slogdet or its backward
    raises; solve (only ``MoFlowNet.reverse``, never captured) is a
    finding, recorded with its error. A graph that replays other numbers
    than the eager call raises. Returns {op: {"captured": bool, "bitwise":
    bool, "error": str}}."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(5)
    w0 = torch.linalg.qr(torch.randn(36, 36, generator=g))[0].to(DEV)
    y0 = torch.randn(64, 9, 36, generator=g).to(DEV)
    w = w0.clone().requires_grad_(True)
    y = y0.clone()

    def slogdet_fwd():
        return torch.linalg.slogdet(w)[1].detach()

    def slogdet_bwd():
        if w.grad is not None:
            w.grad.zero_()
        torch.linalg.slogdet(w)[1].backward()
        return w.grad.detach().clone()

    def solve():
        return torch.linalg.solve(w.detach().T, y[..., None])[..., 0]

    out = {}
    for name, fn in (("slogdet", slogdet_fwd), ("slogdet backward", slogdet_bwd), ("solve", solve)):
        eager = fn().clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                res = fn()
        except Exception as e:
            if name != "solve":
                raise
            torch.cuda.synchronize()
            out[name] = {"captured": False, "bitwise": False, "error": f"{type(e).__name__}: {str(e)[:200]}"}
            log(f"[radar] CUDA-graph capture of torch.linalg.{name}: refused ({out[name]['error']})")
            continue
        reps = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            reps.append(res.clone())
        bitwise = all(torch.equal(r, eager) for r in reps)
        out[name] = {"captured": True, "bitwise": bitwise, "error": ""}
        log(f"[radar] CUDA-graph capture of torch.linalg.{name}: captured, 2 replays bitwise equal to the eager call: "
            f"{bitwise}")
        if not bitwise:
            raise AssertionError(f"torch.linalg.{name}: the captured graph replays other numbers than the eager call")
        del graph
    return out


def _outs_and_grad(model, inputs, device, dtype, cots=None):
    """A copy of ``model`` on ``device`` in ``dtype``: its outputs and the
    whole parameter gradient of sum(out * c), as float64 CPU vectors, and
    the cotangents c (drawn from a seeded generator when not given)."""
    import copy

    import torch

    m = copy.deepcopy(model).to(device, dtype)
    out = m({k: v.to(device, dtype) for k, v in inputs.items()})
    if cots is None:
        gen = torch.Generator().manual_seed(3)
        cots = {k: torch.randn(v.shape, generator=gen, dtype=torch.float64) for k, v in out.items()}
    loss = sum((v * cots[k].to(device, dtype)).sum() for k, v in out.items())
    ps = [p for p in m.parameters() if p.requires_grad]
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    flat = lambda ts: torch.cat([t.detach().reshape(-1).cpu().double() for t in ts])  # noqa: E731
    return flat(out.values()), flat(g if g is not None else torch.zeros_like(p) for g, p in zip(gs, ps)), cots


def _generative_half(model):
    """A module running NowcastNet ``model``'s generative half on
    ``feed["frames"]`` and ``feed["evo"]`` (the dict in, dict out of
    :func:`_outs_and_grad`)."""
    import torch

    class Half(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = model

        def forward(self, feed):
            return {"output": self.inner.generate(feed["frames"], feed["evo"])}

    return Half()


def _named_outputs(module, names):
    """A module running ``module(feed["x"])`` and naming its tuple of
    outputs ``names`` (the dict in, dict out of :func:`_outs_and_grad`)."""
    import torch

    class Named(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = module

        def forward(self, feed):
            return dict(zip(names, self.inner(feed["x"])))

    return Named()


def _hold_card_vs_cpu(name: str, model, inputs):
    """One module on the card against the CPU with the same weights and
    inputs, in float64 (outputs and the whole parameter gradient within
    REL_TOL of their largest magnitude: a fault of the logic shows) and in
    float32: the outputs within REL_TOL (TF32 or a wrong algorithm would
    show), and the gradient's error against the CPU's float64 gradient no
    more than twice the CPU's own float32 gradient's or F32_GRAD_FLOOR,
    whichever is larger (at these widths the float32 gradient strays
    5.7e-3-1.5e-2 from float64 on both devices, PERF.md §6, so two float32
    gradients cannot agree to REL_TOL). Returns the errors."""
    import torch

    rel = lambda a, b: float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))  # noqa: E731
    card64, g_card64, cots = _outs_and_grad(model, inputs, DEV, torch.float64)
    cpu64, g_cpu64, _ = _outs_and_grad(model, inputs, "cpu", torch.float64, cots)
    card32, g_card32, _ = _outs_and_grad(model, inputs, DEV, torch.float32, cots)
    cpu32, g_cpu32, _ = _outs_and_grad(model, inputs, "cpu", torch.float32, cots)
    num = {"float64_output": rel(card64, cpu64), "float64_gradient": rel(g_card64, g_cpu64),
           "float32_output": rel(card32, cpu32), "float32_gradient_card_vs_cpu": rel(g_card32, g_cpu32),
           "float32_gradient_card_vs_float64": rel(g_card32, g_cpu64),
           "float32_gradient_cpu_vs_float64": rel(g_cpu32, g_cpu64)}
    limit = max(2 * num["float32_gradient_cpu_vs_float64"], F32_GRAD_FLOOR)
    log(f"[radar] {name}: card vs CPU on one sample: float64 outputs {num['float64_output']:.3e}, gradient "
        f"{num['float64_gradient']:.3e}; float32 outputs {num['float32_output']:.3e}, gradient card vs CPU "
        f"{num['float32_gradient_card_vs_cpu']:.3e}, against the float64 gradient: card "
        f"{num['float32_gradient_card_vs_float64']:.3e}, CPU {num['float32_gradient_cpu_vs_float64']:.3e} "
        f"(limits {REL_TOL}, and {limit:.3e} for the card's float32 gradient)")
    if not (max(num["float64_output"], num["float64_gradient"], num["float32_output"]) <= REL_TOL
            and num["float32_gradient_card_vs_float64"] <= limit):
        raise AssertionError(f"{name}: the card disagrees with the CPU: {num}")
    return num


def radar_card_vs_cpu(name: str, model, inputs, parts=()):
    """:func:`_hold_card_vs_cpu` of ``model``; with ``parts``, (label,
    module, inputs) triples, the whole model is held in float64 only, its
    float32 errors logged, and each part is held in both (NowcastNet: its
    nearest warp rounds the flows to pixel indices, and float32 rounding
    differences between the devices move some of those indices; the
    generative half is fed the CPU's float64 advected frames on both
    devices, so the rounding cannot enter it, PERF.md §6). Returns the
    errors."""
    import torch

    if not parts:
        return _hold_card_vs_cpu(name, model, inputs)
    rel = lambda a, b: float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))  # noqa: E731
    card64, g_card64, cots = _outs_and_grad(model, inputs, DEV, torch.float64)
    cpu64, g_cpu64, _ = _outs_and_grad(model, inputs, "cpu", torch.float64, cots)
    card32, g_card32, _ = _outs_and_grad(model, inputs, DEV, torch.float32, cots)
    cpu32, g_cpu32, _ = _outs_and_grad(model, inputs, "cpu", torch.float32, cots)
    off = (card32 - cpu32).abs() > REL_TOL * cpu32.abs().max()
    num = {"whole_model_float64": {"output": rel(card64, cpu64), "gradient": rel(g_card64, g_cpu64)},
           "whole_model_float32": {"output": rel(card32, cpu32), "gradient_card_vs_cpu": rel(g_card32, g_cpu32),
                                   "output_share_off_by_1e-4": float(off.double().mean())}}
    log(f"[radar] {name}: the whole model card vs CPU in float64 {num['whole_model_float64']} (limit "
        f"{REL_TOL}); in float32 (not held: rounded flow indices) {num['whole_model_float32']}")
    if max(num["whole_model_float64"].values()) > REL_TOL:
        raise AssertionError(f"{name}: the card disagrees with the CPU in float64: {num}")
    for label, module, feed in parts:
        num[label] = _hold_card_vs_cpu(f"{name} {label}", module, feed)
    return num


def _dgmr_cut(model, steps: int):
    """A copy of the DGMR ``model`` whose sampler forecasts ``steps`` frames
    (its parameters do not depend on the count)."""
    import copy

    cut = copy.deepcopy(model)
    cut.sampler.forecast_steps = steps
    return cut


def run_radar_phase(tmp: str):
    """DGMR and NowcastNet at their reference widths and MoFlow at the
    example's and the reference QM9 depth, on the card: graphed = eager
    bitwise (cuDNN deterministic), card against CPU in float32 and
    float64, graphed and eager steps/s (median and range of 3 calls), busy
    share, kernels a step, peak memory, seconds by part; the examples'
    own configurations end to end with their checks; the CUDA-graph
    capture of slogdet and solve. Returns the numbers."""
    import copy

    import numpy as np
    import torch

    from paddlescience_torch.arch.dgmr import DGMRDiscriminator
    from paddlescience_torch.examples import dgmr, moflow_optimize, moflow_qm9, nowcastnet_radar
    from paddlescience_torch.utils.step_graph import deterministic_convs

    torch.zeros(1, device=DEV)
    out = {}

    # DGMR at the reference defaults
    lap = _Laps()
    k = RADAR_K["dgmr"]
    fit = dgmr.DGMRFit(**RADAR_DGMR, device=DEV)
    n_params = sum(p.numel() for p in fit.model.parameters())
    first = fit.train_steps(1)["loss"]
    lap("build and a step")
    num = {"parameters": n_params, "graph_vs_eager_rel": check_hand_graph("dgmr", fit.loop, k, "radar", bitwise=True)}
    lap("graph check")
    one = {"input_frames": fit.x[:1]}
    cut = _dgmr_cut(fit.model, RADAR_CPU_STEPS)
    num["card_vs_cpu"] = radar_card_vs_cpu(f"dgmr ({RADAR_CPU_STEPS} forecast steps)", cut, one)
    del cut
    lap("card vs CPU")
    num.update(time_slice_path("dgmr", "radar", lambda: fit.loop.run(1, graphed=False), lambda: fit.loop.run(k), k,
                               **RADAR_TIMED["dgmr"]))
    lap("timing")
    with torch.no_grad():
        frames = fit.forecast()
        disc = DGMRDiscriminator(input_channels=1, device=DEV)
        scores = disc(frames)
        torch.cuda.synchronize()
    d = RADAR_DGMR
    if not (frames.shape == (d["n_seq"], d["t_out"], 1, d["hw"], d["hw"]) and torch.isfinite(frames).all()
            and torch.isfinite(scores).all()):
        raise AssertionError(f"dgmr: forecast {tuple(frames.shape)}, scores {scores}")
    last = fit.train_steps(k, k)["loss"]
    if not math.isfinite(last):
        raise AssertionError(f"dgmr: grid-cell loss {first} -> {last}")
    lap("scores and a last chunk")
    num.update(first=first, last=last, scores=scores.reshape(2, 2).tolist(), seconds=lap.total(),
               seconds_by_part=lap.parts)
    log(f"[radar] dgmr: {n_params} parameters, {d['t_out']} frames of {d['hw']}^2 from {d['t_in']}, batch "
        f"{d['n_seq']}; grid-cell loss {first:.6f} -> "
        f"{last:.6f}; DGMRDiscriminator (spatial 4, temporal 3 layers) scores {scores.reshape(2, 2).tolist()}; {lap}")
    fit.loop.release()
    del fit, disc, frames
    out["dgmr"] = num

    lap = _Laps()
    grid, ex_scores = dgmr.run(device=DEV)
    lap("run")
    out["dgmr example"] = {"grid_loss": grid, "scores": ex_scores, "seconds": lap.total()}
    log(f"[radar] dgmr example (64^2, latent and context 32, 6 frames, 5 steps): {ex_scores}; {lap}")

    # NowcastNet at the JAX defaults through the Solver
    lap = _Laps()
    k = RADAR_K["nowcastnet"]
    solver = nowcastnet_radar.build_solver(epochs=1, output_dir=os.path.join(tmp, "nowcastnet"), device=DEV,
                                           iters_per_epoch=k, **RADAR_NOWCAST)
    lap("build")
    num = {"parameters": sum(p.numel() for p in solver.model.parameters()),
           "graph_check": check_misc_solver_graph("nowcastnet", solver, k, phase="radar", eager_first=True)}
    lap("graph check")
    batch = _first_batch(solver, "nowcastnet")["input"][:1]
    c = RADAR_NOWCAST_CPU_HW
    field = {"input": batch[:, :, :c, :c]}
    with torch.no_grad():
        frames64, evo64 = copy.deepcopy(solver.model).to("cpu", torch.float64).evolve(
            field["input"].to("cpu", torch.float64))
    num["card_vs_cpu"] = radar_card_vs_cpu(f"nowcastnet ({c}^2)", solver.model, field, parts=(
        ("evolution network", _named_outputs(solver.model.evo_net, ("intensity", "motion")),
         {"x": field["input"][..., 0]}),
        ("generative half", _generative_half(solver.model), {"frames": frames64, "evo": evo64})))
    del frames64, evo64
    lap("card vs CPU")
    # timed under cuDNN's deterministic algorithms, replaying the graph the check captured: a second graph at
    # 512^2 (its pool ~34 GiB) does not fit beside the first and the eager steps' cache (PERF.md §6)
    with deterministic_convs():
        num.update(time_slice_path("nowcastnet", "radar", solver.train_step, lambda: solver.train_chunk(k), k,
                                   **RADAR_TIMED["nowcastnet"]))
    lap("timing")
    logs = solver.train()
    pred = solver.predict({"input": batch.numpy()}, return_numpy=True)["output"]
    n = RADAR_NOWCAST
    if not (pred.shape == (1, n["total_length"] - n["input_length"], n["height"], n["width"], 1)
            and np.isfinite(pred).all() and math.isfinite(logs[-1]["loss"])):
        raise AssertionError(f"nowcastnet: prediction {pred.shape}, logs {logs}")
    lap("train an epoch and predict")
    num.update(loss=logs[-1]["loss"], seconds=lap.total(), seconds_by_part=lap.parts)
    log(f"[radar] nowcastnet: {num['parameters']} parameters, {n['total_length'] - n['input_length']} frames of "
        f"{n['height']}^2 from {n['input_length']}, batch {n['batch_size']}; loss {logs[-1]['loss']:.6f}; {lap}")
    solver.release_graphs()
    del solver
    gc.collect()
    torch.cuda.empty_cache()
    num["reserved_gib_after_release"] = torch.cuda.memory_reserved() / 2**30
    out["nowcastnet"] = num

    lap = _Laps()
    solver = nowcastnet_radar.build_solver(output_dir=os.path.join(tmp, "nowcastnet_example"), device=DEV)
    logs = solver.train(num_fused_steps=solver.iters_per_epoch)
    ds = nowcastnet_radar.build_dataset({"name": "RadarDataset", "input_keys": ("input",), "label_keys": ("output",),
                                         "image_width": nowcastnet_radar.W, "image_height": nowcastnet_radar.H,
                                         "total_length": nowcastnet_radar.TOTAL,
                                         "input_length": nowcastnet_radar.IN_LEN})
    pred = solver.predict({"input": ds.input["input"][:1]}, return_numpy=True)["output"]
    if not (pred.shape == (1, 6, 32, 32, 1) and np.isfinite(pred).all()
            and all(math.isfinite(v["loss"]) for v in logs)):
        raise AssertionError(f"nowcastnet example: prediction {pred.shape}, losses {logs}")
    lap("train 3 epochs graphed and predict")
    out["nowcastnet example"] = {"losses": [l["loss"] for l in logs], "mean_abs_prediction": float(np.abs(pred).mean()),
                                 "seconds": lap.total()}
    log(f"[radar] nowcastnet example (32^2, 4 of 10 frames, ngf 16, 3 epochs of 4 graphed steps): loss "
        f"{logs[0]['loss']:.6f} -> {logs[-1]['loss']:.6f}; {lap}")
    solver.release_graphs()
    del solver

    # MoFlow: the capture finding, then the examples
    lap = _Laps()
    out["linalg_capture"] = linalg_capture()
    lap("capture test")
    for name, model in (("moflow_qm9", {}), ("moflow_qm9 reference depth", RADAR_MOFLOW_QM9)):
        k = RADAR_K[name]
        fit = moflow_qm9.MoFlowFit(device=DEV, **model)
        first = fit.train_steps(1)["loss"]
        lap(f"{name} build and a step")
        num = {"parameters": sum(p.numel() for p in fit.model.parameters()),
               "graph_vs_eager_rel": check_hand_graph(name, fit.loop, k, "radar", bitwise=True, convs=False)}
        lap(f"{name} graph check")
        num.update(time_slice_path(name, "radar", lambda: fit.loop.run(1, graphed=False), lambda: fit.loop.run(k), k,
                                   **RADAR_TIMED[name]))
        lap(f"{name} timing")
        last = moflow_qm9.main(80 if name == "moflow_qm9" else 20, fit=fit)
        err = moflow_qm9.roundtrip_error(fit)
        if not (math.isfinite(last) and last < first and err < 1e-4):
            raise AssertionError(f"{name}: NLL {first} -> {last}, round trip {err}")
        lap(f"{name} main")
        num.update(first=first, last=last, roundtrip_err=err)
        log(f"[radar] {name}: {num['parameters']} parameters; NLL {first:.3f} -> {last:.3f}; round trip max err "
            f"{err:.3e}")
        fit.loop.release()
        out[name] = num
    opt = moflow_optimize.run(device=DEV)
    if not all(math.isfinite(v) for v in opt.values()):
        raise AssertionError(f"moflow_optimize: {opt}")
    lap("moflow_optimize")
    out["moflow_optimize"] = opt
    out["moflow seconds"] = {"total": lap.total(), "by_part": lap.parts}
    log(f"[radar] moflow_optimize: {opt}; MoFlow {lap}")
    return out


TC_KERNELS = ("jet_mlp_fwd", "jet_gated_fwd")  # kernels whose products run on the tensor cores (3xTF32)
REPLACES = {
    "jet_mlp_fwd": "paddlescience_tpu/ops/jet_pallas.py:361",
    "jet_mlp_bwd": "paddlescience_tpu/ops/jet_pallas.py:557",
    "jet_wgrad": "paddlescience_tpu/ops/jet_pallas.py:526",
    "jet_gated_fwd": "paddlescience_tpu/ops/jet_pallas.py:361",
    "jet_gated_bwd": "paddlescience_tpu/ops/jet_pallas.py:557",
    "lbm_collide_stream": "paddlescience_tpu/ops/lbm.py:141",
}


PROBES = ("xpinn", "hpinns", "operators2", "earthformer", "koopman", "graphs", "unetex", "misc", "radar")
KERNEL_FREE = ("operators2", "earthformer", "koopman", "graphs", "unetex", "radar")  # phases that launch no kernel of the port


def run_probe(only, tmp: str) -> int:
    """The named phases of this slice alone (``--only``)."""
    for phase in only:
        if phase == "xpinn":
            log("[xpinn] summary " + json.dumps(run_xpinn_phase()[0]))
        elif phase == "hpinns":
            log("[hpinns] summary " + json.dumps(run_hpinns_phase()))
        elif phase == "operators2":
            log("[operators2] summary " + json.dumps(run_operators2_phase(tmp)))
        elif phase == "earthformer":
            log("[earthformer] summary " + json.dumps(run_earthformer_phase(tmp)))
        elif phase == "koopman":
            log("[koopman] summary " + json.dumps(run_koopman_phase(tmp)))
        elif phase == "graphs":
            log("[graphs] summary " + json.dumps(run_graphs_phase(tmp)))
        elif phase == "unetex":
            log("[unetex] summary " + json.dumps(run_unetex_phase(tmp)))
        elif phase == "misc":
            log("[misc] summary " + json.dumps(run_misc_phase(tmp)[0]))
        elif phase == "radar":
            log("[radar] summary " + json.dumps(run_radar_phase(tmp)))
        else:
            raise ValueError(f"--only takes {', '.join(PROBES)}; not {phase}")
        mark(phase)
    log(f"[done] the probe's phases passed in {time.perf_counter() - T0:.1f} s (the build included)")
    return 0


def main() -> int:
    import torch

    only = []
    if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3:
        only = sys.argv[2].split(",")
    elif sys.argv[1:]:
        print(f"usage: chip_smoke.py [--only {','.join(PROBES)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import paddlescience_torch  # noqa: F401
        from paddlescience_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 3
    global T0
    T0 = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # the kernels compile in the background at the lowest priority, so the
    # phases that run meanwhile keep their core; a probe of kernel-free phases builds none
    nvcc = None if only and all(p in KERNEL_FREE for p in only) else cuda_build.Build()
    try:
        with tempfile.TemporaryDirectory(prefix="psci_smoke_") as tmp:
            return run_all(tmp, card, nvcc, only)
    finally:
        if nvcc is not None:
            nvcc.close()


def run_all(tmp: str, card: str, nvcc, only) -> int:
    """Every phase, in order; the kernel-free [operators], [operators2],
    [earthformer], [koopman], [graphs] and [unetex] while ``nvcc`` (a
    ``cuda_build.Build``) compiles the kernels; [radar], kernel-free too,
    last."""
    import torch

    from paddlescience_torch.ops import jet_gated as G
    from paddlescience_torch.ops import jet_mlp as J

    if not only:
        log("[build] nvcc started for every kernel (nice 19); [operators], [operators2], [earthformer], [koopman], "
            "[graphs] and [unetex], which launch no kernel of the port, run meanwhile")
        log("[operators] summary " + json.dumps(run_operator_phase(tmp)))
        mark("operators")
        log("[operators2] summary " + json.dumps(run_operators2_phase(tmp)))
        mark("operators2")
        log("[earthformer] summary " + json.dumps(run_earthformer_phase(tmp)))
        mark("earthformer")
        log("[koopman] summary " + json.dumps(run_koopman_phase(tmp)))
        mark("koopman")
        log("[graphs] summary " + json.dumps(run_graphs_phase(tmp)))
        mark("graphs")
        log("[unetex] summary " + json.dumps(run_unetex_phase(tmp)))
        mark("unetex")
    elif all(p in KERNEL_FREE for p in only):  # no kernel needed: no wait for the build
        return run_probe(only, tmp)
    build_logs = nvcc.wait()
    log(f"[build] {len(build_logs)} kernels built, {time.perf_counter() - T0:.1f} s after the start")
    mark("build")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in ("jet_wgrad", "jet_mlp_fwd", "jet_gated_fwd", "jet_mlp_bwd", "jet_gated_bwd"):
        for fn, (regs, st, ld) in ptxas_by_function(build_logs.get(name, "")).items():
            log(f"[build] {name}.cu {fn}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
            if name in PTXAS:
                PTXAS[name][fn] = [regs, st, ld]

    if only:
        return run_probe(only, tmp)

    from paddlescience_torch.autodiff import jet
    from paddlescience_torch.autodiff import path as deriv_path
    from paddlescience_torch.examples import aneurysm
    from paddlescience_torch.examples.allen_cahn import build_solver

    if not os.path.exists(os.path.join(STL_DIR, "aneurysm_closed.stl")):
        subprocess.run([sys.executable, os.path.join(HERE, "tools", "gen_aneurysm_stl.py"), "--out", STL_DIR],
                       check=True, capture_output=True, text=True, timeout=300)
    # the driven paths, and the segment depths at which each runs the kernels
    solvers, depths = {}, {}
    from paddlescience_torch.geometry import raycast

    t0 = time.perf_counter()
    raycast.load()
    log(f"[main] the mesh ray cast library (csrc/mesh_raycast.cpp) built or loaded in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ane = aneurysm.build_solver(STL_DIR, iters_per_epoch=1, log_freq=1, device="cuda")
    ane_build_s = time.perf_counter() - t0
    log(f"[main] aneurysm solver built (host sampling of every constraint) in {ane_build_s:.1f} s: "
        + ", ".join(f"{n} {tuple(b[0][next(iter(b[0]))].shape)}" for n, b in ane._static_batches.items()))
    for path, (kwargs, deriv, _) in PATHS.items():
        solvers[path] = ane if path.startswith("aneurysm/") else build_solver(deriv=deriv, log_freq=1,
                                                                             device="cuda", **kwargs)
        with on_path(deriv):
            depths[path] = solvers[path].model.jet_segment_lengths()
        if not depths[path]:
            raise AssertionError(f"{path} runs no fused segment")
    log(f"[kernels] segment depths per path: {depths}")

    errs = {k: 0.0 for k in KERNELS + ("d_alpha",)}

    def merge(new):
        for k, v in new.items():
            errs[k] = max(errs[k], v)

    S, N, W = MAIN["S"], MAIN["N"], MAIN["W"]
    for L in sorted({l for p, ls in depths.items() if p.startswith("mlp/") for l in ls}, reverse=True):
        merge(check_kernels(S, N, (W,) * (L + 1)))
    check_kernels(S, N - 1, (W,) * (MAIN["L"] + 1))
    # the aneurysm segments: the first takes the 3 coordinates, later ones 512 columns
    silu, dims = (jet.SILU, 0.0), ANEURYSM["dims"]
    shapes = set()
    for path in ("aneurysm/jet_pallas_full", "aneurysm/jet_pallas"):
        s = 0
        for L in depths[path]:
            shapes.add(dims[s : s + L + 1])
            s += L
    for n in (ANEURYSM["N"], ANEURYSM["N"] - 1):
        for seg in sorted(shapes, key=lambda d: (-len(d), d)):
            merge(check_kernels(len(NS3D) + 1, n, seg, silu))
    # every activation the kernels take, at a small shape
    # (their errors stay out of the main-path maxima: exp over two random layers reaches 1e30)
    a = ACT_CHECK
    for act_id in sorted(jet.ACT_RULES):
        act = (act_id, 1.7 if act_id == jet.SIREN else 0.0)
        check_kernels(a["S"], a["N"], (a["W"],) * 3, act, log_it=False)
        check_gated_kernels(a["S"], a["N"], a["W"], G.modified_mlp_program(2), "modified_mlp", act, log_it=False)
    log(f"[kernels] every activation ({len(jet.ACT_RULES)}: {', '.join(jet.ACT_NAMES)}) at S={a['S']} "
        f"N={a['N']} W={a['W']} L=2, ungated and as a ModifiedMLP program: each output within {REL_TOL} x the "
        f"largest magnitude of its reference (the relu family by the either-side check at kinks)")
    for L in sorted({l for p, ls in depths.items() if p.startswith("piratenet/") for l in ls}, reverse=True):
        merge(check_gated_kernels(S, N, W, G.piratenet_program(L // 3), "piratenet"))
    for L in sorted({l for p, ls in depths.items() if p.startswith("modified_mlp/") for l in ls}, reverse=True):
        merge(check_gated_kernels(S, N, W, G.modified_mlp_program(L), "modified_mlp"))
    check_gated_kernels(S, N - 1, W, G.piratenet_program(3), "piratenet")
    check_gated_kernels(S, N - 1, W, G.modified_mlp_program(3), "modified_mlp")
    # S = 7 at W = 256: two tiles do not fit, the backward keeps one and parks the cotangent
    if not J.bwd_parks(len(NS3D) + 1, [W]):
        raise AssertionError("the gated backward at S=7, W=256 was expected to park its cotangent")
    check_gated_kernels(len(NS3D) + 1, N - 1, W, G.piratenet_program(3), "piratenet (parked)")
    # jet_mlp_bwd at width 512: S = 5 keeps two 8-row tiles, S = 8 (the unsteady aneurysm) parks
    for s_ in (5, len(NS3D) + 2):
        if J.bwd_parks(s_, dims) is not (s_ > 5):
            raise AssertionError(f"jet_mlp_bwd at S={s_}, width 512: unexpected cotangent placement")
        merge(check_kernels(s_, ANEURYSM["N"] - 3, dims[:4], silu))
    check_wgrad_repeat()
    check_gated_bwd_repeat()
    check_mlp_bwd_repeat()
    check_fwd_repeat()
    merge(check_halves_kernels())
    errs["lbm_collide_stream"] = max(check_lbm_kernel(256, 256, 1), check_lbm_kernel(256, 256, 200),
                                     check_lbm_kernel(1000, 1000, 1))
    log("[kernels] max abs err over the main-path checks: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    mark("kernels")

    launches = {}
    for path, (_, deriv, steps) in PATHS.items():
        _, launches[path] = run_path(solvers[path], path, deriv, steps)
    launches["cavity"] = run_cavity_path()
    launches[PADDED_PATH] = run_padded_path()
    mark("main paths")

    req = ane._jet_requests["interior"]
    n_streams = {len(jet.build_index(stack)) for reqs in req.values() for stack in reqs}
    log(f"[main] aneurysm interior jet: {n_streams} streams; hidden widths {ANEURYSM['dims']}")
    if n_streams != {len(NS3D) + 1}:
        raise AssertionError(f"aneurysm: the interior jet has {n_streams} streams, expected {len(NS3D) + 1}")

    for arch in ("mlp", "piratenet", "modified_mlp", "aneurysm"):
        paths = [p for p in PATHS if p.startswith(arch + "/")]
        solver = solvers[paths[0]]
        if arch == "piratenet" and not all(float(b.alpha.detach()) != 0.0 for b in solver.model.blocks):
            raise AssertionError("piratenet: an alpha is still 0 after training; the check would prove nothing")
        parts = ("weight_g", "weight_v", "bias") if arch == "aneurysm" else ("alpha", "embed_u", "embed_v")
        check_against_plain_path(solver, arch, tuple(PATHS[p][1] for p in paths), parts)
    mark("plain-path checks")

    graph_launches, graph_timing = run_graph_phase(ane, tmp)
    launches.update(graph_launches)
    log("[graph] summary " + json.dumps(graph_timing))
    mark("graph")
    cyl_errs, launches[CYLINDER_PATH], cyl_timing = run_cylinder_phase()
    log("[cylinder] summary " + json.dumps(cyl_timing))
    mark("cylinder")
    launches["graph euler_beam"], euler_timing = run_euler_beam_phase(tmp)
    log("[euler_beam] summary " + json.dumps(euler_timing))
    mark("euler_beam")
    example_launches, example_timing, ldc2d_params = run_example_phases(tmp)
    launches.update(example_launches)
    log("[examples] summary " + json.dumps(example_timing))
    mark("examples")
    launches["lbfgs jet_pallas_full"], lbfgs_numbers = run_lbfgs_phase(tmp, ldc2d_params)
    log("[lbfgs] summary " + json.dumps(lbfgs_numbers))
    mark("lbfgs")
    recipe_launches, recipe_numbers = run_recipe_phase(tmp)
    launches.update(recipe_launches)
    log("[recipes] summary " + json.dumps(recipe_numbers))
    mark("recipes")
    ldc_launches, ldc_per_step, ldc_errs, ldc_numbers = run_ldc_phase(tmp)
    launches.update(ldc_launches)
    merge(ldc_errs)
    log("[ldc] summary " + json.dumps(ldc_numbers))
    mark("ldc")
    elastic_launches, elastic_per_step, elastic_errs, elastic_numbers = run_elasticity_phase(tmp, ane_build_s)
    launches.update(elastic_launches)
    merge(elastic_errs)
    log("[elasticity] summary " + json.dumps(elastic_numbers))
    mark("elasticity")
    log("[viv] summary " + json.dumps(run_viv_phase(tmp)))
    mark("viv")
    heart_launches, heart_per_step, heart_numbers = run_heart_phase(tmp)
    launches.update(heart_launches)
    log("[heart] summary " + json.dumps(heart_numbers))
    mark("heart")
    flow_launches, flow_per_step, flow_numbers = run_aneurysm_flow_phase(tmp)
    launches.update(flow_launches)
    log("[aneurysm_flow] summary " + json.dumps(flow_numbers))
    mark("aneurysm_flow")
    log("[pinn_suite] summary " + json.dumps(run_pinn_suite_phase(tmp)))
    mark("pinn_suite")
    log("[transforms] summary " + json.dumps(run_transforms_phase(tmp)))
    mark("transforms")
    toolkit_numbers, nsfnet_sb, nsfnet_full, launches["toolkit nsfnet net 3"] = run_toolkit_phase(tmp)
    log("[toolkit] summary " + json.dumps(toolkit_numbers))
    mark("toolkit")
    xpinn_numbers, xpinn_per_step, xpinn_errs, launches["xpinn jet_pallas_full"] = run_xpinn_phase()
    merge(xpinn_errs)
    log("[xpinn] summary " + json.dumps(xpinn_numbers))
    mark("xpinn")
    log("[hpinns] summary " + json.dumps(run_hpinns_phase()))
    mark("hpinns")
    misc_numbers, launches["misc tempogan_lite"] = run_misc_phase(tmp)
    log("[misc] summary " + json.dumps(misc_numbers))
    mark("misc")
    autotune_results = run_autotune_phase(autotune_solvers(solvers, ane))
    log("[autotune] summary " + json.dumps(autotune_results))
    mark("autotune")

    device_ms = {}
    for path in TIMED:
        deriv_path.set_default(deriv_path.CANDIDATES[PATHS[path][1]])
        step_ms, _ = time_steps(solvers[path], path)
        device_ms[path] = profile_steps(solvers[path], path, step_ms)[0]
    rows = time_kernels(errs, launches, device_ms)
    time_cylinder_kernels(rows, cyl_errs, launches[CYLINDER_PATH],
                          cyl_timing["jet_pallas_full"]["kernel_ms_per_step"]["eager"])
    time_ldc_kernels(rows, ldc_per_step)
    time_elasticity_kernels(rows, elastic_per_step)
    time_heart_flow_kernels(rows, heart_per_step["heart"], flow_per_step)
    time_nsfnet_kernels(rows, nsfnet_sb, nsfnet_full)
    time_xpinn_kernels(rows, xpinn_per_step)
    frames = misc_numbers["tempogan_lite frames"]
    lbm_row = next(r for r in rows if r["name"] == "lbm_collide_stream")
    lbm_row.update(launches_tempogan_lite=frames["launches"], ms_tempogan_lattice=frames["kernel_ms_64"],
                   calls_ms_tempogan_lattice=frames["kernel_calls_ms_64"],
                   bound_ms_tempogan_lattice=frames["bound_ms_64"])
    mark("timing")
    # last: NowcastNet at 512^2 leaves the card's memory pools large and fragmented
    log("[radar] summary " + json.dumps(run_radar_phase(tmp)))
    mark("radar")
    log(f"[done] every phase passed in {time.perf_counter() - T0:.1f} s (the build included)")
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
