#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mpas_ocean_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is nonzero):
  1. environment: GPU name and power limit, CUDA versions;
  2. build every kernel from csrc/ with nvcc;
  3. hold the kernel against its plain PyTorch version on the card
     (f64 random state; f32 64x64x100 inertial-gravity wave);
  4. the main path at the headline size, 64x64 cells x 100 levels f32, FE,
     8000 steps: mesh -> StructuredModel -> to_struct ->
     structured_auto_run_loop -> from_struct, with the kernel's launch count,
     kernel and plain timings (fe_step timed through fused_run_loop, so that
     the number does not depend on the size rule) and the IGW error against
     the exact solution;
  5. 256x256x100 f32: fe_step against plain, both timed;
  6. the gradient: the adjoint-step kernel against its plain version (f64,
     and f32 at the headline size), the dot-product identity, then
     torch.autograd.grad of sum(ssh_final^2) through fused_rollout_diff at
     64x64x100 f32 over 4000 steps (bench.py's measure_adjoint), from
     StructuredModel -> to_struct, with both kernels' launch counts and
     timings;
  7. the tiled q-step kernel: against its plain version (f64 64x64x4 for FE
     and FB at q = 1, 2, 4 and three tiles, bitwise reruns; f64 and f32
     256x256x100), the main path at 256x256x100 f32 for 1000 steps, FE
     (routed to fe_step) and FB (the tiled kernel), with launch counts,
     plan and bound, the tiled kernel's FE beside fe_step at 64^2 and 256^2
     (the size rule), and FB over 8000 steps at 64x64x100 against the exact
     IGW and an f64 host run;
  8. the tiled reverse: the tiled adjoint kernel against its plain version
     (f64 16x16x4 and 64x64x4 at q = 1, 2 over wrapping and non-wrapping
     tiles, bitwise reruns; f64 256x256x100 for 5 reverse steps; f32 64^2 and
     256^2 for 100), the dot-product identity through tiled_rollout_diff,
     the grad of sum(ssh_final^2) through tiled_rollout_diff at 256x256x100
     f32 over 100 steps (bench.py's large-mesh tiled adjoint) with launch
     counts, timing and a profiler breakdown, and the numbers behind
     auto_rollout_diff's size rule (both reverse kernels per launch at 64^2,
     128^2, 256^2; both grads at 256^2 and 64^2);
  9. (run right after phase 2) the card's measured peaks, kernel 5: the FMA
     probe (bench.py's measure_vpu_peak) in shared memory and in registers,
     f32 and f64, and the stream probe through device memory and through
     L2, each against its plain version, then their rates; every bound and
     share printed after it divides by the ceilings (at each level the
     highest of the data sheet's rate, the probe's and its plain
     version's), with the bounds at the probes' rates and at the data
     sheet's beside;
 10. the coastal Kelvin channel forward (bench.py's build_kelvin): the
     masked arms of fe_step (FE) and tiled_step (FB) against the plain
     masked steps (f64 and f32), the main path at 64x64x100 f32 over 8000
     FE steps with its launches and live gridpoints per second, FB over
     1000, 256x256x100 FE and FB over 1000, the walls closed bit for bit,
     the Kelvin ssh error against the exact wave, masked beside periodic;
 11. the gradient on the channel: the masked arms of adjoint_step and
     tiled_adjoint against the plain masked reverse (f64 and f32), the
     dot-product identity, the 64x64x100 4000-step grad through
     auto_rollout_diff and the 256x256x100 100-step grad through
     tiled_rollout_diff with launch counts, times and profiler breakdowns;
 12. the nonlinear (vector-invariant) forward: the nonlinear arms of fe_step
     (FE) and tiled_step (FE and FB) against the plain nonlinear steps (f64
     16^2 and 64^2, periodic and channel, with the linear run as a control;
     f32 64^2 and 256^2 IGW and the Kelvin channel with controls), the main
     paths (64x64x100 IGW FE over 8000 steps, 256x256x100 FE and FB over
     1000, the 64^2 Kelvin channel FE over 8000) with launch counts, times,
     bounds and the ratio to the linear arm, the nonlinear IGW error against
     an f64 host run, the walls;
 13. the nonlinear reverse (csrc/nl_adjoint.cuh, the nonlinear arms of
     kernels 3 and 4): the kernel against the plain nonlinear reverse step
     (f64 16^2, 64^2 and 256^2, periodic and channel, at its own and the f32
     main paths' plans, with the linear reverse as a control; f32 at the
     main paths' own plans over 100 reverse steps by the distance from an f64
     reverse), the dot-product identity, the gradients from to_struct (64^2
     IGW and Kelvin channel over 4000 steps, 256^2 over 100 through
     auto_rollout_diff and tiled_rollout_diff) with exact launch counts,
     times and a profiler breakdown, and the kernel per launch beside its
     bound;
 14. momentum forcing (the forced arms of kernels 1-4): the forced
     instantiations' ptxas lines; f64 each forced arm against its plain
     version (16^2 and 64^2 random, periodic and channel, random winds,
     coefficients and levels; d(wind) and d(r_lin, Cd, lambda)) with bitwise
     reruns and the unforced arm as a control; the dot-product identity with
     directions in the wind and the coefficients; the Rayleigh recurrence
     and the wind-drag steady state on the card; f32 after 100 forward and
     reverse steps with controls; the forced main paths and gradients from
     to_struct beside the unforced ones (bench.py's forced 256^2 100-step
     tiled gradient among them) with exact launch counts, a profiler
     breakdown and the forced reverse arms per launch. ``python3
     chip_smoke.py --forcing-only`` runs phases 1, 2, 9 and 14 alone;
 15. tracer transport (the tracer arms of kernels 1 and 2): the tracer
     instantiations' ptxas lines; f64 fe_step FE and tiled_step FE and FB
     (q = 1, 2) with two tracers against the plain steps (16^2 and 64^2
     random, periodic and channel, kappa in {0, 5}, upwind in {1, 0.5, 0})
     with bitwise reruns and controls; uniform T, conserved content,
     monotone upwinding and culled cells on the card; f32 100-step checks
     on bench.py's tracers at 64^2 and 256^2 with a bf16 control; the
     gradient with tracers and the nonlinear core or forcing (finite, held
     in phase 20) and through the tiled reverse at q = 2 (held in phase 21);
     the main paths from to_struct
     (bench.py's two-tracer 64x64x100 FE rollout over 8000 steps,
     256x256x100 FE and FB, the 64^2 channel FE with kappa 5) with exact
     launch counts, timed beside the tracer-free arm with their bounds.
     ``python3 chip_smoke.py --tracers-only`` runs phases 1, 2, 9 and 15
     alone;
 16. the tracer reverse (the tracer arms of kernels 3 and 4 and of kernel
     1's stack entry): the tracer instantiations' ptxas lines; f64
     adjoint_step and tiled_adjoint (q = 1) with two tracers against the
     plain tracer reverse (16^2 and 64^2, periodic and channel, 4 to 100
     levels, kappa in {0, 5}, upwind in {1, 0.5, 0}) with bitwise reruns and
     the tracer-free arm as a control; the stack rebuild bitwise the
     forward's; the dot-product identity with directions in the tracers;
     f32 100 reverse steps on bench.py's tracers by the distance from an f64
     reverse with a bf16 control; the two-tracer gradients of sum ssh^2 +
     sum T^2 from to_struct (64^2 IGW and channel over 4000 steps, 256^2
     over 100 through both routes) with exact launch counts, timed beside
     the tracer-free gradients, a profiler breakdown, and the tracer arms
     per launch beside their bounds. ``python3 chip_smoke.py
     --tracer-reverse-only`` runs phases 1, 2, 9 and 16 alone;
 17. layered stratification (the stratified arms of kernels 1 and 2): the
     stratified instantiations' ptxas lines; f64 fe_step FE and tiled_step
     FE and FB (q = 1, 2) against the plain steps with strat= (16^2 and 64^2
     random, periodic and channel, 4, 36 and 100 levels, make_
     stratification's W of random densities and a dense random W) with
     bitwise reruns and the unstratified arm as a control; equal densities
     against the unstratified arm and the two-layer internal wave (FB over
     half a period) on the card; f32 100-step checks on bench.py's cell and
     the 64^2 channel with a bf16 control; the gradient with
     stratification and the nonlinear core, forcing or tracers (finite,
     held in phase 20); the main path, bench.py's
     baroclinic 64x64x100 FE rollout over 8000 steps from to_struct with
     exact launch counts, and FB 64^2, FE and FB 256^2 and the 64^2 channel
     FE over 1000, timed beside the unstratified arm with their bounds.
     ``python3 chip_smoke.py --strat-only`` runs phases 1, 2, 9 and 17
     alone;
 18. the stratified reverse (the stratified arms of kernels 3 and 4 and of
     kernel 1's stack entry): the stratified reverse instantiations' ptxas
     lines; f64 adjoint_step and tiled_adjoint (q = 1) against the plain
     stratified reverse (16^2 and 64^2, periodic and channel, 4, 36 and 100
     levels, make_stratification's W of random densities and a dense random
     W; d(dt) and d(W) over their Cauchy-Schwarz scales) with bitwise reruns
     and the unstratified arm as a control; the stack rebuild bitwise the
     forward's; the dot-product identity with a direction in W; f32 100
     reverse steps with bench.py's densities by the distance from an f64
     reverse with a bf16 control; the stratified gradient with the other
     options (finite) and the tiled route at q = 2; the slice's gradients of
     sum ssh^2 w.r.t. the state, dt and W from to_struct (64^2 IGW and
     channel over 4000 steps through auto_rollout_diff, 256^2 over 100
     through both routes) with exact stratified launch counts (7937
     fe_step and 4000 adjoint_step at 64^2, 190 and 100 at 256^2), timed
     beside the unstratified gradients, a profiler breakdown, and the
     stratified arms per launch beside their bounds. ``python3
     chip_smoke.py --strat-reverse-only`` runs phases 1, 2, 9 and 18 alone;
 19. composed physics (the composed arms of kernels 1 and 2: forcing,
     tracers and stratification together, and with the nonlinear core):
     the composed instantiations' ptxas lines; f64, every combination of
     two or more of {nonlinear, forcing, tracers, stratification} against
     the plain steps (16^2 and 64^2 random, periodic and channel, 4, 36 and
     100 levels; FE and FB, and the linear core's tiled_step at q = 1, 2)
     with bitwise reruns, each run with one option dropped as a control;
     physics on the card (equal densities, uniform S, conserved content);
     f32 100-step checks of bench.py's full-physics cell (IGW and Kelvin
     channel, FE and FB) with a bf16 control; the gradient of every
     combination (finite); the main paths from to_struct (bench.py's
     full-physics 64x64x100 FE rollout over 8000 steps, every fe_step
     launch forced, tracer and stratified; FB 64^2, FE and FB 256^2 and the
     64^2 channel FE with kappa 5 over 1000) with exact launch counts, timed
     beside each option alone with their bounds. ``python3 chip_smoke.py
     --physics-only`` runs phases 1, 2, 9 and 19 alone;
 20. the composed reverse (every combination of two or more of the
     nonlinear core, forcing, tracers and stratification in kernels 3 and 4
     and in kernel 1's stack rebuild): the composed reverse instantiations'
     ptxas lines; f64, each of the 11 combinations through the gradient's
     card steps against the plain reverse on the kernel's own stack (16^2
     and 64^2, periodic and channel, 4, 36 and 100 levels; d(dt), d(W) and
     the coefficients' cotangents on their Cauchy-Schwarz scales) with
     bitwise reruns, drop-one-option controls and the stack rebuild bitwise
     the forward's; the dot-product identity with directions in the state,
     tracers, wind, coefficients and W; f32 100 reverse steps of bench.py's
     full-physics cell at 64^2 and 256^2, each kernel on its route's plan,
     by the distance from an f64 reverse with a bf16 control; the
     gradients of sum ssh^2 + sum T^2 w.r.t. the state, dt, W, the wind and
     the coefficients from to_struct (bench.py's full-physics
     64x64x100 over 4000 steps through auto_rollout_diff with 7937 composed
     fe_step and 4000 composed nonlinear-reverse launches, the 64^2 channel
     with kappa 5, 256^2 over 100 through both routes, 190 and 100; the
     linear core's FTS at 64^2 and 256^2), the median of 3 with min and
     max, a profiler breakdown with the idle share, each composed arm per
     launch beside each option's reverse alone and its bound, with
     bench.py's tracer options. ``python3
     chip_smoke.py --composed-reverse-only`` runs phases 1, 2, 9 and 20
     alone;
 21. temporal blocking, q > 1: kernel 2's nonlinear arms at q > 1 (the
     q-step kernel, csrc/nl_tiled.cuh) and kernel 4's tracer and stratified
     arms at q > 1: the q-step instantiations' ptxas summary; f64, every
     combination of forcing, tracers and stratification with the nonlinear
     core at q = 2, 3 (FE and FB, periodic and channel, 4 and 36 levels)
     and tiled_adjoint's T, S, TS, FT, FS and FTS arms at q = 2, 3 against
     the plain versions to 1e-12 of scale, reruns bitwise, drop-one
     controls >= 100x off, a composition no tile fits refused; FB q = 3 in
     f32; the q = 2 gradient's dot-product identity; f32 after 100 steps at
     64^2 and 256^2 x 100 with a bf16 control; the main paths from to_struct
     with n / q launches; q = 2 against q = 1 in the same call (the
     nonlinear FE and FB alone and with all four options over 100 steps at
     256^2 and 200 at 64^2, the FTS gradient at 256^2, tiled_adjoint per
     launch); then kernel 4's nonlinear arm at q > 1, the q-step nonlinear
     reverse (csrc/nl_window_adjoint.cuh): its ptxas lines per arm; f64,
     every arm (the nonlinear core with forcing, tracers and stratification
     in every combination, periodic and channel) at q = 2 and 3 at the f32
     main paths' tiles against the plain reverse of every step, reruns
     bitwise, drop-one controls >= 100x off; the q = 2 gradient's
     dot-product identity; f32 after 100 reverse steps at 64^2 and 256^2 x
     100 with a bf16 control; the full-physics 256^2 gradient through
     tiled_rollout_diff(nonlinear=True) at q = 2 with n / 2 launches, the
     nonlinear gradient at q = 2 against q = 1, and per launch at 64^2 and
     256^2 beside two q = 1 launches and the bound.
     ``python3 chip_smoke.py --window-only`` runs phases 1, 2, 9 and 21
     alone, ``--nl-window-only`` phases 1, 2, 9 and that last part.
 22. the sharded row-slab path: kernel 2's received-halo arm
     (ShardedStructuredModel.run_pallas, each slab's state in buffers of
     R + 2 hq rows whose halo rows one exchange per field fills): f64
     against the plain superstep over 1, 2 and 4 slabs (linear FE and FB at
     q = 1, 2, 3, nonlinear at q = 1, 2, forcing, tracers and
     stratification alone and all four, periodic and channel, 4 and 36
     levels) to 1e-12 of scale with exact launch and exchange counts,
     reruns bitwise, bitwise tiled_run_loop's at the same plan, a stale-halo
     control >= 100x off, objective_pallas's f64 gradient against the plain
     objective's and the dot-product identity, f32 100 steps at 64^2 x 100
     with a bf16 control; bench.py's superstep cell (64x64x100 f32, P = 1,
     q = 2, 8000 steps) and sharded adjoint (1000 steps) from
     scatter(to_struct) with exact counts and times beside the single-chip
     kernel and the superstep at q = 1, 2, 4. ``python3 chip_smoke.py
     --sharded-only`` runs phases 1, 2, 9 and 22 alone.
After phase 8 the tracer-free 256x256x100 100-step gradients through
fused_rollout_diff and tiled_rollout_diff are timed again in a fresh process
(``python3 chip_smoke.py --grad-256``, which prints one JSON line), with
their profiler breakdowns, against EARLIER_GRAD_S.
The line before the last prints the GPU's name and power limit as nvidia-smi
gives them, the one before it the kernels' JSON summary, and the last line
is {"ok": true, "device": {...}}. Without a CUDA device it exits nonzero and
prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import statistics
import subprocess
import sys
import time

DT = 30.0
HEADLINE_N, LEVELS, HEADLINE_STEPS = 64, 100, 8000
LARGE_N, LARGE_STEPS = 256, 200
GRAD_STEPS, PLAIN_ADJ_STEPS = HEADLINE_STEPS // 2, 100
# phase 20's timed side gradients (the 64^2 channel and the linear core's
# 64^2 full-physics gradient; GRAD_STEPS until the run's budget took the
# time for phase 21's q-step nonlinear reverse) and phase 21's timed FTS
# gradients at q = 1 and 2 (LARGE_ADJ_STEPS until then)
COMPOSED_SIDE_STEPS = GRAD_STEPS // 4
# the tiled reverse: bench.py's "large-mesh tiled adjoint" line, max(10, STEPS // 80)
LARGE_ADJ_STEPS = max(10, HEADLINE_STEPS // 80)
# the tiled path: bench.py's large rollout, max(10, STEPS // 8) steps; the
# kernel-vs-plain check's length
LARGE_MAIN_STEPS, TILED_CHECK_STEPS = HEADLINE_STEPS // 8, 100
# Steps of the physics checks against the exact waves (phases 4, 7, 10 and
# 12: the f32 and f64 kernels, the f32 plain run and the f64 1-layer host
# run, at t = PHYSICS_STEPS * DT): a quarter of the main path's, so that
# phase 20 fits the run's time budget (at 8000 steps the host runs took
# 60-90 s of the GPU machine's CPU)
PHYSICS_STEPS = HEADLINE_STEPS // 4
REPS = 3
# On the Kelvin channel the f32 u check holds the kernel's distance from an
# f64 plain run to this many times the plain f32 run's: sound runs read
# x0.99-1.03 of it, the plain run with u stored in fp16 x8.9-9.2 and in
# bf16 x62 (PERF.md section 2), and phase 10 fails if a control passes.
U_GAP_FACTOR = 3

# Earlier times, f32, on an NVIDIA H100 80GB HBM3 at 700 W, printed beside
# this run's, against which PERF.md section 2's 5% bound holds the periodic
# main path: the forward kernels per step by CUDA events, the reverse
# kernels per launch by the held-stream timer of phases 6 and 8
# (tools/reverse_timing.py) and the grads, as PERF.md records them after
# the reverse kernels' redesign.
EARLIER_US = {
    "fe_step 64": 13.943, "fe_step 256": 184.883,
    "tiled_step FB 64": 19.931, "tiled_step FB 256": 276.334,
    "adjoint_step 64": 24.747, "adjoint_step 128": 80.112, "adjoint_step 256": 288.599,
    "tiled_adjoint 64": 25.067, "tiled_adjoint 128": 89.002, "tiled_adjoint 256": 333.534,
}
EARLIER_GRAD_S = {64: 0.213139, 256: 0.0732726, "256 fused": 0.067325}

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM
# bytes/s, non-tensor-core FLOP/s per dtype itemsize, and the FP64 tensor
# cores' FLOP/s ("mma64"), the rate of a double matrix product. The data
# sheet gives no L2 rate; the bounds before the probes divided every
# lattice's bytes by the HBM rate, so "l2" repeats it.
DATASHEET = {"hbm": 3.35e12, "l2": 3.35e12, "flops": {4: 67e12, 8: 34e12}, "mma64": 67e12}
# The same rates as phase 9's probes measure them on this card
# (tools/peaks.py).
MEASURED: dict = {}
# The divisor of every bound and share this script prints: at each level
# the highest rate the card is shown to reach, the data sheet's, the
# probe's or its plain version's (phase 9), so that no bound is taken at a
# rate below one the card reaches.
CEILING: dict = {}
# A lattice whose step reads and writes at most this many bytes of state
# (2 state passes) streams from L2 (50 MB on an H100; the margin leaves room
# for the constants and the other buffers): the 64x64x100 state (13 MB per
# pass in f32, 26 MB in f64) does, the 128^2 and 256^2 ones (53 and 210 MB)
# do not.
L2_PASS_BYTES = 40e6


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"{msg} ({time.perf_counter() - T0:.1f} s)", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def igw_case(n: int, levels: int, np_dtype, device=None):
    """The headline inputs, built as bench.py's build() builds them: uniform
    periodic hex lattice over a 10000 km box, IGW state, dt = 30 s. Built
    once per argument set and shared by the phases (a 256^2 lattice takes
    ~12 s on the host); the phases read it and make their states with
    to_struct."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt

    dc = 10000.0e3 / n
    horz = mt.planar_hex_mesh(n, n, dc, f0=1e-4, dtype=np_dtype)
    igw = mt.InertialGravityWave(lx=n * dc / 1e3)
    vert = mt.make_vertical_mesh(
        horz, levels,
        resting_thickness=np.full(
            (horz.n_cells, levels), igw.bottom_depth / levels, dtype=np_dtype
        ),
        dtype=np_dtype,
    )
    ssh, h, u = igw.initial_state(horz, levels)
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy(ssh.astype(np_dtype)),
        layer_thickness=torch.from_numpy(h.astype(np_dtype)),
        normal_velocity=torch.from_numpy(u.astype(np_dtype)),
    )
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n, device=device)
    return horz, igw, model, prog


def random_case(n: int, levels: int, seed: int = 7, u_amp: float = 0.01, layer: float = 10.0):
    """A random f64 lattice state (numpy seed), as tests/test_pallas.py
    builds it: layers of ``layer`` m, h perturbed by 1e-3 of it, u of
    standard deviation u_amp."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt

    horz = mt.planar_hex_mesh(n, n, 1000.0, f0=1e-4, beta=1e-11)
    vert = mt.make_vertical_mesh(
        horz, levels, resting_thickness=np.full((horz.n_cells, levels), layer)
    )
    rng = np.random.default_rng(seed)
    h = layer + (layer / 1000) * rng.normal(size=(horz.n_cells, levels))
    u = u_amp * rng.normal(size=(horz.n_edges, levels))
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy(h.sum(1) - vert.resting_thickness_sum),
        layer_thickness=torch.from_numpy(h),
        normal_velocity=torch.from_numpy(u),
    )
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n)
    return model, prog


@functools.lru_cache(maxsize=None)
def kelvin_case(n: int, levels: int, np_dtype, device=None):
    """bench.py's build_kelvin at n x n cells: the periodic hex lattice over a
    10000 km box with its first and last cell rows culled (a channel with
    walls north and south), levels of 1000 m / levels, the coastal Kelvin
    wave, and the masked StructuredModel. Returns (the culled HorzMesh, the
    KelvinWave, the model, the state); built once per argument set, as
    igw_case."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt

    dc = 10000.0e3 / n
    horz = mt.planar_hex_mesh(n, n, dc, f0=1e-4, dtype=np_dtype)
    y = np.asarray(horz.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = mt.cull_cells(horz, keep)
    vert = mt.make_vertical_mesh(
        chan, levels,
        resting_thickness=np.full((chan.n_cells, levels), 1000.0 / levels, dtype=np_dtype),
        dtype=np_dtype,
    )
    kw = mt.KelvinWave(lx=n * dc / 1e3, f0=1e-4)
    ssh, h, u = kw.initial_state(chan, levels)
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy(ssh.astype(np_dtype)),
        layer_thickness=torch.from_numpy(h.astype(np_dtype)),
        normal_velocity=torch.from_numpy(u.astype(np_dtype)),
    )
    model = mt.StructuredModel(mt.Mesh(horz=chan, vert=vert), n, n, device=device,
                               parent_horz=horz, keep_cells=keep)
    return chan, kw, model, prog


def random_channel(n: int, levels: int, seed: int = 7, u_amp: float = 0.01,
                   layer: float = 10.0):
    """A random f64 channel state (numpy seed): random_case's lattice with
    its first and last cell rows culled, the state on the live cells."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt

    horz = mt.planar_hex_mesh(n, n, 1000.0, f0=1e-4, beta=1e-11)
    y = np.asarray(horz.cells.y)
    keep = (y > 500.0) & (y < y.max() - 500.0)
    chan = mt.cull_cells(horz, keep)
    vert = mt.make_vertical_mesh(
        chan, levels, resting_thickness=np.full((chan.n_cells, levels), layer)
    )
    rng = np.random.default_rng(seed)
    h = layer + (layer / 1000) * rng.normal(size=(chan.n_cells, levels))
    u = u_amp * rng.normal(size=(chan.n_edges, levels))
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy(h.sum(1) - vert.resting_thickness_sum),
        layer_thickness=torch.from_numpy(h),
        normal_velocity=torch.from_numpy(u),
    )
    model = mt.StructuredModel(mt.Mesh(horz=chan, vert=vert), n, n,
                               parent_horz=horz, keep_cells=keep)
    return model, prog


def check_walls(state, mesh, what: str) -> None:
    """u is +0.0, bit for bit, on every edge the wall mask closes, and h is 0
    on every culled cell."""
    import torch

    u = state.normal_velocity
    closed = u.masked_select((mesh.edge_mask == 0)[..., None].expand_as(u))
    if not (bool((closed == 0).all()) and not bool(torch.signbit(closed).any())):
        raise AssertionError(f"{what}: u is not +0.0 on every wall and culled edge")
    h = state.layer_thickness
    dead = h.masked_select((mesh.cell_mask == 0)[..., None].expand_as(h))
    if not bool((dead == 0).all()):
        raise AssertionError(f"{what}: h is not 0 on every culled cell")


FIELDS = ("ssh", "layer_thickness", "normal_velocity")


def field_errors(a, b, rts) -> dict:
    """max |a - b| per field, and that over the field's scale: max |b| for
    h and u; for ssh = sum_k h - rts, a small difference of two large sums,
    the column thickness max |sum_k h| whose rounding it carries."""
    out = {}
    for f in FIELDS:
        x, y = getattr(a, f).double(), getattr(b, f).double()
        err = float((x - y).abs().max())
        scale = (y + rts.double()) if f == "ssh" else y
        out[f] = (err, err / float(scale.abs().max()))
    return out


def format_errors(errs: dict) -> str:
    return ", ".join(f"{f} {e:.3e} ({r:.3e})" for f, (e, r) in errs.items())


def timed_rollout(run, n_steps: int, reps: int):
    """Median and spread of the device time per step of run(n_steps), by
    CUDA events, after a short warm-up. Returns (last output, per-step
    seconds of each rep)."""
    import torch

    run(10)
    per_step = []
    out = None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(n_steps)
        end.record()
        end.synchronize()
        per_step.append(start.elapsed_time(end) / 1e3 / n_steps)
    return out, per_step


def rate_line(name: str, per_step: list, sites: int, gpu: str, earlier: str = "") -> str:
    med = statistics.median(per_step)
    was = (f"; earlier {EARLIER_US[earlier]:.3f} us/step, "
           f"now x{med * 1e6 / EARLIER_US[earlier]:.4f}" if earlier else "")
    return (
        f"{name}: {med * 1e6:.3f} us/step (median of {len(per_step)}, "
        f"min {min(per_step) * 1e6:.3f}, max {max(per_step) * 1e6:.3f}), "
        f"{sites / med:.4e} cells*levels*steps/s{was} [{gpu}]"
    )


def alt_bounds(fn, *args) -> dict:
    """The bound (seconds) of ``fn`` (step_bound or tiled_bounds) at the
    probes' own rates and at the data sheet's, beside the ceilings'."""
    return {"probe": fn(*args, MEASURED)[0], "datasheet": fn(*args, DATASHEET)[0]}


def alt_keys(prefix: str, alts: dict, scale: float) -> dict:
    """Entries of the kernels line for ``alt_bounds``, scaled."""
    return {f"{prefix}_{k}": v * scale for k, v in alts.items()}


def share_line(name: str, per_step: list, bound_s: float, alts: dict) -> str:
    """A kernel's median time beside its bound at the ceilings, at the
    probes' rates and at the data sheet's (the shares printed before the probes): the
    share of each it reaches."""
    med = statistics.median(per_step)
    return (f"{name}: {med * 1e6:.3f} us per step against a bound of {bound_s * 1e6:.3f} us "
            f"at the ceilings: {bound_s / med:.4f} of the bound (at the probes' rates "
            f"{alts['probe'] * 1e6:.3f} us: {alts['probe'] / med:.4f}; at the data sheet's "
            f"{alts['datasheet'] * 1e6:.3f} us: {alts['datasheet'] / med:.4f})")


def byte_rate(peaks: dict, state_bytes: float) -> float:
    """The byte rate a lattice's step streams at: L2's where two passes of
    its state fit L2_PASS_BYTES, device memory's beyond."""
    return peaks["l2"] if 2 * state_bytes <= L2_PASS_BYTES else peaks["hbm"]


def cuda_times(fn, reps: int, warm_up: bool = True) -> list:
    """Device seconds of each of reps calls of fn(), by CUDA events, after
    one warm-up call (none where the caller has just made one)."""
    import torch

    if warm_up:
        fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3)
    return out


def spread(times: list, scale: float = 1.0, unit: str = "s") -> str:
    t = [x * scale for x in times]
    return (f"{statistics.median(t):.6g} {unit} (median of {len(t)}, min {min(t):.6g}, "
            f"max {max(t):.6g})")


# Floating-point operations per cell-level and tracer the tracer arm needs
# (pallas_model.step_flop_count's 92 per lattice site of two cells): per
# cell its three owned edges' T_e, upwind term, flux and diffusive term, the
# divergence, the content and the division
TRACER_OPS = 46


def step_bound(kind: str, ny2: int, nx: int, k: int, n_terms: int, itemsize: int,
               peaks: dict | None = None, n_tracers: int = 0, masked: bool = False):
    """(bound seconds, "bytes" or "operations") of one step of a kernel:
    each input read once and each output written once, over the byte rate
    (``byte_rate``: L2's or device memory's); the arithmetic counted from
    the kernel's source, over the dtype's FMA rate. ``peaks`` are the rates,
    CEILING (phase 9) by default, MEASURED or DATASHEET.
    fe_step reads a state (ssh, h, u), f_edge, rts and the table and writes
    a state; per cell-level it does 24 flux/update operations, 4 per owned
    edge for u and 3 per Coriolis tap (1.5 n_terms). With ``n_tracers`` it
    also reads and writes 2 nT tracer planes and does TRACER_OPS per
    cell-level and tracer; ``masked`` adds the live bits read, and with
    tracers the cell mask. adjoint_step reads a primal state, a cotangent,
    f_edge and the table and writes a cotangent and d(dt); per cell-level it
    does 20 operations per owned edge plus 2 per transposed tap (n_terms), 6
    per incoming edge and 3 for dh. With ``n_tracers`` its tracer arm also
    reads the primal tracers and their cotangent and writes the new one
    (3 x 2 nT planes), reads h' and T' of the next state (2 + 2 nT planes),
    and does TRACER_ADJ_OPS per cell-level and tracer."""
    cells = 2 * ny2 * nx
    state = cells * (1 + 4 * k)
    tr = cells * k * n_tracers
    table = 4 * (44 + 3 * n_terms) + itemsize * n_terms
    if kind == "fe_step":
        nbytes = itemsize * (2 * (state + tr) + 4 * cells) + table
        ops = cells * k * (36 + 1.5 * n_terms + TRACER_OPS * n_tracers)
    else:
        nbytes = itemsize * (3 * (state + tr) + 3 * cells + (cells * k + tr if tr else 0)) + 8 \
            + table
        ops = cells * k * (81 + n_terms + TRACER_ADJ_OPS * n_tracers)
    if masked:
        nbytes += 4 * ny2 * nx + (itemsize * cells if n_tracers else 0)
    peaks = CEILING if peaks is None else peaks
    rate = byte_rate(peaks, itemsize * (state + tr))
    t_bytes, t_ops = nbytes / rate, ops / peaks["flops"][itemsize]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tiled_bounds(ny2: int, nx: int, k: int, n_terms: int, itemsize: int, plan, halo,
                 peaks: dict | None = None):
    """Bounds per step of tiled_step for a plan (row_tile, col_tile, q) with
    per-step halo (rows, columns): (seconds, "bytes" or "operations") with
    each input read once and each output written once per launch of q steps,
    fe_step's arithmetic per cell-level; and the plan's own bound in seconds,
    which also counts the halo re-reads of the windows and the recompute of
    the halo rings on the shrinking windows. ``peaks`` as for
    ``step_bound``."""
    rt, ct, q = plan
    hm, hi = halo
    cells = 2 * ny2 * nx
    state, consts = cells * (1 + 4 * k), 4 * cells
    table = 4 * (44 + 3 * n_terms) + itemsize * n_terms
    ops = cells * k * (36 + 1.5 * n_terms)
    peaks = CEILING if peaks is None else peaks
    rate = byte_rate(peaks, itemsize * state)
    t_bytes = (itemsize * (2 * state + consts) + table) / rate / q
    t_ops = ops / peaks["flops"][itemsize]
    reads = (rt + 2 * hm * q) * (ct + 2 * hi * q) / (rt * ct)
    rings = sum((rt + 2 * hm * (q - 1 - j)) * (ct + 2 * hi * (q - 1 - j))
                for j in range(q)) / (rt * ct * q)
    t_plan = max((itemsize * (reads * (state + consts) + state) + table) / rate / q,
                 t_ops * rings)
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, t_plan)


def tiled_phase(gpu: str, log_text: str, fe_us: dict) -> tuple:
    """Phase 7, the tiled path: the kernel against its plain version (f64
    random, f64 and f32 at 256x256x100), the main path at full width for FE and FB
    with its launch counts, the FE size rule's numbers, and FB at the
    headline size against the exact IGW and an f64 host run. Returns the
    kernel's entry of the kernels line and the main paths' seconds per step
    (FE and FB at 256^2, FB at 64^2)."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
    from mpas_ocean_tpu_torch.structured import (
        structured_auto_run_loop,
        structured_run_loop,
        tiled_run_loop,
    )
    from mpas_ocean_tpu_torch.structured.slab import stencil_reach
    from mpas_ocean_tpu_torch.structured.tiled_model import plain_tiled_rollout, resolve_plan
    from mpas_ocean_tpu_torch.utils import error_measures

    for line in ptxas_report(log_text, ("tiled_step_kernel",)):
        log(f"[7] ptxas {line}")
    scheme = {False: "FE", True: "FB"}

    # f64 64x64x4 random state (ny2 = 32: FB at q = 4 keeps its 8-row halo)
    model, prog = random_case(64, 4)
    st, sm = model.to_struct(prog), model.struct_mesh
    worst = {}
    for fb in (False, True):
        halo = stencil_reach(sm.coriolis_terms, fb)
        for q in (1, 2, 4):
            for rt, ct in ((1, 8), (4, 4), (8, 16)):
                if resolve_plan(sm.ny2, sm.nx, 4, 8, halo, 8, rt, ct, q) != (rt, ct, q):
                    raise AssertionError(f"plan {(rt, ct, q)} was clamped")
                run = lambda: tiled_run_loop(st, sm, 10.0, 8, row_tile=rt, col_tile=ct,
                                             q=q, fb=fb)
                out, again = run(), run()
                ref = plain_tiled_rollout(st, sm, 10.0, 8, rt, ct, q, fb)
                errs = field_errors(out, ref, sm.resting_thickness_sum)
                for f, (_, r) in errs.items():
                    if not r <= 1e-12:
                        raise AssertionError(f"f64 tiled {scheme[fb]} {(rt, ct, q)} vs plain: "
                                             f"{f} {r:.3e} > 1e-12")
                if not all(torch.equal(getattr(out, f), getattr(again, f)) for f in FIELDS):
                    raise AssertionError(f"f64 tiled {scheme[fb]} {(rt, ct, q)} rerun differs")
                key = f"{scheme[fb]} q={q}"
                worst[key] = max(worst.get(key, 0.0), max(r for _, r in errs.values()))
    log("[7] f64 64x64x4 random, 8 steps, tiled kernel vs plain (same plan), tiles 1x8, "
        "4x4, 8x16: max relative error " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + "; reruns bitwise equal")
    for fb in (False, True):
        errs = field_errors(tiled_run_loop(st, sm, 10.0, 8, fb=fb),
                            structured_run_loop(st, sm, 10.0, 8, fb=fb),
                            sm.resting_thickness_sum)
        log(f"[7] f64 64x64x4 random, 8 {scheme[fb]} steps, tiled kernel (planner's plan) vs "
            f"the roll model: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= 1e-12:
                raise AssertionError(f"f64 tiled {scheme[fb]} vs roll model: {f} {r:.3e}")

    # 256x256x100 IGW at the planner's plans: f64 kernel vs plain (only the
    # order of the column sums differs), then f32 and the plain time
    def plan_of(sm, itemsize, fb):
        return resolve_plan(sm.ny2, sm.nx, LEVELS, itemsize,
                            stencil_reach(sm.coriolis_terms, fb), LARGE_MAIN_STEPS)

    _, _, model_l64, prog_l64 = igw_case(LARGE_N, LEVELS, np.float64)
    st_l64, sm_l64 = model_l64.to_struct(prog_l64), model_l64.struct_mesh
    for fb in (False, True):
        plan = plan_of(sm_l64, 8, fb)
        errs = field_errors(tiled_run_loop(st_l64, sm_l64, DT, 10, fb=fb),
                            plain_tiled_rollout(st_l64, sm_l64, DT, 10, *plan, fb),
                            sm_l64.resting_thickness_sum)
        log(f"[7] f64 {LARGE_N}x{LARGE_N}x{LEVELS} IGW, 10 {scheme[fb]} steps, plan "
            f"{plan}, tiled kernel vs plain: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= 1e-12:
                raise AssertionError(f"f64 {LARGE_N}^2 tiled {scheme[fb]} vs plain: {f} {r:.3e}")
    del model_l64, st_l64, sm_l64

    horz_l, _, model_l, prog_l = igw_case(LARGE_N, LEVELS, np.float32)
    st_l, sm_l = model_l.to_struct(prog_l), model_l.struct_mesh
    sites_l = 2 * sm_l.ny2 * sm_l.nx * LEVELS
    # f32 bounds: ssh and h as for fe_step (phase 3). u carries g dt grad of
    # the two versions' different rounding of the ~1000 m column sums, which
    # at 256^2 is over a 4x shorter dc than at 64^2, and FE grows it: 1.4e-3
    # of max|u| after 100 steps, fe_step against its own plain version 4.9e-3
    # after 200 (H100, 700 W; PERF.md section 5), hence 5e-3
    tol = {"ssh": 1e-5, "layer_thickness": 1e-5, "normal_velocity": 5e-3}
    max_abs_err, plain_s, plans = 0.0, {}, {}
    for fb in (False, True):
        plan = plans[fb] = plan_of(sm_l, 4, fb)
        errs = field_errors(tiled_run_loop(st_l, sm_l, DT, TILED_CHECK_STEPS, fb=fb),
                            plain_tiled_rollout(st_l, sm_l, DT, TILED_CHECK_STEPS, *plan, fb),
                            sm_l.resting_thickness_sum)
        log(f"[7] f32 {LARGE_N}x{LARGE_N}x{LEVELS} IGW, {TILED_CHECK_STEPS} {scheme[fb]} steps, "
            f"plan {plan}, tiled kernel vs plain: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= tol[f]:
                raise AssertionError(f"f32 tiled {scheme[fb]} vs plain: {f} {r:.3e} > {tol[f]}")
        max_abs_err = max(max_abs_err, *(e for e, _ in errs.values()))
        plain_s[fb] = [t / 10 for t in cuda_times(
            lambda: plain_tiled_rollout(st_l, sm_l, DT, 10, *plan, fb), REPS)]

    # the main path at full width, FE and FB
    main_s, counts = {}, {}
    for fb in (False, True):
        fe_step.launches = tiled_step.launches = 0
        t0 = time.perf_counter()
        out = structured_auto_run_loop(model_l.to_struct(prog_l), model_l.struct_mesh, DT,
                                       LARGE_MAIN_STEPS, fb=fb)
        final = model_l.from_struct(out)
        wall = time.perf_counter() - t0
        counts[fb] = (fe_step.launches, tiled_step.launches)
        q = plans[fb][2]
        want = (0, LARGE_MAIN_STEPS // q) if fb else (LARGE_MAIN_STEPS, 0)
        log(f"[7] main path {LARGE_N}x{LARGE_N}x{LEVELS} f32 {scheme[fb]}, {LARGE_MAIN_STEPS} "
            f"steps: {wall:.3f} s wall (to_struct .. from_struct); launches fe_step "
            f"{counts[fb][0]}, tiled_step {counts[fb][1]} (want {want[0]}, {want[1]})")
        if counts[fb] != want:
            raise AssertionError(f"{scheme[fb]} main path launches {counts[fb]} != {want}")
        for f in FIELDS:
            if not bool(torch.isfinite(getattr(final, f)).all()):
                raise AssertionError(f"{scheme[fb]} main path: {f} is not finite")
        if tuple(final.normal_velocity.shape) != (horz_l.n_edges, LEVELS):
            raise AssertionError(f"{scheme[fb]} main path: wrong output shapes")
        _, main_s[fb] = timed_rollout(
            lambda n: structured_auto_run_loop(st_l, sm_l, DT, n, fb=fb), LARGE_MAIN_STEPS, REPS)
        dims = (sm_l.ny2, sm_l.nx, LEVELS, len(sm_l.coriolis_terms), 4)
        if fb:
            halo = stencil_reach(sm_l.coriolis_terms, fb)
            route = f"tiled_step, plan {plans[fb]}"
            bound = tiled_bounds(*dims, plans[fb], halo)[0]
            old = alt_bounds(tiled_bounds, *dims, plans[fb], halo)
            occ = tiled_step.occupancy(*plans[fb], halo, LEVELS, fb)
            occ_line = f"{occ[0]} clusters resident, {occ[1]} blocks per SM"
        else:
            route, bound = "fe_step", step_bound("fe_step", *dims)[0]
            old = alt_bounds(step_bound, "fe_step", *dims)
            tile = fe_step.fe_tile(sm_l.ny2, sm_l.nx, LEVELS, 4)
            lp = fe_step.launch_plan(sm_l.host_stencil[0], sm_l.ny2, sm_l.nx, LEVELS, tile)
            occ_line = (f"tile {tile}, {lp['clusters']} clusters, {lp['blocks_per_sm']} blocks "
                        f"per SM")
        name = "tiled_step FB" if fb else "fe_step"
        log("[7] " + rate_line(f"main path {scheme[fb]} ({route}; bound {bound * 1e6:.3f} "
                               f"us/step)", main_s[fb], sites_l, gpu, f"{name} {LARGE_N}"))
        log(f"[7] {occ_line} (occupancy query); " + share_line(name, main_s[fb], bound, old))
    # the FE size rule: the tiled kernel's FE beside fe_step at both sizes
    _, tiled_fe_l = timed_rollout(lambda n: tiled_run_loop(st_l, sm_l, DT, n),
                                  LARGE_MAIN_STEPS, REPS)
    log("[7] " + rate_line(f"tiled_step FE {LARGE_N}x{LARGE_N}, plan {plans[False]}",
                           tiled_fe_l, sites_l, gpu) + f"; fe_step {fe_us[LARGE_N]:.3f} "
        f"us/step (phase 5)")

    # FB at the headline size: 8000 f32 steps (the main path), and at
    # PHYSICS_STEPS against the exact IGW; f64 against an f64 host run of
    # the plain FB rollout with one 1000 m layer
    horz, igw, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    sites = 2 * sm.ny2 * sm.nx * LEVELS
    _, tiled_fe = timed_rollout(lambda n: tiled_run_loop(st, sm, DT, n), HEADLINE_STEPS // 8,
                                REPS)
    plan_fe = resolve_plan(sm.ny2, sm.nx, LEVELS, 4, stencil_reach(sm.coriolis_terms, False),
                           HEADLINE_STEPS // 8)
    log("[7] " + rate_line(f"tiled_step FE {HEADLINE_N}x{HEADLINE_N}, plan {plan_fe}",
                           tiled_fe, sites, gpu) + f"; fe_step {fe_us[HEADLINE_N]:.3f} "
        f"us/step (phase 4)")
    tiled_step.launches = 0
    fin = model.from_struct(structured_auto_run_loop(model.to_struct(prog), sm, DT,
                                                     HEADLINE_STEPS, fb=True))
    if tiled_step.launches != HEADLINE_STEPS:
        raise AssertionError(f"FB {HEADLINE_N}^2: {tiled_step.launches} launches")
    _, fb_s = timed_rollout(lambda n: structured_auto_run_loop(st, sm, DT, n, fb=True),
                            HEADLINE_STEPS // 8, REPS)
    halo_fb = stencil_reach(sm.coriolis_terms, True)
    plan_fb = resolve_plan(sm.ny2, sm.nx, LEVELS, 4, halo_fb, HEADLINE_STEPS)
    bound_fb = tiled_bounds(sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4, plan_fb,
                            halo_fb)
    plain_fb = [t / 10 for t in cuda_times(
        lambda: plain_tiled_rollout(st, sm, DT, 10, *plan_fb, True), REPS)]
    log("[7] " + rate_line(f"main path FB {HEADLINE_N}x{HEADLINE_N} (tiled_step, plan "
                           f"{plan_fb}; bound {bound_fb[0] * 1e6:.3f} us/step, "
                           f"{bound_fb[2] * 1e6:.3f} with the plan's halos)", fb_s, sites, gpu,
                           f"tiled_step FB {HEADLINE_N}")
        + f"; plain {statistics.median(plain_fb) * 1e6:.3f} us/step")
    occ = tiled_step.occupancy(*plan_fb, halo_fb, LEVELS, True)
    log(f"[7] {occ[0]} clusters resident, {occ[1]} blocks per SM (occupancy query); "
        + share_line("tiled_step FB", fb_s, bound_fb[0],
                     alt_bounds(tiled_bounds, sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4,
                                plan_fb, halo_fb)))
    t_end = PHYSICS_STEPS * DT
    exact = igw.exact_ssh(np.asarray(horz.cells.x, np.float64),
                          np.asarray(horz.cells.y, np.float64), t_end)

    def l2(ssh):
        return error_measures(ssh.double().numpy(), exact, horz, "cell").L_two

    fin = model.from_struct(structured_auto_run_loop(st, sm, DT, PHYSICS_STEPS, fb=True))
    _, _, model64, prog64 = igw_case(HEADLINE_N, LEVELS, np.float64)
    k64 = model64.from_struct(structured_auto_run_loop(
        model64.to_struct(prog64), model64.struct_mesh, DT, PHYSICS_STEPS, fb=True))
    _, _, model1, prog1 = igw_case(HEADLINE_N, 1, np.float64, device="cpu")
    ref = model1.from_struct(structured_run_loop(
        model1.to_struct(prog1), model1.struct_mesh, DT, PHYSICS_STEPS, fb=True))
    l2_k, l2_k64, l2_ref = l2(fin.ssh), l2(k64.ssh), l2(ref.ssh)
    ssh_gap = float(np.abs(k64.ssh.numpy() - ref.ssh.numpy()).max())
    log(f"[7] FB IGW ssh L2 error vs exact at t={t_end:.0f} s, {HEADLINE_N}x{HEADLINE_N}x"
        f"{LEVELS}: f32 kernel {l2_k:.6e}; f64 kernel {l2_k64:.6e}, f64 1-layer host "
        f"reference {l2_ref:.6e}; f64 kernel vs host max|ssh diff| {ssh_gap:.3e} m")
    if not (ssh_gap <= 1e-6 and abs(l2_k64 - l2_ref) <= 1e-6):
        raise AssertionError(f"f64 FB IGW off the host reference: {ssh_gap}, {l2_k64}, {l2_ref}")
    # FB is neutrally stable for gravity waves, so the f32 run's rounding
    # does not grow as it does under FE (phase 4)
    if not (np.isfinite(l2_k) and abs(l2_k - l2_k64) <= 0.1 * l2_k64 + 1e-4):
        raise AssertionError(f"f32 FB IGW error {l2_k} is off the f64 run's {l2_k64}")

    halo = stencil_reach(sm_l.coriolis_terms, True)
    dims_l = (sm_l.ny2, sm_l.nx, LEVELS, len(sm_l.coriolis_terms), 4)
    bound, bound_by, plan_bound = tiled_bounds(*dims_l, plans[True], halo)
    old = alt_bounds(tiled_bounds, *dims_l, plans[True], halo)
    q = plans[True][2]
    log(f"[7] tiled_step FB {LARGE_N}^2 per step: {statistics.median(main_s[True]) * 1e6:.3f} "
        f"us; bound {bound * 1e6:.3f} us at the ceilings ({bound_by}, each input read once per "
        f"launch; {old['probe'] * 1e6:.3f} us at the probes' rates, "
        f"{old['datasheet'] * 1e6:.3f} us at the data sheet's), {plan_bound * 1e6:.3f} us "
        f"with the plan's halo reads and ring recompute; plain "
        f"{statistics.median(plain_s[True]) * 1e6:.3f} us [{gpu}]")
    return {
        "name": "tiled_step",
        "route": "cuda",
        "source": "mpas_ocean_tpu_torch/csrc/tiled_step.cu",
        "replaces": "mpas_ocean_tpu/structured/pallas_model.py:852",
        "launches": counts[True][1],
        "max_abs_err": max_abs_err,
        "ms": statistics.median(main_s[True]) * q * 1e3,
        "plain_ms": statistics.median(plain_s[True]) * q * 1e3,
        "bound_ms": bound * q * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
        **alt_keys("bound_ms", old, q * 1e3),
        "plan": list(plans[True]),
        "blocks_per_sm": tiled_step.occupancy(*plans[True], halo, LEVELS, True)[1],
        "bound_ms_with_halos": plan_bound * q * 1e3,
        "ms_fe_256": statistics.median(tiled_fe_l) * 1e3,
        "ms_fe_64": statistics.median(tiled_fe) * 1e3,
        "ms_fb_64": statistics.median(fb_s) * 1e3,
        "plain_ms_fb_64": statistics.median(plain_fb) * 1e3,
    }, {"fe 256": statistics.median(main_s[False]), "fb 256": statistics.median(main_s[True]),
        "fb 64": statistics.median(fb_s)}


def state_fields(state) -> list:
    return [getattr(state, f) for f in FIELDS]


def graph_times(st, sm, n_seg: int, replays: int, reps: int) -> list:
    """Device seconds per step of fe_step's step loop captured in a CUDA
    graph of n_seg steps and replayed ``replays`` times, for reps reps."""
    import torch

    from mpas_ocean_tpu_torch.kernels import fe_step
    from mpas_ocean_tpu_torch.structured.fused_model import _scal

    consts = (sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil)
    scal = _scal(sm, DT, st.layer_thickness.dtype)
    src = tuple(x.contiguous() for x in state_fields(st))
    out = tuple(torch.empty_like(x) for x in src)
    tmp = tuple(torch.empty_like(x) for x in src)
    run = lambda: fe_step.fe_rollout_into(src, out, *consts, *scal, n_seg, scratch=tmp)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    times = cuda_times(lambda: [graph.replay() for _ in range(replays)], reps)
    return [t / (n_seg * replays) for t in times]


def random_cot(state, seed: int):
    """A random cotangent like ``state`` (numpy seed), on its device."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.structured import StructState

    rng = np.random.default_rng(seed)
    return StructState(*(torch.from_numpy(rng.normal(size=tuple(x.shape))).to(
        device=x.device, dtype=x.dtype) for x in state_fields(state)))


def cot_errors(a, b, ddt_a, ddt_b) -> dict:
    """max |a - b| per cotangent field and over max |b|; d(dt) over |b|."""
    out = {}
    for f in FIELDS:
        x, y = getattr(a, f).double(), getattr(b, f).double()
        err = float((x - y).abs().max())
        out[f] = (err, err / float(y.abs().max()))
    err = abs(float(ddt_a) - float(ddt_b))
    out["d_dt"] = (err, err / abs(float(ddt_b)))
    return out


def grad_sum_ssh2(route, st, sm, n_steps: int, plan=None, **kw):
    """torch.autograd.grad of sum(ssh_final^2) in the state and dt through
    ``route`` (fused_rollout_diff, tiled_rollout_diff, auto_rollout_diff;
    ``kw`` its options, ``nonlinear``). Returns (final state, (d_ssh, d_h,
    d_u, d_dt))."""
    import torch

    from mpas_ocean_tpu_torch.structured import StructState

    leaves = [x.clone().requires_grad_(True) for x in state_fields(st)]
    x = st.layer_thickness
    dt = torch.tensor(DT, dtype=x.dtype, device=x.device, requires_grad=True)
    out = route(StructState(*leaves), sm, dt, n_steps, plan=plan, **kw)
    return out, torch.autograd.grad((out.ssh ** 2).sum(), leaves + [dt])


def profile_by_kernel(fn, names: tuple):
    """Device time by kernel of one call of fn(), from a profiler trace; the
    window's length by CUDA events (or the trace's span of device activity,
    if longer); and the device's busy time, the union of the device
    activities' intervals (programmatically dependent launches overlap, so
    the sum of their times can exceed the window): ({name: (us, count)},
    window us, busy us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in names if k in e.key), "other")
        t, c = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (t + e.self_device_time_total, c + e.count)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach = 0.0, -math.inf
    for a, b in spans:
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    window_us = start.elapsed_time(end) * 1e3
    if spans:
        window_us = max(window_us, reach - spans[0][0])
    return by_kernel, window_us, busy_us


def profile_line(by_kernel: dict, window_us: float, busy_us: float, gpu: str) -> str:
    summed_us = sum(t for t, _ in by_kernel.values())
    return (", ".join(f"{k} {t:.0f} us / {c} = {t / max(c, 1):.3f} us"
                      for k, (t, c) in by_kernel.items())
            + f"; device busy {busy_us:.0f} us (the union of the kernels' intervals; their sum "
            f"{summed_us:.0f} us, {summed_us - busy_us:.0f} us of it overlapping), idle share "
            f"{1 - busy_us / window_us:.4f} [{gpu}]")


def ddt_line(by_kernel: dict) -> str:
    """ddt_reduce's device time in a traced grad and its share of the
    device's busy time."""
    busy_us = sum(t for t, _ in by_kernel.values())
    t, c = by_kernel.get("ddt_reduce", (0.0, 0))
    return (f"ddt_reduce {t:.1f} us in {c} launches, {t / busy_us:.5f} of the device's busy "
            f"time")


def tiled_adjoint_phase(gpu: str, log_text: str, fused_grad_64: list) -> tuple:
    """Phase 8, the tiled reverse: the tiled adjoint kernel against its plain
    version (f64 16^2 and 64^2 random states at q = 1 and 2 over tiles that
    wrap and tiles that do not, with bitwise reruns; f64 256^2 IGW for 5
    reverse steps; f32 64^2 and 256^2 for 100 on the same primal states),
    the dot-product identity through tiled_rollout_diff, the main path at
    full width (grad of sum(ssh_final^2) through tiled_rollout_diff at
    256x256x100 f32 over 100 steps, bench.py's "large-mesh tiled adjoint"
    line) with its launch counts, timing and profiler breakdown, and the
    numbers of auto_rollout_diff's size rule. ``fused_grad_64`` holds
    phase 6's 64^2 4000-step grad times through fused_rollout_diff. Returns
    the kernels line's entries (tiled_adjoint; adjoint_step's 256^2
    numbers)."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        auto_rollout_diff,
        diff_model,
        fused_rollout_diff,
        fused_run_loop,
        plain_tiled_adjoint_superstep,
        structured_auto_run_loop,
        structured_run_loop,
        tiled_adjoint_plan,
        tiled_adjoint_rollout,
        tiled_rollout_diff,
    )
    from mpas_ocean_tpu_torch.structured.fused_model import _scal
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    for line in ptxas_report(log_text, ("tiled_adjoint_kernel",)):
        log(f"[8] ptxas {line}")

    def plan_of(st, sm, n_steps, **kw):
        x = st.layer_thickness
        return tiled_adjoint_plan(sm.ny2, sm.nx, x.shape[-1], x.element_size(), n_steps,
                                  halo=reverse_halo(sm.coriolis_terms), **kw)

    def plain_reverse(st, sm, dt, n, g, rt, ct, q, dtype=None):
        """The plain superstep back through the superstep-start states of the
        forward kernel (which the kernel sweep rebuilds bit for bit), so that
        a comparison sees only the reverse's arithmetic; in ``dtype`` (those
        states and g cast to it) where given."""
        starts = [st]
        for _ in range(n // q - 1):
            starts.append(fused_run_loop(starts[-1], sm, dt, q))
        cast = lambda s: s if dtype is None else StructState(
            *(x.to(dtype) for x in state_fields(s)))
        ddt = torch.zeros((), dtype=torch.float64, device=st.layer_thickness.device)
        g = cast(g)
        for s in reversed(starts):
            g, dd = plain_tiled_adjoint_superstep(cast(s), g, sm, dt, rt, ct, q)
            ddt = ddt + dd.double()
        return g, ddt

    def hold(what: str, errs: dict, tol: dict):
        log(f"[8] {what}: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= tol[f]:
                raise AssertionError(f"{what}: {f} {r:.3e} > {tol[f]}")

    # f64 random states: 16^2 (ny2 = 8; the one-tile window wraps onto
    # itself) and 64^2 (ny2 = 32), 6 steps, q = 1 and 2, groups of 2
    f64_tol = dict.fromkeys((*FIELDS, "d_dt"), 1e-12)
    worst = {}
    for n_side, tiles in ((16, ((8, 16), (2, 4))), (64, ((4, 4), (8, 16)))):
        model, prog = random_case(n_side, 4)
        st, sm = model.to_struct(prog), model.struct_mesh
        g = random_cot(st, 11)
        for rt, ct in tiles:
            for q in (1, 2):
                plan = (rt, ct, q, 2)
                out, ddt = tiled_adjoint_rollout(st, sm, 10.0, 6, g, plan=plan)
                again, ddt_again = tiled_adjoint_rollout(st, sm, 10.0, 6, g, plan=plan)
                ref, ref_dt = plain_reverse(st, sm, 10.0, 6, g, rt, ct, q)
                errs = cot_errors(out, ref, ddt, ref_dt)
                key = f"{n_side}^2 {rt}x{ct} q={q}"
                worst[key] = max(r for _, r in errs.values())
                for f, (_, r) in errs.items():
                    if not r <= 1e-12:
                        raise AssertionError(f"f64 tiled adjoint {key} vs plain: {f} {r:.3e}")
                if not (torch.equal(ddt, ddt_again) and all(
                        torch.equal(x, y) for x, y in zip(state_fields(out),
                                                          state_fields(again)))):
                    raise AssertionError(f"f64 tiled adjoint {key}: rerun differs")
    log("[8] f64 random x4 levels, 6 reverse steps, tiled adjoint kernel vs plain (same plan, "
        "same primal states): max relative error " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()) + "; reruns bitwise equal")

    # f64 256x256x100 IGW, 5 reverse steps at the planner's f64 plan
    _, _, model_l64, prog_l64 = igw_case(LARGE_N, LEVELS, np.float64)
    st_l64, sm_l64 = model_l64.to_struct(prog_l64), model_l64.struct_mesh
    g_l64 = random_cot(st_l64, 13)
    plan64 = plan_of(st_l64, sm_l64, 5)
    out, ddt = tiled_adjoint_rollout(st_l64, sm_l64, DT, 5, g_l64, plan=plan64)
    ref, ref_dt = plain_reverse(st_l64, sm_l64, DT, 5, g_l64, *plan64[:3])
    errs = cot_errors(out, ref, ddt, ref_dt)
    hold(f"f64 {LARGE_N}x{LARGE_N}x{LEVELS} IGW, 5 reverse steps, plan {plan64}, tiled adjoint "
         "vs plain", errs, f64_tol)
    del model_l64, st_l64, sm_l64, g_l64, out, ref

    # the dot-product identity <J v, g> = <v, J^T g> through
    # tiled_rollout_diff, J the 7-step rollout's Jacobian (J v by
    # forward-mode AD of the plain rollout)
    model, prog = random_case(16, 4)
    st, sm = model.to_struct(prog), model.struct_mesh
    v, g = random_cot(st, 12), random_cot(st, 14)
    _, jv = torch.func.jvp(
        lambda *xs: tuple(state_fields(structured_run_loop(StructState(*xs), sm, 10.0, 7))),
        tuple(state_fields(st)), tuple(state_fields(v)))
    lhs = sum(float((x * y).sum()) for x, y in zip(jv, state_fields(g)))
    leaves = [x.clone().requires_grad_(True) for x in state_fields(st)]
    out = tiled_rollout_diff(StructState(*leaves), sm, 10.0, 7, plan=(2, 4, 1, 3))
    jtg = torch.autograd.grad(state_fields(out), leaves, state_fields(g))
    rhs = sum(float((x * y).sum()) for x, y in zip(state_fields(v), jtg))
    dot_err = abs(lhs - rhs) / abs(rhs)
    log(f"[8] f64 dot-product identity through tiled_rollout_diff, 7 steps: <Jv, g> "
        f"{lhs:.17g}, <v, J^T g> {rhs:.17g}, relative gap {dot_err:.3e}")
    if not dot_err <= 1e-12:
        raise AssertionError(f"tiled dot-product identity off by {dot_err:.3e} > 1e-12")

    # f32, 100 reverse steps from the cotangent of sum(ssh^2) on the same
    # primal states, at 64^2 and 256^2, each also against the plain reverse
    # in f64 on those f32 inputs; the plain superstep's time at 256^2. The
    # f32 bounds, from an H100 (700 W) run: the kernel and the plain version
    # sum in other orders, and against the f64 reverse the kernel came in
    # closer than the plain version (d_h at 256^2: within 1.2x). d_u and d_h
    # differ by 1.2-1.4e-6 of
    # their scale at 64^2 and 3.5-5.7e-6 at 256^2; d_ssh, the divergence of
    # the level sums of d_u, carries d_u's rounding over 1/(k dc) of the
    # wave (~10 at 64^2, ~40 at 256^2): 1.0e-5 and 1.7e-4. The bounds leave
    # about 3x (PERF.md section 2).
    f32_tol = {"ssh": 5e-4, "layer_thickness": 1e-5, "normal_velocity": 2e-5, "d_dt": 4e-6}
    max_abs_err, plain_s, cases = 0.0, None, {}
    for n_side in (HEADLINE_N, LARGE_N):
        _, _, model, prog = igw_case(n_side, LEVELS, np.float32)
        st, sm = model.to_struct(prog), model.struct_mesh
        cases[n_side] = (model, prog, st, sm)
        fin = fused_run_loop(st, sm, DT, TILED_CHECK_STEPS)
        g = StructState(2 * fin.ssh, torch.zeros_like(fin.layer_thickness),
                        torch.zeros_like(fin.normal_velocity))
        plan = plan_of(st, sm, TILED_CHECK_STEPS)
        out, ddt = tiled_adjoint_rollout(st, sm, DT, TILED_CHECK_STEPS, g, plan=plan)
        ref, ref_dt = plain_reverse(st, sm, DT, TILED_CHECK_STEPS, g, *plan[:3])
        ref64, ref64_dt = plain_reverse(st, sm, DT, TILED_CHECK_STEPS, g, *plan[:3],
                                        dtype=torch.float64)
        what = f"f32 {n_side}x{n_side}x{LEVELS} IGW, {TILED_CHECK_STEPS} reverse steps"
        log(f"[8] {what}, against the plain reverse in f64 on the same inputs: kernel "
            f"{format_errors(cot_errors(out, ref64, ddt, ref64_dt))}; plain f32 "
            f"{format_errors(cot_errors(ref, ref64, ref_dt, ref64_dt))}")
        del ref64
        errs = cot_errors(out, ref, ddt, ref_dt)
        hold(f"{what}, plan {plan}, tiled adjoint vs plain on the same primal states", errs,
             f32_tol)
        if n_side == LARGE_N:
            max_abs_err = max(e for f, (e, _) in errs.items() if f != "d_dt")
            plain_s = cuda_times(lambda: plain_tiled_adjoint_superstep(st, g, sm, DT,
                                                                       *plan[:3]), REPS)
        del fin, g, out, ref

    # device time per launch of the two reverse kernels, each over a stack of
    # 40 primal states, the stream held until the call is queued (held_us)
    def per_launch(kernel, st, sm, group=40):
        scal = _scal(sm, DT, torch.float32)
        stack = tuple(torch.empty((group, *x.shape), dtype=x.dtype, device=x.device)
                      for x in state_fields(st))
        for dst, x in zip(stack, state_fields(st)):
            dst[0].copy_(x)
        fe_step.fe_fill_stack(stack, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
                              *scal, group - 1)
        g_in = tuple(x.contiguous() for x in state_fields(random_cot(st, 15)))
        acc = torch.zeros(1, dtype=torch.float64, device=st.layer_thickness.device)
        if kernel == "adjoint_step":
            run = lambda: adjoint_step.adjoint_rollout(
                stack, g_in, sm.f_edge, *sm.host_adjoint_stencil, *scal, group, acc)
        else:
            rt, ct, q, _ = plan_of(st, sm, group)
            run = lambda: tiled_adjoint.tiled_adjoint_rollout(
                stack, g_in, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
                *sm.host_adjoint_stencil, *scal, group, acc, row_tile=rt, col_tile=ct, q=q,
                halo=reverse_halo(sm.coriolis_terms))
        return [t / 1e6 for t in held_us(run, group, REPS)]

    _, _, model_m, prog_m = igw_case(128, LEVELS, np.float32)
    cases[128] = (model_m, prog_m, model_m.to_struct(prog_m), model_m.struct_mesh)
    launch_s = {}
    for n_side in (HEADLINE_N, 128, LARGE_N):
        st, sm = cases[n_side][2:]
        for kernel in ("adjoint_step", "tiled_adjoint"):
            launch_s[kernel, n_side] = per_launch(kernel, st, sm)
        was = "".join(
            f"; {k} earlier {EARLIER_US[f'{k} {n_side}']:.3f} us, now x"
            f"{statistics.median(launch_s[k, n_side]) * 1e6 / EARLIER_US[f'{k} {n_side}']:.4f}"
            for k in ("adjoint_step", "tiled_adjoint") if f"{k} {n_side}" in EARLIER_US)
        log(f"[8] device time per launch in a 40-step call (with its d(dt) sum; the stream "
            f"held until the call is queued), {n_side}x{n_side}x{LEVELS} "
            f"f32: adjoint_step {spread(launch_s['adjoint_step', n_side], 1e6, 'us')}; "
            f"tiled_adjoint, plan {plan_of(st, sm, 40)}, "
            f"{spread(launch_s['tiled_adjoint', n_side], 1e6, 'us')}{was} [{gpu}]")

    # the slice at full width: grad of sum(ssh_final^2) through
    # tiled_rollout_diff, 256x256x100 f32, 100 steps, from the lattice state
    model_l, prog_l, st_l, sm_l = cases[LARGE_N]
    n = LARGE_ADJ_STEPS
    plan_l = plan_of(st_l, sm_l, n, budget=diff_model._default_budget(st_l.ssh.device))
    fe_step.launches = adjoint_step.launches = tiled_adjoint.launches = 0
    t0 = time.perf_counter()
    out, grads = grad_sum_ssh2(tiled_rollout_diff, model_l.to_struct(prog_l), sm_l, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fe_step.launches, tiled_adjoint.launches, adjoint_step.launches)
    n_ss = n // plan_l[2]
    want = (2 * n - plan_l[2] * -(-n_ss // plan_l[3]), n_ss, 0)
    occ = tiled_adjoint.occupancy(*plan_l[:3], reverse_halo(sm_l.coriolis_terms), LEVELS)
    log(f"[8] tiled_adjoint plan {plan_l[:3]}: {occ[0]} bytes of shared memory per block, "
        f"{occ[1]} blocks of 512 threads per SM (occupancy query)")
    log(f"[8] main path: grad of sum(ssh^2) through tiled_rollout_diff, {LARGE_N}x{LARGE_N}x"
        f"{LEVELS} f32, {n} steps, plan {plan_l}: {wall:.3f} s wall (to_struct .. grad) "
        f"[{gpu}]; launches fe_step {counts[0]}, "
        f"tiled_adjoint {counts[1]}, adjoint_step {counts[2]} (want {want})")
    if counts != want:
        raise AssertionError(f"tiled grad launch counts {counts} != {want}")
    for name, x in zip(("d_ssh", "d_h", "d_u", "d_dt"), grads):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"tiled grad {name} is not finite")
    log(f"[8] |d_ssh|max {float(grads[0].abs().max()):.6e}, |d_h|max "
        f"{float(grads[1].abs().max()):.6e}, |d_u|max {float(grads[2].abs().max()):.6e}, "
        f"d_dt {float(grads[3]):.6e}")
    ref = structured_auto_run_loop(st_l, sm_l, DT, n)
    if not all(torch.equal(x, y) for x, y in zip(state_fields(out), state_fields(ref))):
        raise AssertionError("tiled_rollout_diff's forward differs from structured_auto_run_loop")
    log("[8] tiled_rollout_diff forward is bitwise structured_auto_run_loop's")
    del out, grads, ref
    tiled_s = cuda_times(lambda: grad_sum_ssh2(tiled_rollout_diff, st_l, sm_l, n), REPS)
    log(f"[8] grad through tiled_rollout_diff from the lattice state, {n} steps: "
        f"{spread(tiled_s)} per grad, {spread([t / n for t in tiled_s], 1e6, 'us')} per "
        f"rollout step; earlier {EARLIER_GRAD_S[LARGE_N]} s per grad [{gpu}]")
    by_kernel, window_us, busy_us = profile_by_kernel(
        lambda: grad_sum_ssh2(tiled_rollout_diff, st_l, sm_l, n),
        ("fe_step_kernel", "tiled_adjoint_kernel", "ddt_reduce"))
    log(f"[8] profiler, one tiled grad ({window_us:.0f} us by events): "
        + profile_line(by_kernel, window_us, busy_us, gpu))
    log(f"[8] {ddt_line(by_kernel)}")

    # the size rule: the same 256^2 grad through the fused reverse, the
    # 64^2 4000-step grad through the tiled one (phase 6 ran it fused), and
    # the 100-step grad through both at 128^2
    fused_s = cuda_times(lambda: grad_sum_ssh2(fused_rollout_diff, st_l, sm_l, n), REPS)
    log(f"[8] the same grad through fused_rollout_diff (adjoint_step): {spread(fused_s)} per "
        f"grad, {spread([t / n for t in fused_s], 1e6, 'us')} per rollout step [{gpu}]")
    st_h, sm_h = cases[HEADLINE_N][2:]
    tiled_64 = cuda_times(lambda: grad_sum_ssh2(tiled_rollout_diff, st_h, sm_h, GRAD_STEPS),
                          REPS)
    log(f"[8] grad, {HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32, {GRAD_STEPS} steps, through "
        f"tiled_rollout_diff: {spread(tiled_64)} per grad; through fused_rollout_diff (phase "
        f"6) {spread(fused_grad_64)} [{gpu}]")
    st_m, sm_m = cases[128][2:]
    grad_128 = {route.__name__: cuda_times(lambda: grad_sum_ssh2(route, st_m, sm_m, n), REPS)
                for route in (fused_rollout_diff, tiled_rollout_diff)}
    log(f"[8] grad, 128x128x{LEVELS} f32, {n} steps: " + "; ".join(
        f"through {k} {spread(v)}" for k, v in grad_128.items()) + f" [{gpu}]")
    routes = {}
    for n_side in (HEADLINE_N, 128, LARGE_N):
        st, sm = cases[n_side][2:]
        adjoint_step.launches = tiled_adjoint.launches = 0
        grad_sum_ssh2(auto_rollout_diff, st, sm, 10)
        routes[n_side] = ("tiled_adjoint" if tiled_adjoint.launches and not adjoint_step.launches
                          else "adjoint_step" if adjoint_step.launches
                          and not tiled_adjoint.launches else "both")
    grad_med = {HEADLINE_N: (fused_grad_64, tiled_64), LARGE_N: (fused_s, tiled_s),
                128: tuple(grad_128.values())}
    ratio = {s: statistics.median(t) / statistics.median(f)
             for s, (f, t) in sorted(grad_med.items())}
    log(f"[8] auto_rollout_diff's size rule on the card: the tiled reverse on lattices of at "
        f"least {diff_model.TILED_REVERSE_SITES} sites (2 ny2 nx), the fused reverse below; "
        f"it took " + ", ".join(f"{s}^2 -> {r}" for s, r in routes.items())
        + "; grad time, tiled over fused: " + ", ".join(f"{s}^2 {r:.4f}"
                                                        for s, r in ratio.items()))

    dims = (sm_l.ny2, sm_l.nx, LEVELS, len(sm_l.coriolis_terms), 4)
    bound, bound_by = step_bound("adjoint_step", *dims)
    old = alt_bounds(step_bound, "adjoint_step", *dims)
    log(f"[8] tiled_adjoint {LARGE_N}^2 per launch: "
        f"{statistics.median(launch_s['tiled_adjoint', LARGE_N]) * 1e6:.3f} us; bound "
        f"{bound * 1e6:.3f} us at the ceilings ({bound_by}, each input read once; "
        f"{old['probe'] * 1e6:.3f} us at the probes' rates, {old['datasheet'] * 1e6:.3f} us at "
        f"the data sheet's); plain superstep "
        f"{statistics.median(plain_s) * 1e6:.3f} us [{gpu}]")
    entry = {
        "name": "tiled_adjoint",
        "route": "cuda",
        "source": "mpas_ocean_tpu_torch/csrc/tiled_adjoint.cu",
        "replaces": "mpas_ocean_tpu/structured/pallas_model.py:1979",
        "launches": counts[1],
        "max_abs_err": max_abs_err,
        "ms": statistics.median(launch_s["tiled_adjoint", LARGE_N]) * 1e3,
        "plain_ms": statistics.median(plain_s) * 1e3,
        "bound_ms": bound * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
        **alt_keys("bound_ms", old, 1e3),
        "plan": list(plan_l),
        "ms_64": statistics.median(launch_s["tiled_adjoint", HEADLINE_N]) * 1e3,
        "ms_128": statistics.median(launch_s["tiled_adjoint", 128]) * 1e3,
        "grad_s_256": statistics.median(tiled_s),
        "grad_s_256_fused": statistics.median(fused_s),
        "grad_s_64": statistics.median(tiled_64),
    }
    adjoint_256 = {
        "ms_256": statistics.median(launch_s["adjoint_step", LARGE_N]) * 1e3,
        "ms_128": statistics.median(launch_s["adjoint_step", 128]) * 1e3,
        "ms_64_in_40_step_calls": statistics.median(launch_s["adjoint_step", HEADLINE_N]) * 1e3,
        "bound_ms_256": bound * 1e3,
        **alt_keys("bound_ms_256", old, 1e3),
    }
    return entry, adjoint_256


def peaks_phase(gpu: str, log_text: str) -> list:
    """Phase 9 (run right after the build), kernel 5: the probes against
    their plain versions (fma at T = 1000 on bench.py's inputs and at T = 10
    on random ones, f32 and f64, both modes, to 1e-5 relative; the stream
    probe bitwise, in the layouts the rates use), then the rates, each the
    median of REPS calls of at least 0.1 s (fma) or of bench.py's 128 passes
    (device memory) and 20 ms (L2), and the plain stream's beside. Sets
    MEASURED (the probes' rates) and CEILING (at each level the highest of
    the data sheet's, the probe's and the plain version's rate), the divisor
    of every bound this script prints after it. Returns the kernels line's
    entries of the two probes, each at one count: fma at T = 1000, the
    stream at bench.py's 128 passes."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.tools import peaks

    for line in ptxas_report(log_text, ("fma_stream_kernel", "fma_reg_kernel",
                                        "stream_kernel")):
        log(f"[9] ptxas {line}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    fma_err = {}
    for dtype in (torch.float32, torch.float64):
        ones = torch.ones(peaks.FMA_SHAPE, dtype=dtype, device=dev)
        o_r, x_r = (torch.from_numpy(v).to(dev, dtype)
                    for v in rng.uniform(0.5, 1.5, size=(2, *peaks.FMA_SHAPE)))
        for reg in (False, True):
            for o0, x0, steps in ((ones, ones, 1000), (o_r, x_r, 10)):
                ref = peaks.plain_fma(o0.clone(), x0, steps)
                out = peaks.fma_probe(o0.clone(), x0, steps, in_registers=reg)
                err = float((out - ref).abs().max())
                rel = err / float(ref.abs().max())
                key = (str(dtype).split(".")[-1], "registers" if reg else "shared", steps)
                fma_err[key] = (err, rel)
                if not rel <= 1e-5:
                    raise AssertionError(f"fma_probe {key} vs plain: {rel:.3e} > 1e-5")
    log("[9] fma_probe vs plain (max|diff|, relative): " + ", ".join(
        f"{d} {m} T={t} {e:.3e} ({r:.3e})" for (d, m, t), (e, r) in fma_err.items()))
    gen = torch.Generator(device=dev).manual_seed(2)
    for n, per, layout in ((peaks.HBM_FLOATS, 1, peaks.HBM_LAYOUT),
                           (peaks.state_floats(HEADLINE_N, LEVELS), 4, peaks.L2_LAYOUT)):
        b = torch.randn(n, device=dev, generator=gen)
        out = peaks.stream_probe(b.clone(), 4, per_launch=per, **layout)
        if not torch.equal(out, peaks.plain_stream(b, 4)):
            raise AssertionError(f"stream_probe over {n} values differs from plain")
        del b, out
    log(f"[9] stream_probe vs plain: bitwise equal over the 256 MB array (a pass per launch, "
        f"{peaks.HBM_LAYOUT}) and the 64x64x100 state's size (four per launch, "
        f"{peaks.L2_LAYOUT})")

    # the rates; the launches of this phase's measuring runs
    peaks.fma_launches = peaks.stream_launches = 0
    fma = {(itemsize, reg): peaks.measure_fma(dtype, in_registers=reg, reps=REPS)
           for itemsize, dtype in ((4, torch.float32), (8, torch.float64))
           for reg in (False, True)}
    hbm = peaks.measure_stream(peaks.HBM_FLOATS, resident=False, reps=REPS)
    l2 = peaks.measure_stream(peaks.state_floats(HEADLINE_N, LEVELS), resident=True,
                              reps=REPS)
    launches = (peaks.fma_launches, peaks.stream_launches)
    want = (4 * (2 + REPS), 2 + REPS * hbm["passes"] + 2 + REPS)
    log(f"[9] launches fma_probe {launches[0]}, stream_probe {launches[1]} (want {want})")
    if launches != want:
        raise AssertionError(f"probe launches {launches} != {want}")
    l2_n = peaks.state_floats(HEADLINE_N, LEVELS)
    plain = {"hbm": peaks.measure_plain_stream(peaks.HBM_FLOATS, peaks.STREAM_PASSES, reps=REPS),
             "l2": peaks.measure_plain_stream(l2_n, 1000, reps=REPS)}
    MEASURED.update(hbm=hbm["rate"], l2=l2["rate"],
                    flops={4: fma[4, True]["rate"], 8: fma[8, True]["rate"]})
    hbm_top = max(DATASHEET["hbm"], hbm["rate"], plain["hbm"]["rate"])
    CEILING.update(hbm=hbm_top, l2=max(hbm_top, l2["rate"], plain["l2"]["rate"]),
                   flops={i: max(DATASHEET["flops"][i], fma[i, True]["rate"]) for i in (4, 8)})
    for (itemsize, reg), r in fma.items():
        name = f"f{8 * itemsize} FMA in {'registers' if reg else 'shared memory'}"
        log(f"[9] {name}: {spread(r['flops_per_s'], 1e-12, 'TFLOP/s')}, {r['steps']} steps of "
            f"{r['seconds'][0]:.4f} s; data sheet {DATASHEET['flops'][itemsize] / 1e12:.0f} "
            f"TFLOP/s [{gpu}]")
    for name, r, pl in (("device memory (256 MB, a pass per launch)", hbm, plain["hbm"]),
                        ("L2 (the 64x64x100 f32 state, 13.1 MB a pass)", l2, plain["l2"])):
        log(f"[9] stream through {name}: {spread(r['bytes_per_s'], 1e-12, 'TB/s')}, "
            f"{r['passes']} passes; plain b = b + 1 {spread(pl['bytes_per_s'], 1e-12, 'TB/s')}, "
            f"{pl['passes']} passes (a launch each); data sheet (device memory) "
            f"{DATASHEET['hbm'] / 1e12:.2f} TB/s [{gpu}]")
    log(f"[9] ceilings, the divisor of every bound below: device memory "
        f"{CEILING['hbm'] / 1e12:.4f} TB/s, L2 {CEILING['l2'] / 1e12:.4f} TB/s, FMA f32 "
        f"{CEILING['flops'][4] / 1e12:.4f} TFLOP/s, f64 {CEILING['flops'][8] / 1e12:.4f} "
        f"TFLOP/s (each the highest of the data sheet, probe and plain rates) [{gpu}]")

    # the entries, each at one count: kernel 5's streaming mode at bench.py's
    # shape (its counterpart) at T = 1000, and the stream probe over device
    # memory at bench.py's 128 passes
    n = int(np.prod(peaks.FMA_SHAPE))
    ones = torch.ones(peaks.FMA_SHAPE, device=dev)
    plain_fma_s = cuda_times(lambda: peaks.plain_fma(ones, ones, 1000), REPS)
    kern_1000 = cuda_times(lambda: peaks.fma_probe(ones.clone(), ones, 1000), REPS)
    shared = fma[4, False]
    fma_entry = {
        "name": "fma_probe",
        "route": "cuda",
        "source": "mpas_ocean_tpu_torch/csrc/peaks.cu",
        "replaces": "bench.py:267",
        "launches": launches[0],
        "max_abs_err": max(e for e, _ in fma_err.values()),
        "ms": statistics.median(kern_1000) * 1e3,
        "plain_ms": statistics.median(plain_fma_s) * 1e3,
        "bound_ms": peaks.fma_flops(n, 1000) / CEILING["flops"][4] * 1e3,
        "bound_by": "operations",
        "library_ms": None,
        "steps": 1000,
        "bound_source": ("NVIDIA H100 SXM data sheet, 67 TFLOP/s FP32"
                         if CEILING["flops"][4] == DATASHEET["flops"][4]
                         else "the f32 FMA probe in registers"),
        "calibrated_steps": shared["steps"],
        "calibrated_ms": statistics.median(shared["seconds"]) * 1e3,
        "max_rel_err": max(r for _, r in fma_err.values()),
        "tflops_shared_f32": shared["rate"] / 1e12,
        "tflops_registers_f32": fma[4, True]["rate"] / 1e12,
        "tflops_shared_f64": fma[8, False]["rate"] / 1e12,
        "tflops_registers_f64": fma[8, True]["rate"] / 1e12,
    }
    stream_entry = {
        "name": "stream_probe",
        "route": "cuda",
        "source": "mpas_ocean_tpu_torch/csrc/peaks.cu",
        "replaces": "bench.py:293 (measure_hbm_bw, an XLA loop beside kernel 5)",
        "launches": launches[1],
        "max_abs_err": 0.0,
        "ms": statistics.median(hbm["seconds"]) * 1e3,
        "plain_ms": statistics.median(plain["hbm"]["seconds"]) * 1e3,
        "bound_ms": peaks.stream_bytes(peaks.HBM_FLOATS, hbm["passes"]) / CEILING["hbm"] * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "passes": hbm["passes"],
        "bound_source": ("NVIDIA H100 SXM data sheet, 3.35 TB/s" if CEILING["hbm"] == DATASHEET["hbm"]
                         else "the stream probe or its plain version"),
        "tbps_hbm": hbm["rate"] / 1e12,
        "tbps_hbm_plain": plain["hbm"]["rate"] / 1e12,
        "tbps_l2": l2["rate"] / 1e12,
        "tbps_l2_plain": plain["l2"]["rate"] / 1e12,
        "l2_passes": l2["passes"],
        "tbps_ceiling_l2": CEILING["l2"] / 1e12,
    }
    return [fma_entry, stream_entry]


def channel_forward_phase(gpu: str, periodic: dict) -> dict:
    """Phase 10, the coastal Kelvin channel forward (bench.py's build_kelvin,
    its t_kelvin line): the masked arms of fe_step (FE) and tiled_step (FB)
    against the plain masked steps (f64 64x64x100 and 256x256x100 to 1e-12;
    f32 64x64x100 over 100 steps: ssh and h to PERF.md section 2's 1e-5, u
    within U_GAP_FACTOR times the plain f32 run's distance from an f64 one,
    a factor that controls with u stored at a lower precision are shown to
    exceed), the main path
    at full width (64x64x100 f32 FE over 8000 steps with its launches and
    live gridpoints per second, FB over 1000; 256x256x100 FE and FB over
    1000), the walls closed bit for bit, the Kelvin ssh L2 error at the end
    of the 8000 steps (f32, f64, and an f64 host run), and the masked times
    beside the periodic ones of phases 4 and 7 (``periodic``: seconds per
    step). Returns the masked arms' numbers for the kernels line."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        structured_auto_run_loop,
        structured_fb_step,
        structured_run_loop,
        structured_step,
        tiled_run_loop,
    )
    from mpas_ocean_tpu_torch.structured.slab import stencil_reach
    from mpas_ocean_tpu_torch.structured.tiled_model import plain_tiled_rollout, resolve_plan
    from mpas_ocean_tpu_torch.utils import error_measures

    def rounded_u_run(st, sm, n, fb, dtype):
        # the control: the plain masked steps with u stored in ``dtype``
        # between steps, as a kernel that kept u at that precision would
        step = structured_fb_step if fb else structured_step
        for _ in range(n):
            st = step(st, sm, DT)
            st = StructState(ssh=st.ssh, layer_thickness=st.layer_thickness,
                             normal_velocity=st.normal_velocity.to(dtype).to(st.ssh.dtype))
        return st

    scheme = {False: "FE", True: "FB"}
    n_chk = TILED_CHECK_STEPS

    def plan_of(sm, itemsize, fb, n_steps):
        return resolve_plan(sm.ny2, sm.nx, LEVELS, itemsize,
                            stencil_reach(sm.coriolis_terms, fb), n_steps)

    # f64 64x64x100: the masked arms against the plain masked steps
    chan, kw, model64, prog64 = kelvin_case(HEADLINE_N, LEVELS, np.float64)
    st64, sm64 = model64.to_struct(prog64), model64.struct_mesh
    ref64 = {}
    for fb in (False, True):
        out = structured_auto_run_loop(st64, sm64, DT, n_chk, fb=fb)
        again = structured_auto_run_loop(st64, sm64, DT, n_chk, fb=fb)
        ref64[fb] = structured_run_loop(st64, sm64, DT, n_chk, fb=fb)
        errs = field_errors(out, ref64[fb], sm64.resting_thickness_sum)
        log(f"[10] f64 {HEADLINE_N}x{HEADLINE_N}x{LEVELS} Kelvin channel, {n_chk} "
            f"{scheme[fb]} steps, masked {'tiled_step' if fb else 'fe_step'} vs plain: "
            f"max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= 1e-12:
                raise AssertionError(f"f64 channel {scheme[fb]} vs plain: {f} {r:.3e} > 1e-12")
        if not all(torch.equal(getattr(out, f), getattr(again, f)) for f in FIELDS):
            raise AssertionError(f"f64 channel {scheme[fb]}: rerun differs")
        check_walls(out, sm64, f"f64 channel {scheme[fb]}")
    plan_fb = plan_of(sm64, 8, True, n_chk)
    errs = field_errors(tiled_run_loop(st64, sm64, DT, 10, fb=True),
                        plain_tiled_rollout(st64, sm64, DT, 10, *plan_fb, True),
                        sm64.resting_thickness_sum)
    log(f"[10] f64 channel, 10 FB steps, plan {plan_fb}, masked tiled_step vs its plain "
        f"windows: max|diff| (/scale) = {format_errors(errs)}")
    for f, (_, r) in errs.items():
        if not r <= 1e-12:
            raise AssertionError(f"f64 channel tiled FB vs plain windows: {f} {r:.3e}")

    # f32 64x64x100, 100 steps: against the plain masked steps, and both
    # against the f64 plain run
    _, _, model, prog = kelvin_case(HEADLINE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    max_abs_err = {}
    for fb in (False, True):
        out = structured_auto_run_loop(st, sm, DT, n_chk, fb=fb)
        ref = structured_run_loop(st, sm, DT, n_chk, fb=fb)
        errs = field_errors(out, ref, sm.resting_thickness_sum)
        runs = {"kernel": out, "plain": ref,
                "u in fp16": rounded_u_run(st, sm, n_chk, fb, torch.float16),
                "u in bf16": rounded_u_run(st, sm, n_chk, fb, torch.bfloat16)}
        gap = {name: float((x.normal_velocity.double() - ref64[fb].normal_velocity).abs().max())
               for name, x in runs.items()}
        log(f"[10] f32 {HEADLINE_N}x{HEADLINE_N}x{LEVELS} Kelvin channel, {n_chk} "
            f"{scheme[fb]} steps, masked kernel vs plain: max|diff| (/scale) = "
            f"{format_errors(errs)} (PERF.md section 2: ssh, h 1e-5, u 3e-4); max|u - u_f64| "
            + ", ".join(f"{name} {g:.3e} (x{g / gap['plain']:.3f} the plain f32 run's)"
                        for name, g in gap.items()) + f" m/s; limit x{U_GAP_FACTOR}")
        for f in ("ssh", "layer_thickness"):
            if not errs[f][1] <= 1e-5:
                raise AssertionError(f"f32 channel {scheme[fb]} vs plain: {f} {errs[f][1]:.3e}")
        if not gap["kernel"] <= U_GAP_FACTOR * gap["plain"]:
            raise AssertionError(f"f32 channel {scheme[fb]}: u is {gap['kernel']:.3e} from the "
                                 f"f64 run, the plain version {gap['plain']:.3e}")
        for name in ("u in fp16", "u in bf16"):
            if not gap[name] > U_GAP_FACTOR * gap["plain"]:
                raise AssertionError(f"f32 channel {scheme[fb]}: the control with {name} passes "
                                     f"the u limit ({gap[name]:.3e}), which then tells nothing")
        check_walls(out, sm, f"f32 channel {scheme[fb]}")
        max_abs_err[fb] = max(e for e, _ in errs.values())
    del ref64

    # the main path at the headline size: FE over 8000 steps, from to_struct
    live = chan.n_cells * LEVELS
    sites = 2 * sm.ny2 * sm.nx * LEVELS
    fe_step.launches = tiled_step.launches = 0
    t0 = time.perf_counter()
    out = structured_auto_run_loop(model.to_struct(prog), sm, DT, HEADLINE_STEPS)
    check_walls(out, sm, "FE main path")
    final = model.from_struct(out)
    wall = time.perf_counter() - t0
    counts = (fe_step.launches, tiled_step.launches)
    log(f"[10] main path {HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32 Kelvin channel FE, "
        f"{HEADLINE_STEPS} steps: {wall:.3f} s wall (to_struct .. from_struct); launches "
        f"fe_step {counts[0]}, tiled_step {counts[1]} (want {HEADLINE_STEPS}, 0)")
    if counts != (HEADLINE_STEPS, 0):
        raise AssertionError(f"channel FE main path launches {counts}")
    fe_launches = counts[0]
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(final, f)).all()):
            raise AssertionError(f"channel main path: {f} is not finite")
    if tuple(final.normal_velocity.shape) != (chan.n_edges, LEVELS) or tuple(
            final.ssh.shape) != (chan.n_cells,):
        raise AssertionError("channel main path: wrong output shapes")
    _, fe_s = timed_rollout(lambda n: structured_auto_run_loop(st, sm, DT, n),
                            HEADLINE_STEPS, REPS)
    _, plain_fe = timed_rollout(lambda n: structured_run_loop(st, sm, DT, n), n_chk, REPS)
    dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
    bound_fe64 = step_bound("fe_step", *dims)[0]
    old_fe64 = alt_bounds(step_bound, "fe_step", *dims)
    med = statistics.median(fe_s)
    log("[10] " + rate_line("channel FE (fe_step, masked)", fe_s, sites, gpu)
        + f"; {live / med:.4e} live gridpoints*steps/s (bench.py's "
        f"kelvin_channel_gridpoints_per_sec: {chan.n_cells} live cells x {LEVELS}); plain "
        f"{statistics.median(plain_fe) * 1e6:.3f} us/step; periodic fe_step (phase 4) "
        f"{periodic['fe 64'] * 1e6:.3f} us/step, masked/periodic "
        f"{med / periodic['fe 64']:.4f}")
    log("[10] " + share_line("masked fe_step 64^2", fe_s, bound_fe64, old_fe64))

    # the Kelvin wave after PHYSICS_STEPS steps against the exact solution:
    # f32 and f64 through the kernel, and an f64 run of the plain version on
    # the host with one 1000 m layer (identical layers make the 100-layer
    # system the 1-layer one)
    t_end = PHYSICS_STEPS * DT
    exact = kw.exact_ssh(np.asarray(chan.cells.x, np.float64),
                         np.asarray(chan.cells.y, np.float64), t_end)

    def l2(ssh):
        return error_measures(ssh.double().numpy(), exact, chan, "cell").L_two

    k32 = model.from_struct(structured_auto_run_loop(st, sm, DT, PHYSICS_STEPS))
    k64 = model64.from_struct(structured_auto_run_loop(st64, sm64, DT, PHYSICS_STEPS))
    _, _, model1, prog1 = kelvin_case(HEADLINE_N, 1, np.float64, device="cpu")
    host = model1.from_struct(structured_run_loop(model1.to_struct(prog1), model1.struct_mesh,
                                                  DT, PHYSICS_STEPS))
    p32 = model.from_struct(structured_run_loop(st, sm, DT, PHYSICS_STEPS))
    l2_k, l2_p, l2_k64, l2_host = l2(k32.ssh), l2(p32.ssh), l2(k64.ssh), l2(host.ssh)
    ssh_gap = float(np.abs(k64.ssh.numpy() - host.ssh.numpy()).max())
    log(f"[10] Kelvin ssh L2 error vs exact at t={t_end:.0f} s, {HEADLINE_N}x{HEADLINE_N}x"
        f"{LEVELS} channel FE: f32 kernel {l2_k:.6e}, f32 plain {l2_p:.6e}; f64 kernel "
        f"{l2_k64:.6e}, f64 1-layer host run {l2_host:.6e} (the wave not moved: "
        f"{l2(prog.ssh):.6e}); f64 kernel vs host max|ssh diff| {ssh_gap:.3e} m")
    if not (ssh_gap <= 1e-6 and abs(l2_k64 - l2_host) <= 1e-6):
        raise AssertionError(f"f64 channel off the host run: {ssh_gap}, {l2_k64}, {l2_host}")
    # FE is unstable for gravity waves and grows each f32 run's column-sum
    # rounding into an error of its own, several times the f64 one (7.16
    # against 0.90 on an H100 at 700 W): the kernel's must be of the plain
    # version's size
    if not (np.isfinite(l2_k) and 0.5 * l2_p <= l2_k <= 2.0 * l2_p):
        raise AssertionError(f"f32 channel Kelvin error {l2_k} off the plain run's {l2_p}")
    del k32, k64, host, p32, model64, st64, sm64

    # FB at the headline size, 1000 steps
    q_fb = plan_of(sm, 4, True, LARGE_MAIN_STEPS)[2]
    tiled_step.launches = fe_step.launches = 0
    out = structured_auto_run_loop(model.to_struct(prog), sm, DT, LARGE_MAIN_STEPS, fb=True)
    check_walls(out, sm, "FB 64^2 main path")
    counts = (fe_step.launches, tiled_step.launches)
    if counts != (0, LARGE_MAIN_STEPS // q_fb):
        raise AssertionError(f"channel FB 64^2 launches {counts}")
    _, fb_s = timed_rollout(lambda n: structured_auto_run_loop(st, sm, DT, n, fb=True),
                            LARGE_MAIN_STEPS, REPS)
    med = statistics.median(fb_s)
    log("[10] " + rate_line(f"channel FB 64^2 (tiled_step, masked, plan "
                            f"{plan_of(sm, 4, True, LARGE_MAIN_STEPS)}; launches {counts[1]})",
                            fb_s, sites, gpu)
        + f"; {live / med:.4e} live gridpoints*steps/s; periodic (phase 7) "
        f"{periodic['fb 64'] * 1e6:.3f} us/step, masked/periodic {med / periodic['fb 64']:.4f}")
    del model, st, sm, out, final

    # 256x256x100: f64 against plain for 10 steps, then the main path, FE and
    # FB over 1000 f32 steps
    _, _, model_l64, prog_l64 = kelvin_case(LARGE_N, LEVELS, np.float64)
    st_l64, sm_l64 = model_l64.to_struct(prog_l64), model_l64.struct_mesh
    for fb in (False, True):
        errs = field_errors(structured_auto_run_loop(st_l64, sm_l64, DT, 10, fb=fb),
                            structured_run_loop(st_l64, sm_l64, DT, 10, fb=fb),
                            sm_l64.resting_thickness_sum)
        log(f"[10] f64 {LARGE_N}x{LARGE_N}x{LEVELS} channel, 10 {scheme[fb]} steps, masked "
            f"kernel vs plain: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= 1e-12:
                raise AssertionError(f"f64 {LARGE_N}^2 channel {scheme[fb]}: {f} {r:.3e}")
    del model_l64, st_l64, sm_l64
    chan_l, _, model_l, prog_l = kelvin_case(LARGE_N, LEVELS, np.float32)
    st_l, sm_l = model_l.to_struct(prog_l), model_l.struct_mesh
    live_l, sites_l = chan_l.n_cells * LEVELS, 2 * sm_l.ny2 * sm_l.nx * LEVELS
    dims_l = (sm_l.ny2, sm_l.nx, LEVELS, len(sm_l.coriolis_terms), 4)
    large_s, large_counts = {}, {}
    for fb in (False, True):
        q = plan_of(sm_l, 4, fb, LARGE_MAIN_STEPS)[2]
        want = (0, LARGE_MAIN_STEPS // q) if fb else (LARGE_MAIN_STEPS, 0)
        fe_step.launches = tiled_step.launches = 0
        t0 = time.perf_counter()
        out = structured_auto_run_loop(model_l.to_struct(prog_l), sm_l, DT, LARGE_MAIN_STEPS,
                                       fb=fb)
        check_walls(out, sm_l, f"{LARGE_N}^2 {scheme[fb]} main path")
        final = model_l.from_struct(out)
        wall = time.perf_counter() - t0
        large_counts[fb] = (fe_step.launches, tiled_step.launches)
        log(f"[10] main path {LARGE_N}x{LARGE_N}x{LEVELS} f32 channel {scheme[fb]}, "
            f"{LARGE_MAIN_STEPS} steps: {wall:.3f} s wall; launches fe_step "
            f"{large_counts[fb][0]}, tiled_step {large_counts[fb][1]} (want {want})")
        if large_counts[fb] != want:
            raise AssertionError(f"{LARGE_N}^2 channel {scheme[fb]} launches {large_counts[fb]}")
        if not all(bool(torch.isfinite(getattr(final, f)).all()) for f in FIELDS):
            raise AssertionError(f"{LARGE_N}^2 channel {scheme[fb]}: not finite")
        _, large_s[fb] = timed_rollout(
            lambda n: structured_auto_run_loop(st_l, sm_l, DT, n, fb=fb), LARGE_MAIN_STEPS, REPS)
        med = statistics.median(large_s[fb])
        key = f"{'fb' if fb else 'fe'} 256"
        if fb:
            plan = plan_of(sm_l, 4, True, LARGE_MAIN_STEPS)
            halo = stencil_reach(sm_l.coriolis_terms, True)
            bound = tiled_bounds(*dims_l, plan, halo)[0]
            old = alt_bounds(tiled_bounds, *dims_l, plan, halo)
            route = f"tiled_step, masked, plan {plan}"
        else:
            bound = step_bound("fe_step", *dims_l)[0]
            old = alt_bounds(step_bound, "fe_step", *dims_l)
            route = "fe_step, masked"
        log("[10] " + rate_line(f"channel {scheme[fb]} {LARGE_N}^2 ({route})", large_s[fb],
                                sites_l, gpu)
            + f"; {live_l / med:.4e} live gridpoints*steps/s; periodic (phase 7) "
            f"{periodic[key] * 1e6:.3f} us/step, masked/periodic {med / periodic[key]:.4f}")
        log("[10] " + share_line(f"masked {route.split(',')[0]} {LARGE_N}^2", large_s[fb], bound,
                                 old))
    return {
        "fe_step": {"masked_ms": statistics.median(fe_s) * 1e3,
                    "masked_launches": fe_launches,
                    "masked_max_abs_err": max_abs_err[False],
                    "masked_bound_ms": bound_fe64 * 1e3,
                    **alt_keys("masked_bound_ms", old_fe64, 1e3),
                    "masked_plain_ms": statistics.median(plain_fe) * 1e3,
                    "masked_ms_256": statistics.median(large_s[False]) * 1e3,
                    "masked_over_periodic_64": statistics.median(fe_s) / periodic["fe 64"],
                    "masked_over_periodic_256":
                        statistics.median(large_s[False]) / periodic["fe 256"],
                    "kelvin_live_gridpoints_per_s": live / statistics.median(fe_s),
                    "kelvin_ssh_l2_f32": l2_k, "kelvin_ssh_l2_f64": l2_k64},
        "tiled_step": {"masked_ms": statistics.median(large_s[True]) * q * 1e3,
                       "masked_launches": large_counts[True][1],
                       "masked_max_abs_err": max_abs_err[True],
                       "masked_bound_ms": bound * q * 1e3,
                       **alt_keys("masked_bound_ms", old, q * 1e3),
                       "masked_ms_fb_64": statistics.median(fb_s) * 1e3,
                       "masked_over_periodic_256":
                           statistics.median(large_s[True]) / periodic["fb 256"],
                       "masked_over_periodic_64": statistics.median(fb_s) / periodic["fb 64"]},
    }


def channel_grad_phase(gpu: str, periodic: dict) -> dict:
    """Phase 11, the gradient on the Kelvin channel: the masked arms of
    adjoint_step and tiled_adjoint against the plain masked reverse (f64
    random channels, 1e-12, reruns bitwise; f32 64x64x100 and 256x256x100
    over 100 reverse steps on the same primal states, PERF.md section 2's
    bounds), the f64 dot-product identity over 7 steps through both routes,
    each reverse kernel's device time per launch (``held_us``), and the
    main path at full width: the grad of sum(ssh_final^2) over 4000 steps at
    64x64x100 f32 through auto_rollout_diff and over 100 steps at
    256x256x100 through tiled_rollout_diff, with launch counts, times and a
    profiler breakdown. ``periodic`` holds phases 6 and 8's times (seconds).
    Returns the masked arms' numbers for the kernels line."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        auto_rollout_diff,
        diff_model,
        fused_adjoint_rollout,
        fused_rollout_diff,
        fused_run_loop,
        plain_tiled_adjoint_superstep,
        structured_adjoint_step,
        structured_auto_run_loop,
        structured_run_loop,
        tiled_adjoint_plan,
        tiled_adjoint_rollout,
        tiled_rollout_diff,
    )
    from mpas_ocean_tpu_torch.structured.fused_model import _scal, kernel_live
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    def plan_of(st, sm, n_steps, **kw):
        x = st.layer_thickness
        return tiled_adjoint_plan(sm.ny2, sm.nx, x.shape[-1], x.element_size(), n_steps,
                                  halo=reverse_halo(sm.coriolis_terms), **kw)

    def starts(st, sm, dt, n, q):
        out = [st]
        for _ in range(n // q - 1):
            out.append(fused_run_loop(out[-1], sm, dt, q))
        return out

    def plain_reverse(st, sm, dt, n, g, plan=None, dtype=None):
        """The plain masked reverse back through the forward kernel's own
        primal states: the adjoint step (plan None) or the tiled superstep
        of plan (rt, ct, q); in ``dtype`` (states and g cast) where given."""
        cast = lambda s: s if dtype is None else StructState(
            *(x.to(dtype) for x in state_fields(s)))
        q = 1 if plan is None else plan[2]
        ddt = torch.zeros((), dtype=torch.float64, device=st.layer_thickness.device)
        g = cast(g)
        for s in reversed(starts(st, sm, dt, n, q)):
            if plan is None:
                g, dd = structured_adjoint_step(cast(s), g, sm, dt)
            else:
                g, dd = plain_tiled_adjoint_superstep(cast(s), g, sm, dt, *plan)
            ddt = ddt + dd.double()
        return g, ddt

    def hold(what: str, errs: dict, tol: dict):
        log(f"[11] {what}: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= tol[f]:
                raise AssertionError(f"{what}: {f} {r:.3e} > {tol[f]}")

    # f64 random 16x16x4 and 64x64x4 channels: both reverse kernels against
    # the plain masked reverse, 6 steps, reruns bitwise
    f64_tol = dict.fromkeys((*FIELDS, "d_dt"), 1e-12)
    worst = {}
    for n_side in (16, 64):
        model, prog = random_channel(n_side, 4)
        st, sm = model.to_struct(prog), model.struct_mesh
        g = random_cot(st, 11)
        runs = [("adjoint_step", None,
                 lambda: fused_adjoint_rollout(st, sm, 10.0, 6, g, plan=4))]
        for plan in ((2, 4, 1), (2, 4, 2), (4, 8, 1)):
            runs.append((f"tiled_adjoint {plan}", plan,
                         lambda plan=plan: tiled_adjoint_rollout(st, sm, 10.0, 6, g,
                                                                 plan=(*plan, 2))))
        for name, plan, run in runs:
            (out, ddt), (again, ddt_again) = run(), run()
            ref, ref_dt = plain_reverse(st, sm, 10.0, 6, g, plan)
            errs = cot_errors(out, ref, ddt, ref_dt)
            worst[f"{n_side}^2 {name}"] = max(r for _, r in errs.values())
            for f, (_, r) in errs.items():
                if not r <= 1e-12:
                    raise AssertionError(f"f64 {n_side}^2 channel {name} vs plain: {f} {r:.3e}")
            if not (torch.equal(ddt, ddt_again) and all(
                    torch.equal(x, y) for x, y in zip(state_fields(out), state_fields(again)))):
                raise AssertionError(f"f64 channel {name}: rerun differs")
    log("[11] f64 random channels x4 levels, 6 reverse steps, masked reverse kernels vs the "
        "plain masked reverse (same primal states): max relative error " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()) + "; reruns bitwise equal")

    # the dot-product identity <J v, g> = <v, J^T g> on a channel, 7 steps,
    # J^T g through both differentiable routes
    model, prog = random_channel(16, 4)
    st, sm = model.to_struct(prog), model.struct_mesh
    v, g = random_cot(st, 12), random_cot(st, 14)
    _, jv = torch.func.jvp(
        lambda *xs: tuple(state_fields(structured_run_loop(StructState(*xs), sm, 10.0, 7))),
        tuple(state_fields(st)), tuple(state_fields(v)))
    lhs = sum(float((x * y).sum()) for x, y in zip(jv, state_fields(g)))
    for route, plan in ((fused_rollout_diff, None), (tiled_rollout_diff, (2, 4, 1, 3))):
        leaves = [x.clone().requires_grad_(True) for x in state_fields(st)]
        out = route(StructState(*leaves), sm, 10.0, 7, plan=plan)
        jtg = torch.autograd.grad(state_fields(out), leaves, state_fields(g))
        rhs = sum(float((x * y).sum()) for x, y in zip(state_fields(v), jtg))
        gap = abs(lhs - rhs) / abs(rhs)
        log(f"[11] f64 dot-product identity on the channel through {route.__name__}, 7 steps: "
            f"<Jv, g> {lhs:.17g}, <v, J^T g> {rhs:.17g}, relative gap {gap:.3e}")
        if not gap <= 1e-12:
            raise AssertionError(f"channel dot-product identity off by {gap:.3e}")

    # f32 Kelvin channels, 100 reverse steps from the cotangent of
    # sum(ssh^2) on the same primal states: adjoint_step at 64^2 and
    # tiled_adjoint at 256^2, each also against the plain reverse in f64
    tol = {HEADLINE_N: {"ssh": 1e-5, "layer_thickness": 2e-6, "normal_velocity": 2e-6,
                        "d_dt": 4e-6},
           LARGE_N: {"ssh": 5e-4, "layer_thickness": 1e-5, "normal_velocity": 2e-5,
                     "d_dt": 4e-6}}
    cases, max_abs_err, plain_s = {}, {}, {}
    for n_side in (HEADLINE_N, LARGE_N):
        chan, _, model, prog = kelvin_case(n_side, LEVELS, np.float32)
        st, sm = model.to_struct(prog), model.struct_mesh
        cases[n_side] = (chan, model, prog, st, sm)
        fin = fused_run_loop(st, sm, DT, TILED_CHECK_STEPS)
        g = StructState(2 * fin.ssh, torch.zeros_like(fin.layer_thickness),
                        torch.zeros_like(fin.normal_velocity))
        if n_side == HEADLINE_N:
            plan, name = None, "adjoint_step"
            out, ddt = fused_adjoint_rollout(st, sm, DT, TILED_CHECK_STEPS, g)
        else:
            plan, name = plan_of(st, sm, TILED_CHECK_STEPS)[:3], "tiled_adjoint"
            out, ddt = tiled_adjoint_rollout(st, sm, DT, TILED_CHECK_STEPS, g,
                                             plan=(*plan, 10))
        ref, ref_dt = plain_reverse(st, sm, DT, TILED_CHECK_STEPS, g, plan)
        ref64, ref64_dt = plain_reverse(st, sm, DT, TILED_CHECK_STEPS, g, plan, torch.float64)
        what = (f"f32 {n_side}x{n_side}x{LEVELS} Kelvin channel, {TILED_CHECK_STEPS} reverse "
                f"steps, masked {name}{'' if plan is None else f' plan {plan}'}")
        log(f"[11] {what}, against the plain reverse in f64 on the same inputs: kernel "
            f"{format_errors(cot_errors(out, ref64, ddt, ref64_dt))}; plain f32 "
            f"{format_errors(cot_errors(ref, ref64, ref_dt, ref64_dt))}")
        errs = cot_errors(out, ref, ddt, ref_dt)
        hold(f"{what} vs plain on the same primal states", errs, tol[n_side])
        max_abs_err[name] = max(e for f, (e, _) in errs.items() if f != "d_dt")
        if n_side == LARGE_N:
            plain_s[name] = cuda_times(
                lambda: plain_tiled_adjoint_superstep(st, g, sm, DT, *plan), REPS)
        else:
            plain_s[name] = cuda_times(lambda: structured_adjoint_step(st, g, sm, DT), REPS)
        del fin, g, out, ref, ref64

    # device time per launch of the masked reverse kernels over a stack of 40
    # primal states, the stream held until the call is queued
    def per_launch(kernel, st, sm, group=40):
        scal = _scal(sm, DT, torch.float32)
        live = kernel_live(sm)
        stack = tuple(torch.empty((group, *x.shape), dtype=x.dtype, device=x.device)
                      for x in state_fields(st))
        for dst, x in zip(stack, state_fields(st)):
            dst[0].copy_(x)
        fe_step.fe_fill_stack(stack, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
                              *scal, group - 1, live=live)
        g_in = tuple(x.contiguous() for x in state_fields(random_cot(st, 15)))
        acc = torch.zeros(1, dtype=torch.float64, device=st.layer_thickness.device)
        if kernel == "adjoint_step":
            run = lambda: adjoint_step.adjoint_rollout(
                stack, g_in, sm.f_edge, *sm.host_adjoint_stencil, *scal, group, acc, live=live)
        else:
            rt, ct, q, _ = plan_of(st, sm, group)
            run = lambda: tiled_adjoint.tiled_adjoint_rollout(
                stack, g_in, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
                *sm.host_adjoint_stencil, *scal, group, acc, row_tile=rt, col_tile=ct, q=q,
                halo=reverse_halo(sm.coriolis_terms), live=live)
        return [t / 1e6 for t in held_us(run, group, REPS)]

    launch_s = {("adjoint_step", HEADLINE_N): per_launch("adjoint_step", *cases[HEADLINE_N][3:]),
                ("tiled_adjoint", LARGE_N): per_launch("tiled_adjoint", *cases[LARGE_N][3:])}
    for (name, n_side), t in launch_s.items():
        key = f"{name} {n_side}"
        log(f"[11] masked {name} device time per launch in a 40-step call (held stream), "
            f"{n_side}x{n_side}x{LEVELS} f32 channel: {spread(t, 1e6, 'us')}; periodic "
            f"(phase {6 if name == 'adjoint_step' else 8}) {periodic[key] * 1e6:.3f} us, "
            f"masked/periodic {statistics.median(t) / periodic[key]:.4f} [{gpu}]")

    # the main path at full width: the 64^2 grad over 4000 steps through
    # auto_rollout_diff (fe_step and adjoint_step's masked arms)
    chan, model, prog, st, sm = cases[HEADLINE_N]
    n = GRAD_STEPS
    state_bytes = sum(x.numel() * x.element_size() for x in state_fields(st))
    group = diff_model.adjoint_plan(n, state_bytes, diff_model._default_budget(st.ssh.device))
    fe_step.launches = adjoint_step.launches = tiled_adjoint.launches = 0
    t0 = time.perf_counter()
    out, grads = grad_sum_ssh2(auto_rollout_diff, model.to_struct(prog), sm, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fe_step.launches, adjoint_step.launches, tiled_adjoint.launches)
    want = (2 * n - -(-n // group), n, 0)
    log(f"[11] main path: grad of sum(ssh^2) through auto_rollout_diff, {HEADLINE_N}x"
        f"{HEADLINE_N}x{LEVELS} f32 Kelvin channel, {n} steps, groups of {group}: {wall:.3f} s "
        f"wall (to_struct .. grad); launches fe_step {counts[0]}, adjoint_step {counts[1]}, "
        f"tiled_adjoint {counts[2]} (want {want}) [{gpu}]")
    if counts != want:
        raise AssertionError(f"channel grad launch counts {counts} != {want}")
    adj_launches = counts[1]
    for name, x in zip(("d_ssh", "d_h", "d_u", "d_dt"), grads):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"channel grad {name} is not finite")
    ref = structured_auto_run_loop(st, sm, DT, n)
    if not all(torch.equal(x, y) for x, y in zip(state_fields(out), state_fields(ref))):
        raise AssertionError("auto_rollout_diff's forward differs from structured_auto_run_loop")
    log(f"[11] |d_ssh|max {float(grads[0].abs().max()):.6e}, |d_h|max "
        f"{float(grads[1].abs().max()):.6e}, |d_u|max {float(grads[2].abs().max()):.6e}, "
        f"d_dt {float(grads[3]):.6e}; the forward is bitwise structured_auto_run_loop's")
    del out, grads, ref
    grad_64 = cuda_times(lambda: grad_sum_ssh2(auto_rollout_diff, st, sm, n), REPS)
    log(f"[11] channel grad, {n} steps: {spread(grad_64)} per grad, "
        f"{spread([t / n for t in grad_64], 1e6, 'us')} per rollout step; periodic (phase 6) "
        f"{periodic['grad 64']:.6g} s, masked/periodic "
        f"{statistics.median(grad_64) / periodic['grad 64']:.4f} [{gpu}]")
    by_kernel, window_us, busy_us = profile_by_kernel(
        lambda: grad_sum_ssh2(auto_rollout_diff, st, sm, n),
        ("fe_step_kernel", "adjoint_step_kernel", "ddt_reduce"))
    log(f"[11] profiler, one channel grad ({window_us:.0f} us by events): "
        + profile_line(by_kernel, window_us, busy_us, gpu))

    # 256^2, 100 steps, through tiled_rollout_diff (tiled_adjoint's masked arm)
    chan_l, model_l, prog_l, st_l, sm_l = cases[LARGE_N]
    n = LARGE_ADJ_STEPS
    plan_l = plan_of(st_l, sm_l, n, budget=diff_model._default_budget(st_l.ssh.device))
    fe_step.launches = adjoint_step.launches = tiled_adjoint.launches = 0
    t0 = time.perf_counter()
    out, grads = grad_sum_ssh2(tiled_rollout_diff, model_l.to_struct(prog_l), sm_l, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fe_step.launches, tiled_adjoint.launches, adjoint_step.launches)
    n_ss = n // plan_l[2]
    want = (2 * n - plan_l[2] * -(-n_ss // plan_l[3]), n_ss, 0)
    log(f"[11] main path: grad of sum(ssh^2) through tiled_rollout_diff, {LARGE_N}x{LARGE_N}x"
        f"{LEVELS} f32 Kelvin channel, {n} steps, plan {plan_l}: {wall:.3f} s wall; launches "
        f"fe_step {counts[0]}, tiled_adjoint {counts[1]}, adjoint_step {counts[2]} (want "
        f"{want}) [{gpu}]")
    if counts != want:
        raise AssertionError(f"channel tiled grad launch counts {counts} != {want}")
    tiled_adj_launches = counts[1]
    for name, x in zip(("d_ssh", "d_h", "d_u", "d_dt"), grads):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"channel tiled grad {name} is not finite")
    del out, grads
    grad_256 = cuda_times(lambda: grad_sum_ssh2(tiled_rollout_diff, st_l, sm_l, n), REPS)
    log(f"[11] channel grad through tiled_rollout_diff, {n} steps: {spread(grad_256)} per "
        f"grad; periodic (phase 8) {periodic['grad 256']:.6g} s, masked/periodic "
        f"{statistics.median(grad_256) / periodic['grad 256']:.4f} [{gpu}]")
    by_kernel, window_us, busy_us = profile_by_kernel(
        lambda: grad_sum_ssh2(tiled_rollout_diff, st_l, sm_l, n),
        ("fe_step_kernel", "tiled_adjoint_kernel", "ddt_reduce"))
    log(f"[11] profiler, one channel tiled grad ({window_us:.0f} us by events): "
        + profile_line(by_kernel, window_us, busy_us, gpu))

    dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
    dims_l = (sm_l.ny2, sm_l.nx, LEVELS, len(sm_l.coriolis_terms), 4)
    return {
        "adjoint_step": {
            "masked_ms": statistics.median(launch_s["adjoint_step", HEADLINE_N]) * 1e3,
            "masked_launches": adj_launches,
            "masked_max_abs_err": max_abs_err["adjoint_step"],
            "masked_bound_ms": step_bound("adjoint_step", *dims)[0] * 1e3,
            **alt_keys("masked_bound_ms", alt_bounds(step_bound, "adjoint_step", *dims), 1e3),
            "masked_plain_ms": statistics.median(plain_s["adjoint_step"]) * 1e3,
            "masked_grad_s_64": statistics.median(grad_64)},
        "tiled_adjoint": {
            "masked_ms": statistics.median(launch_s["tiled_adjoint", LARGE_N]) * 1e3,
            "masked_launches": tiled_adj_launches,
            "masked_max_abs_err": max_abs_err["tiled_adjoint"],
            "masked_bound_ms": step_bound("adjoint_step", *dims_l)[0] * plan_l[2] * 1e3,
            **alt_keys("masked_bound_ms", alt_bounds(step_bound, "adjoint_step", *dims_l),
                       plan_l[2] * 1e3),
            "masked_plain_ms": statistics.median(plain_s["tiled_adjoint"]) * 1e3,
            "masked_grad_s_256": statistics.median(grad_256)},
    }


def nl_bound(ny2: int, nx: int, k: int, n_terms: int, itemsize: int, masked: bool = False,
             peaks: dict | None = None):
    """(bound seconds, "bytes" or "operations") of one nonlinear step (both
    forward kernels' nonlinear arms): a state read and written, rts and the
    vertex constants (4 planes, 20 on a channel) and the tables read, over
    the byte rate; pallas_model.step_flop_count's FLOPs per (m, i, k) site,
    184 + 4 n_terms (6 more masked; 376 with the hex table's 48 taps) over
    the dtype's FMA rate. ``peaks`` as for ``step_bound``."""
    cells = 2 * ny2 * nx
    state = cells * (1 + 4 * k)
    consts = cells + (20 if masked else 4) * ny2 * nx
    tables = 4 * (44 + 3 * n_terms + 12 * 11) + 8 * (n_terms + 12)
    nbytes = itemsize * (2 * state + consts) + tables
    ops = ny2 * nx * k * (184 + 4 * n_terms + (6 if masked else 0))
    peaks = CEILING if peaks is None else peaks
    rate = byte_rate(peaks, itemsize * state)
    t_bytes, t_ops = nbytes / rate, ops / peaks["flops"][itemsize]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nonlinear_plan_checks(scheme: dict, hold) -> dict:
    """Phase 12's check of the nonlinear arms at the main paths' own plans;
    ``scheme`` names FE and FB, ``hold`` logs and checks a comparison.
    Returns the worst f64 error over scale per arm ("fe_step FE periodic",
    ..., "tiled_step FB masked")."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
    from mpas_ocean_tpu_torch.structured import StructState, structured_run_loop
    from mpas_ocean_tpu_torch.structured.fused_model import _scal, kernel_live, nl_scal, nl_setup

    # The main paths' own plans (nl_plan at f32: FE (4, 16, 8) at 64^2 and
    # (8, 16, 4) at 256^2, FB (8, 8, 4)), passed to the wrappers, on random
    # states of the main paths' lattices (layers of 10 m perturbed by 1e-3,
    # u of 0.5 m/s; dt = 30 s, 20 steps), where the nonlinear terms move u by
    # ~3e-3 of its scale at 64^2: in f64 at the same tiles with the largest slice
    # that fits f64 (the f32 slices do not), within 1e-12 of the plain steps;
    # in f32 at the exact plans, ssh and h within 1e-5 of scale of the plain
    # f32 steps and u no farther from an f64 plain run from the same values
    # than U_GAP_FACTOR times the plain f32 run; the linear run must miss
    # the f64 limit and the f32 u limit by 100x.
    n_plan = 20
    worst = {}

    def plan_run(st, sm, fb, tile, ks):
        dtype = st.layer_thickness.dtype
        wrapper = tiled_step.tiled_nl_rollout if fb else fe_step.fe_nl_rollout
        before = (fe_step.launches, tiled_step.launches)
        ssh, h, u = wrapper(st.ssh, st.layer_thickness, st.normal_velocity,
                            sm.resting_thickness_sum.to(dtype).contiguous(), *sm.host_stencil,
                            nl_setup(sm, dtype), sm.vertex_cell_terms, sm.edge_vertex_terms,
                            *_scal(sm, DT, dtype), *nl_scal(sm, dtype), n_plan,
                            live=kernel_live(sm), tile=tile, ks=ks)
        grew = (fe_step.launches - before[0], tiled_step.launches - before[1])
        if grew != ((0, n_plan) if fb else (n_plan, 0)):
            raise AssertionError(f"plan run {scheme[fb]} {tile} slice {ks}: launches {grew}")
        return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u)

    for name, n in (("periodic", HEADLINE_N), ("periodic", LARGE_N), ("channel", HEADLINE_N)):
        case = igw_case if name == "periodic" else kelvin_case
        mesh_h, *_, model64 = case(n, LEVELS, np.float64)[:3]
        model32 = case(n, LEVELS, np.float32)[2]
        rng = np.random.default_rng(17)
        h = 10.0 + 0.01 * rng.normal(size=(mesh_h.n_cells, LEVELS))
        u = 0.5 * rng.normal(size=(mesh_h.n_edges, LEVELS))
        fields = (h.sum(1) - 1000.0, h, u)
        f32 = [x.astype(np.float32) for x in fields]
        st32 = model32.to_struct(mt.PrognosticVars(*(torch.from_numpy(x) for x in f32)))
        st64 = model64.to_struct(mt.PrognosticVars(*(torch.from_numpy(x) for x in fields)))
        sm32, sm64 = model32.struct_mesh, model64.struct_mesh
        # the f64 run from the f32 run's own values, which the f32 u check measures from
        st64_32 = model64.to_struct(mt.PrognosticVars(
            *(torch.from_numpy(x.astype(np.float64)) for x in f32)))
        for fb in (False, True):
            plan = fe_step.nl_plan(sm32.ny2, sm32.nx, LEVELS, 4, fb)
            tile, ks64 = plan[:2], fe_step.nl_slice(plan[:2], LEVELS, 8, fb)
            what = (f"{n}x{n}x{LEVELS} {name} random, {n_plan} nonlinear {scheme[fb]} steps at "
                    f"the f32 main path's plan {plan}")
            out, again = (plan_run(st64, sm64, fb, tile, ks64) for _ in range(2))
            ref = structured_run_loop(st64, sm64, DT, n_plan, nonlinear=True, fb=fb)
            errs = field_errors(out, ref, sm64.resting_thickness_sum)
            hold(f"f64 {what} (slice {ks64}) vs plain", errs, 1e-12)
            if not all(torch.equal(getattr(out, f), getattr(again, f)) for f in FIELDS):
                raise AssertionError(f"f64 {what}: rerun differs")
            lin = field_errors(structured_run_loop(st64, sm64, DT, n_plan, fb=fb), ref,
                               sm64.resting_thickness_sum)
            miss = max(r for _, r in lin.values())
            if not miss >= 100 * 1e-12:
                raise AssertionError(f"f64 {what}: the linear run is only {miss:.3e} off")
            key = ("tiled_step FB" if fb else "fe_step FE") + (
                " masked" if name == "channel" else " periodic")
            worst[key] = max(worst.get(key, 0.0), max(r for _, r in errs.values()))
            out32 = plan_run(st32, sm32, fb, tile, plan[2])
            ref32 = structured_run_loop(st32, sm32, DT, n_plan, nonlinear=True, fb=fb)
            lin32 = structured_run_loop(st32, sm32, DT, n_plan, fb=fb)
            ref64 = structured_run_loop(st64_32, sm64, DT, n_plan, nonlinear=True, fb=fb)
            e32 = field_errors(out32, ref32, sm32.resting_thickness_sum)
            l32 = field_errors(lin32, ref32, sm32.resting_thickness_sum)
            hold(f"f32 {what} vs plain (ssh, h)", {f: e32[f] for f in FIELDS[:2]}, 1e-5)
            gap = {k: float((x.normal_velocity.double() - ref64.normal_velocity).abs().max())
                   for k, x in (("kernel", out32), ("plain", ref32), ("linear", lin32))}
            limit = U_GAP_FACTOR * gap["plain"]
            lin_h = max(l32[f][1] for f in FIELDS[:2])
            log(f"[12] f32 {what}: max|u - u_f64| kernel {gap['kernel']:.3e}, plain "
                f"{gap['plain']:.3e}, linear {gap['linear']:.3e} m/s (limit {limit:.3e}: the "
                f"linear run x{gap['linear'] / limit:.1f} of it; its ssh, h x{lin_h / 1e-5:.1f} "
                f"of 1e-5)")
            if not gap["kernel"] <= limit:
                raise AssertionError(f"f32 {what}: u {gap['kernel']:.3e} from f64, limit "
                                     f"{limit:.3e}")
            if not gap["linear"] >= 100 * limit:
                raise AssertionError(f"f32 {what}: the linear run misses u by only "
                                     f"{gap['linear'] / limit:.1f}x")
            if name == "channel":
                check_walls(out, sm64, f"f64 {what}")
                check_walls(out32, sm32, f"f32 {what}")
        log(f"[12] {n}x{n}x{LEVELS} {name}: the main path's plans hold in f64 and f32; "
            f"the linear run misses the nonlinear by {miss:.3e} of scale in f64 (control)")
        del st64, st32, st64_32
    return worst


def nonlinear_phase(gpu: str, log_text: str, linear: dict) -> dict:
    """Phase 12, the nonlinear (vector-invariant) forward: the nonlinear arms
    of fe_step (FE; the tiled route's nonlinear FE too) and tiled_step (FB,
    q = 1) against the plain nonlinear steps (f64 16^2 and 64^2 random
    states with u of 0.5 m/s, periodic and channel, to 1e-12 with bitwise
    reruns, the linear run shown to miss; the main paths' own f32 plans on
    random states of the main paths' lattices, 64^2 and 256^2 periodic and
    the 64^2 channel, in f64 to 1e-12 and in f32 by the distance from an f64
    run, the linear run shown to miss both by 100x; f32 64^2 and 256^2 IGW
    and the 64^2 Kelvin channel after 100 steps, to the tolerances of
    PERF.md section 2, with controls that must miss them), the timed main
    paths (64x64x100 IGW FE over 8000 steps,
    256x256x100 FE and FB over 1000, the 64^2 Kelvin channel FE over 8000)
    with exact launch counts, bounds, shares and the ratio to the linear arm
    (``linear``: phases 4, 7 and 10's seconds per step in this call), the
    nonlinear IGW's ssh error (f64 kernel against an f64 host run), the
    walls. Returns the ``nonlinear_*`` keys of the two kernels' entries."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        structured_auto_run_loop,
        structured_fb_step,
        structured_run_loop,
        structured_step,
        tiled_run_loop,
    )
    from mpas_ocean_tpu_torch.utils import error_measures

    for line in ptxas_report(log_text, ("nl_step_kernel",)):
        log(f"[12] ptxas {line}")
    scheme = {False: "FE", True: "FB"}

    def f32_plan(sm, fb):
        return fe_step.nl_plan(sm.ny2, sm.nx, LEVELS, 4, fb)

    def hold(what, errs, tol):
        log(f"[12] {what}: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= (tol[f] if isinstance(tol, dict) else tol):
                raise AssertionError(f"{what}: {f} {r:.3e}")

    # f64: every arm against the plain nonlinear steps, 20 steps, on random
    # states whose u of 0.5 m/s makes the relative vorticity outweigh f, over
    # a 40 m column (FE's gravity-wave CFL 0.2 at dt = 10 s)
    worst = {}
    for n in (16, HEADLINE_N):
        for channel in (False, True):
            levels = 4 if n == 16 else LEVELS
            model, prog = (random_channel if channel else random_case)(
                n, levels, seed=5, u_amp=0.5, layer=40.0 / levels)
            st, sm = model.to_struct(prog), model.struct_mesh
            runs = {
                "fe_step FE": lambda: structured_auto_run_loop(st, sm, 10.0, 20, nonlinear=True),
                "tiled_step FB": lambda: tiled_run_loop(st, sm, 10.0, 20, nonlinear=True,
                                                        fb=True),
            }
            for name, run in runs.items():
                fb = name.endswith("FB")
                out, again = run(), run()
                ref = structured_run_loop(st, sm, 10.0, 20, nonlinear=True, fb=fb)
                what = (f"f64 {n}x{n} {'channel' if channel else 'periodic'} random, 20 steps, "
                        f"{name}")
                errs = field_errors(out, ref, sm.resting_thickness_sum)
                hold(what + " vs plain", errs, 1e-12)
                if not all(torch.equal(getattr(out, f), getattr(again, f)) for f in FIELDS):
                    raise AssertionError(f"{what}: rerun differs")
                lin = field_errors(structured_run_loop(st, sm, 10.0, 20, fb=fb), ref,
                                   sm.resting_thickness_sum)
                miss = max(r for _, r in lin.values())
                if not miss >= 100 * 1e-12:
                    raise AssertionError(f"{what}: the linear run is only {miss:.3e} off")
                if channel:
                    check_walls(out, sm, what)
                key = f"{name} {'masked' if channel else 'periodic'}"
                worst[key] = max(worst.get(key, 0.0), max(r for _, r in errs.values()))
            log(f"[12] f64 {n}x{n} {'channel' if channel else 'periodic'}: the linear run "
                f"misses the nonlinear by {miss:.3e} of scale (control); reruns bitwise equal")
            del model, st, sm

    for key, err in nonlinear_plan_checks(scheme, hold).items():
        worst[key] = max(worst[key], err)

    # f32 after 100 steps: ssh and h to 1e-5 of scale (as the linear arms);
    # on the periodic IGW u to 3e-4 (64^2) and 5e-3 (256^2) of max|u|, the
    # linear arms' bounds (the kernel's first call on an H100 read 1.6e-4,
    # 1.2e-4 FB; 1.1e-3, 6.6e-4 at 256^2), with a control that must miss
    # them: the plain run with u stored in bf16 between steps; on the
    # Kelvin channel u by its distance from an f64 plain run, at most
    # U_GAP_FACTOR times the plain f32 run's, with the fp16 and bf16
    # controls that must exceed it (phase 10's rule)
    def rounded_u_run(st, sm, n, fb, dtype):
        step = structured_fb_step if fb else structured_step
        for _ in range(n):
            st = step(st, sm, DT, True)
            st = StructState(ssh=st.ssh, layer_thickness=st.layer_thickness,
                             normal_velocity=st.normal_velocity.to(dtype).to(st.ssh.dtype))
        return st

    n_chk = TILED_CHECK_STEPS
    max_abs_err = {}
    # each f32 case built once (a 256^2 lattice takes ~10 s on the host)
    cases = {("IGW", HEADLINE_N): igw_case(HEADLINE_N, LEVELS, np.float32),
             ("IGW", LARGE_N): igw_case(LARGE_N, LEVELS, np.float32),
             ("Kelvin", HEADLINE_N): kelvin_case(HEADLINE_N, LEVELS, np.float32)}
    for name, n in cases:
        *_, model, prog = cases[name, n]
        st, sm = model.to_struct(prog), model.struct_mesh
        if name == "Kelvin":
            *_, model64, prog64 = kelvin_case(n, LEVELS, np.float64)
            st64, sm64 = model64.to_struct(prog64), model64.struct_mesh
        for fb in (False, True):
            out = structured_auto_run_loop(st, sm, DT, n_chk, nonlinear=True, fb=fb)
            ref = structured_run_loop(st, sm, DT, n_chk, nonlinear=True, fb=fb)
            errs = field_errors(out, ref, sm.resting_thickness_sum)
            what = f"f32 {n}x{n}x{LEVELS} {name}, {n_chk} nonlinear {scheme[fb]} steps"
            max_abs_err[(name, n, fb)] = max(e for e, _ in errs.values())
            ctrl = rounded_u_run(st, sm, n_chk, fb, torch.bfloat16)
            if name == "IGW":
                u_tol = 3e-4 if n == HEADLINE_N else 5e-3
                c_err = field_errors(ctrl, ref, sm.resting_thickness_sum)["normal_velocity"][1]
                log(f"[12] {what}: control (u in bf16) u {c_err:.3e} of scale, limit {u_tol}")
                hold(f"{what}, kernel vs plain", errs,
                     {"ssh": 1e-5, "layer_thickness": 1e-5, "normal_velocity": u_tol})
                if not c_err > u_tol:
                    raise AssertionError(f"{what}: the bf16 control passes the u limit")
                continue
            ref64 = structured_run_loop(st64, sm64, DT, n_chk, nonlinear=True, fb=fb)
            runs = {"kernel": out, "plain": ref, "u in bf16": ctrl,
                    "u in fp16": rounded_u_run(st, sm, n_chk, fb, torch.float16)}
            gap = {k: float((x.normal_velocity.double() - ref64.normal_velocity).abs().max())
                   for k, x in runs.items()}
            hold(f"{what}, kernel vs plain (u: PERF.md section 2's channel rule)",
                 {f: errs[f] for f in ("ssh", "layer_thickness")}, 1e-5)
            log(f"[12] {what}: max|u - u_f64| " + ", ".join(
                f"{k} {g:.3e} (x{g / gap['plain']:.3f} the plain f32 run's)"
                for k, g in gap.items()) + f" m/s; limit x{U_GAP_FACTOR}")
            if not gap["kernel"] <= U_GAP_FACTOR * gap["plain"]:
                raise AssertionError(f"{what}: u {gap['kernel']:.3e} from f64, plain "
                                     f"{gap['plain']:.3e}")
            for k in ("u in fp16", "u in bf16"):
                if not gap[k] > U_GAP_FACTOR * gap["plain"]:
                    raise AssertionError(f"{what}: the control with {k} passes the u limit")
            check_walls(out, sm, what)
        del model, st, sm

    # the timed main paths, f32, from to_struct: launches exact
    def main_path(name, n, n_steps, fb, want):
        horz, wave, model, prog = cases[name, n]
        sm = model.struct_mesh
        fe_step.launches = tiled_step.launches = 0
        t0 = time.perf_counter()
        out = structured_auto_run_loop(model.to_struct(prog), sm, DT, n_steps, nonlinear=True,
                                       fb=fb)
        final = model.from_struct(out)
        wall = time.perf_counter() - t0
        counts = (fe_step.launches, tiled_step.launches)
        log(f"[12] main path {n}x{n}x{LEVELS} f32 {name} nonlinear {scheme[fb]}, {n_steps} "
            f"steps: {wall:.3f} s wall (to_struct .. from_struct); launches fe_step "
            f"{counts[0]}, tiled_step {counts[1]} (want {want})")
        if counts != want:
            raise AssertionError(f"nonlinear {name} {n}^2 {scheme[fb]} launches {counts}")
        for f in FIELDS:
            if not bool(torch.isfinite(getattr(final, f)).all()):
                raise AssertionError(f"nonlinear {name} {n}^2 main path: {f} is not finite")
        if sm.edge_mask is not None:
            check_walls(out, sm, f"nonlinear {name} main path")
        st = model.to_struct(prog)
        _, t = timed_rollout(lambda k: structured_auto_run_loop(st, sm, DT, k, nonlinear=True,
                                                                fb=fb), n_steps, REPS)
        return horz, wave, model, prog, final, t, counts

    out = {}
    timed = {}
    for key, name, n, steps, fb, kernel in (
            ("fe 64", "IGW", HEADLINE_N, HEADLINE_STEPS, False, "fe_step"),
            ("fe 256", "IGW", LARGE_N, LARGE_MAIN_STEPS, False, "fe_step"),
            ("fb 256", "IGW", LARGE_N, LARGE_MAIN_STEPS, True, "tiled_step"),
            ("channel fe 64", "Kelvin", HEADLINE_N, HEADLINE_STEPS, False, "fe_step")):
        want = (0, steps) if fb else (steps, 0)
        res = main_path(name, n, steps, fb, want)
        timed[key] = res
        t, sm = res[5], res[2].struct_mesh
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
        masked = sm.edge_mask is not None
        bound = nl_bound(*dims, masked)
        alts = {"probe": nl_bound(*dims, masked, MEASURED)[0],
                "datasheet": nl_bound(*dims, masked, DATASHEET)[0]}
        med = statistics.median(t)
        sites = 2 * sm.ny2 * sm.nx * LEVELS
        live = ""
        if masked:
            live = f"; {res[0].n_cells * LEVELS / med:.4e} live gridpoints*steps/s"
        plan = f32_plan(sm, fb)
        log(f"[12] " + rate_line(f"nonlinear {name} {scheme[fb]} {n}^2 ({kernel}, plan (rows, "
                                 f"columns, slice) {plan})", t, sites, gpu)
            + f"{live}; the linear arm in this call {linear[key] * 1e6:.3f} us/step, "
            f"nonlinear/linear {med / linear[key]:.4f}")
        log(f"[12] " + share_line(f"nonlinear {kernel} {scheme[fb]} {n}^2", t, bound[0], alts)
            + f", bound by {bound[1]}")
        out[key] = {"ms": med * 1e3, "launches": res[6][1 if fb else 0],
                    "bound_ms": bound[0] * 1e3, "bound_by": bound[1],
                    **{f"bound_ms_{k}": v * 1e3 for k, v in alts.items()},
                    "over_linear": med / linear[key]}

    # the plain version's time (100 steps)
    for key, fb in (("fe 64", False), ("fb 256", True), ("channel fe 64", False)):
        model = timed[key][2]
        st, sm = model.to_struct(timed[key][3]), model.struct_mesh
        _, p = timed_rollout(lambda k: structured_run_loop(st, sm, DT, k, nonlinear=True, fb=fb),
                             n_chk, REPS)
        out[key]["plain_ms"] = statistics.median(p) * 1e3
        log(f"[12] plain nonlinear {key}: {statistics.median(p) * 1e6:.3f} us/step "
            f"({n_chk}-step runs)")
    # the channel's FB through tiled_step's masked nonlinear arm, 64^2, 1000 steps
    _, _, model_c, prog_c = cases["Kelvin", HEADLINE_N]
    st, sm = model_c.to_struct(prog_c), model_c.struct_mesh
    tiled_step.launches = 0
    outc = structured_auto_run_loop(st, sm, DT, LARGE_MAIN_STEPS, nonlinear=True, fb=True)
    check_walls(outc, sm, "nonlinear channel FB")
    fb_launches = tiled_step.launches
    if fb_launches != LARGE_MAIN_STEPS:
        raise AssertionError(f"nonlinear channel FB launches {fb_launches}")
    _, t = timed_rollout(lambda k: structured_auto_run_loop(st, sm, DT, k, nonlinear=True,
                                                            fb=True), LARGE_MAIN_STEPS, REPS)
    _, p = timed_rollout(lambda k: structured_run_loop(st, sm, DT, k, nonlinear=True, fb=True),
                         n_chk, REPS)
    out["channel fb 64"] = {"ms": statistics.median(t) * 1e3, "launches": fb_launches,
                            "plain_ms": statistics.median(p) * 1e3,
                            "bound_ms": nl_bound(sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms),
                                                 4, True)[0] * 1e3}
    log("[12] " + rate_line(f"nonlinear Kelvin FB 64^2 (tiled_step, masked, plan "
                            f"{f32_plan(sm, True)}; launches {fb_launches})", t,
                            2 * sm.ny2 * sm.nx * LEVELS, gpu)
        + f"; plain {statistics.median(p) * 1e6:.3f} us/step")

    # the nonlinear IGW at t = PHYSICS_STEPS * DT: its ssh error beside the
    # linear one (phase 4), and the f64 kernel against an f64 host run with
    # one 1000 m layer (identical layers make the 100-layer nonlinear system
    # the 1-layer one: q scales as 1/h and the flux as h)
    horz, igw, model32, prog32 = timed["fe 64"][:4]
    final = model32.from_struct(structured_auto_run_loop(
        model32.to_struct(prog32), model32.struct_mesh, DT, PHYSICS_STEPS, nonlinear=True))
    t_end = PHYSICS_STEPS * DT
    exact = igw.exact_ssh(np.asarray(horz.cells.x, np.float64),
                          np.asarray(horz.cells.y, np.float64), t_end)

    def l2(ssh):
        return error_measures(ssh.double().numpy(), exact, horz, "cell").L_two

    _, _, model64, prog64 = igw_case(HEADLINE_N, LEVELS, np.float64)
    k64 = model64.from_struct(structured_auto_run_loop(
        model64.to_struct(prog64), model64.struct_mesh, DT, PHYSICS_STEPS, nonlinear=True))
    _, _, model1, prog1 = igw_case(HEADLINE_N, 1, np.float64, device="cpu")
    host = model1.from_struct(structured_run_loop(
        model1.to_struct(prog1), model1.struct_mesh, DT, PHYSICS_STEPS, nonlinear=True))
    l2_k, l2_k64, l2_host = l2(final.ssh), l2(k64.ssh), l2(host.ssh)
    ssh_gap = float(np.abs(k64.ssh.numpy() - host.ssh.numpy()).max())
    log(f"[12] nonlinear IGW ssh L2 error vs exact at t={t_end:.0f} s, {HEADLINE_N}x"
        f"{HEADLINE_N}x{LEVELS} FE: f32 kernel {l2_k:.6e} (linear, phase 4: "
        f"{linear['igw l2']:.6e}); f64 kernel {l2_k64:.6e}, f64 1-layer host run "
        f"{l2_host:.6e}; f64 kernel vs host max|ssh diff| {ssh_gap:.3e} m")
    if not (ssh_gap <= 1e-6 and abs(l2_k64 - l2_host) <= 1e-6):
        raise AssertionError(f"nonlinear f64 IGW off the host run: {ssh_gap}")
    if not (np.isfinite(l2_k) and l2_k < 2.0):
        raise AssertionError(f"nonlinear f32 IGW error out of range: {l2_k}")

    fe, fb, ch = out["fe 64"], out["fb 256"], out["channel fe 64"]
    return {
        "fe_step": {
            "nonlinear_ms": fe["ms"], "nonlinear_launches": fe["launches"],
            "nonlinear_plain_ms": fe["plain_ms"], "nonlinear_bound_ms": fe["bound_ms"],
            "nonlinear_bound_by": fe["bound_by"],
            "nonlinear_max_abs_err": max_abs_err[("IGW", HEADLINE_N, False)],
            "nonlinear_max_rel_err_f64": worst["fe_step FE periodic"],
            "nonlinear_over_linear": fe["over_linear"],
            "nonlinear_ms_256": out["fe 256"]["ms"],
            "nonlinear_launches_256": out["fe 256"]["launches"],
            "nonlinear_bound_ms_256": out["fe 256"]["bound_ms"],
            "nonlinear_over_linear_256": out["fe 256"]["over_linear"],
            "nonlinear_masked_ms": ch["ms"], "nonlinear_masked_launches": ch["launches"],
            "nonlinear_masked_plain_ms": ch["plain_ms"],
            "nonlinear_masked_bound_ms": ch["bound_ms"],
            "nonlinear_masked_max_abs_err": max_abs_err[("Kelvin", HEADLINE_N, False)],
            "nonlinear_masked_max_rel_err_f64": worst["fe_step FE masked"],
            "nonlinear_masked_over_linear": ch["over_linear"],
            "nonlinear_igw_ssh_l2_f32": l2_k, "nonlinear_igw_ssh_l2_f64": l2_k64,
            "nonlinear_plan": list(fe_step.nl_plan(HEADLINE_N // 2, HEADLINE_N, LEVELS, 4)),
            "nonlinear_plan_256": list(fe_step.nl_plan(LARGE_N // 2, LARGE_N, LEVELS, 4)),
        },
        "tiled_step": {
            "nonlinear_ms": fb["ms"], "nonlinear_launches": fb["launches"],
            "nonlinear_plain_ms": fb["plain_ms"], "nonlinear_bound_ms": fb["bound_ms"],
            "nonlinear_bound_by": fb["bound_by"],
            "nonlinear_max_abs_err": max_abs_err[("IGW", LARGE_N, True)],
            "nonlinear_max_rel_err_f64": worst["tiled_step FB periodic"],
            "nonlinear_over_linear": fb["over_linear"],
            "nonlinear_masked_ms": out["channel fb 64"]["ms"],
            "nonlinear_masked_launches": out["channel fb 64"]["launches"],
            "nonlinear_masked_plain_ms": out["channel fb 64"]["plain_ms"],
            "nonlinear_masked_bound_ms": out["channel fb 64"]["bound_ms"],
            "nonlinear_masked_max_abs_err": max_abs_err[("Kelvin", HEADLINE_N, True)],
            "nonlinear_masked_max_rel_err_f64": worst["tiled_step FB masked"],
            "nonlinear_plan": list(f32_plan(timed["fb 256"][2].struct_mesh, True)),
        },
    }


# Floating-point operations per (m, i, k) site of one nonlinear reverse
# step, counted from csrc/nl_adjoint.cuh with each intermediate once (not
# its recompute on the rings): stage A 70 (F 18, q_v of the site's 4 vertices
# 40, q_e 12), stage B 424 (T(F), T^T(gu) 96 each, T^T(gu q_e) 144, dq_e 24,
# dF 42, a and dt T^T(gu) 12, Sg 10), stage C 32, stage D 124 (du 72, dh 50,
# ds 2), the step's d(dt) 92.
NL_ADJOINT_FLOPS = 742


def nl_adjoint_bound(ny2: int, nx: int, k: int, n_terms: int, itemsize: int,
                     masked: bool = False, peaks: dict | None = None):
    """(bound seconds, "bytes" or "operations") of one launch of the
    nonlinear reverse: a primal state, a cotangent, the vertex constants (4
    planes, 20 on a channel) and the tables read, a cotangent and the d(dt)
    share written, over the byte rate; NL_ADJOINT_FLOPS per (m, i, k) site
    over the dtype's FMA rate. ``peaks`` as for ``step_bound``."""
    cells = 2 * ny2 * nx
    state = cells * (1 + 4 * k)
    consts = (20 if masked else 4) * ny2 * nx
    tables = 4 * (2 * (44 + 3 * n_terms) + 12 * 11) + 8 * (2 * n_terms + 12)
    nbytes = itemsize * (3 * state + consts) + 8 + tables
    ops = ny2 * nx * k * NL_ADJOINT_FLOPS
    peaks = CEILING if peaks is None else peaks
    rate = byte_rate(peaks, itemsize * state)
    t_bytes, t_ops = nbytes / rate, ops / peaks["flops"][itemsize]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nl_reverse_phase(gpu: str, log_text: str) -> dict:
    """Phase 13, the nonlinear reverse (csrc/nl_adjoint.cuh, the nonlinear
    arms of kernels 3 and 4): the kernel against the plain
    structured_nl_adjoint_step in f64 (16^2 and 64^2 random states with u of
    0.5 m/s, periodic and channel, 6 reverse steps, at the wrapper's own plan
    and the f32 main paths' tiles; 256^2 for 5), to 1e-12 of scale with
    bitwise reruns and the linear adjoint_step 100x off; f32 at the main
    paths' own plans on random states of their lattices (64^2 and 256^2
    periodic, the 64^2 channel), 100 reverse steps, each cotangent no farther
    from an f64 reverse than 3x the plain f32 reverse, the linear reverse
    100x past that; the dot-product identity through fused_rollout_diff; the
    gradients from StructuredModel.to_struct with exact launch counts and
    times (64^2 IGW and the 64^2 channel over 4000 steps through
    auto_rollout_diff, 256^2 over 100 through auto_rollout_diff and
    tiled_rollout_diff), a profiler breakdown of the 256^2 grad, and the
    kernel per launch by held_us beside its bound. Returns the kernels
    line's entry."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        auto_rollout_diff,
        diff_model,
        fused_rollout_diff,
        fused_run_loop,
        structured_nl_adjoint_step,
        structured_run_loop,
        tiled_rollout_diff,
    )
    from mpas_ocean_tpu_torch.structured.fused_model import (
        _scal,
        kernel_live,
        nl_adjoint_scal,
        nl_scal,
        nl_setup,
    )
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    for line in ptxas_report(log_text, ("nl_adjoint_kernel",)):
        log(f"[13] ptxas {line}")

    def stack_of(st, sm, dt, n):
        """n primal states of fe_step's nonlinear arm from st, filled by
        fe_nl_fill_stack (the rebuild of the gradient's reverse)."""
        dtype = st.layer_thickness.dtype
        stack = tuple(torch.empty((n, *x.shape), dtype=dtype, device=x.device)
                      for x in state_fields(st))
        for dst, x in zip(stack, state_fields(st)):
            dst[0].copy_(x)
        fe_step.fe_nl_fill_stack(stack, sm.resting_thickness_sum.to(dtype).contiguous(),
                                 *sm.host_stencil, nl_setup(sm, dtype), sm.vertex_cell_terms,
                                 sm.edge_vertex_terms, *_scal(sm, dt, dtype),
                                 *nl_scal(sm, dtype), n - 1, live=kernel_live(sm))
        return stack

    def kernel_args(sm, dt, dtype):
        """The nonlinear reverse wrapper's constants, made once."""
        return ((nl_setup(sm, dtype), *sm.host_stencil, *sm.host_adjoint_stencil,
                 sm.vertex_cell_terms, sm.edge_vertex_terms, *_scal(sm, dt, dtype),
                 *nl_scal(sm, dtype), *nl_adjoint_scal(sm, dt, dtype)), kernel_live(sm))

    def kernel(stack, g, sm, dt, n, tile=None, ks=None):
        dtype = stack[1].dtype
        ddt = torch.zeros(1, dtype=torch.float64, device=stack[1].device)
        args, live = kernel_args(sm, dt, dtype)
        out = adjoint_step.nl_adjoint_rollout(
            stack, tuple(x.to(dtype).contiguous() for x in state_fields(g)), *args, n, ddt,
            live=live, tile=tile, ks=ks)
        return StructState(*out), ddt

    def linear(stack, g, sm, dt, n):
        dtype = stack[1].dtype
        ddt = torch.zeros(1, dtype=torch.float64, device=stack[1].device)
        out = adjoint_step.adjoint_rollout(
            stack, tuple(x.to(dtype).contiguous() for x in state_fields(g)),
            sm.f_edge.to(dtype).contiguous(), *sm.host_adjoint_stencil, *_scal(sm, dt, dtype), n,
            ddt, live=kernel_live(sm))
        return StructState(*out), ddt

    def plain(stack, g, sm, dt, n, dtype=None):
        """The plain reverse step back through the stack's slots, in dtype
        (the slots and g cast to it, ``sm`` in it), by default the stack's."""
        dtype = stack[1].dtype if dtype is None else dtype
        ddt = torch.zeros((), dtype=torch.float64, device=stack[1].device)
        g = StructState(*(x.to(dtype) for x in state_fields(g)))
        for j in reversed(range(n)):
            g, dd = structured_nl_adjoint_step(StructState(*(x[j].to(dtype) for x in stack)),
                                               g, sm, dt)
            ddt = ddt + dd.double()
        return g, ddt

    def hold(what, errs, tol):
        log(f"[13] {what}: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= tol:
                raise AssertionError(f"{what}: {f} {r:.3e} > {tol}")

    # f64 against the plain reverse, at the wrapper's own plan and the f32
    # main paths' tiles ((8, 8) at 64^2 and 256^2) with f64's largest
    # slice; the linear reverse on the same inputs must miss
    f32_tiles = sorted({adjoint_step.nl_adjoint_plan(n // 2, n, LEVELS, 4)[:2]
                        for n in (HEADLINE_N, LARGE_N)})
    worst, n6 = {}, 6
    for n, levels in ((16, 4), (HEADLINE_N, LEVELS)):
        for channel in (False, True):
            model, prog = (random_channel if channel else random_case)(
                n, levels, seed=5, u_amp=0.5, layer=40.0 / levels)
            st, sm = model.to_struct(prog), model.struct_mesh
            g = random_cot(st, 21)
            stk = stack_of(st, sm, 10.0, n6)
            ref, ref_dt = plain(stk, g, sm, 10.0, n6)
            lin, lin_dt = linear(stk, g, sm, 10.0, n6)
            miss = max(r for _, r in cot_errors(lin, ref, lin_dt, ref_dt).values())
            name = "channel" if channel else "periodic"
            for tile in (None, *f32_tiles):
                tile = None if tile is None else (min(tile[0], sm.ny2), min(tile[1], sm.nx))
                (out, ddt), (again, ddt_again) = (kernel(stk, g, sm, 10.0, n6, tile)
                                                  for _ in range(2))
                what = (f"f64 {n}x{n}x{levels} {name} random, {n6} reverse steps, "
                        f"tile {tile or 'own plan'}")
                errs = cot_errors(out, ref, ddt, ref_dt)
                hold(what + " vs plain", errs, 1e-12)
                if not (torch.equal(ddt, ddt_again) and all(
                        torch.equal(x, y) for x, y in zip(state_fields(out),
                                                          state_fields(again)))):
                    raise AssertionError(f"{what}: rerun differs")
                worst[name] = max(worst.get(name, 0.0), max(r for _, r in errs.values()))
            if not miss >= 100 * 1e-12:
                raise AssertionError(f"f64 {n}^2 {name}: the linear reverse is only {miss:.3e} off")
            log(f"[13] f64 {n}x{n} {name}: the linear reverse misses by {miss:.3e} of scale "
                f"(control); reruns bitwise equal")
            del model, st, sm, stk

    # f64 256x256x100, 5 reverse steps, random state on the IGW lattice
    def random_on(case, n, dtype, seed=17):
        mesh_h, *_ = case(n, LEVELS, np.float64)
        model = case(n, LEVELS, dtype)[2]
        rng = np.random.default_rng(seed)
        h = 10.0 + 0.01 * rng.normal(size=(mesh_h.n_cells, LEVELS))
        u = 0.5 * rng.normal(size=(mesh_h.n_edges, LEVELS))
        fields = [x.astype(dtype) for x in (h.sum(1) - 1000.0, h, u)]
        return model, model.to_struct(mt.PrognosticVars(*(torch.from_numpy(x) for x in fields)))

    model, st = random_on(igw_case, LARGE_N, np.float64)
    sm = model.struct_mesh
    g = random_cot(st, 22)
    stk = stack_of(st, sm, DT, 5)
    ref, ref_dt = plain(stk, g, sm, DT, 5)
    for tile in (None, *f32_tiles):
        out, ddt = kernel(stk, g, sm, DT, 5, tile)
        errs = cot_errors(out, ref, ddt, ref_dt)
        hold(f"f64 {LARGE_N}x{LARGE_N}x{LEVELS} random, 5 reverse steps, tile "
             f"{tile or adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 8)[:2]} vs plain",
             errs, 1e-12)
        worst["periodic"] = max(worst["periodic"], max(r for _, r in errs.values()))
    del model, st, sm, stk, ref, out

    # f32 at the main paths' own plans, 100 reverse steps from a random
    # cotangent: each cotangent's distance from an f64 reverse from the same
    # f32 values at most 3x the plain f32 reverse's; the linear reverse at
    # least 100x that limit in the cotangent it misses most
    n_chk, max_abs_err = TILED_CHECK_STEPS, {}
    for name, case, n in (("periodic", igw_case, HEADLINE_N), ("periodic", igw_case, LARGE_N),
                          ("channel", kelvin_case, HEADLINE_N)):
        model, st = random_on(case, n, np.float32)
        sm, sm64 = model.struct_mesh, case(n, LEVELS, np.float64)[2].struct_mesh
        plan = adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4)
        g = random_cot(st, 23)
        stk = stack_of(st, sm, DT, n_chk)
        runs = {"kernel": kernel(stk, g, sm, DT, n_chk, plan[:2], plan[2]),
                "plain": plain(stk, g, sm, DT, n_chk),
                "linear": linear(stk, g, sm, DT, n_chk)}
        ref64, ref64_dt = plain(stk, g, sm64, DT, n_chk, torch.float64)
        gaps = {k: cot_errors(x, ref64, dd, ref64_dt) for k, (x, dd) in runs.items()}
        what = f"f32 {n}x{n}x{LEVELS} {name} random, {n_chk} reverse steps, plan {plan}"
        log(f"[13] {what}: distance from the f64 reverse " + "; ".join(
            f"{k} {format_errors(v)}" for k, v in gaps.items()))
        for f, (e, _) in gaps["plain"].items():
            if not gaps["kernel"][f][0] <= 3 * e:
                raise AssertionError(f"{what}: {f} {gaps['kernel'][f][0]:.3e} from f64, plain "
                                     f"{e:.3e}")
        ctrl = max(gaps["linear"][f][0] / (3 * e) for f, (e, _) in gaps["plain"].items())
        log(f"[13] {what}: the linear reverse is x{ctrl:.1f} the 3x limit (control)")
        if not ctrl >= 100:
            raise AssertionError(f"{what}: the linear reverse misses by only x{ctrl:.1f}")
        max_abs_err[name, n] = max(e for f, (e, _) in cot_errors(
            runs["kernel"][0], runs["plain"][0], runs["kernel"][1], runs["plain"][1]).items()
            if f != "d_dt")
        if name == "channel":
            if not all(bool(torch.isfinite(x).all()) for x in state_fields(runs["kernel"][0])):
                raise AssertionError(f"{what}: not finite")
        del model, st, sm, sm64, stk, runs, ref64
        torch.cuda.empty_cache()

    # the dot-product identity through fused_rollout_diff, 7 steps, f64
    for channel in (False, True):
        model, prog = (random_channel if channel else random_case)(16, 4, seed=5, u_amp=0.5,
                                                                   layer=10.0)
        st, sm = model.to_struct(prog), model.struct_mesh
        v, g = random_cot(st, 12), random_cot(st, 14)
        _, jv = torch.func.jvp(
            lambda *xs: tuple(state_fields(structured_run_loop(StructState(*xs), sm, 10.0, 7,
                                                               nonlinear=True))),
            tuple(state_fields(st)), tuple(state_fields(v)))
        lhs = sum(float((x * y).sum()) for x, y in zip(jv, state_fields(g)))
        leaves = [x.clone().requires_grad_(True) for x in state_fields(st)]
        out = fused_rollout_diff(StructState(*leaves), sm, 10.0, 7, plan=3, nonlinear=True)
        jtg = torch.autograd.grad(state_fields(out), leaves, state_fields(g))
        rhs = sum(float((x * y).sum()) for x, y in zip(state_fields(v), jtg))
        gap = abs(lhs - rhs) / abs(rhs)
        log(f"[13] f64 dot-product identity, {'channel' if channel else 'periodic'} 16^2, 7 "
            f"nonlinear steps: <Jv, g> {lhs:.17g}, <v, J^T g> {rhs:.17g}, relative gap "
            f"{gap:.3e}")
        if not gap <= 1e-12:
            raise AssertionError(f"nonlinear dot-product identity off by {gap:.3e}")

    # the gradients from StructuredModel.to_struct, f32, launches exact
    def grad_path(name, case, n, n_steps, route, **kw):
        horz, wave, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        fe_step.launches = adjoint_step.launches = adjoint_step.nl_launches = 0
        tiled_adjoint.launches = 0
        t0 = time.perf_counter()
        out, grads = grad_sum_ssh2(route, model.to_struct(prog), sm, n_steps, nonlinear=True,
                                   **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fe_step.launches, adjoint_step.nl_launches, adjoint_step.launches,
                  tiled_adjoint.launches)
        group = diff_model.adjoint_plan(n_steps, 1, math.inf)
        want = (2 * n_steps - -(-n_steps // group), n_steps, 0, 0)
        what = (f"grad of sum(ssh^2) through {route.__name__}(nonlinear=True), {name} {n}x{n}x"
                f"{LEVELS} f32, {n_steps} steps")
        log(f"[13] main path: {what}: {wall:.3f} s wall (to_struct .. grad) [{gpu}]; launches "
            f"fe_step {counts[0]}, nonlinear reverse {counts[1]}, adjoint_step {counts[2]}, "
            f"tiled_adjoint {counts[3]} (want {want})")
        if counts != want:
            raise AssertionError(f"{what}: launch counts {counts} != {want}")
        for label, x in zip(("d_ssh", "d_h", "d_u", "d_dt"), grads):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{what}: {label} is not finite")
        log(f"[13] |d_ssh|max {float(grads[0].abs().max()):.6e}, |d_h|max "
            f"{float(grads[1].abs().max()):.6e}, |d_u|max {float(grads[2].abs().max()):.6e}, "
            f"d_dt {float(grads[3]):.6e}")
        st = model.to_struct(prog)
        ref = fused_run_loop(st, sm, DT, n_steps, nonlinear=True)
        if not all(torch.equal(x, y) for x, y in zip(state_fields(out), state_fields(ref))):
            raise AssertionError(f"{what}: the forward differs from fused_run_loop's")
        times = cuda_times(lambda: grad_sum_ssh2(route, st, sm, n_steps, nonlinear=True, **kw),
                           REPS)
        log(f"[13] {what}: {spread(times)} per grad, "
            f"{spread([t / n_steps for t in times], 1e6, 'us')} per rollout step [{gpu}]")
        return st, sm, counts, times

    st_h, sm_h, counts_64, grad_64 = grad_path("IGW", igw_case, HEADLINE_N, GRAD_STEPS,
                                               auto_rollout_diff)
    st_c, sm_c, _, grad_c = grad_path("Kelvin channel", kelvin_case, HEADLINE_N, GRAD_STEPS,
                                      auto_rollout_diff)
    st_l, sm_l, _, grad_256 = grad_path("IGW", igw_case, LARGE_N, LARGE_ADJ_STEPS,
                                        auto_rollout_diff)
    _, _, _, grad_256_t = grad_path("IGW", igw_case, LARGE_N, LARGE_ADJ_STEPS,
                                    tiled_rollout_diff)
    by_kernel, window_us, busy_us = profile_by_kernel(
        lambda: grad_sum_ssh2(auto_rollout_diff, st_l, sm_l, LARGE_ADJ_STEPS, nonlinear=True),
        ("nl_step_kernel", "nl_adjoint_kernel", "ddt_reduce"))
    log(f"[13] profiler, one {LARGE_N}^2 nonlinear grad ({window_us:.0f} us by events): "
        + profile_line(by_kernel, window_us, busy_us, gpu))

    # the kernel per launch by held_us (40-step calls, its d(dt) sum
    # included) beside its bound; the plain reverse step's time
    def per_launch(st, sm, group=40):
        stk = stack_of(st, sm, DT, group)
        g_in = tuple(x.contiguous() for x in state_fields(random_cot(st, 15)))
        args, live = kernel_args(sm, DT, torch.float32)
        acc = torch.zeros(1, dtype=torch.float64, device=st.ssh.device)
        return [t / 1e6 for t in held_us(lambda: adjoint_step.nl_adjoint_rollout(
            stk, g_in, *args, group, acc, live=live), group, REPS)]

    launch_s = {key: per_launch(st, sm) for key, st, sm in (
        ("64", st_h, sm_h), ("channel 64", st_c, sm_c), ("256", st_l, sm_l))}
    g_l = random_cot(st_l, 16)
    plain_s = cuda_times(lambda: structured_nl_adjoint_step(st_l, g_l, sm_l, DT), REPS)
    bounds = {}
    for key, sm in (("64", sm_h), ("channel 64", sm_c), ("256", sm_l)):
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4, sm.edge_mask is not None)
        bounds[key] = (nl_adjoint_bound(*dims), nl_adjoint_bound(*dims, MEASURED)[0],
                       nl_adjoint_bound(*dims, DATASHEET)[0])
        (b, by), probe, sheet = bounds[key]
        ops_s = sm.ny2 * sm.nx * LEVELS * NL_ADJOINT_FLOPS / CEILING["flops"][4]
        masked = sm.edge_mask is not None
        plan = adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, masked=masked)
        lp = adjoint_step.nl_adjoint_launch_plan(sm.ny2, sm.nx, LEVELS, plan[:2], plan[2])
        med = statistics.median(launch_s[key])
        log(f"[13] nonlinear reverse {key}^2 f32, plan {plan} "
            f"({lp['clusters']} clusters, "
            f"{lp['blocks_per_sm']} block per SM, {lp['smem_bytes']} bytes): "
            f"{spread(launch_s[key], 1e6, 'us')} per launch; bound {b * 1e6:.3f} us ({by}; "
            f"bytes at the probes' rates {probe * 1e6:.3f}, at the data sheet's "
            f"{sheet * 1e6:.3f}; operations {ops_s * 1e6:.3f} us at "
            f"{CEILING['flops'][4] / 1e12:.2f} TFLOP/s, {NL_ADJOINT_FLOPS} per site): "
            f"{b / med:.4f} of the bound [{gpu}]")
    log(f"[13] plain nonlinear reverse step {LARGE_N}^2 f32: "
        f"{spread(plain_s, 1e3, 'ms')} [{gpu}]")
    (b256, by256), probe256, sheet256 = bounds["256"]
    return {
        "name": "nl_adjoint",
        "route": "cuda",
        "source": "mpas_ocean_tpu_torch/csrc/nl_adjoint.cuh",
        "replaces": "mpas_ocean_tpu/structured/pallas_model.py:1480",
        "also_replaces": "mpas_ocean_tpu/structured/pallas_model.py:1979 (q = 1)",
        "launches": counts_64[1],
        "max_abs_err": max_abs_err["periodic", LARGE_N],
        "ms": statistics.median(launch_s["256"]) * 1e3,
        "plain_ms": statistics.median(plain_s) * 1e3,
        "bound_ms": b256 * 1e3,
        "bound_by": by256,
        "library_ms": None,
        "bound_ms_probe": probe256 * 1e3,
        "bound_ms_datasheet": sheet256 * 1e3,
        "plan_256": list(adjoint_step.nl_adjoint_plan(LARGE_N // 2, LARGE_N, LEVELS, 4)),
        "plan_64": list(adjoint_step.nl_adjoint_plan(HEADLINE_N // 2, HEADLINE_N, LEVELS, 4)),
        "ms_64": statistics.median(launch_s["64"]) * 1e3,
        "bound_ms_64": bounds["64"][0][0] * 1e3,
        "masked_ms_64": statistics.median(launch_s["channel 64"]) * 1e3,
        "masked_bound_ms_64": bounds["channel 64"][0][0] * 1e3,
        "max_abs_err_64": max_abs_err["periodic", HEADLINE_N],
        "masked_max_abs_err_64": max_abs_err["channel", HEADLINE_N],
        "max_rel_err_f64": worst["periodic"],
        "masked_max_rel_err_f64": worst["channel"],
        "grad_s_64": statistics.median(grad_64),
        "grad_s_64_channel": statistics.median(grad_c),
        "grad_s_256": statistics.median(grad_256),
        "grad_s_256_tiled": statistics.median(grad_256_t),
    }


# ---- phase 14: momentum forcing ----------------------------------------------

# bench.py's "large-mesh FORCED tiled adjoint" forcing (bench.py:846-849)
BENCH_FORCING = dict(wind_stress_zonal=0.1, bottom_drag_linear=1e-4, rayleigh=1e-5)
# The f32 checks' forcing, on layers of 10 m: a random wind per cell of 1 Pa,
# Cd 2.5e-3 and lambda 1e-4, which move u well past the f32 bounds in 100
# steps (the control of each check must miss by 100x)
F32_FORCING = dict(bottom_drag_quadratic=2.5e-3, rayleigh=1e-4)
# How far the unforced arm must miss each f32 forward bound (the control):
# the forcing moves u itself, and h through the flux of the moved u, but in
# 100 steps moves ssh by only ~1e-4 of the 1000 m column at 64^2 (x10.5 its
# 1e-5 bound on an H100, PERF.md section 2), so ssh's control asks that the
# unforced arm fail its bound threefold, and u's and h's a hundredfold
F32_CONTROL = {"normal_velocity": 100, "layer_thickness": 100, "ssh": 3}
# The f32 reverse's scalar cotangents (one sum each over every edge-level
# and step): their distance from an f64 reverse is held to 3x the plain f32
# reverse's or to 3x SCALAR_FLOOR of their magnitude, whichever is larger.
# Two f32 sums of the same terms miss an f64 one by independent rounding
# noise of one size, and one of them is 3x the other's about one time in
# five (|X| > 3|Y| for two normal draws); the fields' distances are maxima
# over millions of values and do not scatter so. On an H100 (PERF.md section
# 2) the kernel's scalars were 0.4-5 f32 epsilons of their magnitude from
# f64, the plain reverse's 0.2-3.
SCALARS = ("d_dt", "d_r_lin", "d_cd", "d_lambda")
SCALAR_FLOOR = 1e-6
# Operations per cell-level the forced arm adds: forward, per edge the
# Rayleigh term and dt F (2); reverse, per edge a = dt gu, its Rayleigh
# term, gu F and the lambda share (5); three edges per cell
FORCED_FWD_OPS, FORCED_REV_OPS = 6, 15


def forced_step_bound(kind: str, ny2: int, nx: int, k: int, n_terms: int, itemsize: int,
                      peaks: dict | None = None):
    """(bound seconds, "bytes" or "operations") of one forced step of
    ``kind`` ("fe_step" for the forward kernels, "adjoint_step" for the
    reverse ones), step_bound's count plus the forced arm's: the winds and
    the packed levels read (6 values and 6 ints per site), the reverse's
    d(wind) read and written, and FORCED_FWD_OPS or FORCED_REV_OPS per
    cell-level."""
    cells = 2 * ny2 * nx
    state = cells * (1 + 4 * k)
    table = 4 * (44 + 3 * n_terms) + itemsize * n_terms
    forcing = ny2 * nx * (6 * itemsize + 24) + 24
    if kind == "fe_step":
        nbytes = itemsize * (2 * state + 4 * cells) + table + forcing
        ops = cells * k * (36 + 1.5 * n_terms + FORCED_FWD_OPS)
    else:
        nbytes = (itemsize * (3 * state + 3 * cells) + 8 + table + forcing
                  + 2 * 6 * itemsize * ny2 * nx + 24)
        ops = cells * k * (81 + n_terms + FORCED_REV_OPS)
    peaks = CEILING if peaks is None else peaks
    rate = byte_rate(peaks, itemsize * state)
    t_bytes, t_ops = nbytes / rate, ops / peaks["flops"][itemsize]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lattice_forcing(model, seed=11, wind=1e-4, coefs=(1e-3, 2.5e-3, 1e-4)):
    """A random lattice Forcing on the model's device, in its dtype: winds of
    std ``wind`` m^2/s^2, (r_lin, Cd, lambda) = ``coefs`` and random top and
    bottom levels per edge in -1 .. K - 1 (none on a channel's closed
    edges)."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.models.forcing import Forcing

    sm = model.struct_mesh
    rng = np.random.default_rng(seed)
    shape, k = tuple(sm.f_edge.shape), sm.n_vert_levels
    w = wind * rng.normal(size=shape)
    top, bot = (rng.integers(-1, k, size=shape) for _ in range(2))
    if sm.edge_mask is not None:
        closed = sm.edge_mask.cpu().numpy() == 0
        w[closed], top[closed], bot[closed] = 0.0, -1, -1
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64)).to(  # noqa: E731
        dtype=sm.f_edge.dtype, device=sm.f_edge.device)
    onehot = lambda i: t(np.arange(k) == i[..., None])  # noqa: E731
    return Forcing(t(w), onehot(top), onehot(bot), *(t(c) for c in coefs))


def forcing_phase(gpu: str, log_text: str) -> list:
    """Phase 14, momentum forcing (the forced arms of kernels 1-4): the
    forced instantiations' ptxas lines; f64, each forced arm against its
    plain version on 16^2 and 64^2 random states, periodic and channel, with
    random winds, all three coefficients and random top and bottom levels
    (-1 among them): fe_step FE, tiled_step FE and FB (q = 1, 2),
    adjoint_step and tiled_adjoint (q = 1, 2) with d(wind) and d(r_lin, Cd,
    lambda), to 1e-12 of scale, reruns bitwise, the unforced arm 100x off;
    the dot-product identity with directions in the wind and the
    coefficients; the Rayleigh recurrence and the wind-drag steady state
    (tests/test_forcing.py:93-153) on the card; f32 after 100 steps on the
    main paths' lattices with controls; the forced main paths and gradients
    from to_struct beside the unforced ones, timed, with exact launch
    counts, bench.py's forced 256^2 100-step gradient among them; a
    profiler breakdown; the forced reverse arms per launch. Returns the
    forced arms' entries of the kernels line."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint, tiled_step
    from mpas_ocean_tpu_torch.models.forcing import Forcing, make_forcing
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        auto_rollout_diff,
        diff_model,
        fused_model,
        fused_rollout_diff,
        fused_run_loop,
        plain_tiled_adjoint_superstep,
        structured_adjoint_step,
        structured_auto_run_loop,
        structured_run_loop,
        tiled_rollout_diff,
        tiled_run_loop,
    )
    from mpas_ocean_tpu_torch.structured.adjoint import ForcingCot
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    # the forced instantiations: kForced true, kTracers and kStrat false, the
    # last three template arguments of every kernel
    for line in ptxas_report(log_text, ("adjoint_step_kernel", "tiled_adjoint_kernel",
                                        "fe_step_kernel", "tiled_step_kernel"),
                             "Lb1ELb0ELb0EEEv"):
        log(f"[14] ptxas {line}")
    counters = (fe_step, tiled_step, adjoint_step, tiled_adjoint)

    def zero_counts():
        for m in counters:
            m.launches = m.forced_launches = 0

    def counts():
        return {m.__name__.rsplit(".", 1)[-1]: (m.launches, m.forced_launches)
                for m in counters}

    def stack_of(st, sm, dt, n, forcing, q=1):
        """n superstep starts of q forced steps from st (slot j: j q steps),
        by fe_step's forced arm."""
        dtype = st.layer_thickness.dtype
        stack = tuple(torch.empty((n, *x.shape), dtype=dtype, device=x.device)
                      for x in state_fields(st))
        for dst, x in zip(stack, state_fields(st)):
            dst[0].copy_(x)
        kf = fused_model.kernel_forcing(forcing, sm, dtype, st.ssh.device)
        scal, live = fused_model._scal(sm, dt, dtype), fused_model.kernel_live(sm)
        consts = (sm.f_edge.to(dtype).contiguous(), sm.resting_thickness_sum.to(dtype).contiguous(),
                  *sm.host_stencil)
        if q == 1:
            fe_step.fe_fill_stack(stack, *consts, *scal, n - 1, live=live, forcing=kf)
        else:
            for j in range(n - 1):
                fe_step.fe_rollout_into(tuple(x[j] for x in stack), tuple(x[j + 1] for x in stack),
                                        *consts, *scal, q, live=live, forcing=kf)
        return stack

    def reverse_call(stack, g, sm, dt, n, forcing, plan=None):
        """A call of the forced reverse arm (adjoint_step, or tiled_adjoint
        at plan = (rt, ct, q)), or of the unforced one for forcing None, with
        its operands and accumulators made here: (the call, its result as
        (cotangent, d(dt), d(wind) (3, 2, ny2, nx), d(r_lin, Cd, lambda)))."""
        dtype, dev = stack[1].dtype, stack[1].device
        ddt = torch.zeros(1, dtype=torch.float64, device=dev)
        kf = fused_model.kernel_forcing(forcing, sm, dtype, dev)
        dforc = ForcingCot(torch.zeros((6, sm.ny2, sm.nx), dtype=dtype, device=dev),
                           torch.zeros(3, dtype=torch.float64, device=dev))
        g = tuple(x.to(dtype).contiguous() for x in state_fields(g))
        out = tuple(torch.empty_like(x) for x in g)
        scal, live = fused_model._scal(sm, dt, dtype), fused_model.kernel_live(sm)
        f_edge = sm.f_edge.to(dtype).contiguous()
        rts = sm.resting_thickness_sum.to(dtype).contiguous()
        df = None if forcing is None else dforc
        if plan is None:
            call = lambda: adjoint_step.adjoint_rollout(  # noqa: E731
                stack, g, f_edge, *sm.host_adjoint_stencil, *scal, n, ddt, out, live=live,
                forcing=kf, dforc=df)
        else:
            call = lambda: tiled_adjoint.tiled_adjoint_rollout(  # noqa: E731
                stack, g, f_edge, rts, *sm.host_stencil, *sm.host_adjoint_stencil, *scal, n, ddt,
                out, row_tile=plan[0], col_tile=plan[1], q=plan[2],
                halo=reverse_halo(sm.coriolis_terms), live=live, forcing=kf, dforc=df)
        shape = (3, 2, sm.ny2, sm.nx)
        return call, (StructState(*out), ddt[0], dforc.wind.reshape(shape), dforc.coefs)

    def kernel_reverse(stack, g, sm, dt, n, forcing, plan=None):
        """One call of ``reverse_call``: its result."""
        call, result = reverse_call(stack, g, sm, dt, n, forcing, plan)
        call()
        return result

    def plain_reverse(stack, g, sm, dt, n, forcing, plan=None, dtype=None):
        """The plain forced reverse (structured_adjoint_step with forcing,
        or plain_tiled_adjoint_superstep at plan = (rt, ct, q)) back through
        the stack in ``dtype`` (the stack and g cast to it; sm and forcing in
        it), by default the stack's."""
        dtype = stack[1].dtype if dtype is None else dtype
        dev = stack[1].device
        g = StructState(*(x.to(dtype) for x in state_fields(g)))
        ddt = torch.zeros((), dtype=torch.float64, device=dev)
        dw = torch.zeros(forcing.wind_edge.shape, dtype=dtype, device=dev)
        dc = torch.zeros(3, dtype=torch.float64, device=dev)
        for j in reversed(range(n)):
            s = StructState(*(x[j].to(dtype) for x in stack))
            if plan is None:
                g, dd, d = structured_adjoint_step(s, g, sm, dt, forcing)
            else:
                g, dd, d = plain_tiled_adjoint_superstep(s, g, sm, dt, *plan, forcing=forcing)
            ddt, dw, dc = ddt + dd.double(), dw + d.wind, dc + d.coefs.double()
        return g, ddt, dw, dc

    def rev_errors(a, b) -> dict:
        """(max |a - b|, over max |b|) of each part of two reverses."""
        out = {}
        parts = [*zip(FIELDS, state_fields(a[0]), state_fields(b[0])), ("d_dt", a[1], b[1]),
                 ("d_wind", a[2], b[2])]
        parts += [(n, a[3][i], b[3][i]) for i, n in enumerate(("d_r_lin", "d_cd", "d_lambda"))]
        for name, x, y in parts:
            x, y = x.double(), y.double()
            err = float((x - y).abs().max())
            out[name] = (err, err / max(float(y.abs().max()), 1e-300))
        return out

    def hold(what, errs, tol):
        log(f"[14] {what}: max|diff| (/scale) = {format_errors(errs)}")
        for f, (_, r) in errs.items():
            if not r <= tol:
                raise AssertionError(f"{what}: {f} {r:.3e} > {tol}")

    def control(what, errs, limit):
        miss = max(r for _, r in errs.values())
        log(f"[14] {what}: the unforced arm misses by {miss:.3e} of scale (control, limit "
            f"{limit:.0e})")
        if not miss >= 100 * limit:
            raise AssertionError(f"{what}: the unforced arm misses by only {miss:.3e}")

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # f64 kernel against plain, 16^2 and 64^2 random, periodic and channel
    worst = {}
    for n, levels in ((16, 4), (HEADLINE_N, 6)):
        for channel in (False, True):
            model, prog = (random_channel if channel else random_case)(n, levels, seed=5)
            st, sm = model.to_struct(prog), model.struct_mesh
            forcing = lattice_forcing(model)
            name = f"f64 {n}x{n}x{levels} {'channel' if channel else 'periodic'}"
            refs = {fb: structured_run_loop(st, sm, 10.0, 20, fb=fb, forcing=forcing)
                    for fb in (False, True)}
            runs = [("fe_step FE", False, lambda f: fused_run_loop(st, sm, 10.0, 20, forcing=f))]
            runs += [(f"tiled_step {'FB' if fb else 'FE'} q={q}", fb,
                      lambda f, fb=fb, q=q: tiled_run_loop(st, sm, 10.0, 20, row_tile=4,
                                                           col_tile=8, q=q, fb=fb, forcing=f))
                     for fb in (False, True) for q in (1, 2)]
            for label, fb, run in runs:
                want = refs[fb]
                out, again = run(forcing), run(forcing)
                errs = field_errors(out, want, sm.resting_thickness_sum)
                hold(f"{name}, 20 forced steps, {label} vs plain", errs, 1e-12)
                if not same(state_fields(out), state_fields(again)):
                    raise AssertionError(f"{name} {label}: rerun differs")
                control(f"{name} {label}", field_errors(run(None), want,
                                                        sm.resting_thickness_sum), 1e-12)
                worst[label.split()[0]] = max(worst.get(label.split()[0], 0.0),
                                              max(r for _, r in errs.values()))
            g = random_cot(st, 21)
            for label, plan, q in (("adjoint_step", None, 1), ("tiled_adjoint q=1", (4, 8, 1), 1),
                                   ("tiled_adjoint q=2", (4, 8, 2), 2)):
                nn = 6 // q
                stk = stack_of(st, sm, 10.0, nn, forcing, q)
                ref = plain_reverse(stk, g, sm, 10.0, nn, forcing, plan)
                out = kernel_reverse(stk, g, sm, 10.0, nn, forcing, plan)
                again = kernel_reverse(stk, g, sm, 10.0, nn, forcing, plan)
                errs = rev_errors(out, ref)
                hold(f"{name}, 6 reverse steps, {label} vs plain", errs, 1e-12)
                if not (same(state_fields(out[0]), state_fields(again[0]))
                        and same(out[1:], again[1:])):
                    raise AssertionError(f"{name} {label}: rerun differs")
                control(f"{name} {label}", rev_errors(kernel_reverse(stk, g, sm, 10.0, nn, None,
                                                                     plan), ref), 1e-12)
                key = label.split()[0]
                worst[key] = max(worst.get(key, 0.0), max(r for _, r in errs.values()))
            del model, st, sm
    log("[14] reruns bitwise equal; worst f64 relative errors: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))

    # the dot-product identity, 7 forced steps, directions in the state, the
    # wind and the three coefficients, f64
    for channel in (False, True):
        model, prog = (random_channel if channel else random_case)(16, 4, seed=5)
        st, sm = model.to_struct(prog), model.struct_mesh
        forcing = lattice_forcing(model)
        parts = (forcing.wind_edge, forcing.drag_linear, forcing.drag_quadratic,
                 forcing.rayleigh)
        rng = np.random.default_rng(31)
        v_parts = tuple(torch.from_numpy(np.asarray(rng.normal(size=tuple(x.shape)))).to(x)
                        * x.abs().max() for x in parts)
        v, g = random_cot(st, 12), random_cot(st, 14)

        def run(*xs):
            f = Forcing(xs[3], forcing.top_mask, forcing.bottom_mask, *xs[4:])
            return tuple(state_fields(structured_run_loop(StructState(*xs[:3]), sm, 10.0, 7,
                                                          forcing=f)))

        _, jv = torch.func.jvp(run, (*state_fields(st), *parts), (*state_fields(v), *v_parts))
        lhs = sum(float((x * y).sum()) for x, y in zip(jv, state_fields(g)))
        leaves = [x.clone().requires_grad_(True) for x in (*state_fields(st), *parts)]
        f = Forcing(leaves[3], forcing.top_mask, forcing.bottom_mask, *leaves[4:])
        out = fused_rollout_diff(StructState(*leaves[:3]), sm, 10.0, 7, plan=3, forcing=f)
        jtg = torch.autograd.grad(state_fields(out), leaves, state_fields(g))
        rhs = sum(float((x * y).sum()) for x, y in zip((*state_fields(v), *v_parts), jtg))
        gap = abs(lhs - rhs) / abs(rhs)
        log(f"[14] f64 dot-product identity, {'channel' if channel else 'periodic'} 16^2, 7 "
            f"forced steps, directions in the state, the wind and r_lin, Cd, lambda: <Jv, g> "
            f"{lhs:.17g}, <v, J^T g> {rhs:.17g}, relative gap {gap:.3e}")
        if not gap <= 1e-12:
            raise AssertionError(f"forced dot-product identity off by {gap:.3e}")

    # physics on the card, f64 (tests/test_forcing.py:93-153)
    def flat_case(u0=None):
        horz = mt.planar_hex_mesh(8, 8, 5000.0, f0=0.0)
        vert = mt.make_vertical_mesh(horz, 1, resting_thickness=np.full((horz.n_cells, 1), 50.0))
        mesh = mt.Mesh(horz=horz, vert=vert)
        model = mt.StructuredModel(mesh, 8, 8)
        u = np.zeros(horz.n_edges) if u0 is None else u0(horz)
        prog = mt.PrognosticVars(torch.zeros(horz.n_cells, dtype=torch.float64),
                                 torch.full((horz.n_cells, 1), 50.0, dtype=torch.float64),
                                 torch.from_numpy(u[:, None].copy()))
        return horz, mesh, model, prog

    r, n_r = 1e-4, 50
    horz, mesh, model, prog = flat_case(lambda hz: 0.3 * np.cos(np.asarray(hz.edges.angle_edge))
                                        + 0.1 * np.sin(np.asarray(hz.edges.angle_edge)))
    u0 = prog.normal_velocity[:, 0].numpy()
    out = structured_auto_run_loop(model.to_struct(prog), model.struct_mesh, 100.0, n_r,
                                   forcing=model.to_struct_forcing(make_forcing(mesh, rayleigh=r)))
    got = model.from_struct(out).normal_velocity[:, 0].numpy()
    want = u0 * (1.0 - r * 100.0) ** n_r
    gap = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))
    log(f"[14] Rayleigh recurrence, 8^2 f = 0, {n_r} FE steps through fe_step's forced arm: "
        f"max relative error {gap:.3e} against (1 - r dt)^n u0")
    if not np.allclose(got, want, rtol=1e-12, atol=1e-15):
        raise AssertionError(f"Rayleigh recurrence off by {gap:.3e}")
    tau, cd, n_wd = 0.1, 2e-3, 16000
    horz, mesh, model, prog = flat_case()
    f_u = make_forcing(mesh, wind_stress_zonal=tau, bottom_drag_quadratic=cd)
    t0 = time.perf_counter()
    out = model.from_struct(structured_auto_run_loop(
        model.to_struct(prog), model.struct_mesh, 200.0, n_wd,
        forcing=model.to_struct_forcing(f_u)))
    wind_n = f_u.wind_edge.numpy()
    u_star = np.sign(wind_n) * np.sqrt(np.abs(wind_n) / cd)
    u_gap = float(np.max(np.abs(out.normal_velocity[:, 0].numpy() - u_star)
                         / np.maximum(np.abs(u_star), 1e-9)))
    h_gap = float((out.layer_thickness - 50.0).abs().max())
    log(f"[14] wind-drag steady state, 8^2 K = 1 f = 0, {n_wd} FE steps of 200 s through "
        f"fe_step's forced arm ({time.perf_counter() - t0:.2f} s): u against sign(w) "
        f"sqrt(|w| / Cd) max relative error {u_gap:.3e}, h flat to {h_gap:.3e} m")
    if not (np.allclose(out.normal_velocity[:, 0].numpy(), u_star, rtol=1e-6, atol=1e-9)
            and h_gap <= 1e-8):
        raise AssertionError("wind-drag steady state missed")

    # f32 after 100 steps on the main paths' lattices (layers of 10 m), the
    # forcing moving u well past the bounds; f64 runs from the same values
    def f32_forcing(mesh, model, seed):
        rng = np.random.default_rng(seed)
        n_c = mesh.horz.n_cells
        f = make_forcing(mesh, wind_stress_zonal=rng.normal(size=n_c),
                         wind_stress_meridional=rng.normal(size=n_c), **F32_FORCING)
        return model.to_struct_forcing(f)

    max_abs_err, fwd_ok = {}, {}
    for name, case, n in (("periodic", igw_case, HEADLINE_N), ("periodic", igw_case, LARGE_N),
                          ("channel", kelvin_case, HEADLINE_N)):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        _, _, model64, _ = case(n, LEVELS, np.float64)
        mesh = mt.Mesh(horz=horz, vert=mt.make_vertical_mesh(
            horz, LEVELS, resting_thickness=np.full((horz.n_cells, LEVELS), 10.0)))
        forcing, forcing64 = f32_forcing(mesh, model, 41), f32_forcing(mesh, model64, 41)
        forcing = Forcing(*(x.float() for x in (
            forcing.wind_edge, forcing.top_mask, forcing.bottom_mask, forcing.drag_linear,
            forcing.drag_quadratic, forcing.rayleigh)))
        st, sm, sm64 = model.to_struct(prog), model.struct_mesh, model64.struct_mesh
        st64 = StructState(*(x.double() for x in state_fields(st)))
        n_chk = TILED_CHECK_STEPS
        for fb in (False, True):
            arm = "tiled_step FB" if fb else "fe_step FE"
            kern = lambda f: structured_auto_run_loop(st, sm, DT, n_chk, fb=fb, forcing=f)  # noqa
            out, unforced = kern(forcing), kern(None)
            ref = structured_run_loop(st, sm, DT, n_chk, fb=fb, forcing=forcing)
            ref64 = structured_run_loop(st64, sm64, DT, n_chk, fb=fb, forcing=forcing64)
            what = f"f32 {n}x{n}x{LEVELS} {name}, {n_chk} forced steps, {arm}"
            errs = field_errors(out, ref, sm.resting_thickness_sum)
            miss = field_errors(unforced, ref, sm.resting_thickness_sum)
            log(f"[14] {what} vs plain f32: {format_errors(errs)}; the unforced arm "
                f"{format_errors(miss)}")
            limits = {"ssh": 1e-5, "layer_thickness": 1e-5,
                      "normal_velocity": 3e-4 if n == HEADLINE_N else 5e-3}
            gap = lambda x: float((x.normal_velocity.double()  # noqa: E731
                                   - ref64.normal_velocity).abs().max())
            for f in ("ssh", "layer_thickness") + (("normal_velocity",) if name == "periodic"
                                                   else ()):
                if not errs[f][1] <= limits[f]:
                    raise AssertionError(f"{what}: {f} {errs[f][1]:.3e} > {limits[f]}")
            if name == "channel":
                log(f"[14] {what}: u's distance from the f64 run: kernel {gap(out):.3e}, plain "
                    f"f32 {gap(ref):.3e}, unforced {gap(unforced):.3e}")
                if not gap(out) <= U_GAP_FACTOR * gap(ref):
                    raise AssertionError(f"{what}: u {gap(out):.3e} from f64, plain {gap(ref):.3e}")
                ratios = {"normal_velocity": gap(unforced) / (U_GAP_FACTOR * gap(ref))}
                check_walls(out, sm, what)
            else:
                ratios = {"normal_velocity": miss["normal_velocity"][1] / limits["normal_velocity"]}
            ratios.update({f: miss[f][1] / limits[f] for f in ("ssh", "layer_thickness")})
            log(f"[14] {what}: the unforced arm is " + ", ".join(
                f"{f} x{v:.1f}" for f, v in ratios.items()) + " the limit (control: "
                f"x{F32_CONTROL['normal_velocity']} for u and h, x{F32_CONTROL['ssh']} for ssh)")
            for f, v in ratios.items():
                if not v >= F32_CONTROL[f]:
                    raise AssertionError(f"{what}: the unforced arm misses {f} by only x{v:.1f}")
            max_abs_err[arm, name, n] = max(e for e, _ in errs.values())
        # the reverse, 100 steps from a random cotangent
        g = random_cot(st, 23)
        stk = stack_of(st, sm, DT, n_chk, forcing)
        ref64 = plain_reverse(stk, g, sm64, DT, n_chk, forcing64, dtype=torch.float64)
        arms = [("adjoint_step", None)]
        if n == LARGE_N:
            arms.append(("tiled_adjoint", (4, 8, 1)))
        for arm, plan in arms:
            runs = {"kernel": kernel_reverse(stk, g, sm, DT, n_chk, forcing, plan),
                    "plain": plain_reverse(stk, g, sm, DT, n_chk, forcing, plan),
                    "unforced": kernel_reverse(stk, g, sm, DT, n_chk, None, plan)}
            gaps = {k: rev_errors(x, ref64) for k, x in runs.items()}
            what = f"f32 {n}x{n}x{LEVELS} {name}, {n_chk} forced reverse steps, {arm}"
            log(f"[14] {what}: distance from the f64 reverse " + "; ".join(
                f"{k} {format_errors(v)}" for k, v in gaps.items()))
            # the fields by the plain f32 reverse's distance; the scalar sums
            # (SCALAR_FLOOR) by it or their f32 floor, whichever is larger
            limit = {f: 3 * (max(e, SCALAR_FLOOR * e / max(r, 1e-300)) if f in SCALARS else e)
                     for f, (e, r) in gaps["plain"].items()}
            log(f"[14] {what}: kernel over the 3x limit " + ", ".join(
                f"{f} {gaps['kernel'][f][0] / v:.3f}" for f, v in limit.items()))
            for f, v in limit.items():
                if not gaps["kernel"][f][0] <= v:
                    raise AssertionError(f"{what}: {f} {gaps['kernel'][f][0]:.3e} from f64, "
                                         f"limit {v:.3e}")
            ratios = {f: gaps["unforced"][f][0] / v for f, v in limit.items()}
            log(f"[14] {what}: the unforced arm is " + ", ".join(
                f"{f} x{v:.3g}" for f, v in ratios.items()) + " the 3x limit (control)")
            if not min(ratios[f] for f in ("normal_velocity", "d_wind", "d_r_lin", "d_cd",
                                           "d_lambda")) >= 100:
                raise AssertionError(f"{what}: the unforced arm misses by too little")
            max_abs_err[arm, name, n] = max(e for f, (e, _) in rev_errors(
                runs["kernel"], runs["plain"]).items() if f != "d_dt")
        del stk, runs, ref64
        torch.cuda.empty_cache()

    # timed: forced beside unforced in this call, median of REPS
    times = {}

    def both(key, run, n_steps):
        times[key] = {arm: timed_rollout(lambda n, f=f: run(n, f), n_steps, REPS)[1]
                      for arm, f in (("unforced", False), ("forced", True))}
        u_med, f_med = (statistics.median(times[key][a]) for a in ("unforced", "forced"))
        log(f"[14] {key}: forced {spread(times[key]['forced'], 1e6, 'us')} per step, unforced "
            f"{spread(times[key]['unforced'], 1e6, 'us')}: forced/unforced x{f_med / u_med:.4f} "
            f"[{gpu}]")

    forced_of = {}
    for label, case, n in (("64", igw_case, HEADLINE_N), ("256", igw_case, LARGE_N),
                           ("channel 64", kelvin_case, HEADLINE_N)):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        forced_of[label] = model.to_struct_forcing(make_forcing(
            mt.Mesh(horz=horz, vert=mt.make_vertical_mesh(
                horz, LEVELS, resting_thickness=np.full((horz.n_cells, LEVELS), 10.0),
                dtype=np.float32)), dtype=np.float32, **BENCH_FORCING))
    fwd = {}
    for label, case, n, fb, n_steps in (("64", igw_case, HEADLINE_N, False, HEADLINE_STEPS),
                                        ("256", igw_case, LARGE_N, False, LARGE_MAIN_STEPS),
                                        ("256", igw_case, LARGE_N, True, LARGE_MAIN_STEPS),
                                        ("channel 64", kelvin_case, HEADLINE_N, False,
                                         HEADLINE_STEPS)):
        _, _, model, prog = case(n, LEVELS, np.float32)
        sm, forcing = model.struct_mesh, forced_of[label]
        key = f"{'FB' if fb else 'FE'} {label}"
        zero_counts()
        final = model.from_struct(structured_auto_run_loop(
            model.to_struct(prog), sm, DT, n_steps, fb=fb, forcing=forcing))
        c = counts()
        arm = "tiled_step" if fb else "fe_step"
        log(f"[14] main path: forced {key}^2x{LEVELS} f32 from to_struct, {n_steps} steps: "
            f"launches {c} (want {arm} {n_steps} forced)")
        if c[arm] != (n_steps, n_steps) or sum(a for a, _ in c.values()) != n_steps:
            raise AssertionError(f"forced {key}: launch counts {c}")
        if not all(bool(torch.isfinite(x).all()) for x in state_fields(final)):
            raise AssertionError(f"forced {key}: not finite")
        st = model.to_struct(prog)
        both(f"{arm} {key}", lambda k, f, st=st, sm=sm, fb=fb, forcing=forcing:
             structured_auto_run_loop(st, sm, DT, k, fb=fb,
                                      forcing=forcing if f else None), n_steps)
        fwd[key] = c[arm][1]
    # the plain forced step's time, 64^2
    _, _, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    _, plain_fe = timed_rollout(lambda k: structured_run_loop(st, sm, DT, k,
                                                              forcing=forced_of["64"]),
                                TILED_CHECK_STEPS, REPS)
    _, _, model, prog = igw_case(LARGE_N, LEVELS, np.float32)
    st_l, sm_l = model.to_struct(prog), model.struct_mesh
    _, plain_fb = timed_rollout(lambda k: structured_run_loop(st_l, sm_l, DT, k, fb=True,
                                                              forcing=forced_of["256"]),
                                10, REPS)

    # the forced gradients from to_struct, launch counts exact and equal to
    # the unforced ones
    grads = {}

    def grad_path(label, case, n, n_steps, route):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        sm, forcing = model.struct_mesh, forced_of[label]
        parts = [x.clone().requires_grad_(True) for x in (
            forcing.wind_edge, forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh)]
        f = Forcing(parts[0], forcing.top_mask, forcing.bottom_mask, *parts[1:])
        zero_counts()
        t0 = time.perf_counter()
        st = model.to_struct(prog)
        leaves = [x.clone().requires_grad_(True) for x in state_fields(st)]
        out = route(StructState(*leaves), sm, DT, n_steps, forcing=f)
        g = torch.autograd.grad((out.ssh ** 2).sum(), leaves + parts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        tiled = route is tiled_rollout_diff
        group = diff_model.adjoint_plan(n_steps, 1, math.inf) if not tiled else 10
        n_fwd = 2 * n_steps - -(-n_steps // group)
        rev = "tiled_adjoint" if tiled else "adjoint_step"
        what = (f"forced grad of sum(ssh^2) through {route.__name__}, {label}^2x{LEVELS} f32, "
                f"{n_steps} steps")
        log(f"[14] main path: {what}: {wall:.3f} s wall (to_struct .. grad) [{gpu}]; launches "
            f"{c} (want fe_step {n_fwd} and {rev} {n_steps}, all forced)")
        if c["fe_step"] != (n_fwd, n_fwd) or c[rev] != (n_steps, n_steps) or c["tiled_step"] != (
                0, 0) or c["tiled_adjoint" if not tiled else "adjoint_step"] != (0, 0):
            raise AssertionError(f"{what}: launch counts {c}")
        for name, x in zip(("d_ssh", "d_h", "d_u", "d_wind", "d_r_lin", "d_cd", "d_lambda"), g):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{what}: {name} is not finite")
        log(f"[14] |d_h|max {float(g[1].abs().max()):.6e}, |d_u|max {float(g[2].abs().max()):.6e}, "
            f"|d_wind|max {float(g[3].abs().max()):.6e}, d_r_lin {float(g[4]):.6e}, d_cd "
            f"{float(g[5]):.6e}, d_lambda {float(g[6]):.6e}")
        ref = fused_run_loop(st, sm, DT, n_steps, forcing=forcing)
        if not same(state_fields(out), state_fields(ref)):
            raise AssertionError(f"{what}: the forward differs from fused_run_loop's")

        def one(forced):
            leaves = [x.clone().requires_grad_(True) for x in state_fields(st)]
            ps = [x.clone().requires_grad_(True) for x in parts] if forced else []
            fo = Forcing(ps[0], forcing.top_mask, forcing.bottom_mask, *ps[1:]) if forced else None
            o = route(StructState(*leaves), sm, DT, n_steps, forcing=fo)
            return torch.autograd.grad((o.ssh ** 2).sum(), leaves + ps)

        grads[what] = {"unforced": cuda_times(lambda: one(False), REPS),
                       "forced": cuda_times(lambda: one(True), REPS)}
        u_med, f_med = (statistics.median(grads[what][a]) for a in ("unforced", "forced"))
        log(f"[14] {what}: forced {spread(grads[what]['forced'])}, unforced "
            f"{spread(grads[what]['unforced'])} per grad: forced/unforced x{f_med / u_med:.4f} "
            f"[{gpu}]")
        return st, sm, c, f_med

    _, _, c64, g64 = grad_path("64", igw_case, HEADLINE_N, GRAD_STEPS, auto_rollout_diff)
    st_c, sm_c, _, g64c = grad_path("channel 64", kelvin_case, HEADLINE_N, GRAD_STEPS,
                                    auto_rollout_diff)
    st_l, sm_l, c256, g256 = grad_path("256", igw_case, LARGE_N, LARGE_ADJ_STEPS,
                                       tiled_rollout_diff)
    _, _, _, g256f = grad_path("256", igw_case, LARGE_N, LARGE_ADJ_STEPS, fused_rollout_diff)

    def traced():
        leaves = [x.clone().requires_grad_(True) for x in state_fields(st_l)]
        o = tiled_rollout_diff(StructState(*leaves), sm_l, DT, LARGE_ADJ_STEPS,
                               forcing=forced_of["256"])
        return torch.autograd.grad((o.ssh ** 2).sum(), leaves)

    by_kernel, window_us, busy_us = profile_by_kernel(
        traced, ("fe_step_kernel", "tiled_adjoint_kernel", "ddt_reduce"))
    log(f"[14] profiler, bench.py's forced {LARGE_N}^2 tiled grad ({window_us:.0f} us by "
        f"events): " + profile_line(by_kernel, window_us, busy_us, gpu))

    # the forced reverse arms per launch (held_us, 40-step calls), beside the
    # unforced arms on the same stack
    per = {}
    _, _, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st_h, sm_h = model.to_struct(prog), model.struct_mesh
    for label, st, sm, arm in (("64", st_h, sm_h, "adjoint_step"),
                               ("256", st_l, sm_l, "adjoint_step"),
                               ("256", st_l, sm_l, "tiled_adjoint"),
                               ("channel 64", st_c, sm_c, "adjoint_step")):
        forcing, group = forced_of[label], 40
        stk = stack_of(st, sm, DT, group, forcing)
        g_in = random_cot(st, 15)
        plan = None if arm == "adjoint_step" else (4, 8, 1)
        per[arm, label] = {
            k: [t / 1e6 for t in held_us(reverse_call(stk, g_in, sm, DT, group, f, plan)[0],
                                         group, REPS)]
            for k, f in (("unforced", None), ("forced", forcing))}
        u_med, f_med = (statistics.median(per[arm, label][k]) for k in ("unforced", "forced"))
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
        b, by = forced_step_bound("adjoint_step", *dims)
        log(f"[14] {arm} {label}^2 f32 per launch: forced {spread(per[arm, label]['forced'], 1e6, 'us')}"
            f", unforced {spread(per[arm, label]['unforced'], 1e6, 'us')}: x{f_med / u_med:.4f}; "
            f"forced bound {b * 1e6:.3f} us ({by}): {b / f_med:.4f} of it [{gpu}]")
        del stk
    g_l, g_h = random_cot(st_l, 16), random_cot(st_h, 16)
    plain_rev = cuda_times(lambda: structured_adjoint_step(st_l, g_l, sm_l, DT, forced_of["256"]),
                           REPS)
    plain_rev_64 = cuda_times(lambda: structured_adjoint_step(st_h, g_h, sm_h, DT,
                                                              forced_of["64"]), REPS)
    log(f"[14] plain forced reverse step f32: {HEADLINE_N}^2 {spread(plain_rev_64, 1e3, 'ms')}, "
        f"{LARGE_N}^2 {spread(plain_rev, 1e3, 'ms')}; plain forced FE step {HEADLINE_N}^2 "
        f"{spread(plain_fe, 1e3, 'ms')}, FB {LARGE_N}^2 {spread(plain_fb, 1e3, 'ms')} [{gpu}]")

    # the kernels line's entries
    def entry(name, src, replaces, launches_n, err, ms, plain_ms, bound, extra):
        (b, by) = bound
        return {"name": name, "route": "cuda", "source": f"mpas_ocean_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches_n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b * 1e3, "bound_by": by, "library_ms": None,
                **extra}

    d64 = (sm_h.ny2, sm_h.nx, LEVELS, len(sm_h.coriolis_terms), 4)
    d256 = (sm_l.ny2, sm_l.nx, LEVELS, len(sm_l.coriolis_terms), 4)
    med = statistics.median
    return [
        entry("fe_step (forced arm)", "fe_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:320 (forcing operands, :248-256)",
              c256["fe_step"][1], max_abs_err["fe_step FE", "periodic", HEADLINE_N],
              med(times["fe_step FE 64"]["forced"]) * 1e3, med(plain_fe) * 1e3,
              forced_step_bound("fe_step", *d64),
              {"unforced_ms": med(times["fe_step FE 64"]["unforced"]) * 1e3,
               "ms_256": med(times["fe_step FE 256"]["forced"]) * 1e3,
               "unforced_ms_256": med(times["fe_step FE 256"]["unforced"]) * 1e3,
               "masked_ms_64": med(times["fe_step FE channel 64"]["forced"]) * 1e3,
               "launches_forward_64": fwd["FE 64"], "max_rel_err_f64": worst["fe_step"]}),
        entry("tiled_step (forced arm)", "tiled_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:852 (forcing operands)",
              fwd["FB 256"], max_abs_err["tiled_step FB", "periodic", LARGE_N],
              med(times["tiled_step FB 256"]["forced"]) * 1e3, med(plain_fb) * 1e3,
              forced_step_bound("fe_step", *d256),
              {"unforced_ms": med(times["tiled_step FB 256"]["unforced"]) * 1e3,
               "max_rel_err_f64": worst["tiled_step"]}),
        entry("adjoint_step (forced arm)", "adjoint_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1480 (forced operands, :1514-1520)",
              c64["adjoint_step"][1], max_abs_err["adjoint_step", "periodic", HEADLINE_N],
              med(per["adjoint_step", "64"]["forced"]) * 1e3, med(plain_rev_64) * 1e3,
              forced_step_bound("adjoint_step", *d64),
              {"unforced_ms": med(per["adjoint_step", "64"]["unforced"]) * 1e3,
               "ms_256": med(per["adjoint_step", "256"]["forced"]) * 1e3,
               "unforced_ms_256": med(per["adjoint_step", "256"]["unforced"]) * 1e3,
               "bound_ms_256": forced_step_bound("adjoint_step", *d256)[0] * 1e3,
               "masked_ms_64": med(per["adjoint_step", "channel 64"]["forced"]) * 1e3,
               "plain_ms_256": med(plain_rev) * 1e3,
               "grad_s_64": g64, "grad_s_64_channel": g64c, "grad_s_256_fused": g256f,
               "max_rel_err_f64": worst["adjoint_step"]}),
        entry("tiled_adjoint (forced arm)", "tiled_adjoint.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1979 (d(wind), dscal[3:6], :2938-2941)",
              c256["tiled_adjoint"][1], max_abs_err["tiled_adjoint", "periodic", LARGE_N],
              med(per["tiled_adjoint", "256"]["forced"]) * 1e3, med(plain_rev) * 1e3,
              forced_step_bound("adjoint_step", *d256),
              {"unforced_ms": med(per["tiled_adjoint", "256"]["unforced"]) * 1e3,
               "grad_s_256": g256, "max_rel_err_f64": worst["tiled_adjoint"]}),
    ]


# ---- phase 15: tracer transport ---------------------------------------------

# Tracer steps of the f64 kernel-against-plain checks and of the physics
# checks; the main paths' lengths are the tracer-free ones' (HEADLINE_STEPS at
# 64^2 FE, LARGE_MAIN_STEPS at 256^2 and on the channel)
TRACER_CHECK_STEPS = 10
# bench.py's two tracers (measure_pallas_tracers, bench.py:147-170): T = 10 +
# 2 sin(2 pi x / (x_max + 1)), S = 35, donor-cell upwinding, no diffusion
BENCH_TRACER_UPWIND, BENCH_TRACER_KAPPA = 1.0, 0.0
# The f32 tracer check's floor, in f32 epsilons of the tracer's max |T|: a
# tracer that the flow barely moves (bench.py's S = 35 is uniform) ends a few
# roundings from the f64 run in both f32 runs, and one of those distances may
# be 0, so each tracer's limit is U_GAP_FACTOR x the larger of the plain f32
# run's distance and this floor.
TRACER_F32_FLOOR = 4
def bench_tracers(horz, levels: int, np_dtype):
    """bench.py's two tracers on ``horz`` (T = 10 + 2 sin(2 pi x / (x_max +
    1)), S = 35), made by the port's make_tracers as a user would, (nCells, 2,
    K) in ``np_dtype``."""
    import numpy as np

    import mpas_ocean_tpu_torch as mt

    vert = mt.make_vertical_mesh(horz, levels, resting_thickness=np.full(
        (horz.n_cells, levels), 1.0, dtype=np_dtype), dtype=np_dtype)
    x = np.asarray(horz.cells.x)
    return mt.make_tracers(mt.Mesh(horz=horz, vert=vert),
                           [10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1)),
                            np.full(horz.n_cells, 35.0)], dtype=np_dtype)


def tracer_phase(gpu: str, log_text: str) -> list:
    """Phase 15, tracer transport (the tracer arms of kernels 1 and 2): the
    tracer instantiations' ptxas lines; f64, fe_step FE and tiled_step FE and
    FB at q = 1, 2 with two tracers against the plain steps on 16^2 and 64^2
    random states, periodic and channel, at 4, 6 and 36 levels and on the
    channel at 100 (the main path's level chunks), kappa in {0, 5}, upwind
    in {1, 0.5, 0}, to 1e-12 of scale, reruns bitwise, the tracers left
    where they started (a rollout that drops them) 100x off; f32 on
    bench.py's tracers, 100 steps, on the IGW at 64^2 and 256^2 x 100 and on
    the 64^2 x 100 Kelvin channel with kappa 5, each tracer's distance from
    an f64 plain run within U_GAP_FACTOR x the plain f32 run's, with a bf16
    control; uniform T, conserved content, monotone upwinding and culled
    cells on the card (tests/test_tracers.py); the gradient of tracers with
    the nonlinear core and with forcing (finite: the composed reverse, held
    in phase 20) and through the tiled reverse at q = 2 (held in phase 21);
    the main paths
    from to_struct
    (bench.py's 64^2 x 100 two-tracer FE rollout over HEADLINE_STEPS, 256^2
    FE and FB, the 64^2 channel FE with kappa 5) timed beside the tracer-free
    arm with exact launch counts and their bounds. Returns the tracer arms'
    entries of the kernels line."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
    from mpas_ocean_tpu_torch.models import total_tracer_content
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        auto_rollout_diff,
        fused_run_loop,
        structured_auto_run_loop,
        structured_run_loop,
        tiled_adjoint_plan,
        tiled_rollout_diff,
        tiled_run_loop,
    )

    # kTracers true, kStrat false
    for line in ptxas_report(log_text, ("fe_step_kernel", "tiled_step_kernel"), "Lb1ELb0EEEv"):
        log(f"[15] ptxas {line}")
    counters = (fe_step, tiled_step)

    def zero_counts():
        for m in counters:
            m.launches = m.tracer_launches = 0

    def counts():
        return {m.__name__.rsplit(".", 1)[-1]: (m.launches, m.tracer_launches) for m in counters}

    with_tracers = random_tracers

    def errors(out, ref, mesh) -> dict:
        errs = field_errors(out, ref, mesh.resting_thickness_sum)
        e = float((out.tracers - ref.tracers).abs().max())
        errs["tracers"] = (e, e / float(ref.tracers.abs().max()))
        return errs

    def same(a, b) -> bool:
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS + ("tracers",))

    # f64 kernel against plain, 16^2 and 64^2 random, periodic and channel:
    # (n, levels, channel or not, tiled_step's tile, FB's q). At 4 and 6
    # levels each block of a cluster takes one level; at 36, chunks of 8 over
    # 5 blocks, the last of 4; at 100, the main path's chunks of 16 over 7,
    # the last of 4. The deep cases run the planners' tiles (None); no f64
    # FB window fits a tile at q = 2 and 100 levels. Their column is the
    # 6-level case's 60 m (at 100 layers of 10 m the gravity wave's Courant
    # number at dt = 10 s and 1 km cells is ~1, and the state blows up), and
    # they take u of 0.5 m/s (phase 13's): the step moves u through ssh, a
    # column sum that the kernel adds in chunk order, and with u of 0.01 m/s
    # that rounding alone is ~1e-12 of max|u| at 36 levels, with or without
    # tracers (PERF.md section 6, PR 11).
    worst, n_checks = {}, 0
    opts = [(kappa, upwind) for kappa in (0.0, 5.0) for upwind in (1.0, 0.5, 0.0)]
    f64_cases = [(n, levels, channel, (4, 8), (1, 2), 0.01, 10.0)
                 for n, levels in ((16, 4), (HEADLINE_N, 6)) for channel in (False, True)]
    f64_cases += [(HEADLINE_N, 36, channel, None, (1, 2), 0.5, 60.0 / 36)
                  for channel in (False, True)]
    f64_cases += [(HEADLINE_N, LEVELS, True, None, (1,), 0.5, 60.0 / LEVELS)]
    for n, levels, channel, tile, fb_qs, u_amp, layer in f64_cases:
        model, prog = (random_channel if channel else random_case)(n, levels, seed=5,
                                                                   u_amp=u_amp, layer=layer)
        sm = model.struct_mesh
        st = with_tracers(model, model.to_struct(prog))
        name = (f"f64 {n}x{n}x{levels} {'channel' if channel else 'periodic'}, layers of "
                f"{layer:.4g} m, u {u_amp} m/s")
        tk = {} if tile is None else dict(row_tile=tile[0], col_tile=tile[1])
        for kappa, upwind in opts:
            kw = dict(tracer_kappa=kappa, tracer_upwind=upwind)
            refs = {fb: structured_run_loop(st, sm, 10.0, TRACER_CHECK_STEPS, fb=fb, **kw)
                    for fb in (False, True)}
            runs = [("fe_step FE", False,
                     lambda: fused_run_loop(st, sm, 10.0, TRACER_CHECK_STEPS, **kw))]
            runs += [(f"tiled_step {'FB' if fb else 'FE'} q={q}", fb,
                      lambda fb=fb, q=q: tiled_run_loop(st, sm, 10.0, TRACER_CHECK_STEPS,
                                                        q=q, fb=fb, **tk, **kw))
                     for fb in (False, True) for q in (fb_qs if fb else (1, 2))]
            errs_all = []
            for label, fb, run in runs:
                zero_counts()
                out, again = run(), run()
                c = counts()
                if sum(t for _, t in c.values()) != sum(a for a, _ in c.values()) or not any(
                        t for _, t in c.values()):
                    raise AssertionError(f"{name} {label}: launch counts {c}")
                errs = errors(out, refs[fb], sm)
                if not max(r for _, r in errs.values()) <= 1e-12:
                    raise AssertionError(f"{name} kappa {kappa} upwind {upwind} {label}: "
                                         f"{format_errors(errs)}")
                if not same(out, again):
                    raise AssertionError(f"{name} {label}: rerun differs")
                miss = float((st.tracers - refs[fb].tracers).abs().max()
                             / refs[fb].tracers.abs().max())
                if not miss >= 100 * 1e-12:
                    raise AssertionError(f"{name} {label}: the control misses by only {miss}")
                if channel:
                    dead = (sm.cell_mask == 0)[..., None, None].expand_as(out.tracers)
                    if not bool((out.tracers.masked_select(dead) == 0).all()):
                        raise AssertionError(f"{name} {label}: T is not 0 on culled cells")
                key = label.split()[0]
                worst[key] = max(worst.get(key, 0.0), max(r for _, r in errs.values()))
                errs_all.append((label, errs["tracers"][1], miss))
                n_checks += 1
            log(f"[15] {name}, {TRACER_CHECK_STEPS} steps, kappa {kappa} upwind {upwind}: "
                "tracers' error over scale (control's miss) " + ", ".join(
                    f"{lbl} {e:.3e} ({m:.2e})" for lbl, e, m in errs_all))
        del model, st, sm
    log(f"[15] {n_checks} f64 tracer checks, reruns bitwise equal, T = 0 on culled cells; "
        "worst relative errors over every field and the tracers: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))

    # physics on the card, f64 (tests/test_tracers.py:53-110, 192-201)
    def physics_case(channel):
        horz = mt.planar_hex_mesh(16, 16, 1000.0, f0=1e-4)
        keep, mh = None, horz
        if channel:
            y = np.asarray(horz.cells.y)
            keep = (y > y.min() + 1) & (y < y.max() - 1)
            mh = mt.cull_cells(horz, keep)
        vert = mt.make_vertical_mesh(mh, 2)
        mesh = mt.Mesh(horz=mh, vert=vert)
        rng = np.random.default_rng(5 if channel else 7)
        h0 = np.asarray(vert.resting_thickness) + 0.1 * rng.standard_normal((mh.n_cells, 2))
        u0 = 0.1 * rng.standard_normal((mh.n_edges, 2)) * np.asarray(mh.edges.edge_mask)[:, None]
        x = np.asarray(mh.cells.x)
        prog = mt.PrognosticVars(
            torch.from_numpy(h0.sum(1) - np.asarray(vert.resting_thickness_sum)),
            torch.from_numpy(h0), torch.from_numpy(u0),
            tracers=mt.make_tracers(mesh, [10.0 + np.sin(2 * np.pi * x / (x.max() + 1)),
                                           35.0 + 0.0 * x]))
        kw = dict(parent_horz=horz, keep_cells=keep) if channel else {}
        model = mt.StructuredModel(mesh, 16, 16, **kw)
        return model, mesh, prog

    for channel in (False, True):
        model, mesh, prog = physics_case(channel)
        st, sm = model.to_struct(prog), model.struct_mesh
        c0 = total_tracer_content(prog.tracers, prog.layer_thickness, mesh).numpy()
        where = "channel" if channel else "periodic"
        for fb in (False, True):
            arm = "tiled_step FB" if fb else "fe_step FE"
            out = model.from_struct(structured_auto_run_loop(st, sm, 50.0, 20, fb=fb,
                                                             tracer_kappa=5.0))
            sal = out.tracers[:, 1].numpy()
            gap = float(np.abs(sal / 35.0 - 1.0).max())
            c1 = total_tracer_content(out.tracers, out.layer_thickness, mesh).numpy()
            drift = float(np.abs(c1 / c0 - 1.0).max())
            log(f"[15] physics f64 16^2 {where}, {arm}, 20 steps of 50 s, kappa 5: uniform S = 35 "
                f"kept to {gap:.3e} (rtol 1e-10), total content drift {drift:.3e} (rtol 1e-12)")
            if not (gap <= 1e-10 and drift <= 1e-12):
                raise AssertionError(f"physics {where} {arm}: S {gap:.3e}, content {drift:.3e}")
            if channel:
                lat = structured_auto_run_loop(st, sm, 50.0, 20, fb=fb, tracer_kappa=5.0)
                dead = (sm.cell_mask == 0)[..., None, None].expand_as(lat.tracers)
                if not bool((lat.tracers.masked_select(dead) == 0).all()):
                    raise AssertionError(f"physics {where} {arm}: T is not 0 on culled cells")
        if not channel:
            t0 = prog.tracers[:, 0].numpy()
            for kw in (dict(), dict(tracer_upwind=0.0), dict(fb=True, tracer_kappa=5.0)):
                out = model.from_struct(structured_auto_run_loop(st, sm, 50.0, 10, **kw))
                c1 = total_tracer_content(out.tracers, out.layer_thickness, mesh).numpy()
                if not np.allclose(c1, c0, rtol=1e-12, atol=0):
                    raise AssertionError(f"content not conserved with {kw}")
            out = structured_auto_run_loop(st, sm, 20.0, 30, tracer_upwind=1.0)
            t1 = model.from_struct(out).tracers[:, 0].numpy()
            log(f"[15] physics f64 16^2 periodic, upwind 1, 30 FE steps of 20 s: T in "
                f"[{t1.min():.12f}, {t1.max():.12f}], started in [{t0.min():.12f}, "
                f"{t0.max():.12f}]; h min {float(out.layer_thickness.min()):.6f}")
            if not (float(out.layer_thickness.min()) > 0 and t1.max() <= t0.max() + 1e-9
                    and t1.min() >= t0.min() - 1e-9):
                raise AssertionError("upwinding made a new extremum")
    log("[15] physics: T = 35 kept, content conserved (periodic: upwind 1, centered, FB with "
        "kappa 5; channel: kappa 5, walls leak nothing), upwind 1 monotone, T = 0 on culled "
        "cells")

    # f32 on bench.py's tracers, 100 steps: each tracer's distance from an
    # f64 plain run within U_GAP_FACTOR x the plain f32 run's; the plain run
    # with its tracers stored in bf16 after each step must miss that bound.
    # The IGW at 64^2 and 256^2 with kappa 0 (bench.py's cell), and the
    # Kelvin channel at 64^2 with kappa 5 (the masked arm's main path); all
    # through structured_auto_run_loop, so at the main paths' tiles.
    max_abs_err, gaps = {}, {}
    for key, case, n, kappa in (("64", igw_case, HEADLINE_N, BENCH_TRACER_KAPPA),
                                ("256", igw_case, LARGE_N, BENCH_TRACER_KAPPA),
                                ("channel 64", kelvin_case, HEADLINE_N, 5.0)):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        _, _, model64, _ = case(n, LEVELS, np.float64)
        tr = bench_tracers(horz, LEVELS, np.float32)
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity, tracers=tr))
        sm, sm64 = model.struct_mesh, model64.struct_mesh
        st64 = StructState(*(getattr(st, f).double() for f in FIELDS + ("tracers",)))
        kw = dict(tracer_kappa=kappa, tracer_upwind=BENCH_TRACER_UPWIND)
        flow = "Kelvin channel" if case is kelvin_case else "IGW"
        for fb in (False, True):
            arm = "tiled_step FB" if fb else "fe_step FE"
            out = structured_auto_run_loop(st, sm, DT, TILED_CHECK_STEPS, fb=fb, **kw)
            ref = structured_run_loop(st, sm, DT, TILED_CHECK_STEPS, fb=fb, **kw)
            ref64 = structured_run_loop(st64, sm64, DT, TILED_CHECK_STEPS, fb=fb, **kw)
            bf = st
            for _ in range(TILED_CHECK_STEPS):
                bf = structured_run_loop(bf, sm, DT, 1, fb=fb, **kw)
                bf = StructState(bf.ssh, bf.layer_thickness, bf.normal_velocity,
                                 bf.tracers.bfloat16().float())
            what = (f"f32 {n}x{n}x{LEVELS} {flow} with bench.py's tracers, kappa {kappa}, "
                    f"{TILED_CHECK_STEPS} steps, {arm}")
            ratios, control_fails = [], False
            for t, tname in enumerate(("T", "S")):
                d = lambda x: float((x.tracers[..., t, :].double()  # noqa: E731
                                     - ref64.tracers[..., t, :]).abs().max())
                g_k, g_p, g_b = d(out), d(ref), d(bf)
                floor = TRACER_F32_FLOOR * float(np.finfo(np.float32).eps) * float(
                    ref64.tracers[..., t, :].abs().max())
                limit = U_GAP_FACTOR * max(g_p, floor)
                log(f"[15] {what}: {tname}'s distance from the f64 plain run: kernel {g_k:.3e}, "
                    f"plain f32 {g_p:.3e}, floor {floor:.3e}: kernel x{g_k / limit:.3f} of the "
                    f"limit {limit:.3e}; bf16 control {g_b:.3e} (x{g_b / limit:.1f})")
                if not g_k <= limit:
                    raise AssertionError(f"{what}: {tname} {g_k:.3e} from f64, limit {limit:.3e}")
                control_fails = control_fails or g_b > limit
                ratios.append(g_k / limit)
            if not control_fails:
                raise AssertionError(f"{what}: the bf16 control passes")
            if sm.cell_mask is not None:
                check_walls(out, sm, what)
                dead = (sm.cell_mask == 0)[..., None, None].expand_as(out.tracers)
                if not bool((out.tracers.masked_select(dead) == 0).all()):
                    raise AssertionError(f"{what}: T is not 0 on culled cells")
            errs = errors(out, ref, sm)
            log(f"[15] {what}, kernel vs plain f32: {format_errors(errs)}")
            gaps[arm, key] = ratios
            max_abs_err[arm, key] = max(e for e, _ in errs.values())
        del st, st64, out, ref, ref64, bf
        torch.cuda.empty_cache()

    # the gradient with tracers on the card
    horz, _, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st_t = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                             prog.normal_velocity,
                                             tracers=bench_tracers(horz, LEVELS, np.float32)))
    sm = model.struct_mesh
    forcing = model.to_struct_forcing(mt.make_forcing(mt.Mesh(horz=horz, vert=mt.make_vertical_mesh(
        horz, LEVELS, resting_thickness=np.full((horz.n_cells, LEVELS), 10.0, dtype=np.float32),
        dtype=np.float32)), dtype=np.float32, **BENCH_FORCING))
    # the gradient with tracers and the nonlinear core or forcing runs (the
    # composed reverse, phase 20), and the tiled reverse at q = 2 (phase 21)
    q2 = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, 4, halo=(1, 2), q=2, n_tracers=2)
    for label, route, kw in (("auto_rollout_diff nonlinear", auto_rollout_diff,
                              dict(nonlinear=True)),
                             ("tiled_rollout_diff forced", tiled_rollout_diff,
                              dict(forcing=forcing)),
                             (f"tiled_rollout_diff q = 2 {q2}", tiled_rollout_diff,
                              dict(plan=q2))):
        if not grad_runs(route, st_t, sm, 4, **kw):
            raise AssertionError(f"the gradient {label} with tracers is not finite")
    log(f"[15] the gradient with tracers on the card: nonlinear (auto_rollout_diff), forced "
        f"(tiled_rollout_diff) and tiled_rollout_diff at q = 2 (plan {q2}) run, finite")

    # the main paths from to_struct, timed beside the tracer-free arm
    times, launches = {}, {}
    tracer_states = {}
    for label, case, n, fb, n_steps, kappa in (
            ("FE 64", igw_case, HEADLINE_N, False, HEADLINE_STEPS, BENCH_TRACER_KAPPA),
            ("FE 256", igw_case, LARGE_N, False, LARGE_MAIN_STEPS, BENCH_TRACER_KAPPA),
            ("FB 256", igw_case, LARGE_N, True, LARGE_MAIN_STEPS, BENCH_TRACER_KAPPA),
            ("FE channel 64", kelvin_case, HEADLINE_N, False, LARGE_MAIN_STEPS, 5.0)):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        if horz.n_cells not in tracer_states:
            tracer_states[horz.n_cells] = bench_tracers(horz, LEVELS, np.float32)
        ptr = mt.PrognosticVars(prog.ssh, prog.layer_thickness, prog.normal_velocity,
                                tracers=tracer_states[horz.n_cells])
        kw = dict(tracer_kappa=kappa, tracer_upwind=BENCH_TRACER_UPWIND)
        arm = "tiled_step" if fb else "fe_step"
        zero_counts()
        t0 = time.perf_counter()
        final = model.from_struct(structured_auto_run_loop(model.to_struct(ptr), sm, DT, n_steps,
                                                           fb=fb, **kw))
        wall = time.perf_counter() - t0
        c = counts()
        want = n_steps  # q = 1 on both routes
        log(f"[15] main path: {label}^2x{LEVELS} f32 with bench.py's two tracers (kappa {kappa}, "
            f"upwind 1), from to_struct, {n_steps} steps: {wall:.3f} s wall (to_struct .. "
            f"from_struct); launches {c} (want {arm} {want}, all with tracers)")
        if c[arm] != (want, want) or sum(a for a, _ in c.values()) != want:
            raise AssertionError(f"tracers {label}: launch counts {c}")
        if not (all(bool(torch.isfinite(getattr(final, f)).all()) for f in FIELDS + ("tracers",))
                and tuple(final.tracers.shape) == (horz.n_cells, 2, LEVELS)):
            raise AssertionError(f"tracers {label}: output not finite or of the wrong shape")
        launches[label] = c[arm][1]
        st_w = model.to_struct(ptr)
        bare = StructState(st_w.ssh, st_w.layer_thickness, st_w.normal_velocity)
        times[label] = {
            k: timed_rollout(lambda m, s=s: structured_auto_run_loop(s, sm, DT, m, fb=fb, **kw),
                             n_steps, REPS)[1]
            for k, s in (("tracer-free", bare), ("tracers", st_w), ("tracer-free again", bare))}
        times[label]["tracer-free"] += times[label].pop("tracer-free again")
        cells = 2 * sm.ny2 * sm.nx
        live = cells if sm.cell_mask is None else int(sm.cell_mask.sum())
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
        masked = sm.cell_mask is not None
        b, by = step_bound("fe_step", *dims, n_tracers=2, masked=masked)
        b0 = step_bound("fe_step", *dims, masked=masked)[0]
        med_t, med_0 = (statistics.median(times[label][k]) for k in ("tracers", "tracer-free"))
        log(f"[15] {arm} {label} f32: with tracers {spread(times[label]['tracers'], 1e6, 'us')} "
            f"per step, {live * LEVELS / med_t:.4e} cells*levels*steps/s (bench.py's n_cells * "
            f"LEVELS * steps / s); tracer-free {spread(times[label]['tracer-free'], 1e6, 'us')} "
            f": x{med_t / med_0:.4f}; bound with "
            f"tracers {b * 1e6:.3f} us ({by}): {b / med_t:.4f} of it; tracer-free bound "
            f"{b0 * 1e6:.3f} us: {b0 / med_0:.4f} [{gpu}]")
    # the plain versions' times, 64^2 FE and 256^2 FB, with tracers
    plain = {}
    for label, n, fb in (("FE 64", HEADLINE_N, False), ("FB 256", LARGE_N, True)):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=tracer_states[horz.n_cells]))
        plain[label] = timed_rollout(lambda m, st=st, sm=model.struct_mesh, fb=fb:
                                     structured_run_loop(st, sm, DT, m, fb=fb,
                                                         tracer_upwind=BENCH_TRACER_UPWIND),
                                     10, REPS)[1]
        log(f"[15] plain {label} f32 with tracers: {spread(plain[label], 1e3, 'ms')} per step "
            f"[{gpu}]")
    tile = fe_step.fe_tile(HEADLINE_N // 2, HEADLINE_N, LEVELS, 4, 2)
    plan = fe_step.launch_plan(igw_case(HEADLINE_N, LEVELS, np.float32)[2].struct_mesh.host_stencil[0],
                               HEADLINE_N // 2, HEADLINE_N, LEVELS, tile, 2)
    log(f"[15] fe_step's tracer arm at 64^2 x 100 f32, 2 tracers: tile {tile}, "
        f"{fe_step.smem_bytes(tile, LEVELS, 4, n_tracers=2)} bytes of shared memory per block, "
        f"{plan['clusters']} clusters, {plan['blocks_per_sm']} blocks of 512 threads per SM")

    med = statistics.median
    d64 = (HEADLINE_N // 2, HEADLINE_N, LEVELS, 48, 4)
    d256 = (LARGE_N // 2, LARGE_N, LEVELS, 48, 4)

    def entry(name, src, replaces, launches_n, err, ms, plain_ms, bound, extra):
        b, by = bound
        return {"name": name, "route": "cuda", "source": f"mpas_ocean_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches_n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b * 1e3, "bound_by": by, "library_ms": None,
                **extra}

    return [
        entry("fe_step (tracer arm)", "fe_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:320 (tracer planes :362-400, operand "
              ":446-451)", launches["FE 64"], max_abs_err["fe_step FE", "64"],
              med(times["FE 64"]["tracers"]) * 1e3, med(plain["FE 64"]) * 1e3,
              step_bound("fe_step", *d64, n_tracers=2),
              {"tracer_free_ms": med(times["FE 64"]["tracer-free"]) * 1e3,
               "ms_256": med(times["FE 256"]["tracers"]) * 1e3,
               "tracer_free_ms_256": med(times["FE 256"]["tracer-free"]) * 1e3,
               "bound_ms_256": step_bound("fe_step", *d256, n_tracers=2)[0] * 1e3,
               "masked_ms_64_kappa5": med(times["FE channel 64"]["tracers"]) * 1e3,
               "cells_levels_steps_per_s_64": HEADLINE_N ** 2 * LEVELS
               / med(times["FE 64"]["tracers"]),
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "fe_step FE"},
               "max_rel_err_f64": worst["fe_step"], "tile": list(tile)}),
        entry("tiled_step (tracer arm)", "tiled_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:852 (tracer operands :892-946, "
              "1180-1190)", launches["FB 256"], max_abs_err["tiled_step FB", "256"],
              med(times["FB 256"]["tracers"]) * 1e3, med(plain["FB 256"]) * 1e3,
              step_bound("fe_step", *d256, n_tracers=2),
              {"tracer_free_ms": med(times["FB 256"]["tracer-free"]) * 1e3,
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "tiled_step FB"},
               "max_rel_err_f64": worst["tiled_step"]}),
    ]


# The reverse tracer arms' arithmetic per cell-level and tracer, counted
# from csrc/adjoint_window.cuh: fold_tracers' division and product (3), the
# body's a h and a T (2) and per edge, 3 owned and 3 incoming, h_e and F
# (3), dg (2), T_e with its upwind term (7), dT_n and dT_o (6), dF (1), the
# kappa term's 9, and on an owned edge the flux g and d(dt)'s share (5):
# 3 + 2 + 3 * 33 + 3 * 28
TRACER_ADJ_OPS = 188
# The f32 tracer reverse check's floor, in f32 epsilons of a cotangent's
# scale (as TRACER_F32_FLOOR for the forward): a cotangent that both f32
# reverses carry within a few roundings of the f64 one (the salinity's, of a
# uniform S = 35) may sit nearer it in one of them by chance. d(dt)'s scale
# is its Cauchy-Schwarz bound (``ddt_scale``), as in the f64 checks: with
# tracers d(dt) is a sum whose terms cancel to some 1e-2 of them (the h'
# feedback against the tracers' tendency), and at 256^2 the kernels' f32
# d(dt) sat 8-10x the plain f32 reverse's distance from f64, 3e-4 of 8.06,
# with the terms formed in f32 or in double alike (PERF.md section 2).
TRACER_REV_F32_FLOOR = 4


def tracer_reverse_phase(gpu: str, log_text: str) -> list:
    """Phase 16, the tracer reverse (the tracer arms of kernels 3 and 4 and
    of kernel 1's stack entry): the tracer instantiations' ptxas lines; f64,
    adjoint_step and tiled_adjoint (q = 1) with two tracers against the plain
    tracer reverse (structured_adjoint_step with tracers) on the kernel's
    own primal states, 6 reverse steps, 16^2 and 64^2 random states,
    periodic and channel, at 4, 6 and 36 levels and on the channel at 100,
    at the planners' tiles (or (4, 8) where shallow), kappa in {0, 5},
    upwind in {1, 0.5, 0}: every cotangent, the tracers' and d(dt) among
    them, within 1e-12 of its scale, reruns bitwise, and the tracer-free arm
    on the same states and cotangents of ssh, h and u at least 100x off in
    d_h (the h' feedback); fe_fill_stack with tracers bitwise
    fe_rollout_into's; the dot-product identity at f64 over 7 steps through
    fused_rollout_diff and tiled_rollout_diff with directions in the
    tracers; f32, 100 reverse steps on bench.py's tracers (IGW 64^2 and
    256^2 x 100, the 64^2 channel with kappa 5): each cotangent's distance
    from an f64 reverse of the same f32 states within U_GAP_FACTOR x the
    plain f32 reverse's (or the floor), a bf16 control failing it; the
    two-tracer gradients of sum ssh^2 + sum T^2 from to_struct (64^2 IGW and
    channel over GRAD_STEPS through auto_rollout_diff, 256^2 over
    LARGE_ADJ_STEPS through tiled_rollout_diff and fused_rollout_diff) with
    exact tracer launch counts, timed beside the tracer-free gradients, a
    profiler breakdown; each tracer arm per launch by held_us beside its
    bound and the plain step. Returns the kernels line's entries."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        adjoint_plan,
        auto_rollout_diff,
        fused_model,
        fused_rollout_diff,
        structured_adjoint_step,
        structured_run_loop,
        tiled_rollout_diff,
    )
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo, tiled_adjoint_plan
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    for line in ptxas_report(log_text, ("adjoint_step_kernel", "tiled_adjoint_kernel"),
                             "Lb1ELb0EEEv"):
        log(f"[16] ptxas {line}")
    counters = (fe_step, adjoint_step, tiled_adjoint)
    tfields = FIELDS + ("tracers",)

    def zero_counts():
        for m in counters:
            m.launches = m.tracer_launches = 0

    def counts():
        return {m.__name__.rsplit(".", 1)[-1]: (m.launches, m.tracer_launches) for m in counters}

    with_tracers = random_tracers

    def random_g(st, seed):
        rng = np.random.default_rng(seed)
        return StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape))).to(
            getattr(st, f)) for f in tfields))

    def stack_of(st, sm, dt, n, kappa, upwind):
        """n + 1 states of fe_step's tracer arm from st by fe_fill_stack, slot
        j after j steps: (the (ssh, h, u) stack of slots 0 .. n - 1, the
        tracer operands whose planes are their tracer stack, the end state
        (slot n) as a StructState with tracers as planes)."""
        dtype = st.layer_thickness.dtype
        kt = fused_model.kernel_tracers(st, sm, kappa, upwind)
        full = tuple(torch.empty((n + 1, *getattr(st, f).shape), dtype=dtype,
                                 device=st.ssh.device) for f in FIELDS)
        trs = torch.empty((n + 1, *kt.planes.shape), dtype=dtype, device=st.ssh.device)
        for dst, f in zip(full, FIELDS):
            dst[0].copy_(getattr(st, f))
        trs[0].copy_(kt.planes)
        fe_step.fe_fill_stack(full, sm.f_edge.to(dtype).contiguous(),
                              sm.resting_thickness_sum.to(dtype).contiguous(), *sm.host_stencil,
                              *fused_model._scal(sm, dt, dtype), n,
                              live=fused_model.kernel_live(sm), tracers=kt._replace(planes=trs))
        end = StructState(*(x[n] for x in full), trs[n])
        return tuple(x[:n] for x in full), kt._replace(planes=trs[:n]), end

    def rev_runner(stack, kt, end, g, sm, dt, n, tile=None, tracers=True):
        """(run, ddt): run() launches n reverse steps of adjoint_step's
        tracer arm (tile None) or tiled_adjoint's at q = 1 over ``tile``
        (with ``tracers`` False the tracer-free arm on the same states and
        g's ssh, h, u) with every operand made beforehand, so that a timer
        holding the stream sees no host sync (the scalars come from the
        card), adding d(dt) to ddt; it returns the cotangent planes."""
        dtype, device = stack[1].dtype, stack[1].device
        ddt = torch.zeros(1, dtype=torch.float64, device=device)
        gk = tuple(getattr(g, f).to(dtype).contiguous() for f in FIELDS)
        kw = dict(live=fused_model.kernel_live(sm))
        if tracers:
            gk += (fused_model.tracer_planes(g.tracers.to(dtype)),)
            kw.update(tracers=kt, end=(end.layer_thickness, end.tracers))
        scal = fused_model._scal(sm, dt, dtype)
        f_edge = sm.f_edge.to(dtype).contiguous()
        rts = sm.resting_thickness_sum.to(dtype).contiguous()
        halo = reverse_halo(sm.coriolis_terms)
        if tile is None:
            return (lambda: adjoint_step.adjoint_rollout(
                stack, gk, f_edge, *sm.host_adjoint_stencil, *scal, n, ddt, **kw)), ddt
        return (lambda: tiled_adjoint.tiled_adjoint_rollout(
            stack, gk, f_edge, rts, *sm.host_stencil, *sm.host_adjoint_stencil, *scal, n, ddt,
            row_tile=tile[0], col_tile=tile[1], q=1, halo=halo, **kw)), ddt

    def kernel_rev(stack, kt, end, g, sm, dt, n, tile=None, tracers=True):
        """n reverse steps as ``rev_runner`` runs them: (cotangent with
        tracers in the lattice layout, d(dt))."""
        run, ddt = rev_runner(stack, kt, end, g, sm, dt, n, tile, tracers)
        out = run()
        tr = fused_model.tracer_unplanes(out[3]) if tracers else None
        return StructState(*out[:3], tr), ddt[0]

    def plain_rev(stack, kt, end, g, sm, dt, n, dtype=None, store=None):
        """The plain tracer reverse back through the stack's slots in
        ``dtype`` (the stack's), reading h' and T' from the next slot (or
        ``end``) as the kernels do, each step's cotangent passed through
        ``store`` (the bf16 control): (cotangent, d(dt) in f64). d(dt) is
        as sensitive to the rounding of T' as to its own (a cancelling sum,
        the h' feedback against the tracers' tendency): an f64 reverse that
        forms T' again from f32 states sits as far from one that reads their
        T' as an f32 reverse does (a 64^2 CPU run, PERF.md), so the f64
        reference reads the f32 values the kernels read."""
        dtype = dtype or stack[1].dtype
        cast = lambda s: StructState(*(getattr(s, f).to(dtype) for f in tfields))  # noqa: E731
        g = cast(g)
        ddt = torch.zeros((), dtype=torch.float64, device=stack[1].device)
        slot = lambda j: StructState(  # noqa: E731
            *(x[j] for x in stack), fused_model.tracer_unplanes(kt.planes[j])) if j < n else \
            StructState(end.ssh, end.layer_thickness, end.normal_velocity,
                        fused_model.tracer_unplanes(end.tracers))
        for j in reversed(range(n)):
            g, dd = structured_adjoint_step(cast(slot(j)), g, sm, dt, tracer_kappa=kt.kappa,
                                            tracer_upwind=kt.upwind,
                                            next_state=cast(slot(j + 1)))
            if store is not None:
                g = StructState(*(store(getattr(g, f)) for f in tfields))
            ddt = ddt + dd.double()
        return g, ddt

    def rev_errs(a, b, fields=tfields, ddt_scale=None) -> dict:
        """(max |a - b|, over the scale) per cotangent field (scale max |b|)
        and for d(dt) (scale ``ddt_scale``, by default |b|)."""
        out = {}
        for f in fields:
            e = float((getattr(a[0], f).double() - getattr(b[0], f).double()).abs().max())
            out[f] = (e, e / float(getattr(b[0], f).double().abs().max()))
        e = abs(float(a[1]) - float(b[1]))
        out["d_dt"] = (e, e / (ddt_scale or abs(float(b[1]))))
        return out

    def ddt_scale(st, sm, dt, n, g, **kw) -> float:
        """The scale of d(dt) = <g, d(state_n)/d(dt)>, a sum whose terms
        cancel (with a random g it may come out 1e-3 of them): the
        Cauchy-Schwarz bound sum over the fields of |g| |d(state_n)/d(dt)|,
        the tangent by forward-mode AD of the plain rollout."""
        def rollout(d):
            out = structured_run_loop(st, sm, d, n, **kw)
            return tuple(getattr(out, f) for f in tfields)

        one = torch.ones((), dtype=st.ssh.dtype, device=st.ssh.device)
        _, tang = torch.func.jvp(rollout, (dt * one,), (one,))
        return sum(float(torch.linalg.vector_norm(getattr(g, f).double())
                         * torch.linalg.vector_norm(t.double())) for f, t in zip(tfields, tang))

    def same(a, b) -> bool:
        return torch.equal(a[1], b[1]) and all(torch.equal(getattr(a[0], f), getattr(b[0], f))
                                               for f in tfields)

    # f64, kernel against plain (phase 15's lattices: (n, levels, channel, the
    # shallow cases' tile, u amplitude, layer); u of 0.5 m/s on the deep ones,
    # 60 m columns)
    n_rev = 6
    worst, n_checks, rebuilt = {}, 0, 0
    opts = [(kappa, upwind) for kappa in (0.0, 5.0) for upwind in (1.0, 0.5, 0.0)]
    f64_cases = [(n, levels, channel, (4, 8), 0.01, 10.0)
                 for n, levels in ((16, 4), (HEADLINE_N, 6)) for channel in (False, True)]
    f64_cases += [(HEADLINE_N, 36, channel, None, 0.5, 60.0 / 36) for channel in (False, True)]
    f64_cases += [(HEADLINE_N, LEVELS, True, None, 0.5, 60.0 / LEVELS)]
    for n, levels, channel, tile, u_amp, layer in f64_cases:
        model, prog = (random_channel if channel else random_case)(n, levels, seed=5,
                                                                   u_amp=u_amp, layer=layer)
        sm = model.struct_mesh
        st = with_tracers(model, model.to_struct(prog))
        g = random_g(st, 17)
        ny2, nx = sm.ny2, sm.nx
        tiles = {"adjoint_step": adjoint_step.adjoint_tile(ny2, nx, levels, 8, 2),
                 "tiled_adjoint": tile or tiled_adjoint_plan(
                     ny2, nx, levels, 8, n_rev, halo=reverse_halo(sm.coriolis_terms),
                     n_tracers=2)[:2]}
        name = (f"f64 {n}x{n}x{levels} {'channel' if channel else 'periodic'}, layers of "
                f"{layer:.4g} m, u {u_amp} m/s")
        for kappa, upwind in opts:
            stack, kt, end = stack_of(st, sm, 10.0, n_rev, kappa, upwind)
            if (kappa, upwind) == (5.0, 0.5):
                # the rebuild: slot j against j steps of fe_rollout_into, bitwise
                consts = (sm.f_edge.to(torch.float64).contiguous(),
                          sm.resting_thickness_sum.to(torch.float64).contiguous(),
                          *sm.host_stencil, *fused_model._scal(sm, 10.0, torch.float64))
                src = tuple(x[0] for x in stack)
                for j in (1, n_rev - 1, n_rev):
                    out = tuple(torch.empty_like(x) for x in src)
                    tr_out = torch.empty_like(kt.planes[0])
                    fe_step.fe_rollout_into(src, out, *consts, j,
                                            live=fused_model.kernel_live(sm),
                                            tracers=kt._replace(planes=kt.planes[0]),
                                            tr_out=tr_out)
                    want = (end.ssh, end.layer_thickness, end.normal_velocity, end.tracers) \
                        if j == n_rev else (*(x[j] for x in stack), kt.planes[j])
                    if not all(torch.equal(a, b) for a, b in zip((*out, tr_out), want)):
                        raise AssertionError(f"{name}: fe_fill_stack slot {j} is not "
                                             f"fe_rollout_into's {j} steps")
                    rebuilt += 1
            ref = plain_rev(stack, kt, end, g, sm, 10.0, n_rev)
            scale = ddt_scale(st, sm, 10.0, n_rev, g, tracer_kappa=kappa, tracer_upwind=upwind)
            line = [f"d(dt) {float(ref[1]):.6e}, its scale {scale:.6e}"]
            for label, tl in (("adjoint_step", None), ("tiled_adjoint", tiles["tiled_adjoint"])):
                mod = adjoint_step if tl is None else tiled_adjoint
                zero_counts()
                out = kernel_rev(stack, kt, end, g, sm, 10.0, n_rev, tl)
                again = kernel_rev(stack, kt, end, g, sm, 10.0, n_rev, tl)
                if (mod.launches, mod.tracer_launches) != (2 * n_rev, 2 * n_rev):
                    raise AssertionError(f"{name} {label}: launch counts {counts()}")
                errs = rev_errs(out, ref, ddt_scale=scale)
                if not max(r for _, r in errs.values()) <= 1e-12:
                    raise AssertionError(f"{name} kappa {kappa} upwind {upwind} {label}: "
                                         f"{format_errors(errs)}")
                if not same(out, again):
                    raise AssertionError(f"{name} {label}: rerun differs")
                bare = kernel_rev(stack, kt, end, g, sm, 10.0, n_rev, tl, tracers=False)
                miss = rev_errs(bare, ref, FIELDS)["layer_thickness"][1]
                if not miss >= 100 * 1e-12:
                    raise AssertionError(f"{name} {label}: the tracer-free control misses d_h "
                                         f"by only {miss}")
                worst[label] = max(worst.get(label, 0.0), max(r for _, r in errs.values()))
                line.append(f"{label} {max(r for _, r in errs.values()):.3e} (tracers "
                            f"{errs['tracers'][1]:.3e}, d_dt {errs['d_dt'][1]:.3e}; control d_h "
                            f"{miss:.2e})")
                n_checks += 1
            log(f"[16] {name}, {n_rev} reverse steps, kappa {kappa} upwind {upwind}, tiles "
                f"{tiles}: worst error over scale " + ", ".join(line))
            del stack, kt, end
        del model, st, sm
        torch.cuda.empty_cache()
    log(f"[16] {n_checks} f64 tracer reverse checks, reruns bitwise equal, tracer-free controls "
        f">= 100x off; {rebuilt} stack slots bitwise fe_rollout_into's; worst relative errors: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    # the dot-product identity, f64, 7 steps, directions in the tracers too
    model, prog = random_case(32, 6, seed=5, u_amp=0.5, layer=10.0)
    sm = model.struct_mesh
    st = with_tracers(model, model.to_struct(prog))
    v, gbar = random_g(st, 18), random_g(st, 19)
    kw = dict(tracer_kappa=5.0, tracer_upwind=0.5)

    def rollout7(*xs):
        out = structured_run_loop(StructState(*xs), sm, 10.0, 7, **kw)
        return tuple(getattr(out, f) for f in tfields)

    _, jv = torch.func.jvp(rollout7, tuple(getattr(st, f) for f in tfields),
                           tuple(getattr(v, f) for f in tfields))
    lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, tfields))
    dots = {}
    for label, route in (("fused_rollout_diff", lambda s: fused_rollout_diff(
            s, sm, 10.0, 7, plan=3, **kw)),
            ("tiled_rollout_diff", lambda s: tiled_rollout_diff(s, sm, 10.0, 7, plan=(4, 8, 1, 3),
                                                                 **kw))):
        x = [getattr(st, f).clone().requires_grad_(True) for f in tfields]
        out = route(StructState(*x))
        inner = sum((getattr(out, f) * getattr(gbar, f)).sum() for f in tfields)
        jtg = torch.autograd.grad(inner, x)
        rhs = sum(float((getattr(v, f) * d).sum()) for f, d in zip(tfields, jtg))
        dots[label] = abs(lhs - rhs) / abs(rhs)
        log(f"[16] f64 dot-product identity with tracers, 32x32x6, 7 steps, {label}: <Jv, g> "
            f"{lhs:.17g}, <v, J^T g> {rhs:.17g}, relative gap {dots[label]:.3e}")
        if not dots[label] <= 1e-12:
            raise AssertionError(f"{label}: dot-product identity off by {dots[label]:.3e}")
    del model, st, sm

    # f32, 100 reverse steps on bench.py's tracers, from the cotangent of
    # sum ssh^2 + sum T^2 at step 100: each cotangent's distance from an f64
    # reverse of the same f32 primal states within U_GAP_FACTOR x the plain
    # f32 reverse's (or the floor); the plain reverse with its cotangents
    # stored in bf16 after each step must miss that for some cotangent
    gaps, max_abs_err = {}, {}
    n32 = TILED_CHECK_STEPS
    for key, case, n, kappa, kernels in (
            ("64", igw_case, HEADLINE_N, BENCH_TRACER_KAPPA, (("adjoint_step", None),)),
            ("256", igw_case, LARGE_N, BENCH_TRACER_KAPPA, (("adjoint_step", None),
                                                             ("tiled_adjoint", "plan"))),
            ("channel 64", kelvin_case, HEADLINE_N, 5.0, (("adjoint_step", None),))):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=bench_tracers(horz, LEVELS, np.float32)))
        stack, kt, end = stack_of(st, sm, DT, n32, kappa, BENCH_TRACER_UPWIND)
        g = StructState(2 * end.ssh, torch.zeros_like(end.layer_thickness),
                        torch.zeros_like(end.normal_velocity),
                        2 * fused_model.tracer_unplanes(end.tracers))
        ref64 = plain_rev(stack, kt, end, g, sm, DT, n32, dtype=torch.float64)
        p32 = plain_rev(stack, kt, end, g, sm, DT, n32)
        bf = plain_rev(stack, kt, end, g, sm, DT, n32, store=lambda x: x.bfloat16().float())
        ddt_sc = ddt_scale(st, sm, DT, n32, g, tracer_kappa=kappa,
                           tracer_upwind=BENCH_TRACER_UPWIND)
        flow = "Kelvin channel" if case is kelvin_case else "IGW"
        for label, tl in kernels:
            if tl == "plan":
                tl = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, n32,
                                        halo=reverse_halo(sm.coriolis_terms), n_tracers=2)[:2]
            out = kernel_rev(stack, kt, end, g, sm, DT, n32, tl)
            what = (f"f32 {n}x{n}x{LEVELS} {flow} with bench.py's tracers, kappa {kappa}, {n32} "
                    f"reverse steps, {label}{'' if tl is None else f' tile {tuple(tl)}'}")
            e_k, e_p, e_b = rev_errs(out, ref64), rev_errs(p32, ref64), rev_errs(bf, ref64)
            ratios, control_fails, parts = {}, False, []
            for f in e_k:
                scale = e_k[f][0] / e_k[f][1] if e_k[f][1] else 0.0
                floor = TRACER_REV_F32_FLOOR * float(np.finfo(np.float32).eps) * scale
                if f == "d_dt":  # its scale: the Cauchy-Schwarz bound (TRACER_REV_F32_FLOOR)
                    floor = TRACER_REV_F32_FLOOR * float(np.finfo(np.float32).eps) * ddt_sc
                limit = U_GAP_FACTOR * max(e_p[f][0], floor)
                ratios[f] = e_k[f][0] / limit
                control_fails = control_fails or e_b[f][0] > limit
                parts.append(f"{f} kernel {e_k[f][0]:.3e}, plain {e_p[f][0]:.3e}, floor "
                             f"{floor:.3e}: x{ratios[f]:.3f} of the limit; bf16 {e_b[f][0]:.3e} "
                             f"(x{e_b[f][0] / limit:.1f})")
                if not e_k[f][0] <= limit:
                    raise AssertionError(f"{what}: {f} {e_k[f][0]:.3e} from the f64 reverse, "
                                         f"limit {limit:.3e}")
            log(f"[16] {what}: distance from an f64 reverse of the same f32 states: "
                + "; ".join(parts))
            if not control_fails:
                raise AssertionError(f"{what}: the bf16 control passes")
            gaps[label, key] = ratios
            max_abs_err[label, key] = max(e for e, _ in rev_errs(out, p32).values())
        del stack, kt, end, ref64, p32, bf, st
        torch.cuda.empty_cache()

    # the two-tracer gradients from to_struct, timed beside the tracer-free
    def grad_tr(route, s, sm, n_steps, **kw):
        leaves = [getattr(s, f).clone().requires_grad_(True) for f in tfields]
        dt = torch.tensor(DT, dtype=torch.float32, device=s.ssh.device, requires_grad=True)
        out = route(StructState(*leaves), sm, dt, n_steps, **kw)
        loss = (out.ssh ** 2).sum() + (out.tracers ** 2).sum()
        return out, torch.autograd.grad(loss, leaves + [dt])

    times, launches, tracer_states = {}, {}, {}
    for label, case, n, route, n_steps, kappa, want_arm in (
            ("64 auto", igw_case, HEADLINE_N, auto_rollout_diff, GRAD_STEPS, BENCH_TRACER_KAPPA,
             "adjoint_step"),
            ("256 tiled", igw_case, LARGE_N, tiled_rollout_diff, LARGE_ADJ_STEPS,
             BENCH_TRACER_KAPPA, "tiled_adjoint"),
            ("256 fused", igw_case, LARGE_N, fused_rollout_diff, LARGE_ADJ_STEPS,
             BENCH_TRACER_KAPPA, "adjoint_step"),
            ("channel 64 auto", kelvin_case, HEADLINE_N, auto_rollout_diff, GRAD_STEPS, 5.0,
             "adjoint_step")):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        if horz.n_cells not in tracer_states:
            tracer_states[horz.n_cells] = bench_tracers(horz, LEVELS, np.float32)
        ptr = mt.PrognosticVars(prog.ssh, prog.layer_thickness, prog.normal_velocity,
                                tracers=tracer_states[horz.n_cells])
        kw = dict(tracer_kappa=kappa, tracer_upwind=BENCH_TRACER_UPWIND)
        zero_counts()
        t0 = time.perf_counter()
        out, grads = grad_tr(route, model.to_struct(ptr), sm, n_steps, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        st_w = model.to_struct(ptr)
        state_bytes = sum(getattr(st_w, f).numel() * 4 for f in tfields)
        # q = 1 on both routes: groups of adjoint_plan's over n_steps slots
        group = adjoint_plan(n_steps, state_bytes, math.inf)
        n_groups = -(-n_steps // group)
        want = {"fe_step": (2 * n_steps - n_groups,) * 2, want_arm: (n_steps, n_steps)}
        log(f"[16] main path: grad of sum ssh^2 + sum T^2 through {route.__name__}, "
            f"{n}^2x{LEVELS} f32 {'channel' if case is kelvin_case else 'IGW'} with bench.py's "
            f"two tracers (kappa {kappa}, upwind 1), {n_steps} steps, groups of {group}, from "
            f"to_struct: {wall:.3f} s wall [{gpu}]; launches {c} (want {want}, all tracer "
            f"launches)")
        if any(c[m] != want.get(m, (0, 0)) for m in c):
            raise AssertionError(f"tracer grad {label}: launch counts {c} != {want}")
        if not all(bool(torch.isfinite(x).all()) for x in grads) or tuple(
                grads[3].shape) != tuple(st_w.tracers.shape):
            raise AssertionError(f"tracer grad {label}: not finite or of the wrong shape")
        launches[label] = c[want_arm][1], c["fe_step"][1]
        bare = StructState(st_w.ssh, st_w.layer_thickness, st_w.normal_velocity)
        times[label] = {
            "tracer-free": cuda_times(lambda: grad_sum_ssh2(route, bare, sm, n_steps), REPS),
            "tracers": cuda_times(lambda: grad_tr(route, st_w, sm, n_steps, **kw), REPS)}
        med_t, med_0 = (statistics.median(times[label][k]) for k in ("tracers", "tracer-free"))
        log(f"[16] grad {label}, {n_steps} steps: with tracers "
            f"{spread(times[label]['tracers'])}, tracer-free {spread(times[label]['tracer-free'])}"
            f" per grad: x{med_t / med_0:.4f} [{gpu}]")
        if label == "64 auto":
            by_kernel, window_us, busy_us = profile_by_kernel(
                lambda: grad_tr(route, st_w, sm, n_steps, **kw),
                ("fe_step_kernel", "adjoint_step_kernel", "ddt_reduce"))
            log(f"[16] profiler, one two-tracer grad at 64^2 ({window_us:.0f} us by events): "
                + profile_line(by_kernel, window_us, busy_us, gpu))
        del out, grads, st_w, bare
        torch.cuda.empty_cache()

    # each tracer arm per launch (held_us over a 40-step call) beside the
    # tracer-free arm, its bound and the plain tracer reverse step
    per_launch, plain_ms, bounds = {}, {}, {}
    for n in (HEADLINE_N, LARGE_N):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=tracer_states[horz.n_cells]))
        stack, kt, end = stack_of(st, sm, DT, 40, BENCH_TRACER_KAPPA, BENCH_TRACER_UPWIND)
        g = random_g(st, 20)
        halo = reverse_halo(sm.coriolis_terms)
        plans = {n_tr: tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, 40, halo=halo,
                                          n_tracers=n_tr)[:2] for n_tr in (0, 2)}
        plan = plans[2]
        for label in ("adjoint_step", "tiled_adjoint"):
            for arm, tracers in (("tracers", True), ("tracer-free", False)):
                tl = None if label == "adjoint_step" else plans[2 if tracers else 0]
                run, _ = rev_runner(stack, kt, end, g, sm, DT, 40, tl, tracers)
                per_launch[label, n, arm] = held_us(run, 40, REPS)
        s1 = StructState(*(x[0] for x in stack), fused_model.tracer_unplanes(kt.planes[0]))
        plain_ms[n] = [t * 1e3 for t in cuda_times(
            lambda: structured_adjoint_step(s1, g, sm, DT, tracer_upwind=BENCH_TRACER_UPWIND),
            REPS)]
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
        bounds[n] = step_bound("adjoint_step", *dims, n_tracers=2)
        b0 = step_bound("adjoint_step", *dims)[0]
        for label in ("adjoint_step", "tiled_adjoint"):
            t_tr = statistics.median(per_launch[label, n, "tracers"])
            t_0 = statistics.median(per_launch[label, n, "tracer-free"])
            log(f"[16] {label} per launch, {n}x{n}x{LEVELS} f32{'' if label == 'adjoint_step' else f' plans {plans}'}: "
                f"tracer arm {spread(per_launch[label, n, 'tracers'], 1, 'us')}, tracer-free "
                f"{spread(per_launch[label, n, 'tracer-free'], 1, 'us')}: x{t_tr / t_0:.4f}; bound "
                f"with tracers {bounds[n][0] * 1e6:.3f} us ({bounds[n][1]}): {bounds[n][0] * 1e6 / t_tr:.4f} "
                f"of it; tracer-free bound {b0 * 1e6:.3f} us: {b0 * 1e6 / t_0:.4f} [{gpu}]")
        log(f"[16] plain tracer reverse step, {n}x{n}x{LEVELS} f32: "
            f"{spread(plain_ms[n], 1, 'ms')} [{gpu}]")
        tile_a = adjoint_step.adjoint_tile(sm.ny2, sm.nx, LEVELS, 4, 2)
        lp = adjoint_step.launch_plan(sm.host_adjoint_stencil[0], sm.ny2, sm.nx, LEVELS, tile_a, 2)
        occ = tiled_adjoint.occupancy(*plan, 1, reverse_halo(sm.coriolis_terms), LEVELS, 2)
        log(f"[16] {n}^2 tracer arms: adjoint_step tile {tile_a}, {lp['smem_bytes']} bytes of "
            f"shared memory per block, {lp['clusters']} clusters, {lp['blocks_per_sm']} blocks of "
            f"512 threads per SM; tiled_adjoint plan {plan}, {occ[0]} bytes, {occ[1]} blocks per SM")
        del stack, kt, end, st
        torch.cuda.empty_cache()

    med = statistics.median

    def entry(name, src, replaces, n_launch, err, n, extra):
        b, by = bounds[n]
        return {"name": name, "route": "cuda", "source": f"mpas_ocean_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": n_launch, "max_abs_err": err,
                "ms": med(per_launch[name.split()[0], n, "tracers"]) / 1e3,
                "plain_ms": med(plain_ms[n]), "bound_ms": b * 1e3, "bound_by": by,
                "library_ms": None, **extra}

    return [
        entry("adjoint_step (tracer arm)", "adjoint_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1480 (gt_ref / gt_out :1521-1528, "
              "1561, 1573, 1599-1600)", launches["64 auto"][0],
              max_abs_err["adjoint_step", "64"], HEADLINE_N,
              {"fe_step_tracer_launches": launches["64 auto"][1],
               "tracer_free_ms": med(per_launch["adjoint_step", HEADLINE_N, "tracer-free"]) / 1e3,
               "ms_256": med(per_launch["adjoint_step", LARGE_N, "tracers"]) / 1e3,
               "tracer_free_ms_256": med(per_launch["adjoint_step", LARGE_N, "tracer-free"])
               / 1e3, "bound_ms_256": bounds[LARGE_N][0] * 1e3,
               "plain_ms_256": med(plain_ms[LARGE_N]),
               "grad_s_64": med(times["64 auto"]["tracers"]),
               "grad_s_64_tracer_free": med(times["64 auto"]["tracer-free"]),
               "grad_s_64_channel": med(times["channel 64 auto"]["tracers"]),
               "grad_s_256_fused": med(times["256 fused"]["tracers"]),
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "adjoint_step"},
               "max_rel_err_f64": worst["adjoint_step"], "dot_gap": dots["fused_rollout_diff"]}),
        entry("tiled_adjoint (tracer arm)", "tiled_adjoint.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1979 (tracer blocks :2017-2104)",
              launches["256 tiled"][0], max_abs_err["tiled_adjoint", "256"], LARGE_N,
              {"fe_step_tracer_launches": launches["256 tiled"][1],
               "tracer_free_ms": med(per_launch["tiled_adjoint", LARGE_N, "tracer-free"]) / 1e3,
               "ms_64": med(per_launch["tiled_adjoint", HEADLINE_N, "tracers"]) / 1e3,
               "grad_s_256": med(times["256 tiled"]["tracers"]),
               "grad_s_256_tracer_free": med(times["256 tiled"]["tracer-free"]),
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "tiled_adjoint"},
               "max_rel_err_f64": worst["tiled_adjoint"], "dot_gap": dots["tiled_rollout_diff"]}),
    ]


# ---- phase 17: layered stratification ---------------------------------------

# bench.py's baroclinic cell (measure_pallas_strat, bench.py:173-194): densities
# 1025 + linspace(0, 1, LEVELS), top first, the W made in the state dtype
BENCH_RHO_SPAN = 1.0
# Stratified steps of the f64 kernel-against-plain checks
STRAT_CHECK_STEPS = 10
# Floating-point operations per cell-level the stratified arm adds: Phi_k =
# g ssh + sum_l h_l W[l][k], K multiply-adds and g ssh's multiply and add
# (the gradient of Phi replaces that of ssh)
def strat_ops(k: int) -> int:
    return 2 * k + 2


def strat_bound(ny2: int, nx: int, k: int, n_terms: int, itemsize: int,
                peaks: dict | None = None, masked: bool = False):
    """(bound seconds, "bytes" or "operations") of one stratified step:
    ``step_bound``'s fe_step step plus W (K x K values) read once and
    ``strat_ops`` per cell-level; and W's FLOPs (2 K per cell-level) alone."""
    peaks = CEILING if peaks is None else peaks
    cells = 2 * ny2 * nx
    state = cells * (1 + 4 * k)
    table = 4 * (44 + 3 * n_terms) + itemsize * n_terms
    nbytes = itemsize * (2 * state + 4 * cells + k * k) + table + (4 * ny2 * nx if masked else 0)
    ops = cells * k * (36 + 1.5 * n_terms + strat_ops(k))
    t_bytes = nbytes / byte_rate(peaks, itemsize * state)
    t_ops = ops / peaks["flops"][itemsize]
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, cells * k * 2 * k)


def strat_phase(gpu: str, log_text: str) -> list:
    """Phase 17, layered stratification (the stratified arms of kernels 1
    and 2): the stratified instantiations' ptxas lines; f64, fe_step FE and
    tiled_step FE and FB at q = 1, 2 against the plain steps on 16^2 and
    64^2 random states, periodic and channel, at 4, 36 and 100 levels (the
    main path's level chunks), W from make_stratification with random
    non-decreasing densities and a dense random W, to 1e-12 of scale,
    reruns bitwise, the unstratified arm 100x off in u; f32 on bench.py's
    cell (the 64^2 x 100 IGW) and the 64^2 x 100 Kelvin channel, 100 FE and
    FB steps through structured_auto_run_loop, each field's distance from an
    f64 plain run within U_GAP_FACTOR x the plain f32 run's, with a bf16
    control; equal densities against the unstratified arm and the two-layer
    internal wave (FB, half a period) on the card; the gradient with
    stratification and the nonlinear core, forcing or tracers (finite: the
    composed reverse, held in phase 20); the main
    paths from to_struct (bench.py's 64^2 x 100 FE rollout over
    HEADLINE_STEPS with exact launch counts; FB 64^2, FE and FB 256^2 and
    the 64^2 channel FE over LARGE_MAIN_STEPS), timed beside the
    unstratified arm with their bounds. Returns the stratified arms' entries
    of the kernels line."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
    from mpas_ocean_tpu_torch.models import stratification_from_numpy
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        fused_run_loop,
        structured_auto_run_loop,
        structured_run_loop,
        tiled_run_loop,
    )
    from mpas_ocean_tpu_torch.structured.tiled_model import resolve_plan, window_bytes
    from mpas_ocean_tpu_torch.structured.slab import stencil_reach

    for line in ptxas_report(log_text, ("fe_step_kernel", "tiled_step_kernel"), "Lb1EEEv"):
        log(f"[17] ptxas {line}")
    counters = (fe_step, tiled_step)

    def zero_counts():
        for m in counters:
            m.launches = m.strat_launches = 0

    def counts():
        return {m.__name__.rsplit(".", 1)[-1]: (m.launches, m.strat_launches) for m in counters}

    def same(a, b) -> bool:
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)

    def strats(k, seed):
        """make_stratification of random non-decreasing densities (1025 plus a
        random walk of up to 2 kg/m^3), and a dense random W (std 0.05)."""
        rng = np.random.default_rng(seed)
        rho = 1025.0 + np.cumsum(rng.random(k)) * (2.0 / k)
        dense = stratification_from_numpy({"phi_weights": 0.05 * rng.normal(size=(k, k)),
                                           "densities": np.full(k, 1025.0)})
        return {"rho": mt.make_stratification(rho), "dense": dense}

    # f64 kernel against plain: (n, levels, channel, tiled_step's tile, FB's
    # q); the deep cases' columns and u as phase 15's (60 m, 0.5 m/s), their
    # tiles the planners' (no f64 FB window at q = 2 fits 100 levels)
    worst, n_checks = {}, 0
    f64_cases = [(16, 4, channel, (4, 8), (1, 2), 0.01, 10.0) for channel in (False, True)]
    f64_cases += [(HEADLINE_N, 36, channel, None, (1, 2), 0.5, 60.0 / 36)
                  for channel in (False, True)]
    f64_cases += [(HEADLINE_N, LEVELS, channel, None, (1,), 0.5, 60.0 / LEVELS)
                  for channel in (False, True)]
    for n, levels, channel, tile, fb_qs, u_amp, layer in f64_cases:
        model, prog = (random_channel if channel else random_case)(n, levels, seed=5,
                                                                   u_amp=u_amp, layer=layer)
        sm = model.struct_mesh
        st = model.to_struct(prog)
        name = (f"f64 {n}x{n}x{levels} {'channel' if channel else 'periodic'}, layers of "
                f"{layer:.4g} m, u {u_amp} m/s")
        tk = {} if tile is None else dict(row_tile=tile[0], col_tile=tile[1])
        for kind, strat in strats(levels, 17 + levels).items():
            refs = {fb: structured_run_loop(st, sm, 10.0, STRAT_CHECK_STEPS, fb=fb, strat=strat)
                    for fb in (False, True)}
            runs = [("fe_step FE", False,
                     lambda s: fused_run_loop(st, sm, 10.0, STRAT_CHECK_STEPS, strat=s))]
            runs += [(f"tiled_step {'FB' if fb else 'FE'} q={q}", fb,
                      lambda s, fb=fb, q=q: tiled_run_loop(st, sm, 10.0, STRAT_CHECK_STEPS, q=q,
                                                           fb=fb, strat=s, **tk))
                     for fb in (False, True) for q in (fb_qs if fb else (1, 2))]
            line = []
            for label, fb, run in runs:
                zero_counts()
                out, again = run(strat), run(strat)
                c = counts()
                if sum(s for _, s in c.values()) != sum(a for a, _ in c.values()) or not any(
                        s for _, s in c.values()):
                    raise AssertionError(f"{name} {label}: launch counts {c}")
                errs = field_errors(out, refs[fb], sm.resting_thickness_sum)
                if not max(r for _, r in errs.values()) <= 1e-12:
                    raise AssertionError(f"{name} W {kind} {label}: {format_errors(errs)}")
                if not same(out, again):
                    raise AssertionError(f"{name} W {kind} {label}: rerun differs")
                bare = field_errors(run(None), refs[fb], sm.resting_thickness_sum)
                miss = bare["normal_velocity"][1]
                if not miss >= 100 * 1e-12:
                    raise AssertionError(f"{name} W {kind} {label}: the unstratified control "
                                         f"misses by only {miss}")
                if channel:
                    check_walls(out, sm, f"{name} {label}")
                key = label.split()[0]
                worst[key] = max(worst.get(key, 0.0), max(r for _, r in errs.values()))
                line.append((label, max(r for _, r in errs.values()), miss))
                n_checks += 1
            log(f"[17] {name}, W {kind}, {STRAT_CHECK_STEPS} steps: worst error over scale "
                "(unstratified control's miss in u) " + ", ".join(
                    f"{lbl} {e:.3e} ({m:.2e})" for lbl, e, m in line))
        del model, st, sm
    log(f"[17] {n_checks} f64 stratified checks, reruns bitwise equal, walls +0 on the "
        "channel; worst relative errors over every field: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))

    # physics on the card, f64: equal densities reproduce the unstratified
    # arms (tests/test_stratification.py:48-58); the two-layer internal wave
    # (tests/test_stratification.py:276-322) through tiled_step's FB arm
    model, prog = random_channel(HEADLINE_N, 36, seed=5, u_amp=0.5, layer=60.0 / 36)
    st, sm = model.to_struct(prog), model.struct_mesh
    eq = mt.make_stratification([1026.0] * 36)
    for fb in (False, True):
        a = structured_auto_run_loop(st, sm, 10.0, STRAT_CHECK_STEPS, fb=fb, strat=eq)
        b = structured_auto_run_loop(st, sm, 10.0, STRAT_CHECK_STEPS, fb=fb)
        errs = field_errors(a, b, sm.resting_thickness_sum)
        log(f"[17] f64 64x64x36 channel, equal densities against the unstratified arm, "
            f"{'FB' if fb else 'FE'}: {format_errors(errs)}")
        if not max(r for _, r in errs.values()) <= 1e-12:
            raise AssertionError(f"equal densities {'FB' if fb else 'FE'}: {format_errors(errs)}")
    n, dc, dt_iw = 32, 10000.0, 100.0
    iw = mt.InternalWave(lx=n * dc / 1e3, amplitude=1.0)
    horz = mt.planar_hex_mesh(n, n, dc, f0=0.0)
    vert = mt.make_vertical_mesh(horz, 2, resting_thickness=np.tile(
        np.array([iw.h1, iw.h2]), (horz.n_cells, 1)))
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n)
    ssh, h, u = iw.initial_state(horz)
    st = model.to_struct(mt.PrognosticVars(*(torch.from_numpy(a) for a in (ssh, h, u))))
    n_half = int(round(iw.period / 2 / dt_iw))
    zero_counts()
    out = model.from_struct(structured_auto_run_loop(
        st, model.struct_mesh, dt_iw, n_half, fb=True,
        strat=mt.make_stratification(iw.densities())))
    c = counts()
    x = np.asarray(horz.cells.x)
    basis = np.sin(iw.k * x)
    proj = lambda f: float(np.vdot(basis, f - iw.h1) / np.vdot(basis, basis))  # noqa: E731
    a0, a1 = proj(h[:, 0]), proj(out.layer_thickness[:, 0].numpy())
    exact = iw.exact_thickness(x, n_half * dt_iw)
    rmse = float(np.sqrt(np.mean((out.layer_thickness.numpy() - exact) ** 2)))
    log(f"[17] f64 two-layer internal wave, 32x32, f0 = 0, c1 {iw.c1:.6f} m/s, FB (tiled_step) "
        f"over half a period, {n_half} steps of {dt_iw} s: mode amplitude {a0:.6f} -> {a1:.6f} "
        f"(ratio {-a1 / a0:.6f}, limit 1 +- 0.05), RMSE {rmse:.4e} m (limit 0.05); launches {c}")
    if not (abs(-a1 / a0 - 1.0) <= 0.05 and rmse < 0.05 * iw.amplitude
            and c["tiled_step"] == (n_half, n_half)):
        raise AssertionError("the internal wave on the card")

    # f32, 100 steps, bench.py's cell and the 64^2 channel: each field's
    # distance from an f64 plain run within U_GAP_FACTOR x the plain f32
    # run's; the plain run with its state stored in bf16 after each step must
    # miss that bound in some field
    bench_rho = 1025.0 + np.linspace(0.0, BENCH_RHO_SPAN, LEVELS)
    strat32 = mt.make_stratification(bench_rho, dtype=np.float32)
    max_abs_err, gaps = {}, {}
    for key, case in (("64", igw_case), ("channel 64", kelvin_case)):
        _, _, model, prog = case(HEADLINE_N, LEVELS, np.float32)
        _, _, model64, _ = case(HEADLINE_N, LEVELS, np.float64)
        st = model.to_struct(prog)
        sm, sm64 = model.struct_mesh, model64.struct_mesh
        st64 = StructState(*(getattr(st, f).double() for f in FIELDS))
        flow = "Kelvin channel" if case is kelvin_case else "IGW"
        for fb in (False, True):
            arm = "tiled_step FB" if fb else "fe_step FE"
            out = structured_auto_run_loop(st, sm, DT, TILED_CHECK_STEPS, fb=fb, strat=strat32)
            ref = structured_run_loop(st, sm, DT, TILED_CHECK_STEPS, fb=fb, strat=strat32)
            ref64 = structured_run_loop(st64, sm64, DT, TILED_CHECK_STEPS, fb=fb, strat=strat32)
            bf = st
            for _ in range(TILED_CHECK_STEPS):
                bf = structured_run_loop(bf, sm, DT, 1, fb=fb, strat=strat32)
                bf = StructState(*(getattr(bf, f).bfloat16().float() for f in FIELDS))
            what = f"f32 {HEADLINE_N}^2x{LEVELS} {flow}, {TILED_CHECK_STEPS} steps, {arm}"
            ratios, control_fails = [], False
            for f in FIELDS:
                d = lambda x: float((getattr(x, f).double()  # noqa: E731
                                     - getattr(ref64, f)).abs().max())
                g_k, g_p, g_b = d(out), d(ref), d(bf)
                limit = U_GAP_FACTOR * g_p
                log(f"[17] {what}: {f}'s distance from the f64 plain run: kernel {g_k:.3e}, "
                    f"plain f32 {g_p:.3e}: kernel x{g_k / limit:.3f} of the limit {limit:.3e}; "
                    f"bf16 control {g_b:.3e} (x{g_b / limit:.1f})")
                if not g_k <= limit:
                    raise AssertionError(f"{what}: {f} {g_k:.3e} from f64, limit {limit:.3e}")
                control_fails = control_fails or g_b > limit
                ratios.append(g_k / limit)
            if not control_fails:
                raise AssertionError(f"{what}: the bf16 control passes")
            if sm.cell_mask is not None:
                check_walls(out, sm, what)
            errs = field_errors(out, ref, sm.resting_thickness_sum)
            log(f"[17] {what}, kernel vs plain f32: {format_errors(errs)}")
            gaps[arm, key] = ratios
            max_abs_err[arm, key] = max(e for e, _ in errs.values())
        del st, st64, out, ref, ref64, bf
        torch.cuda.empty_cache()

    # the gradient with stratification on the card
    horz, _, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    st_t = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                             prog.normal_velocity,
                                             tracers=bench_tracers(horz, LEVELS, np.float32)))
    forcing = model.to_struct_forcing(mt.make_forcing(mt.Mesh(horz=horz, vert=mt.make_vertical_mesh(
        horz, LEVELS, resting_thickness=np.full((horz.n_cells, LEVELS), 10.0, dtype=np.float32),
        dtype=np.float32)), dtype=np.float32, **BENCH_FORCING))
    # (the forward runs every combination, phase 19; the gradient too, the
    # composed reverse of phase 20)
    from mpas_ocean_tpu_torch.structured import auto_rollout_diff, tiled_rollout_diff

    for label, route, s, kw in (
            ("nonlinear", auto_rollout_diff, st, dict(nonlinear=True)),
            ("forced", auto_rollout_diff, st, dict(forcing=forcing)),
            ("tracers", auto_rollout_diff, st_t, {}),
            ("tiled_rollout_diff nonlinear", tiled_rollout_diff, st, dict(nonlinear=True))):
        if not grad_runs(route, s, sm, 2, strat=strat32, **kw):
            raise AssertionError(f"the gradient {label} with stratification is not finite")
    log("[17] the gradient with stratification runs on the card, finite: nonlinear, forced, "
        "tracers, tiled_rollout_diff nonlinear")

    # the main path: bench.py's cell from to_struct, HEADLINE_STEPS FE steps
    zero_counts()
    t0 = time.perf_counter()
    final = model.from_struct(structured_auto_run_loop(model.to_struct(prog), sm, DT,
                                                       HEADLINE_STEPS, strat=strat32))
    wall = time.perf_counter() - t0
    c = counts()
    log(f"[17] main path: bench.py's baroclinic {HEADLINE_N}^2x{LEVELS} f32, densities 1025 + "
        f"linspace(0, {BENCH_RHO_SPAN}, {LEVELS}), from to_struct, {HEADLINE_STEPS} FE steps: "
        f"{wall:.3f} s wall (to_struct .. from_struct); launches {c} (want fe_step "
        f"{HEADLINE_STEPS}, all stratified)")
    if c != {"fe_step": (HEADLINE_STEPS, HEADLINE_STEPS), "tiled_step": (0, 0)}:
        raise AssertionError(f"the stratified main path: launch counts {c}")
    if not (all(bool(torch.isfinite(getattr(final, f)).all()) for f in FIELDS)
            and tuple(final.layer_thickness.shape) == (horz.n_cells, LEVELS)):
        raise AssertionError("the stratified main path: output not finite or of the wrong shape")
    main_launches = c["fe_step"][1]
    del final

    # each path from its own zeroed counts, then timed beside the
    # unstratified arm in the same call (unstratified, stratified,
    # unstratified), by CUDA events
    times, launches = {}, {}
    for label, case, n, fb, n_steps in (
            ("FE 64", igw_case, HEADLINE_N, False, HEADLINE_STEPS),
            ("FB 64", igw_case, HEADLINE_N, True, LARGE_MAIN_STEPS),
            ("FE 256", igw_case, LARGE_N, False, LARGE_MAIN_STEPS),
            ("FB 256", igw_case, LARGE_N, True, LARGE_MAIN_STEPS),
            ("FE channel 64", kelvin_case, HEADLINE_N, False, LARGE_MAIN_STEPS)):
        _, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(prog)
        arm = "tiled_step" if fb else "fe_step"
        zero_counts()
        structured_auto_run_loop(st, sm, DT, n_steps, fb=fb, strat=strat32)
        c = counts()
        if c[arm] != (n_steps, n_steps) or sum(a for a, _ in c.values()) != n_steps:
            raise AssertionError(f"stratified {label}: launch counts {c}")
        launches[label] = c[arm][1]
        times[label] = {
            k: timed_rollout(lambda m, s=s: structured_auto_run_loop(st, sm, DT, m, fb=fb,
                                                                     strat=s),
                             n_steps, REPS)[1]
            for k, s in (("unstratified", None), ("stratified", strat32),
                         ("unstratified again", None))}
        times[label]["unstratified"] += times[label].pop("unstratified again")
        masked = sm.cell_mask is not None
        live = 2 * sm.ny2 * sm.nx if not masked else int(sm.cell_mask.sum())
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
        b, by, w_flops = strat_bound(*dims, masked=masked)
        b0 = step_bound("fe_step", *dims, masked=masked)[0]
        med_s, med_0 = (statistics.median(times[label][k])
                        for k in ("stratified", "unstratified"))
        log(f"[17] {arm} {label}^2x{LEVELS} f32 stratified: "
            f"{spread(times[label]['stratified'], 1e6, 'us')} per step, "
            f"{live * LEVELS / med_s:.4e} cells*levels*steps/s; unstratified "
            f"{spread(times[label]['unstratified'], 1e6, 'us')}: x{med_s / med_0:.4f}; bound "
            f"{b * 1e6:.3f} us ({by}; W's {w_flops:.4e} FLOPs per step, "
            f"{w_flops / CEILING['flops'][4] * 1e6:.3f} us at the f32 ceiling): "
            f"{b / med_s:.4f} of it; unstratified bound {b0 * 1e6:.3f} us: {b0 / med_0:.4f} "
            f"[{gpu}]")
    # the plain versions' times with stratification, 64^2 FE and 256^2 FB
    plain = {}
    for label, n, fb in (("FE 64", HEADLINE_N, False), ("FB 256", LARGE_N, True)):
        _, _, model, prog = igw_case(n, LEVELS, np.float32)
        st = model.to_struct(prog)
        plain[label] = timed_rollout(lambda m, st=st, sm=model.struct_mesh, fb=fb:
                                     structured_run_loop(st, sm, DT, m, fb=fb, strat=strat32),
                                     10, REPS)[1]
        log(f"[17] plain {label} f32 stratified: {spread(plain[label], 1e3, 'ms')} per step "
            f"[{gpu}]")
    ny2 = HEADLINE_N // 2
    tile = fe_step.fe_tile(ny2, HEADLINE_N, LEVELS, 4, strat=True)
    plan = fe_step.launch_plan(igw_case(HEADLINE_N, LEVELS, np.float32)[2].struct_mesh
                               .host_stencil[0], ny2, HEADLINE_N, LEVELS, tile, strat=True)
    log(f"[17] fe_step's stratified arm at 64^2 x 100 f32: tile {tile}, "
        f"{fe_step.smem_bytes(tile, LEVELS, 4, strat=True)} bytes of shared memory per block, "
        f"{plan['clusters']} clusters, {plan['blocks_per_sm']} blocks of 512 threads per SM")
    sm256 = igw_case(LARGE_N, LEVELS, np.float32)[2].struct_mesh
    halo = stencil_reach(sm256.coriolis_terms, True)
    window = functools.partial(window_bytes, strat=True, fb=True)
    rt, ct, q = resolve_plan(sm256.ny2, sm256.nx, LEVELS, 4, halo, LARGE_MAIN_STEPS,
                             window=window)
    occ = tiled_step.occupancy(rt, ct, q, halo, LEVELS, True, strat=True)
    log(f"[17] tiled_step's stratified FB arm at 256^2 x 100 f32: plan ({rt}, {ct}, {q}), "
        f"{window(rt, ct, q, halo, LEVELS, 4)} bytes of shared memory per block, {occ[0]} "
        f"clusters at once, {occ[1]} blocks of 512 threads per SM")

    med = statistics.median
    d64 = (HEADLINE_N // 2, HEADLINE_N, LEVELS, 48, 4)
    d256 = (LARGE_N // 2, LARGE_N, LEVELS, 48, 4)

    def entry(name, src, replaces, launches_n, err, ms, plain_ms, bound, extra):
        b, by, _ = bound
        return {"name": name, "route": "cuda", "source": f"mpas_ocean_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches_n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b * 1e3, "bound_by": by, "library_ms": None,
                **extra}

    return [
        entry("fe_step (stratified arm)", "fe_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:320 (strat_w :154-165, operand "
              ":436-437)", main_launches, max_abs_err["fe_step FE", "64"],
              med(times["FE 64"]["stratified"]) * 1e3, med(plain["FE 64"]) * 1e3,
              strat_bound(*d64),
              {"unstratified_ms": med(times["FE 64"]["unstratified"]) * 1e3,
               "ms_256": med(times["FE 256"]["stratified"]) * 1e3,
               "unstratified_ms_256": med(times["FE 256"]["unstratified"]) * 1e3,
               "bound_ms_256": strat_bound(*d256)[0] * 1e3,
               "masked_ms_64": med(times["FE channel 64"]["stratified"]) * 1e3,
               "cells_levels_steps_per_s_64": HEADLINE_N ** 2 * LEVELS
               / med(times["FE 64"]["stratified"]),
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "fe_step FE"},
               "max_rel_err_f64": worst["fe_step"], "tile": list(tile)}),
        entry("tiled_step (stratified arm)", "tiled_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:852 (strat_w :904-908, 1193-1194)",
              launches["FB 256"], max_abs_err["tiled_step FB", "64"],
              med(times["FB 256"]["stratified"]) * 1e3, med(plain["FB 256"]) * 1e3,
              strat_bound(*d256),
              {"unstratified_ms": med(times["FB 256"]["unstratified"]) * 1e3,
               "ms_64": med(times["FB 64"]["stratified"]) * 1e3,
               "unstratified_ms_64": med(times["FB 64"]["unstratified"]) * 1e3,
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "tiled_step FB"},
               "max_rel_err_f64": worst["tiled_step"], "plan_256": [rt, ct, q]}),
    ]


# ---- phase 18: the stratified reverse -----------------------------------------

# Floating-point operations per cell-level the stratified reverse arms add,
# in the state dtype: W dPhi at the block's levels (K multiply-adds) and
# dPhi's scale; and in double: d(W)'s row sums (K multiply-adds), a matrix
# product h^T dPhi over the cells
def strat_adj_ops(k: int) -> tuple[int, int]:
    return 2 * k + 1, 2 * k


def strat_adj_bound(ny2: int, nx: int, k: int, n_terms: int, itemsize: int,
                    peaks: dict | None = None, masked: bool = False):
    """(bound seconds, "bytes" or "operations") of one stratified reverse
    step: ``step_bound``'s adjoint_step step (a primal state and a cotangent
    read, a cotangent and d(dt) written) plus W read once and d(W) (K x K
    doubles) written once, and ``strat_adj_ops`` more per cell-level: those
    in the state dtype at its rate (at f32 the tensor cores' TF32 would
    compute another function), those in double, d(W)'s matrix product, at
    the FP64 tensor cores' rate or the f64 rate the card is shown to reach,
    whichever is higher."""
    peaks = CEILING if peaks is None else peaks
    cells = 2 * ny2 * nx
    state = cells * (1 + 4 * k)
    table = 4 * (44 + 3 * n_terms) + itemsize * n_terms
    nbytes = (itemsize * (3 * state + 3 * cells + k * k) + 8 + 8 * k * k + table
              + (4 * ny2 * nx if masked else 0))
    ops_t, ops_d = strat_adj_ops(k)
    t_bytes = nbytes / byte_rate(peaks, itemsize * state)
    t_ops = (cells * k * (81 + n_terms + ops_t) / peaks["flops"][itemsize]
             + cells * k * ops_d / max(DATASHEET["mma64"], peaks["flops"][8]))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def strat_reverse_phase(gpu: str, log_text: str) -> list:
    """Phase 18, the stratified reverse (the stratified arms of kernels 3
    and 4 and of kernel 1's stack entry): the stratified reverse
    instantiations' ptxas lines; f64, adjoint_step and tiled_adjoint (q = 1)
    against the plain stratified reverse (structured_adjoint_step(strat=))
    on the kernel's own primal states, 6 reverse steps, 16^2 and 64^2
    random states, periodic and channel, at 4, 36 and 100 levels (the main
    path's level chunks), make_stratification's W of random densities and
    a dense random W: the cotangent within 1e-12 of each field's scale, d(dt)
    and d(W) within 1e-12 of their Cauchy-Schwarz scales, reruns bitwise,
    the unstratified arm on the same states at least 100x off in d_h;
    fe_fill_stack's stratified arm bitwise fe_rollout_into's; the
    dot-product identity at f64 over 7 steps through fused_rollout_diff and
    tiled_rollout_diff with directions in the state and W; f32, 100 reverse
    steps with bench.py's densities (IGW 64^2 and 256^2 x 100, the 64^2
    channel): each cotangent's distance from an f64 reverse of the same f32
    states within U_GAP_FACTOR x the plain f32 reverse's, a bf16 control
    failing it; one f32 reverse step on integer data whose sums in double
    are exact: both arms' d(W) bitwise the exact sums, the sums in float
    not; the stratified gradient with the nonlinear core, forcing and
    tracers (finite; phase 20 holds it) and the tiled route at q = 2
    (phase 21 holds it); the slice's gradients of sum ssh^2 w.r.t. the state, dt and W from
    to_struct (64^2 IGW and channel over GRAD_STEPS through
    auto_rollout_diff, 256^2 over LARGE_ADJ_STEPS through tiled_rollout_diff
    and fused_rollout_diff) with exact stratified launch counts, timed
    beside the unstratified gradients, a profiler breakdown; each
    stratified arm per launch by held_us beside the unstratified arm, its
    bound and the plain step. Returns the kernels line's entries."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.models import Stratification, stratification_from_numpy
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        adjoint_plan,
        auto_rollout_diff,
        fused_model,
        fused_rollout_diff,
        pressure_transpose,
        structured_adjoint_step,
        structured_run_loop,
        tiled_rollout_diff,
    )
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo, tiled_adjoint_plan
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    for line in ptxas_report(log_text, ("adjoint_step_kernel", "tiled_adjoint_kernel"),
                             "Lb1EEEv"):
        log(f"[18] ptxas {line}")
    counters = (fe_step, adjoint_step, tiled_adjoint)

    def zero_counts():
        for m in counters:
            m.launches = m.strat_launches = 0

    def counts():
        return {m.__name__.rsplit(".", 1)[-1]: (m.launches, m.strat_launches) for m in counters}

    def strats(k, seed):
        """make_stratification of random non-decreasing densities, and a
        dense random W (std 0.05), as phase 17's."""
        rng = np.random.default_rng(seed)
        rho = 1025.0 + np.cumsum(rng.random(k)) * (2.0 / k)
        dense = stratification_from_numpy({"phi_weights": 0.05 * rng.normal(size=(k, k)),
                                           "densities": np.full(k, 1025.0)})
        return {"rho": mt.make_stratification(rho), "dense": dense}

    def random_g(st, seed):
        rng = np.random.default_rng(seed)
        return StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape))).to(
            getattr(st, f)) for f in FIELDS))

    def stack_of(st, sm, dt, n, strat):
        """n + 1 states of fe_step's stratified arm from st by fe_fill_stack,
        slot j after j steps: (the stack of slots 0 .. n - 1, W as the
        kernels take it, slot n)."""
        dtype = st.layer_thickness.dtype
        w = fused_model.kernel_strat(strat, dtype, st.ssh.device)
        full = tuple(torch.empty((n + 1, *getattr(st, f).shape), dtype=dtype,
                                 device=st.ssh.device) for f in FIELDS)
        for dst, f in zip(full, FIELDS):
            dst[0].copy_(getattr(st, f))
        fe_step.fe_fill_stack(full, sm.f_edge.to(dtype).contiguous(),
                              sm.resting_thickness_sum.to(dtype).contiguous(), *sm.host_stencil,
                              *fused_model._scal(sm, dt, dtype), n,
                              live=fused_model.kernel_live(sm), strat_w=w)
        return tuple(x[:n] for x in full), w, StructState(*(x[n] for x in full))

    def rev_runner(stack, w, g, sm, dt, n, tile=None, strat=True):
        """(run, ddt, dw): run() launches n reverse steps of adjoint_step's
        stratified arm (tile None) or tiled_adjoint's at q = 1 over
        ``tile`` (with ``strat`` False the unstratified arm on the same
        states) with every operand made beforehand, adding d(dt) to ddt
        and d(W) to dw; it returns the cotangent."""
        dtype, device = stack[1].dtype, stack[1].device
        k = stack[1].shape[-1]
        ddt = torch.zeros(1, dtype=torch.float64, device=device)
        dw = torch.zeros((k, k), dtype=torch.float64, device=device) if strat else None
        gk = tuple(getattr(g, f).to(dtype).contiguous() for f in FIELDS)
        kw = dict(live=fused_model.kernel_live(sm), strat_w=w if strat else None, dstrat=dw)
        scal = fused_model._scal(sm, dt, dtype)
        f_edge = sm.f_edge.to(dtype).contiguous()
        rts = sm.resting_thickness_sum.to(dtype).contiguous()
        if tile is None:
            return (lambda: adjoint_step.adjoint_rollout(
                stack, gk, f_edge, *sm.host_adjoint_stencil, *scal, n, ddt, **kw)), ddt, dw
        return (lambda: tiled_adjoint.tiled_adjoint_rollout(
            stack, gk, f_edge, rts, *sm.host_stencil, *sm.host_adjoint_stencil, *scal, n, ddt,
            row_tile=tile[0], col_tile=tile[1], q=1, halo=reverse_halo(sm.coriolis_terms),
            **kw)), ddt, dw

    def kernel_rev(stack, w, g, sm, dt, n, tile=None, strat=True):
        run, ddt, dw = rev_runner(stack, w, g, sm, dt, n, tile, strat)
        out = run()
        return StructState(*out[:3]), ddt[0], dw

    def plain_rev(stack, w, g, sm, dt, n, dtype=None, store=None):
        """The plain stratified reverse through the stack's slots in
        ``dtype`` (the stack's), W as the kernels take it, each step's
        cotangent passed through ``store`` (the bf16 control): ((cotangent,
        d(dt), d(W)), d(W)'s Cauchy-Schwarz scale, max over (l, k) of the
        sum over steps and cells of |h[c, l]| |dPhi[c, k]|, and the float
        accumulator control: d(W) with each step's sum over the cells in
        ``dtype`` where the plain reverse sums it in double)."""
        dtype = dtype or stack[1].dtype
        k = stack[1].shape[-1]
        strat = Stratification(w.to(dtype), torch.zeros(k, dtype=dtype, device=w.device))
        eye = {t: Stratification(torch.eye(k, dtype=t, device=w.device), strat.densities)
               for t in (torch.float64, dtype)}
        g = StructState(*(getattr(g, f).to(dtype) for f in FIELDS))
        ddt = torch.zeros((), dtype=torch.float64, device=w.device)
        dw, dw_float, w_scale = (torch.zeros((k, k), dtype=torch.float64, device=w.device)
                                 for _ in range(3))
        for j in reversed(range(n)):
            s = StructState(*(x[j].to(dtype) for x in stack))
            gu = g.normal_velocity
            if sm.edge_mask is not None:
                gu = gu * sm.edge_mask[..., None].to(dtype)
            h = s.layer_thickness.reshape(-1, k)
            d_phi, _ = pressure_transpose(s.layer_thickness.double(), gu.double(), dt, sm,
                                          eye[torch.float64])
            w_scale += h.double().abs().T @ d_phi.abs().reshape(-1, k)
            d_phi, _ = pressure_transpose(s.layer_thickness, gu, dt, sm, eye[dtype])
            dw_float += (h.T @ d_phi.reshape(-1, k)).double()
            g, dd, d = structured_adjoint_step(s, g, sm, dt, strat=strat)
            if store is not None:
                g = StructState(*(store(getattr(g, f)) for f in FIELDS))
            ddt, dw = ddt + dd.double(), dw + d.double()
        return (g, ddt, dw), float(w_scale.max()), dw_float

    def ddt_scale(st, sm, dt, n, g, strat) -> float:
        """d(dt)'s Cauchy-Schwarz scale: sum over the fields of |g|
        |d(state_n)/d(dt)|, the tangent by forward-mode AD of the plain
        stratified rollout."""
        def rollout(d):
            out = structured_run_loop(st, sm, d, n, strat=strat)
            return tuple(getattr(out, f) for f in FIELDS)

        one = torch.ones((), dtype=st.ssh.dtype, device=st.ssh.device)
        _, tang = torch.func.jvp(rollout, (dt * one,), (one,))
        return sum(float(torch.linalg.vector_norm(getattr(g, f).double())
                         * torch.linalg.vector_norm(t.double())) for f, t in zip(FIELDS, tang))

    def rev_errs(a, b, dd_scale, w_scale, fields=FIELDS) -> dict:
        """(max |a - b|, over the scale) per cotangent field (scale max |b|),
        for d(dt) and d(W) (their Cauchy-Schwarz scales)."""
        out = {}
        for f in fields:
            e = float((getattr(a[0], f).double() - getattr(b[0], f).double()).abs().max())
            out[f] = (e, e / float(getattr(b[0], f).double().abs().max()))
        if a[2] is not None:
            e = abs(float(a[1]) - float(b[1]))
            out["d_dt"] = (e, e / dd_scale)
            e = float((a[2] - b[2]).abs().max())
            out["d_w"] = (e, e / w_scale)
        return out

    def same(a, b) -> bool:
        return torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) and all(
            torch.equal(getattr(a[0], f), getattr(b[0], f)) for f in FIELDS)

    # f64, kernel against plain: (n, levels, channel, the shallow cases'
    # tile, u amplitude, layer); phase 17's lattices
    n_rev = 6
    worst, n_checks, rebuilt = {}, 0, 0
    f64_cases = [(16, 4, channel, (4, 8), 0.01, 10.0) for channel in (False, True)]
    f64_cases += [(HEADLINE_N, levels, channel, None, 0.5, 60.0 / levels)
                  for levels in (36, LEVELS) for channel in (False, True)]
    for n, levels, channel, tile, u_amp, layer in f64_cases:
        model, prog = (random_channel if channel else random_case)(n, levels, seed=5,
                                                                   u_amp=u_amp, layer=layer)
        sm = model.struct_mesh
        st = model.to_struct(prog)
        g = random_g(st, 17)
        tiles = {"adjoint_step": adjoint_step.adjoint_tile(sm.ny2, sm.nx, levels, 8, strat=True),
                 "tiled_adjoint": tile or tiled_adjoint_plan(
                     sm.ny2, sm.nx, levels, 8, n_rev, halo=reverse_halo(sm.coriolis_terms),
                     strat=True)[:2]}
        name = (f"f64 {n}x{n}x{levels} {'channel' if channel else 'periodic'}, layers of "
                f"{layer:.4g} m, u {u_amp} m/s")
        for kind, strat in strats(levels, 29 + levels).items():
            stack, w, end = stack_of(st, sm, 10.0, n_rev, strat)
            if kind == "dense":
                # the rebuild: slot j against j steps of fe_rollout_into, bitwise
                consts = (sm.f_edge.to(torch.float64).contiguous(),
                          sm.resting_thickness_sum.to(torch.float64).contiguous(),
                          *sm.host_stencil, *fused_model._scal(sm, 10.0, torch.float64))
                src = tuple(x[0] for x in stack)
                for j in (1, n_rev - 1, n_rev):
                    out = tuple(torch.empty_like(x) for x in src)
                    fe_step.fe_rollout_into(src, out, *consts, j,
                                            live=fused_model.kernel_live(sm), strat_w=w)
                    want = state_fields(end) if j == n_rev else tuple(x[j] for x in stack)
                    if not all(torch.equal(a, b) for a, b in zip(out, want)):
                        raise AssertionError(f"{name}: fe_fill_stack slot {j} is not "
                                             f"fe_rollout_into's {j} stratified steps")
                    rebuilt += 1
            ref, w_scale, _ = plain_rev(stack, w, g, sm, 10.0, n_rev)
            dd_scale = ddt_scale(st, sm, 10.0, n_rev, g, strat)
            line = [f"d(dt) {float(ref[1]):.6e} (scale {dd_scale:.6e}), max|d(W)| "
                    f"{float(ref[2].abs().max()):.6e} (scale {w_scale:.6e})"]
            for label, tl in (("adjoint_step", None), ("tiled_adjoint", tiles["tiled_adjoint"])):
                mod = adjoint_step if tl is None else tiled_adjoint
                zero_counts()
                out = kernel_rev(stack, w, g, sm, 10.0, n_rev, tl)
                again = kernel_rev(stack, w, g, sm, 10.0, n_rev, tl)
                if (mod.launches, mod.strat_launches) != (2 * n_rev, 2 * n_rev):
                    raise AssertionError(f"{name} {label}: launch counts {counts()}")
                errs = rev_errs(out, ref, dd_scale, w_scale)
                if not max(r for _, r in errs.values()) <= 1e-12:
                    raise AssertionError(f"{name} W {kind} {label}: {format_errors(errs)}")
                if not same(out, again):
                    raise AssertionError(f"{name} W {kind} {label}: rerun differs")
                bare = kernel_rev(stack, w, g, sm, 10.0, n_rev, tl, strat=False)
                miss = rev_errs(bare, ref, dd_scale, w_scale)["layer_thickness"][1]
                if not miss >= 100 * 1e-12:
                    raise AssertionError(f"{name} W {kind} {label}: the unstratified control "
                                         f"misses d_h by only {miss}")
                worst[label] = max(worst.get(label, 0.0), max(r for _, r in errs.values()))
                line.append(f"{label} {max(r for _, r in errs.values()):.3e} (d_dt "
                            f"{errs['d_dt'][1]:.3e}, d_w {errs['d_w'][1]:.3e}; control d_h "
                            f"{miss:.2e})")
                n_checks += 1
            log(f"[18] {name}, W {kind}, {n_rev} reverse steps, tiles {tiles}: worst error over "
                "scale " + ", ".join(line))
            del stack, w, end
        del model, st, sm
        torch.cuda.empty_cache()
    log(f"[18] {n_checks} f64 stratified reverse checks, reruns bitwise equal, unstratified "
        f"controls >= 100x off; {rebuilt} stack slots bitwise fe_rollout_into's; worst relative "
        "errors: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    # the dot-product identity, f64, 7 steps, directions in the state and W
    model, prog = random_case(32, 6, seed=5, u_amp=0.5, layer=10.0)
    sm = model.struct_mesh
    st = model.to_struct(prog)
    base = strats(6, 41)["dense"]
    w0 = base.phi_weights.to(st.ssh.device)
    v, gbar = random_g(st, 18), random_g(st, 19)
    v_w = torch.from_numpy(0.05 * np.random.default_rng(20).normal(size=(6, 6))).to(w0)

    def rollout7(*xs):
        out = structured_run_loop(StructState(*xs[:3]), sm, 10.0, 7,
                                  strat=Stratification(xs[3], base.densities))
        return tuple(getattr(out, f) for f in FIELDS)

    _, jv = torch.func.jvp(rollout7, (*state_fields(st), w0), (*state_fields(v), v_w))
    lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, FIELDS))
    dots = {}
    for label, route, kw in (("fused_rollout_diff", fused_rollout_diff, dict(plan=3)),
                             ("tiled_rollout_diff", tiled_rollout_diff, dict(plan=(4, 8, 1, 3)))):
        x = [f.clone().requires_grad_(True) for f in state_fields(st)]
        w = w0.clone().requires_grad_(True)
        out = route(StructState(*x), sm, 10.0, 7, strat=Stratification(w, base.densities), **kw)
        inner = sum((getattr(out, f) * getattr(gbar, f)).sum() for f in FIELDS)
        jtg = torch.autograd.grad(inner, x + [w])
        rhs = sum(float((getattr(v, f) * d).sum()) for f, d in zip(FIELDS, jtg))
        rhs += float((v_w * jtg[3]).sum())
        dots[label] = abs(lhs - rhs) / abs(rhs)
        log(f"[18] f64 dot-product identity with a direction in W, 32x32x6, 7 steps, {label}: "
            f"<Jv, g> {lhs:.17g}, <v, J^T g> {rhs:.17g}, relative gap {dots[label]:.3e}")
        if not dots[label] <= 1e-12:
            raise AssertionError(f"{label}: dot-product identity off by {dots[label]:.3e}")
    del model, st, sm

    # f32, 100 reverse steps with bench.py's densities, from the cotangent of
    # sum ssh^2 at step 100: each cotangent's distance from an f64 reverse of
    # the same f32 primal states within U_GAP_FACTOR x the plain f32
    # reverse's; the plain reverse with its cotangents stored in bf16 after
    # each step must miss that for some cotangent
    strat32 = mt.make_stratification(1025.0 + np.linspace(0.0, BENCH_RHO_SPAN, LEVELS),
                                     dtype=np.float32)
    gaps, max_abs_err = {}, {}
    n32 = TILED_CHECK_STEPS
    for key, case, n, kernels in (
            ("64", igw_case, HEADLINE_N, (("adjoint_step", None),)),
            ("256", igw_case, LARGE_N, (("adjoint_step", None), ("tiled_adjoint", "plan"))),
            ("channel 64", kelvin_case, HEADLINE_N, (("adjoint_step", None),))):
        _, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(prog)
        stack, w, end = stack_of(st, sm, DT, n32, strat32)
        g = StructState(2 * end.ssh, torch.zeros_like(end.layer_thickness),
                        torch.zeros_like(end.normal_velocity))
        ref64, w_scale, _ = plain_rev(stack, w, g, sm, DT, n32, dtype=torch.float64)
        p32, _, _ = plain_rev(stack, w, g, sm, DT, n32)
        bf, _, _ = plain_rev(stack, w, g, sm, DT, n32, store=lambda x: x.bfloat16().float())
        scales = {f: float(getattr(ref64[0], f).abs().max()) for f in FIELDS}
        scales["d_dt"] = ddt_scale(st, sm, DT, n32, g, strat32)
        scales["d_w"] = w_scale
        flow = "Kelvin channel" if case is kelvin_case else "IGW"
        for label, tl in kernels:
            if tl == "plan":
                tl = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, n32,
                                        halo=reverse_halo(sm.coriolis_terms), strat=True)[:2]
            out = kernel_rev(stack, w, g, sm, DT, n32, tl)
            what = (f"f32 {n}x{n}x{LEVELS} {flow} with bench.py's densities, {n32} reverse "
                    f"steps, {label}{'' if tl is None else f' tile {tuple(tl)}'}")
            e_k, e_p, e_b = (rev_errs(x, ref64, scales["d_dt"], w_scale) for x in (out, p32, bf))
            ratios, control_fails, parts = {}, False, []
            for f in e_k:
                limit = U_GAP_FACTOR * e_p[f][0]
                ratios[f] = e_k[f][0] / limit
                control_fails = control_fails or e_b[f][0] > limit
                parts.append(f"{f} kernel {e_k[f][0]:.3e}, plain {e_p[f][0]:.3e}: "
                             f"x{ratios[f]:.3f} of the limit; bf16 {e_b[f][0]:.3e} "
                             f"(x{e_b[f][0] / limit:.1f})")
                if not e_k[f][0] <= limit:
                    raise AssertionError(f"{what}: {f} {e_k[f][0]:.3e} from the f64 reverse, "
                                         f"limit {limit:.3e}")
            log(f"[18] {what}: distance from an f64 reverse of the same f32 states: "
                + "; ".join(parts))
            if not control_fails:
                raise AssertionError(f"{what}: the bf16 control passes")
            gaps[label, key] = ratios
            max_abs_err[label, key] = max(e for e, _ in rev_errs(out, p32, 1.0, 1.0).values())
        del stack, w, end, ref64, p32, bf, st
        torch.cuda.empty_cache()

    # f32 d(W) summed in double: one reverse step on a lattice of spacing
    # 1024 m with h = 2^20 + integers 0 .. 1023, a u-cotangent of integers
    # -7 .. 7 and dt = 1 s, where every product h dPhi and every sum of them
    # in double is exact: both arms' d(W) bitwise the plain f64 reverse's;
    # the same sums over the cells in float (an f32 matrix product) are not
    for n in (HEADLINE_N, LARGE_N):
        sm, stack, g = integer_strat_case(n)
        w = fused_model.kernel_strat(strat32, torch.float32, stack[0].device)
        (_, _, exact), _, _ = plain_rev(stack, w, g, sm, 1.0, 1, dtype=torch.float64)
        _, _, dw_float = plain_rev(stack, w, g, sm, 1.0, 1)
        if torch.equal(dw_float, exact):
            raise AssertionError(f"{n}^2: d(W) summed in float is exact; the check cannot "
                                 "tell a float accumulator")
        for label in ("adjoint_step", "tiled_adjoint"):
            tl = None if label == "adjoint_step" else tiled_adjoint_plan(
                sm.ny2, sm.nx, LEVELS, 4, 1, halo=reverse_halo(sm.coriolis_terms),
                strat=True)[:2]
            _, _, dw = kernel_rev(stack, w, g, sm, 1.0, 1, tl)
            if not torch.equal(dw, exact):
                off = float((dw - exact).abs().max())
                raise AssertionError(f"f32 {n}^2 {label}: d(W) {off:.3e} from the exact sums: "
                                     "not summed in double")
        log(f"[18] f32 {n}x{n}x{LEVELS}, one reverse step on integer data (h = 2^20 + 0 .. 1023, "
            f"gu -7 .. 7, dt 1 s, dc 1024 m): adjoint_step's and tiled_adjoint's d(W) bitwise "
            f"the exact sums (max |d(W)| {float(exact.abs().max()):.6e}); summed over the cells "
            f"in float {float((dw_float - exact).abs().max()):.3e} off")
        del stack, g, sm
        torch.cuda.empty_cache()

    # the gradients with stratification and the nonlinear core, forcing or
    # tracers run on the card, and the tiled route at q = 2 (phase 21)
    horz, _, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    st_t = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                             prog.normal_velocity,
                                             tracers=bench_tracers(horz, LEVELS, np.float32)))
    forcing = model.to_struct_forcing(mt.make_forcing(mt.Mesh(horz=horz, vert=mt.make_vertical_mesh(
        horz, LEVELS, resting_thickness=np.full((horz.n_cells, LEVELS), 10.0, dtype=np.float32),
        dtype=np.float32)), dtype=np.float32, **BENCH_FORCING))
    for label, s, kw in (("nonlinear", st, dict(nonlinear=True)),
                         ("forced", st, dict(forcing=forcing)), ("tracers", st_t, {})):
        if not grad_runs(auto_rollout_diff, s, sm, 2, strat=strat32, **kw):
            raise AssertionError(f"the stratified gradient {label} is not finite")
    q2 = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, 4, halo=(1, 2), q=2, strat=True)
    if not grad_runs(tiled_rollout_diff, st, sm, 4, strat=strat32, plan=q2):
        raise AssertionError("the stratified gradient tiled q = 2 is not finite")
    log(f"[18] the stratified gradient on the card: nonlinear, forced and with tracers run "
        f"(the composed reverse, phase 20), and tiled_rollout_diff at q = 2 (plan {q2}; "
        "phase 21 holds it), finite")
    del st, st_t

    # the slice's gradients from to_struct, w.r.t. the state, dt and W, each
    # path from its own zeroed counts, then timed beside the unstratified
    # gradient in the same call
    def grad_w(route, s, sm, n_steps, strat):
        leaves = [f.clone().requires_grad_(True) for f in state_fields(s)]
        dt = torch.tensor(DT, dtype=torch.float32, device=s.ssh.device, requires_grad=True)
        w = strat.phi_weights.to(s.ssh.device).clone().requires_grad_(True)
        out = route(StructState(*leaves), sm, dt, n_steps,
                    strat=Stratification(w, strat.densities))
        return out, torch.autograd.grad((out.ssh ** 2).sum(), leaves + [dt, w])

    times, launches, walls = {}, {}, {}
    for label, case, n, route, n_steps, want_arm in (
            ("64 auto", igw_case, HEADLINE_N, auto_rollout_diff, GRAD_STEPS, "adjoint_step"),
            ("channel 64 auto", kelvin_case, HEADLINE_N, auto_rollout_diff, GRAD_STEPS,
             "adjoint_step"),
            ("256 tiled", igw_case, LARGE_N, tiled_rollout_diff, LARGE_ADJ_STEPS,
             "tiled_adjoint"),
            ("256 fused", igw_case, LARGE_N, fused_rollout_diff, LARGE_ADJ_STEPS,
             "adjoint_step")):
        _, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        zero_counts()
        t0 = time.perf_counter()
        out, grads = grad_w(route, model.to_struct(prog), sm, n_steps, strat32)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        c = counts()
        st_w = model.to_struct(prog)
        state_bytes = sum(f.numel() * 4 for f in state_fields(st_w))
        group = adjoint_plan(n_steps, state_bytes, math.inf)
        want = {"fe_step": (2 * n_steps - -(-n_steps // group),) * 2,
                want_arm: (n_steps, n_steps)}
        log(f"[18] main path: grad of sum ssh^2 w.r.t. the state, dt and W through "
            f"{route.__name__}, {n}^2x{LEVELS} f32 {'channel' if case is kelvin_case else 'IGW'} "
            f"with bench.py's densities, {n_steps} steps, groups of {group}, from to_struct: "
            f"{walls[label]:.3f} s wall [{gpu}]; launches {c} (want {want}, all stratified)")
        if any(c[m] != want.get(m, (0, 0)) for m in c):
            raise AssertionError(f"stratified grad {label}: launch counts {c} != {want}")
        if not all(bool(torch.isfinite(x).all()) for x in grads) or tuple(
                grads[4].shape) != (LEVELS, LEVELS) or not float(grads[4].abs().max()) > 0:
            raise AssertionError(f"stratified grad {label}: not finite, of the wrong shape, "
                                 f"or d(W) zero")
        launches[label] = c[want_arm][1], c["fe_step"][1]
        times[label] = {
            "unstratified": cuda_times(lambda: grad_sum_ssh2(route, st_w, sm, n_steps), REPS),
            "stratified": cuda_times(lambda: grad_w(route, st_w, sm, n_steps, strat32), REPS)}
        med_s, med_0 = (statistics.median(times[label][k]) for k in ("stratified", "unstratified"))
        log(f"[18] grad {label}, {n_steps} steps: stratified {spread(times[label]['stratified'])}"
            f", unstratified {spread(times[label]['unstratified'])} per grad: x{med_s / med_0:.4f} "
            f"[{gpu}]")
        if label == "64 auto":
            by_kernel, window_us, busy_us = profile_by_kernel(
                lambda: grad_w(route, st_w, sm, n_steps, strat32),
                ("fe_step_kernel", "adjoint_step_kernel", "ddt_reduce", "strat_reduce"))
            log(f"[18] profiler, one stratified grad at 64^2 ({window_us:.0f} us by events): "
                + profile_line(by_kernel, window_us, busy_us, gpu))
        del out, grads, st_w
        torch.cuda.empty_cache()

    # each stratified arm per launch (held_us over a 40-step call) beside the
    # unstratified arm, its bound and the plain stratified reverse step
    per_launch, plain_ms, bounds, plans = {}, {}, {}, {}
    for n in (HEADLINE_N, LARGE_N):
        _, _, model, prog = igw_case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(prog)
        stack, w, _ = stack_of(st, sm, DT, 40, strat32)
        g = random_g(st, 20)
        halo = reverse_halo(sm.coriolis_terms)
        plans[n] = {s: tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, 40, halo=halo,
                                          strat=s)[:2] for s in (False, True)}
        for label in ("adjoint_step", "tiled_adjoint"):
            for arm, strat in (("stratified", True), ("unstratified", False)):
                tl = None if label == "adjoint_step" else plans[n][strat]
                run, _, _ = rev_runner(stack, w, g, sm, DT, 40, tl, strat)
                per_launch[label, n, arm] = held_us(run, 40, REPS)
        s1 = StructState(*(x[0] for x in stack))
        strat_k = Stratification(w, strat32.densities)
        plain_ms[n] = [t * 1e3 for t in cuda_times(
            lambda: structured_adjoint_step(s1, g, sm, DT, strat=strat_k), REPS)]
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
        bounds[n] = strat_adj_bound(*dims)
        b0 = step_bound("adjoint_step", *dims)[0]
        for label in ("adjoint_step", "tiled_adjoint"):
            t_s = statistics.median(per_launch[label, n, "stratified"])
            t_0 = statistics.median(per_launch[label, n, "unstratified"])
            log(f"[18] {label} per launch, {n}x{n}x{LEVELS} f32"
                f"{'' if label == 'adjoint_step' else f' plans {plans[n]}'}: stratified arm "
                f"{spread(per_launch[label, n, 'stratified'], 1, 'us')}, unstratified "
                f"{spread(per_launch[label, n, 'unstratified'], 1, 'us')}: x{t_s / t_0:.4f}; "
                f"bound {bounds[n][0] * 1e6:.3f} us ({bounds[n][1]}): "
                f"{bounds[n][0] * 1e6 / t_s:.4f} of it; unstratified bound {b0 * 1e6:.3f} us: "
                f"{b0 * 1e6 / t_0:.4f} [{gpu}]")
        log(f"[18] plain stratified reverse step, {n}x{n}x{LEVELS} f32: "
            f"{spread(plain_ms[n], 1, 'ms')} [{gpu}]")
        tile_a = adjoint_step.adjoint_tile(sm.ny2, sm.nx, LEVELS, 4, strat=True)
        lp = adjoint_step.launch_plan(sm.host_adjoint_stencil[0], sm.ny2, sm.nx, LEVELS, tile_a,
                                      strat=True)
        occ = tiled_adjoint.occupancy(*plans[n][True], 1, halo, LEVELS, strat=True)
        n_tiles = lp["clusters"]
        log(f"[18] {n}^2 stratified arms: adjoint_step tile {tile_a}, {lp['smem_bytes']} bytes "
            f"of shared memory per block, {n_tiles} clusters, {lp['blocks_per_sm']} blocks of "
            f"512 threads per SM, d(W) accumulators {n_tiles * LEVELS ** 2 * 8 / 1e6:.3f} MB; "
            f"tiled_adjoint plan {plans[n][True]}, {occ[0]} bytes, {occ[1]} blocks per SM")
        del stack, w, st
        torch.cuda.empty_cache()

    med = statistics.median

    def entry(name, src, replaces, n_launch, err, n, extra):
        b, by = bounds[n]
        return {"name": name, "route": "cuda", "source": f"mpas_ocean_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": n_launch, "max_abs_err": err,
                "ms": med(per_launch[name.split()[0], n, "stratified"]) / 1e3,
                "plain_ms": med(plain_ms[n]), "bound_ms": b * 1e3, "bound_by": by,
                "library_ms": None, **extra}

    return [
        entry("adjoint_step (stratified arm)", "adjoint_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1480 (sw_ref :1506-1510, dsw "
              ":1576-1601)", launches["64 auto"][0], max_abs_err["adjoint_step", "64"],
              HEADLINE_N,
              {"fe_step_strat_launches": launches["64 auto"][1],
               "unstratified_ms": med(per_launch["adjoint_step", HEADLINE_N, "unstratified"])
               / 1e3,
               "ms_256": med(per_launch["adjoint_step", LARGE_N, "stratified"]) / 1e3,
               "unstratified_ms_256": med(per_launch["adjoint_step", LARGE_N, "unstratified"])
               / 1e3, "bound_ms_256": bounds[LARGE_N][0] * 1e3,
               "plain_ms_256": med(plain_ms[LARGE_N]),
               "grad_s_64": med(times["64 auto"]["stratified"]),
               "grad_s_64_unstratified": med(times["64 auto"]["unstratified"]),
               "grad_s_64_channel": med(times["channel 64 auto"]["stratified"]),
               "grad_s_256_fused": med(times["256 fused"]["stratified"]),
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "adjoint_step"},
               "max_rel_err_f64": worst["adjoint_step"], "dot_gap": dots["fused_rollout_diff"]}),
        entry("tiled_adjoint (stratified arm)", "tiled_adjoint.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1979 (sw_ref :2022-2035, per-tile "
              "d(W) :2113-2118)", launches["256 tiled"][0], max_abs_err["tiled_adjoint", "256"],
              LARGE_N,
              {"fe_step_strat_launches": launches["256 tiled"][1],
               "unstratified_ms": med(per_launch["tiled_adjoint", LARGE_N, "unstratified"]) / 1e3,
               "ms_64": med(per_launch["tiled_adjoint", HEADLINE_N, "stratified"]) / 1e3,
               "grad_s_256": med(times["256 tiled"]["stratified"]),
               "grad_s_256_unstratified": med(times["256 tiled"]["unstratified"]),
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "tiled_adjoint"},
               "max_rel_err_f64": worst["tiled_adjoint"], "dot_gap": dots["tiled_rollout_diff"],
               "plan_256": list(plans[LARGE_N][True])}),
    ]


# ---- phase 19: composed physics ---------------------------------------------

# The composed options: the nonlinear core, bench.py's momentum forcing,
# tracers and layered stratification (the forward kernels' composed arms)
COMPOSED_OPTIONS = ("nonlinear", "forced", "tracers", "strat")
# Composed steps of the f64 kernel-against-plain checks and of the physics
# checks
COMPOSED_CHECK_STEPS = 10


def composed_combos() -> list:
    """Every combination of two or more of COMPOSED_OPTIONS (11)."""
    import itertools

    return [frozenset(c) for r in (2, 3, 4)
            for c in itertools.combinations(COMPOSED_OPTIONS, r)]


def composed_bound(ny2: int, nx: int, k: int, n_terms: int, itemsize: int, opts,
                   n_tracers: int = 2, masked: bool = False, peaks: dict | None = None,
                   reverse: bool = False, parts: bool = False):
    """(bound seconds, "bytes" or "operations") of one composed step with
    the options ``opts``: a state read and written, with tracers their 2 nT
    planes too; the core's constants and tables (``step_bound``'s linear
    ones, ``nl_bound``'s nonlinear ones), with forcing its winds and packed
    levels, stratified W (K x K); the core's arithmetic (36 + 1.5 n_terms
    per cell-level, or step_flop_count's 184 + 4 n_terms (+ 6 masked) per
    site of two cells) plus TRACER_OPS per cell-level and tracer,
    FORCED_FWD_OPS and strat_ops(K) per cell-level.

    With ``reverse``, one composed reverse step: a primal state and a
    cotangent read and a cotangent written (tracers: 3 x 2 nT planes), h'
    and T' of the next state (1 + 2 nT planes) read; the reverse's constants
    and tables (``step_bound``'s, or ``nl_adjoint_bound``'s) and a d(dt)
    share; with forcing d(wind) read and written too, with stratification
    d(W) (K x K doubles) written too. Its arithmetic is 81 + n_terms per
    cell-level, or NL_ADJOINT_FLOPS per site of two cells, plus
    TRACER_ADJ_OPS per cell-level and tracer, FORCED_REV_OPS and
    strat_adj_ops(K) per cell-level, those in double at the FP64 tensor
    cores' or the shown f64 rate, whichever is higher. ``peaks`` as for
    ``step_bound``. With ``parts``, (the bytes' seconds, the operations')."""
    cells = 2 * ny2 * nx
    state = cells * (1 + 4 * k)
    tr = cells * k * n_tracers if "tracers" in opts else 0
    nl = "nonlinear" in opts
    if reverse and nl:
        consts = (20 if masked else 4) * ny2 * nx
        tables = 4 * (2 * (44 + 3 * n_terms) + 12 * 11) + 8 * (2 * n_terms + 12)
        ops = ny2 * nx * k * NL_ADJOINT_FLOPS
    elif reverse:
        consts = 3 * cells
        tables = 4 * (44 + 3 * n_terms) + itemsize * n_terms
        ops = cells * k * (81 + n_terms)
    elif nl:
        consts = cells + (20 if masked else 4) * ny2 * nx
        tables = 4 * (44 + 3 * n_terms + 12 * 11) + 8 * (n_terms + 12)
        ops = ny2 * nx * k * (184 + 4 * n_terms + (6 if masked else 0))
    else:
        consts = 4 * cells
        tables = 4 * (44 + 3 * n_terms) + itemsize * n_terms
        ops = cells * k * (36 + 1.5 * n_terms)
    if reverse:
        nbytes = itemsize * (3 * (state + tr) + consts + (cells * k + tr if tr else 0)) + 8
    else:
        nbytes = itemsize * (2 * (state + tr) + consts)
    nbytes += tables
    if masked:
        nbytes += 4 * ny2 * nx + (itemsize * cells if tr else 0)
    ops_d = 0
    if "forced" in opts:
        nbytes += ny2 * nx * (6 * itemsize + 24) + 24
        nbytes += 2 * 6 * itemsize * ny2 * nx if reverse else 0
        ops += cells * k * (FORCED_REV_OPS if reverse else FORCED_FWD_OPS)
    if "strat" in opts:
        nbytes += itemsize * k * k + (8 * k * k if reverse else 0)
        ops_t, ops_d = strat_adj_ops(k) if reverse else (strat_ops(k), 0)
        ops += cells * k * ops_t
    if tr:
        ops += cells * k * (TRACER_ADJ_OPS if reverse else TRACER_OPS) * n_tracers
    peaks = CEILING if peaks is None else peaks
    t_bytes = nbytes / byte_rate(peaks, itemsize * (state + tr))
    t_ops = (ops / peaks["flops"][itemsize]
             + cells * k * ops_d / max(DATASHEET["mma64"], peaks["flops"][8]))
    if parts:
        return t_bytes, t_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bench_forcing(horz, model, np_dtype):
    """bench.py's forcing (BENCH_FORCING) on ``horz`` in the model's struct
    layout, made by make_forcing as a user would."""
    import numpy as np

    import mpas_ocean_tpu_torch as mt

    vert = mt.make_vertical_mesh(horz, LEVELS, resting_thickness=np.full(
        (horz.n_cells, LEVELS), 10.0, dtype=np_dtype), dtype=np_dtype)
    return model.to_struct_forcing(mt.make_forcing(mt.Mesh(horz=horz, vert=vert),
                                                   dtype=np_dtype, **BENCH_FORCING))


def grad_runs(route, st, sm, n_steps: int, **kw) -> bool:
    """Whether the gradient of sum ssh^2 (+ sum T^2 with tracers) through
    ``route`` over n_steps from ``st`` runs on the card, finite: the
    earlier phases' check of a gradient phase 20 holds in full."""
    import torch

    from mpas_ocean_tpu_torch.structured import StructState

    x = [None if v is None else v.clone().requires_grad_(True) for v in
         (st.ssh, st.layer_thickness, st.normal_velocity, st.tracers)]
    out = route(StructState(*x), sm, DT, n_steps, **kw)
    obj = (out.ssh ** 2).sum() + (0.0 if out.tracers is None else (out.tracers ** 2).sum())
    grads = torch.autograd.grad(obj, [v for v in x if v is not None])
    return all(bool(torch.isfinite(g).all()) for g in grads)


def composed_phase(gpu: str, log_text: str) -> list:
    """Phase 19, composed physics (the composed arms of kernels 1 and 2:
    forcing, tracers and stratification together, and with the nonlinear
    core): the composed instantiations' ptxas lines; f64, every combination
    of two or more options against the plain steps, fe_step FE and
    tiled_step FB (q = 1, the nonlinear core's arms), and for the linear
    core tiled_step FE and FB at q = 1, 2 too, on 16^2 and 64^2 random
    states, periodic and channel, at 4, 36 and 100 levels, to 1e-12 of
    scale, reruns bitwise, each run with one of its options dropped 100x
    off (the tracers: the tracers left where they started); f32, 100 steps
    of bench.py's full-physics cell (the 64^2 x 100 IGW and the Kelvin
    channel, FE and FB), each field's distance from an f64 plain run within
    U_GAP_FACTOR x the plain f32 run's, with a bf16 control; physics on the
    card (equal densities against the unstratified composed arm, S = 35
    kept, tracer content conserved, periodic and channel); the gradient of
    each combination (finite; phase 20 holds it against the plain reverse);
    the main paths from
    to_struct with exact launch counts (bench.py's full-physics 64^2 x 100
    FE rollout over HEADLINE_STEPS; FB 64^2, FE and FB 256^2 and the 64^2
    channel FE with kappa 5 over LARGE_MAIN_STEPS), timed beside each arm
    alone with their bounds. Returns the composed arms' entries of the
    kernels line."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        auto_rollout_diff,
        structured_auto_run_loop,
        structured_run_loop,
        tiled_rollout_diff,
        tiled_run_loop,
    )

    t_phase = time.perf_counter()
    # the composed instantiations: the nonlinear kernel with any of (kForced,
    # kTracers, kStrat), the linear ones with two or more of them
    for line in (ptxas_report(log_text, ("nl_step_kernel",),
                              ("Lb1EEEv", "Lb1ELb0EEEv", "Lb1ELb0ELb0EEEv"))
                 + ptxas_report(log_text, ("fe_step_kernel", "tiled_step_kernel"),
                                ("Lb1ELb1ELb0EEEv", "Lb1ELb0ELb1EEEv", "Lb1ELb1EEEv"))):
        log(f"[19] ptxas {line}")
    counters = (fe_step, tiled_step)
    arm_counters = ("forced_launches", "tracer_launches", "strat_launches")
    combos = composed_combos()

    def zero_counts():
        for m in counters:
            m.launches = 0
            for c in arm_counters:
                setattr(m, c, 0)

    def counts():
        return {m.__name__.rsplit(".", 1)[-1]: (m.launches, *(getattr(m, c) for c in arm_counters))
                for m in counters}

    with_tracers = random_tracers

    def bare(st):
        return StructState(st.ssh, st.layer_thickness, st.normal_velocity)

    def errors(out, ref, mesh) -> dict:
        errs = field_errors(out, ref, mesh.resting_thickness_sum)
        if ref.tracers is not None:
            e = float((out.tracers - ref.tracers).abs().max())
            errs["tracers"] = (e, e / float(ref.tracers.abs().max()))
        return errs

    def same(a, b) -> bool:
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS) and (
            a.tracers is None or torch.equal(a.tracers, b.tracers))

    def run_kw(opts, forcing, strat, kappa=5.0, upwind=0.5):
        return dict(nonlinear="nonlinear" in opts, forcing=forcing if "forced" in opts else None,
                    strat=strat if "strat" in opts else None, tracer_kappa=kappa,
                    tracer_upwind=upwind)

    # f64 kernel against plain: (n, levels, channel, tiled_step's tile for
    # the linear core, FB's q's); the deep cases' columns and u as phases
    # 15 and 17 (60 m, 0.5 m/s), their tiles the planners'
    worst, n_checks = {}, 0
    f64_cases = [(16, 4, channel, (4, 8), (1, 2), 0.01, 10.0) for channel in (False, True)]
    f64_cases += [(HEADLINE_N, 36, channel, None, (1, 2), 0.5, 60.0 / 36)
                  for channel in (False, True)]
    f64_cases += [(HEADLINE_N, LEVELS, channel, None, (1,), 0.5, 60.0 / LEVELS)
                  for channel in (False, True)]
    for n, levels, channel, tile, fb_qs, u_amp, layer in f64_cases:
        model, prog = (random_channel if channel else random_case)(n, levels, seed=5,
                                                                   u_amp=u_amp, layer=layer)
        sm = model.struct_mesh
        st_t = with_tracers(model, model.to_struct(prog))
        forcing = lattice_forcing(model, seed=11 + levels)
        rng = np.random.default_rng(19 + levels)
        strat = mt.make_stratification(1025.0 + np.cumsum(rng.random(levels)) * (2.0 / levels))
        name = (f"f64 {n}x{n}x{levels} {'channel' if channel else 'periodic'}, layers of "
                f"{layer:.4g} m, u {u_amp} m/s")
        tk = {} if tile is None else dict(row_tile=tile[0], col_tile=tile[1])
        for opts in combos:
            st = st_t if "tracers" in opts else bare(st_t)
            refs = {fb: structured_run_loop(st, sm, 10.0, COMPOSED_CHECK_STEPS, fb=fb,
                                            **run_kw(opts, forcing, strat))
                    for fb in (False, True)}
            runs = [(f"auto {'FB' if fb else 'FE'}", fb,
                     lambda o, fb=fb: structured_auto_run_loop(
                         st_t if "tracers" in o else bare(st_t), sm, 10.0, COMPOSED_CHECK_STEPS,
                         fb=fb, **run_kw(o, forcing, strat)))
                    for fb in (False, True)]
            if "nonlinear" not in opts:
                runs += [(f"tiled {'FB' if fb else 'FE'} q={q}", fb,
                          lambda o, fb=fb, q=q: tiled_run_loop(
                              st_t if "tracers" in o else bare(st_t), sm, 10.0,
                              COMPOSED_CHECK_STEPS, q=q, fb=fb, **tk,
                              **run_kw(o, forcing, strat)))
                         for fb in (False, True) for q in (fb_qs if fb else (1, 2))]
            line = []
            for label, fb, run in runs:
                zero_counts()
                out, again = run(opts), run(opts)
                c = counts()
                total = sum(v[0] for v in c.values())
                for i, opt in enumerate(("forced", "tracers", "strat")):
                    got = sum(v[1 + i] for v in c.values())
                    if got != (total if opt in opts else 0) or not total:
                        raise AssertionError(f"{name} {sorted(opts)} {label}: launch counts {c}")
                errs = errors(out, refs[fb], sm)
                err = max(r for _, r in errs.values())
                if not err <= 1e-12:
                    raise AssertionError(f"{name} {sorted(opts)} {label}: {format_errors(errs)}")
                if not same(out, again):
                    raise AssertionError(f"{name} {sorted(opts)} {label}: rerun differs")
                misses = {}
                for drop in sorted(opts):
                    if drop == "tracers":  # the tracers left where they started
                        misses[drop] = float((st_t.tracers - refs[fb].tracers).abs().max()
                                             / refs[fb].tracers.abs().max())
                    else:
                        bare_errs = field_errors(run(opts - {drop}), refs[fb],
                                                 sm.resting_thickness_sum)
                        misses[drop] = max(r for _, r in bare_errs.values())
                if not min(misses.values()) >= 100 * 1e-12:
                    raise AssertionError(f"{name} {sorted(opts)} {label}: a control misses by "
                                         f"only {misses}")
                if channel:
                    check_walls(out, sm, f"{name} {sorted(opts)} {label}")
                key = label.split()[0] + (" nonlinear" if "nonlinear" in opts else "")
                worst[key] = max(worst.get(key, 0.0), err)
                line.append((label, err, min(misses.values())))
                n_checks += 1
            log(f"[19] {name}, {'+'.join(o for o in COMPOSED_OPTIONS if o in opts)}, "
                f"{COMPOSED_CHECK_STEPS} steps: worst error over scale (smallest control miss) "
                + ", ".join(f"{lbl} {e:.3e} ({m:.2e})" for lbl, e, m in line))
        del model, st_t, sm
        torch.cuda.empty_cache()
    log(f"[19] {n_checks} f64 composed checks, reruns bitwise equal, walls +0 on the channel; "
        "worst relative errors over every field and the tracers: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()) + f" ({time.perf_counter() - t_phase:.1f} "
        "s into the phase)")

    # physics on the card, f64, all four options through both routes: equal
    # densities against the unstratified composed arm; S = 35 kept and each
    # tracer's content sum(h T) conserved (the lattice's cells share one
    # area; culled cells hold h = 0)
    def content(x):
        return (x.layer_thickness[:, :, :, None] * x.tracers).sum((0, 1, 2, 4))

    for channel in (False, True):
        model, prog = (random_channel if channel else random_case)(HEADLINE_N, 36, seed=5,
                                                                   u_amp=0.5, layer=60.0 / 36)
        sm = model.struct_mesh
        st = with_tracers(model, model.to_struct(prog))
        live = torch.ones_like(st.tracers[:, :, :, 1]) if sm.cell_mask is None else \
            sm.cell_mask.to(st.tracers.dtype)[..., None].expand_as(st.tracers[:, :, :, 1])
        tr = st.tracers.clone()
        tr[:, :, :, 1] = 35.0 * live
        st = StructState(st.ssh, st.layer_thickness, st.normal_velocity, tr)
        forcing = lattice_forcing(model, seed=23)
        eq = mt.make_stratification([1026.0] * 36)
        strat = mt.make_stratification(1025.0 + np.linspace(0.0, 2.0, 36))
        where = "channel" if channel else "periodic"
        for fb in (False, True):
            kw = dict(nonlinear=True, fb=fb, forcing=forcing, tracer_kappa=5.0, tracer_upwind=0.5)
            a = structured_auto_run_loop(st, sm, 10.0, COMPOSED_CHECK_STEPS, strat=eq, **kw)
            b = structured_auto_run_loop(st, sm, 10.0, COMPOSED_CHECK_STEPS, **kw)
            eq_err = max(r for _, r in errors(a, b, sm).values())
            out = structured_auto_run_loop(st, sm, 10.0, COMPOSED_CHECK_STEPS, strat=strat, **kw)
            s_gap = float(((out.tracers[:, :, :, 1] - 35.0) * live).abs().max() / 35.0)
            drift = float(((content(out) - content(st)) / content(st)).abs().max())
            log(f"[19] physics f64 64x64x36 {where}, all four options, {'FB' if fb else 'FE'}, "
                f"{COMPOSED_CHECK_STEPS} steps: equal densities vs the unstratified composed arm "
                f"{eq_err:.3e} (limit 1e-12), uniform S = 35 kept to {s_gap:.3e} (limit 1e-12), "
                f"tracer content drift {drift:.3e} (limit 1e-12)")
            if not (eq_err <= 1e-12 and s_gap <= 1e-12 and drift <= 1e-12):
                raise AssertionError(f"composed physics {where} {'FB' if fb else 'FE'}")
        del model, st, sm

    # f32, 100 steps of bench.py's full-physics cell: the IGW (and the
    # Kelvin channel, kappa 5) with the nonlinear core, bench.py's forcing,
    # its two tracers and densities 1025 + linspace(0, 1, LEVELS); each
    # field's distance from an f64 plain run within U_GAP_FACTOR x the plain
    # f32 run's (the tracers' within that of the larger of it and
    # TRACER_F32_FLOOR f32 epsilons of their scale); the plain run with its
    # state stored in bf16 after each step must miss that bound in some field
    bench_rho = 1025.0 + np.linspace(0.0, BENCH_RHO_SPAN, LEVELS)
    strat32 = mt.make_stratification(bench_rho, dtype=np.float32)
    strat64 = mt.make_stratification(bench_rho)
    all_opts = frozenset(COMPOSED_OPTIONS)

    max_abs_err, gaps = {}, {}
    tfields = FIELDS + ("tracers",)
    for key, case, kappa in (("64", igw_case, BENCH_TRACER_KAPPA),
                             ("channel 64", kelvin_case, 5.0)):
        horz, _, model, prog = case(HEADLINE_N, LEVELS, np.float32)
        horz64, _, model64, _ = case(HEADLINE_N, LEVELS, np.float64)
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=bench_tracers(horz, LEVELS, np.float32)))
        sm, sm64 = model.struct_mesh, model64.struct_mesh
        st64 = StructState(*(getattr(st, f).double() for f in tfields))
        f32, f64 = bench_forcing(horz, model, np.float32), bench_forcing(horz64, model64,
                                                                         np.float64)
        flow = "Kelvin channel" if case is kelvin_case else "IGW"
        for fb in (False, True):
            arm = "tiled_step FB" if fb else "fe_step FE"
            kw = dict(nonlinear=True, fb=fb, tracer_kappa=kappa, tracer_upwind=BENCH_TRACER_UPWIND)
            out = structured_auto_run_loop(st, sm, DT, TILED_CHECK_STEPS, forcing=f32,
                                           strat=strat32, **kw)
            ref = structured_run_loop(st, sm, DT, TILED_CHECK_STEPS, forcing=f32, strat=strat32,
                                      **kw)
            ref64 = structured_run_loop(st64, sm64, DT, TILED_CHECK_STEPS, forcing=f64,
                                        strat=strat64, **kw)
            bf = st
            for _ in range(TILED_CHECK_STEPS):
                bf = structured_run_loop(bf, sm, DT, 1, forcing=f32, strat=strat32, **kw)
                bf = StructState(*(getattr(bf, f).bfloat16().float() for f in tfields))
            what = (f"f32 {HEADLINE_N}^2x{LEVELS} {flow}, all four options, kappa {kappa}, "
                    f"{TILED_CHECK_STEPS} steps, {arm}")
            ratios, control_fails = [], False
            for f in tfields:
                d = lambda x: float((getattr(x, f).double()  # noqa: E731
                                     - getattr(ref64, f)).abs().max())
                g_k, g_p, g_b = d(out), d(ref), d(bf)
                floor = (TRACER_F32_FLOOR * float(np.finfo(np.float32).eps)
                         * float(ref64.tracers.abs().max()) if f == "tracers" else 0.0)
                limit = U_GAP_FACTOR * max(g_p, floor)
                log(f"[19] {what}: {f}'s distance from the f64 plain run: kernel {g_k:.3e}, "
                    f"plain f32 {g_p:.3e}: kernel x{g_k / limit:.3f} of the limit {limit:.3e}; "
                    f"bf16 control {g_b:.3e} (x{g_b / limit:.1f})")
                if not g_k <= limit:
                    raise AssertionError(f"{what}: {f} {g_k:.3e} from f64, limit {limit:.3e}")
                control_fails = control_fails or g_b > limit
                ratios.append(g_k / limit)
            if not control_fails:
                raise AssertionError(f"{what}: the bf16 control passes")
            if sm.cell_mask is not None:
                check_walls(out, sm, what)
            errs = errors(out, ref, sm)
            log(f"[19] {what}, kernel vs plain f32: {format_errors(errs)}")
            gaps[arm, key] = ratios
            max_abs_err[arm, key] = max(e for e, _ in errs.values())
        del st, st64, out, ref, ref64, bf
        torch.cuda.empty_cache()

    # the gradient of each combination runs on the card (phase 20 holds it
    # against the plain reverse)
    horz, _, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    sm = model.struct_mesh
    st_t = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                             prog.normal_velocity,
                                             tracers=bench_tracers(horz, LEVELS, np.float32)))
    forcing = bench_forcing(horz, model, np.float32)
    ran = 0
    for opts in combos:
        st = st_t if "tracers" in opts else bare(st_t)
        kw = run_kw(opts, forcing, strat32, 0.0, 1.0)
        for route in (auto_rollout_diff, tiled_rollout_diff):
            if not grad_runs(route, st, sm, 2, **kw):
                raise AssertionError(f"the gradient {route.__name__} with {sorted(opts)} is not "
                                     "finite")
            ran += 1
    log(f"[19] the gradient of every combination runs on the card, finite: {ran} calls "
        "(auto_rollout_diff and tiled_rollout_diff)")

    # the main paths from to_struct: bench.py's full-physics cell, each path
    # from its own zeroed counts, then timed (CUDA events, REPS each) beside
    # each option alone in the same call: composed, nonlinear, forced,
    # tracers, stratified
    times, launches, walls = {}, {}, {}
    tracer_states = {}
    alone = [("composed", all_opts)] + [(o, frozenset([o])) for o in COMPOSED_OPTIONS]
    for label, case, n, fb, n_steps, kappa in (
            ("FE 64", igw_case, HEADLINE_N, False, HEADLINE_STEPS, BENCH_TRACER_KAPPA),
            ("FB 64", igw_case, HEADLINE_N, True, LARGE_MAIN_STEPS, BENCH_TRACER_KAPPA),
            ("FE 256", igw_case, LARGE_N, False, LARGE_MAIN_STEPS, BENCH_TRACER_KAPPA),
            ("FB 256", igw_case, LARGE_N, True, LARGE_MAIN_STEPS, BENCH_TRACER_KAPPA),
            ("FE channel 64", kelvin_case, HEADLINE_N, False, LARGE_MAIN_STEPS, 5.0)):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        if horz.n_cells not in tracer_states:
            tracer_states[horz.n_cells] = bench_tracers(horz, LEVELS, np.float32)
        ptr = mt.PrognosticVars(prog.ssh, prog.layer_thickness, prog.normal_velocity,
                                tracers=tracer_states[horz.n_cells])
        forcing = bench_forcing(horz, model, np.float32)
        arm = "tiled_step" if fb else "fe_step"
        zero_counts()
        t0 = time.perf_counter()
        final = model.from_struct(structured_auto_run_loop(
            model.to_struct(ptr), sm, DT, n_steps, fb=fb,
            **run_kw(all_opts, forcing, strat32, kappa, BENCH_TRACER_UPWIND)))
        walls[label] = time.perf_counter() - t0
        c = counts()
        log(f"[19] main path: {label}^2x{LEVELS} f32, bench.py's full physics (nonlinear, forcing "
            f"wind 0.1 Pa r_lin 1e-4 lambda 1e-5, two tracers kappa {kappa} upwind 1, densities "
            f"1025 + linspace(0, {BENCH_RHO_SPAN}, {LEVELS})), from to_struct, {n_steps} steps: "
            f"{walls[label]:.3f} s wall (to_struct .. from_struct); launches (all, forced, "
            f"tracers, stratified) {c} (want {arm} {n_steps}, every one of every arm)")
        other = "fe_step" if fb else "tiled_step"
        if c[arm] != (n_steps,) * 4 or c[other][0] != 0:
            raise AssertionError(f"composed {label}: launch counts {c}")
        if not (all(bool(torch.isfinite(getattr(final, f)).all()) for f in tfields)
                and tuple(final.tracers.shape) == (horz.n_cells, 2, LEVELS)
                and tuple(final.layer_thickness.shape) == (horz.n_cells, LEVELS)):
            raise AssertionError(f"composed {label}: output not finite or of the wrong shape")
        launches[label] = c[arm][0]
        st_w = model.to_struct(ptr)
        times[label] = {}
        # at the headline, where the composed arm's time goes: the nonlinear
        # core with each other option, and the linear core's composed arm
        pairs = [(f"nonlinear+{o}", frozenset(["nonlinear", o]))
                 for o in ("forced", "tracers", "strat")] + [
            ("forced+tracers+strat", frozenset(["forced", "tracers", "strat"]))]
        for name, opts in alone + (pairs if label == "FE 64" else []):
            s = st_w if "tracers" in opts else bare(st_w)
            kw = run_kw(opts, forcing, strat32, kappa, BENCH_TRACER_UPWIND)
            times[label][name] = timed_rollout(
                lambda m, s=s, kw=kw: structured_auto_run_loop(s, sm, DT, m, fb=fb, **kw),
                n_steps, REPS)[1]
        masked = sm.cell_mask is not None
        dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
        live = 2 * sm.ny2 * sm.nx if not masked else int(sm.cell_mask.sum())
        b, by = composed_bound(*dims, all_opts, masked=masked)
        med = {k: statistics.median(v) for k, v in times[label].items()}
        log(f"[19] {arm} {label}^2x{LEVELS} f32 composed (all four): "
            f"{spread(times[label]['composed'], 1e6, 'us')} per step, "
            f"{live * LEVELS / med['composed']:.4e} cells*levels*steps/s; bound {b * 1e6:.3f} us "
            f"({by}): {b / med['composed']:.4f} of it; each option alone: " + ", ".join(
                f"{o} {spread(times[label][o], 1e6, 'us')} (bound "
                f"{composed_bound(*dims, {o}, masked=masked)[0] * 1e6:.3f} us)"
                for o in COMPOSED_OPTIONS) + f"; composed / nonlinear alone "
            f"x{med['composed'] / med['nonlinear']:.4f} [{gpu}]")
        if label == "FE 64":
            log(f"[19] {arm} {label}^2x{LEVELS} f32, two and three options: " + ", ".join(
                f"{name} {spread(times[label][name], 1e6, 'us')} (bound "
                f"{composed_bound(*dims, opts, masked=masked)[0] * 1e6:.3f} us)"
                for name, opts in pairs) + f" [{gpu}]")
    # the plain versions' times with all four options, 64^2 FE and 256^2 FB
    plain = {}
    for label, n, fb in (("FE 64", HEADLINE_N, False), ("FB 256", LARGE_N, True)):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=tracer_states[horz.n_cells]))
        kw = run_kw(all_opts, bench_forcing(horz, model, np.float32), strat32, BENCH_TRACER_KAPPA,
                    BENCH_TRACER_UPWIND)
        plain[label] = timed_rollout(lambda m, st=st, sm=model.struct_mesh, fb=fb, kw=kw:
                                     structured_run_loop(st, sm, DT, m, fb=fb, **kw),
                                     10, REPS)[1]
        log(f"[19] plain {label} f32, all four options: {spread(plain[label], 1e3, 'ms')} per "
            f"step [{gpu}]")
    plans = {}
    for fb, n in ((False, HEADLINE_N), (True, LARGE_N)):
        plan = fe_step.nl_plan(n // 2, n, LEVELS, 4, fb, forced=True, n_tracers=2, strat=True)
        plans[fb] = list(plan)
        log(f"[19] the nonlinear {'FB (tiled_step)' if fb else 'FE (fe_step)'} composed arm's "
            f"plan at {n}^2 x {LEVELS} f32 (rows, columns, levels per slice): {plan}, "
            f"{fe_step.nl_smem_bytes(plan[:2], LEVELS, 4, fb, plan[2], True, 2, True)} bytes of "
            f"shared memory per block, one block per SM; plain nonlinear plan "
            f"{fe_step.nl_plan(n // 2, n, LEVELS, 4, fb)}")
    log(f"[19] phase 19 took {time.perf_counter() - t_phase:.1f} s")

    med = statistics.median
    d64 = (HEADLINE_N // 2, HEADLINE_N, LEVELS, 48, 4)
    d256 = (LARGE_N // 2, LARGE_N, LEVELS, 48, 4)

    def entry(name, src, replaces, launches_n, err, ms, plain_ms, bound, extra):
        b, by = bound
        return {"name": name, "route": "cuda", "source": f"mpas_ocean_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches_n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b * 1e3, "bound_by": by, "library_ms": None,
                **extra}

    def alone_ms(label):
        return {f"{o}_alone_ms": med(times[label][o]) * 1e3 for o in COMPOSED_OPTIONS}

    pair_ms = {f"{name.replace('+', '_')}_ms": med(times["FE 64"][name]) * 1e3
               for name, _ in pairs}

    return [
        entry("fe_step (composed arm: nonlinear, forced, tracers, stratified)",
              "nl_step.cuh",
              "mpas_ocean_tpu/structured/pallas_model.py:320 (_step_planes :91-299 with nl, "
              "forc, tr and strat_w)", launches["FE 64"], max_abs_err["fe_step FE", "64"],
              med(times["FE 64"]["composed"]) * 1e3, med(plain["FE 64"]) * 1e3,
              composed_bound(*d64, all_opts),
              {**alone_ms("FE 64"), **pair_ms,
               "ms_256": med(times["FE 256"]["composed"]) * 1e3,
               "bound_ms_256": composed_bound(*d256, all_opts)[0] * 1e3,
               "masked_ms_64": med(times["FE channel 64"]["composed"]) * 1e3,
               "cells_levels_steps_per_s_64": HEADLINE_N ** 2 * LEVELS
               / med(times["FE 64"]["composed"]),
               "main_path_wall_s": walls["FE 64"],
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "fe_step FE"},
               "max_rel_err_f64": worst.get("auto nonlinear"), "plan_64": plans[False],
               "sources": ["mpas_ocean_tpu_torch/csrc/nl_step.cuh",
                           "mpas_ocean_tpu_torch/csrc/nl_step_fe_f32.cu",
                           "mpas_ocean_tpu_torch/csrc/fe_step.cu"]}),
        entry("tiled_step (composed arm: nonlinear FB, forced, tracers, stratified)",
              "nl_step.cuh",
              "mpas_ocean_tpu/structured/pallas_model.py:852 (_window_steps :802 with nl, forc, "
              "tr and strat_w)", launches["FB 256"], max_abs_err["tiled_step FB", "64"],
              med(times["FB 256"]["composed"]) * 1e3, med(plain["FB 256"]) * 1e3,
              composed_bound(*d256, all_opts),
              {**alone_ms("FB 256"), "ms_64": med(times["FB 64"]["composed"]) * 1e3,
               "f32_gap_ratios": {k: v for (a, k), v in gaps.items() if a == "tiled_step FB"},
               "max_rel_err_f64_linear_q12": worst.get("tiled"), "plan_256": plans[True],
               "sources": ["mpas_ocean_tpu_torch/csrc/nl_step.cuh",
                           "mpas_ocean_tpu_torch/csrc/nl_step_fb_f32.cu",
                           "mpas_ocean_tpu_torch/csrc/tiled_step.cu"]}),
    ]


# ---- phase 20: the composed reverse -------------------------------------------

# Reverse steps of the composed reverse's f64 checks, and the launches of a
# held_us timing (one reverse call over a stack of that many states)
COMPOSED_REV_STEPS, COMPOSED_HELD_STEPS = 6, 40
# Calls of the stratified pass's wrapper timed together at each size
PASS_TIMED = 20


def strat_pass_bound(ny2: int, nx: int, k: int, itemsize: int, peaks: dict | None = None):
    """(bound seconds, "bytes" or "operations") of one launch of the
    nonlinear reverse's stratified pass: h and S read, dh read and written,
    W read, d(W) (K x K doubles) and a d(dt) share written, over the byte
    rate; its two products' 2 K^2 operations per cell each, W S at the
    dtype's FMA rate and d(W) at the FP64 tensor cores' (the data sheet's,
    or the f64 FMA ceiling where higher, as composed_bound takes it), which
    run side by side: the larger of the two."""
    cells = 2 * ny2 * nx
    nbytes = itemsize * (4 * cells * k + k * k) + 8 * (k * k + 1)
    peaks = CEILING if peaks is None else peaks
    t_bytes = nbytes / byte_rate(peaks, itemsize * cells * k)
    ops = 2 * cells * k * k
    t_ops = max(ops / peaks["flops"][itemsize], ops / max(DATASHEET["mma64"], peaks["flops"][8]))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def strat_pass_section(gpu: str) -> dict:
    """The nonlinear reverse's stratified pass alone (csrc/adjoint_window.cuh,
    strat_pass_kernel, through adjoint_step.nl_strat_pass) against its plain
    version structured.adjoint.strat_pass: f64 on random (h, S, W, dh) at
    64^2 and 256^2 x 100 and a ragged 9 x 14 x 36 lattice, dh within 1e-12
    of its scale, d(W) and d(dt) within 1e-12 of their terms' magnitudes,
    reruns bitwise; f32 on integer data whose d(W) sums are exact in
    double, d(W) bitwise those sums; f32 at the main paths' shapes, a call
    of the wrapper (the launch and the two sums a rollout call makes once)
    by held_us over PASS_TIMED calls, beside its bound and the plain
    version. Returns the numbers the kernels line reports."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.kernels import adjoint_step
    from mpas_ocean_tpu_torch.structured.adjoint import _own_minus_incoming, strat_pass
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    dev = torch.device("cuda")
    dt, inv_dc = DT, HEADLINE_N / 10000.0e3

    def operands(ny2, nx, k, dtype, seed=5):
        rng = np.random.default_rng(seed)
        shape = (2, ny2, nx, k)
        return tuple(torch.from_numpy(x).to(device=dev, dtype=dtype) for x in (
            50.0 + rng.normal(size=shape), rng.normal(size=shape),
            0.05 * rng.normal(size=(k, k)), rng.normal(size=shape)))

    def run(h, s, w, dh):
        k = h.shape[-1]
        dh = dh.clone()
        dstrat = torch.zeros((k, k), dtype=torch.float64, device=dev)
        ddt = torch.zeros(1, dtype=torch.float64, device=dev)
        adjoint_step.nl_strat_pass(h, s, w, dh, dt, inv_dc, dstrat, ddt)
        return dh, dstrat, ddt[0]

    worst, max_abs = 0.0, 0.0
    for ny2, nx, k in ((HEADLINE_N // 2, HEADLINE_N, LEVELS), (LARGE_N // 2, LARGE_N, LEVELS),
                       (9, 14, 36)):
        h, s, w, dh0 = operands(ny2, nx, k, torch.float64)
        got, again = run(h, s, w, dh0), run(h, s, w, dh0)
        dh_w, d_w, d_dt = strat_pass(h, s, w, dt, inv_dc)
        want = dh0 + dh_w
        sums = h.reshape(-1, k).abs().T @ s.reshape(-1, k).abs()
        errs = (float((got[0] - want).abs().max()) / float(want.abs().max()),
                float((got[1] - d_w).abs().max()) / (dt * inv_dc * float(sums.max())),
                abs(float(got[2] - d_dt)) / (inv_dc * float((w.abs() * sums).sum())))
        log(f"[20] stratified pass f64 {ny2}x{nx}x{k} vs plain: dh, d(W), d(dt) "
            + ", ".join(f"{e:.3e}" for e in errs) + " of scale")
        if not max(errs) <= 1e-12:
            raise AssertionError(f"stratified pass f64 {ny2}x{nx}x{k}: {errs}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"stratified pass f64 {ny2}x{nx}x{k}: reruns differ")
        worst = max(worst, *errs)
        del h, s, w, dh0, got, again, want, sums
    for n in (HEADLINE_N, LARGE_N):
        mesh, stack, g = integer_strat_case(n)
        h = stack[1][0].contiguous()
        s = _own_minus_incoming(g.normal_velocity).contiguous()
        dstrat = torch.zeros((LEVELS, LEVELS), dtype=torch.float64, device=dev)
        ddt = torch.zeros(1, dtype=torch.float64, device=dev)
        adjoint_step.nl_strat_pass(h, s, torch.eye(LEVELS, dtype=torch.float32, device=dev),
                                   torch.zeros_like(h), 1.0, 1.0 / mesh.dc, dstrat, ddt)
        exact = h.reshape(-1, LEVELS).double().T @ (s.reshape(-1, LEVELS).double() / mesh.dc)
        if not torch.equal(dstrat, exact):
            raise AssertionError(f"stratified pass f32 {n}^2 integer data: d(W) "
                                 f"{float((dstrat - exact).abs().max()):.3e} off the exact sums")
        log(f"[20] stratified pass f32 {n}^2x{LEVELS} on integer data: d(W) bitwise the exact "
            f"sums in double")
        del mesh, stack, g, h, s
    out = {"max_rel_err_f64": worst}
    for n in (HEADLINE_N, LARGE_N):
        h, s, w, dh = operands(n // 2, n, LEVELS, torch.float32)
        ref = run(*(x.double() for x in (h, s, w, dh)))
        got = run(h, s, w, dh)
        max_abs = max(max_abs, float((got[0].double() - ref[0]).abs().max()))
        dstrat = torch.zeros((LEVELS, LEVELS), dtype=torch.float64, device=dev)
        ddt = torch.zeros(1, dtype=torch.float64, device=dev)
        # a call of the wrapper: the pass's launch and the two kernels that
        # sum its d(W) partials and d(dt) shares (a rollout call's once)
        times = held_us(lambda: [adjoint_step.nl_strat_pass(h, s, w, dh, dt, inv_dc, dstrat, ddt)
                                 for _ in range(PASS_TIMED)], PASS_TIMED, REPS)
        plain = cuda_times(lambda: strat_pass(h, s, w, dt, inv_dc), REPS)
        (b, by), sheet = strat_pass_bound(n // 2, n, LEVELS, 4), strat_pass_bound(
            n // 2, n, LEVELS, 4, DATASHEET)[0]
        us = statistics.median(times)
        log(f"[20] stratified pass f32 {n}x{n}x{LEVELS}: {spread(times, 1, 'us')} a call (the "
            f"pass and its two sums, held_us over {PASS_TIMED}); bound {b * 1e6:.3f} us ({by}; "
            f"{sheet * 1e6:.3f} at the data sheet's rates): {b * 1e6 / us:.4f} of it; plain "
            f"{spread(plain, 1e3, 'ms')}; {adjoint_step.strat_pass_groups(n * n)} groups of 2 "
            f"blocks [{gpu}]")
        key = "" if n == HEADLINE_N else "_256"
        out.update({f"ms{key}": us / 1e3, f"bound_ms{key}": b * 1e3, f"bound_by{key}": by,
                    f"plain_ms{key}": statistics.median(plain) * 1e3})
        del h, s, w, dh, ref, got
    out["max_abs_err"] = max_abs
    torch.cuda.empty_cache()
    return out


@functools.lru_cache(maxsize=None)
def integer_strat_case(n: int):
    """One f32 reverse step whose d(W) sums are exact in double, on the card
    (tests/torch_gpu_cases.py's integer_strat_case at n x n x LEVELS): the
    periodic lattice at 1024 m spacing, h = 2^20 + integers 0 .. 1023, u and
    ssh 0, the cotangent of u integers -7 .. 7 (the others 0); with dt = 1 s
    every product h dPhi and every sum of them in double is exact.
    Returns (StructMesh, the one-slot (ssh, h, u) stack, the cotangent);
    built once per size and shared by phases 18 and 20, which only read it."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.structured import StructState

    horz = mt.planar_hex_mesh(n, n, 1024.0, f0=1e-4, dtype=np.float32)
    vert = mt.make_vertical_mesh(horz, LEVELS, resting_thickness=np.full(
        (horz.n_cells, LEVELS), 2.0 ** 20, dtype=np.float32), dtype=np.float32)
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n)
    rng = np.random.default_rng(31)
    h = (2.0 ** 20 + rng.integers(0, 1024, size=(horz.n_cells, LEVELS))).astype(np.float32)
    st = model.to_struct(mt.PrognosticVars(
        ssh=torch.zeros(horz.n_cells), layer_thickness=torch.from_numpy(h),
        normal_velocity=torch.zeros(horz.n_edges, LEVELS)))
    gu = rng.integers(-7, 8, size=tuple(st.normal_velocity.shape)).astype(np.float32)
    g = StructState(torch.zeros_like(st.ssh), torch.zeros_like(st.layer_thickness),
                    torch.from_numpy(gu).to(st.normal_velocity))
    return model.struct_mesh, tuple(getattr(st, f)[None].contiguous() for f in FIELDS), g


def composed_reverse_phase(gpu: str, log_text: str) -> list:
    """Phase 20, the composed reverse (every combination of two or more of
    the nonlinear core (N), forcing (F), tracers (T) and stratification (S)
    in kernels 3 and 4 and in kernel 1's stack rebuild): the composed
    reverse instantiations' ptxas lines; f64, each of the 11 combinations
    through the gradient's card steps (the nonlinear reverse kernel with N,
    adjoint_step and tiled_adjoint at q = 1 without) against the plain
    reverse on the kernel's own stack (mpas_ocean_tpu_torch/tools/
    composed_reverse.py), COMPOSED_REV_STEPS steps, 16^2 and 64^2 random
    states, periodic and channel, at 4, 36 and 100 levels: every cotangent
    within 1e-12 of its scale (d(dt), d(r_lin, Cd, lambda) and d(W) of their
    Cauchy-Schwarz scales), reruns bitwise, each run with one option dropped
    at least 100x off, the launches in every arm's counter; the stack
    rebuild with every arm bitwise the forward path's states; the
    dot-product identity at f64 over 7 steps with directions in the state,
    the tracers, the wind, the coefficients and W (NFTS and FTS, both
    routes); f32, 100 reverse steps of bench.py's full-physics cell (NFTS on
    the 64^2 x 100 IGW, the Kelvin channel and the 256^2 x 100 IGW, FTS on
    the 64^2 and 256^2 IGW; each kernel on its route's plan): each
    cotangent's distance from an f64 reverse of the same f32 states within
    U_GAP_FACTOR x the plain f32 reverse's (or phase 16's floor, and phase
    14's for the scalars), the plain reverse with bf16 cotangents failing
    it; the main paths from to_struct, the gradient of sum ssh^2 + sum T^2
    w.r.t. the state, dt, W, the wind and the coefficients (bench.py's
    full-physics 64^2 x 100 over GRAD_STEPS through auto_rollout_diff, the
    64^2 channel with kappa 5 over COMPOSED_SIDE_STEPS, 256^2 over
    LARGE_ADJ_STEPS through both routes, and the linear core's FTS at 64^2
    over COMPOSED_SIDE_STEPS and 256^2) with exact launch
    counts, the median of REPS with min and max; a profiler breakdown of
    the 64^2 gradient with the device's idle share; each composed arm per
    launch by held_us beside each option's reverse alone and its bound,
    with bench.py's tracer options (kappa 0, upwind 1), the main path's.
    Returns the kernels line's entries."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.models import Stratification, stratification_from_numpy
    from mpas_ocean_tpu_torch.models.forcing import Forcing
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        adjoint_plan,
        auto_rollout_diff,
        diff_model,
        fused_rollout_diff,
        structured_adjoint_step,
        structured_nl_adjoint_step,
        structured_run_loop,
        tiled_diff,
        tiled_rollout_diff,
    )
    from mpas_ocean_tpu_torch.tools.composed_reverse import (
        COMPOSED_COMBOS,
        COMPOSED_KAPPA,
        COMPOSED_UPWIND,
        composed_ddt_scale,
        composed_errors,
        composed_reverse,
        composed_stack,
        composed_state,
        composed_steps,
        plain_composed_reverse,
    )
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    t_phase = time.perf_counter()
    log(f"[20] device memory held at the phase's start: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    # the composed reverse instantiations: the nonlinear kernel with any of
    # (kForced, kTracers, kStrat), the linear ones with two or more of them
    for line in (ptxas_report(log_text, ("nl_adjoint_kernel",),
                              ("Lb1EEEv", "Lb1ELb0EEEv", "Lb1ELb0ELb0EEEv"))
                 + ptxas_report(log_text, ("adjoint_step_kernel", "tiled_adjoint_kernel"),
                                ("Lb1ELb1ELb0EEEv", "Lb1ELb0ELb1EEEv", "Lb1ELb1EEEv"))):
        log(f"[20] ptxas {line}")
    tfields = FIELDS + ("tracers",)
    kinds = (("fe_step", fe_step, ""), ("adjoint_step", adjoint_step, ""),
             ("nl_adjoint", adjoint_step, "nl_"), ("tiled_adjoint", tiled_adjoint, ""))
    arm_names = ("launches", "forced_launches", "tracer_launches", "strat_launches")

    def zero_counts():
        for _, m, pre in kinds:
            for c in arm_names:
                setattr(m, pre + c, 0)
        adjoint_step.nl_strat_pass_launches = 0

    def counts():
        c = {name: tuple(getattr(m, pre + c) for c in arm_names) for name, m, pre in kinds}
        c["strat_pass"] = (adjoint_step.nl_strat_pass_launches,)
        return c

    def want(kernel, n, opts):
        """The counts a run of n launches of ``kernel`` with ``opts``' arms
        makes, every other kernel at 0 (the stratified pass: one after each
        stratified nonlinear reverse launch)."""
        c = {name: (0,) * 4 for name, _, _ in kinds}
        c[kernel] = (n, *(n if o in opts else 0 for o in "FTS"))
        c["strat_pass"] = (n if kernel == "nl_adjoint" and "S" in opts else 0,)
        return c

    with_tracers = random_tracers

    def random_g(st, seed):
        rng = np.random.default_rng(seed)
        return StructState(*(None if getattr(st, f) is None else torch.from_numpy(
            rng.normal(size=tuple(getattr(st, f).shape))).to(getattr(st, f)) for f in tfields))

    def full_case(n, levels, channel, layer, u_amp=0.5):
        """A random f64 state with two tracers, random winds, levels and
        coefficients, and a dense random W (std 0.05)."""
        model, prog = (random_channel if channel else random_case)(n, levels, seed=5,
                                                                   u_amp=u_amp, layer=layer)
        st = with_tracers(model, model.to_struct(prog))
        rng = np.random.default_rng(29 + levels)
        strat = stratification_from_numpy({"phi_weights": 0.05 * rng.normal(size=(levels, levels)),
                                           "densities": np.full(levels, 1025.0)})
        return model, st, lattice_forcing(model, seed=11 + levels), strat

    def same(a, b) -> bool:
        return all(getattr(a[0], f) is None or torch.equal(getattr(a[0], f), getattr(b[0], f))
                   for f in tfields) and all(x is None or torch.equal(x, y)
                                             for x, y in zip(a[1:], b[1:]))

    def bare(stack):  # a stack without its tracer planes
        return StructState(stack.ssh, stack.layer_thickness, stack.normal_velocity)

    def tiled_tile(st, sm, n, opts):
        return tiled_diff._plan(st, sm, n, None, "N" in opts, "S" in opts, "F" in opts)[:2]

    # f64 against the plain reverse on the kernel's own stack: (n, levels,
    # channel, layer)
    n_rev = COMPOSED_REV_STEPS
    worst, n_checks, rebuilt = {}, 0, 0
    f64_cases = [(16, 4, channel, 10.0) for channel in (False, True)]
    f64_cases += [(HEADLINE_N, levels, channel, 60.0 / levels)
                  for levels in (36, LEVELS) for channel in (False, True)]
    for n, levels, channel, layer in f64_cases:
        model, st_full, forcing, strat = full_case(n, levels, channel, layer)
        sm = model.struct_mesh
        g_full = random_g(st_full, 17)
        name = (f"f64 {n}x{n}x{levels} {'channel' if channel else 'periodic'}, layers of "
                f"{layer:.4g} m, u 0.5 m/s")
        parts = []
        for opts in COMPOSED_COMBOS:
            st, g = composed_state(st_full, opts), composed_state(g_full, opts)
            steps = composed_steps(sm, 10.0, st.layer_thickness, opts, forcing, strat)
            stack = composed_stack(steps, st, n_rev)
            if opts in ("NFTS", "FTS") and n == HEADLINE_N:
                # the rebuild: slot j against j steps of the forward path
                src = diff_model._planes_state(st)
                for j in (1, n_rev - 1, n_rev):
                    out, scratch = diff_model._empty(src), diff_model._empty(src)
                    steps.advance(src, out, j, scratch)
                    if not all(torch.equal(a, b) for a, b in zip(
                            diff_model._fields(out), diff_model._fields(diff_model._slot(stack, j)))):
                        raise AssertionError(f"{name} {opts}: the stack's slot {j} is not the "
                                             f"forward path's {j} steps")
                    rebuilt += 1
            ref, scales = plain_composed_reverse(stack, g, sm, 10.0, n_rev, opts, forcing, strat)
            scales["d_dt"] = composed_ddt_scale(st, sm, 10.0, n_rev, g, opts, forcing, strat)
            # the tiled route: the linear combinations at 4 and 36 levels, the
            # nonlinear ones (the same kernel on the route's tile) at 16^2
            tiled = levels < LEVELS and ("N" not in opts or n < HEADLINE_N)
            routes = [("fused", None)] + ([("tiled", tiled_tile(st, sm, n_rev, opts))]
                                          if tiled else [])
            for route, tl in routes:
                kernel = ("nl_adjoint" if "N" in opts
                          else "adjoint_step" if tl is None else "tiled_adjoint")
                zero_counts()
                out = composed_reverse(composed_steps(sm, 10.0, st.layer_thickness, opts, forcing,
                                                      strat, tl), stack, g, n_rev)
                again = composed_reverse(composed_steps(sm, 10.0, st.layer_thickness, opts,
                                                        forcing, strat, tl), stack, g, n_rev)
                c = counts()
                if any(c[m] != w for m, w in want(kernel, 2 * n_rev, opts).items()
                       if m != "fe_step"):
                    raise AssertionError(f"{name} {opts} {route}: launch counts {c}")
                errs = composed_errors(out, ref, scales)
                err = max(r for _, r in errs.values())
                if not err <= 1e-12:
                    raise AssertionError(f"{name} {opts} {route}: {format_errors(errs)}")
                if not same(out, again):
                    raise AssertionError(f"{name} {opts} {route}: rerun differs")
                misses = {}
                for drop in opts:
                    rest = opts.replace(drop, "")
                    tl_r = tl and tiled_tile(composed_state(st_full, rest), sm, n_rev, rest)
                    d = composed_reverse(composed_steps(sm, 10.0, st.layer_thickness, rest,
                                                        forcing, strat, tl_r),
                                         bare(stack) if drop == "T" else stack,
                                         composed_state(g_full, rest), n_rev)
                    misses[drop] = max(float((getattr(d[0], f) - getattr(ref[0], f)).abs().max()
                                             / getattr(ref[0], f).abs().max())
                                       for f in tfields if getattr(d[0], f) is not None)
                if not min(misses.values()) >= 100 * 1e-12:
                    raise AssertionError(f"{name} {opts} {route}: a control misses by only "
                                         f"{misses}")
                key = f"{kernel} {route}"
                worst[key] = max(worst.get(key, 0.0), err)
                parts.append(f"{opts} {route} {err:.2e} ({min(misses.values()):.1e})")
                n_checks += 1
            del stack, steps
        log(f"[20] {name}, {n_rev} reverse steps: worst error over scale (smallest drop-one "
            "control miss) " + ", ".join(parts))
        del model, st_full, g_full, sm
        torch.cuda.empty_cache()
    log(f"[20] {n_checks} f64 composed reverse checks of the 11 combinations, reruns bitwise "
        f"equal, drop-one controls >= 100x off; {rebuilt} stack slots bitwise the forward path's; "
        "worst relative errors: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({time.perf_counter() - t_phase:.1f} s into the phase)")

    # the dot-product identity, f64, 7 steps, directions in the state, the
    # tracers, the wind, the coefficients and W; all four options and the
    # linear core's three, through both routes
    model, st, forcing, strat = full_case(32, 6, False, 10.0)
    sm = model.struct_mesh
    v, gbar = random_g(st, 18), random_g(st, 19)
    rng = np.random.default_rng(20)
    v_wind = torch.from_numpy(1e-4 * rng.normal(size=tuple(forcing.wind_edge.shape))).to(
        forcing.wind_edge)
    v_coefs = [torch.tensor(x, dtype=torch.float64, device=st.ssh.device)
               for x in (1e-4, 3e-4, 1e-5)]
    v_w = torch.from_numpy(0.05 * rng.normal(size=(6, 6))).to(st.ssh)
    coefs0 = (forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh)
    w0 = strat.phi_weights.to(st.ssh)
    dots = {}
    for opts in ("NFTS", "FTS"):
        def rollout7(*xs, nl="N" in opts):
            f = Forcing(xs[4], forcing.top_mask, forcing.bottom_mask, *xs[5:8])
            out = structured_run_loop(StructState(*xs[:4]), sm, 10.0, 7, nonlinear=nl, forcing=f,
                                      tracer_kappa=COMPOSED_KAPPA, tracer_upwind=COMPOSED_UPWIND,
                                      strat=Stratification(xs[8], strat.densities))
            return tuple(getattr(out, f) for f in tfields)

        prim = (*(getattr(st, f) for f in tfields), forcing.wind_edge, *coefs0, w0)
        tang = (*(getattr(v, f) for f in tfields), v_wind, *v_coefs, v_w)
        _, jv = torch.func.jvp(rollout7, prim, tang)
        lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, tfields))
        for label, route, kw in (("fused_rollout_diff", fused_rollout_diff, dict(plan=3)),
                                 ("tiled_rollout_diff", tiled_rollout_diff,
                                  dict(plan=(4, 8, 1, 3)))):
            x = [p.clone().requires_grad_(True) for p in prim]
            f = Forcing(x[4], forcing.top_mask, forcing.bottom_mask, *x[5:8])
            out = route(StructState(*x[:4]), sm, 10.0, 7, nonlinear="N" in opts, forcing=f,
                        tracer_kappa=COMPOSED_KAPPA, tracer_upwind=COMPOSED_UPWIND,
                        strat=Stratification(x[8], strat.densities), **kw)
            inner = sum((getattr(out, f) * getattr(gbar, f)).sum() for f in tfields)
            jtg = torch.autograd.grad(inner, x)
            rhs = sum(float((t * d).sum()) for t, d in zip(tang, jtg))
            dots[opts, label] = abs(lhs - rhs) / abs(rhs)
            log(f"[20] f64 dot-product identity, {opts}, 32x32x6, 7 steps, directions in the "
                f"state, tracers, wind, coefficients and W, {label}: <Jv, g> {lhs:.17g}, "
                f"<v, J^T g> {rhs:.17g}, relative gap {dots[opts, label]:.3e}")
            if not dots[opts, label] <= 1e-12:
                raise AssertionError(f"{opts} {label}: dot-product identity off by "
                                     f"{dots[opts, label]:.3e}")
    del model, st, sm

    # f32, 100 reverse steps of bench.py's full-physics cell (bench.py's
    # tracers, forcing and densities; kappa 5, upwind 0.5) at 64^2 and
    # 256^2, each kernel on its route's plan (the fused route's, and the
    # tiled route's tile: tiled_adjoint, or the nonlinear kernel on it), from
    # the cotangent of sum ssh^2 + sum T^2 at step 100: each cotangent's distance
    # from an f64 reverse of the same f32 primal states within U_GAP_FACTOR x
    # the plain f32 reverse's or the floor, whichever is larger: for the
    # fields (the tracers' and d(wind) among them) TRACER_REV_F32_FLOOR f32
    # epsilons of their scale (phase 16's), for the scalars d(dt) and
    # d(r_lin, Cd, lambda) SCALAR_FLOOR of their magnitude (phase 14's), for
    # d(W) none (phase 18's); the plain reverse with its cotangents stored in
    # bf16 after each step must miss that
    strat32 = mt.make_stratification(1025.0 + np.linspace(0.0, BENCH_RHO_SPAN, LEVELS),
                                     dtype=np.float32)
    eps32 = float(np.finfo(np.float32).eps)
    gaps, max_abs_err = {}, {}
    n32 = TILED_CHECK_STEPS
    for key, case, n, opts, kernels in (
            ("64", igw_case, HEADLINE_N, "NFTS", (("nl_adjoint", "fused"),)),
            ("channel 64", kelvin_case, HEADLINE_N, "NFTS", (("nl_adjoint", "fused"),)),
            ("64 linear", igw_case, HEADLINE_N, "FTS",
             (("adjoint_step", "fused"), ("tiled_adjoint", "tiled"))),
            ("256", igw_case, LARGE_N, "NFTS", (("nl_adjoint", "fused"), ("nl_adjoint", "tiled"))),
            ("256 linear", igw_case, LARGE_N, "FTS",
             (("adjoint_step", "fused"), ("tiled_adjoint", "tiled")))):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=bench_tracers(horz, LEVELS, np.float32)))
        forcing = bench_forcing(horz, model, np.float32)
        steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat32)
        stack = composed_stack(steps, st, n32)
        end = diff_model._lattice_state(diff_model._slot(stack, n32))
        g = StructState(2 * end.ssh, torch.zeros_like(end.layer_thickness),
                        torch.zeros_like(end.normal_velocity), 2 * end.tracers)
        del end  # a view of the stack (16 GB at 256^2)
        ref64, scales = plain_composed_reverse(stack, g, sm, DT, n32, opts, forcing, strat32,
                                               dtype=torch.float64)
        p32, _ = plain_composed_reverse(stack, g, sm, DT, n32, opts, forcing, strat32)
        bf, _ = plain_composed_reverse(stack, g, sm, DT, n32, opts, forcing, strat32,
                                       store=lambda x: x.bfloat16().float())
        flow = "Kelvin channel" if case is kelvin_case else "IGW"
        magnitude = {"d_dt": abs(float(ref64[1]))}
        if ref64[3] is not None:
            magnitude.update(zip(("d_r_lin", "d_cd", "d_lambda"),
                                 (abs(float(x)) for x in ref64[3])))
        scales.update(magnitude)  # the scalars' errors over their magnitudes
        for kernel, route in kernels:
            tl = tiled_tile(st, sm, n32, opts) if route == "tiled" else None
            out = composed_reverse(composed_steps(sm, DT, st.layer_thickness, opts, forcing,
                                                  strat32, tl), stack, g, n32)
            what = (f"f32 {n}^2x{LEVELS} {flow}, {opts}, bench.py's tracers, forcing and "
                    f"densities, {n32} reverse steps, {kernel} on the {route} route"
                    f"{'' if tl is None else f' tile {tuple(tl)}'}")
            e_k, e_p, e_b = (composed_errors(x, ref64, scales) for x in (out, p32, bf))
            ratios, control_fails, parts = {}, False, []
            for f in e_k:
                scale = e_k[f][0] / e_k[f][1] if e_k[f][1] else 0.0
                floor = (SCALAR_FLOOR * magnitude[f] if f in magnitude else 0.0 if f == "d_w"
                         else TRACER_REV_F32_FLOOR * eps32 * scale)
                limit = U_GAP_FACTOR * max(e_p[f][0], floor)
                ratios[f] = e_k[f][0] / limit
                control_fails = control_fails or e_b[f][0] > limit
                parts.append(f"{f} kernel {e_k[f][0]:.3e}, plain {e_p[f][0]:.3e}, floor "
                             f"{floor:.3e}: x{ratios[f]:.3f} of the limit; bf16 {e_b[f][0]:.3e} "
                             f"(x{e_b[f][0] / limit:.1f})")
                if not e_k[f][0] <= limit:
                    raise AssertionError(f"{what}: {f} {e_k[f][0]:.3e} from the f64 reverse, "
                                         f"limit {limit:.3e}")
            log(f"[20] {what}: distance from an f64 reverse of the same f32 states: "
                + "; ".join(parts))
            if not control_fails:
                raise AssertionError(f"{what}: the bf16 control passes")
            gaps[kernel, route, key] = ratios
            max_abs_err[kernel, route, key] = max(e for e, _ in composed_errors(out, p32,
                                                                                scales).values())
            del out
        del stack, ref64, p32, bf, st, steps, g
        torch.cuda.empty_cache()

    # the main paths from to_struct: the gradient of sum ssh^2 + sum T^2
    # w.r.t. the state, dt, W, the wind and the coefficients, each path from
    # its own zeroed counts, then timed (REPS)
    def grad_full(route, s, sm, n_steps, forcing, kappa, **kw):
        leaves = [getattr(s, f).clone().requires_grad_(True) for f in tfields]
        dt = torch.tensor(DT, dtype=torch.float32, device=s.ssh.device, requires_grad=True)
        w = strat32.phi_weights.to(s.ssh.device).clone().requires_grad_(True)
        fd = [getattr(forcing, c).clone().requires_grad_(True)
              for c in ("wind_edge", "drag_linear", "drag_quadratic", "rayleigh")]
        f = Forcing(fd[0], forcing.top_mask, forcing.bottom_mask, *fd[1:])
        out = route(StructState(*leaves), sm, dt, n_steps, forcing=f, tracer_kappa=kappa,
                    tracer_upwind=BENCH_TRACER_UPWIND,
                    strat=Stratification(w, strat32.densities), **kw)
        loss = (out.ssh ** 2).sum() + (out.tracers ** 2).sum()
        return out, torch.autograd.grad(loss, leaves + [dt, w] + fd)

    times, launches, walls, prof = {}, {}, {}, None
    for label, case, n, route, n_steps, nonlinear, kappa, kernel in (
            ("64 auto", igw_case, HEADLINE_N, auto_rollout_diff, GRAD_STEPS, True,
             BENCH_TRACER_KAPPA, "nl_adjoint"),
            ("channel 64 auto", kelvin_case, HEADLINE_N, auto_rollout_diff, COMPOSED_SIDE_STEPS,
             True, 5.0, "nl_adjoint"),
            ("256 tiled", igw_case, LARGE_N, tiled_rollout_diff, LARGE_ADJ_STEPS, True,
             BENCH_TRACER_KAPPA, "nl_adjoint"),
            ("256 fused", igw_case, LARGE_N, fused_rollout_diff, LARGE_ADJ_STEPS, True,
             BENCH_TRACER_KAPPA, "nl_adjoint"),
            ("64 linear auto", igw_case, HEADLINE_N, auto_rollout_diff, COMPOSED_SIDE_STEPS,
             False, BENCH_TRACER_KAPPA, "adjoint_step"),
            ("256 linear tiled", igw_case, LARGE_N, tiled_rollout_diff, LARGE_ADJ_STEPS, False,
             BENCH_TRACER_KAPPA, "tiled_adjoint")):
        horz, _, model, prog = case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        ptr = mt.PrognosticVars(prog.ssh, prog.layer_thickness, prog.normal_velocity,
                                tracers=bench_tracers(horz, LEVELS, np.float32))
        forcing = bench_forcing(horz, model, np.float32)
        kw = dict(nonlinear=nonlinear)
        zero_counts()
        t0 = time.perf_counter()
        out, grads = grad_full(route, model.to_struct(ptr), sm, n_steps, forcing, kappa, **kw)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        c = counts()
        st_w = model.to_struct(ptr)
        state_bytes = sum(f.numel() * 4 for f in state_fields(st_w)) + st_w.tracers.numel() * 4
        group = adjoint_plan(n_steps, state_bytes, math.inf)
        n_fe = 2 * n_steps - -(-n_steps // group)
        wants = want(kernel, n_steps, "FTS")
        wants["fe_step"] = (n_fe,) * 4
        log(f"[20] main path: grad of sum ssh^2 + sum T^2 w.r.t. the state, dt, W, the wind and "
            f"the coefficients through {route.__name__}, {n}^2x{LEVELS} f32 "
            f"{'channel' if case is kelvin_case else 'IGW'}, {'NFTS' if nonlinear else 'FTS'} "
            f"(bench.py's forcing, tracers with kappa {kappa}, densities), {n_steps} steps, groups "
            f"of {group}, from to_struct: {walls[label]:.3f} s wall [{gpu}]; launches (all, "
            f"forced, tracers, stratified) {c} (want {wants})")
        if c != wants:
            raise AssertionError(f"composed grad {label}: launch counts {c} != {wants}")
        if not all(bool(torch.isfinite(x).all()) for x in grads) or not all(
                float(x.abs().max()) > 0 for x in grads):
            raise AssertionError(f"composed grad {label}: a cotangent not finite, or zero")
        launches[label] = (c[kernel][0], c["fe_step"][0])
        # the counted run above was the warm-up
        times[label] = cuda_times(lambda: grad_full(route, st_w, sm, n_steps, forcing, kappa,
                                                    **kw), REPS, warm_up=False)
        log(f"[20] grad {label}, {n_steps} steps: {spread(times[label])} per grad (median of "
            f"{REPS}, min, max) [{gpu}]")
        if label == "64 auto":
            prof = profile_by_kernel(
                lambda: grad_full(route, st_w, sm, n_steps, forcing, kappa, **kw),
                ("fe_step_kernel", "nl_step_kernel", "nl_adjoint_kernel", "strat_pass_kernel",
                 "ddt_reduce", "strat_reduce"))
            log(f"[20] profiler, one full-physics grad at 64^2 ({prof[1]:.0f} us by events): "
                + profile_line(*prof, gpu))
        del out, grads, st_w
        torch.cuda.empty_cache()

    # each composed arm per launch (held_us over a COMPOSED_HELD_STEPS-step
    # call) beside each option's reverse alone, its bound and the plain
    # composed reverse step, with bench.py's tracer options (the main path's)
    log(f"[20] device memory held before the per-launch timings: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    n_h = COMPOSED_HELD_STEPS
    bench_tr = dict(kappa=BENCH_TRACER_KAPPA, upwind=BENCH_TRACER_UPWIND)
    per_launch, plain_ms, bounds = {}, {}, {}
    nl_arms = ("N", "NF", "NT", "NS", "NFTS")
    lin_arms = ("", "F", "T", "S", "FTS")
    for n in (HEADLINE_N, LARGE_N):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=bench_tracers(horz, LEVELS, np.float32)))
        forcing = bench_forcing(horz, model, np.float32)
        g = random_g(st, 20)
        for core, arms, tl in (("nl_adjoint", nl_arms, None), ("adjoint_step", lin_arms, None),
                               ("tiled_adjoint", lin_arms, "plan")):
            if core == "tiled_adjoint" and n == HEADLINE_N:
                continue
            full = arms[-1]
            stack = composed_stack(composed_steps(sm, DT, st.layer_thickness, full, forcing,
                                                  strat32, **bench_tr), composed_state(st, full),
                                   n_h)
            for opts in arms:
                tile = tiled_tile(composed_state(st, opts), sm, n_h, opts) if tl else None
                steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat32, tile,
                                       **bench_tr)
                s = stack if "T" in opts else bare(stack)
                go = composed_state(g, opts)
                per_launch[core, n, opts] = held_us(
                    lambda steps=steps, s=s, go=go: composed_reverse(steps, s, go, n_h), n_h, REPS)
            full_s = statistics.median(per_launch[core, n, full])
            dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
            opts_set = {"forced", "tracers", "strat"} | ({"nonlinear"} if "N" in full else set())
            bounds[core, n] = composed_bound(*dims, opts_set, reverse=True)
            b, by = bounds[core, n]
            log(f"[20] {core} per launch, {n}x{n}x{LEVELS} f32, bench.py's full physics (tracers "
                f"with kappa {BENCH_TRACER_KAPPA}, upwind {BENCH_TRACER_UPWIND}): "
                f"composed ({'+'.join(full) or 'linear'}) "
                f"{spread(per_launch[core, n, full], 1, 'us')}; bound {b * 1e6:.3f} us ({by}): "
                f"{b * 1e6 / full_s:.4f} of it; each option's reverse alone: " + ", ".join(
                    f"{o or 'core'} {spread(per_launch[core, n, o], 1, 'us')}"
                    for o in arms[:-1]) + f" [{gpu}]")
            del stack, s, steps, go  # s: the stack or a view of it
        # the plain composed reverse step, all four options
        steps = composed_steps(sm, DT, st.layer_thickness, "NFTS", forcing, strat32, **bench_tr)
        stack = composed_stack(steps, st, 1)
        s1 = diff_model._lattice_state(diff_model._slot(stack, 0))
        nxt = diff_model._lattice_state(diff_model._slot(stack, 1))
        plain_ms[n] = [t * 1e3 for t in cuda_times(lambda: structured_nl_adjoint_step(
            s1, g, sm, DT, forcing, tracer_kappa=BENCH_TRACER_KAPPA,
            tracer_upwind=BENCH_TRACER_UPWIND, next_state=nxt, strat=strat32), REPS)]
        lin_ms = [t * 1e3 for t in cuda_times(lambda: structured_adjoint_step(
            s1, g, sm, DT, forcing, tracer_kappa=BENCH_TRACER_KAPPA,
            tracer_upwind=BENCH_TRACER_UPWIND, next_state=nxt, strat=strat32), REPS)]
        plain_ms[n, "linear"] = lin_ms
        log(f"[20] plain composed reverse step, {n}x{n}x{LEVELS} f32: nonlinear "
            f"{spread(plain_ms[n], 1, 'ms')}, linear {spread(lin_ms, 1, 'ms')} [{gpu}]")
        plan = adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, n_tracers=2, strat=True)
        log(f"[20] the nonlinear reverse's composed plan at {n}^2 x {LEVELS} f32 (rows, columns, "
            f"levels per slice): {plan}, "
            f"{adjoint_step.nl_adjoint_smem_bytes(plan[:2], 4, plan[2], 2)} bytes "
            f"of shared memory per block, one block per SM; plain plan "
            f"{adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4)}; the stratified pass "
            f"{adjoint_step.strat_pass_groups(2 * sm.ny2 * sm.nx)} groups of 2 blocks, "
            f"(sub-chunk of cells, W's columns staged at once) "
            f"{adjoint_step.strat_pass_fit(LEVELS, 4)}")
        del stack, st, steps
        torch.cuda.empty_cache()
    sp = strat_pass_section(gpu)
    log(f"[20] phase 20 took {time.perf_counter() - t_phase:.1f} s")

    med = statistics.median

    def entry(name, src, replaces, kernel, route, label, n, plain, extra):
        b, by = bounds[kernel, n]
        full = "NFTS" if kernel == "nl_adjoint" else "FTS"
        size = ("64" if n == HEADLINE_N else "256") + ("" if kernel == "nl_adjoint" else " linear")
        return {"name": name, "route": "cuda", "source": f"mpas_ocean_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[label][0],
                "max_abs_err": max_abs_err[kernel, route, size],
                "ms": med(per_launch[kernel, n, full]) / 1e3, "plain_ms": med(plain),
                "bound_ms": b * 1e3, "bound_by": by, "library_ms": None,
                "fe_step_composed_launches": launches[label][1], **extra}

    def alone(kernel, n, arms):
        return {f"{o or 'core'}_ms": med(per_launch[kernel, n, o]) / 1e3 for o in arms[:-1]}

    summed = sum(t for t, _ in prof[0].values())
    pass_keys = {"strat_pass_launches": launches["64 auto"][0],
                 "strat_pass_ms": sp["ms"], "strat_pass_ms_256": sp["ms_256"],
                 "strat_pass_bound_ms": sp["bound_ms"],
                 "strat_pass_bound_ms_256": sp["bound_ms_256"]}
    return [
        {"name": "strat_pass (the nonlinear reverse's stratified pass)", "route": "cuda",
         "source": "mpas_ocean_tpu_torch/csrc/adjoint_window.cuh",
         "replaces": "mpas_ocean_tpu/structured/pallas_model.py:159 (the pressure's jnp.dot of h "
                     "and W inside _adjoint_segment_kernel's jax.vjp, :1480, transposed)",
         "launches": launches["64 auto"][0], "max_abs_err": sp["max_abs_err"],
         "ms": sp["ms"], "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
         "bound_by": sp["bound_by"], "library_ms": None, "ms_256": sp["ms_256"],
         "plain_ms_256": sp["plain_ms_256"], "bound_ms_256": sp["bound_ms_256"],
         "bound_by_256": sp["bound_by_256"], "max_rel_err_f64": sp["max_rel_err_f64"]},
        entry("nl_adjoint (composed arms: forced, tracers, stratified)", "nl_adjoint.cuh",
              "mpas_ocean_tpu/structured/pallas_model.py:1480 (nl_terms with the forced operands "
              ":1514-1520, gt_ref :1525-1526, sw_ref :1506-1510) and :1979 at q = 1",
              "nl_adjoint", "fused", "64 auto", HEADLINE_N, plain_ms[HEADLINE_N],
              {**alone("nl_adjoint", HEADLINE_N, nl_arms),
               "ms_256": med(per_launch["nl_adjoint", LARGE_N, "NFTS"]) / 1e3,
               "max_abs_err_256": max_abs_err["nl_adjoint", "fused", "256"],
               "max_abs_err_256_tiled": max_abs_err["nl_adjoint", "tiled", "256"],
               "bound_ms_256": bounds["nl_adjoint", LARGE_N][0] * 1e3,
               "plain_ms_256": med(plain_ms[LARGE_N]),
               "grad_s_64": times["64 auto"], "grad_s_64_channel": times["channel 64 auto"],
               "grad_s_256_tiled": times["256 tiled"], "grad_s_256_fused": times["256 fused"],
               "grad_64_idle_share": 1 - prof[2] / prof[1],
               "grad_64_overlap_us": summed - prof[2],
               "f32_gap_ratios": {k: gaps["nl_adjoint", "fused", k]
                                  for k in ("64", "channel 64", "256")},
               "f32_gap_ratios_256_tiled": gaps["nl_adjoint", "tiled", "256"],
               "max_rel_err_f64": worst.get("nl_adjoint fused"),
               "dot_gap": dots["NFTS", "fused_rollout_diff"], **pass_keys,
               "sources": ["mpas_ocean_tpu_torch/csrc/nl_adjoint.cuh",
                           "mpas_ocean_tpu_torch/csrc/nl_adjoint.cu",
                           "mpas_ocean_tpu_torch/csrc/nl_adjoint_f32.cu",
                           "mpas_ocean_tpu_torch/csrc/nl_adjoint_f32_forced.cu"]}),
        entry("adjoint_step (composed arms: forced, tracers, stratified)", "adjoint_step.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1480 (the forced operands :1514-1520, "
              "gt_ref :1521-1528, sw_ref :1506-1510 together)", "adjoint_step", "fused",
              "64 linear auto", HEADLINE_N, plain_ms[HEADLINE_N, "linear"],
              {**alone("adjoint_step", HEADLINE_N, lin_arms),
               "ms_256": med(per_launch["adjoint_step", LARGE_N, "FTS"]) / 1e3,
               "max_abs_err_256": max_abs_err["adjoint_step", "fused", "256 linear"],
               "grad_s_64_linear": times["64 linear auto"],
               "f32_gap_ratios": {k: gaps["adjoint_step", "fused", k]
                                  for k in ("64 linear", "256 linear")},
               "max_rel_err_f64": worst.get("adjoint_step fused"),
               "dot_gap": dots["FTS", "fused_rollout_diff"]}),
        entry("tiled_adjoint (composed arms at q = 1: forced, tracers, stratified)",
              "tiled_adjoint.cu",
              "mpas_ocean_tpu/structured/pallas_model.py:1979 (q = 1 with the forced operands, "
              "tracers0 and sw_ref together)", "tiled_adjoint", "tiled", "256 linear tiled",
              LARGE_N, plain_ms[LARGE_N, "linear"],
              {**alone("tiled_adjoint", LARGE_N, lin_arms),
               "grad_s_256_linear": times["256 linear tiled"],
               "max_abs_err_64": max_abs_err["tiled_adjoint", "tiled", "64 linear"],
               "f32_gap_ratios": gaps["tiled_adjoint", "tiled", "256 linear"],
               "f32_gap_ratios_64": gaps["tiled_adjoint", "tiled", "64 linear"],
               "max_rel_err_f64": worst.get("tiled_adjoint tiled"),
               "dot_gap": dots["FTS", "tiled_rollout_diff"]}),
    ]


# ---- phase 21: temporal blocking, q > 1 ---------------------------------------

# The forward's f64 checks: (levels, q) on the 32 x 32 lattice, whose 16
# rows a parity hold the FB q = 2 and FE q = 3 windows; the reverse's:
# (n, levels, q)
WINDOW_FWD_F64 = ((4, 2), (4, 3), (36, 2))
WINDOW_REV_F64 = ((16, 4, 2), (16, 4, 3), (32, 36, 2))
WINDOW_OPTS = ("", "F", "T", "S", "FT", "FS", "TS", "FTS")
WINDOW_REV_OPTS = ("T", "S", "TS", "FT", "FS", "FTS")
WINDOW_Q = 2
# supersteps of the reverse's f64 checks
WINDOW_REV_SS = 3
# steps of the timed forward runs at 256^2 (the q = 2 composed FB step
# takes 19 ms, so LARGE_MAIN_STEPS would cost phase 21 ~110 s more; the reps
# spread 0.1-0.7%; 200 until phase 22 took the run's budget, 100 until a
# run on a slower host reached 975 s by the end of phase 20) and at 64^2
# (LARGE_MAIN_STEPS until then, 200 until that run), and reverse steps of
# the held_us timings
WINDOW_TIMED_STEPS_256, WINDOW_HELD_STEPS = LARGE_MAIN_STEPS // 20, 16
WINDOW_TIMED_STEPS_64 = LARGE_MAIN_STEPS // 10
WINDOW_GRAD_STEPS = LARGE_ADJ_STEPS // 5


def window_bound(ny2: int, nx: int, k: int, n_terms: int, itemsize: int, opts, q: int,
                 reverse: bool = False):
    """(bound seconds, "bytes" or "operations") of one launch of a q-step
    kernel: the state (and tracers) read and written once, the operands
    once (``composed_bound``'s bytes of one step), and q steps' operations;
    with ``reverse``, one reverse superstep: one reverse step's bytes, q
    reverse steps' and q - 1 forward steps' (the recompute) operations."""
    t_bytes, t_ops = composed_bound(ny2, nx, k, n_terms, itemsize, opts, reverse=reverse,
                                    parts=True)
    t_ops *= q
    if reverse:
        t_ops += (q - 1) * composed_bound(ny2, nx, k, n_terms, itemsize, opts, parts=True)[1]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_tracers(model, st, seed: int = 3):
    """``st`` with two random tracers (a wave in x plus noise, and 35 plus
    noise), 0 on a channel's culled cells, in the state's dtype."""
    import numpy as np
    import torch

    from mpas_ocean_tpu_torch.structured import StructState

    ny2, nx, k = st.layer_thickness.shape[1:]
    rng = np.random.default_rng(seed)
    x = np.arange(nx)[None, None, :, None] / nx
    tr = np.stack([10.0 + 2.0 * np.sin(2 * np.pi * x) + 0.3 * rng.normal(size=(2, ny2, nx, k)),
                   35.0 + 0.3 * rng.normal(size=(2, ny2, nx, k))], axis=3)
    if model.cell_mask is not None:
        tr = tr * model.cell_mask.cpu().numpy()[..., None, None]
    return StructState(st.ssh, st.layer_thickness, st.normal_velocity,
                       torch.from_numpy(tr).to(st.layer_thickness))


def window_phase(gpu: str, log_text: str) -> list:
    """Phase 21, temporal blocking (q > 1): kernel 2's nonlinear arms at
    q > 1 (the q-step kernel, csrc/nl_tiled.cuh, FE at reach 2 and FB at
    reach 3) and kernel 4's tracer and stratified arms at q > 1
    (tiled_adjoint, with forcing too). The q-step instantiations' ptxas
    summary; f64, every combination of forcing (F), tracers (T) and
    stratification (S) with the nonlinear core through tiled_run_loop at
    q = 2, 3 (32^2 x 4 and x 36, periodic and channel, FE and FB) against
    the plain steps, and tiled_adjoint's T, S, TS, FT, FS and FTS at q = 2, 3
    (16^2 x 4, 32^2 x 36) against the plain reverse of every step: within
    1e-12 of scale (d(dt), d(W) and the forcing scalars of their
    Cauchy-Schwarz scales), reruns bitwise, each run with one option
    dropped at least 100x off, a composition no tile fits refused with
    ValueError; FB at q = 3 in f32 (its f64 windows fit no tile); the
    dot-product identity of the q = 2 FTS gradient with directions in the
    state, tracers, W, wind and coefficients; f32 after 100 steps (64^2 and
    256^2 x 100, bench.py's full physics, FE and FB at q = 2, and the FTS
    reverse at q = 2): each field's distance from f64 within U_GAP_FACTOR x
    the plain f32 run's (phases 19 and 20's floors), the plain run stored in
    bf16 failing it; the main paths from to_struct with exact launch counts
    (n / q); q = 2 against q = 1 in this call, median of REPS with min and
    max: the nonlinear FE and FB, alone and NFTS, at 256^2 x 100 over
    WINDOW_TIMED_STEPS_256 steps and at 64^2 over WINDOW_TIMED_STEPS_64, the FTS
    gradient at 256^2 over WINDOW_GRAD_STEPS steps, tiled_adjoint's q = 2 FTS
    arm per launch.
    Returns the kernels line's entries."""
    import re

    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import fe_step, tiled_adjoint, tiled_step
    from mpas_ocean_tpu_torch.models import Stratification, stratification_from_numpy
    from mpas_ocean_tpu_torch.models.forcing import Forcing
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        diff_model,
        fused_model,
        structured_adjoint_step,
        structured_run_loop,
        tiled_diff,
        tiled_model,
        tiled_rollout_diff,
        tiled_run_loop,
    )
    from mpas_ocean_tpu_torch.tools.composed_reverse import (
        composed_ddt_scale,
        composed_errors,
        composed_reverse,
        composed_stack,
        composed_state,
        composed_steps,
        plain_composed_reverse,
        plain_superstep_reverse,
        superstep_stack,
    )
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    t_phase = time.perf_counter()
    tfields = FIELDS + ("tracers",)
    kappa5 = dict(tracer_kappa=5.0, tracer_upwind=0.5)
    for name, kernels in (("nl_tiled_kernel", ("nl_tiled_kernel",)),
                          ("tiled_adjoint_kernel at q > 1",
                           ("tiled_adjoint_kernelIfLb1E", "tiled_adjoint_kernelIdLb1E"))):
        text = "\n".join(ptxas_report(log_text, kernels))
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"[21] ptxas {name}: {len(regs)} instantiations, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, spill stores up to {max(spills, default=0)} "
            "bytes")

    def case(n, levels, channel, opts, seed=5):
        model, prog = (random_channel if channel else random_case)(n, levels, seed=seed,
                                                                   u_amp=0.5)
        st = model.to_struct(prog)
        if "T" in opts:
            st = random_tracers(model, st)
        rng = np.random.default_rng(29 + levels)
        strat = stratification_from_numpy({"phi_weights": 0.05 * rng.normal(size=(levels,
                                                                                   levels)),
                                           "densities": np.full(levels, 1025.0)})
        return model, st, lattice_forcing(model, seed=11 + levels), strat

    def fwd_kw(opts, forcing, strat):
        return dict(forcing=forcing if "F" in opts else None,
                    strat=strat if "S" in opts else None, **kappa5)

    def fwd_errors(out, ref, sm):  # over each field's scale, the tracers' too
        errs = {f: r for f, (_, r) in field_errors(out, ref, sm.resting_thickness_sum).items()}
        if ref.tracers is not None:
            errs["tracers"] = float((out.tracers - ref.tracers).abs().max()
                                    / ref.tracers.abs().max())
        return errs

    def same(a, b):
        return all(getattr(a, f) is None or torch.equal(getattr(a, f), getattr(b, f))
                   for f in tfields)

    # f64 forward: the q-step kernel against the plain steps
    worst_f, n_fwd, refused = 0.0, 0, []
    for levels, q in WINDOW_FWD_F64:
        for channel in (False, True):
            model, st_full, forcing, strat = case(32, levels, channel, "T")
            sm = model.struct_mesh
            parts = []
            for fb in (False, True):
                for opts in WINDOW_OPTS:
                    st = composed_state(st_full, opts)
                    kw = fwd_kw(opts, forcing, strat)
                    arm = f"{'FB' if fb else 'FE'} q={q} {opts or '-'}"

                    def run(o=opts, s=st):
                        return tiled_run_loop(s, sm, 10.0, 2 * q, q=q, nonlinear=True, fb=fb,
                                              **fwd_kw(o, forcing, strat))

                    arms = dict(forced="F" in opts, n_tracers=2 * ("T" in opts),
                                strat="S" in opts)
                    tiles = [(r, c) for r in range(1, sm.ny2 + 1) if sm.ny2 % r == 0
                             for c in range(1, sm.nx + 1) if sm.nx % c == 0]
                    if all(fe_step.nl_smem_bytes(t, levels, 8, fb, 1, **arms, q=q)
                           > fe_step.SMEM_BYTES for t in tiles):
                        tiled_step.window_launches = 0
                        try:
                            run()
                        except ValueError as e:
                            if "shared memory" not in str(e) or tiled_step.window_launches:
                                raise
                            refused.append(f"{levels} levels {arm} "
                                           f"{'channel' if channel else 'periodic'}")
                            continue
                        raise AssertionError(f"f64 {arm} at {levels} levels: fits no tile, "
                                             "yet ran")
                    tiled_step.window_launches = tiled_step.launches = 0
                    out = run()
                    if (tiled_step.window_launches, tiled_step.launches) != (2, 2):
                        raise AssertionError(f"f64 {arm}: launches {tiled_step.window_launches}")
                    ref = structured_run_loop(st, sm, 10.0, 2 * q, nonlinear=True, fb=fb, **kw)
                    errs = fwd_errors(out, ref, sm)
                    err = max(errs.values())
                    if not err <= 1e-12:
                        raise AssertionError(f"f64 {arm} {levels} levels: {errs}")
                    if not same(out, run()):
                        raise AssertionError(f"f64 {arm}: rerun differs")
                    # each option dropped; the tracers, which the state does not
                    # feel, left where they started
                    miss = min([float((st.tracers - ref.tracers).abs().max()
                                      / ref.tracers.abs().max()) if d == "T" else
                                max(fwd_errors(run(opts.replace(d, ""),
                                                   composed_state(st_full,
                                                                  opts.replace(d, ""))),
                                               ref, sm).values()) for d in opts] or [1.0])
                    if not miss >= 100 * 1e-12:
                        raise AssertionError(f"f64 {arm}: a drop-one control misses by {miss}")
                    if channel:
                        check_walls(out, sm, f"f64 {arm} channel")
                    worst_f, n_fwd = max(worst_f, err), n_fwd + 1
                    parts.append(f"{arm} {err:.1e}")
            log(f"[21] f64 nonlinear q-step kernel vs plain steps, 32^2x{levels} "
                f"{'channel' if channel else 'periodic'}, 2q steps: " + ", ".join(parts))
            del model, st_full
    log(f"[21] {n_fwd} f64 forward checks within 1e-12 (worst {worst_f:.3e}), reruns bitwise, "
        f"drop-one controls >= 100x off; refused with ValueError naming the shared memory "
        f"(no tile fits): {', '.join(refused)}")

    # FB at q = 3 and FE and FB at q = 4 in f32 (their f64 windows fit no
    # block, refused with ValueError): the distance rule; FB at q = 4 with
    # all four options fits no block in f32 either
    eps32 = float(np.finfo(np.float32).eps)
    for fb, q, n in ((True, 3, 40), (False, 4, 52), (True, 4, 52)):
        for opts in ("", "FTS"):
            _, _, model, prog = igw_case(n, 4, np.float32)
            _, _, model64, prog64 = igw_case(n, 4, np.float64)
            sm, sm64 = model.struct_mesh, model64.struct_mesh
            st32 = composed_state(random_tracers(model, model.to_struct(prog)), opts)
            st64 = StructState(*(None if x is None else x.double() for x in
                                 (st32.ssh, st32.layer_thickness, st32.normal_velocity,
                                  st32.tracers)))
            rng = np.random.default_rng(33)
            w = 0.05 * rng.normal(size=(4, 4))
            s32, s64 = (stratification_from_numpy({"phi_weights": w.astype(t),
                                                   "densities": np.full(4, 1025.0, dtype=t)})
                        for t in (np.float32, np.float64))
            f32, f64 = lattice_forcing(model), lattice_forcing(model64)
            arm = f"{'FB' if fb else 'FE'} q = {q}"
            tiled_step.window_launches = 0
            try:
                tiled_run_loop(st64, sm64, DT, 2 * q, q=q, nonlinear=True, fb=fb,
                               **fwd_kw(opts, f64, s64))
            except ValueError as e:
                if "shared memory" not in str(e) or tiled_step.window_launches:
                    raise
            else:
                raise AssertionError(f"f64 {arm} {opts}: expected no tile to fit")
            if fb and q == 4 and opts:
                try:
                    tiled_run_loop(st32, sm, DT, 2 * q, q=q, nonlinear=True, fb=fb,
                                   **fwd_kw(opts, f32, s32))
                except ValueError as e:
                    if "shared memory" not in str(e) or tiled_step.window_launches:
                        raise
                    log(f"[21] f32 {arm} {opts}: no tile fits, refused with ValueError")
                    continue
                raise AssertionError(f"f32 {arm} {opts}: expected no tile to fit")
            out = tiled_run_loop(st32, sm, DT, 2 * q, q=q, nonlinear=True, fb=fb,
                                 **fwd_kw(opts, f32, s32))
            plain = structured_run_loop(st32, sm, DT, 2 * q, nonlinear=True, fb=fb,
                                        **fwd_kw(opts, f32, s32))
            ref = structured_run_loop(st64, sm64, DT, 2 * q, nonlinear=True, fb=fb,
                                      **fwd_kw(opts, f64, s64))
            if tiled_step.window_launches != 2:
                raise AssertionError(f"f32 {arm}: launch count {tiled_step.window_launches}")
            parts = []
            for f in tfields:
                if getattr(ref, f) is None:
                    continue
                r = getattr(ref, f)
                d_k = float((getattr(out, f).double() - r).abs().max())
                d_p = float((getattr(plain, f).double() - r).abs().max())
                floor = (TRACER_F32_FLOOR * eps32 * float(r.abs().max()) if f == "tracers"
                         else 0.0)
                limit = U_GAP_FACTOR * max(d_p, floor)
                if not d_k <= limit:
                    raise AssertionError(f"f32 {arm} {opts}: {f} {d_k:.3e} > {limit:.3e}")
                parts.append(f"{f} x{d_k / limit:.3f}")
            log(f"[21] f32 {arm}, the {n}^2x4 IGW {'+ ' + opts if opts else 'nonlinear alone'}, "
                f"{2 * q} steps in 2 launches (f64 refused: no tile fits): distance from an f64 "
                f"plain run over the limit: {', '.join(parts)}")
    torch.cuda.empty_cache()

    # f64 reverse: tiled_adjoint's q > 1 arms against the plain reverse of
    # every step on the kernel-built states
    n_ss, worst_r, n_rev = WINDOW_REV_SS, {}, 0
    for n, levels, q in WINDOW_REV_F64:
        for channel in (False, True):
            model, st_full, forcing, strat = case(n, levels, channel, "T")
            sm = model.struct_mesh
            rng = np.random.default_rng(17)
            g_full = StructState(*(None if getattr(st_full, f) is None else torch.from_numpy(
                rng.normal(size=tuple(getattr(st_full, f).shape))).to(getattr(st_full, f))
                for f in tfields))
            parts = []
            for opts in WINDOW_REV_OPTS:
                st, g = composed_state(st_full, opts), composed_state(g_full, opts)
                full = composed_stack(composed_steps(sm, 10.0, st.layer_thickness, opts, forcing,
                                                     strat), st, n_ss * q)

                def rev(o=opts, stk=full):
                    steps = composed_steps(sm, 10.0, st.layer_thickness, o, forcing, strat,
                                           (2, 4, q))
                    return composed_reverse(steps, superstep_stack(stk, q),
                                            composed_state(g_full, o), n_ss)

                for c in ("launches", "forced_launches", "tracer_launches", "strat_launches"):
                    setattr(tiled_adjoint, c, 0)
                out = rev()
                counts = [tiled_adjoint.launches, tiled_adjoint.forced_launches,
                          tiled_adjoint.tracer_launches, tiled_adjoint.strat_launches]
                if counts != [n_ss] + [n_ss * (o in opts) for o in "FTS"]:
                    raise AssertionError(f"f64 reverse {opts} q={q}: launch counts {counts}")
                ref, scales = plain_composed_reverse(full, g, sm, 10.0, n_ss * q, opts, forcing,
                                                     strat)
                scales["d_dt"] = composed_ddt_scale(st, sm, 10.0, n_ss * q, g, opts, forcing,
                                                    strat)
                errs = composed_errors(out, ref, scales)
                err = max(r for _, r in errs.values())
                if not err <= 1e-12:
                    raise AssertionError(f"f64 reverse {opts} q={q} {n}^2x{levels}: "
                                         f"{format_errors(errs)}")
                again = rev()
                if not (same(out[0], again[0]) and all(
                        x is None or torch.equal(x, y) for x, y in zip(out[1:], again[1:]))):
                    raise AssertionError(f"f64 reverse {opts} q={q}: rerun differs")
                misses = []
                for d in opts:
                    rest = opts.replace(d, "")
                    bare = rev(rest, full if d != "T" else StructState(
                        full.ssh, full.layer_thickness, full.normal_velocity))
                    misses.append(max(float((getattr(bare[0], f) - getattr(ref[0], f)).abs()
                                            .max() / getattr(ref[0], f).abs().max())
                                      for f in tfields if getattr(bare[0], f) is not None))
                if not min(misses) >= 100 * 1e-12:
                    raise AssertionError(f"f64 reverse {opts} q={q}: a control misses by "
                                         f"{misses}")
                worst_r[opts] = max(worst_r.get(opts, 0.0), err)
                n_rev += 1
                parts.append(f"{opts} {err:.1e} ({min(misses):.1e})")
                del full
            log(f"[21] f64 tiled_adjoint q={q} vs the plain reverse, {n}^2x{levels} "
                f"{'channel' if channel else 'periodic'}, {n_ss} supersteps: error over scale "
                "(least drop-one miss) " + ", ".join(parts))
            del model, st_full, g_full
            torch.cuda.empty_cache()
    log(f"[21] {n_rev} f64 reverse checks within 1e-12, reruns bitwise, controls >= 100x off; "
        "worst: " + ", ".join(f"{k} {v:.3e}" for k, v in worst_r.items()))

    # the dot-product identity of the q = 2 gradient, directions in the
    # state, tracers, W, the wind and the coefficients
    dots = {}
    for channel in (False, True):
        model, st, forcing, strat = case(32, 6, channel, "T")
        sm = model.struct_mesh
        rng = np.random.default_rng(18)
        v, gbar = (StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape)))
                                 .to(getattr(st, f)) for f in tfields)) for _ in range(2))
        tang = (*(getattr(v, f) for f in tfields),
                torch.from_numpy(1e-4 * rng.normal(size=tuple(forcing.wind_edge.shape))).to(
                    forcing.wind_edge),
                *(torch.tensor(x, dtype=torch.float64, device=st.ssh.device)
                  for x in (1e-4, 3e-4, 1e-5)),
                torch.from_numpy(0.05 * rng.normal(size=(6, 6))).to(st.ssh))
        prim = (*(getattr(st, f) for f in tfields), forcing.wind_edge, forcing.drag_linear,
                forcing.drag_quadratic, forcing.rayleigh, strat.phi_weights.to(st.ssh))

        def rollout(*xs):
            f = Forcing(xs[4], forcing.top_mask, forcing.bottom_mask, *xs[5:8])
            out = structured_run_loop(StructState(*xs[:4]), sm, 10.0, 6, forcing=f,
                                      strat=Stratification(xs[8], strat.densities), **kappa5)
            return tuple(getattr(out, f) for f in tfields)

        _, jv = torch.func.jvp(rollout, prim, tang)
        lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, tfields))
        x = [p.clone().requires_grad_(True) for p in prim]
        tiled_adjoint.launches = 0
        out = tiled_rollout_diff(StructState(*x[:4]), sm, 10.0, 6,
                                 forcing=Forcing(x[4], forcing.top_mask, forcing.bottom_mask,
                                                 *x[5:8]),
                                 strat=Stratification(x[8], strat.densities),
                                 plan=(2, 4, WINDOW_Q, 1), **kappa5)
        jtg = torch.autograd.grad(sum((getattr(out, f) * getattr(gbar, f)).sum()
                                      for f in tfields), x)
        rhs = sum(float((t * d).sum()) for t, d in zip(tang, jtg))
        dots[channel] = abs(lhs - rhs) / abs(rhs)
        log(f"[21] f64 dot-product identity, FTS q = 2 through tiled_rollout_diff, 32x32x6 "
            f"{'channel' if channel else 'periodic'}, 6 steps ({tiled_adjoint.launches} "
            f"tiled_adjoint launches): <Jv, g> {lhs:.17g}, <v, J^T g> {rhs:.17g}, relative gap "
            f"{dots[channel]:.3e}")
        if not (dots[channel] <= 1e-12 and tiled_adjoint.launches == 3):
            raise AssertionError(f"q = 2 dot-product identity off by {dots[channel]:.3e}")
        del model, st
    log(f"[21] checks took {time.perf_counter() - t_phase:.1f} s")

    # f32, 100 steps of bench.py's full-physics cell at q = 2: the forward
    # (FE and FB) and the FTS reverse, at 64^2 and 256^2
    strat32 = mt.make_stratification(1025.0 + np.linspace(0.0, BENCH_RHO_SPAN, LEVELS),
                                     dtype=np.float32)
    strat64 = mt.make_stratification(1025.0 + np.linspace(0.0, BENCH_RHO_SPAN, LEVELS))
    bench_kw = dict(tracer_kappa=BENCH_TRACER_KAPPA, tracer_upwind=BENCH_TRACER_UPWIND)
    max_abs_err, gaps = {}, {}
    n32 = TILED_CHECK_STEPS
    for n in (HEADLINE_N, LARGE_N):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        horz64, _, model64, _ = igw_case(n, LEVELS, np.float64)
        sm, sm64 = model.struct_mesh, model64.struct_mesh
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=bench_tracers(horz, LEVELS, np.float32)))
        st64 = StructState(*(getattr(st, f).double() for f in tfields))
        f32, f64 = bench_forcing(horz, model, np.float32), bench_forcing(horz64, model64,
                                                                         np.float64)
        for fb in (False, True):
            kw = dict(nonlinear=True, fb=fb, **bench_kw)
            out = tiled_run_loop(st, sm, DT, n32, q=WINDOW_Q, forcing=f32, strat=strat32, **kw)
            ref = structured_run_loop(st, sm, DT, n32, forcing=f32, strat=strat32, **kw)
            ref64 = structured_run_loop(st64, sm64, DT, n32, forcing=f64, strat=strat64, **kw)
            bf = st
            for _ in range(n32):
                bf = structured_run_loop(bf, sm, DT, 1, forcing=f32, strat=strat32, **kw)
                bf = StructState(*(getattr(bf, f).bfloat16().float() for f in tfields))
            what = f"f32 {n}^2x{LEVELS} IGW NFTS {'FB' if fb else 'FE'} q = 2, {n32} steps"
            ratios, control_fails = [], False
            for f in tfields:
                d = lambda x: float((getattr(x, f).double()  # noqa: E731
                                     - getattr(ref64, f)).abs().max())
                g_k, g_p, g_b = d(out), d(ref), d(bf)
                floor = (TRACER_F32_FLOOR * eps32 * float(ref64.tracers.abs().max())
                         if f == "tracers" else 0.0)
                limit = U_GAP_FACTOR * max(g_p, floor)
                if not g_k <= limit:
                    raise AssertionError(f"{what}: {f} {g_k:.3e} from f64, limit {limit:.3e}")
                control_fails = control_fails or g_b > limit
                ratios.append(g_k / limit)
            if not control_fails:
                raise AssertionError(f"{what}: the bf16 control passes")
            gaps["fwd", fb, n] = ratios
            max_abs_err["fwd", fb, n] = max(float((getattr(out, f) - getattr(ref, f)).abs().max())
                                            for f in tfields)
            log(f"[21] {what}: distance from f64 over the limit {[f'{r:.3f}' for r in ratios]} "
                f"(fields, tracers); the bf16 control fails; max |kernel - plain f32| "
                f"{max_abs_err['fwd', fb, n]:.3e}")
            del out, ref, ref64, bf
        # the FTS reverse at q = 2 on the kernel-built superstep starts, the
        # plain reverse recomputing each superstep's inner state as the
        # kernel does (in f32, and in f64 from the same f32 starts)
        n_ss = n32 // WINDOW_Q
        tile = tiled_diff.tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, n32, halo=(1, 2),
                                             q=WINDOW_Q, n_tracers=2, strat=True,
                                             forced=True)[:2]
        steps = composed_steps(sm, DT, st.layer_thickness, "FTS", f32, strat32,
                               (*tile, WINDOW_Q))
        sup = composed_stack(steps, composed_state(st, "FTS"), n_ss)
        end = sup.ssh[n_ss], sup.tracers[n_ss]
        g = StructState(2 * end[0], torch.zeros_like(st.layer_thickness),
                        torch.zeros_like(st.normal_velocity),
                        2 * fused_model.tracer_unplanes(end[1]))
        del end
        ref64, scales = plain_superstep_reverse(sup, g, sm, DT, n_ss, WINDOW_Q, "FTS", f32,
                                                strat32, dtype=torch.float64)
        p32, _ = plain_superstep_reverse(sup, g, sm, DT, n_ss, WINDOW_Q, "FTS", f32, strat32)
        bf, _ = plain_superstep_reverse(sup, g, sm, DT, n_ss, WINDOW_Q, "FTS", f32, strat32,
                                        store=lambda x: x.bfloat16().float())
        out = composed_reverse(steps, sup, g, n_ss)
        magnitude = {"d_dt": abs(float(ref64[1]))}
        magnitude.update(zip(("d_r_lin", "d_cd", "d_lambda"), (abs(float(x)) for x in ref64[3])))
        scales.update(magnitude)
        e_k, e_p, e_b = (composed_errors(x, ref64, scales) for x in (out, p32, bf))
        ratios, control_fails = {}, False
        for f in e_k:
            scale = e_k[f][0] / e_k[f][1] if e_k[f][1] else 0.0
            floor = (SCALAR_FLOOR * magnitude[f] if f in magnitude else 0.0 if f == "d_w"
                     else TRACER_REV_F32_FLOOR * eps32 * scale)
            limit = U_GAP_FACTOR * max(e_p[f][0], floor)
            ratios[f] = e_k[f][0] / limit
            control_fails = control_fails or e_b[f][0] > limit
            if not e_k[f][0] <= limit:
                raise AssertionError(f"f32 FTS reverse q = 2 at {n}^2: {f} {e_k[f][0]:.3e}, "
                                     f"limit {limit:.3e}")
        if not control_fails:
            raise AssertionError(f"f32 FTS reverse q = 2 at {n}^2: the bf16 control passes")
        gaps["rev", n] = ratios
        max_abs_err["rev", n] = max(e for e, _ in composed_errors(out, p32, scales).values())
        log(f"[21] f32 {n}^2x{LEVELS} FTS reverse q = 2 (tile {tile}), {n32} reverse steps: "
            "distance from an f64 reverse of the same f32 superstep starts (the inner states "
            "recomputed in f64) over the limit " + ", ".join(
                f"{f} {r:.3f}" for f, r in ratios.items()) + "; the bf16 control fails")
        del sup, ref64, p32, bf, out, st, st64, steps
        torch.cuda.empty_cache()

    # the main paths from to_struct at q = 2, and q = 2 against q = 1 in this
    # call: the nonlinear arm alone and with all three options, FE and FB
    times, launches, walls, plain, plans = {}, {}, {}, {}, {}
    nfts = {"nonlinear", "forced", "tracers", "strat"}
    for n, n_steps in ((LARGE_N, WINDOW_TIMED_STEPS_256), (HEADLINE_N, WINDOW_TIMED_STEPS_64)):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        ptr = mt.PrognosticVars(prog.ssh, prog.layer_thickness, prog.normal_velocity,
                                tracers=bench_tracers(horz, LEVELS, np.float32))
        forcing = bench_forcing(horz, model, np.float32)
        for fb in (False, True):
            tiled_step.window_launches = tiled_step.launches = tiled_step.tracer_launches = 0
            tiled_step.forced_launches = tiled_step.strat_launches = fe_step.launches = 0
            t0 = time.perf_counter()
            fin = model.from_struct(tiled_run_loop(
                model.to_struct(ptr), sm, DT, n_steps, q=WINDOW_Q, nonlinear=True, fb=fb,
                forcing=forcing, strat=strat32, **bench_kw))
            walls[n, fb] = time.perf_counter() - t0
            c = (tiled_step.window_launches, tiled_step.launches, tiled_step.forced_launches,
                 tiled_step.tracer_launches, tiled_step.strat_launches, fe_step.launches)
            want = (n_steps // WINDOW_Q,) * 5 + (0,)
            log(f"[21] main path: tiled_run_loop(nonlinear=True, q=2, fb={fb}), {n}^2x{LEVELS} "
                f"f32, bench.py's full physics, from to_struct, {n_steps} steps: "
                f"{walls[n, fb]:.3f} s wall; launches (q-step kernel, tiled_step, forced, "
                f"tracers, stratified, fe_step) {c} (want {want}) [{gpu}]")
            if c != want:
                raise AssertionError(f"q = 2 main path {n} fb={fb}: launch counts {c}")
            if not all(bool(torch.isfinite(getattr(fin, f)).all()) for f in tfields):
                raise AssertionError(f"q = 2 main path {n} fb={fb}: output not finite")
            launches[n, fb] = c[0]
            st_w = model.to_struct(ptr)
            bare = StructState(st_w.ssh, st_w.layer_thickness, st_w.normal_velocity)
            for label, s, kw in (("N", bare, {}),
                                 ("NFTS", st_w, dict(forcing=forcing, strat=strat32,
                                                     **bench_kw))):
                for q in (1, WINDOW_Q):
                    times[n, fb, label, q] = timed_rollout(
                        lambda m, s=s, kw=kw, q=q: tiled_run_loop(s, sm, DT, m, q=q,
                                                                  nonlinear=True, fb=fb, **kw),
                        n_steps, REPS)[1]
            dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
            for q in (1, WINDOW_Q):
                plans[n, fb, q] = tiled_model._nl_tile(sm.ny2, sm.nx, LEVELS, 4,
                                                       (3 if fb else 2, 4), n_steps, q, fb,
                                                       dict(forced=True, n_tracers=2,
                                                            strat=True))
            b2, by2 = window_bound(*dims, nfts, WINDOW_Q)
            med2 = statistics.median(times[n, fb, "NFTS", WINDOW_Q]) * WINDOW_Q
            log(f"[21] {'FB' if fb else 'FE'} {n}^2x{LEVELS} f32 over {n_steps} steps, per step: "
                + "; ".join(f"{label} q=1 {spread(times[n, fb, label, 1], 1e6, 'us')}, q=2 "
                            f"{spread(times[n, fb, label, WINDOW_Q], 1e6, 'us')}, q=2/q=1 x"
                            f"{statistics.median(times[n, fb, label, WINDOW_Q]) / statistics.median(times[n, fb, label, 1]):.4f}"  # noqa: E501
                            for label in ("N", "NFTS"))
                + f"; NFTS q=2 per launch {med2 * 1e6:.3f} us against its bound {b2 * 1e6:.3f} us "
                f"({by2}): {b2 / med2:.4f} of it; NFTS plans q=1 {plans[n, fb, 1]}, q=2 "
                f"{plans[n, fb, WINDOW_Q]} [{gpu}]")
            if n == LARGE_N:
                s, kw = st_w, dict(nonlinear=True, fb=fb, forcing=forcing, strat=strat32,
                                   **bench_kw)
                plain[fb] = timed_rollout(lambda m: structured_run_loop(s, sm, DT, m, **kw),
                                          10, REPS)[1]
            del st_w, bare, fin
        del ptr
        torch.cuda.empty_cache()

    # the FTS gradient at 256^2 over WINDOW_GRAD_STEPS steps, q = 2 against
    # q = 1, and tiled_adjoint's q = 2 FTS arm per launch
    horz, _, model, prog = igw_case(LARGE_N, LEVELS, np.float32)
    sm = model.struct_mesh
    ptr = mt.PrognosticVars(prog.ssh, prog.layer_thickness, prog.normal_velocity,
                            tracers=bench_tracers(horz, LEVELS, np.float32))
    forcing = bench_forcing(horz, model, np.float32)

    def grad_fts(s, plan):
        leaves = [getattr(s, f).clone().requires_grad_(True) for f in tfields]
        w = strat32.phi_weights.to(s.ssh.device).clone().requires_grad_(True)
        fd = [getattr(forcing, c).clone().requires_grad_(True)
              for c in ("wind_edge", "drag_linear", "drag_quadratic", "rayleigh")]
        out = tiled_rollout_diff(StructState(*leaves), sm, DT, WINDOW_GRAD_STEPS,
                                 forcing=Forcing(fd[0], forcing.top_mask, forcing.bottom_mask,
                                                 *fd[1:]),
                                 strat=Stratification(w, strat32.densities), plan=plan,
                                 **bench_kw)
        loss = (out.ssh ** 2).sum() + (out.tracers ** 2).sum()
        return torch.autograd.grad(loss, leaves + [w] + fd)

    grad_s, rev_launches, rev_plans = {}, {}, {}
    for q in (1, WINDOW_Q):
        st_w = model.to_struct(ptr)
        plan = rev_plans[q] = tiled_diff.tiled_adjoint_plan(
            sm.ny2, sm.nx, LEVELS, 4, WINDOW_GRAD_STEPS, halo=(1, 2), q=q, n_tracers=2,
            strat=True, forced=True, budget=diff_model._default_budget(st_w.ssh.device))
        for c in ("launches", "forced_launches", "tracer_launches", "strat_launches"):
            setattr(tiled_adjoint, c, 0)
        grads = grad_fts(st_w, plan)
        c = [tiled_adjoint.launches, tiled_adjoint.forced_launches,
             tiled_adjoint.tracer_launches, tiled_adjoint.strat_launches]
        if c != [WINDOW_GRAD_STEPS // q] * 4 or not all(bool(torch.isfinite(x).all())
                                                        for x in grads):
            raise AssertionError(f"FTS grad q = {q}: launches {c}, or not finite")
        rev_launches[q] = c[0]
        grad_s[q] = cuda_times(lambda: grad_fts(st_w, plan), REPS, warm_up=False)
        log(f"[21] FTS grad of sum ssh^2 + sum T^2 (state, W, wind, coefficients) through "
            f"tiled_rollout_diff, {LARGE_N}^2x{LEVELS} f32, {WINDOW_GRAD_STEPS} steps, plan "
            f"{tuple(plan)}: {spread(grad_s[q])} per grad; tiled_adjoint launches {c[0]} (each "
            f"forced, tracer and stratified) [{gpu}]")
        del grads, st_w
    log(f"[21] FTS grad q = 2 / q = 1: x{statistics.median(grad_s[WINDOW_Q]) / statistics.median(grad_s[1]):.4f}")  # noqa: E501
    st = model.to_struct(ptr)
    n_h = WINDOW_HELD_STEPS
    full = composed_stack(composed_steps(sm, DT, st.layer_thickness, "FTS", forcing, strat32,
                                         kappa=BENCH_TRACER_KAPPA, upwind=BENCH_TRACER_UPWIND),
                          st, n_h)
    rng = np.random.default_rng(20)
    g = StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape))).to(
        getattr(st, f)) for f in tfields))
    per_launch = {}
    for q in (1, WINDOW_Q):
        plan = (*rev_plans[q][:2], q)
        steps = composed_steps(sm, DT, st.layer_thickness, "FTS", forcing, strat32, plan,
                               kappa=BENCH_TRACER_KAPPA, upwind=BENCH_TRACER_UPWIND)
        sup = superstep_stack(full, q)
        per_launch[q] = held_us(lambda steps=steps, sup=sup: composed_reverse(
            steps, sup, g, n_h // q), n_h // q, REPS)
        del sup
    dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
    rb, rby = window_bound(*dims, {"forced", "tracers", "strat"}, WINDOW_Q, reverse=True)
    s1 = diff_model._lattice_state(diff_model._slot(full, 0))
    nxt = diff_model._lattice_state(diff_model._slot(full, 1))
    plain_rev = [t * 1e3 for t in cuda_times(lambda: structured_adjoint_step(
        s1, g, sm, DT, forcing, next_state=nxt, strat=strat32, **bench_kw), REPS)]
    med_q2 = statistics.median(per_launch[WINDOW_Q])
    log(f"[21] tiled_adjoint FTS per launch (held_us), {LARGE_N}^2x{LEVELS} f32: q = 1 "
        f"{spread(per_launch[1], 1, 'us')} at {rev_plans[1][:2]}, q = 2 "
        f"{spread(per_launch[WINDOW_Q], 1, 'us')} at {rev_plans[WINDOW_Q][:2]} "
        f"(x{med_q2 / statistics.median(per_launch[1]):.4f}, per step "
        f"x{med_q2 / 2 / statistics.median(per_launch[1]):.4f}); q = 2 bound {rb * 1e6:.3f} us "
        f"({rby}): {rb * 1e6 / med_q2:.4f} of it; plain FTS reverse step "
        f"{spread(plain_rev, 1, 'ms')} [{gpu}]")
    del full, st, s1, nxt
    torch.cuda.empty_cache()
    log(f"[21] phase 21 took {time.perf_counter() - t_phase:.1f} s")

    med = statistics.median
    d256 = (LARGE_N // 2, LARGE_N, LEVELS, 48, 4)
    d64 = (HEADLINE_N // 2, HEADLINE_N, LEVELS, 48, 4)
    entries = []
    for fb in (False, True):
        arm = "FB" if fb else "FE"
        b, by = window_bound(*d256, nfts, WINDOW_Q)
        entries.append({
            "name": f"tiled_step (nonlinear q-step kernel, {arm}, q = 2: nonlinear, forced, "
                    "tracers, stratified)",
            "route": "cuda", "source": "mpas_ocean_tpu_torch/csrc/nl_tiled.cuh",
            "replaces": "mpas_ocean_tpu/structured/pallas_model.py:852 (_window_steps :802-849 "
                        f"with nl_terms, {'fb=True, reach 3' if fb else 'reach 2'}, q > 1)",
            "launches": launches[LARGE_N, fb],
            "max_abs_err": max_abs_err["fwd", fb, LARGE_N],
            "ms": med(times[LARGE_N, fb, "NFTS", WINDOW_Q]) * WINDOW_Q * 1e3,
            "plain_ms": med(plain[fb]) * WINDOW_Q * 1e3,
            "bound_ms": b * 1e3, "bound_by": by, "library_ms": None,
            "q": WINDOW_Q,
            "ms_per_step_q1": med(times[LARGE_N, fb, "NFTS", 1]) * 1e3,
            "ms_per_step_q2": med(times[LARGE_N, fb, "NFTS", WINDOW_Q]) * 1e3,
            "nonlinear_alone_ms_per_step_q1": med(times[LARGE_N, fb, "N", 1]) * 1e3,
            "nonlinear_alone_ms_per_step_q2": med(times[LARGE_N, fb, "N", WINDOW_Q]) * 1e3,
            "ms_per_step_64_q1": med(times[HEADLINE_N, fb, "NFTS", 1]) * 1e3,
            "ms_per_step_64_q2": med(times[HEADLINE_N, fb, "NFTS", WINDOW_Q]) * 1e3,
            "nonlinear_alone_ms_per_step_64_q1": med(times[HEADLINE_N, fb, "N", 1]) * 1e3,
            "nonlinear_alone_ms_per_step_64_q2": med(times[HEADLINE_N, fb, "N", WINDOW_Q]) * 1e3,
            "bound_ms_64": window_bound(*d64, nfts, WINDOW_Q)[0] * 1e3,
            "main_path_wall_s": walls[LARGE_N, fb],
            "f32_gap_ratios": gaps["fwd", fb, LARGE_N],
            "f32_gap_ratios_64": gaps["fwd", fb, HEADLINE_N],
            "max_rel_err_f64": worst_f,
            "sources": ["mpas_ocean_tpu_torch/csrc/nl_tiled.cuh",
                        f"mpas_ocean_tpu_torch/csrc/nl_tiled_{arm.lower()}_f32.cu"]})
    entries.append({
        "name": "tiled_adjoint (tracer and stratified arms at q = 2, with forcing: FTS)",
        "route": "cuda", "source": "mpas_ocean_tpu_torch/csrc/tiled_adjoint.cu",
        "replaces": "mpas_ocean_tpu/structured/pallas_model.py:1979 (q > 1 with tracers0, "
                    "sw_ref and the forced operands together)",
        "launches": rev_launches[WINDOW_Q],
        "max_abs_err": max_abs_err["rev", LARGE_N],
        "ms": med_q2 / 1e3, "plain_ms": med(plain_rev) * WINDOW_Q,
        "bound_ms": rb * 1e3, "bound_by": rby, "library_ms": None, "q": WINDOW_Q,
        "ms_q1": med(per_launch[1]) / 1e3,
        "grad_s_256_q2": grad_s[WINDOW_Q], "grad_s_256_q1": grad_s[1],
        "launches_q1": rev_launches[1],
        "max_abs_err_64": max_abs_err["rev", HEADLINE_N],
        "f32_gap_ratios": gaps["rev", LARGE_N], "f32_gap_ratios_64": gaps["rev", HEADLINE_N],
        "max_rel_err_f64": worst_r, "dot_gaps": [dots[False], dots[True]]})
    entries.append(nl_window_section(gpu, log_text))
    return entries


# ---- phase 21: kernel 4's nonlinear arm at q > 1 ----------------------------------

# the nonlinear core (N) alone and with forcing (F), tracers (T) and
# stratification (S) in every combination: the q-step nonlinear reverse's
# arms, each periodic and on the channel
NL_WIN_OPTS = ("N", "NF", "NT", "NS", "NFT", "NFS", "NTS", "NFTS")
# the f64 checks' lattice (n, levels) and supersteps; reverse steps of the
# held_us timings (4 launches at q = 2, 8 of the q = 1 kernel)
NL_WIN_F64, NL_WIN_SS, NL_WIN_HELD_STEPS = (32, 36), 2, 8


def nl_window_section(gpu: str, log_text: str) -> dict:
    """Phase 21's part for kernel 4's nonlinear arm at q > 1, the q-step
    nonlinear reverse (csrc/nl_window_adjoint.cuh): its instantiations'
    registers and spills per arm; f64, every arm (N with F, T and S in every
    combination, periodic and channel) at q = 2 and 3 on a 32^2 x 36 random
    state with u of 0.5 m/s, at the f32 main paths' tiles (nl_window_plan's
    at 256^2 x 100), against the plain reverse of every step on the
    kernel-built states: within 1e-12 of scale (d(dt), d(W) and the forcing
    scalars of their Cauchy-Schwarz scales), reruns bitwise, N_SS launches
    in every arm's counter, at q = 2 each run with one option dropped at
    least 100x off (N: the linear reverse of every step); the dot-product identity
    of the q = 2 NFTS gradient; f32 after 100 reverse steps (64^2 and 256^2
    x 100, bench.py's full physics, NFTS at q = 2): each cotangent's distance
    from an f64 reverse of the same superstep starts within U_GAP_FACTOR x
    the plain f32 reverse's (phase 20's floors), the plain reverse stored in
    bf16 failing it; the main path, tiled_rollout_diff(nonlinear=True,
    q = 2) with bench.py's full physics at 256^2 over LARGE_ADJ_STEPS steps,
    with exact launch counts (n / 2 in each arm's counter, none of the q = 1
    nonlinear reverse or the linear tiled reverse); the nonlinear gradient
    (N) at q = 2 and q = 1 there; per launch by held_us at 64^2 and 256^2,
    N and NFTS, q = 2 beside two q = 1 launches, and the bound. Returns the
    kernels line's entry."""
    import re

    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import adjoint_step, tiled_adjoint
    from mpas_ocean_tpu_torch.models import Stratification, stratification_from_numpy
    from mpas_ocean_tpu_torch.models.forcing import Forcing
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        diff_model,
        fused_model,
        structured_nl_adjoint_step,
        structured_run_loop,
        tiled_diff,
        tiled_rollout_diff,
    )
    from mpas_ocean_tpu_torch.tools.composed_reverse import (
        composed_ddt_scale,
        composed_errors,
        composed_reverse,
        composed_stack,
        composed_state,
        composed_steps,
        plain_composed_reverse,
        plain_superstep_reverse,
        superstep_stack,
    )
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    t_part = time.perf_counter()
    tfields = FIELDS + ("tracers",)
    counters = ("nl_window_launches", "nl_window_forced_launches", "nl_window_tracer_launches",
                "nl_window_strat_launches")
    kappa5 = dict(tracer_kappa=5.0, tracer_upwind=0.5)
    q2 = WINDOW_Q

    def zero():
        for c in counters + ("nl_launches",):
            setattr(adjoint_step, c, 0)
        tiled_adjoint.launches = 0

    def counts():
        return [getattr(adjoint_step, c) for c in counters]

    def arms_of(opts):
        return dict(n_tracers=2 * ("T" in opts), strat="S" in opts, forced="F" in opts)

    # ptxas, per arm (dtype, masked, forced, tracers, stratified)
    arm_re = re.compile(r"nl_window_adjoint_kernelI([fd])Lb([01])ELb([01])ELb([01])ELb([01])E")
    lines = ptxas_report(log_text, ("nl_window_adjoint_kernel",))
    per_arm, label = {}, None
    for line in lines:
        m = arm_re.search(line)
        if m:
            label = ("f32" if m.group(1) == "f" else "f64") + " " + (
                ("M" if m.group(2) == "1" else "P") + "N"
                + "".join(o for o, b in zip("FTS", m.groups()[2:]) if b == "1"))
            continue
        r = re.search(r"Used (\d+) registers", line)
        s = re.search(r"(\d+) bytes spill stores", line)
        if label and r:
            per_arm.setdefault(label, [0, 0])[0] = int(r.group(1))
        if label and s:
            per_arm.setdefault(label, [0, 0])[1] = max(per_arm.get(label, [0, 0])[1],
                                                       int(s.group(1)))
    log(f"[21] ptxas nl_window_adjoint_kernel, {len(per_arm)} instantiations (P periodic, M "
        "masked), registers/spill-store bytes: "
        + ", ".join(f"{a} {r}/{s}" for a, (r, s) in sorted(per_arm.items())))

    # f64: every arm at q = 2 and 3 against the plain reverse of every step
    n, levels = NL_WIN_F64
    n_ss, worst, n_checks, refused = NL_WIN_SS, {}, 0, []
    for channel in (False, True):
        model, prog = (random_channel if channel else random_case)(n, levels, seed=5,
                                                                   u_amp=0.5)
        sm = model.struct_mesh
        st_full = random_tracers(model, model.to_struct(prog))
        rng = np.random.default_rng(29 + levels)
        strat = stratification_from_numpy({"phi_weights": 0.05 * rng.normal(size=(levels,
                                                                                   levels)),
                                           "densities": np.full(levels, 1025.0)})
        forcing = lattice_forcing(model, seed=11 + levels)
        rng = np.random.default_rng(17)
        g_full = StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st_full, f).shape)))
                               .to(getattr(st_full, f)) for f in tfields))
        parts = []
        for q in (q2, 3):
            for opts in NL_WIN_OPTS:
                st, g = composed_state(st_full, opts), composed_state(g_full, opts)
                tile = adjoint_step.nl_window_plan(LARGE_N // 2, LARGE_N, LEVELS, 4,
                                                   **arms_of(opts))[:2]
                full = composed_stack(composed_steps(sm, 10.0, st.layer_thickness, opts, forcing,
                                                     strat), st, n_ss * q)

                def rev(o=opts, stk=full, q=q, tile=tile):
                    if "N" not in o:  # the drop-N control: the linear reverse of every step
                        return composed_reverse(
                            composed_steps(sm, 10.0, st.layer_thickness, o, forcing, strat),
                            stk, composed_state(g_full, o), n_ss * q)
                    steps = composed_steps(sm, 10.0, st.layer_thickness, o, forcing, strat,
                                           (*tile, q))
                    return composed_reverse(steps, superstep_stack(stk, q),
                                            composed_state(g_full, o), n_ss)

                arm = f"{'channel' if channel else 'periodic'} {opts} q={q} {tile}"
                if adjoint_step.nl_window_smem_bytes(tile, levels, 8, 1, **arms_of(opts)) > \
                        adjoint_step.SMEM_BYTES:
                    zero()
                    try:
                        rev()
                    except ValueError as e:
                        if "shared memory" not in str(e) or counts()[0]:
                            raise
                        refused.append(arm)
                        continue
                    raise AssertionError(f"f64 {arm}: fits no block, yet ran")
                zero()
                out = rev()
                c = counts()
                if c != [n_ss] + [n_ss * (o in opts) for o in "FTS"] or \
                        adjoint_step.nl_launches or tiled_adjoint.launches:
                    raise AssertionError(f"f64 {arm}: launch counts {c}, q = 1 "
                                         f"{adjoint_step.nl_launches}, linear "
                                         f"{tiled_adjoint.launches}")
                ref, scales = plain_composed_reverse(full, g, sm, 10.0, n_ss * q, opts, forcing,
                                                     strat)
                scales["d_dt"] = composed_ddt_scale(st, sm, 10.0, n_ss * q, g, opts, forcing,
                                                    strat)
                errs = composed_errors(out, ref, scales)
                err = max(r for _, r in errs.values())
                if not err <= 1e-12:
                    raise AssertionError(f"f64 {arm}: {format_errors(errs)}")
                again = rev()
                if not (all(getattr(out[0], f) is None
                            or torch.equal(getattr(out[0], f), getattr(again[0], f))
                            for f in tfields)
                        and all(x is None or torch.equal(x, y)
                                for x, y in zip(out[1:], again[1:]))):
                    raise AssertionError(f"f64 {arm}: rerun differs")
                miss = None
                if q == q2:
                    misses = []
                    for d in opts:
                        rest = opts.replace(d, "")
                        stk = full if d not in "NT" else composed_stack(
                            composed_steps(sm, 10.0, st.layer_thickness, rest, forcing, strat),
                            composed_state(st_full, rest), n_ss * q)
                        bare = rev(rest, stk)
                        misses.append(max(float((getattr(bare[0], f) - getattr(ref[0], f))
                                                .abs().max() / getattr(ref[0], f).abs().max())
                                          for f in tfields if getattr(bare[0], f) is not None))
                    miss = min(misses)
                    if not miss >= 100 * 1e-12:
                        raise AssertionError(f"f64 {arm}: a drop-one control misses by "
                                             f"{misses}")
                worst[opts] = max(worst.get(opts, 0.0), err)
                n_checks += 1
                parts.append(f"{opts} q={q} {err:.1e}"
                             + ("" if miss is None else f" ({miss:.1e})"))
                del full
        log(f"[21] f64 q-step nonlinear reverse vs the plain reverse, {n}^2x{levels} "
            f"{'channel' if channel else 'periodic'}, {n_ss} supersteps, at the f32 main "
            "paths' tiles: error over scale (least drop-one miss) " + ", ".join(parts))
        del model, st_full, g_full
        torch.cuda.empty_cache()
    log(f"[21] {n_checks} f64 checks of the q-step nonlinear reverse within 1e-12, reruns "
        f"bitwise, controls >= 100x off; refused (no block fits): {refused or 'none'}; worst: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    # the dot-product identity of the q = 2 NFTS gradient
    dots = {}
    for channel in (False, True):
        model, prog = (random_channel if channel else random_case)(32, 6, seed=5, u_amp=0.5)
        sm = model.struct_mesh
        st = random_tracers(model, model.to_struct(prog))
        forcing = lattice_forcing(model, seed=17)
        rng = np.random.default_rng(18)
        strat = stratification_from_numpy({"phi_weights": 0.05 * rng.normal(size=(6, 6)),
                                           "densities": np.full(6, 1025.0)})
        v, gbar = (StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape)))
                                 .to(getattr(st, f)) for f in tfields)) for _ in range(2))
        tang = (*(getattr(v, f) for f in tfields),
                torch.from_numpy(1e-4 * rng.normal(size=tuple(forcing.wind_edge.shape))).to(
                    forcing.wind_edge),
                *(torch.tensor(x, dtype=torch.float64, device=st.ssh.device)
                  for x in (1e-4, 3e-4, 1e-5)),
                torch.from_numpy(0.05 * rng.normal(size=(6, 6))).to(st.ssh))
        prim = (*(getattr(st, f) for f in tfields), forcing.wind_edge, forcing.drag_linear,
                forcing.drag_quadratic, forcing.rayleigh, strat.phi_weights.to(st.ssh))

        def rollout(*xs):
            f = Forcing(xs[4], forcing.top_mask, forcing.bottom_mask, *xs[5:8])
            out = structured_run_loop(StructState(*xs[:4]), sm, 10.0, 6, nonlinear=True,
                                      forcing=f, strat=Stratification(xs[8], strat.densities),
                                      **kappa5)
            return tuple(getattr(out, f) for f in tfields)

        _, jv = torch.func.jvp(rollout, prim, tang)
        lhs = sum(float((x * getattr(gbar, f)).sum()) for x, f in zip(jv, tfields))
        x = [p.clone().requires_grad_(True) for p in prim]
        zero()
        out = tiled_rollout_diff(StructState(*x[:4]), sm, 10.0, 6, nonlinear=True,
                                 forcing=Forcing(x[4], forcing.top_mask, forcing.bottom_mask,
                                                 *x[5:8]),
                                 strat=Stratification(x[8], strat.densities),
                                 plan=(2, 4, q2, 1), **kappa5)
        jtg = torch.autograd.grad(sum((getattr(out, f) * getattr(gbar, f)).sum()
                                      for f in tfields), x)
        rhs = sum(float((t * d).sum()) for t, d in zip(tang, jtg))
        dots[channel] = abs(lhs - rhs) / abs(rhs)
        log(f"[21] f64 dot-product identity, NFTS q = 2 through tiled_rollout_diff(nonlinear="
            f"True), 32x32x6 {'channel' if channel else 'periodic'}, 6 steps ({counts()} q-step "
            f"nonlinear reverse launches): <Jv, g> {lhs:.17g}, <v, J^T g> {rhs:.17g}, relative "
            f"gap {dots[channel]:.3e}")
        if not (dots[channel] <= 1e-12 and counts() == [3] * 4):
            raise AssertionError(f"nonlinear q = 2 dot-product identity off by "
                                 f"{dots[channel]:.3e}, launches {counts()}")
        del model, st
    log(f"[21] the q-step nonlinear reverse's checks took {time.perf_counter() - t_part:.1f} s")

    # f32 after 100 reverse steps of bench.py's full physics at q = 2
    strat32 = mt.make_stratification(1025.0 + np.linspace(0.0, BENCH_RHO_SPAN, LEVELS),
                                     dtype=np.float32)
    bench_kw = dict(tracer_kappa=BENCH_TRACER_KAPPA, tracer_upwind=BENCH_TRACER_UPWIND)
    eps32 = float(np.finfo(np.float32).eps)
    n32 = TILED_CHECK_STEPS
    gaps, max_abs_err = {}, {}
    for n in (HEADLINE_N, LARGE_N):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=bench_tracers(horz, LEVELS, np.float32)))
        f32 = bench_forcing(horz, model, np.float32)
        n_ss32 = n32 // q2
        tile = adjoint_step.nl_window_plan(sm.ny2, sm.nx, LEVELS, 4, **arms_of("NFTS"))[:2]
        steps = composed_steps(sm, DT, st.layer_thickness, "NFTS", f32, strat32, (*tile, q2))
        sup = composed_stack(steps, st, n_ss32)
        end = sup.ssh[n_ss32], sup.tracers[n_ss32]
        g = StructState(2 * end[0], torch.zeros_like(st.layer_thickness),
                        torch.zeros_like(st.normal_velocity),
                        2 * fused_model.tracer_unplanes(end[1]))
        del end
        ref64, scales = plain_superstep_reverse(sup, g, sm, DT, n_ss32, q2, "NFTS", f32, strat32,
                                                dtype=torch.float64)
        p32, _ = plain_superstep_reverse(sup, g, sm, DT, n_ss32, q2, "NFTS", f32, strat32)
        bf, _ = plain_superstep_reverse(sup, g, sm, DT, n_ss32, q2, "NFTS", f32, strat32,
                                        store=lambda x: x.bfloat16().float())
        zero()
        out = composed_reverse(steps, sup, g, n_ss32)
        if counts() != [n_ss32] * 4:
            raise AssertionError(f"f32 NFTS reverse q = 2 at {n}^2: launches {counts()}")
        magnitude = {"d_dt": abs(float(ref64[1]))}
        magnitude.update(zip(("d_r_lin", "d_cd", "d_lambda"), (abs(float(x)) for x in ref64[3])))
        scales.update(magnitude)
        e_k, e_p, e_b = (composed_errors(x, ref64, scales) for x in (out, p32, bf))
        ratios, control_fails = {}, False
        for f in e_k:
            scale = e_k[f][0] / e_k[f][1] if e_k[f][1] else 0.0
            floor = (SCALAR_FLOOR * magnitude[f] if f in magnitude else 0.0 if f == "d_w"
                     else TRACER_REV_F32_FLOOR * eps32 * scale)
            limit = U_GAP_FACTOR * max(e_p[f][0], floor)
            ratios[f] = e_k[f][0] / limit
            control_fails = control_fails or e_b[f][0] > limit
            if not e_k[f][0] <= limit:
                raise AssertionError(f"f32 NFTS reverse q = 2 at {n}^2: {f} {e_k[f][0]:.3e}, "
                                     f"limit {limit:.3e}")
        if not control_fails:
            raise AssertionError(f"f32 NFTS reverse q = 2 at {n}^2: the bf16 control passes")
        gaps[n] = ratios
        max_abs_err[n] = max(e for e, _ in composed_errors(out, p32, scales).values())
        log(f"[21] f32 {n}^2x{LEVELS} NFTS q-step nonlinear reverse q = 2 (tile {tile}), {n32} "
            "reverse steps: distance from an f64 reverse of the same f32 superstep starts (the "
            "inner states recomputed in f64) over the limit " + ", ".join(
                f"{f} {r:.3f}" for f, r in ratios.items()) + "; the bf16 control fails; max "
            f"|kernel - plain f32| {max_abs_err[n]:.3e}")
        del sup, ref64, p32, bf, out, st, steps
        torch.cuda.empty_cache()

    # the main path: bench.py's full-physics gradient at q = 2 from to_struct,
    # exact launch counts; the nonlinear gradient at q = 2 and q = 1
    horz, _, model, prog = igw_case(LARGE_N, LEVELS, np.float32)
    sm = model.struct_mesh
    ptr = mt.PrognosticVars(prog.ssh, prog.layer_thickness, prog.normal_velocity,
                            tracers=bench_tracers(horz, LEVELS, np.float32))
    forcing = bench_forcing(horz, model, np.float32)

    def grad(s, plan, full_physics):
        fs = tfields if full_physics else FIELDS
        leaves = [getattr(s, f).clone().requires_grad_(True) for f in fs]
        kw = {}
        extra = []
        if full_physics:
            w = strat32.phi_weights.to(s.ssh.device).clone().requires_grad_(True)
            fd = [getattr(forcing, c).clone().requires_grad_(True)
                  for c in ("wind_edge", "drag_linear", "drag_quadratic", "rayleigh")]
            kw = dict(forcing=Forcing(fd[0], forcing.top_mask, forcing.bottom_mask, *fd[1:]),
                      strat=Stratification(w, strat32.densities), **bench_kw)
            extra = [w] + fd
        out = tiled_rollout_diff(StructState(*leaves), sm, DT, LARGE_ADJ_STEPS, nonlinear=True,
                                 plan=plan, **kw)
        loss = (out.ssh ** 2).sum() + (0 if out.tracers is None else (out.tracers ** 2).sum())
        return torch.autograd.grad(loss, leaves + extra)

    st_w = model.to_struct(ptr)
    plan = tiled_diff.tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, LARGE_ADJ_STEPS, halo=(2, 4),
                                         q=q2, nonlinear=True, **arms_of("NFTS"),
                                         budget=diff_model._default_budget(st_w.ssh.device))
    zero()
    grads = grad(st_w, plan, True)
    c = counts()
    main_launches = c[0]
    log(f"[21] main path: tiled_rollout_diff(nonlinear=True, q = 2) with bench.py's full "
        f"physics, {LARGE_N}^2x{LEVELS} f32 from to_struct, {LARGE_ADJ_STEPS} steps, plan "
        f"{tuple(plan)}: launches (q-step nonlinear reverse, forced, tracers, stratified) {c}, "
        f"q = 1 nonlinear reverse {adjoint_step.nl_launches}, linear tiled reverse "
        f"{tiled_adjoint.launches} [{gpu}]")
    if c != [LARGE_ADJ_STEPS // q2] * 4 or adjoint_step.nl_launches or tiled_adjoint.launches \
            or not all(bool(torch.isfinite(x).all()) for x in grads):
        raise AssertionError(f"nonlinear q = 2 main path: launches {c}, or not finite")
    del grads
    grad_s, plans = {}, {}
    bare = StructState(st_w.ssh, st_w.layer_thickness, st_w.normal_velocity)
    for q in (1, q2):
        plans[q] = tiled_diff.tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, LARGE_ADJ_STEPS,
                                                 halo=(2, 4), q=q, nonlinear=True,
                                                 budget=diff_model._default_budget(
                                                     st_w.ssh.device))
        grad_s[q] = cuda_times(lambda q=q: grad(bare, plans[q], False), REPS)
        log(f"[21] nonlinear grad of sum ssh^2 through tiled_rollout_diff, {LARGE_N}^2x{LEVELS} "
            f"f32, {LARGE_ADJ_STEPS} steps, plan {tuple(plans[q])}: {spread(grad_s[q])} per "
            f"grad [{gpu}]")
    log(f"[21] nonlinear grad q = 2 / q = 1: x"
        f"{statistics.median(grad_s[q2]) / statistics.median(grad_s[1]):.4f}")
    del st_w, bare

    # per launch (held_us): q = 2 against two q = 1 launches, N and NFTS, at
    # 64^2 and 256^2; the bound; the plain reverse of one superstep
    held, bounds, plain_ms = {}, {}, None
    n_h = NL_WIN_HELD_STEPS
    for n in (HEADLINE_N, LARGE_N):
        horz, _, model, prog = igw_case(n, LEVELS, np.float32)
        sm = model.struct_mesh
        st = model.to_struct(mt.PrognosticVars(prog.ssh, prog.layer_thickness,
                                               prog.normal_velocity,
                                               tracers=bench_tracers(horz, LEVELS, np.float32)))
        f32 = bench_forcing(horz, model, np.float32) if n != LARGE_N else forcing
        rng = np.random.default_rng(20)
        g = StructState(*(torch.from_numpy(rng.normal(size=tuple(getattr(st, f).shape))).to(
            getattr(st, f)) for f in tfields))
        for opts in ("N", "NFTS"):
            full = composed_stack(composed_steps(sm, DT, st.layer_thickness, opts, f32, strat32,
                                                 kappa=BENCH_TRACER_KAPPA,
                                                 upwind=BENCH_TRACER_UPWIND),
                                  composed_state(st, opts), n_h)
            gg = composed_state(g, opts)
            for q in (1, q2):
                tile = (adjoint_step.nl_window_plan if q > 1 else adjoint_step.nl_adjoint_plan)(
                    sm.ny2, sm.nx, LEVELS, 4, [(r, c) for r in range(1, sm.ny2 + 1)
                                               if sm.ny2 % r == 0
                                               for c in range(1, sm.nx + 1) if sm.nx % c == 0],
                    **(arms_of(opts) if q > 1 else dict(n_tracers=2 * ("T" in opts),
                                                        strat="S" in opts)))[:2]
                steps = composed_steps(sm, DT, st.layer_thickness, opts, f32, strat32,
                                       (*tile, q), kappa=BENCH_TRACER_KAPPA,
                                       upwind=BENCH_TRACER_UPWIND)
                sup = superstep_stack(full, q)
                held[n, opts, q] = held_us(lambda steps=steps, sup=sup: composed_reverse(
                    steps, sup, gg, n_h // q), n_h // q, REPS)
                held[n, opts, q, "tile"] = tile
                del sup
            dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
            names = {"N": {"nonlinear"}, "NFTS": {"nonlinear", "forced", "tracers", "strat"}}
            bounds[n, opts] = window_bound(*dims, names[opts], q2, reverse=True)
            med2 = statistics.median(held[n, opts, q2])
            med1 = statistics.median(held[n, opts, 1])
            log(f"[21] q-step nonlinear reverse {opts} per launch (held_us), {n}^2x{LEVELS} f32: "
                f"q = 2 {spread(held[n, opts, q2], 1, 'us')} at {held[n, opts, q2, 'tile']}; two "
                f"q = 1 launches {2 * med1:.6g} us (per launch {spread(held[n, opts, 1], 1, 'us')}"
                f" at {held[n, opts, 1, 'tile']}): q = 2 / (2 q = 1) x{med2 / (2 * med1):.4f}; "
                f"bound {bounds[n, opts][0] * 1e6:.3f} us ({bounds[n, opts][1]}): "
                f"{bounds[n, opts][0] * 1e6 / med2:.4f} of it [{gpu}]")
            if n == LARGE_N and opts == "NFTS":
                s0 = diff_model._lattice_state(diff_model._slot(full, 0))
                nxt = diff_model._lattice_state(diff_model._slot(full, 1))
                g1 = composed_state(g, opts)
                plain_ms = [t * 1e3 for t in cuda_times(
                    lambda: structured_nl_adjoint_step(s0, g1, sm, DT, f32, next_state=nxt,
                                                       strat=strat32, **bench_kw), REPS)]
                del s0, nxt
            del full
        del st, g
        torch.cuda.empty_cache()
    med = statistics.median
    b, by = bounds[LARGE_N, "NFTS"]
    log(f"[21] the q-step nonlinear reverse's part took {time.perf_counter() - t_part:.1f} s")
    return {
        "name": "nl_window_adjoint (kernel 4's nonlinear arm at q = 2: nonlinear, forced, "
                "tracers, stratified)",
        "route": "cuda", "source": "mpas_ocean_tpu_torch/csrc/nl_window_adjoint.cuh",
        "replaces": "mpas_ocean_tpu/structured/pallas_model.py:1979 (_tiled_adjoint_kernel with "
                    "nl_terms, q > 1: the VJP of _window_steps :2040-2124)",
        "launches": main_launches,
        "max_abs_err": max_abs_err[LARGE_N],
        "ms": med(held[LARGE_N, "NFTS", q2]) / 1e3,
        # the plain reverse of one superstep: q plain reverse steps (the
        # recompute's forward step not counted)
        "plain_ms": med(plain_ms) * q2,
        "bound_ms": b * 1e3, "bound_by": by, "library_ms": None, "q": q2,
        "ms_two_q1": 2 * med(held[LARGE_N, "NFTS", 1]) / 1e3,
        "nonlinear_alone_ms": med(held[LARGE_N, "N", q2]) / 1e3,
        "nonlinear_alone_ms_two_q1": 2 * med(held[LARGE_N, "N", 1]) / 1e3,
        "nonlinear_alone_bound_ms": bounds[LARGE_N, "N"][0] * 1e3,
        "ms_64": med(held[HEADLINE_N, "NFTS", q2]) / 1e3,
        "ms_64_two_q1": 2 * med(held[HEADLINE_N, "NFTS", 1]) / 1e3,
        "nonlinear_alone_ms_64": med(held[HEADLINE_N, "N", q2]) / 1e3,
        "nonlinear_alone_ms_64_two_q1": 2 * med(held[HEADLINE_N, "N", 1]) / 1e3,
        "bound_ms_64": bounds[HEADLINE_N, "NFTS"][0] * 1e3,
        "nonlinear_grad_s_256_q2": grad_s[q2], "nonlinear_grad_s_256_q1": grad_s[1],
        "tiles": {"N": held[LARGE_N, "N", q2, "tile"], "NFTS": held[LARGE_N, "NFTS", q2, "tile"]},
        "max_abs_err_64": max_abs_err[HEADLINE_N],
        "f32_gap_ratios": gaps[LARGE_N], "f32_gap_ratios_64": gaps[HEADLINE_N],
        "max_rel_err_f64": worst, "refused_f64": refused,
        "dot_gaps": [dots[False], dots[True]], "ptxas": per_arm,
        "sources": ["mpas_ocean_tpu_torch/csrc/nl_window_adjoint.cuh",
                    "mpas_ocean_tpu_torch/csrc/nl_window_adjoint.cu"]}


# the sharded superstep (phase 22): bench.py's measure_superstep and
# measure_sharded_adjoint run ShardedStructuredModel(devices=[device]) at
# q = 2, the superstep over HEADLINE_STEPS and the adjoint over
# max(8, HEADLINE_STEPS // 8) steps
SHARDED_Q = 2
SHARDED_ADJ_STEPS = max(8, HEADLINE_STEPS // 8)
SHARDED_SUPERSTEPS = 3  # supersteps of each f64 check
# steps of the sharded adjoint's timed reps: a 1000-step gradient takes
# 17-21 s on the card (its reverse replays the plain superstep), so REPS of
# them would cost phase 22 ~60 s; the main path's 1000-step run is timed
# once beside them
SHARDED_ADJ_TIMED_STEPS = SHARDED_ADJ_STEPS // 10
# steps of the superstep's timed variants (q = 1 and 4, P = 2 and 4, record
# only): the host's work per superstep sets their time a step, which 500
# steps read as well as 8000 (1000 until a run on a slower host left the
# whole run too little room under its limit); bench.py's cell and the
# single-chip kernel run 8000
SHARDED_VARIANT_STEPS = HEADLINE_STEPS // 16


def sharded_phase(gpu: str, log_text: str) -> list:
    """Phase 22, the sharded row-slab path: kernel 2's received-halo arm,
    ShardedStructuredModel.run_pallas, each slab's state in buffers of
    R + 2 hq rows whose halo rows one exchange per field fills, one launch a
    superstep (csrc/step_window.cuh, buffer_plane). The instantiations'
    ptxas summary; f64 against the plain superstep (the same model on CPU
    slabs, slab.window_steps on each slab's extended window) within 1e-12
    of scale over 1, 2 and 4 slabs: the linear core FE and FB at q = 1, 2,
    3 and the nonlinear at q = 1, 2 (32^2 and 16^2 x 4), forcing, tracers
    and stratification alone and all four with the nonlinear core (32^2 x
    36), the channel; exact counts, P n / q launches and n / q exchanges
    per field; reruns bitwise; bitwise equal to the single-chip
    tiled_run_loop at the same plan; the stale-halo control (the exchange
    skipped) >= 100x off; objective_pallas's gradient against the plain
    objective's within 1e-12 of scale and the dot-product identity against
    the plain rollout's tangent (forward-mode AD) within 1e-12, linear,
    nonlinear, FB and NFTS at P = 1 and 2; f32 after 100 steps at P = 1,
    64^2 x 100: each field's distance from an f64 plain run within
    U_GAP_FACTOR x the plain f32 run's, a bf16 control failing it; bench.py's
    superstep cell (64x64x100 f32, P = 1, q = 2, HEADLINE_STEPS steps from
    scatter(to_struct)) and its sharded adjoint (SHARDED_ADJ_STEPS steps,
    timed once, and REPS times over SHARDED_ADJ_TIMED_STEPS) with exact
    counts, timed (median of REPS) beside the single-chip tiled_run_loop at
    q = 2 and 1 and the superstep at q = 1, 2, 4; one launch's device time
    (held_us) against its bound; P = 2 and 4 on the one card once. Returns
    the kernels line's entries."""
    import math
    import re
    import warnings

    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt
    from mpas_ocean_tpu_torch.kernels import tiled_step
    from mpas_ocean_tpu_torch.models import stratification_from_numpy
    from mpas_ocean_tpu_torch.structured import (
        ShardedStructuredModel,
        StructState,
        sharded,
        structured_run_loop,
        tiled_run_loop,
    )
    from mpas_ocean_tpu_torch.structured.slab import reach
    from mpas_ocean_tpu_torch.tools.composed_reverse import composed_state
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us
    from mpas_ocean_tpu_torch.tools.sharded_checks import (
        field_errors,
        kernel_launches,
        pair_runs,
        run_sharded,
        zero_counts,
    )

    t_phase = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    tfields = FIELDS + ("tracers",)
    kappa5 = dict(tracer_kappa=5.0, tracer_upwind=0.5)
    for name in ("tiled_step_kernel", "nl_step_kernel", "nl_tiled_kernel"):
        text = "\n".join(ptxas_report(log_text, (name,)))
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"[22] ptxas {name} (received halos a runtime row mode): {len(regs)} "
            f"instantiations, {min(regs, default=0)}-{max(regs, default=0)} registers, spill "
            f"stores up to {max(spills, default=0)} bytes")

    def case(n, levels, channel, opts, seed=5):
        model, prog = (random_channel if channel else random_case)(n, levels, seed=seed,
                                                                   u_amp=0.5)
        st = model.to_struct(prog)
        if "T" in opts:
            st = random_tracers(model, st)
        rng = np.random.default_rng(29 + levels)
        strat = stratification_from_numpy({"phi_weights": 0.05 * rng.normal(size=(levels,
                                                                                   levels)),
                                           "densities": np.full(levels, 1025.0)})
        kw = dict(forcing=lattice_forcing(model, seed=11 + levels) if "F" in opts else None,
                  strat=strat if "S" in opts else None, nonlinear="N" in opts, **kappa5)
        return model.struct_mesh, composed_state(st, opts), kw

    def same(a, b):
        return all(getattr(a, f) is None or torch.equal(getattr(a, f), getattr(b, f))
                   for f in tfields)

    def plan_q(sm, parts, n, k, q, fb, kw, st):
        """The q run_pallas takes for q (JAX's reduction: the halo limit and
        the shared memory), without its warning."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ShardedStructuredModel(sm, [dev] * parts).superstep_plan(
                n, k, torch.float64, q=q, nonlinear=kw["nonlinear"], fb=fb,
                n_tracers=0 if st.tracers is None else st.tracers.shape[3],
                forced=kw["forcing"] is not None, strat=kw["strat"] is not None)["q"]

    # f64 against the plain superstep
    checks = []
    for n, levels, channel, opts_list, qs, slabs in (
            (32, 4, False, ("", "N"), None, (1, 2, 4)), (16, 4, False, ("", "N"), (2,), (1, 2)),
            (32, 36, False, ("F", "T", "S"), (2,), (2,)),
            (32, 36, False, ("NFTS",), (1, 2), (2,)),
            (32, 4, True, ("", "NFTS"), (1, 2), (2,)), (32, 4, True, ("FTS",), (2,), (4,))):
        for opts in opts_list:
            sm, st, kw = case(n, levels, channel, opts)
            for fb in (False, True):
                for q in qs or ((1, 2) if "N" in opts else (1, 2, 3)):
                    for parts in slabs:
                        if sm.ny2 % parts or reach(fb, "N" in opts) * q > sm.ny2 // parts:
                            continue
                        if plan_q(sm, parts, SHARDED_SUPERSTEPS * q, levels, q, fb, kw,
                                  st) != q:
                            continue
                        checks.append((n, levels, channel, opts, fb, q, parts, sm, st, kw))
    worst, parts_log, n_checks = 0.0, {}, 0
    for n, levels, channel, opts, fb, q, parts, sm, st, kw in checks:
        steps = SHARDED_SUPERSTEPS * q
        card, plain, counts = pair_runs(sm, st, parts, 10.0, steps, q=q, fb=fb, **kw)
        errs = {f: r for f, (_, r) in field_errors(card, plain).items()}
        arm = (f"{n}^2x{levels} {'channel ' if channel else ''}{opts or '-'} "
               f"{'FB' if fb else 'FE'} q={q} P={parts}")
        n_fields = 3 + (st.tracers is not None)
        want = (parts * SHARDED_SUPERSTEPS, n_fields * SHARDED_SUPERSTEPS)
        got = (counts["fe_step"] + counts["tiled_step"], counts["exchanges"])
        if got != want:
            raise AssertionError(f"f64 {arm}: launches, exchanges {got} != {want}")
        if not max(errs.values()) <= 1e-12:
            raise AssertionError(f"f64 {arm}: received-halo arm vs plain superstep {errs}")
        again, _ = run_sharded(sm, st, [dev] * parts, 10.0, steps, q=q, fb=fb, **kw)
        if not same(card, again):
            raise AssertionError(f"f64 {arm}: rerun differs")
        if channel:
            check_walls(card, sm, f"f64 {arm}")
        worst, n_checks = max(worst, max(errs.values())), n_checks + 1
        parts_log.setdefault(f"{n}^2x{levels}{' channel' if channel else ''}", []).append(
            f"{opts or '-'} {'FB' if fb else 'FE'} q{q} P{parts} {max(errs.values()):.1e}")
    for where, items in parts_log.items():
        log(f"[22] f64 received-halo arm vs plain superstep, {where}, {SHARDED_SUPERSTEPS} "
            "supersteps (of scale): " + ", ".join(items))
    log(f"[22] {n_checks} f64 checks within 1e-12 of scale (worst {worst:.3e}), P n / q "
        "launches and n / q exchanges per field each, reruns bitwise")
    del checks

    # bitwise against the single-chip kernel at the same plan
    n_bit = 0
    for opts, fb, q, tile in (("", False, 2, (4, 8)), ("", True, 1, (4, 16)),
                              ("FTS", True, 2, (4, 8)), ("N", False, 1, (4, 8)),
                              ("N", True, 1, (4, 8)), ("N", False, 2, (4, 8)),
                              ("NFTS", True, 2, (2, 4))):
        sm, st, kw = case(32, 4, False, opts)
        ref = tiled_run_loop(st, sm, 10.0, 2 * q, row_tile=tile[0], col_tile=tile[1], q=q,
                             fb=fb, **kw)
        for parts in (1, 2):
            out, _ = run_sharded(sm, st, [dev] * parts, 10.0, 2 * q, row_tile=tile[0],
                                 col_tile=tile[1], q=q, fb=fb, **kw)
            if not same(out, ref):
                raise AssertionError(f"{opts or '-'} {'FB' if fb else 'FE'} q={q} P={parts}: "
                                     "not bitwise tiled_run_loop's at the same plan")
            n_bit += 1
    log(f"[22] f64 32^2x4, tiles dividing the slab: the sharded run bitwise tiled_run_loop's "
        f"at the same (row_tile, col_tile, q), {n_bit} runs (P = 1, 2; linear FE q=2, FB q=1, "
        "FTS FB q=2, nonlinear FE q=1, 2, FB q=1, NFTS FB q=2)")

    # the stale-halo control: the exchange skipped after the first superstep
    for opts in ("", "N"):
        sm, st, kw = case(32, 4, False, opts)
        model = ShardedStructuredModel(sm, [dev] * 2)
        plain, _ = run_sharded(sm, st, [cpu] * 2, 10.0, 6, q=2, **kw)
        good = model.gather(model.run_pallas(model.scatter(st), 10.0, 6, q=2, **kw))
        stale = model.gather(model.run_pallas(model.scatter(st), 10.0, 6, q=2, exchange=False,
                                              **kw))
        e_good, e_stale = field_errors(good, plain)["ssh"][1], field_errors(stale, plain)["ssh"][1]
        log(f"[22] control, {opts or 'linear'} FE q=2 P=2, 3 supersteps: ssh off the plain "
            f"superstep by {e_good:.3e} of scale with the exchange, {e_stale:.3e} with stale "
            f"halos (x{e_stale / 1e-12:.3g} the 1e-12 limit; limit x100)")
        if not (e_good <= 1e-12 and e_stale >= 100 * 1e-12):
            raise AssertionError(f"stale-halo control: {e_good}, {e_stale}")

    # the gradient, f64: objective_pallas against the plain objective, and
    # the dot-product identity against the plain rollout's tangent
    def plain_j(sm, kw, fb, n):
        def j(*xs):
            out = structured_run_loop(StructState(*xs), sm, 10.0, n, fb=fb, **kw)
            return (out.ssh ** 2).sum()
        return j

    grad_log = []
    for opts, fb in (("", False), ("N", False), ("", True), ("NFTS", False)):
        sm, st, kw = case(16, 4, False, opts)
        xs = tuple(x for x in (st.ssh, st.layer_thickness, st.normal_velocity, st.tracers)
                   if x is not None)
        rng = np.random.default_rng(41)
        v = tuple(torch.from_numpy(rng.normal(size=tuple(x.shape))).to(x) for x in xs)
        _, jv = torch.func.jvp(plain_j(sm, kw, fb, 4), xs, v)
        for parts in (1, 2):
            model = ShardedStructuredModel(sm, [dev] * parts)
            grads = []
            for name in ("objective_pallas", "objective"):
                local = {k: [x.requires_grad_() for x in xs_] for k, xs_ in
                         model.scatter(st).items()}
                extra = {"q": SHARDED_Q} if name == "objective_pallas" else {}
                getattr(model, name)(local, 10.0, 4, fb=fb, **kw, **extra).backward()
                g = model.gather({k: [torch.zeros_like(x) if x.grad is None else x.grad
                                      for x in xs_] for k, xs_ in local.items()})
                grads.append(g)
            errs = field_errors(*grads)
            err = max(r for f, (_, r) in errs.items() if f != "tracers")
            g = grads[0]
            dot = sum(float((a * b).sum()) for a, b in zip(
                (g.ssh, g.layer_thickness, g.normal_velocity, g.tracers), v) if a is not None)
            gap = abs(dot - float(jv)) / abs(float(jv))
            what = f"{opts or 'linear'} {'FB' if fb else 'FE'} P={parts}"
            grad_log.append(f"{what} {err:.1e}, identity {gap:.1e}")
            if not (err <= 1e-12 and gap <= 1e-12):
                raise AssertionError(f"f64 gradient {what}: vs plain objective {errs}, "
                                     f"dot-product gap {gap:.3e}")
    log("[22] f64 16^2x4, 4 steps, q=2: objective_pallas's gradient vs the plain objective's "
        "(of scale), the dot-product identity <grad, v> vs the plain rollout's tangent "
        "(relative; limits 1e-12): " + "; ".join(grad_log))

    # f32 after 100 steps at P = 1, 64^2 x 100: the distance rule, with a
    # bf16 control
    horz, _, model32, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    _, _, model64, prog64 = igw_case(HEADLINE_N, LEVELS, np.float64)
    sm, sm64 = model32.struct_mesh, model64.struct_mesh
    st = model32.to_struct(prog)
    st64 = StructState(*(getattr(st, f).double() for f in FIELDS))
    out, _ = run_sharded(sm, st, [dev], DT, TILED_CHECK_STEPS, q=SHARDED_Q)
    ref = structured_run_loop(st, sm, DT, TILED_CHECK_STEPS)
    ref64 = structured_run_loop(st64, sm64, DT, TILED_CHECK_STEPS)
    bf = st
    for _ in range(TILED_CHECK_STEPS):
        bf = structured_run_loop(bf, sm, DT, 1)
        bf = StructState(*(getattr(bf, f).bfloat16().float() for f in FIELDS))
    control_fails, ratios = False, []
    for f in FIELDS:
        d = lambda x: float((getattr(x, f).double() - getattr(ref64, f)).abs().max())  # noqa
        g_k, g_p, g_b = d(out), d(ref), d(bf)
        limit = U_GAP_FACTOR * g_p
        log(f"[22] f32 {HEADLINE_N}^2x{LEVELS} IGW, P=1 q={SHARDED_Q}, {TILED_CHECK_STEPS} steps: "
            f"{f}'s distance from the f64 plain run: sharded {g_k:.3e}, plain f32 {g_p:.3e}: "
            f"x{g_k / limit:.3f} of the limit {limit:.3e}; bf16 control {g_b:.3e} "
            f"(x{g_b / limit:.1f})")
        if not g_k <= limit:
            raise AssertionError(f"f32 sharded {f}: {g_k:.3e} from f64, limit {limit:.3e}")
        control_fails = control_fails or g_b > limit
        ratios.append(g_k / limit)
    if not control_fails:
        raise AssertionError("f32 sharded: the bf16 control passes")
    del st64, ref64, bf, out, ref

    # one launch of the arm against the plain superstep on the card, at the
    # bench cell's plan: max |diff| and the per-launch times
    model = ShardedStructuredModel(sm, [dev])
    local = model.scatter(st)
    su = model._superstep_setup(local, DT, SHARDED_Q, SHARDED_Q, None, None, None, 0.0, 1.0,
                                None, False, False)
    hq, rows = su["hq"], model.rows
    ext = [torch.cat([x[:, -1 - hq:-1], x[:, 1:-1], x[:, 1:1 + hq]], 1).contiguous()
           for x in (local[k][0] for k in ("ssh", "h", "u"))]
    dst = [torch.empty_like(x) for x in ext]
    model._launch(su, 0, ext, dst)
    plain = model._plain_superstep(su, 0, ext)
    launch_err = max(float((d[:, hq:hq + rows] - p).abs().max()) for d, p in zip(dst, plain))
    # the launch's device time behind a held stream (tools/reverse_timing.
    # held_us), and its time by events with the wrapper's host work
    launch_us = held_us(lambda: [model._launch(su, 0, ext, dst) for _ in range(10)], 10, REPS)
    call_s = cuda_times(lambda: model._launch(su, 0, ext, dst), REPS)
    plain_s = cuda_times(lambda: model._plain_superstep(su, 0, ext), REPS)
    log(f"[22] one launch ({SHARDED_Q} steps, plan rt={su['row_tile']} ct={su['col_tile']}) "
        f"vs the plain superstep on the card, f32 {HEADLINE_N}^2x{LEVELS}: max|diff| "
        f"{launch_err:.3e}; launch device time {spread(launch_us, 1, 'us')}, one call by events "
        f"(the wrapper's host work in it) {spread(call_s, 1e6, 'us')}, plain superstep "
        f"{spread(plain_s, 1e6, 'us')} [{gpu}]")
    del ext, dst, plain

    # bench.py's superstep cell from scatter(to_struct), exact counts
    n_grid = horz.n_cells * LEVELS
    zero_counts()
    t0 = time.perf_counter()
    model = ShardedStructuredModel(sm, [dev])
    loc = model.run_pallas(model.scatter(model32.to_struct(prog)), DT, HEADLINE_STEPS,
                           q=SHARDED_Q)
    final = model32.from_struct(model.gather(loc))
    wall = time.perf_counter() - t0
    counts = kernel_launches()
    want_l, want_x = HEADLINE_STEPS // SHARDED_Q, 3 * HEADLINE_STEPS // SHARDED_Q
    log(f"[22] main path: bench.py's superstep cell, {HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32, "
        f"P=1 q={SHARDED_Q}, {HEADLINE_STEPS} steps, scatter(to_struct) .. from_struct(gather) "
        f"{wall:.3f} s wall; launches tiled_step {counts['tiled_step']} (want {want_l}), "
        f"fe_step {counts['fe_step']} (want 0), field exchanges {counts['exchanges']} (want "
        f"{want_x})")
    if (counts["tiled_step"], counts["fe_step"], counts["exchanges"]) != (want_l, 0, want_x):
        raise AssertionError(f"superstep cell counts {counts}")
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(final, f)).all()):
            raise AssertionError(f"superstep cell: {f} is not finite")
    if tuple(final.ssh.shape) != (horz.n_cells,) or tuple(
            final.normal_velocity.shape) != (horz.n_edges, LEVELS):
        raise AssertionError("superstep cell: wrong output shapes")
    ssh_gap = float((model.gather(loc).ssh
                     - tiled_run_loop(st, sm, DT, HEADLINE_STEPS, q=SHARDED_Q,
                                      row_tile=su["row_tile"],
                                      col_tile=su["col_tile"]).ssh).abs().max())
    log(f"[22] superstep cell vs tiled_run_loop at the same plan, {HEADLINE_STEPS} steps: "
        f"max|ssh diff| {ssh_gap:.3e} (want 0: bitwise)")
    if ssh_gap != 0.0:
        raise AssertionError(f"superstep cell differs from tiled_run_loop: {ssh_gap}")
    del loc, final

    # the times: the superstep cell, the single-chip kernel beside it, the
    # superstep at q = 1, 2, 4 and the auto q
    local = model.scatter(st)
    times = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the warm-up's 10 steps reduce q = 4
        for label, fn, n_steps in (
                (f"superstep q={SHARDED_Q}",
                 lambda n: model.run_pallas(local, DT, n, q=SHARDED_Q), HEADLINE_STEPS),
                (f"tiled_run_loop q={SHARDED_Q}",
                 lambda n: tiled_run_loop(st, sm, DT, n, q=SHARDED_Q), HEADLINE_STEPS),
                ("tiled_run_loop q=1", lambda n: tiled_run_loop(st, sm, DT, n, q=1),
                 HEADLINE_STEPS),
                ("superstep q=1", lambda n: model.run_pallas(local, DT, n, q=1),
                 SHARDED_VARIANT_STEPS),
                ("superstep q=4", lambda n: model.run_pallas(local, DT, n, q=4),
                 SHARDED_VARIANT_STEPS)):
            _, t = timed_rollout(fn, n_steps, REPS)
            times[label] = t
            log(f"[22] {label}, {HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32, {n_steps} steps: "
                f"{spread(t, 1e6, 'us')} per step, {n_grid / statistics.median(t):.6g} "
                f"gridpoints*steps/s [{gpu}]")
    q4 = model.superstep_plan(HEADLINE_STEPS, LEVELS, torch.float32, q=4)
    auto = model.superstep_plan(HEADLINE_STEPS, LEVELS, torch.float32)
    log(f"[22] superstep plans: q={SHARDED_Q} {su['row_tile']}x{su['col_tile']}, q=4 "
        f"{q4['row_tile']}x{q4['col_tile']}; the auto q (sharded.AUTO_Q) runs q={auto['q']} at "
        f"{auto['row_tile']}x{auto['col_tile']}")
    for parts in (2, 4):
        mp = ShardedStructuredModel(sm, [dev] * parts)
        lp = mp.scatter(st)
        _, t = timed_rollout(lambda n: mp.run_pallas(lp, DT, n, q=SHARDED_Q),
                             SHARDED_VARIANT_STEPS, 1)
        times[f"superstep q={SHARDED_Q} P={parts}"] = t
        log(f"[22] superstep q={SHARDED_Q}, P={parts} slabs on the one card (record only), "
            f"{SHARDED_VARIANT_STEPS} steps: {t[0] * 1e6:.6g} us per step [{gpu}]")
        del mp, lp

    # bench.py's sharded adjoint: the gradient of objective_pallas over
    # SHARDED_ADJ_STEPS steps at P = 1, q = 2, from scatter(to_struct)
    def sharded_grad(n_steps=SHARDED_ADJ_STEPS):
        loc_g = {k: [x.requires_grad_() for x in v] for k, v in
                 model.scatter(model32.to_struct(prog)).items()}
        model.objective_pallas(loc_g, DT, n_steps, q=SHARDED_Q).backward()
        sharded_grad.last = loc_g

    zero_counts()
    sharded.objective_supersteps = 0
    t0 = time.perf_counter()
    g_main = cuda_times(sharded_grad, 1, warm_up=False)
    wall = time.perf_counter() - t0
    loc_g = sharded_grad.last
    n_ss = SHARDED_ADJ_STEPS // SHARDED_Q
    b = max(1, math.isqrt(n_ss))
    a, rem = divmod(n_ss, b)
    counts = kernel_launches()
    log(f"[22] main path: bench.py's sharded adjoint, grad of objective_pallas, "
        f"{HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32, P=1 q={SHARDED_Q}, {SHARDED_ADJ_STEPS} steps: "
        f"{wall:.3f} s wall (scatter .. grad); launches tiled_step {counts['tiled_step']} = the "
        f"supersteps run forward {sharded.objective_supersteps} ({n_ss} forward, the "
        f"checkpoints' recomputes {counts['tiled_step'] - n_ss}; n + a (2b - 1) + rem = "
        f"{n_ss + a * (2 * b - 1) + rem} for a = {a} chunks of b = {b})")
    if counts["tiled_step"] != sharded.objective_supersteps or counts["tiled_step"] < n_ss:
        raise AssertionError(f"sharded adjoint counts {counts}, {sharded.objective_supersteps}")
    for k, v in loc_g.items():
        if not all(x.grad is None or bool(torch.isfinite(x.grad).all()) for x in v):
            raise AssertionError(f"sharded adjoint: d_{k} is not finite")
    del loc_g
    sharded_grad.last = None
    g_times = cuda_times(lambda: sharded_grad(SHARDED_ADJ_TIMED_STEPS), REPS, warm_up=False)
    log(f"[22] sharded adjoint: {SHARDED_ADJ_STEPS} steps {g_main[0]:.6g} s per grad "
        f"({g_main[0] / SHARDED_ADJ_STEPS * 1e6:.6g} us per step); {SHARDED_ADJ_TIMED_STEPS} "
        f"steps {spread(g_times)} per grad, "
        f"{spread([t / SHARDED_ADJ_TIMED_STEPS for t in g_times], 1e6, 'us')} per step [{gpu}]")

    dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
    bound, bound_by = window_bound(*dims, frozenset(), SHARDED_Q)
    launch_ms = statistics.median(launch_us) / 1e3
    log(f"[22] received-halo arm per launch {launch_ms * 1e3:.6g} us, bound {bound * 1e6:.6g} "
        f"us ({bound_by}), x{launch_ms / 1e3 / bound:.2f} of it; phase 22 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return [{
        "name": "tiled_step (received halos)",
        "route": "cuda",
        "source": "mpas_ocean_tpu_torch/csrc/tiled_step.cu",
        "replaces": "mpas_ocean_tpu/structured/pallas_model.py:852 (received halos, "
                    "sharded.py:1640-1886)",
        "launches": want_l,
        "max_abs_err": launch_err,
        "ms": launch_ms,
        "plain_ms": statistics.median(plain_s) * 1e3,
        "bound_ms": bound * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
        "q": SHARDED_Q,
        "plan": [su["row_tile"], su["col_tile"]],
        "f64_checks": n_checks,
        "f32_gap_ratios": ratios,
        "us_per_step": {k: statistics.median(t) * 1e6 for k, t in times.items()},
        "ms_per_call_by_events": statistics.median(call_s) * 1e3,
        "sharded_adjoint_s_per_grad": g_main[0],
        "sharded_adjoint_steps": SHARDED_ADJ_STEPS,
        f"sharded_adjoint_s_per_grad_{SHARDED_ADJ_TIMED_STEPS}_steps": statistics.median(g_times),
    }]


def ptxas_report(log_text: str, kernels: tuple, arm=None) -> list:
    """ptxas's lines (registers, spills) for the entry functions whose
    mangled names contain one of ``kernels``; with ``arm`` (a string, or a
    tuple of alternatives), only those whose mangled template arguments end
    so: "Lb1EEEv" for the last one true (every lattice kernel's kStrat),
    "Lb1ELb0EEEv" for the second last true and the last false (their
    kTracers), "Lb1ELb0ELb0EEEv" for the third last true and the last two
    false (their forced arms)."""
    arms = (arm,) if isinstance(arm, str) else arm
    out, keep = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in kernels) and (
                arms is None or any(a in line for a in arms))
        if keep and ("Compiling" in line or "registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def grad_256_child() -> dict:
    """The tracer-free grad of sum(ssh_final^2) at 256x256x100 f32 over
    LARGE_ADJ_STEPS steps through fused_rollout_diff and tiled_rollout_diff,
    from the lattice state, in this process alone: (median, min, max)
    seconds of REPS grads each, and each grad's profiler breakdown by
    kernel."""
    import numpy as np

    from mpas_ocean_tpu_torch.structured import fused_rollout_diff, tiled_rollout_diff

    _, _, model, prog = igw_case(LARGE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    out = {}
    for route in (fused_rollout_diff, tiled_rollout_diff):
        t = cuda_times(lambda: grad_sum_ssh2(route, st, sm, LARGE_ADJ_STEPS), REPS)
        by_kernel, window_us, busy_us = profile_by_kernel(
            lambda: grad_sum_ssh2(route, st, sm, LARGE_ADJ_STEPS),
            ("fe_step_kernel", "adjoint_step_kernel", "tiled_adjoint_kernel", "ddt_reduce"))
        out[route.__name__] = {"s": [statistics.median(t), min(t), max(t)],
                               "by_kernel": by_kernel, "window_us": window_us,
                               "busy_us": busy_us}
    return out


def fresh_grad_256(gpu: str) -> dict:
    """Runs ``grad_256_child`` in a fresh process of this script and logs
    its times beside EARLIER_GRAD_S (the fused 256^2 grad read x1.158 of
    its earlier time in one run, and x1.011 in the next) and its profiler
    breakdowns. Returns the child's result."""
    proc = subprocess.run([sys.executable, __file__, "--grad-256"], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the fresh 256^2 grad process failed:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, key in (("fused_rollout_diff", "256 fused"), ("tiled_rollout_diff", LARGE_N)):
        med, lo, hi = res[name]["s"]
        log(f"[8] fresh process: grad of sum(ssh^2) through {name}, {LARGE_N}x{LARGE_N}x{LEVELS} "
            f"f32, {LARGE_ADJ_STEPS} steps: {med:.6g} s (median of {REPS}, min {lo:.6g}, max "
            f"{hi:.6g}); earlier {EARLIER_GRAD_S[key]} s, now x{med / EARLIER_GRAD_S[key]:.4f} "
            f"[{gpu}]")
        by_kernel = {k: tuple(v) for k, v in res[name]["by_kernel"].items()}
        log(f"[8] fresh process, profiler, one grad through {name} "
            f"({res[name]['window_us']:.0f} us by events): "
            + profile_line(by_kernel, res[name]["window_us"], res[name]["busy_us"],
                           gpu))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    import numpy as np

    from mpas_ocean_tpu_torch.kernels import build, fe_step
    from mpas_ocean_tpu_torch.structured import (
        fused_run_loop,
        structured_auto_run_loop,
        structured_run_loop,
    )
    from mpas_ocean_tpu_torch.utils import error_measures

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment -------------------------------------------------------
    gpu = gpu_line()
    log(f"[1] gpu: {gpu}; torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[1] nvcc {nvcc}: {ver}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    log(f"[2] built {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    log_file = lib_path.with_suffix(".log")
    if log_file.exists():
        for line in log_file.read_text().splitlines():
            if line.startswith("nvcc "):  # a source's compile seconds
                log(f"[2] {line}")
            elif "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[2] ptxas {line.strip()}")

    # -- 9. the card's measured peaks (kernel 5), the divisor of every bound
    # printed from here on ------------------------------------------------------
    if "--grad-256" in sys.argv[1:]:
        # the fresh process of fresh_grad_256: one JSON line, nothing else
        print(json.dumps(grad_256_child()))
        return 0
    probe_entries = peaks_phase(gpu, log_file.read_text())
    if "--tracer-reverse-only" in sys.argv[1:]:
        # phase 16 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": tracer_reverse_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--strat-only" in sys.argv[1:]:
        # phase 17 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": strat_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--strat-reverse-only" in sys.argv[1:]:
        # phase 18 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": strat_reverse_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--tracers-only" in sys.argv[1:]:
        # phase 15 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": tracer_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--forcing-only" in sys.argv[1:]:
        # phase 14 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": forcing_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--window-only" in sys.argv[1:]:
        # phase 21 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": window_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--nl-window-only" in sys.argv[1:]:
        # phase 21's part for the q-step nonlinear reverse alone (after the
        # build and the peaks its bounds divide by)
        print(json.dumps({"kernels": [nl_window_section(gpu, log_file.read_text())]}))
        print(gpu)
        return 0
    if "--sharded-only" in sys.argv[1:]:
        # phase 22 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": sharded_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--physics-only" in sys.argv[1:]:
        # phase 19 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": composed_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0
    if "--composed-reverse-only" in sys.argv[1:]:
        # phase 20 alone (after the build and the peaks its bounds divide by)
        print(json.dumps({"kernels": composed_reverse_phase(gpu, log_file.read_text())}))
        print(gpu)
        return 0

    # -- 3. kernel against its plain version on the card ---------------------
    model, prog = random_case(16, 4)
    st, sm = model.to_struct(prog), model.struct_mesh
    errs = field_errors(fused_run_loop(st, sm, 10.0, 20),
                        structured_run_loop(st, sm, 10.0, 20), sm.resting_thickness_sum)
    log(f"[3] f64 16x16x4 random, 20 steps, kernel vs plain: max|diff| "
        f"(/scale) = {format_errors(errs)}")
    for f, (_, r) in errs.items():
        if not r <= 1e-12:
            raise AssertionError(f"f64 kernel vs plain: {f} relative error {r:.3e} > 1e-12")

    horz, igw, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    kern = fused_run_loop(st, sm, DT, 100)
    plain = structured_run_loop(st, sm, DT, 100)
    torch.cuda.synchronize()
    errs = field_errors(kern, plain, sm.resting_thickness_sum)
    log(f"[3] f32 {HEADLINE_N}x{HEADLINE_N}x{LEVELS} IGW, 100 steps, kernel vs plain: "
        f"max|diff| (/scale) = {format_errors(errs)}")
    max_abs_err = max(e for e, _ in errs.values())
    # f32 bounds: the two sum each 100-level column in another order, so
    # ssh differs by a few ulp of the ~1000 m column; through g dt grad(ssh)
    # that moves u by ~1e-4 of max|u| over 100 steps (1.3e-4 measured on an
    # H100, 700 W), hence 3e-4 for u
    tol = {"ssh": 1e-5, "layer_thickness": 1e-5, "normal_velocity": 3e-4}
    for f, (_, r) in errs.items():
        if not r <= tol[f]:
            raise AssertionError(f"f32 kernel vs plain: {f} relative error {r:.3e} > {tol[f]}")

    # -- 4. main path at the headline size --------------------------------------
    sites = 2 * sm.ny2 * sm.nx * LEVELS
    fe_step.launches = 0
    t0 = time.perf_counter()
    st = model.to_struct(prog)
    out = structured_auto_run_loop(st, model.struct_mesh, DT, HEADLINE_STEPS)
    final = model.from_struct(out)
    wall = time.perf_counter() - t0
    launches = fe_step.launches
    log(f"[4] main path {HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32, {HEADLINE_STEPS} "
        f"steps: {wall:.3f} s wall (to_struct .. from_struct), "
        f"fe_step launches {launches}")
    if launches != HEADLINE_STEPS:
        raise AssertionError(f"fe_step launched {launches} times, expected {HEADLINE_STEPS}")
    for f in FIELDS:
        x = getattr(final, f)
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"main path: {f} is not finite")
    if tuple(final.normal_velocity.shape) != (horz.n_edges, LEVELS) or tuple(
            final.ssh.shape) != (horz.n_cells,):
        raise AssertionError("main path: wrong output shapes")

    st = model.to_struct(prog)
    # fe_step timed directly, whichever kernel the size rule picks for FE
    k_out, k_times = timed_rollout(
        lambda n: fused_run_loop(st, sm, DT, n), HEADLINE_STEPS, REPS)
    # the plain version is timed over 100-step runs (its time per step does
    # not depend on the depth; 8000-step runs took ~48 s of this script) and
    # runs PHYSICS_STEPS once for the f32 error below
    _, p_times = timed_rollout(
        lambda n: structured_run_loop(st, sm, DT, n), TILED_CHECK_STEPS, REPS)
    p_out = structured_run_loop(st, sm, DT, PHYSICS_STEPS)
    log("[4] " + rate_line("kernel", k_times, sites, gpu, "fe_step 64"))
    log("[4] " + rate_line("plain ", p_times, sites, gpu))
    dims_h = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
    tile_h = fe_step.fe_tile(sm.ny2, sm.nx, LEVELS, 4)
    plan_h = fe_step.launch_plan(sm.host_stencil[0], sm.ny2, sm.nx, LEVELS, tile_h)
    log(f"[4] fe_step tile {tile_h}: {plan_h['clusters']} clusters, "
        f"{plan_h['blocks_per_sm']} blocks of 512 threads per SM (occupancy query); "
        + share_line("fe_step", k_times, step_bound("fe_step", *dims_h)[0],
                     alt_bounds(step_bound, "fe_step", *dims_h)))
    # the launch gaps: the same steps as one stream of programmatically
    # dependent launches (above) and as a CUDA graph of 100 steps, replayed
    graph_s = graph_times(st, sm, 100, HEADLINE_STEPS // 100, REPS)
    log(f"[4] fe_step per step in a replayed CUDA graph of 100 steps: "
        f"{spread(graph_s, 1e6, 'us')}; in stream launches "
        f"{spread(k_times, 1e6, 'us')} [{gpu}]")
    # The IGW error after PHYSICS_STEPS FE steps. FE is unstable for gravity waves
    # and grows the grid-scale modes fastest, so in f32 the column-sum
    # rounding noise grows to dominate the error of both versions (~0.8
    # against ~0.3 in f64, on an H100 at 700 W); the physics check is
    # the same path in f64 through the kernel against an independent f64 run
    # of the plain version on the host with one 1000 m layer (identical
    # layers make the 100-layer system the 1-layer one).
    t_end = PHYSICS_STEPS * DT
    exact = igw.exact_ssh(np.asarray(horz.cells.x, np.float64),
                          np.asarray(horz.cells.y, np.float64), t_end)

    def l2(ssh):
        return error_measures(ssh.double().numpy(), exact, horz, "cell").L_two

    k32 = model.from_struct(fused_run_loop(st, sm, DT, PHYSICS_STEPS))
    l2_k, l2_p = l2(k32.ssh), l2(model.from_struct(p_out).ssh)
    _, _, model64, prog64 = igw_case(HEADLINE_N, LEVELS, np.float64)
    k64 = model64.from_struct(structured_auto_run_loop(
        model64.to_struct(prog64), model64.struct_mesh, DT, PHYSICS_STEPS))
    _, _, model1, prog1 = igw_case(HEADLINE_N, 1, np.float64, device="cpu")
    ref = model1.from_struct(structured_run_loop(
        model1.to_struct(prog1), model1.struct_mesh, DT, PHYSICS_STEPS))
    l2_k64, l2_ref = l2(k64.ssh), l2(ref.ssh)
    igw_l2 = l2_k
    log(f"[4] IGW ssh L2 error vs exact at t={t_end:.0f} s: f32 kernel {l2_k:.6e}, "
        f"f32 plain {l2_p:.6e}; f64 kernel {l2_k64:.6e}, f64 1-layer host "
        f"reference {l2_ref:.6e}")
    ssh_gap = float(np.abs(k64.ssh.numpy() - ref.ssh.numpy()).max())
    log(f"[4] f64 kernel vs f64 host reference: max|ssh diff| {ssh_gap:.3e} m")
    # f64 rounding (~1e-13 m) grown by FE's grid-scale amplification stays
    # far below 1e-6 m; the f32 runs differ from each other by ~1e-1
    if not (ssh_gap <= 1e-6 and abs(l2_k64 - l2_ref) <= 1e-6):
        raise AssertionError(f"f64 IGW off the host reference: {ssh_gap}, {l2_k64}, {l2_ref}")
    if not (np.isfinite(l2_k) and np.isfinite(l2_p) and l2_k < 2.0 and l2_p < 2.0):
        raise AssertionError(f"f32 IGW error out of range: kernel {l2_k}, plain {l2_p}")

    # -- 5. 256x256x100 ----------------------------------------------------------
    horz_l, _, model_l, prog_l = igw_case(LARGE_N, LEVELS, np.float32)
    st_l, sm_l = model_l.to_struct(prog_l), model_l.struct_mesh
    sites_l = 2 * sm_l.ny2 * sm_l.nx * LEVELS
    kl_out, kl_times = timed_rollout(
        lambda n: fused_run_loop(st_l, sm_l, DT, n), LARGE_STEPS, REPS)
    pl_out, pl_times = timed_rollout(
        lambda n: structured_run_loop(st_l, sm_l, DT, n), LARGE_STEPS, REPS)
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(kl_out, f)).all()):
            raise AssertionError(f"{LARGE_N}x{LARGE_N}: {f} is not finite")
    errs_l = field_errors(kl_out, pl_out, sm_l.resting_thickness_sum)
    log(f"[5] {LARGE_N}x{LARGE_N}x{LEVELS} f32, {LARGE_STEPS} steps, kernel vs "
        f"plain: max|diff| (/scale) = {format_errors(errs_l)}")
    # the same size in f64, where the two may differ only by roundoff
    _, _, model_l64, prog_l64 = igw_case(LARGE_N, LEVELS, np.float64)
    st_l64, sm_l64 = model_l64.to_struct(prog_l64), model_l64.struct_mesh
    errs_l64 = field_errors(fused_run_loop(st_l64, sm_l64, DT, 20),
                            structured_run_loop(st_l64, sm_l64, DT, 20),
                            sm_l64.resting_thickness_sum)
    log(f"[5] {LARGE_N}x{LARGE_N}x{LEVELS} f64, 20 steps, kernel vs plain: "
        f"max|diff| (/scale) = {format_errors(errs_l64)}")
    for f, (_, r) in errs_l64.items():
        if not r <= 1e-12:
            raise AssertionError(f"f64 {LARGE_N}x{LARGE_N} kernel vs plain: {f} {r:.3e} > 1e-12")
    log("[5] " + rate_line("kernel", kl_times, sites_l, gpu))
    log("[5] " + rate_line("plain ", pl_times, sites_l, gpu))

    # -- 6. the gradient ------------------------------------------------------
    from mpas_ocean_tpu_torch.kernels import adjoint_step
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        adjoint_plan,
        fused_adjoint_rollout,
        fused_rollout_diff,
        structured_adjoint_run_loop,
        structured_adjoint_step,
    )
    from mpas_ocean_tpu_torch.structured.fused_model import _scal
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    for line in ptxas_report(log_file.read_text(), ("adjoint_step_kernel", "ddt_reduce")):
        log(f"[6] ptxas {line}")

    fields = state_fields

    def plain_reverse(st, sm, dt, n, g):
        """The plain adjoint step back through the forward kernel's own
        primal states (which the kernel sweep rebuilds bit for bit), so
        that a comparison sees only the adjoint's arithmetic: the plain
        forward's states differ from the kernel's by the rounding of
        ssh = sum_k h - rts, which d(dt) picks up through grad(ssh)."""
        states = [st]
        for _ in range(n - 1):
            states.append(fused_run_loop(states[-1], sm, dt, 1))
        ddt = torch.zeros((), dtype=torch.float64, device=dev)
        for s in reversed(states):
            g, dd = structured_adjoint_step(s, g, sm, dt)
            ddt = ddt + dd
        return g, ddt

    # f64, 16x16x4 random state and cotangent: kernel against plain, twice
    model, prog = random_case(16, 4)
    st, sm = model.to_struct(prog), model.struct_mesh
    g = random_cot(st, 11)
    for n in (1, 7):
        out, ddt = fused_adjoint_rollout(st, sm, 10.0, n, g, plan=3)
        again, ddt_again = fused_adjoint_rollout(st, sm, 10.0, n, g, plan=3)
        ref, ref_dt = plain_reverse(st, sm, 10.0, n, g)
        errs = cot_errors(out, ref, ddt, ref_dt)
        repeat = torch.equal(ddt, ddt_again) and all(
            torch.equal(x, y) for x, y in zip(fields(out), fields(again)))
        log(f"[6] f64 16x16x4 random, {n} reverse steps, adjoint kernel vs plain: "
            f"max|diff| (/scale) = {format_errors(errs)}; rerun bitwise equal: {repeat}")
        for f, (_, r) in errs.items():
            if not r <= 1e-12:
                raise AssertionError(f"f64 adjoint kernel vs plain: {f} {r:.3e} > 1e-12")
        if not repeat:
            raise AssertionError("f64 adjoint rerun is not bitwise equal")

    # the dot-product identity <J v, g> = <v, J^T g>, J the 7-step rollout's
    # Jacobian: J v by forward-mode AD of the plain rollout (which the kernel
    # rollout matches to 1e-12), J^T g by the kernels
    v = random_cot(st, 12)

    def rollout7(*xs):
        return tuple(fields(structured_run_loop(StructState(*xs), sm, 10.0, 7)))

    _, jv = torch.func.jvp(rollout7, tuple(fields(st)), tuple(fields(v)))
    lhs = sum(float((x * y).sum()) for x, y in zip(jv, fields(g)))
    d7, _ = fused_adjoint_rollout(st, sm, 10.0, 7, g)
    rhs = sum(float((x * y).sum()) for x, y in zip(fields(v), fields(d7)))
    dot_err = abs(lhs - rhs) / abs(rhs)
    log(f"[6] f64 dot-product identity, 7 steps: <Jv, g> {lhs:.17g}, <v, J^T g> "
        f"{rhs:.17g}, relative gap {dot_err:.3e}")
    if not dot_err <= 1e-12:
        raise AssertionError(f"dot-product identity off by {dot_err:.3e} > 1e-12")

    # f32 headline IGW, 100 reverse steps from the cotangent of sum(ssh^2)
    horz, igw, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32)
    st, sm = model.to_struct(prog), model.struct_mesh
    fin = fused_run_loop(st, sm, DT, PLAIN_ADJ_STEPS)
    g = StructState(2 * fin.ssh, torch.zeros_like(fin.layer_thickness),
                    torch.zeros_like(fin.normal_velocity))
    k_adj, k_ddt = fused_adjoint_rollout(st, sm, DT, PLAIN_ADJ_STEPS, g)
    p_adj, p_ddt = plain_reverse(st, sm, DT, PLAIN_ADJ_STEPS, g)
    w_adj, w_ddt = structured_adjoint_run_loop(st, sm, DT, PLAIN_ADJ_STEPS, g)
    torch.cuda.synchronize()
    log(f"[6] f32 {HEADLINE_N}x{HEADLINE_N}x{LEVELS} IGW, {PLAIN_ADJ_STEPS} reverse steps, "
        f"kernel sweep vs the all-plain reverse (plain forward too): max|diff| (/scale) = "
        f"{format_errors(cot_errors(k_adj, w_adj, k_ddt, w_ddt))}")
    errs = cot_errors(k_adj, p_adj, k_ddt, p_ddt)
    log(f"[6] f32 {HEADLINE_N}x{HEADLINE_N}x{LEVELS} IGW, {PLAIN_ADJ_STEPS} reverse steps, "
        f"adjoint kernel vs plain on the same primal states: max|diff| (/scale) = "
        f"{format_errors(errs)}")
    adj_max_abs_err = max(e for f, (e, _) in errs.items() if f != "d_dt")
    # f32 bounds, from an H100 (700 W) run: on the same primal states the
    # two differ by summation order only. d_ssh, a difference of 100-level
    # column sums of the cotangent, came in at 1.6e-6 of its scale; d_h,
    # d_u and d(dt) at 2-4e-7. The bounds leave 6-10x. Against the plain
    # forward's states, d(dt) also carries the forward's f32 rounding of
    # ssh = sum_k h - rts (1.8e-4 m on the ~1000 m column, phase 3) through
    # grad(ssh): 2.0e-4 measured, bound 2e-3; the fields do not see it.
    tol = {"ssh": 1e-5, "layer_thickness": 2e-6, "normal_velocity": 2e-6, "d_dt": 4e-6}
    for f, (_, r) in errs.items():
        if not r <= tol[f]:
            raise AssertionError(f"f32 adjoint kernel vs plain: {f} {r:.3e} > {tol[f]}")
    for f, (_, r) in cot_errors(k_adj, w_adj, k_ddt, w_ddt).items():
        bound = 2e-3 if f == "d_dt" else tol[f]
        if not r <= bound:
            raise AssertionError(f"f32 kernel sweep vs all-plain reverse: {f} {r:.3e} > {bound}")

    # per-step times at the headline size: the plain adjoint step, the kernel
    # inside a group of the main path's length, and one launch alone
    state_bytes = sum(x.numel() * x.element_size() for x in fields(st))
    group = adjoint_plan(GRAD_STEPS, state_bytes, math.inf)
    f_edge, (adj_tab, adj_w) = sm.f_edge, sm.host_adjoint_stencil
    scal = _scal(sm, DT, torch.float32)
    stack = tuple(torch.empty((group, *x.shape), dtype=x.dtype, device=dev)
                  for x in fields(st))
    for dst, x in zip(stack, fields(st)):
        dst[0].copy_(x)
    fe_step.fe_fill_stack(stack, f_edge, sm.resting_thickness_sum, *sm.host_stencil, *scal,
                          group - 1)
    ddt_acc = torch.zeros(1, dtype=torch.float64, device=dev)
    g_in = tuple(x.contiguous() for x in fields(g))

    def adj_run(n):
        return adjoint_step.adjoint_rollout(stack, g_in, f_edge, adj_tab, adj_w, *scal, n,
                                            ddt_acc)

    ka_times = [t / 1e6 for t in held_us(lambda: adj_run(group), group, REPS)]
    _, k1_times = timed_rollout(lambda n: [adj_run(1) for _ in range(n)], 100, REPS)

    def plain_adj(n):
        gg = g
        for _ in range(n):
            gg, _ = structured_adjoint_step(st, gg, sm, DT)
        return gg

    _, pa_times = timed_rollout(plain_adj, PLAIN_ADJ_STEPS, REPS)
    tile_a = adjoint_step.adjoint_tile(sm.ny2, sm.nx, LEVELS, 4)
    plan_a = adjoint_step.launch_plan(adj_tab, sm.ny2, sm.nx, LEVELS, tile_a)
    log(f"[6] adjoint_step tile {tile_a}: {plan_a['clusters']} clusters, "
        f"{plan_a['blocks_per_sm']} blocks of 512 threads per SM, {plan_a['smem_bytes']} bytes "
        f"of shared memory per block (occupancy query)")
    log(f"[6] adjoint_step per step, {HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32: device time in a "
        f"{group}-step call {spread(ka_times, 1e6, 'us')}; one call of 1 step (kernel, "
        f"d(dt) sum, host) {spread(k1_times, 1e6, 'us')}; plain "
        f"{spread(pa_times, 1e6, 'us')}; earlier {EARLIER_US['adjoint_step 64']:.3f} us, now x"
        f"{statistics.median(ka_times) * 1e6 / EARLIER_US['adjoint_step 64']:.4f} [{gpu}]")

    # the slice at full width: grad of sum(ssh_final^2) over 4000 steps
    def grad_run(st, sm, n_steps):
        return grad_sum_ssh2(fused_rollout_diff, st, sm, n_steps)

    fe_step.launches = adjoint_step.launches = 0
    t0 = time.perf_counter()
    out, grads = grad_run(model.to_struct(prog), model.struct_mesh, GRAD_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grad_fe, grad_adj = fe_step.launches, adjoint_step.launches
    n_groups = -(-GRAD_STEPS // group)
    want_fe = 2 * GRAD_STEPS - n_groups
    log(f"[6] main path: grad of sum(ssh^2) through fused_rollout_diff, "
        f"{HEADLINE_N}x{HEADLINE_N}x{LEVELS} f32, {GRAD_STEPS} steps, groups of {group}: "
        f"{wall:.3f} s wall (to_struct .. grad); launches fe_step {grad_fe} (want "
        f"{want_fe}), adjoint_step {grad_adj} (want {GRAD_STEPS})")
    if (grad_fe, grad_adj) != (want_fe, GRAD_STEPS):
        raise AssertionError(f"launch counts {grad_fe}, {grad_adj} != {want_fe}, {GRAD_STEPS}")
    for name, x in zip(("d_ssh", "d_h", "d_u", "d_dt"), grads):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"main path gradient {name} is not finite")
    log(f"[6] |d_ssh|max {float(grads[0].abs().max()):.6e}, |d_h|max "
        f"{float(grads[1].abs().max()):.6e}, |d_u|max {float(grads[2].abs().max()):.6e}, "
        f"d_dt {float(grads[3]):.6e}")
    ref = fused_run_loop(st, sm, DT, GRAD_STEPS)
    if not all(torch.equal(x, y) for x, y in zip(fields(out), fields(ref))):
        raise AssertionError("fused_rollout_diff's forward differs from fused_run_loop")
    log("[6] fused_rollout_diff forward is bitwise fused_run_loop's")
    g_times = cuda_times(lambda: grad_run(st, sm, GRAD_STEPS), REPS)
    log(f"[6] grad from the lattice state, {GRAD_STEPS} steps (earlier "
        f"{EARLIER_GRAD_S[HEADLINE_N]} s): {spread(g_times)} per grad, "
        f"{spread([t / GRAD_STEPS for t in g_times], 1e6, 'us')} per rollout step [{gpu}]")
    # where one grad's device time goes, by kernel, from a profiler trace
    by_kernel, window_us, busy_us = profile_by_kernel(
        lambda: grad_run(st, sm, GRAD_STEPS),
        ("fe_step_kernel", "adjoint_step_kernel", "ddt_reduce"))
    log(f"[6] profiler, one grad ({window_us:.0f} us by events): "
        + profile_line(by_kernel, window_us, busy_us, gpu))
    log(f"[6] {ddt_line(by_kernel)}")
    prof_ms = {k: t / max(c, 1) / 1e3 for k, (t, c) in by_kernel.items()}

    # 256x256x100: the adjoint in f64 against plain (phase 8 times the
    # grad there through both reverses)
    _, _, model_l64, prog_l64 = igw_case(LARGE_N, LEVELS, np.float64)
    st_l64, sm_l64 = model_l64.to_struct(prog_l64), model_l64.struct_mesh
    g_l64 = random_cot(st_l64, 13)
    out_l64, ddt_l64 = fused_adjoint_rollout(st_l64, sm_l64, DT, 5, g_l64)
    ref_l64, ref_ddt_l64 = plain_reverse(st_l64, sm_l64, DT, 5, g_l64)
    errs = cot_errors(out_l64, ref_l64, ddt_l64, ref_ddt_l64)
    log(f"[6] {LARGE_N}x{LARGE_N}x{LEVELS} f64, 5 reverse steps, adjoint kernel vs plain: "
        f"max|diff| (/scale) = {format_errors(errs)}")
    for f, (_, r) in errs.items():
        if not r <= 1e-12:
            raise AssertionError(f"f64 {LARGE_N}x{LARGE_N} adjoint vs plain: {f} {r:.3e} > 1e-12")

    # -- 7. the tiled path -------------------------------------------------------
    tiled_entry, periodic_fwd = tiled_phase(gpu, log_file.read_text(), {
        HEADLINE_N: statistics.median(k_times) * 1e6,
        LARGE_N: statistics.median(kl_times) * 1e6,
    })

    # -- 8. the tiled reverse ----------------------------------------------------
    tiled_adj_entry, adjoint_256 = tiled_adjoint_phase(gpu, log_file.read_text(), g_times)
    fresh = fresh_grad_256(gpu)
    tiled_adj_entry["grad_s_256_fresh_process"] = fresh["tiled_rollout_diff"]["s"][0]
    tiled_adj_entry["grad_s_256_fused_fresh_process"] = fresh["fused_rollout_diff"]["s"][0]

    # -- 10. the coastal Kelvin channel forward -----------------------------------
    masked = channel_forward_phase(gpu, {"fe 64": statistics.median(k_times), **periodic_fwd})

    # -- 11. the gradient on the channel ---------------------------------------------
    masked.update(channel_grad_phase(gpu, {
        "adjoint_step 64": adjoint_256["ms_64_in_40_step_calls"] / 1e3,
        "tiled_adjoint 256": tiled_adj_entry["ms"] / 1e3,
        "grad 64": statistics.median(g_times),
        "grad 256": tiled_adj_entry["grad_s_256"],
    }))

    # -- 12. the nonlinear forward -----------------------------------------------
    nonlinear = nonlinear_phase(gpu, log_file.read_text(), {
        "fe 64": statistics.median(k_times), **periodic_fwd,
        "channel fe 64": masked["fe_step"]["masked_ms"] / 1e3, "igw l2": igw_l2,
    })

    # -- 13. the nonlinear reverse -----------------------------------------------
    nl_adjoint_entry = nl_reverse_phase(gpu, log_file.read_text())

    # -- 14. momentum forcing -----------------------------------------------------
    forced_entries = forcing_phase(gpu, log_file.read_text())

    # -- 15. tracer transport -----------------------------------------------------
    tracer_entries = tracer_phase(gpu, log_file.read_text())

    # -- 16. the tracer reverse ----------------------------------------------------
    tracer_entries += tracer_reverse_phase(gpu, log_file.read_text())

    # -- 17. layered stratification -------------------------------------------------
    strat_entries = strat_phase(gpu, log_file.read_text())

    # -- 18. the stratified reverse ---------------------------------------------------
    strat_entries += strat_reverse_phase(gpu, log_file.read_text())

    # -- 19. composed physics ------------------------------------------------------------
    composed_entries = composed_phase(gpu, log_file.read_text())

    # -- 20. the composed reverse ---------------------------------------------------------
    composed_entries += composed_reverse_phase(gpu, log_file.read_text())

    # -- 21. temporal blocking, q > 1 -------------------------------------------------------
    window_entries = window_phase(gpu, log_file.read_text())

    # -- 22. the sharded row-slab path ---------------------------------------------------------
    sharded_entries = sharded_phase(gpu, log_file.read_text())
    log("phases 1-22 done")

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    dims = (sm.ny2, sm.nx, LEVELS, len(sm.coriolis_terms), 4)
    kernels = []
    for name, src, replaces, launches_n, err, ms, plain_ms in (
        ("fe_step", "fe_step.cu", "mpas_ocean_tpu/structured/pallas_model.py:320",
         grad_fe, max_abs_err, statistics.median(k_times) * 1e3,
         statistics.median(p_times) * 1e3),
        ("adjoint_step", "adjoint_step.cu", "mpas_ocean_tpu/structured/pallas_model.py:1480",
         grad_adj, adj_max_abs_err, statistics.median(ka_times) * 1e3,
         statistics.median(pa_times) * 1e3),
    ):
        bound, bound_by = step_bound(name, *dims)
        old = alt_bounds(step_bound, name, *dims)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mpas_ocean_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches_n,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound * 1e3,
            "bound_by": bound_by,
            "library_ms": None,
            **alt_keys("bound_ms", old, 1e3),
        })
    kernels[0]["launches_forward_path"] = launches
    kernels[0]["tile"] = list(tile_h)
    kernels[0]["launch_plan"] = plan_h
    kernels[0]["ms_in_cuda_graph"] = statistics.median(graph_s) * 1e3
    for entry, key in zip(kernels, ("fe_step_kernel", "adjoint_step_kernel")):
        entry["ms_in_grad_profiler"] = prof_ms.get(key)
    kernels[1].update(adjoint_256)
    kernels.append(tiled_entry)
    kernels.append(tiled_adj_entry)
    for entry in kernels:
        entry.update(masked[entry["name"]])
        entry.update(nonlinear.get(entry["name"], {}))
    kernels.append(nl_adjoint_entry)
    kernels.extend(forced_entries)
    kernels.extend(tracer_entries)
    kernels.extend(strat_entries)
    kernels.extend(composed_entries)
    kernels.extend(window_entries)
    kernels.extend(sharded_entries)
    kernels.extend(probe_entries)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
