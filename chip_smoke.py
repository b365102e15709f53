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
     kernel and plain timings and the IGW error against the exact solution;
  5. 256x256x100 f32 through the same entry.
The line before the last prints the GPU's name and power limit as nvidia-smi
gives them, the one before it the kernels' JSON summary, and the last line
is {"ok": true, "device": {...}}. Without a CUDA device it exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

DT = 30.0
HEADLINE_N, LEVELS, HEADLINE_STEPS = 64, 100, 8000
LARGE_N, LARGE_STEPS = 256, 200
REPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def igw_case(n: int, levels: int, np_dtype, device):
    """The headline inputs, built as bench.py's build() builds them: uniform
    periodic hex lattice over a 10000 km box, IGW state, dt = 30 s."""
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
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n).to(device)
    return horz, igw, model, prog


def random_case(n: int, levels: int, device, seed: int = 7):
    """A random f64 lattice state (numpy seed), as tests/test_pallas.py
    builds it."""
    import numpy as np
    import torch

    import mpas_ocean_tpu_torch as mt

    horz = mt.planar_hex_mesh(n, n, 1000.0, f0=1e-4, beta=1e-11)
    vert = mt.make_vertical_mesh(
        horz, levels, resting_thickness=np.full((horz.n_cells, levels), 10.0)
    )
    rng = np.random.default_rng(seed)
    h = 10.0 + 0.01 * rng.normal(size=(horz.n_cells, levels))
    u = 0.01 * rng.normal(size=(horz.n_edges, levels))
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy(h.sum(1) - vert.resting_thickness_sum),
        layer_thickness=torch.from_numpy(h),
        normal_velocity=torch.from_numpy(u),
    )
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n).to(device)
    return model, prog


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


def rate_line(name: str, per_step: list, sites: int, gpu: str) -> str:
    med = statistics.median(per_step)
    return (
        f"{name}: {med * 1e6:.3f} us/step (median of {len(per_step)}, "
        f"min {min(per_step) * 1e6:.3f}, max {max(per_step) * 1e6:.3f}), "
        f"{sites / med:.4e} cells*levels*steps/s [{gpu}]"
    )


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
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[2] ptxas {line.strip()}")

    # -- 3. kernel against its plain version on the card ---------------------
    model, prog = random_case(16, 4, dev)
    st, sm = model.to_struct(prog), model.struct_mesh
    errs = field_errors(fused_run_loop(st, sm, 10.0, 20),
                        structured_run_loop(st, sm, 10.0, 20), sm.resting_thickness_sum)
    log(f"[3] f64 16x16x4 random, 20 steps, kernel vs plain: max|diff| "
        f"(/scale) = {format_errors(errs)}")
    for f, (_, r) in errs.items():
        if not r <= 1e-12:
            raise AssertionError(f"f64 kernel vs plain: {f} relative error {r:.3e} > 1e-12")

    horz, igw, model, prog = igw_case(HEADLINE_N, LEVELS, np.float32, dev)
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
    k_out, k_times = timed_rollout(
        lambda n: structured_auto_run_loop(st, sm, DT, n), HEADLINE_STEPS, REPS)
    p_out, p_times = timed_rollout(
        lambda n: structured_run_loop(st, sm, DT, n), HEADLINE_STEPS, REPS)
    log("[4] " + rate_line("kernel", k_times, sites, gpu))
    log("[4] " + rate_line("plain ", p_times, sites, gpu))
    # The IGW error after 8000 FE steps. FE is unstable for gravity waves
    # and grows the grid-scale modes fastest, so in f32 the column-sum
    # rounding noise grows to dominate the error of both versions (~0.8
    # against ~0.3 in f64, on an H100 at 700 W); the physics check is
    # the same path in f64 through the kernel against an independent f64 run
    # of the plain version on the host with one 1000 m layer (identical
    # layers make the 100-layer system the 1-layer one).
    t_end = HEADLINE_STEPS * DT
    exact = igw.exact_ssh(np.asarray(horz.cells.x, np.float64),
                          np.asarray(horz.cells.y, np.float64), t_end)

    def l2(ssh):
        return error_measures(ssh.double().numpy(), exact, horz, "cell").L_two

    l2_k, l2_p = l2(final.ssh), l2(model.from_struct(p_out).ssh)
    _, _, model64, prog64 = igw_case(HEADLINE_N, LEVELS, np.float64, dev)
    k64 = model64.from_struct(structured_auto_run_loop(
        model64.to_struct(prog64), model64.struct_mesh, DT, HEADLINE_STEPS))
    _, _, model1, prog1 = igw_case(HEADLINE_N, 1, np.float64, torch.device("cpu"))
    ref = model1.from_struct(structured_run_loop(
        model1.to_struct(prog1), model1.struct_mesh, DT, HEADLINE_STEPS))
    l2_k64, l2_ref = l2(k64.ssh), l2(ref.ssh)
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

    # -- 5. 256x256x100 through the same entry ----------------------------------
    horz_l, _, model_l, prog_l = igw_case(LARGE_N, LEVELS, np.float32, dev)
    st_l, sm_l = model_l.to_struct(prog_l), model_l.struct_mesh
    sites_l = 2 * sm_l.ny2 * sm_l.nx * LEVELS
    kl_out, kl_times = timed_rollout(
        lambda n: structured_auto_run_loop(st_l, sm_l, DT, n), LARGE_STEPS, REPS)
    pl_out, pl_times = timed_rollout(
        lambda n: structured_run_loop(st_l, sm_l, DT, n), LARGE_STEPS, REPS)
    for f in FIELDS:
        if not bool(torch.isfinite(getattr(kl_out, f)).all()):
            raise AssertionError(f"{LARGE_N}x{LARGE_N}: {f} is not finite")
    errs_l = field_errors(kl_out, pl_out, sm_l.resting_thickness_sum)
    log(f"[5] {LARGE_N}x{LARGE_N}x{LEVELS} f32, {LARGE_STEPS} steps, kernel vs "
        f"plain: max|diff| (/scale) = {format_errors(errs_l)}")
    # the same size in f64, where the two may differ only by roundoff
    _, _, model_l64, prog_l64 = igw_case(LARGE_N, LEVELS, np.float64, dev)
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

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "fe_step",
        "route": "cuda",
        "source": "mpas_ocean_tpu_torch/csrc/fe_step.cu",
        "replaces": "mpas_ocean_tpu/structured/pallas_model.py:320",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": statistics.median(k_times) * 1e3,
        "plain_ms": statistics.median(p_times) * 1e3,
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
