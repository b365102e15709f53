"""Time the kernels' stratified arms on the card, beside their unstratified
arms, to compare checkouts of the package.

    python -m mpas_ocean_tpu_torch.tools.strat_timing [--sizes 64 256] [--steps 1000]
    python -m mpas_ocean_tpu_torch.tools.strat_timing --reverse [--sizes 64 256]

For each lattice size (n x n cells, 100 levels, f32, the inertial-gravity
wave at dt = 30 s, bench.py's densities 1025 + linspace(0, 1, 100)) it times
``structured_auto_run_loop`` FE (fe_step) and FB (tiled_step, the
planner's plan), stratified and unstratified in turns (unstratified,
stratified, stratified, unstratified), each the device µs per step of one
``--steps`` rollout by CUDA events after a warm-up rollout; with
``--reverse``, the reverse kernels instead (adjoint_step, and tiled_adjoint
at q = 1 on its planner's tile), each the device µs per launch of a
40-step call through a stack of stratified states by
``reverse_timing.held_us``, in the same turns. Prints one JSON line with
every rep's µs, the card and the package's path. To compare checkouts on
one card, run this file against each in turn:

    PYTHONPATH=<checkout> python <checkout under test>/mpas_ocean_tpu_torch/tools/strat_timing.py

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import mpas_ocean_tpu_torch
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.structured import structured_auto_run_loop
from mpas_ocean_tpu_torch.tools.tile_sweep import DT, LEVELS, igw_lattice


def us_per_step(run, n_steps: int) -> float:
    """Device µs per step of run(n_steps), by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(n_steps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n_steps


def time_size(n: int, n_steps: int) -> dict:
    """{"FE" / "FB": {"strat": [µs], "unstrat": [µs]}} at n x n cells."""
    model, st = igw_lattice(n)
    sm = model.struct_mesh
    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, LEVELS), dtype=np.float32)
    out = {}
    for name, fb in (("FE", False), ("FB", True)):
        runs = {k: (lambda m, s=s: structured_auto_run_loop(st, sm, DT, m, fb=fb, strat=s))
                for k, s in (("unstrat", None), ("strat", strat))}
        for run in runs.values():
            run(10)
        times = {k: [] for k in runs}
        for k in ("unstrat", "strat", "strat", "unstrat"):
            times[k].append(us_per_step(runs[k], n_steps))
        out[name] = times
    return {"n": n, "steps": n_steps, **out}


def time_reverse(n: int, group: int = 40) -> dict:
    """{"adjoint_step" / "tiled_adjoint": {"strat": [µs], "unstrat": [µs]}}
    per launch at n x n cells: ``group`` reverse steps from a random
    cotangent through the stack of stratified states that fe_fill_stack
    builds, each arm on its planner's tile, in turns."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import fused_model
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo, tiled_adjoint_plan
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    model, st = igw_lattice(n)
    sm = model.struct_mesh
    dtype, device = torch.float32, st.ssh.device
    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, LEVELS), dtype=np.float32)
    w = fused_model.kernel_strat(strat, dtype, device)
    scal = fused_model._scal(sm, DT, dtype)
    f_edge = sm.f_edge.to(dtype).contiguous()
    rts = sm.resting_thickness_sum.to(dtype).contiguous()
    fields = (st.ssh, st.layer_thickness, st.normal_velocity)
    full = tuple(torch.empty((group + 1, *x.shape), dtype=dtype, device=device) for x in fields)
    for dst, x in zip(full, fields):
        dst[0].copy_(x)
    fe_step.fe_fill_stack(full, f_edge, rts, *sm.host_stencil, *scal, group, strat_w=w)
    stack = tuple(x[:group] for x in full)
    gen = torch.Generator(device=device).manual_seed(15)
    g = tuple(torch.randn(x.shape, generator=gen, device=device, dtype=dtype) for x in fields)
    ddt = torch.zeros(1, dtype=torch.float64, device=device)
    dw = torch.zeros((LEVELS, LEVELS), dtype=torch.float64, device=device)
    halo = reverse_halo(sm.coriolis_terms)

    def runner(arm, strat_on):
        kw = dict(strat_w=w, dstrat=dw) if strat_on else {}
        if arm == "adjoint_step":
            return lambda: adjoint_step.adjoint_rollout(stack, g, f_edge, *sm.host_adjoint_stencil,
                                                        *scal, group, ddt, **kw)
        rt, ct, _, _ = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, group, halo=halo,
                                          strat=strat_on)
        return lambda: tiled_adjoint.tiled_adjoint_rollout(
            stack, g, f_edge, rts, *sm.host_stencil, *sm.host_adjoint_stencil, *scal, group, ddt,
            row_tile=rt, col_tile=ct, q=1, halo=halo, **kw)

    out = {}
    for arm in ("adjoint_step", "tiled_adjoint"):
        runs = {"unstrat": runner(arm, False), "strat": runner(arm, True)}
        times = {k: [] for k in runs}
        for k in ("unstrat", "strat", "strat", "unstrat"):
            times[k] += held_us(runs[k], group, 1)
        out[arm] = times
    return {"n": n, "group": group, **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--reverse", action="store_true",
                    help="time the reverse kernels' stratified arms, per launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("strat_timing needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip()
    if args.reverse:
        sizes = [time_reverse(n) for n in args.sizes]
    else:
        sizes = [time_size(n, args.steps) for n in args.sizes]
    print(json.dumps({"package": mpas_ocean_tpu_torch.__file__, "gpu": gpu, "sizes": sizes}),
          flush=True)


if __name__ == "__main__":
    main()
