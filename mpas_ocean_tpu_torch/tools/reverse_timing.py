"""Time the reverse kernels per launch on the card, by device time, to
compare two checkouts of the package.

    python -m mpas_ocean_tpu_torch.tools.reverse_timing [--sizes 64 256] [--group 40]
        [--tracers 0]

For each lattice size (n x n cells, 100 levels, f32, the inertial-gravity
wave at dt = 30 s) it fills a stack of ``group`` primal states through
``structured_auto_run_loop`` (an entry whose arguments every checkout
shares), then times one call of ``adjoint_step.adjoint_rollout`` and one of
``tiled_adjoint.tiled_adjoint_rollout`` (the planner's plan) over that
stack by ``held_us``, the timer chip_smoke.py's phase 8 uses too, and, where
the checkout has it, one of the nonlinear reverse
(``adjoint_step.nl_adjoint_rollout``, its planner's plan) over a stack of
nonlinear states filled through ``structured_auto_run_loop(nonlinear=True)``
(phase 13's timer). With ``--tracers N`` (N > 0) it times the tracer arms of
adjoint_step and tiled_adjoint (q = 1, the planners' tracer tiles) over a
stack of states carrying N tracers (``tile_sweep.tracer_stack``) instead,
and no nonlinear reverse. With ``--nl-arms`` it times the nonlinear
reverse's arms instead, each a reverse of the gradient's card steps
(``tools/composed_reverse``: ``composed_steps`` on the planner's plan, its
d(dt) sums and, stratified, its passes included) over a stack of
``--group`` states of bench.py's full-physics cell (its forcing, two
tracers with kappa 0 and upwind 1, densities 1025 + linspace(0, 1)): the
core (N), N with forcing (NF), tracers (NT), stratification (NS) and all
four (NFTS) at each size, and the core on the 64^2 Kelvin channel (the
masked arm); ``--reps`` reps each. Prints
one JSON line with the µs per launch of every rep, the card and the
package's path. To compare two checkouts of the package on one card, run
this file against each in turn:

    PYTHONPATH=<checkout> python <checkout under test>/mpas_ocean_tpu_torch/tools/reverse_timing.py

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

import mpas_ocean_tpu_torch
from mpas_ocean_tpu_torch.kernels import adjoint_step, tiled_adjoint
from mpas_ocean_tpu_torch.structured import structured_auto_run_loop, tiled_adjoint_plan
from mpas_ocean_tpu_torch.structured.fused_model import _scal
from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo
from mpas_ocean_tpu_torch.tools.tile_sweep import DT, LEVELS, igw_lattice

REPS = 5
# clock cycles the stream sleeps before each timed call (tens of ms on an
# H100, far more than the host needs to queue one call)
HOLD_CYCLES = 50_000_000


def held_us(run, n_launches: int, reps: int = REPS) -> list[float]:
    """Device µs per launch of run(), ``reps`` times after a warm-up call,
    each timed by CUDA events behind a sleep kernel that holds the stream
    until the host has queued all of run(): the time is the device's, not
    the wrapper's set-up (which takes about as long as a 64x64 launch)."""
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / n_launches)
    return out


def time_tracer_arms(n: int, group: int, n_tracers: int) -> dict:
    """Per-launch device µs of the tracer arms of adjoint_step and
    tiled_adjoint (q = 1) over a stack of ``group`` states of the n x n
    lattice carrying ``n_tracers`` tracers."""
    from mpas_ocean_tpu_torch.tools.tile_sweep import tracer_stack

    model, st = igw_lattice(n)
    sm = model.struct_mesh
    scal = _scal(sm, DT, torch.float32)
    stack, kt, end = tracer_stack(st, sm, group, n_tracers)
    gen = torch.Generator(device=st.ssh.device).manual_seed(15)
    g_in = tuple(torch.randn(x.shape[1:], generator=gen, dtype=x.dtype, device=x.device)
                 for x in (*stack, kt.planes))
    acc = torch.zeros(1, dtype=torch.float64, device=st.ssh.device)
    halo = reverse_halo(sm.coriolis_terms)
    rt, ct, q, _ = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, group, halo=halo,
                                      n_tracers=n_tracers)
    kw = dict(tracers=kt, end=end)
    fused = held_us(lambda: adjoint_step.adjoint_rollout(
        stack, g_in, sm.f_edge, *sm.host_adjoint_stencil, *scal, group, acc, **kw), group)
    tiled = held_us(lambda: tiled_adjoint.tiled_adjoint_rollout(
        stack, g_in, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
        *sm.host_adjoint_stencil, *scal, group, acc, row_tile=rt, col_tile=ct, q=q, halo=halo,
        **kw), group)
    return {"n": n, "group": group, "tracers": n_tracers, "tiled_plan": [rt, ct, q],
            "adjoint_step_tile": list(adjoint_step.adjoint_tile(sm.ny2, sm.nx, LEVELS, 4,
                                                                n_tracers)),
            "adjoint_step_us": fused, "tiled_adjoint_us": tiled}


def time_size(n: int, group: int) -> dict:
    model, st = igw_lattice(n)
    sm = model.struct_mesh
    scal = _scal(sm, DT, torch.float32)
    fields = (st.ssh, st.layer_thickness, st.normal_velocity)
    stack = tuple(torch.empty((group, *x.shape), dtype=x.dtype, device=x.device)
                  for x in fields)
    state = st
    for j in range(group):
        for dst, x in zip(stack, (state.ssh, state.layer_thickness, state.normal_velocity)):
            dst[j].copy_(x)
        state = structured_auto_run_loop(state, sm, DT, 1)
    gen = torch.Generator(device=st.ssh.device).manual_seed(15)
    g_in = tuple(torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
                 for x in fields)
    acc = torch.zeros(1, dtype=torch.float64, device=st.ssh.device)
    halo = reverse_halo(sm.coriolis_terms)
    rt, ct, q, _ = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, group, halo=halo)
    # the stencils as each checkout's wrappers take them: on the host where
    # the mesh carries host copies of both, else on the card
    if hasattr(sm, "host_adjoint_stencil"):
        fwd, adj = sm.host_stencil, sm.host_adjoint_stencil
    else:
        fwd, adj = (sm.stencil_table, sm.coriolis_weight), (sm.adjoint_table, sm.adjoint_weight)
    fused = held_us(lambda: adjoint_step.adjoint_rollout(
        stack, g_in, sm.f_edge, *adj, *scal, group, acc), group)
    tiled = held_us(lambda: tiled_adjoint.tiled_adjoint_rollout(
        stack, g_in, sm.f_edge, sm.resting_thickness_sum, *fwd, *adj, *scal, group // q, acc,
        row_tile=rt, col_tile=ct, q=q, halo=halo), group // q)
    out = {"n": n, "group": group, "tiled_plan": [rt, ct, q], "adjoint_step_us": fused,
           "tiled_adjoint_us": tiled}
    if hasattr(adjoint_step, "nl_adjoint_rollout"):
        from mpas_ocean_tpu_torch.structured.fused_model import (
            kernel_live,
            nl_adjoint_scal,
            nl_scal,
            nl_setup,
        )

        state = st
        for j in range(group):
            for dst, x in zip(stack, (state.ssh, state.layer_thickness, state.normal_velocity)):
                dst[j].copy_(x)
            state = structured_auto_run_loop(state, sm, DT, 1, nonlinear=True)
        args = (nl_setup(sm, torch.float32), *fwd, *adj, sm.vertex_cell_terms,
                sm.edge_vertex_terms, *scal, *nl_scal(sm, torch.float32),
                *nl_adjoint_scal(sm, DT, torch.float32))
        out["nl_adjoint_plan"] = list(adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4))
        out["nl_adjoint_us"] = held_us(lambda: adjoint_step.nl_adjoint_rollout(
            stack, g_in, *args, group, acc, live=kernel_live(sm)), group)
    return out


def igw_full_physics(n: int):
    """(StructMesh, lattice state with bench.py's two tracers, its forcing
    in the struct layout, its Stratification) of the n x n IGW lattice (as
    chip_smoke.py's igw_case), f32 on the card."""
    import numpy as np

    import mpas_ocean_tpu_torch as mt

    dc = 10000.0e3 / n
    horz = mt.planar_hex_mesh(n, n, dc, f0=1e-4, dtype=np.float32)
    igw = mt.InertialGravityWave(lx=n * dc / 1e3)
    vert = mt.make_vertical_mesh(horz, LEVELS, resting_thickness=np.full(
        (horz.n_cells, LEVELS), igw.bottom_depth / LEVELS, dtype=np.float32), dtype=np.float32)
    mesh = mt.Mesh(horz=horz, vert=vert)
    ssh, h, u = igw.initial_state(horz, LEVELS)
    x = np.asarray(horz.cells.x)
    tracers = mt.make_tracers(mesh, [10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1)),
                                     np.full(horz.n_cells, 35.0)], dtype=np.float32)
    prog = mt.PrognosticVars(*(torch.from_numpy(v.astype(np.float32)) for v in (ssh, h, u)),
                             tracers=tracers)
    model = mt.StructuredModel(mesh, n, n)
    forcing = model.to_struct_forcing(mt.make_forcing(
        mesh, dtype=np.float32, wind_stress_zonal=0.1, bottom_drag_linear=1e-4, rayleigh=1e-5))
    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, LEVELS), dtype=np.float32)
    return model.struct_mesh, model.to_struct(prog), forcing, strat


def kelvin_channel(n: int):
    """(StructMesh, lattice state) of bench.py's Kelvin channel at n x n
    cells (the 10000 km lattice with its first and last cell rows culled),
    f32 on the card."""
    import numpy as np

    import mpas_ocean_tpu_torch as mt

    dc = 10000.0e3 / n
    horz = mt.planar_hex_mesh(n, n, dc, f0=1e-4, dtype=np.float32)
    y = np.asarray(horz.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = mt.cull_cells(horz, keep)
    vert = mt.make_vertical_mesh(chan, LEVELS, resting_thickness=np.full(
        (chan.n_cells, LEVELS), 1000.0 / LEVELS, dtype=np.float32), dtype=np.float32)
    ssh, h, u = mt.KelvinWave(lx=n * dc / 1e3, f0=1e-4).initial_state(chan, LEVELS)
    prog = mt.PrognosticVars(*(torch.from_numpy(v.astype(np.float32)) for v in (ssh, h, u)))
    model = mt.StructuredModel(mt.Mesh(horz=chan, vert=vert), n, n, parent_horz=horz,
                               keep_cells=keep)
    return model.struct_mesh, model.to_struct(prog)


def time_nl_arms(n: int, group: int, reps: int, masked: bool) -> dict:
    """{arm: [µs per launch]} of the nonlinear reverse's arms N, NF, NT, NS,
    NFTS at n x n (and "N masked" on the channel with ``masked``), each the
    gradient's card reverse over a stack of ``group`` states."""
    from mpas_ocean_tpu_torch.structured import StructState
    from mpas_ocean_tpu_torch.tools.composed_reverse import (
        composed_reverse,
        composed_stack,
        composed_state,
        composed_steps,
    )

    sm, st, forcing, strat = igw_full_physics(n)
    gen = torch.Generator(device=st.ssh.device).manual_seed(15)
    g = StructState(*(torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
                      for x in (st.ssh, st.layer_thickness, st.normal_velocity, st.tracers)))
    tr = dict(kappa=0.0, upwind=1.0)
    out = {}
    for opts in ("N", "NF", "NT", "NS", "NFTS"):
        steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat, **tr)
        stack = composed_stack(steps, composed_state(st, opts), group)
        go = composed_state(g, opts)
        out[opts] = held_us(lambda: composed_reverse(steps, stack, go, group), group, reps)
        del stack, steps
        torch.cuda.empty_cache()
    if masked:
        cm, cs = kelvin_channel(n)
        steps = composed_steps(cm, DT, cs.layer_thickness, "N", None, None, **tr)
        stack = composed_stack(steps, cs, group)
        gc = StructState(*(torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
                           for x in (cs.ssh, cs.layer_thickness, cs.normal_velocity)))
        out["N masked"] = held_us(lambda: composed_reverse(steps, stack, gc, group), group,
                                  reps)
    return {"n": n, "group": group,
            "nl_adjoint_plan": list(adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4)),
            "us_per_launch": out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--group", type=int, default=40)
    ap.add_argument("--tracers", type=int, default=0,
                    help="time the tracer arms with this many tracers")
    ap.add_argument("--nl-arms", action="store_true",
                    help="time the nonlinear reverse's arms (N, NF, NT, NS, NFTS; masked N at "
                         "the smallest size) instead")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("reverse_timing needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip()
    if args.nl_arms:
        sizes = [time_nl_arms(n, args.group, args.reps, n == min(args.sizes))
                 for n in args.sizes]
    else:
        sizes = [time_tracer_arms(n, args.group, args.tracers) if args.tracers
                 else time_size(n, args.group) for n in args.sizes]
    print(json.dumps({"package": mpas_ocean_tpu_torch.__file__, "gpu": gpu, "sizes": sizes}),
          flush=True)


if __name__ == "__main__":
    main()
