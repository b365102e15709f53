"""Time the window kernels' plans and tiles on the card.

    python -m mpas_ocean_tpu_torch.tools.tile_sweep [--sizes 256 64] [--steps 40]
        [--kernels forward reverse nonlinear nonlinear-reverse] [--tracers 0]
        [--strat] [--q 1] [--out tile_sweep.json]

For each lattice size (n x n cells, 100 levels, f32, the inertial-gravity
wave at dt = 30 s):

* forward: for each stepper (FE, FB) and each plan (row_tile, col_tile, q)
  of at least 16 sites whose window fits one block's shared memory, it times
  ``tiled_run_loop`` by CUDA events (median of 3 after a warm-up); and
  fe_step (FE) through ``fe_step._rollout`` for each tile of powers of two
  up to 16 x 32 that fits;
* reverse: over a stack of ``--steps`` primal states, adjoint_step through
  ``adjoint_step._rollout`` for each tile of at least 8 sites (rows 1-16,
  columns 2-32, ragged tiles too) that fits, and ``tiled_adjoint_rollout``
  for each plan of at least 8 sites that divides the lattice and fits (q = 1
  and 2), each per launch by ``reverse_timing.held_us`` (median of 3 after
  a warm-up); with ``--tracers N`` (N > 0) the tracer arms of both over a
  stack of states carrying N tracers (bench.py's temperature wave and
  uniform salinity, repeated), their tiles and plans sized with the tracer
  planes (``adjoint_tile``'s and ``tiled_adjoint_plan``'s ``n_tracers``);
  with ``--strat`` the stratified arms (bench.py's densities, 1025 +
  linspace(0, 1)); the tiled adjoint's plans at each q of ``--q`` (q = 1
  and 2 by default without tracers or ``--strat``, q = 1 with them);
* nonlinear: the nonlinear arms by CUDA events as forward: at q = 1
  (csrc/nl_step.cuh) fe_step's FE arm through ``fe_step.fe_nl_rollout`` and
  tiled_step's FB arm through ``tiled_step.tiled_nl_rollout``, for each
  tile of powers of two up to 16 x 32 of at least 8 sites, cut to the
  lattice, and each slice of 1-16 levels that fits; at each q > 1 of
  ``--q``, the q-step kernel's FE and FB (csrc/nl_tiled.cuh) through
  ``tiled_step.tiled_nl_rollout(q=)`` for those tiles that divide the
  lattice and each slice that fits;
* nonlinear-reverse: the nonlinear reverse (csrc/nl_adjoint.cuh) through
  ``adjoint_step.nl_adjoint_rollout``, the core and bench.py's full
  physics (NFTS), each over a stack of ``--steps`` primal states of its
  rebuild, for each tile of at least 16 sites (rows 2-16, columns 2-32)
  and slice of 2-8 levels that fit, per launch by
  ``reverse_timing.held_us`` (q = 1), then the planner's plan at each split
  of the levels over 1-8 blocks a tile and at the kernel's own choice.

Prints one line per plan, fastest first, with the blocks per SM (CUDA's
occupancy calculator), the plan the planner (``tile_plan``, ``fe_tile``,
``adjoint_tile``, ``tiled_adjoint_plan``, ``nl_plan``, ``nl_adjoint_plan``)
picks and its rank (from 0), and
writes all the numbers as JSON to ``--out``; a line on stderr names each
plan before it is timed. The planners' rules and the FE size rule of
``fused_model`` are read off this output (PERF.md). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_adjoint, tiled_step
from mpas_ocean_tpu_torch.structured import tile_plan, tiled_adjoint_plan, tiled_run_loop
from mpas_ocean_tpu_torch.structured.fused_model import _scal, nl_scal, nl_setup
from mpas_ocean_tpu_torch.structured.slab import stencil_reach
from mpas_ocean_tpu_torch.structured.tiled_diff import adjoint_window_bytes, reverse_halo
from mpas_ocean_tpu_torch.structured.tiled_model import resolve_plan, window_bytes

LEVELS, DT, REPS = 100, 30.0, 3
T0 = time.perf_counter()


def igw_lattice(n: int, levels: int = LEVELS, dtype=np.float32):
    """(StructuredModel on the card, lattice state) of the IGW case over a
    10000 km periodic box, as chip_smoke.py builds it."""
    dc = 10000.0e3 / n
    horz = mt.planar_hex_mesh(n, n, dc, f0=1e-4, dtype=dtype)
    igw = mt.InertialGravityWave(lx=n * dc / 1e3)
    vert = mt.make_vertical_mesh(
        horz, levels, dtype=dtype,
        resting_thickness=np.full((horz.n_cells, levels), igw.bottom_depth / levels,
                                  dtype=dtype),
    )
    ssh, h, u = igw.initial_state(horz, levels)
    prog = mt.PrognosticVars(*(torch.from_numpy(x.astype(dtype)) for x in (ssh, h, u)))
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n)
    return model, model.to_struct(prog)


def progress(msg: str) -> None:
    """A line on stderr before each measurement, so that a run cut short
    shows where it was."""
    print(f"[{time.perf_counter() - T0:.1f} s] {msg}", file=sys.stderr, flush=True)


def per_step_us(run, n_steps: int) -> list[float]:
    """Device µs per step of run(n_steps), by CUDA events, REPS times after
    a warm-up call."""
    run(n_steps)
    out = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(n_steps)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / n_steps)
    return out


def candidate_plans(ny2: int, nx: int, k: int, itemsize: int, halo, n_steps: int):
    """Every (row_tile, col_tile, q) with tiles up to 32 sites a side that
    divides the lattice, keeps the clamp and fits one block's shared
    memory."""
    hm, hi = halo
    for q in (1, 2, 4):
        if n_steps % q:
            continue
        for rt in (d for d in range(1, min(ny2, 32) + 1) if ny2 % d == 0):
            for ct in (d for d in range(1, min(nx, 32) + 1) if nx % d == 0):
                if (rt * ct >= 16 and rt + 2 * hm * q <= ny2 and ct + 2 * hi * q <= nx
                        and window_bytes(rt, ct, q, halo, k, itemsize)
                        <= tiled_step.SMEM_BYTES):
                    yield rt, ct, q


def fe_tiles(ny2: int, nx: int, k: int, itemsize: int):
    """fe_step's candidate tiles: the powers of two up to 16 x 32 of at
    least 8 sites, cut to the lattice, whose window fits one block's shared
    memory."""
    tiles = dict.fromkeys((min(rt, ny2), min(ct, nx)) for rt in (1, 2, 4, 8, 16)
                          for ct in (1, 2, 4, 8, 16, 32) if rt * ct >= 8)
    return [t for t in tiles if fe_step.smem_bytes(t, k, itemsize) <= fe_step.SMEM_BYTES]


def reverse_tiles(ny2: int, nx: int, k: int, itemsize: int, n_tracers: int = 0,
                  strat: bool = False):
    """adjoint_step's candidate tiles: rows 1-16 and columns 2-32 of at least
    8 sites, cut to the lattice (ragged tiles included), whose window (with
    ``n_tracers`` the tracer arm's, with ``strat`` the stratified arm's)
    fits one block's shared memory."""
    tiles = dict.fromkeys((min(rt, ny2), min(ct, nx)) for rt in adjoint_step.TILE_ROWS
                          for ct in adjoint_step.TILE_COLS if rt * ct >= 8)
    return [t for t in tiles if adjoint_step.smem_bytes(t, k, itemsize, n_tracers=n_tracers,
                                                        strat=strat) <= fe_step.SMEM_BYTES]


def reverse_plans(ny2: int, nx: int, k: int, itemsize: int, halo, n_steps: int,
                  n_tracers: int = 0, strat: bool = False, qs=(1, 2)):
    """The tiled adjoint's candidate plans: tiles up to 32 sites a side of
    at least 8 sites that divide the lattice, each q of ``qs`` (dividing
    n_steps), kept by the clamp and fitting one block's shared memory (the
    tracer arm's window with ``n_tracers``, the stratified arm's with
    ``strat``)."""
    for q in qs:
        if n_steps % q:
            continue
        for rt in (d for d in range(1, min(ny2, 32) + 1) if ny2 % d == 0):
            for ct in (d for d in range(1, min(nx, 32) + 1) if nx % d == 0):
                if (rt * ct >= 8
                        and resolve_plan(ny2, nx, k, itemsize, halo, n_steps, rt, ct, q)
                        == (rt, ct, q)
                        and adjoint_window_bytes(rt, ct, q, halo, k, itemsize,
                                                 n_tracers=n_tracers, strat=strat)
                        <= fe_step.SMEM_BYTES):
                    yield rt, ct, q


def tracer_stack(st, sm, n_steps: int, n_tracers: int):
    """The tracer arms' operands for a stack of n_steps states of ``st``
    carrying ``n_tracers`` tracers (bench.py's T = 10 + 2 sin(2 pi x / nx)
    and S = 35, alternating), filled by fe_fill_stack's tracer arm, and the
    state after its last slot: (stack (ssh, h, u), kernel tracers whose
    planes are the tracer stack, (h, tracer planes) of the end state)."""
    from mpas_ocean_tpu_torch.structured import StructState, fused_model

    ny2, nx, k = st.layer_thickness.shape[1:]
    x = torch.arange(nx, device=st.ssh.device, dtype=torch.float32)[None, None, :, None] / nx
    wave = (10.0 + 2.0 * torch.sin(2 * torch.pi * x)).expand(2, ny2, nx, k)
    tr = torch.stack([wave if t % 2 == 0 else torch.full_like(wave, 35.0)
                      for t in range(n_tracers)], dim=3)
    kt = fused_model.kernel_tracers(StructState(st.ssh, st.layer_thickness,
                                                st.normal_velocity, tr), sm, 0.0, 1.0)
    fields = (st.ssh, st.layer_thickness, st.normal_velocity)
    full = tuple(torch.empty((n_steps + 1, *x.shape), dtype=x.dtype, device=x.device)
                 for x in fields)
    trs = torch.empty((n_steps + 1, *kt.planes.shape), dtype=tr.dtype, device=tr.device)
    for dst, x in zip(full, fields):
        dst[0].copy_(x)
    trs[0].copy_(kt.planes)
    fe_step.fe_fill_stack(full, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
                          *_scal(sm, DT, torch.float32), n_steps, tracers=kt._replace(planes=trs))
    return (tuple(x[:n_steps] for x in full), kt._replace(planes=trs[:n_steps]),
            (full[1][n_steps], trs[n_steps]))


def bench_strat_w(device):
    """bench.py's stratification's W (densities 1025 + linspace(0, 1)) in
    f32, as the kernels take it."""
    from mpas_ocean_tpu_torch.structured import fused_model

    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, LEVELS), dtype=np.float32)
    return fused_model.kernel_strat(strat, torch.float32, device)


def reverse_sweep(n: int, model, st, n_steps: int, gpu: str, n_tracers: int = 0,
                  strat: bool = False, qs=None) -> dict:
    """Per-launch device times of both reverse kernels over every tile and
    plan that fits, from a stack of n_steps primal states of the lattice
    (with ``n_tracers``, carrying that many tracers: the tracer arms; with
    ``strat``, the stratified arms), the tiled adjoint's at each q of
    ``qs`` (q = 1 and 2 by default without the tracer or stratified arms,
    q = 1 with them)."""
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us

    sm = model.struct_mesh
    scal = _scal(sm, DT, torch.float32)
    fields = (st.ssh, st.layer_thickness, st.normal_velocity)
    gen = torch.Generator(device=st.ssh.device).manual_seed(15)
    g_in = tuple(torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
                 for x in fields)
    kw = {}
    if n_tracers:
        stack, kt, end = tracer_stack(st, sm, n_steps, n_tracers)
        g_in += (torch.randn(kt.planes.shape[1:], generator=gen, device=st.ssh.device),)
        kw = dict(tracers=kt, end=end)
    else:
        stack = tuple(torch.empty((n_steps, *x.shape), dtype=x.dtype, device=x.device)
                      for x in fields)
        for dst, x in zip(stack, fields):
            dst[0].copy_(x)
        fe_step.fe_fill_stack(stack, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
                              *scal, n_steps - 1)
    acc = torch.zeros(1, dtype=torch.float64, device=st.ssh.device)
    if strat:
        w = bench_strat_w(st.ssh.device)
        kw.update(strat_w=w, dstrat=torch.zeros((LEVELS, LEVELS), dtype=torch.float64,
                                                device=st.ssh.device))
    if qs is None:
        qs = (1,) if n_tracers or strat else (1, 2)
    table = sm.host_adjoint_stencil[0]
    rows = []
    for tile in reverse_tiles(sm.ny2, sm.nx, LEVELS, 4, n_tracers, strat):
        progress(f"{n}: adjoint_step {tile}")
        t = held_us(lambda: adjoint_step._rollout(
            stack, g_in, sm.f_edge, *sm.host_adjoint_stencil, scal, n_steps, acc, None, None,
            tile, **kw), n_steps, REPS)
        rows.append((tile, t, adjoint_step.launch_plan(table, sm.ny2, sm.nx, LEVELS, tile,
                                                       n_tracers)))
    rows.sort(key=lambda r: statistics.median(r[1]))
    chosen = adjoint_step.adjoint_tile(sm.ny2, sm.nx, LEVELS, 4, n_tracers, strat=strat)
    rank = next((i for i, (p, *_) in enumerate(rows) if p == chosen), None)
    print(f"{n}x{n}x{LEVELS} f32: adjoint_step, {len(rows)} tiles; adjoint_tile picks "
          f"{chosen}, rank {rank} [{gpu}]", flush=True)
    for tile, t, lp in rows:
        print(f"    adjoint_step {tile}: {statistics.median(t):.3f} us/launch (min "
              f"{min(t):.3f}, max {max(t):.3f}); {lp['smem_bytes']} bytes, "
              f"{lp['blocks_per_sm']} blocks per SM, {lp['clusters']} clusters", flush=True)
    entry = {"adjoint_step": [{"tile": p, "us_per_launch": t, **lp} for p, t, lp in rows],
             "adjoint_step_chosen": chosen}
    halo = reverse_halo(sm.coriolis_terms)
    rows = []
    for rt, ct, q in reverse_plans(sm.ny2, sm.nx, LEVELS, 4, halo, n_steps, n_tracers, strat,
                                   qs):
        progress(f"{n}: tiled_adjoint {(rt, ct, q)}")
        # at q > 1 a superstep starts at every q-th state (the last one's
        # tracer arm reads h' and T' of the end state, as at q = 1)
        sup = tuple(x[::q].contiguous() for x in stack)
        skw = dict(kw)
        if n_tracers and q > 1:
            skw.update(tracers=kt._replace(planes=kt.planes[::q].contiguous()))
        t = held_us(lambda: tiled_adjoint.tiled_adjoint_rollout(
            sup, g_in, sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
            *sm.host_adjoint_stencil, *scal, n_steps // q, acc, row_tile=rt, col_tile=ct, q=q,
            halo=halo, **skw), n_steps // q, REPS)
        rows.append(((rt, ct, q), [x / q for x in t],
                     tiled_adjoint.occupancy(rt, ct, q, halo, LEVELS, n_tracers, strat)))
    rows.sort(key=lambda r: statistics.median(r[1]))
    chosen = tiled_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, n_steps, halo=halo,
                                n_tracers=n_tracers, strat=strat)[:3]
    rank = next((i for i, (p, *_) in enumerate(rows) if p == chosen), None)
    print(f"  tiled_adjoint: {len(rows)} plans; tiled_adjoint_plan picks {chosen}, rank "
          f"{rank}", flush=True)
    for plan, t, (smem, bps) in rows:
        print(f"    tiled_adjoint {plan}: {statistics.median(t):.3f} us/step (min "
              f"{min(t):.3f}, max {max(t):.3f}); {smem} bytes, {bps} blocks per SM",
              flush=True)
    entry["tiled_adjoint"] = [{"plan": p, "us_per_step": t, "smem_bytes": smem,
                               "blocks_per_sm": bps} for p, t, (smem, bps) in rows]
    entry["tiled_adjoint_chosen"] = chosen
    return entry


def nonlinear_sweep(n: int, model, st, n_steps: int, gpu: str, qs=(1,)) -> dict:
    """Per-step device times of the nonlinear arms over every tile and slice
    that fits: at q = 1 fe_step's FE arm and tiled_step's FB arm, at each
    q > 1 of ``qs`` the q-step kernel's FE and FB over the tiles that
    divide the lattice."""
    sm = model.struct_mesh
    consts = (sm.resting_thickness_sum, *sm.host_stencil, nl_setup(sm, torch.float32),
              sm.vertex_cell_terms, sm.edge_vertex_terms, *_scal(sm, DT, torch.float32),
              *nl_scal(sm, torch.float32))
    kc = fe_step.level_split(LEVELS)[1]
    tiles = dict.fromkeys((min(rt, sm.ny2), min(ct, sm.nx)) for rt in (1, 2, 4, 8, 16)
                          for ct in (1, 2, 4, 8, 16, 32) if rt * ct >= 8)
    entry = {}
    arms = [(name, fb, 1) for name, fb in (("fe_step FE", False), ("tiled_step FB", True))
            if 1 in qs] + [(f"tiled_step {'FB' if fb else 'FE'} q={q}", fb, q)
                           for q in qs if q > 1 and n_steps % q == 0 for fb in (False, True)]
    for name, fb, q in arms:
        rows = []
        if q == 1:
            wrapper = tiled_step.tiled_nl_rollout if fb else fe_step.fe_nl_rollout
            q_tiles = tiles
        else:
            wrapper = lambda *a, fb=fb, q=q, **kw: tiled_step.tiled_nl_rollout(  # noqa: E731
                *a, q=q, fb=fb, **kw)
            q_tiles = [t for t in tiles if sm.ny2 % t[0] == 0 and sm.nx % t[1] == 0]
        for tile in q_tiles:
            for ks in (1, 2, 4, 8, 16):
                if ks > kc or (fe_step.nl_smem_bytes(tile, LEVELS, 4, fb, ks, q=q)
                               > fe_step.SMEM_BYTES):
                    continue
                progress(f"{n}: {name} {tile} slice {ks}")
                run = lambda s: wrapper(st.ssh, st.layer_thickness, st.normal_velocity, *consts,
                                        s, tile=tile, ks=ks)
                t = per_step_us(run, n_steps)
                lp = (fe_step.nl_launch_plan(sm.ny2, sm.nx, LEVELS, tile, ks, fb) if q == 1
                      else {"smem_bytes": fe_step.nl_smem_bytes(tile, LEVELS, 4, fb, ks, q=q),
                            "blocks_per_sm": 1,
                            "clusters": (sm.ny2 // tile[0]) * (sm.nx // tile[1])})
                rows.append(((*tile, ks), t, lp))
        rows.sort(key=lambda r: statistics.median(r[1]))
        chosen = fe_step.nl_plan(sm.ny2, sm.nx, LEVELS, 4, fb, None if q == 1 else q_tiles,
                                 q=q)
        rank = next((i for i, (p, *_) in enumerate(rows) if p == chosen), None)
        print(f"{n}x{n}x{LEVELS} f32: nonlinear {name}, {len(rows)} (tile, slice) plans; the "
              f"planner picks {chosen}, rank {rank} [{gpu}]", flush=True)
        for plan, t, lp in rows:
            print(f"    {name} {plan}: {statistics.median(t):.3f} us/step (min {min(t):.3f}, "
                  f"max {max(t):.3f}); {lp['smem_bytes']} bytes, {lp['blocks_per_sm']} blocks "
                  f"per SM, {lp['clusters']} clusters", flush=True)
        entry[name] = [{"plan": p, "us_per_step": t, **lp} for p, t, lp in rows]
        entry[name + " chosen"] = chosen
    return entry


def nonlinear_reverse_sweep(n: int, n_steps: int, gpu: str, arms=("N", "NFTS")) -> dict:
    """Per-launch device times of the nonlinear reverse over every tile of
    at least 16 sites and slice of 2-8 levels that fit, for each arm of
    ``arms`` (the core N, and NFTS: bench.py's full-physics cell, its two
    tracers with kappa 0 and upwind 1,
    ``reverse_timing.igw_full_physics``), from a stack of n_steps primal
    states of the arm's rebuild (its stratified passes and d(dt) sums
    included)."""
    from mpas_ocean_tpu_torch.structured import StructState, diff_model
    from mpas_ocean_tpu_torch.tools.composed_reverse import (
        composed_stack,
        composed_state,
        composed_steps,
    )
    from mpas_ocean_tpu_torch.tools.reverse_timing import held_us, igw_full_physics

    sm, st, forcing, strat = igw_full_physics(n)
    gen = torch.Generator(device=st.ssh.device).manual_seed(15)
    g = StructState(*(torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
                      for x in (st.ssh, st.layer_thickness, st.normal_velocity, st.tracers)))
    chunk = fe_step.level_split(LEVELS)[1]
    tiles = dict.fromkeys((min(rt, sm.ny2), min(ct, sm.nx)) for rt in (2, 4, 8, 16)
                          for ct in (2, 4, 8, 16, 32) if rt * ct >= 16)
    entry = {}
    for opts in arms:
        steps = composed_steps(sm, DT, st.layer_thickness, opts, forcing, strat, kappa=0.0,
                               upwind=1.0)
        stack = composed_stack(steps, composed_state(st, opts), n_steps)
        like = diff_model._slot(stack, 0)
        out, scratch = diff_model._empty(like), diff_model._empty(like)
        gp = diff_model._cotangent(diff_model._planes_state(composed_state(g, opts)), like)
        end = diff_model._end(diff_model._slot(stack, n_steps), steps.tracers)
        n_tr = 0 if stack.tracers is None else stack.tracers.shape[1] // 2
        ddt = torch.zeros(1, dtype=torch.float64, device=st.ssh.device)

        def run(tile, ks, kc=None):
            adjoint_step.nl_adjoint_rollout(
                diff_model._fields(stack)[:3], diff_model._fields(gp), *steps.nl_adj,
                *steps.nl_adj_scal, n_steps, ddt, diff_model._fields(out),
                diff_model._fields(scratch), live=steps.live, tile=tile, ks=ks,
                forcing=steps.kf, dforc=steps.dforc,
                tracers=steps.kernel_tracers(stack.tracers), end=end, strat_w=steps.sw,
                dstrat=steps.dstrat, _kc=kc)

        rows = []
        for tile in tiles:
            for ks in (2, 4, 8):
                if ks > chunk or adjoint_step.nl_adjoint_smem_bytes(
                        tile, 4, ks, n_tr) > fe_step.SMEM_BYTES:
                    continue
                progress(f"{n}: nonlinear reverse {opts} {tile} slice {ks}")
                t = held_us(lambda: run(tile, ks), n_steps, REPS)
                rows.append(((*tile, ks), t))
        rows.sort(key=lambda r: statistics.median(r[1]))
        chosen = adjoint_step.nl_adjoint_plan(sm.ny2, sm.nx, LEVELS, 4, n_tracers=n_tr,
                                              strat="S" in opts)
        rank = next((i for i, (p, _) in enumerate(rows) if p == chosen), None)
        print(f"{n}x{n}x{LEVELS} f32: nonlinear reverse {opts}, {len(rows)} (tile, slice) "
              f"plans; nl_adjoint_plan picks {chosen}, rank {rank} [{gpu}]", flush=True)
        for p, t in rows:
            print(f"    nonlinear reverse {opts} {p}: {statistics.median(t):.3f} us/launch (min "
                  f"{min(t):.3f}, max {max(t):.3f}); "
                  f"{adjoint_step.nl_adjoint_smem_bytes(p[:2], 4, p[2], n_tr)} bytes",
                  flush=True)
        # the planner's plan at each level split (levels a block, a multiple
        # of the slice; None: the kernel's own choice)
        splits = []
        ks = chosen[2]
        for kc in sorted({ks * -(-LEVELS // (r * ks)) for r in range(1, 9)}) + [None]:
            if kc is not None and -(-LEVELS // kc) > 8:
                continue
            progress(f"{n}: nonlinear reverse {opts} {chosen} levels a block {kc}")
            t = held_us(lambda: run(chosen[:2], chosen[2], kc), n_steps, REPS)
            splits.append((kc, t))
            split = kc or "the kernel's choice of"
            print(f"    nonlinear reverse {opts} {chosen}, {split} levels a block: "
                  f"{statistics.median(t):.3f} us/launch (min {min(t):.3f}, max {max(t):.3f})",
                  flush=True)
        entry[opts] = {"plans": [{"plan": p, "us_per_launch": t} for p, t in rows],
                       "chosen": chosen,
                       "level_splits": [{"kc": kc, "us_per_launch": t} for kc, t in splits]}
        del stack, steps, out, scratch, gp, end
        torch.cuda.empty_cache()
    return entry


def sweep(sizes, n_steps: int, kernels=("forward", "reverse"), n_tracers: int = 0,
          strat: bool = False, qs=None) -> dict:
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"gpu": gpu, "levels": LEVELS, "steps": n_steps, "tracers": n_tracers,
              "strat": strat, "q": qs, "sizes": {}}
    for n in sizes:
        model, st = igw_lattice(n)
        if "reverse" in kernels:
            result.setdefault("reverse", {})[str(n)] = reverse_sweep(n, model, st, n_steps, gpu,
                                                                     n_tracers, strat, qs)
        if "nonlinear" in kernels:
            result.setdefault("nonlinear", {})[str(n)] = nonlinear_sweep(n, model, st, n_steps,
                                                                         gpu, qs or (1,))
        if "nonlinear-reverse" in kernels:
            result.setdefault("nonlinear-reverse", {})[str(n)] = nonlinear_reverse_sweep(
                n, n_steps, gpu)
        if "forward" not in kernels:
            continue
        sm = model.struct_mesh
        scal = _scal(sm, DT, torch.float32)
        consts = (sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil)
        fe_rows = []
        for tile in fe_tiles(sm.ny2, sm.nx, LEVELS, 4):
            progress(f"{n}: fe_step {tile}")
            t = per_step_us(lambda s: fe_step._rollout(
                st.ssh, st.layer_thickness, st.normal_velocity, *consts, scal, s, tile),
                n_steps)
            fe_rows.append((tile, t, fe_step.launch_plan(sm.host_stencil[0], sm.ny2, sm.nx,
                                                         LEVELS, tile)))
        fe_rows.sort(key=lambda r: statistics.median(r[1]))
        chosen = fe_step.fe_tile(sm.ny2, sm.nx, LEVELS, 4)
        rank = next((i for i, (p, *_) in enumerate(fe_rows) if p == chosen), None)
        print(f"{n}x{n}x{LEVELS} f32: fe_step, {len(fe_rows)} tiles; fe_tile picks {chosen}, "
              f"rank {rank} [{gpu}]", flush=True)
        for tile, t, lp in fe_rows:
            print(f"    fe_step {tile}: {statistics.median(t):.3f} us/step (min {min(t):.3f}, "
                  f"max {max(t):.3f}); {lp['clusters']} clusters, "
                  f"{lp['blocks_per_sm']} blocks per SM", flush=True)
        entry = {"fe_step": [{"tile": p, "us_per_step": t, **lp} for p, t, lp in fe_rows],
                 "fe_step_chosen": chosen, "tiled": {}}
        for fb in (False, True):
            halo = stencil_reach(sm.coriolis_terms, fb)
            rows = []
            for rt, ct, q in candidate_plans(sm.ny2, sm.nx, LEVELS, 4, halo, n_steps):
                if resolve_plan(sm.ny2, sm.nx, LEVELS, 4, halo, n_steps, rt, ct, q) \
                        != (rt, ct, q):
                    continue
                progress(f"{n}: tiled_step {'FB' if fb else 'FE'} {(rt, ct, q)}")
                t = per_step_us(lambda s: tiled_run_loop(
                    st, sm, DT, s, row_tile=rt, col_tile=ct, q=q, fb=fb), n_steps)
                rows.append(((rt, ct, q), t, tiled_step.occupancy(rt, ct, q, halo, LEVELS, fb)))
            rows.sort(key=lambda r: statistics.median(r[1]))
            chosen = tile_plan(sm.ny2, sm.nx, LEVELS, 4, halo, 1000)
            name = "FB" if fb else "FE"
            rank = next((i for i, (p, *_) in enumerate(rows) if p == chosen), None)
            print(f"  {name}: {len(rows)} plans; tile_plan picks {chosen}, rank {rank}",
                  flush=True)
            n_tiles = lambda p: (sm.ny2 // p[0]) * (sm.nx // p[1])
            for plan, t, (act, bps) in rows:
                print(f"    {name} {plan}: {statistics.median(t):.3f} us/step "
                      f"(min {min(t):.3f}, max {max(t):.3f}); {act} clusters resident, "
                      f"{bps} blocks per SM, {n_tiles(plan) / act:.2f} waves", flush=True)
            entry["tiled"][name] = [{"plan": p, "us_per_step": t, "active_clusters": act,
                                     "blocks_per_sm": bps} for p, t, (act, bps) in rows]
            entry["tiled"][name + "_chosen"] = chosen
        result["sizes"][str(n)] = entry
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 64])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--kernels", nargs="+",
                    choices=("forward", "reverse", "nonlinear", "nonlinear-reverse"),
                    default=["forward", "reverse"])
    ap.add_argument("--tracers", type=int, default=0,
                    help="tracers carried by the reverse sweep's states (its tracer arms)")
    ap.add_argument("--strat", action="store_true",
                    help="the reverse sweep's stratified arms (bench.py's densities)")
    ap.add_argument("--q", type=int, nargs="+", default=None,
                    help="steps per launch of the nonlinear sweep (1 by default) and of the "
                         "tiled adjoint's plans (1 and 2 by default, 1 with --tracers or "
                         "--strat)")
    ap.add_argument("--out", type=Path, default=Path("tile_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep needs a CUDA device")
    result = sweep(args.sizes, args.steps, args.kernels, args.tracers, args.strat, args.q)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
