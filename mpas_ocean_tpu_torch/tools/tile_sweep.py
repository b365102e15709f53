"""Time the tiled kernel's plans and the one-step kernel's tiles on the card.

    python -m mpas_ocean_tpu_torch.tools.tile_sweep [--sizes 256 64] [--steps 40]
        [--out tile_sweep.json]

For each lattice size (n x n cells, 100 levels, f32, the inertial-gravity
wave at dt = 30 s), each stepper (FE, FB) and each plan (row_tile,
col_tile, q) of at least 16 sites whose window fits one block's shared
memory, it times ``tiled_run_loop`` by CUDA events (median of 3 after a
warm-up); and fe_step (FE) through ``fe_step._rollout`` for each tile of
powers of two up to 16 x 32 that fits. Prints one line per plan, fastest
first, with the clusters the card holds at once and the blocks per SM
(CUDA's occupancy calculator), the plan ``tile_plan`` (or ``fe_tile``)
picks and its rank (from 0), and writes all the numbers as JSON to
``--out``; a line on stderr names each plan before it is timed. The
planners' rules and the FE size rule of ``fused_model`` are read off this
output (PERF.md). Needs a CUDA device.
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
from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
from mpas_ocean_tpu_torch.structured import tile_plan, tiled_run_loop
from mpas_ocean_tpu_torch.structured.fused_model import _scal
from mpas_ocean_tpu_torch.structured.slab import stencil_reach
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


def sweep(sizes, n_steps: int) -> dict:
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"gpu": gpu, "levels": LEVELS, "steps": n_steps, "sizes": {}}
    for n in sizes:
        model, st = igw_lattice(n)
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
    ap.add_argument("--out", type=Path, default=Path("tile_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep needs a CUDA device")
    result = sweep(args.sizes, args.steps)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
