"""Time the single-chip forward kernels per step on the card, to compare two
checkouts of the package.

    python mpas_ocean_tpu_torch/tools/forward_timing.py <label>

On bench.py's inertial-gravity wave (n x n cells, 100 levels, f32, dt =
30 s; ``tile_sweep.igw_lattice``) it times, each the median of 5 runs by
CUDA events after a warm-up: ``tiled_run_loop`` FB (the linear
``tiled_step``) at 64^2 over 2000 steps and at 256^2 over 200, the nonlinear
FB at q = 1 (``nl_step``) and FE at q = 2 (``nl_tiled``) at 64^2 over 1000,
and ``fused_run_loop`` (``fe_step``) at 64^2 over 2000, through entry
points whose arguments every checkout with the nonlinear q-step kernel
shares. Prints one JSON line of µs per step with ``label``. To compare two
checkouts on one card,
alternate them in one call, each in a fresh process:

    PYTHONPATH=<checkout> python <checkout under test>/mpas_ocean_tpu_torch/tools/forward_timing.py <label>

Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from mpas_ocean_tpu_torch.structured import fused_run_loop, tiled_run_loop
from mpas_ocean_tpu_torch.tools.tile_sweep import DT, LEVELS, igw_lattice

REPS = 5


def per_step_us(fn, n_steps: int) -> float:
    """Median µs per step of fn(n_steps) over REPS runs by CUDA events,
    after a 10-step warm-up."""
    fn(10)
    out = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(n_steps)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / n_steps)
    return statistics.median(out)


def main(label: str) -> dict:
    res = {"label": label, "levels": LEVELS}
    model, st = igw_lattice(64)
    sm = model.struct_mesh
    res["tiled_step FB 64"] = per_step_us(lambda n: tiled_run_loop(st, sm, DT, n, fb=True), 2000)
    res["nl_step FB 64"] = per_step_us(
        lambda n: tiled_run_loop(st, sm, DT, n, fb=True, nonlinear=True), 1000)
    res["nl_tiled FE q=2 64"] = per_step_us(
        lambda n: tiled_run_loop(st, sm, DT, n, q=2, nonlinear=True), 1000)
    res["fe_step FE 64"] = per_step_us(lambda n: fused_run_loop(st, sm, DT, n), 2000)
    model, st = igw_lattice(256)
    sm = model.struct_mesh
    res["tiled_step FB 256"] = per_step_us(lambda n: tiled_run_loop(st, sm, DT, n, fb=True), 200)
    return res


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else "")))
