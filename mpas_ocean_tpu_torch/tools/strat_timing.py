"""Time the forward kernels' stratified arms on the card, beside their
unstratified arms, to compare checkouts of the package.

    python -m mpas_ocean_tpu_torch.tools.strat_timing [--sizes 64 256] [--steps 1000]

For each lattice size (n x n cells, 100 levels, f32, the inertial-gravity
wave at dt = 30 s, bench.py's densities 1025 + linspace(0, 1, 100)) it times
``structured_auto_run_loop`` FE (fe_step) and FB (tiled_step, the
planner's plan), stratified and unstratified in turns (unstratified,
stratified, stratified, unstratified), each the device µs per step of one
``--steps`` rollout by CUDA events after a warm-up rollout. Prints one JSON
line with every rep's µs per step, the card and the package's path. To
compare checkouts on one card, run this file against each in turn:

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("strat_timing needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip()
    sizes = [time_size(n, args.steps) for n in args.sizes]
    print(json.dumps({"package": mpas_ocean_tpu_torch.__file__, "gpu": gpu, "sizes": sizes}),
          flush=True)


if __name__ == "__main__":
    main()
