"""The tiled kernel's received-halo arm (the sharded superstep,
ShardedStructuredModel.run_pallas, slabs of R + 2 hq rows whose halo rows
the exchange fills: csrc/step_window.cuh, buffer_plane) on a CUDA card,
against the plain superstep (the same model on CPU slabs), bitwise against
the single-chip tiled_run_loop at the same plan, in reruns, and with the
exchange skipped. These tests skip on machines without a card. They import
no JAX, so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_sharded_kernel.py
"""

import pytest
import torch

from mpas_ocean_tpu_torch.structured import ShardedStructuredModel, tiled_run_loop
from mpas_ocean_tpu_torch.tools.sharded_checks import field_errors, pair_runs, run_sharded

from torch_gpu_cases import (  # noqa: F401 (fixture)
    WINDOW_NX,
    WINDOW_NY,
    composed_case,
    composed_state,
    cuda,
    window_kw,
)

pytestmark = pytest.mark.gpu

DT = 10.0
SUPERSTEPS = 3

# (options, channel, levels, FB, q, slabs): the linear core (no N) at q = 1,
# 2, 3 and the nonlinear at q = 1, 2, FE and FB, over 1, 2 and 4 slabs of
# the 32 x 40 lattice (20 rows a parity: slabs of 20, 10 and 5 rows);
# forcing, tracers and stratification alone and all four; the channel
CASES = [
    ("", False, 4, False, 1, 1), ("", False, 4, False, 2, 2), ("", False, 4, False, 3, 4),
    ("", False, 4, True, 1, 4), ("", False, 4, True, 2, 2), ("", False, 4, True, 3, 1),
    ("N", False, 4, False, 1, 2), ("N", False, 4, False, 2, 1), ("N", False, 4, True, 1, 4),
    ("N", False, 4, True, 2, 2),
    ("F", False, 36, False, 2, 2), ("T", False, 36, True, 2, 2), ("S", False, 36, False, 2, 4),
    ("NFTS", False, 36, False, 2, 2), ("NFTS", False, 4, True, 1, 2),
    ("FTS", True, 4, True, 2, 2), ("NFTS", True, 4, False, 2, 2), ("NFTS", True, 36, True, 1, 1),
]


def _case(opts, masked, k):
    model, st, forcing, strat = composed_case(opts, WINDOW_NX, k, masked, torch.device("cuda"),
                                              ny=WINDOW_NY)
    return model.struct_mesh, composed_state(st, opts), window_kw(opts, forcing, strat)


@pytest.mark.parametrize("opts, masked, k, fb, q, parts", CASES)
def test_received_halo_arm_matches_plain_superstep_f64(cuda, opts, masked, k, fb, q, parts):
    """SUPERSTEPS supersteps of q steps over ``parts`` slabs: every field
    within 1e-12 of its scale of the plain superstep; parts launches and one
    exchange per field per superstep; a rerun bitwise equal."""
    sm, st, kw = _case(opts, masked, k)
    n = SUPERSTEPS * q
    card, plain, counts = pair_runs(sm, st, parts, DT, n, q=q, fb=fb, nonlinear="N" in opts,
                                    **kw)
    for f, (_, r) in field_errors(card, plain).items():
        assert r <= 1e-12, (f, r)
    n_fields = 4 if st.tracers is not None else 3
    assert counts["fe_step"] + counts["tiled_step"] == parts * SUPERSTEPS
    assert counts["exchanges"] == n_fields * SUPERSTEPS
    again, _ = run_sharded(sm, st, [cuda] * parts, DT, n, q=q, fb=fb, nonlinear="N" in opts,
                           **kw)
    for f in ("ssh", "layer_thickness", "normal_velocity", "tracers"):
        x = getattr(card, f)
        assert x is None or torch.equal(x, getattr(again, f))


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("opts, fb, q, tile", [
    ("", False, 2, (5, 8)), ("", True, 1, (5, 16)), ("FTS", True, 2, (5, 8)),
    ("N", False, 1, (5, 8)), ("N", True, 1, (5, 8)), ("N", False, 2, (5, 8)),
    ("NFTS", True, 2, (5, 4)),
])
def test_received_halo_arm_bitwise_single_chip(cuda, opts, fb, q, tile, parts):
    """At the same plan (a row tile dividing the slab, the same column tile
    and q, so the same level split), the sharded run is the single-chip
    tiled_run_loop's bit for bit: the same kernel reads the same values,
    from the exchange's rows instead of the periodic wrap."""
    sm, st, kw = _case(opts, False, 4)
    n = 2 * q
    plan = dict(q=q, fb=fb, nonlinear="N" in opts, **kw)
    out, _ = run_sharded(sm, st, [cuda] * parts, DT, n, row_tile=tile[0], col_tile=tile[1],
                         **plan)
    ref = tiled_run_loop(st, sm, DT, n, row_tile=tile[0], col_tile=tile[1], **plan)
    for f in ("ssh", "layer_thickness", "normal_velocity", "tracers"):
        x = getattr(ref, f)
        assert x is None or torch.equal(getattr(out, f), x), f


@pytest.mark.parametrize("nonlinear", [False, True])
def test_stale_halos_miss(cuda, nonlinear):
    """The control: over 2 slabs with the exchange skipped after the first
    superstep, the halo rows keep stale values, and ssh misses the plain
    superstep by at least 100x the f64 limit of 1e-12 of its scale, where
    the exchanged run is within it."""
    opts = "N" if nonlinear else ""
    sm, st, kw = _case(opts, False, 4)
    n = 3 * 2
    plain, _ = run_sharded(sm, st, [torch.device("cpu")] * 2, DT, n, q=2, nonlinear=nonlinear,
                           **kw)
    model = ShardedStructuredModel(sm, [cuda] * 2)
    good = model.gather(model.run_pallas(model.scatter(st), DT, n, q=2, nonlinear=nonlinear,
                                         **kw))
    stale = model.gather(model.run_pallas(model.scatter(st), DT, n, q=2, nonlinear=nonlinear,
                                          exchange=False, **kw))
    assert field_errors(good, plain)["ssh"][1] <= 1e-12
    assert field_errors(stale, plain)["ssh"][1] >= 100 * 1e-12


def test_received_halo_wrappers_refuse_other_halos(cuda):
    """The wrappers take received halos of exactly the windows' q reaches
    per side."""
    from mpas_ocean_tpu_torch.kernels import tiled_step

    sm, st, _ = _case("", False, 4)
    model = ShardedStructuredModel(sm, [cuda])
    su = model._superstep_setup(model.scatter(st), DT, 4, 2, None, None, None, 0.0, 1.0, None,
                                False, False)
    rx = model.rows + 2 * su["hq"]
    ssh = torch.zeros(2, rx, sm.nx, dtype=torch.float64, device=cuda)
    h = torch.ones(2, rx, sm.nx, 4, dtype=torch.float64, device=cuda)
    u = torch.zeros(3, 2, rx, sm.nx, 4, dtype=torch.float64, device=cuda)
    f = su["cs"]["f"][0].view(3, 2, rx, sm.nx)
    rts = su["cs"]["rts"][0].view(2, rx, sm.nx)
    with pytest.raises(ValueError, match="received halo rows"):
        tiled_step.tiled_rollout(ssh, h, u, f, rts, *sm.host_stencil, DT, 1.0, 1.0, 2,
                                 row_tile=4, col_tile=8, q=2, halo=su["halo"],
                                 halo_rows=su["hq"] + 1)
