"""The nonlinear q-step kernel (csrc/nl_tiled.cuh: tiled_step's nonlinear
arms at q > 1, FE at reach 2 and FB at reach 3) through tiled_run_loop
against the plain nonlinear steps, on a CUDA card: periodic and the
channel, with forcing, tracers and stratification in every combination, at
f64. These tests skip on machines without a card. They import no JAX, so on
a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_window_kernel.py
"""

import pytest
import torch

from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
from mpas_ocean_tpu_torch.structured import structured_run_loop, tiled_run_loop

from torch_gpu_cases import (  # noqa: F401 (fixture)
    WINDOW_NX,
    WINDOW_NY,
    assert_walls_closed,
    composed_case,
    composed_state,
    cuda,
    window_errors,
    window_kw,
)

pytestmark = pytest.mark.gpu

DT = 10.0
# forcing (F), tracers (T) and stratification (S) with the nonlinear core
OPTS = ("", "F", "T", "S", "FT", "FS", "TS", "FTS")


def _run(st, sm, opts, forcing, strat, n, q, fb):
    return tiled_run_loop(composed_state(st, opts), sm, DT, n, q=q, nonlinear=True, fb=fb,
                          **window_kw(opts, forcing, strat))


@pytest.mark.parametrize("k, q", [(4, 2), (4, 3), (36, 2)])
@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("opts", OPTS)
def test_nonlinear_window_kernel_matches_plain_f64(cuda, opts, masked, fb, k, q):
    """2q nonlinear steps, q per launch of the q-step kernel, on a random f64
    32 x 40 state of 0.5 m/s currents (forced with random winds, levels and
    coefficients, two tracers at kappa 5 and upwind 0.5, a dense W, as the
    combination says): every field within 1e-12 of its scale of the plain
    steps; a rerun bitwise equal; 2 launches of the q-step kernel and of
    tiled_step's counters of the arms it ran, none of fe_step; each run with
    one option dropped at least 100x off (the tracers, which the state does
    not feel, left where they started); the channel's walls closed. Where
    no tile's window fits a block's shared memory (FB at q = 3 in f64, and
    some stratified FE arms at q = 3 and 36 levels: fe_step.nl_plan), the
    run raises ValueError naming it, and nothing is launched."""
    model, st, forcing, strat = composed_case("N" + opts, WINDOW_NX, k, masked, cuda,
                                              ny=WINDOW_NY)
    sm = model.struct_mesh
    n = 2 * q
    arms = dict(forced="F" in opts, n_tracers=2 * ("T" in opts), strat="S" in opts)
    tiles = [(r, c) for r in range(1, sm.ny2 + 1) if sm.ny2 % r == 0
             for c in range(1, sm.nx + 1) if sm.nx % c == 0]
    if all(fe_step.nl_smem_bytes(t, k, 8, fb, 1, **arms, q=q) > fe_step.SMEM_BYTES
           for t in tiles):
        tiled_step.window_launches = 0
        with pytest.raises(ValueError, match="shared memory"):
            _run(st, sm, opts, forcing, strat, n, q, fb)
        assert tiled_step.window_launches == 0
        return
    for m in (tiled_step, fe_step):
        for c in [c for c, v in vars(m).items() if c.endswith("launches") and isinstance(v, int)]:
            setattr(m, c, 0)
    out = _run(st, sm, opts, forcing, strat, n, q, fb)
    counts = [tiled_step.window_launches, tiled_step.launches, tiled_step.forced_launches,
              tiled_step.tracer_launches, tiled_step.strat_launches, fe_step.launches]
    assert counts == [2, 2] + [2 * (o in opts) for o in "FTS"] + [0], counts
    again = _run(st, sm, opts, forcing, strat, n, q, fb)
    ref = structured_run_loop(composed_state(st, opts), sm, DT, n, nonlinear=True, fb=fb,
                              **window_kw(opts, forcing, strat))
    errs = window_errors(out, ref, sm)
    assert max(errs.values()) <= 1e-12, errs
    for a, b in zip((out.ssh, out.layer_thickness, out.normal_velocity, out.tracers),
                    (again.ssh, again.layer_thickness, again.normal_velocity, again.tracers)):
        assert a is None or torch.equal(a, b)
    if masked:
        assert_walls_closed(out.normal_velocity, sm)
    for drop in opts:
        if drop == "T":  # the tracers ride passively: left where they started
            miss = float((st.tracers - ref.tracers).abs().max() / ref.tracers.abs().max())
        else:
            bare = _run(st, sm, opts.replace(drop, ""), forcing, strat, n, q, fb)
            miss = max(window_errors(bare, ref, sm).values())
        assert miss >= 100 * 1e-12, (drop, miss)


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
@pytest.mark.parametrize("opts", ["", "FTS"])
def test_nonlinear_window_kernel_q4(cuda, opts, fb):
    """q = 4 on a 48 x 52 lattice (26 x 48 sites a parity, room for the FB
    q = 4 window's 24 halo rows): in f64 no tile's window fits a block
    (ValueError naming the shared memory, nothing launched), nor in f32 for
    FB with every option; otherwise in f32, 8 steps in 2 launches, each
    field's distance from an f64 plain run within 3x the plain f32 run's
    (the tracers' floored at 4 f32 epsilon of their scale)."""
    import numpy as np

    model64, st64, forcing64, strat64 = composed_case("N" + opts, 48, 4, False, cuda, ny=52)
    tiled_step.window_launches = 0
    with pytest.raises(ValueError, match="shared memory"):
        _run(st64, model64.struct_mesh, opts, forcing64, strat64, 8, 4, fb)
    assert tiled_step.window_launches == 0
    model, st, forcing, strat = composed_case("N" + opts, 48, 4, False, cuda,
                                              dtype=np.float32, ny=52)
    if fb and opts:
        with pytest.raises(ValueError, match="shared memory"):
            _run(st, model.struct_mesh, opts, forcing, strat, 8, 4, fb)
        return
    _assert_f32(model, st, forcing, strat, model64, st64, forcing64, strat64, opts, 8, 4, fb)


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
def test_nonlinear_window_kernel_honours_an_explicit_plan(cuda, fb):
    """The wrapper runs the caller's tile and slice at q = 2 (a tile the
    planner would not take among them), within 1e-12 of the plain steps, and
    refuses a tile whose window does not fit a block's shared memory with a
    ValueError that names it, and a tile that does not divide the lattice."""
    from mpas_ocean_tpu_torch.structured import fused_model

    model, st, forcing, strat = composed_case("NFTS", WINDOW_NX, 4, False, cuda, ny=WINDOW_NY)
    sm = model.struct_mesh
    ref = structured_run_loop(st, sm, DT, 4, nonlinear=True, fb=fb,
                              **window_kw("FTS", forcing, strat))
    dtype = st.layer_thickness.dtype
    args = (st.ssh, st.layer_thickness, st.normal_velocity,
            sm.resting_thickness_sum.contiguous(), *sm.host_stencil,
            fused_model.nl_setup(sm, dtype), sm.vertex_cell_terms, sm.edge_vertex_terms,
            *fused_model._scal(sm, DT, dtype), *fused_model.nl_scal(sm, dtype), 4)
    kw = dict(forcing=fused_model.kernel_forcing(forcing, sm, dtype, cuda),
              tracers=fused_model.kernel_tracers(st, sm, 5.0, 0.5),
              strat_w=fused_model.kernel_strat(strat, dtype, cuda), q=2, fb=fb)
    ssh, h, u, tr = tiled_step.tiled_nl_rollout(*args, tile=(1, 2), ks=1, **kw)
    out = type(st)(ssh, h, u, fused_model.tracer_unplanes(tr))
    errs = window_errors(out, ref, sm)
    assert max(errs.values()) <= 1e-12, errs
    with pytest.raises(ValueError, match="shared memory"):
        tiled_step.tiled_nl_rollout(*args, tile=(20, 32), ks=1, **kw)
    with pytest.raises(ValueError, match="divide"):
        tiled_step.tiled_nl_rollout(*args, tile=(3, 2), ks=1, **kw)


def _assert_f32(model, st, forcing, strat, model64, st64, forcing64, strat64, opts, n, q,
                fb):
    """n steps of the f32 state at q in n / q launches, each field's distance
    from the f64 plain run of the f64 state within 3x the plain f32 run's
    (phase 19's rule; the tracers' floored at 4 f32 epsilon of their
    scale)."""
    import numpy as np

    sm, sm64 = model.struct_mesh, model64.struct_mesh
    tiled_step.window_launches = 0
    out = _run(st, sm, opts, forcing, strat, n, q, fb)
    assert tiled_step.window_launches == n // q
    plain = structured_run_loop(composed_state(st, opts), sm, DT, n, nonlinear=True, fb=fb,
                                **window_kw(opts, forcing, strat))
    ref = structured_run_loop(composed_state(st64, opts), sm64, DT, n, nonlinear=True, fb=fb,
                              **window_kw(opts, forcing64, strat64))
    eps = float(np.finfo(np.float32).eps)
    for f in ("ssh", "layer_thickness", "normal_velocity", "tracers"):
        if getattr(ref, f) is None:
            continue
        r = getattr(ref, f)
        d_k = float((getattr(out, f).double() - r).abs().max())
        d_p = float((getattr(plain, f).double() - r).abs().max())
        floor = 4 * eps * float(r.abs().max()) if f == "tracers" else 0.0
        assert d_k <= 3 * max(d_p, floor), (f, d_k, d_p)


@pytest.mark.parametrize("opts", ["", "FTS"])
def test_nonlinear_window_kernel_fb_q3_f32(cuda, opts):
    """FB at q = 3 (its f64 windows fit no block's shared memory): 6 steps of
    an f32 state on the 32 x 40 lattice, each field's distance from an f64
    plain run within 3x the plain f32 run's, in 2 launches (``_assert_f32``)."""
    import numpy as np

    model, st, forcing, strat = composed_case("N" + opts, WINDOW_NX, 4, False, cuda,
                                              dtype=np.float32, ny=WINDOW_NY)
    model64, st64, forcing64, strat64 = composed_case("N" + opts, WINDOW_NX, 4, False, cuda,
                                                      ny=WINDOW_NY)
    _assert_f32(model, st, forcing, strat, model64, st64, forcing64, strat64, opts, 6, 3, True)
