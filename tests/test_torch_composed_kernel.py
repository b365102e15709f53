"""The composed arms of the hand-written forward kernels (fe_step FE and
tiled_step FB, the nonlinear core's and the linear one's, with momentum
forcing, tracers and layered stratification in every combination of two or
more options) against their plain PyTorch versions, on a CUDA card. These
tests skip on machines without one. They import no JAX, so on a GPU machine
without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_composed_kernel.py
"""

import itertools

import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
from mpas_ocean_tpu_torch.structured import (
    StructState,
    fused_model,
    structured_auto_run_loop,
    structured_run_loop,
    tiled_run_loop,
)

from torch_gpu_cases import (  # noqa: F401 (fixture)
    FIELDS,
    TRACER_FIELDS,
    assert_walls_closed,
    channel_lattice,
    cuda,
    forward_errors,
    random_forcing,
    random_lattice,
    stratification,
    tracer_errors,
    wave_lattice,
    with_tracers,
)

pytestmark = pytest.mark.gpu

OPTIONS = ("nonlinear", "forced", "tracers", "strat")
# every combination of two or more options: 6 + 4 + 1
COMBOS = [c for r in (2, 3, 4) for c in itertools.combinations(OPTIONS, r)]
# 36 levels: chunks of 8 over 5 ranks, the last of 4, so that the nonlinear
# arms walk several slices per chunk and the forced levels fall in several
# ranks and slices
K = 36
DT, STEPS = 10.0, 10
KW = dict(tracer_kappa=5.0, tracer_upwind=0.5)


def _case(masked, device, dtype=np.float64):
    """(model, state with two tracers, random forcing, stratification) on a
    32 x 32 lattice (or channel) of K 10 m levels, u of 0.5 m/s, so that
    the nonlinear terms matter."""
    model, st = (channel_lattice if masked else random_lattice)(32, 32, K, device, seed=9,
                                                                dtype=dtype, u_amp=0.5)
    return (model, with_tracers(model, st), random_forcing(model),
            stratification(K, dtype=dtype))


def _run(run, case, opts, fb, **kw):
    model, st, forcing, strat = case
    if "tracers" not in opts:
        st = StructState(st.ssh, st.layer_thickness, st.normal_velocity)
    return run(st, model.struct_mesh, DT, STEPS, nonlinear="nonlinear" in opts, fb=fb,
               forcing=forcing if "forced" in opts else None,
               strat=strat if "strat" in opts else None, **KW, **kw)


def _errors(out, ref, mesh):
    return (tracer_errors if ref.tracers is not None else forward_errors)(out, ref, mesh)


@pytest.fixture(scope="module", params=[False, True], ids=["periodic", "channel"])
def case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _case(request.param, torch.device("cuda"))


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
@pytest.mark.parametrize("combo", COMBOS, ids="+".join)
def test_composed_arm_matches_plain_f64(case, combo, fb):
    """10 steps with two or more options through structured_auto_run_loop
    (fe_step FE, tiled_step FB; the nonlinear arms at their planner's
    composed plan) on a random 32 x 32 x 36 f64 state: every field and the
    tracers within 1e-12 of their scales of the plain steps; a rerun
    bitwise equal; each run with one of its options other than the tracers
    dropped at least 100x off (the control); on a channel the closed edges
    +0."""
    mesh = case[0].struct_mesh
    on = set(combo)
    ref = _run(structured_run_loop, case, on, fb)
    out = _run(structured_auto_run_loop, case, on, fb)
    assert max(_errors(out, ref, mesh).values()) <= 1e-12, _errors(out, ref, mesh)
    again = _run(structured_auto_run_loop, case, on, fb)
    assert all(torch.equal(getattr(out, f), getattr(again, f))
               for f in (TRACER_FIELDS if "tracers" in on else FIELDS))
    for drop in on - {"tracers"}:
        bare = _run(structured_auto_run_loop, case, on - {drop}, fb)
        assert max(forward_errors(bare, ref, mesh).values()) >= 100 * 1e-12, drop
    if mesh.edge_mask is not None:
        assert_walls_closed(out.normal_velocity, mesh)


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
@pytest.mark.parametrize("combo", [c for c in COMBOS if "nonlinear" not in c], ids="+".join)
def test_composed_linear_arm_at_q2_matches_plain_f64(case, combo, fb):
    """The linear core's composed arms of the tiled kernel at q = 2, at the
    planner's tile (the largest whose composed window fits at 36 f64
    levels): 10 steps within 1e-12 of the plain steps, a rerun bitwise
    equal."""
    mesh = case[0].struct_mesh
    ref = _run(structured_run_loop, case, set(combo), fb)
    run = lambda: _run(tiled_run_loop, case, set(combo), fb, q=2)  # noqa: E731
    out = run()
    assert max(_errors(out, ref, mesh).values()) <= 1e-12, _errors(out, ref, mesh)
    again = run()
    assert all(torch.equal(getattr(out, f), getattr(again, f)) for f in FIELDS)


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
def test_composed_nonlinear_arm_on_ragged_tiles(case, fb):
    """All four options through the nonlinear arms' wrappers on (3, 5)
    tiles, which divide neither side of the 32 x 32 lattice, in slices of 2
    levels: 10 steps within 1e-12 of the plain steps, tracers too."""
    model, st, forcing, strat = case
    mesh, dtype, device = model.struct_mesh, st.layer_thickness.dtype, st.ssh.device
    ref = structured_run_loop(st, mesh, DT, STEPS, nonlinear=True, fb=fb, forcing=forcing,
                              strat=strat, **KW)
    run = tiled_step.tiled_nl_rollout if fb else fe_step.fe_nl_rollout
    out = run(st.ssh, st.layer_thickness, st.normal_velocity,
              mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil,
              fused_model.nl_setup(mesh, dtype), mesh.vertex_cell_terms, mesh.edge_vertex_terms,
              *fused_model._scal(mesh, DT, dtype), *fused_model.nl_scal(mesh, dtype), STEPS,
              tile=(3, 5), ks=2, live=fused_model.kernel_live(mesh),
              forcing=fused_model.kernel_forcing(forcing, mesh, dtype, device),
              tracers=fused_model.kernel_tracers(st, mesh, KW["tracer_kappa"],
                                                 KW["tracer_upwind"]),
              strat_w=fused_model.kernel_strat(strat, dtype, device))
    got = StructState(*out[:3], fused_model.tracer_unplanes(out[3]))
    assert max(tracer_errors(got, ref, mesh).values()) <= 1e-12, tracer_errors(got, ref, mesh)


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
def test_composed_launch_counts(cuda, fb):
    """Each launch of a composed arm counts once in launches and once in
    each of its arms' counters: n fe_step launches for FE, n tiled_step
    for FB, nonlinear or not."""
    case = _case(False, cuda)
    counters = (fe_step, tiled_step)
    for nonlinear in (False, True):
        for m in counters:
            m.launches = m.forced_launches = m.tracer_launches = m.strat_launches = 0
        opts = set(OPTIONS) - (set() if nonlinear else {"nonlinear"})
        _run(structured_auto_run_loop, case, opts, fb)
        arm, other = (tiled_step, fe_step) if fb else (fe_step, tiled_step)
        assert (arm.launches, arm.forced_launches, arm.tracer_launches,
                arm.strat_launches) == (STEPS,) * 4
        assert other.launches == 0


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
def test_equal_densities_reproduce_the_unstratified_composed_arm(cuda, fb):
    """Equal densities (W = 0) through the nonlinear core's composed arm with
    forcing and tracers reproduce the unstratified composed arm within
    1e-12 of each field's scale, on the channel."""
    model, st, forcing, _ = _case(True, cuda)
    mesh = model.struct_mesh
    eq = mt.make_stratification([1026.0] * K)
    kw = dict(nonlinear=True, fb=fb, forcing=forcing, **KW)
    a = structured_auto_run_loop(st, mesh, DT, STEPS, strat=eq, **kw)
    b = structured_auto_run_loop(st, mesh, DT, STEPS, **kw)
    assert max(tracer_errors(a, b, mesh).values()) <= 1e-12


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
@pytest.mark.parametrize("masked", [False, True], ids=["periodic", "channel"])
def test_composed_arm_keeps_a_uniform_tracer_and_the_content(cuda, masked, fb):
    """All four options on the card: a uniform S = 35 stays 35 to 1e-12
    (on the live cells), and each tracer's total content sum(h T) (the
    lattice's cells share one area; culled cells hold h = 0) is conserved
    to 1e-12 of itself over 10 steps."""
    model, st, forcing, strat = _case(masked, cuda)
    mesh = model.struct_mesh
    tr = st.tracers.clone()
    live = torch.ones_like(tr[:, :, :, 1]) if mesh.cell_mask is None else \
        mesh.cell_mask.to(tr.dtype)[..., None].expand_as(tr[:, :, :, 1])
    tr[:, :, :, 1] = 35.0 * live
    st = StructState(st.ssh, st.layer_thickness, st.normal_velocity, tr)
    out = structured_auto_run_loop(st, mesh, DT, STEPS, nonlinear=True, fb=fb, forcing=forcing,
                                   strat=strat, **KW)
    s = out.tracers[:, :, :, 1]
    assert float(((s - 35.0) * live).abs().max()) <= 35.0 * 1e-12
    before, after = ((x.layer_thickness[:, :, :, None] * x.tracers).sum((0, 1, 2, 4))
                     for x in (st, out))
    assert float(((after - before) / before).abs().max()) <= 1e-12


@pytest.mark.parametrize("fb", [False, True], ids=["FE", "FB"])
def test_composed_arm_f32_at_full_depth(cuda, fb):
    """bench.py's full-physics cell, the 64 x 64 x 100 f32 IGW with the
    nonlinear core, its forcing (wind 0.1 Pa, r_lin 1e-4, lambda 1e-5), two
    tracers and densities 1025 + linspace(0, 1, 100), 100 steps of 30 s
    through structured_auto_run_loop: each field's distance from an f64
    plain run within 3x the plain f32 run's (the tracers' within 3x the
    larger of that and 4 f32 epsilons of their scale); the plain run with
    its state stored in bf16 after each step misses that bound in some
    field."""
    model, st = wave_lattice("igw", 64, 100, cuda)
    model64, _ = wave_lattice("igw", 64, 100, cuda, np.float64)
    st = with_tracers(model, st)
    mesh, mesh64 = model.struct_mesh, model64.struct_mesh
    forcings = []
    for dtype, m in ((np.float32, model), (np.float64, model64)):
        horz = mt.planar_hex_mesh(64, 64, 10000.0e3 / 64, f0=1e-4, dtype=dtype)
        vert = mt.make_vertical_mesh(horz, 100, resting_thickness=np.full(
            (horz.n_cells, 100), 10.0, dtype=dtype), dtype=dtype)
        forcings.append(m.to_struct_forcing(mt.make_forcing(
            mt.Mesh(horz=horz, vert=vert), wind_stress_zonal=0.1, bottom_drag_linear=1e-4,
            rayleigh=1e-5, dtype=dtype)))
    f32, f64 = forcings
    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, 100), dtype=np.float32)
    kw = dict(nonlinear=True, fb=fb, strat=strat)
    st64 = StructState(*(getattr(st, f).double() for f in TRACER_FIELDS))
    out = structured_auto_run_loop(st, mesh, 30.0, 100, forcing=f32, **kw)
    ref = structured_run_loop(st, mesh, 30.0, 100, forcing=f32, **kw)
    ref64 = structured_run_loop(st64, mesh64, 30.0, 100, forcing=f64, **kw)
    bf = st
    for _ in range(100):
        bf = structured_run_loop(bf, mesh, 30.0, 1, forcing=f32, **kw)
        bf = StructState(*(getattr(bf, f).bfloat16().float() for f in TRACER_FIELDS))
    eps = float(np.finfo(np.float32).eps)
    control_fails = False
    for f in TRACER_FIELDS:
        gap = lambda x: float((getattr(x, f).double()  # noqa: E731
                               - getattr(ref64, f)).abs().max())
        floor = 4 * eps * float(ref64.tracers.abs().max()) if f == "tracers" else 0.0
        limit = 3 * max(gap(ref), floor)
        assert gap(out) <= limit, (f, gap(out), gap(ref))
        control_fails = control_fails or gap(bf) > limit
    assert control_fails
