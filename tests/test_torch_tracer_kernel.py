"""The tracer arms of the hand-written forward kernels (fe_step FE,
tiled_step FE and FB at q = 1, 2) against their plain PyTorch versions, on a
CUDA card. These tests skip on machines without one. They import no JAX, so
on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_tracer_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
from mpas_ocean_tpu_torch.structured import (
    StructState,
    fused_model,
    fused_run_loop,
    structured_auto_run_loop,
    structured_run_loop,
    tiled_run_loop,
)

from torch_gpu_cases import (  # noqa: F401 (fixture)
    FIELDS,
    TRACER_FIELDS,
    channel_lattice,
    cuda,
    random_forcing,
    random_lattice,
    tracer_errors,
    wave_lattice,
    with_tracers,
)

pytestmark = pytest.mark.gpu

# (name, fb, q, tile) of the arms: fe_step FE at its planner's tile and at
# the f32 main path's (4, 16); the tiled kernel FE and FB at q = 1 and 2
ARMS = [("fe_step", False, 1, None), ("fe_step", False, 1, (4, 16)),
        ("tiled_step", False, 1, (4, 8)), ("tiled_step", False, 2, (4, 8)),
        ("tiled_step", True, 1, (4, 8)), ("tiled_step", True, 2, (8, 16))]
OPTS = [(0.0, 1.0), (5.0, 0.5), (5.0, 0.0)]


def _lattice(masked, n=32, k=6, device=None, dtype=np.float64):
    model, st = (channel_lattice if masked else random_lattice)(n, n, k, device, seed=9,
                                                                dtype=dtype)
    return model, with_tracers(model, st)


def _run(arm, st, mesh, n, kappa, upwind):
    name, fb, q, tile = arm
    if name == "tiled_step":
        return tiled_run_loop(st, mesh, 10.0, n, row_tile=tile[0], col_tile=tile[1], q=q, fb=fb,
                              tracer_kappa=kappa, tracer_upwind=upwind)
    if tile is None:
        return fused_run_loop(st, mesh, 10.0, n, tracer_kappa=kappa, tracer_upwind=upwind)
    dtype = st.layer_thickness.dtype
    kt = fused_model.kernel_tracers(st, mesh, kappa, upwind)
    out = fe_step._rollout(st.ssh, st.layer_thickness, st.normal_velocity,
                           mesh.f_edge.to(dtype).contiguous(),
                           mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil,
                           fused_model._scal(mesh, 10.0, dtype), n, tile,
                           fused_model.kernel_live(mesh), None, kt)
    return StructState(*out[:3], fused_model.tracer_unplanes(out[3]))


@pytest.mark.parametrize("kappa, upwind", OPTS)
@pytest.mark.parametrize("arm", ARMS, ids=lambda a: f"{a[0]}-{'FB' if a[1] else 'FE'}-q{a[2]}")
@pytest.mark.parametrize("masked", [False, True])
def test_tracer_arm_matches_plain_f64(cuda, masked, arm, kappa, upwind):
    """10 steps with two tracers on a random 32 x 32 x 6 f64 state: every
    field and the tracers within 1e-12 of their scales of the plain steps;
    a rerun bitwise equal; the tracers left where they started (a run that
    drops them) at least 100x off; on a channel, T = 0 on culled cells."""
    model, st = _lattice(masked, device=cuda)
    mesh = model.struct_mesh
    ref = structured_run_loop(st, mesh, 10.0, 10, fb=arm[1], tracer_kappa=kappa,
                              tracer_upwind=upwind)
    out = _run(arm, st, mesh, 10, kappa, upwind)
    errs = tracer_errors(out, ref, mesh)
    assert max(errs.values()) <= 1e-12, errs
    again = _run(arm, st, mesh, 10, kappa, upwind)
    assert all(torch.equal(getattr(out, f), getattr(again, f)) for f in TRACER_FIELDS)
    miss = float((st.tracers - ref.tracers).abs().max() / ref.tracers.abs().max())
    assert miss >= 100 * 1e-12
    if masked:
        dead = (mesh.cell_mask == 0)[..., None, None].expand_as(out.tracers)
        assert bool((out.tracers.masked_select(dead) == 0).all())


@pytest.mark.parametrize("fb", [False, True])
def test_tracer_launch_counts(cuda, fb):
    """Each launch of a tracer arm counts once in launches and once in
    tracer_launches: n fe_step launches for FE, n / q tiled_step for FB."""
    model, st = _lattice(False, device=cuda)
    mesh = model.struct_mesh
    for m in (fe_step, tiled_step):
        m.launches = m.tracer_launches = 0
    structured_auto_run_loop(st, mesh, 10.0, 6, fb=fb)
    tiled_run_loop(st, mesh, 10.0, 6, row_tile=4, col_tile=8, q=2, fb=fb)
    fe, tiled = (0, 9) if fb else (6, 3)
    assert (fe_step.launches, fe_step.tracer_launches) == (fe, fe)
    assert (tiled_step.launches, tiled_step.tracer_launches) == (tiled, tiled)


def test_tracer_free_arms_run_without_tracers(cuda):
    """A state without tracers runs the tracer-free arms: no tracer launch,
    and the result carries no tracers."""
    model, st = _lattice(True, device=cuda)
    bare = StructState(st.ssh, st.layer_thickness, st.normal_velocity)
    fe_step.tracer_launches = tiled_step.tracer_launches = 0
    for fb in (False, True):
        assert structured_auto_run_loop(bare, model.struct_mesh, 10.0, 4, fb=fb).tracers is None
    assert fe_step.tracer_launches == tiled_step.tracer_launches == 0


def test_card_refuses_tracers_with_nonlinear_or_forcing(cuda):
    """Tracers with the nonlinear core or with forcing, which the card
    refused before their composed arms were ported, now run there on every
    forward route (structured_auto_run_loop FE and FB, tiled_run_loop FE):
    4 steps within 1e-12 of the plain steps, each launch counted as a
    tracer launch (tests/test_torch_composed_kernel.py holds every
    combination)."""
    model, st = _lattice(False, device=cuda)
    mesh = model.struct_mesh
    forcing = random_forcing(model)
    for kw in (dict(nonlinear=True), dict(forcing=forcing)):
        for fb, run in ((False, structured_auto_run_loop), (True, structured_auto_run_loop),
                        (False, tiled_run_loop)):
            fe_step.tracer_launches = tiled_step.tracer_launches = 0
            out = run(st, mesh, 10.0, 4, fb=fb, **kw)
            ref = structured_run_loop(st, mesh, 10.0, 4, fb=fb, **kw)
            assert max(tracer_errors(out, ref, mesh).values()) <= 1e-12, (kw, fb)
            assert fe_step.tracer_launches + tiled_step.tracer_launches == 4


@pytest.mark.parametrize("fb", [False, True])
def test_tracer_arm_f32_at_full_depth(cuda, fb):
    """bench.py's 64 x 64 x 100 f32 IGW with two random tracers, 100 steps
    of 30 s, upwind 1: the tracers' distance from an f64 plain run within 3x
    the larger of the plain f32 run's and 4 f32 epsilons of their scale
    (PERF.md section 2); the plain run with the tracers stored in bf16 each
    step misses that bound."""
    model, st = wave_lattice("igw", 64, 100, cuda)
    st = with_tracers(model, st)
    mesh = model.struct_mesh
    model64, _ = wave_lattice("igw", 64, 100, cuda, np.float64)
    st64 = StructState(*(getattr(st, f).double() for f in TRACER_FIELDS))
    out = structured_auto_run_loop(st, mesh, 30.0, 100, fb=fb)
    ref = structured_run_loop(st, mesh, 30.0, 100, fb=fb)
    ref64 = structured_run_loop(st64, model64.struct_mesh, 30.0, 100, fb=fb)
    bf = st
    for _ in range(100):
        bf = structured_run_loop(bf, mesh, 30.0, 1, fb=fb)
        bf = StructState(bf.ssh, bf.layer_thickness, bf.normal_velocity,
                         bf.tracers.bfloat16().float())
    gap = lambda x: float((x.tracers.double() - ref64.tracers).abs().max())  # noqa: E731
    limit = 3 * max(gap(ref), 4 * float(np.finfo(np.float32).eps) * float(ref64.tracers.abs().max()))
    assert gap(out) <= limit, (gap(out), gap(ref))
    assert gap(bf) > limit, (gap(bf), gap(ref))
