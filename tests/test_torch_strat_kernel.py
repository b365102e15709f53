"""The stratified arms of the hand-written forward kernels (fe_step FE,
tiled_step FE and FB at q = 1, 2) against their plain PyTorch versions, on a
CUDA card. These tests skip on machines without one. They import no JAX, so
on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_strat_kernel.py
"""

import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
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
    assert_walls_closed,
    channel_lattice,
    cuda,
    forward_errors,
    random_forcing,
    random_lattice,
    stratification,
    wave_lattice,
    with_tracers,
)

pytestmark = pytest.mark.gpu

# (name, fb, q, tile) of the arms: fe_step FE at its planner's tile and at
# (4, 16), the f32 main path's; the tiled kernel FE and FB at q = 1 and 2
# (FB's q = 2 window of (4, 8) at 36 f64 levels does not fit with the
# stratified arm's shared memory; (2, 4) does)
ARMS = [("fe_step", False, 1, None), ("fe_step", False, 1, (4, 16)),
        ("tiled_step", False, 1, (4, 8)), ("tiled_step", False, 2, (4, 8)),
        ("tiled_step", True, 1, (4, 8)), ("tiled_step", True, 2, (2, 4))]


def _lattice(masked, k, device, dtype=np.float64):
    """A random 32 x 32 lattice (or channel) of k 10 m levels at 10 km
    spacing, u of 0.01 m/s."""
    return (channel_lattice if masked else random_lattice)(32, 32, k, device, seed=9, dc=1e4,
                                                           dtype=dtype)


def _run(arm, st, mesh, n, strat):
    name, fb, q, tile = arm
    if name == "tiled_step":
        return tiled_run_loop(st, mesh, 10.0, n, row_tile=tile[0], col_tile=tile[1], q=q, fb=fb,
                              strat=strat)
    if tile is None:
        return fused_run_loop(st, mesh, 10.0, n, strat=strat)
    dtype = st.layer_thickness.dtype
    out = fe_step._rollout(st.ssh, st.layer_thickness, st.normal_velocity,
                           mesh.f_edge.to(dtype).contiguous(),
                           mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil,
                           fused_model._scal(mesh, 10.0, dtype), n, tile,
                           fused_model.kernel_live(mesh),
                           strat_w=fused_model.kernel_strat(strat, dtype, st.ssh.device))
    return StructState(*out)


@pytest.mark.parametrize("kind", ["rho", "dense"])
@pytest.mark.parametrize("k", [6, 36])
@pytest.mark.parametrize("arm", ARMS, ids=lambda a: f"{a[0]}-{'FB' if a[1] else 'FE'}-q{a[2]}")
@pytest.mark.parametrize("masked", [False, True])
def test_strat_arm_matches_plain_f64(cuda, masked, arm, k, kind):
    """10 stratified steps on a random 32 x 32 f64 state at 6 levels (one per
    rank) and 36 (chunks of 8 over 5 ranks, the last of 4), make_
    stratification's W and a dense random one: every field within 1e-12 of
    its scale of the plain steps; a rerun bitwise equal; the unstratified
    run at least 100x off in u; on a channel, the closed edges +0."""
    model, st = _lattice(masked, k, cuda)
    mesh = model.struct_mesh
    strat = stratification(k, kind)
    ref = structured_run_loop(st, mesh, 10.0, 10, fb=arm[1], strat=strat)
    out = _run(arm, st, mesh, 10, strat)
    errs = forward_errors(out, ref, mesh)
    assert max(errs.values()) <= 1e-12, errs
    again = _run(arm, st, mesh, 10, strat)
    assert all(torch.equal(getattr(out, f), getattr(again, f)) for f in FIELDS)
    bare = _run(arm, st, mesh, 10, None)
    assert forward_errors(bare, ref, mesh)["normal_velocity"] >= 100 * 1e-12
    if masked:
        assert_walls_closed(out.normal_velocity, mesh)


@pytest.mark.parametrize("fb", [False, True])
def test_strat_launch_counts(cuda, fb):
    """Each launch of a stratified arm counts once in launches and once in
    strat_launches: n fe_step launches for FE, n / q tiled_step for FB;
    an unstratified run counts none."""
    model, st = _lattice(False, 6, cuda)
    mesh, strat = model.struct_mesh, stratification(6)
    for m in (fe_step, tiled_step):
        m.launches = m.strat_launches = 0
    structured_auto_run_loop(st, mesh, 10.0, 6, fb=fb, strat=strat)
    tiled_run_loop(st, mesh, 10.0, 6, row_tile=4, col_tile=8, q=2, fb=fb, strat=strat)
    fe, tiled = (0, 9) if fb else (6, 3)
    assert (fe_step.launches, fe_step.strat_launches) == (fe, fe)
    assert (tiled_step.launches, tiled_step.strat_launches) == (tiled, tiled)
    structured_auto_run_loop(st, mesh, 10.0, 2, fb=fb)
    assert (fe_step.strat_launches, tiled_step.strat_launches) == (fe, tiled)


def test_card_refuses_strat_with_nonlinear_forcing_or_tracers(cuda):
    """Stratification with the nonlinear core, with forcing or with tracers,
    which the card refused before their composed arms were ported, now runs
    there on every forward route (structured_auto_run_loop FE and FB,
    tiled_run_loop FE): 4 steps within 1e-12 of the plain steps, each launch
    counted as a stratified launch (tests/test_torch_composed_kernel.py
    holds every combination)."""
    model, st = _lattice(False, 6, cuda)
    mesh, strat = model.struct_mesh, stratification(6)
    for kw, state in ((dict(nonlinear=True), st), (dict(forcing=random_forcing(model)), st),
                      ({}, with_tracers(model, st))):
        for fb, run in ((False, structured_auto_run_loop), (True, structured_auto_run_loop),
                        (False, tiled_run_loop)):
            fe_step.strat_launches = tiled_step.strat_launches = 0
            out = run(state, mesh, 10.0, 4, fb=fb, strat=strat, **kw)
            ref = structured_run_loop(state, mesh, 10.0, 4, fb=fb, strat=strat, **kw)
            errs = forward_errors(out, ref, mesh)
            if state.tracers is not None:
                errs["tracers"] = float((out.tracers - ref.tracers).abs().max()
                                        / ref.tracers.abs().max())
            assert max(errs.values()) <= 1e-12, (kw, fb, errs)
            assert fe_step.strat_launches + tiled_step.strat_launches == 4


@pytest.mark.parametrize("fb", [False, True])
def test_equal_densities_reproduce_the_unstratified_kernel(cuda, fb):
    """Equal densities (W = 0) on the card reproduce the unstratified arm
    within 1e-12 of each field's scale, on the channel at 36 levels."""
    model, st = _lattice(True, 36, cuda)
    mesh = model.struct_mesh
    eq = mt.make_stratification([1026.0] * 36)
    a = structured_auto_run_loop(st, mesh, 10.0, 10, fb=fb, strat=eq)
    b = structured_auto_run_loop(st, mesh, 10.0, 10, fb=fb)
    assert max(forward_errors(a, b, mesh).values()) <= 1e-12


@pytest.mark.parametrize("fb", [False, True])
def test_strat_arm_f32_at_full_depth(cuda, fb):
    """bench.py's stratified cell, the 64 x 64 x 100 f32 IGW with densities
    1025 + linspace(0, 1, 100), 100 steps of 30 s through
    structured_auto_run_loop: each field's distance from an f64 plain run
    within 3x the plain f32 run's (PERF.md section 2); the plain run with its
    state stored in bf16 after each step misses that bound in some field."""
    model, st = wave_lattice("igw", 64, 100, cuda)
    model64, _ = wave_lattice("igw", 64, 100, cuda, np.float64)
    strat = mt.make_stratification(1025.0 + np.linspace(0.0, 1.0, 100), dtype=np.float32)
    mesh = model.struct_mesh
    st64 = StructState(*(getattr(st, f).double() for f in FIELDS))
    out = structured_auto_run_loop(st, mesh, 30.0, 100, fb=fb, strat=strat)
    ref = structured_run_loop(st, mesh, 30.0, 100, fb=fb, strat=strat)
    ref64 = structured_run_loop(st64, model64.struct_mesh, 30.0, 100, fb=fb, strat=strat)
    bf = st
    for _ in range(100):
        bf = structured_run_loop(bf, mesh, 30.0, 1, fb=fb, strat=strat)
        bf = StructState(*(getattr(bf, f).bfloat16().float() for f in FIELDS))
    control_fails = False
    for f in FIELDS:
        gap = lambda x: float((getattr(x, f).double() - getattr(ref64, f)).abs().max())  # noqa: E731
        limit = 3 * gap(ref)
        assert gap(out) <= limit, (f, gap(out), gap(ref))
        control_fails = control_fails or gap(bf) > limit
    assert control_fails


def test_internal_wave_on_the_card(cuda):
    """The two-layer internal wave on a 32 x 32 f0 = 0 lattice, FB through
    the tiled kernel's stratified arm in f64, half a period (1890 steps of
    100 s): the mode's amplitude inverts within 5% and the RMSE from the
    exact standing wave is below 0.05 of the amplitude."""
    n, dc = 32, 10000.0
    iw = mt.InternalWave(lx=n * dc / 1e3, amplitude=1.0)
    horz = mt.planar_hex_mesh(n, n, dc, f0=0.0)
    vert = mt.make_vertical_mesh(horz, 2, resting_thickness=np.tile(
        np.array([iw.h1, iw.h2]), (horz.n_cells, 1)))
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n, device=cuda)
    ssh, h, u = iw.initial_state(horz)
    st = model.to_struct(mt.PrognosticVars(*(torch.from_numpy(a) for a in (ssh, h, u))))
    tiled_step.strat_launches = 0
    n_half = int(round(iw.period / 2 / 100.0))
    out = model.from_struct(structured_auto_run_loop(
        st, model.struct_mesh, 100.0, n_half, fb=True,
        strat=mt.make_stratification(iw.densities())))
    assert tiled_step.strat_launches == n_half
    x = np.asarray(horz.cells.x)
    basis = np.sin(iw.k * x)
    proj = lambda f: float(np.vdot(basis, f - iw.h1) / np.vdot(basis, basis))  # noqa: E731
    a0, a1 = proj(h[:, 0]), proj(out.layer_thickness[:, 0].numpy())
    np.testing.assert_allclose(a1, -a0, rtol=0.05)
    exact = iw.exact_thickness(x, n_half * 100.0)
    assert float(np.sqrt(np.mean((out.layer_thickness.numpy() - exact) ** 2))) < 0.05
