"""The hand-written CUDA step kernel against its plain PyTorch version, on a
CUDA card. These tests skip on machines without one. They import no JAX,
so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py
"""

import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.kernels import adjoint_step, fe_step, tiled_step
from mpas_ocean_tpu_torch.structured import fused_model, fused_run_loop, structured_run_loop

from torch_gpu_cases import (  # noqa: F401 (fixture)
    FIELDS,
    assert_walls_closed,
    channel_lattice,
    cuda,
    assert_nonlinear_f32,
    assert_plan_f32,
    forced_stack,
    forward_errors,
    random_forcing,
    random_lattice,
    reversed_terms_mesh,
    wave_lattice,
)

pytestmark = pytest.mark.gpu

@pytest.mark.parametrize("n_steps", [0, 1, 2, 7])
@pytest.mark.parametrize(
    "shape, dc", [((16, 16, 4), 1e3), ((10, 12, 33), 1e3), ((8, 8, 300), 1e5)]
)
def test_kernel_matches_plain_f64(cuda, shape, dc, n_steps):
    """f64: the two differ only in summation order, so 1e-12 of each
    field's magnitude. ssh = sum_k h - rts is a small difference of large
    sums, so its rounding is measured against the column thickness sum_k h.
    K = 33 and 300 cover ragged warps and k-striding. At K = 300 the 3000 m
    column rounds to ~5e-13 m; at 1 km spacing the pressure gradient would
    carry that into 1e-12 of u within two steps, at 100 km it stays below."""
    model, st = random_lattice(*shape, cuda, dc=dc)
    sm = model.struct_mesh
    out = fused_run_loop(st, sm, 10.0, n_steps)
    ref = structured_run_loop(st, sm, 10.0, n_steps)
    torch.cuda.synchronize()
    column = (ref.ssh + sm.resting_thickness_sum).abs().max()
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64
        scale = column if f == "ssh" else b.abs().max()
        err = float((a - b).abs().max() / scale)
        assert err <= 1e-12, (f, err)


@pytest.mark.parametrize("shape, tile, dc", [
    ((16, 16, 4), (3, 5), 1e3),      # ragged tiles in both directions (ny2 = 8, nx = 16)
    ((16, 16, 20), (2, 16), 1e3),    # chunks of 4 levels, 16-byte copies of f64 pairs
    ((8, 8, 4), (4, 8), 1e3),        # one tile: its 6 x 12 window wraps over the 4 x 8 lattice
    ((10, 12, 33), (4, 4), 1e3),     # K * 8 bytes not a multiple of 16: one value per copy
    ((16, 16, 100), (4, 16), 1e3),   # the main path's chunk of 16 levels
    ((8, 8, 300), (1, 3), 1e5),      # chunks of 64 levels
])
def test_kernel_tiles_match_plain_f64(cuda, shape, tile, dc):
    """fe_step's tiles at the lattice's edge and wider than it, 5 steps,
    f64: 1e-12 of each field's scale against the plain version, and a
    rerun bitwise equal (the column sums run in a fixed order). K = 300 at
    100 km spacing, as in test_kernel_matches_plain_f64."""
    model, st = random_lattice(*shape, cuda, seed=3, dc=dc)
    sm = model.struct_mesh
    args = (st.ssh, st.layer_thickness, st.normal_velocity, sm.f_edge,
            sm.resting_thickness_sum, *sm.host_stencil,
            fused_model._scal(sm, 10.0, torch.float64), 5, tile)
    out = fe_step._rollout(*args)
    again = fe_step._rollout(*args)
    ref = structured_run_loop(st, sm, 10.0, 5)
    torch.cuda.synchronize()
    column = (ref.ssh + sm.resting_thickness_sum).abs().max()
    for a, b, f in zip(out, (getattr(ref, f) for f in FIELDS), FIELDS):
        scale = column if f == "ssh" else b.abs().max()
        err = float((a.reshape(b.shape) - b).abs().max() / scale)
        assert err <= 1e-12, (f, err)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_kernel_refuses_a_table_that_is_not_the_hex_lattices(cuda):
    """fe_step takes the hex lattice's stencil table only
    (csrc/step_window.cuh, hex::): the same stencil with each channel's
    terms in reverse order raises ValueError before any launch."""
    model, st = random_lattice(16, 16, 20, cuda, seed=4)
    sm = reversed_terms_mesh(model.struct_mesh)
    assert not torch.equal(sm.stencil_table, model.struct_mesh.stencil_table)
    fe_step.launches = 0
    with pytest.raises(ValueError, match="hex lattice"):
        fused_run_loop(st, sm, 10.0, 5)
    with pytest.raises(ValueError, match="hex lattice"):
        fe_step.launch_plan(sm.host_stencil[0], sm.ny2, sm.nx, 20, (4, 16))
    assert fe_step.launches == 0


def test_kernel_counts_launches_and_keeps_inputs(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    before = [getattr(st, f).clone() for f in FIELDS]
    fe_step.launches = 0
    fused_run_loop(st, model.struct_mesh, 10.0, 5)
    assert fe_step.launches == 5
    for f, b in zip(FIELDS, before):
        assert torch.equal(getattr(st, f), b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    with pytest.raises(TypeError):
        fused_run_loop(
            mt.structured.StructState(*(getattr(st, f).half() for f in FIELDS)),
            sm, 10.0, 1,
        )
    with pytest.raises(ValueError):
        fe_step.fe_rollout(
            st.ssh, st.layer_thickness, st.normal_velocity[:, :, :-1],
            sm.f_edge, sm.resting_thickness_sum, *sm.host_stencil,
            10.0, 1e-3, 1e-3, 1,
        )


@pytest.mark.parametrize("shape, tile", [
    ((16, 16, 4), None),       # the planner's tile
    ((16, 16, 4), (3, 5)),     # ragged tiles in both directions
    ((12, 16, 33), (4, 4)),    # one value per copy; the walls cut through tiles
    ((16, 16, 100), (4, 16)),  # the main path's tile and chunk of 16 levels
])
def test_masked_kernel_matches_plain_f64(cuda, shape, tile):
    """fe_step's masked arm on a coastal channel (first and last cell rows
    culled), 7 steps, f64: 1e-12 of each field's scale against the plain
    masked steps, a rerun bitwise equal, and u +0.0 bit for bit on every
    wall and culled edge."""
    model, st = channel_lattice(*shape, cuda)
    sm = model.struct_mesh
    assert sm.edge_mask is not None
    args = (st.ssh, st.layer_thickness, st.normal_velocity, sm.f_edge,
            sm.resting_thickness_sum, *sm.host_stencil,
            fused_model._scal(sm, 10.0, torch.float64), 7, tile, fe_step.live_bits(sm.edge_mask))
    fe_step.launches = 0
    out = fe_step._rollout(*args)
    again = fe_step._rollout(*args)
    assert fe_step.launches == 14
    ref = structured_run_loop(st, sm, 10.0, 7)
    torch.cuda.synchronize()
    column = (ref.ssh + sm.resting_thickness_sum).abs().max()
    for a, b, f in zip(out, (getattr(ref, f) for f in FIELDS), FIELDS):
        scale = column if f == "ssh" else b.abs().max()
        err = float((a.reshape(b.shape) - b).abs().max() / scale)
        assert err <= 1e-12, (f, err)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    assert_walls_closed(out[2], sm)


def test_masked_kernel_f32_kelvin_channel(cuda):
    """The masked arm at 64x64x100 f32 on bench.py's Kelvin channel, 100
    steps of dt = 30 s through fused_run_loop: ssh and h within PERF.md
    section 2's f32 bound of the plain masked steps (1e-5). u carries
    g dt grad(ssh) of the two versions' different rounding of the ~1000 m
    column sums, which forward Euler grows: on this wave, whose u is
    smaller than the IGW's, the two f32 runs part by ~6e-4 of max|u| (H100,
    700 W), so u is held against an f64 run of the plain version instead:
    the kernel's distance from it at most 3x the plain f32 run's (sound
    runs read 0.99-1.03x; the plain run with u stored in fp16 reads ~9x,
    PERF.md section 2). The walls stay closed and the culled cells at
    h = 0."""
    n, k = 64, 100
    dc = 10000.0e3 / n

    def case(dtype):
        horz = mt.planar_hex_mesh(n, n, dc, f0=1e-4, dtype=dtype)
        y = np.asarray(horz.cells.y)
        keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
        chan = mt.cull_cells(horz, keep)
        vert = mt.make_vertical_mesh(
            chan, k, resting_thickness=np.full((chan.n_cells, k), 1000.0 / k, dtype=dtype),
            dtype=dtype)
        ssh, h, u = mt.KelvinWave(lx=n * dc / 1e3).initial_state(chan, k)
        model = mt.StructuredModel(mt.Mesh(horz=chan, vert=vert), n, n, device=cuda,
                                   parent_horz=horz, keep_cells=keep)
        st = model.to_struct(mt.PrognosticVars(*(torch.from_numpy(x.astype(dtype))
                                                  for x in (ssh, h, u))))
        return st, model.struct_mesh

    st, sm = case(np.float32)
    st64, sm64 = case(np.float64)
    out = fused_run_loop(st, sm, 30.0, 100)
    ref = structured_run_loop(st, sm, 30.0, 100)
    ref64 = structured_run_loop(st64, sm64, 30.0, 100)
    torch.cuda.synchronize()
    column = (ref.ssh + sm.resting_thickness_sum).abs().max()
    for f in ("ssh", "layer_thickness"):
        a, b = getattr(out, f), getattr(ref, f)
        scale = column if f == "ssh" else b.abs().max()
        assert float((a - b).abs().max() / scale) <= 1e-5, f
    gap = lambda x: float((x.normal_velocity.double() - ref64.normal_velocity).abs().max())
    assert gap(out) <= 3 * gap(ref), (gap(out), gap(ref))
    assert_walls_closed(out.normal_velocity, sm)
    dead = (sm.cell_mask == 0)[..., None].expand_as(out.layer_thickness)
    assert bool((out.layer_thickness.masked_select(dead) == 0).all())


# ---- the nonlinear arm (csrc/nl_step.cuh) -----------------------------------

def _nl_args(sm, dt, dtype=torch.float64):
    """fe_nl_rollout's constants after the state: rts, the host stencil, the
    vertex constants, the vertex stencils, the scalars."""
    return (sm.resting_thickness_sum.to(dtype).contiguous(), *sm.host_stencil,
            fused_model.nl_setup(sm, dtype), sm.vertex_cell_terms, sm.edge_vertex_terms,
            *fused_model._scal(sm, dt, dtype), *fused_model.nl_scal(sm, dtype))


def _rel(out, ref, sm):
    column = (ref.ssh + sm.resting_thickness_sum).abs().max()
    errs = {}
    for a, f in zip(out, FIELDS):
        b = getattr(ref, f)
        scale = column if f == "ssh" else b.abs().max()
        errs[f] = float((a.reshape(b.shape).double() - b.double()).abs().max() / scale)
    return errs


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape, tile, ks", [
    ((16, 16, 4), None, None),     # the planner's tile and slice
    ((16, 16, 4), (3, 5), 1),      # ragged tiles in both directions; chunks of one level
    ((8, 8, 4), (4, 8), 1),        # one tile: its 8 x 16 window wraps over the 4 x 8 lattice
    ((10, 12, 33), (4, 4), 2),     # chunks of 8 levels in 4 slices, one value per copy
    ((16, 16, 20), (2, 8), 4),     # chunks of 4 levels, 16-byte copies of f64 pairs
    ((16, 16, 100), (4, 16), 4),   # the main path's chunk of 16 levels in 4 slices
    ((16, 16, 100), (2, 8), 8),    # ... in 2 slices
    ((32, 32, 100), (8, 16), 2),   # the 256^2 f32 main path's tile, in f64's largest slice
])
def test_nonlinear_kernel_matches_plain_f64(cuda, shape, tile, ks, masked):
    """fe_step's nonlinear arm, 7 steps, f64, on a random state whose u
    (0.5 m/s) makes the relative vorticity outweigh f: 1e-12 of each field's
    scale against the plain nonlinear steps, a rerun bitwise equal, one
    launch a step; the linear steps miss by 100x the tolerance; on a
    channel u +0.0 bit for bit on every wall and culled edge."""
    lattice = channel_lattice if masked else random_lattice
    model, st = lattice(*shape, cuda, seed=5, u_amp=0.5)
    sm = model.struct_mesh
    args = (st.ssh, st.layer_thickness, st.normal_velocity, *_nl_args(sm, 10.0), 7)
    live = fused_model.kernel_live(sm)
    fe_step.launches = 0
    out = fe_step.fe_nl_rollout(*args, live=live, tile=tile, ks=ks)
    again = fe_step.fe_nl_rollout(*args, live=live, tile=tile, ks=ks)
    assert fe_step.launches == 14
    ref = structured_run_loop(st, sm, 10.0, 7, nonlinear=True)
    torch.cuda.synchronize()
    for f, err in _rel(out, ref, sm).items():
        assert err <= 1e-12, (f, err)
    assert max(_rel(out, structured_run_loop(st, sm, 10.0, 7), sm).values()) >= 1e-10
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    if masked:
        assert_walls_closed(out[2].reshape(st.normal_velocity.shape), sm)


@pytest.mark.parametrize("masked", [False, True])
def test_nonlinear_route_runs_the_kernel(cuda, masked, monkeypatch):
    """structured_auto_run_loop(nonlinear=True) on a CUDA state, FE: one
    fe_step launch a step and never the plain steps."""
    lattice = channel_lattice if masked else random_lattice
    model, st = lattice(16, 16, 4, cuda, seed=5, u_amp=0.5)
    sm = model.struct_mesh
    ref = structured_run_loop(st, sm, 10.0, 5, nonlinear=True)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA state reached the plain version")

    monkeypatch.setattr(fused_model, "structured_run_loop", refuse)
    fe_step.launches = 0
    out = mt.structured_auto_run_loop(st, sm, 10.0, 5, nonlinear=True)
    assert fe_step.launches == 5
    for f, err in _rel([getattr(out, f) for f in FIELDS], ref, sm).items():
        assert err <= 1e-12, (f, err)


def test_nonlinear_kernel_refuses_tables_that_are_not_the_hex_lattices(cuda):
    """The nonlinear arm takes the hex lattice's vertex and Coriolis tables
    only; a mesh without the vertex constants raises before any launch."""
    import dataclasses

    model, st = random_lattice(16, 16, 4, cuda, u_amp=0.5)
    sm = model.struct_mesh
    ev = list(sm.edge_vertex_terms)
    ev[0], ev[1] = ev[1], ev[0]
    for bad in (dataclasses.replace(sm, edge_vertex_terms=tuple(ev)), reversed_terms_mesh(sm)):
        with pytest.raises(ValueError, match="hex lattice"):
            fused_run_loop(st, bad, 10.0, 2, nonlinear=True)
    bare = dataclasses.replace(sm, vertex_cell_terms=(), edge_vertex_terms=(), f_vertex=None)
    fe_step.launches = 0
    with pytest.raises(ValueError, match="vertex stencils"):
        mt.structured_auto_run_loop(st, bare, 10.0, 2, nonlinear=True)
    assert fe_step.launches == 0


@pytest.mark.parametrize("kind", ["igw", "kelvin"])
def test_nonlinear_kernel_f32_at_full_depth(cuda, kind):
    """fe_step's nonlinear arm at bench.py's 64x64x100 f32 (the IGW, and
    the Kelvin channel through the masked arm), 100 steps of dt = 30 s:
    chip_smoke.py phase 12's f32 tolerances against the plain nonlinear
    steps (torch_gpu_cases.assert_nonlinear_f32)."""
    model, st = wave_lattice(kind, 64, 100, cuda)
    sm = model.struct_mesh
    model64, st64 = wave_lattice(kind, 64, 100, cuda, np.float64)
    out = fused_run_loop(st, sm, 30.0, 100, nonlinear=True)
    ref = structured_run_loop(st, sm, 30.0, 100, nonlinear=True)
    ref64 = structured_run_loop(st64, model64.struct_mesh, 30.0, 100, nonlinear=True)
    torch.cuda.synchronize()
    assert_nonlinear_f32(out, ref, ref64, sm)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tile, ks", [((4, 16), 8), ((8, 16), 4)])
def test_nonlinear_kernel_f32_at_the_main_path_plans(cuda, tile, ks, masked):
    """fe_step's nonlinear arm at the f32 main paths' own plans, (4, 16, 8)
    at 64^2 and (8, 16, 4) at 256^2, which do not fit f64: chip_smoke.py
    phase 12's check, where dropping the nonlinear terms misses by 100x
    (torch_gpu_cases.assert_plan_f32)."""
    assert_plan_f32(fe_step.fe_nl_rollout, False, tile, ks, masked, cuda)


# ---- the forced arm (momentum forcing) --------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(16, 16, 4), (64, 64, 6)])
def test_forced_kernel_matches_plain_f64(cuda, shape, masked):
    """fe_step's forced arm against the plain forced steps, 20 steps, f64:
    1e-12 of each field's scale, with random winds, all three coefficients
    non-zero and random top and bottom levels (-1 among them); a rerun
    bitwise equal, the walls +0.0; and the unforced arm at least 100x that
    limit away."""
    model, st = (channel_lattice if masked else random_lattice)(*shape, cuda)
    sm = model.struct_mesh
    forcing = random_forcing(model)
    out = fused_run_loop(st, sm, 10.0, 20, forcing=forcing)
    again = fused_run_loop(st, sm, 10.0, 20, forcing=forcing)
    ref = structured_run_loop(st, sm, 10.0, 20, forcing=forcing)
    control = fused_run_loop(st, sm, 10.0, 20)
    torch.cuda.synchronize()
    errs = forward_errors(out, ref, sm)
    assert max(errs.values()) <= 1e-12, errs
    assert max(forward_errors(control, ref, sm).values()) >= 100 * 1e-12
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(again, f)), f
    if masked:
        assert_walls_closed(out.normal_velocity, sm)


def test_forced_stack_is_the_rollout_bitwise(cuda):
    """fe_fill_stack's forced arm (the gradient's rebuild) gives the forced
    rollout's states bit for bit."""
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    forcing = random_forcing(model)
    stack = forced_stack(st, sm, 10.0, 4, forcing)
    out = fused_run_loop(st, sm, 10.0, 3, forcing=forcing)
    for x, f in zip(stack, FIELDS):
        assert torch.equal(x[3], getattr(out, f)), f


def test_forced_nonlinear_raises_on_the_card(cuda):
    """Forcing with nonlinear=True, which the card refused before the
    nonlinear kernels' forced arms were ported, now runs forward on every
    route (FE and FB) within 1e-12 of the plain steps, each launch a forced
    one, and its gradient runs too: finite, through the nonlinear reverse's
    forced arm (2 forced reverse launches)."""
    model, st = random_lattice(16, 16, 4, cuda)
    sm = model.struct_mesh
    forcing = random_forcing(model)
    for fb in (False, True):
        fe_step.forced_launches = tiled_step.forced_launches = 0
        out = mt.structured_auto_run_loop(st, sm, 10.0, 2, nonlinear=True, fb=fb,
                                          forcing=forcing)
        ref = structured_run_loop(st, sm, 10.0, 2, nonlinear=True, fb=fb, forcing=forcing)
        assert max(forward_errors(out, ref, sm).values()) <= 1e-12
        assert fe_step.forced_launches + tiled_step.forced_launches == 2
    adjoint_step.nl_forced_launches = 0
    x = [getattr(st, f).clone().requires_grad_(True) for f in FIELDS]
    out = mt.auto_rollout_diff(mt.structured.StructState(*x), sm, 10.0, 2, nonlinear=True,
                               forcing=forcing)
    grads = torch.autograd.grad((out.ssh ** 2).sum(), x)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert adjoint_step.nl_forced_launches == 2
