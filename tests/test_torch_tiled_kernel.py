"""The hand-written tiled q-step kernel against its plain PyTorch version, on
a CUDA card. These tests skip on machines without one. They import no JAX,
so on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_tiled_kernel.py
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
from mpas_ocean_tpu_torch.structured import (
    fused_model,
    structured_auto_run_loop,
    structured_run_loop,
    tiled_model,
    tiled_run_loop,
)
from mpas_ocean_tpu_torch.structured.slab import stencil_reach

from torch_gpu_cases import (  # noqa: F401 (fixture)
    FIELDS,
    assert_walls_closed,
    channel_lattice,
    cuda,
    assert_nonlinear_f32,
    assert_plan_f32,
    forward_errors,
    random_forcing,
    random_lattice,
    reversed_terms_mesh,
    wave_lattice,
)

pytestmark = pytest.mark.gpu

# f64 64x64x4 (ny2 = 32, so FB at q = 4 with its 8-row halo is not clamped);
# tile shapes (rows, columns), a 1-row tile among them
TILES = [(1, 8), (4, 4), (8, 16), (16, 2)]


@pytest.fixture(scope="module")
def lattice64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return random_lattice(64, 64, 4, torch.device("cuda"), seed=9)


def _rel_errors(out, ref, rts):
    """max |a - b| over the field's scale; for ssh = sum_k h - rts, the
    column thickness."""
    errs = {}
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        scale = (b + rts).abs().max() if f == "ssh" else b.abs().max()
        errs[f] = float((a - b).abs().max() / scale)
    return errs


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4])
@pytest.mark.parametrize("tile", TILES)
def test_kernel_matches_plain_f64(lattice64, fb, q, tile):
    """8 steps, f64: the kernel and its plain version (same plan) differ
    only in the order of the column sums, so 1e-12 of each field's scale."""
    model, st = lattice64
    sm = model.struct_mesh
    rt, ct = tile
    out = tiled_run_loop(st, sm, 10.0, 8, row_tile=rt, col_tile=ct, q=q, fb=fb)
    ref = tiled_model.plain_tiled_rollout(st, sm, 10.0, 8, rt, ct, q, fb)
    torch.cuda.synchronize()
    for f, err in _rel_errors(out, ref, sm.resting_thickness_sum).items():
        assert err <= 1e-12, (f, err)


# (dtype, levels, FE or FB, q, tile): chunks of 16 levels (K = 100, the main
# path's: 6 x 16 + 4) and of 4 levels (K = 22: 5 x 4 + 2), so the last
# chunk is short, at q = 1, 2 and 4 where the window fits
CHUNK_CASES = [
    (np.float32, 100, False, 1, (8, 16)), (np.float32, 100, True, 1, (8, 16)),
    (np.float32, 100, False, 2, (4, 8)), (np.float32, 100, True, 2, (2, 4)),
    (np.float32, 100, False, 4, (1, 4)),
    (np.float64, 22, False, 1, (4, 8)), (np.float64, 22, True, 1, (4, 8)),
    (np.float64, 22, False, 2, (4, 8)), (np.float64, 22, True, 2, (4, 8)),
    (np.float64, 22, False, 4, (2, 4)), (np.float64, 22, True, 4, (1, 2)),
]


@pytest.mark.parametrize("dtype, k, fb, q, tile", CHUNK_CASES)
def test_kernel_level_chunks_match_plain(cuda, dtype, k, fb, q, tile):
    """32 x 64 lattice (ny2 = 32, nx = 32) at 100 km spacing, 8 steps
    against the plain version with the same plan: f64 to 1e-12 of each
    field's scale; f32 to PERF.md section 2's bounds (ssh and h 1e-5, u
    3e-4: the column sums run in another order). At 1 km spacing and
    dt = 10 s a gravity wave crosses a cell per step, and forward Euler
    grows the f32 rounding past those bounds within 8 steps."""
    model, st = random_lattice(32, 64, k, cuda, seed=5, dtype=dtype, dc=1e5)
    sm = model.struct_mesh
    rt, ct = tile
    halo = stencil_reach(sm.coriolis_terms, fb)
    assert tiled_model.resolve_plan(sm.ny2, sm.nx, k, st.layer_thickness.element_size(),
                                    halo, 8, rt, ct, q) == (rt, ct, q)
    out = tiled_run_loop(st, sm, 10.0, 8, row_tile=rt, col_tile=ct, q=q, fb=fb)
    ref = tiled_model.plain_tiled_rollout(st, sm, 10.0, 8, rt, ct, q, fb)
    torch.cuda.synchronize()
    tol = (dict.fromkeys(FIELDS, 1e-12) if dtype == np.float64 else
           {"ssh": 1e-5, "layer_thickness": 1e-5, "normal_velocity": 3e-4})
    for f, err in _rel_errors(out, ref, sm.resting_thickness_sum).items():
        assert err <= tol[f], (f, err)


@pytest.mark.parametrize("fb, q", [(False, 1), (True, 1), (True, 2)])
def test_kernel_refuses_a_table_that_is_not_the_hex_lattices(lattice64, fb, q):
    """tiled_step takes the hex lattice's stencil table only
    (csrc/step_window.cuh, hex::): the same stencil with each channel's
    terms in reverse order raises ValueError before any launch."""
    model, st = lattice64
    sm = reversed_terms_mesh(model.struct_mesh)
    tiled_step.launches = 0
    with pytest.raises(ValueError, match="hex lattice"):
        tiled_run_loop(st, sm, 10.0, 8, row_tile=4, col_tile=8, q=q, fb=fb)
    assert tiled_step.launches == 0


@pytest.mark.parametrize("fb", [False, True])
def test_kernel_reruns_are_bitwise_equal(lattice64, fb):
    model, st = lattice64
    a = tiled_run_loop(st, model.struct_mesh, 10.0, 8, row_tile=4, col_tile=8, q=2, fb=fb)
    b = tiled_run_loop(st, model.struct_mesh, 10.0, 8, row_tile=4, col_tile=8, q=2, fb=fb)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4])
def test_launches_are_n_steps_over_q(lattice64, fb, q):
    model, st = lattice64
    before = [getattr(st, f).clone() for f in FIELDS]
    tiled_step.launches = 0
    tiled_run_loop(st, model.struct_mesh, 10.0, 12, row_tile=4, col_tile=8, q=q, fb=fb)
    assert tiled_step.launches == 12 // q
    for f, b in zip(FIELDS, before):
        assert torch.equal(getattr(st, f), b)


def test_cuda_state_never_runs_the_plain_version(lattice64, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA state reached the plain version")

    monkeypatch.setattr(tiled_model, "plain_tiled_rollout", refuse)
    monkeypatch.setattr(fused_model, "structured_run_loop", refuse)
    model, st = lattice64
    tiled_step.launches = 0
    for fb in (False, True):
        tiled_run_loop(st, model.struct_mesh, 10.0, 4, fb=fb)
        structured_auto_run_loop(st, model.struct_mesh, 10.0, 4, fb=fb)
    torch.cuda.synchronize()
    assert tiled_step.launches > 0


def test_kernel_rejects_a_plan_that_does_not_fit(lattice64):
    model, st = lattice64
    sm = model.struct_mesh
    with pytest.raises(ValueError, match="shared memory"):
        tiled_step.tiled_rollout(
            st.ssh, st.layer_thickness, st.normal_velocity, sm.f_edge,
            sm.resting_thickness_sum, *sm.host_stencil,
            10.0, 1e-3, 1e-3, 4, row_tile=32, col_tile=64, q=4, halo=(2, 2),
        )


@pytest.fixture(scope="module")
def channel64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return channel_lattice(64, 64, 4, torch.device("cuda"), seed=9)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("tile", [(1, 8), (4, 4), (8, 16)])
def test_masked_kernel_matches_plain_f64(channel64, fb, q, tile):
    """The masked arm on a 64x64x4 coastal channel, FE and FB, 8 steps,
    f64: 1e-12 of each field's scale against the plain masked windows
    (same plan) and the plain masked steps, a rerun bitwise equal, u +0.0
    bit for bit on every wall and culled edge."""
    model, st = channel64
    sm = model.struct_mesh
    rt, ct = tile
    run = lambda: tiled_run_loop(st, sm, 10.0, 8, row_tile=rt, col_tile=ct, q=q, fb=fb)
    tiled_step.launches = 0
    out, again = run(), run()
    assert tiled_step.launches == 2 * 8 // q
    for ref in (tiled_model.plain_tiled_rollout(st, sm, 10.0, 8, rt, ct, q, fb),
                structured_run_loop(st, sm, 10.0, 8, fb=fb)):
        for f, err in _rel_errors(out, ref, sm.resting_thickness_sum).items():
            assert err <= 1e-12, (f, err)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(again, f)), f
    assert_walls_closed(out.normal_velocity, sm)


@pytest.mark.parametrize("fb", [False, True])
def test_masked_kernel_f32_at_full_depth(cuda, fb):
    """The masked arm at 100 f32 levels (chunks of 16, the main path's)
    on a 32x64 channel at 100 km spacing, 8 steps of the planner's plan:
    PERF.md section 2's f32 bounds against the plain version."""
    model, st = channel_lattice(32, 64, 100, cuda, seed=5, dtype=np.float32, dc=1e5)
    sm = model.struct_mesh
    out = tiled_run_loop(st, sm, 10.0, 8, fb=fb)
    halo = stencil_reach(sm.coriolis_terms, fb)
    plan = tiled_model.resolve_plan(sm.ny2, sm.nx, 100, 4, halo, 8)
    ref = tiled_model.plain_tiled_rollout(st, sm, 10.0, 8, *plan, fb)
    torch.cuda.synchronize()
    tol = {"ssh": 1e-5, "layer_thickness": 1e-5, "normal_velocity": 3e-4}
    for f, err in _rel_errors(out, ref, sm.resting_thickness_sum).items():
        assert err <= tol[f], (f, err)
    assert_walls_closed(out.normal_velocity, sm)


# ---- the nonlinear arms (csrc/nl_step.cuh), q = 1 --------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fb, shape, tile", [
    (False, (16, 16, 4), None),      # the planner's plan
    (True, (16, 16, 4), None),
    (False, (16, 16, 20), (2, 8)),   # chunks of 4 levels
    (True, (16, 16, 33), (4, 4)),    # one value per copy
    (True, (16, 16, 100), (4, 8)),   # the main path's chunk of 16 levels
    (True, (32, 32, 4), (8, 16)),
    (True, (32, 32, 100), (8, 8)),   # the f32 main path's FB tile, in f64's largest slice
    (False, (32, 32, 4), (1, 32)),   # one-row tiles the lattice's width
])
def test_nonlinear_kernel_matches_plain_f64(cuda, fb, shape, tile, masked):
    """The tiled route's nonlinear arms, FE (reach 2, fe_step's arm) and FB
    (reach 3, tiled_step's), 6 steps at q = 1, f64, on a random state with
    u of 0.5 m/s: 1e-12 of each field's scale against the plain windows of
    the same plan and the plain nonlinear steps, a rerun bitwise equal, one
    launch a step of the arm's kernel and none of the other's; on a channel
    u +0.0 bit for bit on every wall and culled edge."""
    lattice = channel_lattice if masked else random_lattice
    model, st = lattice(*shape, cuda, seed=5, u_amp=0.5)
    sm = model.struct_mesh
    rt, ct = tile or (None, None)
    run = lambda: tiled_run_loop(st, sm, 10.0, 6, row_tile=rt, col_tile=ct, nonlinear=True,
                                 fb=fb)
    fe_step.launches = tiled_step.launches = 0
    out, again = run(), run()
    assert (fe_step.launches, tiled_step.launches) == ((0, 12) if fb else (12, 0))
    if tile is None:
        rt, ct, _ = fe_step.nl_plan(sm.ny2, sm.nx, shape[2], 8, fb)
    plan = (rt, ct, 1)
    for ref in (tiled_model.plain_tiled_rollout(st, sm, 10.0, 6, *plan, fb, nonlinear=True),
                structured_run_loop(st, sm, 10.0, 6, nonlinear=True, fb=fb)):
        for f, err in _rel_errors(out, ref, sm.resting_thickness_sum).items():
            assert err <= 1e-12, (f, err)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(again, f)), f
    if masked:
        assert_walls_closed(out.normal_velocity, sm)


@pytest.mark.parametrize("masked", [False, True])
def test_nonlinear_fb_route_runs_the_kernel(cuda, masked, monkeypatch):
    """structured_auto_run_loop(nonlinear=True, fb=True) on a CUDA state:
    one tiled_step launch a step, never the plain steps; at q = 2 on a
    32 x 32 lattice (room for the FB q = 2 window) the q-step kernel, one
    launch per two steps, within 1e-12 of the plain steps."""
    lattice = channel_lattice if masked else random_lattice
    model, st = lattice(16, 16, 4, cuda, seed=5, u_amp=0.5)
    sm = model.struct_mesh
    ref = structured_run_loop(st, sm, 10.0, 4, nonlinear=True, fb=True)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA state reached the plain version")

    monkeypatch.setattr(tiled_model, "plain_tiled_rollout", refuse)
    monkeypatch.setattr(fused_model, "structured_run_loop", refuse)
    tiled_step.launches = 0
    out = structured_auto_run_loop(st, sm, 10.0, 4, nonlinear=True, fb=True)
    assert tiled_step.launches == 4
    for f, err in _rel_errors(out, ref, sm.resting_thickness_sum).items():
        assert err <= 1e-12, (f, err)
    big, st_b = lattice(32, 32, 4, cuda, seed=5, u_amp=0.5)  # room for q = 2 windows
    ref_b = structured_run_loop(st_b, big.struct_mesh, 10.0, 4, nonlinear=True, fb=True)
    tiled_step.launches = tiled_step.window_launches = 0
    out_b = tiled_run_loop(st_b, big.struct_mesh, 10.0, 4, row_tile=2, col_tile=4, q=2,
                           nonlinear=True, fb=True)
    assert tiled_step.launches == tiled_step.window_launches == 2
    for f, err in _rel_errors(out_b, ref_b, big.struct_mesh.resting_thickness_sum).items():
        assert err <= 1e-12, (f, err)


@pytest.mark.parametrize("kind", ["igw", "kelvin"])
@pytest.mark.parametrize("fb", [False, True])
def test_nonlinear_kernel_f32_at_full_depth(cuda, kind, fb):
    """tiled_step's nonlinear arms at bench.py's 64x64x100 f32 (the IGW,
    and the Kelvin channel through the masked arms), 100 steps of dt = 30 s
    at the planner's plan: chip_smoke.py phase 12's f32 tolerances against
    the plain nonlinear steps (torch_gpu_cases.assert_nonlinear_f32)."""
    model, st = wave_lattice(kind, 64, 100, cuda)
    sm = model.struct_mesh
    model64, st64 = wave_lattice(kind, 64, 100, cuda, np.float64)
    out = tiled_run_loop(st, sm, 30.0, 100, nonlinear=True, fb=fb)
    ref = structured_run_loop(st, sm, 30.0, 100, nonlinear=True, fb=fb)
    ref64 = structured_run_loop(st64, model64.struct_mesh, 30.0, 100, nonlinear=True, fb=fb)
    torch.cuda.synchronize()
    assert_nonlinear_f32(out, ref, ref64, sm)


@pytest.mark.parametrize("masked", [False, True])
def test_nonlinear_fb_kernel_f32_at_the_main_path_plan(cuda, masked):
    """tiled_step's nonlinear FB arm at the f32 main paths' own plan
    (8, 8, 4), which does not fit f64: chip_smoke.py phase 12's check, where
    dropping the nonlinear terms misses by 100x
    (torch_gpu_cases.assert_plan_f32)."""
    assert_plan_f32(tiled_step.tiled_nl_rollout, True, (8, 8), 4, masked, cuda)


# ---- the forced arm (momentum forcing) --------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("q, tile", [(1, (4, 8)), (2, (4, 8)), (1, (2, 16))])
def test_forced_kernel_matches_plain_f64(cuda, masked, fb, q, tile):
    """tiled_step's forced arm, FE and FB, q = 1 and 2, against the plain
    forced steps on 64 x 64 x 4, 8 steps, f64: 1e-12 of each field's scale;
    a rerun bitwise equal; the walls +0.0; the unforced arm at least 100x
    that limit away."""
    model, st = (channel_lattice if masked else random_lattice)(64, 64, 4, cuda)
    sm = model.struct_mesh
    forcing = random_forcing(model)
    run = lambda f: tiled_run_loop(st, sm, 10.0, 8, row_tile=tile[0], col_tile=tile[1],  # noqa: E731
                                   q=q, fb=fb, forcing=f)
    out, again, control = run(forcing), run(forcing), run(None)
    ref = structured_run_loop(st, sm, 10.0, 8, fb=fb, forcing=forcing)
    torch.cuda.synchronize()
    errs = forward_errors(out, ref, sm)
    assert max(errs.values()) <= 1e-12, errs
    assert max(forward_errors(control, ref, sm).values()) >= 100 * 1e-12
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(again, f)), f
    if masked:
        assert_walls_closed(out.normal_velocity, sm)
