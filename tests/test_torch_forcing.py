"""The port's momentum forcing (wind stress, bottom drag, Rayleigh damping)
against the JAX package's, on the CPU at f64 (numpy-seeded inputs), the
forward half: ``make_forcing`` and ``StructuredModel.to_struct_forcing``
bit for bit, the kernels' compressed level indices against the JAX
``_forcing_setup``, the forced plain steps (linear and nonlinear, forward
Euler and forward-backward, periodic and on the coastal channel) against the
JAX roll model, the forcing term's algebra and the Rayleigh recurrence
(tests/test_forcing.py's), and the forced plain windows of the tiled kernel
against the roll steps. The CUDA forced arms are held against these plain
versions on the card (tests/test_torch_kernel.py,
tests/test_torch_tiled_kernel.py, chip_smoke.py phase 14).
"""

import numpy as np
import pytest
import torch

import mpas_ocean_tpu as mo
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.pallas_model import _forcing_setup as jax_forcing_setup
from mpas_ocean_tpu_torch.models.forcing import (
    Forcing,
    forcing_from_numpy,
    forcing_tendency,
    forcing_to_numpy,
    make_forcing,
)
from mpas_ocean_tpu_torch.structured import (
    StructState,
    structured_auto_run_loop,
    structured_run_loop,
    structured_step,
)
from mpas_ocean_tpu_torch.structured.fused_model import (
    forcing_scal,
    forcing_setup,
    pack_levels,
)
from mpas_ocean_tpu_torch.structured.model import interp_cell_to_edge
from mpas_ocean_tpu_torch.structured.tiled_model import plain_tiled_rollout

from torch_port_cases import (
    FULL_FORCING,
    STATE_FIELDS,
    both_meshes,
    forced_lattice,
    jax_forcing_dict,
    max_rel_err,
    stub_card,
)

DT = 5.0


def _varied_levels_meshes():
    """(JAX Mesh, port Mesh) of an 8 x 8 lattice of 4 levels whose cells
    start and end at random levels (tests/test_forcing.py:224's bathymetry,
    with min_level_cell varied too)."""
    k = 4
    rng = np.random.default_rng(3)
    meshes = []
    hj, hp = (pkg.planar_hex_mesh(8, 8, 5000.0, f0=0.0) for pkg in (mo, mt))
    min_lc = rng.integers(0, 2, size=hj.n_cells).astype(np.int32)
    max_lc = rng.integers(2, k + 1, size=hj.n_cells).astype(np.int32)
    lv = np.arange(k)[None, :]
    rt = np.where((lv >= min_lc[:, None]) & (lv < max_lc[:, None]), 50.0, 0.0)
    from mpas_ocean_tpu.mesh.vert_mesh import make_vertical_mesh as jax_make_vertical_mesh

    for pkg, horz, mvm in ((mo, hj, jax_make_vertical_mesh), (mt, hp, mt.make_vertical_mesh)):
        vert = mvm(horz, k, resting_thickness=rt, min_level_cell=min_lc, max_level_cell=max_lc)
        meshes.append(pkg.Mesh(horz=horz, vert=vert))
    return meshes


def _channel_meshes():
    from torch_port_cases import nl_channel

    *_, mj, mp = nl_channel(16, 2)
    return mj, mp


@pytest.mark.parametrize("case", ["full", "per_cell", "varied_levels", "channel"])
def test_make_forcing_is_the_jax_packages_bitwise(case):
    """make_forcing of the port against the JAX one, bit for bit: a 16 x 16
    hex mesh of 2 levels with wind, both drags and Rayleigh; a per-cell
    wind; a mesh whose cells start and end at varied levels; the culled
    channel (whose wall edges get no forcing)."""
    kw = dict(FULL_FORCING)
    if case in ("full", "per_cell"):
        mj, mp = both_meshes(16, 16, 2)
    elif case == "varied_levels":
        mj, mp = _varied_levels_meshes()
    else:
        mj, mp = _channel_meshes()
    if case == "per_cell":
        rng = np.random.default_rng(7)
        kw["wind_stress_zonal"] = 0.1 * rng.normal(size=mj.horz.n_cells)
        kw["wind_stress_meridional"] = 0.05 * rng.normal(size=mj.horz.n_cells)
    want = jax_forcing_dict(jax_make_forcing(mj, **kw))
    got = forcing_to_numpy(make_forcing(mp, **kw))
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        assert np.array_equal(got[name], w), name
    if case == "varied_levels":
        top, bot = got["top_mask"], got["bottom_mask"]
        assert top.sum(1).max() == 1 and (top.argmax(1) != bot.argmax(1)).any()


@pytest.mark.parametrize("channel", [False, True])
def test_struct_forcing_and_level_indices_are_the_jax_packages(channel):
    """to_struct_forcing bit for bit against the JAX one (signed wind,
    unsigned masks, zeros on a channel's dead slots), and forcing_setup's
    wind planes and compressed level indices equal to the JAX
    _forcing_setup's, -1 where it has -1; pack_levels keeps both indices."""
    smj, smp, _, _, sfj, sfp = forced_lattice(16, 3, channel)
    want = jax_forcing_dict(sfj)
    got = forcing_to_numpy(sfp)
    for name, w in want.items():
        assert np.array_equal(got[name], w), name
    ny2, nx = smp.ny2, smp.nx
    wind_j, idx_j = jax_forcing_setup(sfj, ny2, nx, np.float64)
    wind_p, idx_p = forcing_setup(sfp, ny2, nx, torch.float64)
    assert np.array_equal(wind_p.numpy(), np.asarray(wind_j)[..., 0])
    assert np.array_equal(idx_p.numpy(), np.asarray(idx_j)[..., 0])
    assert (idx_p == -1).any() == channel
    packed = pack_levels(idx_p)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (6, ny2, nx)
    assert torch.equal((packed & 0xFFFF) - 1, idx_p[:6])
    assert torch.equal((packed >> 16) - 1, idx_p[6:])
    assert forcing_scal(sfp, torch.float32) == tuple(
        float(np.float32(FULL_FORCING[k])) for k in
        ("bottom_drag_linear", "bottom_drag_quadratic", "rayleigh"))


def test_forcing_setup_refuses_masks_that_are_not_one_hot():
    """A level mask with two levels set, or a weight other than 1, raises
    NotImplementedError, as the JAX package's concrete branch does."""
    _, smp, _, _, _, sfp = forced_lattice(8, 3)
    for bad in (sfp.top_mask.clone(), sfp.bottom_mask.clone()):
        two = bad.clone()
        two[0, 0, 0, 0, :2] = 1.0
        half = bad.clone()
        half[0, 0, 0, 0] = 0.5 * half[0, 0, 0, 0]
        for mask in (two, half):
            f = Forcing(sfp.wind_edge, mask, sfp.bottom_mask, sfp.drag_linear,
                        sfp.drag_quadratic, sfp.rayleigh)
            with pytest.raises(NotImplementedError):
                forcing_setup(f, smp.ny2, smp.nx, torch.float64)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("channel", [False, True])
def test_forced_steps_match_jax(channel, nonlinear, fb):
    """20 forced steps of structured_run_loop against the JAX roll model's:
    h and u within 1e-13 of their scales, ssh within 1e-12 of its own (a
    small difference of large sums, which drifts to 1.3e-13 unforced too);
    the unforced run at least 100x farther in u."""
    smj, smp, stj, stp, sfj, sfp = forced_lattice(16, 3, channel)
    ref = jax_run_loop(stj, smj.struct_mesh, DT, 20, nonlinear, sfj, fb=fb)
    out = structured_run_loop(stp, smp.struct_mesh, DT, 20, nonlinear=nonlinear, fb=fb,
                              forcing=sfp)
    tol = {"ssh": 1e-12, "layer_thickness": 1e-13, "normal_velocity": 1e-13}
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(out, f).numpy(), getattr(ref, f)) <= tol[f], f
    unforced = structured_run_loop(stp, smp.struct_mesh, DT, 20, nonlinear=nonlinear, fb=fb)
    assert max_rel_err(unforced.normal_velocity.numpy(), ref.normal_velocity) >= 100 * 1e-13


@pytest.mark.parametrize("channel", [False, True])
def test_forced_step_is_unforced_plus_dt_tendency(channel):
    """Forward Euler: step(forcing) - step(None) = dt * forcing_tendency of
    the old u on the old h_edge (tests/test_forcing.py:66), masked on a
    channel; h is not forced."""
    _, smp, _, stp, _, sfp = forced_lattice(16, 3, channel)
    sm = smp.struct_mesh
    forced = structured_step(stp, sm, 30.0, forcing=sfp)
    base = structured_step(stp, sm, 30.0)
    want = 30.0 * forcing_tendency(stp.normal_velocity,
                                   interp_cell_to_edge(stp.layer_thickness, sm), sfp)
    if sm.edge_mask is not None:
        want = want * sm.edge_mask[..., None]
    diff = forced.normal_velocity - base.normal_velocity
    assert float((diff - want).abs().max()) <= 1e-14
    assert float(want.abs().max()) > 1e-6
    assert torch.equal(forced.layer_thickness, base.layer_thickness)


def test_rayleigh_decay_is_the_exact_recurrence():
    """Pure Rayleigh damping of a uniform-vector velocity on a flat f = 0
    layer (tests/test_forcing.py:126): structured_auto_run_loop on the CPU
    gives u_n = (1 - r dt)^n u_0 to 1e-12."""
    r, dt, n = 1e-4, 100.0, 50
    horz = mt.planar_hex_mesh(8, 8, 5000.0, f0=0.0)
    vert = mt.make_vertical_mesh(horz, 1, resting_thickness=np.full((horz.n_cells, 1), 50.0))
    mesh = mt.Mesh(horz=horz, vert=vert)
    model = mt.StructuredModel(mesh, 8, 8, device="cpu")
    angle = np.asarray(horz.edges.angle_edge)
    u0 = 0.3 * np.cos(angle) + 0.1 * np.sin(angle)
    prog = mt.PrognosticVars(torch.zeros(horz.n_cells), torch.full((horz.n_cells, 1), 50.0,
                                                                   dtype=torch.float64),
                             torch.from_numpy(u0[:, None].copy()))
    prog = mt.PrognosticVars(prog.ssh.double(), prog.layer_thickness, prog.normal_velocity)
    out = structured_auto_run_loop(model.to_struct(prog), model.struct_mesh, dt, n,
                                   forcing=model.to_struct_forcing(make_forcing(mesh, rayleigh=r)))
    got = model.from_struct(out).normal_velocity[:, 0].numpy()
    np.testing.assert_allclose(got, u0 * (1.0 - r * dt) ** n, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("channel", [False, True])
def test_forced_windows_match_the_roll_steps(channel, fb, q):
    """The tiled kernel's plain version with forcing (slab.window_steps on
    halo-padded windows, the wind and level indices windowed as f_edge)
    against the forced roll steps, 4 steps, FE and FB, periodic and masked:
    1e-12 of each field's scale."""
    _, smp, _, stp, _, sfp = forced_lattice(16, 3, channel)
    sm = smp.struct_mesh
    out = plain_tiled_rollout(stp, sm, DT, 4, 4, 4, q, fb, forcing=sfp)
    ref = structured_run_loop(stp, sm, DT, 4, fb=fb, forcing=sfp)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(out, f).numpy(), getattr(ref, f).numpy()) <= 1e-12, f
    nl = plain_tiled_rollout(stp, sm, DT, 2, 8, 16, 1, fb, nonlinear=True, forcing=sfp)
    nl_ref = structured_run_loop(stp, sm, DT, 2, nonlinear=True, fb=fb, forcing=sfp)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(nl, f).numpy(), getattr(nl_ref, f).numpy()) <= 1e-12, f


def test_forcing_carries_across_bitwise():
    """forcing_from_numpy / forcing_to_numpy round-trip the JAX Forcing's
    arrays bit for bit, dtypes and 0-d coefficients included."""
    smj, _, _, _, sfj, _ = forced_lattice(8, 2)
    d = jax_forcing_dict(sfj)
    back = forcing_to_numpy(forcing_from_numpy(d))
    for name, w in d.items():
        assert back[name].dtype == w.dtype and back[name].shape == w.shape
        assert np.array_equal(back[name], w), name


def test_forced_nonlinear_core_is_refused_on_the_card_only(monkeypatch):
    """The nonlinear reverse kernel has a forced arm now, so no guard is
    left: the gradient's steps (diff_model._Steps) build forcing with the
    nonlinear core for a CUDA state (its operands kept on the CPU here,
    torch_port_cases.stub_card), with the forced operands and the d(wind)
    (6, ny2, nx) and f64 d(coefs) accumulators the nonlinear reverse takes,
    as for the linear core, and run it for a CPU state. (The kernels:
    tests/test_torch_composed_adjoint_kernel.py.)"""
    from types import SimpleNamespace

    from mpas_ocean_tpu_torch.structured import diff_model

    stub_card(monkeypatch)
    _, smp, _, stp, _, sfp = forced_lattice(8, 2)
    sm = smp.struct_mesh
    cuda = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    for nonlinear in (True, False):
        steps = diff_model._Steps(sm, 5.0, cuda, nonlinear, forcing=sfp)
        assert steps.kf is not None and hasattr(steps, "nl_adj") == nonlinear
        assert tuple(steps.dforc.wind.shape) == (6, sm.ny2, sm.nx)
        assert steps.dforc.coefs.dtype == torch.float64
    diff_model._Steps(sm, 5.0, stp.layer_thickness, True, forcing=sfp)


def test_forced_state_stays_a_struct_state():
    """A forced step of the port keeps the state's dtype and shapes."""
    _, smp, _, stp, _, sfp = forced_lattice(8, 2)
    out = structured_step(stp, smp.struct_mesh, DT, forcing=sfp)
    assert isinstance(out, StructState)
    for f in STATE_FIELDS:
        assert getattr(out, f).shape == getattr(stp, f).shape
        assert getattr(out, f).dtype == torch.float64
