"""The coastal Kelvin channel in the PyTorch port against the JAX package, on
the CPU at f64 (numpy-seeded inputs): ``mesh.cull_cells``, ``KelvinWave``,
the channel form of ``StructuredModel`` (wall masks, embedding, to_struct /
from_struct), the masked plain steps and windows, the masked reverse and the
gradient through both differentiable routes, the kernels' schemes walked in
numpy with the masks, and the channel's physics (walls, volume, the wave's
propagation, as tests/test_kelvin.py holds the JAX package's gather path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu as mo
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.forward.run_loop import ocn_run_loop
from mpas_ocean_tpu.mesh.cull import cull_cells as jax_cull_cells
from mpas_ocean_tpu.mesh.vert_mesh import make_vertical_mesh as jax_make_vertical_mesh
from mpas_ocean_tpu.structured.model import StructState as JaxStructState
from mpas_ocean_tpu.structured.model import StructuredModel as JaxStructuredModel
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.model import structured_step as jax_step
from mpas_ocean_tpu.verification.kelvin_wave import KelvinWave as JaxKelvinWave
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    struct_mesh_from_numpy,
    struct_mesh_to_numpy,
    structured_adjoint_step,
    structured_auto_run_loop,
    structured_run_loop,
    tiled_rollout_diff,
    tiled_run_loop,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal, kernel_live
from mpas_ocean_tpu_torch.structured.slab import stencil_reach

from test_torch_tiled import _walk_fe_launch, _walk_tiled_launch
from torch_port_cases import STATE_FIELDS, dataclass_arrays, max_rel_err

DT = 200.0
FIELDS = STATE_FIELDS


def _channel(n, k, dc=None, **hex_kw):
    """(JAX parent, port parent, keep_cells) of an n x n periodic hex lattice
    with its first and last cell rows culled (bench.py's build_kelvin)."""
    dc = dc or 10000.0e3 / n
    hj = mo.planar_hex_mesh(n, n, dc, f0=1e-4, **hex_kw)
    hp = mt.planar_hex_mesh(n, n, dc, f0=1e-4, **hex_kw)
    y = np.asarray(hp.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    return hj, hp, keep, dc


def _models(n, k, **hex_kw):
    """The channel in both packages: (JAX model, port model on the CPU,
    JAX culled Mesh, port culled Mesh)."""
    hj, hp, keep, _ = _channel(n, k, **hex_kw)
    cj, cp = jax_cull_cells(hj, keep), mt.cull_cells(hp, keep)
    rt = np.full((cp.n_cells, k), 1000.0 / k)
    mj = mo.Mesh(horz=cj, vert=jax_make_vertical_mesh(cj, k, resting_thickness=rt))
    mp = mt.Mesh(horz=cp, vert=mt.make_vertical_mesh(cp, k, resting_thickness=rt))
    smj = JaxStructuredModel(mj, n, n, parent_horz=hj, keep_cells=keep)
    smp = mt.StructuredModel(mp, n, n, device="cpu", parent_horz=hp, keep_cells=keep)
    return smj, smp, mj, mp


def _kelvin_state(mesh_p, k, seed=None):
    """The Kelvin wave on the culled mesh as numpy (ssh, h, u); with a seed,
    a random perturbation of h and u on top (u kept 0 on the walls)."""
    ssh, h, u = mt.KelvinWave(lx=10000.0).initial_state(mesh_p.horz, k)
    if seed is not None:
        rng = np.random.default_rng(seed)
        h = h + rng.normal(size=h.shape)
        wall = np.asarray(mesh_p.horz.edges.edge_mask)[:, None]
        u = (u + 0.01 * rng.normal(size=u.shape)) * wall
        ssh = h.sum(1) - np.asarray(mesh_p.vert.resting_thickness_sum)
    return ssh, h, u


def _both_states(smj, smp, arrays):
    ssh, h, u = arrays
    st_j = smj.to_struct(mo.PrognosticVars(ssh=jnp.asarray(ssh), layer_thickness=jnp.asarray(h),
                                            normal_velocity=jnp.asarray(u)))
    st_p = smp.to_struct(mt.PrognosticVars(*(torch.from_numpy(np.array(x)) for x in arrays)))
    return st_j, st_p


@pytest.fixture(scope="module")
def channel16():
    """16x16x3 Kelvin channel, perturbed at random (seed 3)."""
    smj, smp, mj, mp = _models(16, 3)
    st_j, st_p = _both_states(smj, smp, _kelvin_state(mp, 3, seed=3))
    return smj, smp, mj, mp, st_j, st_p


def _assert_close(out, ref, rtol=1e-12, atol=1e-13):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).detach().numpy(), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


# ---- the mesh and the initial state ----------------------------------------

@pytest.mark.parametrize("n", [8, 16])
def test_cull_cells_matches_jax(n):
    """Every array of the culled mesh equal to the JAX package's: integers
    exactly, floats to 1e-15."""
    hj, hp, keep, _ = _channel(n, 2)
    a, b = dataclass_arrays(jax_cull_cells(hj, keep)), dataclass_arrays(mt.cull_cells(hp, keep))
    assert a.keys() == b.keys()
    for name, want in a.items():
        got = b[name]
        if isinstance(want, (int, float, bool)) or want is None:
            assert got == want, name
            continue
        want, got = np.asarray(want), np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if np.issubdtype(want.dtype, np.integer):
            assert np.array_equal(got, want), name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-15, atol=0, err_msg=name)


def test_kelvin_initial_state_matches_jax(channel16):
    _, _, mj, mp, _, _ = channel16
    for k in (1, 3):
        want = JaxKelvinWave(lx=10000.0).initial_state(mj.horz, k)
        got = mt.KelvinWave(lx=10000.0).initial_state(mp.horz, k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    # the wall condition holds exactly on the culled mesh's boundary edges
    u = got[2][np.asarray(mp.horz.edges.edge_mask) == 0]
    assert u.size and (u == 0).all()


def test_channel_struct_mesh_matches_jax(channel16):
    """The channel form's lattice constants, masks and embedding indices
    equal the JAX package's, and carry across as numpy both ways."""
    smj, smp, *_ = channel16
    sj, sp = smj.struct_mesh, smp.struct_mesh
    for name in ("f_edge", "resting_thickness_sum", "edge_mask", "cell_mask", "dc", "dv",
                 "area_cell"):
        np.testing.assert_array_equal(getattr(sp, name).numpy(), np.asarray(getattr(sj, name)),
                                      err_msg=name)
    assert np.array_equal(smp.cell_gids, smj.cell_gids)
    assert np.array_equal(smp.edge_gids, smj.edge_gids)
    assert sp.coriolis_terms == sj.coriolis_terms
    # dead cells carry rts = 0; interior edges are the ones with two live cells
    assert (sp.resting_thickness_sum[sp.cell_mask == 0] == 0).all()
    assert 0 < int((sp.edge_mask == 0).sum()) < sp.edge_mask.numel()
    d = {f: getattr(sj, f) for f in ("nx", "ny2", "n_vert_levels", "coriolis_terms")}
    d.update({f: np.asarray(getattr(sj, f)) for f in (
        "dc", "dv", "area_cell", "f_edge", "resting_thickness_sum", "edge_mask", "cell_mask")})
    carried = struct_mesh_from_numpy(d)
    for name in ("edge_mask", "cell_mask"):
        assert torch.equal(getattr(carried, name), getattr(sp, name))
        np.testing.assert_array_equal(struct_mesh_to_numpy(carried)[name], d[name])
    d["edge_mask"] = 0.5 * d["edge_mask"]
    with pytest.raises(ValueError, match="0 and 1"):
        struct_mesh_from_numpy(d)


def test_to_struct_and_from_struct_match_jax(channel16):
    """to_struct embeds the culled state in the parent lattice (zeros on
    dead slots, u pinned to 0 on masked edges) as the JAX package does, and
    from_struct gathers it back to the culled cells and edges."""
    smj, smp, _, mp, st_j, st_p = channel16
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st_p, f).numpy(), np.asarray(getattr(st_j, f)))
    closed = (smp.struct_mesh.edge_mask == 0)[..., None].expand_as(st_p.normal_velocity)
    assert (st_p.normal_velocity[closed] == 0).all()
    back_j, back_p = smj.from_struct(st_j), smp.from_struct(st_p)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back_p, f).numpy(), np.asarray(getattr(back_j, f)))
    assert tuple(back_p.normal_velocity.shape) == (mp.n_edges, 3)
    assert tuple(back_p.ssh.shape) == (mp.n_cells,)


def test_parent_and_keep_cells_go_together(channel16):
    _, _, _, mp, _, _ = channel16
    hp = mt.planar_hex_mesh(16, 16, 10000.0e3 / 16, f0=1e-4)
    with pytest.raises(ValueError, match="go together"):
        mt.StructuredModel(mp, 16, 16, device="cpu", parent_horz=hp)
    with pytest.raises(ValueError, match="go together"):
        mt.StructuredModel(mp, 16, 16, device="cpu", keep_cells=np.ones(hp.n_cells, bool))
    with pytest.raises(ValueError, match="keep_cells"):
        mt.StructuredModel(mp, 16, 16, device="cpu", parent_horz=hp,
                           keep_cells=np.ones(hp.n_cells, bool))


def test_masked_nonlinear_raises(channel16):
    """A masked lattice built by hand, without the masked vertex constants
    (vertex_kite_planes, vertex_mask), refuses nonlinear dynamics (JAX
    tests/test_nonlinear.py:348), through every entry point, and nothing
    falls back to the linear core or to the periodic kite weights."""
    _, smp, _, _, _, st_p = channel16
    bare = dataclasses.replace(smp.struct_mesh, vertex_kite_planes=None, vertex_mask=None)
    for run in (structured_run_loop, structured_auto_run_loop, tiled_run_loop):
        with pytest.raises(NotImplementedError, match="masked vertex"):
            run(st_p, bare, DT, 2, nonlinear=True)


def test_live_bits_pack_the_mask(channel16):
    """The kernels' live bits: bit c of a site is channel c's mask."""
    _, smp, *_ = channel16
    sm = smp.struct_mesh
    live = kernel_live(sm)
    assert live.dtype == torch.int32 and tuple(live.shape) == (sm.ny2, sm.nx)
    mask = sm.edge_mask.reshape(6, sm.ny2, sm.nx).numpy()
    for c in range(6):
        np.testing.assert_array_equal((live.numpy() >> c) & 1, mask[c] != 0)
    assert kernel_live(mt.StructuredModel(
        mt.Mesh(horz=mt.planar_hex_mesh(8, 8, 1e3), vert=mt.make_vertical_mesh(
            mt.planar_hex_mesh(8, 8, 1e3), 2)), 8, 8, device="cpu").struct_mesh) is None


# ---- the masked plain steps and windows -------------------------------------

@pytest.mark.parametrize("fb", [False, True])
def test_masked_run_loop_matches_jax(channel16, fb):
    """20 FE or FB steps of the plain masked roll model against the JAX
    package's masked structured_run_loop: rtol 1e-12, atol 1e-13; the walls
    stay closed exactly."""
    smj, smp, _, _, st_j, st_p = channel16
    out = structured_run_loop(st_p, smp.struct_mesh, DT, 20, fb=fb)
    _assert_close(out, jax_run_loop(st_j, smj.struct_mesh, DT, 20, fb=fb))
    closed = (smp.struct_mesh.edge_mask == 0)[..., None].expand_as(out.normal_velocity)
    assert (out.normal_velocity[closed] == 0).all()


def test_masked_run_loop_matches_the_culled_gather_path(channel16):
    """The masked lattice against the JAX package's gather path on the culled
    mesh (ocn_run_loop, tests/test_kelvin.py:117-132), through from_struct:
    atol 1e-12."""
    _, smp, mj, mp, _, st_p = channel16
    arrays = _kelvin_state(mp, 3, seed=3)
    prog = mo.PrognosticVars(*(jnp.asarray(x) for x in arrays))
    ref = ocn_run_loop(prog, mj.to_device(), DT, 20)
    out = smp.from_struct(structured_run_loop(st_p, smp.struct_mesh, DT, 20))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("fb, plan", [
    (False, (1, 16, 1)), (False, (4, 8, 2)), (False, (8, 16, 1)),
    (True, (2, 4, 1)), (True, (4, 16, 2)), (True, (8, 8, 1)),
])
def test_masked_windows_match_the_masked_roll(channel16, fb, plan):
    """The tiled kernel's plain version (slab.window_steps on halo-padded
    windows, the wall mask windowed as f_edge) on the channel, 8 steps:
    rtol 1e-12 against the masked roll model; the 8-row tiles' windows wrap
    onto themselves across the culled rows."""
    _, smp, _, _, _, st_p = channel16
    sm = smp.struct_mesh
    rt, ct, q = plan
    out = tiled_run_loop(st_p, sm, DT, 8, row_tile=rt, col_tile=ct, q=q, fb=fb)
    ref = structured_run_loop(st_p, sm, DT, 8, fb=fb)
    for f in FIELDS:
        assert max_rel_err(getattr(out, f).numpy(), getattr(ref, f).numpy()) <= 1e-12, f


def _walk_inputs(sm, state):
    ny2, nx, k = sm.ny2, sm.nx, state.layer_thickness.shape[-1]
    return ((state.ssh.numpy(), state.layer_thickness.numpy(),
             state.normal_velocity.numpy().reshape(6, ny2, nx, k)),
            (sm.f_edge.numpy().reshape(6, ny2, nx), sm.resting_thickness_sum.numpy(),
             sm.stencil_table.numpy(), sm.coriolis_weight.numpy()),
            kernel_live(sm).numpy())


@pytest.mark.parametrize("fb, plan", [(False, (2, 4, 1)), (False, (4, 8, 2)),
                                      (True, (4, 4, 1)), (True, (2, 8, 2))])
def test_masked_tiled_kernel_walk_matches_plain(channel16, fb, plan):
    """tiled_step's masked arm walked in numpy (live bits per window site,
    u' = 0 on a clear bit; the CUDA arithmetic is checked on the card): 8
    steps, <= 1e-12 of each field's magnitude against the masked roll."""
    _, smp, _, _, _, st_p = channel16
    sm = smp.struct_mesh
    fields, consts, live = _walk_inputs(sm, st_p)
    scal = _scal(sm, DT, torch.float64)
    halo = stencil_reach(sm.coriolis_terms, fb)
    for _ in range(8 // plan[2]):
        fields = _walk_tiled_launch(*fields, *consts, *scal, *plan, halo, fb, live=live)
    ref = structured_run_loop(st_p, sm, DT, 8, fb=fb)
    for got, f in zip(fields, FIELDS):
        want = getattr(ref, f).numpy()
        assert max_rel_err(got.reshape(want.shape), want) <= 1e-12, f


@pytest.mark.parametrize("tile", [(3, 5), (4, 16), (8, 16)])
def test_masked_fe_step_walk_matches_plain(channel16, tile):
    """fe_step's masked arm walked in numpy over ragged, dividing and
    whole-lattice tiles, 6 steps: every site written once per step, <= 1e-12
    of each field's magnitude against the masked roll."""
    _, smp, _, _, _, st_p = channel16
    sm = smp.struct_mesh
    fields, consts, live = _walk_inputs(sm, st_p)
    scal = _scal(sm, DT, torch.float64)
    for _ in range(6):
        fields, written = _walk_fe_launch(*fields, *consts, *scal, *tile, live=live)
        assert (written == 1).all()
    ref = structured_run_loop(st_p, sm, DT, 6)
    for got, f in zip(fields, FIELDS):
        want = getattr(ref, f).numpy()
        assert max_rel_err(got.reshape(want.shape), want) <= 1e-12, f


# ---- the reverse --------------------------------------------------------------

def _cotangent(state, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=tuple(getattr(state, f).shape)) for f in FIELDS)


def test_masked_adjoint_step_matches_jax_vjp(channel16):
    """The plain masked adjoint step against jax.vjp of the JAX package's
    masked structured_step: the cotangents and d(dt) to rtol 1e-12."""
    smj, smp, _, _, st_j, st_p = channel16
    g = _cotangent(st_p, 5)
    _, vjp = jax.vjp(lambda s, d: jax_step(s, smj.struct_mesh, d), st_j, jnp.float64(DT))
    want, want_dt = vjp(JaxStructState(*(jnp.asarray(x) for x in g)))
    got, got_dt = structured_adjoint_step(st_p, StructState(*(torch.from_numpy(x) for x in g)),
                                          smp.struct_mesh, DT)
    _assert_close(got, want, atol=0)
    np.testing.assert_allclose(float(got_dt), float(want_dt), rtol=1e-12)


@pytest.mark.parametrize("route, plan", [
    (auto_rollout_diff, None), (auto_rollout_diff, 3),
    (tiled_rollout_diff, None), (tiled_rollout_diff, (4, 8, 2, 2)),
])
def test_masked_rollout_grad_matches_jax_grad(channel16, route, plan):
    """grad of sum(ssh_final^2) in the state and dt over 8 steps, through
    both differentiable routes on the CPU (the plain masked steps and
    reverse, in the kernels' plans), against jax.grad of the JAX package's
    masked structured_run_loop: rtol 1e-10."""
    smj, smp, _, _, st_j, st_p = channel16
    n = 8

    def obj_jax(s, dt):
        return jnp.sum(jax_run_loop(s, smj.struct_mesh, dt, n).ssh ** 2)

    r_s, r_dt = jax.grad(obj_jax, argnums=(0, 1))(st_j, jnp.float64(DT))
    x = [getattr(st_p, f).clone().requires_grad_(True) for f in FIELDS]
    dt = torch.tensor(DT, dtype=torch.float64, requires_grad=True)
    out = route(StructState(*x), smp.struct_mesh, dt, n, plan=plan)
    grads = torch.autograd.grad((out.ssh ** 2).sum(), x + [dt])
    for f, got in zip(FIELDS, grads):
        want = np.asarray(getattr(r_s, f))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max(), err_msg=f)
    np.testing.assert_allclose(float(grads[3]), float(r_dt), rtol=1e-10)


# ---- the channel's physics through the port's lattice path -------------------

@pytest.fixture(scope="module")
def kelvin32():
    """tests/test_kelvin.py's channel: 32x32, one 1000 m layer, the
    unperturbed Kelvin wave, on the port's masked lattice."""
    smj, smp, _, mp = _models(32, 1)
    _, st_p = _both_states(smj, smp, _kelvin_state(mp, 1))
    return smp, mp, st_p


def test_kelvin_wave_propagates_through_the_lattice_path(kelvin32):
    """tests/test_kelvin.py:210's criteria, through the port's
    structured_auto_run_loop (the plain masked steps on the CPU) over 5000 s:
    the ssh RMSE under 0.15 of the signal's and under half the error of the
    wave standing still."""
    smp, mp, st_p = kelvin32
    dt, n = 200.0, 25
    out = smp.from_struct(structured_auto_run_loop(st_p, smp.struct_mesh, dt, n))
    kw = mt.KelvinWave(f0=1e-4, lx=10000.0)
    x, y = np.asarray(mp.horz.cells.x), np.asarray(mp.horz.cells.y)
    exact = kw.exact_ssh(x, y, dt * n)
    rmse = np.sqrt(np.mean((out.ssh.numpy() - exact) ** 2))
    assert rmse < 0.15 * np.sqrt(np.mean(exact ** 2))
    assert rmse < 0.5 * np.sqrt(np.mean((out.ssh.numpy() - kw.exact_ssh(x, y, 0.0)) ** 2))


@pytest.mark.parametrize("fb", [False, True])
def test_volume_conserved_with_walls(kelvin32, fb):
    """tests/test_kelvin.py:72: the channel's volume over 20 steps to 1e-9
    relative, with FE and FB; u on the walls stays exactly 0."""
    smp, mp, st_p = kelvin32
    area = np.asarray(mp.horz.cells.area_cell)
    volume = lambda s: float((smp.from_struct(s).layer_thickness[:, 0].numpy() * area).sum())
    out = structured_run_loop(st_p, smp.struct_mesh, 200.0, 20, fb=fb)
    assert abs(volume(out) - volume(st_p)) < 1e-9 * abs(volume(st_p))
    wall = np.asarray(mp.horz.edges.edge_mask) == 0
    assert (smp.from_struct(out).normal_velocity.numpy()[wall] == 0).all()


def test_channel_builds_on_the_card_by_default(monkeypatch, channel16):
    """The channel form builds on the card by default too, and raises
    without one."""
    _, _, _, mp, _, _ = channel16
    _, hp, keep, _ = _channel(16, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.StructuredModel(mp, 16, 16, parent_horz=hp, keep_cells=keep)
