"""The port's tracer transport against the JAX package's, on the CPU at f64
(numpy-seeded inputs): ``make_tracers`` bit for bit, ``to_struct`` /
``from_struct`` with tracers (periodic and on the coastal channel), the
roll steps with tracers (linear and nonlinear, forward Euler and
forward-backward, forced and not, kappa in {0, 5}, upwind in {1, 0.7, 0})
against the JAX roll model, the slab step's tracer arm against
``sharded._step_slab``, the tiled kernel's plain windows and the fused
route's plain version against the JAX Pallas kernels in interpret mode, the
physics of tests/test_tracers.py on the port's lattice, the planners'
tracer planes, every gradient entry point carrying a state's tracers
against jax.vjp of the JAX roll model, and the refusals: tracers with the
nonlinear core or with forcing on the card, forward and reverse. The CUDA
tracer arms are held against these plain versions on the card
(tests/test_torch_tracer_kernel.py, chip_smoke.py phase 15; the reverse's
in tests/test_torch_tracer_adjoint_kernel.py, phase 16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_ocean_tpu as mo
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.models.tracers import make_tracers as jax_make_tracers
from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.pallas_model import _tracer_setup as jax_tracer_setup
from mpas_ocean_tpu.structured.pallas_model import pallas_run_loop as jax_pallas_run_loop
from mpas_ocean_tpu.structured.pallas_model import (
    pallas_tiled_run_loop as jax_pallas_tiled_run_loop,
)
from mpas_ocean_tpu.structured.sharded import _step_slab as jax_step_slab
from mpas_ocean_tpu_torch.kernels import fe_step, tiled_step
from mpas_ocean_tpu_torch.models import make_tracers, total_tracer_content
from mpas_ocean_tpu_torch.structured import (
    StructState,
    auto_rollout_diff,
    fused_adjoint_rollout,
    fused_rollout_diff,
    fused_run_loop,
    fused_step,
    struct_state_from_numpy,
    struct_state_to_numpy,
    structured_auto_run_loop,
    structured_run_loop,
    tiled_adjoint_rollout,
    tiled_rollout_diff,
    tiled_run_loop,
)
from mpas_ocean_tpu_torch.structured.fused_model import (
    kernel_tracers,
    tracer_opts,
    tracer_planes,
    tracer_unplanes,
)
from mpas_ocean_tpu_torch.structured.slab import step_slab, stencil_reach
from mpas_ocean_tpu_torch.structured.tiled_model import (
    plain_tiled_rollout,
    resolve_plan,
    window_bytes,
)

from torch_port_cases import (
    FULL_FORCING,
    STATE_FIELDS,
    max_rel_err,
    nl_channel,
    nl_periodic,
    stub_card,
)

DT = 5.0
FIELDS = STATE_FIELDS + ("tracers",)


def _tracer_fields(mesh, seed=9):
    """Two tracers as numpy (nCells,) and (nCells, K) fields: a temperature
    wave in x with random noise per level, and salinity 35 with noise."""
    horz = mesh.horz
    x = np.asarray(horz.cells.x)
    k = mesh.vert.n_vert_levels
    rng = np.random.default_rng(seed)
    temp = 10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1))
    temp = temp[:, None] + 0.3 * rng.normal(size=(horz.n_cells, k))
    return [temp, 35.0 + 0.5 * rng.normal(size=horz.n_cells)]


def tracer_lattice(n, k, channel=False, seed=5):
    """(JAX model, port model, JAX state, port state, JAX Mesh, port Mesh)
    on ``nl_periodic``'s or ``nl_channel``'s lattice, the states carrying
    two tracers made by each package from the same numpy fields."""
    smj, smp, stj, stp, mj, mp = (nl_channel if channel else nl_periodic)(n, k, seed)
    fields = _tracer_fields(mp)
    trj, trp = jax_make_tracers(mj, fields), make_tracers(mp, fields)
    progj = smj.from_struct(stj).replace(tracers=trj)
    progp = mt.PrognosticVars(*(getattr(smp.from_struct(stp), f) for f in STATE_FIELDS),
                              tracers=trp)
    return smj, smp, smj.to_struct(progj), smp.to_struct(progp), mj, mp


def _errs(out, ref) -> dict:
    return {f: max_rel_err(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
            for f in FIELDS}


@pytest.mark.parametrize("channel", [False, True])
def test_make_tracers_is_the_jax_packages_bitwise(channel):
    """make_tracers of the port against the JAX one, bit for bit: per-cell
    and per-level fields on the periodic lattice and on the channel."""
    *_, mj, mp = tracer_lattice(16, 3, channel)
    fields = _tracer_fields(mp)
    want = np.asarray(jax_make_tracers(mj, fields))
    got = make_tracers(mp, fields).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        make_tracers(mp, [np.zeros(mp.n_cells + 1)])


def test_tracer_update_and_content_match_jax():
    """tracer_concentration, apply_tracer_update and total_tracer_content
    against the JAX package's on an 8 x 8 mesh of 4 levels whose cells
    start and end at random levels (the guarded division: inactive levels
    exactly 0): within 1e-15 of scale."""
    from mpas_ocean_tpu.mesh.vert_mesh import make_vertical_mesh as jax_make_vertical_mesh
    from mpas_ocean_tpu.models import tracers as jt

    k, rng = 4, np.random.default_rng(4)
    hj, hp = (pkg.planar_hex_mesh(8, 8, 5000.0, f0=0.0) for pkg in (mo, mt))
    min_lc = rng.integers(0, 2, size=hj.n_cells).astype(np.int32)
    max_lc = rng.integers(2, k + 1, size=hj.n_cells).astype(np.int32)
    lv = np.arange(k)[None, :]
    rt = np.where((lv >= min_lc[:, None]) & (lv < max_lc[:, None]), 50.0, 0.0)
    kw = dict(resting_thickness=rt, min_level_cell=min_lc, max_level_cell=max_lc)
    mj = mo.Mesh(horz=hj, vert=jax_make_vertical_mesh(hj, k, **kw))
    mp = mt.Mesh(horz=hp, vert=mt.make_vertical_mesh(hp, k, **kw))
    mask = np.asarray(mp.vert.cell_level_mask)
    assert (mask == 0).any()
    tr, h0, h1 = (x * mask[:, None, :] if x.ndim == 3 else x for x in (
        10.0 + rng.normal(size=(hj.n_cells, 2, k)), 50.0 + rng.normal(size=(hj.n_cells, k)),
        50.0 + rng.normal(size=(hj.n_cells, k))))
    tend = rng.normal(size=tr.shape)
    t = torch.from_numpy
    got = mt.models.apply_tracer_update(t(tr), t(h0), t(h1), t(tend), 30.0, mask).numpy()
    want = np.asarray(jt.apply_tracer_update(jnp.asarray(tr), jnp.asarray(h0), jnp.asarray(h1),
                                             jnp.asarray(tend), 30.0, jnp.asarray(mask)))
    assert max_rel_err(got, want) <= 1e-15 and not got[mask[:, None, :].repeat(2, 1) == 0].any()
    got = mt.models.tracer_concentration(t(tr * h0[:, None, :]), t(h0), mask).numpy()
    assert max_rel_err(got, tr) <= 1e-15
    got = total_tracer_content(t(tr), t(h0), mp).numpy()
    want = np.asarray(jt.total_tracer_content(jnp.asarray(tr), jnp.asarray(h0), mj))
    assert max_rel_err(got, want) <= 1e-15


@pytest.mark.parametrize("channel", [False, True])
def test_to_and_from_struct_carry_tracers_as_jax_does(channel):
    """to_struct with tracers bit for bit against the JAX StructuredModel's
    (zeros on a channel's culled cells), the numpy carry across, and
    from_struct back to the culled mesh's cells."""
    smj, smp, stj, stp, mj, mp = tracer_lattice(16, 3, channel)
    assert stp.tracers.shape == (2, 8, 16, 2, 3)
    assert np.array_equal(stp.tracers.numpy(), np.asarray(stj.tracers))
    d = struct_state_to_numpy(stp)
    back = struct_state_from_numpy({f: np.asarray(getattr(stj, f)) for f in FIELDS})
    assert all(torch.equal(getattr(back, f), getattr(stp, f)) for f in FIELDS)
    assert np.array_equal(d["tracers"], np.asarray(stj.tracers))
    prog_j, prog_p = smj.from_struct(stj), smp.from_struct(stp)
    assert prog_p.tracers.shape == (mp.n_cells, 2, 3)
    assert np.array_equal(prog_p.tracers.numpy(), np.asarray(prog_j.tracers))
    if channel:
        dead = smp.cell_mask.numpy() == 0
        assert dead.any() and not stp.tracers.numpy()[dead].any()
    no_tr = struct_state_from_numpy({f: np.asarray(getattr(stj, f)) for f in STATE_FIELDS})
    assert no_tr.tracers is None and "tracers" not in struct_state_to_numpy(no_tr)


# (nonlinear, fb, channel, forced, kappa, upwind)
STEP_CASES = [
    (False, False, False, False, 0.0, 1.0),
    (False, False, False, False, 5.0, 0.7),
    (False, True, False, False, 5.0, 0.0),
    (False, False, True, False, 5.0, 1.0),
    (False, True, True, False, 0.0, 0.7),
    (True, False, False, False, 5.0, 1.0),
    (True, True, True, False, 5.0, 0.7),
    (False, False, False, True, 5.0, 1.0),
    (False, True, True, True, 0.0, 0.0),
    (True, False, True, True, 5.0, 0.7),
]


@pytest.mark.parametrize("nonlinear, fb, channel, forced, kappa, upwind", STEP_CASES)
def test_tracer_steps_match_jax(nonlinear, fb, channel, forced, kappa, upwind):
    """12 steps of structured_run_loop with tracers against the JAX roll
    model's, each field (the tracers among them) within 1e-12 of its scale;
    the tracer-free run leaves the state's other fields as they were with
    tracers (tracers feed nothing back)."""
    from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing

    smj, smp, stj, stp, mj, mp = tracer_lattice(16, 3, channel)
    fj = fp = None
    if forced:
        fj = smj.to_struct_forcing(jax_make_forcing(mj, **FULL_FORCING))
        fp = smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING))
    ref = jax_run_loop(stj, smj.struct_mesh, DT, 12, nonlinear, fj, tracer_kappa=kappa,
                       tracer_upwind=upwind, fb=fb)
    out = structured_run_loop(stp, smp.struct_mesh, DT, 12, nonlinear=nonlinear, fb=fb,
                              forcing=fp, tracer_kappa=kappa, tracer_upwind=upwind)
    for f, e in _errs(out, ref).items():
        assert e <= 1e-12, (f, e)
    bare = structured_run_loop(StructState(stp.ssh, stp.layer_thickness, stp.normal_velocity),
                               smp.struct_mesh, DT, 12, nonlinear=nonlinear, fb=fb, forcing=fp)
    assert bare.tracers is None
    assert all(torch.equal(getattr(bare, f), getattr(out, f)) for f in STATE_FIELDS)


def test_tracer_options_shift_the_result():
    """kappa and upwind each move the tracers far beyond the 1e-12 bound
    (the controls of test_tracer_steps_match_jax): a run with kappa 5 and
    upwind 0.7 against runs with either at its other value."""
    _, smp, _, stp, _, _ = tracer_lattice(16, 3)
    sm = smp.struct_mesh
    run = lambda kappa, upwind: structured_run_loop(  # noqa: E731
        stp, sm, DT, 12, tracer_kappa=kappa, tracer_upwind=upwind).tracers.numpy()
    ref = run(5.0, 0.7)
    for other in (run(0.0, 0.7), run(5.0, 0.0), run(5.0, 1.0)):
        assert max_rel_err(other, ref) >= 100 * 1e-12


def _pad_i(x, p):
    return np.concatenate([x[:, :, -p:], x, x[:, :, :p]], axis=2)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_step_slab_tracers_match_sharded(fb, masked):
    """One full-width slab of 3 interior rows, 8 columns, 3 levels and two
    tracers, random state, wall masks (u = 0 where masked, so sign(F) = 0
    there) and cell masks: step_slab's tracers against sharded._step_slab's
    to 1e-13 of their scale, kappa 5 and upwind 0.7."""
    smj, _, _, _, _, _ = tracer_lattice(8, 3)
    terms = smj.struct_mesh.coriolis_terms
    rows, nx, k = 3, 8, 3
    hm, hi = stencil_reach(terms, fb)
    full = rows + 2 * hm
    rng = np.random.default_rng(21 + 2 * fb + masked)
    h = 10.0 + 0.01 * rng.normal(size=(2, full, nx, k))
    u = 0.01 * rng.normal(size=(6, full, nx, k))
    mask = (rng.random(size=(6, full, nx, 1)) > 0.3).astype(np.float64) if masked else None
    if masked:
        u = u * mask
    cmask = (rng.random(size=(2, full, nx, 1)) > 0.2).astype(np.float64) if masked else None
    tr = 10.0 + rng.normal(size=(4, full, nx, k))
    rts = np.full((2, full, nx, 1), 10.0 * k)
    ssh = h.sum(-1, keepdims=True) - rts
    f = 1e-4 + 1e-6 * rng.normal(size=(6, full, nx, 1))
    dt, inv_dc, s_div = DT, 1e-3, 2.0 / (np.sqrt(3.0) * 1e3)
    planes = lambda x: None if x is None else tuple(jnp.asarray(p) for p in x)  # noqa: E731
    ref = jax_step_slab(planes(ssh), planes(h), planes(u), planes(f), planes(rts),
                        jnp.float64(dt), jnp.float64(inv_dc), jnp.float64(s_div), terms, rows,
                        masks=planes(mask), tr=list(planes(tr)), tropts=(5.0, 0.7),
                        cmask=planes(cmask), fb=fb)
    t = lambda x: None if x is None else torch.from_numpy(_pad_i(x, hi))  # noqa: E731
    out = step_slab(t(ssh), t(h), t(u), t(f), t(rts), dt, inv_dc, s_div, terms, rows, nx,
                    (hm, hi), fb, t(mask), None, t(tr), (5.0, 0.7), t(cmask))
    assert len(out) == 4
    for got, want in zip(out, ref):
        want = np.stack([np.asarray(p) for p in want])
        assert got.shape == want.shape
        assert max_rel_err(got.numpy(), want) <= 1e-13
    if masked:  # planes t * 2 + p: tracer t's on the parity-p cell mask
        dead = np.tile(cmask[:, hm:hm + rows, :, 0] == 0, (2, 1, 1))
        assert dead.any() and not out[3].numpy()[dead].any()


@pytest.mark.parametrize("channel, fb, q, kappa, upwind", [
    (False, False, 1, 5.0, 0.7),
    (True, True, 2, 5.0, 1.0),
])
def test_plain_tiled_rollout_tracers_match_pallas(channel, fb, q, kappa, upwind):
    """The tiled kernel's plain windows with tracers (4 x 8 tiles) against
    the JAX tiled Pallas kernel in interpret mode, 4 steps: each field within
    1e-12 of its scale; the same windows at another tile and q agree."""
    smj, smp, stj, stp, _, _ = tracer_lattice(16, 3, channel)
    ref = jax_pallas_tiled_run_loop(stj, smj.struct_mesh, DT, 4, row_tile=4, interpret=True,
                                    q=q, tracer_kappa=kappa, tracer_upwind=upwind, fb=fb)
    out = tiled_run_loop(stp, smp.struct_mesh, DT, 4, row_tile=4, col_tile=8, q=q, fb=fb,
                         tracer_kappa=kappa, tracer_upwind=upwind)
    for f, e in _errs(out, ref).items():
        assert e <= 1e-12, (f, e)
    other = plain_tiled_rollout(stp, smp.struct_mesh, DT, 4, 2, 16, 3 - q, fb,
                                tracer_kappa=kappa, tracer_upwind=upwind)
    for f, e in _errs(other, ref).items():
        assert e <= 1e-12, (f, e)


@pytest.mark.parametrize("channel", [False, True])
def test_fused_run_loop_tracers_match_pallas(channel):
    """fused_run_loop on the CPU (the fe_step route's plain version) with
    tracers against JAX pallas_run_loop in interpret mode with kappa 5 and
    upwind 0.7, 6 steps: each field within 1e-12 of its scale."""
    smj, smp, stj, stp, _, _ = tracer_lattice(16, 3, channel)
    ref = jax_pallas_run_loop(stj, smj.struct_mesh, DT, 6, interpret=True, tracer_kappa=5.0,
                              tracer_upwind=0.7)
    out = fused_run_loop(stp, smp.struct_mesh, DT, 6, tracer_kappa=5.0, tracer_upwind=0.7)
    for f, e in _errs(out, ref).items():
        assert e <= 1e-12, (f, e)
    auto = structured_auto_run_loop(stp, smp.struct_mesh, DT, 6, tracer_kappa=5.0,
                                    tracer_upwind=0.7)
    assert all(torch.equal(getattr(auto, f), getattr(out, f)) for f in FIELDS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_tracer_operands_match_the_jax_setup(dtype):
    """kernel_tracers' planes, cell mask and rounded (kappa, upwind) against
    the JAX _tracer_setup's; tracer_unplanes inverts tracer_planes."""
    smj, smp, stj, stp, _, _ = tracer_lattice(16, 3, channel=True)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    tr_j, cm_j, opts_j = jax_tracer_setup(stj, smj.struct_mesh, npdt, 5.0, 0.7)
    st = StructState(*(getattr(stp, f).to(dtype) for f in FIELDS))
    kt = kernel_tracers(st, smp.struct_mesh, 5.0, 0.7)
    assert kt.planes.dtype == dtype and kt.planes.is_contiguous()
    assert np.array_equal(kt.planes.numpy(), np.asarray(tr_j).astype(npdt))
    assert np.array_equal(kt.cell_mask.numpy(), np.asarray(cm_j)[..., 0])
    assert (kt.kappa, kt.upwind) == opts_j == tracer_opts(5.0, 0.7, dtype)
    assert torch.equal(tracer_unplanes(tracer_planes(stp.tracers)), stp.tracers)
    assert kernel_tracers(StructState(stp.ssh, stp.layer_thickness, stp.normal_velocity),
                          smp.struct_mesh, 5.0, 0.7) is None


# ---- physics (tests/test_tracers.py:53-110, 192-201) on the port's lattice ----

K = 2
PDT = 50.0


def _physics_state(channel: bool):
    """16 x 16 lattice of 2 levels (tests/test_tracers.py's fixtures): h the
    resting thickness plus 0.1 m noise, u of 0.1 m/s noise (0 on walls), T a
    wave in x, S = 35; (port model, mesh, lattice state)."""
    horz = mt.planar_hex_mesh(16, 16, 1000.0, f0=1e-4)
    keep = None
    if channel:
        y = np.asarray(horz.cells.y)
        keep = (y > y.min() + 1) & (y < y.max() - 1)
        mesh_h = mt.cull_cells(horz, keep)
    else:
        mesh_h = horz
    vert = mt.make_vertical_mesh(mesh_h, K)
    mesh = mt.Mesh(horz=mesh_h, vert=vert)
    rng = np.random.default_rng(5 if channel else 7)
    nc, ne = mesh_h.n_cells, mesh_h.n_edges
    h0 = np.asarray(vert.resting_thickness) + 0.1 * rng.standard_normal((nc, K))
    u0 = 0.1 * rng.standard_normal((ne, K)) * np.asarray(mesh_h.edges.edge_mask)[:, None]
    x = np.asarray(mesh_h.cells.x)
    tr = make_tracers(mesh, [10.0 + np.sin(2 * np.pi * x / (x.max() + 1)), 35.0 + 0.0 * x])
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy(h0.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=torch.from_numpy(h0), normal_velocity=torch.from_numpy(u0),
        tracers=tr)
    kw = dict(parent_horz=horz, keep_cells=keep) if channel else {}
    model = mt.StructuredModel(mesh, 16, 16, device="cpu", **kw)
    return model, mesh, model.to_struct(prog)


ROUTES = {
    "roll": lambda st, sm, dt, n, **kw: structured_auto_run_loop(st, sm, dt, n, **kw),
    "tiled": lambda st, sm, dt, n, **kw: tiled_run_loop(st, sm, dt, n, row_tile=4,
                                                        col_tile=8, q=1, **kw),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("channel", [False, True])
def test_uniform_tracer_stays_uniform(route, channel):
    """T = 35 is a fixed point for any flow (consistency with continuity),
    to rtol 1e-10 over 20 steps, FE and FB; on culled cells T is 0."""
    model, _, st = _physics_state(channel)
    for fb in (False, True):
        out = ROUTES[route](st, model.struct_mesh, PDT, 20, fb=fb, tracer_kappa=5.0)
        sal = model.from_struct(out).tracers[:, 1].numpy()
        np.testing.assert_allclose(sal, 35.0, rtol=1e-10)
        if channel:
            dead = model.cell_mask.numpy() == 0
            assert not out.tracers.numpy()[dead].any()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("channel", [False, True])
def test_total_content_is_conserved(route, channel):
    """sum_c A_c (h T)_c is conserved to rtol 1e-12: on the periodic lattice
    with upwind 1, centered and kappa 5; on the walled channel with kappa 5
    (no flux through walls)."""
    model, mesh, st = _physics_state(channel)
    p0 = model.from_struct(st)
    c0 = total_tracer_content(p0.tracers, p0.layer_thickness, mesh).numpy()
    cases = [dict(tracer_kappa=5.0)] if channel else [
        dict(), dict(tracer_upwind=0.0), dict(tracer_kappa=5.0), dict(fb=True, tracer_kappa=5.0)]
    for kw in cases:
        out = model.from_struct(ROUTES[route](st, model.struct_mesh, PDT, 10, **kw))
        c1 = total_tracer_content(out.tracers, out.layer_thickness, mesh).numpy()
        np.testing.assert_allclose(c1, c0, rtol=1e-12)


def test_upwind_is_monotone():
    """Donor-cell upwinding (upwind 1) creates no new extrema over 30 steps
    of 20 s while h stays positive; centered (upwind 0) does."""
    model, _, st = _physics_state(False)
    t0 = model.from_struct(st).tracers[:, 0].numpy()
    out = structured_auto_run_loop(st, model.struct_mesh, 20.0, 30, tracer_upwind=1.0)
    assert float(out.layer_thickness.min()) > 0.0
    t1 = model.from_struct(out).tracers[:, 0].numpy()
    assert t1.max() <= t0.max() + 1e-9 and t1.min() >= t0.min() - 1e-9
    centered = structured_auto_run_loop(st, model.struct_mesh, 20.0, 30, tracer_upwind=0.0)
    tc = model.from_struct(centered).tracers[:, 0].numpy()
    assert tc.max() > t0.max() + 1e-9 or tc.min() < t0.min() - 1e-9


def test_diffusion_dissipates_variance():
    """With kappa 200 and no flow, the tracer's variance decays while the
    h-weighted mean is conserved (tests/test_tracers.py:89)."""
    model, mesh, st = _physics_state(False)
    h_rest = torch.from_numpy(np.asarray(mesh.vert.resting_thickness))
    prog = model.from_struct(st)
    still = model.to_struct(mt.PrognosticVars(
        ssh=h_rest.sum(1) - torch.from_numpy(np.asarray(mesh.vert.resting_thickness_sum)),
        layer_thickness=h_rest, normal_velocity=torch.zeros_like(prog.normal_velocity),
        tracers=prog.tracers))
    out = model.from_struct(structured_auto_run_loop(still, model.struct_mesh, PDT, 100,
                                                     tracer_kappa=200.0))
    t0, t1 = prog.tracers[:, 0].numpy(), out.tracers[:, 0].numpy()
    assert t1.var() < 0.8 * t0.var()
    w = h_rest.numpy()
    np.testing.assert_allclose((w * t1).sum(), (w * t0).sum(), rtol=1e-12)


# ---- planners -----------------------------------------------------------

def test_planners_reckon_the_tracer_planes():
    """fe_step.smem_bytes and the tiled window add 2 nT planes of the level
    chunk per window copy; fe_tile sizes the tracer arm's tile by them (and
    the tracer-free tile is unchanged); resolve_plan sizes the tiled tile
    with them; a tracer count whose window fits no tile raises ValueError."""
    k, itemsize = 100, 4
    _, kc = fe_step.level_split(k)
    for tile in ((4, 16), (2, 8)):
        sites = (tile[0] + 2) * (tile[1] + 4)
        assert (fe_step.smem_bytes(tile, k, itemsize, n_tracers=2)
                - fe_step.smem_bytes(tile, k, itemsize)) == itemsize * sites * 4 * kc
    assert fe_step.fe_tile(32, 64, k, itemsize, 0) == fe_step.fe_tile(32, 64, k, itemsize)
    for n_tr in (1, 2, 4):
        tile = fe_step.fe_tile(32, 64, k, itemsize, n_tr)
        assert fe_step.smem_bytes(tile, k, itemsize, n_tracers=n_tr) <= fe_step.SMEM_BYTES
    with pytest.raises(ValueError):
        fe_step.fe_tile(32, 64, k, 8, 100)
    for q in (1, 2):
        sites = (4 + 2 * 2 * q) * (8 + 2 * 2 * q)
        copies = 2 if q > 1 else 1
        assert (window_bytes(4, 8, q, (2, 2), k, itemsize, n_tracers=3)
                - window_bytes(4, 8, q, (2, 2), k, itemsize)) == itemsize * sites * 6 * kc * copies
        assert (tiled_step.smem_bytes(sites, kc, q, itemsize, n_tracers=3)
                == window_bytes(4, 8, q, (2, 2), k, itemsize, n_tracers=3))
    two = functools.partial(window_bytes, n_tracers=2)
    rt, ct, q = resolve_plan(128, 256, k, itemsize, (2, 2), 10, q=1, window=two)
    assert two(rt, ct, 1, (2, 2), k, itemsize) <= tiled_step.SMEM_BYTES
    with pytest.raises(ValueError):
        resolve_plan(128, 256, k, 8, (2, 2), 10, q=1,
                     window=functools.partial(window_bytes, n_tracers=100))


# ---- the gradients ---------------------------------------------------------

TR_KW = dict(tracer_kappa=5.0, tracer_upwind=0.5)


def _autograd_vjp(run):
    """The VJP of a differentiable entry point ``run(state)`` for the output
    cotangent g: the gradient of <run(state), g> w.r.t. the state."""
    def vjp(st, g):
        x = [getattr(st, f).clone().requires_grad_(True) for f in FIELDS]
        out = run(StructState(*x))
        inner = sum((getattr(out, f) * getattr(g, f)).sum() for f in FIELDS)
        return StructState(*torch.autograd.grad(inner, x))
    return vjp


# name: (steps, the VJP of that many steps for (state, mesh, cotangent))
GRADIENTS = {
    "auto_rollout_diff": (3, lambda st, sm, g: _autograd_vjp(
        lambda s: auto_rollout_diff(s, sm, DT, 3, plan=2, **TR_KW))(st, g)),
    "fused_rollout_diff": (3, lambda st, sm, g: _autograd_vjp(
        lambda s: fused_rollout_diff(s, sm, DT, 3, **TR_KW))(st, g)),
    "tiled_rollout_diff": (2, lambda st, sm, g: _autograd_vjp(
        lambda s: tiled_rollout_diff(s, sm, DT, 2, plan=(4, 8, 1, 2), **TR_KW))(st, g)),
    "fused_step": (1, lambda st, sm, g: _autograd_vjp(
        lambda s: fused_step(s, sm, DT, **TR_KW))(st, g)),
    "fused_adjoint_rollout": (3, lambda st, sm, g: fused_adjoint_rollout(
        st, sm, DT, 3, g, **TR_KW)[0]),
    "tiled_adjoint_rollout": (2, lambda st, sm, g: tiled_adjoint_rollout(
        st, sm, DT, 2, g, plan=(4, 8, 1, 2), **TR_KW)[0]),
}


@pytest.mark.parametrize("entry", sorted(GRADIENTS))
def test_gradients_carry_tracers_as_jax_does(entry):
    """Every gradient entry point carries a state's tracers (kappa 5,
    upwind 0.5) and returns their cotangent: its VJP for a random output
    cotangent against jax.vjp of the JAX roll model over the same steps,
    each field (the tracers among them) within 1e-12 of its scale."""
    smj, smp, stj, stp, _, _ = tracer_lattice(16, 2)
    n, vjp = GRADIENTS[entry]
    rng = np.random.default_rng(31)
    g = {f: rng.normal(size=tuple(getattr(stp, f).shape)) for f in FIELDS}
    _, jvjp = jax.vjp(lambda s: jax_run_loop(s, smj.struct_mesh, DT, n, **TR_KW), stj)
    (ref,) = jvjp(stj.replace(**{f: jnp.asarray(v) for f, v in g.items()}))
    d = vjp(stp, smp.struct_mesh, struct_state_from_numpy(g))
    for f, e in _errs(d, ref).items():
        assert e <= 1e-12, (f, e)


def test_gradients_refuse_tracers_with_the_nonlinear_core_or_forcing_on_the_card(monkeypatch):
    """The reverse's steps build, on a CUDA device (their operands kept on
    the CPU here, torch_port_cases.stub_card), tracers with the nonlinear
    core, with forcing and with both, and a tracer state at q > 1 on the
    tiled route too (tiled_adjoint's tracer arm at q > 1), with forcing,
    and with the nonlinear core at q > 1 (the q-step nonlinear reverse's
    steps, no guard left); on the CPU
    the gradients run those combinations, here against jax.vjp of the JAX
    roll model within 1e-12 of scale."""
    from types import SimpleNamespace

    from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing
    from mpas_ocean_tpu_torch.structured import diff_model, tiled_diff

    stub_card(monkeypatch)
    smj, smp, stj, stp, mj, mp = tracer_lattice(16, 2)
    sm = smp.struct_mesh
    fp = smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING))
    like = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    for nonlinear, f in ((True, None), (False, fp), (True, fp)):
        steps = diff_model._Steps(sm, DT, like, nonlinear, forcing=f, tracers=True)
        assert steps.tracers and hasattr(steps, "nl_adj") == nonlinear
    for f in (None, fp):
        steps = tiled_diff._TiledSteps(sm, DT, like, (4, 8, 2, 1), forcing=f, tracers=True)
        assert steps.tracers and steps.q == 2
    steps = tiled_diff._TiledSteps(sm, DT, like, (4, 8, 2, 1), nonlinear=True, tracers=True)
    assert steps.tracers and steps.q == 2 and hasattr(steps, "nl_adj")
    assert not hasattr(tiled_diff, "_check_nl_q")
    fj = smj.to_struct_forcing(jax_make_forcing(mj, **FULL_FORCING))
    rng = np.random.default_rng(32)
    g = {f: rng.normal(size=tuple(getattr(stp, f).shape)) for f in FIELDS}
    for nonlinear, forced in ((True, False), (False, True)):
        _, jvjp = jax.vjp(lambda s: jax_run_loop(s, smj.struct_mesh, DT, 2, nonlinear,
                                                 fj if forced else None, **TR_KW), stj)
        (ref,) = jvjp(stj.replace(**{f: jnp.asarray(v) for f, v in g.items()}))
        d = fused_adjoint_rollout(stp, sm, DT, 2, struct_state_from_numpy(g),
                                  nonlinear=nonlinear, forcing=fp if forced else None,
                                  **TR_KW)[0]
        for f, e in _errs(d, ref).items():
            assert e <= 1e-12, (nonlinear, forced, f, e)


def test_card_refuses_tracers_with_the_nonlinear_core_or_forcing(monkeypatch):
    """The reverse kernels' tracer arms run with either core and with
    forcing now, so no guard is left: the gradient's steps build tracers
    with the nonlinear core, with forcing and with both, for a CUDA state
    (its operands kept on the CPU here, torch_port_cases.stub_card), their
    tracer operands on hand (the cell mask, kappa and upwind rounded to the
    state dtype), and for a CPU state, and so does the tiled route's at
    q > 1 (tiled_adjoint's tracer arm at q > 1), its nonlinear core at
    q > 1 too (the q-step nonlinear reverse's steps). (The kernels:
    tests/test_torch_composed_adjoint_kernel.py,
    tests/test_torch_window_adjoint_kernel.py,
    tests/test_torch_nl_window_adjoint_kernel.py.)"""
    from types import SimpleNamespace

    from mpas_ocean_tpu_torch.structured import diff_model, tiled_diff

    stub_card(monkeypatch)
    _, smp, _, stp, _, mp = tracer_lattice(16, 2)
    forcing = smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING))
    cuda = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    for nonlinear, f in ((True, None), (False, forcing), (True, forcing)):
        steps = diff_model._Steps(smp.struct_mesh, DT, cuda, nonlinear, forcing=f, tracers=True,
                                  tracer_kappa=5.0, tracer_upwind=0.5)
        kt = steps.kernel_tracers(torch.zeros(1))
        assert kt.cell_mask is None and (kt.kappa, kt.upwind) == (5.0, 0.5)
        assert (steps.kf is not None) == (f is not None)
        diff_model._Steps(smp.struct_mesh, DT, stp.layer_thickness, nonlinear, forcing=f,
                          tracers=True)
        for plan in ((4, 8, 1, 1), (4, 8, 2, 1)):
            steps = tiled_diff._TiledSteps(smp.struct_mesh, DT, cuda, plan, nonlinear,
                                           forcing=f, tracers=True, tracer_kappa=5.0,
                                           tracer_upwind=0.5)
            assert steps.tracers and steps.q == plan[2] and hasattr(steps, "nl_adj") == nonlinear
