"""Shared inputs for the port's tests on a CUDA card
(tests/test_torch_kernel.py, tests/test_torch_adjoint_kernel.py,
tests/test_torch_tiled_kernel.py, tests/test_torch_tiled_adjoint_kernel.py,
tests/test_torch_peaks.py, tests/test_torch_tracer_kernel.py,
tests/test_torch_strat_adjoint_kernel.py, tests/test_torch_window_kernel.py
and the others of the kernels' arms). They import no JAX, so they run on a
GPU machine without it."""

import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu_torch.tools.composed_reverse import (  # noqa: F401 (the GPU tests' helpers)
    COMPOSED_COMBOS,
    composed_ddt_scale,
    composed_errors,
    composed_reverse,
    composed_stack,
    composed_state,
    composed_steps,
    plain_composed_reverse,
    superstep_stack,
)

FIELDS = ("ssh", "layer_thickness", "normal_velocity")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_lattice(nx, ny, k, device, seed=7, dc=1000.0, dtype=np.float64, u_amp=0.01):
    """(StructuredModel, random lattice state) on ``device``, in ``dtype``
    (the random values are drawn in f64; u of standard deviation u_amp, at
    0.5 m/s the relative vorticity outweighs f and the nonlinear terms
    matter)."""
    horz = mt.planar_hex_mesh(nx, ny, dc, f0=1e-4, beta=1e-11, dtype=dtype)
    vert = mt.make_vertical_mesh(
        horz, k, resting_thickness=np.full((horz.n_cells, k), 10.0, dtype=dtype), dtype=dtype
    )
    rng = np.random.default_rng(seed)
    h = 10.0 + 0.01 * rng.normal(size=(horz.n_cells, k))
    u = u_amp * rng.normal(size=(horz.n_edges, k))
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy((h.sum(1) - vert.resting_thickness_sum).astype(dtype)),
        layer_thickness=torch.from_numpy(h.astype(dtype)),
        normal_velocity=torch.from_numpy(u.astype(dtype)),
    )
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), nx, ny, device=device)
    return model, model.to_struct(prog)


def channel_lattice(nx, ny, k, device, seed=7, dc=1000.0, dtype=np.float64, u_amp=0.01):
    """(StructuredModel, random lattice state) of a coastal channel on
    ``device``, in ``dtype``: the nx x ny periodic hex lattice with its first
    and last cell rows culled (bench.py's build_kelvin), so walls run north
    and south; random h and u on the live cells and edges, drawn in f64, u
    pinned to 0 on the wall edges by ``to_struct``."""
    horz = mt.planar_hex_mesh(nx, ny, dc, f0=1e-4, beta=1e-11, dtype=dtype)
    y = np.asarray(horz.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = mt.cull_cells(horz, keep)
    vert = mt.make_vertical_mesh(
        chan, k, resting_thickness=np.full((chan.n_cells, k), 10.0, dtype=dtype), dtype=dtype
    )
    rng = np.random.default_rng(seed)
    h = 10.0 + 0.01 * rng.normal(size=(chan.n_cells, k))
    u = u_amp * rng.normal(size=(chan.n_edges, k))
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy((h.sum(1) - vert.resting_thickness_sum).astype(dtype)),
        layer_thickness=torch.from_numpy(h.astype(dtype)),
        normal_velocity=torch.from_numpy(u.astype(dtype)),
    )
    model = mt.StructuredModel(mt.Mesh(horz=chan, vert=vert), nx, ny, device=device,
                               parent_horz=horz, keep_cells=keep)
    return model, model.to_struct(prog)


def assert_walls_closed(u, mesh):
    """u (3, 2, ny2, nx, K) is +0.0, bit for bit, on every edge the wall
    mask closes (wall edges and the culled cells' edges)."""
    closed = (mesh.edge_mask == 0)[..., None].expand_as(u)
    bits = u.masked_select(closed)
    assert bits.numel() > 0
    assert bool((bits == 0).all()) and not bool(torch.signbit(bits).any())


def reversed_terms_mesh(mesh):
    """``mesh`` with each output channel's Coriolis terms in reverse order:
    the same stencil summed in another order, whose packed tables no longer
    map as the hex lattice's (csrc/step_window.cuh, ``hex::``;
    csrc/adjoint_window.cuh, ``hex_adj::``), so the kernels refuse them."""
    d = mt.structured.struct_mesh_to_numpy(mesh)
    d["coriolis_terms"] = tuple(reversed(mesh.coriolis_terms))
    return mt.structured.struct_mesh_from_numpy(d).to(mesh.f_edge.device)


def wave_lattice(kind, n, k, device, dtype=np.float32):
    """(StructuredModel, lattice state) of bench.py's cases on ``device``:
    ``kind`` "igw", the inertial-gravity wave on the periodic n x n lattice
    over a 10000 km box (build()), or "kelvin", the Kelvin wave on that
    lattice with its first and last cell rows culled (build_kelvin); k
    levels of 1000 m / k, in ``dtype``."""
    dc = 10000.0e3 / n
    horz = mt.planar_hex_mesh(n, n, dc, f0=1e-4, dtype=dtype)
    mesh, kw = horz, {}
    if kind == "kelvin":
        y = np.asarray(horz.cells.y)
        keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
        mesh = mt.cull_cells(horz, keep)
        kw = {"parent_horz": horz, "keep_cells": keep}
        wave = mt.KelvinWave(lx=n * dc / 1e3)
    else:
        wave = mt.InertialGravityWave(lx=n * dc / 1e3)
    vert = mt.make_vertical_mesh(
        mesh, k, resting_thickness=np.full((mesh.n_cells, k), 1000.0 / k, dtype=dtype),
        dtype=dtype)
    arrays = wave.initial_state(mesh, k)
    model = mt.StructuredModel(mt.Mesh(horz=mesh, vert=vert), n, n, device=device, **kw)
    return model, model.to_struct(mt.PrognosticVars(*(torch.from_numpy(a.astype(dtype))
                                                       for a in arrays)))


def assert_nonlinear_f32(out, ref, ref64, mesh):
    """chip_smoke.py phase 12's f32 check after 100 steps (PERF.md section
    2): ssh and h within 1e-5 of scale of the plain f32 run ``ref``; u
    within 3e-4 of max|u| on a periodic lattice, and on a channel its
    distance from the f64 plain run ``ref64`` at most 3x the plain f32
    run's."""
    column = (ref.ssh + mesh.resting_thickness_sum).abs().max()
    for f in ("ssh", "layer_thickness"):
        a, b = getattr(out, f), getattr(ref, f)
        scale = column if f == "ssh" else b.abs().max()
        assert float((a - b).abs().max() / scale) <= 1e-5, f
    if mesh.edge_mask is None:
        u, v = out.normal_velocity, ref.normal_velocity
        assert float((u - v).abs().max() / v.abs().max()) <= 3e-4
    else:
        gap = lambda x: float((x.normal_velocity.double() - ref64.normal_velocity).abs().max())
        assert gap(out) <= 3 * gap(ref), (gap(out), gap(ref))
        assert_walls_closed(out.normal_velocity, mesh)


def assert_plan_f32(wrapper, fb, tile, ks, masked, device):
    """chip_smoke.py phase 12's check of a main path's own f32 plan (tile,
    slice ks) through its wrapper (``fe_step.fe_nl_rollout`` or
    ``tiled_step.tiled_nl_rollout``), 20 steps of dt = 10 s on a random
    32 x 32 x 100 f32 lattice (or channel) at 10 km spacing with u of 0.5
    m/s: ssh and h within 1e-5 of scale of the plain f32 steps, u no farther
    from an f64 plain run from the same values than 3x the plain f32 run,
    and the linear run 100x farther than that."""
    from mpas_ocean_tpu_torch.structured import StructState, fused_model, structured_run_loop

    lattice = channel_lattice if masked else random_lattice
    model, st = lattice(32, 32, 100, device, seed=5, dc=1e4, dtype=np.float32, u_amp=0.5)
    model64, _ = lattice(32, 32, 100, device, seed=5, dc=1e4, u_amp=0.5)
    sm, sm64 = model.struct_mesh, model64.struct_mesh
    st64 = StructState(*(x.double() for x in (st.ssh, st.layer_thickness, st.normal_velocity)))
    out = StructState(*wrapper(
        st.ssh, st.layer_thickness, st.normal_velocity, sm.resting_thickness_sum.contiguous(),
        *sm.host_stencil, fused_model.nl_setup(sm, torch.float32), sm.vertex_cell_terms,
        sm.edge_vertex_terms, *fused_model._scal(sm, 10.0, torch.float32),
        *fused_model.nl_scal(sm, torch.float32), 20, live=fused_model.kernel_live(sm),
        tile=tile, ks=ks))
    ref = structured_run_loop(st, sm, 10.0, 20, nonlinear=True, fb=fb)
    lin = structured_run_loop(st, sm, 10.0, 20, fb=fb)
    ref64 = structured_run_loop(st64, sm64, 10.0, 20, nonlinear=True, fb=fb)
    torch.cuda.synchronize()
    column = (ref.ssh + sm.resting_thickness_sum).abs().max()
    for f in ("ssh", "layer_thickness"):
        a, b = getattr(out, f), getattr(ref, f)
        scale = column if f == "ssh" else b.abs().max()
        assert float((a - b).abs().max() / scale) <= 1e-5, f
    gap = lambda x: float((x.normal_velocity.double() - ref64.normal_velocity).abs().max())
    assert gap(out) <= 3 * gap(ref), (gap(out), gap(ref))
    assert gap(lin) >= 100 * 3 * gap(ref), (gap(lin), gap(ref))
    if masked:
        assert_walls_closed(out.normal_velocity, sm)


# ---- the nonlinear reverse (tests/test_torch_adjoint_kernel.py,
# tests/test_torch_tiled_adjoint_kernel.py, chip_smoke.py phase 13) ---------

def nl_stack(st, mesh, dt, n):
    """A stack of n primal states of the nonlinear forward kernel from ``st``
    (slot j: j steps), filled by ``fe_step.fe_nl_fill_stack``."""
    from mpas_ocean_tpu_torch.kernels import fe_step
    from mpas_ocean_tpu_torch.structured import fused_model

    dtype = st.layer_thickness.dtype
    stack = tuple(torch.empty((n, *getattr(st, f).shape), dtype=dtype, device=st.ssh.device)
                  for f in FIELDS)
    for dst, f in zip(stack, FIELDS):
        dst[0].copy_(getattr(st, f))
    fe_step.fe_nl_fill_stack(stack, mesh.resting_thickness_sum.to(dtype).contiguous(),
                             *mesh.host_stencil, fused_model.nl_setup(mesh, dtype),
                             mesh.vertex_cell_terms, mesh.edge_vertex_terms,
                             *fused_model._scal(mesh, dt, dtype),
                             *fused_model.nl_scal(mesh, dtype), n - 1,
                             live=fused_model.kernel_live(mesh))
    return stack


def nl_reverse(stack, g, mesh, dt, n, tile=None, ks=None):
    """n reverse steps of the nonlinear reverse kernel through the stack's
    slots n - 1 .. 0 from the cotangent g: (cotangent, d(dt) (1,) f64)."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step
    from mpas_ocean_tpu_torch.structured import StructState, fused_model

    dtype = stack[1].dtype
    ddt = torch.zeros(1, dtype=torch.float64, device=stack[1].device)
    out = adjoint_step.nl_adjoint_rollout(
        stack, tuple(getattr(g, f).to(dtype).contiguous() for f in FIELDS),
        fused_model.nl_setup(mesh, dtype), *mesh.host_stencil, *mesh.host_adjoint_stencil,
        mesh.vertex_cell_terms, mesh.edge_vertex_terms, *fused_model._scal(mesh, dt, dtype),
        *fused_model.nl_scal(mesh, dtype), *fused_model.nl_adjoint_scal(mesh, dt, dtype), n, ddt,
        live=fused_model.kernel_live(mesh),
        tile=tile, ks=ks)
    return StructState(*out), ddt


def linear_reverse(stack, g, mesh, dt, n):
    """The linear reverse kernel (adjoint_step) through the same slots: the
    control that must miss the nonlinear reverse's limits."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step
    from mpas_ocean_tpu_torch.structured import StructState, fused_model

    dtype = stack[1].dtype
    ddt = torch.zeros(1, dtype=torch.float64, device=stack[1].device)
    out = adjoint_step.adjoint_rollout(
        stack, tuple(getattr(g, f).to(dtype).contiguous() for f in FIELDS),
        mesh.f_edge.to(dtype).contiguous(), *mesh.host_adjoint_stencil,
        *fused_model._scal(mesh, dt, dtype), n, ddt, live=fused_model.kernel_live(mesh))
    return StructState(*out), ddt


def plain_nl_reverse(stack, g, mesh, dt, n, dtype=None):
    """The plain nonlinear reverse step (structured_nl_adjoint_step) back
    through the stack's slots n - 1 .. 0 from g, in ``dtype`` (the slots and
    g cast to it; ``mesh`` in it), by default the stack's: (cotangent, d(dt)
    as a 0-d f64 tensor)."""
    from mpas_ocean_tpu_torch.structured import StructState, structured_nl_adjoint_step

    dtype = stack[1].dtype if dtype is None else dtype
    cast = lambda x: x.to(dtype)  # noqa: E731
    ddt = torch.zeros((), dtype=torch.float64, device=stack[1].device)
    g = StructState(*(cast(getattr(g, f)) for f in FIELDS))
    for j in reversed(range(n)):
        g, dd = structured_nl_adjoint_step(StructState(*(cast(x[j]) for x in stack)), g,
                                           mesh, dt)
        ddt = ddt + dd.double()
    return g, ddt


def reverse_gaps(runs: dict, ref64, ref64_dt) -> dict:
    """{run: {field or "d_dt": max |x - ref64|}} for runs = {name: (state,
    d(dt))}."""
    out = {}
    for name, (x, dd) in runs.items():
        out[name] = {f: float((getattr(x, f).double() - getattr(ref64, f)).abs().max())
                     for f in FIELDS}
        out[name]["d_dt"] = abs(float(dd) - float(ref64_dt))
    return out


def assert_nl_reverse_f32(gaps: dict, factor: float = 3.0) -> None:
    """chip_smoke.py phase 13's f32 rule (PERF.md section 2): each
    cotangent's distance from an f64 reverse taken from the same f32 values
    (d_ssh, d_h, d_u, d(dt)) at most ``factor`` times the plain f32
    reverse's, and the linear reverse at least 100 times that limit in the
    cotangent it misses most."""
    for key, plain in gaps["plain"].items():
        assert gaps["kernel"][key] <= factor * plain, (key, gaps["kernel"][key], plain)
    assert max(gaps["linear"][k] / (factor * v) for k, v in gaps["plain"].items()) >= 100, gaps


# ---- momentum forcing: the forced arms of the four linear kernels
# (tests/test_torch_kernel.py, tests/test_torch_tiled_kernel.py,
# tests/test_torch_adjoint_kernel.py, tests/test_torch_tiled_adjoint_kernel.py,
# chip_smoke.py phase 14) -----------------------------------------------------

def forward_errors(out, ref, mesh) -> dict:
    """{field: max |out - ref| / scale}: ssh against the column thickness
    sum_k h (a small difference of large sums), h and u against their own
    magnitude."""
    column = (ref.ssh + mesh.resting_thickness_sum).abs().max()
    return {f: float((getattr(out, f) - getattr(ref, f)).abs().max()
                     / (column if f == "ssh" else getattr(ref, f).abs().max()))
            for f in FIELDS}


def random_forcing(model, seed=11, wind=1e-4, coefs=(1e-3, 2.5e-3, 1e-4)):
    """A lattice Forcing on the model's device, in its dtype: random winds
    (std ``wind`` m^2/s^2, the kinematic stress of ~0.1 Pa), (r_lin, Cd,
    lambda) = ``coefs``, all non-zero, and random top and bottom levels per
    edge in -1 .. K - 1 (-1: no active level; also on a channel's closed
    edges, whose wind is 0)."""
    from mpas_ocean_tpu_torch.models.forcing import Forcing

    sm = model.struct_mesh
    rng = np.random.default_rng(seed)
    shape, k = tuple(sm.f_edge.shape), sm.n_vert_levels
    dtype, device = sm.f_edge.dtype, sm.f_edge.device
    w = wind * rng.normal(size=shape)
    top, bot = (rng.integers(-1, k, size=shape) for _ in range(2))
    if sm.edge_mask is not None:
        closed = sm.edge_mask.cpu().numpy() == 0
        w[closed], top[closed], bot[closed] = 0.0, -1, -1
    onehot = lambda i: (np.arange(k) == i[..., None]).astype(np.float64)  # noqa: E731
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype=dtype, device=device)  # noqa: E731
    return Forcing(t(w), t(onehot(top)), t(onehot(bot)), *(t(c) for c in coefs))


def forced_stack(st, mesh, dt, n, forcing):
    """A stack of n primal states of the forced forward kernel from ``st``
    (slot j: j steps), filled by ``fe_step.fe_fill_stack``'s forced arm."""
    from mpas_ocean_tpu_torch.kernels import fe_step
    from mpas_ocean_tpu_torch.structured import fused_model

    dtype = st.layer_thickness.dtype
    stack = tuple(torch.empty((n, *getattr(st, f).shape), dtype=dtype, device=st.ssh.device)
                  for f in FIELDS)
    for dst, f in zip(stack, FIELDS):
        dst[0].copy_(getattr(st, f))
    fe_step.fe_fill_stack(stack, mesh.f_edge.to(dtype).contiguous(),
                          mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil,
                          *fused_model._scal(mesh, dt, dtype), n - 1,
                          live=fused_model.kernel_live(mesh),
                          forcing=fused_model.kernel_forcing(forcing, mesh, dtype, st.ssh.device))
    return stack


def forced_reverse(stack, g, mesh, dt, n, forcing, plan=None):
    """n reverse steps of the forced arm of adjoint_step (``plan`` None) or
    of tiled_adjoint (``plan`` = (row_tile, col_tile, q): n supersteps of q
    steps, slot j the start of superstep j) through the stack from g, with
    ``forcing`` None the unforced arm: (cotangent, d(dt), d(wind) (3, 2,
    ny2, nx), d(r_lin, Cd, lambda)) as f64 tensors."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import StructState, fused_model
    from mpas_ocean_tpu_torch.structured.adjoint import ForcingCot
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo

    dtype, device = stack[1].dtype, stack[1].device
    ddt = torch.zeros(1, dtype=torch.float64, device=device)
    kf = fused_model.kernel_forcing(forcing, mesh, dtype, device)
    dforc = None if forcing is None else ForcingCot(
        torch.zeros((6, mesh.ny2, mesh.nx), dtype=dtype, device=device),
        torch.zeros(3, dtype=torch.float64, device=device))
    g = tuple(getattr(g, f).to(dtype).contiguous() for f in FIELDS)
    scal, live = fused_model._scal(mesh, dt, dtype), fused_model.kernel_live(mesh)
    f_edge = mesh.f_edge.to(dtype).contiguous()
    if plan is None:
        out = adjoint_step.adjoint_rollout(stack, g, f_edge, *mesh.host_adjoint_stencil, *scal,
                                           n, ddt, live=live, forcing=kf, dforc=dforc)
    else:
        out = tiled_adjoint.tiled_adjoint_rollout(
            stack, g, f_edge, mesh.resting_thickness_sum.to(dtype).contiguous(),
            *mesh.host_stencil, *mesh.host_adjoint_stencil, *scal, n, ddt,
            row_tile=plan[0], col_tile=plan[1], q=plan[2],
            halo=reverse_halo(mesh.coriolis_terms), live=live, forcing=kf, dforc=dforc)
    zero = torch.zeros((3, 2, mesh.ny2, mesh.nx), dtype=torch.float64, device=device)
    dw, dc = (zero, torch.zeros(3, dtype=torch.float64, device=device)) if dforc is None else (
        dforc.wind.double().reshape(zero.shape), dforc.coefs)
    return StructState(*(x.double() for x in out)), ddt[0], dw, dc


def plain_forced_reverse(stack, g, mesh, dt, n, forcing, plan=None):
    """The plain forced reverse back through the stack's slots n - 1 .. 0
    from g, in the stack's dtype: the hand-written ``structured_adjoint_step``
    with forcing (``plan`` None), or the tiled kernel's plain version
    ``plain_tiled_adjoint_superstep`` with forcing (``plan`` = (row_tile,
    col_tile, q), slot j the start of superstep j): (cotangent, d(dt),
    d(wind), d(r_lin, Cd, lambda)) as f64 tensors."""
    from mpas_ocean_tpu_torch.structured import (
        StructState,
        plain_tiled_adjoint_superstep,
        structured_adjoint_step,
    )

    dtype = stack[1].dtype
    g = StructState(*(getattr(g, f).to(dtype) for f in FIELDS))
    ddt = torch.zeros((), dtype=torch.float64, device=stack[1].device)
    dw = torch.zeros_like(forcing.wind_edge, dtype=torch.float64)
    dc = torch.zeros(3, dtype=torch.float64, device=stack[1].device)
    for j in reversed(range(n)):
        s = StructState(*(x[j] for x in stack))
        if plan is None:
            g, dd, d = structured_adjoint_step(s, g, mesh, dt, forcing)
        else:
            g, dd, d = plain_tiled_adjoint_superstep(s, g, mesh, dt, *plan, forcing=forcing)
        ddt, dw, dc = ddt + dd.double(), dw + d.wind.double(), dc + d.coefs.double()
    return StructState(*(x.double() for x in (g.ssh, g.layer_thickness, g.normal_velocity))), \
        ddt, dw, dc


def forced_reverse_errors(a, b) -> dict:
    """{name: max |a - b| / max |b|} over the four parts of two forced
    reverses (``forced_reverse``' tuples): d_ssh, d_h, d_u, d(dt), d(wind)
    and each coefficient's cotangent."""
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max())  # noqa: E731
    out = {f: rel(getattr(a[0], f), getattr(b[0], f)) for f in FIELDS}
    out["d_dt"] = rel(a[1], b[1])
    out["d_wind"] = rel(a[2], b[2])
    for i, name in enumerate(("d_r_lin", "d_cd", "d_lambda")):
        out[name] = rel(a[3][i], b[3][i])
    return out


# ---- tracers (tests/test_torch_tracer_kernel.py) ---------------------------

TRACER_FIELDS = FIELDS + ("tracers",)


def with_tracers(model, st, n_tracers=2, seed=3):
    """``st`` with ``n_tracers`` random tracers made on the host from a numpy
    seed (a wave in x plus noise per level for the first, 35 plus noise for
    the others), 0 on a channel's culled cells, in the state's dtype and on
    its device."""
    from mpas_ocean_tpu_torch.structured import StructState

    ny2, nx, k = st.layer_thickness.shape[1:]
    rng = np.random.default_rng(seed)
    x = np.arange(nx)[None, None, :, None] / nx
    tr = np.stack([(10.0 + 2.0 * np.sin(2 * np.pi * x) if t == 0 else 35.0)
                   + 0.3 * rng.normal(size=(2, ny2, nx, k)) for t in range(n_tracers)], axis=3)
    if model.cell_mask is not None:
        tr = tr * model.cell_mask.cpu().numpy()[..., None, None]
    tr = torch.from_numpy(tr).to(dtype=st.layer_thickness.dtype, device=st.layer_thickness.device)
    return StructState(st.ssh, st.layer_thickness, st.normal_velocity, tr)


def tracer_errors(out, ref, mesh) -> dict:
    """``forward_errors`` of the state's fields and, for the tracers, max
    |a - b| over max |b| (the tracer's scale)."""
    errs = forward_errors(out, ref, mesh)
    errs["tracers"] = float((out.tracers - ref.tracers).abs().max() / ref.tracers.abs().max())
    return errs


# ---- the tracer reverse (tests/test_torch_tracer_adjoint_kernel.py) -------

def tracer_stack(st, mesh, dt, n, kappa, upwind):
    """n + 1 primal states of ``st`` (with tracers) by fe_fill_stack's tracer
    arm, slot j after j steps: (the (ssh, h, u) stack of slots 0 .. n - 1,
    the kernels' tracer operands whose planes are those slots' tracer stack
    (n, 2 nT, ny2, nx, K), end = (h, tracer planes) of slot n)."""
    from mpas_ocean_tpu_torch.kernels import fe_step
    from mpas_ocean_tpu_torch.structured import fused_model

    dtype = st.layer_thickness.dtype
    kt = fused_model.kernel_tracers(st, mesh, kappa, upwind)
    full = tuple(torch.empty((n + 1, *getattr(st, f).shape), dtype=dtype, device=st.ssh.device)
                 for f in FIELDS)
    trs = torch.empty((n + 1, *kt.planes.shape), dtype=dtype, device=st.ssh.device)
    for dst, f in zip(full, FIELDS):
        dst[0].copy_(getattr(st, f))
    trs[0].copy_(kt.planes)
    fe_step.fe_fill_stack(full, mesh.f_edge.to(dtype).contiguous(),
                          mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil,
                          *fused_model._scal(mesh, dt, dtype), n,
                          live=fused_model.kernel_live(mesh), tracers=kt._replace(planes=trs))
    return tuple(x[:n] for x in full), kt._replace(planes=trs[:n]), (full[1][n], trs[n])


def tracer_reverse(stack, kt, end, g, mesh, dt, n, tile=None, tracers=True, q=1):
    """n reverse steps through the stack (``tracer_stack``'s) from the
    cotangent g (its tracers in the lattice layout): adjoint_step's tracer
    arm for ``tile`` None, tiled_adjoint's over ``tile`` = (rows, columns)
    otherwise, n supersteps of q steps (the stack's slots the supersteps'
    starts); with ``tracers`` False the tracer-free arm on the same primal
    states and g's ssh, h and u. Returns (cotangent, d(dt)) as f64, the
    cotangent's tracers in the lattice layout."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import StructState, fused_model
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo

    dtype, device = stack[1].dtype, stack[1].device
    ddt = torch.zeros(1, dtype=torch.float64, device=device)
    gk = tuple(getattr(g, f).to(dtype).contiguous() for f in FIELDS)
    kw = dict(live=fused_model.kernel_live(mesh))
    if tracers:
        gk += (fused_model.tracer_planes(g.tracers.to(dtype)),)
        kw.update(tracers=kt, end=end)
    scal = fused_model._scal(mesh, dt, dtype)
    f_edge = mesh.f_edge.to(dtype).contiguous()
    if tile is None:
        out = adjoint_step.adjoint_rollout(stack, gk, f_edge, *mesh.host_adjoint_stencil, *scal,
                                           n, ddt, **kw)
    else:
        out = tiled_adjoint.tiled_adjoint_rollout(
            stack, gk, f_edge, mesh.resting_thickness_sum.to(dtype).contiguous(),
            *mesh.host_stencil, *mesh.host_adjoint_stencil, *scal, n, ddt, row_tile=tile[0],
            col_tile=tile[1], q=q, halo=reverse_halo(mesh.coriolis_terms), **kw)
    tr = fused_model.tracer_unplanes(out[3]).double() if tracers else None
    return StructState(*(x.double() for x in out[:3]), tr), ddt[0]


def plain_tracer_reverse(stack, kt, end, g, mesh, dt, n, dtype=None):
    """The plain tracer reverse (``structured_adjoint_step`` with tracers,
    kappa and upwind as the kernels take them, h' and T' read from the next
    slot or from ``end`` = (h, tracer planes), as the kernels read them)
    back through the stack's slots n - 1 .. 0 from g, in ``dtype`` (the
    stack's by default): (cotangent, d(dt)) as f64, the tracers in the
    lattice layout."""
    from mpas_ocean_tpu_torch.structured import StructState, fused_model, structured_adjoint_step

    dtype = dtype or stack[1].dtype
    cast = lambda s: StructState(*(getattr(s, f).to(dtype) for f in TRACER_FIELDS))  # noqa: E731
    g = cast(g)
    ddt = torch.zeros((), dtype=torch.float64, device=stack[1].device)
    for j in reversed(range(n)):
        s = StructState(*(x[j] for x in stack), fused_model.tracer_unplanes(kt.planes[j]))
        h_next, tr_next = (stack[1][j + 1], kt.planes[j + 1]) if j + 1 < n else end
        nxt = StructState(s.ssh, h_next, s.normal_velocity, fused_model.tracer_unplanes(tr_next))
        g, dd = structured_adjoint_step(cast(s), g, mesh, dt, tracer_kappa=kt.kappa,
                                        tracer_upwind=kt.upwind, next_state=cast(nxt))
        ddt = ddt + dd.double()
    return StructState(*(getattr(g, f).double() for f in TRACER_FIELDS)), ddt


def reverse_errors(a, b, ddt_scale=None) -> dict:
    """{field: max |a - b| / max |b|} of two (cotangent, d(dt)) pairs, over
    the fields b has, and d(dt)'s error over ``ddt_scale`` (|b's d(dt)| by
    default)."""
    out = {f: float((getattr(a[0], f) - getattr(b[0], f)).abs().max()
                    / getattr(b[0], f).abs().max())
           for f in TRACER_FIELDS if getattr(a[0], f) is not None and getattr(b[0], f) is not None}
    out["d_dt"] = abs(float(a[1]) - float(b[1])) / (ddt_scale or abs(float(b[1])))
    return out


def ddt_scale(st, mesh, dt, n, g, **kw) -> float:
    """The scale of d(dt) = <g, d(state_n)/d(dt)> after n steps from ``st``
    (kw the tracers' options): sum over the fields of |g| |d(state_n)/d(dt)|,
    the Cauchy-Schwarz bound of a sum whose terms may cancel, the tangent by
    forward-mode AD of the plain rollout."""
    from mpas_ocean_tpu_torch.structured import structured_run_loop

    def rollout(d):
        out = structured_run_loop(st, mesh, d, n, **kw)
        return tuple(getattr(out, f) for f in TRACER_FIELDS)

    one = torch.ones((), dtype=st.ssh.dtype, device=st.ssh.device)
    _, tang = torch.func.jvp(rollout, (dt * one,), (one,))
    return sum(float(torch.linalg.vector_norm(getattr(g, f).double())
                     * torch.linalg.vector_norm(t.double())) for f, t in zip(TRACER_FIELDS, tang))


# ---- layered stratification (tests/test_torch_strat_kernel.py) -------------

def stratification(k, kind="rho", dtype=np.float64, seed=13):
    """A Stratification of k layers: ``kind`` "rho", make_stratification's W
    of densities 1025 + linspace(0, 2, k) (bench.py's column spans 1 kg/m^3
    over 100 layers); "dense", a dense random W of standard deviation 0.05
    (the stratified arms take any W)."""
    if kind == "rho":
        return mt.make_stratification(1025.0 + np.linspace(0.0, 2.0, k), dtype=dtype)
    w = 0.05 * np.random.default_rng(seed).normal(size=(k, k))
    return mt.models.stratification_from_numpy(
        {"phi_weights": w.astype(dtype), "densities": np.full(k, 1025.0, dtype=dtype)})


# ---- the stratified reverse (tests/test_torch_strat_adjoint_kernel.py) -----

def strat_stack(st, mesh, dt, n, strat):
    """n + 1 primal states of ``st`` by fe_fill_stack's stratified arm, slot
    j after j steps: (the (ssh, h, u) stack of slots 0 .. n - 1, W as the
    kernels take it (``fused_model.kernel_strat``), the state of slot n)."""
    from mpas_ocean_tpu_torch.kernels import fe_step
    from mpas_ocean_tpu_torch.structured import fused_model

    dtype, device = st.layer_thickness.dtype, st.ssh.device
    w = fused_model.kernel_strat(strat, dtype, device)
    full = tuple(torch.empty((n + 1, *getattr(st, f).shape), dtype=dtype, device=device)
                 for f in FIELDS)
    for dst, f in zip(full, FIELDS):
        dst[0].copy_(getattr(st, f))
    fe_step.fe_fill_stack(full, mesh.f_edge.to(dtype).contiguous(),
                          mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil,
                          *fused_model._scal(mesh, dt, dtype), n,
                          live=fused_model.kernel_live(mesh), strat_w=w)
    return tuple(x[:n] for x in full), w, tuple(x[n] for x in full)


def strat_reverse(stack, w, g, mesh, dt, n, tile=None, strat=True, q=1):
    """n reverse steps through the stack (``strat_stack``'s) from the
    cotangent g (ssh, h, u): adjoint_step's stratified arm for ``tile`` None,
    tiled_adjoint's over ``tile`` = (rows, columns) otherwise, n supersteps
    of q steps (the stack's slots the supersteps' starts); with ``strat``
    False the unstratified arm on the same states. Returns (cotangent,
    d(dt), d(W) or None) as f64."""
    from mpas_ocean_tpu_torch.kernels import adjoint_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import StructState, fused_model
    from mpas_ocean_tpu_torch.structured.tiled_diff import reverse_halo

    dtype, device = stack[1].dtype, stack[1].device
    k = stack[1].shape[-1]
    ddt = torch.zeros(1, dtype=torch.float64, device=device)
    dw = torch.zeros((k, k), dtype=torch.float64, device=device) if strat else None
    gk = tuple(getattr(g, f).to(dtype).contiguous() for f in FIELDS)
    kw = dict(live=fused_model.kernel_live(mesh), strat_w=w if strat else None, dstrat=dw)
    scal = fused_model._scal(mesh, dt, dtype)
    f_edge = mesh.f_edge.to(dtype).contiguous()
    if tile is None:
        out = adjoint_step.adjoint_rollout(stack, gk, f_edge, *mesh.host_adjoint_stencil, *scal,
                                           n, ddt, **kw)
    else:
        out = tiled_adjoint.tiled_adjoint_rollout(
            stack, gk, f_edge, mesh.resting_thickness_sum.to(dtype).contiguous(),
            *mesh.host_stencil, *mesh.host_adjoint_stencil, *scal, n, ddt, row_tile=tile[0],
            col_tile=tile[1], q=q, halo=reverse_halo(mesh.coriolis_terms), **kw)
    return StructState(*(x.double() for x in out[:3])), ddt[0], dw


def plain_strat_reverse(stack, w, g, mesh, dt, n, dtype=None, store=None):
    """The plain stratified reverse (``structured_adjoint_step(strat=)``, W
    as the kernels take it) back through the stack's slots n - 1 .. 0 from
    g, in ``dtype`` (the stack's by default), each step's cotangent passed
    through ``store`` (the bf16 control): ((cotangent, d(dt), d(W)) as f64,
    d(W)'s Cauchy-Schwarz scale max over (l, k) of sum over the steps and
    cells of |h[c, l]| |dPhi[c, k]|, a sum whose terms cancel, and the float
    accumulator control: d(W) with each step's sum over the cells in
    ``dtype`` where the plain reverse sums it in double)."""
    from mpas_ocean_tpu_torch.models import Stratification
    from mpas_ocean_tpu_torch.structured import StructState, pressure_transpose
    from mpas_ocean_tpu_torch.structured import structured_adjoint_step

    dtype = dtype or stack[1].dtype
    k = stack[1].shape[-1]
    strat = Stratification(w.to(dtype), torch.zeros(k, dtype=dtype, device=w.device))
    eye = {t: Stratification(torch.eye(k, dtype=t, device=w.device), strat.densities)
           for t in (torch.float64, dtype)}
    g = StructState(*(getattr(g, f).to(dtype) for f in FIELDS))
    ddt = torch.zeros((), dtype=torch.float64, device=w.device)
    dw, dw_float, w_scale = (torch.zeros((k, k), dtype=torch.float64, device=w.device)
                             for _ in range(3))
    for j in reversed(range(n)):
        s = StructState(*(x[j].to(dtype) for x in stack))
        gu = g.normal_velocity
        if mesh.edge_mask is not None:
            gu = gu * mesh.edge_mask[..., None].to(dtype)
        h = s.layer_thickness.reshape(-1, k)
        d_phi, _ = pressure_transpose(s.layer_thickness.double(), gu.double(), dt, mesh,
                                      eye[torch.float64])
        w_scale += h.double().abs().T @ d_phi.abs().reshape(-1, k)
        d_phi, _ = pressure_transpose(s.layer_thickness, gu, dt, mesh, eye[dtype])
        dw_float += (h.T @ d_phi.reshape(-1, k)).double()
        g, dd, d = structured_adjoint_step(s, g, mesh, dt, strat=strat)
        if store is not None:
            g = StructState(*(store(getattr(g, f)) for f in FIELDS))
        ddt, dw = ddt + dd.double(), dw + d.double()
    return ((StructState(*(getattr(g, f).double() for f in FIELDS)), ddt, dw),
            float(w_scale.max()), dw_float)


def integer_strat_case(n, k, device, seed=31):
    """One f32 reverse step whose d(W) sums are exact in double: the
    periodic n x n lattice at 1024 m spacing, h = 2^20 + integers 0 .. 1023,
    u and ssh 0, the cotangent of u integers -7 .. 7 (the others 0); with
    dt = 1 s every product h dPhi and every sum of them in double is exact,
    and the same sums in float are not. Returns (StructMesh, the one-slot
    (ssh, h, u) stack, the cotangent)."""
    from mpas_ocean_tpu_torch.structured import StructState

    horz = mt.planar_hex_mesh(n, n, 1024.0, f0=1e-4, dtype=np.float32)
    vert = mt.make_vertical_mesh(horz, k, resting_thickness=np.full(
        (horz.n_cells, k), 2.0 ** 20, dtype=np.float32), dtype=np.float32)
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), n, n, device=device)
    rng = np.random.default_rng(seed)
    h = (2.0 ** 20 + rng.integers(0, 1024, size=(horz.n_cells, k))).astype(np.float32)
    st = model.to_struct(mt.PrognosticVars(
        ssh=torch.zeros(horz.n_cells), layer_thickness=torch.from_numpy(h),
        normal_velocity=torch.zeros(horz.n_edges, k)))
    gu = rng.integers(-7, 8, size=tuple(st.normal_velocity.shape)).astype(np.float32)
    g = StructState(torch.zeros_like(st.ssh), torch.zeros_like(st.layer_thickness),
                    torch.from_numpy(gu).to(st.normal_velocity))
    return model.struct_mesh, tuple(getattr(st, f)[None].contiguous() for f in FIELDS), g


def strat_ddt_scale(st, mesh, dt, n, g, strat) -> float:
    """The Cauchy-Schwarz scale of d(dt) = <g, d(state_n)/d(dt)> after n
    stratified steps from ``st``: sum over the fields of |g| |d(state_n)/d(dt)|,
    the tangent by forward-mode AD of the plain rollout."""
    from mpas_ocean_tpu_torch.structured import structured_run_loop

    def rollout(d):
        out = structured_run_loop(st, mesh, d, n, strat=strat)
        return tuple(getattr(out, f) for f in FIELDS)

    one = torch.ones((), dtype=st.ssh.dtype, device=st.ssh.device)
    _, tang = torch.func.jvp(rollout, (dt * one,), (one,))
    return sum(float(torch.linalg.vector_norm(getattr(g, f).double())
                     * torch.linalg.vector_norm(t.double())) for f, t in zip(FIELDS, tang))


def strat_reverse_errors(a, b, ddt_scale, w_scale) -> dict:
    """{cotangent: (max |a - b|, over its scale)} of two (cotangent, d(dt),
    d(W)) results: the fields' scale max |b|, d(dt)'s and d(W)'s the
    Cauchy-Schwarz scales given."""
    out = {}
    for f in FIELDS:
        e = float((getattr(a[0], f) - getattr(b[0], f)).abs().max())
        out[f] = (e, e / float(getattr(b[0], f).abs().max()))
    e = abs(float(a[1]) - float(b[1]))
    out["d_dt"] = (e, e / ddt_scale)
    e = float((a[2] - b[2]).abs().max())
    out["d_w"] = (e, e / w_scale)
    return out


# ---- the composed reverse (tests/test_torch_composed_adjoint_kernel.py; the
# runs and errors in mpas_ocean_tpu_torch/tools/composed_reverse.py) --------

def composed_case(opts, n, k, channel, device, dtype=np.float64, seed=7, ny=None):
    """(model, state, forcing, stratification) of a combination ``opts`` (a
    string of N, F, T, S) on a random n x n (n x ``ny``) lattice of k 10 m
    layers,
    periodic or the channel: u of 0.5 m/s with N (so that the nonlinear
    terms matter), 0.01 m/s without; two random tracers with T
    (``with_tracers``), random winds, levels and coefficients with F
    (``random_forcing``), a dense random W with S; None for an option off."""
    model, st = (channel_lattice if channel else random_lattice)(
        n, ny or n, k, device, seed=seed, dc=1e4, dtype=dtype,
        u_amp=0.5 if "N" in opts else 0.01)
    if "T" in opts:
        st = with_tracers(model, st)
    forcing = random_forcing(model) if "F" in opts else None
    strat = stratification(k, "dense", dtype) if "S" in opts else None
    return model, st, forcing, strat


# ---- q > 1 (tests/test_torch_window_kernel.py,
# tests/test_torch_window_adjoint_kernel.py) ---------------------------------

# the forward windows' lattice: nx x ny = 32 x 40 (20 x 32 sites a parity),
# room for the FB q = 3 window (rows tile + 18) and the FE q = 3 one
# (columns tile + 24)
WINDOW_NX, WINDOW_NY = 32, 40
WINDOW_KAPPA, WINDOW_UPWIND = 5.0, 0.5


def window_kw(opts, forcing, strat) -> dict:
    """The forward entry points' keywords of a combination ``opts`` (F, T,
    S; the state carries its tracers where T is on): the forcing, W, and
    the tracers' kappa 5 and upwind 0.5."""
    return dict(forcing=forcing if "F" in opts else None, strat=strat if "S" in opts else None,
                tracer_kappa=WINDOW_KAPPA, tracer_upwind=WINDOW_UPWIND)


def window_errors(out, ref, mesh) -> dict:
    """``forward_errors``, and ``tracer_errors``' tracers where both have
    them."""
    if out.tracers is not None and ref.tracers is not None:
        return tracer_errors(out, ref, mesh)
    return forward_errors(out, ref, mesh)
