"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py):
the same lattice built by both packages, and random states made from a
numpy seed, handed to each package as numpy arrays."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import mpas_ocean_tpu as mo
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.mesh.cull import cull_cells as jax_cull_cells
from mpas_ocean_tpu.mesh.vert_mesh import make_vertical_mesh as jax_make_vertical_mesh
from mpas_ocean_tpu.structured.model import StructuredModel as JaxStructuredModel

STATE_FIELDS = ("ssh", "layer_thickness", "normal_velocity")
STRUCT_MESH_FIELDS = (
    "nx", "ny2", "n_vert_levels", "coriolis_terms",
    "dc", "dv", "area_cell", "f_edge", "resting_thickness_sum",
)


def both_meshes(nx, ny, k, dc=1000.0, f0=1e-4, beta=1e-11, thickness=10.0):
    """(JAX Mesh, port Mesh) of one periodic hex lattice with k levels."""
    rt = np.full((nx * ny, k), thickness)
    hj = mo.planar_hex_mesh(nx, ny, dc, f0=f0, beta=beta)
    hp = mt.planar_hex_mesh(nx, ny, dc, f0=f0, beta=beta)
    return (
        mo.Mesh(horz=hj, vert=jax_make_vertical_mesh(hj, k, resting_thickness=rt)),
        mt.Mesh(horz=hp, vert=mt.make_vertical_mesh(hp, k, resting_thickness=rt)),
    )


def random_state(mesh, seed, thickness=10.0):
    """Random (ssh, h, u) numpy arrays on an unstructured mesh, with ssh
    consistent with h."""
    rng = np.random.default_rng(seed)
    k = mesh.vert.n_vert_levels
    h = thickness + 0.01 * rng.normal(size=(mesh.n_cells, k))
    u = 0.01 * rng.normal(size=(mesh.n_edges, k))
    ssh = h.sum(1) - np.asarray(mesh.vert.resting_thickness_sum)
    return ssh, h, u


def jax_prog(ssh, h, u):
    return mo.PrognosticVars(
        ssh=jnp.asarray(ssh), layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )


def port_prog(ssh, h, u):
    return mt.PrognosticVars(
        ssh=torch.from_numpy(np.array(ssh)),
        layer_thickness=torch.from_numpy(np.array(h)),
        normal_velocity=torch.from_numpy(np.array(u)),
    )


def jax_lattice(nx, ny, k, seed, **mesh_kw):
    """(JAX StructuredModel, JAX StructState) on a random state."""
    mj, _ = both_meshes(nx, ny, k, **mesh_kw)
    sm = JaxStructuredModel(mj, nx, ny)
    return sm, sm.to_struct(jax_prog(*random_state(mj, seed)))


def jax_struct_mesh_dict(struct_mesh) -> dict:
    """The JAX StructMesh's fields that the port's linear core reads, with
    arrays as numpy."""
    return {
        f: (np.asarray(getattr(struct_mesh, f))
            if f not in ("nx", "ny2", "n_vert_levels", "coriolis_terms")
            else getattr(struct_mesh, f))
        for f in STRUCT_MESH_FIELDS
    }


def jax_struct_state_dict(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


def dataclass_arrays(obj, prefix=""):
    """Flatten a (nested) dataclass into {dotted name: value}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(dataclass_arrays(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def max_rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---- the nonlinear core's lattices (tests/test_torch_nonlinear.py,
# tests/test_torch_nl_adjoint.py) ----------------------------------------

def wavy_state(mesh, amp=0.5, seed=None):
    """tests/test_nonlinear.py:42's _wavy_state as numpy (ssh, h, u): h a
    wave on the resting thickness, u = 0.1 amp sin(2 pi x / lx) on every
    level, so that the nonlinear terms matter; with a seed, random u on
    top (0 on a culled mesh's walls)."""
    horz = mesh.horz
    x, y = np.asarray(horz.cells.x), np.asarray(horz.cells.y)
    lx = float(x.max() - x.min()) + float(np.asarray(horz.edges.dc_edge)[0])
    k = mesh.vert.n_vert_levels
    wave = amp * np.cos(2 * np.pi * x / lx) * np.sin(2 * np.pi * y / lx)
    rts = np.asarray(mesh.vert.resting_thickness_sum)
    h = np.broadcast_to((rts / k + wave / k)[:, None], (horz.n_cells, k)).copy()
    u = np.broadcast_to((0.1 * amp * np.sin(2 * np.pi * np.asarray(horz.edges.x) / lx))[:, None],
                        (horz.n_edges, k)).copy()
    if seed is not None:
        u = u + 0.05 * np.random.default_rng(seed).normal(size=u.shape)
    u = u * np.asarray(horz.edges.edge_mask)[:, None]
    return h.sum(1) - rts, h, u


def to_both(smj, smp, arrays):
    ssh, h, u = arrays
    st_j = smj.to_struct(mo.PrognosticVars(ssh=jnp.asarray(ssh), layer_thickness=jnp.asarray(h),
                                            normal_velocity=jnp.asarray(u)))
    st_p = smp.to_struct(mt.PrognosticVars(*(torch.from_numpy(np.array(x)) for x in arrays)))
    return st_j, st_p


def nl_periodic(n, k, seed=5):
    """(JAX model, port model, JAX state, port state) on an n x n periodic
    lattice of k 50 m levels, f = 1e-4 + beta y."""
    mj, mp = both_meshes(n, n, k, thickness=50.0)
    smj, smp = JaxStructuredModel(mj, n, n), mt.StructuredModel(mp, n, n, device="cpu")
    return (smj, smp, *to_both(smj, smp, wavy_state(mp, seed=seed)), mj, mp)


def nl_channel(n, k, seed=3):
    """The same on tests/test_nonlinear.py:242's channel: the n x n lattice
    with its first and last cell rows culled."""
    dc = 1000.0
    hj, hp = (pkg.planar_hex_mesh(n, n, dc, f0=1e-4) for pkg in (mo, mt))
    y = np.asarray(hp.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    cj, cp = jax_cull_cells(hj, keep), mt.cull_cells(hp, keep)
    rt = np.full((cp.n_cells, k), 50.0)
    mj = mo.Mesh(horz=cj, vert=jax_make_vertical_mesh(cj, k, resting_thickness=rt))
    mp = mt.Mesh(horz=cp, vert=mt.make_vertical_mesh(cp, k, resting_thickness=rt))
    smj = JaxStructuredModel(mj, n, n, parent_horz=hj, keep_cells=keep)
    smp = mt.StructuredModel(mp, n, n, device="cpu", parent_horz=hp, keep_cells=keep)
    return (smj, smp, *to_both(smj, smp, wavy_state(mp, seed=seed)), mj, mp)


# ---- momentum forcing (tests/test_torch_forcing.py,
# tests/test_torch_forcing_adjoint.py) ---------------------------------------

# tests/test_forcing.py:55-63's _full_forcing: wind, both drags and Rayleigh
FULL_FORCING = dict(wind_stress_zonal=0.1, wind_stress_meridional=-0.05,
                    bottom_drag_linear=1e-5, bottom_drag_quadratic=2e-3, rayleigh=1e-6)


def forced_lattice(n, k, channel=False, seed=5, **forcing_kw):
    """(JAX model, port model, JAX state, port state, JAX struct Forcing,
    port struct Forcing) on ``nl_periodic``'s or ``nl_channel``'s lattice,
    with ``make_forcing``'s forcing (FULL_FORCING by default) of each
    package."""
    from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing

    smj, smp, stj, stp, mj, mp = (nl_channel if channel else nl_periodic)(n, k, seed)
    kw = forcing_kw or FULL_FORCING
    fj, fp = jax_make_forcing(mj, **kw), mt.models.make_forcing(mp, **kw)
    return smj, smp, stj, stp, smj.to_struct_forcing(fj), smp.to_struct_forcing(fp)


def jax_forcing_dict(forcing) -> dict:
    return {f.name: np.asarray(getattr(forcing, f.name)) for f in dataclasses.fields(forcing)}


# ---- the card's routes rehearsed on the CPU (tests/test_torch_composed_adjoint.py
# and the gradients' card checks) ---------------------------------------------

class StubEntry:
    """A stubbed kernel entry: checks each call's argument count and types
    against its argtypes, keeps the calls and returns 0."""

    def __init__(self):
        self.argtypes = None
        self.calls = []

    def __call__(self, *args):
        import ctypes

        assert len(args) == len(self.argtypes)
        for a, t in zip(args, self.argtypes):
            want = {ctypes.c_void_p: (int, type(None)), ctypes.c_double: (float,),
                    ctypes.c_int: (int,), ctypes.c_longlong: (int,)}[t]
            assert isinstance(a, want) and not isinstance(a, bool)
        self.calls.append(args)
        return 0


class StubLib:
    """The kernel library stubbed: every entry a StubEntry."""

    def __getattr__(self, name):
        setattr(self, name, StubEntry())
        return getattr(self, name)


def stub_card(monkeypatch) -> StubLib:
    """The card's steps and wrappers on the CPU: the kernel library stubbed
    (StubLib), the wrappers' lattice_dims taking CPU tensors, the steps'
    operands (the forcing's, W) and accumulators kept on the CPU, and every
    launch counter at 0. Returns the stub library."""
    import contextlib
    from types import SimpleNamespace

    from mpas_ocean_tpu_torch.kernels import adjoint_step, build, fe_step, tiled_adjoint
    from mpas_ocean_tpu_torch.structured import diff_model

    lib = StubLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    for m in (fe_step, adjoint_step, tiled_adjoint):
        monkeypatch.setattr(m, "lattice_dims", lambda h, name="fe_step": tuple(h.shape[1:]))
        for c in [c for c, v in vars(m).items() if c.endswith("launches") and isinstance(v, int)]:
            monkeypatch.setattr(m, c, 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    zeros, kernel_forcing = torch.zeros, diff_model.kernel_forcing
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **kw: zeros(*a, **kw))
    monkeypatch.setattr(diff_model, "kernel_strat",
                        lambda s, dtype, device: None if s is None
                        else s.phi_weights.to(dtype).contiguous())
    monkeypatch.setattr(diff_model, "kernel_forcing",
                        lambda f, mesh, dtype, device: kernel_forcing(f, mesh, dtype, "cpu"))
    return lib


# ---- the sharded row slabs (tests/test_torch_sharded.py,
# tests/test_torch_sharded_grad.py) --------------------------------------------

# a stable column of four layers (kg/m^3), top first
SHARDED_RHO = [1024.0, 1025.0, 1025.5, 1027.0]


def full_lattice(n, k, channel=False, seed=5):
    """(JAX model, port model, JAX state, port state, (JAX, port) lattice
    Forcing, (JAX, port) Stratification) on ``nl_periodic``'s or
    ``nl_channel``'s n x n lattice of k 50 m levels (k = 4: SHARDED_RHO's
    densities), the states carrying two tracers (T with a wave and noise,
    S = 35) made by each package from the same numpy fields, the forcing
    FULL_FORCING's."""
    from mpas_ocean_tpu.models import stratification as jax_strat
    from mpas_ocean_tpu.models.forcing import make_forcing as jax_make_forcing
    from mpas_ocean_tpu.models.tracers import make_tracers as jax_make_tracers

    smj, smp, stj, stp, mj, mp = (nl_channel if channel else nl_periodic)(n, k, seed)
    x = np.asarray(mp.horz.cells.x)
    rng = np.random.default_rng(9)
    fields = [10.0 + 2.0 * np.sin(2 * np.pi * x / (x.max() + 1))[:, None]
              + 0.3 * rng.normal(size=(mp.n_cells, k)), np.full(mp.n_cells, 35.0)]
    progj = smj.from_struct(stj).replace(tracers=jax_make_tracers(mj, fields))
    progp = mt.PrognosticVars(*(getattr(smp.from_struct(stp), f) for f in STATE_FIELDS),
                              tracers=mt.make_tracers(mp, fields))
    forcing = (smj.to_struct_forcing(jax_make_forcing(mj, **FULL_FORCING)),
               smp.to_struct_forcing(mt.make_forcing(mp, **FULL_FORCING)))
    rho = SHARDED_RHO if k == 4 else list(1024.0 + np.linspace(0.0, 3.0, k))
    strat = jax_strat.make_stratification(rho), mt.make_stratification(rho)
    return smj, smp, smj.to_struct(progj), smp.to_struct(progp), forcing, strat


def port_local(jax_local: dict, device="cpu") -> dict:
    """A JAX slab dict (ShardedStructuredModel.scatter's: each field stacked
    over the slabs, (P, planes, R + 2, nx, ...)) -> the port's ({field: [one
    tensor per slab]})."""
    return {k: [torch.from_numpy(np.array(x)).to(device) for x in np.asarray(v)]
            for k, v in jax_local.items()}


def jax_local(port_local: dict) -> dict:
    """The port's slab dict -> the JAX package's (each field stacked)."""
    return {k: jnp.asarray(np.stack([x.detach().cpu().numpy() for x in v]))
            for k, v in port_local.items()}
