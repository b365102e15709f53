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
