"""Shared inputs for the port's tests on a CUDA card
(tests/test_torch_kernel.py, tests/test_torch_adjoint_kernel.py,
tests/test_torch_tiled_kernel.py, tests/test_torch_tiled_adjoint_kernel.py).
They import
no JAX, so they run on a GPU machine without it."""

import numpy as np
import pytest
import torch

import mpas_ocean_tpu_torch as mt

FIELDS = ("ssh", "layer_thickness", "normal_velocity")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_lattice(nx, ny, k, device, seed=7, dc=1000.0, dtype=np.float64):
    """(StructuredModel, random lattice state) on ``device``, in ``dtype``
    (the random values are drawn in f64)."""
    horz = mt.planar_hex_mesh(nx, ny, dc, f0=1e-4, beta=1e-11, dtype=dtype)
    vert = mt.make_vertical_mesh(
        horz, k, resting_thickness=np.full((horz.n_cells, k), 10.0, dtype=dtype), dtype=dtype
    )
    rng = np.random.default_rng(seed)
    h = 10.0 + 0.01 * rng.normal(size=(horz.n_cells, k))
    u = 0.01 * rng.normal(size=(horz.n_edges, k))
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy((h.sum(1) - vert.resting_thickness_sum).astype(dtype)),
        layer_thickness=torch.from_numpy(h.astype(dtype)),
        normal_velocity=torch.from_numpy(u.astype(dtype)),
    )
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), nx, ny, device=device)
    return model, model.to_struct(prog)


def reversed_terms_mesh(mesh):
    """``mesh`` with each output channel's Coriolis terms in reverse order:
    the same stencil summed in another order, whose packed tables no longer
    map as the hex lattice's (csrc/step_window.cuh, ``hex::``;
    csrc/adjoint_window.cuh, ``hex_adj::``), so the kernels refuse them."""
    d = mt.structured.struct_mesh_to_numpy(mesh)
    d["coriolis_terms"] = tuple(reversed(mesh.coriolis_terms))
    return mt.structured.struct_mesh_from_numpy(d).to(mesh.f_edge.device)
