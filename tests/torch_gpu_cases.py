"""Shared inputs for the port's tests on a CUDA card
(tests/test_torch_kernel.py, tests/test_torch_adjoint_kernel.py,
tests/test_torch_tiled_kernel.py). They import
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


def random_lattice(nx, ny, k, device, seed=7, dc=1000.0):
    """(StructuredModel, random f64 lattice state) on ``device``."""
    horz = mt.planar_hex_mesh(nx, ny, dc, f0=1e-4, beta=1e-11)
    vert = mt.make_vertical_mesh(
        horz, k, resting_thickness=np.full((horz.n_cells, k), 10.0)
    )
    rng = np.random.default_rng(seed)
    h = 10.0 + 0.01 * rng.normal(size=(horz.n_cells, k))
    u = 0.01 * rng.normal(size=(horz.n_edges, k))
    prog = mt.PrognosticVars(
        ssh=torch.from_numpy(h.sum(1) - vert.resting_thickness_sum),
        layer_thickness=torch.from_numpy(h),
        normal_velocity=torch.from_numpy(u),
    )
    model = mt.StructuredModel(mt.Mesh(horz=horz, vert=vert), nx, ny, device=device)
    return model, model.to_struct(prog)
