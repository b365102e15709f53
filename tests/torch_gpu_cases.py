"""Shared inputs for the port's tests on a CUDA card
(tests/test_torch_kernel.py, tests/test_torch_adjoint_kernel.py,
tests/test_torch_tiled_kernel.py, tests/test_torch_tiled_adjoint_kernel.py,
tests/test_torch_peaks.py). They import no JAX, so they run on a GPU machine
without it."""

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


def channel_lattice(nx, ny, k, device, seed=7, dc=1000.0, dtype=np.float64):
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
    u = 0.01 * rng.normal(size=(chan.n_edges, k))
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
