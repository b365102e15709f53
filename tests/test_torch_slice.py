"""The port's main path end to end on the CPU against the JAX package's:
inertial-gravity-wave state on a periodic hex lattice -> StructuredModel ->
to_struct -> structured_auto_run_loop -> from_struct, f64."""

import numpy as np
import pytest
import torch

import mpas_ocean_tpu as mo
import mpas_ocean_tpu_torch as mt
from mpas_ocean_tpu.mesh.vert_mesh import make_vertical_mesh as jax_make_vertical_mesh
from mpas_ocean_tpu.structured.model import StructuredModel as JaxStructuredModel
from mpas_ocean_tpu.structured.pallas_model import (
    structured_auto_run_loop as jax_auto_run_loop,
)
from mpas_ocean_tpu.verification import InertialGravityWave as JaxIGW

from torch_port_cases import STATE_FIELDS, jax_prog, max_rel_err

N, K, DT, STEPS = 32, 4, 30.0, 40


def _igw_inputs(pkg, make_vertical_mesh, igw_class):
    dc = 10000.0e3 / N
    horz = pkg.planar_hex_mesh(N, N, dc, f0=1e-4)
    igw = igw_class(lx=N * dc / 1e3)
    vert = make_vertical_mesh(
        horz, K, resting_thickness=np.full((horz.n_cells, K), igw.bottom_depth / K)
    )
    return horz, igw, pkg.Mesh(horz=horz, vert=vert), igw.initial_state(horz, K)


@pytest.fixture(scope="module")
def runs():
    _, _, mesh_j, init_j = _igw_inputs(mo, jax_make_vertical_mesh, JaxIGW)
    sm_j = JaxStructuredModel(mesh_j, N, N)
    ref = sm_j.from_struct(jax_auto_run_loop(
        sm_j.to_struct(jax_prog(*init_j)), sm_j.struct_mesh, DT, STEPS))

    horz, igw, mesh, init = _igw_inputs(mt, mt.make_vertical_mesh, mt.InertialGravityWave)
    for a, b in zip(init, init_j):
        np.testing.assert_array_equal(a, b)
    model = mt.StructuredModel(mesh, N, N, device="cpu")
    prog = mt.PrognosticVars(*(torch.from_numpy(a) for a in init))
    out = model.from_struct(mt.structured_auto_run_loop(
        model.to_struct(prog), model.struct_mesh, DT, STEPS))
    return horz, igw, out, ref


def test_slice_matches_jax(runs):
    *_, out, ref = runs
    for f in STATE_FIELDS:
        got = getattr(out, f)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert max_rel_err(got.numpy(), getattr(ref, f)) <= 1e-12, f


def test_slice_igw_error_matches_jax(runs):
    horz, igw, out, ref = runs
    exact = igw.exact_ssh(horz.cells.x, horz.cells.y, STEPS * DT)
    port = mt.error_measures(out.ssh.numpy(), exact, horz, "cell")
    jax_err = mo.utils.error_measures(np.asarray(ref.ssh), exact, horz, "cell")
    assert port.L_two == pytest.approx(jax_err.L_two, rel=1e-9)
    assert port.L_inf == pytest.approx(jax_err.L_inf, rel=1e-9)
    assert port.L_two < 0.05
