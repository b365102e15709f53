"""The port's structured rollouts against the JAX package's, on the CPU.

* plain ``structured_run_loop`` against the JAX roll model, f64;
* ``fused_run_loop`` (which runs the plain version for CPU tensors) against
  the JAX Pallas rollout in interpret mode, at tests/test_pallas.py's
  tolerances;
* a numpy walk of the kernel's stencil table, step for step as
  csrc/fe_step.cu reads it, against the plain version: the table's
  semantics are checked here, the CUDA arithmetic on the card
  (tests/test_torch_kernel.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from mpas_ocean_tpu.structured.model import structured_run_loop as jax_run_loop
from mpas_ocean_tpu.structured.pallas_model import pallas_run_loop
from mpas_ocean_tpu_torch.constants import GRAVITY
from mpas_ocean_tpu_torch.kernels import fe_step
from mpas_ocean_tpu_torch.structured import (
    StructState,
    fused_run_loop,
    struct_mesh_from_numpy,
    struct_mesh_to_numpy,
    struct_state_from_numpy,
    struct_state_to_numpy,
    structured_run_loop,
)
from mpas_ocean_tpu_torch.structured.fused_model import _scal

from torch_port_cases import (
    STATE_FIELDS,
    jax_lattice,
    jax_struct_mesh_dict,
    jax_struct_state_dict,
    max_rel_err,
)


def _port_inputs(sm, st):
    return (
        struct_state_from_numpy(jax_struct_state_dict(st)),
        struct_mesh_from_numpy(jax_struct_mesh_dict(sm.struct_mesh)),
    )


def test_numpy_round_trip_is_bitwise():
    sm, st = jax_lattice(8, 8, 2, seed=1)
    state, mesh = _port_inputs(sm, st)
    back = struct_state_to_numpy(state)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(st, f)))
    d = struct_mesh_to_numpy(mesh)
    for f, v in jax_struct_mesh_dict(sm.struct_mesh).items():
        if isinstance(v, np.ndarray):
            assert d[f].dtype == v.dtype
            np.testing.assert_array_equal(d[f], v)
        else:
            assert d[f] == v, f


def test_plain_run_loop_matches_jax_roll_model():
    sm, st = jax_lattice(16, 16, 3, seed=4)
    state, mesh = _port_inputs(sm, st)
    n, dt = 20, 10.0
    ref = jax_run_loop(st, sm.struct_mesh, dt, n)
    out = structured_run_loop(state, mesh, dt, n)
    for f in STATE_FIELDS:
        assert max_rel_err(getattr(out, f).numpy(), getattr(ref, f)) <= 1e-12, f


def test_fused_run_loop_cpu_matches_pallas_interpret():
    sm, st = jax_lattice(8, 8, 4, seed=7)
    state, mesh = _port_inputs(sm, st)
    n = 5
    ref = pallas_run_loop(st, sm.struct_mesh, 10.0, n, interpret=True)
    out = fused_run_loop(state, mesh, 10.0, n)
    for f, atol in (("ssh", 1e-11), ("layer_thickness", 1e-11),
                    ("normal_velocity", 1e-13)):
        np.testing.assert_allclose(
            getattr(out, f).numpy(), np.asarray(getattr(ref, f)), rtol=0, atol=atol
        )


def _walk_table_step(ssh, h, u, f_edge, rts, table, w, dt, inv_dc, s_div):
    """One step as csrc/fe_step.cu computes it from the packed table, on
    numpy planes: ssh (2, ny2, nx), h (2, ny2, nx, K), u (6, ny2, nx, K),
    f_edge (6, ny2, nx), rts (2, ny2, nx)."""
    _, ny2, nx, _ = h.shape
    n = table[0]
    nbr = table[1:19].reshape(6, 3)
    inc = table[19:37].reshape(2, 3, 3)
    off = table[37:44]
    taps = table[44:].reshape(n, 3)
    m, i = np.meshgrid(np.arange(ny2), np.arange(nx), indexing="ij")

    def at(plane, dm, di, mm=m, ii=i):
        return plane[(mm + dm) % ny2, (ii + di) % nx]

    ssh_n, h_n, u_n = np.empty_like(ssh), np.empty_like(h), np.empty_like(u)
    pg_scale = -GRAVITY * dt
    for p in (0, 1):
        total = None
        for f in range(3):
            pin, dm, di = nbr[f * 2 + p]
            fl = u[f * 2 + p] * (0.5 * (at(h[pin], dm, di) + h[p]))
            total = fl if total is None else total + fl
        for ch, dm, di in inc[p]:
            pn, dmn, din = nbr[ch]
            ms, is_ = (m + dm) % ny2, (i + di) % nx
            he = 0.5 * (at(h[pn], dmn, din, ms, is_) + h[ch & 1][ms, is_])
            total = total - u[ch][ms, is_] * he
        h_n[p] = h[p] - (dt * s_div) * total
        ssh_n[p] = h_n[p].sum(-1) - rts[p]
        for f in range(3):
            c = f * 2 + p
            pin, dm, di = nbr[c]
            grad = (at(ssh[pin], dm, di) - ssh[p]) * inv_dc
            acc = 0.0
            for t in range(off[c], off[c + 1]):
                ch, dm, di = taps[t]
                acc = acc + w[t] * (at(u[ch], dm, di) * at(f_edge[ch], dm, di)[..., None])
            u_n[c] = u[c] + dt * acc + pg_scale * grad[..., None]
    return ssh_n, h_n, u_n


def test_kernel_table_walk_matches_plain_version():
    sm, st = jax_lattice(10, 12, 3, seed=9)
    state, mesh = _port_inputs(sm, st)
    dt, n = 10.0, 6
    dt_, inv_dc, s_div = _scal(mesh, dt, torch.float64)
    ny2, nx, k = mesh.ny2, mesh.nx, state.layer_thickness.shape[-1]
    ssh = state.ssh.numpy()
    h = state.layer_thickness.numpy()
    u = state.normal_velocity.numpy().reshape(6, ny2, nx, k)
    f_edge = mesh.f_edge.numpy().reshape(6, ny2, nx)
    for _ in range(n):
        ssh, h, u = _walk_table_step(
            ssh, h, u, f_edge, mesh.resting_thickness_sum.numpy(),
            mesh.stencil_table.numpy(), mesh.coriolis_weight.numpy(),
            dt_, inv_dc, s_div,
        )
    ref = structured_run_loop(state, mesh, dt, n)
    for got, f in ((ssh, "ssh"), (h, "layer_thickness"), (u, "normal_velocity")):
        want = getattr(ref, f).numpy()
        assert max_rel_err(got.reshape(want.shape), want) <= 1e-12, f


def test_scal_rounds_in_state_dtype():
    sm, st = jax_lattice(8, 8, 2, seed=1)
    _, mesh = _port_inputs(sm, st)
    dt, inv_dc, s_div = _scal(mesh.to("cpu"), 30.1, torch.float32)
    assert dt == float(np.float32(30.1))
    assert inv_dc == float(np.float32(1.0 / np.float64(mesh.dc)))
    assert s_div == float(np.float32(np.float64(mesh.dv) / np.float64(mesh.area_cell)))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on a CUDA device or raises; the CPU route to
    the plain version is fused_run_loop's, by the state's device."""
    sm, st = jax_lattice(8, 8, 2, seed=1)
    state, mesh = _port_inputs(sm, st)
    with pytest.raises(ValueError, match="CUDA"):
        fe_step.fe_rollout(
            state.ssh, state.layer_thickness, state.normal_velocity,
            mesh.f_edge, mesh.resting_thickness_sum, *mesh.host_stencil,
            10.0, 1e-3, 1e-3, 1,
        )
    with pytest.raises(ValueError, match="no rollout"):
        fused_run_loop(StructState(
            *(getattr(state, f).to("meta") for f in STATE_FIELDS)), mesh, 10.0, 1)


def test_containers_move_with_to():
    sm, st = jax_lattice(8, 8, 2, seed=1)
    state, mesh = _port_inputs(sm, st)
    moved_state, moved_mesh = state.to("meta"), mesh.to("meta")
    for f in STATE_FIELDS:
        assert getattr(moved_state, f).device.type == "meta"
    for f in ("dc", "dv", "area_cell", "f_edge", "resting_thickness_sum",
              "stencil_table", "coriolis_weight"):
        assert getattr(moved_mesh, f).device.type == "meta"
    assert moved_mesh.coriolis_terms == mesh.coriolis_terms
    assert moved_mesh.host_stencil is mesh.host_stencil  # the forward kernels' host copy
