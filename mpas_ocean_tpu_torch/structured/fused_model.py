"""Fused rollouts of the structured core on the card, and the entry point
that routes between them.

Counterpart of mpas_ocean_tpu/structured/pallas_model.py's
``pallas_run_loop`` (:712) and ``structured_auto_run_loop`` (:1419) for the
linear and the nonlinear core, on periodic lattices and on coastal channels
(a mesh with a wall mask runs the kernels' masked arms). ``fused_run_loop`` runs forward
Euler (FE) one hand-written kernel step per launch (kernels/fe_step.py,
csrc/fe_step.cu); ``tiled_model.tiled_run_loop`` runs FE or
forward-backward (FB) q steps per launch (kernels/tiled_step.py). State on
a CUDA device runs a kernel, and a failed build or launch raises; state on
the CPU runs the plain version, ``model.structured_run_loop``. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from ..constants import GRAVITY
from ..kernels import fe_step
from . import tiled_model
from .model import StructMesh, StructState, check_nl_mesh, structured_run_loop

__all__ = ["fused_run_loop", "kernel_live", "nl_adjoint_scal", "nl_scal", "nl_setup",
           "structured_auto_run_loop"]


def _scal(mesh: StructMesh, dt, dtype: torch.dtype) -> tuple[float, float, float]:
    """(dt, 1/dc, dv/A), each computed in the mesh dtype and rounded to the
    state dtype exactly as pallas_model._scal does, so the kernel's scalar
    products round like the TPU kernel's."""
    dt = torch.as_tensor(dt, dtype=dtype)
    inv_dc = (1.0 / mesh.dc.cpu()).to(dtype)
    s_div = (mesh.dv.cpu() / mesh.area_cell.cpu()).to(dtype)
    return float(dt), float(inv_dc), float(s_div)


def nl_scal(mesh: StructMesh, dtype: torch.dtype) -> tuple[float, float]:
    """The nonlinear core's metric scalars (KE: dc dv / 4A; curl:
    dc / A_tri), computed in the mesh dtype as the roll model computes them
    and rounded to the state dtype, as pallas_model._scal's slots 3 and 4."""
    dc, dv, area = (x.cpu() for x in (mesh.dc, mesh.dv, mesh.area_cell))
    return float((0.25 * dc * dv / area).to(dtype)), float((dc / (area * 0.5)).to(dtype))


def nl_adjoint_scal(mesh: StructMesh, dt, dtype: torch.dtype) -> tuple[float, float]:
    """The nonlinear reverse kernel's ds and dKE scales, g dt / dc and
    dt / dc, each computed in double from the mesh's dc and rounded once to
    the state dtype: a product of already rounded f32 factors, applied at
    every site of every step, would carry its rounding into ds and dKE as a
    bias."""
    dc, dt = float(mesh.dc), float(dt)
    return tuple(float(torch.tensor(x, dtype=torch.float64).to(dtype))
                 for x in (GRAVITY * dt / dc, dt / dc))


def nl_setup(mesh: StructMesh, dtype: torch.dtype) -> torch.Tensor:
    """The vertex constants as the nonlinear arms take them
    (pallas_model._nl_setup, :586-607): f_vertex's 4 planes (4, ny2, nx), or
    on a channel those, the vertex mask's 4 and the kite planes' 12 stacked
    (20, ny2, nx), in ``dtype`` on the mesh's device. Raises for a mesh
    without them (``model.check_nl_mesh``)."""
    check_nl_mesh(mesh)
    ny2, nx = mesh.ny2, mesh.nx
    planes = [mesh.f_vertex.reshape(4, ny2, nx)]
    if mesh.edge_mask is not None:
        planes += [mesh.vertex_mask.reshape(4, ny2, nx), mesh.vertex_kite_planes]
    return torch.cat(planes).to(dtype).contiguous()


def kernel_live(mesh: StructMesh):
    """The wall mask as the kernels take it, packed into live bits
    (``fe_step.live_bits``), or None on a periodic lattice, which runs the
    periodic arms."""
    if mesh.edge_mask is None:
        return None
    return fe_step.live_bits(mesh.edge_mask)


def fused_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int, *, nonlinear: bool = False,
) -> StructState:
    """n_steps forward-Euler steps of the linear core, or with ``nonlinear``
    of the vector-invariant one (periodic, or masked where the mesh has a
    wall mask)."""
    device = state.layer_thickness.device
    if device.type == "cpu":
        return structured_run_loop(state, mesh, dt, n_steps, nonlinear=nonlinear)
    if device.type != "cuda":
        raise ValueError(f"no rollout for state on {device}")
    dtype = state.layer_thickness.dtype
    consts = (mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil)
    if nonlinear:
        ssh, h, u = fe_step.fe_nl_rollout(
            state.ssh, state.layer_thickness, state.normal_velocity, *consts,
            nl_setup(mesh, dtype), mesh.vertex_cell_terms, mesh.edge_vertex_terms,
            *_scal(mesh, dt, dtype), *nl_scal(mesh, dtype), n_steps, live=kernel_live(mesh))
    else:
        ssh, h, u = fe_step.fe_rollout(
            state.ssh, state.layer_thickness, state.normal_velocity,
            mesh.f_edge.to(dtype).contiguous(), *consts, *_scal(mesh, dt, dtype), n_steps,
            live=kernel_live(mesh),
        )
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u)


def structured_auto_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int, *, nonlinear: bool = False,
    fb: bool = False,
) -> StructState:
    """The lattice rollout entry point. A CPU state runs the plain
    ``structured_run_loop`` (as the JAX package does off the TPU). On the
    card, FB runs the tiled kernel at every size (fe_step has no FB arm).
    FE runs fe_step at every size: that is the size rule measured on an
    H100 (PERF.md section 5), where fe_step beat the tiled kernel's best
    plan at both 64x64x100 and 256x256x100 f32. ``nonlinear`` runs the
    vector-invariant momentum equation through the same routes (the
    kernels' nonlinear arms). A mesh with a wall mask (a coastal channel)
    runs the same routes through the kernels' masked arms, or the plain
    masked steps on the CPU."""
    device = state.layer_thickness.device
    if device.type == "cpu":
        return structured_run_loop(state, mesh, dt, n_steps, nonlinear=nonlinear, fb=fb)
    if fb:
        return tiled_model.tiled_run_loop(state, mesh, dt, n_steps, nonlinear=nonlinear,
                                          fb=True)
    return fused_run_loop(state, mesh, dt, n_steps, nonlinear=nonlinear)
