"""Reverse of the linear forward-Euler step, written out by hand on
``torch.roll``.

``structured_adjoint_step`` is the VJP of ``model.structured_step``: the
plain PyTorch version of the adjoint-step kernel (csrc/adjoint_step.cu) and
the CPU route of ``diff_model``. It is the counterpart of the in-kernel
``jax.vjp`` of ``_step_planes`` in the JAX package's
``_adjoint_segment_kernel`` (mpas_ocean_tpu/structured/pallas_model.py:
1545-1590), which CUDA does not have. For output cotangents (gs, gh, gu):

* G = gh + gs, broadcast over the levels (ssh' = sum_k h' - rts);
* the flux cotangent on each edge is dt * s_div * (G[nbr] - G[owner]);
* dh = G + 1/2 sum over the cell's 6 edges of u * (flux cotangent);
* du = gu + h_edge * (flux cotangent) + dt * f * (C^T gu), with C^T the
  transposed Coriolis stencil;
* dssh = (g dt / dc) * (owned minus incoming edge sums of sum_k gu): the input
  ssh enters the step only through its gradient;
* d(dt) = <G, tend_h> + <gu, tend_u>.

On a masked lattice (a coastal channel) the step ends u' = m * (u + dt *
tend_u), so the output cotangent gu enters as m * gu wherever it appears:
in C^T gu, in du's first term, in dssh's level sums and in d(dt).
"""

from __future__ import annotations

import torch

from ..constants import GRAVITY
from .hex_layout import E, NE, NW
from .model import (
    StructMesh,
    StructState,
    _incoming_edge_fields,
    _neighbor_cell_field,
    apply_stencil,
    div_on_cell,
    grad_on_edge,
    interp_cell_to_edge,
    structured_step,
    tangential_times_f,
)
from .stencils import transpose_coriolis_terms

__all__ = ["structured_adjoint_run_loop", "structured_adjoint_step"]


def structured_adjoint_step(
    state: StructState, g: StructState, mesh: StructMesh, dt
) -> tuple[StructState, torch.Tensor]:
    """VJP of ``structured_step(state, mesh, dt)`` for the output cotangent
    ``g``: (cotangent of the input state, d(dt) as a 0-d tensor). With the
    mesh's wall mask m, gu is m * gu throughout."""
    h, u = state.layer_thickness, state.normal_velocity
    gu = g.normal_velocity
    if mesh.edge_mask is not None:
        gu = gu * mesh.edge_mask[..., None]
    G = g.layer_thickness + g.ssh[..., None]

    h_edge = interp_cell_to_edge(h, mesh)
    tend_h = -div_on_cell(u * h_edge, mesh)
    tend_u = -GRAVITY * grad_on_edge(state.ssh, mesh)[..., None]
    tend_u = tend_u + tangential_times_f(u, mesh)
    d_dt = (G * tend_h).sum() + (gu * tend_u).sum()

    g_flux = torch.stack([_neighbor_cell_field(G, f) - G for f in (E, NE, NW)])
    g_flux = g_flux * (dt * (mesh.dv / mesh.area_cell))
    ug = u * g_flux
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(ug)
    d_h = G + 0.5 * (ug[0] + ug[1] + ug[2] + inc_E + inc_NE + inc_NW)

    ct = apply_stencil(gu, transpose_coriolis_terms(mesh.coriolis_terms))
    d_u = gu + h_edge * g_flux + dt * (mesh.f_edge[..., None] * ct)

    s = gu.sum(-1)
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(s)
    d_ssh = (GRAVITY * dt / mesh.dc) * (s[0] + s[1] + s[2] - inc_E - inc_NE - inc_NW)
    return StructState(ssh=d_ssh, layer_thickness=d_h, normal_velocity=d_u), d_dt


def structured_adjoint_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int, g: StructState
) -> tuple[StructState, torch.Tensor]:
    """VJP of ``structured_run_loop(state, mesh, dt, n_steps)`` for the
    output cotangent ``g``, keeping all n_steps primal states: the plain
    version of the whole kernel reverse, on any device."""
    states = [state]
    for _ in range(n_steps - 1):
        states.append(structured_step(states[-1], mesh, dt))
    d_dt = torch.zeros((), dtype=state.layer_thickness.dtype,
                       device=state.layer_thickness.device)
    if n_steps == 0:
        return g, d_dt
    for s in reversed(states):
        g, dd = structured_adjoint_step(s, g, mesh, dt)
        d_dt = d_dt + dd
    return g, d_dt
