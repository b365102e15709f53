"""Fused rollouts of the structured core on the card, and the entry point
that routes between them.

Counterpart of mpas_ocean_tpu/structured/pallas_model.py's
``pallas_run_loop`` (:712) and ``structured_auto_run_loop`` (:1419) for the
linear and the nonlinear core, on periodic lattices and on coastal channels
(a mesh with a wall mask runs the kernels' masked arms), with momentum
forcing (``forcing=``, the kernels' forced arms; ``forcing_setup`` is the
counterpart of ``_forcing_setup``, :646-709) and with tracers (a state's
``tracers``, the kernels' tracer arms; ``kernel_tracers`` is the counterpart
of ``_tracer_setup``, :610-639) and with layered stratification
(``strat=``, the forward kernels' stratified arms; ``kernel_strat`` is the
counterpart of ``_strat_w``, :642-643), in any combination with each
other and with either core (the composed arms). ``fused_run_loop`` runs forward
Euler (FE) one hand-written kernel step per launch (kernels/fe_step.py,
csrc/fe_step.cu); ``tiled_model.tiled_run_loop`` runs FE or
forward-backward (FB) q steps per launch (kernels/tiled_step.py). State on
a CUDA device runs a kernel, and a failed build or launch raises; state on
the CPU runs the plain version, ``model.structured_run_loop``. Nothing
falls back from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import GRAVITY
from ..kernels import fe_step
from ..models.forcing import Forcing
from ..models.stratification import Stratification
from . import tiled_model
from .model import StructMesh, StructState, check_nl_mesh, structured_run_loop

__all__ = ["KernelForcing", "KernelTracers", "forcing_scal", "forcing_setup", "fused_run_loop",
           "kernel_forcing", "kernel_live", "kernel_strat", "kernel_tracers",
           "nl_adjoint_scal", "nl_scal", "nl_setup", "pack_levels",
           "structured_auto_run_loop", "tracer_opts", "tracer_planes", "tracer_unplanes"]


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


def forcing_setup(forcing: Forcing, ny2: int, nx: int, dtype: torch.dtype):
    """A lattice Forcing (``StructuredModel.to_struct_forcing``) as the
    kernels take it (pallas_model._forcing_setup's concrete branch): the wind
    planes (6, ny2, nx) in ``dtype`` and the one-hot level masks compressed
    to per-edge level indices, int32 (12, ny2, nx) = [top x 6; bottom x 6],
    -1 on an edge with no active level, computed on the forcing's device. A
    mask that is not one-hot {0, 1} raises NotImplementedError. The JAX
    package also has a traced branch, which cannot check its masks and
    poisons the wind with NaN instead; eager torch always holds concrete
    masks, so the check runs on every call."""
    wind = forcing.wind_edge.reshape(6, ny2, nx).to(dtype).contiguous()
    idx = []
    for m in (forcing.top_mask, forcing.bottom_mask):
        m = m.detach().reshape(6, ny2, nx, -1)
        on = m != 0
        ii = torch.where(on.sum(-1) == 1, on.to(torch.int32).argmax(-1), -1).to(torch.int32)
        recon = torch.arange(m.shape[-1], device=m.device) == ii[..., None]
        if not torch.equal(recon.to(m.dtype), m):
            raise NotImplementedError(
                "the kernels take one-hot {0, 1} forcing level masks only (make_forcing "
                "builds these); run the plain steps for general level masks")
        idx.append(ii)
    return wind, torch.cat(idx)


def pack_levels(idx: torch.Tensor) -> torch.Tensor:
    """``forcing_setup``'s level indices (12, ny2, nx) packed into one int32
    per edge (6, ny2, nx), as the forced arms take them: bits 0-15 hold
    top + 1 and bits 16-31 bottom + 1, 0 for no active level (csrc/
    step_window.cuh, load_forcing)."""
    if int(idx.max()) >= (1 << 15) - 1:
        raise ValueError("the forced arms take fewer than 32767 levels")
    return ((idx[:6] + 1) | ((idx[6:] + 1) << 16)).to(torch.int32).contiguous()


def forcing_scal(forcing: Forcing, dtype: torch.dtype) -> tuple[float, float, float]:
    """(r_lin, Cd, lambda) rounded once from the forcing's dtype to the state
    dtype, as pallas_model._scal's slots 6-8."""
    return tuple(float(x.detach().cpu().to(dtype))
                 for x in (forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh))


class KernelForcing(NamedTuple):
    """The forced arms' operands: the wind (6, ny2, nx) in the state dtype,
    the packed levels (``pack_levels``), (r_lin, Cd, lambda), and the levels
    that are some edge's top and some edge's bottom level (the host's copy,
    from which each launch tells its ranks which stage the operands:
    ``kernels.fe_step.forcing_ranks``)."""

    wind: torch.Tensor
    levels: torch.Tensor
    coefs: tuple
    top_levels: tuple
    bottom_levels: tuple


def kernel_forcing(forcing: Forcing | None, mesh: StructMesh, dtype: torch.dtype,
                   device) -> KernelForcing | None:
    """``forcing`` as the forced arms take it, on ``device``, or None."""
    if forcing is None:
        return None
    wind, idx = forcing_setup(forcing, mesh.ny2, mesh.nx, dtype)
    used = [tuple(int(x) for x in torch.unique(part).cpu() if x >= 0)
            for part in (idx[:6], idx[6:])]
    return KernelForcing(wind.to(device).contiguous(), pack_levels(idx).to(device),
                         forcing_scal(forcing, dtype), *used)



def tracer_planes(tracers: torch.Tensor) -> torch.Tensor:
    """Lattice tracers (2, ny2, nx, nT, K) as the kernels take them
    (pallas_model._tr_planes, :610-613): planes (2 nT, ny2, nx, K), plane
    t * 2 + parity, contiguous."""
    _, ny2, nx, _, k = tracers.shape
    return tracers.permute(3, 0, 1, 2, 4).reshape(-1, ny2, nx, k).contiguous()


def tracer_unplanes(planes: torch.Tensor) -> torch.Tensor:
    """The inverse of ``tracer_planes``: (2 nT, ny2, nx, K) -> (2, ny2, nx,
    nT, K), contiguous."""
    _, ny2, nx, k = planes.shape
    return planes.reshape(-1, 2, ny2, nx, k).permute(1, 2, 3, 0, 4).contiguous()


def tracer_opts(kappa, upwind, dtype: torch.dtype) -> tuple[float, float]:
    """(kappa, upwind) rounded once to the state dtype, as
    pallas_model._tracer_setup rounds them (:633-638), so that the kernels'
    products with them round as the plain version's do."""
    return tuple(float(torch.tensor(float(x), dtype=torch.float64).to(dtype))
                 for x in (kappa, upwind))


class KernelTracers(NamedTuple):
    """The tracer arms' operands: the tracer planes (``tracer_planes``), the
    cell mask (2, ny2, nx) in the state dtype on a channel (the guard of the
    division by h'; None on a periodic lattice), and (kappa, upwind) rounded
    to the state dtype (``tracer_opts``)."""

    planes: torch.Tensor
    cell_mask: torch.Tensor | None
    kappa: float
    upwind: float


def kernel_tracers(state: StructState, mesh: StructMesh, kappa, upwind) -> KernelTracers | None:
    """The state's tracers as the tracer arms take them, on the state's
    device and in its dtype, built once per call; None without tracers."""
    if state.tracers is None:
        return None
    dtype = state.layer_thickness.dtype
    cmask = None if mesh.cell_mask is None else mesh.cell_mask.to(dtype).contiguous()
    return KernelTracers(tracer_planes(state.tracers.to(dtype)), cmask,
                         *tracer_opts(kappa, upwind, dtype))



def kernel_strat(strat: Stratification | None, dtype: torch.dtype, device):
    """The stratification's W (K, K) as the stratified arms take it: cast
    once per call to the state dtype (pallas_model._strat_w, :642-643), on
    ``device``, contiguous; None unstratified."""
    if strat is None:
        return None
    return strat.phi_weights.to(dtype=dtype, device=device).contiguous()



def kernel_live(mesh: StructMesh):
    """The wall mask as the kernels take it, packed into live bits
    (``fe_step.live_bits``), or None on a periodic lattice, which runs the
    periodic arms."""
    if mesh.edge_mask is None:
        return None
    return fe_step.live_bits(mesh.edge_mask)


def fused_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int, *, nonlinear: bool = False,
    forcing: Forcing | None = None, tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    strat: Stratification | None = None,
) -> StructState:
    """n_steps forward-Euler steps of the linear core, or with ``nonlinear``
    of the vector-invariant one (periodic, or masked where the mesh has a
    wall mask); ``forcing`` (struct layout) runs the forced arm; the state's
    tracers, if any, run the tracer arm with ``tracer_kappa`` and
    ``tracer_upwind`` (pallas_run_loop's arguments); ``strat`` runs the
    stratified arm; on the card as on the CPU in any combination, with
    either core."""
    device = state.layer_thickness.device
    if device.type == "cpu":
        return structured_run_loop(state, mesh, dt, n_steps, nonlinear=nonlinear,
                                   forcing=forcing, tracer_kappa=tracer_kappa,
                                   tracer_upwind=tracer_upwind, strat=strat)
    if device.type != "cuda":
        raise ValueError(f"no rollout for state on {device}")
    dtype = state.layer_thickness.dtype
    consts = (mesh.resting_thickness_sum.to(dtype).contiguous(), *mesh.host_stencil)
    arms = dict(live=kernel_live(mesh), forcing=kernel_forcing(forcing, mesh, dtype, device),
                tracers=kernel_tracers(state, mesh, tracer_kappa, tracer_upwind),
                strat_w=kernel_strat(strat, dtype, device))
    if nonlinear:
        ssh, h, u, *tr = fe_step.fe_nl_rollout(
            state.ssh, state.layer_thickness, state.normal_velocity, *consts,
            nl_setup(mesh, dtype), mesh.vertex_cell_terms, mesh.edge_vertex_terms,
            *_scal(mesh, dt, dtype), *nl_scal(mesh, dtype), n_steps, **arms)
    else:
        ssh, h, u, *tr = fe_step.fe_rollout(
            state.ssh, state.layer_thickness, state.normal_velocity,
            mesh.f_edge.to(dtype).contiguous(), *consts, *_scal(mesh, dt, dtype), n_steps,
            **arms)
    return StructState(ssh, h, u, tracer_unplanes(tr[0]) if tr else None)


def structured_auto_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int, *, nonlinear: bool = False,
    fb: bool = False, forcing: Forcing | None = None, tracer_kappa: float = 0.0,
    tracer_upwind: float = 1.0, strat: Stratification | None = None,
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
    masked steps on the CPU. ``forcing`` (struct layout,
    ``StructuredModel.to_struct_forcing``) runs the kernels' forced arms. A
    state with tracers runs the kernels' tracer arms with ``tracer_kappa``
    and ``tracer_upwind``. ``strat`` (``make_stratification``) takes each
    layer's pressure gradient from its Montgomery potential, through the
    kernels' stratified arms. The three compose with each other and with
    either core, on the card (the kernels' composed arms) as in the plain
    steps."""
    device = state.layer_thickness.device
    kw = dict(nonlinear=nonlinear, forcing=forcing, tracer_kappa=tracer_kappa,
              tracer_upwind=tracer_upwind, strat=strat)
    if device.type == "cpu":
        return structured_run_loop(state, mesh, dt, n_steps, fb=fb, **kw)
    if fb:
        return tiled_model.tiled_run_loop(state, mesh, dt, n_steps, fb=True, **kw)
    return fused_run_loop(state, mesh, dt, n_steps, **kw)
