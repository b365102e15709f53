"""Shallow-water core on the structured hex lattice, on torch.roll.

Counterpart of mpas_ocean_tpu/structured/model.py for the linear core
(pressure gradient + TRiSK Coriolis) and the nonlinear vector-invariant one
(KE gradient + symmetrised PV flux), with forward Euler and
forward-backward, on periodic lattices and on coastal channels culled from
them (wall masks), with momentum forcing, tracer transport
(``tracer_tendency_struct``) and layered stratification
(``pressure_tendency``). This is the plain PyTorch version of the step kernels
(kernels/fe_step.py, kernels/tiled_step.py): the CPU tests hold it against
the JAX package, and on the card the kernels are held against it.

Layout (see hex_layout.py): cell fields (2, ny2, nx, K), edge fields
(3, 2, ny2, nx, K) with canonical family normals at 0/60/120 degrees,
vertex fields (2, 2, ny2, nx, K).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..constants import GRAVITY
from ..models.forcing import Forcing, forcing_tendency
from ..models.stratification import Stratification, montgomery_potential
from ..models.state import PrognosticVars
from .hex_layout import E, NE, NW, HexLayout
from .stencils import transpose_coriolis_terms

__all__ = [
    "StructMesh",
    "StructState",
    "StructuredModel",
    "apply_stencil",
    "cell_to_vertex_kite",
    "check_nl_mesh",
    "curl_on_vertex",
    "kinetic_energy_cell",
    "packed_stencils",
    "pressure_tendency",
    "pv_on_vertex_struct",
    "struct_mesh_from_numpy",
    "struct_mesh_to_numpy",
    "struct_state_from_numpy",
    "struct_state_to_numpy",
    "structured_fb_step",
    "structured_run_loop",
    "structured_step",
    "tangential_weights_only",
    "tracer_concentration_struct",
    "tracer_tendency_struct",
    "vertex_to_edge_mean",
]


@dataclass(frozen=True)
class StructState:
    ssh: torch.Tensor  # (2, ny2, nx)
    layer_thickness: torch.Tensor  # (2, ny2, nx, K)
    normal_velocity: torch.Tensor  # (3, 2, ny2, nx, K)
    # tracer concentrations (models/tracers.py), or None for a run without
    tracers: torch.Tensor | None = None  # (2, ny2, nx, nT, K)

    def to(self, device) -> "StructState":
        return StructState(
            ssh=self.ssh.to(device),
            layer_thickness=self.layer_thickness.to(device),
            normal_velocity=self.normal_velocity.to(device),
            tracers=None if self.tracers is None else self.tracers.to(device),
        )


@dataclass(frozen=True)
class StructMesh:
    nx: int
    ny2: int
    n_vert_levels: int
    # static Coriolis stencil: tuple of (f_out, p_out, f_in, p_in, dm, di, w)
    coriolis_terms: tuple

    dc: torch.Tensor  # 0-d (uniform)
    dv: torch.Tensor  # 0-d
    area_cell: torch.Tensor  # 0-d
    f_edge: torch.Tensor  # (3, 2, ny2, nx)
    resting_thickness_sum: torch.Tensor  # (2, ny2, nx)
    # the Coriolis stencil packed as the kernels read it
    # (kernels/fe_step.pack_stencil): int32 table + weights in the state dtype
    stencil_table: torch.Tensor
    coriolis_weight: torch.Tensor
    # the same for its transpose
    adjoint_table: torch.Tensor
    adjoint_weight: torch.Tensor
    # (stencil_table as int32, coriolis_weight as float64) in numpy, and the
    # same for the transpose: the kernels take the stencils from the host
    # (kernels/fe_step, kernels/adjoint_step)
    host_stencil: tuple
    host_adjoint_stencil: tuple
    # Wall mask of a culled channel (StructuredModel's parent_horz /
    # keep_cells form): 1 on interior edges (both cells live), 0 on wall
    # edges and on edges of culled cells, whose u every step pins to 0; in
    # f_edge's layout, channel family * 2 + parity. None on a periodic
    # lattice.
    edge_mask: torch.Tensor | None = None  # (3, 2, ny2, nx)
    # 1 on live cells, 0 on culled ones; None on a periodic lattice
    cell_mask: torch.Tensor | None = None  # (2, ny2, nx)
    # The nonlinear core's constants (StructuredModel builds them; () and
    # None on a hand-built mesh, which then runs the linear core only): the
    # machine-extracted vertex stencils of hex_layout.py, kite taps
    # (kind, p_out, p_in, dm, di, w) and endpoint taps
    # (f_out, p_out, kind, p_in, dm, di), and f at the vertices.
    vertex_cell_terms: tuple = ()
    edge_vertex_terms: tuple = ()
    f_vertex: torch.Tensor | None = None  # (2, 2, ny2, nx)
    # On a channel: the kite weights renormalised over live cells, one plane
    # per vertex_cell_terms entry, and 1 on live vertices (one live cell or
    # more), 0 on dead ones, where the PV division is guarded. None on a
    # periodic lattice, whose static 1/3 weights stay as they are.
    vertex_kite_planes: torch.Tensor | None = None  # (12, ny2, nx)
    vertex_mask: torch.Tensor | None = None  # (2, 2, ny2, nx)

    def to(self, device) -> "StructMesh":
        return StructMesh(
            nx=self.nx,
            ny2=self.ny2,
            n_vert_levels=self.n_vert_levels,
            coriolis_terms=self.coriolis_terms,
            dc=self.dc.to(device),
            dv=self.dv.to(device),
            area_cell=self.area_cell.to(device),
            f_edge=self.f_edge.to(device),
            resting_thickness_sum=self.resting_thickness_sum.to(device),
            stencil_table=self.stencil_table.to(device),
            coriolis_weight=self.coriolis_weight.to(device),
            adjoint_table=self.adjoint_table.to(device),
            adjoint_weight=self.adjoint_weight.to(device),
            host_stencil=self.host_stencil,
            host_adjoint_stencil=self.host_adjoint_stencil,
            edge_mask=None if self.edge_mask is None else self.edge_mask.to(device),
            cell_mask=None if self.cell_mask is None else self.cell_mask.to(device),
            vertex_cell_terms=self.vertex_cell_terms,
            edge_vertex_terms=self.edge_vertex_terms,
            **{k: None if getattr(self, k) is None else getattr(self, k).to(device)
               for k in _VERTEX_ARRAYS},
        )


# ---- carrying the JAX package's lattice inputs across, as numpy ----------
_MESH_ARRAYS = ("dc", "dv", "area_cell", "f_edge", "resting_thickness_sum")
_MASK_ARRAYS = ("edge_mask", "cell_mask")  # None on a periodic lattice
# the nonlinear core's vertex constants: f_vertex (None on a hand-built
# mesh), and on a channel the kite planes and the vertex mask
_VERTEX_ARRAYS = ("f_vertex", "vertex_kite_planes", "vertex_mask")
_VERTEX_TERMS = ("vertex_cell_terms", "edge_vertex_terms")
_STATE_ARRAYS = ("ssh", "layer_thickness", "normal_velocity")


def packed_stencils(terms, dtype) -> dict:
    """The kernels' tables of the Coriolis stencil and of its transpose
    (kernels/fe_step.pack_stencil), as numpy, weights in ``dtype``."""
    from ..kernels.fe_step import pack_stencil

    table, weights = pack_stencil(terms)
    adj_table, adj_weights = pack_stencil(transpose_coriolis_terms(terms))
    return {
        "stencil_table": table,
        "coriolis_weight": weights.astype(dtype),
        "adjoint_table": adj_table,
        "adjoint_weight": adj_weights.astype(dtype),
    }


def _host_stencil(packed: dict, kind: str = "") -> tuple:
    """StructMesh.host_stencil (kind "") or host_adjoint_stencil (kind
    "adjoint_") from ``packed_stencils``' arrays."""
    table = packed["stencil_table" if not kind else "adjoint_table"]
    weights = packed["coriolis_weight" if not kind else "adjoint_weight"]
    return table, weights.astype(np.float64)


def struct_mesh_from_numpy(d: dict) -> StructMesh:
    """StructMesh from a dict of the JAX StructMesh's fields (arrays as
    numpy, the rest as given), bit for bit; the kernels' stencil tables are
    packed from ``coriolis_terms``. ``edge_mask`` and ``cell_mask``, and the
    nonlinear core's vertex stencils and constants, are carried where the
    dict holds them and they are not None."""
    terms = tuple(tuple(t) for t in d["coriolis_terms"])
    packed = packed_stencils(terms, np.asarray(d["f_edge"]).dtype)
    for k in _MASK_ARRAYS:
        if d.get(k) is not None and not np.isin(np.asarray(d[k]), (0, 1)).all():
            raise ValueError(f"{k} must hold 0 and 1 only (the kernels take it as bits)")
    return StructMesh(
        nx=int(d["nx"]),
        ny2=int(d["ny2"]),
        n_vert_levels=int(d["n_vert_levels"]),
        coriolis_terms=terms,
        **{k: torch.from_numpy(v) for k, v in packed.items()},
        **{k: torch.from_numpy(np.array(d[k])) for k in _MESH_ARRAYS},
        host_stencil=_host_stencil(packed),
        host_adjoint_stencil=_host_stencil(packed, "adjoint_"),
        **{k: torch.from_numpy(np.array(d[k])) for k in _MASK_ARRAYS + _VERTEX_ARRAYS
           if d.get(k) is not None},
        **{k: tuple(tuple(t) for t in d[k]) for k in _VERTEX_TERMS if d.get(k)},
    )


def struct_mesh_to_numpy(mesh: StructMesh) -> dict:
    d = {
        "nx": mesh.nx,
        "ny2": mesh.ny2,
        "n_vert_levels": mesh.n_vert_levels,
        "coriolis_terms": mesh.coriolis_terms,
    }
    d.update({k: getattr(mesh, k).cpu().numpy() for k in _MESH_ARRAYS})
    d.update({k: None if getattr(mesh, k) is None else getattr(mesh, k).cpu().numpy()
              for k in _MASK_ARRAYS + _VERTEX_ARRAYS})
    d.update({k: getattr(mesh, k) for k in _VERTEX_TERMS})
    return d


def struct_state_from_numpy(d: dict) -> StructState:
    """StructState from a dict of numpy arrays (the JAX StructState's
    fields), bit for bit; ``tracers`` where the dict holds them and they are
    not None."""
    tr = d.get("tracers")
    return StructState(**{k: torch.from_numpy(np.array(d[k])) for k in _STATE_ARRAYS},
                       tracers=None if tr is None else torch.from_numpy(np.array(tr)))


def struct_state_to_numpy(state: StructState) -> dict:
    d = {k: getattr(state, k).cpu().numpy() for k in _STATE_ARRAYS}
    if state.tracers is not None:
        d["tracers"] = state.tracers.cpu().numpy()
    return d


# ---- stencils --------------------------------------------------------------
def _shift(x: torch.Tensor, dm: int, di: int) -> torch.Tensor:
    """out[m, i] = x[m + dm, i + di] on a (ny2, nx, ...) plane, periodic."""
    if dm:
        x = torch.roll(x, -dm, dims=0)
    if di:
        x = torch.roll(x, -di, dims=1)
    return x


def _neighbor_cell_field(h, fam):
    """h at the canonical-direction neighbor across family fam;
    h is (2, ny2, nx, ...) -> same shape."""
    h0, h1 = h[0], h[1]
    if fam == E:
        return torch.stack([_shift(h0, 0, 1), _shift(h1, 0, 1)])
    if fam == NE:
        return torch.stack([h1, _shift(h0, 1, 1)])
    if fam == NW:
        return torch.stack([_shift(h1, 0, -1), _shift(h0, 1, 0)])
    raise ValueError(fam)


def grad_on_edge(h, mesh: StructMesh):
    """(h[neighbor] - h[c]) / dc for each family -> (3, 2, ny2, nx, ...)."""
    return torch.stack(
        [(_neighbor_cell_field(h, f) - h) / mesh.dc for f in (E, NE, NW)]
    )


def interp_cell_to_edge(h, mesh: StructMesh):
    return torch.stack(
        [0.5 * (_neighbor_cell_field(h, f) + h) for f in (E, NE, NW)]
    )


def _incoming_edge_fields(u):
    """The cell's three non-owned edges: E of the W-neighbor, NE of the
    SW-neighbor, NW of the SE-neighbor (each (2, ny2, nx, ...))."""
    uE, uNE, uNW = u[0], u[1], u[2]
    inc_E = torch.stack([_shift(uE[0], 0, -1), _shift(uE[1], 0, -1)])
    inc_NE = torch.stack([_shift(uNE[1], -1, -1), uNE[0]])
    inc_NW = torch.stack([_shift(uNW[1], -1, 0), _shift(uNW[0], 0, 1)])
    return inc_E, inc_NE, inc_NW


def div_on_cell(u, mesh: StructMesh):
    """Outward-flux divergence of an edge-normal field u (3,2,ny2,nx,...)."""
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(u)
    total = u[0] + u[1] + u[2] - inc_E - inc_NE - inc_NW
    return total * (mesh.dv / mesh.area_cell)


def apply_stencil(x, terms):
    """sum_j w_j * x[f_in, p_in] shifted by (dm, di), per output channel,
    for a static term list (f_out, p_out, f_in, p_in, dm, di, w); x is an
    edge field (3, 2, ny2, nx, ...)."""
    out = [[None, None] for _ in range(3)]
    for (f_out, p_out, f_in, p_in, dm, di, w) in terms:
        contrib = w * _shift(x[f_in, p_in], dm, di)
        cur = out[f_out][p_out]
        out[f_out][p_out] = contrib if cur is None else cur + contrib
    return torch.stack([torch.stack(planes) for planes in out])


def tangential_times_f(u, mesh: StructMesh):
    """TRiSK Coriolis accumulation sum_j w_j * (u * f)[eoe_j] as 60 static
    roll-multiply-adds (stencil machine-extracted in hex_layout.py)."""
    return apply_stencil(u * mesh.f_edge[..., None], mesh.coriolis_terms)


def kinetic_energy_cell(u, mesh: StructMesh):
    """KE_c = (dc dv / 4 A_c) sum over the cell's 6 edges of u_e^2 (JAX
    model.py:131-138; dc, dv and A are uniform scalars here)."""
    sq = u * u
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(sq)
    total = sq[0] + sq[1] + sq[2] + inc_E + inc_NE + inc_NW
    return total * (0.25 * mesh.dc * mesh.dv / mesh.area_cell)


def cell_to_vertex_kite(h, mesh: StructMesh):
    """Kite-area cell->vertex average -> (2, 2, ny2, nx, ...) from the
    machine-extracted stencil (JAX model.py:141-157). On a channel the
    static 1/3 weights are replaced by the kite planes renormalised over
    live cells (partial kites at boundary vertices, zero at dead ones)."""
    kw = mesh.vertex_kite_planes
    out = [[None, None], [None, None]]
    for t, (kind, p_out, p_in, dm, di, w) in enumerate(mesh.vertex_cell_terms):
        wgt = w if kw is None else kw[t].reshape(kw[t].shape + (1,) * (h.ndim - 3))
        contrib = wgt * _shift(h[p_in], dm, di)
        cur = out[kind][p_out]
        out[kind][p_out] = contrib if cur is None else cur + contrib
    return torch.stack([torch.stack(planes) for planes in out])


def curl_on_vertex(u, mesh: StructMesh):
    """Relative vorticity at vertices -> (2, 2, ny2, nx, ...) (JAX
    model.py:222-235):

    curl_A(c) = dc/A_tri * (u_NE(c) - u_E(NW(c)) - u_NW(c))
    curl_B(c) = dc/A_tri * (u_E(c) + u_NW(E(c)) - u_NE(c))
    """
    uE, uNE, uNW = u[0], u[1], u[2]
    e_of_nw = torch.stack([_shift(uE[1], 0, -1), _shift(uE[0], 1, 0)])
    nw_of_e = torch.stack([_shift(uNW[0], 0, 1), _shift(uNW[1], 0, 1)])
    area_tri = mesh.area_cell * 0.5
    curl_a = (uNE - e_of_nw - uNW) * (mesh.dc / area_tri)
    curl_b = (uE + nw_of_e - uNE) * (mesh.dc / area_tri)
    return torch.stack([curl_a, curl_b])


def pv_on_vertex_struct(u, h, mesh: StructMesh):
    """q_v = (f_v + zeta_v) / h_v (JAX model.py:160-172). On a channel the
    division is guarded at dead vertices (vertex_mask = 0), whose PV is 0."""
    zeta = curl_on_vertex(u, mesh)
    h_v = cell_to_vertex_kite(h, mesh)
    if mesh.vertex_mask is None:
        return (mesh.f_vertex[..., None] + zeta) / h_v
    vm = mesh.vertex_mask.reshape(mesh.vertex_mask.shape + (1,) * (h_v.ndim - 4))
    safe = torch.where(vm > 0, h_v, torch.ones_like(h_v))
    return (mesh.f_vertex[..., None] + zeta) / safe * vm


def check_nl_mesh(mesh: StructMesh) -> None:
    """Raise unless the mesh carries what the nonlinear core reads (JAX
    model.py:175-186): the vertex stencils and f_vertex, and on a channel
    the masked vertex constants."""
    if not mesh.vertex_cell_terms or mesh.f_vertex is None:
        raise ValueError("StructMesh lacks the vertex stencils of the nonlinear core; "
                         "build it through StructuredModel, whose HexLayout extracts them")
    if mesh.edge_mask is not None and (mesh.vertex_kite_planes is None
                                       or mesh.vertex_mask is None):
        raise NotImplementedError(
            "wall-masked nonlinear dynamics need the masked vertex constants "
            "(vertex_kite_planes, vertex_mask): build the StructMesh through "
            "StructuredModel(parent_horz=..., keep_cells=...)")


def vertex_to_edge_mean(v, mesh: StructMesh):
    """Endpoint mean of a vertex field -> (3, 2, ny2, nx, ...) (JAX
    model.py:189-197)."""
    out = [[None, None] for _ in range(3)]
    for (f_out, p_out, kind, p_in, dm, di) in mesh.edge_vertex_terms:
        contrib = _shift(v[kind, p_in], dm, di)
        cur = out[f_out][p_out]
        out[f_out][p_out] = contrib if cur is None else cur + contrib
    return 0.5 * torch.stack([torch.stack(planes) for planes in out])


def tangential_weights_only(x, mesh: StructMesh):
    """sum_j w_j x[eoe_j]: the Coriolis stencil without f (JAX
    model.py:200-209), which the PV flux applies to the thickness flux."""
    return apply_stencil(x, mesh.coriolis_terms)


def _wall(u, mesh: StructMesh):
    """u with the wall mask applied: u = 0 on wall and culled edges (JAX
    model.py:328-329, 473-474); u itself on a periodic lattice."""
    return u if mesh.edge_mask is None else u * mesh.edge_mask[..., None]


def pressure_tendency(ssh, h, mesh: StructMesh, strat: Stratification | None = None):
    """The momentum equation's pressure term of ``ssh`` and ``h`` (the old
    state's for FE, the fresh ones for FB): -g grad ssh, broadcast over the
    levels, or with ``strat`` -grad Phi of the layers' Montgomery potential
    Phi = g ssh + h @ W (JAX model.py:289-298, 445-450)."""
    if strat is None:
        return -GRAVITY * grad_on_edge(ssh, mesh)[..., None]
    return -grad_on_edge(montgomery_potential(ssh, h, strat), mesh)


def _tend_u(state: StructState, flux, tend_p, mesh: StructMesh, nonlinear: bool):
    """The momentum tendency, in the JAX package's order (model.py:289-313):
    the pressure term ``tend_p`` (``pressure_tendency`` of the old or the
    fresh state), plus the TRiSK Coriolis term of u f, or with ``nonlinear``
    minus grad KE plus the symmetrised PV flux (q_e T(F) + T(F q_e)) / 2 of
    the thickness flux F."""
    tend_u = tend_p
    u = state.normal_velocity
    if not nonlinear:
        return tend_u + tangential_times_f(u, mesh)
    check_nl_mesh(mesh)
    q_e = vertex_to_edge_mean(pv_on_vertex_struct(u, state.layer_thickness, mesh), mesh)
    tend_u = tend_u - grad_on_edge(kinetic_energy_cell(u, mesh), mesh)
    return tend_u + 0.5 * (q_e * tangential_weights_only(flux, mesh)
                           + tangential_weights_only(flux * q_e, mesh))


def tracer_tendency_struct(tracers, flux, mesh: StructMesh, kappa: float, upwind: float,
                           h_edge):
    """d(hT)/dt on the lattice (JAX model.py:236-259, models/tracers.py's
    tracer_tendency as rolls): -div(F T_e) + div(kappa h_e grad T), T_e =
    mean(T) - (upwind / 2) dc sign(F) grad T. ``tracers`` (2, ny2, nx, nT,
    K), ``flux`` and ``h_edge`` (3, 2, ny2, nx, K). Wall edges carry no
    advective flux (u = 0 there) and the diffusive flux is masked by the
    wall mask. kappa = 0 and upwind = 0 skip their terms."""
    t_e = interp_cell_to_edge(tracers, mesh)  # (3, 2, ny2, nx, nT, K)
    g = None
    if upwind or kappa:
        g = grad_on_edge(tracers, mesh)
    if upwind:
        t_e = t_e - (0.5 * upwind * mesh.dc) * torch.sign(flux[..., None, :]) * g
    fl = flux[..., None, :] * t_e
    if kappa:
        diff = kappa * h_edge
        if mesh.edge_mask is not None:
            diff = diff * mesh.edge_mask[..., None]
        fl = fl - diff[..., None, :] * g
    return -div_on_cell(fl, mesh)


def tracer_concentration_struct(content, h, cell_mask):
    """T = content / h on live cells (JAX model.py:262-270): on a channel
    the division is guarded on culled cells (``cell_mask`` 0), where T is
    0."""
    if cell_mask is None:
        return content / h[..., None, :]
    mask = cell_mask[..., None, None]
    safe_h = torch.where(mask > 0, h[..., None, :], torch.ones_like(h)[..., None, :])
    return content / safe_h * mask


def _tracers(state: StructState, flux, h_edge, h, mesh: StructMesh, dt, kappa, upwind):
    """The new tracer concentrations of a step whose continuity update took
    h to ``h`` (JAX model.py:331-341, 475-485): the content h T of the old
    state plus dt times the tendency of the old flux, over the fresh h; None
    without tracers."""
    if state.tracers is None:
        return None
    tend_t = tracer_tendency_struct(state.tracers, flux, mesh, kappa, upwind, h_edge)
    content = state.layer_thickness[..., None, :] * state.tracers + dt * tend_t
    return tracer_concentration_struct(content, h, mesh.cell_mask)


def _forced(tend_u, state: StructState, h_edge, forcing):
    """tend_u plus the momentum forcing of the old u on the old state's
    h_edge (JAX model.py:315-323, 476-480), or tend_u unforced."""
    if forcing is None:
        return tend_u
    return tend_u + forcing_tendency(state.normal_velocity, h_edge, forcing)


def structured_step(state: StructState, mesh: StructMesh, dt, nonlinear: bool = False,
                    forcing: Forcing | None = None, tracer_kappa: float = 0.0,
                    tracer_upwind: float = 1.0,
                    strat: Stratification | None = None) -> StructState:
    """One forward-Euler step, all rolls + elementwise
    (mpas_ocean_tpu/structured/model.py:272-341): the linear core, or
    with ``nonlinear`` the vector-invariant momentum equation; ``forcing``
    (struct layout, ``StructuredModel.to_struct_forcing``) adds wind stress,
    bottom drag and Rayleigh damping to the momentum tendency; ``strat``
    takes each layer's pressure gradient from its Montgomery potential of
    the old state (``pressure_tendency``); the wall mask where the mesh has
    one. The state's tracers, if any, are advected by the step's thickness
    flux with ``tracer_upwind`` and mixed with diffusivity ``tracer_kappa``
    (m^2/s)."""
    h_edge = interp_cell_to_edge(state.layer_thickness, mesh)
    flux = state.normal_velocity * h_edge
    tend_h = -div_on_cell(flux, mesh)

    tend_p = pressure_tendency(state.ssh, state.layer_thickness, mesh, strat)
    tend_u = _tend_u(state, flux, tend_p, mesh, nonlinear)
    tend_u = _forced(tend_u, state, h_edge, forcing)

    h = state.layer_thickness + dt * tend_h
    u = _wall(state.normal_velocity + dt * tend_u, mesh)
    ssh = h.sum(-1) - mesh.resting_thickness_sum
    tracers = _tracers(state, flux, h_edge, h, mesh, dt, tracer_kappa, tracer_upwind)
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u, tracers=tracers)


def structured_fb_step(state: StructState, mesh: StructMesh, dt, nonlinear: bool = False,
                       forcing: Forcing | None = None, tracer_kappa: float = 0.0,
                       tracer_upwind: float = 1.0,
                       strat: Stratification | None = None) -> StructState:
    """One forward-backward step (mpas_ocean_tpu/structured/model.py:
    433-485): the continuity update first, then the pressure gradient of
    the fresh ssh (with ``strat``, of the fresh ssh and h's Montgomery
    potential) and the other momentum terms (Coriolis, or with
    ``nonlinear`` the vector-invariant ones, and the ``forcing``) of the old
    state; the wall mask last. The tracers, as in ``structured_step``, take
    the old state's flux and the fresh h."""
    h_edge = interp_cell_to_edge(state.layer_thickness, mesh)
    flux = state.normal_velocity * h_edge
    h = state.layer_thickness + dt * (-div_on_cell(flux, mesh))
    ssh = h.sum(-1) - mesh.resting_thickness_sum

    tend_u = _tend_u(state, flux, pressure_tendency(ssh, h, mesh, strat), mesh, nonlinear)
    tend_u = _forced(tend_u, state, h_edge, forcing)
    u = _wall(state.normal_velocity + dt * tend_u, mesh)
    tracers = _tracers(state, flux, h_edge, h, mesh, dt, tracer_kappa, tracer_upwind)
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u, tracers=tracers)


def structured_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int,
    nonlinear: bool = False, fb: bool = False, forcing: Forcing | None = None,
    tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    strat: Stratification | None = None,
) -> StructState:
    """n_steps steps of ``structured_step`` (forward Euler) or, with
    ``fb=True``, of ``structured_fb_step`` (forward-backward); ``nonlinear``
    runs the vector-invariant momentum equation, ``forcing`` adds the
    momentum forcing, ``strat`` the layered stratification's pressure, and
    the state's tracers, if any, are carried with ``tracer_kappa`` and
    ``tracer_upwind`` (JAX model.py:488-507). A mesh without the vertex
    constants, asked for nonlinear, raises."""
    step = structured_fb_step if fb else structured_step
    if nonlinear:
        check_nl_mesh(mesh)
    for _ in range(n_steps):
        state = step(state, mesh, dt, nonlinear, forcing, tracer_kappa, tracer_upwind, strat)
    return state


def _masked_vertex_constants(lay: HexLayout, keep: np.ndarray, dtype):
    """The nonlinear core's constants on a channel (JAX model.py:566-590):
    each kite tap's weight times its cell's liveness, renormalised over the
    vertex's live taps (uniform kites, so the weight is proportional to the
    periodic stencil's), one plane per tap (12, ny2, nx); and the vertex
    mask (2, 2, ny2, nx), 1 where a vertex has a live cell."""
    keep_struct = lay.cells_to_struct(keep.astype(np.float64))
    vt = lay.vertex_cell_terms
    live = np.stack([
        w * np.roll(np.roll(keep_struct[p_in], -dm, axis=0), -di, axis=1)
        for (_, _, p_in, dm, di, w) in vt
    ])  # (n_terms, ny2, nx)
    sums = np.zeros((2, 2) + keep_struct.shape[1:])
    for t, (kind, p_out, *_) in enumerate(vt):
        sums[kind, p_out] += live[t]
    safe = np.where(sums > 0, sums, 1.0)
    planes = np.stack([live[t] / safe[vt[t][0], vt[t][1]] for t in range(len(vt))])
    return planes.astype(dtype), (sums > 0).astype(dtype)


class StructuredModel(nn.Module):
    """Fast path for uniform hex lattices: fully periodic, or coastal
    channels carved out of a periodic parent by cell culling.

    Built from an unstructured Mesh; converts state in and out of the
    lattice layout on the host and holds the lattice constants (``f_edge``,
    ``rts``, the metric scalars, the Coriolis term tables, the nonlinear
    core's ``f_vertex`` and, on a channel, the wall masks and the masked
    vertex constants) as buffers on ``device``. ``device=None`` means the card
    ("cuda"), and raises where there is none; the plain version runs on the
    host only for ``device="cpu"``.

    Channel form (mpas_ocean_tpu/structured/model.py:524-566, 633-700): pass
    the periodic ``parent_horz`` the culled mesh was carved from
    (``mesh.cull_cells``) and its ``keep_cells`` mask. The lattice then
    covers the whole parent; culled cells and edges are dead slots, with
    h = 0 and rts = 0, and the steps pin u to exactly 0 on wall and dead
    edges through ``StructMesh.edge_mask``, so the walls behave as the
    culled mesh's do.
    """

    def __init__(self, mesh, nx: int, ny: int, device=None, *, parent_horz=None,
                 keep_cells=None):
        super().__init__()
        if (parent_horz is None) != (keep_cells is None):
            raise ValueError("parent_horz and keep_cells go together")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "StructuredModel builds on the CUDA card by default and "
                    "torch.cuda.is_available() is false; pass device='cpu' "
                    "to run the plain version on the host"
                )
            device = "cuda"
        horz, vert = mesh.horz, mesh.vert
        lattice_horz = horz if parent_horz is None else parent_horz
        self.layout = HexLayout(lattice_horz, nx, ny)
        lay = self.layout
        dtype = np.asarray(lattice_horz.cells.area_cell).dtype
        self.nx, self.ny2, self.n_vert_levels = nx, ny // 2, vert.n_vert_levels
        self.coriolis_terms = tuple(
            (t.f_out, t.p_out, t.f_in, t.p_in, t.dm, t.di, t.w)
            for t in lay.coriolis_terms
        )
        # uniformity requirements for the scalar metric shortcut
        dv_edge = np.asarray(lattice_horz.edges.dv_edge)
        area = np.asarray(lattice_horz.cells.area_cell)
        if not (np.allclose(dv_edge, dv_edge[0]) and np.allclose(area, area[0])):
            raise ValueError("lattice metrics are not uniform")

        def buf(name, a):
            if a is not None:
                a = torch.from_numpy(np.ascontiguousarray(a)).to(device)
            self.register_buffer(name, a)

        self._n_parent_cells = lattice_horz.n_cells
        self._n_parent_edges = lattice_horz.n_edges
        self.vertex_cell_terms = lay.vertex_cell_terms
        self.edge_vertex_terms = lay.edge_vertex_terms
        edge_mask = cell_mask = kite_planes = vertex_mask = None
        rts_cells = np.asarray(vert.resting_thickness_sum)
        if parent_horz is None:
            self.cell_gids = self.edge_gids = None
        else:
            keep = np.asarray(keep_cells, dtype=bool)
            if int(keep.sum()) != horz.n_cells:
                raise ValueError("keep_cells does not match the culled mesh")
            self.cell_gids = np.flatnonzero(keep)
            coe = np.asarray(parent_horz.edges.cells_on_edge)
            keep_edge = keep[coe].any(axis=1)
            if int(keep_edge.sum()) != horz.n_edges:
                raise ValueError("culled mesh was not built from keep_cells")
            self.edge_gids = np.flatnonzero(keep_edge)
            if not np.allclose(np.asarray(horz.cells.x),
                               np.asarray(parent_horz.cells.x)[self.cell_gids]):
                raise ValueError("the culled mesh's cells are not keep_cells' cells")
            # interior edges (two live cells) keep their dynamics; wall
            # edges (one live cell) and dead edges are pinned to u = 0
            edge_mask = lay.edges_to_struct(keep[coe].all(axis=1).astype(dtype))
            cell_mask = lay.cells_to_struct(keep.astype(dtype))
            rts_cells = self._cells_to_parent(rts_cells.astype(dtype))
            kite_planes, vertex_mask = _masked_vertex_constants(lay, keep, dtype)

        buf("dc", dtype.type(lay.dc))
        buf("dv", dtype.type(dv_edge[0]))
        buf("area_cell", dtype.type(area[0]))
        buf("f_edge", lay.edges_to_struct(np.asarray(lattice_horz.edges.f)))
        buf("rts", lay.cells_to_struct(rts_cells))
        buf("edge_mask", edge_mask)
        buf("cell_mask", cell_mask)
        buf("f_vertex", lay.vertices_to_struct(np.asarray(lattice_horz.duals.f)))
        buf("vertex_kite_planes", kite_planes)
        buf("vertex_mask", vertex_mask)
        # the Coriolis stencil and its transpose, packed: on the buffers'
        # device, and the host copies the kernels take
        packed = packed_stencils(self.coriolis_terms, dtype)
        for name, a in packed.items():
            buf(name, a)
        self.host_stencil = _host_stencil(packed)
        self.host_adjoint_stencil = _host_stencil(packed, "adjoint_")

    @property
    def struct_mesh(self) -> StructMesh:
        """The lattice constants as a StructMesh, on the buffers' device."""
        return StructMesh(
            nx=self.nx,
            ny2=self.ny2,
            n_vert_levels=self.n_vert_levels,
            coriolis_terms=self.coriolis_terms,
            dc=self.dc,
            dv=self.dv,
            area_cell=self.area_cell,
            f_edge=self.f_edge,
            resting_thickness_sum=self.rts,
            stencil_table=self.stencil_table,
            coriolis_weight=self.coriolis_weight,
            adjoint_table=self.adjoint_table,
            adjoint_weight=self.adjoint_weight,
            host_stencil=self.host_stencil,
            host_adjoint_stencil=self.host_adjoint_stencil,
            edge_mask=self.edge_mask,
            cell_mask=self.cell_mask,
            vertex_cell_terms=self.vertex_cell_terms,
            edge_vertex_terms=self.edge_vertex_terms,
            f_vertex=self.f_vertex,
            vertex_kite_planes=self.vertex_kite_planes,
            vertex_mask=self.vertex_mask,
        )

    # -- culled <-> parent embedding (identity on a periodic lattice) -----
    def _cells_to_parent(self, field: np.ndarray) -> np.ndarray:
        if self.cell_gids is None:
            return field
        out = np.zeros((self._n_parent_cells,) + field.shape[1:], field.dtype)
        out[self.cell_gids] = field
        return out

    def _edges_to_parent(self, field: np.ndarray) -> np.ndarray:
        if self.edge_gids is None:
            return field
        out = np.zeros((self._n_parent_edges,) + field.shape[1:], field.dtype)
        out[self.edge_gids] = field
        return out

    def to_struct(self, prog: PrognosticVars) -> StructState:
        """Unstructured state -> lattice state on the buffers' device (the
        permutation runs on the host). On a channel the culled cells and
        edges are embedded as zeros, and u is pinned to 0 on masked edges,
        the wall condition the culled mesh's state carries (JAX
        model.py:652-655). Tracers (nCells, nT, K), where the state has
        them, become (2, ny2, nx, nT, K), zero on culled cells."""
        lay = self.layout
        dev = self.f_edge.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def cells(x):
            return lay.cells_to_struct(self._cells_to_parent(x.cpu().numpy()))

        u = lay.edges_to_struct(
            self._edges_to_parent(prog.normal_velocity.cpu().numpy()), sign=True)
        if self.edge_mask is not None:
            u = u * self.edge_mask.cpu().numpy()[..., None]
        return StructState(
            ssh=put(cells(prog.ssh)),
            layer_thickness=put(cells(prog.layer_thickness)),
            normal_velocity=put(u),
            tracers=None if prog.tracers is None else put(cells(prog.tracers)),
        )

    def to_struct_forcing(self, forcing: Forcing) -> Forcing:
        """Unstructured Forcing -> lattice Forcing on the buffers' device (JAX
        model.py:695-720): the wind stress is a signed edge quantity
        (``sign=True``, as the velocity), the level masks are not. On a
        channel the culled edges are embedded as zeros, so dead slots are
        forced by nothing."""
        lay = self.layout
        dev = self.f_edge.device

        def edges(x, sign=False):
            a = lay.edges_to_struct(self._edges_to_parent(x.detach().cpu().numpy()), sign=sign)
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return Forcing(
            wind_edge=edges(forcing.wind_edge, sign=True),
            top_mask=edges(forcing.top_mask),
            bottom_mask=edges(forcing.bottom_mask),
            drag_linear=forcing.drag_linear.to(dev),
            drag_quadratic=forcing.drag_quadratic.to(dev),
            rayleigh=forcing.rayleigh.to(dev),
        )

    def from_struct(self, state: StructState) -> PrognosticVars:
        """Lattice state -> unstructured state, as CPU tensors; on a channel,
        the culled mesh's cells and edges only; tracers where the state has
        them."""
        lay = self.layout
        ssh = lay.cells_from_struct(state.ssh.cpu().numpy())
        h = lay.cells_from_struct(state.layer_thickness.cpu().numpy())
        u = lay.edges_from_struct(state.normal_velocity.cpu().numpy(), sign=True)
        tr = None if state.tracers is None else lay.cells_from_struct(state.tracers.cpu().numpy())
        if self.cell_gids is not None:
            ssh, h, u = ssh[self.cell_gids], h[self.cell_gids], u[self.edge_gids]
            tr = None if tr is None else tr[self.cell_gids]
        return PrognosticVars(
            ssh=torch.from_numpy(np.ascontiguousarray(ssh)),
            layer_thickness=torch.from_numpy(np.ascontiguousarray(h)),
            normal_velocity=torch.from_numpy(np.ascontiguousarray(u)),
            tracers=None if tr is None else torch.from_numpy(np.ascontiguousarray(tr)),
        )
