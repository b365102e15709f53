"""Linear shallow-water core on the structured hex lattice, on torch.roll.

Counterpart of mpas_ocean_tpu/structured/model.py for the periodic linear
core (pressure gradient + TRiSK Coriolis) with forward Euler. This is the
plain PyTorch version of the fused step kernel (kernels/fe_step.py): the CPU
tests hold it against the JAX package, and on the card the kernel is held
against it.

Layout (see hex_layout.py): cell fields (2, ny2, nx, K), edge fields
(3, 2, ny2, nx, K) with canonical family normals at 0/60/120 degrees.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..constants import GRAVITY
from ..models.state import PrognosticVars
from .hex_layout import E, NE, NW, HexLayout
from .stencils import transpose_coriolis_terms

__all__ = [
    "StructMesh",
    "StructState",
    "StructuredModel",
    "apply_stencil",
    "packed_stencils",
    "struct_mesh_from_numpy",
    "struct_mesh_to_numpy",
    "struct_state_from_numpy",
    "struct_state_to_numpy",
    "structured_fb_step",
    "structured_run_loop",
    "structured_step",
]


@dataclass(frozen=True)
class StructState:
    ssh: torch.Tensor  # (2, ny2, nx)
    layer_thickness: torch.Tensor  # (2, ny2, nx, K)
    normal_velocity: torch.Tensor  # (3, 2, ny2, nx, K)

    def to(self, device) -> "StructState":
        return StructState(
            ssh=self.ssh.to(device),
            layer_thickness=self.layer_thickness.to(device),
            normal_velocity=self.normal_velocity.to(device),
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
        )


# ---- carrying the JAX package's lattice inputs across, as numpy ----------
_MESH_ARRAYS = ("dc", "dv", "area_cell", "f_edge", "resting_thickness_sum")
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
    packed from ``coriolis_terms``."""
    terms = tuple(tuple(t) for t in d["coriolis_terms"])
    packed = packed_stencils(terms, np.asarray(d["f_edge"]).dtype)
    return StructMesh(
        nx=int(d["nx"]),
        ny2=int(d["ny2"]),
        n_vert_levels=int(d["n_vert_levels"]),
        coriolis_terms=terms,
        **{k: torch.from_numpy(v) for k, v in packed.items()},
        **{k: torch.from_numpy(np.array(d[k])) for k in _MESH_ARRAYS},
        host_stencil=_host_stencil(packed),
        host_adjoint_stencil=_host_stencil(packed, "adjoint_"),
    )


def struct_mesh_to_numpy(mesh: StructMesh) -> dict:
    d = {
        "nx": mesh.nx,
        "ny2": mesh.ny2,
        "n_vert_levels": mesh.n_vert_levels,
        "coriolis_terms": mesh.coriolis_terms,
    }
    d.update({k: getattr(mesh, k).cpu().numpy() for k in _MESH_ARRAYS})
    return d


def struct_state_from_numpy(d: dict) -> StructState:
    """StructState from a dict of numpy arrays (the JAX StructState's
    fields), bit for bit."""
    return StructState(**{k: torch.from_numpy(np.array(d[k])) for k in _STATE_ARRAYS})


def struct_state_to_numpy(state: StructState) -> dict:
    return {k: getattr(state, k).cpu().numpy() for k in _STATE_ARRAYS}


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


def structured_step(state: StructState, mesh: StructMesh, dt) -> StructState:
    """One forward-Euler step of the linear core, all rolls + elementwise
    (the ``nonlinear=False``, unforced, tracer-free, unstratified arm of
    mpas_ocean_tpu/structured/model.py:272-341)."""
    h_edge = interp_cell_to_edge(state.layer_thickness, mesh)
    flux = state.normal_velocity * h_edge
    tend_h = -div_on_cell(flux, mesh)

    grad_ssh = grad_on_edge(state.ssh, mesh)  # (3, 2, ny2, nx)
    tend_u = -GRAVITY * grad_ssh[..., None]
    tend_u = tend_u + tangential_times_f(state.normal_velocity, mesh)

    h = state.layer_thickness + dt * tend_h
    u = state.normal_velocity + dt * tend_u
    ssh = h.sum(-1) - mesh.resting_thickness_sum
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u)


def structured_fb_step(state: StructState, mesh: StructMesh, dt) -> StructState:
    """One forward-backward step of the linear core (the linear, unforced,
    tracer-free, unstratified arm of mpas_ocean_tpu/structured/model.py:
    433-485): the continuity update first, then the pressure gradient of
    the fresh ssh and the Coriolis term of the old u."""
    h_edge = interp_cell_to_edge(state.layer_thickness, mesh)
    flux = state.normal_velocity * h_edge
    h = state.layer_thickness + dt * (-div_on_cell(flux, mesh))
    ssh = h.sum(-1) - mesh.resting_thickness_sum

    tend_u = -GRAVITY * grad_on_edge(ssh, mesh)[..., None]
    tend_u = tend_u + tangential_times_f(state.normal_velocity, mesh)
    u = state.normal_velocity + dt * tend_u
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u)


def structured_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int, fb: bool = False
) -> StructState:
    """n_steps steps of ``structured_step`` (forward Euler) or, with
    ``fb=True``, of ``structured_fb_step`` (forward-backward)."""
    step = structured_fb_step if fb else structured_step
    for _ in range(n_steps):
        state = step(state, mesh, dt)
    return state


class StructuredModel(nn.Module):
    """Fast path for uniform periodic hex lattices.

    Built from an unstructured Mesh; converts state in and out of the
    lattice layout on the host and holds the lattice constants (``f_edge``,
    ``rts``, the metric scalars and the Coriolis term tables) as buffers on
    ``device``. ``device=None`` means the card ("cuda"), and raises where
    there is none; the plain version runs on the host only for
    ``device="cpu"``. The culled-channel form of the JAX package
    (``parent_horz`` / ``keep_cells``) is not ported yet.
    """

    def __init__(self, mesh, nx: int, ny: int, device=None):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "StructuredModel builds on the CUDA card by default and "
                    "torch.cuda.is_available() is false; pass device='cpu' "
                    "to run the plain version on the host"
                )
            device = "cuda"
        horz, vert = mesh.horz, mesh.vert
        self.layout = HexLayout(horz, nx, ny)
        lay = self.layout
        dtype = np.asarray(horz.cells.area_cell).dtype
        self.nx, self.ny2, self.n_vert_levels = nx, ny // 2, vert.n_vert_levels
        self.coriolis_terms = tuple(
            (t.f_out, t.p_out, t.f_in, t.p_in, t.dm, t.di, t.w)
            for t in lay.coriolis_terms
        )
        # uniformity requirements for the scalar metric shortcut
        dv_edge = np.asarray(horz.edges.dv_edge)
        area = np.asarray(horz.cells.area_cell)
        if not (np.allclose(dv_edge, dv_edge[0]) and np.allclose(area, area[0])):
            raise ValueError("lattice metrics are not uniform")

        def buf(name, a):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(a)).to(device))

        buf("dc", dtype.type(lay.dc))
        buf("dv", dtype.type(dv_edge[0]))
        buf("area_cell", dtype.type(area[0]))
        buf("f_edge", lay.edges_to_struct(np.asarray(horz.edges.f)))
        buf("rts", lay.cells_to_struct(np.asarray(vert.resting_thickness_sum)))
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
        )

    def to_struct(self, prog: PrognosticVars) -> StructState:
        """Unstructured state -> lattice state on the buffers' device (the
        permutation runs on the host)."""
        lay = self.layout
        dev = self.f_edge.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return StructState(
            ssh=put(lay.cells_to_struct(prog.ssh.cpu().numpy())),
            layer_thickness=put(
                lay.cells_to_struct(prog.layer_thickness.cpu().numpy())
            ),
            normal_velocity=put(
                lay.edges_to_struct(prog.normal_velocity.cpu().numpy(), sign=True)
            ),
        )

    def from_struct(self, state: StructState) -> PrognosticVars:
        """Lattice state -> unstructured state, as CPU tensors."""
        lay = self.layout
        ssh = lay.cells_from_struct(state.ssh.cpu().numpy())
        h = lay.cells_from_struct(state.layer_thickness.cpu().numpy())
        u = lay.edges_from_struct(state.normal_velocity.cpu().numpy(), sign=True)
        return PrognosticVars(
            ssh=torch.from_numpy(np.ascontiguousarray(ssh)),
            layer_thickness=torch.from_numpy(np.ascontiguousarray(h)),
            normal_velocity=torch.from_numpy(np.ascontiguousarray(u)),
        )
