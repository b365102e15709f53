"""Surface and bottom momentum forcing: wind stress, bottom drag, Rayleigh
damping.

Counterpart of mpas_ocean_tpu/models/forcing.py (``RHO0``, ``Forcing``,
``make_forcing``, ``forcing_tendency``), as torch tensors:

    du/dt +=  top_mask    * (tau . n) / (rho0 * h_edge)       wind stress
    du/dt += -bottom_mask * (r_lin * u + Cd * |u| * u / h)    bottom drag
    du/dt += -lambda * u                                      Rayleigh

Every term is elementwise in (edge, level) once the wind stress is projected
onto the edge normals and the one-hot top and bottom level masks are built,
so the same ``forcing_tendency`` runs on the unstructured layout (nEdges, K)
and on the lattice's (3, 2, ny2, nx, K) (``StructuredModel.to_struct_forcing``).
The quadratic drag uses the local normal speed |u_e|, as the JAX package
does.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

__all__ = ["RHO0", "Forcing", "forcing_core", "forcing_from_numpy", "forcing_tendency",
           "forcing_to_numpy", "level_onehot", "make_forcing"]

# MPAS-Ocean's reference seawater density [kg/m^3]
RHO0 = 1026.0


@dataclass(frozen=True)
class Forcing:
    """Momentum forcing, layout-agnostic. ``wind_edge`` is the kinematic
    normal wind stress tau.n / rho0 [m^2/s^2] at the edges; ``top_mask`` and
    ``bottom_mask`` one-hot selectors (edges..., K) of the first and last
    active level (zero on closed edges); the three coefficients 0-d tensors:
    ``drag_linear`` [1/s], ``drag_quadratic`` = Cd, ``rayleigh`` [1/s]."""

    wind_edge: torch.Tensor
    top_mask: torch.Tensor
    bottom_mask: torch.Tensor
    drag_linear: torch.Tensor
    drag_quadratic: torch.Tensor
    rayleigh: torch.Tensor

    def to(self, device) -> "Forcing":
        return Forcing(*(getattr(self, f.name).to(device) for f in fields(self)))


def make_forcing(mesh, *, wind_stress_zonal=0.0, wind_stress_meridional=0.0,
                 wind_stress_edge=None, bottom_drag_linear: float = 0.0,
                 bottom_drag_quadratic: float = 0.0, rayleigh: float = 0.0,
                 rho0: float = RHO0, dtype=None) -> Forcing:
    """A :class:`Forcing` for ``mesh`` (JAX models/forcing.py:59-130, bit for
    bit). The wind stress [Pa] is zonal and meridional scalars or per-cell
    (nCells,) arrays, averaged to the edges and projected onto the edge
    normals by ``angle_edge``, or the projected ``wind_stress_edge``
    (nEdges,). The wind hits each edge's first active level, the larger of
    its two cells' ``min_level_cell``, and the drag its last,
    ``max_level_edge_top - 1``; an edge with no active level, or closed
    (``edge_mask`` 0), is forced by neither. ``dtype`` defaults to the mesh's
    float dtype."""
    horz, vert = mesh.horz, mesh.vert
    edges = horz.edges
    n_edges = edges.n_edges
    k = vert.n_vert_levels
    if dtype is None:
        dtype = np.asarray(horz.cells.area_cell).dtype
    if wind_stress_edge is not None:
        tau_n = np.asarray(wind_stress_edge, dtype=np.float64)
        if tau_n.shape != (n_edges,):
            raise ValueError(f"wind_stress_edge must be (nEdges,)={n_edges}, got {tau_n.shape}")
    else:
        coe = np.asarray(edges.cells_on_edge)

        def at_edges(x):
            x = np.asarray(x, dtype=np.float64)
            if x.ndim == 0:
                return np.full(n_edges, float(x))
            if x.shape == (horz.cells.n_cells,):
                return 0.5 * (x[coe[:, 0]] + x[coe[:, 1]])
            if x.shape == (n_edges,):
                return x
            raise ValueError(f"wind stress shape {x.shape} not understood")

        angle = np.asarray(edges.angle_edge, dtype=np.float64)
        tau_n = (at_edges(wind_stress_zonal) * np.cos(angle)
                 + at_edges(wind_stress_meridional) * np.sin(angle))
    coe = np.asarray(edges.cells_on_edge)
    min_lc = np.asarray(vert.min_level_cell)
    top = np.maximum(min_lc[coe[:, 0]], min_lc[coe[:, 1]])
    bot = np.asarray(vert.max_level_edge_top) - 1  # one past the last -> the last
    lv = np.arange(k)[None, :]
    emask = np.asarray(edges.edge_mask, dtype=np.float64)
    active = bot >= top
    top_mask = (lv == top[:, None]) & active[:, None]
    bottom_mask = (lv == bot[:, None]) & active[:, None]

    def tensor(x):
        return torch.from_numpy(np.array(x, dtype=dtype))

    return Forcing(
        wind_edge=tensor((tau_n / rho0) * emask),
        top_mask=tensor(top_mask * emask[:, None]),
        bottom_mask=tensor(bottom_mask * emask[:, None]),
        drag_linear=tensor(bottom_drag_linear),
        drag_quadratic=tensor(bottom_drag_quadratic),
        rayleigh=tensor(rayleigh),
    )


def forcing_core(u, h_edge, wind, top, bot, drag_linear, drag_quadratic, rayleigh):
    """The forcing tendency from its parts, operation for operation as
    ``forcing_tendency`` (and sharded._forcing_core): one shared reciprocal
    of h_edge, 1 where h_edge <= 0 (the masks are 0 there); the wind on the
    top mask, the linear and quadratic drag on the bottom mask, Rayleigh
    everywhere."""
    inv_h = torch.ones_like(h_edge) / torch.where(h_edge > 0, h_edge, torch.ones_like(h_edge))
    tend = top * (wind * inv_h)
    tend = tend - bot * (drag_linear * u + drag_quadratic * torch.abs(u) * u * inv_h)
    return tend - rayleigh * u


def forcing_tendency(normal_velocity: torch.Tensor, h_edge: torch.Tensor,
                     forcing: Forcing) -> torch.Tensor:
    """The momentum forcing tendency, elementwise in (edge, level), on any
    layout whose last axis is the levels (JAX models/forcing.py:133-161)."""
    wind = forcing.wind_edge
    if wind.ndim != normal_velocity.ndim:
        wind = wind[..., None]
    return forcing_core(normal_velocity, h_edge, wind, forcing.top_mask, forcing.bottom_mask,
                        forcing.drag_linear, forcing.drag_quadratic, forcing.rayleigh)


def level_onehot(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-edge level index plane (..., 1), -1 for no level, expanded into
    the one-hot (..., K) mask it encodes, in ``like``'s dtype
    (sharded._level_onehot): exactly 0 and 1, so products are bitwise those
    of the dense mask."""
    lvl = torch.arange(like.shape[-1], device=like.device)
    return (lvl == idx).to(like.dtype)


_FIELDS = ("wind_edge", "top_mask", "bottom_mask", "drag_linear", "drag_quadratic",
           "rayleigh")


def forcing_from_numpy(d: dict) -> Forcing:
    """A Forcing from a dict of the JAX Forcing's fields as numpy arrays, bit
    for bit."""
    return Forcing(**{f: torch.from_numpy(np.array(d[f])) for f in _FIELDS})


def forcing_to_numpy(forcing: Forcing) -> dict:
    return {f: getattr(forcing, f).detach().cpu().numpy() for f in _FIELDS}
