"""Tracer transport: cell tracers (temperature, salinity, any passive
field) carried as content h T, advected by the thickness flux and mixed by
optional del2 diffusion.

Counterpart of mpas_ocean_tpu/models/tracers.py (``make_tracers``,
``tracer_concentration``, ``apply_tracer_update``,
``total_tracer_content``, :60-86, 136-172), as torch tensors. The flux-form
equation

    d(h T)/dt = -div(F T_e) + div(kappa h_e grad T),   F = h_e u,

with the edge value T_e = mean(T) - (upwind / 2) sign(F) dc grad T (centered
at upwind = 0, donor cell at 1), runs on the lattice in
structured/model.py (``tracer_tendency_struct``), structured/slab.py and the
kernels' tracer arms. Tracer arrays are (nCells, nTracers, K): cells first,
levels last, the tracer axis between.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["apply_tracer_update", "make_tracers", "total_tracer_content",
           "tracer_concentration"]


def make_tracers(mesh, fields, dtype=None) -> torch.Tensor:
    """Stack per-cell tracer fields into the (nCells, nT, K) tracer array
    (JAX models/tracers.py:60-86, bit for bit). ``fields``: a sequence of
    arrays, each (nCells,) (the same on every level) or (nCells, K);
    inactive levels (below the bathymetry) are zeroed. ``dtype`` defaults to
    the mesh's float dtype."""
    vert = mesh.vert if hasattr(mesh, "vert") else None
    horz = mesh.horz if hasattr(mesh, "horz") else mesh
    nc = horz.cells.n_cells
    k = vert.n_vert_levels if vert is not None else 1
    cols = []
    for f in fields:
        a = np.asarray(f, dtype=np.float64)
        if a.shape == (nc,):
            a = np.repeat(a[:, None], k, axis=1)
        if a.shape != (nc, k):
            raise ValueError(f"tracer field must be ({nc},) or ({nc}, {k}); got {a.shape}")
        cols.append(a)
    out = np.stack(cols, axis=1)  # (nC, nT, K)
    if vert is not None:
        out = out * np.asarray(vert.cell_level_mask)[:, None, :]
    if dtype is None:
        dtype = np.asarray(horz.cells.area_cell).dtype
    return torch.from_numpy(out.astype(dtype))


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def tracer_concentration(content: torch.Tensor, h: torch.Tensor,
                         cell_level_mask) -> torch.Tensor:
    """T = content / h on active levels (content is h T; (nCells, nT, K)):
    live cells divide by h unconditionally, inactive levels stay exactly
    zero."""
    mask = _as_tensor(cell_level_mask, h)[:, None, :]
    safe_h = torch.where(mask > 0, h[:, None, :], torch.ones_like(mask))
    return content / safe_h * mask


def apply_tracer_update(tracers: torch.Tensor, h_old: torch.Tensor, h_new: torch.Tensor,
                        tend_hT: torch.Tensor, dt, cell_level_mask) -> torch.Tensor:
    """T_new = (h_old T + dt d(hT)/dt) / h_new on active levels: the content
    h T is what the flux form conserves; the carried state is the
    concentration, derived again after the continuity update."""
    content = h_old[:, None, :] * tracers + dt * tend_hT
    return tracer_concentration(content, h_new, cell_level_mask)


def total_tracer_content(tracers: torch.Tensor, layer_thickness: torch.Tensor,
                         mesh) -> torch.Tensor:
    """sum over cells and levels of A_c h T, per tracer, (nT,): the integral
    the flux form conserves on a periodic or walled mesh."""
    act = layer_thickness * _as_tensor(mesh.vert.cell_level_mask, layer_thickness)
    area = _as_tensor(mesh.horz.cells.area_cell, layer_thickness)
    return torch.einsum("cnk,ck,c->n", tracers, act, area)
