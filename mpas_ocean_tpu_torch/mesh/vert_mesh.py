"""Vertical mesh (counterpart of mpas_ocean_tpu/mesh/vert_mesh.py).

Per-column level bounds plus precomputed dense level masks, as host-side
numpy arrays with the JAX package's field names, order and dtypes.
``max_level_edge_top`` is min(maxLevelCell) of the two adjacent cells, as in
the JAX package (a deliberate fix of the reference's VertMesh.jl:31-36).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .horz_mesh import HorzMesh


@dataclass(frozen=True)
class VerticalMesh:
    n_vert_levels: int

    min_level_cell: np.ndarray  # (nCells,) int32, 0-based first active level
    max_level_cell: np.ndarray  # (nCells,) int32, 1-past-last active level
    max_level_edge_top: np.ndarray  # (nEdges,) int32: min over adjacent cells
    max_level_edge_bot: np.ndarray  # (nEdges,) int32: max over adjacent cells
    max_level_vertex_top: np.ndarray  # (nVertices,) int32
    max_level_vertex_bot: np.ndarray  # (nVertices,) int32

    resting_thickness: np.ndarray  # (nCells, nVertLevels) [m]
    resting_thickness_sum: np.ndarray  # (nCells,)

    # dense {0,1} activity masks in the float dtype of resting_thickness
    cell_level_mask: np.ndarray  # (nCells, nVertLevels)
    edge_level_mask: np.ndarray  # (nEdges, nVertLevels)
    vertex_level_mask: np.ndarray  # (nVertices, nVertLevels)

    bottom_depth: np.ndarray  # (nCells,) resting ocean depth [m]
    vert_coord_movement_weights: np.ndarray  # (nVertLevels,)


def _masks(min_lev, max_lev, n_levels, dtype):
    k = np.arange(n_levels)[None, :]
    return ((k >= min_lev[:, None]) & (k < max_lev[:, None])).astype(dtype)


def make_vertical_mesh(
    horz: HorzMesh,
    n_vert_levels: int = 1,
    resting_thickness=None,
    min_level_cell=None,
    max_level_cell=None,
    dtype=np.float64,
    bottom_depth=None,
    vert_coord_movement_weights=None,
) -> VerticalMesh:
    """Construct a vertical mesh over ``horz``.

    Defaults give a stacked column of unit thickness; pass
    ``resting_thickness`` (nCells, nVertLevels) for real configs.
    """
    n_cells = horz.n_cells

    if min_level_cell is None:
        min_level_cell = np.zeros(n_cells, dtype=np.int32)
    if max_level_cell is None:
        max_level_cell = np.full(n_cells, n_vert_levels, dtype=np.int32)
    if resting_thickness is None:
        resting_thickness = np.ones((n_cells, n_vert_levels), dtype=dtype)
    resting_thickness = np.asarray(resting_thickness, dtype=dtype)
    if resting_thickness.shape != (n_cells, n_vert_levels):
        raise ValueError(
            f"resting_thickness shape {resting_thickness.shape} != "
            f"({n_cells}, {n_vert_levels})"
        )

    coe = np.asarray(horz.edges.cells_on_edge)
    max_lc = np.asarray(max_level_cell)
    min_lc = np.asarray(min_level_cell)
    max_level_edge_top = np.minimum(max_lc[coe[:, 0]], max_lc[coe[:, 1]])
    max_level_edge_bot = np.maximum(max_lc[coe[:, 0]], max_lc[coe[:, 1]])
    cov = np.asarray(horz.duals.cells_on_vertex)
    max_level_vertex_top = np.min(max_lc[cov], axis=1)
    max_level_vertex_bot = np.max(max_lc[cov], axis=1)

    min_le = np.maximum(min_lc[coe[:, 0]], min_lc[coe[:, 1]])
    min_lv = np.max(min_lc[cov], axis=1)

    if bottom_depth is None:
        # flat-rest configs: depth at rest = active resting column sum
        cmask = _masks(min_lc, max_lc, n_vert_levels, dtype)
        bottom_depth = (resting_thickness * cmask).sum(axis=1)
    if vert_coord_movement_weights is None:
        vert_coord_movement_weights = np.ones(n_vert_levels, dtype=dtype)

    return VerticalMesh(
        n_vert_levels=n_vert_levels,
        min_level_cell=min_lc.astype(np.int32),
        max_level_cell=max_lc.astype(np.int32),
        max_level_edge_top=max_level_edge_top.astype(np.int32),
        max_level_edge_bot=max_level_edge_bot.astype(np.int32),
        max_level_vertex_top=max_level_vertex_top.astype(np.int32),
        max_level_vertex_bot=max_level_vertex_bot.astype(np.int32),
        resting_thickness=resting_thickness,
        resting_thickness_sum=resting_thickness.sum(axis=1),
        cell_level_mask=_masks(min_lc, max_lc, n_vert_levels, dtype),
        edge_level_mask=_masks(min_le, max_level_edge_top, n_vert_levels, dtype),
        vertex_level_mask=_masks(min_lv, max_level_vertex_top, n_vert_levels, dtype),
        bottom_depth=np.asarray(bottom_depth, dtype=dtype),
        vert_coord_movement_weights=np.asarray(
            vert_coord_movement_weights, dtype=dtype
        ),
    )
