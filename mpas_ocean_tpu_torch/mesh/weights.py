"""TRiSK tangential-reconstruction weights (Thuburn et al. 2009 /
Ringler et al. 2010), geometry-agnostic.

Given any mesh's CCW cell cycles, kite areas, and edge metrics — planar or
spherical — produce edgesOnEdge + weightsOnEdge such that
  u_perp[e] = sum_j w[e,j] * u[eoe[e,j]]
reconstructs the tangential velocity, conserves energy in the Coriolis
force (antisymmetry), and is exact for uniform flow on uniform meshes.

Convention requirements (satisfied by the voronoi.py builder):
  * edges_on_cell CCW; vertices_on_cell[i] between edges i and i+1
  * kite_areas_on_cell aligned with vertices_on_cell
  * edge normal points cells_on_edge[:,0] -> cells_on_edge[:,1]
"""

from __future__ import annotations

import numpy as np

__all__ = ["trisk_weights"]


def trisk_weights(
    cells_on_edge: np.ndarray,  # (nEdges, 2)
    dv_edge: np.ndarray,
    dc_edge: np.ndarray,
    n_edges_on_cell: np.ndarray,  # (nCells,)
    edges_on_cell: np.ndarray,  # (nCells, maxEdges)
    vertices_on_cell: np.ndarray,  # (nCells, maxEdges)
    kite_areas_on_cell: np.ndarray,  # (nCells, maxEdges)
    area_cell: np.ndarray,
):
    """Returns (n_edges_on_edge, edges_on_edge, weights_on_edge) with the
    edges-of-cell-1 block first, then cell 2 (matching MPAS layout)."""
    n_edges = len(cells_on_edge)
    max_edges = edges_on_cell.shape[1]
    max_edges2 = 2 * max_edges

    edges_on_edge = np.zeros((n_edges, max_edges2), dtype=np.int64)
    weights_on_edge = np.zeros((n_edges, max_edges2))
    n_edges_on_edge = np.zeros(n_edges, dtype=np.int32)

    inv_area = 1.0 / np.asarray(area_cell)
    e_ids = np.arange(n_edges)

    for side in (0, 1):
        c = cells_on_edge[:, side]
        m = n_edges_on_cell[c].astype(np.int64)
        row = edges_on_cell[c]
        krow = kite_areas_on_cell[c]
        pos = np.argmax(row == e_ids[:, None], axis=1)
        j = np.arange(1, max_edges)[None, :]
        valid = j < m[:, None]
        idx_e = (pos[:, None] + j) % np.maximum(m[:, None], 1)
        idx_v = (pos[:, None] + j - 1) % np.maximum(m[:, None], 1)
        eoe = np.take_along_axis(row, idx_e, axis=1)
        kite = np.take_along_axis(krow, idx_v, axis=1)
        R = np.cumsum(kite * inv_area[c][:, None], axis=1)
        t_sign = np.where(cells_on_edge[eoe, 0] == c[:, None], 1.0, -1.0)
        s_sign = 1.0 if side == 0 else -1.0
        w = s_sign * (0.5 - R) * (dv_edge[eoe] / dc_edge[:, None]) * t_sign
        w = np.where(valid, w, 0.0)
        eoe = np.where(valid, eoe, 0)

        base = n_edges_on_edge.astype(np.int64)
        cols = np.where(valid, base[:, None] + (j - 1), max_edges2 - 1)
        np.put_along_axis(edges_on_edge, cols, eoe, axis=1)
        np.put_along_axis(weights_on_edge, cols, w, axis=1)
        n_edges_on_edge = (base + valid.sum(1)).astype(np.int32)

    return n_edges_on_edge, edges_on_edge, weights_on_edge
