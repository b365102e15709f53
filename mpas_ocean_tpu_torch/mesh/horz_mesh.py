"""Horizontal TRiSK mesh as host-side numpy dataclasses.

Counterpart of mpas_ocean_tpu/mesh/horz_mesh.py with the same field names,
order, dtypes and conventions: connectivity is 0-based int32 padded with
index 0, sign fields are float with 0.0 on padded slots, and arrays are
element-major ``(nElem, ...)``. The mesh is built and consumed on the host
(the lattice layout turns it into device tensors), so the containers hold
numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PrimaryCells:
    """Voronoi (polygon) cells of the primary mesh."""

    n_cells: int
    max_edges: int

    x: np.ndarray  # (nCells,)
    y: np.ndarray
    z: np.ndarray
    f: np.ndarray  # Coriolis parameter at cell centers

    area_cell: np.ndarray  # (nCells,)

    n_edges_on_cell: np.ndarray  # (nCells,) int32
    edges_on_cell: np.ndarray  # (nCells, maxEdges) int32, 0-based, pad=0
    vertices_on_cell: np.ndarray  # (nCells, maxEdges) int32
    cells_on_cell: np.ndarray  # (nCells, maxEdges) int32
    # +/-1 on valid slots, 0.0 on padding; -1 when this cell is
    # cells_on_edge[:, 0] for that edge (outward normal convention)
    edge_sign_on_cell: np.ndarray  # (nCells, maxEdges) float
    edge_mask_on_cell: np.ndarray  # (nCells, maxEdges) float, 1 valid / 0 pad
    # kite_areas_on_cell[c, i]: area of (cell center, mid(edge_i),
    # vertex_i, mid(edge_{i+1}))
    kite_areas_on_cell: np.ndarray  # (nCells, maxEdges) float


@dataclass(frozen=True)
class DualCells:
    """Delaunay triangle (dual) cells, one per mesh vertex."""

    n_vertices: int
    vertex_degree: int

    x: np.ndarray  # (nVertices,)
    y: np.ndarray
    z: np.ndarray
    f: np.ndarray  # Coriolis at vertices

    area_triangle: np.ndarray  # (nVertices,)

    edges_on_vertex: np.ndarray  # (nVertices, vertexDegree) int32
    cells_on_vertex: np.ndarray  # (nVertices, vertexDegree) int32
    # +/-1: -1 when this vertex is vertices_on_edge[:, 0]
    edge_sign_on_vertex: np.ndarray  # (nVertices, vertexDegree) float
    kite_areas_on_vertex: np.ndarray  # (nVertices, vertexDegree) float


@dataclass(frozen=True)
class Edges:
    """Edges of the primary mesh (velocity points)."""

    n_edges: int
    max_edges2: int  # width of the edges_on_edge axis

    x: np.ndarray  # (nEdges,)
    y: np.ndarray
    z: np.ndarray
    f: np.ndarray  # Coriolis at edges

    cells_on_edge: np.ndarray  # (nEdges, 2) int32; normal points cell0 -> cell1
    vertices_on_edge: np.ndarray  # (nEdges, 2) int32; z_hat x normal: v0 -> v1

    n_edges_on_edge: np.ndarray  # (nEdges,) int32
    edges_on_edge: np.ndarray  # (nEdges, maxEdges2) int32, pad=0
    # TRiSK tangential-reconstruction weights; 0.0 on padded slots
    weights_on_edge: np.ndarray  # (nEdges, maxEdges2) float

    dv_edge: np.ndarray  # (nEdges,) dual-edge (vertex-to-vertex) length
    dc_edge: np.ndarray  # (nEdges,) cell-to-cell distance
    angle_edge: np.ndarray  # (nEdges,) angle of the edge normal vs. east

    # 1.0 for active edges, 0.0 for boundary-closed edges; all ones on
    # periodic meshes
    edge_mask: np.ndarray  # (nEdges,)


@dataclass(frozen=True)
class HorzMesh:
    """A 2-D TRiSK mesh: primary cells + dual cells + edges."""

    cells: PrimaryCells
    duals: DualCells
    edges: Edges

    # periodic planar extent
    lx: float
    ly: float
    on_sphere: bool = False
    sphere_radius: float = 0.0

    @property
    def n_cells(self) -> int:
        return self.cells.n_cells

    @property
    def n_edges(self) -> int:
        return self.edges.n_edges

    @property
    def n_vertices(self) -> int:
        return self.duals.n_vertices
