"""Doubly periodic uniform hexagonal mesh generator.

Generates the planar hex meshes the reference obtains from external tools
(the 48x48 doubly periodic operator-test mesh, reference:
test/ocn/test_Operators.jl:12-15, and the inertial-gravity-wave meshes from
the `inertialGravityWave` artifact). Cell centers form a triangular lattice:
row j sits at y = j * dc * sqrt(3)/2 with odd rows offset by dc/2, giving a
box of lx = nx * dc by ly = ny * dc * sqrt(3)/2 (the ly = sqrt(3)/2 * lx
relation assumed by the reference's test utilities, test/utilities.jl:71-72,
holds when ny == nx).
"""

from __future__ import annotations

import numpy as np

from .horz_mesh import HorzMesh
from .voronoi import build_planar_trisk_mesh

__all__ = ["planar_hex_mesh", "hex_lattice_points"]


def hex_lattice_points(nx: int, ny: int, dc: float) -> tuple[np.ndarray, float, float]:
    """Triangular-lattice generator points for an nx-by-ny periodic hex mesh."""
    if ny % 2 != 0:
        raise ValueError("ny must be even for a periodic hex mesh")
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    x = (i + 0.5 * (j % 2)) * dc
    y = j * (dc * np.sqrt(3.0) / 2.0)
    pts = np.stack([x.ravel(), y.ravel()], axis=1)
    lx = nx * dc
    ly = ny * dc * np.sqrt(3.0) / 2.0
    return pts, lx, ly


def planar_hex_mesh(
    nx: int,
    ny: int,
    dc: float,
    f0: float = 0.0,
    beta: float = 0.0,
    dtype=np.float64,
) -> HorzMesh:
    """Build a doubly periodic uniform hexagonal TRiSK mesh.

    nCells = nx*ny, nEdges = 3*nx*ny, nVertices = 2*nx*ny; every cell has 6
    edges, every vertex degree 3.
    """
    pts, lx, ly = hex_lattice_points(nx, ny, dc)
    mesh = build_planar_trisk_mesh(
        pts, lx, ly, f0=f0, beta=beta, max_edges=6, dtype=dtype
    )
    assert mesh.n_cells == nx * ny
    assert mesh.n_edges == 3 * nx * ny
    assert mesh.n_vertices == 2 * nx * ny
    return mesh
